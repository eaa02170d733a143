"""Fed-TGAN's protocol pieces: the §4.1 encoder initialization
(``encoding``), the §4.2 divergences and weighting (``divergence``,
``weighting``), the per-leaf merge oracle (``aggregation``), FedProx and
partial participation (``fedavg``), bytes and seconds on the wire
(``comm_model``), and the entry points of the paper's architectures
(``architectures``: ``run_federated``, ``run_centralized``,
``run_mdtgan``)."""
from . import divergence
from .aggregation import broadcast_from, psum_weighted, weighted_average
from .encoding import (ClientStats, FederatedInit, compute_client_stats,
                       federated_encoder_init)
from .fedavg import make_federated_round, shard_map_federated_round
from .weighting import (build_divergence_matrix, fedtgan_weights,
                        quantity_only_weights, uniform_weights,
                        weights_from_divergence)
