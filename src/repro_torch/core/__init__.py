"""Fed-TGAN's protocol pieces: the §4.1 encoder initialization
(``encoding``), the §4.2 divergences and weighting (``divergence``,
``weighting``), the per-leaf merge oracle (``aggregation``), FedProx and
partial participation (``fedavg``), bytes and seconds on the wire
(``comm_model``), and the entry points of the paper's architectures
(``architectures``: ``run_federated``, ``run_centralized``,
``run_mdtgan``)."""
