"""Token data for the federated LM workload."""
from .tokens import (TokenDatasetSpec, client_token_streams,
                     fed_weights_from_token_stats, synthetic_token_batches,
                     token_frequency_stats)

__all__ = ["TokenDatasetSpec", "client_token_streams",
           "fed_weights_from_token_stats", "synthetic_token_batches",
           "token_frequency_stats"]
