from .bucketing import (BucketLadder, LadderFitError, RequestTooLarge,
                        default_ladder, ladder_from_sizes)
from .registry import TableEntry, TableRegistry
from .scheduling import AdmittedRequest, ContinuousScheduler, jain_index
from .server import (ServerOverloaded, StreamingSynthesizer,
                     SynthesisRequest, SynthesisResponse)

__all__ = ["BucketLadder", "LadderFitError", "RequestTooLarge",
           "default_ladder", "ladder_from_sizes", "TableEntry",
           "TableRegistry", "AdmittedRequest", "ContinuousScheduler",
           "jain_index", "ServerOverloaded", "StreamingSynthesizer",
           "SynthesisRequest", "SynthesisResponse"]
