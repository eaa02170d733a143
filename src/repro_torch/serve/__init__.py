from .bucketing import (BucketLadder, LadderFitError, RequestTooLarge,
                        default_ladder, ladder_from_sizes)
from .registry import TableEntry, TableRegistry
from .scheduling import AdmittedRequest, ContinuousScheduler
from .server import (ServerOverloaded, StreamingSynthesizer,
                     SynthesisRequest, SynthesisResponse)
