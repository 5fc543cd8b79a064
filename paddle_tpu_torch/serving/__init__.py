"""Serving on the card (counterpart of ``paddle_tpu/serving``):

* ``scheduler`` — continuous-batching queue and slot admission;
* ``engine``    — :class:`GenerationEngine`, prefill + in-place KV-cache
  decode, and :class:`InferenceEngine`, one-shot forward serving of a
  saved inference model; both take ``quantize=`` (int8 weights);
* ``decoder``   — score/prefill/decode programs of a decoder LM;
* ``kv_cache``  — the fixed-region per-slot cache;
* ``metrics``   — counters and latency percentiles.
"""

from .scheduler import (ContinuousBatchingScheduler, ServingRequest,
                        BatchPlan, RequestTimeoutError,
                        PoisonedRequestError, EngineClosedError)
from .metrics import ServingMetrics
from .kv_cache import KVCacheStore
from .decoder import DecoderSpec, build_decoder_lm
from .engine import GenerationEngine, InferenceEngine

__all__ = [
    "ContinuousBatchingScheduler", "ServingRequest", "BatchPlan",
    "RequestTimeoutError", "PoisonedRequestError", "EngineClosedError",
    "ServingMetrics", "KVCacheStore", "DecoderSpec", "build_decoder_lm",
    "GenerationEngine", "InferenceEngine",
]
