"""Serving on the card (counterpart of ``paddle_tpu/serving``):

* ``scheduler`` — continuous-batching queue and slot admission;
* ``engine``    — :class:`GenerationEngine`, prefill + in-place KV-cache
  decode, and :class:`InferenceEngine`, one-shot forward serving of a
  saved inference model; both take ``quantize=`` (int8 weights);
* ``decoder``   — score/prefill/decode (and speculative verify) programs
  of a decoder LM, ``sync_draft_weights`` for a self-draft;
* ``kv_cache``  — the fixed-region per-slot cache, the paged pool (float
  or int8) and its host ``PageAllocator`` (prefix sharing, leak check);
* ``metrics``   — counters and latency percentiles.
"""

from .scheduler import (ContinuousBatchingScheduler, ServingRequest,
                        BatchPlan, RequestTimeoutError,
                        PoisonedRequestError, EngineClosedError)
from .metrics import ServingMetrics
from .kv_cache import (KVCacheStore, OutOfPagesError, PageAllocator,
                       PagedKVCacheStore)
from .decoder import DecoderSpec, build_decoder_lm, sync_draft_weights
from .engine import GenerationEngine, InferenceEngine

__all__ = [
    "ContinuousBatchingScheduler", "ServingRequest", "BatchPlan",
    "RequestTimeoutError", "PoisonedRequestError", "EngineClosedError",
    "ServingMetrics", "KVCacheStore", "PageAllocator", "PagedKVCacheStore",
    "OutOfPagesError", "DecoderSpec", "build_decoder_lm",
    "sync_draft_weights", "GenerationEngine", "InferenceEngine",
]
