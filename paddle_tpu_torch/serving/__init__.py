"""Serving stack of the PyTorch/CUDA port: the continuous-batching
`LLMEngine` over a slotted KV cache, its sampler and its metrics."""
from .engine import (EngineOverloadError, GenerationResult, LLMEngine,
                     SamplingParams)
from .kv_cache import KVCacheManager, NoFreeSlot
from .metrics import OnlineStat, ServingMetrics
from .sampler import (filtered_logits, sample_tokens,
                      sample_tokens_per_lane)

__all__ = ["LLMEngine", "SamplingParams", "GenerationResult",
           "EngineOverloadError", "KVCacheManager", "NoFreeSlot",
           "ServingMetrics", "OnlineStat", "filtered_logits",
           "sample_tokens", "sample_tokens_per_lane"]
