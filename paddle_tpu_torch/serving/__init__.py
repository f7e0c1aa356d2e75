"""Serving stack of the PyTorch/CUDA port: the continuous-batching
`LLMEngine` over a slotted or paged KV cache (fp or int8), its sampler
and its metrics."""
from .engine import (EngineOverloadError, GenerationResult, LLMEngine,
                     SamplingParams)
from .kv_cache import KVCacheManager, NoFreeSlot
from .metrics import OnlineStat, ServingMetrics
from .paged_kv import NoFreePages, PagedKVCache, PagePool
from .sampler import (filtered_logits, sample_tokens,
                      sample_tokens_per_lane)

__all__ = ["LLMEngine", "SamplingParams", "GenerationResult",
           "EngineOverloadError", "KVCacheManager", "NoFreeSlot",
           "PagedKVCache", "PagePool", "NoFreePages",
           "ServingMetrics", "OnlineStat", "filtered_logits",
           "sample_tokens", "sample_tokens_per_lane"]
