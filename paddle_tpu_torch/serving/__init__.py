"""Serving stack of the PyTorch/CUDA port: the continuous-batching
`LLMEngine` over a slotted or paged KV cache (fp or int8) with chunked,
interleaved and prefix-cached admission, its prefix cache, its sampler
and its metrics."""
from .engine import (EngineOverloadError, GenerationResult, LLMEngine,
                     SamplingParams)
from .kv_cache import KVCacheManager, NoFreeSlot
from .metrics import OnlineStat, ServingMetrics
from .paged_kv import (NoFreePages, PagedKVCache, PagePool,
                       TreePageAllocator)
from .prefix_cache import PrefixCache, PrefixNode
from .sampler import (filtered_logits, sample_tokens,
                      sample_tokens_per_lane)

__all__ = ["LLMEngine", "SamplingParams", "GenerationResult",
           "EngineOverloadError", "KVCacheManager", "NoFreeSlot",
           "PagedKVCache", "PagePool", "NoFreePages", "TreePageAllocator",
           "PrefixCache", "PrefixNode",
           "ServingMetrics", "OnlineStat", "filtered_logits",
           "sample_tokens", "sample_tokens_per_lane"]
