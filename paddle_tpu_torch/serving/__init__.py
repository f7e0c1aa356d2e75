"""Serving stack of the PyTorch/CUDA port: the continuous-batching
`LLMEngine` over a slotted or paged KV cache (fp or int8) with chunked,
interleaved and prefix-cached admission, host swap and page handoff,
its prefix cache, its sampler and its metrics, the serving artifact
(`save_for_serving` / `load_model` / `load_engine`), the replica fleet
(`EngineFleet`, `ReplicaHealth`), its shared KV tier (`KVTier`) and its
autoscaler (`AutoscalePolicy`, `FleetAutoscaler`, `ScaleSignals`), and
the HTTP front door over an engine or a fleet (`LLMServer`, its
scheduling thread `EngineWorker`, `ServerMetrics`) with its SLO
admission (`SLOController`, `TenantPolicy`, `TokenBucket`, `Admission`,
`SHED_REASONS`), and TP-sharded serving (`make_tp_mesh`, the
`KVManager` interface, `ShardedKVCacheManager`, `ShardedPagedKVCache`,
`make_kv_manager`). `python -m paddle_tpu_torch.serving` runs the fleet
kill soak, `python -m paddle_tpu_torch.serving.server` the front door's
disconnect-and-drain soak."""
from __future__ import annotations

import dataclasses
import json
import os

from .autoscale import AutoscalePolicy, FleetAutoscaler, ScaleSignals
from .engine import (EngineOverloadError, GenerationResult, LLMEngine,
                     SamplingParams)
from .fleet import REPLICA_STATES, EngineFleet, ReplicaHealth
from .kv_tier import KVTier, chunk_key
from .kv_cache import KVCacheManager, NoFreeSlot
from .metrics import OnlineStat, ServingMetrics
from .paged_kv import (NoFreePages, PagedKVCache, PagePool,
                       TreePageAllocator)
from .prefix_cache import PrefixCache, PrefixNode
from .sampler import (filtered_logits, sample_tokens,
                      sample_tokens_per_lane)
from .server import EngineWorker, LLMServer, ServerMetrics
from .sharded_kv import (KVManager, ShardedKVCacheManager,
                         ShardedPagedKVCache, make_kv_manager, make_tp_mesh)
from .slo import (SHED_REASONS, Admission, SLOController, TenantPolicy,
                  TokenBucket)

__all__ = ["LLMEngine", "SamplingParams", "GenerationResult",
           "EngineOverloadError", "KVCacheManager", "NoFreeSlot",
           "PagedKVCache", "PagePool", "NoFreePages", "TreePageAllocator",
           "PrefixCache", "PrefixNode",
           "ServingMetrics", "OnlineStat", "filtered_logits",
           "sample_tokens", "sample_tokens_per_lane", "save_for_serving",
           "load_model", "load_engine", "EngineFleet", "ReplicaHealth",
           "REPLICA_STATES", "KVTier", "chunk_key", "AutoscalePolicy",
           "FleetAutoscaler", "ScaleSignals", "LLMServer", "EngineWorker",
           "ServerMetrics", "SLOController", "TenantPolicy", "TokenBucket",
           "Admission", "SHED_REASONS", "KVManager",
           "ShardedKVCacheManager", "ShardedPagedKVCache",
           "make_kv_manager", "make_tp_mesh"]

# GPTConfig fields of the JAX package that select a TPU kernel and have
# no meaning here (the port picks its kernels by device)
_TPU_ONLY_FIELDS = ("use_flash",)


def save_for_serving(model, prefix: str) -> str:
    """Persist a GPT model for serving: `<prefix>.llm.json` (the
    `GPTConfig` fields) and `<prefix>.llm.params` (the state dict as a
    pickle of numpy arrays, an int8-PTQ model's `.qweight` / `.w_scale`
    / `.act_scale` / `.bias` buffers included). The JAX package's
    `load_engine` reads the pair too."""
    from ..framework import io as fio
    d = os.path.dirname(os.path.abspath(prefix))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(prefix + ".llm.json", "w") as f:
        json.dump(dataclasses.asdict(model.cfg), f, indent=1)
    fio.save(model.state_dict(), prefix + ".llm.params")
    return prefix


def load_model(prefix: str, device=None):
    """Rebuild the GPT model (fp or int8-PTQ) of a `save_for_serving`
    pair, the port's or the JAX package's, on `device` (default "cuda",
    which raises without a card). The weights go through the JAX-to-
    torch bridge (`models.weights`): names and shapes are checked, and
    each Linear with a `.qweight` becomes an `Int8Linear`. The model
    takes the dtype of the stored embedding."""
    from ..framework import io as fio
    from ..models.gpt import GPT, GPTConfig
    from ..models.weights import load_jax_int8_params, load_jax_params
    cfg_path = prefix + ".llm.json"
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(
            f"no serving artifact at {prefix!r} (expected "
            f"<prefix>.llm.json + <prefix>.llm.params from "
            f"save_for_serving)")
    with open(cfg_path) as f:
        fields = json.load(f)
    for k in _TPU_ONLY_FIELDS:
        fields.pop(k, None)
    cfg = GPTConfig(**fields)
    state = fio.load(prefix + ".llm.params")
    model = GPT(cfg, device=device, dtype=state["wte.weight"].dtype)
    quant = {k[:-len(".qweight")] for k in state if k.endswith(".qweight")}
    if quant:
        bufs = {k: v for k, v in state.items()
                if k.rsplit(".", 1)[0] in quant}
        load_jax_int8_params(model, {k: v for k, v in state.items()
                                     if k not in bufs}, bufs)
    else:
        load_jax_params(model, state)
    return model.eval()


def load_engine(prefix: str, snapshot=None, **engine_kwargs) -> LLMEngine:
    """Rebuild the saved model and wrap it in an `LLMEngine`; keyword
    arguments pass to the engine (`device="cpu"` for the CPU: the
    default is the card, and there is no fallback). With `snapshot` (an
    `LLMEngine.snapshot()` dict of this engine or of the JAX engine,
    e.g. unpickled after a preemption) the engine RESUMES it instead:
    queued, parked and mid-generation requests continue."""
    device = engine_kwargs.get("device")
    if device is None and snapshot is not None:
        device = snapshot.get("engine", {}).get("device")
    model = load_model(prefix, device=device)
    if snapshot is not None:
        return LLMEngine.resume(model, snapshot, **engine_kwargs)
    return LLMEngine(model, **engine_kwargs)
