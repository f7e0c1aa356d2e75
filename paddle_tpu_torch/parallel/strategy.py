"""DistributedStrategy: the port's copy of `paddle_tpu/parallel/strategy.py`
(the reference's fleet/base/distributed_strategy.py:109 over
framework/distributed_strategy.proto).

One typed dataclass tree; every knob maps to a mesh shape, a spec
policy or a Trainer option. The sub-configs take dicts, as the
reference's setters do.
"""
from __future__ import annotations

import dataclasses

__all__ = ["DistributedStrategy", "HybridConfig", "AmpConfig",
           "RecomputeConfig", "ShardingConfig", "PipelineConfig",
           "DGCConfig"]


@dataclasses.dataclass
class HybridConfig:
    dp_degree: int = -1           # -1: absorb remaining devices
    mp_degree: int = 1            # tensor parallel (reference naming)
    pp_degree: int = 1
    sharding_degree: int = 1      # fsdp axis
    sep_degree: int = 1           # sequence parallel
    ep_degree: int = 1            # expert parallel


@dataclasses.dataclass
class AmpConfig:
    enable: bool = False
    dtype: str = "bfloat16"
    level: str = "O1"
    init_loss_scaling: float = 2.0 ** 15
    use_dynamic_loss_scaling: bool = True


@dataclasses.dataclass
class RecomputeConfig:
    enable: bool = False
    # names of block classes to checkpoint; empty = whole loss fn
    checkpoint_layers: tuple = ()


@dataclasses.dataclass
class ShardingConfig:
    stage: int = 1                # ZeRO stage when sharding_degree > 1
    min_param_size: int = 1024


@dataclasses.dataclass
class PipelineConfig:
    accumulate_steps: int = 1     # microbatches


@dataclasses.dataclass
class GradientMergeConfig:
    enable: bool = False
    k_steps: int = 1


@dataclasses.dataclass
class DGCConfig:
    # the mesh axis the compressed collective runs over (the JAX
    # package's parallel/compression.py, not ported yet)
    axis: str = "dp"
    # the reference's dgc_configs knobs, accepted and unused
    rampup_begin_step: int = 0
    rampup_step: int = 1
    sparsity: tuple = (0.999,)


@dataclasses.dataclass
class DistributedStrategy:
    hybrid_configs: HybridConfig = dataclasses.field(
        default_factory=HybridConfig)
    amp: bool = False
    amp_configs: AmpConfig = dataclasses.field(default_factory=AmpConfig)
    recompute: bool = False
    recompute_configs: RecomputeConfig = dataclasses.field(
        default_factory=RecomputeConfig)
    sharding: bool = False
    sharding_configs: ShardingConfig = dataclasses.field(
        default_factory=ShardingConfig)
    pipeline: bool = False
    pipeline_configs: PipelineConfig = dataclasses.field(
        default_factory=PipelineConfig)
    gradient_merge: bool = False
    gradient_merge_configs: GradientMergeConfig = dataclasses.field(
        default_factory=GradientMergeConfig)
    dgc: bool = False
    dgc_configs: DGCConfig = dataclasses.field(default_factory=DGCConfig)
    find_unused_parameters: bool = False

    def __post_init__(self):
        # accept dicts for sub-configs (the reference's dict-style setters)
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, dict):
                setattr(self, f.name, f.type(**v) if callable(f.type)
                        else v)
        for name, cls in (("hybrid_configs", HybridConfig),
                          ("amp_configs", AmpConfig),
                          ("recompute_configs", RecomputeConfig),
                          ("sharding_configs", ShardingConfig),
                          ("pipeline_configs", PipelineConfig),
                          ("gradient_merge_configs", GradientMergeConfig),
                          ("dgc_configs", DGCConfig)):
            v = getattr(self, name)
            if isinstance(v, dict):
                setattr(self, name, cls(**v))
