"""Auto-parallel: cost-model mesh planning and the Engine facade, the
counterpart of `paddle_tpu/parallel/auto.py` (the reference's
`distributed/auto_parallel/`: completion, cost model, planner, engine).

The planner chooses the mesh, the (dp, fsdp, tp, pp) factorization of
the ranks, before a run; the rest of the reference's work is done by the
mesh's layers and the Trainer. The search is closed-form host
arithmetic, copied from the JAX package:

- memory per rank: weights and gradients in the compute dtype sharded
  by fsdp x tp x pp, Adam's moments and fp32 master sharded the same
  (ZeRO), activations proportional to the local batch and depth / pp
  (less under remat);
- step time: compute = flops / (ranks x peak x MFU); the dp gradient
  all-reduce over the fast link (overlappable), TP's per-block
  all-reduces, the pipeline's bubble (1 + (pp - 1) / micro), and the
  slow link's share for a multi-slice plan;
- every divisor factorization of the rank count, the plans that do not
  fit the memory dropped, ranked by modelled step time.

`ClusterSpec`'s defaults are the NVIDIA H100 SXM5 80GB's datasheet
figures (700 W card; HBM3 80 GB, dense bf16 989 TFLOP/s, NVLink 4 at
450 GB/s each way, one 400 Gb/s NDR InfiniBand port per card between
hosts) for an 8-card host: datasheet figures, not measurements.
`Calibrator` fits MFU and the link rates to step times measured on the
card (`time_step_fn`, which syncs the device with
`torch.cuda.synchronize`). `Engine` builds the mesh and the Trainer of
the winning plan over an explicit `world_size` of logical ranks, as
`init_mesh` takes it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ClusterSpec", "ModelStats", "Plan", "CostModel", "Planner",
           "Engine", "analyze_model", "Calibrator", "time_step_fn"]


@dataclasses.dataclass
class ClusterSpec:
    """Hardware description (cluster.py analog): an 8-card H100 SXM5
    host by default, from NVIDIA's datasheet (700 W cards). `ici_bw` is
    the fast link within a slice (NVLink 4), `dcn_bw` the slow one
    between slices (an NDR InfiniBand port per card)."""

    n_devices: int = 8
    hbm_bytes: float = 80e9            # HBM3, H100 SXM5 80GB
    peak_flops: float = 989e12         # dense bf16 tensor cores, H100 SXM5
    ici_bw: float = 4.5e11             # bytes/s each way, NVLink 4
    dcn_bw: float = 5.0e10             # bytes/s, 400 Gb/s NDR InfiniBand
    mfu: float = 0.4                   # attainable model-flops utilization
    hop_latency: float = 1e-5          # per-collective launch/hop cost
    n_slices: int = 1                  # slices joined by the slow link


@dataclasses.dataclass
class ModelStats:
    n_params: int
    n_layers: int = 1
    flops_per_sample: float = 0.0      # fwd+bwd
    act_bytes_per_sample: float = 0.0  # whole-model activations, batch=1
    bytes_per_param: int = 2           # bf16 compute params


def analyze_model(model, sample_shape: Sequence[int],
                  seq_like: bool = False) -> ModelStats:
    """Coarse stats from a Layer: exact param count; flops ≈ 6·P per
    token/sample (the standard transformer estimate — fwd 2P + bwd 4P);
    activations ≈ 12 bytes per param-row-activation via the hidden sizes
    heuristic (falls back to 20× input bytes)."""
    n_params = sum(int(np.prod(p.shape)) for p in model.parameters())
    depth = max(1, len([1 for _, s in model.named_modules()
                        if type(s).__name__ in
                        ("TransformerEncoderLayer", "GPTBlock", "Block")]))
    per_sample = float(np.prod(sample_shape[1:])) if len(sample_shape) > 1 \
        else 1.0
    flops = 6.0 * n_params * (per_sample if seq_like else 1.0)
    if seq_like:
        # transformer rule of thumb: P ≈ 12·L·H² → H; activations per
        # token ≈ 16·H bytes per layer (attn+mlp intermediates, bf16,
        # post-remat rough figure)
        hidden = math.sqrt(max(n_params / (12.0 * depth), 1.0))
        act = per_sample * hidden * depth * 16.0
    else:
        act = max(20.0 * per_sample * 4.0,
                  2.0 * math.sqrt(n_params) * depth)
    return ModelStats(n_params=n_params, n_layers=depth,
                      flops_per_sample=flops, act_bytes_per_sample=act)


@dataclasses.dataclass
class Plan:
    dp: int
    fsdp: int
    tp: int
    pp: int
    micro: int = 1
    mem_bytes: float = 0.0
    step_time: float = float("inf")
    dcn_axis: Optional[str] = None     # which axis spans slices (if any)

    @property
    def degrees(self) -> Dict[str, int]:
        return {"dp": self.dp, "fsdp": self.fsdp, "tp": self.tp,
                "pp": self.pp}

    def mesh_factorization(self, n_slices: int
                           ) -> Tuple[Dict[str, int], Dict[str, int]]:
        """(dcn, ici) degree dicts for multislice.init_multislice_mesh."""
        if self.dcn_axis is None or n_slices <= 1:
            return {}, {a: d for a, d in self.degrees.items() if d > 1}
        deg = self.degrees[self.dcn_axis]
        if deg % n_slices:
            raise ValueError(
                f"plan's {self.dcn_axis} degree {deg} is not divisible "
                f"by n_slices={n_slices} (plans from plan_multislice are "
                "valid only for their cluster's slice count)")
        dcn = {self.dcn_axis: n_slices}
        ici = dict(self.degrees)
        ici[self.dcn_axis] //= n_slices
        return dcn, {a: d for a, d in ici.items() if d > 1}

    def __str__(self):
        dcn = f", dcn={self.dcn_axis}" if self.dcn_axis else ""
        return (f"Plan(dp={self.dp}, fsdp={self.fsdp}, tp={self.tp}, "
                f"pp={self.pp}, micro={self.micro}{dcn}, "
                f"mem={self.mem_bytes / 1e9:.2f}GB, "
                f"t={self.step_time * 1e3:.2f}ms)")


class CostModel:
    """Rank (dp, fsdp, tp, pp) factorizations (cost_model.py analog —
    closed-form instead of an op-graph simulation; only mesh-level
    effects are modeled)."""

    # Adam: m+v fp32 + fp32 master when compute dtype < fp32
    OPT_BYTES_PER_PARAM = 12.0

    def __init__(self, cluster: ClusterSpec, remat: bool = True):
        self.cluster = cluster
        self.remat = remat

    def memory(self, stats: ModelStats, plan: Plan, global_batch: int
               ) -> float:
        shard = plan.fsdp * plan.tp * plan.pp
        p_bytes = stats.n_params * stats.bytes_per_param
        weights = p_bytes / shard
        grads = p_bytes / shard
        opt = stats.n_params * self.OPT_BYTES_PER_PARAM / shard
        local_batch = max(1, global_batch // (plan.dp * plan.fsdp))
        act = stats.act_bytes_per_sample * local_batch / plan.pp
        if self.remat:
            act = act / max(1.0, math.sqrt(stats.n_layers))
        if plan.pp > 1:  # in-flight microbatch activations
            act = act * min(plan.micro, plan.pp) / max(plan.micro, 1)
        return weights + grads + opt + act

    def step_time(self, stats: ModelStats, plan: Plan, global_batch: int
                  ) -> float:
        c = self.cluster
        n = plan.dp * plan.fsdp * plan.tp * plan.pp
        compute = (stats.flops_per_sample * global_batch) / \
            (n * c.peak_flops * c.mfu)
        # grads reduced over dp·fsdp are the PER-DEVICE param shard
        # (params already split over tp·pp)
        p_bytes = stats.n_params * stats.bytes_per_param / \
            (plan.tp * plan.pp)
        g = plan.dp * plan.fsdp
        dp_comm = 2.0 * p_bytes * (g - 1) / max(g, 1) / c.ici_bw \
            if g > 1 else 0.0
        # fsdp adds a param all-gather (forward) of the same volume
        if plan.fsdp > 1:
            dp_comm *= 1.5
        local_batch = max(1, global_batch // (plan.dp * plan.fsdp))
        # TP: two all-reduces per block over activations
        tp_comm = 0.0
        if plan.tp > 1:
            act_vol = stats.act_bytes_per_sample * local_batch
            tp_comm = 2.0 * act_vol * (plan.tp - 1) / plan.tp / c.ici_bw
        # PP: boundary activations hop once fwd + once bwd per microbatch
        # (one layer's activation ≈ act/n_layers), plus the fill/drain
        # bubble stretching compute
        pp_comm = 0.0
        bubble = 1.0
        if plan.pp > 1:
            boundary = stats.act_bytes_per_sample / max(stats.n_layers, 1)
            pp_comm = 2.0 * boundary * local_batch / c.ici_bw
            # each tick launches a ppermute (fwd + ~2× in backward)
            ticks = plan.micro + plan.pp - 1
            pp_comm += 3.0 * ticks * c.hop_latency
            bubble = 1.0 + (plan.pp - 1) / max(plan.micro, 1)
        # DCN surcharge (multislice, FleetExecutor analog): the chosen
        # axis's cross-slice phase rides DCN. Hierarchical collectives:
        # the within-slice phase stays on ICI (already counted); only
        # the (n_slices-wide) exchange pays dcn_bw.
        dcn = 0.0
        S = c.n_slices
        if S > 1 and plan.dcn_axis in ("dp", "fsdp"):
            dcn = 2.0 * p_bytes * (S - 1) / S / c.dcn_bw
            if plan.dcn_axis == "fsdp":
                # the ZeRO forward param all-gather also crosses DCN
                # (mirrors the 1.5x the ICI path charges dp_comm)
                dcn *= 1.5
        elif S > 1 and plan.dcn_axis == "pp":
            boundary = stats.act_bytes_per_sample / max(stats.n_layers, 1)
            # (S-1) of the (pp-1) inter-stage hops cross slices, fwd+bwd
            frac = (S - 1) / max(plan.pp - 1, 1)
            dcn = 2.0 * boundary * local_batch * frac / c.dcn_bw
        # grad all-reduce overlaps backward on ICI: count the max of the
        # overlappable terms, plus the serial halves
        return compute * bubble + max(dp_comm, tp_comm * 0.5) + \
            tp_comm * 0.5 + pp_comm + dcn


def time_step_fn(step_fn, args, steps: int = 5, warmup: int = 2,
                 reduce: str = "median") -> float:
    """Wall-clock seconds of `step_fn(*args)` (median, or best of N with
    reduce="best"), each call ended by `torch.cuda.synchronize()` when a
    card is present (a CPU run has nothing in flight)."""
    import time

    import torch

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    for _ in range(warmup):
        step_fn(*args)
        sync()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step_fn(*args)
        sync()
        times.append(time.perf_counter() - t0)
    return float(np.min(times) if reduce == "best"
                 else np.median(times))


class Calibrator:
    """Fit the ClusterSpec's throughput parameters to MEASURED step
    times, so the planner ranks with numbers observed on this hardware
    instead of datasheet constants.

    Reference: the planner consumes a measured per-op cost table
    (`python/paddle/cost_model/static_op_benchmark.json`); op-level
    measurement collapses here, so what is worth fitting is the
    mesh-level knobs the analytic CostModel is parameterized by —
    achieved MFU, the fast and the slow link's bandwidth. step_time
    is smooth in those, so a handful of (plan, measured-seconds) pairs
    pins them via least squares.
    """

    def __init__(self, cluster: ClusterSpec, remat: bool = True):
        self.cluster = cluster
        self.remat = remat

    def fit(self, stats: ModelStats,
            measurements: Sequence[Tuple[Plan, int, float]],
            fit_dcn: bool = False) -> ClusterSpec:
        """measurements: (plan, global_batch, seconds) triples. Returns
        a NEW ClusterSpec with fitted mfu / ici_bw (and dcn_bw when
        asked and identifiable); the original is untouched."""
        from scipy.optimize import least_squares

        base = dataclasses.replace(self.cluster)

        def unpack(z):  # log-space: the knobs span ~10 decades
            return dataclasses.replace(
                base, mfu=math.exp(z[0]), ici_bw=math.exp(z[1]),
                dcn_bw=(math.exp(z[2]) if fit_dcn else base.dcn_bw))

        def residuals(z):
            cm = CostModel(unpack(z), remat=self.remat)
            return [
                math.log(max(cm.step_time(stats, plan, gb), 1e-12))
                - math.log(max(sec, 1e-12))
                for plan, gb, sec in measurements]

        z0 = [math.log(base.mfu), math.log(base.ici_bw)] + \
            ([math.log(base.dcn_bw)] if fit_dcn else [])
        # wide bounds on purpose: relative to the spec's peak, a CPU
        # backend (tests, planner dry-runs) measures ~1e-5 "mfu"
        span = math.log(1e4)
        lo = [math.log(1e-8), z0[1] - span] + \
            ([z0[2] - span] if fit_dcn else [])
        hi = [math.log(1.0), z0[1] + span] + \
            ([z0[2] + span] if fit_dcn else [])
        sol = least_squares(residuals, z0, bounds=(lo, hi))
        return unpack(sol.x)

    def calibrated_planner(self, stats: ModelStats, measurements,
                           fit_dcn: bool = False,
                           **planner_kw) -> "Planner":
        return Planner(
            cluster=self.fit(stats, measurements, fit_dcn=fit_dcn),
            remat=self.remat, **planner_kw)


class Planner:
    """Search the factorization space (planner.py analog)."""

    def __init__(self, cluster: Optional[ClusterSpec] = None,
                 remat: bool = True, max_tp: int = 8,
                 max_pp: Optional[int] = None, micro_per_stage: int = 4):
        self.cluster = cluster or ClusterSpec()
        self.remat = remat
        self.max_tp = max_tp
        self.max_pp = max_pp
        self.micro_per_stage = micro_per_stage

    def _factorizations(self, n: int):
        divs = [d for d in range(1, n + 1) if n % d == 0]
        for tp in divs:
            if tp > self.max_tp:
                continue
            for pp in divs:
                if self.max_pp is not None and pp > self.max_pp:
                    continue
                if n % (tp * pp):
                    continue
                rest = n // (tp * pp)
                for fsdp in [d for d in range(1, rest + 1)
                             if rest % d == 0]:
                    yield rest // fsdp, fsdp, tp, pp

    def _search(self, stats: ModelStats, global_batch: int, top_k: int,
                dcn_axes_of) -> List[Plan]:
        """The one search loop. `dcn_axes_of(dp, fsdp, tp, pp)` yields
        the dcn-axis options to cost for that factorization ([None] for
        single-slice). Memory is dcn-axis-independent and checked once
        per factorization."""
        cm = CostModel(self.cluster, remat=self.remat)
        candidates: List[Plan] = []
        rejected = {"batch": 0, "micro": 0, "memory": 0, "slices": 0}
        for dp, fsdp, tp, pp in self._factorizations(
                self.cluster.n_devices):
            if global_batch % max(dp * fsdp, 1):
                rejected["batch"] += 1
                continue
            micro = self.micro_per_stage * pp if pp > 1 else 1
            if pp > 1 and global_batch % micro:
                rejected["micro"] += 1
                continue
            axes = list(dcn_axes_of(dp, fsdp, tp, pp))
            if not axes:
                rejected["slices"] += 1
                continue
            base = Plan(dp, fsdp, tp, pp, micro=micro)
            base.mem_bytes = cm.memory(stats, base, global_batch)
            if base.mem_bytes > self.cluster.hbm_bytes * 0.9:
                rejected["memory"] += 1
                continue
            for axis in axes:
                plan = Plan(dp, fsdp, tp, pp, micro=micro, dcn_axis=axis,
                            mem_bytes=base.mem_bytes)
                plan.step_time = cm.step_time(stats, plan, global_batch)
                candidates.append(plan)
        if not candidates:
            reasons = ", ".join(f"{k}: {v}" for k, v in rejected.items()
                                if v) or "none generated"
            raise ValueError(
                f"no feasible plan over {self.cluster.n_devices} devices "
                f"(candidates rejected by constraint — {reasons}). "
                "'memory' means the model exceeds "
                f"{self.cluster.hbm_bytes * 0.9 / 1e9:.1f}GB/device at "
                "that sharding; 'batch'/'micro' mean global_batch="
                f"{global_batch} doesn't divide the data/microbatch "
                "axes; 'slices' means no parallel axis degree was "
                f"divisible by n_slices={self.cluster.n_slices}")
        candidates.sort(key=lambda p: (p.step_time, -p.dp))
        return candidates[:top_k] if top_k > 1 else [candidates[0]]

    def plan(self, stats: ModelStats, global_batch: int,
             top_k: int = 1) -> List[Plan]:
        return self._search(stats, global_batch, top_k,
                            lambda dp, fsdp, tp, pp: [None])

    def plan_multislice(self, stats: ModelStats, global_batch: int,
                        top_k: int = 1) -> List[Plan]:
        """Rank factorizations for a multi-slice cluster, choosing which
        axis spans DCN (the FleetExecutor placement question: replicas
        across slices — gradients cross DCN once per step — versus
        pipeline stages across slices — one microbatch activation per
        tick). Feed the winner's `mesh_factorization(n_slices)` to
        multislice.init_multislice_mesh."""
        S = self.cluster.n_slices
        if S <= 1:
            return self.plan(stats, global_batch, top_k=top_k)

        def axes_of(dp, fsdp, tp, pp):
            return [a for a, d in (("dp", dp), ("fsdp", fsdp),
                                   ("pp", pp)) if d % S == 0]

        return self._search(stats, global_batch, top_k, axes_of)


class Engine:
    """Auto-parallel train facade (engine.py:49 analog): pick a plan,
    build the mesh, the ZeRO stage and the Trainer, train. The cluster
    is `world_size` logical ranks unless given; the mesh is on the
    model's device."""

    def __init__(self, model, loss_fn, optimizer,
                 cluster: Optional[ClusterSpec] = None,
                 strategy: str = "auto", remat: bool = True,
                 world_size: Optional[int] = None):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.cluster = cluster or self._detect_cluster(world_size)
        self.remat = remat
        self.plan_: Optional[Plan] = None
        self.trainer = None
        self.mesh = None

    @staticmethod
    def _detect_cluster(world_size: Optional[int] = None) -> ClusterSpec:
        if world_size is None:
            from .env import default_world_size
            world_size = default_world_size()
        if world_size is None:
            raise ValueError("pass world_size (the number of logical "
                             "ranks) or a ClusterSpec")
        return ClusterSpec(n_devices=world_size)

    def prepare(self, sample_shape: Sequence[int], global_batch: int,
                seq_like: bool = False, stats: Optional[ModelStats] = None):
        from ..framework.trainer import Trainer
        from .mesh import init_mesh
        from .sharding import apply_fsdp, shard_model

        stats = stats or analyze_model(self.model, sample_shape,
                                       seq_like=seq_like)
        # the Engine realizes dp and fsdp (ZeRO) itself; tp needs a model
        # built from tp_layers and pp a PipelineStack: the search is held
        # to the axes this facade delivers (Planner plans tp / pp)
        planner = Planner(self.cluster, remat=self.remat, max_tp=1,
                          max_pp=1)
        self.plan_ = planner.plan(stats, global_batch)[0]
        p = self.plan_
        self.mesh = init_mesh(dp=p.dp, fsdp=p.fsdp, tp=p.tp, pp=p.pp,
                              world_size=self.cluster.n_devices,
                              device=next(self.model.parameters()).device)
        if p.fsdp > 1:
            apply_fsdp(self.model, self.mesh, stage=3)
        shard_model(self.model, self.mesh)
        self.trainer = Trainer(self.model, self.optimizer, self.loss_fn,
                               mesh=self.mesh, remat=self.remat)
        return self

    def fit_batch(self, *batch):
        if self.trainer is None:
            raise RuntimeError("call prepare() first")
        return self.trainer.train_step(*batch)
