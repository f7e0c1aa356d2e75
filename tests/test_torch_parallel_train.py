"""`Trainer(mesh=)` against the JAX Trainer on conftest's 8 virtual
devices, same weights (carried from the JAX model) and numpy batches.

- Loss curves, 8 steps of the reference's `_mlp` (Adam 0.01, mean
  cross-entropy over a batch of 32, `tests/test_parallel.py:146`)
  under dp 8, fsdp 8 at stages 1 and 3, and dp 2 x fsdp 4 at stage 2:
  within JAX's own bar (rtol 2e-4, atol 1e-5; `test_parallel.py:155`),
  and the final parameters within 1e-4 of the largest magnitude.
- Per-rank partitions at each stage: every split slot and parameter
  is a tensor per fsdp rank whose shape is JAX's shard shape, every
  replicated one JAX's fully replicated array; per-rank slot bytes
  equal the total over fsdp within the largest replicated entry.
- `ClipGradByGlobalNorm` under ZeRO-2 and 3, with `axes=("fsdp",)` and
  without: JAX's clipped step (its GSPMD norm is the whole gradients').
- What still raises: tp, pp, sp or ep above 1, a non-mesh, a mesh on
  another device, per-parameter-norm rules over partitions.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import parallel as jpar
from paddle_tpu.framework.trainer import Trainer as JaxTrainer
from paddle_tpu_torch import nn, parallel
from paddle_tpu_torch.framework import Trainer
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import SGD, Adam, Lamb
from paddle_tpu_torch.parallel.sharding import Sharded, rank_bytes
from port_threads import one_torch_thread  # noqa: F401

MLP_MESHES = {"dp8": (dict(dp=8), None), "fsdp8_s1": (dict(fsdp=8), 1),
              "fsdp8_s3": (dict(fsdp=8), 3),
              "dp2_fsdp4_s2": (dict(dp=2, fsdp=4), 2)}


@pytest.fixture(autouse=True)
def _clear_meshes():
    yield
    jpar.set_mesh(None)
    parallel.set_mesh(None)


def _jmlp():
    return jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 4))


def _pmlp():
    g = torch.Generator().manual_seed(5)
    return nn.Sequential(nn.Linear(8, 32, gen=g), nn.ReLU(),
                         nn.Linear(32, 4, gen=g))


def _mlp_data():
    rs = np.random.RandomState(11)
    return rs.randn(32, 8).astype(np.float32), rs.randint(0, 4, (32,))


@pytest.fixture(scope="module")
def mlp_weights():
    pt.seed(11)
    return {k: np.array(v) for k, v in _jmlp().raw_parameters().items()}


def _jax_mlp_trainer(weights, mesh_kw, stage, opt=None, clip=None):
    m = _jmlp()
    m.load_raw_parameters({k: jax.numpy.asarray(v)
                           for k, v in weights.items()})
    mesh = jpar.init_mesh(**mesh_kw) if mesh_kw is not None else None
    if stage is not None:
        jpar.apply_fsdp(m, mesh, stage=stage, min_size=16)
    opt = opt or jopt.Adam(learning_rate=0.01, grad_clip=clip)
    return JaxTrainer(m, opt,
                      lambda o, t: jnn.functional.cross_entropy(o, t),
                      mesh=mesh, donate=False)


def _port_mlp_trainer(weights, mesh_kw, stage, opt=None, clip=None):
    m = load_jax_state(_pmlp(), weights)
    mesh = parallel.init_mesh(**mesh_kw, world_size=8, device="cpu") \
        if mesh_kw is not None else None
    if stage is not None:
        parallel.apply_fsdp(m, mesh, stage=stage, min_size=16)
    opt = opt or Adam(0.01, grad_clip=clip)
    return Trainer(m, opt, lambda o, t: F.cross_entropy(o, t), mesh=mesh)


@pytest.fixture(scope="module")
def jax_mlp_runs(mlp_weights):
    """Per mesh: JAX's 8 losses, final parameters and state."""
    x, y = _mlp_data()
    out = {}
    for name, (kw, stage) in [("base", (None, None))] + list(
            MLP_MESHES.items()):
        tr = _jax_mlp_trainer(mlp_weights, kw, stage)
        losses = [float(tr.train_step(x, y)[0]) for _ in range(8)]
        out[name] = (losses, jax.tree_util.tree_map(np.asarray,
                                                    tr.state.params),
                     tr.state)
        jpar.set_mesh(None)
    return out


@pytest.mark.parametrize("name", list(MLP_MESHES))
def test_mlp_loss_curves_match_jax(name, mlp_weights, jax_mlp_runs):
    kw, stage = MLP_MESHES[name]
    x, y = _mlp_data()
    tr = _port_mlp_trainer(mlp_weights, kw, stage)
    losses = [float(tr.train_step(x, y)[0]) for _ in range(8)]
    want, jparams, _ = jax_mlp_runs[name]
    np.testing.assert_allclose(losses, want, rtol=2e-4, atol=1e-5)
    # and the mesh run equals JAX's one-device run (the reference's bar)
    np.testing.assert_allclose(losses, jax_mlp_runs["base"][0], rtol=2e-4,
                               atol=1e-5)
    assert losses[-1] < losses[0]
    st = tr.gathered_state()
    for k, v in jparams.items():
        err = np.abs(st.params[k].numpy() - v).max() / np.abs(v).max()
        assert err < 1e-4, (k, err)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_per_rank_partitions_match_jax_shards(stage, mlp_weights):
    x, y = _mlp_data()
    jt = _jax_mlp_trainer(mlp_weights, dict(fsdp=8), stage)
    jt.train_step(x, y)
    pt_ = _port_mlp_trainer(mlp_weights, dict(fsdp=8), stage)
    pt_.train_step(x, y)
    jst, st = jt.state, pt_.state

    def same_layout(got, want):
        if want.sharding.is_fully_replicated:
            assert isinstance(got, torch.Tensor)
            assert tuple(got.shape) == want.shape
            return 0
        assert isinstance(got, Sharded) and len(got.parts) == 8
        shard = want.sharding.shard_shape(want.shape)
        assert all(tuple(p.shape) == shard for p in got.parts)
        return 1

    split = sum(same_layout(st.params[k], v) for k, v in
                jst.params.items())
    assert split == (3 if stage == 3 else 0)   # all but the 4-bias
    nslots = sum(same_layout(st.opt_state["slots"][k][sk], sv)
                 for k, s in jst.opt_state["slots"].items()
                 for sk, sv in s.items())
    assert nslots == 6                          # all but the 4-bias's
    mesh = parallel.get_mesh()
    per = rank_bytes(st, mesh)
    total = sum(v.numel() * 4 for s in pt_.gathered_state().opt_state[
        "slots"].values() for v in s.values())
    biggest_whole = 2 * 4 * 4                 # the (4,) bias's 2 slots
    assert len(per) == 8 and len({p["slots"] for p in per}) == 1
    assert abs(per[0]["slots"] - total / 8) <= biggest_whole
    # the values are JAX's: a mesh is a placement
    for k, v in jst.params.items():
        np.testing.assert_allclose(pt_.gathered_state().params[k].numpy(),
                                   np.asarray(v), rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------- #
# the clip under ZeRO-2 / 3
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("stage", [2, 3])
def test_global_norm_clip_over_partitions_matches_jax(stage, mlp_weights):
    from paddle_tpu.nn import ClipGradByGlobalNorm as JClip
    x, y = _mlp_data()
    jt = _jax_mlp_trainer(mlp_weights, dict(fsdp=8), stage,
                          opt=jopt.SGD(learning_rate=1.0,
                                       grad_clip=JClip(0.05)))
    jt.train_step(x, y)
    want = {k: np.asarray(v) for k, v in jt.state.params.items()}
    for axes in (("fsdp",), None):
        tr = _port_mlp_trainer(mlp_weights, dict(fsdp=8), stage,
                               opt=SGD(1.0, grad_clip=nn.ClipGradByGlobalNorm(
                                   0.05, axes=axes)))
        tr.train_step(x, y)
        st = tr.gathered_state()
        moved = max(np.abs(want[k] - mlp_weights[k]).max() for k in want)
        assert moved > 0.01                   # the step did move
        for k, v in want.items():
            # the clipped step moves by at most 0.05 in norm: each
            # entry is within 1e-6 of JAX's
            np.testing.assert_allclose(st.params[k].numpy(), v, atol=1e-6,
                                       rtol=0, err_msg=str((axes, k)))


def test_global_norm_axes_need_a_rank_run():
    clip = nn.ClipGradByGlobalNorm(1.0, axes=("dp",))
    assert clip.axes == ("dp",)
    with pytest.raises(RuntimeError, match="SPMD run"):
        clip({"w": torch.ones(3)})

    def fn(r):
        return clip({"w": torch.full((3,), float(r + 1))})["w"]

    got = parallel.spmd([{"dp": i} for i in range(2)], fn)
    norm = float(np.sqrt(3 * 1.0 + 3 * 4.0))
    for r in range(2):
        np.testing.assert_allclose(got[r].numpy(), (r + 1) / norm,
                                   rtol=1e-6)


# --------------------------------------------------------------------------- #
# what raises
# --------------------------------------------------------------------------- #

def test_mesh_trainer_refuses_what_is_not_ported():
    def make(mesh, opt=None):
        return Trainer(_pmlp(), opt or Adam(0.01),
                       lambda o, t: F.cross_entropy(o, t), mesh=mesh)

    for kw in (dict(tp=2), dict(pp=2, dp=2), dict(sp=2), dict(ep=2)):
        with pytest.raises(NotImplementedError, match="13.4, steps 4-5"):
            make(parallel.init_mesh(**kw, device="cpu"))
    with pytest.raises(TypeError, match="parallel.Mesh"):
        make(object())
    if not torch.cuda.is_available():
        m = parallel.Mesh({"dp": 2}, "cpu")
        m.device = torch.device("meta")
        with pytest.raises(ValueError, match="the model on cpu"):
            make(m)
    with pytest.raises(NotImplementedError, match="each parameter's own"):
        make(parallel.init_mesh(fsdp=2, device="cpu"), Lamb(0.01))
    tr = make(parallel.init_mesh(dp=3, device="cpu"))
    x, y = _mlp_data()
    with pytest.raises(ValueError, match="3 data ranks"):
        tr.train_step(x, y)
