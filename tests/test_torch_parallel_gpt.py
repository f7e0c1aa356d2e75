"""`Trainer(mesh=)` on `gpt_tiny` against the JAX Trainer on conftest's
8 virtual devices: dp 2 x fsdp 2 at ZeRO stage 2 (config 5's stage),
with `ignore_index` labels spread unevenly over the ranks (rank 0 keeps
2 of its 62 shifted labels, rank 1 half of one row less, rank 2 a row
less, rank 3 all), same weights (carried from the JAX model) and ids:
4 AdamW steps, losses within 2e-5 relative of JAX's, the first the
global mean over the valid labels (the mean of the ranks' means is 10x
the tolerance away); the step's collectives counted; the JAX mesh
state carried into the port by the weight bridge and partitioned on
load. Inside the port, with no JAX run: the mesh step equals one
rank's step on the global batch with dropout and `grad_accum`, with
remat, and with an fp16 GradScaler whose first scale overflows (the
same steps rejected).
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import optimizer as jopt
from paddle_tpu import parallel as jpar
from paddle_tpu.framework.trainer import Trainer as JaxTrainer
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch import parallel
from paddle_tpu_torch.framework import Trainer
from paddle_tpu_torch.models import (from_jax_train_state, gpt_tiny,
                                     load_jax_params, train_state_numpy)
from paddle_tpu_torch.nn import ranks
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel.sharding import Sharded
from port_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clear_meshes():
    yield
    jpar.set_mesh(None)
    parallel.set_mesh(None)


def _gpt_batch():
    ids = np.random.RandomState(0).randint(0, 1024, (8, 32)).astype(
        np.int32)
    labels = ids.copy()
    labels[0:2, 2:] = -100       # rank 0: 2 of its 62 shifted labels
    labels[3, 10:] = -100        # rank 1: half of one row
    labels[5, :] = -100          # rank 2: one row wholly ignored
    return ids, labels


@pytest.fixture(scope="module")
def gpt_weights():
    pt.seed(0)
    return {k: np.array(v) for k, v in
            jax_gpt_tiny().raw_parameters().items()}


def test_gpt_tiny_uneven_ignore_index_matches_jax(gpt_weights):
    ids, labels = _gpt_batch()
    pt.seed(0)
    jm = jax_gpt_tiny()
    jm.load_raw_parameters({k: jax.numpy.asarray(v)
                            for k, v in gpt_weights.items()})
    jmesh = jpar.init_mesh(dp=2, fsdp=2)
    jpar.apply_fsdp(jm, jmesh, stage=2)
    jt = JaxTrainer(jm, jopt.AdamW(learning_rate=1e-3),
                    lambda lg, y: jm.loss(lg, y), mesh=jmesh, donate=False)
    want = [float(jt.train_step(ids, labels)[0]) for _ in range(4)]

    m = load_jax_params(gpt_tiny(seed=1, device="cpu"), gpt_weights)
    mesh = parallel.init_mesh(dp=2, fsdp=2, device="cpu")
    parallel.apply_fsdp(m, mesh, stage=2)
    tr = Trainer(m, AdamW(1e-3), lambda lg, y: m.loss(lg, y), mesh=mesh)
    ranks.reset_counts()
    got = [float(tr.train_step(ids, labels)[0]) for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=2e-5)
    # the first loss is the global mean over the valid labels; the mean
    # of the four ranks' means is 10x the tolerance away
    one = load_jax_params(gpt_tiny(seed=1, device="cpu"), gpt_weights)
    with torch.no_grad():
        logits = one(torch.from_numpy(ids).long())
        glob = float(one.loss(logits, torch.from_numpy(labels)))
        means = [float(one.loss(logits[2 * r:2 * r + 2],
                                torch.from_numpy(labels[2 * r:2 * r + 2])))
                 for r in range(4)]
    assert abs(got[0] - glob) < 1e-5 * glob
    assert abs(np.mean(means) - glob) > 10 * 2e-5 * glob
    # per step: one count all_reduce, one reduce_scatter per dp row and
    # one dp all_reduce per slice of a split parameter, the rest whole
    c = ranks.counts()
    nsplit = sum(d is not None for d in tr._pdims.values())
    nwhole = len(tr._pdims) - nsplit
    assert c["reduce_scatter"] == 4 * 2 * nsplit
    assert c["all_reduce"] == 4 * (1 + 2 * nsplit + nwhole)
    assert c["all_gather"] == 4 * nsplit      # stage 2: the params
    # the state's values are the JAX mesh state's (weights bridge): the
    # port's joined state against JAX's global arrays, within 5% of the
    # largest move 4 AdamW steps make (4 lr): Adam turns gradients of
    # ~1e-9, which torch and XLA round differently, into steps of up to
    # ~lr (seen: 1.4e-4)
    jtree = jax.tree_util.tree_map(np.asarray, jt.state.tree())
    mine = train_state_numpy(tr.state)
    assert mine["opt_state"]["step"] == int(jtree["opt_state"]["step"])
    for k, v in jtree["params"].items():
        assert np.abs(mine["params"][k] - v).max() < 0.05 * 4 * 1e-3, k
        for sk, sv in jtree["opt_state"]["slots"][k].items():
            assert mine["opt_state"]["slots"][k][sk].shape == sv.shape
    # and a JAX mesh state resumes under a port mesh, split on load
    resumed = from_jax_train_state(jtree, optimizer=AdamW(1e-3))
    tr2 = Trainer(load_jax_params(gpt_tiny(seed=2, device="cpu"),
                                  gpt_weights), AdamW(1e-3),
                  lambda lg, y: m.loss(lg, y), mesh=mesh)
    parallel.apply_fsdp(tr2.model, mesh, stage=2)
    tr2.load_state(resumed)
    assert isinstance(tr2.state.opt_state["slots"]["wte.weight"]["moment1"],
                      Sharded)
    assert tr2.state.opt_state["step"] == 4


# --------------------------------------------------------------------------- #
# inside the port: the mesh step is one rank's step on the global batch
# --------------------------------------------------------------------------- #

MESH_CASES = {
    # dropout keeps each rank's rows of one global draw, also per
    # microbatch (the global batch's chunk i, split over the ranks)
    "dropout_grad_accum": (dict(dropout=0.1), dict(grad_accum=2),
                           dict(dp=2, fsdp=2), 1),
    "remat_dp4": (dict(dropout=0.1), dict(remat=True), dict(dp=4), None),
    # fp16 with a GradScaler whose first scale overflows: found_inf is
    # the MAX over the partitions, so both reject the same steps
    "scaler_fp16_stage2": ({}, dict(amp_level="O2", amp_dtype="float16",
                                    scaler=2.0 ** 20),
                           dict(dp=2, fsdp=2), 2),
}


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mesh_step_is_one_ranks_global_step(case):
    """gpt_tiny, 3 AdamW steps on 8 x 32 ids: the losses within 2e-6
    relative of one rank's (fp32; fp16: 2e-3, its own rounding of the
    ranks' smaller GEMMs), the scaler's state equal."""
    from paddle_tpu_torch.amp import GradScaler
    model_kw, kw, mesh_kw, stage = MESH_CASES[case]
    ids = np.random.RandomState(1).randint(0, 1024, (8, 32))

    def run(mesh):
        m = gpt_tiny(seed=0, device="cpu", **model_kw)
        if mesh is not None and stage is not None:
            parallel.apply_fsdp(m, mesh, stage=stage)
        tkw = dict(kw)
        if "scaler" in tkw:
            tkw["scaler"] = GradScaler(init_loss_scaling=tkw["scaler"])
        tr = Trainer(m, AdamW(1e-3), lambda lg, y: m.loss(lg, y),
                     mesh=mesh, **tkw)
        return [float(tr.train_step(ids, ids)[0]) for _ in range(3)], tr

    one, t1 = run(None)
    got, tm = run(parallel.init_mesh(**mesh_kw, device="cpu"))
    rtol = 2e-3 if kw.get("amp_dtype") == "float16" else 2e-6
    np.testing.assert_allclose(got, one, rtol=rtol)
    if "scaler" in kw:
        assert all(torch.equal(t1.state.scaler_state[k],
                               tm.state.scaler_state[k])
                   for k in t1.state.scaler_state)
        assert float(tm.state.scaler_state["scale"]) < 2.0 ** 20
        assert tm.state.opt_state["step"] == t1.state.opt_state["step"] < 3
    if model_kw.get("dropout"):
        # the masks are live: another key gives another loss
        m = gpt_tiny(seed=0, device="cpu", **model_kw)
        tr = Trainer(m, AdamW(1e-3), lambda lg, y: m.loss(lg, y))
        tr.init_state(rng_seed=7)
        assert float(tr.train_step(ids, ids)[0]) != one[0]
