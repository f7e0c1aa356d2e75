"""`framework.AutoCheckpoint` of the port (the JAX package's
`framework/auto_checkpoint.py`).

- Save and restore, both backends ("pickle" files, "orbax" step
  directories): a fresh trainer resumes at the saved step with the
  state bitwise, and its next steps are bitwise the uninterrupted
  run's; `max_to_keep` prunes; a checkpoint written under a dp 4 mesh
  restores onto dp 2 and onto no mesh (the state holds whole tensors).
- `checkpoint_io` fires at the JAX package's two sites: a fault
  between the pickle backend's complete `.tmp` and its publish leaves
  the previous checkpoint the newest and a `.tmp` that restore sweeps;
  in the step-directory backend it fires before anything is written.
- A pickle checkpoint the JAX package's Trainer wrote (Adam, 3 steps
  of its MLP) restores into the port's Trainer (`rng_key` ignored) and
  the next 3 losses are within 1e-5 relative of JAX continuing it.
"""
import os

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.auto_checkpoint import \
    AutoCheckpoint as JAutoCheckpoint
from paddle_tpu.framework.trainer import Trainer as JaxTrainer
from paddle_tpu_torch import nn, parallel
from paddle_tpu_torch.framework import AutoCheckpoint, Trainer
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.testing import faults
from port_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clear_meshes():
    yield
    parallel.set_mesh(None)


def _data():
    rs = np.random.RandomState(0)
    return rs.randn(16, 8).astype(np.float32), rs.randint(0, 4, (16,))


def _trainer(mesh=None, weights=None):
    g = torch.Generator().manual_seed(0)
    m = nn.Sequential(nn.Linear(8, 16, gen=g), nn.ReLU(),
                      nn.Linear(16, 4, gen=g))
    if weights is not None:
        m = load_jax_state(m, weights)
    return Trainer(m, Adam(5e-2), lambda o, t: F.cross_entropy(o, t),
                   mesh=mesh)


def _same_state(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        for s, t in a.opt_state["slots"][k].items():
            assert torch.equal(t, b.opt_state["slots"][k][s]), (k, s)
    assert (a.step, a.opt_state["step"]) == (b.step, b.opt_state["step"])


@pytest.mark.parametrize("backend", ["pickle", "orbax"])
def test_save_restore_continue_bitwise(tmp_path, backend):
    x, y = _data()
    ref = _trainer()
    want = [float(ref.train_step(x, y)[0]) for _ in range(5)]
    tr = _trainer()
    acp = AutoCheckpoint(tr, str(tmp_path), save_every=1, max_to_keep=2,
                         backend=backend)
    assert acp.restore() == 0 and acp.latest_step() is None
    got = []
    for step in range(1, 4):
        got.append(float(tr.train_step(x, y)[0]))
        acp.step(step)
    names = sorted(os.listdir(tmp_path))
    assert names == (["state.000000000002.pkl", "state.000000000003.pkl"]
                     if backend == "pickle" else ["2", "3"])
    fresh = _trainer()
    acp2 = AutoCheckpoint(fresh, str(tmp_path), backend=backend)
    assert acp2.restore() == 3
    _same_state(fresh.state, tr.state)
    got += [float(fresh.train_step(x, y)[0]) for _ in range(2)]
    assert got == want


def test_restore_onto_another_mesh(tmp_path):
    x, y = _data()
    tr = _trainer(parallel.init_mesh(dp=4, device="cpu"))
    for _ in range(2):
        tr.train_step(x, y)
    AutoCheckpoint(tr, str(tmp_path), backend="pickle").save(2)
    for mesh in (parallel.init_mesh(dp=2, device="cpu"), None):
        other = _trainer(mesh)
        assert AutoCheckpoint(other, str(tmp_path),
                              backend="pickle").restore() == 2
        _same_state(other.gathered_state(), tr.gathered_state())
        assert np.isfinite(float(other.train_step(x, y)[0]))


def test_torn_write_resumes_from_the_previous_checkpoint(tmp_path):
    x, y = _data()
    tr = _trainer()
    acp = AutoCheckpoint(tr, str(tmp_path / "p"), backend="pickle")
    tr.train_step(x, y)
    acp.step(1)
    first = {k: v.clone() for k, v in tr.state.params.items()}
    tr.train_step(x, y)
    plan = faults.FaultPlan().fail_at("checkpoint_io", 1)
    with faults.inject(plan), pytest.raises(faults.InjectedFault):
        acp.step(2)
    assert plan.injected["checkpoint_io"] == 1
    assert os.path.exists(tmp_path / "p" / "state.000000000002.pkl.tmp")
    assert acp.latest_step() == 1
    fresh = _trainer()
    assert AutoCheckpoint(fresh, str(tmp_path / "p"),
                          backend="pickle").restore() == 1
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path / "p"))
    assert all(torch.equal(fresh.state.params[k], first[k]) for k in first)
    # the step-directory backend: the fault comes before any write
    acp = AutoCheckpoint(tr, str(tmp_path / "o"))
    with faults.inject(faults.FaultPlan().fail_at("checkpoint_io", 1)), \
            pytest.raises(faults.InjectedFault):
        acp.save(2)
    assert os.listdir(tmp_path / "o") == []
    os.makedirs(tmp_path / "o" / "5.tmp")
    assert AutoCheckpoint(_trainer(), str(tmp_path / "o")).restore() == 0
    assert os.listdir(tmp_path / "o") == []


def test_a_jax_written_checkpoint_continues_in_the_port(tmp_path):
    x, y = _data()
    pt.seed(0)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    weights = {k: np.array(v) for k, v in jm.raw_parameters().items()}
    jt = JaxTrainer(jm, jopt.Adam(learning_rate=5e-2),
                    lambda o, t: jnn.functional.cross_entropy(o, t),
                    donate=False)
    jacp = JAutoCheckpoint(jt, str(tmp_path), save_every=1,
                           backend="pickle")
    jacp.restore()
    for step in range(1, 4):
        jt.train_step(x, y)
        jacp.step(step)
    want = [float(jt.train_step(x, y)[0]) for _ in range(3)]
    tr = _trainer(weights=weights)
    assert AutoCheckpoint(tr, str(tmp_path), backend="pickle").restore() == 3
    assert tr.state.step == 3 and tr.state.opt_state["step"] == 3
    jparams = jax.tree_util.tree_map(np.asarray, jacp.trainer.state.params)
    assert set(tr.state.params) == set(jparams)
    got = [float(tr.train_step(x, y)[0]) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
