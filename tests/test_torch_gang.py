"""Several port processes over gloo on the CPU: `parallel.env`, the
host plane, a mesh whose ranks span processes, `launch` and `elastic`
with `framework.AutoCheckpoint`. Workers are fresh interpreters that
import neither `jax` nor `paddle_tpu` and run torch on one thread;
every gloo group has a 30 s timeout, every gang a whole-run timeout.

- Two processes (`launch_local`): `host_all_gather`,
  `host_broadcast`, `barrier`, and `fleet.metrics` (AUC from each
  process's half of the data equals the AUC of all of it); then
  `gpt_tiny` with dropout 0.1 on a dp 4 mesh, two ranks per process,
  three AdamW steps: the losses, the output rows and the final
  parameters bitwise those of the one-process dp 4 mesh (the ranks'
  gradients cross whole and every process sums them in rank order).
  A missing peer raises within the group's timeout.
- Kill and resume (`ElasticController`, 2 processes, dp 2,
  `AutoCheckpoint(save_every=1)`): process 1 dies after step 3; the
  other, its exchange failed, waits to be stopped (as a JAX survivor
  hangs in its collective); the gang relaunches, resumes from step 3,
  and every later loss and the final parameters are bitwise an
  uninterrupted one-process dp 2 run's.
- Shrink (`np_range=(2, 3)`): the slot of process 2 dies at step 2 of
  the 3-process gang; the gang goes on as 2 processes on a dp 2 mesh
  from the checkpoint, and the final loss is within 1e-5 relative of
  one rank training on the whole batch (another sum order: not
  bitwise).
"""
import json
import os
import textwrap
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch import parallel
from paddle_tpu_torch.framework import Trainer
from paddle_tpu_torch.metric import Auc
from paddle_tpu_torch.models import gpt_tiny
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.parallel.elastic import ElasticController
from paddle_tpu_torch.parallel.launch import free_port, launch_local
from port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HEADER = """
import json, os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
from paddle_tpu_torch import parallel
from paddle_tpu_torch.framework import AutoCheckpoint, Trainer
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Adam, AdamW
env = parallel.init_parallel_env(timeout=30)
rank, world = env.rank, env.world_size
inc = int(os.environ.get("PTPU_ELASTIC_INCARNATION", "0"))
assert "jax" not in sys.modules and "paddle_tpu" not in sys.modules
"""

GANG = HEADER + """
from paddle_tpu_torch.parallel import collective as C, fleet_metrics
from paddle_tpu_torch.metric import Auc
from paddle_tpu_torch.models import gpt_tiny
out = {{"world": world}}
out["gather"] = C.host_all_gather(np.array([rank, 10 + rank])).tolist()
t = C.host_all_gather(torch.tensor([rank + 0.5], dtype=torch.bfloat16))
out["gather_bf16"] = [t.dtype == torch.bfloat16, t.float().tolist()]
out["bcast"] = C.host_broadcast(torch.tensor([7.0 * rank + 1]),
                                src=1).tolist()
C.barrier()
rs = np.random.RandomState(3)
preds, labels = rs.rand(400), rs.randint(0, 2, 400)
auc = Auc()
auc.update(preds[rank::2], labels[rank::2])
out["auc"] = fleet_metrics.auc(auc._stat_pos, auc._stat_neg)
out["dist_auc"] = fleet_metrics.DistributedMetric(auc).accumulate()
out["sum"] = fleet_metrics.sum(np.array([rank + 1.0])).tolist()
mesh = parallel.init_mesh(dp=4, device="cpu")
assert list(mesh.local_ranks()) == [2 * rank, 2 * rank + 1]
m = gpt_tiny(seed=0, device="cpu", dropout=0.1)
tr = Trainer(m, AdamW(1e-3), lambda lg, y: m.loss(lg, y), mesh=mesh)
ids = np.random.RandomState(0).randint(0, 1024, (8, 32))
losses = []
for _ in range(3):
    loss, logits = tr.train_step(ids, ids)
    losses.append(float(loss))
out["losses"] = losses
out["transport"] = C.TRANSPORT
torch.save({{"logits": logits, "params": tr.gathered_state().params}},
           {result!r} + f".{{rank}}.pt")
with open({result!r} + f".{{rank}}.json", "w") as f:
    json.dump(out, f)
"""

ELASTIC = HEADER + """
from paddle_tpu_torch import nn
np_rs = np.random.RandomState(0)
x = np_rs.randn(12, 8).astype(np.float32)
y = np_rs.randint(0, 4, (12,))
g = torch.Generator().manual_seed(0)
model = nn.Sequential(nn.Linear(8, 16, gen=g), nn.ReLU(),
                      nn.Linear(16, 4, gen=g))
mesh = parallel.init_mesh(dp=world, device="cpu")
tr = Trainer(model, Adam(5e-2), lambda o, t: F.cross_entropy(o, t),
             mesh=mesh)
acp = AutoCheckpoint(tr, {ckpt!r}, save_every=1, backend={backend!r})
start = acp.restore()
log = open({log!r} + f".r{{rank}}", "a")
for step in range(start + 1, 7):
    try:
        loss, _ = tr.train_step(x, y)
    except RuntimeError:
        time.sleep(120)         # a peer is gone: wait to be stopped
        sys.exit(3)
    print(f"i{{inc}} np{{world}} step {{step}} loss {{float(loss)!r}}",
          file=log, flush=True)
    acp.step(step)
    if rank == world - 1 and world == {die_world} and step == {die_at}:
        os._exit(1)             # a failure mid-training
if rank == 0:
    torch.save({{"params": tr.gathered_state().params,
                 "loss": float(loss), "world": world, "inc": inc}},
               {result!r})
"""


@pytest.fixture(autouse=True)
def _clear_meshes():
    yield
    parallel.set_mesh(None)


def _script(tmp_path, name, body, **kw):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        f.write(textwrap.dedent(body.format(repo=REPO, **kw)))
    return path


def _mlp_run(world, steps, rows=12):
    """The one-process reference of the ELASTIC worker."""
    from paddle_tpu_torch import nn
    rs = np.random.RandomState(0)
    x, y = rs.randn(rows, 8).astype(np.float32), rs.randint(0, 4, (rows,))
    g = torch.Generator().manual_seed(0)
    model = nn.Sequential(nn.Linear(8, 16, gen=g), nn.ReLU(),
                          nn.Linear(16, 4, gen=g))
    mesh = parallel.init_mesh(dp=world, device="cpu") if world else None
    tr = Trainer(model, Adam(5e-2), lambda o, t: F.cross_entropy(o, t),
                 mesh=mesh)
    losses = [float(tr.train_step(x, y)[0]) for _ in range(steps)]
    return losses, tr.gathered_state().params


def test_two_processes_host_plane_metrics_and_a_bitwise_dp_step(tmp_path):
    result = str(tmp_path / "gang")
    script = _script(tmp_path, "gang.py", GANG, result=result)
    assert launch_local(script, [], 2, devices_per_proc=2,
                        log_dir=str(tmp_path / "logs"), timeout=120) == 0, \
        open(tmp_path / "logs" / "worker.0.log").read()[-3000:]
    outs = [json.load(open(f"{result}.{r}.json")) for r in (0, 1)]
    for o in outs:
        assert o["world"] == 2
        assert o["gather"] == [[0, 10], [1, 11]]
        assert o["gather_bf16"] == [True, [[0.5], [1.5]]]
        assert o["bcast"] == [8.0]
        assert o["sum"] == [3.0]
    whole = Auc()
    rs = np.random.RandomState(3)
    preds, labels = rs.rand(400), rs.randint(0, 2, 400)
    whole.update(preds, labels)
    assert outs[0]["auc"] == outs[1]["auc"] == whole.accumulate()
    assert outs[0]["dist_auc"] == whole.accumulate()
    # the one-process dp 4 mesh on the same batch
    m = gpt_tiny(seed=0, device="cpu", dropout=0.1)
    tr = Trainer(m, AdamW(1e-3), lambda lg, y: m.loss(lg, y),
                 mesh=parallel.init_mesh(dp=4, world_size=4, device="cpu"))
    ids = np.random.RandomState(0).randint(0, 1024, (8, 32))
    want = []
    for _ in range(3):
        loss, logits = tr.train_step(ids, ids)
        want.append(float(loss))
    params = tr.gathered_state().params
    for r in (0, 1):
        assert outs[r]["losses"] == want
        got = torch.load(f"{result}.{r}.pt")
        assert torch.equal(got["logits"], logits[4 * r:4 * r + 4])
        assert all(torch.equal(got["params"][k], params[k]) for k in params)
        # one exchange per step for the losses, one per dtype for the
        # gradients (fp32): 2 a step
        assert outs[r]["transport"]["calls"] == 6


def test_missing_peer_raises_within_the_timeout():
    t0 = time.time()
    with pytest.raises(Exception, match="[Tt]ime"):
        parallel.init_parallel_env(f"127.0.0.1:{free_port()}", 2, 0,
                                   timeout=2)
    assert time.time() - t0 < 20
    assert not parallel.env.is_initialized()


def _steps(log):
    by = {}
    for ln in open(log).read().split("\n"):
        if ln:
            p = ln.split()
            by.setdefault(int(p[3]), []).append((p[0], p[1], float(p[5])))
    return by


def test_kill_and_resume_is_bitwise_an_uninterrupted_run(tmp_path):
    result, log = str(tmp_path / "res.pt"), str(tmp_path / "losses")
    script = _script(tmp_path, "w.py", ELASTIC, ckpt=str(tmp_path / "ck"),
                     log=log, result=result, backend="pickle", die_world=2,
                     die_at=3)
    ctrl = ElasticController(script, nproc=2,
                             master=f"127.0.0.1:{free_port()}",
                             log_dir=str(tmp_path / "logs"), max_restarts=2,
                             poll_interval=0.05, timeout=120)
    assert ctrl.run() == 0
    assert ctrl.restarts == 1
    res = torch.load(result)
    assert res["inc"] == 1 and res["world"] == 2
    by = _steps(log + ".r0")
    assert sorted(by) == list(range(1, 7))
    assert by[3][0][0] == "i0" and by[4][-1][0] == "i1"
    want, params = _mlp_run(2, 6)
    assert [by[s][-1][2] for s in range(1, 7)] == want
    assert all(torch.equal(res["params"][k], params[k]) for k in params)


def test_shrink_from_three_processes_to_two(tmp_path):
    result, log = str(tmp_path / "res.pt"), str(tmp_path / "losses")
    script = _script(tmp_path, "w.py", ELASTIC, ckpt=str(tmp_path / "ck"),
                     log=log, result=result, backend="pickle", die_world=3,
                     die_at=2)
    ctrl = ElasticController(script, nproc=3,
                             master=f"127.0.0.1:{free_port()}",
                             log_dir=str(tmp_path / "logs"), max_restarts=2,
                             poll_interval=0.05, np_range=(2, 3),
                             permanent_after=1, timeout=120)
    assert ctrl.run() == 0
    assert ctrl.nproc == 2 and ctrl.resizes == [(1, 3, 2)]
    res = torch.load(result)
    assert res["world"] == 2
    by = _steps(log + ".r0")
    assert sorted(by) == list(range(1, 7))
    assert by[2][0][1] == "np3" and by[6][-1][1] == "np2"
    want, _ = _mlp_run(None, 6)
    np.testing.assert_allclose(res["loss"], want[-1], rtol=1e-5)
