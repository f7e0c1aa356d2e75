"""`parallel.multislice` of the port against the JAX package's
`parallel/multislice.py` on conftest's 8 virtual CPU devices (2
virtual slices of 4).

- The rank grid of `init_multislice_mesh` equals JAX's device-id grid
  for the same dcn / ici dicts (an axis across slices, one in both, a
  grid that is not row-major), and its shape is JAX's mesh shape.
- `detect_slices` (contiguous groups, indivisible counts refused), the
  degree validation, `slice_axes`, `dcn_parallelism`.
- Every public name (`__all__`) of the JAX package's
  `parallel/compression.py`, `localsgd.py`, `multislice.py`, `auto.py`,
  `launch.py`, `elastic.py` and `framework/auto_checkpoint.py` has its
  counterpart in the port's module of that name.
- A Trainer over a multi-slice mesh whose grid is not row-major trains
  bitwise as the plain mesh of the same shape (a step follows the
  coordinates), and its losses are JAX's multi-slice run's within
  JAX's bar (rtol 2e-4, atol 1e-5; `tests/test_parallel.py:155`).
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
from paddle_tpu.parallel import multislice as jms
from paddle_tpu_torch import nn, parallel
from paddle_tpu_torch.framework import Trainer
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.parallel import multislice
from port_threads import one_torch_thread  # noqa: F401

LAYOUTS = {
    "dp_dcn_fsdp_tp_ici": ({"dp": 2}, {"fsdp": 2, "tp": 2}),
    "dp_in_both": ({"dp": 2}, {"dp": 2, "tp": 2}),
    "fsdp_dcn_dp_tp_ici": ({"fsdp": 2}, {"dp": 2, "tp": 2}),
    "pp_dcn_dp_ici": ({"pp": 2}, {"dp": 4}),
    "sp_dcn_dp_fsdp_ici": ({"sp": 2}, {"dp": 2, "fsdp": 2}),
}


STEP6 = ["parallel.compression", "parallel.localsgd", "parallel.multislice",
         "parallel.auto", "parallel.launch", "parallel.elastic",
         "framework.auto_checkpoint"]


@pytest.mark.parametrize("name", STEP6)
def test_every_public_name_is_ported(name):
    import importlib
    jmod = importlib.import_module(f"paddle_tpu.{name}")
    pmod = importlib.import_module(f"paddle_tpu_torch.{name}")
    missing = [n for n in jmod.__all__ if not hasattr(pmod, n)]
    assert not missing and set(jmod.__all__) <= set(pmod.__all__), missing


@pytest.fixture(autouse=True)
def _clear_meshes():
    yield
    jpar.set_mesh(None)
    parallel.set_mesh(None)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_rank_grid_equals_jax_device_grid(name):
    dcn, ici = LAYOUTS[name]
    jmesh = jms.init_multislice_mesh(dcn=dcn, ici=ici, num_slices=2)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    mesh = multislice.init_multislice_mesh(dcn=dcn, ici=ici, num_slices=2,
                                           device="cpu")
    assert np.array_equal(mesh.devices, ids)
    assert tuple(mesh.shape[a] for a in mesh.axis_names) == ids.shape
    assert parallel.get_mesh() is mesh
    # each rank's coordinates are where the grid holds it
    for r in range(8):
        assert mesh.rank_at(mesh.coords(r)) == r


def test_slices_and_validation():
    groups = multislice.detect_slices(num_slices=2, world_size=8)
    assert groups == [[0, 1, 2, 3], [4, 5, 6, 7]]
    jgroups = jms.detect_slices(num_slices=2)
    assert [[d.id for d in g] for g in jgroups] == groups
    with pytest.raises(ValueError, match="not divisible"):
        multislice.detect_slices(num_slices=3, world_size=8)
    with pytest.raises(ValueError, match="devices=|world_size"):
        multislice.detect_slices(num_slices=2)
    with pytest.raises(ValueError, match="multiply to 2, have 4"):
        multislice.init_multislice_mesh(dcn={"dp": 2}, ici={"tp": 2},
                                        num_slices=4, world_size=8)
    with pytest.raises(ValueError, match="slice size is 4"):
        multislice.init_multislice_mesh(dcn={"dp": 2}, ici={"tp": 2},
                                        num_slices=2, world_size=8)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        multislice.init_multislice_mesh(dcn={"xx": 2}, world_size=2)
    assert multislice.slice_axes({"dp": 2, "pp": 1}) == ("dp",)
    assert multislice.dcn_parallelism(4) == {"dp": 4} == \
        jms.dcn_parallelism(4)
    assert multislice.dcn_parallelism(2, "pp") == {"pp": 2}
    with pytest.raises(ValueError, match="DCN-friendly"):
        multislice.dcn_parallelism(2, "tp")
    # without num_slices the slices are dcn's product
    mesh = multislice.init_multislice_mesh(dcn={"dp": 2}, ici={"fsdp": 2},
                                           device="cpu")
    assert mesh.size == 4 and mesh.devices.ravel().tolist() == [0, 1, 2, 3]


def _data():
    rs = np.random.RandomState(11)
    return rs.randn(32, 8).astype(np.float32), rs.randint(0, 4, (32,))


def test_step_over_a_multislice_mesh_equals_the_plain_mesh():
    pt.seed(11)
    jm = jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 4))
    weights = {k: np.array(v) for k, v in jm.raw_parameters().items()}
    x, y = _data()
    jmesh = jms.init_multislice_mesh(dcn={"fsdp": 2}, ici={"dp": 2},
                                     devices=jax.devices()[:4],
                                     num_slices=2)
    jt = JaxTrainer(jm, jopt.Adam(learning_rate=0.01),
                    lambda o, t: jnn.functional.cross_entropy(o, t),
                    mesh=jmesh, donate=False)
    want = [float(jt.train_step(x, y)[0]) for _ in range(4)]

    def run(mesh):
        g = torch.Generator().manual_seed(5)
        m = load_jax_state(nn.Sequential(nn.Linear(8, 32, gen=g), nn.ReLU(),
                                         nn.Linear(32, 4, gen=g)), weights)
        tr = Trainer(m, Adam(0.01), lambda o, t: F.cross_entropy(o, t),
                     mesh=mesh)
        losses = [float(tr.train_step(x, y)[0]) for _ in range(4)]
        return losses, tr.gathered_state().params

    mesh = multislice.init_multislice_mesh(dcn={"fsdp": 2}, ici={"dp": 2},
                                           device="cpu")
    assert mesh.devices.ravel().tolist() == [0, 2, 1, 3]
    got, params = run(mesh)
    plain, pparams = run(parallel.init_mesh(dp=2, fsdp=2, device="cpu"))
    assert got == plain
    assert all(torch.equal(params[k], pparams[k]) for k in params)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
