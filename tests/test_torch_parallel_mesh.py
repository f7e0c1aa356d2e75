"""The port's mesh, strategy and collectives against the JAX package's
on conftest's 8 virtual devices.

The mesh: shapes, the wildcard axis over an explicit world size of 8
(the device count JAX reads), a bad mesh, `HybridCommunicateGroup`,
the strategy's dict setters, `fsdp_extend_spec` with its hints. The
collectives: each, in its list form over 8 ranks, equals JAX's
`shard_map` of the same op over an 8-device mesh (float32 inputs whose
sums are exact, so bitwise), and its rank form inside an SPMD run
equals its list form; the runs' turn order and failure paths; the
counts; the RNG tracker and the one-process environment.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from paddle_tpu import parallel as jpar
from paddle_tpu.parallel import mesh_mod as jmesh
from paddle_tpu.parallel.sharding import fsdp_extend_spec as jfsdp_extend
from paddle_tpu_torch import nn, parallel
from paddle_tpu_torch.nn import ranks
from paddle_tpu_torch.parallel import P, collective as C, mesh_mod
from paddle_tpu_torch.parallel.sharding import fsdp_extend_spec
from port_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clear_meshes():
    yield
    jpar.set_mesh(None)
    parallel.set_mesh(None)


def _shard_map(fn, mesh, in_specs, out_specs):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs)


# --------------------------------------------------------------------------- #
# the mesh and the strategy
# --------------------------------------------------------------------------- #

def test_init_mesh_shapes_match_jax():
    assert len(jax.devices()) == 8
    for kw in (dict(dp=2, tp=4), dict(dp=2, fsdp=4), dict(fsdp=8),
               dict(pp=2, dp=2, tp=2)):
        jm = jpar.init_mesh(**kw)
        m = parallel.init_mesh(**kw, world_size=8, device="cpu")
        assert mesh_mod.mesh_shape(m) == jmesh.mesh_shape(jm)
        assert m.axis_names == tuple(jm.axis_names)
        assert parallel.get_mesh() is m
        assert mesh_mod.data_axes(m) == jmesh.data_axes(jm)
        assert np.array_equal(m.devices.shape, jm.devices.shape)
        # rank ids laid out as JAX lays out its device ids
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        assert np.array_equal(m.devices, ids)
        for r in (0, 3, 7):
            c = m.coords(r)
            assert m.devices[tuple(c[a] for a in m.axis_names)] == r
    hcg = parallel.HybridCommunicateGroup(parallel.init_mesh(
        dp=2, tp=4, device="cpu"))
    jh = jpar.HybridCommunicateGroup(jpar.init_mesh(dp=2, tp=4))
    for name in ("get_data_parallel_world_size",
                 "get_model_parallel_world_size",
                 "get_pipe_parallel_world_size",
                 "get_sharding_parallel_world_size",
                 "get_sequence_parallel_world_size",
                 "get_expert_parallel_world_size", "topology", "nranks"):
        assert getattr(hcg, name)() == getattr(jh, name)(), name


def test_wildcard_axis_and_world_size():
    jm = jpar.init_mesh(dp=-1, tp=2)
    m = parallel.init_mesh(dp=-1, tp=2, world_size=8, device="cpu")
    assert mesh_mod.mesh_shape(m)["dp"] == jmesh.mesh_shape(jm)["dp"] == 4
    with pytest.raises(ValueError, match="world_size"):
        parallel.init_mesh(dp=-1, tp=2, device="cpu")
    with pytest.raises(ValueError, match="only one axis"):
        parallel.init_mesh(dp=-1, fsdp=-1, world_size=8, device="cpu")
    # partial: JAX takes the first devices, the port a smaller mesh
    assert parallel.init_mesh(dp=4, world_size=8, device="cpu").size == 4
    assert parallel.init_mesh(dp=4, device="cpu").size == 4


def test_bad_mesh():
    with pytest.raises(ValueError):
        jpar.init_mesh(dp=3, tp=3, allow_partial=False)
    with pytest.raises(ValueError):
        parallel.init_mesh(dp=3, tp=3, world_size=8, allow_partial=False,
                           device="cpu")
    with pytest.raises(ValueError):
        parallel.init_mesh(dp=16, world_size=8, device="cpu")
    with pytest.raises(ValueError):
        parallel.init_mesh(dp=0, device="cpu")
    with pytest.raises(RuntimeError, match="parallel.init_mesh"):
        parallel.HybridCommunicateGroup(None)


def test_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.init_mesh(dp=2)


def test_strategy_dict_setters():
    from paddle_tpu.parallel import DistributedStrategy as JS
    kw = dict(hybrid_configs={"dp_degree": 2, "sharding_degree": 4},
              sharding=True, sharding_configs={"stage": 2},
              amp=True, amp_configs={"level": "O2", "dtype": "float16"},
              recompute_configs={"checkpoint_layers": ("GPTBlock",)},
              gradient_merge_configs={"enable": True, "k_steps": 4},
              dgc_configs={"axis": "fsdp"})
    s, js = parallel.DistributedStrategy(**kw), JS(**kw)
    for f in ("hybrid_configs", "sharding_configs", "amp_configs",
              "recompute_configs", "gradient_merge_configs", "dgc_configs",
              "pipeline_configs"):
        got, want = getattr(s, f), getattr(js, f)
        assert type(got).__name__ == type(want).__name__
        assert vars(got) == vars(want), f
    assert s.hybrid_configs.sharding_degree == 4
    assert parallel.DistributedStrategy().hybrid_configs.dp_degree == -1


def test_fsdp_extend_spec_matches_jax():
    jm = jpar.init_mesh(dp=2, fsdp=2, tp=2)
    m = parallel.init_mesh(dp=2, fsdp=2, tp=2, world_size=8, device="cpu")
    cases = [((None,), (1024, 128), None), ((None,), (1024, 128), (0,)),
             (("tp", None), (1024, 128), (0,)), (("tp", None), (1024, 128),
                                                   None),
             ((None, "tp"), (64, 96), None), ((), (7, 5), None),
             (("fsdp",), (8,), None), ((), (), None)]
    for spec, shape, hint in cases:
        want = jfsdp_extend(JP(*spec) if spec else None, shape, jm,
                            prefer_dims=hint)
        got = fsdp_extend_spec(P(*spec) if spec else None, shape, m,
                               prefer_dims=hint)
        assert (None if want is None else tuple(want)) == \
            (None if got is None else tuple(got)), (spec, shape, hint)
    assert P(("tp", "fsdp"), None) == P(("tp", "fsdp"), None)
    assert nn.Embedding(64, 16, gen=torch.Generator()).weight.fsdp_dims \
        == (0,)


# --------------------------------------------------------------------------- #
# the collectives: list form vs JAX's shard_map over 8 devices
# --------------------------------------------------------------------------- #

def _ranks_of(x, n=8, axis=0):
    return [torch.from_numpy(np.ascontiguousarray(c))
            for c in np.split(np.asarray(x), n, axis=axis)]


@pytest.mark.parametrize("op", ["sum", "max", "min", "avg"])
def test_all_reduce_matches_shard_map(op):
    jm = jpar.init_mesh(dp=8)
    x = np.random.RandomState(0).randint(-8, 8, (8, 4)).astype(np.float32)
    out = _shard_map(lambda v: jpar.all_reduce(v, op=op, group="dp"), jm,
                     (JP("dp"),), JP("dp"))(jnp.asarray(x))
    want = np.asarray(out)[:1]
    got = C.all_reduce(_ranks_of(x), op=op)
    np.testing.assert_array_equal(got.numpy(), want)


def test_all_reduce_prod_in_rank_order():
    parts = [torch.tensor([2.0, -1.0]), torch.tensor([3.0, 4.0]),
             torch.tensor([0.5, -2.0])]
    np.testing.assert_array_equal(
        C.all_reduce(parts, op=C.ReduceOp.PROD).numpy(), [3.0, 8.0])
    with pytest.raises(ValueError, match="unknown reduce op"):
        C.all_reduce(parts, op="median")


def test_all_gather_matches_shard_map():
    jm = jpar.init_mesh(dp=8)
    x = np.arange(16.0, dtype=np.float32).reshape(8, 2)
    out = _shard_map(lambda v: jpar.all_gather(v, group="dp"), jm,
                     (JP("dp"),), JP("dp"))(jnp.asarray(x))
    want = np.asarray(out)[:8]                   # every rank's copy
    got = C.all_gather(_ranks_of(x), group="dp")
    np.testing.assert_array_equal(got.numpy(), want)
    stacked = C.all_gather(_ranks_of(x), tiled=False, axis=0)
    assert stacked.shape == (8, 1, 2)
    with pytest.raises(ValueError, match="single axis"):
        C.all_gather(_ranks_of(x), group=("dp", "fsdp"))


def test_reduce_scatter_matches_shard_map():
    jm = jpar.init_mesh(dp=8)
    x = np.random.RandomState(1).randint(-4, 4, (8, 8)).astype(np.float32)
    # every rank holds x; rank i keeps row i of 8 x
    out = _shard_map(lambda v: jpar.reduce_scatter(v, group="dp"), jm,
                     (JP(None, None),), JP("dp"))(jnp.asarray(x))
    got = C.reduce_scatter([torch.from_numpy(x)] * 8, group="dp")
    np.testing.assert_array_equal(torch.cat(got).numpy(), np.asarray(out))
    with pytest.raises(NotImplementedError):
        C.reduce_scatter([torch.from_numpy(x)] * 8, op="max")


def test_broadcast_matches_shard_map():
    jm = jpar.init_mesh(dp=8)
    x = np.arange(8.0, dtype=np.float32)
    out = _shard_map(lambda v: jpar.broadcast(v, src=3, group="dp"), jm,
                     (JP("dp"),), JP("dp"))(jnp.asarray(x))
    got = C.broadcast(_ranks_of(x), src=3)
    np.testing.assert_array_equal(np.full(8, got.item()), np.asarray(out))


def test_all_to_all_matches_shard_map():
    jm = jpar.init_mesh(dp=8)
    x = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    out = _shard_map(lambda v: jpar.all_to_all(v, group="dp", split_axis=1,
                                               concat_axis=0),
                     jm, (JP("dp", None),), JP("dp", None))(jnp.asarray(x))
    got = C.all_to_all(_ranks_of(x), group="dp", split_axis=1,
                       concat_axis=0)
    np.testing.assert_array_equal(torch.cat(got).numpy(), np.asarray(out))


def test_ppermute_ring_matches_shard_map():
    jm = jpar.init_mesh(dp=8)
    x = np.arange(8.0, dtype=np.float32)
    perm = [(i, (i + 1) % 8) for i in range(8)]
    out = _shard_map(lambda v: jpar.ppermute(v, perm, group="dp"), jm,
                     (JP("dp"),), JP("dp"))(jnp.asarray(x))
    got = C.ppermute(_ranks_of(x), perm)
    np.testing.assert_array_equal(torch.cat(got).numpy(), np.asarray(out))
    # a rank nobody sends to gets zeros, as lax.ppermute gives
    half = [(0, 1), (2, 3)]
    out = _shard_map(lambda v: jpar.send_recv(v, half, group="dp"), jm,
                     (JP("dp"),), JP("dp"))(jnp.asarray(x + 1))
    got = C.send_recv(_ranks_of(x + 1), half)
    np.testing.assert_array_equal(torch.cat(got).numpy(), np.asarray(out))


# --------------------------------------------------------------------------- #
# the rank form inside SPMD runs
# --------------------------------------------------------------------------- #

def test_rank_form_equals_list_form():
    m = parallel.init_mesh(dp=2, fsdp=4, device="cpu")
    coords = m.ranks_over(("dp", "fsdp"))
    xs = [torch.arange(8.0) * (r + 1) for r in range(8)]

    def fn(r):
        x = xs[r]
        return {"sum": C.all_reduce(x, group=("dp", "fsdp")),
                "fsdp_max": C.all_reduce(x, op="max", group="fsdp"),
                "dp_sum": C.all_reduce(x, group="dp"),
                "gather": C.all_gather(x[:2], group="fsdp"),
                "rs": C.reduce_scatter(x, group="fsdp"),
                "a2a": C.all_to_all(x, group="fsdp"),
                "bcast": C.broadcast(x, src=1, group="fsdp"),
                "perm": C.ppermute(x, [(0, 1), (1, 0)], group="dp"),
                "index": C.axis_index("fsdp")}

    before = C.counts()
    got = C.spmd(coords, fn)
    after = C.counts()
    # one count per collective: 8 calls, the rendezvous of 8 ranks for
    # the first, of 2 or 4 ranks (4 or 2 groups) for the others
    assert after["all_reduce"] - before["all_reduce"] == 1 + 2 + 4
    assert after["reduce_scatter"] - before["reduce_scatter"] == 2
    for r, c in enumerate(coords):
        row = [q for q, d in enumerate(coords) if d["dp"] == c["dp"]]
        col = [q for q, d in enumerate(coords) if d["fsdp"] == c["fsdp"]]
        j = row.index(r)
        assert torch.equal(got[r]["sum"], ranks.combine(
            "all_reduce", xs))
        assert torch.equal(got[r]["fsdp_max"], ranks.combine(
            "all_reduce", [xs[q] for q in row], op="max"))
        assert torch.equal(got[r]["dp_sum"], ranks.combine(
            "all_reduce", [xs[q] for q in col]))
        assert torch.equal(got[r]["gather"], torch.cat(
            [xs[q][:2] for q in row]))
        assert torch.equal(got[r]["rs"], ranks.combine(
            "reduce_scatter", [xs[q] for q in row])[j])
        assert torch.equal(got[r]["a2a"], ranks.combine(
            "all_to_all", [xs[q] for q in row])[j])
        assert torch.equal(got[r]["bcast"], xs[row[1]])
        assert torch.equal(got[r]["perm"], xs[col[1 - col.index(r)]])
        assert got[r]["index"] == j
    # every rank of a group shares the one result tensor
    assert got[0]["sum"] is got[7]["sum"]


def test_runs_take_turns_in_rank_order():
    order = []

    def fn(r):
        order.append(("a", r))
        C.barrier(group="dp")
        order.append(("b", r))
        return r

    assert C.spmd([{"dp": i} for i in range(4)], fn) == [0, 1, 2, 3]
    assert order == [("a", r) for r in range(4)] + [("b", r)
                                                   for r in range(4)]


def test_run_failures_raise():
    def boom(r):
        if r == 2:
            raise KeyError("rank 2")
        return C.all_reduce(torch.ones(2), group="dp")

    with pytest.raises(KeyError, match="rank 2"):
        C.spmd([{"dp": i} for i in range(4)], boom)

    def mismatch(r):
        if r == 0:
            return C.all_reduce(torch.ones(2), group="dp")
        return None

    with pytest.raises(RuntimeError, match="never complete"):
        C.spmd([{"dp": i} for i in range(2)], mismatch)

    def other_op(r):
        if r == 0:
            return C.all_reduce(torch.ones(2), group="dp")
        return C.all_gather(torch.ones(2), group="dp")

    with pytest.raises(RuntimeError, match="calls all_gather"):
        C.spmd([{"dp": i} for i in range(2)], other_op)
    with pytest.raises(RuntimeError, match="SPMD run"):
        C.all_reduce(torch.ones(2), group="dp")      # one rank, no run


def test_host_control_plane_and_env():
    assert C.host_broadcast(3) == 3
    assert C.host_all_gather(np.arange(3)).shape == (1, 3)
    assert C.host_all_gather(torch.arange(3)).shape == (1, 3)
    t = torch.ones(2)
    assert C.wait(t) is t
    C.barrier()                                   # outside a run: nothing
    env = parallel.init_parallel_env()
    assert (env.rank, env.world_size, env.nranks) == (0, 1, 1)
    assert parallel.get_rank() == 0 and parallel.get_world_size() == 1
    with pytest.raises(NotImplementedError, match="step 6"):
        parallel.init_parallel_env(num_processes=2)
    g = C.new_group(axes=("dp", "fsdp"))
    parallel.init_mesh(dp=2, fsdp=4, device="cpu")
    assert g.nranks == 8 and C.get_group("fsdp").nranks == 4
    assert C.axis_size(("dp", "fsdp")) == 8 and C.axis_index() == 0


def test_rng_tracker():
    from paddle_tpu_torch.parallel import random_
    from paddle_tpu_torch.nn import rng
    tr = random_.RNGStatesTracker()
    tr.add("a", 7)
    with pytest.raises(ValueError, match="exists"):
        tr.add("a", 8)
    with pytest.raises(ValueError, match="unknown"):
        with tr.rng_state("b"):
            pass
    draws = []
    for _ in range(2):
        with tr.rng_state("a"):
            draws.append(rng.keep_mask(0.5, (64,), "cpu"))
    assert not torch.equal(draws[0], draws[1])     # the stream moves on
    tr.set_states_tracker({"a": (7, 0)})
    with tr.rng_state("a"):
        assert torch.equal(rng.keep_mask(0.5, (64,), "cpu"), draws[0])
    random_.model_parallel_random_seed(5)
    st = parallel.get_rng_state_tracker().get_states_tracker()
    assert st == {"model_parallel_rng": (5 + 1024, 0),
                  "global_seed": (100003 + 5, 0)}
