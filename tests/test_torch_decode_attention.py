"""Port kernel module K1 (`paddle_tpu_torch/ops_cuda/decode_attention.py`)
against the JAX reference kernel.

On CPU tensors the port's wrapper runs its plain split-K version; the
JAX side runs the Pallas kernel in interpret mode, as
tests/test_decode_attention.py does. Same inputs (numpy, seeded), same
block_k / num_splits; outputs agree at atol = rtol = 1e-5 (fp32, only
the summation order differs) and the visited-chunk counts are equal.
The CUDA kernel itself is held against the same plain version on the
card by chip_smoke.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.ops_pallas.decode_attention import (
    ragged_decode_attention as jax_ragged)
from paddle_tpu_torch.ops_cuda import decode_attention as port
from port_threads import one_torch_thread  # noqa: F401


TOL = dict(rtol=1e-5, atol=1e-5)


def _case(S=4, T=64, nh=4, hd=32, B=None, seed=0):
    rng = np.random.RandomState(seed)
    B = B or S
    q = rng.randn(B, nh, hd).astype(np.float32)
    k = rng.randn(S, T, nh, hd).astype(np.float32)
    v = rng.randn(S, T, nh, hd).astype(np.float32)
    return q, k, v


def _both(q, k, v, lengths, block_k, num_splits, slot_map=None):
    lens = np.asarray(lengths, np.int32)
    jkw = {} if slot_map is None else {
        "slot_map": jnp.asarray(np.asarray(slot_map, np.int32))}
    j_out, j_vis = jax_ragged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(lens), block_k=block_k,
                              num_splits=num_splits, interpret=True,
                              with_stats=True, **jkw)
    sm = None if slot_map is None else torch.tensor(slot_map,
                                                   dtype=torch.int32)
    p_out, p_vis = port.ragged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), slot_map=sm, block_k=block_k,
        num_splits=num_splits, with_stats=True)
    return (np.asarray(j_out), np.asarray(j_vis), p_out.numpy(),
            p_vis.numpy())


@pytest.mark.parametrize("num_splits", [1, 2, 4])
@pytest.mark.parametrize("lengths", [
    (1, 17, 40, 64),       # ragged mix incl. full occupancy
    (0, 8, 9, 63),         # an empty lane, chunk edges
])
def test_matches_jax_kernel(num_splits, lengths):
    q, k, v = _case()
    j_out, j_vis, p_out, p_vis = _both(q, k, v, lengths, 8, num_splits)
    np.testing.assert_allclose(p_out, j_out, **TOL)
    np.testing.assert_array_equal(p_vis, j_vis)


def test_slot_map_virtual_lanes_match_jax():
    """The verify layout: 3 virtual lanes per slot, repeated slot ids,
    per-query lengths, one lane with length 0."""
    S, W = 2, 3
    q, k, v = _case(S=S, B=S * W, seed=4)
    slot_map = np.repeat(np.arange(S), W)
    lengths = [0, 21, 22, 5, 6, 64]
    j_out, j_vis, p_out, p_vis = _both(q, k, v, lengths, 8, 2,
                                       slot_map=slot_map)
    np.testing.assert_allclose(p_out, j_out, **TOL)
    np.testing.assert_array_equal(p_vis, j_vis)


def test_zero_lengths_give_zero_output_and_no_visits():
    q, k, v = _case(seed=2)
    j_out, j_vis, p_out, p_vis = _both(q, k, v, (0, 0, 0, 0), 16, 2)
    np.testing.assert_array_equal(p_out, np.zeros_like(p_out))
    np.testing.assert_allclose(p_out, j_out, **TOL)
    np.testing.assert_array_equal(p_vis, np.zeros((4, 2), np.int32))
    np.testing.assert_array_equal(p_vis, j_vis)


def test_visit_counts_are_the_live_chunk_arithmetic():
    q, k, v = _case(T=64, seed=3)
    lens = torch.tensor([1, 15, 16, 17, 33, 47, 48, 64], dtype=torch.int32)
    qq = torch.from_numpy(np.concatenate([q, q]))
    kk = torch.from_numpy(np.concatenate([k, k]))
    vv = torch.from_numpy(np.concatenate([v, v]))
    _, vis = port.ragged_decode_attention(qq, kk, vv, lens, block_k=16,
                                          num_splits=2, with_stats=True)
    split_rows, split_blocks = 32, 2
    want = [[min(max(-(-(int(n) - p * split_rows) // 16), 0), split_blocks)
             for p in range(2)] for n in lens]
    np.testing.assert_array_equal(vis.numpy(), np.asarray(want))


def test_plain_split_merge_matches_full_slab_reference():
    """Inside the port: split-K plain version + merge ≡ the full-slab
    masked attention (fp32, summation order only)."""
    q, k, v = _case(seed=5)
    lens = torch.tensor([3, 64, 0, 30], dtype=torch.int32)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    out = port.ragged_decode_attention(qt, kt, vt, lens, block_k=8,
                                       num_splits=4)
    ref = port.ragged_decode_reference(qt, kt, vt, lens)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


def test_engine_layout_and_bf16():
    """(B, 1, nh, hd) queries keep their layout; bf16 inputs return
    bf16 (merge cast to q's dtype), close to the fp32 result at bf16
    tolerance (atol = rtol = 2e-2)."""
    q, k, v = _case(seed=6)
    lens = torch.tensor([5, 64, 12, 40], dtype=torch.int32)
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = port.ragged_decode_attention(qt[:, None], kt, vt, lens)
    assert out.shape == (4, 1, 4, 32) and out.dtype == torch.bfloat16
    ref = port.ragged_decode_reference(qt.float(), kt.float(), vt.float(),
                                       lens)
    np.testing.assert_allclose(out[:, 0].float().numpy(), ref.numpy(),
                               rtol=2e-2, atol=2e-2)


def test_pick_decode_blocks_default_ladder():
    assert port.pick_decode_blocks(1024, 64, torch.bfloat16) == (256, 2)
    assert port.pick_decode_blocks(64, 32, torch.float32) == (64, 1)
    assert port.pick_decode_blocks(96, 32, torch.float32) == (32, 1)
    assert port.pick_decode_blocks(1024, 64, torch.int8) == (512, 1)


@pytest.mark.parametrize("T,C", [(16, 1), (64, 1), (128, 1), (200, 1),
                                 (256, 2), (384, 3), (1000, 7), (1024, 8),
                                 (4096, 8)])
def test_cluster_size_depends_on_max_seq_alone(T, C):
    """C(T) = min(8, max(1, T // 128)): the CUDA kernel's CTAs per
    (lane, head), each over a fixed range of ceil(T / C) rows that
    covers [0, T) exactly once. It takes T alone: no lengths, block_k,
    dtype or layout enter, so K1 and K4 (and K5 and K6) cut the same
    rows the same way, and the reference's (block_k, num_splits) picks
    stay as they were for the visit counts."""
    assert port.cluster_size(T) == C
    rows = -(-T // C)
    assert (C - 1) * rows < T <= C * rows
    assert port.pick_decode_blocks(1024, 64, torch.bfloat16) == (256, 2)


def test_cuda_argument_checks_raise():
    """The checks the wrapper runs before a CUDA launch (exercised here
    on CPU tensors: they inspect shapes, dtypes and layout only)."""
    q, k, v = (torch.from_numpy(a) for a in _case())
    lens = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    sm = torch.arange(4, dtype=torch.int32)
    port._check_cuda_args(q, k, v, lens, sm, 8, 2)          # accepted
    with pytest.raises(ValueError, match="divisible"):
        port._check_cuda_args(q, k, v, lens, sm, 24, 1)
    with pytest.raises(TypeError, match="int32"):
        port._check_cuda_args(q, k, v, lens.long(), sm, 8, 2)
    with pytest.raises(TypeError, match="dtypes differ"):
        port._check_cuda_args(q, k.double(), v, lens, sm, 8, 2)
    with pytest.raises(ValueError, match="contiguous"):
        port._check_cuda_args(q.transpose(0, 1).contiguous().transpose(0, 1),
                              k, v, lens, sm, 8, 2)
    qq, kk, vv = (torch.from_numpy(a) for a in _case(hd=48))
    with pytest.raises(ValueError, match="head_dim"):
        port._check_cuda_args(qq, kk, vv, lens, sm, 8, 2)


def test_bad_split_raises_on_cpu_too():
    q, k, v = (torch.from_numpy(a) for a in _case())
    lens = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="divisible"):
        port.ragged_decode_attention(q, k, v, lens, block_k=24,
                                     num_splits=1)


# ---------------------------------------------------------------------- #
# K4 (paged), K5 (int8) and K6 (paged int8): plain versions against the
# JAX Pallas kernels in interpret mode
# ---------------------------------------------------------------------- #

def _quant_case(k, v):
    """int8 codes and f32 scales of k and v, made by the JAX
    `kv_quantize` (the port's equals it bitwise, test_torch_kv_quant)."""
    from paddle_tpu.quantization.kv import kv_quantize
    kq, ks = kv_quantize(jnp.asarray(k))
    vq, vs = kv_quantize(jnp.asarray(v))
    return tuple(np.array(a) for a in (kq, vq, ks, vs))


def _paged_case(S=4, T=64, page=16, seed=7, lengths=(1, 17, 40, 64)):
    """Pools with shuffled page ids: lane s's bound pages (enough for
    its length) at random ids, 0 (the trash page) past them."""
    rng = np.random.RandomState(seed)
    q, k, v = _case(S=S, T=T, seed=seed)
    maxp = T // page
    num_pages = 1 + S * maxp + 3
    ids = rng.permutation(np.arange(1, num_pages))[:S * maxp]
    tables = ids.reshape(S, maxp).astype(np.int32)
    for s, n in enumerate(lengths):
        tables[s, -(-n // page):] = 0
    shape = (num_pages, page) + k.shape[2:]
    kp = rng.randn(*shape).astype(np.float32)    # unbound pages: noise
    vp = rng.randn(*shape).astype(np.float32)
    for s in range(S):
        for j in range(maxp):
            if tables[s, j]:
                kp[tables[s, j]] = k[s, j * page:(j + 1) * page]
                vp[tables[s, j]] = v[s, j * page:(j + 1) * page]
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


def _paged_both(q, kp, vp, tables, lens, block_k, num_splits, quant):
    from paddle_tpu.ops_pallas.decode_attention import (
        paged_ragged_decode_attention as jax_paged)
    if quant:
        kq, vq, ks, vs = _quant_case(kp, vp)
        jargs = (jnp.asarray(kq), jnp.asarray(vq))
        jkw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        pargs = (torch.from_numpy(kq), torch.from_numpy(vq))
        pkw = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    else:
        jargs, jkw = (jnp.asarray(kp), jnp.asarray(vp)), {}
        pargs, pkw = (torch.from_numpy(kp), torch.from_numpy(vp)), {}
    j_out, j_vis = jax_paged(jnp.asarray(q), *jargs, jnp.asarray(tables),
                             jnp.asarray(lens), block_k=block_k,
                             num_splits=num_splits, interpret=True,
                             with_stats=True, **jkw)
    p_out, p_vis = port.paged_ragged_decode_attention(
        torch.from_numpy(q), *pargs, torch.from_numpy(tables),
        torch.from_numpy(lens), block_k=block_k, num_splits=num_splits,
        with_stats=True, **pkw)
    return (np.asarray(j_out), np.asarray(j_vis), p_out.numpy(),
            p_vis.numpy())


@pytest.mark.parametrize("quant", [False, True], ids=["K4", "K6"])
@pytest.mark.parametrize("block_k,num_splits", [(8, 1), (8, 2), (16, 4)])
def test_paged_matches_jax_kernel(quant, block_k, num_splits):
    q, kp, vp, tables, lens = _paged_case()
    j_out, j_vis, p_out, p_vis = _paged_both(q, kp, vp, tables, lens,
                                             block_k, num_splits, quant)
    np.testing.assert_allclose(p_out, j_out, **TOL)
    np.testing.assert_array_equal(p_vis, j_vis)


@pytest.mark.parametrize("quant", [False, True], ids=["K4", "K6"])
def test_paged_empty_lane_and_default_blocks_match_jax(quant):
    q, kp, vp, tables, lens = _paged_case(seed=8, lengths=(0, 16, 33, 5))
    j_out, j_vis, p_out, p_vis = _paged_both(q, kp, vp, tables, lens,
                                             None, None, quant)
    np.testing.assert_allclose(p_out, j_out, **TOL)
    np.testing.assert_array_equal(p_vis, j_vis)
    assert not p_out[0].any()


@pytest.mark.parametrize("num_splits", [1, 2])
@pytest.mark.parametrize("slot_map", [None, [1, 1, 0, 3, 3, 2]],
                         ids=["plain", "verify"])
def test_quant_matches_jax_kernel(num_splits, slot_map):
    """K5: int8 codes + scales through the slotted addressing (the
    verify layout's repeated slots included)."""
    B = 4 if slot_map is None else len(slot_map)
    q, k, v = _case(B=B, seed=9)
    kq, vq, ks, vs = _quant_case(k, v)
    lengths = (1, 17, 40, 64, 0, 9)[:B]
    lens = np.asarray(lengths, np.int32)
    jkw = {} if slot_map is None else {
        "slot_map": jnp.asarray(np.asarray(slot_map, np.int32))}
    j_out, j_vis = jax_ragged(jnp.asarray(q), jnp.asarray(kq),
                              jnp.asarray(vq), jnp.asarray(lens), block_k=8,
                              num_splits=num_splits, interpret=True,
                              with_stats=True, k_scale=jnp.asarray(ks),
                              v_scale=jnp.asarray(vs), **jkw)
    sm = None if slot_map is None else torch.tensor(slot_map,
                                                   dtype=torch.int32)
    p_out, p_vis = port.ragged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kq), torch.from_numpy(vq),
        torch.from_numpy(lens), slot_map=sm, block_k=8,
        num_splits=num_splits, with_stats=True,
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_array_equal(p_vis.numpy(), np.asarray(j_vis))


def test_paged_and_quant_plain_match_their_references():
    """Inside the port: the plain split-K versions + merge ≡ the
    full-slab references (paged: gathered through the tables; int8:
    widened in fp32)."""
    q, kp, vp, tables, lens = _paged_case(seed=10)
    qt, kt, vt, tt, lt = map(torch.from_numpy, (q, kp, vp, tables, lens))
    out = port.paged_ragged_decode_attention(qt, kt, vt, tt, lt, block_k=8,
                                             num_splits=2)
    ref = port.paged_decode_reference(qt, kt, vt, tt, lt)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
    kq, vq, ks, vs = map(torch.from_numpy, _quant_case(kp, vp))
    out = port.paged_ragged_decode_attention(qt, kq, vq, tt, lt,
                                             k_scale=ks, v_scale=vs)
    ref = port.paged_decode_reference(qt, kq, vq, tt, lt, k_scale=ks,
                                      v_scale=vs)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
    # a bf16 query over int8 codes returns bf16
    out16 = port.paged_ragged_decode_attention(
        qt.bfloat16()[:, None], kq, vq, tt, lt, k_scale=ks, v_scale=vs)
    assert out16.dtype == torch.bfloat16 and out16.shape == (4, 1, 4, 32)
    np.testing.assert_allclose(out16[:, 0].float().numpy(), ref.numpy(),
                               rtol=2e-2, atol=2e-2)


def test_paged_equals_slotted_on_the_same_rows():
    """The addressing seam does not change the arithmetic: the paged
    plain version over pages holding a slab's rows equals the slotted
    one bitwise (same splits)."""
    q, kp, vp, tables, lens = _paged_case(seed=11)
    S, maxp = tables.shape
    page = kp.shape[1]
    kc = kp[tables].reshape(S, maxp * page, *kp.shape[2:])
    vc = vp[tables].reshape(S, maxp * page, *vp.shape[2:])
    a = port.paged_ragged_decode_attention(
        *map(torch.from_numpy, (q, kp, vp, tables, lens)), block_k=16,
        num_splits=2)
    b = port.ragged_decode_attention(
        *map(torch.from_numpy, (q, kc, vc, lens)), block_k=32, num_splits=2)
    assert torch.equal(a, b)


def test_pick_paged_decode_blocks_follows_the_reference():
    from paddle_tpu.ops_pallas.decode_attention import (
        pick_paged_decode_blocks as jax_pick)
    for T, page, dtype in ((1024, 64, "bfloat16"), (1024, 64, "int8"),
                           (1024, 64, "float32"), (64, 16, "float32"),
                           (64, 8, "int8"), (96, 32, "float32")):
        want = jax_pick(T, page, 64, jnp.dtype(dtype))
        assert port.pick_paged_decode_blocks(
            T, page, 64, getattr(torch, dtype)) == tuple(want)
    assert port.pick_paged_decode_blocks(1024, 64, 64, torch.bfloat16) \
        == (64, 2)
    assert port.pick_paged_decode_blocks(1024, 64, 64, torch.int8) == (64, 1)


def test_cuda_argument_checks_for_paged_and_quant():
    q, kp, vp, tables, lens = (torch.from_numpy(a) for a in _paged_case())
    port._check_cuda_args(q, kp, vp, lens, tables, 8, 2, page_size=16)
    with pytest.raises(ValueError, match="divide the page"):
        port._check_cuda_args(q, kp, vp, lens, tables, 32, 1, page_size=16)
    with pytest.raises(ValueError, match="tables"):
        port._check_cuda_args(q, kp, vp, lens, tables[0], 8, 2,
                              page_size=16)
    kq, vq, ks, vs = map(torch.from_numpy, _quant_case(kp.numpy(),
                                                       vp.numpy()))
    port._check_cuda_args(q, kq, vq, lens, tables, 8, 2, ks, vs,
                          page_size=16)
    with pytest.raises(ValueError, match="together"):
        port._check_cuda_args(q, kq, vq, lens, tables, 8, 2, ks, None,
                              page_size=16)
    with pytest.raises(TypeError, match="int8 kc/vc need"):
        port._check_cuda_args(q, kq, vq, lens, tables, 8, 2, page_size=16)
    with pytest.raises(ValueError, match="scales"):
        port._check_cuda_args(q, kq, vq, lens, tables, 8, 2, ks[:, :8],
                              vs[:, :8], page_size=16)
    with pytest.raises(TypeError, match="need int8"):
        port._check_cuda_args(q, kp, vp, lens, tables, 8, 2, ks, vs,
                              page_size=16)
    with pytest.raises(ValueError, match="together"):
        port.ragged_decode_attention(q, kq[:4], vq[:4], lens,
                                     k_scale=ks[:4])


def test_each_variant_has_its_own_counter():
    counters = {port.launch_counter(p, qz) for p in (False, True)
                for qz in (False, True)}
    assert len(counters) == 4
    assert port.launch_counter(False, False) is port.LAUNCHES
    assert port.launch_counter(True, True) is port.PAGED_QUANT_LAUNCHES
    # CPU tensors run the plain versions and launch nothing
    q, kp, vp, tables, lens = (torch.from_numpy(a) for a in _paged_case())
    port.PAGED_LAUNCHES.reset()
    port.paged_ragged_decode_attention(q, kp, vp, tables, lens)
    assert port.PAGED_LAUNCHES.count == 0
