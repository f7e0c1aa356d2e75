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
