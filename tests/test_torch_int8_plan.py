"""K7's launch plan and packed arithmetic on the CPU
(`paddle_tpu_torch/ops_cuda/int8_linear.py`, `csrc/int8_linear.cu`).

The CUDA kernel runs only on the card, so what surrounds it is checked
here:
- `launch_plan` for every block and head (k, n) of gpt_tiny, GPT-small
  and gpt_1p3b and for the edge shapes of chip_smoke's phase 2b, at m =
  1..4: the ranks' k-ranges cover the quads (and so k) exactly once and
  none is empty; a cluster has at most 8 CTAs; every load starts on a
  multiple of 16 columns (16 bytes); the clusters' stride visits every
  tile once; threads, grid and shared memory fit the kernel's limits.
- A numpy model of the kernel's arithmetic, cut as the plan cuts it:
  the `__byte_perm` selectors of the wrapper's docstring turn 4 row
  words into 4 column words, `__dp4a` adds them against the packed
  codes, the k-lanes' sums go through the rotated reduction rows and
  the ranks' partials are added in rank order. It equals the exact
  int32 product `int_product` bit for bit on random codes with k tails.
- The rotated reduction stores are free of bank conflicts, and the
  int32 sums cannot overflow at the models' k.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops_cuda import int8_linear as k7
from paddle_tpu_torch.quantization import int_product
from port_threads import one_torch_thread  # noqa: F401

H100_SMS = 132


def _model_shapes(hidden, vocab):
    """(k, n) of a GPT block's four linears and of its tied head."""
    return [(hidden, 3 * hidden), (hidden, hidden), (hidden, 4 * hidden),
            (4 * hidden, hidden), (hidden, vocab)]


SHAPES = sorted(set(_model_shapes(128, 1024)           # gpt_tiny
                    + _model_shapes(768, 50304)        # GPT-small
                    + _model_shapes(2048, 50304)       # gpt_1p3b
                    + [(100, 16), (100, 48), (20, 768), (1, 16), (5, 32)]))

# the wrapper docstring's selectors
PRMT_PAIR = (0x5140, 0x7362)        # (a, b) -> t0, t1; (c, d) -> t2, t3
PRMT_COLUMN = (0x5410, 0x7632)      # (t0, t2) -> cols 0, 1; (t1, t3) -> 2, 3


def byte_perm(x, y, sel):
    """`__byte_perm(x, y, sel)` on uint32 arrays: byte i of the result
    is byte (sel >> 4 i) & 7 of the 8 bytes {x, y} (x's low byte first)."""
    src = np.stack([(x >> (8 * b)) & 0xFF for b in range(4)]
                   + [(y >> (8 * b)) & 0xFF for b in range(4)])
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def dp4a(a, b, c):
    """`__dp4a(a, b, c)` for signed operands: c + the 4 byte products."""
    s = c.astype(np.int64)
    for i in range(4):
        s = s + (((a >> (8 * i)) & 0xFF).astype(np.uint8).view(np.int8)
                 .astype(np.int64)
                 * ((b >> (8 * i)) & 0xFF).astype(np.uint8).view(np.int8)
                 .astype(np.int64))
    return s.astype(np.int32)


def pack_codes(qx):
    """(m, k) int8 codes -> (m, ceil(k / 4)) uint32 words, byte i of word
    q = k-row 4q + i, 0 past k."""
    m, k = qx.shape
    quads = -(-k // 4)
    pad = np.zeros((m, 4 * quads), np.int8)
    pad[:, :k] = qx
    return np.ascontiguousarray(pad).view("<u4").reshape(m, quads)


def column_words(rows):
    """(4, 16) weight bytes (a quad's 4 k-rows of 16 columns) -> the 16
    column words the kernel forms: word position j of rows a, b, c, d
    gives columns 4j..4j+3 through the docstring's two rounds."""
    a, b, c, d = np.ascontiguousarray(rows).view("<u4")   # 4 words each
    t0, t1 = (byte_perm(a, b, s) for s in PRMT_PAIR)
    t2, t3 = (byte_perm(c, d, s) for s in PRMT_PAIR)
    cols = np.stack([byte_perm(t0, t2, PRMT_COLUMN[0]),
                     byte_perm(t0, t2, PRMT_COLUMN[1]),
                     byte_perm(t1, t3, PRMT_COLUMN[0]),
                     byte_perm(t1, t3, PRMT_COLUMN[1])], axis=1)
    return cols.reshape(16)                                # column 4j + e


def red_pos(c):
    """The kernel's rotated slot of tile column c in a reduction row."""
    g, chunk = c >> 4, (c >> 2) & 3
    return 16 * g + 4 * ((chunk + g + (g >> 2)) & 3) + (c & 3)


def kernel_model(qx, qw, plan):
    """The int32 sums the kernel forms under `plan`, step by step."""
    m, k = qx.shape
    n = qw.shape[1]
    g_n, s_n = plan.groups, plan.cluster
    lanes, tile_cols = plan.threads // g_n, 16 * g_n
    quads = -(-k // 4)
    tiles = -(-(n // 16) // g_n)
    clusters = plan.grid // s_n
    xw = pack_codes(qx)
    wpad = np.zeros((4 * quads, n), np.int8)
    wpad[:k] = qw
    out = np.zeros((m, n), np.int32)
    slots = np.array([red_pos(c) for c in range(tile_cols)])
    for cl in range(clusters):
        for tile in range(cl, tiles, clusters):
            c0 = tile * tile_cols
            total = np.zeros((m, tile_cols), np.int32)
            for rank in range(s_n):           # the ranks' partials, in order
                q0 = rank * plan.quads_per_cta
                q1 = min(quads, q0 + plan.quads_per_cta)
                red = np.zeros((lanes, m, tile_cols), np.int32)
                for kl in range(lanes):
                    for g in range(g_n):
                        col = c0 + 16 * g
                        acc = np.zeros((m, 16), np.int32)
                        for q in range(q0 + kl, q1, lanes):
                            if col >= n:
                                break
                            rows = np.ascontiguousarray(
                                wpad[4 * q:4 * q + 4, col:col + 16])
                            acc = dp4a(column_words(rows)[None, :],
                                       xw[:, q:q + 1], acc)
                        red[kl, :, slots[16 * g:16 * g + 16]] = acc.T
                total += red.sum(axis=0, dtype=np.int32)[:, slots]
            live = min(tile_cols, n - c0)
            out[:, c0:c0 + live] = total[:, :live]
    return out


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("k,n", SHAPES)
def test_plan_covers_k_once(k, n, m):
    plan = k7.launch_plan(m, k, n, H100_SMS)
    quads = -(-k // 4)
    assert 1 <= plan.cluster <= 8
    assert plan.groups in (1, 2, 4) and plan.groups <= n // 16
    ranges = [(r * plan.quads_per_cta,
               min(quads, (r + 1) * plan.quads_per_cta))
              for r in range(plan.cluster)]
    assert all(lo < hi for lo, hi in ranges)             # no empty rank
    covered = [q for lo, hi in ranges for q in range(lo, hi)]
    assert covered == list(range(quads))                  # each quad once
    rows = [4 * q + i for q in covered for i in range(4) if 4 * q + i < k]
    assert rows == list(range(k))                         # each k-row once
    tile_cols = 16 * plan.groups
    tiles = -(-(n // 16) // plan.groups)
    clusters = plan.grid // plan.cluster
    assert plan.grid % plan.cluster == 0 and 1 <= clusters <= tiles
    visited = sorted(t for c in range(clusters)
                     for t in range(c, tiles, clusters))
    assert visited == list(range(tiles))                  # each tile once
    starts = sorted(t * tile_cols + 16 * g for t in range(tiles)
                    for g in range(plan.groups))
    # every 16-column group loads from one start on a 16-byte boundary;
    # the starts past n are the last tile's dead groups, which load nothing
    assert [c for c in starts if c < n] == list(range(0, n, 16))
    assert plan.threads % 32 == 0 and 16 * plan.groups <= plan.threads <= 256
    assert plan.threads % plan.groups == 0
    assert k7.smem_bytes(m, plan) <= 232448
    assert plan.grid <= 2 * H100_SMS or plan.cluster * tiles > 2 * H100_SMS


@pytest.mark.parametrize("k,n", [(100, 16), (100, 48), (20, 768), (5, 32),
                                 (130, 64), (128, 384), (512, 128),
                                 (1030, 48)])
def test_packed_accumulation_equals_int_product(k, n):
    rng = np.random.RandomState(k * 7919 + n)
    for m in (1, 4):
        qx = rng.randint(-127, 128, (m, k)).astype(np.int8)
        qw = rng.randint(-127, 128, (k, n)).astype(np.int8)
        plan = k7.launch_plan(m, k, n, H100_SMS)
        want = int_product(torch.from_numpy(qx), torch.from_numpy(qw))
        got = kernel_model(qx, qw, plan)
        np.testing.assert_array_equal(got, want.numpy())
        # the same sums under a cut with several ranks, lanes and tiles
        small = k7.launch_plan(m, k, n, 2)
        np.testing.assert_array_equal(kernel_model(qx, qw, small),
                                      want.numpy())


def test_column_words_follow_k():
    """Byte i of column word e is k-row i of column 4j + e."""
    rng = np.random.RandomState(3)
    rows = rng.randint(0, 256, (4, 16)).astype(np.uint8)
    cols = column_words(rows)
    for c in range(16):
        got = [(int(cols[c]) >> (8 * i)) & 0xFF for i in range(4)]
        assert got == list(rows[:, c])


@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_reduction_stores_are_conflict_free(groups, m):
    """Each 16-byte store of the reduction pass (chunk j of row m) goes
    out in phases of 8 threads; under the padded k-lane stride and the
    rotation every phase hits 8 different 4-bank groups, and the slots
    of a 16-column group are a permutation of its 16 words."""
    stride = 16 * m * groups + 4 * groups
    for c0 in range(0, 16 * groups, 16):
        assert sorted(red_pos(c) for c in range(c0, c0 + 16)) == \
            list(range(c0, c0 + 16))
    for j in range(4):
        for row in range(m):
            for phase in range(256 // 8):
                banks = set()
                for t in range(8 * phase, 8 * phase + 8):
                    g, kl = t % groups, t // groups
                    word = (kl * stride + row * 16 * groups + 16 * g
                            + 4 * ((j + g + (g >> 2)) & 3))
                    banks.add((word // 4) % 8)
                assert len(banks) == 8


def test_int32_sums_cannot_overflow():
    """|acc| <= 127^2 k: below 2^31 at every k the models use (GPT-small
    3072, gpt_1p3b's fc2 8192), so a split's partials add exactly."""
    for k, _ in SHAPES:
        assert 127 * 127 * k < 2 ** 31
    assert 127 * 127 * 133144 < 2 ** 31 <= 127 * 127 * 133145


@pytest.mark.parametrize("bad", [dict(m=0), dict(m=5), dict(n=24),
                                 dict(n=0), dict(k=0)])
def test_plan_refuses_what_the_kernel_does_not_take(bad):
    args = {**dict(m=4, k=768, n=768, num_sms=H100_SMS), **bad}
    with pytest.raises(ValueError):
        k7.launch_plan(**args)


def test_plan_takes_long_k_through_more_ranks():
    """A k whose codes would not fit one CTA's shared memory is cut over
    more ranks; one past what 8 ranks hold raises."""
    plan = k7.launch_plan(4, 200_000, 16, H100_SMS)
    assert plan.cluster == 8 and k7.smem_bytes(4, plan) <= 232448
    with pytest.raises(ValueError, match="too long"):
        k7.launch_plan(4, 400_000, 16, H100_SMS)
