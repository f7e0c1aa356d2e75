"""Shape / indexing / search ops: the counterpart of
`paddle_tpu/ops/manipulation.py`.

Indices come back int32, as the reference's with x64 off (`argmax`,
`argsort`, `topk`, `nonzero`, `unique`, `shape`); torch's gathers and
scatters take them as int64 inside. The ops whose output shape depends
on the data (`masked_select`, `nonzero`, `unique`,
`unique_consecutive`), which the reference computes in host numpy, run
on the tensor's device here: `unique(return_index=True)` takes the
first position of each value by a scatter-min over the inverse. Only
`tolist` and `item` return host values.
"""
from __future__ import annotations

import builtins

import torch

from .. import core
from ._common import a, dims, long, out, pair

__all__ = [
    "reshape", "transpose", "moveaxis", "swapaxes", "concat", "stack",
    "split", "chunk", "unbind", "squeeze", "unsqueeze", "flatten", "flip",
    "roll", "tile", "expand", "expand_as", "broadcast_to", "repeat_interleave",
    "gather", "gather_nd", "scatter", "scatter_nd_add", "put_along_axis",
    "take_along_axis", "index_select", "index_add", "index_put", "slice",
    "strided_slice", "crop", "pad", "where", "masked_select", "masked_fill",
    "nonzero", "unique", "unique_consecutive", "topk", "sort", "argsort",
    "argmax", "argmin", "searchsorted", "bucketize", "kthvalue", "mode",
    "rot90", "as_real", "as_complex", "view", "view_as", "unfold",
    "shard_index", "tensordot", "numel", "shape", "rank", "is_tensor",
    "tolist", "item", "unstack", "atleast_1d", "atleast_2d", "atleast_3d",
    "vstack", "hstack", "dstack", "column_stack", "row_stack",
]


def reshape(x, shape, name=None):
    return torch.reshape(a(x), tuple(shape))


def view(x, shape_or_dtype, name=None):
    x = a(x)
    if isinstance(shape_or_dtype, (list, tuple)):
        return torch.reshape(x, tuple(shape_or_dtype))
    return x.view(core.convert_dtype(shape_or_dtype))


def view_as(x, other, name=None):
    return torch.reshape(a(x), a(other).shape)


def transpose(x, perm=None, name=None):
    x = a(x)
    if perm is None:
        perm = tuple(reversed(range(x.dim())))
    return x.permute(*perm)


def moveaxis(x, source, destination, name=None):
    return torch.movedim(a(x), source, destination)


def swapaxes(x, axis0, axis1, name=None):
    return torch.swapaxes(a(x), axis0, axis1)


def concat(x, axis=0, name=None):
    return torch.cat([a(t) for t in x], dim=int(axis))


def stack(x, axis=0, name=None):
    return torch.stack([a(t) for t in x], dim=axis)


def vstack(x, name=None):
    return torch.vstack([a(t) for t in x])


def hstack(x, name=None):
    return torch.hstack([a(t) for t in x])


def dstack(x, name=None):
    return torch.dstack([a(t) for t in x])


def column_stack(x, name=None):
    return torch.column_stack([a(t) for t in x])


row_stack = vstack


def split(x, num_or_sections, axis=0, name=None):
    x = a(x)
    axis = int(axis)
    if isinstance(num_or_sections, int):
        if x.shape[axis] % num_or_sections:
            raise ValueError(f"split: axis of {x.shape[axis]} does not "
                             f"divide into {num_or_sections} equal parts")
        return list(torch.tensor_split(x, num_or_sections, dim=axis))
    sizes = list(num_or_sections)
    if builtins.any(s in (-1, None) for s in sizes):
        known = builtins.sum(s for s in sizes if s not in (-1, None))
        sizes = [x.shape[axis] - known if s in (-1, None) else s
                 for s in sizes]
    return list(torch.split(x, sizes, dim=axis))


def chunk(x, chunks, axis=0, name=None):
    """`jnp.array_split`: the first parts one longer where the axis
    does not divide."""
    return list(torch.tensor_split(a(x), chunks, dim=axis))


def unbind(x, axis=0):
    return list(torch.unbind(a(x), dim=axis))


unstack = unbind


def squeeze(x, axis=None, name=None):
    x = a(x)
    if axis is None:
        return torch.squeeze(x)
    axes = tuple(ax for ax in dims(axis, x.dim()) if x.shape[ax] == 1)
    return torch.squeeze(x, axes) if axes else x


def unsqueeze(x, axis, name=None):
    x = a(x)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    n = x.dim() + len(axes)
    for ax in sorted(ax % n for ax in axes):
        x = x.unsqueeze(ax)
    return x


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = a(x)
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


def flip(x, axis, name=None):
    x = a(x)
    return torch.flip(x, dims(axis, x.dim()))


def roll(x, shifts, axis=None, name=None):
    return torch.roll(a(x), shifts, axis)


def tile(x, repeat_times, name=None):
    return torch.tile(a(x), tuple(repeat_times))


def expand(x, shape, name=None):
    return a(x).expand(*[-1 if s is None else s for s in shape])


def expand_as(x, y, name=None):
    return torch.broadcast_to(a(x), a(y).shape)


def broadcast_to(x, shape, name=None):
    return torch.broadcast_to(a(x), tuple(shape))


def repeat_interleave(x, repeats, axis=None, name=None):
    if not isinstance(repeats, int):
        repeats = long(repeats)
    return torch.repeat_interleave(a(x), repeats, dim=axis)


def gather(x, index, axis=0, name=None):
    x = a(x)
    return torch.index_select(x, axis, long(index).reshape(-1).to(x.device))


def gather_nd(x, index, name=None):
    x = a(x)
    return x[tuple(long(index).to(x.device).unbind(-1))]


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows `index` of x replaced by `updates` (`overwrite`), or zeroed
    and then summed into (the reference's non-overwrite mode)."""
    x, updates = a(x), a(updates)
    idx = (long(index).reshape(-1).to(x.device),)
    if overwrite:
        return x.index_put(idx, updates.to(x.dtype))
    zeroed = x.index_put(idx, torch.zeros_like(updates, dtype=x.dtype))
    return zeroed.index_put(idx, updates.to(x.dtype), accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    x = a(x)
    idx = tuple(long(index).to(x.device).unbind(-1))
    return x.index_put(idx, a(updates).to(x.dtype), accumulate=True)


def put_along_axis(arr, indices, values, axis, reduce="assign"):
    arr = a(arr)
    idx = long(indices).to(arr.device)
    vals = torch.broadcast_to(pair(arr, values)[1], idx.shape).to(arr.dtype)
    axis = axis % arr.dim()
    if reduce == "assign":
        return torch.scatter(arr, axis, idx, vals)
    if reduce == "add":
        return torch.scatter_add(arr, axis, idx, vals)
    if reduce in ("multiply", "mul"):
        return torch.scatter_reduce(arr, axis, idx, vals, "prod")
    raise KeyError(reduce)


def take_along_axis(arr, indices, axis, broadcast=True):
    arr = a(arr)
    idx = long(indices).to(arr.device)
    if broadcast:
        shape = list(idx.shape)
        for i in range(arr.dim()):
            if i != axis % arr.dim() and shape[i] == 1:
                shape[i] = arr.shape[i]
        idx = idx.expand(shape)
    return torch.take_along_dim(arr, idx, dim=axis)


def index_select(x, index, axis=0, name=None):
    """`jnp.take` along `axis`: an index of any rank."""
    x = a(x)
    idx = long(index).to(x.device)
    axis = axis % x.dim()
    res = torch.index_select(x, axis, idx.reshape(-1))
    return res.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


def index_add(x, index, axis, value, name=None):
    x = a(x)
    return torch.index_add(x, axis % x.dim(), long(index).to(x.device),
                           a(value).to(x.dtype))


def index_put(x, indices, value, accumulate=False, name=None):
    x = a(x)
    idx = tuple(long(i).to(x.device) for i in indices)
    return x.index_put(idx, pair(x, value)[1].to(x.dtype),
                       accumulate=accumulate)


def _stepped(x, ax, st, en, sd):
    """x[..., st:en:sd, ...] along `ax`, any step (torch slices take
    positive steps only)."""
    if sd > 0:
        sl = [builtins.slice(None)] * x.dim()
        sl[ax] = builtins.slice(st, en, sd)
        return x[tuple(sl)]
    pos = range(*builtins.slice(st, en, sd).indices(x.shape[ax]))
    return torch.index_select(x, ax, torch.tensor(list(pos),
                                                  dtype=torch.long,
                                                  device=x.device))


def slice(x, axes, starts, ends, name=None):
    x = a(x)
    for ax, st, en in zip(axes, starts, ends):
        x = _stepped(x, ax, st, en, 1)
    return x


def strided_slice(x, axes, starts, ends, strides, name=None):
    x = a(x)
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        x = _stepped(x, ax, st, en, sd)
    return x


def crop(x, shape=None, offsets=None, name=None):
    x = a(x)
    offsets = offsets or [0] * x.dim()
    shape = shape or x.shape
    sl = tuple(builtins.slice(o, o + s if s != -1 else None)
               for o, s in zip(offsets, shape))
    return x[sl]


def _pad_index(n, lo, hi, mode, device):
    """The source position of each padded position along an axis of n:
    numpy's "edge" (clamp), "reflect" (no edge repeat) and "wrap"."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    m = torch.remainder(i, period)
    return torch.where(m < n, m, period - m)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    x = a(x)
    pad = list(pad)
    nd = x.dim()
    if len(pad) == nd * 2:
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        # reference convention: [left,right, top,bottom, front,back] — pair j
        # applies to the j-th spatial dim counting from the innermost
        n_spatial = len(pad) // 2
        widths = [(0, 0)] * nd
        if data_format.endswith("C") and nd > 2:  # NHWC/NLC/NDHWC
            spatial = list(range(nd - 2, nd - 2 - n_spatial, -1))
        else:  # NCHW family: innermost spatial is the last dim
            spatial = list(range(nd - 1, nd - 1 - n_spatial, -1))
        for j, d in enumerate(spatial):
            widths[d] = (pad[2 * j], pad[2 * j + 1])
    if mode == "constant":
        flat = []
        for lo, hi in reversed(widths):
            flat += [lo, hi]
        return torch.nn.functional.pad(x, flat, value=value)
    kind = {"reflect": "reflect", "replicate": "edge", "edge": "edge",
            "circular": "wrap"}[mode]
    for d, (lo, hi) in enumerate(widths):
        if lo or hi:
            x = torch.index_select(x, d, _pad_index(x.shape[d], lo, hi, kind,
                                                    x.device))
    return x


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    cond = a(condition)
    if not isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        x, y = a(x, cond.device), a(y, cond.device)
    else:
        x, y = pair(x, y)
    return torch.where(cond, x, y)


def masked_select(x, mask, name=None):
    x = a(x)
    return torch.masked_select(x, a(mask, x.device))


def masked_fill(x, mask, value, name=None):
    x = a(x)
    return torch.where(a(mask, x.device), pair(x, value)[1], x)


def nonzero(x, as_tuple=False):
    idx = out(torch.nonzero(a(x)))
    if as_tuple:
        return tuple(idx.unbind(1))
    return idx


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """`np.unique` on the device: (values[, index][, inverse][, counts]),
    index the first position of each value (a scatter-min of positions
    over the inverse)."""
    x = a(x)
    src = x.reshape(-1) if axis is None else x
    vals, inv, counts = torch.unique(src, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    res = [vals]
    if return_index:
        n = src.shape[0 if axis is None else axis]
        pos = torch.arange(n, device=x.device)
        first = torch.full((vals.shape[0 if axis is None else axis],), n,
                           dtype=pos.dtype, device=x.device)
        res.append(first.scatter_reduce(0, inv, pos, "amin"))
    if return_inverse:
        res.append(inv.reshape(x.shape) if axis is None else inv)
    if return_counts:
        res.append(counts)
    res = out(res)
    return res[0] if len(res) == 1 else tuple(res)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    x = a(x)
    src = x.reshape(-1) if axis is None else x
    vals, inv, counts = torch.unique_consecutive(
        src, return_inverse=True, return_counts=True, dim=axis)
    res = [vals]
    if return_inverse:
        res.append(inv)
    if return_counts:
        res.append(counts)
    res = out(res)
    return res[0] if len(res) == 1 else tuple(res)


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    x = a(x)
    vals, idx = torch.topk(x, k, dim=axis, largest=largest, sorted=True)
    return vals, out(idx)


def sort(x, axis=-1, descending=False, stable=False, name=None):
    x = a(x)
    res = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(res, (axis,)) if descending else res


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    x = a(x)
    idx = out(torch.sort(x, dim=axis, stable=True).indices)
    return torch.flip(idx, (axis,)) if descending else idx


def _arg(fn, x, axis, keepdim, dtype):
    x = a(x)
    if axis is None:
        res = fn(x.reshape(-1), 0)
        if keepdim:
            res = res.reshape((1,) * x.dim())
    else:
        res = fn(x, axis, keepdim=keepdim)
    return res.to(core.convert_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    seq, vals = pair(sorted_sequence, values)
    return torch.searchsorted(seq.contiguous(), vals.contiguous(),
                              right=right, out_int32=True)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """The k-th smallest along `axis` and its index in the stable sort
    (the reference's sort / argsort)."""
    x = a(x)
    axis = axis % x.dim()
    srt = torch.sort(x, dim=axis, stable=True)
    v = srt.values.narrow(axis, k - 1, 1)
    i = out(srt.indices.narrow(axis, k - 1, 1))
    if not keepdim:
        v, i = v.squeeze(axis), i.squeeze(axis)
    return v, i


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along `axis` (the largest among equally
    frequent ones) and the last index holding it, as the reference's
    scan over the sorted values."""
    x = a(x)
    axis = axis % x.dim()
    moved = x.movedim(axis, -1).contiguous()
    srt = torch.sort(moved, dim=-1).values
    counts = (torch.searchsorted(srt, srt, right=True)
              - torch.searchsorted(srt, srt))
    n = srt.shape[-1]
    pos = torch.arange(n, device=x.device)
    best = torch.argmax(counts * n + pos, dim=-1, keepdim=True)
    best_v = torch.gather(srt, -1, best)
    idx = torch.argmax(torch.where(moved == best_v, pos,
                                   torch.full_like(pos, -1)), dim=-1)
    best_v = best_v.squeeze(-1)
    idx = out(idx)
    if keepdim:
        best_v, idx = best_v.unsqueeze(axis), idx.unsqueeze(axis)
    return best_v, idx


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(a(x), k, tuple(axes))


def as_real(x, name=None):
    x = a(x)
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


def as_complex(x, name=None):
    x = a(x)
    return torch.complex(x[..., 0], x[..., 1])


def unfold(x, axis, size, step, name=None):
    """Windows of `size` every `step` along `axis`: the window index at
    `axis`, its contents last."""
    x = a(x)
    return x.unfold(axis % x.dim(), size, step)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Vocab-shard an index tensor (the reference's shard_index op)."""
    input = a(input)
    shard_size = (index_num + nshards - 1) // nshards
    lo, hi = shard_id * shard_size, (shard_id + 1) * shard_size
    in_range = (input >= lo) & (input < hi)
    return torch.where(in_range, input - lo,
                       torch.full_like(input, ignore_value))


def tensordot(x, y, axes=2, name=None):
    return torch.tensordot(*pair(x, y), dims=axes)


def numel(x, name=None):
    x = a(x)
    return torch.tensor(x.numel(), dtype=torch.int32, device=x.device)


def shape(x):
    x = a(x)
    return torch.tensor(x.shape, dtype=torch.int32, device=x.device)


def rank(x):
    x = a(x)
    return torch.tensor(x.dim(), dtype=torch.int32, device=x.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def tolist(x):
    return a(x).tolist()


def item(x):
    return a(x).item()


def _atleast(fn, xs):
    res = [fn(a(x)) for x in xs]
    return res[0] if len(res) == 1 else res


def atleast_1d(*xs):
    return _atleast(torch.atleast_1d, xs)


def atleast_2d(*xs):
    return _atleast(torch.atleast_2d, xs)


def atleast_3d(*xs):
    return _atleast(torch.atleast_3d, xs)
