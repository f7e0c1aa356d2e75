"""The functional ops of the GPT and ResNet training paths, in PyTorch.

A subset of `paddle_tpu/nn/functional.py` with the same rounding points:
`linear` is `x @ w` (weight (in, out)) with the bias cast to the output
dtype, and under `amp.auto_cast` (O1) casts x and w to the compute
dtype first, as the JAX `linear` does; `layer_norm` normalises in fp32,
casts to the activation dtype and THEN applies weight and bias in that
dtype (so bf16 stays bf16; the serving path's `models.gpt._ln` keeps
the decode wiring's fp32 affine); `gelu` and `embedding` as in JAX;
`dropout` (both modes, `axis`), `dropout2d`, `dropout3d` and
`alpha_dropout` draw their masks from the training step's key
(`nn.rng`); `scaled_dot_product_attention` goes through the dispatcher
of `ops_cuda.flash_attention` (the flash kernels, or the dense
function for a mask or dropout).

The ResNet path's ops mirror the JAX package's XLA formulas (none of
them reaches a `pallas_call`): `conv1d` / `conv2d` / `conv3d` take the
reference's padding forms (an int, per-dimension ints, 2·nd ints,
(lo, hi) pairs, "SAME" / "VALID"), `groups`, `dilation` and a
channels-last `data_format`, whose input is handed to the convolution
as a permuted (`channels_last`) view with no copy, and cast through
`amp.white_op_hint` under O1; `batch_norm` returns (out, new_mean,
new_var) with JAX's statistics (shifted by the running mean, E[x²] −
E[x]² in fp32, the biased batch variance into the running one,
momentum 0.9 meaning new = 0.9·old + 0.1·batch) and normalises in the
activation dtype; `max_pool2d` / `avg_pool2d` are `reduce_window` over
the padded input (`ceil_mode` widens the high side, `exclusive` counts
only the real entries); `adaptive_avg_pool2d` means axis by axis;
`cross_entropy` has hard and soft labels, `ignore_index`, `weight`,
`label_smoothing` and `reduction`.
"""
from __future__ import annotations

import math

import torch

from .. import amp as _amp
from ..ops_cuda import flash_attention as _fa
from . import rng as _rng

__all__ = ["linear", "layer_norm", "gelu", "relu", "embedding", "dropout",
           "dropout2d", "dropout3d", "alpha_dropout",
           "scaled_dot_product_attention", "conv1d", "conv2d", "conv3d",
           "batch_norm", "max_pool2d", "avg_pool2d", "adaptive_avg_pool2d",
           "flatten", "cross_entropy"]


def linear(x, weight, bias=None):
    """y = x @ weight + bias, weight stored (in_features, out_features);
    a white-list op under O1."""
    x, weight = _amp.white_op_hint(x, weight, op="linear")
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """Statistics in fp32 (at least), the centred (x - mean)^2 variance;
    the normalised value is cast to x's dtype before the affine, which
    runs in x's dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def gelu(x, approximate: bool = False):
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def relu(x):
    return torch.relu(x)


def embedding(x, weight):
    return weight[x]


def _weak(v: float, x):
    """A Python number as JAX meets it beside an array: in the array's
    dtype (a weak type), so x / (1 - p) divides a bf16 x by a bf16
    1 - p."""
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def dropout(x, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train", keep=None):
    """JAX's `dropout`: in training each entry is kept with probability
    1 - p (one draw per position of the kept `axis` dims, broadcast
    over the others) and, in "upscale_in_train" mode, divided by 1 - p;
    "downscale_in_infer" multiplies by 1 - p outside training instead.
    `keep` (bool, the mask's shape) replaces the draw: the tests hold
    the arithmetic against JAX's own mask with it."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * _weak(1 - p, x)
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    if keep is None:
        keep = _rng.keep_mask(1.0 - p, shape, x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / _weak(1.0 - p, x), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def dropout2d(x, p: float = 0.5, training: bool = True,
              data_format: str = "NCHW", keep=None):
    """Whole channels: one draw per (sample, channel)."""
    axis = (0, 1) if data_format == "NCHW" else (0, 3)
    return dropout(x, p=p, axis=axis, training=training, keep=keep)


def dropout3d(x, p: float = 0.5, training: bool = True,
              data_format: str = "NCDHW", keep=None):
    axis = (0, 1) if data_format == "NCDHW" else (0, 4)
    return dropout(x, p=p, axis=axis, training=training, keep=keep)


def alpha_dropout(x, p: float = 0.5, training: bool = True, keep=None):
    """SELU-preserving dropout: dropped entries take -alpha scale, then
    the affine a x + b that keeps mean and variance."""
    if not training or p == 0.0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    if keep is None:
        keep = _rng.keep_mask(1.0 - p, x.shape, x.device)
    a = (1.0 / ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5)
    b = -a * alpha_p * p
    return (_weak(a, x) * torch.where(keep, x, _weak(alpha_p, x))
            + _weak(b, x)).to(x.dtype)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True):
    """Layout (batch, seq, heads, head_dim); the flash kernels K2/K3 on
    CUDA tensors, their plain versions on CPU tensors; a mask or
    dropout (in training) through `attention_dense`."""
    return _fa.dot_product_attention(
        query, key, value, mask=attn_mask, causal=is_causal,
        dropout_p=dropout_p if training else 0.0)


# --------------------------------------------------------------------------- #
# convolution
# --------------------------------------------------------------------------- #

_CHANNELS_LAST = ("NLC", "NHWC", "NDHWC")


def _tupleize(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(v) * n if len(v) == 1 else tuple(v)
    return (v,) * n


def _conv_padding(padding, nd):
    """The reference's padding forms as "SAME" / "VALID" or nd (lo, hi)
    pairs: an int, nd ints, 2·nd ints (lo, hi per dimension) or nd
    pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if len(padding) == nd and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * nd and all(isinstance(p, int) for p in padding):
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nd)]
    if all(isinstance(p, (list, tuple)) for p in padding):
        return [tuple(p) for p in padding]
    raise ValueError(f"bad padding {padding!r}")


def _resolve_pads(padding, nd, sizes, window, stride):
    """(lo, hi) per spatial dimension; "SAME" as XLA pads it
    (`lax.padtype_to_pads`: out = ceil(in / stride), the excess split
    with the odd element on the high side)."""
    pads = _conv_padding(padding, nd)
    if pads == "VALID":
        return [(0, 0)] * nd
    if pads == "SAME":
        out = []
        for n, k, s in zip(sizes, window, stride):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            out.append((total // 2, total - total // 2))
        return out
    if isinstance(pads, str):
        raise ValueError(f"bad padding {padding!r}")
    return pads


def _channels_first(x, nd):
    """A channels-last tensor as its (N, C, *spatial) view, no copy."""
    return x.permute(0, nd + 1, *range(1, nd + 1))


def _channels_last(x, nd):
    return x.permute(0, *range(2, nd + 2), 1)


def _pad_spatial(x, pads, value=0.0):
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return torch.nn.functional.pad(x, flat, value=value)


def _conv(x, weight, bias, stride, padding, dilation, groups, nd,
          data_format):
    x, weight = _amp.white_op_hint(x, weight, op=f"conv{nd}d")
    stride = _tupleize(stride, nd)
    dilation = _tupleize(dilation, nd)
    last = data_format in _CHANNELS_LAST
    if last:
        x = _channels_first(x, nd)
    window = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dilation)]
    pads = _resolve_pads(padding, nd, x.shape[2:], window, stride)
    if all(lo == hi >= 0 for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        x, sym = _pad_spatial(x, pads), 0
    conv = (torch.nn.functional.conv1d, torch.nn.functional.conv2d,
            torch.nn.functional.conv3d)[nd - 1]
    out = conv(x, weight, None, stride, sym, dilation, groups)
    if bias is not None:
        out = out + bias.to(out.dtype).reshape((1, -1) + (1,) * nd)
    return _channels_last(out, nd) if last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 "NLC" if data_format == "NLC" else "NCL")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """Weight (out, in/groups, kh, kw) in either data format."""
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format)


# --------------------------------------------------------------------------- #
# batch norm
# --------------------------------------------------------------------------- #

def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """(out, new_mean, new_var). In training (and unless
    `use_global_stats`), the batch statistics in fp32 (at least): the
    input shifted by the running mean, var = max(E[x²] − E[x]², 0), the
    running stats moved by `momentum` with the biased variance and kept
    in their dtype; otherwise the running stats normalise and come back
    unchanged. The normalisation and the affine run in x's dtype."""
    c_axis = x.dim() - 1 if data_format.endswith("C") and x.dim() > 2 \
        else 1
    red = tuple(i for i in range(x.dim()) if i != c_axis)
    if use_global_stats is None:
        use_global_stats = not training
    shape = [1] * x.dim()
    shape[c_axis] = x.shape[c_axis]
    if use_global_stats:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    else:
        acc_t = torch.promote_types(x.dtype, torch.float32)
        rm = running_mean.to(acc_t)
        xf = x.to(acc_t) - rm.reshape(shape)
        mean_s = xf.mean(dim=red)
        ex2_s = xf.square().mean(dim=red)
        var = torch.clamp_min(ex2_s - mean_s.square(), 0.0)
        mean = mean_s + rm
        new_mean = (momentum * running_mean
                    + (1 - momentum) * mean).to(running_mean.dtype)
        new_var = (momentum * running_var
                   + (1 - momentum) * var).to(running_var.dtype)
    mean, var = mean.to(x.dtype), var.to(x.dtype)
    inv = torch.rsqrt(var + epsilon).reshape(shape)
    out = (x - mean.reshape(shape)) * inv
    if weight is not None:
        out = out * weight.to(x.dtype).reshape(shape)
    if bias is not None:
        out = out + bias.to(x.dtype).reshape(shape)
    return out, new_mean, new_var


# --------------------------------------------------------------------------- #
# pooling
# --------------------------------------------------------------------------- #

def _pool2d(x, kind, kernel, stride, padding, ceil_mode, exclusive,
            data_format):
    """`reduce_window` over the padded input, as the JAX `_pool`: max
    pads with -inf; avg sums the window and divides by the count of
    real entries (`exclusive`) or by the window size; `ceil_mode` widens
    the high side so a last partial window is kept."""
    nd = 2
    kernel = _tupleize(kernel, nd)
    stride = _tupleize(stride if stride is not None else kernel, nd)
    last = data_format in _CHANNELS_LAST
    if last:
        x = _channels_first(x, nd)
    sizes = x.shape[2:]
    pads = _resolve_pads(padding, nd, sizes, kernel, stride)
    if ceil_mode and not isinstance(padding, str):
        for i, (lo, hi) in enumerate(pads):
            rem = (sizes[i] + lo + hi - kernel[i]) % stride[i]
            if rem:
                pads[i] = (lo, hi + stride[i] - rem)
    if kind == "max":
        if all(lo == hi and 0 <= lo <= k // 2
               for (lo, hi), k in zip(pads, kernel)):
            # torch's own padding is the same -inf border
            out = torch.nn.functional.max_pool2d(
                x, kernel, stride, tuple(lo for lo, _ in pads))
        else:
            low = -math.inf if x.is_floating_point() \
                else torch.iinfo(x.dtype).min
            out = torch.nn.functional.max_pool2d(
                _pad_spatial(x, pads, low), kernel, stride)
    else:
        summed = torch.nn.functional.avg_pool2d(
            _pad_spatial(x, pads), kernel, stride, divisor_override=1)
        if exclusive:
            ones = torch.ones((1, 1) + tuple(sizes), dtype=x.dtype,
                              device=x.device)
            counts = torch.nn.functional.avg_pool2d(
                _pad_spatial(ones, pads), kernel, stride,
                divisor_override=1)
        else:
            counts = float(kernel[0] * kernel[1])
        out = summed / counts
    return _channels_last(out, nd) if last else out


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW"):
    return _pool2d(x, "max", kernel_size, stride, padding, ceil_mode, True,
                   data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    out = _pool2d(x, "avg", kernel_size, stride, padding, ceil_mode,
                  exclusive if divisor_override is None else False,
                  data_format)
    if divisor_override is not None:
        k = _tupleize(kernel_size, 2)
        out = out * (float(k[0] * k[1]) / divisor_override)
    return out


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """Axis by axis, as the JAX `_adaptive_pool`: a divisible axis as a
    reshape and a mean, another as the means of the segments [floor(i ·
    in / out), ceil((i + 1) · in / out))."""
    nd = 2
    output_size = _tupleize(output_size, nd)
    spatial0 = x.dim() - nd - 1 if data_format == "NHWC" else x.dim() - nd
    out = x
    for i in range(nd):
        axis = spatial0 + i
        osz, isz = output_size[i], x.shape[axis]
        if osz is None or osz == isz:
            continue
        if isz % osz == 0:
            out = out.reshape(out.shape[:axis] + (osz, isz // osz)
                              + out.shape[axis + 1:]).mean(dim=axis + 1)
        else:
            out = torch.cat([
                out.narrow(axis, (j * isz) // osz,
                           ((j + 1) * isz + osz - 1) // osz - (j * isz) // osz
                           ).mean(dim=axis, keepdim=True)
                for j in range(osz)], dim=axis)
    return out


def flatten(x, start_axis=0, stop_axis=-1):
    return torch.flatten(x, start_axis, stop_axis)


# --------------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------------- #

def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """JAX's `cross_entropy`: log-softmax over `axis` in the input's
    dtype; soft labels (or hard ones after `label_smoothing`) sum
    -label · logp; hard labels pick logp, drop `ignore_index` and, with
    `weight`, scale by the class weight and (mean) divide by the kept
    weights' sum; the hard-label mean divides by the kept count."""
    n_classes = input.shape[axis]
    if label_smoothing > 0.0:
        if not soft_label:
            # jax.nn.one_hot: a comparison with arange, so an id out of
            # range (ignore_index) is a row of zeros
            ids = torch.as_tensor(label, device=input.device).long()
            label = (ids.unsqueeze(-1) == torch.arange(
                n_classes, device=input.device)).to(input.dtype)
            label = label.movedim(-1, axis)
            soft_label = True
        label = (1 - label_smoothing) * label + label_smoothing / n_classes
    logp = torch.log_softmax(input, dim=axis) if use_softmax \
        else torch.log(torch.clamp_min(input, 1e-30))
    if soft_label:
        return _reduce(-(label * logp).sum(dim=axis), reduction)
    if label.dim() == input.dim() and label.shape[axis] == 1:
        label = label.squeeze(axis)
    label = label.long()
    valid = label != ignore_index
    safe = torch.where(valid, label, 0)
    loss = -torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    if weight is not None:
        w = torch.as_tensor(weight, device=input.device)[safe]
        loss = torch.where(valid, loss * w, 0.0)
        if reduction == "mean":
            return loss.sum() / torch.clamp_min(
                torch.where(valid, w, 0.0).sum(), 1e-12)
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        return loss.sum() / torch.clamp_min(valid.sum().to(loss.dtype), 1.0)
    return _reduce(loss, reduction)
