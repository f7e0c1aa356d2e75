"""The functional ops of the GPT and ResNet training paths, in PyTorch.

A subset of `paddle_tpu/nn/functional.py` with the same rounding points:
`linear` is `x @ w` (weight (in, out)) with the bias cast to the output
dtype, and under `amp.auto_cast` (O1) casts x and w to the compute
dtype first, as the JAX `linear` does; `layer_norm` normalises in fp32,
casts to the activation dtype and THEN applies weight and bias in that
dtype (so bf16 stays bf16; the serving path's `models.gpt._ln` keeps
the decode wiring's fp32 affine); `gelu` (exact erf unless `approximate`), the
activations of `paddle_tpu/nn/functional.py:71-200` (the jax.nn
formulas; `softmax` / `log_softmax` cast to `dtype=` first; `rrelu` and
`gumbel_softmax` draw from the step's key) and `embedding` (with
`padding_idx`) as in JAX;
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
only the real entries), and so are `max_pool3d` / `avg_pool3d`;
`conv1d_transpose` / `conv2d_transpose` / `conv3d_transpose` take the
reference's (in, out / groups, *k) weights, integer padding as the
gradient of a convolution and "SAME" / "VALID" as `lax.conv_transpose`
pads them; `label_smooth` and `pixel_shuffle` are the reference's;
`adaptive_avg_pool2d` means axis by axis;
`cross_entropy` has hard and soft labels, `ignore_index`, `weight`,
`label_smoothing` and `reduction`; the other losses of
`paddle_tpu/nn/functional.py:1031-1330` (binary cross-entropy with and
without logits, mse, l1, nll, smooth l1, huber, kl, poisson and
gaussian nll, the margin and embedding losses, focal, log, n-pair and
CTC by the forward algorithm) keep the JAX formulas.
"""
from __future__ import annotations

import math

import torch

from .. import amp as _amp
from .. import core
from ..ops_cuda import flash_attention as _fa
from . import ranks as _ranks
from . import rng as _rng

__all__ = ["linear", "layer_norm", "gelu", "relu", "relu_", "relu6",
           "leaky_relu", "elu", "selu", "celu", "silu", "swish", "mish",
           "sigmoid", "log_sigmoid", "hardsigmoid", "hardswish", "hardtanh",
           "hardshrink", "softshrink", "tanhshrink", "softplus", "softsign",
           "tanh", "prelu", "rrelu", "glu", "maxout", "softmax",
           "log_softmax", "temperature_softmax", "gumbel_softmax",
           "embedding", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "scaled_dot_product_attention", "conv1d", "conv2d", "conv3d",
           "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
           "batch_norm", "max_pool2d", "avg_pool2d", "max_pool3d",
           "avg_pool3d", "adaptive_avg_pool2d", "label_smooth",
           "pixel_shuffle",
           "flatten", "cross_entropy", "softmax_with_cross_entropy",
           "binary_cross_entropy", "binary_cross_entropy_with_logits",
           "mse_loss", "square_error_cost", "l1_loss", "nll_loss",
           "smooth_l1_loss", "huber_loss", "kl_div", "poisson_nll_loss",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss",
           "soft_margin_loss", "multi_label_soft_margin_loss",
           "gaussian_nll_loss", "sigmoid_focal_loss", "log_loss",
           "npair_loss", "ctc_loss", "cosine_similarity",
           "pairwise_distance"]


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


# --------------------------------------------------------------------------- #
# activations (`paddle_tpu/nn/functional.py:71-200`, the jax.nn formulas)
# --------------------------------------------------------------------------- #

relu_ = relu


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def leaky_relu(x, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(
        torch.where(x > 0, torch.zeros_like(x), x)))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0):
    return torch.clamp_min(x, 0.0) + alpha * torch.expm1(
        torch.clamp_max(x, 0.0) / alpha)


def silu(x):
    return x * torch.sigmoid(x)


swish = silu


def mish(x):
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))


def sigmoid(x):
    return torch.sigmoid(x)


def log_sigmoid(x):
    return torch.nn.functional.logsigmoid(x)


def hardsigmoid(x, slope=1.0 / 6, offset=0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x):
    return x * relu6(x + 3.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0):
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5):
    return torch.where(x.abs() > threshold, x, 0.0)


def softshrink(x, threshold=0.5):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, 0.0))


def tanhshrink(x):
    return x - torch.tanh(x)


def softplus(x, beta=1.0, threshold=20.0):
    """x where beta x > threshold, else log(1 + exp(beta x)) / beta."""
    return torch.where(x * beta > threshold, x,
                       torch.logaddexp(x * beta, torch.zeros_like(x)) / beta)


def softsign(x):
    return x / (x.abs() + 1)


def tanh(x):
    return torch.tanh(x)


def prelu(x, weight, data_format="NCHW"):
    """One slope, or one per channel (the channel axis by
    `data_format`)."""
    w = weight
    if w.numel() > 1 and x.dim() > 1:
        c_axis = 1 if data_format.startswith("NC") else x.dim() - 1
        shape = [1] * x.dim()
        shape[c_axis] = w.numel()
        w = w.reshape(shape)
    return torch.where(x > 0, x, w * x)


def rrelu(x, lower=1.0 / 8, upper=1.0 / 3, training=False):
    """Negative inputs times a slope: drawn uniformly from [lower,
    upper) per entry in training (from the step's key, `nn.rng`), their
    mean otherwise."""
    if training:
        a = _rng.uniform(x.shape, x.device, lower, upper).to(x.dtype)
    else:
        a = (lower + upper) / 2.0
    return torch.where(x >= 0, x, a * x)


def glu(x, axis=-1):
    a, b = x.chunk(2, dim=axis)
    return a * torch.sigmoid(b)


def maxout(x, groups, axis=1):
    axis = axis % x.dim()
    c = x.shape[axis]
    shape = x.shape[:axis] + (c // groups, groups) + x.shape[axis + 1:]
    return x.reshape(shape).amax(dim=axis + 1)


def softmax(x, axis=-1, dtype=None):
    """In `dtype` when given (the input cast first), else x's."""
    if dtype is not None:
        x = x.to(core.resolve_dtype(dtype))
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None):
    if dtype is not None:
        x = x.to(core.resolve_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def temperature_softmax(x, temperature=1.0, axis=-1):
    return torch.softmax(x / temperature, dim=axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1):
    """softmax((x + g) / temperature), g Gumbel noise drawn from the
    step's key (`nn.rng`); `hard` makes it one-hot in the forward with
    the soft gradient (straight through)."""
    tiny = torch.finfo(x.dtype).tiny
    u = _rng.uniform(x.shape, x.device, tiny, 1.0).to(x.dtype)
    y = torch.softmax((x - torch.log(-torch.log(u))) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = (y_hard - y).detach() + y
    return y


def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of `weight`; positions holding `padding_idx` give zeros
    (and so pass no gradient to that row)."""
    out = weight[x]
    if padding_idx is not None:
        out = torch.where((x == padding_idx).unsqueeze(-1), 0.0, out)
    return out


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
                                 training: bool = True, head_block=None):
    """Layout (batch, seq, heads, head_dim); the flash kernels K2/K3 on
    CUDA tensors, their plain versions on CPU tensors; a mask or
    dropout (in training) through `attention_dense`. `head_block` (r,
    n), the port's own, says the heads are block r of n of one
    attention's (a tensor-parallel rank's): dropout draws their block
    of the mask over all heads."""
    return _fa.dot_product_attention(
        query, key, value, mask=attn_mask, causal=is_causal,
        dropout_p=dropout_p if training else 0.0, head_block=head_block)


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


def _transpose_pads(padding, nd, stride, window, output_padding):
    """(kernel flipped?, per-dimension (lo, hi) of the lhs-dilated
    correlation) as the reference builds them: integer padding is the
    gradient of a convolution (the kernel flipped, lo = k_eff - 1 -
    pad_lo, hi = k_eff - 1 - pad_hi + output_padding); "SAME" / "VALID"
    go through `lax.conv_transpose`'s padding with the kernel as it is."""
    if isinstance(padding, str):
        pads = []
        for k, s in zip(window, stride):
            if padding.upper() == "SAME":
                total = k + s - 2
                lo = k - 1 if s > k - 1 else -(-total // 2)
            else:
                total = k + s - 2 + max(k - s, 0)
                lo = k - 1
            pads.append((lo, total - lo))
        return False, pads
    p = _conv_padding(padding, nd)
    return True, [(k - 1 - lo, k - 1 - hi + op)
                  for k, (lo, hi), op in zip(window, p, output_padding)]


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, nd, data_format):
    """The reference's `_conv_transpose`: weight (in, out / groups, *k).
    torch's transposed convolution (no padding) gives the full result;
    the reference's padding then crops it (a negative pad) or extends it
    with zeros."""
    stride = _tupleize(stride, nd)
    dilation = _tupleize(dilation, nd)
    output_padding = _tupleize(output_padding, nd)
    last = data_format in _CHANNELS_LAST
    if last:
        x = _channels_first(x, nd)
    window = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dilation)]
    flipped, pads = _transpose_pads(padding, nd, stride, window,
                                    output_padding)
    if not flipped:
        weight = torch.flip(weight, tuple(range(2, 2 + nd)))
    conv = (torch.nn.functional.conv_transpose1d,
            torch.nn.functional.conv_transpose2d,
            torch.nn.functional.conv_transpose3d)[nd - 1]
    full = conv(x, weight.to(x.dtype), None, stride, 0, 0, groups, dilation)
    out = _pad_spatial(full, [(lo - (k - 1), hi - (k - 1))
                              for (lo, hi), k in zip(pads, window)])
    if bias is not None:
        out = out + bias.to(out.dtype).reshape((1, -1) + (1,) * nd)
    return _channels_last(out, nd) if last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL"):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1, data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW"):
    """Weight (in, out / groups, kh, kw), as the reference's and torch's
    transposed convolutions; `output_size` is accepted and, as in the
    reference, not read."""
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2, data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW"):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3, data_format)


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
    unchanged. The normalisation and the affine run in x's dtype. Under
    a mesh (`nn.ranks`) the shifted moments are averaged over the data
    ranks in rank order before the variance is formed: every rank
    normalises with the global batch's statistics, as JAX's batch norm
    over a sharded batch does."""
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
        # under a mesh: averaged over the data ranks (sync batch norm)
        mean_s, ex2_s = _ranks.sync_moments(mean_s, ex2_s)
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

def _pool(x, kind, kernel, stride, padding, ceil_mode, exclusive,
          data_format, nd):
    """`reduce_window` over the padded input, as the JAX `_pool`: max
    pads with -inf; avg sums the window and divides by the count of
    real entries (`exclusive`) or by the window size; `ceil_mode` widens
    the high side so a last partial window is kept."""
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
    max_pool = (torch.nn.functional.max_pool2d,
                torch.nn.functional.max_pool3d)[nd - 2]
    avg_pool = (torch.nn.functional.avg_pool2d,
                torch.nn.functional.avg_pool3d)[nd - 2]
    if kind == "max":
        if all(lo == hi and 0 <= lo <= k // 2
               for (lo, hi), k in zip(pads, kernel)):
            # torch's own padding is the same -inf border
            out = max_pool(x, kernel, stride, tuple(lo for lo, _ in pads))
        else:
            low = -math.inf if x.is_floating_point() \
                else torch.iinfo(x.dtype).min
            out = max_pool(_pad_spatial(x, pads, low), kernel, stride)
    else:
        summed = avg_pool(_pad_spatial(x, pads), kernel, stride,
                          divisor_override=1)
        if exclusive:
            ones = torch.ones((1, 1) + tuple(sizes), dtype=x.dtype,
                              device=x.device)
            counts = avg_pool(_pad_spatial(ones, pads), kernel, stride,
                              divisor_override=1)
        else:
            counts = float(math.prod(kernel))
        out = summed / counts
    return _channels_last(out, nd) if last else out


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW"):
    return _pool(x, "max", kernel_size, stride, padding, ceil_mode, True,
                 data_format, 2)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    return _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
                     divisor_override, data_format, 2)


def _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
              divisor_override, data_format, nd):
    out = _pool(x, "avg", kernel_size, stride, padding, ceil_mode,
                exclusive if divisor_override is None else False,
                data_format, nd)
    if divisor_override is not None:
        k = _tupleize(kernel_size, nd)
        out = out * (float(math.prod(k)) / divisor_override)
    return out


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW"):
    if return_mask:
        raise NotImplementedError(
            "max_pool3d return_mask is not ported yet (ROADMAP Queue 1, "
            "item 13.1's rest)")
    return _pool(x, "max", kernel_size, stride, padding, ceil_mode, True,
                 data_format, 3)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW"):
    return _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
                     divisor_override, data_format, 3)


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


def label_smooth(label, prior_dist=None, epsilon=0.1):
    """(1 - epsilon) · label + epsilon · prior (uniform over the last
    axis by default)."""
    n = label.shape[-1]
    prior = (1.0 / n) if prior_dist is None else prior_dist
    return (1 - epsilon) * label + epsilon * prior


def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    """(n, c · r², h, w) → (n, c, h · r, w · r) (or the NHWC layouts)."""
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


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
            return _masked_mean(loss, torch.where(valid, w, 0.0).sum(),
                                1e-12)
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        return _masked_mean(loss, valid.sum().to(loss.dtype), 1.0)
    return _reduce(loss, reduction)


def _masked_mean(loss, count, floor: float):
    """loss.sum() / max(count, floor); under a mesh the count is the
    global batch's (`nn.ranks.mean_denominator`), and the count pass
    only records it."""
    if _ranks.is_counting():
        return _ranks.record_count(count)
    return loss.sum() / torch.clamp_min(_ranks.mean_denominator(count),
                                        floor)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    """The per-row loss with its `axis` kept (size 1); an ignored row's
    loss is 0; with `return_softmax`, (loss, softmax)."""
    logp = torch.log_softmax(logits, dim=axis)
    if soft_label:
        loss = -(label * logp).sum(dim=axis, keepdim=True)
    else:
        label = torch.as_tensor(label, device=logits.device)
        if label.dim() == logits.dim() and label.shape[axis] == 1:
            label = label.squeeze(axis)
        label = label.long()
        ignored = (label == ignore_index).unsqueeze(axis)
        safe = torch.where(label == ignore_index, 0, label)
        loss = -torch.gather(logp, axis, safe.unsqueeze(axis))
        loss = torch.where(ignored, 0.0, loss)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp_min(input, eps))
             + (1 - label) * torch.log(torch.clamp_min(1 - input, eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    """The stable form max(x, 0) - x y + log1p(exp(-|x|)); with
    `pos_weight` the positive term is scaled by it."""
    max_val = torch.clamp_min(-logit, 0.0)
    if pos_weight is not None:
        log_w = (pos_weight - 1) * label + 1
        loss = (1 - label) * logit + log_w * (
            torch.log1p(torch.exp(-logit.abs())) + max_val)
    else:
        loss = torch.clamp_min(logit, 0.0) - logit * label \
            + torch.log1p(torch.exp(-logit.abs()))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean"):
    return _reduce((input - label).square(), reduction)


def square_error_cost(input, label):
    return (input - label).square()


def l1_loss(input, label, reduction="mean"):
    return _reduce((input - label).abs(), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100,
             reduction="mean"):
    """-input[i, label[i]] over (N, C) log-probabilities; ignored rows
    drop out; with `weight` the mean divides by the kept weights'
    sum."""
    label = torch.as_tensor(label, device=input.device).long()
    valid = label != ignore_index
    safe = torch.where(valid, label, 0)
    loss = -torch.gather(input, 1, safe[:, None])[:, 0]
    if weight is not None:
        w = torch.as_tensor(weight, device=input.device)[safe]
        loss = torch.where(valid, loss * w, 0.0)
        if reduction == "mean":
            return _masked_mean(loss, torch.where(valid, w, 0.0).sum(),
                                0.0)
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        return _masked_mean(loss, valid.sum().to(loss.dtype), 1.0)
    return _reduce(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    d = input - label
    ad = d.abs()
    return _reduce(torch.where(ad < delta, 0.5 * d * d / delta,
                               ad - 0.5 * delta), reduction)


def huber_loss(input, label, delta=1.0, reduction="mean"):
    d = input - label
    ad = d.abs()
    return _reduce(torch.where(ad <= delta, 0.5 * d * d,
                               delta * (ad - 0.5 * delta)), reduction)


def kl_div(input, label, reduction="mean", log_target=False):
    """label (log label with `log_target`) against log-probabilities
    `input`; "batchmean" divides the sum by the batch."""
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = label * (torch.log(torch.clamp_min(label, 1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-8, reduction="mean"):
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        lab = torch.clamp_min(label, 1.0)
        stirling = label * torch.log(lab) - label \
            + 0.5 * torch.log(2 * math.pi * lab)
        loss = loss + torch.where(label > 1, stirling, 0.0)
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    return _reduce(torch.clamp_min(-label * (input - other) + margin, 0.0),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    return _reduce(torch.where(label == 1, input,
                               torch.clamp_min(margin - input, 0.0)),
                   reduction)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = (x1 * x2).sum(dim=axis)
    n1 = x1.square().sum(dim=axis).sqrt()
    n2 = x2.square().sum(dim=axis).sqrt()
    return dot / torch.clamp_min(n1 * n2, eps)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False):
    d = x - y + epsilon
    return (d.abs() ** p).sum(dim=-1, keepdim=keepdim) ** (1.0 / p)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    cs = cosine_similarity(input1, input2, axis=-1)
    return _reduce(torch.where(label == 1, 1 - cs,
                               torch.clamp_min(cs - margin, 0.0)), reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean"):
    d_pos = pairwise_distance(input, positive, p=p, epsilon=epsilon)
    d_neg = pairwise_distance(input, negative, p=p, epsilon=epsilon)
    if swap:
        d_neg = torch.minimum(d_neg, pairwise_distance(
            positive, negative, p=p, epsilon=epsilon))
    return _reduce(torch.clamp_min(d_pos - d_neg + margin, 0.0), reduction)


def soft_margin_loss(input, label, reduction="mean"):
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean"):
    ls = torch.nn.functional.logsigmoid
    loss = -(label * ls(input) + (1 - label) * ls(-input))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss.mean(dim=-1), reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean"):
    var = torch.clamp_min(variance, epsilon)
    loss = 0.5 * (torch.log(var) + (input - label).square() / var)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum"):
    p = torch.sigmoid(logit)
    ce = torch.clamp_min(logit, 0.0) - logit * label \
        + torch.log1p(torch.exp(-logit.abs()))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * (1 - p_t) ** gamma * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def log_loss(input, label, epsilon=1e-4):
    return -(label * torch.log(input + epsilon)
             + (1 - label) * torch.log(1 - input + epsilon))


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    sim = anchor @ positive.t()
    lab = (labels[:, None] == labels[None, :]).to(sim.dtype)
    lab = lab / lab.sum(dim=1, keepdim=True)
    ce = (-(lab * torch.log_softmax(sim, dim=1)).sum(dim=1)).mean()
    reg = l2_reg * (anchor.square().sum(dim=1).mean()
                    + positive.square().sum(dim=1).mean()) * 0.25
    return ce + reg


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC by the forward algorithm in log space over (T, N, C) scores
    (log-softmaxed first), the extended label sequence blank, l1,
    blank, ..., blank; an input stops at its length (its alphas
    frozen)."""
    log_probs = torch.log_softmax(log_probs, dim=-1)
    dev = log_probs.device
    labels = torch.as_tensor(labels, device=dev).long()
    input_lengths = torch.as_tensor(input_lengths, device=dev)
    label_lengths = torch.as_tensor(label_lengths, device=dev).long()
    T, N, _ = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    ext = torch.full((N, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    neg_inf = -1e30
    alpha = torch.full((N, S), neg_inf, dtype=log_probs.dtype, device=dev)
    alpha = torch.cat([log_probs[0, :, blank:blank + 1],
                       torch.gather(log_probs[0], 1, ext[:, 1:2]),
                       alpha[:, 2:]], dim=1)
    same_as_prev2 = torch.cat(
        [torch.ones((N, 2), dtype=torch.bool, device=dev),
         ext[:, 2:] == ext[:, :-2]], dim=1)
    pad1 = torch.full((N, 1), neg_inf, dtype=alpha.dtype, device=dev)
    pad2 = torch.full((N, 2), neg_inf, dtype=alpha.dtype, device=dev)
    for t in range(1, T):
        emit = torch.gather(log_probs[t], 1, ext)
        a_prev1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a_prev2 = torch.where(same_as_prev2, neg_inf,
                              torch.cat([pad2, alpha[:, :-2]], dim=1))
        new = torch.logaddexp(torch.logaddexp(alpha, a_prev1), a_prev2) \
            + emit
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)
    idx_last = 2 * label_lengths
    a_last = torch.gather(alpha, 1, idx_last[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1,
                          torch.clamp_min(idx_last - 1, 0)[:, None])[:, 0]
    loss = -torch.logaddexp(a_last, torch.where(label_lengths > 0, a_prev,
                                                neg_inf))
    if norm_by_times:
        loss = loss / input_lengths
    return _reduce(loss, reduction)
