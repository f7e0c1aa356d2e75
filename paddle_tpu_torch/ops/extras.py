"""Long-tail tensor ops: the counterpart of `paddle_tpu/ops/extras.py`.

The vision ops (`roi_align`, `roi_pool`, `psroi_pool`, `yolo_box`,
`deformable_conv`) and the segment / message-passing ops
(`segment_*`, `graph_send_recv`) are the reference's plain compositions
written in torch, vectorised over boxes and images instead of `vmap`:
the same sample points, bin masks and reductions, in the same order
(no package of finished kernels: torchvision is not used). A segment
reduction without `out_size` reads max(ids) + 1 from the device, as
`jax.ops.segment_*` does eagerly; an empty segment of `segment_max` /
`segment_min` holds the reduction's identity (-inf / +inf), as JAX's.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import core
from ._common import a, long, pair
from .math import _quantile

__all__ = ["add_n", "broadcast_tensors", "dist", "index_sample",
           "is_complex", "is_empty", "is_floating_point", "is_integer",
           "multiplex", "mv", "nanquantile", "poisson", "scatter_nd",
           "segment_sum", "segment_mean", "segment_max", "segment_min",
           "t", "thresholded_relu", "graph_send_recv", "lu_unpack",
           "roi_align", "roi_pool", "psroi_pool", "yolo_box",
           "deformable_conv"]


def add_n(inputs, name=None):
    """Sum a list of tensors, left to right."""
    res = a(inputs[0])
    for v in inputs[1:]:
        res = res + a(v, res.device)
    return res


def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*[a(v) for v in inputs]))


def dist(x, y, p: float = 2.0, name=None):
    """The p-norm of (x - y)."""
    x, y = pair(x, y)
    d = x - y
    if p == float("inf"):
        return torch.amax(torch.abs(d))
    if p == float("-inf"):
        return torch.amin(torch.abs(d))
    if p == 0:
        return torch.count_nonzero(d).to(d.dtype)
    return torch.sum(torch.abs(d) ** p) ** (1.0 / p)


def index_sample(x, index):
    """Per-row gather: out[i, j] = x[i, index[i, j]]."""
    x = a(x)
    return torch.take_along_dim(x, long(index).to(x.device), dim=1)


def is_complex(x) -> bool:
    return a(x).is_complex()


def is_floating_point(x) -> bool:
    return a(x).is_floating_point()


def is_integer(x) -> bool:
    return core.is_integer_dtype(a(x).dtype)


def is_empty(x):
    x = a(x)
    return torch.tensor(x.numel() == 0, device=x.device)


def multiplex(inputs, index, name=None):
    """Row-wise select: out[i] = inputs[index[i]][i]."""
    stacked = torch.stack([a(v) for v in inputs])    # (K, B, ...)
    idx = long(index).to(stacked.device).reshape(-1)
    return stacked[idx, torch.arange(idx.shape[0], device=stacked.device)]


def mv(x, vec, name=None):
    return torch.matmul(*pair(x, vec))


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(x, q, axis, keepdim, skip_nan=True)


def poisson(x, name=None):
    """Per-element Poisson draw with rate x, in x's dtype, from the
    default generator (its law, not JAX's bits)."""
    x = a(x)
    return torch.poisson(x, generator=core.next_generator(x.device))


def scatter_nd(index, updates, shape, name=None):
    """Scatter-add updates into zeros(shape) at index."""
    upd = a(updates)
    res = torch.zeros(tuple(shape), dtype=upd.dtype, device=upd.device)
    idx = tuple(long(index).to(upd.device).unbind(-1))
    return res.index_put(idx, upd, accumulate=True)


def _segments(ids, n):
    ids = long(ids)
    return ids, (int(ids.max()) + 1 if n is None else int(n))


def _segment(data, ids, n, reduce):
    d = a(data)
    ids, n = _segments(ids.to(d.device) if isinstance(ids, torch.Tensor)
                       else a(ids, d.device), n)
    shape = (n,) + tuple(d.shape[1:])
    if reduce == "sum":
        return torch.zeros(shape, dtype=d.dtype, device=d.device).index_add(
            0, ids, d)
    if d.is_floating_point():
        init = float("-inf") if reduce == "amax" else float("inf")
    else:
        info = torch.iinfo(d.dtype)
        init = info.min if reduce == "amax" else info.max
    idx = ids.reshape((-1,) + (1,) * (d.dim() - 1)).expand(d.shape)
    return torch.full(shape, init, dtype=d.dtype, device=d.device
                      ).scatter_reduce(0, idx, d, reduce, include_self=False)


def segment_sum(data, segment_ids, name=None):
    return _segment(data, segment_ids, None, "sum")


def segment_mean(data, segment_ids, name=None):
    d = a(data)
    ids, n = _segments(a(segment_ids, d.device), None)
    sums = _segment(d, ids, n, "sum")
    counts = _segment(torch.ones(d.shape[0], dtype=d.dtype, device=d.device),
                      ids, n, "sum")
    return sums / torch.clamp(counts, min=1).reshape(
        (-1,) + (1,) * (d.dim() - 1))


def segment_max(data, segment_ids, name=None):
    return _segment(data, segment_ids, None, "amax")


def segment_min(data, segment_ids, name=None):
    return _segment(data, segment_ids, None, "amin")


def t(x, name=None):
    """Transpose of a tensor of rank <= 2."""
    x = a(x)
    if x.dim() > 2:
        raise ValueError("t() expects a tensor of rank ≤ 2; use "
                         "transpose for higher ranks")
    return x.t() if x.dim() == 2 else x


def thresholded_relu(x, threshold: float = 1.0, name=None):
    x = a(x)
    return torch.where(x > threshold, x, torch.zeros_like(x))


def lu_unpack(lu_data, lu_pivots, unpack_ludata: bool = True,
              unpack_pivots: bool = True, name=None):
    """(P, L, U) from packed LU data and LAPACK's 1-based pivots, A =
    P @ L @ U (None for a part not asked for)."""
    lu_mat = a(lu_data)
    p, lo, up = torch.lu_unpack(lu_mat, a(lu_pivots, lu_mat.device).int())
    return (p if unpack_pivots else None,
            lo if unpack_ludata else None, up if unpack_ludata else None)


def _box_img_idx(boxes, boxes_num):
    """The image of each box from the per-image box counts."""
    if boxes_num is None:
        return torch.zeros(boxes.shape[0], dtype=torch.long,
                           device=boxes.device)
    bn = long(boxes_num).to(boxes.device)
    return torch.repeat_interleave(torch.arange(bn.shape[0],
                                                device=boxes.device), bn)


def _gather_hw(feats, yi, xi):
    """feats (R, C, H, W) at integer (yi, xi) of shape (R, *S) →
    (R, C, *S)."""
    r, c, h, w = feats.shape
    flat = (yi * w + xi).reshape(r, 1, -1).expand(r, c, -1)
    return torch.gather(feats.reshape(r, c, h * w), 2, flat).reshape(
        (r, c) + tuple(yi.shape[1:]))


def roi_align(x, boxes, boxes_num=None, output_size=7,
              spatial_scale: float = 1.0, sampling_ratio: int = -1,
              aligned: bool = True, name=None):
    """RoIAlign: bilinear-sampled average pooling over boxes. x: (N, C,
    H, W); boxes: (R, 4) xyxy with `boxes_num` rows per image (default:
    all on image 0). As the reference, sampling_ratio <= 0 means a fixed
    2 samples per bin and axis, and a sample farther than one pixel
    outside the image contributes zero."""
    x = a(x)
    boxes = a(boxes, x.device)
    oh, ow = (output_size, output_size) if isinstance(output_size, int) \
        else output_size
    n, c, h, w = x.shape
    img_idx = _box_img_idx(boxes, boxes_num)
    offset = 0.5 if aligned else 0.0
    sr = sampling_ratio if sampling_ratio > 0 else 2
    x1, y1, x2, y2 = (boxes * spatial_scale - offset).unbind(-1)
    bw = torch.clamp(x2 - x1, min=1e-6)
    bh = torch.clamp(y2 - y1, min=1e-6)
    dev = x.device
    frac_ = (torch.arange(sr, device=dev)[None, :] + 0.5) / sr
    ys = y1[:, None, None] + bh[:, None, None] / oh * (
        torch.arange(oh, device=dev)[None, :, None] + frac_[None])
    xs = x1[:, None, None] + bw[:, None, None] / ow * (
        torch.arange(ow, device=dev)[None, :, None] + frac_[None])
    yy = ys.reshape(-1, oh * sr, 1)
    xx = xs.reshape(-1, 1, ow * sr)
    valid = ((yy >= -1.0) & (yy <= h) & (xx >= -1.0) & (xx <= w)).to(x.dtype)
    yy = torch.clamp(yy, 0, h - 1)
    xx = torch.clamp(xx, 0, w - 1)
    y0 = torch.clamp(torch.floor(yy).int(), 0, h - 1)
    x0 = torch.clamp(torch.floor(xx).int(), 0, w - 1)
    y1_ = torch.clamp(y0 + 1, max=h - 1)
    x1_ = torch.clamp(x0 + 1, max=w - 1)
    fy = yy - y0
    fx = xx - x0
    shape = (yy.shape[0], oh * sr, ow * sr)
    y0, y1_, fy = (v.expand(shape) for v in (y0, y1_, fy))
    x0, x1_, fx = (v.expand(shape) for v in (x0, x1_, fx))
    feats = x[img_idx]                                   # (R, C, H, W)
    g = lambda yi, xi: _gather_hw(feats, yi.long(), xi.long())
    fy_, fx_ = fy[:, None], fx[:, None]
    v = (g(y0, x0) * (1 - fy_) * (1 - fx_)
         + g(y1_, x0) * fy_ * (1 - fx_)
         + g(y0, x1_) * (1 - fy_) * fx_
         + g(y1_, x1_) * fy_ * fx_)
    v = v * valid.expand(shape)[:, None]                 # (R, C, P, Q)
    return v.reshape(-1, c, oh, sr, ow, sr).mean(dim=(3, 5))


def _bilinear_sample_zero_pad(img, yy, xx, h, w):
    """img (N, C, H, W); yy / xx float sample points (N, *S) → (N, C,
    *S) bilinear values, each of the four corners counted only if it
    lies inside the image (the reference's DCN / roi semantics)."""
    y0 = torch.floor(yy).int()
    x0 = torch.floor(xx).int()
    fy = (yy - y0).to(img.dtype)
    fx = (xx - x0).to(img.dtype)

    def corner(yc, xc, wgt):
        ok = ((yc >= 0) & (yc < h) & (xc >= 0) & (xc < w)).to(img.dtype)
        yg = torch.clamp(yc, 0, h - 1).long()
        xg = torch.clamp(xc, 0, w - 1).long()
        return _gather_hw(img, yg, xg) * (wgt * ok)[:, None]

    return (corner(y0, x0, (1 - fy) * (1 - fx))
            + corner(y0 + 1, x0, fy * (1 - fx))
            + corner(y0, x0 + 1, (1 - fy) * fx)
            + corner(y0 + 1, x0 + 1, fy * fx))


def _bin_masks_from_bounds(y1, bh, x1, bw, oh, ow, h, w):
    """(R, oh, ow, H, W) bin-membership masks of boxes whose
    feature-space origin / extent are (y1, x1) / (bh, bw), each (R,)."""
    dev = y1.device
    i = torch.arange(oh, dtype=torch.float32, device=dev)[None, :, None]
    j = torch.arange(ow, dtype=torch.float32, device=dev)[None, :, None]
    y1, bh, x1, bw = (v[:, None, None] for v in (y1, bh, x1, bw))
    hstart = torch.clamp(torch.floor(i * bh / oh + y1), 0, h)
    hend = torch.clamp(torch.ceil((i + 1) * bh / oh + y1), 0, h)
    wstart = torch.clamp(torch.floor(j * bw / ow + x1), 0, w)
    wend = torch.clamp(torch.ceil((j + 1) * bw / ow + x1), 0, w)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    ymask = (ys >= hstart) & (ys < hend)                 # (R, oh, H)
    xmask = (xs >= wstart) & (xs < wend)                 # (R, ow, W)
    return ymask[:, :, None, :, None] & xmask[:, None, :, None, :]


def roi_pool(x, boxes, boxes_num=None, output_size=7,
             spatial_scale: float = 1.0, name=None):
    """RoIPool: the max over quantized bins (rounded after scaling, +1
    wide); an empty bin gives 0. x: (N, C, H, W); boxes: (R, 4) xyxy."""
    x = a(x)
    boxes = a(boxes, x.device).float()
    oh, ow = (output_size, output_size) if isinstance(output_size, int) \
        else output_size
    n, c, h, w = x.shape
    img_idx = _box_img_idx(boxes, boxes_num)
    x1, y1, x2, y2 = torch.round(boxes * spatial_scale).unbind(-1)
    bh = torch.clamp(y2 - y1 + 1, min=1.0)
    bw = torch.clamp(x2 - x1 + 1, min=1.0)
    masks = _bin_masks_from_bounds(y1, bh, x1, bw, oh, ow, h, w)
    feats = x[img_idx]                                   # (R, C, H, W)
    neg = torch.tensor(float("-inf"), dtype=x.dtype, device=x.device)
    vals = torch.where(masks[:, :, :, None], feats[:, None, None], neg)
    res = vals.amax(dim=(-2, -1))                        # (R, oh, ow, C)
    res = torch.where(torch.isfinite(res), res, torch.zeros_like(res))
    return res.permute(0, 3, 1, 2)


def psroi_pool(x, boxes, boxes_num=None, output_size=7,
               spatial_scale: float = 1.0, name=None):
    """Position-sensitive RoIPool (R-FCN): channels grouped as C = out_c
    · oh · ow; output bin (i, j) of group g averages channel g · oh · ow
    + i · ow + j over the bin (coordinates rounded, then scaled)."""
    x = a(x)
    boxes = a(boxes, x.device).float()
    oh, ow = (output_size, output_size) if isinstance(output_size, int) \
        else output_size
    n, c, h, w = x.shape
    if c % (oh * ow):
        raise ValueError(f"channels {c} must be divisible by "
                         f"output_size²={oh * ow}")
    out_c = c // (oh * ow)
    img_idx = _box_img_idx(boxes, boxes_num)
    r = torch.round(boxes)
    x1, y1 = r[:, 0] * spatial_scale, r[:, 1] * spatial_scale
    x2 = (r[:, 2] + 1.0) * spatial_scale
    y2 = (r[:, 3] + 1.0) * spatial_scale
    bh = torch.clamp(y2 - y1, min=0.1)
    bw = torch.clamp(x2 - x1, min=0.1)
    masks = _bin_masks_from_bounds(y1, bh, x1, bw, oh, ow, h, w)
    imgs = x[img_idx].reshape(-1, out_c, oh, ow, h, w)
    mf = masks.to(x.dtype)[:, None]                      # (R, 1, oh, ow, H, W)
    s = (imgs * mf).sum(dim=(-2, -1))
    cnt = torch.clamp(mf.sum(dim=(-2, -1)), min=1.0)
    return s / cnt                                       # (R, out_c, oh, ow)


def yolo_box(x, img_size, anchors, class_num: int, conf_thresh: float,
             downsample_ratio: int, clip_bbox: bool = True,
             scale_x_y: float = 1.0, iou_aware: bool = False,
             iou_aware_factor: float = 0.5, name=None):
    """Decode a YOLOv3 head's output into (boxes (N, A·H·W, 4), scores
    (N, A·H·W, classes)); the reference's elementwise formulas."""
    x = a(x)
    dev = x.device
    n, _, h, w = x.shape
    na = len(anchors) // 2
    anc = torch.tensor(anchors, dtype=torch.float32, device=dev).reshape(
        na, 2)
    img = a(img_size, dev).float().reshape(n, 2)         # (h, w)
    iou = None
    if iou_aware:
        iou = torch.sigmoid(x[:, :na])
        x = x[:, na:]
    feat = x.reshape(n, na, 5 + class_num, h, w)
    gx = torch.arange(w, dtype=torch.float32, device=dev)
    gy = torch.arange(h, dtype=torch.float32, device=dev)
    sxy = scale_x_y
    bx = (torch.sigmoid(feat[:, :, 0]) * sxy - (sxy - 1) / 2
          + gx[None, None, None, :]) / w
    by = (torch.sigmoid(feat[:, :, 1]) * sxy - (sxy - 1) / 2
          + gy[None, None, :, None]) / h
    in_w = w * downsample_ratio
    in_h = h * downsample_ratio
    bw = torch.exp(feat[:, :, 2]) * anc[None, :, 0, None, None] / in_w
    bh = torch.exp(feat[:, :, 3]) * anc[None, :, 1, None, None] / in_h
    obj = torch.sigmoid(feat[:, :, 4])
    if iou is not None:
        f = iou_aware_factor
        obj = torch.pow(obj, 1.0 - f) * torch.pow(iou, f)
    cls = torch.sigmoid(feat[:, :, 5:])
    scores = obj[:, :, None] * cls                       # (n, na, cls, h, w)
    obj_mask = (obj >= conf_thresh).to(x.dtype)
    imh = img[:, 0].reshape(n, 1, 1, 1)
    imw = img[:, 1].reshape(n, 1, 1, 1)
    x1 = (bx - bw / 2) * imw
    y1 = (by - bh / 2) * imh
    x2 = (bx + bw / 2) * imw
    y2 = (by + bh / 2) * imh
    if clip_bbox:
        zero = torch.zeros_like(x1)
        x1 = torch.minimum(torch.maximum(x1, zero), imw - 1)
        y1 = torch.minimum(torch.maximum(y1, zero), imh - 1)
        x2 = torch.minimum(torch.maximum(x2, zero), imw - 1)
        y2 = torch.minimum(torch.maximum(y2, zero), imh - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)        # (n, na, h, w, 4)
    boxes = boxes * obj_mask[..., None]
    boxes = boxes.reshape(n, na * h * w, 4)
    scores = (scores * obj_mask[:, :, None]).permute(0, 1, 3, 4, 2)
    scores = scores.reshape(n, na * h * w, class_num)
    return boxes, scores


def deformable_conv(x, offset, weight, bias=None, stride=1, padding=0,
                    dilation=1, deformable_groups: int = 1, groups: int = 1,
                    mask=None, name=None):
    """Deformable convolution v1 / v2. x (N, Cin, H, W); offset (N, 2 ·
    dg · kh · kw, Ho, Wo) as per-kernel-position (dy, dx) pairs; mask
    (N, dg · kh · kw, Ho, Wo) gives the modulated v2. The reference's
    im2col: per kernel position the offset-shifted input plane,
    bilinearly sampled with zero padding, then one grouped product with
    the flattened weights."""
    x = a(x)
    weight = a(weight, x.device)
    n, cin, h, w = x.shape
    cout, cin_g, kh, kw = weight.shape
    if cin % groups or cout % groups or cin_g != cin // groups:
        raise ValueError("channel/group mismatch")
    if cin % deformable_groups:
        raise ValueError(f"deformable_groups ({deformable_groups}) must "
                         f"divide the input channels ({cin})")
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    ph, pw = (padding, padding) if isinstance(padding, int) else padding
    dh, dw = (dilation, dilation) if isinstance(dilation, int) else dilation
    ho = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    wo = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    dg = deformable_groups
    offset = a(offset, x.device).reshape(n, dg, kh * kw, 2, ho, wo)
    if mask is not None:
        mask = a(mask, x.device).reshape(n, dg, kh * kw, ho, wo)
    base_y = (torch.arange(ho, device=x.device) * sh - ph)[:, None]
    base_x = (torch.arange(wo, device=x.device) * sw - pw)[None, :]
    dg_ch = cin // dg
    cols = []
    for ki in range(kh):
        for kj in range(kw):
            kidx = ki * kw + kj
            per_dg = []
            for g in range(dg):
                yy = base_y + ki * dh + offset[:, g, kidx, 0]
                xx = base_x + kj * dw + offset[:, g, kidx, 1]
                v = _bilinear_sample_zero_pad(
                    x[:, g * dg_ch:(g + 1) * dg_ch], yy, xx, h, w)
                if mask is not None:
                    v = v * mask[:, g, kidx][:, None]
                per_dg.append(v)
            cols.append(torch.cat(per_dg, dim=1))        # (N, Cin, Ho, Wo)
    col = torch.stack(cols, dim=1)                       # (N, K, Cin, Ho, Wo)
    col = col.permute(0, 2, 1, 3, 4).reshape(n, cin * kh * kw, ho * wo)
    wmat = weight.reshape(groups, cout // groups, cin_g * kh * kw)
    colg = col.reshape(n, groups, cin_g * kh * kw, ho * wo)
    res = torch.einsum("gok,ngkp->ngop", wmat, colg).reshape(n, cout, ho, wo)
    if bias is not None:
        res = res + a(bias, x.device).reshape(1, -1, 1, 1)
    return res


def graph_send_recv(x, src_index, dst_index, reduce_op: str = "sum",
                    out_size: Optional[int] = None, name=None):
    """Message passing: gather x[src], reduce into the dst slots (one
    segment reduction)."""
    d = a(x)
    msgs = d[long(src_index).to(d.device)]
    ids = long(dst_index).to(d.device)
    n = out_size or d.shape[0]
    if reduce_op == "mean":
        sums = _segment(msgs, ids, n, "sum")
        cnt = _segment(torch.ones(msgs.shape[0], dtype=d.dtype,
                                  device=d.device), ids, n, "sum")
        return sums / torch.clamp(cnt, min=1).reshape(
            (-1,) + (1,) * (d.dim() - 1))
    return _segment(msgs, ids, n, {"sum": "sum", "max": "amax",
                                   "min": "amin"}[reduce_op])

