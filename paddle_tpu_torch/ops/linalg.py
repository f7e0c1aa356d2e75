"""Linear algebra ops: the counterpart of `paddle_tpu/ops/linalg.py`,
over `torch.linalg` on the tensor's device.

Where torch's route differs by device the port takes one that does
not: `lstsq` solves through the SVD (torch's CUDA `lstsq` takes only
full-rank, tall systems, by `gels`), returning JAX's four results
(solution, residuals, rank, singular values); `histogram` and
`histogramdd` bin with `searchsorted` and a scatter-add on the device
(`torch.histogram` runs on the CPU only), with the reference's edges:
JAX's for `histogram` (the last bin takes its right edge), numpy's
float64 edges for `histogramdd`. `eig` / `eigvals` return complex64,
as the reference's.
"""
from __future__ import annotations

import functools

import torch

from ._common import a, floating, out, pair

__all__ = [
    "norm", "vector_norm", "matrix_norm", "cond", "det", "slogdet", "inv",
    "pinv", "matrix_power", "matrix_rank", "svd", "qr", "lu", "cholesky",
    "cholesky_solve", "triangular_solve", "solve", "lstsq", "eig", "eigh",
    "eigvals", "eigvalsh", "multi_dot", "householder_product", "pca_lowrank",
    "einsum", "corrcoef", "cov", "histogram", "histogramdd", "bincount",
]


def _axes(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    return tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    x = a(x)
    dim = _axes(axis, x.dim())
    if p == "fro" or (p is None and axis is None):
        return torch.sqrt(torch.sum(torch.square(x), dim=dim,
                                    keepdim=keepdim))
    if p == "nuc":
        return torch.linalg.matrix_norm(x, "nuc", dim=dim, keepdim=keepdim)
    if p == float("inf"):
        return torch.amax(torch.abs(x), dim=dim, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), dim=dim, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=dim, keepdim=keepdim)
    p = 2 if p is None else p
    return torch.sum(torch.abs(x) ** p, dim=dim, keepdim=keepdim) ** (1.0 / p)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return norm(x, p=p, axis=axis, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return torch.linalg.matrix_norm(a(x), p, dim=tuple(axis),
                                    keepdim=keepdim)


def cond(x, p=None, name=None):
    return torch.linalg.cond(a(x), p)


def det(x, name=None):
    return torch.linalg.det(a(x))


def slogdet(x, name=None):
    sign, logdet = torch.linalg.slogdet(a(x))
    return torch.stack([sign, logdet])


def inv(x, name=None):
    return torch.linalg.inv(a(x))


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(a(x), rtol=rcond, hermitian=hermitian)


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(a(x), n)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return out(torch.linalg.matrix_rank(a(x), rtol=tol, hermitian=hermitian))


def svd(x, full_matrices=False, name=None):
    return tuple(torch.linalg.svd(a(x), full_matrices=full_matrices))


def qr(x, mode="reduced", name=None):
    q, r = torch.linalg.qr(a(x), mode=mode)
    return r if mode == "r" else (q, r)


def lu(x, pivot=True, get_infos=False, name=None):
    """(LU, pivots[, info]) with LAPACK's 1-based pivots, as the
    reference keeps them."""
    lu_mat, piv = torch.linalg.lu_factor(a(x))
    piv = out(piv)
    if get_infos:
        return lu_mat, piv, torch.zeros((), dtype=torch.int32,
                                        device=lu_mat.device)
    return lu_mat, piv


def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(a(x), upper=upper)


def cholesky_solve(x, y, upper=False, name=None):
    return torch.cholesky_solve(*pair(x, y), upper=upper)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    x, y = pair(x, y)
    if transpose:
        x, upper = x.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(x, y, upper=upper,
                                         unitriangular=unitriangular)


def solve(x, y, name=None):
    return torch.linalg.solve(*pair(x, y))


def lstsq(x, y, rcond=None, driver=None, name=None):
    """`jnp.linalg.lstsq` through the SVD on any device: (solution,
    residuals (the squared residual per column when the system is tall
    and of full rank, else empty), rank (int32), singular values);
    singular values at or below rcond · s_max (rcond defaults to eps ·
    max(m, n)) are dropped."""
    x, y = pair(x, y)
    vec = y.dim() == 1
    b = y.unsqueeze(-1) if vec else y
    m, n = x.shape[-2], x.shape[-1]
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    if rcond is None:
        rcond = torch.finfo(s.dtype).eps * max(m, n)
    keep = s > rcond * s[..., :1]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    sol = vh.transpose(-1, -2) @ (s_inv.unsqueeze(-1)
                                  * (u.transpose(-1, -2) @ b))
    rank = keep.sum(-1).to(torch.int32)
    if m > n and bool((rank == n).all()):
        resid = torch.sum(torch.square(b - x @ sol), dim=-2)
        resid = resid.squeeze(-1) if vec else resid
    else:
        resid = torch.zeros((0,), dtype=x.dtype, device=x.device)
    return (sol.squeeze(-1) if vec else sol), resid, rank, s


def eig(x, name=None):
    w, v = torch.linalg.eig(a(x))
    return out(w), out(v)


def eigh(x, UPLO="L", name=None):
    return tuple(torch.linalg.eigh(a(x), UPLO=UPLO))


def eigvals(x, name=None):
    return out(torch.linalg.eigvals(a(x)))


def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(a(x), UPLO=UPLO)


def _promoted(arrays):
    """The tensors cast to their common dtype (JAX's promotion)."""
    ts = [a(v) for v in arrays]
    dt = functools.reduce(torch.promote_types, [t.dtype for t in ts])
    return [t.to(dt) for t in ts]


def multi_dot(arrays, name=None):
    return torch.linalg.multi_dot(_promoted(arrays))


def householder_product(x, tau, name=None):
    return torch.linalg.householder_product(*pair(x, tau))


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """The reference's: a full SVD of the (centred) input, cut to q."""
    x = a(x)
    m, n = x.shape[-2:]
    q = q if q is not None else min(6, m, n)
    if center:
        x = x - torch.mean(x, dim=-2, keepdim=True)
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    return u[..., :q], s[..., :q], vh.transpose(-1, -2)[..., :q]


def einsum(equation, *operands):
    return torch.einsum(equation, *_promoted(operands))


def corrcoef(x, rowvar=True, name=None):
    x = floating(a(x))
    return torch.corrcoef(x if rowvar else x.transpose(-1, -2))


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    x = floating(a(x))
    if x.dim() > 1 and not rowvar:
        x = x.transpose(-1, -2)
    return torch.cov(x, correction=1 if ddof else 0,
                     fweights=None if fweights is None else a(fweights),
                     aweights=None if aweights is None else a(aweights))


def histogram(input, bins=100, min=0, max=0, name=None):
    """Counts of `bins` equal bins over [min, max] (the data's range
    when both are 0), as `jnp.histogram`: a value on the last edge goes
    to the last bin, a value outside to none; float counts, as JAX's."""
    x = a(input).reshape(-1)
    if min == 0 and max == 0:
        lo, hi = torch.amin(x), torch.amax(x)
    else:
        lo = torch.tensor(min, dtype=x.dtype, device=x.device)
        hi = torch.tensor(max, dtype=x.dtype, device=x.device)
    edges = lo + (hi - lo) * torch.linspace(0, 1, bins + 1, dtype=x.dtype,
                                            device=x.device)
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], torch.full_like(idx, bins), idx)
    counts = torch.zeros(bins + 2, dtype=floating(x).dtype, device=x.device)
    counts.index_add_(0, idx, torch.ones_like(x, dtype=counts.dtype))
    return counts[1:-1]


def _np_linspace(lo, hi, num, device):
    """numpy's float64 `linspace` (start + i · step, the stop exact)."""
    step = (hi - lo) / (num - 1)
    e = torch.arange(num, dtype=torch.float64, device=device) * step + lo
    e[-1] = hi
    return e


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """`np.histogramdd` of the rows of x (N, D) on the device: numpy's
    float64 edges, the right edge of each last bin included; (counts,
    edges) as fp32, as the reference returns them."""
    x = a(x)
    n, d = x.shape
    bins = [bins] * d if isinstance(bins, int) else list(bins)
    xd = x.to(torch.float64)
    edges, flat = [], torch.zeros(n, dtype=torch.long, device=x.device)
    inside = torch.ones(n, dtype=torch.bool, device=x.device)
    for i in range(d):
        if ranges is None:
            lo, hi = float(xd[:, i].min()), float(xd[:, i].max())
        else:
            lo, hi = (float(v) for v in ranges[i])
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        e = _np_linspace(lo, hi, bins[i] + 1, x.device)
        idx = torch.searchsorted(e, xd[:, i].contiguous(), right=True)
        idx = idx - (xd[:, i] == e[-1]).long()
        inside &= (idx >= 1) & (idx <= bins[i])
        flat = flat * bins[i] + (idx - 1).clamp(0, bins[i] - 1)
        edges.append(e)
    w = torch.ones(n, dtype=torch.float64, device=x.device) \
        if weights is None else a(weights, x.device).to(torch.float64)
    total = 1
    for b in bins:
        total *= b
    hist = torch.zeros(total, dtype=torch.float64, device=x.device)
    hist.index_add_(0, flat[inside], w[inside])
    hist = hist.reshape(bins)
    if density:
        hist = hist / hist.sum()
        for i, e in enumerate(edges):
            shape = [1] * d
            shape[i] = bins[i]
            hist = hist / torch.diff(e).reshape(shape)
    return out(hist), [out(e) for e in edges]


def bincount(x, weights=None, minlength=0, name=None):
    x = a(x)
    w = None if weights is None else a(weights, x.device)
    res = torch.bincount(x, w, minlength)
    return out(res if w is None else res.to(w.dtype))
