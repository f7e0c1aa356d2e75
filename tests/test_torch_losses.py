"""The port's losses (`nn.functional` and `nn/layers_loss.py`) against the
JAX package's, on the same seeded fp32 inputs: every function with
each reduction it takes ("mean", "sum", "none"; `kl_div` also
"batchmean"), weights, `ignore_index`, `pos_weight`, `log_target`,
`full`, `swap` and the other switches, and each loss layer built with
the same arguments. Values within 1e-5 absolute + 1e-5 relative (the
same formulas; the libraries' log / exp / pow differ in the last ulp;
CTC's forward algorithm sums in another order). CTC's gradient with
respect to the scores against `jax.grad`'s within 1e-4 of its largest
magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as jF
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F
from port_threads import one_torch_thread  # noqa: F401

RS = np.random.RandomState(0)
X = RS.randn(6, 5).astype(np.float32)
Y = RS.randn(6, 5).astype(np.float32)
P = (1 / (1 + np.exp(-X))).astype(np.float32)            # in (0, 1)
T01 = (RS.rand(6, 5) > 0.5).astype(np.float32)
PM1 = np.where(RS.rand(6) > 0.5, 1.0, -1.0).astype(np.float32)
LOGP = (X - np.log(np.exp(X).sum(1, keepdims=True))).astype(np.float32)
LAB = np.array([0, 4, 2, -100, 1, 3])
W5 = np.linspace(0.5, 1.5, 5).astype(np.float32)
VAR = (np.abs(Y) + 0.1).astype(np.float32)
COUNTS = np.floor(np.abs(Y) * 3).astype(np.float32)


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def _call(fn, args, kw, pkg):
    conv = jnp.asarray if pkg == "jax" else torch.from_numpy
    return fn(*[conv(a) if isinstance(a, np.ndarray) else a for a in args],
              **{k: conv(v) if isinstance(v, np.ndarray) else v
                 for k, v in kw.items()})


# (name, args, kwargs); each runs at every reduction in REDUCTIONS[name]
CASES = [
    ("binary_cross_entropy", (P, T01), {}),
    ("binary_cross_entropy", (P, T01), {"weight": W5}),
    ("binary_cross_entropy_with_logits", (X, T01), {}),
    ("binary_cross_entropy_with_logits", (X, T01), {"pos_weight": W5}),
    ("binary_cross_entropy_with_logits", (X, T01), {"weight": W5}),
    ("mse_loss", (X, Y), {}), ("l1_loss", (X, Y), {}),
    ("nll_loss", (LOGP, LAB), {}),
    ("nll_loss", (LOGP, LAB), {"weight": W5}),
    ("smooth_l1_loss", (X, Y), {"delta": 0.7}),
    ("huber_loss", (X, Y), {"delta": 0.7}),
    ("kl_div", (LOGP, P), {}), ("kl_div", (LOGP, LOGP), {"log_target": True}),
    ("poisson_nll_loss", (X, COUNTS), {}),
    ("poisson_nll_loss", (P, COUNTS), {"log_input": False, "full": True}),
    ("margin_ranking_loss", (X[:, 0], Y[:, 0], PM1), {"margin": 0.2}),
    ("hinge_embedding_loss", (X, np.where(T01 > 0, 1.0, -1.0)
                              .astype(np.float32)), {"margin": 0.5}),
    ("cosine_embedding_loss", (X, Y, PM1), {"margin": 0.1}),
    ("triplet_margin_loss", (X, Y, P), {}),
    ("triplet_margin_loss", (X, Y, P), {"p": 1.0, "swap": True}),
    ("soft_margin_loss", (X, np.where(T01 > 0, 1.0, -1.0)
                          .astype(np.float32)), {}),
    ("multi_label_soft_margin_loss", (X, T01), {}),
    ("multi_label_soft_margin_loss", (X, T01), {"weight": W5}),
    ("gaussian_nll_loss", (X, Y, VAR), {}),
    ("gaussian_nll_loss", (X, Y, VAR), {"full": True}),
    ("sigmoid_focal_loss", (X, T01), {}),
    ("sigmoid_focal_loss", (X, T01), {"normalizer": np.float32(4.0),
                                      "gamma": 1.5}),
]
REDUCTIONS = {"kl_div": ("mean", "sum", "none", "batchmean")}


def _cases():
    for name, args, kw in CASES:
        for red in REDUCTIONS.get(name, ("mean", "sum", "none")):
            yield name, args, kw, red


@pytest.mark.parametrize("name,args,kw,reduction", list(_cases()),
                         ids=[f"{n}-{sorted(k)}-{r}"
                              for n, _, k, r in _cases()])
def test_loss_matches_jax(name, args, kw, reduction):
    kw = dict(kw, reduction=reduction)
    _close(_call(getattr(F, name), args, kw, "port"),
           _call(getattr(jF, name), args, kw, "jax"))


@pytest.mark.parametrize("name,args,kw", [
    ("square_error_cost", (X, Y), {}), ("log_loss", (P, T01), {}),
    ("cosine_similarity", (X, Y), {"axis": 1}),
    ("pairwise_distance", (X, Y), {"p": 3.0, "keepdim": True}),
    ("npair_loss", (X, Y, np.array([0, 1, 0, 2, 1, 2])), {}),
    ("softmax_with_cross_entropy", (X, LAB[:, None]), {}),
    ("softmax_with_cross_entropy", (X, P / P.sum(1, keepdims=True)),
     {"soft_label": True}),
], ids=lambda v: v if isinstance(v, str) else None)
def test_other_matches_jax(name, args, kw):
    _close(_call(getattr(F, name), args, kw, "port"),
           _call(getattr(jF, name), args, kw, "jax"))


def test_softmax_with_cross_entropy_returns_softmax():
    got = F.softmax_with_cross_entropy(torch.from_numpy(X),
                                       torch.from_numpy(LAB[:, None]),
                                       return_softmax=True)
    want = jF.softmax_with_cross_entropy(jnp.asarray(X),
                                         jnp.asarray(LAB[:, None]),
                                         return_softmax=True)
    for g, w in zip(got, want):
        _close(g, w)


def _ctc_inputs():
    rs = np.random.RandomState(1)
    T, N, C, L = 12, 3, 6, 4
    scores = rs.randn(T, N, C).astype(np.float32)
    labels = rs.randint(1, C, (N, L))
    labels[1, 1] = labels[1, 0]              # a repeat: needs a blank
    return scores, labels, np.array([12, 9, 7]), np.array([4, 3, 0])


@pytest.mark.parametrize("reduction,norm", [("mean", False), ("sum", False),
                                            ("none", True)])
def test_ctc_matches_jax(reduction, norm):
    s, lab, il, ll = _ctc_inputs()
    got = F.ctc_loss(torch.from_numpy(s), lab, il, ll, blank=0,
                     reduction=reduction, norm_by_times=norm)
    want = jF.ctc_loss(jnp.asarray(s), jnp.asarray(lab), jnp.asarray(il),
                       jnp.asarray(ll), blank=0, reduction=reduction,
                       norm_by_times=norm)
    _close(got, want)


def test_ctc_grad_matches_jax():
    s, lab, il, ll = _ctc_inputs()
    want = jax.grad(lambda x: jF.ctc_loss(x, jnp.asarray(lab),
                                          jnp.asarray(il),
                                          jnp.asarray(ll)))(jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_()
    F.ctc_loss(st, lab, il, ll).backward()
    want = np.asarray(want)
    assert np.abs(st.grad.numpy() - want).max() <= 1e-4 * np.abs(want).max()


# (class, constructor kwargs, forward args)
LAYERS = [
    ("MSELoss", {"reduction": "sum"}, (X, Y)),
    ("L1Loss", {}, (X, Y)),
    ("NLLLoss", {"weight": W5}, (LOGP, LAB)),
    ("BCELoss", {"weight": W5}, (P, T01)),
    ("BCEWithLogitsLoss", {"pos_weight": W5}, (X, T01)),
    ("KLDivLoss", {"reduction": "batchmean"}, (LOGP, P)),
    ("SmoothL1Loss", {"delta": 0.5}, (X, Y)),
    ("HuberLoss", {"delta": 0.5}, (X, Y)),
    ("MarginRankingLoss", {"margin": 0.3}, (X[:, 0], Y[:, 0], PM1)),
    ("HingeEmbeddingLoss", {}, (X, np.where(T01 > 0, 1.0, -1.0)
                                .astype(np.float32))),
    ("CosineEmbeddingLoss", {"margin": 0.2}, (X, Y, PM1)),
    ("TripletMarginLoss", {"swap": True}, (X, Y, P)),
    ("PoissonNLLLoss", {"full": True}, (X, COUNTS)),
    ("GaussianNLLLoss", {"full": True}, (X, Y, VAR)),
    ("SoftMarginLoss", {}, (X, np.where(T01 > 0, 1.0, -1.0)
                            .astype(np.float32))),
    ("MultiLabelSoftMarginLoss", {}, (X, T01)),
    ("CrossEntropyLoss", {"label_smoothing": 0.1}, (X, np.abs(LAB) % 5)),
]


@pytest.mark.parametrize("cls,kw,args", LAYERS, ids=[c for c, _, _ in LAYERS])
def test_loss_layer_matches_jax(cls, kw, args):
    def build(mod, conv):
        return getattr(mod, cls)(**{k: conv(v) if isinstance(v, np.ndarray)
                                    else v for k, v in kw.items()})

    got = build(nn, torch.from_numpy)(*[torch.from_numpy(np.asarray(a))
                                        for a in args])
    want = build(jnn, jnp.asarray)(*[jnp.asarray(a) for a in args])
    _close(got, want)


def test_ctc_layer():
    s, lab, il, ll = _ctc_inputs()
    got = nn.CTCLoss(blank=0, reduction="sum")(torch.from_numpy(s), lab, il,
                                               ll)
    want = jnn.CTCLoss(blank=0, reduction="sum")(
        jnp.asarray(s), jnp.asarray(lab), jnp.asarray(il), jnp.asarray(ll))
    _close(got, want)
