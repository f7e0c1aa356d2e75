"""`hapi.Model` of the port against the JAX package's, over the ported
`io.DataLoader` and `vision.datasets.Cifar10` (synthetic fallback),
as `examples/train_cifar_resnet.py` drives it.

A small conv net (Conv-BN-ReLU-Pool twice, the head; names equal in both
packages), same weights, the same 64 training and 32 test images in the
same order (no shuffle), Momentum(0.05, 0.9, weight_decay=5e-4),
`CrossEntropyLoss`, `Accuracy`: `fit` for 2 epochs and `evaluate` give
the same log names, losses within 1e-4 relative (fp32; other summation
orders through four steps a epoch) and accuracies within one image.
Then the single-step APIs, `predict`, `save` / `load` (the state-dict
files JAX's `load` reads too), `ModelCheckpoint`, `num_iters`, O2, and
the CIFAR entry point with `resnet18` for a few steps.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import hapi as jhapi
from paddle_tpu import io as jio
from paddle_tpu import metric as jmetric
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework import io as jfio
from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import transforms as JT
from paddle_tpu_torch import hapi, metric, models, nn
from paddle_tpu_torch import io as pio
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import datasets as pds
from paddle_tpu_torch.vision import transforms as PT
from port_resnet import numpy_tree
from port_threads import one_torch_thread  # noqa: F401

MEAN, STD = [125.3, 123.0, 113.9], [63.0, 62.1, 66.7]


def _net(pkg):
    n = jnn if pkg == "jax" else nn
    g = {} if pkg == "jax" else {"gen": torch.Generator().manual_seed(0)}
    return n.Sequential(
        n.Conv2D(3, 8, 3, padding=1, **g), n.BatchNorm2D(8), n.ReLU(),
        n.MaxPool2D(2, 2), n.Conv2D(8, 16, 3, stride=2, padding=1, **g),
        n.BatchNorm2D(16), n.ReLU(), n.AdaptiveAvgPool2D(1), n.Flatten(),
        n.Linear(16, 10) if pkg == "jax" else n.Linear(16, 10, **g))


@pytest.fixture(scope="module", autouse=True)
def synthetic():
    jds.set_synthetic_fallback(True)
    pds.set_synthetic_fallback(True)
    yield
    jds._SYNTHETIC = None
    pds._SYNTHETIC = None


def _data(pkg, n_train=64, n_test=32):
    ds, T, io = (jds, JT, jio) if pkg == "jax" else (pds, PT, pio)
    tf = T.Compose([T.Normalize(MEAN, STD, data_format="HWC"),
                    T.Transpose()])
    return (io.Subset(ds.Cifar10(mode="train", transform=tf),
                      range(n_train)),
            io.Subset(ds.Cifar10(mode="test", transform=tf), range(n_test)))


@pytest.fixture(scope="module")
def runs():
    pt.seed(0)
    jnet = _net("jax")
    P, B = numpy_tree(jnet.raw_parameters()), numpy_tree(jnet.raw_buffers())
    out = {}
    for pkg in ("jax", "port"):
        train, test = _data(pkg)
        if pkg == "jax":
            m = jhapi.Model(jnet)
            m.prepare(jopt.Momentum(0.05, 0.9, weight_decay=5e-4),
                      jnn.CrossEntropyLoss(), jmetric.Accuracy())
            loader = jio.DataLoader
        else:
            m = hapi.Model(load_jax_state(_net("port"), P, B))
            m.prepare(Momentum(0.05, 0.9, weight_decay=5e-4),
                      nn.CrossEntropyLoss(), metric.Accuracy())
            loader = pio.DataLoader
        hist = m.fit(loader(train, batch_size=16),
                     loader(test, batch_size=16), epochs=2, verbose=0)
        ev = m.evaluate(loader(test, batch_size=16), verbose=0)
        out[pkg] = {"model": m, "hist": hist, "eval": ev}
    return out


def test_fit_history_matches_jax(runs):
    j, p = runs["jax"]["hist"], runs["port"]["hist"]
    assert set(p) == set(j) == {"loss", "acc", "ips"}
    np.testing.assert_allclose(p["loss"], j["loss"], rtol=1e-4)
    assert np.all(np.abs(np.subtract(p["acc"], j["acc"])) <= 1 / 16 + 1e-9)
    assert all(v > 0 for v in p["ips"])


def test_evaluate_matches_jax(runs):
    j, p = runs["jax"]["eval"], runs["port"]["eval"]
    assert set(p) == set(j) == {"loss", "acc"}
    np.testing.assert_allclose(p["loss"], j["loss"], rtol=1e-4)
    assert abs(p["acc"] - j["acc"]) <= 1 / 32 + 1e-9


def test_trained_state_matches_jax(runs):
    jst = runs["jax"]["model"]._trainer.state
    pst = runs["port"]["model"]._trainer.state
    for tree, jtree in ((pst.params, jst.params), (pst.buffers, jst.buffers)):
        for k, v in jtree.items():
            v = np.asarray(v)
            np.testing.assert_allclose(tree[k].detach().numpy(), v, rtol=0,
                                       atol=1e-4 * np.abs(v).max(),
                                       err_msg=k)


def test_single_step_apis_and_predict(runs):
    jm, pm = runs["jax"]["model"], runs["port"]["model"]
    _, jtest = _data("jax")
    _, ptest = _data("port")
    x = np.stack([ptest[i][0] for i in range(8)])
    y = np.stack([ptest[i][1] for i in range(8)])
    np.testing.assert_allclose(pm.predict_batch(x), jm.predict_batch(x),
                               rtol=0, atol=1e-4)
    jv, pv = jm.eval_batch(x, y), pm.eval_batch(x, y)
    np.testing.assert_allclose(pv[0], jv[0], rtol=1e-4)
    out = pm.predict(ptest, batch_size=16, stack_outputs=True)
    assert out.shape == (32, 10) and out.dtype == np.float32
    assert len(pm.predict(pio.DataLoader(ptest, batch_size=16))) == 2
    before = {k: v.clone() for k, v in pm._trainer.state.params.items()}
    loss, acc = pm.train_batch(x, y)
    assert np.isfinite(loss) and 0 <= acc <= 1
    assert any(not torch.equal(v, before[k])
               for k, v in pm._trainer.state.params.items())


def test_save_load_and_checkpoints(runs, tmp_path):
    pm = runs["port"]["model"]
    path = str(tmp_path / "ck" / "model")
    pm.save(path)
    state = jfio.load(path + ".pdparams")             # JAX reads it
    sd = pm.network.state_dict()
    assert set(state) == set(sd)
    for k, v in sd.items():
        assert np.array_equal(np.asarray(state[k]), v.numpy()), k
    fresh = hapi.Model(_net("port"))
    fresh.prepare(Momentum(0.05, 0.9), nn.CrossEntropyLoss(),
                  metric.Accuracy())
    fresh.load(path)
    for k, v in fresh.network.state_dict().items():
        assert torch.equal(v, sd[k]), k
    _, ptest = _data("port")
    np.testing.assert_array_equal(
        fresh.predict(ptest, batch_size=32, stack_outputs=True),
        pm.predict(ptest, batch_size=32, stack_outputs=True))
    train, _ = _data("port", n_train=32)
    ck = str(tmp_path / "ckpts")
    fresh.fit(train, batch_size=16, epochs=2, save_dir=ck, verbose=0,
              shuffle=False)
    assert sorted(os.listdir(ck)) == sorted(
        f"{e}.{s}" for e in ("0", "1", "final") for s in ("pdparams",
                                                          "pdopt"))


def test_num_iters_accumulation_and_o2(capsys):
    train, test = _data("port", n_train=64, n_test=16)
    m = hapi.Model(_net("port"))
    m.prepare(Momentum(0.05, 0.9), nn.CrossEntropyLoss(), metric.Accuracy(),
              amp_configs={"level": "O2", "dtype": "bfloat16"})
    hist = m.fit(train, batch_size=8, epochs=3, num_iters=5, verbose=1,
                 log_freq=2)
    assert len(hist["loss"]) == 1 and m._trainer.state.step == 5
    assert "Epoch 1/3" in capsys.readouterr().out
    st = m._trainer.state
    assert st.params["0.weight"].dtype == torch.bfloat16
    assert st.params["1.weight"].dtype == torch.float32      # BatchNorm
    assert all(b.dtype == torch.float32 for b in st.buffers.values())
    assert m.predict(test, batch_size=16)[0].dtype == np.float32
    with pytest.warns(UserWarning, match="accumulate_grad_batches"):
        m.fit(train, batch_size=8, epochs=1, accumulate_grad_batches=2,
              verbose=0)
    assert m._trainer.grad_accum == 2
    with pytest.raises(ValueError):
        m.fit(train, accumulate_grad_batches=0, verbose=0)


def test_cifar_entry_point_with_resnet18():
    """The example's pipeline: flip + normalize + transpose, shuffled,
    a ResNet-18 through fit and evaluate (a few steps on the CPU)."""
    tf = PT.Compose([PT.RandomHorizontalFlip(seed=0),
                     PT.Normalize(MEAN, STD, data_format="HWC"),
                     PT.Transpose()])
    train = pds.Cifar10(mode="train", transform=tf)
    test = pio.Subset(pds.Cifar10(mode="test", transform=tf), range(32))
    m = hapi.Model(models.resnet18(num_classes=10, device="cpu"))
    m.prepare(Momentum(learning_rate=0.05, momentum=0.9, weight_decay=5e-4),
              nn.CrossEntropyLoss(), metric.Accuracy())
    hist = m.fit(pio.DataLoader(train, batch_size=16, shuffle=True),
                 pio.DataLoader(test, batch_size=16), epochs=1, verbose=0,
                 num_iters=3)
    assert np.isfinite(hist["loss"][0]) and hist["ips"][0] > 0
    ev = m.evaluate(pio.DataLoader(test, batch_size=16), verbose=0)
    assert set(ev) == {"loss", "acc"} and np.isfinite(ev["loss"])
