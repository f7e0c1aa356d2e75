"""The port's image pipeline and training tools against the JAX
package's, on the same seeded numpy inputs.

- Transforms: each random transform (and a Compose of them) gives JAX's
  arrays bitwise under one seed (JAX reseeded with `paddle_tpu.seed`,
  the port given `SeededRandom(seed)`), and so do the functionals
  (`rotate`, `to_grayscale`, `adjust_*`, `erase`) on uint8 and float
  images.
- Datasets: `Flowers` and `VOC2012` on the synthetic fallback, and
  `DatasetFolder` / `ImageFolder` / `VOC2012` on fixture trees written
  under `tmp_path` (`.npy` trees; PNG and JPEG files through PIL), sample
  for sample.
- The native collate: bitwise `np.stack` and JAX's `collate_batch`,
  through `default_collate_fn` too; a failed build raises.
- The callbacks `EarlyStopping`, `LRSchedulerCallback` and `VisualDL`
  on a scripted sequence of logs: the same decisions, learning rates
  and scalars file, line for line.
- `summary` on `LeNet` and `mobilenet_v2`: the same printed table and
  totals as JAX's.
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as P
from paddle_tpu import io as jio
from paddle_tpu import models as jmodels
from paddle_tpu import native as jnative
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.hapi.model_summary import summary as jax_summary
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import transforms as JT
from paddle_tpu.vision.transforms import functional as JTF
from paddle_tpu_torch import hapi, native
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import models
from paddle_tpu_torch.hapi import callbacks as pcb
from paddle_tpu_torch.optimizer import lr as plr
from paddle_tpu_torch.vision import datasets as pds
from paddle_tpu_torch.vision import transforms as PT
from paddle_tpu_torch.vision.transforms import functional as PTF
from port_threads import one_torch_thread  # noqa: F401


def _img(h, w, c=3, seed=0, dtype=np.uint8):
    rs = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rs.randint(0, 256, (h, w, c)).astype(np.uint8)
    return rs.rand(h, w, c).astype(dtype)


# --------------------------------------------------------------------------- #
# transforms
# --------------------------------------------------------------------------- #

RANDOM = {  # name: (JAX transform, port transform given a stream)
    "RandomResizedCrop": (lambda: JT.RandomResizedCrop(24),
                          lambda r: PT.RandomResizedCrop(24, seed=r)),
    "RandomResizedCrop_nearest": (
        lambda: JT.RandomResizedCrop((20, 16), scale=(0.5, 1.0),
                                     interpolation="nearest"),
        lambda r: PT.RandomResizedCrop((20, 16), scale=(0.5, 1.0),
                                       interpolation="nearest", seed=r)),
    "RandomVerticalFlip": (lambda: JT.RandomVerticalFlip(),
                           lambda r: PT.RandomVerticalFlip(seed=r)),
    "BrightnessTransform": (lambda: JT.BrightnessTransform(0.4),
                            lambda r: PT.BrightnessTransform(0.4, seed=r)),
    "ContrastTransform": (lambda: JT.ContrastTransform(0.4),
                          lambda r: PT.ContrastTransform(0.4, seed=r)),
    "SaturationTransform": (lambda: JT.SaturationTransform(0.4),
                            lambda r: PT.SaturationTransform(0.4, seed=r)),
    "HueTransform": (lambda: JT.HueTransform(0.2),
                     lambda r: PT.HueTransform(0.2, seed=r)),
    "ColorJitter": (lambda: JT.ColorJitter(0.4, 0.4, 0.4, 0.1),
                    lambda r: PT.ColorJitter(0.4, 0.4, 0.4, 0.1, seed=r)),
    "RandomRotation": (lambda: JT.RandomRotation(30),
                       lambda r: PT.RandomRotation(30, seed=r)),
    "RandomRotation_expand": (
        lambda: JT.RandomRotation((-90, 90), expand=True, fill=7),
        lambda r: PT.RandomRotation((-90, 90), expand=True, fill=7,
                                    seed=r)),
    "Grayscale": (lambda: JT.Grayscale(3), lambda r: PT.Grayscale(3)),
    "RandomErasing": (lambda: JT.RandomErasing(prob=0.7, value=3),
                      lambda r: PT.RandomErasing(prob=0.7, value=3,
                                                 seed=r)),
}


def _images():
    return [_img(40, 50, seed=1), _img(33, 21, seed=2),
            _img(64, 64, seed=3), _img(17, 30, seed=4)]


def _run_both(make_jax, make_port, images, seed=5):
    jpt.seed(seed)
    jt = make_jax()
    want = [jt(a) for a in images]
    pt_ = make_port(PT.SeededRandom(seed))
    got = [pt_(a) for a in images]
    return got, want


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_transform_is_jax_s_bitwise(name):
    got, want = _run_both(*RANDOM[name], _images())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_random_erasing_on_chw_float_and_a_training_pipeline():
    imgs = [_img(48, 40, seed=s) for s in range(4)]

    def pipe(T, r=None):
        kw = {} if r is None else {"seed": r}
        return T.Compose([
            T.RandomResizedCrop(32, **kw), T.ColorJitter(0.4, 0.4, 0.4, 0.1,
                                                         **kw),
            T.RandomHorizontalFlip(**kw), T.ToTensor(),
            T.Normalize([0.5, 0.5, 0.5], [0.25, 0.25, 0.25]),
            T.RandomErasing(prob=0.9, value=0.5, **kw)])

    got, want = _run_both(lambda: pipe(JT), lambda r: pipe(PT, r), imgs)
    for g, w in zip(got, want):
        assert g.shape == (3, 32, 32) and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_functionals_are_jax_s(dtype):
    a = _img(21, 30, seed=6, dtype=dtype)
    cases = [("rotate", (a, 37.0)), ("rotate", (a, 90.0, "nearest", True)),
             ("rotate", (a, -20.0, "nearest", False, (4, 9), 3)),
             ("to_grayscale", (a,)), ("to_grayscale", (a, 3)),
             ("to_grayscale", (a[:, :, :1],)),
             ("adjust_brightness", (a, 1.3)), ("adjust_contrast", (a, 0.6)),
             ("adjust_saturation", (a, 1.7)), ("adjust_hue", (a, 0.3)),
             ("adjust_hue", (a, -0.45)), ("adjust_hue", (a[:, :, :1], 0.2)),
             ("erase", (a, 3, 4, 5, 6, 1))]
    for name, args in cases:
        got = getattr(PTF, name)(*args)
        want = getattr(JTF, name)(*args)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    with pytest.raises(ValueError, match="hue factor"):
        PTF.adjust_hue(a, 0.7)
    b = a.copy()
    assert PTF.erase(b, 0, 0, 2, 2, 0, inplace=True) is b
    assert set(JTF.__all__) == set(PTF.__all__)


def test_transform_argument_checks():
    with pytest.raises(ValueError, match="contrast"):
        PT.ContrastTransform(-1)
    with pytest.raises(ValueError, match="hue"):
        PT.HueTransform(0.6)
    with pytest.raises(ValueError, match="degrees"):
        PT.RandomRotation(-3)
    a = _img(8, 8)
    assert PT.BrightnessTransform(0)(a) is a      # no draw at 0
    img, label = PT.Grayscale()((a, 3))
    assert img.shape == (8, 8, 1) and label == 3


# --------------------------------------------------------------------------- #
# datasets
# --------------------------------------------------------------------------- #

@pytest.fixture
def synthetic():
    jds.set_synthetic_fallback(True)
    pds.set_synthetic_fallback(True)
    yield
    jds.set_synthetic_fallback(False)
    pds.set_synthetic_fallback(False)


def _same_samples(got_ds, want_ds, idx=None):
    assert len(got_ds) == len(want_ds)
    for i in (idx if idx is not None else range(len(want_ds))):
        g, w = got_ds[i], want_ds[i]
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_synthetic_flowers_and_voc_are_jax_s(synthetic, tmp_path):
    for mode in ("train", "valid", "test"):
        _same_samples(pds.Flowers(mode=mode), jds.Flowers(mode=mode),
                      [0, 5, 63])
        _same_samples(pds.VOC2012(mode=mode), jds.VOC2012(mode=mode),
                      [0, 7, 15])
    f = pds.Flowers()
    assert f.NUM_CLASSES == 102 and f[0][0].shape == (64, 64, 3)
    t = PT.Compose([PT.Resize(32), PT.Transpose()])
    assert pds.Flowers(transform=t)[1][0].shape == (3, 32, 32)
    (tmp_path / "102flowers.tgz").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="ImageFolder"):
        pds.Flowers(data_file=str(tmp_path / "102flowers.tgz"))
    with pytest.raises(ValueError, match="mode"):
        pds.Flowers(mode="eval")
    pds.set_synthetic_fallback(False)
    with pytest.raises(FileNotFoundError, match="downloaded"):
        pds.VOC2012()


def _npy_tree(root):
    rs = np.random.RandomState(9)
    for c, n in (("cat", 3), ("dog", 2), ("emu", 1)):
        (root / c / "sub").mkdir(parents=True)
        for i in range(n):
            np.save(root / c / f"{i}.npy",
                    rs.randint(0, 255, (6, 5, 3)).astype(np.uint8))
        np.save(root / c / "sub" / "deep.npy", np.zeros((6, 5, 3), np.uint8))
        (root / c / "notes.txt").write_text("skip me")
    (root / "stray.npy").write_bytes(b"")          # not in a class dir


def test_folder_datasets_are_jax_s(tmp_path):
    _npy_tree(tmp_path)
    got, want = pds.DatasetFolder(str(tmp_path)), \
        jds.DatasetFolder(str(tmp_path))
    assert got.classes == want.classes == ["cat", "dog", "emu"]
    assert got.class_to_idx == want.class_to_idx
    assert got.samples == want.samples and len(got) == 9
    _same_samples(got, want)
    only = lambda p: p.endswith("0.npy")             # noqa: E731
    assert pds.DatasetFolder(str(tmp_path), is_valid_file=only).samples \
        == jds.DatasetFolder(str(tmp_path), is_valid_file=only).samples
    got, want = pds.ImageFolder(str(tmp_path / "cat")), \
        jds.ImageFolder(str(tmp_path / "cat"))
    assert got.samples == want.samples
    _same_samples(got, want)
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no class directories"):
        pds.DatasetFolder(str(tmp_path / "empty"))
    with pytest.raises(ValueError, match="no images"):
        pds.ImageFolder(str(tmp_path / "empty"))
    np.testing.assert_array_equal(
        pds.default_loader(str(tmp_path / "cat" / "0.npy")),
        jds.default_loader(str(tmp_path / "cat" / "0.npy")))


def test_voc_tree_and_image_files_through_pil(tmp_path):
    from PIL import Image
    root = tmp_path / "VOC2012"
    (root / "ImageSets" / "Segmentation").mkdir(parents=True)
    (root / "JPEGImages").mkdir()
    (root / "SegmentationClass").mkdir()
    rs = np.random.RandomState(10)
    names = ["2007_000032", "2007_000039"]
    for n in names:
        Image.fromarray(rs.randint(0, 255, (12, 10, 3)).astype(np.uint8)) \
            .save(root / "JPEGImages" / f"{n}.jpg")
        Image.fromarray(rs.randint(0, 21, (12, 10)).astype(np.uint8)) \
            .save(root / "SegmentationClass" / f"{n}.png")
    (root / "ImageSets" / "Segmentation" / "trainval.txt").write_text(
        "\n".join(names) + "\n")
    _same_samples(pds.VOC2012(str(root)), jds.VOC2012(str(root)))
    img, mask = pds.VOC2012(str(root))[1]
    assert img.shape == (12, 10, 3) and mask.dtype == np.int64
    png = tmp_path / "pic.png"
    Image.fromarray(rs.randint(0, 255, (7, 9, 3)).astype(np.uint8)).save(png)
    np.testing.assert_array_equal(pds.default_loader(str(png)),
                                  jds.default_loader(str(png)))


# --------------------------------------------------------------------------- #
# the native collate
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("shape,dtype,n", [
    ((3, 224, 224), np.float32, 8), ((5,), np.int64, 3), ((7, 9), np.uint8, 2),
    ((2, 3), np.float16, 1), ((4, 4), np.float32, 64)])
def test_native_collate_is_np_stack_bitwise(shape, dtype, n):
    rs = np.random.RandomState(11)
    xs = [(rs.randn(*shape) * 50).astype(dtype) for _ in range(n)]
    want = np.stack(xs)
    for threads in (None, 1, 4):
        got = native.collate_batch(xs, n_threads=threads)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native.collate_batch(xs),
                                  jnative.collate_batch(xs))


def test_native_collate_edges_and_default_collate_fn():
    xs = [np.arange(6, dtype=np.float32).reshape(2, 3)[:, ::2]] * 3
    np.testing.assert_array_equal(native.collate_batch(xs), np.stack(xs))
    with pytest.raises(ValueError):                   # ragged: np.stack's
        native.collate_batch([np.zeros(3), np.zeros(4)])
    mixed = native.collate_batch([np.zeros(2, np.int32),
                                  np.ones(2, np.float32)])
    assert mixed.dtype == np.float64                  # np.stack promotes
    obj = native.collate_batch([np.array([{}], object)] * 2)
    assert obj.dtype == object
    rs = np.random.RandomState(12)
    batch = [(rs.rand(3, 64, 64).astype(np.float32), np.int64(i))
             for i in range(16)]                      # 768 KiB: native
    got, want = pio.default_collate_fn(batch), jio.default_collate_fn(batch)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert native.host_library_path("collate").exists()


def test_native_collate_build_failure_raises(monkeypatch):
    calls = []

    def broken(name):
        calls.append(name)
        raise RuntimeError("compiling collate.cc failed")

    monkeypatch.setattr(native, "_COLLATE", {})   # nothing loaded yet
    monkeypatch.setattr(native, "_compile", broken)
    monkeypatch.setenv("PTPU_NO_NATIVE", "1")     # no opt-out either
    xs = [np.zeros(4, np.float32)] * 2
    for _ in range(2):
        with pytest.raises(RuntimeError, match="collate"):
            native.collate_batch(xs)
    assert calls == ["collate"]                   # g++ ran once


# --------------------------------------------------------------------------- #
# callbacks
# --------------------------------------------------------------------------- #

EVAL_LOGS = [{"loss": 2.0, "acc": 0.1}, {"loss": 1.5, "acc": 0.3},
             {"loss": 1.52, "acc": 0.3}, {"loss": 1.49, "acc": 0.35},
             {"loss": 1.6, "acc": 0.2}, {"loss": 1.7, "acc": 0.2},
             {"loss": 1.8, "acc": 0.1}]


@pytest.mark.parametrize("kw", [
    {}, {"patience": 2}, {"monitor": "acc", "patience": 1},
    {"monitor": "acc", "mode": "min", "patience": 2},
    {"patience": 1, "min_delta": 0.05}])
def test_early_stopping_decides_as_jax(kw):
    j, p = jcb.EarlyStopping(**kw), pcb.EarlyStopping(**kw)
    for logs in EVAL_LOGS:
        j.on_eval_end(dict(logs))
        p.on_eval_end(dict(logs))
        assert (p.best, p.wait, p.stop_training, p.mode) == \
            (j.best, j.wait, j.stop_training, j.mode)
    with pytest.warns(UserWarning, match="non-scalar"):
        pcb.EarlyStopping().on_eval_end({"loss": "n/a"})


def test_lr_scheduler_callback_steps_as_jax():
    for by_step, by_epoch in ((False, True), (True, False), (True, True)):
        scheds = {"jax": jlr.StepDecay(0.1, step_size=2, gamma=0.5),
                  "port": plr.StepDecay(0.1, step_size=2, gamma=0.5)}
        seen = {k: [] for k in scheds}
        for k, s in scheds.items():
            cb = (jcb if k == "jax" else pcb).LRSchedulerCallback(
                by_step=by_step, by_epoch=by_epoch)
            cb.set_model(types.SimpleNamespace(
                _optimizer=types.SimpleNamespace(_lr=s)))
            for epoch in range(3):
                for step in range(3):
                    cb.on_train_batch_end(step, {})
                    seen[k].append(s())
                cb.on_epoch_end(epoch, {})
                seen[k].append(s())
        assert seen["port"] == seen["jax"]
    cb = pcb.LRSchedulerCallback()
    cb.set_model(types.SimpleNamespace(
        _optimizer=types.SimpleNamespace(_lr=0.1)))
    cb.on_epoch_end(0)                          # a float LR: nothing to step


def test_visualdl_writes_jax_s_scalars_file(tmp_path):
    for pkg, d in ((jcb, tmp_path / "jax"), (pcb, tmp_path / "port")):
        cb = pkg.VisualDL(log_dir=str(d), log_freq=2)
        for step in range(5):
            cb.on_train_batch_end(step, {"loss": 1.0 / (step + 1),
                                         "acc": np.float32(0.1 * step),
                                         "skip": "text"})
        cb.on_eval_end({"loss": 0.5, "acc": np.asarray([0.25])})
        cb.on_train_end()
        cb.on_eval_end({"loss": 0.4})             # reopens after close
        cb.on_train_end()
    got = (tmp_path / "port" / "scalars.jsonl").read_text()
    assert got == (tmp_path / "jax" / "scalars.jsonl").read_text()
    rows = [json.loads(x) for x in got.splitlines()]
    assert [r["tag"] for r in rows[:2]] == ["train/loss", "train/acc"]
    assert rows[-1] == {"tag": "eval/loss", "step": 2, "value": 0.4}


# --------------------------------------------------------------------------- #
# summary
# --------------------------------------------------------------------------- #

def _jax_concrete(name, **kw):
    """A JAX zoo model built under eval_shape, then given concrete
    zero-free numpy state (summary only reads shapes)."""
    box = {}

    def build():
        box["m"] = getattr(jmodels, name)(**kw)
        return box["m"].raw_parameters(), box["m"].raw_buffers()

    params, buffers = jax.eval_shape(build)
    m = box["m"]
    m.load_raw_parameters({k: jnp.ones(v.shape, v.dtype)
                           for k, v in params.items()})
    m.load_raw_buffers({k: jnp.ones(v.shape, v.dtype)
                        for k, v in buffers.items()})
    return m


@pytest.mark.parametrize("name,kw,size", [
    ("LeNet", {}, (1, 1, 28, 28)),
    ("mobilenet_v2", {"scale": 0.5}, (None, 3, 64, 64))])
def test_summary_rows_and_totals_are_jax_s(name, kw, size, capsys):
    want = jax_summary(_jax_concrete(name, num_classes=10, **kw), size)
    want_text = capsys.readouterr().out
    m = getattr(models, name)(num_classes=10, device="cpu", **kw)
    got = P.summary(m, size)
    assert capsys.readouterr().out == want_text
    assert got == want
    assert got["total_params"] == sum(p.numel() for p in m.parameters())
    m.train()
    x = torch.zeros(tuple(1 if s is None else s for s in size))
    assert hapi.summary(m, input=x) == got and m.training
    capsys.readouterr()
    assert hapi.Model(m, inputs=[hapi.InputSpec(size, "float32")]) \
        .summary() == got
    assert hapi.InputSpec is P.static.InputSpec
    with pytest.raises(ValueError, match="input_size"):
        P.summary(m)
