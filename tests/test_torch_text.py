"""`paddle_tpu_torch.text` against `paddle_tpu.text`, and BERT through
`hapi.Model.fit` over padded text batches against the JAX package's.

- Every dataset's synthetic fallback (`UCIHousing`, `Imdb`,
  `Imikolov` NGRAM and SEQ, `Movielens`, `Conll05st`, `WMT14`, `WMT16`
  both ways) gives JAX's samples bit for bit, train and test, with the
  same vocabularies; without the fallback a missing file raises.
- Each real format, written small into a temporary directory (the
  housing text table, the IMDB tar of review files, a `ratings.dat`,
  CoNLL columns, a WMT tar of `.src` / `.trg` lines, a PTB tar), parses
  to JAX's samples.
- A tiny BERT (vocab 1000, hidden 64, 2 layers, dropout 0) fitted by
  `hapi.Model(net, inputs=[ids, token types, mask])` for one epoch over
  64 synthetic IMDB reviews through a `DataLoader` whose `collate_fn`
  pads them to 64 tokens and builds the attention mask (4 batches of
  16, no shuffle), AdamW(1e-3), cross-entropy and accuracy, fp32, in
  both packages from the same weights: the epoch's loss within 1e-4
  relative, the accuracy within one review, every trained parameter
  within 1e-3 of its largest magnitude; `predict` on the padded
  batches within 1e-4.
"""
import io
import os
import tarfile

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import hapi as jhapi
from paddle_tpu import io as jio
from paddle_tpu import metric as jmetric
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import text as jtext
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import hapi, metric, nn
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import text as ptext
from paddle_tpu_torch.models import bert as pbert
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.optimizer import AdamW
from port_resnet import numpy_tree
from port_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def synthetic():
    jtext.set_synthetic_fallback(True)
    ptext.set_synthetic_fallback(True)
    yield
    from paddle_tpu.vision import datasets as jds
    from paddle_tpu_torch.vision import datasets as pds
    jds._SYNTHETIC = None
    pds._SYNTHETIC = None


def _same(a, b):
    """Samples equal, leaf by leaf, with equal dtypes."""
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_dataset(p, j):
    assert len(p) == len(j) > 0
    for i in range(len(j)):
        _same(p[i], j[i])


SYNTHETIC = [("UCIHousing", {}), ("Imdb", {}),
             ("Imikolov", {"data_type": "NGRAM"}),
             ("Imikolov", {"data_type": "SEQ", "window_size": 3}),
             ("Movielens", {}), ("Conll05st", {}), ("WMT14", {}),
             ("WMT16", {}), ("WMT16", {"src_lang": "de", "trg_lang": "en"})]


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("name,kw", SYNTHETIC,
                         ids=[f"{n}{k}" for n, k in SYNTHETIC])
def test_synthetic_equals_jax(name, kw, mode):
    p = getattr(ptext, name)(mode=mode, **kw)
    j = getattr(jtext, name)(mode=mode, **kw)
    _same_dataset(p, j)
    for attr in ("word_idx", "label_idx"):
        assert getattr(p, attr, None) == getattr(j, attr, None)


def test_missing_file_raises_without_fallback(tmp_path):
    ptext.set_synthetic_fallback(False)
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        ptext.Imdb(data_file=str(tmp_path / "absent.tar.gz"))


def _tar(path, members):
    with tarfile.open(path, "w:gz") as tf:
        for name, text in members.items():
            data = text.encode()
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return str(path)


def _files(tmp_path):
    rs = np.random.RandomState(4)
    housing = tmp_path / "housing.data"
    np.savetxt(housing, rs.rand(25, 14) * 10)
    words = ["good", "bad", "film", "plot", "great", "awful", "it", "was"]

    def review(k):
        return " ".join(words[(k * 3 + i) % 8] for i in range(5 + k % 4)) \
            + "!"

    imdb = _tar(tmp_path / "imdb.tar.gz", {
        f"aclImdb/{mode}/{lab}/{k}.txt": review(k + 7 * (lab == "neg"))
        for mode in ("train", "test") for lab in ("pos", "neg")
        for k in range(3)})
    ratings = tmp_path / "ratings.dat"
    ratings.write_text("".join(f"{u}::{m}::{(u + m) % 5 + 1}::97800\n"
                               for u in range(1, 6) for m in range(1, 5)))
    conll = tmp_path / "conll.txt"
    conll.write_text("The 0 B-A0\ncat 0 I-A0\nsat 1 B-V\n\n"
                     "A 0 B-A1\ndog 1 B-V\n")
    wmt = _tar(tmp_path / "wmt.tar.gz", {
        "wmt/train.src": "a b c\nd e\nf\n", "wmt/train.trg": "x y\nz\nw v u\n",
        "wmt/test.src": "a\n", "wmt/test.trg": "b\n"})
    ptb = _tar(tmp_path / "ptb.tar.gz", {
        "ptb/ptb.train.txt": "the cat sat on the mat\nthe dog sat\n",
        "ptb/ptb.valid.txt": "the cat ran\n"})
    return {"UCIHousing": dict(data_file=str(housing)),
            "Imdb": dict(data_file=imdb, cutoff=1),
            "Movielens": dict(data_file=str(ratings)),
            "Conll05st": dict(data_file=str(conll)),
            "WMT14": dict(data_file=wmt),
            "Imikolov": dict(data_file=ptb, min_word_freq=1)}


@pytest.mark.parametrize("name", ["UCIHousing", "Imdb", "Movielens",
                                  "Conll05st", "WMT14", "Imikolov"])
def test_real_formats_equal_jax(tmp_path, name):
    ptext.set_synthetic_fallback(False)
    jtext.set_synthetic_fallback(False)
    kw = _files(tmp_path)[name]
    assert os.path.exists(kw["data_file"])
    for mode in ("train", "test"):
        _same_dataset(getattr(ptext, name)(mode=mode, **kw),
                      getattr(jtext, name)(mode=mode, **kw))


PAD = 64
CFG = dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2,
           intermediate_size=128, max_position_embeddings=64,
           hidden_dropout=0.0, attention_dropout=0.0)


def pad_collate(batch):
    """(ids, token types, mask, labels): each review zero-padded to
    PAD tokens, the mask 1 over its tokens."""
    n = len(batch)
    ids = np.zeros((n, PAD), np.int64)
    mask = np.zeros((n, PAD), np.int64)
    for i, (doc, _) in enumerate(batch):
        ids[i, :len(doc)] = doc[:PAD]
        mask[i, :len(doc)] = 1
    labels = np.asarray([lab for _, lab in batch], np.int64)
    return ids, np.zeros_like(ids), mask, labels


@pytest.fixture(scope="module")
def fits():
    jtext.set_synthetic_fallback(True)
    ptext.set_synthetic_fallback(True)
    pt.seed(0)
    jnet = jbert.BertForSequenceClassification(jbert.BertConfig(**CFG), 2)
    params = numpy_tree(jnet.raw_parameters())
    names = ["input_ids", "token_type_ids", "attention_mask"]
    out = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            data = jio.Subset(jtext.Imdb(mode="train"), range(64))
            m = jhapi.Model(jnet, inputs=names, labels=["label"])
            m.prepare(jopt.AdamW(1e-3), jnn.CrossEntropyLoss(),
                      jmetric.Accuracy())
            loader = jio.DataLoader(data, batch_size=16,
                                    collate_fn=pad_collate)
        else:
            data = pio.Subset(ptext.Imdb(mode="train"), range(64))
            net = load_jax_state(pbert.BertForSequenceClassification(
                pbert.BertConfig(**CFG), 2, device="cpu"), params)
            m = hapi.Model(net, inputs=names, labels=["label"])
            m.prepare(AdamW(1e-3), nn.CrossEntropyLoss(), metric.Accuracy())
            loader = pio.DataLoader(data, batch_size=16,
                                    collate_fn=pad_collate)
        hist = m.fit(loader, epochs=1, verbose=0)
        out[pkg] = {"model": m, "hist": hist, "batches": list(loader)}
    return out


def test_fit_padded_text_matches_jax(fits):
    j, p = fits["jax"], fits["port"]
    assert len(p["batches"]) == 4
    assert p["model"]._trainer.num_inputs == 3
    assert set(p["hist"]) == set(j["hist"]) == {"loss", "acc", "ips"}
    np.testing.assert_allclose(p["hist"]["loss"], j["hist"]["loss"],
                               rtol=1e-4)
    assert abs(p["hist"]["acc"][0] - j["hist"]["acc"][0]) <= 1 / 64 + 1e-9
    jst = j["model"]._trainer.state
    pst = p["model"]._trainer.state
    for k, v in jst.params.items():
        v = np.asarray(v)
        np.testing.assert_allclose(pst.params[k].detach().numpy(), v,
                                   rtol=0, atol=1e-3 * np.abs(v).max(),
                                   err_msg=k)


def test_predict_padded_batches(fits):
    j, p = fits["jax"], fits["port"]
    ids, tt, mask, _ = p["batches"][1]
    want = j["model"].predict_batch([ids, tt, mask])
    got = p["model"].predict_batch([ids, tt, mask])
    got = got[0] if isinstance(got, list) else got
    want = want[0] if isinstance(want, list) else want
    assert got.shape == (16, 2)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
