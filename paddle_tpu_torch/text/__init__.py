"""Text datasets: `UCIHousing`, `Imdb`, `Imikolov`, `Movielens`,
`Conll05st`, `WMT14` and `WMT16`, the counterparts of
`paddle_tpu/text/__init__.py` (the reference's
`python/paddle/text/datasets/`).

The real file formats are parsed from paths that exist; nothing is
downloaded. Without a file, the synthetic fallback (the switch shared
with `vision.datasets`: `set_synthetic_fallback(True)` or
`PTPU_SYNTHETIC_DATA=1`) gives the JAX package's seeded, learnable
samples bit for bit (numpy's `RandomState` with the same seeds and
draws: `Imdb` seed 8, 16-63 tokens of a 512-token vocabulary, the
label shifting the tokens by 256); without it a missing file raises
`FileNotFoundError`. Samples are numpy arrays, as in JAX.
"""
from __future__ import annotations

import os
import re
import tarfile
from typing import List, Optional

import numpy as np

from ..io import Dataset
from ..vision.datasets import _missing, synthetic_enabled  # noqa: F401
from ..vision.datasets import set_synthetic_fallback  # noqa: F401

__all__ = ["UCIHousing", "Imdb", "Imikolov", "Movielens", "Conll05st",
           "WMT14", "WMT16", "set_synthetic_fallback"]


class UCIHousing(Dataset):
    """13 float features → house price (reference uci_housing.py).
    Features are globally normalized like the reference's preprocessing."""

    FEATURES = 13

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 download: bool = True):
        assert mode in ("train", "test")
        self.mode = mode
        if data_file and os.path.exists(data_file):
            raw = np.loadtxt(data_file).astype(np.float32)
        else:
            _missing("UCIHousing", data_file)
            rng = np.random.RandomState(7)
            feats = rng.randn(506, self.FEATURES).astype(np.float32)
            w = rng.randn(self.FEATURES).astype(np.float32)
            price = feats @ w + 0.1 * rng.randn(506).astype(np.float32) + 22
            raw = np.concatenate([feats, price[:, None]], axis=1)
        mean, std = raw.mean(0), raw.std(0)
        std[-1] = 1.0
        mean[-1] = 0.0
        raw = (raw - mean) / np.where(std == 0, 1.0, std)
        split = int(len(raw) * 0.8)
        part = raw[:split] if mode == "train" else raw[split:]
        self.data = part[:, :-1]
        self.label = part[:, -1:]

    def __getitem__(self, idx):
        return self.data[idx], self.label[idx]

    def __len__(self):
        return len(self.data)


_TOKEN_RE = re.compile(r"[A-Za-z]+|[!?.]")


def _load_dict(d):
    """None | {token: id} | path-to-one-token-per-line file → dict.
    Ids are contiguous over non-blank lines (blank lines don't leave
    gaps — consumers size embedding tables by len())."""
    if d is None or isinstance(d, dict):
        return d
    with open(d) as f:
        tokens = [line.strip() for line in f if line.strip()]
    return {tok: i for i, tok in enumerate(tokens)}


class Imdb(Dataset):
    """IMDB sentiment: token-id sequences + 0/1 label (reference imdb.py:
    tar of pos/neg review files, vocab by frequency with cutoff 150)."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 cutoff: int = 150, download: bool = True):
        assert mode in ("train", "test")
        self.mode = mode
        if data_file and os.path.exists(data_file):
            self.word_idx = self._build_vocab(data_file, cutoff)
            self.docs, self.labels = self._load(data_file, mode)
        else:
            _missing("Imdb", data_file)
            vocab_size, n = 512, 512 if mode == "train" else 128
            self.word_idx = {f"w{i}": i for i in range(vocab_size)}
            rng = np.random.RandomState(8)
            self.labels = rng.randint(0, 2, (n,)).astype(np.int64)
            # label-dependent token bias so classifiers can learn
            self.docs = []
            for i in range(n):
                ln = rng.randint(16, 64)
                offset = (vocab_size // 2) * self.labels[i]
                self.docs.append((rng.randint(0, vocab_size // 2, (ln,))
                                  + offset).astype(np.int64))

    def _pattern(self, mode):
        return re.compile(rf"aclImdb/{mode}/(pos|neg)/.*\.txt$")

    def _tokenize(self, text: str) -> List[str]:
        return _TOKEN_RE.findall(text.lower())

    def _build_vocab(self, path, cutoff):
        from collections import Counter
        freq = Counter()
        pat = self._pattern("train")
        with tarfile.open(path, "r:*") as tf:
            for m in tf.getmembers():
                if m.isfile() and pat.match(m.name):
                    freq.update(self._tokenize(
                        tf.extractfile(m).read().decode("utf-8", "ignore")))
        words = [w for w, c in freq.items() if c >= cutoff]
        words.sort(key=lambda w: (-freq[w], w))
        idx = {w: i for i, w in enumerate(words)}
        idx["<unk>"] = len(idx)
        return idx

    def _load(self, path, mode):
        docs, labels = [], []
        unk = self.word_idx["<unk>"]
        pat = self._pattern(mode)
        with tarfile.open(path, "r:*") as tf:
            for m in tf.getmembers():
                if m.isfile() and pat.match(m.name):
                    toks = self._tokenize(
                        tf.extractfile(m).read().decode("utf-8", "ignore"))
                    docs.append(np.asarray(
                        [self.word_idx.get(t, unk) for t in toks],
                        dtype=np.int64))
                    labels.append(0 if "/pos/" in m.name else 1)
        return docs, np.asarray(labels, dtype=np.int64)

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.docs)


class Movielens(Dataset):
    """ML-1M ratings (reference movielens.py): (user feats, movie id,
    rating). Real format: `ratings.dat` lines `uid::mid::rating::ts`
    inside the archive; synthetic fallback generates a low-rank
    user×item preference structure (learnable by an MF model)."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 download: bool = True):
        assert mode in ("train", "test")
        self.mode = mode
        if data_file and os.path.exists(data_file):
            rows = self._read(data_file)
        else:
            _missing("Movielens", data_file)
            rng = np.random.RandomState(11)
            n_u, n_m, n = 64, 128, 2048
            u_vec = rng.randn(n_u, 4)
            m_vec = rng.randn(n_m, 4)
            uid = rng.randint(0, n_u, (n,))
            mid = rng.randint(0, n_m, (n,))
            score = (u_vec[uid] * m_vec[mid]).sum(1)
            rating = np.clip(np.round(3 + score), 1, 5)
            rows = np.stack([uid, mid, rating], 1).astype(np.int64)
        split = int(len(rows) * 0.9)
        self.rows = rows[:split] if mode == "train" else rows[split:]

    def _read(self, path):
        rows = []
        if path.endswith((".tar", ".tgz", ".tar.gz")):
            with tarfile.open(path, "r:*") as tf:
                for m in tf.getmembers():
                    if m.name.endswith("ratings.dat"):
                        text = tf.extractfile(m).read().decode()
                        break
                else:
                    raise ValueError(f"no ratings.dat in {path}")
        else:
            with open(path) as f:
                text = f.read()
        for ln, line in enumerate(text.strip().split("\n"), 1):
            if not line.strip():
                continue
            parts = line.split("::")
            if len(parts) != 4:
                raise ValueError(
                    f"{path}:{ln}: expected 'uid::mid::rating::ts', "
                    f"got {line[:60]!r}")
            u, mv, r, _ = parts
            rows.append((int(u), int(mv), int(float(r))))
        if not rows:
            raise ValueError(f"{path}: no rating rows found")
        return np.asarray(rows, np.int64)

    def __getitem__(self, idx):
        u, m, r = self.rows[idx]
        return (np.int64(u), np.int64(m),
                np.asarray([float(r)], np.float32))

    def __len__(self):
        return len(self.rows)


class Conll05st(Dataset):
    """CoNLL-2005 SRL (reference conll05.py): token ids + predicate
    marker + BIO label ids. Real input: whitespace column files (token,
    predicate-flag, label); synthetic fallback emits consistent
    tag-per-token-class sequences.

    Pass `word_dict`/`label_dict` ({token: id} or a one-token-per-line
    file path, the reference's dict files) so train and test instances
    share one vocabulary — without them each instance builds ids in
    file-encounter order and models trained on one file cannot score
    another."""

    N_LABELS = 9

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 word_dict=None, label_dict=None, download: bool = True):
        assert mode in ("train", "test")
        if data_file and os.path.exists(data_file):
            self.samples, self.word_idx, self.label_idx = \
                self._read(data_file, _load_dict(word_dict),
                           _load_dict(label_dict))
        else:
            _missing("Conll05st", data_file)
            vocab = 200
            self.word_idx = {f"w{i}": i for i in range(vocab)}
            self.label_idx = {f"L{i}": i for i in range(self.N_LABELS)}
            rng = np.random.RandomState(12 if mode == "train" else 13)
            self.samples = []
            for _ in range(256 if mode == "train" else 64):
                ln = rng.randint(5, 30)
                toks = rng.randint(0, vocab, (ln,)).astype(np.int64)
                pred = np.zeros((ln,), np.int64)
                pred[rng.randint(0, ln)] = 1
                labels = (toks % self.N_LABELS).astype(np.int64)
                self.samples.append((toks, pred, labels))

    def _read(self, path, word_idx=None, label_idx=None):
        word_idx = dict(word_idx) if word_idx else {}
        label_idx = dict(label_idx) if label_idx else {}
        samples = []
        sent: list = []

        def next_id(idx):
            # collision-proof for non-contiguous provided dicts:
            # len() could alias an existing id, max()+1 cannot
            return max(idx.values(), default=-1) + 1

        def flush():
            if not sent:
                return
            toks = np.asarray([word_idx.setdefault(w, next_id(word_idx))
                               for w, _, _ in sent], np.int64)
            pred = np.asarray([int(p) for _, p, _ in sent], np.int64)
            labels = np.asarray(
                [label_idx.setdefault(l, next_id(label_idx))
                 for _, _, l in sent], np.int64)
            samples.append((toks, pred, labels))
            sent.clear()

        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    flush()
                    continue
                parts = line.split()
                if len(parts) >= 3:
                    sent.append((parts[0], parts[1], parts[2]))
        flush()  # files without a trailing blank line keep their last sentence
        return samples, word_idx, label_idx

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)


class _WMTBase(Dataset):
    """Translation pairs → (src_ids, trg_ids[:-1], trg_ids[1:]) (the
    reference's trainer format). Real input: tarball with parallel
    `*.src`/`*.trg` line files; synthetic fallback is a copy task with
    vocabulary remapping (learnable by a seq2seq model)."""

    BOS, EOS, UNK = 0, 1, 2

    def __init__(self, data_file, mode, seed, dict_size=256):
        assert mode in ("train", "test", "val")
        self.dict_size = dict_size
        if data_file and os.path.exists(data_file):
            self.pairs = self._read(data_file, mode)
        else:
            _missing(type(self).__name__, data_file)
            # per-mode seed offset: the synthetic test split must not be
            # a subset of train (data leakage)
            offset = {"train": 0, "val": 1, "test": 2}[mode]
            rng = np.random.RandomState(seed * 101 + offset)
            self.pairs = []
            for _ in range(256 if mode == "train" else 64):
                ln = rng.randint(4, 20)
                src = rng.randint(3, dict_size, (ln,)).astype(np.int64)
                trg = (src + 7 - 3) % (dict_size - 3) + 3  # remap task
                self.pairs.append((src, trg))

    def _encode(self, line: str) -> np.ndarray:
        # stable across processes (python's hash() is salted): crc32
        import zlib
        return np.asarray(
            [zlib.crc32(w.encode()) % (self.dict_size - 3) + 3
             for w in line.split()], np.int64)

    def _read(self, path, mode):
        srcs, trgs = None, None
        with tarfile.open(path, "r:*") as tf:
            for m in tf.getmembers():
                if mode in m.name and m.name.endswith(".src"):
                    srcs = tf.extractfile(m).read().decode().split("\n")
                if mode in m.name and m.name.endswith((".trg", ".tgt")):
                    trgs = tf.extractfile(m).read().decode().split("\n")
        if srcs is None or trgs is None:
            raise ValueError(f"no {mode} .src/.trg pair in {path}")
        while srcs and not srcs[-1].strip():
            srcs.pop()
        while trgs and not trgs[-1].strip():
            trgs.pop()
        if len(srcs) != len(trgs):
            raise ValueError(
                f"misaligned parallel corpus in {path}: {len(srcs)} src "
                f"vs {len(trgs)} trg lines")
        pairs = []
        for s, t in zip(srcs, trgs):
            if not s.strip() or not t.strip():
                continue  # skip the pair together — never an empty target
            pairs.append((self._encode(s), self._encode(t)))
        return pairs

    def __getitem__(self, idx):
        src, trg = self.pairs[idx]
        full = np.concatenate([[self.BOS], trg, [self.EOS]])
        return src, full[:-1].astype(np.int64), full[1:].astype(np.int64)

    def __len__(self):
        return len(self.pairs)


class WMT14(_WMTBase):
    def __init__(self, data_file=None, mode="train", dict_size=256,
                 download=True):
        super().__init__(data_file, mode, seed=14, dict_size=dict_size)


class WMT16(_WMTBase):
    def __init__(self, data_file=None, mode="train", dict_size=256,
                 download=True, src_lang="en", trg_lang="de"):
        if (src_lang, trg_lang) not in (("en", "de"), ("de", "en")):
            raise ValueError(f"unsupported pair {src_lang}->{trg_lang} "
                             "(en<->de only)")
        self.reverse = src_lang == "de"
        super().__init__(data_file, mode, seed=16, dict_size=dict_size)
        if self.reverse:
            self.pairs = [(t, s) for s, t in self.pairs]


class Imikolov(Dataset):
    """PTB-style n-gram LM windows (reference imikolov.py)."""

    def __init__(self, data_file: Optional[str] = None,
                 data_type: str = "NGRAM", window_size: int = 5,
                 mode: str = "train",
                 min_word_freq: int = 50, download: bool = True):
        assert data_type in ("NGRAM", "SEQ")
        assert mode in ("train", "test")
        self.data_type = data_type
        self.window_size = window_size
        if data_file and os.path.exists(data_file):
            lines = self._read_lines(data_file, mode)
            self.word_idx = self._build_vocab(lines, min_word_freq)
        else:
            _missing("Imikolov", data_file)
            vocab = 256
            self.word_idx = {f"w{i}": i for i in range(vocab)}
            self.word_idx.update({"<s>": vocab, "<e>": vocab + 1,
                                  "<unk>": vocab + 2})
            rng = np.random.RandomState(9 if mode == "train" else 10)
            # markov-ish chains: next token correlated with previous
            lines = []
            for _ in range(256 if mode == "train" else 64):
                ln = rng.randint(window_size, 24)
                start = rng.randint(0, vocab)
                seq = [(start + j * 7) % vocab for j in range(ln)]
                lines.append([f"w{t}" for t in seq])
        self.samples = self._windows(lines)

    def _read_lines(self, path, mode):
        name = "ptb.train.txt" if mode == "train" else "ptb.valid.txt"
        with tarfile.open(path, "r:*") as tf:
            for m in tf.getmembers():
                if m.name.endswith(name):
                    text = tf.extractfile(m).read().decode("utf-8")
                    return [l.split() for l in text.strip().split("\n")]
        raise ValueError(f"{name} not in {path}")

    def _build_vocab(self, lines, min_freq):
        from collections import Counter
        freq = Counter(w for l in lines for w in l)
        words = [w for w, c in freq.items() if c >= min_freq and w != "<unk>"]
        words.sort(key=lambda w: (-freq[w], w))
        idx = {w: i for i, w in enumerate(words)}
        for tok in ("<s>", "<e>", "<unk>"):
            idx.setdefault(tok, len(idx))
        return idx

    def _windows(self, lines):
        unk = self.word_idx["<unk>"]
        s, e = self.word_idx["<s>"], self.word_idx["<e>"]
        out = []
        for l in lines:
            ids = [s] + [self.word_idx.get(w, unk) for w in l] + [e]
            if self.data_type == "NGRAM":
                if len(ids) >= self.window_size:
                    for i in range(len(ids) - self.window_size + 1):
                        out.append(np.asarray(ids[i:i + self.window_size],
                                              dtype=np.int64))
            else:
                out.append((np.asarray(ids[:-1], dtype=np.int64),
                            np.asarray(ids[1:], dtype=np.int64)))
        return out

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)
