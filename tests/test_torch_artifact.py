"""The serving artifact of the port (`serving.save_for_serving`,
`load_model`, `load_engine`) against the JAX package's.

- A JAX `save_for_serving` of an fp and of a PTQ `gpt_tiny` loads with
  the port's `load_engine(..., device="cpu")` (the weights through the
  JAX-to-torch bridge, the PTQ buffers rebuilt as `Int8Linear`s), and
  its greedy streams equal the JAX `load_engine`'s where the
  reference's top-2 margin is above 1e-3.
- A port save, then a port load, is bitwise (every tensor, bf16
  included, and the streams); the JAX package loads the port's pair.
- `load_engine(snapshot=...)` resumes a snapshot.
- A missing artifact raises `FileNotFoundError`; `PTPU_FORBID_PICKLE=1`
  refuses the load; the reader refuses a pickle that names anything but
  arrays; without a card the default device raises.
"""
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.quantization import PTQ as JaxPTQ
from paddle_tpu.quantization import QuantConfig as JaxQuantConfig
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu.serving import load_engine as jax_load_engine
from paddle_tpu.serving import save_for_serving as jax_save
from paddle_tpu_torch.framework import io as pio
from paddle_tpu_torch.models import gpt_tiny
from paddle_tpu_torch.quantization import PTQ, Int8Linear
from paddle_tpu_torch.serving import (LLMEngine, SamplingParams,
                                      load_engine, load_model,
                                      save_for_serving)

from port_threads import one_torch_thread  # noqa: F401 — autouse fixture

ENGINE = dict(max_slots=2, max_seq=64, seed=12, prefix_cache=False)


@pytest.fixture(scope="module")
def jax_model():
    pt.seed(0)
    m = jax_gpt_tiny()
    m.eval()
    return m


@pytest.fixture(scope="module")
def jax_int8():
    pt.seed(0)
    m = jax_gpt_tiny()
    m.eval()
    rng = np.random.RandomState(0)
    ptq = JaxPTQ(JaxQuantConfig(), algo="abs_max")
    ptq.quantize(m)
    ptq.sample(m, [jnp.asarray(rng.randint(0, 1024, (1, 32))
                               .astype(np.int32)) for _ in range(2)])
    ptq.convert(m)
    return m


def _prompts(lengths, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1024, (n,)).astype(np.int32) for n in lengths]


def _margin(jax_model, prompts, streams) -> float:
    """The reference's smallest top-2 logit margin over the positions
    that decided its streams (a full forward of the JAX model)."""
    out = []
    for p, toks in zip(prompts, streams):
        seq = np.concatenate([p, np.asarray(toks[:-1], np.int32)])
        lg = np.asarray(jax_model(jnp.asarray(seq[None])))[0, p.size - 1:]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        out.append(float((top2[:, 1] - top2[:, 0]).min()))
    return min(out)


@pytest.mark.parametrize("kind", ["fp", "ptq"])
def test_jax_artifact_serves_jax_streams(jax_model, jax_int8, kind,
                                         tmp_path):
    jm = jax_model if kind == "fp" else jax_int8
    prefix = str(tmp_path / kind / "gpt")
    jax_save(jm, prefix)
    prompts = _prompts((6, 10, 13), seed=11)
    jeng = jax_load_engine(prefix, register_stats=False, **ENGINE)
    want = [r.token_ids for r in jeng.generate(
        prompts, JaxParams(max_new_tokens=6))]
    margin = _margin(jm, prompts, want)
    print(f"smallest reference top-2 margin: {margin:.4g}")
    assert margin > 1e-3, f"near-tie in the reference: {margin}"
    eng = load_engine(prefix, device="cpu", **ENGINE)
    quant = sum(isinstance(m, Int8Linear) for m in eng.model.modules())
    assert quant == (16 if kind == "ptq" else 0)
    got = eng.generate(prompts, SamplingParams(max_new_tokens=6))
    assert [r.token_ids for r in got] == want
    if kind == "ptq":
        for k, v in eng.model.raw_buffers().items():
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(jm.raw_buffers()[k]), err_msg=k)


@pytest.mark.parametrize("kind", ["fp32", "bf16", "ptq"])
def test_port_save_then_load_is_bitwise(kind, tmp_path):
    m = gpt_tiny(seed=3, device="cpu",
                 dtype="bf16" if kind == "bf16" else None)
    if kind == "ptq":
        ptq = PTQ()
        ptq.quantize(m)
        ptq.sample(m, [np.random.RandomState(1).randint(0, 1024, (2, 32))])
        ptq.convert(m)
    prefix = save_for_serving(m, str(tmp_path / "a" / "gpt"))
    back = load_model(prefix, device="cpu")
    want, got = m.state_dict(), back.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    prompts = _prompts((7, 12), seed=2)
    sp = SamplingParams(max_new_tokens=8, temperature=0.8, top_k=20)
    a = LLMEngine(m, device="cpu", **ENGINE).generate(prompts, sp)
    b = load_engine(prefix, device="cpu", **ENGINE).generate(prompts, sp)
    assert [r.token_ids for r in a] == [r.token_ids for r in b]


def test_jax_loads_the_ports_artifact(jax_model, tmp_path):
    from paddle_tpu_torch.models import load_jax_params
    m = load_jax_params(gpt_tiny(device="cpu"), {
        k: np.asarray(v) for k, v in jax_model.raw_parameters().items()})
    prefix = save_for_serving(m, str(tmp_path / "gpt"))
    jeng = jax_load_engine(prefix, register_stats=False, **ENGINE)
    for k, v in jeng.model.raw_parameters().items():
        np.testing.assert_array_equal(np.asarray(v),
                                      m.raw_parameters()[k].numpy(), k)


def test_load_engine_resumes_a_snapshot(tmp_path):
    m = gpt_tiny(seed=4, device="cpu")
    prefix = save_for_serving(m, str(tmp_path / "gpt"))
    prompts = _prompts((9, 14), seed=6)
    sp = SamplingParams(max_new_tokens=12, temperature=0.7)
    want = [r.token_ids for r in LLMEngine(m, device="cpu", **ENGINE)
            .generate(prompts, sp)]
    eng = LLMEngine(m, device="cpu", **ENGINE)
    rids = [eng.submit(p, sp) for p in prompts]
    eng.step()
    snap = pickle.loads(pickle.dumps(eng.snapshot()))
    eng2 = load_engine(prefix, snapshot=snap)
    assert eng2.device.type == "cpu"        # the snapshot's device
    while eng2.has_work():
        eng2.step()
    assert [eng2.result(r).token_ids for r in rids] == want


def test_missing_forbidden_and_foreign(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError, match="llm.json"):
        load_model(str(tmp_path / "nope"), device="cpu")
    prefix = save_for_serving(gpt_tiny(device="cpu"), str(tmp_path / "g"))
    monkeypatch.setenv("PTPU_FORBID_PICKLE", "1")
    with pytest.raises(RuntimeError, match="PTPU_FORBID_PICKLE"):
        load_engine(prefix, device="cpu")
    monkeypatch.delenv("PTPU_FORBID_PICKLE")
    with open(str(tmp_path / "evil"), "wb") as f:
        pickle.dump({"w": os.getcwd}, f)
    with pytest.raises(pickle.UnpicklingError, match="not part of"):
        pio.load(str(tmp_path / "evil"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        load_engine(prefix)
