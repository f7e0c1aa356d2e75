"""TP-sharded serving in the port (`paddle_tpu_torch/serving/sharded_kv.py`,
`nn/tp.py`, the TP wiring of `models/gpt.py`) against the JAX engine,
class by class after tests/test_tp_serving.py, on gpt_tiny on the CPU.

A TP group here is `tp` ranks of one process on one device; each rank
holds its weight shards and its heads' KV slabs, and ranks meet only in
`all_reduce` / `all_gather`. The bars:
- greedy streams: port tp=2 ≡ port tp=1 ≡ JAX tp=1 ≡ JAX tp=2 (the JAX
  tp=2 engine runs on the 8 virtual CPU devices of tests/conftest.py),
  both KV layouts, prefix cache on and off, on prompts whose tp=1 top-2
  margin exceeds 1e-3 at every step; sampled lanes port tp=2 ≡ tp=1
  (the port samples by its own keys, equal to JAX's in law only);
- across degrees the logits are not bitwise (a row-parallel partial sum
  rounds apart from one GEMM): within 1e-4 (fp32) here;
- inside one degree the engine's invariants stay bitwise: speculation on
  ≡ off, paged ≡ slotted, snapshot / resume;
- the collectives: 0 at tp=1, `2 L + 2` per forward (a decode step or a
  prefill call) at tp=2 with fp weights, `L + 2` with int8-PTQ linears
  (replicated, as the reference leaves them out of its specs);
- the sharded plain attention per head shard equals JAX's unsharded
  Pallas kernels in interpret mode (atol = rtol = 1e-5, fp32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.ops_pallas.decode_attention import (
    paged_ragged_decode_attention as jax_paged,
    ragged_decode_attention as jax_ragged)
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu_torch.models import gpt_tiny, load_jax_params
from paddle_tpu_torch.models.gpt import (_body_layers, _decode_forward,
                                         _ln, tp_collectives_per_step,
                                         tp_param_specs)
from paddle_tpu_torch.nn.tp import ShardedParams
from paddle_tpu_torch.ops_cuda import decode_attention as dec
from paddle_tpu_torch.quantization.kv import HeadShards
from paddle_tpu_torch.serving import (KVCacheManager, KVManager, LLMEngine,
                                      PagedKVCache, SamplingParams,
                                      ShardedKVCacheManager,
                                      ShardedPagedKVCache, make_kv_manager,
                                      make_tp_mesh)
from paddle_tpu_torch.serving.sharded_kv import (mesh_fingerprint,
                                                 shard_serving_params)
from port_threads import one_torch_thread  # noqa: F401

CFG = dict(max_slots=3, max_seq=64, seed=7, register_stats=False)
KV_KW = dict(num_layers=2, max_slots=2, max_seq=64, num_heads=4,
             head_dim=8, device="cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
MARGIN = 1e-3        # the tp=1 top-2 margin every greedy step must exceed


@pytest.fixture(scope="module")
def jax_model():
    pt.seed(0)
    m = jax_gpt_tiny()
    m.eval()
    return m


@pytest.fixture(scope="module")
def model(jax_model):
    return load_jax_params(gpt_tiny(device="cpu"), {
        k: np.asarray(v) for k, v in jax_model.raw_parameters().items()})


def _prompts(lengths=(5, 20, 12), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1024, (n,)).astype(np.int32) for n in lengths]


def _engine(model, **kw):
    return LLMEngine(model, device="cpu", **{**CFG, **kw})


def _streams(results):
    return [list(r.token_ids) for r in results]


def _margins(model, prompts, streams):
    """The tp=1 top-2 logit margin of every greedy step, per stream."""
    out = []
    for p, s in zip(prompts, streams):
        ids = torch.from_numpy(np.concatenate([p, s[:-1]]).astype(
            np.int64))[None]
        top = torch.topk(model.logits(ids)[0, len(p) - 1:].float(), 2).values
        out.append(float((top[:, 0] - top[:, 1]).min()))
    return out


def _lanes():
    return [SamplingParams(max_new_tokens=8),
            SamplingParams(max_new_tokens=6, temperature=0.8, top_k=20),
            SamplingParams(max_new_tokens=6, temperature=0.7, top_p=0.9)]


@pytest.fixture(scope="module")
def jax_streams(jax_model):
    """The JAX engine's greedy streams at tp 1 and 2 (the latter on the
    virtual CPU mesh): the cross-package reference of the matrix."""
    out = {}
    for tp in (1, 2):
        eng = JaxEngine(jax_model, tp=tp, **CFG)
        out[tp] = _streams(eng.generate(_prompts(),
                                        JaxParams(max_new_tokens=8)))
    return out


class TestMeshHelpers:
    def test_make_tp_mesh_shape(self):
        g = make_tp_mesh(2)
        assert g.tp == 2 and g.ranks == (0, 1) and g.devices is None
        bound = g.bind("cpu")
        assert bound.devices == (torch.device("cpu"),) * 2
        assert bound.collectives == 0 and g.bind("cpu") is not bound
        assert make_tp_mesh(2, ranks=(2, 3)).ranks == (2, 3)

    def test_make_tp_mesh_validation(self):
        with pytest.raises(ValueError):
            make_tp_mesh(0)
        with pytest.raises(ValueError):
            make_tp_mesh(2, ["cpu"] * 3)      # an explicit group: exactly tp
        with pytest.raises(ValueError):
            make_tp_mesh(2, ranks=(1, 1))
        with pytest.raises(NotImplementedError, match="item 18"):
            make_tp_mesh(2, ["cpu", "meta"])
        with pytest.raises(ValueError, match="engine on"):
            make_tp_mesh(2, ["meta", "meta"]).bind("cpu")

    def test_mesh_fingerprint_distinguishes_groups(self):
        assert mesh_fingerprint(None) == ()
        a = mesh_fingerprint(make_tp_mesh(2, ranks=(0, 1)))
        b = mesh_fingerprint(make_tp_mesh(2, ranks=(2, 3)))
        assert a != b and a[0] == b[0] == 2
        assert a == mesh_fingerprint(make_tp_mesh(2))

    def test_engine_tp_validation(self, model):
        with pytest.raises(ValueError):
            _engine(model, tp=0)
        with pytest.raises(ValueError, match="not divisible"):
            _engine(model, tp=3)               # 4 heads % 3 != 0
        with pytest.raises(ValueError, match="disagrees"):
            _engine(model, mesh=make_tp_mesh(2), tp=4)
        with pytest.raises(TypeError, match="make_tp_mesh"):
            _engine(model, mesh="tp2")
        eng = _engine(model, mesh=make_tp_mesh(2, ["cpu", "cpu"]), tp=2)
        assert eng.tp == 2 and eng._mesh_fp == (2, 0, 1)
        one = _engine(model, mesh=make_tp_mesh(1))
        assert one.tp == 1 and one._mesh_fp == (1, 0)
        assert type(one.cache) is KVCacheManager        # unsharded path


class TestKVManagerInterface:
    def test_all_four_managers_implement_kvmanager(self):
        g = make_tp_mesh(2)
        slotted = make_kv_manager("slotted", **KV_KW)
        paged = make_kv_manager("paged", page_size=16, **KV_KW)
        sh_slot = make_kv_manager("slotted", g, **KV_KW)
        sh_page = make_kv_manager("paged", g, page_size=16, **KV_KW)
        assert type(slotted) is KVCacheManager
        assert type(paged) is PagedKVCache
        assert isinstance(sh_slot, ShardedKVCacheManager) \
            and isinstance(sh_slot, KVCacheManager)
        assert isinstance(sh_page, ShardedPagedKVCache) \
            and isinstance(sh_page, PagedKVCache)
        for m in (slotted, paged, sh_slot, sh_page):
            assert isinstance(m, KVManager)
            for name in KVManager.__abstractmethods__:
                assert callable(getattr(m, name)), (type(m), name)

    @pytest.mark.parametrize("kv_dtype", [None, "int8"])
    def test_sharded_slabs_are_per_rank_and_cost_the_same(self, kv_dtype):
        g = make_tp_mesh(2)
        one = make_kv_manager("slotted", prefix_pool_pages=2,
                              prefix_block=16, kv_dtype=kv_dtype, **KV_KW)
        sh = make_kv_manager("slotted", g, prefix_pool_pages=2,
                             prefix_block=16, kv_dtype=kv_dtype, **KV_KW)
        for slab in (sh.k[0], sh.v[0], sh.pool_k[0], sh.pool_v[0]):
            assert isinstance(slab, HeadShards) and len(slab) == 2
            for part in slab:
                data = part["q"] if kv_dtype else part
                assert data.shape[-2:] == (2, 8) and data.is_contiguous()
                if kv_dtype:            # scales shard with their heads
                    assert part["s"].shape == data.shape[:-1]
        pg = make_kv_manager("paged", g, page_size=16, kv_dtype=kv_dtype,
                             **KV_KW)
        assert all(isinstance(s, HeadShards) for s in pg.k + pg.v)
        # the ranks' slabs together: tp=1's bytes (kv_bytes_per_token)
        assert sh.nbytes() == one.nbytes()
        assert sh.bytes_per_token() == one.bytes_per_token()

    def test_qkv_shards_head_aligned_against_jax(self, model, jax_model):
        """Rank r's qkv columns are the q, k and v columns of its heads
        (not a contiguous third of 3h), and the q / k / v a rank computes
        are the JAX forward's for those heads; the JAX tp=2 engine's KV
        rows after a prefill equal the port tp=2 engine's, joined."""
        g = make_tp_mesh(2).bind("cpu")
        full = model.serving_params()
        sp = shard_serving_params(full, tp_param_specs(model.cfg, full), g)
        assert isinstance(sp, ShardedParams)
        nh, hd, h = 4, 32, 128
        w = np.asarray(jax_model.raw_parameters()[
            "blocks.0.attn.qkv.weight"]).reshape(h, 3, nh, hd)
        for r in range(2):
            np.testing.assert_array_equal(
                sp.ranks[r]["blocks.0.attn.qkv.weight"].numpy(),
                w[:, :, 2 * r:2 * r + 2].reshape(h, -1))
        assert "blocks.0.attn.out.bias" in sp      # replicated
        ids = torch.from_numpy(_prompts((9,))[0].astype(np.int64))[None]
        x = full["wte.weight"][ids] + full["wpe.weight"][:9][None]
        seen = {}

        def attn(i, q, k, v):
            seen.setdefault(i, (q, k, v))
            return q
        _body_layers(model.cfg, sp, x, attn, num_layers=1)
        p = {k: np.asarray(v) for k, v in jax_model.raw_parameters().items()}
        hx = _ln(x, full["blocks.0.ln1.weight"], full["blocks.0.ln1.bias"],
                 1e-5).numpy()
        ref = (hx @ p["blocks.0.attn.qkv.weight"]
               + p["blocks.0.attn.qkv.bias"]).reshape(1, 9, 3, nh, hd)
        for j in range(3):
            got = torch.cat(seen[0][j], dim=-2).numpy()
            np.testing.assert_allclose(got, ref[:, :, j], **TOL)
        # the caches: the JAX tp=2 engine's rows, per head
        prompt = _prompts((9,), seed=1)
        jeng = JaxEngine(jax_model, tp=2, **CFG)
        jeng.generate([prompt], JaxParams(max_new_tokens=1))
        eng = _engine(model, tp=2, prefix_cache=False)
        eng.generate([prompt], SamplingParams(max_new_tokens=1))
        for layer in (0, 3):
            for side in ("k", "v"):
                want = np.asarray(getattr(jeng.cache, side)[layer])[0, :9]
                got = torch.cat(list(getattr(eng.cache, side)[layer]),
                                dim=-2)[0, :9].numpy()
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


class TestBitIdentityMatrix:
    @pytest.mark.parametrize("kv_layout", ["slotted", "paged"])
    @pytest.mark.parametrize("prefix_cache", [True, False])
    def test_matrix(self, model, jax_streams, kv_layout, prefix_cache):
        prompts = _prompts()
        kw = dict(prefix_cache=prefix_cache)
        if kv_layout == "paged":
            kw.update(kv_layout="paged", page_size=16)
        ref = _engine(model, **kw)
        tp2 = _engine(model, tp=2, **kw)
        assert tp2.tp == 2 and tp2.mesh is not None
        a, b = _streams(ref.generate(prompts, _lanes())), \
            _streams(tp2.generate(prompts, _lanes()))
        assert min(_margins(model, prompts[:1], a[:1])) > MARGIN
        assert a == b                       # greedy and sampled lanes
        assert b[0] == jax_streams[1][0] == jax_streams[2][0]
        for eng in (ref, tp2):
            assert eng.watchdog.compiles_unexpected == 0

    def test_greedy_all_lanes_equal_jax_tp1_and_tp2(self, model,
                                                    jax_streams):
        prompts = _prompts()
        got = _streams(_engine(model, tp=2).generate(
            prompts, SamplingParams(max_new_tokens=8)))
        assert min(_margins(model, prompts, got)) > MARGIN
        assert got == jax_streams[1] == jax_streams[2]

    def test_logits_across_degrees_within_fp32_tolerance(self, model):
        """tp=2's first-token logits against tp=1's: not bitwise (the
        row-parallel partial sums round apart), within 1e-4."""
        prompt = _prompts((13,), seed=3)[0]
        lg = {}
        for tp in (1, 2, 4):
            eng = _engine(model, tp=tp, prefix_cache=False)
            eng.submit(prompt, SamplingParams(max_new_tokens=2))
            slot = eng.cache.allocate()
            lg[tp] = eng._prefill_tokens(slot, prompt).numpy()
        for tp in (2, 4):
            np.testing.assert_allclose(lg[tp], lg[1], rtol=1e-4, atol=1e-4)
        # the model-side cached forward over per-rank caches, likewise
        g = make_tp_mesh(2).bind("cpu")
        full = model.serving_params()
        sp = shard_serving_params(full, tp_param_specs(model.cfg, full), g)
        ids = torch.from_numpy(prompt.astype(np.int64))[None]
        shape = (4, 1, 13, 2, 32)
        caches = [[torch.zeros(shape) for _ in range(2)] for _ in "kv"]
        got = _decode_forward(model.cfg, sp, ids, 0, *caches)[0]
        np.testing.assert_allclose(got[0, -1].numpy(), lg[1], rtol=1e-4,
                                   atol=1e-4)

    def test_speculative_tp2_bit_identical(self, model, jax_streams):
        """Speculation on ≡ off at tp=2 (bitwise: the verify pass runs
        each row-wise op and each collective once per position group),
        ≡ tp=1 and ≡ the JAX spec-off tp=1 streams."""
        prompts = _prompts()
        sp = SamplingParams(max_new_tokens=8)
        off = _streams(_engine(model, tp=2).generate(prompts, sp))
        for kw in (dict(speculate_k=2), dict(speculate_k=3, draft="int8"),
                   dict(speculate_k=2, kv_layout="paged", page_size=16,
                        attend_impl="ragged")):
            eng = _engine(model, tp=2, **kw)
            assert _streams(eng.generate(prompts, sp)) == off
            assert eng.stats()["spec_proposed"] > 0
            assert eng.watchdog.compiles_unexpected == 0
        assert off == _streams(_engine(model, speculate_k=2).generate(
            prompts, sp)) == jax_streams[1]

    def test_paged_and_ragged_tp_equal_slotted_masked(self, model):
        """Inside tp=2: paged ≡ slotted bitwise; the "ragged" route
        resolves to "ragged_tp" (the kernel's plain version per rank)."""
        prompts = _prompts(seed=2)
        sp = SamplingParams(max_new_tokens=8)
        base = _streams(_engine(model, tp=2).generate(prompts, sp))
        paged = _engine(model, tp=2, kv_layout="paged", page_size=16)
        assert _streams(paged.generate(prompts, sp)) == base
        rag = _engine(model, tp=2, attend_impl="ragged", kv_dtype="int8")
        assert rag.attend_impl == "ragged_tp"
        assert len(_streams(rag.generate(prompts, sp))[0]) == 8

    def test_snapshot_resume_carries_tp(self, model):
        prompts = _prompts((5, 9), seed=3)
        sp = SamplingParams(max_new_tokens=8)
        want = _streams(_engine(model, tp=2).generate(prompts, sp))
        eng = _engine(model, tp=2)
        rids = [eng.submit(p, sp) for p in prompts]
        eng.step()
        snap = eng.snapshot()
        assert snap["engine"]["tp"] == 2
        resumed = LLMEngine.resume(model, snap)
        assert resumed.tp == 2 and resumed.mesh is not None
        resumed.run_until_complete()
        assert [list(resumed.result(r).token_ids) for r in rids] == want
        pinned = LLMEngine.resume(model, snap,
                                  mesh=make_tp_mesh(2, ranks=(4, 5)))
        assert pinned._mesh_fp == (2, 4, 5)


class TestCollectives:
    def test_counts_per_forward(self, model):
        prompts = _prompts()
        sp = SamplingParams(max_new_tokens=8)
        one = _engine(model)
        one.generate(prompts, sp)
        assert one.stats()["tp_collectives"] == 0
        eng = _engine(model, tp=2, overlap=False)
        eng.generate(prompts, sp)
        st = eng.stats()
        L = model.cfg.num_layers
        assert st["tp"] == 2 and st["tp_collectives_per_step"] == 2 * L + 2
        prefills = sum(1 for e in eng.tracer.events()
                       if e[2] == "prefill_chunk")
        assert st["tp_collectives"] == (2 * L + 2) * (
            prefills + st["decode_steps"])
        assert eng.mesh.all_gathers.count == prefills + st["decode_steps"]

    def test_int8_ptq_linears_replicated(self, model):
        """An int8-PTQ model keeps its linears whole on every rank: one
        all-gather of the heads per block, none for the MLP; the stream
        equals tp=1's."""
        from paddle_tpu_torch.quantization import PTQ
        q = gpt_tiny(device="cpu")
        q.load_state_dict(model.state_dict())
        ptq = PTQ()
        ptq.quantize(q)
        ptq.sample(q, [np.arange(32)[None]])
        ptq.convert(q)
        prompts = _prompts(seed=2)
        sp = SamplingParams(max_new_tokens=6)
        eng = _engine(q, tp=2)
        got = _streams(eng.generate(prompts, sp))
        assert got == _streams(_engine(q).generate(prompts, sp))
        L = q.cfg.num_layers
        assert eng.stats()["tp_collectives_per_step"] == L + 2 == \
            tp_collectives_per_step(q.cfg, q.serving_params())


class TestWatchdogTPMatrix:
    @pytest.mark.parametrize("tp", [1, 2, 4])
    def test_compiles_pinned_across_tp_matrix(self, model, tp):
        prompts = _prompts((5, 17))
        sp = SamplingParams(max_new_tokens=6)
        for kw in (dict(), dict(kv_layout="paged", page_size=16)):
            eng = _engine(model, tp=tp, **kw)
            eng.generate(prompts, sp)
            wd = eng.watchdog
            assert wd.compiles_unexpected == 0, wd.counts()
            assert wd.compiles_total <= wd.budget_total
            assert all(k[-1] == eng._mesh_fp for k in eng._captures)

    def test_sibling_tp_groups_do_not_cross_count(self, model):
        prompts = _prompts((5,))
        sp = SamplingParams(max_new_tokens=4)
        a = _engine(model)
        b = _engine(model, tp=2)
        c = _engine(model, mesh=make_tp_mesh(2, ranks=(2, 3)))
        for eng in (a, b, c):
            eng.generate(prompts, sp)
        for eng in (a, b, c):
            wd = eng.watchdog
            assert wd.compiles_unexpected == 0, wd.counts()
            for name, cnt in wd.counts().items():
                assert cnt["programs"] <= cnt["budget"], (name, cnt)
        keys = [set(e._captures) for e in (a, b, c)]
        assert not (keys[0] & keys[1] or keys[1] & keys[2])


class TestShardedKernel:
    """The sharded plain attention (the port's `shard_map` entries) per
    head shard against JAX's unsharded Pallas kernels in interpret mode,
    run per shard and concatenated: int8 slotted (K5's addressing, with
    slot_map and with_stats) and int8 paged (K6's); the fp variants run
    the same wrapper code without the scales (tests/
    test_torch_decode_attention.py holds the unsharded fp kernels to
    JAX's)."""

    def _slotted(self, S=4, T=64, nh=4, hd=16, B=None, seed=0):
        rng = np.random.RandomState(seed)
        q = rng.randn(B or S, nh, hd).astype(np.float32)
        kc = rng.randn(S, T, nh, hd).astype(np.float32)
        vc = rng.randn(S, T, nh, hd).astype(np.float32)
        return q, kc, vc

    @staticmethod
    def _shards(a, tp, axis=2):
        return [torch.from_numpy(np.ascontiguousarray(x))
                for x in np.split(a, tp, axis=axis)]

    @staticmethod
    def _int8(k, v):
        """Per-row, per-head int8 codes and f32 scales of k and v."""
        out = []
        for x in (k, v):
            sc = (np.abs(x).max(-1) / 127.0).astype(np.float32)
            out += [np.round(x / sc[..., None]).astype(np.int8), sc]
        return out

    def _jax_scales(self, ks, vs, r):
        return dict(k_scale=jnp.asarray(ks[r].numpy()),
                    v_scale=jnp.asarray(vs[r].numpy()))

    def test_sharded_matches_jax_per_shard_slotted(self):
        q, kc, vc = self._slotted(B=6)
        slot_map = np.array([0, 0, 1, 1, 3, 2], np.int32)
        lengths = np.array([3, 4, 17, 18, 64, 1], np.int32)
        kq, ks, vq, vs = self._int8(kc, vc)
        ks, vs = self._shards(ks, 2), self._shards(vs, 2)
        got, vis = dec.sharded_ragged_decode_attention(
            torch.from_numpy(q), self._shards(kq, 2), self._shards(vq, 2),
            torch.from_numpy(lengths), slot_map=torch.from_numpy(slot_map),
            block_k=8, num_splits=2, with_stats=True, k_scale=ks,
            v_scale=vs)
        outs = []
        for r in range(2):
            h = slice(2 * r, 2 * r + 2)
            o, jvis = jax_ragged(
                jnp.asarray(q[:, h]), jnp.asarray(kq[:, :, h]),
                jnp.asarray(vq[:, :, h]), jnp.asarray(lengths),
                slot_map=jnp.asarray(slot_map), block_k=8, num_splits=2,
                interpret=True, with_stats=True,
                **self._jax_scales(ks, vs, r))
            outs.append(np.asarray(o))
            np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
        np.testing.assert_allclose(got.numpy(), np.concatenate(outs, 1),
                                   **TOL)

    def test_sharded_matches_jax_per_shard_paged(self):
        rng = np.random.RandomState(1)
        S, pages, page, nh, hd = 3, 8, 16, 4, 16
        q = rng.randn(S, nh, hd).astype(np.float32)
        kp = rng.randn(pages, page, nh, hd).astype(np.float32)
        vp = rng.randn(pages, page, nh, hd).astype(np.float32)
        tables = rng.permutation(pages)[:S * 2].reshape(S, 2).astype(
            np.int32)
        lengths = np.array([5, 32, 17], np.int32)
        kq, ks, vq, vs = self._int8(kp, vp)
        ks, vs = self._shards(ks, 2), self._shards(vs, 2)
        got = dec.sharded_paged_ragged_decode_attention(
            [torch.from_numpy(np.ascontiguousarray(q[:, 2 * r:2 * r + 2]))
             for r in range(2)], self._shards(kq, 2), self._shards(vq, 2),
            torch.from_numpy(tables), torch.from_numpy(lengths),
            k_scale=ks, v_scale=vs)
        assert isinstance(got, list) and len(got) == 2   # per rank out
        for r in range(2):
            h = slice(2 * r, 2 * r + 2)
            want = jax_paged(jnp.asarray(q[:, h]), jnp.asarray(kq[:, :, h]),
                             jnp.asarray(vq[:, :, h]), jnp.asarray(tables),
                             jnp.asarray(lengths), interpret=True,
                             **self._jax_scales(ks, vs, r))
            np.testing.assert_allclose(got[r].numpy(), np.asarray(want),
                                       **TOL)

    def test_one_slab_is_the_plain_call(self):
        q, kc, vc = self._slotted()
        lengths = torch.tensor([3, 64, 17, 1], dtype=torch.int32)
        args = (torch.from_numpy(q), torch.from_numpy(kc),
                torch.from_numpy(vc), lengths)
        assert torch.equal(dec.sharded_ragged_decode_attention(*args),
                           dec.ragged_decode_attention(*args))

    def test_indivisible_heads_rejected(self, model):
        q, kc, vc = self._slotted(nh=3)
        with pytest.raises(ValueError, match="not divisible"):
            dec.sharded_ragged_decode_attention(
                torch.from_numpy(q), self._shards(kc[:, :, :2], 2),
                self._shards(vc[:, :, :2], 2),
                torch.tensor([3, 64, 17, 1], dtype=torch.int32))
        with pytest.raises(ValueError, match="not divisible"):
            make_kv_manager("slotted", make_tp_mesh(3), **KV_KW)
        full = model.serving_params()
        with pytest.raises(ValueError, match="not divisible"):
            shard_serving_params(full, tp_param_specs(model.cfg, full),
                                 make_tp_mesh(3).bind("cpu"))
