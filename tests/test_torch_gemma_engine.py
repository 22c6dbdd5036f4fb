"""The port's engine serving Gemma against the JAX package's engine, and
K11's band and softcap branches against JAX's kernel.

``gemma2-test`` (softcap 50, a band of 8 on alternate layers, final softcap
30) and ``gemma3-test`` (qk-norms, a band of 8 on five of six layers, local
rope) from one seed, carried to the port with ``from_jax_params``; both
engines serve the same requests over contiguous caches and paged pools in
every KV format (bf16, int8, fp8-e4m3, int4) with prompts past the band.
Tokens and dispatch counters must be equal, logprobs within 0.1. JAX runs
as its own serving tests run it on the CPU: K11 (with ``window=`` and
``softcap=``) and K12 in interpret mode where they take the format, its
XLA paths elsewhere; the port runs the plain versions of its kernels.
Seeds are pinned where tokens part nowhere (int4 caches turn one-ulp
differences into code steps, ROADMAP.md Queue 3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_compressor_tpu.generation import greedy_search as j_greedy
from neural_compressor_tpu.kernels import paged_attention as jpa
from neural_compressor_tpu.models import llama as jl
from neural_compressor_tpu.models.gemma import \
    GemmaForCausalLM as JGemmaForCausalLM
from neural_compressor_tpu.serving.engine import \
    ContinuousBatchingEngine as JEngine
import neural_compressor_tpu_torch as nct
from neural_compressor_tpu_torch.kernels import paged_attention as tpa
from neural_compressor_tpu_torch.models import gemma as tg

from test_torch_engine import COUNTERS, LP_TOL
from test_torch_gemma import f32, flat_state, port_cfg

torch.set_num_threads(2)

ENGINE = dict(n_slots=2, max_len=64, prefill_chunk=16)
MODES = {"contiguous_bf16": ({}, None),
         "contiguous_int8": ({}, "int8"),
         "contiguous_fp8": ({}, "fp8_e4m3"),
         "contiguous_int4": ({}, "int4"),
         "paged_bf16": (dict(paged=True, page_size=16), None),
         "paged_int8": (dict(paged=True, page_size=16), "int8"),
         "paged_fp8": (dict(paged=True, page_size=16), "fp8_e4m3"),
         "paged_int4": (dict(paged=True, page_size=16), "int4")}
SEED = 3
NEW = 5
# partings seen at other seeds, each an int4 pool's code step (the bf16
# forward of both packages gives the same top-2 logits there):
# (seed, preset, mode, request, new token) -> (JAX token, port token,
# top-2 of a full bf16 forward of the prefix in both packages)
PARTED = {
    (2, "gemma3-test", "paged_int4", 0, 4): (186, 104,
                                             ((186, 2.625), (104, 2.484375))),
}


@pytest.fixture(scope="module")
def pairs():
    built = {}

    def get(preset):
        if preset not in built:
            jm = JGemmaForCausalLM.from_preset(preset, seed=SEED)
            tm = tg.from_jax_params(flat_state(jm), port_cfg(jm.cfg),
                                    device="cpu")
            built[preset] = (jm, tm)
        return built[preset]

    return get


def _serve(engine_cls, model, mode, specs, chunk=3):
    kw, fmt = MODES[mode]
    model.kv_cache_quantized = fmt is not None
    model.kv_cache_format = fmt or "int8"
    try:
        eng = engine_cls(model, **{**ENGINE, **kw})
        reqs = [eng.submit(**s) for s in specs]
        done = eng.run(chunk=chunk)
    finally:
        model.kv_cache_quantized = False
    assert sorted(r.uid for r in done) == sorted(r.uid for r in reqs)
    m = eng.metrics()
    return {"tokens": [list(r.generated) for r in reqs],
            "logprobs": [list(r.logprobs) for r in reqs],
            "metrics": {k: m[k] for k in COUNTERS}}


def specs_of(seed):
    """Two requests on two slots, prompts of 12 and 15 tokens (past the
    8-token band), prefilled in one 16-token chunk: few program shapes for
    the JAX engine to compile."""
    rng = np.random.default_rng(seed)
    return [dict(prompt_ids=rng.integers(0, 256, (n,)), max_new_tokens=NEW)
            for n in (12, 15)]


def engine_matches_jax(pairs, preset, mode):
    """Both engines on ``preset`` in ``mode``: tokens, counters, logprobs
    (``test_torch_gemma3_engine.py`` runs gemma3-test through it)."""
    jm, tm = pairs(preset)
    specs = specs_of(SEED)
    want = _serve(JEngine, jm, mode, specs)
    before = dict(tpa.paged_attn_gemma.launches)
    got = _serve(nct.ContinuousBatchingEngine, tm, mode, specs)
    assert got["tokens"] == want["tokens"]
    assert got["metrics"] == want["metrics"]
    for a, b in zip(want["logprobs"], got["logprobs"]):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() <= LP_TOL
    # on the CPU the wrapper runs the plain version and counts nothing
    assert tpa.paged_attn_gemma.launches == before


@pytest.mark.parametrize("mode", sorted(MODES))
def test_gemma2_engine_matches_jax(pairs, mode):
    engine_matches_jax(pairs, "gemma2-test", mode)


def test_float32_paged_engine_equals_greedy():
    """A float32 gemma2 model (JAX's own engine test): the paged engine,
    its pools float32 rows, equals greedy_search on the port and JAX's
    engine on the same weights."""
    jm = JGemmaForCausalLM.from_preset("gemma2-test", seed=SEED,
                                       dtype=jnp.float32)
    tm = tg.from_jax_params(flat_state(jm), port_cfg(jm.cfg, torch.float32),
                            device="cpu")
    rng = np.random.default_rng(33)
    prompts = [rng.integers(0, 256, (n,)) for n in (12, 20)]
    refs = [nct.greedy_search(tm, torch.from_numpy(p)[None],
                              max_new_tokens=8)[0, len(p):].tolist()
            for p in prompts]
    jrefs = [np.asarray(j_greedy(jm, jnp.asarray(p)[None],
                                 max_new_tokens=8))[0, len(p):].tolist()
             for p in prompts]
    assert refs == jrefs
    kw = dict(n_slots=2, max_len=64, prefill_chunk=16, paged=True,
              page_size=16, n_pages=9)
    eng = nct.ContinuousBatchingEngine(tm, **kw)
    reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
    assert len(eng.run(chunk=2)) == 2
    assert [list(r.generated) for r in reqs] == refs
    assert eng.pools[0].k_pages.dtype == torch.float32


# pool formats JAX's interpreter attends (it has no fp8 dot: fp8 below)
FORMATS = ("bf16", "int8", "int4")


def _pools(fmt, rng, P, Hkv, page, D):
    """One random pool in ``fmt`` for both packages: (JAX PagedKVCache
    fields, port tensors), the same values."""
    k = rng.standard_normal((P, Hkv, page, D)).astype(np.float32)
    v = rng.standard_normal((P, Hkv, page, D)).astype(np.float32)
    if fmt == "bf16":
        kb = jnp.asarray(k).astype(jnp.bfloat16)
        vb = jnp.asarray(v).astype(jnp.bfloat16)
        return ((kb, None, vb, None, None, None),
                (torch.from_numpy(f32(kb)).to(torch.bfloat16), None,
                 torch.from_numpy(f32(vb)).to(torch.bfloat16), None, None,
                 None))
    if fmt == "int4":
        codes = [rng.integers(0, 256, (P, Hkv, page // 2, D)).astype(
            np.uint8) for _ in range(2)]
        sc = [rng.uniform(0.01, 0.2, (P, Hkv, page)).astype(np.float32)
              for _ in range(4)]
        j = (jnp.asarray(codes[0]), jnp.asarray(sc[0]),
             jnp.asarray(codes[1]), jnp.asarray(sc[1]), jnp.asarray(sc[2]),
             jnp.asarray(sc[3]))
        t = (torch.from_numpy(codes[0]), torch.from_numpy(sc[0]),
             torch.from_numpy(codes[1]), torch.from_numpy(sc[1]),
             torch.from_numpy(sc[2]), torch.from_numpy(sc[3]))
        return j, t
    cdt = jnp.int8 if fmt == "int8" else jnp.float8_e4m3fn
    tdt = torch.int8 if fmt == "int8" else torch.float8_e4m3fn
    kc = jnp.clip(jnp.asarray(k * 40), -127, 127).astype(cdt)
    vc = jnp.clip(jnp.asarray(v * 40), -127, 127).astype(cdt)
    ks = rng.uniform(0.005, 0.05, (P, Hkv, page)).astype(np.float32)
    vs = rng.uniform(0.005, 0.05, (P, Hkv, page)).astype(np.float32)
    tk = torch.from_numpy(f32(kc)).to(tdt)
    tv = torch.from_numpy(f32(vc)).to(tdt)
    return ((kc, jnp.asarray(ks), vc, jnp.asarray(vs), None, None),
            (tk, torch.from_numpy(ks), tv, torch.from_numpy(vs), None, None))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("window,softcap", [(8, 50.0), (8, None),
                                            (None, 50.0), (20, 50.0)])
def test_plain_k11_band_softcap_matches_jax(fmt, window, softcap):
    """The plain K11 with ``window``/``softcap`` against JAX's
    ``paged_decode_attention(window=, softcap=)`` (interpret mode) within
    1e-2, on pools of 16-row pages whose slots straddle the band: lengths
    0, 1, the window, window + 1 and long ones, a block table in random
    page order, rep 2 (gemma2-test's GQA)."""
    rng = np.random.default_rng(11)
    B, Hkv, rep, D, page, PMAX = 6, 2, 2, 16, 16, 4
    P = B * PMAX + 1
    jp, tp = _pools(fmt, rng, P, Hkv, page, D)
    bt = np.stack([1 + rng.permutation(P - 1)[:PMAX] for _ in range(B)])
    bt = bt.astype(np.int32)
    lengths = np.array([0, 1, 8, 9, 40, 64], np.int32)
    q = rng.standard_normal((B, Hkv * rep, 1, D)).astype(np.float32)
    qb = jnp.asarray(q).astype(jnp.bfloat16)
    jcache = jl.PagedKVCache(jp[0], jp[1], jp[2], jp[3], jnp.asarray(bt),
                             jp[4], jp[5])
    want = f32(jpa.paged_decode_attention(qb, jcache, jnp.asarray(lengths),
                                          window=window, softcap=softcap))
    tcache = tl_paged(tp, bt)
    got = f32(tpa.paged_decode_attention(
        torch.from_numpy(f32(qb)).to(torch.bfloat16), tcache,
        torch.from_numpy(lengths), window=window, softcap=softcap))
    np.testing.assert_allclose(got, want, atol=1e-2)
    assert np.all(got[0] == 0)


def tl_paged(tp, bt):
    from neural_compressor_tpu_torch.models.llama import PagedKVCache

    return PagedKVCache(tp[0], tp[1], tp[2], tp[3], torch.from_numpy(bt),
                        tp[4], tp[5])


def test_plain_k11_fp8_band_equals_its_bf16_rows():
    """fp8 pools (JAX's interpreter has no fp8 dot): with unit scales the
    band and the softcap over fp8 codes equal the same over a bf16 pool of
    those codes (e4m3 converts to bf16 exactly), bit for bit."""
    rng = np.random.default_rng(12)
    B, Hkv, D, page, PMAX = 4, 2, 16, 16, 4
    P = B * PMAX + 1
    codes = torch.from_numpy(rng.standard_normal(
        (2, P, Hkv, page, D)).astype(np.float32) * 8).to(torch.float8_e4m3fn)
    ones = torch.ones((P, Hkv, page))
    bt = torch.from_numpy(np.stack([1 + rng.permutation(P - 1)[:PMAX]
                                    for _ in range(B)]).astype(np.int32))
    lengths = torch.tensor([1, 8, 9, 50], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((B, 4, D)).astype(
        np.float32)).to(torch.bfloat16)
    fp8 = tpa.paged_attn_plain(q, codes[0], ones, codes[1], ones, bt,
                               lengths, window=8, softcap=50.0)
    bf = tpa.paged_attn_plain(q, codes[0].to(torch.bfloat16), None,
                              codes[1].to(torch.bfloat16), None, bt, lengths,
                              window=8, softcap=50.0)
    assert torch.equal(fp8, bf)
