"""The port's Gemma models against the JAX package, weights carried across
with ``from_jax_params``.

Inputs are drawn with numpy from fixed seeds and handed to both packages.
JAX runs eagerly on the CPU as its own Gemma tests run it; the port runs
its plain PyTorch paths. Tolerances: full-forward logits within
1e-4 * max|logit| in float32 (XLA's float32 tanh is an approximation a few
ulps from the rounded tanh the port computes) and 2e-2 * max|logit| in
bf16 (bf16 rounding at other places: float64 sums rounded once in the port,
float32 sums in XLA, eager division against the port's reciprocal).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import nnx

from neural_compressor_tpu.generation import greedy_search as j_greedy
from neural_compressor_tpu.layers.module_utils import \
    named_modules as j_named_modules
from neural_compressor_tpu.models import llama as jl
from neural_compressor_tpu.models.gemma import \
    GemmaForCausalLM as JGemmaForCausalLM
from neural_compressor_tpu.quantization import RTNConfig as JRTNConfig
from neural_compressor_tpu.quantization import quantize as j_quantize
from neural_compressor_tpu.quantization.save_load import _module_meta
import neural_compressor_tpu_torch as nct
from neural_compressor_tpu_torch.models import gemma as tg
from neural_compressor_tpu_torch.models import llama as tl

torch.set_num_threads(2)

PRESETS = ("gemma-test", "gemma2-test", "gemma3-test")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# model and prompt seed of the greedy token checks: no parting found at it
SEED = 3


def flat_state(model) -> dict:
    return {".".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.state(model).flat_state()}


def jax_meta(model) -> dict:
    return {path: _module_meta(m) for path, m in j_named_modules(model)
            if type(m).__name__ in ("WOQLinear", "W4A8Linear")}


def port_cfg(jcfg, dtype=torch.bfloat16) -> tg.GemmaConfig:
    return tg.GemmaConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(jcfg)
                             if f.name != "dtype"}, dtype=dtype)


def gemma_pair(preset, dtype="bfloat16", seed=0, quant=None):
    """(JAX model, port model) on the same weights; ``quant``: an RTN
    config applied on the JAX side first and carried as its bytes."""
    jdt, tdt = DTYPES[dtype]
    jm = JGemmaForCausalLM.from_preset(preset, seed=seed, dtype=jdt)
    if quant is not None:
        j_quantize(jm, quant)
    tm = tg.from_jax_params(flat_state(jm), port_cfg(jm.cfg, tdt),
                            device="cpu", meta=jax_meta(jm))
    return jm, tm


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def ids_of(shape, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("preset", PRESETS)
def test_forward_logits_match_jax(preset, dtype):
    jm, tm = gemma_pair(preset, dtype)
    ids = ids_of((2, 20), seed=1)
    want = f32(jm(jnp.asarray(ids)))
    got = f32(tm(torch.from_numpy(ids)))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= LOGIT_TOL[dtype] * scale, preset


@pytest.mark.parametrize("preset", PRESETS)
def test_cache_path_equals_prefill(preset):
    """The cached decode equals a full prefill, the prompt longer than the
    8-token window so the band binds through the cache; and the port's
    cached step equals JAX's."""
    jm, tm = gemma_pair(preset)
    ids = ids_of((2, 12), seed=2)
    caches = tl.init_kv_cache(tm.cfg, 2, 16, device="cpu")
    _, caches = tm(torch.from_numpy(ids), caches=caches, cache_pos=0)
    step = torch.from_numpy(ids[:, :1])
    lg, _ = tm(step, positions=torch.full((2, 1), 12), caches=caches,
               cache_pos=12)
    full = tm(torch.cat([torch.from_numpy(ids), step], dim=1))
    np.testing.assert_allclose(f32(full[:, -1]), f32(lg[:, 0]), atol=2e-2)
    jc = jl.init_kv_cache(jm.cfg, 2, 16)
    _, jc = jm(jnp.asarray(ids), caches=jc, cache_pos=0)
    jlg, _ = jm(jnp.asarray(ids[:, :1]), positions=jnp.full((2, 1), 12),
                caches=jc, cache_pos=12)
    scale = np.abs(f32(jlg)).max()
    assert np.abs(f32(lg) - f32(jlg)).max() <= 2e-2 * scale


@pytest.mark.parametrize("preset", ("gemma2-test", "gemma3-test"))
def test_rtn_int4_greedy_tokens_match_jax(preset):
    """RTN int4 g32 weights (``tests/test_gemma.py``'s config), quantized
    on the JAX side and carried as bytes: greedy tokens equal."""
    jm, tm = gemma_pair(preset, seed=SEED,
                        quant=JRTNConfig(dtype="int4", group_size=32))
    assert sum(type(m).__name__ == "WOQLinear"
               for _n, m in tm.named_modules()) >= 4
    ids = ids_of((1, 10), seed=SEED)
    want = np.asarray(j_greedy(jm, jnp.asarray(ids), max_new_tokens=8))
    got = nct.greedy_search(tm, torch.from_numpy(ids),
                            max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, want)


def test_port_rtn_quantizes_like_jax():
    """``quantize(RTNConfig)`` on the port swaps every projection for a
    WOQLinear holding JAX's bytes."""
    cfg = JRTNConfig(dtype="int4", group_size=32)
    jm, _ = gemma_pair("gemma2-test", quant=cfg)
    _, tm = gemma_pair("gemma2-test")
    nct.quantize(tm, nct.RTNConfig(dtype="int4", group_size=32))
    jflat = flat_state(jm)
    state = tm.state_dict()
    for k, v in jflat.items():
        if k.endswith((".packed", ".scales")):
            got = state[k]
            want = torch.from_numpy(np.array(v).view(np.int32)
                                    if v.dtype == np.uint32 else np.array(v))
            assert torch.equal(got, want.to(got.dtype)), k


@pytest.mark.parametrize("preset", ("gemma2-test", "gemma3-test"))
def test_chunked_prefill_matches_dense(preset):
    """The chunked long prefill (softcap and band inside the chunks) equals
    the dense path with ``_DENSE_MASK_ELEMS`` lowered, as
    ``test_chunked_prefill_matches_dense_gemma`` lowers it, and JAX's
    chunked prefill."""
    jm, tm = gemma_pair(preset)
    ids = ids_of((2, 40), seed=13)
    ref = f32(tm(torch.from_numpy(ids)))
    old_t, old_j = tl._DENSE_MASK_ELEMS, jl._DENSE_MASK_ELEMS
    try:
        tl.set_dense_mask_limit(64)
        jl.set_dense_mask_limit(64)
        got = f32(tm(torch.from_numpy(ids)))
        jgot = f32(jm(jnp.asarray(ids)))
    finally:
        tl.set_dense_mask_limit(old_t)
        jl.set_dense_mask_limit(old_j)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 2e-2 * scale
    assert np.abs(got - jgot).max() <= 2e-2 * scale


def test_chunked_attention_chunks_and_bands():
    """``_grouped_attention_chunked`` over several query chunks, with the
    band and the softcap, against JAX's (several KV chunks) and against
    the port's dense attention on the same band."""
    rng = np.random.default_rng(5)
    B, H, Hkv, S, D = 1, 4, 2, 70, 16
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    pos = np.arange(S)[None]
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tl._grouped_attention_chunked(tq, tk, tv, torch.from_numpy(pos),
                                        D, q_chunk=16, softcap=50.0,
                                        window=8)
    want = jl._grouped_attention_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), D,
        q_chunk=16, kv_chunk=16, softcap=50.0, window=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    kp = np.arange(S)
    mask = (kp[None, :] <= pos[0][:, None]) & (pos[0][:, None] - kp < 8)
    dense = tg._gemma_grouped_attention(
        tq, tk, tv, torch.from_numpy(mask)[None, None], D ** -0.5, 50.0)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-5)


def test_linear_rope_scaling_matches_jax():
    pos = jnp.arange(40)[None]
    sc = dict(type="linear", factor=8.0)
    jc, js = jl._rope(pos, 32, 1e6, 1.0, sc, 131072)
    tc, ts = tl._rope(torch.arange(40)[None], 32, 1e6, 1.0, sc)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6)
    with pytest.raises(NotImplementedError):
        tl._rope(torch.arange(4)[None], 32, 1e4, 1.0,
                 dict(type="yarn", factor=4.0))


def test_from_jax_params_carries_every_weight():
    jm, tm = gemma_pair("gemma3-test", dtype="float32")
    flat = flat_state(jm)
    state = tm.state_dict()
    assert set(state) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)


def test_bf16_elementwise_rounding_matches_jitted_jax():
    """gelu(approximate) and the softcap round as jitted XLA rounds bf16
    after each operation."""
    from neural_compressor_tpu_torch.ops import gelu_tanh, softcap

    x = (np.random.default_rng(4).standard_normal(20000) * 20).astype(
        np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(f32(xb)).to(torch.bfloat16)
    want = f32(jax.jit(lambda a: jax.nn.gelu(a, approximate=True))(xb))
    np.testing.assert_array_equal(f32(gelu_tanh(tx)), want)
    want = f32(jax.jit(lambda a: 30.0 * jnp.tanh(a / 30.0))(xb))
    np.testing.assert_array_equal(f32(softcap(tx, 30.0)), want)


# int4 caches turn one-ulp differences of a row into code steps of 1/15 of
# its range: jitted JAX against eager JAX parts by as much at layer 1+
KV_TOL = {"int8": 2e-2, "fp8_e4m3": 2e-2, "int4": 5e-2}


def test_quantized_kv_cache_decode_matches_jax():
    """int8, fp8 and int4 contiguous caches: the cache rows are dequantized
    for attention on both sides; a prefill and a decode step within
    ``KV_TOL`` of jitted JAX's logits (the port's quantizers are the jitted
    forms)."""
    for fmt in ("int8", "fp8_e4m3", "int4"):
        jm, tm = gemma_pair("gemma2-test")
        ids = ids_of((1, 12), seed=6)
        caches = tl.init_kv_cache(tm.cfg, 1, 16, quantized=fmt,
                                  device="cpu")
        _, caches = tm(torch.from_numpy(ids), caches=caches, cache_pos=0)
        lg, _ = tm(torch.from_numpy(ids[:, :1]),
                   positions=torch.full((1, 1), 12), caches=caches,
                   cache_pos=12)
        jc = jl.init_kv_cache(jm.cfg, 1, 16, quantized=fmt)

        @nnx.jit
        def run(m, i, p, c, cp):
            return m(i, positions=p, caches=c, cache_pos=cp)

        _, jc = run(jm, jnp.asarray(ids),
                    jnp.arange(12)[None], jc, 0)
        jlg, _ = run(jm, jnp.asarray(ids[:, :1]), jnp.full((1, 1), 12),
                     jc, 12)
        scale = np.abs(f32(jlg)).max()
        assert np.abs(f32(lg) - f32(jlg)).max() <= KV_TOL[fmt] * scale, fmt
