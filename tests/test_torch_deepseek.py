"""The port's DeepSeek model (MLA, routed MoE) against the JAX package,
weights carried across with ``from_jax_params``.

Inputs are drawn with numpy from fixed seeds and handed to both packages.
JAX runs eagerly on the CPU as its own DeepSeek tests run it (its quantizers
under ``jit`` where codes are compared, as the engine's programs run them);
the port runs its plain PyTorch paths. Tolerances, each the larger of JAX's
float32 sums and the port's float64 sums rounded once: the router's
weights within 1e-6 relative; logits within 1e-4 * max|logit| for float32
models over float caches, 2e-2 * max|logit| in bf16 and over int8 / fp8 /
int4 codes (a float32 ulp of a row can move a code by a step).
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
from neural_compressor_tpu.models import deepseek as jd
from neural_compressor_tpu.models import enable_mla_latent_cache as j_enable
from neural_compressor_tpu.models import llama as jl
from neural_compressor_tpu.quantization import RTNConfig as JRTNConfig
from neural_compressor_tpu.quantization import quantize as j_quantize
from neural_compressor_tpu.quantization.save_load import _module_meta
import neural_compressor_tpu_torch as nct
from neural_compressor_tpu_torch.models import deepseek as td
from neural_compressor_tpu_torch.models import llama as tl

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# (latent mode, KV format) of the cache paths
CACHES = [(False, None), (False, "int8"), (False, "fp8_e4m3"),
          (True, None), (True, "int8"), (True, "fp8_e4m3"), (True, "int4")]


def flat_state(model) -> dict:
    return {".".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.state(model).flat_state()}


def jax_meta(model) -> dict:
    return {path: _module_meta(m) for path, m in j_named_modules(model)
            if type(m).__name__ in ("WOQLinear", "W4A8Linear")}


def port_cfg(jcfg, dtype=torch.bfloat16) -> td.DeepseekConfig:
    return td.DeepseekConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(jcfg)
                                if f.name != "dtype"}, dtype=dtype)


def ds_pair(dtype="float32", seed=0, quant=None, bias_seed=None):
    """(JAX model, port model) on the same deepseek-test weights;
    ``quant``: an RTN config applied on the JAX side first and carried as
    its bytes; ``bias_seed``: a non-zero ``e_score_correction_bias`` on
    every router, so that the group selection matters."""
    jdt, tdt = DTYPES[dtype]
    jm = jd.DeepseekForCausalLM.from_preset("deepseek-test", seed=seed,
                                            dtype=jdt)
    if bias_seed is not None:
        rng = np.random.default_rng(bias_seed)
        for layer in jm.model.layers:
            if isinstance(layer.mlp, jd.DeepseekMoE):
                g = layer.mlp.gate
                g.e_score_correction_bias[...] = jnp.asarray(
                    rng.standard_normal(g.e_score_correction_bias.shape)
                    .astype(np.float32) * 0.3)
    if quant is not None:
        j_quantize(jm, quant)
    tm = td.from_jax_params(flat_state(jm), port_cfg(jm.cfg, tdt),
                            device="cpu", meta=jax_meta(jm))
    return jm, tm


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def ids_of(shape, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_router_matches_jax(dtype):
    """Indices equal, weights within 1e-6 relative, with a non-zero
    correction bias (group-limited selection binding)."""
    jm, tm = ds_pair(dtype, bias_seed=7)
    jg, tg_ = jm.model.layers[1].mlp.gate, tm.model.layers[1].mlp.gate
    x = np.random.default_rng(8).standard_normal((40, 64)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    ji, jw = jg(jnp.asarray(x).astype(jdt))
    ti, tw = tg_(torch.from_numpy(x).to(tdt))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    # the bias moved some choices away from the plain top-k
    plain = torch.topk(torch.sigmoid(torch.from_numpy(x).to(tdt).float()
                                     @ tg_.weight.t()), 2).indices
    assert not torch.equal(torch.sort(plain, dim=-1).values,
                           torch.sort(ti, dim=-1).values)


def test_topk_takes_the_lower_index_on_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0]])
    _v, i = td._topk_desc(x, 2)
    assert i.tolist() == [[1, 2]]
    _jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 2)
    assert np.asarray(ji).tolist() == i.tolist()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_moe_matches_jax(dtype):
    jm, tm = ds_pair(dtype, bias_seed=9)
    x = np.random.default_rng(10).standard_normal((2, 6, 64)).astype(
        np.float32)
    jdt, tdt = DTYPES[dtype]
    want = f32(jm.model.layers[2].mlp(jnp.asarray(x).astype(jdt)))
    got = f32(tm.model.layers[2].mlp(torch.from_numpy(x).to(tdt)))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= LOGIT_TOL[dtype] * scale


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_logits_match_jax(dtype):
    jm, tm = ds_pair(dtype, bias_seed=11)
    ids = ids_of((2, 12), seed=1)
    want = f32(jm(jnp.asarray(ids)))
    got = f32(tm(torch.from_numpy(ids)))
    assert np.abs(got - want).max() <= LOGIT_TOL[dtype] * np.abs(want).max()


@pytest.mark.parametrize("latent,fmt", CACHES,
                         ids=[f"{'latent' if a else 'expanded'}-{b or 'bf16'}"
                              for a, b in CACHES])
def test_cache_paths_match_jax(latent, fmt):
    """A 9-token prefill into the caches, then one decode step at per-row
    positions: the port's logits against JAX's, on the expanded caches and
    on the latent caches in every format."""
    jm, tm = ds_pair("float32", seed=2)
    if latent:
        j_enable(jm)
        td.enable_mla_latent_cache(tm)
    B, P, T = 2, 9, 16
    ids = ids_of((B, P), seed=3)
    step = ids_of((B, 1), seed=4)
    q = fmt or False
    jc = jm.init_caches(B, T, quantized=q)
    tc = tm.init_caches(B, T, quantized=q)
    jlg0, jc = jm(jnp.asarray(ids), caches=jc, cache_pos=0)
    tlg0, tc = tm(torch.from_numpy(ids), caches=tc, cache_pos=0)
    pos = np.array([P, P], np.int32)
    jlg, _ = jm(jnp.asarray(step), positions=jnp.asarray(pos)[:, None],
                caches=jc, cache_pos=jnp.asarray(pos))
    tlg, _ = tm(torch.from_numpy(step),
                positions=torch.from_numpy(pos)[:, None].long(), caches=tc,
                cache_pos=torch.from_numpy(pos))
    tol = 1e-4 if fmt is None else 2e-2
    for want, got in ((jlg0, tlg0), (jlg, tlg)):
        want, got = f32(want), f32(got)
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_latent_quantizers_match_jitted_jax():
    """``_lat4_quant`` (codes, scales, offsets) and the latent rows' int8 /
    fp8 ``_kv_quant`` bit for bit against the jitted JAX functions."""
    row = np.random.default_rng(12).standard_normal((2, 1, 5, 24)).astype(
        np.float32) * 3
    row[0, 0, 1] = 0.5                       # a flat row: scale 1
    want = jax.jit(jd._lat4_quant, static_argnums=1)(jnp.asarray(row), 16)
    got = td._lat4_quant(torch.from_numpy(row), 16)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for fmt in ("int8", "fp8_e4m3"):
        wc, ws = jax.jit(jl._kv_quant, static_argnames="fmt")(
            jnp.asarray(row), fmt=fmt)
        gc, gs = td._kv_quant(torch.from_numpy(row), fmt)
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        np.testing.assert_array_equal(
            gc.view(torch.uint8).numpy() if fmt != "int8" else gc.numpy(),
            np.asarray(wc).view(np.uint8) if fmt != "int8"
            else np.asarray(wc))


@pytest.mark.parametrize("latent,fmt", CACHES[:1] + CACHES[3:],
                         ids=["expanded", "latent-bf16", "latent-int8",
                              "latent-fp8", "latent-int4"])
def test_chunked_prefill_matches_jax(latent, fmt):
    """The long-prefill branches (reached with ``set_dense_mask_limit``):
    the expanded path's densified mask and the latent caches' chunked
    attention, with ``attn_scale * sqrt(C)`` folded into q in q's dtype;
    the port's logits against JAX's chunked ones, and against its own
    dense prefill."""
    jm, tm = ds_pair("float32", seed=5)
    if latent:
        j_enable(jm)
        td.enable_mla_latent_cache(tm)
    ids = ids_of((2, 40), seed=6)
    q = fmt or False

    def run(limit):
        old_j, old_t = jl._DENSE_MASK_ELEMS, tl._DENSE_MASK_ELEMS
        try:
            if limit:
                jl.set_dense_mask_limit(limit)
                tl.set_dense_mask_limit(limit)
            if latent:
                jlg, _ = jm(jnp.asarray(ids), caches=jm.init_caches(
                    2, 64, quantized=q), cache_pos=0)
                tlg, _ = tm(torch.from_numpy(ids), caches=tm.init_caches(
                    2, 64, quantized=q), cache_pos=0)
            else:
                jlg, tlg = jm(jnp.asarray(ids)), tm(torch.from_numpy(ids))
        finally:
            jl.set_dense_mask_limit(old_j)
            tl.set_dense_mask_limit(old_t)
        return f32(jlg), f32(tlg)

    jwant, tdense = run(None)
    jchunk, tchunk = run(64)
    tol = 1e-4 if fmt is None else 2e-2
    assert np.abs(tchunk - jchunk).max() <= tol * np.abs(jchunk).max()
    assert np.abs(tchunk - tdense).max() <= 2e-2 * np.abs(tdense).max()


def test_latent_cache_matches_expanded_on_rtn_int4():
    """``enable_mla_latent_cache`` on a port model RTN-quantized to int4
    g32: the absorbed factors come from the dequantized kv_b, so decode
    over the latent cache reproduces the expanded decode (as JAX's
    ``test_latent_cache_matches_expanded``), within 5e-4."""
    tm = td.DeepseekForCausalLM.from_preset("deepseek-test", device="cpu",
                                            dtype=torch.float32)
    nct.quantize(tm, nct.RTNConfig(dtype="int4", group_size=32))
    assert type(tm.model.layers[0].self_attn.kv_b_proj).__name__ == \
        "WOQLinear"
    assert tm.model.layers[1].mlp.gate.weight.dtype == torch.float32
    ids = torch.from_numpy(ids_of((2, 8), seed=4))
    pos = torch.full((2, 1), 8)
    caches = tm.init_caches(2, 16)
    _, caches = tm(ids, caches=caches, cache_pos=0)
    ref, _ = tm(ids[:, :1], positions=pos, caches=caches, cache_pos=8)
    assert td.enable_mla_latent_cache(tm) == 3
    lc = tm.init_caches(2, 16)
    assert isinstance(lc[0], td.LatentKVCache)
    assert tuple(lc[0].lat.shape) == (2, 1, 16, 24)
    _, lc = tm(ids, caches=lc, cache_pos=0)
    got, _ = tm(ids[:, :1], positions=pos, caches=lc, cache_pos=8)
    np.testing.assert_allclose(f32(got), f32(ref), atol=5e-4)


def test_from_jax_params_quantized_with_meta():
    """A JAX DeepSeek RTN-quantized (int4 g32) and switched to the latent
    cache: its state carries the absorbed factors, which the port takes
    as they are; the same model's state without them makes the port
    recompute them. Both give the same port model, whose greedy tokens
    over the latent cache equal JAX's."""
    jm = jd.DeepseekForCausalLM.from_preset("deepseek-test", seed=7,
                                            dtype=jnp.float32)
    j_quantize(jm, JRTNConfig(dtype="int4", group_size=32))
    meta = jax_meta(jm)
    plain_flat = flat_state(jm)
    j_enable(jm)
    absorbed_flat = flat_state(jm)
    assert any(k.endswith("w_k_absorb") for k in absorbed_flat)
    cfg = port_cfg(jm.cfg, torch.float32)
    a = td.from_jax_params(absorbed_flat, cfg, device="cpu", meta=meta)
    b = td.from_jax_params(plain_flat, cfg, device="cpu", meta=meta)
    assert a.use_latent_cache and not b.use_latent_cache
    td.enable_mla_latent_cache(b)
    for la, lb in zip(a.model.layers, b.model.layers):
        for name in ("w_k_absorb", "w_v_absorb"):
            assert torch.equal(getattr(la.self_attn, name),
                               getattr(lb.self_attn, name))
    assert sum(type(m).__name__ == "WOQLinear" for m in a.modules()) >= 30
    ids = ids_of((1, 8), seed=8)
    want = np.asarray(j_greedy(jm, jnp.asarray(ids), max_new_tokens=6))
    for m in (a, b):
        got = nct.greedy_search(m, torch.from_numpy(ids), max_new_tokens=6)
        np.testing.assert_array_equal(got.numpy(), want)


def test_yarn_and_speculation_raise():
    cfg = td.DeepseekConfig(**dict(td.DEEPSEEK_PRESETS["deepseek-test"],
                                   rope_scaling=dict(type="yarn", factor=40,
                                                     mscale_all_dim=1.0)))
    m = td.DeepseekForCausalLM(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="_rope"):
        m(torch.zeros((1, 4), dtype=torch.long))
    m = td.DeepseekForCausalLM.from_preset("deepseek-test", device="cpu")
    with pytest.raises(NotImplementedError, match="speculat"):
        nct.ngram_speculative_greedy_search(
            m, torch.zeros((1, 4), dtype=torch.long), max_new_tokens=4)
    with pytest.raises(NotImplementedError, match="speculative"):
        nct.ContinuousBatchingEngine(m, n_slots=2, max_len=32,
                                     speculative="ngram")
    td.enable_mla_latent_cache(m)
    with pytest.raises(ValueError, match="speculative"):
        nct.ContinuousBatchingEngine(m, n_slots=2, max_len=32, paged=True,
                                     page_size=8, speculative="ngram")
    m2 = td.DeepseekForCausalLM.from_preset("deepseek-test", device="cpu")
    with pytest.raises(ValueError, match="latent"):
        nct.ContinuousBatchingEngine(m2, n_slots=2, max_len=32, paged=True,
                                     page_size=8)
