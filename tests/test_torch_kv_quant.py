"""The port's KV-cache quantizers, caches and configs against the JAX
package, on the same numpy inputs.

Quantizers (``ops/kv_quant.py``, re-exported by ``models.llama`` under the
JAX names) must give codes, scales, offsets and packed bytes bit-equal to
the JAX functions under ``jax.jit``, as JAX's generation and serving
programs run them (XLA multiplies by the float32 reciprocal of a constant
divisor), for int8, fp8-e4m3, symmetric int4, the contiguous cache's
D-half-split asymmetric int4 and the pools' token-half-split int4. The
inputs hold all-zero rows (scale 1) and rows whose codes land on exact .5
ties. ``KVCacheQuantConfig`` and ``kv_cache_entry`` must flag models as
JAX's do, and reject what JAX rejects.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_compressor_tpu import quantization as nq
from neural_compressor_tpu.models import llama as jl
import neural_compressor_tpu_torch as nct
from neural_compressor_tpu_torch.models import llama as tl

torch.set_num_threads(2)

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _bits(t: torch.Tensor) -> torch.Tensor:
    """Compare fp8 codes by their bits (NaN-free, but equal bits is the
    claim)."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _assert_same(jax_out, port_out):
    for a, b in zip(jax_out, port_out):
        a = _t(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))


def _rows(seed, shape=(2, 4, 24, 64)):
    """bf16 K/V rows with per-row magnitudes from 1e-3 to 30, an all-zero
    row, a constant row, and rows of exact ties for int8/int4 codes."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape)
         * rng.uniform(1e-3, 30.0, shape[:-1] + (1,))).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 1, 1] = 0.75
    # amax 127 -> scale f32(1/127) * 127; k + 0.5 lands on .5 after / scale
    D = shape[-1]
    x[1, 0, 2] = np.concatenate([[127.0], np.arange(D - 1) % 40 + 0.5])
    x[1, 1, 3] = np.concatenate([[7.0], (np.arange(D - 1) % 7) - 2.5])
    return jnp.asarray(x).astype(jnp.bfloat16)


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3", "int4"])
@pytest.mark.parametrize("seed", [0, 1])
def test_kv_quant_matches_jitted_jax(fmt, seed):
    x = _rows(seed)
    want = jax.jit(lambda a: jl._kv_quant(a, fmt=fmt))(x)
    got = tl._kv_quant(_t(x), fmt)
    assert got[0].dtype == tl._KV_CODE_DTYPES[fmt]
    _assert_same(want, got)
    # dequantization of those codes, as _kv_dequant computes it
    dq = jax.jit(lambda c, s: jl._kv_dequant(c, s, jnp.float32))(*want)
    assert torch.equal(_t(dq), tl._kv_dequant(*got, torch.float32))


@pytest.mark.parametrize("name", ["_kv_quant4_asym", "_kv_quant4_asym_codes"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int4_asym_quantizers_match_jitted_jax(name, seed):
    """Both int4 layouts: the contiguous cache's per-(token, head, D-half)
    affine codes packed along D, and the pools' per-(token, head) affine
    codes (unpacked here, packed token-half-split below)."""
    x = _rows(seed)
    want = jax.jit(getattr(jl, name))(x)
    got = getattr(tl, name)(_t(x))
    _assert_same(want, got)
    if name == "_kv_quant4_asym":
        dq = jax.jit(lambda c, s, o: jl._kv_dequant4_asym(
            c, s, o, jnp.float32))(*want)
        assert torch.equal(_t(dq), tl._kv_dequant4_asym(*got, torch.float32))
        unp = jax.jit(jl._kv_unpack_int4)(want[0])
        assert torch.equal(_t(unp), tl._kv_unpack_int4(got[0]))
        assert torch.equal(_t(jax.jit(jl._kv_codes_int8)(want[0])),
                           tl._kv_codes_int8(got[0]))
    else:
        packed = jax.jit(jl._kv_pack_page_int4)(want[0])
        assert torch.equal(_t(packed), tl._kv_pack_page_int4(got[0]))


def test_fp8_cast_matches_xla_on_every_code_and_tie():
    """``clip(x, -448, 448).to(float8_e4m3fn)`` against XLA's cast on a
    seeded sweep, every e4m3 value, and every midpoint between neighbours
    (the ties, which round to the even code)."""
    vals = np.arange(256, dtype=np.uint8).view(jnp.float8_e4m3fn).astype(
        np.float32)
    vals = np.sort(vals[np.isfinite(vals)])
    mids = (vals[:-1] + vals[1:]) / 2
    rng = np.random.default_rng(3)
    sweep = np.concatenate([vals, mids, np.nextafter(mids, 0),
                            rng.uniform(-460, 460, 20000),
                            rng.standard_normal(20000) * 1e-2]
                           ).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.clip(a, -448.0, 448.0).astype(
        jnp.float8_e4m3fn))(jnp.asarray(sweep))).view(np.uint8)
    got = torch.from_numpy(sweep).clamp(-448.0, 448.0).to(
        torch.float8_e4m3fn).view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", [True, "int8", "fp8_e4m3", "int4"])
def test_init_kv_cache_and_update_cache_match_jax(fmt):
    """``init_kv_cache(quantized=...)`` has JAX's shapes, dtypes and fill;
    ``update_cache`` writes the same codes at a scalar and at per-row
    positions and returns the same dequantized rows."""
    jcfg = jl.LlamaConfig(**SMALL)
    tcfg = tl.LlamaConfig(**SMALL)
    jc = jl.init_kv_cache(jcfg, 2, 16, quantized=fmt)
    tc = tl.init_kv_cache(tcfg, 2, 16, quantized=fmt, device="cpu")
    assert type(tc[0]).__name__ == "QuantKVCache"
    assert tc[0].fmt == jc[0].fmt
    for a, b in zip(jc[0], tc[0]):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(_bits(_t(a)), _bits(b))
    rng = np.random.default_rng(4)
    for pos in (3, np.array([0, 13], np.int32)):
        S = 3
        k = jnp.asarray(rng.standard_normal((2, 2, S, 16)),
                        jnp.float32).astype(jnp.bfloat16)
        v = jnp.asarray(rng.standard_normal((2, 2, S, 16)),
                        jnp.float32).astype(jnp.bfloat16)
        jk, jv, jnew = jax.jit(lambda c, a, b, p: jl.update_cache(
            c, a, b, p, jnp.bfloat16))(jc[0], k, v, jnp.asarray(pos))
        tpos = pos if isinstance(pos, int) else torch.from_numpy(pos)
        tk, tv, tnew = tl.update_cache(tc[0], _t(k), _t(v), tpos,
                                       torch.bfloat16)
        assert tnew is tc[0]                        # written in place
        assert torch.equal(_t(jk), tk) and torch.equal(_t(jv), tv)
        for a, b in zip(jnew, tnew):
            if a is not None:
                assert torch.equal(_bits(_t(a)), _bits(b))
        jc[0] = jnew


def _jax_llama(seed=0):
    from flax import nnx

    return jl.LlamaForCausalLM(jl.LlamaConfig(**SMALL), nnx.Rngs(seed))


@pytest.mark.parametrize("dtype,fmt", [("int8", "int8"), ("fp8", "fp8_e4m3"),
                                       ("float8_e4m3", "fp8_e4m3"),
                                       ("fp8_e4m3", "fp8_e4m3"),
                                       ("int4", "int4")])
def test_kv_cache_config_flags_the_model_as_jax_does(dtype, fmt):
    jm = nq.quantize(_jax_llama(), nq.KVCacheQuantConfig(dtype=dtype))
    tm = nct.quantize(tl.LlamaForCausalLM(tl.LlamaConfig(**SMALL),
                                          device="cpu"),
                      nct.KVCacheQuantConfig(dtype=dtype))
    assert jm.kv_cache_quantized and tm.kv_cache_quantized
    assert tm.kv_cache_format == jm.kv_cache_format == fmt
    # the mapping covers the same attention modules
    info = [("model.layers.0.self_attn", "LlamaAttention"),
            ("model.layers.1.self_attn", "LlamaAttention"),
            ("model.layers.0.mlp", "LlamaMLP"), ("lm_head", "Linear")]
    assert sorted(nct.KVCacheQuantConfig().to_config_mapping(info)) == \
        sorted(nq.KVCacheQuantConfig().to_config_mapping(info))


def test_kv_cache_config_rejects_what_jax_rejects():
    def both(cfg_j, cfg_t, match):
        with pytest.raises(ValueError, match=match):
            nq.quantize(_jax_llama(), cfg_j)
        with pytest.raises(ValueError, match=match):
            nct.quantize(tl.LlamaForCausalLM(tl.LlamaConfig(**SMALL),
                                             device="cpu"), cfg_t)

    # one cache format a model: per-op variants are rejected
    j = nq.KVCacheQuantConfig(dtype="int8")
    j.set_local(r".*layers\.1.*", nq.KVCacheQuantConfig(dtype="int4"))
    t = nct.KVCacheQuantConfig(dtype="int8")
    t.set_local(r".*layers\.1.*", nct.KVCacheQuantConfig(dtype="int4"))
    both(j, t, "model-global")
    both(nq.KVCacheQuantConfig(dtype="int2"),
         nct.KVCacheQuantConfig(dtype="int2"), "unsupported")
    both(nq.KVCacheQuantConfig(dtype="int8", per_channel_k=True),
         nct.KVCacheQuantConfig(dtype="int8", per_channel_k=True),
         "per_channel_k applies")
    # calibrated per-channel int4 K scales: JAX needs a run_fn; the port
    # has no calibration plumbing yet and says what it waits for
    with pytest.raises(NotImplementedError, match="kv_k_scale"):
        nct.quantize(tl.LlamaForCausalLM(tl.LlamaConfig(**SMALL),
                                         device="cpu"),
                     nct.KVCacheQuantConfig(dtype="int4", per_channel_k=True))


def test_rtn_plus_kv_cache_config_sets_both():
    """``RTNConfig + KVCacheQuantConfig`` composes as in JAX: ``quantize``
    applies the members in order (weights quantized, the cache flagged),
    and ``build_quantized`` carries the flag from the per-layer holder to
    the model."""
    rtn = dict(dtype="int4", group_size=32, use_sym=False)
    jcfg = nq.RTNConfig(**rtn) + nq.KVCacheQuantConfig(dtype="int4")
    tcfg = nct.RTNConfig(**rtn) + nct.KVCacheQuantConfig(dtype="int4")
    assert type(tcfg).__name__ == "ComposableConfig"
    assert [c.name for c in tcfg.config_list] == \
        [c.name for c in jcfg.config_list] == ["rtn", "kv_cache"]
    assert tcfg.to_dict().keys() == jcfg.to_dict().keys()
    three = tcfg + nct.RTNConfig(dtype="int8")
    assert [c.name for c in three.config_list] == ["rtn", "kv_cache", "rtn"]
    jm = nq.quantize(_jax_llama(), jcfg)
    tm = nct.quantize(tl.LlamaForCausalLM(tl.LlamaConfig(**SMALL),
                                          device="cpu"), tcfg)
    for m in (jm, tm):
        assert m.kv_cache_quantized and m.kv_cache_format == "int4"
    assert type(tm.model.layers[0].self_attn.q_proj).__name__ == "WOQLinear"
    built = nct.build_quantized(tl.LlamaConfig(**SMALL), nct.RTNConfig(
        quant_lm_head=True, **rtn) + nct.KVCacheQuantConfig(dtype="fp8"),
        device="cpu")
    assert built.kv_cache_quantized and built.kv_cache_format == "fp8_e4m3"
    assert type(built.lm_head).__name__ == "WOQLinear"
