"""The port's batched decode attention (K7's plain version) and per-slot
cache-row writes against the JAX package, on the same numpy inputs.

JAX runs ``batched_decode_attention`` as its own tests run it on the CPU:
the Pallas kernel in interpret mode, inside its envelope (B > 1,
B*Hkv >= 16, D and T multiples of 128). Outside it JAX falls back to
``_grouped_attention``, which normalises the probabilities before the bf16
cast where K7 normalises after PV; the port's kernel covers those shapes
too, and is held to that fallback within the same tolerance. The CUDA
kernel is held to the plain version on the card by ``chip_smoke.py``.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_compressor_tpu.kernels import decode_attention as jda
from neural_compressor_tpu.models import llama as jl
from neural_compressor_tpu_torch.models import llama as tl

tda = importlib.import_module("neural_compressor_tpu_torch.kernels."
                              "decode_attention")

torch.set_num_threads(2)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf(rng, *shape):
    return jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                       ).astype(jnp.bfloat16)


def _inputs(B, H, Hkv, T, D, seed):
    rng = np.random.default_rng(seed)
    return (_bf(rng, B, H, 1, D), _bf(rng, B, Hkv, T, D),
            _bf(rng, B, Hkv, T, D), rng)


# tests/test_batched_attention.py's bf16 shapes, D = 128, T 256-1024, with
# a scalar and with per-slot positions (at 0 and T - 1 too)
@pytest.mark.parametrize("B,H,Hkv,T,posv", [
    (4, 8, 4, 256, 100),
    (4, 8, 4, 256, None),
    (4, 16, 4, 512, None),
    (16, 4, 4, 1024, 700),
])
def test_batched_plain_matches_k7_interpret(B, H, Hkv, T, posv):
    q, k, v, rng = _inputs(B, H, Hkv, T, 128, seed=T + H)
    if posv is None:
        pos = rng.integers(0, T, (B,)).astype(np.int32)
        pos[0], pos[-1] = 0, T - 1
    else:
        pos = np.full((B,), posv, np.int32)
    jo = jda.batched_decode_attention(q, k, v, jnp.asarray(pos))
    assert jo is not None                  # inside JAX's kernel envelope
    to = tda.batched_decode_attention(_t(q), _t(k), _t(v), _t(pos))
    assert to.dtype == torch.bfloat16 and tuple(to.shape) == (B, H, 1, 128)
    # float32 sum order in the TPU kernel against float64 here: a few bf16
    # ulps at most; 1e-2 of max|out|
    jf = _f32(jo)
    assert np.abs(_f32(to) - jf).max() <= 1e-2 * np.abs(jf).max()


@pytest.mark.parametrize("B,H,Hkv,T,D", [
    (2, 8, 2, 40, 64),        # B*Hkv < 16, T and D not multiples of 128
    (3, 8, 1, 100, 32),       # rep 8
    (2, 4, 4, 130, 256),
])
def test_batched_plain_outside_jax_envelope_matches_grouped(B, H, Hkv, T, D):
    """JAX returns None here and serves these shapes with
    ``_grouped_attention`` (normalise, then bf16, then PV); the port's
    kernel order (bf16 exp, PV, then divide) agrees within 1e-2 of
    max|out|."""
    q, k, v, rng = _inputs(B, H, Hkv, T, D, seed=D + T)
    pos = rng.integers(0, T, (B,)).astype(np.int32)
    pos[0] = T - 1
    assert jda.batched_decode_attention(q, k, v, jnp.asarray(pos)) is None
    mask = (jnp.arange(T)[None, None, None, :]
            <= jnp.asarray(pos)[:, None, None, None])
    jo = jl._grouped_attention(q, k, v, mask, D)
    to = tda.batched_decode_attention(_t(q), _t(k), _t(v), _t(pos))
    jf = _f32(jo)
    assert np.abs(_f32(to) - jf).max() <= 1e-2 * np.abs(jf).max()


def test_batched_plain_past_the_end_attends_every_row():
    # idle engine slots run on past T - 1 inside a multi-step dispatch
    q, k, v, _rng = _inputs(2, 4, 4, 64, 64, seed=1)
    pos = torch.tensor([63, 70], dtype=torch.int32)
    out = tda.batched_decode_attn_plain(_t(q)[:, :, 0], _t(k), _t(v), pos)
    assert torch.equal(out[1], tda.batched_decode_attn_plain(
        _t(q)[1:, :, 0], _t(k)[1:], _t(v)[1:],
        torch.tensor([63], dtype=torch.int32))[0])


def test_batched_int_pos_is_every_slot_at_that_pos():
    q, k, v, _rng = _inputs(3, 8, 2, 64, 64, seed=2)
    a = tda.batched_decode_attention(_t(q), _t(k), _t(v), 17)
    b = tda.batched_decode_attention(_t(q), _t(k), _t(v),
                                     torch.full((3,), 17, dtype=torch.int32))
    assert torch.equal(a, b)
    # the same over int8 codes with scales (K7's quantized branch)
    kc, ks = tl._kv_quant(_t(k), "int8")
    vc, vs = tl._kv_quant(_t(v), "int8")
    a = tda.batched_decode_attention(_t(q), kc, vc, 17, ks, vs)
    b = tda.batched_decode_attention(_t(q), kc, vc,
                                     torch.full((3,), 17, dtype=torch.int32),
                                     ks, vs)
    assert torch.equal(a, b)


@pytest.mark.parametrize("S,starts", [
    (1, [0, 5, 63, 63]),
    (1, [70, 64, 2, 100]),       # past the end: clamped to T - 1
    (8, [0, 8, 56, 60]),         # 60 + 8 > 64: clamped to 56
    (8, [3, 100, 17, 56]),
])
def test_update_rows_per_slot_matches_jax_with_clamp(S, starts):
    rng = np.random.default_rng(S)
    cache = _bf(rng, 4, 2, 64, 32)
    new = _bf(rng, 4, 2, S, 32)
    pos = np.asarray(starts, np.int32)
    want = jl._update_rows(cache, new, jnp.asarray(pos))
    got = tl._update_rows(_t(cache), _t(new), torch.from_numpy(pos))
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("start", [0, 30, 60])
def test_update_rows_scalar_clamps_like_jax(start):
    rng = np.random.default_rng(start)
    cache, new = _bf(rng, 2, 2, 64, 32), _bf(rng, 2, 2, 8, 32)
    want = jl._update_rows(cache, new, start)
    got = tl._update_rows(_t(cache), _t(new), start)
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_model_forward_with_per_slot_positions_matches_jax():
    """One B = 4 decode step of a small model with [B] positions: the
    cache mask (``LlamaModel.forward``) and K7 inside JAX's envelope."""
    import dataclasses

    from flax import nnx

    cfg = dict(vocab_size=256, hidden_size=512, intermediate_size=256,
               num_hidden_layers=1, num_attention_heads=4,
               num_key_value_heads=4, max_position_embeddings=128)
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**cfg), nnx.Rngs(0))
    flat = {".".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.state(jm).flat_state()}
    tcfg = tl.LlamaConfig(**{f.name: getattr(jm.cfg, f.name)
                             for f in dataclasses.fields(jm.cfg)
                             if f.name != "dtype"})
    tm = tl.from_jax_params(flat, tcfg, device="cpu")
    B, T = 4, 128
    rng = np.random.default_rng(7)
    jc = [jl.KVCache(_bf(rng, B, 4, T, 128), _bf(rng, B, 4, T, 128))]
    tc = [tl.KVCache(_t(c.k), _t(c.v)) for c in jc]
    pos = np.asarray([3, 64, 127, 20], np.int32)
    tok = rng.integers(0, 256, (B, 1)).astype(np.int32)
    jy, jc = jm(jnp.asarray(tok), jnp.asarray(pos)[:, None], jc,
                jnp.asarray(pos))
    with torch.no_grad():
        ty, tc = tm(torch.from_numpy(tok), torch.from_numpy(pos)[:, None], tc,
                    torch.from_numpy(pos))
    np.testing.assert_array_equal(_f32(tc[0].k), _f32(jc[0].k))
    jf = _f32(jy)
    assert np.abs(_f32(ty) - jf).max() <= 2e-2 * np.abs(jf).max()
