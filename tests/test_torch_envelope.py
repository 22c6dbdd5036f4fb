"""The kernels' envelope against the JAX package's dispatch.

Where JAX's dispatcher runs its Pallas kernel, the port's kernel runs (any
rep in K5, K6 and K7: the CUDA kernels split the query rows of a KV head
into groups of at most 8 along a grid axis); where JAX declines and
computes in XLA and the port's kernel cannot take the shape either, the
port's caller takes the same plain path, counted in
``batched_decode_attention.plain_calls``. On the CPU every wrapper runs its
plain version, so these tests hold the dispatch rules (which path, counted
how) and the plain versions at rep 16 and with float32 activations against
JAX; ``chip_smoke.py``'s ``gemma_envelope`` holds the kernels to them on
the card.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from neural_compressor_tpu.generation import greedy_search as j_greedy
from neural_compressor_tpu.kernels import decode_attention as jda
from neural_compressor_tpu.kernels import dequant_matmul as jdm
from neural_compressor_tpu.models import llama as jl
from neural_compressor_tpu_torch.kernels import dequant_matmul as tdm
from neural_compressor_tpu_torch.models import llama as tl
import neural_compressor_tpu_torch as nct

from test_torch_dequant_matmul import _bound, _close, _pair, _x
from test_torch_engine import flat_state

torch.set_num_threads(2)
# the modules, not the functions of the same names that kernels exports
tda = importlib.import_module(
    "neural_compressor_tpu_torch.kernels.decode_attention")
tfm = importlib.import_module("neural_compressor_tpu_torch.kernels.fused_matvec")


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


# (B, Hkv, rep, T, D): JAX's K7 dispatch declines at B == 1, B*Hkv < 16,
# D % 128 or T % 128 (decode_attention.py:722); the port's K7 takes every
# D in BATCHED_KERNEL_D (any D up to 256, and 384, 512) at any B and T, so
# it declines only off both
K7_SHAPES = [(1, 2, 2, 128, 128),     # JAX declines (B == 1), K7 runs
             (4, 4, 2, 256, 128),     # both run
             (4, 4, 2, 100, 128),     # JAX declines (T % 128), K7 runs
             (4, 4, 4, 128, 64),      # JAX declines (D % 128), K7 runs
             (8, 2, 16, 256, 128),    # rep 16: both run
             (4, 4, 2, 128, 16),      # JAX declines (D % 128), K7 runs
             (4, 4, 2, 128, 96),      # JAX declines (D % 128), K7 runs
             (4, 4, 2, 128, 320)]     # both decline: the plain path


@pytest.mark.parametrize("shape", K7_SHAPES,
                         ids=["x".join(map(str, s)) for s in K7_SHAPES])
def test_k7_declines_exactly_where_jax_does(shape):
    B, Hkv, rep, T, D = shape
    rng = np.random.default_rng(sum(shape))
    q = rng.standard_normal((B, Hkv * rep, 1, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    pos = rng.integers(0, T, (B,)).astype(np.int32)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = jda.batched_decode_attention(jq, jk, jv, jnp.asarray(pos))
    before = tda.batched_decode_attention.plain_calls
    got = tda.batched_decode_attention(_bf16(q), _bf16(k), _bf16(v),
                                       torch.from_numpy(pos))
    declines = D not in tda.BATCHED_KERNEL_D and want is None
    assert (got is None) == declines
    assert tda.batched_decode_attention.plain_calls == before + declines
    if got is not None and want is not None:
        np.testing.assert_allclose(
            got.to(torch.float32).numpy(),
            np.asarray(want.astype(jnp.float32)), atol=1e-2)


@pytest.mark.parametrize("mode", ["b1", "b2"])
def test_rep16_llama_greedy_matches_jax(mode):
    """16 query heads on one KV head (rep 16, twice K5/K7's old limit of
    8): B=1 greedy decodes through K5 (JAX: its Pallas kernel in
    interpret mode, rows padded to 16), B=2 through K7 (JAX: XLA, as its
    K7 declines B*Hkv < 16); tokens equal. Prompt seed 8 (8-15 all part
    nowhere): at seed 6 the B=2 run parts at row 0's fourth new token,
    where a full forward gives 252 and 6 at 2.5625 and 2.546875 (one bf16
    ulp) in both packages; at seed 7 at row 1's first, 154 and 28 at
    2.28125 and 2.25 in both, where JAX's own cached prefill takes 28."""
    cfg = dict(vocab_size=256, hidden_size=512, intermediate_size=256,
               num_hidden_layers=2, num_attention_heads=16,
               num_key_value_heads=1, max_position_embeddings=128)
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**cfg), nnx.Rngs(5))
    tcfg = tl.LlamaConfig(**{f.name: getattr(jm.cfg, f.name)
                             for f in dataclasses.fields(jm.cfg)
                             if f.name != "dtype"})
    tm = tl.from_jax_params(flat_state(jm), tcfg, device="cpu")
    B = 1 if mode == "b1" else 2
    ids = np.random.default_rng(8).integers(0, 256, (B, 9))
    want = np.asarray(j_greedy(jm, jnp.asarray(ids), max_new_tokens=6))
    got = nct.greedy_search(tm, torch.from_numpy(ids),
                            max_new_tokens=6).numpy()
    np.testing.assert_array_equal(got, want)


def test_k8_takes_float32_activations():
    """K8's wrapper takes a float32 x (on the card: float32 weights and
    FMAs); its plain version equals JAX's ``dequant_matmul_pallas`` in
    interpret mode on the same f32 x within the float32 sum bound."""
    jpw, tpw = _pair(512, 256, scheme="asym", group_size=64, seed=8)
    jx, tx = _x((12, 512), seed=9)
    jy = jdm.dequant_matmul_pallas(jx, jpw, out_dtype=jnp.float32)
    ty = tdm.dequant_gemm(tx, tpw.packed, tpw.scales, tpw.zeros, None,
                          bits=4, group_size=64, layout="tpu_strided",
                          out_dtype=torch.float32)
    assert tx.dtype == torch.float32 and ty.dtype == torch.float32
    _close(ty, jy, _bound(jx, jpw))


def test_k8_declines_where_jax_falls_back():
    """``woq_matmul``'s K8 path takes ``dequant_dot`` (counted) exactly
    where JAX's kernel does not tile (K % G or N % 128), as JAX falls back
    to XLA (``dequant_matmul.py:455-458``)."""
    for (K, N, G), tiles in (((256, 256, 64), True), ((256, 200, 64), False),
                             ((192, 256, 128), False)):
        assert tdm._tiles_ok(K, N, G) == tiles
        jpw, tpw = _pair(K, N, scheme="asym", group_size=G, seed=K + N)
        jx, tx = _x((4, K), seed=1)
        before = tdm.dequant_dot.calls
        ty = tdm.dequant_matmul(tx, tpw, out_dtype=torch.float32)
        assert tdm.dequant_dot.calls == before + (not tiles)
        jy = jdm.dequant_matmul_pallas(jx, jpw, out_dtype=jnp.float32)
        _close(ty, jy, _bound(jx, jpw))


def test_fused_gemv_takes_wide_k():
    """K4 keeps the activation codes in dynamic shared memory, so K runs
    past the old 48 Ki limit up to ``MAX_K``, and past it from global
    memory (both held on the card by ``chip_smoke.py``); the plain version
    at K = 64 Ki."""
    assert tfm.MAX_K > 48 * 1024
    K, N, G = 64 * 1024, 128, 128
    from neural_compressor_tpu_torch.ops import (pack_qtensor,
                                                 quantize_tensor, to_hopper)

    g = torch.Generator().manual_seed(3)
    w = torch.randn((K, N), generator=g) * K ** -0.5
    pw = to_hopper(pack_qtensor(quantize_tensor(w, bits=4, group_size=G)))
    x = torch.randn((K,), generator=g).to(torch.bfloat16)
    y = tfm.fused_gemv(x, None, pw.packed, pw.scales, None, None, eps=0.0,
                       silu=False, out_dtype=torch.bfloat16)
    assert y.shape == (N,) and bool(torch.isfinite(y.float()).all())
