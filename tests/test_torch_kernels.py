"""The plain PyTorch versions of the port's three kernels against the JAX
package's kernels, run as its own tests run them on the CPU (the Pallas
W4A8 GEMM and decode attention in interpret mode).

The CUDA kernels themselves cannot run here; ``chip_smoke.py`` holds each
of them against the plain version below on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_compressor_tpu.kernels.decode_attention import \
    decode_attention as j_decode_attention
from neural_compressor_tpu.kernels.w4a8_matmul import w4a8_matmul as j_w4a8
from neural_compressor_tpu.models.llama import RMSNorm as JRMSNorm
from neural_compressor_tpu.ops.packing import pack_qtensor as j_pack
from neural_compressor_tpu.ops.qtensor import quantize_tensor as j_quant
from neural_compressor_tpu_torch.kernels import (decode_attention,
                                                 fused_gemv, fused_matvec,
                                                 w4a8_gemm, w4a8_matmul)
from neural_compressor_tpu_torch.layers.woq_linear import W4A8Linear
from neural_compressor_tpu_torch.ops.packing import PackedWeight, to_hopper

torch.set_num_threads(2)


def _t(a):
    """numpy/JAX array -> torch (bf16 through a uint16 view)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    return torch.from_numpy(a.copy())


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _weights(K, N, seed=0, group_size=128):
    """The same symmetric int4 weight for both packages: (JAX PackedWeight,
    the port's hopper_nk PackedWeight)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    jpw = j_pack(j_quant(jnp.asarray(w), bits=4, group_size=group_size))
    tpw = to_hopper(PackedWeight(_t(jpw.packed), _t(jpw.scales), None, bits=4,
                                 group_size=jpw.group_size, dtype="int",
                                 orig_shape=(K, N), layout="tpu_strided"))
    return jpw, tpw


def _x(M, K, seed=1, dtype=jnp.float32):
    x = np.random.default_rng(seed).standard_normal((M, K)).astype(np.float32)
    return jnp.asarray(x).astype(dtype)


@pytest.mark.parametrize("M", [1, 5, 40])
@pytest.mark.parametrize("K,N", [(256, 256), (512, 768)])
def test_w4a8_gemm_plain_matches_k1(M, K, N):
    jpw, tpw = _weights(K, N, seed=M)
    x = _x(M, K, seed=M + 1)
    jy = np.asarray(j_w4a8(x, jpw))
    ty = w4a8_matmul(_t(x), tpw).numpy()
    # per-group integer partials are exact in float32 (< 2^24), so only
    # the float32 scale folds can round differently
    assert np.abs(ty - jy).max() <= 1e-5 * np.abs(jy).max()


def test_w4a8_gemm_with_group_32():
    jpw, tpw = _weights(256, 512, seed=3, group_size=32)
    x = _x(7, 256, seed=4)
    jy = np.asarray(j_w4a8(x, jpw))
    ty = w4a8_matmul(_t(x), tpw).numpy()
    assert np.abs(ty - jy).max() <= 1e-5 * np.abs(jy).max()


def test_w4a8linear_outside_envelope_takes_jax_fallback():
    # N = 128 is not a multiple of the 256-wide tile: JAX's w4a8_matmul
    # takes its bf16 dequant-and-dot, and so must W4A8Linear
    from neural_compressor_tpu_torch.layers.woq_linear import _dequant_dot

    jpw, tpw = _weights(256, 128, seed=5)
    x = _x(3, 256, seed=6)
    jy = np.asarray(j_w4a8(x, jpw))
    before = _dequant_dot.calls
    ty = W4A8Linear(tpw)(_t(x)).numpy()
    assert _dequant_dot.calls == before + 1
    assert np.abs(ty - jy).max() <= 1e-6 * np.abs(jy).max()


@pytest.mark.parametrize("M", [1, 6])
def test_w4a8linear_matches_k1_in_envelope(M):
    from neural_compressor_tpu_torch.layers.woq_linear import _dequant_dot

    jpw, tpw = _weights(512, 256, seed=7)
    x = _x(M, 512, seed=8)
    before = _dequant_dot.calls
    ty = W4A8Linear(tpw)(_t(x)).numpy()
    assert _dequant_dot.calls == before
    jy = np.asarray(j_w4a8(x, jpw))
    assert np.abs(ty - jy).max() <= 1e-5 * np.abs(jy).max()


@pytest.mark.parametrize("K,N", [(256, 512), (512, 768)])
def test_fused_gemv_plain_without_epilogue_matches_k1(K, N):
    jpw, tpw = _weights(K, N, seed=9)
    x = _x(1, K, seed=10)
    jy = np.asarray(j_w4a8(x, jpw))
    ty = fused_matvec(_t(x), tpw).numpy()
    assert ty.shape == (1, N)
    assert np.abs(ty - jy).max() <= 1e-5 * np.abs(jy).max()


@pytest.mark.parametrize("form", ["rms", "res", "rms+silu", "rms+silu+res",
                                  "bias+res"])
def test_fused_gemv_plain_matches_modular_path(form):
    """The fused forms against JAX's modular path: RMSNorm -> W4A8Linear
    (K1) -> silu(g)*u -> + bias -> + residual. The fold moves where bf16
    rounds (the normalized activation is never materialized, the epilogue
    runs in float32 before one bf16 store), so the two cannot be bit-equal;
    they agree within 3e-2 of max|y|."""
    K, N = 256, 1024
    silu = "silu" in form
    n_out = N // 2 if silu else N
    jpw, tpw = _weights(K, N, seed=11)
    rng = np.random.default_rng(12)
    x = _x(1, K, seed=13, dtype=jnp.bfloat16)
    rms_w = (1.0 + 0.2 * rng.standard_normal(K)).astype(np.float32)
    res = jnp.asarray(rng.standard_normal((1, n_out)).astype(np.float32)
                      ).astype(jnp.bfloat16)
    bias = (0.1 * rng.standard_normal(n_out)).astype(np.float32)
    eps = 1e-5

    h = x
    if "rms" in form:
        norm = JRMSNorm(K, eps, jnp.bfloat16)
        norm.weight[...] = jnp.asarray(rms_w)
        h = norm(x)
    y = j_w4a8(h, jpw)
    if silu:
        g, u = jnp.split(y, 2, axis=-1)
        y = jax.nn.silu(g) * u
    if "bias" in form:
        y = y + jnp.asarray(bias).astype(y.dtype)
    if "res" in form:
        y = y + res
    jy = _f32(y)

    ty = fused_matvec(
        _t(x), tpw, rms_w=torch.from_numpy(rms_w) if "rms" in form else None,
        eps=eps, bias=torch.from_numpy(bias) if "bias" in form else None,
        residual=_t(res) if "res" in form else None, silu_gate=silu)
    assert ty.dtype == torch.bfloat16 and tuple(ty.shape) == (1, n_out)
    assert np.abs(_f32(ty) - jy).max() <= 3e-2 * np.abs(jy).max()


def test_fused_matvec_envelope():
    _jpw, tpw = _weights(256, 512, seed=14)
    x = torch.zeros(1, 256)
    # silu with a bias is not the gate_up bias semantics: modular path
    assert fused_matvec(x, tpw, bias=torch.zeros(256), silu_gate=True) is None
    # M > 1 and groups that are not a multiple of 128 are outside it
    assert fused_matvec(torch.zeros(2, 256), tpw) is None
    _jpw, tpw32 = _weights(256, 512, seed=15, group_size=32)
    assert fused_matvec(x, tpw32) is None


def _attn_inputs(B, H, Hkv, T, D, seed):
    rng = np.random.default_rng(seed)

    def bf(*shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                           ).astype(jnp.bfloat16)

    return (bf(B, H, 1, D), bf(B, Hkv, 1, D), bf(B, Hkv, 1, D),
            bf(B, Hkv, T, D), bf(B, Hkv, T, D))


@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("pos", [0, 16, 31])
def test_decode_attention_plain_matches_k5(H, Hkv, pos):
    T, D = 32, 128
    q, kn, vn, kc, vc = _attn_inputs(1, H, Hkv, T, D, seed=pos + H)
    jo, jk, jv = j_decode_attention(q, kn, vn, kc, vc, pos)
    tk, tv = _t(kc), _t(vc)
    to, tk2, tv2 = decode_attention(_t(q), _t(kn), _t(vn), tk, tv, pos)
    assert tk2 is tk and tv2 is tv          # the port updates in place
    np.testing.assert_array_equal(_f32(tk2), _f32(jk))
    np.testing.assert_array_equal(_f32(tv2), _f32(jv))
    assert to.dtype == torch.bfloat16 and tuple(to.shape) == (1, H, 1, D)
    assert np.abs(_f32(to) - _f32(jo)).max() <= 1e-2


def test_decode_attention_b2_matches_jax():
    """B = 2 through the port's ``decode_attention`` (the rows written in
    place, then K7's plain version) against JAX's (the B=1 kernel K5 in
    interpret mode): the same cache rows bit for bit, the output within
    1e-2 of max|out| (K7 rounds exp(s - m) to bf16 and divides after PV,
    K5 normalises before the cast)."""
    q, kn, vn, kc, vc = _attn_inputs(2, 4, 4, 64, 128, seed=0)
    jo, jk, jv = j_decode_attention(q, kn, vn, kc, vc, 9)
    tk, tv = _t(kc), _t(vc)
    to, tk2, tv2 = decode_attention(_t(q), _t(kn), _t(vn), tk, tv, 9)
    assert tk2 is tk and tv2 is tv          # the port updates in place
    np.testing.assert_array_equal(_f32(tk2), _f32(jk))
    np.testing.assert_array_equal(_f32(tv2), _f32(jv))
    assert to.dtype == torch.bfloat16 and tuple(to.shape) == (2, 4, 1, 128)
    assert np.abs(_f32(to) - _f32(jo)).max() <= 1e-2 * np.abs(_f32(jo)).max()


def test_wrappers_take_plain_versions_on_cpu_and_count_nothing():
    _jpw, tpw = _weights(256, 256, seed=16)
    counts = (w4a8_gemm.launches, fused_gemv.launches)
    xq = torch.zeros(3, 256, dtype=torch.int8)
    w4a8_gemm(xq, tpw.packed, tpw.scales, torch.ones(3))
    fused_gemv(torch.zeros(256, dtype=torch.bfloat16), None, tpw.packed,
               tpw.scales, None, None, eps=0.0, silu=False,
               out_dtype=torch.bfloat16)
    assert (w4a8_gemm.launches, fused_gemv.launches) == counts
