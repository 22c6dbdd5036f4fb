"""K10 and K1's "tpu_strided" loader in the port against the JAX package:
the plain versions that CPU tensors run, held against JAX's Pallas kernels
in interpret mode on the same words (``vpu_matvec_int8act`` and
``w4a8_matmul``), and the envelope each declines outside of, as JAX's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_compressor_tpu.kernels.dequant_matmul import \
    vpu_matvec_int8act as j_k10
from neural_compressor_tpu.kernels.w4a8_matmul import \
    w4a8_matmul as j_w4a8_matmul
from neural_compressor_tpu.ops import packing as jpk
from neural_compressor_tpu.ops import qtensor as jqt
from neural_compressor_tpu_torch.kernels import dequant_dot
from neural_compressor_tpu_torch.kernels import dequant_matmul as tdm
from neural_compressor_tpu_torch.kernels import w4a8_gemm_strided
from neural_compressor_tpu_torch.kernels.w4a8_matmul import w4a8_matmul
from neural_compressor_tpu_torch.ops import PackedWeight

torch.set_num_threads(2)


def _pair(K, N, G, bits=4, scheme="sym", dtype="int", seed=0, perm=False,
          dq=False):
    """One seeded weight packed by JAX, and the port's PackedWeight on the
    same bytes."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) / 16).astype(np.float32)
    p = rng.permutation(K).astype(np.int32) if perm else None
    jpw = jpk.pack_qtensor(jqt.quantize_tensor(
        jnp.asarray(w), bits=bits, group_size=G, scheme=scheme, dtype=dtype),
        perm=None if p is None else jnp.asarray(p))
    if dq:
        jpw = jpk.apply_double_quant(jpw)

    def t(a):
        if a is None:
            return None
        a = np.array(a)
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                else a)

    tpw = PackedWeight(t(jpw.packed), t(jpw.scales), t(jpw.zeros),
                       bits=jpw.bits, group_size=jpw.group_size,
                       dtype=jpw.dtype, orig_shape=(K, N), layout=jpw.layout,
                       perm=t(jpw.perm), sq_scales=t(jpw.sq_scales),
                       sq_zeros=t(jpw.sq_zeros))
    return jpw, tpw, rng


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# (K, N, G, bits, scheme): the main path's int4 g128 shapes at a small
# size (several K tiles, N tiles of 512/256/128), asym, int2, group 32
K10_CASES = [(2048, 512, 128, 4, "sym"), (1024, 384, 128, 4, "asym"),
             (512, 256, 64, 2, "sym"), (1024, 128, 32, 2, "asym"),
             (256, 640, 256, 4, "sym")]


@pytest.mark.parametrize("xdtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", K10_CASES,
                         ids=lambda c: "_".join(map(str, c)))
def test_k10_plain_matches_jax(case, xdtype):
    """K10's plain version against JAX's ``vpu_matvec_int8act`` (interpret
    mode) on the same words: within 1e-6 of max|y|, bit-equal where XLA's
    CPU program sums the tile's groups in order with fused multiply-adds as
    the port does (most shapes); the int8 codes and every integer sum are
    exact in both."""
    K, N, G, bits, scheme = case
    jpw, tpw, rng = _pair(K, N, G, bits, scheme)
    x = rng.standard_normal((1, K)).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    if xdtype == "bf16":
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    ty = _f32(tdm.vpu_matvec_int8act(tx, tpw, out_dtype=torch.float32))
    jy = _f32(j_k10(jx, jpw, out_dtype=jnp.float32))
    assert np.abs(ty - jy).max() <= 1e-6 * np.abs(jy).max()


@pytest.mark.parametrize("variant", ["perm", "double_quant", "bf16_out"])
def test_k10_perm_double_quant_and_bf16_out(variant):
    """``perm`` gathered and double-quantized scales resolved before the
    kernel, as JAX's; a bf16 result rounded once from the float32 sum."""
    jpw, tpw, rng = _pair(1024, 512, 128, perm=variant == "perm",
                          dq=variant == "double_quant", seed=3)
    x = rng.standard_normal((1, 1024)).astype(np.float32)
    out = (torch.bfloat16, jnp.bfloat16) if variant == "bf16_out" else \
        (torch.float32, jnp.float32)
    ty = _f32(tdm.vpu_matvec_int8act(torch.from_numpy(x), tpw,
                                     out_dtype=out[0]))
    jy = _f32(j_k10(jnp.asarray(x), jpw, out_dtype=out[1]))
    tol = 2.0 ** -8 if variant == "bf16_out" else 1e-6
    assert np.abs(ty - jy).max() <= tol * np.abs(jy).max()


@pytest.mark.parametrize("why", ["m2", "int8_layout", "nf4", "n96"])
def test_k10_declines_where_jax_declines(why):
    """None where JAX's ``vpu_matvec_int8act`` returns None: M != 1, a
    layout other than "tpu_strided" (8-bit codes), codebook dtypes, a
    shape ``_vpu_tiles`` does not tile (N % 128)."""
    kw = {"m2": {}, "int8_layout": dict(bits=8), "nf4": dict(dtype="nf4"),
          "n96": {}}[why]
    N = 96 if why == "n96" else 256
    jpw, tpw, rng = _pair(256, N, 128, **kw)
    M = 2 if why == "m2" else 1
    x = rng.standard_normal((M, 256)).astype(np.float32)
    assert j_k10(jnp.asarray(x), jpw) is None
    assert tdm.vpu_matvec_int8act(torch.from_numpy(x), tpw) is None


def test_fma_f32_is_one_rounding():
    """The plain K10's fused multiply-add: a * b + c rounded once, where
    separate float32 roundings differ (checked against exact rationals)."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a = rng.standard_normal(4000).astype(np.float32)
    b = (rng.standard_normal(4000) * 1e4).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + 1e-7 * rng.standard_normal(
        4000))).astype(np.float32)
    got = tdm.fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    for i in range(0, 4000, 7):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + \
            Fraction(float(c[i]))
        cands = np.array([got[i], np.nextafter(got[i], np.inf),
                          np.nextafter(got[i], -np.inf)], np.float32)
        errs = [abs(Fraction(float(v)) - exact) for v in cands]
        assert errs[0] <= min(errs), i
    assert (got != (a * b + c)).any()   # separate roundings do differ


@pytest.mark.parametrize("G", [8, 32, 128, 256])
@pytest.mark.parametrize("M", [4, 37])
def test_k1_strided_plain_matches_jax_k1(G, M):
    """K1 on "tpu_strided" words (``w4a8_gemm_strided``'s plain version,
    through ``w4a8_matmul``) against JAX's K1 in interpret mode, every
    group size its loaders take (the general path below 32): within 1e-6
    of max|y|."""
    K, N = 512, 256
    jpw, tpw, rng = _pair(K, N, G, seed=G + M)
    x = rng.standard_normal((M, K)).astype(np.float32)
    before = (dequant_dot.calls, w4a8_gemm_strided.launches)
    ty = _f32(w4a8_matmul(torch.from_numpy(x), tpw))
    assert (dequant_dot.calls, w4a8_gemm_strided.launches) == before
    jy = _f32(j_w4a8_matmul(jnp.asarray(x), jpw))
    assert np.abs(ty - jy).max() <= 1e-6 * np.abs(jy).max()


@pytest.mark.parametrize("why", ["asym", "n128", "int2"])
def test_k1_strided_falls_back_where_jax_does(why):
    """Outside JAX's K1 envelope (asymmetric weights, N % 256, int2) the
    bf16 dequant-and-dot, as JAX's ``w4a8_matmul``: within 1e-6."""
    kw = {"asym": dict(scheme="asym"), "n128": {}, "int2": dict(bits=2)}[why]
    N = 128 if why == "n128" else 256
    jpw, tpw, rng = _pair(256, N, 128, **kw)
    x = rng.standard_normal((5, 256)).astype(np.float32)
    before = dequant_dot.calls
    ty = _f32(w4a8_matmul(torch.from_numpy(x), tpw))
    assert dequant_dot.calls == before + 1
    jy = _f32(j_w4a8_matmul(jnp.asarray(x), jpw))
    assert np.abs(ty - jy).max() <= 1e-6 * np.abs(jy).max()
