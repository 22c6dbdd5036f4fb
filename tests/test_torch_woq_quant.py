"""The port's weight-only quantization against the JAX package, bit for bit:
asymmetric int4/int2/int8, NF4 and FP4 codes, scales and zero points, the
MSE clip search, double quantization, packed bytes (``force_int8`` and
``perm`` included) and full dequantization (codebooks and the perm
scatter). Inputs are made with numpy from a seed and fed to both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_compressor_tpu.algorithms.rtn import \
    rtn_quantize_kernel as j_rtn_kernel
from neural_compressor_tpu.ops import packing as jpk
from neural_compressor_tpu.ops import qtensor as jqt
from neural_compressor_tpu.quantization import RTNConfig as JRTNConfig
from neural_compressor_tpu_torch.algorithms.rtn import \
    rtn_quantize_kernel as t_rtn_kernel
from neural_compressor_tpu_torch.ops import packing as tpk
from neural_compressor_tpu_torch.ops import qtensor as tqt
from neural_compressor_tpu_torch.quantization import RTNConfig

torch.set_num_threads(2)


def _weights(K=384, N=96, seed=0):
    """Random weights with an all-zero group, a constant group and a
    column shifted off zero (asymmetric ranges)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32)
    w[128:256, 1] = 0.0                        # all-zero group -> scale 1
    w[:128, 3] = 0.75                          # constant group
    w[:, 4] = np.abs(w[:, 4]) + 2.0            # all positive
    return w


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _qt_equal(tq, jq):
    _eq(tq.codes, jq.codes)
    _eq(tq.scales, jq.scales)
    assert (tq.zeros is None) == (jq.zeros is None)
    if tq.zeros is not None:
        _eq(tq.zeros, jq.zeros)
    assert (tq.dtype, tq.bits, tq.group_size, tq.orig_shape) == \
        (jq.dtype, jq.bits, jq.group_size, jq.orig_shape)


CASES = [("asym", "int4"), ("asym", "int2"), ("asym", "int8"),
         ("sym", "int2"), ("sym", "int8"), ("sym", "nf4"), ("sym", "fp4")]


@pytest.mark.parametrize("group_size", [32, 128, -1])
@pytest.mark.parametrize("scheme,dtype", CASES)
def test_codes_scales_zeros_bit_equal(scheme, dtype, group_size):
    w = _weights()
    jq = jqt.quantize_tensor(jnp.asarray(w), group_size=group_size,
                             scheme=scheme, dtype=dtype)
    tq = tqt.quantize_tensor(torch.from_numpy(w), group_size=group_size,
                             scheme=scheme, dtype=dtype)
    _qt_equal(tq, jq)
    _eq(tqt.dequantize(tq), jqt.dequantize(jq))


@pytest.mark.parametrize("scheme,dtype", [("asym", "int4"), ("sym", "nf4"),
                                          ("asym", "int2")])
def test_k_that_pads_to_the_group(scheme, dtype):
    w = _weights(K=300, N=64, seed=3)
    jq = jqt.quantize_tensor(jnp.asarray(w), group_size=128, scheme=scheme,
                             dtype=dtype)
    tq = tqt.quantize_tensor(torch.from_numpy(w), group_size=128,
                             scheme=scheme, dtype=dtype)
    _qt_equal(tq, jq)
    jpw, tpw = jpk.pack_qtensor(jq), tpk.pack_qtensor(tq)
    assert jpw.layout == tpw.layout == "int8"     # K % G != 0
    _eq(tpw.packed, jpw.packed)
    _eq(tpk.dequantize_packed(tpw, torch.float32),
        jpk.dequantize_packed(jpw, jnp.float32))


def test_full_range_and_codebook_ties():
    """Sym int4 full range, and values exactly on NF4/FP4 midpoints
    (searchsorted side="right" sends a tie up)."""
    w = _weights(seed=4)
    for cb_name in ("nf4", "fp4"):
        cb = np.asarray(jqt.CODEBOOKS.host(cb_name))
        mids = (cb[1:] + cb[:-1]) / np.float32(2.0)
        w[:len(mids), 5] = mids                   # absmax of the group is 1
        w[len(mids), 5] = 1.0
        jq = jqt.quantize_tensor(jnp.asarray(w), group_size=32,
                                 dtype=cb_name)
        tq = tqt.quantize_tensor(torch.from_numpy(w), group_size=32,
                                 dtype=cb_name)
        _qt_equal(tq, jq)
    _eq(tqt.CODEBOOKS["fp4"], jqt.CODEBOOKS.host("fp4"))
    jq = jqt.quantize_tensor(jnp.asarray(w), bits=4, group_size=32,
                             full_range=True)
    tq = tqt.quantize_tensor(torch.from_numpy(w), bits=4, group_size=32,
                             full_range=True)
    _qt_equal(tq, jq)


@pytest.mark.parametrize("scheme,dtype,group_size",
                         [("sym", "int4", 32), ("asym", "int4", 128),
                          ("sym", "nf4", 32), ("asym", "int2", 32),
                          ("asym", "int8", -1)])
def test_search_clip_ratios_and_mse_rtn_bit_equal(scheme, dtype, group_size):
    w = _weights(K=256, N=64, seed=5)
    bits = 4 if dtype.startswith(("nf", "fp")) else int(dtype[3:])
    wdt = dtype if dtype in ("nf4", "fp4") else "int"
    jr = jqt.search_clip(jnp.asarray(w), bits=bits, group_size=group_size,
                         scheme=scheme, dtype=wdt)
    tr = tqt.search_clip(torch.from_numpy(w), bits=bits,
                         group_size=group_size, scheme=scheme, dtype=wdt)
    _eq(tr, jr)
    assert float(tr.min()) < 1.0          # the search clipped somewhere
    kw = dict(dtype=dtype, group_size=group_size, use_sym=scheme == "sym",
              use_mse_search=True)
    jq = j_rtn_kernel(jnp.asarray(w), JRTNConfig(**kw))
    tq = t_rtn_kernel(torch.from_numpy(w), RTNConfig(**kw))
    _qt_equal(tq, jq)


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("bits,dq_group", [(8, 256), (6, 5), (4, 3)])
def test_double_quant_codes_and_meta_bit_equal(sym, bits, dq_group):
    w = _weights(K=512, N=64, seed=6)
    jpw = jpk.pack_qtensor(jqt.quantize_tensor(jnp.asarray(w), group_size=32,
                                               scheme="asym"))
    tpw = tpk.pack_qtensor(tqt.quantize_tensor(torch.from_numpy(w),
                                               group_size=32, scheme="asym"))
    jd = jpk.apply_double_quant(jpw, bits=bits, group_size=dq_group, sym=sym)
    td = tpk.apply_double_quant(tpw, bits=bits, group_size=dq_group, sym=sym)
    assert td.scales.dtype == torch.int8
    _eq(td.scales, jd.scales)
    _eq(td.sq_scales, jd.sq_scales)
    assert (td.sq_zeros is None) == (jd.sq_zeros is None) == sym
    if not sym:
        _eq(td.sq_zeros, jd.sq_zeros)
    _eq(tpk.effective_scales(td), jpk.effective_scales(jd))
    _eq(tpk.dequantize_packed(td, torch.float32),
        jpk.dequantize_packed(jd, jnp.float32))
    assert tpk.resolve_double_quant(td).sq_scales is None


@pytest.mark.parametrize("scheme,dtype,group_size",
                         [("asym", "int4", 32), ("asym", "int2", 128),
                          ("sym", "nf4", 64), ("sym", "fp4", -1)])
def test_tpu_strided_bytes_equal(scheme, dtype, group_size):
    w = _weights(K=256, N=64, seed=7)
    jpw = jpk.pack_qtensor(jqt.quantize_tensor(
        jnp.asarray(w), group_size=group_size, scheme=scheme, dtype=dtype))
    tpw = tpk.pack_qtensor(tqt.quantize_tensor(
        torch.from_numpy(w), group_size=group_size, scheme=scheme,
        dtype=dtype))
    assert jpw.layout == tpw.layout == "tpu_strided"
    np.testing.assert_array_equal(tpw.packed.numpy().view(np.uint32),
                                  np.asarray(jpw.packed))
    _eq(tpk.unpack_to_codes(tpw), jpk.unpack_to_codes(jpw))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            tpk.dequantize_packed(tpw, tdt).float().numpy(),
            np.asarray(jpk.dequantize_packed(jpw, jdt).astype(jnp.float32)))


@pytest.mark.parametrize("scheme,dtype", [("asym", "int4"), ("sym", "nf4"),
                                          ("sym", "int2")])
def test_force_int8_and_perm_packing(scheme, dtype):
    w = _weights(K=256, N=64, seed=8)
    perm = np.random.default_rng(9).permutation(256).astype(np.int32)
    jq = jqt.quantize_tensor(jnp.asarray(w[perm]), group_size=32,
                             scheme=scheme, dtype=dtype)
    tq = tqt.quantize_tensor(torch.from_numpy(w[perm]), group_size=32,
                             scheme=scheme, dtype=dtype)
    for force in (False, True):
        jpw = jpk.pack_qtensor(jq, force_int8=force, perm=perm)
        tpw = tpk.pack_qtensor(tq, force_int8=force, perm=perm)
        assert jpw.layout == tpw.layout == ("int8" if force
                                            else "tpu_strided")
        want = np.asarray(jpw.packed)
        got = tpw.packed.numpy()
        np.testing.assert_array_equal(
            got.view(np.uint32) if want.dtype == np.uint32 else got, want)
        _eq(tpw.perm, jpw.perm)
        # dequantization scatters the permuted rows back to their place
        tw = tpk.dequantize_packed(tpw, torch.float32)
        _eq(tw, jpk.dequantize_packed(jpw, jnp.float32))
        np.testing.assert_array_equal(
            tw.numpy()[perm], tqt.dequantize(tq).numpy())
        assert not tpk.hopper_eligible(tpw)


def test_hopper_eligible_refuses_perm_and_double_quant():
    w = _weights(K=256, N=64, seed=10)
    pw = tpk.pack_qtensor(tqt.quantize_tensor(torch.from_numpy(w),
                                              group_size=128))
    assert tpk.hopper_eligible(pw)
    assert not tpk.hopper_eligible(tpk.apply_double_quant(pw))
    assert not tpk.hopper_eligible(pw._replace(
        perm=torch.arange(256, dtype=torch.int32)))
    with pytest.raises(ValueError, match="hopper_nk"):
        tpk.to_hopper(tpk.apply_double_quant(pw))
