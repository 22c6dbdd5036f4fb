"""The port's quantization math against the JAX package, bit for bit.

Inputs are made with numpy from a seed and handed to both packages; RTN
codes, scales, activation codes and packed bytes must be equal, and the
Hopper serving layout must convert to and from "tpu_strided" exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_compressor_tpu.ops import packing as jpk
from neural_compressor_tpu.ops import qtensor as jqt
from neural_compressor_tpu_torch.ops import packing as tpk
from neural_compressor_tpu_torch.ops import qtensor as tqt

torch.set_num_threads(2)


def _weights(K=384, N=96, seed=0):
    """Random weights with an all-zero group and exact .5 ties."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32)
    w[128:256, 1] = 0.0                       # all-zero group -> scale 1.0
    # column 0, group 0: amax 7 -> scale 1 (sym int4), codes hit .5 ties
    ties = np.array([7.0, 2.5, -3.5, 0.5, 1.5, -0.5, 6.5, -2.5], np.float32)
    w[:128, 0] = np.resize(ties, 128)
    # column 2, group 0: negative max for the full-range path (scale 1)
    w[:128, 2] = np.resize(np.array([-8.0, 3.5, -4.5, 0.5], np.float32), 128)
    return w


@pytest.mark.parametrize("group_size", [128, 32, -1])
@pytest.mark.parametrize("full_range", [False, True])
def test_rtn_int4_codes_and_scales_bit_equal(group_size, full_range):
    w = _weights()
    jq = jqt.quantize_tensor(jnp.asarray(w), bits=4, group_size=group_size,
                             full_range=full_range)
    tq = tqt.quantize_tensor(torch.from_numpy(w), bits=4,
                             group_size=group_size, full_range=full_range)
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    assert tq.group_size == jq.group_size and tq.orig_shape == jq.orig_shape
    if group_size == 128:
        assert float(tq.scales[1, 1]) == 1.0  # the all-zero group
    np.testing.assert_array_equal(tqt.dequantize(tq).numpy(),
                                  np.asarray(jqt.dequantize(jq)))


def test_rtn_pads_k_to_the_group():
    w = _weights(K=300, N=64, seed=3)
    jq = jqt.quantize_tensor(jnp.asarray(w), bits=4, group_size=128)
    tq = tqt.quantize_tensor(torch.from_numpy(w), bits=4, group_size=128)
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))


def test_act_quant_per_token_bit_equal():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((6, 256)) * 3).astype(np.float32)
    x[1] = 0.0                                  # zero row -> scale 1.0
    x[2, :8] = [127.0, 2.5, -3.5, 0.5, 1.5, -0.5, 126.5, -2.5]  # scale 1, ties
    x[2, 8:] = 0.0
    jc, js = jqt.quantize_act_per_token(jnp.asarray(x))
    tc, ts = tqt.quantize_act_per_token(torch.from_numpy(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tc.dtype == torch.int8 and float(ts[1, 0]) == 1.0


def test_act_quant_of_bf16_input_bit_equal():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 512)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(jx).view(np.uint16).copy()).view(
        torch.bfloat16)
    jc, js = jqt.quantize_act_per_token(jx)
    tc, ts = tqt.quantize_act_per_token(tx)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _packed_pair(group_size=128, seed=0):
    w = _weights(seed=seed)
    jpw = jpk.pack_qtensor(jqt.quantize_tensor(jnp.asarray(w), bits=4,
                                               group_size=group_size))
    tpw = tpk.pack_qtensor(tqt.quantize_tensor(torch.from_numpy(w), bits=4,
                                               group_size=group_size))
    return jpw, tpw


@pytest.mark.parametrize("group_size", [128, 32])
def test_tpu_strided_bytes_equal(group_size):
    jpw, tpw = _packed_pair(group_size)
    assert jpw.layout == tpw.layout == "tpu_strided"
    np.testing.assert_array_equal(tpw.packed.numpy().view(np.uint32),
                                  np.asarray(jpw.packed))
    np.testing.assert_array_equal(tpw.scales.numpy(), np.asarray(jpw.scales))


@pytest.mark.parametrize("group_size", [128, 32])
def test_hopper_layout_round_trip_byte_exact(group_size):
    jpw, _ = _packed_pair(group_size, seed=4)
    jbytes = np.asarray(jpw.packed)
    K, N = jpw.orig_shape
    pw = tpk.PackedWeight(torch.from_numpy(jbytes.view(np.int32).copy()),
                          torch.from_numpy(np.asarray(jpw.scales)), None,
                          bits=4, group_size=group_size, dtype="int",
                          orig_shape=(K, N), layout="tpu_strided")
    hop = tpk.to_hopper(pw)
    assert hop.layout == tpk.HOPPER_LAYOUT
    assert hop.packed.dtype == torch.uint8 and tuple(hop.packed.shape) == (N, K // 2)
    # the Hopper bytes hold JAX's codes, two K-adjacent nibbles per byte
    codes = np.asarray(jpk.unpack_to_codes(jpw)).astype(np.int16)
    want = ((codes[0::2] & 0xF) | ((codes[1::2] & 0xF) << 4)).T.astype(np.uint8)
    np.testing.assert_array_equal(hop.packed.numpy(), want)
    back = tpk.to_tpu_strided(hop)
    np.testing.assert_array_equal(back.packed.numpy().view(np.uint32), jbytes)


def test_hopper_unpack_equals_jax_codes():
    jpw, tpw = _packed_pair()
    codes = tpk.unpack_to_codes(tpk.to_hopper(tpw))
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jpk.unpack_to_codes(jpw)))


@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_dequantize_packed_equal(out):
    jpw, tpw = _packed_pair(seed=5)
    jdt, tdt = ((jnp.float32, torch.float32) if out == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jw = np.asarray(jpk.dequantize_packed(jpw, out_dtype=jdt).astype(
        jnp.float32))
    for pw in (tpw, tpk.to_hopper(tpw)):
        tw = tpk.dequantize_packed(pw, out_dtype=tdt).to(torch.float32)
        np.testing.assert_array_equal(tw.numpy(), jw)


def test_asym_and_nf4_quantization_match_jax():
    """Asymmetric int4 and NF4 RTN, which the first slice left raising,
    give JAX's codes, scales and zero points
    (``tests/test_torch_woq_quant.py`` covers the rest)."""
    w = _weights()
    for kw in (dict(bits=4, scheme="asym"), dict(dtype="nf4")):
        jq = jqt.quantize_tensor(jnp.asarray(w), group_size=128, **kw)
        tq = tqt.quantize_tensor(torch.from_numpy(w), group_size=128, **kw)
        np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
        np.testing.assert_array_equal(tq.scales.numpy(),
                                      np.asarray(jq.scales))
        assert (tq.zeros is None) == (jq.zeros is None)
        if tq.zeros is not None:
            np.testing.assert_array_equal(tq.zeros.numpy(),
                                          np.asarray(jq.zeros))
