"""The plain versions of K8 (``dequant_gemm``) and K9 (``vpu_gemv``)
against the JAX package's Pallas kernels run in interpret mode, as its own
tests run them on the CPU (``tests/test_kernels.py``), and ``woq_matmul``'s
dispatch against JAX's.

Tolerances: both sides multiply the same (equally rounded) weights and
accumulate in float32 in different orders, so outputs are compared at
float32 within the float32 summation bound ``4 K 2^-24 (|x| @ |W|)``.
The CUDA kernels cannot run here; ``chip_smoke.py`` holds them against
these plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_compressor_tpu.kernels import dequant_matmul as jdm
from neural_compressor_tpu.ops import packing as jpk
from neural_compressor_tpu.ops import qtensor as jqt
from neural_compressor_tpu_torch.kernels import dequant_matmul as tdm
from neural_compressor_tpu_torch.ops import packing as tpk

torch.set_num_threads(2)


def _t(a):
    """numpy/JAX array -> torch (bf16 through a uint16 view, uint32 words
    as int32 with the same bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    return torch.from_numpy(a.copy())


def _f64(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).astype(np.float64)


def _pair(K, N, *, scheme="sym", dtype="int", bits=4, group_size=32, seed=0,
          perm=False, dq=False):
    """The same packed weight in both packages: (JAX PackedWeight, the
    port's PackedWeight from JAX's arrays)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32)
    p = rng.permutation(K).astype(np.int32) if perm else None
    jq = jqt.quantize_tensor(jnp.asarray(w if p is None else w[p]), bits=bits,
                             group_size=group_size, scheme=scheme, dtype=dtype)
    jpw = jpk.pack_qtensor(jq, perm=p)
    if dq:
        jpw = jpk.apply_double_quant(jpw, bits=8, group_size=4)
    tpw = tpk.PackedWeight(
        _t(jpw.packed), _t(jpw.scales),
        None if jpw.zeros is None else _t(jpw.zeros), bits=jpw.bits,
        group_size=jpw.group_size, dtype=jpw.dtype, orig_shape=(K, N),
        layout=jpw.layout, perm=None if jpw.perm is None else _t(jpw.perm),
        sq_scales=None if jpw.sq_scales is None else _t(jpw.sq_scales),
        sq_zeros=None if jpw.sq_zeros is None else _t(jpw.sq_zeros))
    return jpw, tpw


def _x(shape, seed=1, dtype=jnp.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    return jx, _t(jx)


def _bound(jx, jpw):
    """4 K 2^-24 (|x| @ |W|): float32 summation in two orders."""
    K = jpw.orig_shape[0]
    w = np.abs(np.asarray(jpk.dequantize_packed(jpw, out_dtype=jnp.float32)))
    if jpw.perm is not None:
        w = w[np.asarray(jpw.perm)]
        jx = jnp.take(jx, jpw.perm, axis=-1)
    return 4 * K * 2.0 ** -24 * (np.abs(_f64(jx)) @ w.astype(np.float64))


def _close(ty, jy, bound):
    d = np.abs(_f64(ty) - _f64(jy))
    assert np.all(d <= bound + 1e-30), float((d - bound).max())


# the seven dtype/scheme cases of tests/test_kernels.py
SEVEN = [("sym", "int", 4), ("asym", "int", 4), ("sym", "nf4", 4),
         ("sym", "fp4", 4), ("sym", "int", 2), ("sym", "int", 8),
         ("asym", "int", 8)]


@pytest.mark.parametrize("xdtype", ["f32", "bf16"])
@pytest.mark.parametrize("scheme,dtype,bits", SEVEN)
def test_plain_k8_matches_pallas(scheme, dtype, bits, xdtype):
    jpw, tpw = _pair(256, 256, scheme=scheme, dtype=dtype, bits=bits)
    jx, tx = _x((8, 256), dtype=jnp.float32 if xdtype == "f32"
                else jnp.bfloat16)
    jy = jdm.dequant_matmul_pallas(jx, jpw, out_dtype=jnp.float32)
    before = tdm.dequant_dot.calls
    ty = tdm.dequant_matmul(tx, tpw, out_dtype=torch.float32)
    assert tdm.dequant_dot.calls == before        # the shape tiles: K8
    assert ty.dtype == torch.float32 and ty.shape == (8, 256)
    _close(ty, jy, _bound(jx, jpw))


@pytest.mark.parametrize("shape", [(5, 256), (20, 256), (2, 3, 256),
                                   (256, 256)])
def test_plain_k8_ragged_m_and_3d_x(shape):
    jpw, tpw = _pair(256, 384, scheme="asym", group_size=64, seed=2)
    jx, tx = _x(shape, seed=3, dtype=jnp.bfloat16)
    jy = jdm.dequant_matmul_pallas(jx, jpw)
    ty = tdm.dequant_matmul(tx, tpw)
    assert ty.dtype == torch.bfloat16 and tuple(ty.shape) == (*shape[:-1],
                                                             384)
    # bf16 outputs: at most one bf16 rounding apart beyond the sum bound
    d = np.abs(_f64(ty) - _f64(jy))
    assert np.all(d <= 2.0 ** -7 * np.abs(_f64(jy)) + _bound(jx, jpw))


@pytest.mark.parametrize("case", ["perm", "double_quant", "per_channel",
                                  "int2_asym"])
def test_plain_k8_perm_double_quant_and_groups(case):
    kw = {"perm": dict(perm=True), "double_quant": dict(dq=True),
          "per_channel": dict(group_size=-1, scheme="asym"),
          "int2_asym": dict(bits=2, scheme="asym")}[case]
    jpw, tpw = _pair(256, 256, seed=4, **kw)
    jx, tx = _x((6, 256), seed=5)
    jy = jdm.dequant_matmul_pallas(jx, jpw, out_dtype=jnp.float32)
    ty = tdm.dequant_matmul(tx, tpw, out_dtype=torch.float32)
    _close(ty, jy, _bound(jx, jpw))


@pytest.mark.parametrize("dtype", ["nf4", "fp4"])
def test_plain_k8_codebook_in_the_int8_layout_dequantizes(dtype):
    """Codebook indices stored as "int8" codes: the port's K8 looks them
    up as ``dequantize_packed`` does (JAX's int8 kernel body skips the
    lookup; ROADMAP.md, Queue 3), so it is held to JAX's dequantization."""
    rng = np.random.default_rng(15)
    w = rng.standard_normal((256, 256)).astype(np.float32)
    jpw = jpk.pack_qtensor(jqt.quantize_tensor(jnp.asarray(w), group_size=32,
                                               dtype=dtype), force_int8=True)
    tpw = tpk.PackedWeight(_t(jpw.packed), _t(jpw.scales), None, bits=4,
                           group_size=32, dtype=dtype, orig_shape=(256, 256),
                           layout="int8")
    jx, tx = _x((4, 256), seed=16)
    jy = jx @ jpk.dequantize_packed(jpw, out_dtype=jnp.float32)
    ty = tdm.dequant_matmul(tx, tpw, out_dtype=torch.float32)
    _close(ty, jy, _bound(jx, jpw))


def test_plain_k8_off_the_tiles_takes_the_dot():
    # N = 200 does not tile: JAX and the port both dequantize and dot
    jpw, tpw = _pair(256, 200, scheme="asym", seed=6)
    jx, tx = _x((4, 256), seed=7)
    jy = jdm.dequant_matmul_pallas(jx, jpw, out_dtype=jnp.float32)
    before = tdm.dequant_dot.calls
    ty = tdm.dequant_matmul(tx, tpw, out_dtype=torch.float32)
    assert tdm.dequant_dot.calls == before + 1
    _close(ty, jy, _bound(jx, jpw))


@pytest.mark.parametrize("scheme,bits,kw", [
    ("sym", 4, {}), ("asym", 4, {}), ("sym", 2, {}),
    ("sym", 4, dict(perm=True)), ("asym", 2, dict(dq=True))])
def test_plain_k9_matches_vpu_matvec(scheme, bits, kw):
    jpw, tpw = _pair(512, 640, scheme=scheme, bits=bits, group_size=128,
                     seed=8, **kw)
    jx, tx = _x((1, 512), seed=9)
    jy = jdm.vpu_matvec(jx, jpw, out_dtype=jnp.float32)
    ty = tdm.vpu_matvec(tx, tpw, out_dtype=torch.float32)
    assert jy is not None and ty is not None and ty.shape == (1, 640)
    _close(ty, jy, _bound(jx, jpw))


def test_plain_k9_bf16_x_and_output():
    jpw, tpw = _pair(256, 512, scheme="asym", group_size=32, seed=10)
    jx, tx = _x((1, 1, 256), seed=11, dtype=jnp.bfloat16)
    jy = jdm.vpu_matvec(jx, jpw)
    ty = tdm.vpu_matvec(tx, tpw)
    assert ty.dtype == torch.bfloat16 and tuple(ty.shape) == (1, 1, 512)
    d = np.abs(_f64(ty) - _f64(jy))
    assert np.all(d <= 2.0 ** -7 * np.abs(_f64(jy)) + _bound(jx, jpw))


@pytest.mark.parametrize("case", ["m2", "nf4", "int8_layout", "int8_bits",
                                  "n_ragged", "g_small"])
def test_k9_declines_where_jax_declines(case):
    kw, shape, N = {"m2": ({}, (2, 256), 256),
                    "nf4": (dict(dtype="nf4"), (1, 256), 256),
                    "int8_layout": (dict(bits=8), (1, 256), 256),
                    "int8_bits": (dict(bits=8, scheme="asym"), (1, 256), 256),
                    "n_ragged": ({}, (1, 256), 200),
                    "g_small": (dict(bits=2, group_size=8), (1, 256), 256),
                    }[case]
    jpw, tpw = _pair(256, N, seed=12, **kw)
    jx, tx = _x(shape, seed=13)
    assert jdm.vpu_matvec(jx, jpw) is None
    assert tdm.vpu_matvec(tx, tpw) is None


def _spy_port(monkeypatch, on_card):
    seen = []
    monkeypatch.setattr(tdm, "_on_card", lambda x: on_card)
    for name, tag in (("vpu_gemv", "vpu"), ("dequant_gemm", "pallas")):
        real = getattr(tdm, name)

        def spy(*a, _real=real, _tag=tag, **k):
            seen.append(_tag)
            return _real(*a, **k)

        monkeypatch.setattr(tdm, name, spy)
    real_dot = tdm.dequant_dot

    def dot(*a, **k):
        seen.append("xla")
        return real_dot(*a, **k)

    dot.calls = 0     # the real function counts through the module's name
    monkeypatch.setattr(tdm, "dequant_dot", dot)
    return seen


def _spy_jax(monkeypatch, on_tpu):
    """JAX's choice: which of its three paths ``woq_matmul`` reaches. Its
    kernels run in interpret mode (or are replaced by their XLA
    equivalent) so that nothing needs a TPU."""
    seen, state = [], {"tpu": on_tpu}
    monkeypatch.setattr(jdm, "_on_tpu", lambda: state["tpu"])
    real_vpu = jdm.vpu_matvec

    def vpu(x, pw, out_dtype=None):
        state["tpu"] = False               # interpret mode on the CPU
        try:
            y = real_vpu(x, pw, out_dtype)
        finally:
            state["tpu"] = on_tpu
        if y is not None:
            seen.append("vpu")
        return y

    def pallas(x, pw, out_dtype=None):
        seen.append("pallas")
        return jnp.dot(x, jpk.dequantize_packed(pw, jnp.float32))

    real_deq = jdm.dequantize_packed

    def deq(pw, out_dtype=jnp.bfloat16):
        seen.append("xla")
        return real_deq(pw, out_dtype=out_dtype)

    monkeypatch.setattr(jdm, "vpu_matvec", vpu)
    monkeypatch.setattr(jdm, "dequant_matmul_pallas", pallas)
    monkeypatch.setattr(jdm, "dequantize_packed", deq)
    return seen


@pytest.mark.parametrize("on_card", [True, False])
@pytest.mark.parametrize("impl", ["auto", "vpu", "pallas", "xla"])
def test_woq_matmul_dispatch_matches_jax(monkeypatch, impl, on_card):
    """For each impl, on the card (JAX: on the TPU) and off it, the port
    reaches the same path as JAX for M = 1, 2, 256, 257, for an f32 x, a
    codebook weight and a shape K9 declines."""
    cases = [((1, 256), {}), ((2, 256), {}), ((256, 256), {}),
             ((257, 256), {}), ((1, 256), dict(dtype="nf4")),
             ((1, 256), dict(bits=8))]
    for shape, kw in cases:
        jpw, tpw = _pair(256, 256, seed=14, **kw)
        jx, tx = _x(shape, seed=15)
        with monkeypatch.context() as m:
            jseen = _spy_jax(m, on_card)
            jdm.woq_matmul(jx, jpw, impl=impl)
        with monkeypatch.context() as m:
            tseen = _spy_port(m, on_card)
            tdm.woq_matmul(tx, tpw, impl=impl)
        assert tseen == jseen and len(tseen) == 1, (shape, kw, tseen,
                                                    jseen)


def test_set_default_impl(monkeypatch):
    monkeypatch.setattr(tdm, "_DEFAULT_IMPL", "auto")
    jpw, tpw = _pair(256, 256, seed=16)
    _jx, tx = _x((1, 256), seed=17)
    tdm.set_default_impl("vpu")
    before = tdm.dequant_dot.calls
    tdm.woq_matmul(tx, tpw)
    assert tdm.dequant_dot.calls == before        # plain K9, no dot
    tdm.set_default_impl("auto")
    tdm.woq_matmul(tx, tpw)
    assert tdm.dequant_dot.calls == before + 1    # off the card: the dot
    with pytest.raises(ValueError, match="impl"):
        tdm.set_default_impl("mosaic")
