"""The "s4_rowpack" layout and K2 in the port against the JAX package:
packed words bit-equal, the s4 round trip, K2's plain version against
JAX's K1 (``w4a8_matmul`` on the same codes in "tpu_strided", run in
interpret mode: JAX's ``_s4_impl`` cannot run interpreted, its CPU path is
the bf16 fallback), the envelope's fallback against JAX's ``s4_matmul``,
``to_w4a8_serving(s4=...)`` and ``from_jax_params`` on W4A8 modules.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from neural_compressor_tpu.kernels.s4_matmul import s4_matmul as j_s4_matmul
from neural_compressor_tpu.kernels.w4a8_matmul import \
    w4a8_matmul as j_w4a8_matmul
from neural_compressor_tpu.layers.module_utils import \
    named_modules as j_named_modules
from neural_compressor_tpu.layers.woq_linear import W4A8Linear as JW4A8
from neural_compressor_tpu.models import llama as jl
from neural_compressor_tpu.ops import packing as jpk
from neural_compressor_tpu.ops import qtensor as jqt
from neural_compressor_tpu.algorithms.calib_capture import \
    calibration_forward as j_calibration_forward
from neural_compressor_tpu.quantization import GPTQConfig as JGPTQConfig
from neural_compressor_tpu.quantization import RTNConfig as JRTNConfig
from neural_compressor_tpu.quantization import fuse as jfuse
from neural_compressor_tpu.quantization import quantize as j_quantize
import neural_compressor_tpu_torch as nct
from neural_compressor_tpu_torch.kernels import dequant_dot
from neural_compressor_tpu_torch.layers import W4A8Linear, WOQLinear
from neural_compressor_tpu_torch.ops import PackedWeight
from neural_compressor_tpu_torch.ops import packing as tpk

from test_torch_woq_llama import ENGINE_CFG, _f32, _flat, _meta, _port_cfg
from neural_compressor_tpu_torch.models import llama as tl

torch.set_num_threads(2)

# the module (the package exports a function of its name)
ts4 = importlib.import_module("neural_compressor_tpu_torch.kernels.s4_matmul")


def _words(a) -> torch.Tensor:
    """JAX's uint32 words as the port holds them (int32, same bits)."""
    return torch.from_numpy(np.asarray(a).view(np.int32).copy())


def _pair(K, N, G=128, seed=0, perm=False, dq=False):
    """The same sym-int4 weight packed "tpu_strided" by both packages:
    (JAX PackedWeight, port PackedWeight)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) / 16).astype(np.float32)
    p = rng.permutation(K).astype(np.int32) if perm else None
    jpw = jpk.pack_qtensor(jqt.quantize_tensor(jnp.asarray(w), bits=4,
                                               group_size=G),
                           perm=None if p is None else jnp.asarray(p))
    if dq:
        jpw = jpk.apply_double_quant(jpw)
    tpw = PackedWeight(
        _words(jpw.packed), torch.from_numpy(np.array(jpw.scales)), None,
        bits=4, group_size=G, dtype="int", orig_shape=(K, N),
        layout="tpu_strided",
        perm=None if p is None else torch.from_numpy(p),
        sq_scales=(None if jpw.sq_scales is None
                   else torch.from_numpy(np.array(jpw.sq_scales))),
        sq_zeros=(None if jpw.sq_zeros is None
                  else torch.from_numpy(np.array(jpw.sq_zeros))))
    return jpw, tpw


def test_s4_words_bit_equal_and_round_trip():
    rng = np.random.default_rng(1)
    codes = rng.integers(-8, 8, (64, 256)).astype(np.int8)
    jw = np.asarray(jpk.pack_codes_s4(jnp.asarray(codes)))
    tw = tpk.pack_codes_s4(torch.from_numpy(codes))
    assert tw.dtype == torch.int32 and tuple(tw.shape) == (64, 32)
    np.testing.assert_array_equal(tw.numpy(), jw.view(np.int32))
    np.testing.assert_array_equal(
        tpk.unpack_codes_s4(tw, 64, 256).numpy(), codes)


@pytest.mark.parametrize("perm", [False, True], ids=["plain", "perm"])
def test_to_s4_rowpack_bit_equal(perm):
    jpw, tpw = _pair(256, 512, perm=perm)
    js4, ts4w = jpk.to_s4_rowpack(jpw), tpk.to_s4_rowpack(tpw)
    assert ts4w.layout == "s4_rowpack"
    np.testing.assert_array_equal(ts4w.packed.numpy(),
                                  np.asarray(js4.packed).view(np.int32))
    np.testing.assert_array_equal(
        tpk.dequantize_packed(ts4w, torch.float32).numpy(),
        np.asarray(jpk.dequantize_packed(js4, jnp.float32)))
    with pytest.raises(ValueError, match="s4_rowpack"):
        tpk.to_s4_rowpack(ts4w)


# (K, N, G): N 512 takes K2's N tile 512 at M <= 32, N 768 the tile 256
SHAPES = [(256, 512, 128), (512, 768, 128), (256, 256, 32)]


@pytest.mark.parametrize("M", [1, 5, 40])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("perm", [False, True], ids=["plain", "perm"])
def test_k2_plain_matches_jax_k1_on_the_same_codes(monkeypatch, M, shape,
                                                   perm):
    """``s4_matmul`` inside its envelope runs K2 (its plain version here):
    within 1e-6 of max|y| of JAX's K1 on the same codes in "tpu_strided"
    (the same int32 group partials; XLA may fuse the group fold's
    multiply-add, the port does not)."""
    K, N, G = shape
    jpw, tpw = _pair(K, N, G, seed=M, perm=perm)
    calls = []
    plain = ts4.s4_gemm_plain
    monkeypatch.setattr(ts4, "s4_gemm_plain",
                        lambda *a: calls.append(1) or plain(*a))
    x = np.random.default_rng(M + 7).standard_normal((M, K)).astype(
        np.float32)
    before = dequant_dot.calls
    ty = _f32(ts4.s4_matmul(torch.from_numpy(x), tpk.to_s4_rowpack(tpw)))
    assert calls == [1] and dequant_dot.calls == before
    jy = _f32(j_w4a8_matmul(jnp.asarray(x), jpw))
    assert np.abs(ty - jy).max() <= 1e-6 * np.abs(jy).max()
    # and K2 equals the port's K1 on the same codes bit for bit
    from neural_compressor_tpu_torch.kernels import w4a8_matmul
    np.testing.assert_array_equal(
        ty, _f32(w4a8_matmul(torch.from_numpy(x), tpw)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["n384", "m40_n640", "dq"])
def test_s4_envelope_fallback_matches_jax(case, dtype):
    """Outside K2's envelope (N % 256 at any M, with or without
    double-quantized scales) ``s4_matmul`` takes the bf16 dequant-and-dot
    with no int8 activations, as JAX's does on the CPU. The two sum the
    same bf16 products in float32 in different orders (PyTorch's and
    XLA's CPU matmuls), so a float32 x agrees within 1e-6 of max|y|, and a
    bf16 x, rounded once more to bf16, within one bf16 ulp of max|y|."""
    K, N, M, dq = {"n384": (256, 384, 3, False),
                   "m40_n640": (256, 640, 40, False),
                   "dq": (256, 384, 2, True)}[case]
    jpw, tpw = _pair(K, N, seed=3, dq=dq)
    js4, ts4w = jpk.to_s4_rowpack(jpw), tpk.to_s4_rowpack(tpw)
    x = np.random.default_rng(4).standard_normal((M, K)).astype(np.float32)
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if dtype == "bf16":
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    before = dequant_dot.calls
    ty = _f32(ts4.s4_matmul(tx, ts4w))
    assert dequant_dot.calls == before + 1
    jy = _f32(j_s4_matmul(jx, js4))
    tol = 1e-6 if dtype == "f32" else 2.0 ** -8
    assert np.abs(ty - jy).max() <= tol * np.abs(jy).max()


def test_w4a8linear_dispatch_takes_k2_at_every_m(monkeypatch):
    """A ``W4A8Linear`` on "s4_rowpack" runs ``s4_matmul`` at M = 1 and at
    M > 1, whatever ``M_INT8_THRESHOLD`` is (JAX's order: the layout
    first); on "hopper_nk" at M == 1 the fused GEMV, never K2."""
    jpw, tpw = _pair(256, 512)
    seen = []
    real = ts4.s4_matmul
    monkeypatch.setattr(ts4, "s4_matmul",
                        lambda x, pw: seen.append(x.shape[0]) or real(x, pw))
    monkeypatch.setattr(W4A8Linear, "M_INT8_THRESHOLD", 3)
    mod = W4A8Linear(tpk.to_s4_rowpack(tpw))
    assert mod.layout == "s4_rowpack"
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 256)).astype(np.float32))
    mod(x[:1])
    mod(x)
    assert seen == [1, 4]


def _served_jax(seed: int):
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**ENGINE_CFG), nnx.Rngs(seed))
    j_quantize(jm, JRTNConfig(dtype="int4", group_size=128,
                              quant_lm_head=True))
    jfuse.fuse_for_serving(jm)
    return jm


@pytest.mark.parametrize("s4", ["auto", "s4", True, False])
def test_to_w4a8_serving_layouts_follow_jax(s4):
    """Each value of ``s4``: JAX's "s4"/True and False give the layouts the
    port gives (s4_rowpack where N % 256 == 0, else tpu_strided; or all
    tpu_strided), with the same words; "auto" gives the port's hopper_nk
    (JAX's u4_kpack on a TPU)."""
    jm = _served_jax(2)
    tm = tl.from_jax_params(_flat(jm), _port_cfg(jm.cfg), device="cpu",
                            meta=_meta(jm))
    n = nct.to_w4a8_serving(tm, s4=s4)
    assert n == jfuse.to_w4a8_serving(jm, s4="u4k" if s4 == "auto" else s4)
    jmods = {p: m for p, m in j_named_modules(jm) if type(m) is JW4A8}
    tmods = {p: m for p, m in tm.named_modules() if type(m) is W4A8Linear}
    assert sorted(jmods) == sorted(tmods) and len(tmods) == 2 * 4 + 1
    for p, tmod in tmods.items():
        want = ("hopper_nk" if s4 == "auto" else jmods[p].layout)
        assert tmod.layout == want, p
        if want != "hopper_nk":
            np.testing.assert_array_equal(
                tmod.packed.numpy(),
                np.asarray(jmods[p].packed[...]).view(np.int32))
    if s4 in ("s4", True):
        assert {m.layout for m in tmods.values()} == {"s4_rowpack"}


def test_existing_w4a8_upgraded_in_place(monkeypatch):
    """``W4A8Linear``s already on "tpu_strided" words (hybrid GPTQ's, or
    built under a raised threshold) are upgraded in place, the module
    object kept: to "s4_rowpack" with ``s4="s4"``, bit-equal to JAX's
    in-place upgrade, and to "hopper_nk" with "auto"; ``s4=False`` and
    "auto" under a raised threshold leave them."""
    jm = _served_jax(3)
    jfuse.to_w4a8_serving(jm, s4=False)
    tm = tl.from_jax_params(_flat(jm), _port_cfg(jm.cfg), device="cpu",
                            meta=_meta(jm))
    mods = {p: m for p, m in tm.named_modules() if type(m) is W4A8Linear}
    assert {m.layout for m in mods.values()} == {"tpu_strided"}
    assert nct.to_w4a8_serving(tm, s4=False) == 0
    monkeypatch.setattr(W4A8Linear, "M_INT8_THRESHOLD", 2)
    assert nct.to_w4a8_serving(tm) == 0
    monkeypatch.setattr(W4A8Linear, "M_INT8_THRESHOLD", 1)
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, ENGINE_CFG["vocab_size"], (1, 12)))
    with torch.no_grad():
        before = tm(x)
    assert nct.to_w4a8_serving(tm, s4="s4") == len(mods)
    assert jfuse.to_w4a8_serving(jm, s4="s4") == len(mods)
    jmods = dict(j_named_modules(jm))
    for p, m in tm.named_modules():
        if p in mods:
            assert m is mods[p] and m.layout == "s4_rowpack"
            np.testing.assert_array_equal(
                m.packed.numpy(),
                np.asarray(jmods[p].packed[...]).view(np.int32))
    with torch.no_grad():
        after = tm(x)
    # K1 on tpu_strided words and K2 on the same codes: the same bits
    np.testing.assert_array_equal(_f32(before), _f32(after))
    jm2 = _served_jax(3)
    tm2 = tl.from_jax_params(_flat(jm2), _port_cfg(jm2.cfg), device="cpu",
                             meta=_meta(jm2))
    nct.to_w4a8_serving(tm2)   # WOQLinear -> W4A8Linear on hopper_nk
    assert {m.layout for m in tm2.modules()
            if type(m) is W4A8Linear} == {"hopper_nk"}


@pytest.mark.parametrize("variant", ["hybrid_order", "double_quant"])
def test_to_w4a8_serving_takes_perm_and_double_quant_to_k1_strided(
        monkeypatch, variant):
    """A sym-int4 ``WOQLinear`` with a row permutation (JAX's GPTQ with
    ``hybrid_order``) or double-quantized scales (JAX's RTN with
    ``use_double_quant``) becomes a ``W4A8Linear`` on its "tpu_strided"
    words, as JAX's ``to_w4a8_serving`` makes it (``_w4a8_eligible``);
    "hopper_nk" takes neither. The port serves it on K1's "tpu_strided"
    path (its plain version here, no bf16 fallback): each such module
    within 1e-6 of max|y| of JAX's module (K1 in interpret mode) at M = 1
    and 5, and the bf16 model's logits within 2e-2 of max|logit| of JAX's
    (the tolerance of the W4A8 model tests in ``test_torch_woq_llama.py``:
    one-ulp bf16 roundings between layers part the two)."""
    tw4a8 = importlib.import_module(
        "neural_compressor_tpu_torch.kernels.w4a8_matmul")
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**ENGINE_CFG), nnx.Rngs(6))
    if variant == "hybrid_order":
        rng = np.random.default_rng(6)
        batches = [jnp.asarray(rng.integers(0, ENGINE_CFG["vocab_size"],
                                            (2, 16)).astype(np.int32))
                   for _ in range(2)]
        j_quantize(jm, JGPTQConfig(dtype="int4", group_size=128,
                                   hybrid_order=True, quant_lm_head=True),
                   run_fn=lambda m: j_calibration_forward(m, batches))
        marked = "perm"
    else:
        j_quantize(jm, JRTNConfig(dtype="int4", group_size=128,
                                  use_double_quant=True, quant_lm_head=True))
        marked = "sq_scales"
    tm = tl.from_jax_params(_flat(jm), _port_cfg(jm.cfg), device="cpu",
                            meta=_meta(jm))
    woq = {p for p, m in tm.named_modules() if type(m) is WOQLinear}
    assert len(woq) == 7 * 2 + 1
    assert all(getattr(m, marked) is not None for p, m in tm.named_modules()
               if p in woq)
    assert nct.to_w4a8_serving(tm) == jfuse.to_w4a8_serving(jm) == len(woq)
    jmods = dict(j_named_modules(jm))
    calls = []
    plain = tw4a8.w4a8_gemm_strided_plain
    monkeypatch.setattr(tw4a8, "w4a8_gemm_strided_plain",
                        lambda *a: calls.append(1) or plain(*a))
    before = dequant_dot.calls
    for p, m in tm.named_modules():
        if p not in woq:
            continue
        assert type(m) is W4A8Linear and m.layout == "tpu_strided", p
        assert type(jmods[p]) is JW4A8 and jmods[p].layout == "tpu_strided"
        np.testing.assert_array_equal(
            m.packed.numpy(), np.asarray(jmods[p].packed[...]).view(np.int32))
        for M in (1, 5):
            x = np.random.default_rng(M).standard_normal(
                (M, m.in_features)).astype(np.float32)
            ty = _f32(m(torch.from_numpy(x)))
            jy = _f32(jmods[p](jnp.asarray(x)))
            assert np.abs(ty - jy).max() <= 1e-6 * np.abs(jy).max(), (p, M)
    assert len(calls) == 2 * len(woq) and dequant_dot.calls == before
    ids = np.random.default_rng(7).integers(0, ENGINE_CFG["vocab_size"],
                                            (2, 9)).astype(np.int32)
    with torch.no_grad():
        tl_ = _f32(tm(torch.from_numpy(ids)))
    jl_ = _f32(jm(jnp.asarray(ids)))
    assert dequant_dot.calls == before
    assert np.abs(tl_ - jl_).max() <= 2e-2 * np.abs(jl_).max()


def test_from_jax_params_carries_w4a8_modules_with_perm():
    """A JAX ``W4A8Linear`` on "tpu_strided" or "s4_rowpack" words, with a
    row permutation, loads bit-equal into the port's ``W4A8Linear`` on the
    same layout (the port converts nothing it is given)."""
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**ENGINE_CFG), nnx.Rngs(5))
    j_quantize(jm, JRTNConfig(dtype="int4", group_size=128,
                              quant_lm_head=True))
    mlp = jm.model.layers[0].mlp
    K = mlp.up_proj.in_features
    p = np.random.default_rng(0).permutation(K).astype(np.int32)
    pw = mlp.up_proj.packed_weight()
    codes = np.asarray(jpk.unpack_to_codes(pw))[p]
    jpw = jpk.pack_qtensor(jqt.QTensor(
        jnp.asarray(codes), pw.scales, None, "int", 4, 128,
        pw.orig_shape), perm=jnp.asarray(p))
    mlp.up_proj = JW4A8(jpw)
    gate_strided = JW4A8(mlp.gate_proj.packed_weight())
    mlp.gate_proj = JW4A8(jpk.to_s4_rowpack(gate_strided.packed_weight()))
    tm = tl.from_jax_params(_flat(jm), _port_cfg(jm.cfg), device="cpu",
                            meta=_meta(jm))
    tmlp = tm.model.layers[0].mlp
    assert type(tmlp.up_proj) is W4A8Linear is type(tmlp.gate_proj)
    assert type(tmlp.down_proj) is WOQLinear
    assert tmlp.up_proj.layout == "tpu_strided"
    assert tmlp.gate_proj.layout == "s4_rowpack"
    np.testing.assert_array_equal(tmlp.up_proj.perm.numpy(), p)
    # JAX's s4 words are served by its bf16 fallback off the TPU: the port's
    # K2 is held against JAX's K1 on the same codes in "tpu_strided"
    for tmod, jmod, jref in ((tmlp.up_proj, mlp.up_proj, mlp.up_proj),
                             (tmlp.gate_proj, mlp.gate_proj, gate_strided)):
        np.testing.assert_array_equal(
            tmod.packed.numpy(), np.asarray(jmod.packed[...]).view(np.int32))
        x = np.random.default_rng(2).standard_normal((3, K)).astype(
            np.float32)
        ty = _f32(tmod(torch.from_numpy(x)))
        jy = _f32(jref(jnp.asarray(x)))
        assert np.abs(ty - jy).max() <= 1e-6 * np.abs(jy).max()
