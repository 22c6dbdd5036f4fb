"""Weight-only (W4A16) Llama serving in the port against the JAX package:
``WOQLinear`` models quantized by either package (asymmetric int4, NF4,
symmetric int4) and carried across with ``from_jax_params``; the trained
checkpoints are in ``test_torch_woq_tiny.py``, which shares these
helpers.

Both packages run ``woq_matmul``'s "auto" off their accelerator, which is
dequantize-then-dot: the weight rounded to bf16, the product accumulated in
float32 (in different orders), so logits agree to a few bf16 ulps and
greedy tokens are equal unless two logits tie within that.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from neural_compressor_tpu.generation import greedy_search as j_greedy
from neural_compressor_tpu.layers.module_utils import \
    named_modules as j_named_modules
from neural_compressor_tpu.models import llama as jl
from neural_compressor_tpu.quantization import RTNConfig as JRTNConfig
from neural_compressor_tpu.quantization import fuse as jfuse
from neural_compressor_tpu.quantization import quantize as j_quantize
from neural_compressor_tpu.quantization.save_load import _module_meta
from neural_compressor_tpu.serving.engine import \
    ContinuousBatchingEngine as JEngine
import neural_compressor_tpu_torch as nct
from neural_compressor_tpu_torch.layers import W4A8Linear, WOQLinear
from neural_compressor_tpu_torch.models import llama as tl

from test_torch_engine import LP_TOL, mixed_specs, serve

torch.set_num_threads(2)

ASYM4 = dict(dtype="int4", group_size=32, use_sym=False, quant_lm_head=True)
NF4 = dict(dtype="nf4", group_size=32, quant_lm_head=True)


def _flat(model) -> dict:
    return {".".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.state(model).flat_state()}


def _meta(model) -> dict:
    """Each quantized module's static attributes, as JAX's save_load
    records them."""
    return {path: _module_meta(m) for path, m in j_named_modules(model)
            if type(m).__name__ in ("WOQLinear", "W4A8Linear")}


def _port_cfg(jcfg) -> tl.LlamaConfig:
    return tl.LlamaConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(jcfg)
                             if f.name != "dtype"})


def _port(jm) -> "tl.LlamaForCausalLM":
    return tl.from_jax_params(_flat(jm), _port_cfg(jm.cfg), device="cpu",
                              meta=_meta(jm))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def test_graft_entry_counterpart_logits_match():
    """``__graft_entry__.entry``: llama-test quantized RTN int4 g32, ids
    (2, 16), a forward without cache. The port quantizes its copy of the
    bf16 weights itself (RTN is bit-equal) and serves W4A16."""
    jm = jl.LlamaForCausalLM.from_preset("llama-test", seed=0)
    tm = tl.from_jax_params(_flat(jm), _port_cfg(jm.cfg), device="cpu")
    j_quantize(jm, JRTNConfig(dtype="int4", group_size=32))
    nct.quantize(tm, nct.RTNConfig(dtype="int4", group_size=32))
    n_woq = sum(type(m) is WOQLinear for m in tm.modules())
    assert n_woq == 7 * jm.cfg.num_hidden_layers
    ids = np.random.default_rng(0).integers(0, 256, (2, 16))
    jy = _f32(jm(jnp.asarray(ids)))
    with torch.no_grad():
        ty = _f32(tm(torch.from_numpy(ids)))
    assert ty.shape == jy.shape == (2, 16, 256)
    # a few bf16 ulps: float32 sums in another order, rounded to bf16
    assert np.abs(ty - jy).max() <= 2e-2 * np.abs(jy).max()


ENGINE_CFG = dict(vocab_size=512, hidden_size=512, intermediate_size=512,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=4, max_position_embeddings=128)


@pytest.mark.parametrize("fmt", [dict(ASYM4, group_size=128), NF4],
                         ids=["asym4_g128", "nf4_g32"])
def test_engine_serves_a_woq_model_like_jax(fmt):
    """The 8-slot engine's path at a small size: the same W4A16 model
    (JAX quantizes and fuses; the port takes its bytes and fuses) behind
    both engines, contiguous caches, one mixed submission."""
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**ENGINE_CFG), nnx.Rngs(9))
    j_quantize(jm, JRTNConfig(**fmt))
    assert jfuse.fuse_for_serving(jm) == 4
    tm = _port(jm)
    assert type(tm.model.layers[0].self_attn.qkv_proj) is WOQLinear
    specs = mixed_specs(tm)
    want = serve(JEngine, jm, "contiguous", specs)
    got = serve(nct.ContinuousBatchingEngine, tm, "contiguous", specs)
    assert got["tokens"] == want["tokens"]
    assert got["metrics"] == want["metrics"]
    # one bf16 ulp of a logit between 4 and 8 is 0.03
    for a, b in zip(want["logprobs"], got["logprobs"]):
        assert np.abs(np.asarray(a) - np.asarray(b)).max(initial=0) <= LP_TOL


def test_port_rtn_asym_then_to_w4a8_serving_keeps_woq():
    """The port quantizes asymmetric int4 itself (bytes equal to JAX's),
    fuses; ``to_w4a8_serving`` converts nothing and leaves every module a
    ``WOQLinear``, and the model still serves JAX's greedy tokens."""
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**ENGINE_CFG), nnx.Rngs(4))
    tm = tl.from_jax_params(_flat(jm), _port_cfg(jm.cfg), device="cpu")
    j_quantize(jm, JRTNConfig(**ASYM4))
    nct.quantize(tm, nct.RTNConfig(**ASYM4))
    jq, tq = _flat(jm), tm.state_dict()
    keys = [k for k in jq if k.endswith((".packed", ".scales", ".zeros"))]
    assert len(keys) == 3 * (7 * 2 + 1)
    for k in keys:
        want = jq[k].view(np.int32) if jq[k].dtype == np.uint32 else jq[k]
        np.testing.assert_array_equal(tq[k].numpy(), want)
    jfuse.fuse_for_serving(jm)
    jfuse.to_w4a8_serving(jm)
    assert nct.fuse_for_serving(tm) == 4
    assert nct.to_w4a8_serving(tm) == 0
    assert nct.enable_fused_decode(tm) == 0
    assert not any(type(m) is W4A8Linear for m in tm.modules())
    ids = np.random.default_rng(5).integers(0, 512, (1, 12)).astype(np.int32)
    want = np.asarray(j_greedy(jm, jnp.asarray(ids), max_new_tokens=8))
    got = nct.generate(tm, torch.from_numpy(ids), max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", ["vpu", "pallas"])
def test_forced_kernel_impls_match_jax_in_the_model(impl):
    """``impl`` set on every WOQLinear of both models: JAX runs its Pallas
    kernels in interpret mode, the port the plain versions of K9/K8 (a
    prefill of 12 tokens, then 4 decode steps with a cache). K9 does not
    round the weight to bf16, so this is the card's numerics at M == 1."""
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**dict(
        ENGINE_CFG, num_hidden_layers=1)), nnx.Rngs(6))
    j_quantize(jm, JRTNConfig(**dict(ASYM4, group_size=128)))
    jfuse.fuse_for_serving(jm)
    tm = _port(jm)
    for _p, m in j_named_modules(jm):
        if type(m).__name__ == "WOQLinear":
            m.impl = impl
    for m in tm.modules():
        if isinstance(m, WOQLinear):
            m.impl = impl
    seq = np.random.default_rng(7).integers(0, 512, (1, 16)).astype(np.int32)
    jc = jl.init_kv_cache(jm.cfg, 1, 32)
    tc = tl.init_kv_cache(tm.cfg, 1, 32, device="cpu")
    P = 12
    pos = np.arange(P, dtype=np.int32)[None]
    jy, jc = jm(jnp.asarray(seq[:, :P]), jnp.asarray(pos), jc, 0)
    with torch.no_grad():
        ty, tc = tm(torch.from_numpy(seq[:, :P]), torch.from_numpy(pos), tc, 0)
    assert np.abs(_f32(ty) - _f32(jy)).max() <= 2e-2 * np.abs(_f32(jy)).max()
    for p in range(P, 16):
        tok = seq[:, p:p + 1]
        jy, jc = jm(jnp.asarray(tok), jnp.full((1, 1), p, jnp.int32), jc, p)
        with torch.no_grad():
            ty, tc = tm(torch.from_numpy(tok), torch.full((1, 1), p), tc, p)
        d = np.abs(_f32(ty) - _f32(jy)).max()
        assert d <= 2e-2 * np.abs(_f32(jy)).max(), (p, d)


def _strided_w4a8_pair(monkeypatch, threshold: int, seed: int = 8):
    """A JAX ``W4A8Linear`` and the port's on the same seeded 256x256
    sym-int4 g128 "tpu_strided" words, both classes at ``threshold``."""
    from neural_compressor_tpu.layers.woq_linear import \
        W4A8Linear as JW4A8Linear
    from neural_compressor_tpu.ops import packing as jpk
    from neural_compressor_tpu.ops import qtensor as jqt
    from neural_compressor_tpu_torch.ops import PackedWeight

    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((256, 256)) / 16).astype(np.float32)
    jpw = jpk.pack_qtensor(jqt.quantize_tensor(jnp.asarray(w), bits=4,
                                               group_size=128))
    tpw = PackedWeight(torch.from_numpy(np.asarray(jpw.packed).view(
        np.int32).copy()), torch.from_numpy(np.asarray(jpw.scales)), None,
        bits=4, group_size=128, dtype="int", orig_shape=(256, 256),
        layout="tpu_strided")
    monkeypatch.setattr(JW4A8Linear, "M_INT8_THRESHOLD", threshold)
    monkeypatch.setattr(W4A8Linear, "M_INT8_THRESHOLD", threshold)
    jmod, tmod = JW4A8Linear(jpw), W4A8Linear(tpw)
    assert tmod.layout == "tpu_strided"
    return jmod, tmod, rng


def test_w4a8linear_below_a_raised_int8_threshold_takes_woq_matmul(
        monkeypatch):
    """JAX's ``W4A8Linear`` hands M > 1 below ``M_INT8_THRESHOLD`` to
    ``woq_matmul``, and M == 1 to the all-integer matvec (K10,
    ``vpu_matvec_int8act``); the port follows, keeping the "tpu_strided"
    words that both read when the threshold is raised at build. K10's
    plain version against JAX's kernel in interpret mode: within 1e-6 of
    max|y| (the float sums of the same exact integer terms, which XLA may
    contract into multiply-adds)."""
    from neural_compressor_tpu_torch.kernels import dequant_dot
    from neural_compressor_tpu_torch.kernels import dequant_matmul as tdm

    calls = []
    plain = tdm.vpu_int8act_plain
    monkeypatch.setattr(tdm, "vpu_int8act_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    jmod, tmod, rng = _strided_w4a8_pair(monkeypatch, 4)
    x = rng.standard_normal((2, 256)).astype(np.float32)
    before = dequant_dot.calls
    ty = _f32(tmod(torch.from_numpy(x)))
    assert dequant_dot.calls == before + 1     # woq_matmul off the card
    jy = _f32(jmod(jnp.asarray(x)))
    assert np.abs(ty - jy).max() <= 1e-5 * np.abs(jy).max()
    # M == 1: K10's plain version, as JAX runs K10 (interpret mode)
    ty1 = _f32(tmod(torch.from_numpy(x[:1])))
    jy1 = _f32(jmod(jnp.asarray(x[:1])))
    assert dequant_dot.calls == before + 1 and calls == [1]
    assert np.abs(ty1 - jy1).max() <= 1e-6 * np.abs(jy1).max()


@pytest.mark.parametrize("M", [4, 8])
def test_w4a8linear_at_a_raised_threshold_takes_k1_on_strided_words(
        monkeypatch, M):
    """The repair: at M >= a raised ``M_INT8_THRESHOLD`` a "tpu_strided"
    sym-int4 ``W4A8Linear`` takes K1's integer result on its words (the
    plain version of ``w4a8_gemm_strided`` here), as JAX's ``w4a8_matmul``
    runs K1 on them; before, the port took the bf16 dequant-and-dot, 5.8e-3
    of max|y| from JAX's at M = 4."""
    from neural_compressor_tpu_torch.kernels import dequant_dot

    jmod, tmod, rng = _strided_w4a8_pair(monkeypatch, 4)
    x = rng.standard_normal((M, 256)).astype(np.float32)
    before = dequant_dot.calls
    ty = _f32(tmod(torch.from_numpy(x)))
    assert dequant_dot.calls == before         # the integer path
    jy = _f32(jmod(jnp.asarray(x)))
    assert np.abs(ty - jy).max() <= 1e-6 * np.abs(jy).max()


def test_from_jax_params_refuses_quantized_modules_without_meta():
    """nf4 codebook indices are uint32 words with no zero points, as
    symmetric int4 words are: without its meta such a checkpoint would
    load as integers and give wrong logits, so ``from_jax_params``
    refuses it; with the meta it carries the codebook dtype."""
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**ENGINE_CFG), nnx.Rngs(5))
    j_quantize(jm, JRTNConfig(**NF4))
    with pytest.raises(ValueError, match="no meta"):
        tl.from_jax_params(_flat(jm), _port_cfg(jm.cfg), device="cpu")
    woq = [m for m in _port(jm).modules() if type(m) is WOQLinear]
    assert len(woq) == 7 * 2 + 1
    assert all(m.wdtype == "nf4" for m in woq)
