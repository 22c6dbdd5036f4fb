"""The fused B=1 W4A8 decode layer under each flag-selected variant, the
port against the JAX package on the same weights: K17 (``OMLP_FUSED``), K18
(``ATTN_O_FUSED``), K16's in-kernel write (``set_cache_write_mode(
"kernel")``) and bulk-copied caches (``set_ro_cache_space("hbm")``), and
the split path with ``enable_fused_decode(fold_norms=False)``.

A 2-layer llama (hidden 256, intermediate 768, two heads of 128) is
quantized RTN int4 g128 in JAX and carried across with ``from_jax_params``
before either package converts it: JAX to "u4_kpack" (``s4="u4k"``), the
port to "hopper_nk". JAX serves its fused path as on the TPU: ``_on_tpu``
patched to True where the fused kernels check it, every ``pallas_call`` in
interpret mode, ``with_memory_space_constraint`` the identity. JAX reads
these flags when it traces, so each test clears JAX's caches after setting
them; the port reads them at each call. Spies show that each package
reached its K16, K17 or K18 function.

K17 carries x1 in float32, takes silu in float32 and quantizes h per tile,
so with it both packages part from the split path at bf16 rounding: each
package is held to the other under the same flag, never to the split path.
Tolerances: logits of a teacher-forced decode within ``LOGIT_TOL`` of their
range (a bf16 rounding of each of a few thousand terms, and int8 code flips
where the two round an activation at a tie apart).
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import nnx
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from neural_compressor_tpu.generation import greedy_search as j_greedy
from neural_compressor_tpu.kernels import decode_attention as jda
from neural_compressor_tpu.kernels import fused_matvec as jfm
from neural_compressor_tpu.kernels import omlp_matvec as jom
from neural_compressor_tpu.layers.module_utils import \
    named_modules as j_named_modules
from neural_compressor_tpu.models import llama as jl
from neural_compressor_tpu.quantization import RTNConfig as JRTNConfig
from neural_compressor_tpu.quantization import fuse as jfuse
from neural_compressor_tpu.quantization import quantize as j_quantize
from neural_compressor_tpu.quantization.save_load import _module_meta
import neural_compressor_tpu_torch as nct
from neural_compressor_tpu_torch.kernels import omlp_matvec as tom
from neural_compressor_tpu_torch.models import llama as tl

tda = importlib.import_module("neural_compressor_tpu_torch.kernels."
                              "decode_attention")
tfm = importlib.import_module("neural_compressor_tpu_torch.kernels."
                              "fused_matvec")

torch.set_num_threads(2)

CFG = dict(vocab_size=512, hidden_size=256, intermediate_size=768,
           num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
           max_position_embeddings=128)
SEED, PROMPT_SEED, P, NEW = 0, 1, 12, 8
LOGIT_TOL = 5e-2
# flag -> the function each package reaches under it (JAX module, name;
# port module, name)
FLAGS = {"omlp": ((jom, "omlp_fused"), (tom, "omlp_fused")),
         "attn_o": ((jfm, "attn_o_fused"), (tfm, "attn_o_fused")),
         "write": ((jda, "_decode_attn_impl"), (tda, "decode_attn_write")),
         "hbm": ((jda, "_decode_attn_ro_hbm_impl"), (tda, "decode_attn_hbm"))}
# greedy partings under a flag, with the logits at the step where the two
# part. attn_o: at the 8th new token JAX's jitted greedy program takes 66
# where the port takes 272; a teacher-forced forward of the same 19 tokens
# gives the two packages bit-equal logits there, 272 at 2.703125 and 66 at
# 2.6875, one bf16 ulp apart: the tie falls the other way in JAX's jitted
# program than in its own eager forward.
PARTED = {"attn_o": dict(step=7, port=(272, 2.703125), jax=(66, 2.6875))}


def _flat(model) -> dict:
    return {".".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.state(model).flat_state()}


def _meta(model) -> dict:
    return {path: _module_meta(m) for path, m in j_named_modules(model)
            if type(m).__name__ in ("WOQLinear", "W4A8Linear")}


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module")
def pair():
    """(JAX model on "u4_kpack" with fused decode, the port's on
    "hopper_nk" with fused decode), the same RTN int4 g128 bytes."""
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**CFG), nnx.Rngs(SEED))
    j_quantize(jm, JRTNConfig(dtype="int4", group_size=128,
                              quant_lm_head=True))
    jfuse.fuse_for_serving(jm)
    tcfg = tl.LlamaConfig(**{f.name: getattr(jm.cfg, f.name)
                             for f in dataclasses.fields(jm.cfg)
                             if f.name != "dtype"})
    tm = tl.from_jax_params(_flat(jm), tcfg, device="cpu", meta=_meta(jm))
    assert jfuse.to_w4a8_serving(jm, s4="u4k") == 2 * 4 + 1
    assert jfuse.enable_fused_decode(jm) == 2
    assert nct.to_w4a8_serving(tm) == 2 * 4 + 1
    assert nct.enable_fused_decode(tm) == 2
    return jm, tm


@pytest.fixture
def variant(monkeypatch):
    """Returns ``set(flag)``: JAX on its TPU path in interpret mode, both
    packages' switches set to ``flag`` (None: the default fused path), JAX's
    caches cleared; spies count the calls of each package's function of
    ``flag`` in ``calls``."""
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(pltpu, "with_memory_space_constraint",
                        lambda x, _space: x)
    for mod in (jfm, jom, jda):
        monkeypatch.setattr(mod, "_on_tpu", lambda: True)
    calls = {"jax": 0, "port": 0}

    def spy(side, fn, *a, **k):
        calls[side] += 1
        return fn(*a, **k)

    def set_flag(flag):
        monkeypatch.setattr(jom, "OMLP_FUSED", flag == "omlp")
        monkeypatch.setattr(tom, "OMLP_FUSED", flag == "omlp")
        monkeypatch.setattr(jfm, "ATTN_O_FUSED", flag == "attn_o")
        monkeypatch.setattr(tfm, "ATTN_O_FUSED", flag == "attn_o")
        mode = "kernel" if flag == "write" else "outside"
        space = "hbm" if flag == "hbm" else "vmem"
        for mod in (jda, tda):
            monkeypatch.setattr(mod, "_WRITE_MODE", mode)
            monkeypatch.setattr(mod, "_RO_CACHE_SPACE", space)
        if flag in FLAGS:
            for side, (mod, name) in zip(("jax", "port"), FLAGS[flag]):
                monkeypatch.setattr(mod, name, functools.partial(
                    spy, side, getattr(mod, name)))
        jax.clear_caches()
        return calls

    yield set_flag
    jax.clear_caches()


def _ids(n=P, seed=PROMPT_SEED):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (1, n)).astype(np.int32)


@pytest.mark.parametrize("flag", [None, *FLAGS])
def test_greedy_tokens_match_jax_under_each_flag(pair, variant, flag):
    jm, tm = pair
    calls = variant(flag)
    ids = _ids()
    want = np.asarray(j_greedy(jm, jnp.asarray(ids), max_new_tokens=NEW))
    got = nct.greedy_search(tm, torch.from_numpy(ids),
                            max_new_tokens=NEW).numpy()
    if flag is not None:
        # JAX traces its decode step once; the port calls per layer per step
        assert calls["jax"] >= 1, calls
        assert calls["port"] == 2 * (NEW - 1), calls
    if flag in PARTED:
        part = PARTED[flag]
        step = part["step"]
        np.testing.assert_array_equal(got[:, :P + step], want[:, :P + step])
        assert (got[0, P + step], want[0, P + step]) == (part["port"][0],
                                                         part["jax"][0])
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flag", [None, *FLAGS])
def test_decode_logits_match_jax_under_each_flag(pair, variant, flag):
    """A 12-token prefill, then 4 teacher-forced decode steps through each
    package's model call: logits within ``LOGIT_TOL`` of their range."""
    jm, tm = pair
    variant(flag)
    seq = _ids(P + 4, seed=PROMPT_SEED + 1)
    T = 32
    jc = jl.init_kv_cache(jm.cfg, 1, T)
    tc = tl.init_kv_cache(tm.cfg, 1, T, device="cpu")
    pos = np.arange(P, dtype=np.int32)[None]
    _jy, jc = jm(jnp.asarray(seq[:, :P]), jnp.asarray(pos), jc, 0)
    with torch.no_grad():
        _ty, tc = tm(torch.from_numpy(seq[:, :P]), torch.from_numpy(pos),
                     tc, 0)
    for i in range(4):
        p = P + i
        tok = seq[:, p:p + 1]
        jy, jc = jm(jnp.asarray(tok), jnp.full((1, 1), p, jnp.int32), jc, p)
        with torch.no_grad():
            ty, tc = tm(torch.from_numpy(tok), torch.full((1, 1), p), tc, p)
        jy, ty = _f32(jy), _f32(ty)
        assert np.abs(ty - jy).max() <= LOGIT_TOL * np.abs(jy).max(), (
            flag, i)


def test_fold_norms_false_matches_jax(pair, variant):
    """``enable_fused_decode(model, fold_norms=False)``: each layer applies
    its RMSNorms and calls the GEMVs without a norm weight, in both
    packages, and K17 (which folds the norm) is not taken."""
    jm, tm = pair
    calls = variant("omlp")
    jfuse.enable_fused_decode(jm, fold_norms=False)
    nct.enable_fused_decode(tm, fold_norms=False)
    try:
        assert all(not lyr.fused_fold_norms for lyr in tm.model.layers)
        jax.clear_caches()
        ids = _ids(seed=PROMPT_SEED + 2)
        want = np.asarray(j_greedy(jm, jnp.asarray(ids),
                                   max_new_tokens=NEW))
        got = nct.greedy_search(tm, torch.from_numpy(ids),
                                max_new_tokens=NEW).numpy()
        np.testing.assert_array_equal(got, want)
        assert calls == {"jax": 0, "port": 0}
    finally:
        jfuse.enable_fused_decode(jm)
        nct.enable_fused_decode(tm)
        jax.clear_caches()
