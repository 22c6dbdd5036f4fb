"""The engine on the flag-selected kernels, the port's against the JAX
package's on the same weights (the model and helpers are
``test_torch_engine.py``'s):

* ``set_paged_v2(False)``: the W4A8 model's paged decode over bf16 and
  int8 pools on v1's kernel (K15), JAX's Pallas kernels in interpret mode,
  the port's plain version;
* the bf16 model with one slot over a contiguous bf16 cache, whose decode
  calls are B=1 with a tensor of positions: JAX sends them to its B=1
  kernel (K5), and so does the port since the repair (it sent them to K7,
  which normalises after the PV product and rounds apart). Under ``set_cache_write_mode("kernel")``
  the same engine takes K16's in-kernel write in both packages.

Spies show which function each package reached; tokens, counters and
logprobs are held as in ``test_torch_engine.py``.
"""

import importlib

import jax
import pytest
import torch
from flax import nnx

from neural_compressor_tpu.kernels import decode_attention as jda
from neural_compressor_tpu.kernels import paged_attention as jpa
from neural_compressor_tpu.models import llama as jl
import neural_compressor_tpu_torch as nct

from test_torch_engine import (CFG, SEED, JEngine, assert_same_serving,
                               mixed_specs, serve, serve_pair)

tda = importlib.import_module("neural_compressor_tpu_torch.kernels."
                              "decode_attention")
tpa = importlib.import_module("neural_compressor_tpu_torch.kernels."
                              "paged_attention")

torch.set_num_threads(2)


def _pair(served: bool):
    jm, tm = serve_pair(jl.LlamaForCausalLM(jl.LlamaConfig(**CFG),
                                            nnx.Rngs(SEED)), served)
    return jm, tm, mixed_specs(tm, SEED)


@pytest.fixture(scope="module")
def w4a8_pair():
    return _pair(True)


@pytest.fixture(scope="module")
def bf16_pair():
    """The unquantized model: off the TPU JAX serves W4A8 on its modular
    path and the port on its fused one, whose glue rounds apart; in bf16
    the two differ only where the attention kernels do."""
    return _pair(False)


def _spy(monkeypatch, calls, mod, name):
    fn = getattr(mod, name)
    calls.setdefault(name, 0)

    def spy(*a, **k):
        calls[name] += 1
        return fn(*a, **k)

    monkeypatch.setattr(mod, name, spy)


@pytest.mark.parametrize("mode", ["paged_bf16", "paged_int8"])
def test_paged_v1_engine_matches_jax(w4a8_pair, monkeypatch, mode):
    jm, tm, specs = w4a8_pair
    calls = {}
    for mod, name in ((jpa, "_paged_attn_impl"),
                      (jpa, "_paged_attn_quant_impl"),
                      (jpa, "_paged_attn_impl_v2"), (tpa, "paged_attn_v1"),
                      (tpa, "paged_attn")):
        _spy(monkeypatch, calls, mod, name)
    monkeypatch.setattr(jpa, "_PAGED_V2", False)
    monkeypatch.setattr(tpa, "_PAGED_V2", False)
    jax.clear_caches()
    try:
        want = serve(JEngine, jm, mode, specs)
        got = serve(nct.ContinuousBatchingEngine, tm, mode, specs)
    finally:
        jax.clear_caches()
    assert_same_serving(want, got)
    v1 = "_paged_attn_quant_impl" if mode == "paged_int8" else \
        "_paged_attn_impl"
    assert calls[v1] >= 1 and calls["_paged_attn_impl_v2"] == 0, calls
    assert calls["paged_attn_v1"] > 0 and calls["paged_attn"] == 0, calls


@pytest.mark.parametrize("write", ["outside", "kernel"])
def test_one_slot_contiguous_engine_takes_the_b1_kernel(bf16_pair,
                                                        monkeypatch, write):
    """One slot, a contiguous bf16 cache: every decode is B=1 with a
    position tensor. Both packages attend on their B=1 kernel (K5; under
    the "kernel" write mode K16's write), none on the batched one (K7), and
    serve the same tokens."""
    jm, tm, specs = bf16_pair
    calls = {}
    for mod, name in ((jda, "_decode_attn_ro_impl"),
                      (jda, "_decode_attn_impl"),
                      (jda, "_batched_attn_impl"), (tda, "decode_attn"),
                      (tda, "decode_attn_write"),
                      (tda, "batched_decode_attn")):
        _spy(monkeypatch, calls, mod, name)
    monkeypatch.setattr(jda, "_WRITE_MODE", write)
    monkeypatch.setattr(tda, "_WRITE_MODE", write)
    jax.clear_caches()
    one = dict(n_slots=1, prefill_chunk=32)
    try:
        want = serve(JEngine, jm, "contiguous", specs[:3], **one)
        got = serve(nct.ContinuousBatchingEngine, tm, "contiguous",
                    specs[:3], **one)
    finally:
        jax.clear_caches()
    assert_same_serving(want, got)
    jname, tname = (("_decode_attn_ro_impl", "decode_attn")
                    if write == "outside"
                    else ("_decode_attn_impl", "decode_attn_write"))
    assert calls[jname] >= 1 and calls["_batched_attn_impl"] == 0, calls
    # every decode step of both layers; never the batched kernel
    steps = sum(len(t) - 1 for t in got["tokens"])
    assert calls[tname] >= 2 * steps > 0, calls
    assert calls["batched_decode_attn"] == 0, calls
