"""The quantized-KV-cache slice against the JAX package, through the
engine: a small seeded one-layer GQA llama quantized with ``RTNConfig +
KVCacheQuantConfig`` in JAX and carried to the port with
``from_jax_params(kv_cache_format=...)``, served W4A16 (asymmetric int4
g128, every projection a ``WOQLinear``) and W4A8, by both engines over
contiguous int8/fp8/int4 caches and paged fp8/int4 pools (W4A8: one mode
per format). Checks: tokens and dispatch counters equal, logprobs within
0.1, and the port's cache format and bytes in ``metrics()``.
``test_torch_kv_llama.py`` shares these helpers for the model-level
checks.

JAX runs as its own tests run it on the CPU: its Pallas kernels in
interpret mode where they take the format (K11 fp8/int4, K12 int4 at
128-row pages), else its XLA path (``_grouped_attention`` on the codes
where K7 is off its envelope, the scatter write at 32-row pages). The
model and prompts are pinned to seeds whose greedy tokens are far from
ties in every format: int4 caches turn the packages' one-ulp differences
into whole code steps, which part random models at near-ties (ROADMAP.md,
Queue 3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from neural_compressor_tpu.models import llama as jl
from neural_compressor_tpu.quantization import KVCacheQuantConfig as JKV
from neural_compressor_tpu.quantization import RTNConfig as JRTNConfig
from neural_compressor_tpu.quantization import fuse as jfuse
from neural_compressor_tpu.quantization import quantize as j_quantize
from neural_compressor_tpu.serving.engine import \
    ContinuousBatchingEngine as JEngine
import neural_compressor_tpu_torch as nct
from neural_compressor_tpu_torch.models import llama as tl

from test_torch_engine import (COUNTERS, LP_TOL, flat_state, jax_meta,
                               port_cfg)

torch.set_num_threads(2)

# GQA: 4 query heads of 128 on 2 KV heads; every projection inside the
# W4A8 envelope. One decoder layer: a second layer's K/V come from the
# first layer's output, where the packages' one-ulp differences cross int4
# (and int8) rounding boundaries and move whole code steps; on these
# near-uniform random models that parted greedy tokens at near-ties on
# every seed of 0-24 tried at two layers (ROADMAP.md, Queue 3). The trained
# checkpoints of test_torch_kv_tiny.py carry depth.
KV_CFG = dict(vocab_size=512, hidden_size=512, intermediate_size=512,
              num_hidden_layers=1, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=128)
FORMATS = ("int8", "fp8_e4m3", "int4")
ENGINE = dict(n_slots=4, max_len=128, prefill_chunk=32)
MODES = {"contiguous_int8": ({}, "int8"),
         "contiguous_fp8": ({}, "fp8_e4m3"),
         "contiguous_int4": ({}, "int4"),
         "paged_fp8": (dict(paged=True, page_size=32), "fp8_e4m3"),
         "paged_int4": (dict(paged=True, page_size=32), "int4")}
# engine modes each kind is served in
KIND_MODES = {"w4a16": tuple(MODES),
              "w4a8": ("contiguous_int8", "paged_fp8", "paged_int4")}
# per kind: a model seed far from ties in every format
SEEDS = {"w4a16": 4, "w4a8": 41}
NEW = 4


def kv_pair(kind: str, seed: int | None = None):
    """(JAX model, port model) on the same weights: RTN int4 g128 with the
    lm_head composed with ``KVCacheQuantConfig`` (int8; each test sets its
    format on both models, as the config would), fused; W4A8-served on
    both sides for ``kind == "w4a8"``, on the modular path JAX's CPU runs
    (``test_torch_kv_llama.py`` holds the port's fused decode to it)."""
    seed = SEEDS[kind] if seed is None else seed
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**KV_CFG), nnx.Rngs(seed))
    j_quantize(jm, JRTNConfig(dtype="int4", group_size=128,
                              use_sym=kind == "w4a8", quant_lm_head=True)
               + JKV(dtype="int8"))
    jfuse.fuse_for_serving(jm)
    if kind == "w4a8":
        jfuse.to_w4a8_serving(jm)
    assert jm.kv_cache_quantized and jm.kv_cache_format == "int8"
    tm = tl.from_jax_params(flat_state(jm), port_cfg(jm.cfg), device="cpu",
                            meta=jax_meta(jm),
                            kv_cache_format=jm.kv_cache_format)
    assert tm.kv_cache_quantized and tm.kv_cache_format == "int8"
    if kind == "w4a8":
        nct.to_w4a8_serving(tm)
    return jm, tm


@pytest.fixture(scope="module")
def pairs():
    """(JAX model, port model) per kind, built on first use."""
    built = {}

    def get(kind):
        if kind not in built:
            built[kind] = kv_pair(kind)
        return built[kind]

    return get


def _set_format(models, fmt):
    for m in models:
        m.kv_cache_quantized = True
        m.kv_cache_format = fmt


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ids(B, n, seed):
    return np.random.default_rng(seed).integers(
        0, KV_CFG["vocab_size"], (B, n)).astype(np.int32)


def _serve(engine_cls, model, mode, specs, chunk=4):
    kw, fmt = MODES[mode]
    _set_format((model,), fmt)
    eng = engine_cls(model, **{**ENGINE, **kw})
    reqs = [eng.submit(**s) for s in specs]
    done = eng.run(chunk=chunk)
    assert sorted(r.uid for r in done) == sorted(r.uid for r in reqs)
    m = eng.metrics()
    return eng, {"tokens": [list(r.generated) for r in reqs],
                 "logprobs": [list(r.logprobs) for r in reqs],
                 "metrics": {k: m[k] for k in COUNTERS}}


def engine_specs(seed: int):
    """Four requests on 4 slots: prompts of 5-70 tokens (70 in three
    32-token chunks), ``NEW`` new tokens each."""
    rng = np.random.default_rng(seed)
    return [dict(prompt_ids=rng.integers(0, KV_CFG["vocab_size"], (n,)),
                 max_new_tokens=NEW) for n in (5, 40, 12, 70)]


CASES = [(k, m) for k, modes in KIND_MODES.items() for m in modes]


@pytest.mark.parametrize("kind,mode", CASES,
                         ids=[f"{k}-{m}" for k, m in CASES])
def test_engine_matches_jax(pairs, kind, mode):
    jm, tm = pairs(kind)
    specs = engine_specs(SEEDS[kind])
    _je, want = _serve(JEngine, jm, mode, specs)
    eng, got = _serve(nct.ContinuousBatchingEngine, tm, mode, specs)
    assert got["tokens"] == want["tokens"]
    assert got["metrics"] == want["metrics"]
    for a, b in zip(want["logprobs"], got["logprobs"]):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() <= LP_TOL
    m = eng.metrics()
    _kw, fmt = MODES[mode]
    assert m["kv_cache_format"] == fmt
    held = eng.pools if eng.paged else eng.caches
    assert m["kv_cache_bytes"] == sum(
        t.numel() * t.element_size() for c in held
        for t in (c[:4] + c[5:] if eng.paged else c) if t is not None)


@pytest.mark.parametrize("mode", ["contiguous_int8", "contiguous_fp8"])
def test_one_slot_engine_runs_into_max_len(pairs, mode):
    """One slot (B == 1 decode: K6 over the codes, K12 writing the row)
    with ``chunk=3``: the first request ends at max_len, so its last
    dispatch runs positions 46, 47 and 48 on a 48-row cache (48 past the
    end, its token discarded); a second request reuses the slot. Tokens
    and counters equal JAX's, whose K6 mask keeps all T rows there."""
    jm, tm = pairs("w4a16")
    rng = np.random.default_rng(7)
    specs = [dict(prompt_ids=rng.integers(0, KV_CFG["vocab_size"], (n,)),
                  max_new_tokens=new) for n, new in ((40, 8), (9, 5))]
    one = dict(n_slots=1, max_len=48, prefill_chunk=16)

    def serve(engine_cls, model):
        _kw, fmt = MODES[mode]
        _set_format((model,), fmt)
        eng = engine_cls(model, **one)
        reqs = [eng.submit(**s) for s in specs]
        eng.run(chunk=3)
        m = eng.metrics()
        return ([list(r.generated) for r in reqs],
                {k: m[k] for k in COUNTERS})

    want = serve(JEngine, jm)
    got = serve(nct.ContinuousBatchingEngine, tm)
    assert [len(t) for t in got[0]] == [8, 5]
    assert got == want
