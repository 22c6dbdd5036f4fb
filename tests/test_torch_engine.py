"""The port's ContinuousBatchingEngine against the JAX package's, on the
same weights (``from_jax_params``), both greedy, in contiguous mode; the
paged modes are in ``test_torch_engine_paged.py`` and the trained
checkpoints in ``test_torch_engine_tiny.py``, which share this file's
helpers.

The model is small but puts JAX's batched decode attention (K7) inside its
kernel envelope (head width 128, 4 slots x 4 KV heads = 16 rows, max_len
128), so both engines decode with K7's numerics: JAX through the Pallas
kernel in interpret mode, the port through the kernel's plain version. Both
serve it unquantized (bf16) and RTN-int4 g128 W4A8 (JAX's projections on
its interpret-mode W4A8 kernel). One submission covers: more requests than
slots, a prompt that takes three prefill chunks, a stop token, a stop
sequence, ``max_new_tokens=1`` and streaming. Checks: tokens equal per
request, the engines' dispatch counters equal, logprobs within 2e-2 (the
two sum the final logits in different orders).
"""

import dataclasses

import numpy as np
import pytest
import torch

from flax import nnx

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
from neural_compressor_tpu_torch.models import llama as tl

torch.set_num_threads(2)

CFG = dict(vocab_size=512, hidden_size=512, intermediate_size=512,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
           max_position_embeddings=128)
ENGINE = dict(n_slots=4, max_len=128, prefill_chunk=32)
MODES = {"contiguous": {},
         "paged_bf16": dict(paged=True, page_size=32),
         "paged_int8": dict(paged=True, page_size=32)}
CHUNK = 4
NEW = 6
# logprobs: the two packages round bf16 in different places (rope, sum
# orders), and an int8 activation code flips at one bf16 ulp of its input
LP_TOL = 0.1
# a model and prompts whose greedy tokens are far enough from ties in every
# mode; random W4A8 models part from JAX at near-ties (ROADMAP.md, Queue 3)
SEED = 9
COUNTERS = ("requests", "prompt_tokens", "generated_tokens",
            "prefill_chunk_dispatches", "decode_dispatches",
            "combined_dispatches", "preemptions")


def flat_state(model) -> dict:
    return {".".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.state(model).flat_state()}


def jax_meta(model) -> dict:
    """Each quantized module's static attributes, as JAX's save_load
    records them (``from_jax_params`` needs them)."""
    return {path: _module_meta(m) for path, m in j_named_modules(model)
            if type(m).__name__ in ("WOQLinear", "W4A8Linear")}


def port_cfg(jcfg) -> tl.LlamaConfig:
    return tl.LlamaConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(jcfg)
                             if f.name != "dtype"})


def serve_pair(jm, served: bool):
    """(JAX model, port model) on the same weights; ``served``: RTN int4
    g128 with the lm_head, fused and W4A8-converted on both sides."""
    if served:
        j_quantize(jm, JRTNConfig(dtype="int4", group_size=128,
                                  quant_lm_head=True))
        jfuse.fuse_for_serving(jm)
        jfuse.to_w4a8_serving(jm)
    tm = tl.from_jax_params(flat_state(jm), port_cfg(jm.cfg), device="cpu",
                            meta=jax_meta(jm))
    if served:
        nct.to_w4a8_serving(tm)
        nct.enable_fused_decode(tm)
    return jm, tm


def serve(engine_cls, model, mode: str, specs, chunk: int = CHUNK,
          **engine_kw) -> dict:
    """Submit ``specs`` (dicts of submit() arguments) to a fresh engine in
    ``mode`` and run it dry. The int8 pool is the model's KV-cache format
    flag, as ``KVCacheQuantConfig`` sets it in the JAX package."""
    quant = mode == "paged_int8"
    model.kv_cache_quantized = quant
    model.kv_cache_format = "int8"
    try:
        eng = engine_cls(model, **{**ENGINE, **MODES[mode], **engine_kw})
        streamed: dict[int, list] = {}
        reqs = [eng.submit(stream=lambda r, t: streamed.setdefault(
            r.uid, []).append(t), **s) for s in specs]
        done = eng.run(chunk=chunk)
    finally:
        model.kv_cache_quantized = False
    assert sorted(r.uid for r in done) == sorted(r.uid for r in reqs)
    m = eng.metrics()
    return {"tokens": [list(r.generated) for r in reqs],
            "logprobs": [list(r.logprobs) for r in reqs],
            "streamed": [streamed.get(r.uid, []) for r in reqs],
            "preempted": [r.preemptions for r in reqs],
            "metrics": {k: m[k] for k in COUNTERS}}


def assert_same_serving(want: dict, got: dict) -> None:
    assert got["tokens"] == want["tokens"]
    assert got["metrics"] == want["metrics"]
    assert got["preempted"] == want["preempted"]
    for a, b in zip(want["logprobs"], got["logprobs"]):
        assert len(a) == len(b)
        assert np.abs(np.asarray(a) - np.asarray(b)).max(initial=0) <= LP_TOL


def mixed_specs(tm, seed: int = 0):
    """Six requests on 4 slots: prompts of 5-70 tokens (70 takes three
    32-token chunks), one with max_new_tokens=1, one stop token and one
    stop sequence taken from what the port generates without them."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, CFG["vocab_size"], (n,)).astype(np.int32)
               for n in (5, 40, 12, 70, 3, 20)]
    specs = [dict(prompt_ids=p, max_new_tokens=NEW) for p in prompts]
    specs[4]["max_new_tokens"] = 1
    free = serve(nct.ContinuousBatchingEngine, tm, "contiguous", specs)
    specs[1]["stop_token_ids"] = (free["tokens"][1][3],)
    specs[2]["stop_sequences"] = (tuple(free["tokens"][2][2:4]),)
    return specs


@pytest.fixture(scope="module", params=[False, True], ids=["bf16", "w4a8"])
def contiguous_runs(request):
    jm, tm = serve_pair(jl.LlamaForCausalLM(jl.LlamaConfig(**CFG),
                                            nnx.Rngs(SEED)), request.param)
    specs = mixed_specs(tm, SEED)
    return (serve(JEngine, jm, "contiguous", specs),
            serve(nct.ContinuousBatchingEngine, tm, "contiguous", specs),
            specs)


def test_contiguous_engine_matches_jax(contiguous_runs):
    want, got, _specs = contiguous_runs
    assert_same_serving(want, got)


def test_contiguous_engine_stops_and_streams(contiguous_runs):
    want, got, specs = contiguous_runs
    toks = got["tokens"]
    assert len(toks[4]) == 1                          # max_new_tokens=1
    assert toks[1][-1] == specs[1]["stop_token_ids"][0] and len(toks[1]) <= 4
    seq = specs[2]["stop_sequences"][0]
    assert len(toks[2]) <= 2                          # the sequence trimmed
    assert all(len(t) == NEW for i, t in enumerate(toks) if i in (0, 3, 5))
    # every decided token streams, a stop sequence's included
    assert got["streamed"][2][:len(toks[2])] == toks[2]
    assert got["streamed"][2][len(toks[2]):] == list(seq)
    assert got["streamed"][0] == toks[0] and want["streamed"] == \
        got["streamed"]
    m = got["metrics"]
    assert m["requests"] == 6 and m["generated_tokens"] == sum(map(len, toks))
    assert m["combined_dispatches"] > 0


def test_engine_runs_on_the_models_device_and_reads_back_once():
    from neural_compressor_tpu_torch.serving import engine as te

    m = tl.LlamaForCausalLM(tl.LlamaConfig(**tl.LLAMA_PRESETS["llama-test"]),
                            device="cpu")
    eng = nct.ContinuousBatchingEngine(m, n_slots=2, max_len=32,
                                       prefill_chunk=8)
    assert eng.device == torch.device("cpu")
    assert eng.caches[0].k.shape == (2, 2, 32, 32)
    calls = []
    real = te._readback
    te._readback = lambda *ts: calls.append(len(ts)) or real(*ts)
    try:
        eng.submit(np.arange(5), max_new_tokens=6)
        eng.submit(np.arange(3), max_new_tokens=6)
        eng.run(chunk=3)
    finally:
        te._readback = real
    s = eng.metrics()
    dispatches = (s["prefill_chunk_dispatches"] + s["decode_dispatches"]
                  - s["combined_dispatches"])
    assert len(calls) == dispatches      # one host readback per dispatch


def test_readback_splits_words_back():
    from neural_compressor_tpu_torch.serving.engine import _readback

    a = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    b = torch.tensor([[1.5, -2.25], [3e-8, float("inf")]])
    c = torch.tensor([7], dtype=torch.int64)
    ra, rb, rc = _readback(a, b, c)
    np.testing.assert_array_equal(ra, a.numpy())
    np.testing.assert_array_equal(rb, b.numpy())
    assert rb.dtype == np.float32 and rc.tolist() == [7]


def test_engine_cancel_and_metrics():
    m = tl.LlamaForCausalLM(tl.LlamaConfig(**tl.LLAMA_PRESETS["llama-test"]),
                            device="cpu")
    eng = nct.ContinuousBatchingEngine(m, n_slots=1, max_len=32,
                                       prefill_chunk=8)
    r0 = eng.submit(np.arange(4), max_new_tokens=4)
    r1 = eng.submit(np.arange(4), max_new_tokens=4)
    eng.cancel(r1)
    done = eng.run()
    assert done == [r0] and len(r0.generated) == 4
    assert r1.cancelled and not r1.generated and not eng.queue
    s = eng.metrics()
    assert s["generated_tokens"] == 4 and s["generated_tok_s"] > 0
    assert set(s) >= set(COUNTERS) | {"wall_s", "generated_tok_s"}


def test_engine_off_path_raises():
    m = tl.LlamaForCausalLM(tl.LlamaConfig(**tl.LLAMA_PRESETS["llama-test"]),
                            device="cpu")
    E = nct.ContinuousBatchingEngine
    for kw, name in ((dict(prefix_cache=True, paged=True), "PagePrefixCache"),
                     (dict(logprobs_topk=2), "_top_n_logprobs")):
        with pytest.raises(NotImplementedError, match=name):
            E(m, n_slots=2, max_len=32, **kw)
    eng = E(m, n_slots=2, max_len=32)
    with pytest.raises(NotImplementedError, match="_sample_step"):
        eng.submit(np.arange(3), do_sample=True)
    # greedy speculation is served (tests/test_torch_spec_engine.py); a
    # sampled request under it waits for the rejection-sampled verify
    eng = E(m, n_slots=2, max_len=32, speculative="ngram")
    with pytest.raises(NotImplementedError,
                       match="_spec_rounds.*_sample_step"):
        eng.submit(np.arange(3), do_sample=True)
    # quantized caches and pools are served (tests/test_torch_kv_engine.py);
    # a format JAX does not know is refused in either mode
    m.kv_cache_quantized = True
    m.kv_cache_format = "int3"
    for paged in (False, True):
        with pytest.raises(ValueError, match="int3"):
            E(m, n_slots=2, max_len=32, paged=paged, page_size=16)
    m.kv_cache_quantized = False
    # latent (MLA) pools are served (tests/test_torch_deepseek_engine.py);
    # a paged DeepSeek without the latent cache is refused, as in JAX
    from neural_compressor_tpu_torch.models import deepseek as td

    ds = td.DeepseekForCausalLM.from_preset("deepseek-test", device="cpu")
    with pytest.raises(ValueError, match="latent"):
        E(ds, n_slots=2, max_len=32, paged=True, page_size=16)
    td.enable_mla_latent_cache(ds)
    assert E(ds, n_slots=2, max_len=32, paged=True,
             page_size=16).kv_cache_format == "latent_bf16"
