"""DeepSeek (deepseek-test, float32) served by both engines on the same
weights and submissions: contiguous over the expanded MLA caches and over
the latent caches (bf16, int8), and paged over the latent pool (K14's
write and attention; their plain versions here). Tokens and the ``stats``
counters equal, logprobs within 1e-4 (float32 models; sums in float64 in
the port, float32 in XLA), and the paged engine's pages all returned.
The pages are 16 rows over a 64-row table, so JAX's kernel takes one group
of pages (PMAX 4) and its online softmax equals the port's one pass.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_compressor_tpu.models import deepseek as jd
from neural_compressor_tpu.models import enable_mla_latent_cache as j_enable
from neural_compressor_tpu.serving.engine import \
    ContinuousBatchingEngine as JEngine
import neural_compressor_tpu_torch as nct
from neural_compressor_tpu_torch.models import deepseek as td

from test_torch_engine import COUNTERS, flat_state

torch.set_num_threads(2)

ENGINE = dict(n_slots=2, max_len=64, prefill_chunk=16)
MODES = {"expanded": (False, None, {}),
         "latent_bf16": (True, None, {}),
         "latent_int8": (True, "int8", {}),
         "paged_latent": (True, None, dict(paged=True, page_size=16,
                                           n_pages=9))}
LP_TOL = 1e-4


@pytest.fixture(scope="module")
def pairs():
    built = {}

    def get(latent: bool):
        if latent not in built:
            jm = jd.DeepseekForCausalLM.from_preset("deepseek-test", seed=5,
                                                    dtype=jnp.float32)
            if latent:
                j_enable(jm)
            cfg = td.DeepseekConfig(**{f.name: getattr(jm.cfg, f.name)
                                       for f in dataclasses.fields(jm.cfg)
                                       if f.name != "dtype"},
                                    dtype=torch.float32)
            built[latent] = (jm, td.from_jax_params(flat_state(jm), cfg,
                                                    device="cpu"))
        return built[latent]

    return get


def serve(engine_cls, model, mode, prompts):
    latent, fmt, kw = MODES[mode]
    model.kv_cache_quantized = fmt is not None
    model.kv_cache_format = fmt or "int8"
    try:
        eng = engine_cls(model, **ENGINE, **kw)
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in prompts]
        done = eng.run(chunk=2)
    finally:
        model.kv_cache_quantized = False
    assert sorted(r.uid for r in done) == sorted(r.uid for r in reqs)
    m = eng.metrics()
    return eng, {"tokens": [list(r.generated) for r in reqs],
                 "logprobs": [list(r.logprobs) for r in reqs],
                 "metrics": {k: m[k] for k in COUNTERS}}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_deepseek_engine_matches_jax(pairs, mode):
    jm, tm = pairs(MODES[mode][0])
    rng = np.random.default_rng(31)
    prompts = [(rng.integers(0, 256, (n,)).astype(np.int32), m)
               for n, m in ((12, 6), (7, 4), (20, 6))]
    _je, want = serve(JEngine, jm, mode, prompts)
    eng, got = serve(nct.ContinuousBatchingEngine, tm, mode, prompts)
    assert got["tokens"] == want["tokens"]
    assert got["metrics"] == want["metrics"]
    for a, b in zip(want["logprobs"], got["logprobs"]):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() <= LP_TOL
    if MODES[mode][2].get("paged"):
        assert sorted(eng.free_pages) == list(range(1, 9))
        assert eng.metrics()["kv_cache_format"] == "latent_bf16"
        # the pool: 9 pages of 16 latent rows of r + dr = 24 float32
        assert eng.kv_cache_bytes() == 3 * 9 * 16 * 24 * 4
