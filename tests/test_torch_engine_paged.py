"""The port's ContinuousBatchingEngine against the JAX package's over a
paged KV pool (bf16 rows and int8 codes), on the same weights; helpers and
the model are ``test_torch_engine.py``'s.

Both engines decode through the paged write and attention kernels: JAX's
Pallas K11 in interpret mode (its row writes take the XLA scatter at page
32, the same function as K12), the port's plain versions. Checks as in
contiguous mode, plus a pool small enough to force a preemption: both
engines preempt the same request at the same point, and it resumes
exactly (the same tokens as without preemption).
"""

import numpy as np
import pytest
import torch
from flax import nnx

from neural_compressor_tpu.models import llama as jl
import neural_compressor_tpu_torch as nct

from test_torch_engine import (CFG, SEED, JEngine, assert_same_serving,
                               mixed_specs, serve, serve_pair)

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=[False, True], ids=["bf16", "w4a8"])
def pair(request):
    jm, tm = serve_pair(jl.LlamaForCausalLM(jl.LlamaConfig(**CFG),
                                            nnx.Rngs(SEED)), request.param)
    return jm, tm, mixed_specs(tm, SEED)


@pytest.mark.parametrize("mode", ["paged_bf16", "paged_int8"])
def test_paged_engine_matches_jax(pair, mode):
    jm, tm, specs = pair
    want = serve(JEngine, jm, mode, specs)
    got = serve(nct.ContinuousBatchingEngine, tm, mode, specs)
    assert_same_serving(want, got)
    assert got["metrics"]["combined_dispatches"] > 0


@pytest.mark.parametrize("mode", ["paged_bf16", "paged_int8"])
def test_paged_engine_preempts_and_resumes_exactly(pair, mode):
    """Two slots and 4 usable pages of 16 rows: two 26-token prompts with
    12 new tokens each need 6. The later request is preempted when the
    first needs its third page, requeued, re-prefilled with what it had
    generated, and continues."""
    jm, tm, _specs = pair
    rng = np.random.default_rng(0)
    specs = [dict(prompt_ids=rng.integers(0, CFG["vocab_size"], (26,)),
                  max_new_tokens=12) for _ in range(2)]
    small = dict(n_slots=2, n_pages=5, page_size=16)
    want = serve(JEngine, jm, mode, specs, **small)
    got = serve(nct.ContinuousBatchingEngine, tm, mode, specs, **small)
    assert got["metrics"]["preemptions"] >= 1 and got["preempted"][1] >= 1
    assert_same_serving(want, got)
    roomy = serve(nct.ContinuousBatchingEngine, tm, mode, specs, n_slots=2,
                  page_size=16)
    assert roomy["metrics"]["preemptions"] == 0
    assert roomy["tokens"] == got["tokens"]
