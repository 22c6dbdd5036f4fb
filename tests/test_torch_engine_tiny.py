"""The trained checkpoints (``artifacts/tiny_lm``, ``artifacts/tiny_gqa``)
served RTN-int4 g128 W4A8 by both engines, in each pool mode: validation
rows 0-4 as five requests on four slots, 24 new tokens each.

The tiny models' heads are 64 (``tiny_lm``) and 32 (``tiny_gqa``) wide,
outside JAX's batched decode kernel envelope: in contiguous mode JAX
decodes with ``_grouped_attention`` (probabilities normalised before the
bf16 cast), the port with K7's order (normalised after PV). In paged mode
both run K11's order. Rows that part are listed in ``PARTED`` with their
first differing step (ROADMAP.md, Queue 3); up to that step their tokens
are equal, and every row's logprobs agree within 0.2 where the tokens do.
"""

import os

import numpy as np
import pytest
import torch

from neural_compressor_tpu.evaluation.train_tiny import load_tiny_model
import neural_compressor_tpu_torch as nct

from test_torch_engine import JEngine, serve, serve_pair

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_ENGINE = dict(n_slots=4, max_len=64, prefill_chunk=16)
NEW = 24
# (checkpoint, mode) -> {validation row: first new-token index that differs}
# (ROADMAP.md, Queue 3: near-ties of the W4A8-served model)
PARTED = {("tiny_lm", "contiguous"): {1: 9},
          ("tiny_lm", "paged_bf16"): {1: 7},
          ("tiny_lm", "paged_int8"): {1: 7},
          ("tiny_gqa", "contiguous"): {2: 22}}
# logprobs where the tokens agree: int8 activation codes flip at one bf16
# ulp of their input, and the packages round bf16 in different places
LP_TOL = 0.2


@pytest.fixture(scope="module", params=["tiny_lm", "tiny_gqa"])
def tiny(request):
    jm = load_tiny_model(request.param)
    if jm is None:
        pytest.fail(f"artifacts/{request.param} is missing")
    val = np.load(os.path.join(REPO, "artifacts", request.param,
                               "corpus.npz"))["val"]
    jm, tm = serve_pair(jm, True)
    specs = [dict(prompt_ids=val[r, :16].astype(np.int32),
                  max_new_tokens=NEW) for r in range(5)]
    return request.param, jm, tm, specs


@pytest.mark.parametrize("mode", ["contiguous", "paged_bf16", "paged_int8"])
def test_served_checkpoints_match_jax_engine(tiny, mode):
    name, jm, tm, specs = tiny
    kw = dict(TINY_ENGINE, page_size=16) if mode != "contiguous" \
        else TINY_ENGINE
    want = serve(JEngine, jm, mode, specs, **kw)
    got = serve(nct.ContinuousBatchingEngine, tm, mode, specs, **kw)
    assert got["metrics"] == want["metrics"]
    parted = PARTED.get((name, mode), {})
    for row, (a, b) in enumerate(zip(want["tokens"], got["tokens"])):
        n = parted.get(row, NEW)
        assert b[:n] == a[:n], (row, a, b)
        assert len(b) == len(a) == NEW
        la = np.asarray(want["logprobs"][row][:n])
        lb = np.asarray(got["logprobs"][row][:n])
        assert np.abs(la - lb).max() <= LP_TOL, row
