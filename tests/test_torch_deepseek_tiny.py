"""The trained ``artifacts/tiny_mla`` checkpoint (a 3-layer DeepSeek: MLA
and an 8-expert routed MoE, ``deepseek-acc``) loaded through the JAX
package's ``load_tiny_model`` and carried across with ``from_jax_params``:
greedy tokens against JAX's over the expanded caches and the latent caches
in bf16 and int8, validation rows 0-2 as prompts of 16 tokens, 16 new
tokens each. Rows that part are listed in ``PARTED`` with their first
differing step and both packages' top-2 logits there (ROADMAP.md, Queue
3); up to that step their tokens are equal.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_compressor_tpu.evaluation.train_tiny import load_tiny_model
from neural_compressor_tpu.generation import greedy_search as j_greedy
from neural_compressor_tpu.models import enable_mla_latent_cache as j_enable
import neural_compressor_tpu_torch as nct
from neural_compressor_tpu_torch.models import deepseek as td

from test_torch_engine import flat_state

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW = 16
# (cache mode, validation row) -> (first differing new token, the two
# packages' top-2 (token, logit) pairs there)
PARTED: dict = {}


@pytest.fixture(scope="module")
def tiny():
    """latent -> (JAX model, port model), each pair loaded once."""
    val = np.load(os.path.join(REPO, "artifacts", "tiny_mla",
                               "corpus.npz"))["val"]
    built = {}

    def get(latent: bool):
        if latent not in built:
            jm = load_tiny_model("tiny_mla")
            if jm is None:
                pytest.fail("artifacts/tiny_mla is missing")
            if latent:
                j_enable(jm)
            cfg = td.DeepseekConfig(**{f.name: getattr(jm.cfg, f.name)
                                       for f in dataclasses.fields(jm.cfg)
                                       if f.name != "dtype"})
            tm = td.from_jax_params(flat_state(jm), cfg, device="cpu")
            assert tm.use_latent_cache == latent
            built[latent] = (jm, tm)
        return built[latent]

    return get, val[:3, :16].astype(np.int32)


@pytest.mark.parametrize("mode", ["expanded", "latent_bf16", "latent_int8"])
def test_tiny_mla_greedy_matches_jax(tiny, mode):
    get, prompts = tiny
    jm, tm = get(mode != "expanded")
    quant = mode == "latent_int8"
    for m in (jm, tm):
        m.kv_cache_quantized = quant
        m.kv_cache_format = "int8"
    try:
        want = np.asarray(j_greedy(jm, jnp.asarray(prompts),
                                   max_new_tokens=NEW))
        got = nct.greedy_search(tm, torch.from_numpy(prompts),
                                max_new_tokens=NEW).numpy()
    finally:
        for m in (jm, tm):
            m.kv_cache_quantized = False
    assert got.shape == want.shape == (3, 16 + NEW)
    for row in range(3):
        n = PARTED.get((mode, row), (NEW,))[0]
        np.testing.assert_array_equal(got[row, :16 + n], want[row, :16 + n],
                                      err_msg=f"{mode} row {row}")
