"""JAX's hybrid-GPTQ model of tiny_lm (tiny_gqa:
``test_torch_hybrid_serve_gqa.py``, which shares ``served_check``), fused
and carried into the port byte for byte, served by both packages: the port on
"s4_rowpack" (K2's plain version) against JAX on its "tpu_strided" words
(K1 in interpret mode, the same int32 group partials), and both under
``M_INT8_THRESHOLD = 2`` (K10 and K1's strided loader; JAX's in interpret
mode). Helpers: ``test_torch_hybrid_gptq.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_compressor_tpu.generation import greedy_search as j_greedy
from neural_compressor_tpu.layers.woq_linear import W4A8Linear as JW4A8
from neural_compressor_tpu.quantization import fuse as jfuse
import neural_compressor_tpu_torch as nct
from neural_compressor_tpu_torch.layers import W4A8Linear
from neural_compressor_tpu_torch.models import llama as tl

from test_torch_hybrid_gptq import _corpus, _hybrid_jax
from test_torch_woq_llama import _f32, _flat, _meta, _port_cfg

torch.set_num_threads(2)

# (checkpoint, serving) -> {validation row: first new-token index that
# differs}: up to that step the tokens are equal; there both packages'
# teacher-forced forwards give the two tokens' logits within
# ``TIE_ULPS`` bf16 ulps (an exact tie on tiny_lm row 1), and JAX's jitted
# greedy program picks the other one (ROADMAP.md, Queue 3). The same rows
# part under both servings: the kernels' partials are JAX's, the cached
# decode's glue is not
PARTED = {("tiny_lm", "s4"): {1: 10, 3: 14},
          ("tiny_lm", "threshold2"): {1: 10, 3: 14},
          ("tiny_gqa", "s4"): {0: 4, 2: 14, 4: 14},
          ("tiny_gqa", "threshold2"): {0: 4, 2: 14, 4: 14}}
TIE_ULPS = 4


def served_check(monkeypatch, name, serving):
    """JAX's hybrid-GPTQ model, fused, carried into the port byte for byte;
    greedy tokens on validation rows 0-4 (16-token prompts, 24 new) equal
    to JAX's up to the recorded partings: the port on "s4_rowpack" (K2's
    plain version) against JAX on its "tpu_strided" words (K1 in interpret
    mode, the same int32 partials); or both under ``M_INT8_THRESHOLD = 2``
    (K10 for every decode projection, K1 on the strided words for every
    prefill)."""
    jm, _tm, _b = _hybrid_jax(name)
    jfuse.fuse_for_serving(jm)
    assert all(type(m) is JW4A8 and m.layout == "tpu_strided"
               for m in (jm.model.layers[0].self_attn.qkv_proj, jm.lm_head))
    tm = tl.from_jax_params(_flat(jm), _port_cfg(jm.cfg), device="cpu",
                            meta=_meta(jm))
    qkv = tm.model.layers[0].self_attn.qkv_proj
    assert type(qkv) is W4A8Linear and qkv.layout == "tpu_strided"
    if serving == "s4":
        # JAX's own s4 upgrade would take the same modules (N % 256 == 0;
        # tiny_gqa's qkv, N = 384, stays on its tpu_strided words)
        n_s4 = sum(m.out_features % 256 == 0 for m in tm.modules()
                   if type(m) is W4A8Linear)
        assert nct.to_w4a8_serving(tm, s4="s4") == n_s4 >= 4 * 3 + 1
    else:
        monkeypatch.setattr(JW4A8, "M_INT8_THRESHOLD", 2)
        monkeypatch.setattr(W4A8Linear, "M_INT8_THRESHOLD", 2)
        jax.clear_caches()          # JAX reads the threshold when tracing
    ids = _corpus(name)[1][:5, :16].astype(np.int32)
    try:
        want = np.asarray(j_greedy(jm, jnp.asarray(ids), max_new_tokens=24))
    finally:
        jax.clear_caches()
    got = nct.generate(tm, torch.from_numpy(ids), max_new_tokens=24).numpy()
    parted = PARTED.get((name, serving), {})
    for row in range(5):
        n = 16 + parted.get(row, 24)
        np.testing.assert_array_equal(got[row, :n], want[row, :n])
        if row not in parted:
            continue
        a, b = want[row, n], got[row, n]
        assert a != b                               # still a parting
        pre = want[row:row + 1, :n]
        jl_ = _f32(jm(jnp.asarray(pre)))[0, -1]
        with torch.no_grad():
            tl_ = _f32(tm(torch.from_numpy(pre)))[0, -1]
        ulp = 2.0 ** (np.floor(np.log2(abs(jl_[a]))) - 7)
        assert abs(jl_[a] - jl_[b]) <= TIE_ULPS * ulp
        assert abs(tl_[a] - jl_[a]) <= ulp and abs(tl_[b] - jl_[b]) <= ulp


@pytest.mark.parametrize("serving", ["s4", "threshold2"])
def test_hybrid_served_greedy_tokens_equal_jax(monkeypatch, serving):
    served_check(monkeypatch, "tiny_lm", serving)
