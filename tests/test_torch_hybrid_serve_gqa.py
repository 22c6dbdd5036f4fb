"""``test_torch_hybrid_serve.py``'s check on tiny_gqa (GQA, rep 4; its
fused qkv, N = 384, stays on "tpu_strided" words under ``s4="s4"``, as
JAX's would): JAX's hybrid-GPTQ model served by the port on "s4_rowpack"
and under ``M_INT8_THRESHOLD = 2``, greedy tokens equal to JAX's up to
the recorded partings.
"""

import pytest
import torch

from test_torch_hybrid_serve import served_check

torch.set_num_threads(2)


@pytest.mark.parametrize("serving", ["s4", "threshold2"])
def test_hybrid_served_greedy_tokens_equal_jax(monkeypatch, serving):
    served_check(monkeypatch, "tiny_gqa", serving)
