"""The trained checkpoints (``artifacts/tiny_lm``, ``artifacts/tiny_gqa``)
quantized weight-only by the JAX package, asymmetric int4 g32 and NF4 g32
with the lm_head, and carried into the port by ``from_jax_params``: greedy
tokens and the mean NLL of the validation rows against JAX's, both on
``woq_matmul``'s CPU path (dequantize-then-dot).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_compressor_tpu.evaluation.train_tiny import load_tiny_model
from neural_compressor_tpu.generation import greedy_search as j_greedy
from neural_compressor_tpu.quantization import RTNConfig as JRTNConfig
from neural_compressor_tpu.quantization import quantize as j_quantize
import neural_compressor_tpu_torch as nct
from neural_compressor_tpu_torch.layers import WOQLinear

from test_torch_woq_llama import ASYM4, NF4, _f32, _port

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny(name, fmt):
    jm = load_tiny_model(name)
    if jm is None:
        pytest.fail(f"artifacts/{name} is missing")
    val = np.load(os.path.join(REPO, "artifacts", name, "corpus.npz"))["val"]
    j_quantize(jm, JRTNConfig(**fmt))
    return jm, val


# (checkpoint, format) -> {validation row: first new-token index that
# differs}: the two logits tie within one bf16 ulp there (ROADMAP.md,
# Queue 3); up to that step the tokens are equal
PARTED = {("tiny_gqa", "nf4_g32"): {4: 9}}
NLL_WINDOW = 64     # tokens of every validation row scored teacher-forced


@pytest.mark.parametrize("fmt", [ASYM4, NF4], ids=["asym4_g32", "nf4_g32"])
@pytest.mark.parametrize("name", ["tiny_lm", "tiny_gqa"])
def test_trained_checkpoints_greedy_tokens_equal(request, name, fmt):
    """JAX quantizes the trained checkpoint; the port takes its bytes.
    Greedy tokens on validation rows 0-4 (16-token prompts, 24 new tokens)
    are equal up to the recorded partings."""
    jm, val = _tiny(name, fmt)
    tm = _port(jm)
    assert all(type(m) is WOQLinear for n, m in tm.named_modules()
               if n.endswith("_proj") or n == "lm_head")
    ids = val[:5, :16].astype(np.int32)
    want = np.asarray(j_greedy(jm, jnp.asarray(ids), max_new_tokens=24))
    got = nct.generate(tm, torch.from_numpy(ids), max_new_tokens=24).numpy()
    parted = PARTED.get((name, request.node.callspec.id.split("-")[-1]), {})
    for row in range(5):
        n = 16 + parted.get(row, 24)
        np.testing.assert_array_equal(got[row, :n], want[row, :n])
        if row in parted:
            assert got[row, n] != want[row, n]     # still a parting


@pytest.mark.parametrize("fmt", [ASYM4, NF4], ids=["asym4_g32", "nf4_g32"])
@pytest.mark.parametrize("name", ["tiny_lm", "tiny_gqa"])
def test_trained_checkpoints_mean_nll_matches(name, fmt):
    """The mean next-token NLL over every validation row (its first
    ``NLL_WINDOW`` tokens) is within 1e-3 relative of JAX's."""
    jm, val = _tiny(name, fmt)
    tm = _port(jm)
    rows = val[:, :NLL_WINDOW].astype(np.int32)

    def nll(logits):
        lp = torch.log_softmax(torch.from_numpy(np.array(logits)), dim=-1)
        tgt = torch.from_numpy(rows[:, 1:].astype(np.int64))
        return -lp[:, :-1].gather(-1, tgt[..., None]).mean().item()

    j_nll = nll(_f32(jm(jnp.asarray(rows))))
    with torch.no_grad():
        t_nll = nll(_f32(tm(torch.from_numpy(rows))))
    assert abs(t_nll - j_nll) <= 1e-3 * j_nll, (t_nll, j_nll)
    assert 1.0 < np.exp(t_nll) < 10.0      # a trained model, not noise
