"""The trained checkpoints (``artifacts/tiny_lm``, ``artifacts/tiny_gqa``)
quantized by the JAX package with ``RTNConfig(asym int4 g32, lm_head) +
KVCacheQuantConfig`` (int8 and int4 caches), carried into the port by
``from_jax_params(kv_cache_format=...)``: greedy tokens of validation rows
0-4 as one B=5 batch (16-token prompts, 24 new tokens), the prefill
written as codes and every decode step quantizing its row before it
attends (K7's quantized branch for int8, the int4 code-domain attention).

The tiny models' heads (64 and 32 wide) are outside JAX's batched decode
kernel envelope: JAX decodes int8 with ``_grouped_attention`` on the
codes (normalised before the bf16 cast), the port with K7's order
(normalised after PV). Rows that part are listed in ``PARTED`` with
their first differing step and both packages' logits there (ROADMAP.md,
Queue 3); up to that step their tokens are equal, and the mean NLL of a
64-token prefill into the quantized cache agrees within 1e-3 relative.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import nnx

from neural_compressor_tpu.evaluation.train_tiny import load_tiny_model
from neural_compressor_tpu.generation import greedy_search as j_greedy
from neural_compressor_tpu.models import llama as jl
from neural_compressor_tpu.quantization import KVCacheQuantConfig as JKV
from neural_compressor_tpu.quantization import RTNConfig as JRTNConfig
from neural_compressor_tpu.quantization import quantize as j_quantize
import neural_compressor_tpu_torch as nct
from neural_compressor_tpu_torch.models import llama as tl

from test_torch_woq_llama import ASYM4, _flat, _meta, _port_cfg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW = 24
# (checkpoint, KV format) -> {validation row: first new-token index that
# differs}. int8 caches part nowhere; int4 caches turn the packages'
# one-ulp differences into whole code steps of later layers' K/V, which
# move the logits by up to ~0.6 (ROADMAP.md, Queue 3). At the parting,
# (JAX's token, the port's token) logits, teacher-forced on the shared
# prefix, JAX / port: tiny_lm row 0 5.9375 5.71875 / 5.90625 5.90625,
# row 3 4.84375 4.8125 / 4.5625 4.8125, row 4 11.125 10.8125 / 11.0 11.0;
# tiny_gqa row 2 5.90625 5.34375 / 5.71875 5.875
PARTED = {("tiny_lm", "int4"): {0: 16, 3: 10, 4: 23},
          ("tiny_gqa", "int4"): {2: 3}}
NLL_WINDOW = 64     # tokens of every validation row scored teacher-forced


def _tiny_pair(name, fmt):
    jm = load_tiny_model(name)
    if jm is None:
        pytest.fail(f"artifacts/{name} is missing")
    val = np.load(os.path.join(REPO, "artifacts", name, "corpus.npz"))["val"]
    j_quantize(jm, JRTNConfig(**ASYM4) + JKV(dtype=fmt))
    assert jm.kv_cache_quantized and jm.kv_cache_format == fmt
    tm = tl.from_jax_params(_flat(jm), _port_cfg(jm.cfg), device="cpu",
                            meta=_meta(jm), kv_cache_format=fmt)
    return jm, tm, val


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("name", ["tiny_lm", "tiny_gqa"])
def test_trained_checkpoints_greedy_tokens_equal(name, fmt):
    jm, tm, val = _tiny_pair(name, fmt)
    ids = val[:5, :16].astype(np.int32)
    want = np.asarray(j_greedy(jm, jnp.asarray(ids), max_new_tokens=NEW))
    got = nct.greedy_search(tm, torch.from_numpy(ids),
                            max_new_tokens=NEW).numpy()
    parted = PARTED.get((name, fmt), {})
    for row in range(5):
        n = 16 + parted.get(row, NEW)
        np.testing.assert_array_equal(got[row, :n], want[row, :n],
                                      err_msg=f"row {row}")
        if row in parted:
            assert got[row, n] != want[row, n]     # still a parting
            jy, ty = _parting_logits(jm, tm, want, got, n, fmt)
            a, b = want[row, n], got[row, n]
            # a close call in both packages: each prefers its own token by
            # less than the int4 steps' reach
            assert 0 <= jy[row, a] - jy[row, b] < 0.6, (row, jy[row, [a, b]])
            assert 0 <= ty[row, b] - ty[row, a] < 0.6, (row, ty[row, [a, b]])


def _parting_logits(jm, tm, want, got, n, fmt):
    """Both packages' last logits [5, V] before step ``n``, each fed its
    own greedy tokens (equal up to ``n`` in the row asked about) through
    its cached path: JAX jitted, as its greedy_search runs."""
    B, T = want.shape[0], want.shape[1]
    gd, st = nnx.split(jm)
    fwd = jax.jit(lambda st, ids, p, c, cp: nnx.merge(gd, st)(ids, p, c, cp))
    pos = np.tile(np.arange(16, dtype=np.int32)[None], (B, 1))
    jy, jc = fwd(st, jnp.asarray(want[:, :16]), jnp.asarray(pos),
                 jl.init_kv_cache(jm.cfg, B, T, quantized=fmt), 0)
    tc = tl.init_kv_cache(tm.cfg, B, T, quantized=fmt, device="cpu")
    with torch.no_grad():
        ty, tc = tm(torch.from_numpy(got[:, :16]), torch.from_numpy(pos),
                    tc, 0)
        for p in range(16, n):
            jy, jc = fwd(st, jnp.asarray(want[:, p:p + 1]),
                         jnp.full((B, 1), p, jnp.int32), jc, p)
            ty, tc = tm(torch.from_numpy(got[:, p:p + 1]),
                        torch.full((B, 1), p), tc, p)
    return (np.asarray(jy[:, -1].astype(jnp.float32)),
            ty[:, -1].to(torch.float32).numpy())


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("name", ["tiny_lm", "tiny_gqa"])
def test_trained_checkpoints_mean_nll_matches(name, fmt):
    """Every validation row's first ``NLL_WINDOW`` tokens prefilled into a
    quantized cache (written as codes, attended on them): the mean
    next-token NLL within 1e-3 relative of JAX's jitted forward (the int4
    partings above move single steps, not the model's fit)."""
    jm, tm, val = _tiny_pair(name, fmt)
    rows = val[:, :NLL_WINDOW].astype(np.int32)
    B = rows.shape[0]
    pos = np.tile(np.arange(NLL_WINDOW, dtype=np.int32)[None], (B, 1))
    gd, st = nnx.split(jm)
    fwd = jax.jit(lambda st, ids, p, c: nnx.merge(gd, st)(ids, p, c, 0))
    jy, _jc = fwd(st, jnp.asarray(rows), jnp.asarray(pos),
                 jl.init_kv_cache(jm.cfg, B, NLL_WINDOW, quantized=fmt))
    with torch.no_grad():
        ty, _tc = tm(torch.from_numpy(rows), torch.from_numpy(pos),
                    tl.init_kv_cache(tm.cfg, B, NLL_WINDOW, quantized=fmt,
                                     device="cpu"), 0)

    def nll(logits):
        lp = torch.log_softmax(torch.from_numpy(np.array(logits)), dim=-1)
        tgt = torch.from_numpy(rows[:, 1:].astype(np.int64))
        return -lp[:, :-1].gather(-1, tgt[..., None]).mean().item()

    j_nll = nll(np.asarray(jy.astype(jnp.float32)))
    t_nll = nll(ty.to(torch.float32).numpy())
    assert abs(t_nll - j_nll) <= 1e-3 * j_nll, (t_nll, j_nll)
    assert 1.0 < np.exp(t_nll) < 10.0      # a trained model, not noise
