"""The quantized-KV-cache slice against the JAX package at the model
level: the seeded GQA llama of ``test_torch_kv_engine.py`` (RTN int4 g128
+ ``KVCacheQuantConfig``), W4A16 and W4A8, in each KV format.

Checks: teacher-forced prefill and decode logits (the prefill written as
codes and attended on them; B=1 decode through K6's raw new row for
int8/fp8, the int4 code-domain attention) within 5e-2 of max|logit|, and
for W4A8 also with the port's fused B=1 decode (which reaches K6 through
``_fused_call``) within 0.1: its int8 activation codes flip at one bf16
ulp of their input, and it rounds elsewhere than JAX's modular path
(ROADMAP.md, Queue 3); and ``greedy_search``, which allocates caches in
the model's KV format, giving JAX's tokens at B=1 and B=2 (the row's codes
written first, then K7 or the int4 attention).
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_compressor_tpu.generation import greedy_search as j_greedy
from neural_compressor_tpu.models import llama as jl
import neural_compressor_tpu_torch as nct
from neural_compressor_tpu_torch.models import llama as tl

from test_torch_kv_engine import FORMATS, _f32, _ids, _set_format, kv_pair

torch.set_num_threads(2)

LOGIT_TOL = 5e-2
FUSED_TOL = 1e-1


@pytest.fixture(scope="module", params=["w4a16", "w4a8"])
def pair(request):
    return (request.param, *kv_pair(request.param))


def _logit_steps(model, cfg, init, call, seq, P, fmt):
    """Teacher-forced logits: a P-token prefill, then one step a token."""
    caches = init(cfg, 1, 32, quantized=fmt)
    pos = np.arange(P, dtype=np.int32)[None]
    y, caches = call(model, seq[:, :P], pos, caches, 0)
    out = [_f32(y)[:, -1]]
    for p in range(P, seq.shape[1]):
        y, caches = call(model, seq[:, p:p + 1],
                         np.full((1, 1), p, np.int32), caches, p)
        out.append(_f32(y)[:, -1])
    return np.stack(out)


def _jax_call(m, ids, pos, caches, cp):
    return m(jnp.asarray(ids), jnp.asarray(pos), caches, cp)


@torch.no_grad()
def _port_call(m, ids, pos, caches, cp):
    return m(torch.from_numpy(ids), torch.from_numpy(pos), caches, cp)


@pytest.mark.parametrize("fmt", FORMATS)
def test_prefill_and_decode_logits_match_jax(pair, fmt):
    """A 12-token prefill into a quantized cache, then 6 teacher-forced
    B=1 decode steps; W4A8 also on the port's fused decode."""
    kind, jm, tm = pair
    seq = _ids(1, 18, seed=1)
    want = _logit_steps(jm, jm.cfg, jl.init_kv_cache, _jax_call, seq, 12,
                        fmt)

    def port_init(cfg, B, T, quantized):
        return tl.init_kv_cache(cfg, B, T, quantized=quantized, device="cpu")

    models = [(tm, LOGIT_TOL)]
    if kind == "w4a8":
        fused = copy.deepcopy(tm)
        nct.enable_fused_decode(fused)
        models.append((fused, FUSED_TOL))
    for m, tol in models:
        got = _logit_steps(m, tm.cfg, port_init, _port_call, seq, 12, fmt)
        err = np.abs(got - want).max(axis=-1)          # per step
        assert (err <= tol * np.abs(want).max(axis=-1)).all(), (fmt, err)


@pytest.mark.parametrize("fmt", FORMATS)
def test_greedy_search_tokens_match_jax(pair, fmt):
    """B=1 and B=2, 6 new tokens each."""
    _kind, jm, tm = pair
    _set_format((jm, tm), fmt)
    for B, seed in ((1, 2), (2, 4)):
        ids = _ids(B, 9, seed)
        want = np.asarray(j_greedy(jm, jnp.asarray(ids), max_new_tokens=6))
        got = nct.greedy_search(tm, torch.from_numpy(ids), max_new_tokens=6)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"B={B}")
