"""The port's greedy speculative decoding against the JAX package's:
``ngram_speculative_greedy_search`` (prompt lookup) and
``speculative_greedy_search`` (draft-verify), on the same weights
(``from_jax_params``) and the same prompts. Checks: the token sequences
equal, and the statistics (``rounds``, ``tokens_per_round``,
``accept_hist``) equal, for bf16, W4A8-served and W4A16 targets, over each
KV-cache format, with EOS and its tail semantics, and the ``max_len``
margin error; then the trained checkpoints.

JAX runs as its own tests run it on the CPU: one jitted while loop, its
single-token draft steps and cached decode on its XLA paths or its Pallas
kernels in interpret mode. Random W4A8 models part from JAX at near-ties
(ROADMAP.md, Queue 3), so the models and prompts are pinned to seeds whose
greedy tokens are far from ties; a trained checkpoint's row that parts is
listed in ``PARTED`` with the first new token that differs and both
packages' top-2 logits there.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from neural_compressor_tpu.evaluation.train_tiny import load_tiny_model
from neural_compressor_tpu.generation import speculative as jspec
from neural_compressor_tpu.models import llama as jl
from neural_compressor_tpu.quantization import RTNConfig as JRTNConfig
from neural_compressor_tpu.quantization import fuse as jfuse
from neural_compressor_tpu.quantization import quantize as j_quantize
import neural_compressor_tpu_torch as nct
from neural_compressor_tpu_torch.models import llama as tl

from test_torch_engine import CFG, SEED, flat_state, jax_meta, port_cfg, \
    serve_pair
from test_torch_kv_engine import kv_pair

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, N, NEW = 4, 2, 12


def repetitive_prompts(B: int, seed: int, vocab: int) -> np.ndarray:
    """Prompts that repeat a random 5-gram, so that prompt lookup has
    matches to propose (a random model accepts some of them)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(B):
        unit = rng.integers(0, vocab, (5,))
        rows.append(np.concatenate([rng.integers(0, vocab, (3,)), unit,
                                    rng.integers(0, vocab, (2,)), unit]))
    return np.stack(rows).astype(np.int32)


def w4a16_pair(seed: int):
    """Asymmetric int4 g128 weight-only (every projection a WOQLinear) on
    both sides."""
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**CFG), nnx.Rngs(seed))
    j_quantize(jm, JRTNConfig(dtype="int4", group_size=128, use_sym=False,
                              quant_lm_head=True))
    jfuse.fuse_for_serving(jm)
    tm = tl.from_jax_params(flat_state(jm), port_cfg(jm.cfg), device="cpu",
                            meta=jax_meta(jm))
    return jm, tm


@pytest.fixture(scope="module")
def pairs():
    built = {}

    def get(kind):
        if kind not in built:
            if kind == "w4a16":
                built[kind] = w4a16_pair(SEED)
            else:
                built[kind] = serve_pair(jl.LlamaForCausalLM(
                    jl.LlamaConfig(**CFG), nnx.Rngs(SEED)), kind == "w4a8")
        return built[kind]

    return get


def jax_ngram(jm, ids, **kw):
    seq, st = jspec.ngram_speculative_greedy_search(
        jm, jnp.asarray(ids), return_stats=True, **kw)
    return np.asarray(seq), st


def port_ngram(tm, ids, **kw):
    seq, st = nct.ngram_speculative_greedy_search(
        tm, torch.from_numpy(ids), return_stats=True, **kw)
    return seq.numpy(), st


def assert_same(want, got):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1]["rounds"] == want[1]["rounds"]
    assert got[1]["accept_hist"] == want[1]["accept_hist"]
    assert got[1]["tokens_per_round"] == pytest.approx(
        want[1]["tokens_per_round"], rel=1e-12)


# per target kind and KV format, a prompt seed whose tokens are far from
# ties and whose proposals are accepted in some rounds: of prompt seeds
# 1-8, the W4A8-served model parts from JAX at a near-tie on 1-4 and 6
# (and there plain greedy parts from JAX's greedy too), W4A16 on 1, 5, 7
# and 8, its int8 / fp8 / int4 caches on 1-2 / 5 / 3 (ROADMAP.md, Queue 3)
PROMPT_SEEDS = {"bf16": 1, "w4a8": 5, "w4a16": 6, "int8": 3, "fp8_e4m3": 3,
                "int4": 5}


@pytest.mark.parametrize("kind", ["bf16", "w4a8", "w4a16"])
def test_ngram_matches_jax(pairs, kind):
    jm, tm = pairs(kind)
    ids = repetitive_prompts(2, PROMPT_SEEDS[kind], CFG["vocab_size"])
    kw = dict(max_new_tokens=NEW, k=K, n=N)
    want = jax_ngram(jm, ids, **kw)
    got = port_ngram(tm, ids, **kw)
    assert_same(want, got)
    assert got[0].shape == (2, ids.shape[1] + NEW)
    assert sum(got[1]["accept_hist"]) == 2 * got[1]["rounds"]


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3", "int4"])
def test_ngram_kv_formats_match_jax(fmt):
    """Over quantized contiguous caches: the verify window's rows are
    quantized and written at per-row starts, then attended on the codes;
    the single-token steps take K6 (int8, fp8) or the int4 code-domain
    attention."""
    jm, tm = kv_pair("w4a16")
    for m in (jm, tm):
        m.kv_cache_format = fmt
    ids = repetitive_prompts(1, PROMPT_SEEDS[fmt], 512)
    kw = dict(max_new_tokens=10, k=K, n=N)
    assert_same(jax_ngram(jm, ids, **kw), port_ngram(tm, ids, **kw))


def test_ngram_eos_and_tail_match_jax_and_greedy(pairs):
    """An EOS inside an accepted span cuts the row there; a finished row
    repeats EOS while the other decodes, as ``greedy_search`` does."""
    jm, tm = pairs("bf16")
    ids = repetitive_prompts(2, 3, CFG["vocab_size"])
    free = nct.greedy_search(tm, torch.from_numpy(ids), max_new_tokens=NEW)
    eos = int(free[0, ids.shape[1] + 3])     # row 0's 4th new token
    kw = dict(max_new_tokens=NEW, k=K, n=N, eos_token_id=eos)
    want = jax_ngram(jm, ids, **kw)
    got = port_ngram(tm, ids, **kw)
    assert_same(want, got)
    greedy = nct.greedy_search(tm, torch.from_numpy(ids),
                               max_new_tokens=NEW, eos_token_id=eos)
    np.testing.assert_array_equal(got[0], greedy.numpy())
    assert (got[0][0, ids.shape[1] + 3:] == eos).all()


def test_short_max_len_raises(pairs):
    jm, tm = pairs("bf16")
    ids = repetitive_prompts(1, 4, CFG["vocab_size"])
    need = ids.shape[1] + NEW + K + 1
    for fn, args in ((jspec.ngram_speculative_greedy_search, (jm,)),
                     (nct.ngram_speculative_greedy_search, (tm,)),
                     (jspec.speculative_greedy_search, (jm, jm)),
                     (nct.speculative_greedy_search, (tm, tm))):
        with pytest.raises(ValueError, match=f"{need} rows"):
            fn(*args, ids, max_new_tokens=NEW, k=K, max_len=need - 1)


@pytest.mark.parametrize("draft_kind", ["w4a8", "bf16-other"])
def test_draft_verify_matches_jax(pairs, draft_kind):
    """A bf16 target with a W4A8-served sibling as the draft (high
    acceptance), or an unrelated random model (low acceptance)."""
    jt, tt = pairs("bf16")
    if draft_kind == "w4a8":
        jd, td = pairs("w4a8")
    else:
        jd, td = serve_pair(jl.LlamaForCausalLM(jl.LlamaConfig(**CFG),
                                                nnx.Rngs(SEED + 1)), False)
    ids = repetitive_prompts(2, 5, CFG["vocab_size"])
    kw = dict(max_new_tokens=NEW, k=K)
    seq, st = jspec.speculative_greedy_search(jt, jd, jnp.asarray(ids),
                                              return_stats=True, **kw)
    want = (np.asarray(seq), st)
    seq, st = nct.speculative_greedy_search(tt, td, torch.from_numpy(ids),
                                            return_stats=True, **kw)
    got = (seq.numpy(), st)
    assert_same(want, got)
    if draft_kind == "w4a8":
        assert got[1]["tokens_per_round"] > 1.5


def test_speculation_equals_greedy_on_bf16(pairs):
    """Off near-ties, both speculations give ``greedy_search``'s tokens."""
    _jm, tm = pairs("bf16")
    ids = torch.from_numpy(repetitive_prompts(2, 6, CFG["vocab_size"]))
    greedy = nct.greedy_search(tm, ids, max_new_tokens=NEW)
    torch.testing.assert_close(nct.ngram_speculative_greedy_search(
        tm, ids, max_new_tokens=NEW, k=K, n=N), greedy, rtol=0, atol=0)
    torch.testing.assert_close(nct.speculative_greedy_search(
        tm, tm, ids, max_new_tokens=NEW, k=K), greedy, rtol=0, atol=0)


# checkpoint -> {validation row: first new token that differs} under W4A8
# serving: tiny_lm row 1 at new token 7 (JAX 53, port 48), where a full
# forward of the common prefix gives both packages an exact bf16 tie of
# the top-2 logits, 48 and 53 at 7.65625 (ROADMAP.md, Queue 3: the
# engine's served tiny_lm row 1 parts at new token 7 too)
PARTED = {"tiny_lm": {1: 7}}


@pytest.mark.parametrize("name", ["tiny_lm", "tiny_gqa"])
def test_trained_checkpoints_match_jax(name):
    """Validation rows 0-3 (16-token prompts, 20 new tokens), W4A8-served:
    natural text repeats, so prompt lookup is accepted."""
    jm = load_tiny_model(name)
    if jm is None:
        pytest.fail(f"artifacts/{name} is missing")
    val = np.load(os.path.join(REPO, "artifacts", name, "corpus.npz"))["val"]
    jm, tm = serve_pair(jm, True)
    ids = val[:4, :16].astype(np.int32)
    kw = dict(max_new_tokens=20, k=K, n=N)
    want = jax_ngram(jm, ids, **kw)
    got = port_ngram(tm, ids, **kw)
    parted = PARTED.get(name, {})
    for row in range(ids.shape[0]):
        n = 16 + parted.get(row, 20)
        np.testing.assert_array_equal(got[0][row, :n], want[0][row, :n])
    if not parted:
        assert_same(want, got)
    assert got[1]["tokens_per_round"] > 1.0
