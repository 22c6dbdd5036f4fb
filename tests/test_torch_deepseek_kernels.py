"""K14 (MLA latent paging) and the repaired kernels' envelope: the port's
plain versions against the JAX package's kernels, run as its own tests run
them on the CPU (Pallas in interpret mode).

K14's attention: the plain version sums in float64 and takes one softmax
over the slot's rows; JAX's kernel sums in float32 with an online softmax
over groups of min(4, PMAX) pages. Where one group covers the slot (PMAX <=
4) the two differ by float32 rounding, which can tip a bf16 rounding of a
probability (2^-9 of that row's weight): the tolerance is 2^-9 of the
largest |latent| value. Beyond one group, JAX rounds each probability to
bf16 against its group's running max and rescales after, so each term may
differ by a bf16 rounding: 2^-7 of the largest |latent| value bounds the
sum. The write is exact. ``chip_smoke.py``'s ``deepseek_kernels`` and
``deepseek_envelope`` hold the CUDA kernels to these plain versions.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from neural_compressor_tpu.generation import greedy_search as j_greedy
from neural_compressor_tpu.kernels import paged_attention as jpa
from neural_compressor_tpu.kernels.w4a8_matmul import w4a8_matmul as j_w4a8
from neural_compressor_tpu.models import deepseek as jd
from neural_compressor_tpu.models import enable_mla_latent_cache as j_enable
from neural_compressor_tpu.models import llama as jl
import neural_compressor_tpu_torch as nct
from neural_compressor_tpu_torch.kernels import paged_attention as tpa
from neural_compressor_tpu_torch.layers.woq_linear import W4A8Linear
from neural_compressor_tpu_torch.models import deepseek as td
from neural_compressor_tpu_torch.models import llama as tl

from test_torch_kernels import _t, _weights, _x
from test_torch_engine import flat_state

torch.set_num_threads(2)
# the modules, not the functions of the same names that kernels exports
tfm = importlib.import_module(
    "neural_compressor_tpu_torch.kernels.fused_matvec")
tda = importlib.import_module(
    "neural_compressor_tpu_torch.kernels.decode_attention")

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (B, H, C, r, page, PMAX, pool dtype): deepseek-test's and tiny_mla's
# widths, ragged H (JAX pads to 8), pages of 8 and 16, one group of pages
# (PMAX <= 4) and several
ATTN_CASES = [(3, 4, 24, 16, 8, 3, "bfloat16"),
              (3, 5, 24, 16, 8, 2, "float32"),
              (4, 4, 144, 128, 16, 4, "bfloat16"),
              (4, 12, 144, 128, 8, 7, "bfloat16"),
              (2, 4, 24, 16, 8, 6, "float32")]


def _pool(rng, B, page, pmax, C, dtype):
    """A random pool of B * pmax + 1 pages and scattered block tables (page
    0 the trash page), for both packages."""
    jdt, tdt = DTYPES[dtype]
    n_pages = B * pmax + 1
    pages = rng.standard_normal((n_pages, 1, page, C)).astype(np.float32)
    bt = (rng.permutation(n_pages - 1) + 1).reshape(B, pmax).astype(np.int32)
    jp = jnp.asarray(pages).astype(jdt)
    return jp, _t(jp).to(tdt), bt


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=["x".join(map(str, c)) for c in ATTN_CASES])
def test_latent_attention_plain_matches_k14(case):
    B, H, C, r, page, pmax, dtype = case
    rng = np.random.default_rng(sum(case[:6]))
    jp, tp, bt = _pool(rng, B, page, pmax, C, dtype)
    jdt, tdt = DTYPES[dtype]
    T = page * pmax
    lengths = np.array([0, 1, T, page + 1][:B], np.int32)
    if B > 3:
        lengths[3] = T - 3
    q = rng.standard_normal((B, H, 1, C)).astype(np.float32)
    jq = jnp.asarray(q).astype(jdt)
    scale = (C - r + 8) ** -0.5
    want = np.asarray(jpa.paged_latent_attention(
        jq, jp, jnp.asarray(bt), jnp.asarray(lengths), r, scale))
    got = tpa.paged_latent_attention(_t(jq).to(tdt), tp,
                                     torch.from_numpy(bt),
                                     torch.from_numpy(lengths), r, scale)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, 1, r)
    assert not got[0].any()                    # the zero-length slot
    lat_max = float(tp[..., :r].float().abs().max())
    tol = (2.0 ** -9 if pmax <= 4 else 2.0 ** -7) * lat_max
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_latent_write_plain_matches_k14(dtype):
    """Each slot's row into its page at ``pos % page``, bit for bit: two
    idle slots on one row of the trash page (the last slot's row stands,
    as the TPU kernel's in-order grid leaves it) and page indices past the
    table (the trash page's row ``pos % page``, as JAX's interpret-mode
    write gives it). Where several slots write different rows of one page
    (only the trash page: live slots never share a page), JAX's kernel
    rewrites the whole page from its input each time, so only the last
    slot's row survives; the port writes only rows, so each stands: page 0
    is then held to the port's rule (each targeted row holds its last
    writer's row, the others are untouched)."""
    rng = np.random.default_rng(3)
    B, page, pmax, C = 5, 8, 3, 24
    jp, tp, bt = _pool(rng, B, page, pmax, C, dtype)
    bt[3:] = 0                                   # idle slots: trash page
    jdt, tdt = DTYPES[dtype]
    row = rng.standard_normal((B, C)).astype(np.float32)
    for pos in ([0, 9, 23, 5, 5], [7, 24, 30, 2, 2]):
        pos = np.asarray(pos, np.int32)
        want = np.asarray(jpa.paged_write_latent(
            jp, jnp.asarray(bt), jnp.asarray(row).astype(jdt),
            jnp.asarray(pos)).astype(jnp.float32))
        got = tp.clone()
        rows = torch.from_numpy(row).to(tdt)
        tpa.paged_write_latent(got, torch.from_numpy(bt), rows,
                               torch.from_numpy(pos))
        got = got.float().numpy()
        np.testing.assert_array_equal(got[1:], want[1:])
        trash = tp[0, 0].float().numpy().copy()
        for b in range(B):
            j = pos[b] // page
            if j >= pmax or bt[b, j] == 0:
                trash[pos[b] % page] = rows[b].float().numpy()
        np.testing.assert_array_equal(got[0, 0], trash)


def test_latent_write_takes_any_page_size():
    """JAX falls back to an XLA scatter for pages of 12 rows (the TPU's
    page % 8 rule); the port's write takes them and writes what the
    scatter writes."""
    rng = np.random.default_rng(4)
    B, page, pmax, C = 3, 12, 2, 24
    jp, tp, bt = _pool(rng, B, page, pmax, C, "float32")
    row = rng.standard_normal((B, C)).astype(np.float32)
    pos = np.array([0, 13, 23], np.int32)
    assert jpa.paged_write_latent(jp, jnp.asarray(bt), jnp.asarray(row),
                                  jnp.asarray(pos)) is None
    pids = bt[np.arange(B), pos // page]
    want = np.asarray(jp.at[pids, 0, pos % page].set(jnp.asarray(row)))
    got = tp.clone()
    tpa.paged_write_latent(got, torch.from_numpy(bt), torch.from_numpy(row),
                           torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_latent_matches_contiguous_and_jax():
    """Paged MLA decode over scattered pages reproduces the contiguous
    latent decode (JAX's ``test_paged_latent_cache_matches_contiguous``),
    and the port's paged step equals JAX's."""
    page, B, P, T = 8, 2, 12, 16
    jm = jd.DeepseekForCausalLM.from_preset("deepseek-test",
                                            dtype=jnp.float32)
    j_enable(jm)
    cfg = td.DeepseekConfig(**{f.name: getattr(jm.cfg, f.name)
                               for f in dataclasses.fields(jm.cfg)
                               if f.name != "dtype"}, dtype=torch.float32)
    tm = td.from_jax_params(flat_state(jm), cfg, device="cpu")
    assert tm.use_latent_cache
    ids = np.random.default_rng(6).integers(0, 256, (B, P))
    pos = torch.full((B, 1), P)
    lc = tm.init_caches(B, T)
    _, lc = tm(torch.from_numpy(ids), caches=lc, cache_pos=0)
    ref, _ = tm(torch.from_numpy(ids[:, :1]), positions=pos, caches=lc,
                cache_pos=P)
    bt = np.array([[3, 1], [5, 2]], np.int32)
    pools = td.init_paged_latent_pool(tm.cfg, 6, B, T, page_size=page,
                                      device="cpu")
    jpools = jd.init_paged_latent_pool(jm.cfg, 6, B, T, page_size=page)
    paged, jpaged = [], []
    for pool, jpool, c in zip(pools, jpools, lc):
        jpages = jpool.lat_pages
        for b in range(B):
            for p in range(T // page):
                rows = c.lat[b, :, p * page:(p + 1) * page]
                pool.lat_pages[int(bt[b, p])] = rows
                jpages = jpages.at[int(bt[b, p])].set(jnp.asarray(
                    rows.numpy()))
        paged.append(pool._replace(block_tables=torch.from_numpy(bt)))
        jpaged.append(jd.PagedLatentKVCache(jpages, jnp.asarray(bt)))
    got, new = tm(torch.from_numpy(ids[:, :1]), positions=pos, caches=paged,
                  cache_pos=torch.full((B,), P))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-3,
                               rtol=2e-3)
    want, _ = jm(jnp.asarray(ids[:, :1]), positions=jnp.full((B, 1), P),
                 caches=jpaged, cache_pos=jnp.full((B,), P))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                               rtol=2e-3)
    pid = int(bt[0, P // page])
    assert new[0].lat_pages[pid, 0, P % page].abs().max() > 0


@pytest.mark.parametrize("B", [1, 2])
def test_head_width_80_llama_greedy_matches_jax(B):
    """D 80 (phi-2's head width): the attention kernels take it since the
    repair (on the card: K5 at B=1, K7 at B=2, where JAX's K7 declines
    D % 128); on the CPU their plain versions, greedy tokens equal to
    JAX's, and no plain call where a kernel now runs."""
    cfg = dict(vocab_size=256, hidden_size=320, intermediate_size=256,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=128)
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**cfg), nnx.Rngs(4))
    tcfg = tl.LlamaConfig(**{f.name: getattr(jm.cfg, f.name)
                             for f in dataclasses.fields(jm.cfg)
                             if f.name != "dtype"})
    assert tcfg.head_dim == 80
    tm = tl.from_jax_params(flat_state(jm), tcfg, device="cpu")
    ids = np.random.default_rng(9).integers(0, 256, (B, 9))
    before = tda.batched_decode_attention.plain_calls
    got = nct.greedy_search(tm, torch.from_numpy(ids),
                            max_new_tokens=6).numpy()
    assert tda.batched_decode_attention.plain_calls == before
    want = np.asarray(j_greedy(jm, jnp.asarray(ids), max_new_tokens=6))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("G", [8, 16, 24])
def test_w4a8_any_group_size_matches_k1(G):
    """K1 at the "tpu_strided" group sizes below 32 that JAX's
    ``_w4a8_impl`` runs (K % tk == 0, N % 256 == 0): the port's W4A8Linear
    takes its integer GEMM (on the card the general path), the plain
    version within the float32 scale folds of JAX's."""
    from neural_compressor_tpu_torch.kernels import dequant_dot

    K, N = 48 * G, 256
    jpw, tpw = _weights(K, N, seed=G, group_size=G)
    assert tpw.group_size == G
    for M in (1, 9):
        x = _x(M, K, seed=G + M)
        before = dequant_dot.calls
        ty = W4A8Linear(tpw)(_t(x)).numpy()
        assert dequant_dot.calls == before
        jy = np.asarray(j_w4a8(x, jpw))
        assert np.abs(ty - jy).max() <= 1e-5 * np.abs(jy).max()


def test_fused_gemv_past_max_k_matches_k1():
    """K4 past ``MAX_K``: on the card a first launch quantizes the
    activation into global memory; the plain version at K = 262,144
    against JAX's K1 on the same weight (the same function, M = 1)."""
    K, N = 256 * 1024, 256
    assert K > tfm.MAX_K
    jpw, tpw = _weights(K, N, seed=21)
    x = _x(1, K, seed=22)
    ty = tfm.fused_matvec(_t(x), tpw)
    assert ty is not None
    jy = np.asarray(j_w4a8(x, jpw))
    assert np.abs(ty.numpy() - jy).max() <= 1e-5 * np.abs(jy).max()
