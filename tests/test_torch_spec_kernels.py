"""The speculative verify window's kernels against the JAX package, on the
same numpy inputs: K13's plain version (``paged_write_window_plain``)
against ``paged_write_window``, and K11's W-query window
(``paged_window_attn_plain``) against ``paged_window_attention``, in each
pool format (bf16, int8, fp8-e4m3, int4).

JAX runs as its own tests run it on the CPU: its Pallas kernels in
interpret mode. Off the TPU JAX's ``paged_write_window`` takes no fp8
pool and the caller writes fp8 windows row by row (``_paged_write_row``,
jitted as the engine's programs run it: eager JAX divides ``amax / 448``
truly where ``jit`` multiplies by ``f32(1/448)``); the port's fp8 window
is held to that. ``chip_smoke.py`` holds the CUDA kernels to the plain
versions on the card.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_compressor_tpu.kernels import paged_attention as jpa
from neural_compressor_tpu.models import llama as jl
from neural_compressor_tpu_torch.models import llama as tl
from neural_compressor_tpu_torch.ops import kv_quant as kq

tpa = importlib.import_module("neural_compressor_tpu_torch.kernels."
                              "paged_attention")

torch.set_num_threads(2)

FORMATS = ("bf16", "int8", "fp8_e4m3", "int4")
# the JAX kernel's envelope: D % 128, page % 128, Hkv % 8, W <= page
HKV, D, PAGE, W = 8, 128, 128, 9
PMAX = 3


def _bytes(x) -> np.ndarray:
    """An array's bytes, whatever its dtype."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view(torch.uint8).numpy() if x.element_size() == 1 \
            else x.view(torch.int16 if x.element_size() == 2
                        else torch.int32).numpy().view(np.uint8)
    return np.asarray(x).view(np.uint8)


def _bf(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pools(rng, P, fmt, Hkv=HKV, page=PAGE, D=D):
    """(JAX cache, port cache) holding the same random pool in ``fmt``,
    quantized by the port's quantizers (bit-equal to JAX's jitted ones)."""
    rows = [torch.from_numpy(_bf(rng, P, Hkv, page, D)).to(torch.bfloat16)
            for _ in range(2)]
    if fmt == "bf16":
        parts = (rows[0], None, rows[1], None, None, None)
    elif fmt == "int4":
        k4 = kq.kv_quant4_asym_codes(rows[0])
        v4 = kq.kv_quant4_asym_codes(rows[1])
        parts = (kq.kv_pack_page_int4(k4[0]), k4[1],
                 kq.kv_pack_page_int4(v4[0]), v4[1], k4[2], v4[2])
    else:
        kc, ks = kq.kv_quant(rows[0], fmt)
        vc, vs = kq.kv_quant(rows[1], fmt)
        parts = (kc, ks, vc, vs, None, None)
    bt = np.zeros((4, PMAX), np.int32)
    perm = rng.permutation(np.arange(1, P))
    for b in range(3):                      # slot 3 idle: all trash page
        bt[b] = perm[b * PMAX:(b + 1) * PMAX]

    def jx(t):
        if t is None:
            return None
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy().view(
                jnp.bfloat16))
        if t.dtype == torch.float8_e4m3fn:
            return jnp.asarray(t.view(torch.uint8).numpy().view(
                jnp.float8_e4m3fn))
        return jnp.asarray(t.numpy())

    kp, ks, vp, vs, ko, vo = parts
    jc = jl.PagedKVCache(jx(kp), jx(ks), jx(vp), jx(vs), jnp.asarray(bt),
                         jx(ko), jx(vo))
    tc = tl.PagedKVCache(kp, ks, vp, vs, torch.from_numpy(bt), ko, vo)
    return jc, tc


# window starts of the 4 slots: in-page, crossing a page boundary, crossing
# into a page past the table (rows to the trash page), an idle slot parked
# at the end of an all-trash table
POS = {"in_page": [5, 130, 300, PMAX * PAGE - 1],
       "crossing": [PAGE - 4, 2 * PAGE - 1, 60, PMAX * PAGE - 1],
       "overshoot": [PMAX * PAGE - 5, 70, PAGE - 9, PMAX * PAGE - 1]}


def _assert_pools_equal(jc, tc, fmt):
    """Every page but the trash page 0 byte for byte (several slots write
    page 0 in one call; neither package orders them)."""
    names = ["k_pages", "v_pages"]
    if fmt != "bf16":
        names += ["k_scales", "v_scales"]
    if fmt == "int4":
        names += ["k_offs", "v_offs"]
    for name in names:
        a = _bytes(getattr(tc, name))[1:]
        b = _bytes(getattr(jc, name))[1:]
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("where", sorted(POS))
@pytest.mark.parametrize("fmt", FORMATS)
def test_window_write_matches_jax(fmt, where):
    """K13's plain version against ``paged_write_window`` (the interpret-
    mode kernel; fp8 JAX's per-row writes): pools byte-equal, codes,
    scales and offsets."""
    rng = np.random.default_rng(FORMATS.index(fmt) * 7 + len(where))
    jc, tc = _pools(rng, 3 * PMAX + 1, fmt)
    pos = np.asarray(POS[where], np.int32)
    kn = _bf(rng, 4, HKV, W, D)
    vn = _bf(rng, 4, HKV, W, D)
    jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (kn, vn))
    tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (kn, vn))
    got = tpa.paged_write_window(tc, tk, tv, torch.from_numpy(pos))
    assert got is tc
    want = jpa.paged_write_window(jc, jk, jv, jnp.asarray(pos))
    if fmt == "fp8_e4m3":
        assert want is None         # off the TPU: JAX writes row by row
        want = jc
        row = jax.jit(jl._paged_write_row)   # jitted: amax * f32(1/448)
        for w in range(W):
            want = row(want, jk[:, :, w:w + 1], jv[:, :, w:w + 1],
                       jnp.asarray(pos + w))
    _assert_pools_equal(want, got, fmt)


def test_window_write_takes_the_jax_envelope():
    """Both packages decline the same shapes (the caller then writes row
    by row): W > page, D % 128, page % 128, Hkv % 8."""
    rng = np.random.default_rng(5)
    for Hkv, page, D_, Wn in ((8, 32, 128, 9), (4, 128, 128, 9),
                              (8, 128, 64, 9), (8, 128, 128, 129)):
        jc, tc = _pools(rng, 2 * PMAX + 4, "int8", Hkv, page, D_)
        kn = _bf(rng, 4, Hkv, Wn, D_)
        pos = np.zeros(4, np.int32)
        assert jpa.paged_write_window(
            jc, jnp.asarray(kn).astype(jnp.bfloat16),
            jnp.asarray(kn).astype(jnp.bfloat16), jnp.asarray(pos)) is None
        t = torch.from_numpy(kn).to(torch.bfloat16)
        assert tpa.paged_write_window(tc, t, t,
                                      torch.from_numpy(pos)) is None


def test_window_targets():
    """In-page, crossing, past the table, a clipped first page."""
    bt = torch.tensor([[4, 5], [6, 7], [0, 0]], dtype=torch.int32)
    pid, r = tpa.window_targets(bt, torch.tensor([3, 14, 30]), 16, 4)
    assert pid.tolist() == [[4] * 4, [6, 6, 7, 7], [0] * 4]
    assert r.tolist() == [[3, 4, 5, 6], [14, 15, 0, 1], [14, 15, 0, 1]]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("H", [8, 16], ids=["rep1", "rep2"])
def test_window_attention_matches_jax(fmt, H):
    """``paged_window_attn_plain`` against ``paged_window_attention``
    within 1e-2 of max|out| (the TPU kernel sums in float32 with an online
    softmax over 4-page groups, the port in float64 in one pass), and each
    window row bit-equal to the single-query plain version at its length.
    Lengths: a short window (some rows attend nothing past the prompt), a
    window crossing a page, a full table, a zero-length slot."""
    rng = np.random.default_rng(11 + FORMATS.index(fmt) + H)
    jc, tc = _pools(rng, 3 * PMAX + 1, fmt)
    lengths = np.array([W - 2, PAGE + 4, PMAX * PAGE, 0], np.int32)
    q = _bf(rng, 4, H, W, D)
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    jo = np.asarray(jpa.paged_window_attention(
        jq, jc, jnp.asarray(lengths)).astype(jnp.float32))
    to = tpa.paged_window_attention(tq, tc, torch.from_numpy(lengths))
    assert to.dtype == torch.bfloat16 and tuple(to.shape) == (4, H, W, D)
    assert np.abs(to.float().numpy() - jo).max() <= 1e-2 * np.abs(jo).max()
    assert not to[3].float().any() and not jo[3].any()     # zero length
    args = (tc.k_pages, tc.k_scales, tc.v_pages, tc.v_scales,
            tc.block_tables)
    for w in range(W):
        one = tpa.paged_attn_plain(
            tq[:, :, w], *args, torch.from_numpy(lengths - W + w + 1),
            tc.k_offs, tc.v_offs)
        assert torch.equal(one, to[:, :, w]), w


def test_paged_attend_writes_and_attends_a_window():
    """``LlamaAttention._attend``'s paged branch at S = W: the window's
    rows written by K13 and attended by K11's window equal writing them
    one row at a time and attending each row as a single query."""
    cfg = tl.LlamaConfig(vocab_size=64, hidden_size=HKV * D,
                         intermediate_size=64, num_hidden_layers=1,
                         num_attention_heads=HKV, num_key_value_heads=HKV,
                         max_position_embeddings=512)
    attn = tl.LlamaAttention(cfg, device="cpu")
    rng = np.random.default_rng(3)
    B = 4
    _jc, c1 = _pools(rng, 3 * PMAX + 1, "int8")
    c2 = tl.PagedKVCache(*(None if t is None else t.clone() for t in c1))
    q, k, v = (torch.from_numpy(_bf(rng, B, HKV, W, D)).to(torch.bfloat16)
               for _ in range(3))
    pos = torch.tensor(POS["crossing"])
    out, c1 = attn._attend(torch.bfloat16, q, k, v, None, c1, pos)
    rows = []
    for w in range(W):
        o, c2 = attn._attend(torch.bfloat16, q[:, :, w:w + 1],
                             k[:, :, w:w + 1], v[:, :, w:w + 1], None, c2,
                             pos + w)
        rows.append(o)
    for a, b in zip(c1, c2):
        if a is not None and a is not c1.block_tables:
            assert torch.equal(a[1:], b[1:])
    assert torch.equal(out.reshape(B, W, -1)[:3],
                       torch.cat(rows, dim=1).reshape(B, W, -1)[:3])
