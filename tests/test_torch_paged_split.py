"""K11's split of the keys, on the CPU: a float64 emulation of the plan
``kernels.paged_attention.split_plan`` gives (scores and maxima per part,
the global maximum, p, per-part partials of acc, l and corr, and the fold
in ascending part order), held bit for bit against the plain version
``paged_window_attn_plain`` in every pool format, single queries and
windows, rep 1 and 2, with gemma's band and softcap, at lengths on a
part's last key, its first and the one after, and a slot of length 0.

``csrc/paged_attention.cu`` runs this arithmetic on the card, where
``chip_smoke.py`` holds it to the plain version; here the emulation shows
that cutting the keys into parts changes no bit before the kernel runs.
"""

import importlib

import numpy as np
import pytest
import torch

from neural_compressor_tpu_torch.ops import kv_quant as kq
from neural_compressor_tpu_torch.ops.activations import softcap as _softcap

pa = importlib.import_module("neural_compressor_tpu_torch.kernels."
                             "paged_attention")

torch.set_num_threads(2)

F64, F32 = torch.float64, torch.float32
PAGE, PMAX, D, HKV = 128, 12, 32, 2
# one slot a case: a part's last key (512 keys, the single query's last key
# 511), its first (513: key 512), the one after, the whole table, a band
# slot, a short slot, and a slot of length 0
LENGTHS = (512, 513, 514, PMAX * PAGE, 1500, 37, 0)
WINDOW, CAP = 700, 50.0     # band start 800 at length 1500: inside part 1


def _pool(rng, fmt, n_pages):
    """A random pool (k_pages, k_scales, v_pages, v_scales, k_offs,
    v_offs) in ``fmt``, quantized the port's way."""
    def rows():
        return torch.from_numpy(rng.standard_normal(
            (n_pages, HKV, PAGE, D)).astype(np.float32)).to(torch.bfloat16)
    if fmt == "bf16":
        return rows(), None, rows(), None, None, None
    if fmt == "int4":
        k = kq.kv_quant4_asym_codes(rows())
        v = kq.kv_quant4_asym_codes(rows())
        return (kq.kv_pack_page_int4(k[0]), k[1], kq.kv_pack_page_int4(v[0]),
                v[1], k[2], v[2])
    k, v = kq.kv_quant(rows(), fmt), kq.kv_quant(rows(), fmt)
    return k[0], k[1], v[0], v[1], None, None


def _case(seed, fmt, W, rep):
    rng = np.random.default_rng(seed)
    B = len(LENGTHS)
    n_pages = B * PMAX + 1
    pool = _pool(rng, fmt, n_pages)
    bt = torch.from_numpy(rng.permutation(n_pages - 1)[:B * PMAX] + 1
                          ).to(torch.int32).reshape(B, PMAX)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    q = torch.from_numpy(4 * rng.standard_normal(
        (B, HKV * rep, W, D)).astype(np.float32)).to(torch.bfloat16)
    return q, pool, bt, lengths


def split_emulated(q, k_pages, k_scales, v_pages, v_scales, block_tables,
                   lengths, k_offs=None, v_offs=None, window=None,
                   softcap=None):
    """K11 as its two launches compute it, part by part, in float64 ->
    (out [B, H, W, D], the parts' key ranges, valid [B, 1, rows, T])."""
    fmt = pa.pool_format(k_pages, k_scales, k_offs)
    B, H, Wq, Dq = q.shape
    Hkv = k_pages.shape[1]
    rep = H // Hkv
    rows = Wq * rep
    page = k_pages.shape[2] * (2 if fmt == "int4" else 1)
    plan = pa.split_plan(B, H, Hkv, Wq, Dq, page, block_tables.shape[1])
    bt = block_tables.to(torch.int64)
    k = pa._gather_rows(k_pages, bt)
    v = pa._gather_rows(v_pages, bt)
    T = k.shape[2]
    qr = (q.reshape(B, Hkv, rep, Wq, Dq).transpose(2, 3)
          .reshape(B, Hkv, rows, Dq).to(F64))
    w_of = torch.div(torch.arange(rows), rep, rounding_mode="floor")
    qpos = lengths.to(torch.int64).reshape(B, 1) - Wq + w_of[None, :]
    t = torch.arange(T)[None, None, :]
    valid = t < (qpos + 1).clamp(0, T)[:, :, None]
    if window is not None:
        valid = valid & (qpos[:, :, None] - t < window)
    valid = valid[:, None]
    # launch A: scores, then each row's maximum over each part
    s = torch.einsum("bgrd,bgtd->bgrt", qr, k).to(F32)
    if k_scales is not None:
        s = s * pa._gather_pages(k_scales, bt)[:, :, None, :]
    if fmt == "int4":
        s = s + (qr.sum(dim=-1).to(F32)[..., None]
                 * pa._gather_pages(k_offs, bt)[:, :, None, :])
    s = s * (1.0 / (Dq ** 0.5))
    if softcap is not None:
        s = _softcap(s, softcap)
    cuts = [(i * plan.part_keys, min((i + 1) * plan.part_keys, T))
            for i in range(plan.parts)]
    masked = torch.where(valid, s, torch.tensor(-float("inf")))
    maxima = torch.stack([masked[..., a:b].amax(dim=-1) for a, b in cuts],
                         dim=-1)
    # launch B: p against the global maximum, partials per part, the fold
    m = maxima.amax(dim=-1, keepdim=True)
    e = torch.where(valid, torch.exp(s.to(F64) - m.to(F64)),
                    torch.zeros((), dtype=F64))
    pe = e.to(F32)
    if k_scales is not None:
        pe = pe * pa._gather_pages(v_scales, bt)[:, :, None, :]
    p = pe.to(torch.bfloat16).to(F64)
    cterm = (e.to(F32).to(F64) * pa._gather_pages(v_offs, bt).to(F64)[
        :, :, None, :] if fmt == "int4" else torch.zeros_like(e))
    acc = torch.zeros(qr.shape, dtype=F64)
    l = torch.zeros(qr.shape[:-1], dtype=F64)
    corr = torch.zeros_like(l)
    for a, b in cuts:                      # ascending part order
        acc = acc + torch.einsum("bgrt,bgtd->bgrd", p[..., a:b],
                                 v[:, :, a:b])
        l = l + e[..., a:b].sum(dim=-1)
        corr = corr + cterm[..., a:b].sum(dim=-1)
    out = acc.to(F32)
    if fmt == "int4":
        out = out + corr.to(F32)[..., None]
    out = out / l.to(F32).clamp_min(1e-30)[..., None]
    out = (out.reshape(B, Hkv, Wq, rep, Dq).transpose(2, 3)
           .reshape(B, H, Wq, Dq).to(q.dtype))
    return out, cuts, valid


BRANCHES = {"plain": {}, "band_softcap": dict(window=WINDOW, softcap=CAP),
            "softcap": dict(softcap=CAP)}


@pytest.mark.parametrize("W,rep", [(1, 1), (1, 2), (4, 1), (4, 2)])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8_e4m3", "int4"])
def test_split_equals_plain(fmt, W, rep):
    seed = 1000 + 10 * W + rep + 100 * list(pa._FMT_CODE).index(fmt)
    q, pool, bt, lengths = _case(seed, fmt, W, rep)
    kp, ks, vp, vs, ko, vo = pool
    for name, kw in BRANCHES.items():
        got, cuts, valid = split_emulated(q, kp, ks, vp, vs, bt, lengths,
                                          ko, vo, **kw)
        want = pa.paged_window_attn_plain(q, kp, ks, vp, vs, bt, lengths,
                                          ko, vo, **kw)
        assert torch.equal(got, want), (fmt, W, rep, name)
        # every attended (row, key) lies in exactly one part
        t = torch.arange(valid.shape[-1])
        cover = sum(((t >= a) & (t < b)).to(torch.int64) for a, b in cuts)
        assert bool((cover.expand_as(valid)[valid] == 1).all())
        assert len(cuts) > 2 and int(valid.sum()) > 0
        # the zero-length slot gives exact zeros
        assert not bool(got[LENGTHS.index(0)].to(F32).any())
        if W > 1:   # each window row is the single query at its length
            for w in range(W):
                one, _, _ = split_emulated(
                    q[:, :, w:w + 1].contiguous(), kp, ks, vp, vs, bt,
                    (lengths - W + w + 1).clamp_min(0), ko, vo, **kw)
                assert torch.equal(one[:, :, 0], got[:, :, w]), (name, w)


def test_plan_depends_on_the_page_alone():
    """Part boundaries are absolute key positions fixed by the page size:
    the same for every W, rep, B and D; whole pages; covering the table."""
    for page in (1, 16, 100, 128, 256, 1024):
        plans = {(B, H, Hkv, W, Dq): pa.split_plan(B, H, Hkv, W, Dq, page, 40)
                 for B in (1, 8) for H, Hkv in ((32, 32), (16, 8), (36, 4))
                 for W in (1, 9) for Dq in (16, 128, 256)}
        keys = {p.part_keys for p in plans.values()}
        assert len(keys) == 1
        pk = keys.pop()
        assert pk % page == 0 and pk >= page
        for (B, H, Hkv, W, Dq), p in plans.items():
            rows = W * H // Hkv
            assert p.parts * pk >= 40 * page > (p.parts - 1) * pk
            assert p.group_rows <= 8
            assert (p.groups - 1) * p.group_rows < rows <= (p.groups
                                                           * p.group_rows)
            assert p.grid == (p.parts, Hkv * p.groups, B)
    plan = pa.split_plan(8, 16, 8, 1, 256, 128, 64)
    assert plan.part_keys == 512 and plan.parts == 16
    assert plan.grid == (16, 8, 8)
    assert plan.partials == (8, 8, 2, 16, 258) and plan.tickets == 64
    # a window of 9 rows at rep 4: 36 rows in five groups of at most 8
    plan = pa.split_plan(2, 16, 4, 9, 128, 128, 128)
    assert (plan.groups, plan.group_rows) == (5, 8)
    assert plan.scores == (8, 40, 128 * 128)
