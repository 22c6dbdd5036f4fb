"""K14's split of a slot's latent rows, on the CPU: a float64 emulation of
the plan ``kernels.paged_attention.latent_plan`` gives (scores and maxima
per part, the global maximum, p against it, per-part partials of acc and
l, the fold in ascending part order), held bit for bit against the plain
version ``paged_latent_attn_plain``, which
``tests/test_torch_deepseek_kernels.py`` holds against JAX. Head widths of
deepseek-test (H 4, C 24, r 16), tiny_mla (H 20, C 144, r 128) and 128
heads, pages of 8, 16 and 128 rows, over a table of three parts and a
tail, at lengths 0, 1, a part's last row, its first, the row after, a
later part's first and the whole table.

``csrc/paged_latent.cu`` runs this arithmetic on the card, where
``chip_smoke.py`` holds it to the plain version; here the emulation shows
that cutting the rows into parts changes no bit before a kernel runs, and
that a flash-decoding fold (p rounded against each part's own maximum,
rescaled afterwards) would.
"""

import numpy as np
import pytest
import torch

from neural_compressor_tpu_torch.kernels import paged_attention as pa

torch.set_num_threads(2)

F64, F32 = torch.float64, torch.float32
SHAPES = [(4, 24, 16), (20, 144, 128), (128, 72, 64)]
PAGES = [8, 16, 128]


def _table(page):
    """(part rows, PMAX pages a slot): three whole parts and a tail of 40
    rows."""
    pr = pa.latent_plan(1, 1, 8, 8, page, 1).part_rows
    return pr, -(-(3 * pr + 40) // page)


def _lengths(pr, Tv):
    """Slot lengths (the new row included): none, one row, a part's last
    row, its first, the row after, a later part's first, the whole table."""
    return (0, 1, pr, pr + 1, pr + 2, 2 * pr + 1, Tv)


def _case(seed, H, C, page):
    rng = np.random.default_rng(seed)
    pr, pmax = _table(page)
    lengths = _lengths(pr, pmax * page)
    B = len(lengths)
    n_pages = B * pmax + 1
    bt = (rng.permutation(B * pmax) + 1).reshape(B, pmax)

    def bf16(*shape, s=1.0):
        return torch.from_numpy((s * rng.standard_normal(shape)).astype(
            np.float32)).to(torch.bfloat16)

    return (bf16(B, H, C, s=2.0), bf16(n_pages, 1, page, C),
            torch.from_numpy(bt.astype(np.int32)),
            torch.tensor(lengths, dtype=torch.int32))


def split_emulated(q, pages, bt, lengths, r, scale, flash=False):
    """K14's attention as the kernels compute it, part by part, in float64
    -> (out [B, H, r] float32, the parts' row ranges). ``flash``: the
    mutation, a flash-decoding fold that rounds p against each part's own
    maximum and rescales the partials by exp(m_part - m) afterwards."""
    B, H, C = q.shape
    page, PMAX = pages.shape[2], bt.shape[1]
    plan = pa.latent_plan(B, H, C, r, page, PMAX)
    lat = pa._gather_pages(pages, bt.to(torch.int64))[:, 0].to(F64)
    Tv = lat.shape[1]
    valid = (torch.arange(Tv)[None, :] < lengths.to(torch.int64)[:, None])
    valid = valid[:, None, :]                                # [B, 1, Tv]
    # launch 1: scores, rounded once, then each part's maximum
    s = torch.einsum("bhc,btc->bht", q.to(F64), lat).to(F32)
    s = s * torch.tensor(scale, dtype=F32)
    cuts = [(i * plan.part_rows, min((i + 1) * plan.part_rows, Tv))
            for i in range(plan.parts)]
    masked = torch.where(valid, s, torch.tensor(-float("inf")))
    maxima = torch.stack([masked[..., a:b].amax(dim=-1) for a, b in cuts],
                         dim=-1)                             # [B, H, parts]
    m = maxima.amax(dim=-1, keepdim=True)
    # launch 2: p against the global maximum, partials per part, the fold
    acc = torch.zeros(B, H, r, dtype=F64)
    l = torch.zeros(B, H, dtype=F64)
    for i, (a, b) in enumerate(cuts):                        # ascending
        mp = maxima[..., i:i + 1] if flash else m
        e = torch.where(valid[..., a:b],
                        torch.exp(s[..., a:b].to(F64) - mp.to(F64)),
                        torch.zeros((), dtype=F64))
        p = e.to(F32).to(torch.bfloat16).to(F64)
        acc_p = torch.einsum("bht,btc->bhc", p, lat[:, a:b, :r])
        l_p = e.sum(dim=-1)
        if flash:   # rescale to the global maximum (empty parts: 0)
            w = torch.exp(mp.to(F64) - m.to(F64))
            w = torch.where(torch.isfinite(mp), w, torch.zeros((), dtype=F64))
            acc_p, l_p = acc_p * w, l_p * w[..., 0]
        acc, l = acc + acc_p, l + l_p
    out = acc.to(F32) / l.to(F32)[..., None].clamp_min(1e-30)
    out = torch.where((lengths > 0).reshape(B, 1, 1), out,
                      torch.zeros((), dtype=F32))
    return out, cuts


def _cover(cuts, lengths, Tv):
    """Every attended row lies in exactly one part; the table spans three
    whole parts and a tail."""
    t = torch.arange(Tv)
    cover = sum(((t >= a) & (t < b)).to(torch.int64) for a, b in cuts)
    assert len(cuts) >= 4 and bool((cover == 1).all())
    assert cuts[-1][1] == Tv and max(lengths) == Tv


@pytest.mark.parametrize("page", PAGES)
@pytest.mark.parametrize("H,C,r", SHAPES)
def test_split_equals_plain(H, C, r, page):
    q, pages, bt, lengths = _case(1000 * page + H, H, C, page)
    scale = (C - r + 8) ** -0.5
    got, cuts = split_emulated(q, pages, bt, lengths, r, scale)
    want = pa.paged_latent_attn_plain(q, pages, bt, lengths, r, scale)
    assert torch.equal(got, want), (H, C, r, page)
    _cover(cuts, lengths.tolist(), bt.shape[1] * page)


@pytest.mark.parametrize("page", PAGES)
def test_a_slot_alone_equals_the_batch(page):
    """A slot's output does not depend on what shares its call: each slot
    alone (B = 1, its own plan) equals its row of the batch bit for bit,
    over the same part boundaries."""
    H, C, r = 20, 144, 128
    q, pages, bt, lengths = _case(7 + page, H, C, page)
    batch, cuts = split_emulated(q, pages, bt, lengths, r, 0.125)
    for b in range(len(lengths)):
        alone, cuts1 = split_emulated(q[b:b + 1], pages, bt[b:b + 1],
                                      lengths[b:b + 1], r, 0.125)
        assert cuts1 == cuts
        assert torch.equal(alone[0], batch[b]), (page, b)
        assert torch.equal(alone[0], pa.paged_latent_attn_plain(
            q[b:b + 1], pages, bt[b:b + 1], lengths[b:b + 1], r, 0.125)[0])


@pytest.mark.parametrize("page", PAGES)
def test_a_flash_decoding_fold_fails(page):
    """The mutation: p rounded against each part's own maximum, partials
    rescaled afterwards. It leaves the slots of one part alone and moves
    every slot of two or more full parts by more than the card's tolerance
    (1e-5 of the slot's largest |output|, chip_smoke.lat_tol): there one
    part's p round against a maximum that is not the slot's. (A second part
    of one row moves its slot only where that row's weight is large.)"""
    H, C, r = 128, 72, 64
    q, pages, bt, lengths = _case(31 + page, H, C, page)
    want = pa.paged_latent_attn_plain(q, pages, bt, lengths, r, 0.125)
    got, cuts = split_emulated(q, pages, bt, lengths, r, 0.125, flash=True)
    pr = cuts[0][1]
    tol = 1e-5 * want.abs().amax(dim=(1, 2)) + 1e-30
    d = (got - want).abs().amax(dim=(1, 2))
    for b, n in enumerate(lengths.tolist()):
        if n <= pr:
            assert torch.equal(got[b], want[b]), (page, n)
        elif n > 2 * pr:
            assert d[b] > tol[b], (page, n, float(d[b]), float(tol[b]))


def test_plan_depends_on_the_page_alone():
    """Part boundaries are absolute row positions fixed by the page size:
    the same for every B, H, C, r and PMAX; whole pages up to PART_ROWS
    rows; covering the table. The row blocks of 4096 / HEAD_GROUP rows and
    the column passes of 8192 / HEAD_GROUP cover the table and r; the PV
    launch's ring and p rows fit a block's shared memory."""
    for page in (1, 8, 16, 64, 100, 128, 512, 600, 4096):
        plans = {(B, H, C, r, PMAX): pa.latent_plan(B, H, C, r, page, PMAX)
                 for B in (1, 8) for H, C, r in ((4, 24, 16), (20, 144, 128),
                                                 (128, 576, 512),
                                                 (128, 1024, 1024))
                 for PMAX in (1, 5, 32)}
        rows = {p.part_rows for p in plans.values()}
        assert len(rows) == 1, (page, rows)
        pr = rows.pop()
        assert 1 <= pr <= pa._LAT_MAX_PART_ROWS
        if page <= pa.PART_ROWS:
            assert pr % page == 0 and pr <= pa.PART_ROWS < pr + page
        else:
            assert pr == pa.PART_ROWS
        for (B, H, C, r, PMAX), p in plans.items():
            Tv = PMAX * page
            assert p.parts * pr >= Tv > (p.parts - 1) * pr
            assert p.row_blocks * 4096 // pa.HEAD_GROUP >= Tv
            assert (p.passes - 1) * pa._LAT_NCC < r <= p.passes * pa._LAT_NCC
            assert pa._latent_pv_smem(pr) <= pa._LAT_MAX_DYN
            assert (p.scores, p.maxima, p.partials) == (
                B * H * Tv, B * H * p.row_blocks, B * H * p.parts * (r + 1))
    # the main path: deepseek-v3's 8-slot step over 4096-row tables of
    # 128-row pages, parts of 4 pages
    plan = pa.latent_plan(8, 128, 576, 512, 128, 32)
    assert (plan.part_rows, plan.parts, pa.HEAD_GROUP) == (512, 8, 32)
    assert (plan.row_blocks, plan.passes) == (32, 2)
