"""K15's split of a slot's pages, on the CPU: a float64 emulation of the
plan ``kernels.paged_attention.v1_plan`` gives (scores and each page's
maximum, the running maximum up to each page as fmaxf over the page maxima,
per-page partials S_p, l_p and alpha_p, and the fold that replays v1's
recurrence l = l * alpha_p + l_p, acc = acc * alpha_p + S_p in ascending
page order), held bit for bit against the plain version
``paged_attn_v1_plain``, which ``test_torch_variant_kernels.py`` holds
against JAX. bf16, int8 and fp8 pools, rep 1 to 16, head widths 64, 80 and
128, at lengths 0, 1, a page, a page and one, a part's last key and its
first, the full table, and idle slots on the trash page 0.

Each mutation of the split must part from the plain version: the global
maximum (K11's fold, which rounds p against the wrong maximum), a running
maximum restarted at each part (parts combined as flash decoding combines
them), the fold in reverse page order, and a part-boundary key dropped.

``csrc/paged_attention_v1.cu`` runs this arithmetic on the card, where
``chip_smoke.py`` holds it to the plain version; here the emulation shows
that cutting the pages into parts changes no bit before the kernel runs.
"""

import importlib

import numpy as np
import pytest
import torch

from neural_compressor_tpu_torch.ops import kv_quant as kq

pa = importlib.import_module("neural_compressor_tpu_torch.kernels."
                             "paged_attention")

torch.set_num_threads(2)

F64, F32 = torch.float64, torch.float32
PAGE, PMAX, HKV = 32, 40, 2
PK = pa.split_plan(1, 1, 1, 1, 64, PAGE, PMAX).part_keys     # 512 keys
# one slot a case: empty, one key, a page, a page and one, a part's last key
# (length PK), its first (PK + 1), the full table, and two idle slots on the
# trash page 0 (lengths 0 and 1)
LENGTHS = (0, 1, PAGE, PAGE + 1, PK, PK + 1, PMAX * PAGE, 0, 1)
IDLE = (7, 8)
FORMATS = ("bf16", "int8", "fp8_e4m3")


def _case(seed, fmt, rep, D):
    """q [B, H, D], a pool (k_pages, k_scales, v_pages, v_scales), block
    tables [B, PMAX] (the idle slots all on page 0) and lengths."""
    rng = np.random.default_rng(seed)
    B = len(LENGTHS)
    n_pages = (B - len(IDLE)) * PMAX + 1

    def rows():
        return torch.from_numpy(rng.standard_normal(
            (n_pages, HKV, PAGE, D)).astype(np.float32)).to(torch.bfloat16)

    if fmt == "bf16":
        pool = (rows(), None, rows(), None)
    else:
        pool = (*kq.kv_quant(rows(), fmt), *kq.kv_quant(rows(), fmt))
    bt = np.zeros((B, PMAX), np.int32)
    live = [b for b in range(B) if b not in IDLE]
    bt[live] = (rng.permutation(n_pages - 1) + 1).reshape(len(live), PMAX)
    q = torch.from_numpy(4 * rng.standard_normal(
        (B, HKV * rep, D)).astype(np.float32)).to(torch.bfloat16)
    return (q, pool, torch.from_numpy(bt),
            torch.tensor(LENGTHS, dtype=torch.int32))


def split_emulated(q, k_pages, k_scales, v_pages, v_scales, block_tables,
                   lengths, mutation=None):
    """K15 as its two launches compute it, page by page inside parts of
    whole pages, in float64 -> (out [B, H, D] bf16, the parts' key
    ranges). ``mutation`` plants a fault: "global_max", "restart",
    "reverse" or "drop_boundary"."""
    fmt = pa.pool_format(k_pages, k_scales)
    B, H, D = q.shape
    Hkv, page = k_pages.shape[1], k_pages.shape[2]
    pmax = block_tables.shape[1]
    rep = H // Hkv
    plan = pa.v1_plan(B, H, Hkv, D, page, pmax)
    kpp = plan.part_keys // page                 # pages a part
    bt = block_tables.to(torch.int64)
    k = pa._gather_rows(k_pages, bt)             # [B, Hkv, T, D] float64
    v = pa._gather_rows(v_pages, bt)
    T = k.shape[2]
    t = torch.arange(T)
    n = lengths.to(torch.int64).clamp(max=T)
    valid = (t[None, :] < n[:, None])                        # [B, T]
    if mutation == "drop_boundary":              # part 1's first key lost
        valid = valid & (t[None, :] != plan.part_keys)
    valid = valid[:, None, None, :]
    # launch 1: the scores, then each page's maximum over its valid keys
    qr = q.reshape(B, Hkv, rep, D).to(F64)
    s = torch.einsum("bgrd,bgtd->bgrt", qr, k).to(F32)
    scale = torch.tensor(1.0 / (D ** 0.5), dtype=F32)
    if k_scales is not None:
        s = s * (pa._gather_pages(k_scales, bt) * scale)[:, :, None, :]
    else:
        s = s * scale
    pages = (B, Hkv, rep, pmax, page)
    page_max = torch.where(valid, s, torch.tensor(-float("inf"))).reshape(
        pages).amax(dim=-1)                                  # [B,Hkv,rep,P]
    # launch 2: the running maximum up to each page (restarted at each
    # part's first page by the mutation), p, the page partials
    run = torch.empty_like(page_max)     # the maximum up to each page
    prev = torch.empty_like(page_max)    # ... up to the page before it
    m = torch.full(page_max.shape[:-1], -1e30, dtype=F32)
    for pg in range(pmax):
        if mutation == "restart" and pg % kpp == 0:
            m = torch.full_like(m, -1e30)
        prev[..., pg] = m
        m = torch.fmax(m, page_max[..., pg])
        run[..., pg] = m
    if mutation == "global_max":
        run = page_max.amax(dim=-1, keepdim=True).expand_as(run)
        prev = torch.cat([torch.full_like(run[..., :1], -1e30),
                          run[..., 1:]], dim=-1)
    alpha = torch.exp(prev.to(F64) - run.to(F64))           # [B,Hkv,rep,P]
    e = torch.exp(s.to(F64).reshape(pages) - run.to(F64)[..., None]).to(F32)
    e = torch.where(valid.reshape(B, 1, 1, pmax, page), e,
                    torch.zeros((), dtype=F32))
    l_p = e.to(F64).sum(dim=-1)
    pe = e
    if v_scales is not None:
        pe = pe * pa._gather_pages(v_scales, bt).reshape(
            B, Hkv, 1, pmax, page)
    p = pe.to(torch.bfloat16).to(F64)
    S_p = torch.einsum("bgrjt,bgjtd->bgrjd", p,
                       v.reshape(B, Hkv, pmax, page, D))
    # the fold: the pages a slot visits, in ascending order (the mutation
    # "restart" folds each part from its restarted maximum and rescales
    # the parts to the global maximum, as flash decoding adds them)
    npages = (n + page - 1) // page
    span = kpp if mutation == "restart" else pmax
    l = torch.zeros(qr.shape[:-1], dtype=F64)
    acc = torch.zeros(qr.shape, dtype=F64)
    for p0 in range(0, pmax, span):
        lp, ap = torch.zeros_like(l), torch.zeros_like(acc)
        pgs = range(p0, min(p0 + span, pmax))
        for pg in reversed(pgs) if mutation == "reverse" else pgs:
            on = (pg < npages)[:, None, None]
            lp = torch.where(on, lp * alpha[..., pg] + l_p[..., pg], lp)
            ap = torch.where(on[..., None], ap * alpha[..., pg, None]
                             + S_p[..., pg, :], ap)
        if mutation == "restart":
            w = torch.exp(run[..., pgs[-1]].to(F64)
                          - run.amax(dim=-1).to(F64))
            lp, ap = lp * w, ap * w[..., None]
        l, acc = l + lp, acc + ap
    out = acc.to(F32) / l.to(F32).clamp_min(1e-30)[..., None]
    out = torch.where((lengths > 0).reshape(B, 1, 1, 1), out,
                      torch.zeros((), dtype=F32))
    cuts = [(i * plan.part_keys, min((i + 1) * plan.part_keys, T))
            for i in range(plan.parts)]
    return out.reshape(B, H, D).to(torch.bfloat16), cuts


MUTATIONS = ("global_max", "restart", "reverse", "drop_boundary")


@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("rep", [1, 4, 8, 16])
@pytest.mark.parametrize("fmt", FORMATS)
def test_split_equals_plain(fmt, rep, D):
    seed = 500 + 100 * FORMATS.index(fmt) + 10 * rep + D
    q, (kp, ks, vp, vs), bt, lengths = _case(seed, fmt, rep, D)
    got, cuts = split_emulated(q, kp, ks, vp, vs, bt, lengths)
    want = pa.paged_attn_v1_plain(q, kp, ks, vp, vs, bt, lengths)
    assert torch.equal(got, want), (fmt, rep, D)
    # the table spans parts; every key lies in exactly one
    t = torch.arange(PMAX * PAGE)
    cover = sum(((t >= a) & (t < b)).to(torch.int64) for a, b in cuts)
    assert len(cuts) >= 3 and bool((cover == 1).all())
    # empty slots give exact zeros; the idle slot on page 0 attends its row
    for b, n in enumerate(LENGTHS):
        assert bool(got[b].to(F32).any()) == (n > 0), b


@pytest.mark.parametrize("mutation", MUTATIONS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_each_mutation_parts_from_plain(fmt, mutation):
    """Each planted fault of the split moves bits, in each pool format; on
    the slots whose keys lie in one part the faults that only act across
    parts leave every bit as it was."""
    q, (kp, ks, vp, vs), bt, lengths = _case(900 + FORMATS.index(fmt), fmt,
                                             4, 128)
    want = pa.paged_attn_v1_plain(q, kp, ks, vp, vs, bt, lengths)
    got, _ = split_emulated(q, kp, ks, vp, vs, bt, lengths, mutation)
    assert not torch.equal(got, want), (fmt, mutation)
    if mutation in ("restart", "drop_boundary"):
        short = [b for b, n in enumerate(LENGTHS) if n <= PK]
        assert torch.equal(got[short], want[short]), (fmt, mutation)


def test_plan_depends_on_the_page_alone():
    """Part boundaries are absolute key positions fixed by the page size:
    the same for every B, rep and D; whole pages; covering the table; the
    scratch sized for a partial of D + 2 a page."""
    for page in (1, 16, 32, 100, 128, 256, 1024):
        plans = {(B, H, Hkv, Dq): pa.v1_plan(B, H, Hkv, Dq, page, 40)
                 for B in (1, 8) for H, Hkv in ((32, 32), (16, 8), (32, 2))
                 for Dq in (16, 80, 128, 256)}
        keys = {p.part_keys for p in plans.values()}
        assert len(keys) == 1
        pk = keys.pop()
        assert pk % page == 0 and pk >= page
        assert pk == max(1, pa.PART_KEYS // page) * page
        for (B, H, Hkv, Dq), p in plans.items():
            rep = H // Hkv
            rows = B * Hkv * p.groups * p.group_rows
            assert p.parts * pk >= 40 * page > (p.parts - 1) * pk
            assert p.group_rows <= 8
            assert (p.groups - 1) * p.group_rows < rep <= (p.groups
                                                          * p.group_rows)
            assert p.grid == (p.parts, Hkv * p.groups, B)
            assert p.scores == rows * 40 * page
            assert p.maxima == rows * 40
            assert p.partials == rows * 40 * (Dq + 2)
            assert p.tickets == B * Hkv * p.groups
    # the check's pools: 8 slots of 8 pages of 128 rows, llama2-7b's heads:
    # parts of 4 pages, 2 a slot, 2 MB of float64 partials
    plan = pa.v1_plan(8, 32, 32, 128, 128, 8)
    assert (plan.part_keys, plan.parts, plan.grid) == (512, 2, (2, 32, 8))
    assert plan.partials * 8 == 8 * 32 * 8 * 130 * 8
