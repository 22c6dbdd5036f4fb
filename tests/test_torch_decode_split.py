"""K5's, K6's and K7's split of the keys, on the CPU: a float64 emulation
of the plan ``kernels.decode_attention.decode_plan`` gives (scores and
maxima per part, the global maximum, p, per-part partials of acc and l, the
fold in ascending part order; K5's and K6's l summed part by part before
p), held bit for bit against the plain versions
``batched_decode_attn_plain`` (K7), ``decode_attn_quant_plain`` (K6) and
``decode_attn_plain`` (K5: K6's split over bf16 rows, no raw row), which
the other tests hold against JAX. Every cache format, rep 1 to 16, head
widths 32 to 512, over a cache of three parts and a tail, at positions 0,
a part's last key, its first, the key after, T - 1 and past T (K6's raw
new row on those boundaries too).

``csrc/decode_split.cu`` runs this arithmetic on the card, where
``chip_smoke.py`` holds it to the plain versions; here the emulation shows
that cutting the keys into parts changes no bit before a kernel runs.
"""

import importlib

import numpy as np
import pytest
import torch

from neural_compressor_tpu_torch.ops import kv_quant as kq

da = importlib.import_module("neural_compressor_tpu_torch.kernels."
                             "decode_attention")

torch.set_num_threads(2)

F64, F32 = torch.float64, torch.float32
HKV = 2
PK = da.PART_KEYS
T = 3 * PK + 40                  # three whole parts and a short one
# one slot a case: key 0, a part's last key, its first, the one after, a
# later part's first, the last row, and past the end (every row, no raw row)
POS = (0, PK - 1, PK, PK + 1, 2 * PK, T - 1, T + 3)
FORMATS = {"bf16": torch.bfloat16, "int8": torch.int8,
           "fp8_e4m3": torch.float8_e4m3fn}


def _case(seed, fmt, rep, D, quant=True):
    """q, k_new, v_new, caches (codes and scales for int8/fp8) and pos."""
    rng = np.random.default_rng(seed)
    B = len(POS)

    def bf16(*shape, s=1.0):
        return torch.from_numpy((s * rng.standard_normal(shape)).astype(
            np.float32)).to(torch.bfloat16)

    q = bf16(B, HKV * rep, D, s=4.0)
    kn, vn = bf16(B, HKV, D), bf16(B, HKV, D)
    k, v = bf16(B, HKV, T, D), bf16(B, HKV, T, D)
    if fmt == "bf16":
        cache = (k, None, v, None)
    else:
        cache = (*kq.kv_quant(k, fmt), *kq.kv_quant(v, fmt))
    return q, kn, vn, cache, torch.tensor(POS, dtype=torch.int32)


def split_emulated(q, k, ks, v, vs, pos, k_new=None, v_new=None, k6=None,
                   out_dtype=torch.bfloat16, partials=None):
    """K7 (``k_new`` None), K6 or K5 (``k6`` over bf16 rows, no ``k_new``)
    as the kernels compute them, part by part, in float64 -> (out [B, H, D]
    in ``out_dtype``: bf16, or K18's float32 rows; the parts' key ranges;
    valid). ``partials``, a list, receives each part's float64 PV sums
    [B, H, D] in part order."""
    B, H, D = q.shape
    Hkv, Tc = k.shape[1], k.shape[2]
    rep = H // Hkv
    fmt = {v_: k_ for k_, v_ in FORMATS.items()}[k.dtype]
    raw_row = k_new is not None
    k6 = raw_row if k6 is None else k6
    plan = da.decode_plan(B, H, Hkv, Tc, D, fmt, k6)
    p64 = pos.to(torch.int64)
    t = torch.arange(Tc)
    valid = (t[None, :] <= p64.clamp(0, Tc - 1)[:, None])[:, None, None]
    kf, vf = da._as_f64(k), da._as_f64(v)
    scale = torch.tensor(1.0 / (D ** 0.5), dtype=F32)
    if raw_row:   # the raw new row at pos, scale 1 (none at pos >= T)
        raw = (t[None, :] == p64[:, None])[:, None, :]           # [B, 1, T]
        kf = torch.where(raw[..., None], k_new.to(F64)[:, :, None], kf)
        vf = torch.where(raw[..., None], v_new.to(F64)[:, :, None], vf)
        ks = torch.where(raw, torch.ones((), dtype=F32), ks)
        vs = torch.where(raw, torch.ones((), dtype=F32), vs)
    # launch 1: the scores in the kernels' order, then each part's maximum
    qr = q.reshape(B, Hkv, rep, D).to(F64)
    s = torch.einsum("bgrd,bgtd->bgrt", qr, kf).to(F32)
    if k6:
        s = s * (scale if ks is None else (ks * scale)[:, :, None, :])
    else:
        if ks is not None:
            s = s * ks[:, :, None, :]
        s = s * scale
    cuts = [(i * plan.part_keys, min((i + 1) * plan.part_keys, Tc))
            for i in range(plan.parts)]
    masked = torch.where(valid, s, torch.tensor(-float("inf")))
    maxima = torch.stack([masked[..., a:b].amax(dim=-1) for a, b in cuts],
                         dim=-1)
    # launch 2: p against the global maximum, partials per part, the fold
    m = maxima.amax(dim=-1, keepdim=True)
    e = torch.where(valid, torch.exp(s.to(F64) - m.to(F64)),
                    torch.zeros((), dtype=F64))
    l = torch.zeros(qr.shape[:-1], dtype=F64)
    for a, b in cuts:                      # ascending part order
        l = l + e[..., a:b].sum(dim=-1)
    pe = (e / l[..., None]).to(F32) if k6 else e.to(F32)
    if vs is not None:
        pe = pe * vs[:, :, None, :]
    p = pe.to(torch.bfloat16).to(F64)
    acc = torch.zeros(qr.shape, dtype=F64)
    for a, b in cuts:
        pv = torch.einsum("bgrt,bgtd->bgrd", p[..., a:b], vf[:, :, a:b])
        if partials is not None:
            partials.append(pv.reshape(B, H, D))
        acc = acc + pv
    out = acc.to(F32)
    if not k6:                             # K7 normalises after PV
        out = out / l.to(F32)[..., None]
    return out.reshape(B, H, D).to(out_dtype), cuts, valid


def _cover(cuts, valid):
    """Every attended (slot, key) lies in exactly one part, and the cache
    spans at least three parts."""
    t = torch.arange(valid.shape[-1])
    cover = sum(((t >= a) & (t < b)).to(torch.int64) for a, b in cuts)
    assert len(cuts) >= 3
    assert bool((cover.expand_as(valid)[valid] == 1).all())


@pytest.mark.parametrize("rep", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("D", [32, 128, 256, 384, 512])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_k7_split_equals_plain(fmt, D, rep):
    seed = 100 * list(FORMATS).index(fmt) + D + rep
    q, _kn, _vn, (k, ks, v, vs), pos = _case(seed, fmt, rep, D)
    got, cuts, valid = split_emulated(q, k, ks, v, vs, pos)
    want = da.batched_decode_attn_plain(q, k, v, pos, ks, vs)
    assert torch.equal(got, want), (fmt, D, rep)
    _cover(cuts, valid)


@pytest.mark.parametrize("rep", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("D", [32, 128, 256])
@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3", "bf16"])
def test_k6_split_equals_plain(fmt, D, rep):
    """K6 over int8 and fp8 codes; "bf16" is K5, K6's split over the bf16
    rows of a cache that already holds the new row (no raw row)."""
    seed = 7000 + 100 * (fmt == "int8") + 200 * (fmt == "bf16") + D + rep
    q, kn, vn, (k, ks, v, vs), pos = _case(seed, fmt, rep, D)
    if fmt == "bf16":
        got, cuts, valid = split_emulated(q, k, ks, v, vs, pos, k6=True)
        assert torch.equal(got, da.decode_attn_plain(q, k, v, pos)), (D, rep)
        _cover(cuts, valid)
        # the row at a part's first key carries the softmax where q is 8x
        # it: a split that lost that boundary row would not match
        p = torch.tensor([PK, 2 * PK] * 4, dtype=torch.int32)[:len(POS)]
        qk = k[range(len(POS)), :, p.long()].repeat_interleave(rep, dim=1)
        qk = (qk.float() * 8).to(torch.bfloat16)
        got, _, _ = split_emulated(qk, k, ks, v, vs, p, k6=True)
        assert torch.equal(got, da.decode_attn_plain(qk, k, v, p))
        return
    got, cuts, valid = split_emulated(q, k, ks, v, vs, pos, kn, vn)
    want = da.decode_attn_quant_plain(q, kn, vn, k, ks, v, vs, pos)
    assert torch.equal(got, want), (fmt, D, rep)
    _cover(cuts, valid)
    # the raw row carries its slot's softmax where q is k_new: a split that
    # dropped it, or attended the code row at pos, would not match
    qn = kn.repeat_interleave(rep, dim=1) * 8
    got, _, _ = split_emulated(qn, k, ks, v, vs, pos, kn, vn)
    assert torch.equal(got, da.decode_attn_quant_plain(qn, kn, vn, k, ks, v,
                                                       vs, pos))


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_a_slot_alone_equals_the_batch(fmt):
    """A slot's output does not depend on what shares its launch: each
    slot alone (B = 1) equals its row of the 7-slot batch bit for bit."""
    q, kn, vn, (k, ks, v, vs), pos = _case(9000, fmt, 4, 128)
    k6 = fmt != "bf16"
    batch, _, _ = split_emulated(q, k, ks, v, vs, pos,
                                 *((kn, vn) if k6 else ()))
    for b in range(len(POS)):
        one = [None if x is None else x[b:b + 1]
               for x in (q, k, ks, v, vs, pos, kn, vn)]
        alone, _, _ = split_emulated(*one[:6], *(one[6:] if k6 else ()))
        assert torch.equal(alone[0], batch[b]), (fmt, b)


def test_plan_depends_on_T_alone():
    """Part boundaries are absolute key positions fixed by T: the same for
    every B, H, Hkv (rep), D, format and kernel; whole 64-row tiles;
    covering the cache in at most MAX_PARTS parts."""
    for Tc in (1, 63, 64, 424, 1024, 8192, 8193, 16384, 65536):
        plans = {(B, H, Hkv, D, fmt, k6): da.decode_plan(B, H, Hkv, Tc, D,
                                                         fmt, k6)
                 for B in (1, 8) for H, Hkv in ((32, 32), (16, 8), (32, 2))
                 for D in (32, 128, 256) for fmt in FORMATS
                 for k6 in (False, True)}
        keys = {p.part_keys for p in plans.values()}
        assert len(keys) == 1, (Tc, keys)
        pk = keys.pop()
        assert pk % 64 == 0 and pk >= da.PART_KEYS
        for (B, H, Hkv, D, fmt, k6), p in plans.items():
            rep = H // Hkv
            assert p.parts * pk >= Tc > (p.parts - 1) * pk
            assert p.parts <= da.MAX_PARTS
            assert p.group_rows <= 8
            assert (p.groups - 1) * p.group_rows < rep <= (p.groups
                                                          * p.group_rows)
            assert p.grid == (p.parts, Hkv * p.groups, B)
            assert 1 <= p.stages <= min(da.RING_STAGES, pk // 64)
            assert p.lsum == int(k6 and p.parts > da.LSUM_PARTS)
            assert p.tickets == B * Hkv * p.groups
            assert p.partials == B * H * p.parts * (D + 1)
    # the main paths: llama2-7b's B=1 step at pos 517 (K6, and K5 over
    # bf16 rows) runs 5 of 8 parts on each of 32 heads, 160 blocks for 132
    # SMs
    for fmt in ("int8", "bf16"):
        plan = da.decode_plan(1, 32, 32, 1024, 128, fmt, True)
        assert (plan.part_keys, plan.parts, plan.grid) == (128, 8,
                                                           (8, 32, 1))
        assert 32 * -(-518 // plan.part_keys) > 132
    # at D 512 a group holds at most 6 rows, and the ring still fits
    plan = da.decode_plan(4, 48, 2, 1024, 512, "bf16")
    assert (plan.groups, plan.group_rows) == (4, 6) and plan.stages >= 1
    assert da._smem(512, 2, 6, plan.stages, 256, 4) <= da._MAX_DYN
