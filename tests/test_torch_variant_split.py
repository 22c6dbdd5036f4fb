"""K16's in-kernel write and K18's attention on K5's and K6's split of the
keys, on the CPU: the float64 emulation of the split
(``test_torch_decode_split.split_emulated``) held bit for bit against the
plain versions that the other tests hold against JAX.

* K16's bf16 write (``decode_attn_write_plain`` over bf16 caches): every
  block whose part holds pos stages the new row in place of the cache's,
  and group 0's block stores it, so the split is K5's over the written
  cache; output and caches equal the plain version's.
* K16's int8 write: the new rows quantized by the TPU kernel's rule (a
  numpy float32 version here, an all-zero row among them), scored as codes
  times the new scale and read back from the cache by PV; output, codes and
  scales equal the plain version's. Attending the raw row (K6's rule) or
  quantizing by ``_kv_quant``'s rule must fail.
* K18 (``attn_o_plain``): the split's float32 rows equal ``_attend_plain``'s;
  one amax over the blocks' maxima through ``fused_gemv_plain`` gives
  ``attn_o_plain``. The amax of one key part, or of one head, must fail.

Every case runs rep 1, 4, 8 and 16, D 32, 128 and 256 (K18's projection
at D 128 and 256, its group size), over a cache of three parts and a tail,
at positions 0, a part's last key, its first, the key after, a later
part's first, T - 1 and past T (``test_torch_decode_split.POS``).
``csrc/decode_attention.cu`` and ``csrc/attn_o.cu`` run this arithmetic on
the card, where ``chip_smoke.py`` holds it to the plain versions.
"""

import importlib

import numpy as np
import pytest
import torch

from neural_compressor_tpu_torch.ops import kv_quant as kq
from neural_compressor_tpu_torch.ops.packing import pack_codes_hopper
from test_torch_decode_split import F32, POS, _case, _cover, split_emulated

da = importlib.import_module("neural_compressor_tpu_torch.kernels."
                             "decode_attention")
fm = importlib.import_module("neural_compressor_tpu_torch.kernels."
                             "fused_matvec")

torch.set_num_threads(2)

REPS = [1, 4, 8, 16]
DS = [32, 128, 256]


def _written(caches, rows, pos):
    """Copies of ``caches`` [B, Hkv, T, ...] with each slot's row of
    ``rows`` [B, Hkv, ...] at pos < T, as group 0's block stores it."""
    out = [c.clone() for c in caches]
    T = caches[0].shape[2]
    for b, p in enumerate(pos.tolist()):
        if 0 <= p < T:
            for c, r in zip(out, rows):
                c[b, :, p] = r[b].to(c.dtype)
    return out


def _k16_quant(x):
    """The kernel's int8 rule in numpy float32: scale = f32(max(amax,
    1e-6) * f32(1/127)), codes clip(rint(x / scale), -127, 127)."""
    xf = x.float().numpy()
    sc = (np.maximum(np.abs(xf).max(axis=-1), np.float32(1e-6))
          * np.float32(1 / 127)).astype(np.float32)
    codes = np.clip(np.rint(xf / sc[..., None]), -127, 127)
    return torch.from_numpy(codes.astype(np.int8)), torch.from_numpy(sc)


def _int8_case(rep, D, seed):
    """An int8 case whose new k row of slot 0, KV head 1, is all zero."""
    q, kn, vn, cache, pos = _case(seed, "int8", rep, D)
    kn = kn.clone()
    kn[0, 1] = 0
    return q, kn, vn, cache, pos


@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("D", DS)
def test_k16_bf16_write_split_equals_plain(D, rep):
    q, kn, vn, (k, _ks, v, _vs), pos = _case(11000 + D + rep, "bf16", rep, D)
    kp, vp = k.clone(), v.clone()
    want = da.decode_attn_write_plain(q, kn, vn, kp, None, vp, None, pos)
    ke, ve = _written((k, v), (kn, vn), pos)
    got, cuts, valid = split_emulated(q, ke, None, ve, None, pos, k6=True)
    assert torch.equal(got, want), (D, rep)
    assert torch.equal(ke, kp) and torch.equal(ve, vp)
    _cover(cuts, valid)


@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("D", DS)
def test_k16_int8_write_split_equals_plain(D, rep):
    q, kn, vn, cache, pos = _int8_case(rep, D, 12000 + D + rep)
    plain = [t.clone() for t in cache]
    want = da.decode_attn_write_plain(q, kn, vn, *plain, pos)
    (kc, ksc), (vc, vsc) = _k16_quant(kn), _k16_quant(vn)
    k, ks, v, vs = _written(cache, (kc, ksc, vc, vsc), pos)
    got, cuts, valid = split_emulated(q, k, ks, v, vs, pos, k6=True)
    assert torch.equal(got, want), (D, rep)
    for a, b in zip((k, ks, v, vs), plain):
        assert torch.equal(a, b)
    assert float(ksc[0, 1]) == np.float32(1e-6) * np.float32(1 / 127)
    _cover(cuts, valid)


@pytest.mark.parametrize("rep", [1, 16])
def test_k16_int8_write_mutations_fail(rep):
    """The raw new row attended (K6's function) and ``_kv_quant``'s rule
    (scale 1 on the all-zero row, clip to -128) are other functions."""
    D = 128
    q, kn, vn, cache, pos = _int8_case(rep, D, 13000 + rep)
    plain = [t.clone() for t in cache]
    want = da.decode_attn_write_plain(q, kn, vn, *plain, pos)
    (kc, ksc), (vc, vsc) = _k16_quant(kn), _k16_quant(vn)
    k, ks, v, vs = _written(cache, (kc, ksc, vc, vsc), pos)
    raw, _, _ = split_emulated(q, k, ks, v, vs, pos, kn, vn)
    assert not torch.equal(raw, want)
    kc2, ksc2 = kq.kv_quant(kn[:, :, None], "int8")
    _k2, ks2 = _written(cache[:2], (kc2[:, :, 0], ksc2[:, :, 0]), pos)
    assert not torch.equal(ks2, plain[1])      # the all-zero row's scale


def _k18_weight(rng, K, N, G):
    codes = rng.integers(-8, 8, (K, N)).astype(np.int8)
    sc = (rng.random((K // G, N)) * 0.02 + 0.002).astype(np.float32)
    return pack_codes_hopper(torch.from_numpy(codes)), torch.from_numpy(sc)


def _project(rows, amax, w, sc, res):
    """K18's o-projection of float32 ``rows`` [K] at the scale of
    ``amax``: codes, the grouped int4 dot, times the scale, the residual."""
    s = amax * torch.tensor(1 / 127, dtype=F32)
    s = torch.where(s <= 0, torch.ones_like(s), s)
    codes = torch.clamp(torch.round(rows / s), -128, 127)
    return (fm.group_dot(codes, w, sc) * s + res.float()).to(torch.bfloat16)


def _block_amax(rows, Hkv, rep, T):
    """One amax as the split takes it: each emitting block's max |o| over
    its group's rows, then the maximum of those (an atomicMax)."""
    plan = da.decode_plan(1, Hkv * rep, Hkv, T, rows.shape[-1], "bf16", True)
    g = rows.abs().reshape(Hkv, plan.groups, -1).amax(dim=-1)
    return g.max()


@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("D", DS)
def test_k18_rows_split_equal_attend_plain(D, rep):
    q, _kn, _vn, (k, _ks, v, _vs), pos = _case(14000 + D + rep, "bf16", rep,
                                               D)
    rows, cuts, valid = split_emulated(q, k, None, v, None, pos, k6=True,
                                       out_dtype=F32)
    assert torch.equal(rows, da._attend_plain(q, k, v, pos)), (D, rep)
    _cover(cuts, valid)
    if D not in (128, 256):            # K18's envelope: G == D
        return
    rng = np.random.default_rng(D + rep)
    H = q.shape[1]
    N = 256
    w, sc = _k18_weight(rng, H * D, N, D)
    res = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(
        torch.bfloat16)
    for b in range(len(POS)):
        r = rows[b].reshape(-1)
        assert torch.equal(_block_amax(rows[b], k.shape[1], rep,
                                       k.shape[2]),
                           r.abs().max())
        y = fm.fused_gemv_plain(r, None, w, sc, None, res, eps=0.0,
                                silu=False, out_dtype=torch.bfloat16)
        want = fm.attn_o_plain(q[b], k[b], v[b], int(pos[b]), w, sc, res)
        assert torch.equal(y, want), (D, rep, b)
        assert torch.equal(_project(r, r.abs().max(), w, sc, res), want)


@pytest.mark.parametrize("rep", [1, 4])
def test_k18_amax_mutations_fail(rep):
    """The scale from one key part's rows (an amax taken before the
    fold), or from one head's, is another function."""
    D, N = 128, 256
    q, _kn, _vn, (k, _ks, v, _vs), pos = _case(15000 + rep, "bf16", rep, D)
    b = POS.index(POS[-2])             # T - 1: every part holds keys
    parts = []
    rows, _, _ = split_emulated(q, k, None, v, None, pos, k6=True,
                                out_dtype=F32, partials=parts)
    assert len(parts) >= 3
    rng = np.random.default_rng(rep)
    w, sc = _k18_weight(rng, q.shape[1] * D, N, D)
    res = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(
        torch.bfloat16)
    r = rows[b].reshape(-1)
    want = fm.attn_o_plain(q[b], k[b], v[b], int(pos[b]), w, sc, res)
    assert torch.equal(_project(r, r.abs().max(), w, sc, res), want)
    # part 0's partial sums, and the head whose rows reach the least
    one_part = parts[0][b].to(F32).abs().max()
    one_head = rows[b].abs().amax(dim=-1).min()
    for amax in (one_part, one_head):
        assert amax != r.abs().max()
        assert not torch.equal(_project(r, amax, w, sc, res), want)
