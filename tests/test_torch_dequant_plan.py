"""K8's plan (``kernels/dequant_matmul.py`` ``dequant_plan``) on the CPU:
which path and tiles each product of the served models and of the chip
check's envelope gets, that every plan covers N and every word row exactly
once and fits the card; and a numpy emulation of both paths' order of
work (the small path's k-slots and its folds of warps and splits, the tile
path's stages and splits) against ``dequant_gemm_plain`` within the
bound ``chip_smoke.py``'s ``woq_tol`` holds the kernel to, for every
layout K8 takes, with and without zero points and at G 32, 64, 128 and K.

The CUDA kernel runs only on the card; ``chip_smoke.py`` holds it to the
plain version there.
"""

import numpy as np
import pytest
import torch

from neural_compressor_tpu_torch.kernels import dequant_matmul as dm
from neural_compressor_tpu_torch.kernels.w4a8_matmul import MAX_DYN_SMEM
from neural_compressor_tpu_torch.ops import pack_qtensor, quantize_tensor

torch.set_num_threads(2)

N_SM = 132
# (K, N) of the served projections: llama2-7b (fused qkv and gate_up),
# gemma2-9b (q, k/v, fused qkv, o, gate_up, down, lm_head), DeepSeek-V3's
# dense layers (q_a, q_b, kv_b, o, gate/up, fused, down, lm_head) and its
# experts (gate/up, fused, down)
LLAMA = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096),
         (4096, 32000)]
GEMMA = [(3584, 4096), (3584, 2048), (3584, 8192), (4096, 3584),
         (3584, 28672), (14336, 3584), (3584, 256000)]
DEEPSEEK = [(7168, 1536), (1536, 24576), (512, 32768), (16384, 7168),
            (7168, 18432), (7168, 36864), (18432, 7168), (7168, 129280)]
EXPERTS = [(7168, 2048), (7168, 4096), (2048, 7168)]
# (K, N, G, bits, layout) of phase_woq_envelope and gemma_envelope
ENVELOPE = ([(512, 384, G, b, "tpu_strided") for G in (32, 64, 128, 512)
             for b in (2, 4)]
            + [(512, 384, G, 8, "int8") for G in (32, 64, 128, 512)]
            + [(256, 256, 32, 4, "int8"), (1024, 896, 64, 4, "tpu_strided"),
               (4096, 32000, 128, 4, "tpu_strided"),
               (1024, 384, 64, 4, "tpu_strided")])
SERVED = [(K, N, 128, 4, "tpu_strided")
          for K, N in LLAMA + GEMMA + DEEPSEEK + EXPERTS]
MS = (1, 2, 5, 8, 9, 16, 17, 32, 100, 128, 255, 256)


def _fields(bits, layout):
    return 1 if layout == "int8" else 32 // bits


def _covered(plan, K, N, bits, layout):
    """Each split's (each small warp's) range of K in its own units: the
    small path's chunks of 8 word rows, the tile path's stages of 64
    k-slots; the ranges must be disjoint and cover K."""
    P = _fields(bits, layout)
    if plan.path == "small":
        n = -(-(K // P) // dm.SK_CHUNK)
        starts = [(z * dm.SK_WARPS + w) * plan.per
                  for z in range(plan.splits) for w in range(dm.SK_WARPS)]
    else:
        n = -(-(K // P) // (dm.TILE_KC // P))
        starts = [z * plan.per for z in range(plan.splits)]
    seen = np.zeros(n, dtype=np.int64)
    for s in starts:
        seen[min(s, n):min(s + plan.per, n)] += 1
    return seen


@pytest.mark.parametrize("x_f32", [False, True])
@pytest.mark.parametrize("case", SERVED + ENVELOPE)
def test_plan_covers_n_and_k_once_and_fits(case, x_f32):
    K, N, G, bits, layout = case
    wbytes = K * N * (8 if layout == "int8" else bits) // 8
    for M in MS:
        plan = dm.dequant_plan(M, N, K, G, bits, layout, x_f32, N_SM)
        assert plan.grid[0] * plan.bn == N, (M, plan)
        assert (_covered(plan, K, N, bits, layout) == 1).all(), (M, plan)
        # grid (columns, splits, rows) on the small path, (columns, rows,
        # splits) on the tile path: the row tiles cover M
        rows, splits = (plan.grid[2], plan.grid[1]) if plan.path == "small" \
            else plan.grid[1:]
        assert splits == plan.splits and (rows - 1) * plan.mt < M <= \
            rows * plan.mt
        if plan.path == "small":
            P = 32 // bits
            assert not x_f32 and layout == "tpu_strided"
            assert (G // P) % dm.SK_CHUNK == 0
            assert plan.smem == dm.small_smem(plan.mt, bits, plan.stages)
            assert plan.smem <= MAX_DYN_SMEM
            assert 2 <= plan.stages <= 8 and plan.bn == dm.SK_WN
        else:
            # the float32 tile kernel's dynamic shared memory
            assert 4 * (plan.mt * 64 + 64 * 128 + 16) <= MAX_DYN_SMEM
        if plan.splits > 1:   # the float32 partials under the weight
            assert plan.splits * M * N * 4 <= wbytes, (M, plan)


@pytest.mark.parametrize("K,N", LLAMA + EXPERTS)
def test_decode_step_takes_one_launch_of_the_small_path(K, N):
    """The 8-slot step (M = 8) and every M up to ``SMALL_M`` on the served
    widths: the small path, one launch whatever its split, half the SMs'
    worth of blocks or more."""
    for M in list(range(1, 33)) + [100, 128, dm.SMALL_M]:
        plan = dm.dequant_plan(M, N, K, 128, 4, "tpu_strided", False, N_SM)
        assert plan.path == "small" and plan.mt == (8 if M <= 8 else 16)
        assert plan.grid[0] * plan.grid[1] * plan.grid[2] >= N_SM // 2
    assert dm.dequant_plan(dm.SMALL_M + 1, N, K, 128, 4,
                           "tpu_strided").path == "tile"


def test_plan_declines_and_routes():
    with pytest.raises(ValueError):
        dm.dequant_plan(8, 200, 512, 64, 4, "tpu_strided")     # N % 128
    with pytest.raises(ValueError):
        dm.dequant_plan(8, 256, 500, 64, 4, "tpu_strided")     # K % G
    with pytest.raises(ValueError):
        dm.dequant_plan(8, 256, 512, 4, 4, "tpu_strided")      # G % 8
    with pytest.raises(ValueError):
        dm.dequant_plan(8, 256, 512, 64, 3, "tpu_strided")     # bits
    # groups of other than whole chunks of 8 word rows (G = 8, 24, 32 at
    # int4, 64 at int2), int8 codes, f32 x: tile
    assert dm.dequant_plan(8, 256, 512, 64, 2, "tpu_strided").path == "tile"
    for G in (8, 24, 32):
        assert dm.dequant_plan(8, 256, 768, G, 4, "tpu_strided").path \
            == "tile"
    assert dm.dequant_plan(8, 256, 512, 64, 8, "int8").path == "tile"
    assert dm.dequant_plan(8, 256, 512, 64, 4, "tpu_strided",
                           True).path == "tile"
    # cached per shape: the wrapper makes no plan call per launch
    assert dm.dequant_plan(8, 4096, 4096, 128, 4, "tpu_strided") is \
        dm.dequant_plan(8, 4096, 4096, 128, 4, "tpu_strided")


# ------------------------------------------------------------ emulation
def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(
        torch.bfloat16).float().numpy()


def _weight_fields(pw, bits, G, K):
    """The small path's weights [word row, field, column] as the kernel
    dequantizes them: the field through its exponent bits (2^23 + u, less
    2^23), then (u - (2^(b-1) + z)) * s in float32 or codebook[u] * s,
    rounded once to bf16."""
    P = 32 // bits
    wpg = G // P
    words = pw.packed.numpy().view(np.uint32)                  # [K/P, N]
    sh = (bits * np.arange(P, dtype=np.uint32))[None, :, None]
    u = (words[:, None, :] >> sh) & np.uint32((1 << bits) - 1)
    g = np.arange(K // P) // wpg
    s = pw.scales.numpy()[g][:, None, :]
    cb = dm._codebook(pw, "cpu")
    if cb is not None:
        v = cb.numpy()[u]
    else:
        fu = ((np.uint32(0x4B000000) | u).view(np.float32)
              - np.float32(2.0 ** 23))
        off = np.float32(1 << (bits - 1))
        if pw.zeros is not None:
            off = off + pw.zeros.numpy()[g][:, None, :]
        v = (fu - off).astype(np.float32)
    return _bf16((v * s).astype(np.float32))


def _step(acc, xs, ws):
    """One m16n8k16 step: the 16 exact products summed, added to the f32
    accumulator with one rounding."""
    return (acc.astype(np.float64) + xs.astype(np.float64)
            @ ws.astype(np.float64)).astype(np.float32)


def _fold(parts):
    """Partials folded in order, each add rounded to float32."""
    y = parts[0]
    for p in parts[1:]:
        y = (y + p).astype(np.float32)
    return y


def emulate_small(x, pw, bits, G, plan, fault=None):
    """The small path's order of work on the CPU: each split's eight warps
    walk their chunks of 8 word rows; x is staged as the kernel copies it
    (runs of ``xw`` word rows of one group are runs of k) and read back at
    lane (g, t)'s k-slots: field 2j of rows 2t, 2t+1 at k-slots 2t, 2t+1,
    field 2j+1 at 2t+8, 2t+9; warps folded in order, then splits.
    ``fault`` "swap" stages two word rows of a group swapped in x."""
    M, K = x.shape
    P = 32 // bits
    wpg, rows = G // P, K // P
    nchunks = -(-rows // dm.SK_CHUNK)
    xw = 8 if wpg % 8 == 0 else 4 if wpg % 4 == 0 else 2
    wf = _weight_fields(pw, bits, G, K)                        # [rows, P, N]
    N = wf.shape[-1]
    xf = x.float().numpy()
    xr = np.zeros((M, rows + dm.SK_RS, P), dtype=np.float32)   # [m, row, f]
    for r0 in range(0, rows, xw):
        for f in range(P):
            k0 = (r0 // wpg) * G + f * wpg + r0 % wpg
            xr[:, r0:r0 + xw, f] = xf[:, k0:k0 + xw]
    if fault == "swap":
        xr[:, [0, 1]] = xr[:, [1, 0]]
    splits = []
    for z in range(plan.splits):
        warps = []
        for w in range(dm.SK_WARPS):
            acc = np.zeros((M, N), dtype=np.float32)
            c_lo = min((z * dm.SK_WARPS + w) * plan.per, nchunks)
            for c in range(c_lo, min(c_lo + plan.per, nchunks)):
                for j in range(P // 2):
                    xs, ws = [], []
                    for f in (2 * j, 2 * j + 1):
                        for t in range(4):
                            for e in range(2):
                                r = 8 * c + 2 * t + e
                                ok = r < rows
                                xs.append(xr[:, r, f] if ok else
                                          np.zeros(M, np.float32))
                                ws.append(wf[r, f] if ok else
                                          np.zeros(N, np.float32))
                    acc = _step(acc, np.stack(xs, 1), np.stack(ws, 0))
            warps.append(acc)
        splits.append(_fold(warps))
    return _fold(splits)


def emulate_tile(x, pw, bits, G, layout, plan):
    """The tile path's order: stages of 64 k-slots (for "tpu_strided" 64 /
    P word rows, field s of row wl at slot wl * P + s), 16 k-slots an MMA
    step, each split's sum, then the splits in order."""
    M, K = x.shape
    w = dm.plain_weight_f32(pw.packed, pw.scales, pw.zeros,
                            dm._codebook(pw, "cpu"), bits=bits,
                            group_size=G, layout=layout, K=K,
                            dtype=x.dtype).numpy()
    xf = x.float().numpy()
    if layout == "int8":
        order = np.arange(K)
    else:
        P = 32 // bits
        wpg = G // P
        wrow = np.arange(K) // P
        s = np.arange(K) % P
        order = (wrow // wpg) * G + s * wpg + wrow % wpg
    pad = (-K) % dm.TILE_KC
    order = np.concatenate([order, np.full(pad, -1)])
    parts = []
    for z in range(plan.splits):
        acc = np.zeros((M, w.shape[1]), dtype=np.float32)
        sl = order[z * plan.per * dm.TILE_KC:(z + 1) * plan.per * dm.TILE_KC]
        for i in range(0, len(sl), 16):
            ks = sl[i:i + 16]
            ks = ks[ks >= 0]
            if len(ks):
                acc = _step(acc, xf[:, ks], w[ks])
        parts.append(acc)
    return _fold(parts)


def _bound(x, pw, y_ref):
    """``woq_tol``'s bound for K8 (chip_smoke.py): 2 * 8 sqrt(K) 2^-24
    (|x| @ |W|), plus a bf16 rounding of y where y is bf16."""
    K = x.shape[1]
    A = dm.dequantize_packed(pw, torch.float32).abs()
    tol = 2 * 8 * K ** 0.5 * 2.0 ** -24 * (x.float().abs() @ A)
    if y_ref.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * y_ref.float().abs()
    return tol.numpy()


def _weight(K, N, G, scheme, dtype, bits, seed, force_int8=False):
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn((K, N), generator=gen) * K ** -0.5
    return pack_qtensor(quantize_tensor(w, bits=bits, group_size=G,
                                        scheme=scheme, dtype=dtype),
                        force_int8=force_int8)


FORMATS = [("sym", "int", 4), ("asym", "int", 4), ("sym", "int", 2),
           ("asym", "int", 2), ("sym", "nf4", 4), ("sym", "fp4", 4),
           ("sym", "int", 8), ("asym", "int", 8)]


def _check(x, pw, G, out_dtype=torch.float32, n_sm=N_SM, fault=None):
    K, N = pw.orig_shape
    M = x.shape[0]
    layout = pw.layout
    plan = dm.dequant_plan(M, N, K, G, pw.bits, layout,
                           x.dtype == torch.float32, n_sm)
    if plan.path == "small":
        y = emulate_small(x, pw, pw.bits, G, plan, fault)
    else:
        y = emulate_tile(x, pw, pw.bits, G, layout, plan)
    ref = dm.dequant_gemm_plain(x, pw.packed, pw.scales, pw.zeros,
                                dm._codebook(pw, "cpu"), bits=pw.bits,
                                group_size=G, layout=layout,
                                out_dtype=out_dtype)
    y = torch.from_numpy(y).to(out_dtype).float().numpy()
    d = np.abs(y - ref.float().numpy())
    return plan, d, _bound(x, pw, ref)


@pytest.mark.parametrize("G", [32, 64, 128, -1])
@pytest.mark.parametrize("fmt", FORMATS)
def test_emulated_order_within_the_bound(fmt, G):
    """Every layout K8 takes, at M = 8 and 5 (one row tile of the small
    path where the layout has it) and M = 17 (two row tiles), f32 and bf16
    outputs; the tile path where the layout or G sends it there."""
    scheme, dtype, bits = fmt
    K, N = 512, 256
    pw = _weight(K, N, G, scheme, dtype, bits, seed=bits * 10 + len(scheme))
    Gk = K if G == -1 else G
    gen = torch.Generator().manual_seed(3)
    for M, out in ((8, torch.float32), (5, torch.bfloat16),
                   (17, torch.float32)):
        x = torch.randn((M, K), generator=gen).to(torch.bfloat16)
        plan, d, tol = _check(x, pw, Gk, out)
        want = ("small" if M <= dm.SMALL_M and pw.layout == "tpu_strided"
                and (Gk * bits // 32) % 8 == 0 else "tile")
        assert plan.path == want, plan
        assert (d <= tol).all(), (M, plan, float((d / tol).max()))


def test_emulated_splits_and_force_int8():
    """K split across blocks on the small path (few column tiles), folded
    in split order; "int8" codes of 4-bit weights on the tile path."""
    gen = torch.Generator().manual_seed(4)
    pw = _weight(4096, 256, 128, "asym", "int", 4, seed=5)
    x = torch.randn((8, 4096), generator=gen).to(torch.bfloat16)
    plan, d, tol = _check(x, pw, 128)
    assert plan.path == "small" and plan.splits > 1
    assert (d <= tol).all()
    pw = _weight(256, 256, 32, "asym", "int", 4, seed=6, force_int8=True)
    x = torch.randn((5, 256), generator=gen).to(torch.bfloat16)
    plan, d, tol = _check(x, pw, 32)
    assert pw.layout == "int8" and plan.path == "tile"
    assert (d <= tol).all()


def test_emulated_fault_is_flagged():
    """The bound is tight enough to see the order go wrong: two word rows
    of a group swapped in x's staging leave outputs outside it."""
    gen = torch.Generator().manual_seed(8)
    pw = _weight(1024, 256, 128, "asym", "int", 4, seed=9)
    x = torch.randn((8, 1024), generator=gen).to(torch.bfloat16)
    _plan, d, tol = _check(x, pw, 128)
    assert (d <= tol).all()
    _plan, d, tol = _check(x, pw, 128, fault="swap")
    assert (d > tol).sum() > 0
