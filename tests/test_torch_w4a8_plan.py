"""The shared W4A8 core's plan (``kernels/w4a8_matmul.py`` ``gemm_plan``)
on the CPU: which path and tiles each product of the main path and of the
chip check's envelope gets, that every plan covers each group exactly once
by whole groups, the blocks the small path's design asks for; a torch
emulation of the small path's fold (its eight warps' split of K, folded
by the block in group order) against ``grouped_gemm_plain`` bit for bit;
and the plain versions of the three layouts against JAX's K1 (interpret
mode) at the plan's new thresholds.

The CUDA kernels run only on the card; ``chip_smoke.py`` holds every plan
they take to the plain version bit for bit there.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_compressor_tpu.kernels.w4a8_matmul import \
    w4a8_matmul as j_w4a8_matmul
from neural_compressor_tpu_torch.kernels import dequant_dot
from neural_compressor_tpu_torch.kernels.s4_matmul import s4_matmul
from neural_compressor_tpu_torch.kernels.w4a8_matmul import (
    KS, MAX_DYN_SMEM, SMALL_M, SMALL_WARPS, SMALL_WIDE_BLOCKS, WG_WIDE_N,
    WIDE_SMALL_M, GemmPlan, gemm_plan, grouped_gemm_plain, w4a8_matmul)
from neural_compressor_tpu_torch.ops import packing as tpk

from test_torch_w4a8_kernels import _f32, _pair

torch.set_num_threads(2)

N_SM = 132
SM_SMEM = 233472              # the H100's 228 KB of shared memory an SM
MIN_INFLIGHT = 32 * 1024      # weight bytes in flight an SM the design asks


def inflight_bytes(plan: GemmPlan, n_sm: int) -> int:
    """Raw weight bytes a small plan keeps in flight on a busy SM: the
    blocks resident there (1 KB of shared memory reserved a block, 2048
    threads an SM), their eight warps, each with its ring's slots ahead of
    the one it waits for (all but a batch), times a slot's words."""
    blocks = math.prod(plan.grid)
    fit = max(1, min(SM_SMEM // (plan.smem + 1024),
                     2048 // (32 * SMALL_WARPS)))
    resident = min(fit, -(-blocks // n_sm))
    batch = 4 if plan.stages >= 8 else 2 if plan.stages >= 4 else 1
    return (resident * SMALL_WARPS * (plan.stages - batch) * plan.bn * KS
            // 2)


LAYOUTS = ("hopper_nk", "tpu_strided", "s4_rowpack")
# llama2-7b's projections (K, N) at g128, and the (K, N, G) of the chip
# check's envelope phases (phase_envelope, phase_hybrid_envelope, K1 at
# the "tpu_strided" group sizes 8, 16, 24)
LLAMA = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096),
         (4096, 32000)]
ENVELOPE = [(256, 256, 128), (512, 768, 32), (384, 320, 128), (256, 64, 256),
            (768, 512, 32), (768, 256, 64), (1024, 256, 256),
            (768, 256, 384), (264, 256, 8), (256, 256, 16), (264, 512, 24),
            (2048, 256, 2048), (384, 256, 8), (768, 256, 16),
            (1152, 256, 24)]
CASES = [(K, N, 128) for K, N in LLAMA] + ENVELOPE
MS = (1, 8, 17, 128, 512)


def stages(plan: GemmPlan, K: int, G: int, layout: str):
    """The stages of a block along K as the core walks them (``stage_at``
    in ``csrc/w4a8_core.cuh``): [the k of each 128-slot stage], the small
    path's in the order its eight warps take them (warp w: units w, w + 8,
    ..., ``ku`` k-slots each)."""
    gathered = layout == "tpu_strided" and G > KS
    nst = K // KS
    if plan.path == "small":
        spu = plan.ku // KS
        order = [t for w in range(SMALL_WARPS) for q in range(nst)
                 if (t := (w + (q // spu) * SMALL_WARPS) * spu + q % spu)
                 < nst]
    else:
        order = list(range(nst))
    sts = []
    for t in order:
        if gathered:
            spg = G // KS
            k0, i0 = (t // spg) * G, (t % spg) * 16
            sts.append([k0 + (kk >> 4) * (G >> 3) + i0 + (kk & 15)
                        for kk in range(KS)])
        else:
            sts.append(list(range(t * KS, t * KS + KS)))
    return sts


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plan_covers_each_group_once(case, M, layout):
    """Every plan: the path its shape allows (wgmma past ``SMALL_M`` tokens,
    or past ``WIDE_SMALL_M`` at N >= ``WG_WIDE_N``), tiles that divide N,
    shared memory a block may have, each k of each group in exactly one
    stage, a small path's unit whole groups and whole stages."""
    K, N, G = case
    plan = gemm_plan(M, N, K, G, layout)
    if K % KS or G % 32 or N % 64 or (G % KS and KS % G):
        assert plan.path == "general"
        return
    if G % KS == 0 and (M > SMALL_M or (M > WIDE_SMALL_M
                                        and N >= WG_WIDE_N)):
        assert plan.path == "wgmma" and plan.ku == KS
        assert (plan.mt, plan.bn) == ((128, 128) if M > 64 and N >= WG_WIDE_N
                                      else (64, 64))
    else:
        assert plan.path == "small", plan
        assert plan.mt <= (8 if M <= 8 else 16 if M <= 16 else 32)
        assert plan.bn in (16, 32)
        # a unit: whole groups, whole stages
        assert plan.ku % G == 0 and plan.ku % KS == 0
    assert N % plan.bn == 0 and 3 <= plan.stages <= 8
    assert plan.smem <= MAX_DYN_SMEM
    assert plan.grid == (N // plan.bn, -(-M // plan.mt))
    covered = []
    for ks in stages(plan, K, G, layout):
        assert len(ks) == KS
        # a stage lies inside one group, or holds whole groups
        assert len({k // G for k in ks}) in (1, KS // G)
        covered += ks
    assert sorted(covered) == list(range(K))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("M", [1, 8])
@pytest.mark.parametrize("K,N", LLAMA, ids=lambda v: str(v))
def test_decode_steps_never_split_at_llama_widths(K, N, M, layout):
    """At llama2-7b's widths the decode steps (M 1 and 8) fill the card
    with column tiles alone, each block running all of K: at least
    ``SMALL_WIDE_BLOCKS`` blocks of eight warps, and two blocks an SM or
    32 KB of weights in flight an SM."""
    plan = gemm_plan(M, N, K, 128, layout)
    assert plan.path == "small" and len(plan.grid) == 2
    assert math.prod(plan.grid) >= SMALL_WIDE_BLOCKS
    assert (math.prod(plan.grid) >= 2 * N_SM
            or inflight_bytes(plan, N_SM) >= MIN_INFLIGHT), plan
    assert inflight_bytes(plan, N_SM) >= MIN_INFLIGHT


def split_fold(xq, codes, scales, x_scale, plan, reverse=False,
               drop_last_unit=False):
    """The small path's arithmetic in torch: its eight warps split K into
    units of ``plan.ku`` k-slots (warp w: units w, w + 8, ...), each writes
    its groups' exact integer partials (int64) times their scales in
    float32 to the round's products, and after each round of eight units
    the block adds them to its outputs in group order (or a fault: the
    whole fold in reverse order, or without the last unit's groups), then
    times x_scale."""
    M, K = xq.shape
    ng, N = scales.shape
    G = K // ng
    part = torch.einsum("mgk,gkn->gmn",
                        xq.to(torch.int64).reshape(M, ng, G),
                        codes.to(torch.int64).reshape(ng, G, N))
    gpu = plan.ku // G
    units = -(-ng // gpu)
    folded = []                     # the groups in the order the block adds
    for r in range(-(-units // SMALL_WARPS)):
        prods = {}
        for w in range(SMALL_WARPS):
            u = r * SMALL_WARPS + w
            for g in range(u * gpu, min(ng, (u + 1) * gpu)):
                prods[g] = part[g].to(torch.float32) * scales[g]
        folded += [(g, prods[g]) for g in sorted(prods)]
    if drop_last_unit:
        folded = [(g, p) for g, p in folded if g < (units - 1) * gpu]
    if reverse:
        folded = folded[::-1]
    acc = torch.zeros((M, N), dtype=torch.float32)
    for _g, p in folded:
        acc = acc + p
    return acc * x_scale[:, None]


@pytest.mark.parametrize("M,K,N,G", [(1, 256, 256, 128), (5, 512, 768, 32),
                                     (8, 768, 512, 32), (3, 4096, 256, 2048),
                                     (17, 768, 512, 64)])
def test_split_fold_is_bit_equal_to_plain(M, K, N, G):
    """The small path's split of K across its warps, folded by the block in
    group order, gives ``grouped_gemm_plain``'s bits; the faults the chip
    check plants in the fold (reverse order, where there are three groups
    or more) and one more (the last unit's groups left out) do not."""
    plan = gemm_plan(M, N, K, G, "hopper_nk")
    assert plan.path == "small"
    rng = np.random.default_rng(M * K + G)
    xq = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8))
    codes = torch.from_numpy(rng.integers(-8, 8, (K, N), dtype=np.int8))
    scales = torch.from_numpy(
        (rng.random((K // G, N)) * 0.02 + 1e-3).astype(np.float32))
    x_scale = torch.from_numpy(
        (rng.random(M) * 0.05 + 1e-3).astype(np.float32))
    want = grouped_gemm_plain(xq, codes, scales, x_scale)
    assert torch.equal(split_fold(xq, codes, scales, x_scale, plan), want)
    faults = [dict(drop_last_unit=True)]
    if K // G >= 3:   # two terms add the same either way round
        faults.append(dict(reverse=True))
    for fault in faults:
        assert not torch.equal(
            split_fold(xq, codes, scales, x_scale, plan, **fault), want)


# the layouts' plain versions against JAX's K1 at the plan's new
# boundaries, shapes the existing tests do not take: the engine's M = 8,
# M 17 and 33 around SMALL_M, G 384 ("tpu_strided": stages that take a
# third of a group's word rows) and G 64
@pytest.mark.parametrize("layout,M,K,N,G", [
    ("hopper_nk", 8, 768, 512, 384), ("hopper_nk", 33, 512, 256, 64),
    ("tpu_strided", 8, 768, 256, 384), ("tpu_strided", 17, 1024, 512, 64),
    ("s4_rowpack", 8, 512, 512, 64), ("s4_rowpack", 33, 768, 256, 384)])
def test_plain_matches_jax_k1_at_plan_boundaries(layout, M, K, N, G):
    """``w4a8_matmul`` ("hopper_nk", "tpu_strided") and ``s4_matmul``
    ("s4_rowpack") inside JAX's envelope run the plain K1/K2 here: within
    1e-6 of max|y| of JAX's K1 in interpret mode on the same codes, and
    the three layouts bit-equal to each other."""
    jpw, tpw, rng = _pair(K, N, G, seed=K + M + G)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    jy = _f32(j_w4a8_matmul(jnp.asarray(x.numpy()), jpw))
    before = dequant_dot.calls
    ys = {"tpu_strided": _f32(w4a8_matmul(x, tpw)),
          "hopper_nk": _f32(w4a8_matmul(x, tpk.to_hopper(tpw))),
          "s4_rowpack": _f32(s4_matmul(x, tpk.to_s4_rowpack(tpw)))}
    assert dequant_dot.calls == before   # the integer path, all three
    assert np.abs(ys[layout] - jy).max() <= 1e-6 * np.abs(jy).max()
    for other in ys.values():
        np.testing.assert_array_equal(ys[layout], other)
