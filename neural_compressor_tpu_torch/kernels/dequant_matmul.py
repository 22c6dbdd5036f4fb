"""Weight-only (W4A16) products ``y = x @ dequant(Wq)`` and their dispatch.

The counterpart of ``neural_compressor_tpu/kernels/dequant_matmul.py``:
  * ``dequant_gemm`` (K8; the TPU kernel ``_dequant_matmul_impl``): the
    weight is dequantized tile by tile, rounded to x's dtype and multiplied
    with float32 accumulation; for 1 <= M <= 256;
  * ``vpu_gemv`` (K9; the TPU kernel ``_vpu_matvec_impl``): the M == 1
    product in float32 without rounding the weight, factored per group;
  * ``vpu_int8act`` (K10; the TPU kernel ``_vpu_matvec_int_impl``): the
    all-integer M == 1 product of a W4A8 decode step, x quantized to int8
    per tensor, integer sums over the words' fields, the float work per
    group and per K tile; reached through ``vpu_matvec_int8act`` from a
    ``W4A8Linear`` on "tpu_strided" words below a raised
    ``M_INT8_THRESHOLD``;
  * ``woq_matmul``: the dispatcher. ``"auto"`` on the card takes K9 at
    M == 1 (K8 where K9 declines), K8 up to M = 256 and dequantize-then-
    ``torch.matmul`` above; off the card it takes dequantize-then-matmul,
    as the JAX package does off the TPU. ``impl="vpu"`` / ``"pallas"``
    force K9 / K8 (their plain versions for CPU tensors), as JAX's ``impl=``
    runs its Pallas kernels in interpret mode.

The CUDA kernels (K8's ``csrc/dequant_matmul.cu``; K9's
``csrc/vpu_gemv.cu`` and K10's ``csrc/vpu_int8act.cu`` on their shared
streaming core, ``csrc/vpu_gemv.cuh``) read the "tpu_strided" words and
"int8" codes as the JAX package stores them. K8's path and tiles come from
``dequant_plan``, K9's and K10's strips, splits and rings from
``gemv_plan`` (both cached per shape; the C entries check the plan they
are given), their scratch and argument blocks from ``gemv_workspace``.
Dequantize-then-matmul is no kernel: ``dequant_dot`` counts its calls in
``.calls``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ..ops.packing import (LANE_BITS, PackedWeight, dequantize_packed,
                           resolve_double_quant, unpack_codes)
from ..ops.qtensor import CODEBOOKS, FLOAT_CODE_DTYPES
from . import _build
from .w4a8_matmul import MAX_DYN_SMEM

IMPLS = ("auto", "pallas", "xla", "vpu")
_DEFAULT_IMPL = "auto"
# M at or below this is the weight-bound decode regime: K8
DECODE_M_THRESHOLD = 256


def set_default_impl(impl: str) -> None:
    """The impl that ``woq_matmul`` takes when its caller names none."""
    global _DEFAULT_IMPL
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    _DEFAULT_IMPL = impl


def _rows(x: torch.Tensor) -> int:
    M = 1
    for d in x.shape[:-1]:
        M *= d
    return M


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


@functools.lru_cache(maxsize=None)
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _gather_perm(x2: torch.Tensor, pw: PackedWeight):
    """Rows stored permuted: contract x in the stored order."""
    if pw.perm is None:
        return x2, pw
    return (x2.index_select(-1, pw.perm.to(x2.device, torch.int64)),
            pw._replace(perm=None))


def dequant_dot(x: torch.Tensor, pw: PackedWeight, cdt, out_dtype) -> torch.Tensor:
    """Dequantize to ``cdt``, then a float32 ``torch.matmul``: the JAX
    package's XLA path (``jnp.dot(..., preferred_element_type=f32)``). Not
    a kernel: each call adds one to ``dequant_dot.calls``, so a run can
    show which shapes took it."""
    dequant_dot.calls += 1
    K, N = pw.orig_shape
    lead = x.shape[:-1]
    x2, pw = _gather_perm(x.reshape(-1, K), resolve_double_quant(pw))
    y = torch.matmul(x2.to(cdt).to(torch.float32), dot_weight_f32(pw, cdt))
    return y.to(out_dtype).reshape(*lead, N)


dequant_dot.calls = 0


def dot_weight_f32(pw: PackedWeight, cdt) -> torch.Tensor:
    """The weight [K, N] ``dequant_dot`` multiplies: dequantized to
    ``cdt``, as float32."""
    return dequantize_packed(pw, out_dtype=cdt).to(torch.float32)


def _codebook(pw: PackedWeight, device):
    """The 16-float table of a codebook dtype (nf4, fp4) on ``device``, or
    None; made once per dtype and device."""
    if pw.dtype in FLOAT_CODE_DTYPES:
        return _codebook_on(pw.dtype, torch.device(device))
    return None


@functools.lru_cache(maxsize=None)
def _codebook_on(dtype: str, device) -> torch.Tensor:
    cb = torch.zeros(16, dtype=torch.float32)
    table = CODEBOOKS[dtype]
    cb[:table.numel()] = table
    return cb.to(device)


def dequant_gemm_plain(x, packed, scales, zeros, codebook, *, bits: int,
                       group_size: int, layout: str, out_dtype) -> torch.Tensor:
    """Plain PyTorch version of K8. x bf16 or f32 [M, K]; packed int32
    [K/P, N] ("tpu_strided") or int8 [K, N] ("int8"); scales (zeros) f32
    [K/G, N]; codebook f32 [16] or None -> [M, N] in ``out_dtype``. Each
    weight is computed in float32 as the kernel computes it,
    (u - (2^(b-1) + z)) * s, codebook[u] * s or (c - z) * s, rounded to
    x's dtype; the product accumulates in float32."""
    w = plain_weight_f32(packed, scales, zeros, codebook, bits=bits,
                         group_size=group_size, layout=layout,
                         K=x.shape[-1], dtype=x.dtype)
    y = torch.matmul(x.to(torch.float32), w)
    return y.to(out_dtype)


def plain_weight_f32(packed, scales, zeros, codebook, *, bits: int,
                     group_size: int, layout: str, K: int,
                     dtype) -> torch.Tensor:
    """The weight [K, N] the plain K8 multiplies: dequantized in float32
    as the kernel dequantizes it, rounded to ``dtype`` (x's), as float32."""
    G = group_size
    N = scales.shape[-1]
    codes = (unpack_codes(packed, bits, G, K, signed=False)
             if layout == "tpu_strided" else packed).reshape(-1, G, N)
    if codebook is not None:
        vals = codebook[codes.to(torch.int64)]
    else:
        off = float(1 << (bits - 1)) if layout == "tpu_strided" else 0.0
        if zeros is not None:
            off = off + zeros[:, None, :]
        vals = codes.to(torch.float32) - off
    w = (vals * scales[:, None, :]).reshape(K, N).to(dtype)
    return w.to(torch.float32)


# K8's plan. The C entry checks every plan it is given against the same
# rules (``plan_ok`` in ``csrc/dequant_matmul.cu``) and refuses the rest.
PATHS = {"tile": 0, "small": 1}
SMALL_M = 256                 # the small path up to this many rows of x
SK_WARPS = 8                  # a small block's warps, each its own stream
SK_CHUNK = 8                  # word rows a chunk, the unit of a warp's range
SK_RS = 16                    # word rows a ring slot
SK_WN = 32                    # a small block's columns
TILE_BN, TILE_KC = 128, 64    # the tile kernel's columns, k-slots a stage
N_SM = 132                    # the H100's SMs (the wrapper passes its own)


class DequantPlan(NamedTuple):
    """How K8 runs one product: ``path`` "small" (mma.sync with the weights
    on the wide side: ``mt`` = 8 or 16 rows of x a block, ``bn`` = 32
    columns, eight warps a block each streaming ``per`` chunks of 8 word
    rows through a ring of ``stages`` slots of 16 word rows) or "tile"
    (``mt`` = 16, 32 or 64 rows by 128 columns a block, ``per`` stages of
    64 k-slots a split); ``splits`` blocks along K (the small path folds
    them in the kernel, the tile path in a second launch); ``grid`` the
    launch's blocks and ``smem`` its dynamic shared memory (the small
    path's)."""
    path: str
    mt: int
    bn: int
    stages: int
    per: int
    splits: int
    grid: tuple
    smem: int


def small_smem(mt: int, bits: int, stages: int) -> int:
    """``small_smem`` of ``csrc/dequant_matmul.cu``: each warp's ring of
    slots (16 word rows of 32 columns, x's ``mt`` rows at their k, a scale
    row and a zero row a chunk), or the warps' fold where that is larger,
    then 16 codebook floats."""
    P = 32 // bits
    slot = 4 * (SK_RS * SK_WN + mt * P * SK_RS // 2
                + 2 * (SK_RS // SK_CHUNK) * SK_WN)
    return max(SK_WARPS * stages * slot, SK_WARPS * mt * SK_WN * 4) + 64


def _fields(bits: int, layout: str) -> int:
    """Fields a stored element holds: 32 / bits for "tpu_strided" words
    (int2, int4), 1 for "int8" codes; 0 for anything K8 does not take."""
    if layout == "int8":
        return 1
    return LANE_BITS // bits if layout == "tpu_strided" and bits in (2, 4) \
        else 0


@functools.lru_cache(maxsize=4096)
def dequant_plan(M: int, N: int, K: int, G: int, bits: int, layout: str,
                 x_f32: bool = False, n_sm: int = N_SM) -> DequantPlan:
    """The path and tiles of one K8 product. Raises ValueError on a shape
    K8 does not take (N % 128, K % G, a "tpu_strided" G that is no multiple
    of 32 / bits).

    * bf16 x, "tpu_strided" int2/int4 words, M <= ``SMALL_M`` and whole
      chunks of 8 word rows a group (G / P % 8 == 0: G % 64 at int4, G %
      128 at int2): ``small_plan``'s;
    * else ``tile_plan``'s (the "int8" layout, other group sizes, f32 x)."""
    P = _fields(bits, layout)
    if not (P and M >= 1 and N >= TILE_BN and N % TILE_BN == 0 and G >= 1
            and K % G == 0 and G % P == 0):
        raise ValueError(f"K8 needs N % 128 == 0, K % G == 0 and G % (32 / "
                         f"bits) == 0 (M={M}, N={N}, K={K}, G={G}, "
                         f"bits={bits}, layout={layout})")
    if (layout == "tpu_strided" and not x_f32 and M <= SMALL_M
            and (G // P) % SK_CHUNK == 0):
        return small_plan(M, N, K, G, bits, n_sm)
    return tile_plan(M, N, K, G, bits, layout, n_sm)


def tile_plan(M: int, N: int, K: int, G: int, bits: int, layout: str,
              n_sm: int) -> DequantPlan:
    """The tile path's plan: 16, 32 or 64 rows (M <= 16, <= 32, above) by
    128 columns a block; K split while the tiles fill fewer than four waves
    of ``n_sm`` SMs, as long as the float32 partials move fewer bytes than
    the weight."""
    P = _fields(bits, layout)
    nchunks = -(-(K // P) // (TILE_KC // P))
    bm = 16 if M <= 16 else 32 if M <= 32 else 64
    tiles = (N // TILE_BN) * -(-M // bm)
    wbytes = K * N * (8 if layout == "int8" else bits) // 8 + (K // G) * N * 4
    s = min(-(-4 * n_sm // tiles), max(1, nchunks // 4))
    s = max(1, min(s, wbytes // (8 * M * N)))
    per = -(-nchunks // s)
    splits = -(-nchunks // per)
    return DequantPlan("tile", bm, TILE_BN, 0, per, splits,
                       (N // TILE_BN, -(-M // bm), splits), 0)


def small_plan(M: int, N: int, K: int, G: int, bits: int,
               n_sm: int) -> DequantPlan:
    """The small path's plan: ``mt`` 8 rows (M <= 8) or 16, 32 columns a
    block, ceil(M / mt) row tiles; K split across blocks (doubling) while
    the blocks fill at most half the SMs (e.g. MoE experts at M = 8), as
    long as each warp keeps two whole slots and the partials stay under
    the weight's bytes; rings of two slots (the most blocks an SM), up to
    four where every block has an SM of its own (measured on the H100 at
    llama2-7b's and DeepSeek-V3's expert widths, ``tools/k8_sweep.py``)."""
    P = LANE_BITS // bits
    mt = 8 if M <= 8 else 16
    blocks = (N // SK_WN) * -(-M // mt)
    nchunks = (K // P) // SK_CHUNK
    s = 1
    while (blocks * s * 2 <= n_sm
           and nchunks >= SK_WARPS * 2 * 2 * s
           and 2 * s * M * N * 4 <= K * N * bits // 8):
        s *= 2
    per = -(-nchunks // (SK_WARPS * s))
    splits = -(-nchunks // (SK_WARPS * per))
    stages = max(st for st in (2, 3, 4) if st == 2 or (
        blocks * splits <= n_sm
        and small_smem(mt, bits, st) <= MAX_DYN_SMEM))
    return DequantPlan("small", mt, SK_WN, stages, per, splits,
                       (N // SK_WN, splits, -(-M // mt)),
                       small_smem(mt, bits, stages))


_WORKSPACE: dict = {}


def _workspace(device, floats: int, tiles: int):
    """K8's scratch on ``device``: float32 partials of at least ``floats``
    and int32 tickets of at least ``tiles``, zero (the small path leaves
    them zero), kept between launches and grown as needed."""
    have = _WORKSPACE.get(device)
    if have is None or have[0].numel() < floats or have[1].numel() < tiles:
        old_f, old_t = (0, 0) if have is None else (have[0].numel(),
                                                     have[1].numel())
        have = (torch.empty(max(floats, old_f), dtype=torch.float32,
                            device=device),
                torch.zeros(max(tiles, old_t, 1024), dtype=torch.int32,
                            device=device))
        _WORKSPACE[device] = have
    return have


def dequant_gemm(x, packed, scales, zeros, codebook, *, bits: int,
                 group_size: int, layout: str, out_dtype) -> torch.Tensor:
    """K8 on the card (``csrc/dequant_matmul.cu``) on ``dequant_plan``'s
    plan; the plain version for CPU tensors. Arguments as in
    ``dequant_gemm_plain``. A bf16 x runs on the tensor cores over bf16
    weights; a float32 x over float32 weights in float32 FMAs, as the TPU
    kernel computes an f32 x (never TF32)."""
    if x.device.type == "cpu":
        return dequant_gemm_plain(x, packed, scales, zeros, codebook,
                                  bits=bits, group_size=group_size,
                                  layout=layout, out_dtype=out_dtype)
    dev = x.device
    M, K = x.shape
    ng, N = scales.shape
    G = group_size
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dequant_gemm takes bf16 or f32 activations, not "
                         f"{x.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dequant_gemm stores bf16 or f32, not {out_dtype}")
    P = _fields(bits, layout)
    # the kernel's contract (dequant_plan's and the C entry's)
    if not (P and 1 <= M and N % 128 == 0 and G > 0 and K % G == 0
            and G % P == 0 and ng * G == K):
        raise ValueError(f"dequant_gemm needs N % 128 == 0, K % G == 0 and "
                         f"a tpu_strided (bits 2 or 4) or int8 weight "
                         f"(M={M}, K={K}, N={N}, G={G}, bits={bits}, "
                         f"layout={layout})")
    wshape, wdtype = (((K // P, N), torch.int32) if layout == "tpu_strided"
                      else ((K, N), torch.int8))
    _build.require(x, "x", x.dtype, dev, (M, K))
    _build.require(packed, "packed", wdtype, dev, wshape)
    _build.require(scales, "scales", torch.float32, dev, (ng, N))
    ptrs = []
    for t, name, shape in ((zeros, "zeros", (ng, N)),
                           (codebook, "codebook", (16,))):
        if t is not None:
            _build.require(t, name, torch.float32, dev, shape)
        ptrs.append(None if t is None else t.data_ptr())
    lib = _build.library()
    plan = dequant_plan(M, N, K, G, bits, layout, x.dtype == torch.float32,
                        _sm_count(dev))
    y = torch.empty((M, N), dtype=out_dtype, device=dev)
    part = tickets = None
    if plan.splits > 1:
        part, tickets = _workspace(dev, plan.splits * M * N,
                                   plan.grid[0] * plan.grid[-1])
        part, tickets = part.data_ptr(), tickets.data_ptr()
    err = lib.nctt_dequant_gemm(
        x.data_ptr(), packed.data_ptr(), scales.data_ptr(), ptrs[0], ptrs[1],
        y.data_ptr(), part, tickets, M, N, K, G, bits,
        int(layout == "int8"), int(x.dtype == torch.float32),
        int(out_dtype == torch.bfloat16), PATHS[plan.path], plan.mt,
        plan.bn, plan.stages, plan.per, plan.splits, plan.smem,
        _build.stream_handle(dev))
    _build.check(err, "nctt_dequant_gemm")
    dequant_gemm.launches += 1
    return y


dequant_gemm.launches = 0


def _tiles_ok(K: int, N: int, G: int) -> bool:
    """Whether the JAX package's kernels take the shape (K8 ``_pick_tiles``,
    K9 ``_vpu_tiles``): their K tile starts at G and doubles while it
    divides K, their N tile is 128, 256 or 512, so they tile exactly when
    K % G == 0 and N % 128 == 0. Only the dispatch reads this; the
    port's kernels tile on their own."""
    return K % G == 0 and N % 128 == 0


def dequant_matmul(x: torch.Tensor, pw: PackedWeight,
                   out_dtype=None) -> torch.Tensor:
    """y[..., N] = x[..., K] @ dequant(pw) through K8 (JAX's
    ``dequant_matmul_pallas``): double quant resolved and ``perm``
    gathered first, x cast to bf16 unless it is bf16 or f32. Shapes that do
    not tile (K % G, N % 128) take ``dequant_dot``, as JAX takes XLA."""
    pw = resolve_double_quant(pw)
    K, N = pw.orig_shape
    if x.shape[-1] != K:
        raise ValueError(f"x has K={x.shape[-1]}, the weight K={K}")
    out_dtype = out_dtype or x.dtype
    G = pw.group_size if pw.group_size > 0 else K
    lead = x.shape[:-1]
    x2, pw = _gather_perm(x.reshape(-1, K), pw)
    if x2.dtype not in (torch.bfloat16, torch.float32):
        x2 = x2.to(torch.bfloat16)
    if not _tiles_ok(K, N, G):
        return dequant_dot(x2, pw, x2.dtype, out_dtype).reshape(*lead, N)
    y = dequant_gemm(x2.contiguous(), pw.packed, pw.scales.to(torch.float32),
                     None if pw.zeros is None else pw.zeros.to(torch.float32),
                     _codebook(pw, x2.device), bits=pw.bits, group_size=G,
                     layout=pw.layout, out_dtype=out_dtype)
    return y.reshape(*lead, N)


def codes_f32(packed, bits: int, group_size: int, K: int) -> torch.Tensor:
    """A "tpu_strided" weight's unsigned fields [K, N] as float32."""
    return unpack_codes(packed, bits, group_size, K,
                        signed=False).to(torch.float32)


def vpu_gemv_plain(x, packed, scales, zeros, *, bits: int, group_size: int,
                   out_dtype) -> torch.Tensor:
    """Plain PyTorch version of K9: x [K] (any float dtype, taken to f32);
    packed int32 "tpu_strided" [K/P, N] (int2/int4); scales (zeros) f32
    [K/G, N] -> [N] in ``out_dtype``, computed in float32 as
    ``y_n = sum_g s_gn (sum_k u_kn x_k - (2^(b-1) + z_gn) sum_k x_k)``."""
    xf = x.reshape(-1).to(torch.float32)
    K = xf.shape[0]
    ng, N = scales.shape
    G = group_size
    u = codes_f32(packed, bits, G, K)
    xg = xf.reshape(ng, 1, G)
    a = torch.bmm(xg, u.reshape(ng, G, N))[:, 0]          # [ng, N]
    b = xg.sum(dim=2)                                      # [ng, 1]
    off = float(1 << (bits - 1))
    if zeros is not None:
        off = off + zeros
    return (scales * (a - off * b)).sum(dim=0).to(out_dtype)


# K9's and K10's plan (their streaming core, csrc/vpu_gemv.cuh). The C
# entries check every plan they are given against the same rules
# (``plan_ok``) and refuse the rest.
GEMV_BN = 128                 # a block's columns: 32 lanes x 4
GEMV_WARPS = 4                # a block's warps (4 or 8)
GEMV_STAGES = 2               # ring slots a warp (2 to 4)
GEMV_MAX_ROWS = 16            # word rows a ring slot, at most
SM_SMEM = 233472              # an H100 SM's shared memory (228 KB) ...
SM_BLOCK_SMEM = 1024          # ... less 1 KB the runtime keeps a block
SM_THREADS = 2048             # an SM's resident threads
_GEMV_MAX_WARPS = 8


class GemvPlan(NamedTuple):
    """How K9 or K10 runs one product: blocks of ``warps`` warps over strips
    of 128 columns (``grid`` = (strips, splits)); each block takes
    ``per`` units of K (K9: groups; K10: tiles of ``ngk`` groups), its warps
    a contiguous share of the block's groups each, streamed through rings
    of ``stages`` slots of ``rows`` word rows; ``smem`` the launch's dynamic
    shared memory; where ``splits`` > 1, ``partials`` float32 partials (K9
    a split's sums, K10 a tile's parts, N each) and ``tickets`` int32
    tickets (a strip's) in the workspace."""
    warps: int
    stages: int
    rows: int
    splits: int
    per: int
    ngk: int
    grid: tuple
    smem: int
    partials: int
    tickets: int


def gemv_smem(k10: bool, G: int, warps: int, stages: int, rows: int,
              groups: int) -> int:
    """``layout().total`` of ``csrc/vpu_gemv.cuh``: the warps' rings (slots
    of ``rows`` word rows of 128 columns, a scale row and a zero row), x
    of the block's ``groups`` groups (K9 float32, K10 int8 codes), their
    sums, the fold (K9 a warp's sums; K10 each group's af and scale), a
    word a warp; each part 16-byte aligned."""
    def up16(b):
        return -(-b // 16) * 16
    xs = warps * stages * (rows + 2) * GEMV_BN * 4
    gsum = xs + up16(groups * G * (1 if k10 else 4))
    fold = gsum + up16(groups * 4)
    red = fold + (2 * groups if k10 else warps) * GEMV_BN * 4
    return red + _GEMV_MAX_WARPS * 4


@functools.lru_cache(maxsize=4096)
def gemv_plan(N: int, K: int, G: int, bits: int, tk: int = 0,
              n_sm: int = N_SM) -> GemvPlan:
    """K9's plan (``tk`` 0) or K10's (``tk`` its K tile, ``_vpu_tiles``'s:
    a block takes whole tiles). Raises ValueError on a shape the kernels do
    not take (bits other than 2 and 4, N % 4, K % G, G % (32 / bits), K %
    tk, tk % G) or whose unit of K does not fit a block's shared memory.

    Strips of 128 columns, ``GEMV_WARPS`` warps a block, rings of
    ``GEMV_STAGES`` slots of the largest divisor of G / P up to
    ``GEMV_MAX_ROWS`` word rows; of the splits of K whose x fits
    (``gemv_smem``), the most whose blocks all fit on the card at once
    (``n_sm`` SMs, by shared memory and threads) with a group for every
    warp; one split where the strips alone exceed that."""
    P = LANE_BITS // bits if bits in (2, 4) else 0
    if not (P and N >= 4 and N % 4 == 0 and G >= P and G % P == 0
            and K >= G and K % G == 0
            and (tk == 0 or (tk % G == 0 and K % tk == 0))):
        raise ValueError(f"K9/K10 need int2/int4 words, N % 4 == 0, K % G "
                         f"== 0, G % (32 / bits) == 0 and whole tiles (N={N},"
                         f" K={K}, G={G}, bits={bits}, tk={tk})")
    k10 = tk > 0
    ngk = tk // G if k10 else 1
    nunits = K // G // ngk
    wpg = G // P
    rows = max(r for r in range(1, GEMV_MAX_ROWS + 1) if wpg % r == 0)
    warps, stages = GEMV_WARPS, GEMV_STAGES
    strips = -(-N // GEMV_BN)
    pick, seen = None, set()
    for s in range(1, nunits + 1):
        per = -(-nunits // s)
        splits = -(-nunits // per)
        smem = gemv_smem(k10, G, warps, stages, rows, per * ngk)
        if splits in seen or smem > MAX_DYN_SMEM:
            continue
        seen.add(splits)
        resident = n_sm * min(SM_SMEM // (smem + SM_BLOCK_SMEM),
                              SM_THREADS // (32 * warps))
        if pick is None or (strips * splits <= resident
                            and per * ngk >= warps):
            pick = (splits, per, smem)
    if pick is None:
        raise ValueError(f"K9/K10: x of one unit of K ({ngk} groups of {G})"
                         f" does not fit a block's shared memory")
    splits, per, smem = pick
    partials = (0 if splits == 1 else
                N * (nunits if k10 else splits))
    return GemvPlan(warps, stages, rows, splits, per, ngk,
                    (strips, splits), smem, partials,
                    strips if splits > 1 else 0)


# device -> (sizes held, (partials, tickets), {plan: argument block}): K9's
# and K10's workspace, float32 partials and int32 tickets (kept zeroed:
# the folding block resets its strip's), replaced by larger ones (and the
# argument blocks dropped) when a plan needs more. Calls on one stream run
# in order, so one call's partials are free when the next starts.
_GEMV_SCRATCH: dict = {}


def gemv_workspace(plan: GemvPlan, device) -> int:
    """The address of the argument block of ``nctt_vpu_gemv`` and
    ``nctt_vpu_int8act`` for ``plan`` on ``device``: nine 64-bit words, the
    workspace's addresses (partials, tickets) and the plan (warps, stages,
    rows, splits, per, ngk, smem), in the order of ``PlanWord`` in
    csrc/vpu_gemv.cuh. The workspace is kept per device between calls; the
    blocks are cached per plan."""
    have = _GEMV_SCRATCH.get(device)
    if have is not None:
        block = have[2].get(plan)
        if block is not None:
            return block[1]
    need = (plan.partials, max(plan.tickets, 1024))
    if have is None or any(h < n for h, n in zip(have[0], need)):
        n = need if have is None else tuple(map(max, have[0], need))
        bufs = (torch.empty(max(n[0], 1), dtype=torch.float32, device=device),
                torch.zeros(n[1], dtype=torch.int32, device=device))
        have = (n, bufs, {})
        _GEMV_SCRATCH[device] = have
    words = (ctypes.c_int64 * 9)(
        *(b.data_ptr() for b in have[1]), plan.warps, plan.stages,
        plan.rows, plan.splits, plan.per, plan.ngk, plan.smem)
    have[2][plan] = (words, ctypes.addressof(words))
    return have[2][plan][1]


def vpu_gemv(x, packed, scales, zeros, *, bits: int, group_size: int,
             out_dtype) -> torch.Tensor:
    """K9 on the card (``csrc/vpu_gemv.cu``, one launch on ``gemv_plan``'s
    plan); the plain version for CPU tensors. Arguments as in
    ``vpu_gemv_plain``; on the card x is bf16 or f32."""
    if x.device.type == "cpu":
        return vpu_gemv_plain(x, packed, scales, zeros, bits=bits,
                              group_size=group_size, out_dtype=out_dtype)
    dev = x.device
    K = x.numel()
    ng, N = scales.shape
    G = group_size
    P = LANE_BITS // bits if bits in (2, 4) else 0
    if not (P and G > 0 and G % P == 0 and ng * G == K and N % 4 == 0):
        raise ValueError(f"vpu_gemv needs int2/int4 tpu_strided words, "
                         f"K % G == 0, G % P == 0 and N % 4 == 0 "
                         f"(K={K}, N={N}, G={G}, bits={bits})")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"vpu_gemv takes bf16 or f32 x, not {x.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"vpu_gemv stores bf16 or f32, not {out_dtype}")
    x = x.reshape(K)
    _build.require(x, "x", x.dtype, dev, (K,))
    _build.require(packed, "packed", torch.int32, dev, (K // P, N))
    _build.require(scales, "scales", torch.float32, dev, (ng, N))
    if zeros is not None:
        _build.require(zeros, "zeros", torch.float32, dev, (ng, N))
    lib = _build.library()
    plan = gemv_plan(N, K, G, bits, 0, _sm_count(dev))
    y = torch.empty(N, dtype=out_dtype, device=dev)
    err = lib.nctt_vpu_gemv(
        x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
        None if zeros is None else zeros.data_ptr(), y.data_ptr(),
        gemv_workspace(plan, dev), N, K, G, bits,
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        _build.stream_handle(dev))
    _build.check(err, "nctt_vpu_gemv")
    vpu_gemv.launches += 1
    return y


vpu_gemv.launches = 0


def vpu_matvec(x: torch.Tensor, pw: PackedWeight, out_dtype=None):
    """y[..., N] = x[..., K] @ dequant(pw) for a single row of x through K9.
    Returns None where the JAX package's ``vpu_matvec`` declines: M > 1,
    codebook dtypes, unpacked layouts, non-tiling shapes."""
    K, N = pw.orig_shape
    out_dtype = out_dtype or x.dtype
    G = pw.group_size if pw.group_size > 0 else K
    if (_rows(x) != 1 or pw.layout != "tpu_strided"
            or pw.dtype in FLOAT_CODE_DTYPES or pw.bits not in (2, 4)
            or G % (LANE_BITS // pw.bits) or not _tiles_ok(K, N, G)):
        return None
    pw = resolve_double_quant(pw)
    lead = x.shape[:-1]
    x2, pw = _gather_perm(x.reshape(1, K), pw)
    if x2.dtype not in (torch.bfloat16, torch.float32):
        x2 = x2.to(torch.float32)
    y = vpu_gemv(x2.contiguous(), pw.packed, pw.scales.to(torch.float32),
                 None if pw.zeros is None else pw.zeros.to(torch.float32),
                 bits=pw.bits, group_size=G, out_dtype=out_dtype)
    return y.reshape(*lead, N)


def _vpu_tiles(K: int, N: int, G: int):
    """(tk, tn) of the JAX package's VPU matvecs (``_vpu_tiles``), or None
    where the shape does not tile. K10's tk is numerics, not only a
    decision: the kernel folds its float sums tile by tile."""
    tk = G
    while tk * 2 <= min(K, 1024) and K % (tk * 2) == 0:
        tk *= 2
    tn = 512 if N % 512 == 0 else (256 if N % 256 == 0 else
                                   (128 if N % 128 == 0 else None))
    if tn is None or K % tk or tk % G:
        return None
    return tk, tn


def act_quant_per_tensor(x: torch.Tensor):
    """K10's activation quantization as the jitted TPU program computes it:
    xs = max(max|x|, 1e-6) * f32(1/127), xq = clip(round(x / xs), +-127)
    with a true division. Returns float32 (codes [K], xs [1])."""
    xf = x.reshape(-1).to(torch.float32)
    amax = torch.clamp_min(xf.abs().amax(), 1e-6)
    xs = (amax * (1.0 / 127.0)).reshape(1)
    return torch.clamp(torch.round(xf / xs), -127, 127), xs


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32, as a fused multiply-add (float32
    a, b, c). The product of two float32 values is exact in float64; the
    float64 sum can round, and then (only) where it lands exactly on a
    float32 midpoint its error decides the side."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)              # s + e == p + c exactly
    r = s.to(torch.float32)
    up = torch.nextafter(r, torch.full_like(r, math.inf))
    dn = torch.nextafter(r, torch.full_like(r, -math.inf))
    other = torch.where(s > r.to(torch.float64), up, dn)
    tie = (e != 0) & (s == (r.to(torch.float64) + other.to(torch.float64)) / 2)
    lo, hi = torch.minimum(r, other), torch.maximum(r, other)
    return torch.where(tie, torch.where(e > 0, hi, lo), r)


def vpu_int8act_plain(x, packed, scales, zeros, *, bits: int, group_size: int,
                      tk: int, out_dtype) -> torch.Tensor:
    """Plain PyTorch version of K10: x [K] (bf16 or f32); packed int32
    "tpu_strided" [K/P, N] (int2/int4); scales (zeros) f32 [K/G, N]; tk
    the K tile -> [N] in ``out_dtype``. Per group the integer sums
    a = sum u·xq over the offset-binary fields u and b = sum xq (exact in
    float64), af = f32(a) - (2^(b-1) + z) · f32(b); per tile
    part = fma(s, af, part) over the tile's groups in order, then
    acc = fma(part, xs, acc) in tile order: the TPU kernel's order, with
    the multiply-adds fused as XLA's CPU program of the reference fuses
    them, so the card's kernel and the JAX function give these bits."""
    xq, xs = act_quant_per_tensor(x)
    K = xq.shape[0]
    ng, N = scales.shape
    G = group_size
    u = unpack_codes(packed, bits, G, K, signed=False).to(torch.float64)
    xg = xq.to(torch.float64).reshape(ng, 1, G)
    a = torch.bmm(xg, u.reshape(ng, G, N))[:, 0].to(torch.float32)
    b = xg.sum(dim=2).to(torch.float32)                    # [ng, 1]
    off = float(1 << (bits - 1))
    if zeros is not None:
        off = off + zeros
    nk, ngk = K // tk, tk // G
    af = (a - off * b).expand(ng, N).reshape(nk, ngk, N)
    sc = scales.reshape(nk, ngk, N)
    # every tile at once, its groups in order; then the tiles in order
    part = torch.zeros((nk, N), dtype=torch.float32, device=af.device)
    for g in range(ngk):
        part = fma_f32(sc[:, g], af[:, g], part)
    acc = torch.zeros(N, dtype=torch.float32, device=af.device)
    for t in range(nk):
        acc = fma_f32(part[t], xs.expand(N), acc)
    return acc.to(out_dtype)


def vpu_int8act(x, packed, scales, zeros, *, bits: int, group_size: int,
                tk: int, out_dtype) -> torch.Tensor:
    """K10 on the card (``csrc/vpu_int8act.cu``, one launch on
    ``gemv_plan``'s plan for ``tk``); the plain version for CPU tensors.
    Arguments as in ``vpu_int8act_plain``; on the card x is bf16 or f32."""
    if x.device.type == "cpu":
        return vpu_int8act_plain(x, packed, scales, zeros, bits=bits,
                                 group_size=group_size, tk=tk,
                                 out_dtype=out_dtype)
    dev = x.device
    K = x.numel()
    ng, N = scales.shape
    G = group_size
    P = LANE_BITS // bits if bits in (2, 4) else 0
    if not (P and G > 0 and G % P == 0 and ng * G == K and tk % G == 0
            and K % tk == 0 and N % 4 == 0):
        raise ValueError(f"vpu_int8act needs int2/int4 tpu_strided words, "
                         f"K % tk == 0, tk % G == 0, G % P == 0 and "
                         f"N % 4 == 0 (K={K}, N={N}, G={G}, tk={tk}, "
                         f"bits={bits})")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"vpu_int8act takes bf16 or f32 x, not {x.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"vpu_int8act stores bf16 or f32, not {out_dtype}")
    x = x.reshape(K)
    _build.require(x, "x", x.dtype, dev, (K,))
    _build.require(packed, "packed", torch.int32, dev, (K // P, N))
    _build.require(scales, "scales", torch.float32, dev, (ng, N))
    if zeros is not None:
        _build.require(zeros, "zeros", torch.float32, dev, (ng, N))
    lib = _build.library()
    plan = gemv_plan(N, K, G, bits, tk, _sm_count(dev))
    y = torch.empty(N, dtype=out_dtype, device=dev)
    err = lib.nctt_vpu_int8act(
        x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
        None if zeros is None else zeros.data_ptr(), y.data_ptr(),
        gemv_workspace(plan, dev), N, K, G, bits, tk,
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        _build.stream_handle(dev))
    _build.check(err, "nctt_vpu_int8act")
    vpu_int8act.launches += 1
    return y


vpu_int8act.launches = 0


def vpu_matvec_int8act(x: torch.Tensor, pw: PackedWeight, out_dtype=None):
    """W4A8 single-row decode through K10, as ``neural_compressor_tpu``'s
    ``vpu_matvec_int8act``: x quantized to int8 per tensor, the
    multiply-accumulate in int32. Returns None where JAX's declines: M != 1,
    a layout other than "tpu_strided", codebook dtypes, bits not in (2, 4),
    G % (32 / bits), or a shape ``_vpu_tiles`` does not tile. Double
    quantization is resolved and ``perm`` gathered first."""
    K, N = pw.orig_shape
    out_dtype = out_dtype or x.dtype
    G = pw.group_size if pw.group_size > 0 else K
    if (_rows(x) != 1 or pw.layout != "tpu_strided"
            or pw.dtype in FLOAT_CODE_DTYPES or pw.bits not in (2, 4)
            or G % (LANE_BITS // pw.bits)):
        return None
    tiles = _vpu_tiles(K, N, G)
    if tiles is None:
        return None
    pw = resolve_double_quant(pw)
    lead = x.shape[:-1]
    x2, pw = _gather_perm(x.reshape(1, K), pw)
    if x2.dtype not in (torch.bfloat16, torch.float32):
        x2 = x2.to(torch.float32)
    y = vpu_int8act(x2.contiguous(), pw.packed, pw.scales.to(torch.float32),
                    None if pw.zeros is None else pw.zeros.to(torch.float32),
                    bits=pw.bits, group_size=G, tk=tiles[0],
                    out_dtype=out_dtype)
    return y.reshape(*lead, N)


def woq_matmul(x: torch.Tensor, pw: PackedWeight, impl: str | None = None,
               out_dtype=None) -> torch.Tensor:
    """Quantized-weight matmul dispatcher (see the module docstring)."""
    impl = impl or _DEFAULT_IMPL
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    out_dtype = out_dtype or x.dtype
    on_card = _on_card(x)
    if impl == "auto":
        M = _rows(x)
        if M == 1 and on_card:
            impl = "vpu"
        elif M <= DECODE_M_THRESHOLD and on_card:
            impl = "pallas"
        else:
            impl = "xla"
    if impl == "vpu":
        y = vpu_matvec(x, pw, out_dtype=out_dtype)
        if y is not None:
            return y
        impl = "pallas" if on_card else "xla"
    if impl == "pallas":
        return dequant_matmul(x, pw, out_dtype=out_dtype)
    # serving runs bf16; f32 activations stay f32 (accuracy evals)
    cdt = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
    return dequant_dot(x, pw, cdt, out_dtype)
