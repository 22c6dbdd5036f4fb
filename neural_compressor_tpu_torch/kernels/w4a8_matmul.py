"""W4A8 GEMM: int8 per-token activations x signed int4 weights.

    y[m, n] = xs[m] · Σ_g ws[g, n] · Σ_{k∈g} xq[m, k] · wq[k, n]

Int32 partials per group, folded into float32 with the group scale after
every group, then multiplied by the activation scale.

Ports two TPU kernels that compute this same function on two TPU layouts:
``neural_compressor_tpu/kernels/w4a8_matmul.py`` ``_w4a8_impl`` (K1,
"tpu_strided") and ``kernels/fused_matvec.py`` ``_u4k_impl`` (K3,
"u4_kpack"). The CUDA kernel (``csrc/w4a8_gemm.cu``) reads two layouts
where they lie: "hopper_nk" (``w4a8_gemm``, the port's serving layout)
and "tpu_strided" (``w4a8_gemm_strided``, the words JAX's K1 reads, which
a ``W4A8Linear`` keeps under a raised ``M_INT8_THRESHOLD``, after hybrid
GPTQ or ``to_w4a8_serving(s4=False)``). K2 (``kernels/s4_matmul.py``)
shares the kernel's core. The per-token activation quantization stays
outside the kernel, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..ops.packing import (HOPPER_LAYOUT, PackedWeight, resolve_double_quant,
                           unpack_codes)
from ..ops.qtensor import quantize_act_per_token
from . import _build


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def select_w4a8_tiles(M: int, K: int, G: int) -> tuple[int, int]:
    """(tm, tk) exactly as ``neural_compressor_tpu``'s ``select_w4a8_tiles``
    chooses them. The port's kernel has its own tiling; this decides only
    which shapes the integer path takes (see ``w4a8_tiles_ok``)."""
    tm = min(_round_up(M, 32), 1024)
    if M > 1024:
        ntiles = -(-M // 1024)
        tm = _round_up(-(-M // ntiles), 32)
    ng = K // G

    def _largest_tk(cap):
        t = G
        for m in range(1, ng + 1):
            if ng % m == 0 and m * G <= cap:
                t = m * G
        return t

    if tm <= 32:
        tk = _largest_tk(6144)
    else:
        tk = G
        while tk * 2 <= min(K, 4096) and K % (tk * 2) == 0:
            tk *= 2
        if tk <= 512:
            tm, tk = min(tm, 512), _largest_tk(6144)
    return tm, tk


def w4a8_usable(pw: PackedWeight) -> bool:
    """Weights the integer GEMM takes: "hopper_nk" (symmetric int4 only,
    ``ops.packing.hopper_eligible``) or symmetric int4 integer
    "tpu_strided" words, as ``neural_compressor_tpu``'s ``w4a8_matmul``
    takes them (``w4a8_matmul.py:173-174``)."""
    return pw.layout == HOPPER_LAYOUT or (
        pw.layout == "tpu_strided" and pw.bits == 4 and pw.zeros is None
        and pw.dtype == "int")


def w4a8_tiles_ok(pw: PackedWeight, M: int) -> bool:
    """True where ``neural_compressor_tpu``'s ``w4a8_matmul`` runs its
    integer kernel; elsewhere it takes the bf16 dequant-and-dot
    (``w4a8_matmul.py:178-182``), and so does the port."""
    K, N = pw.orig_shape
    G = pw.group_size if pw.group_size > 0 else K
    _tm, tk = select_w4a8_tiles(M, K, G)
    return w4a8_usable(pw) and K % tk == 0 and N % 256 == 0


def grouped_gemm_plain(xq: torch.Tensor, codes: torch.Tensor,
                       scales: torch.Tensor,
                       x_scale: torch.Tensor) -> torch.Tensor:
    """The arithmetic of K1 and K2 in plain PyTorch: xq int8 [M, K], int8
    codes [K, N], scales f32 [K/G, N], x_scale f32 [M] -> f32 [M, N]. Each
    group's partial sum is an integer of magnitude at most 128·8·G, below
    2^24 for G <= 16384, so float32 holds it exactly; the partials fold
    into float32 in group order, then times the activation scale."""
    M, K = xq.shape
    ng, N = scales.shape
    G = K // ng
    c = codes.to(torch.float32).reshape(ng, G, N)
    xg = xq.to(torch.float32).reshape(M, ng, G).transpose(0, 1)
    d = torch.bmm(xg, c)                                      # [ng, M, N]
    acc = torch.zeros((M, N), dtype=torch.float32, device=xq.device)
    for g in range(ng):  # group order, as the TPU kernel sums
        acc = acc + d[g] * scales[g]
    return acc * x_scale[:, None]


def w4a8_gemm_plain(xq: torch.Tensor, w: torch.Tensor, scales: torch.Tensor,
                    x_scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: xq int8 [M, K], w uint8
    "hopper_nk" [N, K/2], scales f32 [K/G, N], x_scale f32 [M] -> f32
    [M, N] (``grouped_gemm_plain``)."""
    from ..ops.packing import unpack_codes_hopper

    return grouped_gemm_plain(xq, unpack_codes_hopper(w), scales, x_scale)


def w4a8_gemm_strided_plain(xq: torch.Tensor, w: torch.Tensor,
                            scales: torch.Tensor,
                            x_scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version over "tpu_strided" int4 words: w int32
    [K/8, N]; the rest as ``w4a8_gemm_plain``."""
    K = xq.shape[1]
    G = K // scales.shape[0]
    return grouped_gemm_plain(xq, unpack_codes(w, 4, G, K, signed=True),
                              scales, x_scale)


def w4a8_gemm(xq: torch.Tensor, w: torch.Tensor, scales: torch.Tensor,
              x_scale: torch.Tensor) -> torch.Tensor:
    """The W4A8 GEMM on the card (``csrc/w4a8_gemm.cu``); the plain version
    for CPU tensors. Shapes as in ``w4a8_gemm_plain``. Any group size: the
    tiled tensor-core kernel where K and G are multiples of 32 and N of 64,
    a general path (one output a thread on the CUDA cores) elsewhere, e.g.
    at the "tpu_strided" group sizes 8, 16 and 24 that JAX's K1 runs."""
    if xq.device.type == "cpu":
        return w4a8_gemm_plain(xq, w, scales, x_scale)
    return _launch(w4a8_gemm, "nctt_w4a8_gemm", xq, w, scales, x_scale)


w4a8_gemm.launches = 0


def w4a8_gemm_strided(xq: torch.Tensor, w: torch.Tensor,
                      scales: torch.Tensor,
                      x_scale: torch.Tensor) -> torch.Tensor:
    """The W4A8 GEMM over "tpu_strided" int4 words on the card
    (``csrc/w4a8_gemm.cu``, ``nctt_w4a8_gemm_strided``); the plain version
    for CPU tensors. w int32 [K/8, N]; the rest as ``w4a8_gemm``. The tiled
    kernel where G is a multiple of 32, the general path elsewhere (G 8,
    16, 24, ...)."""
    if xq.device.type == "cpu":
        return w4a8_gemm_strided_plain(xq, w, scales, x_scale)
    return _launch(w4a8_gemm_strided, "nctt_w4a8_gemm_strided", xq, w,
                   scales, x_scale)


w4a8_gemm_strided.launches = 0


def _launch(wrapper, entry: str, xq, w, scales, x_scale) -> torch.Tensor:
    """Check the operands of one of the grouped W4A8 GEMM entries (K1's
    two, K2's), launch it and count the launch on ``wrapper``."""
    M, K = xq.shape
    ng, N = scales.shape
    G = K // ng if ng else 0
    if not (G >= 1 and ng * G == K and K % 2 == 0):
        raise ValueError(f"w4a8_gemm needs K a multiple of the group size "
                         f"and even (M={M}, K={K}, N={N}, G={G})")
    if entry == "nctt_w4a8_gemm_strided" and G % 8:
        raise ValueError(f"tpu_strided int4 words need G % 8 == 0 (G={G})")
    if entry == "nctt_s4_gemm" and N % 8:
        raise ValueError(f"s4_rowpack words need N % 8 == 0 (N={N})")
    wdtype, wshape = {"nctt_w4a8_gemm": (torch.uint8, (N, K // 2)),
                      "nctt_w4a8_gemm_strided": (torch.int32, (K // 8, N)),
                      "nctt_s4_gemm": (torch.int32, (K, N // 8))}[entry]
    dev = xq.device
    _build.require(xq, "xq", torch.int8, dev, (M, K))
    _build.require(w, "w", wdtype, dev, wshape)
    _build.require(scales, "scales", torch.float32, dev, (ng, N))
    _build.require(x_scale, "x_scale", torch.float32, dev, (M,))
    y = torch.empty((M, N), dtype=torch.float32, device=dev)
    err = getattr(_build.library(), entry)(
        xq.data_ptr(), w.data_ptr(), scales.data_ptr(), x_scale.data_ptr(),
        y.data_ptr(), M, N, K, G, _build.stream_handle(dev))
    _build.check(err, entry)
    wrapper.launches += 1
    return y


def _gather_perm(x2: torch.Tensor, pw: PackedWeight):
    """Rows stored permuted: contract x in the stored order."""
    if pw.perm is None:
        return x2, pw
    return (x2.index_select(-1, pw.perm.to(x2.device, torch.int64)),
            pw._replace(perm=None))


def w4a8_matmul(x: torch.Tensor, pw: PackedWeight, out_dtype=None) -> torch.Tensor:
    """y = x @ dequant(Wq) with int8 per-token activation quantization and
    the integer GEMM, on "hopper_nk" or symmetric int4 "tpu_strided"
    words, as ``neural_compressor_tpu``'s ``w4a8_matmul``: double-quantized
    scales resolved and ``perm`` gathered first; outside its envelope
    (``w4a8_tiles_ok``) the bf16 dequant-and-dot."""
    from .dequant_matmul import dequant_dot

    out_dtype = out_dtype or x.dtype
    pw = resolve_double_quant(pw)
    K, N = pw.orig_shape
    lead = x.shape[:-1]
    x2, pw = _gather_perm(x.reshape(-1, K), pw)
    if not w4a8_tiles_ok(pw, x2.shape[0]):
        return dequant_dot(x2, pw, torch.bfloat16, out_dtype).reshape(*lead, N)
    xq, x_scale = quantize_act_per_token(x2, bits=8)
    gemm = w4a8_gemm if pw.layout == HOPPER_LAYOUT else w4a8_gemm_strided
    y = gemm(xq, pw.packed, pw.scales.to(torch.float32), x_scale.reshape(-1))
    return y.to(out_dtype).reshape(*lead, N)
