"""W4A8 GEMM: int8 per-token activations x signed int4 weights.

    y[m, n] = xs[m] · Σ_g ws[g, n] · Σ_{k∈g} xq[m, k] · wq[k, n]

Int32 partials per group, folded into float32 with the group scale after
every group, then multiplied by the activation scale.

Ports two TPU kernels that compute this same function on two TPU layouts:
``neural_compressor_tpu/kernels/w4a8_matmul.py`` ``_w4a8_impl`` (K1,
"tpu_strided") and ``kernels/fused_matvec.py`` ``_u4k_impl`` (K3,
"u4_kpack"). Here the weights are "hopper_nk" (``ops/packing.py``); the
CUDA kernel is ``csrc/w4a8_gemm.cu``. The per-token activation
quantization stays outside the kernel, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..ops.packing import HOPPER_LAYOUT, PackedWeight
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


def w4a8_tiles_ok(pw: PackedWeight, M: int) -> bool:
    """True where ``neural_compressor_tpu``'s ``w4a8_matmul`` runs its
    integer kernel; elsewhere it takes the bf16 dequant-and-dot
    (``w4a8_matmul.py:178-182``), and so does the port."""
    K, N = pw.orig_shape
    # hopper_nk holds only symmetric int4 codes (ops.packing.hopper_eligible)
    usable = pw.layout == HOPPER_LAYOUT
    G = pw.group_size if pw.group_size > 0 else K
    _tm, tk = select_w4a8_tiles(M, K, G)
    return usable and K % tk == 0 and N % 256 == 0


def w4a8_gemm_plain(xq: torch.Tensor, w: torch.Tensor, scales: torch.Tensor,
                    x_scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: xq int8 [M, K], w uint8
    "hopper_nk" [N, K/2], scales f32 [K/G, N], x_scale f32 [M] -> f32 [M, N].

    Each group's partial sum is an integer of magnitude at most
    128·8·G, below 2^24 for G <= 16384, so float32 holds it exactly."""
    from ..ops.packing import unpack_codes_hopper

    M, K = xq.shape
    ng, N = scales.shape
    G = K // ng
    codes = unpack_codes_hopper(w).to(torch.float32).reshape(ng, G, N)
    xg = xq.to(torch.float32).reshape(M, ng, G).transpose(0, 1)
    d = torch.bmm(xg, codes)                                  # [ng, M, N]
    acc = torch.zeros((M, N), dtype=torch.float32, device=xq.device)
    for g in range(ng):  # group order, as the TPU kernel sums
        acc = acc + d[g] * scales[g]
    return acc * x_scale[:, None]


def w4a8_gemm(xq: torch.Tensor, w: torch.Tensor, scales: torch.Tensor,
              x_scale: torch.Tensor) -> torch.Tensor:
    """The W4A8 GEMM on the card (``csrc/w4a8_gemm.cu``); the plain version
    for CPU tensors. Shapes as in ``w4a8_gemm_plain``. Any group size: the
    tiled tensor-core kernel where K and G are multiples of 32 and N of 64,
    a general path (``__dp4a`` on the CUDA cores) elsewhere, e.g. at the
    "tpu_strided" group sizes 8, 16 and 24 that JAX's K1 runs."""
    if xq.device.type == "cpu":
        return w4a8_gemm_plain(xq, w, scales, x_scale)
    M, K = xq.shape
    ng, N = scales.shape
    G = K // ng if ng else 0
    if not (G >= 1 and ng * G == K and K % 2 == 0):
        raise ValueError(f"w4a8_gemm needs K a multiple of the group size "
                         f"and even (M={M}, K={K}, N={N}, G={G})")
    dev = xq.device
    _build.require(xq, "xq", torch.int8, dev, (M, K))
    _build.require(w, "w", torch.uint8, dev, (N, K // 2))
    _build.require(scales, "scales", torch.float32, dev, (ng, N))
    _build.require(x_scale, "x_scale", torch.float32, dev, (M,))
    y = torch.empty((M, N), dtype=torch.float32, device=dev)
    err = _build.library().nctt_w4a8_gemm(
        xq.data_ptr(), w.data_ptr(), scales.data_ptr(), x_scale.data_ptr(),
        y.data_ptr(), M, N, K, G, _build.stream_handle(dev))
    _build.check(err, "nctt_w4a8_gemm")
    w4a8_gemm.launches += 1
    return y


w4a8_gemm.launches = 0


def w4a8_matmul(x: torch.Tensor, pw: PackedWeight, out_dtype=None) -> torch.Tensor:
    """y = x @ dequant(Wq) with int8 per-token activation quantization and
    the integer GEMM, on a "hopper_nk" weight."""
    if pw.layout != HOPPER_LAYOUT:
        raise ValueError(f"w4a8_matmul takes {HOPPER_LAYOUT} weights, "
                         f"got {pw.layout}")
    out_dtype = out_dtype or x.dtype
    K, N = pw.orig_shape
    lead = x.shape[:-1]
    xq, x_scale = quantize_act_per_token(x.reshape(-1, K), bits=8)
    y = w4a8_gemm(xq, pw.packed, pw.scales, x_scale.reshape(-1))
    return y.to(out_dtype).reshape(*lead, N)
