"""Weight-only (W4A16) products ``y = x @ dequant(Wq)`` and their dispatch.

The counterpart of ``neural_compressor_tpu/kernels/dequant_matmul.py``:
  * ``dequant_gemm`` (K8; the TPU kernel ``_dequant_matmul_impl``): the
    weight is dequantized tile by tile, rounded to x's dtype and multiplied
    with float32 accumulation; for 1 <= M <= 256;
  * ``vpu_gemv`` (K9; the TPU kernel ``_vpu_matvec_impl``): the M == 1
    product in float32 without rounding the weight, factored per group;
  * ``woq_matmul``: the dispatcher. ``"auto"`` on the card takes K9 at
    M == 1 (K8 where K9 declines), K8 up to M = 256 and dequantize-then-
    ``torch.matmul`` above; off the card it takes dequantize-then-matmul,
    as the JAX package does off the TPU. ``impl="vpu"`` / ``"pallas"``
    force K9 / K8 (their plain versions for CPU tensors), as JAX's ``impl=``
    runs its Pallas kernels in interpret mode.

The CUDA kernels (``csrc/dequant_matmul.cu``) read the "tpu_strided"
words and "int8" codes as the JAX package stores them. Dequantize-then-
matmul is no kernel: ``dequant_dot`` counts its calls in ``.calls``.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.packing import (LANE_BITS, PackedWeight, dequantize_packed,
                           resolve_double_quant, unpack_codes)
from ..ops.qtensor import CODEBOOKS, FLOAT_CODE_DTYPES
from . import _build

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


def _plan(plan_fn, name: str, *args) -> tuple[int, int]:
    """A kernel's split of K, (splits, chunks or groups per split), from
    its C plan entry: the tiling lives in ``csrc/dequant_matmul.cu``."""
    splits, per = ctypes.c_int(), ctypes.c_int()
    err = plan_fn(*args, ctypes.byref(splits), ctypes.byref(per))
    if err:
        raise ValueError(f"{name} refused {args}")
    return splits.value, per.value


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
    w = dequantize_packed(pw, out_dtype=cdt)
    y = torch.matmul(x2.to(cdt).to(torch.float32), w.to(torch.float32))
    return y.to(out_dtype).reshape(*lead, N)


dequant_dot.calls = 0


def _codebook(pw: PackedWeight, device):
    if pw.dtype in FLOAT_CODE_DTYPES:
        cb = torch.zeros(16, dtype=torch.float32)
        table = CODEBOOKS[pw.dtype]
        cb[:table.numel()] = table
        return cb.to(device)
    return None


def dequant_gemm_plain(x, packed, scales, zeros, codebook, *, bits: int,
                       group_size: int, layout: str, out_dtype) -> torch.Tensor:
    """Plain PyTorch version of K8. x bf16 or f32 [M, K]; packed int32
    [K/P, N] ("tpu_strided") or int8 [K, N] ("int8"); scales (zeros) f32
    [K/G, N]; codebook f32 [16] or None -> [M, N] in ``out_dtype``. Each
    weight is computed in float32 as the kernel computes it,
    (u - (2^(b-1) + z)) * s, codebook[u] * s or (c - z) * s, rounded to
    x's dtype; the product accumulates in float32."""
    K = x.shape[-1]
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
    w = (vals * scales[:, None, :]).reshape(K, N).to(x.dtype)
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return y.to(out_dtype)


def dequant_gemm(x, packed, scales, zeros, codebook, *, bits: int,
                 group_size: int, layout: str, out_dtype) -> torch.Tensor:
    """K8 on the card (``csrc/dequant_matmul.cu``); the plain version for
    CPU tensors. Arguments as in ``dequant_gemm_plain``; on the card x
    must be bf16 (the tensor cores run bf16; never TF32)."""
    if x.device.type == "cpu":
        return dequant_gemm_plain(x, packed, scales, zeros, codebook,
                                  bits=bits, group_size=group_size,
                                  layout=layout, out_dtype=out_dtype)
    dev = x.device
    M, K = x.shape
    ng, N = scales.shape
    G = group_size
    if x.dtype != torch.bfloat16:
        raise ValueError(f"dequant_gemm on the card takes bf16 activations, "
                         f"not {x.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dequant_gemm stores bf16 or f32, not {out_dtype}")
    if layout == "tpu_strided":
        ok = bits in (2, 4) and G % (LANE_BITS // bits) == 0
        wshape, wdtype = (K * bits // LANE_BITS, N), torch.int32
    else:
        ok = layout == "int8"
        wshape, wdtype = (K, N), torch.int8
    # the kernel's contract (its C entry's comment); the tiling behind it
    # lives in the C plan entry
    if not (ok and 1 <= M and N % 128 == 0 and G > 0 and K % G == 0
            and ng * G == K):
        raise ValueError(f"dequant_gemm needs N % 128 == 0, K % G == 0 and "
                         f"a tpu_strided (bits 2 or 4) or int8 weight "
                         f"(M={M}, K={K}, N={N}, G={G}, bits={bits}, "
                         f"layout={layout})")
    _build.require(x, "x", torch.bfloat16, dev, (M, K))
    _build.require(packed, "packed", wdtype, dev, wshape)
    _build.require(scales, "scales", torch.float32, dev, (ng, N))
    ptrs = []
    for t, name, shape in ((zeros, "zeros", (ng, N)),
                           (codebook, "codebook", (16,))):
        if t is not None:
            _build.require(t, name, torch.float32, dev, shape)
        ptrs.append(None if t is None else t.data_ptr())
    lib = _build.library()
    wbytes = packed.numel() * packed.element_size() + scales.numel() * 4
    splits, per = _plan(lib.nctt_dequant_gemm_plan, "nctt_dequant_gemm_plan",
                        M, N, K, G, bits, int(layout == "int8"),
                        _sm_count(dev), wbytes)
    y = torch.empty((M, N), dtype=out_dtype, device=dev)
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    err = lib.nctt_dequant_gemm(
        x.data_ptr(), packed.data_ptr(), scales.data_ptr(), ptrs[0], ptrs[1],
        y.data_ptr(), None if part is None else part.data_ptr(), M, N, K, G,
        bits, int(layout == "int8"), int(out_dtype == torch.bfloat16),
        splits, per, _build.stream_handle(dev))
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
    u = unpack_codes(packed, bits, G, K, signed=False).to(torch.float32)
    xg = xf.reshape(ng, 1, G)
    a = torch.bmm(xg, u.reshape(ng, G, N))[:, 0]          # [ng, N]
    b = xg.sum(dim=2)                                      # [ng, 1]
    off = float(1 << (bits - 1))
    if zeros is not None:
        off = off + zeros
    return (scales * (a - off * b)).sum(dim=0).to(out_dtype)


def vpu_gemv(x, packed, scales, zeros, *, bits: int, group_size: int,
             out_dtype) -> torch.Tensor:
    """K9 on the card (``csrc/dequant_matmul.cu``); the plain version for
    CPU tensors. Arguments as in ``vpu_gemv_plain``; on the card x is bf16
    or f32."""
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
    splits, per = _plan(lib.nctt_vpu_gemv_plan, "nctt_vpu_gemv_plan", N, K,
                        G, bits, _sm_count(dev))
    y = torch.empty(N, dtype=out_dtype, device=dev)
    part = (torch.empty((splits, N), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    err = lib.nctt_vpu_gemv(
        x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
        None if zeros is None else zeros.data_ptr(), y.data_ptr(),
        None if part is None else part.data_ptr(), N, K, G, bits,
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        splits, per, _build.stream_handle(dev))
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
