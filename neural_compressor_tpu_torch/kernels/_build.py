"""Build and load the port's hand-written CUDA kernels.

The sources under ``neural_compressor_tpu_torch/csrc`` are compiled at
first use, never at import: ``nvcc`` for ``sm_90a``, one process per
source, all started together, then linked into one shared library with a
plain C interface that ``ctypes`` loads. The build goes to
``csrc/_build/<digest>/``, keyed by a hash of the sources and flags, so a
second process reuses it and an edited source rebuilds. A failed build
raises with nvcc's standard error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC / "_build"
LIB_NAME = "libnctt_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C entry -> argument types; every entry returns cudaGetLastError() (or
# cudaErrorInvalidValue for a plan or shape it refuses)
SIGNATURES = {
    # xq, w, scales, x_scale, y, M, N, K, G, then the plan (path, mt, bn,
    # ku, stages), stream (K1 on "hopper_nk" and "tpu_strided" words, K2 on
    # "s4_rowpack")
    "nctt_w4a8_gemm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _I, _P],
    "nctt_w4a8_gemm_strided": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _P],
    "nctt_s4_gemm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                     _P],
    # x, rms_w, w, scales, bias, residual, y, K, N, G, n_out, silu, eps,
    # codes, scl (global scratch past MAX_K, else null), stream
    "nctt_fused_gemv": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                        _P, _P, _P],
    # q, k_cache, v_cache, pos (int32 [B] on the device), out, plan (the
    # argument block of decode_attention.decode_workspace: scratch and
    # plan), B, H, Hkv, T, D, scale, stream (K5)
    "nctt_decode_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                              _P],
    # q, k_cache, v_cache, out, ws (f32 score rows), B, H, Hkv, T, D, pos
    # (int32 [B] on the device), scale, stream (K16's bulk-copy kernel)
    "nctt_decode_attention_hbm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                                  _F, _P],
    # q, k_new, v_new, k_cache, k_scale, v_cache, v_scale (scales null for
    # bf16), pos (int32 [B] on the device), out, plan (decode_workspace's
    # argument block), B, H, Hkv, T, D, fmt (0 bf16, 1 int8), scale, stream
    # (K16's in-kernel write)
    "nctt_decode_attention_write": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _F, _P],
    # q, k_cache, v_cache, pos, w, scales, residual, y, plan
    # (decode_workspace's argument block: scratch, att, amax), H, Hkv, T, D,
    # N, cols (of an o-projection block), dependent (1: the o-projection a
    # dependent launch), scale, stream (K18)
    "nctt_attn_o": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                    _I, _I, _F, _P],
    # x, residual, rms_w, ow, osc, guw, gusc, dw, dsc, y, x1s, hs (f32
    # scratch), Ko, Kh, I, Go, Gg, Gd, tn_i, eps, has_o, stream
    "nctt_omlp": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                  _I, _I, _I, _I, _F, _I, _P],
    # q, k_pages, k_scales, v_pages, v_scales, block_tables, lengths, out,
    # plan (the argument block of paged_attention.v1_workspace: scratch and
    # plan), B, H, Hkv, P, page, PMAX, D, fmt (0 bf16, 1 int8, 2 fp8),
    # scale, stream (K15)
    "nctt_paged_attention_v1": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _I, _I, _I, _I, _F, _P],
    # q, k_new, v_new, k_codes, k_scale, v_codes, v_scale, pos (int32 [B]
    # on the device), out, plan (the argument block of
    # decode_attention.decode_workspace: scratch and plan), B, H, Hkv, T, D,
    # fp8, scale, stream (K6)
    "nctt_decode_attention_quant": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _F, _P],
    # q, k_cache, v_cache, k_scale, v_scale, pos, out, plan, B, H, Hkv, T,
    # D, code (0 bf16, 1 int8, 2 fp8), scale, stream (K7)
    "nctt_batched_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                      _I, _I, _I, _I, _F, _P],
    # q, k_pages, k_scales, k_offs, v_pages, v_scales, v_offs,
    # block_tables, lengths, out, ws (f32 scores), pmax (f32 part maxima),
    # part (f64 partials), tickets (int32, zeroed), B, H, Hkv, W, P, page,
    # PMAX, D, fmt (0 bf16, 1 int8, 2 fp8, 3 int4), ng, part_keys, parts,
    # scale, window (0: none), softcap (0: none), 1/softcap, stream
    "nctt_paged_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _I, _I, _I, _I, _I, _I, _F, _I, _F, _F,
                                    _P],
    # k_new, v_new, k_pages, k_scales, k_offs, v_pages, v_scales, v_offs,
    # block_tables, pos, B, Hkv, P, page, PMAX, D, fmt, stream
    "nctt_paged_write_rows": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                              _I, _I, _I, _I, _I, _P],
    # the same, k_new/v_new [B, Hkv, W, D]: ..., PMAX, D, W, fmt, stream
    "nctt_paged_write_window": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                _I, _I, _I, _I, _I, _I, _I, _P],
    # row, pages, block_tables, pos, B, P, page, PMAX, C, stream
    "nctt_paged_latent_write": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, pages, block_tables, lengths, out, plan (the argument block of
    # paged_attention.latent_workspace: scratch and plan), B, H, P, page,
    # PMAX, C, r, scale, stream
    "nctt_paged_latent_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _I, _F, _P],
    # x, w, scales, zeros, codebook, out, part, tickets, M, N, K, G, bits,
    # layout_int8, x_f32, out_bf16, path, mt, bn, stages, per, splits,
    # smem, stream (the plan from dequant_matmul.dequant_plan)
    "nctt_dequant_gemm": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, w, scales, zeros, out, plan (the argument block of
    # dequant_matmul.gemv_workspace: workspace and plan), N, K, G, bits,
    # x_bf16, out_bf16, stream (K9)
    "nctt_vpu_gemv": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # the same with tk (the K tile) after bits (K10)
    "nctt_vpu_int8act": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# seconds the build took in this process; 0.0 when an earlier build was reused
build_seconds: float | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if this digest is not built yet); return the
    shared library's path. The compiler's resource report (registers,
    shared memory, spills) is kept beside it in ``nvcc.log``."""
    global build_seconds
    out_dir = BUILD_ROOT / digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        if build_seconds is None:
            build_seconds = 0.0
        return lib
    t0 = time.perf_counter()
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-"))
    try:
        jobs, done = [], {}
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)

            def wait(proc=proc, src=src):
                out, err = proc.communicate()
                done[src] = (out, err, time.perf_counter() - t0)

            waiter = threading.Thread(target=wait)
            waiter.start()
            jobs.append((src, obj, proc, waiter))
        log, errors = [], []
        for src, _obj, proc, waiter in jobs:
            waiter.join()
            out, err, secs = done[src]
            log.append(f"== {src.name} ({secs:.1f} s)\n{out}{err}")
            if proc.returncode:
                errors.append(f"nvcc failed on {src.name} "
                              f"(exit {proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError("\n".join(errors))
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
             *(str(obj) for _s, obj, _p, _w in jobs)],
            capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        (tmp / "nvcc.log").write_text("\n".join(log))
        try:
            os.rename(tmp, out_dir)
        except OSError:
            if not lib.exists():  # lost a race only if the winner finished
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is not None:   # no lock once loaded: a launch takes this path
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require(t, name: str, dtype, device, shape) -> None:
    """Validate one kernel operand: device, dtype, shape, contiguity and
    16-byte alignment (the kernels load 16-byte vectors)."""
    if (t.device == device and t.dtype == dtype and t.shape == shape
            and t.is_contiguous() and not t.data_ptr() % 16):
        return                       # the launch path: one test
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
