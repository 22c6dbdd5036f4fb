"""K8 and K9 rows of a checkout of the port, for comparing two checkouts on
one card: K8 (``dequant_gemm``) at the given M and K9 (``vpu_gemv``) at M
= 1 at llama2-7b's five projections (asym int4 g128), each launch's event
ms (back-to-back launches, weights rotated through >200 MB of copies) and
device ms (torch.profiler), and the wrapper's host µs a call.

    python3 tools/woq_rows.py --root <checkout> [--m 8 100 128 256]

It imports the port from ``--root`` (this checkout by default) and uses
only the wrappers' public arguments, which parent and change share; run
it on parent, change, change, parent in one call.
"""

import argparse
import math
import subprocess
import sys
import time
from pathlib import Path

SHAPES = {"qkv": (4096, 12288), "o": (4096, 4096), "gate_up": (4096, 22016),
          "down": (11008, 4096), "lm_head": (4096, 32000)}
G = 128
NAMES = ("dequant_small_kernel", "dequant_gemm_kernel", "splitk_reduce",
         "vpu_gemv_kernel")


def event_ms(torch, fns, iters):
    for f in fns:
        f()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(iters):
        fns[i % len(fns)]()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(torch, fns, n=40):
    from torch.profiler import ProfilerActivity, profile

    for f in fns:
        f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if any(k in e.key for k in NAMES)) / 1e3 / n


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--m", type=int, nargs="*", default=[8, 100, 128, 256])
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from neural_compressor_tpu_torch.kernels import dequant_matmul as dm
    from neural_compressor_tpu_torch.ops import pack_qtensor, quantize_tensor

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), f"root={args.root}",
          flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)

    def weight(K, N):
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        return pack_qtensor(quantize_tensor(w, bits=4, group_size=G,
                                            scheme="asym"))

    kw8 = dict(bits=4, group_size=G, layout="tpu_strided",
               out_dtype=torch.bfloat16)
    kw9 = dict(bits=4, group_size=G, out_dtype=torch.bfloat16)
    pw = weight(512, 256)
    x = torch.randn((8, 512), generator=gen, device="cuda").to(torch.bfloat16)
    for _ in range(50):
        dm.dequant_gemm(x, pw.packed, pw.scales, pw.zeros, None, **kw8)
    torch.cuda.synchronize()
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        dm.dequant_gemm(x, pw.packed, pw.scales, pw.zeros, None, **kw8)
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    print(f"host us a dequant_gemm call (M=8, K=512, N=256): "
          f"{t / n * 1e6:.2f}", flush=True)
    for name, (K, N) in SHAPES.items():
        pw = weight(K, N)
        wbytes = K * N // 2 + 2 * (K // G) * N * 4
        cps = [(pw.packed.clone(), pw.scales.clone(), pw.zeros.clone())
               for _ in range(max(2, math.ceil(200e6 / wbytes)))]
        for M in [1] + list(args.m):
            x = torch.randn((M, K), generator=gen,
                            device="cuda").to(torch.bfloat16)
            if M == 1:
                fns = [lambda c=c: dm.vpu_gemv(x, *c, **kw9) for c in cps]
            else:
                fns = [lambda c=c: dm.dequant_gemm(x, *c, None, **kw8)
                       for c in cps]
            ms = event_ms(torch, fns, 100 if M == 1 else 30)
            dms = device_ms(torch, fns)
            print(f"{'k9' if M == 1 else 'k8'} {name:8s} M={M:4d} "
                  f"ms={ms:.4f} device_ms={dms:.4f}", flush=True)
        del cps


if __name__ == "__main__":
    main()
