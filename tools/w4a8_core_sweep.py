"""Other tiles of the W4A8 core (``neural_compressor_tpu_torch/csrc/
w4a8_core.cuh``, K1 and K2) at llama2-7b's five projections, on the card.

Each product is launched through its C entry on ``gemm_plan``'s plan and on
plans it may not pick (the small path's own and other tiles of it, wgmma
at 64 x 64 and 128 x 128 with 4 or 6 ring slots), held bit for bit
against the plain version, and timed by torch.profiler (device ms a
launch, weights rotated through >200 MB of copies so that every launch
reads device memory). ``gemm_plan``'s thresholds and tiles come from
such runs. With ``--probe`` it also builds and runs
``tools/stream_probe.cu``: the core's access pattern (cp.async rings, no
compute) against plain 16-byte loads.

    python3 tools/w4a8_core_sweep.py [--m 17 32 64] [--probe]

Needs one CUDA card and nvcc; prints a line a plan and exits non-zero if
any plan disagrees with the plain version.
"""

import argparse
import importlib
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

SHAPES = {"qkv": (4096, 12288), "o": (4096, 4096), "gate_up": (4096, 22016),
          "down": (11008, 4096), "lm_head": (4096, 32000)}
G = 128
ENTRY = {"hopper_nk": "nctt_w4a8_gemm",
         "tpu_strided": "nctt_w4a8_gemm_strided",
         "s4_rowpack": "nctt_s4_gemm"}
KERNELS = ("small_kernel", "wgmma_kernel", "any_group_kernel")


def launch(wm, build, layout, plan, xq, w, sc, xs):
    """One launch of the layout's C entry on ``plan``."""
    M, K = xq.shape
    ng, N = sc.shape
    y = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    err = getattr(build.library(), ENTRY[layout])(
        xq.data_ptr(), w.data_ptr(), sc.data_ptr(), xs.data_ptr(),
        y.data_ptr(), M, N, K, K // ng, wm.PATHS[plan.path], plan.mt,
        plan.bn, plan.ku, plan.stages, build.stream_handle(xq.device))
    build.check(err, ENTRY[layout])
    return y


def plans(wm, M, N, K, layout):
    """``gemm_plan``'s plan first, then the others, each once."""
    out = [wm.gemm_plan(M, N, K, G, layout)]
    if M <= wm.SMALL_M:
        out.append(wm.small_plan(M, N, K, G, layout))
        direct = layout == "hopper_nk"
        out += [wm.GemmPlan("small", mt, bn, wm.KS, 3,
                            (N // bn, -(-M // mt)),
                            wm.small_smem(mt, bn, wm.KS, 3, G, direct))
                for mt in (8, 16, 32) for bn in (16, 32)
                if mt >= M / 2 or mt == 16]
    out += [wm.wgmma_plan(M, N, bm, bn, st)
            for bm, bn in ((64, 64), (128, 128)) for st in (4, 6)]
    seen, uniq = set(), []
    for p in out:
        if p is not None and p not in seen and p.smem <= wm.MAX_DYN_SMEM:
            seen.add(p)
            uniq.append(p)
    return uniq


def device_ms(fns, n: int = 40) -> float:
    """Device ms a call of the core's kernels over ``n`` calls of ``fns``
    (cycled), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    for f in fns:
        f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if any(k in e.key for k in KERNELS)) / 1e3 / n


def sweep(ms, layouts) -> list:
    from neural_compressor_tpu_torch.kernels import _build
    from neural_compressor_tpu_torch.ops import (pack_qtensor,
                                                 quantize_act_per_token,
                                                 quantize_tensor, to_hopper,
                                                 to_s4_rowpack)

    wm = importlib.import_module(
        "neural_compressor_tpu_torch.kernels.w4a8_matmul")
    s4 = importlib.import_module(
        "neural_compressor_tpu_torch.kernels.s4_matmul")
    plain = {"hopper_nk": wm.w4a8_gemm_plain,
             "tpu_strided": wm.w4a8_gemm_strided_plain,
             "s4_rowpack": s4.s4_gemm_plain}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    bad = []
    for name, (K, N) in SHAPES.items():
        w = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
        pw = pack_qtensor(quantize_tensor(w, bits=4, group_size=G))
        words = {"hopper_nk": to_hopper(pw).packed, "tpu_strided": pw.packed,
                 "s4_rowpack": to_s4_rowpack(pw).packed}
        sc = pw.scales
        wbytes = K * N // 2 + (K // G) * N * 4
        for layout in layouts:
            cps = [(words[layout].clone(), sc.clone())
                   for _ in range(max(2, math.ceil(200e6 / wbytes)))]
            for M in ms:
                xq, xs = quantize_act_per_token(torch.randn(
                    (M, K), generator=gen, device=dev).to(torch.bfloat16))
                xs = xs.reshape(-1).contiguous()
                yp = plain[layout](xq, words[layout], sc, xs)
                for i, p in enumerate(plans(wm, M, N, K, layout)):
                    same = torch.equal(
                        launch(wm, _build, layout, p, xq, words[layout], sc,
                               xs), yp)
                    if not same:
                        bad.append((name, M, layout, p))
                    dms = device_ms([lambda p=p, w_=w_, s_=s_: launch(
                        wm, _build, layout, p, xq, w_, s_, xs)
                        for w_, s_ in cps])
                    print(f"{name:7s} M={M:4d} {layout:11s} "
                          f"{'gemm_plan' if i == 0 else 'other':9s} "
                          f"{p.path:5s} mt={p.mt:3d} bn={p.bn:3d} "
                          f"ku={p.ku:4d} stages={p.stages} grid={p.grid} "
                          f"bit-equal={same} device_ms={dms:.4f}",
                          flush=True)
            del cps
    return bad


def probe() -> None:
    from neural_compressor_tpu_torch.kernels import _build

    out = _build.BUILD_ROOT / "stream_probe"
    _build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-O3", "-std=c++17",
                    "-o", str(out), str(ROOT / "tools" / "stream_probe.cu")],
                   check=True, timeout=300)
    for rows in (4096, 32768):   # 8 MiB (llama2-7b's o), 64 MiB
        run = subprocess.run([str(out), str(rows)], capture_output=True,
                             text=True, timeout=300, check=True)
        print(run.stdout, end="", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, nargs="+", default=[17, 32, 64])
    ap.add_argument("--layouts", nargs="+", default=list(ENTRY))
    ap.add_argument("--probe", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    bad = sweep(args.m, args.layouts)
    if args.probe:
        probe()
    if bad:
        sys.exit(f"plans that disagree with the plain version: {bad}")


if __name__ == "__main__":
    main()
