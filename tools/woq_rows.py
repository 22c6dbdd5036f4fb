"""K8, K9 and K10 rows of a checkout of the port, for comparing two
checkouts on one card and for choosing K9's and K10's plan: K8
(``dequant_gemm``) at the given M and K9 (``vpu_gemv``, asym int4 g128) and
K10 (``vpu_int8act``, sym int4 g128, ``_vpu_tiles``' tk) at M = 1, at
llama2-7b's five projections. Each row: event ms (back-to-back calls,
weights rotated through >200 MB of copies), device ms (torch.profiler, the
call's kernels summed), back-to-back ms (calls queued behind a sleeping
kernel, so none waits for the host; not for K8), and each K9/K10 call held
to its plain version (K9 within ``chip_smoke.woq_tol``, K10 bit for bit).
Then each wrapper's host µs a call, at a small shape where the device keeps
up: the whole call, the C entry alone (its arguments' conversion by ctypes
and the launch) and the Python around it. The timers are ``chip_smoke.py``'s
(``timed_ms``, ``backlog_ms``, ``profiled``).

    python3 tools/woq_rows.py [--root <checkout>] [--m 8 100 128 256]
                              [--sweep] [--probe]

``--root`` imports the port from another checkout (only the wrappers'
public arguments are used), so run parent, change, change, parent in one
call; ``--m`` with no values leaves K8 out. ``--sweep`` (a checkout with
``gemv_plan``) also runs K9 and K10 at other plans: 4 or 8 warps a block
(``GEMV_WARPS``), rings of 2 or 3 slots (``GEMV_STAGES``) of at most 4, 8
or 16 word rows (``GEMV_MAX_ROWS``), each constant set for the measurement
and then restored; plans whose x or rings do not fit are skipped. ``--probe`` builds and runs ``tools/gemv_probe.cu``: the core's
access pattern (strips of columns, warp rings of cp.async, nothing
computed) at several strip widths and splits, in GB/s.
"""

import argparse
import importlib
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (its timers; it imports no kernel at load)

SHAPES = {"qkv": (4096, 12288), "o": (4096, 4096), "gate_up": (4096, 22016),
          "down": (11008, 4096), "lm_head": (4096, 32000)}
G = 128
# the kernels a call may launch, as torch.profiler names them (a parent
# checkout's K9 and K10 added a second launch each)
K8_NAMES = ("dequant_small_kernel", "dequant_gemm_kernel", "splitk_reduce")
K9_NAMES = ("vpu_gemv_kernel", "splitk_reduce")
K10_NAMES = ("vpu_int8act_kernel", "vpu_int8act_fold")
SWEEP = [(w, st, rows) for rows in (4, 8, 16) for w in (4, 8)
         for st in (2, 3)]


def host_us(fn, n=2000):
    for _ in range(50):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def probe() -> None:
    from neural_compressor_tpu_torch.kernels import _build

    out = _build.BUILD_ROOT / "gemv_probe"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-O3", "-std=c++17",
                    "-o", str(out), str(ROOT / "tools" / "gemv_probe.cu")],
                   check=True)
    print(subprocess.run([str(out)], capture_output=True, text=True,
                         check=True).stdout, flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--m", type=int, nargs="*", default=[8, 100, 128, 256])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--probe", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    if args.probe:
        probe()
    from neural_compressor_tpu_torch.kernels import _build
    from neural_compressor_tpu_torch.ops import pack_qtensor, quantize_tensor

    dm = importlib.import_module(
        "neural_compressor_tpu_torch.kernels.dequant_matmul")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), f"root={args.root}",
          flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)

    def weight(K, N, scheme="asym"):
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        return pack_qtensor(quantize_tensor(w, bits=4, group_size=G,
                                            scheme=scheme))

    def copies(pw):
        nb = (pw.packed.numel() * 4 + pw.scales.numel() * 4
              * (1 if pw.zeros is None else 2))
        return [(pw.packed.clone(), pw.scales.clone(),
                 None if pw.zeros is None else pw.zeros.clone())
                for _ in range(max(2, math.ceil(200e6 / nb)))]

    kw8 = dict(bits=4, group_size=G, layout="tpu_strided",
               out_dtype=torch.bfloat16)
    kw9 = dict(bits=4, group_size=G, out_dtype=torch.bfloat16)
    lib = _build.library()

    class Recorder:
        """The C entries a wrapper calls, and their arguments; a plan entry
        (a parent checkout's K9 asks one for its split) still runs."""

        def __init__(self):
            self.calls = []

        def __getattr__(self, name):
            real = getattr(lib, name)

            def call(*a):
                self.calls.append((real, a))
                return real(*a) if name.endswith("_plan") else 0
            return call

    # host µs a call, at a small shape where the device keeps up
    pw = weight(512, 256)
    ps = weight(512, 256, "sym")
    x8 = torch.randn((8, 512), generator=gen, device="cuda").to(
        torch.bfloat16)
    x1 = x8[0].contiguous()
    for label, fn in (
            ("dequant_gemm M=8 K=512 N=256", lambda: dm.dequant_gemm(
                x8, pw.packed, pw.scales, pw.zeros, None, **kw8)),
            ("vpu_gemv K=512 N=256", lambda: dm.vpu_gemv(
                x1, pw.packed, pw.scales, pw.zeros, **kw9)),
            ("vpu_int8act K=512 N=256", lambda: dm.vpu_int8act(
                x1, ps.packed, ps.scales, None, tk=512, **kw9))):
        whole = host_us(fn)
        torch.cuda.synchronize()
        rec = Recorder()
        _build._lib = rec
        try:
            python = host_us(fn)     # the launching entries not called
            rec.calls.clear()
            fn()
        finally:
            _build._lib = lib
        entries = list(rec.calls)
        centry = host_us(lambda: [e(*a) for e, a in entries])
        torch.cuda.synchronize()
        print(f"host us a call, {label}: {whole:.2f} (C entries {centry:.2f}:"
              f" {len(entries)} calls, {sum(len(a) for _e, a in entries)} "
              f"arguments; Python around them {python:.2f})", flush=True)

    def k9_k10_rows(tag):
        """K9 and K10 at the five shapes: checks and times; the unit (32
        layers of four projections and the lm_head) at the end."""
        unit = {}
        for name, (K, N) in SHAPES.items():
            reps = 32 if name != "lm_head" else 1
            x = torch.randn((K,), generator=gen, device="cuda").to(
                torch.bfloat16)
            for kind, pw_ in (("k9", weight(K, N)),
                              ("k10", weight(K, N, "sym"))):
                tk = dm._vpu_tiles(K, N, G)[0]
                if kind == "k9":
                    call, names = dm.vpu_gemv, K9_NAMES
                    a = dict(kw9)
                    yp = dm.vpu_gemv_plain(x, pw_.packed, pw_.scales,
                                           pw_.zeros, **a)
                else:
                    call, names = dm.vpu_int8act, K10_NAMES
                    a = dict(kw9, tk=tk)
                    yp = dm.vpu_int8act_plain(x, pw_.packed, pw_.scales,
                                              pw_.zeros, **a)
                yk = call(x, pw_.packed, pw_.scales, pw_.zeros, **a)
                again = call(x, pw_.packed, pw_.scales, pw_.zeros, **a)
                torch.cuda.synchronize()
                if kind == "k9":
                    tol = chip_smoke.woq_tol(torch, x, pw_, yp, True)
                    ok = bool(((yk.float() - yp.float()).abs()
                               <= tol).all())
                else:
                    ok = torch.equal(yk, yp)
                ok = ok and torch.equal(yk, again)
                cps = copies(pw_)
                fns = [lambda c=c: call(x, *c, **a) for c in cps]
                ms = chip_smoke.timed_ms(torch, fns, 100)
                dev = sum(chip_smoke.profiled(torch, fns,
                                              names=names).values())
                b2b = chip_smoke.backlog_ms(torch, fns, 200)
                del cps
                for key, v in (("ms", ms), ("device_ms", dev),
                               ("b2b_ms", b2b)):
                    unit[(kind, key)] = unit.get((kind, key), 0.0) + reps * v
                plan = (dm.gemv_plan(N, K, G, 4, tk if kind == "k10" else 0)
                        if hasattr(dm, "gemv_plan") else "")
                print(f"{tag}{kind} {name:8s} ok={ok} ms={ms:.4f} "
                      f"device_ms={dev:.4f} back_to_back_ms={b2b:.4f} "
                      f"{plan}", flush=True)
        for kind in ("k9", "k10"):
            print(f"{tag}{kind} unit (32 x 4 + lm_head): "
                  + " ".join(f"{key}={unit[(kind, key)]:.4f}"
                             for key in ("ms", "device_ms", "b2b_ms")),
                  flush=True)

    k9_k10_rows("")
    for name, (K, N) in SHAPES.items():
        if not args.m:
            break
        pw = weight(K, N)
        cps = copies(pw)
        for M in args.m:
            x = torch.randn((M, K), generator=gen,
                            device="cuda").to(torch.bfloat16)
            fns = [lambda c=c: dm.dequant_gemm(x, *c, None, **kw8)
                   for c in cps]
            ms = chip_smoke.timed_ms(torch, fns, 30)
            dms = sum(chip_smoke.profiled(torch, fns,
                                          names=K8_NAMES).values())
            print(f"k8 {name:8s} M={M:4d} ms={ms:.4f} device_ms={dms:.4f}",
                  flush=True)
        del cps
    if args.sweep:
        names = ("GEMV_WARPS", "GEMV_STAGES", "GEMV_MAX_ROWS")
        keep = {k: getattr(dm, k) for k in names}
        for values in SWEEP:
            for k, v in zip(names, values):
                setattr(dm, k, v)
            dm.gemv_plan.cache_clear()
            try:   # every shape's x must fit the rings' shared memory
                for K, N in SHAPES.values():
                    dm.gemv_plan(N, K, G, 4)
                    dm.gemv_plan(N, K, G, 4, dm._vpu_tiles(K, N, G)[0])
            except ValueError:
                continue
            k9_k10_rows("sweep warps={} stages={} rows={} ".format(*values))
        for k, v in keep.items():
            setattr(dm, k, v)
        dm.gemv_plan.cache_clear()


if __name__ == "__main__":
    main()
