"""K14's attention (``paged_latent_attn``) at deepseek-v3's main-path shapes,
for choosing its plan and for comparing two checkouts on one card: each
call against its plain version (within ``lat_tol``: 1e-5 of each slot's
largest |output|, as ``chip_smoke.py`` holds it; and how many outputs are
bit for bit), its event ms (back-to-back calls, pools rotated through
>200 MB of copies), its device ms (torch.profiler: the call's kernels
summed, and each kernel apart), its back-to-back ms (calls queued behind a
sleeping kernel, so none waits for the host), and the wrapper's host µs a
call: the whole call, the C entry alone (its arguments' conversion by
ctypes and the CUDA launches) and the Python around it. The timers are
``chip_smoke.py``'s (``timed_ms``, ``backlog_ms``, ``profiled``).

    python3 tools/latent_attn_sweep.py [--root <checkout>] [--sweep]
        [--parts 128 256 ...] [--groups 16 64 ...] [--stages 2 4 ...]
        [--probe]

Cases: 8 slots at ``chip_smoke.DS_LENGTHS`` (1 to 4,096 rows: the check's
K14 row) and 8 slots of 4,096 rows (the engine's idle slots park at the
table's last row), H 128, C 576, r 512, 32 pages of 128 rows a slot.
``--root`` imports the port from another checkout (only the wrapper's
public arguments are used), so run parent, change, change, parent in one
call. ``--sweep`` (a checkout with ``latent_plan``) also runs every case at
parts of 128, 256, 512 and 1,024 rows (``PART_ROWS``, or those ``--parts``
names), the constant set for the measurement and then restored. The head
group and the rings' depth are compile-time constants of the kernels
(``csrc/paged_latent.cuh`` ``HG`` and ``NST``): ``--groups`` and
``--stages`` run this script again on a copy of the port with the one or
the other changed (``HEAD_GROUP`` or ``_LAT_STAGES`` to match), each built
apart under ``csrc/_build/variants/``. ``--probe`` builds and runs
``tools/dmma_probe.cu`` at each float64 mma shape: whether nvcc takes it
for sm_90a, whether its fragment layout gives exact products, and its
rate against float64 FMAs on the CUDA cores, at 8, 16 and 32 warps an
SM.
"""

import argparse
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (its timers; it imports no kernel at load)

B, H, C, R, PAGE, PMAX = 8, 128, 576, 512, 128, 32
SCALE = 192 ** -0.5
# K14's kernels as torch.profiler names them, and a parent's one-pass kernel
NAMES = chip_smoke.LATENT_KERNELS + ("paged_latent_attention_kernel",)


def host_us(fn, n=1000):
    for _ in range(20):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def probe(_build) -> None:
    """Build and run tools/dmma_probe.cu at each float64 mma shape, the
    binaries beside the kernel library's builds."""
    _build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for km in (0, 4, 8, 16):
        exe = _build.BUILD_ROOT / f"dmma_probe_{km}"
        procs[km] = (exe, subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, "-O3", "-std=c++17",
             f"-DKM={km}", "-o", str(exe), str(ROOT / "tools" /
                                                 "dmma_probe.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for km, (exe, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            print(f"mma shape KM={km}: nvcc refused it: {log[:400]}",
                  flush=True)
            continue
        run = subprocess.run([str(exe)], capture_output=True, text=True)
        print(run.stdout.strip() or run.stderr.strip(), flush=True)


def variant(root: Path, hg: int, nst: int) -> Path:
    """A copy of ``root``'s port whose K14 kernels take ``hg`` heads a
    block and rings of ``nst`` stages, under ``root``'s build folder."""
    pkg = "neural_compressor_tpu_torch"
    dst = root / pkg / "csrc" / "_build" / "variants" / f"hg{hg}_nst{nst}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root / pkg, dst / pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, old, new in (
            ("csrc/paged_latent.cuh", "constexpr int HG = 32;",
             f"constexpr int HG = {hg};"),
            ("kernels/paged_attention.py", "\nHEAD_GROUP = 32\n",
             f"\nHEAD_GROUP = {hg}\n"),
            ("csrc/paged_latent.cuh", "constexpr int NST = 3;",
             f"constexpr int NST = {nst};"),
            ("kernels/paged_attention.py", "\n_LAT_STAGES = 3 ",
             f"\n_LAT_STAGES = {nst} ")):
        f = dst / pkg / rel
        text = f.read_text()
        if text.count(old) != 1:
            sys.exit(f"variant: {rel} has no single {old.strip()!r}")
        f.write_text(text.replace(old, new))
    return dst


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--parts", type=int, nargs="+",
                    default=[128, 256, 512, 1024])
    ap.add_argument("--groups", type=int, nargs="+", default=[])
    ap.add_argument("--stages", type=int, nargs="+", default=[])
    args = ap.parse_args()
    for hg, nst in ([(g, 3) for g in args.groups]
                    + [(32, st) for st in args.stages]):
        root = variant(Path(args.root).resolve(), hg, nst)
        print(f"== {hg} heads a group, rings of {nst} stages", flush=True)
        code = subprocess.run([sys.executable, __file__, "--root",
                               str(root)]).returncode
        if code:
            sys.exit(code)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from neural_compressor_tpu_torch.kernels import _build
    from neural_compressor_tpu_torch.kernels import paged_attention as pa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), f"root={args.root}",
          flush=True)
    if args.probe:
        probe(_build)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(51)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    n_pages = B * PMAX + 1
    bt = (torch.randperm(B * PMAX, generator=torch.Generator()
                         .manual_seed(52)) + 1).reshape(B, PMAX).to(
        torch.int32).to(dev)
    nbytes = n_pages * PAGE * C * 2
    pools = [randn(n_pages, 1, PAGE, C)
             for _ in range(max(2, math.ceil(200e6 / nbytes)))]
    q = randn(B, H, C)
    lib = _build.library()

    # host µs a call: the whole call, the C entry alone, the Python around it
    class Recorder:         # the C entry the wrapper calls, and its arguments
        def __getattr__(self, name):
            def call(*a):
                self.last = (getattr(lib, name), a)
                return 0
            return call

    # host µs where the device keeps up: every slot one row long
    l0 = torch.ones(B, dtype=torch.int32, device=dev)
    fn = lambda: pa.paged_latent_attn(q, pools[0], bt, l0, R, SCALE)  # noqa
    whole = host_us(fn)
    torch.cuda.synchronize()
    rec = Recorder()
    _build._lib = rec
    try:
        python = host_us(fn)
    finally:
        _build._lib = lib
    entry, a = rec.last
    centry = host_us(lambda: entry(*a))
    torch.cuda.synchronize()
    print(f"host us a call (every slot one row): {whole:.2f} (C entry "
          f"{centry:.2f}, its {len(a)} arguments; Python around it "
          f"{python:.2f})", flush=True)

    l1 = torch.tensor(chip_smoke.DS_LENGTHS, dtype=torch.int32, device=dev)
    cases = {"lengths=" + ",".join(map(str, chip_smoke.DS_LENGTHS)): l1,
             "every slot 4096": torch.full((B,), PMAX * PAGE,
                                           dtype=torch.int32, device=dev)}
    refs = {k: pa.paged_latent_attn_plain(q, pools[0], bt, v, R, SCALE)
            for k, v in cases.items()}
    plans = [{}]
    if args.sweep:
        plans += [dict(PART_ROWS=pr) for pr in args.parts]
    bad = []
    for plan in plans:
        saved = {k: getattr(pa, k) for k in plan}
        for k, v in plan.items():
            setattr(pa, k, v)
        if plan:
            pa.latent_plan.cache_clear()
        try:
            for label, lengths in cases.items():
                try:
                    out = pa.paged_latent_attn(q, pools[0], bt, lengths, R,
                                               SCALE)
                    torch.cuda.synchronize()
                except (RuntimeError, ValueError) as e:
                    print(f"{plan} {label}: {e}", flush=True)
                    continue
                ref = refs[label]
                d = (out - ref).abs()
                tol = 1e-5 * ref.abs().amax(dim=(1, 2), keepdim=True) + 1e-30
                ok = bool(torch.isfinite(out).all()) and bool((d <= tol).all())
                if not ok:
                    bad.append(f"{plan} {label}")
                fns = [lambda p=p: pa.paged_latent_attn(q, p, bt, lengths, R,
                                                        SCALE) for p in pools]
                ms = chip_smoke.timed_ms(torch, fns, 50)
                kern = chip_smoke.profiled(torch, fns, names=NAMES)
                bms = chip_smoke.backlog_ms(torch, fns, 100)
                used = (pa.latent_plan(B, H, C, R, PAGE, PMAX)
                        if hasattr(pa, "latent_plan") else None)
                print(f"{plan or 'plan as committed'} {label}: within "
                      f"lat_tol={ok} max d/tol={float((d / tol).max()):.3g} "
                      f"bit-equal {int((out == ref).sum())}/{out.numel()} "
                      f"ms={ms:.4f} device_ms={sum(kern.values()):.4f} "
                      f"back_to_back_ms={bms:.4f} "
                      f"{ {k: round(v, 4) for k, v in kern.items()} } "
                      f"plan={used and used[:4]}", flush=True)
        finally:
            for k, v in saved.items():
                setattr(pa, k, v)
            if plan:
                pa.latent_plan.cache_clear()
    print(f"outside lat_tol: {bad}" if bad else "every case within lat_tol",
          flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
