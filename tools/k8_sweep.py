"""Other plans of K8's small path (``neural_compressor_tpu_torch/csrc/
dequant_matmul.cu``, ``dequant_small_kernel``) at llama2-7b's five
projections and DeepSeek-V3's expert shapes, on the card.

Each product is launched through the C entry on ``dequant_plan``'s plan
and on plans it may not pick (the tile path; 2-6 ring slots a warp, K split
across 1, 2 or 4 blocks), held against the plain version
within ``chip_smoke.py``'s ``woq_tol``, and timed by torch.profiler
(device ms a launch, weights rotated through >200 MB of copies so that
every launch reads device memory). ``dequant_plan``'s tiles come from such
runs (the wrapper's host µs a call: ``tools/woq_rows.py``).

    python3 tools/k8_sweep.py [--m 8 16] [--shapes o down] [--quick] [--sass]

``--sass`` also prints, from ``cuobjdump -sass`` of the built library, the
static instruction counts of each small-path instance by opcode.

Needs one CUDA card and nvcc; prints a line a plan and exits non-zero if
any plan disagrees with the plain version.
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SHAPES = {"qkv": (4096, 12288), "o": (4096, 4096), "gate_up": (4096, 22016),
          "down": (11008, 4096), "lm_head": (4096, 32000),
          "expert_up": (7168, 2048), "expert_down": (2048, 7168)}
G = 128
N_SM = 132
KERNELS = ("dequant_small_kernel", "dequant_gemm_kernel", "splitk_reduce")


def launch(dm, build, plan, x, pw):
    """One launch of K8's C entry on ``plan`` (bf16 out)."""
    M, K = x.shape
    ng, N = pw.scales.shape
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    part = tickets = None
    if plan.splits > 1:
        part, tickets = dm._workspace(x.device, plan.splits * M * N,
                                      plan.grid[0] * plan.grid[-1])
        part, tickets = part.data_ptr(), tickets.data_ptr()
    err = build.library().nctt_dequant_gemm(
        x.data_ptr(), pw.packed.data_ptr(), pw.scales.data_ptr(),
        None if pw.zeros is None else pw.zeros.data_ptr(), None,
        y.data_ptr(), part, tickets, M, N, K, G, pw.bits, 0, 0, 1,
        dm.PATHS[plan.path], plan.mt, plan.bn, plan.stages, plan.per,
        plan.splits, plan.smem, build.stream_handle(x.device))
    build.check(err, "nctt_dequant_gemm")
    return y


def small(dm, M, N, K, stages, s):
    """A small-path plan with ``stages`` ring slots, K split across ``s``
    blocks (as evenly as whole chunks allow)."""
    nchunks = (K // 8) // dm.SK_CHUNK
    per = -(-nchunks // (dm.SK_WARPS * s))
    splits = -(-nchunks // (dm.SK_WARPS * per))
    mt = 8 if M <= 8 else 16
    return dm.DequantPlan("small", mt, dm.SK_WN, stages, per, splits,
                          (N // dm.SK_WN, splits, -(-M // mt)),
                          dm.small_smem(mt, 4, stages))


def plans(dm, M, N, K, quick=False):
    """``dequant_plan``'s plan first, then the others, each once (with
    ``quick``, only the tile path's beside it)."""
    out = [dm.dequant_plan(M, N, K, G, 4, "tpu_strided"),
           dm.tile_plan(M, N, K, G, 4, "tpu_strided", N_SM)]
    out += [small(dm, M, N, K, st, s) for s in (1, 2, 4)
            for st in (2, 3, 4, 6) if not quick]
    seen, uniq = set(), []
    for p in out:
        if p not in seen and p.smem <= dm.MAX_DYN_SMEM:
            seen.add(p)
            uniq.append(p)
    return uniq


def sass_counts(lib_path) -> None:
    """Static instruction counts by opcode of each ``dequant_small_kernel``
    instance in the built library (``cuobjdump -sass``)."""
    import collections
    import re
    import subprocess

    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                          str(lib_path)], capture_output=True,
                         text=True).stdout
    for part in out.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if "dequant_small_kernel" not in name:
            continue
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                part))
        print(f"sass {name}: {sum(ops.values())} instructions; "
              + ", ".join(f"{k} {v}" for k, v in ops.most_common(24)),
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, nargs="*", default=[8])
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES))
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="only dequant_plan's plan and the tile path's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from neural_compressor_tpu_torch.kernels import _build
    from neural_compressor_tpu_torch.kernels import dequant_matmul as dm

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    if args.sass:
        sass_counts(_build.build())
    smi = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    bad = []
    for name in args.shapes:
        K, N = SHAPES[name]
        pw = cs.woq_weight(torch, gen, K, N)
        wbytes = K * N // 2 + 2 * (K // G) * N * 4
        cps = [pw._replace(packed=pw.packed.clone(), scales=pw.scales.clone(),
                           zeros=pw.zeros.clone())
               for _ in range(cs.n_copies(wbytes))]
        for M in args.m:
            x = torch.randn((M, K), generator=gen,
                            device="cuda").to(torch.bfloat16)
            yp = dm.dequant_gemm_plain(x, pw.packed, pw.scales, pw.zeros,
                                       None, bits=4, group_size=G,
                                       layout="tpu_strided",
                                       out_dtype=torch.bfloat16)
            tol = cs.woq_tol(torch, x, pw, yp, k9=False)
            for i, plan in enumerate(plans(dm, M, N, K, args.quick)):
                y = launch(dm, _build, plan, x, pw)
                torch.cuda.synchronize()
                ok = bool(((y.float() - yp.float()).abs() <= tol).all())
                if not ok:
                    bad.append((name, M, plan))
                fns = [lambda c=c, p=plan: launch(dm, _build, p, x, c)
                       for c in cps]
                dms = sum(cs.profiled(torch, fns, names=KERNELS).values())
                bms = (wbytes + 2 * M * K + 2 * M * N) / 3.35e12 * 1e3
                print(f"k8 {name:11s} M={M:3d} {'plan' if i == 0 else '    '}"
                      f" {plan.path} mt={plan.mt} bn={plan.bn} "
                      f"stages={plan.stages} per={plan.per} "
                      f"splits={plan.splits} smem={plan.smem} ok={ok} "
                      f"device_ms={dms:.4f} bound_ms={bms:.4f}", flush=True)
        del cps
    if bad:
        sys.exit(f"plans that disagree with the plain version: {bad}")


if __name__ == "__main__":
    main()
