"""GPTQ — Hessian-based weight-only quantization.

The counterpart of ``neural_compressor_tpu/algorithms/gptq.py``: H = 2/n ·
XᵀX accumulated in float32 over each Linear's calibration inputs, a damped
Cholesky factor of H's inverse, the blocked column sweep with error
feedback (``act_order``, ``static_groups``, ``hybrid_order`` (GAR),
``fp8_aware``, nf4/fp4 codebooks), block-sequential calibration (each
quantized block's outputs feed the next) and the lm_head.

The sweep is PyTorch on the model's device (the card on the main path):
an outer loop over panels of ``block_size`` columns, an inner loop over the
panel's columns, as JAX's ``fori_loop`` nest. It holds no Pallas kernel in
the JAX package, so it is glue, not the port of a kernel.

Convention: kernels are [K, N] (in × out); the sweep runs on Wᵀ [N, K]
with H [K, K] over the input dim. A division by a constant is a
multiplication by its float32 reciprocal, as XLA compiles the jitted JAX
sweep.
"""

from __future__ import annotations

import torch
from torch import nn

from ..common import logger
from ..layers.module_utils import get_module, named_modules, replace_module
from ..layers.observers import ObserverStat
from ..layers.woq_linear import WOQLinear
from ..ops.packing import pack_qtensor
from ..ops.qtensor import (CODEBOOKS, FLOAT_CODE_DTYPES, QTensor,
                           _codebook_nearest, _grouped, quantize_with_scale)
from . import register_algo
from .calib_capture import CalibCaptureState, find_target_blocks, run_capture
from .utils import dump_op_stats, extract_linear


_FLOAT_SKIP = ("fp32", "bf16", "fp16", "float32", "bfloat16", "float16")


# ---------------------------------------------------------------------------
# Hessian capture
# ---------------------------------------------------------------------------

def _xtx_update(xtx: torch.Tensor, count: torch.Tensor, x: torch.Tensor):
    """xtx + XᵀX and count + rows over one batch of inputs, in float32."""
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    return xtx + x2.T @ x2, count + x2.shape[0]


class HessianObserver(nn.Module):
    """Wraps a Linear-like module; accumulates XᵀX and the sample count over
    its inputs (float32 buffers on the module's device)."""

    def __init__(self, inner: nn.Module, in_features: int, device=None):
        super().__init__()
        self.inner = inner
        ObserverStat(self, "xtx", torch.zeros(
            (in_features, in_features), dtype=torch.float32, device=device))
        ObserverStat(self, "count", torch.zeros((), dtype=torch.float32,
                                                device=device))

    def forward(self, x, *args, **kwargs):
        self.xtx, self.count = _xtx_update(self.xtx, self.count, x)
        return self.inner(x, *args, **kwargs)

    def hessian(self) -> torch.Tensor:
        return 2.0 * self.xtx / torch.clamp_min(self.count, 1.0)


# ---------------------------------------------------------------------------
# The column sweep
# ---------------------------------------------------------------------------

def _group_scale(wg: torch.Tensor, bits: int, sym: bool, codebook=None):
    """Per-row scale and centered zero of one group slab wg [N, G]."""
    if codebook is not None:
        scale = wg.abs().amax(dim=1)
        scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
        return scale, torch.zeros_like(scale)
    if sym:
        qmax_s = 2 ** (bits - 1) - 1
        scale = wg.abs().amax(dim=1) * (1.0 / qmax_s)
        scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
        return scale, torch.zeros_like(scale)
    amax, amin = wg.amax(dim=1), wg.amin(dim=1)
    scale = (amax - amin) * (1.0 / (2 ** bits - 1))
    scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
    zero = torch.round(-amin / scale) - 2 ** (bits - 1)
    return scale, zero


def _qdq_col(w: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
             bits: int, sym: bool, codebook=None) -> torch.Tensor:
    """Quantize-dequantize one column w [N] with per-row scale and zero."""
    if codebook is not None:
        idx = _codebook_nearest(w / scale, codebook).to(torch.int64)
        return codebook[idx] * scale
    if sym:
        qmax = 2 ** (bits - 1) - 1
        return torch.clamp(torch.round(w / scale), -qmax - 1, qmax) * scale
    half = 2 ** (bits - 1)
    q = torch.clamp(torch.round(w / scale) + (zero + half), 0,
                    2 ** bits - 1) - half
    return (q - zero) * scale


def _tril_inverse(L: torch.Tensor) -> torch.Tensor:
    """The inverse of a lower-triangular [K, K] matrix (JAX's
    ``_tril_inverse_blocked`` solves it panel by panel to bound the TPU
    compiler's memory; one triangular solve is the same matrix here)."""
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def gptq_quantize_matrix(W: torch.Tensor, H: torch.Tensor, *, bits=4,
                         group_size=128, sym=True, act_order=False,
                         percdamp=0.01, block_size=128, static_groups=False,
                         hybrid_order=False, fp8_aware=False, wdtype="int"):
    """Run the GPTQ sweep on one weight W [K, N] with Hessian H [K, K].

    Returns (Wq [K, N] QDQ values, scales [K/G, N], zeros [K/G, N], perm
    [K] or None, fp8_scale): ``hybrid_order`` (GAR) reorders columns by
    H's diagonal within each group and whole groups globally, returning the
    one input permutation (Wq and the scales stay in permuted order);
    ``fp8_aware`` snaps QDQ values onto the e4m3 grid inside a protective
    range (values multiplied back by the power-of-two fp8 scale);
    ``wdtype`` "nf4"/"fp4" rounds to the codebook."""
    codebook = (CODEBOOKS[wdtype].to(W.device)
                if wdtype in FLOAT_CODE_DTYPES else None)
    K, N = W.shape
    G = group_size if group_size > 0 else K
    B = min(block_size, K)
    if K % B:
        raise ValueError(f"K={K} must be a multiple of block_size={B}")
    if act_order and hybrid_order:
        raise ValueError("hybrid_order (GAR) is not allowed with act_order")
    n_groups = K // G
    dynamic_groups = ((not static_groups) and (not act_order) and G <= B
                      and B % G == 0)
    dev = W.device
    H = H.to(torch.float32).clone()
    Wt = W.to(torch.float32).T.contiguous()                # [N, K]

    fp8_scale = torch.ones((), dtype=torch.float32, device=dev)
    prot = None
    if fp8_aware:
        fullscale = 448.0  # e4m3 max
        maxq = 2 ** (bits - 1) - 1
        prot = fullscale - fullscale / maxq
        absmax = Wt.abs().amax()
        fp8_scale = 2.0 ** torch.ceil(torch.log2(torch.clamp_min(
            absmax * (1.0 / prot), 1e-30)))
        Wt = Wt / fp8_scale

    def snap(q):
        if prot is None:
            return q
        q = torch.clamp(q, -prot, prot)
        return q.to(torch.float8_e4m3fn).to(torch.float32)

    # dead input dims
    dead = torch.diagonal(H) == 0.0
    H = H + torch.diag(dead.to(torch.float32))
    Wt = torch.where(dead[None, :], torch.zeros_like(Wt), Wt)

    perm = gar_perm = None
    if hybrid_order:
        d = torch.diagonal(H).reshape(n_groups, G)
        local = torch.argsort(-d, dim=1, stable=True)
        gperm = torch.argsort(-d.amax(dim=1), stable=True)
        gar_perm = (local + (torch.arange(n_groups, device=dev) * G)[:, None]
                    )[gperm].reshape(K)
        Wt = Wt[:, gar_perm]
        H = H[gar_perm][:, gar_perm]
    if act_order:
        perm = torch.argsort(-torch.diagonal(H), stable=True)
        Wt = Wt[:, perm]
        H = H[perm][:, perm]

    if act_order or not dynamic_groups:
        # static group parameters from the (permuted) original weights,
        # on the original column positions (hybrid: the permuted grid)
        W0 = (Wt if (hybrid_order or perm is None)
              else Wt[:, torch.argsort(perm)])
        slabs = W0.reshape(N, n_groups, G).transpose(0, 1)
        s_all, z_all = _group_scale(slabs.reshape(n_groups * N, G), bits,
                                    sym, codebook)
        s_all, z_all = s_all.reshape(n_groups, N), z_all.reshape(n_groups, N)
        g_of_col = (perm // G if act_order
                    else torch.arange(K, device=dev) // G).tolist()
    else:
        s_all = torch.zeros((n_groups, N), dtype=torch.float32, device=dev)
        z_all = torch.zeros((n_groups, N), dtype=torch.float32, device=dev)
        g_of_col = None

    # damped Cholesky, the upper factor U of H⁻¹ = UᵀU without forming H⁻¹:
    # with J the reversal, U = J · chol(J H J)⁻¹ · J
    damp = percdamp * torch.diagonal(H).mean()
    H = H + damp * torch.eye(K, dtype=torch.float32, device=dev)
    Lrev = torch.linalg.cholesky(H.flip(0, 1))
    U = _tril_inverse(Lrev).flip(0, 1)

    Q = torch.zeros((N, K), dtype=torch.float32, device=dev)
    for start in range(0, K, B):
        Wblk = Wt[:, start:start + B].clone()
        Ublk = U[start:start + B, start:start + B]
        Err = torch.zeros((N, B), dtype=torch.float32, device=dev)
        cur_s = cur_z = None
        for i in range(B):
            if dynamic_groups:
                if i % G == 0:
                    base = (i // G) * G
                    cur_s, cur_z = _group_scale(Wblk[:, base:base + G], bits,
                                                sym, codebook)
                    gidx = (start + base) // G
                    s_all[gidx], z_all[gidx] = cur_s, cur_z
                s, z = cur_s, cur_z
            else:
                gid = g_of_col[start + i]
                s, z = s_all[gid], z_all[gid]
            w = Wblk[:, i]
            q = snap(_qdq_col(w, s, z, bits, sym, codebook))
            err = (w - q) / Ublk[i, i]
            Wblk[:, i + 1:] -= err[:, None] * Ublk[i, i + 1:][None, :]
            Q[:, start + i] = q
            Err[:, i] = err
        # propagate the panel's error to every later column
        if start + B < K:
            Wt[:, start + B:] -= Err @ U[start:start + B, start + B:]

    if perm is not None:
        Q = Q[:, torch.argsort(perm)]
    if fp8_aware:
        Q = Q * fp8_scale
        s_all = s_all * fp8_scale
    return Q.T, s_all, z_all, gar_perm, fp8_scale


def gptq_layer_to_woq(kernel, H, cfg, bias=None) -> WOQLinear:
    """Full GPTQ on one kernel [K, N] -> packed ``WOQLinear``."""
    K, N = kernel.shape
    G = cfg.group_size if cfg.group_size > 0 else K
    G = min(G, K)
    cfg_dtype = getattr(cfg, "weight_dtype", getattr(cfg, "dtype", "int"))
    wdtype = cfg_dtype if cfg_dtype in FLOAT_CODE_DTYPES else "int"
    hybrid = bool(getattr(cfg, "hybrid_order", False))
    fp8_aware = bool(getattr(cfg, "fp8_aware", False))
    if fp8_aware and wdtype != "int":
        raise ValueError("fp8_aware GPTQ is an int/W4A8 flow; it cannot be "
                         f"combined with codebook dtype {cfg_dtype!r}")
    # ragged K: pad with dead input dims (H's diagonal 0: damped, weight
    # zeroed inside the sweep) so groups and panels tile evenly
    pad = (-K) % G
    if pad:
        if hybrid:
            raise ValueError(
                f"hybrid_order (GAR) needs in_features ({K}) to be a "
                f"multiple of group_size ({G}): the returned input "
                "permutation must cover exactly the real input dims")
        kernel = torch.nn.functional.pad(kernel, (0, 0, 0, pad))
        H = torch.nn.functional.pad(H, (0, pad, 0, pad))
    Kp = K + pad
    B = min(cfg.block_size, Kp)
    if Kp % B:  # a divisor panel size (G always divides Kp)
        B = G
    Wq, s_all, z_all, gar_perm, fp8_scale = gptq_quantize_matrix(
        kernel, H, bits=cfg.weight_bits, group_size=G, sym=cfg.use_sym,
        act_order=cfg.act_order, percdamp=cfg.percdamp, block_size=B,
        static_groups=cfg.static_groups, hybrid_order=hybrid,
        fp8_aware=fp8_aware, wdtype=wdtype)
    Wq = Wq[:K]
    if wdtype in FLOAT_CODE_DTYPES:
        wg = _grouped(Wq, G)
        codes = _codebook_nearest(wg / s_all[:, None, :],
                                  CODEBOOKS[wdtype].to(Wq.device)
                                  ).reshape(-1, N)[:K]
        qt = QTensor(codes, s_all, None, wdtype, cfg.weight_bits, G, (K, N))
        return WOQLinear.from_qtensor(qt, bias=bias)
    zeros = None if cfg.use_sym else z_all
    codes = quantize_with_scale(Wq, s_all, zeros, cfg.weight_bits, G,
                                scheme=cfg.scheme)
    qt = QTensor(codes, s_all, zeros, "int", cfg.weight_bits, G, (K, N))
    lin = WOQLinear(pack_qtensor(qt, perm=gar_perm), bias=bias)
    if fp8_aware:
        # for the fp8/W4A8 serving flow (the values are already on the
        # protective e4m3 grid; the matmul needs no change)
        lin.register_buffer("scale_bf16_to_fp8", fp8_scale)
    return lin


# ---------------------------------------------------------------------------
# Entry: prepare (capture) / convert (block-sequential quantize)
# ---------------------------------------------------------------------------

_capture_states: dict[int, CalibCaptureState] = {}


@register_algo("gptq")
def gptq_entry(model, configs_mapping, mode="quantize", run_fn=None,
               run_args=None, example_inputs=None, config=None):
    if mode == "prepare":
        blocks = find_target_blocks(model)
        if blocks is None:
            raise ValueError("GPTQ requires a transformer block list")
        st = CalibCaptureState(model, *blocks)
        st.attach()
        _capture_states[id(model)] = st
        return model

    if mode == "convert":
        st = _capture_states.pop(id(model), None)
        if st is None:
            raise RuntimeError("convert() before prepare() for GPTQ")
        captured = st.detach()
        # the mapping was resolved while the capture wrapper held block 0:
        # its ops are named under the wrapper ("<block 0>.inner.<op>"). The
        # JAX package looks them up under their own names, misses them and
        # leaves block 0 unquantized in this flow; the port renames them.
        wrapped = f"{st.block_paths[0]}.inner."
        configs_mapping = {
            (n.replace(wrapped, f"{st.block_paths[0]}.", 1), t): cfg
            for (n, t), cfg in configs_mapping.items()}
        return _convert(model, st.block_paths, captured, configs_mapping)

    blocks = find_target_blocks(model)
    if blocks is None:
        raise ValueError("GPTQ requires a transformer block list")
    st = CalibCaptureState(model, *blocks)
    captured = run_capture(model, st, run_fn, run_args)
    if not captured:
        raise ValueError("GPTQ calibration captured no batches: did run_fn "
                         "call the model?")
    return _convert(model, st.block_paths, captured, configs_mapping)


@torch.no_grad()
def _convert(model, block_paths, captured, configs_mapping):
    cfg_by_name = {name: cfg for (name, _t), cfg in configs_mapping.items()}
    n_done = 0
    inputs = captured  # (args, kwargs) feeding the current block

    for bi, bpath in enumerate(block_paths):
        block = get_module(model, bpath)
        targets = []
        for sub_path, sub in named_modules(block):
            if not sub_path:
                continue
            full = f"{bpath}.{sub_path}"
            cfg = cfg_by_name.get(full)
            if cfg is None or cfg.dtype in _FLOAT_SKIP:
                continue
            if extract_linear(sub) is None:
                continue
            targets.append((sub_path, full, sub))

        if targets:
            # true_sequential: the block's sub-groups in forward order, each
            # group's Hessians through the already-quantized earlier groups;
            # otherwise one pass over all targets from the same inputs
            if any(cfg_by_name[f].true_sequential for _s, f, _m in targets):
                seen, groups = [], []
                for t in targets:
                    prefix = t[0].split(".")[0]
                    if prefix not in seen:
                        seen.append(prefix)
                        groups.append([])
                    groups[seen.index(prefix)].append(t)
            else:
                groups = [targets]
            for group in groups:
                for sub_path, _full, sub in group:
                    k, _b = extract_linear(sub)
                    replace_module(block, sub_path, HessianObserver(
                        sub, k.shape[0], device=k.device))
                for args, kwargs in inputs:
                    block(*args, **kwargs)
                for sub_path, full, sub in group:
                    H = get_module(block, sub_path).hessian()
                    kernel, bias = extract_linear(sub)
                    new = gptq_layer_to_woq(kernel, H, cfg_by_name[full],
                                            bias=bias)
                    replace_module(block, sub_path, new)
                    n_done += 1
        # replay through the (now quantized) block: the next block's inputs
        if bi + 1 < len(block_paths):
            inputs = [(_as_next_input(block(*args, **kwargs), args), kwargs)
                      for args, kwargs in inputs]

    n_done += _maybe_quantize_lm_head(model, block_paths, inputs,
                                      cfg_by_name)
    logger.info("GPTQ quantized %d Linear ops over %d blocks", n_done,
                len(block_paths))
    dump_op_stats(model)
    return model


_TAIL_NORM_NAMES = ("norm", "ln_f", "final_layer_norm", "final_layernorm")


def _maybe_quantize_lm_head(model, block_paths, last_inputs, cfg_by_name):
    """GPTQ the lm_head: its Hessian from the last block's outputs passed
    through the model's tail norm (found on the block list's parent by its
    conventional name)."""
    from ..quantization.config import LM_HEAD_NAMES

    target = None
    for path, mod in named_modules(model):
        leaf = path.rsplit(".", 1)[-1]
        if leaf in LM_HEAD_NAMES and extract_linear(mod) is not None:
            cfg = cfg_by_name.get(path)
            if cfg is not None and cfg.dtype not in _FLOAT_SKIP:
                target = (path, mod, cfg)
            break
    if target is None:
        return 0
    path, head, cfg = target

    list_path = block_paths[0].rsplit(".", 1)[0]
    parent_path = list_path.rsplit(".", 1)[0] if "." in list_path else ""
    parent = get_module(model, parent_path) if parent_path else model
    tail_norm = None
    for name in _TAIL_NORM_NAMES:
        cand = getattr(parent, name, None)
        if cand is not None and callable(cand):
            tail_norm = cand
            break
    if tail_norm is None:
        logger.warning("GPTQ lm_head: no tail norm found on %r; using the "
                       "last block's raw outputs for the Hessian",
                       parent_path or "<root>")
        tail_norm = lambda x: x  # noqa: E731

    last_block = get_module(model, block_paths[-1])
    kernel, bias = extract_linear(head)
    K = kernel.shape[0]
    xtx = torch.zeros((K, K), dtype=torch.float32, device=kernel.device)
    count = torch.zeros((), dtype=torch.float32, device=kernel.device)
    for args, kwargs in last_inputs:
        out = last_block(*args, **kwargs)
        x = out[0] if isinstance(out, tuple) else out
        xtx, count = _xtx_update(xtx, count, tail_norm(x))
    H = 2.0 * xtx / torch.clamp_min(count, 1.0)
    replace_module(model, path, gptq_layer_to_woq(kernel, H, cfg, bias=bias))
    logger.info("GPTQ quantized lm_head (%s)", path)
    return 1


def _as_next_input(block_out, prev_args):
    """Blocks return x or (x, aux); x becomes the next block's first
    argument."""
    x = block_out[0] if isinstance(block_out, tuple) else block_out
    return (x, *prev_args[1:])
