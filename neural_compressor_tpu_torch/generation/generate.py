"""Greedy generation for the port's causal LMs.

The counterpart of ``neural_compressor_tpu.generation.generate``'s greedy
path: a prefill fills a contiguous KV cache (in the model's KV format:
bf16, or int8, fp8-e4m3 or int4 codes when ``KVCacheQuantConfig`` flagged
the model; allocated by the model's ``init_caches`` where it has one, as
DeepSeek's MLA does), then a decode loop feeds back the argmax token. PyTorch runs eagerly, so there is no cached program;
the loop is plain Python over the model's forward. A batch of B > 1
prompts decodes through the batched attention kernel (K7); serving many
requests over contiguous or paged caches is
``serving.ContinuousBatchingEngine``'s work.

Sampling and beam search raise ``NotImplementedError`` until they are
ported.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.llama import init_kv_cache, model_kv_format


def alloc_caches(model, B: int, total: int):
    """Contiguous caches for a decode run in the model's KV format (JAX's
    ``_alloc_caches``): the model's own ``init_caches`` where it has one
    (DeepSeek's MLA: asymmetric K/V widths, or latent rows), else the
    Llama-shaped ``init_kv_cache`` from its cfg."""
    fmt = model_kv_format(model)
    init = getattr(model, "init_caches", None)
    if init is not None:
        return init(B, total, quantized=fmt or False)
    return init_kv_cache(model.cfg, B, total, quantized=fmt,
                         device=model.device)


def _pick_greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)


def _prefill_and_loop(model, input_ids: torch.Tensor, caches,
                      max_new_tokens: int, eos_token_id: int | None,
                      next_token_fn: Callable) -> torch.Tensor:
    B, P = input_ids.shape
    dev = input_ids.device
    positions = torch.arange(P, device=dev)[None, :].expand(B, P)
    logits, caches = model(input_ids, positions, caches, 0)
    tok = next_token_fn(logits[:, -1])
    out = torch.zeros((B, max_new_tokens), dtype=torch.int32, device=dev)
    out[:, 0] = tok[:, 0]
    finished = (tok[:, 0] == eos_token_id) if eos_token_id is not None \
        else torch.zeros((B,), dtype=torch.bool, device=dev)
    for i in range(1, max_new_tokens):
        if eos_token_id is not None and bool(finished.all()):
            break
        pos = P + i - 1
        logits, caches = model(tok, torch.full((B, 1), pos, device=dev),
                               caches, pos)
        nxt = next_token_fn(logits[:, -1])
        nxt = torch.where(finished[:, None], tok, nxt)
        out[:, i] = nxt[:, 0]
        if eos_token_id is not None:
            finished = finished | (nxt[:, 0] == eos_token_id)
        tok = nxt
    return torch.cat([input_ids.to(torch.int32), out], dim=1)


@torch.no_grad()
def greedy_search(model, input_ids, max_new_tokens: int = 32,
                  eos_token_id: int | None = None,
                  max_len: int | None = None) -> torch.Tensor:
    """Greedy decoding. ``input_ids`` [B, P] (moved to the model's device);
    returns [B, P + max_new_tokens] int32, zeros after an early EOS stop."""
    ids = torch.as_tensor(input_ids, device=model.device)
    B, P = ids.shape
    total = P + max_new_tokens if max_len is None else max_len
    if total < P + max_new_tokens - 1:
        raise ValueError(f"max_len={total} cannot hold {P} prompt tokens "
                         f"and {max_new_tokens} new ones")
    caches = alloc_caches(model, B, total)
    return _prefill_and_loop(model, ids, caches, max_new_tokens,
                             eos_token_id, _pick_greedy)


def generate(model, input_ids, do_sample: bool = False, num_beams: int = 1,
             **kwargs) -> torch.Tensor:
    """HF-style dispatcher; the port serves greedy decoding."""
    if num_beams > 1:
        raise NotImplementedError(
            "beam search waits for the port of "
            "neural_compressor_tpu.generation.generate.beam_search")
    if do_sample:
        raise NotImplementedError(
            "sampling waits for the port of "
            "neural_compressor_tpu.generation.generate.sample")
    for k in ("temperature", "top_k", "top_p", "seed"):
        kwargs.pop(k, None)
    return greedy_search(model, input_ids, **kwargs)
