"""Continuous-batching serving engine for (quantized) causal LMs: the
greedy core.

The counterpart of ``neural_compressor_tpu.serving.engine``. A fixed pool
of decode slots shares one decode step; requests prefill into a free slot
on arrival and retire independently at EOS or their limit, so the batch
stays full without a global barrier. Per request: ``max_new_tokens``,
extra ``stop_token_ids`` (kept in the output, like EOS), multi-token
``stop_sequences`` (matched on the host and trimmed), a ``stream``
callback per decided token, the raw-distribution logprob of each token,
and ``cancel``.

Two pool modes, as in the JAX engine, each in the model's KV format (bf16,
or int8, fp8-e4m3 or int4 codes when the model is flagged
``kv_cache_quantized`` with a ``kv_cache_format``, as
``KVCacheQuantConfig`` flags it):
  * contiguous (``paged=False``): one KV cache [n_slots, Hkv, max_len, D]
    per layer (a ``QuantKVCache`` when quantized); decode runs the batched
    attention kernel (K7, its quantized branch for int8/fp8, their rows
    written by K12; int4 caches attend on their codes in plain PyTorch)
    with per-slot positions (one slot over int8/fp8 codes takes K6, as
    JAX's B=1 decode does);
  * paged (``paged=True``): a shared page pool plus per-slot block tables;
    decode writes each row with K12 and attends with K11. Prefill streams
    through ``prefill_streams`` contiguous bf16 staging rows, copied
    (quantized, for a quantized pool) into pages when a prompt completes;
    requests are admitted only when the pool can hold them, and pool
    pressure preempts the latest-arrived slot, which later re-prefills
    prompt + generated and continues exactly.

Every iteration runs at most one dispatch: a batched prefill chunk over
every prefilling slot, ``chunk`` decode steps over all slots, or both
("combined"). Idle and finished slots decode garbage that is ignored, and
park their cache writes on the last row (contiguous) or the trash page 0
(paged). PyTorch runs eagerly, so a dispatch is a Python function over the
model instead of a jitted program; each dispatch reads its results back to
the host once. The ``stats`` counters mean what the JAX engine's mean, so
both engines count the same dispatches for the same submissions.

The JAX engine's ``_s4_prepare`` re-lays int4 weights for the TPU inside
each program; the port's weights are in their serving layout already, so it
has no counterpart. Sampling (and with it the rejection-sampled verify of
speculative rounds), the prefix cache and top-N logprobs raise
``NotImplementedError`` naming what they wait for.

DeepSeek (``models.deepseek``): the engine allocates through the model's
``init_caches``, so contiguous mode serves the expanded MLA caches (K
``qk_head_dim``, V ``v_head_dim`` wide) and, after
``enable_mla_latent_cache``, the latent caches in every format; paged mode
needs the latent cache and serves it from a bf16 latent pool
(``init_paged_latent_pool``), each decode row written by K14's write and
attended by K14's attention, the prefill staged in bf16 latent rows and
copied into pages as they are.

Greedy speculative serving (``speculative="ngram"``, as in the JAX
engine): each decode dispatch runs ``chunk`` verify rounds over all slots;
a round proposes ``spec_k`` tokens a slot from the most recent
``spec_n``-gram match in its prompt + generated tokens (the
continuous-batching twin of ``generation.ngram_speculative_greedy_search``)
and verifies them in one (spec_k+1)-token window forward at per-slot
positions: over contiguous caches the window's rows are written in place
and attended under the position mask, over page pools K13 writes them and
K11's W-query window attends them. Finished and idle slots park their
window above ``max_len`` (the caches keep ``max_len + spec_k + 2`` rows; a
paged slot's window past its table goes to the trash page).
``spec_adaptive`` falls back to plain decode for 8 dispatches whenever the
EWMA of tokens a round drops below ``spec_min_rate``. A contiguous engine
runs a prefill chunk and the rounds in one dispatch, a paged one in two,
as the JAX engine does.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable

import numpy as np
import torch

from ..common import logger
from ..generation.speculative import (accepted_count, ngram_propose,
                                      write_window)
from ..models.llama import (_kv_pack_page_int4, _kv_quant,
                            _kv_quant4_asym_codes, init_kv_cache,
                            init_paged_pool, model_kv_format)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # [P] int32
    max_new_tokens: int = 64
    # stopping: extra per-request stop TOKENS (kept in the output, like
    # EOS) and multi-token stop SEQUENCES (trimmed from the output)
    stop_token_ids: tuple = ()
    stop_sequences: tuple = ()
    # streaming: called as stream(req, token) per decided token
    stream: Callable | None = None
    # filled during serving
    generated: list = dataclasses.field(default_factory=list)
    # log P(token | prefix) under the model's raw distribution, per token
    logprobs: list = dataclasses.field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    prefill_pos: int = 0          # tokens already written to the cache
    preemptions: int = 0


def _chosen_logprob(logits: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """log P(nxt) under the raw model distribution [B] (float32)."""
    lgf = logits.to(torch.float32)
    lse = torch.logsumexp(lgf, dim=-1)
    chosen = torch.gather(lgf, 1, nxt[:, None].to(torch.int64))[:, 0]
    return chosen - lse


def _greedy_token(logits: torch.Tensor):
    """The greedy branch of the JAX engine's ``_next_token_fn``: argmax
    (first index on ties, as ``jnp.argmax``) and its raw logprob."""
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    return nxt, _chosen_logprob(logits, nxt)


@torch.no_grad()
def _spec_rounds(model, caches, buf, pos, lim, active, rounds: int, kk: int,
                 nn: int, eos: int | None, park: int):
    """``rounds`` greedy prompt-lookup verify rounds over all slots (the
    greedy branch of the JAX engine's ``_spec_rounds``): ``buf`` [B, L]
    int32 each slot's tokens, ``pos`` [B] its decided count, ``lim`` [B]
    its limit, ``active`` [B] bool; slots that are inactive or at their
    limit park their window at ``park``. ``buf`` is updated in place.
    Returns (outs [B, rounds, kk+1] int32: each round's argmax window,
    ms [B, rounds]: the tokens each round emits) on the device."""
    W = kk + 1
    B, L = buf.shape
    dev = buf.device
    ar = torch.arange(W, device=dev)
    pos = pos.to(torch.int64)
    lim = lim.to(torch.int64)
    outs = torch.zeros((B, rounds, W), dtype=torch.int32, device=dev)
    ms = torch.zeros((B, rounds), dtype=torch.int64, device=dev)
    for i in range(rounds):
        fin = ~active | (pos >= lim)
        posx = torch.where(fin, torch.full_like(pos, park), pos)
        b = posx - 1
        cur = torch.gather(buf, 1, b[:, None])
        prop = ngram_propose(buf, posx, cur, kk, nn)
        window = torch.cat([cur, prop], dim=1)
        lg, caches = model(window, b[:, None] + ar[None, :], caches, b)
        t = torch.argmax(lg, dim=-1).to(torch.int32)
        m, _has_eos = accepted_count(prop, t, eos)
        m = torch.where(fin, torch.zeros_like(m), torch.minimum(m, lim - pos))
        write_window(buf, t, posx, ~fin)
        outs[:, i] = t
        ms[:, i] = m
        pos = pos + m
    return outs, ms


def _readback(*tensors: torch.Tensor) -> list[np.ndarray]:
    """One device-to-host copy for several int32/float32 tensors: their
    32-bit words go back in one buffer and are split on the host."""
    flat = [t.reshape(-1).view(torch.int32) if t.dtype == torch.float32
            else t.reshape(-1).to(torch.int32) for t in tensors]
    host = torch.cat(flat).cpu().numpy()
    out, i = [], 0
    for t in tensors:
        n = t.numel()
        a = host[i:i + n].reshape(tuple(t.shape))
        out.append(a.view(np.float32) if t.dtype == torch.float32 else a)
        i += n
    return out


class ContinuousBatchingEngine:
    """``paged=True`` swaps the per-slot contiguous caches for a shared
    page pool and block tables (kernels/paged_attention): slots own only
    the pages their length needs, so ``n_pages`` can be sized well below
    ``n_slots * max_len / page_size``. Prefill streams through
    ``prefill_streams`` contiguous staging rows (copied into pages on
    completion). The engine runs on the model's device."""

    def __init__(self, model, n_slots: int = 8, max_len: int = 1024,
                 eos_token_id: int | None = None,
                 prefill_chunk: int = 256, paged: bool = False,
                 n_pages: int | None = None, page_size: int = 128,
                 prefill_streams: int = 2, speculative: str | None = None,
                 spec_k: int = 8, spec_n: int = 2,
                 spec_adaptive: bool = False, spec_min_rate: float = 1.3,
                 prefix_cache: bool = False, logprobs_topk: int = 0):
        if speculative not in (None, "ngram"):
            raise ValueError(f"speculative={speculative!r}: only 'ngram'")
        self.speculative = speculative
        self.spec_k = int(spec_k)
        self.spec_n = int(spec_n)
        # adaptive speculation: below spec_min_rate tokens a round (EWMA
        # over spec dispatches), serve 8 dispatches by plain decode, then
        # probe again
        self.spec_adaptive = bool(spec_adaptive)
        self.spec_min_rate = float(spec_min_rate)
        self._spec_ewma: float | None = None
        self._spec_cool = 0
        if prefix_cache:
            raise NotImplementedError(
                "prefix caching waits for the port of "
                "neural_compressor_tpu.serving.prefix_cache.PagePrefixCache")
        if logprobs_topk:
            raise NotImplementedError(
                "top-N logprobs wait for the port of "
                "neural_compressor_tpu.serving.engine._top_n_logprobs")
        # models may own their cache shapes (DeepSeek's MLA: asymmetric K/V
        # widths, or latent rows): the engine allocates through the model's
        # init_caches where it has one, as JAX's engine does
        self._model_caches = getattr(model, "init_caches", None)
        self.latent = bool(getattr(model, "use_latent_cache", False))
        if speculative and self._model_caches is not None:
            if paged and self.latent:
                raise ValueError("speculative serving has no paged MLA "
                                 "latent support")
            raise NotImplementedError(
                "speculative serving of a model with its own caches "
                "(DeepSeek's MLA) waits for the port of neural_compressor_"
                "tpu.serving.engine._spec_rounds over init_caches")
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_token_id = eos_token_id
        # chunk starts step by the chunk size from 0: a chunk that would
        # cross max_len gets its start CLAMPED (_update_rows), silently
        # shifting rows — round down to a divisor of max_len
        c = min(prefill_chunk, max_len)
        while max_len % c:
            c -= 1
        if c != prefill_chunk:
            logger.info("prefill_chunk %d -> %d (must divide max_len %d)",
                        prefill_chunk, c, max_len)
        self.prefill_chunk = c
        quantized = model_kv_format(model)
        self.kv_cache_format = quantized or "bf16"
        if self.latent:  # a paged latent pool holds bf16 rows
            self.kv_cache_format = "latent_" + (
                "bf16" if paged else self.kv_cache_format)
        self.paged = paged
        # speculative mode writes verify windows up to spec_k rows past the
        # last decided position, and parks idle slots on a window above
        # max_len: the caches keep the margin
        self._cache_rows = max_len + self.spec_k + 2 if speculative \
            else max_len
        if paged:
            assert max_len % page_size == 0
            self.page_size = page_size
            self.pmax = max_len // page_size
            # page 0 is the trash page (idle slots park their writes there)
            self.n_pages = n_pages or (n_slots * self.pmax // 2 + 1)
            if self.latent:
                from ..models.deepseek import init_paged_latent_pool

                self.pools = init_paged_latent_pool(
                    self.cfg, self.n_pages, n_slots, max_len,
                    page_size=page_size, device=self.device)
            elif self._model_caches is not None:
                raise ValueError("paged DeepSeek serving needs the latent "
                                 "cache (enable_mla_latent_cache)")
            else:
                self.pools = init_paged_pool(
                    self.cfg, self.n_pages, n_slots, max_len,
                    page_size=page_size, quantized=quantized,
                    device=self.device)
            self.block_tables = np.zeros((n_slots, self.pmax), np.int32)
            # device copy of the block tables, re-uploaded only when the
            # host table changes
            self._bt_dev = None
            self._bt_dirty = True
            self.free_pages = list(range(self.n_pages - 1, 0, -1))
            self.slot_pages: list[list[int]] = [[] for _ in range(n_slots)]
            self.prefill_streams = max(1, min(prefill_streams, n_slots))
            # bf16 staging rows (latent rows for a latent pool)
            self.staging = (
                self._model_caches(self.prefill_streams, max_len)
                if self._model_caches is not None else
                init_kv_cache(self.cfg, self.prefill_streams, max_len,
                              device=self.device))
            self._free_staging = list(range(self.prefill_streams - 1, -1, -1))
            self._staging_of: dict[int, int] = {}  # slot -> staging row
        else:
            self.caches = (
                self._model_caches(n_slots, self._cache_rows,
                                   quantized=quantized or False)
                if self._model_caches is not None else
                init_kv_cache(self.cfg, n_slots, self._cache_rows,
                              quantized=quantized, device=self.device))
            self.prefill_streams = n_slots
        self._uid = itertools.count()
        # slot bookkeeping (host side)
        self.slot_req: list[Request | None] = [None] * n_slots
        self.slot_state = ["idle"] * n_slots  # idle | prefill | decode
        self.slot_pos = np.zeros((n_slots,), np.int32)   # next write index
        self.slot_tok = np.zeros((n_slots,), np.int32)   # last token
        self.queue: list[Request] = []
        # observability counters (metrics()), the JAX engine's keys; the
        # prefix one stays 0 here
        self.stats = {"wall_s": 0.0, "requests": 0, "prompt_tokens": 0,
                      "generated_tokens": 0, "prefill_chunk_dispatches": 0,
                      "decode_dispatches": 0, "combined_dispatches": 0,
                      "preemptions": 0, "spec_rounds": 0,
                      "spec_accepted": 0, "prefix_hit_tokens": 0,
                      "spec_suppressed_dispatches": 0}

    # ------------------------------------------------------------------ api
    def submit(self, prompt_ids, max_new_tokens: int = 64,
               do_sample: bool = False, stop_token_ids=(), stop_sequences=(),
               stream: Callable | None = None,
               top_logprobs: int = 0) -> Request:
        """Queue a greedy request. ``stop_token_ids`` are additional
        per-request EOS-like tokens (kept in the output); ``stop_sequences``
        are token-id tuples trimmed from the output on match;
        ``stream(req, tok)`` fires per decided token. The JAX engine's
        sampling knobs (``temperature``, ``top_k``, ``top_p``, ``seed``)
        come with sampling."""
        if do_sample and self.speculative:
            raise NotImplementedError(
                "sampled requests under speculation wait for the port of "
                "the rejection-sampled verify of neural_compressor_tpu."
                "serving.engine._spec_rounds and of _sample_step")
        if do_sample:
            raise NotImplementedError(
                "sampled requests wait for the port of "
                "neural_compressor_tpu.serving.engine._sample_step")
        prompt = np.asarray(prompt_ids, np.int32)
        assert prompt.ndim == 1, "submit() takes a single unbatched prompt"
        if top_logprobs > 0:
            raise ValueError(
                f"top_logprobs={top_logprobs} exceeds the engine's "
                "logprobs_topk=0")
        assert len(prompt) + max_new_tokens <= self.max_len, (
            f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds max_len ({self.max_len})")
        req = Request(next(self._uid), prompt, max_new_tokens,
                      stop_token_ids=tuple(int(t) for t in stop_token_ids),
                      stop_sequences=tuple(
                          tuple(int(t) for t in s) for s in stop_sequences),
                      stream=stream)
        self.queue.append(req)
        self.stats["requests"] += 1
        self.stats["prompt_tokens"] += len(prompt)
        return req

    def run(self, max_steps: int = 10_000,
            chunk: int = 8) -> list[Request]:
        """Serve until queue and slots drain. ``chunk`` decode steps run
        per dispatch (slots that hit EOS/stop mid-chunk are truncated on
        the host). Returns finished requests."""
        t0 = time.time()
        finished = []
        for _ in range(max_steps):
            self._fill_slots()
            if all(s == "idle" for s in self.slot_state) and not self.queue:
                break
            if self.paged:
                # allocate this iteration's decode pages up front —
                # preemption (not RuntimeError) resolves pool pressure,
                # and it must happen BEFORE the decode set is captured
                for slot in range(self.n_slots):
                    if self.slot_state[slot] == "decode":
                        self._ensure_pages(
                            slot, min(int(self.slot_pos[slot]) + chunk,
                                      self.max_len - 1))
            decoding = [s for s in range(self.n_slots)
                        if self.slot_state[s] == "decode"]
            if decoding and self.speculative and self._spec_cool > 0:
                # adaptive cooldown: recent acceptance too low, so this
                # iteration serves through the plain decode path
                self._spec_cool -= 1
                self.stats["spec_suppressed_dispatches"] += 1
                self._advance_prefill()
                self.step_many(chunk)
                finished.extend(self._collect())
                continue
            if decoding and self.speculative:
                # a prefill chunk and the verify rounds in ONE dispatch
                # when both kinds of work exist (contiguous; a paged engine
                # runs them as two, as the JAX engine does)
                rounds = max(int(chunk), 1)
                work = self._gather_prefill()
                if work is None:
                    self._spec_step(rounds)
                elif self.paged:
                    self._advance_prefill(work)
                    self._spec_step(rounds)
                else:
                    active, args, ends = work
                    self.stats["combined_dispatches"] += 1
                    self.stats["prefill_chunk_dispatches"] += 1
                    self.stats["decode_dispatches"] += 1
                    dec, spec_args = self._spec_args()
                    nxt, _lp = self._prefill_forward(self.caches, *args)
                    outs, ms = _spec_rounds(
                        self.model, self.caches, *spec_args, rounds,
                        self.spec_k, self.spec_n, self.eos_token_id,
                        self.max_len)
                    outs, ms, nxt = _readback(outs, ms, nxt)
                    self._apply_spec(dec, outs, ms, rounds)
                    # the combined program emits the prefill's argmax
                    # without its logprob, as the JAX engine's
                    self._apply_prefill(active, ends, nxt)
                finished.extend(self._collect())
                continue
            if decoding:
                # prefill chunk + k decode steps in ONE dispatch. Paged
                # mode too: prefill writes the staging rows while decode
                # writes the page pools — disjoint buffers
                work = self._gather_prefill()
                if work is None:
                    self.step_many(chunk)
                else:
                    active, args, ends = work
                    # combined iterations also count toward the prefill/
                    # decode splits (they subsume one of each)
                    self.stats["combined_dispatches"] += 1
                    self.stats["prefill_chunk_dispatches"] += 1
                    self.stats["decode_dispatches"] += 1
                    nxt, plp = self._prefill_forward(
                        self.staging if self.paged else self.caches, *args)
                    out, lps = self._decode_forward(chunk)
                    out, lps, nxt, plp = _readback(out, lps, nxt, plp)
                    self._apply_decode(out, decoding, chunk, lps)
                    self._apply_prefill(active, ends, nxt, plp)
            else:
                self._advance_prefill()
            finished.extend(self._collect())
        self.stats["wall_s"] += time.time() - t0
        return finished

    def cancel(self, req: Request) -> None:
        """Abort a request: queued requests leave the queue immediately;
        running ones stop at the next host sync (their slot, pages, and
        staging row are reclaimed by the serve loop)."""
        req.cancelled = True
        req.done = True
        if req in self.queue:
            self.queue.remove(req)

    def metrics(self) -> dict:
        """Cumulative prompt/generated token counts (in-flight requests
        included), request count, dispatch split, preemptions, and
        end-to-end generated tokens per second over ``run()`` wall time.
        A combined prefill+decode iteration increments
        ``combined_dispatches`` AND both split counters, so total
        dispatches = prefill + decode - combined."""
        s = dict(self.stats)
        s["generated_tok_s"] = (s["generated_tokens"] / s["wall_s"]
                                if s["wall_s"] > 0 else 0.0)
        s["kv_cache_format"] = self.kv_cache_format
        s["kv_cache_bytes"] = self.kv_cache_bytes()
        return s

    def kv_cache_bytes(self) -> int:
        """Bytes of the KV caches or page pools (codes, scales, offsets),
        block tables and staging rows excluded."""
        held = self.pools if self.paged else self.caches
        return sum(t.numel() * t.element_size() for c in held for t in c
                   if t is not None and t is not getattr(c, "block_tables",
                                                         None))

    # ------------------------------------------------------------- internals
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @torch.no_grad()
    def _prefill_forward(self, target, ids, rows, starts, last_idx):
        """One chunk over ``n`` rows of ``target`` (the contiguous caches or
        the staging rows): gather the rows' caches, run the chunk for all of
        them, scatter back; returns the completion token and its logprob
        per row (device tensors)."""
        C = self.prefill_chunk
        n = ids.shape[0]
        positions = starts[:, None] + torch.arange(C, device=self.device,
                                                   dtype=starts.dtype)
        ridx = rows.to(torch.int64)
        sub = [type(c)(*(None if t is None else t[ridx] for t in c))
               for c in target]
        logits, sub = self.model(ids, positions=positions, caches=sub,
                                 cache_pos=starts)
        for c, s in zip(target, sub):
            for t, ts in zip(c, s):
                if t is not None:
                    t[ridx] = ts
        last = logits[torch.arange(n, device=self.device),
                      last_idx.to(torch.int64)]
        return _greedy_token(last)

    @torch.no_grad()
    def _decode_forward(self, k: int):
        """``k`` greedy decode steps for every slot over the caches or the
        page pools; returns tokens and logprobs [n_slots, k] (device)."""
        toks = self._tensor(self.slot_tok)
        pos = self._tensor(self._decode_positions())
        if self.paged:
            bt = self._bt_device()
            caches = [p._replace(block_tables=bt) for p in self.pools]
        else:
            caches = self.caches
        B = self.n_slots
        out = torch.empty((B, k), dtype=torch.int32, device=self.device)
        lps = torch.empty((B, k), dtype=torch.float32, device=self.device)
        for i in range(k):
            logits, caches = self.model(toks[:, None],
                                        positions=pos[:, None],
                                        caches=caches, cache_pos=pos)
            toks, lp = _greedy_token(logits[:, 0])
            out[:, i] = toks
            lps[:, i] = lp
            pos = pos + 1
        return out, lps

    @staticmethod
    def _prompt_of(req: Request) -> np.ndarray:
        """The token stream a (re-)prefill must write: the prompt plus any
        tokens already generated before a preemption."""
        if req.generated:
            return np.concatenate(
                [req.prompt, np.asarray(req.generated, np.int32)])
        return req.prompt

    def _gather_prefill(self):
        """Collect this iteration's prefill work: (active [(slot, row)],
        padded device args, per-slot chunk ends) or None when no slot is
        prefilling. Paged mode binds each prefilling slot to one of
        ``prefill_streams`` staging rows for its duration."""
        active: list[tuple[int, int]] = []  # (slot, target row)
        for slot in range(self.n_slots):
            req = self.slot_req[slot]
            if req is None or self.slot_state[slot] != "prefill" \
                    or req.done:  # done = cancelled mid-prefill
                continue
            if self.paged:
                row = self._staging_of.get(slot)
                if row is None:
                    if not self._free_staging:
                        continue  # all streams busy — wait for one to free
                    row = self._free_staging.pop()
                    self._staging_of[slot] = row
                active.append((slot, row))
            else:
                active.append((slot, slot))
        if not active:
            return None
        C = self.prefill_chunk
        S = len(active)
        # rows padded to a power of two as the JAX engine pads them, so
        # both run their projections at the same M
        Sp = 1 << (S - 1).bit_length()
        ids = np.zeros((Sp, C), np.int32)
        rows = np.zeros((Sp,), np.int32)
        starts = np.zeros((Sp,), np.int32)
        last = np.zeros((Sp,), np.int32)
        ends = []
        for i, (slot, row) in enumerate(active):
            req = self.slot_req[slot]
            src = self._prompt_of(req)
            start = req.prefill_pos
            end = min(start + C, len(src))
            ids[i, : end - start] = src[start:end]
            rows[i], starts[i], last[i] = row, start, end - start - 1
            ends.append(end)
        for i in range(S, Sp):
            # pad with duplicates of row 0: the scatter re-writes the same
            # data to the same row
            ids[i], rows[i], starts[i], last[i] = (ids[0], rows[0],
                                                   starts[0], last[0])
        args = tuple(self._tensor(a) for a in (ids, rows, starts, last))
        return active, args, ends

    def _advance_prefill(self, work=None):
        """Run ONE batched prefill chunk across every prefilling slot."""
        if work is None:
            work = self._gather_prefill()
        if work is None:
            return
        active, args, ends = work
        self.stats["prefill_chunk_dispatches"] += 1
        nxt, lp = self._prefill_forward(
            self.staging if self.paged else self.caches, *args)
        nxt, lp = _readback(nxt, lp)
        self._apply_prefill(active, ends, nxt, lp)

    def _apply_prefill(self, active, ends, nxt, lps=None):
        for i, (slot, row) in enumerate(active):
            req = self.slot_req[slot]
            if req.done:  # cancelled mid-prefill: freed by _collect
                continue
            req.prefill_pos = ends[i]
            src_len = len(self._prompt_of(req))
            if ends[i] < src_len:
                continue
            P = src_len
            if self.paged:
                self._commit_staging(slot, P, row)
                self._free_staging.append(self._staging_of.pop(slot))
            self.slot_state[slot] = "decode"
            self.slot_pos[slot] = P  # first decode step writes KV row P
            tok = int(nxt[i])
            self.slot_tok[slot] = tok
            self._append_token(req, slot, tok,
                               float(lps[i]) if lps is not None else None)
            logger.debug("slot %d prefilled request %d (P=%d)",
                         slot, req.uid, P)

    # -------------------------------------------------------- paged helpers
    def _alloc_page(self, slot: int, page_idx: int) -> bool:
        if not self.free_pages:
            return False
        pid = self.free_pages.pop()
        self.slot_pages[slot].append(pid)
        self.block_tables[slot, page_idx] = pid
        self._bt_dirty = True
        return True

    def _preempt_victim(self, protect: int | None) -> bool:
        """Free pool pressure by preempting the latest-arrived decoding
        slot: its pages are freed and the request is requeued at the FRONT
        to re-prefill prompt+generated on its next turn (greedy resumes
        exactly)."""
        victims = [s for s in range(self.n_slots)
                   if s != protect and self.slot_state[s] == "decode"
                   and self.slot_req[s] is not None]
        if not victims:
            return False
        victim = max(victims, key=lambda s: self.slot_req[s].uid)
        req = self.slot_req[victim]
        req.prefill_pos = 0
        req.preemptions += 1
        self.stats["preemptions"] += 1
        self.queue.insert(0, req)
        self.slot_req[victim] = None
        self.slot_state[victim] = "idle"
        logger.info("preempted slot %d (request %d, %d generated) to free "
                    "%d pages", victim, req.uid, len(req.generated),
                    len(self.slot_pages[victim]))
        self._free_slot_pages(victim)
        return True

    def _ensure_pages(self, slot: int, upto_pos: int) -> None:
        need = min(upto_pos // self.page_size + 1, self.pmax)
        while len(self.slot_pages[slot]) < need:
            if not self._alloc_page(slot, len(self.slot_pages[slot])):
                if not self._preempt_victim(protect=slot):
                    raise RuntimeError(
                        f"paged KV pool exhausted ({self.n_pages} pages) "
                        "with no preemptable slot — the pool cannot hold "
                        "even the remaining request; raise n_pages")

    def _free_slot_pages(self, slot: int) -> None:
        self.free_pages.extend(reversed(self.slot_pages[slot]))
        self.slot_pages[slot] = []
        self.block_tables[slot] = 0
        self._bt_dirty = True

    def _bt_device(self) -> torch.Tensor:
        if self._bt_dirty or self._bt_dev is None:
            self._bt_dev = self._tensor(self.block_tables)
            self._bt_dirty = False
        return self._bt_dev

    @torch.no_grad()
    def _stage_copy(self, row: int, pid: int, start: int) -> None:
        """Copy staging row ``row``'s bf16 rows [start, start + page) into
        pool page ``pid`` of every layer, quantized per (token, head) as
        the paged write quantizes them (JAX's ``_stage_copy_fn``): int8 and
        fp8 with ``_kv_quant``, int4 with ``_kv_quant4_asym_codes`` packed
        token-half-split."""
        page = self.page_size
        if self.latent:  # JAX's copy_latent: the latent rows as they are
            for pool, cache in zip(self.pools, self.staging):
                pool.lat_pages[pid] = cache.lat[row, :, start:start + page
                                                ].to(pool.lat_pages.dtype)
            return
        for pool, cache in zip(self.pools, self.staging):
            kr = cache.k[row, :, start:start + page]      # [Hkv, page, D]
            vr = cache.v[row, :, start:start + page]
            if pool.k_offs is not None:
                for src, pages, scales, offs in (
                        (kr, pool.k_pages, pool.k_scales, pool.k_offs),
                        (vr, pool.v_pages, pool.v_scales, pool.v_offs)):
                    c4, sc, off = _kv_quant4_asym_codes(src)
                    pages[pid] = _kv_pack_page_int4(c4)
                    scales[pid] = sc
                    offs[pid] = off
            elif pool.k_scales is not None:
                fmt = self.kv_cache_format
                for src, pages, scales in ((kr, pool.k_pages, pool.k_scales),
                                           (vr, pool.v_pages, pool.v_scales)):
                    c, sc = _kv_quant(src, fmt)
                    pages[pid] = c
                    scales[pid] = sc
            else:
                pool.k_pages[pid] = kr.to(pool.k_pages.dtype)
                pool.v_pages[pid] = vr.to(pool.v_pages.dtype)

    def _commit_staging(self, slot: int, length: int, row: int) -> None:
        """Allocate pages for a freshly-prefilled slot and copy its staged
        rows (staging row ``row``) into them; pool pressure preempts a
        decoding victim rather than raising."""
        n_pages = (length + self.page_size - 1) // self.page_size
        for p in range(n_pages):
            while not self._alloc_page(slot, p):
                if not self._preempt_victim(protect=slot):
                    raise RuntimeError(
                        f"paged KV pool exhausted ({self.n_pages} pages) "
                        "committing a prefilled prompt with no "
                        "preemptable slot; raise n_pages")
            self._stage_copy(row, self.slot_pages[slot][-1],
                             p * self.page_size)

    def _fill_slots(self):
        for slot in range(self.n_slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue[0]
            if self.paged:
                src = self._prompt_of(req)
                # admission control: only admit when the pool can hold
                # the (resumed) prompt plus one decode page; otherwise
                # wait for retirements instead of thrashing preemption
                need = len(src) // self.page_size + 2
                avail = len(self.free_pages)
                if avail < min(need, self.pmax):
                    if all(r is None for r in self.slot_req):
                        raise RuntimeError(
                            f"request {req.uid} needs ~{need} pages but "
                            f"the idle pool has {avail} "
                            f"free of {self.n_pages} — the pool cannot "
                            "hold this request at all; raise n_pages")
                    break
            self.queue.pop(0)
            self.slot_req[slot] = req
            self.slot_state[slot] = "prefill"
            req.prefill_pos = 0
            logger.debug("slot %d <- request %d (P=%d)", slot, req.uid,
                         len(req.prompt))

    def _decode_positions(self) -> np.ndarray:
        """Per-slot decode positions; non-decoding slots park their garbage
        cache write on the last row (never attended: the mask excludes it
        and requests terminate before reaching it)."""
        park = self._cache_rows - 1
        return np.where(
            np.asarray([s == "decode" for s in self.slot_state]),
            self.slot_pos, park).astype(np.int32)

    def step(self):
        """Single decode step (works in contiguous and paged modes)."""
        return self.step_many(1)

    def step_many(self, k: int = 8):
        """Decode ``k`` tokens for every active slot in one dispatch."""
        k = max(int(k), 1)
        if self.paged:
            # page allocation (and any preemption) BEFORE the decode set
            # and operand snapshot are taken
            for slot in range(self.n_slots):
                if self.slot_state[slot] == "decode":
                    self._ensure_pages(
                        slot, min(int(self.slot_pos[slot]) + k,
                                  self.max_len - 1))
        self.stats["decode_dispatches"] += 1
        dec = [s for s in range(self.n_slots)
               if self.slot_state[s] == "decode"]
        out, lps = _readback(*self._decode_forward(k))
        self._apply_decode(out, dec, k, lps)

    def _append_token(self, req: Request, slot: int, tok: int,
                      lp: float | None = None) -> None:
        """Append one decided token to ``req`` with the full stop
        treatment: counters, logprob, streaming callback, EOS /
        per-request stop tokens (kept in the output), multi-token stop
        sequences (trimmed from the output), max_new_tokens, and
        cache-capacity stop."""
        req.generated.append(tok)
        req.logprobs.append(lp if lp is not None else float("nan"))
        self.stats["generated_tokens"] += 1
        if req.stream is not None:
            req.stream(req, tok)
        if ((self.eos_token_id is not None and tok == self.eos_token_id)
                or tok in req.stop_token_ids):
            req.done = True
        for seq in req.stop_sequences:
            L = len(seq)
            if L and len(req.generated) >= L and \
                    tuple(req.generated[-L:]) == seq:
                del req.generated[-L:]
                del req.logprobs[-L:]
                self.stats["generated_tokens"] -= L
                req.done = True
                break
        if (len(req.generated) >= req.max_new_tokens
                or self.slot_pos[slot] >= self.max_len - 1):
            req.done = True

    # ------------------------------------------------------- speculation
    def _spec_args(self):
        """The decoding slots and the device operands of a speculative
        dispatch: (buf [n_slots, cache rows] each slot's tokens, pos its
        decided count, lim its limit, active)."""
        dec = [s for s in range(self.n_slots)
               if self.slot_state[s] == "decode"]
        buf = np.zeros((self.n_slots, self._cache_rows), np.int32)
        pos = np.ones((self.n_slots,), np.int32)  # parked slots: b = 0
        lim = np.zeros((self.n_slots,), np.int32)
        act = np.zeros((self.n_slots,), bool)
        for s_ in dec:
            req = self.slot_req[s_]
            toks = self._prompt_of(req)
            buf[s_, :len(toks)] = toks
            pos[s_] = len(toks)
            lim[s_] = min(len(req.prompt) + req.max_new_tokens,
                          self.max_len)
            act[s_] = True
        return dec, tuple(self._tensor(a) for a in (buf, pos, lim, act))

    def _apply_spec(self, dec, outs, ms, rounds: int) -> None:
        """Host bookkeeping for one speculative dispatch: each round's
        emitted tokens with the full stop treatment; ``spec_rounds`` and
        ``spec_accepted`` count only the rounds and tokens applied (a stop
        may cut the device's count); then the adaptive EWMA."""
        r0, a0 = self.stats["spec_rounds"], self.stats["spec_accepted"]
        for s_ in dec:
            req = self.slot_req[s_]
            if req is None:
                continue
            for r_ in range(rounds):
                if req.done:
                    break
                applied = 0
                for j in range(int(ms[s_, r_])):
                    if req.done:
                        break
                    self.slot_pos[s_] += 1
                    tok = int(outs[s_, r_, j])
                    self.slot_tok[s_] = tok
                    # verify rounds emit argmax tokens without logprobs
                    self._append_token(req, s_, tok, None)
                    applied += 1
                if applied > 0:
                    self.stats["spec_rounds"] += 1
                    self.stats["spec_accepted"] += applied
        if self.spec_adaptive:
            dr = self.stats["spec_rounds"] - r0
            da = self.stats["spec_accepted"] - a0
            if dr > 0:
                rate = da / dr
                self._spec_ewma = (rate if self._spec_ewma is None else
                                   0.6 * self._spec_ewma + 0.4 * rate)
                if self._spec_ewma < self.spec_min_rate:
                    self._spec_cool = 8  # plain-decode dispatches before
                    #                      the next speculation probe

    def _spec_ensure_pages(self, rounds: int) -> None:
        """Worst-case page allocation for a spec dispatch: every round
        can advance a slot by spec_k+1 tokens and the verify window writes
        spec_k rows past the last decided one."""
        W = self.spec_k + 1
        for slot in range(self.n_slots):
            if self.slot_state[slot] == "decode":
                decided = len(self._prompt_of(self.slot_req[slot]))
                self._ensure_pages(slot, min(decided + rounds * W
                                             + self.spec_k,
                                             self.max_len - 1))

    @torch.no_grad()
    def _spec_step(self, rounds: int) -> None:
        """One speculative decode dispatch: ``rounds`` verify rounds for
        every decoding slot (1..spec_k+1 tokens each a round), one
        readback."""
        if self.paged:
            self._spec_ensure_pages(rounds)
        self.stats["decode_dispatches"] += 1
        dec, spec_args = self._spec_args()
        if not dec:
            return
        if self.paged:
            bt = self._bt_device()
            caches = [p._replace(block_tables=bt) for p in self.pools]
        else:
            caches = self.caches
        outs, ms = _readback(*_spec_rounds(
            self.model, caches, *spec_args, rounds, self.spec_k, self.spec_n,
            self.eos_token_id, self.max_len))
        self._apply_spec(dec, outs, ms, rounds)

    def _apply_decode(self, out, dec_slots, k: int, lps=None):
        """Host bookkeeping for one [n_slots, k] decode result, applied
        only to ``dec_slots`` (the slots that were decoding when the
        dispatch was issued — state may have moved since)."""
        for slot in dec_slots:
            req = self.slot_req[slot]
            if req is None:
                continue
            for j in range(k):
                if req.done:
                    break
                self.slot_pos[slot] += 1
                tok = int(out[slot, j])
                self.slot_tok[slot] = tok
                self._append_token(
                    req, slot, tok,
                    float(lps[slot, j]) if lps is not None else None)

    def _collect(self):
        done = []
        for slot, req in enumerate(self.slot_req):
            if req is not None and req.done:
                done.append(req)
                self.slot_req[slot] = None
                self.slot_state[slot] = "idle"
                if self.paged:
                    self._free_slot_pages(slot)
                    row = self._staging_of.pop(slot, None)
                    if row is not None:  # cancelled mid-prefill
                        self._free_staging.append(row)
        return done
