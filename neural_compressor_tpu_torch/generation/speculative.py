"""Speculative greedy decoding: draft-verify with a second model, and
prompt lookup (n-gram proposals, no draft).

The counterpart of ``neural_compressor_tpu.generation.speculative``. Each
round proposes ``k`` tokens, the target verifies them in ONE forward over
a (k+1)-token window at per-row positions, and the longest prefix that
matches the target's own argmax is accepted together with the target's
token after it: 1..k+1 tokens a round. Rows rejected in a round leave
stale KV rows, which the next round's window rewrites before any query can
attend them (the position mask only exposes ``key_pos <= query_pos``).

The JAX package runs the rounds as one jitted ``lax.while_loop``. PyTorch
runs eagerly, so the loop is plain Python over device tensors: its
condition (any row still decoding) is read back to the host once a round,
and nothing else is. On a served model the verify window and a decode step
run different code (the window's projections at M = k+1, its attention
over the contiguous cache or the page pool's window kernel), so greedy
speculation equals ``greedy_search`` up to ties of the argmax; it equals
the JAX package's speculation, the same algorithm on the same weights.
"""

from __future__ import annotations

import torch

from ..models.llama import init_kv_cache, model_kv_format


def _caches(model, B: int, total: int):
    if hasattr(model, "init_caches"):
        raise NotImplementedError(
            "speculation over a model with its own caches (DeepSeek's MLA) "
            "waits for the port of neural_compressor_tpu.generation."
            "speculative with generate._alloc_caches")
    return init_kv_cache(model.cfg, B, total,
                         quantized=model_kv_format(model),
                         device=model.device)


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    # the first index on ties, as jnp.argmax
    return torch.argmax(logits, dim=-1).to(torch.int32)


def accepted_count(prop: torch.Tensor, t: torch.Tensor, eos: int | None):
    """Tokens a verify round emits per row: the longest prefix of the
    proposals ``prop`` [B, k] equal to the target's argmax ``t`` [B, k+1],
    plus one; cut after the first EOS among them. Returns (m [B] int64,
    has_eos [B] bool)."""
    kk = prop.shape[1]
    match = (prop == t[:, :kk]).to(torch.int32)
    m = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int64) + 1
    if eos is None:
        return m, torch.zeros_like(m, dtype=torch.bool)
    is_eos = t == eos
    eos_idx = torch.argmax(is_eos.to(torch.int32), dim=1)
    has_eos = is_eos.any(dim=1) & (eos_idx < m)
    return torch.where(has_eos, eos_idx + 1, m), has_eos


def ngram_propose(buf: torch.Tensor, pos: torch.Tensor, cur: torch.Tensor,
                  kk: int, nn: int) -> torch.Tensor:
    """Prompt-lookup proposals: for each row, the ``kk`` tokens that
    followed the most recent earlier occurrence of its last ``nn`` decided
    tokens in ``buf`` [B, L] (decided tokens before ``pos`` [B]); no match
    repeats the current token ``cur`` [B, 1]. Returns [B, kk] int32."""
    B, L = buf.shape
    dev = buf.device
    pos = pos.to(torch.int64)
    sidx = pos[:, None] - nn + torch.arange(nn, device=dev)[None, :]
    suffix = torch.gather(buf, 1, sidx.clamp(0, L - 1))
    nwin = L - nn + 1
    eq = torch.ones((B, nwin), dtype=torch.bool, device=dev)
    for i in range(nn):
        eq &= buf[:, i:i + nwin] == suffix[:, i:i + 1]
    jidx = torch.arange(nwin, device=dev)[None, :]
    # the continuation must start inside the decided context, and the
    # trivial match (the suffix itself) is out
    valid = eq & (jidx + nn < pos[:, None])
    j = torch.where(valid, jidx, torch.full_like(jidx, -1)).amax(dim=1)
    gidx = (j + nn)[:, None] + torch.arange(kk, device=dev)[None, :]
    prop = torch.gather(buf, 1, gidx.clamp(0, L - 1))
    return torch.where((j >= 0)[:, None], prop,
                       cur.expand(B, kk)).to(torch.int32)


def write_window(dst: torch.Tensor, rows: torch.Tensor, start: torch.Tensor,
                live: torch.Tensor) -> None:
    """``dst[b, start[b]:start[b] + W] = rows[b]`` for the live rows, in
    place (finished rows keep their content, as JAX writes it back)."""
    W = rows.shape[1]
    st = start.to(torch.int64).clamp(0, dst.shape[1] - W)
    idx = st[:, None] + torch.arange(W, device=dst.device)[None, :]
    old = torch.gather(dst, 1, idx)
    dst.scatter_(1, idx, torch.where(live[:, None], rows, old))


def _tail(input_ids, out, decided, mnt: int, eos: int | None):
    """``greedy_search``'s tail semantics: a row that hit EOS repeats it
    while any other row still decodes, and everything past the step the
    whole batch stopped at stays zero."""
    B, width = out.shape
    idx = torch.arange(width, device=out.device)[None, :]
    maxc = torch.clamp(decided.max(), max=mnt)
    if eos is not None:
        lastpos = (decided - 1).clamp(min=0)
        last = torch.gather(out, 1, lastpos[:, None])[:, 0]
        pad = torch.where((last == eos)[:, None] & (idx < maxc),
                          torch.full_like(out, eos), torch.zeros_like(out))
    else:
        pad = torch.zeros_like(out)
    out = torch.where(idx < decided[:, None], out, pad)[:, :mnt]
    return torch.cat([input_ids.to(torch.int32), out], dim=1)


def _stats(rounds: int, accepted: torch.Tensor, hist: torch.Tensor,
           B: int) -> dict:
    return {"rounds": rounds,
            "tokens_per_round": float(accepted) / max(rounds, 1) / B,
            # accept_hist[m] = row-rounds in which a row emitted m tokens
            # (m = accepted prefix + 1 correction; 0 = a finished row)
            "accept_hist": hist.tolist()}


def _margin(P: int, max_new_tokens: int, k: int, max_len: int | None) -> int:
    need = P + max_new_tokens + k + 1
    if max_len is not None and max_len < need:
        # the verify window writes up to k rows past the last decided
        # position; a shorter cache would clamp the write onto live rows
        raise ValueError(
            f"max_len={max_len} too small for speculative decoding: need "
            f"prompt + max_new_tokens + k + 1 = {need} rows of KV margin")
    return max_len or need


class _Round:
    """The per-row state of a speculative loop on the device: decided
    count ``pos``, current token ``cur``, finished flags, and the
    statistics; ``step`` applies one verify round."""

    def __init__(self, input_ids, mnt: int, kk: int):
        B, P = input_ids.shape
        dev = input_ids.device
        self.P, self.mnt, self.kk = P, mnt, kk
        self.pos = torch.full((B,), P, dtype=torch.int64, device=dev)
        self.cur = input_ids[:, -1:].to(torch.int32)
        self.fin = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.rounds = 0
        self.accepted = torch.zeros((), dtype=torch.int64, device=dev)
        self.hist = torch.zeros((kk + 2,), dtype=torch.int64, device=dev)

    def running(self) -> bool:
        # the loop condition: one host readback a round
        return bool((~self.fin & (self.pos - self.P < self.mnt)).any()) \
            and self.rounds < self.mnt + 1

    def step(self, prop, t, eos):
        """Account one round's emitted tokens (``t`` [B, W] the target's
        argmax); returns the live mask the caller writes ``t`` under."""
        m, has_eos = accepted_count(prop, t, eos)
        fin = self.fin
        m = torch.where(fin, torch.zeros_like(m), m)
        cur = torch.gather(t, 1, (m - 1).clamp(min=0)[:, None])
        self.cur = torch.where(fin[:, None], self.cur, cur)
        self.accepted += m.sum()
        # a scatter, not bincount: bincount reads its size back to the host
        self.hist.scatter_add_(0, m, torch.ones_like(m))
        self.pos = self.pos + m
        self.fin = fin | has_eos | (self.pos - self.P >= self.mnt)
        self.rounds += 1
        return ~fin


@torch.no_grad()
def speculative_greedy_search(target, draft, input_ids,
                              max_new_tokens: int = 32, k: int = 4,
                              eos_token_id: int | None = None,
                              max_len: int | None = None,
                              return_stats: bool = False):
    """Greedy decode ``target`` with ``draft`` speculation.

    ``draft`` is a cheaper model over the same vocabulary; it proposes
    ``k`` tokens a round in k+1 single-token steps (per-row position
    tensors: the batched attention kernel K7 at every B), and ``target``
    verifies them in one (k+1)-token window. ``input_ids`` [B, P]; returns
    [B, P + max_new_tokens] int32 (and, with ``return_stats``, ``{"rounds",
    "tokens_per_round", "accept_hist"}``). ``max_len`` must leave
    ``P + max_new_tokens + k + 1`` cache rows."""
    ids = torch.as_tensor(input_ids, device=target.device)
    B, P = ids.shape
    mnt, W = max_new_tokens, k + 1
    total = _margin(P, mnt, k, max_len)
    tcaches, dcaches = _caches(target, B, total), _caches(draft, B, total)
    dev = ids.device
    prompt_pos = torch.arange(P, device=dev)[None, :].expand(B, P)
    _, tcaches = target(ids, prompt_pos, tcaches, 0)
    _, dcaches = draft(ids, prompt_pos, dcaches, 0)
    out = torch.zeros((B, mnt + W), dtype=torch.int32, device=dev)
    st = _Round(ids, mnt, k)
    ar = torch.arange(W, device=dev)
    while st.running():
        b = st.pos - 1                      # window start: the last decided
        # draft k+1 micro-steps: propose d1..dk, fill its rows b..b+k
        tok, win = st.cur, [st.cur]
        for j in range(W):
            lg, dcaches = draft(tok, (b + j)[:, None], dcaches, b + j)
            tok = _argmax(lg[:, -1])[:, None]
            win.append(tok)
        window = torch.cat(win[:W], dim=1)          # [cur, d1..dk]
        drafted = torch.cat(win[1:W], dim=1)        # [d1..dk]
        lg, tcaches = target(window, b[:, None] + ar[None, :], tcaches, b)
        t = _argmax(lg)                              # [B, W]
        live = st.step(drafted, t, eos_token_id)
        write_window(out, t, b + 1 - P, live)
    seq = _tail(ids, out, st.pos - P, mnt, eos_token_id)
    if return_stats:
        return seq, _stats(st.rounds, st.accepted, st.hist, B)
    return seq


@torch.no_grad()
def ngram_speculative_greedy_search(model, input_ids,
                                    max_new_tokens: int = 32, k: int = 8,
                                    n: int = 2,
                                    eos_token_id: int | None = None,
                                    max_len: int | None = None,
                                    return_stats: bool = False):
    """Greedy decoding with prompt-lookup speculation (no draft): each
    round proposes the ``k`` tokens that followed the most recent earlier
    occurrence of the last ``n`` decided tokens in the prompt + generated
    context (``ngram_propose``), and the model verifies them in one
    (k+1)-token window. Arguments and result as in
    ``speculative_greedy_search``."""
    if n < 1 or k < 1:
        raise ValueError(f"n={n} and k={k} must be at least 1")
    ids = torch.as_tensor(input_ids, device=model.device)
    B, P = ids.shape
    mnt, W = max_new_tokens, k + 1
    total = _margin(P, mnt, k, max_len)
    caches = _caches(model, B, total)
    dev = ids.device
    L = P + mnt + W          # token buffer: prompt + decided + margin
    buf = torch.zeros((B, L), dtype=torch.int32, device=dev)
    buf[:, :P] = ids
    prompt_pos = torch.arange(P, device=dev)[None, :].expand(B, P)
    _, caches = model(ids, prompt_pos, caches, 0)
    st = _Round(ids, mnt, k)
    ar = torch.arange(W, device=dev)
    while st.running():
        b = st.pos - 1
        prop = ngram_propose(buf, st.pos, st.cur, k, n)
        window = torch.cat([st.cur, prop], dim=1)   # [cur, p1..pk]
        lg, caches = model(window, b[:, None] + ar[None, :], caches, b)
        t = _argmax(lg)
        start = st.pos
        live = st.step(prop, t, eos_token_id)
        write_window(buf, t, start, live)
    seq = _tail(ids, buf[:, P:P + mnt + W], st.pos - P, mnt, eos_token_id)
    if return_stats:
        return seq, _stats(st.rounds, st.accepted, st.hist, B)
    return seq
