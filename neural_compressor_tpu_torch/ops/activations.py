"""Elementwise functions of the Gemma family, rounded as jitted JAX
rounds them, so that the port and the JAX package give the same bits.

XLA evaluates a bf16 elementwise chain one operation at a time, rounding
to bf16 after each, and compiles a division by a constant as a
multiplication by its float32 reciprocal. The port does the same; tanh
runs in float64 and is rounded once, so the card and the CPU agree (XLA's
own float32 tanh is an approximation a few ulps from the rounded one).
"""

from __future__ import annotations

import math

import torch


# elements a float64 temporary of ``softcap`` holds at once (a prefill's
# logits over a 256k vocabulary run to billions)
_CHUNK = 1 << 26


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma's logit softcap ``cap * tanh(x / cap)`` in x's dtype: ``x *
    f32(1/cap)``, tanh, times ``cap``, each rounded to x's dtype; taken
    ``_CHUNK`` elements at a time."""
    dt = x.dtype
    inv = torch.tensor(1.0 / cap, dtype=torch.float32, device=x.device)
    out = torch.empty(x.shape, dtype=dt, device=x.device)
    for src, dst in zip(x.reshape(-1).split(_CHUNK),
                        out.view(-1).split(_CHUNK)):
        t = (src.to(torch.float32) * inv).to(dt)
        th = torch.tanh(t.to(torch.float64)).to(dt)
        dst.copy_((th.to(torch.float32) * float(cap)).to(dt))
    return out


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` as XLA evaluates it in x's
    dtype: ``x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3))))``
    with ``x^3 = (x * x) * x`` and the constants in x's dtype, rounding
    after every operation. In bf16 ``F.gelu(approximate="tanh")`` (one
    rounding) differs from it in ~40% of elements."""
    dt = x.dtype
    c0 = torch.tensor(0.044715, dtype=dt, device=x.device)
    s2 = torch.tensor(math.sqrt(2.0 / math.pi), dtype=dt, device=x.device)
    x3 = x * x * x
    c = s2 * (x + c0 * x3)
    th = torch.tanh(c.to(torch.float64)).to(dt)
    return x * (0.5 * (1.0 + th))
