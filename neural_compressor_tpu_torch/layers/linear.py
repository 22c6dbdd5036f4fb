"""Float Linear and Embed modules in the JAX package's layouts.

``Linear`` keeps its kernel as [K, N] (``y = x @ kernel``) and ``Embed``
its table as ``embedding`` [V, H], under the parameter names of
``flax.nnx.Linear`` / ``nnx.Embed``, so a flat JAX state maps onto the
port's ``state_dict`` key for key.
"""

from __future__ import annotations

import torch
from torch import nn


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = False,
                 dtype=torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        # N(0, 1/fan_in) init (the JAX package truncates its normal; this
        # does not)
        k = torch.randn((in_features, out_features), generator=generator,
                        device=device, dtype=torch.float32)
        self.kernel = nn.Parameter((k * in_features ** -0.5).to(dtype),
                                   requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                              device=device),
                                  requires_grad=False) if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.kernel.dtype), self.kernel)
        if self.bias is not None:
            y = y + self.bias
        return y


class Embed(nn.Module):
    def __init__(self, num_embeddings: int, features: int,
                 dtype=torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        e = torch.randn((num_embeddings, features), generator=generator,
                        device=device, dtype=torch.float32)
        self.embedding = nn.Parameter(
            (e * num_embeddings ** -0.5).to(dtype), requires_grad=False)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]
