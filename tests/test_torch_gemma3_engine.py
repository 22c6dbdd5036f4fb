"""The port's engine serving ``gemma3-test`` (qk-norms, a band of 8 on
five of six layers, a local rope table, no softcap) against the JAX
package's engine over contiguous caches and paged pools in every KV format:
tokens and dispatch counters equal, logprobs within 0.1. The helpers and
their notes are ``test_torch_gemma_engine.py``'s; the file is apart so that
each stays within a test worker's minute.
"""

import pytest
import torch

from test_torch_gemma_engine import MODES, engine_matches_jax, pairs  # noqa

torch.set_num_threads(2)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_gemma3_engine_matches_jax(pairs, mode):  # noqa: F811
    engine_matches_jax(pairs, "gemma3-test", mode)
