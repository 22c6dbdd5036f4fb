"""Small shared helpers for algorithm entries (no circular imports)."""

from __future__ import annotations


def run_user_calibration(model, run_fn, run_args) -> None:
    """Call ``run_fn`` on ``model`` with ``run_args`` spread as the JAX
    package spreads them: none, keywords (dict), positionals (list or
    tuple) or one argument."""
    if run_fn is None:
        return
    if run_args is None:
        run_fn(model)
    elif isinstance(run_args, dict):
        run_fn(model, **run_args)
    elif isinstance(run_args, (list, tuple)):
        run_fn(model, *run_args)
    else:
        run_fn(model, run_args)
