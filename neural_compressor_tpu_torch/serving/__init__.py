"""Serving: the continuous-batching engine."""

from .engine import ContinuousBatchingEngine, Request
