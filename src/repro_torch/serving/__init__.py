"""Speculative serving: the engine, the continuous-batching scheduler and
cache operations."""
