"""Data pipeline — counterpart of ``repro.data``."""

from .pipeline import ShardedPipeline, SyntheticLM

__all__ = ["ShardedPipeline", "SyntheticLM"]
