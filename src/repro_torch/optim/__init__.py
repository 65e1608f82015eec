"""Optimizer — counterpart of ``repro.optim`` (AdamW, schedule, clipping)."""

from .adamw import AdamW, AdamWConfig, clip_by_global_norm, cosine_schedule, global_norm

__all__ = ["AdamW", "AdamWConfig", "cosine_schedule", "global_norm", "clip_by_global_norm"]
