"""Model stack — counterpart of ``src/repro/models`` (dense attention patterns)."""

from .model import Model

__all__ = ["Model"]
