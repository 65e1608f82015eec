"""Model stack — counterpart of ``src/repro/models`` (attention patterns and RWKV-6)."""

from .model import Model

__all__ = ["Model"]
