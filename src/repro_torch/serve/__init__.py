"""Serving — counterpart of ``src/repro/serve``."""

from .engine import Request, ServeConfig, ServeEngine

__all__ = ["ServeConfig", "ServeEngine", "Request"]
