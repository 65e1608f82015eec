"""Command-line entry points — counterpart of ``src/repro/launch``."""
