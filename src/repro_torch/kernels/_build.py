"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``build/repro_torch/<name>-<digest>.so`` at the root of the checkout
(listed in ``.gitignore``); the digest covers the source and the flags, so an
edited source is rebuilt and an unchanged one is reused.  Nothing is built at
import: the first kernel call (or :func:`build`) compiles.  :func:`build`
starts one ``nvcc`` per source, all together, so building every source takes
about as long as the slowest one.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["BuildResult", "build", "build_all", "compile_source", "load_library", "BUILD_DIR", "CSRC"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: float   # 0.0 when an earlier build of the same digest was reused
    log: str         # nvcc's output, including the -Xptxas -v register / shared-memory lines


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels cannot be built")
    return str(path)


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def compile_source(src: Path, target: Path) -> str:
    """Compile one ``.cu`` file into the shared library ``target``; returns nvcc's log."""
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src.name} (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, target)  # atomic: a concurrent loader never sees a partial file
    return proc.stdout


def _build_one(name: str) -> BuildResult:
    target = _target(name)
    log_path = target.with_suffix(".log")
    if target.exists():
        return BuildResult(name, target, 0.0, log_path.read_text() if log_path.exists() else "")
    t0 = time.perf_counter()
    log = compile_source(CSRC / f"{name}.cu", target)
    log_path.write_text(log)
    return BuildResult(name, target, time.perf_counter() - t0, log)


def build(names: Iterable[str]) -> Dict[str, BuildResult]:
    """Compile every named source that has no current build, one nvcc per source, all at once."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(_build_one, names)))


def build_all() -> Dict[str, BuildResult]:
    """Build every ``csrc/*.cu``; a launcher calls this before timing anything."""
    return build(sorted(p.stem for p in CSRC.glob("*.cu")))


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it; one handle per process."""
    return ctypes.CDLL(str(build([name])[name].path))
