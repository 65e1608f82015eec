"""``scidata`` — a self-describing scientific container (HDF5/NetCDF stand-in).

The paper's Scientific Discovery Service extracts "HDF5 and NetCDF
self-contained attributes" with the HDF5 library (§III-B5).  h5py is not
available in this container, so this module defines an equivalent
self-describing format with the two properties SDS depends on:

1. **attributes** — typed (int / float / text, exactly the paper's three
   supported attribute datatypes) key/value pairs embedded in the file header;
2. **datasets** — named n-d arrays stored after the header, addressable
   without reading the whole file (header-only reads are what make
   attribute extraction cheap relative to data size).

Layout::

    magic 'SCI1' | u32 header_len | header json (attrs + dataset directory)
    | dataset payloads (raw little-endian arrays, in directory order)

The header can be read with a single ``read(path, offset=0, length=8+N)``
pair, mirroring how SDS opens an HDF5 file and reads only its metadata.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from .backends import StorageBackend

__all__ = [
    "AttrValue",
    "SciFile",
    "serialize_scidata",
    "write_scidata",
    "read_header",
    "read_dataset",
    "read_header_via",
    "read_dataset_via",
    "dataset_range",
    "attr_type_of",
]

#: A ranged reader: ``(offset, length) -> bytes``.  Lets the parse logic run
#: over any byte source — a local backend, or the data plane's chunk-cached
#: cross-DC ranged reads (``DataPath.read_range``).
RangeReader = Callable[[int, int], bytes]

MAGIC = b"SCI1"

AttrValue = Union[int, float, str]


def attr_type_of(value: AttrValue) -> str:
    """The paper's three attribute datatypes: integer, float, text."""
    if isinstance(value, bool):
        raise TypeError("bool attributes are not part of the paper's type set")
    if isinstance(value, int):
        return "int"
    if isinstance(value, float):
        return "float"
    if isinstance(value, str):
        return "text"
    raise TypeError(f"unsupported attribute type: {type(value)!r}")


@dataclass
class SciFile:
    """Parsed header of a scidata container."""

    attrs: Dict[str, AttrValue]
    datasets: List[Dict]  # {name, shape, dtype, offset, nbytes}
    header_len: int = 0

    def dataset(self, name: str) -> Optional[Dict]:
        for d in self.datasets:
            if d["name"] == name:
                return d
        return None


def serialize_scidata(arrays: Dict[str, np.ndarray], attrs: Dict[str, AttrValue]) -> bytes:
    """Serialize ``arrays`` + ``attrs`` into one self-describing blob."""
    directory = []
    offset = 0
    payloads = []
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        raw = arr.tobytes()
        directory.append(
            {
                "name": name,
                "shape": list(arr.shape),
                "dtype": arr.dtype.str,
                "offset": offset,
                "nbytes": len(raw),
            }
        )
        payloads.append(raw)
        offset += len(raw)

    for key, value in attrs.items():
        attr_type_of(value)  # validate against the paper's type set

    header = json.dumps({"attrs": attrs, "datasets": directory}).encode("utf-8")
    return MAGIC + struct.pack("<I", len(header)) + header + b"".join(payloads)


def write_scidata(
    backend: StorageBackend,
    path: str,
    arrays: Dict[str, np.ndarray],
    attrs: Dict[str, AttrValue],
    *,
    owner: str = "",
) -> int:
    """Serialize and store a self-describing file; returns bytes written."""
    blob = serialize_scidata(arrays, attrs)
    backend.write(path, blob, owner=owner)
    return len(blob)


def read_header_via(read_range: RangeReader, label: str = "<scidata>") -> SciFile:
    """Header-only parse over any ranged byte source (see :data:`RangeReader`)."""
    prefix = read_range(0, 8)
    if len(prefix) < 8 or prefix[:4] != MAGIC:
        raise ValueError(f"{label}: not a scidata container")
    (header_len,) = struct.unpack("<I", prefix[4:8])
    header = read_range(8, header_len)
    doc = json.loads(header.decode("utf-8"))
    return SciFile(attrs=doc["attrs"], datasets=doc["datasets"], header_len=header_len)


def dataset_range(sci: SciFile, entry: Dict) -> Tuple[int, int]:
    """Absolute ``(offset, nbytes)`` of a dataset's payload within the file —
    the range a read-ahead of the *next* dataset prefetches."""
    return 8 + sci.header_len + entry["offset"], entry["nbytes"]


def read_dataset_via(
    read_range: RangeReader,
    name: str,
    label: str = "<scidata>",
    *,
    sci: Optional[SciFile] = None,
) -> np.ndarray:
    """Read one named array over any ranged byte source.

    Pass a pre-parsed ``sci`` header to skip re-reading it (the data plane
    does: the header was already fetched — and cached — moments earlier).
    """
    if sci is None:
        sci = read_header_via(read_range, label)
    entry = sci.dataset(name)
    if entry is None:
        raise KeyError(f"{label}: no dataset {name!r}")
    offset, nbytes = dataset_range(sci, entry)
    raw = read_range(offset, nbytes)
    return np.frombuffer(raw, dtype=np.dtype(entry["dtype"])).reshape(entry["shape"])


def read_header(backend: StorageBackend, path: str) -> SciFile:
    """Header-only read (the cheap metadata-extraction path)."""
    return read_header_via(lambda off, ln: backend.read(path, offset=off, length=ln), path)


def read_dataset(backend: StorageBackend, path: str, name: str) -> np.ndarray:
    """Read one named array without touching the others."""
    return read_dataset_via(
        lambda off, ln: backend.read(path, offset=off, length=ln), name, path
    )
