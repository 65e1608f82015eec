"""Checkpointing through the SCISPACE workspace — port of ``src/repro/train/checkpoint.py``.

Two write paths, as the reference's (the paper's §III-B3):

- **workspace mode** ("SCISPACE" in the paper's figures): every shard write
  goes through :class:`~repro_torch.core.workspace.Workspace` — the five-op
  FUSE sequence + metadata RPCs per file, indexed inline.  Globally visible
  immediately.
- **native mode (LW+MEU)**, the default — shards are written straight into
  the pod's local store (:class:`~repro_torch.core.workspace.NativeSession`,
  no RPC in the data path); one batched :class:`~repro_torch.core.meu.MEU`
  export afterwards publishes the metadata, and LW-Offline indexing makes the
  step discoverable.

Checkpoints are self-describing scidata containers, one per shard, at
``/ckpt/<run>/stepNNNNNNNN/shardS.sci``: leaf arrays keyed by their path in
the state tree, attrs ``kind``, ``run``, ``step``, ``shard``, ``n_shards`` and
``split_axes`` (JSON).  Finding the latest step is an SDS attribute query,
never a directory crawl.  Each leaf splits on its largest dimension divisible
by ``n_shards`` (later dimensions win ties); a leaf too small to split goes
to shard 0 whole.

The port's state is a nested dict of tensors.  Its leaves are taken in the
order JAX flattens a dict (``convert.flatten``: sorted keys, paths joined as
the reference's ``path_of`` does), so
for the same state the shard files are byte-identical to the reference's, and
either side restores what the other saved.  Only float32 and int32 leaves
are stored: the reference writes a bfloat16 leaf as ml_dtypes' ``<V2``, which
torch cannot read back.  There is no mesh, so ``restore`` takes no
``shardings=``: it returns CPU tensors, and the caller copies them where they
belong (the :class:`~repro_torch.train.trainer.Trainer` copies them into its
live tensors on the card).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..convert import flatten
from ..core.meu import MEU
from ..core.workspace import NativeSession, Workspace
from ..optim.adamw import tree_unflatten

__all__ = ["CheckpointManager", "CheckpointInfo"]

_STORED = (torch.float32, torch.int32)  # the leaf dtypes a checkpoint holds


def _split_axis(shape: Tuple[int, ...], n_shards: int) -> Optional[int]:
    """Largest dim divisible by n_shards (prefer later dims: params are
    [units, in, out] and splitting 'out' keeps rows contiguous)."""
    best = None
    for d in range(len(shape)):
        if shape[d] % n_shards == 0 and shape[d] >= n_shards:
            if best is None or shape[d] >= shape[best]:
                best = d
    return best


def _host_array(path: str, leaf: torch.Tensor) -> np.ndarray:
    if leaf.dtype not in _STORED:
        raise TypeError(f"{path}: {leaf.dtype} leaves are not checkpointed; only float32 and int32 are (the "
                        f"reference stores bfloat16 as ml_dtypes' <V2, which torch cannot read back)")
    return leaf.detach().cpu().numpy()


@dataclass
class CheckpointInfo:
    run: str
    step: int
    path: str
    n_shards: int


class CheckpointManager:
    """Save/restore train state through a SCISPACE collaboration.

    ``mode`` is ``'native'`` (LW+MEU, default — the paper's fast path) or
    ``'workspace'`` (synchronous global writes — the paper's baseline).
    """

    def __init__(
        self,
        collab,
        *,
        run: str,
        home_dc: str,
        collaborator: str = "trainer",
        mode: str = "native",
        n_shards: int = 2,
        base: str = "/ckpt",
    ):
        if mode not in ("native", "workspace"):
            raise ValueError(f"unknown checkpoint mode {mode!r}")
        self.collab = collab
        self.run = run
        self.home_dc = home_dc
        self.mode = mode
        self.n_shards = n_shards
        self.base = base.rstrip("/")
        self.collaborator = collaborator
        # workspace mode indexes inline (the paper's Inline-Sync write path);
        # native mode indexes offline after the MEU export (LW-Offline).
        self.ws = Workspace(
            collab, collaborator, home_dc,
            extraction_mode="inline-sync" if mode == "workspace" else "none",
        )
        self.native = NativeSession(collab.dc(home_dc), collaborator)
        self.meu = MEU(collab, collab.dc(home_dc), collaborator)

    # -- save -------------------------------------------------------------------
    def _shard_payloads(self, state) -> List[Tuple[Dict[str, np.ndarray], Dict[str, Any]]]:
        shards: List[Dict[str, np.ndarray]] = [dict() for _ in range(self.n_shards)]
        split_axes: Dict[str, int] = {}
        for path, leaf in flatten(state).items():
            arr = _host_array(path, leaf)
            ax = _split_axis(arr.shape, self.n_shards) if arr.ndim else None
            if ax is None:
                shards[0][path] = arr
                split_axes[path] = -1
            else:
                for s, piece in enumerate(np.split(arr, self.n_shards, axis=ax)):
                    shards[s][path] = piece
                split_axes[path] = ax
        metas = []
        for s in range(self.n_shards):
            metas.append(
                {
                    "kind": "checkpoint",
                    "run": self.run,
                    "step": -1,  # filled at save()
                    "shard": s,
                    "n_shards": self.n_shards,
                    "split_axes": json.dumps(split_axes),
                }
            )
        return list(zip(shards, metas))

    def _path(self, step: int, shard: int) -> str:
        return f"{self.base}/{self.run}/step{step:08d}/shard{shard}.sci"

    def save(self, state, step: int) -> Dict[str, float]:
        """Write ``state`` (a nested dict of tensors on any device) as step ``step``.

        Returns the reference's accounting: bytes, pack / write / publish /
        total seconds (pack includes the copy to the host) and the MEU's RPCs.
        """
        t0 = time.perf_counter()
        payloads = self._shard_payloads(state)
        t_pack = time.perf_counter() - t0

        t1 = time.perf_counter()
        total_bytes = 0
        for s, (arrays, attrs) in enumerate(payloads):
            attrs = dict(attrs, step=step)
            path = self._path(step, s)
            if self.mode == "workspace":
                total_bytes += self.ws.write_scidata(path, arrays, attrs)
            else:
                total_bytes += self.native.write_scidata(path, arrays, attrs)
        t_write = time.perf_counter() - t1

        t2 = time.perf_counter()
        export_report = None
        if self.mode == "native":
            # one batched metadata export publishes the new step (§III-B3)
            export_report = self.meu.export(f"{self.base}/{self.run}")
            # LW-Offline indexing so the step is SDS-discoverable (§III-B5)
            paths = [self._path(step, s) for s in range(self.n_shards)]
            self.collab.dc(self.home_dc).offline_index(paths)
        # workspace mode indexed inline during the writes (Inline-Sync)
        t_publish = time.perf_counter() - t2

        return {
            "bytes": float(total_bytes),
            "pack_s": t_pack,
            "write_s": t_write,
            "publish_s": t_publish,
            "total_s": t_pack + t_write + t_publish,
            "meu_rpcs": float(export_report.rpc_calls) if export_report else 0.0,
        }

    # -- discovery + restore -------------------------------------------------------
    def list_steps(self) -> List[int]:
        """SDS attribute query — no directory crawling (§III-B5)."""
        rows = self.ws.search(f"run = {self.run}")
        steps = sorted({int(r["attrs"]["step"]) for r in rows if "step" in r.get("attrs", {})})
        return steps

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, state_like, step: Optional[int] = None):
        """The state of step ``step`` (default: the latest found by SDS) as CPU
        tensors shaped like ``state_like``'s leaves, in their dtypes.

        Leaves are read one at a time through the workspace (any pod can
        restore any run), so the host holds the result and one leaf's pieces.
        """
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints for run {self.run!r}")
        paths = [self._path(step, s) for s in range(self.n_shards)]
        split_axes = json.loads(self.ws.read_attrs(paths[0])["split_axes"])
        flat = []
        for name, like in flatten(state_like).items():
            ax = split_axes[name]
            if ax < 0:
                arr = self.ws.read_dataset(paths[0], name)
            else:
                arr = np.concatenate([self.ws.read_dataset(p, name) for p in paths], axis=ax)
            # scidata stores 0-d arrays as [1] (ascontiguousarray quirk)
            arr = arr.reshape(tuple(like.shape))
            flat.append(torch.from_numpy(arr if arr.flags.writeable else arr.copy()).to(like.dtype))
        return tree_unflatten(state_like, flat)
