"""Serving engine: batched decode with continuous batching — counterpart of ``src/repro/serve/engine.py``.

A fixed slot table holds the decode batch.  Each pending request is prefilled
alone (one row) and its cache row is spliced into a free slot; one decode
step then advances every slot at its own position.  Finished sequences (EOS,
``max_new`` tokens or a full cache) free their slot.  Inactive rows decode
junk into their own cache rows, which the next admission overwrites.

Greedy decoding takes the first maximal logit, as the reference does;
temperature sampling draws from the engine's own ``torch.Generator`` (its
numbers differ from the reference's ``jax.random``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["ServeConfig", "ServeEngine", "Request"]


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 1024
    slots: int = 8              # concurrent sequences (decode batch)
    eos_token: int = 1
    temperature: float = 0.0    # 0 ⇒ greedy
    seed: int = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [S] int
    max_new: int = 32
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _mean_ms(seconds: List[float]) -> float:
    return 1e3 * sum(seconds) / len(seconds) if seconds else 0.0


def _leaves(tree):
    for leaf in tree.values():
        if isinstance(leaf, dict):
            yield from _leaves(leaf)
        else:
            yield leaf


class ServeEngine:
    def __init__(self, model, params, cfg: ServeConfig, *, device="cuda"):
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(f"engine device {self.device} differs from the model's {model.device}")
        self.model = model
        self.cfg = cfg
        self.params = model.cast_for_compute(params)
        self.cache = model.init_decode_cache(cfg.slots, cfg.max_len)
        self.slot_req: List[Optional[Request]] = [None] * cfg.slots
        self.slot_pos = np.zeros(cfg.slots, dtype=np.int64)
        self.queue: List[Request] = []
        self._next_rid = 0
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._prefill_s: List[float] = []
        self._decode_s: List[float] = []

    # -- request intake ----------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int = 32) -> Request:
        req = Request(rid=self._next_rid, prompt=np.asarray(prompt, np.int64), max_new=max_new)
        self._next_rid += 1
        self.queue.append(req)
        return req

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _admit(self) -> None:
        """Prefill pending requests one row at a time and splice each into a free slot."""
        for slot in self._free_slots():
            if not self.queue:
                break
            req = self.queue.pop(0)
            t0 = time.perf_counter()
            cache1, last_logits = self.model.prefill(
                self.params, {"tokens": req.prompt[None]}, max_len=self.cfg.max_len
            )
            # in-place row copy: each leaf keeps its own dtype (rwkv's WKV state stays f32)
            for full, one in zip(_leaves(self.cache), _leaves(cache1)):
                full[:, slot] = one[:, 0]
            first = int(self._sample(last_logits)[0, 0])  # waits for the device
            self._prefill_s.append(time.perf_counter() - t0)
            req.out_tokens.append(first)
            if first == self.cfg.eos_token or len(req.out_tokens) >= req.max_new:
                req.done = True  # finished at admission; slot stays free
            else:
                self.slot_req[slot] = req
                self.slot_pos[slot] = len(req.prompt)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.cfg.temperature <= 0.0:
            return logits.argmax(dim=-1)
        probs = torch.softmax(logits.float() / self.cfg.temperature, dim=-1)
        flat = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=self._gen)
        return flat.reshape(probs.shape[:-1])

    # -- the serving loop ---------------------------------------------------------
    def step(self) -> int:
        """One decode step for all active slots; returns #active."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        tokens = np.zeros((self.cfg.slots, 1), np.int64)
        for i in active:
            tokens[i, 0] = self.slot_req[i].out_tokens[-1]
        t0 = time.perf_counter()
        pos = torch.as_tensor(self.slot_pos, device=self.device)
        self.cache, logits = self.model.decode_step(self.params, self.cache, tokens, pos)
        nxt = self._sample(logits)[:, 0].cpu().numpy()  # waits for the device
        self._decode_s.append(time.perf_counter() - t0)
        for i in active:
            req = self.slot_req[i]
            tok = int(nxt[i])
            req.out_tokens.append(tok)
            self.slot_pos[i] += 1
            if (
                tok == self.cfg.eos_token
                or len(req.out_tokens) >= req.max_new
                or self.slot_pos[i] >= self.cfg.max_len - 1
            ):
                req.done = True
                self.slot_req[i] = None
        return len(active)

    def run_until_drained(self, requests: List[Request], max_steps: int = 10_000) -> Dict[str, float]:
        """Serve until every submitted request finishes; returns throughput stats.

        Times are host-clock seconds around work that ends in a device sync.
        """
        t0 = time.perf_counter()
        steps = 0
        for _ in range(max_steps):
            n = self.step()
            steps += 1
            if n == 0 and not self.queue:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        toks = sum(len(r.out_tokens) for r in requests)
        return {
            "requests": float(len(requests)),
            "tokens": float(toks),
            "steps": float(steps),
            "wall_s": wall,
            "tok_per_s": toks / max(wall, 1e-9),
            "prefills": float(len(self._prefill_s)),
            "prefill_ms_mean": _mean_ms(self._prefill_s),
            "decode_steps": float(len(self._decode_s)),
            "decode_step_ms_mean": _mean_ms(self._decode_s),
        }
