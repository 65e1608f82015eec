"""Model facade — counterpart of ``src/repro/models/model.py:30-98``.

    model = Model(cfg)                       # on the card; Model(cfg, device="cpu") on the CPU
    params = model.init(torch.Generator(model.device).manual_seed(0))
    loss, metrics = model.train_loss(params, batch)
    cache, logits = model.prefill(params, {"tokens": tokens}, max_len=...)
    cache, logits = model.decode_step(params, cache, token, pos)

Only the decoder-only family is ported; its functions live in
:mod:`repro_torch.models.transformer`.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..device import resolve_device
from . import transformer
from .layers import cast_for_compute

__all__ = ["Model"]


class Model:
    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator, *, compute_weights: bool = False):
        """Random master weights in ``cfg.param_dtype`` on this model's device, drawn from ``generator``.

        With ``compute_weights`` every weight that is cast at use is stored in the
        compute dtype straight from its draw: bitwise ``cast_for_compute(init(generator))``
        with no master copy held, which is what serving needs.
        """
        if generator.device.type != self.device.type:
            raise ValueError(f"generator is on {generator.device}, the model on {self.device}")
        return transformer.init_lm(self.cfg, generator, self.device, compute_weights=compute_weights)

    def cast_for_compute(self, params):
        """The weights cast to the compute dtype once, as every use would cast them."""
        return cast_for_compute(params, transformer._dtype(self.cfg))

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, dtype=torch.long, device=self.device)

    def train_loss(self, params, batch: Dict, *, loss_chunk: int = 256):
        """(loss, metrics) of a ``{"tokens", "targets"}`` batch (numpy or tensors of token ids)."""
        batch = {name: self._tokens(x) for name, x in batch.items()}
        return transformer.train_loss(params, batch, self.cfg, loss_chunk=loss_chunk)

    def input_shapes(self, shape) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
        """{name: (shape, dtype)} of one input-shape cell (a :class:`~repro_torch.configs.ShapeConfig`).

        Decode cells describe the per-step token input; the cache is separate state.
        """
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "train":
            return {"tokens": ((B, S), torch.int32), "targets": ((B, S), torch.int32)}
        if shape.kind == "prefill":
            return {"tokens": ((B, S), torch.int32)}
        return {"tokens": ((B, 1), torch.int32)}

    def make_batch(self, generator: torch.Generator, shape) -> Dict[str, torch.Tensor]:
        """A synthetic batch of :meth:`input_shapes`, token ids uniform in the vocab, drawn from ``generator``.

        JAX keys cannot be reproduced in torch, so tests that compare with the
        reference feed both sides the same :class:`~repro_torch.data.SyntheticLM` batches.
        """
        if generator.device.type != self.device.type:
            raise ValueError(f"generator is on {generator.device}, the model on {self.device}")
        return {name: torch.randint(0, self.cfg.vocab_size, shp, generator=generator, device=self.device, dtype=dt)
                for name, (shp, dt) in self.input_shapes(shape).items()}

    def prefill(self, params, batch: Dict, *, max_len: int):
        batch = dict(batch, tokens=self._tokens(batch["tokens"]))
        return transformer.prefill(params, batch, self.cfg, max_len=max_len)

    def decode_step(self, params, cache, token, pos):
        return transformer.decode_step(params, cache, self._tokens(token), pos, self.cfg)

    def init_decode_cache(self, batch: int, max_len: int):
        return transformer.init_decode_cache(self.cfg, batch, max_len, device=self.device)

    def count_params(self, params) -> int:
        return transformer.count_params(params)
