"""End to end: train a ~100M-parameter LM with the whole port, through a node failure.

Twin of ``examples/train_end_to_end.py``, on one card (``--device cuda``, the
default) or the CPU (``--device cpu``), with the same flags and the same JSON:
config (gemma2 family, scaled to ~100M) → model → sharded synthetic data
pipeline → AdamW + cosine → the fault-tolerant Trainer → SCISPACE
checkpointing (native writes published by MEU, found by an SDS search) in a
collaboration of two data centers, this pod's ``pod0`` and a ``peer`` — and,
with ``--fail-at``, a simulated node failure that restarts from the latest
checkpoint that the search finds.  There is no mesh: the port trains on one
device.

    PYTHONPATH=src python -m repro_torch.launch.train_end_to_end --steps 200
    PYTHONPATH=src python -m repro_torch.launch.train_end_to_end --steps 40 --fail-at 25 --ckpt-every 10
    PYTHONPATH=src python -m repro_torch.launch.train_end_to_end --device cpu --steps 6 --seq-len 16 \\
        --global-batch 1 --fail-at 5 --ckpt-every 2

It prints the model's parameter count, then one JSON object: the Trainer's
result, the first and last loss and the checkpointed steps an SDS search
finds (``ckpt_steps_discovered_via_sds``); it fails unless the loss fell.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Tuple

from ..configs import get_config
from ..core import Collaboration
from ..data import ShardedPipeline, SyntheticLM
from ..device import resolve_device
from ..models import Model
from ..models.transformer import count_params, init_lm
from ..optim import AdamW, AdamWConfig
from ..train import CheckpointManager, FaultInjector, Trainer, TrainerConfig

__all__ = ["build_100m_config", "parse_args", "run", "main"]


def build_100m_config():
    """Gemma2-family config scaled to ~100M params, the example's (exact count printed)."""
    return get_config("gemma2-2b").replace(
        name="gemma2-100m",
        d_model=768,
        n_layers=12,
        n_heads=12,
        n_kv_heads=4,
        head_dim=64,
        d_ff=3072,
        vocab_size=32_768,
        attn_window=256,
        dtype="float32",
        param_dtype="float32",
        attn_chunk_q=128,
        attn_chunk_kv=128,
        remat="none",
    )


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=2)
    ap.add_argument("--fail-at", type=int, default=0, help="inject a node failure at this step")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> Tuple[Dict[str, Any], Trainer]:
    """Train as the example does; returns (the JSON's fields, the trainer after the run)."""
    cfg = build_100m_config()
    model = Model(cfg, device=resolve_device(args.device))
    print(f"model: {cfg.name}  params={count_params(init_lm(cfg, None, 'meta')) / 1e6:.1f}M", flush=True)
    opt = AdamW(AdamWConfig(peak_lr=3e-3, warmup_steps=20, total_steps=args.steps))
    pipe = ShardedPipeline(
        SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq_len, period=16, vocab_eff=512),
        global_batch=args.global_batch,
    )

    # SCISPACE checkpoint plane: this pod's DC + a peer DC
    collab = Collaboration()
    try:
        collab.add_datacenter("pod0", n_dtns=2)
        collab.add_datacenter("peer", n_dtns=2)
        ckpt = CheckpointManager(collab, run="e2e-100m", home_dc="pod0", n_shards=2)
        fail = FaultInjector(fail_at=[args.fail_at]) if args.fail_at else None
        trainer = Trainer(
            model, opt, pipe,
            TrainerConfig(loss_chunk=min(args.seq_len, 128), ckpt_every=args.ckpt_every),
            ckpt=ckpt, fault_hook=fail,
        )
        result = trainer.run(args.steps)
        losses = [m["loss"] for m in trainer.metrics_log if "loss" in m]
        out = {
            **result,
            "first_loss": losses[0],
            "last_loss": losses[-1],
            "ckpt_steps_discovered_via_sds": ckpt.list_steps(),
        }
    finally:
        collab.close()
    return out, trainer


def main(argv=None) -> int:
    out, _ = run(parse_args(argv))
    print(json.dumps(out, indent=1))
    if not out["last_loss"] < out["first_loss"]:
        raise AssertionError(f"loss should decrease on the synthetic language: {out['first_loss']} -> "
                             f"{out['last_loss']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
