"""Mixture-of-experts FFN with GShard one-hot dispatch — counterpart of ``src/repro/models/moe.py:31-157``.

Top-k gating over f32 router probabilities, per-expert capacity
``C = ceil(S·K·cf/E)`` per row (or per ``moe_block`` of the sequence), and
dispatch / combine as one-hot products: the K choices are swept in order,
each expert's queue filled in token order, and tokens beyond an expert's
capacity dropped, exactly as the reference drops them.  The three products
(dispatch, the expert FFN, combine) are plain large products, which the
reference leaves to XLA outside any Pallas kernel; here they are
``torch.einsum``.  The load-balance loss is computed as in the reference;
serving ignores it.  Only the swiglu experts without a shared expert are
ported, which is what jamba runs; llama4's shared expert waits for its slice
(ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .layers import Init, Params, dense, init_dense

__all__ = ["init_moe", "moe_layer"]


def _check_ported(cfg) -> None:
    if cfg.activation != "swiglu" or cfg.moe.shared_expert:
        raise NotImplementedError(
            f"MoE with activation={cfg.activation!r}, shared_expert={cfg.moe.shared_expert}: only swiglu "
            "experts without a shared expert are ported (the olmoe/llama4 item, ROADMAP queue 1 item 5)"
        )


def init_moe(init: Init, cfg) -> Params:
    """f32-router dense weights and expert stacks ``[E, d, f]`` / ``[E, f, d]``, normal·1/√fan_in."""
    _check_ported(cfg)
    spec = cfg.moe
    d, f, e = cfg.d_model, spec.d_ff, spec.n_experts
    return {
        "router": init_dense(init, d, (e,)),
        "w_gate": {"w": init.normal((e, d, f), 1.0 / math.sqrt(d))},
        "w_up": {"w": init.normal((e, d, f), 1.0 / math.sqrt(d))},
        "w_down": {"w": init.normal((e, f, d), 1.0 / math.sqrt(f))},
    }


def _top_k_gating(logits: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (gate weights [B,S,K] renormalised over the K, expert ids [B,S,K], probs [B,S,E]).

    A stable descending sort picks the lower expert index among equal
    probabilities, as ``jax.lax.top_k`` does.
    """
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :top_k], idx[..., :top_k]
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
    return gates, idx, probs


def moe_layer(p: Params, x: torch.Tensor, cfg, *, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,D] → (out [B,S,D], load-balance aux loss).

    With ``cfg.moe_block`` > 0 that divides S (and is smaller), capacity is
    counted per block of the sequence instead of per row.
    """
    _check_ported(cfg)
    blk = cfg.moe_block
    B, S, D = x.shape
    if blk and blk < S and S % blk == 0:
        out, aux = _moe_dispatch(p, x.reshape(B * (S // blk), blk, D), cfg, dtype=dtype)
        return out.reshape(B, S, D), aux
    return _moe_dispatch(p, x, cfg, dtype=dtype)


def _moe_dispatch(p: Params, x: torch.Tensor, cfg, *, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    spec = cfg.moe
    B, S, D = x.shape
    E, K = spec.n_experts, spec.top_k
    C = max(1, int(math.ceil(S * K * spec.capacity_factor / E)))

    router_logits = dense(p["router"], x, dtype=torch.float32)  # routing in f32
    gates, idx, probs = _top_k_gating(router_logits, K)

    # load-balance loss (Switch/GShard): E · Σ_e fraction_e · mean_prob_e
    fraction = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(fraction * probs.mean(dim=(0, 1))) * spec.load_balance_coef

    # one-hot dispatch [B,S,E,C] and gate-weighted combine, K choices swept in order
    slots = torch.arange(C, device=x.device)
    dispatch = torch.zeros((B, S, E, C), dtype=torch.bool, device=x.device)
    combine = torch.zeros((B, S, E, C), dtype=torch.float32, device=x.device)
    used = torch.zeros((B, E), dtype=torch.long, device=x.device)  # slots taken per expert
    for k in range(K):
        onehot_e = F.one_hot(idx[..., k], E)                                     # [B,S,E]
        pos_in_e = torch.cumsum(onehot_e, dim=1) - onehot_e + used[:, None, :]  # queue position
        within = (pos_in_e < C) & (onehot_e > 0)                                # over capacity: dropped
        slot = (pos_in_e[..., None] == slots) & within[..., None]               # [B,S,E,C]
        dispatch |= slot
        combine += slot.float() * gates[..., k, None, None]
        used += (onehot_e * within).sum(dim=1)

    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(dtype), x.to(dtype))
    wg, wu, wd = (p[name]["w"].to(dtype) for name in ("w_gate", "w_up", "w_down"))
    h = F.silu(torch.einsum("ebcd,edf->ebcf", expert_in, wg)) * torch.einsum("ebcd,edf->ebcf", expert_in, wu)
    expert_out = torch.einsum("ebcf,efd->ebcd", h, wd)
    y = torch.einsum("bsec,ebcd->bsd", combine.to(dtype), expert_out)
    return y.to(x.dtype), aux
