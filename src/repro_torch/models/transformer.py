"""Decoder-only LM — counterpart of ``src/repro/models/transformer.py``.

The stack is ``cfg.n_units`` repeats of ``cfg.pattern``; parameters and caches
of each pattern position are stacked across units with a leading ``n_units``
dimension, as in the reference, and the reference's ``lax.scan`` over units is
a Python loop here.  Ported: ``init_lm``, ``_embed_inputs``, ``_logits``,
``init_decode_cache``, ``decode_step``, ``prefill`` and ``count_params`` for
every mixer (attention, Mamba-1, RWKV-6 time-mix) and every FFN (dense, MoE,
RWKV-6 channel-mix) of the decoder-only family, with a tied or an untied
(``lm_head``) output head: gemma2, rwkv6, jamba, codeqwen, stablelm,
nemotron and olmoe.
Caches are updated in place: attention writes its new key/value rows, rwkv
and mamba layers copy their new states and carries over the old ones.

Two reference quirks are kept on purpose: prefill scales the embedding when
``norm == "rmsnorm" and post_block_norm`` but decode when ``post_block_norm``
alone is set; and a local layer's cache is a ring only when its length equals
the window.  One reference fault is not copied: when a prompt is longer than
a ring cache, the reference keeps the last T keys at slots ``0..T-1`` while
decode writes slot ``pos % T``; here position p always sits at slot ``p % T``
(ROADMAP.md queue 3).

Training (``lm_hidden``, ``train_loss``) is ported for every mixer and FFN of
the decoder-only family (gemma2, codeqwen, stablelm, nemotron, rwkv6, olmoe,
jamba), under ``remat`` "none" and "unit".  The f32 master weights stay the autograd leaves and every use
casts them, so gradients run through the casts.  Each MoE layer's
load-balance loss is summed over the layers and units into the loss, as the
reference's unit body carries it.
``remat="unit"`` recomputes each unit in the backward
(``torch.utils.checkpoint``, non-reentrant: only the unit's inputs are saved).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .attention import attention_layer, decode_attention_layer, init_attention, init_kv_cache
from .layers import Init, Params, embed, init_embedding, init_mlp, init_norm, mlp, norm, softcap, unembed
from .mamba import init_mamba, init_mamba_cache, mamba_decode_step, mamba_layer, mamba_layer_with_state
from .moe import init_moe, moe_layer
from .rwkv6 import init_rwkv_cache, init_rwkv_cmix, init_rwkv_tmix, rwkv_cmix, rwkv_tmix

__all__ = [
    "init_lm",
    "prefill",
    "decode_step",
    "init_decode_cache",
    "count_params",
    "lm_hidden",
    "train_loss",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _pdtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(init: Init, cfg, spec) -> Params:
    p: Params = {"norm1": init_norm(init, cfg.norm, cfg.d_model)}
    if spec.mixer == "rwkv":
        p["mixer"] = init_rwkv_tmix(init, cfg)
    elif spec.mixer == "mamba":
        p["mixer"] = init_mamba(init, cfg)
    else:
        p["mixer"] = init_attention(init, cfg)
    p["norm2"] = init_norm(init, cfg.norm, cfg.d_model)
    if spec.ffn == "rwkv_cmix":
        p["ffn"] = init_rwkv_cmix(init, cfg)
    elif spec.ffn == "moe":
        p["ffn"] = init_moe(init, cfg)
    else:
        p["ffn"] = init_mlp(init, cfg.d_model, cfg.d_ff, activation=cfg.activation)
    if cfg.post_block_norm:
        p["norm1_post"] = init_norm(init, cfg.norm, cfg.d_model)
        p["norm2_post"] = init_norm(init, cfg.norm, cfg.d_model)
    return p


def init_lm(cfg, generator, device, *, compute_weights: bool = False) -> Params:
    """Random parameters with the reference's shapes and distributions.

    Dense weights are normal·1/√fan_in, embeddings and the untied output head
    (``lm_head``, when ``cfg.tie_embeddings`` is false) normal·0.02, the
    attention output projection normal/√(H·hd), norm scales ones; the rwkv,
    mamba and moe leaves follow ``init_rwkv_tmix`` / ``init_rwkv_cmix``,
    ``init_mamba`` and ``init_moe``.  Every leaf is drawn in f32 and stored in
    ``cfg.param_dtype``, one leaf at a time; with ``compute_weights`` a leaf
    that is cast at use is stored in the compute dtype instead, so the tree is
    bitwise :func:`~repro_torch.models.layers.cast_for_compute` of the master
    weights without them ever being held.  ``device="meta"`` gives the shapes
    without drawing or allocating anything.
    """
    init = Init(generator, device, _pdtype(cfg), compute_dtype=_dtype(cfg) if compute_weights else None)
    params: Params = {"embed": init_embedding(init, cfg.vocab_size, cfg.d_model)}
    params["final_norm"] = init_norm(init, cfg.norm, cfg.d_model)
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(init, cfg.vocab_size, cfg.d_model)
    unit_init = init.stacked(cfg.n_units)
    params["units"] = {f"pos{i}": _init_layer(unit_init, cfg, spec) for i, spec in enumerate(cfg.pattern)}
    return params


def count_params(params) -> int:
    return sum(
        count_params(leaf) if isinstance(leaf, dict) else leaf.numel() for leaf in params.values()
    )


# ---------------------------------------------------------------------------
# embeddings and logits
# ---------------------------------------------------------------------------


def _embed_scale(x: torch.Tensor, cfg) -> torch.Tensor:
    """Gemma-style embedding scale, multiplied in the compute dtype."""
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)


def _embed_inputs(params, batch: Dict[str, torch.Tensor], cfg) -> torch.Tensor:
    x = embed(params["embed"], batch["tokens"], dtype=_dtype(cfg))
    if cfg.norm == "rmsnorm" and cfg.post_block_norm:
        x = _embed_scale(x, cfg)
    return x


def _head_name(cfg) -> str:
    """The output head's leaf: the embedding when tied, ``lm_head`` otherwise."""
    return "embed" if cfg.tie_embeddings else "lm_head"


def _logits(params, x: torch.Tensor, cfg) -> torch.Tensor:
    logits = unembed(params[_head_name(cfg)], x, dtype=_dtype(cfg))
    return softcap(logits, cfg.final_softcap)


def _unit(tree: Dict[str, Any], u: int) -> Dict[str, Any]:
    """Slice unit u out of a stacked tree (views, so cache writes land in place)."""
    return {k: _unit(v, u) if isinstance(v, dict) else v[u] for k, v in tree.items()}


def _rwkv_mix(lp, h, lc, cfg, dt):
    """RWKV time-mix from the cached state; the new state replaces the old one in place."""
    mix, st = rwkv_tmix(lp["mixer"], h, cfg, dtype=dt, state={"wkv": lc["wkv"], "shift": lc["tshift"]})
    lc["wkv"].copy_(st["wkv"])
    lc["tshift"].copy_(st["shift"])
    return mix


def _block(lp, spec, lc, x, mix, cfg, dt):
    """Residual add of the mixer output, then the FFN block (sandwich norms if set).

    Returns (x, aux): aux is the MoE's load-balance loss, None for the other
    FFNs; it is a training term, which serving drops.  Without a cache (``lc``
    None: training) the channel-mix starts from a zero shift.
    """
    if cfg.post_block_norm:
        mix = norm(lp["norm1_post"], mix, kind=cfg.norm)
    x = x + mix
    h = norm(lp["norm2"], x, kind=cfg.norm)
    aux = None
    if spec.ffn == "rwkv_cmix" and lc is None:
        f, _ = rwkv_cmix(lp["ffn"], h, cfg, dtype=dt)
    elif spec.ffn == "rwkv_cmix":
        f, st = rwkv_cmix(lp["ffn"], h, cfg, dtype=dt, state={"shift": lc["cshift"]})
        lc["cshift"].copy_(st["shift"])
    elif spec.ffn == "moe":
        f, aux = moe_layer(lp["ffn"], h, cfg, dtype=dt)
    else:
        f = mlp(lp["ffn"], h, activation=cfg.activation, dtype=dt)
    if cfg.post_block_norm:
        f = norm(lp["norm2_post"], f, kind=cfg.norm)
    return x + f, aux


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _check_trainable(cfg) -> None:
    if cfg.remat == "dots":
        raise NotImplementedError(
            f"{cfg.name}: remat='dots' (keep the dense products, recompute the rest) is not ported yet "
            f"(ROADMAP.md queue 1, item 3h)")


def _train_unit(x: torch.Tensor, aux: torch.Tensor, unit_params, positions: torch.Tensor,
                cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """One unit of the training forward, ``src/repro/models/transformer.py:178-197``: the carry
    (x, aux) through each pattern position, each MoE layer's load-balance loss added to aux."""
    dt = _dtype(cfg)
    for i, spec in enumerate(cfg.pattern):
        lp = unit_params[f"pos{i}"]
        h = norm(lp["norm1"], x, kind=cfg.norm)
        if spec.mixer == "rwkv":
            mix, _ = rwkv_tmix(lp["mixer"], h, cfg, dtype=dt)
        elif spec.mixer == "mamba":
            mix = mamba_layer(lp["mixer"], h, cfg, dtype=dt)
        else:
            mix, _ = attention_layer(lp["mixer"], h, positions, cfg, kind=spec.mixer, dtype=dt)
        x, aux_i = _block(lp, spec, None, x, mix, cfg, dt)
        if aux_i is not None:
            aux = aux + aux_i
    return x, aux


def _unit_trees(tree, n: int):
    """The stacked unit tree as n trees, one per unit, through ``unbind``.

    In the backward, ``unbind`` stacks each leaf's n slice gradients once,
    where indexing unit u (:func:`_unit`) would add a full-size, zero-padded
    gradient into the leaf's for every unit: the same values, n times the
    memory traffic.
    """
    if not isinstance(tree, dict):
        return tree.unbind(0)
    subtrees = {k: _unit_trees(v, n) for k, v in tree.items()}
    return [{k: sub[u] for k, sub in subtrees.items()} for u in range(n)]


def lm_hidden(params, batch: Dict[str, torch.Tensor], cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embeddings → units → final norm.  Returns (hidden, moe_aux): the MoE layers' load-balance
    losses summed over layers and units, 0 without MoE FFNs."""
    _check_trainable(cfg)
    x = _embed_inputs(params, batch, cfg)
    B, S = batch["tokens"].shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for unit in _unit_trees(params["units"], cfg.n_units):
        if cfg.remat == "unit":
            x, aux = checkpoint(_train_unit, x, aux, unit, positions, cfg, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = _train_unit(x, aux, unit, positions, cfg)
    x = norm(params["final_norm"], x, kind=cfg.norm)
    return x, aux


def _chunk_nll(head, x: torch.Tensor, targets: torch.Tensor, cfg) -> torch.Tensor:
    """Σ (logsumexp - picked logit) over one [B, c] chunk: logits in the compute dtype, softcapped, then f32."""
    logits = _logits(head, x, cfg).float()
    lse = torch.logsumexp(logits, dim=-1)
    # the reference's one-hot contraction (gather_ce off) and take_along_axis (on) give this same
    # number in f32: every other term of the one-hot sum is an exact 0
    picked = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return (lse - picked).sum()


def train_loss(params, batch: Dict[str, torch.Tensor], cfg, *, loss_chunk: int = 256):
    """Causal LM cross-entropy, sequence-chunked so [B, S, V] never exists.  Returns (loss, metrics).

    The output head (the embedding when tied, ``lm_head`` otherwise) is cast to
    the compute dtype once per call, not per chunk: the same values as a cast
    at each use, with one copy held for the backward.
    """
    x, aux = lm_hidden(params, batch, cfg)
    targets = batch["targets"]
    B, S = targets.shape
    c = min(loss_chunk, S)
    if S % c:
        raise ValueError(f"seq_len {S} is not a multiple of the loss chunk {c}")
    name = _head_name(cfg)
    head = {name: {"table": params[name]["table"].to(_dtype(cfg))}}
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(S // c):
        xx, tt = x[:, i * c:(i + 1) * c], targets[:, i * c:(i + 1) * c]
        if cfg.remat_loss_chunk:  # recompute the chunk's [B, c, V] logits in the backward
            total = total + checkpoint(_chunk_nll, head, xx, tt, cfg, use_reentrant=False, preserve_rng_state=False)
        else:
            total = total + _chunk_nll(head, xx, tt, cfg)
    loss = total / (B * S) + aux
    return loss, {"loss": loss, "moe_aux": aux}


# ---------------------------------------------------------------------------
# caches + decode
# ---------------------------------------------------------------------------


def init_decode_cache(cfg, batch: int, max_len: int, *, device) -> Dict:
    """Stacked-per-position caches: K/V for attention (local layers never hold
    more than the window), the f32 WKV state and token-shift carries for rwkv,
    the conv tail and the f32 SSM state for mamba."""
    dt = _dtype(cfg)
    cache: Dict[str, Any] = {}
    for i, spec in enumerate(cfg.pattern):
        if spec.mixer == "rwkv":
            entry = init_rwkv_cache(cfg, batch, n_layers_of_kind=cfg.n_units, dtype=dt, device=device)
        elif spec.mixer == "mamba":
            entry = init_mamba_cache(cfg, batch, n_layers_of_kind=cfg.n_units, dtype=dt, device=device)
        else:
            T = max_len
            if spec.mixer == "attn_local" and cfg.attn_window:
                T = min(max_len, cfg.attn_window)
            entry = init_kv_cache(cfg, batch, T, n_layers_of_kind=cfg.n_units, dtype=dt, device=device)
        if spec.ffn == "rwkv_cmix":
            entry["cshift"] = torch.zeros((cfg.n_units, batch, 1, cfg.d_model), dtype=dt, device=device)
        cache[f"pos{i}"] = entry
    return cache


def _rolling(cfg, spec, T: int) -> bool:
    # the cache was allocated at min(max_len, window): it rolls exactly when clamped
    return spec.mixer == "attn_local" and bool(cfg.attn_window) and T == cfg.attn_window


def decode_step(params, cache: Dict, token: torch.Tensor, pos, cfg):
    """One decode step.  token: [B, 1]; pos: scalar or [B] per-slot positions.

    Returns (cache, logits [B, 1, V]); the cache is updated in place.
    """
    dt = _dtype(cfg)
    x = embed(params["embed"], token, dtype=dt)
    if cfg.post_block_norm:
        x = _embed_scale(x, cfg)
    pos = torch.as_tensor(pos, dtype=torch.long, device=x.device)
    for u in range(cfg.n_units):
        unit_p = _unit(params["units"], u)
        unit_c = _unit(cache, u)
        for i, spec in enumerate(cfg.pattern):
            lp, lc = unit_p[f"pos{i}"], unit_c[f"pos{i}"]
            h = norm(lp["norm1"], x, kind=cfg.norm)
            if spec.mixer == "rwkv":
                mix = _rwkv_mix(lp, h, lc, cfg, dt)
            elif spec.mixer == "mamba":
                mix, conv, ssm = mamba_decode_step(lp["mixer"], h, lc["conv"], lc["ssm"], cfg, dtype=dt)
                lc["conv"].copy_(conv)
                lc["ssm"].copy_(ssm)
            else:
                T = lc["k"].shape[1]
                rolling = _rolling(cfg, spec, T)
                mix, _, _ = decode_attention_layer(
                    lp["mixer"], h, lc["k"], lc["v"], pos % T if rolling else pos, cfg,
                    kind=spec.mixer, dtype=dt, rolling=rolling, abs_pos=pos,
                )
            x, _ = _block(lp, spec, lc, x, mix, cfg, dt)
    x = norm(params["final_norm"], x, kind=cfg.norm)
    return cache, _logits(params, x, cfg)


def prefill(params, batch: Dict[str, torch.Tensor], cfg, *, max_len: int):
    """Forward over a prompt, building decode caches.  Returns (cache, last_logits [B,1,V]).

    A ring cache shorter than the prompt keeps the last T keys, position p at
    slot ``p % T`` — the slot decode reads and overwrites next.
    """
    dt = _dtype(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens does not fit max_len={max_len}")
    x = _embed_inputs(params, batch, cfg)
    positions = torch.arange(S, device=x.device).expand(B, S)
    cache = init_decode_cache(cfg, B, max_len, device=x.device)
    for u in range(cfg.n_units):
        unit_p = _unit(params["units"], u)
        unit_c = _unit(cache, u)
        for i, spec in enumerate(cfg.pattern):
            lp, lc = unit_p[f"pos{i}"], unit_c[f"pos{i}"]
            h = norm(lp["norm1"], x, kind=cfg.norm)
            if spec.mixer == "rwkv":  # from the zero state of the fresh cache
                mix = _rwkv_mix(lp, h, lc, cfg, dt)
            elif spec.mixer == "mamba":
                mix, conv, ssm = mamba_layer_with_state(lp["mixer"], h, cfg, dtype=dt)
                lc["conv"].copy_(conv)
                lc["ssm"].copy_(ssm)
            else:
                mix, (k_new, v_new) = attention_layer(
                    lp["mixer"], h, positions, cfg, kind=spec.mixer, dtype=dt, return_kv=True,
                )
                T = lc["k"].shape[1]
                for c, new in ((lc["k"], k_new), (lc["v"], v_new)):
                    if T >= S:
                        c[:, :S] = new.to(c.dtype)
                    else:  # ring: position S-T+j goes to slot (S-T+j) % T
                        c.copy_(torch.roll(new[:, S - T:], shifts=S % T, dims=1).to(c.dtype))
            x, _ = _block(lp, spec, lc, x, mix, cfg, dt)
    x = norm(params["final_norm"], x, kind=cfg.norm)
    return cache, _logits(params, x[:, -1:, :], cfg)
