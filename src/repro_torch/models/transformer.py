"""Decoder-only LM composition (``repro.models.transformer``), the
dense-GQA subset: RMSNorm or LayerNorm blocks of GQA attention (global
or sliding-window layers, qk-norm, logit softcap) and a gated MLP, with
tied or separate embeddings and gemma2's final logit softcap.

Layers are grouped into *cycles* (the smallest repeating structural
unit, e.g. gemma2's (local, global)), and the body's parameters are
stacked over cycles, each leaf with a leading ``n_cycles`` axis, as in
the reference, whose ``lax.scan`` over that axis becomes a Python loop
over the cycle index here.  Forward only: there is no remat.

A layer whose kind (RG-LRU, SSM), attention kind (MLA) or family (MoE,
enc-dec, VLM) the port does not run yet raises ``ValueError`` naming
ROADMAP item A10, where those slices are queued.  The check runs where
parameters and caches are built, not on every forward or decode step.

``device`` defaults to CUDA, as at every entry point of the port.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (NORM_APPLY, embedding_apply,
                                       gated_mlp_apply, init_embedding,
                                       init_gated_mlp, init_linear,
                                       linear_apply, make_norm, softcap,
                                       unembed_apply)

Params = Dict[str, object]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Layer structure
# ---------------------------------------------------------------------------

def layer_sig(cfg: ModelConfig, i: int) -> Tuple:
    """Structural signature of layer i: (mixer, window, is_moe)."""
    kind = cfg.block_kind(i)
    window = cfg.attn_window(i) if kind == "attn" else None
    is_moe = bool(cfg.moe.n_experts) and i >= cfg.moe.first_dense_layers
    return (kind, window, is_moe)


def cycle_period(cfg: ModelConfig) -> int:
    p = len(cfg.attention.layer_pattern)
    if cfg.rglru is not None:
        p = p * len(cfg.rglru.block_pattern) // math.gcd(
            p, len(cfg.rglru.block_pattern))
    return p


def layer_plan(cfg: ModelConfig) -> Tuple[List[int], int, int, List[int]]:
    """Returns (prefix_layers, n_cycles, period, suffix_layers)."""
    start = cfg.moe.first_dense_layers if cfg.moe.n_experts else 0
    start = min(start, cfg.n_layers)
    P = cycle_period(cfg)
    body = cfg.n_layers - start
    n_cycles = body // P
    n_suffix = body - n_cycles * P
    prefix = list(range(start))
    suffix = list(range(cfg.n_layers - n_suffix, cfg.n_layers))
    return prefix, n_cycles, P, suffix


def _require_dense_gqa(cfg: ModelConfig, sig: Tuple) -> None:
    """Raise for a layer this slice of the port does not run."""
    kind, _, is_moe = sig
    what = None
    if kind != "attn":
        what = f"{kind} mixer"
    elif cfg.attention.kind != "gqa":
        what = f"{cfg.attention.kind} attention"
    elif is_moe:
        what = "MoE FFN"
    elif cfg.encoder is not None:
        what = "encoder-decoder stack"
    elif cfg.modality.kind != "none":
        what = f"{cfg.modality.kind} frontend"
    if what is not None:
        raise ValueError(f"{cfg.arch_id}: the {what} is not ported yet "
                         "(ROADMAP A10); the port runs dense GQA layers")


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ModelConfig, i: int,
               device=None) -> Params:
    _require_dense_gqa(cfg, layer_sig(cfg, i))
    dt = _dtype(cfg)
    norm_init, _ = make_norm(cfg.norm, cfg.d_model, device)
    p: Params = {"norm1": norm_init(), "norm2": norm_init()}
    p["mixer"] = attn.init_gqa(gen, cfg.attention, cfg.d_model, dt, device)
    p["ffn"] = init_gated_mlp(gen, cfg.d_model, cfg.d_ff, dt, device)
    return p


def layer_apply(p: Params, cfg: ModelConfig, sig: Tuple, x: torch.Tensor, *,
                positions: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Full-sequence layer (train/prefill)."""
    _, window, _ = sig
    norm_apply = NORM_APPLY[cfg.norm]
    h = norm_apply(p["norm1"], x)
    x = x + attn.gqa_apply(p["mixer"], cfg.attention, h, window=window,
                           positions=positions, chunk=chunk)
    h2 = norm_apply(p["norm2"], x)
    return x + gated_mlp_apply(p["ffn"], h2)


# ---------------------------------------------------------------------------
# Decode-path cache per layer
# ---------------------------------------------------------------------------

def layer_init_cache(cfg: ModelConfig, i: int, batch: int, cache_len: int,
                     long_mode: bool, device=None) -> Params:
    sig = layer_sig(cfg, i)
    _require_dense_gqa(cfg, sig)
    _, window, _ = sig
    L = cache_len
    if window is not None:
        L = min(L, window)
    if long_mode and cfg.long_context == "window":
        L = min(L, cfg.long_window)
    return attn.gqa_init_cache(cfg.attention, batch, L, _dtype(cfg), device)


def layer_decode(p: Params, cfg: ModelConfig, sig: Tuple, x: torch.Tensor,
                 cache: Params, t: torch.Tensor
                 ) -> Tuple[torch.Tensor, Params]:
    norm_apply = NORM_APPLY[cfg.norm]
    h = norm_apply(p["norm1"], x)
    y, cache = attn.gqa_decode(p["mixer"], cfg.attention, h, cache, t)
    x = x + y
    h2 = norm_apply(p["norm2"], x)
    return x + gated_mlp_apply(p["ffn"], h2), cache


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _tree_stack(trees: List[Params]) -> Params:
    """Stack same-structured trees leaf by leaf on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_tree_stack([t[j] for t in trees]) for j in range(len(first))]
    return torch.stack(trees)


def _cycle(body: Params, c: int) -> Params:
    """Cycle ``c`` of the stacked body: views, no copies."""
    return _tree_map(lambda t: t[c], body)


def init_lm(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    device = resolve_device(device)
    dt = _dtype(cfg)
    prefix, n_cycles, P, suffix = layer_plan(cfg)
    p: Params = {"embed": init_embedding(gen, cfg.vocab, cfg.d_model, dt,
                                         device)}
    norm_init, _ = make_norm(cfg.norm, cfg.d_model, device)
    p["final_norm"] = norm_init()
    if not cfg.tie_embeddings:
        p["unembed"] = init_linear(gen, cfg.d_model, cfg.vocab, dt,
                                   device=device)
    p["prefix"] = [init_layer(gen, cfg, i, device) for i in prefix]
    base = len(prefix)
    cycles = [[init_layer(gen, cfg, base + c * P + j, device)
               for j in range(P)] for c in range(n_cycles)]
    p["body"] = _tree_stack(cycles) if cycles else None
    p["suffix"] = [init_layer(gen, cfg, i, device) for i in suffix]
    return p


def body_sigs(cfg: ModelConfig) -> List[Tuple]:
    prefix, n_cycles, P, _ = layer_plan(cfg)
    base = len(prefix)
    return [layer_sig(cfg, base + j) for j in range(P)]


# ---------------------------------------------------------------------------
# Whole-model forward (train / prefill)
# ---------------------------------------------------------------------------

def embed_inputs(p: Params, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    dt = _dtype(cfg)
    x = embedding_apply(p["embed"], tokens, compute_dtype=dt)
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)


def _logits(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = NORM_APPLY[cfg.norm](p["final_norm"], x)
    if cfg.tie_embeddings:
        logits = unembed_apply(p["embed"], x)
    else:
        logits = linear_apply(p["unembed"], x)
    return softcap(logits.float(), cfg.final_softcap)


def lm_apply(p: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
             chunk: int = 512) -> torch.Tensor:
    """tokens: (B, T) integer.  Returns the float32 logits (B, T, V)."""
    prefix, n_cycles, P, suffix = layer_plan(cfg)
    x = embed_inputs(p, cfg, tokens)
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)

    for i, lp in zip(prefix, p["prefix"]):
        x = layer_apply(lp, cfg, layer_sig(cfg, i), x, positions=positions,
                        chunk=chunk)
    if p["body"] is not None:
        sigs = body_sigs(cfg)
        for c in range(n_cycles):
            cyc = _cycle(p["body"], c)
            for j in range(P):
                x = layer_apply(cyc[j], cfg, sigs[j], x, positions=positions,
                                chunk=chunk)
    for i, lp in zip(suffix, p["suffix"]):
        x = layer_apply(lp, cfg, layer_sig(cfg, i), x, positions=positions,
                        chunk=chunk)
    return _logits(p, cfg, x)


# ---------------------------------------------------------------------------
# Whole-model decode
# ---------------------------------------------------------------------------

def lm_init_cache(cfg: ModelConfig, batch: int, cache_len: int,
                  long_mode: bool = False, device=None) -> Params:
    device = resolve_device(device)
    prefix, n_cycles, P, suffix = layer_plan(cfg)
    base = len(prefix)
    cache: Params = {
        "prefix": [layer_init_cache(cfg, i, batch, cache_len, long_mode,
                                    device) for i in prefix],
        "suffix": [layer_init_cache(cfg, i, batch, cache_len, long_mode,
                                    device) for i in suffix],
    }
    cyc = [[layer_init_cache(cfg, base + j, batch, cache_len, long_mode,
                             device) for j in range(P)]
           for _ in range(n_cycles)]
    cache["body"] = _tree_stack(cyc) if cyc else None
    return cache


def lm_decode(p: Params, cfg: ModelConfig, token: torch.Tensor,
              cache: Params, t: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """token: (B,) integer; t: (B,) absolute positions.  One decode step:
    (float32 logits (B, V), the cache with this token written in place)."""
    prefix, n_cycles, P, suffix = layer_plan(cfg)
    dt = _dtype(cfg)
    x = embedding_apply(p["embed"], token[:, None], compute_dtype=dt)
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)

    for i, lp, lc in zip(prefix, p["prefix"], cache["prefix"]):
        x, _ = layer_decode(lp, cfg, layer_sig(cfg, i), x, lc, t)
    if p["body"] is not None:
        sigs = body_sigs(cfg)
        for c in range(n_cycles):
            cyc, cyc_cache = _cycle(p["body"], c), _cycle(cache["body"], c)
            for j in range(P):
                x, _ = layer_decode(cyc[j], cfg, sigs[j], x, cyc_cache[j], t)
    for i, lp, lc in zip(suffix, p["suffix"], cache["suffix"]):
        x, _ = layer_decode(lp, cfg, layer_sig(cfg, i), x, lc, t)
    return _logits(p, cfg, x)[:, 0], cache
