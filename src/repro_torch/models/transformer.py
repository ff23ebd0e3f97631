"""Decoder-only LM composition (``repro.models.transformer``): RMSNorm or
LayerNorm blocks of GQA attention (global or sliding-window layers,
qk-norm, logit softcap) or MLA, over a gated MLP or, past the dense
prefix, a MoE FFN; tied or separate embeddings and gemma2's final logit
softcap; for the VLM, projected patch embeddings prepended to the text.

Layers are grouped into *cycles* (the smallest repeating structural
unit, e.g. gemma2's (local, global)), and the body's parameters are
stacked over cycles, each leaf with a leading ``n_cycles`` axis, as in
the reference, whose ``lax.scan`` over that axis becomes a Python loop
over the cycle index here.  Forward only: there is no remat.

A layer whose mixer (SSM, RG-LRU) or stack (enc-dec) the port does not
run yet raises ``ValueError`` naming ROADMAP A10.4–A10.6, where those
slices are queued.  The check runs where parameters and caches are
built, not on every forward or decode step.

``device`` defaults to CUDA, as at every entry point of the port.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
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


def _require_ported(cfg: ModelConfig, sig: Tuple) -> None:
    """Raise for a layer this slice of the port does not run."""
    kind = sig[0]
    what = None
    if kind != "attn":
        what = f"{kind} mixer"
    elif cfg.encoder is not None:
        what = "encoder-decoder stack"
    if what is not None:
        raise ValueError(f"{cfg.arch_id}: the {what} is not ported yet "
                         "(ROADMAP A10.4-A10.6); the port runs GQA and MLA "
                         "layers over dense and MoE FFNs")


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ModelConfig, i: int,
               device=None) -> Params:
    sig = layer_sig(cfg, i)
    _require_ported(cfg, sig)
    dt = _dtype(cfg)
    a = cfg.attention
    norm_init, _ = make_norm(cfg.norm, cfg.d_model, device)
    p: Params = {"norm1": norm_init(), "norm2": norm_init()}
    if a.kind == "mla":
        p["mixer"] = attn.init_mla(gen, a, cfg.d_model, dt, device)
    else:
        p["mixer"] = attn.init_gqa(gen, a, cfg.d_model, dt, device)
    if sig[2]:
        p["ffn"] = moe_mod.init_moe(gen, cfg.moe, cfg.d_model, dt, device)
    else:
        p["ffn"] = init_gated_mlp(gen, cfg.d_model, cfg.d_ff, dt, device)
    return p


def layer_apply(p: Params, cfg: ModelConfig, sig: Tuple, x: torch.Tensor, *,
                positions: torch.Tensor, chunk: int = 512
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full-sequence layer (train/prefill).  Returns (x, the MoE
    auxiliary loss, or None for a dense FFN)."""
    _, window, is_moe = sig
    a = cfg.attention
    norm_apply = NORM_APPLY[cfg.norm]
    h = norm_apply(p["norm1"], x)
    if a.kind == "mla":
        y = attn.mla_apply(p["mixer"], a, h, positions=positions,
                           window=window, chunk=chunk)
    else:
        y = attn.gqa_apply(p["mixer"], a, h, window=window,
                           positions=positions, chunk=chunk)
    x = x + y
    h2 = norm_apply(p["norm2"], x)
    if is_moe:
        y2, aux = moe_mod.moe_apply(p["ffn"], cfg.moe, h2)
        return x + y2, aux
    return x + gated_mlp_apply(p["ffn"], h2), None


# ---------------------------------------------------------------------------
# Decode-path cache per layer
# ---------------------------------------------------------------------------

def layer_init_cache(cfg: ModelConfig, i: int, batch: int, cache_len: int,
                     long_mode: bool, device=None) -> Params:
    sig = layer_sig(cfg, i)
    _require_ported(cfg, sig)
    _, window, _ = sig
    a = cfg.attention
    L = cache_len
    if window is not None:
        L = min(L, window)
    if long_mode and cfg.long_context == "window":
        L = min(L, cfg.long_window)
    if a.kind == "mla":
        return attn.mla_init_cache(a, batch, L, _dtype(cfg), device)
    return attn.gqa_init_cache(a, batch, L, _dtype(cfg), device)


def layer_decode(p: Params, cfg: ModelConfig, sig: Tuple, x: torch.Tensor,
                 cache: Params, t: torch.Tensor
                 ) -> Tuple[torch.Tensor, Params]:
    a = cfg.attention
    norm_apply = NORM_APPLY[cfg.norm]
    h = norm_apply(p["norm1"], x)
    if a.kind == "mla":
        y, cache = attn.mla_decode(p["mixer"], a, h, cache, t)
    else:
        y, cache = attn.gqa_decode(p["mixer"], a, h, cache, t)
    x = x + y
    h2 = norm_apply(p["norm2"], x)
    if sig[2]:
        y2, _ = moe_mod.moe_apply(p["ffn"], cfg.moe, h2)
    else:
        y2 = gated_mlp_apply(p["ffn"], h2)
    return x + y2, cache


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _stacked(n: int, make) -> Params:
    """The trees ``make(0)``, ..., ``make(n - 1)`` (same structure) stacked
    leaf by leaf on a new leading axis: each tree is made in turn and
    copied into leaves allocated from the first, so at most one unstacked
    tree is held beside the stack (what ``torch.stack`` of all n would
    give, bit for bit, for half the memory)."""
    out = None
    for c in range(n):
        tree = make(c)
        if out is None:
            out = _tree_map(lambda t: t.new_empty((n,) + t.shape), tree)
        for dst, src in zip(_leaves(out), _leaves(tree)):
            dst[c].copy_(src)
        del tree                # freed before the next tree is made
    return out


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


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
    if cfg.modality.kind == "vision":
        p["projector"] = init_linear(gen, cfg.modality.feat_dim,
                                     cfg.d_model, dt, device=device)
    p["prefix"] = [init_layer(gen, cfg, i, device) for i in prefix]
    base = len(prefix)
    p["body"] = _stacked(n_cycles, lambda c: [
        init_layer(gen, cfg, base + c * P + j, device)
        for j in range(P)]) if n_cycles else None
    p["suffix"] = [init_layer(gen, cfg, i, device) for i in suffix]
    return p


def body_sigs(cfg: ModelConfig) -> List[Tuple]:
    prefix, n_cycles, P, _ = layer_plan(cfg)
    base = len(prefix)
    return [layer_sig(cfg, base + j) for j in range(P)]


# ---------------------------------------------------------------------------
# Whole-model forward (train / prefill)
# ---------------------------------------------------------------------------

def embed_inputs(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The text's embeddings scaled by √d_model; for the VLM, with
    ``patches`` (B, n_vis, feat_dim) projected and prepended."""
    dt = _dtype(cfg)
    x = embedding_apply(p["embed"], tokens, compute_dtype=dt)
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    if cfg.modality.kind == "vision" and patches is not None:
        vis = linear_apply(p["projector"], patches.to(dt))
        x = torch.cat([vis, x], dim=1)
    return x


def _logits(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = NORM_APPLY[cfg.norm](p["final_norm"], x)
    if cfg.tie_embeddings:
        logits = unembed_apply(p["embed"], x)
    else:
        logits = linear_apply(p["unembed"], x)
    return softcap(logits.float(), cfg.final_softcap)


def lm_apply(p: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
             patches: Optional[torch.Tensor] = None, chunk: int = 512
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, T) integer.  Returns (the float32 logits (B, T, V) over
    the *text* positions, the MoE auxiliary loss summed over layers, a
    float32 zero where no layer is MoE).  For the VLM, ``patches``
    prepend ``cfg.modality.n_tokens`` positions, and the first that many
    positions' logits are dropped (as in the reference, also where no
    patches were given)."""
    prefix, n_cycles, P, suffix = layer_plan(cfg)
    x = embed_inputs(p, cfg, tokens, patches)
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(lp, sig, x, aux):
        x, a = layer_apply(lp, cfg, sig, x, positions=positions, chunk=chunk)
        return x, aux if a is None else aux + a

    for i, lp in zip(prefix, p["prefix"]):
        x, aux = run(lp, layer_sig(cfg, i), x, aux)
    if p["body"] is not None:
        sigs = body_sigs(cfg)
        for c in range(n_cycles):
            cyc = _cycle(p["body"], c)
            for j in range(P):
                x, aux = run(cyc[j], sigs[j], x, aux)
    for i, lp in zip(suffix, p["suffix"]):
        x, aux = run(lp, layer_sig(cfg, i), x, aux)
    n_vis = cfg.modality.n_tokens if cfg.modality.kind == "vision" else 0
    if n_vis:
        x = x[:, n_vis:]
    return _logits(p, cfg, x), aux


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
    cache["body"] = _stacked(n_cycles, lambda _: [
        layer_init_cache(cfg, base + j, batch, cache_len, long_mode, device)
        for j in range(P)]) if n_cycles else None
    return cache


def lm_decode(p: Params, cfg: ModelConfig, token: torch.Tensor,
              cache: Params, t: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """token: (B,) integer; t: (B,) absolute positions.  One decode step:
    (float32 logits (B, V), the cache with this token written in place).
    The VLM's patches take no part, as in the reference."""
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
