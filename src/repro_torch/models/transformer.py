"""LM composition (``repro.models.transformer``) covering every family
of the reference: RMSNorm or LayerNorm blocks whose mixer is GQA
attention (global or sliding-window layers, qk-norm, logit softcap),
MLA, the RG-LRU (recurrentgemma's hybrid) or the Mamba-2 SSD (mamba2,
which has no FFN); the FFN a gated MLP or, past the dense prefix, a MoE
FFN; tied or separate embeddings and gemma2's final logit softcap; for
the VLM, projected patch embeddings prepended to the text; for the
enc-dec decoder (seamless), a cross-attention to the encoder's output
(``memory``, from ``encdec.py``) in every layer.

Layers are grouped into *cycles* (the smallest repeating structural
unit, e.g. gemma2's (local, global), recurrentgemma's (rglru, rglru,
attn)), and the body's parameters are stacked over cycles, each leaf
with a leading ``n_cycles`` axis, as in the reference, whose
``lax.scan`` over that axis becomes a Python loop over the cycle index
here.  ``lm_apply(..., remat=True)`` recomputes each cycle in the
backward (``torch.utils.checkpoint``, non-reentrant), as the reference
wraps its cycle in ``jax.checkpoint``; the prefix and suffix layers are
not wrapped, as there.

Under ``shard_hints.activation_sharding(mesh)`` (the train and serve
steps on a mesh with a ``data`` or ``model`` axis; every family) every
rank of a pod runs the
same layers on its blocks (``layers.py``, ``attention.py``, ``moe.py``)
and its share of the pod's sequences, and ``lm_apply`` and ``lm_decode``
return the rank's vocabulary columns of the logits; ``lm_init_cache``
makes the rank's block of the decode cache.  A checkpointed cycle re-enters the
context with the forward's mesh, so its recompute in the backward (on
the autograd engine's thread, which does not inherit the context) takes
the same blocks and issues the same collectives in the same order.

``device`` defaults to CUDA, as at every entry point of the port.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import pytree
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch import sharding
from repro_torch.launch.collectives import copy_to_model
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.shard_hints import (activation_sharding,
                                            axis_env_size, current_mesh)
from repro_torch.models.layers import (NORM_APPLY, block_whole,
                                       embedding_apply, gated_mlp_apply,
                                       init_embedding, init_gated_mlp,
                                       init_linear, linear_apply, make_norm,
                                       softcap, unembed_apply)

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


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ModelConfig, i: int,
               device=None) -> Params:
    kind, _, is_moe = layer_sig(cfg, i)
    dt = _dtype(cfg)
    norm_init, _ = make_norm(cfg.norm, cfg.d_model, device)
    p: Params = {"norm1": norm_init()}
    if kind == "attn":
        a = cfg.attention
        if a.kind == "mla":
            p["mixer"] = attn.init_mla(gen, a, cfg.d_model, dt, device)
        else:
            p["mixer"] = attn.init_gqa(gen, a, cfg.d_model, dt, device)
    elif kind == "rglru":
        p["mixer"] = rglru_mod.init_rglru(gen, cfg.rglru, cfg.d_model, dt,
                                          device)
    elif kind == "ssm":
        p["mixer"] = ssm_mod.init_ssm(gen, cfg.ssm, cfg.d_model, dt, device)
    else:
        raise ValueError(kind)
    if cfg.family != "ssm":     # mamba2: one mixer a block, no FFN
        p["norm2"] = norm_init()
        if is_moe:
            p["ffn"] = moe_mod.init_moe(gen, cfg.moe, cfg.d_model, dt,
                                        device)
        else:
            p["ffn"] = init_gated_mlp(gen, cfg.d_model, cfg.d_ff, dt,
                                      device)
    if cfg.encoder is not None:
        # enc-dec decoder layer: cross-attention to the encoder's memory
        p["norm_x"] = norm_init()
        p["xattn"] = _init_xattn(gen, cfg, dt, device)
    return p


def _init_xattn(gen: torch.Generator, cfg: ModelConfig, dt,
                device=None) -> Params:
    a = cfg.attention
    ed = cfg.encoder.d_model
    hd = a.n_heads * a.head_dim
    return {
        "wq": init_linear(gen, cfg.d_model, hd, dt, device=device),
        "wk": init_linear(gen, ed, hd, dt, device=device),
        "wv": init_linear(gen, ed, hd, dt, device=device),
        "wo": init_linear(gen, hd, cfg.d_model, dt, device=device),
    }


def _xattn_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 memory: torch.Tensor) -> torch.Tensor:
    """Cross-attention of x (B, T, d) to ``memory`` (B, S, encoder
    d_model): no mask and no RoPE, any T and S (T = 1 at decode).  Under a
    mesh on the rank's n_heads / M heads (every head where
    ``sharding.heads_whole``: the column blocks gathered, ``wo`` handed
    its row block's columns): ``wq`` reads the residual, ``wk`` and
    ``wv`` the memory (to which ``lm_apply`` applied *f* once), each
    column-parallel, ``wo`` row-parallel; every head on every rank with
    no *f* or *g* where the axis does not split wo's rows
    (``_xattn_whole``)."""
    a = cfg.attention
    B, T, d = x.shape
    S, ed = memory.shape[1:]
    hd = a.head_dim
    n = a.n_heads * hd
    mesh = current_mesh()
    whole = _xattn_whole(cfg)
    hw = mesh is not None and not whole and sharding.heads_whole(
        a, axis_env_size("model"))
    if mesh is not None:
        x = copy_to_model(x, mesh, not whole)
    q, k, v = (attn._head_cols(linear_apply(p[w], y, "col", (w_in, n),
                                            whole), hw,
                               mesh).reshape(B, t, -1, hd)
               for w, y, t, w_in in (("wq", x, T, d), ("wk", memory, S, ed),
                                     ("wv", memory, S, ed)))
    out = attn.chunked_attention(q, k, v, causal=False)
    return attn._out(p, a, out.reshape(B, T, -1), d, hd)


def _xattn_whole(cfg: ModelConfig) -> bool:
    """Whether the cross-attention runs whole over the active mesh's
    ``model`` axis (``layers.block_whole`` of wo's rows)."""
    return block_whole(cfg.attention.n_heads * cfg.attention.head_dim)


def _xattn_and_ffn(p: Params, cfg: ModelConfig, sig: Tuple,
                   x: torch.Tensor, memory: Optional[torch.Tensor],
                   moe_route: str = "dense"
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """What follows the mixer's residual: the cross-attention where the
    layer has one and ``memory`` is given, then the FFN where the layer
    has one (a MoE FFN by ``moe_route``, ``moe.moe_apply``'s).  Returns
    (x, the MoE auxiliary loss or None)."""
    norm_apply = NORM_APPLY[cfg.norm]
    if memory is not None and "xattn" in p:
        x = x + _xattn_apply(p["xattn"], cfg, norm_apply(p["norm_x"], x),
                             memory)
    if "norm2" not in p:
        return x, None
    h2 = norm_apply(p["norm2"], x)
    if sig[2]:
        y2, aux = moe_mod.moe_apply(p["ffn"], cfg.moe, h2, moe_route)
        return x + y2, aux
    return x + gated_mlp_apply(p["ffn"], h2, cfg.d_ff), None


def layer_apply(p: Params, cfg: ModelConfig, sig: Tuple, x: torch.Tensor, *,
                positions: torch.Tensor,
                memory: Optional[torch.Tensor] = None, chunk: int = 512,
                moe_route: str = "dense"
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full-sequence layer (train/prefill).  Returns (x, the MoE
    auxiliary loss, or None where the layer's FFN is dense or absent)."""
    kind, window, _ = sig
    h = NORM_APPLY[cfg.norm](p["norm1"], x)
    if kind == "attn":
        a = cfg.attention
        if a.kind == "mla":
            y = attn.mla_apply(p["mixer"], a, h, positions=positions,
                               window=window, chunk=chunk)
        else:
            y = attn.gqa_apply(p["mixer"], a, h, window=window,
                               positions=positions, chunk=chunk)
    elif kind == "rglru":
        y = rglru_mod.rglru_apply(p["mixer"], cfg.rglru, h)
    else:
        y = ssm_mod.ssm_apply(p["mixer"], cfg.ssm, cfg.d_model, h)
    return _xattn_and_ffn(p, cfg, sig, x + y, memory, moe_route)


# ---------------------------------------------------------------------------
# Decode-path cache per layer
# ---------------------------------------------------------------------------

def layer_init_cache(cfg: ModelConfig, i: int, batch: int, cache_len: int,
                     long_mode: bool, device=None) -> Params:
    kind, window, _ = layer_sig(cfg, i)
    dt = _dtype(cfg)
    if kind == "rglru":
        return rglru_mod.rglru_init_state(cfg.rglru, cfg.d_model, batch, dt,
                                          device)
    if kind == "ssm":
        return ssm_mod.ssm_init_state(cfg.ssm, cfg.d_model, batch, dt,
                                      device)
    a = cfg.attention
    L = cache_len
    if window is not None:
        L = min(L, window)
    if long_mode and cfg.long_context == "window":
        L = min(L, cfg.long_window)
    if a.kind == "mla":
        return attn.mla_init_cache(a, batch, L, dt, device)
    return attn.gqa_init_cache(a, batch, L, dt, device)


def layer_decode(p: Params, cfg: ModelConfig, sig: Tuple, x: torch.Tensor,
                 cache: Params, t: torch.Tensor,
                 memory: Optional[torch.Tensor] = None, *,
                 moe_route: str = "dense", split: Optional[str] = None
                 ) -> Tuple[torch.Tensor, Params]:
    """One token through layer ``sig``; under a mesh ``cache`` is the
    rank's block and ``split`` the axis its length is split over
    (``attention``'s decode)."""
    kind = sig[0]
    h = NORM_APPLY[cfg.norm](p["norm1"], x)
    if kind == "attn":
        a = cfg.attention
        if a.kind == "mla":
            y, cache = attn.mla_decode(p["mixer"], a, h, cache, t, split)
        else:
            y, cache = attn.gqa_decode(p["mixer"], a, h, cache, t, split)
    elif kind == "rglru":
        y, cache = rglru_mod.rglru_decode(p["mixer"], cfg.rglru, h, cache)
    else:
        y, cache = ssm_mod.ssm_decode(p["mixer"], cfg.ssm, cfg.d_model, h,
                                      cache)
    x, _ = _xattn_and_ffn(p, cfg, sig, x + y, memory, moe_route)
    return x, cache


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------

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
            out = pytree.tree_map(lambda t: t.new_empty((n,) + t.shape), tree)
        for dst, src in zip(pytree.leaves(out), pytree.leaves(tree)):
            dst[c].copy_(src)
        del tree                # freed before the next tree is made
    return out


def _cycle(body: Params, c: int) -> Params:
    """Cycle ``c`` of the stacked body: views, no copies."""
    return pytree.tree_map(lambda t: t[c], body)


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
    ``patches`` (B, n_vis, feat_dim) projected and prepended.  Under a
    mesh the projector's output is whole on every rank, as the residual
    stream is: its weight gathered over each axis that splits it
    (``linear_apply(..., whole=True)``; the backward keeps the rank's
    block of the gradient)."""
    dt = _dtype(cfg)
    x = embedding_apply(p["embed"], tokens, compute_dtype=dt,
                        whole_vocab=_vocab_whole(cfg), d_model=cfg.d_model)
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    if cfg.modality.kind == "vision" and patches is not None:
        vis = linear_apply(p["projector"], patches.to(dt), "col",
                           (cfg.modality.feat_dim, cfg.d_model), whole=True)
        x = torch.cat([vis, x], dim=1)
    return x


def _vocab_whole(cfg: ModelConfig) -> bool:
    """Whether the active mesh's ``model`` axis keeps ``cfg``'s vocabulary
    whole (``sharding.vocab_whole``)."""
    return sharding.vocab_whole(cfg.vocab, axis_env_size("model"))


def _logits(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """float32 logits, softcapped; under a mesh the rank's vocabulary
    columns (the softcap is elementwise), every column where the ``model``
    axis keeps the vocabulary whole (``_vocab_whole``: no *f*, the logits
    and what follows them are the same on every ``model`` rank)."""
    x = NORM_APPLY[cfg.norm](p["final_norm"], x)
    whole = _vocab_whole(cfg)
    if cfg.tie_embeddings:
        logits = unembed_apply(p["embed"], x, whole_vocab=whole)
    else:
        mesh = current_mesh()
        if mesh is not None:
            x = copy_to_model(x, mesh, not whole)
        logits = linear_apply(p["unembed"], x, "col",
                              (cfg.d_model, cfg.vocab), whole)
    return softcap(logits.float(), cfg.final_softcap)


def lm_apply(p: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
             patches: Optional[torch.Tensor] = None,
             memory: Optional[torch.Tensor] = None, remat: bool = True,
             chunk: int = 512, moe_route: str = "dense"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, T) integer.  Returns (the float32 logits (B, T, V) over
    the *text* positions (under a mesh, the rank's vocabulary columns),
    the MoE auxiliary loss summed over layers, a float32 zero where no
    layer is MoE).  For the VLM, ``patches``
    prepend ``cfg.modality.n_tokens`` positions, and the first that many
    positions' logits are dropped (as in the reference, also where no
    patches were given).  For the enc-dec decoder, every layer attends to
    ``memory`` (B, S, encoder d_model), the encoder's output.  A MoE
    layer runs ``moe.moe_apply``'s ``moe_route``.  With
    ``remat``, where autograd records (grad mode on, and the body's
    parameters or the embeddings require grad), each cycle of the body
    keeps only its input for the backward, which runs the cycle again
    (flash_attention's forward kernel included); elsewhere it changes
    nothing."""
    prefix, n_cycles, P, suffix = layer_plan(cfg)
    x = embed_inputs(p, cfg, tokens, patches)
    if memory is not None and current_mesh() is not None:
        # *f* once: every layer's wk and wv add their part of the memory's
        # gradient, summed over ``model`` in one all-reduce (none where
        # the cross-attention runs whole)
        memory = copy_to_model(memory, current_mesh(), not _xattn_whole(cfg))
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(lp, sig, x, aux):
        x, a = layer_apply(lp, cfg, sig, x, positions=positions,
                           memory=memory, chunk=chunk, moe_route=moe_route)
        return x, aux if a is None else aux + a

    for i, lp in zip(prefix, p["prefix"]):
        x, aux = run(lp, layer_sig(cfg, i), x, aux)
    if p["body"] is not None:
        sigs = body_sigs(cfg)
        mesh = current_mesh()

        def cycle(x, aux, cyc):
            # also in the recompute
            with activation_sharding(mesh):
                for j in range(P):
                    x, aux = run(cyc[j], sigs[j], x, aux)
            return x, aux

        wrap = remat and torch.is_grad_enabled() and (
            x.requires_grad or any(t.requires_grad
                                   for t in pytree.leaves(p["body"])))
        for c in range(n_cycles):
            cyc = _cycle(p["body"], c)
            if wrap:
                x, aux = checkpoint(cycle, x, aux, cyc, use_reentrant=False)
            else:
                x, aux = cycle(x, aux, cyc)
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
                  long_mode: bool = False, device=None, *, mesh=None,
                  batch_sharded: Optional[bool] = None,
                  baseline_decode: bool = False) -> Params:
    """The decode cache of ``batch`` requests, ``cache_len`` slots a layer
    (a window's layer fewer).  On a ``mesh`` with a ``data`` or ``model``
    axis above 1, only this rank's block of it, as
    ``sharding.cache_shardings`` places it (``batch_sharded`` defaults to
    ``sharding.default_batch_sharded``): empty slots (position -1) and zeros,
    allocated at the block's shape."""
    device = resolve_device(device)
    if sharding.intra_pod(mesh):
        whole = lm_init_cache(cfg, batch, cache_len, long_mode, "meta")
        if batch_sharded is None:
            batch_sharded = sharding.default_batch_sharded(cfg, batch, mesh)
        sharding.check_cache_placement(cfg, mesh, batch_sharded, batch)
        return pytree.tree_map(
            lambda t: torch.full(tuple(t.shape), -1 if t.dtype ==
                                 torch.int32 else 0, dtype=t.dtype,
                                 device=device),
            sharding.local_cache(whole, mesh, batch_sharded=batch_sharded,
                                 baseline_decode=baseline_decode))
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
              cache: Params, t: torch.Tensor, *,
              memory: Optional[torch.Tensor] = None,
              moe_route: str = "dense", split: Optional[str] = None
              ) -> Tuple[torch.Tensor, Params]:
    """token: (B,) integer; t: (B,) absolute positions.  One decode step:
    (float32 logits (B, V), ``cache`` itself).  Every state is written in
    place into the cache's own tensors, not returned anew as in the
    reference: the attention layers' KV ring (k, v and the slot's
    position; MLA's compressed c_kv), the SSD layers' conv history and
    float32 state, the RG-LRU layers' conv history and float32 h; the
    stacked body's per-cycle caches are views of the stack, so the
    writes land there.  The enc-dec decoder attends to ``memory``, the
    encoder's output; the VLM's patches take no part, as in the
    reference.  Under ``shard_hints.activation_sharding(mesh)`` the
    tokens are the rank's rows, ``cache`` its block (``lm_init_cache(...,
    mesh=)``), ``split`` the axis its attention caches' length is split
    over (``sharding.cache_split``), and the logits the rank's vocabulary
    columns."""
    prefix, n_cycles, P, suffix = layer_plan(cfg)
    dt = _dtype(cfg)
    x = embedding_apply(p["embed"], token[:, None], compute_dtype=dt,
                        whole_vocab=_vocab_whole(cfg), d_model=cfg.d_model)
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    kw = {"moe_route": moe_route, "split": split}

    for i, lp, lc in zip(prefix, p["prefix"], cache["prefix"]):
        x, _ = layer_decode(lp, cfg, layer_sig(cfg, i), x, lc, t, memory,
                            **kw)
    if p["body"] is not None:
        sigs = body_sigs(cfg)
        for c in range(n_cycles):
            cyc, cyc_cache = _cycle(p["body"], c), _cycle(cache["body"], c)
            for j in range(P):
                x, _ = layer_decode(cyc[j], cfg, sigs[j], x, cyc_cache[j], t,
                                    memory, **kw)
    for i, lp, lc in zip(suffix, p["suffix"], cache["suffix"]):
        x, _ = layer_decode(lp, cfg, layer_sig(cfg, i), x, lc, t, memory,
                            **kw)
    return _logits(p, cfg, x)[:, 0], cache
