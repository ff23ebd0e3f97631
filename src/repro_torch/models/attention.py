"""Attention: the GQA half of ``repro.models.attention`` (qk-norm, logit
softcap, sliding window), with two paths:

- train/prefill: ``chunked_attention`` over the whole sequence, which in
  the port computes through ``kernels.ops.flash_attention_bthd`` on q, k
  and v as the projections leave them (no KV expansion, no layout copy):
  on a CUDA tensor the hand-written kernel
  (``kernels/csrc/flash_attention.cu``), on the CPU its plain version.
  The reference computes it with a jnp scan over key chunks and calls
  the Pallas kernel its TPU twin.
- decode: one query token against a fixed-capacity KV cache, which may be
  a *ring buffer* of ``window`` slots (the cache positions say which slot
  holds which token).  Plain tensor code, no kernel.

MLA (deepseek-v2 / minicpm3) waits for its slice of the port; the kernel
already takes its k and v of two head dims.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.layers import (init_linear, init_rmsnorm,
                                       linear_apply, rmsnorm_apply, softcap)
from repro_torch.models.rope import apply_rope

Params = Dict[str, object]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Core: full-sequence attention through the flash_attention kernel
# ---------------------------------------------------------------------------

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True,
                      window: Optional[int] = None,
                      logit_softcap: Optional[float] = None,
                      scale: Optional[float] = None,
                      chunk: int = 512,
                      q_offset: int = 0) -> torch.Tensor:
    """q: (B, Tq, Hq, Dk); k: (B, Tk, Hkv, Dk); v: (B, Tk, Hkv, Dv).
    Hq % Hkv == 0.

    Handed as they are to ``ops.flash_attention_bthd``, whose kernel reads
    the KV head of each query head and every stride itself, keeps the
    online softmax's statistics in float32 and never materialises the
    scores; the result is (B, Tq, Hq, Dv), contiguous.  ``q_offset`` is
    the absolute position of q[0] relative to k[0].  Only the causal and
    window masks read positions, and the kernel places queries at ``Tk -
    Tq`` (prefill after a prefix), so with either mask another offset
    raises ``ValueError`` (with the default 0, Tq must equal Tk); with
    neither (``causal=False``, ``window=None``: cross-attention) any
    offset and any Tq, Tk give the same result and are taken.  ``chunk``
    (the reference scan's key-chunk length) is kept for the signature and
    not used: the kernel picks its own tiles.  On a CUDA device an input
    that requires a gradient raises, as the kernel has no backward.
    """
    Tq, Tk = q.shape[1], k.shape[1]
    if (causal or window is not None) and q_offset != Tk - Tq:
        raise ValueError(f"chunked_attention: q_offset={q_offset}; the "
                         f"kernel places q at Tk - Tq = {Tk - Tq}, and the "
                         f"causal or window mask reads positions")
    return ops.flash_attention_bthd(q, k, v, causal=causal, window=window,
                                    logit_softcap=logit_softcap, scale=scale)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *,
                     q_pos: torch.Tensor,
                     cache_positions: torch.Tensor,
                     logit_softcap: Optional[float] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One-token decode.  q: (B, 1, Hq, D); caches: (B, L, Hkv, D).
    ``cache_positions``: (B, L) absolute position of each cache slot, -1
    for empty (ring-buffer semantics fall out of position bookkeeping).
    Grouped layout, no KV expansion: float32 scores, the probabilities
    rounded to the cache's dtype before the float32 product with v, as
    the reference's operands are."""
    B, _, Hq, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    Hkv = k_cache.shape[2]
    Dv = v_cache.shape[-1]
    g = Hq // Hkv
    qh = q.reshape(B, Hkv, g, D)
    s = torch.einsum("bhgd,blhd->bhgl", qh.float(), k_cache.float()) * scale
    s = softcap(s, logit_softcap)
    valid = (cache_positions >= 0) & (cache_positions <= q_pos[:, None])
    s = torch.where(valid[:, None, None], s,
                    torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgl,blhd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, Hq, Dv).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

def init_gqa(gen: torch.Generator, a: AttentionConfig, d_model: int, dtype,
             device=None) -> Params:
    p: Params = {
        "wq": init_linear(gen, d_model, a.n_heads * a.head_dim, dtype,
                          device=device),
        "wk": init_linear(gen, d_model, a.n_kv_heads * a.head_dim, dtype,
                          device=device),
        "wv": init_linear(gen, d_model, a.n_kv_heads * a.head_dim, dtype,
                          device=device),
        "wo": init_linear(gen, a.n_heads * a.head_dim, d_model, dtype,
                          device=device),
    }
    if a.qk_norm:
        p["q_norm"] = init_rmsnorm(a.head_dim, device=device)
        p["k_norm"] = init_rmsnorm(a.head_dim, device=device)
    return p


def gqa_qkv(p: Params, a: AttentionConfig, x: torch.Tensor,
            positions: torch.Tensor):
    B, T, _ = x.shape
    q = linear_apply(p["wq"], x).reshape(B, T, a.n_heads, a.head_dim)
    k = linear_apply(p["wk"], x).reshape(B, T, a.n_kv_heads, a.head_dim)
    v = linear_apply(p["wv"], x).reshape(B, T, a.n_kv_heads, a.head_dim)
    if a.qk_norm:
        q = rmsnorm_apply(p["q_norm"], q)
        k = rmsnorm_apply(p["k_norm"], k)
    q = apply_rope(q, positions, a.rope_theta)
    k = apply_rope(k, positions, a.rope_theta)
    return q, k, v


def gqa_apply(p: Params, a: AttentionConfig, x: torch.Tensor, *,
              window: Optional[int], positions: torch.Tensor,
              chunk: int = 512) -> torch.Tensor:
    """Train/prefill path (full sequence)."""
    q, k, v = gqa_qkv(p, a, x, positions)
    out = chunked_attention(q, k, v, causal=True, window=window,
                            logit_softcap=a.attn_softcap, chunk=chunk)
    B, T = x.shape[:2]
    return linear_apply(p["wo"], out.reshape(B, T, -1))


def gqa_init_cache(a: AttentionConfig, batch: int, length: int, dtype,
                   device=None) -> Params:
    device = resolve_device(device)
    return {
        "k": torch.zeros(batch, length, a.n_kv_heads, a.head_dim,
                         dtype=dtype, device=device),
        "v": torch.zeros(batch, length, a.n_kv_heads, a.head_dim,
                         dtype=dtype, device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.int32,
                          device=device),
    }


def gqa_decode(p: Params, a: AttentionConfig, x: torch.Tensor,
               cache: Params, t: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """x: (B, 1, d).  t: (B,) absolute position of this token.  The cache
    is a ring buffer of ``L`` slots; slot = t mod L (sliding window when
    L < full context).  Unlike the reference, which returns a new cache,
    this writes the token's k, v and position into ``cache`` in place
    (no copy of the cache a step) and returns it."""
    B = x.shape[0]
    L = cache["k"].shape[1]
    q, k, v = gqa_qkv(p, a, x, t[:, None])
    slot = (t % L).long()
    b_idx = torch.arange(B, device=x.device)
    cache["k"][b_idx, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][b_idx, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][b_idx, slot] = t.to(torch.int32)
    out = decode_attention(q, cache["k"], cache["v"], q_pos=t,
                           cache_positions=cache["pos"],
                           logit_softcap=a.attn_softcap)
    return linear_apply(p["wo"], out.reshape(B, 1, -1)), cache
