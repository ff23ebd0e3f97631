"""Attention (``repro.models.attention``): GQA (qk-norm, logit softcap,
sliding window) and MLA (multi-head latent attention, deepseek-v2 and
minicpm3), with two paths:

- train/prefill: ``chunked_attention`` over the whole sequence, which in
  the port computes through ``kernels.ops.flash_attention_bthd`` on q, k
  and v as the projections leave them (no KV expansion, no layout copy):
  on a CUDA tensor the hand-written kernel
  (``kernels/csrc/flash_attention.cu``), on the CPU its plain version;
  training differentiates it through ``ops.FlashAttention`` (that
  forward, a plain float32 backward).
  The reference computes it with a jnp scan over key chunks and calls
  the Pallas kernel its TPU twin.
- decode: one query token against a fixed-capacity KV cache, which may be
  a *ring buffer* of ``window`` slots (the cache positions say which slot
  holds which token).  Plain tensor code, no kernel.

Under ``shard_hints.activation_sharding(mesh)`` (the train step on a mesh
with a ``model`` axis) GQA runs on the rank's heads: n_heads / M query
heads over n_kv_heads / M KV heads (the column blocks of wq, wk, wv,
whole heads each), the kernel on those, and wo row-parallel.

MLA's prefill expands K and V from the latent and hands the kernel k and
v of their own head dims, v a view of the expansion; its decode takes
the *absorbed* form in float32, scores against the compressed ``ckv``
and ``krope`` cache directly, never re-expanding K.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.collectives import copy_to_model
from repro_torch.models.layers import (init_linear, init_normal, init_rmsnorm,
                                       linear_apply, rmsnorm_apply, softcap)
from repro_torch.models.rope import apply_rope
from repro_torch.models.shard_hints import axis_env_size, current_mesh

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
    not used: the kernel picks its own tiles.  Under autograd (grad mode
    on, an input that requires grad) the call goes through
    ``ops.FlashAttention``: the same forward, and the exact float32
    gradient of its function in the backward.
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
    """(q, k, v) after qk-norm and RoPE: (B, T, heads, head_dim), the
    rank's n_heads / M and n_kv_heads / M heads under a mesh (M its
    ``model`` size, 1 without one)."""
    B, T, _ = x.shape
    m = axis_env_size("model")
    mesh = current_mesh()
    if mesh is not None:
        x = copy_to_model(x, mesh)
    q = linear_apply(p["wq"], x, "col").reshape(B, T, a.n_heads // m,
                                                 a.head_dim)
    k = linear_apply(p["wk"], x, "col").reshape(B, T, a.n_kv_heads // m,
                                                 a.head_dim)
    v = linear_apply(p["wv"], x, "col").reshape(B, T, a.n_kv_heads // m,
                                                 a.head_dim)
    if a.qk_norm:
        q = rmsnorm_apply(p["q_norm"], q)
        k = rmsnorm_apply(p["k_norm"], k)
    q = apply_rope(q, positions, a.rope_theta)
    k = apply_rope(k, positions, a.rope_theta)
    return q, k, v


def gqa_apply(p: Params, a: AttentionConfig, x: torch.Tensor, *,
              window: Optional[int], positions: torch.Tensor,
              chunk: int = 512) -> torch.Tensor:
    """Train/prefill path (full sequence): under a mesh on the rank's
    heads, wo's partial products summed over ``model``."""
    q, k, v = gqa_qkv(p, a, x, positions)
    out = chunked_attention(q, k, v, causal=True, window=window,
                            logit_softcap=a.attn_softcap, chunk=chunk)
    B, T = x.shape[:2]
    return linear_apply(p["wo"], out.reshape(B, T, -1), "row")


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


# ---------------------------------------------------------------------------
# MLA block (deepseek-v2 / minicpm3)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, a: AttentionConfig, d_model: int, dtype,
             device=None) -> Params:
    h = a.n_heads
    qhead = a.nope_head_dim + a.rope_head_dim
    p: Params = {}
    if a.q_lora_rank:
        p["wdq"] = init_linear(gen, d_model, a.q_lora_rank, dtype,
                               device=device)
        p["q_norm"] = init_rmsnorm(a.q_lora_rank, device=device)
        p["wuq"] = init_linear(gen, a.q_lora_rank, h * qhead, dtype,
                               device=device)
    else:
        p["wq"] = init_linear(gen, d_model, h * qhead, dtype, device=device)
    p["wdkv"] = init_linear(gen, d_model, a.kv_lora_rank + a.rope_head_dim,
                            dtype, device=device)
    p["kv_norm"] = init_rmsnorm(a.kv_lora_rank, device=device)
    # up-projection, kept 3-D so decode can use the absorbed form
    p["wukv"] = init_normal(gen, (a.kv_lora_rank, h,
                                  a.nope_head_dim + a.v_head_dim),
                            a.kv_lora_rank ** -0.5, dtype, device)
    p["wo"] = init_linear(gen, h * a.v_head_dim, d_model, dtype,
                          device=device)
    return p


def _mla_q(p: Params, a: AttentionConfig, x: torch.Tensor,
           positions: torch.Tensor):
    B, T, _ = x.shape
    if a.q_lora_rank:
        cq = rmsnorm_apply(p["q_norm"], linear_apply(p["wdq"], x))
        q = linear_apply(p["wuq"], cq)
    else:
        q = linear_apply(p["wq"], x)
    q = q.reshape(B, T, a.n_heads, a.nope_head_dim + a.rope_head_dim)
    q_nope = q[..., :a.nope_head_dim]
    q_rope = apply_rope(q[..., a.nope_head_dim:], positions, a.rope_theta)
    return q_nope, q_rope


def _mla_ckv(p: Params, a: AttentionConfig, x: torch.Tensor,
             positions: torch.Tensor):
    ckv_kr = linear_apply(p["wdkv"], x)
    c_kv = rmsnorm_apply(p["kv_norm"], ckv_kr[..., :a.kv_lora_rank])
    k_rope = ckv_kr[..., a.kv_lora_rank:][:, :, None, :]   # (B,T,1,rope_dim)
    k_rope = apply_rope(k_rope, positions, a.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_apply(p: Params, a: AttentionConfig, x: torch.Tensor, *,
              positions: torch.Tensor, window: Optional[int] = None,
              chunk: int = 512) -> torch.Tensor:
    """Train/prefill: expand K and V from the latent and run
    ``chunked_attention`` at scale (nope + rope) ** -0.5.  v is the view
    ``kv[..., nope:]`` of the expansion, which the kernel reads in place
    (at both full widths its rows start 16-byte aligned, its strides
    multiples of 8)."""
    B, T, _ = x.shape
    h = a.n_heads
    q_nope, q_rope = _mla_q(p, a, x, positions)
    c_kv, k_rope = _mla_ckv(p, a, x, positions)
    wukv = p["wukv"].to(x.dtype)
    kv = (c_kv @ wukv.flatten(1)).unflatten(-1, wukv.shape[1:])  # (B,T,h,·)
    k_nope = kv[..., :a.nope_head_dim]
    v = kv[..., a.nope_head_dim:]
    k_rope_b = k_rope[:, :, None, :].expand(B, T, h, a.rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    scale = (a.nope_head_dim + a.rope_head_dim) ** -0.5
    out = chunked_attention(q, k, v, causal=True, window=window,
                            scale=scale, chunk=chunk)
    return linear_apply(p["wo"], out.reshape(B, T, -1))


def mla_init_cache(a: AttentionConfig, batch: int, length: int, dtype,
                   device=None) -> Params:
    device = resolve_device(device)
    return {
        "ckv": torch.zeros(batch, length, a.kv_lora_rank, dtype=dtype,
                           device=device),
        "krope": torch.zeros(batch, length, a.rope_head_dim, dtype=dtype,
                             device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.int32,
                          device=device),
    }


def mla_decode(p: Params, a: AttentionConfig, x: torch.Tensor,
               cache: Params, t: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """Absorbed decode, in float32: W_uk folded into q, scores taken
    against the compressed cache, W_uv applied to the weighted latent.
    The cache is a ring buffer of ``L`` slots (slot = t mod L); this
    writes the token's c_kv, k_rope and position into it in place, as
    ``gqa_decode`` does, and returns it."""
    B = x.shape[0]
    L = cache["ckv"].shape[1]
    q_nope, q_rope = _mla_q(p, a, x, t[:, None])           # (B,1,h,*)
    c_kv, k_rope = _mla_ckv(p, a, x, t[:, None])           # (B,1,r),(B,1,rd)
    slot = (t % L).long()
    b_idx = torch.arange(B, device=x.device)
    cache["ckv"][b_idx, slot] = c_kv[:, 0].to(cache["ckv"].dtype)
    cache["krope"][b_idx, slot] = k_rope[:, 0].to(cache["krope"].dtype)
    cache["pos"][b_idx, slot] = t.to(torch.int32)
    wukv = p["wukv"].float()
    w_uk = wukv[..., :a.nope_head_dim]                     # (r,h,nope)
    w_uv = wukv[..., a.nope_head_dim:]                     # (r,h,v)
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].float(), w_uk)
    ckv_f = cache["ckv"].float()                           # (B,L,r)
    s_nope = torch.einsum("bhr,blr->bhl", q_abs, ckv_f)
    s_rope = torch.einsum("bhd,bld->bhl", q_rope[:, 0].float(),
                          cache["krope"].float())
    scale = (a.nope_head_dim + a.rope_head_dim) ** -0.5
    s = (s_nope + s_rope) * scale
    valid = (cache["pos"] >= 0) & (cache["pos"] <= t[:, None])
    s = torch.where(valid[:, None], s,
                    torch.full((), NEG_INF, device=s.device))
    pr = torch.softmax(s, dim=-1)
    out_c = torch.einsum("bhl,blr->bhr", pr, ckv_f)        # (B,h,r)
    out = torch.einsum("bhr,rhv->bhv", out_c, w_uv)        # (B,h,v)
    out = out.reshape(B, 1, a.n_heads * a.v_head_dim).to(x.dtype)
    return linear_apply(p["wo"], out), cache
