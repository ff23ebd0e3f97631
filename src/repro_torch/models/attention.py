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

Under ``shard_hints.activation_sharding(mesh)`` (the train and serve
steps on a mesh with a ``data`` or ``model`` axis) attention runs on the
rank's heads where the ``model`` axis of M splits wo's rows (the block
runs split; where it does not, ``layers.block_whole``, every rank runs
the whole block with no *f* or *g*, any projection the axis splits
gathered whole): GQA's n_heads / M query heads and the KV heads they
read (the column blocks of wk and wv where those are the rank's KV
heads; else k and v whole, gathered over ``model`` where their columns
split, computed whole where the clamp keeps them so, and cut to the KV
heads the rank's query heads read, ``_kv_select``: one KV head shared
by several ranks, or query heads straddling two), MLA's n_heads / M
heads (the column blocks of wq or wuq and the rank's heads of wukv; the
latent columns of wdkv and wdq are gathered over ``model`` first, since
the RMSNorm reads the whole latent), the kernel on those, and wo
row-parallel.  Where the ``model`` axis does not divide the heads
(``sharding.heads_whole``: the projections' columns still split, a
rank's block a part of a head) the rank gathers its column blocks of q,
k and v whole over ``model`` (their backward sums every rank's part of a
head's gradient), computes every head, and hands the row-parallel wo the
columns of the output its row block reads (``_wo_cols``); MLA's wukv is
whole on every rank then (the clamp), its gradient summed over ``model``
once (``copy_to_model``: each rank's output columns give a part).  The
decode step reads the rank's block of the cache, as
``launch.sharding.cache_shardings`` places it; its ``split`` argument
(``sharding.cache_split``) names the axis the cache's length is split
over (per layer: a flash-decode length the axis does not split is whole
on every rank, ``_length_split``).  Where it is split (``"model"``:
flash-decode; ``"data"``: a batch below 8, every row's length over
``data``) each rank scores the query
against its own slots (over ``model``: every head, q gathered; over
``data``: every row, q gathered where the rank holds its rows of the
requests, not where it holds them all: requests the ``data`` axis does
not divide, ``_rows_split``), the slot's owner writes the new token,
and the softmax is combined: the max of the partial scores all-reduced,
then the sum of their exponentials, p normalised by both before it is
rounded to the cache's dtype (as ``decode_attention`` rounds it on one
device), the partial outputs summed; the rank then keeps its heads (or
rows) for wo.  The function is the one-device decode's.

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
import torch.distributed as dist

from repro_torch.launch import collectives as coll
from repro_torch.launch.sharding import heads_whole, rank_heads, split
from repro_torch.models.layers import (block_whole, init_linear, init_normal,
                                       init_rmsnorm, linear_apply,
                                       rmsnorm_apply, softcap)
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
                     scale: Optional[float] = None,
                     split: Optional[str] = None, mesh=None) -> torch.Tensor:
    """One-token decode.  q: (B, 1, Hq, D); caches: (B, L, Hkv, D).
    ``cache_positions``: (B, L) absolute position of each cache slot, -1
    for empty (ring-buffer semantics fall out of position bookkeeping).
    Grouped layout, no KV expansion: float32 scores, the probabilities
    rounded to the cache's dtype before the float32 product with v, as
    the reference's operands are.  With ``split`` (a mesh axis) the
    caches are this rank's slots of a length split over that axis of
    ``mesh``: the softmax and the output are combined over it
    (``_softmax``), p normalised before it is rounded."""
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
    p = _softmax(s, split, mesh)
    out = torch.einsum("bhgl,blhd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    if split is not None:
        mesh.all_reduce(out, split)
    return out.reshape(B, 1, Hq, Dv).to(q.dtype)


def _softmax(s: torch.Tensor, split: Optional[str], mesh) -> torch.Tensor:
    """The float32 softmax over the last dimension of ``s``, whose entries
    lie split over the mesh axis ``split`` (this rank's share in ``s``):
    the max all-reduced, then the sum of the exponentials; ``torch.
    softmax`` over the local entries where ``split`` is None."""
    if split is None:
        return torch.softmax(s, dim=-1)
    top = s.amax(dim=-1, keepdim=True)
    mesh.all_reduce(top, split, op=dist.ReduceOp.MAX)
    e = torch.exp(s - top)
    total = e.sum(dim=-1, keepdim=True)
    mesh.all_reduce(total, split)
    return e / total


def _write_token(cache: Params, new: Dict[str, torch.Tensor],
                 t: torch.Tensor, split: Optional[str], mesh
                 ) -> torch.Tensor:
    """Writes the token at positions ``t`` (B,) into the ring buffer
    ``cache`` in place: each ``new[name]`` (B, ...) into ``cache[name]``
    (B, L_r, ...), and ``t`` into ``cache["pos"]``, at slot ``t mod L``.
    Where the length is split over ``split`` (L = n L_r), only the rank
    that owns the slot (rank i owns [i L_r, (i + 1) L_r)) writes it; a
    whole-length ``pos`` (the flash-decode placement keeps it on every
    rank) is written everywhere.  No host sync: the others write the old
    value back.  Returns the positions of this rank's slots (B, L_r)."""
    L_r = cache[next(iter(new))].shape[1]
    n = 1 if split is None else mesh.size_of(split)
    L = L_r * n
    slot = (t % L).long()
    b_idx = torch.arange(t.shape[0], device=t.device)
    pos = cache["pos"]
    if n == 1:
        for name, val in new.items():
            cache[name][b_idx, slot] = val.to(cache[name].dtype)
        pos[b_idx, slot] = t.to(torch.int32)
        return pos
    lo = mesh.coords[split] * L_r
    local = slot - lo
    mine = (local >= 0) & (local < L_r)
    local = local.clamp(0, L_r - 1)
    for name, val in new.items():
        buf = cache[name]
        keep = mine.view((-1,) + (1,) * (val.dim() - 1))
        buf[b_idx, local] = torch.where(keep, val.to(buf.dtype),
                                        buf[b_idx, local])
    if pos.shape[1] == L:
        pos[b_idx, slot] = t.to(torch.int32)
        return pos[:, lo:lo + L_r]
    pos[b_idx, local] = torch.where(mine, t.to(torch.int32), pos[b_idx, local])
    return pos


def _own_block(x: torch.Tensor, dim: int, axis: str, mesh) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (cut into equal blocks over
    ``axis``): the rank's heads or rows after a combined decode."""
    n = x.shape[dim] // mesh.size_of(axis)
    return x.narrow(dim, mesh.coords[axis] * n, n)


def _rows_split(split: Optional[str], x: torch.Tensor, cache: Params
                ) -> bool:
    """Whether a decode whose cache length lies over ``data`` holds the
    rank's rows of the requests (fewer than the cache's rows), so that it
    gathers every row's query; where ``data`` does not divide the
    requests, every rank holds them all."""
    return split == "data" and x.shape[0] != cache["pos"].shape[0]


def _head_cols(t: torch.Tensor, whole: bool, mesh) -> torch.Tensor:
    """The column block ``t`` of q, k or v (heads x head_dim last),
    gathered whole over ``model`` where the rank runs every head
    (``heads_whole``); ``t`` elsewhere."""
    return coll.gather_model(t, t.dim() - 1, mesh) if whole else t


def _wo_cols(out: torch.Tensor, whole: bool, mesh) -> torch.Tensor:
    """The columns of the attention output ``out`` (every head's, last
    dimension) that the row-parallel wo's row block of this rank reads,
    where the rank ran every head; ``out`` elsewhere."""
    return _own_block(out, out.dim() - 1, "model", mesh) if whole else out


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


def _rank_q(a: AttentionConfig, mesh) -> Tuple[int, int]:
    """(the query heads this ``model`` rank runs, its first):
    ``sharding.rank_heads``; every head without a mesh."""
    if mesh is None:
        return a.n_heads, 0
    return rank_heads(a.n_heads, mesh.size_of("model"),
                      mesh.coords.get("model", 0))


def _kv_select(t: torch.Tensor, a: AttentionConfig, h0: int, hl: int
               ) -> torch.Tensor:
    """The KV heads that query heads h0, ..., h0 + hl - 1 read, of ``t``
    (..., n_kv_heads, D), laid out for those hl query heads as the kernel
    and ``decode_attention`` read GQA (query head j on KV head j // (hl /
    n)): a slice where each of the n KV heads serves as many consecutive
    query heads (a rank's query heads within one KV head, or across
    whole groups, or straddling two of them evenly), else one KV head a
    query head."""
    g = a.n_heads // a.n_kv_heads
    idx = [(h0 + j) // g for j in range(hl)]
    lo, n = idx[0], idx[-1] - idx[0] + 1
    if hl % n == 0 and all(i - lo == j // (hl // n)
                           for j, i in enumerate(idx)):
        return t[..., lo:lo + n, :]
    return t[..., idx, :]


def gqa_qkv(p: Params, a: AttentionConfig, x: torch.Tensor,
            positions: torch.Tensor, every_kv: bool = False):
    """(q, k, v) after qk-norm and RoPE: (B, T, heads, head_dim).  Under a
    mesh whose ``model`` axis of M splits wo's rows (the block runs
    split: *f* on ``x``), the rank's n_heads / M query heads and the KV
    heads they read, or every query head where M does not divide them
    (``sharding.heads_whole``: q's column blocks gathered whole, whose
    backward sums each rank's part of a head's gradient).  k and v come
    as the rank's column blocks where those are its query heads' KV
    heads; else whole (gathered over ``model`` where their columns split,
    computed whole where the clamp keeps wk and wv whole) and cut to the
    KV heads its query heads read (``_kv_select``), or all n_kv_heads
    with ``every_kv``.  Where the axis does not split wo's rows
    (``layers.block_whole``) every rank runs the whole block, every
    head."""
    B, T, d = x.shape
    m = axis_env_size("model")
    mesh = current_mesh()
    hd = a.head_dim
    nq, nkv = a.n_heads * hd, a.n_kv_heads * hd
    whole = block_whole(nq)
    hw = heads_whole(a, m)
    own = False
    if mesh is not None:
        x = coll.copy_to_model(x, mesh, not whole)
    q = linear_apply(p["wq"], x, "col", (d, nq), whole)
    k = linear_apply(p["wk"], x, "col", (d, nkv), whole)
    v = linear_apply(p["wv"], x, "col", (d, nkv), whole)
    if mesh is not None and not whole:
        q = coll.gather_model(q, q.dim() - 1, mesh, hw)
        kv_split = split(mesh, "model", nkv)
        own = kv_split and a.n_kv_heads % m == 0 and not hw
        if every_kv or not own:
            k, v = (coll.gather_model(u, u.dim() - 1, mesh, kv_split)
                    for u in (k, v))
    q = q.reshape(B, T, -1, hd)
    k = k.reshape(B, T, -1, hd)
    v = v.reshape(B, T, -1, hd)
    if mesh is not None and not (whole or hw or own or every_kv):
        hl, h0 = _rank_q(a, mesh)
        k, v = _kv_select(k, a, h0, hl), _kv_select(v, a, h0, hl)
    if a.qk_norm:
        q = rmsnorm_apply(p["q_norm"], q)
        k = rmsnorm_apply(p["k_norm"], k)
    q = apply_rope(q, positions, a.rope_theta)
    k = apply_rope(k, positions, a.rope_theta)
    return q, k, v


def _out(p: Params, a: AttentionConfig, out: torch.Tensor, d: int,
         v_dim: int) -> torch.Tensor:
    """``wo`` on the attention output ``out`` (B, T, heads x ``v_dim``):
    row-parallel where the block runs split (the columns of its row block
    where the rank ran every head: ``_wo_cols``), whole where it runs
    whole."""
    n = a.n_heads * v_dim
    whole = block_whole(n)
    mesh = current_mesh()
    out = _wo_cols(out, mesh is not None and not whole and heads_whole(
        a, axis_env_size("model")), mesh)
    return linear_apply(p["wo"], out, "row", (n, d), whole)


def gqa_apply(p: Params, a: AttentionConfig, x: torch.Tensor, *,
              window: Optional[int], positions: torch.Tensor,
              chunk: int = 512) -> torch.Tensor:
    """Train/prefill path (full sequence): under a mesh on the rank's
    heads (every head where ``heads_whole`` or where the block runs
    whole), wo's partial products summed over ``model`` where it runs
    split."""
    q, k, v = gqa_qkv(p, a, x, positions)
    out = chunked_attention(q, k, v, causal=True, window=window,
                            logit_softcap=a.attn_softcap, chunk=chunk)
    B, T, d = x.shape
    return _out(p, a, out.reshape(B, T, -1), d, a.head_dim)


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


def _length_split(split_: Optional[str], cache: Params, name: str
                  ) -> Optional[str]:
    """The axis this layer's cache length lies split over: ``split_``,
    but None under flash-decode (``"model"``, whose ``pos`` keeps the
    whole length) where the axis does not split the length, so that
    every rank holds every slot (the clamp)."""
    if split_ == "model" and cache[name].shape[1] == cache["pos"].shape[1]:
        return None
    return split_


def gqa_decode(p: Params, a: AttentionConfig, x: torch.Tensor,
               cache: Params, t: torch.Tensor, split: Optional[str] = None
               ) -> Tuple[torch.Tensor, Params]:
    """x: (B, 1, d).  t: (B,) absolute position of this token.  The cache
    is a ring buffer of ``L`` slots; slot = t mod L (sliding window when
    L < full context).  Unlike the reference, which returns a new cache,
    this writes the token's k, v and position into ``cache`` in place
    (no copy of the cache a step) and returns it.  Under a mesh ``cache``
    is the rank's block and ``split`` the axis its length is split over
    (the module docstring; a length the axis does not split is whole on
    every rank: ``_length_split``).  Where the cache holds every KV head
    on every ``model`` rank (the flash-decode placement, or KV heads the
    axis does not split) each rank writes them all and reads the ones its
    query heads read (every head, over its own slots, under flash-decode,
    where the rank runs every head: ``heads_whole``, or where the block
    runs whole)."""
    B, _, d = x.shape
    mesh = current_mesh()
    sp = _length_split(split, cache, "k")
    whole = block_whole(a.n_heads * a.head_dim)
    hw = whole or heads_whole(a, axis_env_size("model"))
    every_kv = mesh is not None and cache["k"].shape[2] == a.n_kv_heads
    rows = _rows_split(sp, x, cache)
    q, k, v = gqa_qkv(p, a, x, t[:, None], every_kv=every_kv)
    if sp == "model" and not hw:             # every head on the rank's slots
        q = coll.gather_model(q, 2, mesh)
    elif rows:                               # every row on the rank's slots
        q, k, v = (coll.gather_data(u, 0, mesh) for u in (q, k, v))
        t = mesh.all_gather_dim(t, 0, "data")
    pos = _write_token(cache, {"k": k[:, 0], "v": v[:, 0]}, t, sp, mesh)
    k_c, v_c = cache["k"], cache["v"]
    if every_kv and not (hw or sp == "model"):
        hl, h0 = _rank_q(a, mesh)
        k_c, v_c = _kv_select(k_c, a, h0, hl), _kv_select(v_c, a, h0, hl)
    out = decode_attention(q, k_c, v_c, q_pos=t,
                           cache_positions=pos, logit_softcap=a.attn_softcap,
                           split=sp, mesh=mesh)
    if sp == "model" and not hw:
        out = _own_block(out, 2, "model", mesh)
    elif rows:
        out = _own_block(out, 0, "data", mesh)
    return _out(p, a, out.reshape(B, 1, -1), d, a.head_dim), cache


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


def _mla_whole(a: AttentionConfig) -> bool:
    """Whether MLA's block runs whole over the active mesh's ``model``
    axis: the axis does not split wo's n_heads x v_head_dim rows
    (``layers.block_whole``)."""
    return block_whole(a.n_heads * a.v_head_dim)


def _mla_q(p: Params, a: AttentionConfig, x: torch.Tensor,
           positions: torch.Tensor):
    """(q_nope, q_rope) on the rank's n_heads / M heads (M its ``model``
    size, 1 without a mesh; every head where ``heads_whole``: the rank's
    columns gathered, or where the block runs whole); ``_mla_in`` gave
    ``x``.  With a q_lora rank, wdq's latent is whole before ``q_norm``:
    its columns gathered over ``model`` where they split."""
    B, T, d = x.shape
    mesh = current_mesh()
    whole = _mla_whole(a)
    qhead = a.nope_head_dim + a.rope_head_dim
    n = a.n_heads * qhead
    if a.q_lora_rank:
        r = a.q_lora_rank
        cq = linear_apply(p["wdq"], x, "col", (d, r), whole)
        if mesh is not None and not whole:
            cq = coll.gather_model(cq, cq.dim() - 1, mesh,
                                   split(mesh, "model", r))
        q = linear_apply(p["wuq"], rmsnorm_apply(p["q_norm"], cq), "col",
                         (r, n), whole)
    else:
        q = linear_apply(p["wq"], x, "col", (d, n), whole)
    if mesh is not None and not whole:
        q = _head_cols(q, heads_whole(a, axis_env_size("model"))
                       and split(mesh, "model", n), mesh)
    q = q.reshape(B, T, -1, qhead)
    q_nope = q[..., :a.nope_head_dim]
    q_rope = apply_rope(q[..., a.nope_head_dim:], positions, a.rope_theta)
    return q_nope, q_rope


def _mla_ckv(p: Params, a: AttentionConfig, x: torch.Tensor,
             positions: torch.Tensor):
    """(c_kv (B, T, r) after kv_norm, k_rope (B, T, rope_dim)): whole on
    every rank, wdkv's columns gathered over ``model`` where they split
    (the weight, where the block runs whole)."""
    n = a.kv_lora_rank + a.rope_head_dim
    mesh = current_mesh()
    whole = _mla_whole(a)
    ckv_kr = linear_apply(p["wdkv"], x, "col", (x.shape[-1], n), whole)
    if mesh is not None and not whole:
        ckv_kr = coll.gather_model(ckv_kr, ckv_kr.dim() - 1, mesh,
                                   split(mesh, "model", n))
    c_kv = rmsnorm_apply(p["kv_norm"], ckv_kr[..., :a.kv_lora_rank])
    k_rope = ckv_kr[..., a.kv_lora_rank:][:, :, None, :]   # (B,T,1,rope_dim)
    k_rope = apply_rope(k_rope, positions, a.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _mla_in(x: torch.Tensor, a: AttentionConfig) -> torch.Tensor:
    """*f* on MLA's input under a mesh where the block runs split (its
    projections are column-parallel)."""
    mesh = current_mesh()
    return x if mesh is None else coll.copy_to_model(x, mesh,
                                                     not _mla_whole(a))


def _wukv(p: Params, a: AttentionConfig) -> torch.Tensor:
    """wukv: the rank's heads; where the clamp keeps them whole
    (``heads_whole``) every head, its gradient summed over ``model``
    (each rank's output columns give a part of it); where the block runs
    whole every head, gathered over ``model`` where they split."""
    mesh = current_mesh()
    if mesh is None:
        return p["wukv"]
    heads = split(mesh, "model", a.n_heads)
    if _mla_whole(a):
        return coll.gather_from_model(p["wukv"], 1, mesh, heads)
    return coll.copy_to_model(p["wukv"], mesh, not heads)


def mla_apply(p: Params, a: AttentionConfig, x: torch.Tensor, *,
              positions: torch.Tensor, window: Optional[int] = None,
              chunk: int = 512) -> torch.Tensor:
    """Train/prefill: expand K and V from the latent and run
    ``chunked_attention`` at scale (nope + rope) ** -0.5.  v is the view
    ``kv[..., nope:]`` of the expansion, which the kernel reads in place
    (at both full widths its rows start 16-byte aligned, its strides
    multiples of 8).  Under a mesh on the rank's heads (wukv's), wo
    row-parallel (every head where ``heads_whole`` or where the block
    runs whole)."""
    B, T, d = x.shape
    x = _mla_in(x, a)
    q_nope, q_rope = _mla_q(p, a, x, positions)
    c_kv, k_rope = _mla_ckv(p, a, x, positions)
    wukv = _wukv(p, a).to(x.dtype)
    h = wukv.shape[1]
    kv = (c_kv @ wukv.flatten(1)).unflatten(-1, wukv.shape[1:])  # (B,T,h,·)
    k_nope = kv[..., :a.nope_head_dim]
    v = kv[..., a.nope_head_dim:]
    k_rope_b = k_rope[:, :, None, :].expand(B, T, h, a.rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    scale = (a.nope_head_dim + a.rope_head_dim) ** -0.5
    out = chunked_attention(q, k, v, causal=True, window=window,
                            scale=scale, chunk=chunk)
    return _out(p, a, out.reshape(B, T, -1), d, a.v_head_dim)


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
               cache: Params, t: torch.Tensor, split: Optional[str] = None
               ) -> Tuple[torch.Tensor, Params]:
    """Absorbed decode, in float32: W_uk folded into q, scores taken
    against the compressed cache, W_uv applied to the weighted latent.
    The cache is a ring buffer of ``L`` slots (slot = t mod L); this
    writes the token's c_kv, k_rope and position into it in place, as
    ``gqa_decode`` does, and returns it.  Under a mesh on the rank's
    heads (every head where ``heads_whole`` or where the block runs
    whole); where the cache's length is split (``split``, and
    ``_length_split``), the absorbed queries of every head (over
    ``model``) or of every row (over ``data``) score the rank's slots and
    the softmax and the weighted latent are combined over that axis, as
    ``gqa_decode`` combines."""
    B, _, d = x.shape
    mesh = current_mesh()
    sp = _length_split(split, cache, "ckv")
    hw = _mla_whole(a) or heads_whole(a, axis_env_size("model"))
    rows = _rows_split(sp, x, cache)
    x = _mla_in(x, a)
    q_nope, q_rope = _mla_q(p, a, x, t[:, None])           # (B,1,h,*)
    c_kv, k_rope = _mla_ckv(p, a, x, t[:, None])           # (B,1,r),(B,1,rd)
    wukv = _wukv(p, a).float()
    w_uk = wukv[..., :a.nope_head_dim]                     # (r,h,nope)
    w_uv = wukv[..., a.nope_head_dim:]                     # (r,h,v)
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].float(), w_uk)
    q_rope = q_rope[:, 0].float()
    if sp == "model" and not hw:
        q_abs, q_rope = (coll.gather_model(u, 1, mesh)
                         for u in (q_abs, q_rope))
    elif rows:
        q_abs, q_rope, c_kv, k_rope = (coll.gather_data(u, 0, mesh) for u in
                                       (q_abs, q_rope, c_kv, k_rope))
        t = mesh.all_gather_dim(t, 0, "data")
    pos = _write_token(cache, {"ckv": c_kv[:, 0], "krope": k_rope[:, 0]}, t,
                       sp, mesh)
    ckv_f = cache["ckv"].float()                           # (B,L,r)
    s_nope = torch.einsum("bhr,blr->bhl", q_abs, ckv_f)
    s_rope = torch.einsum("bhd,bld->bhl", q_rope, cache["krope"].float())
    scale = (a.nope_head_dim + a.rope_head_dim) ** -0.5
    s = (s_nope + s_rope) * scale
    valid = (pos >= 0) & (pos <= t[:, None])
    s = torch.where(valid[:, None], s,
                    torch.full((), NEG_INF, device=s.device))
    pr = _softmax(s, sp, mesh)
    out_c = torch.einsum("bhl,blr->bhr", pr, ckv_f)        # (B,h,r)
    if sp is not None:
        out_c = mesh.all_reduce(out_c, sp)
    if sp == "model" and not hw:
        out_c = _own_block(out_c, 1, "model", mesh)
    elif rows:
        out_c = _own_block(out_c, 0, "data", mesh)
    out = torch.einsum("bhr,rhv->bhv", out_c, w_uv)        # (B,h,v)
    return _out(p, a, out.reshape(B, 1, -1).to(x.dtype), d,
                a.v_head_dim), cache
