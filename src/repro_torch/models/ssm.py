"""Mamba-2 SSD (state-space duality) block (``repro.models.ssm``), the
chunked dual form [arXiv:2405.21060].

The sequence is split into chunks of length Q.  Within a chunk the SSD
is evaluated in its quadratic "attention-like" dual form; across chunks
a (heads, head_dim, d_state) float32 state is carried, by a Python loop
over the chunks where the reference scans with ``lax.scan``.  Decode is
a one-step recurrence on the same state, O(1) a token.

Plain tensor code, no kernel: the reference computes it outside any
Pallas call.  The decode writes its new conv history and SSD state into
the cache's own tensors (``transformer.lm_decode`` keeps the cache it
was given), and returns them.

Under ``shard_hints.activation_sharding(mesh)`` (the train and serve
steps inside a pod) the weights are the reference's blocks, which do not
follow the heads: ``in_proj``'s columns [z | x | B | C | dt] and
``conv_w``'s channels [x | B | C] are cut into M contiguous blocks over
``model``.  So the rank computes its column block of ``in_proj`` and
gathers that activation whole over ``model`` (tokens x its width a
layer, against d_model x its width for the weight), takes its n_heads /
M heads' z, x and dt and all of B and C from it, runs the conv on those
channels with ``conv_w`` gathered whole (K x channels), the SSD on its
heads, and ``out_proj`` row-parallel (its rows are the rank's heads'
channels where M divides n_heads).  The gated RMSNorm is taken over all
of d_inner: its sum of squares is summed over ``model``, and so is that
sum's gradient (``collectives.sum_over_model``).  The decode keeps the
reference's cache placement: the conv history whole on every ``model``
rank, the SSD state's head_dim split over ``model``; the update and
the readout are elementwise in head_dim, so the rank updates its
head_dim block of every head (the conv runs on every channel, whole),
and the readout's blocks are gathered over ``model`` before the norm.
Where the ``data`` axis does not divide the requests (one ``long_500k``
request) every rank decodes all of them and the reference's placement
puts the SSD state's heads over ``data``: the rank updates its heads'
head_dim block, and the readout is gathered over ``data`` too.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.device import resolve_device
from repro_torch.launch import collectives as coll
from repro_torch.launch.sharding import rank_heads, split
from repro_torch.models.layers import (block_whole, causal_conv,
                                       causal_conv_step, init_linear,
                                       init_normal, init_rmsnorm,
                                       linear_apply, rmsnorm_apply, softplus)
from repro_torch.models.shard_hints import current_mesh

Params = Dict[str, object]


def d_inner(s: SSMConfig, d_model: int) -> int:
    return s.expand * d_model


def init_ssm(gen: torch.Generator, s: SSMConfig, d_model: int, dtype,
             device=None) -> Params:
    device = resolve_device(device)
    di = d_inner(s, d_model)
    if di != s.n_heads * s.head_dim:
        raise ValueError(f"SSM: d_inner {di} != {s.n_heads} heads x "
                         f"{s.head_dim}")
    conv_ch = di + 2 * s.d_state
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # projects to [z (di), x (di), B (n), C (n), dt (h)]
        "in_proj": init_linear(gen, d_model,
                               2 * di + 2 * s.d_state + s.n_heads, dtype,
                               device=device),
        "conv_w": init_normal(gen, (s.d_conv, conv_ch), s.d_conv ** -0.5,
                              dtype, device),
        "conv_b": torch.zeros(conv_ch, dtype=dtype, device=device),
        "A_log": torch.zeros(s.n_heads, **f32),
        "dt_bias": torch.zeros(s.n_heads, **f32),
        "D": torch.ones(s.n_heads, **f32),
        "norm": init_rmsnorm(di, device=device),
        "out_proj": init_linear(gen, di, d_model, dtype, device=device),
    }


def _split_proj(s: SSMConfig, proj: torch.Tensor, d_model: int):
    di = d_inner(s, d_model)
    n = s.d_state
    return proj[..., :di], proj[..., di:2 * di + 2 * n], \
        proj[..., 2 * di + 2 * n:]


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over time, then SiLU.  xbc: (B, T, Ch); w:
    (K, Ch)."""
    return F.silu(causal_conv(xbc, w, b)).to(xbc.dtype)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                B_in: torch.Tensor, C_in: torch.Tensor, D: torch.Tensor, *,
                chunk: int, init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD over a full sequence.

    x: (B, T, h, p); dt: (B, T, h) (post-softplus); B_in/C_in: (B, T,
    n); a_log: (h,) (A = -exp(a_log)).  Returns (y: (B, T, h, p), the
    final state (B, h, p, n)), float32.  T must be a multiple of the
    chunk or below it, as in the reference.  Where autograd records (grad
    mode on and an input that requires grad) the dual form is built out
    of place; otherwise (prefill) in place, which saves a (B, h, Q, Q)
    tensor a chunk."""
    Bsz, T, h, p_dim = x.shape
    n = B_in.shape[-1]
    Q = min(chunk, T)
    if T % Q:
        raise ValueError(f"ssd_chunked: T={T} is not a multiple of the "
                         f"chunk {Q}")
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (x, dt, a_log, B_in, C_in, D, init_state))
    A = -torch.exp(a_log)                                      # (h,) < 0
    xd = x.float() * dt[..., None]                             # x * dt
    # the decays head-major, (B, h, T): each chunk's cumsum runs along
    # the innermost axis, and the (B, h, Q, Q) dual form is contiguous
    # for the matmul with x
    dA = (dt * A).transpose(1, 2)                              # <= 0
    Bf, Cf = B_in.float(), C_in.float()
    S = (torch.zeros(Bsz, h, p_dim, n, dtype=torch.float32, device=x.device)
         if init_state is None else init_state)
    future = torch.ones(Q, Q, dtype=torch.bool, device=x.device).triu(1)
    ys = []
    for c in range(T // Q):
        sl = slice(c * Q, (c + 1) * Q)
        xd_k = xd[:, sl].transpose(1, 2)                       # (B,h,Q,p)
        B_k, C_k = Bf[:, sl], Cf[:, sl]                        # (B,Q,n)
        cum = torch.cumsum(dA[..., sl], dim=-1)                # (B,h,Q)
        total = cum[..., -1:]                                  # (B,h,1)
        # intra-chunk (dual quadratic form): the mask before the exp,
        # then the scores; without autograd in place on the one (B, h, q,
        # k) tensor, with it out of place (exp's backward reads its output)
        L = (cum[..., :, None] - cum[..., None, :]).masked_fill_(
            future, float("-inf"))
        scores = torch.einsum("bqn,bkn->bqk", C_k, B_k)[:, None]
        if grad:
            L = L.exp() * scores
        else:
            L.exp_().mul_(scores)
        y = torch.matmul(L, xd_k)                              # (B,h,q,p)
        # inter-chunk: the carried state's contribution
        y += torch.einsum("bqn,bhpn->bhqp", C_k, S) * torch.exp(cum)[
            ..., None]
        ys.append(y.transpose(1, 2))                           # (B,q,h,p)
        # state update
        w_end = torch.exp(total - cum)                         # (B,h,Q)
        S = torch.exp(total)[..., None] * S + torch.einsum(
            "bhqp,bqn->bhpn", xd_k * w_end[..., None], B_k)
    y = torch.cat(ys, dim=1) + x.float() * D[None, None, :, None]
    return y, S


def _whole(s: SSMConfig, d_model: int) -> bool:
    """Whether the block runs whole over the active mesh's ``model`` axis:
    the axis does not split ``out_proj``'s d_inner rows
    (``layers.block_whole``)."""
    return block_whole(d_inner(s, d_model))


def _rank_heads(s: SSMConfig, mesh, whole: bool) -> Tuple[int, int]:
    """(the heads this ``model`` rank runs, its first head): every head
    without a mesh, where the block runs whole, or where the axis does not
    divide the heads (``sharding.rank_heads``)."""
    if mesh is None or whole:
        return s.n_heads, 0
    return rank_heads(s.n_heads, mesh.size_of("model"),
                      mesh.coords.get("model", 0))


def _whole_proj(p: Params, s: SSMConfig, x: torch.Tensor, mesh,
                whole: bool) -> torch.Tensor:
    """``in_proj``'s output, whole: under a mesh the rank's column block
    gathered over ``model`` (its gradient reduce-scattered back), or, where
    the clamp keeps the columns whole, the whole product (the weight
    through *f*: each rank's heads give a part of its gradient); where the
    block runs whole, the weight gathered and no *f*."""
    if mesh is None:
        return linear_apply(p["in_proj"], x)
    d = x.shape[-1]
    n = 2 * d_inner(s, d) + 2 * s.d_state + s.n_heads
    if whole:
        return linear_apply(p["in_proj"], x, "col", (d, n), whole=True)
    proj = linear_apply(p["in_proj"], coll.copy_to_model(x, mesh), "col",
                        (d, n))
    return coll.gather_model(proj, proj.dim() - 1, mesh,
                             split(mesh, "model", n))


def _conv_w(p: Params, s: SSMConfig, d_model: int, mesh, whole: bool
            ) -> torch.Tensor:
    """``conv_w`` whole (K x channels): its channel blocks gathered over
    ``model`` where they split (the gradient summed over ``model`` and
    scattered back where the block runs split, its block kept where it
    runs whole), or, where the clamp keeps the channels whole, through
    *f* inside a block that runs split."""
    w = p["conv_w"]
    if mesh is None:
        return w
    ch = split(mesh, "model", d_inner(s, d_model) + 2 * s.d_state)
    if whole:
        return coll.gather_from_model(w, 1, mesh, ch)
    return (coll.gather_model(w, 1, mesh) if ch
            else coll.copy_to_model(w, mesh))


def _gated_norm(p: Params, y: torch.Tensor, z: torch.Tensor, di: int,
                mesh, c0: int) -> torch.Tensor:
    """``rmsnorm_apply(p["norm"], y * silu(z))`` over all d_inner ``di``
    channels, of which ``y`` and ``z`` hold the ``model`` rank's from
    channel ``c0`` on: the float32 sum of squares summed over ``model``,
    its gradient as well (all of them: the plain norm)."""
    g = y * F.silu(z)
    if mesh is None or g.shape[-1] == di:
        return rmsnorm_apply(p["norm"], g)
    scale = p["norm"]["scale"][c0:c0 + g.shape[-1]]
    return rmsnorm_apply({"scale": scale}, g, width=di,
                         total=lambda v: coll.sum_over_model(v, mesh))


def _out_proj(p: Params, y: torch.Tensor, di: int, d_model: int, mesh,
              whole: bool) -> torch.Tensor:
    """``out_proj`` on ``y``: row-parallel where the block runs split (the
    rank's row block of channels taken where ``y`` holds all of them),
    whole where it runs whole."""
    if mesh is not None and not whole and y.shape[-1] == di:
        n = di // mesh.size_of("model")
        y = y.narrow(-1, mesh.coords["model"] * n, n)
    return linear_apply(p["out_proj"], y, "row", (di, d_model), whole)


def ssm_apply(p: Params, s: SSMConfig, d_model: int, x: torch.Tensor
              ) -> torch.Tensor:
    """Full-sequence (train/prefill) path.  x: (B, T, d_model); under a
    mesh on the rank's heads (the module docstring)."""
    Bsz, T, _ = x.shape
    di = d_inner(s, d_model)
    mesh = current_mesh()
    whole = _whole(s, d_model)
    hl, h0 = _rank_heads(s, mesh, whole)
    c0, cl = h0 * s.head_dim, hl * s.head_dim
    proj = _whole_proj(p, s, x, mesh, whole)
    z, xbc, dt = _split_proj(s, proj, d_model)
    conv_w, conv_b = _conv_w(p, s, d_model, mesh, whole), p["conv_b"]
    if hl != s.n_heads:
        # the rank's heads' z, x and dt, and all of B and C
        pick = lambda t: torch.cat([t[..., c0:c0 + cl], t[..., di:]], -1)
        z, dt = z[..., c0:c0 + cl], dt[..., h0:h0 + hl]
        xbc, conv_w, conv_b = pick(xbc), pick(conv_w), pick(conv_b)
    xbc = _causal_conv(xbc, conv_w, conv_b)
    xs = xbc[..., :cl].reshape(Bsz, T, hl, s.head_dim)
    B_in = xbc[..., cl:cl + s.d_state]
    C_in = xbc[..., cl + s.d_state:]
    heads = slice(h0, h0 + hl)
    dt = softplus(dt.float() + p["dt_bias"][heads])
    y, _ = ssd_chunked(xs, dt, p["A_log"][heads], B_in, C_in, p["D"][heads],
                       chunk=s.chunk)
    y = y.reshape(Bsz, T, cl).to(x.dtype)
    y = _gated_norm(p, y, z, di, mesh, c0)
    return _out_proj(p, y, di, d_model, mesh, whole)


def ssm_init_state(s: SSMConfig, d_model: int, batch: int, dtype,
                   device=None) -> Params:
    """The conv history in the model's dtype, the SSD state in float32."""
    device = resolve_device(device)
    di = d_inner(s, d_model)
    return {
        "conv": torch.zeros(batch, s.d_conv - 1, di + 2 * s.d_state,
                            dtype=dtype, device=device),
        "ssd": torch.zeros(batch, s.n_heads, s.head_dim, s.d_state,
                           dtype=torch.float32, device=device),
    }


def ssm_decode(p: Params, s: SSMConfig, d_model: int, x: torch.Tensor,
               state: Params) -> Tuple[torch.Tensor, Params]:
    """One-token decode.  x: (B, 1, d_model).  The new conv history and
    SSD state are written into ``state``'s tensors, which are returned.
    Under a mesh ``state`` is the rank's block: the conv history whole,
    the SSD state (B, n_heads, head_dim / M, d_state), or (B, n_heads /
    D, head_dim / M, d_state) for requests whole over ``data`` (the
    module docstring)."""
    Bsz = x.shape[0]
    di = d_inner(s, d_model)
    mesh = current_mesh()
    whole = _whole(s, d_model)
    proj = _whole_proj(p, s, x[:, 0], mesh, whole)
    z, xbc, dt = _split_proj(s, proj, d_model)
    hist = torch.cat([state["conv"], xbc[:, None]], dim=1)    # (B,K,Ch)
    conv_w = _conv_w(p, s, d_model, mesh, whole)
    xbc_t = F.silu(causal_conv_step(hist, conv_w, p["conv_b"])
                   ).to(x.dtype)
    xs = xbc_t[..., :di].reshape(Bsz, s.n_heads, s.head_dim)
    B_in = xbc_t[..., di:di + s.d_state].float()
    C_in = xbc_t[..., di + s.d_state:].float()
    # the rank's head_dim block of its heads: every head but where they
    # lie over ``data`` (all of it without a mesh)
    hd_, pl = state["ssd"].shape[1:3]
    lo = 0 if pl == s.head_dim else mesh.coords["model"] * pl
    heads = slice(0, s.n_heads) if hd_ == s.n_heads else slice(
        mesh.coords["data"] * hd_, (mesh.coords["data"] + 1) * hd_)
    dt_t = softplus(dt.float()[:, heads] + p["dt_bias"][heads])   # (B,h)
    decay = torch.exp(dt_t * -torch.exp(p["A_log"][heads]))       # (B,h)
    xs = xs[:, heads, lo:lo + pl]
    xd = xs.float() * dt_t[..., None]
    S = decay[:, :, None, None] * state["ssd"] + torch.einsum(
        "bn,bhp->bhpn", B_in, xd)
    y = torch.einsum("bn,bhpn->bhp", C_in, S)
    y = y + xs.float() * p["D"][heads][None, :, None]
    if pl != s.head_dim:
        y = coll.gather_model(y, 2, mesh)
    if hd_ != s.n_heads:
        y = mesh.all_gather_dim(y.contiguous(), 1, "data")
    y = y.reshape(Bsz, di).to(x.dtype)
    y = rmsnorm_apply(p["norm"], y * F.silu(z))
    out = _out_proj(p, y, di, d_model, mesh, whole)[:, None]
    state["conv"].copy_(hist[:, 1:])
    state["ssd"].copy_(S)
    return out, state
