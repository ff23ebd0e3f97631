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
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import (causal_conv, causal_conv_step,
                                       init_linear, init_normal, init_rmsnorm,
                                       linear_apply, rmsnorm_apply, softplus)

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


def ssm_apply(p: Params, s: SSMConfig, d_model: int, x: torch.Tensor
              ) -> torch.Tensor:
    """Full-sequence (train/prefill) path.  x: (B, T, d_model)."""
    Bsz, T, _ = x.shape
    di = d_inner(s, d_model)
    proj = linear_apply(p["in_proj"], x)
    z, xbc, dt = _split_proj(s, proj, d_model)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :di].reshape(Bsz, T, s.n_heads, s.head_dim)
    B_in = xbc[..., di:di + s.d_state]
    C_in = xbc[..., di + s.d_state:]
    dt = softplus(dt.float() + p["dt_bias"])
    y, _ = ssd_chunked(xs, dt, p["A_log"], B_in, C_in, p["D"],
                       chunk=s.chunk)
    y = y.reshape(Bsz, T, di).to(x.dtype)
    y = rmsnorm_apply(p["norm"], y * F.silu(z))
    return linear_apply(p["out_proj"], y)


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
    SSD state are written into ``state``'s tensors, which are returned."""
    Bsz = x.shape[0]
    di = d_inner(s, d_model)
    proj = linear_apply(p["in_proj"], x[:, 0])
    z, xbc, dt = _split_proj(s, proj, d_model)
    hist = torch.cat([state["conv"], xbc[:, None]], dim=1)    # (B,K,Ch)
    xbc_t = F.silu(causal_conv_step(hist, p["conv_w"], p["conv_b"])
                   ).to(x.dtype)
    xs = xbc_t[..., :di].reshape(Bsz, s.n_heads, s.head_dim)
    B_in = xbc_t[..., di:di + s.d_state].float()
    C_in = xbc_t[..., di + s.d_state:].float()
    dt_t = softplus(dt.float() + p["dt_bias"])                 # (B,h)
    decay = torch.exp(dt_t * -torch.exp(p["A_log"]))           # (B,h)
    xd = xs.float() * dt_t[..., None]
    S = decay[:, :, None, None] * state["ssd"] + torch.einsum(
        "bn,bhp->bhpn", B_in, xd)
    y = torch.einsum("bn,bhpn->bhp", C_in, S)
    y = y + xs.float() * p["D"][None, :, None]
    y = y.reshape(Bsz, di).to(x.dtype)
    y = rmsnorm_apply(p["norm"], y * F.silu(z))
    out = linear_apply(p["out_proj"], y)[:, None]
    state["conv"].copy_(hist[:, 1:])
    state["ssd"].copy_(S)
    return out, state
