"""Mixture-of-Experts FFN (``repro.models.moe``, deepseek-v2 style):
shared experts and routed top-k experts with capacity-based dispatch.

Dispatch is GShard-style with a fixed per-expert capacity C, so every
shape is static: a token's rank in its expert is counted in token order,
and the pairs ranked C or later are dropped (their residual path passes
through untouched).  The expert products are batched matmuls over the
expert axis, as the reference computes them outside any Pallas kernel.

Nothing here reads a value back to the host, and nothing scatters with
atomics: each kept (token, expert) pair owns one slot of the dispatch
buffer, so the scatter is a plain index assignment, with the dropped
pairs sent to one spare row that is cut off; the combine sums a token's
k expert outputs as a (N, k, d) reduction.  The reference's expert-
parallel route (``REPRO_MOE_EP``, ``moe_ep.py``) goes with the
distributed backend (ROADMAP A11).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import (gated_mlp_apply, init_gated_mlp,
                                       init_linear, init_normal)

Params = Dict[str, object]


def init_moe(gen: torch.Generator, m: MoEConfig, d_model: int, dtype,
             device=None) -> Params:
    E, ff = m.n_experts, m.d_ff_expert
    s = d_model ** -0.5
    p: Params = {
        "router": init_linear(gen, d_model, E, torch.float32, device=device),
        # stacked expert weights: (E, d, ff) / (E, ff, d)
        "w_gate": init_normal(gen, (E, d_model, ff), s, dtype, device),
        "w_up": init_normal(gen, (E, d_model, ff), s, dtype, device),
        "w_down": init_normal(gen, (E, ff, d_model), ff ** -0.5, dtype,
                              device),
    }
    if m.n_shared:
        p["shared"] = init_gated_mlp(gen, d_model, m.n_shared * ff, dtype,
                                     device)
    return p


def moe_capacity(m: MoEConfig, n_tokens: int) -> int:
    """Slots an expert for ``n_tokens`` tokens: the mean load times the
    capacity factor, rounded up to a multiple of 8 and at least 8."""
    cap = int(math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor))
    return max(8, -(-cap // 8) * 8)


def moe_route(p: Params, m: MoEConfig, xf: torch.Tensor):
    """The float32 router on tokens ``xf`` (N, d): (probabilities (N, E),
    renormalised top-k gate weights (N, k), their experts (N, k))."""
    logits = xf.float() @ p["router"]["w"]                     # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gate_w, expert_idx = torch.topk(probs, m.top_k, dim=-1)    # (N, k)
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_w, expert_idx


def moe_slots(m: MoEConfig, expert_idx: torch.Tensor, C: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (token, expert) pair's dispatch slot, flattened in token
    order (N * k,): ``expert * C + rank`` where its rank in the expert is
    below C (``keep``), else ``E * C``, the spare row."""
    E = m.n_experts
    flat_e = expert_idx.reshape(-1)                            # (N*k,)
    # one row an expert, its pairs in token order along the row: the rank
    # is a scan along the innermost dim, which ATen runs in parallel (a
    # scan down the columns of the (N*k, E) one-hot runs one thread a
    # column)
    onehot = (torch.arange(E, device=flat_e.device)[:, None]
              == flat_e).to(torch.int32)                       # (E, N*k)
    pos_in_e = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos = (pos_in_e * onehot).sum(dim=0)                       # (N*k,)
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos,
                       torch.full_like(flat_e, E * C))
    return slot, keep


def moe_apply(p: Params, m: MoEConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d).  Returns (y (B, T, d), the float32 auxiliary loss),
    with C = ``moe_capacity(m, B * T)`` slots an expert."""
    B, T, d = x.shape
    N = B * T
    E, k = m.n_experts, m.top_k
    C = moe_capacity(m, N)
    xf = x.reshape(N, d)
    probs, gate_w, expert_idx = moe_route(p, m, xf)

    # load-balance auxiliary loss (Switch/GShard form)
    me = probs.mean(dim=0)                                     # (E,)
    top1 = expert_idx[:, :1] == torch.arange(E, device=x.device)  # (N, E)
    ce = top1.float().mean(dim=0)
    aux = m.router_aux_weight * E * (me * ce).sum()

    # capacity dispatch: E * C slots and the spare row the dropped pairs
    # write, cut off before the experts run
    slot, keep = moe_slots(m, expert_idx, C)
    tok = torch.arange(N * k, device=x.device) // k            # (N*k,)
    buf = x.new_zeros(E * C + 1, d)
    buf[slot] = xf[tok]
    buf = buf[:E * C].view(E, C, d)

    g = F.silu(torch.bmm(buf, p["w_gate"].to(x.dtype)))
    u = torch.bmm(buf, p["w_up"].to(x.dtype))
    out = torch.bmm(g * u, p["w_down"].to(x.dtype)).view(E * C, d)

    # combine: each token's k expert outputs, weighted, summed over k
    gathered = out[slot.clamp_max(E * C - 1)] * keep[:, None].to(x.dtype)
    gathered = gathered * gate_w.reshape(-1)[:, None].to(x.dtype)
    y = gathered.view(N, k, d).sum(dim=1)

    if "shared" in p:
        y = y + gated_mlp_apply(p["shared"], xf)
    return y.reshape(B, T, d), aux
