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
k expert outputs as a (N, k, d) reduction.

``moe_apply(..., route=)`` names the reference's two functions:
``"dense"``, its default (``repro/models/moe.py``), and ``"ep"``, the
expert-parallel route the reference turns on with its ``REPRO_MOE_EP``
switch (``moe_ep.py``; the port reads no environment variable).  Under
``shard_hints.activation_sharding(mesh)`` the dense route computes the
one-device function on the rank's rows and experts: the router's logit
columns (``router/w`` is placed (data, model)) gathered over ``model``,
every token routed with the global capacity ``moe_capacity(m, N)`` (N
the pod's tokens: a token's rank in its expert counts the tokens of the
``data`` ranks before it, from their per-expert counts), the auxiliary
loss from the routing statistics summed over ``data`` (its gradient
reaches each rank's router columns once), only the pairs of
the rank's E / M experts dispatched and computed (the expert weights are
placed (model, data, None): gathered over ``data``), and each token's
partial combine summed over ``model``.  The EP route is its own function
(per-shard capacities, the mean of the per-shard auxiliary losses:
ROADMAP C11); where ``moe_ep.ep_applicable_seq`` is false (a one-token
decode step on a ``model`` axis above 1) the dense route runs, the
reference's rule.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.launch import collectives as coll
from repro_torch.launch.sharding import split
from repro_torch.models import moe_ep
from repro_torch.models.layers import (gated_mlp_apply, init_gated_mlp,
                                       init_linear, init_normal,
                                       linear_apply)
from repro_torch.models.shard_hints import current_mesh

#: the reference's MoE functions by name (``moe_apply``'s ``route``)
ROUTES = ("dense", "ep")

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
    return route_logits(m, xf.float() @ p["router"]["w"])


def route_logits(m: MoEConfig, logits: torch.Tensor):
    """``moe_route`` from the router's float32 logits (N, E)."""
    probs = torch.softmax(logits, dim=-1)
    gate_w, expert_idx = torch.topk(probs, m.top_k, dim=-1)    # (N, k)
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_w, expert_idx


def _expert_rank(E: int, flat_e: torch.Tensor):
    """(each pair's rank among the earlier pairs of its expert, in pair
    order (N * k,); the (E, N * k) int32 one-hot of the pairs' experts)."""
    # one row an expert, its pairs in token order along the row: the rank
    # is a scan along the innermost dim, which ATen runs in parallel (a
    # scan down the columns of the (N*k, E) one-hot runs one thread a
    # column)
    onehot = (torch.arange(E, device=flat_e.device)[:, None]
              == flat_e).to(torch.int32)                       # (E, N*k)
    pos_in_e = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    return (pos_in_e * onehot).sum(dim=0), onehot


def moe_slots(m: MoEConfig, expert_idx: torch.Tensor, C: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (token, expert) pair's dispatch slot, flattened in token
    order (N * k,): ``expert * C + rank`` where its rank in the expert is
    below C (``keep``), else ``E * C``, the spare row."""
    E = m.n_experts
    flat_e = expert_idx.reshape(-1)                            # (N*k,)
    pos, _ = _expert_rank(E, flat_e)
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos,
                       torch.full_like(flat_e, E * C))
    return slot, keep


def _experts(xf: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             gate_w: torch.Tensor, w_gate, w_up, w_down, C: int
             ) -> torch.Tensor:
    """The capacity dispatch, the experts and the combine: the pairs'
    tokens ``xf`` (N, d) written to their ``slot`` of the experts' (E x C)
    buffer (the dropped ones to a spare row, cut off before the experts
    run), the stacked experts (E, d, ff) / (E, ff, d) applied, and each
    token's k kept outputs weighted by ``gate_w`` (N, k) and summed:
    (N, d)."""
    N, d = xf.shape
    E, k = w_gate.shape[0], gate_w.shape[1]
    tok = torch.arange(N * k, device=xf.device) // k           # (N*k,)
    buf = xf.new_zeros(E * C + 1, d)
    buf[slot] = xf[tok]
    buf = buf[:E * C].view(E, C, d)
    g = F.silu(torch.bmm(buf, w_gate.to(xf.dtype)))
    u = torch.bmm(buf, w_up.to(xf.dtype))
    out = torch.bmm(g * u, w_down.to(xf.dtype)).view(E * C, d)
    gathered = out[slot.clamp_max(E * C - 1)] * keep[:, None].to(xf.dtype)
    gathered = gathered * gate_w.reshape(-1)[:, None].to(xf.dtype)
    return gathered.view(N, k, d).sum(dim=1)


def moe_apply(p: Params, m: MoEConfig, x: torch.Tensor,
              route: str = "dense") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d).  Returns (y (B, T, d), the float32 auxiliary loss),
    with C = ``moe_capacity(m, B * T)`` slots an expert.  ``route``: the
    reference's dense function or its expert-parallel one (the module
    docstring); under a mesh ``x`` holds the rank's rows."""
    if route not in ROUTES:
        raise ValueError(f"moe route {route!r}; known: {ROUTES}")
    mesh = current_mesh()
    B, T, d = x.shape
    D = 1 if mesh is None or mesh.rows_whole else mesh.size_of("data")
    if route == "ep" and moe_ep.ep_applicable_seq(m, B * D, T, mesh):
        y, aux = moe_ep.moe_apply_ep(p, m, x, mesh)
        if "shared" in p:
            y = y + gated_mlp_apply(p["shared"], x.reshape(B * T, d),
                                    m.n_shared * m.d_ff_expert
                                    ).reshape(B, T, d)
        return y, aux
    if mesh is not None:
        return _moe_apply_mesh(p, m, x, mesh)
    N = B * T
    E = m.n_experts
    C = moe_capacity(m, N)
    xf = x.reshape(N, d)
    probs, gate_w, expert_idx = moe_route(p, m, xf)

    # load-balance auxiliary loss (Switch/GShard form)
    me = probs.mean(dim=0)                                     # (E,)
    top1 = expert_idx[:, :1] == torch.arange(E, device=x.device)  # (N, E)
    ce = top1.float().mean(dim=0)
    aux = m.router_aux_weight * E * (me * ce).sum()

    slot, keep = moe_slots(m, expert_idx, C)
    y = _experts(xf, slot, keep, gate_w, p["w_gate"], p["w_up"],
                 p["w_down"], C)
    if "shared" in p:
        y = y + gated_mlp_apply(p["shared"], xf)
    return y.reshape(B, T, d), aux


def _moe_apply_mesh(p: Params, m: MoEConfig, x: torch.Tensor, mesh
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense route on the rank's rows ``x`` (B, T, d) and its E / M
    experts: the one-device function (the module docstring).  Where the
    ``model`` axis does not split the experts (``sharding.split``; the
    router's columns then neither) every rank runs every expert on its
    rows, with no *f* before the layer and nothing summed over ``model``
    after it."""
    B, T, d = x.shape
    N = B * T
    E, ff = m.n_experts, m.d_ff_expert
    # the data ranks whose rows make up the pod's tokens (one where each
    # holds every sequence: ``Mesh.with_rows_whole``)
    D = 1 if mesh.rows_whole else mesh.size_of("data")
    M = mesh.size_of("model")
    n_all = N * D
    C = moe_capacity(m, n_all)
    par = split(mesh, "model", E)
    E_r = E // M if par else E
    e0 = mesh.coords["model"] * E_r if par else 0
    xf = coll.copy_to_model(x.reshape(N, d), mesh, par)
    logits = linear_apply(p["router"], xf.float(), "col", (d, E),
                          not par)                          # (N, E_r)
    _, gate_w, expert_idx = route_logits(
        m, coll.gather_model(logits, 1, mesh, par))

    # the auxiliary loss from the pod's routing statistics, the same on
    # every model rank: its logits gathered by ``gather_from_model``, whose
    # backward keeps the rank's columns (``gather_model``'s would sum the
    # M equal gradients); the dispatch's, of the rank's experts alone,
    # are summed
    probs = torch.softmax(coll.gather_from_model(logits, 1, mesh, par),
                          dim=-1)
    top1 = expert_idx[:, :1] == torch.arange(E, device=x.device)
    stats = coll.reduce_from_data(torch.stack([probs.sum(dim=0),
                                               top1.float().sum(dim=0)]),
                                  mesh) / n_all
    aux = m.router_aux_weight * E * (stats[0] * stats[1]).sum()

    # each pair's rank in its expert over the pod's tokens in order: the
    # counts of the data ranks before this one, then the rank's own scan;
    # only the pairs of the rank's experts are dispatched
    flat_e = expert_idx.reshape(-1)                            # (N*k,)
    pos, onehot = _expert_rank(E, flat_e)
    if D > 1:
        counts = mesh.all_gather_dim(onehot.sum(dim=1)[None], 0, "data")
        pos = pos + counts[:mesh.coords["data"]].sum(dim=0)[flat_e]
    mine = (pos < C) & (flat_e >= e0) & (flat_e < e0 + E_r)
    slot = torch.where(mine, (flat_e - e0) * C + pos,
                       torch.full_like(flat_e, E_r * C))
    w = [coll.gather_data(p[n], 1, mesh, split(mesh, "data", n_in))
         for n, n_in in (("w_gate", d), ("w_up", d), ("w_down", ff))]
    y = coll.reduce_from_model(_experts(xf, slot, mine, gate_w, *w, C),
                               mesh, par)
    if "shared" in p:
        y = y + gated_mlp_apply(p["shared"], x.reshape(N, d),
                                m.n_shared * ff)
    return y.reshape(B, T, d), aux
