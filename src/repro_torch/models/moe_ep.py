"""The expert-parallel MoE route (``repro.models.moe_ep``): tokens split
over the pod's (data, model) ranks, experts over ``model``, each rank's
pairs sent to the experts' owners along ``model`` by an all-to-all.

The reference turns it on with its ``REPRO_MOE_EP`` switch under a mesh
with data and model axes; the port names it instead:
``moe.moe_apply(..., route="ep")`` (and the steps' ``moe_route="ep"``).
It is its own function, not the dense route's: a rank routes its T / M
slice of each of its sequences, with a capacity per (source rank,
destination peer) ``C_send`` and per local expert ``C_exp``, so where a
pair overflows either, it is dropped here and kept by the dense route's
global capacity; its auxiliary loss is the mean over the pod's ranks of
each rank's loss on its own tokens, where the dense route's is the loss
of the pod's routing statistics (ROADMAP C11 asks which one a run
should take).  Where ``ep_applicable_seq`` is false, as at a one-token
decode step on a ``model`` axis above 1, ``moe_apply`` runs the dense
route: the reference's rule, not a fallback.

``moe_apply_ep`` runs on the ranks of a ``launch.mesh.Mesh`` (inside
``activation_sharding``): the rank's rows of the pod's batch, whole
sequences (the layers before it are tensor-parallel), its blocks of the
router (gathered: every rank routes with the whole router) and of its
E / M experts (gathered over ``data``).  ``moe_apply_ep_ref`` is the
plain version in one process on the whole batch and weights: it loops
over the D x M ranks and emulates each all-to-all by permuting the send
buffers.  Routed experts only: ``moe.moe_apply`` adds the shared
experts' MLP on the whole tokens, as the reference does.

Training differentiates both.  On the ranks the all-to-alls send each
gradient block back where its rows came from
(``collectives.all_to_all_model``), the router's and the experts'
gradients are summed over the ranks that read them (their gathers'
reduce-scatters), and the mean of the auxiliary losses passes each rank
the gradient of its own; ``moe_apply_ep_ref``'s autograd (index writes
into fresh buffers, no in-place write to an input) is the plain version
of that gradient, which the tests and ``chip_smoke.py`` hold the ranks
to.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.launch import collectives as coll
from repro_torch.launch.sharding import split

Params = Dict[str, object]


def _round8(n: int) -> int:
    return max(8, -(-n // 8) * 8)


def ep_applicable(m: MoEConfig, n_tokens: int, mesh) -> bool:
    """Whether ``n_tokens`` (the pod's) split evenly over the mesh's
    ``data`` x ``model`` ranks, at least one a rank, and the experts over
    ``model``."""
    if mesh is None or "data" not in mesh.axis_names \
            or "model" not in mesh.axis_names:
        return False
    D, M = mesh.shape["data"], mesh.shape["model"]
    return (n_tokens % (D * M) == 0 and m.n_experts % M == 0
            and n_tokens // (D * M) > 0)


def ep_applicable_seq(m: MoEConfig, B: int, T: int, mesh) -> bool:
    """``ep_applicable`` for the pod's (B, T) batch, with T split over
    ``model`` and B over ``data``."""
    if not ep_applicable(m, B * T, mesh):
        return False
    return T % mesh.shape["model"] == 0 and B % mesh.shape["data"] == 0


def ep_capacities(m: MoEConfig, n_local: int, M: int) -> Tuple[int, int]:
    """(C_send, C_exp) for ``n_local`` tokens a rank on a ``model`` axis of
    M: slots a (source rank, destination peer), and slots a local expert
    (it receives from M peers)."""
    E_r = m.n_experts // M
    c_send = _round8(math.ceil(n_local * m.top_k / M * m.capacity_factor))
    c_exp = _round8(math.ceil(M * c_send / E_r * m.capacity_factor))
    return c_send, c_exp


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` as int32 by a comparison: the same entries,
    without the range check that reads ``idx`` back to the host on the
    card (``idx`` is in [0, n) by construction)."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).to(
        torch.int32)


def _slot_rank(onehot: torch.Tensor) -> torch.Tensor:
    """Each row's rank among the earlier rows of its one-hot column:
    (R, n) int one-hot -> (R,)."""
    return ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)


def _dispatch(m: MoEConfig, xb: torch.Tensor, rw: torch.Tensor, M: int,
              c_send: int):
    """A rank's routing of its tokens ``xb`` (N, d) with the whole router
    ``rw`` (d, E): (the send buffer (M C_send, d), each slot's local
    expert (M C_send,) int32, -1 where empty; the combine's state: each
    pair's slot, keep, gate weight and token; the rank's auxiliary
    loss)."""
    N, d = xb.shape
    E, k = m.n_experts, m.top_k
    E_r = E // M
    probs = torch.softmax(xb.float() @ rw.float(), dim=-1)     # (N, E)
    gate_w, eidx = torch.topk(probs, k, dim=-1)
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    ce = _one_hot(eidx[:, 0], E).float().mean(dim=0)
    aux = m.router_aux_weight * E * (probs.mean(dim=0) * ce).sum()

    flat_e = eidx.reshape(-1)                                  # (N k,)
    dest = flat_e // E_r                                       # owner peer
    pos = _slot_rank(_one_hot(dest, M))
    keep = pos < c_send
    send_slot = torch.where(keep, dest * c_send + pos,
                            torch.full_like(dest, M * c_send))
    tok = torch.arange(N * k, device=xb.device) // k
    send_x = xb.new_zeros(M * c_send + 1, d)
    send_x[send_slot] = xb[tok]
    send_el = torch.full((M * c_send + 1,), -1, dtype=torch.int32,
                         device=xb.device)
    send_el[send_slot] = (flat_e % E_r).to(torch.int32)
    return (send_x[:M * c_send], send_el[:M * c_send],
            (send_slot, keep, gate_w, tok), aux)


def _experts(recv_x: torch.Tensor, recv_el: torch.Tensor, wg, wu, wd,
             c_exp: int) -> torch.Tensor:
    """The rank's E_r experts on the rows it received: each row's output
    (zero where dropped or empty), in the received order."""
    E_r, d = wg.shape[0], recv_x.shape[1]
    valid = recv_el >= 0
    el = recv_el.clamp(0, E_r - 1).long()
    pos = _slot_rank(_one_hot(el, E_r)
                     * valid[:, None].to(torch.int32))
    keep = valid & (pos < c_exp)
    slot = torch.where(keep, el * c_exp + pos,
                       torch.full_like(el, E_r * c_exp))
    buf = recv_x.new_zeros(E_r * c_exp + 1, d)
    buf[slot] = recv_x
    buf = buf[:E_r * c_exp].view(E_r, c_exp, d)
    g = F.silu(torch.bmm(buf, wg))
    u = torch.bmm(buf, wu)
    out = torch.bmm(g * u, wd).view(E_r * c_exp, d)
    return out[slot.clamp_max(E_r * c_exp - 1)] * keep[:, None].to(out.dtype)


def _combine(back: torch.Tensor, state, k: int) -> torch.Tensor:
    """Each token's k returned expert outputs, weighted and summed."""
    send_slot, keep, gate_w, tok = state
    n_slots = back.shape[0]
    contrib = back[send_slot.clamp_max(n_slots - 1)] \
        * keep[:, None].to(back.dtype)
    contrib = contrib * gate_w.reshape(-1)[:, None].to(back.dtype)
    return contrib.view(-1, k, back.shape[1]).sum(dim=1)


def moe_apply_ep(p: Params, m: MoEConfig, x: torch.Tensor, mesh
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts of the EP route on this rank: ``x`` (B, T, d),
    the rank's rows of the pod's batch, whole sequences.  Returns (y (B,
    T, d), the whole sequences' routed output on every ``model`` rank;
    the auxiliary loss, the mean over the pod's ranks)."""
    B, T, d = x.shape
    D, M = mesh.size_of("data"), mesh.size_of("model")
    c_send, c_exp = ep_capacities(m, B * T // M, M)
    span = T // M
    i = mesh.coords["model"]
    xb = coll.copy_to_model(x, mesh)[:, i * span:(i + 1) * span]
    xb = xb.reshape(-1, d)
    rw = coll.gather_model(coll.gather_data(p["router"]["w"], 0, mesh,
                                            split(mesh, "data", d)), 1, mesh)
    send_x, send_el, state, aux = _dispatch(m, xb, rw, M, c_send)
    recv_x = coll.all_to_all_model(send_x, mesh)
    recv_el = coll.all_to_all_model(send_el, mesh)
    ff = p["w_gate"].shape[2]               # placed whole (no axis)
    w = [coll.gather_data(p[n], 1, mesh, split(mesh, "data", n_in)).to(
        x.dtype) for n, n_in in (("w_gate", d), ("w_up", d),
                                  ("w_down", ff))]
    back = coll.all_to_all_model(_experts(recv_x, recv_el, *w, c_exp),
                                 mesh)
    y = _combine(back, state, m.top_k).view(B, span, d)
    aux = coll.reduce_from_model(coll.reduce_from_data(aux, mesh), mesh)
    return coll.gather_from_model(y, 1, mesh), aux / (D * M)


def moe_apply_ep_ref(p: Params, m: MoEConfig, x: torch.Tensor, D: int,
                     M: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the EP route in one process: ``x`` (B, T, d)
    the pod's whole batch, ``p`` whole weights, the D x M ranks' shards
    taken in turn (rank (r, i): rows r B / D on, the T / M span i), each
    all-to-all emulated by handing block j of every source's buffer to
    peer j.  Returns (y (B, T, d) routed experts only, the mean of the
    ranks' auxiliary losses)."""
    B, T, d = x.shape
    E_r = m.n_experts // M
    b, span = B // D, T // M
    c_send, c_exp = ep_capacities(m, b * span, M)
    rw = p["router"]["w"]
    y = torch.zeros_like(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def a2a(bufs: List[torch.Tensor]) -> List[torch.Tensor]:
        # peer j receives block j of each source, sources in order
        return [torch.cat([buf.view(M, -1, *buf.shape[1:])[j]
                           for buf in bufs]) for j in range(M)]

    for r in range(D):
        rows = x[r * b:(r + 1) * b]
        shards = [_dispatch(m, rows[:, i * span:(i + 1) * span]
                            .reshape(-1, d), rw, M, c_send)
                  for i in range(M)]
        recv_x = a2a([s[0] for s in shards])
        recv_el = a2a([s[1] for s in shards])
        back = a2a([_experts(
            recv_x[j], recv_el[j],
            *(p[n][j * E_r:(j + 1) * E_r].to(x.dtype)
              for n in ("w_gate", "w_up", "w_down")), c_exp)
            for j in range(M)])
        for i, s in enumerate(shards):
            y[r * b:(r + 1) * b, i * span:(i + 1) * span] = _combine(
                back[i], s[2], m.top_k).view(b, span, d)
            aux = aux + s[3]
    return y, aux / (D * M)
