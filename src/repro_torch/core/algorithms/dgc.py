"""DeepGradientCompression (Lin et al., ICLR 2018) — Algorithm 3.

Per step each node: scales its gradient by -eta, clips (global norm),
applies momentum correction (u = m*u + g), accumulates v += u, and exchanges
only the top-s% magnitude entries of v per tensor.  Exchanged entries are
cleared from BOTH v and u (momentum factor masking).  A warm-up schedule
raises s over epochs: 75%, 93.75%, 98.4375%, 99.6%, 99.9%.

``sparsity`` is a host number that may change every step (the warm-up
schedule, SkewScout); it is taken as float32, as the reference's traced
operand is.

Top-k: a per-node threshold at the ``s`` quantile of |v|, interpolated
linearly between the two order statistics around it exactly as
``jnp.quantile`` does (rank, floor, ceil and weights in float32), the two
order statistics from ``torch.kthvalue``, which has no size limit.

``compressor="randk"`` swaps the top-s% selection for seeded rand-k: the
keep mask is a pure function of (seed, step, tensor, flat index),
generated inside the kernel ``kernels/csrc/rand_k_select.cu`` through
``ops.rand_k_sparsify``, and the same stream masks ``v`` and ``u``, so no
mask is ever materialised: two launches a tensor a step.  The tensors
are visited, and their counters laid out, as the reference visits and
lays out its parameters (``tree_leaf_order``, ``ModelFns.ref_perm``), so
both packages keep the same elements.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.algorithms.base import (ModelFns, Tree, pernode_grads,
                                              tree_leaf_order, tree_mean0,
                                              tree_stack_n,
                                              tree_zeros_stacked)
from repro_torch.kernels import ops

WARMUP_SPARSITIES = (0.75, 0.9375, 0.984375, 0.996, 0.999)


def warmup_sparsity(epoch: int, e_warm: int) -> float:
    """Paper §3: s follows the warm-up schedule, e_warm epochs per level."""
    idx = min(epoch // max(e_warm, 1), len(WARMUP_SPARSITIES) - 1)
    return WARMUP_SPARSITIES[idx]


class DGC:
    name = "dgc"

    def __init__(self, fns: ModelFns, n_nodes: int, *, momentum: float = 0.9,
                 weight_decay: float = 0.0, clip: float = 1.0,
                 sparsity: float = 0.999, compressor: str = "topk",
                 seed: int = 0):
        if compressor not in ("topk", "randk"):
            raise ValueError(f"compressor={compressor!r}; expected "
                             "'topk' or 'randk'")
        self.fns, self.K = fns, n_nodes
        self.m, self.wd = momentum, weight_decay
        self.clip = clip
        self.sparsity = sparsity
        self.compressor = compressor
        self.seed = seed

    def init(self, params: Tree, mstate: Tree) -> Dict[str, Tree]:
        return {"params": dict(params),                  # ONE global model
                "mstate": tree_stack_n(mstate, self.K),
                "vel": tree_zeros_stacked(params, self.K),   # u (per node)
                "acc": tree_zeros_stacked(params, self.K)}   # v (per node)

    def step(self, state, batch, lr, step_idx, sparsity=None
             ) -> Tuple[Dict, Dict]:
        s = np.float32(self.sparsity if sparsity is None else sparsity)
        w = state["params"]
        losses, grads, new_ms = pernode_grads(
            self.fns, w, state["mstate"], batch, params_stacked=False)

        # g = -eta * grad, with per-node global-norm gradient clipping
        norm = sum(g.float().square().reshape(self.K, -1).sum(dim=1)
                   for g in grads.values()).sqrt()
        scale = (self.clip / norm.clamp_min(1e-12)).clamp_max(1.0)
        vel, acc = {}, {}
        for n, g in grads.items():
            g = -lr * (g * _per_node(scale, g) + self.wd * w[n][None])
            vel[n] = self.m * state["vel"][n] + g
            acc[n] = state["acc"][n] + vel[n]

        if self.compressor == "randk":
            shared, counts = self._rand_k(acc, vel, int(step_idx), s)
        else:
            shared, counts = self._top_k(acc, vel, s)
        params = {n: w[n] + shared[n].sum(dim=0) for n in w}  # sum over nodes
        acc = {n: acc[n] - shared[n] for n in acc}
        comm = sum(c.float() for c in counts) / self.K
        metrics = {"loss": losses.mean(), "comm_floats": comm,
                   "resid_delta": _mean_rel(acc, params)}
        return ({"params": params, "mstate": new_ms, "vel": vel, "acc": acc},
                metrics)

    def _top_k(self, acc: Tree, vel: Tree, s: np.float32):
        """Per tensor and node, share the entries of v with |v| above the
        ``s`` quantile of |v|, and clear them from u in place."""
        shared, counts = {}, []
        for n, v in acc.items():
            t = _quantile_per_node(v.abs().reshape(self.K, -1), s)
            mask = v.abs() > _per_node(t, v)
            shared[n] = torch.where(mask, v, torch.zeros_like(v))
            vel[n] = torch.where(mask, torch.zeros_like(v), vel[n])
            counts.append(mask.sum(dtype=torch.int32))
        return shared, counts

    def _rand_k(self, acc: Tree, vel: Tree, step: int, s: np.float32):
        """Per tensor, seeded rand-k on v and, with the same stream, on u
        (cleared in place): each (step, tensor) gets its own seed."""
        keep = float(np.float32(1) - s)
        shared, counts = {}, []
        for li, n in enumerate(tree_leaf_order(acc)):
            leaf_seed = (step * 1009 + self.seed * 131 + li) & 0xFFFFFFFF
            perm = self.fns.ref_perm(n)
            to_ref, from_ref = _layout(perm, acc[n].dim())
            sv, cnt = ops.rand_k_sparsify(to_ref(acc[n]), keep, leaf_seed)
            su, _ = ops.rand_k_sparsify(to_ref(vel[n]), keep, leaf_seed)
            shared[n] = from_ref(sv)
            vel[n] = vel[n] - from_ref(su)
            counts.append(cnt)
        return shared, counts

    def eval_params(self, state):
        return state["params"], tree_mean0(state["mstate"])

    def node_params(self, state, k: int):
        return (state["params"],
                {n: t[k] for n, t in state["mstate"].items()})


def _per_node(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (K,) tensor shaped to broadcast over the stacked ``like``."""
    return x.reshape((-1,) + (1,) * (like.dim() - 1))


def _quantile_per_node(a: torch.Tensor, q: np.float32) -> torch.Tensor:
    """Row-wise ``jnp.quantile(a, q, axis=1)`` (linear interpolation) of a
    (K, n) float32 tensor: the rank ``q * (n - 1)``, its floor and ceil
    and the two weights in float32 on the host, the two order statistics
    from ``kthvalue``, and ``low * w_low + high * w_high`` in float32."""
    n = a.shape[1]
    rank = np.float32(q) * (np.float32(n) - np.float32(1))
    lo, hi = np.floor(rank), np.ceil(rank)
    w_hi = np.float32(rank - lo)
    w_lo = np.float32(1) - w_hi
    lo, hi = (int(np.clip(r, 0, n - 1)) for r in (lo, hi))
    low = a.kthvalue(lo + 1, dim=1).values
    high = low if hi == lo else a.kthvalue(hi + 1, dim=1).values
    return low * float(w_lo) + high * float(w_hi)


def _layout(perm, dim: int):
    """(to, from) the reference's layout for a stacked (K, ...) tensor
    whose per-node dims are permuted by ``perm`` (None: no change)."""
    if perm is None:
        return (lambda t: t), (lambda t: t)
    fwd = (0,) + tuple(p + 1 for p in perm)
    inv = (0,) + tuple(perm.index(d) + 1 for d in range(dim - 1))
    return ((lambda t: t.permute(fwd).contiguous()),
            (lambda t: t.permute(inv).contiguous()))


def _mean_rel(acc: Tree, params: Tree) -> torch.Tensor:
    num = sum(a.abs().sum() for a in acc.values())
    den = sum(params[n].abs().sum() * a.shape[0] for n, a in acc.items())
    return num / den.clamp_min(1e-12)
