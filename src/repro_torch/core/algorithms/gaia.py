"""Gaia (Hsieh et al., NSDI 2017) — Algorithm 1.

Each node runs local momentum SGD, accumulates weight updates v, and shares
only *significant* updates: those with |v/w| > T.  Shared updates are applied
by every other node and cleared locally.  T decays with the learning rate
(update_threshold).  Under non-IID partitions the insignificant residuals
let each node's model specialize — the paper's §4.3 failure mode.

The significance filter is ``ops.gaia_select_many`` over every stacked
(K, ...) parameter tensor: on the card one launch a step of the
hand-written kernel (``kernels/csrc/gaia_select.cu``).
``t0`` may change every step (a 0-d tensor), which changes an operand's
value and nothing else.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.algorithms.base import (ModelFns, Tree, pernode_grads,
                                              tree_mean0, tree_stack_n,
                                              tree_zeros_stacked)
from repro_torch.kernels import ops


class Gaia:
    name = "gaia"

    def __init__(self, fns: ModelFns, n_nodes: int, *, momentum: float = 0.9,
                 weight_decay: float = 0.0, t0: float = 0.10,
                 lr0: float = None):
        self.fns, self.K = fns, n_nodes
        self.m, self.wd = momentum, weight_decay
        self.t0 = t0
        self.lr0 = lr0  # reference lr for threshold decay (None => constant T)

    def init(self, params: Tree, mstate: Tree) -> Dict[str, Tree]:
        return {"params": tree_stack_n(params, self.K),     # per-node replicas
                "mstate": tree_stack_n(mstate, self.K),
                "vel": tree_zeros_stacked(params, self.K),
                "acc": tree_zeros_stacked(params, self.K)}  # accumulated v

    def step(self, state, batch, lr, step_idx, t0=None) -> Tuple[Dict, Dict]:
        t0 = self.t0 if t0 is None else t0
        # threshold decays with the learning rate (Algorithm 1, line 16)
        thresh = t0 * (lr / self.lr0) if self.lr0 is not None else t0

        losses, grads, new_ms = pernode_grads(
            self.fns, state["params"], state["mstate"], batch,
            params_stacked=True)
        w0 = state["params"]
        vel = {n: self.m * u - lr * (grads[n] + self.wd * w0[n])
               for n, u in state["vel"].items()}
        params = {n: w0[n] + vel[n] for n in w0}
        acc = {n: state["acc"][n] + vel[n] for n in w0}

        # significance filter |v / w| > thresh, one kernel for every
        # tensor: (v * mask, count), so the mask never materializes and
        # the shared part is cleared exactly via acc - shared
        names = list(acc)
        picked, counts = ops.gaia_select_many(
            [acc[n] for n in names], [params[n] for n in names], thresh)
        comm = counts.sum().float() / self.K
        for n, shared in zip(names, picked):
            # apply everyone else's significant updates; clear own part
            total = shared.sum(dim=0, keepdim=True)
            params[n] = params[n] + (total - shared)
            acc[n] = acc[n] - shared

        metrics = {"loss": losses.mean(), "comm_floats": comm,
                   "resid_delta": _mean_rel(acc, params)}
        return ({"params": params, "mstate": new_ms, "vel": vel, "acc": acc},
                metrics)

    def eval_params(self, state):
        return tree_mean0(state["params"]), tree_mean0(state["mstate"])

    def node_params(self, state, k: int):
        return ({n: t[k] for n, t in state["params"].items()},
                {n: t[k] for n, t in state["mstate"].items()})


def _mean_rel(acc: Tree, params: Tree):
    num = sum(a.abs().sum() for a in acc.values())
    den = sum(p.abs().sum() for p in params.values())
    return num / den.clamp_min(1e-12)
