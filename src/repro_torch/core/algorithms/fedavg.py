"""FederatedAveraging (McMahan et al., AISTATS 2017) — Algorithm 2.

Each node runs ``iter_local`` local momentum-SGD steps, then all node models
are averaged (all_reduce) into the next round's starting point.  Following
the paper's Appendix A, all K partitions participate every round
(deterministic variant).  ``iter_local`` may change every step (SkewScout
retunes it): the sync happens when ``step_idx % iter_local ==
iter_local - 1``, decided on the host from two Python ints, so deciding
costs the device nothing.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.algorithms.base import (ModelFns, Tree, pernode_grads,
                                              tree_mean0, tree_size,
                                              tree_stack_n,
                                              tree_zeros_stacked)


class FedAvg:
    name = "fedavg"

    def __init__(self, fns: ModelFns, n_nodes: int, *, momentum: float = 0.9,
                 weight_decay: float = 0.0, iter_local: int = 20):
        self.fns, self.K = fns, n_nodes
        self.m, self.wd = momentum, weight_decay
        self.iter_local = iter_local

    def init(self, params: Tree, mstate: Tree) -> Dict[str, Tree]:
        return {"params": tree_stack_n(params, self.K),
                "mstate": tree_stack_n(mstate, self.K),
                "vel": tree_zeros_stacked(params, self.K)}

    def step(self, state, batch, lr, step_idx, iter_local=None
             ) -> Tuple[Dict, Dict]:
        il = int(self.iter_local if iter_local is None else iter_local)
        w0 = state["params"]
        losses, grads, new_ms = pernode_grads(
            self.fns, w0, state["mstate"], batch, params_stacked=True)
        vel = {n: self.m * u - lr * (grads[n] + self.wd * w0[n])
               for n, u in state["vel"].items()}
        params = {n: w0[n] + vel[n] for n in w0}

        # divergence probe: mean |w_k - w_avg| / |w_avg| before any sync
        avg = tree_mean0(params)
        delta = _mean_rel_dev(params, avg)
        synced = int(step_idx) % il == il - 1
        if synced:
            params = _broadcast_mean(params, avg)
            new_ms = _broadcast_mean(new_ms, tree_mean0(new_ms))
        # fills on the device: a tensor made from a host number is a copy
        # the host waits for
        metrics = {"loss": losses.mean(),
                   "comm_floats": losses.new_full(
                       (), float(tree_size(avg)) if synced else 0.0),
                   "local_delta": delta,
                   "synced": losses.new_full((), synced, dtype=torch.bool)}
        return {"params": params, "mstate": new_ms, "vel": vel}, metrics

    def eval_params(self, state):
        return tree_mean0(state["params"]), tree_mean0(state["mstate"])

    def node_params(self, state, k: int):
        return ({n: t[k] for n, t in state["params"].items()},
                {n: t[k] for n, t in state["mstate"].items()})


def _broadcast_mean(stacked: Tree, avg: Tree) -> Tree:
    """Every node's copy replaced by the mean (all_reduce)."""
    return {n: avg[n].expand_as(t).contiguous() for n, t in stacked.items()}


def _mean_rel_dev(stacked: Tree, avg: Tree) -> torch.Tensor:
    num = sum((s - avg[n][None]).abs().sum() for n, s in stacked.items())
    den = sum(avg[n].abs().sum() * s.shape[0] for n, s in stacked.items())
    return num / den.clamp_min(1e-12)
