"""BSP (Valiant 1990): full synchronization every step — the paper's model-
quality target.  All node gradients are averaged each minibatch; a single
global model exists at all times.  Per-node BatchNorm still normalizes with
*local* minibatch statistics — which is exactly why BSP alone cannot fix the
non-IID problem for BN models (paper §5)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.algorithms.base import (ModelFns, Tree, pernode_grads,
                                              tree_mean0, tree_size,
                                              tree_stack_n)


class BSP:
    name = "bsp"

    def __init__(self, fns: ModelFns, n_nodes: int, *, momentum: float = 0.9,
                 weight_decay: float = 0.0):
        self.fns, self.K = fns, n_nodes
        self.m, self.wd = momentum, weight_decay

    def init(self, params: Tree, mstate: Tree) -> Dict[str, Tree]:
        return {"params": dict(params),
                "mstate": tree_stack_n(mstate, self.K),
                "vel": {n: torch.zeros_like(t) for n, t in params.items()}}

    def step(self, state, batch, lr, step_idx) -> Tuple[Dict, Dict]:
        losses, grads, new_ms = pernode_grads(
            self.fns, state["params"], state["mstate"], batch,
            params_stacked=False)
        g = tree_mean0(grads)
        w = state["params"]
        vel = {n: self.m * u - lr * (g[n] + self.wd * w[n])
               for n, u in state["vel"].items()}
        params = {n: w[n] + vel[n] for n in w}
        metrics = {"loss": losses.mean(),
                   "comm_floats": torch.tensor(float(tree_size(w)),
                                               device=losses.device)}
        return {"params": params, "mstate": new_ms, "vel": vel}, metrics

    def eval_params(self, state):
        return state["params"], tree_mean0(state["mstate"])
