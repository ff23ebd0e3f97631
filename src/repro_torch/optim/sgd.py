"""Vanilla momentum SGD, the optimizer form the paper's Algorithms 1-3 are
written against (``repro.optim.sgd``):  u <- m*u - eta*grad ;  w <- w + u.

Weight decay is L2 in the gradient (Caffe's semantics, as the paper's
training tables set it up).  The trees are the port's pytrees (nested
dicts, lists and tuples over tensors: ``repro_torch.pytree``)."""
from __future__ import annotations

from typing import Any, Tuple, Union

import torch

from repro_torch import pytree

Params = Any


def init_momentum(params: Params) -> Params:
    return pytree.tree_map(torch.zeros_like, params)


def momentum_update(params: Params, grads: Params, velocity: Params, *,
                    lr: Union[float, torch.Tensor], momentum: float = 0.9,
                    weight_decay: float = 0.0
                    ) -> Tuple[Params, Params, Params]:
    """Returns (new_params, new_velocity, update).  ``update`` is the weight
    delta u applied this step: what Gaia and DGC accumulate and
    exchange."""
    def upd(w, g, u):
        g = g + weight_decay * w
        return momentum * u - lr * g
    new_v = pytree.tree_map(upd, params, grads, velocity)
    new_p = pytree.tree_map(lambda w, u: w + u, params, new_v)
    return new_p, new_v, new_v


def global_norm(tree: Params) -> torch.Tensor:
    """The L2 norm of every leaf together, summed in float32."""
    leaves = pytree.leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


def clip_by_global_norm(tree: Params, max_norm: float) -> Params:
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)
    return pytree.tree_map(lambda x: x * scale, tree)
