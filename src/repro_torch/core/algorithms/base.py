"""Shared machinery for the decentralized learning algorithms.

Simulation backend: K nodes live on one device as a stacked leading axis
(``torch.func.vmap`` over nodes), as in ``repro.core.algorithms.base``.
Each node sees only its partition's minibatch; cross-node exchange is an
explicit reduction over the node axis.  Parameters, model state and
batches are flat dicts of tensors.

Every algorithm implements:
  init(params, mstate)                       -> state dict
  step(state, stacked_batch, lr, step_idx,
       **dynamic_hypers)                     -> (state, metrics)
  eval_params(state)                         -> (params, mstate) global model

``metrics["comm_floats"]`` counts the floats exchanged this step per node
— the paper's communication-savings currency (BSP = model size each
step).  Metrics are 0-d tensors on the training device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.func import grad_and_value, vmap

Tree = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class ModelFns:
    """Model adapter: everything an algorithm needs to know about a model.

    loss_fn(params, mstate, batch) -> (loss, new_mstate)
        where ``batch`` is one node's minibatch ({"x": ..., "y": ...}).
    ref_perm(name) -> permutation or None
        how tensor ``name`` (one node's) is permuted from this package's
        layout into the reference's (``repro``), or None where the two
        agree.  DGC's rand-k counts its counters in the reference's
        layout, so both packages keep the same elements.
    """
    loss_fn: Callable
    ref_perm: Callable[[str], Optional[Tuple[int, ...]]] = lambda name: None


def tree_size(tree: Tree) -> int:
    return sum(t.numel() for t in tree.values())


def tree_leaf_order(tree: Tree) -> List[str]:
    """The names of ``tree`` in the order the reference's pytree
    flattening visits its nested params (dict keys sorted, list items by
    index): ``"conv.10.w"`` comes after ``"conv.9.w"``, and ``"fc"``
    before ``"norm"``."""
    def key(name: str):
        return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                     for p in name.split("."))
    return sorted(tree, key=key)


def tree_stack_n(tree: Tree, k: int) -> Tree:
    """K stacked copies of every tensor (a new leading node axis)."""
    return {n: t.unsqueeze(0).repeat((k,) + (1,) * t.dim())
            for n, t in tree.items()}


def tree_zeros_stacked(tree: Tree, k: int) -> Tree:
    return {n: t.new_zeros((k,) + t.shape) for n, t in tree.items()}


def tree_mean0(tree: Tree) -> Tree:
    return {n: t.mean(dim=0) for n, t in tree.items()}


def pernode_grads(fns: ModelFns, params: Tree, mstate: Tree, batch: Tree,
                  *, params_stacked: bool):
    """vmap the node dimension.  batch and mstate tensors have leading
    axis K; params too when ``params_stacked``.  Returns (losses (K,),
    grads, new_mstate), grads stacked (K, ...) either way."""
    in_dims = (0 if params_stacked else None, 0, 0)
    grads, (losses, new_ms) = vmap(grad_and_value(fns.loss_fn, has_aux=True),
                                   in_dims=in_dims)(params, mstate, batch)
    return losses, grads, new_ms
