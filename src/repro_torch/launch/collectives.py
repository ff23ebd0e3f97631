"""The intra-pod collectives of the train step as autograd functions: what
GSPMD inserts for the reference under ``sharding.py``'s placements.

- ``gather_data(w, dim, mesh)``: FSDP.  Forward: the pod's ``data``
  ranks' blocks of ``w`` all-gathered along ``dim``; backward: the
  gradient reduce-scattered back to the rank's block, summed over the
  ``data`` ranks (each holds its share of the pod's batch).
- ``copy_to_model(x, mesh)``: Megatron-LM's *f*, before a column-parallel
  projection.  Forward: the identity (``x`` is the same on every
  ``model`` rank); backward: the gradient all-reduced over ``model``
  (each rank's columns give a part of it).
- ``reduce_from_model(x, mesh)``: Megatron-LM's *g*, after a row-parallel
  projection (and in the vocabulary-parallel loss).  Forward: the
  partial sums all-reduced over ``model``; backward: the identity (the
  computation after it is the same on every ``model`` rank).
- ``reduce_from_data(x, mesh)``: *g* over ``data``, for the loss's
  numerator (each ``data`` rank sums its own sequences; the pod's loss
  is the same on every rank).  On a mesh whose ``data`` ranks each hold
  all the pod's sequences (a count the axis does not split:
  ``Mesh.with_rows_whole``) it is the identity, and ``gather_data``'s
  backward keeps the rank's block: nothing is summed over ``data``.
- ``gather_model(x, dim, mesh)``: the ``model`` ranks' blocks of ``x``
  all-gathered along ``dim`` (MLA's latent columns before its norm, the
  router's logit columns, the heads of a flash-decode); backward: the
  gradient reduce-scattered back to the rank's block, summed over
  ``model`` (the computation after the gather, on the rank's heads or
  experts, gives each rank a part of it).
- ``gather_from_model(x, dim, mesh)``: the same gather where the
  computation after it is the same on every ``model`` rank (the EP
  route's output, each rank's span of the sequences); backward: the
  rank's block of the gradient.
- ``sum_over_model(x, mesh)``: a statistic summed over ``model`` where
  every rank's own part of the activation reads the total (the SSM's
  gated RMSNorm over all of d_inner, whose channels lie split by heads);
  backward: the gradient summed over ``model`` too (each rank's part
  gives a share of the total's gradient).  ``reduce_from_model``, whose
  backward is the identity, would leave each rank its own share.
- ``all_to_all_model(x, mesh)``: the expert-parallel MoE's exchange, the
  rows of ``x`` cut into M equal blocks, block j sent to ``model`` rank
  j, the blocks received stacked in rank order; backward: the same
  exchange of the gradient, which sends each block back where it came
  from.  ``all_to_all_data(x, mesh)``: the same over ``data`` (the
  embedding's lookups: each rank's columns of every ``data`` rank's
  tokens' rows, sent to the rank that holds those tokens).

Each is the identity, with no collective, where its axis has one rank;
``gather_data``, ``gather_model``, ``copy_to_model``,
``reduce_from_model``, ``gather_from_model`` and ``sum_over_model`` also
where their ``split`` is False: the dimension lies whole on every rank of
the axis (``sharding.split``: the clamp kept it so), every rank computes
the whole result, and nothing is gathered, summed or summed again, in
the forward or the backward.  Megatron's *f* and *g* are then off
together for the block.
Every rank of a pod runs the same model code, so the collectives come in
one order on every rank, also where a checkpointed cycle runs again in
the backward.
"""
from __future__ import annotations

import torch


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return mesh.all_gather_dim(x, dim, "data")

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.reduce_scatter_dim(grad, ctx.dim, "data"), None, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return mesh.all_gather_dim(x, dim, "model")

    @staticmethod
    def backward(ctx, grad):
        return (ctx.mesh.reduce_scatter_dim(grad.contiguous(), ctx.dim,
                                            "model"), None, None)


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, mesh):
        ctx.dim, ctx.axis, ctx.mesh = dim, axis, mesh
        return mesh.all_gather_dim(x, dim, axis)

    @staticmethod
    def backward(ctx, grad):
        n = grad.shape[ctx.dim] // ctx.mesh.size_of(ctx.axis)
        return (grad.narrow(ctx.dim, ctx.mesh.coords[ctx.axis] * n, n),
                None, None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return _exchange(x, axis, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.axis, ctx.mesh), None, None


def _exchange(x: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """The tiled all-to-all over ``axis``: equal blocks of rows."""
    n = mesh.size_of(axis)
    if x.shape[0] % n:
        raise ValueError(f"all_to_all over {axis}: {x.shape[0]} rows do not "
                         f"split into {n} equal blocks")
    splits = [x.shape[0] // n] * n
    return mesh.all_to_all(x.contiguous(), splits, splits, axis=axis)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.clone(), ctx.axis), None, None


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(x.clone(), "model")

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.clone(), "model"), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return mesh.all_reduce(x.clone(), axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def gather_data(w: torch.Tensor, dim: int, mesh, split: bool = True
                ) -> torch.Tensor:
    """The rank's ``data`` block of ``w`` gathered along ``dim``; where
    every ``data`` rank holds all the pod's sequences (``mesh.rows_whole``)
    each computes the whole gradient, and the backward keeps the rank's
    block of it."""
    if not split or mesh.size_of("data") == 1:
        return w
    if mesh.rows_whole:
        return _GatherWhole.apply(w, dim, "data", mesh)
    return _GatherData.apply(w, dim, mesh)


def copy_to_model(x: torch.Tensor, mesh, split: bool = True
                  ) -> torch.Tensor:
    """*f*: ``x``; its gradient summed over ``model``."""
    if not split or mesh.size_of("model") == 1:
        return x
    return _Copy.apply(x, "model", mesh)


def reduce_from_model(x: torch.Tensor, mesh, split: bool = True
                      ) -> torch.Tensor:
    """*g*: ``x`` summed over ``model``; its gradient passed as it is."""
    if not split or mesh.size_of("model") == 1:
        return x
    return _Reduce.apply(x, "model", mesh)


def sum_over_model(x: torch.Tensor, mesh, split: bool = True
                   ) -> torch.Tensor:
    """``x`` summed over ``model``; its gradient summed over ``model``
    too."""
    if not split or mesh.size_of("model") == 1:
        return x
    return _SumBoth.apply(x, mesh)


def reduce_from_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """*g* over ``data``: ``x`` summed over the pod's ``data`` ranks; ``x``
    itself where each holds all the pod's sequences (``mesh.rows_whole``)."""
    if mesh.size_of("data") == 1 or mesh.rows_whole:
        return x
    return _Reduce.apply(x, "data", mesh)


def gather_model(x: torch.Tensor, dim: int, mesh, split: bool = True
                 ) -> torch.Tensor:
    """The ``model`` ranks' blocks of ``x`` gathered along ``dim``; the
    gradient reduce-scattered back (summed over ``model``)."""
    if not split or mesh.size_of("model") == 1:
        return x
    return _GatherModel.apply(x, dim, mesh)


def gather_from_model(x: torch.Tensor, dim: int, mesh, split: bool = True
                      ) -> torch.Tensor:
    """The ``model`` ranks' blocks of ``x`` gathered along ``dim``; the
    rank's block of the gradient (the computation after it is the same
    on every ``model`` rank)."""
    if not split or mesh.size_of("model") == 1:
        return x
    return _GatherWhole.apply(x, dim, "model", mesh)


def all_to_all_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Rows of ``x`` in M equal blocks, block j to ``model`` rank j; the
    blocks received, in rank order.  Its gradient goes back the same
    way."""
    if mesh.size_of("model") == 1:
        return x
    return _AllToAll.apply(x, "model", mesh)


def all_to_all_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """``all_to_all_model`` over ``data``."""
    if mesh.size_of("data") == 1:
        return x
    return _AllToAll.apply(x, "data", mesh)
