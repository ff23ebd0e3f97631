"""The device mesh (``repro.launch.mesh``) over ``torch.distributed``.

The reference's production mesh is (data=16, model=16) on one pod, or
(pod=2, data=16, model=16) over two.  The ``pod`` axis is the
decentralized-learning *site* axis: the paper's algorithms control the
traffic across it, and data and tensor parallelism run inside a pod.

Here a mesh is the default process group (made by
``torch.distributed.init_process_group`` under ``torchrun``, or by
``procs.spawn``) laid out pod-major over named axes, one rank a device.
Each rank belongs to one process group along each axis of size above 1:
the ``pod`` group (the ranks of its (data, model) position, one a pod),
the ``data`` group (its pod and model position), the ``model`` group
(its pod and data position), and the pod's ``("data", "model")`` group
(every rank of its pod).  The train step's cross-pod exchanges are
collectives on the pod group (``all_reduce``, ``all_gather``,
``all_to_all``), and a checkpoint ``gather``s the rows to the group's
first rank.  Inside a pod (``sharding.py``'s FSDP over ``data`` and
tensor and expert parallelism over ``model``; a width an axis does not
divide whole on every rank of it) weights are gathered and their gradients
reduce-scattered along a dimension over ``data`` (``all_gather_dim``,
``reduce_scatter_dim``), activations summed over ``model``
(``all_reduce(..., axis="model")``) or gathered along a dimension over
it (``all_gather_dim(..., "model")``: MLA's latent, the router's logits,
the heads of a flash-decode, the SSM's in-projection, the RG-LRU's gate
input), and the expert-parallel MoE's tokens exchanged over ``model``
(``all_to_all(..., axis="model")``).

``make_production_mesh`` describes the reference's layout without a
process group (what ``sharding``'s rules read); ``make_mesh`` builds one
on the running group.
"""
from __future__ import annotations

import copy
import math
import socket
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

#: mesh axes, outermost first
AXES = ("pod", "data", "model")


#: an axis of a collective: a mesh axis name, or ``INTRA``, every rank of
#: one pod
Axis = Union[str, Tuple[str, ...]]
INTRA = ("data", "model")


class Mesh:
    """A named (pod, data, model) layout of ranks: ``shape`` {axis: size}
    in ``axis_names``' order, this rank's ``coords`` on each axis, its
    ``device``, ``pod_group``, the process group of the ranks that share
    this rank's (data, model) position (None where the mesh only
    describes a layout, or has no ``pod`` axis), and ``groups``, this
    rank's process group along ``("data",)``, ``("model",)`` and
    ``INTRA`` where that axis spans more than one rank, and
    ``rows_whole``: whether each rank of the ``data`` axis holds every
    one of the pod's sequences (``with_rows_whole``).  A collective along
    an axis of size 1 sends nothing and returns its input (the pod axis
    excepted: its group always exists on a mesh made by ``make_mesh``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 coords: Optional[Sequence[int]] = None, device=None,
                 pod_group=None):
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(
                axis_names) or not set(axis_names) <= set(AXES):
            raise ValueError(f"mesh axes {tuple(axis_names)} of shape "
                             f"{tuple(shape)}: want distinct names of {AXES}, "
                             "one size each")
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(n) for a, n in zip(axis_names, shape)}
        self.coords = dict(zip(self.axis_names, coords or
                               (0,) * len(self.axis_names)))
        self.device = None if device is None else torch.device(device)
        self.pod_group = pod_group
        self.groups: Dict[Tuple[str, ...], Any] = {}
        self.rows_whole = False

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, coords={self.coords}, "
                f"device={self.device})")

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def pod_rank(self) -> int:
        """This rank's index on the ``pod`` axis (0 without one)."""
        return self.coords.get("pod", 0)

    def with_rows_whole(self, whole: bool = True) -> "Mesh":
        """This mesh, its groups and records shared, as a step runs a
        pod's sequences that its ``data`` axis does not split (the clamp
        keeps the count whole): every ``data`` rank runs all of them, so
        ``collectives.gather_data``'s backward keeps the rank's block of
        the whole gradient and ``reduce_from_data`` sums nothing.  The
        mesh itself where ``whole`` is False."""
        if not whole:
            return self
        view = copy.copy(self)
        view.rows_whole = True
        return view

    def size_of(self, axis: Axis) -> int:
        """Ranks along ``axis`` (a name or a tuple of names)."""
        return math.prod(self.shape.get(a, 1) for a in _names(axis))

    def group(self, axis: Axis):
        """The process group along ``axis``."""
        return self.pod_group if axis == "pod" else self.groups[
            _names(axis)]

    # -- collectives: the backend takes the tensors where they lie (gloo
    # stages CUDA tensors through the host itself)

    def all_reduce(self, x: torch.Tensor, axis: Axis = "pod",
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``x`` reduced by ``op`` (a sum by default) over the group along
        ``axis`` (the pod group by default), in place; returned."""
        if axis != "pod" and self.size_of(axis) == 1:
            return x
        dist.all_reduce(x, op=op, group=self.group(axis))
        return x

    def all_gather_dim(self, x: torch.Tensor, dim: int,
                       axis: Axis) -> torch.Tensor:
        """The blocks of the group along ``axis`` concatenated along
        ``dim`` in rank order: a new tensor, ``dim`` n times as long."""
        n = self.size_of(axis)
        if n == 1:
            return x
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather_single()(out, x.contiguous(), group=self.group(axis))
        return out.view((n,) + tuple(x.shape)).movedim(0, dim).flatten(
            dim, dim + 1)

    def reduce_scatter_dim(self, x: torch.Tensor, dim: int,
                           axis: Axis) -> torch.Tensor:
        """``x`` summed over the group along ``axis``, of which this rank
        keeps its block of ``dim`` (cut into n equal blocks, rank order):
        a new tensor, ``dim`` n times as short.  The inverse of
        ``all_gather_dim``'s layout."""
        n = self.size_of(axis)
        if n == 1:
            return x
        blocks = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(
            dim, 0).contiguous()
        out = blocks.new_empty(blocks.shape[1:])
        _reduce_scatter_single()(out, blocks.flatten(0, 1),
                                 group=self.group(axis))
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The pod group's ``x`` (each (L, ...), contiguous) stacked in pod
        order: (pod size x L, ...), a new tensor."""
        out = x.new_empty((n_pods(self) * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather_single()(out, x, group=self.pod_group)
        return out

    def gather(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The pod group's ``x`` (each (L, ...)) stacked in pod order on the
        group's first rank, a new tensor there; None on the others.  Gloo
        gathers host tensors, so under gloo ``x`` is copied to the host
        first and the result lies there."""
        if dist.get_backend(self.pod_group) == "gloo":
            x = x.cpu()
        x = x.contiguous()
        first = self.pod_rank == 0
        parts = ([torch.empty_like(x) for _ in range(n_pods(self))]
                 if first else None)
        dist.gather(x, parts, dst=dist.get_global_rank(self.pod_group, 0),
                    group=self.pod_group)
        return torch.cat(parts) if first else None

    def all_to_all(self, x: torch.Tensor, in_splits: Sequence[int],
                   out_splits: Sequence[int],
                   axis: Axis = "pod") -> torch.Tensor:
        """Rows of ``x`` (contiguous; its first ``in_splits[0]`` rows to
        rank 0 of the group along ``axis``, the pod group by default, the
        next ``in_splits[1]`` to 1, ...) exchanged over that group: the
        rows each rank sent here, in rank order, ``sum(out_splits)`` of
        them."""
        out = x.new_empty((sum(out_splits),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x, list(out_splits), list(in_splits),
                               group=self.group(axis))
        return out

    def barrier(self) -> None:
        """Returns once every rank of the mesh has reached it: a
        one-element all-reduce on the mesh's device over the pod group,
        then over the pod's ranks (each rank of a pod waits for a rank
        that waited for every pod)."""
        self.all_reduce(torch.zeros(1, device=self.device))
        self.all_reduce(torch.zeros(1, device=self.device), INTRA)


def _names(axis: Axis) -> Tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


def _all_gather_single():
    """``all_gather_single`` where this PyTorch has it (2.13 names
    ``all_gather_into_tensor`` so), else ``all_gather_into_tensor``."""
    return getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor


def _reduce_scatter_single():
    """``reduce_scatter_single`` where this PyTorch has it (2.13 names
    ``reduce_scatter_tensor`` so), else ``reduce_scatter_tensor``."""
    return getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor


# ---------------------------------------------------------------------------
# The reference's names
# ---------------------------------------------------------------------------

def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production layout, (2, 16, 16) over (pod, data,
    model) or (16, 16) over (data, model), as a description: no process
    group (``sharding``'s rules read its shape)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def mesh_axes(mesh: Mesh) -> tuple:
    return tuple(mesh.axis_names)


def n_pods(mesh: Mesh) -> int:
    return mesh.shape.get("pod", 1)


def devices_per_pod(mesh: Mesh) -> int:
    """Devices inside one pod: the rank stride of the ``pod`` axis (axes
    are ordered pod-major)."""
    return mesh.size // n_pods(mesh)


def batch_axes(mesh: Mesh) -> tuple:
    """Mesh axes the global batch shards over (the data axis; the pod axis
    is the explicit site dimension)."""
    return ("data",)


# ---------------------------------------------------------------------------
# A mesh over the running process group
# ---------------------------------------------------------------------------

def make_mesh(shape: Sequence[int], axes: Sequence[str] = AXES, *,
              device) -> Mesh:
    """The mesh of ``shape`` over ``axes`` on the default process group,
    which must be initialized with ``prod(shape)`` ranks; this rank's
    coordinates are its rank unravelled pod-major.  Every rank calls it
    (it makes the groups).  ``device`` is this rank's.  Every model is
    placed on any ``data`` and ``model`` axes: a width an axis does not
    divide is whole on every rank of it (``sharding.split``).

    Raises ``ValueError``, before any collective, under NCCL where two
    ranks hold one device (NCCL would abort at the first collective)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "torch.distributed.init_process_group (or run "
                           "under repro_torch.launch.procs.spawn) first")
    mesh = Mesh(shape, axes, device=device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if mesh.size != world:
        raise ValueError(f"make_mesh: shape {tuple(shape)} holds {mesh.size} "
                         f"ranks, the process group {world}")
    if dist.get_backend() == "nccl":
        check_devices(_device_ids(mesh.device), "nccl")
    coords = np.unravel_index(rank, tuple(mesh.shape.values()))
    mesh.coords = dict(zip(mesh.axis_names, (int(c) for c in coords)))
    grid = np.arange(world).reshape(tuple(mesh.shape.values()))
    for axis in ("pod", "data", "model", INTRA):
        names = [a for a in _names(axis) if a in mesh.axis_names]
        if not names or (axis != "pod" and mesh.size_of(axis) == 1):
            continue
        # one group a position on the other axes, every rank making each
        idx = [mesh.axis_names.index(a) for a in names]
        lines = np.moveaxis(grid, idx, list(range(-len(idx), 0))).reshape(
            -1, mesh.size_of(axis))
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                if axis == "pod":
                    mesh.pod_group = group
                else:
                    mesh.groups[tuple(names)] = group
    return mesh


def check_devices(ids: Sequence[Tuple[str, str]], backend: str) -> None:
    """Raises ``ValueError`` where ``backend`` is NCCL and two ranks'
    (host, device) identities in ``ids`` (one a rank) are one: NCCL takes
    one device a rank."""
    if backend != "nccl":
        return
    seen: Dict[Tuple[str, str], int] = {}
    for r, key in enumerate(ids):
        if key in seen:
            raise ValueError(
                f"NCCL takes one device a rank: ranks {seen[key]} and {r} "
                f"share {key[1]} on {key[0]}; run one rank a card, or "
                "choose the gloo backend")
        seen[key] = r


def _device_ids(device) -> List[Tuple[str, str]]:
    """Every rank's (host, device UUID), gathered over a gloo group."""
    dev = torch.device(device)
    props = torch.cuda.get_device_properties(dev)
    mine = (socket.gethostname(), str(getattr(props, "uuid", dev.index)))
    out: List = [None] * dist.get_world_size()
    dist.all_gather_object(out, mine, group=dist.new_group(backend="gloo"))
    return [tuple(x) for x in out]
