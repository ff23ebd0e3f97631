"""Train and serve steps of the LM (``repro.launch.steps``), with the
paper's communication strategies as a stage of the train step.

The decentralized sites ("pods") are the train state's stacked leading
axis, as the reference's state is pod-stacked: each pod trains its own
replica on its own batch.  Without a mesh every pod lies on one card.
With a ``mesh`` (``launch.mesh.make_mesh``, one or more ranks along its
``pod`` axis) a rank holds its own block of L = n_pods / (pod-axis size)
pods, the block the ``pod`` entry of ``sharding.train_state_shardings``
and ``batch_shardings`` places on it, and every cross-pod exchange is
local work on those rows plus a collective on the pod group
(``make_exchange``):

  bsp:    grads averaged across pods every step: a float32 sum of the
          local rows, ``all_reduce`` of the sum, / n_pods, one cast
  gaia:   |accumulated update| > T |weight| (``ops.gaia_select_many`` on
          the local rows), the selections summed across pods the same
          way; T = t0 * lr / lr0 (lr0 defaults to the construction-time
          lr)
  fedavg: params averaged across pods every ``iter_local`` steps
  dgc:    per-pod global-norm clip, momentum correction, then the
          256-bin histogram top-s% of each pod's accumulated update
          (``ops.dgc_sparsify``, one launch a (local pod, leaf)), summed
          across pods
  dpsgd:  gossip over a ``TopologySchedule`` fabric: self weight plus
          weighted neighbours, float32 accumulate, one cast.  On one
          card ``ops.neighbor_mix_many`` over the stacked rows; on a mesh
          every pod's rows of a dtype group gathered (``all_gather``:
          P - 1 models in, as the reference's ring ships P - 1
          rotations), then ``ops.neighbor_mix_src_many`` with the self
          term on the local rows and the neighbours from the gathered
          ones
  adpsgd: the same, each neighbour read from a bounded-staleness
          snapshot buffer.  On one card ``ops.neighbor_mix_push_many``
          pushes and gathers in one launch; on a mesh each rank pushes
          its own rows, ships each reading rank the rows that rank reads
          of it (``all_to_all``: one model a (source, destination) pair,
          the reference's wire volume) and mixes the received rows with
          ``ops.neighbor_mix_src_many``

The two routes compute one function: the same float32 sums (the
reduction's order aside: with two pods each sum is one addition) and the
same kernel arithmetic on the same rows.  Without a mesh the gossip keeps
its fused one-card kernels: the mesh route over a group of one would add
the flatten and gather, or the pick and all-to-all, copies to the same
function (``chip_smoke.py`` phase 12(d) times both).  The step reads
nothing back from the card: ``step_idx``, ``lr`` and ``sparsity`` are
host numbers, the gossip operands (the all-to-all's routing too) are
built and checked on the host by ``gossip_operands``, and every metric is
a tensor.

Inside a pod (a mesh whose ``data`` or ``model`` axis is above 1; every
family, any widths: a dimension an axis does not divide is whole on
every rank of it, as the reference's clamp keeps it) a rank holds its
block of every leaf of its
pods, FSDP over ``data``, tensor parallelism over ``model`` and the
experts over ``model`` as ``sharding.param_shardings`` places them, and
its ``data`` share of each pod's sequences.  The model runs under
``shard_hints.activation_sharding`` (weights gathered over ``data`` and
their gradients reduce-scattered, heads, FFN columns, experts and
vocabulary split over ``model``: ``launch.collectives``; a MoE layer by
the step's ``moe_route``); the replicated leaves' gradients are summed
after the backward (``sharding.grad_sync_axis``: over ``data``, and over
``model`` too for the leaves that act on the rank's heads or
channels).  Every
exchange above then runs unchanged on the rank's blocks over its pod
group (the ranks of its (data, model) position), but DGC's threshold,
which needs the whole leaf: for a sharded leaf max|v| is all-reduced
(MAX) over the ranks that hold its blocks, each rank's
``ops.abs_histogram`` over [0, that max] is summed there (integers: the
whole leaf's histogram, bit for bit), and ``ops.dgc_select`` keeps what
passes the threshold ``dgc_topk.threshold_by_count`` reads from it, the
one-card selection.  The function computed is the one-card step's.

The serve steps take the same mesh for one site (pod axis 1): the rank's
blocks of the weights, of the decode cache (``sharding.cache_shardings``)
and its rows of the requests, for every family (``make_prefill_step``,
``make_encode_step``, ``make_serve_step``).

The kernels take leaves of one dtype a launch, so a model whose leaves
mix dtypes (bf16 weights, float32 norms) gets one launch a dtype group:
Gaia's float32 accumulated update against bf16 weights is one instance
of ``csrc/gaia_select.cu``, against float32 weights the other.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import pytree
from repro_torch.configs.base import CommConfig, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import dgc_topk, ops
from repro_torch.launch import sharding
from repro_torch.launch.mesh import Mesh, n_pods as mesh_pods
from repro_torch.models.model import (decode_step, forward, init_cache,
                                      init_model, loss_fn)
from repro_torch.models.encdec import encoder_apply
from repro_torch.models.moe import ROUTES
from repro_torch.models.shard_hints import activation_sharding
from repro_torch.models.transformer import lm_decode
from repro_torch.topology.graphs import Topology, TopologySchedule, as_schedule

#: strategies whose cross-pod exchange is gossip over a topology fabric:
#: their train step takes the round's ``gossip_operands``
GOSSIP_STRATEGIES = ("dpsgd", "adpsgd")
STRATEGIES = ("bsp", "gaia", "fedavg", "dgc") + GOSSIP_STRATEGIES


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------

def dtype_groups(leaves: List[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    """The indices of ``leaves`` by dtype, each group in leaf order, the
    groups in the order of their first leaf."""
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(leaves):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def local_pods(n_pods: int, mesh: Optional[Mesh] = None) -> range:
    """The pods this rank holds: the block of a pod-stacked axis of
    ``n_pods`` that the ``pod`` entry of the state's and the batch's
    shardings places on it (every pod without a mesh).  Raises
    ``ValueError`` where the pod axis does not split ``n_pods``."""
    if mesh is None:
        return range(n_pods)
    (rows,) = sharding.local_slices(("pod",), (n_pods,), mesh)
    return range(rows.start, rows.stop)


def make_train_state(params, comm: CommConfig, n_pods: int, *,
                     mesh: Optional[Mesh] = None) -> Dict:
    """The pod-stacked train state of ``params`` (one replica's tree), the
    rank's L = ``len(local_pods(n_pods, mesh))`` rows of it (all n_pods
    without a mesh): ``"params"``, every leaf copied to (L, ...);
    ``"vel"``, float32 zeros of that shape; ``"acc"`` (gaia, dgc), the
    same; for adpsgd ``"snaps"``, the bounded-staleness snapshot buffer:
    for each dtype of the leaves (``"bfloat16"``, ``"float32"``) one
    (max_staleness + 1, L, N) tensor of that dtype, the pod's leaves of
    the dtype flattened side by side in the reference's leaf order (N
    their sizes summed), every slot the stacked params.  The reference
    keeps one (max_staleness + 1, n_pods, ...) buffer a leaf; this is the
    layout the gossip kernel pushes and gathers in one launch.  Slot 0
    holds the newest round.  On a mesh with a ``data`` or ``model`` axis
    above 1 every leaf is the rank's block (``sharding.local_params``),
    the snapshot buffers those blocks side by side."""
    rows = len(local_pods(n_pods, mesh))
    if sharding.intra_pod(mesh):
        params = sharding.local_params(params, mesh)
    stack = lambda t: t.unsqueeze(0).repeat((rows,) + (1,) * t.dim())
    zeros = lambda t: torch.zeros((rows,) + tuple(t.shape),
                                  dtype=torch.float32, device=t.device)
    state = {"params": pytree.tree_map(stack, params),
             "vel": pytree.tree_map(zeros, params)}
    if comm.strategy in ("gaia", "dgc"):
        state["acc"] = pytree.tree_map(zeros, params)
    if comm.strategy == "adpsgd":
        leaves = pytree.leaves(state["params"])
        state["snaps"] = {
            pytree.dtype_name(dt): torch.cat(
                [leaves[i].reshape(rows, -1) for i in idx], dim=1
            )[None].repeat(comm.max_staleness + 1, 1, 1)
            for dt, idx in dtype_groups(leaves).items()}
    return state


def param_shape(cfg: ModelConfig):
    """The parameter tree of ``cfg`` as ``meta`` tensors (shapes and
    dtypes, nothing allocated): what ``sharding``'s rules read."""
    return init_model(None, cfg, "meta")


def cache_shape(cfg: ModelConfig, global_batch: int, seq_len: int,
                long_mode: bool = False):
    """The decode cache of ``make_serve_step`` as ``meta`` tensors."""
    return init_cache(cfg, global_batch, seq_len, long_mode, device="meta")


def train_state_shape(cfg: ModelConfig, comm: CommConfig, n_pods: int
                      ) -> Dict:
    """The whole pod-stacked train state as ``meta`` tensors."""
    return make_train_state(param_shape(cfg), comm, n_pods)


# ---------------------------------------------------------------------------
# Gossip fabric plumbing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Route:
    """AD-PSGD's all-to-all on a mesh, built on the host: ``send`` (int64,
    on the device), the rows of this rank's pushed snapshot buffer,
    viewed ((S + 1) L, N), that it ships, grouped by destination pod rank
    (``in_splits[r]`` rows to rank r); ``out_splits[r]`` rows come from
    rank r, in rank order."""
    send: torch.Tensor
    in_splits: Tuple[int, ...]
    out_splits: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class GossipOperands:
    """A gossip round's operands on the device.  ``mix``, what the gossip
    kernel reads for this rank's pods, range-checked on the host: the
    reference's padded ``nbr_idx`` into the stacked rows (dpsgd), or
    ``stale * K + nbr_idx`` into the ((S + 1) K) rows of the snapshot
    buffer (adpsgd), with its ``nbr_w`` and ``self_w``; on a mesh the
    index names rows of the gathered pods (dpsgd) or of the received rows
    (adpsgd).  ``mean_degree``: active neighbours a pod over every pod,
    float32 0-d; for adpsgd (None for dpsgd) ``mean_staleness``, the
    reads' mean staleness slot, and on a mesh ``route``, its
    all-to-all."""
    mix: ops.MixOperands
    mean_degree: torch.Tensor
    mean_staleness: Optional[torch.Tensor] = None
    route: Optional[Route] = None


def gossip_operands(fabric: Union[Topology, TopologySchedule], t: int, *,
                    pad_degree: Optional[int] = None,
                    staleness: Optional[int] = None,
                    max_staleness: Optional[int] = None,
                    device=None, mesh: Optional[Mesh] = None
                    ) -> GossipOperands:
    """Round ``t``'s mix operands for the gossip train step, on ``device``
    (CUDA by default), padded to the schedule-wide max degree (or
    ``pad_degree``), so every round of a rotating schedule has one shape.
    With ``staleness`` (adpsgd) the reads of slot ``staleness`` of a
    buffer of ``max_staleness + 1`` slots; a staleness outside [0,
    max_staleness], or none given with it, raises ``ValueError``, as a
    slot outside the buffer cannot be read.  With ``mesh``, this rank's
    pods' operands (``local_pods``) and, for adpsgd, the all-to-all's
    routing.  Built and checked on the host, uploaded once: a step that
    takes them reads nothing back."""
    device = resolve_device(device)
    sched = as_schedule(fabric)
    idx, w, sw = sched.neighbor_arrays(int(t), pad_degree=pad_degree)
    K = idx.shape[0]
    on = w > 0
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    degree = f32(on.sum() / K)
    rows = np.asarray(local_pods(K, mesh))
    if staleness is None:
        # dpsgd: the index names stacked rows, on a mesh the gathered ones
        return GossipOperands(ops.mix_operands(idx[rows], w[rows], sw[rows],
                                               K, device), degree)
    if max_staleness is None:
        raise ValueError(
            "staleness needs max_staleness (= comm.max_staleness, the "
            "snapshot-buffer depth) so out-of-buffer slots are refused")
    if not 0 <= staleness <= max_staleness:
        raise ValueError(
            f"staleness {staleness} outside the snapshot buffer bound "
            f"[0, {max_staleness}] fixed at construction "
            "(comm.max_staleness)")
    stale = np.where(on, int(staleness), 0).astype(np.int32)
    common = dict(mean_degree=degree,
                  mean_staleness=f32((stale * on).sum() / max(on.sum(), 1)))
    if mesh is None:
        return GossipOperands(
            ops.mix_operands(stale * K + idx, w, sw, (max_staleness + 1) * K,
                             device), **common)
    route, recv_idx, n_recv = _adpsgd_route(idx, on, stale, mesh)
    return GossipOperands(
        ops.mix_operands(recv_idx, w[rows], sw[rows], n_recv, device),
        route=Route(torch.from_numpy(route[0]).to(device), route[1],
                    route[2]), **common)


def _adpsgd_route(idx: np.ndarray, on: np.ndarray, stale: np.ndarray,
                  mesh: Mesh):
    """AD-PSGD's exchange on a mesh, from the round's (K, D) operands:
    every rank reads, for its pods, the rows (source pod j, slot s) of
    its active entries, each pair once; the rank holding pod j sends
    them, rank by rank, in (j, s) order.  Returns ((send rows into this
    rank's pushed ((S + 1) L, N) buffer, in_splits, out_splits), this
    rank's (L, D) index into the rows it receives, their count).  A rank
    whose pods read no neighbour this round (the odd pod out of a random
    matching) receives no row: its count is 0, and it still takes part
    in the all-to-all."""
    K = idx.shape[0]
    G = mesh_pods(mesh)
    L, me = K // G, mesh.pod_rank
    reads = [sorted({(int(idx[k, d]), int(stale[k, d]))
                     for k in range(r * L, (r + 1) * L)
                     for d in range(idx.shape[1]) if on[k, d]})
             for r in range(G)]
    send, in_splits = [], []
    for dest in range(G):
        mine = [s * L + j - me * L for j, s in reads[dest] if j // L == me]
        send += mine
        in_splits.append(len(mine))
    at, out_splits = {}, []
    for src in range(G):
        got = [(j, s) for j, s in reads[me] if j // L == src]
        for pair in got:
            at[pair] = len(at)
        out_splits.append(len(got))
    rows = range(me * L, (me + 1) * L)
    recv_idx = np.array([[at[(int(idx[k, d]), int(stale[k, d]))]
                          if on[k, d] else 0 for d in range(idx.shape[1])]
                         for k in rows], dtype=np.int32)
    return ((np.array(send, dtype=np.int64), tuple(in_splits),
             tuple(out_splits)), recv_idx, len(at))


# ---------------------------------------------------------------------------
# Histogram-quantile threshold (plain twin of the reference's)
# ---------------------------------------------------------------------------

def hist_threshold(v: torch.Tensor, sparsity, n_bins: int = 256
                   ) -> torch.Tensor:
    """The reference's ``hist_threshold``: the upper edge of the first
    ``n_bins``-histogram bin of |v| over [0, max(max|v|, 1e-30)] whose
    float32 cumulative count reaches ``sparsity * v.numel()`` (left
    ``searchsorted``), clipped to the last bin; float32 0-d.  The count
    to reach is rounded as the reference rounds it: a host number times
    the size in double, rounded once to float32; a tensor (the
    reference's traced operand) in float32.  ``ops.dgc_sparsify`` takes
    a host number and rounds it to float32 first (C10 in ROADMAP.md)."""
    a = v.reshape(-1).abs().float()
    vmax = torch.clamp(a.max(), min=1e-30)
    idx = (a / vmax * n_bins).to(torch.int32).clamp_(0, n_bins - 1)
    hist = torch.bincount(idx, minlength=n_bins)
    cum = torch.cumsum(hist, 0).float()
    if isinstance(sparsity, torch.Tensor):
        target = sparsity.to(torch.float32, copy=True).reshape(1) * a.numel()
    else:
        target = torch.tensor([np.float32(float(sparsity) * a.numel())],
                              device=v.device)
    b = torch.searchsorted(cum, target).clamp_(0, n_bins - 1)[0]
    return dgc_topk.bin_threshold(b, n_bins, vmax)


# ---------------------------------------------------------------------------
# The cross-pod exchange
# ---------------------------------------------------------------------------

def make_exchange(comm: CommConfig, *, mesh: Optional[Mesh] = None,
                  lr: float = 1e-3, lr0: Optional[float] = None,
                  specs: Optional[List] = None) -> Callable:
    """Returns ``exchange(parts, step_idx=0, mix=None, lr=None,
    sparsity=None) -> parts``, the train step's cross-pod exchange on
    this rank's rows (every pod's without a mesh).  ``parts`` maps names
    to lists of stacked (L, ...) leaves in ``pytree.leaves``' order, as
    the strategy takes them after the local momentum step (bsp: before
    it), and the result holds the new lists:

      bsp     {"grads"} -> the pods' mean gradient, each row
      fedavg  {"params"} -> the pods' mean at a sync step, else as given
      gaia    {"params", "acc"} -> params plus the other pods' selected
              updates, acc with the selection taken out
      dgc     {"params", "acc", "vel"} (params before the step) -> params
              plus every pod's selection, acc and vel masked
      dpsgd   {"params"} -> mixed
      adpsgd  {"params", "snaps"} -> mixed, and the pushed buffer

    Sums across pods are float32: the local rows' sum, then (on a mesh of
    more than one pod) one ``all_reduce`` of every leaf's sum in one
    buffer; the gossip
    reads the gathered or received rows (module docstring).  ``lr``
    drives Gaia's threshold (T = t0 lr / lr0), ``sparsity`` overrides
    ``comm.dgc_sparsity``, ``mix`` is the round's ``gossip_operands``.
    ``specs``: each leaf's spec (``sharding.leaf_specs``) where the leaves
    are the rank's blocks on a mesh with a ``data`` or ``model`` axis
    (DGC's threshold then reads the whole leaf: module docstring); every
    leaf is whole without."""
    if comm.strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {comm.strategy!r}; known: "
                         f"{STRATEGIES}")
    group = 1 if mesh is None else mesh_pods(mesh)
    lr_static, lr_ref = lr, (lr if lr0 is None else lr0)
    split = shard_axes(specs, mesh)

    def pod_sum(xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each float32 (L, ...) tensor summed over every pod: (1, ...)
        (the local rows' sum, all-reduced where the pod axis has more
        than one rank)."""
        sums = [x.sum(0, keepdim=True) for x in xs]
        if group == 1:
            return sums
        flat = mesh.all_reduce(torch.cat([x.reshape(-1) for x in sums]))
        return [f.view(x.shape) for f, x in
                zip(flat.split([x.numel() for x in sums]), sums)]

    def mean(xs: List[torch.Tensor]) -> List[torch.Tensor]:
        n = xs[0].shape[0] * group
        return [(m / n).to(x.dtype).expand_as(x) for m, x in
                zip(pod_sum([x.float() for x in xs]), xs)]

    def by_dtype(fn, xs, *rest):
        """``fn`` on each dtype group of ``xs`` (and the same leaves of
        ``rest``), its per-leaf results back in leaf order."""
        out = [None] * len(xs)
        for idx in dtype_groups(xs).values():
            for i, y in zip(idx, fn([xs[i] for i in idx],
                                    *([r[i] for i in idx] for r in rest))):
                out[i] = y
        return out

    def flat_rows(xs, out=None):
        """The (L, ...) leaves' rows side by side: (L, N), into ``out``."""
        return torch.cat([x.reshape(x.shape[0], -1) for x in xs], dim=1,
                         out=out)

    def dgc_selections(acc, s):
        """Each (L, ...) leaf's rows' top-s% selections: one
        ``ops.dgc_sparsify`` a whole row; a sharded row's threshold from
        the whole leaf's histogram, summed over the ranks of its
        blocks."""
        axes = [None] * len(acc) if split is None else split
        sel = [None if ax else torch.stack([ops.dgc_sparsify(a[i], s)[0]
                                            for i in range(a.shape[0])])
               for a, ax in zip(acc, axes, strict=True)]
        for axis in dict.fromkeys(ax for ax in axes if ax):
            rows = [(j, i) for j, ax in enumerate(axes) if ax == axis
                    for i in range(acc[j].shape[0])]
            vmax = torch.stack([acc[j][i].abs().amax().float()
                                for j, i in rows])
            mesh.all_reduce(vmax, axis, op=dist.ReduceOp.MAX)
            hist = torch.stack([ops.abs_histogram(acc[j][i], vmax[k])
                                for k, (j, i) in enumerate(rows)])
            mesh.all_reduce(hist, axis)
            picked = {}
            for k, (j, i) in enumerate(rows):
                t = dgc_topk.threshold_by_count(hist[k], vmax[k], s)
                picked[j, i] = ops.dgc_select(acc[j][i], t)[0]
            for j in {j for j, _ in rows}:
                sel[j] = torch.stack([picked[j, i]
                                      for i in range(acc[j].shape[0])])
        return sel

    def exchange(parts, step_idx=0, mix=None, lr=None, sparsity=None):
        strategy = comm.strategy
        if strategy == "bsp":
            return {"grads": mean(parts["grads"])}
        params = parts["params"]
        if strategy == "fedavg":
            il = comm.iter_local
            if int(step_idx) % il != il - 1:
                return {"params": params}
            return {"params": [m.contiguous() for m in mean(params)]}
        if strategy == "gaia":
            acc = parts["acc"]
            # a fill on the device, not a copy from the host, which would
            # wait for the card
            lr_t = lr_static if lr is None else lr
            thresh = torch.full((), comm.gaia_t0 * (lr_t / lr_ref),
                                dtype=torch.float32, device=params[0].device)
            sel = by_dtype(lambda w, a: ops.gaia_select_many(a, w, thresh)[0],
                           params, acc)
            return {"params": [(w.float() + (t - s_)).to(w.dtype) for w, t, s_
                               in zip(params, pod_sum(sel), sel)],
                    "acc": [a * (s_ == 0) for a, s_ in zip(acc, sel)]}
        if strategy == "dgc":
            acc, vel = parts["acc"], parts["vel"]
            s = comm.dgc_sparsity if sparsity is None else sparsity
            sel = dgc_selections(acc, s)
            keep = [s_ == 0 for s_ in sel]
            return {"params": [(w.float() + t).to(w.dtype) for w, t in
                               zip(params, pod_sum(sel))],
                    "acc": [a * k for a, k in zip(acc, keep)],
                    "vel": [u * k for u, k in zip(vel, keep)]}
        if strategy == "dpsgd":
            if mesh is None:
                return {"params": by_dtype(
                    lambda xs: ops.neighbor_mix_many(xs, mix.mix), params)}
            return {"params": by_dtype(lambda xs: ops.neighbor_mix_src_many(
                xs, mesh.all_gather(flat_rows(xs)), mix.mix), params)}
        snaps, out = {}, [None] * len(params)
        for dt, idx in dtype_groups(params).items():
            name = pytree.dtype_name(dt)
            xs = [params[i] for i in idx]
            if mesh is None:
                ys, snaps[name] = ops.neighbor_mix_push_many(
                    xs, parts["snaps"][name], mix.mix)
            else:
                # the push into a new buffer, the fused kernel's traffic:
                # slot 0 this round's rows, slot s the old slot s - 1
                old = parts["snaps"][name]
                snaps[name] = new = torch.empty_like(old)
                new[1:].copy_(old[:-1])
                flat_rows(xs, out=new[0])
                r = mix.route
                sent = snaps[name].flatten(0, 1).index_select(0, r.send)
                ys = ops.neighbor_mix_src_many(
                    xs, mesh.all_to_all(sent, r.in_splits, r.out_splits),
                    mix.mix)
            for i, y in zip(idx, ys):
                out[i] = y
        return {"params": out, "snaps": snaps}

    return exchange


def shard_axes(specs: Optional[List], mesh: Optional[Mesh]) -> List:
    """For each leaf placed by ``specs`` on ``mesh``: the axis over which
    its blocks lie (``"data"``, ``"model"`` or ``mesh.INTRA``; axes of one rank
    left out), None for a whole leaf.  None without ``specs`` (every leaf
    whole)."""
    if specs is None or mesh is None:
        return None
    out = []
    for spec in specs:
        axes = tuple(a for a in ("data", "model")
                     if a in spec and mesh.size_of(a) > 1)
        out.append(None if not axes else axes if len(axes) > 1
                   else axes[0])
    return out


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, comm: CommConfig, *,
                    mesh: Optional[Mesh] = None, lr: float = 1e-3,
                    lr0: Optional[float] = None, momentum: float = 0.9,
                    weight_decay: float = 0.0, remat: bool = True,
                    chunk: int = 512, moe_route: str = "dense") -> Callable:
    """Returns ``train_step(state, batch, step_idx, mix=None, lr=None,
    sparsity=None) -> (state, metrics)``, a new state (the old one is not
    written).  ``state`` holds this rank's L pods (``make_train_state``
    with the same ``mesh``); ``batch`` leaves are the global (n_pods, b,
    ...) ones (``"tokens"``, ``"labels"``, and ``"patches"`` or
    ``"frames"`` where the arch reads them), of which the step takes the
    rank's rows.

    The local pods' forwards run in turn, each pod's ``loss_fn`` on its
    own views of the stacked leaves, and one ``torch.autograd.grad`` of
    the summed losses lands each pod's gradient in its own row.  Then a
    per-pod momentum step (float32 velocity) and the strategy's exchange
    (``make_exchange``; the step calls ``train_step.exchange``, which a
    check may wrap; ``train_step.pod_grads(params, batch)`` is the
    forward and backward alone, on the rank's stacked params and its rows
    of the batch).  ``metrics``: ``"loss"`` (the mean over every pod,
    the same on every rank), and for dpsgd and adpsgd ``"mean_degree"``
    and ``"comm_floats"`` (per-pod floats sent: one model a neighbour),
    for adpsgd ``"mean_staleness"``; each a float32 0-d tensor.

    On a mesh with a ``data`` or ``model`` axis above 1 the state holds
    the rank's blocks (a width an axis does not divide whole on every
    rank of it) and each pod's sequences split over ``data`` (all of
    them on every ``data`` rank where the axis does not divide them:
    ``Mesh.with_rows_whole``): the module docstring.

    ``moe_route``: the MoE layers' function (``moe.moe_apply``):
    ``"dense"``, the reference's default, or ``"ep"``, its
    ``REPRO_MOE_EP`` route (ROADMAP C11), which runs where a pod's
    tokens split over its ranks (``moe_ep.ep_applicable_seq``) and the
    dense route elsewhere, as in the reference.  Under ``remat`` a
    checkpointed cycle routes again in the backward, on the same inputs:
    the same collectives in the same order, the same experts.

    Runtime operands: ``step_idx`` an int (fedavg's sync step); ``mix``
    the round's ``gossip_operands`` for this mesh (dpsgd, adpsgd:
    required); ``lr`` a host number overriding the static ``lr`` (it
    drives Gaia's threshold decay); ``sparsity`` a host number
    overriding ``comm.dgc_sparsity``.
    """
    if moe_route not in ROUTES:
        raise ValueError(f"moe_route {moe_route!r}; known: {ROUTES}")
    shape = param_shape(cfg)
    n_model = float(sum(t.numel() for t in pytree.leaves(shape)))
    intra = sharding.intra_pod(mesh)
    specs = sharding.leaf_specs(shape, mesh) if intra else None
    split = shard_axes(specs, mesh)
    # the replicated leaves' gradient sums after the backward, by axis
    syncs: Dict = {}
    if intra:
        for i, ((path, _), spec, block_split) in enumerate(zip(
                pytree.leaves_with_paths(shape), specs,
                sharding.block_splits(shape, mesh))):
            axis = sharding.grad_sync_axis(path, spec, mesh,
                                           block_split=block_split)
            if axis is not None:
                syncs.setdefault(axis, []).append(i)
    exchange = make_exchange(comm, mesh=mesh, lr=lr, lr0=lr0, specs=specs)
    lr_static = lr
    gossip = comm.strategy in GOSSIP_STRATEGIES
    group = 1 if mesh is None else mesh_pods(mesh)

    def pod_grads(params, batch, rows_whole=False):
        """(losses (L,), grads): each leaf's gradient (L, ...) in its
        dtype, in ``pytree.leaves``' order; inside a pod the rank's blocks
        of the pod's gradient.  ``rows_whole``: ``batch`` holds every
        sequence of the pod on every ``data`` rank (``local_batch``), so
        nothing is summed over ``data`` (``Mesh.with_rows_whole``)."""
        layout = activation_sharding(mesh.with_rows_whole(rows_whole)) \
            if intra else contextlib.nullcontext()
        with torch.enable_grad(), layout:
            leaves = [t.detach().requires_grad_()
                      for t in pytree.leaves(params)]
            tree = pytree.unflatten(params, leaves)
            losses = torch.stack([
                loss_fn(pytree.tree_map(lambda t: t[i], tree), cfg,
                        {k: v[i] for k, v in batch.items()}, remat=remat,
                        chunk=chunk, moe_route=moe_route)[0]
                for i in range(leaves[0].shape[0])])
            grads = list(torch.autograd.grad(losses.sum(), leaves))
        for axis, idx in syncs.items():     # one all-reduce a dtype group
            if rows_whole:                  # each data rank's is whole
                axis = tuple(a for a in ((axis,) if isinstance(axis, str)
                                         else axis) if a != "data")
                if not axis:
                    continue
                axis = axis if len(axis) > 1 else axis[0]
            for group_ in dtype_groups([grads[i] for i in idx]).values():
                ids = [idx[k] for k in group_]
                flat = mesh.all_reduce(torch.cat(
                    [grads[i].reshape(-1) for i in ids]), axis)
                for i, f in zip(ids, flat.split(
                        [grads[i].numel() for i in ids])):
                    grads[i] = f.view(grads[i].shape)
        return losses.detach(), grads

    def local_sgd(params, grads, vel, lr_t):
        """Per-pod momentum step: (params, vel) as lists of leaves."""
        def upd(w, g, u):
            g32 = g.float()
            if weight_decay:
                g32 = g32 + weight_decay * w.float()
            return momentum * u - lr_t * g32
        vel = [upd(w, g, u) for w, g, u in zip(params, grads, vel)]
        return ([(w.float() + u).to(w.dtype) for w, u in zip(params, vel)],
                vel)

    def local_batch(batch, n_pods):
        """(The rank's rows of the global batch, by ``batch_shardings``;
        whether they are every sequence of the pod on every ``data`` rank:
        a count the ``data`` axis does not split, which the clamp keeps
        whole)."""
        got = {k: v.shape[0] for k, v in batch.items()}
        if set(got.values()) != {n_pods}:
            raise ValueError(f"batch leaves {got} must lead with the "
                             f"{n_pods} pods (the global batch)")
        if mesh is None:
            return batch, False
        D = mesh.size_of("data")
        b = {v.shape[1] for v in batch.values() if v.dim() > 1}
        if len(b) > 1:
            raise ValueError(f"batch leaves {got}: want one sequence count "
                             "a pod")
        whole = D > 1 and not all(sharding.splits(n, D) for n in b)
        specs_ = sharding.batch_shardings(batch, mesh, pod_stacked=True)
        return {k: sharding.local_block(v, specs_[k], mesh)
                for k, v in batch.items()}, whole

    def check_mix(mix, rows):
        if mix is None:
            raise ValueError(f"{comm.strategy} needs the round's "
                             "gossip_operands(...) as the mix argument")
        if (mix.mean_staleness is None) != (comm.strategy == "dpsgd"):
            raise ValueError(
                f"{comm.strategy} takes " + (
                    "gossip_operands(..., staleness=, max_staleness=), the "
                    "per-read staleness slots included"
                    if comm.strategy == "adpsgd" else
                    "gossip_operands(...) without staleness (dpsgd reads "
                    "are fresh)"))
        if mix.mix.idx.shape[0] != rows or (
                comm.strategy == "adpsgd" and (mix.route is None) != (
                    mesh is None)):
            raise ValueError(
                f"gossip operands are for {mix.mix.idx.shape[0]} pods "
                f"{'with' if mix.route is not None else 'without'} a route, "
                f"the state has {rows}: build them over the pod count, with "
                "the step's mesh")

    def train_step(state, batch, step_idx, mix=None, lr=None,
                   sparsity=None):
        lr_t = lr_static if lr is None else lr
        p0 = pytree.leaves(state["params"])
        rows = p0[0].shape[0]
        n_pods = rows * group
        batch, whole_rows = local_batch(batch, n_pods)
        if gossip:
            check_mix(mix, rows)
        vel0 = pytree.leaves(state["vel"])
        losses, grads = pod_grads(state["params"], batch, whole_rows)
        loss = losses.sum(0, keepdim=True)
        if group > 1:
            mesh.all_reduce(loss)
        metrics = {"loss": loss.reshape(()) / n_pods}
        out = lambda leaves: pytree.unflatten(state["params"], leaves)
        ex = train_step.exchange

        if comm.strategy == "bsp":
            g = ex({"grads": grads})["grads"]
            params, vel = local_sgd(p0, g, vel0, lr_t)
            return {"params": out(params), "vel": out(vel)}, metrics

        if comm.strategy == "fedavg":
            params, vel = local_sgd(p0, grads, vel0, lr_t)
            params = ex({"params": params}, step_idx=step_idx)["params"]
            return {"params": out(params), "vel": out(vel)}, metrics

        if comm.strategy == "gaia":
            params, vel = local_sgd(p0, grads, vel0, lr_t)
            acc = [a + u for a, u in zip(pytree.leaves(state["acc"]), vel)]
            new = ex({"params": params, "acc": acc}, lr=lr_t)
            return {"params": out(new["params"]), "vel": out(vel),
                    "acc": out(new["acc"])}, metrics

        if comm.strategy == "dgc":
            # per-pod global norm, leaves in order; a leaf split over ranks
            # summed over them, a whole (replicated) one counted once
            sq, parts_sq = 0, {}
            for x, ax in zip(grads, split or [None] * len(grads)):
                x2 = x.float().square().sum(dim=tuple(range(1, x.dim())))
                if ax is None:
                    sq = sq + x2
                else:
                    parts_sq[ax] = parts_sq.get(ax, 0) + x2
            for ax, x2 in parts_sq.items():
                sq = sq + mesh.all_reduce(x2, ax)
            scale = torch.clamp(comm.dgc_clip / torch.clamp(sq.sqrt(),
                                                            min=1e-12),
                                max=1.0)
            vel = []
            for x, w, u in zip(grads, p0, vel0):
                xc = x * scale.reshape((-1,) + (1,) * (x.dim() - 1)
                                       ).to(x.dtype)
                g = xc.float()
                if weight_decay:
                    g = g + weight_decay * w.float()
                vel.append(momentum * u + (-lr_t) * g)
            acc = [a + u for a, u in zip(pytree.leaves(state["acc"]), vel)]
            new = ex({"params": p0, "acc": acc, "vel": vel},
                     sparsity=sparsity)
            return {"params": out(new["params"]), "vel": out(new["vel"]),
                    "acc": out(new["acc"])}, metrics

        # gossip: the per-pod price is one model an active neighbour this
        # round (padding entries carry weight 0)
        params, vel = local_sgd(p0, grads, vel0, lr_t)
        metrics["mean_degree"] = mix.mean_degree
        metrics["comm_floats"] = mix.mean_degree * n_model
        if comm.strategy == "dpsgd":
            new = ex({"params": params}, mix=mix)
            return {"params": out(new["params"]), "vel": out(vel)}, metrics
        new = ex({"params": params, "snaps": state["snaps"]}, mix=mix)
        metrics["mean_staleness"] = mix.mean_staleness
        return {"params": out(new["params"]), "vel": out(vel),
                "snaps": new["snaps"]}, metrics

    train_step.exchange = exchange
    train_step.pod_grads = pod_grads
    return train_step


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

def _serve_layout(cfg: ModelConfig, mesh: Optional[Mesh],
                  moe_route: str) -> bool:
    """Whether the serve steps run inside a pod's ranks (an intra-pod
    ``mesh``); raises ``ValueError``, before any collective, for an
    unknown ``moe_route`` or a mesh of more than one pod (one site
    serves)."""
    if moe_route not in ROUTES:
        raise ValueError(f"moe_route {moe_route!r}; known: {ROUTES}")
    if mesh is None:
        return False
    if mesh_pods(mesh) > 1:
        raise ValueError(f"serving on a mesh of {mesh_pods(mesh)} pods: one "
                         "decentralized site serves (pod axis 1)")
    return sharding.intra_pod(mesh)


def _serve_rows(batch: Dict, mesh: Mesh) -> Tuple[Dict, int]:
    """(The rank's rows of a serve batch by ``batch_shardings``, the
    global request count B): B / D of them where the ``data`` axis splits
    B, all B on every rank where it does not (the reference's clamp: one
    ``long_500k`` request); raises ``ValueError`` where the leaves'
    request counts differ."""
    got = {k: v.shape[0] for k, v in batch.items()}
    if len(set(got.values())) != 1:
        raise ValueError(f"serve batch leaves {got}: want one request count")
    B = next(iter(got.values()))
    specs = sharding.batch_shardings(batch, mesh, pod_stacked=False)
    return {k: sharding.local_block(v, specs[k], mesh)
            for k, v in batch.items()}, B


def _rows_mesh(rows: Dict, B: int, mesh: Mesh) -> Mesh:
    """The mesh the serve step runs the model on: ``mesh``, or its
    ``with_rows_whole`` view where the step's ``rows`` (``_serve_rows``)
    are all ``B`` requests on every rank of a ``data`` axis above 1."""
    return mesh.with_rows_whole(mesh.size_of("data") > 1 and next(iter(
        rows.values())).shape[0] == B)


def _check_cache(cfg: ModelConfig, cache, mesh: Mesh, rows: int,
                 split: Optional[str], states: Dict[str, Tuple]) -> None:
    """Raises ``ValueError`` where a cache leaf's block is not the one
    ``init_cache(..., mesh=)`` makes for the step's placement: an
    attention cache's ``rows`` requests, its length split by ``split``
    (the whole ``pos`` beside a length split over ``model``, whole where
    the axis does not split it), GQA's KV heads over ``model`` unless the
    length is or the axis does not split them; an SSM or RG-LRU state's
    block of the shape ``states`` names by path (``_state_blocks``)."""
    leaves = dict(pytree.leaves_with_paths(cache))
    M = mesh.size_of("model")
    for path, want in states.items():
        got = leaves.get(path)
        got = None if got is None else tuple(got.shape)
        if got != want:
            raise ValueError(
                f"cache block {path}: {got}, not the placement's {want}; "
                "make the cache with init_cache(..., mesh=, batch_sharded=) "
                "as the serve step's")
    for path, pos in leaves.items():
        if not path.endswith("/pos"):
            continue
        off = 1 if path.startswith("body") else 0
        kv = leaves.get(path[:-3] + "k", leaves.get(path[:-3] + "ckv"))
        if kv is None:
            continue
        L = pos.shape[off + 1]
        want_len = L // M if split == "model" and sharding.splits(L, M) \
            else L
        heads = cfg.attention.n_kv_heads
        if split != "model" and sharding.splits(heads, M):
            heads //= M
        if (pos.shape[off] != rows or kv.shape[off] != rows
                or kv.shape[off + 1] != want_len
                or (kv.dim() - off == 4 and kv.shape[off + 2] != heads)):
            raise ValueError(
                f"cache block {path[:-4]}: pos {tuple(pos.shape)}, "
                f"{tuple(kv.shape)}, not the block of {rows} requests with "
                f"the length split over {split}; make the cache with "
                "init_cache(..., mesh=, batch_sharded=, baseline_decode=) "
                "as the serve step's")


def _state_blocks(cfg: ModelConfig, mesh: Mesh, B: int,
                  batch_sharded: bool) -> Dict[str, Tuple]:
    """The shape of the rank's block of each SSM and RG-LRU state leaf of
    a decode cache of ``B`` requests (``sharding.local_cache``), by
    path."""
    whole = {path: t for path, t in pytree.leaves_with_paths(
        cache_shape(cfg, B, 1)) if path.rsplit("/", 1)[-1] in
        ("ssd", "conv", "h")}
    return {path: tuple(t.shape) for path, t in sharding.local_cache(
        whole, mesh, batch_sharded=batch_sharded).items()}


def _vocab_argmax(logits: torch.Tensor, mesh: Mesh, whole: bool = False
                  ) -> torch.Tensor:
    """The greedy token of the rank's vocabulary columns ``logits`` (B, V /
    M): each rank's max and its first index, the max all-reduced (MAX)
    over ``model``, then the smallest global index among the ranks that
    hold it (MIN): ``torch.argmax`` of the whole row, ties included.
    ``whole``: the logits hold every column (``sharding.vocab_whole``),
    and their ``torch.argmax`` is the token."""
    if whole:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    n = logits.shape[-1]
    top, idx = logits.max(dim=-1)
    best = top.clone()
    mesh.all_reduce(best, "model", op=dist.ReduceOp.MAX)
    cand = torch.where(top == best, idx + mesh.coords["model"] * n,
                       torch.full_like(idx, n * mesh.size_of("model")))
    mesh.all_reduce(cand, "model", op=dist.ReduceOp.MIN)
    return cand.to(torch.int32)


def make_prefill_step(cfg: ModelConfig, *, mesh: Optional[Mesh] = None,
                      chunk: int = 512, moe_route: str = "dense"
                      ) -> Callable:
    """``prefill_step(params, batch)``: the next-token logits (B, V)
    float32 of a full-sequence forward of ``batch`` (its ``"tokens"``;
    for the VLM its ``"patches"``, which ``forward`` prepends; for the
    enc-dec its ``"frames"``, which the encoder reads).  ``moe_route``:
    the MoE layers' function (``moe.moe_apply``: ``"dense"``, the
    reference's default, or ``"ep"``, its ``REPRO_MOE_EP`` route).

    On a ``mesh`` (``launch.mesh.make_mesh``, pod axis 1) with a ``data``
    or ``model`` axis above 1, ``params`` are the rank's blocks
    (``sharding.local_params``), ``batch`` the global batch, of which the
    rank runs its rows (``batch_shardings``: over ``data``); it returns
    the rank's rows' (B / D, V) logits (all B where ``data`` does not
    divide them), whole: the rank's vocabulary columns gathered over
    ``model`` (where the axis splits the vocabulary).  Every width an
    axis does not divide is whole on every rank of it."""
    intra = _serve_layout(cfg, mesh, moe_route)

    def prefill_step(params, batch):
        if not intra:
            logits, _ = forward(params, cfg, batch, remat=False, chunk=chunk,
                                moe_route=moe_route)
            return logits[:, -1]
        rows, B = _serve_rows(batch, mesh)
        with activation_sharding(_rows_mesh(rows, B, mesh)):
            logits, _ = forward(params, cfg, rows, remat=False, chunk=chunk,
                                moe_route=moe_route)
        return _whole_vocab(cfg, mesh, logits[:, -1])
    return prefill_step


def _whole_vocab(cfg: ModelConfig, mesh: Mesh, logits: torch.Tensor
                 ) -> torch.Tensor:
    """The rows' logits over every column: the rank's vocabulary columns
    gathered over ``model``, or ``logits`` where they hold every column
    already (``sharding.vocab_whole``)."""
    if sharding.vocab_whole(cfg.vocab, mesh.size_of("model")):
        return logits
    return mesh.all_gather_dim(logits.contiguous(), 1, "model")


def make_encode_step(cfg: ModelConfig, *, mesh: Optional[Mesh] = None
                     ) -> Callable:
    """``encode_step(params, batch)``: the enc-dec encoder's output on
    ``batch["frames"]`` (B, S, feat_dim), the ``memory`` a serve loop
    computes once and hands ``make_serve_step``.  On a ``mesh`` as
    ``make_prefill_step``'s: ``params`` the rank's blocks, ``batch`` the
    global batch; it returns the memory of the rank's rows of the
    requests (B / D, S, encoder d_model), whole, what the rank's serve
    step reads."""
    if cfg.encoder is None:
        raise ValueError(f"{cfg.arch_id} has no encoder")
    intra = _serve_layout(cfg, mesh, "dense")

    def encode_step(params, batch):
        if not intra:
            return encoder_apply(params["encoder"], cfg, batch["frames"])
        rows, B = _serve_rows({"frames": batch["frames"]}, mesh)
        with activation_sharding(_rows_mesh(rows, B, mesh)):
            return encoder_apply(params["encoder"], cfg, rows["frames"])
    return encode_step


def make_serve_step(cfg: ModelConfig,
                    memory: Optional[torch.Tensor] = None, *,
                    mesh: Optional[Mesh] = None, moe_route: str = "dense",
                    batch_sharded: Optional[bool] = None,
                    baseline_decode: bool = False) -> Callable:
    """``serve_step(params, cache, batch)``: one decode step and its greedy
    next token, (int32 (B,), cache).  For an enc-dec arch, ``memory``
    (the encoder's output on the requests' frames, computed once:
    ``make_encode_step``; on a mesh the rank's rows of it) is read by
    every step through ``transformer.lm_decode``, where ``decode_step``
    would run the encoder on ``batch["frames"]`` each step.
    ``serve_step.logits(params, cache, batch)`` is the same step
    returning its float32 logits instead of the token.

    On a ``mesh`` as ``make_prefill_step``'s: ``params`` the rank's blocks,
    ``batch`` the global batch (the rank decodes its rows), ``cache`` the
    rank's block of the decode cache as ``sharding.cache_shardings``
    places it: ``model.init_cache(..., mesh=, batch_sharded=,
    baseline_decode=)`` with this step's flags.  ``batch_sharded``
    (default: the reference's B >= 8, and always for an SSM or RG-LRU
    model on a ``data`` axis above 1: ``sharding.default_batch_sharded``)
    puts the requests over ``data``, else every row's cache length;
    ``baseline_decode`` (the reference's ``REPRO_BASELINE_DECODE``
    placement) keeps the attention caches' KV heads over ``model``, else
    their length (flash-decode).  The function is the one-device step's
    either way.  Requests the ``data`` axis does not divide (one
    ``long_500k`` request) are held whole by every rank, under either
    placement (the clamp).  The
    token is the vocabulary-parallel argmax of the rank's rows (a plain
    argmax where the vocabulary is whole: ``sharding.vocab_whole``),
    gathered over ``data``: every rank returns the whole batch's (B,)
    tokens; ``.logits`` returns the rank's rows' (B / D, V), whole."""
    intra = _serve_layout(cfg, mesh, moe_route)
    states: Dict = {}                # (B, batch_sharded): _state_blocks

    def decode(params, cache, batch):
        if not intra:
            if memory is None:
                return decode_step(params, cfg, batch, cache,
                                   moe_route=moe_route)
            return lm_decode(params, cfg, batch["token"], cache, batch["t"],
                             memory=memory, moe_route=moe_route)
        rows, B = _serve_rows(batch, mesh)
        placed = (sharding.default_batch_sharded(cfg, B, mesh)
                  if batch_sharded is None else batch_sharded)
        sharding.check_cache_placement(cfg, mesh, placed, B)
        split = sharding.cache_split(mesh, batch_sharded=placed,
                                     baseline_decode=baseline_decode)
        if (B, placed) not in states:
            states[B, placed] = _state_blocks(cfg, mesh, B, placed)
        _check_cache(cfg, cache, mesh, next(iter(rows.values())).shape[0]
                     if placed else B, split, states[B, placed])
        with activation_sharding(_rows_mesh(rows, B, mesh)):
            if memory is None:
                return decode_step(params, cfg, rows, cache,
                                   moe_route=moe_route, split=split)
            return lm_decode(params, cfg, rows["token"], cache, rows["t"],
                             memory=memory, moe_route=moe_route, split=split)

    def serve_step(params, cache, batch):
        logits, new_cache = decode(params, cache, batch)
        if not intra:
            return torch.argmax(logits, dim=-1).to(torch.int32), new_cache
        toks = _vocab_argmax(logits, mesh, sharding.vocab_whole(
            cfg.vocab, mesh.size_of("model")))
        if toks.shape[0] != next(iter(batch.values())).shape[0]:
            toks = mesh.all_gather_dim(toks, 0, "data")   # the rank's rows
        return toks, new_cache

    def logits_of(params, cache, batch):
        logits, new_cache = decode(params, cache, batch)
        if intra:
            logits = _whole_vocab(cfg, mesh, logits)
        return logits, new_cache

    serve_step.logits = logits_of
    return serve_step
