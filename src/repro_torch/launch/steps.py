"""Train and serve steps of the LM (``repro.launch.steps``), with the
paper's communication strategies as a stage of the train step.

On one card the decentralized sites ("pods") are the train state's
stacked leading axis, as the reference's state is pod-stacked: each pod
trains its own replica on its own batch, and the cross-pod exchange is a
reduction over axis 0, or a gossip kernel over its rows:

  bsp:    grads averaged across pods every step
  gaia:   |accumulated update| > T |weight| (``ops.gaia_select_many``),
          the selections summed across pods; T = t0 * lr / lr0 (lr0
          defaults to the construction-time lr)
  fedavg: params averaged across pods every ``iter_local`` steps
  dgc:    per-pod global-norm clip, momentum correction, then the
          256-bin histogram top-s% of each pod's accumulated update
          (``ops.dgc_sparsify``, one launch a (pod, leaf)), summed
          across pods
  dpsgd:  gossip over a ``TopologySchedule`` fabric
          (``ops.neighbor_mix_many``: self weight plus weighted
          neighbours, float32 accumulate, one cast)
  adpsgd: the same, each neighbour read from a bounded-staleness
          snapshot buffer that the same launch pushes
          (``ops.neighbor_mix_push_many``)

The step reads nothing back from the card: ``step_idx``, ``lr`` and
``sparsity`` are host numbers, the gossip operands are checked on the
host when ``gossip_operands`` builds them, and every metric is a tensor.
The reference's mesh (``pod`` axis, shard_map and ppermute ring) waits
for the port's distributed backend (ROADMAP A11).

The kernels take leaves of one dtype a launch, so a model whose leaves
mix dtypes (bf16 weights, float32 norms) gets one launch a dtype group:
Gaia's float32 accumulated update against bf16 weights is one instance
of ``csrc/gaia_select.cu``, against float32 weights the other.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.configs.base import CommConfig, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import dgc_topk, ops
from repro_torch.models.model import decode_step, forward, loss_fn
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


def make_train_state(params, comm: CommConfig, n_pods: int) -> Dict:
    """The pod-stacked train state of ``params`` (one replica's tree):
    ``"params"``, every leaf copied to (n_pods, ...); ``"vel"``, float32
    zeros of that shape; ``"acc"`` (gaia, dgc), the same; for adpsgd
    ``"snaps"``, the bounded-staleness snapshot buffer: for each dtype of
    the leaves (``"bfloat16"``, ``"float32"``) one (max_staleness + 1,
    n_pods, N) tensor of that dtype, the pod's leaves of the dtype
    flattened side by side in the reference's leaf order (N their sizes
    summed), every slot the stacked params.  The reference keeps one
    (max_staleness + 1, n_pods, ...) buffer a leaf; this is the layout
    ``ops.neighbor_mix_push_many`` pushes and gathers in one launch.  Slot
    0 holds the newest round."""
    stack = lambda t: t.unsqueeze(0).repeat((n_pods,) + (1,) * t.dim())
    zeros = lambda t: torch.zeros((n_pods,) + tuple(t.shape),
                                  dtype=torch.float32, device=t.device)
    state = {"params": pytree.tree_map(stack, params),
             "vel": pytree.tree_map(zeros, params)}
    if comm.strategy in ("gaia", "dgc"):
        state["acc"] = pytree.tree_map(zeros, params)
    if comm.strategy == "adpsgd":
        leaves = pytree.leaves(state["params"])
        state["snaps"] = {
            pytree.dtype_name(dt): torch.cat(
                [leaves[i].reshape(n_pods, -1) for i in idx], dim=1
            )[None].repeat(comm.max_staleness + 1, 1, 1)
            for dt, idx in dtype_groups(leaves).items()}
    return state


# ---------------------------------------------------------------------------
# Gossip fabric plumbing
# ---------------------------------------------------------------------------

class GossipOperands(NamedTuple):
    """A gossip round's operands on the device: ``mix``, what the gossip
    kernel reads, range-checked on the host: the reference's padded
    ``nbr_idx`` (dpsgd), or ``stale * K + nbr_idx`` into the ((S + 1) K)
    rows of the snapshot buffer (adpsgd), with its ``nbr_w`` and
    ``self_w``; and for adpsgd ``stale``, (K, D) int32, the staleness slot
    of each read (0 on padding)."""
    mix: ops.MixOperands
    stale: Optional[torch.Tensor] = None


def gossip_operands(fabric: Union[Topology, TopologySchedule], t: int, *,
                    pad_degree: Optional[int] = None,
                    staleness: Optional[int] = None,
                    max_staleness: Optional[int] = None,
                    device=None) -> GossipOperands:
    """Round ``t``'s mix operands for the gossip train step, on ``device``
    (CUDA by default), padded to the schedule-wide max degree (or
    ``pad_degree``), so every round of a rotating schedule has one shape.
    With ``staleness`` (adpsgd) the reads of slot ``staleness`` of a
    buffer of ``max_staleness + 1`` slots; a staleness outside [0,
    max_staleness], or none given with it, raises ``ValueError``, as a
    slot outside the buffer cannot be read.  Built and checked on the
    host, uploaded once: a step that takes them reads nothing back."""
    device = resolve_device(device)
    sched = as_schedule(fabric)
    idx, w, sw = sched.neighbor_arrays(int(t), pad_degree=pad_degree)
    K = idx.shape[0]
    if staleness is None:
        return GossipOperands(ops.mix_operands(idx, w, sw, K, device))
    if max_staleness is None:
        raise ValueError(
            "staleness needs max_staleness (= comm.max_staleness, the "
            "snapshot-buffer depth) so out-of-buffer slots are refused")
    if not 0 <= staleness <= max_staleness:
        raise ValueError(
            f"staleness {staleness} outside the snapshot buffer bound "
            f"[0, {max_staleness}] fixed at construction "
            "(comm.max_staleness)")
    stale = np.where(w > 0, int(staleness), 0).astype(np.int32)
    return GossipOperands(
        ops.mix_operands(stale * K + idx, w, sw, (max_staleness + 1) * K,
                         device), torch.from_numpy(stale).to(device))


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
# Train step
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, comm: CommConfig, *,
                    lr: float = 1e-3, lr0: Optional[float] = None,
                    momentum: float = 0.9, weight_decay: float = 0.0,
                    remat: bool = True, chunk: int = 512) -> Callable:
    """Returns ``train_step(state, batch, step_idx, mix=None, lr=None,
    sparsity=None) -> (state, metrics)``, a new state (the old one is not
    written).  ``batch`` leaves are (n_pods, b, ...) (``"tokens"``,
    ``"labels"``, and ``"patches"`` or ``"frames"`` where the arch reads
    them).

    The pods' forwards run in turn, each pod's ``loss_fn`` on its own
    views of the stacked leaves, and one ``torch.autograd.grad`` of the
    summed losses lands each pod's gradient in its own row.  Then a
    per-pod momentum step (float32 velocity) and the strategy's exchange
    (the module docstring).  ``metrics``: ``"loss"`` (the mean over
    pods), and for dpsgd and adpsgd ``"mean_degree"`` and
    ``"comm_floats"`` (per-pod floats sent: one model a neighbour), for
    adpsgd ``"mean_staleness"``; each a float32 0-d tensor.

    Runtime operands: ``step_idx`` an int (fedavg's sync step); ``mix``
    the round's ``gossip_operands`` (dpsgd, adpsgd: required); ``lr`` a
    host number overriding the static ``lr`` (it drives Gaia's threshold
    decay); ``sparsity`` a host number overriding ``comm.dgc_sparsity``.
    """
    if comm.strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {comm.strategy!r}; known: "
                         f"{STRATEGIES}")
    lr_static = lr
    gossip = comm.strategy in GOSSIP_STRATEGIES

    def pod_grads(state, batch):
        """(losses (n_pods,), grads): each leaf's gradient (n_pods, ...)
        in its dtype, in ``pytree.leaves``' order."""
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_()
                      for t in pytree.leaves(state["params"])]
            params = pytree.unflatten(state["params"], leaves)
            n_pods = leaves[0].shape[0]
            losses = torch.stack([
                loss_fn(pytree.tree_map(lambda t: t[i], params), cfg,
                        {k: v[i] for k, v in batch.items()}, remat=remat,
                        chunk=chunk)[0] for i in range(n_pods)])
            grads = torch.autograd.grad(losses.sum(), leaves)
        return losses.detach(), list(grads)

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

    def check_mix(mix, n_pods):
        if mix is None:
            raise ValueError(f"{comm.strategy} needs the round's "
                             "gossip_operands(...) as the mix argument")
        if (mix.stale is None) != (comm.strategy == "dpsgd"):
            raise ValueError(
                f"{comm.strategy} takes " + (
                    "gossip_operands(..., staleness=, max_staleness=), the "
                    "per-read staleness slots included"
                    if comm.strategy == "adpsgd" else
                    "gossip_operands(...) without staleness (dpsgd reads "
                    "are fresh)"))
        if mix.mix.idx.shape[0] != n_pods:
            raise ValueError(
                f"gossip operands are for {mix.mix.idx.shape[0]} nodes but "
                f"the state has {n_pods} pods: build the schedule over the "
                "pod count")

    def train_step(state, batch, step_idx, mix=None, lr=None,
                   sparsity=None):
        lr_t = lr_static if lr is None else lr
        p0 = pytree.leaves(state["params"])
        n_pods = p0[0].shape[0]
        if gossip:
            check_mix(mix, n_pods)
        vel0 = pytree.leaves(state["vel"])
        losses, grads = pod_grads(state, batch)
        metrics = {"loss": losses.mean()}
        out = lambda leaves: pytree.unflatten(state["params"], leaves)

        if comm.strategy == "bsp":
            g = [x.float().mean(0, keepdim=True).to(x.dtype).expand_as(x)
                 for x in grads]
            params, vel = local_sgd(p0, g, vel0, lr_t)
            return {"params": out(params), "vel": out(vel)}, metrics

        if comm.strategy == "fedavg":
            params, vel = local_sgd(p0, grads, vel0, lr_t)
            il = comm.iter_local
            if int(step_idx) % il == il - 1:
                params = [t.float().mean(0, keepdim=True).to(t.dtype)
                          .expand_as(t).contiguous() for t in params]
            return {"params": out(params), "vel": out(vel)}, metrics

        if comm.strategy == "gaia":
            params, vel = local_sgd(p0, grads, vel0, lr_t)
            acc = [a + u for a, u in zip(pytree.leaves(state["acc"]), vel)]
            # a fill on the device, not a copy from the host, which would
            # wait for the card
            thresh = torch.full((), comm.gaia_t0 * (
                lr_t / (lr_static if lr0 is None else lr0)),
                dtype=torch.float32, device=p0[0].device)
            sel = [None] * len(acc)
            for idx in dtype_groups(params).values():
                outs, _ = ops.gaia_select_many([acc[i] for i in idx],
                                               [params[i] for i in idx],
                                               thresh)
                for i, s_ in zip(idx, outs):
                    sel[i] = s_
            new_p = [(w.float() + (s_.sum(0, keepdim=True) - s_)
                      ).to(w.dtype) for w, s_ in zip(params, sel)]
            acc = [a * (s_ == 0) for a, s_ in zip(acc, sel)]
            return {"params": out(new_p), "vel": out(vel),
                    "acc": out(acc)}, metrics

        if comm.strategy == "dgc":
            sq = 0
            for x in grads:         # per-pod global norm, leaves in order
                sq = sq + x.float().square().sum(dim=tuple(range(1, x.dim())))
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
            s = comm.dgc_sparsity if sparsity is None else sparsity
            new_p, new_acc, new_vel = [], [], []
            for w, a, u in zip(p0, acc, vel):
                sel = torch.stack([ops.dgc_sparsify(a[i], s)[0]
                                   for i in range(n_pods)])
                keep = sel == 0
                new_p.append((w.float() + sel.sum(0, keepdim=True)
                              ).to(w.dtype))
                new_acc.append(a * keep)
                new_vel.append(u * keep)
            return {"params": out(new_p), "vel": out(new_vel),
                    "acc": out(new_acc)}, metrics

        # gossip: the per-pod price is one model an active neighbour this
        # round (padding entries carry weight 0)
        params, vel = local_sgd(p0, grads, vel0, lr_t)
        nbr_on = (mix.mix.w > 0).float()
        mean_degree = nbr_on.sum() / n_pods
        metrics["mean_degree"] = mean_degree
        metrics["comm_floats"] = mean_degree * (
            float(sum(t.numel() for t in p0)) / n_pods)
        groups = dtype_groups(params)
        mixed = [None] * len(params)
        if comm.strategy == "dpsgd":
            for idx in groups.values():
                for i, y in zip(idx, ops.neighbor_mix_many(
                        [params[i] for i in idx], mix.mix)):
                    mixed[i] = y
            return {"params": out(mixed), "vel": out(vel)}, metrics
        snaps = {}
        for dt, idx in groups.items():
            name = pytree.dtype_name(dt)
            ys, snaps[name] = ops.neighbor_mix_push_many(
                [params[i] for i in idx], state["snaps"][name], mix.mix)
            for i, y in zip(idx, ys):
                mixed[i] = y
        metrics["mean_staleness"] = (mix.stale * nbr_on).sum() / \
            nbr_on.sum().clamp_min(1.0)
        return {"params": out(mixed), "vel": out(vel), "snaps": snaps}, \
            metrics

    return train_step


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, *, chunk: int = 512) -> Callable:
    """``prefill_step(params, batch)``: the next-token logits (B, V)
    float32 of a full-sequence forward of ``batch`` (its ``"tokens"``;
    for the VLM its ``"patches"``, which ``forward`` prepends; for the
    enc-dec its ``"frames"``, which the encoder reads)."""
    def prefill_step(params, batch):
        logits, _ = forward(params, cfg, batch, remat=False, chunk=chunk)
        return logits[:, -1]
    return prefill_step


def make_serve_step(cfg: ModelConfig,
                    memory: Optional[torch.Tensor] = None) -> Callable:
    """``serve_step(params, cache, batch)``: one decode step and its greedy
    next token, (int32 (B,), cache).  For an enc-dec arch, ``memory``
    (the encoder's output on the requests' frames, computed once) is
    read by every step through ``transformer.lm_decode``, where
    ``decode_step`` would run the encoder on ``batch["frames"]`` each
    step."""
    def serve_step(params, cache, batch):
        if memory is None:
            logits, new_cache = decode_step(params, cfg, batch, cache)
        else:
            logits, new_cache = lm_decode(params, cfg, batch["token"], cache,
                                          batch["t"], memory=memory)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, new_cache
    return serve_step
