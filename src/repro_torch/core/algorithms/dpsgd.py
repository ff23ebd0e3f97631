"""D-PSGD (Lian et al., NeurIPS 2017): decentralized parallel SGD.

Each node holds a model replica, takes a local momentum-SGD step, then
*gossip-averages* with its graph neighbors: ``x_k <- sum_j W[k,j] x_j``
restricted to the round's edges, with W the symmetric doubly-stochastic
mixing matrix.  On the complete graph (W = 1/K) this is exact averaging;
on sparse graphs (ring, torus, expander, D-Cliques) each step only moves
the model toward consensus at the rate of the spectral gap, trading
accuracy-under-skew for per-node bandwidth of ``degree * |model|``.

The fabric is a :class:`~repro_torch.topology.graphs.TopologySchedule`:
round ``t`` mixes with ``schedule.at(t)``'s neighbors.  Its padded
neighbor indices and weights are ``ops.MixOperands``, range-checked on
the host and uploaded once per distinct graph, padded to the
schedule-wide max degree (or to ``pad_degree``, the max over a SkewScout
topology ladder, so a rung switch through :meth:`DPSGD.set_schedule`
keeps the operand shape), so every round hands the mixing kernel
operands of one shape; a round that changes the graph changes only which
cached operands go in, never the kernel.

The mixing itself is one ``ops.neighbor_mix_many`` over the model's
leaves where they lie: on the card the hand-written kernel
``kernels/csrc/neighbor_mix.cu``, one launch a step that reads no device
value back.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.algorithms.base import (ModelFns, Tree, pernode_grads,
                                              tree_mean0, tree_size,
                                              tree_stack_n,
                                              tree_zeros_stacked)
from repro_torch.kernels import ops
from repro_torch.topology.graphs import Topology, TopologySchedule, as_schedule


class DPSGD:
    name = "dpsgd"

    def __init__(self, fns: ModelFns, n_nodes: int, *,
                 topology: Union[Topology, TopologySchedule],
                 momentum: float = 0.9, weight_decay: float = 0.0,
                 pad_degree: Optional[int] = None, participation=None):
        """``pad_degree`` widens the neighbor operand shape beyond this
        schedule's max degree: set it to the max over a SkewScout
        topology ladder so rung switches keep one operand shape.

        ``participation``: optional
        :class:`~repro_torch.topology.links.Participation` sampler.  Each
        round its seeded node mask zeroes the mixing weight of every
        edge with a sampled-out endpoint (slack returns to the self
        weight, so rows still sum to 1 and sampled-out nodes keep their
        own model)."""
        schedule = as_schedule(topology)
        if schedule.n_nodes != n_nodes:
            raise ValueError(f"schedule has {schedule.n_nodes} nodes, "
                             f"the run {n_nodes}")
        self.fns, self.K = fns, n_nodes
        self.m, self.wd = momentum, weight_decay
        self.participation = participation
        self._pad_degree = max(schedule.max_degree, 1, pad_degree or 0)
        self._stepped = False
        self._operand_cache: Dict[int, tuple] = {}
        self.set_schedule(schedule)

    def set_schedule(self, fabric: Union[Topology, TopologySchedule]
                     ) -> None:
        """Swap the fabric mid-run (SkewScout topology rung switch).
        The operand padding only grows, and refuses to grow once the
        first step has run, so the mixing operands keep one shape for
        the whole run."""
        schedule = as_schedule(fabric)
        if schedule.n_nodes != self.K:
            raise ValueError(f"schedule has {schedule.n_nodes} nodes, "
                             f"the run {self.K}")
        if schedule.max_degree > self._pad_degree and self._stepped:
            raise ValueError(
                f"schedule {schedule.name!r} needs degree "
                f"{schedule.max_degree} > pad {self._pad_degree}; construct "
                f"{type(self).__name__} with pad_degree=max over the ladder")
        self._pad_degree = max(self._pad_degree, schedule.max_degree)
        self.schedule = schedule
        self._operand_cache.clear()

    @property
    def topology(self) -> Topology:
        """Round-0 graph — the full graph for constant schedules."""
        return self.schedule.at(0)

    def mix_operands(self, t: int, device: torch.device
                     ) -> ops.MixOperands:
        """Round ``t``'s neighbor operands on ``device``, cached per
        unique graph of the period, all padded to one shape, the index
        range-checked once when the entry is built.  With a participation
        sampler, round ``t``'s node mask is applied to the cached host
        weights (same shapes, masked values), which replace the weights
        alone; a full-participation round returns the cached operands."""
        graph = self.schedule.at(t)
        ent = self._operand_cache.get(id(graph))
        if ent is None:
            idx, w, sw = self.schedule.neighbor_arrays(
                t, pad_degree=self._pad_degree)
            # the graph is kept in the entry so its id cannot be recycled
            ent = (graph, (idx, w), ops.mix_operands(idx, w, sw, self.K,
                                                     device))
            self._operand_cache[id(graph)] = ent
        _, (idx_np, w_np), mix = ent
        if self.participation is None:
            return mix
        m = self.participation.mask(int(t))
        if m.all():
            return mix
        # w'_ij = w_ij * m_i * m_j (symmetric), slack to the diagonal:
        # rows still sum to 1 and sampled-out nodes mix with nobody
        w2 = np.where(m[idx_np] & m[:, None], w_np, 0.0).astype(np.float32)
        sw2 = (1.0 - w2.sum(axis=1)).astype(np.float32)
        return mix.with_weights(torch.from_numpy(w2).to(device),
                                torch.from_numpy(sw2).to(device))

    def init(self, params: Tree, mstate: Tree) -> Dict[str, Tree]:
        return {"params": tree_stack_n(params, self.K),
                "mstate": tree_stack_n(mstate, self.K),
                "vel": tree_zeros_stacked(params, self.K)}

    def _flatten(self, stacked: Tree) -> torch.Tensor:
        """Per-node model stack -> one (K, N) float32 matrix, the leaves'
        per-node entries side by side in the tree's order (the layout of
        ADPSGD's snapshot buffer)."""
        return torch.cat([t.reshape(self.K, -1).float()
                          for t in stacked.values()], dim=1)

    def _unflatten(self, mixed: torch.Tensor, like: Tree) -> Tree:
        """Split a (K, N) matrix back into tensors shaped like ``like``."""
        sizes = [t[0].numel() for t in like.values()]
        return {n: part.reshape(t.shape).to(t.dtype)
                for (n, t), part in zip(like.items(),
                                        mixed.split(sizes, dim=1))}

    def _local_update(self, state, batch, lr):
        """Per-node momentum-SGD step (pre-gossip), shared with ADPSGD."""
        self._stepped = True
        w0 = state["params"]
        losses, grads, new_ms = pernode_grads(
            self.fns, w0, state["mstate"], batch, params_stacked=True)
        vel = {n: self.m * u - lr * (grads[n] + self.wd * w0[n])
               for n, u in state["vel"].items()}
        return losses, new_ms, vel, {n: w0[n] + vel[n] for n in w0}

    def step(self, state, batch, lr, step_idx) -> Tuple[Dict, Dict]:
        """One local step + gossip round.  ``step_idx`` selects the
        round's graph."""
        mix = self.mix_operands(
            int(step_idx), next(iter(state["params"].values())).device)
        losses, new_ms, vel, params = self._local_update(state, batch, lr)
        # gossip-average every leaf at once, each read where it lies
        params = dict(zip(params, ops.neighbor_mix_many(
            list(params.values()), mix)))
        return ({"params": params, "mstate": new_ms, "vel": vel},
                self._gossip_metrics(losses, params, mix.w))

    def _gossip_metrics(self, losses, params: Tree, nbr_w) -> Dict:
        # per-node price: ship the model once to each active neighbor
        # this round (padding entries carry weight 0, so counting
        # positive weights recovers the round graph's mean degree)
        model_floats = float(tree_size(params)) / self.K
        mean_degree = (nbr_w > 0).sum().float() / self.K
        # consensus distance: mean |w_k - w_avg| / |w_avg|
        avg = tree_mean0(params)
        num = sum((s - avg[n][None]).abs().sum() for n, s in params.items())
        den = sum(a.abs().sum() * self.K for a in avg.values())
        return {"loss": losses.mean(),
                "comm_floats": mean_degree * model_floats,
                "consensus_delta": num / den.clamp_min(1e-12)}

    def eval_params(self, state):
        return tree_mean0(state["params"]), tree_mean0(state["mstate"])

    def node_params(self, state, k: int):
        return ({n: t[k] for n, t in state["params"].items()},
                {n: t[k] for n, t in state["mstate"].items()})
