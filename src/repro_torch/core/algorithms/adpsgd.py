"""AD-PSGD (Lian et al., NeurIPS 2018): asynchronous decentralized SGD.

Same local momentum-SGD + gossip-averaging loop as :class:`DPSGD`, but
nodes do not wait for each round's slowest link: each node mixes with
the *last delivered* version of its neighbors' parameters, which may be
up to ``max_staleness`` rounds old.  The simulation models this with a
**bounded-staleness snapshot buffer**: ``state["snaps"]`` holds the
flattened per-node parameter stack of the last ``max_staleness + 1``
rounds (slot 0 = this round's post-gradient params, slot ``s`` = the
stack from ``s`` rounds ago), a materialised (S + 1, K, N) float32
tensor, and every neighbor read gathers from slot ``staleness`` instead
of slot 0.  ``staleness = 0`` is bit-identical to D-PSGD; the *bound* is
structural: a read deeper than the buffer cannot be expressed.

The mixing is one ``ops.neighbor_mix(..., src=)`` a step: on the card the
src-gather entry of ``kernels/csrc/neighbor_mix.cu``.  The buffer is
viewed as one ((S + 1) * K, N) source matrix and the round's padded
neighbor indices are offset by ``staleness * K``, so the staleness
values ride inside the same index operand as the schedule's neighbor
sets: rotating schedules, SkewScout rung switches and staleness changes
(``set_staleness``) all change operand values only.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.algorithms.base import ModelFns
from repro_torch.core.algorithms.dpsgd import DPSGD
from repro_torch.kernels import ops
from repro_torch.topology.graphs import Topology, TopologySchedule


class ADPSGD(DPSGD):
    name = "adpsgd"

    def __init__(self, fns: ModelFns, n_nodes: int, *,
                 topology: Union[Topology, TopologySchedule],
                 momentum: float = 0.9, weight_decay: float = 0.0,
                 pad_degree: Optional[int] = None,
                 max_staleness: int = 2,
                 staleness: Optional[int] = None,
                 participation=None):
        """``max_staleness`` sizes the snapshot buffer (the hard bound a
        controller may move within); ``staleness`` is the current rung,
        defaulting to the bound (fully asynchronous)."""
        if max_staleness < 0:
            raise ValueError(f"max_staleness must be >= 0, got "
                             f"{max_staleness}")
        self.max_staleness = int(max_staleness)
        self.staleness = self.max_staleness
        self._stale_cache: Dict = {}
        super().__init__(fns, n_nodes, topology=topology,
                         momentum=momentum, weight_decay=weight_decay,
                         pad_degree=pad_degree, participation=participation)
        if staleness is not None:
            self.set_staleness(staleness)

    # ---- staleness plumbing ----
    def set_schedule(self, fabric) -> None:
        super().set_schedule(fabric)
        self._stale_cache = {}

    def set_staleness(self, staleness: int) -> None:
        """Move the staleness rung (SkewScout).  The buffer depth is
        fixed at ``max_staleness + 1``, so a rung outside [0,
        max_staleness] raises; any rung within it changes only the values
        of the index operand."""
        s = int(staleness)
        if not 0 <= s <= self.max_staleness:
            raise ValueError(
                f"staleness {s} outside the bound [0, {self.max_staleness}] "
                "fixed by the snapshot buffer at construction")
        if s != self.staleness:
            self.staleness = s
            self._stale_cache = {}

    def _stale_operands(self, t: int, device: torch.device
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Round ``t``'s (K, D) int32 staleness slots (the current rung on
        real neighbor slots, 0 on padding: padding weights are 0, so the
        slot only has to keep the gather index in range) and the gather
        index ``stale * K + nbr_idx`` into the flattened buffer, cached
        per (graph, rung) on ``device``."""
        key = (id(self.schedule.at(t)), self.staleness)
        ent = self._stale_cache.get(key)
        if ent is None:
            idx, w, _ = self.schedule.neighbor_arrays(
                t, pad_degree=self._pad_degree)
            stale = np.where(w > 0, self.staleness, 0).astype(np.int32)
            gidx = (stale * self.K + idx).astype(np.int32)
            ent = (self.schedule.at(t),
                   torch.from_numpy(stale).to(device),
                   torch.from_numpy(gidx).to(device))
            self._stale_cache[key] = ent
        return ent[1], ent[2]

    def edge_staleness(self, t: int) -> np.ndarray:
        """Per-edge staleness bound for round ``t``'s active edges,
        aligned with ``schedule.at(t).edges``: what the async ledger uses
        to amortize each link's latency."""
        return np.full(len(self.schedule.at(int(t)).edges),
                       self.staleness, np.int64)

    # ---- state ----
    def init(self, params, mstate) -> Dict:
        state = super().init(params, mstate)
        flat = self._flatten(state["params"])
        state["snaps"] = flat.unsqueeze(0).repeat(self.max_staleness + 1,
                                                  1, 1)
        return state

    def step(self, state, batch, lr, step_idx) -> Tuple[Dict, Dict]:
        """One local step + stale gossip round."""
        t = int(step_idx)
        device = state["snaps"].device
        nbr_idx, nbr_w, self_w = self.mix_operands(t, device)
        stale, gidx = self._stale_operands(t, device)
        losses, new_ms, vel, params = self._local_update(state, batch, lr)
        flat = self._flatten(params)
        # push this round's post-gradient stack into slot 0; slot s now
        # holds the stack from s rounds ago (pre-mix, like slot 0)
        snaps = torch.cat([flat[None], state["snaps"][:-1]], dim=0)
        mixed = ops.neighbor_mix(flat, gidx, nbr_w, self_w,
                                 src=snaps.reshape(-1, flat.shape[1]))
        params = self._unflatten(mixed, params)

        metrics = self._gossip_metrics(losses, params, nbr_w)
        nbr_mask = nbr_w > 0
        reads = nbr_mask.sum().float().clamp_min(1.0)
        metrics["mean_staleness"] = (stale * nbr_mask).sum().float() / reads
        metrics["max_staleness_used"] = (stale * nbr_mask).max()
        return ({"params": params, "mstate": new_ms, "vel": vel,
                 "snaps": snaps}, metrics)
