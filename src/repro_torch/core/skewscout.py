"""SkewScout (paper §7): communication-adaptive decentralized learning.

Periodically (every ``travel_every`` minibatches):
 1. *Model traveling*: node k's current model is evaluated on a subset of
    node j's training data (and vice versa).  Since node k's training
    accuracy on its own partition is known, the drop is the measured
    **accuracy loss** AL(θ) — a proxy for model divergence.
 2. *Communication control*: minimize Eq. 1,
        J(θ) = λ_AL · max(0, AL(θ) − σ_AL) + λ_C · C(θ)/CM,
    over the algorithm's θ ladder with a pluggable tuner (hill climbing by
    default), where C(θ) is the measured per-step communication since the
    last travel and CM is the full-model cost (BSP's per-step price).

Probes ride the fabric: each node's model travels along one of the
round's *active* edges (falling back to the union graph's neighbors when
a sparse round leaves the node isolated, and to the legacy ring only
when there is no fabric at all), so probes measure peers the node can
actually reach.  When a :class:`~repro_torch.topology.CommLedger` is
attached, every probe's model shipment is **booked on the edge it
traverses** —
probe traffic is priced into C(θ) like any other traffic, instead of
being tallied off-ledger.

C(θ)/CM pricing: with a synchronous ledger, floats are weighted by the
inverse bandwidth of the links they crossed, so under the geo-wan
profile scarce WAN bytes dominate the objective — the paper's Gaia
setting.  With an **async** ledger (AD-PSGD), C(θ) is the simulated
wall-clock the window actually cost (per-edge clocks, latency amortized
by staleness) over the wall-clock of one full-model exchange — so θ
rungs that change *when* links block (staleness) are priced, not just
rungs that change how many floats move.  With the uniform profile the
sync path reduces exactly to the flat float ratio.  Under a stochastic
link model (``CommLedger(link_model=...)``) the CM denominator comes
from the ledger's per-edge EWMA *measured* costs instead of profile
constants, re-priced at every probe on a pinned fabric (``cm_fabric``).

SkewScout is algorithm-agnostic: anything exposing a dynamic θ knob
(Gaia t0, FedAvg iter_local, DGC sparsity) plugs in via ``theta_ladder``.

Topology as a rung: for gossip (D-PSGD) the θ ladder is a list of
:class:`~repro_torch.topology.graphs.TopologySchedule` rungs (densest
first — see ``topology_ladder``), so the controller trades *edges*, not just
floats, against accuracy loss.  Switching rungs re-wires links, and the
ledger books that re-wiring traffic into ``priced_cost`` — so C(θ)
charges a rung-flapping controller for link churn, and CM is pinned at
construction (one full-model exchange on the densest fabric) so the
ratio stays comparable across rungs.

Staleness as a rung: for asynchronous gossip (AD-PSGD) the θ ladder is
``[0, 1, ..., max_staleness]`` (most synchronous = most expensive
first), priced by the async ledger's wall-clock — the controller trades
*freshness* against accuracy loss on a fixed fabric.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import CommConfig
from repro_torch.core.tuners import make_tuner
from repro_torch.topology.graphs import as_schedule

# θ ladders, ordered most-communication-heavy -> most-relaxed (paper §4.4)
THETA_LADDERS = {
    "gaia": [0.01, 0.02, 0.05, 0.10, 0.20, 0.30, 0.40, 0.50],
    "fedavg": [1, 2, 5, 10, 20, 50, 100, 200],
    "dgc": [0.75, 0.9375, 0.984375, 0.996, 0.999],
}


@dataclass
class TravelReport:
    step: int
    theta: Any
    accuracy_loss: float
    comm_ratio: float          # C(θ)/CM since last travel (per step)
    objective: float
    new_theta: Any
    # model-traveling traffic this probe event shipped (K models, one
    # per node) and the union-fabric edges it crossed
    probe_floats: float = 0.0
    probe_edges: Tuple = ()


class SkewScout:
    def __init__(self, comm: CommConfig, algo_name: str, model_floats: int,
                 eval_acc_fn: Callable, *, start_index: Optional[int] = None,
                 seed: int = 0, ledger=None, warmup_travels: int = 1,
                 ladder: Optional[List] = None,
                 cm_ref: Optional[float] = None, cm_fabric=None,
                 participation=None):
        """eval_acc_fn(params, mstate, x, y) -> accuracy in [0,1].
        ``ledger``: optional CommLedger; when given, C(θ)/CM is computed
        from bandwidth-priced link traffic (sync) or simulated
        wall-clock (async), and probe shipments are booked on the edges
        they traverse.
        ``warmup_travels``: initial probes that measure but do not move θ —
        the first window's communication reflects the init transient
        (updates are large at t=0 whatever θ is), so attributing it to the
        current rung sends the hill climber the wrong way.
        ``ladder``: override THETA_LADDERS — for topology mode, a list of
        TopologySchedule rungs ordered densest first; for staleness mode,
        ints ordered most-synchronous first.
        ``cm_ref``: pin the CM denominator (seconds for one full-model
        exchange) instead of re-deriving it from the ledger's current
        fabric each probe — required when rung switches change the fabric
        mid-run, or C(θ)/CM would be renormalized under the controller.
        ``cm_fabric``: like ``cm_ref`` but for a ledger with a stochastic
        link model, where profile constants are a fiction: the *fabric*
        is pinned and CM is re-priced at every probe from the ledger's
        per-edge EWMA measured costs
        (``measured_full_exchange_time/cost``), so the denominator
        tracks what the links actually cost while staying comparable
        across rung switches.  Amortized handshake installments land in
        whichever C(θ) window reuses the links, so a rung switch that
        persists sees its setup cost decay across windows while
        thrashing keeps re-paying it.
        ``participation``: optional
        :class:`~repro_torch.topology.links.Participation` sampler —
        probes
        only travel between nodes participating in the probe round
        (sampled-out nodes neither ship their model nor host a
        probe), mirroring how the ledger and gossip mask traffic."""
        if ladder is None:
            ladder = THETA_LADDERS[algo_name]
        kw = {} if comm.tuner == "hill" else {"seed": seed}
        self.tuner = make_tuner(comm.tuner, ladder, start_index=start_index,
                                **kw)
        self.comm = comm
        self.model_floats = float(model_floats)
        self.eval_acc = eval_acc_fn
        self.ledger = ledger
        self.warmup_travels = warmup_travels
        self.participation = participation
        self._cm_ref = cm_ref
        # normalize to a schedule once: union() is cached per schedule
        # instance, so per-probe CM re-pricing reuses one union graph
        self._cm_fabric = None if cm_fabric is None \
            else as_schedule(cm_fabric)
        self._cost_mark = self._ledger_cost()
        self._comm_since = 0.0
        self._steps_since = 0
        self.history: List[TravelReport] = []

    @property
    def theta(self):
        return self.tuner.theta

    def _ledger_cost(self) -> float:
        """The running cost counter C(θ) windows are cut from — the
        currency (wall-clock / sampled / constant bandwidth-seconds) is
        the *ledger's* policy (``LedgerView.window_cost``), so the
        numerator always matches the CM denominator's units."""
        return self.ledger.view().window_cost \
            if self.ledger is not None else 0.0

    def _cm(self) -> float:
        # an explicit pinned constant always wins — cm_ref exists to
        # keep C(θ)/CM comparable across rung switches, and a caller
        # that passed one must not have it silently overridden; the
        # pricing policy (measured vs constant, time vs cost) otherwise
        # lives on the ledger, with cm_fabric pinning the exchange graph
        if self._cm_ref is not None:
            return self._cm_ref
        return self.ledger.view().cm_denominator(self.model_floats,
                                                 fabric=self._cm_fabric)

    def record_step(self, comm_floats: float) -> None:
        self._comm_since += float(comm_floats)
        self._steps_since += 1

    def _probe_route(self, algo, step: int) -> List[Tuple[int, int]]:
        """One probe target per node, along the round's active edges.
        Isolated nodes (sparse rounds) fall back to the union graph;
        algorithms with no fabric at all (Gaia/FedAvg/DGC without a
        ledger) keep the legacy ring.  Successive travels rotate through
        each node's neighbor list so repeated probes cover the fabric.
        With a participation sampler, sampled-out nodes neither probe
        nor host, and participating nodes only target participating
        neighbors (a node with none sits the probe round out)."""
        K = algo.K
        sched = getattr(algo, "schedule", None)
        graph = union = None
        if sched is not None:
            sched = as_schedule(sched)
            graph, union = sched.at(step), sched.union()
        elif self.ledger is not None:
            union = self.ledger.topology      # route on the priced fabric
        m = None if self.participation is None \
            else self.participation.mask(step)
        route = []
        for k in range(K):
            if m is not None and not m[k]:
                continue
            nbrs = graph.neighbors(k) if graph is not None else []
            if m is not None:
                nbrs = [j for j in nbrs if m[j]]
            if not nbrs and union is not None:
                nbrs = union.neighbors(k)
                if m is not None:
                    nbrs = [j for j in nbrs if m[j]]
            if nbrs:
                j = nbrs[len(self.history) % len(nbrs)]
            elif m is None:
                j = (k + 1) % K
            else:
                continue        # no participating peer this round
            route.append((k, j))
        return route

    def maybe_travel(self, step: int, algo, state,
                     sample_subset: Callable) -> Optional[TravelReport]:
        """sample_subset(node) -> (x, y) training subset of that node."""
        if self._steps_since < self.comm.travel_every:
            return None
        route = self._probe_route(algo, step)
        # model traveling: each node's model scored at home vs. away
        losses = []
        for k, j in route:
            pk, sk = algo.node_params(state, k)
            x_home, y_home = sample_subset(k)
            acc_home = float(self.eval_acc(pk, sk, x_home, y_home))
            x_away, y_away = sample_subset(j)
            acc_away = float(self.eval_acc(pk, sk, x_away, y_away))
            losses.append(max(0.0, acc_home - acc_away))
        al = float(np.mean(losses)) if losses else 0.0
        probe_edges = tuple((min(k, j), max(k, j)) for k, j in route
                            if k != j)
        probe_floats = self.model_floats * len(probe_edges)
        if self.ledger is not None:
            # book the probes' model shipments on the links they crossed
            # *before* closing the window: each window's C(θ) includes
            # the probe cost the controller itself incurred under that θ
            self.ledger.record_probe(probe_edges, self.model_floats)
            window = self._ledger_cost() - self._cost_mark
            c_ratio = (window / max(self._steps_since, 1)) / self._cm()
        else:
            c_ratio = (self._comm_since / max(self._steps_since, 1)
                       ) / self.model_floats
        obj = (self.comm.lambda_al * max(0.0, al - self.comm.sigma_al)
               + self.comm.lambda_c * c_ratio)
        old = self.tuner.theta
        if len(self.history) < self.warmup_travels:
            new = old                     # measure-only warm-up probe
        else:
            new = self.tuner.step(obj)
        rep = TravelReport(step, old, al, c_ratio, obj, new,
                           probe_floats=probe_floats,
                           probe_edges=probe_edges)
        self.history.append(rep)
        self._comm_since = 0.0
        self._steps_since = 0
        self._cost_mark = self._ledger_cost()
        return rep

    def travel_overhead_floats(self) -> float:
        """Model-traveling floats counted against the savings: probe
        shipments of every travel *after* the measure-only warm-ups
        (warm-up probes calibrate the controller; their traffic is still
        booked on the ledger, but is not overhead attributed to θ)."""
        return float(sum(rep.probe_floats
                         for rep in self.history[self.warmup_travels:]))
