"""Link-level communication cost accounting (array-native).

Replaces the flat ``comm_floats`` scalar with per-link traffic: every
exchange is attributed to the edges of the run's fabric, split into LAN
vs WAN totals, and priced into a simulated wall-clock step time.

The fabric is a :class:`~repro_torch.topology.graphs.TopologySchedule` (a bare
:class:`Topology` is wrapped into its constant schedule): gossip rounds
are priced against the *active edge set of that round's graph*, not one
frozen graph.  When the active edge set changes — a time-varying
schedule rotating its matchings, or SkewScout switching topology rungs
mid-run — each newly-activated link is charged an explicit online
re-wiring cost: ``rewire_floats`` control-plane floats plus a per-class
handshake latency (WAN setup is far slower than LAN), both added to the
simulated step time.  Re-wiring traffic is booked on the links it
crosses, so the LAN/WAN split still covers every priced float and
SkewScout's C(θ)/CM objective sees schedule switches as real cost.

Two timing models share the float accounting:

*Synchronous* (default, D-PSGD stop-and-wait): every round ends when its
slowest activated link finishes, so ``sim_time_s`` grows by the max of
``latency + transfer`` over the round's active edges — one geo-WAN
straggler gates every node.

*Asynchronous* (``async_mode=True``, AD-PSGD): every link carries a
**virtual clock** that advances only by that link's own cost, and a
round's wall-clock is the max of the *activated* edges' clocks — links
never wait for each other, so the global clock is a max of per-edge
sums instead of a sum of per-round maxes (always <=, and strictly <
once different links bottleneck different rounds or latency is
amortized).  Bounded staleness is what licenses the overlap: a link
whose payloads may arrive up to ``s`` rounds stale keeps ``s + 1``
deliveries in flight, so its propagation latency is re-paid once per
``s + 1`` activations (``s = 0`` degrades to stop-and-wait per edge).
Per-node busy time (max cost over the node's own activated links each
round) and the resulting idle time / clock skew expose who was gated.

Stochastic links (``link_model=``): a
:class:`~repro_torch.topology.links.LinkModel` replaces the class-constant
pricing with seeded per-edge sampling — persistent per-edge base draws,
lognormal per-activation jitter, and a Markov transient-slowdown state
for bursty stragglers.  Both timing models price the *sampled* per-edge
times, so the async max-of-per-edge-sums diverges from the sync
sum-of-per-round-maxes under transient stragglers, not only persistent
WAN gaps.  Every observation also feeds per-edge EWMA **measured**
costs that SkewScout's C(θ)/CM pricing consumes in place of profile
constants.

Amortized re-wiring (``amortize_window=W``): a newly-activated link's
handshake is paid in ``handshake / W`` installments over its first ``W``
activations instead of up front — a rung switch that persists gets
cheaper per round.  A link dropped before its window completes forfeits
the unamortized balance immediately (the setup work was really done;
tearing down just stops deferring the booking), so thrashing between
schedules stays exactly as expensive as un-amortized switching.  A run
that ends mid-window leaves the remainder in
``view().pending_handshake_s`` (reported in ``summary()``):
``rewire_time_s + pending_handshake_s`` is the horizon-independent
handshake total to compare across windows.

Array layout (the 10k-node redesign): every canonical edge the ledger
ever prices gets a stable integer **edge id** (eid) the first time a
graph containing it is registered; all bookkeeping — virtual clocks,
booked traffic, EWMA measured costs, handshake installment balances —
lives in flat float64 arrays indexed by eid.  A gossip round is a
handful of vectorized array ops over the round graph's edge list
(gathered through the per-graph ``eids`` index), so pricing scales with
the active edge count, not with ``K * degree`` Python-dict updates.
The array core reproduces the retired dict-backed ledger bit-for-bit
(``tests/test_fabric_scale.py`` holds them equal on every invariant
scenario): sequential accumulations that are order-sensitive in IEEE
float (installment payments, forfeit charges, the non-worst full
exchange sum) keep their original fold order, everything order-invariant
(maxes, elementwise folds, independent per-edge adds) is vectorized.

Partial participation (``participation=``): a seeded
:class:`~repro_torch.topology.links.Participation` mask decides which nodes
show up for each gossip round; an edge is active iff *both* endpoints
participate.  Non-participating edges book no floats, pay no
installments, and do not advance their link-model draw counters — but
the round's re-wiring tracking still follows the schedule's full active
set (sampling out of a round does not tear the link down).  With
``participation=None`` (or fraction 1.0) every round prices exactly as
before, bit-for-bit.

Read API: :meth:`CommLedger.view` returns a frozen :class:`LedgerView`
snapshot — scalars plus eid-aligned arrays — rebuilt only when the
ledger has mutated since the last call.  It is the only read API: the
reference's deprecated accessor shims are not carried over.

Units: traffic in *floats* (the repo's communication currency, 4 bytes
each); bandwidth in floats/second; latency in seconds.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs.base import FabricConfig
from repro_torch.topology.graphs import (Edge, Topology, TopologySchedule,
                                   as_schedule)


@dataclass(frozen=True)
class LinkProfile:
    """Per-class bandwidth/latency.  ``uniform`` removes the LAN/WAN
    distinction (every link is LAN-priced) — the seed repo's behaviour.
    ``*_handshake`` is the connection-setup latency a newly-activated
    link pays once (re-wiring); it defaults to 3x the link's propagation
    latency (SYN / SYN-ACK / ACK) when not given."""
    name: str
    lan_bandwidth: float        # floats / second
    wan_bandwidth: float
    lan_latency: float = 0.0    # seconds
    wan_latency: float = 0.0
    lan_handshake: Optional[float] = None   # seconds; None -> 3x latency
    wan_handshake: Optional[float] = None

    def bandwidth(self, cls: str) -> float:
        return self.wan_bandwidth if cls == "wan" else self.lan_bandwidth

    def latency(self, cls: str) -> float:
        return self.wan_latency if cls == "wan" else self.lan_latency

    def handshake(self, cls: str) -> float:
        h = self.wan_handshake if cls == "wan" else self.lan_handshake
        return 3.0 * self.latency(cls) if h is None else h

    def price_per_float(self, cls: str) -> float:
        """Seconds per float — the scarcity weight used by SkewScout."""
        return 1.0 / self.bandwidth(cls)


# 4-byte floats: 10 Gb/s LAN ~ 312.5e6 floats/s; 100 Mb/s WAN ~ 3.125e6
LINK_PROFILES: Dict[str, LinkProfile] = {
    "uniform": LinkProfile("uniform", 312.5e6, 312.5e6, 0.0, 0.0),
    "datacenter": LinkProfile("datacenter", 312.5e6, 312.5e6,
                              1e-4, 1e-4),
    "geo-wan": LinkProfile("geo-wan", 312.5e6, 3.125e6, 1e-4, 5e-2),
}


def _seqsum(v: np.ndarray) -> float:
    """Sequential left-fold sum — bit-equal to a Python accumulation
    loop (``np.cumsum`` accumulates in order; ``np.sum`` is pairwise)."""
    return float(np.cumsum(v)[-1]) if len(v) else 0.0


def _wan_mask(graph: Topology) -> np.ndarray:
    return np.asarray(graph.edge_class) == "wan" if graph.edge_class \
        else np.zeros(0, bool)


class _GraphPricing:
    """Cached per-edge pricing arrays for one graph of the schedule:
    class constants gathered once, endpoint index arrays for per-node
    routing, the graph's global eid index, and a per-graph traffic
    accumulator (flushed into the ledger's eid-indexed traffic array on
    cold reads / schedule switches, preserving the dict-era fold
    grouping)."""

    def __init__(self, graph: Topology, profile: LinkProfile,
                 eids: np.ndarray):
        self.graph = graph
        self.deg = graph.degrees().astype(np.float64)
        self.is_wan = _wan_mask(graph)
        self.bw = np.where(self.is_wan, profile.wan_bandwidth,
                           profile.lan_bandwidth)
        self.lat = np.where(self.is_wan, profile.wan_latency,
                            profile.lan_latency)
        self.hs = np.where(self.is_wan, profile.handshake("wan"),
                           profile.handshake("lan"))
        self.active = frozenset(graph.edges)
        self.eids = eids
        # eid -> position in this graph's edge list (installment loop)
        self.pos_of: Dict[int, int] = {
            int(g): n for n, g in enumerate(eids)}
        self.edge_index = {e: n for n, e in enumerate(graph.edges)}
        # edge endpoint arrays for vectorized per-node routing
        self.ei = np.asarray([i for i, _ in graph.edges], np.int64)
        self.ej = np.asarray([j for _, j in graph.edges], np.int64)
        self.traffic = np.zeros(len(graph.edges))

    def flush_into(self, traffic: np.ndarray) -> None:
        if len(self.eids):
            traffic[self.eids] = traffic[self.eids] + self.traffic
        self.traffic[:] = 0.0


@dataclass(frozen=True, eq=False)
class LedgerView:
    """Frozen snapshot of a :class:`CommLedger` — the read API.

    Scalars are plain floats/ints; per-edge arrays are **eid-aligned**
    (``edges[k]`` is the canonical edge with eid ``k``, stable across
    schedule switches) and are copies (a view survives later ledger
    mutation).  ``union_eids`` selects the current union fabric's edges
    out of the eid space (``edge_traffic[union_eids]`` is the old
    ``edge_traffic`` property).  The ``full_exchange_*`` /
    ``measured_*`` / ``cm_denominator`` pricing helpers evaluate against
    the *live* ledger (EWMA state moves with new observations).

    ``view()`` is version-cached: repeated calls between ledger
    mutations return the same object with zero rebuild cost — the fix
    for the old per-call dict rebuilds in SkewScout's probe loop."""
    n_nodes: int
    async_mode: bool
    rounds: int
    amortize_window: int
    sim_time_s: float
    lan_floats: float
    wan_floats: float
    total_floats: float
    priced_cost: float
    sampled_priced_cost: float
    window_cost: float
    rewire_lan_floats: float
    rewire_wan_floats: float
    rewire_floats: float
    rewiring_cost: float
    rewire_events: int
    rewire_time_s: float
    pending_handshake_s: float
    clock_skew_s: float
    edges: Tuple[Edge, ...]
    edge_clock: np.ndarray = dataclasses.field(repr=False)
    edge_seen: np.ndarray = dataclasses.field(repr=False)
    edge_traffic: np.ndarray = dataclasses.field(repr=False)
    union_eids: np.ndarray = dataclasses.field(repr=False)
    ewma_latency_s: np.ndarray = dataclasses.field(repr=False)
    ewma_price_s: np.ndarray = dataclasses.field(repr=False)
    ewma_seen: np.ndarray = dataclasses.field(repr=False)
    node_clock: np.ndarray = dataclasses.field(repr=False)
    node_busy_s: np.ndarray = dataclasses.field(repr=False)
    node_idle_s: np.ndarray = dataclasses.field(repr=False)
    _ledger: "CommLedger" = dataclasses.field(repr=False, compare=False)

    # ---- pricing helpers (delegate to the live ledger) ----
    def full_exchange_cost(self, model_floats: float) -> float:
        return self._ledger._full_exchange_cost(model_floats)

    def full_exchange_time(self, model_floats: float) -> float:
        return self._ledger._full_exchange_time(model_floats)

    def measured_latency_s(self, e: Edge, cls: str = "lan") -> float:
        return self._ledger._measured_latency_s(e, cls)

    def measured_price_per_float(self, e: Edge,
                                 cls: str = "lan") -> float:
        return self._ledger._measured_price_per_float(e, cls)

    def measured_full_exchange_cost(self, model_floats: float,
                                    fabric=None) -> float:
        return self._ledger._measured_full_exchange_cost(
            model_floats, fabric=fabric)

    def measured_full_exchange_time(self, model_floats: float,
                                    fabric=None) -> float:
        return self._ledger._measured_full_exchange_time(
            model_floats, fabric=fabric)

    def cm_denominator(self, model_floats: float, fabric=None) -> float:
        return self._ledger._cm_denominator(model_floats, fabric=fabric)

    # ---- dict conveniences (tests / debugging; O(E) builds) ----
    def edge_clock_map(self) -> Dict[Edge, float]:
        """Per-link virtual clocks keyed by canonical edge (only edges
        that were ever clock-charged appear — the legacy
        ``edge_clocks()`` contract)."""
        idx = np.flatnonzero(self.edge_seen)
        return {self.edges[k]: float(self.edge_clock[k]) for k in idx}

    def traffic_map(self) -> Dict[Edge, float]:
        """Every float ever booked keyed by canonical edge (edges with
        zero traffic omitted — the legacy ``traffic_by_edge()``
        contract)."""
        idx = np.flatnonzero(self.edge_traffic)
        return {self.edges[k]: float(self.edge_traffic[k]) for k in idx}


class CommLedger:
    """Accumulates per-edge traffic and simulated time for one run.

    ``record_exchange(c)``: all-to-all style — each node's ``c`` exchanged
    floats are spread uniformly over its incident edges (the sum over
    edges conserves ``K * c``); priced on the schedule's union graph
    (parameter-server-style traffic has no per-round edge set).
    ``record_gossip(m, t)``: D-PSGD style — every edge *active in round
    t's graph* carries the full model once per direction (``2m`` per
    active edge), masked down to the round's participants when a
    ``participation`` sampler is attached.  In ``async_mode`` a per-edge
    ``staleness`` bound (AD-PSGD) amortizes each link's latency over
    ``staleness + 1`` in-flight deliveries.
    ``record_probe(edges, m)``: SkewScout model traveling — ``m`` floats
    cross each probed union link once.

    Construction takes the typed :class:`~repro_torch.configs.base.FabricConfig`
    (``config=``, default ``FabricConfig()``) for the amortization and
    re-wiring knobs.  Read results through :meth:`view`.
    """

    def __init__(self, fabric: Union[Topology, TopologySchedule],
                 profile: LinkProfile, *,
                 config: Optional[FabricConfig] = None,
                 async_mode: bool = False,
                 link_model=None,
                 participation=None,
                 ewma_alpha: float = 0.1):
        config = FabricConfig() if config is None else config
        self.profile = profile
        self.rewire_floats_per_edge = float(config.rewire_floats)
        self.async_mode = bool(async_mode)
        # stochastic per-link sampler (repro_torch.topology.links.LinkModel);
        # None keeps the class-constant pricing
        self.links = link_model
        # per-round client sampler (repro_torch.topology.links.Participation);
        # None = everyone participates every round (the legacy pricing)
        self.participation = participation
        self.amortize_window = int(config.amortize_window)
        assert self.amortize_window >= 1, self.amortize_window
        assert 0.0 < ewma_alpha <= 1.0, ewma_alpha
        self.ewma_alpha = float(ewma_alpha)
        # ---- the eid-indexed array core ----
        # canonical edge -> stable edge id; grown at graph registration
        self._eid: Dict[Edge, int] = {}
        self._edge_of_eid: List[Edge] = []
        self._eid_i = np.zeros(0, np.int64)   # endpoint arrays by eid
        self._eid_j = np.zeros(0, np.int64)
        self._clock = np.zeros(0)             # per-edge virtual clock (s)
        self._clock_seen = np.zeros(0, bool)  # ever clock-charged
        self._traffic = np.zeros(0)           # floats booked, by eid
        # per-edge EWMA measured costs (observed latency seconds and
        # price seconds/float) — SkewScout's measured-cost denominators
        self._ewma_lat = np.zeros(0)
        self._ewma_price = np.zeros(0)
        self._ewma_seen = np.zeros(0, bool)
        # handshake amortization: unpaid balance + per-activation
        # installment by eid; `_pending` keeps the dict-era insertion
        # order (the sequential pay/forfeit folds are order-sensitive)
        self._hs_bal = np.zeros(0)
        self._hs_inst = np.zeros(0)
        self._pending: Dict[int, None] = {}
        # running transfer seconds with every float priced at the
        # bandwidth its activation actually sampled — the sync C(θ)
        # numerator that stays in the same currency as the measured CM
        self._sampled_cost_s = 0.0
        self.lan_floats = 0.0
        self.wan_floats = 0.0
        self.sim_time_s = 0.0
        # online re-wiring accounting (floats also in lan/wan totals)
        self.rewire_lan_floats = 0.0
        self.rewire_wan_floats = 0.0
        self.rewire_events = 0
        self.rewire_time_s = 0.0     # handshake seconds booked on links
        # communication rounds recorded — includes probe/overhead
        # exchanges, so this is NOT the trainer's step count
        self.rounds = 0
        self._last_active: Optional[frozenset] = None
        self._pricing: Dict[int, _GraphPricing] = {}
        self._measured_ids: Dict[int, tuple] = {}
        self._version = 0
        self._view: Optional[LedgerView] = None
        self._view_version = -1
        self._attach(as_schedule(fabric))
        # per-node busy time: each round a node participates in, it
        # works for the max cost over its own activated incident links
        self.node_busy_s = np.zeros(self.topology.n_nodes)

    # ---- edge registration ----
    def _register(self, graph: Topology) -> np.ndarray:
        """Assign stable eids to any of ``graph``'s edges the ledger has
        not seen, growing the flat bookkeeping arrays; returns the
        graph's eid index array."""
        eid = self._eid
        miss = [e for e in graph.edges if e not in eid]
        if miss:
            start = len(self._edge_of_eid)
            for k, e in enumerate(miss):
                eid[e] = start + k
            self._edge_of_eid.extend(miss)
            add = len(miss)
            self._eid_i = np.concatenate(
                [self._eid_i, np.asarray([i for i, _ in miss], np.int64)])
            self._eid_j = np.concatenate(
                [self._eid_j, np.asarray([j for _, j in miss], np.int64)])
            z = np.zeros(add)
            zb = np.zeros(add, bool)
            self._clock = np.concatenate([self._clock, z])
            self._clock_seen = np.concatenate([self._clock_seen, zb])
            self._traffic = np.concatenate([self._traffic, z])
            self._ewma_lat = np.concatenate([self._ewma_lat, z])
            self._ewma_price = np.concatenate([self._ewma_price, z])
            self._ewma_seen = np.concatenate([self._ewma_seen, zb])
            self._hs_bal = np.concatenate([self._hs_bal, z])
            self._hs_inst = np.concatenate([self._hs_inst, z])
        if not graph.edges:
            return np.zeros(0, np.int64)
        return np.fromiter((eid[e] for e in graph.edges), np.int64,
                           len(graph.edges))

    def _attach(self, schedule: TopologySchedule) -> None:
        self.schedule = schedule
        self.topology = schedule.union()
        self._union_pricing = _GraphPricing(
            self.topology, self.profile, self._register(self.topology))

    def _graph_pricing(self, graph: Topology) -> _GraphPricing:
        p = self._pricing.get(id(graph))
        if p is None:
            p = self._pricing[id(graph)] = _GraphPricing(
                graph, self.profile, self._register(graph))
        return p

    # ---- recording ----
    def _book_floats(self, pricing: _GraphPricing,
                     per_edge: np.ndarray) -> None:
        """Attribute ``per_edge`` floats (aligned with ``pricing.graph``'s
        edge list) to links and LAN/WAN totals — all vectorized; the
        eid-indexed traffic array only absorbs the per-graph accumulator
        on cold reads (``view``/``switch_schedule``)."""
        pricing.traffic += per_edge
        self.lan_floats += float(per_edge[~pricing.is_wan].sum())
        self.wan_floats += float(per_edge[pricing.is_wan].sum())

    def _link_rates(self, pricing: _GraphPricing, active: np.ndarray
                    ) -> tuple:
        """Per-edge (latency, bandwidth) for one activation of the
        ``active`` edges: the graph's class constants, or — with a
        ``link_model`` attached — the sampled values, each observation
        folded into the per-edge EWMA measured costs (one vectorized
        elementwise fold; bit-equal to the per-edge scalar fold)."""
        if self.links is None or not self.links.stochastic:
            # identity sampling: constants are the truth, the EWMA fold
            # would only re-derive them — keep the hot path draw-free
            return pricing.lat, pricing.bw
        lat, bw = self.links.sample(pricing.graph.edges, pricing.lat,
                                    pricing.bw, active)
        act = np.flatnonzero(active)
        if act.size:
            ids = pricing.eids[act]
            a = self.ewma_alpha
            obs_lat = lat[act]
            obs_price = 1.0 / bw[act]
            seen = self._ewma_seen[ids]
            self._ewma_lat[ids] = np.where(
                seen, (1.0 - a) * self._ewma_lat[ids] + a * obs_lat,
                obs_lat)
            self._ewma_price[ids] = np.where(
                seen, (1.0 - a) * self._ewma_price[ids] + a * obs_price,
                obs_price)
            self._ewma_seen[ids] = True
        return lat, bw

    def _book_sampled_cost(self, per_edge: np.ndarray, bw: np.ndarray,
                           active: np.ndarray) -> None:
        """Accumulate the transfer seconds of ``per_edge`` floats at the
        (possibly sampled) ``bw`` of this activation — the sampled
        analogue of ``priced_cost``'s float-times-constant-price sum.
        No-op without a stochastic link model: ``sampled_priced_cost``
        falls back to ``priced_cost`` there."""
        if self.links is not None and self.links.stochastic:
            self._sampled_cost_s += float(
                (per_edge[active] / bw[active]).sum())

    def _pay_installments(self, pricing: _GraphPricing,
                          active: np.ndarray) -> Optional[np.ndarray]:
        """Handshake installments due this round: each active edge with
        an unpaid balance pays ``handshake / amortize_window`` into its
        round cost.  Returns the per-edge installment array (None when
        nothing is owed).  The loop runs over the pending set only
        (empty in steady state) in insertion order — the sequential
        ``rewire_time_s`` fold is order-sensitive."""
        if not self._pending:
            return None
        inst = None
        for g in list(self._pending):
            n = pricing.pos_of.get(g)
            if n is None or not active[n]:
                continue
            bal = float(self._hs_bal[g])
            pay = min(float(self._hs_inst[g]), bal)
            if inst is None:
                inst = np.zeros(len(pricing.graph.edges))
            inst[n] += pay
            self.rewire_time_s += pay
            bal -= pay
            if bal <= 1e-18:
                del self._pending[g]
                self._hs_bal[g] = 0.0
                self._hs_inst[g] = 0.0
            else:
                self._hs_bal[g] = bal
        return inst

    def _charge_time(self, pricing: _GraphPricing,
                     cost: np.ndarray, active: np.ndarray) -> None:
        """Advance the clocks by ``cost`` seconds per edge (aligned with
        ``pricing.graph.edges``; only ``active`` entries count).

        sync: stop-and-wait — the global clock grows by the round's max
        cost and every activated edge snaps to it.  async: each edge's
        clock advances by its own cost; the global clock is the max of
        the *activated* edges' clocks (monotone by construction)."""
        if not active.any():
            return
        ids = pricing.eids[active]
        if self.async_mode:
            newc = self._clock[ids] + cost[active]
            self._clock[ids] = newc
            self.sim_time_s = max(self.sim_time_s, float(newc.max()))
        else:
            self.sim_time_s += float(cost[active].max())
            self._clock[ids] = self.sim_time_s
        self._clock_seen[ids] = True
        busy = np.zeros(len(self.node_busy_s))
        own = np.where(active, cost, 0.0)
        np.maximum.at(busy, pricing.ei, own)
        np.maximum.at(busy, pricing.ej, own)
        self.node_busy_s += busy

    def _rewire(self, pricing: _GraphPricing) -> None:
        """Charge the online re-wiring cost for links that were not
        active in the previous gossip round: a control-plane handshake
        of ``rewire_floats_per_edge`` floats per new link, priced at the
        link's class and added to the simulated step time; the link's
        per-class *setup latency* (``LinkProfile.handshake``: WAN >>
        LAN) is charged as its own serial setup event at the default
        ``amortize_window=1`` (the exact legacy behaviour), or scheduled
        as ``handshake / amortize_window`` installments paid into the
        link's first ``amortize_window`` gossip activations.  Links
        dropped before their window completes forfeit the unpaid
        balance immediately.
        Floats are booked into the LAN/WAN totals too, so ``lan_floats +
        wan_floats`` still covers every priced float.  Only gossip
        rounds carry an active edge set — union-routed exchanges
        (probes) never re-wire and never reset the tracking."""
        if self._last_active is None or \
                pricing.active is self._last_active or \
                pricing.active == self._last_active:
            self._last_active = pricing.active
            return
        prev = self._last_active
        new = pricing.active - prev
        dropped = prev - pricing.active
        self._last_active = pricing.active
        # teardown: a dropped link's unamortized handshake balance is
        # charged now — the setup work was spent; only the booking was
        # deferred.  This is what keeps schedule thrashing as expensive
        # as un-amortized switching.
        if dropped and self._pending:
            forfeit_max = 0.0
            forfeited = []
            busy = np.zeros(len(self.node_busy_s))
            for e in dropped:
                g = self._eid.get(e)
                if g is None or g not in self._pending:
                    continue
                bal = float(self._hs_bal[g])
                del self._pending[g]
                self._hs_bal[g] = 0.0
                self._hs_inst[g] = 0.0
                if bal <= 0.0:
                    continue
                forfeited.append(g)
                self.rewire_time_s += bal
                # the endpoints did this work: keep busy/idle/clock-skew
                # accounting comparable across amortize_window settings
                # (at window 1 the same seconds flow through the round's
                # _charge_time and land on the endpoints there)
                for k in e:
                    if k < len(busy):
                        busy[k] = max(busy[k], bal)
                if self.async_mode:
                    c = float(self._clock[g]) + bal
                    self._clock[g] = c
                    self._clock_seen[g] = True
                    self.sim_time_s = max(self.sim_time_s, c)
                else:
                    forfeit_max = max(forfeit_max, bal)
            # sync: teardowns run in parallel across the dropped links,
            # and the links that actually forfeited (only those — a
            # fully-paid dropped edge keeps its stale clock) snap to the
            # global clock
            self.sim_time_s += forfeit_max
            if forfeited and not self.async_mode:
                ids = np.asarray(forfeited, np.int64)
                self._clock[ids] = np.maximum(self._clock[ids],
                                              self.sim_time_s)
                self._clock_seen[ids] = True
            self.node_busy_s += busy
        if not new:
            return
        new_ids = np.fromiter((self._eid[e] for e in new), np.int64,
                              len(new))
        if self.async_mode:
            # a (re)activated link joins at the global frontier: it
            # cannot have banked transfer time while it did not exist.
            # Without this, a rung switch would hand the controller a
            # free window (the new fabric's clocks lag the ratcheted
            # global max, so C(θ) reads ~0 until they catch up).
            self._clock[new_ids] = np.maximum(self._clock[new_ids],
                                              self.sim_time_s)
            self._clock_seen[new_ids] = True
        is_new = np.zeros(len(self._edge_of_eid), bool)
        is_new[new_ids] = True
        is_new = is_new[pricing.eids]
        per_edge = np.where(is_new, self.rewire_floats_per_edge, 0.0)
        if self.rewire_floats_per_edge > 0.0:
            self._book_floats(pricing, per_edge)
            self.rewire_lan_floats += float(per_edge[~pricing.is_wan].sum())
            self.rewire_wan_floats += float(per_edge[pricing.is_wan].sum())
        # window 1 (the default) keeps the exact legacy behaviour: the
        # whole handshake is charged here as its own serial setup event.
        # W > 1 schedules it as installments over the link's first W
        # activations instead (re-activation restarts the window: the
        # old connection is gone)
        if self.amortize_window > 1:
            for n in np.flatnonzero(is_new):
                g = int(pricing.eids[n])
                hs = float(pricing.hs[n])
                if hs > 0.0:
                    self._hs_bal[g] = hs
                    self._hs_inst[g] = hs / self.amortize_window
                    self._pending[g] = None
            hs_now = 0.0
        else:
            hs_now = pricing.hs
        # the control-plane transfer itself (amortized handshake latency
        # is paid through the installments, starting with this round's
        # gossip; control-plane floats are priced at nominal constants)
        self._book_sampled_cost(per_edge, pricing.bw, is_new)
        cost = np.where(is_new,
                        hs_now + pricing.lat + per_edge / pricing.bw, 0.0)
        self.rewire_time_s += float(cost[is_new].sum())
        self._charge_time(pricing, cost, cost > 0)
        self.rewire_events += len(new)

    def record_exchange(self,
                        floats_per_node: Union[float, Sequence[float]]
                        ) -> None:
        """All-to-all exchange of ``floats_per_node`` floats per node,
        routed uniformly over each node's incident edges of the union
        fabric.  Union routing has no per-round active edge set, so it
        neither pays nor resets re-wiring."""
        pricing = self._union_pricing
        K = self.topology.n_nodes
        c = np.broadcast_to(np.asarray(floats_per_node, np.float64), (K,))
        share = np.where(pricing.deg > 0,
                         c / np.maximum(pricing.deg, 1), 0.0)
        per_edge = share[pricing.ei] + share[pricing.ej]
        self._book_floats(pricing, per_edge)
        active = per_edge > 0
        lat, bw = self._link_rates(pricing, active)
        self._book_sampled_cost(per_edge, bw, active)
        self._charge_time(pricing,
                          np.where(active, lat + per_edge / bw, 0.0),
                          active)
        self.rounds += 1
        self._version += 1

    def record_gossip(self, model_floats: float,
                      t: Optional[int] = None,
                      staleness: Union[None, int, Sequence[int]] = None
                      ) -> None:
        """One gossip round at round index ``t``: the full model crosses
        every edge active in ``schedule.at(t)``, both directions.
        ``t=None`` keeps the legacy one-graph behaviour (round 0).

        ``staleness`` (async mode only): per-edge bounded-staleness
        values (scalar broadcasts) — a link tolerating ``s``-stale
        deliveries pipelines ``s + 1`` payloads, so its latency is paid
        once per ``s + 1`` activations.  Ignored in sync mode, where
        every round is stop-and-wait regardless of the algorithm.

        With a ``participation`` sampler attached, the round's mask
        drops every edge whose endpoints did not both show up: no
        floats, no time, no installment payment, no link-model draw.
        Re-wiring still tracks the schedule's full active set (sampling
        out is not a teardown)."""
        graph = self.schedule.at(0 if t is None else t)
        pricing = self._graph_pricing(graph)
        self._rewire(pricing)
        n_edges = len(graph.edges)
        if self.participation is not None:
            m = self.participation.mask(0 if t is None else t)
            per_edge = np.where(m[pricing.ei] & m[pricing.ej],
                                2.0 * model_floats, 0.0)
        else:
            per_edge = np.full(n_edges, 2.0 * model_floats)
        self._book_floats(pricing, per_edge)
        active = per_edge > 0
        lat, bw = self._link_rates(pricing, active)
        self._book_sampled_cost(per_edge, bw, active)
        if self.async_mode and staleness is not None:
            s = np.broadcast_to(np.asarray(staleness, np.float64),
                                (n_edges,))
            assert (s >= 0).all(), "staleness must be non-negative"
            lat = lat / (1.0 + s)
        cost = np.where(active, lat + per_edge / bw, 0.0)
        inst = self._pay_installments(pricing, active)
        if inst is not None:
            cost = cost + inst
        self._charge_time(pricing, cost, active)
        self.rounds += 1
        self._version += 1

    def record_probe(self, edges: Sequence[Edge],
                     floats_each: float) -> None:
        """SkewScout model traveling: ``floats_each`` floats cross each
        probed link once (one direction).  Probes ride union-fabric
        links (probe routing follows active edges, which are union
        members), are booked into the LAN/WAN totals and per-edge
        traffic, block on delivery (staleness 0 — the measurement needs
        the fresh model), and neither pay nor reset re-wiring."""
        pricing = self._union_pricing
        per_edge = np.zeros(len(pricing.graph.edges))
        for i, j in edges:
            e = (min(i, j), max(i, j))
            assert e in pricing.edge_index, \
                f"probe edge {e} is not on the union fabric"
            per_edge[pricing.edge_index[e]] += float(floats_each)
        self._book_floats(pricing, per_edge)
        active = per_edge > 0
        lat, bw = self._link_rates(pricing, active)
        self._book_sampled_cost(per_edge, bw, active)
        self._charge_time(pricing,
                          np.where(active, lat + per_edge / bw, 0.0),
                          active)
        self.rounds += 1
        self._version += 1

    def switch_schedule(self, fabric: Union[Topology, TopologySchedule]
                        ) -> None:
        """Swap the fabric mid-run (SkewScout climbing a topology rung).
        Accumulated traffic and per-edge clocks are preserved (eids are
        stable for life); the first gossip round on the new schedule
        pays re-wiring for every link the old round's active set did not
        have."""
        schedule = as_schedule(fabric)
        assert schedule.n_nodes == self.topology.n_nodes, \
            (schedule.n_nodes, self.topology.n_nodes)
        self._flush_traffic()
        self._attach(schedule)
        self._pricing.clear()
        self._version += 1

    def _flush_traffic(self) -> None:
        """Fold the per-graph accumulators into the canonical
        eid-indexed traffic array (cold path: views and schedule
        switches) — one binary add per edge per flush, the dict-era
        grouping."""
        self._union_pricing.flush_into(self._traffic)
        for p in self._pricing.values():
            p.flush_into(self._traffic)

    # ---- the read API ----
    def view(self) -> LedgerView:
        """Frozen :class:`LedgerView` snapshot; version-cached, so
        repeated reads between mutations cost nothing."""
        if self._view is not None and self._view_version == self._version:
            return self._view
        self._flush_traffic()
        n = len(self._edge_of_eid)
        self._view = LedgerView(
            n_nodes=self.topology.n_nodes,
            async_mode=self.async_mode,
            rounds=self.rounds,
            amortize_window=self.amortize_window,
            sim_time_s=self.sim_time_s,
            lan_floats=self.lan_floats,
            wan_floats=self.wan_floats,
            total_floats=self._total_floats(),
            priced_cost=self._priced_cost(),
            sampled_priced_cost=self._sampled_priced_cost(),
            window_cost=self._window_cost(),
            rewire_lan_floats=self.rewire_lan_floats,
            rewire_wan_floats=self.rewire_wan_floats,
            rewire_floats=self._rewire_floats_total(),
            rewiring_cost=self._rewiring_cost(),
            rewire_events=self.rewire_events,
            rewire_time_s=self.rewire_time_s,
            pending_handshake_s=self._pending_handshake_s(),
            clock_skew_s=self._clock_skew_s(),
            edges=tuple(self._edge_of_eid),
            edge_clock=self._clock[:n].copy(),
            edge_seen=self._clock_seen[:n].copy(),
            edge_traffic=self._traffic[:n].copy(),
            union_eids=self._union_pricing.eids.copy(),
            ewma_latency_s=self._ewma_lat[:n].copy(),
            ewma_price_s=self._ewma_price[:n].copy(),
            ewma_seen=self._ewma_seen[:n].copy(),
            node_clock=self._node_clocks(),
            node_busy_s=self.node_busy_s.copy(),
            node_idle_s=self._node_idle_s(),
            _ledger=self,
        )
        self._view_version = self._version
        return self._view

    # ---- private implementations (read through view()) ----
    def _total_floats(self) -> float:
        return self.lan_floats + self.wan_floats

    def _priced_cost(self) -> float:
        return (self.lan_floats * self.profile.price_per_float("lan")
                + self.wan_floats * self.profile.price_per_float("wan"))

    def _sampled_priced_cost(self) -> float:
        if self.links is None or not self.links.stochastic:
            return self._priced_cost()
        return self._sampled_cost_s

    def _rewire_floats_total(self) -> float:
        return self.rewire_lan_floats + self.rewire_wan_floats

    def _rewiring_cost(self) -> float:
        return (self.rewire_lan_floats * self.profile.price_per_float("lan")
                + self.rewire_wan_floats
                * self.profile.price_per_float("wan"))

    def _window_cost(self) -> float:
        if self.async_mode:
            return self.sim_time_s
        return self._sampled_priced_cost()

    def _pending_handshake_s(self) -> float:
        return float(sum(float(self._hs_bal[g]) for g in self._pending))

    def _node_clocks(self) -> np.ndarray:
        clk = np.zeros(self.topology.n_nodes)
        K = len(clk)
        seen = self._clock_seen
        ids = np.flatnonzero(seen)
        if ids.size:
            c = self._clock[ids]
            i = self._eid_i[ids]
            j = self._eid_j[ids]
            mi = i < K
            mj = j < K
            np.maximum.at(clk, i[mi], c[mi])
            np.maximum.at(clk, j[mj], c[mj])
        return clk

    def _clock_skew_s(self) -> float:
        clk = self._node_clocks()
        return float(clk.max() - clk.min()) if len(clk) else 0.0

    def _node_idle_s(self) -> np.ndarray:
        return np.maximum(self.sim_time_s - self.node_busy_s, 0.0)

    def _full_exchange(self, model_floats: float, g: Topology,
                       lat_e: np.ndarray, price_e: np.ndarray,
                       worst: bool) -> float:
        """One BSP-style full-model exchange on ``g`` (each node's model
        share routed uniformly over its incident edges): the max link
        time (``worst=True``, latency + transfer) or the summed
        bandwidth-seconds (sequential fold — bit-equal to the retired
        per-edge loop).  The per-edge (latency, price) arrays come from
        the callers, so the constant and measured variants share one
        routing formula."""
        if not len(g.edges):
            return 1e-30
        deg = g.degrees().astype(np.float64)
        share = model_floats / np.maximum(deg, 1)
        ei = np.asarray([i for i, _ in g.edges], np.int64)
        ej = np.asarray([j for _, j in g.edges], np.int64)
        per_edge = share[ei] + share[ej]
        if worst:
            acc = max(0.0, float((lat_e + per_edge * price_e).max()))
        else:
            acc = _seqsum(per_edge * price_e)
        return max(acc, 1e-30)

    def _const_rates(self, g: Topology) -> tuple:
        is_wan = _wan_mask(g)
        lat = np.where(is_wan, self.profile.latency("wan"),
                       self.profile.latency("lan"))
        price = np.where(is_wan, self.profile.price_per_float("wan"),
                         self.profile.price_per_float("lan"))
        return lat, price

    def _full_exchange_cost(self, model_floats: float) -> float:
        lat, price = self._const_rates(self.topology)
        return self._full_exchange(model_floats, self.topology, lat,
                                   price, worst=False)

    def _full_exchange_time(self, model_floats: float) -> float:
        lat, price = self._const_rates(self.topology)
        return self._full_exchange(model_floats, self.topology, lat,
                                   price, worst=True)

    def _measured_latency_s(self, e: Edge, cls: str = "lan") -> float:
        g = self._eid.get(e)
        if g is not None and self._ewma_seen[g]:
            return float(self._ewma_lat[g])
        return self.profile.latency(cls)

    def _measured_price_per_float(self, e: Edge,
                                  cls: str = "lan") -> float:
        g = self._eid.get(e)
        if g is not None and self._ewma_seen[g]:
            return float(self._ewma_price[g])
        return self.profile.price_per_float(cls)

    def _measured_union(self, fabric) -> Topology:
        return self.topology if fabric is None \
            else as_schedule(fabric).union()

    def _measured_rates(self, g: Topology) -> tuple:
        """Per-edge EWMA measured (latency, price) with profile-constant
        fallback for never-observed links, cached per graph object."""
        ent = self._measured_ids.get(id(g))
        if ent is None or ent[0] is not g:
            ids = np.fromiter((self._eid.get(e, -1) for e in g.edges),
                              np.int64, len(g.edges))
            self._measured_ids[id(g)] = ent = (g, ids)
        ids = ent[1]
        lat_c, price_c = self._const_rates(g)
        seen = (ids >= 0) & self._ewma_seen[np.maximum(ids, 0)]
        safe = np.maximum(ids, 0)
        lat = np.where(seen, self._ewma_lat[safe], lat_c)
        price = np.where(seen, self._ewma_price[safe], price_c)
        return lat, price

    def _measured_full_exchange_cost(self, model_floats: float,
                                     fabric=None) -> float:
        g = self._measured_union(fabric)
        lat, price = self._measured_rates(g)
        return self._full_exchange(model_floats, g, lat, price,
                                   worst=False)

    def _measured_full_exchange_time(self, model_floats: float,
                                     fabric=None) -> float:
        g = self._measured_union(fabric)
        lat, price = self._measured_rates(g)
        return self._full_exchange(model_floats, g, lat, price,
                                   worst=True)

    def _cm_denominator(self, model_floats: float,
                        fabric=None) -> float:
        if self.links is not None:
            return (self._measured_full_exchange_time(model_floats,
                                                      fabric=fabric)
                    if self.async_mode
                    else self._measured_full_exchange_cost(model_floats,
                                                           fabric=fabric))
        return (self._full_exchange_time(model_floats) if self.async_mode
                else self._full_exchange_cost(model_floats))

    def summary(self) -> Dict[str, float]:
        return dict(lan_floats=self.lan_floats, wan_floats=self.wan_floats,
                    total_floats=self._total_floats(),
                    sim_time_s=self.sim_time_s,
                    priced_cost=self._priced_cost(), rounds=self.rounds,
                    rewire_floats=self._rewire_floats_total(),
                    rewire_events=self.rewire_events,
                    rewire_time_s=self.rewire_time_s,
                    async_mode=float(self.async_mode),
                    clock_skew_s=self._clock_skew_s(),
                    busy_s_max=float(self.node_busy_s.max()),
                    idle_s_mean=float(self._node_idle_s().mean()),
                    amortize_window=float(self.amortize_window),
                    pending_handshake_s=self._pending_handshake_s(),
                    **({"link_" + k: float(v)
                        for k, v in self.links.summary().items()}
                       if self.links is not None else {}),
                    **({"participation": float(self.participation.fraction)}
                       if self.participation is not None else {}))
