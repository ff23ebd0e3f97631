"""Communication-fabric subsystem: who talks to whom, when, and at what
cost.

Module map
----------
``graphs.py``
    :class:`Topology` (edge list + symmetric doubly-stochastic mixing
    matrix + per-edge LAN/WAN class + cached adjacency) and the static
    builders: ``fully_connected``, ``ring``, ``torus``,
    ``random_regular`` (expander), ``hierarchical`` (geo-WAN
    datacenters), ``hierarchical_cliques`` (bounded-degree
    cliques-of-cliques — the 10k+-node ledger-scale fabric; past
    ``MIXING_AUTO_MAX`` nodes the dense mixing matrix is skipped),
    ``d_cliques`` (label-aware cliques from partition
    label histograms).  :class:`TopologySchedule` generalizes the fabric
    to one graph *per round*: ``constant_schedule`` wraps any static
    graph, ``time_varying_d_cliques`` is Bellet et al.'s
    one-peer-per-round variant, ``random_matching_schedule`` is the
    EquiTopo-style i.i.d. matching fabric, and ``topology_ladder``
    builds SkewScout's rungs (full -> hierarchical -> dcliques -> ring).
    ``build_topology`` / ``build_schedule`` are the registries keyed by
    ``CommConfig.topology``.

``costs.py``
    :class:`LinkProfile` (per-class bandwidth/latency/handshake presets
    in ``LINK_PROFILES``: uniform | datacenter | geo-wan) and
    :class:`CommLedger`, which prices each algorithm's exchanged floats
    against the *active edge set of the round's graph*, tracks LAN/WAN
    totals and a simulated wall-clock step time, and charges an explicit
    online re-wiring cost — control-plane floats plus per-class
    handshake latency — whenever the active edge set changes (schedule
    rotation or a SkewScout rung switch via ``switch_schedule``).  Two
    timing models share the float accounting: synchronous rounds cost
    the slowest activated link; ``async_mode`` (AD-PSGD) gives every
    link its own virtual clock — a round costs the activated edges' max
    clock, bounded staleness amortizes link latency, and per-node
    busy/idle/clock-skew accounting exposes the stragglers.  All
    bookkeeping lives in flat arrays over a stable edge index — one
    gossip round is O(active edges) of vectorized work, so 10k+-node
    fabrics price in milliseconds per round.  Reads go through the
    frozen :class:`LedgerView` snapshot (``CommLedger.view()``), the
    ledger's only read API.  The ledger
    is threaded through ``core/trainer.py`` and prices SkewScout's
    ``C(theta)/CM`` objective in WAN-weighted cost (sync) or simulated
    wall-clock (async); SkewScout probe shipments are booked per edge
    via ``record_probe``.

``links.py``
    :class:`LinkModel`, the stochastic-heterogeneous-link sampler: each
    edge draws a persistent base latency/bandwidth from its class's
    distribution (``hetero``), every activation applies a median-1
    lognormal jitter (``jitter``), and a per-edge Markov chain produces
    bursty transient slowdowns (``straggler_rate`` / ``straggler_exit``
    / ``straggler_slowdown``).  All draws are keyed by ``(seed, edge,
    activation index)`` — bit-identical replay across ledger rebuilds.
    The ledger samples it when ``link_model=`` is attached, folds each
    observation into per-edge EWMA *measured* costs
    (``measured_full_exchange_time/cost``), and amortizes re-wiring
    handshakes over ``amortize_window`` activations.
    ``make_link_model`` builds it from a ``LinkConfig``
    (``CommConfig.fabric.link``).  :class:`Participation` is the seeded
    per-round node sampler behind partial participation: the same mask
    gates the ledger's priced traffic, the gossip mixing weights, and
    SkewScout's probe routes, on a key stream disjoint from the link
    draws.

Downstream consumers
--------------------
``core/algorithms/dpsgd.py`` (gossip averaging = ``W_t @ params`` on the
round's edges, per-round neighbor operands through the hand-written
``kernels/csrc/neighbor_mix.cu`` kernel) and ``core/trainer.py`` (the
ledger that prices every exchange of a run).  This package is a NumPy
copy of ``repro.topology``; nothing in it imports torch.
"""
from repro_torch.topology.costs import (LINK_PROFILES, CommLedger,
                                        LedgerView, LinkProfile)
from repro_torch.topology.links import (LinkModel, Participation,
                                        make_link_model)
from repro_torch.topology.graphs import (LABEL_AWARE_TOPOLOGIES,
                                         MIXING_AUTO_MAX, Topology,
                                         TopologySchedule, as_schedule,
                                         build_schedule, build_topology,
                                         constant_schedule, d_cliques,
                                         fully_connected,
                                         greedy_clique_assignment, hierarchical,
                                         hierarchical_cliques,
                                         metropolis_weights,
                                         random_matching_schedule, random_regular,
                                         ring, topology_ladder, torus,
                                         time_varying_d_cliques)

__all__ = ["LINK_PROFILES", "CommLedger", "LedgerView", "LinkProfile",
           "LinkModel", "MIXING_AUTO_MAX", "Participation",
           "Topology", "TopologySchedule", "LABEL_AWARE_TOPOLOGIES",
           "as_schedule", "build_schedule", "build_topology",
           "constant_schedule", "d_cliques", "fully_connected",
           "greedy_clique_assignment", "hierarchical",
           "hierarchical_cliques", "make_link_model",
           "metropolis_weights", "random_matching_schedule",
           "random_regular", "ring", "topology_ladder", "torus",
           "time_varying_d_cliques"]
