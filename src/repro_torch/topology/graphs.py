"""Communication graphs and mixing matrices.

Every topology is an undirected connected graph over the K nodes plus a
symmetric doubly-stochastic mixing matrix ``W`` (Metropolis–Hastings
weights), the gossip-averaging operator of D-PSGD (Lian et al., 2017):
``x_{t+1} = W @ x_t`` restricted to graph edges.  Edges carry a link
class ("lan" | "wan") consumed by the cost model in ``costs.py``.

Builders:
  fully_connected   all-to-all (W = 1/K everywhere: exact averaging)
  ring              cycle graph — the minimal-bandwidth baseline
  torus             2D wrap-around grid (near-square factorization of K)
  random_regular    d-regular expander via the pairing model
  hierarchical      geo-WAN: LAN cliques (datacenters) joined by WAN
                    links between gateway nodes (the paper's Gaia setting)
  hierarchical_cliques
                    cliques-of-cliques: LAN cliques whose gateways form
                    higher-level WAN cliques recursively — bounded degree,
                    the 10k+-node ledger-scale fabric
  d_cliques         label-aware cliques (Bellet et al., 2021): greedy
                    clique assembly so each clique's aggregate label
                    histogram is near-uniform; inter-clique ring over WAN

Schedules (:class:`TopologySchedule`): the fabric is a *sequence* of
graphs, one per gossip round, all over the same node set.  A single
frozen graph is the trivial constant schedule, so every consumer
(ledger, D-PSGD, SkewScout) speaks schedules and the one-graph-per-run
path keeps working unchanged.  Time-varying builders:
  constant_schedule          wrap any Topology
  time_varying_d_cliques     Bellet et al.'s one-peer-per-round variant:
                             round-robin matchings inside each label-
                             balanced clique + a single rotating WAN
                             inter-clique edge per round
  random_matching_schedule   EquiTopo-style i.i.d. random near-perfect
                             matchings (degree <= 1 per round)
  topology_ladder            SkewScout rungs, densest first:
                             full -> hierarchical -> (tv-)dcliques -> ring
``build_schedule`` is the registry keyed by ``CommConfig.topology``;
per-round graphs need not be connected — only the union over one period
must be (consensus still mixes across rounds).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

Edge = Tuple[int, int]


@dataclass(frozen=True)
class Topology:
    """An undirected communication graph with gossip weights.

    edges        canonical (i < j) undirected edge list
    mixing       (K, K) symmetric doubly-stochastic matrix, supported
                 exactly on edges + the diagonal — or ``None`` on
                 ledger-only fabrics past ``MIXING_AUTO_MAX`` nodes,
                 where the dense matrix alone would be gigabytes
    edge_class   per-edge link class, "lan" or "wan"
    cliques      D-Cliques / datacenter grouping (empty when unused)
    """
    name: str
    n_nodes: int
    edges: Tuple[Edge, ...]
    mixing: Optional[np.ndarray]
    edge_class: Tuple[str, ...] = ()
    cliques: Tuple[Tuple[int, ...], ...] = ()

    def __post_init__(self):
        if not self.edge_class:
            object.__setattr__(self, "edge_class",
                               ("lan",) * len(self.edges))
        assert len(self.edge_class) == len(self.edges)
        # adjacency cache, CSR layout: schedules rebuild neighbor sets
        # every round and the ledger gathers endpoints per round, so
        # neighbors() must be O(deg) and the build O(E) array work —
        # not a Python loop over 100k+ edges
        K = self.n_nodes
        if self.edges:
            pairs = np.asarray(self.edges, np.int64)
            ei, ej = pairs[:, 0], pairs[:, 1]
        else:
            ei = ej = np.zeros(0, np.int64)
        object.__setattr__(self, "_ei", ei)
        object.__setattr__(self, "_ej", ej)
        src = np.concatenate([ei, ej])
        dst = np.concatenate([ej, ei])
        deg = np.bincount(src, minlength=K).astype(np.int64)
        order = np.lexsort((dst, src))
        object.__setattr__(self, "_csr_dst", dst[order])
        object.__setattr__(self, "_csr_ptr",
                           np.concatenate([np.zeros(1, np.int64),
                                           np.cumsum(deg)]))
        object.__setattr__(self, "_deg", deg)

    # ---- structure ----
    def neighbors(self, k: int) -> List[int]:
        return self._csr_dst[self._csr_ptr[k]:self._csr_ptr[k + 1]] \
            .tolist()

    def edge_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """Endpoint arrays (ei, ej) aligned with ``edges`` — the
        vectorized consumers' layout (ledger pricing, full-exchange
        routing)."""
        return self._ei, self._ej

    def degrees(self) -> np.ndarray:
        return self._deg.copy()

    @property
    def max_degree(self) -> int:
        return int(self.degrees().max()) if self.edges else 0

    @property
    def mean_degree(self) -> float:
        return float(self.degrees().mean()) if self.edges else 0.0

    def wan_edge_indices(self) -> np.ndarray:
        return np.asarray([e for e, c in enumerate(self.edge_class)
                           if c == "wan"], np.int64)

    # ---- spectral ----
    def spectral_gap(self) -> float:
        """1 - |lambda_2(W)|: larger gap => faster gossip consensus."""
        assert self.mixing is not None, \
            f"{self.name}: no mixing matrix (ledger-only fabric past " \
            f"{MIXING_AUTO_MAX} nodes); rebuild with with_mixing=True"
        ev = np.sort(np.abs(np.linalg.eigvalsh(self.mixing)))
        return float(1.0 - ev[-2]) if len(ev) > 1 else 1.0

    # ---- kernel-facing layout ----
    def neighbor_arrays(self, pad_degree: Optional[int] = None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Padded (idx, weight, self_weight) arrays for the neighbor_mix
        kernel: idx (K, D) int32 padded with the node's own index, weight
        (K, D) float32 padded with 0, self_w (K,) float32 = diag(W).

        ``pad_degree`` widens D beyond this graph's max degree so every
        round of a schedule (and every rung of a topology ladder) shares
        one operand shape — the jitted step never retraces."""
        assert self.mixing is not None, \
            f"{self.name}: no mixing matrix (ledger-only fabric past " \
            f"{MIXING_AUTO_MAX} nodes); rebuild with with_mixing=True"
        K = self.n_nodes
        D = max(self.max_degree if pad_degree is None else pad_degree, 1)
        assert D >= self.max_degree, (D, self.max_degree)
        idx = np.tile(np.arange(K, dtype=np.int32)[:, None], (1, D))
        w = np.zeros((K, D), np.float32)
        fill = np.zeros(K, np.int64)
        for i, j in self.edges:
            for a, b in ((i, j), (j, i)):
                idx[a, fill[a]] = b
                w[a, fill[a]] = self.mixing[a, b]
                fill[a] += 1
        return idx, w, np.diag(self.mixing).astype(np.float32)


def _canonical(edges: Sequence[Edge]) -> List[Edge]:
    return sorted({(min(i, j), max(i, j)) for i, j in edges if i != j})


def metropolis_weights(n_nodes: int, edges: Sequence[Edge]) -> np.ndarray:
    """Symmetric doubly-stochastic W: W_ij = 1/(1 + max(deg_i, deg_j)) on
    edges, diagonal takes the slack.  Standard gossip weights — doubly
    stochastic for any graph, uniform 1/K on the complete graph."""
    W = np.zeros((n_nodes, n_nodes))
    if edges:
        pairs = np.asarray(list(edges), np.int64)
        ei, ej = pairs[:, 0], pairs[:, 1]
        deg = np.bincount(np.concatenate([ei, ej]), minlength=n_nodes)
        w = 1.0 / (1.0 + np.maximum(deg[ei], deg[ej]))
        W[ei, ej] = w
        W[ej, ei] = w
    np.fill_diagonal(W, 1.0 - W.sum(axis=1))
    return W


def _connected(n_nodes: int, edges: Sequence[Edge]) -> bool:
    """Label-propagation connected-components over endpoint arrays
    (hook to the min label, then pointer-jump until stable) — O(E log K)
    array work instead of a Python DFS, so the 125k-edge 10k-node
    fabrics stay cheap to validate."""
    if n_nodes <= 1:
        return True
    if not edges:
        return False
    pairs = np.asarray(list(edges), np.int64)
    ei, ej = pairs[:, 0], pairs[:, 1]
    comp = np.arange(n_nodes)
    while True:
        prev = comp.copy()
        lo = np.minimum(comp[ei], comp[ej])
        np.minimum.at(comp, ei, lo)
        np.minimum.at(comp, ej, lo)
        while True:
            jumped = comp[comp]
            if np.array_equal(jumped, comp):
                break
            comp = jumped
        if np.array_equal(comp, prev):
            break
    return int(comp.max()) == 0


MIXING_AUTO_MAX = 4096
"""Above this node count ``_build`` skips the dense mixing matrix: the
ledger, link model, and schedules only need edge lists, and (K, K)
float64 at 10k nodes is 800 MB.  Consumers that genuinely need W
(spectral gap, neighbor_mix operands) assert it is present."""


def _build(name: str, n_nodes: int, edges: Sequence[Edge],
           edge_class: Sequence[str] = (),
           cliques: Sequence[Tuple[int, ...]] = (),
           require_connected: bool = True,
           with_mixing: Optional[bool] = None) -> Topology:
    """``require_connected=False`` is for the per-round graphs of a
    time-varying schedule (matchings are never connected on their own —
    only the union over a period must be).  ``with_mixing=None`` builds
    W only up to ``MIXING_AUTO_MAX`` nodes; pass True/False to force."""
    edges = _canonical(edges)
    if n_nodes > 1 and require_connected:
        assert _connected(n_nodes, edges), f"{name}: graph not connected"
    if with_mixing is None:
        with_mixing = n_nodes <= MIXING_AUTO_MAX
    mixing = metropolis_weights(n_nodes, edges) if with_mixing else None
    return Topology(name, n_nodes, tuple(edges), mixing,
                    tuple(edge_class), tuple(tuple(c) for c in cliques))


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def fully_connected(n_nodes: int) -> Topology:
    edges = [(i, j) for i in range(n_nodes) for j in range(i + 1, n_nodes)]
    return _build("full", n_nodes, edges)


def ring(n_nodes: int) -> Topology:
    edges = [(k, (k + 1) % n_nodes) for k in range(n_nodes)]
    return _build("ring", n_nodes, edges)


def torus(n_nodes: int, rows: Optional[int] = None) -> Topology:
    """2D wrap-around grid; K is factorized near-square when ``rows`` is
    omitted.  Falls back to a ring when K is prime or < 4."""
    if rows is None:
        rows = int(np.sqrt(n_nodes))
        while rows > 1 and n_nodes % rows:
            rows -= 1
    if rows <= 1 or n_nodes < 4:
        return ring(n_nodes)
    cols = n_nodes // rows
    edges = []
    for r in range(rows):
        for c in range(cols):
            k = r * cols + c
            edges.append((k, r * cols + (c + 1) % cols))
            edges.append((k, ((r + 1) % rows) * cols + c))
    return _build("torus", n_nodes, edges)


def random_regular(n_nodes: int, degree: int = 4,
                   seed: int = 0) -> Topology:
    """d-regular graph via the pairing model — an expander with high
    probability (good spectral gap at constant degree)."""
    assert (n_nodes * degree) % 2 == 0, "K * degree must be even"
    assert degree < n_nodes, (degree, n_nodes)
    rng = np.random.default_rng(seed)
    for _ in range(200):
        stubs = np.repeat(np.arange(n_nodes), degree)
        rng.shuffle(stubs)
        pairs = stubs.reshape(-1, 2)
        if any(i == j for i, j in pairs):
            continue
        edges = _canonical([tuple(p) for p in pairs])
        if len(edges) != n_nodes * degree // 2:   # multi-edge collapsed
            continue
        if _connected(n_nodes, edges):
            return _build(f"random{degree}", n_nodes, edges)
    # degenerate small cases: fall back to a ring (always connected)
    return ring(n_nodes)


def hierarchical(n_nodes: int, n_datacenters: Optional[int] = None
                 ) -> Topology:
    """Geo-WAN: nodes grouped into datacenters; each datacenter is a LAN
    clique, and datacenter gateways (first node of each group) form a WAN
    clique — the paper's Gaia deployment shape."""
    if n_datacenters is None:
        n_datacenters = max(2, int(round(np.sqrt(n_nodes))))
    n_datacenters = min(n_datacenters, n_nodes)
    groups = [list(range(n_nodes))[d::n_datacenters]
              for d in range(n_datacenters)]
    groups = [g for g in groups if g]
    edges, cls = [], []
    for g in groups:
        for a in range(len(g)):
            for b in range(a + 1, len(g)):
                edges.append((g[a], g[b]))
                cls.append("lan")
    gateways = [g[0] for g in groups]
    for a in range(len(gateways)):
        for b in range(a + 1, len(gateways)):
            edges.append((gateways[a], gateways[b]))
            cls.append("wan")
    ec = {(min(i, j), max(i, j)): c for (i, j), c in zip(edges, cls)}
    edges = _canonical(edges)
    return _build("geo-wan", n_nodes, edges, [ec[e] for e in edges],
                  cliques=groups)


def hierarchical_cliques(n_nodes: int, clique_size: int = 25) -> Topology:
    """Cliques-of-cliques: the bounded-degree fabric that scales the
    geo-WAN shape to 10k+ nodes.

    Level 0 groups consecutive nodes into LAN cliques of ``clique_size``;
    each clique's first member is its gateway, and the gateways are
    recursively grouped into higher-level WAN cliques of the same size
    until a single top clique remains.  Every node keeps degree
    O(clique_size * levels) — at K=10000, c=25 that is ~125k edges and
    max degree 63, vs the flat :func:`hierarchical`'s sqrt(K)-degree
    gateways — and construction is O(E), so ledger-only pricing runs at
    fabric sizes where a dense mixing matrix is not even materialized
    (see ``MIXING_AUTO_MAX``)."""
    assert clique_size >= 2, clique_size
    edges: List[Edge] = []
    cls: List[str] = []
    groups = [list(range(n_nodes))[a:a + clique_size]
              for a in range(0, n_nodes, clique_size)]
    level0 = [g for g in groups if g]
    groups, wan = level0, False
    while True:
        for g in groups:
            for a in range(len(g)):
                for b in range(a + 1, len(g)):
                    edges.append((g[a], g[b]))
                    cls.append("wan" if wan else "lan")
        if len(groups) <= 1:
            break
        gateways = [g[0] for g in groups]
        groups = [gateways[a:a + clique_size]
                  for a in range(0, len(gateways), clique_size)]
        wan = True
    ec = {(min(i, j), max(i, j)): c for (i, j), c in zip(edges, cls)}
    edges = _canonical(edges)
    return _build("hier-cliques", n_nodes, edges,
                  [ec[e] for e in edges], cliques=level0)


def greedy_clique_assignment(label_hist: np.ndarray,
                             clique_size: Optional[int] = None,
                             seed: int = 0) -> List[List[int]]:
    """Greedy label-balanced clique assignment shared by the constant and
    time-varying D-Cliques builders: repeatedly absorb the node that most
    reduces the clique's TV distance to the global label distribution,
    so skew cancels *inside* each clique.

    The ``seed`` is the *only* source of randomness (one private
    ``default_rng``), and both builders route through this one helper —
    the same ``(label_hist, clique_size, seed)`` always yields the same
    assignment, and nothing another subsystem draws (e.g. the stochastic
    link model's keyed streams) can perturb it.  Callers that need the
    constant and time-varying variants to agree on cliques can also
    precompute the assignment here and pass it via ``cliques=``."""
    K, C = label_hist.shape
    if clique_size is None:
        # one clique should be able to span the label space: with
        # exclusive-label partitions each node holds ~C/K classes, so C
        # nodes per clique recovers a near-uniform clique histogram
        # (Bellet et al. use cliques of size n_classes)
        clique_size = min(K, max(2, C))
    n_cliques = max(1, int(np.ceil(K / clique_size)))
    glob = label_hist.sum(axis=0) / max(label_hist.sum(), 1)

    rng = np.random.default_rng(seed)
    sizes = [K // n_cliques + (c < K % n_cliques)
             for c in range(n_cliques)]
    remaining = list(rng.permutation(K))
    cliques: List[List[int]] = []
    for size in sizes:
        cq: List[int] = []
        s = np.zeros(C)
        while len(cq) < size and remaining:
            def tv_with(k):
                t = s + label_hist[k]
                return 0.5 * np.abs(t / max(t.sum(), 1) - glob).sum()
            k = min(remaining, key=tv_with)
            cq.append(k)
            s += label_hist[k]
            remaining.remove(k)
        if cq:
            cliques.append(sorted(int(k) for k in cq))
    return cliques


def d_cliques(label_hist: np.ndarray, clique_size: Optional[int] = None,
              seed: int = 0,
              cliques: Optional[List[List[int]]] = None) -> Topology:
    """Label-aware D-Cliques (Bellet et al., 2021).

    ``label_hist``: (K, C) per-node label counts.  Nodes are greedily
    grouped into cliques of ~``clique_size`` so each clique's aggregate
    label distribution tracks the global one; cliques are LAN-connected
    internally and joined by a WAN ring of inter-clique edges.
    ``cliques`` overrides the greedy assignment with a precomputed one
    (:func:`greedy_clique_assignment`).
    """
    K = label_hist.shape[0]
    if cliques is None:
        cliques = greedy_clique_assignment(label_hist, clique_size, seed)

    edges, cls = [], []
    for cq in cliques:
        for a in range(len(cq)):
            for b in range(a + 1, len(cq)):
                edges.append((cq[a], cq[b]))
                cls.append("lan")
    for c in range(len(cliques)):       # inter-clique ring (WAN)
        if len(cliques) > 1:
            nxt = cliques[(c + 1) % len(cliques)]
            edges.append((cliques[c][0], nxt[0]))
            cls.append("wan")
    ec = {(min(i, j), max(i, j)): c for (i, j), c in zip(edges, cls)}
    edges = _canonical(edges)
    return _build("dcliques", K, edges, [ec[e] for e in edges],
                  cliques=cliques)


# ---------------------------------------------------------------------------
# schedules: one graph per round
# ---------------------------------------------------------------------------

class TopologySchedule:
    """A periodic sequence of communication graphs over one node set.

    ``at(t)`` is round ``t``'s graph; gossip, the ledger, and SkewScout
    all consume schedules, with a single frozen graph as the trivial
    constant schedule.  Per-round graphs may be disconnected (matchings
    usually are) — consensus only needs the *union* over one period to
    be connected, which is asserted here.
    """

    def __init__(self, name: str, graphs: Sequence[Topology]):
        assert graphs, "schedule needs at least one graph"
        K = graphs[0].n_nodes
        assert all(g.n_nodes == K for g in graphs), \
            "all graphs in a schedule must share the node set"
        self.name = name
        self._graphs = tuple(graphs)
        self._union: Optional[Topology] = None
        self._round_gaps: Dict[int, float] = {}
        if K > 1:
            union_edges = sorted({e for g in graphs for e in g.edges})
            assert _connected(K, union_edges), \
                f"{name}: union over one period is not connected"

    # ---- structure ----
    @property
    def n_nodes(self) -> int:
        return self._graphs[0].n_nodes

    @property
    def period(self) -> int:
        return len(self._graphs)

    @property
    def is_constant(self) -> bool:
        return len(self._graphs) == 1

    def at(self, t: int) -> Topology:
        return self._graphs[int(t) % len(self._graphs)]

    def graphs(self) -> Tuple[Topology, ...]:
        """The unique per-round graphs of one period."""
        return self._graphs

    @property
    def max_degree(self) -> int:
        """Max degree over the whole period — the kernel padding width
        that keeps every round's operands one shape."""
        return max(g.max_degree for g in self._graphs)

    def mean_round_edges(self) -> float:
        """Mean active edges per round — the communication-cost metric
        that orders SkewScout's topology ladder (densest first)."""
        return float(np.mean([len(g.edges) for g in self._graphs]))

    def union(self) -> Topology:
        """Union graph over one period: the set of links that exist at
        all.  The ledger prices re-wiring against it and SkewScout's CM
        (one full-model exchange) is defined on it.  An edge is WAN if
        any round classifies it WAN."""
        if self._union is None:
            cls: Dict[Edge, str] = {}
            cliques: Tuple[Tuple[int, ...], ...] = ()
            for g in self._graphs:
                if g.cliques and not cliques:
                    cliques = g.cliques
                for e, c in zip(g.edges, g.edge_class):
                    if c == "wan" or e not in cls:
                        cls[e] = c
            edges = sorted(cls)
            self._union = _build(f"{self.name}:union", self.n_nodes,
                                 edges, [cls[e] for e in edges],
                                 cliques=cliques,
                                 require_connected=self.n_nodes > 1)
        return self._union

    # ---- kernel-facing layout ----
    def neighbor_arrays(self, t: int, pad_degree: Optional[int] = None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Round ``t``'s padded neighbor operands, padded to the
        schedule-wide max degree by default (one shape, no retrace)."""
        pad = self.max_degree if pad_degree is None else pad_degree
        return self.at(t).neighbor_arrays(pad_degree=pad)

    # ---- spectral ----
    def round_spectral_gap(self, t: int) -> float:
        """Spectral gap of round ``t``'s graph alone (0 for matchings —
        a single disconnected round does not mix to consensus)."""
        i = int(t) % len(self._graphs)
        if i not in self._round_gaps:
            self._round_gaps[i] = self._graphs[i].spectral_gap()
        return self._round_gaps[i]

    def spectral_gap(self) -> float:
        """Effective per-round gap of one period: the consensus error
        contracts by the spectral radius of ``prod_t (W_t - J)`` per
        period (J = 11^T/K), so the per-round rate is its period-th
        root.  Reduces exactly to ``1 - |lambda_2(W)|`` for a constant
        schedule."""
        K = self.n_nodes
        if K == 1:
            return 1.0
        J = np.full((K, K), 1.0 / K)
        M = np.eye(K)
        for g in self._graphs:
            assert g.mixing is not None, \
                f"{g.name}: no mixing matrix (ledger-only fabric past " \
                f"{MIXING_AUTO_MAX} nodes)"
            M = (g.mixing - J) @ M
        rate = float(np.max(np.abs(np.linalg.eigvals(M))))
        return 1.0 - rate ** (1.0 / self.period)


def constant_schedule(topology: Topology) -> TopologySchedule:
    """The one-graph-per-run path, expressed as a schedule."""
    return TopologySchedule(topology.name, [topology])


def as_schedule(fabric: Union[Topology, TopologySchedule]
                ) -> TopologySchedule:
    if isinstance(fabric, TopologySchedule):
        return fabric
    assert isinstance(fabric, Topology), type(fabric)
    return constant_schedule(fabric)


def _round_robin_matching(members: Sequence[int], r: int
                          ) -> List[Edge]:
    """Round ``r`` of the circle-method round robin over ``members``:
    a (near-)perfect matching; over ``m-1`` rounds (m even, one bye
    added when odd) every pair meets exactly once."""
    m = list(members)
    if len(m) % 2:
        m.append(-1)                      # bye
    n = len(m)
    if n < 2:
        return []
    k = r % (n - 1)
    rest = m[1:]
    arr = [m[0]] + rest[k:] + rest[:k]
    return [(arr[i], arr[n - 1 - i]) for i in range(n // 2)
            if arr[i] >= 0 and arr[n - 1 - i] >= 0]


def time_varying_d_cliques(label_hist: np.ndarray,
                           clique_size: Optional[int] = None,
                           seed: int = 0,
                           cliques: Optional[List[List[int]]] = None
                           ) -> TopologySchedule:
    """One-peer-per-round D-Cliques (Bellet et al., 2021, §time-varying).

    Same greedy label-balanced cliques as :func:`d_cliques`, but each
    round every node talks to *one* clique peer (round-robin matching
    inside the clique) and a *single* rotating WAN edge joins
    consecutive cliques — instead of the constant variant's full
    intra-clique mesh plus one WAN edge per clique, every round.  Over
    one period the union covers the whole constant graph, so the mixing
    rate survives while per-round traffic (and especially per-round WAN
    traffic) drops by the clique size.  Both variants share
    :func:`greedy_clique_assignment` (same ``seed`` => same cliques);
    ``cliques`` passes a precomputed assignment explicitly.
    """
    K = label_hist.shape[0]
    if cliques is None:
        cliques = greedy_clique_assignment(label_hist, clique_size, seed)
    n_cl = len(cliques)
    # period: lcm of the per-clique round-robin cycles and the WAN ring
    # rotation, so the union over one period is the full constant graph
    period = 1
    for cq in cliques:
        m = len(cq) + (len(cq) % 2)
        period = math.lcm(period, max(m - 1, 1))
    if n_cl > 1:
        period = math.lcm(period, n_cl)
    graphs = []
    for r in range(period):
        edges: List[Edge] = []
        cls: List[str] = []
        for cq in cliques:
            for a, b in _round_robin_matching(cq, r):
                edges.append((a, b))
                cls.append("lan")
        if n_cl > 1:
            c = r % n_cl
            nxt = cliques[(c + 1) % n_cl]
            edges.append((cliques[c][0], nxt[0]))
            cls.append("wan")
        ec = {(min(i, j), max(i, j)): c for (i, j), c in zip(edges, cls)}
        edges = _canonical(edges)
        graphs.append(_build(f"tv-dcliques[{r}]", K, edges,
                             [ec[e] for e in edges], cliques=cliques,
                             require_connected=False))
    return TopologySchedule("tv-dcliques", graphs)


def random_matching_schedule(n_nodes: int, period: Optional[int] = None,
                             seed: int = 0,
                             n_sites: Optional[int] = None
                             ) -> TopologySchedule:
    """EquiTopo-style schedule: an independent random (near-)perfect
    matching each round — degree <= 1 per round, expander-grade mixing
    from the randomness across rounds.  The period is resampled until
    the union is connected (whp after O(log K) matchings).

    ``n_sites``: nodes live in datacenters (the same ``d::n_sites``
    grouping and sqrt-K default as :func:`hierarchical`), and an edge
    crossing sites is WAN.  Random matchings are placement-blind, so
    most of their edges cross sites — the honest geo-WAN price of the
    fabric, and exactly what locality-aware D-Cliques avoid.  Pass
    ``n_sites=1`` for a single-LAN cluster."""
    if period is None:
        period = max(4, 2 * int(np.ceil(np.log2(max(n_nodes, 2)))))
    if n_sites is None:
        n_sites = min(max(2, int(round(np.sqrt(n_nodes)))), n_nodes)
    site = {k: k % n_sites for k in range(n_nodes)}

    def build_round(r, edges):
        cls = ["wan" if site[i] != site[j] else "lan" for i, j in edges]
        return _build(f"random-matching[{r}]", n_nodes, edges, cls,
                      require_connected=False)

    rng = np.random.default_rng(seed)
    for _ in range(200):
        graphs = []
        for r in range(period):
            perm = rng.permutation(n_nodes)
            edges = _canonical([(int(perm[2 * i]), int(perm[2 * i + 1]))
                                for i in range(n_nodes // 2)])
            graphs.append(build_round(r, edges))
        union = sorted({e for g in graphs for e in g.edges})
        if n_nodes == 1 or _connected(n_nodes, union):
            return TopologySchedule("random-matching", graphs)
    # degenerate tiny-K case: splice in a ring round to force connectivity
    graphs[-1] = build_round(period - 1,
                             _canonical(ring(n_nodes).edges))
    return TopologySchedule("random-matching", graphs)


def topology_ladder(n_nodes: int, label_hist: Optional[np.ndarray] = None,
                    seed: int = 0, time_varying: bool = True
                    ) -> List[TopologySchedule]:
    """SkewScout's topology rungs: full, hierarchical, (tv-)dcliques,
    ring — *sorted* most-communication-heavy -> most relaxed by mean
    per-round edge count (the THETA_LADDERS convention).  Sorting
    matters: hill climbing needs the ladder monotone in cost, and a
    time-varying D-Cliques rung is cheaper per round than a ring, not
    between hierarchical and ring.  Without label histograms the
    label-aware rung degrades to a torus."""
    rungs = [constant_schedule(fully_connected(n_nodes)),
             constant_schedule(hierarchical(n_nodes))]
    if label_hist is not None:
        rungs.append(time_varying_d_cliques(label_hist, seed=seed)
                     if time_varying
                     else constant_schedule(d_cliques(label_hist,
                                                      seed=seed)))
    else:
        rungs.append(constant_schedule(torus(n_nodes)))
    rungs.append(constant_schedule(ring(n_nodes)))
    rungs.sort(key=TopologySchedule.mean_round_edges, reverse=True)
    # small-K builders can collapse (torus(<4) is a ring): drop duplicates
    seen, out = set(), []
    for s in rungs:
        if s.name not in seen:
            seen.add(s.name)
            out.append(s)
    return out


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def build_topology(name: str, n_nodes: int, *,
                   label_hist: Optional[np.ndarray] = None,
                   seed: int = 0, **kw) -> Topology:
    """Topology factory keyed by ``CommConfig.topology``."""
    if name in ("full", "fully_connected", "clique"):
        return fully_connected(n_nodes)
    if name == "ring":
        return ring(n_nodes)
    if name == "torus":
        return torus(n_nodes, **kw)
    if name in ("random", "expander"):
        deg = kw.pop("degree", min(4, n_nodes - 1))
        if (n_nodes * deg) % 2:
            deg = max(2, deg - 1)
        return random_regular(n_nodes, deg, seed=seed)
    if name in ("geo-wan", "hierarchical"):
        return hierarchical(n_nodes, **kw)
    if name in ("hier-cliques", "hierarchical-cliques"):
        return hierarchical_cliques(n_nodes, **kw)
    if name in ("dcliques", "d-cliques"):
        assert label_hist is not None, \
            "dcliques topology needs per-node label histograms"
        return d_cliques(label_hist, seed=seed, **kw)
    raise ValueError(f"unknown topology {name!r}")


#: topology names that require per-node label histograms to build
LABEL_AWARE_TOPOLOGIES = ("dcliques", "d-cliques", "tv-dcliques",
                          "time-varying-dcliques")


def full_skew_label_hist(n_nodes: int,
                         n_classes: Optional[int] = None) -> np.ndarray:
    """Synthetic (K, C) per-node label histogram for the paper's
    *full-skew* setting — each node holds one label exclusively.  What
    compile-only dry-runs and demo drivers feed the label-aware builders
    when no real partition exists to derive histograms from."""
    if n_classes is None:
        n_classes = max(2, n_nodes)
    hist = np.zeros((n_nodes, n_classes))
    hist[np.arange(n_nodes), np.arange(n_nodes) % n_classes] = 100
    return hist


def build_demo_schedule(name: str, n_nodes: int,
                        seed: int = 0) -> "TopologySchedule":
    """:func:`build_schedule` with the full-skew synthetic histogram
    supplied automatically for label-aware fabrics — the one import-safe
    home for compile-only dry-runs and demo drivers that have no real
    partition to derive histograms from."""
    label_hist = (full_skew_label_hist(n_nodes)
                  if name in LABEL_AWARE_TOPOLOGIES else None)
    return build_schedule(name, n_nodes, label_hist=label_hist, seed=seed)


def build_schedule(name: str, n_nodes: int, *,
                   label_hist: Optional[np.ndarray] = None,
                   seed: int = 0, **kw) -> TopologySchedule:
    """Schedule factory keyed by ``CommConfig.topology``: every static
    topology name becomes its constant schedule; ``tv-dcliques`` and
    ``random-matching`` are the time-varying builders."""
    if name in ("tv-dcliques", "time-varying-dcliques"):
        assert label_hist is not None, \
            "tv-dcliques schedule needs per-node label histograms"
        return time_varying_d_cliques(label_hist, seed=seed, **kw)
    if name in ("random-matching", "equitopo"):
        return random_matching_schedule(n_nodes, seed=seed, **kw)
    return constant_schedule(build_topology(name, n_nodes,
                                            label_hist=label_hist,
                                            seed=seed, **kw))
