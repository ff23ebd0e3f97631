"""Stochastic heterogeneous links + per-round client participation.

``LinkProfile`` prices every link of a class (lan | wan) from two
constants, which makes AD-PSGD's headline advantage unmeasurable: the
async ledger only wins when *different* links bottleneck different
rounds, and with class constants the same WAN edge is the bottleneck
forever.  :class:`LinkModel` replaces the constants with a seeded,
replayable sampler with three layers of structure:

*Per-edge base draws* (``hetero``): each link draws a persistent
latency/bandwidth multiplier once, lognormal with sigma ``hetero``
around the class constants — some links are just slower than others,
forever.  At ``hetero=0`` every link's base equals the class constants.

*Per-activation jitter* (``jitter``): every activation multiplies the
link's cost by an independent median-1 lognormal, ``exp(jitter * z)``
with ``z ~ N(0,1)`` — latency is multiplied, bandwidth divided, so the
whole edge cost scales by the draw.

*Markov transient slowdowns* (``straggler_rate``): each link carries a
two-state chain (normal <-> slow).  A normal link enters the slow state
with probability ``straggler_rate`` per activation and leaves it with
probability ``straggler_exit``; while slow, latency is multiplied and
bandwidth divided by ``straggler_slowdown``.  Bursty, *occasional*
stragglers — the regime where async gossip strictly beats stop-and-wait
even on an all-LAN fabric (Lian et al., AD-PSGD).

Seeding and replay: every draw is a pure function of
``(seed, edge, activation index)`` — a counter-based hash stream from
``kernels/rng.py`` (the lowbias32 stream of ``repro.kernels.rng``, bit
for bit), evaluated vectorized over all of a round's active
edges at once.  Activation ``n`` of an edge owns uniform counters
``[4n, 4n+4)`` on that edge's round stream: the jitter normal consumes
``4n``/``4n+1`` (Box–Muller), the Markov transition uniform is ``4n+2``,
and ``4n+3`` is reserved.  A rebuilt model (same seed) replaying the
same sequence of ledger calls therefore produces bit-identical sampled
times, in any interleaving of edges; the Markov state is a fold over the
keyed draws, so it replays too.  With all three knobs at zero,
:meth:`LinkModel.sample` returns the class-constant arrays unchanged
(bitwise), which is what lets a "sampled" ledger at zero rates reproduce
the constant-profile ledger exactly.

Array layout (the 10k-node redesign): per-link state — stream key, base
multipliers, draw counter, Markov bit — lives in flat arrays indexed by
a slot id; an edge list is resolved to its slot array once (cached per
edge-tuple object) and every later activation is pure gather/scatter.
Slot admission keys whole edge sets in one :func:`rng.fold_keys` batch,
bit-equal to the retired per-edge ``fold_key`` loop.

:class:`Participation` is the client-sampling analogue: a seeded
per-round Bernoulli node mask (tag-disjoint from both link streams, so
toggling sampling can never perturb link draws and vice versa).  The
ledger prices only edges whose endpoints both participate; dpsgd/adpsgd
zero the corresponding mixing weights; SkewScout probes route around
absent nodes.

Consumed by :class:`~repro_torch.topology.costs.CommLedger` (``link_model=`` /
``participation=``): gossip, exchange, and probe rounds all price
sampled per-edge times, and the ledger folds each observation into
per-edge EWMA *measured* costs that SkewScout's C(θ)/CM pricing reads in
place of profile constants.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import LinkConfig
from repro_torch.kernels import rng
from repro_torch.topology.costs import LinkProfile

Edge = Tuple[int, int]

# draw-key tags: keep the per-edge base stream, the per-activation
# stream, and the participation stream disjoint (all keyed under one
# model seed)
_TAG_BASE = 0x0B
_TAG_ROUND = 0x0A
_TAG_PART = 0x0C


class LinkModel:
    """Seeded per-link latency/bandwidth sampler (see module docstring).

    ``sample`` maps a graph's per-edge class-constant (latency,
    bandwidth) arrays to sampled arrays for one activation, advancing
    each active edge's draw counter and Markov state — all flat-array
    gather/scatter after the edge set's one-time slot admission.
    """

    def __init__(self, profile: LinkProfile, *, seed: int = 0,
                 jitter: float = 0.0, hetero: float = 0.0,
                 straggler_rate: float = 0.0, straggler_exit: float = 0.5,
                 straggler_slowdown: float = 10.0):
        assert jitter >= 0 and hetero >= 0, (jitter, hetero)
        assert 0.0 <= straggler_rate <= 1.0, straggler_rate
        assert 0.0 < straggler_exit <= 1.0, straggler_exit
        assert straggler_slowdown >= 1.0, straggler_slowdown
        self.profile = profile
        self.seed = int(seed)
        self.jitter = float(jitter)
        self.hetero = float(hetero)
        self.straggler_rate = float(straggler_rate)
        self.straggler_exit = float(straggler_exit)
        self.straggler_slowdown = float(straggler_slowdown)
        # per-link state, slot-indexed flat arrays
        self._slot: Dict[Edge, int] = {}
        self._key = np.zeros(0, np.uint32)   # round-stream keys
        self._lat_mult = np.ones(0)          # persistent base draws
        self._bw_mult = np.ones(0)
        self._n = np.zeros(0, np.int64)      # activations (draw counter)
        self._slow = np.zeros(0, bool)       # Markov slow state
        # edge-tuple object -> its slot index array (the per-graph cache)
        self._slots_cache: Dict[int, tuple] = {}
        # counters for the trainer's straggler/jitter extras
        self.activations = 0
        self.slow_activations = 0

    @property
    def stochastic(self) -> bool:
        """False when every knob is zero — sampling is the identity and
        the hot path can skip the per-edge draws entirely."""
        return (self.jitter > 0 or self.hetero > 0
                or self.straggler_rate > 0)

    # ---- slot admission ----
    def _admit(self, edges: Sequence[Edge]) -> None:
        """Create slots for unseen edges, keying and base-drawing the
        whole batch in one vectorized pass (bit-equal to the per-edge
        scalar ``fold_key``/``normal01`` calls it replaces)."""
        start = len(self._key)
        for k, e in enumerate(edges):
            self._slot[e] = start + k
        ii = np.asarray([i for i, _ in edges], np.int64)
        jj = np.asarray([j for _, j in edges], np.int64)
        key = rng.fold_keys(rng.fold_key(self.seed, _TAG_ROUND), ii, jj)
        n = len(edges)
        if self.hetero > 0:
            base = rng.fold_keys(rng.fold_key(self.seed, _TAG_BASE),
                                 ii, jj)
            z0 = rng.normal01(base, np.zeros(n, np.int64))
            z1 = rng.normal01(base, np.ones(n, np.int64))
            lat_mult = np.exp(self.hetero * z0)
            bw_mult = np.exp(-self.hetero * z1)
        else:
            lat_mult = np.ones(n)
            bw_mult = np.ones(n)
        self._key = np.concatenate([self._key, key.astype(np.uint32)])
        self._lat_mult = np.concatenate([self._lat_mult, lat_mult])
        self._bw_mult = np.concatenate([self._bw_mult, bw_mult])
        self._n = np.concatenate([self._n, np.zeros(n, np.int64)])
        self._slow = np.concatenate([self._slow, np.zeros(n, bool)])

    def _slots_for(self, edges: Sequence[Edge]) -> np.ndarray:
        """Slot index array for ``edges``, cached per edge-tuple object
        (graphs are long-lived; the cache keeps a reference so the id
        key cannot be recycled)."""
        ent = self._slots_cache.get(id(edges))
        if ent is not None and ent[0] is edges:
            return ent[1]
        miss = [e for e in edges if e not in self._slot]
        if miss:
            self._admit(miss)
        slots = np.fromiter((self._slot[e] for e in edges), np.int64,
                            len(edges))
        self._slots_cache[id(edges)] = (edges, slots)
        return slots

    def sample(self, edges: Sequence[Edge], lat: np.ndarray,
               bw: np.ndarray, active: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Sampled (latency, bandwidth) arrays for one activation of the
        ``active`` edges, starting from the graph's class-constant
        arrays.  Inactive edges keep the constants (their cost is masked
        by the caller anyway) and do not advance their counters.

        All active edges draw in one vectorized hash evaluation: keys
        and counters are gathered from the slot arrays, the jitter
        normals and Markov uniforms come from one ``kernels/rng.py``
        batch each, and the state write-back is a scatter."""
        if not self.stochastic:
            return lat, bw
        s_lat = lat.astype(np.float64).copy()
        s_bw = bw.astype(np.float64).copy()
        idx = np.flatnonzero(active)
        if idx.size == 0:
            return s_lat, s_bw
        sl = self._slots_for(edges)[idx]
        keys = self._key[sl]
        ctr = self._n[sl]
        # activation n owns uniform counters [4n, 4n+4) on the edge's
        # round stream: Box-Muller jitter at 4n/4n+1, Markov u at 4n+2
        mult = np.ones(idx.size, np.float64)
        if self.jitter > 0:
            z = rng.normal01(keys, 2 * ctr)
            mult *= np.exp(self.jitter * z)
        if self.straggler_rate > 0:
            u = rng.uniform01(keys, (4 * ctr + 2).astype(np.uint32)
                              ).astype(np.float64)
            slow = self._slow[sl]
            mult = np.where(slow, mult * self.straggler_slowdown, mult)
            self.slow_activations += int(np.sum(slow))
            next_slow = np.where(slow, u >= self.straggler_exit,
                                 u < self.straggler_rate)
        else:
            next_slow = self._slow[sl]
        self.activations += idx.size
        self._n[sl] = ctr + 1
        self._slow[sl] = next_slow
        s_lat[idx] = lat[idx] * self._lat_mult[sl] * mult
        s_bw[idx] = bw[idx] * self._bw_mult[sl] / mult
        return s_lat, s_bw

    # ---- reporting ----
    def slow_fraction(self) -> float:
        """Fraction of activations that hit a straggler's slow state."""
        return self.slow_activations / max(self.activations, 1)

    def summary(self) -> Dict[str, float]:
        return dict(jitter=self.jitter, hetero=self.hetero,
                    straggler_rate=self.straggler_rate,
                    straggler_slowdown=self.straggler_slowdown,
                    activations=float(self.activations),
                    slow_activations=float(self.slow_activations),
                    slow_fraction=self.slow_fraction())


class Participation:
    """Seeded per-round client sampling: round ``t``'s Bernoulli node
    mask is a pure function of ``(seed, t)`` on its own tag-disjoint
    hash stream — replayable, order-independent, and isolated from the
    link model's draws (toggling one can never shift the other).

    Semantics: a masked-out node skips the round's *communication* only
    (local updates continue); an edge is active iff both endpoints
    participate.  ``fraction=1.0`` is the exact pre-sampling behaviour
    (all-true masks).  Masks are cached (read by the ledger, the mixing
    operands, and SkewScout in the same round) and frozen read-only."""

    def __init__(self, n_nodes: int, fraction: float, *, seed: int = 0):
        assert 0.0 < float(fraction) <= 1.0, fraction
        self.n_nodes = int(n_nodes)
        self.fraction = float(fraction)
        self.seed = int(seed)
        self._cache: Dict[int, np.ndarray] = {}

    def mask(self, t) -> np.ndarray:
        """Boolean (n_nodes,) participant mask for round ``t``."""
        t = int(t)
        m = self._cache.get(t)
        if m is None:
            if self.fraction >= 1.0:
                m = np.ones(self.n_nodes, bool)
            else:
                key = np.uint32(rng.fold_key(self.seed, _TAG_PART, t))
                u = rng.uniform01(key, np.arange(self.n_nodes,
                                                 dtype=np.uint32))
                m = np.asarray(u < np.float32(self.fraction))
            m.flags.writeable = False
            if len(self._cache) >= 16:
                self._cache.pop(next(iter(self._cache)))
            self._cache[t] = m
        return m

    def summary(self) -> Dict[str, float]:
        return dict(fraction=self.fraction, n_nodes=float(self.n_nodes))


def make_link_model(link: LinkConfig, profile: LinkProfile, *,
                    seed: int = 0) -> Optional[LinkModel]:
    """Build the :class:`LinkModel` a :class:`LinkConfig` asks for
    (``None`` for the constant-profile ledger).  The model draws from
    its own keyed streams, so the link seed can never perturb anything
    else seeded from the run seed (clique assignment, data order, init)."""
    assert isinstance(link, LinkConfig), link
    if link.model == "constant":
        return None
    if link.model != "sampled":
        raise ValueError(
            f"unknown link_model {link.model!r} (constant | sampled)")
    return LinkModel(profile, seed=seed, jitter=link.jitter,
                     hetero=link.hetero,
                     straggler_rate=link.straggler_rate,
                     straggler_exit=link.straggler_exit,
                     straggler_slowdown=link.straggler_slowdown)
