"""Fabric-ledger parity: the port's ``repro_torch.topology`` against the
reference's ``repro.topology``.

Each case builds the same fabric with each package's own builders, drives
both ledgers through the same calls and compares everything they report
exactly (``np.testing.assert_equal``: floats bit for bit, NaN equal to
NaN):

* the 11 scenario shapes of ``tests/test_fabric_scale.py`` (``SCENARIOS``):
  sync/async, constant and sampled links, stragglers, probes, schedule
  rotation, mid-run switches, re-wiring floats and amortized handshakes;
* participation masks, ``hierarchical_cliques`` at 10k nodes, and the
  scale smoke's rows (``fig_topology.smoke_scale``) but for host timings;
* the behaviour ``tests/test_links.py`` asserts: seeded per-edge link
  draws, the zero-rate and constant ledgers, the straggler chain firing
  at the same activations, amortized and forfeited handshakes, EWMA
  measured costs, SkewScout's C(θ) numerator and CM denominator, clique
  assignment, the link-model registry and the summary's fields.

NumPy only on both sides; nothing here trains the reference's model.
"""
import dataclasses
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import repro.configs.base as jax_configs
import repro.core.skewscout as jax_skewscout
import repro.topology as jax_topology
import repro.topology.graphs as jax_graphs
import repro_torch.configs.base as configs
import repro_torch.core.skewscout as skewscout
import repro_torch.topology as topology
import repro_torch.topology.graphs as graphs

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import test_fabric_scale  # noqa: E402

#: each package as the cases see it: its topology module, graph module,
#: configs and SkewScout
REF = SimpleNamespace(T=jax_topology, G=jax_graphs, C=jax_configs,
                      S=jax_skewscout.SkewScout)
PORT = SimpleNamespace(T=topology, G=graphs, C=configs,
                       S=skewscout.SkewScout)


def exclusive_hist(n_nodes: int, n_classes: int) -> np.ndarray:
    hist = np.zeros((n_nodes, n_classes))
    for k in range(n_nodes):
        hist[k, k % n_classes] = 100
    return hist


def ring_plus(P, n: int, extra, cls: str):
    """``ring(n)`` plus one extra edge of the given link class, built by
    package ``P``."""
    cls_map = {e: "lan" for e in P.T.ring(n).edges}
    cls_map[(min(extra), max(extra))] = cls
    edges = sorted(cls_map)
    return P.G._build(f"ring+{cls}", n, edges, [cls_map[e] for e in edges])


def tv9(P):
    return P.T.time_varying_d_cliques(exclusive_hist(9, 3), seed=0)


def view_numbers(led):
    """Everything a ledger reports through its summary and its view."""
    v = led.view()
    edges = led.topology.edges
    classes = led.topology.edge_class
    return {
        "summary": led.summary(),
        "sim_time_s": v.sim_time_s, "lan": v.lan_floats,
        "wan": v.wan_floats, "total": v.total_floats,
        "priced": v.priced_cost, "sampled": v.sampled_priced_cost,
        "window": v.window_cost, "rewire_floats": v.rewire_floats,
        "rewiring_cost": v.rewiring_cost, "rewire_events": v.rewire_events,
        "rewire_time_s": v.rewire_time_s,
        "pending": v.pending_handshake_s, "skew": v.clock_skew_s,
        "rounds": v.rounds, "edge_clocks": v.edge_clock_map(),
        "traffic": v.traffic_map(), "busy": v.node_busy_s,
        "clock": v.node_clock, "idle": v.node_idle_s,
        "measured": [(v.measured_latency_s(e, c),
                      v.measured_price_per_float(e, c))
                     for e, c in zip(edges, classes)],
        "full": [f(1234.0) for f in (
            v.full_exchange_cost, v.full_exchange_time,
            v.measured_full_exchange_cost, v.measured_full_exchange_time,
            v.cm_denominator)],
    }


# ---------------------------------------------------------------------------
# the scenarios of tests/test_fabric_scale.py
# ---------------------------------------------------------------------------

def _thrash():
    return [(t, (lambda P: ring_plus(P, 6, (0, 3), "wan")) if t % 2
             else (lambda P: P.T.ring(6))) for t in range(1, 9)]


#: ``test_fabric_scale.SCENARIOS`` with each fabric (and switch target) a
#: function of the package that builds it
SCENARIOS = {
    "sync-tv-rewire": dict(fabric=tv9, rewire=32.0, probe=True,
                           exchange=True, rounds=12),
    "async-tv-stale": dict(fabric=tv9, rewire=32.0, probe=True,
                           exchange=True, rounds=12, staleness=2,
                           **{"async": True}),
    "sync-hier": dict(fabric=lambda P: P.T.hierarchical(6), rounds=10,
                      exchange=True),
    "async-hier": dict(fabric=lambda P: P.T.hierarchical(6), rounds=10,
                       staleness=1, **{"async": True}),
    "sync-sampled": dict(
        fabric=lambda P: P.T.ring(8), profile="datacenter", rounds=40,
        link=dict(seed=3, jitter=0.3, hetero=0.2, straggler_rate=0.1,
                  straggler_exit=0.4, straggler_slowdown=25.0),
        ewma_alpha=0.05, exchange=True),
    "async-sampled": dict(
        fabric=lambda P: P.T.ring(8), profile="datacenter", rounds=40,
        link=dict(seed=7, jitter=0.3, straggler_rate=0.1,
                  straggler_slowdown=25.0),
        staleness=2, probe=True, **{"async": True}),
    "async-sampled-tv": dict(
        fabric=tv9, rounds=18,
        link=dict(seed=5, jitter=0.2, straggler_rate=0.05),
        staleness=1, exchange=True, **{"async": True}),
    "amortize-w4": dict(
        fabric=lambda P: P.T.ring(6), rounds=10, window=4, rewire=16.0,
        switch=[(1, lambda P: ring_plus(P, 6, (0, 3), "wan"))]),
    "thrash-w4": dict(fabric=lambda P: P.T.ring(6), rounds=9, window=4,
                      rewire=16.0, switch=_thrash()),
    "thrash-w4-async": dict(fabric=lambda P: P.T.ring(6), rounds=9,
                            window=4, rewire=16.0, staleness=1,
                            switch=_thrash(), **{"async": True}),
    "switch-dense": dict(
        fabric=tv9, rounds=8, rewire=50.0, probe=True,
        switch=[(4, lambda P: P.T.fully_connected(9))]),
}


def _same_graph(a, b):
    """Two fabrics (graph or schedule) with the same rounds' edges and
    link classes."""
    a, b = jax_topology.as_schedule(a), jax_topology.as_schedule(b)
    assert a.period == b.period
    for t in range(a.period):
        assert a.at(t).edges == b.at(t).edges
        assert list(a.at(t).edge_class) == list(b.at(t).edge_class)


@pytest.mark.parametrize("name", sorted(test_fabric_scale.SCENARIOS))
def test_scenarios_are_the_reference_suites(name):
    """This table is ``test_fabric_scale.SCENARIOS``: the same names and
    knobs, and each fabric, built by the reference, the suite's own."""
    ours, theirs = SCENARIOS[name], test_fabric_scale.SCENARIOS[name]
    assert set(ours) == set(theirs)
    for key in set(ours) - {"fabric", "switch"}:
        assert ours[key] == theirs[key], key
    _same_graph(ours["fabric"](REF), theirs["fabric"]())
    assert [t for t, _ in ours.get("switch", [])] == \
        [t for t, _ in theirs.get("switch", [])]
    for (_, mine), (_, ref) in zip(ours.get("switch", []),
                                   theirs.get("switch", [])):
        _same_graph(mine(REF), ref())


def _scenario_ledger(P, scn):
    prof = P.T.LINK_PROFILES[scn.get("profile", "geo-wan")]
    lk = scn.get("link")
    return P.T.CommLedger(
        scn["fabric"](P), prof, async_mode=scn.get("async", False),
        link_model=P.T.LinkModel(prof, **lk) if lk else None,
        config=P.C.FabricConfig(rewire_floats=scn.get("rewire", 0.0),
                                amortize_window=scn.get("window", 1)),
        ewma_alpha=scn.get("ewma_alpha", 0.1))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_ledgers_equal(name):
    """Both ledgers, driven round by round through the scenario (gossip,
    exchanges, probes, switches), report the same numbers every fifth
    round and at the end."""
    scn = SCENARIOS[name]
    pair = [(P, _scenario_ledger(P, scn)) for P in (REF, PORT)]
    switches = dict(scn.get("switch", []))
    for t in range(scn["rounds"]):
        for P, led in pair:
            if t in switches:
                led.switch_schedule(switches[t](P))
            led.record_gossip(1000.0, t=t, staleness=scn.get("staleness"))
            if scn.get("exchange"):
                led.record_exchange(40.0)
            if scn.get("probe"):
                led.record_probe([led.topology.edges[
                    t % len(led.topology.edges)]], 25.0)
        if t % 5 == 0:
            np.testing.assert_equal(view_numbers(pair[1][1]),
                                    view_numbers(pair[0][1]))
    np.testing.assert_equal(view_numbers(pair[1][1]),
                            view_numbers(pair[0][1]))


# ---------------------------------------------------------------------------
# participation, the 10k-node builder, the scale smoke
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,fraction,seed", [(64, 0.3, 9), (64, 0.3, 10),
                                             (16, 1.0, 0), (64, 0.25, 1),
                                             (10_000, 0.1, 0)])
def test_participation_masks_equal(n, fraction, seed):
    mine = topology.Participation(n, fraction, seed=seed)
    theirs = jax_topology.Participation(n, fraction, seed=seed)
    for t in range(50):
        np.testing.assert_array_equal(mine.mask(t), theirs.mask(t))


def _participation_case(P, case):
    prof = P.T.LINK_PROFILES
    if case == "fraction-one":
        out = []
        for part in (None, P.T.Participation(9, 1.0, seed=4)):
            led = P.T.CommLedger(tv9(P), prof["geo-wan"], async_mode=True,
                                 participation=part)
            for t in range(12):
                led.record_gossip(500.0, t=t, staleness=1)
            out.append(view_numbers(led))
        return out
    if case == "half":
        led = P.T.CommLedger(P.T.ring(8), prof["uniform"],
                             participation=P.T.Participation(8, 0.5, seed=2))
        for t in range(20):
            led.record_gossip(100.0, t=t)
        return view_numbers(led)
    # the mask stream drawn between rounds leaves the link draws alone
    out = []
    for interleave in (False, True):
        lm = P.T.LinkModel(prof["datacenter"], seed=6, jitter=0.4,
                           straggler_rate=0.2)
        led = P.T.CommLedger(P.T.ring(8), prof["datacenter"], link_model=lm)
        p = P.T.Participation(8, 0.5, seed=6)
        for t in range(30):
            if interleave:
                p.mask(t)
            led.record_gossip(1e4, t=t)
        out.append(view_numbers(led))
    return out


@pytest.mark.parametrize("case", ["fraction-one", "half", "interleaved"])
def test_participation_ledgers_equal(case):
    np.testing.assert_equal(_participation_case(PORT, case),
                            _participation_case(REF, case))


def test_hierarchical_cliques_equal_at_10k():
    mine = topology.hierarchical_cliques(10_000, clique_size=25)
    theirs = jax_topology.hierarchical_cliques(10_000, clique_size=25)
    assert mine.edges == theirs.edges
    np.testing.assert_array_equal(np.asarray(mine.edge_class),
                                  np.asarray(theirs.edge_class))
    assert mine.cliques == theirs.cliques
    assert mine.mixing is None and theirs.mixing is None
    assert graphs._connected(10_000, mine.edges)


def test_scale_smoke_rows_equal(monkeypatch):
    """The fig_topology scale smoke, the port's against the reference's:
    the same fabrics, active edges, WAN floats and simulated time (host
    timings aside), each within its 10 s budget."""
    from benchmarks import fig_topology as jax_fig_topology
    from repro_torch.benchmarks import fig_topology
    monkeypatch.delenv("BENCH_JSON_DIR", raising=False)
    for mod in (jax_fig_topology, fig_topology):
        monkeypatch.setattr(mod, "save_rows", lambda *a: "")
    mine, theirs = fig_topology.smoke_scale(), jax_fig_topology.smoke_scale()
    timing = ("per_round_ms", "wall_s")
    strip = lambda rows: [{k: v for k, v in r.items() if k not in timing}
                          for r in rows]
    assert strip(mine) == strip(theirs)
    assert mine[-1]["active_edges"] < mine[-1]["edges"]


# ---------------------------------------------------------------------------
# the link model: tests/test_links.py's behaviour on both packages
# ---------------------------------------------------------------------------

def _links_case(P, case):
    """Drive package ``P`` as the ``tests/test_links.py`` test of the same
    name does, and return what it asserts on."""
    T, C = P.T, P.C
    prof = T.LINK_PROFILES
    if case == "same-seed-replay":
        sched = tv9(P)
        lm = T.LinkModel(prof["datacenter"], seed=3, jitter=0.3, hetero=0.2,
                         straggler_rate=0.05)
        led = T.CommLedger(sched, prof["datacenter"], async_mode=True,
                           link_model=lm)
        for t in range(3 * sched.period):
            led.record_gossip(1e4, t=t, staleness=1)
            led.record_exchange(100.0)
        return view_numbers(led), lm.slow_activations
    if case == "different-seeds":
        out = []
        for seed in (0, 1, 2):
            lm = T.LinkModel(prof["datacenter"], seed=seed, jitter=0.5)
            led = T.CommLedger(T.ring(6), prof["datacenter"], link_model=lm)
            for t in range(10):
                led.record_gossip(1e4, t=t)
            out.append(led.sim_time_s)
        return out
    if case.startswith("zero-rate"):
        async_mode = case.endswith("async")
        sched = tv9(P)
        out = []
        for lm in (None, T.LinkModel(prof["geo-wan"], seed=7)):
            led = T.CommLedger(sched, prof["geo-wan"],
                               config=C.FabricConfig(rewire_floats=32.0),
                               async_mode=async_mode, link_model=lm)
            for t in range(2 * sched.period):
                led.record_gossip(500.0, t=t,
                                  staleness=1 if async_mode else None)
                led.record_exchange(40.0)
                led.record_probe([led.topology.edges[0]], 25.0)
            out.append(view_numbers(led))
        return out
    if case in ("straggler-ring10", "straggler-gap"):
        rates = (0.1,) if case == "straggler-ring10" else (0.0, 0.1)
        seed, rounds = (7, 50) if case == "straggler-ring10" else (11, 60)
        out = []
        for rate in rates:
            for async_mode in (False, True):
                lm = T.LinkModel(prof["datacenter"], seed=seed,
                                 straggler_rate=rate,
                                 straggler_slowdown=25.0)
                led = T.CommLedger(T.ring(10), prof["datacenter"],
                                   async_mode=async_mode, link_model=lm)
                for t in range(rounds):
                    led.record_gossip(1e5, t=t,
                                      staleness=2 if async_mode else None)
                out.append((led.sim_time_s, lm.slow_activations,
                            lm.summary()))
        return out
    if case == "markov-stationary":
        lm = T.LinkModel(prof["datacenter"], seed=0, straggler_rate=0.2,
                         straggler_exit=0.4)
        led = T.CommLedger(T.ring(8), prof["datacenter"], link_model=lm)
        for t in range(600):
            led.record_gossip(100.0, t=t)
        return lm.slow_fraction(), lm.slow_activations, view_numbers(led)
    if case == "amortized-handshake":
        out = []
        for W in (1, 4):
            led = T.CommLedger(T.ring(6), prof["geo-wan"],
                               config=C.FabricConfig(amortize_window=W))
            led.record_gossip(100.0, t=0)
            led.switch_schedule(ring_plus(P, 6, (0, 3), "wan"))
            for t in range(1, 10):
                led.record_gossip(100.0, t=t)
                out.append((led.sim_time_s, led.view().pending_handshake_s))
            out.append(view_numbers(led))
        return out
    if case == "thrash-forfeits":
        out = []
        for W in (1, 4):
            led = T.CommLedger(T.ring(6), prof["geo-wan"],
                               config=C.FabricConfig(rewire_floats=16.0,
                                                     amortize_window=W))
            led.record_gossip(100.0, t=0)
            for t in range(1, 9):
                led.switch_schedule(ring_plus(P, 6, (0, 3), "wan") if t % 2
                                    else T.ring(6))
                led.record_gossip(100.0, t=t)
            out.append(view_numbers(led))
        return out
    if case == "ewma-converges":
        lm = T.LinkModel(prof["datacenter"], seed=5, jitter=0.3)
        led = T.CommLedger(T.ring(4), prof["datacenter"], link_model=lm,
                           ewma_alpha=0.05)
        for t in range(800):
            led.record_gossip(1e4, t=t)
        return view_numbers(led)
    if case == "measured-fallback":
        lm = T.LinkModel(prof["geo-wan"], seed=0, jitter=0.4)
        led = T.CommLedger(ring_plus(P, 6, (0, 3), "wan"), prof["geo-wan"],
                           link_model=lm)
        before = view_numbers(led)
        for t in range(50):
            led.record_gossip(1e4, t=t)
        return before, view_numbers(led)
    if case == "sync-window-numerator":
        lm = T.LinkModel(prof["datacenter"], seed=3, straggler_rate=0.2,
                         straggler_slowdown=25.0)
        led = T.CommLedger(T.ring(6), prof["datacenter"], link_model=lm)
        for t in range(60):
            led.record_gossip(1e4, t=t)
        scout = P.S(C.CommConfig(strategy="gaia", skewscout=True), "gaia",
                    1000, lambda *a: 0.0, ledger=led)
        led0 = T.CommLedger(T.ring(6), prof["datacenter"],
                            link_model=T.LinkModel(prof["datacenter"],
                                                   seed=3))
        led0.record_gossip(1e4, t=0)
        return scout._ledger_cost(), view_numbers(led), view_numbers(led0)
    if case == "skewscout-measured-cm":
        lm = T.LinkModel(prof["geo-wan"], seed=2, jitter=0.4)
        led = T.CommLedger(ring_plus(P, 6, (0, 3), "wan"), prof["geo-wan"],
                           link_model=lm)
        scout = P.S(C.CommConfig(strategy="gaia", skewscout=True), "gaia",
                    1000, lambda *a: 0.0, ledger=led,
                    cm_fabric=T.fully_connected(6))
        before = scout._cm()
        for t in range(40):
            led.record_gossip(1e4, t=t)
        return before, scout._cm()
    if case == "greedy-cliques":
        hist = exclusive_hist(10, 5)
        asg = T.greedy_clique_assignment(hist, seed=0)
        override = [sorted(range(0, 5)), sorted(range(5, 10))]
        return (asg, T.d_cliques(hist, seed=0).cliques,
                T.time_varying_d_cliques(hist, seed=0).at(0).cliques,
                T.d_cliques(hist, seed=123, cliques=override).cliques)
    if case == "link-draws-leave-cliques":
        hist = exclusive_hist(9, 3)
        lm = T.LinkModel(prof["geo-wan"], seed=0, jitter=0.5,
                         straggler_rate=0.3)
        led = T.CommLedger(T.ring(9), prof["geo-wan"], link_model=lm)
        led.record_gossip(1e5, t=0)
        asg = T.greedy_clique_assignment(hist, seed=0)
        led.record_gossip(1e5, t=1)
        return asg, T.d_cliques(hist, seed=0).cliques, view_numbers(led)
    if case == "make-link-model":
        none = T.make_link_model(C.LinkConfig(), prof["uniform"])
        lm = T.make_link_model(C.LinkConfig(model="sampled", jitter=0.2,
                                            straggler_rate=0.1),
                               prof["uniform"], seed=4)
        with pytest.raises(ValueError, match="link_model"):
            T.make_link_model(C.LinkConfig(model="quantum"), prof["uniform"])
        return none, type(lm).__name__, lm.seed, lm.jitter, \
            lm.straggler_rate, lm.summary()
    if case == "summary-fields":
        lm = T.LinkModel(prof["geo-wan"], seed=0, jitter=0.1,
                         straggler_rate=0.05)
        led = T.CommLedger(T.ring(6), prof["geo-wan"], link_model=lm,
                           config=C.FabricConfig(amortize_window=3))
        led.record_gossip(1e4, t=0)
        return led.summary()
    if case == "replace-keeps-link-knobs":
        comm = C.CommConfig(fabric=C.FabricConfig(
            link=C.LinkConfig(model="sampled", straggler_rate=0.3),
            amortize_window=5))
        c2 = dataclasses.replace(
            comm, fabric=dataclasses.replace(comm.fabric, topology="ring"))
        return dataclasses.asdict(c2)
    raise ValueError(case)


LINK_CASES = ("same-seed-replay", "different-seeds", "zero-rate-sync",
              "zero-rate-async", "straggler-ring10", "straggler-gap",
              "markov-stationary", "amortized-handshake", "thrash-forfeits",
              "ewma-converges", "measured-fallback", "sync-window-numerator",
              "skewscout-measured-cm", "greedy-cliques",
              "link-draws-leave-cliques", "make-link-model",
              "summary-fields", "replace-keeps-link-knobs")


@pytest.mark.parametrize("case", LINK_CASES)
def test_link_behaviour_equal(case):
    np.testing.assert_equal(_links_case(PORT, case), _links_case(REF, case))


def test_link_claims_hold_on_the_port():
    """What ``tests/test_links.py`` asserts of these runs, on the port's
    numbers: the straggler chain fired and async beats sync, the gap opens
    only with stragglers, the Markov chain's stationary share, a
    conserved handshake total with its spike flattened, thrashing
    forfeits, EWMA convergence, the measured costs' fallback, the sync
    numerator's currency and the measured CM."""
    ring10 = _links_case(PORT, "straggler-ring10")
    (sync_t, sync_slow, _), (async_t, async_slow, _) = ring10
    assert async_t < sync_t and sync_slow > 0 and async_slow > 0
    gap = _links_case(PORT, "straggler-gap")
    ratio = {0.0: gap[0][0] / gap[1][0], 0.1: gap[2][0] / gap[3][0]}
    assert ratio[0.0] == pytest.approx(1.0, abs=0.12), ratio
    assert ratio[0.1] > 2.0 * ratio[0.0], ratio
    slow_fraction, _, _ = _links_case(PORT, "markov-stationary")
    assert abs(slow_fraction - 0.2 / (0.2 + 0.4)) < 0.08
    amort = _links_case(PORT, "amortized-handshake")
    w1, w4 = amort[9], amort[19]
    assert w4["rewire_time_s"] == pytest.approx(w1["rewire_time_s"])
    assert w4["pending"] == pytest.approx(0.0, abs=1e-15)
    # the round after the switch, whose start both windows share
    first = {1: amort[0][0], 4: amort[10][0]}
    assert first[4] < first[1], first
    assert first[1] - first[4] > \
        0.5 * topology.LINK_PROFILES["geo-wan"].handshake("wan")
    thrash = _links_case(PORT, "thrash-forfeits")
    assert thrash[1]["rewire_time_s"] == pytest.approx(
        thrash[0]["rewire_time_s"])
    np.testing.assert_allclose(thrash[1]["busy"], thrash[0]["busy"],
                               rtol=1e-9)
    ewma = _links_case(PORT, "ewma-converges")
    expect = float(np.exp(0.3 ** 2 / 2)) / \
        topology.LINK_PROFILES["datacenter"].lan_bandwidth
    for _, price in ewma["measured"]:
        assert abs(price - expect) / expect < 0.2
    before, after = _links_case(PORT, "measured-fallback")
    assert before["full"][2] == pytest.approx(before["full"][0])
    assert after["full"][2] != pytest.approx(after["full"][0], rel=1e-6)
    cost, led, led0 = _links_case(PORT, "sync-window-numerator")
    assert cost == led["sampled"] and led["sampled"] > 1.5 * led["priced"]
    assert led0["sampled"] == led0["priced"]
    cm_before, cm_after = _links_case(PORT, "skewscout-measured-cm")
    assert cm_after != pytest.approx(cm_before, rel=1e-6)


def test_amortize_window_validation_equal():
    for P in (REF, PORT):
        with pytest.raises(AssertionError):
            P.T.CommLedger(P.T.ring(4), P.T.LINK_PROFILES["uniform"],
                           config=P.C.FabricConfig(amortize_window=0))


def test_trainer_straggler_async_beats_sync_on_the_port():
    """``test_links.py``'s trainer acceptance on the port (CPU): with
    straggler_rate > 0 on an all-LAN ring, AD-PSGD's simulated wall-clock
    is below D-PSGD's at accuracy within noise, the run reports its link
    extras, and a zero-rate sampled run prices as the constant ledger."""
    from repro_torch.configs.cnn_zoo import CNN_ZOO
    from repro_torch.core.trainer import train_decentralized
    from repro_torch.data.synthetic import synth_images
    C = configs
    ds = synth_images(360, seed=0, n_classes=3)
    parts = []
    for k in range(6):
        i = np.where(ds.y == k % 3)[0][k // 3::2]
        parts.append((ds.x[i], ds.y[i]))
    runs = {}
    for name, async_gossip in (("dpsgd", False), ("adpsgd", True)):
        comm = C.CommConfig(
            strategy=name,
            fabric=C.FabricConfig(
                topology="ring", profile="datacenter",
                link=C.LinkConfig(model="sampled", straggler_rate=0.2,
                                  straggler_slowdown=25.0)),
            async_gossip=async_gossip, max_staleness=2)
        runs[name] = train_decentralized(
            CNN_ZOO["gn-lenet"], name, parts, (ds.x, ds.y), comm=comm,
            steps=12, batch=5, eval_every=12, device="cpu")
    sync, asy = runs["dpsgd"], runs["adpsgd"]
    assert asy.sim_time_s < sync.sim_time_s
    assert asy.val_acc > sync.val_acc - 0.15
    for r in (sync, asy):
        lmx = r.extras["link_model"]
        assert lmx["straggler_rate"] == 0.2 and lmx["activations"] > 0
        assert 0.0 <= lmx["slow_fraction"] <= 1.0
    assert sync.extras["link_model"]["slow_activations"] > 0
    priced = {}
    for link_model in ("constant", "sampled"):
        comm = C.CommConfig(strategy="dpsgd", fabric=C.FabricConfig(
            topology="ring", profile="datacenter",
            link=C.LinkConfig(model=link_model)))
        r = train_decentralized(
            CNN_ZOO["gn-lenet"], "dpsgd", parts, (ds.x, ds.y), comm=comm,
            steps=3, batch=5, eval_every=3, device="cpu")
        priced[link_model] = (r.sim_time_s, r.comm_lan_floats,
                              r.comm_wan_floats)
    assert priced["sampled"] == priced["constant"]
