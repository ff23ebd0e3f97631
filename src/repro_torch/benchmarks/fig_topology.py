"""Topology x skew sweep for gossip (D-PSGD) training, plus a schedule
column at fixed full skew.

The scenario-diversity unlock on top of the paper: the same algorithm on
the same partitions, varying only *who talks to whom*.  Under label skew,
sparse graphs (ring) pay in accuracy for their bandwidth savings, label-
aware D-Cliques recover most of the gap at a fraction of the edges, and
the geo-WAN hierarchy shows the LAN/WAN traffic split the flat
``comm_floats`` scalar could never express.  Link costs use the geo-wan
profile so WAN bytes and the simulated step time diverge across graphs.

The schedule column then varies *when* the edges exist: constant
D-Cliques vs the one-peer-per-round time-varying variant vs EquiTopo
random matchings, reporting WAN floats x final accuracy at full skew —
the paper-level claim that a time-varying fabric keeps the mixing rate
while shedding most per-round (and especially WAN) traffic.

The sync-vs-async column fixes the fabric (geo-wan, full label skew)
and varies *who waits*: synchronous D-PSGD (every round ends at the
slowest link) vs AD-PSGD with bounded-staleness mixing priced by the
async ledger's per-edge clocks — accuracy within noise at a fraction of
the simulated wall-clock, plus the per-node idle time the straggler was
costing everyone.

The straggler-rate column (``run_straggler`` / ``--smoke-links``) drops
the persistent WAN gap entirely: an all-LAN fabric under the stochastic
link model, sweeping the Markov transient-slowdown rate.  Sync pays
every round's straggler (sum of per-round maxes); async only pays it on
the link it hit (max of per-edge sums) — AD-PSGD's actual headline
claim, unmeasurable under class-constant link pricing.

The twin of the reference's ``benchmarks/fig_topology.py``; its training
runs go to ``device`` (CUDA by default).  The smokes write their rows
with ``save_rows`` only: the reference's ``BENCH_*.json`` from a smoke
is written only where an environment variable names a directory, and
the port reads none.

    python -m repro_torch.benchmarks.fig_topology [--quick]
        [--smoke-async | --smoke-links | --smoke-scale] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.benchmarks.common import save_rows
from repro_torch.configs.base import CommConfig, FabricConfig, LinkConfig
from repro_torch.configs.cnn_zoo import CNN_ZOO
from repro_torch.core.partition import partition_label_skew
from repro_torch.core.trainer import train_decentralized
from repro_torch.data.synthetic import synth_images
from repro_torch.topology import (LINK_PROFILES, CommLedger, Participation,
                                  hierarchical_cliques, make_link_model)

K = 10
N_CLASSES = 5          # < K so D-Cliques can span the label space
# harder than the fig1/fig6 setting (lower separation, higher noise,
# larger lr): sparse-graph consensus lag must actually cost accuracy
# under skew, or every topology trivially matches BSP
DATA = dict(noise=1.2, class_sep=0.22, n_classes=N_CLASSES)
LR = 0.05
TOPOLOGIES = ("ring", "full", "dcliques", "geo-wan")
# schedule column: same greedy cliques, different *per-round* edges.
# 3 classes over 9 nodes => 3 cliques, so constant D-Cliques keeps 3 WAN
# edges live every round while the time-varying variant rotates one; a
# 2-clique split would hide the WAN win (both fabrics would have 1 WAN
# edge).  One-peer-per-round mixes less per step, so the column runs at
# a gentler lr than the dense-graph sweep.
SCHED_K, SCHED_CLASSES, SCHED_LR = 9, 3, 0.02
SCHED_DATA = dict(noise=0.8, class_sep=0.35, n_classes=SCHED_CLASSES)
SCHEDULES = ("dcliques", "tv-dcliques", "random-matching")
# sync-vs-async column: same geo-wan fabric + full skew, the only
# difference is whether rounds stop-and-wait for the slowest link
ASYNC_MODES = (("sync", "dpsgd", False), ("async", "adpsgd", True))
# straggler column: all-LAN fabric (no persistent WAN gap), transient
# Markov slowdowns only — the occasional-straggler regime
STRAGGLER_RATES = (0.0, 0.05, 0.15)
STRAGGLER_SLOWDOWN = 25.0


def _exclusive_parts(ds, n_nodes=K, n_classes=N_CLASSES):
    """Full label skew with K > n_classes: node k sees only class
    k % C; each class is sharded over the K/C nodes that hold it."""
    per = n_nodes // n_classes
    parts = []
    for k in range(n_nodes):
        cls_idx = np.where(ds.y == k % n_classes)[0]
        idx = cls_idx[k // n_classes::per]
        parts.append((ds.x[idx], ds.y[idx]))
    return parts


def run(quick: bool = False, device=None):
    steps = 100 if quick else 300
    ds = synth_images(2000 if quick else 4000, seed=0, **DATA)
    val = synth_images(600 if quick else 1000, seed=99, **DATA)
    rows = []
    for skew in (0.0, 1.0):
        if skew == 1.0:
            parts = _exclusive_parts(ds)
        else:
            idx = partition_label_skew(ds.y, K, skew, seed=1)
            parts = [(ds.x[i], ds.y[i]) for i in idx]
        for topo in TOPOLOGIES:
            comm = CommConfig(strategy="dpsgd",
                              fabric=FabricConfig(topology=topo,
                                                  profile="geo-wan"))
            r = train_decentralized(
                CNN_ZOO["gn-lenet"], "dpsgd", parts, (val.x, val.y),
                comm=comm, steps=steps, batch=20, lr=LR,
                eval_every=steps, device=device)
            rows.append(dict(
                schedule="constant", topology=topo, skew=skew,
                val_acc=r.val_acc,
                wan_mfloats=r.comm_wan_floats / 1e6,
                lan_mfloats=r.comm_lan_floats / 1e6,
                sim_time_s=r.sim_time_s,
                spectral_gap=r.extras["spectral_gap"]))
            print(f"[fig_topology] {topo:8s} skew={skew}: "
                  f"acc={r.val_acc:.3f} wan={r.comm_wan_floats/1e6:.1f}M "
                  f"lan={r.comm_lan_floats/1e6:.1f}M "
                  f"t_sim={r.sim_time_s:.1f}s "
                  f"gap={r.extras['spectral_gap']:.3f}", flush=True)

    # schedule column: fixed full skew, constant vs time-varying fabrics;
    # WAN floats x accuracy is the trade the schedules exist to win
    sds = synth_images(1800 if quick else 3600, seed=0, **SCHED_DATA)
    sval = synth_images(600 if quick else 1000, seed=99, **SCHED_DATA)
    parts = _exclusive_parts(sds, SCHED_K, SCHED_CLASSES)
    for name in SCHEDULES:
        comm = CommConfig(strategy="dpsgd",
                          fabric=FabricConfig(topology=name,
                                              profile="geo-wan",
                                              rewire_floats=64.0))
        r = train_decentralized(
            CNN_ZOO["gn-lenet"], "dpsgd", parts, (sval.x, sval.y),
            comm=comm, steps=steps, batch=20, lr=SCHED_LR,
            eval_every=steps, device=device)
        led = r.extras["ledger"]
        rows.append(dict(
            schedule=name, topology=r.topology, skew=1.0,
            val_acc=r.val_acc,
            wan_mfloats=r.comm_wan_floats / 1e6,
            lan_mfloats=r.comm_lan_floats / 1e6,
            wan_mfloats_per_round=r.comm_wan_floats / 1e6 / steps,
            rewire_mfloats=led["rewire_floats"] / 1e6,
            sim_time_s=r.sim_time_s,
            schedule_period=r.extras["schedule_period"],
            spectral_gap=r.extras["spectral_gap"]))
        print(f"[fig_topology] sched {name:16s}: acc={r.val_acc:.3f} "
              f"wan/round={r.comm_wan_floats/1e6/steps:.2f}M "
              f"rewire={led['rewire_floats']/1e6:.2f}M "
              f"period={r.extras['schedule_period']} "
              f"gap={r.extras['spectral_gap']:.3f}", flush=True)

    rows.extend(run_async(parts=_exclusive_parts(ds), ds_val=val,
                          steps=steps, device=device))
    rows.extend(run_straggler(parts=_exclusive_parts(ds), ds_val=val,
                              steps=steps, device=device))
    save_rows("fig_topology", rows)
    return rows


def run_async(parts=None, ds_val=None, steps: int = 100, device=None):
    """Sync-vs-async column (also the ``--smoke-async`` CI entry): the
    same geo-wan fabric, full label skew — D-PSGD priced synchronously
    vs AD-PSGD on the async ledger.  The claim: accuracy within noise,
    simulated wall-clock strictly lower, and the idle time the straggler
    link was costing every LAN node goes to ~zero."""
    if parts is None:
        ds = synth_images(1200, seed=0, **DATA)
        ds_val = synth_images(400, seed=99, **DATA)
        parts = _exclusive_parts(ds)
    rows = []
    for mode, algo, async_gossip in ASYNC_MODES:
        comm = CommConfig(strategy=algo,
                          fabric=FabricConfig(topology="geo-wan",
                                              profile="geo-wan"),
                          async_gossip=async_gossip, max_staleness=2)
        r = train_decentralized(
            CNN_ZOO["gn-lenet"], algo, parts, (ds_val.x, ds_val.y),
            comm=comm, steps=steps, batch=20, lr=LR, eval_every=steps,
            device=device)
        led = r.extras["ledger"]
        rows.append(dict(
            schedule="constant", mode=mode, topology="geo-wan", skew=1.0,
            val_acc=r.val_acc,
            wan_mfloats=r.comm_wan_floats / 1e6,
            lan_mfloats=r.comm_lan_floats / 1e6,
            sim_time_s=r.sim_time_s,
            sim_time_per_step_ms=r.sim_time_s / steps * 1e3,
            clock_skew_s=led["clock_skew_s"],
            idle_s_mean=led["idle_s_mean"]))
        print(f"[fig_topology] {mode:5s} ({algo:6s}): "
              f"acc={r.val_acc:.3f} t_sim={r.sim_time_s:.2f}s "
              f"({r.sim_time_s/steps*1e3:.1f}ms/step) "
              f"idle={led['idle_s_mean']:.2f}s "
              f"skew={led['clock_skew_s']:.2f}s", flush=True)
    return rows


def run_straggler(parts=None, ds_val=None, steps: int = 100,
                  rates=STRAGGLER_RATES, device=None):
    """Straggler-rate sweep (also the ``--smoke-links`` CI entry): an
    otherwise-LAN fabric (ring, datacenter profile — every link LAN),
    the stochastic link model's transient Markov slowdowns the only
    heterogeneity.  Sync D-PSGD stop-and-waits on whichever link is
    currently slow; AD-PSGD's per-edge clocks absorb the burst — the
    wall-clock gap *grows with the straggler rate* while accuracy stays
    within noise, and at rate 0 the two ledgers price identical rounds
    (modulo staleness amortization of the ~zero LAN latency)."""
    if parts is None:
        ds = synth_images(1200, seed=0, **DATA)
        ds_val = synth_images(400, seed=99, **DATA)
        parts = _exclusive_parts(ds)
    rows = []
    for rate in rates:
        for mode, algo, async_gossip in ASYNC_MODES:
            comm = CommConfig(
                strategy=algo,
                fabric=FabricConfig(
                    topology="ring", profile="datacenter",
                    link=LinkConfig(model="sampled", straggler_rate=rate,
                                    straggler_slowdown=STRAGGLER_SLOWDOWN)),
                async_gossip=async_gossip, max_staleness=2)
            r = train_decentralized(
                CNN_ZOO["gn-lenet"], algo, parts, (ds_val.x, ds_val.y),
                comm=comm, steps=steps, batch=20, lr=LR,
                eval_every=steps, device=device)
            lm = r.extras["link_model"]
            rows.append(dict(
                schedule="constant", mode=mode, topology="ring",
                link_model="sampled", straggler_rate=rate, skew=1.0,
                val_acc=r.val_acc,
                sim_time_s=r.sim_time_s,
                sim_time_per_step_ms=r.sim_time_s / steps * 1e3,
                slow_fraction=lm["slow_fraction"],
                clock_skew_s=r.extras["ledger"]["clock_skew_s"]))
            print(f"[fig_topology] straggler={rate:.2f} {mode:5s} "
                  f"({algo:6s}): acc={r.val_acc:.3f} "
                  f"t_sim={r.sim_time_s:.3f}s "
                  f"slow_frac={lm['slow_fraction']:.3f}", flush=True)
    return rows


def smoke_async(device=None):
    """Tiny end-to-end async exercise for CI: must finish in seconds and
    still show the async ledger strictly beating sync wall-clock."""
    rows = run_async(steps=12, device=device)
    sync = next(r for r in rows if r["mode"] == "sync")
    asy = next(r for r in rows if r["mode"] == "async")
    assert asy["sim_time_s"] < sync["sim_time_s"], \
        (asy["sim_time_s"], sync["sim_time_s"])
    save_rows("fig_topology_async_smoke", rows)
    return rows


def smoke_links(device=None):
    """Stochastic-link CI smoke: transient stragglers on an all-LAN
    fabric — async AD-PSGD must strictly beat sync D-PSGD's simulated
    wall-clock at accuracy within noise."""
    rows = run_straggler(steps=12, rates=(0.15,), device=device)
    sync = next(r for r in rows if r["mode"] == "sync")
    asy = next(r for r in rows if r["mode"] == "async")
    assert asy["sim_time_s"] < sync["sim_time_s"], \
        (asy["sim_time_s"], sync["sim_time_s"])
    assert asy["val_acc"] > sync["val_acc"] - 0.15, \
        (asy["val_acc"], sync["val_acc"])
    assert sync["slow_fraction"] > 0, "straggler chain never fired"
    save_rows("fig_topology_links_smoke", rows)
    return rows


def smoke_scale(rounds: int = 50, budget_s: float = 10.0):
    """Array-native fabric scale smoke (the ``--smoke-scale`` CI entry):
    price ``rounds`` gossip rounds on a 10k-node hier-cliques fabric —
    stochastic sampled links, 10% partial participation, async ledger,
    no training — and assert the whole thing fits in ``budget_s`` host
    seconds.  A 1k-node config rides along so the JSON shows per-round
    cost growing with *active edges*, not node count squared (the
    O(active edges) contract of the array ledger)."""
    model_floats = 1e6
    rows = []
    for n_nodes, clique in ((1000, 10), (10000, 25)):
        topo = hierarchical_cliques(n_nodes, clique)
        fabric = FabricConfig(
            topology="hier-cliques", profile="geo-wan",
            link=LinkConfig(model="sampled", jitter=0.1,
                            straggler_rate=0.05),
            participation=0.1)
        profile = LINK_PROFILES[fabric.profile]
        links = make_link_model(fabric.link, profile, seed=0)
        part = Participation(n_nodes, fabric.participation, seed=0)
        led = CommLedger(topo, profile, config=fabric, async_mode=True,
                         link_model=links, participation=part)
        t0 = time.perf_counter()
        for t in range(rounds):
            led.record_gossip(model_floats, t=t)
        wall = time.perf_counter() - t0
        v = led.view()
        active = int(np.count_nonzero(v.edge_traffic))
        rows.append(dict(nodes=n_nodes, edges=len(topo.edges),
                         active_edges=active, rounds=rounds,
                         per_round_ms=wall / rounds * 1e3, wall_s=wall,
                         wan_mfloats=v.wan_floats / 1e6,
                         sim_time_s=v.sim_time_s))
        print(f"[fig_topology] scale K={n_nodes}: {len(topo.edges)} "
              f"edges, {active} active, {wall/rounds*1e3:.2f}ms/round "
              f"({wall:.2f}s total)", flush=True)
    big = rows[-1]
    assert big["wall_s"] < budget_s, \
        (f"10k-node ledger took {big['wall_s']:.2f}s for {rounds} "
         f"rounds (budget {budget_s}s)")
    # 10% participation must actually mask traffic: with both endpoints
    # sampled independently, most edges never fire in 50 rounds
    assert big["active_edges"] < big["edges"], rows
    save_rows("fig_topology_scale_smoke", rows)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke-async", action="store_true",
                    help="tiny sync-vs-async CI smoke (seconds, asserts "
                         "async < sync simulated wall-clock)")
    ap.add_argument("--smoke-links", action="store_true",
                    help="stochastic-link CI smoke (transient stragglers "
                         "on an all-LAN fabric, asserts async < sync)")
    ap.add_argument("--smoke-scale", action="store_true",
                    help="array-ledger scale smoke (10k-node hier-cliques "
                         "fabric, 50 priced rounds under 10s host time)")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    if args.smoke_async:
        smoke_async(device=args.device)
    elif args.smoke_links:
        smoke_links(device=args.device)
    elif args.smoke_scale:
        smoke_scale()
    else:
        run(quick=args.quick, device=args.device)
