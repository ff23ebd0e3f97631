"""Decentralized training loop (simulation backend) in PyTorch.

The harness behind the paper's experiments, as ``repro.core.trainer``:
pick a CNN, a partitioning and an algorithm, train K nodes stacked on one
device, track communication on the fabric's ledger, and report the
validation accuracy of the global model.

Every strategy of the reference runs (BSP, Gaia, FedAvg, DGC with top-k
or rand-k, D-PSGD, AD-PSGD), with or without SkewScout steering θ.  Runs
go to CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import CommConfig
from repro_torch.configs.cnn_zoo import CNNConfig
from repro_torch.core.algorithms.adpsgd import ADPSGD
from repro_torch.core.algorithms.base import ModelFns, tree_size
from repro_torch.core.algorithms.bsp import BSP
from repro_torch.core.algorithms.dgc import DGC, warmup_sparsity
from repro_torch.core.algorithms.dpsgd import DPSGD
from repro_torch.core.algorithms.fedavg import FedAvg
from repro_torch.core.algorithms.gaia import Gaia
from repro_torch.core.skewscout import SkewScout
from repro_torch.data.pipeline import DecentralizedLoader
from repro_torch.device import resolve_device
from repro_torch.models.cnn import cnn_apply, init_cnn, reference_perm
from repro_torch.topology import (LABEL_AWARE_TOPOLOGIES, LINK_PROFILES,
                                  CommLedger, Participation, Topology,
                                  TopologySchedule, as_schedule,
                                  build_schedule, make_link_model,
                                  topology_ladder)


# ---------------------------------------------------------------------------
# CNN adapter
# ---------------------------------------------------------------------------

def make_cnn_fns(cfg: CNNConfig) -> Tuple[ModelFns, Callable]:
    def loss_fn(params, mstate, batch):
        logits, new_ms = cnn_apply(params, mstate, cfg, batch["x"],
                                   train=True)
        return F.cross_entropy(logits, batch["y"]), new_ms

    @torch.no_grad()
    def eval_acc(params, mstate, x: np.ndarray, y: np.ndarray,
                 batch: int = 512) -> float:
        device = next(iter(params.values())).device
        accs, ns = [], []
        for i in range(0, len(x), batch):
            xb = torch.from_numpy(np.ascontiguousarray(x[i:i + batch]))
            yb = torch.from_numpy(np.asarray(y[i:i + batch], np.int64))
            logits, _ = cnn_apply(params, mstate, cfg, xb.to(device),
                                  train=False)
            hit = logits.argmax(dim=-1) == yb.to(device)
            accs.append(float(hit.float().mean()))
            ns.append(len(xb))
        return float(np.average(accs, weights=ns))

    return ModelFns(loss_fn=loss_fn, ref_perm=reference_perm), eval_acc


#: gossip-averaging strategies that run over a TopologySchedule fabric
GOSSIP_ALGOS = ("dpsgd", "adpsgd")


def make_algorithm(name: str, fns: ModelFns, n_nodes: int,
                   comm: CommConfig, *, momentum: float = 0.9,
                   weight_decay: float = 5e-4, lr0: Optional[float] = None,
                   topology: Optional[Topology | TopologySchedule] = None,
                   seed: int = 0, pad_degree: Optional[int] = None,
                   staleness: Optional[int] = None,
                   participation: Optional[Participation] = None):
    if name == "bsp":
        return BSP(fns, n_nodes, momentum=momentum, weight_decay=weight_decay)
    if name == "gaia":
        return Gaia(fns, n_nodes, momentum=momentum,
                    weight_decay=weight_decay, t0=comm.gaia_t0, lr0=lr0)
    if name == "fedavg":
        return FedAvg(fns, n_nodes, momentum=momentum,
                      weight_decay=weight_decay, iter_local=comm.iter_local)
    if name == "dgc":
        return DGC(fns, n_nodes, momentum=momentum,
                   weight_decay=weight_decay, clip=comm.dgc_clip,
                   sparsity=comm.dgc_sparsity,
                   compressor=comm.dgc_compressor, seed=seed)
    if name in GOSSIP_ALGOS:
        if topology is None:
            # label-aware topologies need the label histograms only
            # train_decentralized can supply — refuse to silently build
            # a label-blind graph in their place
            if comm.fabric.topology in LABEL_AWARE_TOPOLOGIES:
                raise ValueError(
                    f"comm.fabric.topology={comm.fabric.topology!r} is "
                    "label-aware: it needs per-node label histograms to "
                    "assemble cliques. Build it with build_schedule(..., "
                    "label_hist=...) and pass topology= explicitly "
                    "(train_decentralized does this from the partitions)")
            topology = build_schedule(comm.fabric.topology, n_nodes,
                                      seed=seed)
        if name == "adpsgd":
            return ADPSGD(fns, n_nodes, topology=topology,
                          momentum=momentum, weight_decay=weight_decay,
                          pad_degree=pad_degree,
                          max_staleness=comm.max_staleness,
                          staleness=staleness, participation=participation)
        return DPSGD(fns, n_nodes, topology=topology, momentum=momentum,
                     weight_decay=weight_decay, pad_degree=pad_degree,
                     participation=participation)
    raise ValueError(name)


@dataclass
class RunResult:
    name: str
    val_acc: float
    val_acc_curve: List[Tuple[int, float]]
    loss_curve: List[Tuple[int, float]]
    comm_total_floats: float
    bsp_equiv_floats: float
    comm_savings: float
    skewscout_history: List = field(default_factory=list)
    extras: Dict[str, Any] = field(default_factory=dict)
    # link-level accounting (repro_torch.topology.CommLedger)
    topology: str = "full"
    comm_lan_floats: float = 0.0
    comm_wan_floats: float = 0.0
    sim_time_s: float = 0.0


def train_decentralized(cnn_cfg: CNNConfig, algo_name: str,
                        parts: Sequence[Tuple[np.ndarray, np.ndarray]],
                        val: Tuple[np.ndarray, np.ndarray], *,
                        comm: CommConfig = CommConfig(),
                        steps: int = 400, batch: int = 20,
                        lr_schedule: Callable = None, lr: float = 0.05,
                        momentum: float = 0.9, weight_decay: float = 5e-4,
                        eval_every: int = 100, seed: int = 0,
                        theta_start_index: Optional[int] = None,
                        device=None) -> RunResult:
    """Train ``cnn_cfg`` on the K partitions ``parts`` under
    ``algo_name`` for ``steps`` steps on ``device`` (CUDA by default).
    ``theta_start_index`` picks SkewScout's starting rung."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if eval_every < 1:
        raise ValueError(f"eval_every must be >= 1, got {eval_every} "
                         "(with steps < eval_every the final step still "
                         "evaluates, but eval_every itself must be valid)")
    device = resolve_device(device)
    K = len(parts)
    # a label past the model's classes would index past its logits: on a
    # card a device-side assert that ends the process's CUDA context
    top = max(int(np.max(y, initial=-1)) for y in [y for _, y in parts]
              + [val[1]])
    if top >= cnn_cfg.n_classes:
        raise ValueError(f"labels reach {top}, but {cnn_cfg.name} has "
                         f"{cnn_cfg.n_classes} classes")
    fns, eval_acc = make_cnn_fns(cnn_cfg)
    params, mstate = init_cnn(torch.Generator().manual_seed(seed), cnn_cfg)
    params = {n: t.to(device) for n, t in params.items()}
    mstate = {n: t.to(device) for n, t in mstate.items()}
    model_floats = float(tree_size(params))

    # communication fabric: per-round graph schedule + link-level cost.
    # Label histograms feed the label-aware builders — needed for a
    # dcliques-family topology, and for the SkewScout topology ladder
    # (whatever fabric the run starts on, the controller must be able to
    # climb to the label-aware rung)
    label_hist = None
    if comm.fabric.topology in LABEL_AWARE_TOPOLOGIES or \
            (comm.skewscout and algo_name == "dpsgd"):
        n_classes = int(max(int(y.max()) for _, y in parts)) + 1
        label_hist = np.stack([np.bincount(np.asarray(y, np.int64),
                                           minlength=n_classes)
                               for _, y in parts])
    sched = build_schedule(comm.fabric.topology, K, label_hist=label_hist,
                           seed=seed)

    # topology as a SkewScout rung (dpsgd): the θ ladder is a list of
    # schedules ordered densest first; training starts on the rung
    # matching the configured topology when there is one, and the
    # neighbor operands are padded to the ladder-wide max degree so rung
    # switches keep one operand shape
    ladder = None
    pad_degree = None
    staleness = None
    start_index = theta_start_index
    if comm.skewscout and algo_name == "dpsgd":
        ladder = topology_ladder(K, label_hist=label_hist, seed=seed)
        # the configured fabric is always a rung: replace the same-named
        # rung with the exact built schedule, or insert it, then re-sort
        # densest-first (hill climbing needs the ladder monotone in cost)
        names = [s.name for s in ladder]
        if sched.name in names:
            ladder[names.index(sched.name)] = sched
        else:
            ladder.append(sched)
        ladder.sort(key=TopologySchedule.mean_round_edges, reverse=True)
        if start_index is None:
            start_index = ladder.index(sched)
        elif not 0 <= start_index < len(ladder):
            raise ValueError(
                f"theta_start_index={start_index} out of range for the "
                f"{len(ladder)}-rung topology ladder "
                f"({[s.name for s in ladder]})")
        sched = ladder[start_index]
        pad_degree = max(s.max_degree for s in ladder)
    elif comm.skewscout and algo_name == "adpsgd":
        # staleness as a SkewScout rung (adpsgd): most synchronous rung
        # first.  A sync ledger ignores staleness, so every rung would
        # have the same C(theta) and the controller would drift on noise
        # — refuse instead of silently mis-steering
        if not comm.async_gossip:
            raise ValueError(
                "skewscout over the adpsgd staleness ladder needs "
                "async_gossip=True: a synchronous ledger prices every "
                "staleness rung identically (C(theta) is float-based), "
                "so the controller's cost term would be degenerate")
        ladder = list(range(comm.max_staleness + 1))
        if start_index is None:
            start_index = len(ladder) - 1     # start fully asynchronous
        elif not 0 <= start_index < len(ladder):
            raise ValueError(
                f"theta_start_index={start_index} out of range for the "
                f"{len(ladder)}-rung staleness ladder ({ladder})")
        staleness = ladder[start_index]

    # stochastic links: one seeded LinkModel for the run, on keyed
    # streams the link seed cannot share with anything else
    profile = LINK_PROFILES[comm.fabric.profile]
    links = make_link_model(comm.fabric.link, profile, seed=seed)
    # partial participation: one seeded per-round node sampler shared by
    # the ledger (masked pricing), the gossip mixing operands and the
    # SkewScout probes
    part = (Participation(K, comm.fabric.participation, seed=seed)
            if comm.fabric.participation < 1.0 else None)
    ledger = CommLedger(sched, profile, config=comm.fabric,
                        async_mode=comm.async_gossip,
                        link_model=links,
                        participation=part)

    algo = make_algorithm(algo_name, fns, K, comm, momentum=momentum,
                          weight_decay=weight_decay, lr0=lr, topology=sched,
                          seed=seed, pad_degree=pad_degree,
                          staleness=staleness, participation=part)
    state = algo.init(params, mstate)
    loader = DecentralizedLoader(parts, batch, seed=seed)
    lr_fn = lr_schedule or (lambda s: lr)

    def _cm_pin(fabric) -> float:
        # CM pinned to one full-model exchange on the given fabric, in
        # the unit the scout prices C(theta) with: wall-clock for an
        # async ledger, bandwidth-seconds for a sync one
        led = CommLedger(fabric, profile).view()
        return led.full_exchange_time(model_floats) if comm.async_gossip \
            else led.full_exchange_cost(model_floats)

    scout = None
    if comm.skewscout and algo_name in GOSSIP_ALGOS:
        # the densest rung (dpsgd) or the fixed fabric (adpsgd) pins the
        # denominator so C(theta)/CM stays comparable as the controller
        # moves.  Under a link model the constants are a fiction: pin the
        # *fabric* instead and let the scout re-price CM from the
        # ledger's per-edge EWMA measured costs at every probe
        pin = ladder[0] if algo_name == "dpsgd" else sched
        cm = (dict(cm_fabric=pin) if links is not None
              else dict(cm_ref=_cm_pin(pin)))
        scout = SkewScout(comm, algo_name, tree_size(params), eval_acc,
                          start_index=start_index, seed=seed,
                          ledger=ledger, ladder=ladder,
                          participation=part, **cm)
    elif comm.skewscout and algo_name != "bsp":
        scout = SkewScout(comm, algo_name, tree_size(params), eval_acc,
                          start_index=theta_start_index, seed=seed,
                          ledger=ledger, participation=part)

    loss_curve, acc_curve, gap_curve, stale_curve = [], [], [], []
    comm_total = 0.0

    for t in range(steps):
        xs, ys = loader.next_stacked()
        sbatch = {"x": torch.from_numpy(xs).to(device),
                  "y": torch.from_numpy(ys.astype(np.int64)).to(device)}
        lr_t = torch.tensor(lr_fn(t), dtype=torch.float32, device=device)
        # FedAvg's sync interval and DGC's sparsity stay Python numbers,
        # which the step reads without a device sync
        kw: Dict[str, Any] = {}
        if algo_name == "gaia":
            kw["t0"] = torch.tensor(scout.theta if scout else comm.gaia_t0,
                                    dtype=torch.float32, device=device)
        elif algo_name == "fedavg":
            kw["iter_local"] = int(scout.theta if scout else comm.iter_local)
        elif algo_name == "dgc":
            kw["sparsity"] = (scout.theta if scout else warmup_sparsity(
                t // loader.steps_per_epoch, comm.dgc_warmup_epochs))
        state, metrics = algo.step(state, sbatch, lr_t, t, **kw)
        cf = float(metrics["comm_floats"])
        comm_total += cf
        if algo_name in GOSSIP_ALGOS:
            # round t's active edge set prices this gossip exchange; an
            # async algorithm also reports its per-edge staleness bound
            # so the ledger can amortize link latency accordingly
            stale = algo.edge_staleness(t) \
                if algo_name == "adpsgd" else None
            ledger.record_gossip(model_floats, t=t, staleness=stale)
            gap_curve.append(
                (t, float(algo.schedule.round_spectral_gap(t))))
            if algo_name == "adpsgd":
                stale_curve.append((t, float(metrics["mean_staleness"])))
        elif cf > 0:
            ledger.record_exchange(cf)
        if scout:
            scout.record_step(cf)
            rep = scout.maybe_travel(
                t, algo, state,
                lambda node, _t=t: loader.sample_train_subset(
                    node, 256, seed=_t))
            if rep is not None:
                # model traveling overhead: the scout booked each
                # probe's shipment on the edge it crossed
                comm_total += rep.probe_floats
                if algo_name == "dpsgd" and rep.new_theta is not rep.theta:
                    # topology rung switch: re-wiring is charged by the
                    # ledger on the next gossip round, inside the new
                    # rung's C(θ) window
                    algo.set_schedule(rep.new_theta)
                    ledger.switch_schedule(rep.new_theta)
                elif algo_name == "adpsgd" and rep.new_theta != rep.theta:
                    # staleness rung switch: same fabric, new bound —
                    # operand values only, no re-wiring
                    algo.set_staleness(rep.new_theta)
        if (t + 1) % eval_every == 0 or t == steps - 1:
            p, s = algo.eval_params(state)
            acc_curve.append((t + 1, eval_acc(p, s, val[0], val[1])))
        loss_curve.append((t, float(metrics["loss"])))

    bsp_equiv = model_floats * steps
    # the fabric the run *ended* on (rung switches may have moved it)
    final_sched = as_schedule(algo.schedule) \
        if algo_name in GOSSIP_ALGOS else sched
    ledger_view = ledger.view()
    return RunResult(
        name=f"{cnn_cfg.name}/{algo_name}",
        val_acc=acc_curve[-1][1],
        val_acc_curve=acc_curve,
        loss_curve=loss_curve,
        comm_total_floats=comm_total,
        bsp_equiv_floats=bsp_equiv,
        comm_savings=bsp_equiv / max(comm_total, 1.0),
        skewscout_history=list(scout.history) if scout else [],
        extras={"ledger": ledger.summary(),
                "spectral_gap": final_sched.spectral_gap(),
                "spectral_gap_curve": gap_curve,
                "schedule_period": final_sched.period,
                # per-node clock accounting (async: who ran ahead; sync:
                # who sat waiting on the slowest link)
                "node_clock_skew_s": ledger_view.clock_skew_s,
                "node_busy_s": [float(b) for b in ledger_view.node_busy_s],
                "node_idle_s": [float(i) for i in ledger_view.node_idle_s],
                **({"link_model": links.summary()}
                   if links is not None else {}),
                **({"staleness_curve": stale_curve,
                    "max_staleness": algo.max_staleness}
                   if algo_name == "adpsgd" else {}),
                **({"topology_ladder": [s.name for s in ladder]}
                   if ladder is not None and algo_name == "dpsgd" else {}),
                **({"staleness_ladder": list(ladder)}
                   if ladder is not None and algo_name == "adpsgd"
                   else {})},
        topology=final_sched.name,
        comm_lan_floats=ledger.lan_floats,
        comm_wan_floats=ledger.wan_floats,
        sim_time_s=ledger.sim_time_s,
    )
