"""Decentralized training loop (simulation backend) in PyTorch.

The harness behind the paper's experiments, as ``repro.core.trainer``:
pick a CNN, a partitioning and an algorithm, train K nodes stacked on one
device, track communication on the fabric's ledger, and report the
validation accuracy of the global model.

This slice runs BSP, Gaia and D-PSGD without SkewScout; the other
strategies raise ``NotImplementedError`` naming the ROADMAP item that
ports them.  Runs go to CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import CommConfig
from repro_torch.configs.cnn_zoo import CNNConfig
from repro_torch.core.algorithms.base import ModelFns, tree_size
from repro_torch.core.algorithms.bsp import BSP
from repro_torch.core.algorithms.dpsgd import DPSGD
from repro_torch.core.algorithms.gaia import Gaia
from repro_torch.data.pipeline import DecentralizedLoader
from repro_torch.models.cnn import cnn_apply, init_cnn
from repro_torch.topology import (LABEL_AWARE_TOPOLOGIES, LINK_PROFILES,
                                  CommLedger, Participation, Topology,
                                  TopologySchedule, build_schedule,
                                  make_link_model)

#: strategies of the reference not ported yet, with the ROADMAP item
#: that ports each
NOT_PORTED = {
    "adpsgd": "ROADMAP.md, next slice: AD-PSGD + _mix_src_kernel",
    "dgc": "ROADMAP.md, next slice: DGC + _randk_kernel",
    "fedavg": "ROADMAP.md, next slice: FedAvg",
}
SKEWSCOUT_ITEM = "ROADMAP.md, next slice: SkewScout"


def _resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means CUDA, and raises
    where there is none rather than running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the GPU unless the "
                "caller passes device='cpu'")
        return torch.device("cuda")
    return torch.device(device)


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

    return ModelFns(loss_fn=loss_fn), eval_acc


def make_algorithm(name: str, fns: ModelFns, n_nodes: int,
                   comm: CommConfig, *, momentum: float = 0.9,
                   weight_decay: float = 5e-4, lr0: Optional[float] = None,
                   topology: Optional[Topology | TopologySchedule] = None,
                   seed: int = 0,
                   participation: Optional[Participation] = None):
    if name == "bsp":
        return BSP(fns, n_nodes, momentum=momentum, weight_decay=weight_decay)
    if name == "gaia":
        return Gaia(fns, n_nodes, momentum=momentum,
                    weight_decay=weight_decay, t0=comm.gaia_t0, lr0=lr0)
    if name == "dpsgd":
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
        return DPSGD(fns, n_nodes, topology=topology, momentum=momentum,
                     weight_decay=weight_decay, participation=participation)
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"strategy {name!r} is not ported yet: {NOT_PORTED[name]}")
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
                        device=None) -> RunResult:
    """Train ``cnn_cfg`` on the K partitions ``parts`` under
    ``algo_name`` for ``steps`` steps on ``device`` (CUDA by default)."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if eval_every < 1:
        raise ValueError(f"eval_every must be >= 1, got {eval_every} "
                         "(with steps < eval_every the final step still "
                         "evaluates, but eval_every itself must be valid)")
    if comm.skewscout:
        raise NotImplementedError(
            f"skewscout=True is not ported yet: {SKEWSCOUT_ITEM}")
    if algo_name in NOT_PORTED:
        raise NotImplementedError(
            f"strategy {algo_name!r} is not ported yet: "
            f"{NOT_PORTED[algo_name]}")
    device = _resolve_device(device)
    K = len(parts)
    fns, eval_acc = make_cnn_fns(cnn_cfg)
    params, mstate = init_cnn(torch.Generator().manual_seed(seed), cnn_cfg)
    params = {n: t.to(device) for n, t in params.items()}
    mstate = {n: t.to(device) for n, t in mstate.items()}

    # communication fabric: per-round graph schedule + link-level cost.
    # Label histograms feed the label-aware graphs (dcliques family)
    label_hist = None
    if comm.fabric.topology in LABEL_AWARE_TOPOLOGIES:
        n_classes = int(max(int(y.max()) for _, y in parts)) + 1
        label_hist = np.stack([np.bincount(np.asarray(y, np.int64),
                                           minlength=n_classes)
                               for _, y in parts])
    sched = build_schedule(comm.fabric.topology, K, label_hist=label_hist,
                           seed=seed)

    # stochastic links: one seeded LinkModel for the run, on keyed
    # streams the link seed cannot share with anything else
    profile = LINK_PROFILES[comm.fabric.profile]
    links = make_link_model(comm.fabric.link, profile, seed=seed)
    # partial participation: one seeded per-round node sampler shared by
    # the ledger (masked pricing) and the gossip mixing operands
    part = (Participation(K, comm.fabric.participation, seed=seed)
            if comm.fabric.participation < 1.0 else None)
    ledger = CommLedger(sched, profile, config=comm.fabric,
                        async_mode=comm.async_gossip,
                        link_model=links,
                        participation=part)

    algo = make_algorithm(algo_name, fns, K, comm, momentum=momentum,
                          weight_decay=weight_decay, lr0=lr, topology=sched,
                          seed=seed, participation=part)
    state = algo.init(params, mstate)
    loader = DecentralizedLoader(parts, batch, seed=seed)
    lr_fn = lr_schedule or (lambda s: lr)
    model_floats = float(tree_size(params))

    loss_curve, acc_curve, gap_curve = [], [], []
    comm_total = 0.0

    for t in range(steps):
        xs, ys = loader.next_stacked()
        sbatch = {"x": torch.from_numpy(xs).to(device),
                  "y": torch.from_numpy(ys.astype(np.int64)).to(device)}
        lr_t = torch.tensor(lr_fn(t), dtype=torch.float32, device=device)
        kw: Dict[str, Any] = {}
        if algo_name == "gaia":
            kw["t0"] = torch.tensor(comm.gaia_t0, dtype=torch.float32,
                                    device=device)
        state, metrics = algo.step(state, sbatch, lr_t, t, **kw)
        cf = float(metrics["comm_floats"])
        comm_total += cf
        if algo_name == "dpsgd":
            # round t's active edge set prices this gossip exchange
            ledger.record_gossip(model_floats, t=t)
            gap_curve.append(
                (t, float(algo.schedule.round_spectral_gap(t))))
        elif cf > 0:
            ledger.record_exchange(cf)
        if (t + 1) % eval_every == 0 or t == steps - 1:
            p, s = algo.eval_params(state)
            acc_curve.append((t + 1, eval_acc(p, s, val[0], val[1])))
        loss_curve.append((t, float(metrics["loss"])))

    bsp_equiv = model_floats * steps
    ledger_view = ledger.view()
    return RunResult(
        name=f"{cnn_cfg.name}/{algo_name}",
        val_acc=acc_curve[-1][1],
        val_acc_curve=acc_curve,
        loss_curve=loss_curve,
        comm_total_floats=comm_total,
        bsp_equiv_floats=bsp_equiv,
        comm_savings=bsp_equiv / max(comm_total, 1.0),
        extras={"ledger": ledger.summary(),
                "spectral_gap": sched.spectral_gap(),
                "spectral_gap_curve": gap_curve,
                "schedule_period": sched.period,
                # per-node clock accounting (sync: who sat waiting on
                # the slowest link)
                "node_clock_skew_s": ledger_view.clock_skew_s,
                "node_busy_s": [float(b) for b in ledger_view.node_busy_s],
                "node_idle_s": [float(i) for i in ledger_view.node_idle_s],
                **({"link_model": links.summary()}
                   if links is not None else {})},
        topology=sched.name,
        comm_lan_floats=ledger.lan_floats,
        comm_wan_floats=ledger.wan_floats,
        sim_time_s=ledger.sim_time_s,
    )
