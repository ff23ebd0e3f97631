"""The dry-run stand-in (``repro.launch.dryrun``): one rank's step of every
(architecture x input shape) combination on the reference's production
meshes, traced on ``meta`` tensors, with its memory, an H100 roofline,
the cross-pod exchange, a graph audit and a step audit.

The reference lowers and compiles each combo's step for 512 forced host
devices and reads XLA's memory, cost and HLO.  Here nothing is compiled,
allocated or sent: the port's own train, prefill and decode steps run
once on ``meta`` tensors for rank 0 of a ``launch.meta.MetaMesh`` of the
mesh's shape, every collective recorded by the mesh, every aten op and
kernel launch counted by ``launch.meta.CostMode``.  Rank 0 stands for
every rank: a placed dimension is split evenly or, where the reference's
clamp keeps it whole (any width an axis does not divide, ``long_500k``'s
one request, a pod's sequences ``data`` does not divide), whole on every
rank, so every rank's blocks have one shape (only AD-PSGD's all-to-all
splits and the gossip's neighbour sets differ by pod rank).  ``--mesh``
takes any (pod, data, model) shape the reference's dry run takes.  No
card, no ``XLA_FLAGS``, no process group.

Usage (the reference's flags, ``--save-hlo`` aside: there is no HLO):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k [--multi-pod] [--strategy gaia] [--out report.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all-combos

A serve shape (prefill, decode) on a mesh of more than one pod traces one
pod's (data, model) grid: the reference's serve placements replicate
the parameters and the requests over ``pod``, and the port serves one site
a mesh (``steps.make_prefill_step``), so each pod's ranks run that step.
A combo the steps refuse comes back as a failure row carrying its
``ValueError``, as the reference's sweep records a failed combo.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import traceback
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.analysis import graph_audit, step_audit
from repro_torch.configs.base import (CommConfig, FabricConfig, INPUT_SHAPES,
                                      InputShape, ModelConfig)
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import analysis, meta, sharding, specs
from repro_torch.launch.mesh import devices_per_pod, n_pods as mesh_n_pods
from repro_torch.launch.steps import (GOSSIP_STRATEGIES, gossip_operands,
                                      local_pods, make_prefill_step,
                                      make_serve_step, make_train_state,
                                      make_train_step, param_shape)
from repro_torch.models.model import init_cache
from repro_torch.topology.graphs import build_demo_schedule

STRATEGIES = ("bsp", "gaia", "fedavg", "dgc") + GOSSIP_STRATEGIES

#: every fabric a gossip strategy can ride: the topology half of the
#: audit matrix (STRATEGIES x GOSSIP_TOPOLOGIES; the other strategies
#: trace the same step for every fabric, so they sweep once)
GOSSIP_TOPOLOGIES = ("ring", "torus", "full", "random", "geo-wan",
                     "dcliques", "tv-dcliques", "random-matching")

#: the all-combos sweep target: the reduced config on the reference's CI
#: mesh (2 pods x 2 data x 2 model)
SWEEP_ARCH = "qwen3-0.6b"
SWEEP_SHAPE = "train_4k"
SWEEP_MESH = "2,2,2"

#: which graph-audit findings fail a combo: "gossip" (default: the gossip
#: strategies' train steps), "all" (--strict-audit: any combo), "none"
AUDIT_FAIL_MODES = ("gossip", "all", "none")

#: the reference's collective names for ``Mesh``'s methods
_KIND_NAMES = {"all_reduce": "all-reduce", "all_gather_dim": "all-gather",
               "all_gather": "all-gather", "reduce_scatter_dim":
               "reduce-scatter", "all_to_all": "all-to-all",
               "gather": "gather", "barrier": "barrier"}


def iter_combos(include_serve: bool = True):
    """The audit matrix: ``(shape_name, strategy, topology)`` rows, every
    strategy x topology combo of the train step plus the prefill and
    decode steps (strategy and topology ``None`` there)."""
    for s in STRATEGIES:
        for t in (GOSSIP_TOPOLOGIES if s in GOSSIP_STRATEGIES
                  else (None,)):
            yield (SWEEP_SHAPE, s, t)
    if include_serve:
        yield ("prefill_32k", None, None)
        yield ("decode_32k", None, None)


def make_production_mesh(*, multi_pod: bool = False) -> meta.MetaMesh:
    """Rank 0 of the reference's production mesh: (2, 16, 16) over (pod,
    data, model), or (16, 16) over (data, model), held as one pod of
    (1, 16, 16) (the train state's pod axis of one)."""
    return _parse_mesh("2,16,16" if multi_pod else "16,16")


def _parse_mesh(spec: Optional[str]) -> Optional[meta.MetaMesh]:
    """``"pod,data,model"`` or ``"data,model"`` as rank 0 of a
    ``MetaMesh``; a (data, model) mesh is one pod of (1, data, model),
    named by its two sizes."""
    if not spec:
        return None
    dims = tuple(int(d) for d in spec.split(","))
    if len(dims) not in (2, 3):
        raise ValueError(
            f"--mesh {spec!r}: expected 'pod,data,model' (3 dims) or "
            "'data,model' (2 dims)")
    name = "x".join(str(d) for d in dims)
    return meta.MetaMesh(dims if len(dims) == 3 else (1,) + dims, name=name)


def _serve_mesh(mesh: meta.MetaMesh) -> meta.MetaMesh:
    """The mesh a serve step runs on: one pod's (data, model) grid."""
    if mesh_n_pods(mesh) == 1:
        return mesh
    return meta.MetaMesh((1, mesh.shape["data"], mesh.shape["model"]),
                         name=mesh.name)


def batch_blocks(tree: Dict[str, torch.Tensor], mesh, *,
                 pod_stacked: bool) -> Dict[str, Tuple[int, ...]]:
    """The shape of the rank's block of each leaf of a global batch."""
    placed = sharding.batch_shardings(tree, mesh, pod_stacked=pod_stacked)
    return {k: tuple(sharding.local_block(t, placed[k], mesh).shape)
            for k, t in tree.items()}


def _rows_bytes(batch: Dict[str, torch.Tensor], mesh, *,
                pod_stacked: bool) -> int:
    """Bytes of the rank's rows of a global batch."""
    return sum(math.prod(s) * batch[k].element_size() for k, s in
               batch_blocks(batch, mesh, pod_stacked=pod_stacked).items())


def build_step(arch: Union[str, ModelConfig],
               shape_name: Union[str, InputShape], *,
               strategy: Optional[str] = "gaia",
               topology: Optional[str] = "ring",
               staleness: Optional[int] = None, max_staleness: int = 2,
               chunk: int = 512, remat: bool = True,
               reduced: bool = False, mesh=None) -> Tuple:
    """One combo's ``(step, args, notes)`` on rank 0 of ``mesh`` (a
    ``MetaMesh``): ``args`` are ``meta`` tensors (the rank's train state,
    the global batch, the round's gossip operands; or the rank's
    parameter blocks, the global batch and its cache block), and
    ``notes`` holds ``"mesh"`` (the mesh the step runs on),
    ``"argument_bytes"`` (the rank's state or parameter blocks, its rows
    of the batch, its operands and cache blocks), ``"wire_groups"`` (a
    train state's leaf dtype groups: one pod's row width each) and,
    for decode, ``"batch_sharded"`` (the cache placement taken:
    ``sharding.default_batch_sharded``, where the reference's rule is B >=
    8).  ``strategy`` and ``topology`` may be None for serve shapes.

    As the reference's model code does, ``REPRO_MOE_EP`` set in the
    environment takes the MoE layers' expert-parallel route
    (``moe_route="ep"``), and ``REPRO_BASELINE_DECODE`` the decode cache's
    heads placement (``baseline_decode``).

    ``arch`` may be a ``ModelConfig`` and ``shape_name`` an
    ``InputShape``: a hook for tracing a configuration and shape that are
    not the registry's (``chip_smoke.py`` phase 17 traces its pod run's
    depth cut and batch)."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if reduced:
        cfg = cfg.reduced()
    shape = INPUT_SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    mesh = mesh or make_production_mesh(multi_pod=True)
    pods = mesh_n_pods(mesh)
    # the reference's switches, read where its model code reads them
    route = "ep" if os.environ.get("REPRO_MOE_EP") else "dense"
    baseline = bool(os.environ.get("REPRO_BASELINE_DECODE"))
    notes: Dict = {}
    if shape.mode == "train":
        comm = CommConfig(strategy=strategy or "bsp",
                          fabric=FabricConfig(topology=topology or "ring"),
                          max_staleness=max_staleness)
        state = make_train_state(param_shape(cfg), comm, pods, mesh=mesh)
        batch = specs.as_meta(specs.train_batch_specs(cfg, shape,
                                                      n_pods=pods))
        step = make_train_step(cfg, comm, mesh=mesh, remat=remat,
                               chunk=chunk, moe_route=route)
        args: Tuple = (state, batch, 0)
        leaves = pytree.leaves(state["params"])
        groups: Dict[str, int] = {}
        for t in leaves:
            name = pytree.dtype_name(t.dtype)
            groups[name] = groups.get(name, 0) + t[0].numel()
        notes["wire_groups"] = groups
        notes["argument_bytes"] = meta.block_bytes(state) + _rows_bytes(
            batch, mesh, pod_stacked=True)
        if strategy in GOSSIP_STRATEGIES:
            sched = build_demo_schedule(topology, pods)
            mix = gossip_operands(
                sched, 0,
                staleness=(max_staleness if staleness is None
                           else staleness)
                if strategy == "adpsgd" else None,
                max_staleness=max_staleness, device="meta", mesh=mesh)
            _, w, _ = sched.neighbor_arrays(0)
            mine = np.asarray(local_pods(pods, mesh))
            notes["degree"] = float((w[mine] > 0).sum(axis=1).mean())
            notes["model_bytes"] = sum(t[0].numel() * t.element_size()
                                       for t in leaves) * len(mine)
            notes["argument_bytes"] += meta.block_bytes(mix)
            args += (mix,)
        notes["mesh"] = mesh
        return step, args, notes
    mesh = _serve_mesh(mesh)
    params = sharding.local_params(param_shape(cfg), mesh)
    notes["mesh"] = mesh
    if shape.mode == "prefill":
        batch = specs.as_meta(specs.prefill_batch_specs(cfg, shape))
        notes["argument_bytes"] = meta.block_bytes(params) + _rows_bytes(
            batch, mesh, pod_stacked=False)
        return (make_prefill_step(cfg, mesh=mesh, chunk=chunk,
                                  moe_route=route), (params, batch), notes)
    B = shape.global_batch
    placed = sharding.default_batch_sharded(cfg, B, mesh)
    cache = init_cache(cfg, B, shape.seq_len, shape.name == "long_500k",
                       device="meta", mesh=mesh, batch_sharded=placed,
                       baseline_decode=baseline)
    batch = specs.as_meta(specs.decode_batch_specs(cfg, shape))
    notes["batch_sharded"] = placed
    notes["argument_bytes"] = (meta.block_bytes((params, cache))
                               + _rows_bytes(batch, mesh, pod_stacked=False))
    return (make_serve_step(cfg, mesh=mesh, moe_route=route,
                            batch_sharded=placed, baseline_decode=baseline),
            (params, cache, batch), notes)


def audit_graph(trace, mesh, shape: Union[str, InputShape],
                strategy: Optional[str], *, tag: str,
                combo: Optional[str] = None) -> graph_audit.GraphAudit:
    """The graph audit (GA2xx) of one combo's ``trace`` on ``mesh`` as
    the sweep runs it: the pod-axis report and GA205 for a train step on
    more than one pod, GA201 for the gossip strategies, GA202 over the
    cross-pod transfers of a train step."""
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    train_graph = shape.mode == "train" and mesh_n_pods(mesh) > 1
    return graph_audit.audit_trace(
        trace, tag=tag, combo=combo,
        devices_per_pod=devices_per_pod(mesh) if train_graph else None,
        check_wire_dtype=train_graph,
        check_pod_axis=strategy in GOSSIP_STRATEGIES
        and shape.mode == "train",
        expect_donation=shape.mode == "train")


def trace_combo(arch: Union[str, ModelConfig],
                shape: Union[str, InputShape], mesh, *,
                strategy: Optional[str], topology: Optional[str], tag: str,
                combo: str,
                const_threshold_bytes: int = step_audit.CONST_THRESHOLD_BYTES,
                **build) -> Tuple[Dict, meta.Trace, step_audit.StepAudit,
                                  graph_audit.GraphAudit]:
    """One combo's step (``build_step`` on ``mesh``, ``build`` its other
    options) traced once on ``meta`` tensors under the step audit
    (JA401–JA405), and the graph audit (GA2xx) over the same trace: the
    per-combo work of both sweeps, ``dryrun_one``'s and
    ``analysis.step_audit.audit_combos``.  Returns ``(notes, trace,
    step_audit, graph_audit)``, each audit's findings under ``tag``."""
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    step, args, notes = build_step(arch, shape, strategy=strategy,
                                   topology=topology, mesh=mesh, **build)
    trace, sa = step_audit.trace_and_audit(
        step, args, notes["mesh"], wire_groups=notes.get("wire_groups"),
        gossip=strategy in GOSSIP_STRATEGIES and shape.mode == "train",
        tag=tag, const_threshold_bytes=const_threshold_bytes)
    ga = audit_graph(trace, mesh, shape, strategy, tag=tag, combo=combo)
    return notes, trace, sa, ga


def dryrun_one(arch: Union[str, ModelConfig],
               shape_name: Union[str, InputShape], *,
               multi_pod: bool = False,
               strategy: Optional[str] = "gaia",
               topology: Optional[str] = "ring",
               staleness: Optional[int] = None, max_staleness: int = 2,
               chunk: int = 512, remat: bool = True, verbose: bool = True,
               reduced: bool = False, mesh=None,
               audit_fail: str = "gossip") -> Dict:
    """Trace one combo (``build_step``) and report it in the reference's
    JSON keys: ``arch``, ``shape``, ``mesh``, ``mode``, ``strategy``,
    ``ok``, ``pod_exchange``, ``audit``, ``memory``, ``cost`` and
    ``roofline``, plus ``placement`` (decode: the cache placement taken
    beside the reference's B >= 8).

    ``memory``: ``argument_size_in_bytes``, the rank's arguments as
    blocks (``build_step``'s notes); ``temp_size_in_bytes``, the most
    bytes of storage the step made and held at once (its outputs
    included: peak live less the arguments); ``output_size_in_bytes``,
    the step's outputs.  ``cost``: the traced flops and bytes (an upper
    bound: ``CostMode``), each kernel's launches, flops and bytes.

    ``pod_exchange`` (a train step on more than one pod; the reference's
    keys, wire bytes a rank in GB): ``permute_*`` are the pod-axis
    ``all_gather`` and ``all_to_all`` (the gossip exchange; the
    reference's collective-permutes), ``reduce_*`` the ``all_reduce``
    and ``reduce_scatter_dim`` records, ``*_cross`` those on the pod
    axis and ``*_local`` the intra-pod ones; gossip rows add
    ``topology`` and ``ring_permute_gbytes_per_dev``, what collective
    permutes to the rank's pods' active neighbours would ship (their
    mean degree times the rank's model bytes), beside the port's
    exchange.  The gossip checks hold as the reference's: the exchange
    on the pod axis only, above 0 bytes, its reductions below it.

    A host read in the step ends its trace: GA203 in the audit, and the
    ``cost`` of what was traced up to it, under ``traced_to_host_sync``
    (a failed combo where the audit fails it).

    The same trace runs under the dataflow audit (``analysis.step_audit``,
    JA401–JA405), its summary under ``"step_audit"``: reported, not failed
    on (``python -m repro_torch.analysis`` is that gate)."""
    if audit_fail not in AUDIT_FAIL_MODES:
        raise ValueError(
            f"audit_fail {audit_fail!r}: expected one of "
            f"{AUDIT_FAIL_MODES}")
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if reduced:
        cfg = cfg.reduced()
    shape = INPUT_SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    pods = mesh_n_pods(mesh)
    mesh_name = mesh.name
    gossip = strategy in GOSSIP_STRATEGIES and shape.mode == "train"
    combo = f"{shape.name}/{strategy or '-'}/{topology or '-'}"
    arch_name = arch if isinstance(arch, str) else cfg.arch_id
    notes, trace, sa, ga = trace_combo(
        cfg, shape, mesh, strategy=strategy, topology=topology,
        tag=f"{arch_name}/{shape.name}/{strategy or shape.mode}",
        combo=combo, staleness=staleness, max_staleness=max_staleness,
        chunk=chunk, remat=remat)
    cost = trace.cost
    mem_summary = {
        "argument_size_in_bytes": int(notes["argument_bytes"]),
        "temp_size_in_bytes": int(cost.peak_bytes),
        "output_size_in_bytes": meta.block_bytes(trace.output),
    }
    by = meta.totals(trace.collectives)
    colls = {}
    for kind, name in _KIND_NAMES.items():
        if kind in by:
            colls[name] = colls.get(name, 0) + by[kind]
    n_chips = mesh.size
    mf = analysis.model_flops_estimate(cfg, shape, shape.mode)
    roof = analysis.derive_roofline(
        arch_name, shape.name, mesh_name, n_chips, cost.flops, cost.bytes,
        colls, mf, bytes_per_device=mem_summary["argument_size_in_bytes"]
        + mem_summary["temp_size_in_bytes"])
    train_graph = shape.mode == "train" and pods > 1
    pod_exchange = None
    if train_graph:
        pex = graph_audit.pod_exchange_report(trace, devices_per_pod(mesh))
        pod_exchange = {
            "permute_cross_gbytes_per_dev": pex.permute_cross_bytes / 1e9,
            "permute_local_gbytes_per_dev": pex.permute_local_bytes / 1e9,
            "reduce_cross_gbytes_per_dev": pex.reduce_cross_bytes / 1e9,
            "reduce_local_gbytes_per_dev": pex.reduce_local_bytes / 1e9,
            "cross_pod_gbytes_per_dev": pex.cross_pod_bytes / 1e9,
            "pod_axis_only": pex.pod_axis_only,
            "unparsed_collectives": pex.unparsed,
        }
        if gossip and not trace.host_syncs:
            pod_exchange["topology"] = topology
            pod_exchange["ring_permute_gbytes_per_dev"] = (
                notes["degree"] * notes["model_bytes"] / 1e9)
            if not pex.pod_axis_only:
                raise RuntimeError(
                    f"{strategy} exchange leaked off the pod axis: a "
                    "collective joins ranks of several pods off it")
            if pex.permute_cross_bytes <= 0:
                raise RuntimeError(
                    f"{strategy} traced no cross-pod all_gather or "
                    "all_to_all: the gossip exchange vanished")
            if pex.reduce_cross_bytes >= pex.permute_cross_bytes:
                raise RuntimeError(
                    f"{strategy}: cross-pod reduction bytes "
                    f"({pex.reduce_cross_bytes:.0f}) rival the exchange "
                    f"({pex.permute_cross_bytes:.0f}): the gossip is "
                    "leaking into reduction collectives")
            if pex.unparsed:
                raise RuntimeError(
                    f"{strategy}: {pex.unparsed} collective(s) the pod "
                    "report cannot classify (a gather or barrier in the "
                    "step, or an axis not the mesh's): cross-pod byte "
                    "totals would understate the exchange")
    audit = ga.to_json()
    hard_fail = audit_fail == "all" or (audit_fail == "gossip" and gossip)
    if hard_fail and ga.findings:
        raise RuntimeError(
            f"{strategy or shape.mode}: graph audit failed — "
            + "; ".join(f"{f.rule} {f.message}" for f in ga.findings))
    cost_json: Dict = {
        "flops": cost.flops, "bytes accessed": cost.bytes,
        "launches": {k: v["launches"] for k, v in cost.kernels.items()},
        "kernels": {k: {"flops": v["flops"], "bytes": v["bytes"]}
                    for k, v in cost.kernels.items()},
    }
    if trace.host_syncs:
        cost_json["traced_to_host_sync"] = trace.host_syncs[0]
    report = {
        "arch": arch_name, "shape": shape.name, "mesh": mesh_name,
        "mode": shape.mode,
        "strategy": strategy if shape.mode == "train" else None,
        "ok": True,
        "pod_exchange": pod_exchange,
        "audit": audit,
        "step_audit": sa.to_json(),
        "memory": mem_summary,
        "cost": cost_json,
        "roofline": {
            "t_compute_ms": roof.t_compute * 1e3,
            "t_memory_ms": roof.t_memory * 1e3,
            "t_collective_ms": roof.t_collective * 1e3,
            "bottleneck": roof.bottleneck,
            "hlo_gflops_per_dev": roof.hlo_gflops,
            "hlo_gbytes_per_dev": roof.hlo_gbytes,
            "coll_gbytes_per_dev": roof.coll_gbytes,
            "coll_breakdown_gb": roof.coll_breakdown,
            "coll_by_axis_gb": {k: v / 1e9 for k, v in by.items()
                                if "@" in k},
            "model_gflops_per_dev": roof.model_gflops,
            "useful_ratio": roof.useful_ratio,
        },
    }
    if shape.mode == "decode":
        report["placement"] = {"batch_sharded": notes["batch_sharded"],
                               "reference_batch_sharded":
                                   shape.global_batch >= 8}
    if verbose:
        print(f"[dryrun] {arch_name} x {shape.name} on {mesh_name}: OK  "
              f"bottleneck={roof.bottleneck} "
              f"t=(c {roof.t_compute*1e3:.2f} / m {roof.t_memory*1e3:.2f} / "
              f"x {roof.t_collective*1e3:.2f}) ms  "
              f"useful={roof.useful_ratio:.2f}")
        print(f"         memory: {json.dumps(mem_summary)}")
        if pod_exchange is not None:
            print(f"         cross-pod exchange: "
                  f"{pod_exchange['cross_pod_gbytes_per_dev']:.4f} GB/dev "
                  f"(permute {pod_exchange['permute_cross_gbytes_per_dev']:.4f}"
                  f" / reduce {pod_exchange['reduce_cross_gbytes_per_dev']:.4f}"
                  f", pod_axis_only={pod_exchange['pod_axis_only']})")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--all-combos", action="store_true",
                    help="trace + graph-audit the whole audit matrix "
                         "(iter_combos): every strategy x topology combo "
                         "plus prefill/decode, reduced config on the "
                         f"{SWEEP_MESH} mesh")
    ap.add_argument("--strict-audit", action="store_true",
                    help="fail on ANY graph-audit finding, serve/prefill "
                         "steps included (default: only gossip strategies "
                         "hard-fail)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--strategy", default="gaia", choices=list(STRATEGIES))
    ap.add_argument("--topology", default="ring",
                    help="gossip fabric over the pod set (dpsgd/adpsgd): "
                         "ring | torus | full | random | geo-wan | "
                         "dcliques | tv-dcliques | random-matching")
    ap.add_argument("--staleness", type=int, default=None,
                    help="adpsgd staleness rung (default: max-staleness)")
    ap.add_argument("--max-staleness", type=int, default=2,
                    help="adpsgd snapshot-buffer depth")
    ap.add_argument("--mesh", default=None,
                    help="override mesh shape, e.g. 2,2,2 (pod,data,model)"
                         " or 16,16 (data,model)")
    ap.add_argument("--reduced", action="store_true",
                    help="trace the reduced() config instead of the "
                         "full-size arch")
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--outdir", default=None,
                    help="per-combo JSON dir; existing results are skipped")
    args = ap.parse_args(argv)
    try:
        mesh_override = _parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))

    combos = []
    if args.all_combos:
        args.mesh = args.mesh or SWEEP_MESH
        mesh_override = mesh_override or _parse_mesh(args.mesh)
        args.reduced = True
        for sh, st, tp in iter_combos():
            combos.append((SWEEP_ARCH, sh, st, tp))
    elif args.all:
        for a in ARCH_IDS:
            for s in INPUT_SHAPES:
                combos.append((a, s, args.strategy, args.topology))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape, --all, or --all-combos")
        combos = [(args.arch, args.shape, args.strategy, args.topology)]
    # no communication strategy applies to the serve steps
    combos = [(a, s, strat, topo) if INPUT_SHAPES[s].mode == "train"
              else (a, s, None, None) for a, s, strat, topo in combos]

    audit_fail = "all" if args.strict_audit else "gossip"

    def cfg_tag(strategy, topology):
        # every knob that changes a report, or a cached JSON of another
        # configuration would come back as this run's result
        return "__".join(
            [strategy or "serve", "multi" if args.multi_pod else "single"]
            + ([f"mesh{args.mesh.replace(',', 'x')}"] if args.mesh else [])
            + (["reduced"] if args.reduced else [])
            + ([f"chunk{args.chunk}"] if args.chunk != 512 else [])
            + (["noremat"] if args.no_remat else [])
            + (["strict"] if args.strict_audit else [])
            + ([f"{topology}",
                f"s{args.staleness}of{args.max_staleness}"]
               if strategy in GOSSIP_STRATEGIES else []))

    reports, failures = [], []
    for a, s, strat, topo in combos:
        tag = f"{a}__{s}__{cfg_tag(strat, topo)}"
        path = os.path.join(args.outdir, tag + ".json") if args.outdir \
            else None
        if path and os.path.exists(path):
            with open(path) as f:
                rep = json.load(f)
            (reports if rep.get("ok") else failures).append(rep)
            print(f"[dryrun] {tag}: cached "
                  f"({'ok' if rep.get('ok') else 'FAILED'})")
            continue
        try:
            rep = dryrun_one(
                a, s, multi_pod=args.multi_pod, strategy=strat,
                topology=topo, staleness=args.staleness,
                max_staleness=args.max_staleness,
                reduced=args.reduced,
                mesh=mesh_override,
                chunk=args.chunk, remat=not args.no_remat,
                audit_fail=audit_fail)
            reports.append(rep)
        except Exception as e:  # repro-allow: RA104 — the sweep records
            #                     the failure row and goes on
            traceback.print_exc()
            rep = {"arch": a, "shape": s, "ok": False,
                   "error": f"{type(e).__name__}: {e}"}
            failures.append(rep)
        if path:
            os.makedirs(args.outdir, exist_ok=True)
            with open(path, "w") as f:
                json.dump(rep, f, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(reports + failures, f, indent=1)
    print(f"[dryrun] {len(reports)} ok, {len(failures)} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
