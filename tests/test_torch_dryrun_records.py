"""The dry-run stand-in's collective records against real runs, on the
CPU: gloo ranks started by ``repro_torch.launch.procs.spawn`` run one
step each with rank 0's mesh recording its collectives
(``launch.meta.record_collectives``), and the stand-in traces the same
step for rank 0 of a ``MetaMesh`` of the same shape (``launch.dryrun.
build_step`` with the run's ``InputShape``).  The two records must be
equal entry for entry: kind, axis, shape and dtype, in call order.

- (1, 2, 2), four ranks: one bsp train step and one prefill of a reduced
  arch of each family: dense GQA (qwen3-0.6b), MLA + MoE under the dense
  route and under the expert-parallel one (deepseek-v2-lite-16b; the
  reference's ``REPRO_MOE_EP``), the SSM (mamba2-780m), the RG-LRU hybrid
  (recurrentgemma-2b), the enc-dec (seamless-m4t-large-v2, frames) and
  the VLM (phi-3-vision-4.2b, patches);
- (2, 1, 1), two ranks: one dpsgd and one adpsgd step of the reduced
  qwen3-0.6b over a ring of two pods (AD-PSGD's all-to-all splits are
  built per pod rank: rank 0's).

The flash_attention launches the stand-in counts are held against the
plain route's calls on the CPU too: a CPU run launches no kernel, so
the ranks count the calls of ``ops.flash_attention_bthd``'s forward.
"""
import dataclasses

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro_torch import pytree
from repro_torch.configs.base import CommConfig, FabricConfig, InputShape
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, meta, procs, sharding, specs, steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model
from repro_torch.topology.graphs import build_demo_schedule

SPAWN_TIMEOUT = 300
#: (label, arch, MoE route)
FAMILIES = (("gqa", "qwen3-0.6b", "dense"),
            ("mla-moe-dense", "deepseek-v2-lite-16b", "dense"),
            ("mla-moe-ep", "deepseek-v2-lite-16b", "ep"),
            ("ssm", "mamba2-780m", "dense"),
            ("rglru", "recurrentgemma-2b", "dense"),
            ("encdec", "seamless-m4t-large-v2", "dense"),
            ("vlm", "phi-3-vision-4.2b", "dense"))
GOSSIP = ("dpsgd", "adpsgd")
#: the text tokens of a sequence; a VLM's sequence adds its patches
TEXT_T = 32
#: requests a prefill, sequences a pod's train step
PREFILL_B, TRAIN_B = 2, 2


def _shape(cfg, mode: str, pods: int = 1) -> InputShape:
    extra = cfg.modality.n_tokens if cfg.modality.kind == "vision" else 0
    batch = PREFILL_B if mode == "prefill" else TRAIN_B * pods
    return InputShape(f"records_{mode}", TEXT_T + extra, batch, mode)


def _fill(specs_, seed: int, vocab: int):
    """Seeded values for a batch spec: tokens and labels in the
    vocabulary, patches and frames standard normal."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shape, dtype) in specs_.items():
        if dtype.is_floating_point:
            out[k] = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dtype)
        else:
            out[k] = torch.from_numpy(rng.integers(0, vocab, shape)).to(
                dtype)
    return out


def _counted_flash():
    """Count the calls of the attention forward (the kernel's launches on
    the card) by wrapping ``ops._flash_bthd_forward``."""
    calls = [0]
    real = ops._flash_bthd_forward

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)
    return calls, real, counted


def _keys(records):
    return [r.key() for r in records]


def _family_rank(rank, dev):
    mesh = make_mesh((1, 2, 2), device=dev)
    out = {}
    for label, arch, route in FAMILIES:
        cfg = get_config(arch).reduced()
        params = model.init_model(torch.Generator().manual_seed(0), cfg,
                                  "cpu")
        comm = CommConfig(strategy="bsp")
        state = steps.make_train_state(params, comm, 1, mesh=mesh)
        batch = _fill(specs.train_batch_specs(
            cfg, _shape(cfg, "train"), n_pods=1), 1, cfg.vocab)
        step = steps.make_train_step(cfg, comm, mesh=mesh, moe_route=route)
        calls, real, counted = _counted_flash()
        ops._flash_bthd_forward = counted
        try:
            with meta.record_collectives(mesh) as train:
                step(state, batch, 0)
            n_train = calls[0]
            calls[0] = 0
            prefill = steps.make_prefill_step(cfg, mesh=mesh,
                                              moe_route=route)
            pbatch = _fill(specs.prefill_batch_specs(
                cfg, _shape(cfg, "prefill")), 2, cfg.vocab)
            with meta.record_collectives(mesh) as pre, torch.no_grad():
                prefill(sharding.local_params(params, mesh), pbatch)
        finally:
            ops._flash_bthd_forward = real
        out[label] = {"train": _keys(train), "prefill": _keys(pre),
                      "train_flash": n_train, "prefill_flash": calls[0]}
    return out if rank == 0 else None


def _gossip_rank(rank, dev):
    mesh = make_mesh((2, 1, 1), device=dev)
    cfg = get_config("qwen3-0.6b").reduced()
    params = model.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    sched = build_demo_schedule("ring", 2)
    batch = _fill(specs.train_batch_specs(cfg, _shape(cfg, "train", 2),
                                          n_pods=2), 3, cfg.vocab)
    out = {}
    for strategy in GOSSIP:
        comm = CommConfig(strategy=strategy,
                          fabric=FabricConfig(topology="ring"))
        mix = steps.gossip_operands(
            sched, 0, device="cpu", mesh=mesh,
            **({"staleness": comm.max_staleness,
                "max_staleness": comm.max_staleness}
               if strategy == "adpsgd" else {}))
        state = steps.make_train_state(params, comm, 2, mesh=mesh)
        step = steps.make_train_step(cfg, comm, mesh=mesh)
        with meta.record_collectives(mesh) as got:
            step(state, batch, 0, mix=mix)
        out[strategy] = _keys(got)
    with meta.record_collectives(mesh) as got:      # checkpoint plumbing
        mesh.barrier()
        mesh.gather(torch.ones(1, 3))
    out["plumbing"] = _keys(got)
    assert "all_reduce" not in vars(mesh)           # the class's again
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def family_runs():
    return procs.spawn(_family_rank, 4, backend="gloo", device="cpu",
                       timeout=SPAWN_TIMEOUT)[0]


@pytest.fixture(scope="module")
def gossip_runs():
    return procs.spawn(_gossip_rank, 2, backend="gloo", device="cpu",
                       timeout=SPAWN_TIMEOUT)[0]


def _standin(cfg, shape, mesh_shape, strategy, route, monkeypatch):
    if route == "ep":
        monkeypatch.setenv("REPRO_MOE_EP", "1")
    else:
        monkeypatch.delenv("REPRO_MOE_EP", raising=False)
    mesh = meta.MetaMesh(mesh_shape)
    step, args, notes = dryrun.build_step(cfg, shape, strategy=strategy,
                                          topology="ring", mesh=mesh)
    return meta.trace_step(step, args, notes["mesh"])


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("label,arch,route", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_meta_mesh_records_equal_a_gloo_run(family_runs, monkeypatch,
                                            label, arch, route, mode):
    cfg = get_config(arch).reduced()
    trace = _standin(cfg, _shape(cfg, mode), (1, 2, 2),
                     "bsp" if mode == "train" else None, route, monkeypatch)
    got = _keys(trace.collectives)
    want = family_runs[label][mode]
    assert len(want) > 0
    assert got == want
    assert trace.cost.kernels.get("flash_attention", {}).get(
        "launches", 0) == family_runs[label][f"{mode}_flash"]


@pytest.mark.parametrize("strategy", GOSSIP)
def test_meta_mesh_gossip_records_equal_a_gloo_run(gossip_runs, monkeypatch,
                                                   strategy):
    cfg = get_config("qwen3-0.6b").reduced()
    trace = _standin(cfg, _shape(cfg, "train", 2), (2, 1, 1), strategy,
                     "dense", monkeypatch)
    got = _keys(trace.collectives)
    assert got == gossip_runs[strategy]
    kinds = {k[0] for k in got}
    assert ("all_gather" if strategy == "dpsgd" else "all_to_all") in kinds


def test_meta_mesh_keeps_the_size_one_shortcut():
    """An axis of one rank records nothing, as ``Mesh`` sends nothing;
    the pod axis records even at one pod, as ``Mesh`` calls it."""
    mesh = meta.MetaMesh((1, 1, 2))
    x = torch.empty(4, 3, device="meta")
    assert mesh.all_reduce(x, "data") is x
    assert mesh.all_gather_dim(x, 0, "data") is x
    mesh.all_reduce(x)
    y = mesh.all_gather_dim(x, 1, "model")
    z = mesh.reduce_scatter_dim(torch.empty(4, 6, device="meta"), 1, "model")
    assert tuple(y.shape) == (4, 6) and tuple(z.shape) == (4, 3)
    assert [r.kind for r in mesh.records] == ["all_reduce", "all_gather_dim",
                                              "reduce_scatter_dim"]
    assert [r.wire_bytes for r in mesh.records] == [0, 48, 48]
    assert dataclasses.replace(mesh.records[0], wire_bytes=1).key() == \
        mesh.records[0].key()
    assert all(t.device.type == "meta" for t in pytree.leaves({"y": y,
                                                               "z": z}))


def test_barrier_and_gather_are_one_record_each(gossip_runs):
    """A barrier is one record (not its two all-reduces), a gather
    another, on a gloo mesh and on a ``MetaMesh``; the graph audit calls
    both unclassifiable inside a step (GA205)."""
    from repro_torch.analysis import graph_audit
    mesh = meta.MetaMesh((2, 1, 1))
    mesh.barrier()
    got = mesh.gather(torch.empty(1, 3, device="meta"))
    assert tuple(got.shape) == (2, 3)
    assert _keys(mesh.records) == gossip_runs["plumbing"] == [
        ("barrier", ("data", "model"), (), ""),
        ("gather", "pod", (1, 3), "float32")]
    trace = meta.Trace(list(mesh.records), mesh.axis_names, 2, [], {},
                       meta.CostMode(), 0)
    audit = graph_audit.audit_trace(trace, devices_per_pod=1)
    assert [f.rule for f in audit.findings] == ["GA205"]
    assert audit.pod_exchange.unparsed == 2
