"""The dry-run stand-in (``repro_torch.launch.dryrun``) on the CPU, with no
card: its pieces against the JAX reference's, the kernel ops' meta
routes against their plain versions, the audit's findings, the refused
combos and two full-width rows.

- Per-leaf blocks: for each of the ten archs, on (16, 16) and (2, 16,
  16), the stand-in's per-rank block of every parameter, train-state (bsp
  and adpsgd), decode-cache (decode_32k, and long_500k's one request with
  the cache's length over ``data``) and batch leaf equals
  ``NamedSharding(AbstractMesh(...), spec).shard_shape(...)`` of the
  reference's placements, whole where its clamp keeps a dimension whole
  (heads and vocabularies ``model`` does not divide); the per-rank
  argument bytes are equal too (AD-PSGD's snapshot buffers are the
  port's flat per-dtype ones: their bytes are held, not their leaves).
- ``model_flops_estimate``: equal to the reference's, bit for bit, for
  ten archs x four shapes; ``iter_combos`` and the sweep constants equal
  the reference's (read in a subprocess: importing ``repro.launch.
  dryrun`` sets ``XLA_FLAGS`` for 512 host devices).
- The meta routes: each public op of ``kernels/ops.py`` gives the plain
  version's output shapes and dtypes on ``meta``, counts no launch,
  never reaches ``torch.bincount``, and hands the cost counter one entry
  a launch (``flash_attention``'s flops are ``ops.attention_work``'s).
- Findings: a host read inside a step is GA203 and fails the combo under
  ``--strict-audit``; an exchange that widens bf16 rows to float32 on the
  pod axis is GA202.
- The five archs ``check_layout`` refused on the production meshes until
  their heads and vocabularies were taken whole (ROADMAP C17), and
  long_500k's one request (C18): their rows are ok, and ``main`` returns
  0.
- Two full-width rows on (2, 16, 16): qwen3-0.6b train_4k under bsp and
  deepseek-v2-lite-16b decode_32k.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro_torch import pytree
from repro_torch.configs.base import CommConfig, INPUT_SHAPES, InputShape
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.kernels import ops, ref as tref
from repro_torch.launch import analysis, dryrun, meta, sharding, steps

ROOT = Path(__file__).resolve().parents[1]
#: the archs the port places on the production meshes: all ten
PLACED = ARCH_IDS
#: the archs ``check_layout`` refused there before the model code took
#: their heads and vocabularies whole (ROADMAP C17), with the width each
#: refusal named
REFUSED = {"recurrentgemma-2b": "n_heads=10", "starcoder2-3b": "n_heads=24",
           "minicpm3-4b": "n_heads=40", "mamba2-780m": "vocab=50280",
           "seamless-m4t-large-v2": "vocab=256206"}


@pytest.fixture(scope="module")
def ref():
    """The JAX reference's placements, imported here only."""
    import jax
    from jax.sharding import AbstractMesh, NamedSharding
    from repro.configs import base, registry
    from repro.launch import analysis as janalysis
    from repro.launch import sharding as jsh
    from repro.launch import specs as jsp
    from repro.launch import steps as jst
    return types.SimpleNamespace(
        jax=jax, base=base, get_config=registry.get_config, sharding=jsh,
        specs=jsp, steps=jst, analysis=janalysis,
        NamedSharding=NamedSharding,
        mesh=lambda m: AbstractMesh(m, ("pod", "data", "model")[-len(m):]))


def _blocks(ref, tree, shardings, jmesh):
    """The per-device block shape of every leaf of a reference tree of
    shapes, in leaf order."""
    leaves = ref.jax.tree_util.tree_leaves(tree)
    specs_ = ref.jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda y: hasattr(y, "spec"))
    return [tuple(ref.NamedSharding(jmesh, getattr(s, "spec", s))
                  .shard_shape(tuple(x.shape))) for x, s in
            zip(leaves, specs_, strict=True)]


def _nbytes(ref, tree, blocks) -> int:
    return sum(math.prod(b) * x.dtype.itemsize for x, b in zip(
        ref.jax.tree_util.tree_leaves(tree), blocks))


def _shapes(tree):
    return [tuple(t.shape) for t in pytree.leaves(tree)]


@pytest.mark.parametrize("mesh_shape", [(16, 16), (2, 16, 16)],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", PLACED)
def test_blocks_and_argument_bytes_match_reference(ref, arch, mesh_shape):
    cfg, jcfg = get_config(arch), ref.get_config(arch)
    jmesh = ref.mesh(mesh_shape)
    mesh = dryrun._parse_mesh(",".join(map(str, mesh_shape)))
    pods = dryrun.mesh_n_pods(mesh)

    # parameters (a serve step's arguments) and the prefill batch
    jp = ref.steps.param_shape(jcfg)
    want_p = _blocks(ref, jp, ref.sharding.param_shardings(jp, jmesh), jmesh)
    serve = dryrun._serve_mesh(mesh)
    assert _shapes(sharding.local_params(steps.param_shape(cfg), serve)) == \
        want_p
    p_bytes = _nbytes(ref, jp, want_p)
    _, _, notes = dryrun.build_step(arch, "prefill_32k", mesh=mesh)
    jb = ref.specs.input_specs(jcfg, "prefill_32k")
    b_blocks = _blocks(ref, jb, ref.sharding.batch_shardings(
        jb, jmesh, pod_stacked=False), jmesh)
    assert notes["argument_bytes"] == p_bytes + _nbytes(ref, jb, b_blocks)

    # the train state under bsp and adpsgd, and the train batch
    for strategy in ("bsp", "adpsgd"):
        comm = CommConfig(strategy=strategy)
        jstate = ref.steps.train_state_shape(
            jcfg, ref.base.CommConfig(strategy=strategy), pods)
        want = {k: _blocks(ref, v, s, jmesh) for (k, v), s in zip(
            jstate.items(), ref.sharding.train_state_shardings(
                jstate, jmesh).values())}
        state = steps.make_train_state(steps.param_shape(cfg), comm, pods,
                                       mesh=mesh)
        for k in ("params", "vel"):
            assert _shapes(state[k]) == want[k], k
        want_bytes = sum(_nbytes(ref, jstate[k], want[k]) for k in jstate)
        assert meta.block_bytes(state) == want_bytes, strategy
        if strategy == "bsp":
            _, _, notes = dryrun.build_step(arch, "train_4k", strategy="bsp",
                                            mesh=mesh)
            jb = ref.specs.input_specs(jcfg, "train_4k", n_pods=pods)
            b_blocks = _blocks(ref, jb, ref.sharding.batch_shardings(
                jb, jmesh, pod_stacked=True), jmesh)
            assert notes["argument_bytes"] == want_bytes + _nbytes(
                ref, jb, b_blocks)

    # the decode cache (the reference's B >= 8 placement) and its batch
    shape = INPUT_SHAPES["decode_32k"]
    jc = ref.steps.cache_shape(jcfg, shape.global_batch, shape.seq_len)
    want_c = _blocks(ref, jc, ref.sharding.cache_shardings(
        jc, jmesh, batch_sharded=True), jmesh)
    step, args, notes = dryrun.build_step(arch, "decode_32k", mesh=mesh)
    assert notes["batch_sharded"] is True
    assert _shapes(args[1]) == want_c
    jb = ref.specs.input_specs(jcfg, "decode_32k")
    b_blocks = _blocks(ref, jb, ref.sharding.batch_shardings(
        jb, jmesh, pod_stacked=False), jmesh)
    assert notes["argument_bytes"] == p_bytes + _nbytes(
        ref, jc, want_c) + _nbytes(ref, jb, b_blocks)

    # long_500k's one request: whole on every rank, the cache's length
    # over data (the reference's batch_sharded=False)
    shape = INPUT_SHAPES["long_500k"]
    jc = ref.steps.cache_shape(jcfg, shape.global_batch, shape.seq_len,
                               long_mode=True)
    want_c = _blocks(ref, jc, ref.sharding.cache_shardings(
        jc, jmesh, batch_sharded=False), jmesh)
    _, args, notes = dryrun.build_step(arch, "long_500k", mesh=mesh)
    assert notes["batch_sharded"] is False
    assert _shapes(args[1]) == want_c
    jb = ref.specs.input_specs(jcfg, "long_500k")
    b_blocks = _blocks(ref, jb, ref.sharding.batch_shardings(
        jb, jmesh, pod_stacked=False), jmesh)
    assert notes["argument_bytes"] == p_bytes + _nbytes(
        ref, jc, want_c) + _nbytes(ref, jb, b_blocks)


@pytest.mark.parametrize("shape_name", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_estimate_is_the_reference_arithmetic(ref, arch,
                                                         shape_name):
    shape = INPUT_SHAPES[shape_name]
    got = analysis.model_flops_estimate(get_config(arch), shape, shape.mode)
    want = ref.analysis.model_flops_estimate(
        ref.get_config(arch), ref.base.INPUT_SHAPES[shape_name], shape.mode)
    assert got == want and type(got) is type(want)


def test_iter_combos_and_sweep_constants_are_the_reference():
    code = ("import json; from repro.launch import dryrun as d; print(json."
            "dumps([list(d.iter_combos()), list(d.iter_combos(False)), "
            "d.STRATEGIES, d.GOSSIP_TOPOLOGIES, d.SWEEP_ARCH, d.SWEEP_SHAPE,"
            " d.SWEEP_MESH, d.AUDIT_FAIL_MODES]))")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True, timeout=300)
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = [list(dryrun.iter_combos()), list(dryrun.iter_combos(False)),
           dryrun.STRATEGIES, dryrun.GOSSIP_TOPOLOGIES, dryrun.SWEEP_ARCH,
           dryrun.SWEEP_SHAPE, dryrun.SWEEP_MESH, dryrun.AUDIT_FAIL_MODES]
    assert json.loads(json.dumps(got)) == want
    assert len(want[0]) == 22


# ---------------------------------------------------------------------------
# The kernel ops' meta routes
# ---------------------------------------------------------------------------

def _op_calls():
    """(name, kernel count name, launches, fn(device)) of every public op,
    on seeded inputs made on the CPU and moved to the device asked."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s, dt=torch.float32: torch.randn(*s, generator=g).to(dt)
    K, D = 4, 2
    idx = np.array([[1, 3], [0, 2], [1, 3], [2, 0]], np.int32)
    w, sw = np.full((K, D), 0.25, np.float32), np.full(K, 0.5, np.float32)
    x = r(K, 6)
    xs = [r(K, 3, 2, dt=torch.bfloat16), r(K, 5, dt=torch.bfloat16)]
    src = r(8, 11, dt=torch.bfloat16)
    snaps = r(3, K, 11, dt=torch.bfloat16)
    v, vw = r(1000), r(1000)
    gn = r(2, 4, 4, 8)
    q, k_, v_ = r(1, 64, 4, 64), r(1, 64, 2, 64), r(1, 64, 2, 64)
    qh, kh, vh = r(1, 2, 64, 64), r(1, 2, 64, 64), r(1, 2, 64, 64)
    mo = lambda n, dev: ops.mix_operands(idx, w, sw, n, dev)
    to = lambda t, dev: t.to(dev)
    return [
        ("gaia_select", "gaia_select", 1,
         lambda d: ops.gaia_select(to(v, d), to(vw, d), 0.1)),
        ("gaia_select_many", "gaia_select", 1,
         lambda d: ops.gaia_select_many([to(v, d), to(x, d)],
                                        [to(vw, d), to(x, d)], 0.1)),
        ("neighbor_mix", "neighbor_mix", 1,
         lambda d: ops.neighbor_mix(to(x, d), *(to(torch.from_numpy(a), d)
                                                for a in (idx, w, sw)))),
        ("neighbor_mix_src", "neighbor_mix_src", 1,
         lambda d: ops.neighbor_mix(to(x, d), *(to(torch.from_numpy(a), d)
                                                for a in (idx, w, sw)),
                                    src=to(r(6, 6), d))),
        ("neighbor_mix_many", "neighbor_mix", 1,
         lambda d: ops.neighbor_mix_many([to(t, d) for t in xs], mo(K, d))),
        ("neighbor_mix_push_many", "neighbor_mix_src", 1,
         lambda d: ops.neighbor_mix_push_many([to(t, d) for t in xs],
                                              to(snaps, d), mo(3 * K, d))),
        ("neighbor_mix_src_many", "neighbor_mix_src", 1,
         lambda d: ops.neighbor_mix_src_many([to(t, d) for t in xs],
                                             to(src, d), mo(8, d))),
        ("rand_k_sparsify", "rand_k_select", 1,
         lambda d: ops.rand_k_sparsify(to(v, d), 0.3, 7)),
        ("rand_k_sparsify_many", "rand_k_select", 2,
         lambda d: ops.rand_k_sparsify_many(
             [to(v, d)] * 33, [to(vw, d)] * 33, 0.3, list(range(33)),
             [None] * 33)),
        ("abs_histogram", "abs_histogram", 1,
         lambda d: ops.abs_histogram(to(v, d), 2.0)),
        ("abs_histogram_fused", "abs_histogram_fused", 1,
         lambda d: ops.abs_histogram_fused(to(v, d))),
        ("dgc_select", "dgc_select", 1,
         lambda d: ops.dgc_select(to(v, d), 0.5)),
        ("dgc_sparsify", "dgc_sparsify", 1,
         lambda d: ops.dgc_sparsify(to(v, d), 0.9)),
        ("group_norm", "group_norm", 1,
         lambda d: ops.group_norm(to(gn, d), to(torch.ones(8), d),
                                  to(torch.zeros(8), d), group_size=2)),
        ("flash_attention", "flash_attention", 1,
         lambda d: ops.flash_attention(to(qh, d), to(kh, d), to(vh, d),
                                       window=16)),
        ("flash_attention_bthd", "flash_attention", 1,
         lambda d: ops.flash_attention_bthd(to(q, d), to(k_, d), to(v_, d))),
    ]


def _outs(x):
    return [t for t in pytree.leaves(list(x) if isinstance(x, (tuple, list))
                                     else [x])]


@pytest.mark.parametrize("name,kernel,n,call", _op_calls(),
                         ids=[c[0] for c in _op_calls()])
def test_meta_route_gives_the_plain_shapes(monkeypatch, name, kernel, n,
                                           call):
    want = _outs(call("cpu"))
    before = dict(ops.launches)

    def no_bincount(*a, **kw):
        raise AssertionError("the meta route reached torch.bincount")
    monkeypatch.setattr(torch, "bincount", no_bincount)
    monkeypatch.setattr(tref.torch, "bincount", no_bincount)
    with meta.CostMode() as cost:
        got = _outs(call("meta"))
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.device.type == "meta" for t in got)
    assert ops.launches == before
    assert cost.kernels[kernel]["launches"] == n
    assert set(cost.kernels) == {kernel}
    assert cost.kernels[kernel]["bytes"] > 0
    if kernel == "flash_attention":
        want_flops = (ops.attention_work(1, 2, 2, 64, 64, 64, 64, 4, True, 16)
                      if name == "flash_attention" else
                      ops.attention_work(1, 4, 2, 64, 64, 64, 64, 4, True,
                                         None))
        assert (cost.kernels[kernel]["flops"],
                cost.kernels[kernel]["bytes"]) == want_flops


def test_attention_pairs_count_the_masks():
    T = 64
    assert ops.attention_pairs(T, T, True, None) == T * (T + 1) // 2
    assert ops.attention_pairs(T, T, False, None) == T * T
    assert ops.attention_pairs(1, T, True, None) == T
    assert ops.attention_pairs(T, T, True, 8) == sum(min(i + 1, 8)
                                                     for i in range(T))
    assert ops.attention_work(2, 4, 2, T, T, 64, 64, 2, True, None)[0] == \
        4 * 2 * 4 * 64 * T * (T + 1) // 2


def test_flash_attention_backward_on_meta_is_counted_op_by_op():
    """The attention's autograd route on ``meta``: the forward one kernel
    entry, the backward the plain float32 backward's aten ops."""
    q, k, v = (torch.empty(1, 128, 4, 64, device="meta", requires_grad=True)
               for _ in range(3))
    with meta.CostMode() as cost:
        out = ops.flash_attention_bthd(q, k, v)
        fwd = cost.flops
        grads = torch.autograd.grad(out.sum(), (q, k, v))
    assert cost.kernels["flash_attention"]["launches"] == 1
    assert cost.flops > 2 * fwd
    assert [tuple(g.shape) for g in grads] == [(1, 128, 4, 64)] * 3


def test_cost_mode_counts_live_storage_and_host_reads():
    a = torch.empty(256, 256, device="meta")
    with meta.CostMode(arguments=(a,)) as cost:
        b = a @ a                                   # 256 KiB made
        c = b.t()                                   # a view: none
        del b
        d = c + 1                                   # 256 KiB more, b alive
        del c, d
    assert cost.peak_bytes == 2 * 256 * 256 * 4
    assert cost.live == 0
    assert cost.flops == 2 * 256 ** 3
    with pytest.raises(meta.HostSync, match="_local_scalar_dense"):
        with meta.CostMode():
            a.sum().item()
    with pytest.raises(meta.HostSync, match="_to_copy"):
        with meta.CostMode():
            a.tolist()


# ---------------------------------------------------------------------------
# Findings, refusals, full-width rows
# ---------------------------------------------------------------------------

def test_host_read_in_a_step_is_ga203_and_fails_under_strict(monkeypatch,
                                                             tmp_path):
    real = dryrun.make_prefill_step

    def synced(*a, **kw):
        step = real(*a, **kw)

        def read(params, batch):
            logits = step(params, batch)
            logits.sum().item()                     # a host read
            return logits
        return read
    monkeypatch.setattr(dryrun, "make_prefill_step", synced)
    rep = dryrun.dryrun_one("qwen3-0.6b", InputShape("p", 64, 4, "prefill"),
                            reduced=True, mesh=dryrun._parse_mesh("1,2,2"),
                            verbose=False)
    assert rep["ok"] and [f["rule"] for f in rep["audit"]["findings"]] == \
        ["GA203"]
    assert "_local_scalar_dense" in rep["audit"]["findings"][0]["message"]
    assert rep["cost"]["traced_to_host_sync"].startswith(
        "aten._local_scalar_dense")
    out = tmp_path / "rows.json"
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "prefill_32k",
                        "--reduced", "--mesh", "1,2,2", "--strict-audit",
                        "--out", str(out)]) == 1
    (row,) = json.loads(out.read_text())
    assert not row["ok"] and "GA203" in row["error"]


def test_widened_exchange_is_ga202():
    """A D-PSGD exchange whose pod-axis all_gather ships the bf16 group's
    rows as float32 (a one-layer cut of qwen3-0.6b, bf16 weights and
    float32 norms)."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=1)
    shape = InputShape("t", 64, 4, "train")
    mesh = meta.MetaMesh((2, 1, 1))
    kw = dict(strategy="dpsgd", topology="ring", mesh=mesh, verbose=False)
    clean = dryrun.dryrun_one(cfg, shape, **kw)
    assert clean["audit"]["findings"] == []
    assert clean["audit"]["cross_pod_dtype_bytes"].keys() == {"bfloat16",
                                                              "float32"}
    real = mesh.all_gather
    mesh.all_gather = lambda x: real(x.float()).to(x.dtype)
    with pytest.raises(RuntimeError, match="GA202"):
        dryrun.dryrun_one(cfg, shape, **kw)
    rep = dryrun.dryrun_one(cfg, shape, audit_fail="none", **kw)
    rules = [f["rule"] for f in rep["audit"]["findings"]]
    assert rules == ["GA202"]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_refused_archs_are_failure_rows(tmp_path, multi_pod):
    """The five archs once refused (their rows carried the width in
    ``REFUSED``) at long_500k, whose one request was refused as well: ok
    rows, each with the whole-batch placement, no finding."""
    out = tmp_path / "rows.json"
    rows = []
    for arch in REFUSED:
        assert dryrun.main(["--arch", arch, "--shape", "long_500k", "--out",
                            str(out)] + (["--multi-pod"] if multi_pod
                                         else [])) == 0
        rows += json.loads(out.read_text())
    for arch, row in zip(REFUSED, rows):
        assert row["arch"] == arch and row["ok"], row.get("error")
        assert "error" not in row or not row["error"], row["error"]
        assert row["placement"]["batch_sharded"] is False
        assert row["audit"]["findings"] == []


def test_full_width_rows_on_the_multi_pod_mesh():
    train = dryrun.dryrun_one("qwen3-0.6b", "train_4k", multi_pod=True,
                              strategy="bsp", verbose=False)
    assert train["ok"] and train["mesh"] == "2x16x16"
    assert train["cost"]["launches"] == {"flash_attention": 2 * 28}
    assert train["pod_exchange"]["reduce_cross_gbytes_per_dev"] > 0
    assert train["pod_exchange"]["permute_cross_gbytes_per_dev"] == 0
    assert train["audit"]["findings"] == []
    ro = train["roofline"]
    assert all(ro[k] > 0 for k in ("t_compute_ms", "t_memory_ms",
                                   "t_collective_ms"))
    assert 0 < ro["useful_ratio"] < 1
    decode = dryrun.dryrun_one("deepseek-v2-lite-16b", "decode_32k",
                               multi_pod=True, verbose=False)
    assert decode["ok"] and decode["pod_exchange"] is None
    assert decode["placement"] == {"batch_sharded": True,
                                   "reference_batch_sharded": True}
    assert decode["memory"]["argument_size_in_bytes"] > 0
    assert decode["roofline"]["coll_breakdown_gb"]["all-reduce"] > 0
