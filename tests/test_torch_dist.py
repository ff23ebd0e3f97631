"""The port's pod axis across processes, on the CPU: gloo ranks started by
``repro_torch.launch.procs.spawn``, one pod a rank, against the one-card
route and the JAX reference (imported by the ``ref`` fixture, so that the
ranks, which import this file, need no JAX).

One spawn a group size (P = 2 and P = 4 ranks, ``torch.set_num_threads(1)``
in each) runs every rank-side check once (module-scoped fixtures, like
``test_launch_gossip.py``'s ``gossip_output``); the parametrized tests read
its results, so a failure names its strategy.  A third spawn, of P = 3,
runs the gossip exchanges over a random matching, which leaves one pod
without a neighbour each round.  Every spawn has a deadline: the process
group's timeout and the parent's join both end at ``SPAWN_TIMEOUT``
seconds.

Tolerances (the reduced qwen3, float32 unless a case says bfloat16):
- the exchange (``steps.make_exchange``) on one set of inputs, each rank's
  rows against the one-card exchange's: bit for bit at P = 2 (and the
  gossip over a random matching at P = 3), where every cross-pod float32
  sum is one addition and the gossip is one mix of the same rows; within
  1e-6 of the largest entry at P = 4 (gloo's ring sums in its own order,
  the plain gossip's matmul takes a row block), and bfloat16 leaves
  within one bfloat16 ulp of it;
- three whole train steps, each rank's rows of params, vel, acc and the
  snapshots against the one-card step's: relative L2 within 1e-5; the
  loss within 1e-6 relative;
- AD-PSGD at staleness 0 against D-PSGD across ranks: bit for bit;
- the bytes the step hands to ``torch.distributed``: exact counts;
- a P-rank checkpoint against the one-card checkpoint of the same state:
  every array and the meta bytes equal;
- the training example with ``--procs 2`` against one process: the losses
  within 1e-5.
"""
import dataclasses
import os
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro_torch import checkpointing as ckpt
from repro_torch import pytree
from repro_torch.configs.base import INPUT_SHAPES, CommConfig, FabricConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import procs, sharding, specs, steps
from repro_torch.models import model
from repro_torch.topology.graphs import build_demo_schedule

SPAWN_TIMEOUT = 240
#: the exchange at P = 4, over the largest entry: float32 1e-6; bfloat16
#: leaves one bfloat16 ulp (2**-7), where a float32 sum taken in another
#: order rounds across a bfloat16 boundary
EXCHANGE_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
STEP_TOL = 1e-5
LOSS_TOL = 1e-6
EXAMPLE_TOL = 1e-5
GROUP_SIZES = (2, 4)
STRATEGIES = steps.STRATEGIES
STEPS, STEP_B, STEP_T, LR = 3, 2, 16, 1e-2
#: comm fields a strategy: Gaia at a threshold that selects a share of
#: the updates; FedAvg syncing every second step; AD-PSGD reading slot 1
#: of 3
COMM = {"bsp": {}, "gaia": {"gaia_t0": 0.05}, "fedavg": {"iter_local": 2},
        "dgc": {"dgc_sparsity": 0.95}, "dpsgd": {},
        "adpsgd": {"max_staleness": 2}}
STALENESS = 1
#: collectives a rank may call; the check wraps each that this PyTorch has
COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "all_gather_single",
               "all_to_all_single", "all_gather", "all_to_all", "broadcast",
               "reduce", "reduce_scatter_tensor", "gather", "scatter",
               "send", "recv", "isend", "irecv", "barrier")


def _comm(strategy, **kw):
    return CommConfig(strategy=strategy,
                      fabric=FabricConfig(topology="ring"),
                      **{**COMM[strategy], **kw})


def _cfg(dtype="float32"):
    return dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                               dtype=dtype)


def _mix(comm, n_pods, t=0, mesh=None, staleness=STALENESS, fabric="ring"):
    if comm.strategy not in steps.GOSSIP_STRATEGIES:
        return {}
    kw = ({"staleness": staleness, "max_staleness": comm.max_staleness}
          if comm.strategy == "adpsgd" else {})
    return {"mix": steps.gossip_operands(build_demo_schedule(fabric, n_pods),
                                         t, device="cpu", mesh=mesh, **kw)}


def _batch(t, n_pods, vocab):
    rng = np.random.default_rng(100 + t)
    seqs = torch.from_numpy(rng.integers(0, vocab, (n_pods, STEP_B,
                                                    STEP_T + 1)))
    return {"tokens": seqs[..., :-1], "labels": seqs[..., 1:]}


def _exchange_inputs(strategy, cfg, n_pods, seed):
    """The exchange's inputs for every pod, from one seed: stacked leaves
    of the reduced qwen3's shapes and dtypes."""
    rng = np.random.default_rng(seed)
    like = pytree.leaves(model.init_model(torch.Generator().manual_seed(0),
                                          cfg, "cpu"))

    def draw(scale, dtype=None):
        return [torch.from_numpy(rng.standard_normal(
            (n_pods,) + tuple(t.shape)).astype(np.float32) * scale).to(
            dtype or t.dtype) for t in like]
    if strategy == "bsp":
        return {"grads": draw(0.01)}
    parts = {"params": draw(0.1)}
    if strategy in ("gaia", "dgc"):
        parts["acc"] = draw(0.01, torch.float32)
    if strategy == "dgc":
        parts["vel"] = draw(0.01, torch.float32)
    if strategy == "adpsgd":
        S1 = COMM["adpsgd"]["max_staleness"] + 1
        parts["snaps"] = {
            pytree.dtype_name(dt): torch.from_numpy(rng.standard_normal(
                (S1, n_pods, sum(like[i].numel() for i in idx))
            ).astype(np.float32) * 0.1).to(dt)
            for dt, idx in steps.dtype_groups(like).items()}
    return parts


def _rows(parts, rows, strategy):
    """The local rows of an exchange's parts (snaps: their pod axis 1)."""
    out = {k: [x[rows] for x in v] for k, v in parts.items()
           if k != "snaps"}
    if "snaps" in parts:
        out["snaps"] = {k: v[:, rows] for k, v in parts["snaps"].items()}
    return out


def _flat(parts):
    """Every tensor of an exchange's parts or a state, in a fixed order."""
    return pytree.leaves(parts)


def _compare(got, want):
    """(bit for bit, max |got - want| over max |want|, relative L2)."""
    same, worst, num, den = True, 0.0, 0.0, 0.0
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
        same = same and torch.equal(g, w)
        d = (g.double() - w.double())
        worst = max(worst, float(d.abs().max()) / max(
            float(w.double().abs().max()), 1e-30))
        num += float(d.square().sum())
        den += float(w.double().square().sum())
    return same, worst, (num / max(den, 1e-300)) ** 0.5


class _Recorder:
    """``torch.distributed``'s collectives wrapped: each call's name,
    whether its group is the pod group, and the bytes it is handed (an
    all-gather's and an all-to-all's input, every tensor argument of the
    others)."""

    def __init__(self, mesh):
        self.mesh, self.calls, self.saved = mesh, [], {}

    def __enter__(self):
        for name in COLLECTIVES:
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            self.saved[name] = fn

            def counted(*args, _fn=fn, _name=name, **kw):
                tensors = [a for a in args if isinstance(a, torch.Tensor)]
                if _name in ("all_gather_into_tensor", "all_gather_single",
                             "all_to_all_single"):
                    tensors = tensors[1:2]
                self.calls.append(
                    (_name, kw.get("group") is self.mesh.pod_group,
                     sum(t.numel() * t.element_size() for t in tensors)))
                return _fn(*args, **kw)
            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(dist, name, fn)


def _gather_rows(t, axis, P):
    """Every rank's ``t`` concatenated along ``axis``."""
    parts = [torch.empty_like(t) for _ in range(P)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts, dim=axis)


def _rank_checks(rank, dev, P, out_dir):
    """Every rank-side check of a P-rank group; returns host values."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_mesh((P, 1, 1), device=dev)
    rows = slice(rank, rank + 1)
    res = {"rank": rank, "coords": mesh.coords, "exchange": {}, "step": {},
           "bytes": {}, "ckpt": {}}

    # (iii) the exchange on one set of inputs, both routes
    for dtype in ("float32", "bfloat16"):
        cfg = _cfg(dtype)
        for strategy in STRATEGIES:
            comm = _comm(strategy)
            full = _exchange_inputs(strategy, cfg, P, seed=7)
            kw = {"step_idx": 1}
            one = steps.make_exchange(comm, lr=LR)(full, **kw,
                                                   **_mix(comm, P))
            got = steps.make_exchange(comm, mesh=mesh, lr=LR)(
                _rows(full, rows, strategy), **kw,
                **_mix(comm, P, mesh=mesh))
            same, worst, _ = _compare(_flat(got),
                                      _flat(_rows(one, rows, strategy)))
            res["exchange"][(dtype, strategy)] = (same, worst)

    # (iii) three whole steps, (v) the bytes each hands to the backend,
    # (vii) checkpoints of the states
    cfg = _cfg()
    p = model.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    n_model = sum(t.numel() for t in pytree.leaves(p))
    for strategy in STRATEGIES:
        comm = _comm(strategy)
        one_step = steps.make_train_step(cfg, comm, lr=LR)
        mesh_step = steps.make_train_step(cfg, comm, mesh=mesh, lr=LR)
        one = steps.make_train_state(p, comm, P)
        mine = steps.make_train_state(p, comm, P, mesh=mesh)
        worst_l2, loss_err, calls = 0.0, 0.0, []
        for t in range(STEPS):
            b = _batch(t, P, cfg.vocab)
            one, m_one = one_step(one, b, t, **_mix(comm, P, t))
            with _Recorder(mesh) as rec:
                mine, m_mine = mesh_step(mine, b, t,
                                         **_mix(comm, P, t, mesh=mesh))
            calls.append(rec.calls)
            _, _, l2 = _compare(_flat(mine), _flat(_rows(
                {k: pytree.leaves(v) if k != "snaps" else v
                 for k, v in one.items()}, rows, strategy)))
            worst_l2 = max(worst_l2, l2)
            assert sorted(m_one) == sorted(m_mine)
            loss_err = max(loss_err, max(
                abs(float(m_mine[k]) - float(m_one[k])) /
                max(abs(float(m_one[k])), 1e-30) for k in m_one))
        res["step"][strategy] = (worst_l2, loss_err)
        res["bytes"][strategy] = {"calls": calls, "n_model": n_model}
        if strategy in ("gaia", "adpsgd"):
            specs_ = sharding.train_state_shardings(
                steps.train_state_shape(cfg, comm, P), mesh)
            path = os.path.join(out_dir, f"P{P}_{strategy}")
            ckpt.save(os.path.join(path, "ranks"), mine, step=STEPS,
                      mesh=mesh, specs=specs_)
            # the one-card checkpoint of the same stacked state: the
            # ranks' rows gathered by the list all-gather (not save's)
            stacked = [_gather_rows(t, ax, P) for t, ax in zip(
                pytree.leaves(mine), [spec.index("pod") for spec in
                                      pytree.leaves_like(specs_, mine)])]
            if rank == 0:
                ckpt.save(os.path.join(path, "one_card"),
                          pytree.unflatten(mine, stacked), step=STEPS)
            back = ckpt.restore(os.path.join(path, "ranks"),
                                pytree.tree_map(torch.empty_like, mine),
                                step=STEPS, mesh=mesh, specs=specs_)
            res["ckpt"][strategy] = all(
                torch.equal(x, y) for x, y in zip(pytree.leaves(back),
                                                  pytree.leaves(mine)))

    # (iv) AD-PSGD at staleness 0 against D-PSGD, across ranks
    outs = {}
    for strategy in ("dpsgd", "adpsgd"):
        comm = _comm(strategy)
        state = steps.make_train_state(p, comm, P, mesh=mesh)
        step = steps.make_train_step(cfg, comm, mesh=mesh, lr=LR)
        for t in range(2):
            state, _ = step(state, _batch(t, P, cfg.vocab), t,
                            **_mix(comm, P, t, mesh=mesh, staleness=0))
        outs[strategy] = pytree.leaves(state["params"])
    res["adpsgd0"] = all(torch.equal(x, y) for x, y in
                         zip(outs["adpsgd"], outs["dpsgd"]))

    # (vi) the mesh takes a width its data and model axes do not split:
    # an RG-LRU width of 255 (over data, the gates' rows), whole on every
    # rank of the axis
    taken = []
    cfg = get_config("recurrentgemma-2b").reduced()
    cfg = dataclasses.replace(cfg, rglru=dataclasses.replace(
        cfg.rglru, lru_width=255))
    for shape in ((P // 2, 2, 1), (P // 2, 1, 2)):
        mesh = mesh_lib.make_mesh(shape, device=dev)
        shapes = steps.param_shape(cfg)
        gates = [s_ for (p_, _), s_ in zip(pytree.leaves_with_paths(
            shapes), sharding.leaf_specs(shapes, mesh))
            if p_.endswith("mixer/w_a/w")]
        taken.append(bool(gates) and all(
            a_ is None or mesh.size_of(a_) == 1 for s_ in gates
            for a_ in s_))
    res["refused"] = taken
    return res


def _matching_checks(rank, dev, P):
    """The gossip exchanges over a random matching of P = 3 pods, one a
    rank, every round of its period against the one-card exchange: each
    round leaves one pod unmatched, so one rank reads no neighbour (AD-PSGD
    receives no row)."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_mesh((P, 1, 1), device=dev)
    rows = slice(rank, rank + 1)
    period = build_demo_schedule("random-matching", P).period
    res = {"unmatched": 0}
    for dtype in ("float32", "bfloat16"):
        cfg = _cfg(dtype)
        for strategy in steps.GOSSIP_STRATEGIES:
            comm = _comm(strategy)
            full = _exchange_inputs(strategy, cfg, P, seed=11)
            same, worst = True, 0.0
            for t in range(period):
                mine = _mix(comm, P, t, mesh=mesh, fabric="random-matching")
                res["unmatched"] += int(not bool(mine["mix"].mix.w.any()))
                one = steps.make_exchange(comm, lr=LR)(
                    full, **_mix(comm, P, t, fabric="random-matching"))
                got = steps.make_exchange(comm, mesh=mesh, lr=LR)(
                    _rows(full, rows, strategy), **mine)
                s_, w_, _ = _compare(_flat(got),
                                     _flat(_rows(one, rows, strategy)))
                same, worst = same and s_, max(worst, w_)
            res[(dtype, strategy)] = (same, worst)
    return res


@pytest.fixture(scope="module")
def matching():
    return procs.spawn(_matching_checks, 3, backend="gloo", device="cpu",
                       timeout=SPAWN_TIMEOUT, args=(3,))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strategy", steps.GOSSIP_STRATEGIES)
def test_gossip_with_a_pod_left_out_matches_one_card(matching, strategy,
                                                     dtype):
    """A random matching of 3 pods leaves one out each round; the rank that
    holds it reads nothing (keeps its self term) and the others go on:
    every rank's rows equal the one-card exchange's, bit for bit (each
    mixed row has one neighbour, as at P = 2)."""
    period = build_demo_schedule("random-matching", 3).period
    assert sum(r["unmatched"] for r in matching) == 2 * 2 * period
    for rank, r in enumerate(matching):
        same, worst = r[(dtype, strategy)]
        assert same, (rank, worst)


@pytest.fixture(scope="module", params=GROUP_SIZES, ids=lambda p: f"P{p}")
def ranks(request, tmp_path_factory):
    P = request.param
    out_dir = str(tmp_path_factory.mktemp(f"dist_P{P}"))
    results = procs.spawn(_rank_checks, P, backend="gloo", device="cpu",
                          timeout=SPAWN_TIMEOUT, args=(P, out_dir))
    return P, out_dir, results


# ---------------------------------------------------------------------------
# (iii)-(vii): the ranks' results
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_exchange_matches_one_card(ranks, strategy, dtype):
    P, _, results = ranks
    for r in results:
        same, worst = r["exchange"][(dtype, strategy)]
        if P == 2:
            assert same, (r["rank"], worst)
        assert worst <= EXCHANGE_TOL[dtype], (r["rank"], worst)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_train_steps_match_one_card(ranks, strategy):
    _, _, results = ranks
    for r in results:
        l2, loss_err = r["step"][strategy]
        assert l2 <= STEP_TOL, (r["rank"], l2)
        assert loss_err <= LOSS_TOL, (r["rank"], loss_err)


def test_ranks_hold_their_pods(ranks):
    P, _, results = ranks
    assert [r["coords"] for r in results] == [
        {"pod": i, "data": 0, "model": 0} for i in range(P)]


def test_adpsgd_staleness0_bitwise_dpsgd(ranks):
    _, _, results = ranks
    assert all(r["adpsgd0"] for r in results)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_exchange_is_pod_group_only(ranks, strategy):
    """Every collective of a step is on the pod group, and its bytes are
    the strategy's: bsp, gaia and dgc all-reduce one float32 model (and
    the loss), fedavg at its sync step only; dpsgd gathers one model a
    rank in (P - 1 received); adpsgd ships one model a (source,
    destination) pair (the ring: 1 at P = 2, 2 at P = 4)."""
    P, _, results = ranks
    for r in results:
        b = r["bytes"][strategy]
        model32 = b["n_model"] * 4
        for t, calls in enumerate(b["calls"]):
            assert all(on_pod for _, on_pod, _ in calls), calls
            names = sorted(name for name, _, _ in calls)
            sizes = sorted(n for _, _, n in calls)
            if strategy in ("bsp", "gaia", "dgc") or (
                    strategy == "fedavg" and t % 2 == 1):
                assert names == ["all_reduce"] * 2 and sizes == [4, model32]
            elif strategy == "fedavg":
                assert names == ["all_reduce"] and sizes == [4]
            else:
                op = [n for n, _, _ in calls if n != "all_reduce"]
                moved = sum(n for name, _, n in calls if name != "all_reduce")
                assert sorted(n for name, _, n in calls
                              if name == "all_reduce") == [4]
                pairs = 1 if strategy == "dpsgd" else min(2, P - 1)
                assert moved == pairs * model32, (op, moved, model32)
                assert set(op) <= {"all_gather_into_tensor",
                                   "all_gather_single", "all_to_all_single"}


@pytest.mark.parametrize("strategy", ["gaia", "adpsgd"])
def test_checkpoint_of_ranks_is_the_one_card_checkpoint(ranks, strategy):
    """The P ranks' checkpoint of their state after the steps (acc;
    AD-PSGD's snapshots, whose pod axis is 1) against the one-card
    checkpoint of the same stacked state: every array and the meta bytes;
    and each rank's restore is its own rows, bit for bit."""
    P, out_dir, results = ranks
    path = os.path.join(out_dir, f"P{P}_{strategy}")
    a = os.path.join(path, "ranks", f"ckpt_{STEPS}")
    b = os.path.join(path, "one_card", f"ckpt_{STEPS}")
    with np.load(os.path.join(a, "payload.npz")) as za, \
            np.load(os.path.join(b, "payload.npz")) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for f in za.files:
            assert za[f].dtype == zb[f].dtype, f
            np.testing.assert_array_equal(za[f], zb[f], err_msg=f)
    with open(os.path.join(a, "meta.msgpack"), "rb") as fa, \
            open(os.path.join(b, "meta.msgpack"), "rb") as fb:
        assert fa.read() == fb.read()
    assert all(r["ckpt"][strategy] for r in results)


def test_mesh_refuses_data_and_model_axes(ranks):
    """A data or model axis above 1 takes every family at the widths it
    splits (``test_torch_intrapod.py``, ``test_torch_intrapod_moe.py``,
    ``test_torch_intrapod_families.py``), and a width neither axis
    splits too: an RG-LRU width of 255, its gates' rows and columns whole
    on every rank (``tests/test_torch_clamp.py`` runs such leaves)."""
    _, _, results = ranks
    assert all(r["refused"] == [True, True] for r in results)


# ---------------------------------------------------------------------------
# (vi) refusals that need no ranks
# ---------------------------------------------------------------------------

def test_nccl_refuses_a_shared_device():
    ids = [("host", "GPU-0"), ("host", "GPU-1"), ("host", "GPU-0")]
    with pytest.raises(ValueError, match="ranks 0 and 2"):
        mesh_lib.check_devices(ids, "nccl")
    mesh_lib.check_devices(ids, "gloo")
    mesh_lib.check_devices(ids[:2], "nccl")


def test_spawn_refuses_nccl_without_a_card_a_rank():
    with pytest.raises(ValueError, match="NCCL takes one card a rank"):
        procs.spawn(_rank_checks, 2, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        procs.spawn(_rank_checks, 2, backend="mpi", device="cpu")


def _raises_on_rank_1(rank, dev):
    if rank == 1:
        raise KeyError("rank 1 fails")
    dist.barrier()


def test_spawn_raises_the_first_failure_in_the_parent():
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        procs.spawn(_raises_on_rank_1, 2, backend="gloo", device="cpu",
                    timeout=60)


@pytest.mark.parametrize("op", ["gaia_select_many", "neighbor_mix_many",
                                "neighbor_mix_push_many",
                                "neighbor_mix_src_many",
                                "rand_k_sparsify_many"])
def test_list_ops_refuse_mixed_dtypes_on_the_cpu(op):
    """A list op takes one dtype a launch (the exchange groups the leaves
    by dtype): a mixed list raises ``TypeError`` on the CPU as the card
    does, so a CPU run shows a wrong grouping."""
    from repro_torch.kernels import ops
    a = torch.zeros(2, 3)
    b = torch.zeros(2, 4, dtype=torch.bfloat16)
    mix = ops.mix_operands(np.array([[1], [0]]), np.full((2, 1), 0.5),
                           np.full(2, 0.5), 2, "cpu")
    calls = {
        "gaia_select_many": lambda: ops.gaia_select_many(
            [a, a.bfloat16()], [a, a], 0.1),
        "neighbor_mix_many": lambda: ops.neighbor_mix_many([a, b], mix),
        "neighbor_mix_push_many": lambda: ops.neighbor_mix_push_many(
            [a, b], torch.zeros(1, 2, 7), mix),
        "neighbor_mix_src_many": lambda: ops.neighbor_mix_src_many(
            [a, b], torch.zeros(2, 7), mix),
        "rand_k_sparsify_many": lambda: ops.rand_k_sparsify_many(
            [a, b], [a, b], 0.5, [1, 2], [None, None])}
    with pytest.raises(TypeError, match="dtypes differ"):
        calls[op]()


# ---------------------------------------------------------------------------
# (i) input specs and (ii) sharding rules against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape_name", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(ref, arch, shape_name):
    n_pods = 2 if INPUT_SHAPES[shape_name].mode == "train" else 1
    got = specs.input_specs(get_config(arch), shape_name, n_pods=n_pods)
    want = ref.specs.input_specs(ref.get_config(arch), shape_name,
                                 n_pods=n_pods)
    assert sorted(got) == sorted(want)
    for k, (shape, dtype) in got.items():
        assert shape == tuple(want[k].shape), (k, shape, want[k].shape)
        assert pytree.dtype_name(dtype) == str(want[k].dtype), k
    meta = specs.as_meta(got)
    assert all(t.device.type == "meta" for t in meta.values())
    assert set(INPUT_SHAPES) == set(ref.base.INPUT_SHAPES)


@pytest.fixture(scope="module")
def ref():
    """The JAX reference's modules, imported here rather than at the top:
    the gloo ranks import this file and need neither JAX nor ``repro``
    (each would pay their import)."""
    import jax
    from jax.sharding import AbstractMesh
    from repro.configs import base, registry
    from repro.launch import sharding as jsh
    from repro.launch import specs as jsp
    from repro.launch import steps as jst
    def spec_list(tree):
        return [tuple(x.spec) for x in jax.tree_util.tree_leaves(
            tree, is_leaf=lambda y: hasattr(y, "spec"))]

    def paths(tree):
        return [(jsh._path_str(p), tuple(x.shape)) for p, x in
                jax.tree_util.tree_flatten_with_path(tree)[0]]
    return types.SimpleNamespace(
        jax=jax, base=base, get_config=registry.get_config, sharding=jsh,
        specs=jsp, steps=jst, spec_list=spec_list, paths=paths,
        mesh=lambda m: AbstractMesh(tuple(m.shape.values()), m.axis_names))


@pytest.mark.parametrize("multi_pod", [True, False])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_match_reference(ref, arch, multi_pod):
    """Every full-width parameter of each arch (shapes only, the port's
    ``meta`` tree against the reference's ``eval_shape``): the paths,
    ``rule_spec``, ``_clamp_spec`` and ``param_shardings`` stacked and
    unstacked, on the reference's production mesh."""
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    jmesh = ref.mesh(mesh)
    p = steps.param_shape(get_config(arch))
    jp = ref.steps.param_shape(ref.get_config(arch))
    paths = [(ps, tuple(t.shape)) for ps, t in pytree.leaves_with_paths(p)]
    assert paths == ref.paths(jp)
    for ps, shape in paths:
        assert sharding.rule_spec(ps, shape) == tuple(
            ref.sharding.rule_spec(ps, shape)), ps
        spec = sharding.rule_spec(ps, shape)
        assert sharding._clamp_spec(spec, shape, mesh) == tuple(
            ref.sharding._clamp_spec(ref.sharding.P(*spec), shape, jmesh))
    assert pytree.leaves_like(sharding.param_shardings(p, mesh), p) == \
        ref.spec_list(ref.sharding.param_shardings(jp, jmesh))
    stacked = pytree.tree_map(lambda t: t.unsqueeze(0).expand(
        (2,) + tuple(t.shape)), p)
    jstacked = ref.jax.tree_util.tree_map(
        lambda x: ref.jax.ShapeDtypeStruct((2,) + x.shape, x.dtype), jp)
    assert pytree.leaves_like(sharding.param_shardings(
        stacked, mesh, stacked=True), stacked) == ref.spec_list(
        ref.sharding.param_shardings(jstacked, jmesh, stacked=True))


#: one arch of each family
FAMILY_ARCHS = ("qwen3-0.6b", "phi-3-vision-4.2b", "deepseek-v2-lite-16b",
                "minicpm3-4b", "mamba2-780m", "recurrentgemma-2b",
                "seamless-m4t-large-v2")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_state_batch_and_cache_shardings_match_reference(ref, arch):
    """``train_state_shardings`` (params, vel, acc: the reference's; the
    port's flat snapshot buffers: (None, "pod", None)), ``batch_shardings``
    of the train specs and ``cache_shardings`` of the decode cache, with
    the batch sharded and not, and the baseline-decode switch."""
    mesh = mesh_lib.make_production_mesh(multi_pod=True)
    jmesh = ref.mesh(mesh)
    cfg, jcfg = get_config(arch), ref.get_config(arch)
    for strategy in ("gaia", "adpsgd"):
        state = steps.train_state_shape(cfg, CommConfig(strategy=strategy),
                                        2)
        jstate = ref.steps.train_state_shape(
            jcfg, ref.base.CommConfig(strategy=strategy), 2)
        got = sharding.train_state_shardings(state, mesh)
        want = ref.sharding.train_state_shardings(jstate, jmesh)
        for k in ("params", "vel", "acc"):
            if k in state:
                assert pytree.leaves_like(got[k], state[k]) == \
                    ref.spec_list(want[k]), k
        if "snaps" in state:
            assert set(pytree.leaves_like(got["snaps"], state["snaps"])) \
                == {(None, "pod", None)}
    batch = specs.as_meta(specs.input_specs(cfg, "train_4k", n_pods=2))
    jbatch = ref.specs.input_specs(jcfg, "train_4k", n_pods=2)
    got = sharding.batch_shardings(batch, mesh, pod_stacked=True)
    want = ref.sharding.batch_shardings(jbatch, jmesh, pod_stacked=True)
    assert [got[k] for k in sorted(got)] == ref.spec_list(want)
    for seq, gb in ((32_768, 128), (64, 1)):
        cache = steps.cache_shape(cfg, gb, seq)
        jcache = ref.steps.cache_shape(jcfg, gb, seq)
        for sharded in (True, False):
            for baseline in (False, True):
                if baseline:
                    os.environ["REPRO_BASELINE_DECODE"] = "1"
                try:
                    want = ref.spec_list(ref.sharding.cache_shardings(
                        jcache, jmesh, batch_sharded=sharded))
                finally:
                    os.environ.pop("REPRO_BASELINE_DECODE", None)
                assert pytree.leaves_like(sharding.cache_shardings(
                    cache, mesh, batch_sharded=sharded,
                    baseline_decode=baseline), cache) == want


def test_local_slices_take_a_ranks_block():
    mesh = mesh_lib.Mesh((4, 2, 1), mesh_lib.AXES, coords=(2, 1, 0))
    assert sharding.local_slices(("pod", "data"), (8, 6), mesh) == (
        slice(4, 6), slice(3, 6))
    assert sharding.local_slices((("pod", "data"),), (16,), mesh) == (
        slice(10, 12),)
    with pytest.raises(ValueError):
        sharding.local_slices(("pod",), (6,), mesh)


# ---------------------------------------------------------------------------
# (viii) the training example
# ---------------------------------------------------------------------------

def test_example_procs_match_one_process(tmp_path):
    """``--procs 2 --device cpu`` (AD-PSGD: the all-to-all route, and a
    checkpoint gathered from the ranks) against one process."""
    from repro_torch.examples import train_lm_decentralized as ex
    argv = ["--device", "cpu", "--strategy", "adpsgd", "--steps", "21",
            "--seq", "32", "--d-model", "64", "--layers", "2",
            "--batch-per-pod", "2", "--lr", "3e-3"]
    one = ex.train(ex.parse_args(argv))
    two = ex.train(ex.parse_args(argv + ["--procs", "2", "--ckpt",
                                         str(tmp_path)]))
    assert [t for t, _ in two["losses"]] == [t for t, _ in one["losses"]]
    np.testing.assert_allclose([x for _, x in two["losses"]],
                               [x for _, x in one["losses"]], rtol=EXAMPLE_TOL)
    params = one["state"]["params"]
    back = ckpt.restore(str(tmp_path), params, step=21)
    for x, y in zip(pytree.leaves(back), pytree.leaves(params)):
        torch.testing.assert_close(x, y, rtol=EXAMPLE_TOL, atol=EXAMPLE_TOL)
