"""The port's training path against the JAX reference, on the CPU.

Weights cannot come from the same random draws (``jax.random`` has no
PyTorch counterpart), so every comparison carries ``repro``'s initial
parameters across with ``cnn_params_from_jax``; inputs are NumPy arrays
made from a seed.  Tolerances: the model (logits, loss, gradients, BN
state) at rtol 1e-4 / atol 1e-5, float32 sums taken in another order by
XLA and ATen; one algorithm step at atol 1e-4; five trainer steps'
losses within 1e-3 relative.  A Gaia or DGC top-k entry within rounding
of its threshold may flip (at most 1e-3 of them); rand-k's masks, the
communication of data-independent strategies and SkewScout's θ sequence
are exact.  Host-side NumPy code (data, partitions, topology, ledger,
RNG, SkewScout's controller) is a copy and must be bit-equal.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

import repro.core.divergence as jax_divergence
import repro.core.trainer as jax_trainer
from repro.configs.base import CommConfig as JaxCommConfig
from repro.configs.base import FabricConfig as JaxFabricConfig
from repro.configs.cnn_zoo import CNN_ZOO as JAX_CNN_ZOO
from repro.core.partition import partition_label_skew as jax_partition
from repro.data.pipeline import DecentralizedLoader as JaxLoader
from repro.data.synthetic import synth_images as jax_synth_images
from repro.kernels import rng as jax_rng
from repro.models.cnn import cnn_apply as jax_cnn_apply
from repro.models.cnn import cnn_batch_stats as jax_cnn_batch_stats
from repro.models.cnn import init_cnn as jax_init_cnn
from repro.topology import LINK_PROFILES as JAX_LINK_PROFILES
from repro.topology import CommLedger as JaxLedger
from repro.topology import build_schedule as jax_build_schedule
from repro.topology.graphs import full_skew_label_hist
import repro_torch.core.divergence as divergence
import repro_torch.core.trainer as trainer
from repro_torch.configs.base import CommConfig, FabricConfig
from repro_torch.configs.cnn_zoo import CNN_ZOO
from repro_torch.core.algorithms.base import tree_size
from repro_torch.core.partition import partition_label_skew
from repro_torch.data.pipeline import DecentralizedLoader
from repro_torch.data.synthetic import synth_images
from repro_torch.kernels import ops
from repro_torch.kernels import rng
from repro_torch.models.cnn import (cnn_apply, cnn_batch_stats,
                                   cnn_params_from_jax, init_cnn)
from repro_torch.topology import LINK_PROFILES, CommLedger, build_schedule

REPO = Path(__file__).resolve().parents[1]
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def jax_oracles(monkeypatch):
    """Send ``repro``'s kernel ops to their jnp oracles, which
    ``tests/test_kernels.py`` holds equal to the Pallas kernels: no
    dispatch timing trials, and no write to the shared dispatch cache."""
    monkeypatch.setenv("REPRO_KERNEL_DISPATCH", "oracle")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# jitted: eager jax.random and eager convolutions cost seconds per config
_jax_init_jit = jax.jit(jax_init_cnn, static_argnums=1)
_jax_apply_jit = jax.jit(jax_cnn_apply, static_argnums=2,
                         static_argnames="train")
_jax_stats_jit = jax.jit(jax_cnn_batch_stats, static_argnums=(1, 3))


def _jax_init(name: str):
    params, state = _jax_init_jit(jax.random.PRNGKey(0), JAX_CNN_ZOO[name])
    return _np(params), _np(state)


def _assert_trees_close(port, ref_tree, **tol):
    assert set(port) == set(ref_tree)
    for k in ref_tree:
        np.testing.assert_allclose(port[k].numpy(), ref_tree[k].numpy(),
                                   err_msg=k, **tol)


def test_cnn_configs_are_copies():
    assert {k: dataclasses.asdict(v) for k, v in CNN_ZOO.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_CNN_ZOO.items()}


#: input seed per model: float32 rounding differs between XLA and ATen
#: by ~1e-6, so a ReLU input or a max-pool runner-up within that of a tie
#: would route a gradient differently on each side.  These seeds keep
#: every such margin above TIE_MARGIN (``_tie_margin`` checks it).
INPUT_SEED = {"lenet": 295, "bn-lenet": 170, "gn-lenet": 387,
              "brn-lenet": 295, "alexnet-s": 104, "resnet-s": 386,
              "resnet-s-gn": 372}
TIE_MARGIN = 5e-5


def _tie_margin(monkeypatch, params, state, cfg, x) -> float:
    """Smallest |ReLU input| and smallest gap between the two largest
    entries of a max-pool window (windows of zeros carry no gradient)
    in one forward pass of the port."""
    seen = []
    relu, pool = F.relu, F.max_pool2d

    def relu_rec(t):
        seen.append(float(t.abs().min()))
        return relu(t)

    def pool_rec(t, k, s):
        B, C, H, W = t.shape
        win = t.reshape(B, C, H // 2, 2, W // 2, 2).transpose(3, 4)
        top = win.reshape(B, C, H // 2, W // 2, 4).topk(2, dim=-1).values
        gap = (top[..., 0] - top[..., 1])[top[..., 0] > 0]
        seen.append(float(gap.min()) if gap.numel() else np.inf)
        return pool(t, k, s)

    monkeypatch.setattr(F, "relu", relu_rec)
    monkeypatch.setattr(F, "max_pool2d", pool_rec)
    cnn_apply(params, state, cfg, x, train=True)
    monkeypatch.undo()
    return min(seen)


@pytest.mark.parametrize("name", list(JAX_CNN_ZOO))
def test_cnn_matches_jax(name, monkeypatch):
    cfg = CNN_ZOO[name]
    p_np, s_np = _jax_init(name)
    params, state = cnn_params_from_jax(p_np, s_np, cfg)
    x = np.random.default_rng(INPUT_SEED[name]).standard_normal(
        (4, 16, 16, 3)).astype(np.float32)
    y = np.random.default_rng(1).integers(0, 10, size=4).astype(np.int32)
    assert _tie_margin(monkeypatch, params, state, cfg,
                       torch.from_numpy(x)) > TIE_MARGIN

    jfns, _ = jax_trainer.make_cnn_fns(JAX_CNN_ZOO[name])
    jloss, jgrads, jstate = jax.jit(jfns.loss_and_grad)(
        p_np, s_np, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    jlogits, _ = _jax_apply_jit(p_np, s_np, JAX_CNN_ZOO[name], x, train=True)
    jeval, _ = _jax_apply_jit(p_np, s_np, JAX_CNN_ZOO[name], x, train=False)

    fns, _ = trainer.make_cnn_fns(cfg)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}
    grads, (loss, new_state) = torch.func.grad_and_value(
        fns.loss_fn, has_aux=True)(params, state, batch)
    logits, _ = cnn_apply(params, state, cfg, batch["x"], train=True)
    ev, _ = cnn_apply(params, state, cfg, batch["x"], train=False)

    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **MODEL_TOL)
    np.testing.assert_allclose(ev.numpy(), np.asarray(jeval), **MODEL_TOL)
    np.testing.assert_allclose(float(loss), float(jloss), **MODEL_TOL)
    g_ref, st_ref = cnn_params_from_jax(_np(jgrads), _np(jstate), cfg)
    _assert_trees_close(grads, g_ref, **MODEL_TOL)
    _assert_trees_close(new_state, st_ref, **MODEL_TOL)
    assert tree_size(params) == sum(a.size for a in
                                    jax.tree_util.tree_leaves(p_np))


@pytest.mark.parametrize("name", ["bn-lenet", "resnet-s"])
def test_cnn_batch_stats_matches_jax(name):
    cfg = CNN_ZOO[name]
    p_np, _ = _jax_init(name)
    params, _ = cnn_params_from_jax(p_np, {}, cfg)
    x = np.random.default_rng(INPUT_SEED[name]).standard_normal(
        (4, 16, 16, 3)).astype(np.float32)
    for layer in (0, len(cfg.conv_channels) - 1):
        mine = cnn_batch_stats(params, cfg, torch.from_numpy(x), layer)
        theirs = _jax_stats_jit(p_np, JAX_CNN_ZOO[name], x, layer)
        for port, ref_t in zip(mine, theirs):
            np.testing.assert_allclose(port.numpy(), np.asarray(ref_t),
                                       **MODEL_TOL)


def test_divergence_probes_match_jax():
    """Figure 4's BN-statistics divergence across three partitions' batches
    and the relative L2 distance between two models."""
    cfg_name = "bn-lenet"
    p_np, _ = _jax_init(cfg_name)
    params, _ = cnn_params_from_jax(p_np, {}, CNN_ZOO[cfg_name])
    rs = np.random.default_rng(INPUT_SEED[cfg_name])
    batches = [rs.standard_normal((4, 16, 16, 3)).astype(np.float32) + k
               for k in range(3)]
    for layer in (0, 1):
        mine = divergence.bn_divergence(params, CNN_ZOO[cfg_name], batches,
                                        layer)
        theirs = jax_divergence.bn_divergence(p_np, JAX_CNN_ZOO[cfg_name],
                                              batches, layer)
        for port, ref_a in zip(mine, theirs):
            np.testing.assert_allclose(port, ref_a, rtol=1e-4)
    shifted = {n: t * 1.5 for n, t in params.items()}
    jshifted = jax.tree_util.tree_map(lambda a: a * 1.5, p_np)
    np.testing.assert_allclose(
        divergence.model_l2_distance(shifted, params),
        jax_divergence.model_l2_distance(jshifted, p_np), rtol=1e-5)


# ---------------------------------------------------------------------------
# one algorithm step
# ---------------------------------------------------------------------------

STEP_K, STEP_B, STEP_LR = 4, 8, 0.05


def _step_inputs(cfg_name: str):
    p_np, s_np = _jax_init(cfg_name)
    rs = np.random.default_rng(2)
    x = rs.standard_normal((STEP_K, STEP_B, 16, 16, 3)).astype(np.float32)
    y = rs.integers(0, 10, size=(STEP_K, STEP_B)).astype(np.int32)
    return p_np, s_np, x, y


def _port_step(algo_name: str, cfg_name: str, *, step_idx: int = 0,
               hypers=None, staleness=None, **comm_kw):
    """One step of the port's ``algo_name`` from ``repro``'s initial
    state, on the same batch as :func:`_step_pair`.  ``hypers`` are the
    step's dynamic hyper-parameters as Python numbers.  Returns (state,
    metrics, algorithm)."""
    hypers = dict(hypers or {})
    p_np, s_np, x, y = _step_inputs(cfg_name)
    comm = CommConfig(fabric=FabricConfig(topology="ring"), **comm_kw)
    cfg = CNN_ZOO[cfg_name]
    fns, _ = trainer.make_cnn_fns(cfg)
    algo = trainer.make_algorithm(algo_name, fns, STEP_K, comm, lr0=STEP_LR,
                                  staleness=staleness)
    params, state = cnn_params_from_jax(p_np, s_np, cfg)
    if algo_name == "gaia":
        hypers["t0"] = torch.tensor(hypers["t0"])
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}
    new, met = algo.step(algo.init(params, state), batch,
                         torch.tensor(STEP_LR), step_idx, **hypers)
    return new, met, algo


def _step_pair(algo_name: str, cfg_name: str, *, step_idx: int = 0,
               hypers=None, staleness=None, **comm_kw):
    """One step of ``algo_name`` on both sides from the same state and
    batch, the reference's hyper-parameters passed as the trainer passes
    them (float32, or int32 for ``iter_local``).  Returns (jax state,
    jax metrics, port state, port metrics, port algorithm)."""
    p_np, s_np, x, y = _step_inputs(cfg_name)
    jcomm = JaxCommConfig(fabric=JaxFabricConfig(topology="ring"), **comm_kw)
    jfns, _ = jax_trainer.make_cnn_fns(JAX_CNN_ZOO[cfg_name])
    jalgo = jax_trainer.make_algorithm(algo_name, jfns, STEP_K, jcomm,
                                       lr0=STEP_LR, staleness=staleness)
    jkw = {k: jnp.asarray(v, jnp.int32 if k == "iter_local" else jnp.float32)
           for k, v in (hypers or {}).items()}
    jnew, jmet = jalgo.step(jalgo.init(p_np, s_np),
                            {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                            jnp.float32(STEP_LR), jnp.int32(step_idx), **jkw)
    return (jnew, jmet) + _port_step(algo_name, cfg_name, step_idx=step_idx,
                                     hypers=hypers, staleness=staleness,
                                     **comm_kw)


def _port_layout(jtree, cfg_name: str):
    """A stacked JAX params/state pytree in the port's names and layout."""
    p, s = jtree
    return cnn_params_from_jax(_np(p), _np(s), CNN_ZOO[cfg_name])


def _check_states(jnew, new, cfg_name: str, keys=("params", "vel")):
    for key in keys:
        ref_p, _ = _port_layout((jnew[key], {}), cfg_name)
        _assert_trees_close(new[key], ref_p, atol=1e-4, rtol=0)
    _, ref_s = _port_layout((jnew["params"], jnew["mstate"]), cfg_name)
    _assert_trees_close(new["mstate"], ref_s, atol=1e-4, rtol=0)


def _check_metrics(jmet, met, exact=("comm_floats",)):
    assert set(met) == set(jmet)
    for key in jmet:
        if key in exact:
            assert float(met[key]) == float(jmet[key]), key
        else:
            np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                       rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("algo_name", ["bsp", "dpsgd"])
def test_algorithm_step_matches_jax(algo_name, jax_oracles):
    cfg_name = "bn-lenet"
    jnew, jmet, new, met, _ = _step_pair(algo_name, cfg_name)
    _check_metrics(jmet, met)
    _check_states(jnew, new, cfg_name)


@pytest.mark.parametrize("staleness", [0, 2])
def test_adpsgd_step_matches_jax(staleness, jax_oracles):
    """One AD-PSGD step from a buffer whose deeper slots differ from
    slot 0, so staleness 2 really reads other rows; snapshots compared
    slot by slot in the port's layout."""
    cfg_name = "bn-lenet"
    jnew, jmet, new, met, algo = _step_pair("adpsgd", cfg_name,
                                            staleness=staleness, step_idx=1)
    _check_metrics(jmet, met, exact=("comm_floats", "max_staleness_used"))
    assert float(met["mean_staleness"]) == staleness
    _check_states(jnew, new, cfg_name)
    leaves, treedef = jax.tree_util.tree_flatten(jnew["params"])
    sizes = np.cumsum([l[0].size for l in leaves])[:-1]
    assert new["snaps"].shape == (3, STEP_K, sizes[-1] + leaves[-1][0].size)
    for slot in range(3):
        parts = np.split(np.asarray(jnew["snaps"][slot]), sizes, axis=1)
        jtree = jax.tree_util.tree_unflatten(
            treedef, [a.reshape(l.shape) for a, l in zip(parts, leaves)])
        ref_p, _ = _port_layout((jtree, {}), cfg_name)
        _assert_trees_close(algo._unflatten(new["snaps"][slot],
                                            new["params"]),
                            ref_p, atol=1e-4, rtol=0)


def test_adpsgd_staleness0_is_dpsgd_bit_for_bit():
    new, met, _ = _port_step("adpsgd", "bn-lenet", staleness=0)
    dnew, dmet, _ = _port_step("dpsgd", "bn-lenet")
    for key in ("params", "vel", "mstate"):
        for n, t in dnew[key].items():
            assert torch.equal(new[key][n], t), (key, n)
    for key, v in dmet.items():
        assert torch.equal(met[key], v), key


@pytest.mark.parametrize("step_idx", [0, 1])
def test_fedavg_step_matches_jax(step_idx, jax_oracles):
    """iter_local 2: step 0 trains locally, step 1 syncs (params and BN
    state averaged over the nodes)."""
    cfg_name = "bn-lenet"
    jnew, jmet, new, met, _ = _step_pair("fedavg", cfg_name,
                                         step_idx=step_idx,
                                         hypers={"iter_local": 2})
    _check_metrics(jmet, met, exact=("comm_floats", "synced"))
    assert bool(met["synced"]) == (step_idx == 1)
    _check_states(jnew, new, cfg_name)
    synced = all(torch.equal(t, t[:1].expand_as(t))
                 for t in new["params"].values())
    assert synced == (step_idx == 1)


def test_dgc_randk_step_matches_jax(jax_oracles):
    """Rand-k keeps the same elements on both sides (the mask is a pure
    function of seed, tensor and flat index in the reference's layout),
    so the count is exact and every state tensor agrees."""
    cfg_name = "bn-lenet"
    jnew, jmet, new, met, _ = _step_pair(
        "dgc", cfg_name, step_idx=3, hypers={"sparsity": 0.75},
        dgc_compressor="randk")
    _check_metrics(jmet, met)
    _check_states(jnew, new, cfg_name, keys=("params", "vel", "acc"))


@pytest.mark.parametrize("algo_name,op,hypers,comm_kw", [
    ("gaia", "gaia_select_many", {"t0": 0.1}, {}),
    ("dgc", "rand_k_sparsify_many", {"sparsity": 0.75},
     {"dgc_compressor": "randk"}),
    ("dpsgd", "neighbor_mix_many", {}, {}),
    ("adpsgd", "neighbor_mix_push_many", {}, {})])
def test_step_filters_every_tensor_in_one_op(algo_name, op, hypers, comm_kw,
                                             monkeypatch):
    """Gaia's, DGC rand-k's, D-PSGD's and AD-PSGD's step call their
    multi-tensor op once, on every parameter tensor, and the
    single-tensor ops (the raw one-matrix ``neighbor_mix`` among them)
    not at all: on the card that is one kernel launch a step."""
    calls = []
    many = getattr(ops, op)

    def counted(*args, **kwargs):
        calls.append(len(args[0]))
        return many(*args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("a single-tensor op was called")
    monkeypatch.setattr(ops, op, counted)
    monkeypatch.setattr(ops, "gaia_select", refuse)
    monkeypatch.setattr(ops, "rand_k_sparsify", refuse)
    monkeypatch.setattr(ops, "neighbor_mix", refuse)
    _, _, algo = _port_step(algo_name, "bn-lenet", hypers=hypers, **comm_kw)
    assert calls == [len(init_cnn(torch.Generator().manual_seed(0),
                                  CNN_ZOO["bn-lenet"])[0])]


def test_dgc_topk_step_matches_jax(jax_oracles):
    """Top-k thresholds at the quantile of |v| computed as jnp.quantile
    does; an entry within rounding of the threshold may flip, as in
    Gaia's test: flips <= 1e-3, everything else at atol 1e-4."""
    cfg_name = "bn-lenet"
    jnew, jmet, new, met, _ = _step_pair("dgc", cfg_name,
                                         hypers={"sparsity": 0.9375})
    ref_acc, _ = _port_layout((jnew["acc"], {}), cfg_name)
    ref_v, _ = _port_layout((jnew["vel"], {}), cfg_name)
    ref_p, ref_s = _port_layout((jnew["params"], jnew["mstate"]), cfg_name)
    # vel is cleared exactly where the entry was shared
    flips = total = 0
    for n, a in new["acc"].items():
        shared, ref_shared = new["vel"][n] == 0, ref_v[n] == 0
        flip = shared != ref_shared
        flips += int(flip.sum())
        total += a.numel()
        keep = ~flip
        for port, ref_t in ((a, ref_acc[n]), (new["vel"][n], ref_v[n])):
            np.testing.assert_allclose(port[keep].numpy(),
                                       ref_t[keep].numpy(), atol=1e-4,
                                       rtol=0, err_msg=n)
        col = ~flip.any(dim=0)          # the global model sums the nodes
        np.testing.assert_allclose(new["params"][n][col].numpy(),
                                   ref_p[n][col].numpy(), atol=1e-4,
                                   rtol=0, err_msg=n)
    assert flips / total <= 1e-3, (flips, total)
    assert abs(float(met["comm_floats"]) - float(jmet["comm_floats"])) \
        <= flips / STEP_K
    for key in ("loss", "resid_delta"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=1e-3, err_msg=key)
    _assert_trees_close(new["mstate"], ref_s, atol=1e-4, rtol=0)


def test_gaia_step_matches_jax(jax_oracles):
    cfg_name = "bn-lenet"
    jnew, jmet, new, met, _ = _step_pair("gaia", cfg_name,
                                         hypers={"t0": 0.1})
    ref_acc, _ = _port_layout((jnew["acc"], {}), cfg_name)
    ref_p, ref_s = _port_layout((jnew["params"], jnew["mstate"]), cfg_name)
    ref_v, _ = _port_layout((jnew["vel"], {}), cfg_name)
    # acc starts at 0, so its pre-filter value is this step's update
    # (vel), and the shared part is what the filter cleared: a nonzero
    # update whose acc is now 0.  An update that is exactly 0 on one side
    # and a rounding residue on the other counts as a flip too.
    flips = total = 0
    for n, a in new["acc"].items():
        shared = (a == 0) & (new["vel"][n] != 0)
        ref_shared = (ref_acc[n] == 0) & (ref_v[n] != 0)
        flips += int((shared != ref_shared).sum())
        total += a.numel()
        # a flipped tie changes the whole column's applied update:
        # compare everything else at the stated tolerance
        keep = ~(shared != ref_shared).any(dim=0)
        for port, ref_t in ((new["params"][n], ref_p[n]), (a, ref_acc[n])):
            np.testing.assert_allclose(port[:, keep].numpy(),
                                       ref_t[:, keep].numpy(), atol=1e-4,
                                       rtol=0, err_msg=n)
        np.testing.assert_allclose(new["vel"][n].numpy(), ref_v[n].numpy(),
                                   atol=1e-4, rtol=0, err_msg=n)
    assert flips / total <= 1e-3, (flips, total)
    assert abs(float(met["comm_floats"]) - float(jmet["comm_floats"])) \
        <= flips / STEP_K + 1e-3
    for key in ("loss", "resid_delta"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=1e-4, err_msg=key)
    _assert_trees_close(new["mstate"], ref_s, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the trainer, end to end
# ---------------------------------------------------------------------------

def _partitions(K: int = 5):
    ds = synth_images(600, seed=0, noise=0.8, class_sep=0.35)
    val = synth_images(200, seed=99, noise=0.8, class_sep=0.35)
    idx = partition_label_skew(ds.y, K, 1.0, seed=1)
    return [(ds.x[i], ds.y[i]) for i in idx], (val.x, val.y)


def _trainer_pair(cfg_name: str, algo_name: str, monkeypatch, *,
                  steps: int = 5, **comm_kw):
    """``steps`` steps of ``train_decentralized`` on both sides, the
    port's initial parameters carried across from ``repro``."""
    parts, val = _partitions()
    p_np, s_np = _jax_init(cfg_name)
    monkeypatch.setattr(
        trainer, "init_cnn",
        lambda gen, cfg: cnn_params_from_jax(p_np, s_np, cfg))
    fabric = comm_kw.pop("topology", "ring")
    kw = dict(steps=steps, batch=20, lr=0.05, eval_every=steps, seed=0)
    jr = jax_trainer.train_decentralized(
        JAX_CNN_ZOO[cfg_name], algo_name, parts, val,
        comm=JaxCommConfig(fabric=JaxFabricConfig(topology=fabric),
                           **comm_kw), **kw)
    r = trainer.train_decentralized(
        CNN_ZOO[cfg_name], algo_name, parts, val,
        comm=CommConfig(fabric=FabricConfig(topology=fabric), **comm_kw),
        device="cpu", **kw)
    return jr, r


@pytest.mark.parametrize("algo_name,comm_kw,exact_comm", [
    ("gaia", {}, False), ("dpsgd", {}, True), ("adpsgd", {}, True),
    ("fedavg", {"iter_local": 2}, True), ("dgc", {}, False),
    ("dgc", {"dgc_compressor": "randk"}, True)],
    ids=["gaia", "dpsgd", "adpsgd", "fedavg", "dgc", "dgc-randk"])
def test_trainer_matches_jax(algo_name, comm_kw, exact_comm, monkeypatch,
                             jax_oracles):
    """Five steps of GN-LeNet.  Where the communication does not depend
    on the data (gossip, FedAvg's syncs, rand-k's seeded masks) it must
    be exact; Gaia's and DGC top-k's counts can move with a flipped
    tie."""
    jr, r = _trainer_pair("gn-lenet", algo_name, monkeypatch, **comm_kw)
    losses = np.array([l for _, l in r.loss_curve])
    np.testing.assert_allclose(losses, [l for _, l in jr.loss_curve],
                               rtol=1e-3)
    assert np.all(np.isfinite(losses))
    assert r.topology == jr.topology
    if exact_comm:
        assert r.comm_total_floats == jr.comm_total_floats
    else:
        np.testing.assert_allclose(r.comm_total_floats,
                                   jr.comm_total_floats, rtol=1e-3)
    if algo_name in ("dpsgd", "adpsgd"):
        assert r.extras["ledger"] == jr.extras["ledger"]
        assert r.sim_time_s == jr.sim_time_s
    if algo_name == "adpsgd":
        assert r.extras["staleness_curve"] == jr.extras["staleness_curve"]


def _thetas(history):
    name = lambda th: getattr(th, "name", th)
    return [(h.step, name(h.theta), name(h.new_theta)) for h in history]


@pytest.mark.parametrize("algo_name,comm_kw,ladder", [
    ("gaia", {"topology": "full"}, None),
    ("dpsgd", {}, "topology_ladder"),
    ("adpsgd", {"async_gossip": True}, "staleness_ladder")],
    ids=["gaia", "dpsgd", "adpsgd"])
def test_skewscout_matches_jax(algo_name, comm_kw, ladder, monkeypatch,
                               jax_oracles):
    """SkewScout over Gaia's θ ladder, D-PSGD's topology ladder and
    AD-PSGD's staleness ladder: the same probes (2K evaluations a travel
    on 256-sample subsets) steer θ through the same sequence; accuracy
    losses agree within one sample in 256."""
    jr, r = _trainer_pair("gn-lenet", algo_name, monkeypatch, steps=6,
                          skewscout=True, travel_every=2, **comm_kw)
    assert len(r.skewscout_history) == 3
    assert _thetas(r.skewscout_history) == _thetas(jr.skewscout_history)
    for h, jh in zip(r.skewscout_history, jr.skewscout_history):
        assert abs(h.accuracy_loss - jh.accuracy_loss) <= 1 / 256
        assert h.probe_edges == jh.probe_edges
        assert h.probe_floats == jh.probe_floats
    np.testing.assert_allclose([l for _, l in r.loss_curve],
                               [l for _, l in jr.loss_curve], rtol=1e-3)
    assert r.topology == jr.topology
    if ladder is not None:
        assert r.extras[ladder] == jr.extras[ladder]


def test_trainer_defaults_to_cuda(monkeypatch):
    parts, val = _partitions()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.train_decentralized(CNN_ZOO["gn-lenet"], "bsp", parts, val,
                                    steps=1)


def test_unknown_strategy_raises():
    parts, val = _partitions()
    with pytest.raises(ValueError, match="sgd"):
        trainer.train_decentralized(CNN_ZOO["gn-lenet"], "sgd", parts, val,
                                    steps=1, device="cpu")


def test_staleness_outside_bound_raises():
    fns, _ = trainer.make_cnn_fns(CNN_ZOO["gn-lenet"])
    comm = CommConfig(fabric=FabricConfig(topology="ring"), max_staleness=2)
    algo = trainer.make_algorithm("adpsgd", fns, 5, comm)
    assert algo.staleness == 2
    algo.set_staleness(0)
    assert algo.staleness == 0
    for bad in (-1, 3):
        with pytest.raises(ValueError, match="bound"):
            algo.set_staleness(bad)
        with pytest.raises(ValueError, match="bound"):
            trainer.make_algorithm("adpsgd", fns, 5, comm, staleness=bad)
    assert algo.staleness == 0


def test_set_schedule_refuses_wider_pad_once_stepped():
    """A rung switch may not widen the neighbour operands after the first
    step; with ``pad_degree`` set to the ladder's max it never has to."""
    fns, _ = trainer.make_cnn_fns(CNN_ZOO["lenet"])
    algo = trainer.make_algorithm(
        "dpsgd", fns, 5, CommConfig(fabric=FabricConfig(topology="ring")))
    params, _ = trainer.init_cnn(torch.Generator().manual_seed(0),
                                 CNN_ZOO["lenet"])
    state = algo.init(params, {})
    algo.set_schedule(build_schedule("full", 5))    # before any step: grows
    algo.set_schedule(build_schedule("ring", 5))
    batch = {"x": torch.zeros(5, 2, 16, 16, 3),
             "y": torch.zeros(5, 2, dtype=torch.long)}
    algo.step(state, batch, torch.tensor(0.05), 0)
    algo.set_schedule(build_schedule("full", 5))    # pad is already 4
    narrow = trainer.make_algorithm(
        "dpsgd", fns, 5, CommConfig(fabric=FabricConfig(topology="ring")))
    narrow.step(narrow.init(params, {}), batch, torch.tensor(0.05), 0)
    with pytest.raises(ValueError, match="pad_degree"):
        narrow.set_schedule(build_schedule("full", 5))


# ---------------------------------------------------------------------------
# host side: the NumPy copies are bit-equal
# ---------------------------------------------------------------------------

def test_data_and_partitions_bit_equal():
    a = synth_images(300, seed=4, noise=0.8, class_sep=0.35)
    b = jax_synth_images(300, seed=4, noise=0.8, class_sep=0.35)
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    for skew in (0.0, 0.5, 1.0):
        for p, q in zip(partition_label_skew(a.y, 5, skew, seed=1),
                        jax_partition(b.y, 5, skew, seed=1)):
            np.testing.assert_array_equal(p, q)
    idx = partition_label_skew(a.y, 5, 1.0, seed=1)
    parts = [(a.x[i], a.y[i]) for i in idx]
    mine, theirs = DecentralizedLoader(parts, 8, seed=3), \
        JaxLoader(parts, 8, seed=3)
    for _ in range(12):
        for u, v in zip(mine.next_stacked(), theirs.next_stacked()):
            np.testing.assert_array_equal(u, v)


def test_rng_bit_equal():
    ctr = np.arange(1000, dtype=np.int64)
    key = rng.fold_key(7, 0x0A, 3)
    assert key == jax_rng.fold_key(7, 0x0A, 3)
    ii, jj = np.arange(20), np.arange(20)[::-1]
    np.testing.assert_array_equal(rng.fold_keys(key, ii, jj),
                                  jax_rng.fold_keys(key, ii, jj))
    np.testing.assert_array_equal(rng.uniform_bits(key, ctr),
                                  jax_rng.uniform_bits(key, ctr))
    np.testing.assert_array_equal(rng.uniform01(key, ctr),
                                  jax_rng.uniform01(key, ctr))
    np.testing.assert_array_equal(rng.normal01(key, ctr),
                                  jax_rng.normal01(key, ctr))


@pytest.mark.parametrize("topology", ["ring", "tv-dcliques"])
@pytest.mark.parametrize("profile", ["uniform", "geo-wan"])
def test_ledger_summary_equal(topology, profile):
    K = 10
    hist = full_skew_label_hist(K, 5) if topology == "tv-dcliques" else None
    mine = CommLedger(build_schedule(topology, K, label_hist=hist, seed=2),
                      LINK_PROFILES[profile])
    theirs = JaxLedger(jax_build_schedule(topology, K, label_hist=hist,
                                          seed=2), JAX_LINK_PROFILES[profile])
    for t in range(10):
        mine.record_gossip(1234.0, t=t)
        theirs.record_gossip(1234.0, t=t)
        mine.record_exchange(55.5)
        theirs.record_exchange(55.5)
    assert mine.summary() == theirs.summary()


@pytest.mark.parametrize("window,rewire", [(1, 0.0), (3, 0.0), (4, 250.0)])
def test_ledger_fabric_config_knobs_equal(window, rewire):
    """The port's ledger takes its amortization and re-wiring knobs only
    from ``config=``; on a schedule that re-wires every round they price
    as the reference's do."""
    K = 10
    hist = full_skew_label_hist(K, 5)
    mine = CommLedger(
        build_schedule("tv-dcliques", K, label_hist=hist, seed=2),
        LINK_PROFILES["geo-wan"],
        config=FabricConfig(amortize_window=window, rewire_floats=rewire))
    theirs = JaxLedger(
        jax_build_schedule("tv-dcliques", K, label_hist=hist, seed=2),
        JAX_LINK_PROFILES["geo-wan"],
        config=JaxFabricConfig(amortize_window=window, rewire_floats=rewire))
    for t in range(7):
        mine.record_gossip(1234.0, t=t)
        theirs.record_gossip(1234.0, t=t)
    assert mine.summary() == theirs.summary()
    assert mine.view().amortize_window == window
    assert (mine.view().rewire_floats > 0) == (rewire > 0)


# ---------------------------------------------------------------------------
# import hygiene: the port runs where JAX is not installed
# ---------------------------------------------------------------------------

def test_port_import_loads_no_jax_or_repro():
    code = ("import sys, repro_torch.core.trainer, "
            "repro_torch.kernels.dgc_topk, "
            "repro_torch.benchmarks.kernels_bench, "
            "repro_torch.models.model, repro_torch.launch.steps, "
            "repro_torch.examples.serve_decode, "
            "repro_torch.benchmarks.run, "
            "repro_torch.examples.quickstart, "
            "repro_torch.examples.skewscout_adaptive, "
            "repro_torch.examples.train_topology\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_or_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        bad = {m for m in _imported_roots(f)} & {"jax", "jaxlib", "repro"}
        assert not bad, (f, bad)
