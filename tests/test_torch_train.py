"""The port's training path against the JAX reference, on the CPU.

Weights cannot come from the same random draws (``jax.random`` has no
PyTorch counterpart), so every comparison carries ``repro``'s initial
parameters across with ``cnn_params_from_jax``; inputs are NumPy arrays
made from a seed.  Tolerances: the model (logits, loss, gradients, BN
state) at rtol 1e-4 / atol 1e-5, float32 sums taken in another order by
XLA and ATen; one algorithm step at atol 1e-4; five trainer steps'
losses within 1e-3 relative.  Host-side NumPy code (data, partitions,
topology, ledger, RNG) is a copy and must be bit-equal.
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
import repro_torch.core.trainer as trainer
from repro_torch.configs.base import CommConfig, FabricConfig
from repro_torch.configs.cnn_zoo import CNN_ZOO
from repro_torch.core.algorithms.base import tree_size
from repro_torch.core.partition import partition_label_skew
from repro_torch.data.pipeline import DecentralizedLoader
from repro_torch.data.synthetic import synth_images
from repro_torch.kernels import rng
from repro_torch.models.cnn import (cnn_apply, cnn_batch_stats,
                                   cnn_params_from_jax)
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


# ---------------------------------------------------------------------------
# one algorithm step
# ---------------------------------------------------------------------------

STEP_K, STEP_B = 4, 8


def _step_pair(algo_name: str, cfg_name: str):
    """One step of ``algo_name`` on both sides from the same state and
    batch.  Returns (jax state, jax metrics, port state, port metrics)."""
    p_np, s_np = _jax_init(cfg_name)
    rs = np.random.default_rng(2)
    x = rs.standard_normal((STEP_K, STEP_B, 16, 16, 3)).astype(np.float32)
    y = rs.integers(0, 10, size=(STEP_K, STEP_B)).astype(np.int32)
    lr = 0.05
    jcomm = JaxCommConfig(fabric=JaxFabricConfig(topology="ring"))
    comm = CommConfig(fabric=FabricConfig(topology="ring"))

    jfns, _ = jax_trainer.make_cnn_fns(JAX_CNN_ZOO[cfg_name])
    jalgo = jax_trainer.make_algorithm(algo_name, jfns, STEP_K, jcomm, lr0=lr)
    jstate = jalgo.init(p_np, s_np)
    jkw = {"t0": jnp.float32(0.1)} if algo_name == "gaia" else {}
    jnew, jmet = jalgo.step(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                            jnp.float32(lr), jnp.int32(0), **jkw)

    cfg = CNN_ZOO[cfg_name]
    fns, _ = trainer.make_cnn_fns(cfg)
    algo = trainer.make_algorithm(algo_name, fns, STEP_K, comm, lr0=lr)
    params, state = cnn_params_from_jax(p_np, s_np, cfg)
    kw = {"t0": torch.tensor(0.1)} if algo_name == "gaia" else {}
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}
    new, met = algo.step(algo.init(params, state), batch, torch.tensor(lr),
                         0, **kw)
    return jnew, jmet, new, met


def _port_layout(jtree, cfg_name: str):
    """A stacked JAX params/state pytree in the port's names and layout."""
    p, s = jtree
    return cnn_params_from_jax(_np(p), _np(s), CNN_ZOO[cfg_name])


@pytest.mark.parametrize("algo_name", ["bsp", "dpsgd"])
def test_algorithm_step_matches_jax(algo_name, jax_oracles):
    cfg_name = "bn-lenet"
    jnew, jmet, new, met = _step_pair(algo_name, cfg_name)
    assert float(met["comm_floats"]) == float(jmet["comm_floats"])
    for key in set(jmet) - {"comm_floats"}:
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=1e-4, err_msg=key)
    for key in ("params", "vel"):
        ref_p, _ = _port_layout((jnew[key], {}), cfg_name)
        _assert_trees_close(new[key], ref_p, atol=1e-4, rtol=0)
    _, ref_s = _port_layout((jnew["params"], jnew["mstate"]), cfg_name)
    _assert_trees_close(new["mstate"], ref_s, atol=1e-4, rtol=0)


def test_gaia_step_matches_jax(jax_oracles):
    cfg_name = "bn-lenet"
    jnew, jmet, new, met = _step_pair("gaia", cfg_name)
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


@pytest.mark.parametrize("algo_name", ["gaia", "dpsgd"])
def test_trainer_matches_jax(algo_name, monkeypatch, jax_oracles):
    parts, val = _partitions()
    cfg_name = "gn-lenet"
    p_np, s_np = _jax_init(cfg_name)
    monkeypatch.setattr(
        trainer, "init_cnn",
        lambda gen, cfg: cnn_params_from_jax(p_np, s_np, cfg))
    kw = dict(steps=5, batch=20, lr=0.05, eval_every=5, seed=0)
    jr = jax_trainer.train_decentralized(
        JAX_CNN_ZOO[cfg_name], algo_name, parts, val,
        comm=JaxCommConfig(fabric=JaxFabricConfig(topology="ring")), **kw)
    r = trainer.train_decentralized(
        CNN_ZOO[cfg_name], algo_name, parts, val,
        comm=CommConfig(fabric=FabricConfig(topology="ring")),
        device="cpu", **kw)
    losses = np.array([l for _, l in r.loss_curve])
    np.testing.assert_allclose(losses, [l for _, l in jr.loss_curve],
                               rtol=1e-3)
    assert np.all(np.isfinite(losses))
    assert r.topology == jr.topology
    if algo_name == "dpsgd":
        assert r.comm_total_floats == jr.comm_total_floats
        assert r.extras["ledger"] == jr.extras["ledger"]
        assert r.sim_time_s == jr.sim_time_s
    else:
        np.testing.assert_allclose(r.comm_total_floats,
                                   jr.comm_total_floats, rtol=1e-3)


def test_trainer_defaults_to_cuda(monkeypatch):
    parts, val = _partitions()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.train_decentralized(CNN_ZOO["gn-lenet"], "bsp", parts, val,
                                    steps=1)


@pytest.mark.parametrize("algo_name,comm", [
    ("fedavg", CommConfig()), ("dgc", CommConfig()), ("adpsgd", CommConfig()),
    ("gaia", CommConfig(skewscout=True))])
def test_unported_strategies_raise(algo_name, comm):
    parts, val = _partitions()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trainer.train_decentralized(CNN_ZOO["gn-lenet"], algo_name, parts,
                                    val, comm=comm, steps=1, device="cpu")


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
    code = ("import sys, repro_torch.core.trainer\n"
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
