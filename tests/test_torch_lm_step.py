"""The port's LM train step against the JAX reference, on the CPU: one
step a strategy, the DGC threshold and the training example (split from
``test_torch_lm_train.py``, which holds ``loss_fn``, remat and the
attention's autograd route, so that no module of port tests takes a
worker's whole share of a parallel run).

The same NumPy inputs, made from a seed, go through ``repro`` and
``repro_torch``; the weights are the reference's ``init_model``'s, carried
across by ``lm_params_from_jax``.  Everything in float32.

Tolerances:
- one train step a strategy: each leaf of params, vel, acc and the
  snapshots within 1e-4, and within 1e-3 of the reference's largest
  change to that leaf in the step plus 4 float32 ulps of its largest
  entry (the update is lr x a gradient that XLA and ATen sum in another
  order); metrics
  equal (1e-5 relative); the DGC threshold bit for bit on identical
  inputs.  A state left unchanged, or a bsp step without the cross-pod
  mean, fails that comparison (``test_step_comparison_flags_a_fault``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro.configs.base import CommConfig as JaxCommConfig
from repro.configs.base import FabricConfig as JaxFabricConfig
from repro.configs.registry import get_config as jax_get_config
from repro.kernels import ref as jax_kref
from repro.launch import steps as jax_steps
from repro.models import model as jax_model
from repro.topology.graphs import build_demo_schedule as jax_demo_schedule
from repro_torch import pytree
from repro_torch.configs import registry
from repro_torch.configs.base import CommConfig, FabricConfig
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import model
from repro_torch.topology.graphs import build_demo_schedule

STEP_ABS, STEP_TOL, STEP_ULPS = 1e-4, 1e-3, 4


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _normal(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _to_torch(tree):
    return model.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                    "cpu")


# ---------------------------------------------------------------------------
# (iii) one train step a strategy
# ---------------------------------------------------------------------------

N_PODS, STEP_B, STEP_T, STEP_LR = 2, 2, 16, 1e-2
#: comm fields of each case: Gaia at a threshold that selects a share of
#: the first steps' updates; FedAvg syncing every second step; DGC at the
#: example's sparsity; AD-PSGD reading slot 1 of 3
STEP_CASES = {
    "bsp": {}, "gaia": {"gaia_t0": 0.05}, "fedavg": {"iter_local": 2},
    "dgc": {"dgc_sparsity": 0.95}, "dpsgd": {},
    "adpsgd": {"max_staleness": 2}}
STALENESS = 1


def _step_batch(seed, vocab):
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, vocab, (N_PODS, STEP_B, STEP_T + 1)).astype(
        np.int32)
    nb = {"tokens": seqs[..., :-1], "labels": seqs[..., 1:]}
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v).long() for k, v in nb.items()})


def _reference_step(strategy, jcfg, jcomm):
    """The reference's step on one card.  bsp, gaia, fedavg and dgc: its
    jitted ``make_train_step`` with no mesh (DGC's sparsity a float32
    runtime operand).  dpsgd and adpsgd, whose exchange needs a ``pod``
    mesh there: its fedavg step with ``iter_local`` past every step (the
    local momentum step alone), then ``repro.kernels.ref``'s padded mix
    (dpsgd), or the snapshot push and ``neighbor_mix_src_ref`` over the
    buffer's ((S + 1) K) rows (adpsgd), on its own ``gossip_operands``."""
    if strategy not in steps.GOSSIP_STRATEGIES:
        fn = jax.jit(jax_steps.make_train_step(jcfg, jcomm, lr=STEP_LR))
        sparsity = (jnp.float32(jcomm.dgc_sparsity) if strategy == "dgc"
                    else None)
        return lambda st, b, t: fn(st, b, t, sparsity=sparsity)
    local = jax.jit(jax_steps.make_train_step(
        jcfg, dataclasses.replace(jcomm, strategy="fedavg",
                                  iter_local=10 ** 9), lr=STEP_LR))
    sched = jax_demo_schedule("ring", N_PODS)

    def step(st, b, t):
        new, met = local({"params": st["params"], "vel": st["vel"]}, b, t)
        if strategy == "dpsgd":
            idx, w, sw = jax_steps.gossip_operands(sched, t)
            mix = lambda x: jax_kref.neighbor_mix_padded_ref(
                x.reshape(N_PODS, -1), idx, w, sw).reshape(x.shape)
            new["params"] = jax.tree_util.tree_map(mix, new["params"])
        else:
            S1 = jcomm.max_staleness + 1
            idx, w, sw, stale = jax_steps.gossip_operands(
                sched, t, staleness=STALENESS,
                max_staleness=jcomm.max_staleness)
            new["snaps"] = jax.tree_util.tree_map(
                lambda s_, x: jnp.concatenate([x[None], s_[:-1]]),
                st["snaps"], new["params"])
            gidx = stale * N_PODS + idx

            def mix(x, s_):
                return jax_kref.neighbor_mix_src_ref(
                    x.reshape(N_PODS, -1), s_.reshape(S1 * N_PODS, -1),
                    gidx, w, sw).reshape(x.shape)
            new["params"] = jax.tree_util.tree_map(mix, new["params"],
                                                   new["snaps"])
            mask = (w > 0).astype(jnp.float32)
            met["mean_staleness"] = jnp.sum(stale * mask) / jnp.maximum(
                jnp.sum(mask), 1.0)
        deg = jnp.sum(w > 0).astype(jnp.float32) / N_PODS
        n = sum(l.size for l in jax.tree_util.tree_leaves(st["params"]))
        met["mean_degree"] = deg
        met["comm_floats"] = deg * (n / N_PODS)
        return new, met
    return step


def _port_state(jstate):
    """The reference's train state as the port's: the same trees, and
    AD-PSGD's per-leaf snapshot buffers as one flat buffer a dtype."""
    state = {k: _to_torch(v) for k, v in jstate.items() if k != "snaps"}
    if "snaps" in jstate:
        snaps = [torch.from_numpy(np.array(a)) for a in
                 jax.tree_util.tree_leaves(jstate["snaps"])]
        state["snaps"] = {
            pytree.dtype_name(dt): torch.cat(
                [snaps[i].reshape(snaps[i].shape[0], N_PODS, -1)
                 for i in idx], dim=2)
            for dt, idx in steps.dtype_groups(snaps).items()}
    return state


def _snap_leaves(state, like):
    """The port's flat snapshot buffers split back into per-leaf (S + 1,
    n_pods, ...) tensors shaped like the reference's ``like`` leaves."""
    out = [None] * len(like)
    leaves = pytree.leaves(state["params"])
    for dt, idx in steps.dtype_groups(leaves).items():
        buf = state["snaps"][pytree.dtype_name(dt)]
        off = 0
        for i in idx:
            n = leaves[i][0].numel()
            out[i] = buf[:, :, off:off + n].reshape(like[i].shape)
            off += n
    return out


def _leaf_bound(new, old):
    """``STEP_TOL`` x the reference's largest change to a leaf in the
    step, plus ``STEP_ULPS`` float32 ulps of its largest entry, and at
    most ``STEP_ABS``."""
    change = float(np.abs(new - old).max(initial=0.0))
    return min(STEP_ABS, STEP_TOL * change + STEP_ULPS * float(
        np.finfo(np.float32).eps) * float(np.abs(new).max(initial=0.0)))


def _state_matches(state, jstate, jstate0, strategy):
    """Params, vel, acc and snapshots of the port's step against the
    reference's step ``jstate0`` -> ``jstate``, each leaf within
    ``_leaf_bound``; for Gaia and DGC an entry within rounding of its
    threshold may flip (its acc is zero on one side only): at most 1e-3
    of the entries, left out of the comparison with every pod's param at
    that position."""
    flip = None
    if "acc" in jstate:
        got = pytree.leaves(state["acc"])
        want = [_np32(a) for a in jax.tree_util.tree_leaves(jstate["acc"])]
        flip = [(_np32(g) == 0) != (w_ == 0) for g, w_ in zip(got, want)]
        n_flip = sum(int(f.sum()) for f in flip)
        assert n_flip <= 1e-3 * sum(f.size for f in flip), n_flip
    for key in ("params", "vel", "acc"):
        if key not in jstate:
            assert key not in state
            continue
        got = pytree.leaves(state[key])
        want = [_np32(a) for a in jax.tree_util.tree_leaves(jstate[key])]
        before = [_np32(a) for a in jax.tree_util.tree_leaves(jstate0[key])]
        assert len(got) == len(want)
        for i, (g, w_, w0) in enumerate(zip(got, want, before)):
            g = _np32(g)
            assert g.shape == w_.shape, (key, i)
            ok = np.ones(g.shape, bool)
            if flip is not None:
                ok = ~flip[i] if key != "params" else \
                    np.broadcast_to(~flip[i].any(axis=0), g.shape)
            np.testing.assert_allclose(g[ok], w_[ok], rtol=0,
                                       atol=_leaf_bound(w_, w0),
                                       err_msg=f"{strategy} {key} leaf {i}")
    if "snaps" in jstate:
        want = jax.tree_util.tree_leaves(jstate["snaps"])
        before = jax.tree_util.tree_leaves(jstate0["snaps"])
        for i, (g, w_, w0) in enumerate(zip(_snap_leaves(state, want), want,
                                            before)):
            w_ = _np32(w_)
            np.testing.assert_allclose(_np32(g), w_, rtol=0,
                                       atol=_leaf_bound(w_, _np32(w0)),
                                       err_msg=f"{strategy} snaps leaf {i}")


@pytest.mark.parametrize("strategy,t0,t1", [
    ("bsp", 0, 1), ("gaia", 0, 1), ("fedavg", 0, 1), ("fedavg", 1, 2),
    ("dgc", 0, 1), ("dpsgd", 0, 1), ("adpsgd", 0, 1)],
    ids=["bsp", "gaia", "fedavg_sync", "fedavg_local", "dgc", "dpsgd",
         "adpsgd"])
def test_train_step_matches_reference(strategy, t0, t1):
    """Two steps, ``t0`` then ``t1``: the reference's first step from the
    fresh state gives a state with nonzero vel and acc (and AD-PSGD's
    buffer slots apart), which both packages then step from, each
    compared with the reference's step on the same state.  FedAvg syncs
    at t = 1 (iter_local 2)."""
    fields = STEP_CASES[strategy]
    jcfg = jax_get_config("qwen3-0.6b").reduced()
    cfg = registry.get_config("qwen3-0.6b").reduced()
    jcomm = JaxCommConfig(strategy=strategy, fabric=JaxFabricConfig(
        topology="ring"), **fields)
    comm = CommConfig(strategy=strategy, fabric=FabricConfig(
        topology="ring"), **fields)
    jp = jax_model.init_model(jax.random.PRNGKey(0), jcfg)
    jstate = jax_steps.make_train_state(jp, jcomm, N_PODS)
    ref_step = _reference_step(strategy, jcfg, jcomm)
    train_step = steps.make_train_step(cfg, comm, lr=STEP_LR)
    sched = build_demo_schedule("ring", N_PODS)
    for t in (t0, t1):
        jb, b = _step_batch(t, cfg.vocab)
        kw = {}
        if strategy in steps.GOSSIP_STRATEGIES:
            kw["mix"] = steps.gossip_operands(
                sched, t, device="cpu",
                **({"staleness": STALENESS,
                    "max_staleness": comm.max_staleness}
                   if strategy == "adpsgd" else {}))
        if strategy == "dgc":
            kw["sparsity"] = comm.dgc_sparsity
        state, metrics = train_step(_port_state(jstate), b, t, **kw)
        jstate0 = jstate
        jstate, jmetrics = ref_step(jstate, jb, t)
        _state_matches(state, jstate, jstate0, strategy)
        assert sorted(metrics) == sorted(jmetrics)
        for k, v in metrics.items():
            assert v.dtype == torch.float32 and v.dim() == 0
            np.testing.assert_allclose(float(v), float(jmetrics[k]),
                                       rtol=1e-5, atol=0, err_msg=k)


@pytest.mark.parametrize("fault", ["state_unchanged", "bsp_not_averaged"])
def test_step_comparison_flags_a_fault(fault):
    """The step comparison is tight enough to see a wrong step: the
    reference's bsp step from a state with nonzero vel against a port
    state that was not stepped, or that took the pods' own gradients (a
    local step, fedavg between syncs) where bsp takes their mean."""
    jcfg = jax_get_config("qwen3-0.6b").reduced()
    cfg = registry.get_config("qwen3-0.6b").reduced()
    jcomm = JaxCommConfig(strategy="bsp")
    jp = jax_model.init_model(jax.random.PRNGKey(0), jcfg)
    ref_step = _reference_step("bsp", jcfg, jcomm)
    jstate0, _ = ref_step(jax_steps.make_train_state(jp, jcomm, N_PODS),
                          _step_batch(0, cfg.vocab)[0], 0)
    jb, b = _step_batch(1, cfg.vocab)
    jstate, _ = ref_step(jstate0, jb, 1)
    if fault == "state_unchanged":
        state = _port_state(jstate0)
    else:
        local = steps.make_train_step(
            cfg, CommConfig(strategy="fedavg", iter_local=10 ** 9),
            lr=STEP_LR)
        state, _ = local(_port_state(jstate0), b, 1)
    with pytest.raises(AssertionError):
        _state_matches(state, jstate, jstate0, "bsp")


def test_fedavg_syncs_only_at_its_step():
    """At t % iter_local == iter_local - 1 every pod holds the pods' mean,
    at any other t the pods differ."""
    cfg = registry.get_config("qwen3-0.6b").reduced()
    comm = CommConfig(strategy="fedavg", iter_local=3)
    p = model.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    step = steps.make_train_step(cfg, comm, lr=STEP_LR)
    for t, synced in ((0, False), (1, False), (2, True), (5, True)):
        state = steps.make_train_state(p, comm, N_PODS)
        state, _ = step(state, _step_batch(t, cfg.vocab)[1], t)
        same = all(torch.equal(x[0], x[1])
                   for x in pytree.leaves(state["params"]))
        assert same == synced, t


def test_gossip_operands_refuse_what_the_step_cannot_take():
    cfg = registry.get_config("qwen3-0.6b").reduced()
    sched = build_demo_schedule("ring", N_PODS)
    with pytest.raises(ValueError, match="max_staleness"):
        steps.gossip_operands(sched, 0, staleness=1, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        steps.gossip_operands(sched, 0, staleness=3, max_staleness=2,
                              device="cpu")
    p = model.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    _, b = _step_batch(0, cfg.vocab)
    for strategy, mix in (
            ("dpsgd", None),
            ("dpsgd", steps.gossip_operands(sched, 0, staleness=1,
                                            max_staleness=2, device="cpu")),
            ("adpsgd", steps.gossip_operands(sched, 0, device="cpu")),
            ("dpsgd", steps.gossip_operands(build_demo_schedule("ring", 3),
                                            0, device="cpu"))):
        comm = CommConfig(strategy=strategy)
        step = steps.make_train_step(cfg, comm)
        with pytest.raises(ValueError):
            step(steps.make_train_state(p, comm, N_PODS), b, 0, mix=mix)
    with pytest.raises(ValueError, match="unknown strategy"):
        steps.make_train_step(cfg, CommConfig(strategy="allreduce"))


# ---------------------------------------------------------------------------
# (iv) the DGC threshold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 37, 4096, 100_003])
@pytest.mark.parametrize("sparsity", [0.5, 0.9, 0.95, 0.999])
def test_hist_threshold_matches_reference_bit_for_bit(n, sparsity):
    """The port's ``hist_threshold`` against the reference's on the same
    float32 v, with the sparsity as a host number and as a float32
    operand; ``ops.dgc_sparsify``'s plain route (the train step's)
    against the reference's with the float32 operand, which rounds the
    count to reach as it does: threshold and selection bit for bit."""
    v = _normal(n, n) * np.float32(0.01)
    v[1::7] = 0.0                          # zeros and ties at 0
    jv, tv = jnp.asarray(v), torch.from_numpy(v)
    jt = jax.jit(lambda x, s: jax_steps.hist_threshold(x, s))
    want_f32 = float(jt(jv, jnp.float32(sparsity)))
    want_host = float(jax_steps.hist_threshold(jv, sparsity))
    assert float(steps.hist_threshold(tv, sparsity)) == want_host
    assert float(steps.hist_threshold(
        tv, torch.tensor(sparsity, dtype=torch.float32))) == want_f32
    sel, cnt, t = ops.dgc_sparsify(tv, sparsity)
    assert float(t) == want_f32
    mask = np.abs(v) > np.float32(want_f32)
    np.testing.assert_array_equal(sel.numpy(), np.where(mask, v, 0))
    assert int(cnt) == int(mask.sum())


def test_dgc_threshold_of_an_all_zero_v():
    """An all-zero v: the reference clamps max|v| to 1e-30 before the
    upper edge, ``dgc_sparsify`` (as the reference's kernel op) does not,
    so the thresholds are (b + 1) / 256 * 1e-30 and 0; both select
    nothing, and the train step's exchange is the same."""
    v = np.zeros(1000, np.float32)
    want = float(jax_steps.hist_threshold(jnp.asarray(v), jnp.float32(0.9)))
    assert float(steps.hist_threshold(torch.from_numpy(v),
                                      torch.tensor(0.9))) == want > 0.0
    sel, cnt, t = ops.dgc_sparsify(torch.from_numpy(v), 0.9)
    assert float(t) == 0.0 and int(cnt) == 0 and not sel.any()


# ---------------------------------------------------------------------------
# the training example
# ---------------------------------------------------------------------------

def test_train_lm_example_learns_and_checkpoints(tmp_path):
    """``train_lm_decentralized`` on the CPU, cut to 2 layers of d_model
    128 and 60 steps of 64 tokens: it passes its own loss < 5.5 (it reads
    5.04 here) and writes the pods' params in the reference's format,
    which the reference restores."""
    from repro_torch.examples import train_lm_decentralized as ex
    argv = ["--device", "cpu", "--strategy", "gaia", "--steps", "60",
            "--seq", "64", "--d-model", "128", "--layers", "2",
            "--ckpt", str(tmp_path)]
    assert ex.main(argv) == 0
    from repro import checkpointing as jax_ckpt
    assert jax_ckpt.latest_step(str(tmp_path)) == 60
    cfg = ex.model_config(128, 2)
    like = steps.make_train_state(
        model.init_model(torch.Generator().manual_seed(0), cfg, "cpu"),
        CommConfig(strategy="gaia"), ex.N_PODS)["params"]
    from repro_torch import checkpointing as ckpt
    back = ckpt.restore(str(tmp_path), like, step=60)
    assert all(bool(torch.isfinite(t).all()) for t in pytree.leaves(back))


@pytest.mark.parametrize("strategy", steps.STRATEGIES)
def test_train_lm_example_runs_every_strategy(strategy):
    """Every strategy of the example's ``--strategy`` trains 12 small
    steps: finite losses, falling."""
    from repro_torch.examples import train_lm_decentralized as ex
    run = ex.train(ex.parse_args(
        ["--device", "cpu", "--strategy", strategy, "--steps", "12",
         "--seq", "16", "--d-model", "64", "--layers", "2",
         "--batch-per-pod", "2"]))
    losses = [x for _, x in run["losses"]]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
