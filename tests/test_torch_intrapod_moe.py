"""Training the MLA and MoE families inside a pod, and a ``model`` axis
wider than n_kv_heads, on the CPU: gloo ranks started by
``repro_torch.launch.procs.spawn`` split a pod over a ``data`` x
``model`` grid (FSDP over ``data``, tensor and expert parallelism over
``model``), against the one-device port and the JAX reference (imported
by the fixtures only: the ranks import this file and need no JAX).

One spawn of four ranks, each on one thread, with a deadline
(``SPAWN_TIMEOUT``), runs every rank-side case once (a module-scoped
fixture); the parametrized tests read its results:
(i) the pod's loss and each gathered gradient leaf of the reduced
    deepseek-v2-lite-16b, deepseek-v2-236b and minicpm3-4b on (1, 2, 2)
    (deepseek-lite also on (1, 1, 4)) under both MoE routes, the train
    step's ``pod_grads``; with remat on and off;
(ii) one MoE layer's gradients (x, router, experts, shared experts) under
    both routes on tokens pushed towards experts 0 and 1, so that the EP
    route's per-shard capacity drops pairs;
(iii) one step and the exchange of each of the six strategies on
    (2, 2, 1) and (2, 1, 2) for the reduced deepseek-lite, and a
    checkpoint of the gaia state on each;
(iv) the reduced starcoder2-3b (4 heads over 2 KV heads) and the reduced
    qwen3-0.6b with 2 KV heads (its ``k_norm``) on (1, 1, 4): each KV head
    serves two ranks; the gradient, and prefill and decode under the
    flash-decode and the heads placements of the cache.

Tolerances, float32:
- the pod's loss and each gathered gradient leaf against the one-device
  port's ``loss_fn`` and against ``jax.value_and_grad`` of the
  reference's (dense route), or against the one-device ``loss_fn`` whose
  MoE layers run ``moe_apply_ep_ref`` over the mesh's shards (EP route):
  within 2e-5 x max(1, max|leaf|) (the North star's float32 bound);
- the MoE layer's gradients under the EP route against the autograd of
  ``moe_apply_ep_ref``, and (routed experts only) against ``jax.grad``
  through the reference's ``moe_apply_ep`` under ``shard_map``, in a
  subprocess with four host devices: the same bound;
- remat on against remat off on the mesh: bit for bit (each
  checkpointed cycle routes again on the same inputs);
- one step: each rank's blocks against the one-card step's, relative L2
  within 1e-5, the metrics within 1e-6 relative; the exchange on one set
  of inputs, float32 and bfloat16: bit for bit;
- the checkpoint: the mesh's files equal, array for array and the meta's
  bytes, the one-card checkpoint of the gathered state; the reference's
  ``repro.checkpointing.restore`` reads them; each rank restores its
  blocks bit for bit;
- the serve: prefill and every decode step's logits within 2e-5 x
  max(1, max|logits|) of the one-card serve (``test_torch_serve_mesh.py``'s
  bound), the cache's blocks gathered within the same bound, positions
  equal.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch
from _torch_layout import trace_layout
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro_torch import pytree
from repro_torch.configs.base import CommConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import procs, sharding, steps
from repro_torch.models import model, moe, moe_ep
from repro_torch.models.layers import gated_mlp_apply
from repro_torch.models.shard_hints import activation_sharding

import test_torch_intrapod as intra

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 300
GRAD_TOL = 2e-5
STEP_TOL = 1e-5
LOSS_TOL = 1e-6
MLA = ("deepseek-v2-lite-16b", "deepseek-v2-236b", "minicpm3-4b")
LITE = "deepseek-v2-lite-16b"
#: (mesh, arch) of (i): every MLA arch on (1, 2, 2), deepseek-lite also
#: with the experts and heads over four model ranks
GRAD_CASES = [((1, 2, 2), a) for a in MLA] + [((1, 1, 4), LITE)]
ROUTES = moe.ROUTES
#: (i)'s batch: 2 sequences of 24 tokens (T splits over a model axis of
#: 4 and B over a data axis of 2: the EP route runs)
GRAD_B, GRAD_T = 2, 24
#: (ii)'s tokens (B, T) and their push towards experts 0 and 1
LAYER_B, LAYER_T, PUSH = 2, 64, 3.0
LAYER_MESHES = ((1, 1, 4), (1, 2, 2))
AUX_WEIGHT = 100.0
STEP_MESHES = intra.FOUR
#: (iv): the archs whose KV heads a model axis of 4 shares, and their
#: sequence length (starcoder2 past its reduced window of 64)
KV_MESH = (1, 1, 4)
KV_ARCHS = {"starcoder2-3b": 96, "qwen3-0.6b@kv2": 24}
SERVE_B, SERVE_T, DECODE, CACHE = 8, 16, 12, 8
#: the two cache placements: (batch_sharded, baseline_decode)
PLACEMENTS = ((True, False), (True, True))


def _id(x):
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], bool):
        return f"bs{int(x[0])}-base{int(x[1])}"
    if isinstance(x, tuple):
        return "x".join(map(str, x))
    return str(x)


def _with_kv2(cfg):
    """A config with 2 KV heads (the reduced qwen3-0.6b's 4 over 2)."""
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, n_kv_heads=2))


def _cfg(arch, get=get_config):
    """The reduced config of ``arch``, float32; ``name@kv2``: with 2 KV
    heads.  ``get`` is the registry's ``get_config`` (the port's, or the
    reference's)."""
    name, _, variant = arch.partition("@")
    cfg = get(name).reduced()
    return _with_kv2(cfg) if variant == "kv2" else cfg


def _labelled(vocab, B, T, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, T)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, T)).astype(np.int32)
    labels[rng.random((B, T)) < 1 / 6] = -1
    return {"tokens": toks, "labels": labels}


def _layer_inputs():
    """(ii)'s MoE params (seed 3), tokens pushed along the router's columns
    0 and 1, and the loss's weights on y."""
    cfg = _cfg(LITE)
    d = cfg.d_model
    p = moe.init_moe(torch.Generator().manual_seed(3), cfg.moe, d,
                     torch.float32, "cpu")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (LAYER_B, LAYER_T, d)).astype(np.float32))
    w = p["router"]["w"]
    x = x + PUSH * (w[:, 0] / w[:, 0].square().sum()
                    + w[:, 1] / w[:, 1].square().sum())
    wy = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (LAYER_B, LAYER_T, d)).astype(np.float32))
    return p, x, wy


def _layer_loss(y, aux, wy):
    return (y * wy).sum() + AUX_WEIGHT * aux


def _tokens(vocab):
    rng = np.random.default_rng(21)
    return (torch.from_numpy(rng.integers(0, vocab, (SERVE_B, SERVE_T))),
            torch.from_numpy(rng.integers(0, vocab, (SERVE_B, DECODE))))


def _step_batch(toks, t):
    return {"token": toks[:, t],
            "t": torch.full((SERVE_B,), t, dtype=torch.int32)}


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _gathered_grads(cfg, mesh, params, nb, route, remat=True):
    """The pod's loss and its gathered gradient leaves by ``mesh``'s ranks
    (the train step's ``pod_grads`` on one pod, ``route``'s MoE)."""
    comm = CommConfig(strategy="bsp")
    state = steps.make_train_state(params, comm, 1, mesh=mesh)
    step = steps.make_train_step(cfg, comm, mesh=mesh, moe_route=route,
                                 remat=remat)
    batch = {k: torch.from_numpy(v).long()[None] for k, v in nb.items()}
    specs_ = sharding.batch_shardings(batch, mesh, pod_stacked=True)
    mine = {k: sharding.local_block(v, specs_[k], mesh)
            for k, v in batch.items()}
    losses, grads = step.pod_grads(state["params"], mine)
    specs = pytree.leaves_like(sharding.train_state_shardings(
        steps.train_state_shape(cfg, comm, 1), mesh)["params"],
        state["params"])
    return float(losses[0]), [sharding.gather_leaf(g, s, mesh)[0]
                              for g, s in zip(grads, specs)]


def _layer_grads(mesh, route):
    """(ii) on this rank: the MoE layer's y (the rank's rows) and the
    gradients of the pod's loss, gathered whole: x's and each leaf's."""
    cfg = _cfg(LITE)
    p, x, wy = _layer_inputs()
    local = pytree.tree_map(lambda t: t.detach().requires_grad_(),
                            sharding.local_params({"ffn": p}, mesh)["ffn"])
    rows = sharding.local_block(x, ("data", None, None), mesh).clone()
    rows.requires_grad_()
    wy_rows = sharding.local_block(wy, ("data", None, None), mesh)
    with activation_sharding(mesh):
        y, aux = moe.moe_apply(local, cfg.moe, rows, route)
    leaves = pytree.leaves(local)
    grads = torch.autograd.grad(_layer_loss(y, aux, wy_rows),
                                [rows] + leaves)
    specs = sharding.leaf_specs({"ffn": p}, mesh)
    whole = [mesh.all_gather_dim(grads[0], 0, "data")]
    whole += [sharding.gather_leaf(g, s, mesh)
              for g, s in zip(grads[1:], specs)]
    return y.detach(), float(aux.detach()), whole


def _serve(cfg, mesh, params, placement):
    """(iv)'s serve on this rank: the prefill's and every decode step's
    logits (the rank's rows, whole vocabulary), and the cache gathered
    whole."""
    bs, base = placement
    prompt, dec = _tokens(cfg.vocab)
    with torch.inference_mode():
        pre = steps.make_prefill_step(cfg, mesh=mesh)(params,
                                                      {"tokens": prompt})
        cache = model.init_cache(cfg, SERVE_B, CACHE, device="cpu",
                                 mesh=mesh, batch_sharded=bs,
                                 baseline_decode=base)
        step = steps.make_serve_step(cfg, mesh=mesh, batch_sharded=bs,
                                     baseline_decode=base)
        logits = []
        for t in range(DECODE):
            lg, cache = step.logits(params, cache, _step_batch(dec, t))
            logits.append(lg)
    whole = model.init_cache(cfg, SERVE_B, CACHE, device="meta")
    specs = pytree.leaves_like(sharding.cache_shardings(
        whole, mesh, batch_sharded=bs, baseline_decode=base), whole)
    return pre, torch.stack(logits), [
        sharding.gather_leaf(t, s, mesh)
        for t, s in zip(pytree.leaves(cache), specs)]


def _step_checks(mesh, out_dir):
    """(iii) one step and the exchange of each strategy on ``mesh`` for
    the reduced deepseek-lite, each against the one-card route this rank
    runs itself; a checkpoint of the gaia state."""
    cfg = _cfg(LITE)
    p = model.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    specs = sharding.leaf_specs(p, mesh)
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    like16 = pytree.leaves(model.init_model(torch.Generator().manual_seed(0),
                                            cfg16, "cpu"))
    res = {"exchange": {}, "step": {}}
    for strategy in intra.STRATEGIES:
        comm = intra._comm(strategy)
        for c, like in ((cfg, pytree.leaves(p)), (cfg16, like16)):
            full = intra._exchange_inputs(strategy, c, seed=7)
            want = steps.make_exchange(comm, lr=intra.LR)(
                full, step_idx=1, **intra._mix(comm))
            got = steps.make_exchange(comm, mesh=mesh, lr=intra.LR,
                                      specs=specs)(
                intra._blocks(full, specs, mesh, like), step_idx=1,
                **intra._mix(comm, mesh))
            res["exchange"][strategy, c.dtype] = intra._compare(
                pytree.leaves(got),
                pytree.leaves(intra._blocks(want, specs, mesh, like)))[0]
        batch = intra._batch(cfg.vocab)
        one, m_one = steps.make_train_step(cfg, comm, lr=intra.LR)(
            steps.make_train_state(p, comm, intra.N_PODS), batch, 1,
            **intra._mix(comm))
        state = steps.make_train_state(p, comm, intra.N_PODS, mesh=mesh)
        mine, m_mine = steps.make_train_step(cfg, comm, mesh=mesh,
                                             lr=intra.LR)(
            state, batch, 1, **intra._mix(comm, mesh))
        _, l2 = intra._compare(pytree.leaves(mine), pytree.leaves(
            intra._blocks(one, specs, mesh, pytree.leaves(p))))
        err = max(abs(float(m_mine[k]) - float(m_one[k])) /
                  max(abs(float(m_one[k])), 1e-30) for k in m_one)
        res["step"][strategy] = (l2, err, sorted(m_one) == sorted(m_mine))
        if strategy == intra.CKPT_STRATEGY:
            res["ckpt"] = intra._checkpoint(cfg, comm, mesh, mine, out_dir)
    return res


def _four_ranks(rank, dev, trees, out_dir):
    torch.set_num_threads(1)
    res = {"grads": {}, "remat": {}, "layer": {}, "kv": {}, "serve": {},
           "steps": {}}
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = mesh_lib.make_mesh(shape, device=dev)
        return meshes[shape]
    # (i) the pod's loss and gradient, both routes; remat off once
    for shape, arch in GRAD_CASES:
        cfg, mesh = _cfg(arch), mesh_of(shape)
        params = model.lm_params_from_jax(trees[arch][0], "cpu")
        for route in ROUTES:
            loss, whole = _gathered_grads(cfg, mesh, params, trees[arch][1],
                                          route)
            res["grads"][shape, arch, route] = (loss, whole if rank == 0
                                                else None)
            if shape == (1, 2, 2) and arch == LITE:
                again = _gathered_grads(cfg, mesh, params, trees[arch][1],
                                        route, remat=False)
                res["remat"][route] = loss == again[0] and all(
                    torch.equal(a, b) for a, b in zip(whole, again[1]))
    # (ii) one MoE layer, both routes
    for shape in LAYER_MESHES:
        for route in ROUTES:
            y, aux, whole = _layer_grads(mesh_of(shape), route)
            res["layer"][shape, route] = (y, aux, whole if rank == 0
                                          else None)
    # (iv) the KV heads shared by two model ranks
    mesh = mesh_of(KV_MESH)
    for arch in KV_ARCHS:
        cfg = _cfg(arch)
        params = model.lm_params_from_jax(trees[arch][0], "cpu")
        loss, whole = _gathered_grads(cfg, mesh, params, trees[arch][1],
                                      "dense")
        res["kv"][arch] = (loss, whole if rank == 0 else None)
        local = sharding.local_params(params, mesh)
        for pl in PLACEMENTS:
            pre, logits, cache = _serve(cfg, mesh, local, pl)
            res["serve"][arch, pl] = (pre, logits,
                                      cache if rank == 0 else None)
    # (iii) steps, exchanges and checkpoints
    for shape in STEP_MESHES:
        res["steps"][shape] = _step_checks(mesh_of(shape), out_dir)
    res["coords"] = {s: m.coords for s, m in meshes.items()}
    return res


# ---------------------------------------------------------------------------
# Fixtures: the reference, the parent's values, the spawn
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    """The JAX reference, imported here only."""
    import jax
    import jax.numpy as jnp
    from repro import checkpointing as jax_ckpt
    from repro.configs.registry import get_config as jax_get_config
    from repro.models import model as jax_model
    return types.SimpleNamespace(jax=jax, jnp=jnp, ckpt=jax_ckpt,
                                 get_config=jax_get_config, model=jax_model)


@pytest.fixture(scope="module")
def trees(ref):
    """For each arch of (i) and (iv): the reference's reduced weights
    (``init_model`` at key 0, as NumPy) and a batch with labels, a sixth
    of them -1."""
    out = {}
    archs = {a: GRAD_T for a in MLA}
    archs.update(KV_ARCHS)
    for arch, T in archs.items():
        jcfg = _cfg(arch, ref.get_config)
        jp = ref.model.init_model(ref.jax.random.PRNGKey(0), jcfg)
        out[arch] = (ref.jax.tree_util.tree_map(np.asarray, jp),
                     _labelled(512, GRAD_B, T, 13))
    return out


@pytest.fixture(scope="module")
def ranks(trees, tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("intrapod_moe"))
    return out_dir, procs.spawn(_four_ranks, 4, backend="gloo",
                                device="cpu", timeout=SPAWN_TIMEOUT,
                                args=(trees, out_dir))


def _one_device_grads(cfg, tree, nb, ep_mesh=None, monkeypatch=None):
    """The one-device port's loss and gradient leaves; with ``ep_mesh``
    (data, model), its MoE layers run ``moe_apply_ep_ref`` over that
    mesh's shards plus the shared experts."""
    if ep_mesh is not None:
        D, M = ep_mesh

        def ep_ref(p_, m_, x, route="dense"):
            y, aux = moe_ep.moe_apply_ep_ref(p_, m_, x, D, M)
            if "shared" in p_:
                y = y + gated_mlp_apply(p_["shared"], x)
            return y, aux
        monkeypatch.setattr(moe, "moe_apply", ep_ref)
    p = pytree.tree_map(lambda t: t.requires_grad_(),
                        model.lm_params_from_jax(tree, "cpu"))
    loss, _ = model.loss_fn(p, cfg, {k: torch.from_numpy(v).long()
                                     for k, v in nb.items()})
    grads = torch.autograd.grad(loss, pytree.leaves(p))
    return float(loss.detach()), [g.numpy() for g in grads]


def _reference_grads(ref, arch, tree, nb):
    jloss, jgrads = ref.jax.value_and_grad(
        lambda p_, b_: ref.model.loss_fn(p_, _cfg(arch, ref.get_config),
                                         b_)[0])(
        ref.jax.tree_util.tree_map(ref.jnp.asarray, tree),
        {k: ref.jnp.asarray(v) for k, v in nb.items()})
    return float(jloss), [np.asarray(g) for g in
                          ref.jax.tree_util.tree_leaves(jgrads)]


def _named(arch):
    """The leaf paths of ``arch``'s params, in ``pytree.leaves``' order."""
    return [path for path, _ in pytree.leaves_with_paths(
        model.init_model(None, _cfg(arch), "meta"))]


def _leaf_close(got, want, tol, what, names):
    assert len(got) == len(want), (what, len(got), len(want))
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        bound = tol * max(1.0, float(np.abs(w).max(initial=0.0)))
        err = float(np.abs(g - w).max(initial=0.0))
        assert err <= bound, (what, name, err, bound)


# ---------------------------------------------------------------------------
# (i) the pod's loss and gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,arch", GRAD_CASES, ids=_id)
def test_dense_route_grads_match_one_device_and_reference(ref, trees, ranks,
                                                          shape, arch):
    """The dense route (the reference's default): the pod's loss on every
    rank and each gathered gradient leaf (``kv_norm``, ``q_norm`` and
    ``router/w`` among them, named in the message) against the
    one-device port and ``jax.value_and_grad`` of the reference's
    ``loss_fn``."""
    tree, nb = trees[arch]
    cfg = _cfg(arch)
    _, results = ranks
    losses = [r["grads"][shape, arch, "dense"][0] for r in results]
    whole = [g.numpy() for g in results[0]["grads"][shape, arch, "dense"][1]]
    assert len(set(losses)) == 1, losses
    names = _named(arch)
    assert any(n.endswith("kv_norm/scale") for n in names)
    assert any(n.endswith("router/w") for n in names) == bool(
        cfg.moe.n_experts)
    loss, grads = _one_device_grads(cfg, tree, nb)
    jloss, jgrads = _reference_grads(ref, arch, tree, nb)
    np.testing.assert_allclose(losses[0], loss, rtol=0, atol=GRAD_TOL)
    np.testing.assert_allclose(losses[0], jloss, rtol=0, atol=GRAD_TOL)
    _leaf_close(whole, grads, GRAD_TOL, f"{arch} against the port", names)
    _leaf_close(whole, jgrads, GRAD_TOL, f"{arch} against the reference",
                names)


@pytest.mark.parametrize("shape,arch", GRAD_CASES, ids=_id)
def test_ep_route_grads_match_the_plain_ep_route(trees, ranks, monkeypatch,
                                                 shape, arch):
    """``moe_route="ep"``: the pod's loss and gradient against the
    one-device ``loss_fn`` whose MoE layers run ``moe_apply_ep_ref`` over
    the mesh's D x M shards (plus the shared experts); an arch without
    experts runs its dense layers alike."""
    tree, nb = trees[arch]
    cfg = _cfg(arch)
    _, results = ranks
    losses = [r["grads"][shape, arch, "ep"][0] for r in results]
    whole = [g.numpy() for g in results[0]["grads"][shape, arch, "ep"][1]]
    assert len(set(losses)) == 1, losses
    loss, grads = _one_device_grads(cfg, tree, nb, shape[1:], monkeypatch)
    np.testing.assert_allclose(losses[0], loss, rtol=0, atol=GRAD_TOL)
    _leaf_close(whole, grads, GRAD_TOL, f"{arch} EP route", _named(arch))


@pytest.mark.parametrize("route", ROUTES)
def test_remat_recompute_routes_as_the_forward(ranks, route):
    """deepseek-lite on (1, 2, 2): each checkpointed cycle, recomputed in
    the backward, runs the same collectives and routes every pair to the
    same expert as the forward did: the gradient equals remat off's, bit
    for bit."""
    _, results = ranks
    assert all(r["remat"][route] for r in results)


# ---------------------------------------------------------------------------
# (ii) one MoE layer
# ---------------------------------------------------------------------------

def _layer_want(route, D, M):
    """The one-process layer: y, aux and the gradients of x and of every
    leaf, by ``route`` (EP: ``moe_apply_ep_ref`` over D x M shards)."""
    cfg = _cfg(LITE)
    p, x, wy = _layer_inputs()
    p = pytree.tree_map(lambda t: t.requires_grad_(), p)
    x = x.requires_grad_()
    if route == "ep":
        y, aux = moe_ep.moe_apply_ep_ref(p, cfg.moe, x, D, M)
        y = y + gated_mlp_apply(p["shared"], x)
    else:
        y, aux = moe.moe_apply(p, cfg.moe, x)
    grads = torch.autograd.grad(_layer_loss(y, aux, wy),
                                [x] + pytree.leaves(p))
    return y.detach(), float(aux.detach()), [g.numpy() for g in grads]


def _layer_names():
    cfg = _cfg(LITE)
    p = moe.init_moe(None, cfg.moe, cfg.d_model, torch.float32, "meta")
    return ["x"] + [path for path, _ in pytree.leaves_with_paths(p)]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("shape", LAYER_MESHES, ids=_id)
def test_moe_layer_grads_match_one_process(ranks, shape, route):
    """The MoE layer on the ranks (the rank's rows and experts) against the
    one-process function of its route: y, aux and the gradients of x, the
    router, the experts and the shared experts.  The aux's gradient
    reaches the router once (a weight of 100 on it makes an M-fold count
    show)."""
    D, M = shape[1:]
    _, results = ranks
    y_want, aux_want, want = _layer_want(route, D, M)
    rows = torch.cat([results[r * M]["layer"][shape, route][0]
                      for r in range(D)])
    bound = GRAD_TOL * max(1.0, float(y_want.abs().max()))
    assert float((rows - y_want).abs().max()) <= bound
    for r in results:
        assert abs(r["layer"][shape, route][1] - aux_want) <= GRAD_TOL
    got = [g.numpy() for g in results[0]["layer"][shape, route][2]]
    _leaf_close(got, want, GRAD_TOL, f"{route} layer on {shape}",
                _layer_names())


def test_pairs_drop_and_the_routes_differ(ranks):
    """Where the EP route's per-shard capacity drops pairs (counted here),
    its y, aux and gradients are another function than the dense
    route's (ROADMAP C11)."""
    cfg = _cfg(LITE)
    p, x, _ = _layer_inputs()
    for D, M in (s[1:] for s in LAYER_MESHES):
        b, span = LAYER_B // D, LAYER_T // M
        c_send, _ = moe_ep.ep_capacities(cfg.moe, b * span, M)
        dropped = sum(int((~moe_ep._dispatch(
            cfg.moe, x[r * b:(r + 1) * b, i * span:(i + 1) * span]
            .reshape(-1, cfg.d_model), p["router"]["w"], M,
            c_send)[2][1]).sum()) for r in range(D) for i in range(M))
        assert dropped > 0, (D, M)
        y_ep, aux_ep, g_ep = _layer_want("ep", D, M)
        y_d, aux_d, g_d = _layer_want("dense", D, M)
        assert float((y_ep - y_d).abs().max()) > 1e-3
        assert abs(aux_ep - aux_d) > 1e-7
        assert float(np.abs(g_ep[1] - g_d[1]).max()) > 1e-3   # router


_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, {src!r})
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config
    from repro.models import moe_ep
    z = np.load({inp!r})
    m = get_config({arch!r}).reduced().moe
    names = ("x", "router", "w_gate", "w_up", "w_down")
    out = {{}}
    for D, M in {meshes!r}:
        mesh = jax.make_mesh((D, M), ("data", "model"))

        def loss(x, r, g, u, dn):
            p = {{"router": {{"w": r}}, "w_gate": g, "w_up": u,
                 "w_down": dn}}
            y, aux = moe_ep.moe_apply_ep(p, m, x, mesh)
            return (y * z["wy"]).sum() + {aux_w!r} * aux
        with mesh:
            grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
                *(jnp.asarray(z[k]) for k in names))
        for k, g in zip(names, grads):
            out[f"{{k}}_{{D}}x{{M}}"] = np.asarray(g)
    np.savez({out!r}, **out)
    print("REF_EP_GRAD_OK")
""")


@pytest.fixture(scope="module")
def reference_ep_grads(tmp_path_factory):
    """``jax.grad`` through the reference's ``moe_apply_ep`` (routed
    experts) on (ii)'s tokens and params, on each (D, M) of
    ``LAYER_MESHES``, from a subprocess with four host devices."""
    tmp = tmp_path_factory.mktemp("moe_ep_grad")
    p, x, wy = _layer_inputs()
    inp, out = str(tmp / "in.npz"), str(tmp / "out.npz")
    np.savez(inp, x=x.numpy(), router=p["router"]["w"].numpy(),
             w_gate=p["w_gate"].numpy(), w_up=p["w_up"].numpy(),
             w_down=p["w_down"].numpy(), wy=wy.numpy())
    script = tmp / "ref_ep_grad.py"
    script.write_text(_SCRIPT.format(
        src=os.path.join(ROOT, "src"), inp=inp, out=out, arch=LITE,
        meshes=[s[1:] for s in LAYER_MESHES], aux_w=AUX_WEIGHT))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0 and "REF_EP_GRAD_OK" in r.stdout, \
        r.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("shape", LAYER_MESHES, ids=_id)
def test_ep_ref_grads_match_reference_moe_apply_ep(reference_ep_grads,
                                                   shape):
    """The plain EP route's autograd (routed experts only) against
    ``jax.grad`` through the reference's ``shard_map`` route."""
    D, M = shape[1:]
    cfg = _cfg(LITE)
    p, x, wy = _layer_inputs()
    routed = {k: p[k] for k in ("router", "w_gate", "w_up", "w_down")}
    routed = pytree.tree_map(lambda t: t.requires_grad_(), routed)
    x = x.requires_grad_()
    y, aux = moe_ep.moe_apply_ep_ref(routed, cfg.moe, x, D, M)
    names = ("x", "router", "w_gate", "w_up", "w_down")
    grads = torch.autograd.grad(
        _layer_loss(y, aux, wy),
        [x, routed["router"]["w"]] + [routed[k] for k in names[2:]])
    _leaf_close([g.numpy() for g in grads],
                [reference_ep_grads[f"{k}_{D}x{M}"] for k in names],
                GRAD_TOL, f"EP against the reference on {shape}", names)


# ---------------------------------------------------------------------------
# (iii) steps, exchanges, checkpoints on (2, 2, 1) and (2, 1, 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strategy", intra.STRATEGIES)
@pytest.mark.parametrize("shape", STEP_MESHES, ids=_id)
def test_moe_exchange_on_blocks_matches_one_card_bit_for_bit(ranks, shape,
                                                             strategy,
                                                             dtype):
    """The stacked expert leaves placed (pod, model, data, None) and the
    others: each rank's blocks of the exchange equal the one-card
    exchange's (DGC's global norm and threshold over leaves split over
    both axes)."""
    _, results = ranks
    assert all(r["steps"][shape]["exchange"][strategy, dtype]
               for r in results)


@pytest.mark.parametrize("strategy", intra.STRATEGIES)
@pytest.mark.parametrize("shape", STEP_MESHES, ids=_id)
def test_moe_train_step_on_blocks_matches_one_card(ranks, shape, strategy):
    _, results = ranks
    for i, r in enumerate(results):
        l2, err, same_keys = r["steps"][shape]["step"][strategy]
        assert same_keys and l2 <= STEP_TOL and err <= LOSS_TOL, (i, l2, err)


@pytest.mark.parametrize("shape", STEP_MESHES, ids=_id)
def test_moe_checkpoint_on_the_mesh_is_the_one_card_checkpoint(ref, ranks,
                                                               shape):
    """The gaia state of the MoE model (experts over ``model`` or over
    ``data``) saved on the mesh: the one-card checkpoint of the state
    gathered whole, array for array and the meta's bytes; the reference's
    ``restore`` reads it; each rank restores its own blocks."""
    out_dir, results = ranks
    path = os.path.join(out_dir, intra._id(shape))
    a = os.path.join(path, "mesh", "ckpt_1")
    b = os.path.join(path, "one_card", "ckpt_1")
    with np.load(os.path.join(a, "payload.npz")) as za, \
            np.load(os.path.join(b, "payload.npz")) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for f in za.files:
            np.testing.assert_array_equal(za[f], zb[f], err_msg=f)
    with open(os.path.join(a, "meta.msgpack"), "rb") as fa, \
            open(os.path.join(b, "meta.msgpack"), "rb") as fb:
        assert fa.read() == fb.read()
    state = steps.train_state_shape(_cfg(LITE),
                                    intra._comm(intra.CKPT_STRATEGY),
                                    intra.N_PODS)
    like = {k: pytree.tree_map(lambda t: np.zeros(t.shape, np.float32),
                               state[k]) for k in ("params", "vel", "acc")}
    back = ref.ckpt.restore(os.path.join(path, "mesh"), like, step=1)
    with np.load(os.path.join(b, "payload.npz")) as zb:
        for i, leaf in enumerate(ref.jax.tree_util.tree_leaves(back)):
            np.testing.assert_array_equal(np.asarray(leaf), zb[f"leaf_{i}"])
    assert all(r["steps"][shape]["ckpt"] for r in results)


# ---------------------------------------------------------------------------
# (iv) a model axis wider than n_kv_heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(KV_ARCHS))
def test_kv_heads_shared_by_ranks_grads_match(ref, trees, ranks, arch):
    """Each KV head serves two of the four model ranks: every rank gathers
    k and v whole and keeps its query heads' KV head; the loss and every
    gathered gradient leaf (``wk``, ``wv``, ``k_norm``) against the
    one-device port and the reference."""
    tree, nb = trees[arch]
    cfg = _cfg(arch)
    assert KV_MESH[2] > cfg.attention.n_kv_heads    # KV heads shared
    _, results = ranks
    losses = [r["kv"][arch][0] for r in results]
    whole = [g.numpy() for g in results[0]["kv"][arch][1]]
    assert len(set(losses)) == 1, losses
    loss, grads = _one_device_grads(cfg, tree, nb)
    jloss, jgrads = _reference_grads(ref, arch, tree, nb)
    np.testing.assert_allclose(losses[0], loss, rtol=0, atol=GRAD_TOL)
    np.testing.assert_allclose(losses[0], jloss, rtol=0, atol=GRAD_TOL)
    names = _named(arch)
    _leaf_close(whole, grads, GRAD_TOL, f"{arch} against the port", names)
    _leaf_close(whole, jgrads, GRAD_TOL, f"{arch} against the reference",
                names)


@pytest.fixture(scope="module")
def one_card_serve(trees):
    """Per KV arch: the one-card prefill and decode logits and the cache
    after the loop."""
    out = {}
    for arch in KV_ARCHS:
        cfg = _cfg(arch)
        p = model.lm_params_from_jax(trees[arch][0], "cpu")
        prompt, dec = _tokens(cfg.vocab)
        with torch.inference_mode():
            pre = steps.make_prefill_step(cfg)(p, {"tokens": prompt})
            cache = model.init_cache(cfg, SERVE_B, CACHE, device="cpu")
            step = steps.make_serve_step(cfg)
            logits = []
            for t in range(DECODE):
                lg, cache = step.logits(p, cache, _step_batch(dec, t))
                logits.append(lg)
        out[arch] = (pre, torch.stack(logits), pytree.leaves(cache))
    return out


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = GRAD_TOL * max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= bound, (what, err, bound)


@pytest.mark.parametrize("placement", PLACEMENTS, ids=_id)
@pytest.mark.parametrize("arch", list(KV_ARCHS))
def test_kv_heads_shared_by_ranks_serve_matches_one_card(ranks,
                                                         one_card_serve,
                                                         arch, placement):
    """Prefill and decode on (1, 1, 4) under the flash-decode placement
    (every KV head on the rank's slots) and the heads placement (every KV
    head on every rank: the clamp keeps them whole, each rank reads its
    own): the logits of every rank and the cache gathered whole against
    the one-card serve."""
    pre, logits, cache = one_card_serve[arch]
    _, results = ranks
    for r in results:
        got_pre, got_logits, _ = r["serve"][arch, placement]
        _close(got_pre, pre, f"{arch} prefill")
        _close(got_logits, logits, f"{arch} decode")
    got = results[0]["serve"][arch, placement][2]
    assert len(got) == len(cache)
    for i, (g, w) in enumerate(zip(got, cache)):
        if w.dtype == torch.int32:
            assert torch.equal(g, w), (arch, i)
        else:
            _close(g, w, f"{arch} cache leaf {i}")


def test_ranks_hold_their_coordinates(ranks):
    _, results = ranks
    for shape in (KV_MESH,) + STEP_MESHES:
        want = [dict(zip(mesh_lib.AXES, map(int, np.unravel_index(i, shape))))
                for i in range(4)]
        assert [r["coords"][shape] for r in results] == want


# ---------------------------------------------------------------------------
# What the layout takes and refuses (mesh descriptions, no process group)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [
    ("deepseek-v2-lite-16b", (2, 16, 16)), ("deepseek-v2-lite-16b", (1, 1, 4)),
    ("deepseek-v2-236b", (2, 16, 16)), ("minicpm3-4b", (1, 2, 2)),
    ("minicpm3-4b", (2, 8, 8)), ("qwen3-0.6b", (2, 16, 16)),
    ("starcoder2-3b", (1, 1, 4)), ("gemma2-9b", (2, 16, 16))], ids=_id)
@pytest.mark.parametrize("mode", ["train", "serve"])
def test_check_layout_takes_the_full_widths(arch, shape, mode):
    """The step of ``mode`` traced on the mesh's last rank
    (``_torch_layout``)."""
    trace_layout(get_config(arch), shape, mode)


@pytest.mark.parametrize("arch,shape,what", [
    ("minicpm3-4b", (1, 1, 3), "d_ff"),
    ("starcoder2-3b", (1, 1, 3), "n_kv_heads"),
    ("starcoder2-3b", (1, 1, 5), "n_kv_heads"),
    ("deepseek-v2-lite-16b", (1, 1, 128), "n_experts")], ids=_id)
def test_check_layout_refuses_what_the_axes_cannot_take(arch, shape, what):
    """minicpm3's d_ff of 6,400 on 3 ranks; starcoder2's 2 KV heads (their
    256 columns of wk and wv) on 3 and on 5; deepseek-lite's 64 experts on
    128: taken (they were refused until ROADMAP A11e closed; the train
    step traced on the mesh's last rank), the dimension whole on every
    ``model`` rank in ``leaf_specs``
    (``tests/test_torch_clamp.py`` runs such leaves; chip_smoke.py phase
    18 these archs at full width)."""
    cfg = get_config(arch)
    mesh = mesh_lib.Mesh(shape, mesh_lib.AXES)
    trace_layout(cfg, shape, "train")
    leaf, dim = {"d_ff": ("ffn/gate/w", -1), "n_kv_heads": ("mixer/wk/w", -1),
                 "n_experts": ("ffn/w_gate", -3)}[what]
    shapes = steps.param_shape(cfg)
    got = [s_ for (p_, _), s_ in zip(pytree.leaves_with_paths(shapes),
                                     sharding.leaf_specs(shapes, mesh))
           if p_.endswith(leaf)]
    assert got and all(s_[dim] is None for s_ in got), (what, got)


def test_train_step_refuses_an_unknown_moe_route():
    with pytest.raises(ValueError, match="moe_route"):
        steps.make_train_step(_cfg(LITE), CommConfig(strategy="bsp"),
                              moe_route="sparse")


def test_ep_route_makes_no_range_checked_one_hot(monkeypatch):
    """The EP route's one-hots are comparisons: ``F.one_hot`` checks its
    indices' range by reading them back to the host, a host sync on the
    card in every training step."""
    def refuse(*args, **kwargs):
        raise AssertionError("F.one_hot called")
    monkeypatch.setattr(torch.nn.functional, "one_hot", refuse)
    cfg = _cfg(LITE)
    p, x, _ = _layer_inputs()
    y, aux = moe_ep.moe_apply_ep_ref(p, cfg.moe, x, 2, 2)
    assert torch.isfinite(y).all() and torch.isfinite(aux)
