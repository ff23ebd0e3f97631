"""Training and serving the SSM, RG-LRU hybrid, enc-dec and VLM families
inside a pod, on the CPU: gloo ranks started by
``repro_torch.launch.procs.spawn`` split a pod over a ``data`` x
``model`` grid (FSDP over ``data``, tensor parallelism over ``model``,
with the reference's parameter and cache placements), against the
one-device port and the JAX reference (imported by the fixtures only: the
ranks import this file and need no JAX).

One spawn of four ranks, each on one thread, with a deadline
(``SPAWN_TIMEOUT``), runs every rank-side case once (a module-scoped
fixture); the parametrized tests read its results.  The reduced
mamba2-780m, recurrentgemma-2b, seamless-m4t-large-v2 (with frames) and
phi-3-vision-4.2b (with patches) run on (1, 2, 2), the SSM and the RG-LRU
hybrid on (1, 1, 4) as well:
(i) the pod's loss and each gathered gradient leaf (the train step's
    ``pod_grads``), remat on and off; and once, on the SSM over (1, 2, 2),
    with the gated norm's sum of squares summed over ``model`` by
    ``reduce_from_model`` (no sum in the backward), which must miss;
(ii) one step and the exchange of each of the six strategies on
    (2, 1, 2) for the reduced mamba2;
(iii) a checkpoint of the gaia state on that mesh;
(iv) the serve: the prefill, every decode step's logits and greedy
    tokens, and the cache gathered whole, under each placement of the
    cache the family takes (on (1, 1, 4) also the requests whole, where the
    RG-LRU's state lies split by channel);
(v) the tied unembedding (the table's block gathered over ``data``) at
    a decode step's few rows and at many, forward and backward.

Tolerances, float32:
- the pod's loss and each gathered gradient leaf against the one-device
  port's ``loss_fn`` and against ``jax.value_and_grad`` of the
  reference's: within 2e-5 x max(1, max|leaf|) (the North star's float32
  bound);
- one step: each rank's blocks against the one-card step's, relative L2
  within 1e-5, the metrics within 1e-6 relative; the exchange on one set
  of inputs, float32 and bfloat16: bit for bit;
- the checkpoint: the mesh's files equal, array for array and the meta's
  bytes, the one-card checkpoint of the gathered state; the reference's
  ``repro.checkpointing.restore`` reads them; each rank restores its
  blocks bit for bit;
- the serve: the prefill's and every decode step's logits within 2e-5 x
  max(1, max|logits|) of the one-card serve and of the reference's; the
  greedy tokens equal to both where the one-card logits' two largest lie
  ``TIE_GAP`` apart or more; the cache's blocks gathered within the same
  bound of the one-card cache, positions equal.
"""
import dataclasses
import os
import types

import numpy as np
import pytest
import torch
from _torch_layout import trace_layout
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro_torch import pytree
from repro_torch.configs.base import CommConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import collectives as coll
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import procs, sharding, steps
from repro_torch.models import model
from repro_torch.models import ssm as ssm_mod

import test_torch_intrapod as intra

SPAWN_TIMEOUT = 300
GRAD_TOL = 2e-5
STEP_TOL = 1e-5
LOSS_TOL = 1e-6
TIE_GAP = 1e-4
SSM, RGLRU = "mamba2-780m", "recurrentgemma-2b"
ENCDEC, VLM = "seamless-m4t-large-v2", "phi-3-vision-4.2b"
ARCHS = (SSM, RGLRU, ENCDEC, VLM)
#: each arch's training sequence length (recurrentgemma past its reduced
#: window of 64; mamba2's below its chunk of 32)
TRAIN_T = {SSM: 24, RGLRU: 96, ENCDEC: 24, VLM: 24}
GRAD_B = 2
CASES = [((1, 2, 2), a) for a in ARCHS] + [((1, 1, 4), a)
                                           for a in (SSM, RGLRU)]
#: (i)'s case with the norm's backward sum taken out
NO_SUM = ((1, 2, 2), SSM)
STEP_MESH = (2, 1, 2)
SERVE_B, SERVE_T, DECODE, CACHE = 8, 16, 12, 8
#: (batch_sharded, baseline_decode): the flash-decode and the heads
#: placements of the attention caches; on (1, 1, 4) the requests whole
#: too (the RG-LRU's state over ``model`` by channel)
PLACEMENTS = ((True, False), (True, True))
WHOLE = (False, False)
SERVES = [(shape, arch, pl) for shape, arch in CASES for pl in
          (PLACEMENTS[:1] if arch == SSM else PLACEMENTS)
          + ((WHOLE,) if shape == (1, 1, 4) else ())]


def _id(x):
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], bool):
        return f"bs{int(x[0])}-base{int(x[1])}"
    if isinstance(x, tuple):
        return "x".join(map(str, x))
    return str(x)


def _cfg(arch, get=get_config):
    """The reduced config of ``arch`` (float32); ``get`` is the registry's
    ``get_config``, the port's or the reference's."""
    return get(arch).reduced()


def _extras(cfg, B, seed):
    """The batch's frames (enc-dec) or patches (VLM) of ``B`` requests,
    float32 NumPy, or none."""
    rng = np.random.default_rng(seed)
    if cfg.encoder is not None:
        return {"frames": rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.modality.feat_dim)).astype(
            np.float32)}
    if cfg.modality.kind == "vision":
        return {"patches": rng.standard_normal(
            (B, cfg.modality.n_tokens, cfg.modality.feat_dim)).astype(
            np.float32)}
    return {}


def _train_batch(cfg, T):
    """(i)'s batch: tokens, labels (a sixth of them -1) and the arch's
    frames or patches."""
    rng = np.random.default_rng(13)
    toks = rng.integers(0, cfg.vocab, (GRAD_B, T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (GRAD_B, T)).astype(np.int32)
    labels[rng.random((GRAD_B, T)) < 1 / 6] = -1
    return {"tokens": toks, "labels": labels, **_extras(cfg, GRAD_B, 14)}


def _torch_batch(nb):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else
            torch.from_numpy(v) for k, v in nb.items()}


def _serve_inputs(cfg):
    """(the prompt (SERVE_B, SERVE_T), the tokens fed to the decode steps
    (SERVE_B, DECODE), the frames or patches as tensors)."""
    rng = np.random.default_rng(21)
    return (torch.from_numpy(rng.integers(0, cfg.vocab, (SERVE_B, SERVE_T))),
            torch.from_numpy(rng.integers(0, cfg.vocab, (SERVE_B, DECODE))),
            {k: torch.from_numpy(v) for k, v in
             _extras(cfg, SERVE_B, 22).items()})


def _step_batch(toks, t):
    return {"token": toks[:, t],
            "t": torch.full((SERVE_B,), t, dtype=torch.int32)}


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _gathered_grads(cfg, mesh, params, nb, remat=True):
    """The pod's loss and its gathered gradient leaves by ``mesh``'s ranks
    (the train step's ``pod_grads`` on one pod)."""
    comm = CommConfig(strategy="bsp")
    state = steps.make_train_state(params, comm, 1, mesh=mesh)
    step = steps.make_train_step(cfg, comm, mesh=mesh, remat=remat)
    batch = {k: v[None] for k, v in _torch_batch(nb).items()}
    specs_ = sharding.batch_shardings(batch, mesh, pod_stacked=True)
    mine = {k: sharding.local_block(v, specs_[k], mesh)
            for k, v in batch.items()}
    losses, grads = step.pod_grads(state["params"], mine)
    specs = pytree.leaves_like(sharding.train_state_shardings(
        steps.train_state_shape(cfg, comm, 1), mesh)["params"],
        state["params"])
    return float(losses[0]), [sharding.gather_leaf(g, s, mesh)[0]
                              for g, s in zip(grads, specs)]


def _serve(cfg, mesh, params, placement):
    """(iv) on this rank: the prefill's logits (the rank's rows, whole
    vocabulary), each decode step's logits and tokens (the whole batch's),
    and the cache gathered whole."""
    bs, base = placement
    prompt, dec, extra = _serve_inputs(cfg)
    memory = None
    with torch.inference_mode():
        pre = steps.make_prefill_step(cfg, mesh=mesh)(
            params, {"tokens": prompt, **extra})
        if cfg.encoder is not None:
            memory = steps.make_encode_step(cfg, mesh=mesh)(params, extra)
        cache = model.init_cache(cfg, SERVE_B, CACHE, device="cpu",
                                 mesh=mesh, batch_sharded=bs,
                                 baseline_decode=base)
        step = steps.make_serve_step(cfg, memory, mesh=mesh,
                                     batch_sharded=bs, baseline_decode=base)
        logits, toks = [], []
        for t in range(DECODE):
            # the token step on a copy of the cache (a recurrent state
            # advances in place), then the logits step on the cache
            tok, _ = step(params, pytree.tree_map(torch.clone, cache),
                          _step_batch(dec, t))
            lg, cache = step.logits(params, cache, _step_batch(dec, t))
            logits.append(lg)
            toks.append(tok)
    whole = model.init_cache(cfg, SERVE_B, CACHE, device="meta")
    specs = pytree.leaves_like(sharding.cache_shardings(
        whole, mesh, batch_sharded=bs, baseline_decode=base), whole)
    return pre, torch.stack(logits), torch.stack(toks), [
        sharding.gather_leaf(t, s, mesh)
        for t, s in zip(pytree.leaves(cache), specs)]


#: (v) the tied unembedding on (1, 2, 2): a table of 512 x 256 (each
#: rank's block 256 x 128) against 2 x 3 rows (a decode step's few: 3
#: rows a rank) and 2 x 300 (300 rows a rank)
UNEMBED_T = {"few": 3, "many": 300}


def _unembed_grads(mesh, T):
    """(v) on this rank: the logits of its rows (its vocabulary columns,
    gathered whole), the gradients of a seeded loss on them: x's
    (gathered over ``data``) and the table's (gathered whole)."""
    from repro_torch.models.layers import unembed_apply
    from repro_torch.models.shard_hints import activation_sharding
    table, x, w = _unembed_inputs(T)
    spec = ("model", "data")
    block = sharding.local_block(table, spec, mesh).clone().requires_grad_()
    rows = sharding.local_block(x, ("data", None, None), mesh).clone()
    rows.requires_grad_()
    with activation_sharding(mesh):
        logits = unembed_apply({"table": block}, rows)
    wl = sharding.local_block(w, ("data", None, "model"), mesh)
    gx, gt = torch.autograd.grad((logits * wl).sum(), [rows, block])
    return (mesh.all_gather_dim(mesh.all_gather_dim(
        logits.detach().contiguous(), 2, "model"), 0, "data"),
        mesh.all_gather_dim(gx, 0, "data"),
        sharding.gather_leaf(gt, spec, mesh))


def _unembed_inputs(T):
    rng = np.random.default_rng(31)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    return f(512, 256), f(2, T, 256), f(2, T, 512)


def _step_checks(mesh, out_dir):
    """(ii) one step and the exchange of each strategy on ``mesh`` for the
    reduced mamba2, each against the one-card route this rank runs
    itself; (iii) a checkpoint of the gaia state."""
    cfg = _cfg(SSM)
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
    res = {"grads": {}, "serve": {}}
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = mesh_lib.make_mesh(shape, device=dev)
        return meshes[shape]
    for shape, arch in CASES:
        cfg, mesh = _cfg(arch), mesh_of(shape)
        tree, nb = trees[arch]
        params = model.lm_params_from_jax(tree, "cpu")
        # (i) remat on and off
        for remat in (True, False):
            loss, whole = _gathered_grads(cfg, mesh, params, nb, remat)
            res["grads"][shape, arch, remat] = (loss, whole if rank == 0
                                                else None)
        if (shape, arch) == NO_SUM:
            saved = coll.sum_over_model
            ssm_mod.coll.sum_over_model = coll.reduce_from_model
            try:
                loss, whole = _gathered_grads(cfg, mesh, params, nb)
            finally:
                ssm_mod.coll.sum_over_model = saved
            res["no_sum"] = (loss, whole if rank == 0 else None)
        # (iv)
        local = sharding.local_params(params, mesh)
        for s_, a_, pl in SERVES:
            if (s_, a_) == (shape, arch):
                pre, logits, toks, cache = _serve(cfg, mesh, local, pl)
                res["serve"][shape, arch, pl] = (
                    pre, logits, toks, cache if rank == 0 else None)
    # (v)
    res["unembed"] = {rows: _unembed_grads(mesh_of((1, 2, 2)), T)
                      for rows, T in UNEMBED_T.items()}
    # (ii), (iii)
    res["steps"] = _step_checks(mesh_of(STEP_MESH), out_dir)
    res["coords"] = {s: m.coords for s, m in meshes.items()}
    return res


# ---------------------------------------------------------------------------
# Fixtures: the reference, the one-card values, the spawn
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    """The JAX reference, imported here only."""
    import jax
    import jax.numpy as jnp
    from repro import checkpointing as jax_ckpt
    from repro.configs.registry import get_config as jax_get_config
    from repro.launch import steps as jax_steps
    from repro.models import model as jax_model
    return types.SimpleNamespace(jax=jax, jnp=jnp, ckpt=jax_ckpt,
                                 get_config=jax_get_config, steps=jax_steps,
                                 model=jax_model)


@pytest.fixture(scope="module")
def trees(ref):
    """For each arch: the reference's reduced weights (``init_model`` at
    key 0, as NumPy) and (i)'s batch."""
    out = {}
    for arch in ARCHS:
        jp = ref.model.init_model(ref.jax.random.PRNGKey(0),
                                  _cfg(arch, ref.get_config))
        out[arch] = (ref.jax.tree_util.tree_map(np.asarray, jp),
                     _train_batch(_cfg(arch), TRAIN_T[arch]))
    return out


@pytest.fixture(scope="module")
def ranks(trees, tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("intrapod_families"))
    return out_dir, procs.spawn(_four_ranks, 4, backend="gloo",
                                device="cpu", timeout=SPAWN_TIMEOUT,
                                args=(trees, out_dir))


@pytest.fixture(scope="module")
def want_grads(ref, trees):
    """Per arch: the one-device port's and the reference's loss and
    gradient leaves."""
    out = {}
    for arch in ARCHS:
        tree, nb = trees[arch]
        cfg = _cfg(arch)
        p = pytree.tree_map(lambda t: t.requires_grad_(),
                            model.lm_params_from_jax(tree, "cpu"))
        loss, _ = model.loss_fn(p, cfg, _torch_batch(nb))
        grads = [g.numpy() for g in torch.autograd.grad(loss,
                                                         pytree.leaves(p))]
        jloss, jgrads = ref.jax.value_and_grad(
            lambda p_, b_: ref.model.loss_fn(
                p_, _cfg(arch, ref.get_config), b_)[0])(
            ref.jax.tree_util.tree_map(ref.jnp.asarray, tree),
            {k: ref.jnp.asarray(v) for k, v in nb.items()})
        out[arch] = (float(loss.detach()), grads, float(jloss),
                     [np.asarray(g) for g in
                      ref.jax.tree_util.tree_leaves(jgrads)])
    return out


@pytest.fixture(scope="module")
def want_serve(ref, trees):
    """Per arch: the one-card serve's prefill and decode logits, tokens and
    cache, and the reference's prefill and decode logits and serve
    tokens."""
    out = {}
    jnp = ref.jnp
    for arch in ARCHS:
        cfg, jcfg = _cfg(arch), _cfg(arch, ref.get_config)
        p = model.lm_params_from_jax(trees[arch][0], "cpu")
        jp = ref.jax.tree_util.tree_map(jnp.asarray, trees[arch][0])
        prompt, dec, extra = _serve_inputs(cfg)
        jextra = {k: jnp.asarray(v.numpy()) for k, v in extra.items()}
        with torch.inference_mode():
            r = {"prefill": steps.make_prefill_step(cfg)(
                p, {"tokens": prompt, **extra})}
            memory = (steps.make_encode_step(cfg)(p, extra)
                      if cfg.encoder is not None else None)
            cache = model.init_cache(cfg, SERVE_B, CACHE, device="cpu")
            step = steps.make_serve_step(cfg, memory)
            logits = []
            for t in range(DECODE):
                lg, cache = step.logits(p, cache, _step_batch(dec, t))
                logits.append(lg)
        r["jprefill"] = torch.from_numpy(np.asarray(ref.jax.jit(
            ref.steps.make_prefill_step(jcfg))(
            jp, {"tokens": jnp.asarray(prompt.numpy()), **jextra})))
        jcache = ref.model.init_cache(jcfg, SERVE_B, CACHE)
        jscache = ref.model.init_cache(jcfg, SERVE_B, CACHE)
        jdecode = ref.jax.jit(lambda p_, b_, c_: ref.model.decode_step(
            p_, jcfg, b_, c_))
        jserve = ref.jax.jit(ref.steps.make_serve_step(jcfg))
        # the decode steps read no patches; the enc-dec's its frames
        dextra = {k: v for k, v in jextra.items() if k == "frames"}
        jlogits, jtoks = [], []
        for t in range(DECODE):
            jb = {k: jnp.asarray(v.numpy())
                  for k, v in _step_batch(dec, t).items()}
            jb.update(dextra)
            jl, jcache = jdecode(jp, jb, jcache)
            jlogits.append(torch.from_numpy(np.asarray(jl)))
            jt, jscache = jserve(jp, jscache, jb)
            jtoks.append(torch.from_numpy(np.asarray(jt)))
        r.update(logits=torch.stack(logits), jlogits=torch.stack(jlogits),
                 jtoks=torch.stack(jtoks), cache=pytree.leaves(cache))
        out[arch] = r
    return out


def _names(arch):
    """The leaf paths of ``arch``'s params, in ``pytree.leaves``' order."""
    return [path for path, _ in pytree.leaves_with_paths(
        model.init_model(None, _cfg(arch), "meta"))]


def _leaf_errs(got, want, tol, names):
    """Each leaf's largest difference over its bound tol x max(1,
    max|want|), by name."""
    assert len(got) == len(want) == len(names)
    out = {}
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        bound = tol * max(1.0, float(np.abs(w).max(initial=0.0)))
        out[name] = float(np.abs(g - w).max(initial=0.0)) / bound
    return out


def _leaf_close(got, want, tol, what, names):
    errs = _leaf_errs(got, want, tol, names)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1.0, (what, worst, errs[worst])


def _rows(results, shape, key, pick, dim=0):
    """The ranks' rows of ``pick(results[key])`` stacked along ``dim`` in
    data order (model rank 0 of each data rank; its model peers hold the
    same, asserted)."""
    D, M = shape[1], shape[2]
    out = []
    for r in range(D):
        got = [pick(results[r * M + i]["serve"][key]) for i in range(M)]
        for g in got[1:]:
            assert torch.equal(g, got[0]), key
        out.append(got[0])
    return torch.cat(out, dim=dim)


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = GRAD_TOL * max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= bound, (what, err, bound)


# ---------------------------------------------------------------------------
# (i) the pod's loss and gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("shape,arch", CASES, ids=_id)
def test_grads_match_one_device_and_reference(want_grads, ranks, shape, arch,
                                              remat):
    """The pod's loss on every rank and each gathered gradient leaf (the
    SSM's A_log, dt_bias, D, conv_b and gated norm, the RG-LRU's gates,
    lam and conv_b, the encoder's and cross-attention's projections, the
    VLM's projector, by name in the message) against the one-device port
    and ``jax.value_and_grad`` of the reference's ``loss_fn``."""
    loss, grads, jloss, jgrads = want_grads[arch]
    _, results = ranks
    losses = [r["grads"][shape, arch, remat][0] for r in results]
    whole = [g.numpy() for g in results[0]["grads"][shape, arch, remat][1]]
    assert len(set(losses)) == 1, losses
    np.testing.assert_allclose(losses[0], loss, rtol=0, atol=GRAD_TOL)
    np.testing.assert_allclose(losses[0], jloss, rtol=0, atol=GRAD_TOL)
    names = _names(arch)
    _leaf_close(whole, grads, GRAD_TOL, f"{arch} against the port", names)
    _leaf_close(whole, jgrads, GRAD_TOL, f"{arch} against the reference",
                names)


def test_norm_statistic_without_its_backward_sum_misses(want_grads, ranks):
    """The SSM's gated RMSNorm over all of d_inner, its sum of squares
    summed over ``model`` by ``reduce_from_model`` (whose backward leaves
    each rank its own share of that sum's gradient): the loss is the same,
    and the gradient misses the bound, in ``in_proj`` and the norm's
    scale among others."""
    loss, grads, _, _ = want_grads[SSM]
    _, results = ranks
    got_loss, whole = results[0]["no_sum"]
    np.testing.assert_allclose(got_loss, loss, rtol=0, atol=GRAD_TOL)
    errs = _leaf_errs([g.numpy() for g in whole], grads, GRAD_TOL,
                      _names(SSM))
    missed = {k for k, v in errs.items() if v > 1.0}
    assert any(k.endswith("in_proj/w") for k in missed), errs
    assert any(k.endswith("mixer/norm/scale") for k in missed), errs


def test_model_partial_leaves_are_summed_over_model():
    """The replicated leaves that act on a rank's heads or channels get
    their gradient summed over ``model`` as well as ``data``; the norms of
    the residual stream, which every rank computes whole, over ``data``
    only."""
    mesh = mesh_lib.Mesh((1, 2, 2), mesh_lib.AXES)
    both = ("data", "model")
    for arch, paths in ((SSM, ("A_log", "dt_bias", "D", "conv_b",
                               "norm/scale")),
                        (RGLRU, ("conv_b", "lam", "w_a/b", "w_i/b"))):
        got = {p: sharding.grad_sync_axis(p, s, mesh) for (p, _), s in zip(
            pytree.leaves_with_paths(steps.param_shape(get_config(arch))),
            sharding.leaf_specs(steps.param_shape(get_config(arch)), mesh))}
        for p, axis in got.items():
            partial = any(p.endswith("mixer/" + q) for q in paths)
            if p.endswith(("norm1/scale", "norm2/scale", "final_norm/scale")):
                assert axis == "data", (p, axis)
            elif partial:
                assert axis == both, (p, axis)
    enc = steps.param_shape(get_config(ENCDEC))
    for (p, _), s in zip(pytree.leaves_with_paths(enc),
                         sharding.leaf_specs(enc, mesh)):
        if p.endswith(("/scale", "/bias")):
            assert sharding.grad_sync_axis(p, s, mesh) == "data", p


# ---------------------------------------------------------------------------
# (ii) steps and exchanges, (iii) the checkpoint, on (2, 1, 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strategy", intra.STRATEGIES)
def test_ssm_exchange_on_blocks_matches_one_card_bit_for_bit(ranks, strategy,
                                                             dtype):
    _, results = ranks
    assert all(r["steps"]["exchange"][strategy, dtype] for r in results)


@pytest.mark.parametrize("strategy", intra.STRATEGIES)
def test_ssm_train_step_on_blocks_matches_one_card(ranks, strategy):
    _, results = ranks
    for i, r in enumerate(results):
        l2, err, same_keys = r["steps"]["step"][strategy]
        assert same_keys and l2 <= STEP_TOL and err <= LOSS_TOL, (i, l2, err)


def test_ssm_checkpoint_on_the_mesh_is_the_one_card_checkpoint(ref, ranks):
    """The gaia state of the SSM (in_proj and conv_w over ``model``, its
    per-head vectors whole) saved on (2, 1, 2): the one-card checkpoint
    of the state gathered whole, array for array and the meta's bytes;
    the reference's ``restore`` reads it; each rank restores its own
    blocks."""
    out_dir, results = ranks
    path = os.path.join(out_dir, intra._id(STEP_MESH))
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
    state = steps.train_state_shape(_cfg(SSM),
                                    intra._comm(intra.CKPT_STRATEGY),
                                    intra.N_PODS)
    like = {k: pytree.tree_map(lambda t: np.zeros(t.shape, np.float32),
                               state[k]) for k in ("params", "vel", "acc")}
    back = ref.ckpt.restore(os.path.join(path, "mesh"), like, step=1)
    with np.load(os.path.join(b, "payload.npz")) as zb:
        for i, leaf in enumerate(ref.jax.tree_util.tree_leaves(back)):
            np.testing.assert_array_equal(np.asarray(leaf), zb[f"leaf_{i}"])
    assert all(r["steps"]["ckpt"] for r in results)


# ---------------------------------------------------------------------------
# (iv) serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,arch", CASES, ids=_id)
def test_prefill_matches_one_card_and_reference(ranks, want_serve, shape,
                                                arch):
    pl = next(p for s, a, p in SERVES if (s, a) == (shape, arch))
    _, results = ranks
    got = _rows(results, shape, (shape, arch, pl), lambda v: v[0])
    _close(got, want_serve[arch]["prefill"], f"{arch} against the port")
    _close(got, want_serve[arch]["jprefill"], f"{arch} against the "
           "reference")


@pytest.mark.parametrize("shape,arch,placement", SERVES, ids=_id)
def test_decode_matches_one_card_and_reference(ranks, want_serve, shape,
                                               arch, placement):
    """Every decode step's logits (the rank's rows, gathered in data
    order) against the one-card serve and the reference's
    ``decode_step``; the greedy tokens (the whole batch's, on every rank)
    against the one-card argmax and the reference's serve step where the
    top two logits lie ``TIE_GAP`` apart."""
    _, results = ranks
    w = want_serve[arch]
    got = _rows(results, shape, (shape, arch, placement), lambda v: v[1],
                dim=1)
    _close(got, w["logits"], f"{arch} against the port")
    _close(got, w["jlogits"], f"{arch} against the reference")
    top2 = torch.topk(w["logits"], 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > TIE_GAP
    assert clear.float().mean() > 0.9, clear
    one = torch.argmax(w["logits"], dim=-1).to(torch.int32)
    for r in results:
        toks = r["serve"][shape, arch, placement][2]
        assert torch.equal(toks[clear], one[clear])
        assert torch.equal(toks[clear], w["jtoks"][clear])


@pytest.mark.parametrize("shape,arch,placement", SERVES, ids=_id)
def test_cache_blocks_gathered_match_one_card(ranks, want_serve, shape, arch,
                                              placement):
    """The cache after the loop, each leaf gathered whole (the SSD state's
    head_dim blocks, the conv histories and the RG-LRU's state whole on
    every model rank or by channel, the attention rings) against the
    one-card cache."""
    _, results = ranks
    got = results[0]["serve"][shape, arch, placement][3]
    want = want_serve[arch]["cache"]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if w.dtype == torch.int32:
            assert torch.equal(g, w), (arch, i)
        else:
            _close(g, w, f"{arch} cache leaf {i}")


@pytest.mark.parametrize("rows", list(UNEMBED_T))
def test_tied_unembedding_matches_one_device(ranks, rows):
    """The tied unembedding on (1, 2, 2) at few rows and at many: the
    logits, x's and the table's gradients of a seeded loss against one
    device's ``x @ table.T``, on every rank."""
    table, x, w = _unembed_inputs(UNEMBED_T[rows])
    table.requires_grad_()
    x.requires_grad_()
    logits = x @ table.T
    gx, gt = torch.autograd.grad((logits * w).sum(), [x, table])
    _, results = ranks
    for r in results:
        got = r["unembed"][rows]
        for g, w_, what in zip(got, (logits.detach(), gx, gt),
                               ("logits", "x", "table")):
            _close(g, w_, f"{rows} rows: {what}")


def test_ranks_hold_their_coordinates(ranks):
    _, results = ranks
    for shape in {s for s, _ in CASES} | {STEP_MESH}:
        want = [dict(zip(mesh_lib.AXES, map(int, np.unravel_index(i, shape))))
                for i in range(4)]
        assert [r["coords"][shape] for r in results] == want


# ---------------------------------------------------------------------------
# What the layout takes and refuses (mesh descriptions, no process group)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 2, 2)], ids=_id)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["train", "serve"])
def test_check_layout_takes_the_four_families_at_full_width(arch, shape,
                                                            mode):
    """The step of ``mode`` traced on the mesh's last rank
    (``_torch_layout``)."""
    trace_layout(get_config(arch), shape, mode)


def test_specs_are_the_reference_rules():
    """The placements the port computes around: the SSM's in_proj blocks
    over ``model`` cut across its heads, the SSD state's head_dim over
    ``model``, the RG-LRU's caches whole over ``model``."""
    mesh = mesh_lib.Mesh((1, 2, 2), mesh_lib.AXES)
    specs = dict(zip(
        (p for p, _ in pytree.leaves_with_paths(steps.param_shape(
            get_config(SSM)))),
        sharding.leaf_specs(steps.param_shape(get_config(SSM)), mesh)))
    assert specs["body/0/mixer/in_proj/w"] == (None, "data", "model")
    assert specs["body/0/mixer/conv_w"] == (None, None, "model")
    assert specs["body/0/mixer/out_proj/w"] == (None, "model", "data")
    for arch, want in ((SSM, {"body/0/ssd": (None, "data", None, "model",
                                             None),
                              "body/0/conv": (None, "data", None, None)}),
                       (RGLRU, {"body/0/h": (None, "data", None),
                                "body/0/conv": (None, "data", None, None),
                                "suffix/0/h": ("data", None)})):
        whole = steps.cache_shape(get_config(arch), 8, 64)
        got = dict(zip((p for p, _ in pytree.leaves_with_paths(whole)),
                       pytree.leaves_like(sharding.cache_shardings(
                           whole, mesh, batch_sharded=True), whole)))
        for path, spec in want.items():
            assert got[path] == spec, (arch, path, got[path])


@pytest.mark.parametrize("arch", [SSM, RGLRU])
def test_recurrent_caches_refuse_the_whole_batch_on_a_data_axis(arch):
    """With the requests whole the reference places the conv history's
    slots over ``data``: the port serves these models with the requests
    over ``data`` (the default), and refuses the other placement."""
    cfg = _cfg(arch)
    mesh = mesh_lib.Mesh((1, 2, 1), mesh_lib.AXES)
    assert sharding.default_batch_sharded(cfg, 4, mesh)
    assert not sharding.default_batch_sharded(cfg, 4, mesh_lib.Mesh(
        (1, 1, 2), mesh_lib.AXES))
    with pytest.raises(ValueError, match="batch_sharded"):
        model.init_cache(cfg, 4, CACHE, device="cpu", mesh=mesh,
                         batch_sharded=False)


def test_encode_step_needs_an_encoder():
    with pytest.raises(ValueError, match="no encoder"):
        steps.make_encode_step(_cfg(SSM))


def test_serve_step_refuses_a_state_block_of_another_placement():
    """A cache made with the requests whole (the RG-LRU's state split by
    channel over ``model``) handed to a serve step that places the
    requests over ``data`` (the state whole on every ``model`` rank):
    ``ValueError`` naming the state's block, before any collective (a
    mesh description, no process group)."""
    cfg = _cfg(RGLRU)
    mesh = mesh_lib.Mesh((1, 1, 4), mesh_lib.AXES)
    params = sharding.local_params(model.init_model(
        torch.Generator().manual_seed(0), cfg, "cpu"), mesh)
    cache = model.init_cache(cfg, SERVE_B, CACHE, device="cpu", mesh=mesh,
                             batch_sharded=False)
    step = steps.make_serve_step(cfg, mesh=mesh, batch_sharded=True)
    _, dec, _ = _serve_inputs(cfg)
    with pytest.raises(ValueError,
                       match=r"cache block suffix/0/h: \(8, 64\)"):
        step(params, cache, _step_batch(dec, 0))
