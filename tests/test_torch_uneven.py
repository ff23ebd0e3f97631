"""Dimensions a mesh axis does not divide, on the CPU (ROADMAP A11d: C17,
C18): gloo ranks started by ``repro_torch.launch.procs.spawn`` place
them as the reference's ``_clamp_spec`` does, against the one-device
port and the JAX reference (imported by the fixtures only: the ranks
import this file and need no JAX).

Two spawns, one a mesh, each with a deadline (``SPAWN_TIMEOUT``), run
every rank-side case once (module-scoped fixtures); the parametrized
tests read their results.

- (1, 1, 3), three ranks: reduced archs of the families C17 touches,
  each widened so that 3 divides every projection's columns but not the
  4 query heads, nor the vocabulary of 512: GQA with qk-norm (4 over 4 KV
  heads of 48, every head gathered), GQA with one KV head (shared by the ranks),
  MLA (wukv's heads whole on every rank), the RG-LRU hybrid and the
  enc-dec (its encoder and cross-attention too).  (i) the pod's loss and
  each gathered gradient leaf, remat on and off; (ii) the prefill and
  every decode step's logits and greedy tokens under the cache's
  placements: flash-decode, the heads placement and, for the RG-LRU
  hybrid, the requests whole.
- (1, 2, 2), four ranks: (i) for the SSM with a vocabulary of 511, which
  the ``model`` axis does not divide; (iii) one request (``long_500k``'s
  batch, which ``data`` does not divide: every rank holds it) for GQA,
  MLA, the SSM and the RG-LRU hybrid, each decode cache's length over
  ``data`` (the SSD state's heads over ``data``, the conv histories
  whole) and seeded as it stands after ``T0`` tokens, so that every
  attention ring has wrapped: the prefill of a prompt, then every decode
  step's logits and greedy tokens from position ``T0`` on.

Tolerances, float32: the pod's loss and each gathered gradient leaf
against the one-device port's ``loss_fn`` and against
``jax.value_and_grad`` of the reference's, within 2e-5 x max(1,
max|leaf|); the prefill's and every decode step's logits within 2e-5 x
max(1, max|logits|) of the one-card serve and of the reference's
``decode_step``; the greedy tokens equal to both where the one-card
logits' two largest lie ``TIE_GAP`` apart.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro_torch import pytree
from repro_torch.configs.base import CommConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import procs, sharding, steps
from repro_torch.models import model

SPAWN_TIMEOUT = 240
GRAD_TOL = 2e-5
TIE_GAP = 1e-4
GQA, KV1, MLA = "qwen3-0.6b", "starcoder2-3b", "minicpm3-4b"
RGLRU, ENCDEC, SSM = "recurrentgemma-2b", "seamless-m4t-large-v2", \
    "mamba2-780m"
#: the (1, 1, 3) archs: every one's heads and vocabulary whole over model
THREE = (GQA, KV1, MLA, RGLRU, ENCDEC)
#: the one-request archs over (1, 2, 2)
ONE = (GQA, MLA, SSM, RGLRU)
TRAIN_T = {GQA: 24, KV1: 24, MLA: 24, RGLRU: 80, ENCDEC: 24, SSM: 24}
GRAD_B = 2
SERVE_B, SERVE_T, DECODE, CACHE = 2, 12, 4, 48
#: (batch_sharded, baseline_decode) on (1, 1, 3): flash-decode, the heads
#: placement, and the requests whole (a data axis of one)
PLACEMENTS = {a: ((True, False), (True, True)) for a in THREE}
PLACEMENTS[RGLRU] += ((False, False),)
SERVES = [(a, pl) for a in THREE for pl in PLACEMENTS[a]]
#: the one request: its cache's slots, the tokens it holds (past every
#: ring of the reduced configs: 64 slots), its prompt and decode steps
ONE_CACHE, T0, ONE_T, ONE_DECODE = 128, 160, 12, 4


def _id(x):
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], bool):
        return f"bs{int(x[0])}-base{int(x[1])}"
    return str(x)


def _three(cfg, arch):
    """``cfg`` widened for a model axis of 3: heads of 48 (4 x 48 = 192
    columns), d_ff 384, MLA's q_lora 96, kv_lora 80 (+ 16 rope = 96) and
    v_head 48, the RG-LRU's width 192, the encoder's d_model 192."""
    a = dataclasses.replace(cfg.attention, head_dim=48)
    if arch == KV1:
        a = dataclasses.replace(a, n_kv_heads=1)
    if arch == MLA:
        a = dataclasses.replace(a, q_lora_rank=96, kv_lora_rank=80,
                                v_head_dim=48)
    kw = dict(attention=a, d_ff=384)
    if arch == RGLRU:
        kw["rglru"] = dataclasses.replace(cfg.rglru, lru_width=192)
    if arch == ENCDEC:
        kw["encoder"] = dataclasses.replace(cfg.encoder, d_model=192)
    return dataclasses.replace(cfg, **kw)


def _cfg(arch, mesh, get=get_config):
    """The config of ``arch`` on ``mesh`` ("three" or "one"); ``get`` is
    the registry's ``get_config``, the port's or the reference's.  The
    RG-LRU hybrid keeps one whole (rglru, rglru, attn) cycle: 3 layers."""
    cfg = get(arch).reduced()
    if arch == RGLRU:
        cfg = dataclasses.replace(cfg, n_layers=3)
    if mesh == "three":
        return _three(cfg, arch)
    return dataclasses.replace(cfg, vocab=511) if arch == SSM else cfg


def _extras(cfg, B, seed):
    """The enc-dec's frames of ``B`` requests, float32 NumPy, or none."""
    if cfg.encoder is None:
        return {}
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal(
        (B, cfg.encoder.n_frames, cfg.modality.feat_dim)).astype(
        np.float32)}


def _train_batch(cfg, T):
    """(i)'s batch: tokens, labels (a sixth of them -1), frames."""
    rng = np.random.default_rng(13)
    toks = rng.integers(0, cfg.vocab, (GRAD_B, T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (GRAD_B, T)).astype(np.int32)
    labels[rng.random((GRAD_B, T)) < 1 / 6] = -1
    return {"tokens": toks, "labels": labels, **_extras(cfg, GRAD_B, 14)}


def _torch_batch(nb):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else
            torch.from_numpy(v) for k, v in nb.items()}


def _serve_inputs(cfg, B, T, n):
    """(the prompt (B, T), the tokens fed to the n decode steps (B, n),
    the frames as tensors)."""
    rng = np.random.default_rng(21)
    return (torch.from_numpy(rng.integers(0, cfg.vocab, (B, T))),
            torch.from_numpy(rng.integers(0, cfg.vocab, (B, n))),
            {k: torch.from_numpy(v) for k, v in
             _extras(cfg, B, 22).items()})


def _step_batch(toks, i, t):
    return {"token": toks[:, i],
            "t": torch.full((toks.shape[0],), t, dtype=torch.int32)}


def _seeded_cache(cfg):
    """The one request's whole decode cache as it stands after ``T0``
    tokens: every float leaf from a seed, every position ring filled with
    the last tokens its slots hold (position t in slot t mod L)."""
    whole = model.init_cache(cfg, 1, ONE_CACHE, long_mode=True,
                             device="cpu")
    rng = np.random.default_rng(41)
    out = []
    for path, t in pytree.leaves_with_paths(whole):
        if t.dtype == torch.int32:
            L = t.shape[-1]
            slot = np.arange(L)
            pos = T0 - L + (slot - (T0 - L)) % L
            out.append(torch.from_numpy(np.broadcast_to(
                pos.astype(np.int32), t.shape).copy()))
        else:
            out.append(torch.from_numpy(0.5 * rng.standard_normal(
                tuple(t.shape)).astype(np.float32)))
    return pytree.unflatten(whole, out)


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _gathered_grads(cfg, mesh, params, nb, remat):
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


def _decode_loop(step, params, cache, toks, t0):
    """Each decode step's logits and greedy tokens from position ``t0``
    (the token step on a copy of the cache: a recurrent state advances
    in place)."""
    logits, out = [], []
    for i in range(toks.shape[1]):
        tok, _ = step(params, pytree.tree_map(torch.clone, cache),
                      _step_batch(toks, i, t0 + i))
        lg, cache = step.logits(params, cache, _step_batch(toks, i, t0 + i))
        logits.append(lg)
        out.append(tok)
    return torch.stack(logits), torch.stack(out)


def _serve_three(cfg, mesh, params, placement):
    """(ii) on this rank: the prefill's logits and each decode step's
    logits and tokens."""
    bs, base = placement
    prompt, dec, extra = _serve_inputs(cfg, SERVE_B, SERVE_T, DECODE)
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
        return (pre,) + _decode_loop(step, params, cache, dec, 0)


def _serve_one(cfg, mesh, params):
    """(iii) on this rank: the one request's prefill logits, then each
    decode step's from the seeded cache's block (its length over
    ``data``)."""
    prompt, dec, _ = _serve_inputs(cfg, 1, ONE_T, ONE_DECODE)
    with torch.inference_mode():
        pre = steps.make_prefill_step(cfg, mesh=mesh)(params,
                                                      {"tokens": prompt})
        cache = pytree.tree_map(torch.clone, sharding.local_cache(
            _seeded_cache(cfg), mesh, batch_sharded=False))
        step = steps.make_serve_step(cfg, mesh=mesh, batch_sharded=False)
        return (pre,) + _decode_loop(step, params, cache, dec, T0)


def _ranks(rank, dev, trees, which):
    torch.set_num_threads(1)
    shape = (1, 1, 3) if which == "three" else (1, 2, 2)
    mesh = mesh_lib.make_mesh(shape, device=dev)
    res = {"grads": {}, "serve": {}, "coords": mesh.coords}
    for arch, (tree, nb) in trees.items():
        cfg = _cfg(arch, which)
        params = model.lm_params_from_jax(tree, "cpu")
        if nb is not None:
            for remat in (True, False):
                loss, whole = _gathered_grads(cfg, mesh, params, nb, remat)
                res["grads"][arch, remat] = (loss, whole if rank == 0
                                             else None)
        local = sharding.local_params(params, mesh)
        if which == "three":
            for pl in PLACEMENTS[arch]:
                res["serve"][arch, pl] = _serve_three(cfg, mesh, local, pl)
        elif arch in ONE:
            res["serve"][arch] = _serve_one(cfg, mesh, local)
    return res


# ---------------------------------------------------------------------------
# Fixtures: the reference, the one-card values, the spawns
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    """The JAX reference, imported here only."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jax_get_config
    from repro.launch import steps as jax_steps
    from repro.models import model as jax_model
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=jax_get_config,
                                 steps=jax_steps, model=jax_model)


def _trees(ref, which, archs, train):
    """For each arch: the reference's weights (``init_model`` at key 0, as
    NumPy) and (i)'s batch where ``train`` holds the arch."""
    out = {}
    for arch in archs:
        jp = ref.model.init_model(ref.jax.random.PRNGKey(0),
                                  _cfg(arch, which, ref.get_config))
        cfg = _cfg(arch, which)
        out[arch] = (ref.jax.tree_util.tree_map(np.asarray, jp),
                     _train_batch(cfg, TRAIN_T[arch]) if arch in train
                     else None)
    return out


@pytest.fixture(scope="module")
def trees(ref):
    return {"three": _trees(ref, "three", THREE, THREE),
            "one": _trees(ref, "one", ONE, (SSM,))}


@pytest.fixture(scope="module")
def ranks(trees):
    return {which: procs.spawn(_ranks, n, backend="gloo", device="cpu",
                               timeout=SPAWN_TIMEOUT,
                               args=(trees[which], which))
            for which, n in (("three", 3), ("one", 4))}


def _want_grads(ref, which, arch, tree, nb):
    """The one-device port's and the reference's loss and gradient
    leaves."""
    cfg = _cfg(arch, which)
    p = pytree.tree_map(lambda t: t.requires_grad_(),
                        model.lm_params_from_jax(tree, "cpu"))
    loss, _ = model.loss_fn(p, cfg, _torch_batch(nb))
    grads = [g.numpy() for g in torch.autograd.grad(loss, pytree.leaves(p))]
    jcfg = _cfg(arch, which, ref.get_config)
    jloss, jgrads = ref.jax.value_and_grad(
        lambda p_, b_: ref.model.loss_fn(p_, jcfg, b_)[0])(
        ref.jax.tree_util.tree_map(ref.jnp.asarray, tree),
        {k: ref.jnp.asarray(v) for k, v in nb.items()})
    return (float(loss.detach()), grads, float(jloss),
            [np.asarray(g) for g in ref.jax.tree_util.tree_leaves(jgrads)])


@pytest.fixture(scope="module")
def want_grads(ref, trees):
    return {(which, arch): _want_grads(ref, which, arch, tree, nb)
            for which in trees for arch, (tree, nb) in trees[which].items()
            if nb is not None}


def _want_serve(ref, cfg, jcfg, tree, prompt, dec, extra, cache, jcache,
                t0):
    """The one-card serve's and the reference's prefill logits, every
    decode step's logits from ``cache`` (``jcache``) and the reference's
    serve tokens."""
    jnp = ref.jnp
    p = model.lm_params_from_jax(tree, "cpu")
    jp = ref.jax.tree_util.tree_map(jnp.asarray, tree)
    jextra = {k: jnp.asarray(v.numpy()) for k, v in extra.items()}
    with torch.inference_mode():
        r = {"prefill": steps.make_prefill_step(cfg)(
            p, {"tokens": prompt, **extra})}
        memory = (steps.make_encode_step(cfg)(p, extra)
                  if cfg.encoder is not None else None)
        step = steps.make_serve_step(cfg, memory)
        logits = []
        for i in range(dec.shape[1]):
            lg, cache = step.logits(p, cache, _step_batch(dec, i, t0 + i))
            logits.append(lg)
    r["jprefill"] = torch.from_numpy(np.asarray(ref.jax.jit(
        ref.steps.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(prompt.numpy()), **jextra})))
    jdecode = ref.jax.jit(lambda p_, b_, c_: ref.model.decode_step(
        p_, jcfg, b_, c_))
    jserve = ref.jax.jit(ref.steps.make_serve_step(jcfg))
    jlogits, jtoks, jscache = [], [], jcache
    for i in range(dec.shape[1]):
        jb = {k: jnp.asarray(v.numpy())
              for k, v in _step_batch(dec, i, t0 + i).items()}
        jb.update(jextra)
        jl, jcache = jdecode(jp, jb, jcache)
        jlogits.append(torch.from_numpy(np.asarray(jl)))
        jt, jscache = jserve(jp, jscache, jb)
        jtoks.append(torch.from_numpy(np.asarray(jt)))
    r.update(logits=torch.stack(logits), jlogits=torch.stack(jlogits),
             jtoks=torch.stack(jtoks))
    return r


@pytest.fixture(scope="module")
def want_serve(ref, trees):
    """Per (mesh, arch): the one-card serve and the reference's, on the
    (1, 1, 3) serve inputs from empty caches, or on the one request's
    prompt and seeded cache."""
    out = {}
    for arch in THREE:
        cfg, jcfg = _cfg(arch, "three"), _cfg(arch, "three", ref.get_config)
        prompt, dec, extra = _serve_inputs(cfg, SERVE_B, SERVE_T, DECODE)
        out["three", arch] = _want_serve(
            ref, cfg, jcfg, trees["three"][arch][0], prompt, dec, extra,
            model.init_cache(cfg, SERVE_B, CACHE, device="cpu"),
            ref.model.init_cache(jcfg, SERVE_B, CACHE), 0)
    for arch in ONE:
        cfg, jcfg = _cfg(arch, "one"), _cfg(arch, "one", ref.get_config)
        prompt, dec, extra = _serve_inputs(cfg, 1, ONE_T, ONE_DECODE)
        cache = _seeded_cache(cfg)
        jcache = ref.jax.tree_util.tree_unflatten(
            ref.jax.tree_util.tree_structure(ref.model.init_cache(
                jcfg, 1, ONE_CACHE, long_mode=True)),
            [ref.jnp.asarray(np.array(t.numpy())) for t in
             pytree.leaves(cache)])
        out["one", arch] = _want_serve(ref, cfg, jcfg, trees["one"][arch][0],
                                       prompt, dec, extra, cache, jcache, T0)
    return out


def _names(cfg):
    """The leaf paths of ``cfg``'s params, in ``pytree.leaves``' order."""
    return [path for path, _ in pytree.leaves_with_paths(
        model.init_model(None, cfg, "meta"))]


def _leaf_close(got, want, what, names):
    """Each leaf within GRAD_TOL x max(1, max|want|), the worst named."""
    assert len(got) == len(want) == len(names)
    errs = {}
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        bound = GRAD_TOL * max(1.0, float(np.abs(w).max(initial=0.0)))
        errs[name] = float(np.abs(g - w).max(initial=0.0)) / bound
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1.0, (what, worst, errs[worst])


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = GRAD_TOL * max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= bound, (what, err, bound)


# ---------------------------------------------------------------------------
# (i) the pod's loss and gradient
# ---------------------------------------------------------------------------

GRADS = [("three", a) for a in THREE] + [("one", SSM)]


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("which,arch", GRADS, ids=_id)
def test_grads_match_one_device_and_reference(want_grads, ranks, which, arch,
                                              remat):
    """The pod's loss on every rank and each gathered gradient leaf (the
    projections whose columns split across a head, the qk-norm and latent
    norm scales, MLA's whole wukv, the whole table and unembedding, by
    name in the message) against the one-device port and
    ``jax.value_and_grad`` of the reference's ``loss_fn``."""
    loss, grads, jloss, jgrads = want_grads[which, arch]
    results = ranks[which]
    losses = [r["grads"][arch, remat][0] for r in results]
    whole = [g.numpy() for g in results[0]["grads"][arch, remat][1]]
    assert len(set(losses)) == 1, losses
    np.testing.assert_allclose(losses[0], loss, rtol=0, atol=GRAD_TOL)
    np.testing.assert_allclose(losses[0], jloss, rtol=0, atol=GRAD_TOL)
    names = _names(_cfg(arch, which))
    _leaf_close(whole, grads, f"{arch} against the port", names)
    _leaf_close(whole, jgrads, f"{arch} against the reference", names)


# ---------------------------------------------------------------------------
# (ii), (iii) serving
# ---------------------------------------------------------------------------

def _serve_close(results, key, w, what):
    """Every rank's prefill and decode logits against the one-card serve
    and the reference's, its greedy tokens where the one-card logits'
    top two lie ``TIE_GAP`` apart (each rank holds every request)."""
    top2 = torch.topk(w["logits"], 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > TIE_GAP
    assert clear.float().mean() > 0.75, clear
    one = torch.argmax(w["logits"], dim=-1).to(torch.int32)
    for i, r in enumerate(results):
        pre, logits, toks = r["serve"][key]
        for got, a, b in ((pre, "prefill", "jprefill"),
                          (logits, "logits", "jlogits")):
            _close(got, w[a], f"{what} rank {i} {a} against the port")
            _close(got, w[b], f"{what} rank {i} {a} against the reference")
        assert torch.equal(toks[clear], one[clear]), (what, i)
        assert torch.equal(toks[clear], w["jtoks"][clear]), (what, i)


@pytest.mark.parametrize("arch,placement", SERVES, ids=_id)
def test_serve_with_heads_and_vocab_whole(ranks, want_serve, arch,
                                          placement):
    """(1, 1, 3): the prefill and every decode step, each rank running
    every head and the whole vocabulary."""
    _serve_close(ranks["three"], (arch, placement), want_serve["three", arch],
                 arch)


@pytest.mark.parametrize("arch", ONE)
def test_one_request_over_data(ranks, want_serve, arch):
    """(1, 2, 2): one request on every rank, its cache's length over
    ``data`` with every ring wrapped; the decode from position ``T0``."""
    _serve_close(ranks["one"], arch, want_serve["one", arch], arch)


def test_ranks_hold_their_coordinates(ranks):
    for which, shape in (("three", (1, 1, 3)), ("one", (1, 2, 2))):
        want = [dict(zip(mesh_lib.AXES, map(int, np.unravel_index(i, shape))))
                for i in range(int(np.prod(shape)))]
        assert [r["coords"] for r in ranks[which]] == want


# ---------------------------------------------------------------------------
# What the layout takes and refuses (mesh descriptions, no process group)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [GQA, KV1, MLA, RGLRU, ENCDEC])
@pytest.mark.parametrize("mode", ["train", "serve"])
def test_check_layout_takes_heads_and_vocab_whole(arch, mode):
    """The widened configs on (1, 1, 3), which the ranks above train and
    serve (their heads of 48 are no kernel's, so no ``meta`` trace): the
    query heads and the vocabulary the axis does not divide are whole on
    every rank (``heads_whole``, ``vocab_whole``; the table's vocabulary
    rows whole in ``leaf_specs``) inside attention blocks that run split
    (the query columns over ``model``); to serve, the heads placement's
    KV heads whole in the cache's specs."""
    cfg = _cfg(arch, "three")
    mesh = mesh_lib.Mesh((1, 1, 3), mesh_lib.AXES)
    assert sharding.heads_whole(cfg.attention, 3)
    assert sharding.vocab_whole(cfg.vocab, 3)
    if mode == "train":
        shapes = steps.param_shape(cfg)
        specs = dict(zip((p_ for p_, _ in pytree.leaves_with_paths(shapes)),
                         sharding.leaf_specs(shapes, mesh)))
        assert specs["embed/table"][-2] is None
        cols = [s_ for p_, s_ in specs.items()
                if p_.endswith(("mixer/wq/w", "mixer/wuq/w"))]
        assert cols and all(s_[-1] == "model" for s_ in cols), cols
        return
    cache = model.init_cache(cfg, 3, 12, device="meta")
    kv = [s_ for (p_, _), s_ in zip(
        pytree.leaves_with_paths(cache), pytree.leaves_like(
            sharding.cache_shardings(cache, mesh, batch_sharded=True,
                                     baseline_decode=True), cache))
        if p_.endswith("/k")]
    assert all(s_[-2] is None for s_ in kv), kv


@pytest.mark.parametrize("arch", [SSM, RGLRU])
def test_recurrent_caches_take_the_whole_batch_it_does_not_split(arch):
    """One request on a data axis of 2: the whole-batch placement (its
    SSD state's heads over ``data``, the conv history whole) by default;
    two requests split over ``data`` keep the requests over ``data``."""
    cfg = _cfg(arch, "one")
    mesh = mesh_lib.Mesh((1, 2, 2), mesh_lib.AXES)
    assert not sharding.default_batch_sharded(cfg, 1, mesh)
    assert sharding.default_batch_sharded(cfg, 2, mesh)
    sharding.check_cache_placement(cfg, mesh, False, 1)
    with pytest.raises(ValueError, match="split over data"):
        sharding.check_cache_placement(cfg, mesh, False, 2)


def test_a_conv_history_split_over_data_is_refused():
    """The whole batch's conv history of d_conv - 1 = 3 slots over a data
    axis of 3, which the clamp would split: refused, named."""
    cfg = _cfg(SSM, "one")
    with pytest.raises(ValueError, match="d_conv - 1=3 over data=3"):
        sharding.check_cache_placement(
            cfg, mesh_lib.Mesh((1, 3, 1), mesh_lib.AXES), False, 1)


def test_clamped_leaves_are_whole_on_every_model_rank():
    """The table and MLA's wukv keep the vocabulary and the heads whole
    over ``model`` (d_model still over ``data``); the projections'
    columns split across a head."""
    mesh = mesh_lib.Mesh((1, 2, 3), mesh_lib.AXES)
    specs = dict(zip((p for p, _ in pytree.leaves_with_paths(
        steps.param_shape(_cfg(MLA, "three")))), sharding.leaf_specs(
        steps.param_shape(_cfg(MLA, "three")), mesh)))
    assert specs["embed/table"] == (None, "data")
    assert specs["body/0/mixer/wukv"] == (None, None, None, None)
    assert specs["body/0/mixer/wuq/w"] == (None, "data", "model")
    assert specs["body/0/mixer/wo/w"] == (None, "model", "data")
