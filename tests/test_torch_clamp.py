"""Every leaf the reference's ``_clamp_spec`` keeps whole, on the CPU
(ROADMAP A11e): gloo ranks started by ``repro_torch.launch.procs.spawn``
hold each dimension a mesh axis does not split whole on every rank of
the axis, and compute the one-device function, against the one-device
port and the JAX reference (imported by the fixtures only: the ranks
import this file and need no JAX).

The configs are the registry's ``reduced()`` ones, unwidened: on a
``model`` axis of 3 none of their projections' columns split but MLA's
wuq (4 x 48) and deepseek's wq, so most blocks run whole on every rank,
and wuq and wq are gathered whole inside them; on a ``data`` axis of 3
no d_model (256) splits, so no weight is gathered over ``data``.  One
extra case, ``STRADDLE`` (starcoder2's reduced config with 6 query heads
over 2 KV heads of 64), runs split over ``model`` = 3 with wk and wv
whole and the middle rank's query heads reading both KV heads; another,
``SSM_SPLIT`` (mamba2's with 4 heads of 96), runs every head on every
rank inside a block split over ``model`` = 3, trained only.

Three spawns, one a mesh, each with a deadline (``SPAWN_TIMEOUT``):

- (a) (1, 1, 3) and (b) (1, 3, 1), three ranks each: one arch of each
  family, GQA (qwen3), one KV head a group of 2 (starcoder2), MLA
  (minicpm3), MLA + MoE (deepseek-v2-lite, dense and EP routes: the EP
  route takes the dense one where ``ep_applicable`` is false, as on a
  model axis of 3 over 4 experts), the SSM (mamba2), the RG-LRU hybrid
  (recurrentgemma, one (rglru, rglru, attn) cycle), the enc-dec
  (seamless) and the VLM (phi-3-vision).  (i) the pod's loss and each
  gathered gradient leaf, remat on and off; (ii) the prefill and every
  decode step's logits and greedy tokens under the cache's placements:
  on (1, 1, 3) flash-decode with a length of 64 the axis does not split
  (whole on every rank), the heads placement, and for the recurrent
  archs the requests whole; on (1, 3, 1) the default placement.
- (c) (2, 3, 1), six ranks: the dgc and dpsgd exchanges of the reduced
  qwen3, every 2-D leaf whole over ``data``, and of a variant whose
  d_model of 192 the axis splits, each leaf against the one-card
  exchange bit for bit, with the route each took (``ops.dgc_sparsify``
  on a whole leaf, ``ops.abs_histogram`` and ``ops.dgc_select`` on a
  split one) counted; one bsp step against the one-card step.

Tolerances, float32: the pod's loss and each gathered gradient leaf
within 2e-5 x max(1, max|leaf|) of the one-device port's and of
``jax.value_and_grad`` of the reference's ``loss_fn``; the prefill's and
every decode step's logits within 2e-5 x max(1, max|logits|) of the
one-card serve and of the reference's ``decode_step``; the greedy tokens
equal to both where the one-card logits' two largest lie ``TIE_GAP``
apart.

``tests/test_torch_clamp_grid.py`` traces the ten archs' steps on every
small mesh.
"""
import concurrent.futures
import dataclasses
import types

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro_torch import pytree
from repro_torch.configs.base import CommConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import procs, sharding, steps
from repro_torch.launch.meta import MetaMesh
from repro_torch.models import attention, model, moe, moe_ep, rglru, ssm
from repro_torch.models.layers import block_whole, gated_mlp_apply
from repro_torch.models.shard_hints import activation_sharding

import test_torch_intrapod as intra
import test_torch_uneven as uneven

SPAWN_TIMEOUT = 300
GRAD_TOL = uneven.GRAD_TOL
GQA, KV1, MLA, MOE = ("qwen3-0.6b", "starcoder2-3b", "minicpm3-4b",
                      "deepseek-v2-lite-16b")
SSM, RGLRU, ENCDEC, VLM = ("mamba2-780m", "recurrentgemma-2b",
                           "seamless-m4t-large-v2", "phi-3-vision-4.2b")
STRADDLE, SSM_SPLIT = "starcoder2-3b@straddle", "mamba2-780m@split"
FAMILIES = (GQA, KV1, MLA, MOE, SSM, RGLRU, ENCDEC, VLM)
MESHES = {"model3": (1, 1, 3), "data3": (1, 3, 1)}
#: the archs of each mesh's spawn
ARCHS = {"model3": FAMILIES + (STRADDLE, SSM_SPLIT), "data3": FAMILIES}
#: (arch, moe route) of (i)
GRAD_RUNS = [(a, "dense") for a in ARCHS["model3"]] + [(MOE, "ep")]
TRAIN_T = {a: 24 for a in ARCHS["model3"]}
TRAIN_T[RGLRU] = 80
GRAD_B = 3
#: (i) on (1, 3, 1) with 2 sequences a pod, which the data axis does not
#: split: every data rank runs both (``shard_hints.rows_whole``)
ROWS_ARCHS, ROWS_B = (GQA, MOE), 2
SERVE_B, SERVE_T, DECODE = 3, 12, 4
#: the caches' lengths: 64 slots, which a model axis of 3 does not split
#: (the flash-decode length whole on every rank), 48 over a data axis of 3
CACHE = {"model3": 64, "data3": 48}
#: (batch_sharded, baseline_decode) on (1, 1, 3); the default (None) on
#: (1, 3, 1)
PLACEMENTS = {a: ((True, False), (True, True)) for a in ARCHS["model3"]}
PLACEMENTS[SSM_SPLIT] = ()                   # trained only
for _a in (SSM, RGLRU):
    PLACEMENTS[_a] += ((False, False),)
SERVES = ([("model3", a, pl) for a in ARCHS["model3"] for pl in PLACEMENTS[a]]
          + [("data3", a, None) for a in FAMILIES])
#: (ii) on (1, 3, 1): 4 requests placed over data (batch_sharded=True),
#: which the axis does not split: every rank decodes all of them
WHOLE_B, WHOLE_ARCHS = 4, (GQA, SSM, RGLRU)
TIE_GAP = uneven.TIE_GAP
#: (c): the mesh, the strategies, the variant's d_model
EX_MESH, EX_STRATEGIES, EX_WIDE = (2, 3, 1), ("dgc", "dpsgd"), 192


def _id(x):
    if x is None:
        return "default"
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], bool):
        return f"bs{int(x[0])}-base{int(x[1])}"
    if isinstance(x, tuple):
        return "x".join(map(str, x))
    return str(x)


def _cfg(arch, get=get_config):
    """The reduced config of ``arch``; the RG-LRU hybrid keeps one whole
    (rglru, rglru, attn) cycle (3 layers); ``STRADDLE``: starcoder2's with
    6 query heads over 2 KV heads of 64; ``SSM_SPLIT``: mamba2's with a
    d_model of 192 and 4 heads of 96, so that a model axis of 3 splits
    out_proj's 384 rows and in_proj's 804 columns but neither the heads
    nor the 416 conv channels (every head on every rank inside a block
    that runs split).  ``get`` is the registry's ``get_config``, the
    port's or the reference's."""
    name, _, variant = arch.partition("@")
    cfg = get(name).reduced()
    if name == RGLRU:
        cfg = dataclasses.replace(cfg, n_layers=3)
    if variant == "straddle":
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, n_heads=6, n_kv_heads=2, head_dim=64))
    if variant == "split":
        cfg = dataclasses.replace(cfg, d_model=192, ssm=dataclasses.replace(
            cfg.ssm, n_heads=4, head_dim=96))
    return cfg


def _extras(cfg, B, seed):
    """The enc-dec's frames or the VLM's patches of ``B`` requests, float32
    NumPy, or none."""
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


def _train_batch(cfg, T, B=GRAD_B):
    """(i)'s batch of ``B`` sequences: tokens, labels (a sixth of them
    -1), frames or patches."""
    rng = np.random.default_rng(13)
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    labels[rng.random((B, T)) < 1 / 6] = -1
    return {"tokens": toks, "labels": labels, **_extras(cfg, B, 14)}


def _serve_inputs(cfg, B=SERVE_B):
    """(the prompt (B, T), the tokens fed to the decode steps, the frames
    or patches as tensors)."""
    rng = np.random.default_rng(21)
    return (torch.from_numpy(rng.integers(0, cfg.vocab, (B, SERVE_T))),
            torch.from_numpy(rng.integers(0, cfg.vocab, (B, DECODE))),
            {k: torch.from_numpy(v) for k, v in
             _extras(cfg, B, 22).items()})


def _ep_ref(D, M):
    """``moe.moe_apply`` as the EP route's plain version on (D, M) ranks
    plus the shared experts: the one-device function of the EP route."""
    def apply(p_, m_, x, route="dense"):
        y, aux = moe_ep.moe_apply_ep_ref(p_, m_, x, D, M)
        if "shared" in p_:
            y = y + gated_mlp_apply(p_["shared"], x)
        return y, aux
    return apply


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _gathered_grads(cfg, mesh, params, nb, remat, route, rows_whole=False):
    """The pod's loss and its gathered gradient leaves by ``mesh``'s ranks
    (the train step's ``pod_grads`` on one pod; ``rows_whole``: every
    rank holds all the pod's sequences)."""
    comm = CommConfig(strategy="bsp")
    state = steps.make_train_state(params, comm, 1, mesh=mesh)
    step = steps.make_train_step(cfg, comm, mesh=mesh, remat=remat,
                                 moe_route=route)
    batch = {k: v[None] for k, v in uneven._torch_batch(nb).items()}
    specs_ = sharding.batch_shardings(batch, mesh, pod_stacked=True)
    mine = {k: sharding.local_block(v, specs_[k], mesh)
            for k, v in batch.items()}
    losses, grads = step.pod_grads(state["params"], mine, rows_whole)
    specs = pytree.leaves_like(sharding.train_state_shardings(
        steps.train_state_shape(cfg, comm, 1), mesh)["params"],
        state["params"])
    return float(losses[0]), [sharding.gather_leaf(g, s, mesh)[0]
                              for g, s in zip(grads, specs)]


def _serve(cfg, mesh, params, placement, which, B=SERVE_B):
    """(ii) on this rank: the prefill's logits and each decode step's
    logits and tokens, of ``B`` requests."""
    bs, base = placement or (None, False)
    prompt, dec, extra = _serve_inputs(cfg, B)
    memory = None
    with torch.inference_mode():
        pre = steps.make_prefill_step(cfg, mesh=mesh)(
            params, {"tokens": prompt, **extra})
        if cfg.encoder is not None:
            memory = steps.make_encode_step(cfg, mesh=mesh)(params, extra)
        cache = model.init_cache(cfg, B, CACHE[which], device="cpu",
                                 mesh=mesh, batch_sharded=bs,
                                 baseline_decode=base)
        step = steps.make_serve_step(cfg, memory, mesh=mesh,
                                     batch_sharded=bs, baseline_decode=base)
        return (pre,) + uneven._decode_loop(step, params, cache, dec, 0)


def _ranks(rank, dev, trees, which):
    torch.set_num_threads(1)
    mesh = mesh_lib.make_mesh(MESHES[which], device=dev)
    res = {"grads": {}, "serve": {}, "coords": mesh.coords}
    for arch, (tree, nb) in trees.items():
        cfg = _cfg(arch)
        params = model.lm_params_from_jax(tree, "cpu")
        for a, route in GRAD_RUNS:
            if a != arch:
                continue
            for remat in (True, False):
                loss, whole = _gathered_grads(cfg, mesh, params, nb, remat,
                                              route)
                res["grads"][arch, route, remat] = (
                    loss, whole if rank == 0 else None)
        if which == "data3" and arch in ROWS_ARCHS:
            loss, whole = _gathered_grads(
                cfg, mesh, params, _train_batch(cfg, TRAIN_T[arch], ROWS_B),
                True, "dense", rows_whole=True)
            res["grads"][arch, "rows"] = (loss, whole if rank == 0 else None)
        local = sharding.local_params(params, mesh)
        for w, a, pl in SERVES:
            if (w, a) == (which, arch):
                res["serve"][arch, pl] = _serve(cfg, mesh, local, pl, which)
        if which == "data3" and arch in WHOLE_ARCHS:
            res["serve"][arch, "whole"] = _serve(cfg, mesh, local,
                                                 (True, False), which,
                                                 WHOLE_B)
    return res


def _wide(cfg):
    """The reduced qwen3 with a d_model of ``EX_WIDE`` (split over a data
    axis of 3)."""
    return dataclasses.replace(cfg, d_model=EX_WIDE)


def _exchange_ranks(rank, dev):
    """(c) on this rank: each strategy's exchange of both configs against
    the one-card exchange (bit for bit), the routes' kernel calls, and
    one bsp step against the one-card step."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_mesh(EX_MESH, device=dev)
    calls = {"dgc_sparsify": 0, "abs_histogram": 0, "dgc_select": 0}
    real = {n: getattr(ops, n) for n in calls}

    def counted(name):
        def f(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return f
    res = {"exchange": {}, "axes": {}, "calls": {}}
    base = intra._cfg()
    for label, cfg in (("whole", base), ("split", _wide(base))):
        p = model.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
        specs = sharding.leaf_specs(p, mesh)
        res["axes"][label] = steps.shard_axes(specs, mesh)
        for strategy in EX_STRATEGIES:
            comm = intra._comm(strategy)
            full = intra._exchange_inputs(strategy, cfg, seed=7)
            want = steps.make_exchange(comm, lr=intra.LR)(
                full, step_idx=1, **intra._mix(comm))
            for n in calls:
                calls[n] = 0
                setattr(ops, n, counted(n))
            try:
                got = steps.make_exchange(comm, mesh=mesh, lr=intra.LR,
                                          specs=specs)(
                    intra._blocks(full, specs, mesh, pytree.leaves(p)),
                    step_idx=1, **intra._mix(comm, mesh))
            finally:
                for n, f in real.items():
                    setattr(ops, n, f)
            res["calls"][label, strategy] = dict(calls)
            res["exchange"][label, strategy] = intra._compare(
                pytree.leaves(got), pytree.leaves(intra._blocks(
                    want, specs, mesh, pytree.leaves(p))))[0]
    comm = intra._comm("bsp")
    p = model.init_model(torch.Generator().manual_seed(0), base, "cpu")
    seqs = torch.from_numpy(np.random.default_rng(100).integers(
        0, base.vocab, (intra.N_PODS, 3, intra.STEP_T + 1)))
    batch = {"tokens": seqs[..., :-1], "labels": seqs[..., 1:]}
    one, _ = steps.make_train_step(base, comm, lr=intra.LR)(
        steps.make_train_state(p, comm, intra.N_PODS), batch, 1)
    mine, _ = steps.make_train_step(base, comm, mesh=mesh, lr=intra.LR)(
        steps.make_train_state(p, comm, intra.N_PODS, mesh=mesh), batch, 1)
    specs = sharding.leaf_specs(p, mesh)
    res["step"] = intra._compare(pytree.leaves(mine), pytree.leaves(
        intra._blocks(one, specs, mesh, pytree.leaves(p))))[1]
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


@pytest.fixture(scope="module")
def trees(ref):
    """For each arch: the reference's weights (``init_model`` at key 0, as
    NumPy) and (i)'s batch."""
    out = {}
    for arch in ARCHS["model3"]:
        cfg = _cfg(arch)
        jp = ref.model.init_model(ref.jax.random.PRNGKey(0),
                                  _cfg(arch, ref.get_config))
        out[arch] = (ref.jax.tree_util.tree_map(np.asarray, jp),
                     _train_batch(cfg, TRAIN_T[arch]))
    return out


class _Spawned(dict):
    """The spawns' results by name, each waited for where it is read."""

    def __getitem__(self, key):
        return super().__getitem__(key).result()


@pytest.fixture(scope="module")
def ranks(trees):
    """The three spawns, started side by side (each its own ``FileStore``)
    while the fixtures after this one compute the one-device values."""
    pool = concurrent.futures.ThreadPoolExecutor(len(MESHES) + 1)
    out = _Spawned({which: pool.submit(
        procs.spawn, _ranks, 3, backend="gloo", device="cpu",
        timeout=SPAWN_TIMEOUT,
        args=({a: trees[a] for a in ARCHS[which]}, which))
        for which in MESHES})
    dict.__setitem__(out, "exchange", pool.submit(
        procs.spawn, _exchange_ranks, 6, backend="gloo", device="cpu",
        timeout=SPAWN_TIMEOUT))
    yield out
    pool.shutdown(wait=True)


def _want_grads(ref, arch, tree, nb):
    """The one-device port's and the reference's loss and gradient
    leaves."""
    cfg = _cfg(arch)
    p = pytree.tree_map(lambda t: t.requires_grad_(),
                        model.lm_params_from_jax(tree, "cpu"))
    loss, _ = model.loss_fn(p, cfg, uneven._torch_batch(nb))
    grads = [g.numpy() for g in torch.autograd.grad(loss, pytree.leaves(p))]
    jcfg = _cfg(arch, ref.get_config)
    jloss, jgrads = ref.jax.value_and_grad(
        lambda p_, b_: ref.model.loss_fn(p_, jcfg, b_)[0])(
        ref.jax.tree_util.tree_map(ref.jnp.asarray, tree),
        {k: ref.jnp.asarray(v) for k, v in nb.items()})
    return (float(loss.detach()), grads, float(jloss),
            [np.asarray(g) for g in ref.jax.tree_util.tree_leaves(jgrads)])


@pytest.fixture(scope="module")
def want_grads(ref, trees):
    return {arch: _want_grads(ref, arch, *trees[arch]) for arch in trees}


@pytest.fixture(scope="module")
def want_ep(trees):
    """The one-device port's loss and gradient leaves of deepseek-lite
    under the EP route's plain version on (1, 3, 1)'s ranks."""
    tree, nb = trees[MOE]
    p = pytree.tree_map(lambda t: t.requires_grad_(),
                        model.lm_params_from_jax(tree, "cpu"))
    real = moe.moe_apply
    moe.moe_apply = _ep_ref(*MESHES["data3"][1:])
    try:                    # the backward recomputes the remat cycles
        loss, _ = model.loss_fn(p, _cfg(MOE), uneven._torch_batch(nb))
        grads = torch.autograd.grad(loss, pytree.leaves(p))
    finally:
        moe.moe_apply = real
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.fixture(scope="module")
def want_serve(ref, trees):
    """Per arch: the one-card serve and the reference's from empty caches
    (the decode steps' logits do not depend on the cache's length before
    its ring wraps)."""
    out = {}
    for arch in ARCHS["model3"]:
        if not PLACEMENTS[arch]:
            continue
        cfg, jcfg = _cfg(arch), _cfg(arch, ref.get_config)
        prompt, dec, extra = _serve_inputs(cfg)
        out[arch] = uneven._want_serve(
            ref, cfg, jcfg, trees[arch][0], prompt, dec, extra,
            model.init_cache(cfg, SERVE_B, CACHE["data3"], device="cpu"),
            ref.model.init_cache(jcfg, SERVE_B, CACHE["data3"]), 0)
    return out


@pytest.fixture(scope="module")
def want_whole(ref, trees):
    """Per arch of ``WHOLE_ARCHS``: the one-card serve of ``WHOLE_B``
    requests and the reference's."""
    out = {}
    for arch in WHOLE_ARCHS:
        cfg, jcfg = _cfg(arch), _cfg(arch, ref.get_config)
        prompt, dec, extra = _serve_inputs(cfg, WHOLE_B)
        out[arch] = uneven._want_serve(
            ref, cfg, jcfg, trees[arch][0], prompt, dec, extra,
            model.init_cache(cfg, WHOLE_B, CACHE["data3"], device="cpu"),
            ref.model.init_cache(jcfg, WHOLE_B, CACHE["data3"]), 0)
    return out


# ---------------------------------------------------------------------------
# (i) the pod's loss and gradient
# ---------------------------------------------------------------------------

GRADS = [(w, a, r) for w in MESHES for a, r in GRAD_RUNS
         if a in ARCHS[w]]


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("which,arch,route", GRADS, ids=_id)
def test_grads_with_leaves_whole_match_one_device_and_reference(
        ranks, want_grads, want_ep, which, arch, route, remat):
    """The pod's loss on every rank and each gathered gradient leaf
    against the one-device port and ``jax.value_and_grad`` of the
    reference's ``loss_fn``; deepseek-lite's EP route against the port
    with the EP route's plain version where it applies (a data axis of
    3), and against the dense route's values where it does not (a model
    axis of 3 over 4 experts: the reference's rule)."""
    loss, grads, jloss, jgrads = want_grads[arch]
    results = ranks[which]
    losses = [r["grads"][arch, route, remat][0] for r in results]
    whole = [g.numpy() for g in results[0]["grads"][arch, route, remat][1]]
    assert len(set(losses)) == 1, losses
    names = uneven._names(_cfg(arch))
    cfg = _cfg(arch)
    mesh = MetaMesh(MESHES[which])
    if route == "ep" and moe_ep.ep_applicable_seq(
            cfg.moe, GRAD_B, TRAIN_T[arch], mesh):
        eloss, egrads = want_ep
        np.testing.assert_allclose(losses[0], eloss, rtol=0, atol=GRAD_TOL)
        uneven._leaf_close(whole, egrads, f"{arch} ep against the port",
                           names)
        return
    np.testing.assert_allclose(losses[0], loss, rtol=0, atol=GRAD_TOL)
    np.testing.assert_allclose(losses[0], jloss, rtol=0, atol=GRAD_TOL)
    uneven._leaf_close(whole, grads, f"{arch} against the port", names)
    uneven._leaf_close(whole, jgrads, f"{arch} against the reference", names)


@pytest.mark.parametrize("arch", ROWS_ARCHS)
def test_grads_with_the_sequences_whole_over_data_match_one_device(ranks,
                                                                   trees,
                                                                   arch):
    """2 sequences a pod on a data axis of 3, which the clamp keeps whole:
    every rank runs both, nothing summed over ``data`` (the loss, the
    gradients, deepseek's MoE capacity and aux over the pod's tokens
    once), the pod's loss and each gathered gradient leaf against the
    one-device port's."""
    cfg = _cfg(arch)
    nb = _train_batch(cfg, TRAIN_T[arch], ROWS_B)
    p = pytree.tree_map(lambda t: t.requires_grad_(),
                        model.lm_params_from_jax(trees[arch][0], "cpu"))
    loss, _ = model.loss_fn(p, cfg, uneven._torch_batch(nb))
    grads = [g.numpy() for g in torch.autograd.grad(loss, pytree.leaves(p))]
    results = ranks["data3"]
    losses = [r["grads"][arch, "rows"][0] for r in results]
    assert len(set(losses)) == 1, losses
    np.testing.assert_allclose(losses[0], float(loss.detach()), rtol=0,
                               atol=GRAD_TOL)
    uneven._leaf_close([g.numpy() for g in results[0]["grads"][arch, "rows"][
        1]], grads, f"{arch} rows whole", uneven._names(cfg))


# ---------------------------------------------------------------------------
# (ii) serving
# ---------------------------------------------------------------------------

def _serve_close(results, key, w, what, rows_of):
    """Every rank's prefill and decode logits (its rows) against the
    one-card serve and the reference's, its greedy tokens (every row)
    where the one-card logits' two largest lie ``TIE_GAP`` apart."""
    top2 = torch.topk(w["logits"], 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > TIE_GAP
    assert clear.float().mean() > 0.75, clear
    one = torch.argmax(w["logits"], dim=-1).to(torch.int32)
    for i, r in enumerate(results):
        pre, logits, toks = r["serve"][key]
        rows = rows_of(r, pre.shape[0])
        for got, a, b in ((pre, "prefill", "jprefill"),
                          (logits, "logits", "jlogits")):
            want_a = w[a][rows] if a == "prefill" else w[a][:, rows]
            want_b = w[b][rows] if b == "jprefill" else w[b][:, rows]
            uneven._close(got, want_a, f"{what} rank {i} {a} against the "
                          "port")
            uneven._close(got, want_b, f"{what} rank {i} {a} against the "
                          "reference")
        assert torch.equal(toks[clear], one[clear]), (what, i)
        assert torch.equal(toks[clear], w["jtoks"][clear]), (what, i)


def _rows(r, n):
    """The rows of the requests a rank's logits hold: its block over
    ``data``, or all of them."""
    if n == SERVE_B:
        return slice(0, SERVE_B)
    i = r["coords"]["data"]
    return slice(i * n, (i + 1) * n)


@pytest.mark.parametrize("which,arch,placement", SERVES, ids=_id)
def test_serve_with_leaves_whole(ranks, want_serve, which, arch, placement):
    """The prefill and every decode step: on (1, 1, 3) each rank running
    the whole block where the axis does not split it, the flash-decode
    cache's length of 64 whole on every rank; on (1, 3, 1) the requests
    and the cache length over ``data``, every weight whole."""
    _serve_close(ranks[which], (arch, placement), want_serve[arch],
                 f"{which} {arch} {placement}", _rows)


@pytest.mark.parametrize("arch", WHOLE_ARCHS)
def test_serve_of_requests_placed_over_data_it_does_not_split(
        ranks, want_whole, arch):
    """4 requests with ``batch_sharded=True`` on (1, 3, 1): the clamp keeps
    them whole, so every rank holds every request's cache (attention, the
    SSD or RG-LRU state and its conv history) and decodes all of them,
    nothing summed over ``data``; the prefill's and each decode step's
    logits against the one-card serve and the reference's, the greedy
    tokens equal to both."""
    for r in ranks["data3"]:
        assert r["serve"][arch, "whole"][0].shape[0] == WHOLE_B
    _serve_close(ranks["data3"], (arch, "whole"), want_whole[arch],
                 f"data3 {arch} {WHOLE_B} requests whole",
                 lambda r, n: slice(0, n))


def test_ranks_hold_their_coordinates(ranks):
    for which, shape in MESHES.items():
        want = [dict(zip(mesh_lib.AXES, map(int, np.unravel_index(i, shape))))
                for i in range(int(np.prod(shape)))]
        assert [r["coords"] for r in ranks[which]] == want


# ---------------------------------------------------------------------------
# (c) the exchanges on (2, 3, 1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", ["whole", "split"])
@pytest.mark.parametrize("strategy", EX_STRATEGIES)
def test_exchange_of_whole_and_split_leaves_matches_one_card(
        ranks, strategy, label):
    """Each exchanged leaf on every rank equals the one-card exchange's
    block bit for bit; the reduced qwen3 holds every 2-D leaf whole over
    ``data`` (DGC: one ``dgc_sparsify`` a local row of each leaf), the
    d_model-192 variant splits them (their thresholds from the summed
    ``abs_histogram``, ``dgc_select``)."""
    results = ranks["exchange"]
    for i, r in enumerate(results):
        assert r["exchange"][label, strategy], (i, label, strategy)
    axes = results[0]["axes"][label]
    n_split = sum(a is not None for a in axes)
    if label == "whole":
        assert n_split == 0, axes
    else:
        assert 0 < n_split < len(axes), axes
    if strategy == "dgc":
        rows = 1                                   # one pod a rank
        for r in results:
            calls = r["calls"][label, strategy]
            assert calls["dgc_sparsify"] == rows * (len(axes) - n_split)
            assert calls["abs_histogram"] == calls["dgc_select"] == \
                rows * n_split


def test_bsp_step_with_leaves_whole_matches_one_card(ranks):
    for i, r in enumerate(ranks["exchange"]):
        assert r["step"] <= intra.STEP_TOL, (i, r["step"])


# ---------------------------------------------------------------------------
# The gradient sums read the model code's rule of each block
# ---------------------------------------------------------------------------

def _runs_whole(cfg, path):
    """The model code's verdict on the block of the leaf at ``path`` under
    the active mesh: whether it runs whole over ``model``."""
    a, leaf = cfg.attention, path.rsplit("/mixer/", 1)[-1]
    if cfg.ssm is not None and leaf in ("A_log", "D", "dt_bias",
                                        "norm/scale", "conv_b"):
        return ssm._whole(cfg.ssm, cfg.d_model)
    if cfg.rglru is not None and leaf in ("conv_b", "lam", "w_a/b",
                                          "w_i/b"):
        return rglru._whole(cfg.rglru, cfg.d_model)
    assert leaf in ("q_norm/scale", "k_norm/scale", "kv_norm/scale"), path
    if a.kind == "mla":
        return attention._mla_whole(a)
    return block_whole(a.n_heads * a.head_dim)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_gradient_sums_follow_the_blocks_the_model_code_runs(arch,
                                                             reduced):
    """On model axes of 2, 3, 4, 8 and 16, every leaf whose gradient a
    block's ``model`` ranks each hold a part of (``block_splits``' verdict
    not None) is summed over ``model`` exactly where the model code runs
    its block split (the SSM's, the RG-LRU's, MLA's and GQA's own
    verdicts, through ``layers.block_whole``); every other leaf has no
    verdict."""
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    shape = steps.param_shape(cfg)
    for M in (2, 3, 4, 8, 16):
        mesh = MetaMesh((1, 2, M))
        verdicts = sharding.block_splits(shape, mesh)
        with activation_sharding(mesh):
            for (path, _), split in zip(pytree.leaves_with_paths(shape),
                                        verdicts):
                if split is not None:
                    assert split is not _runs_whole(cfg, path), (path, M)
                    assert sharding.grad_sync_axis(
                        path, (), mesh, block_split=split) == (
                            ("data", "model") if split else "data"), path


def test_a_partial_leaf_whose_block_has_no_exit_is_refused():
    """A leaf that acts on a rank's share of its block (qwen3's qk-norms)
    whose block's row-parallel exit is renamed (``wo`` to ``w_out``): its
    sum over ``model`` would be a guess, and ``block_splits`` raises,
    naming the leaf."""
    shape = steps.param_shape(_cfg(GQA))
    mixer = shape["body"][0]["mixer"]
    mixer["w_out"] = mixer.pop("wo")
    with pytest.raises(ValueError, match=r"mixer/[qk]_norm/scale"):
        sharding.block_splits(shape, MetaMesh((1, 1, 2)))
