"""The port's serve steps under a mesh on the CPU: gloo ranks started by
``repro_torch.launch.procs.spawn`` serve one site of a (1, D, M) mesh,
each rank holding its blocks of the parameters (FSDP over ``data``,
tensor and expert parallelism over ``model``), of the decode cache (the
reference's two placements: the attention caches' length over ``model``,
or with ``baseline_decode`` their KV heads; below 8 requests' batch, every
row's length over ``data``) and its rows of the batch.  Held against the
one-device port and the JAX reference on the same weights (the
reference's reduced ``init_model``, carried across by
``model.lm_params_from_jax``; JAX is imported by the ``ref`` fixture only:
the ranks import this file and need neither JAX nor ``repro``).

One spawn of four ranks, each on one thread, with a deadline
(``SPAWN_TIMEOUT``), runs every rank-side case (module-scoped fixture)
over the meshes of ``ARCHS``: the dense GQA archs (qwen3-0.6b, gemma2-9b
with its softcaps and sliding window, starcoder2-3b) and the MLA archs
(deepseek-v2-lite-16b and deepseek-v2-236b over MoE, minicpm3-4b with a
q_lora rank).  Each case: ``make_prefill_step`` on ``B`` prompts of
``T`` tokens (the MoE archs also with ``moe_route="ep"``), then
``DECODE`` teacher-forced steps of ``make_serve_step`` over a ring of
``CACHE`` slots (it wraps, so the ring's slot owner moves across the
ranks), under the four (``batch_sharded``, ``baseline_decode``) flags.

Tolerances, float32: the logits (prefill and every decode step) within
2e-5 x max(1, max|logits|) of the one-device port's and of the
reference's (``make_prefill_step``, ``decode_step``); the greedy tokens
(the vocabulary-parallel argmax) equal to the one-device and the
reference's ``make_serve_step`` tokens, where the one-device logits'
two largest lie ``TIE_GAP`` apart or more (checked: a flip cannot pass
unseen); the cache's blocks, gathered over the ranks, within the same
bound of the one-device cache, their positions equal; the EP route's
prefill against the one-device forward with ``moe_apply_ep_ref`` in the
MoE layers.  The refusals are checked on mesh descriptions (no process
group: a collective would raise, not a ``ValueError``).  The example:
``serve_decode --mesh 2,2 --procs 4 --reduced --device cpu`` against one
process, token for token.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
from _torch_layout import trace_layout
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro_torch import pytree
from repro_torch.configs.base import CommConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import procs, sharding, steps
from repro_torch.launch.mesh import AXES, Mesh, make_mesh
from repro_torch.models import model, moe, moe_ep
from repro_torch.models.layers import gated_mlp_apply

SPAWN_TIMEOUT = 300
TOL = 2e-5
TIE_GAP = 1e-4
B, T, DECODE, CACHE = 8, 16, 12, 8
GQA = ("qwen3-0.6b", "gemma2-9b", "starcoder2-3b")
MLA = ("deepseek-v2-lite-16b", "deepseek-v2-236b", "minicpm3-4b")
#: the mesh of each arch's cases (starcoder2's 2 KV heads do not split
#: over a model axis of 4)
ARCHS = {(1, 2, 2): GQA + MLA,
         (1, 1, 4): ("qwen3-0.6b", "gemma2-9b") + MLA}
#: (batch_sharded, baseline_decode)
PLACEMENTS = ((True, False), (True, True), (False, False), (False, True))
CASES = [(shape, arch, pl) for shape, archs in ARCHS.items()
         for arch in archs for pl in PLACEMENTS]
PREFILLS = [(shape, arch) for shape, archs in ARCHS.items() for arch in archs]
EP = [(shape, arch) for shape, arch in PREFILLS
      if get_config(arch).moe.n_experts]


def _id(x):
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], bool):
        return f"bs{int(x[0])}-base{int(x[1])}"
    if isinstance(x, tuple):
        return "x".join(map(str, x))
    return str(x)


def _cfg(arch):
    return get_config(arch).reduced()


def _tokens(vocab):
    rng = np.random.default_rng(21)
    return (torch.from_numpy(rng.integers(0, vocab, (B, T))),
            torch.from_numpy(rng.integers(0, vocab, (B, DECODE))))


def _step_batch(toks, t):
    return {"token": toks[:, t], "t": torch.full((B,), t, dtype=torch.int32)}


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _case(cfg, mesh, params, placement):
    """One case on this rank: the decode loop's logits (rows, whole
    vocabulary) and tokens (whole batch) at each step, and the cache
    gathered whole (on every rank; returned by the first)."""
    bs, base = placement
    _, dec = _tokens(cfg.vocab)
    cache = model.init_cache(cfg, B, CACHE, device="cpu", mesh=mesh,
                             batch_sharded=bs, baseline_decode=base)
    step = steps.make_serve_step(cfg, mesh=mesh, batch_sharded=bs,
                                 baseline_decode=base)
    logits, toks = [], []
    with torch.inference_mode():
        for t in range(DECODE):
            batch = _step_batch(dec, t)
            lg, cache = step.logits(params, cache, batch)
            # the same step again: it writes the same entries to the same
            # slots, so the cache is unchanged
            tok, cache = step(params, cache, batch)
            logits.append(lg)
            toks.append(tok)
    whole = model.init_cache(cfg, B, CACHE, device="meta")
    specs = pytree.leaves_like(sharding.cache_shardings(
        whole, mesh, batch_sharded=bs, baseline_decode=base), whole)
    gathered = [sharding.gather_leaf(t_, s_, mesh)
                for t_, s_ in zip(pytree.leaves(cache), specs)]
    return torch.stack(logits), torch.stack(toks), gathered


def _argmax_ties(mesh):
    """The vocabulary-parallel argmax on rows built with ties across the
    ranks' columns: (its tokens, ``torch.argmax`` of the gathered rows)."""
    M, i = mesh.size_of("model"), mesh.coords["model"]
    n = 6
    rows = torch.zeros(3, n)
    rows[1, 3] = 5.0 if i in (1, M - 1) else 1.0    # a tie on two ranks
    rows[2] = torch.arange(n) % 2 * 2.0              # ties inside every rank
    got = steps._vocab_argmax(rows, mesh)
    whole = mesh.all_gather_dim(rows, 1, "model")
    return got, torch.argmax(whole, dim=-1).to(torch.int32)


def _ranks(rank, dev, trees):
    torch.set_num_threads(1)
    out = {}
    for shape, archs in ARCHS.items():
        mesh = make_mesh(shape, device=dev)
        out[shape, "coords"] = mesh.coords
        out[shape, "ties"] = _argmax_ties(mesh)
        for arch in archs:
            cfg = _cfg(arch)
            whole = model.lm_params_from_jax(trees[arch], "cpu")
            params = sharding.local_params(whole, mesh)
            prompt, _ = _tokens(cfg.vocab)
            routes = moe.ROUTES if cfg.moe.n_experts else ("dense",)
            with torch.inference_mode():
                for route in routes:
                    out[shape, arch, route] = steps.make_prefill_step(
                        cfg, mesh=mesh, moe_route=route)(
                        params, {"tokens": prompt})
            for pl in PLACEMENTS:
                logits, toks, cache = _case(cfg, mesh, params, pl)
                out[shape, arch, pl] = (logits, toks,
                                        cache if rank == 0 else None)
    return out


# ---------------------------------------------------------------------------
# Fixtures: the reference, the one-device port, the spawn
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
    """Each arch's reference weights (``init_model`` at key 0), as NumPy."""
    out = {}
    for arch in GQA + MLA:
        jp = ref.model.init_model(ref.jax.random.PRNGKey(0),
                                  ref.get_config(arch).reduced())
        out[arch] = ref.jax.tree_util.tree_map(np.asarray, jp)
    return out


@pytest.fixture(scope="module")
def want(ref, trees):
    """Per arch: the one-device port's and the reference's prefill logits,
    decode logits and greedy tokens at each step, and the one-device
    port's cache after the loop."""
    out = {}
    jnp = ref.jnp
    for arch in GQA + MLA:
        cfg, jcfg = _cfg(arch), ref.get_config(arch).reduced()
        p = model.lm_params_from_jax(trees[arch], "cpu")
        jp = ref.jax.tree_util.tree_map(jnp.asarray, trees[arch])
        prompt, dec = _tokens(cfg.vocab)
        r = {"prefill": steps.make_prefill_step(cfg)(p, {"tokens": prompt}),
             "jprefill": torch.from_numpy(np.asarray(ref.jax.jit(
                 ref.steps.make_prefill_step(jcfg))(
                 jp, {"tokens": jnp.asarray(prompt.numpy())})))}
        cache = model.init_cache(cfg, B, CACHE, device="cpu")
        step = steps.make_serve_step(cfg)
        jcache = ref.model.init_cache(jcfg, B, CACHE)
        jscache = ref.model.init_cache(jcfg, B, CACHE)
        jdecode = ref.jax.jit(lambda p_, b_, c_: ref.model.decode_step(
            p_, jcfg, b_, c_))
        jserve = ref.jax.jit(ref.steps.make_serve_step(jcfg))
        logits, jlogits, toks, jtoks = [], [], [], []
        for t in range(DECODE):
            batch = _step_batch(dec, t)
            jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
            lg, cache = step.logits(p, cache, batch)
            logits.append(lg)
            toks.append(torch.argmax(lg, dim=-1).to(torch.int32))
            jl, jcache = jdecode(jp, jbatch, jcache)
            jlogits.append(torch.from_numpy(np.asarray(jl)))
            jt, jscache = jserve(jp, jscache, jbatch)
            jtoks.append(torch.from_numpy(np.asarray(jt)))
        r.update(logits=torch.stack(logits), jlogits=torch.stack(jlogits),
                 toks=torch.stack(toks), jtoks=torch.stack(jtoks),
                 cache=pytree.leaves(cache))
        out[arch] = r
    return out


@pytest.fixture(scope="module")
def ranks(trees):
    return procs.spawn(_ranks, 4, backend="gloo", device="cpu",
                       timeout=SPAWN_TIMEOUT, args=(trees,))


def _rows(results, shape, key, dim=0, pick=lambda v: v):
    """The ranks' rows of ``pick(results[key])`` stacked along ``dim`` in
    data order (model rank 0 of each data rank; its model peers hold the
    same, asserted)."""
    D, M = shape[1], shape[2]
    out = []
    for r in range(D):
        got = [pick(results[r * M + i][key]) for i in range(M)]
        for g in got[1:]:
            assert torch.equal(g, got[0]), key
        out.append(got[0])
    return torch.cat(out, dim=dim)


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = TOL * max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= bound, (what, err, bound)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,arch", PREFILLS, ids=lambda x: _id(x))
def test_prefill_matches_one_device_and_reference(ranks, want, shape, arch):
    got = _rows(ranks, shape, (shape, arch, "dense"))
    _close(got, want[arch]["prefill"], f"{arch} against the port")
    _close(got, want[arch]["jprefill"], f"{arch} against the reference")


@pytest.mark.parametrize("shape,arch", EP, ids=lambda x: _id(x))
def test_ep_prefill_matches_the_plain_ep_route(ranks, trees, monkeypatch,
                                               shape, arch):
    """``moe_route="ep"``: the prefill's logits against the one-device
    forward whose MoE layers run ``moe_apply_ep_ref`` over the mesh's D x
    M shards, plus the shared experts."""
    cfg = _cfg(arch)
    p = model.lm_params_from_jax(trees[arch], "cpu")
    D, M = shape[1], shape[2]

    def ep_ref(p_, m_, x, route="dense"):
        y, aux = moe_ep.moe_apply_ep_ref(p_, m_, x, D, M)
        if "shared" in p_:
            y = y + gated_mlp_apply(p_["shared"], x)
        return y, aux
    monkeypatch.setattr(moe, "moe_apply", ep_ref)
    prompt, _ = _tokens(cfg.vocab)
    plain = steps.make_prefill_step(cfg)(p, {"tokens": prompt})
    _close(_rows(ranks, shape, (shape, arch, "ep")), plain,
           f"{arch} EP route")


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,arch,placement", CASES, ids=_id)
def test_decode_logits_match_one_device_and_reference(ranks, want, shape,
                                                      arch, placement):
    got = _rows(ranks, shape, (shape, arch, placement), dim=1,
                pick=lambda v: v[0])
    _close(got, want[arch]["logits"], f"{arch} against the port")
    _close(got, want[arch]["jlogits"], f"{arch} against the reference")


@pytest.mark.parametrize("shape,arch,placement", CASES, ids=_id)
def test_greedy_tokens_match(ranks, want, shape, arch, placement):
    """Every rank returns the whole batch's tokens: the vocabulary-parallel
    argmax equals the one-device argmax and the reference's serve step
    where the top two logits are ``TIE_GAP`` apart (all of them here)."""
    top2 = torch.topk(want[arch]["logits"], 2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > TIE_GAP
    for r in ranks:
        toks = r[shape, arch, placement][1]
        assert torch.equal(toks, want[arch]["toks"])
        assert torch.equal(toks, want[arch]["jtoks"])


@pytest.mark.parametrize("shape,arch,placement", CASES, ids=_id)
def test_cache_blocks_gathered_match_one_device(ranks, want, shape, arch,
                                                placement):
    got = ranks[0][shape, arch, placement][2]
    assert len(got) == len(want[arch]["cache"])
    for i, (g, w) in enumerate(zip(got, want[arch]["cache"])):
        if w.dtype == torch.int32:
            assert torch.equal(g, w), (arch, i)
        else:
            _close(g, w, f"{arch} cache leaf {i}")


@pytest.mark.parametrize("shape", list(ARCHS), ids=_id)
def test_vocab_argmax_breaks_ties_as_torch_argmax(ranks, shape):
    for r in ranks:
        got, want_ = r[shape, "ties"]
        assert torch.equal(got, want_), (got, want_)


def test_ranks_hold_their_coordinates(ranks):
    for shape in ARCHS:
        want_ = [dict(zip(AXES, map(int, np.unravel_index(i, shape))))
                 for i in range(4)]
        assert [r[shape, "coords"] for r in ranks] == want_


# ---------------------------------------------------------------------------
# Refusals, on mesh descriptions (no process group)
# ---------------------------------------------------------------------------

#: the SSM, RG-LRU, enc-dec and VLM families at full width, each on a mesh
#: one of its widths does not split: the dimension, and the leaf (path
#: suffix, dimension from the end) the clamp keeps whole
OTHER = {"mamba2-780m": ((1, 1, 32), "ssm in_proj width", "mixer/in_proj/w",
                         -1),
         "recurrentgemma-2b": ((1, 1, 3), "lru_width", "mixer/in_x/w", -1),
         "seamless-m4t-large-v2": ((1, 3, 1), "feat_dim",
                                   "encoder/in_proj/w", -2),
         "phi-3-vision-4.2b": ((1, 3, 1), "feat_dim", "projector/w", -2)}


def _whole_in_specs(cfg, mesh, suffix, dim):
    """Whether every leaf of ``cfg`` whose path ends in ``suffix`` keeps
    its dimension ``dim`` (from the end) whole on ``mesh``, as
    ``leaf_specs`` places it, where its rule names an axis."""
    shapes = steps.param_shape(cfg)
    got = []
    for (p_, t_), spec in zip(pytree.leaves_with_paths(shapes),
                              sharding.leaf_specs(shapes, mesh)):
        if not p_.endswith(suffix):
            continue
        lead = 1 if {"body", "layers"} & set(p_.split("/")) else 0
        rule = (None,) * lead + sharding.rule_spec(
            p_, tuple(t_.shape)[lead:])
        got.append((rule + (None,) * (t_.dim() - len(rule)), spec))
    return bool(got) and all(rule[dim] is not None and spec[dim] is None
                             for rule, spec in got)


@pytest.mark.parametrize("arch", list(OTHER))
@pytest.mark.parametrize("mode", ["train", "serve"])
def test_other_families_are_refused_naming_a11c(arch, mode):
    """Every family is placed inside a pod (``test_torch_intrapod_
    families.py``), also where an axis does not split one of its widths
    (ROADMAP A11e, closed here): mamba2's in_proj width of 6,448 (and its
    48 heads) on 32 model ranks, recurrentgemma's lru_width of 2,560 on
    3, seamless' and phi-3-vision's 1024 frontend features (the encoder's
    ``in_proj`` and the projector's rows) on 3 data ranks are whole on
    every rank of the axis, the steps of ``mode`` traced on the mesh's
    last rank (``_torch_layout``; ``tests/test_torch_clamp.py`` runs such
    leaves against one device and the reference)."""
    shape, _, suffix, dim = OTHER[arch]
    cfg, mesh = get_config(arch), Mesh(shape, AXES)
    trace_layout(cfg, shape, mode)
    assert _whole_in_specs(cfg, mesh, suffix, dim)


@pytest.mark.parametrize("arch", MLA)
def test_mla_and_moe_training_is_taken(arch):
    """The MLA family, with or without MoE experts, is placed for training
    as for serving (``tests/test_torch_intrapod_moe.py`` trains it)."""
    mesh = Mesh((1, 2, 2), AXES)
    for mode in ("serve", "train"):
        trace_layout(_cfg(arch), (1, 2, 2), mode)
    for route in moe.ROUTES:
        step = steps.make_train_step(_cfg(arch), CommConfig(strategy="bsp"),
                                     mesh=mesh, moe_route=route)
        assert callable(step.pod_grads)


#: 3 KV heads (of 12 query heads) on a model axis of 4: wider than
#: n_kv_heads, not a multiple of it
KV3 = "starcoder2-3b@kv3"


def _layout_cfg(arch):
    if arch != KV3:
        return _cfg(arch)
    cfg = _cfg("starcoder2-3b")
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, n_heads=12, n_kv_heads=3))


@pytest.mark.parametrize("arch,shape,what,suffix,dim", [
    (KV3, (1, 1, 4), "n_kv_heads", "/k", -2),
    ("deepseek-v2-lite-16b", (1, 1, 8), "n_experts", "ffn/w_gate", -3),
    ("deepseek-v2-lite-16b", (1, 1, 3), "kv_lora_rank", "mixer/wdkv/w", -1),
    ("minicpm3-4b", (1, 3, 1), "q_lora_rank", "mixer/wuq/w", -2),
    ("qwen3-0.6b", (1, 3, 1), "d_model", "embed/table", -1)], ids=_id)
def test_axes_that_do_not_divide_are_refused(arch, shape, what, suffix,
                                             dim):
    """Widths an axis does not divide are taken to serve (they were
    refused until ROADMAP A11e closed): the dimension ``what`` of the
    leaf at ``suffix`` is whole on every rank of its axis; for 3 KV heads
    on 4 model ranks, the heads placement's cache keeps them whole."""
    cfg, mesh = _layout_cfg(arch), Mesh(shape, AXES)
    trace_layout(cfg, shape, "serve")
    if suffix != "/k":
        assert _whole_in_specs(cfg, mesh, suffix, dim), what
        return
    whole = model.init_cache(cfg, B, CACHE, device="meta")
    specs = [s_ for (p_, _), s_ in zip(pytree.leaves_with_paths(whole),
             pytree.leaves_like(sharding.cache_shardings(
                 whole, mesh, batch_sharded=True, baseline_decode=True),
                 whole)) if p_.endswith(suffix)]
    assert specs and all(s_[dim] is None for s_ in specs), what


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-lite-16b"])
def test_full_width_serving_layouts_are_taken(arch):
    """The full widths on the meshes the card runs, and the reference's
    production (16, 16) for deepseek's 16 heads and 64 experts."""
    cfg = get_config(arch)
    for shape in ((1, 2, 2), (1, 1, 4)):
        trace_layout(cfg, shape, "serve")
    if arch != "qwen3-0.6b":
        trace_layout(cfg, (1, 16, 16), "serve")


def test_serving_takes_one_pod():
    with pytest.raises(ValueError, match="one decentralized site"):
        steps.make_prefill_step(_cfg("qwen3-0.6b"),
                                mesh=Mesh((2, 1, 2), AXES))


def test_a_batch_the_data_axis_does_not_split_is_refused():
    """Three requests on a data axis of 2, placed over it: the clamp keeps
    them whole, so every rank's cache block holds all three (its length
    still over ``model``), as it holds them where they are placed whole
    (``batch_sharded=False``, ``tests/test_torch_uneven.py``)."""
    cfg = _cfg("qwen3-0.6b")
    mesh = Mesh((1, 2, 2), AXES)
    cache = model.init_cache(cfg, 3, CACHE, device="cpu", mesh=mesh,
                             batch_sharded=True)
    for path, t in pytree.leaves_with_paths(cache):
        off = 1 if path.startswith("body") else 0
        assert t.shape[off] == 3, (path, tuple(t.shape))
        if path.endswith("/k"):
            assert t.shape[off + 1] == CACHE // 2, (path, tuple(t.shape))


@pytest.mark.parametrize("made,used", [
    ((True, False), (True, True)), ((True, True), (False, False)),
    ((False, False), (True, False))], ids=_id)
def test_a_cache_of_another_placement_is_refused(made, used):
    cfg = _cfg("deepseek-v2-lite-16b" if made[1] else "qwen3-0.6b")
    mesh = Mesh((1, 2, 2), AXES)
    p = sharding.local_params(model.init_model(
        torch.Generator().manual_seed(0), cfg, "cpu"), mesh)
    cache = model.init_cache(cfg, B, CACHE, device="cpu", mesh=mesh,
                             batch_sharded=made[0], baseline_decode=made[1])
    step = steps.make_serve_step(cfg, mesh=mesh, batch_sharded=used[0],
                                 baseline_decode=used[1])
    with pytest.raises(ValueError, match="cache block"):
        step(p, cache, _step_batch(_tokens(cfg.vocab)[1], 0))


def test_a_length_the_axis_does_not_split_is_refused():
    """A flash-decode cache length of 6 on 4 model ranks: the clamp keeps
    it whole, so every rank holds every slot beside the whole ``pos``
    (the decode then combines nothing over ``model``:
    ``attention._length_split``); a length the whole-batch placement puts
    over a data axis that does not split it is refused, named (ROADMAP
    A11e)."""
    cache = model.init_cache(_cfg("qwen3-0.6b"), B, 6, device="cpu",
                             mesh=Mesh((1, 1, 4), AXES))
    for path, t in pytree.leaves_with_paths(cache):
        off = 1 if path.startswith("body") else 0
        if path.endswith(("/k", "/pos")):
            assert t.shape[off + 1] == 6, (path, tuple(t.shape))
    with pytest.raises(ValueError, match="cache length=6 over data=4"):
        model.init_cache(_cfg("qwen3-0.6b"), 2, 6, device="cpu",
                         mesh=Mesh((1, 4, 1), AXES), batch_sharded=False)


def test_the_flags_pick_the_cache_split():
    mesh = Mesh((1, 2, 2), AXES)
    split = lambda bs, base: sharding.cache_split(
        mesh, batch_sharded=bs, baseline_decode=base)
    assert [split(*pl) for pl in PLACEMENTS] == ["model", None, "data",
                                                 "data"]
    assert sharding.cache_split(None, batch_sharded=True,
                                baseline_decode=False) is None


# ---------------------------------------------------------------------------
# The example
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,route", [("qwen3-0.6b", "dense"),
                                        ("deepseek-v2-lite-16b", "ep")])
def test_example_mesh_matches_one_process(arch, route):
    from repro_torch.examples import serve_decode as ex
    argv = ["--device", "cpu", "--reduced", "--arch", arch, "--batch", "8",
            "--prompt-len", "6", "--gen-len", "6", "--cache-len", "16",
            "--moe-route", route]
    one = ex.run(ex.parse_args(argv))
    run = ex.run(ex.parse_args(argv + ["--mesh", "2,2", "--procs", "4"]))
    assert run["ranks"] == 4 and one["ranks"] == 1
    assert torch.equal(run["tokens"], one["tokens"])
    with pytest.raises(ValueError, match="holds 4 ranks"):
        ex.mesh_shape(ex.parse_args(argv + ["--mesh", "2,2", "--procs",
                                            "2"]))
    assert dataclasses.is_dataclass(run["cfg"])
