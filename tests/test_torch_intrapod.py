"""The port's intra-pod axes on the CPU: gloo ranks started by
``repro_torch.launch.procs.spawn``, a pod split over a ``data`` x ``model``
grid of ranks (FSDP over ``data``, tensor parallelism over ``model``),
against the one-device port and the JAX reference (imported by the
``ref`` fixture only: the ranks import this file and need no JAX).

Three spawns, each rank on one thread (``torch.set_num_threads(1)``), run
every rank-side check once (module-scoped fixtures, as in
``test_torch_dist.py``); the parametrized tests read their results:
- four ranks: (i) the loss and gradient of the reduced qwen3-0.6b,
  gemma2-9b and starcoder2-3b on mesh (1, 2, 2), also with the backward
  (and the checkpointed cycles' recompute) on another thread; (ii) one
  step and the exchange of each of the six strategies on (2, 2, 1) and
  (2, 1, 2); (iii) a checkpoint on (2, 2, 1); (iv) the refusals;
- eight ranks: (ii) and (iii) on (2, 2, 2);
- (v) the training example with ``--mesh 2,2,1 --procs 4``.
Every spawn has a deadline (``SPAWN_TIMEOUT``).

Tolerances (float32 unless a case says bfloat16):
- the pod's loss and each gathered gradient leaf against the one-device
  port's and against ``jax.value_and_grad`` of the reference's
  ``loss_fn`` on the same weights: within 2e-5 x max(1, max|leaf|) (the
  North star's float32 bound);
- the exchange on one set of inputs, each rank's blocks against the
  one-card exchange's: bit for bit for all six (two pods: each cross-pod
  sum is one addition; DGC's histogram is summed in integers; the gossip
  mixes the same rows), float32 and bfloat16;
- one whole step, each rank's blocks of params, vel, acc and the
  snapshots against the one-card step's: relative L2 within 1e-5 (the
  sharded sums run in another order); the metrics within 1e-6 relative;
- the checkpoint: the mesh's files equal, array for array and the meta's
  bytes, the one-card checkpoint of the gathered state; the reference's
  ``repro.checkpointing.restore`` reads them; each rank restores its own
  blocks bit for bit;
- the example: the losses within 1e-5 of one process's.
"""
import dataclasses
import os
import threading
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from _torch_layout import trace_layout
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro_torch import checkpointing as ckpt
from repro_torch import pytree
from repro_torch.configs.base import CommConfig, FabricConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import procs, sharding, steps
from repro_torch.models import model
from repro_torch.models.shard_hints import activation_sharding
from repro_torch.topology.graphs import build_demo_schedule

SPAWN_TIMEOUT = 240
GRAD_TOL = 2e-5
STEP_TOL = 1e-5
LOSS_TOL = 1e-6
EXAMPLE_TOL = 1e-5
#: the dense GQA archs and the sequence length of their case (gemma2 and
#: starcoder2 past their reduced window of 64)
DENSE = {"qwen3-0.6b": 24, "gemma2-9b": 96, "starcoder2-3b": 96}
GRAD_MESH = (1, 2, 2)
FOUR = ((2, 2, 1), (2, 1, 2))
EIGHT = (2, 2, 2)
MESHES = FOUR + (EIGHT,)
N_PODS, STEP_B, STEP_T, LR = 2, 2, 16, 1e-2
STRATEGIES = steps.STRATEGIES
COMM = {"bsp": {}, "gaia": {"gaia_t0": 0.05}, "fedavg": {"iter_local": 2},
        "dgc": {"dgc_sparsity": 0.95}, "dpsgd": {},
        "adpsgd": {"max_staleness": 2}}
STALENESS = 1
CKPT_STRATEGY = "gaia"
#: collectives (and group creation) the refusals must not reach
COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "all_gather_single",
               "all_to_all_single", "all_gather", "reduce_scatter_tensor",
               "reduce_scatter_single", "gather", "broadcast", "barrier",
               "new_group")


def _id(shape):
    return "x".join(map(str, shape))


def _comm(strategy):
    return CommConfig(strategy=strategy, fabric=FabricConfig(topology="ring"),
                      **COMM[strategy])


def _cfg(arch="qwen3-0.6b", dtype="float32"):
    return dataclasses.replace(get_config(arch).reduced(), dtype=dtype)


def _mix(comm, mesh=None):
    if comm.strategy not in steps.GOSSIP_STRATEGIES:
        return {}
    kw = ({"staleness": STALENESS, "max_staleness": comm.max_staleness}
          if comm.strategy == "adpsgd" else {})
    return {"mix": steps.gossip_operands(build_demo_schedule("ring", N_PODS),
                                         0, device="cpu", mesh=mesh, **kw)}


def _batch(vocab, seed=100):
    seqs = torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (N_PODS, STEP_B, STEP_T + 1)))
    return {"tokens": seqs[..., :-1], "labels": seqs[..., 1:]}


def _compare(got, want):
    """(bit for bit, relative L2) over pairs of tensors."""
    same, num, den = True, 0.0, 0.0
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
        same = same and torch.equal(g, w)
        d = g.double() - w.double()
        num += float(d.square().sum())
        den += float(w.double().square().sum())
    return same, (num / max(den, 1e-300)) ** 0.5


def _snap_blocks(snaps, like, specs, mesh):
    """The rank's layout of one-card snapshot buffers: each dtype group's
    (S + 1, n_pods, N) buffer cut back into its (full) leaves ``like``,
    each leaf's rows and blocks taken (``specs``, the unstacked leaves'),
    and laid side by side again."""
    rows = steps.local_pods(N_PODS, mesh)
    out = {}
    for dt, idx in steps.dtype_groups(like).items():
        buf = snaps[pytree.dtype_name(dt)][:, rows.start:rows.stop]
        parts = buf.split([like[i].numel() for i in idx], dim=2)
        out[pytree.dtype_name(dt)] = torch.cat([
            sharding.local_block(p.reshape(p.shape[:2] + like[i].shape),
                                 (None, None) + tuple(specs[i]), mesh
                                 ).reshape(p.shape[0], p.shape[1], -1)
            for p, i in zip(parts, idx)], dim=2)
    return out


def _blocks(parts, specs, mesh, like):
    """The rank's blocks of an exchange's parts or a state: each leaf's
    pods and blocks by its stacked spec; the snapshot buffers by
    ``_snap_blocks``."""
    rows = steps.local_pods(N_PODS, mesh)
    out = {}
    for k, v in parts.items():
        if k == "snaps":
            out[k] = _snap_blocks(v, like, specs, mesh)
            continue
        leaves = v if isinstance(v, list) else pytree.leaves(v)
        out[k] = [sharding.local_block(t[rows.start:rows.stop],
                                       (None,) + tuple(s), mesh)
                  .contiguous() for t, s in zip(leaves, specs)]
    return out


def _exchange_inputs(strategy, cfg, seed):
    """Every pod's exchange inputs from one seed: stacked leaves of the
    reduced qwen3's shapes and dtypes."""
    rng = np.random.default_rng(seed)
    like = pytree.leaves(model.init_model(torch.Generator().manual_seed(0),
                                          cfg, "cpu"))

    def draw(scale, dtype=None):
        return [torch.from_numpy(rng.standard_normal(
            (N_PODS,) + tuple(t.shape)).astype(np.float32) * scale).to(
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
                (S1, N_PODS, sum(like[i].numel() for i in idx))
            ).astype(np.float32) * 0.1).to(dt)
            for dt, idx in steps.dtype_groups(like).items()}
    return parts


class _Recorder:
    """``torch.distributed``'s collectives and ``new_group`` wrapped: the
    names of the calls made inside."""

    def __init__(self):
        self.calls, self.saved = [], {}

    def __enter__(self):
        for name in COLLECTIVES:
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            self.saved[name] = fn

            def counted(*args, _fn=fn, _name=name, **kw):
                self.calls.append(_name)
                return _fn(*args, **kw)
            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(dist, name, fn)


def _refused(fn):
    """(the ValueError's text or None, the collectives ``fn`` reached)."""
    with _Recorder() as rec:
        try:
            fn()
        except ValueError as e:
            return str(e), rec.calls
    return None, rec.calls


def _lru_width(width):
    cfg = get_config("recurrentgemma-2b").reduced()
    return dataclasses.replace(cfg, rglru=dataclasses.replace(
        cfg.rglru, lru_width=width))


def _encoder_width(width):
    cfg = get_config("seamless-m4t-large-v2").reduced()
    return dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, d_model=width))


def _ssm_heads(heads, head_dim, d_model):
    cfg = get_config("mamba2-780m").reduced()
    return dataclasses.replace(cfg, d_model=d_model, ssm=dataclasses.replace(
        cfg.ssm, n_heads=heads, head_dim=head_dim))


#: configs each with a width the axes do not split, which the clamp keeps
#: whole on every rank of the axis (refused until ROADMAP A11e closed):
#: the RG-LRU's width of 255 (over ``model``, and over ``data`` for the
#: gates' rows), the encoder's d_model of 255 (both axes), an SSM of 3
#: heads (its in_proj width of 1,571 over ``model``), 3 KV heads (the
#: heads placement's cache over ``model``) and a d_model of 255
BAD = {"rglru": lambda: _lru_width(255),
       "encdec": lambda: _encoder_width(255),
       "ssm": lambda: _ssm_heads(3, 256, 384),
       "kv_heads": lambda: dataclasses.replace(_cfg(), attention=dataclasses.
                                               replace(_cfg().attention,
                                                       n_heads=6,
                                                       n_kv_heads=3)),
       "d_model": lambda: dataclasses.replace(_cfg(), d_model=255)}
#: the dimension of each case the axes do not split
NAMED = {"rglru": "lru_width", "encdec": "encoder d_model",
         "ssm": "ssm n_heads", "kv_heads": "n_kv_heads",
         "d_model": "d_model"}
#: the leaves (path suffix, dimension from the end) each case's clamp
#: keeps whole, where the rule puts an axis above one rank there; "/k":
#: the heads placement's decode cache
WHOLE = {"rglru": (("mixer/w_a/w", -2), ("mixer/w_a/w", -1)),
         "encdec": (("encoder/in_proj/w", -1), ("encoder/layers/wq/w", -2)),
         "ssm": (("mixer/in_proj/w", -1),),
         "kv_heads": (("/k", -2),),
         "d_model": (("embed/table", -1),)}


def _clamped_whole(cfg, mesh, case):
    """Whether each of ``WHOLE[case]``'s dimensions is whole (None) where
    its leaf's rule (``rule_spec``, or the cache's heads over ``model``)
    names an axis above one rank of ``mesh``; and how many were held."""
    n = 0
    for suffix, dim in WHOLE[case]:
        if suffix == "/k":
            tree = model.init_cache(cfg, 2, 8, device="meta")
            specs = sharding.cache_shardings(tree, mesh, batch_sharded=True,
                                             baseline_decode=True)
            rules = [(None,) * (t_.dim() - 2) + ("model", None)
                     for t_ in pytree.leaves(tree)]
        else:
            tree = steps.param_shape(cfg)
            specs = sharding.param_shardings(tree, mesh)
            rules = []
            for p_, t_ in pytree.leaves_with_paths(tree):
                lead = 1 if {"body", "layers"} & set(p_.split("/")) else 0
                r_ = sharding.rule_spec(p_, tuple(t_.shape)[lead:])
                rules.append(r_ + (None,) * (t_.dim() - lead - len(r_)))
        for (p_, _), rule, spec in zip(pytree.leaves_with_paths(tree), rules,
                                       pytree.leaves_like(specs, tree)):
            if not p_.endswith(suffix):
                continue
            ax = rule[dim]
            if ax and mesh.size_of(ax) > 1:
                if spec[dim] is not None:
                    return False, n
                n += 1
    return True, n


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _pod_grads(cfg, mesh, p, nb):
    """The pod's loss and its gathered gradient leaves by ``mesh``'s ranks
    (the train step's ``pod_grads`` on one pod), with the rank's state and
    batch rows (for the thread check)."""
    comm = CommConfig(strategy="bsp")
    state = steps.make_train_state(p, comm, 1, mesh=mesh)
    step = steps.make_train_step(cfg, comm, mesh=mesh)
    batch = {k: torch.from_numpy(v).long()[None] for k, v in nb.items()}
    specs_ = sharding.batch_shardings(batch, mesh, pod_stacked=True)
    mine = {k: sharding.local_block(v, specs_[k], mesh)
            for k, v in batch.items()}
    losses, grads = step.pod_grads(state["params"], mine)
    specs = pytree.leaves_like(sharding.train_state_shardings(
        steps.train_state_shape(cfg, comm, 1), mesh)["params"],
        state["params"])
    whole = [sharding.gather_leaf(g, s, mesh)[0]
             for g, s in zip(grads, specs)]
    return float(losses[0]), whole, state, mine


def _thread_grads(cfg, mesh, state, mine):
    """The rank's raw gradient twice: the backward on this thread, and on
    another thread (which does not inherit ``activation_sharding``; the
    checkpointed cycles re-enter it in their recompute).  Bit for bit."""
    def value():
        leaves = [t[0].detach().requires_grad_()
                  for t in pytree.leaves(state["params"])]
        with activation_sharding(mesh):
            loss, _ = model.loss_fn(pytree.unflatten(state["params"],
                                                     leaves), cfg,
                                    {k: v[0] for k, v in mine.items()},
                                    remat=True)
        return loss, leaves
    loss, leaves = value()
    here = torch.autograd.grad(loss, leaves)
    loss, leaves = value()
    box = []
    t = threading.Thread(target=lambda: box.append(
        torch.autograd.grad(loss, leaves)))
    t.start()
    t.join()
    return len(box) == 1 and all(torch.equal(a, b)
                                 for a, b in zip(here, box[0]))


def _mesh_checks(mesh, dev, out_dir):
    """(ii) one step and the exchange of each strategy on ``mesh``, each
    against the one-card route this rank runs itself; (iii) a checkpoint
    of the gaia state."""
    cfg = _cfg()
    p = model.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    specs = sharding.leaf_specs(p, mesh)
    like_bf16 = pytree.leaves(model.init_model(
        torch.Generator().manual_seed(0), _cfg(dtype="bfloat16"), "cpu"))
    res = {"exchange": {}, "step": {}}
    for strategy in STRATEGIES:
        comm = _comm(strategy)
        for dtype in ("float32", "bfloat16"):
            full = _exchange_inputs(strategy, _cfg(dtype=dtype), seed=7)
            like = pytree.leaves(p) if dtype == "float32" else like_bf16
            want = steps.make_exchange(comm, lr=LR)(full, step_idx=1,
                                                    **_mix(comm))
            got = steps.make_exchange(comm, mesh=mesh, lr=LR, specs=specs)(
                _blocks(full, specs, mesh, like), step_idx=1,
                **_mix(comm, mesh))
            res["exchange"][strategy, dtype] = _compare(
                pytree.leaves(got),
                pytree.leaves(_blocks(want, specs, mesh, like)))[0]
        batch = _batch(cfg.vocab)
        one, m_one = steps.make_train_step(cfg, comm, lr=LR)(
            steps.make_train_state(p, comm, N_PODS), batch, 1, **_mix(comm))
        state = steps.make_train_state(p, comm, N_PODS, mesh=mesh)
        mine, m_mine = steps.make_train_step(cfg, comm, mesh=mesh, lr=LR)(
            state, batch, 1, **_mix(comm, mesh))
        _, l2 = _compare(pytree.leaves(mine), pytree.leaves(
            _blocks(one, specs, mesh, pytree.leaves(p))))
        err = max(abs(float(m_mine[k]) - float(m_one[k])) /
                  max(abs(float(m_one[k])), 1e-30) for k in m_one)
        res["step"][strategy] = (l2, err, sorted(m_one) == sorted(m_mine))
        if strategy == CKPT_STRATEGY:
            res["ckpt"] = _checkpoint(cfg, comm, mesh, mine, out_dir)
    return res


def _checkpoint(cfg, comm, mesh, state, out_dir):
    """(iii) ``state`` (params, vel, acc) saved on the mesh, and by the
    first rank the one-card checkpoint of the same state gathered whole;
    each rank's restore of its blocks against its state."""
    state = {k: state[k] for k in ("params", "vel", "acc")}
    specs = sharding.train_state_shardings(
        steps.train_state_shape(cfg, comm, N_PODS), mesh)
    specs = {k: specs[k] for k in state}
    path = os.path.join(out_dir, _id(tuple(mesh.shape.values())))
    ckpt.save(os.path.join(path, "mesh"), state, step=1, mesh=mesh,
              specs=specs)
    whole = [sharding.gather_leaf(t, s, mesh) for t, s in zip(
        pytree.leaves(state), pytree.leaves_like(specs, state))]
    # the pods: every rank of the pod group gathers the rows (all ranks
    # take part; the first writes)
    whole = [mesh.all_gather(t.contiguous()) for t in whole]
    if dist.get_rank() == 0:
        ckpt.save(os.path.join(path, "one_card"),
                  pytree.unflatten(state, whole), step=1)
    back = ckpt.restore(os.path.join(path, "mesh"),
                        pytree.tree_map(torch.empty_like, state), step=1,
                        mesh=mesh, specs=specs)
    dist.barrier()
    return all(torch.equal(a, b) for a, b in zip(pytree.leaves(back),
                                                  pytree.leaves(state)))


def _prefill_gap(cfg, mesh):
    """The largest gap between the prefill's logits of ``cfg`` (seeded
    weights, four requests of ``STEP_T`` tokens, the enc-dec's frames) on
    ``mesh``'s ranks, each its rows, and one device's, over max(1,
    max|logits|)."""
    p = model.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.default_rng(101)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (4, STEP_T)))}
    if cfg.encoder is not None:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (4, cfg.encoder.n_frames, cfg.modality.feat_dim)).astype(
            np.float32))
    with torch.inference_mode():
        one = steps.make_prefill_step(cfg)(p, batch)
        got = steps.make_prefill_step(cfg, mesh=mesh)(
            sharding.local_params(p, mesh), batch)
    n = got.shape[0]
    i = mesh.coords["data"] if n < one.shape[0] else 0
    return float((got - one[i * n:(i + 1) * n]).abs().max()
                 / max(1.0, float(one.abs().max())))


def _four_ranks(rank, dev, cases, out_dir):
    torch.set_num_threads(1)
    res = {"refused": {}, "grads": {}, "meshes": {}}
    # (iv) what was refused: each case's prefill against one device, and
    # its train step made before any collective
    grad_mesh = mesh_lib.make_mesh(GRAD_MESH, device=dev)
    res["coords"] = grad_mesh.coords
    res["prefill_gap"] = {}
    for name, make in BAD.items():
        res["refused"][name, "make_mesh"] = _refused(
            lambda name=name, make=make: res["prefill_gap"].__setitem__(
                name, _prefill_gap(make(), grad_mesh)))
    for name, make in BAD.items():
        res["refused"][name, "make_train_step"] = _refused(
            lambda make=make: steps.make_train_step(
                make(), CommConfig(strategy="bsp"), mesh=grad_mesh))
    # a pod's sequences that do not split over data
    cfg = _cfg()
    p = model.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    comm = CommConfig(strategy="bsp")
    odd = {k: v[:1, :1] for k, v in _batch(cfg.vocab).items()}
    res["refused"]["batch", "train_step"] = _refused(
        lambda: steps.make_train_step(cfg, comm, mesh=grad_mesh)(
            steps.make_train_state(p, comm, 1, mesh=grad_mesh), odd, 0))
    # (i) the pod's loss and gradient, and the backward on another thread
    for arch, (tree, nb) in cases.items():
        cfg = _cfg(arch)
        params = model.lm_params_from_jax(tree, "cpu")
        loss, whole, state, mine = _pod_grads(cfg, grad_mesh, params, nb)
        res["grads"][arch] = (loss, whole if rank == 0 else None)
        if arch == "qwen3-0.6b":
            res["thread"] = _thread_grads(cfg, grad_mesh, state, mine)
    # (ii), (iii)
    for shape in FOUR:
        res["meshes"][shape] = _mesh_checks(
            mesh_lib.make_mesh(shape, device=dev), dev, out_dir)
    return res


def _eight_ranks(rank, dev, out_dir):
    torch.set_num_threads(1)
    mesh = mesh_lib.make_mesh(EIGHT, device=dev)
    return {"coords": mesh.coords,
            "meshes": {EIGHT: _mesh_checks(mesh, dev, out_dir)}}


# ---------------------------------------------------------------------------
# Fixtures: the parent's reference values and the spawns
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    """The JAX reference, imported here only (the ranks import this file
    and need neither JAX nor ``repro``)."""
    import jax
    import jax.numpy as jnp
    from repro import checkpointing as jax_ckpt
    from repro.configs.registry import get_config as jax_get_config
    from repro.models import model as jax_model
    return types.SimpleNamespace(jax=jax, jnp=jnp, ckpt=jax_ckpt,
                                 get_config=jax_get_config, model=jax_model)


@pytest.fixture(scope="module")
def cases(ref):
    """For each dense arch: the reference's reduced weights (NumPy) and a
    batch with labels, a sixth of them -1."""
    out = {}
    for arch, T in DENSE.items():
        jp = ref.model.init_model(ref.jax.random.PRNGKey(0),
                                  ref.get_config(arch).reduced())
        rng = np.random.default_rng(13)
        toks = rng.integers(0, 512, (2, T)).astype(np.int32)
        labels = rng.integers(0, 512, (2, T)).astype(np.int32)
        labels[rng.random((2, T)) < 1 / 6] = -1
        out[arch] = (ref.jax.tree_util.tree_map(np.asarray, jp),
                     {"tokens": toks, "labels": labels})
    return out


@pytest.fixture(scope="module")
def four(cases, tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("intrapod4"))
    return out_dir, procs.spawn(_four_ranks, 4, backend="gloo", device="cpu",
                                timeout=SPAWN_TIMEOUT, args=(cases, out_dir))


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("intrapod8"))
    return out_dir, procs.spawn(_eight_ranks, 8, backend="gloo",
                                device="cpu", timeout=SPAWN_TIMEOUT,
                                args=(out_dir,))


@pytest.fixture
def ranks(request, four, eight):
    """(out_dir, every rank's checks of ``request.param``'s mesh)."""
    out_dir, results = eight if request.param == EIGHT else four
    return out_dir, [r["meshes"][request.param] for r in results]


def _leaf_close(got, want, tol, what):
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        bound = tol * max(1.0, float(np.abs(w).max(initial=0.0)))
        err = float(np.abs(g - w).max(initial=0.0))
        assert err <= bound, (what, i, w.shape, err, bound)


# ---------------------------------------------------------------------------
# (i) the pod's loss and gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(DENSE))
def test_sharded_loss_and_grads_match_one_device_and_reference(
        ref, cases, four, arch):
    """Mesh (1, 2, 2): the pod's loss on every rank, and each leaf's
    gradient gathered whole, against the one-device port's
    ``loss_fn`` and against ``jax.value_and_grad`` of the reference's."""
    tree, nb = cases[arch]
    cfg = _cfg(arch)
    jloss, jgrads = ref.jax.value_and_grad(
        lambda p_, b_: ref.model.loss_fn(p_, ref.get_config(arch).reduced(),
                                         b_)[0])(
        ref.jax.tree_util.tree_map(ref.jnp.asarray, tree),
        {k: ref.jnp.asarray(v) for k, v in nb.items()})
    p = pytree.tree_map(lambda t: t.requires_grad_(),
                        model.lm_params_from_jax(tree, "cpu"))
    loss, _ = model.loss_fn(p, cfg, {k: torch.from_numpy(v).long()
                                     for k, v in nb.items()})
    grads = [g.numpy() for g in torch.autograd.grad(loss, pytree.leaves(p))]
    _, results = four
    losses = [r["grads"][arch][0] for r in results]
    whole = [g.numpy() for g in results[0]["grads"][arch][1]]
    assert len(set(losses)) == 1, losses
    np.testing.assert_allclose(losses[0], float(loss.detach()), rtol=0,
                               atol=GRAD_TOL)
    np.testing.assert_allclose(losses[0], float(jloss), rtol=0, atol=GRAD_TOL)
    _leaf_close(whole, grads, GRAD_TOL, f"{arch} against the port")
    _leaf_close(whole, [np.asarray(g) for g in
                        ref.jax.tree_util.tree_leaves(jgrads)], GRAD_TOL,
                f"{arch} against the reference")


def test_remat_recompute_on_another_thread(four):
    """The backward on a thread that did not enter ``activation_sharding``
    (as the autograd engine's device thread on the card) recomputes the
    checkpointed cycles on the rank's blocks: the same gradient, bit for
    bit."""
    _, results = four
    assert all(r["thread"] for r in results)


def test_ranks_hold_their_blocks(four, eight):
    for (_, results), shape in ((four, GRAD_MESH), (eight, EIGHT)):
        want = [dict(zip(mesh_lib.AXES, map(int, np.unravel_index(i, shape))))
                for i in range(len(results))]
        assert [r["coords"] for r in results] == want


# ---------------------------------------------------------------------------
# (ii) one step and the exchange on (2, 2, 1), (2, 1, 2), (2, 2, 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("ranks", MESHES, ids=_id, indirect=True)
def test_exchange_on_blocks_matches_one_card_bit_for_bit(ranks, strategy,
                                                         dtype):
    """Each rank's blocks of the exchange on one set of inputs equal the
    one-card exchange's: the sums, Gaia's selection, DGC's selection (a
    sharded leaf's threshold from its histogram summed over the ranks)
    and the gossip rows."""
    _, results = ranks
    assert all(r["exchange"][strategy, dtype] for r in results)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("ranks", MESHES, ids=_id, indirect=True)
def test_train_step_on_blocks_matches_one_card(ranks, strategy):
    _, results = ranks
    for i, r in enumerate(results):
        l2, err, same_keys = r["step"][strategy]
        assert same_keys and l2 <= STEP_TOL and err <= LOSS_TOL, (i, l2, err)


# ---------------------------------------------------------------------------
# (iii) checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ranks", (FOUR[0], EIGHT), ids=_id, indirect=True)
def test_checkpoint_on_the_mesh_is_the_one_card_checkpoint(ref, ranks):
    """The mesh's checkpoint of a gaia state (params, vel, acc) equals the
    one-card checkpoint of the state gathered whole, array for array and
    the meta's bytes; the reference's ``restore`` reads it; each rank
    restores its own blocks."""
    out_dir, results = ranks
    shape = FOUR[0] if len(results) == 4 else EIGHT
    path = os.path.join(out_dir, _id(shape))
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
    cfg = _cfg()
    state = steps.train_state_shape(cfg, _comm(CKPT_STRATEGY), N_PODS)
    like = {k: pytree.tree_map(lambda t: np.zeros(t.shape, np.float32),
                               state[k]) for k in ("params", "vel", "acc")}
    back = ref.ckpt.restore(os.path.join(path, "mesh"), like, step=1)
    with np.load(os.path.join(b, "payload.npz")) as zb:
        for i, leaf in enumerate(ref.jax.tree_util.tree_leaves(back)):
            np.testing.assert_array_equal(np.asarray(leaf), zb[f"leaf_{i}"])
    assert all(r["ckpt"] for r in results)


# ---------------------------------------------------------------------------
# (iv) refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["make_mesh", "make_train_step"])
@pytest.mark.parametrize("case", list(BAD))
def test_refusals_come_before_any_collective(four, case, where):
    """A width the axes do not divide, of each family (the RG-LRU's width,
    the encoder's d_model, the SSM's heads), KV heads or d_model, once
    refused: on the mesh ``make_mesh`` makes, the prefill on the rank's
    blocks (the dimension whole on every rank of its axis) within
    ``GRAD_TOL`` of one device's; ``make_train_step`` takes it and
    reaches no collective (``tests/test_torch_clamp.py`` trains such
    leaves)."""
    _, results = four
    for r in results:
        text, calls = r["refused"][case, where]
        assert text is None, text
        if where == "make_train_step":
            assert calls == [], calls
        else:
            assert r["prefill_gap"][case] <= GRAD_TOL, r["prefill_gap"]


def test_a_batch_that_does_not_split_over_data_is_refused(four):
    """One sequence a pod on a data axis of 2: the clamp keeps it whole,
    every ``data`` rank runs it and nothing is summed over ``data``
    (``Mesh.with_rows_whole``; ``tests/test_torch_clamp.py`` holds such
    steps against one device): the step is taken."""
    _, results = four
    for r in results:
        text, _ = r["refused"]["batch", "train_step"]
        assert text is None, text


@pytest.mark.parametrize("case", list(BAD))
@pytest.mark.parametrize("shape", [(1, 2, 1), (1, 1, 2), (2, 2, 2)],
                         ids=_id)
def test_check_layout_refuses_what_the_axes_cannot_take(case, shape):
    """Each case is taken on each mesh (its train step traced on the
    mesh's last rank, ``_torch_layout``), and the leaves of its width the
    mesh's axes do not split keep that dimension whole (``WHOLE``); where
    the mesh has no such axis (a ``data`` axis alone for the SSM's and the
    KV heads' cases, a ``model`` axis alone for d_model) there is none to
    hold."""
    mesh = mesh_lib.Mesh(shape, mesh_lib.AXES)
    trace_layout(BAD[case](), shape, "train")
    ok, held = _clamped_whole(BAD[case](), mesh, case)
    assert ok, (case, NAMED[case])
    model_only = case in ("ssm", "kv_heads")
    assert held > 0 or (model_only and shape[2] == 1) or (
        case == "d_model" and shape[1] == 1), (case, held)


@pytest.mark.parametrize("arch", list(DENSE))
def test_check_layout_takes_the_dense_archs(arch):
    """The full-width dense archs on the reference's (2, 2, 2) sweep
    mesh, the train step traced on its last rank."""
    trace_layout(get_config(arch), (2, 2, 2), "train")


def test_check_layout_at_the_production_width():
    """qwen3-0.6b on (pod, data, model) = (2, 16, 8): 8 KV heads over 8
    model ranks; the production (2, 16, 16) puts its 8 KV heads on a
    16-way model axis, each head shared by two ranks, and deepseek-v2-
    lite-16b's 16 heads and 64 experts on 16 model ranks: both taken,
    for training and for serving (the steps traced on the last rank)."""
    trace_layout(get_config("qwen3-0.6b"), (2, 16, 8), "train")
    prod = mesh_lib.make_production_mesh(multi_pod=True)
    for arch in ("qwen3-0.6b", "deepseek-v2-lite-16b"):
        for mode in ("train", "serve"):
            trace_layout(get_config(arch), tuple(prod.shape.values()), mode)


# ---------------------------------------------------------------------------
# (v) the training example
# ---------------------------------------------------------------------------

def test_example_mesh_matches_one_process(tmp_path):
    """``--mesh 2,2,1 --procs 4 --device cpu`` (BSP: FSDP's gathers and
    reduce-scatters, the gradient all-reduced across pods) against one
    process: the losses, and the checkpoint gathered from the ranks.
    Gaia's and DGC's selections flip an entry at their threshold where
    the sharded sums round otherwise (a run of 21 steps of DGC ends 2.3e-5
    apart in 6 of 65,536 entries), so they are held one step at a time
    above."""
    from repro_torch.examples import train_lm_decentralized as ex
    argv = ["--device", "cpu", "--strategy", "bsp", "--steps", "21",
            "--seq", "32", "--d-model", "64", "--layers", "2",
            "--batch-per-pod", "2", "--lr", "3e-3"]
    one = ex.train(ex.parse_args(argv))
    run = ex.train(ex.parse_args(argv + ["--mesh", "2,2,1", "--procs", "4",
                                         "--ckpt", str(tmp_path)]))
    assert [t for t, _ in run["losses"]] == [t for t, _ in one["losses"]]
    np.testing.assert_allclose([x for _, x in run["losses"]],
                               [x for _, x in one["losses"]],
                               rtol=EXAMPLE_TOL)
    params = one["state"]["params"]
    back = ckpt.restore(str(tmp_path), params, step=21)
    for x, y in zip(pytree.leaves(back), pytree.leaves(params)):
        torch.testing.assert_close(x, y, rtol=EXAMPLE_TOL, atol=EXAMPLE_TOL)
    with pytest.raises(ValueError, match="holds 4 ranks"):
        ex.mesh_shape(ex.parse_args(["--mesh", "2,2,1", "--procs", "2"]))
