"""Parameter, state, cache and batch placement rules
(``repro.launch.sharding``), as pure functions.

2D scheme inside each pod: FSDP-style sharding over ``data`` + tensor and
expert parallelism over ``model``:

- in-projections (d -> heads*hd / ff):     (data, model)   [out-dim TP]
- out-projections (heads*hd / ff -> d):    (model, data)   [in-dim TP]
- embedding (vocab, d):                    (model, data)   [vocab TP]
- MoE stacked experts (E, d, ff):          (model, data, None)  [expert par.]
- norms / biases / small vectors:          replicated
- the decentralized-site axis ``pod`` shards the *stacked replica*
  dimension that ``steps.make_train_state`` prepends.

A spec is what the reference's ``PartitionSpec`` holds: a tuple with one
entry a dimension (fewer for ``rule_spec``), each a mesh-axis name or
None.  Rules match on the leaf's path string (``"body/mixer/wq/w"``, the
reference's ``_path_str``) and rank, so they cover every arch family
without per-model tables.  The ``*_shardings`` functions return a tree of
specs shaped like their input.

The train and serve steps apply them (``local_slices``, ``local_block``):
the ``pod`` entries say which rows of the stacked state and batch a rank
holds; on a mesh with a ``data`` or ``model`` axis above 1 (every family, at
the widths ``check_layout`` takes for training or serving) the ``data`` and
``model`` entries say which block of each leaf (``local_params``), of
each decode-cache leaf (``local_cache``; ``cache_split`` names the axis
its length is split over) and which of the pod's sequences.
``gather_leaf`` is the inverse, for checkpoints and checks.  Where an
axis does not divide a dimension the reference's ``_clamp_spec`` keeps
the dimension whole.  The model code takes these whole dimensions
(``check_layout`` refuses the rest, each named):
- a vocabulary the ``model`` axis does not divide (``vocab_whole``): the
  table and the unembedding whole over ``model`` (d_model still over
  ``data``), the lookup, the logits, the cross-entropy and the greedy
  argmax no longer vocabulary-parallel;
- query heads the ``model`` axis does not divide (``heads_whole``): the
  projections' columns still split, so the rank gathers its column
  blocks of q, k and v over ``model``, computes every head, and hands the
  row-parallel ``wo`` the attention output's columns of its row block;
  MLA's ``wukv`` keeps its heads whole on every rank;
- a GQA decode cache's KV heads on a ``model`` axis that is a multiple of
  n_kv_heads (each KV head shared by M / n_kv_heads ranks) or that does
  not divide them: ``wk`` and ``wv`` stay split by columns, and the cache
  keeps every head on every ``model`` rank;
- the SSM's and the RG-LRU's conv history and the RG-LRU's state on every
  ``model`` rank (the requests over ``data``), and, for requests the
  ``data`` axis does not divide (one ``long_500k`` request), the conv
  history whole beside the SSD state's heads over ``data``.
Where the placement does not follow a model's structure (the SSM's
``in_proj`` and ``conv_w`` blocks cut across its heads; its SSD state's
head_dim over ``model``) the model code computes around it
(``models/ssm.py``); the placements stay the reference's.
"""
from __future__ import annotations

import math
import re
from typing import Any, Optional, Tuple

import torch

from repro_torch import pytree
from repro_torch.launch.mesh import INTRA, Mesh

Spec = Tuple[Optional[str], ...]
Tree = Any

_OUT_PROJ = r"(wo|down|out_proj|out)"


def rule_spec(path: str, shape: Tuple[int, ...]) -> Spec:
    """The spec of an unstacked leaf at ``path`` of ``shape``: the first
    rule that matches."""
    ndim = len(shape)
    if ndim <= 1 or min(shape) == 1:
        return ()                                    # scalars/vectors/norms
    if re.search(r"embed/table$|table$", path):      # embedding / unembed
        return ("model", "data")
    if re.search(r"unembed/w$", path):
        return ("data", "model")
    # MoE stacked experts (E, d, ff) / (E, ff, d)
    if re.search(r"ffn/w_(gate|up|down)$", path) and ndim == 3:
        return ("model", "data", None)
    # MLA 3D up-projection (r, h, nope+v): shard heads
    if re.search(r"wukv$", path) and ndim == 3:
        return (None, "model", None)
    if re.search(r"conv_w$", path) and ndim == 2:    # conv (K, Ch): channels
        return (None, "model")
    # output projections: TP on the input dim
    if re.search(_OUT_PROJ + r"/w$", path) and ndim == 2:
        return ("model", "data")
    # input projections and everything else 2D: TP on the output dim
    if ndim == 2:
        return ("data", "model")
    return ()


def _axis_size(mesh: Mesh, ax) -> int:
    return math.prod(mesh.shape[a] for a in
                     (ax if isinstance(ax, tuple) else (ax,)))


def splits(dim: int, size: int) -> bool:
    """Whether ``size`` ranks split a dimension of ``dim`` (the clamp's
    rule)."""
    return dim % size == 0 and dim >= size


def _clamp_spec(spec: Spec, shape, mesh: Mesh) -> Spec:
    """Drop sharding on dims the mesh can't divide (tiny reduced configs):
    one entry a dimension of ``shape``."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                     - len(spec))):
        if ax is None:
            out.append(None)
            continue
        out.append(ax if splits(dim, _axis_size(mesh, ax)) else None)
    return tuple(out)


def param_shardings(params_shape: Tree, mesh: Mesh, *,
                    stacked: bool = False,
                    snap_stacked: bool = False) -> Tree:
    """The spec tree of a params(-shaped) tree (tensors, ``meta`` ones
    included).  ``stacked``: the tree has a prepended replica dimension
    (pod-site stacking in the train state), sharded over ``pod`` when the
    mesh has that axis.  ``snap_stacked``: a staleness-slot dimension
    before it as well (AD-PSGD's snapshot buffer), never sharded."""
    stack_axis = "pod" if (stacked and "pod" in mesh.axis_names) else None
    out = []
    for ps, leaf in pytree.leaves_with_paths(params_shape):
        shape = tuple(leaf.shape)
        segs = ps.split("/")
        # scan-stacked layer cycles carry a leading cycle axis
        cycle_stacked = "body" in segs or "layers" in segs
        lead: Tuple = ()
        if snap_stacked:
            lead += (None,)
            shape = shape[1:]
        if stacked:
            lead += (stack_axis,)
            shape = shape[1:]
        if cycle_stacked:
            lead += (None,)
            shape = shape[1:]
        spec = lead + rule_spec(ps, shape)
        out.append(_clamp_spec(spec, tuple(leaf.shape), mesh))
    return pytree.unflatten(params_shape, out)


def train_state_shardings(state_shape: Tree, mesh: Mesh) -> Tree:
    """Specs of the launch train state: every entry pod-stacked; AD-PSGD's
    ``snaps`` carries an unsharded snapshot-slot axis in front."""
    return {k: param_shardings(v, mesh, stacked=True,
                               snap_stacked=(k == "snaps"))
            for k, v in state_shape.items()}


def _cache_spec(path: str, shape, batch_sharded: bool,
                baseline_decode: bool) -> Spec:
    """``cache_shardings``' entry for the leaf at ``path`` before the
    clamp: one entry a dimension."""
    nd = len(shape)
    stacked = path.startswith("body")        # leading cycle axis
    off = 1 if stacked else 0
    dims: list = [None] * nd
    if "pos" in path:                        # (B, L) int positions
        if batch_sharded:
            dims[off] = "data"
        elif nd - off >= 2:
            dims[off + 1] = "data"
        return tuple(dims)
    if nd - off >= 3:                        # kv / ckv / conv / ssd
        if batch_sharded:
            dims[off] = "data"
            if not baseline_decode and any(
                    t in path for t in ("/k", "/v", "ckv", "krope")):
                dims[off + 1] = "model"
            elif nd - off >= 4:
                dims[off + 2] = "model"
        else:
            dims[off + 1] = "data"           # shard length/heads dim
            if nd - off >= 4:
                dims[off + 2] = "model"
    elif nd - off == 2:                      # (B, w) rglru h state
        if batch_sharded:
            dims[off] = "data"
        else:
            dims[off + 1] = "model"
    return tuple(dims)


def cache_shardings(cache_shape: Tree, mesh: Mesh, *, batch_sharded: bool,
                    baseline_decode: bool = False) -> Tree:
    """Decode-cache specs.  KV caches are (B, L, H, hd) (+ an optional
    leading stacked-cycle axis).  When the batch is big enough it shards
    over ``data``; for global_batch=1 (long_500k) the cache *length* dim
    shards over ``data`` instead (sequence sharding).  Attention caches
    shard their length over ``model`` (flash-decode) unless
    ``baseline_decode`` (the reference's ``REPRO_BASELINE_DECODE``)."""
    return pytree.unflatten(cache_shape, [
        _clamp_spec(_cache_spec(ps, tuple(leaf.shape), batch_sharded,
                                baseline_decode), tuple(leaf.shape), mesh)
        for ps, leaf in pytree.leaves_with_paths(cache_shape)])


def batch_shardings(batch_shape: Tree, mesh: Mesh, *,
                    pod_stacked: bool) -> Tree:
    """Input batches: leading (pod?, batch) dims shard over (pod?, data)."""
    def spec_for(shape) -> Spec:
        nd = len(shape)
        dims: list = [None] * nd
        i = 0
        if pod_stacked:
            dims[0] = "pod" if "pod" in mesh.axis_names else None
            i = 1
        if nd > i and shape[i] > 1:
            dims[i] = "data"
        return tuple(dims)
    return pytree.tree_map(
        lambda t: _clamp_spec(spec_for(tuple(t.shape)), tuple(t.shape), mesh),
        batch_shape)


# ---------------------------------------------------------------------------
# A rank's block
# ---------------------------------------------------------------------------

def local_slices(spec: Spec, shape, mesh: Mesh) -> Tuple[slice, ...]:
    """The block of each dimension of a ``shape`` tensor placed by ``spec``
    that this rank (``mesh.coords``) holds: a dimension sharded over axes
    of total size n is cut into n equal blocks, the rank's index on those
    axes (row-major) picking one."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                     - len(spec))):
        if ax is None:
            out.append(slice(0, dim))
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        n, i = 1, 0
        for a in names:
            n, i = n * mesh.shape[a], i * mesh.shape[a] + mesh.coords[a]
        if dim % n:
            raise ValueError(f"dimension {dim} does not split over {names} "
                             f"({n} ranks)")
        out.append(slice(i * dim // n, (i + 1) * dim // n))
    return tuple(out)


def local_block(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t`` (a view) as ``spec`` places it."""
    return t[local_slices(spec, tuple(t.shape), mesh)]


# ---------------------------------------------------------------------------
# The intra-pod axes
# ---------------------------------------------------------------------------

def intra_pod(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` splits a pod over more than one rank (a ``data`` or
    ``model`` axis above 1)."""
    return mesh is not None and mesh.size_of(INTRA) > 1


MODES = ("train", "serve")


def kv_shared(a, M: int) -> bool:
    """Whether a ``model`` axis of ``M`` ranks is wider than the GQA
    attention ``a``'s n_kv_heads (``check_layout`` takes it where M is a
    multiple of n_kv_heads): each KV head then serves M / n_kv_heads
    ranks, every rank computes its column block of ``wk`` and ``wv``,
    gathers k and v whole and keeps the head its query heads read."""
    return a.kind == "gqa" and M > a.n_kv_heads


def heads_whole(a, M: int) -> bool:
    """Whether the attention ``a`` (GQA, MLA, the enc-dec's encoder and
    cross-attention) runs every head on each of ``M`` ``model`` ranks:
    where M does not divide n_heads (nor then n_kv_heads, unless the axis
    is wider than them: ``kv_shared``).  The rank gathers its column
    blocks of q, k and v whole and hands ``wo`` its row block of the
    output."""
    return M > 1 and a.n_heads % M != 0


def vocab_whole(vocab: int, M: int) -> bool:
    """Whether the table and the unembedding keep ``vocab`` whole on each
    of ``M`` ``model`` ranks (the clamp's rule): the logits are then
    whole on every ``model`` rank."""
    return M > 1 and not splits(vocab, M)


def recurrent(cfg) -> bool:
    """Whether ``cfg`` keeps an SSM or RG-LRU state in its decode cache."""
    return cfg.ssm is not None or cfg.rglru is not None


def default_batch_sharded(cfg, batch: int, mesh: Optional[Mesh]) -> bool:
    """The decode cache's placement for ``batch`` requests where the
    caller names none: the requests over ``data`` from 8 of them (the
    reference's rule), and for a model with an SSM or RG-LRU state on a
    ``data`` axis above 1 wherever that axis splits the requests
    (``check_cache_placement``)."""
    D = 1 if mesh is None else mesh.size_of("data")
    return batch >= 8 or (recurrent(cfg) and D > 1 and splits(batch, D))


def check_cache_placement(cfg, mesh: Optional[Mesh], batch_sharded: bool,
                          batch: int) -> None:
    """Raises ``ValueError`` where the decode cache of ``batch`` requests
    of ``cfg`` cannot take ``batch_sharded`` on ``mesh``.  With the
    requests whole (``batch_sharded=False``) the reference places the
    SSM's and the RG-LRU's conv history's K - 1 slots over ``data`` (its
    clamp keeps them whole on every rank, beside an SSD state split over
    the heads and the RG-LRU's state by channel over ``model``).  The port
    takes that placement where the ``data`` axis does not split the
    requests either (every rank decodes all of them: one ``long_500k``
    request); where it splits them, a rank would decode its rows against
    every row's state, so the port serves them with the requests over
    ``data`` (ROADMAP C16); and where it splits the K - 1 slots, it
    refuses."""
    D = 1 if mesh is None else mesh.size_of("data")
    if not (intra_pod(mesh) and not batch_sharded and recurrent(cfg)
            and D > 1):
        return
    k = (cfg.ssm or cfg.rglru).d_conv - 1
    if splits(batch, D):
        raise ValueError(
            f"{cfg.arch_id} on data={D}: {batch} requests split over data, "
            "so the SSM and RG-LRU decode caches are served with the "
            "requests over data (batch_sharded=True); the placement of a "
            "whole batch would decode the rank's rows against every row's "
            "state")
    if splits(k, D):
        raise ValueError(
            f"{cfg.arch_id}: d_conv - 1={k} over data={D} (the whole "
            "batch's conv history): the decode reads every slot")


def _alignment(cfg, M: int) -> list:
    """The refusals no leaf's clamp can see: a ``model`` axis that cuts
    across the SSM's heads (whose rows of ``out_proj`` and SSD state the
    rank computes), a ``model`` axis wider than n_kv_heads that is not a
    multiple of it (``kv_shared``), and one that splits the query heads
    but cuts across a KV head.  Query heads the axis does not divide are
    taken (``heads_whole``: every head on every rank)."""
    a, bad = cfg.attention, []
    if cfg.encoder is not None or any(
            cfg.block_kind(i) == "attn" for i in range(cfg.n_layers)):
        if kv_shared(a, M):
            if M % a.n_kv_heads:
                bad.append(f"model={M} over n_kv_heads={a.n_kv_heads} (a "
                           "model axis wider than n_kv_heads must be a "
                           "multiple of it)")
        elif (a.kind == "gqa" and not heads_whole(a, M)
              and a.n_kv_heads % M):
            bad.append(f"n_kv_heads={a.n_kv_heads} over model={M}")
    if cfg.ssm is not None and cfg.ssm.n_heads % M:
        bad.append(f"ssm n_heads={cfg.ssm.n_heads} over model={M}")
    return bad


#: the dimensions the model code takes whole where the clamp keeps them
#: so (``_DIM_NAMES``' names): the vocabulary (``vocab_whole``), MLA's
#: ``wukv`` heads (``heads_whole``), a whole batch's conv history slots
_TAKEN_WHOLE = ("vocab", "n_heads", "d_conv - 1")


#: the names of a leaf's dimensions (the last ones; a stacked cycle axis
#: goes before them), by its path, the first pattern that matches: what a
#: refusal calls a dimension the clamp would keep whole
_DIM_NAMES = (
    (r"encoder/in_proj/w$", ("feat_dim", "encoder d_model")),
    (r"encoder/layers/w[qkv]/w$|xattn/w[kv]/w$",
     ("encoder d_model", "n_heads * head_dim")),
    (r"encoder/layers/wo/w$", ("n_heads * head_dim", "encoder d_model")),
    (r"encoder/layers/ffn/(gate|up)/w$", ("encoder d_model", "d_ff")),
    (r"encoder/layers/ffn/down/w$", ("d_ff", "encoder d_model")),
    (r"table$", ("vocab", "d_model")),
    (r"unembed/w$", ("d_model", "vocab")),
    (r"projector/w$", ("feat_dim", "d_model")),
    (r"router/w$", ("d_model", "n_experts")),
    (r"ffn/w_(gate|up)$", ("n_experts", "d_model", "d_ff_expert")),
    (r"ffn/w_down$", ("n_experts", "d_ff_expert", "d_model")),
    (r"shared/(gate|up)/w$", ("d_model", "n_shared * d_ff_expert")),
    (r"shared/down/w$", ("n_shared * d_ff_expert", "d_model")),
    (r"ffn/(gate|up)/w$", ("d_model", "d_ff")),
    (r"ffn/down/w$", ("d_ff", "d_model")),
    (r"wq/w$", ("d_model", "n_heads * head_dim")),
    (r"w[kv]/w$", ("d_model", "n_kv_heads * head_dim")),
    (r"wo/w$", ("n_heads * head_dim", "d_model")),
    (r"wdq/w$", ("d_model", "q_lora_rank")),
    (r"wuq/w$", ("q_lora_rank", "n_heads * qk_head_dim")),
    (r"wdkv/w$", ("d_model", "kv_lora_rank + rope_head_dim")),
    (r"wukv$", ("kv_lora_rank", "n_heads", "qk_nope_head_dim + v_head_dim")),
    (r"in_proj/w$", ("d_model", "ssm in_proj width")),
    (r"out_proj/w$", ("d_inner", "d_model")),
    (r"(in_x|in_gate)/w$", ("d_model", "lru_width")),
    (r"(w_a|w_i)/w$", ("lru_width", "lru_width")),
    (r"out/w$", ("lru_width", "d_model")),
    (r"conv_w$", ("d_conv", "conv channels")),
    (r"ssd$", ("requests", "ssm n_heads", "ssm head_dim", "d_state")),
    (r"/[kv]$", ("requests", "cache length", "n_kv_heads", "head_dim")),
    (r"conv$", ("requests", "d_conv - 1", "conv channels")),
    (r"(ckv|krope)$", ("requests", "cache length", "latent width")),
    (r"/h$", ("requests", "lru_width")),
    (r"pos$", ("requests", "cache length")))


def _clamped(path: str, shape, want: Spec, mesh: Mesh) -> list:
    """Where the clamp drops an axis that ``want`` (one entry a dimension
    of ``shape``) names: (what, ``path``) for each dimension the axis does
    not split, what as "name=n over axis=k" (``_DIM_NAMES``), but the
    dimensions the model code takes whole (``_TAKEN_WHOLE``)."""
    got = _clamp_spec(want, shape, mesh)
    names = next((n for pat, n in _DIM_NAMES if re.search(pat, path)), ())
    out = []
    for i, (n, w, g) in enumerate(zip(shape, want, got)):
        if w is not None and g is None:
            j = i - (len(shape) - len(names))
            name = names[j] if j >= 0 else f"dimension {i}"
            if name not in _TAKEN_WHOLE:
                out.append((f"{name}={n} over {w}={_axis_size(mesh, w)}",
                            path))
    return out


def _param_refusals(cfg, mesh: Mesh) -> list:
    """``_clamped`` over every parameter leaf of ``cfg``, by the rules of
    ``param_shardings``."""
    from repro_torch.models.model import init_model
    out = []
    for ps, leaf in pytree.leaves_with_paths(init_model(None, cfg, "meta")):
        shape = tuple(leaf.shape)
        segs = ps.split("/")
        lead = (None,) if ("body" in segs or "layers" in segs) else ()
        out += _clamped(ps, shape, lead + rule_spec(ps, shape[len(lead):]),
                        mesh)
    return out


def cache_refusals(cache: Tree, mesh: Mesh, *, batch_sharded: bool,
                   baseline_decode: bool) -> list:
    """The leaves of a whole decode ``cache`` that ``mesh`` does not split
    as ``cache_shardings`` places them (a dimension the reference's clamp
    would keep whole, which the decode would read as the rank's block),
    as ``_clamped`` gives them; a GQA cache's KV heads that the ``model``
    axis does not split are taken (every ``model`` rank holds them all,
    and the decode reads its own: ``kv_shared``, or every head:
    ``heads_whole``; ``_alignment`` refuses the rest)."""
    out = []
    for path, t in pytree.leaves_with_paths(cache):
        shape = tuple(t.shape)
        want = _cache_spec(path, shape, batch_sharded, baseline_decode)
        if path.endswith(("/k", "/v")):
            want = want[:-2] + (None,) + want[-1:]
        out += _clamped(path, shape, want, mesh)
    return out


def check_layout(cfg, mesh: Optional[Mesh], mode: str = "train") -> None:
    """Raises ``ValueError`` where ``cfg`` (a ``ModelConfig``) cannot be
    placed on ``mesh``'s ``data`` and ``model`` axes for ``mode``
    (``"train"`` or ``"serve"``): every family is placed for both, so the
    refusals are widths an axis does not split, each named.  By the
    placements: every parameter leaf where ``param_shardings``' clamp
    would drop an axis its rule names, and, to serve, every leaf of the
    decode cache (the requests over ``data``) that ``cache_shardings``
    would leave whole so (the SSD state's head_dim over ``model``), each
    dimension named by ``_DIM_NAMES``, but the dimensions the model code
    takes whole (``_TAKEN_WHOLE``: the vocabulary, MLA's ``wukv`` heads,
    a GQA cache's KV heads).  By alignment, which no clamp sees
    (``_alignment``): the SSM's heads over ``model``, and a ``model`` axis
    wider than n_kv_heads that is not a multiple of them.  Nothing to
    check without an axis above 1."""
    if mode not in MODES:
        raise ValueError(f"check_layout: mode={mode!r}; want one of "
                         f"{MODES}")
    if not intra_pod(mesh):
        return
    leaves = _param_refusals(cfg, mesh)
    if mode == "serve":
        from repro_torch.models.model import init_cache
        whole = init_cache(cfg, mesh.size_of("data"), mesh.size_of("model"),
                           device="meta")
        for base in (False, True):
            leaves += cache_refusals(whole, mesh, batch_sharded=True,
                                     baseline_decode=base)
    first = {}
    for what, path in leaves:
        first.setdefault(what, path)
    bad = _alignment(cfg, mesh.size_of("model")) + [
        f"{what} ({path})" for what, path in first.items()]
    if bad:
        raise ValueError(
            f"{cfg.arch_id}: {'; '.join(bad)}: the axis does not divide the "
            "dimension; a dimension left whole would be read as the rank's "
            "block")


def cache_split(mesh: Optional[Mesh], *, batch_sharded: bool,
                baseline_decode: bool) -> Optional[str]:
    """The mesh axis over which ``cache_shardings`` splits the attention
    caches' *length* for these flags, None where every rank holds its
    rows' whole length: ``"model"`` (the batch over ``data``, the length
    over ``model``: flash-decode), None (``baseline_decode``: the batch
    over ``data``, the KV heads over ``model``), ``"data"`` (a batch
    below 8: the length over ``data``, the heads over ``model``).
    Without an intra-pod mesh, None."""
    if not intra_pod(mesh):
        return None
    if not batch_sharded:
        return "data" if mesh.size_of("data") > 1 else None
    if baseline_decode:
        return None
    return "model" if mesh.size_of("model") > 1 else None


def local_cache(cache: Tree, mesh: Mesh, *, batch_sharded: bool,
                baseline_decode: bool = False) -> Tree:
    """This rank's block of every leaf of a whole decode ``cache`` (views),
    as ``cache_shardings`` places them: the counterpart of
    ``local_params``.  Raises ``ValueError`` where an axis does not split
    a dimension the placement shards (the reference's ``_clamp_spec``
    would leave it whole, which the decode would read as the rank's
    block), but a GQA cache's KV heads on a ``model`` axis that is a
    multiple of their count: every ``model`` rank holds them all, and the
    decode reads its own (``kv_shared``)."""
    bad = cache_refusals(cache, mesh, batch_sharded=batch_sharded,
                         baseline_decode=baseline_decode)
    if bad:
        raise ValueError(
            f"cache leaves: the mesh {mesh.shape} does not split "
            f"{', '.join(f'{w} ({p})' for w, p in bad)} as the placement asks (a batch the data axis "
            "divides; a length the axis it is split over divides)")
    return pytree.unflatten(cache, [
        local_block(t, _clamp_spec(_cache_spec(
            path, tuple(t.shape), batch_sharded, baseline_decode),
            tuple(t.shape), mesh), mesh)
        for path, t in pytree.leaves_with_paths(cache)])


def leaf_specs(params: Tree, mesh: Mesh) -> list:
    """The spec of each leaf of an unstacked params(-shaped) tree, in
    ``pytree.leaves``' order (``param_shardings``' entries)."""
    return pytree.leaves_like(param_shardings(params, mesh), params)


def local_params(params: Tree, mesh: Mesh) -> Tree:
    """This rank's block of every leaf of one replica's ``params`` (views),
    as ``param_shardings`` places them on ``mesh``."""
    return pytree.unflatten(params, [
        local_block(t, spec, mesh)
        for t, spec in zip(pytree.leaves(params), leaf_specs(params, mesh))])


def gather_leaf(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The pod's whole leaf from this rank's block ``t`` placed by
    ``spec``: every ``data`` and ``model`` dimension all-gathered (the
    ``pod`` dimension left as it is), on every rank of the pod."""
    for dim, ax in enumerate(spec):
        if ax in ("data", "model"):
            t = mesh.all_gather_dim(t, dim, ax)
    return t


#: replicated leaves that act on a rank's own heads, columns or channels
#: under tensor parallelism, so each ``model`` rank holds a part of their
#: gradient: GQA's qk-norm scales (on the rank's heads), MLA's latent norms
#: ``q_norm`` and ``kv_norm`` (on the latent gathered whole, then read by
#: the rank's columns of ``wuq`` and heads of ``wukv``), the SSM's
#: per-head ``A_log``, ``dt_bias`` and ``D`` and its gated norm's scale
#: (the rank's heads and channels), the conv biases of the SSM and the
#: RG-LRU and the RG-LRU's ``lam`` (the rank's channels; the SSM's B and C
#: channels read by every rank's heads, each a part), and the bias of a
#: column-parallel projection
_MODEL_PARTIAL = re.compile(r"(^|/)(q_norm|k_norm|kv_norm)/scale$"
                            r"|mixer/(A_log|dt_bias|D|conv_b|lam|norm/scale)$")


def grad_sync_axis(path: str, spec: Spec, mesh: Mesh):
    """The axis over which the gradient of the leaf at ``path`` (placed
    by ``spec``) is summed after the backward, None where the backward
    left it whole: a leaf sharded over ``data`` got its sum from the
    reduce-scatter of its gather; any other leaf is summed over ``data``
    (each rank saw its share of the pod's sequences) and, where it acts
    on the rank's heads or columns, over ``model`` too."""
    axes = []
    if "data" not in spec:
        axes.append("data")
        partial = _MODEL_PARTIAL.search(path) or (
            path.endswith("/b") and not re.search(_OUT_PROJ + r"/b$", path))
        if partial and "model" not in spec:
            axes.append("model")
    axes = tuple(a for a in axes if mesh.size_of(a) > 1)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]
