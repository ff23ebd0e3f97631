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
holds; on a mesh with a ``data`` or ``model`` axis above 1 (every family,
on any such axes, for training and serving) the ``data`` and ``model``
entries say which block of each leaf (``local_params``), of
each decode-cache leaf (``local_cache``; ``cache_split`` names the axis
its length is split over) and which of the pod's sequences.
``gather_leaf`` is the inverse, for checkpoints and checks.  Where an
axis does not divide a dimension the reference's ``_clamp_spec`` keeps
the dimension whole, and so does the port, on every family, to train and
to serve: the model code asks ``split`` of each dimension it reads (with
the leaf's whole size) and never assumes the rule's placement.  A block
(attention, an MLP, a mixer, the MoE layer) runs split over ``model``
where the axis splits the rows of its row-parallel exit (Megatron's *f*
before it and *g* after it; a leaf whole inside it through *f*, its
gradient a part on each rank), and whole where it does not (no *f*, no
*g*, every rank the whole block; a leaf split inside it gathered whole,
``layers.block_whole``, ``linear_apply(..., whole=True)``).  Query heads
the axis does not divide run whole on every rank (``heads_whole``), KV
heads are read as the rank's query heads read them
(``attention._kv_select``), a vocabulary the axis does not divide is
whole (``vocab_whole``), a weight a ``data`` axis does not split is
whole with no gather, and a pod's sequences a ``data`` axis does not
split run on every rank of it (``Mesh.with_rows_whole``).  What the
decode cache's placement still refuses is ``check_cache_placement``'s
and ``cache_refusals``' (ROADMAP A11e).  The replicated leaves' gradient
sums follow the blocks (``grad_sync_axis``, ``block_splits``).
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


def split(mesh: Optional[Mesh], axis: str, n: int) -> bool:
    """Whether ``mesh``'s ``axis`` splits a leaf dimension of ``n`` that the
    leaf's rule (``rule_spec``, ``_cache_spec``) places on ``axis``: what
    ``_clamp_spec`` keeps; where it does not, the dimension is whole on
    every rank of the axis.  False without a mesh; True on an axis of one
    rank (each rank's block is the whole dimension, and the collectives
    over it are the identity).  The model code asks this of every
    dimension it reads, with the leaf's whole size, and never assumes the
    rule's placement."""
    return mesh is not None and splits(n, mesh.size_of(axis))


def rank_heads(n_heads: int, M: int, m: int) -> Tuple[int, int]:
    """(the heads ``model`` rank ``m`` of ``M`` runs, its first head):
    n_heads / M from m n_heads / M where M divides them, else all of them
    from 0 (``heads_whole``)."""
    if M > 1 and n_heads % M == 0:
        return n_heads // M, m * n_heads // M
    return n_heads, 0


def heads_whole(a, M: int) -> bool:
    """Whether the attention ``a`` (GQA, MLA, the enc-dec's encoder and
    cross-attention) runs every head on each of ``M`` ``model`` ranks:
    where M does not divide n_heads.  Where the projections' columns
    still split (``split``), the rank gathers its column blocks of q, k
    and v whole and hands a row-parallel ``wo`` its row block of the
    output; where they are whole the block runs whole."""
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


def cache_refusals(cache: Tree, mesh: Mesh, *, batch_sharded: bool,
                   baseline_decode: bool) -> list:
    """The leaves of a whole decode ``cache`` that the port does not place
    as ``cache_shardings`` does: (what, path) for an attention cache's
    length that the whole-batch placement (``batch_sharded=False``) puts
    over a ``data`` axis that does not split it.  Its ring's slot of a
    token is the position modulo the whole length, which the rank's
    block, whole or a part, does not tell the decode (ROADMAP A11e).
    Every other dimension the clamp keeps whole is whole on every rank
    of its axis, and the model code reads it so."""
    out = []
    if batch_sharded or mesh.size_of("data") == 1:
        return out
    for path, t in pytree.leaves_with_paths(cache):
        off = 1 if path.startswith("body") else 0
        if not path.endswith(("/k", "/v", "ckv", "krope")):
            continue
        L, D = t.shape[off + 1], mesh.size_of("data")
        if not splits(L, D):
            out.append((f"cache length={L} over data={D}", path))
    return out


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
    ``local_params``; a dimension the clamp keeps whole is whole in the
    block.  Raises ``ValueError`` for what ``cache_refusals`` names."""
    bad = cache_refusals(cache, mesh, batch_sharded=batch_sharded,
                         baseline_decode=baseline_decode)
    if bad:
        raise ValueError(
            f"cache leaves on the mesh {mesh.shape}: "
            f"{', '.join(f'{w} ({p})' for w, p in bad)}: the whole-batch "
            "placement's attention cache length must split over data "
            "(ROADMAP A11e)")
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
#: gradient where their block runs split over ``model``: GQA's qk-norm
#: scales (on the rank's heads), MLA's latent norms ``q_norm`` and
#: ``kv_norm`` (on the latent gathered whole, then read by the rank's
#: columns of ``wuq`` and heads of ``wukv``), the SSM's per-head
#: ``A_log``, ``dt_bias`` and ``D`` and its gated norm's scale (the
#: rank's heads and channels), the conv biases of the SSM and the RG-LRU
#: and the RG-LRU's ``lam`` (the rank's channels; the SSM's B and C
#: channels read by every rank's heads, each a part), and the bias of a
#: column-parallel projection
_MODEL_PARTIAL = re.compile(r"(^|/)(q_norm|k_norm|kv_norm)/scale$"
                            r"|mixer/(A_log|dt_bias|D|conv_b|lam|norm/scale)$")

#: a block's row-parallel exit, by its last path segment: Megatron's *g*
#: sums over ``model`` there where the block runs split
_EXIT = ("wo", "out_proj", "out", "down")


def _model_partial(path: str) -> bool:
    """Whether the replicated leaf at ``path`` acts on a rank's share of
    its block (``_MODEL_PARTIAL``, or a column-parallel projection's
    bias)."""
    return bool(_MODEL_PARTIAL.search(path) or (
        path.endswith("/b") and not re.search(_OUT_PROJ + r"/b$", path)))


def block_split(mesh: Optional[Mesh], exit_rows: int) -> bool:
    """Whether a block (attention, an MLP, an SSM or RG-LRU mixer) whose
    row-parallel exit has ``exit_rows`` whole rows runs split over
    ``mesh``'s ``model`` axis: the axis splits those rows (``split``).
    The one rule of the model code (``layers.block_whole``) and of the
    gradient sums (``block_splits``)."""
    return split(mesh, "model", exit_rows)


def grad_sync_axis(path: str, spec: Spec, mesh: Mesh, *,
                   block_split: Optional[bool] = True):
    """The axis over which the gradient of the leaf at ``path`` (placed
    by ``spec``) is summed after the backward, None where the backward
    left it whole: a leaf sharded over ``data`` got its sum from the
    reduce-scatter of its gather; any other leaf is summed over ``data``
    (each rank saw its share of the pod's sequences) and, where it acts
    on the rank's heads or columns inside a block that runs split over
    ``model`` (``block_split``, ``block_splits``' verdict), over
    ``model`` too.  In a block that runs whole every ``model`` rank
    computes the whole gradient, which is not summed again."""
    axes = []
    if "data" not in spec:
        axes.append("data")
        if _model_partial(path) and "model" not in spec and block_split:
            axes.append("model")
    axes = tuple(a for a in axes if mesh.size_of(a) > 1)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def block_splits(params_shape: Tree, mesh: Mesh) -> list:
    """For each leaf of a params(-shaped) tree, in ``pytree.leaves``'
    order: for a leaf that acts on a rank's share of its block
    (``_model_partial``), whether the block runs split over ``model``:
    ``block_split`` of the rows of the block's row-parallel exit (the
    nearest ``wo``, ``out_proj``, ``out`` or ``down`` weight up its
    path), the width the model code hands ``layers.block_whole``; None
    for every other leaf, whose gradient sum no block decides.  Raises
    ``ValueError`` for such a leaf with no exit up its path (a new block
    kind, or an exit renamed), whose sum over ``model`` would be a
    guess."""
    paths = pytree.leaves_with_paths(params_shape)
    shapes = {p: tuple(t.shape) for p, t in paths}
    out = []
    for path, _ in paths:
        if not _model_partial(path):
            out.append(None)
            continue
        segs = path.split("/")[:-1]
        exits = []
        while segs and not exits:
            exits = [e for e in ("/".join(segs + [x, "w"]) for x in _EXIT)
                     if e in shapes]
            segs = segs[:-1]
        if not exits:
            raise ValueError(
                f"{path}: acts on a rank's share of its block, but no "
                f"row-parallel exit ({', '.join(_EXIT)}) lies up its path, "
                "so whether its gradient is summed over model is unknown")
        out.append(block_split(mesh, shapes[exits[0]][-2]))
    return out
