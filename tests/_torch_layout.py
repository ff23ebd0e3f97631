"""A model's train and serve steps traced on ``meta`` tensors on one rank
of a mesh (``launch.meta.MetaMesh``): what a test of a placement runs
where no rank is spawned.  The model code computes every shape of the
rank's blocks, so a block, a gather or a sum that does not fit the
placement raises here.

``trace_layout(cfg, shape, mode)`` cuts ``cfg`` to ``cut(cfg)``'s depth
and traces, on the last rank of ``shape`` (rank 0 is the dry run's):

- ``"train"``: one bsp train step of ``ROWS`` sequences of ``TEXT``
  tokens a pod (the forward, the backward, the gradient sums and the
  update); its loss a 0-d tensor, its state the placed blocks' shapes;
- ``"serve"``: the prefill of ``ROWS`` requests (the rank's rows' whole
  logits) and a decode step under the cache's placements: ``ROWS``
  requests over ``data`` (flash-decode and the heads placement) and
  ``FEW`` requests whole (the length over ``data``) where
  ``sharding.check_cache_placement`` takes it, each cache of ``SLOTS``.

The step runs on ``meta`` tensors as they come (no ``CostMode``): a host
sync raises there, as nothing holds a value.
"""
import dataclasses

from repro_torch import pytree
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun, sharding, specs, steps
from repro_torch.launch.meta import MetaMesh
from repro_torch.models import model

#: requests or sequences a pod, and a second request count below 8 (the
#: whole-batch cache placement); every data axis up to 4 splits ROWS
ROWS, FEW = 12, 4
#: text tokens a sequence (a multiple of the SSM's chunk; the VLM's
#: patches come on top), and the decode cache's slots, which every data
#: axis up to 4 and model axis up to 8 splits
TEXT, SLOTS = 64, 48
MODES = ("train", "serve")


def cut(cfg):
    """``cfg`` at its widths, cut to 2 decoder layers (the RG-LRU hybrid:
    one (rglru, rglru, attn) cycle; the enc-dec's encoder as many):
    every block kind of the arch (deepseek's dense first layer and an
    MoE layer) is kept."""
    n = min(cfg.n_layers, 3 if cfg.rglru is not None else 2)
    kw = {"n_layers": n}
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(cfg.encoder, n_layers=n)
    return dataclasses.replace(cfg, **kw)


def _last(shape):
    return tuple(n - 1 for n in shape)


def _seq(cfg):
    """Tokens a sequence: ``TEXT``, and the VLM's patches."""
    return TEXT + (cfg.modality.n_tokens if cfg.modality.kind == "vision"
                   else 0)


def trace_layout(cfg, shape, mode, coords=None):
    """Trace ``cfg``'s ``mode`` steps on the rank ``coords`` (default: the
    last) of a (pod, data, model) mesh of ``shape``; fails on what the
    model code does not take, and where an output is not the
    placement's shape."""
    cfg = cut(cfg)
    mesh = MetaMesh(shape, coords=coords or _last(shape))
    if mode == "train":
        step, args, _ = dryrun.build_step(
            cfg, InputShape("train", _seq(cfg), ROWS, "train"),
            strategy="bsp", topology=None, mesh=mesh)
        state, metrics = step(*args)
        assert tuple(metrics["loss"].shape) == ()
        assert [tuple(t.shape) for t in pytree.leaves(state["params"])] \
            == [tuple(t.shape) for t in pytree.leaves(args[0]["params"])]
        return
    assert mode == "serve", mode
    mesh = MetaMesh((1,) + tuple(shape[1:]), coords=(0,) + tuple(
        (coords or _last(shape))[1:]))
    D = mesh.size_of("data")
    params = sharding.local_params(steps.param_shape(cfg), mesh)
    batch = specs.as_meta(specs.prefill_batch_specs(
        cfg, InputShape("prefill", _seq(cfg), ROWS, "prefill")))
    logits = steps.make_prefill_step(cfg, mesh=mesh)(params, batch)
    rows = ROWS // D if sharding.splits(ROWS, D) else ROWS
    assert tuple(logits.shape) == (rows, cfg.vocab), logits.shape
    placements = [(ROWS, True, False), (ROWS, True, True)]
    if not (sharding.recurrent(cfg) and D > 1):      # C16
        placements.append((FEW, False, False))
    for B, bs, base in placements:
        cache = model.init_cache(cfg, B, SLOTS, device="meta", mesh=mesh,
                                 batch_sharded=bs, baseline_decode=base)
        dec = specs.as_meta(specs.decode_batch_specs(
            cfg, InputShape("decode", SLOTS, B, "decode")))
        toks, new = steps.make_serve_step(
            cfg, mesh=mesh, batch_sharded=bs, baseline_decode=base)(
            params, cache, dec)
        assert tuple(toks.shape) == (B,), toks.shape
        assert [tuple(t.shape) for t in pytree.leaves(new)] == [
            tuple(t.shape) for t in pytree.leaves(cache)]
