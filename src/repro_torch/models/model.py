"""Top-level LM API of the port (``repro.models.model``): one entry point
per operation, for every arch of the registry (dense GQA, MLA, MoE, the
VLM, the RG-LRU hybrid, the SSM and the enc-dec;
``repro_torch.configs.registry``).

``batch`` layout:
- train/prefill: {"tokens": (B, T_text) integer, ["labels": (B, T_text)
  integer, for ``loss_fn``; a negative label is masked out], ["patches":
  (B, n_vis, feat_dim) float, for the VLM], ["frames": (B, n_frames,
  feat_dim) float, for the enc-dec]}
- decode: {"token": (B,) integer, "t": (B,) integer absolute positions,
  ["frames": as above]}, with the cache from ``init_cache``.  As in the
  reference, an enc-dec decode step runs the encoder on its frames
  every step; a serving loop that computes the memory once calls
  ``transformer.lm_decode(..., memory=)`` itself.

``lm_params_from_jax`` carries the reference's ``init_model`` parameters
(as NumPy arrays) into the port, so both packages can run the same
weights.  ``loss_fn`` is the training loss (``launch.steps``' train step
differentiates it).

Parameters and caches go to ``device``, which defaults to CUDA and
raises where there is none (``repro_torch.device.resolve_device``); the
CPU runs them only when the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch import collectives as coll
from repro_torch.launch import sharding
from repro_torch.models import encdec, transformer
from repro_torch.models.shard_hints import current_mesh

Params = Dict[str, Any]


def init_model(gen: torch.Generator, cfg: ModelConfig,
               device=None) -> Params:
    """Random parameters drawn from ``gen`` (on its device), every leaf
    placed on ``device``; an enc-dec arch's encoder under
    ``"encoder"``."""
    p = transformer.init_lm(gen, cfg, device)
    if cfg.encoder is not None:
        p["encoder"] = encdec.init_encoder(gen, cfg, device)
    return p


def _memory(p: Params, cfg: ModelConfig, batch: Dict[str, Any]
            ) -> Optional[torch.Tensor]:
    if cfg.encoder is None:
        return None
    return encdec.encoder_apply(p["encoder"], cfg, batch["frames"])


def forward(p: Params, cfg: ModelConfig, batch: Dict[str, Any], *,
            remat: bool = True, chunk: int = 512, moe_route: str = "dense"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits (B, T_text, V) float32,
    moe_aux), the MoE auxiliary loss summed over layers, a float32 zero
    for a dense arch.  ``remat``: ``transformer.lm_apply``'s (each cycle
    recomputed in the backward; nothing changes without grad mode).
    ``moe_route``: the MoE layers' function, ``"dense"`` or ``"ep"``
    (``moe.moe_apply``)."""
    return transformer.lm_apply(p, cfg, batch["tokens"],
                                patches=batch.get("patches"),
                                memory=_memory(p, cfg, batch), remat=remat,
                                chunk=chunk, moe_route=moe_route)


def loss_fn(p: Params, cfg: ModelConfig, batch: Dict[str, Any], *,
            remat: bool = True, chunk: int = 512, moe_route: str = "dense"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss: (ce + aux, {"ce": ce, "aux": aux}), float32 0-d.
    ce is the mean over the positions with ``batch["labels"] >= 0`` of
    the float32 ``log_softmax``'s negative log-likelihood of the label
    (``max(count, 1)`` in the denominator); aux the MoE auxiliary loss.
    A negative label is gathered at class 0 and masked out (the
    reference gathers it at the last class; torch's gather refuses a
    negative index), so the two give one loss and one gradient.
    ``moe_route``: the MoE layers' function (``forward``'s).

    Under ``shard_hints.activation_sharding(mesh)`` ``p`` holds the rank's
    blocks and ``batch`` its ``data`` share of the pod's sequences, and
    the loss is the pod's (``_sharded_ce``), the same on every rank of
    the pod."""
    logits, aux = forward(p, cfg, batch, remat=remat, chunk=chunk,
                          moe_route=moe_route)
    labels = batch["labels"]
    mesh = current_mesh()
    if mesh is not None:
        ce = _sharded_ce(logits, labels, mesh, sharding.vocab_whole(
            cfg.vocab, mesh.size_of("model")))
        return ce + aux, {"ce": ce, "aux": aux}
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp_min(0)[..., None].long()
                        )[..., 0]
    mask = (labels >= 0).float()
    ce = (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return ce + aux, {"ce": ce, "aux": aux}


def _sharded_ce(logits: torch.Tensor, labels: torch.Tensor, mesh,
                whole_vocab: bool = False) -> torch.Tensor:
    """The vocabulary-parallel cross-entropy of a pod, from the rank's
    (B / D, T, V / M) logits: the row max all-reduced (MAX) over
    ``model`` and held constant (the log-sum-exp does not depend on it);
    the sum of exp and the label's shifted logit (from the rank that owns
    the label's column, zero elsewhere) summed over ``model``; the
    negative log-likelihood's masked sum and the count of labels >= 0
    summed over ``data``, so the mean is over the pod's labels, not the
    rank's.  With ``whole_vocab`` the logits hold every column on every
    ``model`` rank, and nothing is summed over ``model``."""
    n = logits.shape[-1]
    top = logits.detach().amax(dim=-1, keepdim=True)
    if not whole_vocab:
        mesh.all_reduce(top, "model", op=dist.ReduceOp.MAX)
    z = logits - top
    local = labels.long() - (0 if whole_vocab else
                             mesh.coords.get("model", 0) * n)
    mine = (local >= 0) & (local < n) & (labels >= 0)
    picked = torch.gather(z, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    picked = torch.where(mine, picked, torch.zeros((), dtype=z.dtype,
                                                   device=z.device))
    sums = torch.stack([z.exp().sum(dim=-1), picked])
    if not whole_vocab:
        sums = coll.reduce_from_model(sums, mesh)
    nll = sums[0].log() - sums[1]
    mask = (labels >= 0).float()
    num_count = coll.reduce_from_data(torch.stack([(nll * mask).sum(),
                                                   mask.sum()]), mesh)
    return num_count[0] / num_count[1].clamp_min(1.0)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               long_mode: bool = False, device=None, *, mesh=None,
               batch_sharded: Optional[bool] = None,
               baseline_decode: bool = False) -> Params:
    """The decode cache of ``batch`` requests; on an intra-pod ``mesh``
    the rank's block of it (``transformer.lm_init_cache``)."""
    return transformer.lm_init_cache(cfg, batch, cache_len, long_mode,
                                     device, mesh=mesh,
                                     batch_sharded=batch_sharded,
                                     baseline_decode=baseline_decode)


def decode_step(p: Params, cfg: ModelConfig, batch: Dict[str, Any],
                cache: Params, *, moe_route: str = "dense",
                split: Optional[str] = None) -> Tuple[torch.Tensor, Params]:
    """One serve step: next-token logits (B, V) float32 and the cache,
    updated in place.  Under a mesh, ``transformer.lm_decode``'s blocks
    and ``split``."""
    return transformer.lm_decode(p, cfg, batch["token"], cache, batch["t"],
                                 memory=_memory(p, cfg, batch),
                                 moe_route=moe_route, split=split)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def lm_params_from_jax(tree: Any, device=None) -> Any:
    """The reference's ``init_model`` parameter tree, its leaves as NumPy
    arrays (``jax.tree_util.tree_map(np.asarray, params)``), as the
    port's: the same dicts, lists and keys, the stacked ``"body"`` and
    the enc-dec's ``"encoder"`` (its stacked ``"layers"``) kept, every
    leaf a tensor of the same dtype and bits on ``device``, also where
    the dtypes of a tree mix (the SSM's float32 ``A_log``, ``dt_bias``
    and ``D`` and the RG-LRU's float32 gates and ``lam`` in a bfloat16
    model)."""
    return _from_jax(tree, resolve_device(device))


def _from_jax(tree: Any, device: torch.device) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_from_jax(v, device) for v in tree]
    return _tensor(tree, device)
