"""Shape and dtype stand-ins for every model input
(``repro.launch.specs``): nothing is allocated.

Each spec maps an input's name to ``(shape, torch dtype)``; ``as_meta``
turns a spec into ``meta`` tensors, what ``sharding``'s rules read.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig

Spec = Tuple[Tuple[int, ...], torch.dtype]


def text_len(cfg: ModelConfig, seq_len: int) -> int:
    """VLM: vision patch tokens occupy part of the sequence budget."""
    if cfg.modality.kind == "vision":
        return seq_len - cfg.modality.n_tokens
    return seq_len


def _extras(cfg: ModelConfig, lead: Tuple[int, ...]) -> Dict[str, Spec]:
    """The VLM's patches and the enc-dec's frames, after ``lead`` dims."""
    out: Dict[str, Spec] = {}
    if cfg.modality.kind == "vision":
        out["patches"] = (lead + (cfg.modality.n_tokens,
                                  cfg.modality.feat_dim), torch.bfloat16)
    if cfg.encoder is not None:
        out["frames"] = (lead + (cfg.encoder.n_frames,
                                 cfg.modality.feat_dim), torch.bfloat16)
    return out


def train_batch_specs(cfg: ModelConfig, shape: InputShape, *,
                      n_pods: int = 1) -> Dict[str, Spec]:
    """(n_pods, global_batch / n_pods, T) tokens and labels, and the
    arch's extra inputs."""
    if shape.global_batch % n_pods:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"over {n_pods} pods")
    b = shape.global_batch // n_pods
    T = text_len(cfg, shape.seq_len)
    return {"tokens": ((n_pods, b, T), torch.int32),
            "labels": ((n_pods, b, T), torch.int32),
            **_extras(cfg, (n_pods, b))}


def prefill_batch_specs(cfg: ModelConfig, shape: InputShape
                        ) -> Dict[str, Spec]:
    b = shape.global_batch
    return {"tokens": ((b, text_len(cfg, shape.seq_len)), torch.int32),
            **_extras(cfg, (b,))}


def decode_batch_specs(cfg: ModelConfig, shape: InputShape
                       ) -> Dict[str, Spec]:
    b = shape.global_batch
    # an enc-dec's frames: the encoder memory is computed at prefill time
    specs = {"token": ((b,), torch.int32), "t": ((b,), torch.int32)}
    if cfg.encoder is not None:
        specs.update(_extras(cfg, (b,)))
    return specs


def input_specs(cfg: ModelConfig, shape_name: str, *, n_pods: int = 1
                ) -> Dict[str, Spec]:
    shape = INPUT_SHAPES[shape_name]
    if shape.mode == "train":
        return train_batch_specs(cfg, shape, n_pods=n_pods)
    if shape.mode == "prefill":
        return prefill_batch_specs(cfg, shape)
    return decode_batch_specs(cfg, shape)


def as_meta(specs: Dict[str, Spec]) -> Dict[str, torch.Tensor]:
    """The specs as ``meta`` tensors (no storage)."""
    return {k: torch.empty(s, dtype=d, device="meta")
            for k, (s, d) in specs.items()}
