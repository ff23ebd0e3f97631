"""Serve steps of the LM (``repro.launch.steps``): prefill and one-token
decode.  The train steps and the mesh wait for the port's distributed
backend (ROADMAP A11).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import decode_step, forward
from repro_torch.models.transformer import lm_decode


def make_prefill_step(cfg: ModelConfig, *, chunk: int = 512) -> Callable:
    """``prefill_step(params, batch)``: the next-token logits (B, V)
    float32 of a full-sequence forward of ``batch`` (its ``"tokens"``;
    for the VLM its ``"patches"``, which ``forward`` prepends; for the
    enc-dec its ``"frames"``, which the encoder reads)."""
    def prefill_step(params, batch):
        logits, _ = forward(params, cfg, batch, chunk=chunk)
        return logits[:, -1]
    return prefill_step


def make_serve_step(cfg: ModelConfig,
                    memory: Optional[torch.Tensor] = None) -> Callable:
    """``serve_step(params, cache, batch)``: one decode step and its greedy
    next token, (int32 (B,), cache).  For an enc-dec arch, ``memory``
    (the encoder's output on the requests' frames, computed once) is
    read by every step through ``transformer.lm_decode``, where
    ``decode_step`` would run the encoder on ``batch["frames"]`` each
    step."""
    def serve_step(params, cache, batch):
        if memory is None:
            logits, new_cache = decode_step(params, cfg, batch, cache)
        else:
            logits, new_cache = lm_decode(params, cfg, batch["token"], cache,
                                          batch["t"], memory=memory)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, new_cache
    return serve_step
