"""Serve steps of the LM (``repro.launch.steps``): prefill and one-token
decode.  The train steps and the mesh wait for the port's distributed
backend (ROADMAP A11).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import decode_step, forward


def make_prefill_step(cfg: ModelConfig, *, chunk: int = 512) -> Callable:
    """``prefill_step(params, batch)``: the next-token logits (B, V)
    float32 of a full-sequence forward of ``batch`` (its ``"tokens"``,
    and for the VLM its ``"patches"``, which ``forward`` prepends)."""
    def prefill_step(params, batch):
        logits, _ = forward(params, cfg, batch, chunk=chunk)
        return logits[:, -1]
    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """``serve_step(params, cache, batch)``: one decode step and its greedy
    next token, (int32 (B,), cache)."""
    def serve_step(params, cache, batch):
        logits, new_cache = decode_step(params, cfg, batch, cache)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, new_cache
    return serve_step
