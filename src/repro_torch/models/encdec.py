"""Encoder stack of the enc-dec archs (``repro.models.encdec``; the
seamless-m4t backbone).

The modality frontend (mel-spectrogram and conv feature extractor) is
stubbed, as in the reference: the caller hands over precomputed frame
embeddings (B, n_frames, feat_dim).  The encoder is the transformer
stack that consumes them, bidirectional self-attention without RoPE
through ``chunked_attention(causal=False)`` (on a CUDA tensor the
hand-written ``flash_attention`` kernel) over the config's norm and the
gated MLP; the decoder is ``transformer.py``'s stack with
cross-attention to the encoder's output.  The layers' parameters are
stacked on a leading axis, as the reference stacks them for its
``lax.scan``, which becomes a Python loop over the layers here.

Under ``shard_hints.activation_sharding(mesh)`` (the train and serve
steps inside a pod) ``in_proj``'s output is whole on every rank, as the
residual stream is (its weight gathered over each axis that splits it:
``linear_apply(..., whole=True)``; the backward keeps the rank's block of
the gradient), and each layer runs the GQA column and row routes on the
rank's n_heads / M heads (every head where ``sharding.heads_whole``, as
``attention.py`` runs them; the whole block where the ``model`` axis
does not split wo's rows), non-causal, and the gated MLP on its d_ff
columns (all of them where the axis does not split d_ff); the
LayerNorms are replicated.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch import collectives as coll
from repro_torch.launch.sharding import heads_whole
from repro_torch.models import attention as attn
from repro_torch.models.layers import (NORM_APPLY, block_whole,
                                       gated_mlp_apply, init_gated_mlp,
                                       init_linear, linear_apply, make_norm)
from repro_torch.models.shard_hints import axis_env_size, current_mesh
from repro_torch.models.transformer import _cycle, _dtype, _stacked

Params = Dict[str, object]


def init_encoder_layer(gen: torch.Generator, cfg: ModelConfig,
                       device=None) -> Params:
    ed = cfg.encoder.d_model
    a = cfg.attention
    dt = _dtype(cfg)
    norm_init, _ = make_norm(cfg.norm, ed, device)
    hd = a.n_heads * a.head_dim
    return {
        "norm1": norm_init(), "norm2": norm_init(),
        "wq": init_linear(gen, ed, hd, dt, device=device),
        "wk": init_linear(gen, ed, hd, dt, device=device),
        "wv": init_linear(gen, ed, hd, dt, device=device),
        "wo": init_linear(gen, hd, ed, dt, device=device),
        "ffn": init_gated_mlp(gen, ed, cfg.d_ff, dt, device),
    }


def init_encoder(gen: torch.Generator, cfg: ModelConfig,
                 device=None) -> Params:
    device = resolve_device(device)
    e = cfg.encoder
    norm_init, _ = make_norm(cfg.norm, e.d_model, device)
    return {
        "in_proj": init_linear(gen, cfg.modality.feat_dim, e.d_model,
                               _dtype(cfg), device=device),
        "layers": _stacked(e.n_layers,
                           lambda _: init_encoder_layer(gen, cfg, device)),
        "final_norm": norm_init(),
    }


def encoder_apply(p: Params, cfg: ModelConfig, frames: torch.Tensor
                  ) -> torch.Tensor:
    """frames: (B, S, feat_dim) -> memory (B, S, encoder d_model); under a
    mesh the rank's rows, whole (the module docstring)."""
    a = cfg.attention
    hd = a.head_dim
    ed = cfg.encoder.d_model
    n = a.n_heads * hd
    norm_apply = NORM_APPLY[cfg.norm]
    mesh = current_mesh()
    whole = block_whole(n)
    hw = mesh is not None and not whole and heads_whole(
        a, axis_env_size("model"))
    x = linear_apply(p["in_proj"], frames.to(_dtype(cfg)), "col",
                     (cfg.modality.feat_dim, ed), whole=True)
    B, S, _ = x.shape
    for i in range(cfg.encoder.n_layers):
        lp = _cycle(p["layers"], i)
        hh = norm_apply(lp["norm1"], x)
        if mesh is not None:
            hh = coll.copy_to_model(hh, mesh, not whole)
        q, k, v = (attn._head_cols(linear_apply(lp[w], hh, "col", (ed, n),
                                                whole), hw,
                                   mesh).reshape(B, S, -1, hd)
                   for w in ("wq", "wk", "wv"))
        y = attn.chunked_attention(q, k, v, causal=False)
        x = x + attn._out(lp, a, y.reshape(B, S, -1), ed, hd)
        x = x + gated_mlp_apply(lp["ffn"], norm_apply(lp["norm2"], x),
                                cfg.d_ff)
    return norm_apply(p["final_norm"], x)
