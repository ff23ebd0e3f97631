"""RG-LRU recurrent block (``repro.models.rglru``; RecurrentGemma /
Griffin, arXiv:2402.19427).

The recurrence  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)  is a
first-order linear recurrence.  Over a full sequence the reference
evaluates it with ``jax.lax.associative_scan``; the port with ``scan``,
a log-depth Hillis-Steele doubling of the same ``combine`` in float32
tensor ops (11 rounds at T = 2048), since PyTorch has no associative
scan outside ``torch.compile``.  At decode it is O(1) a token.  a_t =
exp(-c * softplus(Lambda) * r_t) with recurrence gate r_t and input gate
i_t.

Plain tensor code, no kernel: the reference computes it outside any
Pallas call.  The decode writes its new conv history and state into the
cache's own tensors (``transformer.lm_decode`` keeps the cache it was
given), and returns them.

Under ``shard_hints.activation_sharding(mesh)`` (the train and serve
steps inside a pod) a ``model`` rank runs its block of the width's
channels, as the reference places the weights: ``in_x``, ``in_gate``
and ``conv_w`` split by channel (column-parallel), the scan channel-wise
and so local, ``out`` row-parallel.  The gates ``w_a`` and ``w_i`` are
dense (w, w) matrices placed (data, model): the rank's columns of them
read the conv's output whole, gathered over ``model`` (its gradient
reduce-scattered back).  The decode cache stays where the reference
places it: the conv history whole on every ``model`` rank (each rank
gathers the new row of ``in_x`` over ``model`` and writes it), and h
whole too where the placement keeps it so (the requests over ``data``:
the rank's new channels gathered and written), else the rank's
channels.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RGLRUConfig
from repro_torch.device import resolve_device
from repro_torch.launch import collectives as coll
from repro_torch.models.layers import (block_whole, causal_conv,
                                       causal_conv_step, init_linear,
                                       init_normal, linear_apply, softplus)
from repro_torch.models.shard_hints import current_mesh

Params = Dict[str, object]

_C = 8.0  # Griffin's fixed scaling constant


def init_rglru(gen: torch.Generator, r: RGLRUConfig, d_model: int, dtype,
               device=None) -> Params:
    device = resolve_device(device)
    w = r.lru_width or d_model
    lam = torch.log(torch.expm1(-torch.log(torch.linspace(
        0.9, 0.999, w, dtype=torch.float32)) / _C))
    return {
        # gated "recurrent unit" branch + linear gate branch (Griffin block)
        "in_x": init_linear(gen, d_model, w, dtype, device=device),
        "in_gate": init_linear(gen, d_model, w, dtype, device=device),
        "conv_w": init_normal(gen, (r.d_conv, w), r.d_conv ** -0.5, dtype,
                              device),
        "conv_b": torch.zeros(w, dtype=dtype, device=device),
        "w_a": init_linear(gen, w, w, torch.float32, bias=True,
                           device=device),
        "w_i": init_linear(gen, w, w, torch.float32, bias=True,
                           device=device),
        # Lambda init so a^c is in (0.9, 0.999) at r=1 (Griffin appendix)
        "lam": lam.to(device),
        "out": init_linear(gen, w, d_model, dtype, device=device),
    }


def _cols(n_local: int, mesh, whole: bool) -> slice:
    """The ``model`` rank's channels of the width, ``n_local`` of them
    (every channel without a mesh or where the block runs whole)."""
    lo = 0 if mesh is None or whole else \
        mesh.coords.get("model", 0) * n_local
    return slice(lo, lo + n_local)


def _whole(r: RGLRUConfig, d_model: int) -> bool:
    """Whether the block runs whole over the active mesh's ``model`` axis:
    the axis does not split the lru_width rows of ``out``
    (``layers.block_whole``); every width of the block is lru_width, so
    it splits none of them."""
    return block_whole(r.lru_width or d_model)


def _gates(p: Params, xw: torch.Tensor, width: int = 0, mesh=None,
           whole: bool = False):
    """(a, sqrt(1 - a^2) * i * x), float32, on the channels of ``xw``;
    under a mesh (``width`` the whole lru_width) the rank's (every channel
    where the block runs whole), the gates' input ``xw`` gathered
    whole."""
    xf = xw.float()
    xin = xf if mesh is None else coll.gather_model(
        xw, xw.dim() - 1, mesh, not whole).float()
    shape = (width, width)
    r_g = torch.sigmoid(linear_apply(p["w_a"], xin, "col", shape, whole))
    i_g = torch.sigmoid(linear_apply(p["w_i"], xin, "col", shape, whole))
    lam = p["lam"][_cols(xw.shape[-1], mesh, whole)]
    log_a = -_C * softplus(lam) * r_g                   # (..., w), <= 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-12, 1.0))
    return a, beta * i_g * xf


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, no activation.  x: (B, T, w)."""
    return causal_conv(x, w, b).to(x.dtype)


def scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1: the
    reference's ``associative_scan`` of ``combine((a1, b1), (a2, b2)) =
    (a1 a2, a2 b1 + b2)``, as ceil(log2 T) rounds of Hillis-Steele
    doubling (each position combined with the one ``s`` before it, s = 1,
    2, 4, ...).  Without autograd (prefill) a round writes its (a, b) into
    one of two buffers of its own (the first ``s`` positions copied, the
    rest one fused op each), never into its inputs; the buffers
    alternate.  Where autograd records (grad mode on and an input that
    requires grad), which ops with ``out=`` do not support, a round
    concatenates the same ops' results instead: the same numbers."""
    T = a.shape[1]
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        s = 1
        while s < T:
            b = torch.cat([b[:, :s], torch.addcmul(b[:, s:], a[:, s:],
                                                   b[:, :-s])], dim=1)
            if 2 * s < T:
                a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
            s *= 2
        return b
    a_buf = (torch.empty_like(a), torch.empty_like(a))
    b_buf = (torch.empty_like(b), torch.empty_like(b))
    s, r = 1, 0
    while s < T:
        a_new, b_new = a_buf[r % 2], b_buf[r % 2]
        b_new[:, :s] = b[:, :s]
        torch.addcmul(b[:, s:], a[:, s:], b[:, :-s], out=b_new[:, s:])
        if 2 * s < T:               # the last round needs no new a
            a_new[:, :s] = a[:, :s]
            torch.mul(a[:, s:], a[:, :-s], out=a_new[:, s:])
        a, b = a_new, b_new
        s, r = 2 * s, r + 1
    return b


def _in(x: torch.Tensor, mesh, whole: bool) -> torch.Tensor:
    """*f* on the block's input under a mesh where the block runs split
    (in_x and in_gate are column-parallel)."""
    return x if mesh is None else coll.copy_to_model(x, mesh, not whole)


def rglru_apply(p: Params, r: RGLRUConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence path.  x: (B, T, d_model); under a mesh on the rank's
    channels, ``out`` row-parallel (every channel, ``out`` whole, where
    the block runs whole)."""
    mesh = current_mesh()
    d = x.shape[-1]
    w = r.lru_width or d
    whole = _whole(r, d)
    x = _in(x, mesh, whole)
    gate = F.gelu(linear_apply(p["in_gate"], x, "col", (d, w), whole),
                  approximate="tanh")
    xw = linear_apply(p["in_x"], x, "col", (d, w), whole)
    xw = _conv(xw, p["conv_w"],
               p["conv_b"][_cols(xw.shape[-1], mesh, whole)])
    a, b = _gates(p, xw, w, mesh, whole)                 # (B,T,w) fp32
    h = scan(a, b)
    y = h.to(x.dtype) * gate
    return linear_apply(p["out"], y, "row", (w, d), whole)


def rglru_init_state(r: RGLRUConfig, d_model: int, batch: int, dtype,
                     device=None) -> Params:
    """The conv history in the model's dtype, h in float32."""
    device = resolve_device(device)
    w = r.lru_width or d_model
    return {
        "conv": torch.zeros(batch, r.d_conv - 1, w, dtype=dtype,
                            device=device),
        "h": torch.zeros(batch, w, dtype=torch.float32, device=device),
    }


def rglru_decode(p: Params, r: RGLRUConfig, x: torch.Tensor, state: Params
                 ) -> Tuple[torch.Tensor, Params]:
    """One-token decode.  x: (B, 1, d_model).  The new conv history and h
    are written into ``state``'s tensors, which are returned.  Under a
    mesh ``state`` is the rank's block: the conv history whole, h whole
    or the rank's channels (the module docstring)."""
    mesh = current_mesh()
    d = x.shape[-1]
    w = r.lru_width or d
    whole = _whole(r, d)
    x0 = _in(x[:, 0], mesh, whole)
    gate = F.gelu(linear_apply(p["in_gate"], x0, "col", (d, w), whole),
                  approximate="tanh")
    xw_t = linear_apply(p["in_x"], x0, "col", (d, w), whole)
    cols = _cols(xw_t.shape[-1], mesh, whole)
    row = xw_t if mesh is None else coll.gather_model(xw_t, 1, mesh,
                                                      not whole)
    hist = torch.cat([state["conv"], row[:, None]], dim=1)
    xw = causal_conv_step(hist[..., cols], p["conv_w"],
                          p["conv_b"][cols]).to(x.dtype)
    a, b = _gates(p, xw, w, mesh, whole)
    full_h = state["h"].shape[-1] != xw.shape[-1]
    h = a * (state["h"][:, cols] if full_h else state["h"]) + b
    y = h.to(x.dtype) * gate
    out = linear_apply(p["out"], y, "row", (w, d), whole)[:, None]
    state["conv"].copy_(hist[:, 1:])
    state["h"].copy_(coll.gather_model(h, 1, mesh) if full_h else h)
    return out, state
