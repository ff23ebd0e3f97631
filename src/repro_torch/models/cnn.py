"""CNN models for the paper's own study (image classification), in PyTorch.

LeNet / BN-LeNet / GN-LeNet / BRN-LeNet / AlexNet-s / ResNet-s, as in
``repro.models.cnn``.  Parameters and BatchNorm state are flat dicts of
tensors keyed like a ``state_dict`` (``"conv.0.w"``, ``"norm.0.mean"``,
``"out.b"``), and ``cnn_apply`` is a pure function of them, so per-node
gradients come from ``torch.func.vmap`` over a stacked node axis.

Layouts: images enter in NHWC, as in the reference, and run as NCHW
inside; conv weights are OIHW; fully connected weights are (d_in, d_out)
and the conv features are flattened in (H, W, C) order, so
:func:`cnn_params_from_jax` moves the reference's parameters across with
only the conv weights transposed.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.cnn_zoo import CNNConfig
from repro_torch.models.layers import (batchnorm_apply, batchrenorm_apply,
                                       groupnorm_apply, init_batchnorm,
                                       init_groupnorm)

Params = Dict[str, torch.Tensor]

#: a conv weight's dims in the reference's layout (HWIO), as positions in
#: this module's (OIHW)
HWIO_FROM_OIHW = (2, 3, 1, 0)


def reference_perm(name: str) -> Optional[Tuple[int, ...]]:
    """How parameter ``name`` (one node's) is permuted from this module's
    layout into ``repro.models.cnn``'s: conv weights OIHW -> HWIO, every
    other tensor as it is."""
    if name.startswith("conv.") and name.endswith(".w"):
        return HWIO_FROM_OIHW
    return None


def _prefixed(prefix: str, d: Mapping[str, torch.Tensor]) -> Params:
    return {f"{prefix}.{k}": v for k, v in d.items()}


def _sub(tree: Mapping[str, torch.Tensor], prefix: str) -> Params:
    """The entries of a flat dict under ``prefix.``, with it stripped."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in tree.items() if k.startswith(prefix + ".")}


def init_cnn(generator: torch.Generator, cfg: CNNConfig
             ) -> Tuple[Params, Params]:
    """Returns (params, state) as float32 CPU tensors drawn from
    ``generator`` (He-normal convs and fc layers, zero biases).  state =
    BatchNorm running stats (empty for the other norms)."""
    randn = lambda *shape: torch.randn(*shape, generator=generator)
    params: Params = {}
    state: Params = {}
    c_in, side = cfg.in_channels, cfg.image_size
    for i, (c, k) in enumerate(zip(cfg.conv_channels, cfg.kernel_sizes)):
        params[f"conv.{i}.w"] = randn(c, c_in, k, k) * (2.0 / (k * k * c_in)) ** 0.5
        params[f"conv.{i}.b"] = torch.zeros(c)
        if cfg.norm in ("batch", "batchrenorm"):
            np_, ns = init_batchnorm(c)
            params.update(_prefixed(f"norm.{i}", np_))
            state.update(_prefixed(f"norm.{i}", ns))
        elif cfg.norm == "group":
            params.update(_prefixed(f"norm.{i}",
                                    init_groupnorm(c, cfg.group_size)))
        if cfg.pool_after[i]:
            side //= 2
        c_in = c
    d = side * side * c_in
    for j, fd in enumerate(cfg.fc_dims):
        params[f"fc.{j}.w"] = randn(d, fd) * (2.0 / d) ** 0.5
        params[f"fc.{j}.b"] = torch.zeros(fd)
        d = fd
    params["out.w"] = randn(d, cfg.n_classes) * d ** -0.5
    params["out.b"] = torch.zeros(cfg.n_classes)
    return params, state


def _conv(params: Params, i: int, x: torch.Tensor) -> torch.Tensor:
    w = params[f"conv.{i}.w"]
    # odd kernels at stride 1: the reference's "SAME" padding is k // 2
    return F.conv2d(x, w, params[f"conv.{i}.b"], padding=w.shape[-1] // 2)


def cnn_apply(params: Params, state: Params, cfg: CNNConfig,
              images: torch.Tensor, *, train: bool
              ) -> Tuple[torch.Tensor, Params]:
    """images: (B, H, W, C).  Returns (logits, new_state)."""
    x = images.permute(0, 3, 1, 2)
    new_state: Params = {}
    prev_block = None
    for i in range(len(cfg.conv_channels)):
        y = _conv(params, i, x)
        np_ = _sub(params, f"norm.{i}")
        if cfg.norm in ("batch", "batchrenorm") and np_:
            apply = batchnorm_apply if cfg.norm == "batch" \
                else batchrenorm_apply
            y, ns = apply(np_, _sub(state, f"norm.{i}"), y, train=train)
            new_state.update(_prefixed(f"norm.{i}", ns))
        elif cfg.norm == "group" and np_:
            y = groupnorm_apply(np_, y, group_size=cfg.group_size)
        y = F.relu(y)
        if cfg.residual and prev_block is not None \
                and prev_block.shape == y.shape:
            y = y + prev_block
        prev_block = y
        x = y
        if cfg.pool_after[i]:
            x = F.max_pool2d(x, 2, 2)
            prev_block = None
    # flatten in (H, W, C) order, as the reference's NHWC reshape does
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    for j in range(len(cfg.fc_dims)):
        x = F.relu(x @ params[f"fc.{j}.w"] + params[f"fc.{j}.b"])
    return x @ params["out.w"] + params["out.b"], new_state


def cnn_batch_stats(params: Params, cfg: CNNConfig, images: torch.Tensor,
                    layer: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minibatch (mu_B, biased var_B) per channel at conv ``layer`` — the
    probe behind the paper's Figure 4 divergence analysis."""
    x = images.permute(0, 3, 1, 2)
    for i in range(len(cfg.conv_channels)):
        y = _conv(params, i, x)
        if i == layer:
            mu = y.mean(dim=(0, 2, 3))
            var = (y - mu[None, :, None, None]).square().mean(dim=(0, 2, 3))
            return mu, var
        # continue through the network as if normless
        x = F.relu(y)
        if cfg.pool_after[i]:
            x = F.max_pool2d(x, 2, 2)
    raise ValueError(f"layer {layer} out of range")


def _flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts/lists of arrays -> {"a.0.b": array}."""
    if isinstance(tree, Mapping):
        items: Sequence = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(_flatten_tree(v, f"{prefix}.{k}" if prefix else k))
    return out


def cnn_params_from_jax(params_np: Any, state_np: Any, cfg: CNNConfig
                        ) -> Tuple[Params, Params]:
    """Carry a ``repro.models.cnn`` pytree across: ``params_np`` and
    ``state_np`` are its (params, state) as nested dicts and lists of
    NumPy arrays (any leading node axes are kept).  Returns this
    module's (params, state) as float32 CPU tensors, with the HWIO conv
    weights transposed to OIHW.  Works for any tree shaped like the
    parameters, e.g. their gradients."""
    params = {}
    for k, a in _flatten_tree(params_np).items():
        t = torch.from_numpy(np.array(a, np.float32))
        perm = reference_perm(k)
        if perm is not None:
            lead = t.dim() - 4          # HWIO after any node axes
            t = t.permute(*range(lead),
                          *(lead + perm.index(d) for d in range(4)))
        params[k] = t.contiguous()
    state = {k: torch.from_numpy(np.array(a, np.float32))
             for k, a in _flatten_tree(state_np).items()}
    expected = set(init_cnn(torch.Generator().manual_seed(0), cfg)[0])
    if set(params) != expected:
        raise ValueError(f"parameter names {sorted(params)} do not match "
                         f"{cfg.name}'s {sorted(expected)}")
    return params, state
