"""The port's LM training path against the JAX reference, on the CPU.

The same NumPy inputs, made from a seed, go through ``repro`` and
``repro_torch``; the weights are the reference's ``init_model``'s, carried
across by ``lm_params_from_jax``.  On the CPU the port's attention is its
plain version, differentiated through ``ops.FlashAttention`` (the plain
forward, the chunked plain backward ``ref.flash_attention_bthd_bwd_ref``);
the reference differentiates its jnp attention.  Everything in float32.

Tolerances:
- ``loss_fn`` on the ten reduced archs: the loss within 1e-4, each
  gradient leaf within 1e-4 x max(1, max|reference leaf|) (float32 sums
  taken in another order by XLA and ATen through two to five layers and
  their backward);
- remat against no remat in the port: 1e-6 (the same ops, run again);
- the attention's gradients against autograd through the plain version:
  1e-5.

The train step a strategy, the DGC threshold and the training example
are in ``test_torch_lm_step.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro.configs.registry import get_config as jax_get_config
from repro.models import model as jax_model
from repro_torch import pytree
from repro_torch.configs import registry
from repro_torch.kernels import ops, ref
from repro_torch.models import model

LOSS_TOL = 1e-4
GRAD_TOL = 1e-4
REMAT_TOL = 1e-6
ATTN_TOL = 1e-5


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _normal(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _to_torch(tree):
    return model.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                    "cpu")


def _leaf_close(got, want, tol, what=""):
    """Each leaf of ``got`` (the port's, in JAX's order) within ``tol`` x
    max(1, max|want leaf|) of ``want``'s."""
    gl, wl = pytree.leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl), (what, len(gl), len(wl))
    for i, (g, w) in enumerate(zip(gl, wl)):
        w = _np32(w)
        assert tuple(g.shape) == w.shape, (what, i, g.shape, w.shape)
        bound = tol * max(1.0, float(np.abs(w).max(initial=0.0)))
        err = float(np.abs(_np32(g) - w).max(initial=0.0))
        assert err <= bound, (what, i, tuple(w.shape), err, bound)


# ---------------------------------------------------------------------------
# (i) loss_fn and its gradient on the ten reduced archs
# ---------------------------------------------------------------------------

#: (arch, config fields replaced in the reduced config, T): gemma2 and
#: starcoder2 past their reduced window of 64; mamba2 over two SSD chunks
#: of 32; recurrentgemma with one (rglru, rglru, attn) cycle and an RG-LRU
#: suffix; phi-3-vision with its 8 reduced patches, seamless with 16
#: reduced frames
ARCH_CASES = [("qwen3-0.6b", {}, 24), ("gemma2-9b", {}, 96),
              ("starcoder2-3b", {}, 96), ("phi-3-vision-4.2b", {}, 24),
              ("deepseek-v2-lite-16b", {}, 24), ("deepseek-v2-236b", {}, 24),
              ("minicpm3-4b", {}, 24), ("mamba2-780m", {}, 64),
              ("recurrentgemma-2b", {"n_layers": 5}, 48),
              ("seamless-m4t-large-v2", {}, 24)]


def _case(arch, kw, T, B=2, seed=13):
    """The reduced config of both packages, the reference's weights (and
    the port's copy) and one batch with labels, a sixth of them -1."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **kw)
    cfg = dataclasses.replace(registry.get_config(arch).reduced(), **kw)
    jp = jax_model.init_model(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    labels[rng.random((B, T)) < 1 / 6] = -1
    nb = {"tokens": toks, "labels": labels}
    if cfg.modality.kind == "vision":
        nb["patches"] = _normal(seed + 1, B, cfg.modality.n_tokens,
                                cfg.modality.feat_dim)
    if cfg.encoder is not None:
        nb["frames"] = _normal(seed + 2, B, cfg.encoder.n_frames,
                               cfg.modality.feat_dim)
    batch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
             else torch.from_numpy(v) for k, v in nb.items()}
    return jcfg, cfg, jp, nb, batch


def _port_value_and_grad(p, cfg, batch, remat=True):
    p = pytree.tree_map(lambda t: t.detach().requires_grad_(), p)
    loss, parts = model.loss_fn(p, cfg, batch, remat=remat)
    grads = torch.autograd.grad(loss, pytree.leaves(p))
    return loss, parts, pytree.unflatten(p, list(grads))


@pytest.mark.parametrize("arch,kw,T", ARCH_CASES,
                         ids=[c[0] for c in ARCH_CASES])
def test_loss_fn_and_grad_match_jax(arch, kw, T):
    jcfg, cfg, jp, nb, batch = _case(arch, kw, T)
    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        lambda p_, b_: jax_model.loss_fn(p_, jcfg, b_), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in nb.items()})
    loss, parts, grads = _port_value_and_grad(_to_torch(jp), cfg, batch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0,
                               atol=LOSS_TOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(parts[k].detach()), float(jparts[k]),
                                   rtol=0, atol=LOSS_TOL)
    if cfg.moe.n_experts:
        assert float(parts["aux"].detach()) > 0.0
    _leaf_close(grads, jgrads, GRAD_TOL, arch)


def test_loss_fn_masks_negative_labels():
    """Only the labels >= 0 count, and a batch of -1 labels gives ce 0
    and a zero gradient, as in the reference."""
    _, cfg, jp, nb, batch = _case("qwen3-0.6b", {}, 8)
    p = _to_torch(jp)
    keep = batch["labels"] >= 0
    logits, _ = model.forward(p, cfg, batch)
    logp = torch.log_softmax(logits, -1)
    want = -logp[keep].gather(-1, batch["labels"][keep][:, None])[:, 0]
    loss, parts = model.loss_fn(p, cfg, batch)
    torch.testing.assert_close(parts["ce"], want.mean(), rtol=1e-6,
                               atol=1e-6)
    none = dict(batch, labels=torch.full_like(batch["labels"], -1))
    loss, parts, grads = _port_value_and_grad(p, cfg, none)
    assert float(parts["ce"]) == 0.0
    assert all(float(g.abs().max()) == 0.0 for g in pytree.leaves(grads))


# ---------------------------------------------------------------------------
# (ii) remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kw,T", [ARCH_CASES[0], ARCH_CASES[4],
                                       ARCH_CASES[8]],
                         ids=["qwen3-0.6b", "deepseek-v2-lite-16b",
                              "recurrentgemma-2b"])
def test_remat_matches_no_remat(arch, kw, T):
    """Each body cycle recomputed in the backward gives the loss and the
    gradient that keeping every activation does."""
    _, cfg, jp, _, batch = _case(arch, kw, T)
    p = _to_torch(jp)
    assert p["body"] is not None
    loss_r, _, grads_r = _port_value_and_grad(p, cfg, batch, remat=True)
    loss_n, _, grads_n = _port_value_and_grad(p, cfg, batch, remat=False)
    np.testing.assert_allclose(float(loss_r), float(loss_n), rtol=0,
                               atol=REMAT_TOL)
    for gr, gn in zip(pytree.leaves(grads_r), pytree.leaves(grads_n)):
        torch.testing.assert_close(gr, gn, rtol=0, atol=REMAT_TOL)


# ---------------------------------------------------------------------------
# (v) the attention's autograd route
# ---------------------------------------------------------------------------

#: (B, Tq, Tk, H, Hkv, Dk, Dv) and the mask options
ATTN_CASES = [
    ((2, 40, 40, 4, 4, 16, 16), dict(causal=True)),
    ((2, 40, 40, 4, 2, 16, 16), dict(causal=True, window=9)),
    ((1, 33, 33, 4, 1, 16, 16), dict(causal=True, logit_softcap=5.0)),
    ((2, 24, 40, 4, 2, 48, 32), dict(causal=True)),
    ((1, 17, 29, 2, 2, 16, 8), dict(causal=False)),
    ((2, 31, 31, 6, 2, 24, 24), dict(causal=True, window=7,
                                     logit_softcap=3.0, scale=0.3)),
]


@pytest.mark.parametrize("elems", [None, 200], ids=["one_chunk", "chunks"])
@pytest.mark.parametrize("shape,kw", ATTN_CASES,
                         ids=["causal", "gqa_window", "mqa_softcap",
                              "dk_ne_dv_offset", "cross", "all"])
def test_attention_function_grads_match_autograd_of_plain(shape, kw, elems,
                                                          monkeypatch):
    if elems is not None:        # several query chunks in the backward
        monkeypatch.setattr(ref, "BWD_SCORE_ELEMS", elems)
    B, Tq, Tk, H, Hkv, Dk, Dv = shape
    q0 = torch.from_numpy(_normal(1, B, Tq, H, Dk))
    k0 = torch.from_numpy(_normal(2, B, Tk, Hkv, Dk))
    v0 = torch.from_numpy(_normal(3, B, Tk, Hkv, Dv))
    dout = torch.from_numpy(_normal(4, B, Tq, H, Dv))

    def grads(fn):
        q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
        out = fn(q, k, v, **kw)
        out.backward(dout)
        return out, q.grad, k.grad, v.grad

    got = grads(ops.flash_attention_bthd)
    want = grads(ref.flash_attention_bthd_ref)
    assert got[0].grad_fn is not None and \
        type(got[0].grad_fn).__name__ == "FlashAttentionBackward"
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=ATTN_TOL, atol=ATTN_TOL)


def test_attention_function_on_the_bhtd_layout():
    """``ops.flash_attention`` ((B, H, T, D)) under autograd takes the
    same route, its gradients those of the plain version."""
    q0, k0, v0, dout = (torch.from_numpy(_normal(i, 2, 3, 20, 16))
                        for i in range(4))
    res = []
    for fn in (ops.flash_attention, ref.flash_attention_ref):
        q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
        fn(q, k, v, causal=True, window=5).backward(dout)
        res.append((q.grad, k.grad, v.grad))
    for g, w in zip(*res):
        torch.testing.assert_close(g, w, rtol=ATTN_TOL, atol=ATTN_TOL)
    # without grad mode, or with no input that requires grad, the op
    # records nothing
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None
    assert ops.flash_attention(q0, k0, v0).grad_fn is None
