"""The port's LM serving path against the JAX reference, on the CPU.

The same NumPy inputs, made from a seed, go through ``repro`` and
``repro_torch``.  On the CPU the port's ``ops.flash_attention`` is its
plain version (``kernels/ref.py``), which ``chunked_attention`` and so
every full-sequence forward reach; the CUDA kernel is held against that
plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.  Whole models run on the reference's own weights,
carried across by ``lm_params_from_jax``.

Tolerances: attention 2e-5 in float32 and 2e-2 in bfloat16 (the
reference's kernel tests; in bfloat16 the reference's ``chunked_attention``
also rounds the probabilities to bfloat16 before the product with v,
which the port's kernel and plain version keep in float32); layers 1e-5
in float32; whole reduced models (float32, two layers) 1e-4, for float32
products summed in another order by XLA and ATen.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro.configs.base import AttentionConfig as JaxAttentionConfig
from repro.configs import registry as jax_registry
from repro.configs.registry import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.launch import steps as jax_steps
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.models import rope as jax_rope
from repro_torch.benchmarks import pv_rounding
from repro_torch.configs import registry
from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import (attention, layers, model, moe, rope,
                                transformer)

REPO = Path(__file__).resolve().parents[1]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
#: tests/test_kernels.py's attention grid: (B, H, Tq, Tk, D) and options
FA_SHAPES = [(1, 2, 128, 128, 64), (2, 1, 64, 192, 64), (1, 1, 200, 200, 128)]
FA_KWS = [dict(causal=True), dict(causal=False),
          dict(causal=True, window=64), dict(causal=True, logit_softcap=30.0)]
LM_TOL = 1e-4


def _pair(a: np.ndarray, dtype: str):
    """One float32 NumPy array as a JAX and a torch array of ``dtype``
    (both round float32 -> bfloat16 to nearest even: the same bits)."""
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


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


def _qkv(shape, dtype):
    B, H, Tq, Tk, D = shape
    return [_pair(_normal(s, B, H, t, D), dtype)
            for s, t in ((0, Tq), (1, Tk), (2, Tk))]


# ---------------------------------------------------------------------------
# flash_attention: the op's CPU route against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", FA_KWS, ids=["causal", "full", "window64",
                                            "softcap30"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", FA_SHAPES)
def test_flash_attention_matches_jax_oracle(shape, dtype, kw):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(shape, dtype)
    launches = dict(ops.launches)
    out = ops.flash_attention(tq, tk, tv, **kw)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    assert ops.launches == launches                 # the CPU launches nothing
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(
        _np32(out), _np32(jax_ref.flash_attention_ref(jq, jk, jv, **kw)),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("shape,dtype,kw", [
    ((1, 1, 200, 200, 128), "float32", dict(causal=True)),
    ((2, 1, 64, 192, 64), "float32", dict(causal=True, window=64)),
    ((1, 2, 128, 128, 64), "bfloat16", dict(causal=True, logit_softcap=30.0)),
    ((1, 2, 128, 128, 64), "float32", dict(causal=False))])
def test_flash_attention_matches_pallas_interpret(shape, dtype, kw):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(shape, dtype)
    expect = jax_ops.flash_attention(jq, jk, jv, block_q=64, block_k=64,
                                     interpret=True, **kw)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np32(ops.flash_attention(tq, tk, tv, **kw)),
                               _np32(expect), atol=tol, rtol=tol)


def test_flash_attention_refuses_bad_operands():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match=r"\(B, H, T, D\)"):
        ops.flash_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="must be"):
        ops.flash_attention(q, torch.zeros(1, 2, 8, 32), q)
    with pytest.raises(ValueError, match="must be"):
        ops.flash_attention(q, q, torch.zeros(1, 2, 9, 64))
    with pytest.raises(ValueError, match="leaves no key"):
        ops.flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="positive"):
        ops.flash_attention(q, q, q, logit_softcap=0.0)


# ---------------------------------------------------------------------------
# chunked_attention (GQA, (B, T, H, D)) against the reference's scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=16),
                                dict(causal=True, logit_softcap=50.0)],
                         ids=["causal", "full", "window16", "softcap50"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_chunked_attention_matches_jax(dtype, kw, heads):
    Hq, Hkv = heads
    B, T, D = 2, 40, 64
    jq, tq = _pair(_normal(3, B, T, Hq, D), dtype)
    jk, tk = _pair(_normal(4, B, T, Hkv, D), dtype)
    jv, tv = _pair(_normal(5, B, T, Hkv, D), dtype)
    out = attention.chunked_attention(tq, tk, tv, **kw)
    assert out.shape == (B, T, Hq, D) and out.dtype == tq.dtype
    expect = jax_attn.chunked_attention(jq, jk, jv, chunk=16, **kw)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np32(out), _np32(expect), atol=tol, rtol=tol)


def test_chunked_attention_refuses_foreign_q_offset():
    """A mask that reads positions (causal, window) takes only the
    kernel's offset Tk - Tq."""
    q = torch.zeros(1, 8, 2, 64)
    kv = torch.zeros(1, 12, 2, 64)
    with pytest.raises(ValueError, match="q_offset"):
        attention.chunked_attention(q, q, q, q_offset=3)
    with pytest.raises(ValueError, match="q_offset"):
        attention.chunked_attention(q, kv, kv)        # the default offset 0
    with pytest.raises(ValueError, match="q_offset"):
        attention.chunked_attention(q, kv, kv, causal=False, window=4)
    out = attention.chunked_attention(q, kv, kv, q_offset=4)
    assert out.shape == q.shape


@pytest.mark.parametrize("tq,tk", [(3, 5), (7, 5), (5, 5)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_chunked_attention_cross_attention_at_offset_0(dtype, tq, tk):
    """The reference's cross-attention: no causal or window mask, Tq and
    Tk free, q_offset 0 (``repro/models/encdec.py``); the offset reads
    nothing, so the port takes it and gives the reference's result."""
    jq, tq_ = _pair(_normal(20, 1, tq, 2, 64), dtype)
    jk, tk_ = _pair(_normal(21, 1, tk, 2, 64), dtype)
    jv, tv_ = _pair(_normal(22, 1, tk, 2, 64), dtype)
    out = attention.chunked_attention(tq_, tk_, tv_, causal=False,
                                      q_offset=0)
    assert out.shape == (1, tq, 2, 64) and out.dtype == tq_.dtype
    expect = jax_attn.chunked_attention(jq, jk, jv, causal=False,
                                        q_offset=0)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np32(out), _np32(expect), atol=tol, rtol=tol)


#: MLA's head dims as (B, T, Hq, Hkv, Dk, Dv): the reduced MLA configs
#: (nope 32 + rope 16, v 32) at one and two query heads a KV head,
#: minicpm3's (96, 64) and deepseek-v2's (192, 128)
MLA_CASES = [(1, 5, 2, 2, 48, 32), (2, 64, 4, 2, 48, 32),
             (1, 33, 2, 2, 96, 64), (1, 17, 2, 1, 192, 128)]


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False)],
                         ids=["causal", "full"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", MLA_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_chunked_attention_takes_dk_ne_dv(case, dtype, kw):
    """k and v of their own head dims, as MLA's prefill passes them
    (``repro/models/attention.py``), through ``chunked_attention`` and
    both ops, against the reference's ``chunked_attention`` (its Pallas
    kernel takes one head dim)."""
    B, T, Hq, Hkv, Dk, Dv = case
    jq, tq = _pair(_normal(23, B, T, Hq, Dk), dtype)
    jk, tk = _pair(_normal(24, B, T, Hkv, Dk), dtype)
    jv, tv = _pair(_normal(25, B, T, Hkv, Dv), dtype)
    expect = _np32(jax_attn.chunked_attention(jq, jk, jv, chunk=16, **kw))
    tol = DTYPES[dtype][2]
    launches = dict(ops.launches)
    out = attention.chunked_attention(tq, tk, tv, **kw)
    assert out.shape == (B, T, Hq, Dv) and out.dtype == tq.dtype
    np.testing.assert_allclose(_np32(out), expect, atol=tol, rtol=tol)
    assert torch.equal(ops.flash_attention_bthd(tq, tk, tv, **kw), out)
    g = Hq // Hkv
    mha = ops.flash_attention(
        tq.transpose(1, 2), *(t.repeat_interleave(g, dim=2).transpose(1, 2)
                              for t in (tk, tv)), **kw)
    assert mha.shape == (B, Hq, T, Dv)
    np.testing.assert_allclose(_np32(mha.transpose(1, 2)), expect, atol=tol,
                               rtol=tol)
    assert ops.launches == launches                 # the CPU launches nothing


# ---------------------------------------------------------------------------
# flash_attention_bthd: the model's (B, T, H, D) layout and GQA heads, read
# where they lie, against the reference
# ---------------------------------------------------------------------------

def _fused_views(dtype: str, B: int, T: int, Hq: int, Hkv: int, D: int):
    """q, k, v as (B, T, H, D) views of one fused (B, T, (Hq + 2 Hkv) D)
    projection, as a JAX and a torch triple: the torch views are not
    contiguous (their time stride is the fused row)."""
    jf, tf = _pair(_normal(8, B, T, (Hq + 2 * Hkv) * D), dtype)
    cuts = ((0, Hq), (Hq, Hq + Hkv), (Hq + Hkv, Hq + 2 * Hkv))
    jax_views = [jf[..., a * D:b * D].reshape(B, T, b - a, D)
                 for a, b in cuts]
    torch_views = [tf[..., a * D:b * D].unflatten(-1, (b - a, D))
                   for a, b in cuts]
    return jax_views, torch_views


@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("kw", FA_KWS, ids=["causal", "full", "window64",
                                            "softcap30"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_bthd_matches_jax(dtype, kw, heads):
    """The op's CPU route on GQA heads against the reference's oracle on
    the KV heads expanded, and against its ``chunked_attention``."""
    Hq, Hkv = heads
    B, T, D = 2, 96, 64
    jq, tq = _pair(_normal(9, B, T, Hq, D), dtype)
    jk, tk = _pair(_normal(10, B, T, Hkv, D), dtype)
    jv, tv = _pair(_normal(11, B, T, Hkv, D), dtype)
    launches = dict(ops.launches)
    out = ops.flash_attention_bthd(tq, tk, tv, **kw)
    assert ops.launches == launches                 # the CPU launches nothing
    assert out.shape == (B, T, Hq, D) and out.dtype == tq.dtype
    assert out.is_contiguous()
    tol = DTYPES[dtype][2]
    oracle = jax_ref.flash_attention_ref(
        *(jnp.repeat(t, Hq // t.shape[2], axis=2).transpose(0, 2, 1, 3)
          for t in (jq, jk, jv)), **kw).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np32(out), _np32(oracle), atol=tol, rtol=tol)
    scan = jax_attn.chunked_attention(jq, jk, jv, chunk=32, **kw)
    np.testing.assert_allclose(_np32(out), _np32(scan), atol=tol, rtol=tol)


@pytest.mark.parametrize("heads", [(4, 2), (4, 1)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_bthd_reads_views_of_a_fused_projection(dtype,
                                                                heads):
    """Non-contiguous (B, T, H, D) views of a fused qkv projection give
    the reference's result, and the bits of their contiguous copies."""
    Hq, Hkv = heads
    B, T, D = 2, 48, 64
    (jq, jk, jv), (tq, tk, tv) = _fused_views(dtype, B, T, Hq, Hkv, D)
    assert not any(t.is_contiguous() for t in (tq, tk, tv))
    out = ops.flash_attention_bthd(tq, tk, tv, window=16)
    assert torch.equal(out, ops.flash_attention_bthd(
        tq.contiguous(), tk.contiguous(), tv.contiguous(), window=16))
    tol = DTYPES[dtype][2]
    expect = jax_attn.chunked_attention(jq, jk, jv, chunk=16, window=16)
    np.testing.assert_allclose(_np32(out), _np32(expect), atol=tol, rtol=tol)
    out = attention.chunked_attention(tq, tk, tv, logit_softcap=30.0)
    expect = jax_attn.chunked_attention(jq, jk, jv, chunk=16,
                                        logit_softcap=30.0)
    np.testing.assert_allclose(_np32(out), _np32(expect), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", ["d_stride_q", "d_stride_kv", "grouping",
                                  "shape"])
def test_flash_attention_bthd_refuses_what_it_cannot_take(case):
    """A head dim off unit stride, query heads that do not group over the
    KV heads and mismatched k, v raise on the CPU as on the card, with no
    launch."""
    q = torch.zeros(1, 8, 4, 64)
    kv = torch.zeros(1, 8, 2, 64)
    d_strided = torch.zeros(1, 8, 64, 2).transpose(2, 3)
    bad = {"d_stride_q": ((torch.zeros(1, 8, 64, 4).transpose(2, 3), kv, kv),
                          "contiguous"),
           "d_stride_kv": ((q, d_strided, d_strided), "contiguous"),
           "grouping": ((q, torch.zeros(1, 8, 3, 64),
                         torch.zeros(1, 8, 3, 64)), "do not group"),
           "shape": ((q, kv, torch.zeros(1, 9, 2, 64)), "must be")}
    operands, match = bad[case]
    launches = dict(ops.launches)
    with pytest.raises(ValueError, match=match):
        ops.flash_attention_bthd(*operands)
    assert ops.launches == launches


def test_pv_rounding_keeps_the_hi_lo_split_near_float32():
    """Why the kernel splits p: on the CPU table of ``pv_rounding`` at a
    small size, one bf16 product of bf16(p) lies far over the 1e-6 mean
    |err| the prefill check allows, TF32 p over it too, and the hi/lo
    pair under it, within 30x of float32 p summed in another order."""
    rows = {name: mean for name, _, mean, _ in
            pv_rounding.rounding_table(heads=2, seq=256, dim=64)}
    assert rows["p bf16"] > 100 * 1e-6
    assert rows["p tf32"] > 10 * 1e-6
    assert rows["p hi/lo bf16"] <= 1e-6
    assert rows["p hi/lo bf16"] <= 30 * rows["p f32, f64 sum"]


# ---------------------------------------------------------------------------
# layers and RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_jax(theta):
    x = _normal(6, 2, 12, 4, 64)
    pos = np.random.default_rng(7).integers(0, 5000, (2, 12))
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    expect = jax_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(_np32(got), _np32(expect), atol=1e-5,
                               rtol=1e-5)
    got1 = rope.apply_rope(torch.from_numpy(x), torch.arange(12), theta)
    expect1 = jax_rope.apply_rope(jnp.asarray(x), jnp.arange(12), theta)
    np.testing.assert_allclose(_np32(got1), _np32(expect1), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_norms_and_gated_mlp_match_jax(dtype):
    """Norms: 1e-5 in float32, 2e-2 in bfloat16 (one rounding of the
    output after float32 statistics).  Gated MLP: 1e-5 in float32; in
    bfloat16 one bfloat16 ulp of the largest output (2**-7 of it): the
    three products' outputs are rounded to bfloat16 at places XLA and
    ATen choose differently."""
    tol = 1e-5 if dtype == "float32" else 2e-2
    jx, tx = _pair(_normal(8, 2, 5, 32) * 3 + 1, dtype)
    scale, bias = _normal(9, 32) * 0.1, _normal(10, 32) * 0.1
    rms_j = {"scale": jnp.asarray(scale)}
    rms_t = {"scale": torch.from_numpy(scale)}
    np.testing.assert_allclose(
        _np32(layers.rmsnorm_apply(rms_t, tx)),
        _np32(jax_layers.rmsnorm_apply(rms_j, jx)), atol=tol, rtol=tol)
    ln_j = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    ln_t = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    np.testing.assert_allclose(
        _np32(layers.layernorm_apply(ln_t, tx)),
        _np32(jax_layers.layernorm_apply(ln_j, jx)), atol=tol, rtol=tol)
    jdt = DTYPES[dtype][0]
    mlp_j = jax_layers.init_gated_mlp(jax.random.PRNGKey(1), 32, 48, jdt)
    expect = _np32(jax_layers.gated_mlp_apply(mlp_j, jx))
    mlp_tol = 1e-5 if dtype == "float32" else 2.0 ** -7 * np.abs(
        expect).max()
    np.testing.assert_allclose(
        _np32(layers.gated_mlp_apply(_to_torch(mlp_j), tx)), expect,
        atol=mlp_tol, rtol=1e-5)


# ---------------------------------------------------------------------------
# GQA block: prefill, decode, ring buffer
# ---------------------------------------------------------------------------

GQA_CONFIGS = {
    "qknorm-gqa": dict(n_heads=4, n_kv_heads=2, head_dim=64, qk_norm=True),
    "softcap-window": dict(n_heads=4, n_kv_heads=4, head_dim=64,
                           attn_softcap=50.0, sliding_window=6,
                           layer_pattern=("local",)),
}


@pytest.mark.parametrize("name", list(GQA_CONFIGS))
def test_gqa_apply_and_decode_match_jax(name):
    kw = GQA_CONFIGS[name]
    ja, a = JaxAttentionConfig(kind="gqa", **kw), AttentionConfig(**kw)
    window = a.sliding_window
    d_model, B, T = 32, 2, 12
    jp = jax_attn.init_gqa(jax.random.PRNGKey(0), ja, d_model, jnp.float32)
    p = _to_torch(jp)
    x = _normal(11, B, T, d_model)
    positions = np.broadcast_to(np.arange(T), (B, T))
    full = attention.gqa_apply(p, a, torch.from_numpy(x), window=window,
                               positions=torch.from_numpy(positions.copy()))
    jfull = jax_attn.gqa_apply(jp, ja, jnp.asarray(x), window=window,
                               positions=jnp.asarray(positions), chunk=4)
    np.testing.assert_allclose(_np32(full), _np32(jfull), atol=1e-5,
                               rtol=1e-5)
    # decode over a ring of `window` slots (or all T), against the
    # reference's decode and the port's own full-sequence pass
    L = window or T
    cache = attention.gqa_init_cache(a, B, L, torch.float32, "cpu")
    jcache = jax_attn.gqa_init_cache(ja, B, L, jnp.float32)
    jdecode = jax.jit(lambda p_, x_, c_, t_: jax_attn.gqa_decode(
        p_, ja, x_, c_, t_))
    for t in range(T):
        o, cache = attention.gqa_decode(
            p, a, torch.from_numpy(x[:, t:t + 1]), cache,
            torch.full((B,), t, dtype=torch.int32))
        jo, jcache = jdecode(jp, jnp.asarray(x[:, t:t + 1]), jcache,
                             jnp.full((B,), t, jnp.int32))
        np.testing.assert_allclose(_np32(o), _np32(jo), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np32(o[:, 0]), _np32(full[:, t]),
                                   atol=1e-4, rtol=1e-3)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


def test_gqa_ring_buffer_equals_sliding_window():
    """A ring buffer of W slots == sliding-window attention of width W."""
    a = AttentionConfig(kind="gqa", n_heads=2, n_kv_heads=2, head_dim=64,
                        sliding_window=4, layer_pattern=("local",))
    d_model, T, W = 16, 12, 4
    p = attention.init_gqa(torch.Generator().manual_seed(0), a, d_model,
                           torch.float32, "cpu")
    x = torch.from_numpy(_normal(12, 1, T, d_model))
    full = attention.gqa_apply(p, a, x, window=W,
                               positions=torch.arange(T).expand(1, T))
    cache = attention.gqa_init_cache(a, 1, W, torch.float32, "cpu")
    outs = []
    for t in range(T):
        o, cache = attention.gqa_decode(p, a, x[:, t:t + 1], cache,
                                        torch.full((1,), t))
        outs.append(o)
    np.testing.assert_allclose(_np32(torch.cat(outs, dim=1)), _np32(full),
                               atol=1e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# whole reduced models through lm_params_from_jax
# ---------------------------------------------------------------------------

#: gemma2 and starcoder2 at T = 96 > their reduced window of 64; the MLA,
#: MoE and VLM archs (phi-3-vision with its 8 reduced patches prepended)
LM_CASES = [("qwen3-0.6b", 24), ("gemma2-9b", 96), ("starcoder2-3b", 96),
            ("phi-3-vision-4.2b", 24), ("deepseek-v2-lite-16b", 24),
            ("deepseek-v2-236b", 24), ("minicpm3-4b", 24)]
#: the smallest log-ratio of a token's k-th to (k+1)-th router
#: probability a MoE case accepts: 10x the 1e-5 float32 error of the two
#: packages' router logits, past which topk and lax.top_k cannot disagree
ROUTER_GAP = 1e-4


@pytest.mark.parametrize("arch,T", LM_CASES)
def test_reduced_lm_matches_jax(arch, T, monkeypatch):
    jcfg = jax_get_config(arch).reduced()
    cfg = registry.get_config(arch).reduced()
    jp = jax_model.init_model(jax.random.PRNGKey(0), jcfg)
    p = _to_torch(jp)
    B = 2
    toks = np.random.default_rng(13).integers(0, cfg.vocab, (B, T)).astype(
        np.int32)
    tt = torch.from_numpy(toks).long()
    batch, jbatch = {"tokens": tt}, {"tokens": jnp.asarray(toks)}
    vision = cfg.modality.kind == "vision"
    if vision:
        patches = _normal(14, B, cfg.modality.n_tokens, cfg.modality.feat_dim)
        batch["patches"] = torch.from_numpy(patches)
        jbatch["patches"] = jnp.asarray(patches)
    # every MoE layer's router: the smallest top-k gap on these inputs
    gaps = []
    route = moe.moe_route

    def gap_route(p_, m_, xf):
        probs, gate_w, idx = route(p_, m_, xf)
        top = torch.topk(probs.double().log(), m_.top_k + 1, dim=-1).values
        gaps.append(float((top[:, -2] - top[:, -1]).min()))
        return probs, gate_w, idx
    monkeypatch.setattr(moe, "moe_route", gap_route)

    logits, aux = model.forward(p, cfg, batch)
    jlogits, jaux = jax.jit(lambda p_, b_: jax_model.forward(
        p_, jcfg, b_))(jp, jbatch)
    assert logits.shape == (B, T, cfg.vocab) and logits.dtype == torch.float32
    assert aux.dtype == torch.float32
    if cfg.moe.n_experts:
        np.testing.assert_allclose(float(aux), float(jaux), atol=LM_TOL,
                                   rtol=LM_TOL)
        assert float(aux) > 0.0
    else:
        assert float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(_np32(logits), _np32(jlogits), atol=LM_TOL,
                               rtol=LM_TOL)

    prefill = steps.make_prefill_step(cfg)
    np.testing.assert_array_equal(_np32(prefill(p, batch)),
                                  _np32(logits[:, -1]))

    # what decode must reproduce: the text's prefill (decode reads no
    # patches, so the VLM has none); for MoE one of B x 4 = 8 tokens, where
    # the capacity (8) drops no pair on either path
    agree = 0 if vision else T
    if cfg.moe.n_experts:
        agree = 8 // B
        logits, _ = model.forward(p, cfg, {"tokens": tt[:, :agree]})
    cache = model.init_cache(cfg, B, T, device="cpu")
    jcache = jax_model.init_cache(jcfg, B, T)
    jdecode = jax.jit(lambda p_, b_, c_: jax_model.decode_step(
        p_, jcfg, b_, c_))
    serve = steps.make_serve_step(cfg)
    jserve = jax.jit(jax_steps.make_serve_step(jcfg))
    serve_cache = model.init_cache(cfg, B, T, device="cpu")
    jserve_cache = jax_model.init_cache(jcfg, B, T)
    for t in range(T):
        tpos = torch.full((B,), t, dtype=torch.int32)
        batch = {"token": tt[:, t], "t": tpos}
        jbatch = {"token": jnp.asarray(toks[:, t]),
                  "t": jnp.full((B,), t, jnp.int32)}
        step_logits, cache = model.decode_step(p, cfg, batch, cache)
        jstep_logits, jcache = jdecode(jp, jbatch, jcache)
        np.testing.assert_allclose(_np32(step_logits), _np32(jstep_logits),
                                   atol=LM_TOL, rtol=LM_TOL)
        tok, serve_cache = serve(p, serve_cache, batch)
        jtok, jserve_cache = jserve(jp, jserve_cache, jbatch)
        assert tok.dtype == torch.int32
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        if t < agree:
            np.testing.assert_allclose(_np32(step_logits),
                                       _np32(logits[:, t]), atol=LM_TOL,
                                       rtol=LM_TOL)
            np.testing.assert_array_equal(
                tok.numpy(), np.argmax(_np32(logits[:, t]), axis=-1))
    if cfg.moe.n_experts:
        print(f"{arch}: smallest router gap {min(gaps):.3g} over "
              f"{len(gaps)} MoE calls")
        assert min(gaps) > ROUTER_GAP
    else:
        assert not gaps


def test_lm_params_from_jax_keeps_the_tree_and_bits():
    jcfg = jax_get_config("gemma2-9b").reduced()
    jp = jax_model.init_model(jax.random.PRNGKey(1), jcfg)
    p = _to_torch(jp)
    jleaves, jdef = jax.tree_util.tree_flatten_with_path(jp)
    for path, leaf in jleaves:
        t = p
        for key in path:
            t = t[key.key if hasattr(key, "key") else key.idx]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    # the stacked body: one cycle of gemma2's (local, global) pair
    assert transformer.cycle_period(registry.get_config("gemma2-9b")) == 2
    assert len(p["body"]) == 2 and p["body"][0]["mixer"]["wq"]["w"].shape[0] \
        == 1
    bf = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    pb = _to_torch(bf)
    assert pb["embed"]["table"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np32(pb["embed"]["table"]),
                                  _np32(bf["embed"]["table"]))


def test_init_model_shapes_follow_the_reference():
    for arch in registry.ARCH_IDS:
        cfg = registry.get_config(arch).reduced()
        jp = jax_model.init_model(jax.random.PRNGKey(0),
                                  jax_get_config(arch).reduced())
        p = model.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
        shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
        assert jax.tree_util.tree_map(lambda t: tuple(t.shape), p) == shapes
        assert sum(t.numel() for t in jax.tree_util.tree_leaves(p)) == \
            sum(a.size for a in jax.tree_util.tree_leaves(jp))


def _leaf_devices(tree):
    return {t.device for t in jax.tree_util.tree_leaves(tree)}


def test_lm_entry_points_default_to_cuda(monkeypatch):
    """Without a device the LM's entry points place everything on CUDA,
    so where there is none they raise instead of running on the CPU; with
    ``device="cpu"`` every leaf of the parameters and cache lies there."""
    cfg = registry.get_config("qwen3-0.6b").reduced()
    gen = torch.Generator().manual_seed(0)
    jp = jax.tree_util.tree_map(np.asarray, jax_model.init_model(
        jax.random.PRNGKey(0), jax_get_config("qwen3-0.6b").reduced()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: model.init_model(gen, cfg),
                  lambda: model.init_cache(cfg, 1, 8),
                  lambda: model.lm_params_from_jax(jp),
                  lambda: layers.init_rmsnorm(8),
                  lambda: layers.init_layernorm(8),
                  lambda: layers.init_linear(gen, 4, 4, bias=True),
                  lambda: attention.gqa_init_cache(cfg.attention, 1, 8,
                                                   torch.float32)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    cpu = torch.device("cpu")
    assert _leaf_devices(model.init_model(gen, cfg, "cpu")) == {cpu}
    assert _leaf_devices(model.init_cache(cfg, 1, 8, device="cpu")) == {cpu}
    assert _leaf_devices(model.lm_params_from_jax(jp, "cpu")) == {cpu}


def test_registry_matches_reference():
    """The reference's ten ids in its order, each with its parameter
    count; an unknown id refused; the SSM, the RG-LRU hybrid and the
    enc-dec built (parameters and caches) on the CPU like the rest."""
    assert registry.ARCH_IDS == [
        "qwen3-0.6b", "phi-3-vision-4.2b", "gemma2-9b", "recurrentgemma-2b",
        "seamless-m4t-large-v2", "starcoder2-3b", "deepseek-v2-236b",
        "minicpm3-4b", "mamba2-780m", "deepseek-v2-lite-16b"]
    assert registry.ARCH_IDS == jax_registry.ARCH_IDS
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_config("no-such-arch")
    for arch, cfg in registry.all_configs().items():
        assert cfg.n_params() == jax_get_config(arch).n_params()
        # copied field for field
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jax_get_config(arch))
    cpu = torch.device("cpu")
    for arch in ("mamba2-780m", "recurrentgemma-2b", "seamless-m4t-large-v2"):
        cfg = registry.get_config(arch).reduced()
        p = model.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
        cache = model.init_cache(cfg, 1, 8, device="cpu")
        assert _leaf_devices(p) == _leaf_devices(cache) == {cpu}
        assert ("encoder" in p) == (cfg.encoder is not None)


@pytest.mark.parametrize("arch,cache_kind", [
    (None, "ring-buffer KV"), ("deepseek-v2-lite-16b", "compressed MLA c_kv"),
    ("mamba2-780m", "constant SSM state"),
    ("recurrentgemma-2b", "RG-LRU + ring KV"),
    ("seamless-m4t-large-v2", "ring-buffer KV")],
    ids=["default", "deepseek-v2-lite-16b", "mamba2-780m",
         "recurrentgemma-2b", "seamless-m4t-large-v2"])
def test_serve_decode_example_runs_on_cpu(arch, cache_kind):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_decode",
         "--device", "cpu", "--reduced"] + (["--arch", arch] if arch else []),
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300,
        check=True).stdout
    assert (f"arch={arch or 'qwen3-0.6b'} (reduced, float32)  batch=4  "
            "device=cpu") in out
    assert "generated 32 tokens/request" in out and "tok/s" in out
    assert out.splitlines()[-1] == f"cache family: {cache_kind}"
