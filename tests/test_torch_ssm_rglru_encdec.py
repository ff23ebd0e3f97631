"""The port's SSM (Mamba-2 SSD), RG-LRU and enc-dec modules against the
JAX reference, on the CPU, and the three families' whole reduced models.

The same NumPy inputs, made from a seed, go through ``repro`` and
``repro_torch``; the parameters are drawn by the reference and carried
across by ``lm_params_from_jax``.  The encoder's and the decoder's
attention reach the port's ``chunked_attention``, on the CPU the flash
kernel's plain version.

Tolerances:
- float32: 1e-5 on the causal convs, the RG-LRU's gates and scan, the
  cross-attention and single decode steps of a mixer; 1e-4 on
  ``ssd_chunked``, the encoder stack and whole-model logits (the
  einsums and the scans sum in another order in XLA and ATen);
- a model's own prefill against its decode: the reference's 2e-3
  (``tests/test_arch_smoke.py::test_reduced_prefill_decode_agree``);
- bfloat16: the convs 2e-2 elementwise; the mixers' full-sequence
  paths 2e-2 of the output's largest magnitude (a one-ulp difference in
  a bfloat16 GEMM or SiLU, which XLA and ATen round differently, reaches
  every output through the next projection), and the port's mean
  distance from the float32 output (the same weights, cast) at most
  1.25x the reference's: the port rounds no worse than the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro.configs.registry import get_config as jax_get_config
from repro.models import encdec as jax_encdec
from repro.models import model as jax_model
from repro.models import rglru as jax_rglru
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_transformer
from repro_torch import pytree
from repro_torch.configs import registry
from repro_torch.models import encdec, model, rglru, ssm, transformer

F32_TOL = 1e-5
LM_TOL = 1e-4
AGREE_TOL = 2e-3
BF16_TOL = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _normal(seed: int, *shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _to_torch(tree):
    return model.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                    "cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(_np32(got), _np32(want), atol=tol, rtol=tol)


def _bf16_close(got, want, truth):
    """``got`` (the port's bfloat16 output) against ``want`` (the
    reference's) and ``truth`` (the reference's float32 output on the
    same weights), as the module docstring states."""
    got, want, truth = _np32(got), _np32(want), _np32(truth)
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()
    assert np.abs(got - truth).mean() <= 1.25 * np.abs(want - truth).mean()


def _cfg(arch: str, **kw):
    """The reference's reduced config of ``arch`` (with ``kw`` replaced)
    and the port's, equal field for field."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **kw)
    cfg = dataclasses.replace(registry.get_config(arch).reduced(), **kw)
    return jcfg, cfg


def _mixer(arch: str, dtype: str = "float32"):
    """The first layer's mixer parameters of ``arch``'s reduced config, in
    ``dtype``, as the reference draws them and as the port carries them."""
    jcfg, cfg = _cfg(arch, dtype=dtype)
    jp = jax_transformer.init_layer(jax.random.PRNGKey(3), jcfg, 0)["mixer"]
    return jcfg, cfg, jp, _to_torch(jp)


# ---------------------------------------------------------------------------
# the causal convs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("which", ["ssm", "rglru"])
def test_causal_convs_match_jax(which, dtype):
    """``conv_w[0]`` multiplies the newest sample in both packages; the
    SSM's conv ends in a SiLU, the RG-LRU's in none."""
    jdt, tdt, tol = DTYPES[dtype]
    x, w, b = _normal(0, 2, 11, 24), _normal(1, 4, 24), _normal(2, 24)
    jfn, fn = ((jax_ssm._causal_conv, ssm._causal_conv) if which == "ssm"
               else (jax_rglru._conv, rglru._conv))
    want = jfn(*(jnp.asarray(a, jdt) for a in (x, w, b)))
    got = fn(*(torch.from_numpy(a).to(tdt) for a in (x, w, b)))
    assert got.dtype == tdt and got.shape == (2, 11, 24)
    _close(got, want, tol)
    # the taps' orientation: an impulse at t = 0 reads w[0], w[1], ... at
    # t = 0, 1, ... (before the SSM's SiLU)
    if which == "rglru" and dtype == "float32":
        imp = torch.zeros(1, 6, 24)
        imp[0, 0] = 1.0
        out = fn(imp, torch.from_numpy(w), torch.zeros(24))
        np.testing.assert_array_equal(out[0, :4].numpy(), w)


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------

def _ssd_inputs(T: int, h: int = 4, p: int = 8, n: int = 6, seed: int = 0):
    B = 2
    x = _normal(seed, B, T, h, p)
    dt = np.log1p(np.exp(_normal(seed + 1, B, T, h)))        # softplus > 0
    a_log = _normal(seed + 2, h, scale=0.5)
    B_in, C_in = _normal(seed + 3, B, T, n), _normal(seed + 4, B, T, n)
    D = _normal(seed + 5, h)
    return x, dt.astype(np.float32), a_log, B_in, C_in, D


@pytest.mark.parametrize("n_chunks", [1, 3])
def test_ssd_chunked_matches_jax(n_chunks):
    """At T = chunk and T = 3 chunks, from a non-zero initial state: the
    outputs and the final state."""
    chunk = 16
    ins = _ssd_inputs(n_chunks * chunk)
    S0 = _normal(9, 2, 4, 8, 6, scale=0.5)
    jy, jS = jax_ssm.ssd_chunked(*(jnp.asarray(a) for a in ins), chunk=chunk,
                                 init_state=jnp.asarray(S0))
    y, S = ssm.ssd_chunked(*(torch.from_numpy(a) for a in ins), chunk=chunk,
                           init_state=torch.from_numpy(S0))
    assert y.dtype == S.dtype == torch.float32
    assert y.shape == (2, n_chunks * chunk, 4, 8) and S.shape == (2, 4, 8, 6)
    _close(y, jy, LM_TOL)
    _close(S, jS, LM_TOL)


def test_ssd_chunked_refuses_a_ragged_t():
    ins = _ssd_inputs(40)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ssm.ssd_chunked(*(torch.from_numpy(a) for a in ins), chunk=16)
    # below the chunk, the whole sequence is one chunk
    y, _ = ssm.ssd_chunked(*(torch.from_numpy(a) for a in ins), chunk=64)
    jy, _ = jax_ssm.ssd_chunked(*(jnp.asarray(a) for a in ins), chunk=64)
    _close(y, jy, LM_TOL)


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), tree)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssm_apply_matches_jax(dtype):
    jcfg, cfg, jp, p = _mixer("mamba2-780m", dtype)
    jdt, tdt, _ = DTYPES[dtype]
    x = _normal(4, 2, 2 * cfg.ssm.chunk, cfg.d_model)
    want = jax_ssm.ssm_apply(jp, jcfg.ssm, jcfg.d_model, jnp.asarray(x, jdt))
    got = ssm.ssm_apply(p, cfg.ssm, cfg.d_model, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    if dtype == "float32":
        _close(got, want, LM_TOL)
    else:
        _bf16_close(got, want, jax_ssm.ssm_apply(
            _f32(jp), jcfg.ssm, jcfg.d_model,
            jnp.asarray(x, jdt).astype(jnp.float32)))


def test_ssm_decode_matches_jax_and_writes_the_state_in_place():
    jcfg, cfg, jp, p = _mixer("mamba2-780m")
    B = 2
    jstate = jax_ssm.ssm_init_state(jcfg.ssm, jcfg.d_model, B, jnp.float32)
    state = ssm.ssm_init_state(cfg.ssm, cfg.d_model, B, torch.float32, "cpu")
    conv, ssd_state = state["conv"], state["ssd"]
    assert conv.dtype == torch.float32 and ssd_state.dtype == torch.float32
    xs = _normal(5, B, 6, cfg.d_model)
    for t in range(6):
        jy, jstate = jax_ssm.ssm_decode(jp, jcfg.ssm, jcfg.d_model,
                                        jnp.asarray(xs[:, t:t + 1]), jstate)
        y, state = ssm.ssm_decode(p, cfg.ssm, cfg.d_model,
                                  torch.from_numpy(xs[:, t:t + 1]), state)
        assert state["conv"] is conv and state["ssd"] is ssd_state
        _close(y, jy, F32_TOL)
        _close(conv, jstate["conv"], F32_TOL)
        _close(ssd_state, jstate["ssd"], F32_TOL)
    # bf16: the conv history in the model's dtype, the SSD state float32
    st16 = ssm.ssm_init_state(cfg.ssm, cfg.d_model, B, torch.bfloat16, "cpu")
    assert st16["conv"].dtype == torch.bfloat16
    assert st16["ssd"].dtype == torch.float32


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 7, 64, 100])
def test_rglru_scan_matches_associative_scan(T):
    a = np.random.default_rng(T).uniform(0.5, 1.0, (2, T, 16)).astype(
        np.float32)
    b = _normal(T + 1, 2, T, 16)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    _, want = jax.lax.associative_scan(
        combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = rglru.scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, want, F32_TOL)
    # and the recurrence itself
    h, hs = np.zeros((2, 16), np.float32), []
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(hs, 1), atol=F32_TOL,
                               rtol=F32_TOL)


def test_rglru_init_and_gates_match_jax():
    jcfg, cfg, jp, p = _mixer("recurrentgemma-2b")
    gen = torch.Generator().manual_seed(0)
    own = rglru.init_rglru(gen, cfg.rglru, cfg.d_model, torch.float32, "cpu")
    np.testing.assert_allclose(own["lam"].numpy(), np.asarray(jp["lam"]),
                               rtol=F32_TOL, atol=F32_TOL)
    assert {k: tuple(v["w"].shape) if isinstance(v, dict) else
            tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v["w"].shape) if isinstance(v, dict) else tuple(v.shape)
         for k, v in jp.items()}
    xw = _normal(6, 2, 9, cfg.rglru.lru_width or cfg.d_model)
    ja, jb = jax_rglru._gates(jp, jnp.asarray(xw))
    a, b = rglru._gates(p, torch.from_numpy(xw))
    _close(a, ja, F32_TOL)
    _close(b, jb, F32_TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rglru_apply_matches_jax(dtype):
    jcfg, cfg, jp, p = _mixer("recurrentgemma-2b", dtype)
    jdt, tdt, _ = DTYPES[dtype]
    x = _normal(7, 2, 80, cfg.d_model)
    want = jax_rglru.rglru_apply(jp, jcfg.rglru, jnp.asarray(x, jdt))
    got = rglru.rglru_apply(p, cfg.rglru, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    if dtype == "float32":
        _close(got, want, F32_TOL)
    else:
        _bf16_close(got, want, jax_rglru.rglru_apply(
            _f32(jp), jcfg.rglru, jnp.asarray(x, jdt).astype(jnp.float32)))


def test_rglru_decode_matches_jax_and_writes_the_state_in_place():
    jcfg, cfg, jp, p = _mixer("recurrentgemma-2b")
    B = 2
    jstate = jax_rglru.rglru_init_state(jcfg.rglru, jcfg.d_model, B,
                                        jnp.float32)
    state = rglru.rglru_init_state(cfg.rglru, cfg.d_model, B, torch.float32,
                                   "cpu")
    conv, h = state["conv"], state["h"]
    xs = _normal(8, B, 6, cfg.d_model)
    for t in range(6):
        jy, jstate = jax_rglru.rglru_decode(jp, jcfg.rglru,
                                            jnp.asarray(xs[:, t:t + 1]),
                                            jstate)
        y, state = rglru.rglru_decode(p, cfg.rglru,
                                      torch.from_numpy(xs[:, t:t + 1]), state)
        assert state["conv"] is conv and state["h"] is h
        _close(y, jy, F32_TOL)
        _close(conv, jstate["conv"], F32_TOL)
        _close(h, jstate["h"], F32_TOL)
    st16 = rglru.rglru_init_state(cfg.rglru, cfg.d_model, B, torch.bfloat16,
                                  "cpu")
    assert st16["conv"].dtype == torch.bfloat16
    assert st16["h"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the enc-dec: encoder stack and cross-attention
# ---------------------------------------------------------------------------

def _seamless(n_frames: int = 37):
    jcfg, cfg = _cfg("seamless-m4t-large-v2")
    jcfg = dataclasses.replace(jcfg, encoder=dataclasses.replace(
        jcfg.encoder, n_layers=2))
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, n_layers=2))
    frames = _normal(10, 2, n_frames, cfg.modality.feat_dim)
    return jcfg, cfg, frames


def test_encoder_apply_matches_jax_at_a_ragged_length():
    """Two encoder layers (stacked as the reference stacks them) over 37
    frames: non-causal attention, no RoPE."""
    jcfg, cfg, frames = _seamless(37)
    jp = jax_encdec.init_encoder(jax.random.PRNGKey(4), jcfg)
    p = _to_torch(jp)
    assert p["layers"]["wq"]["w"].shape[0] == 2
    want = jax_encdec.encoder_apply(jp, jcfg, jnp.asarray(frames))
    got = encdec.encoder_apply(p, cfg, torch.from_numpy(frames))
    assert got.shape == (2, 37, cfg.encoder.d_model)
    _close(got, want, LM_TOL)
    own = encdec.init_encoder(torch.Generator().manual_seed(0), cfg, "cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), own) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)


@pytest.mark.parametrize("T", [1, 5, 40])
def test_xattn_apply_matches_jax(T):
    jcfg, cfg, memory = _seamless(37)
    memory = memory[..., :cfg.encoder.d_model]
    jp = jax_transformer._init_xattn(jax.random.PRNGKey(5), jcfg,
                                     jnp.float32)
    p = _to_torch(jp)
    x = _normal(11, 2, T, cfg.d_model)
    want = jax_transformer._xattn_apply(jp, jcfg, jnp.asarray(x),
                                        jnp.asarray(memory))
    got = transformer._xattn_apply(p, cfg, torch.from_numpy(x),
                                   torch.from_numpy(memory))
    assert got.shape == (2, T, cfg.d_model)
    _close(got, want, F32_TOL)


# ---------------------------------------------------------------------------
# whole reduced models
# ---------------------------------------------------------------------------

#: recurrentgemma with 5 layers: one (rglru, rglru, attn) cycle and an
#: RG-LRU suffix, at T = 96 > its reduced window of 64; mamba2 at T = 64,
#: two of its reduced chunks of 32; seamless with 16 reduced frames
WHOLE_CASES = [("mamba2-780m", {}, 64), ("recurrentgemma-2b",
                                         {"n_layers": 5}, 96),
               ("seamless-m4t-large-v2", {}, 40)]


@pytest.mark.parametrize("arch,kw,T", WHOLE_CASES,
                         ids=[c[0] for c in WHOLE_CASES])
def test_reduced_family_matches_jax(arch, kw, T):
    """``forward`` and a run of ``decode_step`` against the reference's on
    its own weights, each decode step against the port's own prefill."""
    jcfg, cfg = _cfg(arch, **kw)
    jp = jax_model.init_model(jax.random.PRNGKey(0), jcfg)
    p = _to_torch(jp)
    B = 2
    toks = np.random.default_rng(13).integers(0, cfg.vocab, (B, T)).astype(
        np.int32)
    tt = torch.from_numpy(toks).long()
    batch, jbatch = {"tokens": tt}, {"tokens": jnp.asarray(toks)}
    extra, jextra = {}, {}
    if cfg.encoder is not None:
        frames = _normal(14, B, cfg.encoder.n_frames, cfg.modality.feat_dim)
        extra, jextra = ({"frames": torch.from_numpy(frames)},
                         {"frames": jnp.asarray(frames)})
    logits, aux = model.forward(p, cfg, {**batch, **extra})
    jlogits, _ = jax.jit(lambda p_, b_: jax_model.forward(p_, jcfg, b_))(
        jp, {**jbatch, **jextra})
    assert logits.shape == (B, T, cfg.vocab) and float(aux) == 0.0
    _close(logits, jlogits, LM_TOL)

    cache = model.init_cache(cfg, B, T, device="cpu")
    jcache = jax_model.init_cache(jcfg, B, T)
    jdecode = jax.jit(lambda p_, b_, c_: jax_model.decode_step(
        p_, jcfg, b_, c_))
    for t in range(T):
        step = {"token": tt[:, t], "t": torch.full((B,), t,
                                                   dtype=torch.int32)}
        jstep = {"token": jnp.asarray(toks[:, t]),
                 "t": jnp.full((B,), t, jnp.int32)}
        step_logits, cache = model.decode_step(p, cfg, {**step, **extra},
                                               cache)
        jstep_logits, jcache = jdecode(jp, {**jstep, **jextra}, jcache)
        _close(step_logits, jstep_logits, LM_TOL)
        np.testing.assert_allclose(_np32(step_logits), _np32(logits[:, t]),
                                   atol=AGREE_TOL, rtol=AGREE_TOL)


def test_seamless_decode_step_equals_lm_decode_with_memory():
    """``decode_step`` with frames runs the encoder every step; the serving
    loop's ``lm_decode(memory=encoder_apply(frames))`` gives the same
    logits and cache."""
    _, cfg = _cfg("seamless-m4t-large-v2")
    p = model.init_model(torch.Generator().manual_seed(2), cfg, "cpu")
    B, T = 2, 6
    frames = torch.from_numpy(_normal(15, B, cfg.encoder.n_frames,
                                      cfg.modality.feat_dim))
    toks = torch.from_numpy(np.random.default_rng(16).integers(
        0, cfg.vocab, (B, T)))
    memory = encdec.encoder_apply(p["encoder"], cfg, frames)
    c1 = model.init_cache(cfg, B, T, device="cpu")
    c2 = model.init_cache(cfg, B, T, device="cpu")
    for t in range(T):
        tpos = torch.full((B,), t, dtype=torch.int32)
        l1, c1 = model.decode_step(p, cfg, {"token": toks[:, t], "t": tpos,
                                            "frames": frames}, c1)
        l2, c2 = transformer.lm_decode(p, cfg, toks[:, t], c2, tpos,
                                       memory=memory)
        np.testing.assert_array_equal(l1.numpy(), l2.numpy())
    for a, b in zip(pytree.leaves(c1), pytree.leaves(c2)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-2b",
                                  "seamless-m4t-large-v2"])
def test_lm_params_from_jax_keeps_mixed_dtypes(arch):
    """A bfloat16 model's tree: the float32 leaves (the SSM's ``A_log``,
    ``dt_bias``, ``D``; the RG-LRU's ``w_a``, ``w_i``, ``lam``; the
    norms) stay float32, the rest bfloat16, every leaf's bits equal, the
    encoder carried."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               dtype="bfloat16")
    jp = jax_model.init_model(jax.random.PRNGKey(6), jcfg)
    p = _to_torch(jp)
    jleaves, _ = jax.tree_util.tree_flatten_with_path(jp)
    dtypes = set()
    for path, leaf in jleaves:
        t = p
        for key in path:
            t = t[key.key if hasattr(key, "key") else key.idx]
        want = np.asarray(leaf)
        assert str(t.dtype).split(".")[-1] == want.dtype.name, path
        assert t.shape == want.shape, path
        np.testing.assert_array_equal(_np32(t), want.astype(np.float32))
        dtypes.add((jax.tree_util.keystr(path).split("'")[-2], t.dtype))
    f32 = {name for name, dt in dtypes if dt == torch.float32}
    assert {name for name, dt in dtypes if dt == torch.bfloat16}
    if arch == "mamba2-780m":
        assert {"A_log", "dt_bias", "D"} <= f32
    elif arch == "recurrentgemma-2b":
        assert "lam" in f32 and "b" in f32       # w_a's and w_i's biases
        # 2 reduced layers, both RG-LRU, below the period of 3: no body
        assert p["body"] is None
        assert p["suffix"][0]["mixer"]["w_a"]["w"].dtype == torch.float32
    else:
        assert "encoder" in p and p["encoder"]["in_proj"]["w"].dtype == \
            torch.bfloat16
