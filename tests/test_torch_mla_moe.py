"""The port's MLA attention, MoE FFN and VLM patch embedding against the
JAX reference, on the CPU.

The same NumPy inputs, made from a seed, go through ``repro`` and
``repro_torch``, the parameters drawn by the reference and carried
across by ``lm_params_from_jax``.  MLA's prefill reaches the port's
``chunked_attention``, on the CPU the flash kernel's plain version.

Tolerances, float32: MLA's prefill and each decode step 1e-4 (the
absorbed decode sums the latent in another order than the expansion);
the MoE FFN's output and auxiliary loss 1e-5.

Routing near ties: ``torch.topk`` and ``lax.top_k`` pick the same
experts unless a token's k-th and (k+1)-th router probabilities lie
within the float32 error of the two packages' probabilities apart.  Each
MoE test measures the smallest such gap on its inputs as a ratio, log
p_k - log p_(k+1) (the gap of the router's logits; probabilities far
below 1 carry their error relative to their size), prints it, and
asserts that it exceeds ``ROUTER_GAP``, 10x the 1e-5 float32 error of
the logits at these sizes, so a flip cannot pass unseen.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro.configs.base import AttentionConfig as JaxAttentionConfig
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.configs.registry import get_config as jax_get_config
from repro.models import attention as jax_attn
from repro.models import moe as jax_moe
from repro.models import transformer as jax_transformer
from repro_torch.configs import registry
from repro_torch.configs.base import AttentionConfig, MoEConfig
from repro_torch.models import attention, model, moe, transformer

#: the smallest k-th to (k+1)-th router probability gap a test accepts
ROUTER_GAP = 1e-4
MLA_TOL = 1e-4
MOE_TOL = 1e-5


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


def router_gap(probs: np.ndarray, k: int) -> float:
    """The smallest log-ratio of a token's k-th to its (k+1)-th largest
    router probability."""
    top = np.log(-np.sort(-probs.astype(np.float64), axis=-1))
    return float((top[:, k - 1] - top[:, k]).min())


# ---------------------------------------------------------------------------
# MLA: prefill and absorbed decode, both q forms
# ---------------------------------------------------------------------------

MLA_KW = dict(kind="mla", n_heads=4, n_kv_heads=4, head_dim=32,
              kv_lora_rank=64, rope_head_dim=16, nope_head_dim=32,
              v_head_dim=32)


@pytest.mark.parametrize("q_lora_rank", [None, 48], ids=["wq", "q_lora"])
def test_mla_apply_and_decode_match_jax(q_lora_rank):
    kw = dict(MLA_KW, q_lora_rank=q_lora_rank)
    ja, a = JaxAttentionConfig(**kw), AttentionConfig(**kw)
    d_model, B, T = 64, 2, 12
    jp = jax_attn.init_mla(jax.random.PRNGKey(3), ja, d_model, jnp.float32)
    p = _to_torch(jp)
    assert ("wuq" in p) == bool(q_lora_rank) and p["wukv"].dim() == 3
    x = _normal(21, B, T, d_model)
    positions = np.broadcast_to(np.arange(T), (B, T))
    full = attention.mla_apply(p, a, torch.from_numpy(x),
                               positions=torch.from_numpy(positions.copy()))
    jfull = jax_attn.mla_apply(jp, ja, jnp.asarray(x),
                               positions=jnp.asarray(positions), chunk=4)
    np.testing.assert_allclose(_np32(full), _np32(jfull), atol=MLA_TOL,
                               rtol=MLA_TOL)
    cache = attention.mla_init_cache(a, B, T, torch.float32, "cpu")
    jcache = jax_attn.mla_init_cache(ja, B, T, jnp.float32)
    jdecode = jax.jit(lambda p_, x_, c_, t_: jax_attn.mla_decode(
        p_, ja, x_, c_, t_))
    for t in range(T):
        o, cache = attention.mla_decode(
            p, a, torch.from_numpy(x[:, t:t + 1]), cache,
            torch.full((B,), t, dtype=torch.int32))
        jo, jcache = jdecode(jp, jnp.asarray(x[:, t:t + 1]), jcache,
                             jnp.full((B,), t, jnp.int32))
        np.testing.assert_allclose(_np32(o), _np32(jo), atol=MLA_TOL,
                                   rtol=MLA_TOL)
        np.testing.assert_allclose(_np32(o[:, 0]), _np32(full[:, t]),
                                   atol=MLA_TOL, rtol=MLA_TOL)
    for key in ("ckv", "krope", "pos"):
        np.testing.assert_allclose(_np32(cache[key]), _np32(jcache[key]),
                                   atol=1e-6, rtol=1e-6)


def test_mla_decode_ring_buffer_keeps_the_last_slots():
    """A ring of L < T slots: slot t mod L is overwritten, the positions
    say which token each holds, as in the reference."""
    ja, a = JaxAttentionConfig(**MLA_KW), AttentionConfig(**MLA_KW)
    d_model, B, T, L = 64, 1, 10, 4
    jp = jax_attn.init_mla(jax.random.PRNGKey(4), ja, d_model, jnp.float32)
    p = _to_torch(jp)
    x = _normal(22, B, T, d_model)
    cache = attention.mla_init_cache(a, B, L, torch.float32, "cpu")
    jcache = jax_attn.mla_init_cache(ja, B, L, jnp.float32)
    for t in range(T):
        o, cache = attention.mla_decode(p, a, torch.from_numpy(x[:, t:t + 1]),
                                        cache, torch.full((B,), t))
        jo, jcache = jax_attn.mla_decode(jp, ja, jnp.asarray(x[:, t:t + 1]),
                                         jcache, jnp.full((B,), t, jnp.int32))
        np.testing.assert_allclose(_np32(o), _np32(jo), atol=MLA_TOL,
                                   rtol=MLA_TOL)
    assert cache["pos"].tolist() == [[8, 9, 6, 7]]


# ---------------------------------------------------------------------------
# MoE: routing, capacity dispatch with drops, combine, aux
# ---------------------------------------------------------------------------

MOE_KW = dict(n_experts=4, n_shared=1, top_k=2, d_ff_expert=32,
              first_dense_layers=0)


def _reference_drops(x: np.ndarray, w: np.ndarray, m: MoEConfig, C: int):
    """The (token, expert) pairs the reference drops: its router's top-k
    experts (``lax.top_k``), each pair ranked in its expert by token order,
    those ranked C or later."""
    _, idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(w),
                                          axis=-1), m.top_k)
    seen, dropped = {}, set()
    for n, row in enumerate(np.asarray(idx)):
        for e in row:
            seen[int(e)] = seen.get(int(e), 0) + 1
            if seen[int(e)] > C:
                dropped.add((n, int(e)))
    return dropped


@pytest.mark.parametrize("hot", [None, 0], ids=["balanced", "overflow"])
def test_moe_apply_matches_jax(hot):
    """``hot``: that expert's router column scaled up, and the tokens
    shifted along it, so that it overflows its capacity and the pairs past
    it are dropped."""
    jm, m = JaxMoEConfig(**MOE_KW), MoEConfig(**MOE_KW)
    d, B, T = 32, 2, 16
    jp = jax_moe.init_moe(jax.random.PRNGKey(5), jm, d, jnp.float32)
    x = _normal(23, B, T, d)
    if hot is not None:
        w = np.asarray(jp["router"]["w"]).copy()
        x = x + 1.5 * w[:, hot] / np.linalg.norm(w[:, hot])
        w[:, hot] *= 8.0
        jp = dict(jp, router={"w": jnp.asarray(w)})
    p = _to_torch(jp)
    y, aux = moe.moe_apply(p, m, torch.from_numpy(x))
    jy, jaux = jax_moe.moe_apply(jp, jm, jnp.asarray(x))
    np.testing.assert_allclose(_np32(y), _np32(jy), atol=MOE_TOL,
                               rtol=MOE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=MOE_TOL,
                               rtol=MOE_TOL)

    xf = x.reshape(B * T, d)
    probs, _, idx = moe.moe_route(p, m, torch.from_numpy(xf))
    gap = router_gap(_np32(probs), m.top_k)
    print(f"smallest top-{m.top_k} router gap {gap:.3g}")
    assert gap > ROUTER_GAP
    C = moe.moe_capacity(m, B * T)
    _, keep = moe.moe_slots(m, idx, C)
    dropped = {(n, int(e)) for n, row in enumerate(idx.tolist())
               for e, kept in zip(row, keep.view(B * T, -1)[n].tolist())
               if not kept}
    assert dropped == _reference_drops(xf, np.asarray(jp["router"]["w"]), m,
                                       C)
    if hot is None:
        assert not dropped
    else:
        load = int((idx == hot).sum())
        print(f"expert {hot}: {load} pairs for {C} slots, "
              f"{len(dropped)} dropped")
        assert load > C and {e for _, e in dropped} == {hot}
        assert len(dropped) == load - C, (load, C, dropped)


def test_moe_capacity_matches_jax():
    for kw in (MOE_KW, dict(n_experts=64, top_k=6, capacity_factor=1.25),
               dict(n_experts=160, top_k=6)):
        for n in (1, 8, 37, 8192):
            assert moe.moe_capacity(MoEConfig(**kw), n) == \
                jax_moe.moe_capacity(JaxMoEConfig(**kw), n)


# ---------------------------------------------------------------------------
# VLM: patches projected and prepended, their logits dropped
# ---------------------------------------------------------------------------

def test_embed_inputs_and_lm_apply_with_patches():
    jcfg = jax_get_config("phi-3-vision-4.2b").reduced()
    cfg = registry.get_config("phi-3-vision-4.2b").reduced()
    jp = jax_transformer.init_lm(jax.random.PRNGKey(6), jcfg)
    p = _to_torch(jp)
    assert p["projector"]["w"].shape == (cfg.modality.feat_dim, cfg.d_model)
    B, T, n_vis = 2, 12, cfg.modality.n_tokens
    toks = np.random.default_rng(24).integers(0, cfg.vocab, (B, T))
    patches = _normal(25, B, n_vis, cfg.modality.feat_dim)
    x = transformer.embed_inputs(p, cfg, torch.from_numpy(toks),
                                 torch.from_numpy(patches))
    jx = jax_transformer.embed_inputs(jp, jcfg, jnp.asarray(toks),
                                      jnp.asarray(patches))
    assert x.shape == (B, n_vis + T, cfg.d_model)
    np.testing.assert_allclose(_np32(x), _np32(jx), atol=1e-5, rtol=1e-5)
    # without patches the text alone is embedded
    assert transformer.embed_inputs(p, cfg, torch.from_numpy(toks)).shape \
        == (B, T, cfg.d_model)
    logits, aux = transformer.lm_apply(p, cfg, torch.from_numpy(toks),
                                       patches=torch.from_numpy(patches))
    jlogits, jaux = jax_transformer.lm_apply(jp, jcfg, jnp.asarray(toks),
                                             patches=jnp.asarray(patches))
    assert logits.shape == (B, T, cfg.vocab)
    np.testing.assert_allclose(_np32(logits), _np32(jlogits), atol=1e-4,
                               rtol=1e-4)
    assert float(aux) == float(jaux) == 0.0


# ---------------------------------------------------------------------------
# the MoE layer inside the LM: deepseek's dense prefix, the stacked body
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v2-236b"])
def test_moe_lm_layout_follows_the_reference(arch):
    cfg = registry.get_config(arch)
    prefix, n_cycles, P, suffix = transformer.layer_plan(cfg)
    assert (prefix, P, suffix) == ([0], 1, []) and \
        n_cycles == cfg.n_layers - 1
    red = dataclasses.replace(cfg.reduced(), n_layers=3)
    p = model.init_model(torch.Generator().manual_seed(0), red, "cpu")
    assert "w_gate" not in p["prefix"][0]["ffn"]        # the dense layer
    body_ffn = p["body"][0]["ffn"]
    E, ff = red.moe.n_experts, red.moe.d_ff_expert
    assert body_ffn["w_gate"].shape == (2, E, red.d_model, ff)
    assert body_ffn["router"]["w"].dtype == torch.float32
    assert p["body"][0]["mixer"]["wukv"].shape[:2] == (
        2, red.attention.kv_lora_rank)
