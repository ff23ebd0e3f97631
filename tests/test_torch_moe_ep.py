"""The port's two MoE routes inside a pod, on the CPU.

The reference has two MoE functions, and the port names each:
- the dense route, its default (``repro/models/moe.py``): one function
  of the pod's tokens, with the global capacity ``moe_capacity(m, N)``
  and the *global* auxiliary loss, the Switch/GShard loss of the pod's
  routing statistics.  Under a mesh the port's dense route must equal
  the one-device ``moe_apply``;
- the expert-parallel (EP) route, which the reference turns on with
  ``REPRO_MOE_EP`` (``repro/models/moe_ep.py``): a capacity per (source
  rank, destination peer) and per local expert, and as auxiliary loss
  the *mean of the per-shard losses* (``pmean`` over data and model).
  Where the shards' routing statistics differ, so do the two losses;
  ROADMAP C11 asks which one a run should take.

Held here:
(i) the port's plain EP route, ``moe_apply_ep_ref`` (one process, the
    all-to-all emulated), against the reference's ``moe_apply_ep`` run
    under ``shard_map`` in a subprocess that sets
    ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` before it
    imports JAX, on the reduced deepseek-v2-lite-16b's MoE over (data,
    model) = (1, 4) and (2, 2): y and aux within 2e-5 x max(1, max|y|),
    on tokens pushed towards experts 0 and 1, so that (source, peer)
    pairs overflow ``C_send`` and are dropped (counted);
(ii) on four gloo ranks (``procs.spawn``, one thread each, a deadline)
    over (1, 1, 4) and (1, 2, 2): the ranked EP route (``moe_apply(...,
    route="ep")`` under ``activation_sharding``) against
    ``moe_apply_ep_ref`` plus the shared experts, and the ranked dense
    route against the one-device ``moe_apply``, within the same bound;
(iii) the gradients of ``all_to_all_model``, ``gather_model`` and
    ``gather_from_model`` on the ranks against the same functions
    written in one process (bit for bit where the backward is a
    permutation or a slice; within 1e-6 for ``gather_model``'s
    reduce-scatter, which sums M terms in the backend's order).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro_torch.configs.registry import get_config
from repro_torch.launch import collectives as coll
from repro_torch.launch import procs, sharding
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe, moe_ep
from repro_torch.models.layers import gated_mlp_apply
from repro_torch.models.shard_hints import activation_sharding

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5
SPAWN_TIMEOUT = 240
ARCH = "deepseek-v2-lite-16b"
#: (data, model) of the reference's mesh in (i); the ranks' (1, D, M)
REF_MESHES = ((1, 4), (2, 2))
RANK_MESHES = ((1, 1, 4), (1, 2, 2))
#: the tokens: (B, T), and the push of every token's router logits
#: towards experts 0 and 1 (so C_send overflows)
B, T, PUSH = 2, 64, 3.0
ROUTER_GAP = 1e-4


def _cfg():
    return get_config(ARCH).reduced()


def _params():
    m, d = _cfg().moe, _cfg().d_model
    return moe.init_moe(torch.Generator().manual_seed(3), m, d,
                        torch.float32, "cpu")


def _tokens(p):
    """(B, T, d) normals plus a push along the router's columns 0 and 1."""
    d = _cfg().d_model
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, T, d)).astype(np.float32))
    w = p["router"]["w"]
    push = w[:, 0] / w[:, 0].square().sum() + w[:, 1] / w[:, 1].square().sum()
    return x + PUSH * push


def _bound(want):
    return TOL * max(1.0, float(want.abs().max()))


def router_gap(probs, k):
    top = np.log(-np.sort(-probs.astype(np.float64), axis=-1))
    return float((top[:, k - 1] - top[:, k]).min())


# ---------------------------------------------------------------------------
# (i) the plain EP route against the reference's moe_apply_ep
# ---------------------------------------------------------------------------

_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, {src!r})
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config
    from repro.models import moe as moe_mod
    from repro.models import moe_ep
    z = np.load({inp!r})
    m = get_config({arch!r}).reduced().moe
    p = {{"router": {{"w": jnp.asarray(z["router"])}},
         "w_gate": jnp.asarray(z["w_gate"]), "w_up": jnp.asarray(z["w_up"]),
         "w_down": jnp.asarray(z["w_down"])}}
    x = jnp.asarray(z["x"])
    out = {{}}
    y, aux = moe_mod.moe_apply(p, m, x)
    out["dense_y"], out["dense_aux"] = np.asarray(y), np.asarray(aux)
    for D, M in {meshes!r}:
        mesh = jax.make_mesh((D, M), ("data", "model"))
        with mesh:
            y, aux = jax.jit(lambda p, x: moe_ep.moe_apply_ep(
                p, m, x, mesh))(p, x)
        out[f"y_{{D}}x{{M}}"] = np.asarray(y)
        out[f"aux_{{D}}x{{M}}"] = np.asarray(aux)
    np.savez({out!r}, **out)
    print("REF_EP_OK")
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's dense ``moe_apply`` on one device and its
    ``moe_apply_ep`` on each (D, M) of ``REF_MESHES``, from a subprocess
    with four host devices, on the routed experts of ``_params()``."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    p = _params()
    inp, out = str(tmp / "in.npz"), str(tmp / "out.npz")
    np.savez(inp, router=p["router"]["w"].numpy(),
             w_gate=p["w_gate"].numpy(), w_up=p["w_up"].numpy(),
             w_down=p["w_down"].numpy(), x=_tokens(p).numpy())
    script = tmp / "ref_ep.py"
    script.write_text(_SCRIPT.format(src=os.path.join(ROOT, "src"), inp=inp,
                                     out=out, arch=ARCH,
                                     meshes=list(REF_MESHES)))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0 and "REF_EP_OK" in r.stdout, r.stderr[-3000:]
    with np.load(out) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


def _drops(p, x, D, M):
    """(pairs dropped at C_send, pairs) over the D x M shards of ``x``."""
    m = _cfg().moe
    b, span = B // D, T // M
    c_send, _ = moe_ep.ep_capacities(m, b * span, M)
    dropped = total = 0
    for r in range(D):
        for i in range(M):
            xb = x[r * b:(r + 1) * b, i * span:(i + 1) * span].reshape(
                -1, x.shape[-1])
            keep = moe_ep._dispatch(m, xb, p["router"]["w"], M, c_send)[2][1]
            dropped += int((~keep).sum())
            total += keep.numel()
    return dropped, total


@pytest.mark.parametrize("mesh", REF_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ep_ref_matches_reference_moe_apply_ep(reference, mesh):
    D, M = mesh
    m = _cfg().moe
    p = _params()
    x = _tokens(p)
    probs = torch.softmax(x.reshape(-1, x.shape[-1]) @ p["router"]["w"], -1)
    gap = router_gap(probs.numpy(), m.top_k)
    assert gap > ROUTER_GAP, gap
    dropped, total = _drops(p, x, D, M)
    assert 0 < dropped < total, (dropped, total)
    y, aux = moe_ep.moe_apply_ep_ref(p, m, x, D, M)
    want_y, want_aux = reference[f"y_{D}x{M}"], reference[f"aux_{D}x{M}"]
    err = float((y - want_y).abs().max())
    assert err <= _bound(want_y), (err, dropped)
    assert abs(float(aux) - float(want_aux)) <= _bound(want_y), (
        float(aux), float(want_aux))


def test_dense_route_matches_reference_and_differs_from_ep(reference):
    """The one-device dense route is the reference's ``moe_apply``; where
    pairs drop, the EP route is another function (C11): its y and aux
    differ from the dense route's."""
    m = _cfg().moe
    p = {k: v for k, v in _params().items() if k != "shared"}
    x = _tokens(p)
    y, aux = moe.moe_apply(p, m, x)
    assert float((y - reference["dense_y"]).abs().max()) <= _bound(
        reference["dense_y"])
    assert abs(float(aux) - float(reference["dense_aux"])) <= _bound(
        reference["dense_y"])
    for D, M in REF_MESHES:
        assert float((reference[f"y_{D}x{M}"] - y).abs().max()) > 1e-3
        assert abs(float(reference[f"aux_{D}x{M}"]) - float(aux)) > 1e-7


# ---------------------------------------------------------------------------
# (ii), (iii) on gloo ranks
# ---------------------------------------------------------------------------

def _grads_on_rank(mesh):
    """The gradients of the three collectives on this rank: each input a
    seeded (2M, 3) block, each loss weighted by a seeded rank-wise (or,
    for ``gather_from_model``, shared) tensor."""
    M, i = mesh.size_of("model"), mesh.coords["model"]
    out = {}
    for name in ("all_to_all_model", "gather_model", "gather_from_model"):
        x = torch.from_numpy(np.random.default_rng(10 + i).standard_normal(
            (2 * M, 3)).astype(np.float32)).requires_grad_()
        if name == "all_to_all_model":
            y = coll.all_to_all_model(x, mesh)
        elif name == "gather_model":
            y = coll.gather_model(x, 0, mesh)
        else:
            y = coll.gather_from_model(x, 0, mesh)
        seed = 50 if name == "gather_from_model" else 20 + i
        w = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            tuple(y.shape)).astype(np.float32))
        (g,) = torch.autograd.grad((y * w).sum(), x)
        out[name] = g
    return out


def _grads_one_process(M):
    """The same three functions written in one process over M inputs: the
    gradient of the ranks' summed losses (one loss for
    ``gather_from_model``, whose downstream is the same on every rank)."""
    out = {}
    for name in ("all_to_all_model", "gather_model", "gather_from_model"):
        xs = [torch.from_numpy(np.random.default_rng(10 + i)
                               .standard_normal((2 * M, 3))
                               .astype(np.float32)).requires_grad_()
              for i in range(M)]
        if name == "all_to_all_model":
            ys = [torch.cat([x.view(M, 2, 3)[j] for x in xs])
                  for j in range(M)]
        else:
            ys = [torch.cat(xs)] * M
        loss = 0
        for j, y in enumerate(ys):
            seed = 50 if name == "gather_from_model" else 20 + j
            w = torch.from_numpy(np.random.default_rng(seed).standard_normal(
                tuple(y.shape)).astype(np.float32))
            loss = loss + (y * w).sum()
            if name == "gather_from_model":
                break
        out[name] = list(torch.autograd.grad(loss, xs))
    return out


def _ranks(rank, dev):
    torch.set_num_threads(1)
    cfg = _cfg()
    m = cfg.moe
    p = _params()
    x = _tokens(p)
    res = {}
    for shape in RANK_MESHES:
        mesh = make_mesh(shape, device=dev)
        local = sharding.local_params({"ffn": p}, mesh)["ffn"]
        rows = sharding.local_block(x, ("data", None, None), mesh)
        out = {}
        with activation_sharding(mesh):
            for route in moe.ROUTES:
                y, aux = moe.moe_apply(local, m, rows, route)
                out[route] = (y, float(aux))
        out["grads"] = _grads_on_rank(mesh)
        out["coords"] = mesh.coords
        res[shape] = out
    return res


@pytest.fixture(scope="module")
def ranks():
    return procs.spawn(_ranks, 4, backend="gloo", device="cpu",
                       timeout=SPAWN_TIMEOUT)


def _rows(results, shape, route):
    """The ranks' y rows stacked in data order (model rank 0 of each);
    every model rank's rows equal its model peers' (asserted)."""
    D, M = shape[1], shape[2]
    out = []
    for r in range(D):
        ys = [results[r * M + i][shape][route][0] for i in range(M)]
        for y in ys[1:]:
            assert torch.equal(y, ys[0])
        out.append(ys[0])
    return torch.cat(out)


@pytest.mark.parametrize("shape", RANK_MESHES, ids=lambda s: "x".join(
    map(str, s)))
def test_ranked_ep_route_matches_ep_ref(ranks, shape):
    m = _cfg().moe
    p = _params()
    x = _tokens(p)
    y_ref, aux_ref = moe_ep.moe_apply_ep_ref(p, m, x, shape[1], shape[2])
    y_ref = y_ref + gated_mlp_apply(p["shared"], x)
    y = _rows(ranks, shape, "ep")
    assert float((y - y_ref).abs().max()) <= _bound(y_ref)
    for r in ranks:
        assert abs(r[shape]["ep"][1] - float(aux_ref)) <= _bound(y_ref)


@pytest.mark.parametrize("shape", RANK_MESHES, ids=lambda s: "x".join(
    map(str, s)))
def test_ranked_dense_route_matches_one_device(ranks, shape):
    m = _cfg().moe
    p = _params()
    x = _tokens(p)
    y_ref, aux_ref = moe.moe_apply(p, m, x)
    y = _rows(ranks, shape, "dense")
    assert float((y - y_ref).abs().max()) <= _bound(y_ref)
    for r in ranks:
        assert abs(r[shape]["dense"][1] - float(aux_ref)) <= _bound(y_ref)


@pytest.mark.parametrize("name", ["all_to_all_model", "gather_model",
                                  "gather_from_model"])
@pytest.mark.parametrize("shape", RANK_MESHES, ids=lambda s: "x".join(
    map(str, s)))
def test_collective_gradients_match_one_process(ranks, shape, name):
    M = shape[2]
    want = _grads_one_process(M)[name]
    for r in ranks:
        i = r[shape]["coords"]["model"]
        got = r[shape]["grads"][name]
        if name == "gather_model":
            torch.testing.assert_close(got, want[i], rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(got, want[i]), (name, i)


def test_ep_applicable_is_the_reference_rule():
    """A one-token decode step on a model axis above 1 takes the dense
    route; tokens that split over every rank take the EP route."""
    from repro_torch.launch.mesh import AXES, Mesh
    m = _cfg().moe
    mesh = Mesh((1, 2, 2), AXES)
    assert not moe_ep.ep_applicable_seq(m, 8, 1, mesh)
    assert moe_ep.ep_applicable_seq(m, 8, 16, mesh)
    assert not moe_ep.ep_applicable_seq(m, 8, 16, None)
    assert not moe_ep.ep_applicable_seq(
        dataclasses.replace(m, n_experts=3), 8, 16, mesh)
    assert moe_ep.ep_capacities(m, 32, 4) == (24, 120)
