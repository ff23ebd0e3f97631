"""The port's kernel layer against the JAX reference, on the CPU.

The same NumPy inputs, made from a seed, go through ``repro``'s Pallas
kernel (``interpret=True``), its jnp oracle, and ``repro_torch``'s plain
PyTorch version, which is what ``repro_torch.kernels.ops`` runs for a CPU
tensor.  Masks and counts must be bit-exact; mixing agrees to 2e-5 in
float32 and 2e-2 in bfloat16 (one bf16 rounding of the output, after
float32 accumulation in another order).  The CUDA kernels themselves are
held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gaia_select as jax_gaia
from repro.kernels import neighbor_mix as jax_mix
from repro.kernels import ref as jax_ref
from repro.topology import build_schedule as jax_build_schedule
from repro.topology.graphs import full_skew_label_hist
from repro_torch.kernels import build, ops, ref
from repro_torch.topology import build_schedule

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(a: np.ndarray, dtype: str):
    """One float32 NumPy array as a JAX and a torch array of ``dtype``
    (both round float32 -> bfloat16 to nearest even: the same bits)."""
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [1000, 8192, 12345])
def test_gaia_select_ref_matches_jax(n, dtype):
    rng = np.random.default_rng(n)
    v_np = rng.standard_normal(n).astype(np.float32) * 0.01
    w_np = rng.standard_normal(n).astype(np.float32) * 0.3
    jv, tv = _pair(v_np, dtype)
    jw, tw = _pair(w_np, dtype)
    for t in (0.0, 0.05, 0.1):
        t32 = np.float32(t)
        sel, cnt = ref.gaia_select_ref(tv, tw, t32)
        assert sel.dtype == tv.dtype and cnt.dtype == torch.int32
        k_sel, k_cnt = jax_gaia.gaia_select(jv, jw, t32, interpret=True)
        o_sel, o_cnt = jax_ref.gaia_select_ref(jv, jw, jnp.float32(t))
        for other_sel, other_cnt in ((k_sel, k_cnt), (o_sel, o_cnt)):
            np.testing.assert_array_equal(_np32(sel), _np32(other_sel))
            np.testing.assert_array_equal(_np32(sel) != 0,
                                          _np32(other_sel) != 0)
            assert int(cnt) == int(other_cnt)
        assert 0 < int(cnt) < n or t == 0.0


def _schedule_pair(name: str, K: int):
    hist = full_skew_label_hist(K, 5) if name == "tv-dcliques" else None
    return (jax_build_schedule(name, K, label_hist=hist, seed=3),
            build_schedule(name, K, label_hist=hist, seed=3))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("topology", ["ring", "random", "tv-dcliques"])
def test_neighbor_mix_ref_matches_jax(topology, dtype):
    K, N = 10, 1000
    jsched, tsched = _schedule_pair(topology, K)
    tol = DTYPES[dtype][2]
    x_np = np.random.default_rng(7).standard_normal((K, N)).astype(np.float32)
    jx, tx = _pair(x_np, dtype)
    for t in range(min(jsched.period, 3)):
        # the port's NumPy topology hands the kernel the same operands
        ops_j = jsched.neighbor_arrays(t)
        ops_t = tsched.neighbor_arrays(t)
        for a, b in zip(ops_j, ops_t):
            np.testing.assert_array_equal(a, b)
        idx, w, sw = ops_t
        out = ref.neighbor_mix_padded_ref(
            tx, torch.from_numpy(idx.astype(np.int32)),
            torch.from_numpy(w.astype(np.float32)),
            torch.from_numpy(sw.astype(np.float32)))
        assert out.dtype == tx.dtype and out.shape == (K, N)
        jops = (jnp.asarray(idx, jnp.int32), jnp.asarray(w, jnp.float32),
                jnp.asarray(sw, jnp.float32))
        expects = [
            jax_mix.neighbor_mix(jx, *jops, interpret=True),
            jax_ref.neighbor_mix_padded_ref(jx, *jops),
            jax_ref.neighbor_mix_ref(jx, jnp.asarray(jsched.at(t).mixing,
                                                     jnp.float32)),
        ]
        for e in expects:
            np.testing.assert_allclose(_np32(out), _np32(e), atol=tol,
                                       rtol=tol)
        dense = ref.neighbor_mix_ref(
            tx, torch.from_numpy(tsched.at(t).mixing.astype(np.float32)))
        np.testing.assert_allclose(_np32(out), _np32(dense), atol=tol,
                                   rtol=tol)


@pytest.fixture
def no_kernel_build(monkeypatch):
    """Fail the test if anything asks for a CUDA kernel."""
    def refuse(name):
        raise AssertionError(f"CPU tensors must not load the {name} kernel")
    monkeypatch.setattr(build, "load", refuse)


def test_ops_route_cpu_tensors_to_ref(no_kernel_build):
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal((5, 300)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 300)).astype(np.float32))
    launches = (ops.gaia_select.launches, ops.neighbor_mix.launches)
    sel, cnt = ops.gaia_select(v, w, 0.5)
    rsel, rcnt = ref.gaia_select_ref(v, w, 0.5)
    assert torch.equal(sel, rsel) and int(cnt) == int(rcnt)
    idx, nw, sw = (torch.from_numpy(a) for a in
                   build_schedule("ring", 5).neighbor_arrays(0))
    mixed = ops.neighbor_mix(v, idx.int(), nw.float(), sw.float())
    assert torch.equal(mixed, ref.neighbor_mix_padded_ref(v, idx, nw, sw))
    assert (ops.gaia_select.launches, ops.neighbor_mix.launches) == launches


def test_ops_reject_bad_operands(no_kernel_build):
    x = torch.zeros(4, 10)
    with pytest.raises(ValueError):
        ops.gaia_select(x, torch.zeros(4, 11), 0.1)
    with pytest.raises(ValueError):
        ops.neighbor_mix(x, torch.zeros(3, 2, dtype=torch.int32),
                         torch.zeros(3, 2), torch.zeros(4))
    with pytest.raises(ValueError):
        ops.neighbor_mix(x.reshape(-1), torch.zeros(4, 2, dtype=torch.int32),
                         torch.zeros(4, 2), torch.zeros(4))
    with pytest.raises(ValueError):     # tensors on two devices
        ops.gaia_select(x, torch.zeros(4, 10, device="meta"), 0.1)


@pytest.mark.parametrize("bad", [-1, 4])
def test_neighbor_mix_refuses_index_outside_range(no_kernel_build, bad):
    """An index outside [0, K) raises before any mixing; the CUDA route
    checks the same range (tests/test_torch_cuda.py)."""
    idx = torch.tensor([[1, 3]] * 4, dtype=torch.int32)
    idx[2, 1] = bad
    with pytest.raises(ValueError, match="outside"):
        ops.neighbor_mix(torch.zeros(4, 10), idx, torch.full((4, 2), 0.25),
                         torch.full((4,), 0.5))
