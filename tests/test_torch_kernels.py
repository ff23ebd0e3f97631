"""The port's kernel layer against the JAX reference, on the CPU.

The same NumPy inputs, made from a seed, go through ``repro``'s Pallas
kernel (``interpret=True``), its jnp oracle, and ``repro_torch``'s plain
PyTorch version, which is what ``repro_torch.kernels.ops`` runs for a CPU
tensor.  Masks, counts and random streams must be bit-exact; mixing agrees to
2e-5 in float32 and 2e-2 in bfloat16 (one bf16 rounding of the output,
after float32 accumulation in another order).  The CUDA kernels themselves are
held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gaia_select as jax_gaia
from repro.kernels import neighbor_mix as jax_mix
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels import rng as jax_rng
from repro.topology import build_schedule as jax_build_schedule
from repro.topology.graphs import full_skew_label_hist
from repro_torch.kernels import build, ops, ref, rng
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
    rs = np.random.default_rng(0)
    v = torch.from_numpy(rs.standard_normal((5, 300)).astype(np.float32))
    w = torch.from_numpy(rs.standard_normal((5, 300)).astype(np.float32))
    launches = dict(ops.launches)
    sel, cnt = ops.gaia_select(v, w, 0.5)
    rsel, rcnt = ref.gaia_select_ref(v, w, 0.5)
    assert torch.equal(sel, rsel) and int(cnt) == int(rcnt)
    idx, nw, sw = (torch.from_numpy(a) for a in
                   build_schedule("ring", 5).neighbor_arrays(0))
    mixed = ops.neighbor_mix(v, idx.int(), nw.float(), sw.float())
    assert torch.equal(mixed, ref.neighbor_mix_padded_ref(v, idx, nw, sw))
    src = torch.cat([v, w, v])
    mixed = ops.neighbor_mix(v, idx.int() + 5, nw.float(), sw.float(),
                             src=src)
    assert torch.equal(mixed, ref.neighbor_mix_padded_ref(v, idx + 5, nw, sw,
                                                          src))
    sel, cnt = ops.rand_k_sparsify(v, 0.25, 7)
    rsel, rcnt = ref.rand_k_select_ref(v, 0.25, 7)
    assert torch.equal(sel, rsel) and int(cnt) == int(rcnt)
    assert ops.launches == launches


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
    i, w4, s4 = (torch.zeros(4, 2, dtype=torch.int32), torch.zeros(4, 2),
                 torch.zeros(4))
    for bad_src in (torch.zeros(3, 10), torch.zeros(8, 11),
                    torch.zeros(80)):
        with pytest.raises(ValueError, match="src"):
            ops.neighbor_mix(x, i, w4, s4, src=bad_src)
    with pytest.raises(TypeError, match="src"):
        ops.neighbor_mix(x, i, w4, s4, src=torch.zeros(8, 10).double())


@pytest.mark.parametrize("bad", [-1, 4])
def test_neighbor_mix_refuses_index_outside_range(no_kernel_build, bad):
    """An index outside [0, K) raises before any mixing; the CUDA route
    checks the same range (tests/test_torch_cuda.py)."""
    idx = torch.tensor([[1, 3]] * 4, dtype=torch.int32)
    idx[2, 1] = bad
    with pytest.raises(ValueError, match="outside"):
        ops.neighbor_mix(torch.zeros(4, 10), idx, torch.full((4, 2), 0.25),
                         torch.full((4,), 0.5))


@pytest.mark.parametrize("bad", [-1, 12])
def test_neighbor_mix_src_refuses_index_outside_range(no_kernel_build, bad):
    """With ``src`` (M, N) the range is [0, M): AD-PSGD's offset indices
    in [K, M) pass, and an index outside [0, M) raises before mixing."""
    x, src = torch.zeros(4, 10), torch.ones(12, 10)
    w, sw = torch.full((4, 2), 0.25), torch.full((4,), 0.5)
    idx = torch.tensor([[9, 11]] * 4, dtype=torch.int32)
    assert torch.equal(ops.neighbor_mix(x, idx, w, sw, src=src),
                       torch.full((4, 10), 0.5))
    idx[2, 1] = bad
    with pytest.raises(ValueError, match=r"outside \[0, 12\)"):
        ops.neighbor_mix(x, idx, w, sw, src=src)


# ---------------------------------------------------------------------------
# the counter-hash RNG and rand-k
# ---------------------------------------------------------------------------

#: keys include one past 2**31; counters reach 2**24
RNG_KEYS = [0, 7, 123456789, 2**31 + 5, 2**32 - 1]


def test_rng_torch_path_bit_equal():
    ctr = np.concatenate([np.arange(5000), np.arange(2**24 - 5000, 2**24 + 1),
                          [2**31 - 1, 2**32 - 1]]).astype(np.int64)
    tctr = torch.from_numpy(ctr)
    for key in RNG_KEYS:
        bits = rng.uniform_bits(key, tctr)
        assert bits.dtype == torch.int64
        np.testing.assert_array_equal(bits.numpy(),
                                      rng.uniform_bits(key, ctr))
        np.testing.assert_array_equal(
            bits.numpy(), np.asarray(jax_rng.uniform_bits(
                jnp.uint32(key), jnp.asarray(ctr.astype(np.uint32)))))
        u = rng.uniform01(key, tctr)
        assert u.dtype == torch.float32
        np.testing.assert_array_equal(u.numpy(), rng.uniform01(key, ctr))
        np.testing.assert_array_equal(u.numpy(), np.asarray(
            jax_rng.uniform01(jnp.uint32(key),
                              jnp.asarray(ctr.astype(np.uint32)))))


#: 1 - 0.999 in float32, as the trainer computes DGC's keep probability:
#: exactly 16777 * 2**-24.  In float64 it is 0.0010000000000000009, which
#: would keep an element whose uniform is 16777 * 2**-24.
KEEP_999 = float(np.float32(1) - np.float32(0.999))
#: (seed, flat index) whose uniform is exactly KEEP_999; one seed past 2**31
BOUNDARY = [(3594, 588), (2147489716, 826)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [1000, 8192, 12345])
def test_rand_k_select_ref_matches_jax(n, dtype):
    v_np = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    jv, tv = _pair(v_np, dtype)
    assert KEEP_999 == 16777 * 2.0 ** -24
    for keep in (0.25, KEEP_999):
        for seed, at in [(11, None)] + BOUNDARY:
            sel, cnt = ref.rand_k_select_ref(tv, keep, seed)
            assert sel.dtype == tv.dtype and cnt.dtype == torch.int32
            jseed = np.uint32(seed).view(np.int32)      # the reference's int32
            jkeep = jnp.float32(keep)
            for other_sel, other_cnt in (
                    jax_ref.rand_k_select_ref(jv, jkeep, jseed),
                    jax_ops.rand_k_sparsify(jv, jkeep, jseed,
                                            interpret=True)):
                np.testing.assert_array_equal(_np32(sel), _np32(other_sel))
                assert int(cnt) == int(other_cnt)
            if at is not None and keep == KEEP_999:
                # the element on the boundary is dropped: u < keep is false
                assert float(rng.uniform01(seed, torch.tensor([at]))) == keep
                assert float(sel[at]) == 0.0
            assert 0 < int(cnt) < n or keep == KEEP_999
        assert torch.equal(ops.rand_k_sparsify(tv, keep, 11)[0],
                           ref.rand_k_select_ref(tv, keep, 11)[0])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("topology", ["ring", "random", "tv-dcliques"])
def test_neighbor_mix_src_ref_matches_jax(topology, dtype):
    """AD-PSGD's stale mixing at staleness 2: neighbour rows from a
    (3K, N) snapshot buffer through ``stale * K + nbr``, self term on x."""
    K, N, S = 10, 1000, 2
    _, tsched = _schedule_pair(topology, K)
    tol = DTYPES[dtype][2]
    rs = np.random.default_rng(8)
    x_np = rs.standard_normal((K, N)).astype(np.float32)
    src_np = np.concatenate(
        [x_np, rs.standard_normal((S * K, N)).astype(np.float32)])
    jx, tx = _pair(x_np, dtype)
    jsrc, tsrc = _pair(src_np, dtype)
    for t in range(min(tsched.period, 3)):
        idx, w, sw = tsched.neighbor_arrays(t)
        gidx = (np.where(w > 0, S, 0) * K + idx).astype(np.int32)
        ops_t = tuple(torch.from_numpy(a) for a in (
            gidx, w.astype(np.float32), sw.astype(np.float32)))
        out = ref.neighbor_mix_padded_ref(tx, *ops_t, tsrc)
        assert out.dtype == tx.dtype and out.shape == (K, N)
        assert torch.equal(out, ops.neighbor_mix(tx, *ops_t, src=tsrc))
        jops = (jnp.asarray(gidx), jnp.asarray(w, jnp.float32),
                jnp.asarray(sw, jnp.float32))
        for e in (jax_ops.neighbor_mix(jx, *jops, src=jsrc, interpret=True),
                  jax_ref.neighbor_mix_padded_ref(jx, *jops, jsrc),
                  jax_ref.neighbor_mix_src_ref(jx, jsrc, *jops)):
            np.testing.assert_allclose(_np32(out), _np32(e), atol=tol,
                                       rtol=tol)
