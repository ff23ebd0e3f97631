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
import types

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
from repro_torch.configs.cnn_zoo import CNN_ZOO
from repro_torch.core.algorithms.base import tree_leaf_order
from repro_torch.kernels import build, ops, ref, rng
from repro_torch.models.cnn import init_cnn, reference_perm
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


# ---------------------------------------------------------------------------
# DGC's histogram route and GroupNorm: routing and refusals (parity with the
# reference is in tests/test_torch_dgc_gn.py)
# ---------------------------------------------------------------------------

def test_dgc_and_group_norm_ops_route_cpu_tensors_to_ref(no_kernel_build):
    rs = np.random.default_rng(3)
    v = torch.from_numpy(rs.standard_normal((5, 300)).astype(np.float32))
    launches = dict(ops.launches)
    vm = float(v.abs().max())
    assert torch.equal(ops.abs_histogram(v, vm),
                       ref.abs_histogram_ref(v, 256, vm))
    hist, v_max = ops.abs_histogram_fused(v, n_bins=64)
    assert float(v_max) == vm
    assert torch.equal(hist, ref.abs_histogram_ref(v, 64, vm))
    sel, cnt = ops.dgc_select(v, 1.0)
    rsel, rcnt = ref.dgc_select_ref(v, 1.0)
    assert torch.equal(sel, rsel) and int(cnt) == int(rcnt)
    for got, expect in zip(ops.dgc_sparsify(v, 0.99),
                           ref.dgc_sparsify_ref(v, 0.99)):
        assert torch.equal(got, expect)
    x = torch.from_numpy(rs.standard_normal((2, 4, 4, 8)).astype(np.float32))
    sc, bi = torch.ones(8), torch.zeros(8)
    assert torch.equal(ops.group_norm(x, sc, bi, group_size=4),
                       ref.group_norm_ref(x, sc, bi, group_size=4))
    assert ops.launches == launches


def test_dgc_and_group_norm_ops_reject_bad_operands(no_kernel_build):
    v = torch.zeros(100)
    for n_bins in (0, ops.MAX_BINS + 1):
        with pytest.raises(ValueError, match="n_bins"):
            ops.abs_histogram(v, 1.0, n_bins=n_bins)
        with pytest.raises(ValueError, match="n_bins"):
            ops.abs_histogram_fused(v, n_bins=n_bins)
        with pytest.raises(ValueError, match="n_bins"):
            ops.dgc_sparsify(v, 0.9, n_bins=n_bins)
    assert ops.abs_histogram(v, 1.0, n_bins=ops.MAX_BINS).shape == \
        (ops.MAX_BINS,)
    with pytest.raises(ValueError, match="scalar"):
        ops.abs_histogram(v, torch.ones(2))
    with pytest.raises(ValueError, match="scalar"):
        ops.dgc_select(v, torch.ones(3))
    with pytest.raises(ValueError, match="empty"):
        ops.dgc_sparsify(torch.zeros(0), 0.9)
    # a meta tensor is a description: the op's meta route; any device but
    # the CPU, CUDA and meta has no kernel
    sel, cnt = ops.dgc_select(torch.zeros(4, device="meta"),
                              torch.tensor(0.5))
    assert sel.device.type == "meta" and cnt.dtype == torch.int32
    with pytest.raises(ValueError, match="no kernel"):
        ops._device_type(types.SimpleNamespace(device=torch.device("mps")))
    x = torch.zeros(2, 4, 4, 6)
    with pytest.raises(ValueError, match="multiple"):
        ops.group_norm(x, torch.ones(6), torch.zeros(6), group_size=4)
    with pytest.raises(ValueError, match="multiple"):
        ops.group_norm(x, torch.ones(6), torch.zeros(6), group_size=0)
    with pytest.raises(ValueError, match="scale"):
        ops.group_norm(x, torch.ones(4), torch.zeros(6), group_size=2)
    with pytest.raises(ValueError, match="B, H, W, C"):
        ops.group_norm(x[0], torch.ones(6), torch.zeros(6), group_size=2)


# ---------------------------------------------------------------------------
# gaia_select_many and rand_k_sparsify_many: every GN-LeNet tensor at K=5
# in one op, against the reference's kernels (interpret mode) one tensor
# at a time, the reference's tensors in its own layout (conv weights HWIO)
# ---------------------------------------------------------------------------

def _gn_lenet_leaves(dtype: str, K: int = 5):
    """GN-LeNet's parameter tensors stacked at K, in the reference's leaf
    order: [(name, perm, port tensor, JAX tensor in the reference's
    layout)] of seeded normals (two independent sets)."""
    params, _ = init_cnn(torch.Generator().manual_seed(0), CNN_ZOO["gn-lenet"])
    assert len(params) == 16
    rs = np.random.default_rng(5)
    sets = ([], [])
    for name in tree_leaf_order(params):
        perm = reference_perm(name)
        shape = (K,) + tuple(params[name].shape)
        to_ref, from_ref = ref.reference_layout(perm, len(shape))
        ref_shape = tuple(to_ref(torch.empty(shape)).shape)
        for out in sets:
            a = rs.standard_normal(ref_shape).astype(np.float32) * 0.01
            j, t = _pair(a, dtype)
            out.append((name, perm, from_ref(t), j))
    return sets


def _ref_layout_np(t: torch.Tensor, perm) -> np.ndarray:
    return _np32(ref.reference_layout(perm, t.dim())[0](t))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gaia_select_many_matches_jax_per_tensor(dtype):
    vs, ws = _gn_lenet_leaves(dtype)
    launches = dict(ops.launches)
    t = np.float32(0.05)
    outs, counts = ops.gaia_select_many([v for _, _, v, _ in vs],
                                        [w for _, _, w, _ in ws], t)
    assert ops.launches == launches                 # the CPU launches nothing
    assert counts.dtype == torch.int32 and counts.shape == (16,)
    for (name, perm, _, jv), (_, _, _, jw), out, cnt in zip(vs, ws, outs,
                                                            counts):
        k_sel, k_cnt = jax_ops.gaia_select(jv, jw, t, interpret=True)
        np.testing.assert_array_equal(_ref_layout_np(out, perm),
                                      _np32(k_sel), err_msg=name)
        assert int(cnt) == int(k_cnt), name
    assert 0 < int(counts.sum()) < sum(v.numel() for _, _, v, _ in vs)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rand_k_sparsify_many_matches_jax_per_tensor(dtype):
    """Each tensor's counters in the reference's layout, acc and vel by
    one stream, seeds past 2**31: the selections, vel less its selection
    and the counts are the reference's bits, its ``rand_k_sparsify`` run
    on each tensor in its own layout."""
    accs, vels = _gn_lenet_leaves(dtype)
    keep = np.float32(0.25)
    seeds = [(2**31 + 7) * 1009 + li for li in range(len(accs))]
    shared, new_vels, counts = ops.rand_k_sparsify_many(
        [a for _, _, a, _ in accs], [u for _, _, u, _ in vels], keep, seeds,
        [perm for _, perm, _, _ in accs])
    assert counts.dtype == torch.int32 and counts.shape == (16,)
    for li, ((name, perm, _, ja), (_, _, _, ju)) in enumerate(zip(accs,
                                                                  vels)):
        jseed = np.uint32(seeds[li] & 0xFFFFFFFF).view(np.int32)
        sv, cnt = jax_ops.rand_k_sparsify(ja, keep, jseed, interpret=True)
        su, _ = jax_ops.rand_k_sparsify(ju, keep, jseed, interpret=True)
        np.testing.assert_array_equal(_ref_layout_np(shared[li], perm),
                                      _np32(sv), err_msg=name)
        np.testing.assert_array_equal(_ref_layout_np(new_vels[li], perm),
                                      _np32(ju - su), err_msg=name)
        assert int(counts[li]) == int(cnt), name


@pytest.mark.parametrize("name", ["conv.0.w", "conv.1.w", "conv.1.b",
                                  "fc.0.w"])
def test_rand_k_counter_layout_is_the_reference_flat_index(name):
    """What ``rand_k_select.cu`` computes from ``ops._counter_layout``:
    splitting flat index i over the port's dims and summing each index
    times its stride gives the element's flat index in the reference's
    layout."""
    params, _ = init_cnn(torch.Generator().manual_seed(0), CNN_ZOO["gn-lenet"])
    shape = (5,) + tuple(params[name].shape)
    perm = reference_perm(name)
    dims, sizes, strides = ops._counter_layout(shape, perm)
    i = np.arange(int(np.prod(shape)), dtype=np.int64)
    if dims == 0:
        counter = i
    else:
        rem, counter = i.copy(), np.zeros_like(i)
        for d in range(dims - 1, -1, -1):
            counter += (rem % sizes[d]) * strides[d]
            rem //= sizes[d]
    to_ref, from_ref = ref.reference_layout(perm, len(shape))
    ref_shape = to_ref(torch.empty(shape)).shape
    expect = from_ref(torch.arange(i.size).reshape(ref_shape)).reshape(-1)
    np.testing.assert_array_equal(counter, expect.numpy())


def test_many_ops_refuse_bad_lists(no_kernel_build):
    x = torch.zeros(5, 4, 3)
    bad = [(lambda: ops.gaia_select_many([], [], 0.1), "one length"),
           (lambda: ops.gaia_select_many([x, x], [x], 0.1), "one length"),
           (lambda: ops.gaia_select_many([x], [x[:, :2]], 0.1), "differ"),
           (lambda: ops.rand_k_sparsify_many([x], [x], 0.5, [1, 2],
                                             [None]), "one length"),
           (lambda: ops.rand_k_sparsify_many([x], [x[:2]], 0.5, [1],
                                             [None]), "differ"),
           (lambda: ops.rand_k_sparsify_many([x], [x], 0.5, [1], [(0, 0)]),
            "permute")]
    launches = dict(ops.launches)
    for call, match in bad:
        with pytest.raises(ValueError, match=match):
            call()
    assert ops.launches == launches


# ---------------------------------------------------------------------------
# neighbor_mix_many and neighbor_mix_push_many: D-PSGD's and AD-PSGD's
# rounds over a model's leaves, against the reference's kernel (interpret
# mode) on the leaves concatenated as the reference's step concatenates them
# ---------------------------------------------------------------------------

#: per-node leaf shapes: a conv weight, norm scales, sizes off a multiple of
#: 4 (the kernel's 16-byte vectors) and a leaf of one element
MIX_LEAF_SHAPES = [(5, 5, 3, 8), (8,), (8,), (37,), (10, 13), (1,), (10,)]


def _leaf_pair(K: int, dtype: str, seed: int):
    """Seeded normal leaves stacked at K: (JAX leaves, torch leaves)."""
    rs = np.random.default_rng(seed)
    pairs = [_pair(rs.standard_normal((K,) + s).astype(np.float32), dtype)
             for s in MIX_LEAF_SHAPES]
    return [j for j, _ in pairs], [t for _, t in pairs]


def _flat_jax(jleaves, K: int):
    return jnp.concatenate([j.reshape(K, -1) for j in jleaves], axis=1)


def _split_np(flat, like):
    sizes = np.cumsum([t[0].numel() for t in like])[:-1]
    return [p.reshape(t.shape) for p, t in
            zip(np.split(_np32(flat), sizes, axis=1), like)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("topology", ["ring", "torus", "random"])
def test_neighbor_mix_many_ref_matches_jax(topology, dtype):
    """Each leaf mixed on its own equals the reference's kernel on the
    leaves concatenated (D-PSGD's flatten), split back."""
    K = 16
    tol = DTYPES[dtype][2]
    idx, w, sw = build_schedule(topology, K, seed=3).neighbor_arrays(0)
    mix = ops.mix_operands(idx, w, sw, K, "cpu")
    jleaves, leaves = _leaf_pair(K, dtype, 11)
    outs = ops.neighbor_mix_many(leaves, mix)
    expect = jax_mix.neighbor_mix(
        _flat_jax(jleaves, K), jnp.asarray(idx, jnp.int32),
        jnp.asarray(w, jnp.float32), jnp.asarray(sw, jnp.float32),
        interpret=True)
    for out, x, e in zip(outs, leaves, _split_np(expect, leaves)):
        assert out.dtype == x.dtype and out.shape == x.shape
        assert out.is_contiguous()
        np.testing.assert_allclose(_np32(out), e, atol=tol, rtol=tol)


@pytest.mark.parametrize("staleness", [0, 2])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("topology", ["ring", "torus", "random"])
def test_neighbor_mix_push_many_ref_matches_jax(topology, dtype, staleness):
    """The push and the stale gather against the reference's step: the
    leaves concatenated, pushed by ``concatenate([flat[None],
    snaps[:-1]])`` and mixed by the reference's kernel with ``src=``;
    the pushed buffer is exact (a copy)."""
    K, S = 16, 2
    tol = DTYPES[dtype][2]
    idx, w, sw = build_schedule(topology, K, seed=3).neighbor_arrays(0)
    gidx = (np.where(w > 0, staleness, 0) * K + idx).astype(np.int32)
    mix = ops.mix_operands(gidx, w, sw, (S + 1) * K, "cpu")
    jleaves, leaves = _leaf_pair(K, dtype, 12)
    N = sum(t[0].numel() for t in leaves)
    jsnaps, snaps = _pair(np.random.default_rng(13).standard_normal(
        (S + 1, K, N)).astype(np.float32), dtype)
    outs, new_snaps = ops.neighbor_mix_push_many(leaves, snaps, mix)
    jflat = _flat_jax(jleaves, K)
    jnew = jnp.concatenate([jflat[None], jsnaps[:-1]])
    expect = jax_ops.neighbor_mix(
        jflat, jnp.asarray(gidx), jnp.asarray(w, jnp.float32),
        jnp.asarray(sw, jnp.float32), src=jnew.reshape(-1, N),
        interpret=True)
    assert new_snaps.dtype == snaps.dtype
    np.testing.assert_array_equal(_np32(new_snaps), _np32(jnew))
    for out, x, e in zip(outs, leaves, _split_np(expect, leaves)):
        assert out.dtype == x.dtype and out.shape == x.shape
        np.testing.assert_allclose(_np32(out), e, atol=tol, rtol=tol)


@pytest.mark.parametrize("push", [False, True], ids=["dpsgd", "adpsgd"])
@pytest.mark.parametrize("cfg_name", ["gn-lenet", "resnet-s", "alexnet-s"])
def test_neighbor_mix_many_matches_the_raw_op_on_the_flat_matrix(
        cfg_name, push, no_kernel_build):
    """A zoo model's leaves at K = 5 on a ring through the leaf-table op
    against the raw op on the flattened (K, N) matrix (and, for the push,
    the buffer pushed by ``torch.cat``), within 2e-5."""
    K, S = 5, 2
    params, _ = init_cnn(torch.Generator().manual_seed(0), CNN_ZOO[cfg_name])
    g = torch.Generator().manual_seed(1)
    leaves = [torch.randn((K,) + tuple(t.shape), generator=g)
              for t in params.values()]
    flat = torch.cat([x.reshape(K, -1) for x in leaves], dim=1)
    idx, w, sw = build_schedule("ring", K).neighbor_arrays(0)
    stale = S if push else 0
    gidx = (np.where(w > 0, stale, 0) * K + idx).astype(np.int32)
    raw = (torch.from_numpy(gidx), torch.from_numpy(w), torch.from_numpy(sw))
    launches = dict(ops.launches)
    if push:
        snaps = torch.randn((S + 1,) + tuple(flat.shape), generator=g)
        outs, new_snaps = ops.neighbor_mix_push_many(
            leaves, snaps, ops.mix_operands(gidx, w, sw, (S + 1) * K, "cpu"))
        pushed = torch.cat([flat[None], snaps[:-1]])
        assert torch.equal(new_snaps, pushed)
        expect = ops.neighbor_mix(flat, *raw, src=pushed.reshape(-1,
                                                                 flat.shape[1]))
    else:
        outs = ops.neighbor_mix_many(leaves,
                                     ops.mix_operands(gidx, w, sw, K, "cpu"))
        expect = ops.neighbor_mix(flat, *raw)
    assert ops.launches == launches              # the CPU launches nothing
    got = torch.cat([o.reshape(K, -1) for o in outs], dim=1)
    torch.testing.assert_close(got, expect, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bad", [-1, "n_src"])
def test_mix_operands_refuse_index_outside_range(bad, no_kernel_build):
    """The range check runs on the host arrays, before any upload: the
    operands are asked for on a CUDA device, and the refusal comes first
    (here, where there is no card, as on one)."""
    idx, w, sw = build_schedule("ring", 5).neighbor_arrays(0)
    n_src = 15
    idx = idx.copy()
    idx[3, 1] = n_src if bad == "n_src" else bad
    launches = dict(ops.launches)
    with pytest.raises(ValueError, match="outside"):
        ops.mix_operands(idx, w, sw, n_src, "cuda")
    assert ops.launches == launches
    idx[3, 1] = n_src - 1                        # in range: built
    mix = ops.mix_operands(idx, w, sw, n_src, "cpu")
    assert (mix.idx.dtype, mix.w.dtype, mix.self_w.dtype) == (
        torch.int32, torch.float32, torch.float32)
    assert mix.n_src == n_src and mix.idx.shape == (5, 2)


def test_gossip_many_ops_refuse_bad_operands(no_kernel_build):
    idx, w, sw = build_schedule("ring", 5).neighbor_arrays(0)
    mix = ops.mix_operands(idx, w, sw, 5, "cpu")
    stale = ops.mix_operands(idx, w, sw, 15, "cpu")
    x = torch.zeros(5, 4, 3)
    snaps = torch.zeros(3, 5, 12)
    bad = [(lambda: ops.neighbor_mix_many([], mix), "leaves"),
           (lambda: ops.neighbor_mix_many([x, x[:4]], mix), "leaves"),
           (lambda: ops.neighbor_mix_many([x], stale), "source rows"),
           (lambda: ops.neighbor_mix_push_many([x], snaps, mix),
            "source rows"),
           (lambda: ops.neighbor_mix_push_many([x], snaps[:, :, :8], stale),
            "snaps"),
           (lambda: ops.mix_operands(idx[:, :1], w, sw, 5, "cpu"), "shapes"),
           (lambda: mix.with_weights(torch.zeros(5, 3), mix.self_w),
            "shapes")]
    launches = dict(ops.launches)
    for call, match in bad:
        with pytest.raises(ValueError, match=match):
            call()
    with pytest.raises(TypeError, match="dtype"):
        ops.neighbor_mix_push_many([x], snaps.double(), stale)
    assert ops.launches == launches
