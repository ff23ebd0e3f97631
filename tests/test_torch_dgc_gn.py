"""The port's DGC histogram route and GroupNorm against the JAX reference,
on the CPU.

The same NumPy inputs, made from a seed, go through ``repro``'s Pallas
kernels (always with an explicit ``interpret=True``: without it the
reference's dispatcher times candidates and writes its cache), its jnp
oracles, and ``repro_torch``'s plain PyTorch versions, which are what
``repro_torch.kernels.ops`` runs for a CPU tensor.  Histograms, max|v|,
counts and DGC thresholds must be bit-exact and selected values equal as
numbers; GroupNorm agrees to 1e-5 in float32 (the reference test's
tolerance) and 2e-2 in bfloat16 (one bf16 rounding of the output, after
float32 statistics summed in another order).  The CUDA kernels are held
against these plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro.kernels import dgc_topk as jax_dgc
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.benchmarks import kernels_bench
from repro_torch.kernels import dgc_topk, ops, ref
from repro_torch.models.attention import chunked_attention

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
#: tests/test_kernels.py's DGC shapes and a ragged size
SHAPES = [(5000,), (100, 77), (17, 33, 9), (12345,)]
SPARSITIES = [0.0, 0.5, 0.75, 0.9, 0.99, 0.999, 1.0]
#: the sizes and sparsities chip_smoke.py checks the DGC kernel at on the
#: card: ragged sizes, GN-LeNet's K=5 stack (483,410), the bench's 2**20
CARD_SIZES = [1, 37, 4096, 483_410, 1_000_003, 1 << 20]
CARD_SPARSITIES = [0.5, 0.9, 0.99, 0.999]


def _pair(a: np.ndarray, dtype: str):
    """One float32 NumPy array as a JAX and a torch array of ``dtype``
    (both round float32 -> bfloat16 to nearest even: the same bits)."""
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _normal(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# histogram, threshold, select
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_abs_histogram_ref_matches_jax(shape, dtype):
    """Bins of |v| against an external v_max: max|v| (ties land in the
    last bin), half of it (everything above clamps to the last bin), a
    v_max so small that the quotient saturates the int32 conversion, and
    an all-zero v (its v_max floored at 1e-30)."""
    v_np = _normal(shape, sum(shape))
    jv, tv = _pair(v_np, dtype)
    top = float(tv.float().abs().max())
    cases = [(jv, tv, top), (jv, tv, 0.5 * top), (jv, tv, 1e-35)]
    cases.append(_pair(np.zeros(shape, np.float32), dtype) + (0.0,))
    for jx, tx, vmax in cases:
        vm32 = np.float32(vmax)
        hist = ref.abs_histogram_ref(tx, 256, vm32)
        assert hist.dtype == torch.int32 and hist.shape == (256,)
        assert int(hist.sum()) == tx.numel()
        assert torch.equal(hist, ops.abs_histogram(tx, vm32))
        for other in (jax_dgc.abs_histogram(jx, jnp.float32(vm32),
                                            interpret=True),
                      jax_ref.abs_histogram_ref(jx, 256, jnp.float32(vm32))):
            np.testing.assert_array_equal(hist.numpy(), np.asarray(other))
    assert int(ref.abs_histogram_ref(tv, 256, top)[255]) >= 1


@pytest.mark.parametrize("n_bins", [256, 100])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_abs_histogram_fused_matches_jax(shape, dtype, n_bins):
    v_np = _normal(shape, 1 + sum(shape))
    jv, tv = _pair(v_np, dtype)
    hist, v_max = ops.abs_histogram_fused(tv, n_bins=n_bins)
    assert hist.dtype == torch.int32 and v_max.dtype == torch.float32
    j_hist, j_max = jax_dgc.abs_histogram_fused(jv, n_bins=n_bins,
                                                interpret=True)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(j_hist))
    assert float(v_max) == float(j_max)


@pytest.mark.parametrize("n_bins", [256, 100])
def test_threshold_from_histogram_matches_jax(n_bins):
    """Bit-equal to the reference's glue as the reference runs it, under
    ``jit``: XLA turns its ``/ n_bins`` into a multiply by the float32
    reciprocal, which the port computes.  At 256 bins (a power of two)
    JAX's eager division gives the same bits too."""
    jit_threshold = jax.jit(jax_dgc.threshold_from_histogram)
    for seed in range(3):
        v_np = _normal(5000, seed)
        j_hist, j_max = jax_dgc.abs_histogram_fused(
            jnp.asarray(v_np), n_bins=n_bins, interpret=True)
        hist = torch.from_numpy(np.array(j_hist))
        v_max = torch.tensor(float(j_max))
        for s in SPARSITIES:
            t = dgc_topk.threshold_from_histogram(hist, v_max, s)
            assert t.dtype == torch.float32 and t.shape == ()
            expect = [jit_threshold(j_hist, j_max, jnp.float32(s))]
            if n_bins == 256:
                expect.append(jax_dgc.threshold_from_histogram(
                    j_hist, j_max, jnp.float32(s)))
            for e in expect:
                assert float(t) == float(e), (seed, s, float(t), float(e))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_dgc_select_ref_matches_jax(shape, dtype):
    """Values equal as numbers: the reference's oracle multiplies by the
    mask and gives -0.0 for a negative entry it drops, where the port and
    the Pallas kernel give +0.0."""
    v_np = _normal(shape, 2 + sum(shape))
    jv, tv = _pair(v_np, dtype)
    for t in (0.0, 0.5, 1.5, 10.0):
        t32 = np.float32(t)
        sel, cnt = ref.dgc_select_ref(tv, t32)
        assert sel.dtype == tv.dtype and cnt.dtype == torch.int32
        op_sel, op_cnt = ops.dgc_select(tv, t32)
        assert torch.equal(op_sel, sel) and int(op_cnt) == int(cnt)
        assert not torch.signbit(sel[sel == 0]).any()
        for o_sel, o_cnt in (jax_dgc.dgc_select(jv, t32, interpret=True),
                             jax_ref.dgc_select_ref(jv, jnp.float32(t))):
            np.testing.assert_array_equal(_np32(sel), _np32(o_sel))
            assert int(cnt) == int(o_cnt)


def _card_route(v: torch.Tensor, sparsity, n_bins: int):
    """The op's card route, composed from the plain versions on the CPU:
    histogram at max|v|, the threshold glue, the select."""
    v_max = v.float().abs().max()
    hist = ref.abs_histogram_ref(v, n_bins, v_max)
    t = dgc_topk.threshold_from_histogram(hist, v_max, sparsity)
    sel, cnt = ref.dgc_select_ref(v, t)
    return sel, cnt, t


@pytest.mark.parametrize("n_bins", [256, 100])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_dgc_sparsify_routes_agree(shape, dtype, n_bins):
    """The port's CPU op (the bisection ``ref.dgc_sparsify_ref``) and its
    card route (histogram, threshold, select) give one threshold, count
    and selection bit for bit, and so does the reference's kernel route
    (``ops.dgc_sparsify(..., interpret=True)``) at every bin count.  The
    reference's own oracle (``repro/kernels/ref.py`` ``dgc_sparsify_ref``)
    bisects for ``n_bins.bit_length() - 1`` steps, one short of
    ceil(log2(n_bins)) when ``n_bins`` is not a power of two, so it is
    held to the port only at 256 bins."""
    v_np = _normal(shape, 3 + sum(shape))
    jv, tv = _pair(v_np, dtype)
    for s in SPARSITIES:
        sel, cnt, t = ops.dgc_sparsify(tv, s, n_bins=n_bins)
        assert t.dtype == torch.float32 and cnt.dtype == torch.int32
        c_sel, c_cnt, c_t = _card_route(tv, s, n_bins)
        assert float(t) == float(c_t), (s, float(t), float(c_t))
        assert int(cnt) == int(c_cnt) and torch.equal(sel, c_sel)
        expects = [jax_ops.dgc_sparsify(jv, jnp.float32(s), n_bins=n_bins,
                                        interpret=True)]
        if n_bins == 256:
            expects.append(jax.jit(
                jax_ref.dgc_sparsify_ref, static_argnames="n_bins")(
                    jv, jnp.float32(s), n_bins=n_bins))
        for o_sel, o_cnt, o_t in expects:
            assert float(t) == float(o_t), (s, float(t), float(o_t))
            assert int(cnt) == int(o_cnt)
            np.testing.assert_array_equal(_np32(sel), _np32(o_sel))
        assert bool((sel.float().abs() > float(t)).eq(sel != 0).all())


@pytest.mark.parametrize("n_bins", [256, 100])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", CARD_SIZES)
def test_abs_histogram_fused_matches_jax_at_card_sizes(n, dtype, n_bins):
    """The histogram and max|v| of the sizes the card checks, and the
    threshold picked from it (the reference's search and the kernel's),
    against the reference's Pallas kernel (interpret mode) and its jitted
    glue."""
    v_np = _normal(n, 11 + n)
    jv, tv = _pair(v_np, dtype)
    hist, v_max = ops.abs_histogram_fused(tv, n_bins=n_bins)
    j_hist, j_max = jax_dgc.abs_histogram_fused(jv, n_bins=n_bins,
                                                interpret=True)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(j_hist))
    assert float(v_max) == float(j_max) and int(hist.sum()) == n
    jit_threshold = jax.jit(jax_dgc.threshold_from_histogram)
    for s in CARD_SPARSITIES:
        expect = float(jit_threshold(j_hist, j_max, jnp.float32(s)))
        for pick in (dgc_topk.threshold_from_histogram,
                     dgc_topk.threshold_by_count):
            assert float(pick(hist, v_max, s)) == expect, (pick, s)


@pytest.mark.parametrize("n_bins", [256, 100])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", CARD_SIZES)
def test_dgc_sparsify_matches_jax_at_card_sizes(n, dtype, n_bins):
    """The port's CPU op (the bisection) at the sizes and sparsities the
    card checks its one-launch kernel at, against the reference's kernel
    route (Pallas, interpret mode): threshold and count bit for bit,
    values equal."""
    v_np = _normal(n, 12 + n)
    jv, tv = _pair(v_np, dtype)
    for s in CARD_SPARSITIES:
        sel, cnt, t = ops.dgc_sparsify(tv, s, n_bins=n_bins)
        o_sel, o_cnt, o_t = jax_ops.dgc_sparsify(
            jv, jnp.float32(s), n_bins=n_bins, interpret=True)
        assert float(t) == float(o_t), (s, float(t), float(o_t))
        assert int(cnt) == int(o_cnt), s
        np.testing.assert_array_equal(_np32(sel), _np32(o_sel))


def _histogram(kind: str, n_bins: int, seed: int) -> np.ndarray:
    """An int32 (n_bins,) histogram: random counts, everything in bin 0,
    all zeros, everything in the last bin, or a few non-zero bins."""
    rng = np.random.default_rng(seed)
    h = np.zeros(n_bins, np.int32)
    if kind == "random":
        h[:] = rng.integers(0, 5000, n_bins)
    elif kind == "bin0":
        h[0] = 1 << 20
    elif kind == "last":
        h[-1] = 4097
    elif kind == "sparse":
        h[rng.integers(0, n_bins, 3)] = rng.integers(1, 1 << 24, 3)
    return h


@pytest.mark.parametrize("kind", ["random", "bin0", "zeros", "last",
                                  "sparse"])
@pytest.mark.parametrize("n_bins", [1, 7, 100, 255, 256, 1000, 1024])
def test_threshold_by_count_matches_jax(n_bins, kind):
    """The kernel's search (the number of bins whose float32 cumulative
    count lies below the target) against the reference's
    ``threshold_from_histogram`` under ``jit``, bit for bit, on
    histograms of every kind, at bin counts on and off a power of two,
    and against the port's searchsorted form."""
    jit_threshold = jax.jit(jax_dgc.threshold_from_histogram)
    for seed in range(2):
        h = _histogram(kind, n_bins, seed)
        v_max = np.float32(np.random.default_rng(seed).uniform(0.1, 10.0))
        for s in SPARSITIES:
            t = dgc_topk.threshold_by_count(torch.from_numpy(h),
                                            torch.tensor(v_max), s)
            assert t.dtype == torch.float32 and t.shape == ()
            expect = jit_threshold(jnp.asarray(h), jnp.float32(v_max),
                                   jnp.float32(s))
            assert float(t) == float(expect), (seed, s, float(t),
                                               float(expect))
            assert float(t) == float(dgc_topk.threshold_from_histogram(
                torch.from_numpy(h), torch.tensor(v_max), s))


# ---------------------------------------------------------------------------
# GroupNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("group_size", [2, 4])
@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (4, 4, 4, 32)])
def test_group_norm_ref_matches_jax(shape, group_size, dtype):
    x_np = _normal(shape, 4 + group_size)
    c = shape[-1]
    scale = _normal(c, 5) * 0.1 + 1.0
    bias = _normal(c, 6) * 0.1
    jx, tx = _pair(x_np, dtype)
    tol = DTYPES[dtype][2]
    out = ref.group_norm_ref(tx, torch.from_numpy(scale),
                             torch.from_numpy(bias), group_size=group_size)
    assert out.dtype == tx.dtype and out.shape == shape
    assert torch.equal(out, ops.group_norm(
        tx, torch.from_numpy(scale), torch.from_numpy(bias),
        group_size=group_size))
    js, jb = jnp.asarray(scale), jnp.asarray(bias)
    for e in (jax_ops.group_norm(jx, js, jb, group_size=group_size,
                                 interpret=True),
              jax_ref.group_norm_ref(jx, js, jb, group_size=group_size)):
        np.testing.assert_allclose(_np32(out), _np32(e), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(100, 16, 16, 32), (100, 16, 16, 16),
                                   (2, 128, 128, 16)])
def test_group_norm_ref_matches_jax_at_card_shapes(shape, dtype):
    """The shapes the card checks GroupNorm's two routes at: GN-LeNet's
    and resnet-s-gn's first activations at K=5 x batch 20 (group_size 2,
    the zoo's) and a 1 MB sample, against the reference's Pallas kernel
    (interpret mode) and its oracle."""
    x_np = _normal(shape, 13)
    c = shape[-1]
    scale = _normal(c, 14) * 0.1 + 1.0
    bias = _normal(c, 15) * 0.1
    jx, tx = _pair(x_np, dtype)
    tol = DTYPES[dtype][2]
    out = ops.group_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias),
                         group_size=2)
    assert out.dtype == tx.dtype and out.shape == shape
    js, jb = jnp.asarray(scale), jnp.asarray(bias)
    for e in (jax_ops.group_norm(jx, js, jb, group_size=2, interpret=True),
              jax_ref.group_norm_ref(jx, js, jb, group_size=2)):
        np.testing.assert_allclose(_np32(out), _np32(e), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape,dtype,group_size,route", [
    ((128, 8, 8, 64), torch.float32, 2, "sample"),      # the bench's
    ((100, 16, 16, 32), torch.float32, 2, "sample"),    # GN-LeNet's
    ((100, 16, 16, 16), torch.bfloat16, 2, "sample"),   # resnet-s-gn's
    ((1, 3, 5, 6), torch.float32, 3, "sample"),
    ((2, 128, 128, 16), torch.float32, 2, "group"),     # 1 MB a sample
    ((2, 128, 128, 16), torch.bfloat16, 2, "group"),
    ((1, 64, 64, 16), torch.float32, 2, "group"),       # 256 KB
    ((1, 64, 64, 16), torch.bfloat16, 2, "sample"),     # 128 KB
    ((1, 56, 56, 16), torch.float32, 2, "sample"),      # 201,792 bytes
    ((1, 57, 57, 16), torch.float32, 2, "group"),       # 209,024 bytes
    ((1, 79, 79, 16), torch.bfloat16, 2, "sample"),
    ((1, 80, 80, 16), torch.bfloat16, 2, "group")])
def test_group_norm_route(shape, dtype, group_size, route):
    """The one-block-a-sample route where the block's shared memory (the
    sample's tile in x's dtype, per-channel partial sums, each group's
    mean and scale) fits ``GN_SAMPLE_SMEM``, the (sample, group) route
    above it; a pure function of shape and dtype."""
    B, H, W, C = shape
    smem = ops.group_norm_sample_smem(shape, dtype, group_size)
    item = 4 if dtype == torch.float32 else 2
    assert smem == -(-H * W * C * item // 16) * 16 + 4 * (
        max(256, C) + 2 * (C // group_size))
    assert ops.group_norm_route(shape, dtype, group_size) == route
    assert (route == "sample") == (smem <= ops.GN_SAMPLE_SMEM)


# ---------------------------------------------------------------------------
# the kernel bench twin
# ---------------------------------------------------------------------------

#: the reference bench's rows (benchmarks/kernels_bench.py) without the
#: interpret-mode rows
REFERENCE_ROWS = [
    "kernel/flash_attention", "oracle/flash_attention",
    "prod/chunked_attention",
    "kernel/gaia_select_1M", "oracle/gaia_select_1M",
    "kernel/dgc_sparsify_1M", "oracle/dgc_sparsify_1M",
    "oracle/dgc_quantile_1M",
    "kernel/rand_k_1M", "oracle/rand_k_1M",
    "kernel/neighbor_mix_ring8_128k", "oracle/neighbor_mix_ring8_128k",
    "oracle/neighbor_mix_dense",
    "kernel/group_norm", "oracle/group_norm"]
LIBRARY_ROWS = ["library/flash_attention", "library/dgc_quantile_1M",
                "library/neighbor_mix_dense", "library/group_norm"]


def test_kernels_bench_rows_on_cpu():
    launches = dict(ops.launches)
    rows = kernels_bench.run("cpu", n=4096, mix_cols=256,
                             gn_shape=(4, 4, 4, 8), attn_shape=(1, 2, 32, 64),
                             reps=2)
    names = [name for name, _ in rows]
    assert [n for n in names if not n.startswith("library/")] == \
        REFERENCE_ROWS
    assert sorted(n for n in names if n.startswith("library/")) == \
        sorted(LIBRARY_ROWS)
    assert all(np.isfinite(us) and us > 0 for _, us in rows)
    assert ops.launches == launches            # the CPU launches nothing


def test_kernels_bench_entry_point_prints_rows(monkeypatch, capsys,
                                               tmp_path):
    small = kernels_bench.run

    def run_small(device):
        return small(device, n=2048, mix_cols=128, gn_shape=(2, 4, 4, 8),
                     attn_shape=(1, 2, 16, 64), reps=1)
    monkeypatch.setattr(kernels_bench, "run", run_small)
    out_json = tmp_path / "rows.json"
    assert kernels_bench.main(["--device", "cpu", "--json",
                               str(out_json)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "# device: cpu"
    rows = [line.split(",") for line in lines[1:]]
    assert [r[0] for r in rows] == [n for n, _ in run_small("cpu")]
    assert all(len(r) == 3 and r[2] == "" and float(r[1]) > 0 for r in rows)
    assert out_json.read_text().count("us_per_call") == len(rows)


def test_kernels_bench_attention_rows_compute_one_function():
    """The four attention rows compute the reference's causal attention:
    the op, its plain version, SDPA and the model path's
    ``chunked_attention`` on the (B, T, H, D) layout, within 2e-5 of
    ``repro``'s oracle (float32)."""
    a = kernels_bench.inputs("cpu", n=64, mix_cols=8, gn_shape=(1, 2, 2, 4),
                             attn_shape=(1, 2, 48, 64))
    q, k, v = a["q"], a["k"], a["v_attn"]
    expect = np.asarray(jax_ref.flash_attention_ref(
        *(jnp.asarray(t.numpy()) for t in (q, k, v))))
    got = [ops.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v),
           torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                            is_causal=True),
           chunked_attention(*(t.transpose(1, 2) for t in (q, k, v)),
                             chunk=64).transpose(1, 2)]
    for out in got:
        np.testing.assert_allclose(out.numpy(), expect, atol=2e-5, rtol=2e-5)


def test_kernels_bench_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernels_bench.run()


def _quantile_np(a: np.ndarray, q: float) -> np.float32:
    """``jnp.quantile``'s linear interpolation as its source writes it,
    each float32 operation rounded on its own."""
    s = np.sort(a.reshape(-1))
    rank = np.float32(q) * (np.float32(s.size) - np.float32(1))
    w_hi = np.float32(rank - np.floor(rank))
    w_lo = np.float32(1) - w_hi
    return (s[int(np.floor(rank))] * w_lo) + (s[int(np.ceil(rank))] * w_hi)


def test_dgc_threshold_ref_is_the_exact_quantile():
    """The exact threshold (the bench's ``oracle/dgc_quantile_1M``) is
    ``jnp.quantile``'s function of |v| bit for bit, and within one ulp of
    what XLA's CPU backend computes for it: that backend may fuse the
    interpolation's multiply and add into one fused multiply-add, which
    rounds once where the source rounds twice."""
    for shape in SHAPES:
        v_np = _normal(shape, 7)
        for s in (0.5, 0.9, 0.99, 0.999):
            t = ref.dgc_threshold_ref(torch.from_numpy(v_np), s)
            assert t.dtype == torch.float32 and t.shape == ()
            assert float(t) == float(_quantile_np(np.abs(v_np), s)), \
                (shape, s)
            np.testing.assert_array_max_ulp(
                t.numpy(), np.asarray(jax_ref.dgc_threshold_ref(
                    jnp.asarray(v_np), s)), maxulp=1)
