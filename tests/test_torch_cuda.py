"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips itself where there is no CUDA device
(this file imports neither JAX nor ``repro``, so it also runs on a
machine that has only PyTorch):

    python -m pytest -q tests/test_torch_cuda.py

``chip_smoke.py`` runs the same checks at the training path's shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import CommConfig, FabricConfig
from repro_torch.configs.cnn_zoo import CNN_ZOO
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core import trainer
from repro_torch.kernels import ops, ref
from repro_torch.models import attention, model
from repro_torch.models.cnn import init_cnn
from repro_torch.topology import build_schedule

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g) * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1,), (37,), (5, 32, 3, 5, 5),
                                   (1_000_003,)])
def test_gaia_select_kernel_bit_exact(dev, shape, dtype):
    v = _randn(shape, 0, 0.01).to(dev, dtype)
    w = _randn(shape, 1, 0.3).to(dev, dtype)
    launches = ops.launches["gaia_select"]
    for t in (0.0, 0.05, torch.tensor(0.1, device=dev)):
        sel, cnt = ops.gaia_select(v, w, t)
        rsel, rcnt = ref.gaia_select_ref(v, w, t)
        assert torch.equal(sel, rsel)
        assert cnt.dtype == torch.int32 and int(cnt) == int(rcnt)
    assert ops.launches["gaia_select"] == launches + 3


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("topology,K", [("ring", 5), ("random", 16),
                                        ("full", 8)])
def test_neighbor_mix_kernel_matches_ref(dev, topology, K, dtype, tol):
    idx, w, sw = build_schedule(topology, K, seed=0).neighbor_arrays(0)
    operands = (torch.from_numpy(idx.astype(np.int32)).to(dev),
                torch.from_numpy(w.astype(np.float32)).to(dev),
                torch.from_numpy(sw.astype(np.float32)).to(dev))
    for N in (1, 129, 96_682):
        x = _randn((K, N), N).to(dev, dtype)
        out = ops.neighbor_mix(x, *operands)
        assert out.dtype == dtype and out.shape == (K, N)
        torch.testing.assert_close(
            out.float(), ref.neighbor_mix_padded_ref(x, *operands).float(),
            atol=tol, rtol=tol)


def test_kernels_refuse_what_they_cannot_take(dev):
    x = torch.zeros(4, 10, device=dev)
    with pytest.raises(TypeError):
        ops.gaia_select(x.double(), x.double(), 0.1)
    with pytest.raises(ValueError):
        ops.gaia_select(x.t(), x.t(), 0.1)           # not contiguous
    i = torch.zeros(4, 2, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        ops.neighbor_mix(x, i, torch.zeros(4, 2, device=dev),
                         torch.ones(4, device=dev))


@pytest.mark.parametrize("bad", [-1, 4])
def test_neighbor_mix_kernel_refuses_index_outside_range(dev, bad):
    idx = torch.tensor([[1, 3]] * 4, dtype=torch.int32, device=dev)
    idx[2, 1] = bad
    launches = dict(ops.launches)
    with pytest.raises(ValueError, match="outside"):
        ops.neighbor_mix(torch.zeros(4, 10, device=dev), idx,
                         torch.full((4, 2), 0.25, device=dev),
                         torch.full((4,), 0.5, device=dev))
    with pytest.raises(ValueError, match="outside"):
        ops.neighbor_mix(torch.zeros(4, 10, device=dev), idx + 8 * (bad > 0),
                         torch.full((4, 2), 0.25, device=dev),
                         torch.full((4,), 0.5, device=dev),
                         src=torch.zeros(12, 10, device=dev))
    assert ops.launches == launches


def test_launch_alone_matches_the_op(dev):
    """The bare launches that chip_smoke.py times compute what the ops
    return."""
    v = _randn((5, 1000), 0, 0.01).to(dev)
    w = _randn((5, 1000), 1, 0.3).to(dev)
    t = torch.full((1,), 0.1, device=dev)
    out = torch.empty_like(v)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    ops.launch_gaia_select([v], [w], t, [out], count)
    sel, cnt = ops.gaia_select(v, w, 0.1)
    assert torch.equal(out, sel) and int(count) == int(cnt)
    idx, nw, sw = build_schedule("ring", 5).neighbor_arrays(0)
    operands = (torch.from_numpy(idx.astype(np.int32)).to(dev),
                torch.from_numpy(nw.astype(np.float32)).to(dev),
                torch.from_numpy(sw.astype(np.float32)).to(dev))
    mixed = torch.empty_like(v)
    ops.launch_neighbor_mix(v, *operands, mixed)
    assert torch.equal(mixed, ops.neighbor_mix(v, *operands))
    src = torch.cat([w, v, w])
    ops.launch_neighbor_mix_src(v, src, operands[0] + 5, *operands[1:],
                                mixed)
    assert torch.equal(mixed, ops.neighbor_mix(v, operands[0] + 5,
                                               *operands[1:], src=src))
    count.zero_()
    ops.launch_rand_k_select([v], None, [out], None, count, [2**31 + 7], 0.25,
                             [None])
    sel, cnt = ops.rand_k_sparsify(v, 0.25, 2**31 + 7)
    assert torch.equal(out, sel) and int(count) == int(cnt)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("topology,K", [("ring", 5), ("random", 16)])
def test_neighbor_mix_src_kernel_matches_ref(dev, topology, K, dtype, tol):
    """AD-PSGD's stale mixing at staleness 2: neighbour rows from a
    (3K, N) buffer through ``2 * K + nbr``, the self term on x."""
    idx, w, sw = build_schedule(topology, K, seed=0).neighbor_arrays(0)
    gidx = (np.where(w > 0, 2, 0) * K + idx).astype(np.int32)
    operands = (torch.from_numpy(gidx).to(dev),
                torch.from_numpy(w.astype(np.float32)).to(dev),
                torch.from_numpy(sw.astype(np.float32)).to(dev))
    for N in (1, 129, 96_682):
        x = _randn((K, N), N).to(dev, dtype)
        src = _randn((3 * K, N), N + 1).to(dev, dtype)
        launches = ops.launches["neighbor_mix_src"]
        out = ops.neighbor_mix(x, *operands, src=src)
        assert ops.launches["neighbor_mix_src"] == launches + 1
        assert out.dtype == dtype and out.shape == (K, N)
        torch.testing.assert_close(
            out.float(),
            ref.neighbor_mix_padded_ref(x, *operands, src).float(),
            atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1,), (37,), (5, 32, 3, 5, 5),
                                   (1_000_003,)])
def test_rand_k_select_kernel_bit_exact(dev, shape, dtype):
    v = _randn(shape, 0).to(dev, dtype)
    keep_999 = float(np.float32(1) - np.float32(0.999))
    launches = ops.launches["rand_k_select"]
    for keep, seed in ((0.25, 3), (keep_999, 3594), (0.5, 2**31 + 7)):
        sel, cnt = ops.rand_k_sparsify(v, keep, seed)
        rsel, rcnt = ref.rand_k_select_ref(v, keep, seed)
        assert torch.equal(sel != 0, rsel != 0) and torch.equal(sel, rsel)
        assert cnt.dtype == torch.int32 and int(cnt) == int(rcnt)
    assert ops.launches["rand_k_select"] == launches + 3


def test_adpsgd_staleness0_on_card_is_dpsgd(dev):
    """On the card too, AD-PSGD at staleness 0 (buffer depth 3) is D-PSGD
    bit for bit: the src-gather entry reads slot 0, which is D-PSGD's x,
    in the same kernel body.  cuDNN runs deterministically, so the two
    runs differ only in the mixing."""
    cfg = CNN_ZOO["gn-lenet"]
    fns, _ = trainer.make_cnn_fns(cfg)
    comm = CommConfig(fabric=FabricConfig(topology="ring"), max_staleness=2)
    params, mstate = init_cnn(torch.Generator().manual_seed(0), cfg)
    rs = np.random.default_rng(1)
    batches = [{"x": torch.from_numpy(rs.standard_normal(
                    (5, 20, 16, 16, 3)).astype(np.float32)).to(dev),
                "y": torch.from_numpy(rs.integers(0, 10, (5, 20))).to(dev)}
               for _ in range(3)]
    runs = []
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name in ("dpsgd", "adpsgd"):
            algo = trainer.make_algorithm(name, fns, 5, comm, staleness=0)
            state = algo.init({n: t.to(dev) for n, t in params.items()},
                              {n: t.to(dev) for n, t in mstate.items()})
            for t, batch in enumerate(batches):
                state, met = algo.step(state, batch,
                                       torch.tensor(0.05, device=dev), t)
            runs.append((state, met))
    finally:
        torch.backends.cudnn.deterministic = flag
    (d_state, d_met), (a_state, a_met) = runs
    for n, t in d_state["params"].items():
        assert torch.equal(a_state["params"][n], t), n
    assert torch.equal(a_met["loss"], d_met["loss"])


def _parts():
    """Five label-skewed partitions of noise images, two labels each (one
    label a node drives FedAvg's local loss to ~1e-7 within a few steps,
    below what float32 resolves to rtol 1e-3)."""
    rs = np.random.default_rng(0)
    parts = [(rs.standard_normal((40, 16, 16, 3)).astype(np.float32),
              (k + np.arange(40) % 2).astype(np.int32)) for k in range(5)]
    return parts, parts[0]


@pytest.mark.parametrize("algo,comm_kw", [
    ("dpsgd", {}), ("gaia", {}), ("adpsgd", {}), ("dgc", {}),
    ("dgc", {"dgc_compressor": "randk"}), ("fedavg", {"iter_local": 2})],
    ids=["dpsgd", "gaia", "adpsgd", "dgc", "dgc-randk", "fedavg"])
def test_dpsgd_step_on_card_matches_cpu(dev, algo, comm_kw):
    """Five steps on the card (kernels) and on the CPU (plain versions)
    give the same losses; TF32 off on both."""
    parts, val = _parts()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        curves = [[loss for _, loss in trainer.train_decentralized(
            CNN_ZOO["gn-lenet"], algo, parts, val,
            comm=CommConfig(fabric=FabricConfig(topology="ring"), **comm_kw),
            steps=5, eval_every=5, device=d).loss_curve]
            for d in ("cuda", "cpu")]
        np.testing.assert_allclose(curves[0], curves[1], rtol=1e-3)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


@pytest.mark.parametrize("algo,comm_kw,kw", [
    ("bsp", {}, {}), ("gaia", {}, {"t0": 0.1}), ("dpsgd", {}, {}),
    ("adpsgd", {"max_staleness": 2}, {}), ("dgc", {}, {"sparsity": 0.99}),
    ("dgc", {"dgc_compressor": "randk"}, {"sparsity": 0.99}),
    ("fedavg", {"iter_local": 2}, {"iter_local": 2})],
    ids=["bsp", "gaia", "dpsgd", "adpsgd", "dgc", "dgc-randk", "fedavg"])
def test_cnn_step_on_card_has_no_audit_finding(dev, algo, comm_kw, kw):
    """One GN-LeNet step of each algorithm on the card under the step
    audit: no host sync (PyTorch's sync debug mode), no large closed-over
    tensor, no draw from a generator the step did not receive."""
    from repro_torch.analysis import step_audit
    cfg = CNN_ZOO["gn-lenet"]
    fns, _ = trainer.make_cnn_fns(cfg)
    comm = CommConfig(fabric=FabricConfig(topology="ring"), **comm_kw)
    step_algo = trainer.make_algorithm(algo, fns, 5, comm)
    params, mstate = init_cnn(torch.Generator().manual_seed(0), cfg)
    state = step_algo.init({n: t.to(dev) for n, t in params.items()},
                           {n: t.to(dev) for n, t in mstate.items()})
    rs = np.random.default_rng(1)
    batch = {"x": torch.from_numpy(rs.standard_normal(
                 (5, 20, 16, 16, 3)).astype(np.float32)).to(dev),
             "y": torch.from_numpy(rs.integers(0, 10, (5, 20))).to(dev)}
    lr = torch.tensor(0.05, device=dev)
    kw = {k: (torch.tensor(v, device=dev) if k == "t0" else v)
          for k, v in kw.items()}
    for t in range(2):                  # the first call warms cuDNN up
        rep = step_audit.audit_step(step_algo.step, (state, batch, lr, t),
                                    kw)
        state = rep.output[0]
    assert rep.ok, [f.format() for f in rep.findings]


def test_planted_host_read_on_card_is_one_JA401(dev):
    """The step audit's capture of PyTorch's sync debug mode fires: one
    ``.item()`` of a card tensor in a step is exactly one JA401, and the
    caller's debug mode is restored after the call."""
    from repro_torch.analysis import step_audit
    torch.cuda.set_sync_debug_mode("warn")
    try:
        rep = step_audit.audit_step(lambda x: (x * 2).sum().item(),
                                    (torch.ones(4, device=dev),))
        assert torch.cuda.get_sync_debug_mode() == 1
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [f.rule for f in rep.findings] == ["JA401"], rep.findings
    assert rep.output == 8.0


DGC_SHAPES = [(1,), (37,), (5, 32, 3, 5, 5), (1_000_003,)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DGC_SHAPES)
def test_dgc_histogram_kernels_bit_exact(dev, shape, dtype):
    """abs_histogram_fused, abs_histogram and dgc_select against their
    plain versions, and dgc_sparsify's one launch against the bisection:
    histograms, max|v|, thresholds and counts bit for bit, values equal;
    one launch of the kernel an op call."""
    v = _randn(shape, 2).to(dev, dtype)
    before = dict(ops.launches)
    hist, v_max = ops.abs_histogram_fused(v)
    r_max = v.float().abs().max()
    assert float(v_max) == float(r_max)
    assert torch.equal(hist, ref.abs_histogram_ref(v, 256, r_max))
    for vm in (0.5 * float(r_max), 1e-35):
        assert torch.equal(ops.abs_histogram(v, vm),
                           ref.abs_histogram_ref(v, 256, vm))
    for s in (0.5, 0.9, 0.99, 0.999):
        for n_bins in (256, 100):
            sel, cnt, t = ops.dgc_sparsify(v, s, n_bins=n_bins)
            rsel, rcnt, rt = ref.dgc_sparsify_ref(v, s, n_bins=n_bins)
            assert float(t) == float(rt), (s, n_bins)
            assert int(cnt) == int(rcnt) and torch.equal(sel, rsel)
    sel, cnt = ops.dgc_select(v, 0.5)
    rsel, rcnt = ref.dgc_select_ref(v, 0.5)
    assert torch.equal(sel, rsel) and int(cnt) == int(rcnt)
    after = ops.launches
    assert after["dgc_sparsify"] == before["dgc_sparsify"] + 8
    assert after["abs_histogram_fused"] == before["abs_histogram_fused"] + 1
    assert after["abs_histogram"] == before["abs_histogram"] + 2
    assert after["dgc_select"] == before["dgc_select"] + 1


def test_dgc_histogram_kernels_at_ties_and_zeros(dev):
    v = _randn((4096,), 3).to(dev)
    top = float(v.abs().max())
    v[[5, 99, 4000]] = torch.tensor([top, -top, top], device=dev)
    hist, v_max = ops.abs_histogram_fused(v)
    assert float(v_max) == top and int(hist[255]) >= 3
    assert torch.equal(hist, ref.abs_histogram_ref(v, 256, top))
    zeros = torch.zeros(1000, device=dev)
    sel, cnt, t = ops.dgc_sparsify(zeros, 0.999)
    assert float(t) == 0.0 and int(cnt) == 0 and not sel.any()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,group_size", [
    ((2, 8, 8, 16), 2), ((2, 8, 8, 16), 4), ((4, 4, 4, 32), 2),
    ((4, 4, 4, 32), 4), ((128, 8, 8, 64), 2), ((1, 3, 5, 6), 3),
    ((100, 16, 16, 32), 2), ((100, 16, 16, 16), 2), ((2, 128, 128, 16), 2)])
def test_group_norm_kernel_matches_ref(dev, shape, group_size, dtype, tol):
    """Today's shapes, GN-LeNet's and resnet-s-gn's first activations at
    K=5 x batch 20, and a 1 MB sample on the (sample, group) route; the
    other shapes take the one-block-a-sample route.  Both routes forced
    on a shape that fits either."""
    x = _randn(shape, 4).to(dev, dtype)
    sc = (_randn(shape[-1:], 5, 0.1) + 1.0).to(dev)
    bi = _randn(shape[-1:], 6, 0.1).to(dev)
    expect = ref.group_norm_ref(x, sc, bi, group_size=group_size).float()
    route = ops.group_norm_route(shape, dtype, group_size)
    assert route == ("group" if shape == (2, 128, 128, 16) else "sample")
    launches = ops.launches["group_norm"]
    out = ops.group_norm(x, sc, bi, group_size=group_size)
    assert ops.launches["group_norm"] == launches + 1
    assert out.dtype == dtype and out.shape == shape
    torch.testing.assert_close(out.float(), expect, atol=tol, rtol=tol)
    if route == "sample":
        y = torch.empty_like(x)
        ops.launch_group_norm(x, sc, bi, y, group_size, 1e-5, route="group")
        torch.testing.assert_close(y.float(), expect, atol=tol, rtol=tol)


def test_new_kernels_refuse_what_they_cannot_take(dev):
    v = torch.zeros(4, 10, device=dev)
    before = dict(ops.launches)
    with pytest.raises(TypeError):
        ops.dgc_sparsify(v.double(), 0.9)
    with pytest.raises(ValueError):
        ops.dgc_select(v.t(), 0.1)                  # not contiguous
    with pytest.raises(ValueError, match="n_bins"):
        ops.abs_histogram(v, 1.0, n_bins=2048)
    x = torch.zeros(2, 4, 4, 6, device=dev)
    with pytest.raises(ValueError, match="multiple"):
        ops.group_norm(x, torch.ones(6, device=dev),
                       torch.zeros(6, device=dev), group_size=4)
    with pytest.raises(TypeError):
        ops.group_norm(x, torch.ones(6, device=dev).double(),
                       torch.zeros(6, device=dev), group_size=2)
    assert ops.launches == before


@pytest.mark.parametrize("bad,error,match", [
    (lambda dev: (torch.zeros(64, device=dev).double(), {}), TypeError,
     "dtype"),
    (lambda dev: (torch.zeros(64, device=dev).half(), {}), TypeError,
     "dtype"),
    (lambda dev: (torch.zeros(8, 8, device=dev).t(), {}), ValueError,
     "contiguous"),
    (lambda dev: (torch.zeros(64, device=dev), {"n_bins": 2048}),
     ValueError, "n_bins"),
    (lambda dev: (torch.zeros(64, device=dev), {"n_bins": 0}), ValueError,
     "n_bins"),
    (lambda dev: (torch.zeros(0, device=dev), {}), ValueError, "empty")],
    ids=["float64", "float16", "strided", "bins2048", "bins0", "empty"])
def test_dgc_sparsify_refuses_without_launch(dev, bad, error, match):
    v, kw = bad(dev)
    before = dict(ops.launches)
    with pytest.raises(error, match=match):
        ops.dgc_sparsify(v, 0.9, **kw)
    assert ops.launches == before


def test_new_launches_alone_match_the_ops(dev):
    v = _randn((5, 1000), 7).to(dev)
    work = ops.dgc_work(256, dev)
    ops.launch_dgc_topk("abs_histogram_fused", v, work, 256)
    hist, _, _, v_max = ops.dgc_outputs(work, 256)
    r_hist, r_max = ops.abs_histogram_fused(v)
    assert torch.equal(hist, r_hist) and float(v_max) == float(r_max)
    sel, cnt, t = ops.dgc_sparsify(v, 0.9)
    out = torch.empty_like(v)
    ops.launch_dgc_topk("dgc_sparsify", v, work, 256, out=out, sparsity=0.9)
    _, count, t_, _ = ops.dgc_outputs(work, 256)
    assert torch.equal(out, sel) and int(count) == int(cnt)
    assert float(t_) == float(t)
    out = torch.empty_like(v)
    ops.launch_dgc_topk("dgc_select", v, work, 256, out=out,
                        threshold=t.reshape(1))
    assert torch.equal(out, sel) and int(work[256]) == int(cnt)
    x = _randn((2, 4, 4, 8), 8).to(dev)
    sc, bi = torch.ones(8, device=dev), torch.zeros(8, device=dev)
    y = torch.empty_like(x)
    ops.launch_group_norm(x, sc, bi, y, 2, 1e-5)
    assert torch.equal(y, ops.group_norm(x, sc, bi, group_size=2))


# ---------------------------------------------------------------------------
# flash_attention and the LM on the card
# ---------------------------------------------------------------------------

#: tests/test_kernels.py's grid (B, H, Tq, Tk, D), D = 256 (gemma2's head
#: dim) and the LM prefill's shape
FA_SHAPES = [(1, 2, 128, 128, 64), (2, 1, 64, 192, 64), (1, 1, 200, 200, 128),
             (1, 2, 160, 160, 256), (1, 1, 64, 300, 256)]
FA_KWS = [dict(causal=True), dict(causal=False), dict(causal=True, window=64),
          dict(causal=True, logit_softcap=30.0)]


def _qkv(shape, dtype, dev):
    B, H, Tq, Tk, D = shape
    return [_randn((B, H, t, D), s).to(dev, dtype)
            for s, t in ((0, Tq), (1, Tk), (2, Tk))]


@pytest.mark.parametrize("kw", FA_KWS, ids=["causal", "full", "window64",
                                            "softcap30"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", FA_SHAPES)
def test_flash_attention_kernel_matches_ref(dev, shape, dtype, tol, kw):
    q, k, v = _qkv(shape, dtype, dev)
    launches = ops.launches["flash_attention"]
    out = ops.flash_attention(q, k, v, **kw)
    assert ops.launches["flash_attention"] == launches + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(
        out.float(), ref.flash_attention_ref(q, k, v, **kw).float(),
        atol=tol, rtol=tol)


def test_flash_attention_kernel_at_the_prefill_shape(dev):
    q, k, v = _qkv((4, 16, 2048, 2048, 128), torch.bfloat16, dev)
    out = ops.flash_attention(q, k, v)
    torch.testing.assert_close(out.float(),
                               ref.flash_attention_ref(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)
    o2 = torch.empty_like(q)
    ops.launch_flash_attention(q, k, v, o2, causal=True, window=None,
                               logit_softcap=None, scale=128 ** -0.5)
    assert torch.equal(o2, out)


def test_flash_attention_refuses_what_it_cannot_take(dev):
    q = torch.zeros(1, 2, 16, 64, device=dev)
    before = dict(ops.launches)
    with pytest.raises(TypeError):
        ops.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(TypeError, match="differs"):
        ops.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(2, 3), q.transpose(2, 3),
                            q.transpose(2, 3))
    q80 = torch.zeros(1, 2, 16, 80, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q80, q80, q80)
    with pytest.raises(ValueError, match="head dim"):      # a pair not built
        ops.flash_attention(q, q, q[..., :32])
    # the raw launch refuses an input that requires grad: the kernel has
    # no backward (the ops route such inputs through ops.FlashAttention
    # in grad mode, and detach them outside it)
    g = torch.zeros(1, 2, 16, 64, device=dev, requires_grad=True)
    with pytest.raises(ValueError, match="requires grad"):
        ops.launch_flash_attention(g, g, g, torch.empty_like(q),
                                   causal=True, window=None,
                                   logit_softcap=None, scale=0.125)
    assert ops.launches == before
    with torch.no_grad():
        out = attention.chunked_attention(*(g.transpose(1, 2),) * 3)
    assert ops.launches["flash_attention"] == \
        before["flash_attention"] + 1
    assert not out.requires_grad
    torch.testing.assert_close(out, torch.zeros_like(out))


def _fused_qkv(shape, group, dtype, dev):
    """q (B, Tq, H * group, D) and k, v (B, Tk, H, D) as views of one fused
    projection-shaped tensor (none contiguous), for (B, H, Tq, Tk, D)."""
    B, H, Tq, Tk, D = shape
    Hq = H * group
    fused = _randn((B, max(Tq, Tk), (Hq + 2 * H) * D), 3).to(dev, dtype)
    return (fused[:, :Tq, :Hq * D].unflatten(2, (Hq, D)),
            fused[:, :Tk, Hq * D:(Hq + H) * D].unflatten(2, (H, D)),
            fused[:, :Tk, (Hq + H) * D:].unflatten(2, (H, D)))


@pytest.mark.parametrize("group", [2, 4])
@pytest.mark.parametrize("kw", FA_KWS, ids=["causal", "full", "window64",
                                            "softcap30"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", FA_SHAPES)
def test_flash_attention_bthd_kernel_matches_ref(dev, shape, dtype, tol, kw,
                                                 group):
    """The kernel on GQA heads, reading strided (B, T, H, D) views."""
    q, k, v = _fused_qkv(shape, group, dtype, dev)
    launches = ops.launches["flash_attention"]
    out = ops.flash_attention_bthd(q, k, v, **kw)
    assert ops.launches["flash_attention"] == launches + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert out.is_contiguous()
    torch.testing.assert_close(
        out.float(), ref.flash_attention_bthd_ref(q, k, v, **kw).float(),
        atol=tol, rtol=tol)


def test_flash_attention_bthd_kernel_at_the_prefill_shape(dev):
    """qwen3-0.6b's prefill: 4 x 2048 tokens, 16 query heads over 8 KV
    heads of 128, bfloat16, held to chip_smoke.py's bounds: max |err|
    8e-3 and mean |err| 1e-6 (the reference multiplies the float32
    probabilities by v; the kernel's bf16 hi/lo pair keeps to that)."""
    q, k, v = _fused_qkv((4, 8, 2048, 2048, 128), 2, torch.bfloat16, dev)
    for kw in FA_KWS:
        diff = (ops.flash_attention_bthd(q, k, v, **kw).float()
                - ref.flash_attention_bthd_ref(q, k, v, **kw).float()).abs()
        assert float(diff.max()) <= 8e-3, kw
        assert float(diff.mean()) <= 1e-6, kw


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True,
                                                      window=64),
                                dict(causal=False)],
                         ids=["causal", "window64", "full"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T", [200, 300])
def test_flash_attention_bthd_kernel_at_group_10_d256(dev, T, dtype, tol,
                                                      kw):
    """recurrentgemma's heads: 10 query heads over one KV head of 256."""
    q, k, v = _fused_qkv((2, 1, T, T, 256), 10, dtype, dev)
    launches = ops.launches["flash_attention"]
    out = ops.flash_attention_bthd(q, k, v, **kw)
    assert ops.launches["flash_attention"] == launches + 1
    assert out.shape == (2, T, 10, 256)
    torch.testing.assert_close(
        out.float(), ref.flash_attention_bthd_ref(q, k, v, **kw).float(),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("tq", [1, 200, 1500])
def test_flash_attention_non_causal_over_a_ragged_tk_of_1500(dev, tq, dtype,
                                                             tol):
    """seamless' encoder (Tq = Tk = 1500, off the kernel's 64-row tiles)
    and its cross-attention (Tq 1 at decode, Tq != Tk at prefill): no
    mask, 16 heads of 64, through ``chunked_attention`` at offset 0."""
    q = _randn((2, tq, 16, 64), 4).to(dev, dtype)
    k, v = (_randn((2, 1500, 16, 64), s).to(dev, dtype) for s in (5, 6))
    launches = ops.launches["flash_attention"]
    out = attention.chunked_attention(q, k, v, causal=False)
    assert ops.launches["flash_attention"] == launches + 1
    torch.testing.assert_close(
        out.float(),
        ref.flash_attention_bthd_ref(q, k, v, causal=False).float(),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_layouts_give_the_same_bits(dev, dtype):
    """The (B, H, T, D) op and the (B, T, H, D) op on the same data give
    the same bits: one kernel reads both layouts by their strides, and a
    GQA head reads what the expanded MHA head holds."""
    B, H, T, D = 2, 4, 200, 128
    q, k, v = (_randn((B, H, T, D), s).to(dev, dtype) for s in (0, 1, 2))
    for kw in FA_KWS:
        mha = ops.flash_attention(q, k, v, **kw)
        bthd = ops.flash_attention_bthd(
            *(t.transpose(1, 2) for t in (q, k, v)), **kw)
        assert torch.equal(bthd.transpose(1, 2), mha), kw
        kg, vg = k[:, ::2], v[:, ::2]                    # 4 over 2 KV heads
        mha = ops.flash_attention(q, kg.repeat_interleave(2, dim=1),
                                  vg.repeat_interleave(2, dim=1), **kw)
        gqa = ops.flash_attention_bthd(
            *(t.transpose(1, 2) for t in (q, kg, vg)), **kw)
        assert torch.equal(gqa.transpose(1, 2), mha), kw


def test_flash_attention_bthd_refuses_what_it_cannot_take(dev):
    q = torch.zeros(1, 16, 4, 64, device=dev, dtype=torch.bfloat16)
    kv = q[:, :, :2]
    before = dict(ops.launches)
    with pytest.raises(TypeError, match="differs"):
        ops.flash_attention_bthd(q, kv.float(), kv.float())
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention_bthd(q, kv.transpose(2, 3).contiguous()
                                 .transpose(2, 3), kv)
    with pytest.raises(ValueError, match="do not group"):
        ops.flash_attention_bthd(q, q[:, :, :3], q[:, :, :3])
    q80 = torch.zeros(1, 16, 2, 80, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention_bthd(q80, q80, q80)
    odd = torch.zeros(1, 16, 4 * 64 + 4, device=dev,
                      dtype=torch.bfloat16)[..., 4:].unflatten(2, (4, 64))
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.flash_attention_bthd(odd, odd, odd)
    g = torch.zeros(1, 16, 2, 64, device=dev, requires_grad=True)
    with pytest.raises(ValueError, match="requires grad"):
        ops.launch_flash_attention(g, g, g, torch.empty_like(g),
                                   causal=True, window=None,
                                   logit_softcap=None, scale=0.125,
                                   layout="bthd")
    assert ops.launches == before
    with torch.no_grad():                 # detached, then the kernel
        out = ops.flash_attention_bthd(g, g, g)
    assert ops.launches["flash_attention"] == \
        before["flash_attention"] + 1
    assert not out.requires_grad
    torch.testing.assert_close(out, torch.zeros_like(out))


def _attention_calls(cfg) -> int:
    """``flash_attention`` launches of one forward: one an attention
    layer; for the enc-dec, one an encoder layer and a cross-attention a
    decoder layer besides."""
    n = sum(cfg.block_kind(i) == "attn" for i in range(cfg.n_layers))
    if cfg.encoder is not None:
        n += cfg.encoder.n_layers + cfg.n_layers
    return n


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_lm_forward_on_card_matches_cpu(dev, arch):
    cfg = get_config(arch).reduced()
    p = model.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    rs = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rs.integers(0, cfg.vocab, (2, 96)))}
    if cfg.modality.kind in ("vision", "audio"):
        key = "patches" if cfg.modality.kind == "vision" else "frames"
        n = (cfg.modality.n_tokens if key == "patches"
             else cfg.encoder.n_frames)
        batch[key] = torch.from_numpy(rs.standard_normal(
            (2, n, cfg.modality.feat_dim)).astype(np.float32))
    cpu, cpu_aux = model.forward(p, cfg, batch)
    p_dev = _to(p, dev)                         # the same values, on the card
    launches = ops.launches["flash_attention"]
    flags = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card, card_aux = model.forward(
            p_dev, cfg, {k: v.to(dev) for k, v in batch.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags
    assert ops.launches["flash_attention"] == launches + _attention_calls(cfg)
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(float(card_aux), float(cpu_aux), rtol=1e-3,
                               atol=1e-3)


def _devices(tree):
    if isinstance(tree, dict):
        return set().union(*(_devices(v) for v in tree.values()))
    if isinstance(tree, list):
        return set().union(*(_devices(v) for v in tree))
    return set() if tree is None else {tree.device.type}


@pytest.mark.parametrize("gen_device", ["cpu", "cuda"])
def test_lm_defaults_place_every_leaf_on_the_card(dev, gen_device):
    """``init_model``/``init_cache`` with no device: every parameter and
    cache leaf on the card, whichever device the generator draws on, and a
    decode step runs there."""
    cfg = get_config("qwen3-0.6b").reduced()
    p = model.init_model(torch.Generator(device=gen_device).manual_seed(0),
                         cfg)
    cache = model.init_cache(cfg, 2, 8)
    assert _devices(p) == {"cuda"} and _devices(cache) == {"cuda"}
    tok = torch.zeros(2, dtype=torch.long, device=dev)
    logits, _ = model.decode_step(
        p, cfg, {"token": tok, "t": torch.zeros(2, dtype=torch.int32,
                                                 device=dev)}, cache)
    assert logits.device.type == "cuda" and logits.shape == (2, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return None if tree is None else tree.to(dev)


# ---------------------------------------------------------------------------
# k and v of their own head dims (MLA), offset-free cross-attention
# ---------------------------------------------------------------------------

#: the (Dk, Dv) pairs besides the dense LMs' equal ones
FA_PAIRS = [(96, 96), (192, 128), (96, 64), (48, 32)]
#: (B, H, Tq, Tk): tests/test_kernels.py's grid, and a ragged Tq over Tk
FA_PAIR_SHAPES = [(1, 2, 128, 128), (2, 1, 64, 192), (1, 1, 200, 200),
                  (1, 2, 100, 37)]


@pytest.mark.parametrize("kw", FA_KWS, ids=["causal", "full", "window64",
                                            "softcap30"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", FA_PAIR_SHAPES)
@pytest.mark.parametrize("pair", FA_PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_flash_attention_head_dim_pairs_match_ref(dev, pair, shape, dtype,
                                                  tol, kw):
    B, H, Tq, Tk = shape
    Dk, Dv = pair
    q, k = (_randn((B, H, t, Dk), s).to(dev, dtype)
            for s, t in ((0, Tq), (1, Tk)))
    v = _randn((B, H, Tk, Dv), 2).to(dev, dtype)
    launches = ops.launches["flash_attention"]
    out = ops.flash_attention(q, k, v, **kw)
    assert ops.launches["flash_attention"] == launches + 1
    assert out.dtype == dtype and out.shape == (B, H, Tq, Dv)
    torch.testing.assert_close(
        out.float(), ref.flash_attention_ref(q, k, v, **kw).float(),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("pair", [(192, 128), (96, 64), (48, 32)],
                         ids=lambda p: f"{p[0]}-{p[1]}")
def test_flash_attention_bthd_reads_v_sliced_from_a_fused_kv(dev, pair, dtype,
                                                            tol):
    """MLA's v is a slice of the fused kv projection (its nope half, then
    v): head stride nope + Dv, at an offset of nope elements.  The kernel
    reads it where it lies, 4 query heads over 2 KV heads."""
    Dk, Dv = pair
    B, T = 2, 96
    q = _randn((B, T, 4, Dk), 0).to(dev, dtype)
    k = _randn((B, T, 2, Dk), 1).to(dev, dtype)
    kv = _randn((B, T, 2, 2 * Dv), 2).to(dev, dtype)
    v = kv[..., Dv:]
    assert not v.is_contiguous() and v.stride(2) == 2 * Dv
    for kw in FA_KWS:
        out = ops.flash_attention_bthd(q, k, v, **kw)
        assert out.shape == (B, T, 4, Dv) and out.is_contiguous()
        torch.testing.assert_close(
            out.float(),
            ref.flash_attention_bthd_ref(q, k, v, **kw).float(),
            atol=tol, rtol=tol)
        assert torch.equal(out, ops.flash_attention_bthd(q, k, v.contiguous(),
                                                         **kw))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("tq,tk", [(192, 64), (3, 5), (64, 192)])
def test_cross_attention_at_offset_0_runs_the_kernel(dev, tq, tk, dtype,
                                                     tol):
    """Non-causal, window-free attention with Tq != Tk at q_offset 0 (the
    reference's cross-attention): one kernel launch, the plain version's
    result; Tq > Tk visits every k-block."""
    q = _randn((2, tq, 4, 64), 0).to(dev, dtype)
    k, v = (_randn((2, tk, 2, 64), s).to(dev, dtype) for s in (1, 2))
    launches = ops.launches["flash_attention"]
    out = attention.chunked_attention(q, k, v, causal=False, q_offset=0)
    assert ops.launches["flash_attention"] == launches + 1
    torch.testing.assert_close(
        out.float(),
        ref.flash_attention_bthd_ref(q, k, v, causal=False).float(),
        atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# gaia_select_many and rand_k_sparsify_many: one launch for a list
# ---------------------------------------------------------------------------

#: a ragged list: one element, a ragged 37, a conv weight stacked at K=5
#: (permuted into the reference's layout for rand-k) and 1,000,003
MANY_SHAPES = [(1,), (37,), (5, 32, 3, 5, 5), (1_000_003,), (5, 64)]
MANY_PERMS = [None, None, (2, 3, 1, 0), None, None]


def _off16(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` one element past a 16-byte boundary, so
    the kernels take their scalar path on it."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    out = buf[1:].view(t.shape)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gaia_select_many_kernel_bit_exact(dev, dtype):
    vs = [_randn(s, i, 0.01).to(dev, dtype) for i, s in enumerate(MANY_SHAPES)]
    ws = [_randn(s, 10 + i, 0.3).to(dev, dtype)
          for i, s in enumerate(MANY_SHAPES)]
    vs[4], ws[4] = _off16(vs[4]), _off16(ws[4])
    launches = ops.launches["gaia_select"]
    for t in (0.0, 0.05, torch.tensor(0.1, device=dev)):
        outs, counts = ops.gaia_select_many(vs, ws, t)
        routs, rcounts = ref.gaia_select_many_ref(vs, ws, t)
        for o, r in zip(outs, routs):
            assert torch.equal(o, r)
        assert counts.dtype == torch.int32 and torch.equal(counts, rcounts)
    assert ops.launches["gaia_select"] == launches + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rand_k_sparsify_many_kernel_bit_exact(dev, dtype):
    accs = [_randn(s, i).to(dev, dtype) for i, s in enumerate(MANY_SHAPES)]
    vels = [_randn(s, 10 + i).to(dev, dtype)
            for i, s in enumerate(MANY_SHAPES)]
    vels[1][::3] = -0.0                  # signed zeros stay as they were
    accs[4], vels[4] = _off16(accs[4]), _off16(vels[4])
    keep_999 = float(np.float32(1) - np.float32(0.999))
    launches = ops.launches["rand_k_select"]
    for keep, base in ((0.25, 3), (keep_999, 3594), (0.5, 2**31 + 7)):
        seeds = [base + 131 * i for i in range(len(accs))]
        got = ops.rand_k_sparsify_many(accs, vels, keep, seeds, MANY_PERMS)
        expect = ref.rand_k_sparsify_many_ref(accs, vels, keep, seeds,
                                              MANY_PERMS)
        for g, e in zip(got[0] + got[1], expect[0] + expect[1]):
            assert torch.equal(g, e)
            assert torch.equal(torch.signbit(g), torch.signbit(e))
        assert got[2].dtype == torch.int32 and torch.equal(got[2], expect[2])
    assert ops.launches["rand_k_select"] == launches + 3


def test_many_kernels_take_more_tensors_than_a_launch(dev):
    """40 tensors: two launches of up to 32, each tensor's count in its
    place."""
    shapes = [(5, 3 + 97 * i) for i in range(40)]
    vs = [_randn(s, i, 0.01).to(dev) for i, s in enumerate(shapes)]
    ws = [_randn(s, 100 + i, 0.3).to(dev) for i, s in enumerate(shapes)]
    before = dict(ops.launches)
    outs, counts = ops.gaia_select_many(vs, ws, 0.05)
    routs, rcounts = ref.gaia_select_many_ref(vs, ws, 0.05)
    assert all(torch.equal(o, r) for o, r in zip(outs, routs))
    assert torch.equal(counts, rcounts)
    perms = [None] * 40
    seeds = list(range(2**31, 2**31 + 40))
    got = ops.rand_k_sparsify_many(vs, ws, 0.25, seeds, perms)
    expect = ref.rand_k_sparsify_many_ref(vs, ws, 0.25, seeds, perms)
    for g, e in zip(got[0] + got[1], expect[0] + expect[1]):
        assert torch.equal(g, e)
    assert torch.equal(got[2], expect[2])
    assert ops.launches["gaia_select"] == before["gaia_select"] + 2
    assert ops.launches["rand_k_select"] == before["rand_k_select"] + 2


# ---------------------------------------------------------------------------
# neighbor_mix_many and neighbor_mix_push_many: one gossip launch a step
# over a model's leaves
# ---------------------------------------------------------------------------

GOSSIP_CFGS = ["gn-lenet", "resnet-s", "alexnet-s"]


def _zoo_leaves(cfg_name, K, dev, dtype, seed):
    """Seeded normal leaves of a zoo model's shapes, stacked at K."""
    params, _ = init_cnn(torch.Generator().manual_seed(0), CNN_ZOO[cfg_name])
    return [_randn((K,) + tuple(t.shape), seed + i).to(dev, dtype)
            for i, t in enumerate(params.values())]


def _gossip_operands(topology, K, stale, n_src, dev):
    """The round-0 operands of ``topology``, real neighbours read at slot
    ``stale`` of a buffer of ``n_src`` rows."""
    idx, w, sw = build_schedule(topology, K, seed=0).neighbor_arrays(0)
    return ops.mix_operands(np.where(w > 0, stale, 0) * K + idx, w, sw,
                            n_src, dev)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("topology,K", [("ring", 5), ("random", 16)])
@pytest.mark.parametrize("cfg_name", GOSSIP_CFGS)
def test_neighbor_mix_many_kernel_matches_ref(dev, cfg_name, topology, K,
                                              dtype, tol):
    xs = _zoo_leaves(cfg_name, K, dev, dtype, 0)
    mix = _gossip_operands(topology, K, 0, K, dev)
    before = dict(ops.launches)
    outs = ops.neighbor_mix_many(xs, mix)
    assert ops.launches["neighbor_mix"] == before["neighbor_mix"] + 1
    expect = ref.neighbor_mix_many_ref(xs, mix.idx, mix.w, mix.self_w)
    for o, e, x in zip(outs, expect, xs):
        assert o.dtype == dtype and o.shape == x.shape and o.is_contiguous()
        torch.testing.assert_close(o.float(), e.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("staleness", [0, 2])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("topology,K", [("ring", 5), ("random", 16)])
@pytest.mark.parametrize("cfg_name", GOSSIP_CFGS)
def test_neighbor_mix_push_many_kernel_matches_ref(dev, cfg_name, topology, K,
                                                   dtype, tol, staleness):
    """The push is a copy (exact); the mix within the tolerance."""
    S = 2
    xs = _zoo_leaves(cfg_name, K, dev, dtype, 0)
    N = sum(x[0].numel() for x in xs)
    snaps = _randn((S + 1, K, N), 99).to(dev, dtype)
    mix = _gossip_operands(topology, K, staleness, (S + 1) * K, dev)
    before = ops.launches["neighbor_mix_src"]
    outs, new_snaps = ops.neighbor_mix_push_many(xs, snaps, mix)
    assert ops.launches["neighbor_mix_src"] == before + 1
    expect, expect_snaps = ref.neighbor_mix_push_many_ref(
        xs, snaps, mix.idx, mix.w, mix.self_w)
    assert torch.equal(new_snaps, expect_snaps)
    for o, e, x in zip(outs, expect, xs):
        assert o.dtype == dtype and o.shape == x.shape and o.is_contiguous()
        torch.testing.assert_close(o.float(), e.float(), atol=tol, rtol=tol)


def _flat_mix(xs, operands):
    """The earlier D-PSGD design: flatten, the raw op (its index check
    and sync included), split."""
    K = operands.idx.shape[0]
    flat = torch.cat([x.reshape(K, -1).float() for x in xs], dim=1)
    mixed = ops.neighbor_mix(flat, operands.idx, operands.w, operands.self_w)
    return [p.reshape(x.shape).to(x.dtype) for p, x in
            zip(mixed.split([x[0].numel() for x in xs], dim=1), xs)]


def _flat_push(xs, snaps, operands):
    """The earlier AD-PSGD design: flatten, push by ``torch.cat``, the raw
    op with ``src=``, split."""
    K = operands.idx.shape[0]
    flat = torch.cat([x.reshape(K, -1).float() for x in xs], dim=1)
    new_snaps = torch.cat([flat[None], snaps[:-1]], dim=0)
    mixed = ops.neighbor_mix(flat, operands.idx, operands.w,
                             operands.self_w,
                             src=new_snaps.reshape(-1, flat.shape[1]))
    return ([p.reshape(x.shape).to(x.dtype) for p, x in
             zip(mixed.split([x[0].numel() for x in xs], dim=1), xs)],
            new_snaps)


@pytest.mark.parametrize("algo_name,op,flat_route,kernel", [
    ("dpsgd", "neighbor_mix_many", _flat_mix, "neighbor_mix"),
    ("adpsgd", "neighbor_mix_push_many", _flat_push, "neighbor_mix_src")])
def test_gossip_step_on_card_matches_the_flat_route(dev, algo_name, op,
                                                    flat_route, kernel,
                                                    monkeypatch):
    """One D-PSGD or AD-PSGD step (staleness 2, its third round, so the
    deeper slots differ) through the leaf-table op makes one launch and
    gives the state of the earlier flatten-mix-split route bit for bit
    (cuDNN deterministic: the steps differ only in the mixing)."""
    cfg = CNN_ZOO["gn-lenet"]
    fns, _ = trainer.make_cnn_fns(cfg)
    comm = CommConfig(fabric=FabricConfig(topology="ring"), max_staleness=2)
    params, mstate = init_cnn(torch.Generator().manual_seed(0), cfg)
    rs = np.random.default_rng(3)
    batch = {"x": torch.from_numpy(rs.standard_normal(
                 (5, 20, 16, 16, 3)).astype(np.float32)).to(dev),
             "y": torch.from_numpy(rs.integers(0, 10, (5, 20))).to(dev)}
    lr = torch.tensor(0.05, device=dev)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    algo = trainer.make_algorithm(algo_name, fns, 5, comm)
    state = algo.init({n: t.to(dev) for n, t in params.items()},
                      {n: t.to(dev) for n, t in mstate.items()})
    for t in range(2):
        state, _ = algo.step(state, batch, lr, t)
    before = dict(ops.launches)
    new, _ = algo.step(state, batch, lr, 2)
    made = {k: c - before[k] for k, c in ops.launches.items()
            if c != before[k]}
    assert made == {kernel: 1}, made
    monkeypatch.setattr(ops, op, flat_route)
    old, _ = algo.step(state, batch, lr, 2)
    assert set(new) == set(old)
    for part, tree in new.items():
        if isinstance(tree, torch.Tensor):
            assert torch.equal(tree, old[part]), part
            continue
        for n, t in tree.items():
            assert torch.equal(t, old[part][n]), (part, n)


def test_gossip_many_kernels_take_more_leaves_than_a_launch(dev):
    """40 leaves, one of them off a 16-byte boundary and some of ragged
    sizes: two launches of up to 32 each, for both ops."""
    K, S = 5, 2
    xs = [_randn((K, 3 + 97 * i), i).to(dev) for i in range(40)]
    xs[7] = _off16(xs[7])
    mix = _gossip_operands("ring", K, 0, K, dev)
    stale = _gossip_operands("ring", K, 2, (S + 1) * K, dev)
    N = sum(x[0].numel() for x in xs)
    snaps = _randn((S + 1, K, N), 77).to(dev)
    before = dict(ops.launches)
    outs = ops.neighbor_mix_many(xs, mix)
    pushed, new_snaps = ops.neighbor_mix_push_many(xs, snaps, stale)
    assert ops.launches["neighbor_mix"] == before["neighbor_mix"] + 2
    assert ops.launches["neighbor_mix_src"] == before["neighbor_mix_src"] + 2
    expect = ref.neighbor_mix_many_ref(xs, mix.idx, mix.w, mix.self_w)
    expect_p, expect_snaps = ref.neighbor_mix_push_many_ref(
        xs, snaps, stale.idx, stale.w, stale.self_w)
    assert torch.equal(new_snaps, expect_snaps)
    for got, exp in ((outs, expect), (pushed, expect_p)):
        for o, e in zip(got, exp):
            torch.testing.assert_close(o, e, atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# LM training: the attention's autograd route, Gaia's mixed dtypes, a step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1,), (37,), (2, 1024, 3),
                                   (1_000_003,)])
def test_gaia_select_float32_v_over_bfloat16_w_bit_exact(dev, shape):
    """The float32-v, bfloat16-w instance against the plain version, one
    launch for the list; the reverse pair is refused."""
    vs = [_randn(shape, 0, 0.01).to(dev), _randn((5,), 2, 0.01).to(dev)]
    ws = [_randn(shape, 1, 0.3).to(dev, torch.bfloat16),
          _randn((5,), 3, 0.3).to(dev, torch.bfloat16)]
    launches = ops.launches["gaia_select"]
    outs, counts = ops.gaia_select_many(vs, ws, 0.05)
    assert ops.launches["gaia_select"] == launches + 1
    for v, w, o, c in zip(vs, ws, outs, counts):
        rsel, rcnt = ref.gaia_select_ref(v, w, 0.05)
        assert o.dtype == torch.float32 and torch.equal(o, rsel)
        assert int(c) == int(rcnt)
    with pytest.raises(TypeError, match="dtypes"):
        ops.gaia_select_many([w.bfloat16() for w in vs],
                             [v.float() for v in ws], 0.05)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=64,
                                     logit_softcap=30.0),
                                dict(causal=False)],
                         ids=["causal", "window_softcap", "full"])
def test_flash_attention_autograd_route_matches_plain(dev, kw, dtype, tol):
    """``ops.FlashAttention`` (the kernel forward, the plain chunked
    backward) against autograd through the plain version on views of one
    projection, 4 query heads over 2 KV heads of 128: dq, dk and dv
    within ``tol`` of the largest plain gradient (TF32 off), one kernel
    launch."""
    B, T, H, Hkv, D = 2, 200, 4, 2, 128
    g = torch.Generator().manual_seed(5)
    fused = torch.randn(B, T, (H + 2 * Hkv) * D, generator=g).to(dev, dtype)
    dout = torch.randn(B, T, H, D, generator=g).to(dev, dtype)

    def views(f):
        return (f[..., :H * D].unflatten(2, (H, D)),
                f[..., H * D:(H + Hkv) * D].unflatten(2, (Hkv, D)),
                f[..., (H + Hkv) * D:].unflatten(2, (Hkv, D)))
    grads = []
    flags = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for fn in (ops.flash_attention_bthd, ref.flash_attention_bthd_ref):
            f = fused.detach().requires_grad_()
            before = ops.launches["flash_attention"]
            fn(*views(f), **kw).backward(dout)
            assert ops.launches["flash_attention"] - before == \
                (fn is ops.flash_attention_bthd)
            grads.append(f.grad.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags
    for got, want in zip(views(grads[0]), views(grads[1])):
        assert float((got - want).abs().max()) <= \
            tol * float(want.abs().max())


@pytest.mark.parametrize("strategy", ["bsp", "gaia", "fedavg", "dgc",
                                      "dpsgd", "adpsgd"])
def test_lm_train_step_on_card_matches_cpu(dev, strategy):
    """One step of the reduced qwen3 (float32, 2 pods) on the card and on
    the CPU from the same state, TF32 off: params, vel and acc within
    1e-4; a Gaia or DGC entry within rounding of its threshold may flip
    (at most 1e-3 of them)."""
    from repro_torch import pytree
    from repro_torch.launch import steps
    cfg = get_config("qwen3-0.6b").reduced()
    comm = CommConfig(strategy=strategy, fabric=FabricConfig(topology="ring"),
                      gaia_t0=0.05, iter_local=1, dgc_sparsity=0.95)
    p = model.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    rs = np.random.default_rng(0)
    seqs = torch.from_numpy(rs.integers(0, cfg.vocab, (2, 2, 33)))
    batch = {"tokens": seqs[..., :-1], "labels": seqs[..., 1:]}
    sched = build_schedule("ring", 2)
    out = {}
    flags = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for d in ("cpu", dev):
            kw = {}
            if strategy in steps.GOSSIP_STRATEGIES:
                kw["mix"] = steps.gossip_operands(
                    sched, 0, device=d, **({"staleness": 1,
                                            "max_staleness": 2}
                                           if strategy == "adpsgd" else {}))
            state = steps.make_train_state(_to(p, d), comm, 2)
            step = steps.make_train_step(cfg, comm, lr=1e-2)
            out[str(d)], _ = step(state, {k: v.to(d) for k, v in
                                          batch.items()}, 0, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags
    cpu, card = out["cpu"], out[str(dev)]
    flip = None
    if "acc" in cpu:
        flip = [(a.cpu() == 0) != (b == 0) for a, b in
                zip(pytree.leaves(card["acc"]), pytree.leaves(cpu["acc"]))]
        assert sum(int(f.sum()) for f in flip) <= \
            1e-3 * sum(f.numel() for f in flip)
    for key in ("params", "vel", "acc"):
        if key not in cpu:
            continue
        for i, (a, b) in enumerate(zip(pytree.leaves(card[key]),
                                       pytree.leaves(cpu[key]))):
            ok = torch.ones(b.shape, dtype=torch.bool)
            if flip is not None:
                ok = ~flip[i] if key != "params" else \
                    (~flip[i].any(dim=0)).expand(b.shape)
            torch.testing.assert_close(a.cpu()[ok], b[ok], rtol=0,
                                       atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("topology,K", [("ring", 5), ("random", 16)])
@pytest.mark.parametrize("cfg_name", GOSSIP_CFGS)
def test_neighbor_mix_src_many_kernel_matches_ref(dev, cfg_name, topology, K,
                                                  dtype, tol):
    """The cross-process gossip's mix: every neighbour row from a (2K, N)
    source, one launch counted as ``neighbor_mix_src``."""
    xs = _zoo_leaves(cfg_name, K, dev, dtype, 0)
    N = sum(x[0].numel() for x in xs)
    src = _randn((2 * K, N), 98).to(dev, dtype)
    mix = _gossip_operands(topology, K, 1, 2 * K, dev)
    before = ops.launches["neighbor_mix_src"]
    outs = ops.neighbor_mix_src_many(xs, src, mix)
    assert ops.launches["neighbor_mix_src"] == before + 1
    expect = ref.neighbor_mix_src_many_ref(xs, src, mix.idx, mix.w,
                                           mix.self_w)
    for o, e, x in zip(outs, expect, xs):
        assert o.dtype == dtype and o.shape == x.shape
        torch.testing.assert_close(o.float(), e.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_neighbor_mix_src_many_kernel_with_no_source_row(dev, dtype):
    """Pods that read no neighbour (an empty (0, N) source, every weight
    0, as AD-PSGD's receiver whose pod a random matching left out): one
    launch, each leaf its self term, bit for bit with the plain version."""
    xs = _zoo_leaves("gn-lenet", 1, dev, dtype, 5)
    N = sum(x[0].numel() for x in xs)
    mix = ops.mix_operands(np.zeros((1, 1)), np.zeros((1, 1)), np.ones(1),
                           0, dev)
    src = torch.empty((0, N), device=dev, dtype=dtype)
    before = ops.launches["neighbor_mix_src"]
    outs = ops.neighbor_mix_src_many(xs, src, mix)
    assert ops.launches["neighbor_mix_src"] == before + 1
    expect = ref.neighbor_mix_src_many_ref(xs, src, mix.idx, mix.w,
                                           mix.self_w)
    for o, e, x in zip(outs, expect, xs):
        assert torch.equal(o, e) and torch.equal(o, x)


def _three_rank_matching(rank, dev, dtype):
    """One gloo rank of three on the card: AD-PSGD's and D-PSGD's exchange
    over every round of a random matching of the 3 pods (one pod left out
    a round: its rank receives no row) against the one-card exchange;
    True where every round's row is the same bit for bit."""
    import dataclasses
    from repro_torch import pytree
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((3, 1, 1), device=dev)
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                              dtype=dtype)
    like = pytree.leaves(model.init_model(torch.Generator().manual_seed(0),
                                          cfg, "cpu"))
    rs = np.random.default_rng(4)
    params = [torch.from_numpy(rs.standard_normal((3,) + tuple(t.shape))
                               .astype(np.float32) * 0.1).to(dev, t.dtype)
              for t in like]
    sched = build_schedule("random-matching", 3)
    same = True
    for strategy in steps.GOSSIP_STRATEGIES:
        comm = CommConfig(strategy=strategy,
                          fabric=FabricConfig(topology="random-matching"))
        S1 = comm.max_staleness + 1
        snaps = {pytree.dtype_name(dt): torch.from_numpy(rs.standard_normal(
                     (S1, 3, sum(like[i].numel() for i in idx))).astype(
                     np.float32)).to(dev, dt)
                 for dt, idx in steps.dtype_groups(like).items()}
        kw = ({"staleness": 1, "max_staleness": comm.max_staleness}
              if strategy == "adpsgd" else {})
        for t in range(sched.period):
            full = {"params": params}
            mine = {"params": [p[rank:rank + 1] for p in params]}
            if strategy == "adpsgd":
                full["snaps"] = snaps
                mine["snaps"] = {k: v[:, rank:rank + 1].contiguous()
                                 for k, v in snaps.items()}
            want = steps.make_exchange(comm)(full, mix=steps.gossip_operands(
                sched, t, device=dev, **kw))
            got = steps.make_exchange(comm, mesh=mesh)(
                mine, mix=steps.gossip_operands(sched, t, device=dev,
                                                mesh=mesh, **kw))
            same = same and all(
                torch.equal(g, w[rank:rank + 1]) for g, w in
                zip(got["params"], want["params"]))
            if strategy == "adpsgd":
                same = same and all(torch.equal(got["snaps"][k], v[:, rank:
                                                                  rank + 1])
                                    for k, v in want["snaps"].items())
    return same


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_gloo_ranks_on_the_card_gossip_with_a_pod_left_out(dev, dtype):
    """Three gloo ranks on the card over a random matching: every round one
    rank's pod reads no neighbour (AD-PSGD's all-to-all hands it no row,
    its mix launches over an empty source) and every rank's rows equal the
    one-card exchange's, bit for bit."""
    from repro_torch.launch import procs
    assert all(procs.spawn(_three_rank_matching, 3, backend="gloo",
                           device=dev, timeout=300, args=(dtype,)))


def _two_rank_checkpoint(rank, dev, path):
    """One gloo rank of two on the card: an AD-PSGD train state of seeded
    values on the card, this rank's rows saved through the mesh (each
    leaf gathered to rank 0 through the host) and restored; True where
    the restore is the rank's rows and rank 0's checkpoint equals the
    one-card checkpoint of the whole state, array for array."""
    import dataclasses
    import os
    from repro_torch import checkpointing as ckpt
    from repro_torch import pytree
    from repro_torch.launch import sharding, steps
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 1, 1), device=dev)
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                              dtype="bfloat16")
    comm = CommConfig(strategy="adpsgd")
    shape = steps.train_state_shape(cfg, comm, 2)
    specs = sharding.train_state_shardings(shape, mesh)
    g = torch.Generator().manual_seed(6)
    full = pytree.tree_map(lambda t: torch.randn(
        tuple(t.shape), generator=g).to(dev, t.dtype), shape)
    axes = [s.index("pod") for s in pytree.leaves_like(specs, full)]
    mine = pytree.unflatten(full, [
        t.narrow(ax, rank, 1).contiguous()
        for t, ax in zip(pytree.leaves(full), axes)])
    ckpt.save(os.path.join(path, "ranks"), mine, step=1, mesh=mesh,
              specs=specs)
    back = ckpt.restore(os.path.join(path, "ranks"),
                        pytree.tree_map(torch.empty_like, mine), step=1,
                        mesh=mesh, specs=specs)
    ok = all(x.device == y.device and torch.equal(x, y) for x, y in
             zip(pytree.leaves(back), pytree.leaves(mine)))
    if rank == 0:
        one = ckpt.restore(ckpt.save(os.path.join(path, "one_card"), full,
                                     step=1), pytree.tree_map(
            torch.empty_like, full))
        both = ckpt.restore(os.path.join(path, "ranks"), pytree.tree_map(
            torch.empty_like, full), step=1)
        ok = ok and all(torch.equal(x, y) for x, y in zip(
            pytree.leaves(one), pytree.leaves(both)))
    return ok


def test_two_gloo_ranks_on_the_card_checkpoint(dev, tmp_path):
    """A checkpoint of CUDA rows written by two gloo ranks on the card is
    the one-card checkpoint of the stacked state, and each rank restores
    its own rows."""
    from repro_torch.launch import procs
    assert all(procs.spawn(_two_rank_checkpoint, 2, backend="gloo",
                           device=dev, timeout=300, args=(str(tmp_path),)))


def _two_rank_exchange(rank, dev, strategy, dtype):
    """One gloo rank of two on the card: the exchange of ``strategy`` on
    its row of seeded stacked inputs (the reduced qwen3's leaves) against
    the one-card exchange of all the rows; True where its row is the same
    bit for bit."""
    import dataclasses
    from repro_torch import pytree
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 1, 1), device=dev)
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                              dtype=dtype)
    like = pytree.leaves(model.init_model(torch.Generator().manual_seed(0),
                                          cfg, "cpu"))
    rs = np.random.default_rng(3)
    full = [torch.from_numpy(rs.standard_normal((2,) + tuple(t.shape))
                             .astype(np.float32) * 0.1).to(dev, t.dtype)
            for t in like]
    key = "grads" if strategy == "bsp" else "params"
    comm = CommConfig(strategy=strategy, fabric=FabricConfig(topology="ring"))
    mix = {}
    if strategy == "dpsgd":
        sched = build_schedule("ring", 2)
        mix = {"mix": steps.gossip_operands(sched, 0, device=dev)}
        mine = {"mix": steps.gossip_operands(sched, 0, device=dev,
                                             mesh=mesh)}
    want = steps.make_exchange(comm)({key: full}, **mix)[key]
    launches = ops.launches["neighbor_mix_src"]
    got = steps.make_exchange(comm, mesh=mesh)(
        {key: [t[rank:rank + 1] for t in full]},
        **(mine if strategy == "dpsgd" else {}))[key]
    assert ops.launches["neighbor_mix_src"] == launches + (
        strategy == "dpsgd") * len(steps.dtype_groups(like))
    return all(torch.equal(g, w[rank:rank + 1]) for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strategy", ["bsp", "dpsgd"])
def test_two_gloo_ranks_on_the_card_exchange_bit_for_bit(dev, strategy,
                                                         dtype):
    """Two gloo ranks on the one card (``procs.spawn``): bsp's float32
    all-reduce and dpsgd's gather and ``neighbor_mix_src_many`` launch
    give each rank its rows of the one-card exchange (``neighbor_mix_many``
    for dpsgd), bit for bit."""
    from repro_torch.launch import procs
    assert all(procs.spawn(_two_rank_exchange, 2, backend="gloo",
                           device=dev, timeout=300, args=(strategy, dtype)))


def _four_rank_intrapod(rank, dev, shape, strategy, dtype):
    """One gloo rank of four on the card, mesh ``shape`` (a pod over data
    and model ranks): the exchange of ``strategy`` on its blocks of seeded
    stacked inputs (the reduced qwen3's leaves) against the one-card
    exchange (True where bit for bit), and one float32 train step (TF32
    off) against the one-card step: the relative L2 of its blocks of
    params and vel."""
    import dataclasses
    from repro_torch import pytree
    from repro_torch.launch import sharding, steps
    from repro_torch.launch.mesh import make_mesh
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                              dtype=dtype)
    mesh = make_mesh(shape, device=dev)
    p = model.init_model(torch.Generator().manual_seed(0), cfg, dev)
    like, specs = pytree.leaves(p), sharding.leaf_specs(p, mesh)
    rows = steps.local_pods(2, mesh)

    def blocks(ts):
        return [sharding.local_block(t[rows.start:rows.stop],
                                     (None,) + tuple(s), mesh).contiguous()
                for t, s in zip(ts, specs)]
    rs = np.random.default_rng(5)
    draw = lambda scale, dt=None: [torch.from_numpy(rs.standard_normal(
        (2,) + tuple(t.shape)).astype(np.float32) * scale).to(
        dev, dt or t.dtype) for t in like]
    comm = CommConfig(strategy=strategy, fabric=FabricConfig(topology="ring"),
                      dgc_sparsity=0.95)
    full = {"grads": draw(0.01)} if strategy == "bsp" else {
        "params": draw(0.1)}
    if strategy == "dgc":
        full.update(acc=draw(0.01, torch.float32),
                    vel=draw(0.01, torch.float32))
    sched = build_schedule("ring", 2)
    mix = ({"mix": steps.gossip_operands(sched, 0, device=dev)},
           {"mix": steps.gossip_operands(sched, 0, device=dev, mesh=mesh)}
           ) if strategy == "dpsgd" else ({}, {})
    want = steps.make_exchange(comm)(full, **mix[0])
    got = steps.make_exchange(comm, mesh=mesh, specs=specs)(
        {k: blocks(v) for k, v in full.items()}, **mix[1])
    same = all(torch.equal(g, w) for k in want
               for g, w in zip(got[k], blocks(want[k])))
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 2, 17))).to(dev)
    batch = {"tokens": tokens[..., :-1], "labels": tokens[..., 1:]}
    torch.backends.cuda.matmul.allow_tf32 = False
    one, _ = steps.make_train_step(cfg, comm, lr=1e-2)(
        steps.make_train_state(p, comm, 2), batch, 1, **mix[0])
    mine, _ = steps.make_train_step(cfg, comm, mesh=mesh, lr=1e-2)(
        steps.make_train_state(p, comm, 2, mesh=mesh), batch, 1, **mix[1])
    num = den = 0.0
    for k in ("params", "vel"):
        for g, w in zip(pytree.leaves(mine[k]),
                        blocks(pytree.leaves(one[k]))):
            num += float((g.double() - w.double()).square().sum())
            den += float(w.double().square().sum())
    return same, (num / den) ** 0.5


@pytest.mark.parametrize("strategy", ["bsp", "dgc", "dpsgd"])
@pytest.mark.parametrize("shape", [(2, 2, 1), (2, 1, 2), (1, 2, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_four_gloo_ranks_on_the_card_intrapod(dev, shape, strategy):
    """Four gloo ranks on the one card, a pod split over data and model
    ranks: each rank's blocks of the exchange equal the one-card
    exchange's bit for bit (DGC's sharded leaves through
    ``abs_histogram`` and ``dgc_select``, the gossip through
    ``neighbor_mix_src_many``), and a float32 step's blocks lie within
    1e-5 relative L2 of the one-card step's (``test_torch_intrapod.py``'s
    bounds)."""
    from repro_torch.launch import procs
    for same, l2 in procs.spawn(_four_rank_intrapod, 4, backend="gloo",
                                device=dev, timeout=300,
                                args=(shape, strategy, "float32")):
        assert same and l2 <= 1e-5, (same, l2)
