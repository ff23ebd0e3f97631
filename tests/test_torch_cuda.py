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
from repro_torch.core import trainer
from repro_torch.kernels import ops, ref
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
    count = torch.zeros((), dtype=torch.int32, device=dev)
    ops.launch_gaia_select(v, w, t, out, count)
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
    ops.launch_rand_k_select(v, out, count, 2**31 + 7, 0.25)
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
