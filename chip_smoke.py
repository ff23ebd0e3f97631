#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero
before the last line is printed:

1. device: the card's name and power limit, the library versions;
2. build: compile the three CUDA sources of the training path from
   ``src/repro_torch/kernels/csrc`` (``nvcc``, sm_90a, one process each, all
   started together) and time it;
3. kernels against their plain PyTorch versions on the card:
   ``gaia_select`` and ``rand_k_select`` bit-exact (output and count) at
   every GN-LeNet parameter shape stacked at K=5 and at a ragged
   n=1,000,003, in float32 and bfloat16 (rand-k with seeds past 2**31 and
   keep = 1 - float32(0.999)); ``neighbor_mix`` allclose (float32 2e-5,
   bfloat16 2e-2) at (5, 96682) on a ring, on a random K=16 degree-4 graph,
   and in bfloat16; its src-gather variant likewise with a (15, 96682)
   snapshot buffer read at staleness 2 and a (48, 96682) one on the
   random graph, and an index past the buffer refused with no launch;
4. the main path: ``train_decentralized`` trains GN-LeNet at full width
   (96,682 parameters a node, K=5, batch 20) under every strategy: BSP,
   Gaia, D-PSGD (ring), AD-PSGD (ring, staleness 2), DGC top-k, DGC
   rand-k, FedAvg (iter_local 5) and D-PSGD steered by SkewScout over the
   topology ladder.  First five steps of each on the card and on the CPU
   (plain versions) must give the same losses (and SkewScout the same θ
   history); AD-PSGD at staleness 0 must give D-PSGD's results exactly on
   the card; then 30 steps of each on the card, with every launch count
   set to 0 just before each run and read just after;
5. kernel times: the median of 50 CUDA-event-timed launches at the main
   path's shapes: the kernel launch alone (``ms``) and the whole op with its
   checks and allocations (``op_ms``), beside the plain version, the library
   call that computes the same function where there is one, and the least
   time the card could take (bytes over 3.35 TB/s, operations over
   67 TFLOP/s, the float32 rate of the CUDA cores, which the integer hash
   of rand-k is counted at too).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  The kernel checks and the
card-against-CPU losses run with TF32 off, so the card and the CPU compute
the same function; the timed 30-step runs use PyTorch's default flags, as a
user's run does.  Exits non-zero without a result where there is no CUDA
device or no ``src/repro_torch`` beside this file.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
STEPS = 30
CPU_CHECK_STEPS = 5
K = 5
#: 1 - 0.999 in float32: DGC's keep probability at its last sparsity rung
KEEP_999 = float(np.float32(1) - np.float32(0.999))
#: the main path's runs: (label, strategy, CommConfig fields besides the
#: ring fabric); the SkewScout run's travel interval is set per phase
RUNS = (("bsp", "bsp", {}), ("gaia", "gaia", {}), ("dpsgd", "dpsgd", {}),
        ("adpsgd", "adpsgd", {"max_staleness": 2}),
        ("dgc", "dgc", {}),
        ("dgc-randk", "dgc", {"dgc_compressor": "randk"}),
        ("fedavg", "fedavg", {"iter_local": 5}),
        ("dpsgd-skewscout", "dpsgd", {"skewscout": True}))


def phase(n: int, title: str) -> None:
    print(f"[phase {n}] {title}", flush=True)


def time_ms(fn, reps: int = 50) -> float:
    """Median device time of one ``fn()`` over ``reps`` launches, each
    between two CUDA events.  A spin kernel queued first holds the
    device while the host enqueues, so the events bracket device work
    and not the host's launch latency."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


@contextlib.contextmanager
def tf32_off():
    """Full float32 matmuls and convolutions, then the flags as they were."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def thetas(history):
    """SkewScout's (step, θ, new θ) sequence, schedules by name."""
    name = lambda th: getattr(th, "name", th)
    return [(h.step, name(h.theta), name(h.new_theta)) for h in history]


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms (its default backward convolutions
    may sum in a different order on every call), then the flag as it was."""
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = flag


def bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from repro_torch.configs.base import CommConfig, FabricConfig
    from repro_torch.configs.cnn_zoo import CNN_ZOO
    from repro_torch.core import trainer
    from repro_torch.core.partition import partition_label_skew
    from repro_torch.data.synthetic import synth_images
    from repro_torch.kernels import build, ops, ref
    from repro_torch.models.cnn import init_cnn
    from repro_torch.topology import build_schedule

    dev = torch.device("cuda")

    # ---------------------------------------------------------------- 1
    phase(1, "device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name}; cuda devices: {torch.cuda.device_count()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}; default TF32 flags: matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN "
          f"{torch.backends.cudnn.allow_tf32}")
    print(smi, flush=True)

    # ---------------------------------------------------------------- 2
    phase(2, "build")
    t0 = time.perf_counter()
    logs = build.build()
    print(f"built {sorted(logs) or 'nothing (libraries up to date)'} in "
          f"{time.perf_counter() - t0:.2f} s")
    for kname, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {kname}: {line.strip()}")
    for kname in build.KERNELS:
        build.load(kname)
    sys.stdout.flush()

    # ---------------------------------------------------------------- 3
    phase(3, "kernels against their plain versions (TF32 off)")
    cfg = CNN_ZOO["gn-lenet"]
    params0, _ = init_cnn(torch.Generator().manual_seed(0), cfg)
    leaf_shapes = [(K,) + tuple(t.shape) for t in params0.values()]
    assert len(leaf_shapes) == 16, leaf_shapes
    n_params = sum(t.numel() for t in params0.values())
    assert n_params == 96_682, n_params
    gen = torch.Generator().manual_seed(1)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    gaia_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in leaf_shapes + [(1_000_003,)]:
            v = randn(*shape, scale=0.01).to(dtype)
            w = randn(*shape, scale=0.3).to(dtype)
            t = torch.tensor(0.1, device=dev)
            sel, cnt = ops.gaia_select(v, w, t)
            rsel, rcnt = ref.gaia_select_ref(v, w, t)
            torch.cuda.synchronize()
            assert torch.equal(sel != 0, rsel != 0), (shape, dtype)
            assert torch.equal(sel, rsel), (shape, dtype)
            assert int(cnt) == int(rcnt), (shape, dtype, int(cnt), int(rcnt))
            gaia_err = max(gaia_err, float((sel.float() - rsel.float())
                                           .abs().max()))
    print(f"gaia_select: bit-exact at {len(leaf_shapes) + 1} shapes x "
          "{float32, bfloat16}")

    def mix_operands(sched):
        idx, w, sw = sched.neighbor_arrays(0)
        return (torch.from_numpy(idx.astype(np.int32)).to(dev),
                torch.from_numpy(w.astype(np.float32)).to(dev),
                torch.from_numpy(sw.astype(np.float32)).to(dev))

    ring_ops = mix_operands(build_schedule("ring", K))
    rand_ops = mix_operands(build_schedule("random", 16, seed=0))
    assert rand_ops[0].shape == (16, 4), rand_ops[0].shape
    mix_err = 0.0
    for label, ops_t, shape, dtype, tol in (
            ("ring f32", ring_ops, (K, n_params), torch.float32, 2e-5),
            ("random K=16 D=4 f32", rand_ops, (16, n_params),
             torch.float32, 2e-5),
            ("ring bf16", ring_ops, (K, n_params), torch.bfloat16, 2e-2)):
        x = randn(*shape).to(dtype)
        out = ops.neighbor_mix(x, *ops_t)
        with tf32_off():
            expect = ref.neighbor_mix_padded_ref(x, *ops_t)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == shape
        err = float((out.float() - expect.float()).abs().max())
        torch.testing.assert_close(out.float(), expect.float(), atol=tol,
                                   rtol=tol)
        if label == "ring f32":
            mix_err = err
        print(f"neighbor_mix {label} {tuple(shape)}: max |err| {err:.3g} "
              f"(tol {tol})")

    def stale_operands(ops_t, stale, k):
        """AD-PSGD's gather index: real neighbours read slot ``stale``."""
        idx, w, sw = ops_t
        return (torch.where(w > 0, stale * k, 0) + idx).int(), w, sw

    ring_src_ops = stale_operands(ring_ops, 2, K)
    rand_src_ops = stale_operands(rand_ops, 2, 16)
    src_err = 0.0
    for label, ops_t, k, dtype, tol in (
            ("ring f32", ring_src_ops, K, torch.float32, 2e-5),
            ("random K=16 D=4 f32", rand_src_ops, 16, torch.float32, 2e-5),
            ("ring bf16", ring_src_ops, K, torch.bfloat16, 2e-2)):
        x = randn(k, n_params).to(dtype)
        src = torch.cat([x, randn(2 * k, n_params).to(dtype)])
        out = ops.neighbor_mix(x, *ops_t, src=src)
        with tf32_off():
            expect = ref.neighbor_mix_padded_ref(x, *ops_t, src)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == x.shape
        err = float((out.float() - expect.float()).abs().max())
        torch.testing.assert_close(out.float(), expect.float(), atol=tol,
                                   rtol=tol)
        if label == "ring f32":
            src_err = err
        print(f"neighbor_mix_src {label} x {tuple(x.shape)} src "
              f"{tuple(src.shape)}: max |err| {err:.3g} (tol {tol})")
    before = dict(ops.launches)
    bad = ring_src_ops[0].clone()
    bad[1, 0] = 3 * K                       # one past the buffer
    try:
        ops.neighbor_mix(x, bad, *ring_src_ops[1:], src=src)
        raise AssertionError("an index past the buffer was not refused")
    except ValueError as e:
        assert "outside" in str(e), e
    assert ops.launches == before, (ops.launches, before)
    print("neighbor_mix_src: an index past the buffer is refused, no launch")

    randk_checks = 0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in leaf_shapes + [(1_000_003,)]:
            v = randn(*shape).to(dtype)
            for keep, seed in ((0.25, 1009), (KEEP_999, 3594),
                               (0.0625, 2**31 + 131)):
                sel, cnt = ops.rand_k_sparsify(v, keep, seed)
                rsel, rcnt = ref.rand_k_select_ref(v, keep, seed)
                torch.cuda.synchronize()
                assert torch.equal(sel != 0, rsel != 0), (shape, dtype, seed)
                assert torch.equal(sel, rsel), (shape, dtype, seed)
                assert int(cnt) == int(rcnt), (shape, dtype, int(cnt),
                                               int(rcnt))
                randk_checks += 1
    print(f"rand_k_select: bit-exact in {randk_checks} checks "
          f"({len(leaf_shapes) + 1} shapes x {{float32, bfloat16}} x 3 "
          f"(keep, seed), keep {KEEP_999!r} and seed {2**31 + 131} among "
          "them)")
    sys.stdout.flush()

    # ---------------------------------------------------------------- 4
    phase(4, "main path: train_decentralized on the card")
    ds = synth_images(3000, seed=0, noise=0.8, class_sep=0.35)
    val = synth_images(800, seed=99, noise=0.8, class_sep=0.35)
    idx = partition_label_skew(ds.y, K, 1.0, seed=1)
    parts = [(ds.x[i], ds.y[i]) for i in idx]

    def run(label, algo_name, fields, device=None, steps=STEPS,
            travel_every=2):
        comm = CommConfig(fabric=FabricConfig(topology="ring"),
                          travel_every=travel_every, **fields)
        return trainer.train_decentralized(
            cfg, algo_name, parts, (val.x, val.y), comm=comm, steps=steps,
            eval_every=steps, seed=0, device=device)

    # the same five steps on the card and on the CPU (plain versions), TF32
    # off; this also warms the card up (cuDNN, allocator) for the timed runs
    with tf32_off():
        for label, algo_name, fields in RUNS:
            r_card, r_cpu = (run(label, algo_name, fields, device=d,
                                 steps=CPU_CHECK_STEPS)
                             for d in ("cuda", "cpu"))
            curves = [[loss for _, loss in r.loss_curve]
                      for r in (r_card, r_cpu)]
            np.testing.assert_allclose(curves[0], curves[1], rtol=1e-3)
            assert thetas(r_card.skewscout_history) == \
                thetas(r_cpu.skewscout_history), label
            print(f"{label}: {CPU_CHECK_STEPS} steps on cuda and cpu "
                  f"agree (rtol 1e-3, TF32 off): "
                  f"{np.round(curves[0], 5).tolist()}"
                  + (f"; SkewScout θ {thetas(r_card.skewscout_history)}"
                     if r_card.skewscout_history else ""), flush=True)
    # AD-PSGD at staleness 0 (buffer depth 3) is D-PSGD bit for bit on the
    # card: its src-gather launch reads slot 0, D-PSGD's own x.  cuDNN runs
    # deterministically here, so the runs differ only in the mixing; D-PSGD
    # runs twice to show that the card repeats itself under these flags
    with tf32_off(), cudnn_deterministic():
        fns, _ = trainer.make_cnn_fns(cfg)
        ring_comm = CommConfig(fabric=FabricConfig(topology="ring"),
                               max_staleness=2)
        p0, s0 = init_cnn(torch.Generator().manual_seed(0), cfg)
        rs = np.random.default_rng(1)
        batches = [{"x": torch.from_numpy(rs.standard_normal(
                        (K, 20, 16, 16, 3)).astype(np.float32)).to(dev),
                    "y": torch.from_numpy(rs.integers(0, 10, (K, 20))).to(dev)}
                   for _ in range(CPU_CHECK_STEPS)]
        finals = []
        for algo_name in ("dpsgd", "dpsgd", "adpsgd"):
            algo = trainer.make_algorithm(algo_name, fns, K, ring_comm,
                                          staleness=0)
            state = algo.init({n: t.to(dev) for n, t in p0.items()},
                              {n: t.to(dev) for n, t in s0.items()})
            losses = []
            for t, b in enumerate(batches):
                state, met = algo.step(state, b,
                                       torch.tensor(0.05, device=dev), t)
                losses.append(float(met["loss"]))
            finals.append((losses, state["params"]))
        for i, label in ((1, "dpsgd run twice"), (2, "adpsgd")):
            assert finals[i][0] == finals[0][0], (label, finals[i][0],
                                                  finals[0][0])
            for n, t in finals[0][1].items():
                assert torch.equal(finals[i][1][n], t), (label, n)
        print(f"adpsgd at staleness 0 (buffer depth 3) equals dpsgd bit for "
              f"bit on the card over {CPU_CHECK_STEPS} steps: losses "
              f"{finals[0][0]}", flush=True)
    # warm each run up at the default flags too: cuDNN picks its TF32
    # convolutions for each strategy's shapes on first use, which must not
    # fall into the timed runs below
    for label, algo_name, fields in RUNS:
        run(label, algo_name, fields, steps=CPU_CHECK_STEPS)

    # record each run's last training state, to check where it lives
    last_state = {}
    make_algorithm = trainer.make_algorithm

    def recording_make_algorithm(*args, **kwargs):
        algo = make_algorithm(*args, **kwargs)
        step = algo.step

        def recorded(state, *a, **kw):
            out = step(state, *a, **kw)
            last_state[algo.name] = out[0]
            return out
        algo.step = recorded
        return algo

    trainer.make_algorithm = recording_make_algorithm
    launches = {k_: 0 for k_ in ops.launches}
    results, rates = {}, {}
    try:
        for label, algo_name, fields in RUNS:
            for k_ in ops.launches:
                ops.launches[k_] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = run(label, algo_name, fields, travel_every=10)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(ops.launches)
            for k_, c in counts.items():
                launches[k_] += c
            results[label], rates[label] = r, STEPS / wall
            losses = [loss for _, loss in r.loss_curve]
            print(f"{label}: {STEPS / wall:.2f} steps/s (wall, one eval "
                  f"included, default TF32 flags), loss {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f}, val_acc {r.val_acc:.4f}, "
                  f"comm_total_floats {r.comm_total_floats:.1f}, "
                  f"launches {counts}"
                  + (f", SkewScout θ {thetas(r.skewscout_history)}"
                     if r.skewscout_history else ""), flush=True)
            assert len(losses) == STEPS and np.all(np.isfinite(losses)), \
                (label, losses)
            for part, tree in last_state[algo_name].items():
                tensors = tree.values() if isinstance(tree, dict) else [tree]
                for t in tensors:
                    assert t.device.type == "cuda", (label, part, t.device)
    finally:
        trainer.make_algorithm = make_algorithm
    bsp_losses = [loss for _, loss in results["bsp"].loss_curve]
    assert np.mean(bsp_losses[-5:]) < np.mean(bsp_losses[:5]), bsp_losses
    assert len(results["dpsgd-skewscout"].skewscout_history) == 3
    assert launches["gaia_select"] >= STEPS * 16, launches
    assert launches["neighbor_mix"] >= STEPS, launches
    assert launches["neighbor_mix_src"] >= STEPS, launches
    assert launches["rand_k_select"] >= STEPS * 32, launches
    print(f"main-path launches: {launches}")
    print("steps/s: " + json.dumps({k_: round(v, 2)
                                   for k_, v in rates.items()}))

    sys.stdout.flush()

    # ---------------------------------------------------------------- 5
    phase(5, "kernel times (median of 50 CUDA-event-timed launches)")
    t = torch.tensor(0.1, device=dev)
    t1 = t.reshape(1)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    leaves = [(randn(*s, scale=0.01), randn(*s, scale=0.3))
              for s in leaf_shapes]
    outs = [torch.empty_like(v) for v, _ in leaves]
    g_ms = sum(time_ms(lambda v=v, w=w, o=o: ops.launch_gaia_select(
        v, w, t1, o, count)) for (v, w), o in zip(leaves, outs))
    g_op = sum(time_ms(lambda v=v, w=w: ops.gaia_select(v, w, t))
               for v, w in leaves)
    g_plain = sum(time_ms(lambda v=v, w=w: ref.gaia_select_ref(v, w, t))
                  for v, w in leaves)
    n_step = K * n_params
    g_bound, g_by = bound_ms(3 * n_step * 4 + 16 * 8, 3 * n_step)
    print(f"gaia_select, one Gaia step (16 launches, {n_step} floats): "
          f"kernel {g_ms:.4f} ms, op {g_op:.4f} ms, plain {g_plain:.4f} ms, "
          f"bound {g_bound:.5f} ms ({g_by})")
    big_v = randn(1_000_003, scale=0.01)
    big_w = randn(1_000_003, scale=0.3)
    big_o = torch.empty_like(big_v)
    print(f"gaia_select n=1,000,003 f32: kernel "
          f"{time_ms(lambda: ops.launch_gaia_select(big_v, big_w, t1, big_o, count)):.4f}"
          f" ms, bound {bound_ms(3 * 1_000_003 * 4, 3 * 1_000_003)[0]:.5f} ms")

    x = randn(K, n_params)
    idx_t, w_t, sw_t = ring_ops
    D = idx_t.shape[1]
    W = torch.zeros(K, K, device=dev)
    W.scatter_add_(1, idx_t.long(), w_t)
    W += torch.diag(sw_t)
    mixed = torch.empty_like(x)
    m_ms = time_ms(lambda: ops.launch_neighbor_mix(x, idx_t, w_t, sw_t, mixed))
    m_op = time_ms(lambda: ops.neighbor_mix(x, idx_t, w_t, sw_t))
    m_plain = time_ms(lambda: ref.neighbor_mix_padded_ref(x, idx_t, w_t,
                                                          sw_t))
    m_lib = time_ms(lambda: torch.matmul(W, x))
    m_bound, m_by = bound_ms(2 * K * n_params * 4 + K * D * 8 + K * 4,
                             2 * (D + 1) * K * n_params)
    print(f"neighbor_mix (5, 96682) f32 ring: kernel {m_ms:.4f} ms, op "
          f"{m_op:.4f} ms, plain {m_plain:.4f} ms, dense W @ X {m_lib:.4f} ms, bound "
          f"{m_bound:.5f} ms ({m_by})")
    x16 = randn(16, n_params)
    mixed16 = torch.empty_like(x16)
    print(f"neighbor_mix (16, 96682) f32 random D=4: kernel "
          f"{time_ms(lambda: ops.launch_neighbor_mix(x16, *rand_ops, mixed16)):.4f}"
          " ms")

    src = torch.cat([x, randn(2 * K, n_params)])
    gidx, _, _ = ring_src_ops
    Wp = torch.zeros(K, 3 * K, device=dev)
    Wp.scatter_add_(1, gidx.long(), w_t)
    Wp[:, :K] += torch.diag(sw_t)           # slot 0 of the buffer is x
    s_ms = time_ms(lambda: ops.launch_neighbor_mix_src(
        x, src, gidx, w_t, sw_t, mixed))
    s_op = time_ms(lambda: ops.neighbor_mix(x, gidx, w_t, sw_t, src=src))
    s_plain = time_ms(lambda: ref.neighbor_mix_padded_ref(x, gidx, w_t, sw_t,
                                                          src))
    s_lib = time_ms(lambda: torch.matmul(Wp, src))
    rows_read = int(torch.unique(gidx[w_t > 0]).numel())
    s_bound, s_by = bound_ms((2 + rows_read / K) * K * n_params * 4
                             + K * D * 8 + K * 4,
                             2 * (D + 1) * K * n_params)
    print(f"neighbor_mix_src x (5, 96682), src (15, 96682) f32 ring, "
          f"staleness 2: kernel {s_ms:.4f} ms, op {s_op:.4f} ms, plain "
          f"{s_plain:.4f} ms, dense W' @ src {s_lib:.4f} ms, bound "
          f"{s_bound:.5f} ms ({s_by}; x, {rows_read} src rows, y)")
    x48 = randn(16, n_params)
    src48 = torch.cat([x48, randn(32, n_params)])
    mixed48 = torch.empty_like(x48)
    print(f"neighbor_mix_src (16, 96682) from (48, 96682) random D=4: kernel "
          f"{time_ms(lambda: ops.launch_neighbor_mix_src(x48, src48, rand_src_ops[0], *rand_src_ops[1:], mixed48)):.4f}"
          " ms")

    # one DGC rand-k step: acc and vel of every tensor, same seed each
    randk_leaves = [randn(*s_, scale=0.01) for s_ in leaf_shapes]
    randk_outs = [torch.empty_like(v) for v in randk_leaves]
    r_ms = 2 * sum(time_ms(lambda v=v, o=o, li=li: ops.launch_rand_k_select(
        v, o, count, 1009 * 7 + li, KEEP_999))
        for li, (v, o) in enumerate(zip(randk_leaves, randk_outs)))
    r_op = 2 * sum(time_ms(lambda v=v, li=li: ops.rand_k_sparsify(
        v, KEEP_999, 1009 * 7 + li)) for li, v in enumerate(randk_leaves))
    r_plain = 2 * sum(time_ms(lambda v=v, li=li: ref.rand_k_select_ref(
        v, KEEP_999, 1009 * 7 + li)) for li, v in enumerate(randk_leaves))
    # per element: v read and out written (8 bytes), ~14 integer and float
    # operations (lowbias32, the 24-bit conversion, the compare, the select)
    r_bound, r_by = bound_ms(2 * n_step * 8 + 32 * 4, 2 * n_step * 14)
    print(f"rand_k_select, one DGC rand-k step (32 launches, 2 x {n_step} "
          f"floats): kernel {r_ms:.4f} ms, op {r_op:.4f} ms, plain "
          f"{r_plain:.4f} ms, bound {r_bound:.5f} ms ({r_by})")
    big_o2 = torch.empty_like(big_v)
    print(f"rand_k_select n=1,000,003 f32: kernel "
          f"{time_ms(lambda: ops.launch_rand_k_select(big_v, big_o2, count, 3594, KEEP_999)):.4f}"
          f" ms, bound {bound_ms(1_000_003 * 8, 1_000_003 * 14)[0]:.5f} ms")

    kernels = [
        {"name": "gaia_select", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gaia_select.cu",
         "replaces": "src/repro/kernels/gaia_select.py:22",
         "launches": launches["gaia_select"], "max_abs_err": gaia_err,
         "ms": g_ms, "op_ms": g_op, "plain_ms": g_plain, "bound_ms": g_bound,
         "bound_by": g_by, "library_ms": None},
        {"name": "neighbor_mix", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/neighbor_mix.cu",
         "replaces": "src/repro/kernels/neighbor_mix.py:48",
         "launches": launches["neighbor_mix"], "max_abs_err": mix_err,
         "ms": m_ms, "op_ms": m_op, "plain_ms": m_plain, "bound_ms": m_bound,
         "bound_by": m_by, "library_ms": m_lib},
        {"name": "neighbor_mix_src", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/neighbor_mix.cu",
         "replaces": "src/repro/kernels/neighbor_mix.py:60",
         "launches": launches["neighbor_mix_src"], "max_abs_err": src_err,
         "ms": s_ms, "op_ms": s_op, "plain_ms": s_plain, "bound_ms": s_bound,
         "bound_by": s_by, "library_ms": s_lib},
        {"name": "rand_k_select", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rand_k_select.cu",
         "replaces": "src/repro/kernels/dgc_topk.py:152",
         "launches": launches["rand_k_select"], "max_abs_err": 0.0,
         "ms": r_ms, "op_ms": r_op, "plain_ms": r_plain, "bound_ms": r_bound,
         "bound_by": r_by, "library_ms": None},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
