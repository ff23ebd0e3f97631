#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero
before the last line is printed:

1. device: the card's name and power limit, the library versions;
2. build: compile every CUDA kernel of the training path from
   ``src/repro_torch/kernels/csrc`` (``nvcc``, sm_90a) and time it;
3. kernels against their plain PyTorch versions on the card: ``gaia_select``
   bit-exact (mask and count) at every GN-LeNet parameter shape stacked at
   K=5, at a ragged n=1,000,003, in float32 and bfloat16; ``neighbor_mix``
   allclose (float32 2e-5, bfloat16 2e-2) at (5, 96682) on a ring, on a
   random K=16 degree-4 graph, and in bfloat16;
4. the main path: ``train_decentralized`` trains GN-LeNet at full width
   (96,682 parameters a node, K=5, batch 20): first five steps of each of
   BSP, Gaia and D-PSGD on the card and on the CPU (plain versions) must
   give the same losses; then 30 steps of each on the card, with every
   launch count set to 0 just before each run and read just after;
5. kernel times: the median of 50 CUDA-event-timed launches at the main
   path's shapes: the kernel launch alone (``ms``) and the whole op with its
   checks and allocations (``op_ms``), beside the plain version, the library
   call that computes the same function where there is one, and the least
   time the card could take (bytes over 3.35 TB/s, flops over 67 TFLOP/s
   float32).

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
    sys.stdout.flush()

    # ---------------------------------------------------------------- 4
    phase(4, "main path: train_decentralized on the card")
    ds = synth_images(3000, seed=0, noise=0.8, class_sep=0.35)
    val = synth_images(800, seed=99, noise=0.8, class_sep=0.35)
    idx = partition_label_skew(ds.y, K, 1.0, seed=1)
    parts = [(ds.x[i], ds.y[i]) for i in idx]
    comm = CommConfig(fabric=FabricConfig(topology="ring"))

    # the same five steps on the card and on the CPU (plain versions), TF32
    # off; this also warms the card up (cuDNN, allocator) for the timed runs
    with tf32_off():
        for algo_name in ("bsp", "gaia", "dpsgd"):
            curves = [[loss for _, loss in trainer.train_decentralized(
                cfg, algo_name, parts, (val.x, val.y), comm=comm,
                steps=CPU_CHECK_STEPS, eval_every=CPU_CHECK_STEPS, seed=0,
                device=d).loss_curve] for d in ("cuda", "cpu")]
            np.testing.assert_allclose(curves[0], curves[1], rtol=1e-3)
            print(f"{algo_name}: {CPU_CHECK_STEPS} steps on cuda and cpu "
                  f"agree (rtol 1e-3, TF32 off): "
                  f"{np.round(curves[0], 5).tolist()}", flush=True)
    # warm each strategy up at the default flags too: cuDNN picks its TF32
    # convolutions for each strategy's shapes on first use, which must not
    # fall into the timed runs below
    for algo_name in ("bsp", "gaia", "dpsgd"):
        trainer.train_decentralized(
            cfg, algo_name, parts, (val.x, val.y), comm=comm,
            steps=CPU_CHECK_STEPS, eval_every=CPU_CHECK_STEPS, seed=0)

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
    launches = {"gaia_select": 0, "neighbor_mix": 0}
    results = {}
    try:
        for algo_name in ("bsp", "gaia", "dpsgd"):
            ops.gaia_select.launches = 0
            ops.neighbor_mix.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = trainer.train_decentralized(
                cfg, algo_name, parts, (val.x, val.y), comm=comm,
                steps=STEPS, eval_every=STEPS, seed=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {"gaia_select": ops.gaia_select.launches,
                      "neighbor_mix": ops.neighbor_mix.launches}
            for k_, c in counts.items():
                launches[k_] += c
            results[algo_name] = r
            losses = [loss for _, loss in r.loss_curve]
            print(f"{algo_name}: {STEPS / wall:.2f} steps/s (wall, one "
                  f"eval included, default TF32 flags), loss {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f}, val_acc {r.val_acc:.4f}, "
                  f"comm_total_floats {r.comm_total_floats:.1f}, "
                  f"launches {counts}", flush=True)
            assert len(losses) == STEPS and np.all(np.isfinite(losses)), \
                (algo_name, losses)
            for part in ("params", "mstate", "vel"):
                for tname, t in last_state[algo_name][part].items():
                    assert t.device.type == "cuda", (algo_name, tname,
                                                     t.device)
    finally:
        trainer.make_algorithm = make_algorithm
    bsp_losses = [loss for _, loss in results["bsp"].loss_curve]
    assert np.mean(bsp_losses[-5:]) < np.mean(bsp_losses[:5]), bsp_losses
    assert launches["gaia_select"] >= STEPS * 16, launches
    assert launches["neighbor_mix"] >= STEPS, launches
    print(f"main-path launches: {launches}")

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
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
