"""Public kernel ops, with the signatures of ``repro.kernels.ops``.

A tensor on a CUDA device always goes to the hand-written kernel
(``csrc/*.cu``, built by ``build.py``); a tensor on the CPU goes to the
plain version in ``ref.py``.  There is no other route: a CUDA tensor the
kernel cannot take (wrong dtype, shape or layout) raises, and so does a
failed build or launch.  Operands are checked the same way on both
routes, so a bad operand raises on the card as it does on the CPU.

``launch_gaia_select``, ``launch_neighbor_mix``,
``launch_neighbor_mix_src`` and ``launch_rand_k_select`` launch a kernel
alone, on operands the op has checked and allocated; the ops call them,
and ``chip_smoke.py`` times them to separate a kernel from its wrapper.

``launches`` counts the launches of each kernel by name, incremented
only where the kernel is launched, so a run can show that its path went
through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build, ref

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# v, w, threshold, out, count, n, device, stream
_GAIA_ARGS = [_P, _P, _P, _P, _P, _LL, _I, _P]
# x, idx, w, self_w, out, K, D, N, device, stream
_MIX_ARGS = [_P, _P, _P, _P, _P, _I, _I, _LL, _I, _P]
# x, src, idx, w, self_w, out, K, D, M, N, device, stream
_MIX_SRC_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _I, _P]
# v, out, count, n, seed, keep_prob, device, stream
_RANDK_ARGS = [_P, _P, _P, _LL, ctypes.c_uint, ctypes.c_float, _I, _P]

#: launches of each kernel since the count was last set to 0
launches = {"gaia_select": 0, "neighbor_mix": 0, "neighbor_mix_src": 0,
            "rand_k_select": 0}


def _kernel(lib: str, entry: str, dtype: torch.dtype, argtypes):
    fn = getattr(build.load(lib), f"{entry}_{_SUFFIX[dtype]}")
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; False when all lie on one
    CUDA device; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return False


def _check(name: str, t: torch.Tensor, dtypes) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _launched(kernel: str, op: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{op}: kernel launch failed with cudaError {err}")
    launches[kernel] += 1


def gaia_select(v: torch.Tensor, w: torch.Tensor, threshold
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaia significance filter: (v * (|v| > T|w|), int32 count), the
    compare in float32.  ``threshold`` is a Python float or a 0-d float
    tensor (on the device of ``v`` to avoid a copy)."""
    if v.shape != w.shape:
        raise ValueError(f"gaia_select: shapes differ {v.shape} vs {w.shape}")
    t = torch.as_tensor(threshold, dtype=torch.float32, device=v.device)
    if _on_cpu(v, w, t):
        return ref.gaia_select_ref(v, w, t)
    _check("gaia_select v", v, _SUFFIX)
    if w.dtype != v.dtype:
        raise TypeError(f"gaia_select: dtypes differ {v.dtype} vs {w.dtype}")
    _check("gaia_select w", w, _SUFFIX)
    out = torch.empty_like(v)
    count = torch.zeros((), dtype=torch.int32, device=v.device)
    launch_gaia_select(v, w, t.reshape(1).contiguous(), out, count)
    return out, count


def launch_gaia_select(v: torch.Tensor, w: torch.Tensor, t: torch.Tensor,
                       out: torch.Tensor, count: torch.Tensor) -> None:
    """Launch the ``gaia_select`` kernel on CUDA operands that
    ``gaia_select`` checked: ``t`` a (1,) float32 threshold, ``out`` like
    ``v``, ``count`` an int32 scalar the kernel adds its count to."""
    fn = _kernel("gaia_select", "gaia_select", v.dtype, _GAIA_ARGS)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    _launched("gaia_select", "gaia_select", fn(
        v.data_ptr(), w.data_ptr(), t.data_ptr(), out.data_ptr(),
        count.data_ptr(), v.numel(), v.device.index, stream))


def neighbor_mix(x: torch.Tensor, nbr_idx: torch.Tensor,
                 nbr_w: torch.Tensor, self_w: torch.Tensor, *,
                 src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sparse gossip averaging y[k] = self_w[k]*x[k] + sum_d
    nbr_w[k,d]*x[nbr_idx[k,d]] over padded neighbor lists (see
    ``TopologySchedule.neighbor_arrays``).  x: (K, N) float32 or
    bfloat16; nbr_idx: (K, D) int32; nbr_w: (K, D) float32; self_w: (K,)
    float32.  With ``src`` (M, N), M >= K, of x's dtype, the neighbour
    rows are gathered from ``src`` instead (AD-PSGD's stale mixing over
    its flattened snapshot buffer); the self term stays on x.
    Accumulates in float32, returns x's dtype.  An index outside [0, M)
    (M = K without ``src``) raises ``ValueError`` on either route (a host
    read of the index range, one sync a call)."""
    if x.dim() != 2:
        raise ValueError(f"neighbor_mix: x must be (K, N), got {x.shape}")
    K, N = x.shape
    if nbr_idx.dim() != 2 or nbr_idx.shape[0] != K or \
            nbr_w.shape != nbr_idx.shape or self_w.shape != (K,):
        raise ValueError(
            f"neighbor_mix: operand shapes x {tuple(x.shape)}, nbr_idx "
            f"{tuple(nbr_idx.shape)}, nbr_w {tuple(nbr_w.shape)}, self_w "
            f"{tuple(self_w.shape)}; want (K, N), (K, D), (K, D), (K,)")
    M = K
    if src is not None:
        if src.dim() != 2 or src.shape[1] != N or src.shape[0] < K:
            raise ValueError(f"neighbor_mix: src {tuple(src.shape)} must be "
                             f"(M, {N}) with M >= {K}")
        if src.dtype != x.dtype:
            raise TypeError(f"neighbor_mix: src dtype {src.dtype} differs "
                            f"from x's {x.dtype}")
        M = src.shape[0]
    on_cpu = _on_cpu(x, nbr_idx, nbr_w, self_w,
                     *(() if src is None else (src,)))
    if nbr_idx.numel():
        lo, hi = (int(b) for b in torch.aminmax(nbr_idx))
        if lo < 0 or hi >= M:
            raise ValueError(f"neighbor_mix: neighbor index outside "
                             f"[0, {M}): range [{lo}, {hi}]")
    if on_cpu:
        return ref.neighbor_mix_padded_ref(x, nbr_idx, nbr_w, self_w, src)
    if K > 65535:
        raise ValueError(f"neighbor_mix: K={K} exceeds the grid's 65535 rows")
    _check("neighbor_mix x", x, _SUFFIX)
    _check("neighbor_mix nbr_idx", nbr_idx, (torch.int32,))
    _check("neighbor_mix nbr_w", nbr_w, (torch.float32,))
    _check("neighbor_mix self_w", self_w, (torch.float32,))
    out = torch.empty_like(x)
    if src is None:
        launch_neighbor_mix(x, nbr_idx, nbr_w, self_w, out)
    else:
        _check("neighbor_mix src", src, _SUFFIX)
        launch_neighbor_mix_src(x, src, nbr_idx, nbr_w, self_w, out)
    return out


def launch_neighbor_mix(x: torch.Tensor, nbr_idx: torch.Tensor,
                        nbr_w: torch.Tensor, self_w: torch.Tensor,
                        out: torch.Tensor) -> None:
    """Launch the ``neighbor_mix`` kernel on CUDA operands that
    ``neighbor_mix`` checked, writing into ``out`` (like ``x``)."""
    K, N = x.shape
    fn = _kernel("neighbor_mix", "neighbor_mix", x.dtype, _MIX_ARGS)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _launched("neighbor_mix", "neighbor_mix", fn(
        x.data_ptr(), nbr_idx.data_ptr(), nbr_w.data_ptr(),
        self_w.data_ptr(), out.data_ptr(), K, nbr_idx.shape[1], N,
        x.device.index, stream))


def launch_neighbor_mix_src(x: torch.Tensor, src: torch.Tensor,
                            nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
                            self_w: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the src-gather variant of the ``neighbor_mix`` kernel on
    CUDA operands that ``neighbor_mix(..., src=src)`` checked, writing
    into ``out`` (like ``x``)."""
    K, N = x.shape
    fn = _kernel("neighbor_mix", "neighbor_mix_src", x.dtype, _MIX_SRC_ARGS)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _launched("neighbor_mix_src", "neighbor_mix", fn(
        x.data_ptr(), src.data_ptr(), nbr_idx.data_ptr(), nbr_w.data_ptr(),
        self_w.data_ptr(), out.data_ptr(), K, nbr_idx.shape[1],
        src.shape[0], N, x.device.index, stream))


def rand_k_sparsify(v: torch.Tensor, keep_prob, seed
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seeded rand-k sparsification: (v * mask, int32 count) with
    ``mask[i] = uniform01(seed, i) < keep_prob`` over the flat index i
    (``kernels/rng.py``).  ``keep_prob`` is a host number, rounded to
    float32 (the compare is in float32); ``seed`` an integer taken modulo
    2**32.  Both reach the kernel by value, and the mask is generated
    inside it, so the two routes keep the same elements bit for bit."""
    p = float(np.float32(keep_prob))
    key = int(seed) & 0xFFFFFFFF
    if _on_cpu(v):
        return ref.rand_k_select_ref(v, p, key)
    _check("rand_k_sparsify v", v, _SUFFIX)
    out = torch.empty_like(v)
    count = torch.zeros((), dtype=torch.int32, device=v.device)
    launch_rand_k_select(v, out, count, key, p)
    return out, count


def launch_rand_k_select(v: torch.Tensor, out: torch.Tensor,
                         count: torch.Tensor, seed: int,
                         keep_prob: float) -> None:
    """Launch the ``rand_k_select`` kernel on a CUDA tensor that
    ``rand_k_sparsify`` checked: ``out`` like ``v``, ``count`` an int32
    scalar the kernel adds its count to, ``seed`` in [0, 2**32)."""
    fn = _kernel("rand_k_select", "rand_k_select", v.dtype, _RANDK_ARGS)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    _launched("rand_k_select", "rand_k_sparsify", fn(
        v.data_ptr(), out.data_ptr(), count.data_ptr(), v.numel(), seed,
        keep_prob, v.device.index, stream))
