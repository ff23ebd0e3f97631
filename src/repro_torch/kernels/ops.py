"""Public kernel ops, with the signatures of ``repro.kernels.ops``.

A tensor on a CUDA device always goes to the hand-written kernel
(``csrc/*.cu``, built by ``build.py``); a tensor on the CPU goes to the
plain version in ``ref.py``.  There is no other route: a CUDA tensor the
kernel cannot take (wrong dtype, shape or layout) raises, and so does a
failed build or launch.  Operands are checked the same way on both
routes, so a bad operand raises on the card as it does on the CPU.

``launch_gaia_select`` and ``launch_neighbor_mix`` launch a kernel alone,
on operands the op has checked and allocated; the ops call them, and
``chip_smoke.py`` times them to separate a kernel from its wrapper.

Each op counts its kernel launches in a plain integer attribute,
``gaia_select.launches`` and ``neighbor_mix.launches``, incremented only
where the kernel is launched, so a run can show that its path went
through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build, ref

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# v, w, threshold, out, count, n, device, stream
_GAIA_ARGS = [_P, _P, _P, _P, _P, _LL, _I, _P]
# x, idx, w, self_w, out, K, D, N, device, stream
_MIX_ARGS = [_P, _P, _P, _P, _P, _I, _I, _LL, _I, _P]


def _kernel(name: str, dtype: torch.dtype, argtypes):
    fn = getattr(build.load(name), f"{name}_{_SUFFIX[dtype]}")
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


def _raise_on_error(op: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{op}: kernel launch failed with cudaError {err}")


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
    fn = _kernel("gaia_select", v.dtype, _GAIA_ARGS)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    _raise_on_error("gaia_select", fn(
        v.data_ptr(), w.data_ptr(), t.data_ptr(), out.data_ptr(),
        count.data_ptr(), v.numel(), v.device.index, stream))
    gaia_select.launches += 1


def neighbor_mix(x: torch.Tensor, nbr_idx: torch.Tensor,
                 nbr_w: torch.Tensor, self_w: torch.Tensor) -> torch.Tensor:
    """Sparse gossip averaging y[k] = self_w[k]*x[k] + sum_d
    nbr_w[k,d]*x[nbr_idx[k,d]] over padded neighbor lists (see
    ``TopologySchedule.neighbor_arrays``).  x: (K, N) float32 or
    bfloat16; nbr_idx: (K, D) int32; nbr_w: (K, D) float32; self_w: (K,)
    float32.  Accumulates in float32, returns x's dtype.  An index
    outside [0, K) raises ``ValueError`` on either route (a host read of
    the index range, one sync a call)."""
    if x.dim() != 2:
        raise ValueError(f"neighbor_mix: x must be (K, N), got {x.shape}")
    K, N = x.shape
    if nbr_idx.dim() != 2 or nbr_idx.shape[0] != K or \
            nbr_w.shape != nbr_idx.shape or self_w.shape != (K,):
        raise ValueError(
            f"neighbor_mix: operand shapes x {tuple(x.shape)}, nbr_idx "
            f"{tuple(nbr_idx.shape)}, nbr_w {tuple(nbr_w.shape)}, self_w "
            f"{tuple(self_w.shape)}; want (K, N), (K, D), (K, D), (K,)")
    on_cpu = _on_cpu(x, nbr_idx, nbr_w, self_w)
    if nbr_idx.numel():
        lo, hi = (int(b) for b in torch.aminmax(nbr_idx))
        if lo < 0 or hi >= K:
            raise ValueError(f"neighbor_mix: neighbor index outside "
                             f"[0, {K}): range [{lo}, {hi}]")
    if on_cpu:
        return ref.neighbor_mix_padded_ref(x, nbr_idx, nbr_w, self_w)
    if K > 65535:
        raise ValueError(f"neighbor_mix: K={K} exceeds the grid's 65535 rows")
    _check("neighbor_mix x", x, _SUFFIX)
    _check("neighbor_mix nbr_idx", nbr_idx, (torch.int32,))
    _check("neighbor_mix nbr_w", nbr_w, (torch.float32,))
    _check("neighbor_mix self_w", self_w, (torch.float32,))
    out = torch.empty_like(x)
    launch_neighbor_mix(x, nbr_idx, nbr_w, self_w, out)
    return out


def launch_neighbor_mix(x: torch.Tensor, nbr_idx: torch.Tensor,
                        nbr_w: torch.Tensor, self_w: torch.Tensor,
                        out: torch.Tensor) -> None:
    """Launch the ``neighbor_mix`` kernel on CUDA operands that
    ``neighbor_mix`` checked, writing into ``out`` (like ``x``)."""
    K, N = x.shape
    fn = _kernel("neighbor_mix", x.dtype, _MIX_ARGS)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on_error("neighbor_mix", fn(
        x.data_ptr(), nbr_idx.data_ptr(), nbr_w.data_ptr(),
        self_w.data_ptr(), out.data_ptr(), K, nbr_idx.shape[1], N,
        x.device.index, stream))
    neighbor_mix.launches += 1


gaia_select.launches = 0
neighbor_mix.launches = 0
