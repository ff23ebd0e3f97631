"""Public kernel ops, with the signatures of ``repro.kernels.ops``.

A tensor on a CUDA device always goes to the hand-written kernel
(``csrc/*.cu``, built by ``build.py``); a tensor on the CPU goes to the
plain version in ``ref.py``.  There is no other route: a CUDA tensor the
kernel cannot take (wrong dtype, shape or layout) raises, and so does a
failed build or launch.  Operands are checked the same way on both
routes, so a bad operand raises on the card as it does on the CPU.

The ops: ``gaia_select`` and ``gaia_select_many`` (one launch for a list
of tensors); gossip averaging as ``neighbor_mix_many`` (D-PSGD: every
leaf of a model in one launch) and ``neighbor_mix_push_many`` (AD-PSGD:
the stale gather and the snapshot push in one launch), and
``neighbor_mix_src_many`` (the cross-process gossip: every neighbour row
from a gathered or received source), all on
``MixOperands`` that ``mix_operands`` range-checks once on the host, and
as the raw one-matrix ``neighbor_mix`` (and its ``src=`` gather), which
checks its index on the device (one sync a call);
``rand_k_sparsify`` and ``rand_k_sparsify_many`` (DGC's acc and vel of a
list of tensors in one launch); DGC's histogram-thresholded top-s% as
``dgc_sparsify`` (max|v|, histogram, threshold and select in one
launch) and its parts ``abs_histogram``, ``abs_histogram_fused`` and
``dgc_select``, each one launch of the same kernel; ``group_norm``
(NHWC, forward; one block a sample, or one a (sample, group) where a
sample outgrows shared memory, ``group_norm_route``); and attention
forward as ``flash_attention`` (the reference's (B, H, T, D) layout) and
``flash_attention_bthd`` (the model's (B, T, H, D) layout, GQA heads read
in place), one kernel under both, with k and v of their own head dims
(``FLASH_HEAD_DIMS``); where grad mode is on and an input requires grad
both go through ``FlashAttention``, whose forward is that kernel and
whose backward is the plain ``ref.flash_attention_bthd_bwd_ref``; outside
grad mode they run the forward on the inputs detached.

``launch_gaia_select``, ``launch_neighbor_mix_many``,
``launch_neighbor_mix_push_many``, ``launch_neighbor_mix_src_many``,
``launch_neighbor_mix``,
``launch_neighbor_mix_src``, ``launch_rand_k_select``,
``launch_dgc_topk``, ``launch_group_norm`` and ``launch_flash_attention``
launch a kernel alone, on operands the op has checked and allocated; the
ops call them, and ``chip_smoke.py`` times them to separate a kernel from
its wrapper.

``launches`` counts the launches of each kernel by name, incremented
only where the kernel is launched (a list of tensors too long for one
launch counts each of its launches), so a run can show that its path
went through the kernels.

A tensor on the ``meta`` device is a description, not a third place to
compute: every public op checks its operands as the card route does, then
returns ``torch.empty`` outputs of the kernel's own shapes and dtypes on
``meta``, runs none of the plain version's arithmetic, and hands each
listener of the thread's ``meta_sinks()`` (``launch.meta.CostMode`` while
it is active) one entry a launch the card would make: the kernel's name
and the flops and bytes of its bound (``attention_work`` for
``flash_attention``; for the others their operands' bytes and the few
flops an element ``chip_smoke.py``'s bounds count).  ``launches`` counts
no meta entry.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build, ref

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PP, _PLL, _PU, _PI = (ctypes.POINTER(t) for t in (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint, ctypes.c_int))
# v[], w[], out[], n[], count, threshold, counts, device, stream, launches
_GAIA_ARGS = [_PP, _PP, _PP, _PLL, _I, _P, _P, _I, _P, _PI]
# x[], out[], n[], off[], count, idx, w, self_w, K, D, src, src_ld, E, base,
# M, snaps, snaps_ld, device, stream, launches
_MIX_ARGS = [_PP, _PP, _PLL, _PLL, _I, _P, _P, _P, _I, _I, _P, _LL, _I, _I,
             _I, _P, _LL, _I, _P, _PI]
# acc[], vel[], shared[], new_vel[], n[], seeds[], dims[], sizes[],
# cstrides[], count, keep_prob, counts, device, stream, launches
_RANDK_ARGS = [_PP, _PP, _PP, _PP, _PLL, _PU, _PI, _PU, _PU, _I,
               ctypes.c_float, _P, _I, _P, _PI]
#: dims of a tensor's counter layout in ``rand_k_select.cu``: the node axis
#: and four of a conv weight
_RANDK_MAX_DIMS = 5
# phases, v, out, n, n_bins, sparsity, vmax_in, t_in, work, slots, device,
# stream
_DGC_ARGS = [_I, _P, _P, _LL, _I, ctypes.c_float, _P, _P, _P, _I, _I, _P]
# route, x, scale, bias, y, batch, H*W, C, group_size, eps, device, stream
_GN_ARGS = [_I, _P, _P, _P, _P, _LL, _LL, _I, _I, ctypes.c_float, _I, _P]
# q, k, v, o, B, H, Hkv, Tq, Tk, Dk, Dv, strides (q, k, v, o: B, T, H),
# scale, causal, window, softcap, device, stream
_FA_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _PLL,
            ctypes.c_float, _I, _I, ctypes.c_float, _I, _P]

#: the (v, w) dtypes ``gaia_select`` takes on the card, and the entry of
#: ``csrc/gaia_select.cu`` that takes each pair
GAIA_DTYPES = {(torch.float32, torch.float32): "gaia_select_f32",
               (torch.bfloat16, torch.bfloat16): "gaia_select_bf16",
               (torch.float32, torch.bfloat16): "gaia_select_f32_bf16"}
#: the most shared memory a block of the ``neighbor_mix`` kernel takes (a
#: Hopper block's 227 KB): bounds the rows it stages
_MIX_MAX_SMEM = 232448
#: the most bins ``abs_histogram`` takes (the kernel's shared counters)
MAX_BINS = 1024
#: the phases of ``csrc/dgc_topk.cu``'s kernel (bits: max|v| 1, histogram
#: 2, select 4; the threshold runs where histogram and select do) that
#: each op runs in its one launch, by the op's launch-count name
_DGC_PHASES = {"dgc_sparsify": 7, "abs_histogram_fused": 3,
               "abs_histogram": 2, "dgc_select": 4}
#: per-block slots in a ``dgc_topk`` work buffer: a cap on the cooperative
#: grid, above the H100's 132 SMs x 4 blocks of 512 threads
_DGC_SLOTS = 2048
#: the most shared memory GroupNorm's one-block-a-sample route takes (a
#: Hopper block may have up to 227 KB); a larger sample takes the
#: (sample, group) route
GN_SAMPLE_SMEM = 200 * 1024
#: threads a block of the one-block-a-sample route
_GN_SAMPLE_THREADS = 256
#: the (Dk, Dv) head-dim pairs the ``flash_attention`` kernel is built
#: for: the dense LMs' (64, 64), (128, 128), (256, 256); phi-3-vision's
#: (96, 96); MLA's (192, 128) (deepseek-v2), (96, 64) (minicpm3) and
#: (48, 32) (the reduced MLA configs)
FLASH_HEAD_DIMS = frozenset({(64, 64), (128, 128), (256, 256), (96, 96),
                             (192, 128), (96, 64), (48, 32)})
#: query rows a block of the kernel (both bodies): the grid's y runs over
#: Tq / this, at most 65535
_FLASH_BLOCK_Q = 64

#: launches of each kernel since the count was last set to 0 (the gossip
#: kernel counts as ``neighbor_mix`` where it gathers from the leaves
#: themselves, as ``neighbor_mix_src`` where it gathers from a source
#: buffer: AD-PSGD's push, the cross-process gossip's gathered or
#: received rows, the raw op's ``src=``)
launches = {"gaia_select": 0, "neighbor_mix": 0, "neighbor_mix_src": 0,
            "rand_k_select": 0, "dgc_sparsify": 0, "abs_histogram_fused": 0,
            "abs_histogram": 0, "dgc_select": 0, "group_norm": 0,
            "flash_attention": 0}


#: each thread's listeners (``meta_sinks``)
_local = threading.local()
#: the most tensors one launch of a list kernel takes (``gaia_select``,
#: ``neighbor_mix``, ``rand_k_select``): a longer list is several launches
_LIST_LAUNCH = 32


def _kernel(lib: str, entry: str, dtype: torch.dtype, argtypes):
    fn = getattr(build.load(lib), f"{entry}_{_SUFFIX[dtype]}")
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _device_type(*tensors: torch.Tensor) -> str:
    """``"cpu"``, ``"cuda"`` or ``"meta"``: the type of the one device
    every tensor lies on; raises for tensors on several devices, or on
    another type."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel for device {device}")
    return device.type


def _nbytes(*tensors) -> int:
    """Bytes of the tensors (None left out)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def meta_sinks() -> List[Callable[[str, float, float], None]]:
    """This thread's listeners, each called ``sink(kernel, flops,
    n_bytes)`` once a launch that an op's meta route stands for
    (``launch.meta.CostMode`` adds itself while it is active)."""
    if not hasattr(_local, "sinks"):
        _local.sinks = []
    return _local.sinks


def _meta_launch(kernel: str, flops: float, n_bytes: float,
                 n: int = 1) -> None:
    """Hand each of this thread's ``meta_sinks`` ``n`` launches of
    ``kernel`` that together do ``flops`` and move ``n_bytes``, split
    evenly."""
    for sink in meta_sinks():
        for _ in range(n):
            sink(kernel, flops / n, n_bytes / n)


def _list_launches(count: int) -> int:
    """Launches of a list kernel over ``count`` tensors."""
    return -(-count // _LIST_LAUNCH)


def _check(name: str, t: torch.Tensor, dtypes) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _launched(kernel: str, op: str, err: int, n: int = 1) -> None:
    """Raise on a failed launch, else count ``n`` launches of ``kernel``."""
    if err != 0:
        raise RuntimeError(f"{op}: kernel launch failed with cudaError {err}")
    launches[kernel] += n


def _pointers(tensors) -> ctypes.Array:
    """The data pointers of ``tensors`` (None for a missing one) as a C
    array of ``void*``."""
    return (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))


def _lists(op: str, *lists: Sequence) -> List[list]:
    """The argument lists as lists, raising unless they have one length of
    at least 1."""
    out = [list(x) for x in lists]
    if not out[0] or any(len(x) != len(out[0]) for x in out):
        raise ValueError(f"{op}: needs lists of one length >= 1, got "
                         f"{[len(x) for x in out]}")
    return out


def _one_dtype(op: str, tensors: Sequence[torch.Tensor]) -> None:
    """One dtype across a list a launch takes: checked on both routes, so
    a list the card would refuse is refused on the CPU too."""
    for t in tensors:
        if t.dtype != tensors[0].dtype:
            raise TypeError(f"{op}: dtypes differ {tensors[0].dtype} vs "
                            f"{t.dtype}")


def _check_many(op: str, tensors: Sequence[torch.Tensor]) -> None:
    """One dtype the kernel takes, every tensor contiguous."""
    _one_dtype(op, tensors)
    for t in tensors:
        _check(op, t, _SUFFIX)


def gaia_select(v: torch.Tensor, w: torch.Tensor, threshold
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaia significance filter: (v * (|v| > T|w|), int32 count), the
    compare in float32.  ``threshold`` is a Python float or a 0-d float
    tensor (on the device of ``v`` to avoid a copy).  ``gaia_select_many``
    on one tensor."""
    outs, counts = gaia_select_many([v], [w], threshold)
    return outs[0], counts.reshape(())


def gaia_select_many(vs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                     threshold) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``gaia_select`` on each pair (v, w) of ``vs`` and ``ws`` with one
    threshold: ([v_j * (|v_j| > T|w_j|)], int32 (len(vs),) counts).  On
    the card one launch covers every tensor (up to 32 a launch), each
    contiguous, the vs of one dtype and the ws of one, a pair of
    ``GAIA_DTYPES`` (float32 v over bfloat16 w: a bf16 model's float32
    accumulated update against its weights, read as they are); on the CPU
    the plain version loops."""
    vs, ws = _lists("gaia_select", vs, ws)
    for v, w in zip(vs, ws):
        if v.shape != w.shape:
            raise ValueError(f"gaia_select: shapes differ {v.shape} vs "
                             f"{w.shape}")
    _one_dtype("gaia_select", vs)
    _one_dtype("gaia_select", ws)
    t = torch.as_tensor(threshold, dtype=torch.float32, device=vs[0].device)
    kind = _device_type(*vs, *ws, t)
    if kind == "cpu":
        return ref.gaia_select_many_ref(vs, ws, t)
    _check_many("gaia_select", vs)
    _check_many("gaia_select", ws)
    if (vs[0].dtype, ws[0].dtype) not in GAIA_DTYPES:
        raise TypeError(f"gaia_select: (v, w) dtypes ({vs[0].dtype}, "
                        f"{ws[0].dtype}) not in {sorted(map(str, GAIA_DTYPES))}")
    outs = [torch.empty_like(v) for v in vs]
    if kind == "meta":
        counts = torch.empty(len(vs), dtype=torch.int32, device="meta")
        _meta_launch("gaia_select", 3 * sum(v.numel() for v in vs),
                     _nbytes(*vs, *ws, *outs, counts, t),
                     _list_launches(len(vs)))
        return outs, counts
    counts = torch.zeros(len(vs), dtype=torch.int32, device=vs[0].device)
    launch_gaia_select(vs, ws, t.reshape(1).contiguous(), outs, counts)
    return outs, counts


def launch_gaia_select(vs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                       t: torch.Tensor, outs: Sequence[torch.Tensor],
                       counts: torch.Tensor) -> None:
    """Launch the ``gaia_select`` kernel on CUDA operands that
    ``gaia_select_many`` checked (the kernel's instance picked by the
    pair of dtypes): ``t`` a (1,) float32 threshold, each of ``outs``
    like its v, ``counts`` int32 (len(vs),) the kernel adds each
    tensor's count to.  One launch for up to 32 tensors."""
    fn = getattr(build.load("gaia_select"),
                 GAIA_DTYPES[(vs[0].dtype, ws[0].dtype)])
    fn.argtypes, fn.restype = _GAIA_ARGS, ctypes.c_int
    dev = vs[0].device
    made = ctypes.c_int(0)
    err = fn(_pointers(vs), _pointers(ws), _pointers(outs),
             (ctypes.c_longlong * len(vs))(*(v.numel() for v in vs)),
             len(vs), t.data_ptr(), counts.data_ptr(), dev.index,
             torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(made))
    _launched("gaia_select", "gaia_select", err, made.value)


@dataclasses.dataclass(frozen=True)
class MixOperands:
    """A gossip round's padded neighbor operands on the device, checked
    once on the host: ``idx`` (K, D) int32 rows of a source of ``n_src``
    rows, each in [0, n_src); ``w`` (K, D) and ``self_w`` (K,) float32.
    Built by ``mix_operands``; ``with_weights`` swaps the weights alone
    (a participation mask), keeping the checked index."""
    idx: torch.Tensor
    w: torch.Tensor
    self_w: torch.Tensor
    n_src: int

    def with_weights(self, w: torch.Tensor, self_w: torch.Tensor
                     ) -> "MixOperands":
        if w.shape != self.w.shape or self_w.shape != self.self_w.shape:
            raise ValueError(
                f"with_weights: w {tuple(w.shape)} and self_w "
                f"{tuple(self_w.shape)} must keep the shapes "
                f"{tuple(self.w.shape)} and {tuple(self.self_w.shape)}")
        return dataclasses.replace(self, w=w, self_w=self_w)


def mix_operands(nbr_idx: np.ndarray, nbr_w: np.ndarray,
                 self_w: np.ndarray, n_src: int, device) -> MixOperands:
    """``MixOperands`` from the host arrays of
    ``TopologySchedule.neighbor_arrays`` (or AD-PSGD's gather index into
    its snapshot buffer): ``0 <= nbr_idx < n_src`` is checked on these
    arrays, and a failure raises ``ValueError`` before anything reaches
    ``device``; then the arrays are uploaded once, as int32, float32 and
    float32.  An empty source (``n_src`` 0: pods that read no neighbour
    this round) takes only zero weights over padding index 0; the kernel
    then reads no row and each pod keeps its self term."""
    nbr_idx, nbr_w, self_w = (np.asarray(a) for a in (nbr_idx, nbr_w,
                                                      self_w))
    if nbr_idx.ndim != 2 or nbr_w.shape != nbr_idx.shape or \
            self_w.shape != nbr_idx.shape[:1]:
        raise ValueError(
            f"mix_operands: shapes nbr_idx {nbr_idx.shape}, nbr_w "
            f"{nbr_w.shape}, self_w {self_w.shape}; want (K, D), (K, D), "
            "(K,)")
    if nbr_idx.size and (nbr_idx.min() < 0 or
                         nbr_idx.max() >= max(n_src, 1)):
        raise ValueError(f"mix_operands: neighbor index outside [0, "
                         f"{n_src}): range [{nbr_idx.min()}, "
                         f"{nbr_idx.max()}]")
    if n_src == 0 and np.any(nbr_w != 0):
        raise ValueError("mix_operands: no source rows, but a neighbour "
                         "weight is not 0")
    idx_t, w_t, sw_t = (
        torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)
        for a, dtype in ((nbr_idx, np.int32), (nbr_w, np.float32),
                         (self_w, np.float32)))
    return MixOperands(idx_t, w_t, sw_t, int(n_src))


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
    read of the index range, one sync a call).  On the card, one launch
    of the kernel of ``neighbor_mix_many`` on the one leaf x."""
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
    kind = _device_type(x, nbr_idx, nbr_w, self_w,
                        *(() if src is None else (src,)))
    if kind == "meta":
        # the index has no values here: its range check, a host read on
        # the other routes, has nothing to read
        _check("neighbor_mix x", x, _SUFFIX)
        _check_mix_operands(nbr_idx, nbr_w, self_w)
        if src is not None:
            _check("neighbor_mix src", src, _SUFFIX)
        out = torch.empty_like(x)
        _meta_launch("neighbor_mix" if src is None else "neighbor_mix_src",
                     _mix_flops(out, nbr_idx),
                     _nbytes(x, src, nbr_idx, nbr_w, self_w, out))
        return out
    if nbr_idx.numel():
        lo, hi = (int(b) for b in torch.aminmax(nbr_idx))
        if lo < 0 or hi >= M:
            raise ValueError(f"neighbor_mix: neighbor index outside "
                             f"[0, {M}): range [{lo}, {hi}]")
    if kind == "cpu":
        return ref.neighbor_mix_padded_ref(x, nbr_idx, nbr_w, self_w, src)
    _check("neighbor_mix x", x, _SUFFIX)
    _check_mix_operands(nbr_idx, nbr_w, self_w)
    out = torch.empty_like(x)
    if src is None:
        launch_neighbor_mix(x, nbr_idx, nbr_w, self_w, out)
    else:
        _check("neighbor_mix src", src, _SUFFIX)
        launch_neighbor_mix_src(x, src, nbr_idx, nbr_w, self_w, out)
    return out


def neighbor_mix_many(xs: Sequence[torch.Tensor], operands: MixOperands
                      ) -> List[torch.Tensor]:
    """D-PSGD's gossip round on every leaf of a model: for each stacked
    (K, ...) leaf x, its per-node entries as a row, ``neighbor_mix(x,
    operands.idx, operands.w, operands.self_w)``, returned as a new
    contiguous tensor shaped like x.  ``operands.n_src`` must be K (the
    neighbours are the leaves' own rows).  On the card one launch covers
    every leaf (up to 32 a launch), all of one dtype (float32 or
    bfloat16), each contiguous and read where it lies, and no device value
    is read back; on the CPU the plain version loops."""
    xs, K = _mix_leaves("neighbor_mix_many", xs, operands)
    if operands.n_src != K:
        raise ValueError(f"neighbor_mix_many: operands index {operands.n_src}"
                         f" source rows, the leaves have {K}")
    _one_dtype("neighbor_mix_many", xs)
    kind = _device_type(*xs, operands.idx, operands.w, operands.self_w)
    if kind == "cpu":
        return ref.neighbor_mix_many_ref(xs, operands.idx, operands.w,
                                         operands.self_w)
    _check_many("neighbor_mix_many", xs)
    _check_mix_operands(operands.idx, operands.w, operands.self_w)
    outs = [torch.empty_like(x) for x in xs]
    if kind == "meta":
        _meta_mix("neighbor_mix", xs, outs, operands)
        return outs
    launch_neighbor_mix_many(xs, operands, outs)
    return outs


def neighbor_mix_push_many(xs: Sequence[torch.Tensor], snaps: torch.Tensor,
                           operands: MixOperands
                           ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """AD-PSGD's stale gossip round and its snapshot push, on every leaf
    of a model.  ``snaps`` (S + 1, K, N), of the leaves' dtype, holds the
    last S + 1 rounds' stacks flattened, the leaves' per-node entries
    side by side in the order of ``xs`` (N their sizes summed; slot 0 the
    newest).  Returns (mixed leaves, new_snaps): new_snaps[0] is this
    round's leaves flattened, new_snaps[s] = snaps[s - 1]; each leaf x is
    mixed as ``neighbor_mix(x, operands.idx, operands.w, operands.self_w,
    src=new_snaps viewed as ((S + 1) K, N))`` on its own columns, so
    ``idx = staleness * K + neighbour`` reads slot ``staleness`` and
    ``operands.n_src`` must be (S + 1) K.  Both are new tensors.  On the
    card one launch does the push and the gather of every leaf (up to 32
    a launch), reading the leaves and snaps where they lie, with no device
    value read back; on the CPU the plain version loops."""
    xs, K = _mix_leaves("neighbor_mix_push_many", xs, operands)
    N = sum(x[0].numel() for x in xs)
    if snaps.dim() != 3 or snaps.shape[1:] != (K, N):
        raise ValueError(f"neighbor_mix_push_many: snaps {tuple(snaps.shape)}"
                         f" must be (S + 1, {K}, {N})")
    if operands.n_src != snaps.shape[0] * K:
        raise ValueError(f"neighbor_mix_push_many: operands index "
                         f"{operands.n_src} source rows, the buffer has "
                         f"{snaps.shape[0] * K}")
    if snaps.dtype != xs[0].dtype:
        raise TypeError(f"neighbor_mix_push_many: snaps dtype {snaps.dtype} "
                        f"differs from the leaves' {xs[0].dtype}")
    _one_dtype("neighbor_mix_push_many", xs)
    kind = _device_type(*xs, snaps, operands.idx, operands.w,
                        operands.self_w)
    if kind == "cpu":
        return ref.neighbor_mix_push_many_ref(xs, snaps, operands.idx,
                                              operands.w, operands.self_w)
    _check_many("neighbor_mix_push_many", xs + [snaps])
    _check_mix_operands(operands.idx, operands.w, operands.self_w)
    outs = [torch.empty_like(x) for x in xs]
    new_snaps = torch.empty_like(snaps)
    if kind == "meta":
        _meta_mix("neighbor_mix_src", xs, outs, operands, snaps, new_snaps)
        return outs, new_snaps
    launch_neighbor_mix_push_many(xs, snaps, operands, outs, new_snaps)
    return outs, new_snaps


def neighbor_mix_src_many(xs: Sequence[torch.Tensor], src: torch.Tensor,
                          operands: MixOperands) -> List[torch.Tensor]:
    """Gossip averaging of a list of stacked (K, ...) leaves, one dtype,
    with every neighbour row from ``src`` (M, N): the leaves' per-node
    entries side by side in list order (N their sizes summed), so leaf j
    reads its own columns of src.  Each leaf is mixed as
    ``neighbor_mix(x_j, operands.idx, operands.w, operands.self_w,
    src=src[:, off_j:off_j + n_j])``: the self term on x, ``idx`` rows of
    src, ``operands.n_src`` = M; float32 accumulate, one cast.  This is
    the cross-process gossip's mix (the rows gathered or received from
    the other ranks as src).  On the card one launch of the
    ``neighbor_mix`` kernel (up to 32 leaves a launch), counted as
    ``neighbor_mix_src``, with no device value read back; on the CPU the
    plain version loops."""
    xs, K = _mix_leaves("neighbor_mix_src_many", xs, operands)
    N = sum(x[0].numel() for x in xs)
    if src.dim() != 2 or src.shape[1] != N:
        raise ValueError(f"neighbor_mix_src_many: src {tuple(src.shape)} "
                         f"must be (M, {N})")
    if operands.n_src != src.shape[0]:
        raise ValueError(f"neighbor_mix_src_many: operands index "
                         f"{operands.n_src} source rows, src has "
                         f"{src.shape[0]}")
    if src.dtype != xs[0].dtype:
        raise TypeError(f"neighbor_mix_src_many: src dtype {src.dtype} "
                        f"differs from the leaves' {xs[0].dtype}")
    _one_dtype("neighbor_mix_src_many", xs)
    kind = _device_type(*xs, src, operands.idx, operands.w, operands.self_w)
    if kind == "cpu":
        return ref.neighbor_mix_src_many_ref(xs, src, operands.idx,
                                             operands.w, operands.self_w)
    _check_many("neighbor_mix_src_many", xs + [src])
    _check_mix_operands(operands.idx, operands.w, operands.self_w)
    outs = [torch.empty_like(x) for x in xs]
    if kind == "meta":
        _meta_mix("neighbor_mix_src", xs, outs, operands, src)
        return outs
    launch_neighbor_mix_src_many(xs, src, operands, outs)
    return outs


def _mix_leaves(op: str, xs: Sequence[torch.Tensor], operands: MixOperands
                ) -> Tuple[List[torch.Tensor], int]:
    """The leaves as a list of one or more (K, ...) tensors, K the
    operands' node count."""
    xs = list(xs)
    K = operands.idx.shape[0]
    if not xs or any(x.dim() < 1 or x.shape[0] != K for x in xs):
        raise ValueError(f"{op}: needs one or more (K={K}, ...) leaves, got "
                         f"{[tuple(x.shape) for x in xs]}")
    return xs, K


def _check_mix_operands(nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
                        self_w: torch.Tensor) -> None:
    _check("neighbor_mix nbr_idx", nbr_idx, (torch.int32,))
    _check("neighbor_mix nbr_w", nbr_w, (torch.float32,))
    _check("neighbor_mix self_w", self_w, (torch.float32,))


def _mix_flops(outs, nbr_idx: torch.Tensor) -> int:
    """The gossip's multiply-adds, two flops each: the self term and D
    neighbours an output element."""
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    return 2 * (nbr_idx.shape[1] + 1) * sum(y.numel() for y in outs)


def _meta_mix(kernel: str, xs, outs, operands: MixOperands,
              *bufs: torch.Tensor) -> None:
    """The meta route's entries of a list gossip launch (``kernel`` its
    count name): the leaves, the outputs, the operands and ``bufs`` (a
    source, a snapshot buffer and its pushed copy) moved once."""
    _meta_launch(kernel, _mix_flops(outs, operands.idx),
                 _nbytes(*xs, *outs, *bufs, operands.idx, operands.w,
                         operands.self_w), _list_launches(len(xs)))


def _launch_mix(kernel: str, xs: Sequence[torch.Tensor],
                outs: Sequence[torch.Tensor], offs: Sequence[int],
                nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
                self_w: torch.Tensor, *, src: Optional[torch.Tensor] = None,
                extra: int = 0, base: int = 0, n_src: int,
                snaps: Optional[torch.Tensor] = None) -> None:
    """Launch the ``neighbor_mix`` kernel on checked CUDA operands: the
    staged rows of leaf j are its K rows, then ``extra`` rows of ``src``
    (row stride N = src's last dim) at column ``offs[j]``; an index names
    staged row ``base + idx``, in [0, n_src); with ``snaps`` every staged
    row is also written there (same stride and columns).  One launch for
    up to 32 leaves, counted under ``kernel``."""
    K, D = nbr_idx.shape
    # a block's shared memory: 1 KB a staged row, then idx, w and sw
    if (K + extra) * 1024 + K * D * 8 + K * 4 > _MIX_MAX_SMEM:
        raise ValueError(f"neighbor_mix: {K + extra} staged rows at K={K}, "
                         f"D={D} exceed a block's shared memory")
    fn = _kernel("neighbor_mix", "neighbor_mix", xs[0].dtype, _MIX_ARGS)
    dev = xs[0].device
    ld = 0 if src is None else src.shape[-1]
    made = ctypes.c_int(0)
    err = fn(_pointers(xs), _pointers(outs),
             (ctypes.c_longlong * len(xs))(*(x.numel() // K for x in xs)),
             (ctypes.c_longlong * len(xs))(*offs), len(xs),
             nbr_idx.data_ptr(), nbr_w.data_ptr(), self_w.data_ptr(), K, D,
             None if src is None else src.data_ptr(), ld, extra, base, n_src,
             None if snaps is None else snaps.data_ptr(), ld, dev.index,
             torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(made))
    _launched(kernel, "neighbor_mix", err, made.value)


def launch_neighbor_mix_many(xs: Sequence[torch.Tensor],
                             operands: MixOperands,
                             outs: Sequence[torch.Tensor]) -> None:
    """Launch the ``neighbor_mix`` kernel as ``neighbor_mix_many`` does,
    on leaves it checked, writing each leaf's result into ``outs``."""
    _launch_mix("neighbor_mix", xs, outs, [0] * len(xs), operands.idx,
                operands.w, operands.self_w, n_src=operands.n_src)


def launch_neighbor_mix_push_many(xs: Sequence[torch.Tensor],
                                  snaps: torch.Tensor, operands: MixOperands,
                                  outs: Sequence[torch.Tensor],
                                  new_snaps: torch.Tensor) -> None:
    """Launch the ``neighbor_mix`` kernel as ``neighbor_mix_push_many``
    does, on operands it checked: the mixed leaves into ``outs``, the
    pushed buffer into ``new_snaps`` (like ``snaps``)."""
    K = operands.idx.shape[0]
    offs = np.cumsum([0] + [x.numel() // K for x in xs[:-1]]).tolist()
    _launch_mix("neighbor_mix_src", xs, outs, offs, operands.idx, operands.w,
                operands.self_w, src=snaps,
                extra=(snaps.shape[0] - 1) * K, n_src=operands.n_src,
                snaps=new_snaps)


def launch_neighbor_mix_src_many(xs: Sequence[torch.Tensor],
                                 src: torch.Tensor, operands: MixOperands,
                                 outs: Sequence[torch.Tensor]) -> None:
    """Launch the ``neighbor_mix`` kernel as ``neighbor_mix_src_many``
    does, on operands it checked: every row of ``src`` staged after the
    leaves' own, each leaf at its column offset."""
    K = operands.idx.shape[0]
    offs = np.cumsum([0] + [x.numel() // K for x in xs[:-1]]).tolist()
    _launch_mix("neighbor_mix_src", xs, outs, offs, operands.idx, operands.w,
                operands.self_w, src=src, extra=src.shape[0], base=K,
                n_src=src.shape[0])


def launch_neighbor_mix(x: torch.Tensor, nbr_idx: torch.Tensor,
                        nbr_w: torch.Tensor, self_w: torch.Tensor,
                        out: torch.Tensor) -> None:
    """Launch the ``neighbor_mix`` kernel on CUDA operands that
    ``neighbor_mix`` checked, writing into ``out`` (like ``x``): one
    leaf, the (K, N) matrix x."""
    _launch_mix("neighbor_mix", [x], [out], [0], nbr_idx, nbr_w, self_w,
                n_src=x.shape[0])


def launch_neighbor_mix_src(x: torch.Tensor, src: torch.Tensor,
                            nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
                            self_w: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the ``neighbor_mix`` kernel with its neighbour rows from
    ``src`` on CUDA operands that ``neighbor_mix(..., src=src)`` checked,
    writing into ``out`` (like ``x``): one leaf x, every row of src
    staged after x's."""
    _launch_mix("neighbor_mix_src", [x], [out], [0], nbr_idx, nbr_w, self_w,
                src=src, extra=src.shape[0], base=x.shape[0],
                n_src=src.shape[0])


def rand_k_sparsify(v: torch.Tensor, keep_prob, seed
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seeded rand-k sparsification: (v * mask, int32 count) with
    ``mask[i] = uniform01(seed, i) < keep_prob`` over the flat index i
    (``kernels/rng.py``).  ``keep_prob`` is a host number, rounded to
    float32 (the compare is in float32); ``seed`` an integer taken modulo
    2**32.  Both reach the kernel by value, and the mask is generated
    inside it, so the two routes keep the same elements bit for bit.  On
    the card, the ``rand_k_select`` launch of ``rand_k_sparsify_many`` on
    one tensor and no vel."""
    p = float(np.float32(keep_prob))
    key = int(seed) & 0xFFFFFFFF
    kind = _device_type(v)
    if kind == "cpu":
        return ref.rand_k_select_ref(v, p, key)
    _check("rand_k_sparsify v", v, _SUFFIX)
    out = torch.empty_like(v)
    if kind == "meta":
        count = torch.empty((), dtype=torch.int32, device="meta")
        _meta_launch("rand_k_select", 18 * v.numel(), _nbytes(v, out, count))
        return out, count
    counts = torch.zeros(1, dtype=torch.int32, device=v.device)
    launch_rand_k_select([v], None, [out], None, counts, [key], p, [None])
    return out, counts.reshape(())


def rand_k_sparsify_many(accs: Sequence[torch.Tensor],
                         vels: Sequence[torch.Tensor], keep_prob,
                         seeds: Sequence[int],
                         perms: Sequence[Optional[Tuple[int, ...]]]
                         ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                    torch.Tensor]:
    """DGC's rand-k on a list of stacked (K, ...) tensors, acc and vel
    masked by one stream: for tensor j, with the counter of each element
    its flat index in the reference's layout, the tensor's per-node dims
    permuted by ``perms[j]`` (None: this layout), and seed ``seeds[j]``
    (modulo 2**32), ``mask = uniform01(seed, counter) < keep_prob``
    (float32).  Returns ([acc_j * mask], [vel_j - vel_j * mask], int32
    (len(accs),) counts of acc's kept entries), bit-equal to
    ``rand_k_sparsify`` on ``acc_j`` and ``vel_j`` permuted into the
    reference's layout, the results permuted back.  On the card one launch
    covers every tensor (up to 32 a launch), all of one dtype, each
    contiguous, read where it lies (no permuted copies); on the CPU the
    plain version loops."""
    accs, vels, seeds, perms = _lists("rand_k_sparsify", accs, vels, seeds,
                                      perms)
    for a, u, perm in zip(accs, vels, perms):
        if a.shape != u.shape:
            raise ValueError(f"rand_k_sparsify: acc {tuple(a.shape)} and vel "
                             f"{tuple(u.shape)} differ")
        _counter_layout(tuple(a.shape), perm)         # raises on a bad perm
    p = float(np.float32(keep_prob))
    keys = [int(s_) & 0xFFFFFFFF for s_ in seeds]
    _one_dtype("rand_k_sparsify", accs + vels)
    kind = _device_type(*accs, *vels)
    if kind == "cpu":
        return ref.rand_k_sparsify_many_ref(accs, vels, p, keys, perms)
    _check_many("rand_k_sparsify", accs + vels)
    shared = [torch.empty_like(a) for a in accs]
    new_vels = [torch.empty_like(u) for u in vels]
    if kind == "meta":
        counts = torch.empty(len(accs), dtype=torch.int32, device="meta")
        _meta_launch("rand_k_select", 18 * sum(a.numel() for a in accs),
                     _nbytes(*accs, *vels, *shared, *new_vels, counts),
                     _list_launches(len(accs)))
        return shared, new_vels, counts
    counts = torch.zeros(len(accs), dtype=torch.int32, device=accs[0].device)
    launch_rand_k_select(accs, vels, shared, new_vels, counts, keys, p, perms)
    return shared, new_vels, counts


@functools.lru_cache(maxsize=1024)
def _counter_layout(shape: Tuple[int, ...],
                    perm: Optional[Tuple[int, ...]]
                    ) -> Tuple[int, Tuple[int, ...], Tuple[int, ...]]:
    """A stacked (K, ...) tensor's counter layout for ``rand_k_select.cu``:
    (dims, sizes, strides), the sizes this layout's dims, outermost first,
    and each dim's stride in the reference's flat index, where the
    reference lays one node's dims out permuted by ``perm`` (its dim i is
    this layout's per-node dim ``perm[i]``); both padded to 5.  dims = 0
    (no perm): the counter is the flat index itself."""
    pad = (0,) * _RANDK_MAX_DIMS
    if perm is None:
        return 0, pad, pad
    node = shape[1:]
    if sorted(perm) != list(range(len(node))):
        raise ValueError(f"rand_k_sparsify: perm {perm} does not permute the "
                         f"{len(node)} per-node dims of {shape}")
    if len(shape) > _RANDK_MAX_DIMS:
        raise ValueError(f"rand_k_sparsify: a permuted tensor has at most "
                         f"{_RANDK_MAX_DIMS} dims, got {shape}")
    if int(np.prod(shape)) >= 2 ** 32:
        raise ValueError(f"rand_k_sparsify: a permuted tensor has fewer "
                         f"than 2**32 elements, got {shape}")
    ref_strides = [int(np.prod([node[p_] for p_ in perm[i + 1:]]))
                   for i in range(len(perm))]
    strides = (int(np.prod(node)),) + tuple(
        ref_strides[perm.index(d)] for d in range(len(node)))
    fill = (0,) * (_RANDK_MAX_DIMS - len(shape))
    return len(shape), tuple(shape) + fill, strides + fill


def launch_rand_k_select(accs: Sequence[torch.Tensor],
                         vels: Optional[Sequence[torch.Tensor]],
                         shared: Sequence[torch.Tensor],
                         new_vels: Optional[Sequence[torch.Tensor]],
                         counts: torch.Tensor, seeds: Sequence[int],
                         keep_prob: float,
                         perms: Sequence[Optional[Tuple[int, ...]]]) -> None:
    """Launch the ``rand_k_select`` kernel on CUDA operands that an op
    checked: ``shared`` and ``new_vels`` like ``accs`` and ``vels``
    (``vels`` and ``new_vels`` None: acc only), ``counts`` int32
    (len(accs),) the kernel adds each tensor's count to, ``seeds`` in
    [0, 2**32).  One launch for up to 32 tensors."""
    T = len(accs)
    fn = _kernel("rand_k_select", "rand_k_select", accs[0].dtype, _RANDK_ARGS)
    n, dims, sizes, strides = _randk_layouts(
        tuple(tuple(a.shape) for a in accs), tuple(perms))
    none = [None] * T
    dev = accs[0].device
    made = ctypes.c_int(0)
    err = fn(_pointers(accs), _pointers(vels or none), _pointers(shared),
             _pointers(new_vels or none), n, (ctypes.c_uint * T)(*seeds),
             dims, sizes, strides, T, keep_prob, counts.data_ptr(), dev.index,
             torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(made))
    _launched("rand_k_select", "rand_k_sparsify", err, made.value)


@functools.lru_cache(maxsize=256)
def _randk_layouts(shapes: Tuple[Tuple[int, ...], ...],
                   perms: Tuple[Optional[Tuple[int, ...]], ...]
                   ) -> Tuple[ctypes.Array, ...]:
    """The rows of the ``rand_k_select`` table that follow from the
    tensors' shapes and perms alone, as the C arrays the launcher reads
    (and never writes): element counts, then each tensor's counter dims,
    sizes and strides (``_counter_layout``).  Cached: a training run asks
    for the same list every step."""
    T = len(shapes)
    layouts = [_counter_layout(s_, p_) for s_, p_ in zip(shapes, perms)]
    return ((ctypes.c_longlong * T)(*(int(np.prod(s_)) for s_ in shapes)),
            (ctypes.c_int * T)(*(d for d, _, _ in layouts)),
            (ctypes.c_uint * (T * _RANDK_MAX_DIMS))(
                *(x for _, sz, _ in layouts for x in sz)),
            (ctypes.c_uint * (T * _RANDK_MAX_DIMS))(
                *(x for _, _, st in layouts for x in st)))


def _check_bins(n_bins: int) -> None:
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins={n_bins} outside [1, {MAX_BINS}]")


def _scalar(name: str, x, device: torch.device) -> torch.Tensor:
    """A float32 scalar operand on ``device``, as a 0-d tensor."""
    t = torch.as_tensor(x, dtype=torch.float32, device=device)
    if t.numel() != 1:
        raise ValueError(f"{name} must be a scalar, got shape {t.shape}")
    return t.reshape(())


def abs_histogram(v: torch.Tensor, v_max, *, n_bins: int = 256
                  ) -> torch.Tensor:
    """int32 (n_bins,) histogram of |v| over [0, v_max] in ``n_bins``
    linear bins, clamped (an element at or past ``v_max`` goes to the last
    bin), the bin computed in float32 as ``ref.abs_histogram_ref`` does.
    ``v_max`` is a host number or a float32 scalar tensor (on the device
    of ``v`` to avoid a copy); ``n_bins`` is at most ``MAX_BINS``.  On the
    card one launch of the ``dgc_topk`` kernel, histogram phase only."""
    _check_bins(n_bins)
    vm = _scalar("abs_histogram v_max", v_max, v.device)
    kind = _device_type(v, vm)
    if kind == "cpu":
        return ref.abs_histogram_ref(v, n_bins, vm)
    _check("abs_histogram v", v, _SUFFIX)
    if kind == "meta":
        hist = torch.empty(n_bins, dtype=torch.int32, device="meta")
        _meta_launch("abs_histogram", 7 * v.numel(), _nbytes(v, vm, hist))
        return hist
    work = dgc_work(n_bins, v.device)
    launch_dgc_topk("abs_histogram", v, work, n_bins, v_max=vm.reshape(1))
    return dgc_outputs(work, n_bins)[0]


def abs_histogram_fused(v: torch.Tensor, *, n_bins: int = 256
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int32 (n_bins,) histogram of |v| over [0, max|v|], float32 0-d
    max|v|).  On the card one launch of the ``dgc_topk`` kernel, max and
    histogram phases, a grid-wide barrier between them."""
    _check_bins(n_bins)
    if v.numel() == 0:
        raise ValueError("abs_histogram_fused: v is empty")
    kind = _device_type(v)
    if kind == "cpu":
        v_max = v.float().abs().max()
        return ref.abs_histogram_ref(v, n_bins, v_max), v_max
    _check("abs_histogram_fused v", v, _SUFFIX)
    if kind == "meta":
        hist = torch.empty(n_bins, dtype=torch.int32, device="meta")
        v_max = torch.empty((), dtype=torch.float32, device="meta")
        _meta_launch("abs_histogram_fused", 9 * v.numel(),
                     _nbytes(v, hist, v_max))
        return hist, v_max
    work = dgc_work(n_bins, v.device)
    launch_dgc_topk("abs_histogram_fused", v, work, n_bins)
    hist, _, _, v_max = dgc_outputs(work, n_bins)
    return hist, v_max


def dgc_select(v: torch.Tensor, threshold
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absolute-magnitude select: (v where |v| > t else 0, int32 count),
    compared in float32.  ``threshold`` is a host number or a float32
    scalar tensor (on the device of ``v`` to avoid a copy).  On the card
    one launch of the ``dgc_topk`` kernel, select phase only."""
    t = _scalar("dgc_select threshold", threshold, v.device)
    kind = _device_type(v, t)
    if kind == "cpu":
        return ref.dgc_select_ref(v, t)
    _check("dgc_select v", v, _SUFFIX)
    out = torch.empty_like(v)
    if kind == "meta":
        count = torch.empty((), dtype=torch.int32, device="meta")
        _meta_launch("dgc_select", 3 * v.numel(), _nbytes(v, t, out, count))
        return out, count
    work = dgc_work(1, v.device)
    launch_dgc_topk("dgc_select", v, work, 1, out=out, threshold=t.reshape(1))
    return out, dgc_outputs(work, 1)[1]


def dgc_sparsify(v: torch.Tensor, sparsity, *, n_bins: int = 256
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DGC top-s%: (v where |v| > t else 0, int32 count, float32 0-d
    threshold t), t the upper edge of the ``n_bins``-histogram bin of
    |v| over [0, max|v|] where the cumulative count reaches ``sparsity``
    of the total.  On the card one launch of the ``dgc_topk`` kernel:
    max|v|, histogram, threshold (``dgc_topk.threshold_by_count``'s
    search) and select, the outputs written by the kernel alone.  On the
    CPU: the bisection ``ref.dgc_sparsify_ref``, which lands on the same
    bin, so the two routes give one threshold bit for bit."""
    _check_bins(n_bins)
    if v.numel() == 0:
        raise ValueError("dgc_sparsify: v is empty")
    kind = _device_type(v)
    if kind == "cpu":
        return ref.dgc_sparsify_ref(v, sparsity, n_bins=n_bins)
    _check("dgc_sparsify v", v, _SUFFIX)
    out = torch.empty_like(v)
    if kind == "meta":
        count = torch.empty((), dtype=torch.int32, device="meta")
        t = torch.empty((), dtype=torch.float32, device="meta")
        _meta_launch("dgc_sparsify", 12 * v.numel(),
                     _nbytes(v, out, count, t))
        return out, count, t
    work = dgc_work(n_bins, v.device)
    launch_dgc_topk("dgc_sparsify", v, work, n_bins, out=out,
                    sparsity=sparsity)
    _, count, t, _ = dgc_outputs(work, n_bins)
    return out, count, t


def dgc_work(n_bins: int, device: torch.device) -> torch.Tensor:
    """The int32 work buffer of one ``dgc_topk`` launch, left unfilled
    (the kernel writes what it reads): the histogram, the count, the
    threshold and max|v| as float32 bits, then ``_DGC_SLOTS`` per-block
    slots."""
    return torch.empty(n_bins + 3 + _DGC_SLOTS, dtype=torch.int32,
                       device=device)


def dgc_outputs(work: torch.Tensor, n_bins: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """(int32 (n_bins,) histogram, int32 0-d count, float32 0-d
    threshold, float32 0-d max|v|): views of a ``dgc_work`` buffer."""
    floats = work[n_bins + 1:n_bins + 3].view(torch.float32)
    return work[:n_bins], work[n_bins], floats[0], floats[1]


def launch_dgc_topk(op: str, v: torch.Tensor, work: torch.Tensor,
                    n_bins: int, *, out: Optional[torch.Tensor] = None,
                    sparsity=0.0, v_max: Optional[torch.Tensor] = None,
                    threshold: Optional[torch.Tensor] = None) -> None:
    """Launch the ``dgc_topk`` kernel with the phases of ``op`` (a key of
    ``_DGC_PHASES``, also the launch count it adds to) on CUDA operands
    that an op checked: ``work`` a ``dgc_work(n_bins)`` buffer the kernel
    writes its histogram, count, threshold and max|v| into; ``out`` like
    ``v`` (ops that select); ``sparsity`` a host number, rounded to
    float32 (``dgc_sparsify``); ``v_max`` a (1,) float32
    (``abs_histogram``); ``threshold`` a (1,) float32 (``dgc_select``).
    One cooperative launch; a launch the card refuses raises."""
    fn = _kernel("dgc_topk", "dgc_topk", v.dtype, _DGC_ARGS)
    ptr = (lambda t: None if t is None else t.data_ptr())
    stream = torch.cuda.current_stream(v.device).cuda_stream
    _launched(op, op, fn(
        _DGC_PHASES[op], v.data_ptr(), ptr(out), v.numel(), n_bins,
        float(np.float32(sparsity)), ptr(v_max), ptr(threshold),
        work.data_ptr(), _DGC_SLOTS, v.device.index, stream))


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               group_size: int = 2, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of an NHWC (B, H, W, C) tensor, per sample, over groups
    of ``group_size`` adjacent channels: float32 mean and biased
    variance, ``(x - mu) * rsqrt(var + eps) * scale + bias`` with float32
    (C,) ``scale`` and ``bias``, returned in x's dtype.  Forward only, as
    the reference's kernel.  On the card one launch, on the route
    ``group_norm_route`` picks."""
    if x.dim() != 4:
        raise ValueError(f"group_norm: x must be (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    C = x.shape[3]
    if group_size < 1 or C % group_size != 0:
        raise ValueError(f"group_norm: C={C} is not a multiple of "
                         f"group_size={group_size}")
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"group_norm: scale {tuple(scale.shape)} and bias "
                         f"{tuple(bias.shape)} must be ({C},)")
    kind = _device_type(x, scale, bias)
    if kind == "cpu":
        return ref.group_norm_ref(x, scale, bias, group_size=group_size,
                                  eps=eps)
    _check("group_norm x", x, _SUFFIX)
    _check("group_norm scale", scale, (torch.float32,))
    _check("group_norm bias", bias, (torch.float32,))
    out = torch.empty_like(x)
    if kind == "meta":
        _meta_launch("group_norm", 8 * x.numel(),
                     _nbytes(x, scale, bias, out))
        return out
    launch_group_norm(x, scale, bias, out, group_size, eps)
    return out


def group_norm_sample_smem(shape: Sequence[int], dtype: torch.dtype,
                           group_size: int) -> int:
    """Bytes of shared memory a block of GroupNorm's one-block-a-sample
    route takes (as ``csrc/group_norm.cu`` counts them): the sample's
    (H*W, C) tile in x's dtype, rounded up to 16 bytes, then float32
    per-channel partial sums and each group's mean and scale."""
    _, H, W, C = shape
    tile = -(-H * W * C * (torch.finfo(dtype).bits // 8) // 16) * 16
    return tile + 4 * (max(_GN_SAMPLE_THREADS, C) + 2 * (C // group_size))


def group_norm_route(shape: Sequence[int], dtype: torch.dtype,
                     group_size: int) -> str:
    """GroupNorm's kernel route for an NHWC ``shape`` of ``dtype``:
    ``"sample"`` (one block a sample, x read once into shared memory)
    where the sample fits ``GN_SAMPLE_SMEM``, else ``"group"`` (one block
    a (sample, group), the group read three times at stride C)."""
    return ("sample" if group_norm_sample_smem(shape, dtype, group_size)
            <= GN_SAMPLE_SMEM else "group")


def launch_group_norm(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, out: torch.Tensor,
                      group_size: int, eps: float,
                      route: Optional[str] = None) -> None:
    """Launch the ``group_norm`` kernel on CUDA operands that
    ``group_norm`` checked, writing into ``out`` (like ``x``), on
    ``route`` (``group_norm_route``'s by default)."""
    B, H, W, C = x.shape
    route = route or group_norm_route(x.shape, x.dtype, group_size)
    fn = _kernel("group_norm", "group_norm", x.dtype, _GN_ARGS)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _launched("group_norm", "group_norm", fn(
        {"sample": 0, "group": 1}[route], x.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), B, H * W, C, group_size, eps,
        x.device.index, stream))


def _flash_options(window: Optional[int],
                   logit_softcap: Optional[float]) -> None:
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window={window} leaves no key")
    if logit_softcap is not None and not logit_softcap > 0:
        raise ValueError(f"flash_attention: logit_softcap={logit_softcap} "
                         "must be positive")


def _flash_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> None:
    """Raise unless the head dims of q, k and v lie at unit stride."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 and t.shape[3] > 1:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"in its head dim (strides {t.stride()})")


def _flash_card_operands(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, Tq: int) -> None:
    """What the kernel takes beyond the layout: one dtype of two, a (Dk,
    Dv) pair it is built for; in bfloat16, operands whose 16-byte rows
    cp.async can copy."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _SUFFIX:
            raise TypeError(f"flash_attention {name}: dtype {t.dtype} not "
                            f"in {tuple(_SUFFIX)}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} dtype {t.dtype} "
                            f"differs from q's {q.dtype}")
        if q.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])):
            raise ValueError(f"flash_attention: bfloat16 {name} must be "
                             "16-byte aligned with strides a multiple of 8 "
                             f"(strides {t.stride()})")
    dims = (q.shape[3], v.shape[3])
    if dims not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dims (Dk, Dv) = {dims} not "
                         f"in {sorted(FLASH_HEAD_DIMS)}")
    if -(-Tq // _FLASH_BLOCK_Q) > 65535:
        raise ValueError(f"flash_attention: Tq={Tq} exceeds the grid's "
                         f"65535 blocks of {_FLASH_BLOCK_Q} rows")


def attention_pairs(Tq: int, Tk: int, causal: bool,
                    window: Optional[int]) -> int:
    """The (query, key) pairs a head's attention keeps, as
    ``ref.flash_attention_ref`` masks them: the query at row i at
    position ``i + Tk - Tq``, the keys up to it where ``causal``, the
    last ``window`` of them where a window is set."""
    pos = np.arange(Tq, dtype=np.int64) + (Tk - Tq)
    hi = np.minimum(pos, Tk - 1) if causal else np.full(Tq, Tk - 1)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(Tq,
                                                                 np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_work(B: int, H: int, Hkv: int, Tq: int, Tk: int, Dk: int,
                   Dv: int, dtype_bytes: int, causal: bool,
                   window: Optional[int]) -> Tuple[int, int]:
    """(flops, bytes) of one attention forward at its bound: two
    multiply-adds a kept pair and head dim (q.k over Dk, p.v over Dv), so
    4·B·H·Tq·Tk·D with the causal half for Dk = Dv = D; q, k, v and o
    each moved once."""
    flops = 2 * B * H * (Dk + Dv) * attention_pairs(Tq, Tk, causal, window)
    return flops, (B * H * Tq + B * Hkv * Tk) * (Dk + Dv) * dtype_bytes


def _meta_flash(B, H, Hkv, Tq, Tk, Dk, Dv, dtype_bytes, causal,
                window) -> None:
    _meta_launch("flash_attention", *attention_work(
        B, H, Hkv, Tq, Tk, Dk, Dv, dtype_bytes, causal, window))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    logit_softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention forward over q (B, H, Tq, Dk), k (B, H, Tk, Dk) and v
    (B, H, Tk, Dv) of one dtype (the reference's MHA layout;
    ``flash_attention_bthd`` takes the model's layout and GQA heads), as
    ``ref.flash_attention_ref`` computes it: float32 scores, softmax and
    accumulator, the query at row i at position ``i + (Tk - Tq)``,
    ``causal`` and sliding-``window`` masks, ``logit_softcap``, scale
    ``Dk ** -0.5`` by default; the result (B, H, Tq, Dv) in q's dtype,
    contiguous.  On the card the kernel takes float32 or bfloat16 with
    the head dims at unit stride (other strides are free) and (Dk, Dv) in
    ``FLASH_HEAD_DIMS``.  Where an input requires grad and grad mode is
    on, autograd differentiates it through ``FlashAttention``; outside
    grad mode the forward runs on the inputs detached."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q, k, v must be (B, H, T, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Tq, D = q.shape
    if k.shape[:2] != (B, H) or k.shape[3] != D or \
            v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be ({B}, {H}, Tk, {D}) and "
                         f"({B}, {H}, Tk, Dv)")
    _flash_options(window, logit_softcap)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        _flash_layout(q, k, v)
        return FlashAttention.apply(
            *(t.transpose(1, 2) for t in (q, k, v)), causal, window,
            logit_softcap, scale).transpose(1, 2).contiguous()
    q, k, v = q.detach(), k.detach(), v.detach()     # no graph to record
    kind = _device_type(q, k, v)
    if kind == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       logit_softcap=logit_softcap,
                                       scale=scale)
    _flash_layout(q, k, v)
    _flash_card_operands(q, k, v, Tq)
    out = torch.empty((B, H, Tq, v.shape[3]), dtype=q.dtype, device=q.device)
    if kind == "meta":
        _meta_flash(q.shape[0], H, k.shape[1], Tq, k.shape[2], D,
                    v.shape[3], q.element_size(), causal, window)
        return out
    launch_flash_attention(q, k, v, out, causal=causal, window=window,
                           logit_softcap=logit_softcap,
                           scale=D ** -0.5 if scale is None else scale)
    return out


def flash_attention_bthd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         logit_softcap: Optional[float] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """``flash_attention`` on the model's layout: q (B, Tq, H, Dk), k (B,
    Tk, Hkv, Dk) and v (B, Tk, Hkv, Dv) with H % Hkv == 0, query head h
    reading KV head ``h // (H // Hkv)``; the result (B, Tq, H, Dv),
    contiguous, in q's dtype.  The kernel reads q, k and v where they lie,
    with any strides but a unit one for the head dims (views of a fused
    projection, say), so the caller neither expands the KV heads nor
    copies a layout.  The plain version (``ref.flash_attention_bthd_ref``)
    expands the KV heads.  The layout and the grouping are checked on both
    routes; on the card the operands also as ``flash_attention`` checks
    them.  Where an input requires grad and grad mode is on, the call
    goes through ``FlashAttention``, which autograd differentiates;
    outside grad mode the forward runs on the inputs detached."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention_bthd: q, k, v must be (B, T, H, "
                         f"D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Tq, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention_bthd: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be ({B}, Tk, Hkv, {D}) and "
                         f"({B}, Tk, Hkv, Dv)")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"flash_attention_bthd: {H} query heads do not "
                         f"group over {Hkv} KV heads")
    _flash_options(window, logit_softcap)
    _flash_layout(q, k, v)
    opts = (causal, window, logit_softcap, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, *opts)
    return _flash_bthd_forward(q.detach(), k.detach(), v.detach(), *opts)


def _flash_bthd_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, window: Optional[int],
                        logit_softcap: Optional[float],
                        scale: Optional[float]) -> torch.Tensor:
    """``flash_attention_bthd``'s forward on operands it checked: the plain
    version on the CPU, the kernel on the card."""
    kind = _device_type(q, k, v)
    if kind == "cpu":
        return ref.flash_attention_bthd_ref(q, k, v, causal=causal,
                                            window=window,
                                            logit_softcap=logit_softcap,
                                            scale=scale)
    B, Tq, H, D = q.shape
    _flash_card_operands(q, k, v, Tq)
    out = torch.empty((B, Tq, H, v.shape[3]), dtype=q.dtype, device=q.device)
    if kind == "meta":
        _meta_flash(B, H, k.shape[2], Tq, k.shape[1], D, v.shape[3],
                    q.element_size(), causal, window)
        return out
    launch_flash_attention(q, k, v, out, causal=causal, window=window,
                           logit_softcap=logit_softcap,
                           scale=D ** -0.5 if scale is None else scale,
                           layout="bthd")
    return out


class FlashAttention(torch.autograd.Function):
    """Attention that autograd differentiates, on the model's (B, T, H, D)
    layout: ``flash_attention_bthd`` takes it whenever an input requires
    grad.  Forward: the kernel on the card (it runs again where
    ``torch.utils.checkpoint`` recomputes a layer), the plain version on
    the CPU, on the inputs detached, so the kernel sees no input that
    requires grad.  Backward: ``ref.flash_attention_bthd_bwd_ref`` on both
    devices, the exact gradient of the forward's function (float32 scores,
    softmax and accumulator; the reference has no backward kernel), from
    the saved q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_softcap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window,
                        logit_softcap=logit_softcap, scale=scale)
        return _flash_bthd_forward(q.detach(), k.detach(), v.detach(),
                                   causal, window, logit_softcap, scale)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = ref.flash_attention_bthd_bwd_ref(q, k, v, dout,
                                                      **ctx.opts)
        return dq, dk, dv, None, None, None, None


def launch_flash_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, out: torch.Tensor, *,
                           causal: bool, window: Optional[int],
                           logit_softcap: Optional[float], scale: float,
                           layout: str = "bhtd") -> None:
    """Launch the ``flash_attention`` kernel on CUDA operands that an op
    checked, writing into ``out`` (q's shape with v's head dim).
    ``layout`` names the
    order of the four tensors' dims: ``"bhtd"`` (B, H, T, D) or
    ``"bthd"`` (B, T, H, D).  The kernel reads every tensor's batch, time
    and head strides and the KV heads' count from k; query head h reads KV
    head ``h // (H // Hkv)``.  It skips the k-blocks outside the causal
    and window band when Tq <= Tk, where every row keeps a valid key.
    An input that requires grad is refused: the kernel has no backward
    (autograd goes through ``FlashAttention``, which passes it detached
    inputs)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.requires_grad:
            raise ValueError(f"launch_flash_attention: {name} requires grad;"
                             " the kernel has no backward (autograd goes "
                             "through FlashAttention)")
    if layout == "bhtd":
        q, k, v, out = (t.transpose(1, 2) for t in (q, k, v, out))
    elif layout != "bthd":
        raise ValueError(f"launch_flash_attention: layout {layout!r} is "
                         "neither 'bhtd' nor 'bthd'")
    B, Tq, H, Dk = q.shape
    Tk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = _kernel("flash_attention", "flash_attention", q.dtype, _FA_ARGS)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launched("flash_attention", "flash_attention", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Hkv,
        Tq, Tk, Dk, Dv, strides, scale, int(causal), window or 0,
        logit_softcap or 0.0, q.device.index, stream))
