"""Parameter-tree checkpoints in the reference's on-disk format
(``repro.checkpointing``): each package reads the other's files.

``<path>/ckpt_<step>/`` (or ``<path>`` itself without a step) holds

- ``payload.npz``: the tree's leaves as ``leaf_0``, ``leaf_1``, ... in
  JAX's flatten order (``repro_torch.pytree``: dict keys sorted, ``None``
  holds no leaf), each a NumPy array; a dtype NumPy lacks (bfloat16) is
  stored as float32, as the reference's ``to_np`` does;
- ``meta.msgpack``: a msgpack map {"treedef": the tree's
  ``str(PyTreeDef)``, "n_leaves": int, "step": int or nil, "dtypes": the
  leaves' dtype names}, byte for byte what ``msgpack.packb`` writes for
  it.

A save writes into a temporary directory beside the target, one leaf at a
time, and renames it into place.  With a ``mesh`` (``launch.mesh``), each
rank holds its block of a pod-stacked tree: ``save`` gathers each leaf
whole, first over the pod's ``data`` and ``model`` ranks where the mesh
has such axes (``sharding.gather_leaf``), then over the pod group to its
first rank, which writes the stacked leaf before the next is gathered,
so a checkpoint written by many ranks is, array for array, the one-card
checkpoint of the same stacked state; ``restore`` hands each rank its
block, reading only its pods' bytes of each array.  The
port encodes and decodes the msgpack subset that ``meta`` uses (a map of
str keys to str, int, nil and arrays of str) itself, so it needs no
``msgpack`` package.
"""
from __future__ import annotations

import math
import os
import shutil
import struct
import tempfile
import zipfile
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.launch.mesh import INTRA
from repro_torch.launch.sharding import gather_leaf, intra_pod, local_slices

Tree = Any

#: torch dtypes NumPy holds as they are; any other (bfloat16) is stored
#: as float32
_NATIVE = {torch.float64, torch.float32, torch.float16, torch.int64,
           torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool}


def _target(path: str, step: Optional[int]) -> str:
    return os.path.join(path, f"ckpt_{step}") if step is not None else path


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype not in _NATIVE:
        t = t.float()
    return t.numpy()


def _leaf_specs(tree: Tree, specs: Optional[Tree], mesh) -> List[tuple]:
    """Each leaf's spec by ``specs`` (a tree of ``sharding`` specs like
    ``tree``'s), ``("pod",)`` for every leaf without them.  Raises
    ``ValueError`` on a mesh with a ``data`` or ``model`` axis above 1
    without ``specs``, or with a leaf whose pod axis is not its first
    (AD-PSGD's snapshot buffers: their blocks lie side by side, not as a
    block of one array)."""
    if specs is None:
        if intra_pod(mesh):
            raise ValueError("a checkpoint on a mesh with data or model "
                             "axes needs the tree's specs (sharding."
                             "train_state_shardings or param_shardings)")
        return [("pod",)] * len(pytree.leaves(tree))
    out = [tuple(s) for s in pytree.leaves_like(specs, tree)]
    if intra_pod(mesh) and any("pod" in s and s.index("pod") for s in out):
        raise ValueError("a leaf whose pod axis is not its first (the "
                         "snapshot buffers) holds rank blocks side by side "
                         "on a mesh with data or model axes; checkpoint "
                         "params, vel and acc")
    return out


def _pod_axis(spec: tuple) -> Optional[int]:
    return spec.index("pod") if "pod" in spec else None


def save(path: str, tree: Tree, step: Optional[int] = None, *,
         mesh=None, specs: Optional[Tree] = None) -> str:
    """Writes ``tree``'s leaves and meta to ``<path>/ckpt_<step>`` (or
    ``path`` when ``step`` is None), replacing what was there; returns the
    directory.  Leaves on the card are copied to the host one at a time.

    With ``mesh`` every rank calls this with its block of the tree: each
    leaf's blocks along its pod axis (axis 0, or where ``specs``, e.g.
    ``sharding.train_state_shardings``' tree, puts ``"pod"``) are
    gathered to the pod group's first rank, which writes the stacked
    leaf; on a mesh with a ``data`` or ``model`` axis above 1 (``specs``
    required) the pod's blocks are all-gathered over those axes first.
    Every rank returns once all are written."""
    target = _target(path, step)
    leaves = pytree.leaves(tree)
    meta = packb({"treedef": pytree.treedef_str(tree),
                  "n_leaves": len(leaves), "step": step,
                  "dtypes": [pytree.dtype_name(t.dtype) for t in leaves]})
    if mesh is None:
        _write(target, leaves, meta)
        return target

    intra = intra_pod(mesh)
    writes_pod = all(mesh.coords.get(a, 0) == 0 for a in INTRA)

    def gathered():
        """The stacked leaves, gathered one at a time (None off the first
        rank)."""
        for t, spec in zip(leaves, _leaf_specs(tree, specs, mesh)):
            if intra:
                t = gather_leaf(t, spec, mesh)
            ax = _pod_axis(spec)
            if not writes_pod or ax is None:
                yield t
                continue
            g = mesh.gather(t.movedim(ax, 0))
            yield None if g is None else g.movedim(0, ax)
    if mesh.pod_rank == 0 and writes_pod:
        _write(target, gathered(), meta)
    else:
        for _ in gathered():
            pass
    mesh.barrier()
    return target


def _write(target: str, leaves: Iterable[torch.Tensor], meta: bytes
           ) -> None:
    """``payload.npz`` as ``np.savez`` writes it (stored, zip64 members),
    each leaf converted and written before the next is taken, then
    ``meta.msgpack``."""
    parent = os.path.dirname(target) or "."
    os.makedirs(parent, exist_ok=True)
    tmpdir = tempfile.mkdtemp(dir=parent)
    try:
        with zipfile.ZipFile(os.path.join(tmpdir, "payload.npz"), "w",
                             zipfile.ZIP_STORED, allowZip64=True) as zf:
            for i, t in enumerate(leaves):
                with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, _to_numpy(t),
                                              allow_pickle=False)
        with open(os.path.join(tmpdir, "meta.msgpack"), "wb") as f:
            f.write(meta)
        if os.path.isdir(target):
            shutil.rmtree(target)
        os.replace(tmpdir, target)
    except BaseException:
        shutil.rmtree(tmpdir, ignore_errors=True)
        raise


def restore(path: str, like: Tree, step: Optional[int] = None, *,
            mesh=None, specs: Optional[Tree] = None) -> Tree:
    """The checkpoint at ``<path>/ckpt_<step>`` (or ``path``) as a tree of
    ``like``'s structure, each leaf cast to the dtype of ``like``'s leaf
    at its place and put on that leaf's device.  With ``mesh``, ``like``
    holds this rank's blocks, and of each leaf only the rank's block of
    its pod axis (as ``save`` takes ``specs``) is read; on a mesh with a
    ``data`` or ``model`` axis above 1 the rank's block of those
    dimensions is then cut from it.  Raises
    ``ValueError`` where the leaf count or a shape differs from
    ``like``'s."""
    target = _target(path, step)
    want = pytree.leaves(like)
    leaf_specs = ([()] * len(want) if mesh is None
                  else _leaf_specs(like, specs, mesh))
    out = []
    with zipfile.ZipFile(os.path.join(target, "payload.npz")) as zf:
        n = sum(name.endswith(".npy") for name in zf.namelist())
        if n != len(want):
            raise ValueError(f"checkpoint {target} has {n} leaves, the "
                             f"tree {len(want)}")
        for i, (w, spec) in enumerate(zip(want, leaf_specs)):
            with zf.open(f"leaf_{i}.npy") as f:
                a = _read_block(f, _pod_axis(spec), mesh)
            if intra_pod(mesh):
                inner = tuple(ax if ax in ("data", "model") else None
                              for ax in spec)
                a = np.ascontiguousarray(
                    a[local_slices(inner, a.shape, mesh)])
            if tuple(a.shape) != tuple(w.shape):
                raise ValueError(f"checkpoint {target} leaf {i}: shape "
                                 f"{a.shape}, the tree's {tuple(w.shape)}")
            out.append(torch.from_numpy(a).to(device=w.device,
                                              dtype=w.dtype))
    return pytree.unflatten(like, out)


def _read_block(f, axis: Optional[int], mesh) -> np.ndarray:
    """The ``.npy`` array in ``f``, or (``axis`` given) this rank's block
    of that axis (``sharding.local_slices``): a C-ordered array's block is
    prod(shape[:axis]) runs of bytes, each read after a seek past the
    rest."""
    if axis is None:
        return np.lib.format.read_array(f, allow_pickle=False)
    version = np.lib.format.read_magic(f)
    shape, fortran, dtype = {
        (1, 0): np.lib.format.read_array_header_1_0,
        (2, 0): np.lib.format.read_array_header_2_0}[version](f)
    (rows,) = local_slices(("pod",), (shape[axis],), mesh)
    if fortran:
        f.seek(0)
        a = np.lib.format.read_array(f, allow_pickle=False)
        return a[(slice(None),) * axis + (rows,)]
    n = rows.stop - rows.start
    out = np.empty(shape[:axis] + (n,) + shape[axis + 1:], dtype)
    run = n * math.prod(shape[axis + 1:]) * dtype.itemsize
    dst, start = memoryview(out.reshape(-1).view(np.uint8)), f.tell()
    for o in range(math.prod(shape[:axis])):
        f.seek(start + (o * shape[axis] + rows.start) * (run // n))
        dst[o * run:(o + 1) * run] = f.read(run)
    return out


def load_meta(path: str, step: Optional[int] = None) -> Dict[str, Any]:
    """The ``meta.msgpack`` map of a checkpoint, decoded."""
    with open(os.path.join(_target(path, step), "meta.msgpack"), "rb") as f:
        return unpackb(f.read())


def latest_step(path: str) -> Optional[int]:
    """The largest step of the ``ckpt_<step>`` directories in ``path``,
    None where there is none."""
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(path)
             if d.startswith("ckpt_")]
    return max(steps) if steps else None


# ---------------------------------------------------------------------------
# msgpack: the subset meta uses
# ---------------------------------------------------------------------------

def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj)``'s bytes for str, int (64-bit), None, lists
    and tuples of these, and dicts with str keys (in their order)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _sized(out: bytearray, n: int, fix: Optional[Tuple[int, int]],
           wide: Tuple[Tuple[int, int, str], ...]) -> None:
    """A length header: the fix form (``fix``: (prefix, limit)) below its
    limit, else the first wide form (code, limit, struct format) it
    fits."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
        return
    for code, limit, fmt in wide:
        if n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _sized(out, len(b), (0xA0, 32), ((0xD9, 1 << 8, ">B"),
                                         (0xDA, 1 << 16, ">H"),
                                         (0xDB, 1 << 32, ">I")))
        out += b
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), (0x90, 16), ((0xDC, 1 << 16, ">H"),
                                           (0xDD, 1 << 32, ">I")))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _sized(out, len(obj), (0x80, 16), ((0xDE, 1 << 16, ">H"),
                                           (0xDF, 1 << 32, ">I")))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack: key {k!r} is not a str")
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def _pack_int(n: int, out: bytearray) -> None:
    """The smallest form, as msgpack-python picks it: positive fixint,
    else unsigned 8-64 bits for n >= 0; negative fixint, else signed 8-64
    bits."""
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt, bits in ((0xCC, ">B", 8), (0xCD, ">H", 16),
                                (0xCE, ">I", 32), (0xCF, ">Q", 64)):
            if n < 1 << bits:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"msgpack: int {n} too large")
    else:
        for code, fmt, bits in ((0xD0, ">b", 8), (0xD1, ">h", 16),
                                (0xD2, ">i", 32), (0xD3, ">q", 64)):
            if n >= -(1 << (bits - 1)):
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"msgpack: int {n} too small")


def unpackb(data: bytes) -> Any:
    """The object ``packb`` (or ``msgpack.packb``) wrote, for the same
    subset: arrays come back as lists, maps as dicts."""
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"msgpack: {len(data) - end} trailing bytes")
    return obj


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENGTHS = {0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _unpack(buf: memoryview, i: int) -> Tuple[Any, int]:
    code = buf[i]
    i += 1
    if code < 0x80:
        return code, i
    if code >= 0xE0:
        return code - 0x100, i
    if code == 0xC0:
        return None, i
    if code in (0xC2, 0xC3):
        return code == 0xC3, i
    if code in _FIXED:
        fmt = _FIXED[code]
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, i)[0], i + size
    if 0xA0 <= code < 0xC0:
        kind, n = "str", code & 0x1F
    elif 0x90 <= code < 0xA0:
        kind, n = "array", code & 0x0F
    elif 0x80 <= code < 0x90:
        kind, n = "map", code & 0x0F
    elif code in _LENGTHS:
        kind, fmt = _LENGTHS[code]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
    else:
        raise ValueError(f"msgpack: type byte {code:#x} outside the subset")
    if kind == "str":
        return bytes(buf[i:i + n]).decode("utf-8"), i + n
    if kind == "array":
        items: List[Any] = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            items.append(v)
        return items, i
    out: Dict[Any, Any] = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        out[k], i = _unpack(buf, i)
    return out, i
