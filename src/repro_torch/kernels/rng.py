"""Counter-based seeded RNG: the topology link model's streams and the
plain version of the rand-k kernel's in-kernel hash.

Every random number is a pure function of (key, counter): Wellons'
lowbias32 avalanche hash of a per-stream key and a per-element counter.
A copy of the NumPy path of ``repro.kernels.rng`` — bit-exact with it —
which ``topology/links.py`` draws its per-edge latency, bandwidth and
participation streams from.  ``uniform_bits`` and ``uniform01`` also take
a torch counter tensor and then compute on the tensor's device, bit-equal
to the NumPy path: ``kernels/ref.py`` uses that as the plain version of
the hash inside ``kernels/csrc/rand_k_select.cu``.  The module itself
imports no torch, so the NumPy topology package stays torch-free.

``uniform_bits``/``uniform01`` are integer-only (the float conversion
keeps 24 bits, exact in float32); ``normal01`` is Box–Muller over two
counter uniforms in float64.  Not cryptographic.
"""
from __future__ import annotations

import sys

import numpy as np

_M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B9          # 2**32 / golden ratio: stream-key spreading
_INV24 = float(2.0 ** -24)  # 24-bit mantissa uniform step
_U32 = np.uint32


def _mix(x):
    """lowbias32: full-avalanche 32-bit hash (x is a uint32 array)."""
    x = x ^ (x >> _U32(16))
    x = x * _U32(0x7FEB352D)
    x = x ^ (x >> _U32(15))
    x = x * _U32(0x846CA68B)
    x = x ^ (x >> _U32(16))
    return x


def _mul32_t(x, c: int):
    """(x * c) mod 2**32 for an int64 tensor ``x`` in [0, 2**32) (torch's
    uint32 arithmetic is incomplete): the constant is split into 16-bit
    halves so no partial product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix_t(x):
    """:func:`_mix` on an int64 tensor holding uint32 values, masked to
    32 bits after each multiply."""
    x = x ^ (x >> 16)
    x = _mul32_t(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32_t(x, 0x846CA68B)
    return x ^ (x >> 16)


def _mix_py(x: int) -> int:
    """Python-int twin of :func:`_mix` (host-side key folding)."""
    x &= _M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    x ^= x >> 16
    return x


def fold_key(*parts: int) -> int:
    """Fold any number of integer key components (seed, tag, edge ids,
    ...) into one uint32 stream key.  Order-sensitive, avalanche-mixed
    per component, so (seed, 0, 1) and (seed, 1, 0) are independent."""
    k = 0
    for p in parts:
        k = _mix_py((k * _GOLD + (int(p) & _M32)) & _M32)
    return k


def fold_keys(key: int, *parts) -> np.ndarray:
    """Vectorized continuation of :func:`fold_key`: fold integer *array*
    components into an existing scalar key, elementwise — bit-equal to
    calling ``fold_key(..., parts[0][k], parts[1][k], ...)`` per element
    (uint32 arithmetic wraps exactly like the ``& _M32`` masking)."""
    k = None
    for p in parts:
        p = np.asarray(p).astype(_U32)
        if k is None:
            # first array part: fold the scalar prefix in exact ints
            k = _mix(_U32((int(key) * _GOLD) & _M32) + p)
        else:
            k = _mix(k * _U32(_GOLD) + p)
    return k if k is not None else np.asarray(int(key), _U32)


def _is_tensor(a) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(a, torch.Tensor)


def uniform_bits(key, ctr):
    """uint32 hash of (key, counter) — the raw stream.  ``key`` scalar
    (or broadcastable array), ``ctr`` any integer array.  With a torch
    ``ctr`` (``key`` then a Python int), the hash values come back as an
    int64 tensor on ``ctr``'s device."""
    if _is_tensor(ctr):
        k = (int(key) & _M32) * _GOLD & _M32
        return _mix_t((ctr.long() & _M32) ^ k)
    key = np.asarray(key).astype(_U32)
    ctr = np.asarray(ctr).astype(_U32)
    return _mix(ctr ^ (key * _U32(_GOLD)))


def uniform01(key, ctr):
    """float32 uniforms in [0, 1) from (key, counter): the top 24 bits
    of the hash, exact in float32, for a NumPy or a torch ``ctr``."""
    bits = uniform_bits(key, ctr)
    if _is_tensor(ctr):
        return (bits >> 8).float() * _INV24
    return (bits >> _U32(8)).astype(np.float32) * np.float32(_INV24)


def normal01(key, ctr, dtype=np.float64) -> np.ndarray:
    """Standard normals via Box–Muller over counters (2*ctr, 2*ctr+1)."""
    ctr = np.asarray(ctr)
    u1 = uniform01(key, ctr * 2).astype(dtype)
    u2 = uniform01(key, ctr * 2 + 1).astype(dtype)
    # 1 - u1 in (0, 1]: log never sees 0
    r = np.sqrt(-2.0 * np.log1p(-u1))
    return r * np.cos(dtype(2.0 * np.pi) * u2)

