"""ctypes bridge to the native C++ host runtime (native/amtpu_host.cpp;
counterpart of audio_modem_tpu/native.py).

Compiles on first use with g++ into ``build/torch_native/`` (a path of this
package's own: the JAX package builds the same source into
``build/libamtpu_host.so``), and falls back to pure numpy/zlib
implementations when no toolchain is available. The library is built under
a temporary name and moved into place, so concurrent processes never load a
half-written file. Everything here is host control-plane work; the device
owns the sample-rate math.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent
_SRC = _ROOT / "native" / "amtpu_host.cpp"
_SO = _ROOT / "build" / "torch_native" / "libamtpu_host.so"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
                _SO.parent.mkdir(parents=True, exist_ok=True)
                tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     str(_SRC), "-o", str(tmp)],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, _SO)
            lib = ctypes.CDLL(str(_SO))
            lib.ema_dc_removal.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_double, ctypes.POINTER(ctypes.c_double),
            ]
            lib.crc32_slice8.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_uint32]
            lib.crc32_slice8.restype = ctypes.c_uint32
            lib.unpack_bits.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int8), ctypes.c_int64]
            lib.pack_bits.argtypes = [ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
            lib.majority_vote.argtypes = [
                ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int8),
                ctypes.c_int64, ctypes.c_int,
            ]
            lib.ema_dc_removal_batch.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
                ctypes.POINTER(ctypes.c_double),
            ]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def ema_dc_removal(x: np.ndarray, alpha: float, dc_state: float) -> tuple[np.ndarray, float]:
    """Sequential EMA DC tracker (app.js:750-755). Returns (cleaned, new_dc)."""
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    if lib is None:
        # Closed-form vectorized fallback, chunked: alpha**-i overflows to
        # inf once i * -ln(alpha) exceeds ~709 (i ≈ 700k at alpha=0.999), so
        # the closed form runs per 65536-sample chunk with the state carried.
        n = len(x)
        if n == 0:
            return x, dc_state
        out = np.empty_like(x)
        CHUNK = 65536
        for off in range(0, n, CHUNK):
            xc = x[off : off + CHUNK].astype(np.float64)
            m = len(xc)
            powers = alpha ** np.arange(1, m + 1, dtype=np.float64)
            inv = alpha ** -np.arange(m, dtype=np.float64)
            weighted = np.cumsum(xc * inv)
            dc = powers * dc_state + (1 - alpha) * (powers / alpha) * weighted
            out[off : off + m] = (xc - dc).astype(np.float32)
            dc_state = float(dc[-1])
        return out, dc_state
    y = np.empty_like(x)
    state = ctypes.c_double(dc_state)
    lib.ema_dc_removal(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(x), alpha, ctypes.byref(state),
    )
    return y, state.value


def ema_dc_removal_batch(x: np.ndarray, alpha: float, dc_states: np.ndarray) -> np.ndarray:
    """[N, n] blocks + [N] states -> cleaned [N, n]; states updated in place."""
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    if lib is None:
        out = np.empty_like(x)
        for i in range(x.shape[0]):
            out[i], dc_states[i] = ema_dc_removal(x[i], alpha, float(dc_states[i]))
        return out
    y = np.empty_like(x)
    states = np.ascontiguousarray(dc_states, dtype=np.float64)
    lib.ema_dc_removal_batch(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        x.shape[0], x.shape[1], alpha,
        states.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    dc_states[:] = states
    return y


def crc32(data: bytes | np.ndarray) -> int:
    lib = _load()
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data, dtype=np.uint8).tobytes()
    if lib is None:
        import zlib

        return zlib.crc32(data) & 0xFFFFFFFF
    buf = np.frombuffer(data, dtype=np.uint8)
    if len(buf) == 0:
        return 0
    return int(lib.crc32_slice8(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf), 0))


def majority_vote(bits: np.ndarray, rep: int) -> np.ndarray:
    lib = _load()
    bits = np.ascontiguousarray(bits, dtype=np.int8)
    n_groups = len(bits) // rep
    if lib is None:
        groups = bits[: n_groups * rep].reshape(n_groups, rep)
        return (groups.sum(axis=1) * 2 >= rep).astype(np.int8)
    out = np.empty(n_groups, dtype=np.int8)
    lib.majority_vote(
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        n_groups, rep,
    )
    return out
