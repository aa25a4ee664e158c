"""Build the CUDA sources under ``csrc/`` into one shared library with a
plain C interface, load it with ctypes, and launch its kernels.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/libamtpu_kernels.so csrc/*.cu

The library lands in ``build/torch_kernels/`` at the root of the checkout at
first use and is rebuilt when the hash of the sources or flags changes. No
PyTorch header is included, so a build takes seconds. ``_SIGNATURES`` is
the table of kernels: a kernel ``<name>`` is the C entry ``amtpu_<name>``,
which returns ``cudaGetLastError()`` after its launch, and the key of its
launch count. ``launch`` is the one way a wrapper calls an entry.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from audio_modem_tpu_torch.utils import trace

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libamtpu_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# The kernels: amtpu_<name>'s C signature, every pointer and the stream
# (appended by ``launch``) as c_void_p.
_SIGNATURES = {
    "decode_fused": [
        _P, _P, _P, _I, _I,          # signals, n_valid, min_pos, B, T
        _P, _F,                      # pre1, t_energy
        _P, _P, _P, _P, _P,          # rx_active, ce_known, rx_demod, data_pos, pilot_pos
        _I, _I, _I, _I, _I, _I, _F,  # fft, cp, n_active, nd, npi, ncol_pad, qam_scale
        _I, _I, _I,                  # bps, max_syms, n_pos
        _P,                          # scratch
        _P, _P, _P, _P, _P,          # out: start, coarse, cmetric, fine, detected
        _P, _P, _P,                  # out: bits, ch_re, ch_im
        _P,                          # stream
    ],
    "decode_predicted": [
        _P, _P, _I, _I,              # signals, n_valid, B, T
        _P, _P, _P,                  # start0, ok0, bits0 (NULL: every slot predicted)
        _P, _F,                      # pre1, t_energy
        _P, _P,                      # demod_bins, fft_twiddle
        _P, _P, _P, _P, _P,          # rx_active, ce_known, rx_demod, data_pos, pilot_pos
        _I, _I, _I, _I, _I, _I, _F,  # fft, cp, n_active, nd, npi, ncol_pad, qam_scale
        _I, _I, _I, _I, _I, _I,      # bps, n_sym, n_pred, k_slots, cadence, repetition
        _P,                          # scratch
        _P, _P, _P, _P,              # out: start, fine, ok, packed
        _P,                          # stream
    ],
    "decode_chunks_fused": [
        _P, _I, _I,                  # frames, B, T
        _P, _P, _P, _P, _P,          # rx_active, ce_known, rx_demod, data_pos, pilot_pos
        _I, _I, _I, _I, _I, _I, _F,  # fft, cp, n_active, nd, npi, ncol_pad, qam_scale
        _I, _I,                      # bps, n_sym
        _P,                          # scratch
        _P,                          # out: bits
        _P,                          # stream
    ],
    "stream_demod": [
        _P, _I, ctypes.c_longlong, _I,  # data, B, row stride, L
        _P, _P, _P,                  # ch_re, ch_im, scale
        _P, _P, _P, _P, _P,          # rx_active, ce_known, rx_demod, data_pos, pilot_pos
        _I, _I, _I, _I, _I, _I, _F,  # fft, cp, n_active, nd, npi, ncol_pad, qam_scale
        _I, _I,                      # bps, n_sym
        _P,                          # out: bits
        _P,                          # stream
    ],
    "decode_tail": [
        _P, _P, _P, _P, _P, _P,      # coarse, start, fine, bits, ch_re, ch_im
        _I, _I, _I, _I, _I,          # B, n_bits, n_active, repetition, row_bytes
        _P,                          # out: rows
        _P,                          # stream
    ],
    "stream_scan": [
        _P, _I, _I, _I,              # windows, n_valid, B, W
        _F, _I, _I,                  # min_energy, half, n_pos
        _P,                          # out: rows
        _P,                          # stream
    ],
}

# amtpu_<name>_scratch_floats: the scratch a kernel needs, in floats.
_SIZES = {
    "decode_fused": [_I, _I, _I],   # B, T, n_pos
    "decode_predicted": [_I, _I, _I, _I],  # B, T, n_pred, slot_bits
    "decode_chunks_fused": [_I],    # B
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_launches = dict.fromkeys(_SIGNATURES, 0)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def launch_counts() -> dict[str, int]:
    """Launches per kernel of ``_SIGNATURES`` since the last reset."""
    return dict(_launches)


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _build(lib_path: Path, stamp: Path, digest: str) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cu]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "nvcc.log").write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    stamp.write_text(digest)


def load_library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library, in a
    ``setup.kernel_load`` span (``built``: whether nvcc ran, in a
    ``setup.kernel_build`` span inside it)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with trace.setup_span("setup.kernel_load") as sp:
            lib_path = BUILD_DIR / LIB_NAME
            stamp = BUILD_DIR / "sources.sha256"
            digest = _digest()
            built = not (lib_path.exists() and stamp.exists() and stamp.read_text() == digest)
            sp.set(built=built)
            if built:
                with trace.setup_span("setup.kernel_build"):
                    _build(lib_path, stamp, digest)
            lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, f"amtpu_{name}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name, argtypes in _SIZES.items():
            fn = getattr(lib, f"amtpu_{name}_scratch_floats")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_longlong
        lib.amtpu_error_string.argtypes = [ctypes.c_int]
        lib.amtpu_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, code: int, name: str) -> None:
    if code != 0:
        msg = lib.amtpu_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def scratch_floats(name: str, *dims: int) -> int:
    """The scratch kernel ``name`` needs at ``dims``, in floats."""
    return getattr(load_library(), f"amtpu_{name}_scratch_floats")(*dims)


def launch(name: str, dev: torch.device, *args) -> None:
    """``amtpu_<name>(*args, stream)`` on the current stream of ``dev``, with
    ``dev`` made current for the call (the launch and the shared-memory
    attribute it sets act on the current device, which need not be the
    tensors'); raises on its error code, then counts the launch."""
    lib = load_library()
    with torch.cuda.device(dev):
        code = getattr(lib, f"amtpu_{name}")(*args, torch.cuda.current_stream(dev).cuda_stream)
    check(lib, code, name)
    _launches[name] += 1
