"""The PyTorch port imports without JAX, nvcc or a GPU, and CPU tensors take
the plain path without touching the kernel launch counters."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from audio_modem_tpu_torch import MODES
from audio_modem_tpu_torch import kernels
from audio_modem_tpu_torch.kernels import receive

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent

MODULES = [
    "audio_modem_tpu_torch",
    "audio_modem_tpu_torch.tables",
    "audio_modem_tpu_torch.ops.bits",
    "audio_modem_tpu_torch.ops.constellations",
    "audio_modem_tpu_torch.ops.dft",
    "audio_modem_tpu_torch.sync",
    "audio_modem_tpu_torch.phy",
    "audio_modem_tpu_torch.framing",
    "audio_modem_tpu_torch.kernels",
    "audio_modem_tpu_torch.kernels._build",
    "audio_modem_tpu_torch.kernels.receive",
    "audio_modem_tpu_torch.parallel.batch",
    "audio_modem_tpu_torch.parallel.multi_receiver",
    "audio_modem_tpu_torch.decoder",
    "audio_modem_tpu_torch.api",
]


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['triton'] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_tf32_is_off():
    import audio_modem_tpu_torch

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    audio_modem_tpu_torch.assert_full_fp32()


def test_cpu_tensors_take_the_plain_path():
    mode = MODES["QPSK"]
    rng = np.random.default_rng(1)
    kernels.reset_launch_counts()
    sig = torch.from_numpy(rng.standard_normal((2, 4096)).astype(np.float32) * 0.05)
    nv = torch.tensor([4096, 3000], dtype=torch.int32)
    out = receive.decode_fused(sig, nv, torch.zeros(2, dtype=torch.int32), mode, 2)
    assert not out["detected"].any()
    bits = receive.decode_chunks_fused(sig, mode, 2)
    assert bits.shape == (2, 2 * 410) and bits.dtype == torch.int8
    assert torch.equal(receive.decode_chunks_fused_stream(sig, mode, 2), bits)
    out = receive.decode_long_fused(sig, nv, torch.zeros(2, dtype=torch.int32), mode, 2)
    assert not out["detected"].any()
    assert kernels.launch_counts() == {"decode_fused": 0, "decode_chunks_fused": 0, "stream_demod": 0}


def test_mixed_devices_raise():
    import pytest

    with pytest.raises(ValueError):
        kernels.runs_on_kernel(torch.zeros(1), torch.zeros(1, device="meta"))
