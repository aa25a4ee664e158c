"""audio_modem_tpu_torch — the OFDM acoustic modem in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``audio_modem_tpu`` (JAX/Pallas), which stays beside it as the
reference. Module names follow the JAX package so each counterpart is easy
to find:

  configs    OFDM profiles and modem modes
  tables     per-profile constant tables (DFT matrices, templates, signs)
  ops/       bits, constellations, active-bin DFT, JS-LCG, CRC-32, Reed-Solomon
  sync       preprocess, Schmidl-Cox scan with first-peak commit, xcorr refine
             and detector
  phy        CP strip, modulate, channel estimate, equalize, demodulate, soft
             metrics, timing-tracked demod, EVM
  framing    payload codecs (host), single and batched frame synthesis (device)
  decoder    single-signal and chunk-frame decode with the retry ladder
  api        encode / decode entry points
  channel    channel simulator (AWGN, multipath, clock drift, dropout)
  runtime/   streaming receiver, chunk assembly, live PCM ingest, audio devices
  utils/     WAV I/O, metrics, logging, tracing, plots
  diag       test signals, loopback analysis, BER curves
  arq        selective-repeat retransmission, one stream or many
  cli        the command line
  kernels/   hand-written CUDA kernels, each beside its plain PyTorch version
  parallel/  batched multi-stream decode and the turbo receive round

The port imports nothing of the JAX package. It keeps its own copies of the
wire format's host modules (``configs``, ``ops.lcg``, ``ops.crc32``,
``ops.rs``); tests/test_torch_configs.py holds them equal to the originals,
so the wire format keeps one definition in effect.

Entry points (``api``, ``decoder``, the ``framing`` builders, the receivers,
``diag``, ``arq``, ``runtime.ingest``) run on the card unless the caller
passes ``device="cpu"`` (the CLI: ``--torch-device cpu``); without a CUDA
device a call that does not name the CPU raises.

Everything runs in float32. TF32 is off for matrix products and
convolutions: the plain reference must not round to ~3 decimal digits.
"""

import torch

from audio_modem_tpu_torch.configs import MODES, OFDM_PROFILES, ModemMode, OfdmProfile

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def assert_full_fp32() -> None:
    """Raise if something re-enabled TF32 since this package was imported."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is enabled; the port computes in full float32")


assert_full_fp32()

__all__ = ["MODES", "OFDM_PROFILES", "ModemMode", "OfdmProfile", "__version__", "assert_full_fp32"]
