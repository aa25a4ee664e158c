"""Kernels A and B on the card against their plain versions, at small
shapes. Marked ``cuda``: on a machine without a CUDA device each test skips
with the reason (the CUDA kernels have no CPU or interpret mode).

    python -m pytest tests/test_torch_cuda.py -m cuda -q

on a machine with an NVIDIA Hopper GPU and nvcc builds the kernels and runs
them."""

import numpy as np
import pytest
import torch

from audio_modem_tpu_torch import MODES, framing
from audio_modem_tpu_torch.kernels import launch_counts, receive, reset_launch_counts
from audio_modem_tpu_torch.parallel import batch

torch.set_num_threads(2)

FIVE_MODES = ["QPSK", "16-QAM", "BPSK-ACOUSTIC", "BPSK-NARROW", "64-QAM"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _windows(mode, n=3, size=64, noise=0.02, seed=5):
    rng = np.random.default_rng(seed)
    frames = framing.build_data_chunk_frames([rng.bytes(size) for _ in range(n)], 0, mode).numpy()
    frames = frames + noise * rng.standard_normal(frames.shape).astype(np.float32)
    sym = mode.profile.symbol_len
    signals, n_valid = batch.pad_signals(list(frames), pad_len=frames.shape[1] + 2 * sym)
    return signals, n_valid, (signals.shape[1] - 3 * sym) // sym


@pytest.mark.cuda
@pytest.mark.parametrize("name", FIVE_MODES)
def test_kernel_a_matches_plain(cuda_device, name):
    mode = MODES[name]
    signals, n_valid, max_syms = _windows(mode)
    args = [torch.from_numpy(a).to(cuda_device) for a in (signals, n_valid, np.zeros(len(n_valid), np.int32))]
    reset_launch_counts()
    out = receive.decode_fused(*args, mode, max_syms)
    ref = receive.decode_fused_reference(*args, mode, max_syms)
    assert launch_counts()["decode_fused"] == 1
    for key in ("start", "coarse", "coarse_metric", "detected"):
        assert torch.equal(out[key], ref[key]), key
    assert out["detected"].all()
    assert (out["fine_metric"] - ref["fine_metric"]).abs().max().item() < 1e-5
    for key in ("ch_re", "ch_im"):
        assert (out[key] - ref[key]).abs().max().item() < 1e-4
    sym = mode.profile.symbol_len
    bps_sym = out["bits"].shape[1] // max_syms
    for i, s in enumerate(out["start"].tolist()):
        nb = (int(n_valid[i]) - (s + 3 * sym)) // sym * bps_sym
        assert torch.equal(out["bits"][i, :nb], ref["bits"][i, :nb])


@pytest.mark.cuda
@pytest.mark.parametrize("name", FIVE_MODES)
def test_kernel_b_matches_plain(cuda_device, name):
    mode = MODES[name]
    p = mode.profile
    rng = np.random.default_rng(9)
    n_sym = framing.num_symbols_for_payload(40 + 11, mode)
    fr = framing.build_data_chunk_frames([rng.bytes(40) for _ in range(4)], 0, mode, device=cuda_device)
    fr = fr[:, p.silence_pre_chunk(False) :].contiguous()
    reset_launch_counts()
    out = receive.decode_chunks_fused(fr, mode, n_sym)
    assert launch_counts()["decode_chunks_fused"] == 1
    assert torch.equal(out, receive.decode_chunks_fused_reference(fr, mode, n_sym))


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(cuda_device):
    mode = MODES["QPSK"]
    sig = torch.zeros(2, 8192, device=cuda_device)
    nv = torch.full((2,), 8192, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        receive.decode_fused(sig, nv, torch.zeros(2, dtype=torch.int32, device=cuda_device), mode, 2)
    with pytest.raises(ValueError):
        receive.decode_chunks_fused(sig[:, ::2], mode, 2)
