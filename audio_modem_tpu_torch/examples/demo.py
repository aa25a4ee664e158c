"""End-to-end demo of the port (counterpart of examples/demo.py): file ->
modem WAV -> noisy acoustic channel -> receive -> verification and
diagnostic plots.

    python -m audio_modem_tpu_torch.examples.demo [--mode 16-QAM] [--fec] [--snr 18] [--torch-device cuda]

Writes demo_out/ in the working directory: the TX WAV, the channel-degraded
RX WAV, the recovered file, and spectrum / channel / waveform / BER plots
(the plots need matplotlib; without it they are left out, and the demo says
so).
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

from audio_modem_tpu_torch import api, channel, diag, framing
from audio_modem_tpu_torch.configs import get_mode
from audio_modem_tpu_torch.kernels import resolve_device
from audio_modem_tpu_torch.utils import plots
from audio_modem_tpu_torch.utils.wav import read_wav, write_wav


def main(argv=None) -> bool:
    """Run the demo; returns whether the received payload matches."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="QPSK")
    ap.add_argument("--fec", action="store_true")
    ap.add_argument("--snr", type=float, default=20.0)
    ap.add_argument("--size", type=int, default=6000, help="payload bytes")
    ap.add_argument("--torch-device", default="cuda", help="compute device (cuda, cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.torch_device)

    out = pathlib.Path("demo_out")
    out.mkdir(exist_ok=True)
    mode = get_mode(args.mode)
    payload = np.random.default_rng(0).bytes(args.size)
    (out / "original.bin").write_bytes(payload)

    # --- transmit ---
    frames = [f.cpu().numpy() for f in api.encode(payload, mode, "demo.bin", fec=args.fec, device=dev)]
    tx = np.concatenate(frames)
    write_wav(str(out / "tx.wav"), tx)
    print(f"TX: {len(payload)} B -> {len(frames)} frame(s), {len(tx) / 44100:.2f}s of audio")

    # --- acoustic channel ---
    spec = channel.ChannelSpec(snr_db=args.snr, multipath=((17, 0.2), (43, 0.08)), gain=0.6, dc_offset=0.004)
    write_wav(str(out / "rx.wav"), channel.apply_channel_np(tx, spec, seed=1, device=dev))
    print(f"channel: AWGN {args.snr} dB + 2-tap multipath + gain 0.6 + DC")

    # --- receive ---
    signal, _ = read_wav(str(out / "rx.wav"))
    channel_mag = None
    if len(frames) == 1:
        result, info = api.decode(signal, mode, device=dev)
        ok = not isinstance(result, framing.FrameError) and result.crc_valid
        data = b"" if isinstance(result, framing.FrameError) else result.data
        channel_mag = info.channel_mag if info is not None else None
        extra = f", FEC corrected {result.fec_corrected} B" if ok and result.fec_corrected else ""
        print(f"RX (legacy): crc={'OK' if ok else 'FAIL'}{extra}")
    else:
        res = api.decode_chunked(signal, mode, fec=args.fec, device=dev)
        data = b"" if isinstance(res, framing.FrameError) else res.data
        print(f"RX (chunked): {getattr(res, 'received_chunks', 0)}/{getattr(res, 'total_chunks', 0)} chunks")
    (out / "received.bin").write_bytes(data)
    match = data == payload
    print("payload match:", match)

    # --- diagnostics ---
    rep = diag.analyze_input(signal)
    curve = diag.ber_vs_snr(mode, snrs_db=(0.0, 5.0, 10.0, 15.0, 20.0, 25.0), n_streams=8, n_sym=4, device=dev)
    print("BER vs SNR:", ", ".join(f"{snr:g} dB {ber:.4f}" for snr, ber in curve.items()))
    try:
        if channel_mag is not None:
            plots.plot_channel_response(channel_mag, mode.profile, str(out / "channel.png"))
        plots.plot_spectrum(rep.spectrum_db, rep.freqs, str(out / "spectrum.png"), mode.profile)
        plots.plot_waveform(signal[: 44100 * 2], str(out / "waveform.png"))
        plots.plot_ber_curve(curve, str(out / "ber.png"), f"BER vs SNR — {mode.name}")
        print("plots in", out)
    except ImportError:
        print("plots left out: matplotlib is not installed")
    return match


if __name__ == "__main__":
    raise SystemExit(0 if main() else 1)
