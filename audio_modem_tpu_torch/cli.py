"""Command-line application: the framework's L5/L6 surface (counterpart of
audio_modem_tpu/cli.py).

WAV-file analogs of the reference UI actions (index.html:98-252):
  encode    file -> WAV signal (legacy or chunked, size-routed)
  decode    WAV -> file (full-signal decode; CRC-failed payloads are still
            written with a .corrupted suffix, like app.js:526-529)
  receive   WAV -> chunked streaming receive with bitmap/progress report
  diagnose  loopback analysis of a recorded test-signal WAV
  testsignal / sweep  generate diagnostic signals
  listen / play  live receive / paced transmit over PCM streams
  info      rate table for all modes (app.js:32-58 analog)
  bench     the throughput benchmark (``audio_modem_tpu_torch.bench``)

The compute device is the top-level option ``--torch-device`` (``cuda`` by
default, or ``cpu``), given before the subcommand. Without a CUDA device a
run that does not pass ``--torch-device cpu`` raises; nothing falls back to
the CPU.

    python -m audio_modem_tpu_torch.cli --torch-device cpu encode in.bin out.wav
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


def _add_mode(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mode", default="QPSK", help="QPSK | 16-QAM | 64-QAM | BPSK-ACOUSTIC | BPSK-REPEAT | BPSK-NARROW")
    p.add_argument("--fec", action="store_true", help="RS(255,223) forward error correction (extension)")


def cmd_encode(args) -> int:
    from audio_modem_tpu_torch import api
    from audio_modem_tpu_torch.utils.wav import write_wav

    data = Path(args.input).read_bytes()
    frames = api.encode(data, args.mode, Path(args.input).name, fec=args.fec, device=args.torch_device)
    signal = torch.cat(frames).cpu().numpy()  # the whole signal to the host in one copy
    write_wav(args.output, signal)
    print(f"encoded {len(data)} bytes -> {len(frames)} frame(s), "
          f"{len(signal)} samples ({len(signal)/44100:.2f}s) -> {args.output}")
    return 0


def cmd_decode(args) -> int:
    from audio_modem_tpu_torch import api, framing
    from audio_modem_tpu_torch.utils.wav import read_wav

    signal, rate = read_wav(args.input, max_seconds=args.max_duration)
    # waveform trimmer analog (app.js:1252-1306 / index.html:213-225):
    # slice the recording to [trim_start, trim_end] seconds before decoding
    if args.trim_start or args.trim_end is not None:
        lo = int(max(args.trim_start, 0.0) * rate)
        hi = int(args.trim_end * rate) if args.trim_end is not None else len(signal)
        if hi <= lo:
            print("error: empty trim range", file=sys.stderr)
            return 1
        signal = signal[lo:hi]
    result, info = api.decode(signal, args.mode, device=args.torch_device)
    if isinstance(result, framing.FrameError):
        print(f"error: {result.error}", file=sys.stderr)
        return 1
    name = getattr(result, "file_name", "decoded.bin") or "decoded.bin"
    out = Path(args.output or name)
    if isinstance(result, framing.LegacyFrame):
        if not result.crc_valid:
            out = out.with_suffix(out.suffix + ".corrupted")
        out.write_bytes(result.data)
        print(f"decoded {len(result.data)} bytes -> {out} "
              f"(crc {'OK' if result.crc_valid else 'FAILED'}, "
              f"preamble@{info.preamble_idx}, corr {info.fine_metric:.3f})")
    else:
        print(f"decoded non-legacy frame: {result}")
    return 0


def cmd_receive(args) -> int:
    from audio_modem_tpu_torch import api, framing
    from audio_modem_tpu_torch.utils.wav import read_wav

    signal, _ = read_wav(args.input, max_seconds=args.max_duration)
    res = api.decode_chunked(signal, args.mode, fec=args.fec, device=args.torch_device)
    if isinstance(res, framing.FrameError):
        print(f"error: {res.error}", file=sys.stderr)
        return 1
    out = Path(args.output or res.file_name or "received.bin")
    out.write_bytes(res.data)
    status = "complete" if res.complete else f"PARTIAL, missing {res.missing_chunks}"
    print(f"received {res.received_chunks}/{res.total_chunks} chunks "
          f"({res.crc_errors} CRC errors) -> {out} [{status}]")
    return 0 if res.complete else 2


def _parse_channel_spec(text: str):
    """Mini-language for --channel: comma-separated key=value pairs.
    snr=DB, ppm=PPM, gain=G, dc=OFFSET, echo=DELAY:AMP (repeatable),
    drop=START:LEN (repeatable)."""
    from audio_modem_tpu_torch.channel import ChannelSpec

    kw: dict = {"multipath": [], "dropout": []}
    for part in text.split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        if k == "snr":
            kw["snr_db"] = float(v)
        elif k == "ppm":
            kw["clock_ppm"] = float(v)
        elif k == "gain":
            kw["gain"] = float(v)
        elif k == "dc":
            kw["dc_offset"] = float(v)
        elif k == "echo":
            d, _, a = v.partition(":")
            kw["multipath"].append((int(d), float(a)))
        elif k == "drop":
            s, _, n = v.partition(":")
            kw["dropout"].append((int(s), int(n)))
        else:
            raise SystemExit(f"unknown channel key: {k!r}")
    kw["multipath"] = tuple(kw["multipath"])
    kw["dropout"] = tuple(kw["dropout"])
    return ChannelSpec(**kw)


def cmd_diagnose(args) -> int:
    from audio_modem_tpu_torch import diag
    from audio_modem_tpu_torch.configs import get_mode
    from audio_modem_tpu_torch.utils.wav import read_wav

    if args.live:
        channel_fn = None
        if args.channel:
            from audio_modem_tpu_torch.channel import apply_channel_np

            spec = _parse_channel_spec(args.channel)
            channel_fn = lambda s: apply_channel_np(s, spec, device=args.torch_device)  # noqa: E731

        def level_line(meter, n):
            bar = "#" * min(int(meter.rms * 40), 20)
            clip = " CLIP" if meter.clipping else ""
            print(f"\r[diagnose] {n / 44100:6.1f}s | level [{bar:<20}]{clip}",
                  end="", file=sys.stderr, flush=True)

        d = diag.live_loopback_diagnosis(
            get_mode(args.mode), channel_fn, speed=args.speed,
            on_level=level_line, device=args.torch_device,
        )
        print("", file=sys.stderr)
        report = d.loopback
        print(json.dumps({
            "detected": report.detected,
            "correlation": round(report.correlation, 4),
            "ber": round(report.ber, 6),
            "snr_db": round(report.snr_estimate_db, 2),
            "quality": report.quality,
            "recommended_mode": report.recommended_mode,
            "input": {
                "rms": round(d.input.rms, 4),
                "peak": round(d.input.peak, 4),
                "noise_floor": round(d.input.noise_floor, 6),
                "clipping": d.input.clipping,
            },
            "samples_recorded": d.samples_recorded,
        }))
        return 0 if report.detected else 2
    if not args.input:
        raise SystemExit("diagnose: input WAV required (or use --live)")
    signal, _ = read_wav(args.input)
    report = diag.analyze_loopback(signal, get_mode(args.mode), device=args.torch_device)
    print(json.dumps({
        "detected": report.detected,
        "correlation": round(report.correlation, 4),
        "ber": round(report.ber, 6),
        "snr_db": round(report.snr_estimate_db, 2),
        "quality": report.quality,
        "recommended_mode": report.recommended_mode,
    }))
    return 0


def cmd_testsignal(args) -> int:
    from audio_modem_tpu_torch import diag
    from audio_modem_tpu_torch.configs import get_mode
    from audio_modem_tpu_torch.utils.wav import write_wav

    signal, _ = diag.generate_test_signal(get_mode(args.mode), device=args.torch_device)
    write_wav(args.output, signal.cpu().numpy())
    print(f"test signal ({args.mode}) -> {args.output}")
    return 0


def cmd_sweep(args) -> int:
    from audio_modem_tpu_torch import diag
    from audio_modem_tpu_torch.utils.wav import write_wav

    write_wav(args.output, diag.generate_sweep_tone())
    print(f"sweep tone -> {args.output}")
    return 0


def cmd_listen(args) -> int:
    """Live receive from a PCM byte stream (pipe/socket/stdin) — the
    getUserMedia streaming-receive analog (app.js:1059-1161)."""
    from audio_modem_tpu_torch import framing
    from audio_modem_tpu_torch.runtime.ingest import listen

    if args.device is not None:
        # real microphone capture (getUserMedia analog, app.js:349-417):
        # sounddevice/ALSA/path backend presenting the same binary stream
        from audio_modem_tpu_torch.runtime import audiodev

        stream = audiodev.open_capture(args.device, block=args.block)
        args.pcm = "f32"  # device backends are float32 end to end
    else:
        stream = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")

    def stats_line(stats, samples, meter):
        bar = "#" * min(int(meter.rms * 40), 20)
        clip = " CLIP" if meter.clipping else ""
        print(
            f"\r[listen] {samples/44100:8.1f}s audio | level [{bar:<20}]{clip} "
            f"| frames {stats.frames_decoded} "
            f"| chunks {stats.chunks_received}/{stats.total_chunks or '?'} "
            f"| errors {stats.frame_errors + stats.crc_errors}",
            end="",
            file=sys.stderr,
            flush=True,
        )

    try:
        report = listen(
            stream,
            args.mode,
            block=args.block,
            fmt=args.pcm,
            persist_path=args.state,
            resume=args.resume,
            fec=args.fec,
            on_stats=stats_line,
            device=args.torch_device,
        )
    finally:
        if stream is not sys.stdin.buffer:
            stream.close()
            proc = getattr(stream, "_amt_proc", None)
            if proc is not None:  # ALSA subprocess backend
                proc.terminate()
    print("", file=sys.stderr)
    res = report.result
    if isinstance(res, framing.FrameError):
        print(f"error: {res.error}", file=sys.stderr)
        return 1
    out = Path(args.output or res.file_name or "received.bin")
    out.write_bytes(res.data)
    status = "complete" if res.complete else f"PARTIAL, missing {res.missing_chunks}"
    print(
        f"received {res.received_chunks}/{res.total_chunks} chunks "
        f"({res.crc_errors} CRC errors, {report.realtime_factor:.1f}x realtime) "
        f"-> {out} [{status}]"
    )
    return 0 if res.complete else 2


def cmd_play(args) -> int:
    """Paced transmit: file -> raw PCM on stdout (or a pipe/file) at the
    audio rate — the AudioContext playback analog (app.js:305-316)."""
    from audio_modem_tpu_torch.runtime.ingest import play

    data = Path(args.input).read_bytes()
    if args.device is not None:
        # real speaker playback (AudioContext analog, app.js:305-316): the
        # device clocks the samples itself, so host pacing is disabled
        from audio_modem_tpu_torch.runtime import audiodev

        stream = audiodev.open_playback(args.device)
        args.pcm = "f32"  # device backends are float32 end to end
        speed = 0.0
    else:
        stream = sys.stdout.buffer if args.output == "-" else open(args.output, "wb")
        speed = 0.0 if args.no_pace else args.speed

    def on_frame(seq, total):
        print(f"\r[play] frame {seq + 1}/{total}", end="", file=sys.stderr, flush=True)

    try:
        written = play(
            data,
            stream,
            args.mode,
            Path(args.input).name,
            fmt=args.pcm,
            speed=speed,
            fec=args.fec,
            chunked=not args.legacy,
            on_frame=on_frame,
            device=args.torch_device,
        )
    finally:
        if stream is not sys.stdout.buffer:
            stream.close()
            proc = getattr(stream, "_amt_proc", None)
            if proc is not None:  # ALSA subprocess backend: let aplay drain
                proc.wait(timeout=30)
    print(f"\nplayed {written} samples ({written/44100:.2f}s)", file=sys.stderr)
    return 0


def cmd_info(args) -> int:
    from audio_modem_tpu_torch.configs import MODES

    print(f"{'mode':<15}{'profile':<12}{'const':<7}{'rep':<4}{'chunk':<7}{'raw rate':<12}")
    for m in MODES.values():
        p = m.profile
        raw = p.num_data_subs * m.bps * p.sample_rate / p.symbol_len / m.repetition
        print(f"{m.name:<15}{m.profile_name:<12}{m.constellation:<7}{m.repetition:<4}"
              f"{m.chunk_size:<7}{raw/8:,.0f} B/s")
    return 0


def cmd_bench(args) -> int:
    from audio_modem_tpu_torch import bench

    return bench.main(device=args.torch_device)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="audio-modem-tpu-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--torch-device", choices=("cuda", "cpu"), default="cuda",
                    help="where the modem computes (default cuda; raises without a CUDA device)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("encode", help="file -> modem WAV")
    p.add_argument("input"); p.add_argument("output"); _add_mode(p)
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser("decode", help="WAV -> file (single frame)")
    p.add_argument("input"); p.add_argument("-o", "--output"); _add_mode(p)
    p.add_argument("--trim-start", type=float, default=0.0, metavar="SEC",
                   help="discard audio before SEC (trimmer analog)")
    p.add_argument("--trim-end", type=float, default=None, metavar="SEC",
                   help="discard audio after SEC")
    p.add_argument("--max-duration", type=float, default=None, metavar="SEC",
                   help="read at most SEC seconds of audio (RAM budget; "
                        "reference max-duration selector, index.html:140-144)")
    p.set_defaults(fn=cmd_decode)

    p = sub.add_parser("receive", help="WAV -> file (chunked streaming)")
    p.add_argument("input"); p.add_argument("-o", "--output"); _add_mode(p)
    p.add_argument("--max-duration", type=float, default=None, metavar="SEC",
                   help="read at most SEC seconds of audio (RAM budget)")
    p.set_defaults(fn=cmd_receive)

    p = sub.add_parser("diagnose", help="analyze a recorded loopback WAV, "
                       "or run the live duplex pre-test (--live)")
    p.add_argument("input", nargs="?",
                   help="recorded WAV (omit with --live)"); _add_mode(p)
    p.add_argument("--live", action="store_true",
                   help="duplex pre-test: play the test signal while "
                        "recording the return path (reference live loopback)")
    p.add_argument("--channel", default=None, metavar="SPEC",
                   help="injectable channel for --live, e.g. "
                        "'snr=20,ppm=100,gain=0.5,dc=0.01,echo=50:0.3,"
                        "drop=1000:500'")
    p.add_argument("--speed", type=float, default=0.0,
                   help="--live pacing multiple of real time (0 = unpaced)")
    p.set_defaults(fn=cmd_diagnose)

    p = sub.add_parser("testsignal", help="generate the known test signal")
    p.add_argument("output"); _add_mode(p)
    p.set_defaults(fn=cmd_testsignal)

    p = sub.add_parser("sweep", help="generate a frequency sweep tone")
    p.add_argument("output")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("listen", help="live receive from a PCM stream (pipe/stdin) or microphone")
    p.add_argument("input", nargs="?", default="-", help="PCM source path, or - for stdin")
    p.add_argument("-o", "--output"); _add_mode(p)
    p.add_argument("--pcm", choices=("f32", "s16"), default="f32")
    p.add_argument("--block", type=int, default=4096)
    p.add_argument("--state", help="sqlite path for crash-resumable chunk store")
    p.add_argument("--resume", action="store_true", help="resume from --state")
    p.add_argument("--device", help="capture from an audio device instead of a "
                   "stream: 'auto', 'sd:<name>', 'alsa:<dev>', or a FIFO/device path")
    p.set_defaults(fn=cmd_listen)

    p = sub.add_parser("play", help="paced transmit: file -> PCM stream at audio rate, or speaker")
    p.add_argument("input")
    p.add_argument("output", nargs="?", default="-", help="PCM sink path, or - for stdout")
    _add_mode(p)
    p.add_argument("--pcm", choices=("f32", "s16"), default="f32")
    p.add_argument("--speed", type=float, default=1.0, help="pacing multiple of real time")
    p.add_argument("--no-pace", action="store_true", help="write at full throughput")
    p.add_argument("--device", help="play to an audio device instead of a stream: "
                   "'auto', 'sd:<name>', 'alsa:<dev>', or a FIFO/device path")
    p.add_argument("--legacy", action="store_true",
                   help="size-routed framing (small files -> one legacy frame; "
                        "not decodable by listen)")
    p.set_defaults(fn=cmd_play)

    p = sub.add_parser("info", help="mode/rate table")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("bench", help="throughput benchmark")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    if args.torch_device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --torch-device cpu to run the modem on the CPU")
    args.torch_device = torch.device(args.torch_device)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
