"""Diagnostics: sweep/test signals, loopback analysis, input analysis
(counterpart of audio_modem_tpu/diag.py).

Re-implements the reference's pre-test suite (modem.js:886-1082,
app.js:1312-1627): output sweep tone, known OFDM test signal, loopback
analyzer (sync metric, per-subcarrier |H|, SNR estimate, BER vs known
payload, quality verdict + recommended mode), and input-recording analysis
(RMS / peak / noise floor / spectrum).

The signal work (test-signal synthesis, the loopback analyzer's sync,
channel estimate and demod, the BER curves) runs on ``device``, ``"cuda"``
unless the caller names the CPU; the tone, the input analysis and the
verdicts are numpy on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from audio_modem_tpu_torch import decoder, framing, phy, sync
from audio_modem_tpu_torch.configs import SAMPLE_RATE, ModemMode
from audio_modem_tpu_torch.kernels import read_pair, resolve_device, upload
from audio_modem_tpu_torch.ops.bits import bits_to_bytes, majority_vote, soft_combine


def generate_sweep_tone(
    start_freq: float = 200.0,
    end_freq: float = 12000.0,
    duration: float = 2.0,
    sample_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """Linear chirp with 50 ms fade-in/out at 0.8 amplitude
    (modem.js:890-912)."""
    n = round(duration * sample_rate)
    t = np.arange(n, dtype=np.float64) / sample_rate
    phase = 2 * np.pi * (start_freq * t + (end_freq - start_freq) * t * t / (2 * duration))
    sig = 0.8 * np.sin(phase)
    fade = round(0.05 * sample_rate)
    env = np.ones(n)
    env[:fade] = np.arange(fade) / fade
    env[n - fade :] = np.minimum(env[n - fade :], (n - np.arange(n - fade, n)) / fade)
    return (sig * env).astype(np.float32)


TEST_PAYLOAD = bytes(range(16))  # modem.js:915-917
TEST_FILENAME = "test"


def generate_test_signal(mode: ModemMode, device="cuda") -> tuple[torch.Tensor, bytes]:
    """Known-payload legacy frame for loopback testing (modem.js:914-973),
    synthesized on ``device``."""
    return framing.build_transmit_signal(TEST_PAYLOAD, mode, TEST_FILENAME, device=device), TEST_PAYLOAD


@dataclasses.dataclass
class LoopbackReport:
    """analyzeLoopback result (modem.js:975-1082)."""

    detected: bool
    correlation: float
    ber: float
    channel_magnitude: np.ndarray
    snr_estimate_db: float
    quality: str  # excellent | good | poor
    evm: float | None = None  # RMS error-vector magnitude (extension metric)

    @property
    def recommended_mode(self) -> str:
        """Modulation recommendation (app.js:1598-1605)."""
        if self.quality == "excellent":
            return "16-QAM"
        if self.quality == "good":
            return "QPSK"
        return "BPSK-REPEAT"


def analyze_loopback(
    recorded: "np.ndarray | torch.Tensor", mode: ModemMode, test_data: bytes = TEST_PAYLOAD, device="cuda"
) -> LoopbackReport:
    """Loopback quality analysis (modem.js:975-1082): sync -> channel -> SNR
    -> BER vs known payload -> verdict. The recording is padded and
    preprocessed on ``device``, and every slice of it is cut there; only
    scalars, |H| and the demodulated bits come back."""
    p = mode.profile
    sym = p.symbol_len
    sig = upload(recorded, device)
    n_valid = sig.shape[0]
    dev = sig.device
    nv = torch.tensor([n_valid], dtype=torch.int32, device=dev)
    pre = sync.preprocess(decoder.pad_to_bucket(sig)[None], nv)

    coarse = int(sync.detect_preamble(pre, p, nv)[0][0])
    if coarse < 0:
        # fall back to cross-correlation, like modem.js:980-984
        coarse = int(sync.detect_preamble_xcorr(pre, p, nv)[0][0])
    if coarse < 0:
        return LoopbackReport(False, 0.0, 1.0, np.zeros(0), 0.0, "poor")

    start_t, metric_t = sync.refine_xcorr(pre, torch.tensor([coarse], device=dev), p, nv)
    start, metric = read_pair("refine", start_t[0], metric_t[0])
    correlation = max(0.0, metric)

    ce_start = start + 2 * sym
    if ce_start + sym > n_valid:
        return LoopbackReport(True, correlation, 1.0, np.zeros(0), 0.0, "poor")

    pre = pre[0]
    ch_re, ch_im = phy.estimate_channel(pre[ce_start : ce_start + sym], p)
    ch_mag = phy.channel_magnitude(ch_re, ch_im).cpu().numpy()

    # SNR from pilot |H| (modem.js:1032-1043)
    pilot_pos = np.nonzero(p.pilot_mask_active)[0]
    pilot_mag = ch_mag[pilot_pos]
    usable = pilot_mag > 1e-6
    avg = float(pilot_mag[usable].mean()) if usable.any() else 0.0
    snr_db = 20 * np.log10(avg) if avg > 0 else -np.inf

    # BER against the known packet layout (modem.js:1046-1069)
    data_start = ce_start + sym
    ber = 1.0
    evm = None
    if data_start < n_valid:
        n_sym = (n_valid - data_start) // sym
        if n_sym > 0:
            data = pre[data_start : data_start + n_sym * sym].reshape(n_sym, sym)
            # EVM over the known payload's symbols only (trailing symbols are
            # silence/junk the length fields cut off)
            payload_bytes = 1 + len(TEST_FILENAME) + 4 + len(test_data) + 4
            n_used = min(n_sym, framing.num_symbols_for_payload(payload_bytes, mode))
            if n_used > 0:
                evm = float(phy.error_vector_magnitude(data[:n_used], ch_re, ch_im, mode))
            bits = phy.demodulate(data, ch_re, ch_im, mode)
            if mode.repetition > 1:
                bits = majority_vote(bits, mode.repetition)
            by = bits_to_bytes(bits).cpu().numpy().tobytes()
            if len(by) >= 1 + len(TEST_FILENAME) + 4 + len(test_data) + 4:
                name_len = by[0]
                off = 1 + name_len + 4
                if off + len(test_data) <= len(by):
                    err = 0
                    for i, tb in enumerate(test_data):
                        err += bin(by[off + i] ^ tb).count("1")
                    ber = err / (len(test_data) * 8)

    if ber == 0 and correlation > 0.8:
        quality = "excellent"
    elif ber < 0.05:
        quality = "good"
    else:
        quality = "poor"
    return LoopbackReport(True, correlation, ber, ch_mag, float(snr_db), quality, evm)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def ber_vs_snr(
    mode: ModemMode,
    snrs_db: tuple[float, ...] = (0.0, 5.0, 10.0, 15.0, 20.0, 25.0, 30.0),
    n_streams: int = 16,
    n_sym: int = 8,
    seed: int = 0,
    device="cuda",
) -> dict[float, float]:
    """BER-vs-SNR curve via the batched loopback step — one batched device
    computation per SNR point over a stream batch, its noise drawn from a
    ``torch.Generator`` seeded ``seed + i`` for point i. The reference has
    no channel sweep capability at all (SURVEY §5 fault injection: none)."""
    from audio_modem_tpu_torch.parallel.batch import batch_loopback_step

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n_streams, n_sym * mode.bits_per_symbol), dtype=np.int8)
    bits_d = torch.from_numpy(bits).to(dev)
    out = {}
    for i, snr in enumerate(snrs_db):
        ber, _ = batch_loopback_step(bits_d, _generator(dev, seed + i), mode, n_sym, float(snr))
        out[float(snr)] = float(ber)
    return out


def repetition_ber_vs_snr(
    mode: ModemMode,
    snrs_db: tuple[float, ...] = (-4.0, -2.0, 0.0, 2.0),
    n_streams: int = 16,
    n_sym: int = 12,
    seed: int = 0,
    device="cuda",
) -> dict[float, tuple[float, float]]:
    """Decoded-bit BER of a repetition mode, hard vote vs soft combining.

    For each SNR point, runs the AWGN loopback (modulate repeated bits ->
    CE symbol -> AWGN -> channel estimate -> demod) on ``device`` and
    decodes the repetition code BOTH ways: the reference's hard-bit
    majority vote (modem.js:487-495) and maximum-ratio combining of the
    matched-filter soft metrics (phy.demodulate_soft_bpsk +
    ops.bits.soft_combine). Returns {snr_db: (hard_ber, soft_ber)} — the
    measured gap is the soft retry's sensitivity gain over the reference."""
    from audio_modem_tpu_torch.channel import awgn
    from audio_modem_tpu_torch.tables import profile_tables

    assert mode.repetition > 1 and mode.constellation == "BPSK"
    dev = resolve_device(device)
    p = mode.profile
    rep = mode.repetition
    rng = np.random.default_rng(seed)
    n_wire = n_sym * mode.bits_per_symbol
    n_dec = n_wire // rep
    dec_bits = rng.integers(0, 2, (n_streams, n_dec), dtype=np.int8)
    wire = np.repeat(dec_bits, rep, axis=-1)
    wire = np.pad(wire, ((0, 0), (0, n_wire - wire.shape[1])))
    wire_d = torch.from_numpy(wire).to(dev)
    dec_d = torch.from_numpy(dec_bits).to(dev)
    ce = profile_tables(p, dev).header[2 * p.symbol_len :].expand(n_streams, p.symbol_len)
    out: dict[float, tuple[float, float]] = {}
    for i, snr in enumerate(snrs_db):
        syms = phy.modulate(wire_d, mode)
        sig = syms.reshape(syms.shape[0], -1)
        rx = awgn(torch.cat([ce, sig], dim=-1), float(snr), _generator(dev, seed + i))
        ch_re, ch_im = phy.estimate_channel(rx[:, : p.symbol_len], p)
        data = rx[:, p.symbol_len :].reshape(-1, n_sym, p.symbol_len)
        hard_dec = majority_vote(phy.demodulate(data, ch_re, ch_im, mode), rep)
        soft_dec = soft_combine(phy.demodulate_soft_bpsk(data, ch_re, ch_im, mode), rep)
        m = hard_dec.shape[1]
        ref = dec_d[:, :m]
        errs = torch.stack([(hard_dec != ref).sum(), (soft_dec != ref).sum()]).tolist()
        out[float(snr)] = (errs[0] / ref.numel(), errs[1] / ref.numel())
    return out


def render_chunk_bitmap(bitmap: np.ndarray, width: int = 64) -> str:
    """Text rendering of the received-chunk bitmap (app.js:1025-1053 analog):
    one cell per chunk group, '#' complete / '+' partial / '.' missing."""
    n = len(bitmap)
    if n == 0:
        return ""
    cells = min(width, n)
    lines = []
    edges = np.linspace(0, n, cells + 1).astype(int)
    row = []
    for i in range(cells):
        seg = bitmap[edges[i] : max(edges[i + 1], edges[i] + 1)]
        frac = seg.mean()
        row.append("#" if frac == 1.0 else ("+" if frac > 0 else "."))
    lines.append("".join(row))
    return "\n".join(lines)


@dataclasses.dataclass
class RateInfo:
    """Live rate/max-size estimate (updateModulationInfo, app.js:32-58)."""

    mode: str
    raw_bits_per_sec: float
    effective_bytes_per_sec: float
    max_bytes: int
    max_duration_sec: float


def rate_info(mode: ModemMode, max_duration_sec: float = 120.0) -> RateInfo:
    """Reference formula app.js:38-53: symbol rate x bits/symbol, minus
    sync/CE overhead and repetition, minus the ~15B header."""
    p = mode.profile
    sym_duration = p.symbol_len / p.sample_rate
    raw = mode.bits_per_symbol / sym_duration
    overhead = (1.0 if p.is_acoustic else 0.5) + 3 * sym_duration
    avail = max_duration_sec - overhead
    max_symbols = int(avail / sym_duration)
    max_bits = max_symbols * mode.bits_per_symbol
    max_bytes = max_bits // 8 // mode.repetition - 15
    speed = max_bytes / avail if avail > 0 else 0.0
    return RateInfo(mode.name, raw, speed, int(max_bytes), max_duration_sec)


@dataclasses.dataclass
class InputReport:
    """Input-recording analysis (app.js:1404-1484)."""

    rms: float
    peak: float
    noise_floor: float
    clipping: bool
    spectrum_db: np.ndarray  # 1024-bin dB spectrum
    freqs: np.ndarray


def analyze_input(recording: np.ndarray, sample_rate: int = SAMPLE_RATE) -> InputReport:
    x = np.asarray(recording, dtype=np.float64)
    rms = float(np.sqrt(np.mean(x**2)))
    peak = float(np.abs(x).max()) if len(x) else 0.0
    # noise floor = mean RMS of the quietest 10% of 2048-sample blocks
    # (app.js:1444-1459)
    nblk = len(x) // 2048
    if nblk > 0:
        blocks = x[: nblk * 2048].reshape(nblk, 2048)
        block_rms = np.sqrt((blocks**2).mean(axis=1))
        k = max(1, nblk // 10)
        noise_floor = float(np.sort(block_rms)[:k].mean())
    else:
        noise_floor = rms
    n_fft = 2048
    seg = x[:n_fft] if len(x) >= n_fft else np.pad(x, (0, n_fft - len(x)))
    spec = np.abs(np.fft.rfft(seg * np.hanning(n_fft)))[: n_fft // 2]
    spec_db = 20 * np.log10(spec + 1e-12)
    freqs = np.fft.rfftfreq(n_fft, 1 / sample_rate)[: n_fft // 2]
    return InputReport(rms, peak, noise_floor, rms > 0.9, spec_db, freqs)


@dataclasses.dataclass
class LiveDiagnosis:
    """Result of the duplex live pre-test (play + record simultaneously)."""

    loopback: LoopbackReport
    input: InputReport
    samples_played: int
    samples_recorded: int


def live_loopback_diagnosis(
    mode: ModemMode,
    channel_fn=None,
    speed: float = 0.0,
    block: int = 4096,
    on_level=None,
    device="cuda",
) -> LiveDiagnosis:
    """Duplex live pre-test: PLAY the known test signal while RECORDING the
    return path, then analyze the recording — the reference's live loopback
    pre-test (app.js:1509-1618 plays via AudioContext while getUserMedia
    records). Here the 'air' is an OS pipe pair: a writer thread paces the
    test signal (optionally through ``channel_fn``, the injectable channel —
    e.g. channel.apply_channel_np with a ChannelSpec; it takes and returns
    host float32 audio) into the pipe at the audio rate while this thread
    records block-by-block with a level meter. The test signal is
    synthesized and the recording analyzed on ``device``; the channel runs
    before the writer starts, so the writer thread moves host bytes only.

    ``speed``: pacing factor for the writer (0 = as fast as the pipe
    drains — what tests use; 1.0 = real time). ``on_level``: optional
    callback(LevelMeter, samples_recorded) per block for a live UI line.
    """
    import os as _os
    import threading

    from audio_modem_tpu_torch.runtime.ingest import LevelMeter, PacedWriter, read_pcm_blocks

    signal, _ = generate_test_signal(mode, device=device)
    tx = signal.cpu().numpy()
    if channel_fn is not None:
        tx = np.asarray(channel_fn(tx), np.float32)

    r_fd, w_fd = _os.pipe()

    def writer() -> None:
        with _os.fdopen(w_fd, "wb") as w:
            PacedWriter(w, fmt="f32", speed=speed).write(tx, block=block)

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    meter = LevelMeter()
    chunks: list[np.ndarray] = []
    n_rec = 0
    with _os.fdopen(r_fd, "rb") as r:
        for blk in read_pcm_blocks(r, block=block, fmt="f32"):
            meter.update(blk)
            chunks.append(blk)
            n_rec += len(blk)
            if on_level is not None:
                on_level(meter, n_rec)
    t.join()
    recorded = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    return LiveDiagnosis(
        loopback=analyze_loopback(recorded, mode, device=device),
        input=analyze_input(recorded),
        samples_played=len(tx),
        samples_recorded=n_rec,
    )
