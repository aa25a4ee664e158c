"""The benchmark's plain reference of the chunked receiver: one whole
recording of a chunked transfer received with the streaming receiver's
semantics (app.js:706-998), in float64, on top of ``oracle``.

The recording arrives in blocks of ``BLOCK`` samples; after each block the
receive state machine runs until it waits for more samples:

  DC removal   the EMA tracker (app.js:750-755), dc = a dc + (1 - a) x and
               x - dc, in float64 in closed form per block;
  scan         the Schmidl-Cox metric P^2 / (Ra Rb) over fft/2 halves at
               every ``STRIDE``-th position from the scan position, in
               windows of at most ``SCAN_BUCKET - fft`` positions that end
               at the last position the samples written so far cover, with
               the stream's energy gate (``MIN_ENERGY``, app.js:796) and the
               first-peak commit (app.js:829-839);
  refine       the normalized cross-correlation with preamble 1 over +-3 CP
               around the committed position (as ``oracle.refine``); below 0.1
               it is a false peak and the scan resumes half a symbol past
               the coarse position (app.js:879-884);
  frame        once the frame's worst-case length is written (280 payload
               bytes before the metadata frame, the chunk size and 11
               after: app.js:888-896), the frame is cut at its start,
               divided by its peak (app.js:918-925), and its CE, demodulation
               and parse follow (as ``oracle.channel``, ``oracle.demodulate``,
               the parse of modem.js:795-849); the scan resumes at the frame's actual length
               where its CRC holds, four symbols past its start after a
               parse error, else at its worst-case end;
  assembly     the metadata frame opens the file, each CRC-valid data
               chunk is stored by its sequence number (app.js:597-704).

Departures from app.js and modem.js, each the receiver's own
(``audio_modem_tpu_torch/runtime/receiver.py``): the scan evaluates
stride-aligned positions in windows (app.js scans every sample as it
arrives), so where a window ends decides what the first-peak commit sees;
the scan resumes at the frame's actual length, not its worst-case estimate;
a parse error skips four symbols. Left out: the receiver's ring (the whole
recording is held; no read of this deployment reaches further back than
the ring holds), its retry ladder (soft combining, FEC erasures, timing
tracking; a frame that needs a retry differs from the reference's), and
FEC frames.

``Precision`` (``oracle``) says how samples, templates and spectra are
stored: the reference keeps float32 samples after the DC removal and after
the frame's normalization, everything else float64; the control stores them
in bfloat16. It imports nothing of the program under test.
"""

from __future__ import annotations

import dataclasses
import math
import zlib

import numpy as np
import torch

from benchmark.reference import oracle
from benchmark.reference.oracle import F64, REFERENCE, Precision
from benchmark.reference.profiles import FRAME_DATA, FRAME_META, MODES, Mode

BLOCK = 4096  # samples a call of the receiver takes (api.decode_chunked)
DC_ALPHA = 0.999
SCAN_BUCKET = 8192
STRIDE = 16
MIN_ENERGY = 0.001
PRE_META_MAX_PAYLOAD = 280
AUTOCORR_THRESHOLD = 0.5
XCORR_THRESHOLD = 0.1


@dataclasses.dataclass
class Frame:
    """One frame the receiver cut: its refined start (global sample), the
    refine's metric (nan where the end of the recording came before the
    refine), |H| of its CE on the active bins (None where the frame was too
    short for one) and its kind (meta, data, legacy or error)."""

    start: int
    fine: float
    mag: np.ndarray | None
    kind: str


@dataclasses.dataclass
class Received:
    frames: list[Frame]
    file_name: str | None = None
    total_chunks: int = 0
    file_size: int = 0
    chunk_size: int = 0
    chunks: dict[int, bytes] = dataclasses.field(default_factory=dict)
    crc_errors: int = 0
    false_peaks: int = 0
    scan_windows: int = 0

    def file(self) -> bytes:
        """The assembled file; missing chunks read as zeros (app.js:667-687)."""
        out = bytearray(self.file_size)
        for seq, data in sorted(self.chunks.items()):
            out[seq * self.chunk_size : seq * self.chunk_size + len(data)] = data
        return bytes(out[: self.file_size])

    @property
    def missing(self) -> list[int]:
        return [i for i in range(self.total_chunks) if i not in self.chunks]


def frame_samples(payload_bytes: int, mode: Mode) -> int:
    """(3 header symbols + data symbols) * symbol length (modem.js:863-874)."""
    n_sym = -(-payload_bytes * 8 * mode.repetition // mode.bits_per_symbol)
    return (3 + n_sym) * mode.profile.symbol_len


def remove_dc(x: torch.Tensor, alpha: float = DC_ALPHA, block: int = BLOCK) -> torch.Tensor:
    """The EMA DC tracker over a whole recording, float64 [T]: block by block
    in closed form, m_n = a^(n+1) m + (1 - a) a^n sum_k<=n a^-k x_k, the
    state carried from block to block."""
    n = x.shape[0]
    nb = -(-n // block)
    xs = torch.nn.functional.pad(x.to(F64), (0, nb * block - n)).reshape(nb, block)
    k = torch.arange(block, dtype=F64, device=x.device)
    w = torch.cumsum(xs * alpha ** -k, dim=1)
    ends = ((1 - alpha) * alpha ** (block - 1) * w[:, -1]).tolist()
    start, m = [0.0] * nb, 0.0
    for b in range(nb):
        start[b] = m
        m = alpha ** block * m + ends[b]
    dc = alpha ** (k + 1) * torch.tensor(start, dtype=F64, device=x.device)[:, None] + (1 - alpha) * alpha ** k * w
    return (xs - dc).reshape(-1)[:n]


def scan_sums(sig: torch.Tensor, half: int) -> tuple[np.ndarray, np.ndarray]:
    """Prefix sums over the recording, float64 with a leading 0: of
    s[n] s[n + half] (the Schmidl-Cox product) and of s[n]^2."""
    s = sig.cpu().numpy()
    cp = np.concatenate([[0.0], np.cumsum(s[:-half] * s[half:])])
    cs = np.concatenate([[0.0], np.cumsum(s * s)])
    return cp, cs


def scan_window(cp: np.ndarray, cs: np.ndarray, pos: int, n_pos: int, half: int) -> int:
    """First-peak commit over positions pos, pos + STRIDE, ... up to
    pos + n_pos - 1 (``scan_sums``' prefix sums): the committed offset from
    ``pos``, or -1. A window of fewer positions than the bucket holds ends
    in a metric of 0, which counts as a drop."""
    d = pos + np.arange(0, n_pos, STRIDE)
    p = cp[d + half] - cp[d]
    ra = cs[d + half] - cs[d]
    rb = cs[d + 2 * half] - cs[d + half]
    ok = (ra > MIN_ENERGY) & (rb > MIN_ENERGY)
    metric = np.append(np.where(ok, p * p / np.where(ok, ra * rb, 1.0), 0.0), 0.0)
    runmax = np.maximum.accumulate(metric)
    drop = (runmax > AUTOCORR_THRESHOLD) & (metric < 0.7 * runmax)
    end = int(np.argmax(drop)) if drop.any() else metric.shape[0] - 1
    idx = int(np.argmax(metric[: end + 1]))  # the first of equal maxima
    return idx * STRIDE if metric[idx] > AUTOCORR_THRESHOLD else -1


def refine(sig: torch.Tensor, coarse: int, total: int, p, tpl: torch.Tensor) -> tuple[int, float]:
    """``oracle.refine`` of one committed position with the template ``tpl``
    (preamble 1 as the precision stores it): d over [max(0, c - 3 CP),
    min(total - sym, c + 3 CP)]; (start, best metric), the first maximum
    winning, the coarse position with -inf where no offset is usable."""
    plen, radius = p.symbol_len, 3 * p.cp_len
    n_off = 2 * radius + 1
    lo, hi = max(coarse - radius, 0), min(total - plen, coarse + radius)
    win = sig[lo : lo + n_off + plen - 1]
    win = torch.nn.functional.pad(win, (0, n_off + plen - 1 - win.shape[0])).unfold(0, plen, 1)
    denom = torch.sqrt((win * win).sum(-1) * (tpl * tpl).sum())
    ok = (denom > 0.001) & (lo + torch.arange(n_off, device=sig.device) <= hi)
    metric = torch.where(ok, (win @ tpl) / torch.where(ok, denom, 1.0), float("-inf"))
    arg = int(torch.argmax(metric))
    best = float(metric[arg])
    return (lo + arg if math.isfinite(best) else coarse), best


def _parse(by: bytes) -> dict:
    """The frame parse of a metadata or data frame (modem.js:795-849; the
    CRC-32 is zlib's, the IEEE one); anything else through ``oracle.parse``."""
    def crc_ok(off: int) -> bool:
        return len(by) >= off + 4 and int.from_bytes(by[off : off + 4], "big") == zlib.crc32(by[:off])

    if len(by) >= 12 and by[0] == FRAME_META:
        name = by[12 : 12 + by[11]]
        return {"type": "meta", "total_chunks": int.from_bytes(by[1:5], "big"),
                "file_size": int.from_bytes(by[5:9], "big"), "chunk_size": int.from_bytes(by[9:11], "big"),
                "name": name, "file_name": name.decode("utf-8", errors="replace"), "crc_valid": crc_ok(12 + len(name))}
    if len(by) >= 10 and by[0] == FRAME_DATA:
        off = 7 + int.from_bytes(by[5:7], "big")
        return {"type": "data", "seq": int.from_bytes(by[1:5], "big"), "data": by[7:off], "crc_valid": crc_ok(off)}
    return oracle.parse(by)


def receive(x: torch.Tensor, mode_name: str, prec: Precision = REFERENCE, block: int = BLOCK) -> Received:
    """Receive the recording ``x`` (float32 [T]) with the receiver's
    semantics (see the module docstring)."""
    mode = MODES[mode_name]
    p = mode.profile
    sym, half, radius = p.symbol_len, p.fft_size // 2, 3 * p.cp_len
    sig = prec.q(remove_dc(x))
    n = sig.shape[0]
    cp, cs = scan_sums(sig, half)
    tpl = prec.qp(oracle.preamble1(p, sig.device).to(F64))
    known = oracle.ce_known(p, sig.device)
    rx = Received(frames=[])
    st = {"state": "idle", "scan": 0, "pre": -1, "end": -1, "fine": math.nan, "meta": False}

    def scan(total: int) -> bool:
        scan_end = total - 2 * half
        while st["scan"] <= scan_end:
            n_pos = min(scan_end - st["scan"] + 1, SCAN_BUCKET - 2 * half)
            rx.scan_windows += 1
            idx = scan_window(cp, cs, st["scan"], n_pos, half)
            if idx >= 0:
                st["pre"] = st["scan"] + idx
                st["scan"] = st["pre"] + half
                st["state"] = "refine"
                return True
            st["scan"] += n_pos
        return False

    def refined(total: int) -> bool:
        if total < st["pre"] + sym + radius:
            return False
        start, fine = refine(sig, st["pre"], total, p, tpl)
        if not fine >= XCORR_THRESHOLD:
            rx.false_peaks += 1
            st["state"] = "idle"
            return True
        st["pre"], st["fine"] = start, fine
        payload = rx.chunk_size + 11 if st["meta"] else PRE_META_MAX_PAYLOAD
        st["end"] = st["pre"] + frame_samples(payload, mode)
        st["state"] = "collect"
        return True

    def frame(total: int, partial: bool = False) -> None:
        pre = st["pre"]
        length = st["end"] - pre
        if partial:
            length = min(length, total - pre)
        fr = sig[pre : pre + length]
        mx = float(fr.abs().max())
        if mx > 1e-6:
            fr = prec.q(fr / mx)
        n_sym = (length - 3 * sym) // sym
        resume, mag, kind = None, None, "error"
        if n_sym > 0:
            ce = fr[2 * sym + p.cp_len : 2 * sym + p.cp_len + p.fft_size]  # oracle.channel
            ch = prec.qp(torch.fft.fft(ce)[p.sub_start : p.sub_end + 1] * known)
            mag = ch.abs().cpu().numpy()
            bits = oracle.demodulate(fr[3 * sym : (3 + n_sym) * sym].reshape(n_sym, sym), ch, mode)
            got = _parse(oracle.to_bytes(bits, mode.repetition))
            kind = got.get("type", "error")
        if kind == "error":
            resume = pre + 4 * sym
        elif kind == "meta":
            if got["crc_valid"]:
                st["meta"] = True
                rx.file_name, rx.total_chunks = got["file_name"], got["total_chunks"]
                rx.file_size, rx.chunk_size = got["file_size"], got["chunk_size"]
                rx.chunks, rx.crc_errors = {}, 0
                resume = pre + frame_samples(16 + len(got["name"]), mode)
        elif kind == "data":
            seq = got["seq"]
            if st["meta"] and seq < rx.total_chunks:
                if not got["crc_valid"]:
                    rx.crc_errors += 1
                elif seq not in rx.chunks:
                    rx.chunks[seq] = got["data"]
            if got["crc_valid"]:
                resume = pre + frame_samples(11 + len(got["data"]), mode)
        rx.frames.append(Frame(pre, st["fine"], mag, kind))
        if resume is not None and kind != "error":
            resume = min(resume, st["end"])
        st["scan"] = resume if resume is not None else st["end"]
        st["pre"], st["end"], st["fine"], st["state"] = -1, -1, math.nan, "idle"

    def collect(total: int) -> bool:
        if total < st["end"]:
            return False
        frame(total)
        return True

    steps = {"idle": scan, "refine": refined, "collect": collect}
    for off in range(0, n, block):
        total = min(off + block, n)
        while steps[st["state"]](total):
            pass
    if st["state"] in ("refine", "collect") and n - st["pre"] >= 4 * sym:  # the end of the recording
        if st["end"] < 0:
            st["end"] = n
        frame(n, partial=True)
    return rx


def frame_gaps(starts: list[int], fines: list[float], mags: list, ref: list[Frame]) -> dict:
    """The widest gaps of a receiver's frames against the reference's
    ``ref``, frame by frame: the ``starts``, ``fines`` (nan where the frame
    had no refine) and ``mags`` (|H|, None where the frame had no CE) of each
    frame the receiver cut; |H|'s gap as a share of the largest reference
    bin. A frame count that differs reads as a gap of the whole recording in
    the start and of 1 in the others."""
    if len(starts) != len(ref):
        return {"start_gap": float(max(starts + [r.start for r in ref] + [1])), "fine_gap": 1.0, "ce_gap": 1.0}
    out = {"start_gap": 0.0, "fine_gap": 0.0, "ce_gap": 0.0}
    for s, f, m, r in zip(starts, fines, mags, ref):
        out["start_gap"] = max(out["start_gap"], float(abs(s - r.start)))
        if math.isnan(f) != math.isnan(r.fine) or (m is None) != (r.mag is None):
            out["fine_gap"] = out["ce_gap"] = 1.0
            continue
        if not math.isnan(f):
            out["fine_gap"] = max(out["fine_gap"], abs(f - r.fine))
        if m is not None:
            out["ce_gap"] = max(out["ce_gap"], float(np.abs(np.asarray(m, np.float64) - r.mag).max() / r.mag.max()))
    return out


def compare(got: Received, ref: Received) -> dict:
    """``frame_gaps`` of one receive (``got``, the reference in another
    precision) against another."""
    return frame_gaps([f.start for f in got.frames], [f.fine for f in got.frames], [f.mag for f in got.frames],
                      ref.frames)
