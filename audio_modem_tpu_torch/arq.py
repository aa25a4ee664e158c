"""ARQ extension: missing-chunk retransmission sessions (counterpart of
audio_modem_tpu/arq.py).

The reference's protocol spec describes ACK/NACK selective-repeat ARQ
(docs/protocol_spec.md:43-63) that its simplex implementation never ships —
receivers can only report missing chunks out-of-band (app.js:659-665). This
module completes the spec:

Wire (extension frame, same PHY):
  request: [0xFC][count:2][seqNum:4 x count][CRC32:4]
     count == 0 means "transfer complete" (ACK-all).

Session layer: selective-repeat over any pair of unidirectional channels
(functions mapping a TX signal to the peer's RX signal — loopback, the
channel simulator, or real audio I/O). The forward link carries
metadata/data frames; the back link carries request frames. Rounds continue
until the receiver ACKs or ``max_rounds`` is hit; the return value reports
per-round chunk counts so tests can assert retransmission actually happened.

Frames are synthesized on ``device`` (``"cuda"`` unless the caller names
the CPU), one batched call per group of equal-length payloads, and come to
the host once per group: the channels take and return host float32 audio,
as a sound card would. The receivers decode on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from audio_modem_tpu_torch import decoder, framing, sync
from audio_modem_tpu_torch.configs import ModemMode
from audio_modem_tpu_torch.kernels import read_pair, resolve_device, upload
from audio_modem_tpu_torch.ops.bits import majority_vote, soft_combine
from audio_modem_tpu_torch.ops.constellations import bits_per_symbol
from audio_modem_tpu_torch.ops.crc32 import crc32
from audio_modem_tpu_torch.runtime.receiver import StreamingReceiver

FRAME_REQUEST = 0xFC
MAX_SEQS_PER_REQUEST = 256


def build_request_payload(missing: list[int]) -> bytes:
    """[0xFC][count:2][seq:4 x count][CRC:4]; count 0 = ACK-all."""
    seqs = missing[:MAX_SEQS_PER_REQUEST]
    body = bytes([FRAME_REQUEST]) + len(seqs).to_bytes(2, "big")
    for s in seqs:
        body += int(s).to_bytes(4, "big")
    return body + crc32(body).to_bytes(4, "big")


@dataclasses.dataclass
class RequestFrame:
    missing: list[int]
    crc_valid: bool
    frame_type: int = FRAME_REQUEST

    @property
    def is_ack(self) -> bool:
        return not self.missing


def parse_request(by: bytes) -> RequestFrame | framing.FrameError:
    if len(by) < 7 or by[0] != FRAME_REQUEST:
        return framing.FrameError("Not a request frame")
    count = int.from_bytes(by[1:3], "big")
    off = 3 + 4 * count
    if off + 4 > len(by):
        return framing.FrameError("Request frame truncated")
    seqs = [int.from_bytes(by[3 + 4 * i : 7 + 4 * i], "big") for i in range(count)]
    expected = int.from_bytes(by[off : off + 4], "big")
    return RequestFrame(seqs, expected == crc32(by[:off]))


def build_request_frame(missing: list[int], mode: ModemMode, device="cuda") -> torch.Tensor:
    """Request payload -> full OFDM frame on the back link, on ``device``."""
    p = mode.profile
    return framing.synthesize_frame(
        build_request_payload(missing), mode, p.silence_pre_chunk(True), p.silence_post_chunk(), device
    )


@dataclasses.dataclass
class ArqReport:
    complete: bool
    rounds: int
    chunks_sent_per_round: list[int]
    data: bytes
    file_name: str


def _payload(body: bytes, fec: bool) -> bytes:
    return framing.wrap_fec(body) if fec else body


def _synthesize_mixed(items: "list[tuple[bytes, int, int]]", mode: ModemMode, device) -> "list[np.ndarray]":
    """Batched TX of heterogeneous payloads: [(payload, silence_pre,
    silence_post)] -> per-item host frame signals, preserving order.

    Groups by (payload length, silences) and runs ONE batched synthesis
    (framing.synthesize_frames) on ``device`` per group, then ONE copy of
    the group to the host — an ARQ resend round across 64 streams costs a
    couple of device calls and copies instead of one of each per frame."""
    out: "list[np.ndarray | None]" = [None] * len(items)
    groups: dict = {}
    for idx, (pl, pre, post) in enumerate(items):
        groups.setdefault((len(pl), pre, post), []).append(idx)
    for (_, pre, post), idxs in groups.items():
        sigs = framing.synthesize_frames([items[i][0] for i in idxs], mode, pre, post, device).cpu().numpy()
        for row, i in enumerate(idxs):
            out[i] = sigs[row]
    return out  # type: ignore[return-value]


def run_arq_session(
    data: bytes,
    mode: ModemMode,
    file_name: str,
    forward: Callable[[np.ndarray], np.ndarray],
    backward: Callable[[np.ndarray], np.ndarray] | None = None,
    max_rounds: int = 5,
    fec: bool = False,
    device="cuda",
) -> ArqReport:
    """Selective-repeat transfer over simulated (or real) duplex channels.

    ``forward``/``backward`` map a transmitted host signal to what the peer
    receives (identity for loopback; channel.apply_channel_np for fault
    injection). Round 1 sends metadata + every chunk; each later round
    resends only the chunks the receiver reported missing. The back link
    carries request frames; a corrupted request falls back to "resend all
    still-missing" knowledge from the last good report (here: retry the
    request once, then give up the round). The receiver is a
    ``StreamingReceiver`` on ``device``.
    """
    dev = resolve_device(device)
    backward = backward or (lambda s: s)
    chunk_size = mode.chunk_size
    total_chunks = -(-len(data) // chunk_size)
    p = mode.profile
    pre_m, pre_d, post = p.silence_pre_chunk(True), p.silence_pre_chunk(False), p.silence_post_chunk()

    rx = StreamingReceiver(mode, fec=fec, device=dev)
    sent_per_round: list[int] = []

    def meta_item() -> tuple[bytes, int, int]:
        body = framing.build_metadata_payload(total_chunks, len(data), chunk_size, file_name)
        return _payload(body, fec), pre_m, post

    def chunk_item(s: int) -> tuple[bytes, int, int]:
        body = framing.build_data_chunk_payload(data[s * chunk_size : (s + 1) * chunk_size], s)
        return _payload(body, fec), pre_d, post

    def send_frames(items: "list[tuple[bytes, int, int]]") -> None:
        signal = forward(np.concatenate(_synthesize_mixed(items, mode, dev)))
        for off in range(0, len(signal), 4096):
            rx.process_audio_block(signal[off : off + 4096])
        rx.flush()

    # round 1: metadata + all chunks
    send_frames([meta_item()] + [chunk_item(s) for s in range(total_chunks)])
    sent_per_round.append(total_chunks)

    rounds = 1
    while rounds < max_rounds:
        # back link: receiver reports missing (or ACKs)
        missing = rx.assembler.missing_chunks() if rx.meta_received else list(range(total_chunks))
        req_sig = backward(build_request_frame(missing, mode, dev).cpu().numpy())
        req = _decode_request(req_sig, mode, dev)
        if isinstance(req, framing.FrameError) or not req.crc_valid:
            rounds += 1
            continue  # lost/corrupt request: sender retries next round
        if req.is_ack:
            break
        resend = [chunk_item(s) for s in req.missing]
        # re-send metadata too in case it was lost
        if not rx.meta_received:
            resend.insert(0, meta_item())
        send_frames(resend)
        sent_per_round.append(len(req.missing))
        rounds += 1
        if rx.assembler.is_complete:
            break

    out = rx.assembler.assemble() if rx.meta_received else b""
    report = ArqReport(
        complete=rx.assembler.is_complete,
        rounds=rounds,
        chunks_sent_per_round=sent_per_round,
        data=out,
        file_name=rx.assembler.file_name,
    )
    rx.cleanup()
    return report


def run_batch_arq_session(
    datas: "list[bytes]",
    mode: ModemMode,
    file_names: "list[str]",
    forward: Callable[[int, np.ndarray], np.ndarray],
    backward: "Callable[[int, np.ndarray], np.ndarray] | None" = None,
    max_rounds: int = 5,
    fec: bool = False,
    block: int = 65536,
    device="cuda",
) -> "list[ArqReport]":
    """Selective-repeat ARQ over the BATCHED runtime: N concurrent transfers
    through ONE BatchReceiver on ``device`` (its staged machine: scan,
    refine, then kernel B on the frames each step collects).

    ``forward(i, sig)`` / ``backward(i, sig)`` are per-stream channels on
    host audio. Each round: every stream's pending frames are synthesized
    in a couple of batched device calls (_synthesize_mixed), ingested as
    lockstep [N, block] host blocks (completed streams ride along as
    silence), and each incomplete stream's missing-chunk report crosses the
    back link as a request frame. Rounds stop at all-ACK or ``max_rounds``.
    """
    from audio_modem_tpu_torch.parallel.multi_receiver import BatchReceiver

    dev = resolve_device(device)
    backward = backward or (lambda i, s: s)
    n = len(datas)
    chunk_size = mode.chunk_size
    totals = [-(-len(d) // chunk_size) for d in datas]
    p = mode.profile
    pre_m, pre_d, post = (
        p.silence_pre_chunk(True),
        p.silence_pre_chunk(False),
        p.silence_post_chunk(),
    )
    rx = BatchReceiver(mode, n, fec=fec, device=dev)
    sent_per_round: "list[list[int]]" = [[] for _ in range(n)]

    def payload_for(i: int, s: int) -> bytes:
        return _payload(framing.build_data_chunk_payload(datas[i][s * chunk_size : (s + 1) * chunk_size], s), fec)

    def meta_payload(i: int) -> bytes:
        return _payload(framing.build_metadata_payload(totals[i], len(datas[i]), chunk_size, file_names[i]), fec)

    def send_round(per_stream: "dict[int, list[tuple[bytes, int]]]") -> None:
        """per_stream: i -> [(payload, silence_pre)] in send order."""
        flat: "list[tuple[bytes, int, int]]" = []
        slots: "list[tuple[int, int]]" = []  # (stream, position)
        for i, items in per_stream.items():
            for k, (pl, pre) in enumerate(items):
                flat.append((pl, pre, post))
                slots.append((i, k))
        sigs = _synthesize_mixed(flat, mode, dev)
        per_sig: "dict[int, list[np.ndarray]]" = {i: [] for i in per_stream}
        for (i, _), sig in zip(slots, sigs):
            per_sig[i].append(sig)
        signals = {i: forward(i, np.concatenate(s)) for i, s in per_sig.items() if s}
        if not signals:
            return
        length = max(len(s) for s in signals.values())
        for off in range(0, length, block):
            size = min(block, length - off)
            buf = np.zeros((n, size), np.float32)
            for i, s in signals.items():
                seg = s[off : off + size]
                buf[i, : len(seg)] = seg
            rx.process_blocks(buf)
        rx.flush()

    # round 1: metadata + every chunk, all streams at once
    send_round(
        {
            i: [(meta_payload(i), pre_m)]
            + [(payload_for(i, s), pre_d) for s in range(totals[i])]
            for i in range(n)
        }
    )
    for i in range(n):
        sent_per_round[i].append(totals[i])

    rounds = 1
    while rounds < max_rounds:
        # back links: per-stream missing-chunk reports (ACK when complete)
        requests: "dict[int, RequestFrame]" = {}
        all_acked = True
        for i, s in enumerate(rx.streams):
            missing = (
                s.assembler.missing_chunks()
                if s.meta_received
                else list(range(totals[i]))
            )
            req_sig = backward(i, build_request_frame(missing, mode, dev).cpu().numpy())
            req = _decode_request(req_sig, mode, dev)
            if isinstance(req, framing.FrameError) or not req.crc_valid:
                all_acked = False  # lost request: sender retries next round
                continue
            if not req.is_ack:
                requests[i] = req
                all_acked = False
        if all_acked:
            break
        resend: "dict[int, list[tuple[bytes, int]]]" = {}
        for i, req in requests.items():
            items = [(payload_for(i, s), pre_d) for s in req.missing]
            if not rx.streams[i].meta_received:
                items.insert(0, (meta_payload(i), pre_m))
            resend[i] = items
            sent_per_round[i].append(len(req.missing))
        rounds += 1
        if resend:
            send_round(resend)
        if all(s.assembler.is_complete for s in rx.streams):
            break

    reports = [
        ArqReport(
            complete=s.assembler.is_complete,
            rounds=rounds,
            chunks_sent_per_round=sent_per_round[i],
            data=s.assembler.assemble() if s.meta_received else b"",
            file_name=s.assembler.file_name,
        )
        for i, s in enumerate(rx.streams)
    ]
    rx.cleanup()
    return reports


def _decode_request(
    signal: "np.ndarray | torch.Tensor", mode: ModemMode, device="cuda"
) -> RequestFrame | framing.FrameError:
    """Full-signal decode of a request frame on ``device`` with
    decode_signal's full retry ladder behind it: the public retry-loop
    decode (decoder.decode_raw — false-positive resume), then on failure
    the xcorr sync re-acquisition with a frame-aligned decode
    (``_chunk_core``, the streaming demod), with soft repetition combining
    for the x3-repetition back-link modes. A noisy return channel is the
    ARQ session's weakest link; the reference has no return channel at all
    (spec-promised, never shipped). The signal goes to ``device`` once."""
    sig = upload(signal, device)
    raw, _info = decoder.decode_raw(sig, mode, device=sig.device)
    result: RequestFrame | framing.FrameError
    if isinstance(raw, framing.FrameError):
        result = raw
    else:
        result = parse_request(raw)
        if isinstance(result, RequestFrame) and result.crc_valid:
            return result
    # xcorr re-acquisition (see decoder.decode_signal)
    xstart, xmetric = read_pair("xcorr", *decoder._xcorr_core(decoder.pad_to_bucket(sig), sig.shape[0], mode))
    if xmetric < sync.XCORR_THRESHOLD or xstart < 0:
        return result
    # symbol-count bucketing (decoder.pad_aligned_frame): the frame is
    # padded to a whole number of SYM_BUCKET-symbol buckets
    padded = decoder.pad_aligned_frame(sig[xstart:], mode, device=sig.device)
    if isinstance(padded, framing.FrameError):
        return result
    fdev, n_sym, n_bucket = padded
    n_bits = n_sym * bits_per_symbol(mode)
    bits = decoder._chunk_core(fdev, mode, n_bucket)[:n_bits]
    b = majority_vote(bits, mode.repetition) if mode.repetition > 1 else bits
    retry = parse_request(decoder._to_bytes(b))
    if isinstance(retry, RequestFrame) and retry.crc_valid:
        return retry
    if decoder._soft_retry_applicable(mode):
        soft = decoder._chunk_soft_core(fdev, mode, n_bucket)[:n_bits]
        soft_retry = parse_request(decoder._to_bytes(soft_combine(soft, mode.repetition)))
        if isinstance(soft_retry, RequestFrame) and soft_retry.crc_valid:
            return soft_retry
    return result
