"""L3 framing: payload codecs (host) and frame synthesis (device), batched
and single-frame (counterpart of audio_modem_tpu/framing.py).

Wire formats (big-endian), matching the reference exactly:
  legacy (modem.js:498-522):  [nameLen:1][name][dataLen:4][data][CRC32:4]
  meta   (modem.js:666-692):  [0xFE][totalChunks:4][totalFileSize:4]
                              [chunkSize:2][nameLen:1][name][CRC32:4]
  data   (modem.js:694-714):  [0xFF][seqNum:4][dataLen:2][data][CRC32:4]
  FEC    (extension):         [0xFD][codedLen:4][RS(255,223)-coded inner payload]

The codecs are copies of the JAX package's host code; the tests hold both
byte-identical. The frame builders synthesize on ``device``, the card unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from audio_modem_tpu_torch.configs import FRAME_DATA, FRAME_FEC, FRAME_META, ModemMode
from audio_modem_tpu_torch.ops.crc32 import crc32
from audio_modem_tpu_torch import phy
from audio_modem_tpu_torch.kernels import resolve_device
from audio_modem_tpu_torch.ops.bits import bytes_to_bits, repeat_bits
from audio_modem_tpu_torch.ops.constellations import bits_per_symbol
from audio_modem_tpu_torch.tables import profile_tables

# ---------------- payload codecs (host) ----------------


def _be32(v: int) -> bytes:
    return int(v).to_bytes(4, "big")


def _be16(v: int) -> bytes:
    return int(v).to_bytes(2, "big")


def build_legacy_payload(file_data: bytes, file_name: str) -> bytes:
    name = (file_name or "file").encode("utf-8")[:255]
    body = bytes([len(name)]) + name + _be32(len(file_data)) + bytes(file_data)
    return body + _be32(crc32(body))


def build_metadata_payload(total_chunks: int, total_file_size: int, chunk_size: int, file_name: str) -> bytes:
    name = (file_name or "file").encode("utf-8")[:255]
    body = (
        bytes([FRAME_META]) + _be32(total_chunks) + _be32(total_file_size)
        + _be16(chunk_size) + bytes([len(name)]) + name
    )
    return body + _be32(crc32(body))


def build_data_chunk_payload(chunk: bytes, seq_num: int) -> bytes:
    body = bytes([FRAME_DATA]) + _be32(seq_num) + _be16(len(chunk)) + bytes(chunk)
    return body + _be32(crc32(body))


@dataclasses.dataclass
class LegacyFrame:
    file_name: str
    data: bytes
    crc_valid: bool
    expected_crc: int
    actual_crc: int
    frame_type: str = "legacy"
    fec_corrected: int = 0


@dataclasses.dataclass
class MetaFrame:
    total_chunks: int
    total_file_size: int
    chunk_size: int
    file_name: str
    crc_valid: bool
    frame_type: int = FRAME_META
    fec_corrected: int = 0


@dataclasses.dataclass
class DataFrame:
    seq_num: int
    data: bytes
    crc_valid: bool
    frame_type: int = FRAME_DATA
    fec_corrected: int = 0


@dataclasses.dataclass
class FrameError:
    error: str


ParseResult = LegacyFrame | MetaFrame | DataFrame | FrameError


def parse_metadata(by: bytes) -> MetaFrame | FrameError:
    """modem.js:805-828."""
    if len(by) < 16:
        return FrameError("Metadata frame too short")
    total_chunks = int.from_bytes(by[1:5], "big")
    total_size = int.from_bytes(by[5:9], "big")
    chunk_size = int.from_bytes(by[9:11], "big")
    name_len = by[11]
    off = 12 + name_len
    if off + 4 > len(by):
        return FrameError("Metadata frame truncated")
    name = by[12:off].decode("utf-8", errors="replace")
    expected = int.from_bytes(by[off : off + 4], "big")
    return MetaFrame(total_chunks, total_size, chunk_size, name, expected == crc32(by[:off]))


def parse_data_chunk(by: bytes) -> DataFrame | FrameError:
    """modem.js:830-849."""
    if len(by) < 11:
        return FrameError("Data chunk frame too short")
    seq = int.from_bytes(by[1:5], "big")
    dlen = int.from_bytes(by[5:7], "big")
    off = 7 + dlen
    if off + 4 > len(by):
        return FrameError("Data chunk truncated")
    data = by[7:off]
    expected = int.from_bytes(by[off : off + 4], "big")
    return DataFrame(seq, data, expected == crc32(by[:off]))


def parse_legacy(by: bytes) -> LegacyFrame | FrameError:
    """modem.js:622-653."""
    if len(by) < 10:
        return FrameError("Decoded data too short")
    name_len = by[0]
    off = 1 + name_len
    if off + 8 > len(by):
        return FrameError("Decoded data too short for header")
    name = by[1:off].decode("utf-8", errors="replace")
    dlen = int.from_bytes(by[off : off + 4], "big")
    off += 4
    if dlen <= 0 or off + dlen + 4 > len(by):
        return FrameError(f"Invalid data length: {dlen}")
    data = by[off : off + dlen]
    off += dlen
    expected = int.from_bytes(by[off : off + 4], "big")
    actual = crc32(by[:off])
    return LegacyFrame(name, data, expected == actual, expected, actual)


def parse_payload_bytes(
    by: bytes, min_len: int = 10, erasures: "np.ndarray | None" = None
) -> ParseResult:
    """Dispatch on the first byte (modem.js:609-621, 795-802; 0xFD is the
    FEC extension). ``erasures`` optionally flags unreliable bytes for the
    FEC path's errors-and-erasures decoding. A failed FEC parse falls back
    to a legacy parse only when that parse is CRC-valid (a legacy frame whose
    name is 253 bytes long starts with the same byte)."""
    if len(by) < min_len:
        return FrameError("Decoded data too short")
    if by[0] == FRAME_FEC:
        res = parse_fec(by, min_len, erasures=erasures)
        if isinstance(res, FrameError):
            legacy = parse_legacy(by)
            if not isinstance(legacy, FrameError) and legacy.crc_valid:
                return legacy
        return res
    if by[0] == FRAME_META:
        return parse_metadata(by)
    if by[0] == FRAME_DATA:
        return parse_data_chunk(by)
    return parse_legacy(by)


def fec_coded_len(payload_bytes: int) -> int:
    from audio_modem_tpu_torch.ops.rs import K, NSYM

    return payload_bytes + NSYM * (-(-payload_bytes // K))


def fec_wire_len(payload_bytes: int) -> int:
    """Total on-air payload bytes for a FEC-wrapped payload."""
    return 5 + fec_coded_len(payload_bytes)


def wrap_fec(payload: bytes) -> bytes:
    from audio_modem_tpu_torch.ops.rs import codeword_lengths, interleave, rs_encode

    coded = rs_encode(payload)
    coded = interleave(coded, len(codeword_lengths(len(coded))))
    return bytes([FRAME_FEC]) + _be32(len(coded)) + coded


def parse_fec(
    by: bytes, min_len: int = 10, erasures: "np.ndarray | None" = None
) -> ParseResult:
    from audio_modem_tpu_torch.ops.rs import codeword_lengths, deinterleave, rs_decode

    if len(by) < 5:
        return FrameError("FEC frame too short")
    clen = int.from_bytes(by[1:5], "big")
    if 5 + clen > len(by):
        return FrameError("FEC frame truncated")
    try:
        row_lens = codeword_lengths(clen)
        coded = deinterleave(by[5 : 5 + clen], len(row_lens), row_lens)
        ers = None
        if erasures is not None and len(erasures) >= 5 + clen:
            flags = deinterleave(
                bytes(np.asarray(erasures[5 : 5 + clen], np.uint8)), len(row_lens), row_lens
            )
            ers = np.frombuffer(flags, np.uint8).astype(bool)
        inner, corrected = rs_decode(coded, erasures=ers)
    except ValueError as e:
        return FrameError(f"FEC decode failed: {e}")
    result = parse_payload_bytes(inner, min_len)
    if not isinstance(result, FrameError):
        result.fec_corrected = corrected
    return result


def payload_to_bits(payload: bytes, mode: ModemMode) -> np.ndarray:
    """bytes -> repetition-coded int8 bits, zero-padded to a whole symbol
    (modem.js:524-526, 329)."""
    bits = np.unpackbits(np.frombuffer(bytes(payload), np.uint8)).astype(np.int8)
    if mode.repetition > 1:
        bits = repeat_bits(torch.from_numpy(bits), mode.repetition).numpy()
    pad = (-len(bits)) % bits_per_symbol(mode)
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, dtype=bits.dtype)])
    return bits


def num_symbols_for_payload(payload_bytes: int, mode: ModemMode) -> int:
    """ceil(bits / bitsPerSymbol) (modem.js:866-869)."""
    return -(-(payload_bytes * 8 * mode.repetition) // bits_per_symbol(mode))


def estimate_frame_samples(payload_bytes: int, mode: ModemMode) -> int:
    """(3 header symbols + data symbols) * symbol_len (modem.js:863-874)."""
    return (3 + num_symbols_for_payload(payload_bytes, mode)) * mode.profile.symbol_len


def estimate_frame_samples_with_silence(payload_bytes: int, mode: ModemMode, is_first_frame: bool) -> int:
    """modem.js:876-884."""
    p = mode.profile
    return (
        p.silence_pre_chunk(is_first_frame)
        + estimate_frame_samples(payload_bytes, mode)
        + p.silence_post_chunk()
    )


# ---------------- frame synthesis (device) ----------------

# Frames per synthesis step: bounds the working set (mapped points, product
# output and assembled frames are live together) for very large batches.
_SYNTH_GROUP = 4096


def _synth_frames_body(
    payloads_u8: torch.Tensor, mode: ModemMode, n_sym: int, silence_pre: int, silence_post: int
) -> torch.Tensor:
    b = payloads_u8.shape[0]
    bits = bytes_to_bits(payloads_u8)
    if mode.repetition > 1:
        bits = repeat_bits(bits, mode.repetition)
    bits = torch.nn.functional.pad(bits, (0, n_sym * bits_per_symbol(mode) - bits.shape[1]))
    syms = phy.modulate(bits, mode)  # [B, n_sym, sym]
    header = profile_tables(mode, payloads_u8.device).header
    body = torch.cat([header.expand(b, -1), syms.reshape(b, -1)], dim=-1)
    mx = body.abs().amax(dim=-1, keepdim=True)
    pos = mx > 0
    body = torch.where(pos, body * (mx.new_tensor(0.8) / torch.where(pos, mx, 1.0)), body)
    return torch.nn.functional.pad(body, (silence_pre, silence_post))


def _synth_frames_core(
    payloads_u8: torch.Tensor, mode: ModemMode, n_sym: int, silence_pre: int, silence_post: int
) -> torch.Tensor:
    """[B, n_bytes] uint8 payloads -> [B, total_len] frames on the payloads'
    device: bit unpack, repetition, constellation map, the TX product,
    pre1 | pre2 | CE header, per-frame 0.8 peak norm, zero silences
    (modem.js:529-553, 718-766)."""
    b = payloads_u8.shape[0]
    if b <= _SYNTH_GROUP:
        return _synth_frames_body(payloads_u8, mode, n_sym, silence_pre, silence_post)
    return torch.cat(
        [
            _synth_frames_body(payloads_u8[i : i + _SYNTH_GROUP], mode, n_sym, silence_pre, silence_post)
            for i in range(0, b, _SYNTH_GROUP)
        ]
    )


def synthesize_frames(
    payloads: "list[bytes]", mode: ModemMode, silence_pre: int, silence_post: int, device="cuda"
) -> torch.Tensor:
    """Equal-length payloads -> [B, total_len] frames in one batched call."""
    n_bytes = len(payloads[0])
    if any(len(pl) != n_bytes for pl in payloads):
        raise ValueError("synthesize_frames requires equal-length payloads")
    u8 = np.frombuffer(b"".join(payloads), np.uint8).reshape(len(payloads), n_bytes)
    n_sym = num_symbols_for_payload(n_bytes, mode)
    return _synth_frames_core(
        torch.from_numpy(u8.copy()).to(resolve_device(device)), mode, n_sym, silence_pre, silence_post
    )


def build_data_chunk_frames(
    chunks: "list[bytes]", first_seq: int, mode: ModemMode, fec: bool = False, device="cuda"
) -> torch.Tensor:
    """Consecutive equal-length chunks numbered from ``first_seq`` ->
    [B, total_len] data frames (modem.js:763-766, batched)."""
    p = mode.profile
    payloads = [build_data_chunk_payload(c, first_seq + i) for i, c in enumerate(chunks)]
    if fec:
        payloads = [wrap_fec(pl) for pl in payloads]
    return synthesize_frames(payloads, mode, p.silence_pre_chunk(False), p.silence_post_chunk(), device)


def synthesize_frame(
    payload: bytes, mode: ModemMode, silence_pre: int, silence_post: int, device="cuda"
) -> torch.Tensor:
    """One payload -> its frame [total_len]: silence | pre1 | pre2 | CE |
    data | silence, peak-normalized to 0.8 (modem.js:529-553); a batch of
    one through ``_synth_frames_core``."""
    return synthesize_frames([payload], mode, silence_pre, silence_post, device)[0]


def build_transmit_signal(
    file_data: bytes, mode: ModemMode, file_name: str, fec: bool = False, device="cuda"
) -> torch.Tensor:
    """Legacy single-frame TX (modem.js:498-555); ``fec`` wraps the payload in
    RS(255,223) (extension)."""
    p = mode.profile
    payload = build_legacy_payload(file_data, file_name)
    if fec:
        payload = wrap_fec(payload)
    return synthesize_frame(payload, mode, p.silence_pre_legacy(), p.silence_post_legacy(), device)


def build_metadata_frame(
    total_chunks: int, total_file_size: int, chunk_size: int, file_name: str, mode: ModemMode,
    fec: bool = False, device="cuda",
) -> torch.Tensor:
    """modem.js:758-761."""
    p = mode.profile
    payload = build_metadata_payload(total_chunks, total_file_size, chunk_size, file_name)
    if fec:
        payload = wrap_fec(payload)
    return synthesize_frame(payload, mode, p.silence_pre_chunk(True), p.silence_post_chunk(), device)


def build_data_chunk_frame(
    chunk: bytes, seq_num: int, mode: ModemMode, fec: bool = False, device="cuda"
) -> torch.Tensor:
    """modem.js:763-766."""
    return build_data_chunk_frames([chunk], seq_num, mode, fec, device)[0]
