"""OFDM profiles + modem mode registry (immutable, jit-cache friendly).

Reference keeps a mutable global config (modem.js:69-98) that every call site
re-sets (the mutable-global anti-pattern). Here each profile is a frozen
dataclass whose hash keys jit caches, with every derived constant — subcarrier
index tables, pilot masks, and the seeded preamble / channel-estimation
waveforms (modem.js:158-200) — precomputed once in float64 and cached.

Profile values: modem.js:69-85. Mode registry: app.js:60-66. Chunk sizes:
app.js:195-199. Silence rules: modem.js:533-535, 728-733.

The port's own copy of audio_modem_tpu/configs.py, changed only in its
import paths; tests/test_torch_configs.py holds every field and derived
array equal to the original, so the wire format keeps one definition.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from audio_modem_tpu_torch.ops.lcg import js_lcg_signs

FFT_SIZE = 512
SAMPLE_RATE = 44100

# LCG seeds fixed by the reference protocol (modem.js:161,175,190)
SEED_PREAMBLE1 = 42
SEED_PREAMBLE2 = 43
SEED_CE = 44

# Frame type magic bytes (modem.js:661-662)
FRAME_META = 0xFE
FRAME_DATA = 0xFF
# EXTENSION: Reed-Solomon-wrapped payload (spec-promised FEC,
# docs/protocol_spec.md:56, never implemented by the reference)
FRAME_FEC = 0xFD

# Legacy vs chunked routing threshold (app.js:121)
CHUNK_THRESHOLD = 32 * 1024


@dataclasses.dataclass(frozen=True)
class OfdmProfile:
    """One OFDM physical-layer profile (modem.js:69-85)."""

    name: str
    cp_len: int
    sub_start: int
    sub_end: int
    pilots: tuple[int, ...]
    fft_size: int = FFT_SIZE
    sample_rate: int = SAMPLE_RATE

    @property
    def symbol_len(self) -> int:
        return self.fft_size + self.cp_len

    @property
    def is_acoustic(self) -> bool:
        # CP >= 128 selects long sync silences (modem.js:533)
        return self.cp_len >= 128

    @property
    def num_active_subs(self) -> int:
        return self.sub_end - self.sub_start + 1

    @property
    def num_data_subs(self) -> int:
        return self.num_active_subs - len(self.pilots)

    # ---- derived constant tables (cached per profile) ----

    def _d(self) -> "_Derived":
        return _derived(self)

    @property
    def active_bins(self) -> np.ndarray:
        return self._d().active_bins

    @property
    def data_bins(self) -> np.ndarray:
        return self._d().data_bins

    @property
    def pilot_bins(self) -> np.ndarray:
        return self._d().pilot_bins

    @property
    def pilot_mask_active(self) -> np.ndarray:
        """Boolean mask over active bins: True where pilot."""
        return self._d().pilot_mask_active

    @property
    def preamble1(self) -> np.ndarray:
        """Time-domain preamble symbol 1 incl. CP, float32 [symbol_len]."""
        return self._d().pre1

    @property
    def preamble2(self) -> np.ndarray:
        return self._d().pre2

    @property
    def ce_symbol(self) -> np.ndarray:
        """Time-domain channel-estimation symbol incl. CP, float32."""
        return self._d().ce

    @property
    def ce_known_signs(self) -> np.ndarray:
        """Known CE BPSK signs on active bins, float64 [num_active_subs]."""
        return self._d().ce_known

    def bits_per_symbol(self, bps: int) -> int:
        return self.num_data_subs * bps

    def header_samples(self) -> int:
        """pre1 + pre2 + CE (modem.js:872-873)."""
        return 3 * self.symbol_len

    def silence_pre_legacy(self) -> int:
        return int(self.sample_rate * (0.5 if self.is_acoustic else 0.3))

    def silence_post_legacy(self) -> int:
        return int(self.sample_rate * (0.5 if self.is_acoustic else 0.2))

    def silence_pre_chunk(self, is_first_frame: bool) -> int:
        if is_first_frame:
            return round(self.sample_rate * (0.5 if self.is_acoustic else 0.3))
        return round(self.sample_rate * 0.05)

    def silence_post_chunk(self) -> int:
        return round(self.sample_rate * 0.02)


@dataclasses.dataclass(frozen=True)
class _Derived:
    active_bins: np.ndarray
    data_bins: np.ndarray
    pilot_bins: np.ndarray
    pilot_mask_active: np.ndarray
    pre1: np.ndarray
    pre2: np.ndarray
    ce: np.ndarray
    ce_known: np.ndarray


def _synth_symbol(p: OfdmProfile, bins: np.ndarray, signs: np.ndarray) -> np.ndarray:
    """BPSK signs on ``bins`` -> real time-domain OFDM symbol with CP, f32.

    Half-spectrum + irfft is mathematically identical to the reference's
    Hermitian-extended full IFFT real output (modem.js:164-169), with DC and
    Nyquist zeroed.
    """
    half = np.zeros(p.fft_size // 2 + 1, dtype=np.complex128)
    half[bins] = signs
    td = np.fft.irfft(half, n=p.fft_size)
    out = np.concatenate([td[-p.cp_len :], td]).astype(np.float32)  # addCP (modem.js:202-208)
    return out


@lru_cache(maxsize=None)
def _derived(p: OfdmProfile) -> _Derived:
    active = np.arange(p.sub_start, p.sub_end + 1)
    pilot_set = set(p.pilots)
    pilot_mask = np.array([k in pilot_set for k in active])
    data_bins = active[~pilot_mask]
    pilot_bins = np.asarray(p.pilots, dtype=np.int64)

    # Preamble 1: every other active bin, seed 42 (modem.js:158-170)
    p1_bins = np.arange(p.sub_start, p.sub_end + 1, 2)
    p1_signs = js_lcg_signs(SEED_PREAMBLE1, len(p1_bins))
    pre1 = _synth_symbol(p, p1_bins, p1_signs)

    # Preamble 2: all active bins, seed 43 (modem.js:172-184)
    p2_signs = js_lcg_signs(SEED_PREAMBLE2, len(active))
    pre2 = _synth_symbol(p, active, p2_signs)

    # CE symbol: all active bins, seed 44 (modem.js:186-200)
    ce_signs = js_lcg_signs(SEED_CE, len(active))
    ce = _synth_symbol(p, active, ce_signs)

    return _Derived(
        active_bins=active,
        data_bins=data_bins,
        pilot_bins=pilot_bins,
        pilot_mask_active=pilot_mask,
        pre1=pre1,
        pre2=pre2,
        ce=ce,
        ce_known=ce_signs,
    )


OFDM_PROFILES: dict[str, OfdmProfile] = {
    "standard": OfdmProfile(
        name="standard",
        cp_len=64,
        sub_start=12,
        sub_end=232,
        pilots=(15, 29, 43, 57, 71, 85, 99, 113, 127, 141, 155, 169, 183, 197, 211, 225),
    ),
    "acoustic": OfdmProfile(
        name="acoustic",
        cp_len=128,
        sub_start=23,
        sub_end=93,
        pilots=(25, 35, 45, 55, 65, 75, 85),
    ),
    "narrowband": OfdmProfile(
        name="narrowband",
        cp_len=256,
        sub_start=35,
        sub_end=58,
        pilots=(37, 45, 53),
    ),
}


@dataclasses.dataclass(frozen=True)
class ModemMode:
    """User-facing mode: (profile, constellation, repetition) (app.js:60-66)."""

    name: str
    profile_name: str
    constellation: str
    repetition: int
    chunk_size: int  # app.js:195-199

    @property
    def profile(self) -> OfdmProfile:
        return OFDM_PROFILES[self.profile_name]

    @property
    def bps(self) -> int:
        from audio_modem_tpu_torch.ops.constellations import CONSTELLATIONS

        return CONSTELLATIONS[self.constellation].bps

    @property
    def bits_per_symbol(self) -> int:
        return self.profile.num_data_subs * self.bps


MODES: dict[str, ModemMode] = {
    "QPSK": ModemMode("QPSK", "standard", "QPSK", 1, 2048),
    "16-QAM": ModemMode("16-QAM", "standard", "QAM16", 1, 4096),
    "BPSK-ACOUSTIC": ModemMode("BPSK-ACOUSTIC", "acoustic", "BPSK", 1, 512),
    "BPSK-REPEAT": ModemMode("BPSK-REPEAT", "acoustic", "BPSK", 3, 512),
    "BPSK-NARROW": ModemMode("BPSK-NARROW", "narrowband", "BPSK", 3, 512),
    # EXTENSION mode: the reference spec promises 64-QAM at ~7.7 KB/s
    # (docs/protocol_spec.md:26-27) but the code never implements it; this
    # framework does. Same frame format — only the constellation differs.
    "64-QAM": ModemMode("64-QAM", "standard", "QAM64", 1, 4096),
}


def get_mode(name: str) -> ModemMode:
    """Mode lookup, case-insensitive, with the reference's default (QPSK)."""
    key = name.upper().replace("_", "-")
    if key in MODES:
        return MODES[key]
    aliases = {"QAM16": "16-QAM", "16QAM": "16-QAM", "QAM64": "64-QAM", "64QAM": "64-QAM", "BPSK": "BPSK-ACOUSTIC"}
    if key in aliases:
        return MODES[aliases[key]]
    raise KeyError(f"unknown mode {name!r}; valid: {sorted(MODES)}")
