"""Preamble synchronization, batched over a leading stream axis
(counterpart of audio_modem_tpu/sync.py; modem.js:213-319, 567-588).

Two invariants carry over from the JAX package:

* window sums use the exact pairwise doubling of ``windowed_sum``, never
  cumulative-sum differences (float32 cancellation there causes false
  detections in silence);
* the coarse scan commits the FIRST peak above 0.5 once the metric drops
  below 0.7x its running max, never the global argmax (see the JAX
  ``detect_preamble`` docstring for the reference bug this avoids).

Every sum whose rounding can move a decision (the preprocess mean, the
scan's block and window sums) runs in a fixed order that uses only
elementwise adds, so the CUDA kernel that replaces this path
(``kernels/receive.py::decode_fused``) reproduces it bit for bit.
"""

from __future__ import annotations

import torch

from audio_modem_tpu_torch.configs import OfdmProfile
from audio_modem_tpu_torch.tables import profile_tables

AUTOCORR_THRESHOLD = 0.5
AUTOCORR_MIN_ENERGY = 0.01
XCORR_THRESHOLD = 0.1
XCORR_MIN_DENOM = 0.001
XCORR_DETECT_THRESHOLD = 0.15
COARSE_STRIDE = 16

# Lanes of the fixed-order row sum (see pairwise_row_sum); the CUDA kernel
# gives one thread to each lane.
SUM_LANES = 1024


def windowed_sum(x: torch.Tensor, window: int) -> torch.Tensor:
    """Sliding-window sum over the last axis, 'valid' mode:
    [..., T] -> [..., T - window + 1], by exact doubling: S_2k[d] = S_k[d] +
    S_k[d+k], then the binary expansion of ``window`` composed by shifted
    adds, largest power first."""
    t = x.shape[-1]
    x = x.to(torch.float32)
    powers = [1 << b for b in range(window.bit_length()) if window & (1 << b)]
    top = max(powers)
    cache = {1: x}
    k = 1
    while 2 * k <= top:
        s = cache[k]
        cache[2 * k] = s[..., : s.shape[-1] - k] + s[..., k:]
        k *= 2
    n_pos = t - window + 1
    out = None
    off = 0
    for pk in sorted(powers, reverse=True):
        seg = cache[pk][..., off : off + n_pos]
        out = seg if out is None else out + seg
        off += pk
    return out


def pairwise_row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed order: [..., T] -> [..., 1].

    The row is zero-padded to SUM_LANES * m (m a power of two) and viewed as
    [m, SUM_LANES]; adjacent rows are added pairwise until one is left,
    then the lanes are halved (lane l + lane l + n/2) down to one."""
    *lead, t = x.shape
    m = 1
    while m * SUM_LANES < t:
        m *= 2
    v = torch.nn.functional.pad(x.to(torch.float32), (0, m * SUM_LANES - t))
    v = v.reshape(*lead, m, SUM_LANES)
    while v.shape[-2] > 1:
        v = v[..., 0::2, :] + v[..., 1::2, :]
    v = v[..., 0, :]
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v


def preprocess(signal: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """DC removal + unit-peak normalization over the first ``n_valid``
    samples of each row (modem.js:213-232); samples past it stay 0."""
    t = signal.shape[-1]
    nv = n_valid.to(signal.device)[..., None]
    mask = torch.arange(t, device=signal.device) < nv
    sig = torch.where(mask, signal.to(torch.float32), 0.0)
    mean = pairwise_row_sum(sig) / torch.clamp(nv.to(torch.float32), min=1.0)
    out = torch.where(mask, sig - mean, 0.0)
    mx = out.abs().amax(dim=-1, keepdim=True)
    big = mx > 1e-6
    scale = torch.where(big, torch.reciprocal(torch.where(big, mx, 1.0)), 1.0)
    return out * scale


def _strided_windowed_sum(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Window sums at stride-aligned positions only: [..., T] ->
    [..., T//stride - window//stride + 1]. Block sums of ``stride`` samples,
    added in sample order, then ``windowed_sum`` over the blocks."""
    *lead, t = x.shape
    nb = t // stride
    xs = x[..., : nb * stride].reshape(*lead, nb, stride)
    blocks = xs[..., 0]
    for j in range(1, stride):
        blocks = blocks + xs[..., j]
    return windowed_sum(blocks, window // stride)


def scan_metric(
    signal: torch.Tensor,
    profile: OfdmProfile,
    n_valid: torch.Tensor,
    min_pos: "torch.Tensor | int" = 0,
    min_energy: float = AUTOCORR_MIN_ENERGY,
    stride: int = 1,
) -> torch.Tensor:
    """Schmidl-Cox metric P^2/(Ra*Rb) over fft/2-sample halves at every
    scan position of [..., T] -> [..., n_pos]; 0 where the position is not
    valid (d > n_valid - fft, d < min_pos, or an energy <= ``min_energy``).
    ``stride`` > 1 evaluates only stride-aligned positions (safe up to
    CP/4; must divide fft/2)."""
    half = profile.fft_size // 2
    if half % stride:
        raise ValueError("stride must divide the half-symbol window")
    t = signal.shape[-1]
    dev = signal.device
    s = signal.to(torch.float32)
    prod = s[..., : t - half] * s[..., half:]
    if stride == 1:
        n_pos = t - 2 * half + 1
        p = windowed_sum(prod, half)[..., :n_pos]
        e = windowed_sum(s * s, half)
    else:
        p = _strided_windowed_sum(prod, half, stride)
        e = _strided_windowed_sum(s * s, half, stride)
        n_pos = min(p.shape[-1], e.shape[-1] - half // stride)
        p = p[..., :n_pos]
    hs = half // stride
    ra = e[..., :n_pos]
    rb = e[..., hs : hs + n_pos]

    d = torch.arange(n_pos, device=dev) * stride
    nv = torch.as_tensor(n_valid, device=dev)[..., None]
    mp = torch.as_tensor(min_pos, device=dev)[..., None]
    valid = (d <= nv - 2 * half) & (d >= mp) & (ra > min_energy) & (rb > min_energy)
    return torch.where(valid, (p * p) / torch.where(valid, ra * rb, 1.0), 0.0)


def first_peak_commit(metric: torch.Tensor, stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """First-peak commit over a scan metric [..., n_pos]: the first position
    where the metric drops below 0.7x its running max (once that max exceeds
    0.5) closes the search; the best metric up to it and its first index
    win. Returns (coarse int32 = index * stride, or -1 when the best metric
    is <= 0.5; best metric float32)."""
    n_pos = metric.shape[-1]
    runmax = torch.cummax(metric, dim=-1).values
    drop = (runmax > AUTOCORR_THRESHOLD) & (metric < 0.7 * runmax)
    first_drop = torch.where(
        drop.any(dim=-1), torch.argmax(drop.to(torch.uint8), dim=-1), n_pos - 1
    )
    k = torch.arange(n_pos, device=metric.device)
    prefix = torch.where(k <= first_drop[..., None], metric, 0.0)
    best = prefix.amax(dim=-1)
    idx = (torch.argmax(prefix, dim=-1) * stride).to(torch.int32)
    return torch.where(best > AUTOCORR_THRESHOLD, idx, -1).to(torch.int32), best


def detect_preamble(
    signal: torch.Tensor,
    profile: OfdmProfile,
    n_valid: torch.Tensor,
    min_pos: "torch.Tensor | int" = 0,
    min_energy: float = AUTOCORR_MIN_ENERGY,
    stride: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Coarse Schmidl-Cox scan over [..., T] with first-peak commit
    (``scan_metric``, then ``first_peak_commit``). Returns (coarse int32,
    best metric float32); coarse is -1 when the best metric is <= 0.5."""
    return first_peak_commit(scan_metric(signal, profile, n_valid, min_pos, min_energy, stride), stride)


def gather_windows(signal: torch.Tensor, starts: torch.Tensor, length: int) -> torch.Tensor:
    """Rows of [B, L] ``signal`` cut at per-row ``starts`` [B] into [B, length];
    samples outside [0, L) read as 0."""
    L = signal.shape[-1]
    idx = starts.to(torch.int64)[:, None] + torch.arange(length, device=signal.device)
    inside = (idx >= 0) & (idx < L)
    vals = torch.gather(signal, 1, idx.clamp(0, L - 1))
    return torch.where(inside, vals, 0.0)


def sliding_correlate(x: torch.Tensor, profile: OfdmProfile) -> torch.Tensor:
    """corr[d] = sum_j x[d+j] * pre1[j]: [..., L] -> [..., L - sym + 1].
    Materializes the [..., L - sym + 1, sym] window view: meant for refine
    regions, not whole signals."""
    pre1 = profile_tables(profile, x.device).pre1
    return torch.matmul(x.to(torch.float32).unfold(-1, pre1.shape[0], 1), pre1)


def detect_preamble_xcorr(
    signal: torch.Tensor, profile: OfdmProfile, n_valid: "torch.Tensor | int"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense normalized cross-correlation against preamble 1 at every
    position of [..., T] (modem.js:235-283, the reference's fallback
    detector). Returns (best index int32, best metric float32); the index
    is -1 when the metric is <= 0.15. The correlation is a float32
    ``conv1d`` (cuDNN's TF32 is off), so no window view of the whole
    signal is ever built."""
    tabs = profile_tables(profile, signal.device)
    plen = profile.symbol_len
    *lead, t = signal.shape
    s = signal.to(torch.float32)
    corr = torch.nn.functional.conv1d(s.reshape(-1, 1, t), tabs.pre1.view(1, 1, plen))
    corr = corr.reshape(*lead, t - plen + 1)
    denom = torch.sqrt(windowed_sum(s * s, plen) * tabs.t_energy)
    d = torch.arange(t - plen + 1, device=signal.device)
    nv = torch.as_tensor(n_valid, device=signal.device)[..., None]
    ok = (denom > XCORR_MIN_DENOM) & (d <= nv - plen)
    metric = torch.where(ok, corr / torch.where(ok, denom, 1.0), 0.0)
    best = metric.amax(dim=-1)
    idx = torch.argmax(metric, dim=-1).to(torch.int32)
    return torch.where(best > XCORR_DETECT_THRESHOLD, idx, -1).to(torch.int32), best


def refine_xcorr(
    signal: torch.Tensor,
    coarse_idx: torch.Tensor,
    profile: OfdmProfile,
    n_valid: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fine normalized cross-correlation against preamble 1 around
    ``coarse_idx`` (modem.js:567-588), batched: signal [B, L], coarse [B].

    d runs over [max(0, c - 3CP), min(n_valid - sym, c + 3CP)]; the metric is
    corr / sqrt(window energy * template energy), -inf where that root is
    <= 1e-3. Returns (start int32 [B], best metric [B]); ties take the
    smallest d, and start falls back to ``coarse_idx`` when no d is finite.
    Samples past the end of ``signal`` read as 0."""
    tabs = profile_tables(profile, signal.device)
    plen = profile.symbol_len
    radius = 3 * profile.cp_len
    n_off = 2 * radius + 1
    coarse = coarse_idx.to(torch.int64)
    lo = torch.clamp(coarse - radius, min=0)
    hi = torch.minimum(n_valid.to(torch.int64) - plen, coarse + radius)
    region = gather_windows(signal.to(torch.float32), lo, n_off + plen - 1)
    corr = sliding_correlate(region, profile)
    denom = torch.sqrt(windowed_sum(region * region, plen) * tabs.t_energy)
    d_global = lo[:, None] + torch.arange(n_off, device=signal.device)
    ok = (denom > XCORR_MIN_DENOM) & (d_global <= hi[:, None])
    metric = torch.where(ok, corr / torch.where(ok, denom, 1.0), float("-inf"))
    best = metric.amax(dim=-1)
    start = torch.where(torch.isfinite(best), lo + torch.argmax(metric, dim=-1), coarse)
    return start.to(torch.int32), best
