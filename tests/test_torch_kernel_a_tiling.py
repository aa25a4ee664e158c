"""Kernel A's decomposition (csrc/receive.cu, amtpu_decode_fused) modelled in
plain PyTorch and held bit for bit to the plain path it replaces:

* stages 1-2: per-tile pairwise subtrees of the row sum, finished in tree
  order, and the preprocess peak from the tiles' max and min (fl(x - mean)
  is monotone in x) against ``sync.preprocess``;
* stage 4 (and the best search of stage 5): the first-peak commit tile by
  tile with a carry-in of the earlier tiles' maxima against
  ``sync.first_peak_commit``.

Tile sizes that do not divide the row or the scan, valid lengths and
minimum positions in mid-tile, and hand-made metrics for the commit's edge
cases (a drop at a tile boundary, equal maxima across two tiles, no drop,
nothing above 0.5). The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from audio_modem_tpu_torch import framing, sync
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.kernels import receive

torch.set_num_threads(2)

BIG = 2**31 - 1
ROWS_PER_TILE, SCAN_TILE = 32, 512  # the kernel's own sizes (csrc/receive.cu kRowsA, kScanTile)


def _tiled_preprocess(x: torch.Tensor, nv: torch.Tensor, rows: int) -> torch.Tensor:
    """Stages 1-2 of kernel A: [B, T] raw rows -> normalized rows."""
    b, t = x.shape
    m = 1
    while m * sync.SUM_LANES < t:
        m *= 2
    rows = min(rows, m)
    n_tiles = m // rows
    valid = torch.arange(t) < nv[:, None]
    pad = m * sync.SUM_LANES - t
    # stage 1: each tile's lane subtrees, and its max and min of valid samples
    v = torch.nn.functional.pad(torch.where(valid, x, 0.0), (0, pad)).reshape(b, n_tiles, rows, sync.SUM_LANES)
    while v.shape[2] > 1:
        v = v[:, :, 0::2] + v[:, :, 1::2]
    part = v[:, :, 0]
    hi = torch.nn.functional.pad(torch.where(valid, x, -torch.inf), (0, pad), value=-torch.inf)
    lo = torch.nn.functional.pad(torch.where(valid, x, torch.inf), (0, pad), value=torch.inf)
    tile_hi = hi.reshape(b, n_tiles, -1).amax(-1)
    tile_lo = lo.reshape(b, n_tiles, -1).amin(-1)
    # stage 2: the tree over all tiles in order, the lanes halved, the peak
    while part.shape[1] > 1:
        part = part[:, 0::2] + part[:, 1::2]
    lanes = part[:, 0]
    while lanes.shape[-1] > 1:
        h = lanes.shape[-1] // 2
        lanes = lanes[:, :h] + lanes[:, h:]
    mean = lanes / torch.clamp(nv[:, None].to(torch.float32), min=1.0)
    amax = torch.maximum((tile_hi.amax(1, keepdim=True) - mean).abs(), (tile_lo.amin(1, keepdim=True) - mean).abs())
    amax = torch.where(torch.clamp(nv, max=t)[:, None] > 0, amax, 0.0)
    big = amax > 1e-6
    scale = torch.where(big, torch.reciprocal(torch.where(big, amax, 1.0)), 1.0)
    return torch.where(valid, (x - mean) * scale, 0.0)


def _tiled_commit(metric: torch.Tensor, tile: int, stride: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 4 and the best search of stage 5: [B, n_pos] metric ->
    (coarse, best) as ``sync.first_peak_commit``."""
    b, n = metric.shape
    nt = -(-n // tile)
    tiles = torch.nn.functional.pad(metric, (0, nt * tile - n)).reshape(b, nt, tile)
    tmax = tiles.amax(-1)
    carry = torch.cat([torch.zeros(b, 1), torch.cummax(tmax, dim=1).values[:, :-1]], dim=1)
    run = torch.maximum(carry[..., None], torch.cummax(tiles, dim=-1).values)
    k = torch.arange(nt * tile).reshape(nt, tile)
    drop = (k < n) & (run > sync.AUTOCORR_THRESHOLD) & (tiles < 0.7 * run)
    first = torch.where(drop.any(-1), k.expand(b, -1, -1).gather(-1, drop.to(torch.uint8).argmax(-1, keepdim=True))[..., 0], BIG)
    fd = first.amin(1)
    fd = torch.where(fd == BIG, n - 1, fd)
    coarse, best = [], []
    for r in range(b):
        f = int(fd[r])
        tf = f // tile
        part = metric[r, tf * tile : f + 1]
        bst = torch.maximum(tmax[r, :tf].amax() if tf else torch.tensor(0.0), part.amax())
        full = (tmax[r, :tf] == bst).nonzero()
        if len(full):
            t0 = int(full[0]) * tile
            kb = t0 + int((metric[r, t0 : t0 + tile] == bst).nonzero()[0])
        else:
            kb = tf * tile + int((part == bst).nonzero()[0])
        coarse.append(kb * stride if bst > sync.AUTOCORR_THRESHOLD else -1)
        best.append(bst)
    return torch.tensor(coarse, dtype=torch.int32), torch.stack(best)


@pytest.mark.parametrize("t", [700, 5000, 1024 * 37 + 5, 70_001])
@pytest.mark.parametrize("rows", [1, 4, ROWS_PER_TILE])
def test_tiled_preprocess_is_sync_preprocess(t, rows):
    rng = np.random.default_rng(t + rows)
    x = torch.from_numpy((rng.standard_normal((5, t)) * rng.uniform(0.01, 3.0, (5, 1)) + 0.3).astype(np.float32))
    nv = torch.tensor([t, t // 2 + 17, 1, 0, t + 100], dtype=torch.int32)
    assert torch.equal(_tiled_preprocess(x, nv, rows), sync.preprocess(x, nv))


def _window_metric(mode, min_pos: int, nv_cut: int):
    rng = np.random.default_rng(min_pos + nv_cut)
    frames = framing.build_data_chunk_frames([rng.bytes(48) for _ in range(3)], 0, mode, device="cpu")
    x = torch.nn.functional.pad(frames, (4000, 3000)) + torch.from_numpy(
        0.03 * rng.standard_normal((3, frames.shape[1] + 7000)).astype(np.float32)
    )
    t = x.shape[1]
    nv = torch.tensor([t, t - nv_cut, t - 2 * nv_cut], dtype=torch.int32)
    pre = sync.preprocess(x, nv)
    mp = torch.tensor([0, min_pos, 2 * min_pos], dtype=torch.int32)
    return sync.scan_metric(pre, mode.profile, nv, min_pos=mp, stride=sync.COARSE_STRIDE)


@pytest.mark.parametrize("tile", [7, 64, 100, SCAN_TILE])
@pytest.mark.parametrize("min_pos, nv_cut", [(0, 0), (1000, 333), (4488, 1601), (30_000, 0)])
def test_tiled_commit_on_scanned_windows(tile, min_pos, nv_cut):
    metric = _window_metric(MODES["QPSK"], min_pos, nv_cut)
    assert metric.shape[1] % tile
    coarse, best = _tiled_commit(metric, tile)
    want_coarse, want_best = sync.first_peak_commit(metric, sync.COARSE_STRIDE)
    assert torch.equal(coarse, want_coarse) and torch.equal(best, want_best)


def _edge_metrics(tile: int) -> torch.Tensor:
    n = 5 * tile + 3
    rows = []
    m = torch.linspace(0.0, 0.9, 2 * tile)  # rising to the end of tile 1, dropping at tile 2's first index
    rows.append(torch.cat([m, torch.full((n - 2 * tile,), 0.1)]))
    m = torch.full((n,), 0.2)  # equal maxima from tile 0's last two positions into tile 1, then a drop
    m[tile - 2 : tile + 3] = 0.8
    m[tile + 3] = 0.3
    rows.append(m)
    rows.append(torch.linspace(0.0, 0.95, n))  # no drop: the whole scan
    m = torch.full((n,), 0.3)  # nothing above 0.5; the best is a late plateau
    m[3 * tile :] = 0.5
    rows.append(m)
    m = torch.zeros(n)  # a drop followed by a higher peak that must not win
    m[tile + 1], m[tile + 2], m[4 * tile] = 0.7, 0.2, 0.99
    rows.append(m)
    return torch.stack(rows).to(torch.float32)


@pytest.mark.parametrize("tile", [4, 9, 64, SCAN_TILE])
def test_tiled_commit_edge_cases(tile):
    metric = _edge_metrics(tile)
    coarse, best = _tiled_commit(metric, tile)
    want_coarse, want_best = sync.first_peak_commit(metric, sync.COARSE_STRIDE)
    assert torch.equal(coarse, want_coarse) and torch.equal(best, want_best)
    # the cases hold what they say
    assert int(want_coarse[1]) == (tile - 2) * sync.COARSE_STRIDE
    assert int(want_coarse[2]) == (metric.shape[1] - 1) * sync.COARSE_STRIDE
    assert int(want_coarse[3]) == -1 and float(want_best[3]) == 0.5
    assert int(want_coarse[4]) == (tile + 1) * sync.COARSE_STRIDE


@pytest.mark.parametrize("t", [8192, 914_688, 7_913_472, 100_003])
def test_fused_geometry_covers_the_plain_scan(t):
    """The wrapper's position count, from which the kernel derives its scan
    tiles, is the length of ``sync.scan_metric`` at stride 16."""
    mode = MODES["QPSK"]
    x = torch.zeros(1, t)
    want = sync.scan_metric(x, mode.profile, torch.tensor([t]), stride=sync.COARSE_STRIDE).shape[1]
    assert receive._scan_positions(t, mode.profile) == want
