"""The demod tile's decomposition (csrc/receive.cu, demod_tile) modelled in
plain PyTorch and held bit for bit to the plain path it replaces:

* symbol tiles of MT rows with a ragged, masked last tile; the staged bodies
  in the kernel's layout of tap quads [fft / 4][MT + 1][4], filled through
  its element order (8 quads of 4 symbols per warp);
* the padded table ``Tables.rx_demod`` multiplied in chunks of KC taps, the
  accumulators kept across chunks, each thread's RM x RN block written to the
  spectrum through the kernel's (thread, r, q) -> (row, column) map;
* the per-tile epilogue: pilot ratios, their sum in pilot order, ZF EQ,
  rotation, demap;
* kernel B's variant, where row 0 of every tile is the CE body and the EQ
  tables come from that row's spectrum;

against ``phy.demodulate`` and ``decode_chunks_fused_reference`` for every
mode, one and three streams, and symbol counts around the tile sizes. Also
``rx_demod`` itself: ``rx_data | rx_pilot``, zero padding, 16-byte rows, and
columns equal to ``rx_active``'s at the data and pilot positions. The CUDA
kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import audio_modem_tpu_torch
from audio_modem_tpu_torch import phy
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.kernels import receive
from audio_modem_tpu_torch.ops import constellations as con
from audio_modem_tpu_torch.tables import DEMOD_COLUMN_MULTIPLE, profile_tables

torch.set_num_threads(2)

FFT = 512
KC = 16  # taps per staged chunk of the table (csrc/receive.cu kKC)
# (RM, RN, TM, TN) of the kernel's tiles by padded column count (csrc/receive.cu TileWide, TileMid, TileNarrow)
TILES = {448: (8, 4, 3, 112), 144: (4, 4, 8, 36), 48: (4, 4, 8, 12)}
FIVE_MODES = ["QPSK", "16-QAM", "64-QAM", "BPSK-ACOUSTIC", "BPSK-NARROW"]
PROFILE_MODES = ["QPSK", "BPSK-ACOUSTIC", "BPSK-NARROW"]


def _tile(mode):
    tabs = profile_tables(mode, "cpu")
    return TILES[min(c for c in TILES if c >= tabs.rx_demod.shape[1])]


def test_model_uses_the_kernels_tile_shapes():
    src = (Path(audio_modem_tpu_torch.__file__).parent / "csrc" / "receive.cu").read_text()
    shapes = {name: tuple(int(v) for v in args.split(","))
              for name, args in re.findall(r"using Tile(\w+) = Tile<([^>]*)>;", src)}
    assert [shapes[n] for n in ("Wide", "Mid", "Narrow")] == [TILES[448], TILES[144], TILES[48]]
    assert all(rm * tm % 4 == 0 for rm, _, tm, _ in TILES.values())  # rows are staged four at a time
    assert int(re.search(r"constexpr int kKC = (\d+);", src).group(1)) == KC
    assert int(re.search(r"constexpr int kFft = (\d+);", src).group(1)) == FFT


@pytest.mark.parametrize("name", PROFILE_MODES)
def test_rx_demod_is_the_padded_pair_of_tables(name):
    mode = MODES[name]
    p = mode.profile
    tabs = profile_tables(mode, "cpu")
    nd, npi = p.num_data_subs, len(p.pilots)
    ncol = 2 * nd + 2 * npi
    assert tabs.rx_demod.dtype == torch.float32 and tabs.rx_demod.is_contiguous()
    assert tabs.rx_demod.shape[0] == p.fft_size == FFT
    assert tabs.rx_demod.shape[1] % DEMOD_COLUMN_MULTIPLE == 0 and 0 <= tabs.rx_demod.shape[1] - ncol < DEMOD_COLUMN_MULTIPLE
    assert tabs.rx_demod.stride(0) * tabs.rx_demod.element_size() % 16 == 0
    assert torch.equal(tabs.rx_demod[:, : 2 * nd], tabs.rx_data)
    assert torch.equal(tabs.rx_demod[:, 2 * nd : ncol], tabs.rx_pilot)
    assert not tabs.rx_demod[:, ncol:].any()
    # kernel B reads its channel off these columns: they are rx_active's
    na = p.num_active_subs
    for pos, re0, im0 in ((tabs.data_pos, 0, nd), (tabs.pilot_pos, 2 * nd, 2 * nd + npi)):
        n = len(pos)
        assert torch.equal(tabs.rx_demod[:, re0 : re0 + n], tabs.rx_active[:, pos.long()])
        assert torch.equal(tabs.rx_demod[:, im0 : im0 + n], tabs.rx_active[:, na + pos.long()])


@pytest.mark.parametrize("name", PROFILE_MODES)
def test_thread_grid_covers_the_tile_once(name):
    """Every (row, column) of the spectrum is written by exactly one
    (thread, r, q); every staged element (tap, row) by exactly one index."""
    mode = MODES[name]
    rm, rn, tm_n, tn_n = _tile(mode)
    mt = rm * tm_n
    p = mode.profile
    ncol = 2 * p.num_data_subs + 2 * len(p.pilots)
    tid = torch.arange(tm_n * tn_n)
    tn, tm = tid % tn_n, tid // tn_n
    r, q = torch.arange(rm), torch.arange(rn)
    rows = (tm[:, None, None] * rm + r[None, :, None]).expand(-1, -1, rn)
    cols = (((q // 4)[None, None, :] * tn_n + tn[:, None, None]) * 4 + (q % 4)[None, None, :]).expand(-1, rm, -1)
    keep = cols < ncol
    hits = torch.zeros(mt, ncol, dtype=torch.int64)
    hits.index_put_((rows[keep], cols[keep]), torch.ones(int(keep.sum()), dtype=torch.int64), accumulate=True)
    assert (hits == 1).all()
    i = torch.arange(mt * FFT // 4)
    staged = torch.zeros(FFT // 4, mt, dtype=torch.int64)
    staged.index_put_((_quad(i), _row(i)), torch.ones_like(i), accumulate=True)
    assert (staged == 1).all()
    # a quarter warp's 16-byte stores fall into 8 different 16-byte bank groups
    slot = (_quad(i) * (mt + 1) + _row(i)).reshape(-1, 8) % 8
    assert (slot.sort(dim=1).values == torch.arange(8)).all()


def _quad(i):
    """Tap quad (taps 4q .. 4q+3) of the tile's staged element i."""
    return ((i >> 5) % (FFT // 32)) * 8 + (i & 7)


def _row(i):
    return ((i >> 5) // (FFT // 32)) * 4 + ((i >> 3) & 3)


def _tile_spectrum(bodies: torch.Tensor, mode, tile) -> torch.Tensor:
    """[rows <= MT, fft] bodies of one tile -> spectrum [rows, ncol] the way
    the kernel forms it: staged in tap quads with zero rows up to MT, the
    table in chunks of KC taps, each thread's block scattered to its columns."""
    rm, rn, tm_n, tn_n = tile
    mt = rm * tm_n
    tabs = profile_tables(mode, "cpu")
    ncol_pad = tabs.rx_demod.shape[1]
    p = mode.profile
    ncol = 2 * p.num_data_subs + 2 * len(p.pilots)
    rows = bodies.shape[0]
    assert rows <= mt
    padded = torch.zeros(mt, FFT)
    padded[:rows] = bodies
    staged = torch.zeros(FFT // 4, mt + 1, 4)
    i = torch.arange(mt * FFT // 4)
    staged[_quad(i), _row(i)] = padded.reshape(mt, FFT // 4, 4)[_row(i), _quad(i)]
    acc = torch.zeros(mt, ncol_pad)
    for c in range(FFT // KC):
        chunk = staged[c * KC // 4 : (c + 1) * KC // 4, :mt]  # [KC / 4, MT, 4] -> [MT, KC]
        acc = acc + chunk.permute(1, 0, 2).reshape(mt, KC) @ tabs.rx_demod[c * KC : (c + 1) * KC]
    spec = torch.full((mt, ncol), float("nan"))
    for tid in range(tm_n * tn_n):
        tn, tm = tid % tn_n, tid // tn_n
        for j in range(rn // 4):
            col = (j * tn_n + tn) * 4
            load = min(col, ncol_pad - 4)  # the clamped column the thread loads
            keep = [q for q in range(4) if col + q < ncol]
            if keep and load == col:
                spec[tm * rm : (tm + 1) * rm, col : col + len(keep)] = acc[tm * rm : (tm + 1) * rm, col : col + len(keep)]
            assert not keep or load == col  # a clamped group owns no column
    assert not spec[:rows].isnan().any()
    return spec[:rows]


def _epilogue(spec, hd, hp, mode) -> torch.Tensor:
    """Spectrum [g, ncol] of data symbols, EQ tables (re, im) at the data and
    pilot bins -> bits [g * nd * bps]: pilot ratios, summed in pilot order."""
    p = mode.profile
    nd, npi = p.num_data_subs, len(p.pilots)
    pr, pi = phy.equalize(spec[:, 2 * nd : 2 * nd + npi], spec[:, 2 * nd + npi :], hp[0], hp[1])
    usable = pr.abs() > 1e-6
    ratio = torch.where(usable, pi / torch.where(usable, pr, 1.0), 0.0)
    total = torch.zeros(spec.shape[0])
    for j in range(npi):
        total = torch.where(usable[:, j], total + ratio[:, j], total)
    cnt = usable.sum(-1)
    phi = torch.where(cnt > 0, total / torch.clamp(cnt, min=1), 0.0)[:, None]
    dr, di = phy.equalize(spec[:, :nd], spec[:, nd : 2 * nd], hd[0], hd[1])
    return con.demap(mode.constellation, dr + di * phi, di - dr * phi).reshape(-1)


def _tiled_demod(rows_of, n_sym: int, mode, ch=None, ce_body=None) -> torch.Tensor:
    """One stream through the tiles. ``rows_of(k0, g)`` gives the [g, fft]
    bodies of data symbols k0 .. k0+g-1. With ``ch`` (re, im) [n_active] the
    channel is given (kernel A's stage 6, the streaming demod); with
    ``ce_body`` [fft] every tile carries the CE body in row 0 (kernel B)."""
    tile = _tile(mode)
    mt = tile[0] * tile[2]
    tabs = profile_tables(mode, "cpu")
    r0 = 0 if ce_body is None else 1
    out = []
    for k0 in range(0, n_sym, mt - r0):
        g = min(mt - r0, n_sym - k0)
        bodies = rows_of(k0, g)
        if ce_body is not None:
            bodies = torch.cat([ce_body[None], bodies])
        spec = _tile_spectrum(bodies, mode, tile)
        if ce_body is None:
            h = ch
        else:
            p = mode.profile
            nd, npi = p.num_data_subs, len(p.pilots)
            y = torch.zeros(2, p.num_active_subs)
            y[:, tabs.data_pos.long()] = torch.stack([spec[0, :nd], spec[0, nd : 2 * nd]])
            y[:, tabs.pilot_pos.long()] = torch.stack([spec[0, 2 * nd : 2 * nd + npi], spec[0, 2 * nd + npi :]])
            h = (y[0] * tabs.ce_known, y[1] * tabs.ce_known)
        hd = (h[0][tabs.data_pos.long()], h[1][tabs.data_pos.long()])
        hp = (h[0][tabs.pilot_pos.long()], h[1][tabs.pilot_pos.long()])
        out.append(_epilogue(spec[r0:], hd, hp, mode))
    return torch.cat(out).to(torch.int8)


def _frames(mode, b: int, n_sym: int, seed: int) -> torch.Tensor:
    """[b, (3 + n_sym) * sym] frames: header, n_sym random data symbols, a
    per-frame gain, a two-tap echo and noise."""
    p = mode.profile
    rng = np.random.default_rng(seed)
    bits = torch.from_numpy(rng.integers(0, 2, (b, n_sym * con.bits_per_symbol(mode))).astype(np.int8))
    data = phy.modulate(bits, mode).reshape(b, -1)
    x = torch.cat([profile_tables(mode, "cpu").header.expand(b, -1), data], dim=1).numpy()
    x = x + 0.3 * np.roll(x, 5, axis=1)
    x = x * rng.uniform(0.2, 3.0, (b, 1)) + 0.01 * rng.standard_normal(x.shape)
    return torch.from_numpy(x.astype(np.float32))


CASES = [(name, n_sym, b) for name in FIVE_MODES for n_sym in (1, 7, 8, 9, 41) for b in (1, 3)]
CASES += [("BPSK-NARROW", 598, 1), ("BPSK-NARROW", 598, 3)]


@pytest.mark.parametrize("name, n_sym, b", CASES)
def test_tiled_demod_matches_demodulate(name, n_sym, b):
    """The tile with a given channel (kernel A's stage 6 and the streaming
    demod, rows scaled as StreamSrc scales them) against phy.demodulate."""
    mode = MODES[name]
    p = mode.profile
    sym = p.symbol_len
    frames = _frames(mode, b, n_sym, seed=n_sym + 100 * b)
    scale = torch.from_numpy(np.random.default_rng(7).uniform(0.5, 2.0, b).astype(np.float32))
    ch_re, ch_im = phy.estimate_channel(frames[:, 2 * sym : 3 * sym] * scale[:, None], p)
    data = frames[:, 3 * sym :]
    want = receive.stream_demod_reference(data, ch_re, ch_im, scale, mode, n_sym)
    assert torch.equal(want, phy.demodulate((data * scale[:, None]).reshape(b, n_sym, sym), ch_re, ch_im, mode))
    for i in range(b):
        symbols = (data[i] * scale[i]).reshape(n_sym, sym)
        got = _tiled_demod(lambda k0, g: symbols[k0 : k0 + g, p.cp_len :], n_sym, mode, ch=(ch_re[i], ch_im[i]))
        assert torch.equal(got, want[i]), (name, n_sym, i, int((got != want[i]).sum()))


CE_CASES = [(name, n_sym) for name in FIVE_MODES for n_sym in (1, 23, 24, 41)] + [("BPSK-NARROW", 598)]


@pytest.mark.parametrize("name, n_sym", CE_CASES)
def test_tiled_demod_with_ce_row_matches_chunk_reference(name, n_sym):
    """Kernel B's tiles (peak scale by division, the CE body in row 0 of
    every tile, a frame shorter than its symbols read as zeros) against
    decode_chunks_fused_reference."""
    mode = MODES[name]
    p = mode.profile
    sym = p.symbol_len
    frames = _frames(mode, 2, n_sym, seed=3 + n_sym)
    frames = frames[:, : frames.shape[1] - sym // 3]  # the last symbol's tail is missing
    want = receive.decode_chunks_fused_reference(frames, mode, n_sym)
    for i in range(frames.shape[0]):
        x = frames[i] / frames[i].abs().max()
        x = torch.nn.functional.pad(x, (0, (3 + n_sym) * sym - x.shape[0]))
        symbols = x[3 * sym :].reshape(n_sym, sym)
        got = _tiled_demod(lambda k0, g: symbols[k0 : k0 + g, p.cp_len :], n_sym, mode,
                           ce_body=x[2 * sym + p.cp_len : 3 * sym])
        assert torch.equal(got, want[i]), (name, n_sym, i, int((got != want[i]).sum()))
