// Receive kernels for Hopper (sm_90a): the full per-stream receive (kernel A),
// the cadence-predicted slots of a turbo round (kernel C), the frame-aligned
// chunk demod (kernel B), the streaming demod of a data region whose
// channel is already known, and the one-shot decoder's tail after kernel A
// (vote, byte pack and |H| into one row a stream), with a plain C interface
// for ctypes (see kernels/_build.py). A is a pipeline of six launches gridded
// over (tiles or symbol tiles, streams); C five (A's first two, a slot chain a
// stream, the demod over (symbol tiles, slots, streams), the pack); B is two
// launches (peak; CE and demod) gridded over (chunks or symbol tiles,
// frames); the streaming demod one CTA per (symbol tile, stream); the tail
// one launch over (byte tiles, streams).
//
// All four end in the same demod (per symbol: DFT at the data and pilot
// bins, ZF EQ, pilot phase, hard demap, int8 bits). A, B and the streaming
// demod take the DFT as a register-blocked product against the table
// rx_demod (demod_tile); C as a 512-point real FFT in shared memory
// (fft_demod_tile), 40x fewer operations than the product. Both tiles end in
// one epilogue (demod_epilogue), so EQ, pilot phase, demap and bit layout
// round the same way in all four.
// Everything is float32. Where a sum decides the coarse
// sync (preprocess mean, scan block and window sums) the order of additions
// is the one the plain PyTorch version (sync.py) uses, and the arithmetic
// goes through the _rn intrinsics so nvcc cannot contract it into FMAs: the
// kernel reproduces the plain coarse index and metric bit for bit.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreadsA = 1024;  // kernel A's per-lane and per-stream stages
constexpr int kThreadsPeak = 256;  // kernel B's peak: one CTA per (chunk of a frame, frame)
constexpr int kPeakChunk = 4096;   // samples per peak CTA
constexpr int kFft = 512;        // DFT size of every profile
constexpr int kSumLanes = 1024;  // sync.SUM_LANES
constexpr int kStride = 16;      // sync.COARSE_STRIDE
constexpr int kHalfBlocks = 16;  // (kFft / 2) / kStride
constexpr int kMaxSym = 768;     // longest symbol of any profile (narrowband)
constexpr int kMaxCp = 256;      // longest cyclic prefix of any profile
// A staged span of samples: kernel C's prefetch superset of the next slot's
// refine region at cp = 256 (12 cp + sym samples), plus 3 of alignment in
// front and the 7 that the refine's last float4 reads reach past the region.
constexpr int kSpanFloats = 12 * kMaxCp + kMaxSym + 12;
static_assert(kFft == 2 * kHalfBlocks * kStride, "the scan's window is half a DFT");
constexpr int kKC = 16;          // taps per staged chunk of the demod table
static_assert(kFft % kKC == 0 && kKC % 4 == 0, "the taps are whole chunks of whole quads");
constexpr int kStages = 3;       // chunks of the demod table in flight per CTA
constexpr float kAutocorrThreshold = 0.5f;
constexpr float kMinEnergy = 0.01f;
constexpr float kXcorrThreshold = 0.1f;
constexpr float kXcorrMinDenom = 0.001f;

struct Demod {
  const float* rx_active;  // [fft, 2*n_active]
  const float* ce_known;   // [n_active]
  const float* rx_demod;   // [fft, ncol_pad]: data cos | -sin, pilot cos | -sin, zero columns
  const int* data_pos;     // [nd]
  const int* pilot_pos;    // [npi]
  int fft, cp, n_active, nd, npi, ncol_pad, bps;
  float qam_scale;
  const int* bins;         // [nd + npi]: the DFT bin of each data, then pilot, column (FFT tile only)
  const float* twiddle;    // [fft][2]: cos | -sin of 2 pi k / fft (FFT tile only)
};

// ---- block reductions (blockDim.x a multiple of 32, at most 1024) ----

__device__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_max(lane < nw ? red[lane] : -INFINITY);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  const float r = red[32];
  __syncthreads();
  return r;
}

__device__ int block_min(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_min(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_min(lane < nw ? red[lane] : INT_MAX);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  const int r = red[32];
  __syncthreads();
  return r;
}

// ---- shared demod ----

// One-tap ZF EQ with passthrough where |H|^2 <= 1e-10 (phy.equalize). The
// division stays per bin so it rounds like the plain version; |H|^2 and the
// passthrough flag are computed once per frame.
__device__ void equalize(float sr, float si, float hr, float hi, float den, bool ok,
                         float& er, float& ei) {
  if (ok) {
    er = __fdiv_rn(__fadd_rn(__fmul_rn(sr, hr), __fmul_rn(si, hi)), den);
    ei = __fdiv_rn(__fsub_rn(__fmul_rn(si, hr), __fmul_rn(sr, hi)), den);
  } else {
    er = sr;
    ei = si;
  }
}

// Nearest level index on one square-QAM axis, Gray code inverted to bits
// (ops.constellations.demap; rintf rounds half to even like torch.round).
__device__ int qam_axis_bits(float x, float scale, int bpa) {
  const int top = (1 << bpa) - 1;
  float g = rintf(__fmul_rn(__fadd_rn(__fdiv_rn(x, scale), (float)top), 0.5f));
  g = fminf(fmaxf(g, 0.0f), (float)top);
  int b = (int)g;
  for (int shift = 1; shift < bpa; shift <<= 1) b ^= b >> shift;
  return b;
}

__device__ int demap_index(float cr, float ci, int bps, float scale) {
  if (bps == 1) return cr < 0.0f;
  if (bps == 2) {
    const int b0 = ci < 0.0f;
    return (b0 << 1) | (b0 ^ (cr < 0.0f));
  }
  const int bpa = bps / 2;
  return (qam_axis_bits(ci, scale, bpa) << bpa) | qam_axis_bits(cr, scale, bpa);
}

// ---- the demod tile ----
//
// The DFT of a tile of symbols at the data and pilot bins is the product
// [MT, fft] x [fft, ncol_pad] against the padded table rx_demod, in float32
// on the CUDA cores (the tensor cores round differently). What bounds it on
// the H100: FMA rate. 2 * fft * ncol flops per symbol (0.45 MFLOP on the
// standard profile) make the byte bound of chip_smoke.py irrelevant here:
// the launches reach 17-31% of the fp32 peak (tools/profile_torch_receive.py
// prints their times beside torch.matmul's for the same product). With
// clock64 around the tile's phases, the multiply is most of a CTA's time,
// the table's chunks arrive before they are waited for, and staging and
// epilogue, which nothing overlaps when an SM holds one CTA, take the
// rest. The design is a register-blocked product:
//   - a CTA owns MT = RM * TM symbols of one stream and all columns (the
//     epilogue needs a symbol's pilots before its data), on a TM x TN grid
//     of threads, each with RM x RN accumulators: a tap costs a thread
//     (RM + RN) / 4 16-byte shared loads for RM * RN FMAs. More warps beat
//     larger blocks at every width that was tried (8x8 blocks on half the
//     threads, a two-dimensional warp layout and explicit operand prefetch
//     were all slower or equal), so the blocks are 8x4 and 4x4;
//   - the bodies are staged once, in quads of 4 taps ([fft / 4][MT + 1]
//     float4), so a tap quad of a row is one 16-byte load that a warp reads
//     as a broadcast, and one 16-byte copy in; the odd stride keeps the
//     staging stores (8 quads x 4 rows per warp) free of bank conflicts. The
//     raw samples come by cp.async, the whole tile in flight at once (a CTA
//     has too few threads to hide the loads' latency behind registers; 16
//     plain loads a thread ahead of their stores measured slower), and each
//     thread then normalizes its own samples in place (the source's map);
//   - the table arrives in chunks of kKC taps by 16-byte cp.async, kStages
//     chunks in flight, so the next chunk loads while this one is multiplied;
//     a thread's float4 columns are (j * TN + tn) * 4, neighbouring threads
//     on neighbouring 16 bytes, free of bank conflicts.
// Each spectrum element stays one chain of fmaf over the taps 0 .. fft-1 in
// order from 0 (a thread keeps its accumulators across the chunks), and the
// epilogue keeps phy.demodulate's operations, so the bits do not depend on
// the tiling. The thread grid follows the profile's column count: 448, 144
// and 48 padded columns (standard, acoustic, narrowband) each get a tile
// whose threads all own columns. The standard tile is 24 symbols high: the
// 41 symbols of a 2048-byte QPSK chunk are two tiles (24 + 17, or with
// kernel B's CE row 23 + 18), 128 CTAs for 64 streams on 132 SMs, where 32
// rows would make the taller tile a third longer and 16 rows three tiles.

template <int RM_, int RN_, int TM_, int TN_>
struct Tile {
  static constexpr int RM = RM_, RN = RN_, TM = TM_, TN = TN_;
  static constexpr int kMT = RM * TM;        // symbols per tile
  static constexpr int kCols = RN * TN;      // columns the thread grid covers
  static constexpr int kThreads = TM * TN;
  static constexpr int kLdb = kMT + 1;       // float4 between two tap quads of the staged bodies (odd)
  static_assert(RM % 4 == 0 && RN % 4 == 0, "rows and columns of a thread are float4 groups");
  static_assert(kThreads >= kMT, "the pilot phase takes one thread per symbol");
  static_assert(kMT % 4 == 0 && kLdb % 2 == 1, "rows are staged four at a time, free of bank conflicts");
  static_assert(kMT <= kStages * kKC, "the pilots' ratios of a tile fit in the table's stages");
};
using TileWide = Tile<8, 4, 3, 112>;   // 24 symbols x 448 columns (standard profile: 442)
using TileMid = Tile<4, 4, 8, 36>;     // 32 symbols x 144 columns (acoustic: 142)
using TileNarrow = Tile<4, 4, 8, 12>;  // 32 symbols x 48 columns (narrowband: 48)

// The tile's shared-memory regions, carved from one dynamic buffer of
// tile_smem_floats<Cfg>(d) floats; body and tab start on 16 bytes.
struct TileSmem {
  float* hd;    // [3*nd]: re | im | den (0 = passthrough)
  float* hp;    // [3*npi]
  float* phi;   // [kMT]
  float* body;  // [fft / 4][kLdb] float4: 4 taps of a row; after the product the spectrum [kMT][ncol]
  float* tab;   // [kStages][kKC][ncol_pad]
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

template <class Cfg>
__host__ __device__ int tile_smem_floats(const Demod& d) {
  return round4(3 * d.nd + 3 * d.npi + Cfg::kMT) + kFft * Cfg::kLdb + kStages * kKC * d.ncol_pad;
}

template <class Cfg>
__device__ TileSmem carve(const Demod& d, float* smem) {
  TileSmem s;
  s.hd = smem;
  s.hp = s.hd + 3 * d.nd;
  s.phi = s.hp + 3 * d.npi;
  s.body = smem + round4(3 * d.nd + 3 * d.npi + Cfg::kMT);
  s.tab = s.body + kFft * Cfg::kLdb;
  return s;
}

__device__ __forceinline__ void cp_async4(void* dst_shared, const void* src_global) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(dst_shared);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src_global) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst_shared, const void* src_global) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(dst_shared);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src_global) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Taps [c*kKC, (c+1)*kKC) of rx_demod (contiguous rows) into their stage of
// s.tab; one commit group per call, empty past the last chunk.
template <class Cfg>
__device__ __forceinline__ void stage_table_chunk(const Demod& d, const TileSmem& s, int c) {
  const int chunk = kKC * d.ncol_pad;
  if (c * kKC < kFft) {
    const float4* src = reinterpret_cast<const float4*>(d.rx_demod + (size_t)c * chunk);
    float4* dst = reinterpret_cast<float4*>(s.tab + (c % kStages) * chunk);
    for (int i = threadIdx.x; i < chunk / 4; i += Cfg::kThreads) cp_async16(dst + i, src + i);
  }
  cp_async_commit();
}

// One entry of the EQ tables hd [3*nd] and hp [3*npi] (re | im | den): H,
// and |H|^2 with 0 marking passthrough (|H|^2 <= 1e-10), for data bin j
// (j < nd) or pilot bin j - nd.
__device__ __forceinline__ void put_eq(const Demod& d, float* hd, float* hp, int j, float hr, float hi) {
  const bool data = j < d.nd;
  const float mag = __fadd_rn(__fmul_rn(hr, hr), __fmul_rn(hi, hi));
  float* h = data ? hd : hp;
  const int m = data ? d.nd : d.npi, i = data ? j : j - d.nd;
  h[i] = hr;
  h[m + i] = hi;
  h[2 * m + i] = mag > 1e-10f ? mag : 0.0f;
}

// EQ tables from the stream's active-bin channel (ch_re, ch_im [n_active],
// global). The caller synchronizes before reading them.
__device__ void eq_tables(const Demod& d, float* hd, float* hp, const float* ch_re, const float* ch_im) {
  for (int j = threadIdx.x; j < d.nd + d.npi; j += blockDim.x) {
    const int pos = j < d.nd ? d.data_pos[j] : d.pilot_pos[j - d.nd];
    put_eq(d, hd, hp, j, ch_re[pos], ch_im[pos]);
  }
}

// EQ tables from the spectrum of the CE body (``ce`` [ncol]: data re | im,
// pilot re | im): H = Y * known sign (phy.estimate_channel). rx_demod's
// columns are rx_active's at the data and pilot positions, so in the product
// tile Y is bit for bit channel_estimate's.
__device__ void eq_tables_from_ce(const Demod& d, float* hd, float* hp, const float* ce) {
  const int nd = d.nd, npi = d.npi;
  for (int j = threadIdx.x; j < nd + npi; j += blockDim.x) {
    const bool data = j < nd;
    const float known = d.ce_known[data ? d.data_pos[j] : d.pilot_pos[j - nd]];
    const float* y = data ? ce + j : ce + 2 * nd + (j - nd);
    put_eq(d, hd, hp, j, __fmul_rn(y[0], known), __fmul_rn(y[data ? nd : npi], known));
  }
}

// One bin's bits, MSB first (phy.demodulate's order), as the widest stores
// the bin's offset allows: ``out`` lies a multiple of bps bytes from a
// 4-byte aligned base.
__device__ __forceinline__ void store_bits(signed char* out, int idx, int bps) {
  if (bps == 1) {
    out[0] = (signed char)(idx & 1);
  } else if ((bps & 3) == 0) {
    for (int b = 0; b < bps; b += 4) {
      const int v = idx >> (bps - 4 - b);
      *reinterpret_cast<uint32_t*>(out + b) =
          ((v >> 3) & 1) | (((v >> 2) & 1) << 8) | (((v >> 1) & 1) << 16) | ((v & 1) << 24);
    }
  } else if ((bps & 1) == 0) {
    for (int b = 0; b < bps; b += 2) {
      const int v = idx >> (bps - 2 - b);
      *reinterpret_cast<uint16_t*>(out + b) = (uint16_t)(((v >> 1) & 1) | ((v & 1) << 8));
    }
  } else {
    for (int b = 0; b < bps; ++b) out[b] = (signed char)((idx >> (bps - 1 - b)) & 1);
  }
}

// Element (k, j) = i / n, i % n of a flat loop i = tid, tid + NT, ... over
// [rows][n], stepped without a division a step.
template <int NT>
struct Walk {
  int k, j;
  const int n, dk, dj;
  __device__ explicit Walk(int n_) : k(threadIdx.x / n_), j(threadIdx.x % n_), n(n_), dk(NT / n_), dj(NT % n_) {}
  __device__ void next() {
    j += dj;
    k += dk;
    if (j >= n) j -= n, ++k;
  }
};

// The demod's epilogue, one body for the product tile and the FFT tile: the
// spectra of data symbols k0 .. k0+g-1 (row k at spec + k*ld: data re | data
// im | pilot re | pilot im) and the EQ tables hd, hp (put_eq) -> pilot phase
// (mean of Im/Re over the equalized pilots with |Re| > 1e-6), ZF EQ, the
// rotation, hard demap and int8 bits, in phy.demodulate's operations. Every
// pilot's ratio in parallel into ``ratio`` and ``usable`` (g * npi floats
// each), then one thread per symbol adds them in pilot order into ``phi``
// (g floats; NT >= g). The caller synchronizes after writing spec and the
// tables. ``bits`` is the row's first bit (4-byte aligned); bits go out
// bin-major, MSB first within a bin.
template <int NT>
__device__ void demod_epilogue(const Demod& d, const float* spec, int ld, const float* __restrict__ hd,
                               const float* __restrict__ hp, float* phi, float* __restrict__ ratio,
                               float* __restrict__ usable, int k0, int g, signed char* __restrict__ bits) {
  const int tid = threadIdx.x, nd = d.nd, npi = d.npi, bps = d.bps;
  for (Walk<NT> w(npi); w.k < g; w.next()) {
    const int k = w.k, j = w.j, i = k * npi + j;
    const float* sp = spec + k * ld + 2 * nd;
    float pr, pi;
    equalize(sp[j], sp[npi + j], hp[j], hp[npi + j], hp[2 * npi + j], hp[2 * npi + j] > 0.0f, pr, pi);
    const bool ok = fabsf(pr) > 1e-6f;
    ratio[i] = ok ? __fdiv_rn(pi, pr) : 0.0f;
    usable[i] = ok ? 1.0f : 0.0f;
  }
  __syncthreads();
  if (tid < g) {
    float sum = 0.0f;
    int cnt = 0;
    for (int j = 0; j < npi; ++j)
      if (usable[tid * npi + j] != 0.0f) {
        sum = __fadd_rn(sum, ratio[tid * npi + j]);
        ++cnt;
      }
    phi[tid] = cnt > 0 ? __fdiv_rn(sum, (float)cnt) : 0.0f;
  }
  __syncthreads();
#pragma unroll 4
  for (Walk<NT> w(nd); w.k < g; w.next()) {
    const int k = w.k, j = w.j;
    const float* __restrict__ sp = spec + k * ld;
    float dr, di;
    equalize(sp[j], sp[nd + j], hd[j], hd[nd + j], hd[2 * nd + j], hd[2 * nd + j] > 0.0f, dr, di);
    const float p = phi[k];
    const float cr = __fadd_rn(dr, __fmul_rn(di, p));
    const float ci = __fsub_rn(di, __fmul_rn(dr, p));
    store_bits(bits + ((size_t)(k0 + k) * nd + j) * bps, demap_index(cr, ci, bps, d.qam_scale), bps);
  }
}

// Data symbols k0 .. k0+g-1 (the ragged last tile of a row is masked, its
// missing bodies are zeros) of one stream, symbol k's CP at data_base +
// k*sym of sample source ``src`` (sample i is src.map(src.x[i]) where
// src.has(i), else 0): DFT at the data and pilot bins, pilot phase, ZF EQ,
// demap, int8 bits. The channel is the stream's (``ch_re``, ``ch_im``
// [n_active], g <= Cfg::kMT) or, where CE, estimated by the tile itself: its
// row 0 is then the CE body, the fft samples from ``ce_pos``, and g <=
// Cfg::kMT - 1. ``bits`` is the row's first bit (4-byte aligned); bits go out
// bin-major, MSB first within a bin.
template <class Cfg, bool CE, class Src>
__device__ void demod_tile(const Src& src, int data_base, int ce_pos, const Demod& d,
                           const float* ch_re, const float* ch_im, int k0, int g,
                           signed char* __restrict__ bits, float* smem) {
  constexpr int RM = Cfg::RM, RN = Cfg::RN, MT = Cfg::kMT, LDB = Cfg::kLdb, NT = Cfg::kThreads;
  constexpr int R0 = CE ? 1 : 0;  // the tile's row of data symbol k0
  const int rows = g + R0;
  const int tid = threadIdx.x, tn = tid % Cfg::TN, tm = tid / Cfg::TN;
  const int nd = d.nd, npi = d.npi, ncol_pad = d.ncol_pad;
  const int sym = kFft + d.cp;
  const int ncol = 2 * nd + 2 * npi;
  const TileSmem s = carve<Cfg>(d, smem);

  // raw bodies, CP skipped, in quads of 4 taps: a warp takes 8 quads of 4
  // rows at a time (128-byte runs of samples in, conflict-free 16-byte
  // stores out, LDB being odd); quad i of the tile is taps 4*qd .. 4*qd+3 of
  // row m. A quad that lies whole and 16-byte aligned in its row comes by one
  // 16-byte cp.async (every row of a frame-aligned batch or of a region the
  // decoder cut is so aligned; a receive window's rows start anywhere), any
  // other by 4-byte copies, which move only about a sample a cycle per SM.
  const int first = data_base + k0 * sym + d.cp;
  auto quad = [](int i) { return ((i >> 5) % (kFft / 32)) * 8 + (i & 7); };
  auto row = [](int i) { return ((i >> 5) / (kFft / 32)) * 4 + ((i >> 3) & 3); };
  auto sample = [=](int m, int qd) { return (CE && m == 0 ? ce_pos : first + (m - R0) * sym) + 4 * qd; };
  for (int i = tid; i < MT * (kFft / 4); i += NT) {
    const int qd = quad(i), m = row(i), pos = sample(m, qd);
    float* dst = s.body + (qd * LDB + m) * 4;
    const bool live = m < rows;
    if (live && src.has(pos) && src.has(pos + 3) && (reinterpret_cast<uintptr_t>(src.x + pos) & 15) == 0) {
      cp_async16(dst, src.x + pos);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (live && src.has(pos + e))
          cp_async4(dst + e, src.x + pos + e);
        else
          dst[e] = 0.0f;
      }
    }
  }
  cp_async_commit();
  for (int c = 0; c < kStages - 1; ++c) stage_table_chunk<Cfg>(d, s, c);
  if (!CE) eq_tables(d, s.hd, s.hp, ch_re, ch_im);
  cp_async_wait<kStages - 1>();  // this thread's samples have landed: normalize them in place
  for (int i = tid; i < MT * (kFft / 4); i += NT) {
    const int qd = quad(i), m = row(i), pos = sample(m, qd);
    if (m >= rows) continue;
    float4* at = reinterpret_cast<float4*>(s.body + (qd * LDB + m) * 4);
    float4 v = *at;
    if (src.has(pos)) v.x = src.map(v.x);
    if (src.has(pos + 1)) v.y = src.map(v.y);
    if (src.has(pos + 2)) v.z = src.map(v.z);
    if (src.has(pos + 3)) v.w = src.map(v.w);
    *at = v;
  }

  int col[RN / 4];  // the thread's float4 column groups, clamped into the table
#pragma unroll
  for (int j = 0; j < RN / 4; ++j) col[j] = min((j * Cfg::TN + tn) * 4, ncol_pad - 4);
  float acc[RM][RN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int q = 0; q < RN; ++q) acc[r][q] = 0.0f;

  for (int c = 0; c * kKC < kFft; ++c) {
    cp_async_wait<kStages - 2>();  // this thread's share of chunk c has landed
    __syncthreads();               // everyone's has, chunk c-1's stage is free; at c = 0 the bodies and EQ tables are whole
    stage_table_chunk<Cfg>(d, s, c + kStages - 1);
    const float* tab = s.tab + (c % kStages) * kKC * ncol_pad;
    const float4* body = reinterpret_cast<const float4*>(s.body) + c * (kKC / 4) * LDB + tm * RM;
#pragma unroll
    for (int kq = 0; kq < kKC / 4; ++kq) {
      float4 x[RM];  // taps 4*kq .. 4*kq+3 of the thread's rows
#pragma unroll
      for (int r = 0; r < RM; ++r) x[r] = body[kq * LDB + r];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float t[RN];
#pragma unroll
        for (int j = 0; j < RN / 4; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(tab + (4 * kq + e) * ncol_pad + col[j]);
          t[4 * j] = v.x, t[4 * j + 1] = v.y, t[4 * j + 2] = v.z, t[4 * j + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float xr = e == 0 ? x[r].x : e == 1 ? x[r].y : e == 2 ? x[r].z : x[r].w;
#pragma unroll
          for (int q = 0; q < RN; ++q) acc[r][q] = fmaf(xr, t[q], acc[r][q]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the bodies are read; the spectrum takes their place
  float* spec = s.body;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int m = tm * RM + r;
#pragma unroll
    for (int q = 0; q < RN; ++q) {
      const int cc = ((q / 4) * Cfg::TN + tn) * 4 + (q & 3);
      if (m < rows && cc < ncol) spec[m * ncol + cc] = acc[r][q];
    }
  }
  __syncthreads();
  if (CE) {
    eq_tables_from_ce(d, s.hd, s.hp, spec);
    __syncthreads();
  }
  // data symbol k0's spectrum on; the table's stages are free for the pilots' ratios
  demod_epilogue<NT>(d, spec + R0 * ncol, ncol, s.hd, s.hp, s.phi, s.tab, s.tab + MT * npi, k0, g, bits);
}

// ---- the FFT tile ----
//
// The DFT of a tile's symbols as a 512-point real FFT per row in shared
// memory, for kernel C. What bounds it on the H100: on paper bytes. A
// 512-point real FFT is ~11.5 k flops where the product tile's DFT is 2 *
// 512 * 448 (0.46 M), so the tile's floor is the read of its bodies (the
// turbo round's 2,048 slots x 42 rows: 172 MB, 51 us at 3.35 TB/s), not the
// FMA rate. In practice the staging alone runs near the memory rate, and
// the FFT and the epilogue (two IEEE divisions a point) set the time: they
// are latency-bound at 24 warps an SM, two CTAs of 384 threads (shared
// memory allows two CTAs; at 80 registers a thread, 384 threads beat 256,
// 352 and 448, and 512 with the twiddles read at each use). The design:
//   - a CTA owns one (stream, slot) and up to kFftRows - 1 of its data
//     symbols (a 2048-byte QPSK chunk's 41 in one CTA); its row 0 is the CE
//     body at start + 2*sym + cp, as kernel B's tile has a CE row, so the EQ
//     tables come from the tile's own spectrum and no channel goes through
//     device memory;
//   - every row's 512-sample body comes by 16-byte cp.async from the aligned
//     address at or below its first sample (the rows of a slot share their
//     misalignment a, since sym is a multiple of 4), the whole tile in flight
//     at once, 0 past n_valid and T; the FFT's first read applies the
//     source's map. Row m lies at m * kFftLd floats, its body at + a;
//   - 16 threads a row, 24 rows at a time: the body packed as 256 complex
//     points z[n] = x[2n] + i x[2n+1], a 16 x 16 complex FFT (thread n2 takes
//     the 16-point DFT of z[16 n1 + n2] in registers, twiddles W256^(n2 k1),
//     a transpose through shared memory at a pitch of 17 complex, thread k1
//     the second 16-point DFT), each 16-point DFT a radix-4 pair. Then the
//     real split at the data and pilot bins only: X[b] = (Z[b] + conj
//     Z[256-b]) / 2 - i W512^b (Z[b] - conj Z[256-b]) / 2, the forward sign
//     and no scale, as rx_demod's columns (cos | -sin) hold. The twiddles
//     are Demod::twiddle, built on the host in float64 and rounded once;
//   - the spectrum lands in the row's own memory (the layout the product
//     tile gives), the EQ tables come from row 0 (eq_tables_from_ce), and
//     demod_epilogue does the rest.
// The FFT rounds differently from the product, at the 1e-7 level of the
// spectrum: the bits equal the plain version's wherever no point lies that
// close to a decision boundary.

constexpr int kFftRows = 42;     // rows per FFT tile: the CE row and up to 41 data symbols
constexpr int kThreadsFft = 384;  // 24 rows at a time, 16 threads a row (42 rows: 24 + 18)
constexpr int kFftLd = 544;      // floats a row: the body (512 + a) and the FFT's 16 x 17 complex
static_assert(kFftLd % 4 == 0 && kFftLd >= 2 * 16 * 17 && kFftLd >= kFft + 4, "a row holds its body and the FFT");
static_assert(kThreadsFft >= kFftRows, "the pilot phase takes one thread per symbol");
static_assert(kThreadsFft % 32 == 0, "a row's 16 threads are half of a whole warp (__syncwarp)");
static_assert(kFft == 2 * 16 * 16, "the plan is a 16 x 16 complex FFT of the packed 512-sample body");

__host__ __device__ inline int fft_smem_floats(const Demod& d) {
  return kFftRows * kFftLd + round4(3 * d.nd + 3 * d.npi + kFftRows + 2 * kFftRows * d.npi);
}

// A 4-point DFT, forward sign, of elements I0, I0+S, I0+2S, I0+3S, in place.
template <int I0, int S>
__device__ __forceinline__ void dft4(float (&re)[16], float (&im)[16]) {
  const float ar = re[I0] + re[I0 + 2 * S], ai = im[I0] + im[I0 + 2 * S];
  const float br = re[I0] - re[I0 + 2 * S], bi = im[I0] - im[I0 + 2 * S];
  const float cr = re[I0 + S] + re[I0 + 3 * S], ci = im[I0 + S] + im[I0 + 3 * S];
  const float dr = re[I0 + S] - re[I0 + 3 * S], di = im[I0 + S] - im[I0 + 3 * S];
  re[I0] = ar + cr, im[I0] = ai + ci;
  re[I0 + S] = br + di, im[I0 + S] = bi - dr;  // b - i d
  re[I0 + 2 * S] = ar - cr, im[I0 + 2 * S] = ai - ci;
  re[I0 + 3 * S] = br - di, im[I0 + 3 * S] = bi + dr;  // b + i d
}

__device__ __forceinline__ void cmul(float& re, float& im, float2 w) {
  const float r = re * w.x - im * w.y;
  im = re * w.y + im * w.x;
  re = r;
}

// A 16-point DFT, forward sign, of a[n] in place: n = 4 m1 + m2, DFT4 over
// m1, twiddles W16^(m2 l1) (w16[e] = W16^e), DFT4 over m2. Bin k = l1 + 4 l2
// ends at index 4 (k % 4) + k / 4.
__device__ __forceinline__ void dft16(float (&re)[16], float (&im)[16], const float2 (&w16)[10]) {
  dft4<0, 4>(re, im);
  dft4<1, 4>(re, im);
  dft4<2, 4>(re, im);
  dft4<3, 4>(re, im);
#pragma unroll
  for (int m2 = 1; m2 < 4; ++m2)
#pragma unroll
    for (int l1 = 1; l1 < 4; ++l1) cmul(re[m2 + 4 * l1], im[m2 + 4 * l1], w16[m2 * l1]);
  dft4<0, 1>(re, im);
  dft4<4, 1>(re, im);
  dft4<8, 1>(re, im);
  dft4<12, 1>(re, im);
}

// Data symbols k0 .. k0+g-1 (g <= kFftRows - 1) of one stream, symbol k's
// body at data_pos + (k - k0)*sym of sample source ``src`` (sample i is
// src.map(src.x[i]) where src.has(i), else 0), the CE body at ``ce_pos``:
// FFT, EQ tables from the CE row, demod_epilogue. ``bits`` is the row's
// first bit (4-byte aligned).
template <class Src>
__device__ void fft_demod_tile(const Src& src, int ce_pos, int data_pos, const Demod& d, int k0, int g,
                               signed char* __restrict__ bits, float* smem) {
  constexpr int NT = kThreadsFft;
  const int tid = threadIdx.x, rows = g + 1, nd = d.nd, npi = d.npi, nbin = nd + npi;
  const int sym = kFft + d.cp;
  float* hd = smem + kFftRows * kFftLd;
  float* hp = hd + 3 * nd;
  float* phi = hp + 3 * npi;
  float* ratio = phi + kFftRows;
  float* usable = ratio + kFftRows * npi;
  const float2* __restrict__ tw = reinterpret_cast<const float2*>(d.twiddle);

  // bodies in, from the 16-byte aligned sample a before each row's first
  const int a = (int)(((reinterpret_cast<uintptr_t>(src.x) >> 2) + (unsigned)ce_pos) & 3);
  const int nq = (a + kFft + 3) >> 2;  // quads a row
  auto first = [=](int m) { return (m == 0 ? ce_pos : data_pos + (m - 1) * sym) - a; };
  for (Walk<NT> w(nq); w.k < rows; w.next()) {
    const int m = w.k, q = w.j, pos = first(m) + 4 * q;
    float* dst = smem + m * kFftLd + 4 * q;
    if (src.has(pos) && src.has(pos + 3)) {
      cp_async16(dst, src.x + pos);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (src.has(pos + e))
          cp_async4(dst + e, src.x + pos + e);
        else
          dst[e] = 0.0f;
      }
    }
  }
  cp_async_commit();
  float2 w16[10];  // W16^e = W512^(32 e)
#pragma unroll
  for (int e = 0; e < 10; ++e) w16[e] = __ldg(tw + 32 * e);
  cp_async_wait<0>();
  __syncthreads();  // every row has landed, raw: the FFT's first read applies the source's map

  // one FFT per row; a row's 16 threads are one half of a warp, so __syncwarp
  // orders their shared-memory steps, and every thread runs every pass
  const int l16 = tid & 15;
  for (int m0 = 0; m0 < rows; m0 += NT / 16) {
    const int m = m0 + (tid >> 4);
    const bool live = m < rows;
    float* row = smem + (live ? m : 0) * kFftLd;
    float2* row2 = reinterpret_cast<float2*>(row);
    const int p0 = first(live ? m : 0) + a;  // the body's first sample; the map where the source has it
    const bool whole = src.has(p0) && src.has(p0 + kFft - 1);
    float re[16], im[16];
#pragma unroll
    for (int n1 = 0; n1 < 16; ++n1) {  // z[16 n1 + n2] for thread n2
      const int t = 2 * (16 * n1 + l16);
      re[n1] = live && (whole || src.has(p0 + t)) ? src.map(row[a + t]) : 0.0f;
      im[n1] = live && (whole || src.has(p0 + t + 1)) ? src.map(row[a + t + 1]) : 0.0f;
    }
    dft16(re, im, w16);
    __syncwarp();
#pragma unroll
    for (int k1 = 0; k1 < 16; ++k1) {
      const int at = 4 * (k1 & 3) + (k1 >> 2);
      cmul(re[at], im[at], __ldg(tw + 2 * l16 * k1));  // W256^(n2 k1)
      if (live) row2[17 * l16 + k1] = make_float2(re[at], im[at]);
    }
    __syncwarp();
#pragma unroll
    for (int n2 = 0; n2 < 16; ++n2) {  // column k1 = this thread's
      const float2 v = live ? row2[17 * n2 + l16] : make_float2(0.0f, 0.0f);
      re[n2] = v.x, im[n2] = v.y;
    }
    dft16(re, im, w16);
    __syncwarp();
#pragma unroll
    for (int k2 = 0; k2 < 16; ++k2) {  // Z[k1 + 16 k2] in natural order
      const int at = 4 * (k2 & 3) + (k2 >> 2);
      if (live) row2[l16 + 16 * k2] = make_float2(re[at], im[at]);
    }
    __syncwarp();
    // the real split at this thread's bins j = l16 + 16 i, held until the row's Z is read
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = l16 + 16 * i;
      if (live && j < nbin) {
        const int b = __ldg(d.bins + j);
        const float2 zb = row2[b & 255], zc = row2[(256 - b) & 255], w = __ldg(tw + b);
        const float er = 0.5f * (zb.x + zc.x), ei = 0.5f * (zb.y - zc.y);
        const float orr = 0.5f * (zb.y + zc.y), oi = -0.5f * (zb.x - zc.x);
        re[i] = er + (w.x * orr - w.y * oi);
        im[i] = ei + (w.x * oi + w.y * orr);
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = l16 + 16 * i;
      if (live && j < nbin) {
        const bool data = j < nd;
        const int c = data ? j : 2 * nd + (j - nd), m_im = data ? nd : npi;
        row[c] = re[i];
        row[c + m_im] = im[i];
      }
    }
  }
  __syncthreads();
  eq_tables_from_ce(d, hd, hp, smem);
  __syncthreads();
  demod_epilogue<NT>(d, smem + kFftLd, kFftLd, hd, hp, phi, ratio, usable, k0, g, bits);
}

// CE: H = DFT(body) * known sign (phy.estimate_channel) of the fft samples
// of ``src`` from ``pos``, staged in ``body`` (fft floats of shared memory).
// H goes to ``ch_re_out`` and ``ch_im_out`` ([n_active] each, global).
template <class Src>
__device__ void channel_estimate(const Src& src, int pos, const Demod& d, float* body,
                                 float* ch_re_out, float* ch_im_out) {
  const int tid = threadIdx.x, nt = blockDim.x, na = d.n_active;
  for (int n = tid; n < kFft; n += nt) body[n] = src(pos + n);
  __syncthreads();
  for (int c = tid; c < 2 * na; c += nt) {
    float acc = 0.0f;
#pragma unroll 64
    for (int n = 0; n < kFft; ++n) acc = fmaf(body[n], d.rx_active[n * 2 * na + c], acc);
    const float h = __fmul_rn(acc, d.ce_known[c < na ? c : c - na]);
    if (c < na)
      ch_re_out[c] = h;
    else
      ch_im_out[c - na] = h;
  }
}

// ---- kernel A: full receive, a pipeline of six launches ----
//
// Replaces audio_modem_tpu/kernels/receive.py::_receive_kernel (entry
// decode_fused): preprocess, strided Schmidl-Cox scan with first-peak
// commit, +-3*CP xcorr refine, CE, demod, for B streams of T samples.
//
// What bounds it on the H100: bytes from device memory. The window is read
// once in the least: 234 MB at the turbo round's B = 64, T = 914,688, or 70 us
// at 3.35 TB/s. The normalization (x - mean) / max|x - mean| needs the
// stream's global mean before the scan can start, so two reads of the
// window (~140 us) are the practical floor; everything else (metric ~1/16 of
// the window, the refine region, the frame's symbols) is small or stays in L2.
//
// The design makes both passes over the window coalesced streams gridded
// over (tiles, streams), and the demod gridded over (symbol tiles,
// streams), so even one stream fills the card; each stage stays exact:
//   1. pre_stats (tiles of kRowsA rows of kSumLanes, B, lane quarters): per
//      lane a perfect pairwise subtree over the tile's rows, plus max(x) and
//      min(x) of the tile's valid samples. Read 1 of the window.
//   2. combine (B): finishes the tree in tree order over all tiles (padded
//      rows are +0, as in sync.pairwise_row_sum), halves the lanes: the
//      mean, bit for bit. amax = max(0, |fl(xmax - mean)|, |fl(xmin -
//      mean)|) equals max|fl(x - mean)| because fl(x - mean) is monotone in x.
//   3. scan (kScanTile positions, B): the tile's normalized samples and
//      halo in shared memory (read 2), 16-sample block sums in sample order,
//      window16 doubling sums, the metric, and the tile's max.
//   4. commit (kScanTile positions, B): carry-in = max of the earlier
//      tiles' maxima; a block prefix max gives the running max; the tile's
//      first drop goes to an atomicMin. Max is exact in any order, so the
//      first drop equals sync.first_peak_commit's.
//   5. refine_ce (B): best and its first index up to the first drop (full
//      tiles' maxima plus one partial tile), the xcorr refine (refine, on
//      the region staged by stage_span), the CE (channel_estimate).
//   6. demod (symbol tiles, B): demod_tile on the normalized samples at
//      start + 3*sym, EQ tables built per CTA from the CE.
// The normalized sample is recomputed from x wherever it is read, so the
// [B, T] window is never copied.

constexpr int kRowsA = 32;       // rows of kSumLanes per pre_stats tile (power of two)
constexpr int kLaneSplit = 4;    // pre_stats CTAs per tile, each a quarter of the lanes
constexpr int kThreadsPre = kSumLanes / kLaneSplit;
constexpr int kCombineGroup = 8; // tiles loaded together by combine (power of two)
constexpr int kScanTile = 512;   // scan positions per scan / commit CTA
constexpr int kThreadsScan = 256;
constexpr int kScanBlocksE = kScanTile + 2 * kHalfBlocks - 1;  // energy blocks per scan tile
constexpr int kScanBlocksP = kScanTile + kHalfBlocks - 1;      // product blocks per scan tile
constexpr int kScanSamples = kStride * kScanBlocksE;           // samples per scan tile, halo included

// A sample source: sample i of a row is map(x[i]) where has(i), else 0.
struct PreSrc {
  const float* x;
  int T, nv;
  float mean, scale;
  __device__ bool has(int i) const { return i >= 0 && i < nv && i < T; }
  __device__ float map(float v) const { return __fmul_rn(__fsub_rn(v, mean), scale); }
  __device__ float operator()(int i) const { return has(i) ? map(x[i]) : 0.0f; }
};

__device__ PreSrc pre_src(const float* signals, const int* n_valid, const float* stats, int T, int b) {
  return PreSrc{signals + (size_t)b * T, T, n_valid[b], stats[2 * b], stats[2 * b + 1]};
}

__device__ float window16(const float* b) {
  // S16 of sync.windowed_sum: ((b0+b1)+(b2+b3)) + ... balanced over adjacent pairs
  float s2[8], s4[4], s8[2];
  for (int i = 0; i < 8; ++i) s2[i] = __fadd_rn(b[2 * i], b[2 * i + 1]);
  for (int i = 0; i < 4; ++i) s4[i] = __fadd_rn(s2[2 * i], s2[2 * i + 1]);
  for (int i = 0; i < 2; ++i) s8[i] = __fadd_rn(s4[2 * i], s4[2 * i + 1]);
  return __fadd_rn(s8[0], s8[1]);
}

// Inclusive prefix max over the block (blockDim.x a multiple of 32).
__device__ float block_prefix_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = fmaxf(v, u);
  }
  if (lane == 31) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nw ? red[lane] : -INFINITY;
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = fmaxf(w, u);
    }
    red[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = fmaxf(v, red[warp - 1]);
  __syncthreads();
  return v;
}

// 1. lane subtrees and extremes of rows [tile * rows, (tile + 1) * rows), one
// quarter of the lanes per CTA (blockIdx.z), so four CTAs share an SM and
// one's loads overlap another's reductions
__global__ void __launch_bounds__(kThreadsPre)
pre_stats_kernel(const float* __restrict__ signals, const int* __restrict__ n_valid, int T, int rows,
                 float* __restrict__ part, float* __restrict__ tile_mm) {
  __shared__ float redf[33];
  const int tile = blockIdx.x, b = blockIdx.y, n_tiles = gridDim.x;
  const int lane = blockIdx.z * kThreadsPre + threadIdx.x;
  const int nv = min(n_valid[b], T);
  const float* x = signals + (size_t)b * T;
  float v[kRowsA];
  float hi = -INFINITY, lo = INFINITY;
#pragma unroll
  for (int r = 0; r < kRowsA; ++r) {
    const int i = (tile * rows + r) * kSumLanes + lane;
    v[r] = (r < rows && i < nv) ? x[i] : 0.0f;
    if (r < rows && i < nv) {
      hi = fmaxf(hi, v[r]);
      lo = fminf(lo, v[r]);
    }
  }
#pragma unroll
  for (int s = 1; s < kRowsA; s <<= 1) {
    if (s < rows) {
#pragma unroll
      for (int r = 0; r + s < kRowsA; r += 2 * s) v[r] = __fadd_rn(v[r], v[r + s]);
    }
  }
  const size_t t = (size_t)b * n_tiles + tile;
  part[t * kSumLanes + lane] = v[0];
  hi = block_max(hi, redf);
  lo = -block_max(-lo, redf);
  if (threadIdx.x == 0) {
    const size_t q = t * kLaneSplit + blockIdx.z;
    tile_mm[2 * q] = hi;
    tile_mm[2 * q + 1] = lo;
  }
}

// 2. mean and scale per stream; resets the first-drop slot
__global__ void __launch_bounds__(kThreadsA)
combine_kernel(const float* __restrict__ part, const float* __restrict__ tile_mm,
               const int* __restrict__ n_valid, int T, int n_tiles, float* __restrict__ stats,
               int* __restrict__ first_drop) {
  __shared__ float lanes[kSumLanes];
  __shared__ float redf[33];
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* pb = part + (size_t)b * n_tiles * kSumLanes;
  // n_tiles is a power of two: aligned groups of g tiles are subtrees of the
  // tree; each group's loads go out together, its root joins a stack
  const int g = min(kCombineGroup, n_tiles);
  float stk[24];
  int sp = 0;
  for (int k0 = 0; k0 < n_tiles; k0 += g) {
    float v[kCombineGroup];
#pragma unroll
    for (int r = 0; r < kCombineGroup; ++r) v[r] = r < g ? pb[(size_t)(k0 + r) * kSumLanes + tid] : 0.0f;
#pragma unroll
    for (int s = 1; s < kCombineGroup; s <<= 1) {
      if (s < g) {
#pragma unroll
        for (int r = 0; r + s < kCombineGroup; r += 2 * s) v[r] = __fadd_rn(v[r], v[r + s]);
      }
    }
    float root = v[0];
    for (int c = k0 / g; c & 1; c >>= 1) root = __fadd_rn(stk[--sp], root);
    stk[sp++] = root;
  }
  lanes[tid] = stk[0];
  __syncthreads();
  for (int h = kSumLanes / 2; h > 0; h >>= 1) {
    if (tid < h) lanes[tid] = __fadd_rn(lanes[tid], lanes[tid + h]);
    __syncthreads();
  }
  const float* mm = tile_mm + (size_t)b * n_tiles * kLaneSplit * 2;
  float hi = -INFINITY, lo = INFINITY;
  for (int k = tid; k < n_tiles * kLaneSplit; k += blockDim.x) {
    hi = fmaxf(hi, mm[2 * k]);
    lo = fminf(lo, mm[2 * k + 1]);
  }
  hi = block_max(hi, redf);
  lo = -block_max(-lo, redf);
  if (tid == 0) {
    const int nv = n_valid[b];
    const float mean = __fdiv_rn(lanes[0], fmaxf((float)nv, 1.0f));
    float amax = 0.0f;
    if (min(nv, T) > 0) amax = fmaxf(fabsf(__fsub_rn(hi, mean)), fabsf(__fsub_rn(lo, mean)));
    stats[2 * b] = mean;
    stats[2 * b + 1] = amax > 1e-6f ? __frcp_rn(amax) : 1.0f;
    first_drop[b] = INT_MAX;
  }
}

// 3. metric at d = 16k for the tile's kScanTile positions. Shared samples are
// stored with one pad float every kStride, so the threads of a warp, each
// summing its own 16-sample block, hit distinct banks.
__device__ __forceinline__ int pad16(int i) { return i + (i >> 4); }

__global__ void __launch_bounds__(kThreadsScan)
scan_kernel(const float* __restrict__ signals, const int* __restrict__ n_valid,
            const int* __restrict__ min_pos, int T, const float* __restrict__ stats, int half,
            int n_pos, float* __restrict__ metric_all, float* __restrict__ tile_max) {
  __shared__ float s[kScanSamples + kScanSamples / kStride];
  __shared__ float bp[kScanBlocksP];
  __shared__ float be[kScanBlocksE];
  __shared__ float redf[33];
  const int tile = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  const int k0 = tile * kScanTile, kc = min(kScanTile, n_pos - k0);
  const int nbe = kc + 2 * kHalfBlocks - 1, nbp = kc + kHalfBlocks - 1;
  const PreSrc pre = pre_src(signals, n_valid, stats, T, b);
  const int i0 = k0 * kStride;
  for (int i = tid; i < kStride * nbe; i += nt) s[pad16(i)] = pre(i0 + i);
  __syncthreads();
  // block sums, samples added in order (sync._strided_windowed_sum)
  for (int q = tid; q < nbe; q += nt) {
    const float* sq = s + pad16(q * kStride);
    float e = __fmul_rn(sq[0], sq[0]);
    for (int j = 1; j < kStride; ++j) e = __fadd_rn(e, __fmul_rn(sq[j], sq[j]));
    be[q] = e;
    if (q < nbp) {
      const float* sr = s + pad16(q * kStride + half);
      float p = __fmul_rn(sq[0], sr[0]);
      for (int j = 1; j < kStride; ++j) p = __fadd_rn(p, __fmul_rn(sq[j], sr[j]));
      bp[q] = p;
    }
  }
  __syncthreads();
  float* metric = metric_all + (size_t)b * n_pos + k0;
  float mx = 0.0f;
  for (int k = tid; k < kc; k += nt) {
    const float p = window16(bp + k);
    const float ra = window16(be + k);
    const float rb = window16(be + k + kHalfBlocks);
    const int dpos = (k0 + k) * kStride;
    const bool valid = dpos <= pre.nv - 2 * half && dpos >= min_pos[b] && ra > kMinEnergy &&
                       rb > kMinEnergy;
    const float m = valid ? __fdiv_rn(__fmul_rn(p, p), __fmul_rn(ra, rb)) : 0.0f;
    metric[k] = m;
    mx = fmaxf(mx, m);
  }
  mx = block_max(mx, redf);
  if (tid == 0) tile_max[(size_t)b * gridDim.x + tile] = mx;
}

// 4. first drop below 0.7x the running max, tile by tile
__global__ void __launch_bounds__(kScanTile)
commit_kernel(const float* __restrict__ metric_all, const float* __restrict__ tile_max, int n_pos,
              int* __restrict__ first_drop) {
  __shared__ float redf[33];
  __shared__ int redi[33];
  const int tile = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, n_tiles = gridDim.x;
  const float* tm = tile_max + (size_t)b * n_tiles;
  float carry = 0.0f;  // the metric is >= +0, so 0 is the empty running max
  for (int t = tid; t < tile; t += blockDim.x) carry = fmaxf(carry, tm[t]);
  carry = block_max(carry, redf);
  const int k = tile * kScanTile + tid;
  const float m = k < n_pos ? metric_all[(size_t)b * n_pos + k] : 0.0f;
  const float run = fmaxf(carry, block_prefix_max(m, redf));
  const bool drop = k < n_pos && run > kAutocorrThreshold && m < __fmul_rn(0.7f, run);
  const int first = block_min(drop ? k : INT_MAX, redi);
  if (tid == 0 && first != INT_MAX) atomicMin(first_drop + b, first);
}

// Shared memory of refine and the CE: two staged spans (kernel C's chain
// refines from one while the next slot's region lands in the other; kernel
// A's stage 5 uses the first), the template, the CE body and the block
// reductions' slots.
struct RefineSmem {
  __align__(16) float span[2][kSpanFloats];
  __align__(16) float tmpl[kMaxSym + 4];
  float body[kMaxSym];
  float redf[33];
  int redi[33];
};

struct Refined {
  int start;
  float fine;
};

// Samples [first, end) of ``pre`` staged in ``buf`` (16-byte aligned shared
// memory): buf[i] holds sample base + i, base being the sample at or below
// first whose address is 16-byte aligned. A quad of samples that lies whole
// inside the row's valid samples comes by one 16-byte cp.async, any other by
// 4-byte copies and zeros; one commit group. land_span waits for it and
// applies the source's map.
struct Span {
  int base, nq;
};

__device__ Span stage_span(const PreSrc& pre, int first, int end, float* buf) {
  const int base = first - (int)(((reinterpret_cast<uintptr_t>(pre.x) >> 2) + (unsigned)first) & 3);
  const Span sp{base, (end - base + 3) >> 2};
  for (int q = threadIdx.x; q < sp.nq; q += blockDim.x) {
    const int pos = base + 4 * q;
    float* dst = buf + 4 * q;
    if (pre.has(pos) && pre.has(pos + 3)) {
      cp_async16(dst, pre.x + pos);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (pre.has(pos + e))
          cp_async4(dst + e, pre.x + pos + e);
        else
          dst[e] = 0.0f;
      }
    }
  }
  cp_async_commit();
  return sp;
}

// Waits for this thread's copies (every earlier commit group), maps its
// samples in place, then synchronizes the block.
__device__ void land_span(const PreSrc& pre, const Span& sp, float* buf) {
  cp_async_wait<0>();
  for (int q = threadIdx.x; q < sp.nq; q += blockDim.x) {
    const int pos = sp.base + 4 * q;
    float4* at = reinterpret_cast<float4*>(buf + 4 * q);
    float4 v = *at;
    if (pre.has(pos)) v.x = pre.map(v.x);
    if (pre.has(pos + 1)) v.y = pre.map(v.y);
    if (pre.has(pos + 2)) v.z = pre.map(v.z);
    if (pre.has(pos + 3)) v.w = pre.map(v.w);
    *at = v;
  }
  __syncthreads();
}

// Threads refine needs at most for a profile's cp (ceil((n_off + 3) / 4)).
__host__ __device__ inline int refine_threads(int cp) { return (6 * cp + 1 + 3 + 3) / 4; }

// The xcorr refine around coarse index c >= 0 over [lo, hi] = [max(c - 3cp,
// 0), min(nv - sym, c + 3cp)] (sync.refine_xcorr: first index of the best
// metric, c where no offset is finite), from the normalized region [lo, lo +
// n_off + sym - 1) at buf + off (buf 16-byte aligned shared memory that
// holds 7 floats past the region) and the template tmpl (sym floats and 4
// more, sym a multiple of 4, 16-byte aligned shared memory). Kernel A's stage 5 and
// kernel C's slot chain both run it, so the two cannot drift apart. Every
// thread of the block calls it (at least refine_threads(cp) of them) and
// gets the same result.
//
// Register-blocked: thread t owns the 4 consecutive offsets 4t - a .. 4t - a
// + 3 (a = off % 4, so its reads are 16-byte aligned). Per 4 taps it loads
// one float4 of the region (the next 4 values slide through registers) and
// one of the template (a broadcast) for 32 FMAs, where one thread an offset
// took 2 shared loads per 2 FMAs; both loads run one step ahead, since a
// stream's chain has only a few warps to hide their latency. Each offset stays one fmaf chain over the
// taps j = 0 .. sym - 1 in order, for corr and for the energy, so start and
// fine are bit for bit those of the unblocked loop.
__device__ Refined refine(const float* __restrict__ buf, int off, int lo, int hi, int c,
                          const float* __restrict__ tmpl, float t_energy, int sym, int n_off, float* redf,
                          int* redi) {
  const int tid = threadIdx.x, a = off & 3;
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  if (tid < (n_off + a + 3) >> 2) {
    const float4* __restrict__ w = reinterpret_cast<const float4*>(buf + (off - a)) + tid;
    const float4* __restrict__ t4 = reinterpret_cast<const float4*>(tmpl);
    float corr[4] = {0.0f, 0.0f, 0.0f, 0.0f}, e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float4 cur = w[0], nxt = w[1], t = t4[0];
#pragma unroll 4
    for (int j4 = 0; j4 < sym / 4; ++j4) {
      const float4 nxt2 = w[j4 + 2], t2 = t4[j4 + 1];
      const float v[8] = {cur.x, cur.y, cur.z, cur.w, nxt.x, nxt.y, nxt.z, nxt.w};
      const float tt[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          corr[r] = fmaf(v[r + u], tt[u], corr[r]);
          e[r] = fmaf(v[r + u], v[r + u], e[r]);
        }
      cur = nxt, nxt = nxt2, t = t2;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int o = 4 * tid - a + r;
      if (o < 0 || o >= n_off) continue;
      const float den = sqrtf(__fmul_rn(e[r], t_energy));
      if (den > kXcorrMinDenom && lo + o <= hi) m[r] = __fdiv_rn(corr[r], den);
    }
  }
  float fm = fmaxf(fmaxf(m[0], m[1]), fmaxf(m[2], m[3]));
  fm = block_max(fm, redf);
  int dbest = INT_MAX;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (m[r] == fm && isfinite(fm)) dbest = min(dbest, lo + 4 * tid - a + r);
  dbest = block_min(dbest, redi);
  return Refined{isfinite(fm) ? dbest : c, fm};
}

// 5. best up to the first drop, xcorr refine over [lo, hi], CE
__global__ void __launch_bounds__(kThreadsA)
refine_ce_kernel(const float* __restrict__ signals, const int* __restrict__ n_valid, int T,
                 const float* __restrict__ stats, const float* __restrict__ pre1, float t_energy,
                 Demod d, int n_pos, int n_tiles, const float* __restrict__ metric_all,
                 const float* __restrict__ tile_max, const int* __restrict__ first_drop,
                 int* start_out, int* coarse_out, float* cmetric_out, float* fine_out,
                 unsigned char* detected_out, float* ch_re_out, float* ch_im_out) {
  __shared__ RefineSmem sm;
  float* redf = sm.redf;
  int* redi = sm.redi;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const PreSrc pre = pre_src(signals, n_valid, stats, T, b);
  const int na = d.n_active;
  const float* metric = metric_all + (size_t)b * n_pos;
  const float* tm = tile_max + (size_t)b * n_tiles;

  int fd = first_drop[b];
  if (fd == INT_MAX) fd = n_pos - 1;
  const int tf = fd / kScanTile, p0 = tf * kScanTile;
  float best = 0.0f;
  for (int t = tid; t < tf; t += nt) best = fmaxf(best, tm[t]);
  for (int k = p0 + tid; k <= fd; k += nt) best = fmaxf(best, metric[k]);
  best = block_max(best, redf);
  int t_first = INT_MAX;  // first full tile that holds best
  for (int t = tid; t < tf; t += nt)
    if (tm[t] == best) {
      t_first = t;
      break;
    }
  t_first = block_min(t_first, redi);
  const int k_lo = t_first == INT_MAX ? p0 : t_first * kScanTile;
  const int k_hi = t_first == INT_MAX ? fd : k_lo + kScanTile - 1;
  int kbest = INT_MAX;
  for (int k = k_lo + tid; k <= k_hi; k += nt)
    if (metric[k] == best) {
      kbest = k;
      break;
    }
  kbest = block_min(kbest, redi);
  const int coarse = best > kAutocorrThreshold ? kbest * kStride : -1;
  const int c = max(coarse, 0), sym = kFft + d.cp, radius = 3 * d.cp, n_off = 2 * radius + 1;
  const int lo = max(c - radius, 0), hi = min(pre.nv - sym, c + radius);
  for (int i = tid; i < sym; i += nt) sm.tmpl[i] = pre1[i];
  const Span sp = stage_span(pre, lo, lo + n_off + sym - 1, sm.span[0]);
  land_span(pre, sp, sm.span[0]);
  const Refined r = refine(sm.span[0], lo - sp.base, lo, hi, c, sm.tmpl, t_energy, sym, n_off, redf, redi);
  channel_estimate(pre, r.start + 2 * sym + d.cp, d, sm.body, ch_re_out + (size_t)b * na, ch_im_out + (size_t)b * na);
  if (tid == 0) {
    start_out[b] = r.start;
    coarse_out[b] = coarse;
    cmetric_out[b] = best;
    fine_out[b] = r.fine;
    detected_out[b] = coarse >= 0 && r.fine >= kXcorrThreshold;
  }
}

// 6. one tile of data symbols of stream b at start + 3*sym
template <class Cfg>
__global__ void __launch_bounds__(Cfg::kThreads)
receive_demod_kernel(const float* __restrict__ signals, const int* __restrict__ n_valid, int T,
                     const float* __restrict__ stats, const int* __restrict__ start,
                     const float* __restrict__ ch_re, const float* __restrict__ ch_im, Demod d,
                     int max_syms, signed char* bits_out) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y, k0 = blockIdx.x * Cfg::kMT;
  const PreSrc pre = pre_src(signals, n_valid, stats, T, b);
  demod_tile<Cfg, false>(pre, start[b] + 3 * (kFft + d.cp), 0, d, ch_re + (size_t)b * d.n_active,
                         ch_im + (size_t)b * d.n_active, k0, min(Cfg::kMT, max_syms - k0),
                         bits_out + (size_t)b * max_syms * d.nd * d.bps, smem);
}

// ---- kernel C: the cadence-predicted slots of a turbo round ----
//
// Replaces the JAX package's lax.scan of _predicted_signal_decode
// (audio_modem_tpu/parallel/multi_receiver.py:314-330 over
// parallel/batch.py:126-147), which XLA compiles into the turbo round's
// device program; it has no Pallas twin. Per stream, slot after slot:
// coarse = clamp(prev_start + cadence, 0, T - 1), the +-3*CP xcorr refine
// there, detected = fine >= 0.1 and every earlier slot detected, the CE at
// start + 2*sym, the demod of n_sym symbols at start + 3*sym; then the
// repetition vote, the MSB-first byte pack and the round's 5-byte head
// (detected, start big-endian) straight into the packed [B, K, 5 + n_bytes]
// matrix, slot 0 included where kernel A decoded it.
//
// What bounds it on the H100: bytes, one read of the window (234 MB at the
// turbo round's B = 64, T = 914,688: 70 us), on paper; the demod reads its
// symbols once more (the bodies of 2,048 slots x 42 rows, 172 MB) and the
// refine regions are small. In practice the demod (the FFT tile's compute,
// see there) and the slot chain set its time. The chain is serial (32
// slots a stream, one SM each) and has a floor of its own: 2 * 385 * 576
// FMAs a slot at the standard profile, which no blocking shortens, only
// spreads. The design:
//   1-2. pre_stats and combine, kernel A's stages 1-2: the preprocess mean
//        and scale, so the normalized sample is recomputed from the raw
//        window wherever it is read (PreSrc; 0 past n_valid and past T, the
//        zero extension of preprocess_extend) and no copy is made;
//   3. chain (B): one CTA a stream walks its slots in order, since each
//      slot's coarse index is the previous slot's refined start. Only the
//      refine is on the chain (the CE feeds the demod alone, which takes it
//      from its own CE row): the template is staged once, and while slot k
//      refines, the span that holds slot k+1's region whatever slot k's
//      start turns out to be (chain_cover) lands by cp.async in the other of
//      two buffers. The refine is kernel A's stage 5's (refine, register-
//      blocked). A missed slot still hands its refined start on; only the
//      cumulative flag drops;
//   4. demod (symbol tiles, slots, B): fft_demod_tile at each slot's start,
//      its row 0 the slot's CE body;
//   5. pack (slots, B): vote, byte pack and head of each slot.

// Threads of the chain's CTA for a profile's cp: the refine's, at least four
// warps for the staging.
__host__ __device__ inline int chain_threads(int cp) {
  const int warps = (refine_threads(cp) + 31) / 32;
  return 32 * (warps > 4 ? warps : 4);
}

// Samples [first, end) that hold the refine region [max(c - 3cp, 0), that +
// n_off + sym - 1) of every slot whose coarse index is c = clamp(w, 0, T - 1)
// for some w in [w_lo, w_hi]: for the chain's next slot w = start + cadence,
// and start lies within 3 cp of this slot's coarse index. The clamps are
// monotone, so the first and last w bound the region.
__device__ void chain_cover(long long w_lo, long long w_hi, int T, int radius, int len, int& first, int& end) {
  const long long c_lo = w_lo < 0 ? 0 : w_lo > T - 1 ? T - 1 : w_lo;
  const long long c_hi = w_hi < 0 ? 0 : w_hi > T - 1 ? T - 1 : w_hi;
  first = (int)(c_lo - radius < 0 ? 0 : c_lo - radius);
  end = (int)(c_hi - radius < 0 ? 0 : c_hi - radius) + len;
}

// 3. the slot chain of stream b (chain_threads(cp) threads)
__global__ void __launch_bounds__(512)
predicted_chain_kernel(const float* __restrict__ signals, const int* __restrict__ n_valid, int T,
                       const float* __restrict__ stats, const float* __restrict__ pre1, float t_energy, int cp,
                       const int* __restrict__ start0, const unsigned char* __restrict__ ok0, int n_pred,
                       int cadence, int* start_out, float* fine_out, unsigned char* ok_out) {
  __shared__ RefineSmem sm;
  const int b = blockIdx.x, sym = kFft + cp, radius = 3 * cp, n_off = 2 * radius + 1, len = n_off + sym - 1;
  const PreSrc pre = pre_src(signals, n_valid, stats, T, b);
  for (int i = threadIdx.x; i < sym; i += blockDim.x) sm.tmpl[i] = pre1[i];
  int prev = start0[b];
  bool ok = ok0[b] != 0;
  int first, end;
  chain_cover((long long)prev + cadence, (long long)prev + cadence, T, radius, len, first, end);
  Span sp = stage_span(pre, first, end, sm.span[0]);
  for (int k = 0; k < n_pred; ++k) {
    const size_t s = (size_t)b * n_pred + k;
    const long long want = (long long)prev + cadence;
    const int c = want < 0 ? 0 : want > T - 1 ? T - 1 : (int)want;
    float* buf = sm.span[k & 1];
    land_span(pre, sp, buf);  // slot k's region; slot k-1's buffer is free
    const int base = sp.base;
    if (k + 1 < n_pred) {
      chain_cover((long long)c - radius + cadence, (long long)c + radius + cadence, T, radius, len, first, end);
      sp = stage_span(pre, first, end, sm.span[(k + 1) & 1]);
    }
    const int lo = max(c - radius, 0), hi = min(pre.nv - sym, c + radius);
    const Refined r = refine(buf, lo - base, lo, hi, c, sm.tmpl, t_energy, sym, n_off, sm.redf, sm.redi);
    ok = ok && r.fine >= kXcorrThreshold;
    if (threadIdx.x == 0) {
      start_out[s] = r.start;
      fine_out[s] = r.fine;
      ok_out[s] = ok;
    }
    prev = r.start;
  }
}

// 4. one tile of data symbols of slot blockIdx.y of stream blockIdx.z
__global__ void __launch_bounds__(kThreadsFft, 2)
predicted_demod_kernel(const float* __restrict__ signals, const int* __restrict__ n_valid, int T,
                       const float* __restrict__ stats, const int* __restrict__ start, Demod d, int n_pred,
                       int n_sym, signed char* bits_out) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z, k0 = blockIdx.x * (kFftRows - 1), sym = kFft + d.cp;
  const size_t s = (size_t)b * n_pred + blockIdx.y;
  const PreSrc pre = pre_src(signals, n_valid, stats, T, b);
  const int st = start[s];
  fft_demod_tile(pre, st + 2 * sym + d.cp, st + 3 * sym + d.cp + k0 * sym, d, k0, min(kFftRows - 1, n_sym - k0),
                 bits_out + s * n_sym * d.nd * d.bps, smem);
}

constexpr int kThreadsPack = 256;

// Bytes j = j0, j0 + step, ... < n_bytes of the repetition-voted bits of src,
// MSB first: byte j holds voted bits 8j .. 8j+7 (ops.bits.majority_vote:
// group i is bits i*rep .. i*rep+rep-1, ties to 1; then bits_to_bytes).
// Kernel C's pack and the one-shot decoder's tail both vote through it.
__device__ void vote_pack(const signed char* __restrict__ src, int rep, int n_bytes, int j0, int step,
                          unsigned char* __restrict__ out) {
  for (int j = j0; j < n_bytes; j += step) {
    unsigned v = 0;
    for (int q = 0; q < 8; ++q) {
      const signed char* g = src + (size_t)(8 * j + q) * rep;
      int sum = 0;
      for (int r = 0; r < rep; ++r) sum += g[r];
      v = (v << 1) | (unsigned)(2 * sum >= rep);
    }
    out[j] = (unsigned char)v;
  }
}

// 5. slot blockIdx.x of stream blockIdx.y into its packed row: head, then
// the voted, packed bytes (vote_pack).
// The first k_slots - n_pred slots (0 or 1) come from kernel A's outputs
// (bits0, start0, ok0), the others from the chain and the demod.
__global__ void __launch_bounds__(kThreadsPack)
predicted_pack_kernel(const signed char* __restrict__ bits, const int* __restrict__ start,
                      const unsigned char* __restrict__ ok, const signed char* __restrict__ bits0,
                      const int* __restrict__ start0, const unsigned char* __restrict__ ok0, int n_pred,
                      int k_slots, int slot_bits, int rep, int n_bytes, unsigned char* __restrict__ packed) {
  const int slot = blockIdx.x, b = blockIdx.y, first = k_slots - n_pred;
  const signed char* src;
  int st;
  unsigned char flag;
  if (slot < first) {
    src = bits0 + (size_t)b * slot_bits;
    st = start0[b];
    flag = ok0[b];
  } else {
    const size_t s = (size_t)b * n_pred + (slot - first);
    src = bits + s * slot_bits;
    st = start[s];
    flag = ok[s];
  }
  unsigned char* row = packed + ((size_t)b * k_slots + slot) * (5 + n_bytes);
  if (threadIdx.x < 5) row[threadIdx.x] = threadIdx.x == 0 ? flag : (unsigned char)((st >> (32 - 8 * threadIdx.x)) & 0xFF);
  vote_pack(src, rep, n_bytes, threadIdx.x, kThreadsPack, row + 5);
}

// ---- the one-shot decoder's tail: one launch after kernel A ----
//
// Row b of ``rows`` [B, row_bytes] gathers what the host reads of kernel A's
// row b in one copy: the head (coarse and start int32, the fine metric's
// float32 bits), |H| float32 [n_active] (phy.channel_magnitude, each
// operation rounded on its own as PyTorch's separate operations round it),
// then the voted, packed bytes of the whole bits row (n_bits / rep / 8 of
// them) and zeros up to row_bytes, a multiple of 4. Groups and bytes start at
// bit 0, so the bytes of a frame's first n_sym symbols are a prefix of the
// row's; the host keeps that prefix. Grid: (byte tiles, B).

constexpr int kThreadsTail = 256;
constexpr int kTailHead = 12;

__global__ void __launch_bounds__(kThreadsTail)
decode_tail_kernel(const int* __restrict__ coarse, const int* __restrict__ start, const float* __restrict__ fine,
                   const signed char* __restrict__ bits, const float* __restrict__ ch_re,
                   const float* __restrict__ ch_im, int n_bits, int n_active, int rep, int n_bytes, int row_bytes,
                   unsigned char* __restrict__ rows) {
  const int b = blockIdx.y;
  unsigned char* row = rows + (size_t)b * row_bytes;
  unsigned char* packed = row + kTailHead + 4 * n_active;
  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) {
      int* head = reinterpret_cast<int*>(row);
      head[0] = coarse[b];
      head[1] = start[b];
      head[2] = __float_as_int(fine[b]);
    }
    float* mag = reinterpret_cast<float*>(row + kTailHead);
    for (int k = threadIdx.x; k < n_active; k += kThreadsTail) {
      const float re = ch_re[(size_t)b * n_active + k], im = ch_im[(size_t)b * n_active + k];
      mag[k] = __fsqrt_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
    }
    const int n_packed = row_bytes - kTailHead - 4 * n_active;
    if (n_bytes + (int)threadIdx.x < n_packed) packed[n_bytes + threadIdx.x] = 0;
  }
  vote_pack(bits + (size_t)b * n_bits, rep, n_bytes, blockIdx.x * kThreadsTail + threadIdx.x,
            gridDim.x * kThreadsTail, packed);
}

// ---- the chunked receiver's scan: one launch a window ----
//
// Replaces no TPU kernel: the JAX package's streaming scan
// (audio_modem_tpu/runtime/receiver.py) is plain jnp. It runs
// sync.detect_preamble at stride kStride with no preprocess on B rows of at
// most kStreamScanMax samples, each valid up to one n_valid, one CTA a row:
// the row in shared memory (the pad16 layout of kernel A's scan; samples at
// or past n_valid read as 0),
// the 16-sample block sums in sample order, window16, the metric under the
// validity mask, the running max (block_prefix_max), the first drop below
// 0.7x it once it passes 0.5, and the best metric up to that drop at its
// first index. Row b of ``out`` [B, 2] is (coarse = index * kStride or -1,
// the best metric's float32 bits): the host reads it in one copy.
// What bounds it: a row is 32 KB, ~10 ns of the card's bandwidth, and a
// position is a few dozen operations, so one launch and no scratch is the
// design: kernel A's scan is gridded over tiles of long rows and commits
// across tiles by atomicMin, which a window of 481 positions does not need.

constexpr int kStreamScanMax = 8192;                         // samples a row: the receiver's SCAN_BUCKET
constexpr int kStreamBlocks = kStreamScanMax / kStride;      // energy blocks of a full row
constexpr int kThreadsStreamScan = kStreamBlocks;            // a thread a position and a block
static_assert(kStreamBlocks >= 2 * kHalfBlocks, "a full row holds a position's two halves");

__global__ void __launch_bounds__(kThreadsStreamScan)
stream_scan_kernel(const float* __restrict__ windows, int nv, int W, float min_energy, int half, int n_pos,
                   int* __restrict__ out) {
  __shared__ float s[kStreamScanMax + kStreamScanMax / kStride];
  __shared__ float bp[kStreamBlocks];
  __shared__ float be[kStreamBlocks];
  __shared__ float redf[33];
  __shared__ int redi[33];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lim = min(nv, W);
  const float* x = windows + (size_t)b * W;
  for (int i = tid; i < W; i += nt) s[pad16(i)] = i < lim ? x[i] : 0.0f;
  __syncthreads();
  // block sums, samples added in order (sync._strided_windowed_sum)
  const int nbe = n_pos + 2 * kHalfBlocks - 1, nbp = n_pos + kHalfBlocks - 1;
  for (int q = tid; q < nbe; q += nt) {
    const float* sq = s + pad16(q * kStride);
    float e = __fmul_rn(sq[0], sq[0]);
    for (int j = 1; j < kStride; ++j) e = __fadd_rn(e, __fmul_rn(sq[j], sq[j]));
    be[q] = e;
    if (q < nbp) {
      const float* sr = s + pad16(q * kStride + half);
      float p = __fmul_rn(sq[0], sr[0]);
      for (int j = 1; j < kStride; ++j) p = __fadd_rn(p, __fmul_rn(sq[j], sr[j]));
      bp[q] = p;
    }
  }
  __syncthreads();
  const int k = tid;
  const bool pos = k < n_pos;
  float m = 0.0f;
  if (pos) {
    const float p = window16(bp + k);
    const float ra = window16(be + k);
    const float rb = window16(be + k + kHalfBlocks);
    const int d = k * kStride;
    const bool valid = d <= nv - 2 * half && ra > min_energy && rb > min_energy;
    if (valid) m = __fdiv_rn(__fmul_rn(p, p), __fmul_rn(ra, rb));
  }
  // sync.first_peak_commit: max is exact in any order, so the running max and
  // the best are the plain version's; ties go to the first index
  const float run = block_prefix_max(m, redf);
  const bool drop = pos && run > kAutocorrThreshold && m < __fmul_rn(0.7f, run);
  int first = block_min(drop ? k : INT_MAX, redi);
  if (first == INT_MAX) first = n_pos - 1;
  const float cand = pos && k <= first ? m : 0.0f;
  const float best = block_max(cand, redf);
  const int idx = block_min(pos && cand == best ? k : INT_MAX, redi);
  if (tid == 0) {
    out[2 * b] = best > kAutocorrThreshold ? idx * kStride : -1;
    out[2 * b + 1] = __float_as_int(best);
  }
}

// ---- kernel B: frame-aligned chunk demod, a pipeline of two launches ----
//
// Replaces audio_modem_tpu/kernels/receive.py::_chunk_kernel (entry
// decode_chunks_fused). Per frame: max |x| over the row, samples divided by
// it (passthrough when <= 1e-6), CE at 2*sym + cp, n_sym symbols.
// What bounds it on the H100: the frame is read twice (the peak must be
// known before any sample is scaled; the second read hits L2 where the
// batch fits it) and the demod is the FMA-bound tile above. A frame is too little work for an
// SM and 64 frames too few CTAs for 132 SMs, so both launches are gridded
// inside the frame as well:
//   1. peak (chunks of kPeakChunk samples, B): 16-byte loads, block max,
//      atomicMax on the bit pattern (non-negative floats order as unsigned
//      integers; max is exact in any order) into a slot the entry zeroes.
//   2. demod (symbol tiles, B): demod_tile on the scaled samples at 3*sym.
//      The CE rides in the tile: its row 0 is the scaled CE body, one more
//      row of the same product (a tile of 24 rows holds 23 symbols, so the
//      41 symbols of a 2048-byte QPSK chunk still take two tiles), and the
//      EQ tables come from that row's spectrum. A CE launch of its own, one
//      fmaf chain per thread against rx_active from L2, is bound by the
//      loads' latency and took over a third of the demod's time.

struct ScaledSrc {
  const float* x;
  int T;
  float mx;
  bool big;
  __device__ bool has(int i) const { return i >= 0 && i < T; }
  __device__ float map(float v) const { return big ? __fdiv_rn(v, mx) : v; }
};

__device__ ScaledSrc scaled_src(const float* frames, int T, const unsigned* peak, int b) {
  const float mx = __uint_as_float(peak[b]);
  return ScaledSrc{frames + (size_t)b * T, T, mx, mx > 1e-6f};
}

// 1. max |x| of samples [chunk * kPeakChunk, (chunk + 1) * kPeakChunk) of frame b
__global__ void __launch_bounds__(kThreadsPeak)
chunk_peak_kernel(const float* __restrict__ frames, int T, unsigned* __restrict__ peak) {
  __shared__ float redf[33];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int i0 = blockIdx.x * kPeakChunk;
  const float* x = frames + (size_t)b * T + i0;
  const int n = min(kPeakChunk, T - i0);
  // scalars up to the first 16-byte boundary, float4 from there, scalars at the end
  const int head = min(n, (int)((4 - ((reinterpret_cast<uintptr_t>(x) >> 2) & 3)) & 3));
  const int n4 = (n - head) / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  float mx = 0.0f;
  for (int i = tid; i < n4; i += kThreadsPeak) {
    const float4 v = x4[i];
    mx = fmaxf(fmaxf(mx, fmaxf(fabsf(v.x), fabsf(v.y))), fmaxf(fabsf(v.z), fabsf(v.w)));
  }
  if (tid < head) mx = fmaxf(mx, fabsf(x[tid]));
  if (head + 4 * n4 + tid < n) mx = fmaxf(mx, fabsf(x[head + 4 * n4 + tid]));
  mx = block_max(mx, redf);
  if (tid == 0) atomicMax(peak + b, __float_as_uint(mx));
}

// 2. one tile of frame b: the CE body at 2*sym + cp in row 0, then up to
// kMT - 1 data symbols at 3*sym
template <class Cfg>
__global__ void __launch_bounds__(Cfg::kThreads)
chunk_demod_kernel(const float* __restrict__ frames, int T, const unsigned* __restrict__ peak, Demod d,
                   int n_sym, signed char* bits_out) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y, k0 = blockIdx.x * (Cfg::kMT - 1), sym = kFft + d.cp;
  const ScaledSrc src = scaled_src(frames, T, peak, b);
  demod_tile<Cfg, true>(src, 3 * sym, 2 * sym + d.cp, d, nullptr, nullptr, k0,
                        min(Cfg::kMT - 1, n_sym - k0), bits_out + (size_t)b * n_sym * d.nd * d.bps,
                        smem);
}

// ---- streaming demod: a data region with a known channel ----
//
// Replaces audio_modem_tpu/kernels/receive.py::_chunk_stream_flat_kernel and
// ::_chunk_stream_pair_kernel (entries decode_chunks_fused_stream and
// decode_long_fused). Row b of ``data`` (row stride ld, L samples) starts at
// the CP of its first data symbol; each sample is multiplied by scale[b].
// The channel comes in the active-bin layout (ch_re, ch_im [B, n_active]).
// One CTA demodulates one tile of symbols of one stream: it builds that
// stream's EQ table, then runs demod_tile. The TPU kernels' flat/pair split,
// 128-lane sections and 16-bit word packing are Mosaic layout and have no
// part here. What bounds it on the H100: the tile's FMA rate (see the
// demod tile), not device memory: each sample is read once. The grid is over symbol tiles as well as streams, so a
// single stream (the decoder's B = 1) still spreads over every SM.

struct StreamSrc {
  const float* x;
  int L;
  float scale;
  __device__ bool has(int i) const { return i >= 0 && i < L; }
  __device__ float map(float v) const { return __fmul_rn(v, scale); }
};

template <class Cfg>
__global__ void __launch_bounds__(Cfg::kThreads)
stream_demod_kernel(const float* __restrict__ data, long long ld, int L,
                    const float* __restrict__ ch_re, const float* __restrict__ ch_im,
                    const float* __restrict__ scale, Demod d, int n_sym, signed char* bits_out) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y, k0 = blockIdx.x * Cfg::kMT;
  const StreamSrc src{data + (size_t)b * ld, L, scale[b]};
  demod_tile<Cfg, false>(src, 0, 0, d, ch_re + (size_t)b * d.n_active, ch_im + (size_t)b * d.n_active,
                         k0, min(Cfg::kMT, n_sym - k0), bits_out + (size_t)b * n_sym * d.nd * d.bps,
                         smem);
}

// Kernel A's tiling of a T-sample row with n_pos scan positions: rows *
// n_rows_tiles is the power-of-two row count of sync.pairwise_row_sum.
struct TilingA {
  int rows, n_rows_tiles, n_scan_tiles;
};

TilingA tiling_a(int T, int n_pos) {
  long long m = 1;
  while (m * kSumLanes < T) m *= 2;
  const int rows = (int)(m < kRowsA ? m : kRowsA);
  return TilingA{rows, (int)(m / rows), (n_pos + kScanTile - 1) / kScanTile};
}

// The demod's description, or fft = 0 where the tile cannot take it: the
// DFT size is kFft, there are data and pilot bins, the table's rows must be
// whole 16-byte pieces that hold every column, the spectrum must fit over
// the staged bodies, and a row of bits must start on 4 bytes (store_bits).
Demod make_demod(const float* rx_active, const float* ce_known, const float* rx_demod,
                 const int* data_pos, const int* pilot_pos, int fft, int cp, int n_active, int nd,
                 int npi, int ncol_pad, float qam_scale, int bps, const signed char* bits) {
  const int ncol = 2 * nd + 2 * npi;
  const bool ok = fft == kFft && nd >= 1 && npi >= 1 && ncol <= fft && ncol_pad % 4 == 0 && ncol_pad >= ncol &&
                  ncol_pad <= TileWide::kCols && bps >= 1 &&
                  reinterpret_cast<uintptr_t>(rx_demod) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(bits) % 4 == 0;
  return Demod{rx_active, ce_known, rx_demod, data_pos, pilot_pos, ok ? fft : 0,
               cp,        n_active, nd,       npi,      ncol_pad,  bps,          qam_scale};
}

// Launches ``kernel`` (one of the four demod kernels, at tile Cfg) over
// (tiles of n_sym symbols, rows.x, rows.y) with the tile's dynamic shared
// memory; ``ce_rows`` rows of every tile are taken by a CE body (0 or 1).
template <class Cfg, class... Params, class... Args>
cudaError_t launch_tiles(void (*kernel)(Params...), const Demod& d, int ce_rows, int n_sym, dim3 rows,
                         cudaStream_t stream, Args... args) {
  const int per_tile = Cfg::kMT - ce_rows;
  const size_t smem = sizeof(float) * tile_smem_floats<Cfg>(d);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n_sym + per_tile - 1) / per_tile, rows.x, rows.y), Cfg::kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The narrowest tile that covers the profile's columns, chosen on the host.
#define AMTPU_LAUNCH_TILES(kernel, d, ...)                                              \
  ((d).ncol_pad <= TileNarrow::kCols ? launch_tiles<TileNarrow>(kernel<TileNarrow>, d, __VA_ARGS__) \
   : (d).ncol_pad <= TileMid::kCols  ? launch_tiles<TileMid>(kernel<TileMid>, d, __VA_ARGS__)       \
                                     : launch_tiles<TileWide>(kernel<TileWide>, d, __VA_ARGS__))

}  // namespace

extern "C" {

const char* amtpu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Floats of kernel A's scratch for B rows of T samples and n_pos scan
// positions: lane subtrees [B, n_rows_tiles, kSumLanes], tile extremes
// [B, n_rows_tiles, kLaneSplit, 2], mean and scale [B, 2], metric [B, n_pos],
// scan tile maxima [B, n_scan_tiles], first drop (int) [B].
long long amtpu_decode_fused_scratch_floats(int B, int T, int n_pos) {
  const TilingA g = tiling_a(T, n_pos);
  return (long long)B *
         ((long long)g.n_rows_tiles * (kSumLanes + 2 * kLaneSplit) + 2 + n_pos + g.n_scan_tiles + 1);
}

// Kernel A's six launches on ``stream``. ``scratch`` holds
// amtpu_decode_fused_scratch_floats(B, T, n_pos) floats; n_pos is the
// position count of sync.scan_metric at stride kStride.
int amtpu_decode_fused(const float* signals, const int* n_valid, const int* min_pos, int B, int T,
                       const float* pre1, float t_energy, const float* rx_active,
                       const float* ce_known, const float* rx_demod, const int* data_pos,
                       const int* pilot_pos, int fft, int cp, int n_active, int nd, int npi,
                       int ncol_pad, float qam_scale, int bps, int max_syms, int n_pos,
                       float* scratch, int* start, int* coarse, float* cmetric, float* fine,
                       unsigned char* detected, signed char* bits, float* ch_re, float* ch_im,
                       cudaStream_t stream) {
  const Demod d = make_demod(rx_active, ce_known, rx_demod, data_pos, pilot_pos, fft, cp, n_active,
                             nd, npi, ncol_pad, qam_scale, bps, bits);
  if (T < 1 || n_pos < 1 || d.fft == 0 || cp > kMaxCp || fft + cp > kMaxSym || (fft + cp) % 4 != 0 ||
      B < 1 || max_syms < 1)
    return (int)cudaErrorInvalidValue;
  const TilingA g = tiling_a(T, n_pos);
  const int rows = g.rows, n_rows_tiles = g.n_rows_tiles, n_scan_tiles = g.n_scan_tiles;
  float* part = scratch;
  float* tile_mm = part + (size_t)B * n_rows_tiles * kSumLanes;
  float* stats = tile_mm + (size_t)B * n_rows_tiles * kLaneSplit * 2;
  float* metric = stats + (size_t)B * 2;
  float* tile_max = metric + (size_t)B * n_pos;
  int* first_drop = reinterpret_cast<int*>(tile_max + (size_t)B * n_scan_tiles);
  cudaError_t err;
  pre_stats_kernel<<<dim3(n_rows_tiles, B, kLaneSplit), kThreadsPre, 0, stream>>>(signals, n_valid, T,
                                                                                  rows, part, tile_mm);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  combine_kernel<<<B, kThreadsA, 0, stream>>>(part, tile_mm, n_valid, T, n_rows_tiles, stats,
                                              first_drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scan_kernel<<<dim3(n_scan_tiles, B), kThreadsScan, 0, stream>>>(signals, n_valid, min_pos, T, stats,
                                                                  fft / 2, n_pos, metric, tile_max);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  commit_kernel<<<dim3(n_scan_tiles, B), kScanTile, 0, stream>>>(metric, tile_max, n_pos, first_drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  refine_ce_kernel<<<B, kThreadsA, 0, stream>>>(signals, n_valid, T, stats, pre1, t_energy, d, n_pos,
                                                n_scan_tiles, metric, tile_max, first_drop, start,
                                                coarse, cmetric, fine, detected, ch_re, ch_im);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)AMTPU_LAUNCH_TILES(receive_demod_kernel, d, 0, max_syms, B, stream, signals, n_valid, T,
                                 stats, start, ch_re, ch_im, d, max_syms, bits);
}

// Floats of kernel C's scratch for B rows of T samples and n_pred predicted
// slots of slot_bits bits: lane subtrees and tile extremes as kernel A's,
// mean and scale [B, 2], the unused first-drop slot (int) [B], then the bits
// (int8) [B, n_pred, slot_bits].
long long amtpu_decode_predicted_scratch_floats(int B, int T, int n_pred, int slot_bits) {
  const TilingA g = tiling_a(T, 1);
  return (long long)B * ((long long)g.n_rows_tiles * (kSumLanes + 2 * kLaneSplit) + 3) +
         (long long)B * n_pred * ((slot_bits + 3) / 4);
}

// Kernel C on ``stream``: the n_pred = k_slots or k_slots - 1 predicted
// slots of B rows of T raw samples (n_valid valid), the chain starting from
// (start0, ok0), packed with the slot that kernel A decoded (bits0, int8
// [B, slot_bits]; read when n_pred < k_slots) into ``packed`` [B, k_slots,
// 5 + n_bytes], n_bytes = n_sym * nd * bps / repetition / 8. The predicted
// slots' start, fine metric and cumulative flag go to start, fine and ok
// [B, n_pred]. ``bins`` (int [nd + npi]) and ``twiddle`` (float [fft][2])
// are the FFT tile's (Demod). ``scratch`` holds
// amtpu_decode_predicted_scratch_floats floats.
int amtpu_decode_predicted(const float* signals, const int* n_valid, int B, int T, const int* start0,
                           const unsigned char* ok0, const signed char* bits0, const float* pre1, float t_energy,
                           const int* bins, const float* twiddle, const float* rx_active, const float* ce_known,
                           const float* rx_demod, const int* data_pos, const int* pilot_pos, int fft, int cp,
                           int n_active, int nd, int npi, int ncol_pad, float qam_scale, int bps, int n_sym,
                           int n_pred, int k_slots, int cadence, int repetition, float* scratch, int* start,
                           float* fine, unsigned char* ok, unsigned char* packed, cudaStream_t stream) {
  const int slot_bits = n_sym * nd * bps, n_bytes = slot_bits / repetition / 8;
  const TilingA g = tiling_a(T, 1);
  float* part = scratch;
  float* tile_mm = part + (size_t)B * g.n_rows_tiles * kSumLanes;
  float* stats = tile_mm + (size_t)B * g.n_rows_tiles * kLaneSplit * 2;
  int* first_drop = reinterpret_cast<int*>(stats + (size_t)B * 2);
  signed char* bits = reinterpret_cast<signed char*>(first_drop + B);
  Demod d = make_demod(rx_active, ce_known, rx_demod, data_pos, pilot_pos, fft, cp, n_active, nd, npi, ncol_pad,
                       qam_scale, bps, bits);
  d.bins = bins;
  d.twiddle = twiddle;
  // the FFT tile: 16 bins a thread of a row, rows whose bodies share their alignment, a float2 twiddle table
  if (T < 1 || B < 1 || n_sym < 1 || k_slots < 1 || repetition < 1 || n_bytes < 1 || d.fft == 0 || cp > kMaxCp ||
      fft + cp > kMaxSym || (fft + cp) % 4 != 0 || nd + npi > 16 * 16 || bins == nullptr ||
      reinterpret_cast<uintptr_t>(twiddle) % 8 != 0 ||
      !(n_pred == k_slots || (n_pred == k_slots - 1 && bits0 != nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (n_pred > 0) {
    pre_stats_kernel<<<dim3(g.n_rows_tiles, B, kLaneSplit), kThreadsPre, 0, stream>>>(signals, n_valid, T, g.rows,
                                                                                     part, tile_mm);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    combine_kernel<<<B, kThreadsA, 0, stream>>>(part, tile_mm, n_valid, T, g.n_rows_tiles, stats, first_drop);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    predicted_chain_kernel<<<B, chain_threads(cp), 0, stream>>>(signals, n_valid, T, stats, pre1, t_energy, cp,
                                                                start0, ok0, n_pred, cadence, start, fine, ok);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int per = kFftRows - 1;
    const size_t smem = sizeof(float) * fft_smem_floats(d);
    if ((err = cudaFuncSetAttribute(predicted_demod_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
      return (int)err;
    predicted_demod_kernel<<<dim3((n_sym + per - 1) / per, n_pred, B), kThreadsFft, smem, stream>>>(
        signals, n_valid, T, stats, start, d, n_pred, n_sym, bits);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  predicted_pack_kernel<<<dim3(k_slots, B), kThreadsPack, 0, stream>>>(bits, start, ok, bits0, start0, ok0, n_pred,
                                                                       k_slots, slot_bits, repetition, n_bytes,
                                                                       packed);
  return (int)cudaGetLastError();
}

// The one-shot decoder's tail on ``stream`` over B rows of kernel A's outputs
// (coarse, start, fine [B]; bits int8 [B, n_bits]; ch_re, ch_im [B, n_active])
// into ``rows`` uint8 [B, row_bytes] (decode_tail_kernel). row_bytes must be
// 12 + 4 * n_active + n_bits / repetition / 8 rounded up to a multiple of 4.
int amtpu_decode_tail(const int* coarse, const int* start, const float* fine, const signed char* bits,
                      const float* ch_re, const float* ch_im, int B, int n_bits, int n_active, int repetition,
                      int row_bytes, unsigned char* rows, cudaStream_t stream) {
  if (B < 1 || B > 65535 || n_bits < 0 || n_active < 0 || repetition < 1) return (int)cudaErrorInvalidValue;
  const int n_bytes = n_bits / repetition / 8;
  if (row_bytes != kTailHead + 4 * n_active + (n_bytes + 3) / 4 * 4) return (int)cudaErrorInvalidValue;
  const int tiles = n_bytes > 0 ? (n_bytes + kThreadsTail - 1) / kThreadsTail : 1;
  decode_tail_kernel<<<dim3(tiles, B), kThreadsTail, 0, stream>>>(coarse, start, fine, bits, ch_re, ch_im, n_bits,
                                                                  n_active, repetition, n_bytes, row_bytes, rows);
  return (int)cudaGetLastError();
}

// The chunked receiver's scan on ``stream`` (stream_scan_kernel): B rows of W
// samples, each valid up to n_valid, into ``out`` int [B, 2]. half is
// fft / 2; n_pos is the position count of sync.scan_metric at stride kStride
// on a W-sample row.
int amtpu_stream_scan(const float* windows, int n_valid, int B, int W, float min_energy, int half, int n_pos,
                      int* out, cudaStream_t stream) {
  if (B < 1 || W < 1 || W > kStreamScanMax || half != kHalfBlocks * kStride || n_pos < 1 ||
      n_pos > kThreadsStreamScan || (n_pos + 2 * kHalfBlocks - 1) * kStride > W)
    return (int)cudaErrorInvalidValue;
  stream_scan_kernel<<<B, kThreadsStreamScan, 0, stream>>>(windows, n_valid, W, min_energy, half, n_pos, out);
  return (int)cudaGetLastError();
}

// Floats of kernel B's scratch for B frames: the peak's bit pattern [B].
long long amtpu_decode_chunks_fused_scratch_floats(int B) { return B; }

// Kernel B's two launches on ``stream``. ``scratch`` holds
// amtpu_decode_chunks_fused_scratch_floats(B) floats.
int amtpu_decode_chunks_fused(const float* frames, int B, int T, const float* rx_active,
                              const float* ce_known, const float* rx_demod, const int* data_pos,
                              const int* pilot_pos, int fft, int cp, int n_active, int nd, int npi,
                              int ncol_pad, float qam_scale, int bps, int n_sym, float* scratch,
                              signed char* bits, cudaStream_t stream) {
  const Demod d = make_demod(rx_active, ce_known, rx_demod, data_pos, pilot_pos, fft, cp, n_active,
                             nd, npi, ncol_pad, qam_scale, bps, bits);
  if (d.fft == 0 || B < 1 || T < 1 || n_sym < 1) return (int)cudaErrorInvalidValue;
  unsigned* peak = reinterpret_cast<unsigned*>(scratch);
  cudaError_t err = cudaMemsetAsync(peak, 0, sizeof(unsigned) * B, stream);
  if (err != cudaSuccess) return (int)err;
  chunk_peak_kernel<<<dim3((T + kPeakChunk - 1) / kPeakChunk, B), kThreadsPeak, 0, stream>>>(frames, T,
                                                                                            peak);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)AMTPU_LAUNCH_TILES(chunk_demod_kernel, d, 1, n_sym, B, stream, frames, T, peak, d, n_sym,
                                 bits);
}

int amtpu_stream_demod(const float* data, int B, long long ld, int L, const float* ch_re,
                       const float* ch_im, const float* scale, const float* rx_active,
                       const float* ce_known, const float* rx_demod, const int* data_pos,
                       const int* pilot_pos, int fft, int cp, int n_active, int nd, int npi,
                       int ncol_pad, float qam_scale, int bps, int n_sym, signed char* bits,
                       cudaStream_t stream) {
  const Demod d = make_demod(rx_active, ce_known, rx_demod, data_pos, pilot_pos, fft, cp, n_active,
                             nd, npi, ncol_pad, qam_scale, bps, bits);
  if (d.fft == 0 || B < 1 || n_sym < 1) return (int)cudaErrorInvalidValue;
  return (int)AMTPU_LAUNCH_TILES(stream_demod_kernel, d, 0, n_sym, B, stream, data, ld, L, ch_re, ch_im,
                                 scale, d, n_sym, bits);
}

}  // extern "C"
