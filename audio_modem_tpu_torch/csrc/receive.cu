// Receive kernels for Hopper (sm_90a): the full per-stream receive (kernel A),
// the frame-aligned chunk demod (kernel B) and the streaming demod of a data
// region whose channel is already known, with a plain C interface for ctypes
// (see kernels/_build.py). A is a pipeline of six launches gridded over
// (tiles or symbol groups, streams); B runs one CTA per frame; the streaming
// demod one CTA per (group of kGroup symbols, stream).
//
// All three end in the same demod (per symbol: DFT at the data and pilot
// bins, ZF EQ, pilot phase, hard demap, int8 bits), shared below as the
// device function demod_group, so one rounding discipline serves all three.
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
constexpr int kThreadsB = 512;   // kernel B: one CTA per frame
constexpr int kThreadsS = 256;   // stream demod: one CTA per (symbol group, stream)
constexpr int kSumLanes = 1024;  // sync.SUM_LANES
constexpr int kStride = 16;      // sync.COARSE_STRIDE
constexpr int kHalfBlocks = 16;  // (fft / 2) / kStride for fft = 512
constexpr int kMaxSym = 768;     // longest symbol of any profile (narrowband)
constexpr int kMaxRegion = 6 * 256 + 1 + kMaxSym - 1;  // refine region at cp = 256
constexpr int kGroup = 8;        // data symbols per demod pass (and per stream-demod CTA)
constexpr float kAutocorrThreshold = 0.5f;
constexpr float kMinEnergy = 0.01f;
constexpr float kXcorrThreshold = 0.1f;
constexpr float kXcorrMinDenom = 0.001f;

struct Demod {
  const float* rx_active;  // [fft, 2*n_active]
  const float* ce_known;   // [n_active]
  const float* rx_data;    // [fft, 2*nd]
  const float* rx_pilot;   // [fft, 2*npi]
  const int* data_pos;     // [nd]
  const int* pilot_pos;    // [npi]
  int fft, cp, n_active, nd, npi, bps;
  float qam_scale;
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

int demod_smem_floats(const Demod& d) {
  return 2 * d.n_active + 3 * d.nd + 3 * d.npi + kGroup * d.fft +
         kGroup * (2 * d.nd + 2 * d.npi) + kGroup;
}

// The demod's shared-memory regions, carved from one dynamic buffer of
// demod_smem_floats(d) floats.
struct DemodSmem {
  float* ch;    // [2*na]: re | im
  float* hd;    // [3*nd]: re | im | den (0 = passthrough)
  float* hp;    // [3*npi]
  float* body;  // [kGroup*fft]
  float* spec;  // [kGroup*ncol]
  float* phi;   // [kGroup]
};

__device__ DemodSmem carve(const Demod& d, float* smem) {
  DemodSmem s;
  s.ch = smem;
  s.hd = s.ch + 2 * d.n_active;
  s.hp = s.hd + 3 * d.nd;
  s.body = s.hp + 3 * d.npi;
  s.spec = s.body + kGroup * d.fft;
  s.phi = s.spec + kGroup * (2 * d.nd + 2 * d.npi);
  return s;
}

// EQ tables at the data and pilot positions from the active-bin channel in
// s.ch: H, and |H|^2 with 0 marking passthrough (|H|^2 <= 1e-10).
__device__ void eq_tables(const Demod& d, const DemodSmem& s) {
  const int nd = d.nd, npi = d.npi, na = d.n_active;
  for (int j = threadIdx.x; j < nd + npi; j += blockDim.x) {
    const bool data = j < nd;
    const int pos = data ? d.data_pos[j] : d.pilot_pos[j - nd];
    const float hr = s.ch[pos], hi = s.ch[na + pos];
    const float mag = __fadd_rn(__fmul_rn(hr, hr), __fmul_rn(hi, hi));
    float* h = data ? s.hd : s.hp;
    const int m = data ? nd : npi, i = data ? j : j - nd;
    h[i] = hr;
    h[m + i] = hi;
    h[2 * m + i] = mag > 1e-10f ? mag : 0.0f;
  }
  __syncthreads();
}

// Data symbols k0 .. k0+g-1 (g <= kGroup), symbol k's CP at data_base +
// k*sym of sample source ``src``: DFT at the data and pilot bins (one column
// per thread, fft taps summed in order by FMA, the table read once for all
// g bodies), pilot phase, ZF EQ, demap, int8 bits. ``bits`` is the row's
// first bit; bits go out bin-major, MSB first within a bin (phy.demodulate's
// order). Needs eq_tables first.
template <class Src>
__device__ void demod_group(const Src& src, int data_base, const Demod& d, int k0, int g,
                            signed char* bits, const DemodSmem& s) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int fft = d.fft, nd = d.nd, npi = d.npi, bps = d.bps;
  const int sym = fft + d.cp;
  const int ncol = 2 * nd + 2 * npi;
  for (int i = tid; i < kGroup * fft; i += nt) {
    const int k = i / fft, n = i - k * fft;
    s.body[i] = k < g ? src(data_base + (k0 + k) * sym + d.cp + n) : 0.0f;
  }
  __syncthreads();
  for (int c = tid; c < ncol; c += nt) {
    const float* tab = c < 2 * nd ? d.rx_data + c : d.rx_pilot + (c - 2 * nd);
    const int w = c < 2 * nd ? 2 * nd : 2 * npi;
    float acc[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) acc[k] = 0.0f;
    for (int n = 0; n < fft; ++n) {
      const float t = tab[n * w];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) acc[k] = fmaf(s.body[k * fft + n], t, acc[k]);
    }
    for (int k = 0; k < g; ++k) s.spec[k * ncol + c] = acc[k];
  }
  __syncthreads();
  // pilot phase: mean of Im/Re over pilots with |Re| > 1e-6
  if (tid < g) {
    const float* sp = s.spec + tid * ncol + 2 * nd;
    const float* hp = s.hp;
    float sum = 0.0f;
    int cnt = 0;
    for (int j = 0; j < npi; ++j) {
      float pr, pi;
      equalize(sp[j], sp[npi + j], hp[j], hp[npi + j], hp[2 * npi + j], hp[2 * npi + j] > 0.0f,
               pr, pi);
      if (fabsf(pr) > 1e-6f) {
        sum = __fadd_rn(sum, __fdiv_rn(pi, pr));
        ++cnt;
      }
    }
    s.phi[tid] = cnt > 0 ? __fdiv_rn(sum, (float)cnt) : 0.0f;
  }
  __syncthreads();
  const float* hd = s.hd;
  for (int i = tid; i < g * nd; i += nt) {
    const int k = i / nd, j = i - k * nd;
    const float* sp = s.spec + k * ncol;
    float dr, di;
    equalize(sp[j], sp[nd + j], hd[j], hd[nd + j], hd[2 * nd + j], hd[2 * nd + j] > 0.0f, dr, di);
    const float p = s.phi[k];
    const float cr = __fadd_rn(dr, __fmul_rn(di, p));
    const float ci = __fsub_rn(di, __fmul_rn(dr, p));
    const int idx = demap_index(cr, ci, bps, d.qam_scale);
    signed char* out = bits + ((size_t)(k0 + k) * nd + j) * bps;
    for (int b = 0; b < bps; ++b) out[b] = (signed char)((idx >> (bps - 1 - b)) & 1);
  }
  __syncthreads();
}

// CE: H = DFT(body) * known sign (phy.estimate_channel) of the fft samples
// of ``src`` from ``pos``, staged in ``body`` (fft floats of shared memory).
// H goes to ``ch`` ([2*n_active] re | im, shared) or, where ``ch`` is null,
// to ``ch_re_out`` and ``ch_im_out`` ([n_active] each, global).
template <class Src>
__device__ void channel_estimate(const Src& src, int pos, const Demod& d, float* body, float* ch,
                                 float* ch_re_out, float* ch_im_out) {
  const int tid = threadIdx.x, nt = blockDim.x, na = d.n_active;
  for (int n = tid; n < d.fft; n += nt) body[n] = src(pos + n);
  __syncthreads();
  for (int c = tid; c < 2 * na; c += nt) {
    float acc = 0.0f;
    for (int n = 0; n < d.fft; ++n) acc = fmaf(body[n], d.rx_active[n * 2 * na + c], acc);
    const float h = __fmul_rn(acc, d.ce_known[c < na ? c : c - na]);
    if (ch)
      ch[c] = h;
    else if (c < na)
      ch_re_out[c] = h;
    else
      ch_im_out[c - na] = h;
  }
  __syncthreads();
}

// Channel estimate at frame offset 2*sym + cp, then n_sym data symbols at
// 3*sym + cp + k*sym, from sample source ``src`` (reads 0 out of range).
template <class Src>
__device__ void demod_frame(const Src& src, int base, const Demod& d, int n_sym,
                            signed char* bits, float* smem) {
  const int sym = d.fft + d.cp;
  const DemodSmem s = carve(d, smem);
  channel_estimate(src, base + 2 * sym + d.cp, d, s.body, s.ch, nullptr, nullptr);
  eq_tables(d, s);
  for (int k0 = 0; k0 < n_sym; k0 += kGroup)
    demod_group(src, base + 3 * sym, d, k0, min(kGroup, n_sym - k0), bits, s);
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
// over (tiles, streams), and the demod gridded over (symbol groups,
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
//      tiles' maxima plus one partial tile), the xcorr refine, the CE.
//   6. demod (kGroup-symbol groups, B): demod_group on the normalized
//      samples at start + 3*sym, EQ tables built per CTA from the CE.
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

struct PreSrc {
  const float* x;
  int T, nv;
  float mean, scale;
  __device__ float operator()(int i) const {
    return (i >= 0 && i < nv && i < T) ? __fmul_rn(__fsub_rn(x[i], mean), scale) : 0.0f;
  }
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

// 5. best up to the first drop, xcorr refine over [lo, hi], CE
__global__ void __launch_bounds__(kThreadsA)
refine_ce_kernel(const float* __restrict__ signals, const int* __restrict__ n_valid, int T,
                 const float* __restrict__ stats, const float* __restrict__ pre1, float t_energy,
                 Demod d, int n_pos, int n_tiles, const float* __restrict__ metric_all,
                 const float* __restrict__ tile_max, const int* __restrict__ first_drop,
                 int* start_out, int* coarse_out, float* cmetric_out, float* fine_out,
                 unsigned char* detected_out, float* ch_re_out, float* ch_im_out) {
  __shared__ float region[kMaxRegion];
  __shared__ float tmpl[kMaxSym];
  __shared__ float body[kMaxSym];
  __shared__ float redf[33];
  __shared__ int redi[33];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const PreSrc pre = pre_src(signals, n_valid, stats, T, b);
  const int sym = d.fft + d.cp, na = d.n_active;
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

  const int radius = 3 * d.cp, n_off = 2 * radius + 1;
  const int c = max(coarse, 0);
  const int lo = max(c - radius, 0), hi = min(pre.nv - sym, c + radius);
  for (int i = tid; i < n_off + sym - 1; i += nt) region[i] = pre(lo + i);
  for (int i = tid; i < sym; i += nt) tmpl[i] = pre1[i];
  __syncthreads();
  float fm = -INFINITY;
  int dbest = INT_MAX;
  float mloc[2] = {-INFINITY, -INFINITY};
  for (int o = tid, r = 0; o < n_off; o += nt, ++r) {
    float corr = 0.0f, e = 0.0f;
    for (int j = 0; j < sym; ++j) {
      const float v = region[o + j];
      corr = fmaf(v, tmpl[j], corr);
      e = fmaf(v, v, e);
    }
    const float den = sqrtf(__fmul_rn(e, t_energy));
    if (den > kXcorrMinDenom && lo + o <= hi) mloc[r] = __fdiv_rn(corr, den);
    fm = fmaxf(fm, mloc[r]);
  }
  fm = block_max(fm, redf);
  for (int o = tid, r = 0; o < n_off; o += nt, ++r)
    if (mloc[r] == fm && isfinite(fm)) dbest = min(dbest, lo + o);
  dbest = block_min(dbest, redi);
  const int start = isfinite(fm) ? dbest : c;
  if (tid == 0) {
    start_out[b] = start;
    coarse_out[b] = coarse;
    cmetric_out[b] = best;
    fine_out[b] = fm;
    detected_out[b] = coarse >= 0 && fm >= kXcorrThreshold;
  }
  channel_estimate(pre, start + 2 * sym + d.cp, d, body, nullptr, ch_re_out + (size_t)b * na,
                   ch_im_out + (size_t)b * na);
}

// EQ tables of stream b from its channel (re, im) [B, n_active] in global memory.
__device__ void load_channel(const Demod& d, const DemodSmem& s, const float* ch_re,
                             const float* ch_im, int b) {
  const int na = d.n_active;
  for (int a = threadIdx.x; a < na; a += blockDim.x) {
    s.ch[a] = ch_re[(size_t)b * na + a];
    s.ch[na + a] = ch_im[(size_t)b * na + a];
  }
  __syncthreads();
  eq_tables(d, s);
}

// 6. kGroup data symbols of stream b at start + 3*sym
__global__ void __launch_bounds__(kThreadsS)
receive_demod_kernel(const float* __restrict__ signals, const int* __restrict__ n_valid, int T,
                     const float* __restrict__ stats, const int* __restrict__ start,
                     const float* __restrict__ ch_re, const float* __restrict__ ch_im, Demod d,
                     int max_syms, signed char* bits_out) {
  extern __shared__ float smem[];
  const int b = blockIdx.y, k0 = blockIdx.x * kGroup;
  const DemodSmem s = carve(d, smem);
  load_channel(d, s, ch_re, ch_im, b);
  const PreSrc pre = pre_src(signals, n_valid, stats, T, b);
  demod_group(pre, start[b] + 3 * (d.fft + d.cp), d, k0, min(kGroup, max_syms - k0),
              bits_out + (size_t)b * max_syms * d.nd * d.bps, s);
}

// ---- kernel B: frame-aligned chunk demod ----
//
// Replaces audio_modem_tpu/kernels/receive.py::_chunk_kernel (entry
// decode_chunks_fused). Per frame (one CTA): max |x| over the row, samples
// divided by it (passthrough when <= 1e-6), CE at 2*sym + cp, n_sym symbols.
// What bounds it on the H100: the frame is read twice (max, then the CE and
// data symbols) and the DFT is ~0.45 MFLOP per symbol from shared memory, so
// at 64 frames it is latency-bound on 64 CTAs; batching more frames per launch
// is what fills the card.

struct ScaledSrc {
  const float* x;
  int T;
  float mx;
  bool big;
  __device__ float operator()(int i) const {
    if (i < 0 || i >= T) return 0.0f;
    return big ? __fdiv_rn(x[i], mx) : x[i];
  }
};

__global__ void __launch_bounds__(kThreadsB)
chunk_kernel(const float* __restrict__ frames, int T, Demod d, int n_sym, signed char* bits_out) {
  extern __shared__ float smem[];
  __shared__ float redf[33];
  const int b = blockIdx.x;
  const float* x = frames + (size_t)b * T;
  float mx = 0.0f;
  for (int i = threadIdx.x; i < T; i += blockDim.x) mx = fmaxf(mx, fabsf(x[i]));
  mx = block_max(mx, redf);
  const ScaledSrc src{x, T, mx, mx > 1e-6f};
  demod_frame(src, 0, d, n_sym, bits_out + (size_t)b * n_sym * d.nd * d.bps, smem);
}

// ---- streaming demod: a data region with a known channel ----
//
// Replaces audio_modem_tpu/kernels/receive.py::_chunk_stream_flat_kernel and
// ::_chunk_stream_pair_kernel (entries decode_chunks_fused_stream and
// decode_long_fused). Row b of ``data`` (row stride ld, L samples) starts at
// the CP of its first data symbol; each sample is multiplied by scale[b].
// The channel comes in the active-bin layout (ch_re, ch_im [B, n_active]).
// One CTA demodulates kGroup symbols of one stream: it builds that stream's
// EQ table, then runs demod_group. The TPU kernels' flat/pair split, 128-lane
// sections and 16-bit word packing are Mosaic layout and have no part here.
// What bounds it on the H100: the DFT reads the [fft, 2*nd + 2*npi] tables
// once per kGroup symbols (from L2; 290 KB for the acoustic profile, 905 KB
// for the standard one), so L2 bandwidth and FMA issue, not device memory
// (each sample is read once). The grid is over symbols as well as streams,
// so a single stream (the decoder's B = 1) still spreads over every SM.

struct StreamSrc {
  const float* x;
  int L;
  float scale;
  __device__ float operator()(int i) const {
    return (i >= 0 && i < L) ? __fmul_rn(x[i], scale) : 0.0f;
  }
};

__global__ void __launch_bounds__(kThreadsS)
stream_demod_kernel(const float* __restrict__ data, long long ld, int L,
                    const float* __restrict__ ch_re, const float* __restrict__ ch_im,
                    const float* __restrict__ scale, Demod d, int n_sym, signed char* bits_out) {
  extern __shared__ float smem[];
  const int b = blockIdx.y, k0 = blockIdx.x * kGroup;
  const DemodSmem s = carve(d, smem);
  load_channel(d, s, ch_re, ch_im, b);
  const StreamSrc src{data + (size_t)b * ld, L, scale[b]};
  demod_group(src, 0, d, k0, min(kGroup, n_sym - k0),
              bits_out + (size_t)b * n_sym * d.nd * d.bps, s);
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

Demod make_demod(const float* rx_active, const float* ce_known, const float* rx_data,
                 const float* rx_pilot, const int* data_pos, const int* pilot_pos, int fft,
                 int cp, int n_active, int nd, int npi, float qam_scale, int bps) {
  return Demod{rx_active, ce_known, rx_data, rx_pilot, data_pos, pilot_pos,
               fft,       cp,       n_active, nd,     npi,      bps,       qam_scale};
}

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
                       const float* ce_known, const float* rx_data, const float* rx_pilot,
                       const int* data_pos, const int* pilot_pos, int fft, int cp, int n_active,
                       int nd, int npi, float qam_scale, int bps, int max_syms, int n_pos,
                       float* scratch, int* start, int* coarse, float* cmetric, float* fine,
                       unsigned char* detected, signed char* bits, float* ch_re, float* ch_im,
                       cudaStream_t stream) {
  if (T < 1 || n_pos < 1 || fft != 2 * kHalfBlocks * kStride || cp > 256 || fft + cp > kMaxSym ||
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
  const Demod d = make_demod(rx_active, ce_known, rx_data, rx_pilot, data_pos, pilot_pos, fft, cp,
                             n_active, nd, npi, qam_scale, bps);
  const size_t smem = sizeof(float) * demod_smem_floats(d);
  cudaError_t err = cudaFuncSetAttribute(receive_demod_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
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
  const dim3 grid((max_syms + kGroup - 1) / kGroup, B);
  receive_demod_kernel<<<grid, kThreadsS, smem, stream>>>(signals, n_valid, T, stats, start, ch_re,
                                                          ch_im, d, max_syms, bits);
  return (int)cudaGetLastError();
}

int amtpu_decode_chunks_fused(const float* frames, int B, int T, const float* rx_active,
                              const float* ce_known, const float* rx_data, const float* rx_pilot,
                              const int* data_pos, const int* pilot_pos, int fft, int cp,
                              int n_active, int nd, int npi, float qam_scale, int bps, int n_sym,
                              signed char* bits, cudaStream_t stream) {
  const Demod d = make_demod(rx_active, ce_known, rx_data, rx_pilot, data_pos, pilot_pos, fft, cp,
                             n_active, nd, npi, qam_scale, bps);
  const size_t smem = sizeof(float) * demod_smem_floats(d);
  cudaError_t err = cudaFuncSetAttribute(chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  chunk_kernel<<<B, kThreadsB, smem, stream>>>(frames, T, d, n_sym, bits);
  return (int)cudaGetLastError();
}

int amtpu_stream_demod(const float* data, int B, long long ld, int L, const float* ch_re,
                       const float* ch_im, const float* scale, const float* rx_active,
                       const float* ce_known, const float* rx_data, const float* rx_pilot,
                       const int* data_pos, const int* pilot_pos, int fft, int cp, int n_active,
                       int nd, int npi, float qam_scale, int bps, int n_sym, signed char* bits,
                       cudaStream_t stream) {
  const Demod d = make_demod(rx_active, ce_known, rx_data, rx_pilot, data_pos, pilot_pos, fft, cp,
                             n_active, nd, npi, qam_scale, bps);
  const size_t smem = sizeof(float) * demod_smem_floats(d);
  cudaError_t err = cudaFuncSetAttribute(stream_demod_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_sym + kGroup - 1) / kGroup, B);
  stream_demod_kernel<<<grid, kThreadsS, smem, stream>>>(data, ld, L, ch_re, ch_im, scale, d, n_sym,
                                                         bits);
  return (int)cudaGetLastError();
}

}  // extern "C"
