// Receive kernels for Hopper (sm_90a): the full per-stream receive (kernel A),
// the frame-aligned chunk demod (kernel B) and the streaming demod of a data
// region whose channel is already known, with a plain C interface for ctypes
// (see kernels/_build.py). A and B run one CTA per stream or frame; the
// streaming demod one CTA per (group of kGroup symbols, stream).
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

constexpr int kThreadsA = 1024;  // kernel A: one CTA per stream
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

// Channel estimate at frame offset 2*sym + cp, then n_sym data symbols at
// 3*sym + cp + k*sym, from sample source ``src`` (reads 0 out of range).
template <class Src>
__device__ void demod_frame(const Src& src, int base, const Demod& d, int n_sym,
                            signed char* bits, float* ch_re_out, float* ch_im_out,
                            float* smem) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int fft = d.fft, na = d.n_active;
  const int sym = fft + d.cp;
  const DemodSmem s = carve(d, smem);

  // CE: H = DFT(body) * known sign (phy.estimate_channel)
  for (int n = tid; n < fft; n += nt) s.body[n] = src(base + 2 * sym + d.cp + n);
  __syncthreads();
  for (int c = tid; c < 2 * na; c += nt) {
    float acc = 0.0f;
    for (int n = 0; n < fft; ++n) acc = fmaf(s.body[n], d.rx_active[n * 2 * na + c], acc);
    s.ch[c] = __fmul_rn(acc, d.ce_known[c < na ? c : c - na]);
  }
  __syncthreads();
  for (int a = tid; a < na; a += nt) {
    if (ch_re_out) ch_re_out[a] = s.ch[a];
    if (ch_im_out) ch_im_out[a] = s.ch[na + a];
  }
  eq_tables(d, s);
  for (int k0 = 0; k0 < n_sym; k0 += kGroup)
    demod_group(src, base + 3 * sym, d, k0, min(kGroup, n_sym - k0), bits, s);
}

// ---- kernel A: full receive ----
//
// Replaces audio_modem_tpu/kernels/receive.py::_receive_kernel (entry
// decode_fused). Per stream (one CTA of 1024 threads):
//   1. preprocess: mean over n_valid (fixed pairwise order), max |x - mean|;
//      the normalized sample is recomputed from x wherever it is read, so the
//      [B, T] window is never copied;
//   2. 16-sample block sums of s[i]*s[i+256] and s[i]^2 (global scratch);
//   3. strided Schmidl-Cox metric P^2/(Ra*Rb) from 16-block doubling sums;
//   4. first-peak commit: prefix max over thread chunks, first drop below
//      0.7x the running max, first maximal index of the prefix;
//   5. +-3*CP normalized xcorr refine against preamble 1 (shared memory);
//   6. CE and demod at the refined start (demod_frame).
// What bounds it on the H100: bytes from device memory. The window is read
// about three times (mean, max, block sums) plus the refine region and the
// frame; at B = 64, T = 914,688 that is ~0.7 GB. The metric scratch is
// ~1/16 of the window and stays in L2. The design keeps every pass a
// coalesced stream over the row and nothing else of window size in memory.
// Load balance: 64 CTAs on 132 SMs leave half the card idle; splitting a
// stream's scan over several CTAs is the first thing to change.

struct PreSrc {
  const float* x;
  int T, nv;
  float mean, scale;
  __device__ float operator()(int i) const {
    return (i >= 0 && i < nv && i < T) ? __fmul_rn(__fsub_rn(x[i], mean), scale) : 0.0f;
  }
};

__device__ float window16(const float* b) {
  // S16 of sync.windowed_sum: ((b0+b1)+(b2+b3)) + ... balanced over adjacent pairs
  float s2[8], s4[4], s8[2];
  for (int i = 0; i < 8; ++i) s2[i] = __fadd_rn(b[2 * i], b[2 * i + 1]);
  for (int i = 0; i < 4; ++i) s4[i] = __fadd_rn(s2[2 * i], s2[2 * i + 1]);
  for (int i = 0; i < 2; ++i) s8[i] = __fadd_rn(s4[2 * i], s4[2 * i + 1]);
  return __fadd_rn(s8[0], s8[1]);
}

__global__ void __launch_bounds__(kThreadsA)
receive_kernel(const float* __restrict__ signals, const int* __restrict__ n_valid,
               const int* __restrict__ min_pos, int T, const float* __restrict__ pre1,
               float t_energy, Demod d, int max_syms, int nb_p, int nb_e, int n_pos,
               float* block_p, float* block_e, float* metric_all, int* start_out,
               int* coarse_out, float* cmetric_out, float* fine_out, unsigned char* detected_out,
               signed char* bits_out, float* ch_re_out, float* ch_im_out) {
  extern __shared__ float smem[];
  __shared__ float lanes[kSumLanes];
  __shared__ float region[kMaxRegion];
  __shared__ float tmpl[kMaxSym];
  __shared__ float redf[33];
  __shared__ int redi[33];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int nv = n_valid[b], mp = min_pos[b];
  const int sym = d.fft + d.cp, half = d.fft / 2;
  const float* x = signals + (size_t)b * T;
  float* bp = block_p + (size_t)b * nb_p;
  float* be = block_e + (size_t)b * nb_e;
  float* metric = metric_all + (size_t)b * n_pos;

  // 1. preprocess: pairwise sum over rows of SUM_LANES, then halve the lanes
  int m = 1;
  while (m * kSumLanes < T) m *= 2;
  {
    float stk[24];
    int sp = 0;
    for (int k = 0; k < m; ++k) {
      const int i = k * kSumLanes + tid;
      float v = (i < T && i < nv) ? x[i] : 0.0f;
      for (int c = k; c & 1; c >>= 1) v = __fadd_rn(stk[--sp], v);
      stk[sp++] = v;
    }
    lanes[tid] = stk[0];
  }
  __syncthreads();
  for (int h = kSumLanes / 2; h > 0; h >>= 1) {
    if (tid < h) lanes[tid] = __fadd_rn(lanes[tid], lanes[tid + h]);
    __syncthreads();
  }
  const float mean = __fdiv_rn(lanes[0], fmaxf((float)nv, 1.0f));
  float amax = 0.0f;
  for (int i = tid; i < min(nv, T); i += kThreadsA) amax = fmaxf(amax, fabsf(__fsub_rn(x[i], mean)));
  amax = block_max(amax, redf);
  const PreSrc pre{x, T, nv, mean, amax > 1e-6f ? __frcp_rn(amax) : 1.0f};

  // 2. block sums, samples added in order
  for (int q = tid; q < nb_e; q += kThreadsA) {
    const int i0 = q * kStride;
    float e = 0.0f, p = 0.0f;
    for (int j = 0; j < kStride; ++j) {
      const float s = pre(i0 + j);
      e = j ? __fadd_rn(e, __fmul_rn(s, s)) : __fmul_rn(s, s);
      if (q < nb_p) {
        const float pr = __fmul_rn(s, pre(i0 + j + half));
        p = j ? __fadd_rn(p, pr) : pr;
      }
    }
    be[q] = e;
    if (q < nb_p) bp[q] = p;
  }
  __syncthreads();

  // 3. metric at d = 16k
  for (int k = tid; k < n_pos; k += kThreadsA) {
    float w[kHalfBlocks];
    for (int j = 0; j < kHalfBlocks; ++j) w[j] = bp[k + j];
    const float p = window16(w);
    for (int j = 0; j < kHalfBlocks; ++j) w[j] = be[k + j];
    const float ra = window16(w);
    for (int j = 0; j < kHalfBlocks; ++j) w[j] = be[k + kHalfBlocks + j];
    const float rb = window16(w);
    const int dpos = k * kStride;
    const bool valid = dpos <= nv - 2 * half && dpos >= mp && ra > kMinEnergy && rb > kMinEnergy;
    metric[k] = valid ? __fdiv_rn(__fmul_rn(p, p), __fmul_rn(ra, rb)) : 0.0f;
  }
  __syncthreads();

  // 4. first-peak commit
  const int chunk = (n_pos + kThreadsA - 1) / kThreadsA;
  const int k_lo = min(tid * chunk, n_pos), k_hi = min(k_lo + chunk, n_pos);
  float cmax = 0.0f;
  for (int k = k_lo; k < k_hi; ++k) cmax = fmaxf(cmax, metric[k]);
  lanes[tid] = cmax;
  __syncthreads();
  for (int off = 1; off < kThreadsA; off <<= 1) {  // inclusive prefix max
    const float v = tid >= off ? lanes[tid - off] : 0.0f;
    __syncthreads();
    lanes[tid] = fmaxf(lanes[tid], v);
    __syncthreads();
  }
  float run = tid ? lanes[tid - 1] : 0.0f;
  int first = INT_MAX;
  for (int k = k_lo; k < k_hi; ++k) {
    run = fmaxf(run, metric[k]);
    if (run > kAutocorrThreshold && metric[k] < __fmul_rn(0.7f, run)) {
      first = k;
      break;
    }
  }
  int fd = block_min(first, redi);
  if (fd == INT_MAX) fd = n_pos - 1;
  float best = 0.0f;
  for (int k = tid; k <= fd; k += kThreadsA) best = fmaxf(best, metric[k]);
  best = block_max(best, redf);
  int kbest = INT_MAX;
  for (int k = tid; k <= fd; k += kThreadsA)
    if (metric[k] == best) {
      kbest = k;
      break;
    }
  kbest = block_min(kbest, redi);
  const int coarse = best > kAutocorrThreshold ? kbest * kStride : -1;

  // 5. xcorr refine over [lo, hi]
  const int radius = 3 * d.cp, n_off = 2 * radius + 1;
  const int c = max(coarse, 0);
  const int lo = max(c - radius, 0), hi = min(nv - sym, c + radius);
  for (int i = tid; i < n_off + sym - 1; i += kThreadsA) region[i] = pre(lo + i);
  for (int i = tid; i < sym; i += kThreadsA) tmpl[i] = pre1[i];
  __syncthreads();
  float fm = -INFINITY;
  int dbest = INT_MAX;
  float mloc[2] = {-INFINITY, -INFINITY};
  for (int o = tid, r = 0; o < n_off; o += kThreadsA, ++r) {
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
  for (int o = tid, r = 0; o < n_off; o += kThreadsA, ++r)
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

  // 6. CE + demod at the refined start
  demod_frame(pre, start, d, max_syms, bits_out + (size_t)b * max_syms * d.nd * d.bps,
              ch_re_out + (size_t)b * d.n_active, ch_im_out + (size_t)b * d.n_active, smem);
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
  demod_frame(src, 0, d, n_sym, bits_out + (size_t)b * n_sym * d.nd * d.bps, nullptr, nullptr,
              smem);
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
  const int b = blockIdx.y, k0 = blockIdx.x * kGroup, na = d.n_active;
  const DemodSmem s = carve(d, smem);
  for (int a = threadIdx.x; a < na; a += blockDim.x) {
    s.ch[a] = ch_re[(size_t)b * na + a];
    s.ch[na + a] = ch_im[(size_t)b * na + a];
  }
  __syncthreads();
  eq_tables(d, s);
  const StreamSrc src{data + (size_t)b * ld, L, scale[b]};
  demod_group(src, 0, d, k0, min(kGroup, n_sym - k0),
              bits_out + (size_t)b * n_sym * d.nd * d.bps, s);
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

int amtpu_decode_fused(const float* signals, const int* n_valid, const int* min_pos, int B, int T,
                       const float* pre1, float t_energy, const float* rx_active,
                       const float* ce_known, const float* rx_data, const float* rx_pilot,
                       const int* data_pos, const int* pilot_pos, int fft, int cp, int n_active,
                       int nd, int npi, float qam_scale, int bps, int max_syms, int nb_p, int nb_e,
                       int n_pos, float* block_p, float* block_e, float* metric, int* start,
                       int* coarse, float* cmetric, float* fine, unsigned char* detected,
                       signed char* bits, float* ch_re, float* ch_im, cudaStream_t stream) {
  const Demod d = make_demod(rx_active, ce_known, rx_data, rx_pilot, data_pos, pilot_pos, fft, cp,
                             n_active, nd, npi, qam_scale, bps);
  const size_t smem = sizeof(float) * demod_smem_floats(d);
  cudaError_t err = cudaFuncSetAttribute(receive_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  receive_kernel<<<B, kThreadsA, smem, stream>>>(signals, n_valid, min_pos, T, pre1, t_energy, d,
                                                 max_syms, nb_p, nb_e, n_pos, block_p, block_e,
                                                 metric, start, coarse, cmetric, fine, detected,
                                                 bits, ch_re, ch_im);
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
