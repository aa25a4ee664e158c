// Receive kernels for Hopper (sm_90a): the full per-stream receive (kernel A)
// and the frame-aligned chunk demod (kernel B), with a plain C interface for
// ctypes (see kernels/_build.py). One CTA per stream or frame.
//
// Both kernels end in the same demod (CE, then per symbol: DFT at the data and
// pilot bins, ZF EQ, pilot phase, hard demap, int8 bits), shared below as
// device functions. Everything is float32. Where a sum decides the coarse
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
constexpr int kSumLanes = 1024;  // sync.SUM_LANES
constexpr int kStride = 16;      // sync.COARSE_STRIDE
constexpr int kHalfBlocks = 16;  // (fft / 2) / kStride for fft = 512
constexpr int kMaxSym = 768;     // longest symbol of any profile (narrowband)
constexpr int kMaxRegion = 6 * 256 + 1 + kMaxSym - 1;  // refine region at cp = 256
constexpr int kGroup = 4;        // data symbols per demod pass
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

// Channel estimate at frame offset 2*sym + cp, then n_sym data symbols at
// 3*sym + cp + k*sym, from sample source ``src`` (reads 0 out of range).
// Bits go out bin-major, MSB first within a bin (phy.demodulate's order).
template <class Src>
__device__ void demod_frame(const Src& src, int base, const Demod& d, int n_sym,
                            signed char* bits, float* ch_re_out, float* ch_im_out,
                            float* smem) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int fft = d.fft, na = d.n_active, nd = d.nd, npi = d.npi, bps = d.bps;
  const int sym = fft + d.cp;
  const int ncol = 2 * nd + 2 * npi;
  float* ch = smem;                     // [2*na]: re | im
  float* hd = ch + 2 * na;              // [3*nd]: re | im | den (0 = passthrough)
  float* hp = hd + 3 * nd;              // [3*npi]
  float* body = hp + 3 * npi;           // [kGroup*fft]
  float* spec = body + kGroup * fft;    // [kGroup*ncol]
  float* phi = spec + kGroup * ncol;    // [kGroup]

  // CE: H = DFT(body) * known sign (phy.estimate_channel)
  for (int n = tid; n < fft; n += nt) body[n] = src(base + 2 * sym + d.cp + n);
  __syncthreads();
  for (int c = tid; c < 2 * na; c += nt) {
    float acc = 0.0f;
    for (int n = 0; n < fft; ++n) acc = fmaf(body[n], d.rx_active[n * 2 * na + c], acc);
    ch[c] = __fmul_rn(acc, d.ce_known[c < na ? c : c - na]);
  }
  __syncthreads();
  for (int a = tid; a < na; a += nt) {
    if (ch_re_out) ch_re_out[a] = ch[a];
    if (ch_im_out) ch_im_out[a] = ch[na + a];
  }
  for (int j = tid; j < nd + npi; j += nt) {
    const bool data = j < nd;
    const int pos = data ? d.data_pos[j] : d.pilot_pos[j - nd];
    const float hr = ch[pos], hi = ch[na + pos];
    const float mag = __fadd_rn(__fmul_rn(hr, hr), __fmul_rn(hi, hi));
    float* h = data ? hd : hp;
    const int m = data ? nd : npi, i = data ? j : j - nd;
    h[i] = hr;
    h[m + i] = hi;
    h[2 * m + i] = mag > 1e-10f ? mag : 0.0f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < n_sym; k0 += kGroup) {
    const int g = min(kGroup, n_sym - k0);
    for (int i = tid; i < g * fft; i += nt) {
      const int k = i / fft, n = i - k * fft;
      body[i] = src(base + 3 * sym + d.cp + (k0 + k) * sym + n);
    }
    __syncthreads();
    // DFT at the data and pilot bins: one dot product of fft taps per column
    for (int i = tid; i < g * ncol; i += nt) {
      const int k = i / ncol, c = i - k * ncol;
      const float* tab = c < 2 * nd ? d.rx_data + c : d.rx_pilot + (c - 2 * nd);
      const int w = c < 2 * nd ? 2 * nd : 2 * npi;
      const float* b = body + k * fft;
      float acc = 0.0f;
      for (int n = 0; n < fft; ++n) acc = fmaf(b[n], tab[n * w], acc);
      spec[i] = acc;
    }
    __syncthreads();
    // pilot phase: mean of Im/Re over pilots with |Re| > 1e-6
    if (tid < g) {
      const float* s = spec + tid * ncol + 2 * nd;
      float sum = 0.0f;
      int cnt = 0;
      for (int j = 0; j < npi; ++j) {
        float pr, pi;
        equalize(s[j], s[npi + j], hp[j], hp[npi + j], hp[2 * npi + j], hp[2 * npi + j] > 0.0f,
                 pr, pi);
        if (fabsf(pr) > 1e-6f) {
          sum = __fadd_rn(sum, __fdiv_rn(pi, pr));
          ++cnt;
        }
      }
      phi[tid] = cnt > 0 ? __fdiv_rn(sum, (float)cnt) : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < g * nd; i += nt) {
      const int k = i / nd, j = i - k * nd;
      const float* s = spec + k * ncol;
      float dr, di;
      equalize(s[j], s[nd + j], hd[j], hd[nd + j], hd[2 * nd + j], hd[2 * nd + j] > 0.0f, dr, di);
      const float p = phi[k];
      const float cr = __fadd_rn(dr, __fmul_rn(di, p));
      const float ci = __fsub_rn(di, __fmul_rn(dr, p));
      const int idx = demap_index(cr, ci, bps, d.qam_scale);
      signed char* out = bits + ((size_t)(k0 + k) * nd + j) * bps;
      for (int b = 0; b < bps; ++b) out[b] = (signed char)((idx >> (bps - 1 - b)) & 1);
    }
    __syncthreads();
  }
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

}  // extern "C"
