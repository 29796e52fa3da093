// Mixture synthesis with the fused mel epilogue, for float32, bfloat16 and
// int8 banks: synth_mel_f32, synth_mel_bf16 and synth_mel_int8.
//
// Replaces challenge_tpu/ops/pallas_synth.py::_kernel in its fourth mode
// (B4), synthesize_windows(..., mel=(melm, tmask, fmask)),
// pallas_synth.py:283-334, which make_feature_fn(..., fused_mel=True)
// calls once a batch. The three other modes are synth.cu.
//
// What it computes, per sample b, window row t, channel c and mel bin m,
// with acc the ordered float32 sum of synth.cu (ordered_pair below: the
// background window, then each active voice and noise clip in slot order,
// every multiply and add rounded once, int8 banks dequantized):
//   mag[t, c, f] = sqrt(acc[t, c*freq + f]^2 + acc[t, half + c*freq + f]^2)
//   x[t, c, f]   = mag[t, c, f] * fmask[b, c*freq + f]
//   mel[b, m, t, c] = tmask[b, t]
//                     * sum over f, increasing, of x[t, c, f] * melm[f, m]
//   mm[b] = (min, max) of mel[b] over m, t and c
// in float32 for every bank type: the magnitude is the float32 root, not
// rounded to bfloat16 first as B3's output is. melm is passed as its
// nonzero band, per mel bin the rows f (ascending) and weights of its
// nonzero entries. Every term is >= 0 (the masks are {0,1}), so leaving
// out the zero terms of the sum is exact, and so is synthesizing only the
// columns f_lo .. f_lo + n_f - 1 that meet a nonzero weight: no other
// column reaches the output. Kernel and plain version (ops/synth.py,
// synthesize_mel_plain) take the same rounded products and sums in the
// same order and agree bit for bit. The output layout is the model's,
// [batch, n_mels, n_frame, chans].
//
// Bound: bytes. Per call it must read each sample's background window and
// the rows of each active clip that land in the window, over the band's
// columns only (2 x n_f of the 2 x freq columns of each complex plane pair;
// 118 of 257 frequency rows for an 80-bin mel), the slot tables, the masks
// and the band, and write the mel and mm, each once; chip_smoke.py's
// mel_work counts them from the draws (and states the count over all
// columns beside it). The arithmetic, a few flops per clip element and
// about 6 per nonzero mel product, is far below the card's float32 rate.
//
// Design. One block per (row tile of kRows window rows, sample). Warp 0
// gathers the tile's active slots (synth_common.cuh, shared with synth.cu);
// the band goes to shared memory. Phase 1: each thread owns one band column of one channel
// and walks the tile's rows, taking the ordered sum of its (re, im) pair,
// the root and the frequency mask, into a [kRows, chans x n_f] tile of
// masked magnitudes in shared memory (16 KB at most for 257 rows). The
// complex window and the magnitude never reach device memory. Phase 2:
// each thread takes outputs (m, t, c), consecutive threads on consecutive
// (t, c) of one bin so that stores coalesce, sums the bin's nonzero band
// terms in increasing f, applies the time mask and keeps a running min and
// max. Phase 3: a warp-shuffle and shared-memory reduction, then one
// atomicMin and one atomicMax per block on mm[b]'s bits as unsigned ints:
// the values are >= 0, where the integer order is the float order, so the
// result is exact and the same whatever order the blocks run in. A small
// kernel launched first on the same stream sets mm to (+inf, 0). Bank
// type and int8 background scale are template parameters, as in synth.cu.
// The TPU kernel's software pipeline, 128-lane mm row and block-diagonal
// mel matrix are layout devices of Mosaic and are not carried over. Unlike
// synth.cu, B4 still reads its bank rows straight from device memory, one
// element per thread per load.

#include "synth_common.cuh"

namespace {

using synth::kMaxSlots;

constexpr int kRows = 8;        // window rows per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 48 * 1024;   // without the opt-in attribute

// The nonzero band of the mel matrix [freq, n_mels], per mel bin (CSR).
struct Band {
  const int* off;     // [n_mels + 1]: bin m's entries are off[m] .. off[m+1]
  const int* row;     // [nnz] frequency rows, ascending within a bin
  const float* w;     // [nnz] weights
  int nnz, n_mels;
  int f_lo, n_f;      // the synthesized columns: rows f_lo .. f_lo + n_f - 1
  int freq;           // frequency rows per channel plane
};

// The ordered float32 sum of window row t at the column pair (m, half + m):
// the background element (times the int8 background scale), then each slot
// whose row covers t, in order, every multiply and add rounded once.
template <typename T, bool kScaled>
__device__ __forceinline__ void ordered_pair(const synth::Slots<T>& s,
                                             const T* win, float bgscale,
                                             int t, int m, int half,
                                             int width, float& re,
                                             float& im) {
  // banks are read-only for the whole call: __ldg keeps the loads on the
  // read-only path that __restrict__ parameters gave them
  re = synth::upcast(__ldg(win + (long long)t * width + m));
  im = synth::upcast(__ldg(win + (long long)t * width + half + m));
  if (kScaled) {                                    // int8 banks
    re = __fmul_rn(re, bgscale);
    im = __fmul_rn(im, bgscale);
  }
  const int n = s.n;
  for (int k = 0; k < n; ++k) {
    const int j = t - s.shift[k];
    if (j >= 0 && j < s.len[k]) {
      const T* row = s.clip[k] + (long long)j * width;
      re = __fadd_rn(re, __fmul_rn(s.w[k], synth::upcast(__ldg(row + m))));
      im = __fadd_rn(im, __fmul_rn(s.w[k],
                                   synth::upcast(__ldg(row + half + m))));
    }
  }
}

__global__ void mm_init(unsigned int* mm, int batch) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < batch) {
    mm[2 * i] = 0x7f800000u;          // +inf: the min of nothing
    mm[2 * i + 1] = 0u;               // +0: the max of nothing >= 0
  }
}

template <typename T, bool kScaled>
__global__ void __launch_bounds__(kThreads) synth_mel_kernel(
    const synth::Sources<T> src, const Band band,
    const float* __restrict__ tmask, const float* __restrict__ fmask,
    float* __restrict__ mel, unsigned int* __restrict__ mm, int n_frame,
    int width, int chans) {
  extern __shared__ float smem[];
  __shared__ synth::Slots<T> s;
  __shared__ float s_lo[kWarps], s_hi[kWarps];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRows;
  const int t1 = min(t0 + kRows, n_frame);
  const int half = width / 2;
  const int n_cols = chans * band.n_f;
  float* s_mag = smem;                                 // [kRows, n_cols]
  int* s_off = reinterpret_cast<int*>(s_mag + kRows * n_cols);
  int* s_row = s_off + band.n_mels + 1;                // relative to f_lo
  float* s_w = reinterpret_cast<float*>(s_row + band.nnz);

  if (threadIdx.x < 32) synth::gather_slots(src, b, t0, t1, s);
  for (int i = threadIdx.x; i <= band.n_mels; i += kThreads) {
    s_off[i] = band.off[i];
  }
  for (int i = threadIdx.x; i < band.nnz; i += kThreads) {
    s_row[i] = band.row[i] - band.f_lo;
    s_w[i] = band.w[i];
  }
  __syncthreads();

  // 1. the masked magnitudes of the band's columns, for the tile's rows
  const T* win = src.bg + (long long)src.bidx[b] * src.bg_stride
                        + (long long)src.boff[b] * width;
  const float bgscale = kScaled ? src.bgscale[b] : 1.0f;
  for (int k = threadIdx.x; k < n_cols; k += kThreads) {
    const int c = k / band.n_f;
    const int col = c * band.freq + band.f_lo + (k - c * band.n_f);
    const float keep = fmask[(long long)b * half + col];
    for (int t = t0; t < t1; ++t) {
      float re, im;
      ordered_pair<T, kScaled>(s, win, bgscale, t, col, half, width, re,
                               im);
      s_mag[(t - t0) * n_cols + k] =
          __fmul_rn(synth::magnitude(re, im), keep);
    }
  }
  __syncthreads();

  // 2. the mel bins, in the model's layout, and their running min and max
  float lo = __int_as_float(0x7f800000), hi = 0.0f;
  const int per_bin = (t1 - t0) * chans;    // one bin's outputs in the tile
  for (int i = threadIdx.x; i < band.n_mels * per_bin; i += kThreads) {
    const int m = i / per_bin;
    const int r = i - m * per_bin;
    const int tl = r / chans;
    const int c = r - tl * chans;
    const float* x = s_mag + tl * n_cols + c * band.n_f;
    float acc = 0.0f;
    for (int j = s_off[m]; j < s_off[m + 1]; ++j) {
      acc = __fadd_rn(acc, __fmul_rn(x[s_row[j]], s_w[j]));
    }
    const int t = t0 + tl;
    const float v = __fmul_rn(acc, tmask[(long long)b * n_frame + t]);
    mel[(((long long)b * band.n_mels + m) * n_frame + t) * chans + c] = v;
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }

  // 3. the block's min and max, then one atomic each on mm[b]
  for (int o = 16; o > 0; o /= 2) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (threadIdx.x % 32 == 0) {
    s_lo[threadIdx.x / 32] = lo;
    s_hi[threadIdx.x / 32] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      lo = fminf(lo, s_lo[w]);
      hi = fmaxf(hi, s_hi[w]);
    }
    atomicMin(mm + 2 * b, __float_as_uint(lo));
    atomicMax(mm + 2 * b + 1, __float_as_uint(hi));
  }
}

template <typename T, bool kScaled>
int launch(const synth::Sources<T>& src, const Band& band,
           const float* tmask, const float* fmask, float* mel, float* mm,
           int batch, int n_frame, int width, void* stream) {
  const int chans = band.freq > 0 ? width / (2 * band.freq) : 0;
  const size_t smem = sizeof(float) * kRows * chans * band.n_f
                      + sizeof(int) * (band.n_mels + 1)
                      + (sizeof(int) + sizeof(float)) * band.nnz;
  if (src.n_v + src.n_x > kMaxSlots || batch > 65535 || chans < 1
      || width != 2 * chans * band.freq || band.f_lo < 0 || band.n_f < 1
      || band.f_lo + band.n_f > band.freq || band.n_mels < 1
      || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || n_frame == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned int* mm_bits = reinterpret_cast<unsigned int*>(mm);
  mm_init<<<(batch + kThreads - 1) / kThreads, kThreads, 0, st>>>(mm_bits,
                                                                  batch);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 grid((n_frame + kRows - 1) / kRows, batch);
  synth_mel_kernel<T, kScaled><<<grid, kThreads, smem, st>>>(
      src, band, tmask, fmask, mel, mm_bits, n_frame, width, chans);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() (0
// on success). Sources as synth.cu's entry points. The band of the mel
// matrix [freq, n_mels]: `band_off` [n_mels + 1], `band_row` and `band_w`
// [nnz] (int32, int32, float32), rows ascending within each bin and inside
// [f_lo, f_lo + n_f). `tmask` [batch, n_frame] and `fmask` [batch, width /
// 2] are float32 {0,1} masks. The caller allocates `mel` [batch, n_mels,
// n_frame, width / (2 * freq)] and `mm` [batch, 2], float32.
#define MEL_ENTRY(NAME, T, SCALED)                                            \
  extern "C" int NAME(                                                        \
      const T* bg, const int* bidx, const int* boff, long long bg_stride,     \
      const T* vbank, const int* vidx, const int* vshift, const float* vw,    \
      const int* vlen, int n_v, int v_rows, long long v_stride,               \
      const T* nbank, const int* nidx, const int* nshift, const float* nw,    \
      const int* nlen, int n_x, int n_rows, long long n_stride,               \
      const float* bgscale, const int* band_off, const int* band_row,         \
      const float* band_w, int nnz, int n_mels, int f_lo, int n_f, int freq,  \
      const float* tmask, const float* fmask, float* mel, float* mm,          \
      int batch, int n_frame, int width, void* stream) {                      \
    if ((bgscale != nullptr) != SCALED) {                                     \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    }                                                                         \
    const synth::Sources<T> src{bg, bidx, boff, bg_stride, vbank, vidx,      \
                                vshift, vw, vlen, n_v, v_rows, v_stride,      \
                                nbank, nidx, nshift, nw, nlen, n_x, n_rows,   \
                                n_stride, bgscale};                           \
    const Band band{band_off, band_row, band_w, nnz, n_mels, f_lo, n_f,       \
                    freq};                                                    \
    return launch<T, SCALED>(src, band, tmask, fmask, mel, mm, batch,         \
                             n_frame, width, stream);                         \
  }

MEL_ENTRY(synth_mel_f32, float, false)
MEL_ENTRY(synth_mel_bf16, __nv_bfloat16, false)
MEL_ENTRY(synth_mel_int8, int8_t, true)
