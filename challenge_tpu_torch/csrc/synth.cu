// Mixture synthesis for float32, bfloat16 and int8 banks, with the
// magnitude computed in the kernel, the raw complex window written out, or
// the se v9 targets' three windows written out in one pass.
//
// Replaces challenge_tpu/ops/pallas_synth.py::_kernel, the one TPU kernel,
// in three of its modes: the magnitude epilogue
// (synthesize_windows(..., magnitude=True)) with float32 banks (mode B1,
// synth_mag_f32) and with bfloat16 or int8 banks (mode B3, synth_mag_bf16
// and synth_mag_int8), and the flat-complex output (mode B2, the default
// epilogue, pallas_synth.py:279-281: synth_flat_f32, synth_flat_bf16 and
// synth_flat_int8). The se v9 targets call B2 three times a batch on the
// TPU (challenge_tpu/data/mixture.py:493-527); synth_se_f32, synth_se_bf16
// and synth_se_int8 compute the three windows in one launch. The fourth
// mode, the fused mel epilogue (B4), is synth_mel.cu; the slot table and
// the opt-in to large shared memory are shared with it (synth_common.cuh).
//
// What it computes, per sample b and window row t in [0, n_frame):
//   acc  = float(bg[bidx[b], boff[b] + t, :])               (flat row, F cols)
//          (int8 banks: acc = float(q_bg) * bgscale[b])
//   for each voice slot k, then each noise slot k, in slot order, w != 0:
//     j = t - shift[b, k];  if 0 <= j < len[b, k]:  acc += w[b, k] * float(clip[j, :])
//   magnitude: out[b, t, m] = sqrt(acc[m]^2 + acc[F/2 + m]^2)   m in [0, F/2)
//   raw:       out[b, t, c] = acc[c]                             c in [0, F)
//   se triple: the raw window of the full mix; of the background and the
//              noises alone (only_noise); of 0.0 and the voices alone
//              (only_voice), each in the same slot order
// The flat layout is channel-major (column c*f + freq), so the real planes
// are the first half of the columns and the imaginary planes the second.
// Clip rows that land outside [0, n_frame) are dropped. For int8 banks the
// caller folds each clip's dequantization scale into its weight
// (w * flat_scale[idx]) and passes the per-sample background scales. The
// output is float32 for float32 banks and bfloat16 for the other two.
//
// Exactness: the sum is an ordered float32 sum whatever the bank type:
// each element is upcast exactly, then every step is a rounded multiply and
// a rounded add (__fmul_rn / __fadd_rn, which nvcc never contracts into an
// FMA), in the same order as the JAX kernel and as the plain PyTorch
// version in ops/synth.py. sqrtf is the IEEE square root (no
// --use_fast_math); a bfloat16 output is the float32 root, or the float32
// accumulator, rounded once more, to nearest even (__float2bfloat16_rn).
// The triple's three sums are the separate calls' sums: only_noise skips
// the voices as the call with every voice weight zeroed does, and
// only_voice starts from +0.0, as the call over a zero background bank
// (times a unit scale) does. Staging changes where a value is read from,
// not the arithmetic. Kernel and plain version agree bit for bit.
//
// Bound: bytes. Per call it must read each sample's background window
// (n_frame x F elements of the bank type), the rows of each active clip
// that land in the window and the slot tables, and write the output
// (n_frame x F/2 elements of the output type for the magnitude, n_frame x
// F for the raw window, three of those for the triple), each once;
// chip_smoke.py's synth_work counts them from the draws. On the main path's
// draws (B=12, n_frame=512, F=4*257, 7 voice and 2 noise slots) the
// magnitude is about 51.7 MB a call for float32 banks, 26 MB for bfloat16
// and 16 MB for int8, bounds of about 15.4, 7.7 and 4.8 us at 3.35 TB/s;
// the raw window writes twice the output bytes; the triple reads what one
// raw window reads and writes three. The arithmetic (2 flops per element
// per clip, 4 and a root per magnitude) is far below the card's float32
// rate.
//
// Design. One block per (row tile, sample); a tile is 8 window rows (4 for
// the triple, whose three accumulators cost registers). A block has one thread per column pair (m, F/2 + m), F/2
// rounded up to a warp: 544 threads at F = 1028, each of which walks the
// tile's rows once, so no thread makes a pass the others do not (30 idle
// lanes of 544), and each column pair's sums live in that thread's
// registers, float32 whatever the bank type. F/2 may be at most 1024.
//   - The background rows of the tile, and each active slot's rows that
//     reach it, are one contiguous byte range each. They pass through a
//     ring of stages in shared memory (2, 3 and 4 stages for float32,
//     bfloat16 and int8 banks; a float32 8-row stage is 32.9 KB) by
//     16-byte cp.async.cg copies (synth_common.cuh's stage_range and its
//     alignment rule: bf16 and int8 rows start off 16-byte boundaries, and
//     2-D TMA maps need 16-byte row strides, so the copies are 1-D chunks
//     of the range rounded outwards, clamped at its end). While one source
//     is added from its stage, the next ones are in flight. The
//     background's copy starts before the slot table is read.
//   - One warp reads the sample's slot table, lane k slot k, and keeps the
//     active slots that reach the tile in slot order (a ballot and a prefix
//     count); no thread walks the table alone.
//   - The epilogue writes each output tile to shared memory, then out as
//     one contiguous range with 16-byte stores (element stores only at an
//     unaligned head or tail; every tile of the main path is aligned).
// The complex window of the magnitude epilogue never reaches device
// memory. No atomics; the order of each sum is fixed. Bank type, int8
// background scale and epilogue are template parameters, not runtime
// branches: a runtime flag once gave the float32 magnitude instance a
// stack frame and cost it time (PERF.md).
//
// What bounds it (PERF.md, on an H100): float32 banks run near the memory
// rate once the launch is counted. With 2- and 1-byte banks the time per
// sample stays about two thirds of float32's though the bytes are a half
// and a third: each block's chain of dependent steps (tile indices, slot
// table, copies, adds, epilogue) and the instructions per element, not the
// bytes, set their pace. Overlapping one tile's chain with the next tile's
// copies (persistent blocks) is the next step.

#include "synth_common.cuh"

namespace {

using synth::kMaxSlots;

constexpr int kMaxThreads = 1024;         // one column pair a thread
constexpr long long kMaxSmem = 232448;    // a block's opt-in maximum

enum Epilogue { kMag, kFlat, kTriple };

// Window rows per tile: 4 for the triple, whose three accumulators cost
// registers (of 2, 4 and 8 rows, 4 was the fastest for bf16 and int8 banks
// on an H100, and 8 for float32 by 7%; PERF.md).
template <int kEpi>
__host__ __device__ constexpr int tile_rows() {
  return kEpi == kTriple ? 4 : 8;
}

// Ring stages by bank element size: about 66, 49 and 33 KB a block at
// F = 1028 and 8 rows.
template <typename T>
__host__ __device__ constexpr int ring() {
  return sizeof(T) == 4 ? 2 : sizeof(T) == 2 ? 3 : 4;
}

template <typename T, typename Out, bool kScaled, int kEpi>
__global__ void __launch_bounds__(kMaxThreads) synth_kernel(
    const synth::Sources<T> src, Out* __restrict__ out,
    Out* __restrict__ out_noise, Out* __restrict__ out_voice, int n_frame,
    int width, int stage) {
  constexpr int kStages = ring<T>();
  constexpr int kRows = tile_rows<kEpi>();
  constexpr int kOuts = kEpi == kTriple ? 3 : 1;
  extern __shared__ __align__(16) char smem[];
  __shared__ synth::Slots<T> s;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRows;
  const int nr = min(kRows, n_frame - t0);
  const int half = width / 2;
  const int m = threadIdx.x;            // this thread's pair (m, half + m)
  const bool mine = m < half;

  // the background rows do not wait for the slot table
  const T* win = src.bg + (long long)src.bidx[b] * src.bg_stride
                        + (long long)(src.boff[b] + t0) * width;
  const float bgscale = kScaled ? src.bgscale[b] : 1.0f;
  synth::stage_range(smem, win, (long long)nr * width * sizeof(T));
  synth::cp_async_commit();
  if (threadIdx.x < 32) synth::gather_slots(src, b, t0, t0 + nr, s);
  __syncthreads();
  const int n_src = 1 + s.n;              // the background, then the slots

  // slot k's rows inside the tile: tile rows [lo, hi), from clip row
  // t0 + lo - shift on
  auto span = [&](int k, int& lo, int& hi) {
    lo = max(s.shift[k] - t0, 0);
    hi = min(s.shift[k] + s.len[k] - t0, nr);
  };
  auto first = [&](int k, int lo) {
    return s.clip[k] + (long long)(t0 + lo - s.shift[k]) * width;
  };
  auto fetch = [&](int i) {             // start source i's copy, if any
    if (i < n_src) {
      int lo, hi;
      span(i - 1, lo, hi);
      synth::stage_range(smem + (i % kStages) * stage, first(i - 1, lo),
                         (long long)(hi - lo) * width * sizeof(T));
    }
    synth::cp_async_commit();           // one group per source, even empty
  };
  for (int i = 1; i < kStages - 1; ++i) fetch(i);

  float acc[kOuts][kRows][2];
  for (int i = 0; i < n_src; ++i) {
    synth::cp_async_wait<kStages - 2>();  // source i has landed ...
    __syncthreads();                      // ... for all, and i - 1 is added
    fetch(i + kStages - 1);               // into the stage i - 1 used
    if (!mine) continue;
    const char* stg = smem + (i % kStages) * stage;
    if (i == 0) {
      const T* x = reinterpret_cast<const T*>(
          stg + (reinterpret_cast<uintptr_t>(win) & 15)) + m;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < nr) {
          float re = synth::upcast(x[r * width]);
          float im = synth::upcast(x[r * width + half]);
          if (kScaled) {                  // int8 banks
            re = __fmul_rn(re, bgscale);
            im = __fmul_rn(im, bgscale);
          }
          acc[0][r][0] = re;
          acc[0][r][1] = im;
          if (kEpi == kTriple) {
            acc[kOuts - 2][r][0] = re;    // only_noise
            acc[kOuts - 2][r][1] = im;
            acc[kOuts - 1][r][0] = 0.0f;  // only_voice
            acc[kOuts - 1][r][1] = 0.0f;
          }
        }
      }
    } else {
      const int k = i - 1;
      int lo, hi;
      span(k, lo, hi);
      const float w = s.w[k];
      const bool voice = k < s.nv;
      const T* x = reinterpret_cast<const T*>(
          stg + (reinterpret_cast<uintptr_t>(first(k, lo)) & 15)) + m;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= lo && r < hi) {          // staged row r - lo
          const T* row = x + (r - lo) * width;
          const float re = __fmul_rn(w, synth::upcast(row[0]));
          const float im = __fmul_rn(w, synth::upcast(row[half]));
          acc[0][r][0] = __fadd_rn(acc[0][r][0], re);
          acc[0][r][1] = __fadd_rn(acc[0][r][1], im);
          if (kEpi == kTriple) {
            if (voice) {
              acc[kOuts - 1][r][0] = __fadd_rn(acc[kOuts - 1][r][0], re);
              acc[kOuts - 1][r][1] = __fadd_rn(acc[kOuts - 1][r][1], im);
            } else {
              acc[kOuts - 2][r][0] = __fadd_rn(acc[kOuts - 2][r][0], re);
              acc[kOuts - 2][r][1] = __fadd_rn(acc[kOuts - 2][r][1], im);
            }
          }
        }
      }
    }
  }

  // epilogue: each output tile through shared memory, then 16-byte stores
  synth::cp_async_wait<0>();
  __syncthreads();
  const int ow = kEpi == kMag ? half : width;
#pragma unroll
  for (int o = 0; o < kOuts; ++o) {
    Out* dst = (o == 0 ? out : o == 1 ? out_noise : out_voice)
               + ((long long)b * n_frame + t0) * ow;
    Out* y = reinterpret_cast<Out*>(
        smem + (reinterpret_cast<uintptr_t>(dst) & 15));
    if (mine) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < nr) {
          if (kEpi == kMag) {
            synth::store(y + r * half + m,
                         synth::magnitude(acc[o][r][0], acc[o][r][1]));
          } else {
            synth::store(y + r * width + m, acc[o][r][0]);
            synth::store(y + r * width + half + m, acc[o][r][1]);
          }
        }
      }
    }
    __syncthreads();
    synth::store_range(dst, smem, (long long)nr * ow);
    if (o + 1 < kOuts) __syncthreads();
  }
}

template <typename T, typename Out, bool kScaled, int kEpi>
int launch(const synth::Sources<T>& src, Out* out, Out* out_noise,
           Out* out_voice, int batch, int n_frame, int width, void* stream) {
  const int half = width / 2;
  if (src.n_v + src.n_x > kMaxSlots || batch > 65535 || width % 2 != 0
      || half < 1 || half > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || n_frame == 0) return 0;
  constexpr int kRows = tile_rows<kEpi>();
  const long long stage =
      synth::stage_bytes((long long)kRows * width * sizeof(T));
  const long long smem = ring<T>() * stage;
  const long long out_tile =
      16 + (long long)kRows * (kEpi == kMag ? half : width) * sizeof(Out);
  if (out_tile > smem || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = synth_kernel<T, Out, kScaled, kEpi>;
  static long long opted[synth::kMaxDevices] = {};
  const int err = synth::allow_smem(kernel, smem, opted);
  if (err != 0) return err;
  const dim3 grid((n_frame + kRows - 1) / kRows, batch);
  const int threads = (half + 31) / 32 * 32;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      src, out, out_noise, out_voice, n_frame, width,
      static_cast<int>(stage));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() (0
// on success). The caller allocates the outputs: `out` [batch, n_frame,
// width / 2] for synth_mag_*, [batch, n_frame, width] for synth_flat_*;
// synth_se_* write `out` (the full mix), `out_noise` and `out_voice`, each
// [batch, n_frame, width]. Banks are contiguous [items, rows, width] of the
// entry point's element type, each starting 16-byte aligned (rows need not
// be); slot tables are contiguous int32 / float32 [batch, n_v] and [batch,
// n_x]; the noise pointers may be null when n_x == 0. `bgscale` is [batch]
// float32 for int8 banks and must be null for the other two.
#define SYNTH_SOURCES(T)                                                      \
  const T *bg, const int *bidx, const int *boff, long long bg_stride,         \
      const T *vbank, const int *vidx, const int *vshift, const float *vw,    \
      const int *vlen, int n_v, int v_rows, long long v_stride,               \
      const T *nbank, const int *nidx, const int *nshift, const float *nw,    \
      const int *nlen, int n_x, int n_rows, long long n_stride,               \
      const float *bgscale
#define SYNTH_UNPAREN(...) __VA_ARGS__
#define SYNTH_LAUNCH(T, OUT, SCALED, EPI, OUTS)                               \
  if ((bgscale != nullptr) != SCALED) {                                       \
    return static_cast<int>(cudaErrorInvalidValue);                           \
  }                                                                           \
  const synth::Sources<T> src{bg, bidx, boff, bg_stride, vbank, vidx,        \
                              vshift, vw, vlen, n_v, v_rows, v_stride,        \
                              nbank, nidx, nshift, nw, nlen, n_x, n_rows,     \
                              n_stride, bgscale};                             \
  return launch<T, OUT, SCALED, EPI>(src, SYNTH_UNPAREN OUTS, batch,        \
                                     n_frame, width, stream);
#define SYNTH_ENTRY(NAME, T, OUT, SCALED, EPI)                                \
  extern "C" int NAME(SYNTH_SOURCES(T), OUT* out, int batch, int n_frame,    \
                      int width, void* stream) {                              \
    SYNTH_LAUNCH(T, OUT, SCALED, EPI, (out, nullptr, nullptr))                \
  }
#define SE_ENTRY(NAME, T, OUT, SCALED)                                        \
  extern "C" int NAME(SYNTH_SOURCES(T), OUT* out, OUT* out_noise,            \
                      OUT* out_voice, int batch, int n_frame, int width,      \
                      void* stream) {                                         \
    SYNTH_LAUNCH(T, OUT, SCALED, kTriple, (out, out_noise, out_voice))        \
  }

SYNTH_ENTRY(synth_mag_f32, float, float, false, kMag)
SYNTH_ENTRY(synth_mag_bf16, __nv_bfloat16, __nv_bfloat16, false, kMag)
SYNTH_ENTRY(synth_mag_int8, int8_t, __nv_bfloat16, true, kMag)
SYNTH_ENTRY(synth_flat_f32, float, float, false, kFlat)
SYNTH_ENTRY(synth_flat_bf16, __nv_bfloat16, __nv_bfloat16, false, kFlat)
SYNTH_ENTRY(synth_flat_int8, int8_t, __nv_bfloat16, true, kFlat)
SE_ENTRY(synth_se_f32, float, float, false)
SE_ENTRY(synth_se_bf16, __nv_bfloat16, __nv_bfloat16, false)
SE_ENTRY(synth_se_int8, int8_t, __nv_bfloat16, true)
