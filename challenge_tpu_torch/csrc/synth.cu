// Mixture synthesis with the magnitude computed in the kernel, float32 banks.
//
// Replaces challenge_tpu/ops/pallas_synth.py::_kernel in its magnitude mode
// (synthesize_windows(..., magnitude=True) with float32 banks), the one TPU
// kernel on the training path.
//
// What it computes, per sample b and window row t in [0, n_frame):
//   acc  = bg[bidx[b], boff[b] + t, :]                      (flat row, F cols)
//   for each voice slot k, then each noise slot k, in slot order, w != 0:
//     j = t - shift[b, k];  if 0 <= j < len[b, k]:  acc += w[b, k] * clip[j, :]
//   out[b, t, m] = sqrt(acc[m]^2 + acc[F/2 + m]^2)          m in [0, F/2)
// The flat layout is channel-major (column c*f + freq), so the real planes
// are the first half of the columns and the imaginary planes the second.
// Clip rows that land outside [0, n_frame) are dropped.
//
// Exactness: the sum is an ordered float32 sum. Each step is a rounded
// multiply then a rounded add (__fmul_rn / __fadd_rn, which nvcc never
// contracts into an FMA), in the same order as the JAX kernel and as the
// plain PyTorch version in ops/synth.py, so the three agree bit for bit.
// sqrtf is the IEEE square root (no --use_fast_math).
//
// Bound: bytes. Per call it must read each sample's background window
// (n_frame x F floats), the rows of each active clip that land in the
// window and the slot tables, and write the magnitude (n_frame x F/2
// floats), each once; chip_smoke.py's synth_work counts them from the
// draws. On the main path's draws (B=12, n_frame=512, F=4*257, 7 voice and
// 2 noise slots) that is 51.7 MB a call, a bound of 15.4 us at 3.35 TB/s.
// The arithmetic (2 flops per element per clip, 4 and a root per
// magnitude) is far below the card's float32 rate.
//
// Design. One block per (row tile of kRows window rows, sample). Thread 0
// reads the sample's slot table (indices, shifts, lengths, weights) and
// keeps, in order, the active slots whose rows reach the tile; there is no
// scalar prefetch. Each thread owns magnitude columns m (stride kThreads),
// so neighbouring threads load neighbouring addresses of every bank row.
// The complex window lives only in registers, as it lived only in VMEM on
// the TPU: it never goes to device memory. No atomics, no shared
// accumulator; the order of the sum is fixed. Clip rows are read from
// device memory once per tile that needs them; staging them in shared
// memory (cp.async / TMA) is left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;        // window rows per block
constexpr int kMaxSlots = 32;   // voice + noise slots per sample

__global__ void __launch_bounds__(kThreads) synth_mag_f32_kernel(
    const float* __restrict__ bg, const int* __restrict__ bidx,
    const int* __restrict__ boff, long long bg_stride,
    const float* __restrict__ vbank, const int* __restrict__ vidx,
    const int* __restrict__ vshift, const float* __restrict__ vw,
    const int* __restrict__ vlen, int n_v, int v_rows, long long v_stride,
    const float* __restrict__ nbank, const int* __restrict__ nidx,
    const int* __restrict__ nshift, const float* __restrict__ nw,
    const int* __restrict__ nlen, int n_x, int n_rows, long long n_stride,
    float* __restrict__ out, int n_frame, int width) {
  __shared__ const float* s_clip[kMaxSlots];
  __shared__ int s_shift[kMaxSlots];
  __shared__ int s_len[kMaxSlots];
  __shared__ float s_w[kMaxSlots];
  __shared__ int s_n;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRows;
  const int t1 = min(t0 + kRows, n_frame);
  const int half = width / 2;

  if (threadIdx.x == 0) {
    int n = 0;
    for (int k = 0; k < n_v + n_x; ++k) {
      const bool voice = k < n_v;
      const int i = voice ? b * n_v + k : b * n_x + (k - n_v);
      const float w = voice ? vw[i] : nw[i];
      if (w == 0.0f) continue;                          // inactive slot
      const int shift = voice ? vshift[i] : nshift[i];
      const int len = min(voice ? vlen[i] : nlen[i], voice ? v_rows : n_rows);
      if (shift + len <= t0 || shift >= t1) continue;   // misses this tile
      const long long item = voice ? vidx[i] : nidx[i];
      s_clip[n] = voice ? vbank + item * v_stride : nbank + item * n_stride;
      s_shift[n] = shift;
      s_len[n] = len;
      s_w[n] = w;
      ++n;
    }
    s_n = n;
  }
  __syncthreads();

  const int n_slots = s_n;
  const float* win = bg + (long long)bidx[b] * bg_stride
                        + (long long)boff[b] * width;
  float* o = out + (long long)b * n_frame * half;
  for (int m = threadIdx.x; m < half; m += kThreads) {
    for (int t = t0; t < t1; ++t) {
      float re = win[(long long)t * width + m];
      float im = win[(long long)t * width + half + m];
      for (int k = 0; k < n_slots; ++k) {
        const int j = t - s_shift[k];
        if (j >= 0 && j < s_len[k]) {
          const float* row = s_clip[k] + (long long)j * width;
          re = __fadd_rn(re, __fmul_rn(s_w[k], row[m]));
          im = __fadd_rn(im, __fmul_rn(s_w[k], row[half + m]));
        }
      }
      o[(long long)t * half + m] =
          sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates `out` [batch, n_frame, width / 2]. Banks are contiguous
// [items, rows, width] float32; slot tables are contiguous int32 / float32
// [batch, n_v] and [batch, n_x]; the noise pointers may be null when
// n_x == 0.
extern "C" int synth_mag_f32(
    const float* bg, const int* bidx, const int* boff, long long bg_stride,
    const float* vbank, const int* vidx, const int* vshift, const float* vw,
    const int* vlen, int n_v, int v_rows, long long v_stride,
    const float* nbank, const int* nidx, const int* nshift, const float* nw,
    const int* nlen, int n_x, int n_rows, long long n_stride,
    float* out, int batch, int n_frame, int width, void* stream) {
  if (n_v + n_x > kMaxSlots || batch > 65535 || width % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || n_frame == 0) return 0;
  const dim3 grid((n_frame + kRows - 1) / kRows, batch);
  synth_mag_f32_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      bg, bidx, boff, bg_stride, vbank, vidx, vshift, vw, vlen, n_v, v_rows,
      v_stride, nbank, nidx, nshift, nw, nlen, n_x, n_rows, n_stride, out,
      n_frame, width);
  return static_cast<int>(cudaGetLastError());
}
