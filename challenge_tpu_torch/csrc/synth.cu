// Mixture synthesis for float32, bfloat16 and int8 banks, with the
// magnitude computed in the kernel or the raw complex window written out.
//
// Replaces challenge_tpu/ops/pallas_synth.py::_kernel, the one TPU kernel,
// in three of its modes: the magnitude epilogue
// (synthesize_windows(..., magnitude=True)) with float32 banks (mode B1,
// synth_mag_f32) and with bfloat16 or int8 banks (mode B3, synth_mag_bf16
// and synth_mag_int8), and the flat-complex output (mode B2, the default
// epilogue, pallas_synth.py:279-281: synth_flat_f32, synth_flat_bf16 and
// synth_flat_int8), which the se v9 targets call three times a batch. The
// fourth mode, the fused mel epilogue (B4), is synth_mel.cu; the slot table
// and the ordered sum below are shared with it (synth_common.cuh).
//
// What it computes, per sample b and window row t in [0, n_frame):
//   acc  = float(bg[bidx[b], boff[b] + t, :])               (flat row, F cols)
//          (int8 banks: acc = float(q_bg) * bgscale[b])
//   for each voice slot k, then each noise slot k, in slot order, w != 0:
//     j = t - shift[b, k];  if 0 <= j < len[b, k]:  acc += w[b, k] * float(clip[j, :])
//   magnitude: out[b, t, m] = sqrt(acc[m]^2 + acc[F/2 + m]^2)   m in [0, F/2)
//   raw:       out[b, t, c] = acc[c]                             c in [0, F)
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
// Kernel and plain version agree bit for bit.
//
// Bound: bytes. Per call it must read each sample's background window
// (n_frame x F elements of the bank type), the rows of each active clip
// that land in the window and the slot tables, and write the output
// (n_frame x F/2 elements of the output type for the magnitude, n_frame x
// F for the raw window), each once; chip_smoke.py's synth_work counts them
// from the draws. On the main path's draws (B=12, n_frame=512, F=4*257, 7
// voice and 2 noise slots) the magnitude is about 51.7 MB a call for
// float32 banks, 26 MB for bfloat16 and 16 MB for int8, bounds of about
// 15.4, 7.7 and 4.8 us at 3.35 TB/s; the raw window writes twice the
// output bytes. The arithmetic (2 flops per element per clip, 4 and a root
// per magnitude) is far below the card's float32 rate.
//
// Design. One block per (row tile of kRows window rows, sample). Thread 0
// reads the sample's slot table (indices, shifts, lengths, weights) and
// keeps, in order, the active slots whose rows reach the tile; there is no
// scalar prefetch. Each thread owns the column pair (m, F/2 + m) (stride
// kThreads), so neighbouring threads load neighbouring addresses of every
// bank row, and both epilogues read the pair from the thread's registers.
// The complex window lives only in registers, as it lived only in VMEM on
// the TPU; the magnitude epilogue never writes it to device memory. No
// atomics, no shared accumulator; the order of the sum is fixed. The
// epilogue and the background scale are template flags, not runtime
// branches: a runtime flag gave the float32 magnitude instance a stack
// frame and cost it time (PERF.md). Clip rows are read from device memory
// once per tile that needs them; staging them in shared memory (cp.async /
// TMA) is left for later work. With 1- and 2-byte bank elements one
// element per thread per load is a 32- or 64-byte warp transaction, far
// from what the memory system needs to reach its rate, and the time is set
// by the chain of dependent row loads, not by the bytes: on an H100 the
// bf16 and int8 kernels take about as long as the f32 one, about 5 and 8
// times their bounds against 3 (PERF.md). Wider loads are later work.

#include "synth_common.cuh"

namespace {

using synth::kMaxSlots;
using synth::kRows;

constexpr int kThreads = 256;

template <typename T, typename Out, bool kScaled, bool kMag>
__global__ void __launch_bounds__(kThreads) synth_kernel(
    const synth::Sources<T> src, Out* __restrict__ out, int n_frame,
    int width) {
  __shared__ synth::Slots<T> s;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRows;
  const int t1 = min(t0 + kRows, n_frame);
  const int half = width / 2;
  if (threadIdx.x == 0) synth::gather_slots(src, b, t0, t1, s);
  __syncthreads();

  const T* win = src.bg + (long long)src.bidx[b] * src.bg_stride
                        + (long long)src.boff[b] * width;
  const float bgscale = kScaled ? src.bgscale[b] : 1.0f;
  Out* o = out + (long long)b * n_frame * (kMag ? half : width);
  for (int m = threadIdx.x; m < half; m += kThreads) {
    for (int t = t0; t < t1; ++t) {
      float re, im;
      synth::ordered_pair<T, kScaled>(s, win, bgscale, t, m, half, width,
                                      re, im);
      if (kMag) {
        synth::store(o + (long long)t * half + m, synth::magnitude(re, im));
      } else {
        synth::store(o + (long long)t * width + m, re);
        synth::store(o + (long long)t * width + half + m, im);
      }
    }
  }
}

template <typename T, typename Out, bool kScaled, bool kMag>
int launch(const synth::Sources<T>& src, Out* out, int batch, int n_frame,
           int width, void* stream) {
  if (src.n_v + src.n_x > kMaxSlots || batch > 65535 || width % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || n_frame == 0) return 0;
  const dim3 grid((n_frame + kRows - 1) / kRows, batch);
  synth_kernel<T, Out, kScaled, kMag><<<grid, kThreads, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
      src, out, n_frame, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() (0
// on success). The caller allocates `out`: [batch, n_frame, width / 2] for
// synth_mag_*, [batch, n_frame, width] for synth_flat_*. Banks
// are contiguous [items, rows, width] of the entry point's element type;
// slot tables are contiguous int32 / float32 [batch, n_v] and [batch, n_x];
// the noise pointers may be null when n_x == 0. `bgscale` is [batch]
// float32 for int8 banks and must be null for the other two.
#define SYNTH_ENTRY(NAME, T, OUT, SCALED, MAG)                                \
  extern "C" int NAME(                                                        \
      const T* bg, const int* bidx, const int* boff, long long bg_stride,     \
      const T* vbank, const int* vidx, const int* vshift, const float* vw,    \
      const int* vlen, int n_v, int v_rows, long long v_stride,               \
      const T* nbank, const int* nidx, const int* nshift, const float* nw,    \
      const int* nlen, int n_x, int n_rows, long long n_stride,               \
      const float* bgscale, OUT* out, int batch, int n_frame, int width,      \
      void* stream) {                                                         \
    if ((bgscale != nullptr) != SCALED) {                                     \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    }                                                                         \
    const synth::Sources<T> src{bg, bidx, boff, bg_stride, vbank, vidx,      \
                                vshift, vw, vlen, n_v, v_rows, v_stride,      \
                                nbank, nidx, nshift, nw, nlen, n_x, n_rows,   \
                                n_stride, bgscale};                           \
    return launch<T, OUT, SCALED, MAG>(src, out, batch, n_frame, width,       \
                                       stream);                               \
  }

SYNTH_ENTRY(synth_mag_f32, float, float, false, true)
SYNTH_ENTRY(synth_mag_bf16, __nv_bfloat16, __nv_bfloat16, false, true)
SYNTH_ENTRY(synth_mag_int8, int8_t, __nv_bfloat16, true, true)
SYNTH_ENTRY(synth_flat_f32, float, float, false, false)
SYNTH_ENTRY(synth_flat_bf16, __nv_bfloat16, __nv_bfloat16, false, false)
SYNTH_ENTRY(synth_flat_int8, int8_t, __nv_bfloat16, true, false)
