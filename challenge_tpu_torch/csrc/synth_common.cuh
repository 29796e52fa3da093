// The ordered mixture sum shared by the synthesis kernels (synth.cu: the
// magnitude and flat-complex epilogues; synth_mel.cu: the fused mel
// epilogue). See synth.cu for what it computes and why it is exact.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace synth {

constexpr int kRows = 8;        // window rows per block
constexpr int kMaxSlots = 32;   // voice + noise slots per sample

__device__ __forceinline__ float upcast(float x) { return x; }
__device__ __forceinline__ float upcast(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float upcast(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// The active slots of one sample whose rows reach one row tile, in slot
// order (voices, then noises). Lives in shared memory.
template <typename T>
struct Slots {
  const T* clip[kMaxSlots];
  int shift[kMaxSlots];
  int len[kMaxSlots];
  float w[kMaxSlots];
  int n;
};

// The slot tables and banks of one call, as the entry points take them.
template <typename T>
struct Sources {
  const T* bg;
  const int* bidx;
  const int* boff;
  long long bg_stride;
  const T* vbank;
  const int* vidx;
  const int* vshift;
  const float* vw;
  const int* vlen;
  int n_v, v_rows;
  long long v_stride;
  const T* nbank;
  const int* nidx;
  const int* nshift;
  const float* nw;
  const int* nlen;
  int n_x, n_rows;
  long long n_stride;
  const float* bgscale;   // [batch], int8 banks only
};

// Thread 0 of a block: keep, in order, the active slots (w != 0) of sample
// b whose shifted rows reach the tile [t0, t1).
template <typename T>
__device__ __forceinline__ void gather_slots(const Sources<T>& src, int b,
                                             int t0, int t1, Slots<T>& s) {
  int n = 0;
  for (int k = 0; k < src.n_v + src.n_x; ++k) {
    const bool voice = k < src.n_v;
    const int i = voice ? b * src.n_v + k : b * src.n_x + (k - src.n_v);
    const float w = voice ? src.vw[i] : src.nw[i];
    if (w == 0.0f) continue;                          // inactive slot
    const int shift = voice ? src.vshift[i] : src.nshift[i];
    const int len = min(voice ? src.vlen[i] : src.nlen[i],
                        voice ? src.v_rows : src.n_rows);
    if (shift + len <= t0 || shift >= t1) continue;   // misses this tile
    const long long item = voice ? src.vidx[i] : src.nidx[i];
    s.clip[n] = voice ? src.vbank + item * src.v_stride
                      : src.nbank + item * src.n_stride;
    s.shift[n] = shift;
    s.len[n] = len;
    s.w[n] = w;
    ++n;
  }
  s.n = n;
}

// The ordered float32 sum of window row t at the column pair (m, half + m):
// the background element (times the int8 background scale), then each slot
// whose row covers t, in order, every multiply and add rounded once.
template <typename T, bool kScaled>
__device__ __forceinline__ void ordered_pair(const Slots<T>& s, const T* win,
                                             float bgscale, int t, int m,
                                             int half, int width, float& re,
                                             float& im) {
  // banks are read-only for the whole call: __ldg keeps the loads on the
  // read-only path that __restrict__ parameters gave them
  re = upcast(__ldg(win + (long long)t * width + m));
  im = upcast(__ldg(win + (long long)t * width + half + m));
  if (kScaled) {                                    // int8 banks
    re = __fmul_rn(re, bgscale);
    im = __fmul_rn(im, bgscale);
  }
  const int n = s.n;
  for (int k = 0; k < n; ++k) {
    const int j = t - s.shift[k];
    if (j >= 0 && j < s.len[k]) {
      const T* row = s.clip[k] + (long long)j * width;
      re = __fadd_rn(re, __fmul_rn(s.w[k], upcast(__ldg(row + m))));
      im = __fadd_rn(im, __fmul_rn(s.w[k], upcast(__ldg(row + half + m))));
    }
  }
}

// The IEEE float32 magnitude of a pair (sqrtf without --use_fast_math).
__device__ __forceinline__ float magnitude(float re, float im) {
  return sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
}

}  // namespace synth
