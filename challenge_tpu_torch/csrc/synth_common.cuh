// What the synthesis kernels share (synth.cu: the magnitude, flat-complex
// and se-triple epilogues; synth_mel.cu: the fused mel epilogue): the
// element conversions, the slot table of one row tile, read by one warp,
// and the 16-byte staged copies between device and shared memory. See
// synth.cu for what the kernels compute and why they are exact.
//
// Alignment rule. The banks have no pad between rows (data/specset.py), so
// a row of F elements starts 16-byte aligned only for float32 banks with F
// a multiple of 4: at F = 1028 a bfloat16 row starts 8 bytes off every
// other 16-byte boundary and an int8 row at any multiple of 4 bytes. A run
// of whole rows is one contiguous byte range all the same. stage_range
// copies such a range [s, e) into shared memory as the 16-byte chunks of
// [s rounded down to 16, e), each at its own offset from the stage's start,
// so that global byte g lands at stage + (g - (s & ~15)): element 0 of the
// range sits (s & 15) bytes in, and every element keeps its alignment mod
// 16. The chunk that holds e copies only the bytes before e (cp.async's
// src-size; the rest of the chunk is zero-filled), so no copy reads past
// the range, and the rounded-down start never reads before a bank whose
// base is 16-byte aligned, which the wrappers check (ops/synth.py).
// store_range is the mirror image for the outputs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace synth {

constexpr int kMaxSlots = 32;   // voice + noise slots per sample: one warp

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
// order (voices, then noises): `nv` of the `n` are voices. Lives in shared
// memory.
template <typename T>
struct Slots {
  const T* clip[kMaxSlots];
  int shift[kMaxSlots];
  int len[kMaxSlots];
  float w[kMaxSlots];
  int n, nv;
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

// Called by the 32 lanes of one warp: lane k reads slot k of sample b (its
// weight, shift, length and item, all four loads in flight at once), and
// the active slots (w != 0) whose shifted rows reach the tile [t0, t1) are
// kept in slot order, each at the count of kept slots below it (a ballot
// and a prefix count). Lengths past the bank's rows are clamped to them.
template <typename T>
__device__ __forceinline__ void gather_slots(const Sources<T>& src, int b,
                                             int t0, int t1, Slots<T>& s) {
  const int k = threadIdx.x & 31;
  const bool voice = k < src.n_v;
  bool keep = false;
  const T* clip = nullptr;
  int shift = 0, len = 0;
  float w = 0.0f;
  if (k < src.n_v + src.n_x) {
    const int i = voice ? b * src.n_v + k : b * src.n_x + (k - src.n_v);
    w = voice ? src.vw[i] : src.nw[i];
    shift = voice ? src.vshift[i] : src.nshift[i];
    len = min(voice ? src.vlen[i] : src.nlen[i],
              voice ? src.v_rows : src.n_rows);
    const long long item = voice ? src.vidx[i] : src.nidx[i];
    clip = voice ? src.vbank + item * src.v_stride
                 : src.nbank + item * src.n_stride;
    keep = w != 0.0f && shift + len > t0 && shift < t1;
  }
  const unsigned kept = __ballot_sync(0xffffffffu, keep);
  if (keep) {
    const int at = __popc(kept & ((1u << k) - 1u));
    s.clip[at] = clip;
    s.shift[at] = shift;
    s.len[at] = len;
    s.w[at] = w;
  }
  if (k == 0) {
    s.n = __popc(kept);
    s.nv = __popc(kept & (src.n_v >= 32 ? 0xffffffffu
                                        : (1u << src.n_v) - 1u));
  }
}

// ------------------------------------------------- 16-byte staged copies

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The shared-memory bytes that stage_range needs for a range of n bytes.
__host__ __device__ constexpr long long stage_bytes(long long n) {
  return (n + 15) / 16 * 16 + 16;
}

// All threads of the block: start the copy of the n bytes at s into
// `stage` (16-byte aligned) as 16-byte cp.async chunks; the caller commits
// and waits. Element 0 of the range lands (s & 15) bytes in.
__device__ __forceinline__ void stage_range(char* stage, const void* s,
                                            long long n) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(s);
  const uintptr_t a0 = lo & ~uintptr_t(15);
  const uintptr_t end = lo + n;
  const int chunks = static_cast<int>((end - a0 + 15) >> 4);
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const uintptr_t g = a0 + 16 * static_cast<uintptr_t>(c);
    cp_async16(stage + 16 * c, reinterpret_cast<const void*>(g),
               static_cast<int>(min(uintptr_t(16), end - g)));
  }
}

// All threads of the block: write the n elements staged at `staged` (laid
// out as stage_range lays out a range that starts at dst: element 0 at
// (dst & 15) bytes into the 16-byte aligned `staged`) to dst, with 16-byte
// stores wherever the destination is 16-byte aligned and element stores
// at the unaligned head and tail.
template <typename Out>
__device__ __forceinline__ void store_range(Out* dst, const char* staged,
                                            long long n) {
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t a0 = d & ~uintptr_t(15);
  const uintptr_t e = d + n * sizeof(Out);
  uintptr_t h = (d + 15) & ~uintptr_t(15), t = e & ~uintptr_t(15);
  if (h > t) h = t = e;                  // inside one 16-byte chunk
  const int n_head = static_cast<int>((h - d) / sizeof(Out));
  const int n_tail = static_cast<int>((e - t) / sizeof(Out));
  const int n_mid = static_cast<int>((t - h) >> 4);
  for (int i = threadIdx.x; i < n_head + n_tail; i += blockDim.x) {
    const uintptr_t g = i < n_head ? d + i * sizeof(Out)
                                   : t + (i - n_head) * sizeof(Out);
    *reinterpret_cast<Out*>(g) =
        *reinterpret_cast<const Out*>(staged + (g - a0));
  }
  for (int c = threadIdx.x; c < n_mid; c += blockDim.x) {
    const uintptr_t g = h + 16 * static_cast<uintptr_t>(c);
    *reinterpret_cast<int4*>(g) =
        *reinterpret_cast<const int4*>(staged + (g - a0));
  }
}

// The IEEE float32 magnitude of a pair (sqrtf without --use_fast_math).
__device__ __forceinline__ float magnitude(float re, float im) {
  return sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
}

}  // namespace synth
