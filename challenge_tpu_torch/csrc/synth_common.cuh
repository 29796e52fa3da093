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

// Slot k of one sample as lane k of a warp holds it between load_slot and
// keep_slots.
template <typename T>
struct SlotLoad {
  const T* clip;
  int shift, len;
  float w;
  bool valid;        // k < n_v + n_x
};

// Lane k of a warp: start the loads of slot k of sample b (its weight,
// shift, length and item, all in flight at once). Lengths past the bank's
// rows are clamped to them.
template <typename T>
__device__ __forceinline__ SlotLoad<T> load_slot(const Sources<T>& src,
                                                 int b) {
  const int k = threadIdx.x & 31;
  const bool voice = k < src.n_v;
  SlotLoad<T> l{nullptr, 0, 0, 0.0f, k < src.n_v + src.n_x};
  if (l.valid) {
    const int i = voice ? b * src.n_v + k : b * src.n_x + (k - src.n_v);
    l.w = voice ? src.vw[i] : src.nw[i];
    l.shift = voice ? src.vshift[i] : src.nshift[i];
    l.len = min(voice ? src.vlen[i] : src.nlen[i],
                voice ? src.v_rows : src.n_rows);
    const long long item = voice ? src.vidx[i] : src.nidx[i];
    l.clip = voice ? src.vbank + item * src.v_stride
                   : src.nbank + item * src.n_stride;
  }
  return l;
}

// The 32 lanes of one warp, each with its load_slot: the active slots
// (w != 0) whose shifted rows reach the tile [t0, t1) are kept in slot
// order, each at the count of kept slots below it (a ballot and a prefix
// count).
template <typename T>
__device__ __forceinline__ void keep_slots(const SlotLoad<T>& l,
                                           const Sources<T>& src, int t0,
                                           int t1, Slots<T>& s) {
  const int k = threadIdx.x & 31;
  const bool keep = l.valid && l.w != 0.0f && l.shift + l.len > t0
                    && l.shift < t1;
  const unsigned kept = __ballot_sync(0xffffffffu, keep);
  if (keep) {
    const int at = __popc(kept & ((1u << k) - 1u));
    s.clip[at] = l.clip;
    s.shift[at] = l.shift;
    s.len[at] = l.len;
    s.w[at] = l.w;
  }
  if (k == 0) {
    s.n = __popc(kept);
    s.nv = __popc(kept & (src.n_v >= 32 ? 0xffffffffu
                                        : (1u << src.n_v) - 1u));
  }
}

// Called by the 32 lanes of one warp: lane k reads slot k of sample b, and
// the active slots that reach the tile [t0, t1) are kept in slot order
// (load_slot, then keep_slots).
template <typename T>
__device__ __forceinline__ void gather_slots(const Sources<T>& src, int b,
                                             int t0, int t1, Slots<T>& s) {
  keep_slots(load_slot(src, b), src, t0, t1, s);
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

// ------------------------------------------ bulk copies on an mbarrier

// One thread: make the mbarrier at `bar` (shared memory) expect one
// arrival a phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(a)
               : "memory");
}

// After mbar_init, before the barrier's first use by a bulk copy.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Wait until the phase of parity `parity` of the mbarrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" :: "r"(a), "r"(parity) : "memory");
}

// The bytes that bulk_segment moves for a segment of n bytes at g: the
// 16-byte chunks of [g rounded down to 16, g + n rounded up to 16).
__device__ __forceinline__ int bulk_bytes(uintptr_t g, int n) {
  return static_cast<int>(((g + n + 15) & ~uintptr_t(15))
                          - (g & ~uintptr_t(15)));
}

// The 32 lanes of one warp: make the mbarrier `bar` expect the bytes that
// bulk_segment moves for n_seg segments of n bytes, segment q at s + q *
// stride, and arrive on it (its one arrival a phase). The copies may be
// issued by other warps, before or after.
__device__ __forceinline__ void bulk_expect(const void* s, long long stride,
                                            int n_seg, int n,
                                            uint64_t* bar) {
  const int lane = threadIdx.x & 31;
  int bytes = 0;
  for (int q = lane; q < n_seg; q += 32) {
    bytes += bulk_bytes(reinterpret_cast<uintptr_t>(s) + q * stride, n);
  }
  bytes = __reduce_add_sync(0xffffffffu, bytes);
  if (lane == 0) {
    const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
        :: "r"(b), "r"(bytes) : "memory");
  }
}

// One thread: copy the n bytes at g into `slot` (16-byte aligned, at
// least stage_bytes(n) long) with one cp.async.bulk of the 16-byte chunks
// of [g rounded down to 16, g + n rounded up to 16), completing on the
// mbarrier `bar`: element 0 lands (g & 15) bytes into the slot, as
// stage_range lays out a range. The caller makes sure that the rounded
// range stays inside the allocation (no allocation ends within 15 bytes
// after g + n).
__device__ __forceinline__ void bulk_segment(char* slot, const void* g,
                                             int n, uint64_t* bar) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(g);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(slot))),
         "l"(a & ~uintptr_t(15)), "r"(bulk_bytes(a, n)),
         "r"(static_cast<unsigned>(__cvta_generic_to_shared(bar)))
      : "memory");
}

// Order this thread's generic-proxy accesses to shared memory before
// later bulk copies into the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// Host: let `kernel` take `smem` bytes of dynamic shared memory. Above
// 48 KB a kernel must opt in, once per device and size; `opted` is the
// caller's record of it per device, a static of the launching template
// instance, so that each kernel instance keeps its own.
constexpr int kMaxDevices = 64;
template <typename Kernel>
int allow_smem(Kernel* kernel, long long smem,
               long long (&opted)[kMaxDevices]) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err != 0) return err;
  if (dev < kMaxDevices && opted[dev] >= smem) return 0;
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err == 0 && dev < kMaxDevices) opted[dev] = smem;
  return err;
}

// Host: `*blocks` = as many blocks of `threads` threads and `smem` bytes of
// dynamic shared memory as fit on the current device at once (at least
// one a SM). `grids` is the caller's record per device, as `opted` above:
// the count is worked out once per device and size, not per launch.
struct Grid {
  long long smem;
  int blocks;
};
template <typename Kernel>
int persistent_grid(Kernel* kernel, int threads, long long smem,
                    Grid (&grids)[kMaxDevices], int* blocks) {
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err != 0) return err;
  if (dev < kMaxDevices && grids[dev].blocks > 0 && grids[dev].smem == smem) {
    *blocks = grids[dev].blocks;
    return 0;
  }
  int sms = 0, fit = 0;
  err = static_cast<int>(cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, dev));
  if (err == 0) {
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, kernel, threads, static_cast<size_t>(smem)));
  }
  if (err != 0) return err;
  *blocks = sms * (fit > 0 ? fit : 1);
  if (dev < kMaxDevices) grids[dev] = Grid{smem, *blocks};
  return 0;
}

// The IEEE float32 magnitude of a pair (sqrtf without --use_fast_math).
__device__ __forceinline__ float magnitude(float re, float im) {
  return sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
}

}  // namespace synth
