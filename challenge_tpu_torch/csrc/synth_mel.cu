// Mixture synthesis with the fused mel epilogue, for float32, bfloat16 and
// int8 banks: synth_mel_f32, synth_mel_bf16 and synth_mel_int8.
//
// Replaces challenge_tpu/ops/pallas_synth.py::_kernel in its fourth mode
// (B4), synthesize_windows(..., mel=(melm, tmask, fmask)),
// pallas_synth.py:283-334, which make_feature_fn(..., fused_mel=True)
// calls once a batch. The three other modes are synth.cu.
//
// What it computes, per sample b, window row t, channel c and mel bin m,
// with acc the ordered float32 sum of synth.cu (the background window,
// then each active voice and noise clip in slot order, every multiply and
// add rounded once, int8 banks dequantized):
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
// 118 of 257 frequency rows for every mel size from 40 to 128 bins), the
// slot tables, the masks and the band, and write the mel and mm, each
// once; chip_smoke.py's mel_work counts them from the draws (and states
// the count over all columns beside it). The arithmetic, a few flops per
// clip element and about 6 per nonzero mel product, is far below the
// card's float32 rate.
//
// Design. A work item is a row tile of kRows (8) window rows of one
// sample; a block of 256 threads takes items blockIdx.x, + gridDim.x, ...
// The grid is as many blocks as fit on the card at once (3 a SM), each
// walking its items, so the band and the bin groups are set up once a
// block; the block count is worked out once per device and shared-memory
// size. Any grid size gives the same result.
//   - Warp w owns tile row w; in it, lane (c, fb) owns band rows f = fb,
//     fb + span, ... (span = 32 / chans lanes a channel, at most kCols
//     rows a lane) of channel c, and keeps their (re, im) sums in
//     registers. A clip that covers only some rows of the tile leaves the
//     other warps idle for it, with no test per row.
//   - In the flat layout a row's band is 2 x chans segments of n_f
//     elements, one per complex plane, freq elements apart, and so is a
//     run of rows. Each source of the item (the background rows of the
//     tile, then each active slot's rows that reach it, in slot order) is
//     staged segment by segment into a ring of stages (2, 4 and 7 for
//     float32, bfloat16 and int8 banks): each warp copies its row's
//     segments with one cp.async.bulk each, of the segment's 16-byte
//     chunks rounded outwards, and warp 0 arrives on the stage's mbarrier
//     with the bytes (synth_common.cuh's bulk_expect and bulk_segment).
//     Segment starts fall on every residue mod 16 that the element size
//     allows, and an int8 row stride of 1028 bytes rules out a TMA map, so
//     element 0 of a segment lands at its residue and each lane adds it
//     once a segment. Only the band's columns are read. The background's
//     copies start before the slot table is kept, the next sources' are in
//     flight while one is added, and a stage is refilled once every
//     thread has added what it held.
//   - One warp keeps the sample's slot table (synth_common.cuh, shared
//     with synth.cu); the item's masks and the band go to shared memory
//     with their loads started before the window's.
//   - The masked magnitudes go over the ring's first bytes, a [kRows,
//     chans x n_f] tile (the complex window and the magnitude never reach
//     device memory). The mel bins are split into bin groups of about
//     equal nonzero entries; thread (group, 4 consecutive outputs (t, c))
//     sums each bin of its group over the bin's nonzero band rows in
//     increasing f, four independent sums, applies the time mask, stores
//     the four with one 16-byte store (element stores where the run is
//     not 16-byte aligned) and keeps a running min and max.
//   - min and max of values >= 0 do not depend on order, so mm is exact
//     whatever order the items run in: a small kernel launched first on
//     the same stream sets mm to (+inf, 0), and each item folds its min
//     and max in by one atomicMin and one atomicMax on the float bits as
//     unsigned ints. One launch a call (per-sample arrival records, the
//     last item of a sample writing mm) measured no faster than the two
//     (PERF.md §6), so the two stay.
// Bank type and int8 background scale are template parameters, as in
// synth.cu. The TPU kernel's software pipeline, 128-lane mm row and
// block-diagonal mel matrix are layout devices of Mosaic and are not
// carried over.
//
// What bounds it on an H100 (PERF.md §6): not the bytes. Every block of
// a launch starts at once, so the copies of the first items arrive
// together and take the card's memory rate for the first few
// microseconds; each item is then a chain of round trips (indices and
// slot table, background, clips) and short, dependent shared-memory
// phases (adds, magnitude, mel) of a few microseconds, and the 768 items
// of the main path run in two such waves. Measured on an NVIDIA H100
// 80GB HBM3 at a 700 W power limit, on the main path's draws
// (scripts/mel_ab.py): 0.0227, 0.0220 and 0.0225 ms for float32, bfloat16
// and int8 banks, against bounds of 0.0065, 0.0039 and 0.0025 ms, and
// 0.0273, 0.0323 and 0.0262 ms for the first port, which read every
// element straight from device memory. 16-row tiles, deeper rings, one
// block an item, one launch a call and register caps of 64 to 128 were
// each no better or spilled (PERF.md §6).

#include "synth_common.cuh"

namespace {

using synth::kMaxSlots;

constexpr int kRows = 8;                // window rows per work item
constexpr int kThreads = 256;           // a warp a tile row
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;           // 80 registers: no spill anywhere
constexpr int kRowsPerWarp = kRows / kWarps;   // tile rows a warp owns
constexpr int kCols = 8;                // band rows a lane, per row
static_assert(kRows % kWarps == 0, "a warp owns whole tile rows");
constexpr long long kMaxSmem = 232448;  // a block's opt-in maximum

// Ring stages by bank element size: 15.9, 8.2 and 4.6 KB a stage at 8
// rows and n_f = 118.
template <typename T>
__host__ __device__ constexpr int ring() {
  return sizeof(T) == 4 ? 2 : sizeof(T) == 2 ? 4 : 7;
}

// The nonzero band of the mel matrix [freq, n_mels], per mel bin (CSR).
struct Band {
  const int* off;     // [n_mels + 1]: bin m's entries are off[m] .. off[m+1]
  const int* row;     // [nnz] frequency rows, ascending within a bin
  const float* w;     // [nnz] weights
  int nnz, n_mels;
  int f_lo, n_f;      // the synthesized columns: rows f_lo .. f_lo + n_f - 1
  int freq;           // frequency rows per channel plane
};

__global__ void mm_init(unsigned int* mm, int batch) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < batch) {
    mm[2 * i] = 0x7f800000u;          // +inf: the min of nothing
    mm[2 * i + 1] = 0u;               // +0: the max of nothing >= 0
  }
}

template <typename T, bool kScaled>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
synth_mel_kernel(
    const synth::Sources<T> src, const Band band,
    const float* __restrict__ tmask, const float* __restrict__ fmask,
    float* __restrict__ mel, float* __restrict__ mm, int batch,
    int n_frame, int width, int chans, int seg_slot, int stage) {
  constexpr int kStages = ring<T>();
  constexpr int kE = sizeof(T);
  extern __shared__ __align__(16) char smem[];
  __shared__ synth::Slots<T> s;
  __shared__ float s_lo[kWarps], s_hi[kWarps], s_scale;
  __shared__ uint64_t s_full[kStages];    // a stage's copies have landed
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_f = band.n_f;
  const int n_cols = chans * n_f;
  const int n_seg = 2 * chans;                 // band segments per row
  const int seg_stride = band.freq * kE;       // bytes between segments
  const int n_tiles = (n_frame + kRows - 1) / kRows;
  const int n_work = n_tiles * batch;
  const int n_out = kRows * chans;             // a bin's outputs per tile
  const int groups = kThreads / (n_out / 4);   // bin groups of the mel
  // the mel's runs are 16-byte aligned wherever a run of the first tile is
  const bool vec = (reinterpret_cast<uintptr_t>(mel) & 15) == 0
                   && (n_frame * chans) % 4 == 0;
  // the ring, whose first bytes take the masked magnitudes [kRows, n_cols]
  // once the item's sources are added; then the band's (row - f_lo,
  // weight) pairs, the item's column mask, its time mask per output, the
  // band's offsets and the first bin of each bin group
  float* s_mag = reinterpret_cast<float*>(smem);
  int2* s_band = reinterpret_cast<int2*>(
      smem + max(kStages * stage, kRows * n_cols * 4));
  float* s_keep = reinterpret_cast<float*>(s_band + band.nnz);
  float* s_tm = s_keep + n_cols;
  int* s_off = reinterpret_cast<int*>(s_tm + n_out);
  int* s_grp = s_off + band.n_mels + 1;

  // this lane's band columns: channel c, rows f = fb + span * k
  const int span = 32 / chans;                 // lanes a channel
  const int c = lane / span;
  const int fb = lane - c * span;

  // all threads: start the copies of source seq, tile rows [lo, hi)
  // staged from row lo on at `from`; warp 0 arrives on the stage's barrier
  // with the bytes, each warp copies the segments of its rows
  auto issue = [&](int seq, const T* from, int lo, int hi) {
    char* st = smem + (seq % kStages) * stage;
    uint64_t* bar = &s_full[seq % kStages];
    if (warp == 0) {
      synth::bulk_expect(from, seg_stride, (hi - lo) * n_seg, n_f * kE, bar);
    }
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp + kWarps * j;
      if (r >= lo && r < hi && lane < n_seg) {
        const int q = (r - lo) * n_seg + lane;
        synth::bulk_segment(st + q * seg_slot,
                            reinterpret_cast<const char*>(from)
                                + (long long)q * seg_stride,
                            n_f * kE, bar);
      }
    }
  };

  int w = blockIdx.x;
  if (threadIdx.x < kStages) {
    synth::mbar_init(&s_full[threadIdx.x]);
    synth::fence_mbar_init();
  }
  __syncthreads();
  int seq = 0;                      // this block's sources so far
  for (; w < n_work; w += gridDim.x) {
    const int b = w / n_tiles;
    const int t0 = (w - b * n_tiles) * kRows;
    const int nr = min(kRows, n_frame - t0);
    synth::SlotLoad<T> slot;        // warp 0: the sample's slot table
    if (warp == 0) slot = synth::load_slot(src, b);
    // the item's masks and scale, and once a block the band, go to shared
    // memory; their loads start before the window's, so that the three
    // round trips overlap
    for (int i = threadIdx.x; i < n_cols; i += kThreads) {
      const int ci = i / n_f;
      s_keep[i] = fmask[(long long)b * (width / 2) + ci * band.freq
                        + band.f_lo + (i - ci * n_f)];
    }
    if (threadIdx.x < nr * chans) s_tm[threadIdx.x] =
        tmask[(long long)b * n_frame + t0 + threadIdx.x / chans];
    if (kScaled && threadIdx.x == kThreads - 1) s_scale = src.bgscale[b];
    if (w == blockIdx.x) {
      for (int i = threadIdx.x; i < band.nnz; i += kThreads) {
        s_band[i] = make_int2(band.row[i] - band.f_lo,
                              __float_as_int(band.w[i]));
      }
      for (int i = threadIdx.x; i <= band.n_mels; i += kThreads) {
        s_off[i] = band.off[i];
      }
    }
    // the background rows at the band's first column: their copies start
    // before the slot table is kept
    const T* win = src.bg + (long long)src.bidx[b] * src.bg_stride
                          + (long long)(src.boff[b] + t0) * width
                          + band.f_lo;
    issue(seq, win, 0, nr);
    if (warp == 0) synth::keep_slots(slot, src, t0, t0 + nr, s);
    __syncthreads();
    if (w == blockIdx.x) {
      // bin group g starts at the first bin with g / groups of the band's
      // entries before it, so that the groups hold about equal entries
      for (int g = threadIdx.x; g <= groups; g += kThreads) {
        const int target = g * band.nnz / groups;
        int lo = 0, hi = band.n_mels;
        while (lo < hi) {
          const int mid = (lo + hi) / 2;
          if (s_off[mid] < target) lo = mid + 1; else hi = mid;
        }
        s_grp[g] = g == groups ? band.n_mels : lo;
      }
    }
    const int n_src = 1 + s.n;       // the background, then the slots

    // source i's tile rows [lo, hi), staged from row lo on at `from`
    auto rows = [&](int i, int& lo, int& hi) {
      if (i == 0) {
        lo = 0;
        hi = nr;
      } else {
        lo = max(s.shift[i - 1] - t0, 0);
        hi = min(s.shift[i - 1] + s.len[i - 1] - t0, nr);
      }
    };
    auto from = [&](int i, int lo) {
      return i == 0 ? win
                    : s.clip[i - 1] + (long long)(t0 + lo - s.shift[i - 1])
                                          * width + band.f_lo;
    };
    auto fetch = [&](int i) {
      if (i < n_src) {
        int lo, hi;
        rows(i, lo, hi);
        issue(seq + i, from(i, lo), lo, hi);
      }
    };
    for (int i = 1; i < kStages; ++i) fetch(i);

    float acc[kRowsPerWarp][kCols][2];
    for (int i = 0; i < n_src; ++i) {
      int lo, hi;
      rows(i, lo, hi);
      const int st = ((seq + i) % kStages) * stage;
      const int g0 = static_cast<int>(
          reinterpret_cast<uintptr_t>(from(i, lo)) & 15);
      const float wk = i == 0 ? (kScaled ? s_scale : 1.0f) : s.w[i - 1];
      bool waited = false;
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const int r = warp + kWarps * j;
        if (r < lo || r >= hi) continue;
        if (!waited) {
          synth::mbar_wait(&s_full[(seq + i) % kStages],
                           ((seq + i) / kStages) & 1);
          waited = true;
        }
        // this lane's two segments of staged row r - lo: element 0 of
        // segment q lies (g0 + q * seg_stride) & 15 bytes into its slot;
        // 32-bit offsets into shared memory
        const int q = (r - lo) * n_seg + c;
        const int re = st + q * seg_slot + ((g0 + q * seg_stride) & 15)
                       + fb * kE;
        const int qi = q + chans;
        const int im = st + qi * seg_slot + ((g0 + qi * seg_stride) & 15)
                       + fb * kE;
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          if (fb + span * k < n_f) {
            const float x = synth::upcast(
                *reinterpret_cast<const T*>(smem + re + span * k * kE));
            const float y = synth::upcast(
                *reinterpret_cast<const T*>(smem + im + span * k * kE));
            if (i == 0) {                   // the background
              acc[j][k][0] = kScaled ? __fmul_rn(x, wk) : x;
              acc[j][k][1] = kScaled ? __fmul_rn(y, wk) : y;
            } else {
              acc[j][k][0] = __fadd_rn(acc[j][k][0], __fmul_rn(wk, x));
              acc[j][k][1] = __fadd_rn(acc[j][k][1], __fmul_rn(wk, y));
            }
          }
        }
      }
      if (i + kStages < n_src) {     // the stage is needed again
        __syncthreads();             // once every thread has added i
        fetch(i + kStages);
      }
    }
    // the masked magnitudes, into the ring's first bytes once every thread
    // is past its adds and every copy has landed
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int f = fb + span * k;
        if (warp + kWarps * j < nr && f < n_f) {
          acc[j][k][0] = __fmul_rn(synth::magnitude(acc[j][k][0],
                                                    acc[j][k][1]),
                                   s_keep[c * n_f + f]);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp + kWarps * j;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int f = fb + span * k;
        if (r < nr && f < n_f) s_mag[(r * chans + c) * n_f + f] = acc[j][k][0];
      }
    }
    __syncthreads();

    // the mel: output o = (t, c) of a bin reads s_mag[o * n_f + f]; thread
    // (group g, outputs o .. o + 3) sums the bins of group g in increasing
    // f, four independent sums, and stores each bin's four with one 16-byte
    // store where the run is aligned
    float vmin = __int_as_float(0x7f800000), vmax = 0.0f;
    const int g = threadIdx.x / (n_out / 4);
    const int o = (threadIdx.x - g * (n_out / 4)) * 4;
    const int run = nr * chans;               // a bin's outputs here
    if (g < groups && o < run) {
      const float* x = s_mag + o * n_f;
      float tm[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) tm[u] = s_tm[min(o + u, run - 1)];
      float* out = mel + (((long long)b * band.n_mels) * n_frame + t0)
                             * chans + o;
      for (int m = s_grp[g]; m < s_grp[g + 1]; ++m) {
        float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int e = s_off[m]; e < s_off[m + 1]; ++e) {
          const int2 rw = s_band[e];
          const float wt = __int_as_float(rw.y);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            a[u] = __fadd_rn(a[u], __fmul_rn(x[u * n_f + rw.x], wt));
          }
        }
        float* dst = out + (long long)m * n_frame * chans;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          a[u] = __fmul_rn(a[u], tm[u]);
          if (o + u < run) {
            vmin = fminf(vmin, a[u]);
            vmax = fmaxf(vmax, a[u]);
          }
        }
        if (vec && o + 4 <= run) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(a[0], a[1], a[2], a[3]);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (o + u < run) dst[u] = a[u];
          }
        }
      }
    }
    synth::fence_proxy_async();      // s_mag's bytes take the next copies

    // the item's min and max, then into the sample's
    for (int sh = 16; sh > 0; sh /= 2) {
      vmin = fminf(vmin, __shfl_xor_sync(0xffffffffu, vmin, sh));
      vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, sh));
    }
    if (lane == 0) {
      s_lo[warp] = vmin;
      s_hi[warp] = vmax;
    }
    __syncthreads();
    // the last warp (warp 0 leads the next item's copies)
    if (threadIdx.x == kThreads - 32) {
      for (int v = 0; v < kWarps - 1; ++v) {
        vmin = fminf(vmin, s_lo[v]);
        vmax = fmaxf(vmax, s_hi[v]);
      }
      unsigned int* mm_bits = reinterpret_cast<unsigned int*>(mm) + 2 * b;
      atomicMin(mm_bits, __float_as_uint(vmin));
      atomicMax(mm_bits + 1, __float_as_uint(vmax));
    }
    seq += n_src;
  }
}

template <typename T, bool kScaled>
int launch(const synth::Sources<T>& src, const Band& band,
           const float* tmask, const float* fmask, float* mel, float* mm,
           int batch, int n_frame, int width, void* stream) {
  const int chans = band.freq > 0 ? width / (2 * band.freq) : 0;
  const long long seg_slot =
      synth::stage_bytes((long long)band.n_f * sizeof(T));
  const long long stage = (long long)kRows * 2 * chans * seg_slot;
  const long long n_out = (long long)kRows * chans;
  const long long mag = sizeof(float) * kRows * chans * band.n_f;
  const long long smem = (ring<T>() * stage > mag ? ring<T>() * stage : mag)
                         + sizeof(int2) * band.nnz
                         + sizeof(float) * chans * (band.n_f + kRows)
                         + sizeof(int) * (band.n_mels + 2
                                          + (n_out > 0 ? 4 * kThreads / n_out
                                                       : 0));
  // one warp a tile row, a lane a segment copy, kCols band rows a lane;
  // the bulk copies' rounded ends inside the plane
  if (src.n_v + src.n_x > kMaxSlots || chans < 1 || chans > 16
      || 32 % chans != 0
      || width != 2 * chans * band.freq || band.f_lo < 0 || band.n_f < 1
      || band.f_lo + band.n_f > band.freq || band.n_mels < 1
      || band.n_f > kCols * (32 / chans) || n_out > kThreads
      || (band.freq - band.f_lo - band.n_f) * (long long)sizeof(T) < 15
      || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || n_frame == 0) return 0;
  const long long n_work = (long long)(n_frame + kRows - 1) / kRows * batch;
  if (n_work > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto kernel = synth_mel_kernel<T, kScaled>;
  static long long opted[synth::kMaxDevices] = {};
  int err = synth::allow_smem(kernel, smem, opted);
  if (err != 0) return err;
  // as many blocks as fit on the card at once, worked out once per device
  // and shared-memory size (a stale count from another thread costs time,
  // never the result)
  static synth::Grid grids[synth::kMaxDevices] = {};
  int blocks = 0;
  err = synth::persistent_grid(kernel, kThreads, smem, grids, &blocks);
  if (err != 0) return err;
  mm_init<<<(batch + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      reinterpret_cast<unsigned int*>(mm), batch);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  kernel<<<static_cast<int>(blocks < n_work ? blocks : n_work), kThreads,
           smem, st>>>(
      src, band, tmask, fmask, mel, mm, batch, n_frame, width, chans,
      static_cast<int>(seg_slot), static_cast<int>(stage));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() (0
// on success). Sources as synth.cu's entry points. The band of the mel
// matrix [freq, n_mels]: `band_off` [n_mels + 1], `band_row` and `band_w`
// [nnz] (int32, int32, float32), rows ascending within each bin and inside
// [f_lo, f_lo + n_f), for chans = width / (2 x freq) a power of two up to
// 16 with n_f <= 8 x 32 / chans, and the band ending at least 15 bytes
// before each plane's end (the bulk copies' rounded ends stay inside the
// bank). `tmask` [batch, n_frame] and `fmask` [batch, width / 2] are
// float32 {0,1} masks. The caller allocates `mel` [batch, n_mels,
// n_frame, chans] and `mm` [batch, 2], float32.
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
