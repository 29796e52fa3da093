// BatchNorm with an optional swish epilogue, training and eval mode,
// forward and backward, for the EfficientNet backbone
// (challenge_tpu_torch/models/effnet.py through ops/bn_act.py).
//
// It replaces no TPU kernel: JAX leaves BatchNorm and swish to XLA, which
// fuses them. The port's plain path (models/layers.py BatchNorm, then
// F.silu) runs them as separate PyTorch ops, each reading or writing the
// whole activation: about 12 passes forward and 20 backward. Every kernel
// here is bound by device memory, so the design moves fewer bytes: 3
// passes forward (read x for the statistics, read x and write the output)
// and 5 backward (read the output gradient and x for the sums, read both
// and write the input gradient); eval mode is one read and one write.
//
// The arithmetic is the plain path's, step for step:
//   * statistics in float32: mean = sum(x) / N and mean_sq = sum(x * x) / N
//     (each x * x rounded, as the plain path's square is), the one-pass
//     biased var = max(mean_sq - mean^2, 0), mul = rsqrt(var + eps) *
//     weight; the running statistics updated in place, rm = rm * m + mean
//     * (1 - m), with that same biased var;
//   * z = ((x - mean) * mul) + bias, every step rounded on its own (the
//     __f*_rn intrinsics keep nvcc from contracting them into FMAs);
//     z rounded to the output's dtype, then swish as PyTorch's silu
//     computes it, z / (1 + expf(-z)) in float32;
//   * backward, autograd's algebra over that forward (not the textbook
//     closed form): dz from PyTorch's silu backward, s = 1 / (1 +
//     expf(-z)), dout * s * (1 + z (1 - s)) (PyTorch's build contracts the
//     inner multiply-add, as __fmaf_rn does here), rounded to the output's
//     dtype; A = sum(dz), B = sum(dz * (x - mean)), D = sum(dz * mul);
//     dbias = A, dweight = B * rsqrt(var + eps); dvar = -0.5 (B * weight)
//     rs^3 where mean_sq - mean^2 >= 0; dmean = (-D - dvar mean) - dvar
//     mean; dx = ((dz * mul + x k) + x k) + dmean / N with k = dvar / N, in
//     autograd's order of accumulation; a division by N is a product with
//     float32(1 / N), as PyTorch's CUDA division by a scalar is.
//
// The sums are PyTorch's, in PyTorch's order, so that a training
// BatchNorm is the plain path bit for bit: the plain path's mean, mean of
// squares and autograd's three sums (of dz, dz * (x - mean) and dz * mul)
// are reductions over B, H and W, and ATen's reduce kernel
// (ATen/native/cuda/Reduce.cuh) fixes their order from the tensor's shape
// and layout alone. The wrapper (ops/bn_act.py) works out the block of bw
// lanes by bh rows and the G splits as ATen's setReduceConfig does; each
// thread sums its strided share into four accumulators in turn and
// combines them in order, the block combines in halving trees, and each
// channel's G split sums are combined as ATen's last block combines them.
// The two layouts differ in what a thread sums:
//   * channels_last (layout 1; a [B*H*W, C] matrix, or the rows in the
//     gradient's own order, ops/bn_act.py): row thread y of split g sums
//     rows y + bh g + k bh G of up to 4 channels (bw 1);
//   * NCHW (layout 0; B and H*W are not coalesced): thread (x, y) of split
//     g sums elements x + bw y + bw bh g + k bw bh G of the channel's
//     B * H*W, the lanes then the rows in trees.
// Nothing uses float atomics, and the results are the same bits run to
// run. Elementwise kernels take 16-byte vectors (4 float32, 8 bfloat16
// elements) where the layout and the pointers allow, else one element a
// lane.
//
// Entry points (the wrapper, ops/bn_act.py, checks every argument; each
// returns the launch's CUDA error code, 0 on success, and takes the
// stream last): bn_stats_{f32,bf16}, bn_finalize, bn_apply_{f32,bf16},
// bn_grad_reduce_{f32,bf16}, bn_grad_finalize, bn_grad_input_{f32,bf16}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxThreads = 512;  // ATen's reduce block, at most

template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int kN = 4;
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: the plain path's cast to compute_dtype
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

template <typename T, int W>
__device__ __forceinline__ void load_w(const T* p, float (&v)[W]) {
  if constexpr (W == 1) {
    v[0] = to_f(p[0]);
  } else if constexpr (W * sizeof(T) == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = to_f(e[j]);
  } else {
    static_assert(W * sizeof(T) == 16, "an 8- or 16-byte vector");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = to_f(e[j]);
  }
}

template <typename T, int W>
__device__ __forceinline__ void store_w(T* p, const float (&v)[W]) {
  if constexpr (W == 1) {
    p[0] = from_f<T>(v[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < W; ++j) e[j] = from_f<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// z = ((x - mean) * mul) + bias, each step rounded on its own
__device__ __forceinline__ float affine(float x, float mean, float mul,
                                        float bias) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), bias);
}

// PyTorch's silu in float32
__device__ __forceinline__ float swish(float z) {
  return __fdiv_rn(z, __fadd_rn(1.0f, expf(-z)));
}

// PyTorch's silu backward in float32
__device__ __forceinline__ float swish_grad(float dout, float z) {
  const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
  return __fmul_rn(__fmul_rn(dout, s), __fmaf_rn(z, __fsub_rn(1.0f, s), 1.0f));
}

// stats: per channel (mean, mul, rs, mean_sq - mean^2), written by the
// forward finalize (eval: from the running buffers) and read by the
// training apply and the backward
struct Stats {
  float mean, mul, rs, var_raw;
};

__device__ __forceinline__ Stats load_stats(const float* stats, int c) {
  const float4 s = reinterpret_cast<const float4*>(stats)[c];
  return {s.x, s.y, s.z, s.w};
}

// what a reduce pass sums, per element (each product rounded, as the plain
// path's elementwise ops round it): x and x * x forward; dz, dz * (x -
// mean) and dz * mul backward, dz through swish's gradient where it is on
template <typename T, bool GRAD>
struct Terms {
  static constexpr int kQ = GRAD ? 3 : 2;
  float mean = 0.0f, mul = 0.0f, bias = 0.0f;
  int act = 0;

  __device__ __forceinline__ void of(float x, float d, float (&v)[kQ]) const {
    if constexpr (!GRAD) {
      v[0] = x;
      v[1] = __fmul_rn(x, x);
    } else {
      float dz = d;
      if (act) {
        const float z = round_to<T>(affine(x, mean, mul, bias));
        dz = round_to<T>(swish_grad(d, z));
      }
      v[0] = dz;
      v[1] = __fmul_rn(dz, __fsub_rn(x, mean));
      v[2] = __fmul_rn(dz, mul);
    }
  }
};

template <typename T, bool GRAD>
__device__ __forceinline__ Terms<T, GRAD> terms_of(const float* stats,
                                                   const float* bias, int c,
                                                   int act) {
  Terms<T, GRAD> t;
  if constexpr (GRAD) {
    const Stats st = load_stats(stats, c);
    t.mean = st.mean;
    t.mul = st.mul;
    t.bias = bias[c];
    t.act = act;
  }
  return t;
}

struct ReduceArgs {
  const void* x;
  const void* dout;     // backward only
  const float* stats;   // backward only
  const float* bias;    // backward only
  float* partials;      // [Q, C, S]: each sum's split partials
  int batch, channels, inner, splits, act;
  int width, rows;      // ATen's block: bw lanes (NCHW) by ry rows
};

// NCHW, in ATen's order for a reduction over B and H*W, the fastest dims
// (not coalesced, so not vectorized): thread (x, y) of split g of channel
// c sums the elements x + bw y + bw bh g + k bw bh G of the channel's
// B * H*W (b = i / HW, i % HW within the plane) into four accumulators in
// turn and combines them in order; the bw lanes combine in a halving tree,
// then the bh rows, and thread 0 writes the split's partial sums.
template <typename T, bool GRAD>
__global__ void __launch_bounds__(kMaxThreads) bn_reduce_nchw(ReduceArgs a) {
  using Tm = Terms<T, GRAD>;
  constexpr int Q = Tm::kQ;
  const int c = blockIdx.x, C = a.channels, hw = a.inner;
  const int bw = a.width, bh = a.rows, t = threadIdx.x;
  const int x = t % bw, y = t / bw;
  const int n = a.batch * hw, stride = bw * bh * a.splits;
  const Tm tm = terms_of<T, GRAD>(a.stats, a.bias, c, a.act);
  const T* xp = static_cast<const T*>(a.x);
  const T* dp = static_cast<const T*>(a.dout);
  float acc[4][Q];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[i][q] = 0.0f;
  int idx = x + bw * y + bw * bh * blockIdx.y;
  for (; idx + 3 * stride < n; idx += 4 * stride) {
    float xv[4], dv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = idx + i * stride, b = e / hw;
      const int off = (b * C + c) * hw + (e - b * hw);
      xv[i] = to_f(xp[off]);
      dv[i] = GRAD ? to_f(dp[off]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v[Q];
      tm.of(xv[i], dv[i], v);
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[i][q] = __fadd_rn(acc[i][q], v[q]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (idx >= n) break;
    const int b = idx / hw, off = (b * C + c) * hw + (idx - b * hw);
    float v[Q];
    tm.of(to_f(xp[off]), GRAD ? to_f(dp[off]) : 0.0f, v);
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[i][q] = __fadd_rn(acc[i][q], v[q]);
    idx += stride;
  }
  __shared__ float sm[3][kMaxThreads];
#pragma unroll
  for (int q = 0; q < Q; ++q)
    sm[q][t] = __fadd_rn(__fadd_rn(__fadd_rn(acc[0][q], acc[1][q]), acc[2][q]),
                         acc[3][q]);
  for (int o = bw / 2; o > 0; o >>= 1) {
    __syncthreads();
    if (x < o) {
#pragma unroll
      for (int q = 0; q < Q; ++q) sm[q][t] = __fadd_rn(sm[q][t], sm[q][t + o]);
    }
  }
  for (int o = bh / 2; o > 0; o >>= 1) {
    __syncthreads();
    if (y < o) {
#pragma unroll
      for (int q = 0; q < Q; ++q)
        sm[q][t] = __fadd_rn(sm[q][t], sm[q][t + o * bw]);
    }
  }
  if (t == 0) {
#pragma unroll
    for (int q = 0; q < Q; ++q)
      a.partials[(q * C + c) * a.splits + blockIdx.y] = sm[q][0];
  }
}

// channels_last, in ATen's order (the header): thread (y, col) of split g
// sums the rows y + ry g + k ry G of its W channels into four accumulators
// in turn (four rows loaded, then summed; the last up to three into the
// first accumulators), combines them in order, then the ry row threads of
// each column combine in a halving tree and row thread 0 writes the
// split's partial sums. blockDim.x is ry times the block's columns.
template <typename T, int W, bool GRAD>
__global__ void __launch_bounds__(kThreads) bn_reduce_nhwc(ReduceArgs a) {
  using Tm = Terms<T, GRAD>;
  constexpr int Q = Tm::kQ;
  const int C = a.channels, cols = C / W, ry = a.rows;
  const int ct = blockDim.x / ry;
  const int tcol = threadIdx.x % ct, y = threadIdx.x / ct;
  const int col = blockIdx.x * ct + tcol;
  const bool on = col < cols;
  const int M = a.batch * a.inner, stride = ry * a.splits;
  Tm tm[W];
  float acc[4][Q][W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if (on) tm[j] = terms_of<T, GRAD>(a.stats, a.bias, col * W + j, a.act);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[i][q][j] = 0.0f;
  }
  const T* x = static_cast<const T*>(a.x) + col * W;
  const T* d = GRAD ? static_cast<const T*>(a.dout) + col * W : nullptr;
  int idx = y + ry * blockIdx.y;
  if (on) {
    for (; idx + 3 * stride < M; idx += 4 * stride) {
      float xv[4][W], dv[4][W];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        load_w<T, W>(x + (idx + i * stride) * C, xv[i]);
        if constexpr (GRAD) load_w<T, W>(d + (idx + i * stride) * C, dv[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < W; ++j) {
          float v[Q];
          tm[j].of(xv[i][j], GRAD ? dv[i][j] : 0.0f, v);
#pragma unroll
          for (int q = 0; q < Q; ++q)
            acc[i][q][j] = __fadd_rn(acc[i][q][j], v[q]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (idx >= M) break;
      float xv[W], dv[W];
      load_w<T, W>(x + idx * C, xv);
      if constexpr (GRAD) load_w<T, W>(d + idx * C, dv);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        float v[Q];
        tm[j].of(xv[j], GRAD ? dv[j] : 0.0f, v);
#pragma unroll
        for (int q = 0; q < Q; ++q)
          acc[i][q][j] = __fadd_rn(acc[i][q][j], v[q]);
      }
      idx += stride;
    }
  }
  __shared__ float sm[3][kThreads * 4];
  const int slot = threadIdx.x * W;  // (y * ct + tcol) * W
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int j = 0; j < W; ++j)
      sm[q][slot + j] = __fadd_rn(
          __fadd_rn(__fadd_rn(acc[0][q][j], acc[1][q][j]), acc[2][q][j]),
          acc[3][q][j]);
  for (int off = ry / 2; off > 0; off >>= 1) {
    __syncthreads();
    if (y < off) {
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int j = 0; j < W; ++j)
          sm[q][slot + j] =
              __fadd_rn(sm[q][slot + j], sm[q][slot + off * ct * W + j]);
    }
  }
  if (y == 0 && on) {
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int j = 0; j < W; ++j)
        a.partials[(q * C + col * W + j) * a.splits + blockIdx.y] =
            sm[q][slot + j];
  }
}

// the Q sums of the channel of this thread's group (bw * bh threads a
// channel, kMaxThreads / (bw * bh) channels a block) over the S splits,
// as ATen's last block of a global reduce combines them: thread t = x + bw
// y sums splits t, t + bw bh, ... in order, then the bh rows combine in a
// halving tree, then the bw lanes. Every thread of the block calls it;
// thread 0 of a group gets the sums.
template <int Q>
__device__ __forceinline__ void combine_splits(const float* partials, int C,
                                               int S, int bw, int bh, int c,
                                               bool on, float (&out)[Q]) {
  __shared__ float sm[Q][kMaxThreads];
  const int t = threadIdx.x, g0 = t % (bw * bh);
  const int x = g0 % bw, y = g0 / bw;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    float w = 0.0f;
    if (on)
      for (int g = g0; g < S; g += bw * bh)
        w = __fadd_rn(w, partials[(q * C + c) * S + g]);
    sm[q][t] = w;
  }
  for (int o = bh / 2; o > 0; o >>= 1) {
    __syncthreads();
    if (y < o) {
#pragma unroll
      for (int q = 0; q < Q; ++q)
        sm[q][t] = __fadd_rn(sm[q][t], sm[q][t + o * bw]);
    }
  }
  for (int o = bw / 2; o > 0; o >>= 1) {
    __syncthreads();
    if (x < o) {
#pragma unroll
      for (int q = 0; q < Q; ++q) sm[q][t] = __fadd_rn(sm[q][t], sm[q][t + o]);
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) out[q] = sm[q][t];
}

struct FinalizeArgs {
  const float* partials;  // [2, C, S] sums of x and x * x
  const float* means_in;  // [2, C] (mean, mean_sq) over the ranks, or null
  float* means_out;       // [2, C]: write (mean, mean_sq) and stop, or null
  const float* weight;
  float* running_mean;
  float* running_var;
  float* stats;           // [C, 4]
  int channels, splits, width, rows, update, eval;
  float inv_n, eps, momentum, one_minus;
};

__global__ void __launch_bounds__(kMaxThreads)
    bn_finalize_kernel(FinalizeArgs a) {
  const int C = a.channels, group = a.width * a.rows;
  const int c = blockIdx.x * (kMaxThreads / group) + threadIdx.x / group;
  const bool on = c < C;
  float sums[2] = {0.0f, 0.0f};
  if (!a.eval && a.means_in == nullptr)
    combine_splits<2>(a.partials, C, a.splits, a.width, a.rows, c, on, sums);
  if (!on || threadIdx.x % group != 0) return;
  float mean, var_raw, var;
  if (a.eval) {
    mean = a.running_mean[c];
    var_raw = var = a.running_var[c];
  } else {
    float mean_sq;
    if (a.means_in != nullptr) {
      mean = a.means_in[c];
      mean_sq = a.means_in[C + c];
    } else {
      mean = __fmul_rn(sums[0], a.inv_n);
      mean_sq = __fmul_rn(sums[1], a.inv_n);
    }
    if (a.means_out != nullptr) {
      a.means_out[c] = mean;
      a.means_out[C + c] = mean_sq;
      return;
    }
    var_raw = __fsub_rn(mean_sq, __fmul_rn(mean, mean));
    var = var_raw < 0.0f ? 0.0f : var_raw;  // a NaN stays NaN
    if (a.update) {
      a.running_mean[c] = __fadd_rn(__fmul_rn(a.running_mean[c], a.momentum),
                                    __fmul_rn(mean, a.one_minus));
      a.running_var[c] = __fadd_rn(__fmul_rn(a.running_var[c], a.momentum),
                                   __fmul_rn(var, a.one_minus));
    }
  }
  const float rs = rsqrtf(__fadd_rn(var, a.eps));
  reinterpret_cast<float4*>(a.stats)[c] =
      make_float4(mean, __fmul_rn(rs, a.weight[c]), rs, var_raw);
}

struct ApplyArgs {
  const void* x;
  void* out;
  const float* stats;         // training
  const float* running_mean;  // eval
  const float* running_var;   // eval
  const float* weight;        // eval
  const float* bias;
  long long vectors;
  int channels, inner, act, eval;
  float eps;
};

template <typename T>
__device__ __forceinline__ float apply_one(float x, const ApplyArgs& a,
                                           int c) {
  float mean, mul;
  if (a.eval) {
    mean = a.running_mean[c];
    mul = __fmul_rn(rsqrtf(__fadd_rn(a.running_var[c], a.eps)), a.weight[c]);
  } else {
    const float2 s = reinterpret_cast<const float2*>(a.stats)[2 * c];
    mean = s.x;
    mul = s.y;
  }
  const float z = round_to<T>(affine(x, mean, mul, a.bias[c]));
  return a.act ? swish(z) : z;
}

template <typename T, int W, int LAYOUT>
__global__ void __launch_bounds__(kThreads) bn_apply_kernel(ApplyArgs a) {
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  for (long long u = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
       u < a.vectors; u += static_cast<long long>(gridDim.x) * kThreads) {
    const int e = static_cast<int>(u) * W;
    float v[W];
    load_w<T, W>(x + e, v);
    if constexpr (LAYOUT == 0) {
      const int c = (e / a.inner) % a.channels;
#pragma unroll
      for (int j = 0; j < W; ++j) v[j] = apply_one<T>(v[j], a, c);
    } else {
      const int c0 = e % a.channels;
#pragma unroll
      for (int j = 0; j < W; ++j) v[j] = apply_one<T>(v[j], a, c0 + j);
    }
    store_w<T, W>(out + e, v);
  }
}

struct GradFinalizeArgs {
  // [3, C, S] sums of dz, dz * (x - mean) and dz * mul
  const float* partials;
  const float* local_in;   // [3, C] this rank's sums, or null: the partials
  const float* global_in;  // [3, C] the sums over the ranks, or null: local
  float* sums_out;         // [3, C]: write this rank's sums and stop, or null
  const float* stats;
  const float* weight;
  float* dweight;
  float* dbias;
  float* coef;             // [C, 2]: (dvar / N, dmean / N)
  int channels, splits, width, rows, eval;
  float inv_n;
};

__global__ void __launch_bounds__(kMaxThreads)
    bn_grad_finalize_kernel(GradFinalizeArgs a) {
  const int C = a.channels, group = a.width * a.rows;
  const int c = blockIdx.x * (kMaxThreads / group) + threadIdx.x / group;
  const bool on = c < C;
  float sums[3] = {0.0f, 0.0f, 0.0f};
  if (a.local_in == nullptr)
    combine_splits<3>(a.partials, C, a.splits, a.width, a.rows, c, on, sums);
  if (!on || threadIdx.x % group != 0) return;
  if (a.local_in != nullptr) {
#pragma unroll
    for (int q = 0; q < 3; ++q) sums[q] = a.local_in[q * C + c];
  }
  if (a.sums_out != nullptr) {
#pragma unroll
    for (int q = 0; q < 3; ++q) a.sums_out[q * C + c] = sums[q];
    return;
  }
  const Stats st = load_stats(a.stats, c);
  a.dbias[c] = sums[0];
  a.dweight[c] = __fmul_rn(sums[1], st.rs);
  float k = 0.0f, dmean_n = 0.0f;
  if (!a.eval) {
    if (a.global_in != nullptr) {
#pragma unroll
      for (int q = 0; q < 3; ++q) sums[q] = a.global_in[q * C + c];
    }
    const float drs = __fmul_rn(sums[1], a.weight[c]);
    const float rs3 = __fmul_rn(__fmul_rn(st.rs, st.rs), st.rs);
    const float dvar =
        st.var_raw >= 0.0f ? __fmul_rn(__fmul_rn(-0.5f, drs), rs3) : 0.0f;
    const float t = __fmul_rn(-dvar, st.mean);
    const float dmean = __fadd_rn(__fadd_rn(-sums[2], t), t);
    k = __fmul_rn(dvar, a.inv_n);
    dmean_n = __fmul_rn(dmean, a.inv_n);
  }
  reinterpret_cast<float2*>(a.coef)[c] = make_float2(k, dmean_n);
}

struct GradInputArgs {
  const void* x;
  const void* dout;
  void* dx;
  const float* stats;
  const float* bias;
  const float* coef;
  long long vectors;
  int channels, inner, act;
};

template <typename T>
__device__ __forceinline__ float grad_one(float x, float d,
                                          const GradInputArgs& a, int c) {
  const Stats st = load_stats(a.stats, c);
  const float2 k = reinterpret_cast<const float2*>(a.coef)[c];
  float dz = d;
  if (a.act) {
    const float z = round_to<T>(affine(x, st.mean, st.mul, a.bias[c]));
    dz = round_to<T>(swish_grad(d, z));
  }
  const float g = __fmul_rn(k.x, x);
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(dz, st.mul), g), g), k.y);
}

template <typename T, int W, int LAYOUT>
__global__ void __launch_bounds__(kThreads)
    bn_grad_input_kernel(GradInputArgs a) {
  const T* x = static_cast<const T*>(a.x);
  const T* d = static_cast<const T*>(a.dout);
  T* dx = static_cast<T*>(a.dx);
  for (long long u = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
       u < a.vectors; u += static_cast<long long>(gridDim.x) * kThreads) {
    const int e = static_cast<int>(u) * W;
    float xv[W], dv[W];
    load_w<T, W>(x + e, xv);
    load_w<T, W>(d + e, dv);
    if constexpr (LAYOUT == 0) {
      const int c = (e / a.inner) % a.channels;
#pragma unroll
      for (int j = 0; j < W; ++j) xv[j] = grad_one<T>(xv[j], dv[j], a, c);
    } else {
      const int c0 = e % a.channels;
#pragma unroll
      for (int j = 0; j < W; ++j) xv[j] = grad_one<T>(xv[j], dv[j], a, c0 + j);
    }
    store_w<T, W>(dx + e, xv);
  }
}

// an elementwise launch: grid-stride over the vectors, at most 32 blocks
// an SM's worth
int elementwise_blocks(long long vectors) {
  const long long blocks = (vectors + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 132 * 32 ? blocks : 132 * 32);
}

// `vec`: channels_last, vectors of 4 channels
template <typename T, bool GRAD>
int reduce(ReduceArgs a, int layout, int vec, cudaStream_t stream) {
  if (layout == 0) {
    const dim3 grid(a.channels, a.splits);
    bn_reduce_nchw<T, GRAD><<<grid, a.width * a.rows, 0, stream>>>(a);
  } else {
    const int cols = a.channels / (vec ? 4 : 1);
    const int ct = cols < kThreads / a.rows ? cols : kThreads / a.rows;
    const dim3 grid((cols + ct - 1) / ct, a.splits);
    if (vec)
      bn_reduce_nhwc<T, 4, GRAD><<<grid, ct * a.rows, 0, stream>>>(a);
    else
      bn_reduce_nhwc<T, 1, GRAD><<<grid, ct * a.rows, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int apply(ApplyArgs a, int layout, int vec, cudaStream_t stream) {
  constexpr int kN = Pack<T>::kN;
  const int blocks = elementwise_blocks(a.vectors);
  if (layout == 0) {
    if (vec)
      bn_apply_kernel<T, kN, 0><<<blocks, kThreads, 0, stream>>>(a);
    else
      bn_apply_kernel<T, 1, 0><<<blocks, kThreads, 0, stream>>>(a);
  } else {
    if (vec)
      bn_apply_kernel<T, kN, 1><<<blocks, kThreads, 0, stream>>>(a);
    else
      bn_apply_kernel<T, 1, 1><<<blocks, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int grad_input(GradInputArgs a, int layout, int vec, cudaStream_t stream) {
  constexpr int kN = Pack<T>::kN;
  const int blocks = elementwise_blocks(a.vectors);
  if (layout == 0) {
    if (vec)
      bn_grad_input_kernel<T, kN, 0><<<blocks, kThreads, 0, stream>>>(a);
    else
      bn_grad_input_kernel<T, 1, 0><<<blocks, kThreads, 0, stream>>>(a);
  } else {
    if (vec)
      bn_grad_input_kernel<T, kN, 1><<<blocks, kThreads, 0, stream>>>(a);
    else
      bn_grad_input_kernel<T, 1, 1><<<blocks, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// a finalize launch: `width` * `rows` threads a channel
int channel_blocks(int channels, int width, int rows) {
  const int per = kMaxThreads / (width * rows);
  return (channels + per - 1) / per;
}

}  // namespace

// the shape of every activation entry point: [B, C, H, W] as `batch`,
// `channels` and `inner` = H * W; `layout` 0 for NCHW, 1 for
// channels_last; `vec` 1 where vectors are taken; a reduce's `splits`,
// `width` and `rows`: G and ATen's block, bw lanes by bh (ry) rows (the
// header)
#define BN_ENTRIES(SUFFIX, T)                                                 \
  extern "C" int bn_stats_##SUFFIX(const void* x, float* partials,            \
                                   int batch, int channels, int inner,        \
                                   int layout, int vec, int splits,           \
                                   int width, int rows, void* stream) {       \
    ReduceArgs a{x, nullptr, nullptr, nullptr, partials, batch, channels,     \
                 inner, splits, 0, width, rows};                              \
    return reduce<T, false>(a, layout, vec,                                   \
                            static_cast<cudaStream_t>(stream));               \
  }                                                                           \
  extern "C" int bn_apply_##SUFFIX(                                           \
      const void* x, void* out, const float* stats,                           \
      const float* running_mean, const float* running_var,                    \
      const float* weight, const float* bias, float eps, int eval, int act,   \
      int batch, int channels, int inner, int layout, int vec,                \
      void* stream) {                                                         \
    const int w = vec ? Pack<T>::kN : 1;                                      \
    ApplyArgs a{x, out, stats, running_mean, running_var, weight, bias,       \
                static_cast<long long>(batch) * channels * inner / w,         \
                channels, inner, act, eval, eps};                             \
    return apply<T>(a, layout, vec, static_cast<cudaStream_t>(stream));       \
  }                                                                           \
  extern "C" int bn_grad_reduce_##SUFFIX(                                     \
      const void* x, const void* dout, const float* stats,                    \
      const float* bias, float* partials, int act, int batch, int channels,   \
      int inner, int layout, int vec, int splits, int width, int rows,        \
      void* stream) {                                                         \
    ReduceArgs a{x, dout, stats, bias, partials, batch, channels, inner,      \
                 splits, act, width, rows};                                   \
    return reduce<T, true>(a, layout, vec,                                    \
                           static_cast<cudaStream_t>(stream));                \
  }                                                                           \
  extern "C" int bn_grad_input_##SUFFIX(                                      \
      const void* x, const void* dout, void* dx, const float* stats,          \
      const float* bias, const float* coef, int act, int batch, int channels, \
      int inner, int layout, int vec, void* stream) {                         \
    const int w = vec ? Pack<T>::kN : 1;                                      \
    GradInputArgs a{x, dout, dx, stats, bias, coef,                           \
                    static_cast<long long>(batch) * channels * inner / w,     \
                    channels, inner, act};                                    \
    return grad_input<T>(a, layout, vec, static_cast<cudaStream_t>(stream));  \
  }

BN_ENTRIES(f32, float)
BN_ENTRIES(bf16, __nv_bfloat16)

extern "C" int bn_finalize(const float* partials, const float* means_in,
                           float* means_out, const float* weight,
                           float* running_mean, float* running_var,
                           float* stats, int channels, int splits,
                           int width, int rows, int update, int eval,
                           float inv_n, float eps, float momentum,
                           float one_minus, void* stream) {
  FinalizeArgs a{partials, means_in, means_out, weight, running_mean,
                 running_var, stats, channels, splits, width, rows,
                 update, eval, inv_n, eps, momentum, one_minus};
  bn_finalize_kernel<<<channel_blocks(channels, width, rows), kMaxThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_grad_finalize(const float* partials, const float* local_in,
                                const float* global_in, float* sums_out,
                                const float* stats, const float* weight,
                                float* dweight, float* dbias, float* coef,
                                int channels, int splits, int width,
                                int rows, int eval, float inv_n,
                                void* stream) {
  GradFinalizeArgs a{partials, local_in, global_in, sums_out, stats, weight,
                     dweight, dbias, coef, channels, splits, width, rows,
                     eval, inv_n};
  bn_grad_finalize_kernel<<<channel_blocks(channels, width, rows),
                            kMaxThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
