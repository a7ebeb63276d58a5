// The motion net's train-mode BatchNorm in bfloat16, with the ReLU that
// follows it and a bottleneck's residual add, forward and backward, on a
// channels-last [B, C, T, H, W] activation (avsep_tpu_torch/models/motion.py,
// ResNet3dFastOnly and Bottleneck3d).
//
// It replaces no TPU kernel: the JAX package leaves BatchNorm to XLA.  It
// was added because PyTorch's CUDA batch norm takes a 5-D channels-last
// tensor as neither contiguous nor channels-last (its channels-last path is
// 4-D only) and falls to its generic Welford reduction and separate
// elementwise passes, about 26 ms per clips AV step on an H100, with the
// ReLU and the residual add as further elementwise kernels.
//
// With x viewed as rows [N = B T H W] x C (channels last), per channel c:
//   mean_c, var_c   the batch mean and biased variance in float32
//   scale_c         weight_c * rsqrt(var_c + eps)
//   bn              bf16((x - mean_c) * scale_c + bias_c)
//   pre             bn, or bf16(bn + residual) with a residual
//   y               relu(pre), or pre without the ReLU
// rounded to bfloat16 where layers.BatchNorm + the add + torch.relu round.
// Backward, with g = dy where pre > 0 (the mask recomputed from x, the
// statistics and the residual, not read from y), or g = dy without the ReLU:
//   dbias_c   = sum g            dweight_c = sum g * xhat, xhat = (x - mean_c)
//                                            * rsqrt(var_c + eps)
//   dx        = bf16(weight_c rsqrt(var_c + eps) (g - dbias_c / N
//                                                 - xhat dweight_c / N))
//   dresidual = g (bf16, exact).
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  Per element of x: statistics
// read 2; apply read 2 (4 with a residual) and write 2; backward reduce read
// 4 (6 with a residual under the ReLU); backward elementwise read 4 (6) and
// write 2 (4 with the residual's gradient).  At the clips cell (2 x 16 clips
// of 32 x 224 x 224 per AV step, 53 BatchNorms a clip) that is about 25 GB,
// 7.6 ms per AV step; the arithmetic is a few operations an element.
//
// Design, for every width of the net (C = 8 to 256):
// - A block of 256 threads owns a chunk of rows over all C channels.  A
//   thread owns one group of 8 channels (one 16-byte vector of a row), and
//   the C / 8 threads of a row read it whole, so neighbouring threads read
//   neighbouring 16 bytes at every C: 256 rows an iteration at C = 8, 8 at
//   C = 256.  Each thread keeps four loads in flight.
// - Statistics (bn_stats_kernel): per thread, float32 Welford (count, mean,
//   M2) over its rows, one reciprocal a row for its 8 channels; the block
//   merges its threads by Chan's formula in a fixed tree (shuffles inside
//   a warp, shared memory across warps); each block writes
//   its partial mean and M2 per channel to scratch.  bn_combine_stats_kernel
//   merges the blocks of a channel in a fixed order (a block a channel:
//   each thread loads its at most 5 partials at once and merges them, then
//   a butterfly in each warp and the 8 warps in order), so no atomics and a
//   replay gives the same bits.  The backward reduce and its combine do the
//   same with plain float32 sums of g and g (x - mean).  The combine is
//   latency, not bytes: one round of loads, not a chain of them.
// - Rows per block are sized so that a shape launches at most 1056 blocks
//   (two waves of 132 SMs at four resident blocks each) and at least 264,
//   with four rows a thread where that leaves 264 (kernels.motion_bn_plan in
//   Python, which sizes the scratch).
// - Every kernel is a template on the ReLU and the residual, so that a
//   variant carries neither the branches nor the registers of another.
//   Apply and backward elementwise keep each thread's 8 channels' constants
//   in registers and stream 16-byte vectors; the forward's normalization and
//   the backward's mask go through the same device function, so the mask
//   repeats the forward's rounding bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;      // channels of one 16-byte vector
constexpr int kUnroll = 4;   // loads in flight per thread
constexpr int kCombineThreads = 256;
constexpr int kPartialsPerThread = 5;  // blocks <= 1280
constexpr unsigned kAll = 0xffffffffu;

struct Rows {
  long long n;        // rows: B T H W
  int c8;             // C / 8: threads of one row
  int per_block;      // rows of one block's chunk
  int blocks;
};

__device__ __forceinline__ void unpack(uint4 v, float f[kVec]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack(const float f[kVec]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float inv_std(float var, float eps) {
  return rsqrtf(__fadd_rn(var, eps));
}

// The pre-activation: the rounded BatchNorm output, plus the residual
// rounded again where there is one.  Forward and backward both call it.
template <bool kRes>
__device__ __forceinline__ float pre_activation(float x, float mean,
                                                float scale, float bias,
                                                float res) {
  const float bn = round_bf16(__fmaf_rn(__fsub_rn(x, mean), scale, bias));
  return kRes ? round_bf16(__fadd_rn(bn, res)) : bn;
}

// a thread's place: channel group g of row lane r, rows r, r + rpi, ...
struct Lane {
  int g, r, rpi;
  long long row0, row1;
};

__device__ __forceinline__ Lane lane_of(const Rows& s) {
  Lane l;
  l.g = threadIdx.x % s.c8;
  l.r = threadIdx.x / s.c8;
  l.rpi = kThreads / s.c8;
  l.row0 = static_cast<long long>(blockIdx.x) * s.per_block;
  l.row1 = min(s.n, l.row0 + s.per_block);
  return l;
}

// Chan's merge of (nb, mb, Mb) into (na, ma, Ma)
__device__ __forceinline__ void merge(float& na, float& ma, float& Ma,
                                      float nb, float mb, float Mb) {
  if (nb == 0.f) return;
  const float n = na + nb;
  const float wb = nb / n;
  const float d = mb - ma;
  ma = __fmaf_rn(d, wb, ma);
  Ma = Ma + Mb + d * d * (na * wb);
  na = n;
}

// The per-channel constants of a thread's 8 channels
struct Channels {
  float mean[kVec], scale[kVec], bias[kVec];
};

__device__ __forceinline__ void load_channels(Channels& ch, int g,
                                              const float* mean,
                                              const float* var,
                                              const float* weight,
                                              const float* bias, float eps) {
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    const int k = kVec * g + c;
    ch.mean[c] = mean[k];
    ch.scale[c] = __fmul_rn(weight[k], inv_std(var[k], eps));
    ch.bias[c] = bias[k];
  }
}

// The levels of a block's tree that stay inside a warp: where C / 8
// divides 32, rows r and r + step of one channel group lie step * C / 8
// lanes apart for step < 32 / (C / 8), and shuffles take those levels;
// the rest go through shared memory.
__device__ __forceinline__ int tree_shuffles(const Rows& s) {
  return 32 % s.c8 == 0 ? 32 / s.c8 : 1;
}

// Statistics: Welford partials of each block.  The block's row lanes of
// each channel group merge in a fixed tree (lane r takes lane r + step for
// step = 1, 2, 4, ...); the backward reduce sums in the same tree.
__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(const uint4* __restrict__ x, Rows s,
                    float* __restrict__ part) {
  __shared__ float sh_n[kThreads];
  __shared__ float sh_m[kVec][kThreads];
  __shared__ float sh_M[kVec][kThreads];
  const Lane l = lane_of(s);
  float n = 0.f, m[kVec], M[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) m[c] = M[c] = 0.f;
  if (l.r < l.rpi) {
    for (long long row = l.row0 + l.r; row < l.row1;
         row += kUnroll * l.rpi) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long rr = row + u * l.rpi;
        if (rr < l.row1) v[u] = __ldg(x + rr * s.c8 + l.g);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (row + u * l.rpi >= l.row1) break;
        n += 1.f;
        const float inv = __frcp_rn(n);
        float f[kVec];
        unpack(v[u], f);
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          const float d = f[c] - m[c];
          m[c] = __fmaf_rn(d, inv, m[c]);
          M[c] = __fmaf_rn(d, f[c] - m[c], M[c]);
        }
      }
    }
  }
  const int t = threadIdx.x;
  int step = 1;
  for (; step < tree_shuffles(s); step *= 2) {
    const float no = __shfl_down_sync(kAll, n, step * s.c8);
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      const float mo = __shfl_down_sync(kAll, m[c], step * s.c8);
      const float Mo = __shfl_down_sync(kAll, M[c], step * s.c8);
      if (l.r % (2 * step) == 0) {
        float nc = n;
        merge(nc, m[c], M[c], no, mo, Mo);
      }
    }
    if (l.r % (2 * step) == 0 && no != 0.f) n += no;
  }
  sh_n[t] = n;
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    sh_m[c][t] = m[c];
    sh_M[c][t] = M[c];
  }
  __syncthreads();
  for (; step < l.rpi; step *= 2) {
    if (l.r < l.rpi && l.r % (2 * step) == 0 && l.r + step < l.rpi) {
      const int o = t + step * s.c8;
      const float no = sh_n[o];
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        float nc = n;
        merge(nc, m[c], M[c], no, sh_m[c][o], sh_M[c][o]);
        sh_m[c][t] = m[c];
        sh_M[c][t] = M[c];
      }
      if (no != 0.f) n += no;
      sh_n[t] = n;
    }
    __syncthreads();
  }
  if (l.r == 0) {
    const int C = s.c8 * kVec;
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      const long long k = kVec * l.g + c;
      part[k * s.blocks + blockIdx.x] = m[c];
      part[(C + k) * s.blocks + blockIdx.x] = M[c];
    }
  }
}

__device__ __forceinline__ float block_rows(const Rows& s, int b) {
  return static_cast<float>(
      min(static_cast<long long>(s.per_block),
          s.n - static_cast<long long>(b) * s.per_block));
}

// A block a channel k: partials p0 (and p1) of every block, each thread's
// loaded in one round.
template <typename F>
__device__ __forceinline__ void load_partials(const float* part, const Rows& s,
                                              int k, float p0[], float p1[],
                                              F&& each) {
  const int C = s.c8 * kVec;
#pragma unroll
  for (int i = 0; i < kPartialsPerThread; ++i) {
    const int b = threadIdx.x + i * kCombineThreads;
    if (b < s.blocks) {
      p0[i] = part[static_cast<long long>(k) * s.blocks + b];
      p1[i] = part[static_cast<long long>(C + k) * s.blocks + b];
    }
  }
#pragma unroll
  for (int i = 0; i < kPartialsPerThread; ++i) {
    const int b = threadIdx.x + i * kCombineThreads;
    if (b < s.blocks) each(b, p0[i], p1[i]);
  }
}

// mean and biased variance of channel blockIdx.x from the blocks' partials
__global__ void __launch_bounds__(kCombineThreads)
    bn_combine_stats_kernel(const float* __restrict__ part, Rows s,
                            float* __restrict__ mean,
                            float* __restrict__ var) {
  __shared__ float sh[3][kCombineThreads / 32];
  const int k = blockIdx.x;
  float pm[kPartialsPerThread], pM[kPartialsPerThread];
  float n = 0.f, m = 0.f, M = 0.f;
  load_partials(part, s, k, pm, pM, [&](int b, float mb, float Mb) {
    merge(n, m, M, block_rows(s, b), mb, Mb);
  });
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float no = __shfl_xor_sync(kAll, n, off);
    const float mo = __shfl_xor_sync(kAll, m, off);
    const float Mo = __shfl_xor_sync(kAll, M, off);
    merge(n, m, M, no, mo, Mo);
  }
  const int w = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    sh[0][w] = n;
    sh[1][w] = m;
    sh[2][w] = M;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int o = 1; o < kCombineThreads / 32; ++o) {
      merge(n, m, M, sh[0][o], sh[1][o], sh[2][o]);
    }
    mean[k] = m;
    var[k] = M / n;
  }
}

template <bool kRelu, bool kRes>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const uint4* __restrict__ x,
                    const uint4* __restrict__ residual,
                    const float* __restrict__ mean,
                    const float* __restrict__ var,
                    const float* __restrict__ weight,
                    const float* __restrict__ bias, uint4* __restrict__ y,
                    Rows s, float eps) {
  const Lane l = lane_of(s);
  if (l.r >= l.rpi) return;
  Channels ch;
  load_channels(ch, l.g, mean, var, weight, bias, eps);
  for (long long row = l.row0 + l.r; row < l.row1; row += kUnroll * l.rpi) {
    uint4 v[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = row + u * l.rpi;
      if (rr < l.row1) {
        v[u] = __ldg(x + rr * s.c8 + l.g);
        if (kRes) rv[u] = __ldg(residual + rr * s.c8 + l.g);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = row + u * l.rpi;
      if (rr >= l.row1) break;
      float f[kVec], rf[kVec];
      unpack(v[u], f);
      if (kRes) unpack(rv[u], rf);
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const float p = pre_activation<kRes>(f[c], ch.mean[c], ch.scale[c],
                                             ch.bias[c], kRes ? rf[c] : 0.f);
        // torch.relu keeps a NaN
        f[c] = (!kRelu || p > 0.f || p != p) ? p : 0.f;
      }
      y[rr * s.c8 + l.g] = pack(f);
    }
  }
}

// g for one vector: dy, zero where the recomputed pre-activation is not
// above 0 under the ReLU (the residual is read only for that)
template <bool kRelu, bool kRes>
__device__ __forceinline__ void masked_grad(float g[kVec], float xf[kVec],
                                            uint4 dy, uint4 xv, uint4 rv,
                                            const Channels& ch) {
  unpack(dy, g);
  unpack(xv, xf);
  if (!kRelu) return;
  float rf[kVec];
  if (kRes) unpack(rv, rf);
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    const float p = pre_activation<kRes>(xf[c], ch.mean[c], ch.scale[c],
                                         ch.bias[c], kRes ? rf[c] : 0.f);
    if (!(p > 0.f)) g[c] = 0.f;
  }
}

// Loads of the backward's passes: dy and x, and the residual where the
// mask needs it (the ReLU with a residual)
template <bool kMaskRes>
__device__ __forceinline__ void load_backward(const uint4* dy, const uint4* x,
                                              const uint4* residual,
                                              long long i, uint4& dv,
                                              uint4& xv, uint4& rv) {
  dv = __ldg(dy + i);
  xv = __ldg(x + i);
  if (kMaskRes) rv = __ldg(residual + i);
}

template <bool kRelu, bool kRes>
__global__ void __launch_bounds__(kThreads)
    bn_backward_reduce_kernel(const uint4* __restrict__ dy,
                              const uint4* __restrict__ x,
                              const uint4* __restrict__ residual,
                              const float* __restrict__ mean,
                              const float* __restrict__ var,
                              const float* __restrict__ weight,
                              const float* __restrict__ bias, Rows s,
                              float eps, float* __restrict__ part) {
  constexpr bool kMaskRes = kRelu && kRes;
  __shared__ float sh_g[kVec][kThreads];
  __shared__ float sh_gx[kVec][kThreads];
  const Lane l = lane_of(s);
  float sg[kVec], sgx[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) sg[c] = sgx[c] = 0.f;
  if (l.r < l.rpi) {
    Channels ch;
    load_channels(ch, l.g, mean, var, weight, bias, eps);
    for (long long row = l.row0 + l.r; row < l.row1;
         row += kUnroll * l.rpi) {
      uint4 dv[kUnroll], xv[kUnroll], rv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long rr = row + u * l.rpi;
        if (rr < l.row1) {
          load_backward<kMaskRes>(dy, x, residual, rr * s.c8 + l.g, dv[u],
                                  xv[u], rv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (row + u * l.rpi >= l.row1) break;
        float g[kVec], xf[kVec];
        masked_grad<kRelu, kMaskRes>(g, xf, dv[u], xv[u], rv[u], ch);
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          sg[c] += g[c];
          sgx[c] = __fmaf_rn(g[c], __fsub_rn(xf[c], ch.mean[c]), sgx[c]);
        }
      }
    }
  }
  const int t = threadIdx.x;
  int step = 1;
  for (; step < tree_shuffles(s); step *= 2) {
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      const float go = __shfl_down_sync(kAll, sg[c], step * s.c8);
      const float gxo = __shfl_down_sync(kAll, sgx[c], step * s.c8);
      if (l.r % (2 * step) == 0) {
        sg[c] += go;
        sgx[c] += gxo;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    sh_g[c][t] = sg[c];
    sh_gx[c][t] = sgx[c];
  }
  __syncthreads();
  for (; step < l.rpi; step *= 2) {
    if (l.r < l.rpi && l.r % (2 * step) == 0 && l.r + step < l.rpi) {
      const int o = t + step * s.c8;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        sg[c] += sh_g[c][o];
        sgx[c] += sh_gx[c][o];
        sh_g[c][t] = sg[c];
        sh_gx[c][t] = sgx[c];
      }
    }
    __syncthreads();
  }
  if (l.r == 0) {
    const int C = s.c8 * kVec;
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      const long long k = kVec * l.g + c;
      part[k * s.blocks + blockIdx.x] = sg[c];
      part[(C + k) * s.blocks + blockIdx.x] = sgx[c];
    }
  }
}

// dbias = sum g, dweight = rsqrt(var + eps) sum g (x - mean) of channel
// blockIdx.x
__global__ void __launch_bounds__(kCombineThreads)
    bn_combine_grad_kernel(const float* __restrict__ part, Rows s,
                           const float* __restrict__ var, float eps,
                           float* __restrict__ dweight,
                           float* __restrict__ dbias) {
  __shared__ float sh[2][kCombineThreads / 32];
  const int k = blockIdx.x;
  float pg[kPartialsPerThread], pgx[kPartialsPerThread];
  float sg = 0.f, sgx = 0.f;
  load_partials(part, s, k, pg, pgx, [&](int, float g, float gx) {
    sg += g;
    sgx += gx;
  });
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    sg += __shfl_xor_sync(kAll, sg, off);
    sgx += __shfl_xor_sync(kAll, sgx, off);
  }
  const int w = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    sh[0][w] = sg;
    sh[1][w] = sgx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int o = 1; o < kCombineThreads / 32; ++o) {
      sg += sh[0][o];
      sgx += sh[1][o];
    }
    dbias[k] = sg;
    dweight[k] = sgx * inv_std(var[k], eps);
  }
}

template <bool kRelu, bool kRes>
__global__ void __launch_bounds__(kThreads, 2)
    bn_backward_apply_kernel(const uint4* __restrict__ dy,
                             const uint4* __restrict__ x,
                             const uint4* __restrict__ residual,
                             const float* __restrict__ mean,
                             const float* __restrict__ var,
                             const float* __restrict__ weight,
                             const float* __restrict__ bias,
                             const float* __restrict__ dweight,
                             const float* __restrict__ dbias,
                             uint4* __restrict__ dx,
                             uint4* __restrict__ dresidual, Rows s,
                             float eps) {
  constexpr bool kMaskRes = kRelu && kRes;
  const Lane l = lane_of(s);
  if (l.r >= l.rpi) return;
  Channels ch;
  load_channels(ch, l.g, mean, var, weight, bias, eps);
  // dx = a (g - k1 - (x - mean) k2)
  float a[kVec], k1[kVec], k2[kVec];
  const float inv_n = 1.f / static_cast<float>(s.n);
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    const int k = kVec * l.g + c;
    const float is = inv_std(var[k], eps);
    a[c] = weight[k] * is;
    k1[c] = dbias[k] * inv_n;
    k2[c] = dweight[k] * is * inv_n;
  }
  for (long long row = l.row0 + l.r; row < l.row1; row += kUnroll * l.rpi) {
    uint4 dv[kUnroll], xv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = row + u * l.rpi;
      if (rr < l.row1) {
        load_backward<kMaskRes>(dy, x, residual, rr * s.c8 + l.g, dv[u],
                                xv[u], rv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = row + u * l.rpi;
      if (rr >= l.row1) break;
      const long long i = rr * s.c8 + l.g;
      float g[kVec], xf[kVec], out[kVec];
      masked_grad<kRelu, kMaskRes>(g, xf, dv[u], xv[u], rv[u], ch);
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        out[c] = a[c] * (g[c] - k1[c] - (xf[c] - ch.mean[c]) * k2[c]);
      }
      dx[i] = pack(out);
      if (kRes) dresidual[i] = pack(g);
    }
  }
}

Rows make_rows(long long rows, int channels, int per_block, int blocks) {
  Rows s;
  s.n = rows;
  s.c8 = channels / kVec;
  s.per_block = per_block;
  s.blocks = blocks;
  return s;
}

template <bool kRelu, bool kRes>
cudaError_t forward(const uint4* x, const uint4* residual,
                    const float* weight, const float* bias, uint4* y,
                    float* mean, float* var, float* partial, const Rows& s,
                    int channels, float eps, cudaStream_t stream) {
  bn_stats_kernel<<<s.blocks, kThreads, 0, stream>>>(x, s, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_combine_stats_kernel<<<channels, kCombineThreads, 0, stream>>>(
      partial, s, mean, var);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_apply_kernel<kRelu, kRes><<<s.blocks, kThreads, 0, stream>>>(
      x, residual, mean, var, weight, bias, y, s, eps);
  return cudaGetLastError();
}

template <bool kRelu, bool kRes>
cudaError_t backward(const uint4* dy, const uint4* x, const uint4* residual,
                     const float* weight, const float* bias,
                     const float* mean, const float* var, uint4* dx,
                     uint4* dresidual, float* dweight, float* dbias,
                     float* partial, const Rows& s, int channels, float eps,
                     cudaStream_t stream) {
  bn_backward_reduce_kernel<kRelu, kRes><<<s.blocks, kThreads, 0, stream>>>(
      dy, x, residual, mean, var, weight, bias, s, eps, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_combine_grad_kernel<<<channels, kCombineThreads, 0, stream>>>(
      partial, s, var, eps, dweight, dbias);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_backward_apply_kernel<kRelu, kRes><<<s.blocks, kThreads, 0, stream>>>(
      dy, x, residual, mean, var, weight, bias, dweight, dbias, dx,
      dresidual, s, eps);
  return cudaGetLastError();
}

}  // namespace

// x [rows, channels] bf16 (a channels-last [B, C, T, H, W], rows = B T H W),
// 16-byte aligned; residual the same shape or null; weight, bias [channels]
// float32; y like x; mean, var [channels] float32 (the biased variance);
// partial float32 scratch of 2 x channels x blocks.  channels a multiple of
// 8 up to 2048; per_block rows of each of the blocks (at most 1280) chunks
// (kernels.motion_bn_plan).  Returns the first launch error (0 on success).
extern "C" int avsep_motion_bn(const void* x, const void* residual,
                               const float* weight, const float* bias,
                               void* y, float* mean, float* var,
                               float* partial, long long rows, int channels,
                               int per_block, int blocks, float eps, int relu,
                               cudaStream_t stream) {
  const Rows s = make_rows(rows, channels, per_block, blocks);
  const uint4* xv = static_cast<const uint4*>(x);
  const uint4* rv = static_cast<const uint4*>(residual);
  uint4* yv = static_cast<uint4*>(y);
  const auto run = relu ? (rv ? forward<true, true> : forward<true, false>)
                        : (rv ? forward<false, true> : forward<false, false>);
  return static_cast<int>(run(xv, rv, weight, bias, yv, mean, var, partial,
                              s, channels, eps, stream));
}

// The backward of avsep_motion_bn: grad the output's gradient like x
// (channels last, dense); x, residual, weight, bias, mean, var as the
// forward had and gave them; dx like x; dresidual like x where there is a
// residual (its gradient, g), else null; dweight, dbias [channels] float32;
// partial as the forward's.  Returns the first launch error (0 on
// success).
extern "C" int avsep_motion_bn_backward(
    const void* grad, const void* x, const void* residual,
    const float* weight, const float* bias, const float* mean,
    const float* var, void* dx, void* dresidual, float* dweight,
    float* dbias, float* partial, long long rows, int channels, int per_block,
    int blocks, float eps, int relu, cudaStream_t stream) {
  const Rows s = make_rows(rows, channels, per_block, blocks);
  const uint4* rv = static_cast<const uint4*>(residual);
  const auto run = relu ? (rv ? backward<true, true> : backward<true, false>)
                        : (rv ? backward<false, true>
                              : backward<false, false>);
  return static_cast<int>(run(
      static_cast<const uint4*>(grad), static_cast<const uint4*>(x), rv,
      weight, bias, mean, var, static_cast<uint4*>(dx),
      static_cast<uint4*>(dresidual), dweight, dbias, partial, s, channels,
      eps, stream));
}
