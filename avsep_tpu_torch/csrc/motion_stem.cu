// The motion net's stem: the 5x7x7 convolution at stride (1, 2, 2), padding
// (2, 3, 3), 3 input channels and 8 output channels, no bias, that opens the
// SlowFast fast pathway (avsep_tpu_torch/models/motion.py, ResNet3dFastOnly.
// conv1), in bfloat16 on the tensor cores, forward and weight gradient.
//
// It replaces no TPU kernel: the JAX package leaves this convolution to XLA.
// It was added because cuDNN finds no tensor-core shape for 3 input channels
// and ran the stem at about 5.3 TFLOP/s, the largest kernel of a clips
// training step (28.34 ms forward and 16.38 ms weight gradient per step of
// 32 clips of 32 x 224 x 224 on an H100).
//
//   out[b, t, oh, ow, n] = sum over kt, kh, kw, c of
//       bf16(x[b, t + kt - 2, 2 oh + kh - 3, 2 ow + kw - 3, c])
//       * bf16(weight[n, c, kt, kh, kw])
//
// x reads as zero outside the clip.  A uint8 clip is normalized in the load
// as ops/imagenet.py's normalize_frames does it, in float32 and in its order
// (times the float32 of 1/255, minus the ImageNet mean, divided by the std,
// each rounded on its own: no fused multiply-add), then rounded to bfloat16 as
// Conv3d.forward's cast does: a block computes the 3 x 256 values once into
// a table and looks each byte up.  A float32 clip is only rounded.  The sums
// are float32 and the output bfloat16, [B, T, OH, OW, 8] (channels last).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s).  Per call at the
// clips cell's shape (16 clips of 32 x 224 x 224): 75.5 GFLOP in each pass
// (M = 6.42 M output positions, N = 8, K = 735), 0.076 ms; bytes: the clip
// read once (77.1 MB uint8) and the bf16 output written once (102.8 MB), or
// for the weight gradient the clip and the output's gradient read once,
// 0.054 ms.  Operations bound both passes on paper, but N = 8 gives each
// element of the implicit GEMM's A operand only 8 multiply-adds, so the
// shared-memory reads that gather A bound the design in practice.
//
// Design, forward (avsep_motion_stem):
// - A block of 8 warps owns an output tile of 8 frames x 16 rows x 16
//   columns of one clip.  It stages the input the tile needs, 12 frames x 37
//   rows x 37 pixels, normalized and in bfloat16, in shared memory, each
//   pixel as 4 values (the 3 channels and a zero), 8 bytes; and the whole
//   weight, as the B fragments of mma.sync's m16n8k16 want it: per (kt, kh)
//   and per tap offset kw in [-2, 9], for each output channel n, the 4
//   values (w[n, 0..2], 0), zero where kw lies outside [0, 7).
// - A warp computes 16 output rows x 8 columns of two frames.  Each lane
//   loads whole pixels (8 bytes) as A fragments: one pixel gives the two
//   A registers of its two k-pairs (channels 0, 1 and 2, pad).  For one
//   (kt, kh), the 8 columns of a row read 21 pixels (2 x 7 + 7): six chunks
//   of 4, loaded once, serve all 8 columns, column j reading chunk c
//   against the weights of taps 4c + (0..3) - 2j.  So a (kt, kh) costs a
//   warp 24 eight-byte loads and 40 mma per two frames, where loading
//   each column's own window would take 64 loads.
// - Rows of the staged input are 42 pixels apart, so that the 16 lanes of a
//   half-warp (rows 2g + kh for g = 0..3, pixels q = 0..3) hit 16 distinct
//   pairs of banks; the weights' tap slots are 12 channels apart for the
//   same reason.
// - The output is stored as bf16 pairs straight from the accumulators.
// - Staging loads 12 slots per thread before it converts any, so that their
//   loads are in flight together.  Still, one block fits an SM, so staging
//   and the tensor cores take turns: at the cell's shape (0.83 ms a call on
//   an H100 at 700 W) the kernel without its mma takes 0.46 ms and without
//   its staging 0.47 ms.  Two blocks an SM would overlap them, at smaller
//   tiles and more halo.
//
// Design, weight gradient (avsep_motion_stem_wgrad):
// - dW[n, c, kt, kh, kw] = sum over all output positions of
//   grad[pos, n] * x[pos's input pixel for the tap, c], the same implicit
//   GEMM with the reduction over positions.  A block owns one 16 x 16
//   column of output positions of one clip over all frames, in chunks of 8
//   frames: the input of a chunk is staged as in the forward (recomputed
//   from the clip, so nothing but the clip is kept for the backward) and the
//   chunk's gradient, [8, 16, 16, 8] bf16, beside it.
// - The 70 K-chunks (5 x 7 (kt, kh) x 2 chunks of 4 taps x 4 channels; tap 7
//   and channel 3 are padding) are dealt to the 8 warps, 9 or 8 each, with
//   float32 accumulators that live across the block's loop.  For each group
//   of 16 positions (one output row of the tile) a warp loads the gradient
//   with ldmatrix.x2.trans (B: positions x channels) and each of its chunks
//   with ldmatrix.x4.trans (A: taps x positions, from the staged pixels, whose
//   rows of 2 pixels are 16-byte aligned), then issues one mma per chunk.
// - Each block writes its 5880 sums to its own column of a partial buffer;
//   a second kernel adds the columns of each weight in a fixed order (each
//   lane a fixed stride of them, then a fixed butterfly), so the result
//   repeats bit for bit, graph replays included.  The sum is rounded to
//   bfloat16 and back to float32, as the eager path's bf16 weight gradient
//   passes through the cast's backward.
// - The shared-memory reads of the A fragments bound it (each ldmatrix.x4
//   feeds one mma): at the cell's shape (1.13 ms a call) the kernel without
//   its mma takes 0.54 ms and without its staging 0.82 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCin = 3;
constexpr int kCout = 8;
constexpr int kKt = 5;
constexpr int kKh = 7;
constexpr int kKw = 7;
constexpr int kWeights = kCout * kCin * kKt * kKh * kKw;  // 5880

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// a block's output tile (frames, rows, columns)
constexpr int kTileT = 8;
constexpr int kTileH = 16;
constexpr int kTileW = 16;
// the staged input: frames, rows, pixels used and pixel slots per row
constexpr int kSlabT = kTileT + kKt - 1;       // 12
constexpr int kSlabH = 2 * kTileH + kKh - 2;   // 37
constexpr int kSlabUsed = 2 * kTileW + kKw - 2;  // 37
constexpr int kSlabW = 42;  // >= 2 * (kTileW - 8) + 24, even, 2 mod 8
constexpr int kSlab = kSlabT * kSlabH * kSlabW;  // 8-byte pixel slots
// the weight as B fragments: (kt, kh) x tap slot (kw + 2) x channel slot
constexpr int kTapSlots = 12;
constexpr int kChanSlots = 12;
constexpr int kWSlots = kKt * kKh * kTapSlots * kChanSlots;
// the gradient of a chunk: kTileT x kTileH x kTileW positions of 16 bytes
constexpr int kGrad = kTileT * kTileH * kTileW;
constexpr int kChunks = kKt * kKh * 2;  // K-chunks of the weight gradient
constexpr int kChunksPerWarp = (kChunks + kWarps - 1) / kWarps;  // 9

constexpr int kForwardSmem = 8 * (kSlab + kWSlots);
constexpr int kWgradSmem = 8 * kSlab + 16 * kGrad;

static_assert(kSlabW >= 2 * (kTileW - 8) + 24, "a warp reads 24 pixels");
static_assert(kSlabW % 8 == 2, "conflict-free A loads");
static_assert(kForwardSmem <= 232448 && kWgradSmem <= 232448, "smem");

struct Clip {
  const void* data;  // uint8 (to be normalized) or float32
  int batch, frames, height, width, out_h, out_w;
  long long sb, st, sh, sw, sc;  // element strides
  float scale;                   // float32(1 / 255)
  float mean[kCin], std[kCin];
};

// slots of the staged input a thread loads before it converts any, so that
// its loads are in flight together
constexpr int kStageBatch = 12;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return pack_bf16(x, 0.0f);
}

// The bf16 of each normalized uint8 value of each channel, for the block:
// (u * scale - mean) / std, each operation rounded on its own as
// ops/imagenet.py's normalize_frames computes it in float32.
__device__ void fill_lut(uint16_t* lut, const Clip& c) {
  for (int i = threadIdx.x; i < kCin * 256; i += kThreads) {
    const int ch = i >> 8;
    const float u = static_cast<float>(i & 255);
    // constant indices keep the clip's parameters out of local memory
    const float mean = ch == 0 ? c.mean[0] : ch == 1 ? c.mean[1] : c.mean[2];
    const float std = ch == 0 ? c.std[0] : ch == 1 ? c.std[1] : c.std[2];
    lut[i] = static_cast<uint16_t>(bf16_bits(
        __fdiv_rn(__fsub_rn(__fmul_rn(u, c.scale), mean), std)));
  }
}

__device__ __forceinline__ uint32_t value_bits(uint8_t u, int ch,
                                               const uint16_t* lut) {
  return lut[(ch << 8) + u];
}

__device__ __forceinline__ uint32_t value_bits(float x, int,
                                               const uint16_t*) {
  return bf16_bits(x);
}

// Stages the input of output frames t0.., rows oh0.., columns ow0.. of clip
// b: slot (f, r, l) holds pixel (t0 - 2 + f, 2 oh0 - 3 + r, 2 ow0 - 3 + l) as
// (c0, c1, c2, 0) in bf16, or zeros outside the clip and past the pixels
// the tile uses.
template <typename In>
__device__ void stage_input(uint2* slab, const uint16_t* lut, const Clip& c,
                            int b, int t0, int oh0, int ow0) {
  const In* data = static_cast<const In*>(c.data);
  for (int base = threadIdx.x; base < kSlab;
       base += kThreads * kStageBatch) {
    In raw[kStageBatch][kCin];
    bool ok[kStageBatch];
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int i = base + k * kThreads;
      const int l = i % kSlabW;
      const int fr = i / kSlabW;
      const int r = fr % kSlabH;
      const int f = fr / kSlabH;
      const int it = t0 - 2 + f;
      const int ih = 2 * oh0 - 3 + r;
      const int iw = 2 * ow0 - 3 + l;
      ok[k] = i < kSlab && l < kSlabUsed && it >= 0 && it < c.frames &&
              ih >= 0 && ih < c.height && iw >= 0 && iw < c.width;
      if (ok[k]) {
        const In* p = data + (b * c.sb + it * c.st + ih * c.sh + iw * c.sw);
#pragma unroll
        for (int ch = 0; ch < kCin; ++ch) raw[k][ch] = p[ch * c.sc];
      }
    }
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int i = base + k * kThreads;
      if (i < kSlab) {
        uint2 v = make_uint2(0u, 0u);
        if (ok[k]) {
          v.x = value_bits(raw[k][0], 0, lut) |
                (value_bits(raw[k][1], 1, lut) << 16);
          v.y = value_bits(raw[k][2], 2, lut);
        }
        slab[i] = v;
      }
    }
  }
}

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r,
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, "
               "[%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// the tile grid of a clip: blockIdx.x = tile row * tiles_w + tile column
__device__ __forceinline__ void tile_origin(const Clip& c, int* oh0,
                                            int* ow0) {
  const int tiles_w = (c.out_w + kTileW - 1) / kTileW;
  *oh0 = (blockIdx.x / tiles_w) * kTileH;
  *ow0 = (blockIdx.x % tiles_w) * kTileW;
}

// ------------------------------------------------------------- forward

template <typename In>
__global__ void __launch_bounds__(kThreads, 1)
    stem_forward_kernel(Clip c, const float* __restrict__ weight,
                        __nv_bfloat16* __restrict__ out) {
  extern __shared__ uint4 smem4[];
  __shared__ uint16_t lut[kCin * 256];
  uint2* slab = reinterpret_cast<uint2*>(smem4);
  uint2* wsm = slab + kSlab;

  const int b = blockIdx.z;
  const int t0 = blockIdx.y * kTileT;
  int oh0, ow0;
  tile_origin(c, &oh0, &ow0);

  // the weight as B fragments; slot (kk, s, n) holds taps kw = s - 2.  All
  // of a thread's loads are issued before any is used.
  constexpr int kFill = (kWSlots + kThreads - 1) / kThreads;
  float wv[kFill][kCin];
#pragma unroll
  for (int k = 0; k < kFill; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int n = i % kChanSlots;
    const int kk = i / (kChanSlots * kTapSlots);
    const int kw = (i / kChanSlots) % kTapSlots - 2;
    if (i < kWSlots && n < kCout && kw >= 0 && kw < kKw) {
      // weight [n, c, kt, kh, kw]: kk = kt * kKh + kh
      const float* w = weight + (n * kCin * kKt * kKh + kk) * kKw + kw;
#pragma unroll
      for (int ch = 0; ch < kCin; ++ch) wv[k][ch] = w[ch * kKt * kKh * kKw];
    } else {
#pragma unroll
      for (int ch = 0; ch < kCin; ++ch) wv[k][ch] = 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < kFill; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < kWSlots) {
      wsm[i] = make_uint2(pack_bf16(wv[k][0], wv[k][1]),
                          pack_bf16(wv[k][2], 0.0f));
    }
  }
  fill_lut(lut, c);
  __syncthreads();
  stage_input<In>(slab, lut, c, b, t0, oh0, ow0);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int col_group = warp & 1;  // output columns 8 * col_group + 0..7
  const int frame0 = warp >> 1;    // output frames frame0 and frame0 + 4

  float acc[2][8][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][j][e] = 0.0f;

#pragma unroll 1
  for (int kt = 0; kt < kKt; ++kt) {
#pragma unroll 1
    for (int kh = 0; kh < kKh; ++kh) {
      // B fragments of tap offsets d = 2 di - 2: taps d + q
      const uint2* wrow = wsm + (kt * kKh + kh) * kTapSlots * kChanSlots;
      uint2 bw[5];
#pragma unroll
      for (int di = 0; di < 5; ++di) {
        bw[di] = wrow[(2 * di + q) * kChanSlots + g];
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint2* row = slab +
                           ((frame0 + 4 * u + kt) * kSlabH + 2 * g + kh) *
                               kSlabW +
                           16 * col_group + q;
        uint2 lo[6], hi[6];  // output rows g and g + 8 (input rows + 16)
#pragma unroll
        for (int ch = 0; ch < 6; ++ch) {
          lo[ch] = row[4 * ch];
          hi[ch] = row[16 * kSlabW + 4 * ch];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // chunks whose taps 4 ch + q - 2 j meet [0, 7)
#pragma unroll
          for (int ch = 0; ch < 6; ++ch) {
            if (4 * ch - 2 * j < -3 || 4 * ch - 2 * j > 6) continue;
            const uint2 w = bw[2 * ch - j + 1];
            mma_bf16(acc[u][j], lo[ch].x, hi[ch].x, lo[ch].y, hi[ch].y, w.x,
                     w.y);
          }
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int t = t0 + frame0 + 4 * u;
    if (t >= c.frames) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int oh = oh0 + g + 8 * half;
      if (oh >= c.out_h) continue;
      const size_t row =
          ((static_cast<size_t>(b) * c.frames + t) * c.out_h + oh) * c.out_w;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ow = ow0 + 8 * col_group + j;
        if (ow >= c.out_w) continue;
        *reinterpret_cast<uint32_t*>(out + (row + ow) * kCout + 2 * q) =
            pack_bf16(acc[u][j][2 * half], acc[u][j][2 * half + 1]);
      }
    }
  }
}

// ------------------------------------------------------ weight gradient

template <typename In>
__global__ void __launch_bounds__(kThreads, 1)
    stem_wgrad_kernel(Clip c, const __nv_bfloat16* __restrict__ grad,
                      float* __restrict__ partial) {
  extern __shared__ uint4 smem4[];
  __shared__ uint16_t lut[kCin * 256];
  uint2* slab = reinterpret_cast<uint2*>(smem4);
  uint4* gsm = reinterpret_cast<uint4*>(slab + kSlab);

  const int b = blockIdx.y;
  const int blocks = gridDim.x * gridDim.y;
  const int block = blockIdx.y * gridDim.x + blockIdx.x;
  int oh0, ow0;
  tile_origin(c, &oh0, &ow0);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_chunks = warp + kWarps * (kChunksPerWarp - 1) < kChunks
                           ? kChunksPerWarp
                           : kChunksPerWarp - 1;
  // a chunk's offset in the staged input: frame kt, row kh, pixel 4 half
  int chunk_off[kChunksPerWarp];
#pragma unroll
  for (int i = 0; i < kChunksPerWarp; ++i) {
    const int id = min(warp + kWarps * i, kChunks - 1);
    const int kk = id >> 1;
    chunk_off[i] = ((kk / kKh) * kSlabH + kk % kKh) * kSlabW + 4 * (id & 1);
  }
  // ldmatrix rows: lanes 0-7 and 16-23 give positions 0-7 and 8-15 at
  // pixels (0, 1) of their window, lanes 8-15 and 24-31 at pixels (2, 3)
  const int pos = (lane & 7) + 8 * (lane >> 4);
  const int lane_off = 2 * pos + 2 * ((lane >> 3) & 1);

  float acc[kChunksPerWarp][4];
#pragma unroll
  for (int i = 0; i < kChunksPerWarp; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

  fill_lut(lut, c);
  for (int t0 = 0; t0 < c.frames; t0 += kTileT) {
    __syncthreads();  // the previous chunk is read, the table written
    // the chunk's gradient, every load of a thread issued before its
    // stores
    constexpr int kGradPerThread = kGrad / kThreads;
    static_assert(kGrad % kThreads == 0, "whole rounds");
    uint4 gv[kGradPerThread];
#pragma unroll
    for (int k = 0; k < kGradPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int ow = ow0 + i % kTileW;
      const int oh = oh0 + (i / kTileW) % kTileH;
      const int t = t0 + i / (kTileW * kTileH);
      gv[k] = make_uint4(0u, 0u, 0u, 0u);
      if (t < c.frames && oh < c.out_h && ow < c.out_w) {
        gv[k] = *reinterpret_cast<const uint4*>(
            grad +
            (((static_cast<size_t>(b) * c.frames + t) * c.out_h + oh) *
                 c.out_w +
             ow) *
                kCout);
      }
    }
    stage_input<In>(slab, lut, c, b, t0, oh0, ow0);
#pragma unroll
    for (int k = 0; k < kGradPerThread; ++k) {
      gsm[threadIdx.x + k * kThreads] = gv[k];
    }
    __syncthreads();

    const int nt = min(kTileT, c.frames - t0);
    const int nh = min(kTileH, c.out_h - oh0);
    for (int f = 0; f < nt; ++f) {
#pragma unroll 1
      for (int r = 0; r < nh; ++r) {
        uint32_t bg[2];
        ldmatrix_x2_trans(bg, gsm + (f * kTileH + r) * kTileW + (lane & 15));
        const uint2* base = slab + (f * kSlabH + 2 * r) * kSlabW + lane_off;
#pragma unroll
        for (int i = 0; i < kChunksPerWarp; ++i) {
          if (i < n_chunks) {
            uint32_t a[4];
            ldmatrix_x4_trans(a, base + chunk_off[i]);
            mma_bf16(acc[i], a[0], a[1], a[2], a[3], bg[0], bg[1]);
          }
        }
      }
    }
  }

  // acc[i][e]: tap row g + 8 (e >> 1) of chunk i (pixel >> 2, channel & 3),
  // output channel 2 q + (e & 1)
  const int g = lane >> 2;
  const int q = lane & 3;
#pragma unroll
  for (int i = 0; i < kChunksPerWarp; ++i) {
    if (i >= n_chunks) continue;
    const int id = warp + kWarps * i;
    const int kk = id >> 1;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kidx = g + 8 * (e >> 1);
      const int ci = kidx & 3;
      const int kw = 4 * (id & 1) + (kidx >> 2);
      if (ci >= kCin || kw >= kKw) continue;
      const int n = 2 * q + (e & 1);
      const int o = ((n * kCin + ci) * kKt * kKh + kk) * kKw + kw;
      partial[static_cast<size_t>(o) * blocks + block] = acc[i][e];
    }
  }
}

// out[o] = float32(bf16(sum of partial[o, 0 .. blocks))), one warp per o
__global__ void __launch_bounds__(kThreads)
    stem_wgrad_reduce_kernel(const float* __restrict__ partial,
                             float* __restrict__ out, int blocks) {
  const int o = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (o >= kWeights) return;
  const float* p = partial + static_cast<size_t>(o) * blocks;
  float s = 0.0f;
  for (int i = lane; i < blocks; i += 32) s += p[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(~0u, s, off);
  if (lane == 0) out[o] = __bfloat162float(__float2bfloat16_rn(s));
}

// opts the kernels in to their shared memory once per device
cudaError_t opt_in() {
  static bool done[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && done[device]) return cudaSuccess;
  const void* forward[] = {
      reinterpret_cast<const void*>(stem_forward_kernel<uint8_t>),
      reinterpret_cast<const void*>(stem_forward_kernel<float>)};
  const void* wgrad[] = {
      reinterpret_cast<const void*>(stem_wgrad_kernel<uint8_t>),
      reinterpret_cast<const void*>(stem_wgrad_kernel<float>)};
  for (int k = 0; k < 2 && err == cudaSuccess; ++k) {
    err = cudaFuncSetAttribute(forward[k],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kForwardSmem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(wgrad[k],
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kWgradSmem);
    }
  }
  if (err == cudaSuccess && device < 64) done[device] = true;
  return err;
}

Clip make_clip(const void* clips, int batch, int frames,
               int height, int width, long long sb, long long st,
               long long sh, long long sw, long long sc, float scale,
               float mean0, float mean1, float mean2, float std0, float std1,
               float std2) {
  Clip c;
  c.data = clips;
  c.batch = batch;
  c.frames = frames;
  c.height = height;
  c.width = width;
  c.out_h = (height - 1) / 2 + 1;
  c.out_w = (width - 1) / 2 + 1;
  c.sb = sb;
  c.st = st;
  c.sh = sh;
  c.sw = sw;
  c.sc = sc;
  c.scale = scale;
  c.mean[0] = mean0;
  c.mean[1] = mean1;
  c.mean[2] = mean2;
  c.std[0] = std0;
  c.std[1] = std1;
  c.std[2] = std2;
  return c;
}

unsigned tiles(const Clip& c) {
  return static_cast<unsigned>(((c.out_h + kTileH - 1) / kTileH) *
                               ((c.out_w + kTileW - 1) / kTileW));
}

}  // namespace

// clips [batch, frames, height, width, 3] with the given element strides,
// uint8 (clips_u8 = 1, normalized in the load with scale, mean and std) or
// float32 (clips_u8 = 0); weight [8, 3, 5, 7, 7] float32, contiguous; out
// [batch, frames, (height + 1) / 2, (width + 1) / 2, 8] bf16, contiguous.
// Returns the launch's error code (0 on success).
extern "C" int avsep_motion_stem(const void* clips, int clips_u8,
                                 const float* weight, void* out, int batch,
                                 int frames, int height, int width,
                                 long long sb, long long st, long long sh,
                                 long long sw, long long sc, float scale,
                                 float mean0, float mean1, float mean2,
                                 float std0, float std1, float std2,
                                 cudaStream_t stream) {
  const Clip c = make_clip(clips, batch, frames, height, width, sb, st, sh,
                           sw, sc, scale, mean0, mean1, mean2, std0, std1,
                           std2);
  cudaError_t err = opt_in();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tiles(c), (frames + kTileT - 1) / kTileT, batch);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (clips_u8) {
    stem_forward_kernel<uint8_t>
        <<<grid, kThreads, kForwardSmem, stream>>>(c, weight, o);
  } else {
    stem_forward_kernel<float>
        <<<grid, kThreads, kForwardSmem, stream>>>(c, weight, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// The weight gradient of avsep_motion_stem: clips as there; grad the
// output's gradient [batch, frames, (height + 1) / 2, (width + 1) / 2, 8]
// bf16, contiguous; partial float32 scratch of 5880 x (batch x tiles)
// values (tiles = ceil(out_h / 16) x ceil(out_w / 16)); grad_weight
// [8, 3, 5, 7, 7] float32.  Returns the first launch error (0 on success).
extern "C" int avsep_motion_stem_wgrad(const void* clips, int clips_u8,
                                       const void* grad, float* partial,
                                       float* grad_weight, int batch,
                                       int frames, int height, int width,
                                       long long sb, long long st,
                                       long long sh, long long sw,
                                       long long sc, float scale, float mean0,
                                       float mean1, float mean2, float std0,
                                       float std1, float std2,
                                       cudaStream_t stream) {
  const Clip c = make_clip(clips, batch, frames, height, width, sb, st, sh,
                           sw, sc, scale, mean0, mean1, mean2, std0, std1,
                           std2);
  cudaError_t err = opt_in();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tiles(c), batch);
  const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(grad);
  if (clips_u8) {
    stem_wgrad_kernel<uint8_t>
        <<<grid, kThreads, kWgradSmem, stream>>>(c, g, partial);
  } else {
    stem_wgrad_kernel<float>
        <<<grid, kThreads, kWgradSmem, stream>>>(c, g, partial);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_wgrad_reduce_kernel<<<(kWeights + kWarps - 1) / kWarps, kThreads, 0,
                             stream>>>(partial, grad_weight,
                                       static_cast<int>(grid.x * grid.y));
  return static_cast<int>(cudaGetLastError());
}
