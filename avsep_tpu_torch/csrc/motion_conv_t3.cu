// The motion net's 3x1x1 temporal convolutions (the SlowFast fast pathway's
// bottleneck conv1s, avsep_tpu_torch/models/motion.py, Bottleneck3d.conv1) in
// bfloat16 on channels-last-3d activations, on the tensor cores: the
// convolution (which also gives the input gradient) and the weight gradient.
//
// It replaces no TPU kernel: the JAX package leaves this convolution to XLA.
// It was added because cuDNN, handed a channels-last-3d bf16 tensor at a
// 3x1x1 kernel, converts it to NCDHW, runs a float32 FFMA kernel without
// tensor cores and converts back: 11.36 ms of an AV step's 32 forwards
// (8.57 of them the FFMA kernel) on an H100, where reading and writing
// their 1.93 GB takes 0.575 ms.
//
//   y[b, t, p, n] = sum over k in 0..2, c of
//       x[b, t + k - 1, p, c] * w[k][n][c]        (zero outside 0 <= t < T)
//
// x is [B, T, HW, C] (a channels-last-3d [B, C, T, H, W] tensor, p the
// position in the H x W plane), w[k][n][c] the conv's weight [N, C, 3, 1, 1]
// at [n, c, k], y [B, T, HW, N]; float32 sums, rounded once to bfloat16.
// The input gradient of a stride-1, pad-1 temporal conv is the same
// convolution of the output gradient with the taps transposed and reversed
// (w'[k][c][n] = w[2 - k][n][c]), so one kernel serves both: it reads the
// conv's weight either way into its taps.
//
//   dw[k][c][n] = sum over b, t, p of x[b, t + k - 1, p, c] * dy[b, t, p, n]
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s).  The fast
// pathway's 16 conv1s take 8 to 256 input and 8 to 64 output channels, at
// most 154 operations per byte moved, below the card's 295: memory bounds
// all three passes.  Per AV step (32 clips of 32 frames) each pass moves
// 1.93 GB (the convolution reads x and writes y, the weight gradient reads
// x and dy): 0.575 ms, where the 90 GFLOP take 0.09 ms.  So the design
// reads each byte once and keeps the loads in flight.
//
// Design, convolution (avsep_motion_conv_t3):
// - Implicit GEMM over the channels-last view: M the positions, N the
//   output channels, K = 3 C (tap-major).  In channels-last-3d a temporal
//   tap is the same H x W x C slab one frame earlier or later, so a block
//   owns a tile of a clip's plane (the plane cut into equal tiles of at
//   most BM positions) and walks along a run of frames: the tiles of the
//   frames it needs, each a contiguous span of x, sit in a ring of
//   shared-memory stages, loaded by cp.async with the next frames in
//   flight while the tensor cores work, so each byte of x is read from
//   device memory once (plus one frame each side of a run).  A frame
//   outside the clip is zero-filled.
// - The taps [3, N, C] stay in shared memory for the block's life; each
//   block gathers them from the conv's weight (16-byte loads for the
//   forward, 2-byte loads whose lanes read neighbours for the input
//   gradient), so no reordering kernel runs beside it.
// - A warp computes 32 positions x N / WN output channels of each frame
//   with mma.sync m16n8k16 (bf16 in, float32 sums), A and B from
//   ldmatrix; a warp whose positions lie past the tile skips its work.  K
//   runs in chunks of 8 channels of one tap, two chunks a k-step (with
//   C = 8 a step spans two taps, and the last pairs tap 2 with zeros).
//   Shared-memory tiles are stored in 16-byte chunks XOR-swizzled within
//   each 128-byte line, so the 8 rows an ldmatrix reads fall in distinct
//   banks (swz).
// - The kernels are templates on C, N and WN, so the K loop unrolls with
//   every offset but a lane's own folded into constants: at these shapes
//   an address computed in the loop costs more instruction slots than the
//   tensor cores' work.
// - The sums are rounded to bfloat16 pairs and stored straight from the
//   accumulators.
// - WN (the warps across N, the rest across positions), the tile, the
//   frames a block walks and the stages are chosen by the wrapper
//   (ops/kernels.py, motion_conv_t3_plan): stages of at most 32 KB, two
//   blocks an SM where their shared memory fits, enough blocks for the
//   132 SMs.  The (C, N, WN) instantiated are the fast pathway's conv1s
//   and their input gradients.
//
// Design, weight gradient (avsep_motion_conv_t3_wgrad):
// - The same walk along frames with x's and dy's tiles in the ring; the
//   GEMM's rows are the (tap, channel) pairs in chunks of 8, its columns
//   the output channels, its reduction the positions.  A block takes a
//   group of up to 4 chunks of channels with their three taps (12 chunks,
//   6 row tiles, one a warp; with C = 8 the warps left over split the
//   positions) and all N columns, and stages only the group's channels of
//   x, so each byte of x is read once; dy is read once a group.
// - Each block writes its float32 sums to a row of a partial buffer; a
//   second kernel adds the rows in a fixed order (each of up to 32 warps a
//   fixed stride of them in 8 chains, then the chains and the warps in
//   order),
//   rounds once to bfloat16 and writes dw as [N, C, 3], so two calls give
//   the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemMax = 232448;
constexpr int kMaxStages = 12;

struct Conv {
  const __nv_bfloat16* x;  // [B, T, HW, C]
  // the conv's weight: [N, C, 3] (forward) or [C, N, 3] (grad_input, the
  // input gradient's taps transposed and reversed)
  const __nv_bfloat16* w;
  __nv_bfloat16* y;  // [B, T, HW, N]
  int frames, hw, tile_rows, run, stages, grad_input;
};

struct Wgrad {
  const __nv_bfloat16* x;   // [B, T, HW, C]
  const __nv_bfloat16* dy;  // [B, T, HW, N]
  float* partial;           // [blocks over positions][3 C N]
  int frames, hw, run, stages, bm;
};

// where chunk ``c8`` of row ``row`` of a tile of CHUNKS 16-byte chunks a row
// lies: XOR-swizzled within its line of 8 chunks, by the row where a row
// holds 8 chunks or more, else by the line, so that the 8 rows an ldmatrix
// reads fall in 8 distinct groups of banks
template <int CHUNKS>
__device__ __forceinline__ int swz(int row, int c8) {
  const int i = row * CHUNKS + c8;
  return CHUNKS >= 8 ? i ^ (row & 7) : i ^ ((i >> 3) & 7);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// waits until at most ``n`` of this thread's groups are pending
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    default: cp_async_wait<8>(); break;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r,
                                                  uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, "
               "[%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Starts the copies of ``rows`` rows of CHUNKS 16-byte chunks each from
// ``src`` (rows ``stride`` chunks apart) into the swizzled tile at shared
// address ``dst``; rows at or past ``valid_rows`` are zero-filled.
template <int CHUNKS>
__device__ __forceinline__ void load_tile(uint32_t dst, const uint4* src,
                                          int rows, long long stride,
                                          int valid_rows, const void* any) {
  for (int i = threadIdx.x; i < rows * CHUNKS; i += kThreads) {
    const int r = i / CHUNKS;
    const int c = i % CHUNKS;
    const bool ok = r < valid_rows;
    cp_async16(dst + 16 * swz<CHUNKS>(r, c), ok ? src + r * stride + c : any,
               ok);
  }
}

// ------------------------------------------------------------ convolution

// The taps[k][n][c] into the swizzled rows (k N + n) of 8-channel chunks at
// shared address ``wsm``, from the conv's weight: w[n][c][k] ([N, C, 3]: a
// (n, chunk) item is 48 contiguous bytes, three 16-byte loads spread over
// the three taps) or, with ``grad_input``, w[c][n][2 - k] ([C, N, 3]: an
// item (k, n, chunk) gathers 8 values, the lanes of a warp on neighbouring
// n).  Plain stores: the walk's first barrier makes them visible.
template <int C, int N>
__device__ __forceinline__ void load_taps(uint32_t wsm,
                                          const __nv_bfloat16* w,
                                          int grad_input) {
  constexpr int C8 = C / 8;
  const uint16_t* wv = reinterpret_cast<const uint16_t*>(w);
  if (!grad_input) {
    for (int i = threadIdx.x; i < N * C8; i += kThreads) {
      const int n = i / C8;
      const int c8 = i % C8;
      const uint4* src = reinterpret_cast<const uint4*>(w) + 3 * i;
      uint4 raw[3] = {src[0], src[1], src[2]};
      const uint16_t* v = reinterpret_cast<const uint16_t*>(raw);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        uint32_t h[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          h[e] = static_cast<uint32_t>(v[6 * e + k]) |
                 (static_cast<uint32_t>(v[6 * e + 3 + k]) << 16);
        }
        const uint32_t dst = wsm + 16 * swz<C8>(k * N + n, c8);
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                     "r"(h[0]), "r"(h[1]), "r"(h[2]), "r"(h[3]));
      }
    }
  } else {
    for (int i = threadIdx.x; i < 3 * N * C8; i += kThreads) {
      const int n = i % N;
      const int c8 = (i / N) % C8;
      const int k = i / (N * C8);
      const uint16_t* src = wv + (8 * c8 * N + n) * 3 + 2 - k;
      uint32_t h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[e] = static_cast<uint32_t>(src[2 * e * N * 3]) |
               (static_cast<uint32_t>(src[(2 * e + 1) * N * 3]) << 16);
      }
      const uint32_t dst = wsm + 16 * swz<C8>(k * N + n, c8);
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                   "r"(h[0]), "r"(h[1]), "r"(h[2]), "r"(h[3]));
    }
  }
}

template <int C, int N, int WN>
__global__ void __launch_bounds__(kThreads, 2) conv_t3_kernel(Conv p) {
  constexpr int C8 = C / 8;
  constexpr int STEPS = (3 * C8 + 1) / 2;  // k16 steps
  constexpr int WM = kWarps / WN;
  constexpr int BM = 32 * WM;       // positions a stage holds
  constexpr int NW = N / (8 * WN);  // n8 tiles a warp
  constexpr int TILE = 16 * BM * C8;  // bytes of a stage
  static_assert(NW >= 1 && NW <= 4 && N % (8 * WN) == 0, "warp tile");
  static_assert(C8 == 1 || C8 % 2 == 0, "a k-step's two chunks");
  extern __shared__ uint4 smem[];
  const uint32_t zero = smem_addr(smem);  // one line of zeros
  const uint32_t wsm = zero + 128;
  const uint32_t ring = wsm + 16 * 3 * N * C8;

  const int hw0 = blockIdx.x * p.tile_rows;
  const int valid_rows = min(p.tile_rows, p.hw - hw0);
  const int t0 = blockIdx.y * p.run;
  const int t1 = min(p.frames, t0 + p.run);
  const int b = blockIdx.z;
  const int nf = t1 - t0 + 2;  // frames t0 - 1 .. t1
  const uint4* x = reinterpret_cast<const uint4*>(p.x);

  if (threadIdx.x < 8) smem[threadIdx.x] = make_uint4(0u, 0u, 0u, 0u);
  // frame t0 - 1 + i into stage i % stages: the tile's rows, zeros outside
  // the clip
  auto load_frame = [&](int i) {
    const int f = t0 - 1 + i;
    const bool in_clip = f >= 0 && f < p.frames;
    const uint4* src =
        in_clip ? x + ((static_cast<long long>(b) * p.frames + f) * p.hw +
                       hw0) * C8
                : x;
    load_tile<C8>(ring + (i % p.stages) * TILE, src, valid_rows, C8,
                  in_clip ? valid_rows : 0, p.x);
  };
  for (int i = 0; i < p.stages - 1; ++i) {
    if (i < nf) load_frame(i);
    cp_async_commit();
  }
  load_taps<C, N>(wsm, p.w, p.grad_input);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / WN;
  const int wn = warp % WN;
  // rows past the tile: a warp with none left skips, and its second half
  // where that has none
  const bool live = wm * 32 < valid_rows;
  const bool live1 = wm * 32 + 16 < valid_rows;
  // ldmatrix roles.  A matrices: (rows 0-7, first chunk of the step),
  // (rows 8-15, first), (rows 0-7, second), (rows 8-15, second); B
  // matrices: (n tile j, first), (j, second), (j + 1, first), (j + 1,
  // second).  Each lane's part of an address is fixed here; the step's
  // part is a constant of the unrolled loop.
  const int a_sec = lane >> 4;
  const int b_sec = (lane >> 3) & 1;
  int a_off[2];
  int a_x[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int row = wm * 32 + 16 * mi + (lane & 7) + ((lane >> 3) & 1) * 8;
    a_off[mi] = row * C8;
    a_x[mi] = C8 >= 8 ? (row & 7) : ((row * C8) >> 3) & 7;
  }
  const int b_row = wn * NW * 8 + (lane & 7) + (lane >> 4) * 8;

  for (int j = 0; j < t1 - t0; ++j) {
    cp_async_wait_upto(p.stages - 4);  // frames j .. j + 2 have landed
    __syncthreads();                   // and frame j - 1's stage is free
    if (j + p.stages - 1 < nf) load_frame(j + p.stages - 1);
    cp_async_commit();
    if (!live) continue;
    const uint32_t st[3] = {ring + (j % p.stages) * TILE,
                            ring + ((j + 1) % p.stages) * TILE,
                            ring + ((j + 2) % p.stages) * TILE};

    float acc[2][NW][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int jn = 0; jn < NW; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][jn][e] = 0.0f;

#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      // this lane's chunk of the step, (tap, channel chunk), for A and B
      const int ka = 2 * s + a_sec;
      const int kb = 2 * s + b_sec;
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (mi == 1 && !live1) continue;
        uint32_t addr;
        if (C8 == 1) {  // chunk = tap; the fourth is zeros
          const int i = a_off[mi] ^ a_x[mi];
          addr = ka < 3 ? (ka == 0 ? st[0] : ka == 1 ? st[1] : st[2]) + 16 * i
                        : zero;
        } else {
          const int tap = (2 * s) / C8;  // both chunks of the step
          const int c8 = (2 * s) % C8 + a_sec;
          const int i = C8 >= 8 ? a_off[mi] + (c8 ^ a_x[mi])
                                : (a_off[mi] + c8) ^ a_x[mi];
          addr = st[tap] + 16 * i;
        }
        ldmatrix_x4(a[mi], addr);
      }
#pragma unroll
      for (int jn = 0; jn < NW; jn += 2) {
        const int row = (kb / C8) * N + b_row + 8 * jn;
        const int i = swz<C8>(row, kb % C8);
        const uint32_t addr = kb < 3 * C8 ? wsm + 16 * i : zero;
        uint32_t bf[4];
        if (jn + 1 < NW) {
          ldmatrix_x4(bf, addr);
        } else {
          ldmatrix_x2(bf, addr);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (mi == 1 && !live1) continue;
          mma_bf16(acc[mi][jn], a[mi], bf[0], bf[1]);
          if (jn + 1 < NW) mma_bf16(acc[mi][jn + 1], a[mi], bf[2], bf[3]);
        }
      }
    }

    const long long frame_row =
        (static_cast<long long>(b) * p.frames + t0 + j) * p.hw + hw0;
    const int g = lane >> 2;
    const int q = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 32 + 16 * mi + g + 8 * half;
        if (r >= valid_rows) continue;
        uint32_t* out = reinterpret_cast<uint32_t*>(
            p.y + (frame_row + r) * N + wn * NW * 8 + 2 * q);
#pragma unroll
        for (int jn = 0; jn < NW; ++jn) {
          out[jn * 4] = pack_bf16(acc[mi][jn][2 * half],
                                  acc[mi][jn][2 * half + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------- weight gradient

template <int C, int N>
__global__ void __launch_bounds__(kThreads, 2) wgrad_t3_kernel(Wgrad p) {
  constexpr int C8 = C / 8;
  constexpr int CT = N / 8;
  // a group: GC8 chunks of 8 channels, all three taps (channel-major rows)
  constexpr int GC8 = C8 < 4 ? C8 : 4;
  constexpr int GROUPS = C8 / GC8;
  constexpr int NR8 = 3 * GC8;           // the group's row chunks
  constexpr int RT_N = (NR8 + 1) / 2;    // its row tiles, one a warp
  constexpr int PHASES = kWarps / RT_N;  // warps a row tile
  static_assert(C8 % GC8 == 0 && RT_N <= kWarps, "groups");
  extern __shared__ uint4 smem[];
  const int group = blockIdx.x % GROUPS;
  const int tile_idx = blockIdx.x / GROUPS;
  const int bm = p.bm;
  const int x_tile = 16 * bm * GC8;  // bytes
  const int stage = x_tile + 16 * bm * CT;
  const uint32_t zero = smem_addr(smem);
  const uint32_t ring = zero + 128;

  const int hw0 = tile_idx * bm;
  const int t0 = blockIdx.y * p.run;
  const int t1 = min(p.frames, t0 + p.run);
  const int b = blockIdx.z;
  const int nf = t1 - t0 + 2;
  const int valid_rows = min(bm, p.hw - hw0);
  const uint4* x = reinterpret_cast<const uint4*>(p.x);
  const uint4* dy = reinterpret_cast<const uint4*>(p.dy);

  if (threadIdx.x < 8) smem[threadIdx.x] = make_uint4(0u, 0u, 0u, 0u);
  // frame t0 - 1 + i: the group's channels of x into stage i % stages, and
  // dy where the frame is one the block sums over; positions past the
  // plane are zeros
  auto load_frame = [&](int i) {
    const int f = t0 - 1 + i;
    const uint32_t st = ring + (i % p.stages) * stage;
    const bool in_clip = f >= 0 && f < p.frames;
    const long long row0 =
        (static_cast<long long>(b) * p.frames + f) * p.hw + hw0;
    load_tile<GC8>(st, in_clip ? x + row0 * C8 + group * GC8 : x, bm, C8,
                   in_clip ? valid_rows : 0, p.x);
    if (f >= t0 && f < t1) {
      load_tile<CT>(st + x_tile, dy + row0 * CT, bm, CT, valid_rows, p.dy);
    }
  };
  for (int i = 0; i < p.stages - 1; ++i) {
    if (i < nf) load_frame(i);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool active = warp < RT_N * PHASES;
  const int rt = warp % RT_N;
  const int phase = warp / RT_N;
  // A (x^T) matrices: (chunk a, positions 0-7), (b, 0-7), (a, 8-15),
  // (b, 8-15), a chunk (channel chunk r / 3, tap r % 3); B (dy) matrices:
  // (positions 0-7, column chunk c), (8-15, c), (0-7, c + 1), (8-15, c + 1)
  const int a_chunk = 2 * rt + ((lane >> 3) & 1);
  const int a_pos = (lane & 7) + (lane >> 4) * 8;
  const int b_pos = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_chunk = lane >> 4;
  const bool a_ok = a_chunk < NR8;
  const int a_tap = a_chunk % 3;
  const int a_c8 = a_chunk / 3;

  float acc[CT][4];
#pragma unroll
  for (int ct = 0; ct < CT; ++ct)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ct][e] = 0.0f;

  for (int j = 0; j < t1 - t0; ++j) {
    cp_async_wait_upto(p.stages - 4);
    __syncthreads();
    if (j + p.stages - 1 < nf) load_frame(j + p.stages - 1);
    cp_async_commit();
    if (!active) continue;
    const uint32_t xs = ring + ((j + a_tap) % p.stages) * stage;
    const uint32_t gs = ring + ((j + 1) % p.stages) * stage + x_tile;
#pragma unroll 2
    for (int pg = 16 * phase; pg < valid_rows; pg += 16 * PHASES) {
      uint32_t a[4];
      ldmatrix_x4_trans(
          a, a_ok ? xs + 16 * swz<GC8>(pg + a_pos, a_c8) : zero);
#pragma unroll
      for (int ct = 0; ct < CT; ct += 2) {
        uint32_t bf[4];
        const uint32_t addr = gs + 16 * swz<CT>(pg + b_pos, ct + b_chunk);
        if (ct + 1 < CT) {
          ldmatrix_x4_trans(bf, addr);
          mma_bf16(acc[ct], a, bf[0], bf[1]);
          mma_bf16(acc[ct + 1], a, bf[2], bf[3]);
        } else {
          ldmatrix_x2_trans(bf, addr);
          mma_bf16(acc[ct], a, bf[0], bf[1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the phases' sums

  // acc[ct][e]: row g + 8 (e >> 1) of the row tile (chunk 2 rt + (e >> 1),
  // channel g of it), column 8 ct + 2 q + (e & 1)
  const int g = lane >> 2;
  const int q = lane & 3;
  float* sums = reinterpret_cast<float*>(smem + 8);
  if (active && PHASES > 1) {
    float* mine = sums + ((phase * RT_N + rt) * CT * 32 + lane) * 4;
#pragma unroll
    for (int ct = 0; ct < CT; ++ct)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[ct * 128 + e] = acc[ct][e];
  }
  __syncthreads();
  if (!active || phase != 0) return;
  if (PHASES > 1) {
#pragma unroll
    for (int ct = 0; ct < CT; ++ct)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = 0.0f;
#pragma unroll
        for (int ph = 0; ph < PHASES; ++ph) {
          s += sums[((ph * RT_N + rt) * CT * 32 + lane) * 4 + ct * 128 + e];
        }
        acc[ct][e] = s;
      }
  }
  const long long pb =
      (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) *
          (gridDim.x / GROUPS) + tile_idx;
  float* out = p.partial + pb * 3 * C * N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int chunk = 2 * rt + half;
    if (chunk >= NR8) continue;
    // tap * C + channel
    const int row = (chunk % 3) * C + (group * GC8 + chunk / 3) * 8 + g;
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) {
      *reinterpret_cast<float2*>(out + row * N + 8 * ct + 2 * q) =
          make_float2(acc[ct][2 * half], acc[ct][2 * half + 1]);
    }
  }
}

// dw[n, c, k] = bf16(sum over blocks of partial[block][(k C + c) N + n]):
// 32 elements a block of ``warps`` warps (1 to kReduceWarps, about one for
// each 8 rows); warp w adds rows w, w + warps, ... in kChains interleaved
// chains (so that many loads are in flight), then the chains and the
// warps are added in a fixed order
constexpr int kReduceWarps = 32;
constexpr int kChains = 8;

__global__ void __launch_bounds__(32 * kReduceWarps)
    wgrad_t3_reduce_kernel(const float* __restrict__ partial,
                           __nv_bfloat16* __restrict__ dw, int blocks,
                           int channels, int n_out) {
  __shared__ float sums[kReduceWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int elems = 3 * channels * n_out;
  const int e = blockIdx.x * 32 + lane;
  float s[kChains] = {};
  if (e < elems) {
    const float* col = partial + e;
    int i = warp;
    for (; i + (kChains - 1) * warps < blocks; i += kChains * warps) {
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        s[k] += col[static_cast<long long>(i + k * warps) * elems];
      }
    }
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      if (i + k * warps < blocks) {
        s[k] += col[static_cast<long long>(i + k * warps) * elems];
      }
    }
  }
  float t0 = 0.0f;
#pragma unroll
  for (int k = 0; k < kChains; ++k) t0 += s[k];
  sums[warp][lane] = t0;
  __syncthreads();
  if (warp != 0 || e >= elems) return;
  float t = sums[0][lane];
  for (int w = 1; w < warps; ++w) t += sums[w][lane];
  const int n = e % n_out;
  const int r = e / n_out;
  const int k = r / channels;
  const int c = r - k * channels;
  dw[(static_cast<long long>(n) * channels + c) * 3 + k] =
      __float2bfloat16_rn(t);
}

// opts ``kernel`` in to the most shared memory once per device
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, bool* done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || device >= 64 || done[device]) return err;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  if (err == cudaSuccess) done[device] = true;
  return err;
}

template <int C, int N, int WN>
cudaError_t launch_conv(const Conv& p, int batch, int smem,
                        cudaStream_t stream) {
  static bool done[64] = {};
  cudaError_t err = opt_in(conv_t3_kernel<C, N, WN>, done);
  if (err != cudaSuccess) return err;
  if (p.tile_rows < 1 || p.tile_rows > 32 * (kWarps / WN)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((p.hw + p.tile_rows - 1) / p.tile_rows,
                  (p.frames + p.run - 1) / p.run, batch);
  conv_t3_kernel<C, N, WN><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int C, int N>
cudaError_t launch_wgrad(const Wgrad& p, int batch, int smem,
                         cudaStream_t stream) {
  static bool done[64] = {};
  cudaError_t err = opt_in(wgrad_t3_kernel<C, N>, done);
  if (err != cudaSuccess) return err;
  constexpr int groups = C / 8 < 4 ? 1 : C / 32;
  const dim3 grid(((p.hw + p.bm - 1) / p.bm) * groups,
                  (p.frames + p.run - 1) / p.run, batch);
  wgrad_t3_kernel<C, N><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

constexpr int layout(int c, int n, int wn) { return (c * 512 + n) * 16 + wn; }

}  // namespace

// x [batch, frames, hw, channels] bf16; w the conv's weight, bf16,
// [n_out, channels, 3], or with grad_input [channels, n_out, 3] (the input
// gradient: its taps transposed and reversed); y [batch, frames, hw,
// n_out] bf16; all dense and 16-byte aligned;
// (channels, n_out, wn) one of the instantiated layouts (wn warps across
// n_out); tile_rows positions a block (at most 256 / wn), run frames a
// block, stages of the ring, smem the block's dynamic shared memory
// (ops/kernels.py, motion_conv_t3_plan).  Returns the launch's error code
// (0 on success; cudaErrorInvalidValue for a layout not instantiated).
extern "C" int avsep_motion_conv_t3(const void* x, const void* w, void* y,
                                    int batch, int frames, int hw,
                                    int channels, int n_out, int wn,
                                    int tile_rows, int run, int stages,
                                    int grad_input, int smem,
                                    cudaStream_t stream) {
  if (stages < 4 || stages > kMaxStages || run < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Conv p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.frames = frames;
  p.hw = hw;
  p.tile_rows = tile_rows;
  p.run = run;
  p.stages = stages;
  p.grad_input = grad_input;
  cudaError_t err;
  switch (layout(channels, n_out, wn)) {
#define AVSEP_CONV(C, N, WN)                              \
  case layout(C, N, WN):                                  \
    err = launch_conv<C, N, WN>(p, batch, smem, stream);  \
    break;
    // the fast pathway's conv1s, forward
    AVSEP_CONV(8, 8, 1)
    AVSEP_CONV(32, 8, 1)
    AVSEP_CONV(32, 16, 1)
    AVSEP_CONV(64, 16, 1)
    AVSEP_CONV(64, 32, 1)
    AVSEP_CONV(128, 32, 2)
    AVSEP_CONV(128, 64, 2)
    AVSEP_CONV(256, 64, 4)
    // and their input gradients
    AVSEP_CONV(8, 32, 1)
    AVSEP_CONV(16, 32, 1)
    AVSEP_CONV(16, 64, 2)
    AVSEP_CONV(32, 64, 2)
    AVSEP_CONV(32, 128, 4)
    AVSEP_CONV(64, 128, 4)
    AVSEP_CONV(64, 256, 8)
#undef AVSEP_CONV
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The weight gradient: x as above, dy [batch, frames, hw, n_out] bf16,
// (channels, n_out) one of the instantiated pairs; partial float32 scratch
// of 3 x channels x n_out values for each of the (batch x ceil(frames /
// run) x ceil(hw / bm)) blocks over positions, dw [n_out, channels, 3]
// bf16; bm positions a tile (a multiple of 16).  Returns the first launch
// error (0 on success).
extern "C" int avsep_motion_conv_t3_wgrad(const void* x, const void* dy,
                                          float* partial, void* dw,
                                          int batch, int frames, int hw,
                                          int channels, int n_out, int bm,
                                          int run, int stages, int smem,
                                          cudaStream_t stream) {
  if (stages < 4 || stages > kMaxStages || run < 1 || bm < 16 || bm % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Wgrad p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.dy = static_cast<const __nv_bfloat16*>(dy);
  p.partial = partial;
  p.frames = frames;
  p.hw = hw;
  p.run = run;
  p.stages = stages;
  p.bm = bm;
  cudaError_t err;
  switch (layout(channels, n_out, 0)) {
#define AVSEP_WGRAD(C, N)                              \
  case layout(C, N, 0):                                \
    err = launch_wgrad<C, N>(p, batch, smem, stream);  \
    break;
    AVSEP_WGRAD(8, 8)
    AVSEP_WGRAD(32, 8)
    AVSEP_WGRAD(32, 16)
    AVSEP_WGRAD(64, 16)
    AVSEP_WGRAD(64, 32)
    AVSEP_WGRAD(128, 32)
    AVSEP_WGRAD(128, 64)
    AVSEP_WGRAD(256, 64)
#undef AVSEP_WGRAD
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = ((hw + bm - 1) / bm) * ((frames + run - 1) / run) * batch;
  const int elems = 3 * channels * n_out;
  const int warps = min(kReduceWarps, max(1, blocks / 8));
  wgrad_t3_reduce_kernel<<<(elems + 31) / 32, 32 * warps, 0, stream>>>(
      partial, static_cast<__nv_bfloat16*>(dw), blocks, channels, n_out);
  return static_cast<int>(cudaGetLastError());
}
