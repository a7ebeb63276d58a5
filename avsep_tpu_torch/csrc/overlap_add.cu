// Overlap-add + window-square normalization (+ optional clip): the tail of
// the iSTFT.
//
// Replaces the TPU kernel
// avsep_tpu/ops/pallas_kernels.py::overlap_add_normalize (wrapper :71-112,
// kernel body _ola_kernel :46-68).
//
//   out[r, s] = clip?( (sum over m = 0 .. K-1, ascending, of
//                        frames[r, s / hop - m, m * hop + s % hop]) / denom[s] )
//
// over the terms whose frame index lies in [0, n_frames) and whose column
// lies in [0, n_fft), with K = ceil(n_fft / hop).  The sum starts from zero
// and adds in ascending m, the order of avsep_tpu/ops/stft.py:163-164, so
// the result is the plain version's to the bit.  No atomics: every output
// sample is owned by one thread, and the result is deterministic.
//
// Bound on an H100 SXM (3.35 TB/s): on the flagship path (16 clips x 2
// sources = 32 rows of 256 frames x 1022, out_len 66302) the kernel reads
// 33.49 MB of frames and writes 8.49 MB, about 12.5 us; at most 4 adds and
// one divide per output sample, so bytes bound it.
//
// Design: this first version is a simple coalesced kernel, one thread per
// output sample.  Threads of a warp cover consecutive samples of one
// hop-block, so each of the K reads is a contiguous run of one frame row.
// The TPU kernel's K-1 zero frames of front padding, its 8-row tiles and its
// DMA into VMEM scratch are TPU shapes and are not carried over.  TMA and
// vectorised stores are left for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void overlap_add_kernel(const float* __restrict__ frames,
                                   const float* __restrict__ denom,
                                   float* __restrict__ out, long long total,
                                   int n_frames, int n_fft, int hop,
                                   int out_len, int clip) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= total) return;
  const long long r = i / out_len;
  const int s = static_cast<int>(i - r * out_len);
  const int blk = s / hop;
  const int off = s - blk * hop;
  const int K = (n_fft + hop - 1) / hop;
  const float* base = frames + r * n_frames * static_cast<long long>(n_fft);

  float acc = 0.0f;
  for (int m = 0; m < K; ++m) {
    const int t = blk - m;
    const int j = m * hop + off;
    if (t >= 0 && t < n_frames && j < n_fft) {
      acc += base[static_cast<long long>(t) * n_fft + j];
    }
  }
  float y = acc / denom[s];
  if (clip) y = fminf(fmaxf(y, -1.0f), 1.0f);
  out[i] = y;
}

}  // namespace

// frames [rows, n_frames, n_fft], denom [>= out_len], out [rows, out_len],
// all float32, contiguous, on the current device.  Returns the launch's
// error code (0 on success).
extern "C" int avsep_overlap_add_normalize(const float* frames,
                                           const float* denom, float* out,
                                           int rows, int n_frames, int n_fft,
                                           int hop, int out_len, int clip,
                                           cudaStream_t stream) {
  const long long total = static_cast<long long>(rows) * out_len;
  const long long blocks = (total + kThreads - 1) / kThreads;
  overlap_add_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      frames, denom, out, total, n_frames, n_fft, hop, out_len, clip);
  return static_cast<int>(cudaGetLastError());
}
