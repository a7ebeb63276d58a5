// Framing + analysis window: the head of the STFT.
//
// Replaces the TPU kernel avsep_tpu/ops/pallas_kernels.py::frame_window
// (wrapper :138-172, kernel body _frame_kernel :118-135).
//
//   out[b, t, j] = padded[b, t * hop + j] * window[j]    (0 <= j < n_fft)
//
// with samples past the end of a padded row reading as zero, as the JAX
// package's zero-extended hop-block reshape does.
//
// Bound on an H100 SXM (3.35 TB/s): the kernel moves its input once and its
// output once.  On the flagship path (B = 16, 65535 samples, n_fft 1022,
// hop 256) that is 4.26 MB read and 16.74 MB written, about 6.3 us; the one
// multiply per output element is far below the f32 rate, so bytes bound it.
//
// Design: this first version is a simple coalesced kernel.  One block owns
// kFramesPerBlock consecutive frames of one batch row; the window is staged
// once per block in shared memory, and neighbouring threads read and write
// neighbouring addresses.  The TPU kernel's 8-row tiles, its DMA into VMEM
// scratch and its padding to whole tiles are TPU shapes and are not carried
// over.  TMA and vectorised stores are left for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFramesPerBlock = 4;

__global__ void frame_window_kernel(const float* __restrict__ padded,
                                    const float* __restrict__ window,
                                    float* __restrict__ out, int padded_len,
                                    int n_frames, int n_fft, int hop,
                                    int chunks_per_row) {
  extern __shared__ float win[];
  for (int j = threadIdx.x; j < n_fft; j += blockDim.x) win[j] = window[j];
  __syncthreads();

  const int b = blockIdx.x / chunks_per_row;
  const int t0 = (blockIdx.x % chunks_per_row) * kFramesPerBlock;
  const int t1 = min(t0 + kFramesPerBlock, n_frames);
  const float* row = padded + static_cast<size_t>(b) * padded_len;
  for (int t = t0; t < t1; ++t) {
    const long long start = static_cast<long long>(t) * hop;
    float* dst = out + (static_cast<size_t>(b) * n_frames + t) * n_fft;
    for (int j = threadIdx.x; j < n_fft; j += blockDim.x) {
      const long long s = start + j;
      const float x = s < padded_len ? row[s] : 0.0f;
      dst[j] = x * win[j];
    }
  }
}

}  // namespace

// padded [batch, padded_len], window [n_fft], out [batch, n_frames, n_fft],
// all float32, contiguous, on the current device.  Returns the launch's
// error code (0 on success).
extern "C" int avsep_frame_window(const float* padded, const float* window,
                                  float* out, int batch, int padded_len,
                                  int n_frames, int n_fft, int hop,
                                  cudaStream_t stream) {
  const int chunks_per_row = (n_frames + kFramesPerBlock - 1) / kFramesPerBlock;
  const int blocks = batch * chunks_per_row;
  const size_t smem = static_cast<size_t>(n_fft) * sizeof(float);
  frame_window_kernel<<<blocks, kThreads, smem, stream>>>(
      padded, window, out, padded_len, n_frames, n_fft, hop, chunks_per_row);
  return static_cast<int>(cudaGetLastError());
}
