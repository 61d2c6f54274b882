// Kernel F: one whole GRU layer forward (tanh) over a precomputed
// x-projection xp = x @ W + b, emitting the h sequence.
//
// Replaces the TPU kernel midi_vae_tpu/ops/fused_train.py::_fwd_kernel,
// reached through gru_layer_train as _fwd_pallas (grid over T) and as
// _fwd_wide_pallas (the batch-tiled grid the JAX package takes at H = 512,
// where the in-kernel-projection kernels do not fit its VMEM and it computes
// xp in XLA, :2282-2288). The port does the same at the wide route: xp is one
// torch.matmul over all T * B rows, and this kernel runs only the serial
// part.
//
// Design: kernel A without the x tile. One block owns kRows = 8 batch rows
// and loops over all T steps; h for its rows lives in shared memory; thread
// j reads its three gates of xp[t] straight from global memory (neighbouring
// threads, neighbouring addresses) and adds h @ U from the L2-resident U.
// Compiled under __launch_bounds__(kWideThreads), so a block of up to 512
// threads (H <= 512) always has the registers it needs.
//
// What bounds it: the serial chain of T steps, each an L2 read of U (3 MB at
// H = 512) by each of the B/8 blocks; at B = 256 only 32 SMs work.
#include "gru_common.cuh"

namespace mvt {

__global__ void __launch_bounds__(kWideThreads) gru_layer_xp_fwd_kernel(
    const float* __restrict__ xp, const float* __restrict__ h0,
    const float* __restrict__ u, float* __restrict__ seq, int T, int B,
    int H) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;               // (H, kRows)
  float* rh_s = h_s + kRows * H;   // (H, kRows)
  const int row0 = blockIdx.x * kRows;
  load_tile(h0, h_s, row0, B, H);
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    float az[kRows], ar[kRows], ah[kRows];
    load_gates(xp + (size_t)t * B * 3 * H, row0, B, H, az, ar, ah);
    // the previous step's cell ended with a barrier, and the store below
    // only reads h_s, which the next cell writes after its first barrier
    gru_cell_recurrent<kTanh>(az, ar, ah, h_s, rh_s, u, H);
    store_tile(h_s, seq + (size_t)t * B * H, row0, B, H);
  }
}

}  // namespace mvt

extern "C" int mvt_gru_layer_xp_fwd(const float* xp, const float* h0,
                                    const float* u, float* seq, int T, int B,
                                    int H, void* stream) {
  using namespace mvt;
  if (T < 1 || B < 1 || H < 32 || H % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * kRows * 2 * H;
  cudaError_t err = fit_block(gru_layer_xp_fwd_kernel, H, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  gru_layer_xp_fwd_kernel<<<grid, H, smem, static_cast<cudaStream_t>(stream)>>>(
      xp, h0, u, seq, T, B, H);
  return (int)cudaGetLastError();
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
