// Kernel Q: one whole LSTM layer forward (tanh) over a precomputed
// x-projection xp = x @ W + b, emitting the h and c sequences.
//
// Replaces the TPU kernel midi_vae_tpu/ops/fused_train.py::_lstm_fwd_kernel
// (:1331), reached through lstm_layer_train as _lstm_fwd_pallas (:1352, grid
// over T) and as _lstm_fwd_wide_pallas (:1890, the batch-tiled grid), which
// the JAX package takes where the in-kernel-projection kernels are switched
// off (_lstm_layer_fallback_x, :2559-2565). The port takes it on the wide
// route (ops/_layout.py, LSTM above H = 256): xp is one torch.matmul over all
// T * B rows, and this kernel runs only the serial part. The c sequence is
// the backward's residual (kernel R, lstm_layer_xp_bwd.cu). The LSTM twin of
// kernel F (gru_layer_xp_fwd.cu).
//
// Design: kernel L without the x tile. One block owns kRows = 8 batch rows
// and loops over all T steps; h (double-buffered) and c for its rows live in
// shared memory; thread j reads its four gates of xp[t] straight from global
// memory (neighbouring threads, neighbouring addresses), adds h @ U from the
// L2-resident U, and stores its own c column (lstm_common.cuh). Compiled
// under __launch_bounds__(kWideThreads), so a block of up to 512 threads
// (H <= 512) always has the registers it needs.
//
// What bounds it: the serial chain of T steps, each an L2 read of U (4 MiB at
// H = 512) by each of the B/8 blocks; at B = 256 only 32 SMs work.
//
// A bf16 build (mvt_lstm_layer_xp_fwd_bf16) runs _lstm_fwd_kernel in a bf16
// model (rows 15 and 17 in bf16, LSTM(512)'s layers at B = 256 through
// _lstm_fwd_wide_pallas): xp (which XLA has already rounded to bf16), h0, c0
// and U in bf16, each widened to float as it is loaded, so h @ U is bf16
// products summed in float and the gates are float (_lstm_gates'
// preferred_element_type); h' comes from the unrounded c', and h and c are
// rounded to bf16 where the Pallas kernel carries them in its bf16 scratch
// (:1915-1916) and stores both sequences.
#include "lstm_common.cuh"

namespace mvt {

template <typename TV>
__global__ void __launch_bounds__(kWideThreads) lstm_layer_xp_fwd_kernel(
    const TV* __restrict__ xp, const TV* __restrict__ h0,
    const TV* __restrict__ c0, const TV* __restrict__ u,
    TV* __restrict__ hseq, TV* __restrict__ cseq, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;               // (H, kRows), h_{t-1}
  float* hn_s = h_s + kRows * H;   // (H, kRows), h_t
  float* c_s = hn_s + kRows * H;   // (H, kRows)
  const int row0 = blockIdx.x * kRows;
  load_tile(h0, h_s, row0, B, H);
  load_tile(c0, c_s, row0, B, H);
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    float ai[kRows], af[kRows], ag[kRows], ao[kRows];
    load_gates4(xp + (size_t)t * B * 4 * H, row0, B, H, ai, af, ag, ao);
    // the previous step's cell ended with a barrier; its h_t (now h_s) is
    // only read from here on, and this cell writes the other buffer
    lstm_cell_recurrent<kTanh, kRows, TV, TV>(ai, af, ag, ao, h_s, hn_s, c_s,
                                              u, H);
    float* done = hn_s;
    hn_s = h_s;
    h_s = done;
    store_tile(h_s, hseq + (size_t)t * B * H, row0, B, H);
    // thread j stores the c column it wrote itself: no barrier needed
    store_columns(c_s, cseq + (size_t)t * B * H, row0, B, H, 1, H);
  }
}

template <typename TV>
int launch(const TV* xp, const TV* h0, const TV* c0, const TV* u, TV* hseq,
           TV* cseq, int T, int B, int H, void* stream) {
  if (T < 1 || B < 1 || H < 32 || H % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * kRows * 3 * H;
  cudaError_t err = fit_block(lstm_layer_xp_fwd_kernel<TV>, H, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  lstm_layer_xp_fwd_kernel<TV><<<grid, H, smem, static_cast<cudaStream_t>(stream)>>>(
      xp, h0, c0, u, hseq, cseq, T, B, H);
  return (int)cudaGetLastError();
}

}  // namespace mvt

extern "C" int mvt_lstm_layer_xp_fwd(const float* xp, const float* h0,
                                     const float* c0, const float* u,
                                     float* hseq, float* cseq, int T, int B,
                                     int H, void* stream) {
  return mvt::launch(xp, h0, c0, u, hseq, cseq, T, B, H, stream);
}

// the bf16 build: every operand and output bf16
extern "C" int mvt_lstm_layer_xp_fwd_bf16(const mvt::bf16* xp,
                                          const mvt::bf16* h0,
                                          const mvt::bf16* c0,
                                          const mvt::bf16* u, mvt::bf16* hseq,
                                          mvt::bf16* cseq, int T, int B, int H,
                                          void* stream) {
  return mvt::launch(xp, h0, c0, u, hseq, cseq, T, B, H, stream);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
