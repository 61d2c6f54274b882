// Kernels T and T xp: one reset-before GRU cell step, the per-step cells of
// the decode heads and of the encoder layers that the whole-layer kernels do
// not run.
//
// T replaces the TPU kernel midi_vae_tpu/ops/fused_gru.py::_gru_full_kernel
// (:54), reached through _gru_step_pallas (:95) from gru_step (:143): the
// fused_step of every GRU decode-head cell that no whole-head kernel takes
// (merge_decoder_scans, fused_train_decoder=False, and the serving heads
// kernel B does not take: 3 layers, or another output activation). It
// computes x @ W + b and h @ U in the kernel.
// T xp replaces _gru_recurrent_kernel (:71), reached through
// _gru_recurrent_pallas (:117) from gru_recurrent_step (:164): the encoder
// layers with fused_train_encoder=False, over xp = x @ W + b that the caller
// computes for every step in one matmul (models/rnn.py:163); only h @ U is in
// the kernel.
// Neither backward is a kernel in the JAX package: gru_step's and
// gru_recurrent_step's custom VJPs recompute the step through the plain jnp
// math (_gru_step_bwd :153, _gru_recurrent_bwd :174), and the port's autograd
// Functions do the same (ops/gru_step.py). Templated on the cell activation
// (tanh, sigmoid or relu).
// T has a bf16 build too (mvt_gru_step_bf16): _gru_full_kernel in a bf16
// model (compute_dtype="bfloat16", the heads of fused_train_decoder=False
// and merge_decoder_scans) takes x, h, W, U and b in bf16, computes
// x @ W + b, h @ U and the gates in float (preferred_element_type=float32)
// and stores h' in bf16; the bf16 build loads bf16 and stores h' rounded to
// nearest even (gru_common.cuh's to_f32, from_f32).
//
// Design: the cell of kernels A and B (gru_common.cuh) run once: one block
// owns kRows = 8 batch rows, blockDim.x == H and thread j owns hidden column
// j of the three gates; x, h and r * h of its rows live in shared memory, W,
// U and b are read from L2. The candidate's (r * h) @ U_h sums over every
// column of r * h, so gru_cell_recurrent completes r * h in shared memory
// behind a barrier before that product. Compiled under
// __launch_bounds__(kWideThreads), so a block of up to 512 threads (H <= 512)
// always has the registers it needs.
//
// What bounds it: one launch per cell per step (192 a training forward of
// the default config with merge_decoder_scans, 196 with
// fused_train_decoder=False), each a single pass over W and U by B/8
// blocks: the launch and the L2 reads, not the FLOPs.
#include "gru_common.cuh"

namespace mvt {

template <int ACT, typename TT>
__global__ void __launch_bounds__(kWideThreads) gru_step_kernel(
    const TT* __restrict__ x, const TT* __restrict__ h,
    const TT* __restrict__ w, const TT* __restrict__ b,
    const TT* __restrict__ u, TT* __restrict__ h_out, int B, int D,
    int H) {
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;               // (D, kRows)
  float* h_s = x_s + kRows * D;    // (H, kRows), the new h in place
  float* rh_s = h_s + kRows * H;   // (H, kRows), r * h
  const int row0 = blockIdx.x * kRows;
  load_tile(x, x_s, row0, B, D);
  load_tile(h, h_s, row0, B, H);
  __syncthreads();
  gru_cell<ACT, kRows, TT>(x_s, D, h_s, rh_s, w, u, b, H);
  store_tile(h_s, h_out, row0, B, H);
}

template <int ACT>
__global__ void __launch_bounds__(kWideThreads) gru_step_xp_kernel(
    const float* __restrict__ xp, const float* __restrict__ h,
    const float* __restrict__ u, float* __restrict__ h_out, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;               // (H, kRows), the new h in place
  float* rh_s = h_s + kRows * H;   // (H, kRows), r * h
  const int row0 = blockIdx.x * kRows;
  float az[kRows], ar[kRows], ah[kRows];
  load_gates(xp, row0, B, H, az, ar, ah);
  load_tile(h, h_s, row0, B, H);
  __syncthreads();
  gru_cell_recurrent<ACT>(az, ar, ah, h_s, rh_s, u, H);
  store_tile(h_s, h_out, row0, B, H);
}

template <int ACT, typename TT>
cudaError_t launch(const TT* x, const TT* h, const TT* w, const TT* b,
                   const TT* u, TT* h_out, int B, int D, int H,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * kRows * (D + 2 * H);
  cudaError_t err = fit_block(gru_step_kernel<ACT, TT>, H, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kRows - 1) / kRows);
  gru_step_kernel<ACT, TT><<<grid, H, smem, stream>>>(x, h, w, b, u, h_out, B,
                                                      D, H);
  return cudaGetLastError();
}

template <typename TT>
int launch_any(const TT* x, const TT* h, const TT* w, const TT* b,
               const TT* u, TT* h_out, int B, int D, int H, int act,
               void* stream) {
  if (B < 1 || D < 1 || H < 32 || H % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kTanh:
      return (int)launch<kTanh>(x, h, w, b, u, h_out, B, D, H, s);
    case kSigmoid:
      return (int)launch<kSigmoid>(x, h, w, b, u, h_out, B, D, H, s);
    case kRelu:
      return (int)launch<kRelu>(x, h, w, b, u, h_out, B, D, H, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int ACT>
cudaError_t launch_xp(const float* xp, const float* h, const float* u,
                      float* h_out, int B, int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kRows * 2 * H;
  cudaError_t err = fit_block(gru_step_xp_kernel<ACT>, H, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kRows - 1) / kRows);
  gru_step_xp_kernel<ACT><<<grid, H, smem, stream>>>(xp, h, u, h_out, B, H);
  return cudaGetLastError();
}

}  // namespace mvt

extern "C" int mvt_gru_step(const float* x, const float* h, const float* w,
                            const float* b, const float* u, float* h_out,
                            int B, int D, int H, int act, void* stream) {
  return mvt::launch_any(x, h, w, b, u, h_out, B, D, H, act, stream);
}

extern "C" int mvt_gru_step_bf16(const mvt::bf16* x, const mvt::bf16* h,
                                 const mvt::bf16* w, const mvt::bf16* b,
                                 const mvt::bf16* u, mvt::bf16* h_out, int B,
                                 int D, int H, int act, void* stream) {
  return mvt::launch_any(x, h, w, b, u, h_out, B, D, H, act, stream);
}

extern "C" int mvt_gru_step_xp(const float* xp, const float* h,
                               const float* u, float* h_out, int B, int H,
                               int act, void* stream) {
  using namespace mvt;
  if (B < 1 || H < 32 || H % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kTanh:
      return (int)launch_xp<kTanh>(xp, h, u, h_out, B, H, s);
    case kSigmoid:
      return (int)launch_xp<kSigmoid>(xp, h, u, h_out, B, H, s);
    case kRelu:
      return (int)launch_xp<kRelu>(xp, h, u, h_out, B, H, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
