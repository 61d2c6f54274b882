// Kernels S and S xp: one LSTM cell step; S with x @ W and h @ U included,
// S xp over a precomputed x-projection.
//
// S replaces the TPU kernel midi_vae_tpu/ops/fused_lstm.py::_lstm_full_kernel
// (:67), reached through _lstm_step_pallas (:98) from lstm_step, the
// fused_step of every LSTM decode head in training
// (make_fused_decoder_step, models/rnn.py:299-312) and of the serving heads
// that kernel M does not take (3 layers, or another output activation). Its
// backward is not a kernel in the JAX package either: lstm_step's custom VJP
// recomputes the step through the plain jnp math (_lstm_step_bwd, :168-174),
// and the port's autograd Function does the same (ops/lstm_step.py).
// S xp replaces _lstm_recurrent_kernel (:78), reached through
// _lstm_recurrent_pallas (:126) from lstm_recurrent_step (:181): the encoder
// layers with fused_train_encoder=False (models/rnn.py:184-192), over
// xp = x @ W + b that the caller computes for every step in one matmul; only
// h @ U is in the kernel, as in kernel Q's step. Its backward is the plain
// recomputation too (_lstm_recurrent_bwd, :194-200).
// Templated on the cell activation (on g and on c: tanh, sigmoid or relu).
// S has a bf16 build too (mvt_lstm_step_bf16): _lstm_full_kernel in a bf16
// model (compute_dtype="bfloat16": every LSTM head cell) takes x, h, c, W, U
// and b in bf16, computes x @ W + b, h @ U and the gates in float and stores
// h' and c' in bf16, h' from the unrounded c'; the bf16 build loads bf16 and
// stores both rounded to nearest even (lstm_common.cuh).
//
// Design: the cell of kernels L and M (lstm_common.cuh) run once: one block
// owns kRows = 8 batch rows, blockDim.x == H and thread j owns hidden column
// j of the four gates; x, h (and the new h) and c of its rows live in shared
// memory, W, U and b are read from L2. Compiled under
// __launch_bounds__(kWideThreads), so a block of up to 512 threads (H <= 512)
// always has the registers it needs.
//
// What bounds it: one launch per cell per decode step (196 a training
// forward of the default LSTM config; S xp as many with
// fused_train_encoder=False), each a single pass over W and U (S xp: U) by
// B/8 blocks: the launch and the L2 reads, not the FLOPs.
#include "lstm_common.cuh"

namespace mvt {

template <int ACT, typename TT>
__global__ void __launch_bounds__(kWideThreads) lstm_step_kernel(
    const TT* __restrict__ x, const TT* __restrict__ h,
    const TT* __restrict__ c, const TT* __restrict__ w,
    const TT* __restrict__ b, const TT* __restrict__ u,
    TT* __restrict__ h_out, TT* __restrict__ c_out, int B, int D, int H) {
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;               // (D, kRows)
  float* h_s = x_s + kRows * D;    // (H, kRows)
  float* hn_s = h_s + kRows * H;   // (H, kRows)
  float* c_s = hn_s + kRows * H;   // (H, kRows)
  const int row0 = blockIdx.x * kRows;
  load_tile(x, x_s, row0, B, D);
  load_tile(h, h_s, row0, B, H);
  load_tile(c, c_s, row0, B, H);
  __syncthreads();
  lstm_cell<ACT, kRows, TT>(x_s, D, h_s, hn_s, c_s, w, u, b, H);
  store_tile(hn_s, h_out, row0, B, H);
  store_tile(c_s, c_out, row0, B, H);
}

template <int ACT>
__global__ void __launch_bounds__(kWideThreads) lstm_step_xp_kernel(
    const float* __restrict__ xp, const float* __restrict__ h,
    const float* __restrict__ c, const float* __restrict__ u,
    float* __restrict__ h_out, float* __restrict__ c_out, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;               // (H, kRows)
  float* hn_s = h_s + kRows * H;   // (H, kRows)
  float* c_s = hn_s + kRows * H;   // (H, kRows)
  const int row0 = blockIdx.x * kRows;
  float ai[kRows], af[kRows], ag[kRows], ao[kRows];
  load_gates4(xp, row0, B, H, ai, af, ag, ao);
  load_tile(h, h_s, row0, B, H);
  load_tile(c, c_s, row0, B, H);
  __syncthreads();
  lstm_cell_recurrent<ACT>(ai, af, ag, ao, h_s, hn_s, c_s, u, H);
  store_tile(hn_s, h_out, row0, B, H);
  store_tile(c_s, c_out, row0, B, H);
}

template <int ACT, typename TT>
cudaError_t launch(const TT* x, const TT* h, const TT* c, const TT* w,
                   const TT* b, const TT* u, TT* h_out, TT* c_out, int B,
                   int D, int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kRows * (D + 3 * H);
  cudaError_t err = fit_block(lstm_step_kernel<ACT, TT>, H, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kRows - 1) / kRows);
  lstm_step_kernel<ACT, TT><<<grid, H, smem, stream>>>(x, h, c, w, b, u,
                                                       h_out, c_out, B, D, H);
  return cudaGetLastError();
}

template <typename TT>
int launch_any(const TT* x, const TT* h, const TT* c, const TT* w,
               const TT* b, const TT* u, TT* h_out, TT* c_out, int B, int D,
               int H, int act, void* stream) {
  if (B < 1 || D < 1 || H < 32 || H % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kTanh:
      return (int)launch<kTanh>(x, h, c, w, b, u, h_out, c_out, B, D, H, s);
    case kSigmoid:
      return (int)launch<kSigmoid>(x, h, c, w, b, u, h_out, c_out, B, D, H, s);
    case kRelu:
      return (int)launch<kRelu>(x, h, c, w, b, u, h_out, c_out, B, D, H, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int ACT>
cudaError_t launch_xp(const float* xp, const float* h, const float* c,
                      const float* u, float* h_out, float* c_out, int B, int H,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * kRows * 3 * H;
  cudaError_t err = fit_block(lstm_step_xp_kernel<ACT>, H, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kRows - 1) / kRows);
  lstm_step_xp_kernel<ACT><<<grid, H, smem, stream>>>(xp, h, c, u, h_out,
                                                      c_out, B, H);
  return cudaGetLastError();
}

}  // namespace mvt

extern "C" int mvt_lstm_step(const float* x, const float* h, const float* c,
                             const float* w, const float* b, const float* u,
                             float* h_out, float* c_out, int B, int D, int H,
                             int act, void* stream) {
  return mvt::launch_any(x, h, c, w, b, u, h_out, c_out, B, D, H, act, stream);
}

extern "C" int mvt_lstm_step_bf16(const mvt::bf16* x, const mvt::bf16* h,
                                  const mvt::bf16* c, const mvt::bf16* w,
                                  const mvt::bf16* b, const mvt::bf16* u,
                                  mvt::bf16* h_out, mvt::bf16* c_out, int B,
                                  int D, int H, int act, void* stream) {
  return mvt::launch_any(x, h, c, w, b, u, h_out, c_out, B, D, H, act, stream);
}

extern "C" int mvt_lstm_step_xp(const float* xp, const float* h,
                                const float* c, const float* u, float* h_out,
                                float* c_out, int B, int H, int act,
                                void* stream) {
  using namespace mvt;
  if (B < 1 || H < 32 || H % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kTanh:
      return (int)launch_xp<kTanh>(xp, h, c, u, h_out, c_out, B, H, s);
    case kSigmoid:
      return (int)launch_xp<kSigmoid>(xp, h, c, u, h_out, c_out, B, H, s);
    case kRelu:
      return (int)launch_xp<kRelu>(xp, h, c, u, h_out, c_out, B, H, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
