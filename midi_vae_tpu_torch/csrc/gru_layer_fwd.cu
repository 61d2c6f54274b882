// Kernel A: one whole GRU layer forward, x @ W computed inside the kernel.
//
// Replaces the TPU kernels midi_vae_tpu/ops/fused_train.py::_fwdx_kernel
// (emits the (T, B, H) h sequence) and ::_fwdx_last_kernel (emits only the
// final h), reached through gru_layer_infer_x. One kernel covers both with
// the emit_seq flag.
//
// Design: the TPU walks time with its sequential grid and keeps W, U, b in
// VMEM. Here one block owns kRows = 8 batch rows and loops over all T steps
// itself (blocks run in parallel and share nothing, so no state crosses a
// block boundary); h for its rows lives in shared memory. W, U and b stay in
// global memory and are re-read from L2 at every step (U alone is 768 KiB
// at H = 256, above the 227 KB of shared memory a block can have). Per step
// the block computes x_t @ W, h @ U[:, :2H], a barrier, then (r*h) @ U[:, 2H:].
//
// What bounds it: the serial chain of T steps, each one an L2 read of W and
// U by every block. At B = 256 the grid is 32 blocks of H = 256 threads, so
// most SMs idle; each U element loaded feeds kRows FMAs.
//
// A bf16 build (mvt_gru_layer_fwd_bf16) runs _fwdx_kernel in a bf16 model
// (compute_dtype="bfloat16", the encoder layers of the training step): x,
// h0, W, b and U in bf16, widened as they are loaded, x @ W and h @ U summed
// in float, r * h kept in float, and the carried h and the stored sequence
// rounded to bf16 once a step (the Pallas h_s scratch and seq_ref have x's
// dtype). The velocity layer's cast_x (D < 8: x and W widened to float in
// the JAX wrapper) gives the same products, so it takes this build too.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (midi_vae_tpu_torch/ops/_build.py).
#include "gru_common.cuh"

namespace mvt {

template <int ACT, typename TV>
__global__ void gru_layer_fwd_kernel(
    const TV* __restrict__ x, const TV* __restrict__ h0,
    const TV* __restrict__ w, const TV* __restrict__ b,
    const TV* __restrict__ u, TV* __restrict__ out,
    int T, int B, int D, int H, int emit_seq) {
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;               // (D, kRows)
  float* h_s = x_s + kRows * D;    // (H, kRows)
  float* rh_s = h_s + kRows * H;   // (H, kRows)
  const int row0 = blockIdx.x * kRows;
  load_tile(h0, h_s, row0, B, H);
  for (int t = 0; t < T; ++t) {
    // x_s is free: the previous step's cell ended with a barrier
    load_tile(x + (size_t)t * B * D, x_s, row0, B, D);
    __syncthreads();
    gru_cell<ACT, kRows, TV>(x_s, D, h_s, rh_s, w, u, b, H);
    if (emit_seq) {
      store_tile(h_s, out + (size_t)t * B * H, row0, B, H);
    }
  }
  if (!emit_seq) store_tile(h_s, out, row0, B, H);
}

template <int ACT, typename TV>
cudaError_t launch(const TV* x, const TV* h0, const TV* w, const TV* b,
                   const TV* u, TV* out, int T, int B, int D, int H,
                   int emit_seq, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kRows * (D + 2 * H);
  cudaError_t err = fit_block(gru_layer_fwd_kernel<ACT, TV>, H, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kRows - 1) / kRows);
  gru_layer_fwd_kernel<ACT, TV><<<grid, H, smem, stream>>>(
      x, h0, w, b, u, out, T, B, D, H, emit_seq);
  return cudaGetLastError();
}

template <typename TV>
int run(const TV* x, const TV* h0, const TV* w, const TV* b, const TV* u,
        TV* out, int T, int B, int D, int H, int act, int emit_seq,
        void* stream) {
  if (T < 1 || B < 1 || D < 1 || H < 32 || H % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kTanh:
      return (int)launch<kTanh>(x, h0, w, b, u, out, T, B, D, H, emit_seq, s);
    case kSigmoid:
      return (int)launch<kSigmoid>(x, h0, w, b, u, out, T, B, D, H, emit_seq, s);
    case kRelu:
      return (int)launch<kRelu>(x, h0, w, b, u, out, T, B, D, H, emit_seq, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mvt

extern "C" int mvt_gru_layer_fwd(
    const float* x, const float* h0, const float* w, const float* b,
    const float* u, float* out, int T, int B, int D, int H, int act,
    int emit_seq, void* stream) {
  return mvt::run(x, h0, w, b, u, out, T, B, D, H, act, emit_seq, stream);
}

extern "C" int mvt_gru_layer_fwd_bf16(
    const mvt::bf16* x, const mvt::bf16* h0, const mvt::bf16* w,
    const mvt::bf16* b, const mvt::bf16* u, mvt::bf16* out, int T, int B,
    int D, int H, int act, int emit_seq, void* stream) {
  return mvt::run(x, h0, w, b, u, out, T, B, D, H, act, emit_seq, stream);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
