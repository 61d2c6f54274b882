// Kernel C: the serial part of one GRU layer's backward (BPTT), x @ W
// recomputed inside the kernel.
//
// Replaces the TPU kernel midi_vae_tpu/ops/fused_train.py::_bwdx_kernel,
// reached through gru_layer_train_x's backward (_bwdx_pallas). The TPU kernel
// also sums dW, db and dU over all T*B rows in VMEM; here that reduction is a
// second pass, kernel W (grad_reduce.cu), as in the JAX package's own wide
// scheme (_bwd_wide_kernel + _gru_wide_weight_grads): one f32 U of GRU(256)
// is 768 KiB, more than the 227 KB of shared memory a block can have, and
// blocks cannot share an accumulator.
//
// Per reverse step t = T-1 .. 0 the block recomputes the gates from x_t and
// h_{t-1} (the forward's h sequence shifted by one step, h0 at t = 0), adds
// d_seq[t] to the carried dh for return-sequence layers (d_final seeds the
// carry for last layers), and emits
//   dx[t] (T, B, D)       skipped when dx is null (no grad wanted),
//   da_cat[t] (T, B, 3H)  the pre-activation gate grads [da_z, da_r, da],
//   rh[t] (T, B, H)       r * h_{t-1}, the dU[:, 2H:] operand of kernel W,
// and dh0 (B, H) after the last step.
//
// Design: as kernel A, one block owns kRows = 8 batch rows for the whole
// reverse loop, blockDim.x == H, thread j owns hidden column j; the carried
// dh of its column stays in registers. W, U and their transposes stay in
// global memory and are read from L2 at every step.
//
// What bounds it: the serial chain of T steps, each with 4 barriers and an L2
// read of U twice (U for the recompute, U^T for the transposed products) and
// of W twice, by each of the B/8 blocks; at B = 256 only 32 SMs work.
//
// A bf16 build (mvt_gru_layer_bwd_bf16) runs _bwdx_kernel in a bf16 model:
// x, the stored h sequence, h0, the incoming grads and the weights in bf16,
// each widened to float as it is loaded; the gate math, the dh carry and
// every product stay float (the Pallas kernel widens x and h_{t-1} and keeps
// dh in an f32 scratch); dx and dh0 are rounded to bf16 once, and the gate
// grads and r * h leave in float for kernel W.
#include "gru_cell_bwd.cuh"

namespace mvt {

template <typename TV>
__global__ void gru_layer_bwd_kernel(
    const TV* __restrict__ x, const TV* __restrict__ hseq,
    const TV* __restrict__ h0, const TV* __restrict__ d_seq,
    const TV* __restrict__ d_final, const TV* __restrict__ w,
    const TV* __restrict__ b, const TV* __restrict__ u,
    const TV* __restrict__ ut, const TV* __restrict__ wt,
    TV* __restrict__ dx, TV* __restrict__ dh0,
    float* __restrict__ dacat, float* __restrict__ rh, int T, int B, int D,
    int H) {
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                // (D, kRows)
  float* hp_s = x_s + kRows * D;    // (H, kRows)
  float* rh_s = hp_s + kRows * H;   // (H, kRows)
  float* da_s = rh_s + kRows * H;   // (3H, kRows)
  float* dx_s = da_s + kRows * 3 * H;  // (D, kRows), only when dx is wanted
  const int row0 = blockIdx.x * kRows;
  const int j = threadIdx.x;

  float dh[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    dh[r] = (d_final != nullptr && row < B) ? to_f32(d_final[(size_t)row * H + j]) : 0.0f;
  }
  for (int t = T - 1; t >= 0; --t) {
    // x_s and hp_s are free: the previous step's cell ended with a barrier
    // and only da_s, rh_s and dx_s were read after it
    load_tile(x + (size_t)t * B * D, x_s, row0, B, D);
    load_tile(t > 0 ? hseq + (size_t)(t - 1) * B * H : h0, hp_s, row0, B, H);
    if (d_seq != nullptr) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = row0 + r;
        if (row < B) dh[r] += to_f32(d_seq[((size_t)t * B + row) * H + j]);
      }
    }
    __syncthreads();
    gru_cell_bwd<kRows, TV>(x_s, D, hp_s, dh, da_s, rh_s,
                            dx != nullptr ? dx_s : nullptr, w, u, b, ut, wt, H);
    store_columns(da_s, dacat + (size_t)t * B * 3 * H, row0, B, 3 * H, 3, H);
    store_columns(rh_s, rh + (size_t)t * B * H, row0, B, H, 1, H);
    if (dx != nullptr) store_tile(dx_s, dx + (size_t)t * B * D, row0, B, D);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (row < B) dh0[(size_t)row * H + j] = from_f32<TV>(dh[r]);
  }
}

template <typename TV>
int launch(const TV* x, const TV* hseq, const TV* h0, const TV* d_seq,
           const TV* d_final, const TV* w, const TV* b, const TV* u,
           const TV* ut, const TV* wt, TV* dx, TV* dh0, float* dacat,
           float* rh, int T, int B, int D, int H, void* stream) {
  if (T < 1 || B < 1 || D < 1 || H < 32 || H % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem =
      sizeof(float) * kRows * (D + 5 * H + (dx != nullptr ? D : 0));
  cudaError_t err = fit_block(gru_layer_bwd_kernel<TV>, H, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  gru_layer_bwd_kernel<TV><<<grid, H, smem, static_cast<cudaStream_t>(stream)>>>(
      x, hseq, h0, d_seq, d_final, w, b, u, ut, wt, dx, dh0, dacat, rh, T, B,
      D, H);
  return (int)cudaGetLastError();
}

}  // namespace mvt

// d_seq (T, B, H) and d_final (B, H) may each be null (read as zeros); dx may
// be null (not computed).
extern "C" int mvt_gru_layer_bwd(
    const float* x, const float* hseq, const float* h0, const float* d_seq,
    const float* d_final, const float* w, const float* b, const float* u,
    const float* ut, const float* wt, float* dx, float* dh0, float* dacat,
    float* rh, int T, int B, int D, int H, void* stream) {
  return mvt::launch(x, hseq, h0, d_seq, d_final, w, b, u, ut, wt, dx, dh0,
                     dacat, rh, T, B, D, H, stream);
}

// the bf16 build: every operand bf16 but the gate grads and r * h (float)
extern "C" int mvt_gru_layer_bwd_bf16(
    const mvt::bf16* x, const mvt::bf16* hseq, const mvt::bf16* h0,
    const mvt::bf16* d_seq, const mvt::bf16* d_final, const mvt::bf16* w,
    const mvt::bf16* b, const mvt::bf16* u, const mvt::bf16* ut,
    const mvt::bf16* wt, mvt::bf16* dx, mvt::bf16* dh0, float* dacat,
    float* rh, int T, int B, int D, int H, void* stream) {
  return mvt::launch(x, hseq, h0, d_seq, d_final, w, b, u, ut, wt, dx, dh0,
                     dacat, rh, T, B, D, H, stream);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
