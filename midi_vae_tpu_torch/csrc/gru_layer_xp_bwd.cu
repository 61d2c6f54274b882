// Kernel G: the serial part of one GRU layer's backward (BPTT) over a
// precomputed x-projection: the gate grads, which are dL/dxp.
//
// Replaces the TPU kernels midi_vae_tpu/ops/fused_train.py::_bwd_kernel
// (_bwd_pallas, which also sums dU in VMEM) and ::_bwd_wide_kernel
// (_bwd_wide_pallas, the batch-tiled two-pass variant the JAX package takes at
// H = 512, with dU reduced afterwards in XLA by _gru_wide_weight_grads).
// Here dU is always that second pass, kernel W (grad_reduce.cu), over this
// kernel's gate grads and r * h_{t-1}, which it emits so that the second
// pass needs no recompute of r.
//
// Per reverse step t = T-1 .. 0 the block reads the gates' x-projection
// xp[t] and h_{t-1} (the forward's h sequence shifted by one step, h0 at
// t = 0), adds d_seq[t] to the carried dh for return-sequence layers
// (d_final seeds the carry for last layers), and emits
//   dacat[t] (T, B, 3H)  [da_z, da_r, da], which is dxp[t],
//   rh[t] (T, B, H)      r * h_{t-1}, the dU[:, 2H:] operand of kernel W,
// and dh0 (B, H) after the last step. dx = dxp @ W^T, dW and db are
// torch.matmul / autograd over xp = x @ W + b, outside any kernel, as in the
// JAX package.
//
// Design: kernel C (gru_layer_bwd.cu) without the x tile and the dx product:
// one block owns kRows = 8 batch rows for the whole reverse loop,
// blockDim.x == H, thread j owns hidden column j and its dh carry in
// registers. U and U^T stay in global memory and are read from L2 at every
// step. Compiled under __launch_bounds__(kWideThreads), so a block of up to
// 512 threads always has the registers it needs.
//
// What bounds it: the serial chain of T steps, each with 4 barriers and two
// L2 reads of U (U for the recompute, U^T for the transposed products) by
// each of the B/8 blocks; at B = 256 only 32 SMs work.
//
// A bf16 build (mvt_gru_layer_xp_bwd_bf16) runs _bwd_kernel (row 10, the
// path of GRU(512) in a bf16 model at B = 256): xp, the stored h sequence,
// h0, the incoming grads and U in bf16, each widened to float as it is
// loaded; the gate math, the dh carry and every product stay float. It emits
// dxp rounded to bf16 (dxp_ref in xp's dtype, :165), which autograd takes
// back through xp = x @ W + b, and dh0 rounded to bf16 (:186), and beside
// them the same gate grads unrounded in float (dacat) with r * h, from which
// kernel W sums dU: _bwd_kernel accumulates dU from the float gate grads
// (:166-167), not from the rounded dxp. The float build emits dacat alone,
// which is its dxp.
#include "gru_cell_bwd.cuh"

namespace mvt {

template <typename TV>
__global__ void __launch_bounds__(kWideThreads) gru_layer_xp_bwd_kernel(
    const TV* __restrict__ xp, const TV* __restrict__ hseq,
    const TV* __restrict__ h0, const TV* __restrict__ d_seq,
    const TV* __restrict__ d_final, const TV* __restrict__ u,
    const TV* __restrict__ ut, float* __restrict__ dacat,
    TV* __restrict__ dxp, TV* __restrict__ dh0, float* __restrict__ rh, int T,
    int B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* hp_s = smem;              // (H, kRows)
  float* rh_s = hp_s + kRows * H;  // (H, kRows)
  float* da_s = rh_s + kRows * H;  // (3H, kRows)
  const int row0 = blockIdx.x * kRows;
  const int j = threadIdx.x;

  float dh[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    dh[r] = (d_final != nullptr && row < B) ? to_f32(d_final[(size_t)row * H + j]) : 0.0f;
  }
  for (int t = T - 1; t >= 0; --t) {
    // hp_s is free: the previous step's cell ended with a barrier and only
    // da_s and rh_s were read after it
    load_tile(t > 0 ? hseq + (size_t)(t - 1) * B * H : h0, hp_s, row0, B, H);
    if (d_seq != nullptr) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = row0 + r;
        if (row < B) dh[r] += to_f32(d_seq[((size_t)t * B + row) * H + j]);
      }
    }
    float az[kRows], ar[kRows], ah[kRows];
    load_gates(xp + (size_t)t * B * 3 * H, row0, B, H, az, ar, ah);
    __syncthreads();
    gru_cell_bwd_recurrent<kRows, TV>(az, ar, ah, hp_s, dh, da_s, rh_s, nullptr,
                                      u, ut, nullptr, 0, H);
    store_columns(da_s, dacat + (size_t)t * B * 3 * H, row0, B, 3 * H, 3, H);
    if constexpr (!std::is_same_v<TV, float>) {
      store_columns(da_s, dxp + (size_t)t * B * 3 * H, row0, B, 3 * H, 3, H);
    }
    store_columns(rh_s, rh + (size_t)t * B * H, row0, B, H, 1, H);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (row < B) dh0[(size_t)row * H + j] = from_f32<TV>(dh[r]);
  }
}

template <typename TV>
int launch(const TV* xp, const TV* hseq, const TV* h0, const TV* d_seq,
           const TV* d_final, const TV* u, const TV* ut, float* dacat, TV* dxp,
           TV* dh0, float* rh, int T, int B, int H, void* stream) {
  if (T < 1 || B < 1 || H < 32 || H % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * kRows * 5 * H;
  cudaError_t err = fit_block(gru_layer_xp_bwd_kernel<TV>, H, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  gru_layer_xp_bwd_kernel<TV><<<grid, H, smem, static_cast<cudaStream_t>(stream)>>>(
      xp, hseq, h0, d_seq, d_final, u, ut, dacat, dxp, dh0, rh, T, B, H);
  return (int)cudaGetLastError();
}

}  // namespace mvt

// d_seq (T, B, H) and d_final (B, H) may each be null (read as zeros); the
// float build has no dxp (dacat is its dxp).
extern "C" int mvt_gru_layer_xp_bwd(
    const float* xp, const float* hseq, const float* h0, const float* d_seq,
    const float* d_final, const float* u, const float* ut, float* dacat,
    float* dh0, float* rh, int T, int B, int H, void* stream) {
  return mvt::launch(xp, hseq, h0, d_seq, d_final, u, ut, dacat,
                     static_cast<float*>(nullptr), dh0, rh, T, B, H, stream);
}

// the bf16 build: every operand bf16 but the gate grads dacat and r * h
// (float); dxp (bf16) receives the rounded gate grads
extern "C" int mvt_gru_layer_xp_bwd_bf16(
    const mvt::bf16* xp, const mvt::bf16* hseq, const mvt::bf16* h0,
    const mvt::bf16* d_seq, const mvt::bf16* d_final, const mvt::bf16* u,
    const mvt::bf16* ut, float* dacat, mvt::bf16* dxp, mvt::bf16* dh0,
    float* rh, int T, int B, int H, void* stream) {
  return mvt::launch(xp, hseq, h0, d_seq, d_final, u, ut, dacat, dxp, dh0, rh,
                     T, B, H, stream);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
