// Kernel R: the serial part of one LSTM layer's backward (BPTT) over a
// precomputed x-projection: the gate grads, which are dL/dxp.
//
// Replaces the TPU kernels midi_vae_tpu/ops/fused_train.py::_lstm_bwd_kernel
// (:1383, through _lstm_bwd_pallas :1448, which also sums dU in VMEM) and
// ::_lstm_bwd_wide_kernel (:1922, through _lstm_bwd_wide_pallas :1984, the
// batch-tiled two-pass variant with dU reduced afterwards in XLA by
// _lstm_wide_weight_grads :2032). Here dU = h_{t-1}^T . da is always that
// second pass, kernel W (grad_reduce.cu), over this kernel's gate grads. The
// LSTM twin of kernel G (gru_layer_xp_bwd.cu).
//
// Per reverse step t = T-1 .. 0 the block reads the gates' x-projection
// xp[t], h_{t-1} (the forward's h sequence shifted by one step, h0 at t = 0)
// and c_t, c_{t-1} (c0 at t = 0) from kernel Q's c sequence, adds d_seq[t] to
// the carried dh for return-sequence layers (d_final seeds the carry for
// last layers; dc starts at zero), and emits dacat[t] (T, B, 4H) = [di, df,
// dg, do], which is dxp[t], and dh0, dc0 (B, H) after the last step. dx = dxp
// @ W^T, dW and db are torch.matmul / autograd over xp = x @ W + b, outside
// any kernel, as in the JAX package.
//
// Design: kernel N (lstm_layer_bwd.cu) without the x tile and the dx
// product: one block owns kRows = 8 batch rows for the whole reverse loop,
// blockDim.x == H, thread j owns hidden column j of the four gates and its
// dh and dc carries in registers; shared memory holds h_{t-1} (H, 8) and the
// gate grads (4H, 8): 80 KiB at H = 512. U and U^T stay in global memory and
// are read from L2 at every step. Compiled under
// __launch_bounds__(kWideThreads), so a block of up to 512 threads always has
// the registers it needs.
//
// What bounds it: the serial chain of T steps, each with two L2 reads of U
// (U for the recompute, U^T for dh) by each of the B/8 blocks; at B = 256
// only 32 SMs work.
//
// A bf16 build (mvt_lstm_layer_xp_bwd_bf16) runs _lstm_bwd_wide_kernel and
// _lstm_bwd_kernel in a bf16 model (rows 18 and 16 in bf16): xp, the stored
// h and c sequences, h0, c0, the incoming grads and U in bf16, each widened
// to float as it is loaded; the gate recompute, the dh and dc carries and
// every product stay float. It emits dxp rounded to bf16 (dacat_ref and
// dxp_ref in xp's dtype, :2000, :1435) with dh0 and dc0 rounded, and, where
// dacat is not null, the same gate grads unrounded in float. Row 18 sums dU
// from the rounded stream (_lstm_wide_weight_grads :2032-2043, after the
// kernel), so kernel W reads dxp there; row 16 sums dU inside the kernel
// from the unrounded da (:1436), so kernel W reads dacat there. The float
// build emits dacat alone, which is its dxp.
#include "lstm_cell_bwd.cuh"

namespace mvt {

template <typename TV>
__global__ void __launch_bounds__(kWideThreads) lstm_layer_xp_bwd_kernel(
    const TV* __restrict__ xp, const TV* __restrict__ hseq,
    const TV* __restrict__ cseq, const TV* __restrict__ h0,
    const TV* __restrict__ c0, const TV* __restrict__ d_seq,
    const TV* __restrict__ d_final, const TV* __restrict__ u,
    const TV* __restrict__ ut, float* __restrict__ dacat,
    TV* __restrict__ dxp, TV* __restrict__ dh0, TV* __restrict__ dc0, int T,
    int B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* hp_s = smem;              // (H, kRows)
  float* da_s = hp_s + kRows * H;  // (4H, kRows)
  const int row0 = blockIdx.x * kRows;
  const int j = threadIdx.x;
  const int G = 4 * H;

  float dh[kRows], dc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    dh[r] = (d_final != nullptr && row < B) ? to_f32(d_final[(size_t)row * H + j]) : 0.0f;
    dc[r] = 0.0f;
  }
  for (int t = T - 1; t >= 0; --t) {
    // hp_s is free: the previous step read it only before the barrier
    // inside its cell step
    load_tile(t > 0 ? hseq + (size_t)(t - 1) * B * H : h0, hp_s, row0, B, H);
    if (d_seq != nullptr) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = row0 + r;
        if (row < B) dh[r] += to_f32(d_seq[((size_t)t * B + row) * H + j]);
      }
    }
    float ai[kRows], af[kRows], ag[kRows], ao[kRows];
    load_gates4(xp + (size_t)t * B * G, row0, B, H, ai, af, ag, ao);
    // also orders the previous step's reads of da_s before this step's writes
    __syncthreads();
    lstm_cell_bwd_recurrent<kRows, TV>(ai, af, ag, ao, hp_s,
                            t > 0 ? cseq + (size_t)(t - 1) * B * H : c0,
                            cseq + (size_t)t * B * H, row0, B, dh, dc, da_s, u,
                            ut, H);
    if (std::is_same_v<TV, float> || dacat != nullptr) {
      store_columns(da_s, dacat + (size_t)t * B * G, row0, B, G, 4, H);
    }
    if constexpr (!std::is_same_v<TV, float>) {
      store_columns(da_s, dxp + (size_t)t * B * G, row0, B, G, 4, H);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (row < B) {
      dh0[(size_t)row * H + j] = from_f32<TV>(dh[r]);
      dc0[(size_t)row * H + j] = from_f32<TV>(dc[r]);
    }
  }
}

template <typename TV>
int launch(const TV* xp, const TV* hseq, const TV* cseq, const TV* h0,
           const TV* c0, const TV* d_seq, const TV* d_final, const TV* u,
           const TV* ut, float* dacat, TV* dxp, TV* dh0, TV* dc0, int T, int B,
           int H, void* stream) {
  if (T < 1 || B < 1 || H < 32 || H % 32 != 0 ||
      (dacat == nullptr && dxp == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * kRows * 5 * H;
  cudaError_t err = fit_block(lstm_layer_xp_bwd_kernel<TV>, H, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  lstm_layer_xp_bwd_kernel<TV><<<grid, H, smem, static_cast<cudaStream_t>(stream)>>>(
      xp, hseq, cseq, h0, c0, d_seq, d_final, u, ut, dacat, dxp, dh0, dc0, T,
      B, H);
  return (int)cudaGetLastError();
}

}  // namespace mvt

// d_seq (T, B, H) and d_final (B, H) may each be null (read as zeros).
// ut = U^T (4H, H), contiguous. The float build has no dxp (dacat is its
// dxp).
extern "C" int mvt_lstm_layer_xp_bwd(
    const float* xp, const float* hseq, const float* cseq, const float* h0,
    const float* c0, const float* d_seq, const float* d_final, const float* u,
    const float* ut, float* dacat, float* dh0, float* dc0, int T, int B, int H,
    void* stream) {
  return mvt::launch(xp, hseq, cseq, h0, c0, d_seq, d_final, u, ut, dacat,
                     static_cast<float*>(nullptr), dh0, dc0, T, B, H, stream);
}

// the bf16 build: every operand bf16; dxp (bf16) receives the rounded gate
// grads, dacat (float, may be null) the same gate grads unrounded
extern "C" int mvt_lstm_layer_xp_bwd_bf16(
    const mvt::bf16* xp, const mvt::bf16* hseq, const mvt::bf16* cseq,
    const mvt::bf16* h0, const mvt::bf16* c0, const mvt::bf16* d_seq,
    const mvt::bf16* d_final, const mvt::bf16* u, const mvt::bf16* ut,
    float* dacat, mvt::bf16* dxp, mvt::bf16* dh0, mvt::bf16* dc0, int T,
    int B, int H, void* stream) {
  return mvt::launch(xp, hseq, cseq, h0, c0, d_seq, d_final, u, ut, dacat,
                     dxp, dh0, dc0, T, B, H, stream);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
