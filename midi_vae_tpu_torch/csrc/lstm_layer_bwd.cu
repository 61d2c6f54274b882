// Kernel N: the serial part of one LSTM layer's backward (BPTT), x @ W
// recomputed inside the kernel.
//
// Replaces the TPU kernel midi_vae_tpu/ops/fused_train.py::_lstm_bwdx_kernel
// (:2405), reached through lstm_layer_train_x's backward (_lstm_bwdx_pallas
// :2472). The TPU kernel also sums dW, db and dU over all T*B rows in VMEM;
// here that reduction is a second pass, kernel W (grad_reduce.cu), as in the
// JAX package's own wide scheme (_lstm_bwd_wide_kernel +
// _lstm_wide_weight_grads): one f32 LSTM U is 1 MiB at H = 256, more than
// the 227 KB of shared memory a block can have, and blocks cannot share an
// accumulator. The LSTM twin of kernel C (gru_layer_bwd.cu).
//
// Per reverse step t = T-1 .. 0 the block recomputes the gates from x_t and
// h_{t-1} (the forward's h sequence shifted by one step, h0 at t = 0), reads
// c_t and c_{t-1} (c0 at t = 0) from the forward's c sequence (kernel L's
// residual), adds d_seq[t] to the carried dh for return-sequence layers
// (d_final seeds the carry for last layers; dc starts at zero), and emits
//   dx[t] (T, B, D)       = da @ W^T, skipped when dx is null,
//   dacat[t] (T, B, 4H)   the pre-activation gate grads [di, df, dg, do],
// and dh0, dc0 (B, H) after the last step (lstm_cell_bwd.cuh has the math).
//
// Design: as kernel L, one block owns kRows = 8 batch rows for the whole
// reverse loop, blockDim.x == H, thread j owns hidden column j of the four
// gates; its dh and dc carries stay in registers. Shared memory holds x_t
// (D, 8), h_{t-1} (H, 8) and the gate grads (4H, 8). W, U and their
// transposes stay in global memory and are read from L2 at every step. Two
// barriers a step: one after the tiles load, one inside the cell step.
//
// What bounds it: the serial chain of T steps, each an L2 read of W and U
// for the recompute and of U^T and W^T for the transposed products, by each
// of the B/8 blocks; at B = 256 only 32 SMs work.
//
// A bf16 build (mvt_lstm_layer_bwd_bf16) runs _lstm_bwdx_kernel in a bf16
// model (row 20 in bf16): x, the stored h and c sequences, h0, c0, the
// incoming grads and the weights in bf16, each widened to float as it is
// loaded; the gate recompute, the dh and dc carries and every product stay
// float (the Pallas kernel widens x, h_{t-1}, c_{t-1} and c_t and keeps dh
// and dc in f32 scratch, :2525-2526); dx = da @ W^T, dh0 and dc0 are rounded
// to bf16 once (:2491-2493), and the gate grads leave unrounded in float, the
// values from which the Pallas kernel sums dW, db and dU (:2458-2460) and
// from which kernel W sums them here.
#include "lstm_cell_bwd.cuh"

namespace mvt {

template <typename TV>
__global__ void lstm_layer_bwd_kernel(
    const TV* __restrict__ x, const TV* __restrict__ hseq,
    const TV* __restrict__ cseq, const TV* __restrict__ h0,
    const TV* __restrict__ c0, const TV* __restrict__ d_seq,
    const TV* __restrict__ d_final, const TV* __restrict__ w,
    const TV* __restrict__ b, const TV* __restrict__ u,
    const TV* __restrict__ ut, const TV* __restrict__ wt,
    TV* __restrict__ dx, TV* __restrict__ dh0, TV* __restrict__ dc0,
    float* __restrict__ dacat, int T, int B, int D, int H) {
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                // (D, kRows)
  float* hp_s = x_s + kRows * D;    // (H, kRows)
  float* da_s = hp_s + kRows * H;   // (4H, kRows)
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
    // x_s and hp_s are free: the previous step read them only before the
    // barrier inside its cell step
    load_tile(x + (size_t)t * B * D, x_s, row0, B, D);
    load_tile(t > 0 ? hseq + (size_t)(t - 1) * B * H : h0, hp_s, row0, B, H);
    if (d_seq != nullptr) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = row0 + r;
        if (row < B) dh[r] += to_f32(d_seq[((size_t)t * B + row) * H + j]);
      }
    }
    // also orders the previous step's reads of da_s before this step's writes
    __syncthreads();
    float ai[kRows], af[kRows], ag[kRows], ao[kRows];
    lstm_x_gates<kRows, TV>(x_s, D, w, b, H, ai, af, ag, ao);
    lstm_cell_bwd_recurrent<kRows, TV>(ai, af, ag, ao, hp_s,
                            t > 0 ? cseq + (size_t)(t - 1) * B * H : c0,
                            cseq + (size_t)t * B * H, row0, B, dh, dc, da_s, u,
                            ut, H);
    store_columns(da_s, dacat + (size_t)t * B * G, row0, B, G, 4, H);
    if (dx != nullptr) {
      float v[kRows];
      for (int d = j; d < D; d += blockDim.x) {
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
        for (int g = 0; g < G; ++g) {
          const float wv = to_f32(wt[(size_t)g * D + d]);
          load_rows(da_s + g * kRows, v);
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r] = fmaf(v[r], wv, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int row = row0 + r;
          if (row < B) dx[((size_t)t * B + row) * D + d] = from_f32<TV>(acc[r]);
        }
      }
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
int launch(const TV* x, const TV* hseq, const TV* cseq, const TV* h0,
           const TV* c0, const TV* d_seq, const TV* d_final, const TV* w,
           const TV* b, const TV* u, const TV* ut, const TV* wt, TV* dx,
           TV* dh0, TV* dc0, float* dacat, int T, int B, int D, int H,
           void* stream) {
  if (T < 1 || B < 1 || D < 1 || H < 32 || H % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * kRows * (D + 5 * H);
  cudaError_t err = fit_block(lstm_layer_bwd_kernel<TV>, H, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  lstm_layer_bwd_kernel<TV><<<grid, H, smem, static_cast<cudaStream_t>(stream)>>>(
      x, hseq, cseq, h0, c0, d_seq, d_final, w, b, u, ut, wt, dx, dh0, dc0,
      dacat, T, B, D, H);
  return (int)cudaGetLastError();
}

}  // namespace mvt

// d_seq (T, B, H) and d_final (B, H) may each be null (read as zeros); dx may
// be null (not computed). ut = U^T (4H, H) and wt = W^T (4H, D), contiguous.
extern "C" int mvt_lstm_layer_bwd(
    const float* x, const float* hseq, const float* cseq, const float* h0,
    const float* c0, const float* d_seq, const float* d_final, const float* w,
    const float* b, const float* u, const float* ut, const float* wt,
    float* dx, float* dh0, float* dc0, float* dacat, int T, int B, int D,
    int H, void* stream) {
  return mvt::launch(x, hseq, cseq, h0, c0, d_seq, d_final, w, b, u, ut, wt,
                     dx, dh0, dc0, dacat, T, B, D, H, stream);
}

// the bf16 build: every operand bf16 but the gate grads dacat (float)
extern "C" int mvt_lstm_layer_bwd_bf16(
    const mvt::bf16* x, const mvt::bf16* hseq, const mvt::bf16* cseq,
    const mvt::bf16* h0, const mvt::bf16* c0, const mvt::bf16* d_seq,
    const mvt::bf16* d_final, const mvt::bf16* w, const mvt::bf16* b,
    const mvt::bf16* u, const mvt::bf16* ut, const mvt::bf16* wt,
    mvt::bf16* dx, mvt::bf16* dh0, mvt::bf16* dc0, float* dacat, int T,
    int B, int D, int H, void* stream) {
  return mvt::launch(x, hseq, cseq, h0, c0, d_seq, d_final, w, b, u, ut, wt,
                     dx, dh0, dc0, dacat, T, B, D, H, stream);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
