// Kernel V: the backward (BPTT) of the fused GRU encoder stacks, x @ W
// recomputed inside the kernel; the backward of kernel U.
//
// Replaces the TPU kernels midi_vae_tpu/ops/fused_train.py::_stack2_bwd_kernel
// (through _stack2_bwd_pallas, gru_stack2_train_x's backward) and
// ::_encmb_bwd_kernel (through encode_multibranch_train_bwd,
// gru_encode_multibranch_train's backward). Two entry points:
//   mvt_gru_stack2_bwd               the stack, from d_seq (T, B, H) or
//                                    d_final (B, H) of layer 2, with h01 and
//                                    h02; f32 or bf16 sequences;
//   mvt_gru_encode_multibranch_bwd   the stack from its d_final and K
//                                    branches from theirs, zero initial
//                                    states, f32.
// The TPU kernels also sum each layer's dW, db and dU over all T*B rows in
// VMEM; here that is a second pass, kernel W (grad_reduce.cu), as for
// kernel C: one f32 U of GRU(256) is 768 KiB, more than a block's 227 KB of
// shared memory, and blocks cannot share an accumulator. So per layer and
// branch V emits the gate grads da_cat = [da_z, da_r, da] (T, B, 3H) and
// r * h_{t-1} (T, B, H), f32; and dx (only where dx is not null), and the
// stack's dh01 and dh02 (stack2 only), in the operand type.
//
// Design: the grid of kernel U, (ceil(B / kRows), 1 + K). Block row 0 walks
// the stack in reverse: per step t, layer 2's cell backward
// (gru_cell_bwd.cuh) over its input h1_t (the stored h1 sequence, rounded as
// stored: _stack2_bwd_kernel :2732) and h2_{t-1}, then layer 1's over x_t and
// h1_{t-1}, with layer 2's dx added to layer 1's dh carry; both carries stay
// in registers in f32, as in kernel C. Block row k walks branch k - 1 over
// its own Tk steps from its d_final (the TPU kernel enters a short branch's
// span at grid step T - Tk). Weights come in f32 (the wrapper widens a bf16
// model's, an exact cast), with the transposes U^T and W^T that the
// transposed products read row by row; all are read from L2 at every step.
//
// What bounds it: the stack's serial chain of 2T cell backwards, each with
// 4 barriers and L2 reads of W, U and their transposes, by each block.
#include "gru_cell_bwd.cuh"

namespace mvt {

constexpr int kMaxBranches = 3;

// The stack of one launch. Pointers in void are of the operand type (float
// or __nv_bfloat16); h01, h02 may be null (zeros), d_seq or d_final may be
// null (no incoming grad), dx, dh01, dh02 may be null (not wanted).
// Mirrored by _StackBwd in ops/encoder_stack.py.
struct StackBwd {
  const void *x, *h1seq, *h2seq, *h01, *h02, *d_seq, *d_final;
  const float *w1, *b1, *u1, *u1t, *w1t, *w2, *b2, *u2, *u2t, *w2t;
  void *dx, *dh01, *dh02;
  float *da1, *rh1, *da2, *rh2;
  int T, D;
};

// One 1-layer branch (float), from a zero state; dx may be null. Mirrored
// by _BranchBwd.
struct BranchBwd {
  const float *x, *hseq, *d_final, *w, *b, *u, *ut, *wt;
  float *dx, *da, *rh;
  int T, D;
};

struct BranchesBwd {
  BranchBwd k[kMaxBranches];
};

// column j of the block's rows of a (B, H) matrix, or zeros when a is null
template <typename TA>
__device__ __forceinline__ void load_column(const TA* a, float v[kRows],
                                            int row0, int B, int H) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    v[r] = (a != nullptr && row < B) ? to_f32(a[(size_t)row * H + threadIdx.x]) : 0.0f;
  }
}

template <typename TA>
__device__ __forceinline__ void store_column(const float v[kRows], TA* a,
                                             int row0, int B, int H) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (row < B) a[(size_t)row * H + threadIdx.x] = from_f32<TA>(v[r]);
  }
}

template <typename TX>
__device__ __forceinline__ void stack_bwd(const StackBwd& s, int B, int H,
                                          float* smem) {
  const TX* x = static_cast<const TX*>(s.x);
  const TX* h1seq = static_cast<const TX*>(s.h1seq);
  const TX* h2seq = static_cast<const TX*>(s.h2seq);
  const TX* d_seq = static_cast<const TX*>(s.d_seq);
  TX* dx = static_cast<TX*>(s.dx);
  const int D = s.D;
  float* x_s = smem;                 // (D, kRows): x_t
  float* h1_s = x_s + kRows * D;     // (H, kRows): h1_t, layer 2's input
  float* hp1_s = h1_s + kRows * H;   // (H, kRows): h1_{t-1}
  float* hp2_s = hp1_s + kRows * H;  // (H, kRows): h2_{t-1}
  float* rh_s = hp2_s + kRows * H;   // (H, kRows)
  float* da_s = rh_s + kRows * H;    // (3H, kRows)
  float* dx2_s = da_s + kRows * 3 * H;  // (H, kRows): layer 2's dx
  float* dx_s = dx2_s + kRows * H;   // (D, kRows), only when dx is wanted
  const int row0 = blockIdx.x * kRows;
  const int j = threadIdx.x;
  const size_t BH = (size_t)B * H;

  float dh1[kRows], dh2[kRows];
  load_column(static_cast<const TX*>(s.d_final), dh2, row0, B, H);
#pragma unroll
  for (int r = 0; r < kRows; ++r) dh1[r] = 0.0f;
  for (int t = s.T - 1; t >= 0; --t) {
    // the tiles are free: the previous step's cells ended with barriers and
    // only da_s, rh_s and dx_s were read after them
    load_tile(x + (size_t)t * B * D, x_s, row0, B, D);
    load_tile(h1seq + t * BH, h1_s, row0, B, H);
    if (t > 0) {
      load_tile(h1seq + (t - 1) * BH, hp1_s, row0, B, H);
      load_tile(h2seq + (t - 1) * BH, hp2_s, row0, B, H);
    } else {
      load_tile_or_zero(static_cast<const TX*>(s.h01), hp1_s, row0, B, H);
      load_tile_or_zero(static_cast<const TX*>(s.h02), hp2_s, row0, B, H);
    }
    if (d_seq != nullptr) {
      float g[kRows];
      load_column(d_seq + t * BH, g, row0, B, H);
#pragma unroll
      for (int r = 0; r < kRows; ++r) dh2[r] += g[r];
    }
    __syncthreads();
    gru_cell_bwd(h1_s, H, hp2_s, dh2, da_s, rh_s, dx2_s, s.w2, s.u2, s.b2, s.u2t,
                 s.w2t, H);
    store_columns(da_s, s.da2 + t * 3 * BH, row0, B, 3 * H, 3, H);
    store_columns(rh_s, s.rh2 + t * BH, row0, B, H, 1, H);
    // thread j computed column j of layer 2's dx (D = H)
#pragma unroll
    for (int r = 0; r < kRows; ++r) dh1[r] += dx2_s[j * kRows + r];
    gru_cell_bwd(x_s, D, hp1_s, dh1, da_s, rh_s, dx != nullptr ? dx_s : nullptr,
                 s.w1, s.u1, s.b1, s.u1t, s.w1t, H);
    store_columns(da_s, s.da1 + t * 3 * BH, row0, B, 3 * H, 3, H);
    store_columns(rh_s, s.rh1 + t * BH, row0, B, H, 1, H);
    if (dx != nullptr) store_tile(dx_s, dx + (size_t)t * B * D, row0, B, D);
  }
  if (s.dh01 != nullptr) store_column(dh1, static_cast<TX*>(s.dh01), row0, B, H);
  if (s.dh02 != nullptr) store_column(dh2, static_cast<TX*>(s.dh02), row0, B, H);
}

__device__ __forceinline__ void branch_bwd(const BranchBwd& a, int B, int H,
                                           float* smem) {
  float* x_s = smem;                 // (D, kRows)
  float* hp_s = x_s + kRows * a.D;   // (H, kRows)
  float* rh_s = hp_s + kRows * H;    // (H, kRows)
  float* da_s = rh_s + kRows * H;    // (3H, kRows)
  float* dx_s = da_s + kRows * 3 * H;  // (D, kRows), only when dx is wanted
  const int row0 = blockIdx.x * kRows;
  const size_t BH = (size_t)B * H;
  float dh[kRows];
  load_column(a.d_final, dh, row0, B, H);
  for (int t = a.T - 1; t >= 0; --t) {
    load_tile(a.x + (size_t)t * B * a.D, x_s, row0, B, a.D);
    load_tile_or_zero(t > 0 ? a.hseq + (t - 1) * BH : nullptr, hp_s, row0, B, H);
    __syncthreads();
    gru_cell_bwd(x_s, a.D, hp_s, dh, da_s, rh_s, a.dx != nullptr ? dx_s : nullptr,
                 a.w, a.u, a.b, a.ut, a.wt, H);
    store_columns(da_s, a.da + t * 3 * BH, row0, B, 3 * H, 3, H);
    store_columns(rh_s, a.rh + t * BH, row0, B, H, 1, H);
    if (a.dx != nullptr) store_tile(dx_s, a.dx + (size_t)t * B * a.D, row0, B, a.D);
  }
}

template <typename TX>
__global__ void gru_encoder_stack_bwd_kernel(StackBwd stack,
                                             BranchesBwd branches, int B,
                                             int H) {
  extern __shared__ __align__(16) float smem[];
  if (blockIdx.y == 0) {
    stack_bwd<TX>(stack, B, H, smem);
  } else if constexpr (std::is_same_v<TX, float>) {
    branch_bwd(branches.k[blockIdx.y - 1], B, H, smem);
  }
}

template <typename TX>
int launch(const StackBwd* stack, const BranchBwd* branches, int n_branches,
           int B, int H, void* stream) {
  if (stack == nullptr || stack->T < 1 || stack->D < 1 || B < 1 || H < 32 ||
      H % 32 != 0 || n_branches < 0 || n_branches > kMaxBranches) {
    return (int)cudaErrorInvalidValue;
  }
  BranchesBwd all{};
  const int D = stack->D;
  size_t smem = sizeof(float) * kRows * (D + 8 * H + (stack->dx != nullptr ? D : 0));
  for (int k = 0; k < n_branches; ++k) {
    const BranchBwd& a = branches[k];
    if (a.T < 1 || a.D < 1) return (int)cudaErrorInvalidValue;
    all.k[k] = a;
    const size_t need =
        sizeof(float) * kRows * (a.D + 5 * H + (a.dx != nullptr ? a.D : 0));
    if (need > smem) smem = need;
  }
  cudaError_t err = fit_block(gru_encoder_stack_bwd_kernel<TX>, H, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows, 1 + n_branches);
  gru_encoder_stack_bwd_kernel<TX><<<grid, H, smem, static_cast<cudaStream_t>(stream)>>>(
      *stack, all, B, H);
  return (int)cudaGetLastError();
}

}  // namespace mvt

// The stack alone, with h01 and h02, emitting dh01 and dh02; is_bf16 != 0
// selects the __nv_bfloat16 build (x, the sequences, h0s, the incoming and
// outgoing grads bf16; weights float), else all float.
extern "C" int mvt_gru_stack2_bwd(const mvt::StackBwd* stack, int B, int H,
                                  int is_bf16, void* stream) {
  using namespace mvt;
  if (stack == nullptr || stack->h01 == nullptr || stack->h02 == nullptr ||
      stack->dh01 == nullptr || stack->dh02 == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  return is_bf16 ? launch<bf16>(stack, nullptr, 0, B, H, stream)
                 : launch<float>(stack, nullptr, 0, B, H, stream);
}

// The stack from its d_final and n_branches branches from theirs, float,
// every initial state zero (h01, h02, d_seq, dh01 and dh02 must be null).
extern "C" int mvt_gru_encode_multibranch_bwd(const mvt::StackBwd* stack,
                                              const mvt::BranchBwd* branches,
                                              int n_branches, int B, int H,
                                              void* stream) {
  using namespace mvt;
  if (stack == nullptr || stack->h01 != nullptr || stack->h02 != nullptr ||
      stack->d_seq != nullptr || stack->dh01 != nullptr || stack->dh02 != nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  return launch<float>(stack, branches, n_branches, B, H, stream);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
