// Kernel U: the forward of the fused GRU encoder stacks, the 2-layer
// reset-before GRU stack with x @ W inside the kernel and, beside it, up to
// kMaxBranches independent 1-layer branches.
//
// Replaces the TPU kernels midi_vae_tpu/ops/fused_train.py::_stack2_fwd_kernel
// (through _stack2_fwd_pallas, reached from gru_stack2_train_x) and
// ::_encmb_fwd_kernel (through encode_multibranch_train_fwd, reached from
// gru_encode_multibranch_train). Two entry points:
//   mvt_gru_stack2_fwd               the stack from given h01 and h02, f32
//                                    or bf16 (the JAX op runs bf16 where
//                                    D >= 8);
//   mvt_gru_encode_multibranch_fwd   the stack and K branches, every initial
//                                    state zero, f32 only.
// Both emit the h sequences the backward (kernel V) needs: h1 and h2 of the
// stack, hk of each branch, (T, B, H) time-major.
//
// Design: the TPU walks time with its sequential grid, and the branches'
// steps run one after another inside each grid step. Here the grid is
// (ceil(B / kRows), 1 + K): block row y = 0 runs the stack for its kRows
// batch rows over all T steps; block row y = k runs branch k - 1's layer
// over its own Tk steps, beside the stack. Per step of the stack, layer 1's
// cell (gru_common.cuh) leaves its h in shared memory in float, layer 2's
// cell reads that tile as its input, and only then is h1 rounded to the
// operand type for the carry and the h1 sequence (the Pallas kernel feeds
// layer 2 the f32 h1 of the same step and stores it rounded:
// _stack2_fwd_kernel :2659-2668). Nothing crosses global memory between the
// layers. W, U and b stay in global memory and are read from L2 at every
// step, as kernel A reads them (one f32 U of GRU(256) is 768 KiB).
//
// What bounds it: the stack's serial chain of 2T cells, each an L2 read of
// W and U by every block; the branches are shorter chains (a velocity
// branch has T steps of one layer) and overlap it. At B = 256 the grid is
// 32 x (1 + K) blocks of H threads.
#include "gru_common.cuh"

namespace mvt {

constexpr int kMaxBranches = 3;

// The stack of one launch. h01 and h02 may be null (zeros). Pointers of the
// operand type (float or __nv_bfloat16). Mirrored by _StackFwd in
// ops/encoder_stack.py.
struct StackFwd {
  const void *x, *h01, *h02, *w1, *b1, *u1, *w2, *b2, *u2;
  void *h1seq, *h2seq;
  int T, D;
};

// One 1-layer branch (float), from a zero state. Mirrored by _BranchFwd.
struct BranchFwd {
  const float *x, *w, *b, *u;
  float* hseq;
  int T, D;
};

struct BranchesFwd {
  BranchFwd k[kMaxBranches];
};

template <typename TX>
__device__ __forceinline__ void stack_fwd(const StackFwd& s, int B, int H,
                                          float* smem) {
  const TX* x = static_cast<const TX*>(s.x);
  const TX *w1 = static_cast<const TX*>(s.w1), *b1 = static_cast<const TX*>(s.b1),
           *u1 = static_cast<const TX*>(s.u1), *w2 = static_cast<const TX*>(s.w2),
           *b2 = static_cast<const TX*>(s.b2), *u2 = static_cast<const TX*>(s.u2);
  TX* h1seq = static_cast<TX*>(s.h1seq);
  TX* h2seq = static_cast<TX*>(s.h2seq);
  const int D = s.D;
  float* x_s = smem;               // (D, kRows)
  float* h1_s = x_s + kRows * D;   // (H, kRows)
  float* h2_s = h1_s + kRows * H;  // (H, kRows)
  float* rh_s = h2_s + kRows * H;  // (H, kRows)
  const int row0 = blockIdx.x * kRows;
  const int j = threadIdx.x;
  load_tile_or_zero(static_cast<const TX*>(s.h01), h1_s, row0, B, H);
  load_tile_or_zero(static_cast<const TX*>(s.h02), h2_s, row0, B, H);
  for (int t = 0; t < s.T; ++t) {
    // x_s is free, and every thread has rounded its column of h1_s: the
    // previous step's cells ended with barriers, then this one
    load_tile(x + (size_t)t * B * D, x_s, row0, B, D);
    __syncthreads();
    gru_cell<kTanh, kRows, TX, float>(x_s, D, h1_s, rh_s, w1, u1, b1, H);
    gru_cell<kTanh, kRows, TX, TX>(h1_s, H, h2_s, rh_s, w2, u2, b2, H);
    // thread j rounds and stores column j of both layers (it wrote them)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float h1 = round_as<TX>(h1_s[j * kRows + r]);
      h1_s[j * kRows + r] = h1;
      const int row = row0 + r;
      if (row < B) {
        const size_t at = ((size_t)t * B + row) * H + j;
        h1seq[at] = from_f32<TX>(h1);
        h2seq[at] = from_f32<TX>(h2_s[j * kRows + r]);
      }
    }
  }
}

__device__ __forceinline__ void branch_fwd(const BranchFwd& a, int B, int H,
                                           float* smem) {
  float* x_s = smem;               // (D, kRows)
  float* h_s = x_s + kRows * a.D;  // (H, kRows)
  float* rh_s = h_s + kRows * H;   // (H, kRows)
  const int row0 = blockIdx.x * kRows;
  load_tile_or_zero<kRows, float>(nullptr, h_s, row0, B, H);
  for (int t = 0; t < a.T; ++t) {
    load_tile(a.x + (size_t)t * B * a.D, x_s, row0, B, a.D);
    __syncthreads();
    gru_cell<kTanh>(x_s, a.D, h_s, rh_s, a.w, a.u, a.b, H);
    store_tile(h_s, a.hseq + (size_t)t * B * H, row0, B, H);
  }
}

template <typename TX>
__global__ void gru_encoder_stack_fwd_kernel(StackFwd stack,
                                             BranchesFwd branches, int B,
                                             int H) {
  extern __shared__ __align__(16) float smem[];
  if (blockIdx.y == 0) {
    stack_fwd<TX>(stack, B, H, smem);
  } else if constexpr (std::is_same_v<TX, float>) {
    branch_fwd(branches.k[blockIdx.y - 1], B, H, smem);
  }
}

template <typename TX>
int launch(const StackFwd* stack, const BranchFwd* branches, int n_branches,
           int B, int H, void* stream) {
  if (stack == nullptr || stack->T < 1 || stack->D < 1 || B < 1 || H < 32 ||
      H % 32 != 0 || n_branches < 0 || n_branches > kMaxBranches) {
    return (int)cudaErrorInvalidValue;
  }
  BranchesFwd all{};
  size_t smem = sizeof(float) * kRows * (stack->D + 3 * H);
  for (int k = 0; k < n_branches; ++k) {
    const BranchFwd& a = branches[k];
    if (a.T < 1 || a.D < 1) return (int)cudaErrorInvalidValue;
    all.k[k] = a;
    const size_t need = sizeof(float) * kRows * (a.D + 2 * H);
    if (need > smem) smem = need;
  }
  cudaError_t err = fit_block(gru_encoder_stack_fwd_kernel<TX>, H, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows, 1 + n_branches);
  gru_encoder_stack_fwd_kernel<TX><<<grid, H, smem, static_cast<cudaStream_t>(stream)>>>(
      *stack, all, B, H);
  return (int)cudaGetLastError();
}

}  // namespace mvt

// The stack alone, from h01 and h02; is_bf16 != 0 selects the
// __nv_bfloat16 build (every operand bf16), else every operand is float.
extern "C" int mvt_gru_stack2_fwd(const mvt::StackFwd* stack, int B, int H,
                                  int is_bf16, void* stream) {
  using namespace mvt;
  if (stack == nullptr || stack->h01 == nullptr || stack->h02 == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  return is_bf16 ? launch<bf16>(stack, nullptr, 0, B, H, stream)
                 : launch<float>(stack, nullptr, 0, B, H, stream);
}

// The stack and n_branches branches, float, every initial state zero (the
// stack's h01 and h02 must be null).
extern "C" int mvt_gru_encode_multibranch_fwd(const mvt::StackFwd* stack,
                                              const mvt::BranchFwd* branches,
                                              int n_branches, int B, int H,
                                              void* stream) {
  using namespace mvt;
  if (stack == nullptr || stack->h01 != nullptr || stack->h02 != nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  return launch<float>(stack, branches, n_branches, B, H, stream);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
