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
// h @ U is in the kernel. Its backward is the plain recomputation too
// (_lstm_recurrent_bwd, :194-200).
//
// Math (_lstm_full_kernel, _lstm_gates :54-64): gates = (x @ W + b) + h @ U
// in float, columns [i, f, g, o], then c' = sig(f) c + sig(i) act(g) and
// h' = sig(o) act(c'), h' from the unrounded c', both stored in the
// operands' dtype (bf16: rounded to nearest even). act (on g and on c) is
// tanh, sigmoid or relu. S has a bf16 build (mvt_lstm_step_bf16: every LSTM
// head cell of a bf16 model); S xp is float32 only.
//
// Design: one product a launch on the tensor cores, [x | h] (B, D + H) .
// [W ; U] (D + H, 4H), with the cell math in its epilogue. A block of 2 kBN
// threads owns a tile of kBM batch rows x kUnits hidden units; its kBN =
// 4 kUnits product columns are the four gate columns of its own units,
// gathered from W's and U's four column ranges [q H + u0, q H + u0 + kUnits)
// and interleaved 8 units at a time (gemm_tc.cuh's kGather), so that each
// thread's accumulator fragments hold i, f, g and o of the same four (row,
// unit) pairs: the epilogue adds b (S xp: xp's own columns) in float, runs
// the cell in registers and stores h' and c'; nothing goes to a second pass.
// The mainloop is gemm_tc.cuh's (its cp.async ring, padded tiles and
// stage-wise zeroed accumulators), over two segments of depth: x against W
// (k < D), then h against U (S xp: h against U alone). Float32 operands
// take the three-product TF32 split (float32 accuracy); bf16 operands are
// exact in TF32, so one product each, summed in float: _dot's
// preferred_element_type=float32 on bf16 operands.
//
// The tile plan (ops/_layout.py::step_plan, cached per shape): (kBM, kUnits)
// of (32, 8), or (64, 16) for bf16 S where (32, 8) makes more than three
// blocks an SM (B = 256, H = 512), as the two were timed on the H100.
//
// What bounds it: one launch per cell per decode step (196 a training
// forward of the default LSTM config; S xp as many with
// fused_train_encoder=False), each a product of a few hundred MFLOP and a
// read of W and U (1.25 MiB in float32 at H = 256) from L2: the launch and
// the ring's latency, not the FLOPs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (midi_vae_tpu_torch/ops/_build.py).
#include "gemm_tc.cuh"

namespace mvt {

template <typename TV>
struct StepArgs {
  const TV* x;      // (B, D), or null (S xp)
  const TV* h;      // (B, H)
  const TV* c;      // (B, H)
  const TV* w;      // (D, 4H), or null (S xp)
  const TV* b;      // (4H,), or null (S xp)
  const TV* u;      // (H, 4H)
  const float* xp;  // (B, 4H): S xp's x @ W + b, else null
  TV* h_out;        // (B, H)
  TV* c_out;        // (B, H)
  int B, D, H;
  int x_vec, h_vec, w_vec, u_vec;  // float tiles that take 16-byte copies
};

template <int ACT, typename TV, int kBM, int kUnits, bool kXp>
__device__ __forceinline__ void step_body(const StepArgs<TV>& a) {
  constexpr int kP = std::is_same_v<TV, bf16> ? tc::kOne : tc::kThree;
  using G = tc::Gemm<false, TV, TV, kBM, kP, 4 * kUnits, true>;
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, G4 = 4 * H;
  const int u0 = blockIdx.x * kUnits, m0 = blockIdx.y * kBM;
  typename G::Acc acc;
  const typename G::Segment sx{a.x, a.D, a.w, G4, 0, kXp ? 0 : a.D, a.x_vec != 0, a.w_vec != 0};
  const typename G::Segment sh{a.h, H, a.u, G4, 0, H, a.h_vec != 0, a.u_vec != 0};
  G::run2(sx, sh, m0, a.B, u0, H, H, smem, acc, nullptr);
  // acc[mt][q][2 half + e]: gate q of row m0 + row_of(mt, 2 half), unit
  // u0 + gather_unit(col_of(q, e)) (the same unit for every q)
  const int unit0 = u0 + tc::gather_unit(G::col_of(0, 0));
#pragma unroll
  for (int mt = 0; mt < G::kMT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + G::row_of(mt, 2 * half);
      if (row >= a.B) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int unit = unit0 + e;
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float add = kXp ? a.xp[(size_t)row * G4 + q * H + unit] : to_f32(a.b[q * H + unit]);
          g[q] = acc[mt][q][2 * half + e] + add;
        }
        const size_t o = (size_t)row * H + unit;
        const float cn = activate<kSigmoid>(g[1]) * to_f32(a.c[o]) +
                         activate<kSigmoid>(g[0]) * activate<ACT>(g[2]);
        a.h_out[o] = from_f32<TV>(activate<kSigmoid>(g[3]) * activate<ACT>(cn));
        a.c_out[o] = from_f32<TV>(cn);
      }
    }
  }
}

template <int kUnits>
constexpr int step_threads() {
  return 8 * kUnits;  // 2 kBN, kBN = 4 kUnits
}

template <int ACT, typename TV, int kBM, int kUnits>
__global__ void __launch_bounds__(step_threads<kUnits>()) lstm_step_kernel(const StepArgs<TV> a) {
  step_body<ACT, TV, kBM, kUnits, false>(a);
}

template <int ACT, int kBM, int kUnits>
__global__ void __launch_bounds__(step_threads<kUnits>()) lstm_step_xp_kernel(
    const StepArgs<float> a) {
  step_body<ACT, float, kBM, kUnits, true>(a);
}

template <int ACT, typename TV, int kBM, int kUnits, bool kXp>
int launch_tile(const StepArgs<TV>& a, void* stream) {
  constexpr int kP = std::is_same_v<TV, bf16> ? tc::kOne : tc::kThree;
  using G = tc::Gemm<false, TV, TV, kBM, kP, 4 * kUnits, true>;
  const dim3 grid(a.H / kUnits, (a.B + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // G::kSmem is at most 39 KiB: under the 48 KiB a launch may take unasked
  if constexpr (kXp) {
    lstm_step_xp_kernel<ACT, kBM, kUnits><<<grid, G::kThr, G::kSmem, s>>>(a);
  } else {
    lstm_step_kernel<ACT, TV, kBM, kUnits><<<grid, G::kThr, G::kSmem, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// the tile plans of ops/_layout.py::STEP_TILES, by index
template <int ACT, typename TV, bool kXp>
int launch_plan(const StepArgs<TV>& a, int tile, void* stream) {
  switch (tile) {
    case 0: return launch_tile<ACT, TV, 32, 8, kXp>(a, stream);
    case 1: return launch_tile<ACT, TV, 64, 16, kXp>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

__host__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

template <typename TV, bool kXp>
int run(StepArgs<TV> a, int act, int tile, void* stream) {
  if (a.B < 1 || (!kXp && a.D < 1) || a.H < 32 || a.H % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  // 16-byte copies of float rows whose stride and base are 16-byte
  // multiples (bf16 tiles are staged through registers)
  const bool f32 = std::is_same_v<TV, float>;
  a.x_vec = f32 && !kXp && a.D % 4 == 0 && aligned16(a.x);
  a.h_vec = f32 && aligned16(a.h);
  a.w_vec = f32 && !kXp && aligned16(a.w);
  a.u_vec = f32 && aligned16(a.u);
  switch (act) {
    case kTanh: return launch_plan<kTanh, TV, kXp>(a, tile, stream);
    case kSigmoid: return launch_plan<kSigmoid, TV, kXp>(a, tile, stream);
    case kRelu: return launch_plan<kRelu, TV, kXp>(a, tile, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mvt

// x (B, D), h, c (B, H), w (D, 4H), b (4H,), u (H, 4H) contiguous; h_out,
// c_out (B, H); tile: the index of ops/_layout.py::step_plan's tile.
extern "C" int mvt_lstm_step(const float* x, const float* h, const float* c, const float* w,
                             const float* b, const float* u, float* h_out, float* c_out, int B,
                             int D, int H, int act, int tile, void* stream) {
  return mvt::run<float, false>({x, h, c, w, b, u, nullptr, h_out, c_out, B, D, H}, act, tile,
                                stream);
}

// the bf16 build: every operand and output bf16
extern "C" int mvt_lstm_step_bf16(const mvt::bf16* x, const mvt::bf16* h, const mvt::bf16* c,
                                  const mvt::bf16* w, const mvt::bf16* b, const mvt::bf16* u,
                                  mvt::bf16* h_out, mvt::bf16* c_out, int B, int D, int H,
                                  int act, int tile, void* stream) {
  return mvt::run<mvt::bf16, false>({x, h, c, w, b, u, nullptr, h_out, c_out, B, D, H}, act,
                                    tile, stream);
}

// S xp: xp (B, 4H), h, c (B, H), u (H, 4H) float32, contiguous
extern "C" int mvt_lstm_step_xp(const float* xp, const float* h, const float* c, const float* u,
                                float* h_out, float* c_out, int B, int H, int act, int tile,
                                void* stream) {
  return mvt::run<float, true>({nullptr, h, c, nullptr, nullptr, u, xp, h_out, c_out, B, 0, H},
                               act, tile, stream);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
