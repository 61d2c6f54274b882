// Kernel G: one GRU layer's backward through time (BPTT) over a
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
// From xp (T, B, 3H), hprev = [h0, hseq[:-1]] (the forward's h sequence
// shifted by one step; the wrapper forms it, and hands it to kernel W too),
// the incoming grads (d_seq for return-sequence layers; d_final seeds the
// carry for last layers) and U it emits
//   dacat (T, B, 3H)  [da_z, da_r, da] in float, which is dxp,
//   rh (T, B, H)      r * h_{t-1}, the dU[:, 2H:] operand of kernel W,
//   dh0 (B, H).
// dx = dxp @ W^T, dW and db are autograd over xp = x @ W + b, outside any
// kernel, as in the JAX package.
//
// Design: kernel C's phases (gru_cell_bwd_chain.cuh has the math) without
// the x segment and the dx pass. None of the gate recompute depends on the
// carried dh, so
//   mvt_gru_layer_xp_bwd_gates  the xp gate pre-pass, parallel over all T B
//                               rows on the tensor cores: P1 gates[:, :2H]
//                               = sig(xp_zr + hprev . U_zr), r hprev into
//                               rh; P2 gates[:, 2H:] = tanh(xp_h + rh .
//                               U_h) (xp's columns added in the epilogues;
//                               C's P1 and P2 with no x segment);
//   mvt_gru_layer_xp_bwd_chain  C's chain over those gates on thread-block
//                               clusters (its plan: ops/_layout.py::
//                               gru_bptt_plan("G_chain", ...)), the carry
//                               seeded by d_final and fed d_seq exactly as C
//                               runs it.
// The wrapper (ops/gru_layer.py::gru_layer_xp_bwd) runs them in order. Where
// C's chain does not launch (H not a multiple of 64: 32, 96, 160, ...) the
// per-block route (mvt_gru_layer_xp_bwd_block, the first design: one block
// of H threads per kRows = 8 batch rows for the whole reverse loop, the
// gates recomputed inside it, U and U^T read from L2 at every step;
// compiled under __launch_bounds__(kWideThreads)) takes the layer, as
// ops/_layout.py::gru_xp_bwd_route picks before launch.
//
// A bf16 build (the _bf16 entry points) runs _bwd_kernel (row 10, the
// path of GRU(512) in a bf16 model at B = 256): xp, hprev, the incoming
// grads and U in bf16. The pre-pass takes P1's bf16 products exactly (one
// TF32 product each) and P2's float r h against the bf16 U_h split in two
// (kTwoA), as C's bf16 pre-pass; the chain takes da . U^T on the tensor
// cores with the float da in three bf16 terms and keeps every gate grad and
// the dh carry in float (the Pallas kernel's f32 scratch). It emits dxp
// rounded to bf16 (dxp_ref in xp's dtype, :165) from the chain's own stores
// of da (the chain's kDxp instance), which autograd takes back through xp =
// x @ W + b, and dh0 rounded to bf16 (:186), and beside them the same gate
// grads unrounded in float (dacat) with r * h, from which kernel W sums dU:
// _bwd_kernel accumulates dU from the float gate grads (:166-167), not from
// the rounded dxp. The float build emits dacat alone, which is its dxp.
//
// What bounds it on the H100: the chain, T serial steps of two dependent
// products of rows x Hc x H (and 2 Hc x H) a CTA and two cluster barriers;
// the pre-pass is two products over all T B rows at the tensor cores' rate.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (midi_vae_tpu_torch/ops/_build.py).
#include "gru_cell_bwd.cuh"
#include "gru_cell_bwd_chain.cuh"

namespace mvt {

// The per-block route: one block owns kRows = 8 batch rows for the whole
// reverse loop, thread j hidden column j and its dh carries in registers;
// the gates are recomputed inside the loop (gru_cell_bwd_recurrent), U and
// U^T read from L2 at every step.
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
namespace mvt {

// The xp gate pre-pass's P1: gates[:, :2H] = sig(xp[:, :2H] + hprev U_zr),
// r hprev into rh (the dU[:, 2H:] operand). hprev (M, H), U (H, 3H), xp (M,
// 3H). Grid (2H / 128, ceil(M / 128)); H a multiple of 64.
template <typename TV>
__global__ void __launch_bounds__(tc::kThreads) gru_xp_gates_p1_kernel(
    const TV* __restrict__ xp, const TV* __restrict__ hprev, const TV* __restrict__ u,
    float* __restrict__ gates, float* __restrict__ rh, int M, int H, int h_vec, int u_vec) {
  using G = GatesP1<TV>;
  extern __shared__ __align__(16) float smem[];
  const int G3 = 3 * H;
  const int m0 = blockIdx.y * kGateBM, n0 = blockIdx.x * tc::kBN;
  typename G::Acc acc;
  G::run(hprev, H, u, G3, m0, M, n0, 2 * H, 0, H, h_vec != 0, u_vec != 0, smem, acc, nullptr);
#pragma unroll
  for (int nt = 0; nt < G::kNT; ++nt) {
    const int n = n0 + G::col_of(nt, 0);  // even
    if (n >= 2 * H) continue;
#pragma unroll
    for (int mt = 0; mt < G::kMT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + G::row_of(mt, 2 * half);
        if (m >= M) continue;
        const TV* x = xp + (size_t)m * G3 + n;
        const float v0 = activate<kSigmoid>(to_f32(x[0]) + acc[mt][nt][2 * half]);
        const float v1 = activate<kSigmoid>(to_f32(x[1]) + acc[mt][nt][2 * half + 1]);
        if (n >= H) {  // r: r h_{t-1}
          const TV* hp = hprev + (size_t)m * H + n - H;
          *reinterpret_cast<float2*>(rh + (size_t)m * H + n - H) =
              make_float2(v0 * to_f32(hp[0]), v1 * to_f32(hp[1]));
        }
        *reinterpret_cast<float2*>(gates + (size_t)m * G3 + n) = make_float2(v0, v1);
      }
    }
  }
}

// P2: gates[:, 2H:] = tanh(xp[:, 2H:] + rh U_h). Grid (ceil(H / 128),
// ceil(M / 128)).
template <typename TV>
__global__ void __launch_bounds__(tc::kThreads) gru_xp_gates_p2_kernel(
    const TV* __restrict__ xp, const float* __restrict__ rh, const TV* __restrict__ u,
    float* __restrict__ gates, int M, int H, int u_vec) {
  using G = FloatByW<TV>;
  extern __shared__ __align__(16) float smem[];
  const int G3 = 3 * H;
  const int m0 = blockIdx.y * kGateBM, n0 = blockIdx.x * tc::kBN;
  typename G::Acc acc;
  G::run(rh, H, u + 2 * H, G3, m0, M, n0, H, 0, H, true, u_vec != 0, smem, acc, nullptr);
#pragma unroll
  for (int nt = 0; nt < G::kNT; ++nt) {
    const int n = n0 + G::col_of(nt, 0);
    if (n >= H) continue;
#pragma unroll
    for (int mt = 0; mt < G::kMT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + G::row_of(mt, 2 * half);
        if (m >= M) continue;
        const TV* x = xp + (size_t)m * G3 + 2 * H + n;
        *reinterpret_cast<float2*>(gates + (size_t)m * G3 + 2 * H + n) =
            make_float2(tanhf(to_f32(x[0]) + acc[mt][nt][2 * half]),
                        tanhf(to_f32(x[1]) + acc[mt][nt][2 * half + 1]));
      }
    }
  }
}

// The pre-pass of one layer: gates (M, 3H) float [z, r, hh] and rh (M, H)
// float from xp (M, 3H), hprev (M, H), u (H, 3H), M = T B.
template <typename TV>
int launch_xp_gates(const TV* xp, const TV* hprev, const TV* u, float* gates, float* rh, int M,
                    int H, void* stream) {
  if (M < 1 || H < 64 || H % 64 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr bool f32 = std::is_same_v<TV, float>;
  // 16-byte copies of float rows (bf16: staged)
  const int h_vec = f32 && aligned16(hprev);
  const int u_vec = f32 && aligned16(u);
  auto p1 = gru_xp_gates_p1_kernel<TV>;
  cudaError_t err = cudaFuncSetAttribute(p1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)GatesP1<TV>::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int mb = (M + kGateBM - 1) / kGateBM;
  p1<<<dim3(2 * H / tc::kBN, mb), tc::kThreads, GatesP1<TV>::kSmem, s>>>(xp, hprev, u, gates, rh,
                                                                         M, H, h_vec, u_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto p2 = gru_xp_gates_p2_kernel<TV>;
  err = cudaFuncSetAttribute(p2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)FloatByW<TV>::kSmem);
  if (err != cudaSuccess) return (int)err;
  p2<<<dim3((H + tc::kBN - 1) / tc::kBN, mb), tc::kThreads, FloatByW<TV>::kSmem, s>>>(
      xp, rh, u, gates, M, H, u_vec);
  return (int)cudaGetLastError();
}

template <typename TV>
int xp_chain(const float* gates, const TV* hprev, const TV* d_seq, const TV* d_final,
             const TV* ut, float* dacat, TV* dxp, TV* dh0, int T, int B, int H, int cluster,
             int rows, int nbuf, int stages, void* stream) {
  GruBwdChainArgs<TV> a{gates, hprev, d_seq, d_final, ut, dacat, dh0,
                        T, B, H, rows, nbuf, stages};
  a.dxp = dxp;
  constexpr bool kDxp = !std::is_same_v<TV, float>;
  return launch_gru_bwd_chain<TV, kDxp>(a, cluster, stream);
}

}  // namespace mvt

// The xp gate pre-pass: gates (M, 3H) float = [z, r, hh] and rh (M, H)
// float of xp (M, 3H), hprev (M, H) and u (H, 3H); M = T B
extern "C" int mvt_gru_layer_xp_bwd_gates(const float* xp, const float* hprev, const float* u,
                                          float* gates, float* rh, int M, int H, void* stream) {
  return mvt::launch_xp_gates(xp, hprev, u, gates, rh, M, H, stream);
}

extern "C" int mvt_gru_layer_xp_bwd_gates_bf16(const mvt::bf16* xp, const mvt::bf16* hprev,
                                               const mvt::bf16* u, float* gates, float* rh,
                                               int M, int H, void* stream) {
  return mvt::launch_xp_gates(xp, hprev, u, gates, rh, M, H, stream);
}

// C's chain over the gates: dacat (T, B, 3H) float and dh0 (B, H). d_seq (T,
// B, H) and d_final (B, H) may each be null (read as zeros); ut = U^T (3H,
// H). cluster, rows, nbuf and stages are the plan of
// ops/_layout.py::gru_bptt_plan. The float build's dacat is its dxp.
extern "C" int mvt_gru_layer_xp_bwd_chain(const float* gates, const float* hprev,
                                          const float* d_seq, const float* d_final,
                                          const float* ut, float* dacat, float* dh0, int T,
                                          int B, int H, int cluster, int rows, int nbuf,
                                          int stages, void* stream) {
  return mvt::xp_chain(gates, hprev, d_seq, d_final, ut, dacat, static_cast<float*>(nullptr),
                       dh0, T, B, H, cluster, rows, nbuf, stages, stream);
}

// the bf16 build: dxp (T, B, 3H) bf16 gets the gate grads rounded once,
// from the chain's own stores of dacat
extern "C" int mvt_gru_layer_xp_bwd_chain_bf16(const float* gates, const mvt::bf16* hprev,
                                               const mvt::bf16* d_seq, const mvt::bf16* d_final,
                                               const mvt::bf16* ut, float* dacat,
                                               mvt::bf16* dxp, mvt::bf16* dh0, int T, int B,
                                               int H, int cluster, int rows, int nbuf, int stages,
                                               void* stream) {
  return mvt::xp_chain(gates, hprev, d_seq, d_final, ut, dacat, dxp, dh0, T, B, H, cluster, rows,
                       nbuf, stages, stream);
}

// cudaOccupancyMaxActiveClusters of the chain's build (bf16 or float) at
// `cluster` CTAs a cluster
extern "C" int mvt_gru_layer_xp_bwd_max_clusters(int bf16, int cluster, int* out) {
  return bf16 ? mvt::bwd_max_clusters(mvt::gru_bwd_chain_kernel<mvt::bf16, true>, cluster, out)
              : mvt::bwd_max_clusters(mvt::gru_bwd_chain_kernel<float>, cluster, out);
}

// The per-block route: d_seq (T, B, H) and d_final (B, H) may each be null
// (read as zeros); the float build has no dxp (dacat is its dxp).
extern "C" int mvt_gru_layer_xp_bwd_block(
    const float* xp, const float* hseq, const float* h0, const float* d_seq,
    const float* d_final, const float* u, const float* ut, float* dacat,
    float* dh0, float* rh, int T, int B, int H, void* stream) {
  return mvt::launch(xp, hseq, h0, d_seq, d_final, u, ut, dacat,
                     static_cast<float*>(nullptr), dh0, rh, T, B, H, stream);
}

// the bf16 build: every operand bf16 but the gate grads dacat and r * h
// (float); dxp (bf16) receives the rounded gate grads
extern "C" int mvt_gru_layer_xp_bwd_block_bf16(
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
