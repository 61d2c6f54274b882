// The GRU's backward through time on the H100, in phases: kernel C
// (gru_layer_bwd.cu: an encoder layer, x @ W recomputed) and kernel E
// (gru_decode_bwd.cu: a decode head of one or two layers, the readout and
// the fed-back probs) share every piece below.
//
// Math (midi_vae_tpu/ops/fused_train.py::_bwdx_kernel :2145-2182 and
// _gru_cell_bwd_core :336, the reset-before cell with a tanh candidate),
// h = h_{t-1}:
//   z = sig(x W_z + b_z + h U_z)   r = sig(x W_r + b_r + h U_r)
//   hh = tanh(x W_h + b_h + (r h) U_h)
//   da   = dh (1 - z)(1 - hh^2)        da_z = dh (h - hh) z (1 - z)
//   drh  = da U_h^T                    da_r = drh h r (1 - r)
//   dh_{t-1} = dh z + drh r + [da_z, da_r] U_zr^T
//   dx   = [da_z, da_r, da] W^T
// The weight gradients are not summed here: the phases emit the gate grads
// da_cat = [da_z, da_r, da] and r h, and kernel W (grad_reduce.cu) reduces
// them over all T B rows afterwards.
//
// The TPU kernels run one grid step per time step and recompute the gates
// inside it, from x and from h_{t-1}, the forward's stored sequence shifted
// by one step. None of that depends on the carried dh, so here:
//
// 1. The gate pre-pass (gru_gates_p1_kernel, gru_gates_p2_kernel), parallel
//    over all M = T B rows on the tensor cores (gemm_tc.cuh's mainloop, 128
//    x 128 tiles): P1 gates[:, :2H] = sig(x W_zr + b_zr + hprev U_zr) and
//    gates[:, 2H:] = x W_h + b_h, with r hprev into rh (the stream kernel W
//    reads for dU[:, 2H:]); P2 gates[:, 2H:] = tanh(that + rh U_h). hprev =
//    [h0, hseq[:-1]] is the caller's. Float32 operands take the three-
//    product TF32 split; bf16 x, hprev, W and U are exact in TF32, so P1 is
//    one product each (the Pallas kernel's _dot of bf16 values summed in
//    float) and P2, float r h against the bf16 U_h, splits r h in two
//    (kTwoA). Bound by its operations on the tensor cores.
//
// 2. The chain, on thread-block clusters of kChainThreads-thread CTAs (one
//    an SM). A cluster owns `rows` batch rows for the whole reverse loop; its
//    C CTAs split the H units, CTA c owning [c Hc, (c+1) Hc), Hc = H / C, and
//    their 3 Hc gate rows (local gate q Hc + u is gate row q H + c Hc + u).
//    A thread owns up to kBwdMaxPairs (row, unit) pairs and their float dh
//    carries. A layer's reverse step:
//      E1  from the pre-pass's z, r, hh and hprev of its pairs: da and da_z
//          into the CTA's da tile (rows rounded to 16, 3 Hc) and out to da_cat;
//      S1  the CTA's partial over its candidate gate rows for all H units:
//          part (rows, H) = da (rows, Hc) . U_h^T rows; one cluster barrier;
//      R1  each CTA sums the C partials of its own units through
//          distributed shared memory in rank order (0 to C-1, the same bits
//          every run): drh; da_r = drh h r (1 - r) into the tile and out;
//      S2  part (rows, H) = [da_z, da_r] (rows, 2 Hc) . U_zr^T rows and,
//          where the layer's dx feeds the chain (kernel E), in the columns
//          after H its dx partial [da_z, da_r, da] (rows, 3 Hc) . W^T rows;
//          one cluster barrier;
//      R2  dh_{t-1} = dh z + drh r + the summed partials of its own units;
//          E's layer 2 sums its dx columns into layer 1's dh the same way,
//          and layer 1's dx (the next step's fed-back probs' grad, D
//          columns) is summed whole by every CTA of the cluster.
//    The reset-before GRU needs drh before da_r, so a step has two
//    dependent reductions where the LSTM's (lstm_cell_bwd.cuh) has one.
//    da_z is known at E1, but its product waits for S2, so that each stage
//    writes one partial of H (or H + dx) columns: folding it into S1 would
//    add an H-column exchange to every step. With two partial buffers (the
//    stages alternate) one cluster barrier a stage suffices; with one, a
//    second, split barrier (arrive after a reduction, wait before the next
//    stage writes) keeps a peer from overwriting a buffer still read.
//    The slices (U^T's 3 Hc rows; E's W^T rows) pass through a ring of
//    chunks of kBwdChunk gate rows in shared memory, in the weights' type:
//    resident where the ring holds every chunk of a step (copied once,
//    cp.async), else streamed from L2 at every step through `stages` slots
//    (2 to 8) that run on across the stages and steps
//    (ops/_layout.py::gru_bptt_plan). The float build's products are FFMA:
//    a warp owns up to kBwdMaxItems tiles of 8 rows x 64 units (2 a lane),
//    da read as float4 broadcasts. The bf16 build's U and W are exactly
//    bf16 but da is float, so its products run on the tensor cores with da
//    split into three bf16 terms (as the LSTM's bf16 chain,
//    chain_product_mma): mma.sync m16n8k16 over tiles of 16 rows x 32 units,
//    B's fragments by ldmatrix .trans from the chunk (its rows padded to H
//    + kBwdSlicePad values); one bf16 rounding of da would compute another
//    function.
//    Bound by the chain: T steps of two dependent products and two cluster
//    barriers a layer.
//
// 3. The dx pass (kernel C only, where dx is wanted): dx (M, D) = da_cat
//    (M, 3H) . W^T on the tensor cores (gemm_tc.cuh), float da_cat split in
//    three TF32 products against a float W, in two (kTwoA) against a bf16
//    W, rounded once to the build's type.
//
// Every kernel launches on the caller's stream and allocates nothing: the
// wrappers (ops/gru_layer.py, ops/gru_decode.py) allocate the scratch, form
// hprev, the transposed weights and E's padded W1^T, and choose the plan.
#pragma once

#include <algorithm>

#include "gemm_tc.cuh"
#include "lstm_cluster.cuh"

namespace mvt {

// ---------------------------------------------------------------------------
// Phases 1 and 3 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kGateBM = 128;

template <typename TV>
using GatesP1 = tc::Gemm<false, TV, TV, kGateBM, std::is_same_v<TV, bf16> ? tc::kOne : tc::kThree>;
template <typename TV>
using FloatByW = tc::Gemm<false, float, TV, kGateBM,
                          std::is_same_v<TV, bf16> ? tc::kTwoA : tc::kThree>;

// P1 over x (M, D), W (D, 3H), b (3H), hprev (M, H), U (H, 3H): column
// blocks below 2H take x W + hprev U, the others x W alone. Grid (3H / 128,
// ceil(M / 128)); H a multiple of 64.
template <typename TV>
__global__ void __launch_bounds__(tc::kThreads) gru_gates_p1_kernel(
    const TV* __restrict__ x, const TV* __restrict__ w, const TV* __restrict__ b,
    const TV* __restrict__ hprev, const TV* __restrict__ u, float* __restrict__ gates,
    float* __restrict__ rh, int M, int D, int H, int x_vec, int w_vec, int h_vec) {
  using G = GatesP1<TV>;
  extern __shared__ __align__(16) float smem[];
  const int G3 = 3 * H;
  const int m0 = blockIdx.y * kGateBM, n0 = blockIdx.x * tc::kBN;
  const bool zr = n0 < 2 * H;
  typename G::Acc acc;
  G::run2(typename G::Segment{x, D, w, G3, 0, D, x_vec != 0, w_vec != 0},
          typename G::Segment{hprev, H, u, G3, 0, zr ? H : 0, h_vec != 0, w_vec != 0}, m0, M, n0,
          G3, 0, smem, acc, nullptr);
#pragma unroll
  for (int nt = 0; nt < G::kNT; ++nt) {
    const int n = n0 + G::col_of(nt, 0);  // even; 3H is a multiple of 2
    if (n >= G3) continue;
    const float b0 = to_f32(b[n]), b1 = to_f32(b[n + 1]);
#pragma unroll
    for (int mt = 0; mt < G::kMT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + G::row_of(mt, 2 * half);
        if (m >= M) continue;
        float v0 = acc[mt][nt][2 * half] + b0, v1 = acc[mt][nt][2 * half + 1] + b1;
        if (zr) {
          v0 = activate<kSigmoid>(v0);
          v1 = activate<kSigmoid>(v1);
          if (n >= H) {  // r: r h_{t-1}, the dU[:, 2H:] operand
            const TV* hp = hprev + (size_t)m * H + n - H;
            *reinterpret_cast<float2*>(rh + (size_t)m * H + n - H) =
                make_float2(v0 * to_f32(hp[0]), v1 * to_f32(hp[1]));
          }
        }
        *reinterpret_cast<float2*>(gates + (size_t)m * G3 + n) = make_float2(v0, v1);
      }
    }
  }
}

// P2: gates[:, 2H:] = tanh(gates[:, 2H:] + rh U_h). Grid (H / 128, ceil(M /
// 128)) (the last column block ragged at H = 64 mod 128).
template <typename TV>
__global__ void __launch_bounds__(tc::kThreads) gru_gates_p2_kernel(
    const float* __restrict__ rh, const TV* __restrict__ u, float* __restrict__ gates, int M,
    int H, int u_vec) {
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
        float2* g = reinterpret_cast<float2*>(gates + (size_t)m * G3 + 2 * H + n);
        const float2 xh = *g;
        *g = make_float2(tanhf(xh.x + acc[mt][nt][2 * half]),
                         tanhf(xh.y + acc[mt][nt][2 * half + 1]));
      }
    }
  }
}

// dx (M, D) = dacat (M, 3H) . W^T, wt = W^T (3H, D); rounded to TV. Grid
// (ceil(D / 128), ceil(M / 128)).
template <typename TV>
__global__ void __launch_bounds__(tc::kThreads) gru_bwd_dx_kernel(
    const float* __restrict__ dacat, const TV* __restrict__ wt, TV* __restrict__ dx, int M, int D,
    int H, int wt_vec) {
  using G = FloatByW<TV>;
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * kGateBM, n0 = blockIdx.x * tc::kBN;
  typename G::Acc acc;
  G::run(dacat, 3 * H, wt, D, m0, M, n0, D, 0, 3 * H, true, wt_vec != 0, smem, acc, nullptr);
#pragma unroll
  for (int nt = 0; nt < G::kNT; ++nt) {
#pragma unroll
    for (int mt = 0; mt < G::kMT; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + G::row_of(mt, e), n = n0 + G::col_of(nt, e);
        if (m < M && n < D) dx[(size_t)m * D + n] = from_f32<TV>(acc[mt][nt][e]);
      }
    }
  }
}

__host__ inline bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

// Phase 1 of one layer: gates (M, 3H) float [z, r, hh] and rh (M, H) float
// from x (M, D), w (D, 3H), b (3H), hprev (M, H), u (H, 3H), M = T B.
template <typename TV>
int launch_gates(const TV* x, const TV* w, const TV* b, const TV* hprev, const TV* u,
                 float* gates, float* rh, int M, int D, int H, void* stream) {
  if (M < 1 || D < 1 || H < 64 || H % 64 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr bool f32 = std::is_same_v<TV, float>;
  // 16-byte copies of float rows that are 16-byte multiples (bf16: staged)
  const int x_vec = f32 && D % 4 == 0 && aligned16(x);
  const int w_vec = f32 && aligned16(w) && aligned16(u);
  const int h_vec = f32 && aligned16(hprev);
  auto p1 = gru_gates_p1_kernel<TV>;
  cudaError_t err = cudaFuncSetAttribute(p1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)GatesP1<TV>::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int mb = (M + kGateBM - 1) / kGateBM;
  p1<<<dim3(3 * H / tc::kBN + (3 * H % tc::kBN != 0), mb), tc::kThreads, GatesP1<TV>::kSmem, s>>>(
      x, w, b, hprev, u, gates, rh, M, D, H, x_vec, w_vec, h_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto p2 = gru_gates_p2_kernel<TV>;
  err = cudaFuncSetAttribute(p2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)FloatByW<TV>::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int u_vec = f32 && aligned16(u + 2 * H);
  p2<<<dim3(H / tc::kBN + (H % tc::kBN != 0), mb), tc::kThreads, FloatByW<TV>::kSmem, s>>>(
      rh, u, gates, M, H, u_vec);
  return (int)cudaGetLastError();
}

template <typename TV>
int launch_bwd_dx(const float* dacat, const TV* wt, TV* dx, int M, int D, int H, void* stream) {
  if (M < 1 || D < 1 || H < 1) return (int)cudaErrorInvalidValue;
  auto k = gru_bwd_dx_kernel<TV>;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)FloatByW<TV>::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int wt_vec = std::is_same_v<TV, float> && D % 4 == 0 && aligned16(wt);
  k<<<dim3((D + tc::kBN - 1) / tc::kBN, (M + kGateBM - 1) / kGateBM), tc::kThreads,
      FloatByW<TV>::kSmem, static_cast<cudaStream_t>(stream)>>>(dacat, wt, dx, M, D, H, wt_vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Phase 2: the chain on a cluster
// ---------------------------------------------------------------------------

constexpr int kBwdChunk = 16;     // gate rows of a chunk of a slice
constexpr int kBwdMaxItems = 2;   // product tiles (8 rows x 64 units) a warp owns in a stage
constexpr int kBwdMaxPairs = 3;   // (row, unit) pairs a thread owns
constexpr int kBwdMaxSegs = 6;    // slice segments of a step (a 2-layer head)
constexpr int kBwdTile = 64;      // units of a float product tile
constexpr int kBwdTileMma = 32;   // units of a bf16 product tile (4 n-tiles of 8)
constexpr int kBwdSlicePad = 8;   // bf16 slice rows are H + 8 values (ldmatrix, 32 banks)

// values a ring row holds: H, padded in bf16 so that ldmatrix's 8 rows of
// 16 bytes hit 32 banks
template <typename TV>
__host__ __device__ constexpr int slice_ld(int H) {
  return H + (std::is_same_v<TV, bf16> ? kBwdSlicePad : 0);
}

// One segment of the slices a step reads: the CTA's local gate rows [g0, g1)
// of a row-major (3H, ld) source (U^T, W^T; ld its padded width), written
// into the partial's columns [col0, col0 + ld).
template <typename TV>
struct BwdSeg {
  const TV* src;
  int ld, g0, g1, col0;
};

// The ring of chunks in shared memory: chunk j of the whole sequence (T
// steps of n chunks, in the order the stages read them) lives in slot
// j % stages. Resident (n <= stages): the n chunks of a step are copied
// once; streamed: each acquire waits for its chunk and refills the slot
// freed by the previous one.
template <typename TV>
struct BwdRing {
  TV* base;
  const BwdSeg<TV>* segs;  // shared memory
  int n, stages, total, seq, H, Hc, c;

  __device__ __forceinline__ bool resident() const { return n <= stages; }

  // chunk k of a step into `dst`, 16 bytes a copy
  __device__ __forceinline__ void copy(int k, TV* dst) const {
    int s = 0;
    while (k >= (segs[s].g1 - segs[s].g0) / kBwdChunk) {
      k -= (segs[s].g1 - segs[s].g0) / kBwdChunk;
      ++s;
    }
    const BwdSeg<TV> sg = segs[s];
    const int g = sg.g0 + k * kBwdChunk;
    constexpr int kVec = 16 / sizeof(TV);
    const int per_row = sg.ld / kVec;
    for (int i = threadIdx.x; i < kBwdChunk * per_row; i += blockDim.x) {
      const int kk = i / per_row, v = (i % per_row) * kVec, gl = g + kk;
      const int row = (gl / Hc) * H + c * Hc + gl % Hc;
      cp_async16(dst + (size_t)kk * slice_ld<TV>(H) + v, sg.src + (size_t)row * sg.ld + v);
    }
  }

  __device__ __forceinline__ TV* slot(int j) const {
    return base + (size_t)(j % (resident() ? n : stages)) * kBwdChunk * slice_ld<TV>(H);
  }

  // every thread: the resident chunks, or the first stages - 1 streamed ones
  __device__ __forceinline__ void start() {
    if (resident()) {
      for (int j = 0; j < n; ++j) copy(j, slot(j));
      cp_async_commit();
      cp_async_wait(0);
      __syncthreads();
    } else {
      for (int j = 0; j < stages - 1; ++j) {
        if (j < total) copy(j % n, slot(j));
        cp_async_commit();
      }
    }
  }

  // every thread, in sequence order: the next chunk, landed and visible
  __device__ __forceinline__ const TV* acquire() {
    if (!resident()) {
      cp_async_wait(stages - 2);
      __syncthreads();  // and every thread is done with the slot refilled next
      const int next = seq + stages - 1;
      if (next < total) copy(next % n, slot(next));
      cp_async_commit();
    }
    return slot(seq++);
  }
};

using BwdAcc = float[kBwdMaxItems][8][2];

// The float build's chunk product (FFMA): acc += the da tile's rows of each
// of the warp's items, gate rows [g, g + kBwdChunk) . the chunk's rows, for
// the items whose columns lie in the segment. Item it = warp + i
// kChainWarps is (row tile it / ctiles, column tile it % ctiles); a lane
// owns 2 neighbouring columns of 8 rows.
__device__ __forceinline__ void chunk_product(const float* da_s, int DS, int g,
                                              const float* chunk, int H,
                                              const BwdSeg<float>& sg, int items, int ctiles,
                                              BwdAcc& acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kBwdMaxItems; ++i) {
    const int it = warp + i * kChainWarps;
    const int n = kBwdTile * (it % ctiles) - sg.col0;
    if (it < items && n >= 0 && n < sg.ld) {
      const float* dr = da_s + (size_t)(8 * (it / ctiles)) * DS + g;
      const float* sp = chunk + n + 2 * lane;
#pragma unroll 1
      for (int kk = 0; kk < kBwdChunk; kk += 4) {
        // four gate rows of the lane's two columns, then a row of da at a
        // time (a float4 broadcast): few registers beside the sums
        float2 u2[4];
#pragma unroll
        for (int gg = 0; gg < 4; ++gg) {
          u2[gg] = *reinterpret_cast<const float2*>(sp + (size_t)(kk + gg) * H);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 d = *reinterpret_cast<const float4*>(dr + r * DS + kk);
          float a0 = acc[i][r][0], a1 = acc[i][r][1];
          a0 = fmaf(d.x, u2[0].x, a0);
          a1 = fmaf(d.x, u2[0].y, a1);
          a0 = fmaf(d.y, u2[1].x, a0);
          a1 = fmaf(d.y, u2[1].y, a1);
          a0 = fmaf(d.z, u2[2].x, a0);
          a1 = fmaf(d.z, u2[2].y, a1);
          a0 = fmaf(d.w, u2[3].x, a0);
          a1 = fmaf(d.w, u2[3].y, a1);
          acc[i][r][0] = a0;
          acc[i][r][1] = a1;
        }
      }
    }
  }
}

// three bf16 terms of a float pair: their roundings, the roundings of what
// those leave, and of what is left then (each difference exact in float):
// d = t[0] + t[1] + t[2] to within 2^-27 of d (lstm_cell_bwd.cuh's
// split_pair)
__device__ __forceinline__ void bf16_terms(float2 d, unsigned (&t)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(d.x, d.y);
    const float2 hf = __bfloat1622float2(h);
    d = make_float2(d.x - hf.x, d.y - hf.y);
    t[i] = *reinterpret_cast<const unsigned*>(&h);
  }
}

using BwdAccMma = float[kBwdMaxItems][4][4];

// The bf16 build's chunk product on the tensor cores: acc += da (rows of the
// item's m-tile, the chunk's 16 gate rows) . the chunk's bf16 rows, with the
// float da split into three bf16 terms (bf16_terms), each multiplied by the
// exact bf16 weights on mma.sync m16n8k16 (float accumulators): one bf16
// rounding of da would compute another function. Each chunk's three products
// go into zeroed accumulators and are added by one rounded float add (the
// tensor cores truncate as they add). Item it = warp + i kChainWarps is
// (m-tile it / ctiles of 16 rows, column tile it % ctiles of 32 units: 4
// n-tiles of 8); B's fragments by ldmatrix .trans from the k-major chunk.
__device__ __forceinline__ void chunk_product_mma(const float* da_s, int DS, int g,
                                                  const bf16* chunk, int H,
                                                  const BwdSeg<bf16>& sg, int items, int ctiles,
                                                  BwdAccMma& acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gid = lane >> 2, tig = lane & 3;
  const int SW = slice_ld<bf16>(H);
  // ldmatrix rows: k (lane & 7) + 8 ((lane >> 3) & 1), n-tile pair lane >> 4
  const int b_k = (lane & 7) + 8 * ((lane >> 3) & 1), b_n = 8 * (lane >> 4);
#pragma unroll
  for (int i = 0; i < kBwdMaxItems; ++i) {
    const int it = warp + i * kChainWarps;
    const int n = kBwdTileMma * (it % ctiles) - sg.col0;
    if (it < items && n >= 0 && n < sg.ld) {
      const float* dr = da_s + (size_t)(16 * (it / ctiles) + gid) * DS + g + 2 * tig;
      unsigned t[4][3];  // (r, k), (r + 8, k), (r, k + 8), (r + 8, k + 8)
      bf16_terms(*reinterpret_cast<const float2*>(dr), t[0]);
      bf16_terms(*reinterpret_cast<const float2*>(dr + 8 * DS), t[1]);
      bf16_terms(*reinterpret_cast<const float2*>(dr + 8), t[2]);
      bf16_terms(*reinterpret_cast<const float2*>(dr + 8 * DS + 8), t[3]);
      const bf16* bp = chunk + (size_t)b_k * SW + n + b_n;
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {  // n-tiles 2 pr, 2 pr + 1
        unsigned b00, b01, b10, b11;
        ldmatrix_x4_trans(bp + 16 * pr, b00, b01, b10, b11);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned c0 = h ? b10 : b00, c1 = h ? b11 : b01;
          float part4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int term = 2; term >= 0; --term) {
            mma_bf16(part4, t[0][term], t[1][term], t[2][term], t[3][term], c0, c1);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][2 * pr + h][e] += part4[e];
        }
      }
    }
  }
}

// the bf16 product's sums of a warp's items into the partial (row stride
// pw) at column tile it % ctiles (of 32 units) after column col0
__device__ __forceinline__ void store_mma(const BwdAccMma& acc, float* part, int pw, int rows,
                                          int items, int ctiles, int col0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < kBwdMaxItems; ++i) {
    const int it = warp + i * kChainWarps;
    if (it < items) {
      const int n0 = col0 + kBwdTileMma * (it % ctiles) + 2 * tig, r0 = 16 * (it / ctiles) + gid;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (r0 + 8 * h < rows) {
            *reinterpret_cast<float2*>(part + (size_t)(r0 + 8 * h) * pw + n0 + 8 * nt) =
                make_float2(acc[i][nt][2 * h], acc[i][nt][2 * h + 1]);
          }
        }
      }
    }
  }
}

// One stage's product: part (rows, pw) = each segment's da gate rows . its
// slice rows into its columns, the chunks taken from the ring in order.
// Every thread calls it. A warp's items are product tiles over the whole
// partial; with kSeg (the bf16 instance for partials of more tiles than a
// CTA's warps hold, kBwdMaxItems each: a 1-layer head's H + Dp columns at H
// = 1024) over one segment's columns at a time, each segment's sums stored
// before the next one's chunks. The segments' columns do not overlap, so
// every column is the same sum of the same products either way.
template <typename TV, bool kSeg = false>
__device__ __forceinline__ void stage_product(BwdRing<TV>& ring, int s0, int s1, const float* da_s,
                                              int DS, float* part, int pw, int rows) {
  static_assert(!kSeg || std::is_same_v<TV, bf16>, "the per-segment items are bf16's");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (kSeg) {
    BwdAccMma acc;
    for (int s = s0; s < s1; ++s) {
      BwdSeg<TV> sg = ring.segs[s];
      const int col0 = sg.col0, ctiles = sg.ld / kBwdTileMma, items = (rows + 15) / 16 * ctiles;
      sg.col0 = 0;
#pragma unroll
      for (int i = 0; i < kBwdMaxItems; ++i) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.0f;
        }
      }
      for (int g = sg.g0; g < sg.g1; g += kBwdChunk) {
        const TV* chunk = ring.acquire();
        chunk_product_mma(da_s, DS, g, chunk, ring.H, sg, items, ctiles, acc);
      }
      store_mma(acc, part, pw, rows, items, ctiles, col0);
    }
  } else if constexpr (std::is_same_v<TV, bf16>) {
    const int ctiles = pw / kBwdTileMma, items = (rows + 15) / 16 * ctiles;
    BwdAccMma acc;
#pragma unroll
    for (int i = 0; i < kBwdMaxItems; ++i) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.0f;
      }
    }
    for (int s = s0; s < s1; ++s) {
      const BwdSeg<TV> sg = ring.segs[s];
      for (int g = sg.g0; g < sg.g1; g += kBwdChunk) {
        const TV* chunk = ring.acquire();
        chunk_product_mma(da_s, DS, g, chunk, ring.H, sg, items, ctiles, acc);
      }
    }
    store_mma(acc, part, pw, rows, items, ctiles, 0);
  } else {
    const int ctiles = pw / kBwdTile, items = (rows + 7) / 8 * ctiles;
    BwdAcc acc;
#pragma unroll
    for (int i = 0; i < kBwdMaxItems; ++i) {
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[i][r][0] = acc[i][r][1] = 0.0f;
    }
    for (int s = s0; s < s1; ++s) {
      const BwdSeg<TV> sg = ring.segs[s];
      for (int g = sg.g0; g < sg.g1; g += kBwdChunk) {
        const TV* chunk = ring.acquire();
        chunk_product(da_s, DS, g, chunk, ring.H, sg, items, ctiles, acc);
      }
    }
#pragma unroll
    for (int i = 0; i < kBwdMaxItems; ++i) {
      const int it = warp + i * kChainWarps;
      if (it < items) {
        const int n = kBwdTile * (it % ctiles) + 2 * lane, r0 = 8 * (it / ctiles);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (r0 + r < rows) {
            *reinterpret_cast<float2*>(part + (size_t)(r0 + r) * pw + n) =
                make_float2(acc[i][r][0], acc[i][r][1]);
          }
        }
      }
    }
  }
}

// a peer CTA's shared-memory address (32 bits) of the same place as `a`
// in this CTA's, and a float load from it through distributed shared memory
__device__ __forceinline__ unsigned peer_addr(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_peer(unsigned a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
  return v;
}

// the C partials of one value (this CTA's `part + off` in each peer), 8
// loads in flight at a time, summed in rank order
__device__ __forceinline__ float peer_sum(const float* part, size_t off, int C) {
  const unsigned a = smem_u32(part + off);
  float sum = 0.0f;
  for (int p0 = 0; p0 < C; p0 += 8) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = p0 + k < C ? ld_peer(peer_addr(a, p0 + k)) : 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (p0 + k < C) sum += v[k];
    }
  }
  return sum;
}

// What a chain CTA carries from stage to stage: the cluster, the ring, the
// partial buffers and the da tile, its rows, and the barrier state.
template <typename TV>
struct BwdCta {
  cg::cluster_group cluster;
  BwdRing<TV> ring;
  float* part;      // nbuf buffers of part_stride floats
  float* da_s;      // (round16(rows), DS)
  int part_stride, DS, C, c, H, Hc, B, rows, row0, nbuf, buf;
  bool first;
  // the CTA's (row, unit) pairs (rows * Hc) and its rows below B, in
  // shared memory: read anew in each step, so that the tests of a thread's
  // pairs are not held in registers (predicates) over the whole loop
  const int* lim_s;
  __device__ __forceinline__ int npairs() const { return ((const volatile int*)lim_s)[0]; }
  __device__ __forceinline__ int real_rows() const { return ((const volatile int*)lim_s)[1]; }
  // E: the fed-back probs' grads of the cluster's rows, rows * D
  __device__ __forceinline__ int fed() const { return ((const volatile int*)lim_s)[2]; }

  // before a stage's product writes its partial buffer
  __device__ __forceinline__ float* begin_stage() {
    __syncthreads();  // the da tile is written
    if (nbuf == 1 && !first) cluster_wait();  // every peer has read the buffer
    first = false;
    return part + buf * part_stride;
  }
  // after it: every CTA's partials are complete
  __device__ __forceinline__ void exchange() {
    cluster_arrive();
    cluster_wait();
  }
  // after the reduction that read the buffer
  __device__ __forceinline__ void end_stage() {
    if (nbuf == 1) cluster_arrive();
    buf ^= nbuf - 1;
  }
  // before the CTA leaves: no peer reads its buffers any more
  __device__ __forceinline__ void finish() {
    if (nbuf == 2) cluster_arrive();
    cluster_wait();
  }
};

// One layer's reverse step at time t for the CTA's pairs (E1, S1, R1, S2,
// R2 of the note). gates (T, B, 3H), hprev (T, B, H); dacat (T, B, 3H)
// float gets the gate grads rounded as TG, and with kDxp dxp (T, B, 3H)
// the same grads rounded once to TV (kernel G's bf16 build: its dxp, from
// the same stores); dh: the pairs' carries (d_seq added by the caller),
// replaced by dh_{t-1}. Segments s0 (S1), s0 + 1 ..
// s0 + nseg2 (S2, pw2 columns). kDxOwn: the own units' columns [H, 2H) of
// S2 summed into dx_own (E's layer 2 into layer 1's dh); kDxFed: columns
// [H, H + D) of S2 summed whole for the cluster's rows into dxf_s (rows, D)
// (E's layer 1: the fed-back probs).
template <typename TV, typename TG, bool kDxOwn, bool kDxFed, bool kDxp = false, bool kSeg = false>
__device__ __forceinline__ void gru_layer_bwd_step(BwdCta<TV>& x, const float* __restrict__ gates,
                                                   const TV* __restrict__ hprev,
                                                   float* __restrict__ dacat, int t, int s0,
                                                   int nseg2, int pw2,
                                                   float (&dh)[kBwdMaxPairs],
                                                   float (&dx_own)[kBwdMaxPairs], float* dxf_s,
                                                   int D, TV* __restrict__ dxp = nullptr) {
  const int H = x.H, Hc = x.Hc, c = x.c, G3 = 3 * H, DS = x.DS, npairs = x.npairs();
  const int real = x.real_rows();
  // what R1 needs of E1, per pair: r and h r (1 - r); dh is replaced by
  // dh z, the first term of dh_{t-1}
  float rv[kBwdMaxPairs], hr[kBwdMaxPairs];
  // E1
#pragma unroll
  for (int i = 0; i < kBwdMaxPairs; ++i) {
    const int p = threadIdx.x + i * kChainThreads;
    if (p >= npairs) continue;
    const int r = p / Hc, u = p % Hc, row = x.row0 + r, unit = c * Hc + u;
    float da = 0.0f, da_z = 0.0f;
    rv[i] = hr[i] = 0.0f;
    if (r < real) {
      const size_t o = ((size_t)t * x.B + row) * G3 + unit;
      const float z = gates[o], rg = gates[o + H], hh = gates[o + 2 * H];
      const float h = to_f32(hprev[((size_t)t * x.B + row) * H + unit]);
      rv[i] = rg;
      hr[i] = h * rg * (1.0f - rg);
      da = dh[i] * (1.0f - z) * (1.0f - hh * hh);
      da_z = dh[i] * (h - hh) * z * (1.0f - z);
      dh[i] *= z;
      dacat[o] = round_as<TG>(da_z);
      dacat[o + 2 * H] = round_as<TG>(da);
      if constexpr (kDxp) {
        dxp[o] = from_f32<TV>(da_z);
        dxp[o + 2 * H] = from_f32<TV>(da);
      }
    }
    x.da_s[r * DS + u] = da_z;
    x.da_s[r * DS + 2 * Hc + u] = da;
  }
  // S1, R1
  float* part = x.begin_stage();
  stage_product<TV, kSeg>(x.ring, s0, s0 + 1, x.da_s, DS, part, H, x.rows);
  x.exchange();
#pragma unroll
  for (int i = 0; i < kBwdMaxPairs; ++i) {
    const int p = threadIdx.x + i * kChainThreads;
    if (p >= npairs) continue;
    const int r = p / Hc, u = p % Hc, row = x.row0 + r;
    const float drh = peer_sum(part, (size_t)r * H + c * Hc + u, x.C);
    const float da_r = drh * hr[i];
    x.da_s[r * DS + Hc + u] = da_r;
    if (r < real) {
      const size_t o = ((size_t)t * x.B + row) * G3 + H + c * Hc + u;
      dacat[o] = round_as<TG>(da_r);
      if constexpr (kDxp) dxp[o] = from_f32<TV>(da_r);
    }
    dh[i] += drh * rv[i];
  }
  x.end_stage();
  // S2, R2
  part = x.begin_stage();
  stage_product<TV, kSeg>(x.ring, s0 + 1, s0 + 1 + nseg2, x.da_s, DS, part, pw2, x.rows);
  x.exchange();
#pragma unroll
  for (int i = 0; i < kBwdMaxPairs; ++i) {
    const int p = threadIdx.x + i * kChainThreads;
    if (p >= npairs) continue;
    const size_t off = (size_t)(p / Hc) * pw2 + c * Hc + p % Hc;
    dh[i] += peer_sum(part, off, x.C);
    if constexpr (kDxOwn) dx_own[i] += peer_sum(part, off + H, x.C);
  }
  if constexpr (kDxFed) {
    const int fed = x.fed();
    for (int i = threadIdx.x; i < fed; i += blockDim.x) {
      dxf_s[i] = peer_sum(part, (size_t)(i / D) * pw2 + H + i % D, x.C);
    }
  }
  x.end_stage();
}

// The chain CTA's shared memory in bytes (ops/_layout.py's gru_bptt_smem
// computes the same): the ring (stages chunks of kBwdChunk x H values of
// `elem` bytes, H + kBwdSlicePad in bf16), nbuf partial buffers of
// part_floats, the da tile (round16(rows_max), 3 Hc) and, for a head (D_max
// > 0), Wo's own rows (Hc, D_max), the dlogits and the fed-back probs' grad
// (rows_max, D_max) each.
__host__ __device__ constexpr size_t gru_bptt_smem(int H, int C, int rows_max, size_t part_floats,
                                                   int nbuf, int stages, int elem, int D_max) {
  const size_t Hc = H / C;
  return (size_t)stages * kBwdChunk * (H + (elem == 2 ? kBwdSlicePad : 0)) * elem +
         (size_t)nbuf * part_floats * 4 + (size_t)round16(rows_max) * 3 * Hc * 4 +
         (D_max > 0 ? (Hc * D_max + 2 * (size_t)rows_max * D_max) * 4 : 0);
}

// the checks every chain launch shares: the width, the cluster, a CTA's
// pairs and product tiles at rows and the widest partial pw (tiles of 8 rows
// x 64 units in float, 16 x 32 on the tensor cores in bf16; pw the widest
// segment's columns in the per-segment instance), the ring
inline bool chain_ok(int H, int cluster, int rows, int pw, int nbuf, int stages, int n,
                     bool mma) {
  if (H < kBwdTile || H % kBwdTile != 0 || cluster < 1 || cluster > kMaxCluster ||
      H % cluster != 0 || rows < 1 || nbuf < 1 || nbuf > 2 || stages < 1) {
    return false;
  }
  const int Hc = H / cluster;
  if (Hc % kBwdChunk != 0 || rows * Hc > kBwdMaxPairs * kChainThreads ||
      (mma ? (rows + 15) / 16 * (pw / kBwdTileMma) : (rows + 7) / 8 * (pw / kBwdTile)) >
          kBwdMaxItems * kChainWarps) {
    return false;
  }
  return n <= stages || (stages >= 2 && stages <= 8);
}

// ---------------------------------------------------------------------------
// Kernel C's chain: one encoder layer
// ---------------------------------------------------------------------------

template <typename TV>
struct GruBwdChainArgs {
  const float* gates;  // (T, B, 3H), the pre-pass's [z, r, hh]
  const TV* hprev;     // (T, B, H) [h0, hseq[:-1]]
  const TV* d_seq;     // (T, B, H) or null
  const TV* d_final;   // (B, H) or null
  const TV* ut;        // U^T (3H, H)
  float* dacat;        // (T, B, 3H)
  TV* dh0;             // (B, H)
  int T, B, H, rows, nbuf, stages;
  TV* dxp = nullptr;   // (T, B, 3H): kernel G's bf16 instance (kDxp) alone
};

// chunks of a step: U_h^T's Hc rows, then U_zr^T's 2 Hc
__host__ __device__ constexpr int layer_chunks(int Hc) { return 3 * Hc / kBwdChunk; }

// Grid: clusters * C CTAs of kChainThreads, cluster dims (C, 1, 1). kDxp:
// also a.dxp, the gate grads rounded once to TV (kernel G's bf16 build).
template <typename TV, bool kDxp = false>
__global__ void __launch_bounds__(kChainThreads, 1) gru_bwd_chain_kernel(
    const GruBwdChainArgs<TV> a) {
  extern __shared__ __align__(16) unsigned char gru_bwd_smem[];
  __shared__ BwdSeg<TV> segs[2];
  __shared__ int lim_s[2];
  BwdCta<TV> x{cg::this_cluster()};
  x.C = (int)x.cluster.num_blocks();
  x.c = (int)x.cluster.block_rank();
  x.H = a.H;
  x.Hc = a.H / x.C;
  x.B = a.B;
  x.rows = a.rows;
  x.row0 = (blockIdx.x / x.C) * a.rows;
  x.lim_s = lim_s;
  x.DS = 3 * x.Hc;
  x.nbuf = a.nbuf;
  x.buf = 0;
  x.first = true;
  const int H = a.H, Hc = x.Hc, tid = threadIdx.x;
  // shared memory: the ring | the partial buffers (rows, H) | the da tile
  const size_t ring_bytes = (size_t)a.stages * kBwdChunk * slice_ld<TV>(H) * sizeof(TV);
  x.part = reinterpret_cast<float*>(gru_bwd_smem + ring_bytes);
  x.part_stride = a.rows * H;
  x.da_s = x.part + a.nbuf * x.part_stride;
  if (tid == 0) {
    lim_s[0] = a.rows * Hc;
    lim_s[1] = min(a.rows, a.B - x.row0);
    segs[0] = BwdSeg<TV>{a.ut, H, 2 * Hc, 3 * Hc, 0};
    segs[1] = BwdSeg<TV>{a.ut, H, 0, 2 * Hc, 0};
  }
  for (int i = tid; i < round16(a.rows) * x.DS; i += blockDim.x) x.da_s[i] = 0.0f;
  __syncthreads();
  const int n = layer_chunks(Hc);
  x.ring = BwdRing<TV>{reinterpret_cast<TV*>(gru_bwd_smem), segs, n, a.stages, a.T * n, 0, H, Hc,
                       x.c};
  x.ring.start();

  float dh[kBwdMaxPairs];
#pragma unroll
  for (int i = 0; i < kBwdMaxPairs; ++i) {
    const int p = tid + i * kChainThreads;
    const int row = x.row0 + p / Hc, unit = x.c * Hc + p % Hc;
    dh[i] = (p < a.rows * Hc && row < a.B && a.d_final != nullptr)
                ? to_f32(a.d_final[(size_t)row * H + unit]) : 0.0f;
  }
  for (int t = a.T - 1; t >= 0; --t) {
    if (a.d_seq != nullptr) {
#pragma unroll
      for (int i = 0; i < kBwdMaxPairs; ++i) {
        const int p = tid + i * kChainThreads;
        const int row = x.row0 + p / Hc, unit = x.c * Hc + p % Hc;
        if (p < a.rows * Hc && row < a.B) dh[i] += to_f32(a.d_seq[((size_t)t * a.B + row) * H + unit]);
      }
    }
    gru_layer_bwd_step<TV, float, false, false, kDxp>(x, a.gates, a.hprev, a.dacat, t, 0, 1, H,
                                                      dh, dh, nullptr, 0, a.dxp);
  }
  x.finish();
#pragma unroll
  for (int i = 0; i < kBwdMaxPairs; ++i) {
    const int p = tid + i * kChainThreads;
    const int row = x.row0 + p / Hc, unit = x.c * Hc + p % Hc;
    if (p < a.rows * Hc && row < a.B) a.dh0[(size_t)row * H + unit] = from_f32<TV>(dh[i]);
  }
}

// static shared memory a chain kernel may hold beside its dynamic (the
// segments, E's head; ops/_layout.py's GRU_BWD_SMEM leaves it out)
constexpr size_t kBwdStaticSmem = 1024;

template <typename Kernel, typename Args>
int launch_cluster_kernel(Kernel kernel, const Args& a, int grid, int cluster, size_t smem,
                          void* stream) {
  if (smem + kBwdStaticSmem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cluster_config(kernel, cluster, smem);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch l(grid, cluster, smem, stream);
  err = cudaLaunchKernelEx(&l.cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// C's chain at the plan of ops/_layout.py::gru_bptt_plan (cluster size,
// rows a cluster, partial buffers, ring slots); cudaErrorInvalidValue for a
// plan the build does not run. kDxp: the instance that also emits a.dxp.
template <typename TV, bool kDxp = false>
int launch_gru_bwd_chain(const GruBwdChainArgs<TV>& a, int cluster, void* stream) {
  if (a.T < 1 || a.B < 1 || (kDxp && a.dxp == nullptr) ||
      !chain_ok(a.H, cluster, a.rows, a.H, a.nbuf, a.stages, layer_chunks(a.H / cluster),
                std::is_same_v<TV, bf16>)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = gru_bptt_smem(a.H, cluster, a.rows, (size_t)a.rows * a.H, a.nbuf, a.stages,
                                    sizeof(TV), 0);
  return launch_cluster_kernel(gru_bwd_chain_kernel<TV, kDxp>, a,
                               (a.B + a.rows - 1) / a.rows * cluster,
                               cluster, smem, stream);
}

// ---------------------------------------------------------------------------
// Kernel E's chain: decode heads of one or two layers, several in a launch
// ---------------------------------------------------------------------------

constexpr int kMaxHeads = 4;

// one head of a launch, (T, B, .) sequences time-major; the layer-2 fields
// are unused (may be null) for 1-layer heads. Mirrored by _HeadBwdChain in
// ops/gru_decode.py.
template <typename TV>
struct HeadBwdChain {
  const float *gates1, *gates2;           // (T, B, 3H), the pre-pass's [z, r, hh]
  const TV *hprev1, *hprev2;              // (T, B, H): [h_0, h[:-1]] of each layer
  const TV *probs, *g_probs, *g_logits;   // (T, B, D)
  const TV *u1t, *w1t, *u2t, *w2t;        // U^T (3H, H), W1^T (3H, Dp) zero-padded, W2^T (3H, H)
  const TV* wo;                           // (H, D)
  float *dlogits, *da1, *da2;             // (T, B, D), (T, B, 3H)
  TV *d_h1_0, *d_h2_0, *d_start;          // (B, H), (B, D)
  int D, Dp, n_layers, out_act, T, rows, clusters;
};

template <typename TV>
struct HeadsBwdChain {
  HeadBwdChain<TV> h[kMaxHeads];
  int n_heads, B, H, nbuf, stages, rows_max, D_max;
  size_t part_floats;
};

// chunks of a step and the widest partial of a head
__host__ __device__ constexpr int head_chunks(int Hc, int n_layers) {
  return n_layers * 6 * Hc / kBwdChunk;  // S1: Hc, S2: 2 Hc of U^T and 3 Hc of W^T a layer
}
__host__ __device__ constexpr int head_pw(int H, int Dp, int n_layers) {
  return n_layers == 2 ? 2 * H : H + Dp;
}

// Grid: the heads' clusters * C CTAs of kChainThreads, cluster dims (C, 1,
// 1); head k's clusters follow head k-1's. TG: the type the emitted dlogits
// and gate grads are rounded as (float, or bf16 in E wide's bf16 build).
template <typename TV, typename TG, bool kSeg = false>
__global__ void __launch_bounds__(kChainThreads, 1) gru_head_bwd_chain_kernel(
    const HeadsBwdChain<TV> hs) {
  extern __shared__ __align__(16) unsigned char gru_bwd_smem[];
  __shared__ BwdSeg<TV> segs[kBwdMaxSegs];
  __shared__ HeadBwdChain<TV> a;
  __shared__ int row0_s, lim_s[3];
  BwdCta<TV> x{cg::this_cluster()};
  x.C = (int)x.cluster.num_blocks();
  x.c = (int)x.cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the CTA's head and its cluster within the head (constant indices: the
  // heads stay in the parameter space)
  int cl = blockIdx.x / x.C, hid = 0;
#pragma unroll
  for (int k = 0; k + 1 < kMaxHeads; ++k) {
    if (hid == k && k + 1 < hs.n_heads && cl >= hs.h[k].clusters) {
      cl -= hs.h[k].clusters;
      hid = k + 1;
    }
  }
  if (tid == 0) {
    switch (hid) {
      case 0: a = hs.h[0]; break;
      case 1: a = hs.h[1]; break;
      case 2: a = hs.h[2]; break;
      default: a = hs.h[3]; break;
    }
  }
  const int H = hs.H, B = hs.B, Hc = H / x.C;
  x.H = H;
  x.Hc = Hc;
  x.B = B;
  x.DS = 3 * Hc;
  x.nbuf = hs.nbuf;
  x.buf = 0;
  x.first = true;
  // shared memory: the ring | the partial buffers | the da tile | Wo's own
  // rows (Hc, D) | dlogits (rows, D) | the fed-back probs' grad (rows, D)
  const size_t ring_bytes = (size_t)hs.stages * kBwdChunk * slice_ld<TV>(H) * sizeof(TV);
  x.part = reinterpret_cast<float*>(gru_bwd_smem + ring_bytes);
  x.part_stride = (int)hs.part_floats;
  x.da_s = x.part + hs.nbuf * hs.part_floats;
  float* wo_s = x.da_s + (size_t)round16(hs.rows_max) * x.DS;
  float* dl_s = wo_s + (size_t)Hc * hs.D_max;
  float* dxf_s = dl_s + (size_t)hs.rows_max * hs.D_max;
  __syncthreads();  // the head's fields
  const int D = a.D, T = a.T, rows = a.rows, c = x.c;
  const bool two = a.n_layers == 2;
  x.rows = rows;
  x.row0 = cl * rows;
  x.lim_s = lim_s;
  if (tid == 0) {
    row0_s = x.row0;
    lim_s[0] = rows * Hc;
    lim_s[1] = min(rows, B - x.row0);
    lim_s[2] = rows * D;
  }
  // segments: layer 2's S1 and S2 (U_zr^T, W2^T), then layer 1's
  if (tid == 0) {
    int s = 0;
    if (two) {
      segs[s++] = BwdSeg<TV>{a.u2t, H, 2 * Hc, 3 * Hc, 0};
      segs[s++] = BwdSeg<TV>{a.u2t, H, 0, 2 * Hc, 0};
      segs[s++] = BwdSeg<TV>{a.w2t, H, 0, 3 * Hc, H};
    }
    segs[s++] = BwdSeg<TV>{a.u1t, H, 2 * Hc, 3 * Hc, 0};
    segs[s++] = BwdSeg<TV>{a.u1t, H, 0, 2 * Hc, 0};
    segs[s++] = BwdSeg<TV>{a.w1t, a.Dp, 0, 3 * Hc, H};
  }
  for (int i = tid; i < Hc * D; i += blockDim.x) wo_s[i] = to_f32(a.wo[(size_t)c * Hc * D + i]);
  for (int i = tid; i < rows * D; i += blockDim.x) dxf_s[i] = 0.0f;
  for (int i = tid; i < round16(rows) * x.DS; i += blockDim.x) x.da_s[i] = 0.0f;
  __syncthreads();
  const int n = head_chunks(Hc, a.n_layers);
  x.ring = BwdRing<TV>{reinterpret_cast<TV*>(gru_bwd_smem), segs, n, hs.stages, T * n, 0, H, Hc,
                       c};
  x.ring.start();
  const int L1 = two ? 3 : 0;  // layer 1's first segment

  float dh1[kBwdMaxPairs], dh2[kBwdMaxPairs];
#pragma unroll
  for (int i = 0; i < kBwdMaxPairs; ++i) dh1[i] = dh2[i] = 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    __syncthreads();  // dxf_s holds the previous step's sums
    // dlogits, one warp a row: gp_total = g_probs + dx_fed, through the
    // output activation (softmax reduced over the D columns), + g_logits
    for (int r = warp; r < rows; r += kChainWarps) {
      const int row = x.row0 + r;
      float* dl = dl_s + (size_t)r * D;
      const float* dxf = dxf_s + (size_t)r * D;
      if (row >= B) {
        for (int d = lane; d < D; d += 32) dl[d] = 0.0f;
        continue;
      }
      const size_t base = ((size_t)t * B + row) * D;
      float s = 0.0f;
      if (a.out_act == kSoftmax) {
        for (int d = lane; d < D; d += 32) {
          s += (to_f32(a.g_probs[base + d]) + dxf[d]) * to_f32(a.probs[base + d]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      }
      for (int d = lane; d < D; d += 32) {
        const float p = to_f32(a.probs[base + d]);
        const float gp = to_f32(a.g_probs[base + d]) + dxf[d];
        float v = a.out_act == kSoftmax ? p * (gp - s)
                  : a.out_act == kSigmoid ? gp * p * (1.0f - p) : gp;
        v += to_f32(a.g_logits[base + d]);
        dl[d] = v;
        if (c == 0) a.dlogits[base + d] = round_as<TG>(v);
      }
    }
    __syncthreads();
    // the top layer's dh: dlogits . Wo^T over the CTA's own units, plus
    // its carry
    const int npairs = x.npairs();
#pragma unroll
    for (int i = 0; i < kBwdMaxPairs; ++i) {
      const int p = tid + i * kChainThreads;
      if (p >= npairs) continue;
      const float* dl = dl_s + (size_t)(p / Hc) * D;
      const float* wr = wo_s + (size_t)(p % Hc) * D;
      float s = 0.0f;
      for (int d = 0; d < D; ++d) s = fmaf(dl[d], wr[d], s);
      if (two) {
        dh2[i] += s;
      } else {
        dh1[i] += s;
      }
    }
    if (two) {
      gru_layer_bwd_step<TV, TG, true, false, false, kSeg>(x, a.gates2, a.hprev2, a.da2, t, 0, 2,
                                                           2 * H, dh2, dh1, nullptr, 0);
    }
    gru_layer_bwd_step<TV, TG, false, true, false, kSeg>(x, a.gates1, a.hprev1, a.da1, t, L1, 2,
                                                         H + a.Dp, dh1, dh1, dxf_s, D);
  }
  x.finish();
  __syncthreads();  // dxf_s
  // the head's fields and the CTA's rows read anew from shared memory: none
  // of them stays in a register over the loop for this epilogue
  const volatile HeadBwdChain<TV>& av = a;
  const int rows_e = av.rows, D_e = av.D, row0_e = *(volatile int*)&row0_s;
  const int c_e = (int)cg::this_cluster().block_rank();
  if (c_e == 0) {
    for (int i = tid; i < rows_e * D_e; i += blockDim.x) {
      const int row = row0_e + i / D_e;
      if (row < B) av.d_start[(size_t)row * D_e + i % D_e] = from_f32<TV>(dxf_s[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kBwdMaxPairs; ++i) {
    const int p = tid + i * kChainThreads;
    const int row = row0_e + p / Hc, unit = c_e * Hc + p % Hc;
    if (p < rows_e * Hc && row < B) {
      av.d_h1_0[(size_t)row * H + unit] = from_f32<TV>(dh1[i]);
      if (av.n_layers == 2) av.d_h2_0[(size_t)row * H + unit] = from_f32<TV>(dh2[i]);
    }
  }
}

// E's chain over `heads` at the plan of ops/_layout.py::gru_head_bwd_plan
// (cluster size, each head's rows and clusters, partial buffers, ring
// slots); cudaErrorInvalidValue for a plan the build does not run. The bf16
// build takes its per-segment instance (kSeg) only where a head's partial
// has more product tiles than the CTA's warps hold (ops/_layout.py::
// _most_rows): every other launch keeps the instance it had.
template <typename TV, typename TG>
int launch_gru_head_bwd_chain(const HeadBwdChain<TV>* heads, int n_heads, int B, int H,
                              int cluster, int nbuf, int stages, void* stream) {
  constexpr bool kMma = std::is_same_v<TV, bf16>;
  if (n_heads < 1 || n_heads > kMaxHeads || B < 1) return (int)cudaErrorInvalidValue;
  bool seg = false;
  HeadsBwdChain<TV> hs{};
  hs.n_heads = n_heads;
  hs.B = B;
  hs.H = H;
  hs.nbuf = nbuf;
  hs.stages = stages;
  int clusters = 0;
  for (int k = 0; k < n_heads; ++k) {
    const HeadBwdChain<TV>& a = heads[k];
    const int pw = head_pw(H, a.Dp, a.n_layers);
    if (a.T < 1 || a.D < 1 || a.Dp < a.D || a.Dp % kBwdTile != 0 || a.Dp > H ||
        (a.n_layers != 1 && a.n_layers != 2) ||
        (a.out_act != kSoftmax && a.out_act != kSigmoid && a.out_act != kLinear) ||
        a.clusters != (B + a.rows - 1) / a.rows) {
      return (int)cudaErrorInvalidValue;
    }
    const int n = H % cluster ? 0 : head_chunks(H / cluster, a.n_layers);
    if (!chain_ok(H, cluster, a.rows, pw, nbuf, stages, n, kMma)) {
      // the widest segment: H columns (U^T's, and W2^T's), Dp <= H
      if (!kMma || !chain_ok(H, cluster, a.rows, H, nbuf, stages, n, kMma)) {
        return (int)cudaErrorInvalidValue;
      }
      seg = true;
    }
    hs.h[k] = a;
    clusters += a.clusters;
    hs.rows_max = std::max(hs.rows_max, a.rows);
    hs.D_max = std::max(hs.D_max, a.D);
    hs.part_floats = std::max(hs.part_floats, (size_t)a.rows * pw);
  }
  const size_t smem = gru_bptt_smem(H, cluster, hs.rows_max, hs.part_floats, nbuf, stages,
                                    sizeof(TV), hs.D_max);
  if constexpr (kMma) {
    if (seg) {
      return launch_cluster_kernel(gru_head_bwd_chain_kernel<TV, TG, true>, hs,
                                   clusters * cluster, cluster, smem, stream);
    }
  }
  return launch_cluster_kernel(gru_head_bwd_chain_kernel<TV, TG>, hs, clusters * cluster, cluster,
                               smem, stream);
}

// cudaOccupancyMaxActiveClusters of a chain kernel at `cluster` CTAs a
// cluster, each with all the dynamic shared memory it may take beside its
// static (one CTA an SM)
template <typename Kernel>
int bwd_max_clusters(Kernel kernel, int cluster, int* out) {
  const size_t smem = 232448 - kBwdStaticSmem;
  cudaError_t err = cluster_config(kernel, cluster, smem);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch l(cluster, cluster, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &l.cfg);
}

}  // namespace mvt
