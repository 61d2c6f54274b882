// Shared device code of the LSTM backward kernels (N: lstm_layer_bwd.cu, R:
// lstm_layer_xp_bwd.cu): the backward through time of one tanh LSTM layer,
// in three phases.
//
// Math (midi_vae_tpu/ops/fused_train.py::_lstm_bwdx_kernel :2429-2464,
// _lstm_bwd_kernel :1405-1440 and _lstm_bwd_wide_kernel :1944-1976), with
// h = h_{t-1}, c_p = c_{t-1}:
//   [i, f, g, o] = sig, sig, tanh, sig of xp_t + h.U;  tc = tanh(c_t)
//   dc  = dc_carry + dh*o*(1 - tc^2)
//   da  = [dc*g*i(1-i), dc*c_p*f(1-f), dc*i*(1-g^2), dh*tc*o(1-o)]
//   dh_{t-1} = da.U^T;   dc_{t-1} = dc*f
// Only tanh's derivative is written here, as in the TPU kernels
// (_lstm_x_use_pallas and _lstm_mode send other cell activations to the
// plain scan). The weight gradients are not summed here: kernel W
// (grad_reduce.cu) reduces dW = x^T.da, db and dU = h_{t-1}^T.da over all
// T*B rows afterwards.
//
// The TPU kernels run one grid step per time step, so they recompute the
// gates inside the serial loop. Of a reverse step only dh_{t-1} = da.U^T
// feeds the next one: the gates read h_{t-1} from the forward's stored
// sequence, and dx = da.W^T feeds nothing. So on the H100 the layer runs
// as three kernels:
//
// 1. The gate pre-pass, parallel over all T*B rows: act = [sig(i), sig(f),
//    tanh(g), sig(o)] of xp + h_prev.U (R) or x.W + b + h_prev.U (N),
//    h_prev = [h0, hseq[:-1]], into a float32 scratch (T, B, 4H), 128 x 128
//    output tiles a block. The float build, lstm_bwd_gates_kernel, is a
//    tiled FFMA product (8 x 8 a thread, two shared-memory stages). The
//    bf16 build, lstm_bwd_gates_mma_kernel, takes the bf16 operands to the
//    tensor cores (mma.sync m16n8k16, float accumulators): the products of
//    bf16 values summed in float, the Pallas kernel's _dot with
//    preferred_element_type=float32, in another order; the velocity
//    layer's cast_x (D < 8, W in float32) multiplies the same numbers.
//    Bound by its operations: 2 T B (D + H) 4H at the FFMA rate in float,
//    at the tensor-core rate in bf16.
//
// 2. lstm_bwd_chain_kernel, the serial chain, on thread-block clusters.
//    One cluster owns `rows` batch rows for the whole reverse loop; its C
//    CTAs split the H hidden units, so CTA c owns units [c Hc, (c+1) Hc),
//    Hc = H / C, and their 4 Hc gate columns. Each CTA keeps its slice of
//    U (those 4 Hc gate columns, H units) in shared memory for all T steps:
//    128 KiB for f32 at H = 256 (C = 8), bf16 at 256 (C = 4) and bf16 at
//    512 (C = 16, a non-portable cluster size). Per reverse step:
//      E  the gate-grad math of the CTA's own (unit, row) pairs: da and dc
//         from act, c_t, c_{t-1} and the carries (float registers), da into
//         shared memory (rows, 4 Hc) and out to the gate-grad streams;
//      G  the CTA's partial dh over its own gate rows, for all H units:
//         part (rows, H) = da (rows, 4 Hc) . U slice^T (4 Hc, H);
//      a cluster barrier, then
//      Rd each CTA sums the C partials of its own units through distributed
//         shared memory in a fixed peer order (rank 0 to C-1), so a run
//         gives the same bits as the next: dh_{t-1} of its pairs.
//    da stays float32 whatever the build: the reference multiplies the
//    float32 da by U (_dot_t(da, u)). The float build's G is FFMA over
//    U^T rows (2 units x 8 rows a thread, da read as float4 broadcasts).
//    The bf16 build's U is exactly bf16, so its G runs on the tensor cores
//    with da split into three bf16 terms (their sum is da to 2^-27) and
//    each step's 48 products summed in float (chain_product_mma): one
//    bf16 rounding of da would compute another function (chip_smoke.py
//    holds that rounding as a control). The dh and dc carries stay
//    float32. The next step's act, c and incoming dh are loaded into
//    registers right after the current step's E, so their latency hides
//    behind G and the barrier. Where two partial buffers fit, step t
//    writes one and step t-1 the other, and one cluster barrier a step
//    suffices; else a second, split barrier (arrive after Rd, wait before
//    the next G) keeps a peer from overwriting a buffer still read. Float32
//    at H = 512 does not fit (its slice is 256 KiB at C = 16): that build
//    streams its slice from L2 at every step, in chunks of 16 gate rows
//    through a cp.async ring of 2 to 8 chunks that runs on across the step
//    boundary (the STREAM instance). Bound by the serial chain: T steps of
//    rows x 4 Hc x H multiply-adds per CTA and a cluster barrier.
//
// 3. lstm_bwd_dx_kernel (N only), parallel over all T*B rows after the
//    chain: dx = da.W^T with the float32 da, FFMA (gemm_tile), rounded once
//    to the build's type. R's dx = dxp.W^T stays outside any kernel, as in
//    the JAX package.
//
// Every kernel launches on the caller's stream and allocates nothing: the
// wrappers (midi_vae_tpu_torch/ops/lstm_layer.py) allocate the scratch and
// choose the cluster plan (ops/_layout.py::bptt_plan).
#pragma once

#include "lstm_cluster.cuh"

namespace mvt {

// ---------------------------------------------------------------------------
// The tiled product of phases 1 and 3
// ---------------------------------------------------------------------------

constexpr int kGemmThreads = 256;
constexpr int kGemmTile = 128;  // rows and columns of a block's output tile
constexpr int kGemmK = 8;       // depth of one shared-memory stage

// The rows of a row-major (M, K) operand: rows below `split` from a0, the
// others from a1 shifted up by `split` rows ([h0, hseq[:-1]] with split = B;
// a plain matrix with split = M).
template <typename T>
struct RowsA {
  const T* a0;
  const T* a1;
  int split;
  int K;
  __device__ __forceinline__ float at(int m, int k) const {
    return m < split ? to_f32(a0[(size_t)m * K + k])
                     : to_f32(a1[(size_t)(m - split) * K + k]);
  }
};

// acc += A[m0:m0+128, :K] . Bm[:K, n0:n0+128], Bm row-major (K, N); rows
// past M, columns past N and depths past K read as zeros. Thread t owns the
// output rows 4 ty + {0..3}, 64 + 4 ty + {0..3} and the columns
// 4 tx + {0..3}, 64 + 4 tx + {0..3} (tx = t % 16, ty = t / 16). As and Bs
// each hold two (8, 128) float stages in shared memory: the next stage's
// operands are loaded into registers while the current one is multiplied,
// one barrier a stage.
template <typename TA, typename TB>
__device__ __forceinline__ void gemm_tile(const RowsA<TA>& A, const TB* __restrict__ Bm,
                                          int M, int N, int K, int m0, int n0,
                                          float acc[8][8], float* As, float* Bs) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int ar = tid >> 1, ak = (tid & 1) * 4;   // A loads: row, first depth
  const int bk = tid >> 5, bn = (tid & 31) * 4;  // B loads: depth, first column
  float ra[4], rb[4];
  auto fetch = [&](int k0) {
    const int m = m0 + ar;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + ak + i;
      ra[i] = (m < M && k < K) ? A.at(m, k) : 0.0f;
    }
    const int k = k0 + bk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + bn + i;
      rb[i] = (k < K && n < N) ? to_f32(Bm[(size_t)k * N + n]) : 0.0f;
    }
  };
  auto stash = [&](int stage) {
    float* as = As + stage * kGemmK * kGemmTile;
#pragma unroll
    for (int i = 0; i < 4; ++i) as[(ak + i) * kGemmTile + ar] = ra[i];
    *reinterpret_cast<float4*>(Bs + stage * kGemmK * kGemmTile + bk * kGemmTile + bn) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
  };
  fetch(0);
  stash(0);
  __syncthreads();
  int stage = 0;
  for (int k0 = 0; k0 < K; k0 += kGemmK) {
    const bool more = k0 + kGemmK < K;
    if (more) fetch(k0 + kGemmK);
    const float* as = As + stage * kGemmK * kGemmTile;
    const float* bs = Bs + stage * kGemmK * kGemmTile;
#pragma unroll
    for (int kk = 0; kk < kGemmK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kGemmTile + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * kGemmTile + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kGemmTile + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * kGemmTile + 64 + 4 * tx);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    // the other stage was last read before the previous barrier
    if (more) stash(stage ^ 1);
    __syncthreads();
    stage ^= 1;
  }
}

// thread t's i-th output row and j-th output column of gemm_tile's tile
__device__ __forceinline__ int gemm_row(int i) {
  return (i < 4 ? 0 : 60) + 4 * (threadIdx.x >> 4) + i;
}
__device__ __forceinline__ int gemm_col(int j) {
  return (j < 4 ? 0 : 60) + 4 * (threadIdx.x & 15) + j;
}

// Phase 1. act (M = T*B, 4H) = the activations of
//   [xp or x.W + b] + h_prev.U,   h_prev row m = h0[m] (m < B), hseq[m - B];
// x (M, D), W (D, 4H), b (4H) when XW, else xp (M, 4H); U (H, 4H). Grid:
// (4H / 128, ceil(M / 128)).
template <typename TV, bool XW>
__global__ void __launch_bounds__(kGemmThreads) lstm_bwd_gates_kernel(
    const TV* __restrict__ xin, const TV* __restrict__ w, const TV* __restrict__ bias,
    const TV* __restrict__ hseq, const TV* __restrict__ h0, const TV* __restrict__ u,
    float* __restrict__ act, int M, int B, int D, int H) {
  __shared__ __align__(16) float As[2 * kGemmK * kGemmTile];
  __shared__ __align__(16) float Bs[2 * kGemmK * kGemmTile];
  const int G = 4 * H;
  const int n0 = blockIdx.x * kGemmTile, m0 = blockIdx.y * kGemmTile;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  if constexpr (XW) {
    gemm_tile(RowsA<TV>{xin, xin, M, D}, w, M, G, D, m0, n0, acc, As, Bs);
  }
  gemm_tile(RowsA<TV>{h0, hseq, B, H}, u, M, G, H, m0, n0, acc, As, Bs);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + gemm_row(i);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + gemm_col(j);
      float v = acc[i][j];
      if constexpr (XW) {
        v += to_f32(bias[n]);
      } else {
        v += to_f32(xin[(size_t)m * G + n]);
      }
      act[(size_t)m * G + n] = (n / H == 2) ? tanhf(v) : activate<kSigmoid>(v);
    }
  }
}

// Phase 1 of the bf16 builds, on the tensor cores: the same act from bf16
// operands, each product a bf16 x bf16 product summed in float
// (mma.sync m16n8k16, float accumulators), as the Pallas kernel's _dot with
// preferred_element_type=float32 computes it; only the order of the sums
// differs from the FFMA kernel's. The B operands come transposed, a row per
// output column: wt = W^T (4H, D), ut = U^T (4H, H). A block computes a
// (128, 128) tile with 8 warps of (64, 32); the operands pass through
// shared memory in stages of 32 depths, rows padded to 40 values so that
// the fragment loads hit 32 banks.
constexpr int kMmaK = 32;
constexpr int kMmaStride = kMmaK + 8;

// rows [r0, r0 + 128) x depths [k0, k0 + 32) of a row-major (rows, K) bf16
// operand into dst (128, kMmaStride); rows past `rows` and depths past K
// read as zeros. 16-byte copies where K is a multiple of 8 (a row that is
// not 16-byte aligned goes by value), else by value.
template <typename RowPtr>
__device__ __forceinline__ void mma_stage(RowPtr row_ptr, int rows, int K, int r0, int k0,
                                          bf16* dst) {
  if (K % 8 == 0) {
    for (int i = threadIdx.x; i < kGemmTile * kMmaK / 8; i += kGemmThreads) {
      const int r = i / (kMmaK / 8), kc = (i % (kMmaK / 8)) * 8;
      bf16* d = dst + r * kMmaStride + kc;
      if (r0 + r < rows && k0 + kc < K) {
        const bf16* p = row_ptr(r0 + r) + k0 + kc;
        if ((reinterpret_cast<size_t>(p) & 15) == 0) {
          *reinterpret_cast<int4*>(d) = *reinterpret_cast<const int4*>(p);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) d[e] = p[e];
        }
      } else {
        *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
      }
    }
  } else {
    for (int i = threadIdx.x; i < kGemmTile * kMmaK; i += kGemmThreads) {
      const int r = i / kMmaK, k = i % kMmaK;
      dst[r * kMmaStride + k] =
          (r0 + r < rows && k0 + k < K) ? row_ptr(r0 + r)[k0 + k] : __float2bfloat16_rn(0.0f);
    }
  }
}

// acc[mi][ni] += A (M, K) . Bt (N, K)^T over the block's tile; warp (wm, wn)
// owns rows 64 wm + 16 mi + {gid, gid + 8} and columns 32 wn + 8 ni + 2 tig
// + {0, 1} of it (gid = lane / 4, tig = lane % 4).
template <typename RowA>
__device__ __forceinline__ void mma_tile(RowA a_row, const bf16* __restrict__ bt, int M, int N,
                                         int K, int m0, int n0, float acc[4][4][4], bf16* As,
                                         bf16* Bs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3, gid = lane >> 2, tig = lane & 3;
  auto b_row = [&](int n) { return bt + (size_t)n * K; };
  for (int k0 = 0; k0 < K; k0 += kMmaK) {
    mma_stage(a_row, M, K, m0, k0, As);
    mma_stage(b_row, N, K, n0, k0, Bs);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMmaK; kk += 16) {
      unsigned af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const bf16* p = As + (64 * wm + 16 * mi + gid) * kMmaStride + kk + 2 * tig;
        af[mi][0] = ld_b32(p);
        af[mi][1] = ld_b32(p + 8 * kMmaStride);
        af[mi][2] = ld_b32(p + 8);
        af[mi][3] = ld_b32(p + 8 * kMmaStride + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const bf16* p = Bs + (32 * wn + 8 * ni + gid) * kMmaStride + kk + 2 * tig;
        bfr[ni][0] = ld_b32(p);
        bfr[ni][1] = ld_b32(p + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_bf16(acc[mi][ni], af[mi][0], af[mi][1], af[mi][2], af[mi][3], bfr[ni][0],
                   bfr[ni][1]);
        }
      }
    }
    __syncthreads();
  }
}

template <bool XW>
__global__ void __launch_bounds__(kGemmThreads) lstm_bwd_gates_mma_kernel(
    const bf16* __restrict__ xin, const bf16* __restrict__ wt, const bf16* __restrict__ bias,
    const bf16* __restrict__ hseq, const bf16* __restrict__ h0, const bf16* __restrict__ ut,
    float* __restrict__ act, int M, int B, int D, int H) {
  __shared__ __align__(16) bf16 As[kGemmTile * kMmaStride];
  __shared__ __align__(16) bf16 Bs[kGemmTile * kMmaStride];
  const int G = 4 * H;
  const int n0 = blockIdx.x * kGemmTile, m0 = blockIdx.y * kGemmTile;
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
    }
  }
  if constexpr (XW) {
    mma_tile([&](int m) { return xin + (size_t)m * D; }, wt, M, G, D, m0, n0, acc, As, Bs);
  }
  mma_tile([&](int m) { return m < B ? h0 + (size_t)m * H : hseq + (size_t)(m - B) * H; }, ut,
           M, G, H, m0, n0, acc, As, Bs);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + 64 * wm + 16 * mi + gid + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + 32 * wn + 8 * ni + 2 * tig;
        float v[2] = {acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] += XW ? to_f32(bias[n + e]) : to_f32(xin[(size_t)m * G + n + e]);
          v[e] = (n / H == 2) ? tanhf(v[e]) : activate<kSigmoid>(v[e]);
        }
        *reinterpret_cast<float2*>(act + (size_t)m * G + n) = make_float2(v[0], v[1]);
      }
    }
  }
}

// Phase 3. dx (M, D) = da (M, 4H) . W^T, wt = W^T (4H, D); rounded to TV.
// Grid: (ceil(D / 128), ceil(M / 128)).
template <typename TV>
__global__ void __launch_bounds__(kGemmThreads) lstm_bwd_dx_kernel(
    const float* __restrict__ da, const TV* __restrict__ wt, TV* __restrict__ dx, int M, int D,
    int H) {
  __shared__ __align__(16) float As[2 * kGemmK * kGemmTile];
  __shared__ __align__(16) float Bs[2 * kGemmK * kGemmTile];
  const int n0 = blockIdx.x * kGemmTile, m0 = blockIdx.y * kGemmTile;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  gemm_tile(RowsA<float>{da, da, M, 4 * H}, wt, M, D, 4 * H, m0, n0, acc, As, Bs);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + gemm_row(i);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + gemm_col(j);
      if (n < D) dx[(size_t)m * D + n] = from_f32<TV>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Phase 2: the serial chain on a cluster
// ---------------------------------------------------------------------------

// (unit, row) pairs a thread owns: Hc * rows <= kMaxPairs * kChainThreads
constexpr int kMaxPairs = 3;
// gate rows of U^T per streamed chunk (the STREAM instance)
constexpr int kStreamChunk = 16;
// the da tile's row stride is 4 Hc + kDaPad floats, so that the bf16
// build's 8-byte fragment loads of a half-warp hit 32 banks
constexpr int kDaPad = 8;

template <typename TV>
struct ChainArgs {
  const float* act;    // (T, B, 4H) activations i, f, g, o (phase 1)
  const TV* cseq;      // (T, B, H) the forward's c sequence
  const TV* c0;        // (B, H)
  const TV* d_seq;     // (T, B, H) or null
  const TV* d_final;   // (B, H) or null
  const TV* u;         // float: U^T (4H, H); bf16: U (H, 4H)
  float* dacat;        // (T, B, 4H) float gate grads, or null
  TV* dxp;             // (T, B, 4H) gate grads rounded to TV, or null
  TV* dh0;             // (B, H)
  TV* dc0;             // (B, H)
  int T, B, H;
  int rows;    // batch rows per cluster
  int splits;  // gate-row splits of G among the warps (each its partial)
  int nbuf;    // partial buffers: 2 (one barrier a step) or 1 (two)
  int stages;  // chunks in the streamed ring (the STREAM instance), >= 2
};

// two neighbouring units of one U^T row in shared memory, widened
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Shared memory of a chain CTA, in bytes: the U slice (or the `stages`
// chunks it streams through), the da tile (rows rounded up to 8, 4 Hc +
// kDaPad) and the partial buffers (nbuf * splits * rows * H floats).
// ops/_layout.py's chain_smem computes the same.
__host__ __device__ constexpr size_t chain_smem(int H, int C, int rows, int splits, int nbuf,
                                                int stages, bool stream, size_t elem) {
  return (stream ? (size_t)stages * kStreamChunk * H * 4 : (size_t)4 * (H / C) * H * elem) +
         (size_t)round8(rows) * (4 * (H / C) + kDaPad) * 4 +
         (size_t)nbuf * splits * rows * H * 4;
}

// Rows [g0, g0 + n) of the CTA's U^T slice (local gate row gl = q Hc + u is
// U^T row q H + c Hc + u) into dst (n, H), 16 bytes a copy: the float
// build's slice.
__device__ __forceinline__ void copy_slice(const float* __restrict__ ut, float* dst, int g0,
                                           int n, int H, int Hc, int c) {
  const int per_row = H / 4;
  for (int i = threadIdx.x; i < n * per_row; i += blockDim.x) {
    const int gl = g0 + i / per_row, piece = i % per_row;
    const int g = (gl / Hc) * H + c * Hc + gl % Hc;
    cp_async16(reinterpret_cast<char*>(dst + (size_t)(gl - g0) * H) + 16 * piece,
               reinterpret_cast<const char*>(ut + (size_t)g * H) + 16 * piece);
  }
}

// part (rows, H) [+]= da_s rows . slice rows [g_lo, g_hi) for warp tile
// (units k0 = 64 kt + 2 lane .. + 1, rows 8 rt .. + 7); slice points at gate
// row g_base of the resident slice or of a streamed chunk.
__device__ __forceinline__ void chain_product(const float* da_s, const float* slice, int g_base,
                                              int g_lo, int g_hi, int DS, int H, int rows,
                                              int kt, int rt, float* part, bool accumulate) {
  const int lane = threadIdx.x & 31;
  const int k0 = 64 * kt + 2 * lane, r0 = 8 * rt;
  float acc0[8], acc1[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const bool keep = accumulate && r0 + r < rows;
    const float2 p = keep ? *reinterpret_cast<const float2*>(part + (size_t)(r0 + r) * H + k0)
                          : make_float2(0.0f, 0.0f);
    acc0[r] = p.x;
    acc1[r] = p.y;
  }
  for (int g = g_lo; g < g_hi; g += 4) {
    float4 d[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) d[r] = *reinterpret_cast<const float4*>(da_s + (r0 + r) * DS + g);
#pragma unroll
    for (int gg = 0; gg < 4; ++gg) {
      const float2 u2 = load_pair(slice + (size_t)(g + gg - g_base) * H + k0);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float dv = gg == 0 ? d[r].x : gg == 1 ? d[r].y : gg == 2 ? d[r].z : d[r].w;
        acc0[r] = fmaf(dv, u2.x, acc0[r]);
        acc1[r] = fmaf(dv, u2.y, acc1[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (r0 + r < rows) {
      *reinterpret_cast<float2*>(part + (size_t)(r0 + r) * H + k0) = make_float2(acc0[r], acc1[r]);
    }
  }
}

// two floats as three bf16 pairs: their roundings, the roundings of what
// those leave, and of what is left then (each difference exact in float):
// d = t[0] + t[1] + t[2] to within 2^-27 of d, below a float's own rounding
__device__ __forceinline__ void split_pair(float2 d, unsigned t[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(d.x, d.y);
    const float2 hf = __bfloat1622float2(h);
    d = make_float2(d.x - hf.x, d.y - hf.y);
    t[i] = *reinterpret_cast<const unsigned*>(&h);
  }
}

// The bf16 build's G phase on the tensor cores: part (rows, H) = da (rows,
// 4 Hc) . U slice^T, with the float32 da split into three bf16 terms
// (split_pair), each multiplied by the bf16 U (mma.sync m16n8k16, float
// accumulators), so that da enters whole, not with the 8 significant bits
// of one rounding; U is exactly bf16 in this build. Warp w owns units
// [w H/16, (w+1) H/16) (H/128 n-tiles of 8) for every 16-row m-tile.
__device__ __forceinline__ void chain_product_mma(const float* da_s, int DS, const bf16* slice,
                                                  int G4, int H, int rows, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int ntw = H / 128, n_w = warp * ntw * 8, mts = (rows + 15) / 16, rows8 = round8(rows);
  float acc[3][4][4];
#pragma unroll
  for (int mt = 0; mt < 3; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    }
  }
  for (int k0 = 0; k0 < G4; k0 += 16) {
    unsigned bfr[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt < ntw) {
        const int n = n_w + 8 * nt + gid;
        const bf16* row = slice + (size_t)n * G4;
        bfr[nt][0] = ld_b32(row + ((((k0 >> 3)) ^ (n & 7)) << 3) + 2 * tig);
        bfr[nt][1] = ld_b32(row + ((((k0 >> 3) + 1) ^ (n & 7)) << 3) + 2 * tig);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 3; ++mt) {
      if (mt < mts) {
        float2 d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // (r, k), (r + 8, k), (r, k + 8), (r + 8, k + 8)
          const int r = 16 * mt + gid + 8 * (e & 1), k = k0 + 2 * tig + 8 * (e >> 1);
          d[e] = r < rows8 ? *reinterpret_cast<const float2*>(da_s + r * DS + k)
                           : make_float2(0.0f, 0.0f);
        }
        unsigned t[4][3];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_pair(d[e], t[e]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt < ntw) {
            // the step's three products, smallest term first, then added to
            // the running sum in float: the tensor cores' own additions do
            // not round to nearest, so they sum 48 products at a time only
            float part4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int i = 2; i >= 0; --i) {
              mma_bf16(part4, t[0][i], t[1][i], t[2][i], t[3][i], bfr[nt][0], bfr[nt][1]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part4[e];
          }
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 3; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (mt < mts && nt < ntw) {
        const int n = n_w + 8 * nt + 2 * tig;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * mt + gid + 8 * half;
          if (r < rows) {
            *reinterpret_cast<float2*>(part + (size_t)r * H + n) =
                make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
          }
        }
      }
    }
  }
}

// The chain. Grid: clusters * C CTAs of kChainThreads, cluster dims (C, 1, 1).
template <typename TV, bool STREAM>
__global__ void __launch_bounds__(kChainThreads, 1) lstm_bwd_chain_kernel(const ChainArgs<TV> a) {
  extern __shared__ __align__(16) unsigned char chain_smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const int H = a.H, B = a.B, T = a.T, rows = a.rows;
  const int Hc = H / C, G4 = 4 * Hc, G = 4 * H, DS = G4 + kDaPad;
  constexpr bool kMma = std::is_same_v<TV, bf16>;
  const int row0 = (blockIdx.x / C) * rows;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int npairs = Hc * rows;

  // shared memory: slice (or the ring of chunks) | da (round8(rows), 4 Hc)
  // | partials (nbuf x splits x (rows, H))
  TV* slice = reinterpret_cast<TV*>(chain_smem_raw);
  const size_t slice_bytes = STREAM ? (size_t)a.stages * kStreamChunk * H * sizeof(TV)
                                    : (size_t)G4 * H * sizeof(TV);
  float* da_s = reinterpret_cast<float*>(chain_smem_raw + slice_bytes);
  float* part = da_s + (size_t)round8(rows) * DS;
  const size_t part_stride = (size_t)a.splits * rows * H;  // floats per buffer

  // the resident slice, once; the streamed build's first stages - 1 chunks
  const int n_chunks = STREAM ? G4 / kStreamChunk : 1;
  const int total_chunks = T * n_chunks;
  if constexpr (STREAM) {
    for (int j = 0; j < a.stages - 1; ++j) {
      if (j < total_chunks) {
        copy_slice(a.u, slice + (size_t)j * kStreamChunk * H, (j % n_chunks) * kStreamChunk,
                   kStreamChunk, H, Hc, c);
      }
      cp_async_commit();
    }
  } else if constexpr (kMma) {
    copy_slice_u(a.u, slice, H, Hc, c);
    cp_async_commit();
  } else {
    copy_slice(a.u, slice, 0, G4, H, Hc, c);
    cp_async_commit();
  }
  // rows past the cluster's own and past B stay zero in the da tile
  for (int i = tid; i < round8(rows) * DS; i += blockDim.x) da_s[i] = 0.0f;
  __syncthreads();

  // the carries of the thread's (unit, row) pairs p = r Hc + u, and the
  // operands of the step to come, loaded one step ahead
  float dh[kMaxPairs], dc[kMaxPairs];
  float nx_i[kMaxPairs], nx_f[kMaxPairs], nx_g[kMaxPairs], nx_o[kMaxPairs];
  float nx_cp[kMaxPairs], nx_ct[kMaxPairs], nx_ds[kMaxPairs];
  auto load_step = [&](int t) {
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int p = tid + i * kChainThreads;
      const int r = p / Hc, unit = c * Hc + p % Hc, row = row0 + r;
      if (p < npairs && row < B) {
        const float* ar = a.act + ((size_t)t * B + row) * G + unit;
        nx_i[i] = ar[0];
        nx_f[i] = ar[H];
        nx_g[i] = ar[2 * H];
        nx_o[i] = ar[3 * H];
        nx_cp[i] = to_f32(t > 0 ? a.cseq[((size_t)(t - 1) * B + row) * H + unit]
                                : a.c0[(size_t)row * H + unit]);
        nx_ct[i] = to_f32(a.cseq[((size_t)t * B + row) * H + unit]);
        nx_ds[i] = a.d_seq != nullptr ? to_f32(a.d_seq[((size_t)t * B + row) * H + unit]) : 0.0f;
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int p = tid + i * kChainThreads;
    const int row = row0 + p / Hc, unit = c * Hc + p % Hc;
    dh[i] = (p < npairs && row < B && a.d_final != nullptr)
                ? to_f32(a.d_final[(size_t)row * H + unit]) : 0.0f;
    dc[i] = 0.0f;
  }
  load_step(T - 1);

  const int ntiles = (H / 64) * (round8(rows) / 8);
  const int items = ntiles * a.splits;
  const int g_split = G4 / a.splits;
  int chunk_seq = 0;  // streamed chunks consumed so far (over all steps)
  int buf = 0;
  for (int t = T - 1; t >= 0; --t) {
    // E: the gate-grad math of the thread's pairs
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int p = tid + i * kChainThreads;
      if (p >= npairs) continue;
      const int r = p / Hc, u = p % Hc, row = row0 + r, unit = c * Hc + u;
      float di = 0.0f, df = 0.0f, dg = 0.0f, dout = 0.0f;
      if (row < B) {
        const float dhv = dh[i] + nx_ds[i];
        const float ig = nx_i[i], fg = nx_f[i], gg = nx_g[i], og = nx_o[i];
        const float cp = nx_cp[i], tc = tanhf(nx_ct[i]);
        const float d = dc[i] + dhv * og * (1.0f - tc * tc);
        di = d * gg * ig * (1.0f - ig);
        df = d * cp * fg * (1.0f - fg);
        dg = d * ig * (1.0f - gg * gg);
        dout = dhv * tc * og * (1.0f - og);
        dc[i] = d * fg;
        const size_t o = ((size_t)t * B + row) * G + unit;
        if (a.dacat != nullptr) {
          a.dacat[o] = di;
          a.dacat[o + H] = df;
          a.dacat[o + 2 * H] = dg;
          a.dacat[o + 3 * H] = dout;
        }
        if (a.dxp != nullptr) {
          a.dxp[o] = from_f32<TV>(di);
          a.dxp[o + H] = from_f32<TV>(df);
          a.dxp[o + 2 * H] = from_f32<TV>(dg);
          a.dxp[o + 3 * H] = from_f32<TV>(dout);
        }
      }
      float* dr = da_s + r * DS + u;
      dr[0] = di;
      dr[Hc] = df;
      dr[2 * Hc] = dg;
      dr[3 * Hc] = dout;
    }
    if (t > 0) load_step(t - 1);
    if constexpr (!STREAM) {
      if (t == T - 1) cp_async_wait(0);  // the resident slice has landed
    }
    __syncthreads();
    // with one partial buffer, every peer has read the previous step's
    if (a.nbuf == 1 && t < T - 1) cluster_wait();
    float* part_b = part + buf * part_stride;
    // G: part_b[s] (rows, H) = da_s . slice rows of split s
    if constexpr (kMma) chain_product_mma(da_s, DS, slice, G4, H, rows, part_b);
    for (int ch = 0; ch < (kMma ? 0 : n_chunks); ++ch) {
      const TV* src = slice;
      int g_base = 0;
      if constexpr (STREAM) {
        // chunk chunk_seq has landed in every thread's copies, and every
        // warp is done with the ring slot the next copy refills
        cp_async_wait(a.stages - 2);
        __syncthreads();
        const int next = chunk_seq + a.stages - 1;
        if (next < total_chunks) {
          copy_slice(a.u, slice + (size_t)(next % a.stages) * kStreamChunk * H,
                     (next % n_chunks) * kStreamChunk, kStreamChunk, H, Hc, c);
        }
        cp_async_commit();
        src = slice + (size_t)(chunk_seq % a.stages) * kStreamChunk * H;
        g_base = ch * kStreamChunk;
        ++chunk_seq;
      }
      for (int it = warp; it < items; it += kChainWarps) {
        const int tile = it % ntiles, s = it / ntiles;
        int lo = s * g_split, hi = lo + g_split;
        if constexpr (STREAM) {
          lo = max(lo, g_base);
          hi = min(hi, g_base + kStreamChunk);
          if (lo >= hi) continue;
        }
        if constexpr (!kMma) {
          chain_product(da_s, src, g_base, lo, hi, DS, H, rows, tile % (H / 64),
                        tile / (H / 64), part_b + s * (size_t)rows * H,
                        STREAM && lo > s * g_split);
        }
      }
    }
    // the splits' partials summed into the first, in split order
    if (a.splits > 1) {
      __syncthreads();
      for (int i = tid; i < rows * H; i += blockDim.x) {
        float sum = part_b[i];
        for (int s = 1; s < a.splits; ++s) sum += part_b[s * (size_t)rows * H + i];
        part_b[i] = sum;
      }
    }
    // every CTA's partials are complete
    cluster_arrive();
    cluster_wait();
    // Rd: dh_{t-1} of the thread's pairs: the peers' partials, all loads in
    // flight at once, summed in rank order
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int p = tid + i * kChainThreads;
      if (p >= npairs) continue;
      const size_t off = (size_t)(p / Hc) * H + c * Hc + p % Hc;
      float v[kMaxCluster];
#pragma unroll
      for (int peer = 0; peer < kMaxCluster; ++peer) {
        v[peer] = peer < C ? cluster.map_shared_rank(part_b, peer)[off] : 0.0f;
      }
      float sum = 0.0f;
#pragma unroll
      for (int peer = 0; peer < kMaxCluster; ++peer) {
        if (peer < C) sum += v[peer];
      }
      dh[i] = sum;
    }
    if (a.nbuf == 1) cluster_arrive();
    buf ^= a.nbuf - 1;
  }
  // no CTA leaves while a peer may still read its partials
  if (a.nbuf == 2) cluster_arrive();
  cluster_wait();
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int p = tid + i * kChainThreads;
    const int row = row0 + p / Hc, unit = c * Hc + p % Hc;
    if (p < npairs && row < B) {
      a.dh0[(size_t)row * H + unit] = from_f32<TV>(dh[i]);
      a.dc0[(size_t)row * H + unit] = from_f32<TV>(dc[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host launchers (each returns a cudaError_t code)
// ---------------------------------------------------------------------------

// The float builds' pre-pass (FFMA): w (D, 4H) and u (H, 4H) as they are.
template <bool XW>
int launch_gates(const float* xin, const float* w, const float* b, const float* hseq,
                 const float* h0, const float* u, float* act, int T, int B, int D, int H,
                 void* stream) {
  if (T < 1 || B < 1 || H < 32 || H % 32 != 0 || (XW && D < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int M = T * B;
  const dim3 grid(4 * H / kGemmTile, (M + kGemmTile - 1) / kGemmTile);
  lstm_bwd_gates_kernel<float, XW><<<grid, kGemmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xin, w, b, hseq, h0, u, act, M, B, D, H);
  return (int)cudaGetLastError();
}

// The bf16 builds' pre-pass (tensor cores): wt = W^T (4H, D), ut = U^T (4H, H).
template <bool XW>
int launch_gates(const bf16* xin, const bf16* wt, const bf16* b, const bf16* hseq,
                 const bf16* h0, const bf16* ut, float* act, int T, int B, int D, int H,
                 void* stream) {
  if (T < 1 || B < 1 || H < 32 || H % 32 != 0 || (XW && D < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int M = T * B;
  const dim3 grid(4 * H / kGemmTile, (M + kGemmTile - 1) / kGemmTile);
  lstm_bwd_gates_mma_kernel<XW><<<grid, kGemmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xin, wt, b, hseq, h0, ut, act, M, B, D, H);
  return (int)cudaGetLastError();
}

template <typename TV>
int launch_dx(const float* da, const TV* wt, TV* dx, int T, int B, int D, int H, void* stream) {
  if (T < 1 || B < 1 || D < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const int M = T * B;
  const dim3 grid((D + kGemmTile - 1) / kGemmTile, (M + kGemmTile - 1) / kGemmTile);
  lstm_bwd_dx_kernel<TV><<<grid, kGemmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      da, wt, dx, M, D, H);
  return (int)cudaGetLastError();
}

// Only the float build streams its slice (bf16 fits at every H <= 512).
template <typename TV, bool STREAM>
int launch_chain_instance(const ChainArgs<TV>& a, int cluster, size_t smem, void* stream) {
  cudaError_t err = cluster_config(lstm_bwd_chain_kernel<TV, STREAM>, cluster, smem);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch l((a.B + a.rows - 1) / a.rows * cluster, cluster, smem, stream);
  err = cudaLaunchKernelEx(&l.cfg, lstm_bwd_chain_kernel<TV, STREAM>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TV>
int launch_chain(const ChainArgs<TV>& a, int cluster, int stream_slice, void* stream) {
  const int H = a.H;
  const bool streamed = stream_slice != 0;
  if (a.T < 1 || a.B < 1 || H < 64 || H % 64 != 0 || cluster < 1 || cluster > 16 ||
      H % cluster != 0 || a.rows < 1 || (H / cluster) * a.rows > kMaxPairs * kChainThreads ||
      a.splits < 1 || (4 * (H / cluster)) % (4 * a.splits) != 0 || a.nbuf < 1 || a.nbuf > 2 ||
      (streamed && (!std::is_same_v<TV, float> || (4 * (H / cluster)) % kStreamChunk != 0 ||
                    a.stages < 2 || a.stages > 8)) ||
      (std::is_same_v<TV, bf16> && (a.splits != 1 || H % 128 != 0 || (H / cluster) % 16 != 0 ||
                                    a.rows > 48)) ||
      (a.dacat == nullptr && a.dxp == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem =
      chain_smem(H, cluster, a.rows, a.splits, a.nbuf, a.stages, streamed, sizeof(TV));
  if constexpr (std::is_same_v<TV, float>) {
    if (streamed) return launch_chain_instance<TV, true>(a, cluster, smem, stream);
  }
  return launch_chain_instance<TV, false>(a, cluster, smem, stream);
}

// cudaOccupancyMaxActiveClusters of the chain at `cluster` CTAs a cluster
// (one CTA an SM)
template <typename TV>
int chain_max_clusters(int cluster, int stream_slice, int* out) {
  if constexpr (std::is_same_v<TV, float>) {
    if (stream_slice) return max_active_clusters(lstm_bwd_chain_kernel<TV, true>, cluster, out);
  } else {
    if (stream_slice) return (int)cudaErrorInvalidValue;
  }
  return max_active_clusters(lstm_bwd_chain_kernel<TV, false>, cluster, out);
}

}  // namespace mvt
