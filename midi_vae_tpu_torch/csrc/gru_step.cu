// Kernels T and T xp: one reset-before GRU cell step, the per-step cells of
// the decode heads and of the encoder layers that the whole-layer kernels do
// not run.
//
// T replaces the TPU kernel midi_vae_tpu/ops/fused_gru.py::_gru_full_kernel
// (:54), reached through _gru_step_pallas (:95) from gru_step (:143): the
// fused_step of every GRU decode-head cell that no whole-head kernel takes
// (merge_decoder_scans, fused_train_decoder=False, and the serving heads
// kernel B does not take: 3 layers, or another output activation). It
// computes x @ W + b and h @ U in the kernel.
// T xp replaces _gru_recurrent_kernel (:71), reached through
// _gru_recurrent_pallas (:117) from gru_recurrent_step (:164): the encoder
// layers with fused_train_encoder=False, over xp = x @ W + b that the caller
// computes for every step in one matmul (models/rnn.py:163); only h @ U is in
// the kernel.
// Neither backward is a kernel in the JAX package: gru_step's and
// gru_recurrent_step's custom VJPs recompute the step through the plain jnp
// math (_gru_step_bwd :153, _gru_recurrent_bwd :174), and the port's autograd
// Functions do the same (ops/gru_step.py). Templated on the cell activation
// (tanh, sigmoid or relu).
// T has a bf16 build too (mvt_gru_step_bf16): _gru_full_kernel in a bf16
// model (compute_dtype="bfloat16", the heads of fused_train_decoder=False
// and merge_decoder_scans) takes x, h, W, U and b in bf16, computes
// x @ W + b, h @ U and the gates in float (preferred_element_type=float32)
// and stores h' in bf16, rounded once; r * h stays float, as the Pallas dot
// promotes it.
//
// Math: z = sig(x W_z + h U_z + b_z), r = sig(x W_r + h U_r + b_r),
// hh = act(x W_h + b_h + (r h) U_h), h' = z h + (1 - z) hh (T xp: xp's
// columns in place of x W + b).
//
// Design: one launch on thread-block clusters and the tensor cores. A
// cluster of C CTAs owns a tile of kBM batch rows and all H units; CTA c
// owns units [c kHC, (c+1) kHC) and their gate columns of W and U. Its warps
// split the tile into (16 rows x 8 units) fragments, one a warp, and take
// two products on mma.sync m16n8k8 (TF32 operands, float sums):
//   P1 = [x | h] . [W ; U_zr] over the depth D + H: the x segment against
//      W's three gate columns of the unit group (z, r and the candidate's
//      x W_h), the h segment against U's z and r columns only (T xp: the h
//      segment alone, xp's own columns added in the epilogue). Epilogue: z,
//      r, r h of the CTA's units into its r h tile;
//   X  each CTA copies its units' columns of r h into every peer's r h
//      tile through distributed shared memory; one cluster barrier;
//   P2 = (r h) . U_h over the CTA's kHC candidate columns. Epilogue: hh,
//      h' = z h + (1 - z) hh, stored.
// [x | h] of the cluster's rows is loaded once into shared memory (widened
// to float, x's depth zero-padded to a multiple of 32); the weights' gate
// columns stream through one cp.async ring of kStepStages stages of 32
// depth rows that runs on from P1 into P2, so P2's first stages load while
// the CTAs meet at the barrier (stages of 16 rows took about 1.2x as long
// on the H100, and 8 slots of them no less than 4: a stage's wait and
// barrier cost about the same whatever its depth; PERF.md, Findings).
// Float32 operands take three TF32 products a pair (a_lo b_hi + a_hi b_lo
// + a_hi b_hi: float32 accuracy); bf16 operands are exact in TF32, so P1
// takes one product a pair and P2, whose r h is float, two (its remainder
// beside the exact U_h: gemm_tc.cuh's kTwoA).
// Each stage's products go into zeroed accumulators (one a product: the
// mma chains run side by side) and join the running sums by one rounded
// float add (gemm_tc.cuh's note on truncation).
//
// The plan (kBM, kHC; C = H / kHC CTAs a cluster) is chosen per shape by
// ops/_layout.py::gru_step_plan from the plans timed on the H100
// (tools/time_t_and_b.py). Where its clusters outnumber the card's active
// clusters (16 x 64 at B = 256, H = 512: 16 clusters of 8 against 15),
// T takes its two-launch route instead (kPart 1 and 2 below: P1, then P2
// under programmatic dependent launch, r h through global memory): its 128
// CTAs run in one wave.
//
// What bounds it: one launch per cell per decode step (192 a training
// forward of the default config with merge_decoder_scans, 196 with
// fused_train_decoder=False), each a product of tens to a few hundred
// MFLOP and a read of W and U (1.5 MiB in float32 at H = D = 256) from L2:
// the launch, the ring's latency and the cluster barrier, not the FLOPs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (midi_vae_tpu_torch/ops/_build.py).
#include "gemm_tc.cuh"
#include "lstm_cluster.cuh"

namespace mvt {

constexpr int kStepKC = 32;     // depth rows of a ring stage
constexpr int kStepStages = 3;  // ring slots
constexpr int kStepPadB = 8;    // a ring row holds NG kHC + 8 values
constexpr int kStepPadA = 4;    // the [x | h] and r h tiles' rows: 4 mod 32 floats

template <typename TV>
struct GruStepArgs {
  const TV* x;      // (B, D), or null (T xp)
  const TV* h;      // (B, H)
  const TV* w;      // (D, 3H), or null (T xp)
  const TV* b;      // (3H,), or null (T xp)
  const TV* u;      // (H, 3H)
  const float* xp;  // (B, 3H): T xp's x @ W + b, else null
  TV* h_out;        // (B, H)
  int B, D, H;
  // the two-launch alternative (mvt_gru_step_split): P1's z, r h and
  // candidate x part, (B, H) float each, which its second launch reads
  float* z_g;
  float* rh_g;
  float* cx_g;
};

// x's depth in the [x | h] tile, a multiple of the stage depth
__host__ __device__ constexpr int step_dp(int D) { return (D + kStepKC - 1) / kStepKC * kStepKC; }
// a tile row of K floats, padded to 4 mod 32 (the A fragments' 8 rows x 4
// depths then hit 32 banks)
__host__ __device__ constexpr int step_row(int K) { return (K + 31) / 32 * 32 + kStepPadA; }

// Dynamic shared memory of a CTA in bytes: the [x | h] tile, the r h tile
// (float) and the ring (elem bytes a value). ops/_layout.py's
// gru_step_smem computes the same.
__host__ __device__ constexpr size_t gru_step_smem(int D, int H, int bm, int hc, int elem,
                                                   bool xp) {
  return (size_t)bm * step_row(xp ? H : step_dp(D) + H) * 4 + (size_t)bm * (H + kStepPadA) * 4 +
         (size_t)kStepStages * kStepKC * ((xp ? 2 : 3) * hc + kStepPadB) * elem;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

// kPart: 0 the design above (one launch on clusters); 1 and 2 the
// two-launch route, P1 and P2 as two launches (no clusters), the second
// under programmatic dependent launch, r h and the gates through global
// memory: the route of the plan whose clusters outnumber the card's active
// clusters (at B = 256, H = 512 they would run in two waves; PERF.md,
// Findings).
// Grid: (ceil(B / kBM) * C) CTAs of 32 (kBM / 16) (kHC / 8) threads,
// cluster dims (C, 1, 1), C = H / kHC (kPart 1, 2: no cluster dims).
template <int ACT, typename TV, bool kXp, int kBM, int kHC, int kPart = 0>
__global__ void __launch_bounds__(32 * (kBM / 16) * (kHC / 8)) gru_step_tc_kernel(
    const GruStepArgs<TV> a) {
  constexpr int kWarpsN = kHC / 8;
  constexpr int kThr = 32 * (kBM / 16) * kWarpsN;
  constexpr int NG = kXp ? 2 : 3;
  constexpr int BS = NG * kHC + kStepPadB;
  constexpr int kVec = 16 / sizeof(TV);
  constexpr bool kF32 = std::is_same_v<TV, float>;
  extern __shared__ __align__(16) unsigned char step_smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const int H = a.H, B = a.B, D = kXp ? 0 : a.D;
  const int Dp = kXp ? 0 : step_dp(D), K = Dp + H, AS = step_row(K), RS = H + kStepPadA;
  // the CTA's units: its cluster rank (the alternative: its block's index)
  const int n_units = kPart ? H / kHC : C;
  const int m0 = (blockIdx.x / n_units) * kBM;
  const int u0 = (kPart ? (int)blockIdx.x % n_units : c) * kHC;
  // shared memory: [x | h] (kBM, AS) float | r h (kBM, RS) float | the ring
  // (kStepStages, kStepKC, BS) of TV
  float* As = reinterpret_cast<float*>(step_smem_raw);
  float* Rs = As + (size_t)kBM * AS;
  TV* ring = reinterpret_cast<TV*>(Rs + (size_t)kBM * RS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gid = lane >> 2,
            tig = lane & 3;
  const int mt = warp / kWarpsN, ug = warp % kWarpsN;

  // stages: nkx of x against W (T), then h against U_zr, then P2's (r h)
  // against U_h
  const int nkx = Dp / kStepKC, nk1 = nkx + H / kStepKC;
  const int nk = kPart == 1 ? nk1 : nk1 + H / kStepKC;
  auto fetch = [&](int kt) {
    const TV* g = a.u;
    int k0, kmax = H, q0 = 0, ng = 2;
    if (kt < nkx) {
      g = a.w;
      k0 = kt * kStepKC;
      kmax = D;
      ng = 3;
    } else if (kt < nk1) {
      k0 = (kt - nkx) * kStepKC;
    } else {
      k0 = (kt - nk1) * kStepKC;
      q0 = 2;
      ng = 1;
    }
    TV* s = ring + (size_t)(kt % kStepStages) * kStepKC * BS;
    const int per_row = ng * kHC / kVec;
    for (int i = tid; i < kStepKC * per_row; i += kThr) {
      const int r = i / per_row, v = (i % per_row) * kVec, q = v / kHC, ul = v % kHC;
      const bool ok = k0 + r < kmax;
      const TV* src = ok ? g + (size_t)(k0 + r) * 3 * H + (q0 + q) * H + u0 + ul : g;
      tc::copy16(reinterpret_cast<float*>(s + r * BS + v), src, ok);
    }
  };
  if constexpr (kPart == 1) {
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  }
  if constexpr (kPart == 2) {
    // the alternative's second launch: U_h's first stages, then (after the
    // first launch's writes) r h of the tile's rows
#pragma unroll
    for (int s = 0; s < kStepStages - 1; ++s) {
      if (nk1 + s < nk) fetch(nk1 + s);
      tc::commit();
    }
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    for (int i = tid; i < kBM * H / 4; i += kThr) {
      const int r = i / (H / 4), k = (i % (H / 4)) * 4, row = m0 + r;
      const bool ok = row < B;
      tc::copy16(Rs + (size_t)r * RS + k, ok ? a.rh_g + (size_t)row * H + k : a.rh_g, ok);
    }
    tc::commit();
    tc::wait_pending<0>();
  } else {
  // [x | 0 | h] of the tile's rows, widened; rows past B and x's padding
  // are zero. Float: cp.async into the tile (16-byte copies where the rows
  // allow, x's 4-byte copies otherwise), in stage 0's copy group; bf16:
  // after the ring's first stages are asked for, loaded 8 values a thread
  // at a time into registers, then widened
  if constexpr (kF32) {
    const bool x16 = !kXp && D % 4 == 0 && (reinterpret_cast<size_t>(a.x) & 15) == 0;
    const bool h16 = (reinterpret_cast<size_t>(a.h) & 15) == 0;
    const int xv = x16 ? 4 : 1, hv = h16 ? 4 : 1;
    for (int i = tid; i < kBM * Dp / xv; i += kThr) {
      const int r = i / (Dp / xv), k = (i % (Dp / xv)) * xv, row = m0 + r;
      const bool ok = row < B && k < D;
      const float* src = ok ? reinterpret_cast<const float*>(a.x) + (size_t)row * D + k
                            : reinterpret_cast<const float*>(a.u);
      if (x16) {
        tc::copy16(As + (size_t)r * AS + k, src, ok);
      } else {
        tc::copy4(As + (size_t)r * AS + k, src, ok);
      }
    }
    for (int i = tid; i < kBM * H / hv; i += kThr) {
      const int r = i / (H / hv), k = (i % (H / hv)) * hv, row = m0 + r;
      const bool ok = row < B;
      const float* src = ok ? reinterpret_cast<const float*>(a.h) + (size_t)row * H + k
                            : reinterpret_cast<const float*>(a.u);
      if (h16) {
        tc::copy16(As + (size_t)r * AS + Dp + k, src, ok);
      } else {
        tc::copy4(As + (size_t)r * AS + Dp + k, src, ok);
      }
    }
#pragma unroll
    for (int s = 0; s < kStepStages - 1; ++s) {
      if (s < nk) fetch(s);
      tc::commit();
    }
  } else {
#pragma unroll
    for (int s = 0; s < kStepStages - 1; ++s) {
      if (s < nk) fetch(s);
      tc::commit();
    }
    constexpr int kBatch = 8;
    for (int i0 = tid; i0 < kBM * K; i0 += kBatch * kThr) {
      float v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * kThr, r = i / K, k = i % K, row = m0 + r;
        v[j] = 0.0f;
        if (i < kBM * K && row < B) {
          if (k < D) {
            v[j] = to_f32(a.x[(size_t)row * D + k]);
          } else if (k >= Dp) {
            v[j] = to_f32(a.h[(size_t)row * H + k - Dp]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * kThr;
        if (i < kBM * K) As[(size_t)(i / K) * AS + i % K] = v[j];
      }
    }
  }
  }
  // the cluster's CTAs have all started before a peer writes into them
  if constexpr (kPart == 0) cluster_arrive_relaxed();

  // the A fragment (rows 16 mt + gid (+ 8), depths k (+ 4)) of a tile of
  // row stride ts, split as hi / lo (lo zero where the operand is exact)
  auto a_frag = [&](const float* t, int ts, int k, bool split_a, unsigned (&hi)[4],
                    unsigned (&lo)[4]) {
    const float* p = t + (size_t)(16 * mt + gid) * ts + k;
    const float av[4] = {p[0], p[8 * ts], p[4], p[8 * ts + 4]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (split_a) {
        tc::split<true>(av[e], hi[e], lo[e]);
      } else {
        tc::split<false>(av[e], hi[e], lo[e]);
      }
    }
  };
  // t[p] += product p of A . B over a stage's k-step (kProducts of
  // tc::Products): t[0] a_hi b_hi, t[1] a_lo b_hi, t[2] a_hi b_lo, each its
  // own accumulator, so the stage's mma chains run side by side
  auto products = [&](float (&t)[3][4], const unsigned (&ah)[4], const unsigned (&al)[4],
                      const TV* bc, int kp) {
    unsigned bh0, bl0, bh1, bl1;
    const bool split_b = kp == tc::kThree;
    if (split_b) {
      tc::split<true>(to_f32(bc[0]), bh0, bl0);
      tc::split<true>(to_f32(bc[4 * BS]), bh1, bl1);
    } else {
      tc::split<false>(to_f32(bc[0]), bh0, bl0);
      tc::split<false>(to_f32(bc[4 * BS]), bh1, bl1);
    }
    tc::mma_tf32(t[0], ah, bh0, bh1);
    if (kp == tc::kThree || kp == tc::kTwoA) tc::mma_tf32(t[1], al, bh0, bh1);
    if (kp == tc::kThree) tc::mma_tf32(t[2], ah, bl0, bl1);
  };

  // P1: acc[q] gate q (z, r, the candidate's x W_h) of the warp's fragment
  constexpr int kP1 = kF32 ? tc::kThree : tc::kOne;
  float acc[3][4] = {};
  for (int kt = 0; kt < (kPart == 2 ? 0 : nk1); ++kt) {
    tc::wait_pending<kStepStages - 2>();
    __syncthreads();  // stage kt is in; every thread is done with slot kt - 1
    if (kt + kStepStages - 1 < nk) fetch(kt + kStepStages - 1);
    tc::commit();
    const TV* bt = ring + (size_t)(kt % kStepStages) * kStepKC * BS;
    const int kb = kt < nkx ? kt * kStepKC : Dp + (kt - nkx) * kStepKC;
    const int nq = kt < nkx ? 3 : 2;
    float t[3][3][4] = {};
#pragma unroll
    for (int ks = 0; ks < kStepKC / 8; ++ks) {
      unsigned ah[4], al[4];
      a_frag(As, AS, kb + 8 * ks + tig, kP1 == tc::kThree, ah, al);
      const TV* bc = bt + (8 * ks + tig) * BS + 8 * ug + gid;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        if (q < nq) products(t[q], ah, al, bc + q * kHC, kP1);
      }
    }
    // the stage's products summed (small first), then one rounded add each
#pragma unroll
    for (int q = 0; q < 3; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] += t[q][1][e] + t[q][2][e] + t[q][0][e];
    }
  }

  // P1's epilogue: pair (half, e) is row 16 mt + gid + 8 half, local unit
  // 8 ug + 2 tig + e; z, r h into the r h tile, the candidate's x part kept
  float zv[2][2], hold[2][2], cx[2][2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int rl = 16 * mt + gid + 8 * half, row = m0 + rl;
      const int unit = u0 + 8 * ug + 2 * tig + e;
      if constexpr (kPart == 2) {
        const size_t o = (size_t)(row < B ? row : 0) * H + unit;
        zv[half][e] = a.z_g[o];
        hold[half][e] = to_f32(a.h[o]);
        cx[half][e] = a.cx_g[o];
        continue;
      }
      float az, ar, ah;
      if constexpr (kXp) {
        const float* x = a.xp + (size_t)(row < B ? row : 0) * 3 * H + unit;
        az = row < B ? x[0] : 0.0f;
        ar = row < B ? x[H] : 0.0f;
        ah = row < B ? x[2 * H] : 0.0f;
      } else {
        az = to_f32(a.b[unit]);
        ar = to_f32(a.b[H + unit]);
        ah = to_f32(a.b[2 * H + unit]);
      }
      const float z = activate<kSigmoid>(acc[0][2 * half + e] + az);
      const float r = activate<kSigmoid>(acc[1][2 * half + e] + ar);
      const float hp = As[(size_t)rl * AS + Dp + unit];
      Rs[(size_t)rl * RS + unit] = r * hp;
      zv[half][e] = z;
      hold[half][e] = hp;
      cx[half][e] = acc[2][2 * half + e] + ah;
      if (kPart == 1 && row < B) {
        const size_t o = (size_t)row * H + unit;
        a.z_g[o] = z;
        a.rh_g[o] = r * hp;
        a.cx_g[o] = cx[half][e];
      }
    }
  }
  if constexpr (kPart == 1) {
    tc::wait_pending<0>();
    return;
  }
  if constexpr (kPart == 0) {
  __syncthreads();  // the CTA's columns of r h are in its tile
  cluster_wait();   // every CTA of the cluster has started
  // X: the CTA's kHC columns of its kBM rows into every peer's r h tile
  push_columns(cluster, reinterpret_cast<char*>(Rs), kBM * kHC / 4,
               [&](int j) {
                 return ((size_t)(j / (kHC / 4)) * RS + u0 + 4 * (j % (kHC / 4))) * 4;
               },
               C, c);
  cluster_arrive();
  cluster_wait();
  }

  // P2: (r h) . U_h over the CTA's candidate columns
  constexpr int kP2 = kF32 ? tc::kThree : tc::kTwoA;
  float acc2[4] = {};
  for (int kt = nk1; kt < nk; ++kt) {
    tc::wait_pending<kStepStages - 2>();
    __syncthreads();
    if (kt + kStepStages - 1 < nk) fetch(kt + kStepStages - 1);
    tc::commit();
    const TV* bt = ring + (size_t)(kt % kStepStages) * kStepKC * BS;
    const int kb = (kt - nk1) * kStepKC;
    float t[3][4] = {};
#pragma unroll
    for (int ks = 0; ks < kStepKC / 8; ++ks) {
      unsigned ah[4], al[4];
      a_frag(Rs, RS, kb + 8 * ks + tig, true, ah, al);
      products(t, ah, al, bt + (8 * ks + tig) * BS + 8 * ug + gid, kP2);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[e] += t[1][e] + t[2][e] + t[0][e];
  }
  tc::wait_pending<0>();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + 16 * mt + gid + 8 * half;
    if (row >= B) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int unit = u0 + 8 * ug + 2 * tig + e;
      const float hh = activate<ACT>(acc2[2 * half + e] + cx[half][e]);
      const float z = zv[half][e];
      a.h_out[(size_t)row * H + unit] = from_f32<TV>(z * hold[half][e] + (1.0f - z) * hh);
    }
  }
}

template <int kBM, int kHC>
constexpr int step_tc_threads() {
  return 32 * (kBM / 16) * (kHC / 8);
}

template <int ACT, typename TV, bool kXp, int kBM, int kHC>
int launch_step_tile(const GruStepArgs<TV>& a, void* stream) {
  auto kernel = gru_step_tc_kernel<ACT, TV, kXp, kBM, kHC>;
  const int C = a.H / kHC;
  if (a.H % kHC != 0 || C > kMaxCluster) return (int)cudaErrorInvalidValue;
  const size_t smem = gru_step_smem(a.D, a.H, kBM, kHC, sizeof(TV), kXp);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  // the attributes once an instance (non-portable cluster sizes allowed),
  // again where a launch asks more shared memory than any before
  static size_t configured = 0;
  if (smem > configured) {
    cudaError_t err = cluster_config(kernel, kMaxCluster, smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((a.B + kBM - 1) / kBM * C);
  cfg.blockDim = dim3(step_tc_threads<kBM, kHC>());
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the plans of ops/_layout.py::STEP_T_PLANS (rows kBM, units kHC), by index
template <int ACT, typename TV, bool kXp>
int launch_step_plan(const GruStepArgs<TV>& a, int plan, void* stream) {
  switch (plan) {
    case 0: return launch_step_tile<ACT, TV, kXp, 16, 32>(a, stream);
    case 1: return launch_step_tile<ACT, TV, kXp, 16, 64>(a, stream);
    case 2: return launch_step_tile<ACT, TV, kXp, 32, 32>(a, stream);
    case 3: return launch_step_tile<ACT, TV, kXp, 32, 64>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One launch of the two-launch route's part kPart (1: P1, 2: P2,
// programmatic dependent on the launch before it) of T (not T xp)
template <int ACT, typename TV, int kBM, int kHC, int kPart>
cudaError_t launch_part(const GruStepArgs<TV>& a, void* stream) {
  auto kernel = gru_step_tc_kernel<ACT, TV, false, kBM, kHC, kPart>;
  const size_t smem = gru_step_smem(a.D, a.H, kBM, kHC, sizeof(TV), false);
  if (smem > 232448) return cudaErrorInvalidValue;
  static size_t configured = 0;
  if (smem > configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((a.B + kBM - 1) / kBM * (a.H / kHC));
  cfg.blockDim = dim3(step_tc_threads<kBM, kHC>());
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  if (kPart == 2) {
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

// the two-launch route at the plan 16 rows x 64 units (STEP_T_PLANS[1]),
// the one whose clusters outnumber the card's at B = 256, H = 512
template <int ACT, typename TV>
int launch_split(const GruStepArgs<TV>& a, void* stream) {
  if (a.H % 64 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_part<ACT, TV, 16, 64, 1>(a, stream);
  if (err == cudaSuccess) err = launch_part<ACT, TV, 16, 64, 2>(a, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TV>
int run_split(const GruStepArgs<TV>& a, int act, void* stream) {
  const auto misaligned = [](const void* p) { return (reinterpret_cast<size_t>(p) & 15) != 0; };
  if (a.B < 1 || a.D < 1 || a.H < 64 || a.H % 64 != 0 || a.H > 512 || misaligned(a.u) ||
      misaligned(a.w) || misaligned(a.z_g)) {
    return (int)cudaErrorInvalidValue;
  }
  switch (act) {
    case kTanh: return launch_split<kTanh, TV>(a, stream);
    case kSigmoid: return launch_split<kSigmoid, TV>(a, stream);
    case kRelu: return launch_split<kRelu, TV>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TV, bool kXp>
int run_step(const GruStepArgs<TV>& a, int act, int plan, void* stream) {
  const auto misaligned = [](const void* p) { return (reinterpret_cast<size_t>(p) & 15) != 0; };
  if (a.B < 1 || (!kXp && a.D < 1) || a.H < 32 || a.H % 32 != 0 || a.H > 512 ||
      misaligned(a.u) || (!kXp && misaligned(a.w))) {
    return (int)cudaErrorInvalidValue;
  }
  switch (act) {
    case kTanh: return launch_step_plan<kTanh, TV, kXp>(a, plan, stream);
    case kSigmoid: return launch_step_plan<kSigmoid, TV, kXp>(a, plan, stream);
    case kRelu: return launch_step_plan<kRelu, TV, kXp>(a, plan, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mvt

// x (B, D), h (B, H), w (D, 3H), b (3H,), u (H, 3H) contiguous, w and u
// 16-byte aligned; h_out (B, H); plan: the index of
// ops/_layout.py::gru_step_plan's plan.
extern "C" int mvt_gru_step(const float* x, const float* h, const float* w, const float* b,
                            const float* u, float* h_out, int B, int D, int H, int act, int plan,
                            void* stream) {
  return mvt::run_step<float, false>({x, h, w, b, u, nullptr, h_out, B, D, H}, act, plan,
                                     stream);
}

// the bf16 build: every operand and h_out bf16
extern "C" int mvt_gru_step_bf16(const mvt::bf16* x, const mvt::bf16* h, const mvt::bf16* w,
                                 const mvt::bf16* b, const mvt::bf16* u, mvt::bf16* h_out, int B,
                                 int D, int H, int act, int plan, void* stream) {
  return mvt::run_step<mvt::bf16, false>({x, h, w, b, u, nullptr, h_out, B, D, H}, act, plan,
                                     stream);
}

// T's two-launch route (ops/_layout.py::gru_step_plan's `split`: the
// plan 16 x 64 where its clusters outnumber the card's): as mvt_gru_step,
// with scratch 3 B H floats (P1's z, r h and candidate x part, 16-byte
// aligned)
extern "C" int mvt_gru_step_split(const float* x, const float* h, const float* w,
                                  const float* b, const float* u, float* h_out, float* scratch,
                                  int B, int D, int H, int act, void* stream) {
  const size_t n = (size_t)B * H;
  return mvt::run_split<float>({x, h, w, b, u, nullptr, h_out, B, D, H, scratch, scratch + n,
                                scratch + 2 * n},
                               act, stream);
}

extern "C" int mvt_gru_step_split_bf16(const mvt::bf16* x, const mvt::bf16* h,
                                       const mvt::bf16* w, const mvt::bf16* b,
                                       const mvt::bf16* u, mvt::bf16* h_out, float* scratch,
                                       int B, int D, int H, int act, void* stream) {
  const size_t n = (size_t)B * H;
  return mvt::run_split<mvt::bf16>({x, h, w, b, u, nullptr, h_out, B, D, H, scratch,
                                    scratch + n, scratch + 2 * n},
                                   act, stream);
}

// T xp: xp (B, 3H), h (B, H), u (H, 3H) float32, contiguous
extern "C" int mvt_gru_step_xp(const float* xp, const float* h, const float* u, float* h_out,
                               int B, int H, int act, int plan, void* stream) {
  return mvt::run_step<float, true>({nullptr, h, nullptr, nullptr, u, xp, h_out, B, 0, H}, act,
                                    plan, stream);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
