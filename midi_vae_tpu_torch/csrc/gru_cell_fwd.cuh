// Kernel A's chain (gru_layer_fwd.cu): the serial recurrence of one
// reset-before GRU layer over a precomputed float32 x-projection, on
// thread-block clusters (lstm_cluster.cuh's helpers; the plan of
// lstm_cell_fwd.cuh's float build).
//
// Math (midi_vae_tpu/ops/fused_train.py::_fwdx_kernel :2057-2077 and
// _fwdx_last_kernel :2919-2941, after x @ W + b, which the pre-pass
// computes):
//   z, r = sig(xp_t[:, :2H] + h_{t-1} . U[:, :2H])
//   hh   = act(xp_t[:, 2H:] + (r h_{t-1}) . U[:, 2H:])
//   h_t  = z h_{t-1} + (1 - z) hh
// every product and gate in float; h_t rounded to the build's type where
// the Pallas scratch holds it (bf16: once a step, the carried state and the
// stored sequence; r h stays float, as the Pallas dot promotes r * h).
//
// Layout. One cluster of C CTAs (512 threads each, one an SM) owns `rows`
// batch rows for all T steps. CTA c owns the hidden units [c Hc, (c+1) Hc),
// Hc = H / C, and their 3 Hc gate columns of U (an H x 3 Hc slice, local
// column q Hc + u is U column q H + c Hc + u), so it finishes its own units'
// gates with no sum across CTAs. Each CTA holds the whole h_{t-1} and the
// whole r h of its rows in shared memory, feature-major (H, rows rounded to
// 8). A thread of split 0 (the owner) owns one unit's gates on 8 rows;
// `splits` threads share each such tile's depth, their partials summed in
// split order through shared memory (bf16's P1: warps own m-tiles of 16
// rows x 8 units, below). A step:
//   P1 (rows, 2 Hc) = h_{t-1} . U_zr slice (FFMA; in bf16 on the tensor
//      cores), plus xp_t's z and r columns (copied by the owner one step
//      ahead, cp.async): z, r;
//   X1 the owner writes r h of its pairs into its CTA's r h tile, and the
//      CTA copies its columns into every peer's (16-byte stores through
//      distributed shared memory); one cluster barrier;
//   P2 (rows, Hc) = (r h) . U_h slice, plus xp_t's candidate columns: hh
//      and h_t (c.f. the blend of h_{t-1} kept in registers);
//   X2 h_t into the own columns of the h tile, copied into every peer's;
//      one cluster barrier, during which h_t goes to the sequence and the
//      owner copies xp_{t+1}.
// The reset-before GRU needs r before it can take (r h) . U_h, so a step has
// two dependent products and two exchanges, where the LSTM chain has one;
// each barrier is also the one that frees the tile its peers write next (a
// peer pushes r h only after it has waited at the barrier that ends every
// CTA's P2 of the step before, and h_t only after the one that ends every
// P1), so one tile of each is enough. Every store into a peer's shared
// memory comes before a barrier that the peer waits at, and the last step
// pushes no h_t, so a CTA leaves after its last step with no closing
// barrier.
//
// Builds: float32 (gru_fwd_chain_kernel: the slice float, P1 and P2 as
// FFMA) and bf16 (gru_fwd_chain_mma_kernel: h and U are exactly bf16, so P1
// runs on mma.sync with float accumulators over a bf16 h tile; r h is
// float, so P2 stays FFMA over the bf16 candidate slice, widened as it is
// read: both are _dot's products on the exact operands, summed in float in
// another order). The bf16 build reads a float32 xp (A's pre-pass) or, in
// its bf16-xp instance (kernel X, gru_encoder_scan.cu: the model's own bf16
// x @ W + b), a bf16 xp widened as it is added; the rest of the step is the
// same. The slice is resident where it takes at most half of a
// block's shared memory (float at H = 256: 96 KiB in clusters of 8; bf16 at
// 256: 96 KiB in clusters of 4, at 512 in clusters of 16); float at H = 512
// (192 KiB in clusters of 16) streams it from L2 at every step, in chunks of
// kGruChunk depth rows through a cp.async ring that runs on across the
// phases and steps (P1's chunks hold the 2 Hc z and r columns, P2's the Hc
// candidate columns: the STREAM instance).
//
// Kernel F (gru_layer_xp_fwd.cu) runs the float32 build over its given xp
// where the slice is resident, and where it streams a tensor-core instance
// of its own (gru_fwd_chain_tc_kernel, below: the slice packed in
// B-fragment order and streamed by the Tensor Memory Accelerator, P1 and
// P2 as three TF32 products; tc_segment, which D wide's tensor-core chain
// of gru_decode_chain.cuh shares). A's instances are unchanged.
//
// What bounds it: the chain, T steps of two dependent products of rows x
// H x (2 Hc, Hc) per CTA and two cluster barriers; ops/_layout.py::
// gru_fwd_plan picks C, the rows a cluster takes (ceil(B / the card's
// active clusters), bounded by what fits beside the slice) and the splits.
// Every kernel launches on the caller's stream and allocates nothing.
#pragma once

#include "gemm_tc.cuh"
#include "lstm_cluster.cuh"

namespace mvt {

// The Tensor Memory Accelerator's bulk copies into a ring of shared-memory
// slots, each slot's completion counted on an mbarrier (kernel B's decode
// chain, gru_decode_chain.cuh, and F's tensor-core instance below)
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// the calling thread arrives on bar and adds `bytes` to the transfers it
// waits for
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// `bytes` (a multiple of 16, both ends 16-byte aligned) from global memory
// into this CTA's shared memory by the Tensor Memory Accelerator, counted
// on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// wait for bar's phase of parity `parity` to complete; a wait far longer
// than any transfer traps, so a fault surfaces as a launch error, not a hang
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  for (long long spins = 0; !done; ++spins) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (spins > (1ll << 28)) __trap();
  }
}

// depth rows of a streamed chunk of the float slice
constexpr int kGruChunk = 32;
// the most threads that share a tile's depth (a power of two)
constexpr int kGruMaxSplits = 16;

template <typename TV, typename TX = float>
struct GruFwdArgs {
  const TX* xp;     // (T, B, 3H), x @ W + b: float32, or bf16 (X)
  const TV* h0;     // (B, H)
  const TV* u;      // (H, 3H)
  TV* hseq;         // (T, B, H) or null
  TV* hlast;        // (B, H) or null
  int T, B, H;
  int rows;    // batch rows per cluster
  int splits;  // threads sharing a tile's depth
  int stages;  // chunks in the streamed ring, 0 where the slice is resident
};

// Shared memory of a GRU chain CTA, in bytes: the slice (elem bytes a value)
// or the ring of `stages` chunks (float); the h and r h tiles in float, or
// in bf16 (elem 2) the h tile in bf16 (rows in m-tiles of 16, H + kHPad a
// row), the r h tile, z's tile and the float xp of z and r (rows, 2 Hc +
// kXsPad); the partials of splits 1 and up and the owners' xp of the step to
// come (kTileStride floats a tile of 8 rows). ops/_layout.py's
// gru_chain_smem computes the same.
__host__ __device__ constexpr size_t gru_chain_smem(int H, int C, int rows, int splits,
                                                    int stages, int elem) {
  const size_t Hc = H / C, R8 = round8(rows);
  const size_t tiles = (size_t)splits * kTileStride * Hc * (R8 / 8) * 4;
  if (elem == 2) {
    return 3 * Hc * H * 2 + (size_t)16 * ((rows + 15) / 16) * (H + kHPad) * 2 + H * R8 * 4 +
           R8 * Hc * 4 + (size_t)rows * (2 * Hc + kXsPad) * 4 + tiles;
  }
  return (stages ? (size_t)stages * kGruChunk * 2 * Hc * 4 : 3 * Hc * H * elem) +
         2 * H * R8 * 4 + tiles;
}

// The partials of the splits (NQ gates of a tile's 8 rows) summed into split
// 0's, in split order, through `part` (S - 1, ntiles, kTileStride); every
// thread of the CTA calls it
template <int NQ>
__device__ __forceinline__ void gru_reduce(float (&acc)[NQ][8], float* part, int S, int ntiles,
                                           int tile, int split) {
  if (S == 1) return;
  if (split > 0 && split < S) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        part[((size_t)(split - 1) * ntiles + tile) * kTileStride + 8 * q + r] = acc[q][r];
      }
    }
  }
  __syncthreads();
  if (split == 0) {
    for (int s = 1; s < S; ++s) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          acc[q][r] += part[((size_t)(s - 1) * ntiles + tile) * kTileStride + 8 * q + r];
        }
      }
    }
  }
}

// acc[r] += h rows [k_lo, k_hi) of the tile (H, R8) at rows 8 ro + r .
// column `col` of src (row stride ld, holding depth k_base on)
template <int NQ, typename TU>
__device__ __forceinline__ void gru_product(const float* tile, int R8, int ro, const TU* src,
                                            int ld, const int (&col)[NQ], int k_lo, int k_hi,
                                            int k_base, float (&acc)[NQ][8]) {
  // 4 depth rows an iteration, their shared memory loads in flight
  // together (timed against 1, 2 and 8 on the H100: PERF.md, Findings)
#pragma unroll 4
  for (int k = k_lo; k < k_hi; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(tile + (size_t)k * R8 + 8 * ro);
    const float4 a1 = *reinterpret_cast<const float4*>(tile + (size_t)k * R8 + 8 * ro + 4);
    const float hv[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const TU* ur = src + (size_t)(k - k_base) * ld;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float uq = to_f32(ur[col[q]]);
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[q][r] = fmaf(hv[r], uq, acc[q][r]);
    }
  }
}

// Grid: clusters * C CTAs of kChainThreads, cluster dims (C, 1, 1).
template <int ACT, typename TV, bool STREAM>
__global__ void __launch_bounds__(kChainThreads, 1) gru_fwd_chain_kernel(
    const GruFwdArgs<TV> a) {
  extern __shared__ __align__(16) unsigned char gru_smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const int H = a.H, B = a.B, T = a.T, rows = a.rows, S = a.splits;
  const int Hc = H / C, G3 = 3 * Hc, R8 = round8(rows), ntiles = Hc * (R8 / 8);
  const int row0 = (blockIdx.x / C) * rows;
  const int tid = threadIdx.x;
  // thread tid works on tile tid % ntiles (unit ul, rows 8 ro ..) in split
  // tid / ntiles; split 0 owns the tile's pairs
  const int tile = tid % ntiles, split = tid / ntiles;
  const int ul = tile % Hc, ro = tile / Hc, unit = c * Hc + ul;
  const bool owner = split == 0;
  // shared memory: the slice (H, 3 Hc) of TV or the ring of chunks
  // (kGruChunk, 2 Hc) of float | the h tile (H, R8) | the r h tile (H, R8) |
  // the partials (S - 1, ntiles, kTileStride) | the owners' xp
  // (ntiles, kTileStride)
  TV* slice = reinterpret_cast<TV*>(gru_smem_raw);
  float* ring = reinterpret_cast<float*>(gru_smem_raw);
  const size_t slice_bytes =
      STREAM ? (size_t)a.stages * kGruChunk * 2 * Hc * 4 : (size_t)G3 * H * sizeof(TV);
  float* hbuf = reinterpret_cast<float*>(gru_smem_raw + slice_bytes);
  const size_t hsize = (size_t)H * R8;
  float* rhbuf = hbuf + hsize;
  float* part = rhbuf + hsize;
  float* xs = part + (size_t)(S - 1) * ntiles * kTileStride + (size_t)tile * kTileStride;

  // the streamed ring: chunk j of the sequence is step j / (2 n)'s P1 (z and
  // r columns) or P2 (candidate columns) chunk of depth rows
  // kGruChunk ((j % (2 n)) % n) ..
  const int n_chunks = STREAM ? H / kGruChunk : 1;
  const int total_chunks = T * 2 * n_chunks;
  const size_t slot_floats = (size_t)kGruChunk * 2 * Hc;
  auto copy_chunk = [&](int j) {
    const int p2 = (j % (2 * n_chunks)) >= n_chunks, d = j % n_chunks;
    const int w = p2 ? Hc : 2 * Hc, per_row = w / 4;
    float* dst = ring + (size_t)(j % a.stages) * slot_floats;
    const float* src = reinterpret_cast<const float*>(a.u) + (size_t)d * kGruChunk * 3 * H;
    for (int i = tid; i < kGruChunk * per_row; i += blockDim.x) {
      const int k = i / per_row, gl = 4 * (i % per_row);
      const int q = p2 ? 2 : gl / Hc, u0 = p2 ? gl : gl % Hc;
      cp_async16(dst + (size_t)k * w + gl, src + (size_t)k * 3 * H + q * H + c * Hc + u0);
    }
  };
  if constexpr (STREAM) {
    for (int j = 0; j < a.stages - 1; ++j) {
      if (j < total_chunks) copy_chunk(j);
      cp_async_commit();
    }
  } else {
    constexpr int kVec = 16 / sizeof(TV);  // values a 16-byte copy
    const int per_row = G3 / kVec;
    for (int i = tid; i < H * per_row; i += blockDim.x) {
      const int k = i / per_row, gl = kVec * (i % per_row), q = gl / Hc, u0 = gl % Hc;
      cp_async16(slice + (size_t)k * G3 + gl, a.u + (size_t)k * 3 * H + q * H + c * Hc + u0);
    }
    cp_async_commit();
  }
  for (size_t i = tid; i < 2 * hsize; i += blockDim.x) hbuf[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < rows * H; i += blockDim.x) {
    const int r = i / H, k = i % H;
    if (row0 + r < B) hbuf[(size_t)k * R8 + r] = to_f32(a.h0[(size_t)(row0 + r) * H + k]);
  }
  auto live = [&](int r) { return owner && 8 * ro + r < rows && row0 + 8 * ro + r < B; };
  // the owner copies xp of the step to come into its own slots of xs
  // (value (q, r) at 8 q + r): one copy group, waited for by itself
  auto load_xp = [&](int t) {
    const float* x = a.xp + ((size_t)t * B + row0 + 8 * ro) * 3 * H + unit;
#pragma unroll 1
    for (int r = 0; r < 8; ++r, x += 3 * H) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        if (live(r)) {
          cp_async4(xs + 8 * q + r, x + q * H);
        } else {
          xs[8 * q + r] = 0.0f;
        }
      }
    }
    cp_async_commit();
  };
  auto store_out = [&](int t, const float (&hv)[8]) {
    size_t o = (size_t)(row0 + 8 * ro) * H + unit;  // row, unit
#pragma unroll
    for (int r = 0; r < 8; ++r, o += H) {
      if (!live(r)) continue;
      if (a.hseq != nullptr) a.hseq[(size_t)t * B * H + o] = from_f32<TV>(hv[r]);
      if (a.hlast != nullptr && t == T - 1) a.hlast[o] = from_f32<TV>(hv[r]);
    }
  };
  // one phase's product: acc (zeroed here) = the tile (h or r h) . the NQ
  // columns col of the slice (resident) or of the phase's chunks (streamed,
  // row stride ld), over the thread's split of the depth
  int chunk_seq = 0;  // streamed chunks consumed so far (over all steps)
  auto product = [&](const float* src_tile, const auto& col, int ld, auto& acc) {
    constexpr int NQ = std::extent_v<std::remove_reference_t<decltype(col)>>;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[q][r] = 0.0f;
    }
    if constexpr (STREAM) {
      const int per = kGruChunk / S;
      for (int ch = 0; ch < n_chunks; ++ch) {
        // chunk chunk_seq has landed in every thread's copies, and every
        // thread is done with the ring slot the next copy refills
        cp_async_wait(a.stages - 2);
        __syncthreads();
        const int next = chunk_seq + a.stages - 1;
        if (next < total_chunks) copy_chunk(next);
        cp_async_commit();
        if (split < S) {
          const int k0 = ch * kGruChunk + split * per;
          gru_product<NQ>(src_tile, R8, ro, ring + (size_t)(chunk_seq % a.stages) * slot_floats,
                          ld, col, k0, k0 + per, ch * kGruChunk, acc);
        }
        ++chunk_seq;
      }
    } else if (split < S) {
      const int k0 = split * (H / S);
      gru_product<NQ>(src_tile, R8, ro, slice, G3, col, k0, k0 + H / S, 0, acc);
    }
  };
  if (owner) load_xp(0);
  if constexpr (!STREAM) cp_async_wait(0);
  // every CTA's tiles are set before a peer writes into them
  cluster_arrive();
  cluster_wait();

  // the columns P1 and P2 read: z and r of unit ul (the slice, a P1 chunk),
  // its candidate column (the slice, a P2 chunk)
  const int zr_cols[2] = {ul, Hc + ul};
  const int h_col[1] = {STREAM ? ul : 2 * Hc + ul};
  const size_t own = (size_t)c * Hc * R8;  // the CTA's columns of a tile, in floats
  for (int t = 0; t < T; ++t) {
    // P1
    float acc[2][8];
    product(hbuf, zr_cols, 2 * Hc, acc);
    gru_reduce(acc, part, S, ntiles, tile, split);
    // the owner's z and r; r h of its pairs into its tile. The owner's xp
    // copies have landed: the resident build's only pending group is
    // theirs; in the streamed one, P1's chunk waits have since left only
    // newer groups pending (stages <= H / kGruChunk)
    float hold[8], zv[8];
    if (owner) {
      if constexpr (!STREAM) cp_async_wait(0);
      const float* hr = hbuf + (size_t)unit * R8 + 8 * ro;
      float* rr = rhbuf + (size_t)unit * R8 + 8 * ro;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        hold[r] = hr[r];
        zv[r] = activate<kSigmoid>(acc[0][r] + xs[r]);
        rr[r] = activate<kSigmoid>(acc[1][r] + xs[8 + r]) * hold[r];
      }
    }
    __syncthreads();  // the CTA's columns of r h are in its tile
    // X1: its units' rows are one run of Hc R8 floats
    push_columns(cluster, reinterpret_cast<char*>(rhbuf), Hc * R8 / 4,
                 [&](int j) { return own * 4 + (size_t)16 * j; }, C, c);
    cluster_arrive();
    cluster_wait();
    // P2
    float acc_h[1][8];
    product(rhbuf, h_col, Hc, acc_h);
    gru_reduce(acc_h, part, S, ntiles, tile, split);
    float hv[8] = {};
    if (owner) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float hh = activate<ACT>(acc_h[0][r] + xs[16 + r]);
        hv[r] = 8 * ro + r < rows ? round_as<TV>(zv[r] * hold[r] + (1.0f - zv[r]) * hh) : 0.0f;
      }
    }
    if (t + 1 == T) {
      store_out(t, hv);
      break;
    }
    if (owner) {
      float* hr = hbuf + (size_t)unit * R8 + 8 * ro;
      *reinterpret_cast<float4*>(hr) = make_float4(hv[0], hv[1], hv[2], hv[3]);
      *reinterpret_cast<float4*>(hr + 4) = make_float4(hv[4], hv[5], hv[6], hv[7]);
    }
    __syncthreads();  // the CTA's columns of h_t are in its tile
    // X2, then the barrier; the step's outputs and the owner's next xp go to
    // and come from device memory while it completes
    push_columns(cluster, reinterpret_cast<char*>(hbuf), Hc * R8 / 4,
                 [&](int j) { return own * 4 + (size_t)16 * j; }, C, c);
    cluster_arrive();
    if (owner) load_xp(t + 1);
    store_out(t, hv);
    cluster_wait();
  }
}

// ---------------------------------------------------------------------------
// The bf16 build: P1 on the tensor cores
// ---------------------------------------------------------------------------

// h and U are exactly bf16, so P1 (h_{t-1} . U_zr) runs on mma.sync m16n8k16
// with float accumulators: _dot's preferred_element_type=float32 product,
// the sums in another order. h is held row-major in bf16 (16 mts, H +
// kHPad) and the z and r slice swizzled for ldmatrix (copy_slice_u, as the
// bf16 LSTM chain's); a warp owns (m-tile, group of 8 units) items, so each
// thread ends with z and r of four (row, unit) pairs, and writes r h (float)
// into the r h tile and z into z's tile. P2 takes float r h, so it stays
// FFMA over the candidate slice (bf16, widened), owned by tiles of 8 rows
// as in the float build, which read z back from its tile.
// TX: xp's type. A float xp's z and r go into xz by 8-byte copies, the
// candidate into xs by 4-byte ones; a bf16 xp's z and r by 4-byte copies
// into the same bytes of xz (read as bf16), its candidate (2 bytes, below
// cp.async's least) loaded into registers and stored widened into xs.
// Grid: clusters * C CTAs of kChainThreads, cluster dims (C, 1, 1).
template <int ACT, typename TX = float>
__global__ void __launch_bounds__(kChainThreads, 1) gru_fwd_chain_mma_kernel(
    const GruFwdArgs<bf16, TX> a) {
  extern __shared__ __align__(16) unsigned char gru_smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const int H = a.H, B = a.B, T = a.T, rows = a.rows, S = a.splits;
  const int Hc = H / C, G2 = 2 * Hc, HP = H + kHPad, mts = (rows + 15) / 16, ugs = Hc / 8;
  const int items = mts * ugs, R8 = round8(rows), ntiles = Hc * (R8 / 8), XZ = G2 + kXsPad;
  const int row0 = (blockIdx.x / C) * rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gid = lane >> 2,
            tig = lane & 3;
  // P2's tiles, as the float build's: tile tid % ntiles (unit ul, rows 8 ro
  // ..) in split tid / ntiles, split 0 the owner
  const int tile = tid % ntiles, split = tid / ntiles;
  const int ul = tile % Hc, ro = tile / Hc, unit = c * Hc + ul;
  const bool owner = split == 0;
  // shared memory: the z and r slice (H, 2 Hc), swizzled | the candidate
  // slice (H, Hc) | the h tile (16 mts, HP) | the r h tile (H, R8) | z's
  // tile (R8, Hc) | P1's xp of z and r (rows, XZ floats; a bf16 xp's at
  // the front of each row) | the partials (S - 1, ntiles, kTileStride) |
  // the owners' candidate xp (ntiles, kTileStride)
  bf16* slice_zr = reinterpret_cast<bf16*>(gru_smem_raw);
  bf16* slice_h = slice_zr + (size_t)H * G2;
  bf16* htile = slice_h + (size_t)H * Hc;
  float* rhbuf = reinterpret_cast<float*>(htile + (size_t)16 * mts * HP);
  float* ztile = rhbuf + (size_t)H * R8;
  TX* xz = reinterpret_cast<TX*>(ztile + (size_t)R8 * Hc);
  float* part = ztile + (size_t)R8 * Hc + (size_t)rows * XZ;
  float* xs = part + (size_t)(S - 1) * ntiles * kTileStride + (size_t)tile * kTileStride;

  copy_slice_u(a.u, slice_zr, H, Hc, c, 2, 3);
  for (int i = tid; i < H * ugs; i += blockDim.x) {
    const int n = i / ugs, j = i % ugs;
    cp_async16(slice_h + (size_t)n * Hc + 8 * j,
               a.u + (size_t)n * 3 * H + 2 * H + c * Hc + 8 * j);
  }
  cp_async_commit();
  {  // the h, r h, z and xp tiles start at zero (the padding rows stay so)
    int4* p = reinterpret_cast<int4*>(htile);
    const size_t n16 = ((size_t)16 * mts * HP * 2 + ((size_t)H * R8 + (size_t)R8 * Hc +
                                                     (size_t)rows * XZ) * 4) / 16;
    for (size_t i = tid; i < n16; i += blockDim.x) p[i] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();
  for (int i = tid; i < rows * H; i += blockDim.x) {
    const int r = i / H, k = i % H;
    if (row0 + r < B) htile[(size_t)r * HP + k] = a.h0[(size_t)(row0 + r) * H + k];
  }
  // P1's pairs: item it = warp + i kChainWarps is (m-tile it / ugs, units
  // 8 (it % ugs) ..); pair (i, half, e) is row 16 mt + gid + 8 half, local
  // unit 8 ug + 2 tig + e
  auto pair_row = [&](int i, int half) {
    return 16 * ((warp + i * kChainWarps) / ugs) + gid + 8 * half;
  };
  auto pair_ul = [&](int i) { return 8 * ((warp + i * kChainWarps) % ugs) + 2 * tig; };
  auto pair_ok = [&](int i, int half) {
    return warp + i * kChainWarps < items && pair_row(i, half) < rows;
  };
  auto live = [&](int r) { return owner && 8 * ro + r < rows && row0 + 8 * ro + r < B; };
  // the step's xp: z and r of the thread's P1 pairs into xz (8 bytes a
  // copy), the candidate of its P2 rows into xs; one copy group, waited for
  // by itself
  auto load_xp = [&](int t) {
    const TX* xt = a.xp + (size_t)t * B * 3 * H;
#pragma unroll
    for (int i = 0; i < kFwdMaxItems; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (!pair_ok(i, half)) continue;
        const int rl = pair_row(i, half), lu = pair_ul(i);
        TX* dst = xz + (size_t)rl * XZ + lu;
        const TX* x = xt + (size_t)(row0 + rl) * 3 * H + c * Hc + lu;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (row0 + rl < B) {
            if constexpr (std::is_same_v<TX, float>) {
              cp_async8(dst + q * Hc, x + q * H);
            } else {
              cp_async4(dst + q * Hc, x + q * H);
            }
          } else {
            dst[q * Hc] = dst[q * Hc + 1] = from_f32<TX>(0.0f);
          }
        }
      }
    }
    if (owner) {
      const TX* x = xt + (size_t)(row0 + 8 * ro) * 3 * H + 2 * H + unit;
      if constexpr (std::is_same_v<TX, float>) {
#pragma unroll 1
        for (int r = 0; r < 8; ++r, x += 3 * H) {
          if (live(r)) {
            cp_async4(xs + r, x);
          } else {
            xs[r] = 0.0f;
          }
        }
      } else {
        // the 8 loads in flight together, then widened into xs
        float v[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) v[r] = live(r) ? to_f32(x[(size_t)r * 3 * H]) : 0.0f;
#pragma unroll
        for (int r = 0; r < 8; ++r) xs[r] = v[r];
      }
    }
    cp_async_commit();
  };
  auto store_out = [&](int t, const float (&hv)[8]) {
    size_t o = (size_t)(row0 + 8 * ro) * H + unit;  // row, unit
#pragma unroll
    for (int r = 0; r < 8; ++r, o += H) {
      if (!live(r)) continue;
      if (a.hseq != nullptr) a.hseq[(size_t)t * B * H + o] = __float2bfloat16_rn(hv[r]);
      if (a.hlast != nullptr && t == T - 1) a.hlast[o] = __float2bfloat16_rn(hv[r]);
    }
  };
  load_xp(0);
  cp_async_wait(0);
  // every CTA's tiles are set before a peer writes into them
  cluster_arrive();
  cluster_wait();

  // ldmatrix rows: A (h) row 16 mt + (lane & 7) + 8 ((lane >> 3) & 1), depth
  // + 8 (lane >> 4); B (the slice) depth (lane & 7) + 8 ((lane >> 3) & 1),
  // gate lane >> 4 (z or r)
  const int a_r = (lane & 7) + 8 * ((lane >> 3) & 1), a_k = 8 * (lane >> 4);
  const int b_k = (lane & 7) + 8 * ((lane >> 3) & 1), b_q = lane >> 4;
  const size_t own = (size_t)c * Hc * R8;  // the CTA's columns of the r h tile
  const int h_col[1] = {ul};
  for (int t = 0; t < T; ++t) {
    // P1: acc[i][q][2 half + e] is gate q (z, r) of pair (i, half, e)
    float acc[kFwdMaxItems][2][4];
#pragma unroll
    for (int i = 0; i < kFwdMaxItems; ++i) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.0f;
      }
      const int it = warp + i * kChainWarps;
      if (it >= items) continue;
      const int mt = it / ugs, ug = it % ugs;
      const bf16* a_row = htile + (size_t)(16 * mt + a_r) * HP + a_k;
      const int j0 = b_q * ugs + ug;
#pragma unroll 4
      for (int k0 = 0; k0 < H; k0 += 16) {
        unsigned a0, a1, a2, a3, b00, b01, b10, b11;
        ldmatrix_x4(a_row + k0, a0, a1, a2, a3);
        const int k = k0 + b_k;
        ldmatrix_x4_trans(slice_zr + (size_t)k * G2 + ((j0 ^ (k & 7)) << 3), b00, b01, b10, b11);
        mma_bf16(acc[i][0], a0, a1, a2, a3, b00, b01);
        mma_bf16(acc[i][1], a0, a1, a2, a3, b10, b11);
      }
    }
    // z and r of the pairs (the step's xp has landed: the thread's only
    // pending group); r h into the r h tile, z into z's tile
    cp_async_wait(0);
#pragma unroll
    for (int i = 0; i < kFwdMaxItems; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (!pair_ok(i, half)) continue;
        const int rl = pair_row(i, half);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int lu = pair_ul(i) + e;
          const TX* x = xz + (size_t)rl * XZ + lu;
          const float z = activate<kSigmoid>(acc[i][0][2 * half + e] + to_f32(x[0]));
          const float r = activate<kSigmoid>(acc[i][1][2 * half + e] + to_f32(x[Hc]));
          const float hp = __bfloat162float(htile[(size_t)rl * HP + c * Hc + lu]);
          rhbuf[(size_t)(c * Hc + lu) * R8 + rl] = r * hp;
          ztile[(size_t)rl * Hc + lu] = z;
        }
      }
    }
    __syncthreads();  // the CTA's columns of r h are in its tile
    push_columns(cluster, reinterpret_cast<char*>(rhbuf), Hc * R8 / 4,
                 [&](int j) { return own * 4 + (size_t)16 * j; }, C, c);
    cluster_arrive();
    cluster_wait();
    // P2 as FFMA: (rows, Hc) = (r h) . the candidate slice
    float acc_h[1][8] = {};
    if (split < S) {
      const int k0 = split * (H / S);
      gru_product<1>(rhbuf, R8, ro, slice_h, Hc, h_col, k0, k0 + H / S, 0, acc_h);
    }
    gru_reduce(acc_h, part, S, ntiles, tile, split);
    float hv[8] = {};
    if (owner) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int rl = 8 * ro + r;
        if (rl >= rows) continue;
        const float z = ztile[(size_t)rl * Hc + ul];
        const float hold = __bfloat162float(htile[(size_t)rl * HP + unit]);
        const float hh = activate<ACT>(acc_h[0][r] + xs[r]);
        hv[r] = round_as<bf16>(z * hold + (1.0f - z) * hh);
      }
    }
    if (t + 1 == T) {
      store_out(t, hv);
      break;
    }
    if (owner) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (8 * ro + r < rows) htile[(size_t)(8 * ro + r) * HP + unit] = __float2bfloat16_rn(hv[r]);
      }
    }
    __syncthreads();  // the CTA's columns of h_t are in its tile
    // X2: rows x Hc / 8 chunks of 16 bytes, then the barrier; the step's
    // outputs and the next xp go to and come from device memory meanwhile
    const int per_row = ugs;
    push_columns(cluster, reinterpret_cast<char*>(htile), rows * per_row,
                 [&](int j) {
                   return ((size_t)(j / per_row) * HP + c * Hc + 8 * (j % per_row)) * 2;
                 },
                 C, c);
    cluster_arrive();
    load_xp(t + 1);
    store_out(t, hv);
    cluster_wait();
  }
}

// ---------------------------------------------------------------------------
// F's tensor-core instance: the float32 chain with the slice streamed by the
// Tensor Memory Accelerator and both products on the tensor cores
// ---------------------------------------------------------------------------

// (m-tile, n-tile) items a warp owns in a phase
constexpr int kTcMaxItems = 4;

// The slice of U packed per CTA (ops/gru_layer.py::pack_tc_slices) in the
// order mma.sync's B fragments are read: for each 8 depth rows (a k-step)
// and each 8 columns (an n-tile) of a CTA's P1 slice (H, 2 Hc: z and r of
// its units) or P2 slice (H, Hc: the candidate), 32 lanes x 2 values, lane
// 4 g + t holding depth rows t and t + 4 of column g. A chunk of `chunk`
// depth rows of either is one contiguous block. TV: float32 (kernel F) or
// bf16 (kernel X's streamed instance, gru_encoder_scan.cu), the type of
// every operand and output.
template <typename TV = float>
struct GruFwdTcArgs {
  const TV* xp;   // (T, B, 3H)
  const TV* h0;   // (B, H)
  const TV* pzr;  // (C, H / 8, 2 Hc / 8, 64)
  const TV* ph;   // (C, H / 8, Hc / 8, 64)
  TV* hseq;       // (T, B, H)
  int T, B, H;
  int rows;    // batch rows per cluster
  int stages;  // slots of the ring
  int chunk;   // depth rows of a chunk (32, 64 or 128)
};

// the row stride of the tensor-core instance's h and r h tiles: the rows
// rounded to 8, and 8 floats more where that is a multiple of 16, so that a
// warp's A-fragment loads (rows g, depths t) hit 32 banks. An m-tile's rows
// past the stride (rows rounded to 8 but not to 16) read the next depth
// row's values (past the r h tile's last: the gate sums), whose products
// land in gate rows no owner reads.
__host__ __device__ constexpr int gru_tc_stride(int rows) {
  return round8(rows) % 16 ? round8(rows) : round8(rows) + 8;
}
// depth splits of a phase of `items` (m-tile, n-tile) items over the CTA's
// `warps`: the warps left idle by few items share each item's k-steps
__host__ __device__ constexpr int gru_tc_splits(int items, int ksteps, int warps = kChainWarps) {
  int s = 1;
  while (2 * s * items <= warps && ksteps % (2 * s) == 0) s *= 2;
  return s;
}

// Shared memory of the tensor-core instance, in bytes: the ring (stages x
// chunk x 2 Hc values of `elem` bytes) | the h and r h tiles (H x
// gru_tc_stride floats) | the phases' gate sums (splits x rows in m-tiles x
// (columns + 8)) | the owners' xp (8 rows x 3 gates a tile of 8 rows,
// kTileStride floats). ops/_layout.py's gru_tc_smem computes the same.
__host__ __device__ constexpr size_t gru_tc_smem(int H, int C, int rows, int stages, int chunk,
                                                 int elem = 4) {
  const int Hc = H / C, mts = (rows + 15) / 16, RS = gru_tc_stride(rows);
  const int s1 = gru_tc_splits(mts * 2 * Hc / 8, chunk / 8);
  const int s2 = gru_tc_splits(mts * Hc / 8, chunk / 8);
  const size_t g1 = (size_t)s1 * 16 * mts * (2 * Hc + 8), g2 = (size_t)s2 * 16 * mts * (Hc + 8);
  return (size_t)elem * stages * chunk * 2 * Hc +
         4 * (2 * (size_t)H * RS + (g1 > g2 ? g1 : g2) +
              (size_t)Hc * (round8(rows) / 8) * kTileStride);
}

// B fragments of a packed slice: two float32 values (3 products: split), or
// two bf16 values in one 32-bit word (exact in TF32)
__device__ __forceinline__ void tc_b_frag(const float* p, unsigned (&hi)[2], unsigned (&lo)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  tc::split<true>(v.x, hi[0], lo[0]);
  tc::split<true>(v.y, hi[1], lo[1]);
}
__device__ __forceinline__ void tc_b_frag(const bf16* p, unsigned (&hi)[2], unsigned (&lo)[2]) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  hi[0] = w << 16;  // a bf16 value's bits are the top half of its float's
  hi[1] = w & 0xffff0000u;
  lo[0] = lo[1] = 0u;
}

// One segment of a chain's step on the tensor cores, shared by F's
// instance and D wide's (gru_decode_chain.cuh): gate sums = a tile of
// shared memory (depth rows of rows, row stride RS: h, r h or x) . `width`
// columns of a slice packed in B-fragment order, streamed through the
// ring in n chunks of ksteps k-steps of 8 depth rows. A warp owns the
// (m-tile, n-tile) items it, it + stride, ... (stride = the warps of a
// split) of one of `splits` shares of each chunk's k-steps; each chunk's
// products go into zeroed accumulators that one float add joins to the
// running sums (the tensor cores truncate as they add), and at the end
// every split's sums land in its gate tile (16 mts x (width + 8) floats at
// gsum + split x that). P products a k-step: 3 (both operands float32,
// split), 2 (the tile's float32 values split, the weights exact), 1 (both
// exact in TF32: bf16 values). Chunk seq (counted over the chain) sits in
// slot seq % stages; next(j) asks for chunk j into its slot. Every thread of
// the CTA (WARPS warps, each at most MI items) calls it; it ends with a
// barrier.
template <int P, int MI = kTcMaxItems, int WARPS = kChainWarps, typename TW, typename Next>
__device__ __forceinline__ void tc_segment(const float* tile, int RS, int mts, int width, int items,
                                           int splits, int ksteps, const TW* ring,
                                           size_t slot_elems, int stages, int n, int total,
                                           int& seq, unsigned long long* bars, Next next,
                                           float* gsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gid = lane >> 2, tig = lane & 3;
  const int nts = width / 8, per = ksteps / splits, stride = WARPS / splits;
  const int split = warp / stride, first = warp % stride;
  float run[MI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) run[i][e] = 0.0f;
  }
  for (int ch = 0; ch < n; ++ch) {
    // every thread is done with the slot the next copy refills; then chunk
    // seq has landed
    __syncthreads();
    if (tid == 0 && seq + stages - 1 < total) next(seq + stages - 1);
    mbar_wait(&bars[seq % stages], (seq / stages) & 1);
    const TW* slot = ring + (size_t)(seq % stages) * slot_elems;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int it = first + i * stride;
      if (it >= items) break;
      const int mt = it / nts, nt = it % nts;
      float st[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const int k0 = ch * 8 * ksteps + split * per * 8;
      const float* arow = tile + (size_t)(k0 + tig) * RS + 16 * mt + gid;
      const TW* brow = slot + (((size_t)split * per * nts + nt) * 32 + lane) * 2;
#pragma unroll 2
      for (int ks = 0; ks < per; ++ks) {
        const float* ap = arow + (size_t)ks * 8 * RS;
        unsigned ah[4], al[4], bh[2], bl[2];
        tc::split<P >= 2>(ap[0], ah[0], al[0]);
        tc::split<P >= 2>(ap[8], ah[1], al[1]);
        tc::split<P >= 2>(ap[4 * RS], ah[2], al[2]);
        tc::split<P >= 2>(ap[4 * RS + 8], ah[3], al[3]);
        tc_b_frag(brow + (size_t)ks * nts * 64, bh, bl);
        if constexpr (P >= 2) tc::mma_tf32(st, al, bh[0], bh[1]);
        if constexpr (P == 3) tc::mma_tf32(st, ah, bl[0], bl[1]);
        tc::mma_tf32(st, ah, bh[0], bh[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) run[i][e] += st[e];
    }
    ++seq;
  }
  // each split's sums into its gate tile: c0, c1 at (row g, columns 2 t,
  // 2 t + 1), c2, c3 eight rows below
  float* g = gsum + (size_t)split * 16 * mts * (width + 8);
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int it = first + i * stride;
    if (it >= items) break;
    const int mt = it / nts, nt = it % nts;
    float* o = g + (size_t)(16 * mt + gid) * (width + 8) + 8 * nt + 2 * tig;
    *reinterpret_cast<float2*>(o) = make_float2(run[i][0], run[i][1]);
    *reinterpret_cast<float2*>(o + 8 * (width + 8)) = make_float2(run[i][2], run[i][3]);
  }
  __syncthreads();
}

// A gate column's sum over a segment's splits, in split order: row `row`,
// column `col` of the gate tiles at gsum (16 mts x (width + 8) floats each)
__device__ __forceinline__ float tc_gate(const float* gsum, int mts, int width, int splits,
                                         int row, int col) {
  float s = 0.0f;
  for (int sp = 0; sp < splits; ++sp) s += gsum[((size_t)sp * 16 * mts + row) * (width + 8) + col];
  return s;
}

// Grid: clusters * C CTAs of kChainThreads, cluster dims (C, 1, 1).
//
// A step is A's float chain's (P1, X1, P2, X2, two cluster barriers) with
// its products on mma.sync m16n8k8 as three TF32 products (gemm_tc.cuh: the
// operands split into a TF32 part and its remainder, a_lo b_hi + a_hi b_lo +
// a_hi b_hi; tc_segment), the phase's sums in shared-memory gate tiles that
// the owners (one thread a unit and 8 rows, as in A's chain) sum over the
// splits in split order; they finish the gates, exchange r h and h_t and
// store the sequence. The slice streams through a ring of
// `stages` slots of `chunk` depth rows (P1's chunks 2 Hc columns wide,
// P2's Hc) that runs on across the phases and steps; thread 0 asks the
// Tensor Memory Accelerator for each chunk, one contiguous block of the
// packed slice, its completion counted on the slot's mbarrier.
//
// The bf16 instance (TV = bf16, kernel X where its slice does not fit a
// CTA: H = 1024) streams the bf16 slice, half the bytes a chunk, and keeps
// X's roundings: h and U are exactly bf16, so P1 is one TF32 product each
// (bf16 values are exact in TF32: the Pallas dot's products, summed in
// float); r h is float, so P2 splits it in two TF32 parts against the exact
// U_h (2^-22 of r h left out, against X's FFMA over the float r h); xp and
// h0 are bf16, widened as they are read, and h is rounded to bf16 once a
// step (the carried state and the sequence; X's wrapper takes the final h
// from the sequence).
template <int ACT, typename TV = float>
__global__ void __launch_bounds__(kChainThreads, 1) gru_fwd_chain_tc_kernel(
    const GruFwdTcArgs<TV> a) {
  constexpr bool kBf16 = std::is_same_v<TV, bf16>;
  // TF32 products a k-step of P1 (h . U_zr) and P2 ((r h) . U_h)
  constexpr int kP1 = kBf16 ? 1 : 3, kP2 = kBf16 ? 2 : 3;
  extern __shared__ __align__(16) unsigned char gru_smem_raw[];
  __shared__ unsigned long long bars[8];  // a slot's transfer
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const int H = a.H, B = a.B, T = a.T, rows = a.rows, K = a.chunk;
  const int Hc = H / C, R8 = round8(rows), ntiles = Hc * (R8 / 8), RS = gru_tc_stride(rows);
  const int mts = (rows + 15) / 16, ksteps = K / 8;
  const int row0 = (blockIdx.x / C) * rows;
  const int tid = threadIdx.x;
  // owners: thread tid < ntiles owns unit ul of rows 8 ro ..
  const bool owner = tid < ntiles;
  const int ul = tid % Hc, ro = tid / Hc, unit = c * Hc + ul;
  // the phases' items and depth splits
  const int items1 = mts * 2 * Hc / 8, items2 = mts * Hc / 8;
  const int s1 = gru_tc_splits(items1, ksteps), s2 = gru_tc_splits(items2, ksteps);
  // shared memory: the ring | the h tile (H, RS) | the r h tile (H, RS) |
  // the gate sums | the owners' xp
  TV* ring = reinterpret_cast<TV*>(gru_smem_raw);
  const size_t slot_elems = (size_t)K * 2 * Hc;
  float* hbuf = reinterpret_cast<float*>(ring + (size_t)a.stages * slot_elems);
  float* rhbuf = hbuf + (size_t)H * RS;
  float* gsum = rhbuf + (size_t)H * RS;
  const size_t g1 = (size_t)s1 * 16 * mts * (2 * Hc + 8), g2 = (size_t)s2 * 16 * mts * (Hc + 8);
  float* xs = gsum + (g1 > g2 ? g1 : g2) + (size_t)(owner ? tid : 0) * kTileStride;

  const int n_chunks = H / K, total_chunks = T * 2 * n_chunks;
  // chunk j of the sequence (thread 0 alone): step j / (2 n)'s P1 or P2
  // chunk (j % n) into slot j % stages
  auto copy_chunk = [&](int j) {
    const int p2 = (j % (2 * n_chunks)) >= n_chunks, d = j % n_chunks;
    const int w = p2 ? Hc : 2 * Hc;
    const TV* src = (p2 ? a.ph : a.pzr) + ((size_t)c * H + (size_t)d * K) * w;
    const unsigned bytes = K * w * sizeof(TV);
    unsigned long long* bar = &bars[j % a.stages];
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, bytes);
    bulk_copy(ring + (size_t)(j % a.stages) * slot_elems, src, bytes, bar);
  };
  if (tid == 0) {
    for (int j = 0; j < a.stages; ++j) mbar_init(&bars[j], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < a.stages - 1 && j < total_chunks; ++j) copy_chunk(j);
  }
  for (size_t i = tid; i < 2 * (size_t)H * RS; i += blockDim.x) hbuf[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < rows * H; i += blockDim.x) {
    const int r = i / H, k = i % H;
    if (row0 + r < B) hbuf[(size_t)k * RS + r] = to_f32(a.h0[(size_t)(row0 + r) * H + k]);
  }
  auto live = [&](int r) { return owner && 8 * ro + r < rows && row0 + 8 * ro + r < B; };
  // the owner copies xp of the step to come into xs (value (q, r) at
  // 8 q + r): float32 in one copy group, waited for by itself; bf16 (2
  // bytes, below cp.async's least) loaded into registers, a gate's 8 rows
  // in flight together, and stored widened
  auto load_xp = [&](int t) {
    if (!owner) return;
    const TV* x = a.xp + ((size_t)t * B + row0 + 8 * ro) * 3 * H + unit;
    if constexpr (kBf16) {
#pragma unroll 1
      for (int q = 0; q < 3; ++q) {
        float v[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) v[r] = live(r) ? to_f32(x[(size_t)r * 3 * H + q * H]) : 0.0f;
#pragma unroll
        for (int r = 0; r < 8; ++r) xs[8 * q + r] = v[r];
      }
    } else {
#pragma unroll 1
      for (int r = 0; r < 8; ++r, x += 3 * H) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          if (live(r)) {
            cp_async4(xs + 8 * q + r, x + q * H);
          } else {
            xs[8 * q + r] = 0.0f;
          }
        }
      }
      cp_async_commit();
    }
  };
  // one phase's product: gate sums (16 mts, width + 8) of each split = the
  // tile (h or r h) . the phase's width columns, streamed in n_chunks chunks
  int chunk_seq = 0;
  auto gate = [&](int width, int splits, int col, int r) {
    return tc_gate(gsum, mts, width, splits, 8 * ro + r, col);
  };
  load_xp(0);
  // every CTA's tiles are set before a peer writes into them
  cluster_arrive();
  cluster_wait();

  const size_t own = (size_t)c * Hc * RS;  // the CTA's columns of a tile, in floats
  for (int t = 0; t < T; ++t) {
    // P1
    tc_segment<kP1>(hbuf, RS, mts, 2 * Hc, items1, s1, ksteps, ring, slot_elems, a.stages,
                    n_chunks, total_chunks, chunk_seq, bars, copy_chunk, gsum);
    float hold[8], zv[8];
    if (owner) {
      if constexpr (!kBf16) cp_async_wait(0);  // the owner's xp of the step
      const float* hr = hbuf + (size_t)unit * RS + 8 * ro;
      float* rr = rhbuf + (size_t)unit * RS + 8 * ro;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        hold[r] = hr[r];
        zv[r] = activate<kSigmoid>(gate(2 * Hc, s1, ul, r) + xs[r]);
        rr[r] = activate<kSigmoid>(gate(2 * Hc, s1, Hc + ul, r) + xs[8 + r]) * hold[r];
      }
    }
    __syncthreads();  // the CTA's columns of r h are in its tile
    // X1: its units' rows are one run of Hc RS floats
    push_columns(cluster, reinterpret_cast<char*>(rhbuf), Hc * RS / 4,
                 [&](int j) { return own * 4 + (size_t)16 * j; }, C, c);
    cluster_arrive();
    cluster_wait();
    // P2
    tc_segment<kP2>(rhbuf, RS, mts, Hc, items2, s2, ksteps, ring, slot_elems, a.stages, n_chunks,
                    total_chunks, chunk_seq, bars, copy_chunk, gsum);
    float hv[8] = {};
    if (owner) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float hh = activate<ACT>(gate(Hc, s2, ul, r) + xs[16 + r]);
        hv[r] = 8 * ro + r < rows ? round_as<TV>(zv[r] * hold[r] + (1.0f - zv[r]) * hh) : 0.0f;
      }
    }
    auto store_out = [&]() {
      size_t o = ((size_t)t * B + row0 + 8 * ro) * H + unit;
#pragma unroll
      for (int r = 0; r < 8; ++r, o += H) {
        if (live(r)) a.hseq[o] = from_f32<TV>(hv[r]);
      }
    };
    if (t + 1 == T) {
      store_out();
      break;
    }
    if (owner) {
      float* hr = hbuf + (size_t)unit * RS + 8 * ro;
      *reinterpret_cast<float4*>(hr) = make_float4(hv[0], hv[1], hv[2], hv[3]);
      *reinterpret_cast<float4*>(hr + 4) = make_float4(hv[4], hv[5], hv[6], hv[7]);
    }
    __syncthreads();  // the CTA's columns of h_t are in its tile
    // X2, then the barrier; the step's outputs and the owner's next xp go to
    // and come from device memory while it completes
    push_columns(cluster, reinterpret_cast<char*>(hbuf), Hc * RS / 4,
                 [&](int j) { return own * 4 + (size_t)16 * j; }, C, c);
    cluster_arrive();
    load_xp(t + 1);
    store_out();
    cluster_wait();
  }
}

// The tensor-core instance at its plan (ops/_layout.py::gru_tc_plan:
// cluster size, rows a cluster, stages, chunk; the ring's values TV);
// cudaErrorInvalidValue for a plan it does not run.
template <int ACT, typename TV = float>
int launch_gru_fwd_tc(const GruFwdTcArgs<TV>& a, int cluster, void* stream) {
  const int H = a.H, K = a.chunk;
  if (a.T < 1 || a.B < 1 || cluster < 1 || cluster > kMaxCluster || H % cluster != 0 ||
      a.rows < 1 || (K != 32 && K != 64 && K != 128) || H % K != 0 || a.stages < 2 ||
      a.stages > 8 || a.hseq == nullptr ||
      (reinterpret_cast<size_t>(a.pzr) & 15) != 0 || (reinterpret_cast<size_t>(a.ph) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int Hc = H / cluster, mts = (a.rows + 15) / 16;
  if (Hc % 8 != 0 || Hc * (round8(a.rows) / 8) > kChainThreads ||
      (mts * 2 * Hc / 8 + kChainWarps - 1) / kChainWarps > kTcMaxItems) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = gru_tc_smem(H, cluster, a.rows, a.stages, K, sizeof(TV));
  if (smem > 232448 - 1024) return (int)cudaErrorInvalidValue;
  auto kernel = gru_fwd_chain_tc_kernel<ACT, TV>;
  cudaError_t err = cluster_config(kernel, cluster, smem);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch l((a.B + a.rows - 1) / a.rows * cluster, cluster, smem, stream);
  err = cudaLaunchKernelEx(&l.cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters of the tensor-core instance of values TV
// at `cluster` CTAs a cluster (one CTA an SM: the whole of a block's shared
// memory beside the ring's mbarriers)
template <typename TV>
int gru_fwd_tc_max_clusters(int cluster, int* out) {
  const size_t smem = 232448 - 1024;
  auto kernel = gru_fwd_chain_tc_kernel<kTanh, TV>;
  cudaError_t err = cluster_config(kernel, cluster, smem);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch l(cluster, cluster, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &l.cfg);
}

template <typename Args>
int launch_gru_instance(void (*kernel)(Args), const Args& a, int cluster, size_t smem,
                        void* stream) {
  cudaError_t err = cluster_config(kernel, cluster, smem);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch l((a.B + a.rows - 1) / a.rows * cluster, cluster, smem, stream);
  err = cudaLaunchKernelEx(&l.cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The chain of one layer at the plan of ops/_layout.py::gru_fwd_plan
// (cluster size, rows a cluster, splits, streamed ring); cudaErrorInvalidValue
// for a plan the build does not run. TX: xp's type (bf16 only in the bf16
// build).
template <typename TV, int ACT, typename TX = float>
int launch_gru_fwd_chain(const GruFwdArgs<TV, TX>& a, int cluster, void* stream) {
  constexpr bool kMma = std::is_same_v<TV, bf16>;
  static_assert(kMma || std::is_same_v<TX, float>, "the float32 build reads a float32 xp");
  // units a 16-byte copy of the slice takes; in bf16, 2 Hc / 8 chunks a
  // multiple of 8 for the swizzle
  constexpr int kUnits = kMma ? 32 : 4;
  const int H = a.H, S = a.splits;
  if (a.T < 1 || a.B < 1 || cluster < 1 || cluster > kMaxCluster || H % cluster != 0 ||
      a.rows < 1 || S < 1 || (S & (S - 1)) != 0 || S > kGruMaxSplits ||
      (a.hseq == nullptr) == (a.hlast == nullptr) ||
      (reinterpret_cast<size_t>(a.u) & 15) != 0 ||
      (reinterpret_cast<size_t>(a.xp) & (kMma ? 2 * sizeof(TX) - 1 : 3)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int Hc = H / cluster, tiles = Hc * (round8(a.rows) / 8);
  if (Hc % kUnits != 0 || tiles * S > kChainThreads) return (int)cudaErrorInvalidValue;
  if (kMma && (a.stages != 0 || (a.rows + 15) / 16 * (Hc / 8) > kFwdMaxItems * kChainWarps)) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.stages != 0) {
    if (a.stages < 2 || a.stages > 8 || H % kGruChunk != 0 || kGruChunk % S != 0 ||
        a.stages > H / kGruChunk) {
      return (int)cudaErrorInvalidValue;
    }
  } else if (H % S != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = gru_chain_smem(H, cluster, a.rows, S, a.stages, sizeof(TV));
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if constexpr (kMma) {
    return launch_gru_instance(gru_fwd_chain_mma_kernel<ACT, TX>, a, cluster, smem, stream);
  } else {
    return launch_gru_instance(a.stages != 0 ? gru_fwd_chain_kernel<ACT, TV, true>
                                             : gru_fwd_chain_kernel<ACT, TV, false>,
                               a, cluster, smem, stream);
  }
}

// cudaOccupancyMaxActiveClusters of the chain's build (the resident or the
// streamed slice; TX: the bf16 build's xp type) at `cluster` CTAs a cluster
// (one CTA an SM)
template <typename TV, typename TX = float>
int gru_fwd_max_clusters(int cluster, int stream_slice, int* out) {
  if constexpr (std::is_same_v<TV, float>) {
    return stream_slice ? max_active_clusters(gru_fwd_chain_kernel<kTanh, TV, true>, cluster, out)
                        : max_active_clusters(gru_fwd_chain_kernel<kTanh, TV, false>, cluster, out);
  } else {
    if (stream_slice) return (int)cudaErrorInvalidValue;
    return max_active_clusters(gru_fwd_chain_mma_kernel<kTanh, TX>, cluster, out);
  }
}

}  // namespace mvt
