// Shared device code of the LSTM forward kernels over a precomputed
// x-projection (Q: lstm_layer_xp_fwd.cu, Y: lstm_encoder_scan.cu, and L's
// chain after its x @ W pre-pass: lstm_layer_fwd.cu): the serial chain of
// one LSTM layer on thread-block clusters.
//
// Math (midi_vae_tpu/ops/fused_train.py::_lstm_fwd_kernel :1331-1349 and
// fused_lstm.py::_encoder_kernel :228-249, both around _lstm_gates):
//   [i, f, g, o] = xp_t + h_{t-1} . U          (the products summed in float)
//   c' = sig(f) c + sig(i) act(g);   h' = sig(o) act(c')
// h' comes from the unrounded c'; h and c are rounded to the build's type
// where the Pallas scratch holds them (a no-op in float). act is tanh for Q;
// tanh, sigmoid or relu for Y and L.
//
// Layout. One cluster of C CTAs (512 threads each, one an SM) owns `rows`
// batch rows for all T steps. CTA c owns the hidden units [c Hc, (c+1) Hc),
// Hc = H / C, and their 4 Hc gate columns of U (an H x 4 Hc slice), so it
// finishes its own units' cell math with no sum across CTAs. Each CTA holds
// the whole h_{t-1} of its rows in shared memory (in bf16 twice: h_{t-1}
// read, h_t written). A step:
//   P  gates (rows, 4 Hc) = h_{t-1} (rows, H) . U slice, plus xp_t's own
//      columns (loaded one step ahead: into registers in bf16, into shared
//      memory by cp.async where xp is float);
//   E  the cell math of the CTA's own (unit, row) pairs in registers (c
//      carried there: float, or rounded to bf16 each step in bf16), h and c
//      out to the sequences, h' (rounded as the build holds it) into the
//      CTA's own columns of the other h tile;
//   X  the CTA copies its columns of that tile into every peer's (16-byte
//      stores through distributed shared memory), then one cluster barrier.
// Each element of h has one writer, so the order of the copies changes no
// bit. In bf16, two h tiles make one barrier a step enough: a peer writes step t's
// tile only after the barrier of step t-1, which every CTA reaches after it
// has read that tile for its step t-1 product.
// Every store into a peer's shared memory comes before a barrier that the
// peer waits at, so a CTA leaves after its last step with no closing
// barrier.
//
// The bf16 build (lstm_fwd_chain_mma_kernel) keeps its slice resident (128
// KiB at H = 256 in clusters of 4 and at H = 512 in clusters of 16; 144 KiB
// at H = 384 in clusters of 8) and takes P on the tensor cores: h and U are
// exactly bf16, so mma.sync m16n8k16 with float accumulators computes
// _lstm_gates' preferred_element_type=float32 product, the sums in another
// order. h is held row-major (rows, H + kHPad); a warp owns (m-tile of 16
// rows, group of 8 units) items and computes their four gates' n-tiles, so
// each thread ends with i, f, g and o of the same four (unit, row) pairs.
// L's bf16 chain reads a float xp (_lstm_fwdx_kernel adds x @ W + b to h @ U
// unrounded): its threads copy their pairs' float xp of the step to come
// into a shared-memory tile (rows, 4 Hc + kXsPad) with cp.async, as the
// float owners do, since 16 more floats a thread would spill the bf16
// chain's 128 registers; the tile takes the place of rows it would
// otherwise hold (fwd_plan counts it).
// The float build (lstm_fwd_chain_kernel) takes P as FFMA: h held
// feature-major (H, rows rounded to 8), a thread of split 0 owns one unit's
// four gates on 8 rows, and `splits` threads share each such tile's depth,
// their partials summed in split order through shared memory; the owner
// copies its xp of the step to come into shared memory (cp.async), which
// keeps its registers for the product; it holds one h tile and meets its
// peers at two barriers a step (reads of h_{t-1} done, h_t gathered). Its slice is
// resident at H = 256 (128 KiB, clusters of 8) and 384; at H = 512 it is 256
// KiB, so that build streams it from L2 at every step, in chunks of 64 depth
// rows through a cp.async ring that runs on across the step boundary (the
// STREAM instance).
//
// What bounds it: the chain, T steps of a rows x 4 Hc x H product per CTA
// and a cluster barrier; ops/_layout.py::fwd_plan picks C and the rows a
// cluster takes, ceil(B / the card's active clusters), so that 112-120 SMs
// work at B = 256. Every kernel launches on the caller's stream and
// allocates nothing.
#pragma once

#include "lstm_cluster.cuh"

namespace mvt {

// bf16: at most three m-tiles of 16 rows a cluster
constexpr int kFwdMaxRowsMma = 48;
// float: depth rows of a streamed chunk of the slice, and the most threads
// that share a tile's depth (a power of two dividing it)
constexpr int kFwdChunk = 64;
constexpr int kMaxSplits = 16;

// XT: xp's type (TV, or float for L's bf16 chain)
template <typename TV, typename XT = TV>
struct FwdArgs {
  const XT* xp;  // (T, B, 4H), x @ W + b
  const TV* h0;  // (B, H)
  const TV* c0;  // (B, H)
  const TV* u;   // (H, 4H)
  TV* hseq;      // (T, B, H) or null
  TV* cseq;      // (T, B, H) or null
  TV* hlast;     // (B, H) or null
  int T, B, H;
  int rows;    // batch rows per cluster
  int splits;  // float: depth splits of the product
  int stages;  // float: chunks in the streamed ring, 0 where the slice is resident
};

// Shared memory of a forward chain CTA, in bytes: the slice (or the
// `stages` chunks of its ring), the h tiles (two in bf16, one in float) and,
// in float, the partials of splits 1 and up and the xp of the step to come (each
// kTileStride floats a tile of 8 rows); in bf16 with a float xp (xs), its
// tile. ops/_layout.py's fwd_chain_smem computes the same.
__host__ __device__ constexpr size_t fwd_chain_smem(int H, int C, int rows, int splits,
                                                    int stages, bool mma, bool xs = false) {
  return mma ? (size_t)4 * (H / C) * H * 2 + (size_t)2 * round16(rows) * (H + kHPad) * 2 +
                   (xs ? (size_t)rows * (4 * (H / C) + kXsPad) * 4 : 0)
             : (stages ? (size_t)stages * kFwdChunk * 4 * (H / C) * 4
                       : (size_t)4 * (H / C) * H * 4) +
                   (size_t)round8(rows) * H * 4 +
                   (size_t)splits * kTileStride * (H / C) * (round8(rows) / 8) * 4;
}

// c' and h' of one (unit, row) pair from its four gate sums; c (the carried
// state) becomes c' rounded as a TV holds it, h' comes from the unrounded c'
template <int ACT, typename TV>
__device__ __forceinline__ float lstm_pair(float gi, float gf, float gg, float go, float& c) {
  const float cn = activate<kSigmoid>(gf) * c + activate<kSigmoid>(gi) * activate<ACT>(gg);
  c = round_as<TV>(cn);
  return activate<kSigmoid>(go) * activate<ACT>(cn);
}

// ---------------------------------------------------------------------------
// The bf16 build: P on the tensor cores
// ---------------------------------------------------------------------------

// Grid: clusters * C CTAs of kChainThreads, cluster dims (C, 1, 1).
template <int ACT, typename XT>
__global__ void __launch_bounds__(kChainThreads, 1) lstm_fwd_chain_mma_kernel(
    const FwdArgs<bf16, XT> a) {
  constexpr bool kXs = std::is_same_v<XT, float>;
  extern __shared__ __align__(16) unsigned char fwd_smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const int H = a.H, B = a.B, T = a.T, rows = a.rows;
  const int Hc = H / C, G4 = 4 * Hc, HP = H + kHPad, mts = (rows + 15) / 16, ugs = Hc / 8;
  const int items = mts * ugs;
  const int row0 = (blockIdx.x / C) * rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gid = lane >> 2,
            tig = lane & 3;
  // shared memory: the slice (H, 4 Hc), swizzled | two h tiles (16 mts, HP)
  // | with a float xp, its tile (rows, XS)
  bf16* slice = reinterpret_cast<bf16*>(fwd_smem_raw);
  bf16* hbuf = slice + (size_t)G4 * H;
  const size_t hsize = (size_t)16 * mts * HP;
  float* xs = reinterpret_cast<float*>(hbuf + 2 * hsize);
  const int XS = G4 + kXsPad;

  copy_slice_u(a.u, slice, H, Hc, c);
  cp_async_commit();
  for (size_t i = tid; i < 2 * hsize / 8; i += blockDim.x) {
    reinterpret_cast<int4*>(hbuf)[i] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();
  for (int i = tid; i < rows * H; i += blockDim.x) {
    const int r = i / H, k = i % H;
    if (row0 + r < B) hbuf[(size_t)r * HP + k] = a.h0[(size_t)(row0 + r) * H + k];
  }
  // the thread's pairs: item it = warp + i kChainWarps is (m-tile it / ugs,
  // units 8 (it % ugs) ..); pair (i, half, e) is row 16 mt + gid + 8 half,
  // local unit 8 ug + 2 tig + e. Their c, and xp of the step to come as
  // bf16 pairs of units (gate q, half); a float xp goes to xs instead
  float cst[kFwdMaxItems][4];
  unsigned xq[kFwdMaxItems][4][kXs ? 1 : 2];
  auto pair_row = [&](int i, int half) {
    return 16 * ((warp + i * kChainWarps) / ugs) + gid + 8 * half;
  };
  auto pair_unit = [&](int i) { return c * Hc + 8 * ((warp + i * kChainWarps) % ugs) + 2 * tig; };
  auto live = [&](int i, int half) {
    const int rl = pair_row(i, half);
    return warp + i * kChainWarps < items && rl < rows && row0 + rl < B;
  };
  auto load_xp = [&](int t) {
#pragma unroll
    for (int i = 0; i < kFwdMaxItems; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const bool ok = live(i, half);
        const XT* x = a.xp + ((size_t)t * B + row0 + pair_row(i, half)) * 4 * H + pair_unit(i);
        if constexpr (kXs) {
          // the pair's 2 units of each gate, 8 bytes a copy, into its own
          // slots: only this thread reads them, after its own wait
          const int rl = pair_row(i, half);
          if (warp + i * kChainWarps >= items || rl >= rows) continue;
          float* dst = xs + (size_t)rl * XS + pair_unit(i) - c * Hc;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (ok) {
              cp_async8(dst + q * Hc, x + q * H);
            } else {
              dst[q * Hc] = dst[q * Hc + 1] = 0.0f;
            }
          }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) xq[i][q][half] = ok ? ld_b32(x + q * H) : 0u;
        }
      }
    }
    if constexpr (kXs) cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kFwdMaxItems; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const bool ok = live(i, half);
      const size_t o = (size_t)(row0 + pair_row(i, half)) * H + pair_unit(i);
      cst[i][2 * half] = ok ? to_f32(a.c0[o]) : 0.0f;
      cst[i][2 * half + 1] = ok ? to_f32(a.c0[o + 1]) : 0.0f;
    }
  }
  // the pairs' h_t (as the thread wrote them into the h tile hn) and c_t
  // to their sequences
  auto store_out = [&](int t, const bf16* hn) {
#pragma unroll
    for (int i = 0; i < kFwdMaxItems; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (!live(i, half)) continue;
        const int unit = pair_unit(i);
        const unsigned h2 = ld_b32(hn + (size_t)pair_row(i, half) * HP + unit);
        const size_t o = (size_t)(row0 + pair_row(i, half)) * H + unit;
        if (a.hseq != nullptr) *reinterpret_cast<unsigned*>(a.hseq + (size_t)t * B * H + o) = h2;
        if (a.cseq != nullptr) {
          *reinterpret_cast<__nv_bfloat162*>(a.cseq + (size_t)t * B * H + o) =
              __floats2bfloat162_rn(cst[i][2 * half], cst[i][2 * half + 1]);
        }
        if (a.hlast != nullptr && t == T - 1) *reinterpret_cast<unsigned*>(a.hlast + o) = h2;
      }
    }
  };
  load_xp(0);
  cp_async_wait(0);
  // every CTA's tiles are set before a peer writes into them
  cluster_arrive();
  cluster_wait();

  // ldmatrix rows: A (h) row 16 mt + (lane & 7) + 8 ((lane >> 3) & 1), depth
  // + 8 (lane >> 4); B (the slice) depth (lane & 7) + 8 ((lane >> 3) & 1),
  // gate (lane >> 4) (+ 2 for the second load)
  const int a_r = (lane & 7) + 8 * ((lane >> 3) & 1), a_k = 8 * (lane >> 4);
  const int b_k = (lane & 7) + 8 * ((lane >> 3) & 1), b_q = lane >> 4;
  for (int t = 0; t < T; ++t) {
    const bf16* hc = hbuf + (size_t)(t & 1) * hsize;
    bf16* hn = hbuf + (size_t)((t & 1) ^ 1) * hsize;
    // a float xp of step t (copied during step t - 1's barrier) has landed
    if constexpr (kXs) cp_async_wait(0);
#pragma unroll
    for (int i = 0; i < kFwdMaxItems; ++i) {
      const int it = warp + i * kChainWarps;
      if (it >= items) continue;
      const int mt = it / ugs, ug = it % ugs;
      float acc[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
      }
      const bf16* a_row = hc + (size_t)(16 * mt + a_r) * HP + a_k;
      const int j01 = b_q * (Hc / 8) + ug, j23 = (b_q + 2) * (Hc / 8) + ug;
#pragma unroll 4
      for (int k0 = 0; k0 < H; k0 += 16) {
        unsigned a0, a1, a2, a3, b[4][2];
        ldmatrix_x4(a_row + k0, a0, a1, a2, a3);
        const int k = k0 + b_k;
        const bf16* b_row = slice + (size_t)k * G4;
        ldmatrix_x4_trans(b_row + ((j01 ^ (k & 7)) << 3), b[0][0], b[0][1], b[1][0], b[1][1]);
        ldmatrix_x4_trans(b_row + ((j23 ^ (k & 7)) << 3), b[2][0], b[2][1], b[3][0], b[3][1]);
#pragma unroll
        for (int q = 0; q < 4; ++q) mma_bf16(acc[q], a0, a1, a2, a3, b[q][0], b[q][1]);
      }
      // E: acc[q][2 half + e] is gate q of row 16 mt + gid + 8 half, unit
      // 8 ug + 2 tig + e
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = pair_row(i, half);
        if (rl >= rows) continue;
        float hv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float g[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if constexpr (kXs) {
              g[q] = acc[q][2 * half + e] + xs[(size_t)rl * XS + q * Hc + pair_unit(i) - c * Hc + e];
            } else {
              // unit 2 tig + e's bf16 is the pair's low (e = 0) or high half
              const unsigned x = xq[i][q][half];
              g[q] = acc[q][2 * half + e] + __uint_as_float(e ? x & 0xffff0000u : x << 16);
            }
          }
          hv[e] = lstm_pair<ACT, bf16>(g[0], g[1], g[2], g[3], cst[i][2 * half + e]);
        }
        *reinterpret_cast<__nv_bfloat162*>(hn + (size_t)rl * HP + pair_unit(i)) =
            __floats2bfloat162_rn(hv[0], hv[1]);
      }
    }
    if (t + 1 == T) {
      store_out(t, hn);
      break;
    }
    __syncthreads();  // the CTA's columns of h_t are in hn
    // X: rows x Hc / 8 chunks of 16 bytes. The arrive's release waits for
    // the thread's earlier memory operations, so the step's device-memory
    // traffic (xp of the next step, the outputs) is issued after it, to
    // complete while the barrier does
    const int per_row = Hc / 8;
    push_columns(cluster, reinterpret_cast<char*>(hn), rows * per_row,
                 [&](int j) {
                   return ((size_t)(j / per_row) * HP + c * Hc + 8 * (j % per_row)) * 2;
                 },
                 C, c);
    cluster_arrive();
    load_xp(t + 1);
    store_out(t, hn);
    cluster_wait();
  }
}

// ---------------------------------------------------------------------------
// The float build: P as FFMA
// ---------------------------------------------------------------------------

// Depth rows [k0, k0 + n) of the CTA's float slice (local gate column
// gl = q Hc + u is U column q H + c Hc + u) into dst (n, 4 Hc), 16 bytes a
// copy.
__device__ __forceinline__ void copy_rows(const float* __restrict__ u, float* dst, int k0, int n,
                                          int H, int Hc, int c) {
  for (int i = threadIdx.x; i < n * Hc; i += blockDim.x) {
    const int k = i / Hc, p = i % Hc, q = 4 * p / Hc, u0 = 4 * p % Hc;
    cp_async16(dst + (size_t)k * 4 * Hc + 4 * p,
               u + (size_t)(k0 + k) * 4 * H + q * H + c * Hc + u0);
  }
}

// P of the float build: acc (gate q, row r) += h rows [k_lo, k_hi) of rows
// 8 ro + r . the slice's column q Hc + ul (src holds depth k_base on)
__device__ __forceinline__ void fwd_product(const float* hc, int R8, int ro, const float* src,
                                            int Hc, int ul, int k_lo, int k_hi, int k_base,
                                            float (&acc)[4][8]) {
#pragma unroll 1
  for (int k = k_lo; k < k_hi; ++k) {
    const float4 h0v = *reinterpret_cast<const float4*>(hc + (size_t)k * R8 + 8 * ro);
    const float4 h1v = *reinterpret_cast<const float4*>(hc + (size_t)k * R8 + 8 * ro + 4);
    const float hv[8] = {h0v.x, h0v.y, h0v.z, h0v.w, h1v.x, h1v.y, h1v.z, h1v.w};
    const float* ur = src + (size_t)(k - k_base) * 4 * Hc + ul;
    const float uq[4] = {ur[0], ur[Hc], ur[2 * Hc], ur[3 * Hc]};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[q][r] = fmaf(hv[r], uq[q], acc[q][r]);
    }
  }
}

// Grid: clusters * C CTAs of kChainThreads, cluster dims (C, 1, 1).
template <int ACT, bool STREAM>
__global__ void __launch_bounds__(kChainThreads, 1) lstm_fwd_chain_kernel(
    const FwdArgs<float> a) {
  extern __shared__ __align__(16) unsigned char fwd_smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const int H = a.H, B = a.B, T = a.T, rows = a.rows, S = a.splits;
  const int Hc = H / C, G4 = 4 * Hc, R8 = round8(rows), ntiles = Hc * (R8 / 8);
  const int row0 = (blockIdx.x / C) * rows;
  const int tid = threadIdx.x;
  // thread tid works on tile tid % ntiles (unit ul, rows 8 ro ..) in split
  // tid / ntiles; split 0 owns the tile's pairs
  const int tile = tid % ntiles, split = tid / ntiles;
  const int ul = tile % Hc, ro = tile / Hc, unit = c * Hc + ul;
  const bool owner = split == 0;
  // shared memory: the slice (H, 4 Hc) or the ring of chunks (kFwdChunk, 4 Hc) |
  // one h tile (H, R8) | the partials (S - 1, ntiles, kTileStride) | the
  // owners' xp of the step to come (ntiles, kTileStride)
  float* slice = reinterpret_cast<float*>(fwd_smem_raw);
  float* hbuf = slice + (STREAM ? (size_t)a.stages * kFwdChunk * G4 : (size_t)H * G4);
  const size_t hsize = (size_t)H * R8;
  float* part = hbuf + hsize;
  float* xs = part + (size_t)(S - 1) * ntiles * kTileStride + (size_t)tile * kTileStride;

  const int n_chunks = STREAM ? H / kFwdChunk : 1;
  const int total_chunks = T * n_chunks;
  // the streamed build's 16-byte pieces of a chunk (kFwdChunk x Hc of them:
  // thread tid copies pieces tid, tid + kChainThreads, ..., each
  // kChainThreads / Hc depth rows below the last); the offsets of its
  // first in U from the chunk's first depth row and in the ring slot,
  // worked out once
  const int piece_k = tid / Hc, piece_p = tid % Hc, piece_rows = kChainThreads / Hc;
  const int piece_src = piece_k * 4 * H + (4 * piece_p / Hc) * H + c * Hc + 4 * piece_p % Hc;
  const int piece_dst = piece_k * G4 + 4 * piece_p;
  auto copy_chunk = [&](int j) {  // chunk j of the sequence into its ring slot
    const float* src = a.u + (size_t)(j % n_chunks) * kFwdChunk * 4 * H + piece_src;
    float* dst = slice + (size_t)(j % a.stages) * kFwdChunk * G4 + piece_dst;
    for (int k = piece_k; k < kFwdChunk; k += piece_rows) {
      cp_async16(dst, src);
      src += (size_t)piece_rows * 4 * H;
      dst += piece_rows * G4;
    }
  };
  if constexpr (STREAM) {
    for (int j = 0; j < a.stages - 1; ++j) {
      if (j < total_chunks) copy_chunk(j);
      cp_async_commit();
    }
  } else {
    copy_rows(a.u, slice, 0, H, H, Hc, c);
    cp_async_commit();
  }
  for (size_t i = tid; i < hsize; i += blockDim.x) hbuf[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < rows * H; i += blockDim.x) {
    const int r = i / H, k = i % H;
    if (row0 + r < B) hbuf[(size_t)k * R8 + r] = a.h0[(size_t)(row0 + r) * H + k];
  }
  // the owner's pairs (unit, rows 8 ro + r): c in registers; xp of the step
  // to come copied by the owner itself into its own slots of xs (one copy
  // group, so its own wait suffices: no barrier)
  float cst[8];
  auto live = [&](int r) { return owner && 8 * ro + r < rows && row0 + 8 * ro + r < B; };
  // (xs points at the thread's tile: value (q, r) at 8 q + r)
  auto load_xp = [&](int t) {
    const float* x = a.xp + ((size_t)t * B + row0 + 8 * ro) * 4 * H + unit;
#pragma unroll 1
    for (int r = 0; r < 8; ++r, x += 4 * H) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (live(r)) {
          cp_async4(xs + 8 * q + r, x + q * H);
        } else {
          xs[8 * q + r] = 0.0f;
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    cst[r] = live(r) ? a.c0[(size_t)(row0 + 8 * ro + r) * H + unit] : 0.0f;
  }
  // the owner's h_t and c_t to their sequences
  auto store_out = [&](int t, const float (&hv)[8]) {
    size_t o = (size_t)(row0 + 8 * ro) * H + unit;  // row, unit
#pragma unroll
    for (int r = 0; r < 8; ++r, o += H) {
      if (!live(r)) continue;
      if (a.hseq != nullptr) a.hseq[(size_t)t * B * H + o] = hv[r];
      if (a.cseq != nullptr) a.cseq[(size_t)t * B * H + o] = cst[r];
      if (a.hlast != nullptr && t == T - 1) a.hlast[o] = hv[r];
    }
  };
  if (owner) load_xp(0);
  if constexpr (!STREAM) cp_async_wait(0);
  cluster_arrive();
  cluster_wait();

  int chunk_seq = 0;  // streamed chunks consumed so far (over all steps)
  for (int t = 0; t < T; ++t) {
    const float* hc = hbuf;
    float acc[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[q][r] = 0.0f;
    }
    if constexpr (STREAM) {
      const int per = kFwdChunk / S;
      for (int ch = 0; ch < n_chunks; ++ch) {
        // chunk chunk_seq has landed in every thread's copies, and every
        // thread is done with the ring slot the next copy refills
        cp_async_wait(a.stages - 2);
        __syncthreads();
        const int next = chunk_seq + a.stages - 1;
        if (next < total_chunks) copy_chunk(next);
        cp_async_commit();
        if (split < S) {
          const int k0 = ch * kFwdChunk + split * per;
          fwd_product(hc, R8, ro, slice + (size_t)(chunk_seq % a.stages) * kFwdChunk * G4, Hc,
                      ul, k0, k0 + per, ch * kFwdChunk, acc);
        }
        ++chunk_seq;
      }
    } else if (split < S) {
      fwd_product(hc, R8, ro, slice, Hc, ul, split * (H / S), (split + 1) * (H / S), 0, acc);
    }
    // the splits' partials summed into split 0's, in split order
    if (S > 1) {
      if (!owner && split < S) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            part[((size_t)(split - 1) * ntiles + tile) * kTileStride + 8 * q + r] = acc[q][r];
          }
        }
      }
      __syncthreads();
      if (owner) {
        for (int s = 1; s < S; ++s) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              acc[q][r] += part[((size_t)(s - 1) * ntiles + tile) * kTileStride + 8 * q + r];
            }
          }
        }
      }
    }
    // the first barrier: every CTA's reads of h_{t-1} are done when it
    // completes; E runs while it does
    const bool more = t + 1 < T;
    if (more) cluster_arrive();
    // E. The owner's xp copies have landed: the resident build's only
    // pending group is theirs; in the streamed one, the chunk loop's waits
    // have since left at most stages - 2 newer groups pending
    float hv[8] = {};
    if (owner) {
      if constexpr (!STREAM) cp_async_wait(0);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        hv[r] = lstm_pair<ACT, float>(acc[0][r] + xs[r], acc[1][r] + xs[8 + r],
                                      acc[2][r] + xs[16 + r], acc[3][r] + xs[24 + r], cst[r]);
        if (8 * ro + r >= rows) hv[r] = 0.0f;
      }
    }
    if (!more) {
      store_out(t, hv);
      break;
    }
    cluster_wait();
    if (owner) {
      float* hr = hbuf + (size_t)unit * R8 + 8 * ro;
      *reinterpret_cast<float4*>(hr) = make_float4(hv[0], hv[1], hv[2], hv[3]);
      *reinterpret_cast<float4*>(hr + 4) = make_float4(hv[4], hv[5], hv[6], hv[7]);
    }
    __syncthreads();  // the CTA's columns of h_t are in the tile
    // X: its units' rows are one run of Hc R8 floats; the second barrier;
    // the step's outputs go to device memory while it completes
    const size_t base = (size_t)c * Hc * R8 * 4;
    push_columns(cluster, reinterpret_cast<char*>(hbuf), Hc * R8 / 4,
                 [&](int j) { return base + (size_t)16 * j; }, C, c);
    cluster_arrive();
    if (owner) load_xp(t + 1);
    store_out(t, hv);
    cluster_wait();
  }
}

// ---------------------------------------------------------------------------
// Host launchers (each returns a cudaError_t code)
// ---------------------------------------------------------------------------

template <typename Kernel, typename TV, typename XT>
int launch_fwd_instance(Kernel kernel, const FwdArgs<TV, XT>& a, int cluster, size_t smem,
                        void* stream) {
  cudaError_t err = cluster_config(kernel, cluster, smem);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch l((a.B + a.rows - 1) / a.rows * cluster, cluster, smem, stream);
  err = cudaLaunchKernelEx(&l.cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

__host__ inline bool misaligned(const void* p, size_t bytes) {
  return (reinterpret_cast<size_t>(p) & (bytes - 1)) != 0;
}

// The chain of one layer at the plan of ops/_layout.py::fwd_plan (cluster
// size, rows a cluster, splits, streamed ring); cudaErrorInvalidValue for a
// plan the build does not run.
template <typename TV, int ACT, typename XT = TV>
int launch_fwd_chain(const FwdArgs<TV, XT>& a, int cluster, void* stream) {
  constexpr bool kMma = std::is_same_v<TV, bf16>;
  constexpr bool kXs = kMma && std::is_same_v<XT, float>;
  static_assert(kMma || std::is_same_v<XT, float>, "the float chain reads a float xp");
  const int H = a.H;
  if (a.T < 1 || a.B < 1 || cluster < 1 || cluster > kMaxCluster || H % cluster != 0 ||
      a.rows < 1 || a.splits < 1 || misaligned(a.u, 16) || misaligned(a.xp, kXs ? 8 : 4) ||
      (a.hseq == nullptr && a.hlast == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int Hc = H / cluster;
  if constexpr (kMma) {
    if (H % 128 != 0 || Hc % 16 != 0 || a.rows > kFwdMaxRowsMma || a.splits != 1 ||
        a.stages != 0 || (a.rows + 15) / 16 * (Hc / 8) > kFwdMaxItems * kChainWarps ||
        misaligned(a.hseq, 4) || misaligned(a.cseq, 4) || misaligned(a.hlast, 4)) {
      return (int)cudaErrorInvalidValue;
    }
  } else {
    const int S = a.splits, tiles = Hc * (round8(a.rows) / 8);
    if (H % 64 != 0 || Hc % 4 != 0 || (S & (S - 1)) != 0 || S > kMaxSplits ||
        tiles * S > kChainThreads ||
        (a.stages != 0 && (a.stages < 2 || a.stages > 8 || kChainThreads % Hc != 0))) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const size_t smem = fwd_chain_smem(H, cluster, a.rows, a.splits, a.stages, kMma, kXs);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if constexpr (kMma) {
    return launch_fwd_instance(lstm_fwd_chain_mma_kernel<ACT, XT>, a, cluster, smem, stream);
  } else {
    if (a.stages != 0) {
      return launch_fwd_instance(lstm_fwd_chain_kernel<ACT, true>, a, cluster, smem, stream);
    }
    return launch_fwd_instance(lstm_fwd_chain_kernel<ACT, false>, a, cluster, smem, stream);
  }
}

// cudaOccupancyMaxActiveClusters of the chain's build (the resident or the
// streamed slice) at `cluster` CTAs a cluster (one CTA an SM)
template <typename TV, int ACT, typename XT = TV>
int fwd_max_clusters(int cluster, int stream_slice, int* out) {
  if constexpr (std::is_same_v<TV, bf16>) {
    if (stream_slice) return (int)cudaErrorInvalidValue;
    return max_active_clusters(lstm_fwd_chain_mma_kernel<ACT, XT>, cluster, out);
  } else {
    if (stream_slice) return max_active_clusters(lstm_fwd_chain_kernel<ACT, true>, cluster, out);
    return max_active_clusters(lstm_fwd_chain_kernel<ACT, false>, cluster, out);
  }
}

}  // namespace mvt
