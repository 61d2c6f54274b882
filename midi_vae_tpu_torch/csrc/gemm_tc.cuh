// Shared device code of the port's matrix products on the tensor cores at
// float32 accuracy: kernel W's weight-gradient reduction (grad_reduce.cu,
// C = A^T B over N rows), the x-projection pre-pass of kernels L and A
// (xproj.cuh, xp = x @ W + b) and kernel S's step (lstm_step.cu, [x | h] .
// [W ; U] with the LSTM cell in the epilogue).
//
// Arithmetic. mma.sync m16n8k8 takes TF32 operands (10 mantissa bits) and
// sums in float. A float32 operand is split into a TF32 high part
// (cvt.rna.tf32.f32) and the remainder x - hi (exact in float; the tensor
// cores read its top 10 mantissa bits), and a product is summed as
// a_lo b_hi + a_hi b_lo + a_hi b_hi (kThree): the dropped a_lo b_lo term and
// the remainders' own truncation are about 2^-21 of the product, so the
// result lands near float32's rounding of a float32 FMA sum (2e-7 relative
// L2 at W's shapes; one TF32 rounding of each operand, kOne on float data,
// lands near 3e-4). A bf16 value is exact in TF32, so
// a bf16 A needs no split (kTwo: a b_lo + a b_hi; kTwoA, its mirror, splits
// a float A beside an exact B: a_lo b + a_hi b) and a product of two bf16
// operands is one exact TF32 product summed in float (kOne), the function of
// jnp.dot(..., preferred_element_type=float32) on bf16 operands.
// The tensor cores add a product into their accumulators with truncation,
// not rounding to nearest, so over a long depth the sums drift toward zero:
// a build whose mma added into the running sums read, in chip_smoke.py's W
// checks on the H100, 3.6e-6 relative after chunks of 500 rows and 2.3e-5
// after 3,300 (W_REL_L2 is 1e-5). Each stage's products (16 rows) therefore
// go into zeroed accumulators and are added into the running sums by one
// rounded float add: the truncation then touches only 16 rows' products.
//
// Mainloop. A block of 2 kBNt threads (warps: 2 along M x kBNt / 32 along
// N; W and the pre-pass: kBNt = kBN = 128, kThreads = 256; S: 64 or 32)
// computes one kBM x kBNt tile of the product (kBM 128, or 64 or 32 where
// the product has few rows) over a range of the depth, or over two
// segments of it one after the other (S: x against W, then h against U;
// run2), in stages of kBK = 16 depth rows held in a ring of kStages = 4
// slots of shared memory; a stage never holds depth of both segments. B's
// tile columns may be gathered (kGather: S's four gate blocks of its units,
// interleaved 8 units at a time, gather_unit and gather_gate). Float
// operands are copied by cp.async, 16 bytes a copy where the row stride,
// the width and the base are multiples of 4 floats, else 4 bytes (x has
// D = 61 columns: its rows are not 16-byte aligned); bf16 operands are
// loaded into registers one stage ahead and stored widened to float after
// the stage's products, so every tile in shared memory is float and every
// fragment is read the same way. Elements outside the operand (the ragged
// edges of M, N and the depth) are zero-filled.
//
// Layouts. A enters as A(m, k) = a[k * lda + m] (kAT: W's A^T, a tile of
// kBK rows of kBM values) or a[m * lda + k] (the pre-pass's x, a tile of kBM
// rows of kBK values); B(k, n) = b[k * ldb + n] (a tile of kBK rows of kBN
// values). There is no ldmatrix for 32-bit transposed fragments, so the
// fragments are 32-bit shared-memory loads; the tiles' rows are padded so
// that the loads of a warp hit 32 banks: a row of M or N values holds
// kBM + 8 (kBN + 8) floats, the fragment's four k rows then 8 banks apart;
// a row of depth values holds kBK + 4, its eight m rows 4 banks apart.
//
// What bounds it: at W's shapes (N = 1,024 to 32,768 rows into a few
// hundred thousand outputs) the three TF32 products and the operand traffic
// of shared memory; the caller splits the depth over blocks to fill the 132
// SMs. Every kernel launches on the caller's stream and allocates nothing.
#pragma once

#include "gru_common.cuh"

namespace mvt {
namespace tc {

constexpr int kThreads = 256;
constexpr int kBN = 128;
constexpr int kBK = 16;
constexpr int kStages = 4;
constexpr int kPadMN = 8;
constexpr int kPadK = 4;

// the TF32 products a fragment pair takes (kTwoA: A split, B exact)
enum Products : int { kOne = 1, kTwo = 2, kThree = 3, kTwoA = 4 };

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// cp.async of 16 (4) bytes, zero-filling the destination where !valid
__device__ __forceinline__ void copy16(float* s, const void* g, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(s)), "l"(g),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void copy4(float* s, const void* g, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(s)), "l"(g),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a . b: a 16 x 8 TF32 A fragment, an 8 x 8 TF32 B fragment, float
// sums (not volatile: the compiler may interleave independent products)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x as a TF32 high part and, where the operand is split, its remainder
template <bool kSplit>
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  if constexpr (kSplit) {
    hi = to_tf32(x);
    lo = __float_as_uint(x - __uint_as_float(hi));  // the tensor cores read its TF32 bits
  } else {
    hi = to_tf32(x);  // exact values: the identity
    lo = 0u;
  }
}

// The tile column cl of an operand whose columns are gathered (kGather):
// the four gate blocks of kernel S's units, interleaved 8 units at a time
// (tile columns 32 j + 8 q + i are gate q of unit 8 j + i), so that a
// warp's four n-tiles of 8 columns are one unit group's four gates. cl's
// unit (from the tile's first) and gate.
__device__ __forceinline__ int gather_unit(int cl) { return (cl >> 5) * 8 + (cl & 7); }
__device__ __forceinline__ int gather_gate(int cl) { return (cl >> 3) & 3; }

// One operand's stage: R rows x CC values of a row-major matrix g (row
// stride ld) from (r0, c0), rows < r1 and columns < c1 valid, into a float
// tile of row stride ss, by kThr threads. Float: cp.async (16-byte copies
// when vec); bf16: loaded into registers by fetch(), stored widened by
// put(). kGather: tile column cl is matrix column c0 + gather_unit(cl) +
// gather_gate(cl) * gstride, valid where c0 + gather_unit(cl) < c1 (four
// neighbouring tile columns stay neighbours in g).
template <typename T, int R, int CC, int kThr = kThreads, bool kGather = false>
struct Stage {
  static constexpr bool kStaged = std::is_same_v<T, bf16>;
  static constexpr int kElems = R * CC / kThr;
  static constexpr int kVecs = kElems / 4;
  static_assert(R * CC % (4 * kThr) == 0, "a tile is whole 16-byte copies of every thread");
  unsigned short held[kStaged ? kElems : 1];

  // matrix column (cc, what c1 bounds) and its offset in a row of g
  __device__ __forceinline__ static int col(int c0, int cl) {
    return c0 + (kGather ? gather_unit(cl) : cl);
  }
  __device__ __forceinline__ static int off(int cc, int cl, int gstride) {
    return kGather ? cc + gather_gate(cl) * gstride : cc;
  }

  __device__ __forceinline__ void fetch(const T* g, int ld, int r0, int r1, int c0, int c1,
                                        float* s, int ss, bool vec, int gstride = 0) {
    const int tid = threadIdx.x;
    if constexpr (kStaged) {
      const unsigned short* gu = reinterpret_cast<const unsigned short*>(g);
#pragma unroll
      for (int i = 0; i < kElems; ++i) {
        const int e = tid + i * kThr, r = r0 + e / CC, cl = e % CC, cc = col(c0, cl);
        held[i] = (r < r1 && cc < c1) ? __ldg(gu + (size_t)r * ld + off(cc, cl, gstride))
                                      : (unsigned short)0;
      }
    } else if (vec) {
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        const int e = tid + i * kThr, rr = e / (CC / 4), cl = 4 * (e % (CC / 4));
        const int r = r0 + rr, cc = col(c0, cl);
        const bool ok = r < r1 && cc < c1;
        copy16(s + rr * ss + cl, ok ? g + (size_t)r * ld + off(cc, cl, gstride) : g, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kElems; ++i) {
        const int e = tid + i * kThr, rr = e / CC, cl = e % CC;
        const int r = r0 + rr, cc = col(c0, cl);
        const bool ok = r < r1 && cc < c1;
        copy4(s + rr * ss + cl, ok ? g + (size_t)r * ld + off(cc, cl, gstride) : g, ok);
      }
    }
  }

  __device__ __forceinline__ void put(float* s, int ss) const {
    if constexpr (kStaged) {
#pragma unroll
      for (int i = 0; i < kElems; ++i) {
        const int e = threadIdx.x + i * kThr;
        s[(e / CC) * ss + e % CC] = __uint_as_float((unsigned)held[i] << 16);
      }
    }
  }
};

// One segment of a product's depth: A (a, lda) and B (b, ldb) over depth
// rows [k0, k1) of each; a_vec, b_vec: their float tiles take 16-byte
// copies. A product may run over two segments one after the other (kernel
// S: x then h against W then U); an empty segment has k1 == k0.
template <typename TA, typename TB>
struct Seg {
  const TA* a;
  int lda;
  const TB* b;
  int ldb;
  int k0, k1;
  bool a_vec, b_vec;
};

// The product of one kBM x kBNt tile over depth [k0, k1) (or over two
// segments of depth, run2): acc (the warp's kMT x 4 fragments of 16 x 8) +=
// A(m0.., k) B(k, n0..), rows m < M and columns n < Nn valid, by kThr =
// 2 kBNt threads (warps: 2 along M x kBNt / 32 along N). kProducts: kThree
// (float A and B), kTwo (A exact in TF32), kTwoA (B exact in TF32), kOne
// (both exact, or the one-product build). kGather: B's columns gathered (Stage, gstride).
template <bool kAT, typename TA, typename TB, int kBM, int kProducts, int kBNt = kBN,
          bool kGather = false>
struct Gemm {
  static constexpr int kThr = 2 * kBNt;
  static constexpr int kWarpsN = kBNt / 32;
  static constexpr int kWM = kBM / 2;  // warp tile rows; 32 columns
  static constexpr int kMT = kWM / 16;
  static constexpr int kNT = 4;
  static constexpr int kAS = kAT ? kBM + kPadMN : kBK + kPadK;
  static constexpr int kASize = kAT ? kBK * kAS : kBM * kAS;
  static constexpr int kBS = kBNt + kPadMN;
  static constexpr int kBSize = kBK * kBS;
  static constexpr size_t kSmem = (size_t)kStages * (kASize + kBSize) * sizeof(float);
  using Acc = float[kMT][kNT][4];
  using Segment = Seg<TA, TB>;

  // bsum: where given, the thread adds column tid % kBNt of B's rows
  // 8 (tid / kBNt) .. + 8 of every stage (plain float sums, in order)
  __device__ static void run(const TA* __restrict__ a, int lda, const TB* __restrict__ b,
                             int ldb, int m0, int M, int n0, int Nn, int k0, int k1, bool a_vec,
                             bool b_vec, float* smem, Acc& acc, float* bsum) {
    run2(Segment{a, lda, b, ldb, k0, k1, a_vec, b_vec}, Segment{a, lda, b, ldb, 0, 0, false, false},
         m0, M, n0, Nn, 0, smem, acc, bsum);
  }

  // the product over segment s1's depth, then s2's, in one ring of stages
  // (a stage never holds depth of both)
  __device__ static void run2(const Segment s1, const Segment s2, int m0, int M, int n0, int Nn,
                              int gstride, float* smem, Acc& acc, float* bsum) {
    float* As = smem;
    float* Bs = smem + kStages * kASize;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gid = lane >> 2,
              tig = lane & 3;
    const int wm = (warp / kWarpsN) * kWM, wn = (warp % kWarpsN) * 32;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

    Stage<TA, kAT ? kBK : kBM, kAT ? kBM : kBK, kThr> sa;
    Stage<TB, kBK, kBNt, kThr, kGather> sb;
    const int nk1 = (s1.k1 - s1.k0 + kBK - 1) / kBK;
    const int nk = nk1 + (s2.k1 - s2.k0 + kBK - 1) / kBK;
    auto fetch = [&](int kt) {
      const Segment& g = kt < nk1 ? s1 : s2;
      const int kb = g.k0 + (kt < nk1 ? kt : kt - nk1) * kBK, slot = kt % kStages;
      if constexpr (kAT) {
        sa.fetch(g.a, g.lda, kb, g.k1, m0, M, As + slot * kASize, kAS, g.a_vec);
      } else {
        sa.fetch(g.a, g.lda, m0, M, kb, g.k1, As + slot * kASize, kAS, g.a_vec);
      }
      sb.fetch(g.b, g.ldb, kb, g.k1, n0, Nn, Bs + slot * kBSize, kBS, g.b_vec, gstride);
    };
    auto put = [&](int kt) {
      const int slot = kt % kStages;
      sa.put(As + slot * kASize, kAS);
      sb.put(Bs + slot * kBSize, kBS);
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) {
        fetch(s);
        put(s);
      }
      commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      wait_pending<kStages - 2>();
      __syncthreads();  // stage kt is in; every thread is done with slot kt - 1
      const int next = kt + kStages - 1;
      if (next < nk) fetch(next);
      commit();
      const float* at = As + (kt % kStages) * kASize;
      const float* bt = Bs + (kt % kStages) * kBSize;
      // B's fragments of the stage's two k-steps, split once; then per
      // m-tile its A fragments, and the stage's products into fresh
      // accumulators (the four n-tiles' mma independent of each other),
      // added into the running sums by one rounded float add (see the note)
      unsigned bh[2][kNT][2], bl[2][kNT][2];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            split<kProducts == kThree || kProducts == kTwo>(
                bt[(8 * ks + tig + 4 * h) * kBS + wn + nt * 8 + gid], bh[ks][nt][h],
                bl[ks][nt][h]);
          }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int m = wm + mt * 16 + gid;
        unsigned ah[2][4], al[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const int k = 8 * ks + tig;
          float av[4];
          if constexpr (kAT) {
            av[0] = at[k * kAS + m];
            av[1] = at[k * kAS + m + 8];
            av[2] = at[(k + 4) * kAS + m];
            av[3] = at[(k + 4) * kAS + m + 8];
          } else {
            av[0] = at[m * kAS + k];
            av[1] = at[(m + 8) * kAS + k];
            av[2] = at[m * kAS + k + 4];
            av[3] = at[(m + 8) * kAS + k + 4];
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            split<kProducts == kThree || kProducts == kTwoA>(av[e], ah[ks][e], al[ks][e]);
          }
        }
        float t[kNT][4] = {};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          if constexpr (kProducts == kThree || kProducts == kTwoA) {
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) mma_tf32(t[nt], al[ks], bh[ks][nt][0], bh[ks][nt][1]);
          }
          if constexpr (kProducts == kThree || kProducts == kTwo) {
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) mma_tf32(t[nt], ah[ks], bl[ks][nt][0], bl[ks][nt][1]);
          }
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) mma_tf32(t[nt], ah[ks], bh[ks][nt][0], bh[ks][nt][1]);
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += t[nt][e];
      }
      if (bsum != nullptr) {
        const int col = tid % kBNt, r0 = 8 * (tid / kBNt);
#pragma unroll
        for (int r = 0; r < 8; ++r) *bsum += bt[(r0 + r) * kBS + col];
      }
      if (next < nk) put(next);
    }
    wait_pending<0>();
  }

  // (row, column) of accumulator element e of fragment (mt, nt), relative
  // to the tile's origin
  __device__ __forceinline__ static int row_of(int mt, int e) {
    const int warp = threadIdx.x >> 5, gid = (threadIdx.x & 31) >> 2;
    return (warp / kWarpsN) * kWM + mt * 16 + gid + (e >= 2 ? 8 : 0);
  }
  __device__ __forceinline__ static int col_of(int nt, int e) {
    const int warp = threadIdx.x >> 5, tig = threadIdx.x & 3;
    return (warp % kWarpsN) * 32 + nt * 8 + 2 * tig + (e & 1);
  }
};

}  // namespace tc
}  // namespace mvt
