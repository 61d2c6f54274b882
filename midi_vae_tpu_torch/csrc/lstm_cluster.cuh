// The pieces the serial chains on thread-block clusters share: the LSTM's
// backward (lstm_cell_bwd.cuh, kernels N and R) and forward
// (lstm_cell_fwd.cuh, kernels Q, Y and L's chain), and the GRU's forward
// (gru_cell_fwd.cuh, kernel A's chain). A chain runs 512-thread CTAs, one an
// SM, in clusters of up to 16 (a non-portable size above 8); each CTA keeps
// its slice of U in shared memory (copied with cp.async, or streamed through
// a cp.async ring where it does not fit) and the CTAs of a cluster meet at
// one cluster barrier a step. The bf16 builds take their products on the
// tensor cores with mma.sync m16n8k16 (float accumulators).
#pragma once

#include <cooperative_groups.h>

#include "lstm_common.cuh"

namespace mvt {

namespace cg = cooperative_groups;

constexpr int kChainThreads = 512;
constexpr int kChainWarps = kChainThreads / 32;
// the largest cluster (16: a non-portable size)
constexpr int kMaxCluster = 16;

__host__ __device__ constexpr int round8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n of the thread's committed copy groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ unsigned ld_b32(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// c += a . b on the tensor cores: a 16 x 16 bf16 A fragment, a 16 x 8 bf16 B
// fragment, float accumulators
__device__ __forceinline__ void mma_bf16(float c[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bf16 forward chains (h @ U on the tensor cores): (m-tile, unit group)
// items a warp owns at most
constexpr int kFwdMaxItems = 2;
// bf16 forward chains: the h tile's row stride is H + kHPad values, so that
// ldmatrix's 8 rows of 16 bytes hit 32 banks
constexpr int kHPad = 8;
// bf16 forward chains with a float xp: the xp tile's rows are (gates) Hc +
// kXsPad floats, so that a half-warp's 8-byte reads (8 rows of 4 unit
// pairs) hit 32 banks
constexpr int kXsPad = 8;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldmatrix_x4(const bf16* p, unsigned& r0, unsigned& r1,
                                            unsigned& r2, unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(const bf16* p, unsigned& r0, unsigned& r1,
                                                  unsigned& r2, unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

// The bf16 builds' slice: U restricted to the CTA's gate columns, (H, G Hc)
// with unit n's row n holding its G Hc gate columns of the first G gates
// (local gl = q Hc + u is U column q H + c Hc + u; U has `u_gates` gate
// blocks a row: 4 for the LSTM, 3 for the GRU, whose chain takes z and r,
// G = 2, this way), each 16-byte chunk j of a row stored at chunk j ^ (n % 8)
// (G Hc / 8 a multiple of 8): the fragment loads of 8 neighbouring rows (the
// backward's mma B fragments of 8 units, the forward's ldmatrix of 8
// depths) then read 8 different chunks, so 32 banks.
__device__ __forceinline__ void copy_slice_u(const bf16* __restrict__ u, bf16* dst, int H,
                                             int Hc, int c, int G = 4, int u_gates = 4) {
  const int GH = G * Hc, chunks = GH / 8;
  for (int i = threadIdx.x; i < H * chunks; i += blockDim.x) {
    const int n = i / chunks, j = i % chunks;
    const int q = 8 * j / Hc, u0 = 8 * j % Hc;
    cp_async16(dst + (size_t)n * GH + ((j ^ (n & 7)) << 3),
               u + (size_t)n * u_gates * H + q * H + c * Hc + u0);
  }
}

// the dynamic shared memory and (above 8) the non-portable cluster size of
// a chain kernel
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, int cluster, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

// a launch configuration of `grid` CTAs of a chain (of `threads` threads)
// in clusters of `cluster`
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int grid, int cluster, size_t smem, void* stream, int threads = kChainThreads) {
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// float: a tile's 32 partial sums (or xp values) lie kTileStride floats
// from the next tile's, so that a warp's neighbouring tiles hit 32 banks
constexpr int kTileStride = 33;

// The all-gather of a forward chain: n16 16-byte chunks of this CTA's
// shared-memory tile `tile` (chunk i at byte offset off(i)) into the same
// place of every peer's tile, through distributed shared memory
template <typename Off>
__device__ __forceinline__ void push_columns(cg::cluster_group& cluster, char* tile, int n16,
                                             Off off, int C, int c) {
  for (int i = threadIdx.x; i < n16 * (C - 1); i += blockDim.x) {
    const size_t o = off(i % n16);
    const int4 v = *reinterpret_cast<const int4*>(tile + o);
    char* peer = cluster.map_shared_rank(tile, (c + 1 + i / n16) % C);
    *reinterpret_cast<int4*>(peer + o) = v;
  }
}

// cudaOccupancyMaxActiveClusters of a chain kernel at `cluster` CTAs a
// cluster, each with the whole of a block's shared memory (one CTA an SM)
template <typename Kernel>
int max_active_clusters(Kernel kernel, int cluster, int* out) {
  const size_t smem = 232448;
  cudaError_t err = cluster_config(kernel, cluster, smem);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch l(cluster, cluster, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &l.cfg);
}

}  // namespace mvt
