// The tensor-core tile product shared by the port's mLSTM kernels (the ViL
// layer family in vil_layer.cu, the chunkwise backward in mlstm_bwd.cu, the
// chunkwise forward in mlstm_fwd.cu), with the cp.async, cluster and
// mbarrier helpers those kernels and the sLSTM scan (slstm.cu) share.
//
// One CTA of 8 warps computes a 64 x 64 fp32 output tile C += op(A) op(B)
// from operands in shared memory, on the tensor cores: warp-level
// `mma.sync.aligned.m16n8k8` with TF32 operands and fp32 accumulators, in
// the 3xTF32 split that keeps fp32 accuracy (the port's parity rule is
// fp32 with TF32 off):
//   hi = cvt.rna.tf32(x),  lo = cvt.rna.tf32(x - hi),
//   acc += lo*hi' + hi*lo' + hi*hi'        (lo*lo' is below fp32's rounding)
// At a third of the 495 TFLOP/s TF32 rate that is 165 TFLOP/s, 2.5x the
// 67 TFLOP/s fp32 CUDA-core peak, and each warp reads 12 shared-memory
// words per 12 products of 1,024 multiply-adds, where an FMA loop reads one
// or two per multiply-add.
//
// Warp w owns output rows 16*(w % 4) .. +16 and columns 32*(w / 4) .. +32:
// four 16 x 8 accumulator fragments (`Acc`, 16 floats a thread). Operands
// are read as op(A)[m][k] = A[m*lda + k] (or A[k*lda + m] when TA) and
// op(B)[k][n] = B[k*ldb + n] (or B[n*ldb + k] when TB). Tiles are 64 rows
// of `LDS` = 68 floats: rows stay 16-byte aligned for cp.async, and the
// fragment loads of a row-indexed operand (A, or B when TB) hit 32
// different banks; a k-indexed one (TA, or B without TB) takes two ways.
//
// `Causal` skips work that a triangular operand makes zero: OUT_LOWER
// leaves the 16 x 8 output fragments above the diagonal (column > row)
// at zero; K_LE_M runs the k loop only to the warp's last row (A lower
// triangular, A[m][k] = 0 for k > m); K_GE_M starts it at the warp's first
// row (A upper triangular).
//
// wgmma is not used: the chunk products are 64 x 64 x 64 with gate math
// between them, and TF32 wgmma wants both operands K-major in shared memory
// and a warpgroup pipeline that does not pay at this size.
//
// The bf16 kernels' product is tile_bf16.cuh's, on bf16 tiles.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

constexpr int T = 64;             // tile rows and columns
constexpr int LDS = T + 4;        // shared-memory row stride (floats)
constexpr int FLOATS = T * LDS;   // one tile
constexpr int THREADS = 256;      // the CTA the product is written for

enum Causal { FULL = 0, OUT_LOWER = 1, K_LE_M = 2, K_GE_M = 3 };

// The thread's index within its group of THREADS: a CTA of 2 * THREADS
// threads runs two tile products at once, one per group.
__device__ __forceinline__ int thread_in_group() { return threadIdx.x & (THREADS - 1); }

// The 16 accumulators of one thread: c[j][r] is row row(r), column col(j, r)
// of the output tile.
struct Acc {
  float c[4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) c[j][r] = 0.f;
  }
  __device__ __forceinline__ static int row(int r) {
    return 16 * ((thread_in_group() >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * (r >> 1);
  }
  __device__ __forceinline__ static int col(int j, int r) {
    return 32 * (thread_in_group() >> 7) + 8 * j + 2 * (threadIdx.x & 3) + (r & 1);
  }
};

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  hi &= 0xffffe000u;  // the tensor core reads the top 19 bits: make hi exactly that
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k step (k0 .. k0+7) of acc += op(A) op(B) for the warp's 16 x 32 part
// (rows m0.., columns n0..) of the 64 x 64 tile; lane = (g, t).
template <bool TA, bool TB, int MODE>
__device__ __forceinline__ void mma_k8(Acc& acc, const float* A, int lda, const float* B, int ldb,
                                       int k0, int m0, int n0, int g, int t,
                                       const float* kscale, const float* mscale) {
  float af[4];
  if (TA) {
    af[0] = A[(k0 + t) * lda + m0 + g];
    af[1] = A[(k0 + t) * lda + m0 + g + 8];
    af[2] = A[(k0 + t + 4) * lda + m0 + g];
    af[3] = A[(k0 + t + 4) * lda + m0 + g + 8];
  } else {
    af[0] = A[(m0 + g) * lda + k0 + t];
    af[1] = A[(m0 + g + 8) * lda + k0 + t];
    af[2] = A[(m0 + g) * lda + k0 + t + 4];
    af[3] = A[(m0 + g + 8) * lda + k0 + t + 4];
  }
  if (kscale != nullptr) {
    const float s0 = kscale[k0 + t], s1 = kscale[k0 + t + 4];
    af[0] *= s0;
    af[1] *= s0;
    af[2] *= s1;
    af[3] *= s1;
  }
  if (mscale != nullptr) {
    const float s0 = mscale[m0 + g], s1 = mscale[m0 + g + 8];
    af[0] *= s0;
    af[1] *= s1;
    af[2] *= s0;
    af[3] *= s1;
  }
  uint32_t ah[4], al[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split(af[i], ah[i], al[i]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (MODE == OUT_LOWER && n0 + 8 * j > m0 + 15) continue;  // warp-uniform
    const int n = n0 + 8 * j + g;
    const float b0f = TB ? B[n * ldb + k0 + t] : B[(k0 + t) * ldb + n];
    const float b1f = TB ? B[n * ldb + k0 + t + 4] : B[(k0 + t + 4) * ldb + n];
    uint32_t bh0, bl0, bh1, bl1;
    split(b0f, bh0, bl0);
    split(b1f, bh1, bl1);
    mma_tf32(acc.c[j], al, bh0, bh1);
    mma_tf32(acc.c[j], ah, bl0, bl1);
    mma_tf32(acc.c[j], ah, bh0, bh1);
  }
}

// acc += op(A) op(B) over k in [0, K), K a multiple of 8, for the warp's
// 16 x 32 part of the 64 x 64 tile, in 3xTF32. `kscale`, where given,
// multiplies column k of op(A) and `mscale` its row m (shared or global
// arrays of K and 64 floats). Every warp of the CTA (or of its group) calls
// it; nothing here synchronizes.
template <bool TA, bool TB, int MODE = FULL>
__device__ __forceinline__ void mma(Acc& acc, const float* A, int lda, const float* B, int ldb,
                                    int K, const float* kscale = nullptr,
                                    const float* mscale = nullptr) {
  const int lane = threadIdx.x & 31, w = thread_in_group() >> 5;
  const int m0 = 16 * (w & 3), n0 = 32 * (w >> 2);
  const int g = lane >> 2, t = lane & 3;
  int kbeg = 0, kend = K;
  if (MODE == K_LE_M) kend = K < m0 + 16 ? K : m0 + 16;
  if (MODE == K_GE_M) kbeg = m0;
#pragma unroll 2
  for (int k0 = kbeg; k0 < kend; k0 += 8)
    mma_k8<TA, TB, MODE>(acc, A, lda, B, ldb, k0, m0, n0, g, t, kscale, mscale);
}

// Two independent full products over the same K in one k loop, so that
// each warp has eight accumulator chains in flight instead of four:
// acc1 += op(A1) op(B1), acc2 += op(A2) op(B2) (kscale2 as mma's kscale).
template <bool TA1, bool TB1, bool TA2, bool TB2>
__device__ __forceinline__ void mma_pair(Acc& acc1, const float* A1, const float* B1, Acc& acc2,
                                         const float* A2, const float* B2, int ld, int K,
                                         const float* kscale2 = nullptr) {
  const int lane = threadIdx.x & 31, w = thread_in_group() >> 5;
  const int m0 = 16 * (w & 3), n0 = 32 * (w >> 2);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    mma_k8<TA1, TB1, FULL>(acc1, A1, ld, B1, ld, k0, m0, n0, g, t, nullptr, nullptr);
    mma_k8<TA2, TB2, FULL>(acc2, A2, ld, B2, ld, k0, m0, n0, g, t, kscale2, nullptr);
  }
}

// Sum over the four lanes of a quad: the lanes that hold one accumulator row
// of a warp's 32 columns (call with each thread's share of Acc::row(r)).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Writes the accumulators to a 64 x 64 tile at row stride ldc.
__device__ __forceinline__ void store(const Acc& acc, float* C, int ldc) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 2 * h;
      *reinterpret_cast<float2*>(C + Acc::row(r) * ldc + Acc::col(j, r)) =
          make_float2(acc.c[j][r], acc.c[j][r + 1]);
    }
}

// ---- asynchronous copies into shared memory --------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Wait for every committed group, or for all but the newest one.
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

__device__ __forceinline__ void cp_async_wait_one() { cp_async_wait<1>(); }

// Starts the copy of a ROWS x COLS block of a row-major global matrix (row
// stride `ld` floats, `src` its element (0, 0), which must be a valid
// address) into shared memory at row stride `ldd`; rows >= nrows and
// columns >= ncols land as zeros. 16-byte copies where the rows are
// 16-byte aligned, else 4-byte ones. The caller commits and waits.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_async(float* dst, int ldd, const float* src, long ld,
                                           int nrows, int ncols) {
  const bool vec = (ld & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * (COLS / 4); i += THREADS) {
      const int r = i / (COLS / 4), c = 4 * (i % (COLS / 4));
      const int left = ncols - c;
      const int nb = r < nrows && left > 0 ? 4 * (left < 4 ? left : 4) : 0;
      cp_async16(dst + r * ldd + c, nb ? src + r * ld + c : src, nb);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, c = i % COLS;
      const bool ok = r < nrows && c < ncols;
      cp_async4(dst + r * ldd + c, ok ? src + r * ld + c : src, ok ? 4 : 0);
    }
  }
}

// ---- thread block clusters ---------------------------------------------------
// The kernels that split one recurrence over a few CTAs (K1's value tiles,
// K5's gates) exchange partial results through distributed shared memory.

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster arrives; shared-memory writes
// before it (local or remote) are visible to every thread after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The generic address of `p` (this CTA's shared memory) in the CTA of the
// cluster with rank `rank`; ordinary loads and stores reach it.
template <typename T>
__device__ __forceinline__ T* cluster_peer(T* p, unsigned rank) {
  uint64_t out;
  asm("mapa.u64 %0, %1, %2;\n"
               : "=l"(out)
               : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<T*>(out);
}

// One-way exchange without a cluster barrier: a producer writes a 32-bit
// word into a CTA's shared memory with st.async, which counts its bytes down
// on that CTA's mbarrier; the consumer waits for the barrier's phase.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of `p` (this CTA's shared memory) in the CTA
// of rank `rank`.
__device__ __forceinline__ uint32_t cluster_u32(const void* p, unsigned rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes initialized mbarriers visible to the cluster (then cluster_sync).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of st.async data in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits for the completion of the phase of parity `parity`; what the
// st.async writes of that phase stored is visible after it.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      " .reg .pred p;\n"
      " WAIT:\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Stores v at shared::cluster address `dst`, counting 4 bytes down on the
// mbarrier at shared::cluster address `bar` (of the same CTA as dst).
__device__ __forceinline__ void st_async(uint32_t dst, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                   dst),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

// Launches `kernel` with clusters of `cx` CTAs along x; returns the launch's
// error (a cluster the card cannot place is refused here, never run).
template <typename... K, typename... A>
cudaError_t launch_cluster(void (*kernel)(K...), dim3 grid, dim3 block, size_t smem,
                           cudaStream_t st, int cx, A&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cx;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<A&&>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace tile
