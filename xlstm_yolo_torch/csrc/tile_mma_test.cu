// C entries around the shared tile products, for their card tests: one CTA
// computes C (64 x 64) = op(A) op(B) over K in slices of 64. op(A) is A
// (64, K) row-major, or, when ta, the transpose of A (K, 64); op(B) is B
// (K, 64), or, when tb, the transpose of B (64, K). A last slice shorter
// than 64 lands zero-padded.
//
// tile_mma_test_f32 runs the 3xTF32 product (tile_mma.cuh), each operand
// staged into an fp32 tile by cp.async as the fp32 kernels stage theirs; K
// a multiple of 8.
//
// tile_mma_test_bf16 runs the bf16 tile layer (tile_bf16.cuh): each
// operand is rounded to bf16 once as it is staged into a bf16 tile, after
// op(A)'s row m is scaled by sa[m] where sa is given (the pre-scaled
// operands of the bf16 kernels), and read by ldmatrix (.trans for a k-major
// tile) into m16n8k16. `mode` is the product's Causal mode (0 FULL, 1
// OUT_LOWER, 2 K_LE_M, 3 K_GE_M; the last two want K 64) and `nlim` its
// column limit. K a multiple of 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_bf16.cuh"
#include "tile_mma.cuh"

namespace {

template <bool TA, bool TB>
__global__ void __launch_bounds__(tile::THREADS) tile_mma_test(const float* A, const float* B,
                                                               float* C, int K) {
  extern __shared__ __align__(16) float sm[];
  float* as = sm;
  float* bs = sm + tile::FLOATS;
  tile::Acc acc;
  acc.zero();
  for (int k0 = 0; k0 < K; k0 += tile::T) {
    const int kk = K - k0 < tile::T ? K - k0 : tile::T;
    if (TA)
      tile::load_async<tile::T, tile::T>(as, tile::LDS, A + (long)k0 * tile::T, tile::T, kk,
                                         tile::T);
    else
      tile::load_async<tile::T, tile::T>(as, tile::LDS, A + k0, K, tile::T, kk);
    if (TB)
      tile::load_async<tile::T, tile::T>(bs, tile::LDS, B + k0, K, tile::T, kk);
    else
      tile::load_async<tile::T, tile::T>(bs, tile::LDS, B + (long)k0 * tile::T, tile::T, kk,
                                         tile::T);
    tile::cp_async_commit();
    tile::cp_async_wait_all();
    __syncthreads();
    tile::mma<TA, TB>(acc, as, tile::LDS, bs, tile::LDS, (kk + 7) / 8 * 8);
    __syncthreads();
  }
  tile::store(acc, C, tile::T);
}

template <bool TA, bool TB, int MODE>
__global__ void __launch_bounds__(tile::THREADS) tile_mma16_test(const float* A, const float* B,
                                                                 float* C, int K,
                                                                 const float* sa, int nlim) {
  extern __shared__ __align__(16) __nv_bfloat16 sh[];
  __nv_bfloat16* as = sh;
  __nv_bfloat16* bs = sh + tile::HALVES;
  tile::Acc acc;
  acc.zero();
  for (int k0 = 0; k0 < K; k0 += tile::T) {
    const int kk = K - k0 < tile::T ? K - k0 : tile::T;
    for (int i = threadIdx.x; i < tile::T * tile::T; i += tile::THREADS) {
      const int r = i / tile::T, c = i % tile::T;  // row and column of the tile as stored
      // A's tile holds op(A)[m][k] at [m][k], or at [k][m] when TA
      const int m = TA ? c : r, k = TA ? r : c;
      float a = k < kk ? (TA ? A[(long)(k0 + k) * tile::T + m] : A[(long)m * K + k0 + k]) : 0.f;
      if (sa != nullptr) a *= sa[m];
      as[r * tile::LDH + c] = __float2bfloat16_rn(a);
      // B's tile holds op(B)[k][n] at [k][n], or at [n][k] when TB
      const int n = TB ? r : c, kb = TB ? c : r;
      const float b = kb < kk ? (TB ? B[(long)n * K + k0 + kb] : B[(long)(k0 + kb) * tile::T + n])
                              : 0.f;
      bs[r * tile::LDH + c] = __float2bfloat16_rn(b);
    }
    __syncthreads();
    tile::mma16<TA, TB, MODE>(acc, as, bs, (kk + 15) / 16 * 16, nlim);
    __syncthreads();
  }
  tile::store(acc, C, tile::T);
}

template <int MODE>
cudaError_t launch16(int ta, int tb, const float* A, const float* B, float* C, int K,
                     const float* sa, int nlim, cudaStream_t st) {
  auto kernel = ta ? (tb ? tile_mma16_test<true, true, MODE> : tile_mma16_test<true, false, MODE>)
                   : (tb ? tile_mma16_test<false, true, MODE> : tile_mma16_test<false, false, MODE>);
  const size_t smem = sizeof(__nv_bfloat16) * 2 * tile::HALVES;
  kernel<<<1, tile::THREADS, smem, st>>>(A, B, C, K, sa, nlim);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tile_mma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns 0 on success, else the CUDA error code of the launch.
int tile_mma_test_f32(const float* A, const float* B, float* C, int K, int ta, int tb,
                      void* stream) {
  if (K <= 0 || K % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * 2 * tile::FLOATS;
  auto kernel = ta ? (tb ? tile_mma_test<true, true> : tile_mma_test<true, false>)
                   : (tb ? tile_mma_test<false, true> : tile_mma_test<false, false>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, tile::THREADS, smem, st>>>(A, B, C, K);
  return cudaGetLastError();
}

// sa: null, or 64 floats; mode 0-3 (2 and 3 with K 64); 0 < nlim <= 64.
int tile_mma_test_bf16(const float* A, const float* B, float* C, int K, int ta, int tb,
                       const float* sa, int mode, int nlim, void* stream) {
  if (K <= 0 || K % 16 != 0 || mode < 0 || mode > 3 || (mode >= 2 && K != tile::T) ||
      nlim <= 0 || nlim > tile::T)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case tile::FULL: return launch16<tile::FULL>(ta, tb, A, B, C, K, sa, nlim, st);
    case tile::OUT_LOWER: return launch16<tile::OUT_LOWER>(ta, tb, A, B, C, K, sa, nlim, st);
    case tile::K_LE_M: return launch16<tile::K_LE_M>(ta, tb, A, B, C, K, sa, nlim, st);
    default: return launch16<tile::K_GE_M>(ta, tb, A, B, C, K, sa, nlim, st);
  }
}

}  // extern "C"
