// A C entry around the shared tile product (tile_mma.cuh), for its card test:
// one CTA computes C (64 x 64) = op(A) op(B) over K in slices of 64, each
// operand staged into a shared tile by cp.async as the kernels stage theirs.
// op(A) is A (64, K) row-major, or, when ta, the transpose of A (K, 64);
// op(B) is B (K, 64), or, when tb, the transpose of B (64, K). K is a
// multiple of 8; a last slice shorter than 64 lands zero-padded.

#include <cuda_runtime.h>

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

}  // extern "C"
