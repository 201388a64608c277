// Row-wise kth-largest distinct value (K8) for NVIDIA Hopper, fp32, plain C
// interface.
//
// Replaces the TPU kernel `_kth_kernel` in
// xlstm_yolo_tpu/kernels/topk_pallas.py, entered through `rowwise_kth_value`.
// For x (R, N) it gives (R, 1): the value left as the row max after k-1
// passes that each suppress EVERY entry equal to the current row max. Equal
// values fall together, so the result is the kth largest DISTINCT value of
// the row, and -1e30 for a row with fewer than k distinct values. This is
// the threshold of the task-aligned assigner's top-k membership, not
// `torch.topk`.
//
// What bounds it on this card: one comparison chain per element on 4 bytes
// read, far below the fp32 ridge, so the least time is set by bytes: each
// element of x read once.
//
// What the design does about it: the TPU kernel held a (128, N) block in
// fast memory and ran k-1 serial lane reductions over it. Here one CTA owns
// a row and reads it from device memory exactly once, coalesced (16 bytes a
// thread where the row allows it). Each thread keeps the K largest distinct
// values of its strided share sorted in registers: an element that does not
// beat the thread's Kth value costs one comparison, and rows of the
// assigner's metric are mostly zeros, which are dropped as duplicates after
// the first. The kth distinct value of the row is among every thread's K
// best, so the merge runs the suppress chain on those: k rounds of a block
// max over each thread's largest value below the previous round's max.
// K is a template argument (1..16), so the lists never leave the registers.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int NT = 256;       // threads per CTA
constexpr int NW = NT / 32;   // warps per CTA
constexpr int MAX_K = 16;
constexpr float NEG = -1e30f;

// Keep v in the sorted (descending) list of the K largest distinct values.
template <int K>
__device__ __forceinline__ void keep(float (&top)[K], float v) {
  if (!(v > top[K - 1])) return;
  bool dup = false;
#pragma unroll
  for (int i = 0; i < K; ++i) dup |= v == top[i];
  if (dup) return;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (v > top[i]) {
      const float t = top[i];
      top[i] = v;
      v = t;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(NT) kth_value(const float* __restrict__ x,
                                                float* __restrict__ out, int N) {
  __shared__ float warp_max[NW];
  __shared__ float round_max;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* row = x + (size_t)blockIdx.x * N;

  float top[K];
#pragma unroll
  for (int i = 0; i < K; ++i) top[i] = NEG;

  if ((N & 3) == 0 && (reinterpret_cast<size_t>(row) & 15) == 0) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    for (int i = tid; i < N / 4; i += NT) {
      const float4 v = row4[i];
      keep<K>(top, v.x);
      keep<K>(top, v.y);
      keep<K>(top, v.z);
      keep<K>(top, v.w);
    }
  } else {
    for (int i = tid; i < N; i += NT) keep<K>(top, row[i]);
  }

  // the suppress chain over the threads' lists: round r leaves the rth
  // largest distinct value of the row in prev
  float prev = INFINITY;
  for (int r = 0; r < K; ++r) {
    float cand = NEG;
#pragma unroll
    for (int i = K - 1; i >= 0; --i)
      if (top[i] < prev) cand = top[i];
    for (int o = 16; o > 0; o >>= 1) cand = fmaxf(cand, __shfl_xor_sync(0xffffffffu, cand, o));
    if (lane == 0) warp_max[warp] = cand;
    __syncthreads();
    if (tid == 0) {
      float m = warp_max[0];
#pragma unroll
      for (int w = 1; w < NW; ++w) m = fmaxf(m, warp_max[w]);
      round_max = m;
    }
    __syncthreads();
    prev = round_max;
  }
  if (tid == 0) out[blockIdx.x] = prev;
}

template <int K>
cudaError_t launch(const float* x, float* out, int R, int N, cudaStream_t st) {
  kth_value<K><<<R, NT, 0, st>>>(x, out, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The largest k the kernel takes.
int topk_max_k() { return MAX_K; }

// x (R, N) contiguous fp32 -> out (R) fp32, the kth largest distinct value
// of each row (-1e30 where the row has fewer than k). Returns 0 on success,
// else the CUDA error code (cudaErrorInvalidValue for a shape or k it does
// not take).
int rowwise_kth_value_f32(const float* x, float* out, int R, int N, int k, void* stream) {
  if (R <= 0 || N <= 0 || k < 1 || k > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
#define CASE(K) case K: return static_cast<int>(launch<K>(x, out, R, N, st));
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
#undef CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
