// Row-wise kth-largest distinct value (K8) for NVIDIA Hopper, fp32, plain C
// interface.
//
// Replaces the TPU kernel `_kth_kernel` in
// xlstm_yolo_tpu/kernels/topk_pallas.py, entered through `rowwise_kth_value`.
// For x (R, N) it gives (R, 1): the value left as the row max after k-1
// passes that each suppress EVERY entry equal to the current row max. Equal
// values fall together, so the result is the kth largest DISTINCT value of
// the row, and -1e30 for a row with fewer than k distinct values above
// -1e30. This is the threshold of the task-aligned assigner's top-k
// membership, not `torch.topk`.
//
// What bounds it on this card: one comparison per element on 4 bytes read,
// far below the fp32 ridge, so the least time is set by bytes: each element
// of x read once.
//
// What the design does about it: the TPU kernel held a (128, N) block in
// fast memory and ran k-1 serial lane reductions over it. Here a row is read
// from device memory exactly once, and three things keep the card's memory
// busy:
//   Bytes in flight. A CTA owns a row, and each thread issues U 16-byte
//   loads before it looks at any of them. At large R, CTAs of 128 threads
//   and U 8 (16 KB a CTA, ten CTAs an SM); at small R, where the rows alone
//   leave SMs idle, CTAs of 512 threads and U 5 (40 KB a CTA: a whole row
//   of the assigner's 8400 anchors in one round trip). Either is far above
//   the ~25 KB an SM needs in flight at this card's latency.
//   Rows that are not 16-byte aligned read their few scalars before the
//   first 16-byte boundary and after the last one apart.
//   Cheap rejection. Each warp keeps its K largest distinct values so far in
//   K lanes, sorted, with the Kth as a running threshold: an element at or
//   below it, or equal to the smallest listed value, costs one comparison
//   and a vote (rows of the assigner's metric are mostly zeros, which fall
//   out once a zero is listed). The survivors are found by a warp ballot and
//   inserted one distinct value at a time, each insertion two ballots and
//   two shuffles.
//   One barrier. The warps' lists go to shared memory as order-preserving
//   integer keys, one barrier, and one warp runs the suppress chain over
//   them: K rounds of one warp-wide integer max (redux).
// K is a template argument (1..16), so the lists never leave the registers.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int MAX_K = 16;
constexpr int SMALL_R = 512;  // up to this many rows, the CTAs of 512 threads
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// Insert the warp-uniform w into the warp's list: lane j < K holds the jth
// largest distinct value so far (NEG: none), thr is the Kth and low the
// smallest listed value (NaN while none is, which equals nothing).
template <int K>
__device__ __forceinline__ void insert(float& lst, float& thr, float& low, float w, int lane) {
  if (!(w > thr)) return;                                 // the threshold rose past it
  if (__ballot_sync(FULL, lane < K && lst == w)) return;  // already in
  const int pos = __popc(__ballot_sync(FULL, lane < K && lst > w));
  const float up = __shfl_up_sync(FULL, lst, 1);
  if (lane < K) lst = lane == pos ? w : (lane > pos ? up : lst);
  thr = __shfl_sync(FULL, lst, K - 1);
  low = thr > NEG ? thr : fminf(low, w);
}

// Every lane offers v; the survivors go into the list, one distinct value at
// a time (the lanes holding an equal value are done with it).
template <int K>
__device__ __forceinline__ void offer(float& lst, float& thr, float& low, float v, int lane) {
  unsigned m = __ballot_sync(FULL, v > thr && v != low);
  while (m) {
    const float w = __shfl_sync(FULL, v, __ffs(m) - 1);
    m &= ~__ballot_sync(FULL, v == w);
    insert<K>(lst, thr, low, w, lane);
  }
}

// An int whose order is the float order (-0 taken as +0, which it equals).
__device__ __forceinline__ int order_key(float f) {
  const int k = __float_as_int(f + 0.f);
  return k ^ ((k >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// NT threads a CTA, U 16-byte loads a thread in flight.
template <int K, int NT, int U>
__global__ void __launch_bounds__(NT) kth_value(const float* __restrict__ x,
                                                float* __restrict__ out, int N) {
  constexpr int NW = NT / 32;
  __shared__ int lists[NW * K];  // every warp's list, as keys
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, r = blockIdx.x;
  const float* row = x + (size_t)r * N;
  // the row: `head` scalars up to a 16-byte boundary, M float4s, `tail` scalars
  const int head = min((int)((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) / 4, N);
  const int M = (N - head) / 4, tail = N - head - 4 * M;
  const float4* body = reinterpret_cast<const float4*>(row + head);

  float lst = NEG, thr = NEG, low = __int_as_float(0x7fffffff);
  for (int start = 0; start < M; start += NT * U) {
    float4 v[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int i = start + j * NT + (int)threadIdx.x;
      v[j] = i < M ? body[i] : make_float4(NEG, NEG, NEG, NEG);
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (start + j * NT >= M) break;  // alike in the CTA: no lane has a load left
      offer<K>(lst, thr, low, v[j].x, lane);
      offer<K>(lst, thr, low, v[j].y, lane);
      offer<K>(lst, thr, low, v[j].z, lane);
      offer<K>(lst, thr, low, v[j].w, lane);
    }
  }
  if (warp == 0) {  // the scalars off the 16-byte grid
    const int t = lane - 4;
    offer<K>(lst, thr, low,
             lane < head ? row[lane] : (t >= 0 && t < tail ? row[head + 4 * M + t] : NEG), lane);
  }

  if (lane < K) lists[warp * K + lane] = order_key(lst);
  __syncthreads();
  if (warp != 0) return;

  // the suppress chain over the lists: round i leaves the ith largest
  // distinct value of the row in prev (NEG once there are fewer)
  constexpr int C = NW * K, P = (C + 31) / 32;
  const int neg = order_key(NEG);
  int key[P];
#pragma unroll
  for (int i = 0; i < P; ++i) key[i] = i * 32 + lane < C ? lists[i * 32 + lane] : neg;
  int prev = 0x7fffffff;
  for (int round = 0; round < K; ++round) {
    int cand = neg;
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (key[i] < prev) cand = max(cand, key[i]);
    prev = __reduce_max_sync(FULL, cand);
  }
  if (lane == 0) out[r] = key_value(prev);
}

template <int K>
cudaError_t launch(const float* x, float* out, int R, int N, cudaStream_t st) {
  if (R <= SMALL_R) kth_value<K, 512, 5><<<R, 512, 0, st>>>(x, out, N);
  else kth_value<K, 128, 8><<<R, 128, 0, st>>>(x, out, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The largest k the kernel takes.
int topk_max_k() { return MAX_K; }

// x (R, N) contiguous fp32, any alignment of 4 bytes -> out (R) fp32, the
// kth largest distinct value of each row (-1e30 where the row has fewer
// than k). Returns 0 on success, else the CUDA error code
// (cudaErrorInvalidValue for a shape or k it does not take).
int rowwise_kth_value_f32(const float* x, float* out, int R, int N, int k, void* stream) {
  if (R <= 0 || N <= 0 || k < 1 || k > MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
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
