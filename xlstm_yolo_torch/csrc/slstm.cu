// sLSTM recurrence forward (K5) for NVIDIA Hopper, fp32, plain C interface.
//
// Replaces the TPU kernel `_kernel` in
// xlstm_yolo_tpu/kernels/slstm_pallas.py (entered through
// `slstm_scan_pallas`). Per time step and head it computes
//   raw = wx_t + y R + b                      (y: DH, R: DH x 4DH)
//   m'  = max(i, logsigmoid(f) + m)
//   c'  = exp(logsigmoid(f) + m - m') c + exp(i - m') tanh(z)
//   n'  = exp(logsigmoid(f) + m - m') n + exp(i - m')
//   y   = sigmoid(o) c' / n'
// for all S steps in one launch, with (y, c, n, m) on chip. wx
// (B, S, NH, 4, DH) is read once and y (B, S, NH, DH) written once. A call
// may carry the state in and out: (y, c, n, m) packed as (4, B, NH, DH),
// read before the first step and written after the last.
//
// What bounds it on this card: the work is 2 * 4 * DH^2 operations per
// 20 * DH bytes of wx and y, i.e. 0.4 * DH op/B (51 at DH 128), above the
// fp32 ridge of 20 op/B at DH >= 64 and at it for DH 32, so the least time is
// set by operations. In practice the chain is bound by latency: S steps in
// order, each a product of depth DH and two block-wide barriers.
//
// What the design does about it: the TPU kernel folded the heads into one
// block-diagonal product because one core runs grid steps serially. Here
// heads and batch rows are independent blocks: one CTA per (batch row,
// head), so B * NH chains run side by side and no zero block is multiplied.
// A CTA has 4 * DH threads, one per output column (gate g, channel e). Each
// thread keeps its column of R on chip for the whole sequence: the first
// min(DH, 64) entries in registers, the rest (DH 128: 64 entries, 128 KB
// per CTA) in shared memory, because R at DH 128 is 256 KB, more than either
// the register file's share or the shared memory of one SM alone. Per
// step a thread adds its dot of y (broadcast from shared memory) with its
// column to the prefetched wx entry, the four gates of a channel meet in
// shared memory, and DH threads do the pointwise update with c, n, m in
// registers.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr float NEG_INIT = -1e30f;

__device__ __forceinline__ float logsigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

template <int DH>
struct Cfg {
  static constexpr int NT = 4 * DH;                 // threads: one per (gate, channel)
  static constexpr int DREG = DH < 64 ? DH : 64;    // R entries per thread in registers
  static constexpr int DSM = DH - DREG;             // R entries per thread in shared memory
  static constexpr size_t kSmem = sizeof(float) * (size_t)DSM * NT;
};

// CARRY: the call reads state_in and/or writes state_out (either may still
// be null); without it the states start from their initial values and stay
// on chip, and the kernel touches neither pointer.
template <int DH, bool CARRY>
__global__ void __launch_bounds__(Cfg<DH>::NT)
slstm_fwd_kernel(const float* __restrict__ wx, const float* __restrict__ r,
                 const float* __restrict__ bias, const float* __restrict__ state_in,
                 float* __restrict__ y, float* __restrict__ state_out, int S, int NH) {
  constexpr int NT = Cfg<DH>::NT, DREG = Cfg<DH>::DREG, DSM = Cfg<DH>::DSM;
  extern __shared__ float rs[];                 // DSM x NT: rs[d][col] = R[DREG + d][col]
  __shared__ __align__(16) float ys[DH];        // y of the previous step
  __shared__ float raw[NT];                     // gate preacts of this step, gate-major
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;  // tid = g * DH + e

  // r[h] is (DH, 4, DH): entry (d, g, e) at d * 4DH + g * DH + e = d * NT + tid
  const float* rh = r + (size_t)h * DH * NT;
  float rr[DREG];
#pragma unroll
  for (int d = 0; d < DREG; ++d) rr[d] = rh[(size_t)d * NT + tid];
  for (int d = 0; d < DSM; ++d) rs[d * NT + tid] = rh[(size_t)(DREG + d) * NT + tid];
  const float bcol = bias[(size_t)h * NT + tid];
  float c = 0.f, n = 0.f, m = NEG_INIT;          // state of channel tid (tid < DH)
  // packed states: plane p of (y, c, n, m) at p * plane + sidx
  const size_t plane = (size_t)gridDim.x * NH * DH, sidx = ((size_t)b * NH + h) * DH + tid;
  if (tid < DH) {
    ys[tid] = CARRY && state_in ? state_in[sidx] : 0.f;
    if (CARRY && state_in) {
      c = state_in[plane + sidx];
      n = state_in[2 * plane + sidx];
      m = state_in[3 * plane + sidx];
    }
  }

  const size_t step = (size_t)NH * NT;           // wx floats per (batch row, step)
  const float* wxp = wx + ((size_t)b * S * NH + h) * NT + tid;
  float* yp = y + ((size_t)b * S * NH + h) * DH + tid;
  float wcur = wxp[0];
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    const float wnext = t + 1 < S ? wxp[(size_t)(t + 1) * step] : 0.f;  // prefetch
    float a0 = wcur + bcol, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int d = 0; d < DREG; d += 4) {
      const float4 yv = *reinterpret_cast<const float4*>(ys + d);
      a0 += yv.x * rr[d];
      a1 += yv.y * rr[d + 1];
      a2 += yv.z * rr[d + 2];
      a3 += yv.w * rr[d + 3];
    }
#pragma unroll 4
    for (int d = 0; d < DSM; d += 4) {
      const float4 yv = *reinterpret_cast<const float4*>(ys + DREG + d);
      a0 += yv.x * rs[d * NT + tid];
      a1 += yv.y * rs[(d + 1) * NT + tid];
      a2 += yv.z * rs[(d + 2) * NT + tid];
      a3 += yv.w * rs[(d + 3) * NT + tid];
    }
    raw[tid] = (a0 + a1) + (a2 + a3);
    __syncthreads();  // every thread has read ys; raw is complete
    if (tid < DH) {
      const float iraw = raw[tid], fraw = raw[DH + tid], zraw = raw[2 * DH + tid],
                  oraw = raw[3 * DH + tid];
      const float logfplusm = m + logsigmoid(fraw);
      const float mn = fmaxf(iraw, logfplusm);
      const float ig = expf(iraw - mn), fg = expf(logfplusm - mn);
      c = fg * c + ig * tanhf(zraw);
      n = fg * n + ig;
      m = mn;
      const float yn = c / n / (1.f + expf(-oraw));
      ys[tid] = yn;
      yp[(size_t)t * NH * DH] = yn;
    }
    wcur = wnext;
    __syncthreads();  // ys holds this step's y
  }
  if (CARRY && state_out && tid < DH) {
    state_out[sidx] = ys[tid];
    state_out[plane + sidx] = c;
    state_out[2 * plane + sidx] = n;
    state_out[3 * plane + sidx] = m;
  }
}

template <int DH, bool CARRY>
cudaError_t launch_variant(const float* wx, const float* r, const float* bias, const float* state_in,
                   float* y, float* state_out, int B, int S, int NH, cudaStream_t st) {
  static int configured = -1;  // device on which this variant's shared-memory limit is raised
  int dev;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (Cfg<DH>::kSmem > 0 && dev != configured) {
    if ((err = cudaFuncSetAttribute(slstm_fwd_kernel<DH, CARRY>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)Cfg<DH>::kSmem)) != cudaSuccess)
      return err;
    configured = dev;
  }
  slstm_fwd_kernel<DH, CARRY><<<dim3(B, NH), Cfg<DH>::NT, Cfg<DH>::kSmem, st>>>(
      wx, r, bias, state_in, y, state_out, S, NH);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const float* wx, const float* r, const float* bias, const float* state_in,
                   float* y, float* state_out, int B, int S, int NH, cudaStream_t st) {
  return state_in || state_out
             ? launch_variant<DH, true>(wx, r, bias, state_in, y, state_out, B, S, NH, st)
             : launch_variant<DH, false>(wx, r, bias, state_in, y, state_out, B, S, NH, st);
}

}  // namespace

extern "C" {

const char* slstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// wx (B, S, NH, 4, DH), r (NH, DH, 4, DH), bias (NH, 4, DH) -> y
// (B, S, NH, DH), all contiguous fp32. state_in and state_out are the packed
// (y, c, n, m), (4, B, NH, DH), or null: no state_in starts from zeros with
// m = -1e30, no state_out writes no last state. Returns 0 on success, else
// the CUDA error code (cudaErrorInvalidValue for an unsupported shape).
int slstm_fwd_f32(const float* wx, const float* r, const float* bias, const float* state_in,
                  float* y, float* state_out, int B, int S, int NH, int DH, void* stream) {
  if (B <= 0 || S <= 0 || NH <= 0 || NH > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (DH) {
    case 32: return launch<32>(wx, r, bias, state_in, y, state_out, B, S, NH, st);
    case 64: return launch<64>(wx, r, bias, state_in, y, state_out, B, S, NH, st);
    case 128: return launch<128>(wx, r, bias, state_in, y, state_out, B, S, NH, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
