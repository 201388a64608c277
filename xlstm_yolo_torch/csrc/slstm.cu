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
// 20 * DH bytes of wx and y, i.e. 0.4 * DH op/B, so the least time is set by
// operations (bytes at DH 32). In practice the chain is bound by latency: S
// steps in order, each a product of depth DH, the gate math, and the
// exchange of y between the threads that hold R.
//
// What the design does about it: the TPU kernel folded the heads into one
// block-diagonal product because one core runs grid steps serially. Here
// every (batch row, head) chain runs side by side; one thread per gate
// column (gate g, channel e) holds R[:, g, e] in registers for the whole
// sequence, and wx is staged into shared memory RING steps ahead of its step
// by cp.async, each thread copying the one word a step it alone reads (so the
// ring needs no barrier). Each thread applies its own gate's nonlinearity
// (logsigmoid of f, tanh of z, sigmoid of o) before the gates meet, so the
// transcendentals run on four sets of threads at once and the chain after
// the exchange is two exps, two FMAs and one division. By head dim:
//   DH 32: one CTA of four warps per chain, warp g = gate g, lane e =
//     channel e. Every warp runs the pointwise update of all 32 channels and
//     keeps its own copy of y in shared memory, which the next step's y R
//     reads as broadcasts: one block barrier a step, the rest warp-local.
//   DH 64: one CTA of 256 threads per chain; y goes through shared memory
//     (two block barriers a step).
//   DH 128: R is 256 KB, as much as one SM's register file, so a cluster of
//     two CTAs holds it (two gates each, 128 registers a thread). Each thread
//     writes its gate value into both CTAs' shared memory with st.async,
//     which counts the bytes down on that CTA's mbarrier; a CTA's pointwise
//     threads wait for the barrier's phase alone (no cluster barrier a
//     step), and both CTAs run the update, so both hold the new y.
// The per-step times of these designs and of the ones they replaced are in
// PERF.md.
//
// Under autograd the forward also writes, per step and channel, the four gate
// values it used (i_raw, logsigmoid(f_raw), tanh(z_raw), sigmoid(o_raw)) and
// the new (c, n, m) to a workspace `saved` (B, S, NH, 7, DH); without it
// (null) nothing but y leaves the chip, as before.
//
// The backward (slstm_bwd_f32) replaces the JAX entry's `_bwd` in
// slstm_pallas.py, which takes jax.vjp of the plain scan `slstm_scan`: one
// reverse loop on the device, no Pallas kernel. Here it is one launch that
// walks every (batch row, head) chain from t = S-1 down to 0 with the
// stabilizer m held constant (y is invariant to it, so these are the exact
// gradients up to rounding). Per step and channel:
//   dy   = dy_t + (R draw_{t+1})           (the recurrent part: 4 DH -> DH)
//   dc'  = dc + dy so / n,  dn' = dn - dy so c / n^2
//   draw = (dig ig, dfg fg sigmoid(-f), dc' ig (1 - tz^2), dy (c/n) so (1 - so))
//          with dfg = dc' c_{t-1} + dn' n_{t-1}, dig = dc' tz + dn'
//   dc, dn = dc' fg, dn' fg                 (carried to step t-1)
// where ig = exp(i - m) and fg = exp(logsigmoid(f) + m_{t-1} - m) are
// recomputed from the saved values exactly as the forward computed them
// (the same intrinsics on the same operands), so the backward never
// recomputes a state with other rounding. It writes draw = dwx
// (B, S, NH, 4, DH); dr = sum y_{t-1}^T draw and db = sum draw are left to
// the wrapper (one einsum, one sum), as the JAX package leaves them to XLA.
//
// What bounds the backward: like the forward, the chain, S steps in order,
// each a product of depth 4 DH (R's rows against the four gates' draw), a
// reduction, the pointwise update and one block barrier. Its bytes (the
// workspace, dy and dwx, 12 DH floats a step) stream through a cp.async ring
// 8 or 16 steps ahead of the walk. The design keeps R in registers as rows:
// thread (d, q) holds R[d, q, :] and dots it with gate q's draw, the QPC
// gates of a channel sit in adjacent lanes and are summed by shuffles, and
// every lane of the channel then runs the pointwise update itself, so y's
// gradient never goes through shared memory; only draw does, double-
// buffered by step parity (one barrier a step). DH 32 and 64: one CTA of
// 4 DH threads per chain. DH 128: R's rows are 256 KB, so a cluster of two
// CTAs holds them, two gates each (128 registers a thread); each CTA's
// partial (DH floats) goes to both CTAs' shared memory with st.async on an
// mbarrier, both sum the two halves in rank order and run the update, and
// each keeps the draw of its own two gates.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

constexpr float NEG_INIT = -1e30f;
constexpr int RING = 16;  // steps of wx staged ahead

// The gate math runs on the fast exp, log and division intrinsics (tanh
// stays accurate): at head dim 32 the pointwise chain paces each step, and
// these took it from 0.40 to 0.28 us a step while the scan moved from 4e-7
// to 7e-6 of the plain one's max (PERF.md), far inside the 1e-3 gate.
__device__ __forceinline__ float logsigmoid(float x) {
  return fminf(x, 0.f) - __logf(1.f + __expf(-fabsf(x)));
}

// Gate g's nonlinearity, applied where its preact is made: i as it is, f
// to logsigmoid(f), z to tanh(z), o to sigmoid(o).
__device__ __forceinline__ float gate_act(int g, float raw) {
  if (g == 1) return logsigmoid(raw);
  if (g == 2) return tanhf(raw);
  if (g == 3) return __fdividef(1.f, 1.f + __expf(-raw));
  return raw;
}

// The pointwise update of one channel from its four gate values; returns
// the new y.
__device__ __forceinline__ float cell(float i, float lsf, float tz, float so, float& c, float& n,
                                      float& m) {
  const float logfplusm = m + lsf;
  const float mn = fmaxf(i, logfplusm);
  const float ig = __expf(i - mn), fg = __expf(logfplusm - mn);
  c = fg * c + ig * tz;
  n = fg * n + ig;
  m = mn;
  return __fdividef(c * so, n);
}

constexpr int SAVED = 7;  // values a step leaves in `saved`: i, lsf, tz, so, c, n, m

struct Args {
  const float* wx;        // (B, S, NH, 4, DH)
  const float* r;         // (NH, DH, 4, DH)
  const float* bias;      // (NH, 4, DH)
  const float* state_in;  // (4, B, NH, DH) or null
  float* y;               // (B, S, NH, DH)
  float* state_out;       // (4, B, NH, DH) or null
  float* saved;           // (B, S, NH, SAVED, DH) or null
  int B, S, NH;
};

// ---- DH 32: a warp per gate -------------------------------------------------

template <bool CARRY, bool SAVE>
__global__ void __launch_bounds__(128) slstm_gate_warps(Args a) {
  constexpr int DH = 32;
  __shared__ __align__(16) float ys[4][DH];  // y of the previous step, one copy per warp
  __shared__ float xb[2][4][DH];             // the step's gate values, by step parity
  __shared__ float ring[RING][4 * DH];
  const int tid = threadIdx.x, e = tid & 31, g = tid >> 5;  // tid = g * DH + e
  const int b = blockIdx.x, h = blockIdx.y, S = a.S, NH = a.NH;

  float rr[DH];  // R[h][d][g][e]
  const float* rh = a.r + (size_t)h * DH * 4 * DH + tid;
#pragma unroll
  for (int d = 0; d < DH; ++d) rr[d] = rh[(size_t)d * 4 * DH];
  const float bcol = a.bias[(size_t)h * 4 * DH + tid];
  const size_t plane = (size_t)a.B * NH * DH, sidx = ((size_t)b * NH + h) * DH + e;
  float yv = 0.f, c = 0.f, n = 0.f, m = NEG_INIT;  // channel e, in every warp
  if (CARRY && a.state_in) {
    yv = a.state_in[sidx];
    c = a.state_in[plane + sidx];
    n = a.state_in[2 * plane + sidx];
    m = a.state_in[3 * plane + sidx];
  }
  ys[g][e] = yv;
  __syncwarp();

  const size_t step = (size_t)NH * 4 * DH;
  const float* src = a.wx + ((size_t)b * S * NH + h) * 4 * DH + tid;
  float* yp = a.y + ((size_t)b * S * NH + h) * DH + e;
  auto issue = [&](int t) {
    if (t < S) tile::cp_async4(&ring[t % RING][tid], src + t * step, 4);
    tile::cp_async_commit();
  };
  for (int t = 0; t < RING - 1; ++t) issue(t);

  for (int t = 0; t < S; ++t) {
    issue(t + RING - 1);
    tile::cp_async_wait<RING - 1>();
    float a0 = ring[t % RING][tid] + bcol, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      const float4 y4 = *reinterpret_cast<const float4*>(&ys[g][d]);
      a0 += y4.x * rr[d];
      a1 += y4.y * rr[d + 1];
      a2 += y4.z * rr[d + 2];
      a3 += y4.w * rr[d + 3];
    }
    const int par = t & 1;
    xb[par][g][e] = gate_act(g, (a0 + a1) + (a2 + a3));
    __syncthreads();  // the four gates of every channel are in
    yv = cell(xb[par][0][e], xb[par][1][e], xb[par][2][e], xb[par][3][e], c, n, m);
    __syncwarp();     // every lane of this warp has read its ys copy
    ys[g][e] = yv;
    __syncwarp();
    if (g == 0) yp[(size_t)t * NH * DH] = yv;
    if (SAVE) {  // warp g writes gate g's value and, for g < 3, state g
      float* sp = a.saved + (((size_t)b * S + t) * NH + h) * SAVED * DH + e;
      sp[g * DH] = xb[par][g][e];
      if (g < 3) sp[(4 + g) * DH] = g == 0 ? c : (g == 1 ? n : m);
    }
  }
  if (CARRY && a.state_out && g == 0) {
    a.state_out[sidx] = yv;
    a.state_out[plane + sidx] = c;
    a.state_out[2 * plane + sidx] = n;
    a.state_out[3 * plane + sidx] = m;
  }
}

// ---- DH 64, 128: a thread per gate column, NC CTAs per chain -------------------

template <int DH, int NC, bool CARRY, bool SAVE>
__global__ void __launch_bounds__(4 * DH / NC, 1) slstm_columns(Args a) {
  constexpr int NT = 4 * DH / NC;  // this CTA's columns: gates NT / DH * rank ..
  __shared__ __align__(16) float ys[DH];     // y of the previous step
  __shared__ float xb[2][4 * DH];            // the step's gate values, by step parity
  __shared__ float ring[RING][NT];
  __shared__ __align__(8) uint64_t full[2];  // NC > 1: xb[p] is complete, by step parity
  const int rank = NC > 1 ? (int)tile::cluster_rank() : 0;
  const int b = blockIdx.y, h = blockIdx.z, tid = threadIdx.x, col = rank * NT + tid;
  const int g = col / DH, S = a.S, NH = a.NH;
  constexpr unsigned XBYTES = sizeof(float) * 4 * DH;  // one step's gate values, from all CTAs

  // r[h] is (DH, 4, DH): entry (d, g, e) at d * 4DH + g * DH + e = d * 4DH + col
  float rr[DH];
  const float* rh = a.r + (size_t)h * DH * 4 * DH + col;
#pragma unroll
  for (int d = 0; d < DH; ++d) rr[d] = rh[(size_t)d * 4 * DH];
  const float bcol = a.bias[(size_t)h * 4 * DH + col];
  const size_t plane = (size_t)a.B * NH * DH, sidx = ((size_t)b * NH + h) * DH + tid;
  float c = 0.f, n = 0.f, m = NEG_INIT;  // state of channel tid (tid < DH)
  if (tid < DH) {
    ys[tid] = CARRY && a.state_in ? a.state_in[sidx] : 0.f;
    if (CARRY && a.state_in) {
      c = a.state_in[plane + sidx];
      n = a.state_in[2 * plane + sidx];
      m = a.state_in[3 * plane + sidx];
    }
  }

  const size_t step = (size_t)NH * 4 * DH;
  const float* src = a.wx + ((size_t)b * S * NH + h) * 4 * DH + col;
  float* yp = a.y + ((size_t)b * S * NH + h) * DH + tid;
  auto issue = [&](int t) {
    if (t < S) tile::cp_async4(&ring[t % RING][tid], src + t * step, 4);
    tile::cp_async_commit();
  };
  for (int t = 0; t < RING - 1; ++t) issue(t);
  uint32_t xdst[NC], bdst[NC][2];  // this thread's xb[0] word and the barriers, in every CTA
  if (NC > 1) {
#pragma unroll
    for (int r = 0; r < NC; ++r) {
      xdst[r] = tile::cluster_u32(&xb[0][col], r);
      bdst[r][0] = tile::cluster_u32(&full[0], r);
      bdst[r][1] = tile::cluster_u32(&full[1], r);
    }
    if (tid == 0) {
      tile::mbar_init(&full[0], 1);
      tile::mbar_init(&full[1], 1);
      tile::mbar_init_fence();
      tile::mbar_expect_tx(&full[0], XBYTES);
      tile::mbar_expect_tx(&full[1], XBYTES);
    }
    tile::cluster_sync();  // the peers' barriers are set; ys is set
  } else {
    __syncthreads();
  }

  for (int t = 0; t < S; ++t) {
    issue(t + RING - 1);
    tile::cp_async_wait<RING - 1>();
    float a0 = ring[t % RING][tid] + bcol, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      const float4 yv = *reinterpret_cast<const float4*>(ys + d);
      a0 += yv.x * rr[d];
      a1 += yv.y * rr[d + 1];
      a2 += yv.z * rr[d + 2];
      a3 += yv.w * rr[d + 3];
    }
    const float v = gate_act(g, (a0 + a1) + (a2 + a3));
    const int par = t & 1;
    if (NC > 1) {
#pragma unroll
      for (int r = 0; r < NC; ++r)
        tile::st_async(xdst[r] + par * XBYTES, v, bdst[r][par]);
    } else {
      xb[par][col] = v;
      __syncthreads();
    }
    if (tid < DH) {
      if (NC > 1) {
        // every column of the step is in, so every local thread is past its
        // read of ys; then re-arm this barrier for its next phase
        tile::mbar_wait(&full[par], (t >> 1) & 1);
        if (tid == 0) tile::mbar_expect_tx(&full[par], XBYTES);
      }
      const float* x = xb[par];
      const float yn = cell(x[tid], x[DH + tid], x[2 * DH + tid], x[3 * DH + tid], c, n, m);
      ys[tid] = yn;
      if (rank == 0) yp[(size_t)t * NH * DH] = yn;
      if (SAVE) {  // rank 0 writes the gate values, the last rank the states
        float* sp = a.saved + (((size_t)b * S + t) * NH + h) * SAVED * DH + tid;
        if (rank == 0) {
#pragma unroll
          for (int v = 0; v < 4; ++v) sp[v * DH] = x[v * DH + tid];
        }
        if (rank == NC - 1) {
          sp[4 * DH] = c;
          sp[5 * DH] = n;
          sp[6 * DH] = m;
        }
      }
    }
    __syncthreads();  // ys holds this step's y
  }
  if (CARRY && a.state_out && rank == 0 && tid < DH) {
    a.state_out[sidx] = ys[tid];
    a.state_out[plane + sidx] = c;
    a.state_out[2 * plane + sidx] = n;
    a.state_out[3 * plane + sidx] = m;
  }
  if (NC > 1) tile::cluster_sync();  // no CTA leaves while a peer's st.async may target it
}

template <bool CARRY, bool SAVE>
cudaError_t launch(const Args& a, int DH, cudaStream_t st) {
  if (DH == 32) {
    slstm_gate_warps<CARRY, SAVE><<<dim3(a.B, a.NH), 128, 0, st>>>(a);
    return cudaGetLastError();
  }
  if (DH == 64) {
    slstm_columns<64, 1, CARRY, SAVE><<<dim3(1, a.B, a.NH), 256, 0, st>>>(a);
    return cudaGetLastError();
  }
  if (DH == 128)
    return tile::launch_cluster(slstm_columns<128, 2, CARRY, SAVE>, dim3(2, a.B, a.NH),
                                dim3(256), 0, st, 2, a);
  return cudaErrorInvalidValue;
}

// ---- the backward: one reverse walk per chain ---------------------------------

struct BwdArgs {
  const float* r;         // (NH, DH, 4, DH)
  const float* saved;     // (B, S, NH, SAVED, DH), as the forward wrote it
  const float* dy;        // (B, S, NH, DH)
  const float* state_in;  // (4, B, NH, DH) or null: the state before step 0
  float* dwx;             // (B, S, NH, 4, DH)
  int B, S, NH;
};

// Steps of the workspace and dy staged ahead of the walk: a step is 8 DH floats.
__host__ __device__ constexpr int bwd_ring(int dh) { return dh >= 128 ? 8 : 16; }

// DH channels, NC CTAs a chain, QPC = 4 / NC gates a CTA; thread (d, qq) =
// tid d * QPC + qq holds R[d, rank * QPC + qq, :].
template <int DH, int NC>
__global__ void __launch_bounds__(4 * DH / NC, 1) slstm_bwd_walk(BwdArgs a) {
  constexpr int QPC = 4 / NC, NT = DH * QPC, RB = bwd_ring(DH);
  constexpr int W = 8 * DH;       // floats of one ring slot: saved (7 DH), then dy (DH)
  constexpr int DP = DH + 8;      // padded row of the draw buffer: the QPC rows' words
                                  // read together fall in different banks
  constexpr unsigned XBYTES = sizeof(float) * NC * DH;  // one step's partials, from all CTAs
  __shared__ __align__(16) float ring[RB][W];
  __shared__ __align__(16) float drs[2][QPC][DP];  // this CTA's gates' draw, by step parity
  __shared__ float xp[2][NC][DH];                  // NC > 1: the CTAs' partials, by parity
  __shared__ __align__(8) uint64_t full[2];        // NC > 1: xp[p] is complete
  const int rank = NC > 1 ? (int)tile::cluster_rank() : 0;
  const int b = blockIdx.y, h = blockIdx.z, tid = threadIdx.x;
  const int d = tid / QPC, qq = tid % QPC, q = rank * QPC + qq;
  const int S = a.S, NH = a.NH;

  float rr[DH];  // R[h][d][q][:]
  {
    const float4* rh = reinterpret_cast<const float4*>(a.r + (((size_t)h * DH + d) * 4 + q) * DH);
#pragma unroll
    for (int e = 0; e < DH; e += 4) {
      const float4 v = rh[e / 4];
      rr[e] = v.x;
      rr[e + 1] = v.y;
      rr[e + 2] = v.z;
      rr[e + 3] = v.w;
    }
  }
  // the state before step 0
  float c0 = 0.f, n0 = 0.f, m0 = NEG_INIT;
  if (a.state_in) {
    const size_t plane = (size_t)a.B * NH * DH, sidx = ((size_t)b * NH + h) * DH + d;
    c0 = a.state_in[plane + sidx];
    n0 = a.state_in[2 * plane + sidx];
    m0 = a.state_in[3 * plane + sidx];
  }
  for (int i = tid; i < 2 * QPC * DP; i += NT) (&drs[0][0][0])[i] = 0.f;

  const size_t chain = (size_t)b * S * NH + h;  // (b, t = 0, h) in units of one (b, t, h) row
  // iteration it walks step t = S - 1 - it
  auto issue = [&](int it) {
    if (it < S) {
      const size_t row = chain + (size_t)(S - 1 - it) * NH;
      float* dst = ring[it % RB];
#pragma unroll
      for (int i = tid; i < W; i += NT)
        tile::cp_async4(dst + i, i < SAVED * DH ? a.saved + row * SAVED * DH + i
                                                : a.dy + row * DH + (i - SAVED * DH), 4);
    }
    tile::cp_async_commit();
  };
  for (int it = 0; it < RB - 1; ++it) issue(it);

  uint32_t xdst[NC], bdst[NC][2];  // this thread's xp[0][rank][d] and the barriers, in every CTA
  if (NC > 1) {
#pragma unroll
    for (int r = 0; r < NC; ++r) {
      xdst[r] = tile::cluster_u32(&xp[0][rank][d], r);
      bdst[r][0] = tile::cluster_u32(&full[0], r);
      bdst[r][1] = tile::cluster_u32(&full[1], r);
    }
    if (tid == 0) {
      tile::mbar_init(&full[0], 1);
      tile::mbar_init(&full[1], 1);
      tile::mbar_init_fence();
      tile::mbar_expect_tx(&full[0], XBYTES);
      tile::mbar_expect_tx(&full[1], XBYTES);
    }
  }
  tile::cp_async_wait<RB - 3>();  // the steps of iterations 0 and 1 are in
  if (NC > 1) tile::cluster_sync();  // the peers' barriers are set; drs and the ring are set
  else __syncthreads();

  float dc = 0.f, dn = 0.f;  // the carries into step t, channel d (alike in the channel's lanes)
  float* out = a.dwx + chain * 4 * DH + q * DH + d;
  for (int it = 0; it < S; ++it) {
    const int t = S - 1 - it, par = it & 1;
    issue(it + RB - 1);
    // the recurrent part of y's gradient: R[d, q, :] . draw_{t+1}[q, :], over the gates
    const float* dprev = drs[par ^ 1][qq];
    float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
    for (int e = 0; e < DH; e += 4) {
      const float4 v = *reinterpret_cast<const float4*>(dprev + e);
      p0 += v.x * rr[e];
      p1 += v.y * rr[e + 1];
      p2 += v.z * rr[e + 2];
      p3 += v.w * rr[e + 3];
    }
    float part = (p0 + p1) + (p2 + p3);
#pragma unroll
    for (int o = 1; o < QPC; o <<= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    float dyr = part;
    if (NC > 1) {
      if (qq == 0) {
#pragma unroll
        for (int r = 0; r < NC; ++r) tile::st_async(xdst[r] + par * XBYTES, part, bdst[r][par]);
      }
      tile::mbar_wait(&full[par], (it >> 1) & 1);
      if (tid == 0) tile::mbar_expect_tx(&full[par], XBYTES);  // re-arm for iteration it + 2
      dyr = 0.f;
#pragma unroll
      for (int r = 0; r < NC; ++r) dyr += xp[par][r][d];
    }

    // the pointwise step of channel d, in each of its lanes
    const float* sv = ring[it % RB];
    const float ii = sv[d], lsf = sv[DH + d], tz = sv[2 * DH + d], so = sv[3 * DH + d];
    const float c = sv[4 * DH + d], n = sv[5 * DH + d], m = sv[6 * DH + d];
    float cp = c0, np_ = n0, mp = m0;
    if (t > 0) {
      const float* pv = ring[(it + 1) % RB];
      cp = pv[4 * DH + d];
      np_ = pv[5 * DH + d];
      mp = pv[6 * DH + d];
    }
    const float ig = __expf(ii - m), fg = __expf((mp + lsf) - m);  // as the forward's cell()
    const float dyt = sv[7 * DH + d] + dyr;
    const float inv_n = 1.f / n, hn = c * inv_n;
    const float dct = dc + dyt * so * inv_n;
    const float dnt = dn - dyt * so * hn * inv_n;
    const float dfg = dct * cp + dnt * np_;
    const float dig = dct * tz + dnt;
    dc = dct * fg;
    dn = dnt * fg;
    float g;
    if (q == 0) g = dig * ig;
    else if (q == 1) g = dfg * fg * -expm1f(lsf);  // d logsigmoid(f) / df = 1 - sigmoid(f)
    else if (q == 2) g = dct * ig * (1.f - tz * tz);
    else g = dyt * hn * so * (1.f - so);
    drs[par][qq][d] = g;
    out[(size_t)t * NH * 4 * DH] = g;
    tile::cp_async_wait<RB - 3>();  // the next iteration's two steps are in
    __syncthreads();                  // drs[par] holds this step's draw
  }
  if (NC > 1) tile::cluster_sync();  // no CTA leaves while a peer's st.async may target it
}

cudaError_t launch_bwd(const BwdArgs& a, int DH, cudaStream_t st) {
  if (DH == 32) {
    slstm_bwd_walk<32, 1><<<dim3(1, a.B, a.NH), 128, 0, st>>>(a);
    return cudaGetLastError();
  }
  if (DH == 64) {
    slstm_bwd_walk<64, 1><<<dim3(1, a.B, a.NH), 256, 0, st>>>(a);
    return cudaGetLastError();
  }
  if (DH == 128)
    return tile::launch_cluster(slstm_bwd_walk<128, 2>, dim3(2, a.B, a.NH), dim3(256), 0, st, 2,
                                a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* slstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// wx (B, S, NH, 4, DH), r (NH, DH, 4, DH), bias (NH, 4, DH) -> y
// (B, S, NH, DH), all contiguous fp32, DH 32, 64 or 128. state_in and
// state_out are the packed (y, c, n, m), (4, B, NH, DH), or null: no
// state_in starts from zeros with m = -1e30, no state_out writes no last
// state. saved is null or (B, S, NH, 7, DH): every step's gate values
// (i_raw, logsigmoid(f_raw), tanh(z_raw), sigmoid(o_raw)) and new (c, n, m),
// which slstm_bwd_f32 reads. Returns 0 on success, else the CUDA error code
// (cudaErrorInvalidValue for an unsupported shape).
int slstm_fwd_f32(const float* wx, const float* r, const float* bias, const float* state_in,
                  float* y, float* state_out, float* saved, int B, int S, int NH, int DH,
                  void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || NH <= 0 || NH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{wx, r, bias, state_in, y, state_out, saved, B, S, NH};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool carry = state_in || state_out;
  cudaError_t err = saved ? (carry ? launch<true, true>(a, DH, st) : launch<false, true>(a, DH, st))
                          : (carry ? launch<true, false>(a, DH, st)
                                   : launch<false, false>(a, DH, st));
  return static_cast<int>(err);
}

// The reverse walk: r (NH, DH, 4, DH), saved (B, S, NH, 7, DH) as
// slstm_fwd_f32 wrote it, dy (B, S, NH, DH), state_in the packed state the
// forward started from or null -> dwx (B, S, NH, 4, DH), the gate preacts'
// gradient; all contiguous fp32, DH 32, 64 or 128. Returns 0 on success,
// else the CUDA error code.
int slstm_bwd_f32(const float* r, const float* saved, const float* dy, const float* state_in,
                  float* dwx, int B, int S, int NH, int DH, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || NH <= 0 || NH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{r, saved, dy, state_in, dwx, B, S, NH};
  return static_cast<int>(launch_bwd(a, DH, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
