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
// gradients up to rounding). It writes draw = dwx (B, S, NH, 4, DH), each
// chain's sum of draw over t (the wrapper sums those over B into db; no
// float atomics) and the initial state's gradient; dr = sum y_{t-1}^T draw
// is left to the wrapper (products over views), as the JAX package
// leaves it to XLA.
//
// A carried state, both ways. The gradient of the returned last state
// (dy, dc, dn, dm), `dlast`, seeds the walk: dy joins step S-1's, (dc, dn)
// start the carries. The function depends on a stabilized state (c, n, m)
// only through c e^m and n e^m, so the frozen walk is exact for every
// cotangent except the part of dm that is not dc c + dn n: that part,
// delta = dm - dc c - dn n, follows the stabilizer's max chain back, step
// by step: where the input gate won the max (i_raw >= logsigmoid(f_raw) +
// m_{t-1}) it joins d i_raw and stops, else it joins d logsigmoid(f_raw)
// and goes on to m_{t-1}. At t = 0 the kernel writes `dstate`, the gradient
// of the initial (y, c, n, m): R draw_0, the carries, and dc c0 + dn n0 +
// what is left of delta.
//
// What bounds the backward: like the forward, the chain, S steps in order,
// each a product of depth 4 DH (R's rows against the four gates' draw) and
// the step's update. Its bytes (the workspace and dy, 8 DH floats a step
// in, dwx 4 DH out) are far below the card's rate at any batch the LM runs.
// So the design takes everything it can off the chain:
//   Coefficient form. Every factor of a step that does not depend on the
//   carried gradient comes from the workspace alone: a = so / n, bn = so c
//   / n^2, fg and ig (from the same intrinsics on the same operands as the
//   forward's cell(), so bit-identical to it), and per gate q a triple
//   (alpha_q, beta_q, gamma_q) with delta's factor (slstm_bwd_coefficients
//   in kernels/slstm.py is the same algebra in torch). The chain is then
//     dyt = dy_t + R draw_{t+1},  dct = dc + a dyt,  dnt = dn - bn dyt,
//     draw_q = alpha_q dct + beta_q dnt + gamma_q dyt + dgate_q delta,
//     dc, dn, delta = fg dct, fg dnt, keep delta
//   multiply-adds only: no division, transcendental or branch on the gate.
//   Warp specialization. Four producer warps, a step each in turn, stage
//   each step's workspace row (7 DH contiguous floats), its dy row and the
//   previous step's (c, n, m) with 1-D bulk copies on an mbarrier, RAW steps
//   ahead, and compute the coefficients CR steps ahead into a shared ring
//   with full and empty mbarriers. Consumer threads wait
//   on a step's full barrier, release its slot as soon as the coefficients
//   are in registers, and exchange draw among themselves on a named barrier
//   (bar.sync 1), which the producers never stand in.
//   Few shared-memory bytes a step. Each step every consumer reads its
//   slice of draw from shared memory, and those reads, more than the
//   multiply-adds, set the pace (a thread that held one row of R read DH
//   floats a step for DH multiply-adds). So a group of 16 lanes holds the
//   rows of R of four channels: lane l takes one gate and one slice of each
//   row (every fourth float4), reads that slice of draw once and uses it for
//   all four channels; a reduce-scatter by shuffles (2 + 1 + 2) then leaves
//   each lane the whole sum of one channel, and the four lanes of a channel
//   run its update, one gate each, so y's gradient never goes through
//   shared memory; draw does, double-buffered by step parity, padded so that
//   a quarter-warp's float4 reads fall in distinct banks. The step's
//   coefficients are read while the products are in flight. DH 32 and 64:
//   one CTA of 4 DH consumer threads per chain. DH 128: R's rows are 256 KB,
//   so a cluster of two CTAs holds them, each the rows of its 64 channels
//   (128 floats of R a thread), and each sends its channels' draw to the
//   other's shared memory with st.async on an mbarrier. A CTA starts a
//   step's products on its own channels' draw and waits for the other
//   CTA's only then, so the exchange overlaps half of the products.

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
  const float* saved;     // (B, S, NH, SAVED, DH), as the forward wrote it; 16-byte aligned
  const float* dy;        // (B, S, NH, DH), 16-byte aligned
  const float* state_in;  // (4, B, NH, DH) or null: the state before step 0
  const float* dlast;     // (4, B, NH, DH) or null: the last state's (dy, dc, dn, dm)
  float* dwx;             // (B, S, NH, 4, DH)
  float* dbp;             // (B, NH, 4, DH): each chain's sum of dwx over t
  float* dstate;          // (4, B, NH, DH) or null: out, the initial state's (dy, dc, dn, dm)
  int B, S, NH;
};

// Rows of one step's coefficients: the channel's (dy, a, bn, fg, keep), then
// per gate (alpha, beta, gamma, dgate).
constexpr int CCH = 5, CG = 4;

// The layout of the reverse-time kernel for head dim DH and NC CTAs a chain
// (a CTA owns DC = DH / NC channels, all four gates).
template <int DH, int NC>
struct BwdShape {
  static constexpr int DC = DH / NC;                // channels a CTA
  static constexpr int CH = 4, LOG_CH = 2;          // channels whose rows of R a consumer holds
  static constexpr int LANES = 16;                  // consumer lanes of CH channels
  static constexpr int SP = LANES / 4;              // slices of a gate's row, one a lane
  static constexpr int E = DH / SP;                 // floats of a slice: every SP-th float4
  static constexpr int NCONS = DC / CH * LANES;     // consumer threads
  static constexpr int NPW = 4;                     // producer warps, a step each in turn
  static constexpr int NTHR = NCONS + 32 * NPW;
  static constexpr int RAW = 16;                    // steps of workspace and dy staged ahead
  static constexpr int CR = 8;                      // steps of coefficients computed ahead
  static constexpr int W = 11 * DH;                 // floats of a staged step: its saved row,
                                                    // dy, then the (c, n, m) of the step before
  static constexpr int GS = CG * DC + 8;            // a gate's coefficients, padded so that the
                                                    // gates of 8 channels fall in distinct banks
  static constexpr int CW = CCH * DC + 4 * GS;      // floats of a step's coefficients
  static constexpr int DP = DH + 16;                // padded row of the draw buffer: the 8
                                                    // float4s a quarter-warp reads, distinct banks
  // dynamic shared memory, in floats: the staged steps, the coefficients,
  // draw of every channel by step parity
  static constexpr int COEF_OFF = RAW * W, DRS_OFF = COEF_OFF + CR * CW,
                       FLOATS = DRS_OFF + 2 * 4 * DP;
  static constexpr unsigned BYTES = sizeof(float) * FLOATS;
  // the draw a CTA receives from the others each step
  static constexpr unsigned DBYTES = sizeof(float) * 4 * (DH - DC);
  static_assert(E % 4 == 0 && (E / 4) % NC == 0, "whole float4 slices, a part per CTA");
  static_assert(RAW % NPW == 0 && CR % NPW == 0, "a producer warp owns its steps' slots");
};

// The products of float4 chunks K0 .. K1 - 1 of a lane's slice of R's rows
// with the same chunks of draw (dp: the lane's first chunk of its gate's row).
template <int K0, int K1, int CH, int SP, int E>
__device__ __forceinline__ void dot_chunks(const float* dp, const float (&rr)[CH][E],
                                           float (&acc)[CH]) {
#pragma unroll
  for (int k = K0; k < K1; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(dp + 4 * k * SP);
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      acc[j] = fmaf(v.x, rr[j][4 * k], acc[j]);
      acc[j] = fmaf(v.y, rr[j][4 * k + 1], acc[j]);
      acc[j] = fmaf(v.z, rr[j][4 * k + 2], acc[j]);
      acc[j] = fmaf(v.w, rr[j][4 * k + 3], acc[j]);
    }
  }
}

template <int DH, int NC>
__global__ void __launch_bounds__(BwdShape<DH, NC>::NTHR, 1) slstm_bwd_ws(BwdArgs a) {
  using Sh = BwdShape<DH, NC>;
  constexpr int DC = Sh::DC, CH = Sh::CH, SP = Sh::SP, E = Sh::E, NCONS = Sh::NCONS;
  constexpr int NPW = Sh::NPW;
  constexpr int RAW = Sh::RAW, CR = Sh::CR, W = Sh::W, GS = Sh::GS, CW = Sh::CW, DP = Sh::DP;
  constexpr int L = Sh::LOG_CH;
  extern __shared__ __align__(128) float sm[];
  float* raw = sm;
  float* coef = sm + Sh::COEF_OFF;
  float* drs = sm + Sh::DRS_OFF;
  __shared__ __align__(8) uint64_t rawfull[RAW], cfull[CR], cempty[CR], dfull[2];
  const int rank = NC > 1 ? (int)tile::cluster_rank() : 0;
  const int b = blockIdx.y, h = blockIdx.z, tid = threadIdx.x, S = a.S, NH = a.NH;
  const size_t plane = (size_t)a.B * NH * DH, base = ((size_t)b * NH + h) * DH + rank * DC;
  const size_t chain = (size_t)b * S * NH + h;  // (b, t = 0, h) in units of one (b, t, h) row

  if (tid == 0) {
    for (int i = 0; i < RAW; ++i) tile::mbar_init(&rawfull[i], 1);
    for (int i = 0; i < CR; ++i) {
      tile::mbar_init(&cfull[i], 32);
      tile::mbar_init(&cempty[i], NCONS / 32);
    }
    tile::mbar_init(&dfull[0], 1);
    tile::mbar_init(&dfull[1], 1);
    tile::mbar_init_fence();
    if (NC > 1) {
      tile::mbar_expect_tx(&dfull[0], Sh::DBYTES);
      tile::mbar_expect_tx(&dfull[1], Sh::DBYTES);
    }
  }
  for (int i = tid; i < 2 * 4 * DP; i += Sh::NTHR) drs[i] = 0.f;  // draw_S = 0
  // the coefficients that are zero by the gate's algebra stay as set here
  for (int i = tid; i < CR * CW; i += Sh::NTHR) coef[i] = 0.f;
  if (NC > 1) tile::cluster_sync();  // the peers' barriers are set
  else __syncthreads();

  if (tid >= NCONS) {
    // ---- producers: stage the steps, compute their coefficients ----
    // Warp w takes steps it = w, w + NPW, ... and alone uses their slots of
    // both rings, so the producer warps never wait for each other and their
    // steps' latencies overlap. Channels: this CTA's, dl = 0 .. DC - 1.
    const int w = (tid - NCONS) / 32, lane = tid & 31;
    const float* srow = a.saved + chain * SAVED * DH;
    const float* drow = a.dy + chain * DH;
    auto issue = [&](int it) {  // step t = S - 1 - it into slot it % RAW
      const size_t t = S - 1 - it;
      float* dst = raw + (it % RAW) * W;
      uint64_t* bar = &rawfull[it % RAW];
      tile::mbar_expect_tx(bar, sizeof(float) * (t > 0 ? 11 : 8) * DH);
      tile::bulk_load(dst, srow + t * NH * SAVED * DH, sizeof(float) * SAVED * DH, bar);
      tile::bulk_load(dst + SAVED * DH, drow + t * NH * DH, sizeof(float) * DH, bar);
      if (t > 0)  // the (c, n, m) of step t - 1
        tile::bulk_load(dst + 8 * DH, srow + (t - 1) * NH * SAVED * DH + 4 * DH,
                        sizeof(float) * 3 * DH, bar);
    };
    if (lane == 0)
      for (int it = w; it < RAW && it < S; it += NPW) issue(it);
    for (int it = w; it < S; it += NPW) {
      const int cs = it % CR;
      const bool first = it == S - 1;  // step 0: the previous state is the initial one
      tile::mbar_wait(&rawfull[it % RAW], (it / RAW) & 1);
      tile::mbar_wait(&cempty[cs], ((it / CR) & 1) ^ 1);
      const float* cur = raw + (it % RAW) * W + rank * DC;
      float* cf = coef + cs * CW;
#pragma unroll
      for (int dl = lane; dl < DC; dl += 32) {
        const float i = cur[dl], lsf = cur[DH + dl], tz = cur[2 * DH + dl], so = cur[3 * DH + dl];
        const float c = cur[4 * DH + dl], n = cur[5 * DH + dl], m = cur[6 * DH + dl];
        float cp = 0.f, np_ = 0.f, mp = NEG_INIT, dyv = cur[7 * DH + dl];
        if (!first) {
          cp = cur[8 * DH + dl];
          np_ = cur[9 * DH + dl];
          mp = cur[10 * DH + dl];
        } else if (a.state_in) {
          cp = a.state_in[plane + base + dl];
          np_ = a.state_in[2 * plane + base + dl];
          mp = a.state_in[3 * plane + base + dl];
        }
        if (it == 0 && a.dlast) dyv += a.dlast[base + dl];
        const float ig = __expf(i - m), fg = __expf((mp + lsf) - m);  // as the forward's cell()
        const bool ib = i >= mp + lsf;  // the input gate won the stabilizer's max
        const float inv_n = __fdividef(1.f, n), hn = c * inv_n;
        const float sig = -expm1f(lsf);  // sigmoid(-f) = 1 - exp(logsigmoid(f))
        cf[dl] = dyv;
        cf[DC + dl] = so * inv_n;
        cf[2 * DC + dl] = so * hn * inv_n;
        cf[3 * DC + dl] = fg;
        cf[4 * DC + dl] = ib ? 0.f : 1.f;
        // per gate (i, f, z, o) its (alpha, beta, gamma, dgate), the others zero:
        // i (tz ig, ig, 0, ib), f (c_{t-1} fg sig, n_{t-1} fg sig, 0, !ib sig),
        // z (ig (1 - tz^2), 0, 0, 0), o (0, 0, (c / n) so (1 - so), 0)
        float* g = cf + CCH * DC + dl;
        g[0] = tz * ig;
        g[DC] = ig;
        g[3 * DC] = ib ? 1.f : 0.f;
        g[GS] = cp * fg * sig;
        g[GS + DC] = np_ * fg * sig;
        g[GS + 3 * DC] = ib ? 0.f : sig;
        g[2 * GS] = ig * (1.f - tz * tz);
        g[3 * GS + 2 * DC] = hn * so * (1.f - so);
      }
      tile::mbar_arrive(&cfull[cs]);
      __syncwarp();  // the warp is past its reads of slot it % RAW: refill it
      if (lane == 0 && it + RAW < S) issue(it + RAW);
    }
  } else {
    // ---- consumers: the chain ----
    // A group of 16 lanes holds R's rows of CH of this CTA's channels. For
    // the dot, lane l takes gate qq = l / SP and slice s = l % SP of those
    // rows (CH x E floats of R), reads that slice of draw once and uses it
    // for the CH channels; a reduce-scatter by shuffles then leaves lane l
    // the whole sum of channel dl = CH grp + c. For the update, lane l takes
    // gate pq = l / CH of channel dl.
    const int l = tid & 15, grp = tid >> 4;
    const int qq = l / SP, s = l % SP;
    int c = 0;
#pragma unroll
    for (int lev = 0; lev < L; ++lev) c += ((l >> lev) & 1) * (CH >> (lev + 1));
    const int dl = grp * CH + c, d = rank * DC + dl, pq = l >> L;
    constexpr int KV = E / 4, KH = KV / NC;  // float4s of a slice; of them, a CTA's channels
    float rr[CH][E];  // R[h][rank DC + CH grp + j][qq][4 (k SP + s) + i]
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const float4* rh = reinterpret_cast<const float4*>(
          a.r + (((size_t)h * DH + rank * DC + grp * CH + j) * 4 + qq) * DH);
#pragma unroll
      for (int k = 0; k < KV; ++k) {
        const float4 v = rh[k * SP + s];
        rr[j][4 * k] = v.x;
        rr[j][4 * k + 1] = v.y;
        rr[j][4 * k + 2] = v.z;
        rr[j][4 * k + 3] = v.w;
      }
    }
    // the carries into step t, channel d (alike in the channel's lanes), and
    // the part of the last state's dm that follows the stabilizer's max chain
    float dc = 0.f, dn = 0.f, delta = 0.f, gsum = 0.f;
    if (a.dlast) {
      dc = a.dlast[plane + base + dl];
      dn = a.dlast[2 * plane + base + dl];
      const float* last = a.saved + (chain + (size_t)(S - 1) * NH) * SAVED * DH + d;
      delta = a.dlast[3 * plane + base + dl] - dc * last[4 * DH] - dn * last[5 * DH];
    }
    // where this lane's draw goes in the other CTAs (NC > 1), by step parity
    uint32_t ddst[NC], dbar[NC][2];
    if (NC > 1) {
#pragma unroll
      for (int r = 0; r < NC; ++r) {
        ddst[r] = tile::cluster_u32(&drs[pq * DP + d], r);
        dbar[r][0] = tile::cluster_u32(&dfull[0], r);
        dbar[r][1] = tile::cluster_u32(&dfull[1], r);
      }
    }
    // the recurrent part of y's gradient at iteration it, R[d, :, :] .
    // draw_{t+1}: this lane's products, own channels' draw first, the other
    // CTA's once it is in; then their sum over the group for channel d
    float acc[CH];
    auto dot = [&](int it) {
      const float* dp = drs + (((it & 1) ^ 1) * 4 + qq) * DP + 4 * s;
#pragma unroll
      for (int j = 0; j < CH; ++j) acc[j] = 0.f;
      if (NC == 1) {
        dot_chunks<0, KV, CH, SP, E>(dp, rr, acc);
        return;
      }
      const int p = (it - 1) & 1;  // the parity the other CTA's draw_{t+1} came in on
      if (rank == 0) dot_chunks<0, KH, CH, SP, E>(dp, rr, acc);
      else dot_chunks<KH, KV, CH, SP, E>(dp, rr, acc);
      if (it > 0) {
        tile::mbar_wait(&dfull[p], ((it - 1) >> 1) & 1);
        if (tid == 0) tile::mbar_expect_tx(&dfull[p], Sh::DBYTES);  // re-arm for it + 2
      }
      if (rank == 0) dot_chunks<KH, KV, CH, SP, E>(dp, rr, acc);
      else dot_chunks<0, KH, CH, SP, E>(dp, rr, acc);
    };
    auto gather = [&]() {
      // reduce-scatter over the group: level lev halves the channels a lane
      // holds (bit lev of l keeps the upper half), then the lanes that hold
      // the same channel sum
#pragma unroll
      for (int lev = 0, half = CH / 2; half >= 1; ++lev, half /= 2) {
        const bool up = (l >> lev) & 1;
#pragma unroll
        for (int i = 0; i < half; ++i) {
          const float give = up ? acc[i] : acc[i + half];
          acc[i] = (up ? acc[i + half] : acc[i]) + __shfl_xor_sync(0xffffffffu, give, 1 << lev);
        }
      }
      float part = acc[0];
#pragma unroll
      for (int o = CH; o < 16; o <<= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      return part;
    };
    float* out = a.dwx + chain * 4 * DH + pq * DH + d;
    for (int it = 0; it < S; ++it) {
      const int t = S - 1 - it, par = it & 1, cs = it % CR;
      dot(it);
      // the step's coefficients, while the products are in flight
      tile::mbar_wait(&cfull[cs], (it / CR) & 1);
      const float* cf = coef + cs * CW + dl;
      const float cdy = cf[0], ca = cf[DC], cbn = cf[2 * DC], cfg = cf[3 * DC], ckeep = cf[4 * DC];
      const float* cg = cf + CCH * DC + pq * GS;
      const float al = cg[0], be = cg[DC], ga = cg[2 * DC], de = cg[3 * DC];
      const float dyt = cdy + gather();
      const float dct = dc + ca * dyt, dnt = dn - cbn * dyt;
      const float g = al * dct + be * dnt + ga * dyt + de * delta;
      dc = cfg * dct;
      dn = cfg * dnt;
      delta *= ckeep;
      drs[(par * 4 + pq) * DP + d] = g;
      if (NC > 1) {
#pragma unroll
        for (int r = 0; r < NC; ++r)
          if (r != rank) tile::st_async(ddst[r] + par * 4 * DP * 4, g, dbar[r][par]);
      }
      out[(size_t)t * NH * 4 * DH] = g;
      gsum += g;
      __syncwarp();
      if ((tid & 31) == 0) tile::mbar_arrive(&cempty[cs]);  // the warp is done with the slot
      tile::named_sync(1, NCONS);  // drs[par] holds this CTA's part of this step's draw
    }
    dot(S);
    const float dy0 = gather();  // R draw_0: the gradient of the initial y
    a.dbp[(((size_t)b * NH + h) * 4 + pq) * DH + d] = gsum;
    if (a.dstate && pq == 0) {
      const float c0 = a.state_in ? a.state_in[plane + base + dl] : 0.f;
      const float n0 = a.state_in ? a.state_in[2 * plane + base + dl] : 0.f;
      a.dstate[base + dl] = dy0;
      a.dstate[plane + base + dl] = dc;
      a.dstate[2 * plane + base + dl] = dn;
      a.dstate[3 * plane + base + dl] = dc * c0 + dn * n0 + delta;
    }
  }
  if (NC > 1) tile::cluster_sync();  // no CTA leaves while a peer's st.async may target it
}

template <int DH, int NC>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t st) {
  using Sh = BwdShape<DH, NC>;
  auto kernel = slstm_bwd_ws<DH, NC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::BYTES);
  if (err != cudaSuccess) return err;
  if (NC == 1) {
    kernel<<<dim3(1, a.B, a.NH), Sh::NTHR, Sh::BYTES, st>>>(a);
    return cudaGetLastError();
  }
  return tile::launch_cluster(kernel, dim3(NC, a.B, a.NH), dim3(Sh::NTHR), Sh::BYTES, st, NC, a);
}

cudaError_t launch_bwd(const BwdArgs& a, int DH, cudaStream_t st) {
  if (DH == 32) return launch_bwd<32, 1>(a, st);
  if (DH == 64) return launch_bwd<64, 1>(a, st);
  if (DH == 128) return launch_bwd<128, 2>(a, st);
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
// forward started from or null, dlast the packed (4, B, NH, DH) gradient of
// the returned last state (y, c, n, m) or null -> dwx (B, S, NH, 4, DH),
// the gate preacts' gradient, dbp (B, NH, 4, DH), each chain's sum of dwx
// over t, and, when dstate is not null, the gradient of the initial (y, c,
// n, m) into dstate (4, B, NH, DH); all contiguous fp32, saved and dy
// 16-byte aligned, DH 32, 64 or 128. Returns 0 on success, else the CUDA
// error code.
int slstm_bwd_f32(const float* r, const float* saved, const float* dy, const float* state_in,
                  const float* dlast, float* dwx, float* dbp, float* dstate, int B, int S, int NH,
                  int DH, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || NH <= 0 || NH > 65535 ||
      (reinterpret_cast<uintptr_t>(saved) | reinterpret_cast<uintptr_t>(dy)) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{r, saved, dy, state_in, dlast, dwx, dbp, dstate, B, S, NH};
  return static_cast<int>(launch_bwd(a, DH, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
