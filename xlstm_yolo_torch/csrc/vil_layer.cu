// The ViL layer family, forward, for NVIDIA Hopper, fp32, plain C interface:
// the layer-fused (K3), cell-fused (K4), block-fused (K7) and conv-fused (K6)
// functions.
//
// K3 replaces the TPU kernel `_kernel_vil_layer` in
// xlstm_yolo_tpu/kernels/mlstm_pallas.py (entered through
// `mlstm_vil_layer_fused_pallas`). It computes the whole ViLLayer minus the
// depthwise conv: RMSNorm, proj_up (both halves), headwise q/k/v, the i/f
// gate dots, the chunkwise mLSTM, the per-head outnorm, the learnable skip,
// the SiLU(z) output gate, proj_down and the residual. Inputs x (B, S, DIM)
// and conv_act (B, S, INNER) in their natural layout; output (B, S, DIM).
//
// K4 replaces `_kernel_vil_fused` (entry `mlstm_vil_fused_pallas`): the
// cell alone. Headwise q, k from conv_act and v from x_mlstm (both streamed
// in, (B, S, INNER)), the gate dots and the chunkwise mLSTM; output h
// (B, S, INNER) before the outnorm. It is what the layer runs when
// stochastic depth keeps the residual outside the kernel.
//
// K7 replaces `_kernel_vil_block` (entry `mlstm_vil_block_fused_pallas`):
// K4 plus the layer's tail (outnorm, skip, SiLU(z) gate, proj_down,
// residual), with z (B, S, INNER) and the residual x_res (B, S, DIM)
// streamed in. K3 is K7 behind RMSNorm and proj_up.
//
// K6 replaces `_kernel_vil_conv` (entry `mlstm_vil_layer_conv_fused_pallas`):
// K3 plus the 3x3 depthwise conv on the (H, W) token grid and its SiLU,
// all inside: x (B, S = H*W, DIM) is the only activation read and out
// (B, S, DIM) the only one written. The TPU kernel kept a window of the
// sequence with W+1 rows of halo each side in fast memory; a tap reaches
// W+1 tokens away in sequence order (81 at the 80-wide grid), so here the
// head writes x_mlstm to the workspace and the cell prologue reads the nine
// taps back through L2, the zero padding applied to the conv's INPUT (taps
// outside the grid are skipped, which also keeps the edge columns from
// wrapping to the neighbouring image row).
//
// What bounds it on this card: at the ViL-YOLO shapes the layer does
// hundreds of operations per byte of x + conv_act + out, above the ridge of
// the fp32 CUDA cores (67 TFLOP/s over 3.35 TB/s = 20 op/B) and of the
// tensor cores at three TF32 passes (165 TFLOP/s: 49 op/B), so the least
// time is set by operations.
//
// What the design does about it. The TPU kernel walked the sequence in order
// on one core; here the recurrence is split into the chunkwise parallel form
// so that every SM has work even at batch 1, and every product runs on the
// tensor cores through the shared 3xTF32 tile product (tile_mma.cuh, fp32
// accuracy) with operands staged by cp.async in 64 x 64 tiles. Shared memory
// per stage is fixed by its tiles and does not grow with DIM or INNER, so
// every width runs:
//   1. head (K3, K6; one CTA per 64 tokens x 64 columns of proj_up): RMSNorm
//      and proj_up as one GEMM over DIM in double-buffered 64-column slices;
//      rms_scale scales A's columns in the fragment loads and each row's
//      1/rms (its sum of squares gathered from the same slices) scales the
//      accumulators; x_mlstm and z go to the workspace. 70 KB.
//   2. cell prologue (one CTA per 64 tokens x one head): that head's conv_act
//      (K6: its nine taps and SiLU) and x_mlstm, then q, k, v as three 64 x
//      64 x 64 products. Each gate pre-activation dots all 3*INNER channels,
//      so each CTA writes its head's partial dot for all 2*NH gate rows to
//      the workspace (2, NH_src, B*NH, S). 87 KB, two CTAs per SM.
//   3. chunk summaries (one CTA per (chunk, batch*head)): sums the NH_src gate
//      partials in a fixed order (deterministic, no atomics) into the i/f
//      pre-activations, then k^T (g v) and the k sums. 35 KB.
//   4. state scan (one CTA per (batch*head, 256 state entries)): the only
//      sequential part, NS steps of an elementwise update of C, n, m.
//   5. chunk outputs (one CTA per (chunk, batch*head)): the causal q k^T, the
//      intra-chunk E v and the carried-in q C, normalized; for the members
//      with the tail also its elementwise part, once per head and token:
//      y = (outnorm(h) + skip conv_act) silu(z) to the workspace. 71 KB.
//   6. epilogue (K3, K6, K7; one CTA per 64 tokens x 64 columns of DIM): y
//      times proj_down as a GEMM over INNER in double-buffered 64-channel
//      slices; the residual is added at the end. 70 KB.
// Gate math, stabilizers, exp/log, norms and scans stay fp32 on the CUDA
// cores.
//
// Head dim and chunk size are fixed at 64. A sequence that is not a
// multiple of 64 is handled by masking the last chunk: missing positions
// load as zeros with an input-gate log of -1e30, so they add nothing to any
// valid position.

#include <cuda_runtime.h>

#include <math.h>

#include "tile_mma.cuh"

namespace {

using tile::Acc;
using tile::LDS;

constexpr int DH = 64;               // head dim
constexpr int CS = 64;               // chunk length
constexpr int TOK = 64;              // tokens per CTA of the head, cell prologue and epilogue
constexpr int KS = 64;               // the head's slice of DIM per stage
constexpr int NT = tile::THREADS;    // threads per CTA
constexpr int NW = NT / 32;          // warps per CTA
constexpr int TF = tile::FLOATS;     // floats of one 64 x 64 shared tile
constexpr float QS = 0.125f;         // 1 / sqrt(DH)
constexpr float NEG = -1e30f;

struct Params {
  const float* x;     // (B, S, DIM) layer input, K3 and K6
  const float* conv;  // (B, S, INNER) activated conv branch (K6: the workspace's)
  const float* xm;    // (B, S, INNER) x_mlstm: streamed in (K4, K7) or the head's (K3, K6)
  const float* zr;    // (B, S, INNER) output-gate branch the epilogue reads:
                      // the workspace's z (K3, K6) or the streamed one (K7)
  const float* xres;  // (B, S, DIM) residual the epilogue adds: x (K3, K6) or
                      // the streamed one (K7)
  const float* nrm;   // (DIM) rms_scale
  const float* wu;    // (2*INNER, DIM) proj_up's weight, out x in
  const float* bu;    // (2*INNER)
  const float* wq;    // (NH, DH_out, DH_in)
  const float* wk;
  const float* wv;
  const float* bq;    // (INNER)
  const float* bk;
  const float* bv;
  const float* wgi;   // (NH, 3*INNER)
  const float* bgi;   // (NH)
  const float* wgf;
  const float* bgf;
  const float* nsc;   // (INNER) effective outnorm scale
  const float* nbi;   // (INNER)
  const float* skip;  // (INNER)
  const float* wd;    // (DIM, INNER) proj_down's weight, out x in
  const float* bd;    // (DIM)
  float* out;         // (B, S, DIM)
  // workspace
  float* q;           // (B, S, INNER), unscaled
  float* k;
  float* v;
  float* z;           // K3 and K6: the z half of proj_up
  float* xmw;         // K3 and K6: (B, S, INNER) x_mlstm, written by the head
  float* convw;       // K6 only: (B, S, INNER) conv_act, written by the prologue
  const float* wc;    // K6 only: (9, INNER) depthwise taps, [kh*3 + kw][channel]
  const float* bc;    // K6 only: (INNER)
  int H, W;           // K6 only: the token grid, S = H * W
  float* h;           // (B, S, INNER) cell output before outnorm; K4's output
  float* y;           // (B, S, INNER) (outnorm(h) + skip conv) silu(z); K3, K6, K7
  float* gp;          // (2, NH_src, B*NH, S) per-source-head partial gate dots
  float* ig;          // (B*NH, S) gate preacts
  float* fg;
  float* kv;          // (B*NH, NS, DH, DH) chunk summaries
  float* ksum;        // (B*NH, NS, DH)
  float* btot;        // (B*NH, NS)
  float* mloc;        // (B*NH, NS)
  float* cprev;       // (B*NH, NS, DH, DH) carried-in states
  float* nprev;       // (B*NH, NS, DH)
  float* mprev;       // (B*NH, NS)
  int B, S, DIM, INNER, NH, NS, igate_exp;
  float eps, norm_eps, rms_eps;
};

__device__ __forceinline__ float logsigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Inclusive scan (sum, or max when MAX) of a[0..63] in place; called by all
// 32 lanes of one warp. Lane l owns a[2l] and a[2l+1].
template <bool MAX>
__device__ void warp_scan64(float* a) {
  const int l = threadIdx.x & 31;
  const float a0 = a[2 * l], a1 = a[2 * l + 1];
  float inc = MAX ? fmaxf(a0, a1) : a0 + a1;
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, inc, o);
    if (l >= o) inc = MAX ? fmaxf(inc, t) : inc + t;
  }
  float excl = __shfl_up_sync(0xffffffffu, inc, 1);
  if (l == 0) excl = MAX ? NEG : 0.f;
  a[2 * l] = MAX ? fmaxf(excl, a0) : excl + a0;
  a[2 * l + 1] = MAX ? fmaxf(excl, fmaxf(a0, a1)) : excl + a0 + a1;
}

// 1. Head: RMSNorm and proj_up for 64 tokens x 64 output columns.
__global__ void __launch_bounds__(NT) vil_head(Params p) {
  extern __shared__ __align__(16) float sm[];  // per stage: x rows, then proj_up's rows
  __shared__ float ns[2][KS];                  // rms_scale's slice per stage
  __shared__ float rinv[TOK];
  const int DIM = p.DIM, INNER = p.INNER, tid = threadIdx.x;
  const long ntok = (long)p.B * p.S, tok0 = (long)blockIdx.x * TOK;
  const int c0 = blockIdx.y * tile::T;  // first output column, of 2*INNER
  const int nrows = (int)(ntok - tok0 < TOK ? ntok - tok0 : TOK);
  const float* xsrc = p.x + tok0 * DIM;
  const float* wsrc = p.wu + (long)c0 * DIM;
  const int nk = (DIM + KS - 1) / KS;

  auto stage = [&](int buf, int k0) {
    float* xb = sm + buf * 2 * TF;
    tile::load_async<TOK, KS>(xb, LDS, xsrc + k0, DIM, nrows, DIM - k0);
    tile::load_async<TOK, KS>(xb + TF, LDS, wsrc + k0, DIM, TOK, DIM - k0);
    if (tid < KS) ns[buf][tid] = k0 + tid < DIM ? p.nrm[k0 + tid] : 0.f;
    tile::cp_async_commit();
  };

  Acc acc;
  acc.zero();
  float ss = 0.f;  // sum of squares of row tid/4 over this thread's quarter of each slice
  stage(0, 0);
  for (int i = 0; i < nk; ++i) {
    const int buf = i & 1;
    if (i + 1 < nk) {
      stage(buf ^ 1, (i + 1) * KS);
      tile::cp_async_wait_one();
    } else {
      tile::cp_async_wait_all();
    }
    __syncthreads();
    const float* xb = sm + buf * 2 * TF;
    const float* xr = xb + (tid >> 2) * LDS + (KS / 4) * (tid & 3);
#pragma unroll
    for (int c = 0; c < KS / 4; ++c) ss += xr[c] * xr[c];
    tile::mma<false, true>(acc, xb, LDS, xb + TF, LDS, KS, ns[buf]);
    __syncthreads();
  }
  ss = tile::quad_sum(ss);
  if ((tid & 3) == 0) rinv[tid >> 2] = rsqrtf(ss / DIM + p.rms_eps);
  __syncthreads();

  const bool xm_half = c0 < INNER;
  float* dst = xm_half ? p.xmw + c0 : p.z + (c0 - INNER);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 2 * hh, row = Acc::row(r), col = Acc::col(j, r);
      if (tok0 + row < ntok)
        *reinterpret_cast<float2*>(dst + (tok0 + row) * INNER + col) =
            make_float2(acc.c[j][r] * rinv[row] + p.bu[c0 + col],
                        acc.c[j][r + 1] * rinv[row] + p.bu[c0 + col + 1]);
    }
}

// K6: conv_act of 64 tokens x head n's channels from x_mlstm in the
// workspace: the nine taps on the (H, W) grid (a tap outside it adds
// nothing), bias, SiLU; to the workspace and to the shared tile cv.
__device__ void conv_tile(const Params& p, float* cv, int n, long tok0, long ntok) {
  const int INNER = p.INNER, H = p.H, W = p.W;
  for (int i = threadIdx.x; i < TOK * DH; i += NT) {
    const int r = i / DH, cl = i % DH, c = n * DH + cl;
    const long tk = tok0 + r;
    float act = 0.f;
    if (tk < ntok) {
      const long b = tk / p.S;
      const int s = (int)(tk % p.S), row = s / W, col = s % W;
      const float* img = p.xm + b * p.S * INNER + c;
      float acc = p.bc[c];
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const int rr = row + kh - 1;
        if (rr < 0 || rr >= H) continue;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int cc = col + kw - 1;
          if (cc < 0 || cc >= W) continue;
          acc += img[(long)(rr * W + cc) * INNER] * p.wc[(kh * 3 + kw) * INNER + c];
        }
      }
      act = silu(acc);
      p.convw[tk * INNER + c] = act;
    }
    cv[r * LDS + cl] = act;
  }
}

// Starts the copy of rows r0 .. r0+63 of the stacked gate kernels (rows
// 0 .. NH-1 the input gate's, NH .. 2NH-1 the forget gate's, each (3*INNER))
// at columns coff .. coff+63; rows past 2*NH land as zeros.
__device__ void load_gate_rows(const Params& p, float* dst, int r0, int coff) {
  const long ld = 3L * p.INNER;
  const int NH = p.NH;
  const bool vec = (ld & 3) == 0 && (coff & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(p.wgi) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(p.wgf) & 15) == 0;
  const int per = vec ? DH / 4 : DH;  // copies per row
  for (int i = threadIdx.x; i < tile::T * per; i += NT) {
    const int r = i / per, c = (vec ? 4 : 1) * (i % per), rr = r0 + r;
    const float* src = rr < NH ? p.wgi + rr * ld : rr < 2 * NH ? p.wgf + (rr - NH) * ld : nullptr;
    if (vec)
      tile::cp_async16(dst + r * LDS + c, src ? src + coff + c : p.wgi, src ? 16 : 0);
    else
      tile::cp_async4(dst + r * LDS + c, src ? src + coff + c : p.wgi, src ? 4 : 0);
  }
}

// Adds the bias to a headwise product, keeps it in the shared tile and
// writes the token rows that exist to the workspace.
__device__ __forceinline__ void put_headwise(const Acc& a, const float* bias, float* tile_,
                                             float* dst, long tok0, long ntok, int INNER) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 2 * hh, row = Acc::row(r), col = Acc::col(j, r);
      const float2 v = make_float2(a.c[j][r] + bias[col], a.c[j][r + 1] + bias[col + 1]);
      *reinterpret_cast<float2*>(tile_ + row * LDS + col) = v;
      if (tok0 + row < ntok) *reinterpret_cast<float2*>(dst + (tok0 + row) * INNER + col) = v;
    }
}

// 2. Cell prologue for 64 tokens and head n: headwise q/k/v and the head's
// partial gate dots. CONV (K6) computes conv_act from the workspace's
// x_mlstm first; the others stream it in.
template <bool CONV>
__global__ void __launch_bounds__(NT, 2) vil_cell_prologue(Params p) {
  extern __shared__ __align__(16) float sm[];
  float* t0 = sm;           // conv_act, then q
  float* t1 = t0 + TF;      // x_mlstm, then k
  float* t2 = t1 + TF;      // wq, then v
  float* t3 = t2 + TF;      // wk, then gate rows
  float* t4 = t3 + TF;      // wv, then gate rows
  const int n = blockIdx.y, INNER = p.INNER, NH = p.NH;
  const long ntok = (long)p.B * p.S, tok0 = (long)blockIdx.x * TOK;
  const int nrows = (int)(ntok - tok0 < TOK ? ntok - tok0 : TOK);
  const long hoff = tok0 * INNER + (long)n * DH;
  const long woff = (long)n * DH * DH;
  if (!CONV) tile::load_async<TOK, DH>(t0, LDS, p.conv + hoff, INNER, nrows, DH);
  tile::load_async<TOK, DH>(t1, LDS, p.xm + hoff, INNER, nrows, DH);
  tile::load_async<DH, DH>(t2, LDS, p.wq + woff, DH, DH, DH);
  tile::load_async<DH, DH>(t3, LDS, p.wk + woff, DH, DH, DH);
  tile::load_async<DH, DH>(t4, LDS, p.wv + woff, DH, DH, DH);
  tile::cp_async_commit();
  if (CONV) conv_tile(p, t0, n, tok0, ntok);
  tile::cp_async_wait_all();
  __syncthreads();

  {
    Acc aq, ak, av;
    aq.zero();
    ak.zero();
    av.zero();
    tile::mma<false, true>(aq, t0, LDS, t2, LDS, DH);
    tile::mma<false, true>(ak, t0, LDS, t3, LDS, DH);
    tile::mma<false, true>(av, t1, LDS, t4, LDS, DH);
    __syncthreads();
    put_headwise(aq, p.bq + n * DH, t0, p.q + n * DH, tok0, ntok, INNER);
    put_headwise(ak, p.bk + n * DH, t1, p.k + n * DH, tok0, ntok, INNER);
    put_headwise(av, p.bv + n * DH, t2, p.v + n * DH, tok0, ntok, INNER);
  }

  // this head's share of every gate pre-activation: cat(q, k, v)[:, head n]
  // against the matching columns of all 2*NH gate rows, 64 rows at a time
  const long stride = (long)p.B * NH * p.S;  // one source head's partials
  for (int r0 = 0; r0 < 2 * NH; r0 += tile::T) {
    load_gate_rows(p, t3, r0, n * DH);
    load_gate_rows(p, t4, r0, INNER + n * DH);
    tile::cp_async_commit();
    tile::cp_async_wait_all();
    __syncthreads();
    Acc ag;
    ag.zero();
    tile::mma<false, true>(ag, t0, LDS, t3, LDS, DH);
    tile::mma<false, true>(ag, t1, LDS, t4, LDS, DH);
    __syncthreads();
    load_gate_rows(p, t3, r0, 2 * INNER + n * DH);
    tile::cp_async_commit();
    tile::cp_async_wait_all();
    __syncthreads();
    tile::mma<false, true>(ag, t2, LDS, t3, LDS, DH);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int hc = r0 + Acc::col(j, r);
        const long tk = tok0 + Acc::row(r);
        if (hc < 2 * NH && tk < ntok) {
          const int which = hc >= NH, hh = hc - which * NH;
          const long b = tk / p.S, s = tk % p.S;
          p.gp[((long)which * NH + n) * stride + (b * NH + hh) * p.S + s] = ag.c[j][r];
        }
      }
    __syncthreads();
  }
}

// The i/f pre-activations of chunk positions s0 .. s0+63 of row bh = b*NH +
// hh: bias plus the NH source heads' partials, summed in order; written to
// ig/fg for the later stages and the backward, and returned as gate logs
// lf (log forget, 0 where masked) and li (log input, NEG where masked).
__device__ void sum_gates(const Params& p, int bh, int hh, int s0, float* lf, float* li) {
  const int tid = threadIdx.x;
  if (tid < 2 * CS) {
    const int which = tid >= CS, i = tid - which * CS, s = s0 + i;
    const bool ok = s < p.S;
    float pre = 0.f;
    if (ok) {
      const long stride = (long)p.B * p.NH * p.S;
      const float* src = p.gp + (long)which * p.NH * stride + (long)bh * p.S + s;
      pre = which ? p.bgf[hh] : p.bgi[hh];
      for (int n = 0; n < p.NH; ++n) pre += src[n * stride];
      (which ? p.fg : p.ig)[(long)bh * p.S + s] = pre;
    }
    if (which)
      lf[i] = ok ? logsigmoid(pre) : 0.f;
    else
      li[i] = ok ? (p.igate_exp ? pre : logsigmoid(pre)) : NEG;
  }
}

// Chunk j's gate logs of row bh from ig/fg: lf (log forget), li (log
// input, NEG where masked).
__device__ __forceinline__ void load_gates(const Params& p, int bh, int s0, float* lf,
                                           float* li) {
  const int tid = threadIdx.x;
  if (tid < CS) {
    const int s = s0 + tid;
    const bool ok = s < p.S;
    const float fp = ok ? p.fg[(long)bh * p.S + s] : 0.f;
    const float ip = ok ? p.ig[(long)bh * p.S + s] : 0.f;
    lf[tid] = ok ? logsigmoid(fp) : 0.f;
    li[tid] = ok ? (p.igate_exp ? ip : logsigmoid(ip)) : NEG;
  }
}

// 3. Per-chunk state summaries.
__global__ void __launch_bounds__(NT) vil_chunk_summary(Params p) {
  __shared__ __align__(16) float ks[TF];
  __shared__ __align__(16) float vs[TF];
  __shared__ float bcs[CS], li[CS], gw[CS];
  __shared__ float s_mloc;
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / p.NH, n = bh % p.NH;
  const int tid = threadIdx.x, s0 = j * CS;
  const int nrows = p.S - s0 < CS ? p.S - s0 : CS;
  const long hoff = ((long)b * p.S + s0) * p.INNER + (long)n * DH;

  tile::load_async<CS, DH>(ks, LDS, p.k + hoff, p.INNER, nrows, DH);
  tile::load_async<CS, DH>(vs, LDS, p.v + hoff, p.INNER, nrows, DH);
  tile::cp_async_commit();
  sum_gates(p, bh, n, s0, bcs, li);
  tile::cp_async_wait_all();
  __syncthreads();
  if (tid < 32) warp_scan64<false>(bcs);  // b = inclusive cumsum of log f
  __syncthreads();
  const float btot = bcs[CS - 1];
  if (tid < CS) gw[tid] = li[tid] + (btot - bcs[tid]);
  __syncthreads();
  if (tid < 32) {
    float m = fmaxf(gw[tid], gw[tid + 32]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (tid == 0) s_mloc = m;
  }
  __syncthreads();
  const float mloc = s_mloc;
  if (tid < CS) gw[tid] = expf(gw[tid] - mloc);
  __syncthreads();
  for (int i = tid; i < CS * DH; i += NT) vs[(i / DH) * LDS + i % DH] *= gw[i / DH];
  __syncthreads();

  const long base = (long)bh * p.NS + j;
  Acc acc;
  acc.zero();
  tile::mma<true, false>(acc, ks, LDS, vs, LDS, CS);  // k^T (g v): [d][e]
  float* kvo = p.kv + base * DH * DH;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 2 * hh;
      *reinterpret_cast<float2*>(kvo + Acc::row(r) * DH + Acc::col(jj, r)) =
          make_float2(acc.c[jj][r], acc.c[jj][r + 1]);
    }
  if (tid < DH) {
    float s_ = 0.f;
    for (int s = 0; s < CS; ++s) s_ += ks[s * LDS + tid] * gw[s];
    p.ksum[base * DH + tid] = s_;
  }
  if (tid == 0) {
    p.btot[base] = btot;
    p.mloc[base] = mloc;
  }
}

// 4. Sequential scan over chunks: writes the state carried into each chunk.
__global__ void __launch_bounds__(NT) vil_state_scan(Params p) {
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int idx = blockIdx.y * NT + tid;  // entry of C
  const bool own_n = blockIdx.y == 0 && tid < DH;
  const bool own_m = blockIdx.y == 0 && tid == 0;
  const long row = (long)bh * p.NS;
  float c = 0.f, nn = 0.f, m = 0.f;
  float bt = p.btot[row], ml = p.mloc[row], kvv = p.kv[row * DH * DH + idx];
  float ks = own_n ? p.ksum[row * DH + tid] : 0.f;
  for (int j = 0; j < p.NS; ++j) {
    const long base = row + j;
    float nbt = 0.f, nml = 0.f, nkv = 0.f, nks = 0.f;
    if (j + 1 < p.NS) {  // prefetch the next chunk's summary
      nbt = p.btot[base + 1];
      nml = p.mloc[base + 1];
      nkv = p.kv[(base + 1) * DH * DH + idx];
      if (own_n) nks = p.ksum[(base + 1) * DH + tid];
    }
    p.cprev[base * DH * DH + idx] = c;
    if (own_n) p.nprev[base * DH + tid] = nn;
    if (own_m) p.mprev[base] = m;
    const float mn = fmaxf(bt + m, ml);
    const float dold = expf(bt + m - mn), dnew = expf(ml - mn);
    c = c * dold + kvv * dnew;
    nn = nn * dold + ks * dnew;
    m = mn;
    bt = nbt;
    ml = nml;
    kvv = nkv;
    ks = nks;
  }
}

// 5. Per-chunk outputs h = (intra + inter) / normalizer.
__global__ void __launch_bounds__(NT, 3) vil_chunk_output(Params p) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                // q, unscaled
  float* ks = qs + TF;           // k, then E: decayed q k^T / sqrt(DH) (row t, col s)
  float* vs = ks + TF;
  float* Cs = vs + TF;           // carried-in C [d][e]
  float* nv = Cs + TF;           // DH carried-in n
  float* bcs = nv + DH;          // CS cumsum of log f
  float* li = bcs + CS;          // CS log input gate
  float* cm = li + CS;           // CS running max of li - b
  float* stab = cm + CS;         // CS stabilizer
  float* av = stab + CS;         // CS inter-chunk scale
  float* den = av + CS;          // CS normalizer
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / p.NH, n = bh % p.NH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, s0 = j * CS;
  const long base = (long)bh * p.NS + j;
  const int nrows = p.S - s0 < CS ? p.S - s0 : CS;
  const long hoff = ((long)b * p.S + s0) * p.INNER + (long)n * DH;

  tile::load_async<CS, DH>(qs, LDS, p.q + hoff, p.INNER, nrows, DH);
  tile::load_async<CS, DH>(ks, LDS, p.k + hoff, p.INNER, nrows, DH);
  tile::load_async<CS, DH>(vs, LDS, p.v + hoff, p.INNER, nrows, DH);
  tile::load_async<DH, DH>(Cs, LDS, p.cprev + base * DH * DH, DH, DH, DH);
  tile::cp_async_commit();
  load_gates(p, bh, s0, bcs, li);
  if (tid < DH) nv[tid] = p.nprev[base * DH + tid];
  const float m_prev = p.mprev[base];
  tile::cp_async_wait_all();
  __syncthreads();
  if (tid < 32) warp_scan64<false>(bcs);
  __syncthreads();
  if (tid < CS) cm[tid] = li[tid] - bcs[tid];
  __syncthreads();
  if (tid < 32) warp_scan64<true>(cm);
  __syncthreads();
  if (tid < CS) {
    // row max of log D: b_t + max_{s<=t}(li_s - b_s); the stabilizer also
    // covers the carried-in term m_prev + b_t
    const float inter_log = m_prev + bcs[tid];
    const float st = fmaxf(bcs[tid] + cm[tid], inter_log);
    stab[tid] = st;
    av[tid] = expf(inter_log - st);
  }
  __syncthreads();

  {
    Acc s;
    s.zero();
    tile::mma<false, true, tile::OUT_LOWER>(s, qs, LDS, ks, LDS, DH);
    __syncthreads();  // every warp is done with k: E takes its place
    float* E = ks;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = Acc::row(r), c = Acc::col(jj, r);
        E[t * LDS + c] = c <= t ? s.c[jj][r] * QS * expf(li[c] - bcs[c] + bcs[t] - stab[t]) : 0.f;
      }
  }
  __syncthreads();
  const float* E = ks;

  for (int t = warp; t < CS; t += NW) {
    const float es = warp_sum(E[t * LDS + lane] + E[t * LDS + lane + 32]);
    const float qn = QS * warp_sum(qs[t * LDS + lane] * nv[lane] +
                                   qs[t * LDS + lane + 32] * nv[lane + 32]);
    if (lane == 0) den[t] = fmaxf(fabsf(es + av[t] * qn), expf(-stab[t])) + p.eps;
  }
  __syncthreads();

  Acc hv, inter;
  hv.zero();
  inter.zero();
  tile::mma<false, false, tile::K_LE_M>(hv, E, LDS, vs, LDS, CS);
  tile::mma<false, false>(inter, qs, LDS, Cs, LDS, DH);
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = Acc::row(r);
      hv.c[jj][r] = (hv.c[jj][r] + av[t] * QS * inter.c[jj][r]) / den[t];
    }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 2 * hh, t = Acc::row(r);
      if (s0 + t < p.S)
        *reinterpret_cast<float2*>(p.h + ((long)b * p.S + s0 + t) * p.INNER + n * DH +
                                   Acc::col(jj, r)) = make_float2(hv.c[jj][r], hv.c[jj][r + 1]);
    }
  if (p.y == nullptr) return;  // the cell: no tail

  // the tail's elementwise part for this head, once: y = (outnorm(h) + skip
  // conv_act) silu(z), the A operand of the epilogue's proj_down
  __syncthreads();  // every warp is done with C: h takes its place
  tile::store(hv, Cs, LDS);
  __syncthreads();
  for (int t = warp; t < CS; t += NW) {
    if (s0 + t >= p.S) break;  // warp-uniform
    const float* hr = Cs + t * LDS;
    const float a0 = hr[lane], a1 = hr[lane + 32];
    const float mu = warp_sum(a0 + a1) / DH;
    const float d0 = a0 - mu, d1 = a1 - mu;
    const float inv = rsqrtf(warp_sum(d0 * d0 + d1 * d1) / DH + p.norm_eps);
    const long row = ((long)b * p.S + s0 + t) * p.INNER + n * DH;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int cl = lane + 32 * half, c = n * DH + cl;
      const float hn = (half ? d1 : d0) * inv * p.nsc[c] + p.nbi[c];
      p.y[row + cl] = (hn + p.skip[c] * p.conv[row + cl]) * silu(p.zr[row + cl]);
    }
  }
}

// 6. Epilogue for 64 tokens x 64 columns of DIM: y (the chunk outputs'
// tail product) times proj_down's slice, the K loop over heads in
// double-buffered 64-channel slices; then bias and residual.
__global__ void __launch_bounds__(NT, 3) vil_epilogue(Params p) {
  // per stage: y (64 tokens x one head's channels), then proj_down's rows
  // c0 .. c0+63 at the same channels
  extern __shared__ __align__(16) float sm[];
  const int DIM = p.DIM, INNER = p.INNER;
  const long ntok = (long)p.B * p.S, tok0 = (long)blockIdx.x * TOK;
  const int c0 = blockIdx.y * tile::T;
  const int nrows = (int)(ntok - tok0 < TOK ? ntok - tok0 : TOK);
  const int ncols = DIM - c0 < tile::T ? DIM - c0 : tile::T;
  auto stage = [&](int buf, int n) {
    float* yb = sm + buf * 2 * TF;
    tile::load_async<TOK, DH>(yb, LDS, p.y + tok0 * INNER + n * DH, INNER, nrows, DH);
    tile::load_async<tile::T, DH>(yb + TF, LDS, p.wd + (long)c0 * INNER + n * DH, INNER, ncols,
                                  DH);
    tile::cp_async_commit();
  };

  Acc acc;
  acc.zero();
  stage(0, 0);
  for (int n = 0; n < p.NH; ++n) {
    const int buf = n & 1;
    if (n + 1 < p.NH) {
      stage(buf ^ 1, n + 1);
      tile::cp_async_wait_one();
    } else {
      tile::cp_async_wait_all();
    }
    __syncthreads();
    const float* yb = sm + buf * 2 * TF;
    tile::mma<false, true>(acc, yb, LDS, yb + TF, LDS, DH);
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = Acc::row(r), c = c0 + Acc::col(j, r);
      const long tk = tok0 + t;
      if (tk < ntok && c < DIM) p.out[tk * DIM + c] = acc.c[j][r] + p.bd[c] + p.xres[tk * DIM + c];
    }
}

// Which function of the family a call computes.
enum Kind { LAYER = 0, CELL = 1, BLOCK = 2, CONV = 3 };

// The workspace's arrays, in this order, with their sizes in floats; the
// backward reads q/k/v/h, the gates and the carried-in states from it. z
// and x_mlstm exist for the layer and the conv-fused layer only (the others
// stream them in or have none), the cell writes h to its output instead,
// conv_act exists for the conv-fused layer only, every member has the
// gate partials, and every member with the tail its A operand y.
enum WsArray { WQ, WK, WV, WZ, WH, WIG, WFG, WKV, WCPREV, WKSUM, WNPREV, WBTOT, WMLOC, WMPREV,
               WXM, WCONV, WGP, WY, kNumWs };

void workspace_layout(int kind, int B, int S, int INNER, int NH, long* off) {
  const long NS = (S + CS - 1) / CS;
  const long tok = (long)B * S, rows = (long)B * NH;
  const bool has_head = kind == LAYER || kind == CONV;
  const long size[kNumWs] = {tok * INNER, tok * INNER, tok * INNER,
                             has_head ? tok * INNER : 0, kind == CELL ? 0 : tok * INNER,
                             rows * S, rows * S, rows * NS * DH * DH, rows * NS * DH * DH,
                             rows * NS * DH, rows * NS * DH, rows * NS, rows * NS, rows * NS,
                             has_head ? tok * INNER : 0, kind == CONV ? tok * INNER : 0,
                             2 * NH * rows * S, kind == CELL ? 0 : tok * INNER};
  off[0] = 0;
  for (int i = 0; i < kNumWs; ++i) off[i + 1] = off[i] + size[i];
}

constexpr size_t kHeadSmem = sizeof(float) * 4 * TF;
constexpr size_t kPrologueSmem = sizeof(float) * 5 * TF;
constexpr size_t kOutputSmem = sizeof(float) * (4 * TF + DH + 6 * CS);
constexpr size_t kEpilogueSmem = sizeof(float) * 4 * TF;  // two stages of two tiles

template <class K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Points p at the workspace and launches the stages of `kind` on the stream;
// p holds the inputs, the sizes and (for the cell) h already. Returns 0 or
// the CUDA error code of the first failed step.
int run(Params& p, float* ws, int kind, void* stream) {
  if (p.INNER != p.NH * DH || p.B <= 0 || p.S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  p.NS = (p.S + CS - 1) / CS;
  const long tok = (long)p.B * p.S, rows = (long)p.B * p.NH;
  long off[kNumWs + 1];
  workspace_layout(kind, p.B, p.S, p.INNER, p.NH, off);
  p.q = ws + off[WQ]; p.k = ws + off[WK]; p.v = ws + off[WV]; p.z = ws + off[WZ];
  if (kind != CELL) p.h = ws + off[WH];
  p.ig = ws + off[WIG]; p.fg = ws + off[WFG]; p.kv = ws + off[WKV];
  p.cprev = ws + off[WCPREV]; p.ksum = ws + off[WKSUM]; p.nprev = ws + off[WNPREV];
  p.btot = ws + off[WBTOT]; p.mloc = ws + off[WMLOC]; p.mprev = ws + off[WMPREV];
  p.gp = ws + off[WGP];
  p.y = kind == CELL ? nullptr : ws + off[WY];
  const bool has_head = kind == LAYER || kind == CONV;
  if (has_head) {
    p.zr = p.z;
    p.xres = p.x;
    p.xmw = ws + off[WXM];
    p.xm = p.xmw;
  }
  if (kind == CONV) {
    if (p.H <= 0 || p.W <= 0 || (long)p.H * p.W != p.S)
      return static_cast<int>(cudaErrorInvalidValue);
    p.convw = ws + off[WCONV];
    p.conv = p.convw;
  }

  cudaError_t err;
  const auto prologue = kind == CONV ? vil_cell_prologue<true> : vil_cell_prologue<false>;
  if ((err = allow_smem(vil_head, kHeadSmem)) != cudaSuccess) return err;
  if ((err = allow_smem(prologue, kPrologueSmem)) != cudaSuccess) return err;
  if ((err = allow_smem(vil_chunk_output, kOutputSmem)) != cudaSuccess) return err;
  if ((err = allow_smem(vil_epilogue, kEpilogueSmem)) != cudaSuccess) return err;

  const unsigned tok_tiles = (unsigned)((tok + TOK - 1) / TOK);
  if (has_head) {
    vil_head<<<dim3(tok_tiles, 2 * p.INNER / tile::T), NT, kHeadSmem, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  prologue<<<dim3(tok_tiles, p.NH), NT, kPrologueSmem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  vil_chunk_summary<<<dim3(p.NS, rows), NT, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  vil_state_scan<<<dim3(rows, DH * DH / NT), NT, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  vil_chunk_output<<<dim3(p.NS, rows), NT, kOutputSmem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (kind == CELL) return 0;
  vil_epilogue<<<dim3(tok_tiles, (p.DIM + tile::T - 1) / tile::T), NT, kEpilogueSmem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return 0;
}

// The cell's arguments, shared by the four entries.
void set_cell(Params& p, const float* conv, const float* wq, const float* wk, const float* wv,
              const float* bq, const float* bk, const float* bv, const float* wgi,
              const float* bgi, const float* wgf, const float* bgf, int B, int S, int INNER,
              int NH, int igate_exp, float eps) {
  p.conv = conv;
  p.wq = wq; p.wk = wk; p.wv = wv; p.bq = bq; p.bk = bk; p.bv = bv;
  p.wgi = wgi; p.bgi = bgi; p.wgf = wgf; p.bgf = bgf;
  p.B = B; p.S = S; p.INNER = INNER; p.NH = NH;
  p.igate_exp = igate_exp; p.eps = eps;
}

// The tail's arguments, shared by the layer and the block.
void set_tail(Params& p, const float* nsc, const float* nbi, const float* skip, const float* wd,
              const float* bd, float* out, int DIM, float norm_eps) {
  p.nsc = nsc; p.nbi = nbi; p.skip = skip; p.wd = wd; p.bd = bd; p.out = out;
  p.DIM = DIM; p.norm_eps = norm_eps;
}

}  // namespace

extern "C" {

// Writes the offsets (in floats) of the workspace's arrays q, k, v, z, h,
// ig, fg, kv, cprev, ksum, nprev, btot, mloc, mprev, xm, conv, gp, y into
// off[0..17] and its total size into off[18]; the wrapper allocates off[18]
// floats. `kind`: 0 the layer, 1 the cell (no z, no h, no y), 2 the block
// (no z), 3 the conv-fused layer (the only one with conv); z and xm exist
// for 0 and 3.
void vil_workspace_layout(int kind, int B, int S, int INNER, int NH, long* off) {
  workspace_layout(kind, B, S, INNER, NH, off);
}

const char* vil_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each entry returns 0 on success, else the CUDA error code of the first
// failed step. Headwise weights arrive as (NH, DH_out, DH_in), gate kernels
// as (NH, 3*INNER), proj_up's weight as (2*INNER, DIM) and proj_down's as
// (DIM, INNER) (out x in, as torch's Linear keeps them).

// K3: the layer from x and conv_act.
int vil_layer_fwd_f32(const float* x, const float* conv, const float* nrm, const float* wu,
                      const float* bu, const float* wq, const float* wk, const float* wv,
                      const float* bq, const float* bk, const float* bv, const float* wgi,
                      const float* bgi, const float* wgf, const float* bgf, const float* nsc,
                      const float* nbi, const float* skip, const float* wd, const float* bd,
                      float* out, float* ws, int B, int S, int DIM, int INNER, int NH,
                      int igate_exp, float eps, float norm_eps, float rms_eps, void* stream) {
  Params p = {};
  set_cell(p, conv, wq, wk, wv, bq, bk, bv, wgi, bgi, wgf, bgf, B, S, INNER, NH, igate_exp, eps);
  set_tail(p, nsc, nbi, skip, wd, bd, out, DIM, norm_eps);
  p.x = x; p.nrm = nrm; p.wu = wu; p.bu = bu; p.rms_eps = rms_eps;
  return run(p, ws, LAYER, stream);
}

// K6: the layer from x alone, the depthwise conv on the (H, W) token grid
// inside; wc arrives as (9, INNER), tap kh*3 + kw of every channel.
int vil_layer_conv_fwd_f32(const float* x, const float* nrm, const float* wu, const float* bu,
                           const float* wc, const float* bc, const float* wq, const float* wk,
                           const float* wv, const float* bq, const float* bk, const float* bv,
                           const float* wgi, const float* bgi, const float* wgf,
                           const float* bgf, const float* nsc, const float* nbi,
                           const float* skip, const float* wd, const float* bd, float* out,
                           float* ws, int B, int S, int DIM, int INNER, int NH, int igate_exp,
                           int H, int W, float eps, float norm_eps, float rms_eps,
                           void* stream) {
  Params p = {};
  set_cell(p, nullptr, wq, wk, wv, bq, bk, bv, wgi, bgi, wgf, bgf, B, S, INNER, NH, igate_exp,
           eps);
  set_tail(p, nsc, nbi, skip, wd, bd, out, DIM, norm_eps);
  p.x = x; p.nrm = nrm; p.wu = wu; p.bu = bu; p.rms_eps = rms_eps;
  p.wc = wc; p.bc = bc; p.H = H; p.W = W;
  return run(p, ws, CONV, stream);
}

// K4: the cell from conv_act and x_mlstm; h (B, S, INNER) out.
int vil_cell_fwd_f32(const float* conv, const float* xm, const float* wq, const float* wk,
                     const float* wv, const float* bq, const float* bk, const float* bv,
                     const float* wgi, const float* bgi, const float* wgf, const float* bgf,
                     float* h, float* ws, int B, int S, int INNER, int NH, int igate_exp,
                     float eps, void* stream) {
  Params p = {};
  set_cell(p, conv, wq, wk, wv, bq, bk, bv, wgi, bgi, wgf, bgf, B, S, INNER, NH, igate_exp, eps);
  p.xm = xm; p.h = h;
  return run(p, ws, CELL, stream);
}

// K7: the cell and the tail from conv_act, x_mlstm, z and the residual.
int vil_block_fwd_f32(const float* conv, const float* xm, const float* z, const float* xres,
                      const float* wq, const float* wk, const float* wv, const float* bq,
                      const float* bk, const float* bv, const float* wgi, const float* bgi,
                      const float* wgf, const float* bgf, const float* nsc, const float* nbi,
                      const float* skip, const float* wd, const float* bd, float* out, float* ws,
                      int B, int S, int DIM, int INNER, int NH, int igate_exp, float eps,
                      float norm_eps, void* stream) {
  Params p = {};
  set_cell(p, conv, wq, wk, wv, bq, bk, bv, wgi, bgi, wgf, bgf, B, S, INNER, NH, igate_exp, eps);
  set_tail(p, nsc, nbi, skip, wd, bd, out, DIM, norm_eps);
  p.xm = xm; p.zr = z; p.xres = xres;
  return run(p, ws, BLOCK, stream);
}

}  // extern "C"
