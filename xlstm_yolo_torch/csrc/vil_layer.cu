// The ViL layer family, forward, for NVIDIA Hopper, plain C interface: the
// layer-fused (K3, fp32 and bf16), cell-fused (K4), block-fused (K7) and
// conv-fused (K6) functions.
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
//   2. cell prologue (one CTA per 64 tokens x one group of 64 channels: one
//      head at DH 64): the group's conv_act (K6: its nine taps and SiLU) and
//      x_mlstm, then q, k, v as three 64 x 64 x 64 products. Each gate
//      pre-activation dots all 3*INNER channels, so each CTA writes its
//      group's partial dot for all 2*NH gate rows to the workspace (2, NG,
//      B*NH, S). 87 KB, two CTAs per SM.
//   3. chunk summaries (one CTA per (chunk, batch*head)): sums the NG gate
//      partials in a fixed order (deterministic, no atomics) into the i/f
//      pre-activations, then k^T (g v) and the k sums. 35 KB.
//   4. state scan (one CTA per (batch*head, 256 state entries; one for the
//      whole DH x DH state below DH 16)): the only sequential part, NS
//      steps of an elementwise update of C, n, m.
//   5. chunk outputs (one CTA per (chunk, batch*head)): the causal q k^T, the
//      intra-chunk E v and the carried-in q C, normalized; for the members
//      with the tail also its elementwise part, once per head and token:
//      y = (outnorm(h) + skip conv_act) silu(z) to the workspace, or
//      y = (h + skip conv_act) silu(z) when the caller passes no outnorm
//      affine (the layer's use_outnorm=False). 71 KB.
//   6. epilogue (K3, K6, K7; one CTA per 64 tokens x 64 columns of DIM): y
//      times proj_down as a GEMM over INNER in double-buffered 64-channel
//      slices; the residual is added at the end. 70 KB.
// Gate math, stabilizers, exp/log, norms and scans stay fp32 on the CUDA
// cores.
//
// K3 in bf16 (vil_layer_fwd_bf16, the vil16_* stages): the TPU kernel's
// default arithmetic, `mxu_dtype="bfloat16"`, with x and conv_act in bf16
// as the JAX layer streams them under AMP or bf16 serving. What bounds it
// on this card: its products are bf16 (989 TFLOP/s), so at ViL-YOLO-n's
// widths the bytes of x, conv_act and out (2 bytes each) bound it, and a
// design that moves each intermediate through device memory in fp32 spends
// most of its time there and in the latency of each stage's loads.
// What the design does about it: every product reads bf16 tiles through
// ldmatrix into m16n8k16 (tile_bf16.cuh), each operand written to shared
// memory once as the bf16 value the JAX kernel rounds: the normalized x
// (x (1/rms) rms_scale, scaled in place after it lands), the gate-weighted
// k (k g), q_inter (q a / sqrt(DH)), E, the carried C, y; activations and
// the weights (rounded once per call by vil16_prep) are copied in as they
// are by 16-byte cp.async. An intermediate goes through device memory in
// bf16 wherever the JAX kernel consumes it only as a bf16 operand: x_mlstm
// (the v product and the gate dots), v, k's copy for q k^T, the carried C
// of the forward's state, y; q and k stay fp32 as well (q_inter and q . n,
// and g k and the k sums, scale them before any rounding), z fp32 (SiLU).
// The two state scans (the forward's, and under grad the backward's) run
// in one launch with four chunks' loads in flight; the gate dots skip the
// gate columns past 2*NH. The weights arrive fp32 and are rounded once;
// the biases of proj_up and of q/k/v and rms_scale are rounded to bf16
// values as the JAX layer casts them; the gate biases, outnorm, skip and
// proj_down's bias stay fp32. Under grad it also writes q, k, v (unscaled)
// and h in bf16, the dtype the JAX forward saves them in, for the
// backward, and a second set of carried (C, n) states for it, from chunk
// summaries of the bf16 k and v taken in fp32 (3xTF32: g k is no bf16
// value): the forward's own state accumulates bf16-operand summaries of
// fp32 k and v (the JAX kernel's kvs and ksums), while the JAX backward
// replays the state from the bf16 k and v it saved, in fp32 (its phase 1),
// so that is the state the backward reads. Shared memory per stage is fixed
// by its tiles (at most 74 KB), so every width runs.
//
// Head dims: 64, and the smaller ones the JAX package's ViL blocks default
// to, 4, 8, 16 and 32 (`DH` is a template parameter of every stage that
// depends on it; the entries dispatch on INNER / NH). Below 64 the stages
// split in two kinds:
//   - the headwise products and the gate dots (the cell prologue) pack the
//     64 / DH heads of a 64-channel group into one 64-wide tile, the
//     headwise weights as its block-diagonal (the off-diagonal blocks zero,
//     as the TPU kernel's `wq_bd`), so those products stay 64 x 64 x 64 and
//     the gate partials have one source per group of 64 channels, as at 64;
//   - the per-head chunk products (q k^T, E v, q C, (g k)^T v) contract or
//     produce only within one head and are never packed: a CTA takes one
//     head of one chunk, its q, k, v, C land in 64-wide tiles zero-padded
//     in shared memory, each contraction over the head dim runs to the
//     MMA's k (8 in TF32, 16 in bf16; DH itself from 8 or 16 up) and each
//     product's output stops at the head's DH columns (`nlim`, `mlim` of
//     the tile products). The per-head gate matrix (a CS x CS exp and mask)
//     is then as much work as the products at DH 4 and 8.
// Widths: INNER any multiple of DH; a group or a proj_up tile that runs
// past INNER is masked. The chunk is fixed at 64. A sequence that is not a
// multiple of 64 is handled by masking the last chunk: missing positions
// load as zeros with an input-gate log of -1e30, so they add nothing to any
// valid position.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include "tile_bf16.cuh"
#include "tile_mma.cuh"

namespace {

using tile::Acc;
using tile::LDS;
using tile::kp16;
using tile::kp32;
using tile::qscale;
using tile::round_bf16;
using tile::store_block;
using bf16 = __nv_bfloat16;

constexpr int CS = 64;               // chunk length
constexpr int TOK = 64;              // tokens per CTA of the head, cell prologue and epilogue
constexpr int KS = 64;               // the head's slice of DIM per stage
constexpr int NT = tile::THREADS;    // threads per CTA
constexpr int NW = NT / 32;          // warps per CTA
constexpr int TF = tile::FLOATS;     // floats of one 64 x 64 shared tile
constexpr float NEG = -1e30f;
constexpr int GW = tile::T;          // channels of a head group (the prologue's and epilogue's tiles)


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
  const float* wq;    // (NH, DH_out, DH_in), DH = INNER / NH
  const float* wk;
  const float* wv;
  const float* bq;    // (INNER)
  const float* bk;
  const float* bv;
  const float* wgi;   // (NH, 3*INNER)
  const float* bgi;   // (NH)
  const float* wgf;
  const float* bgf;
  const float* nsc;   // (INNER) effective outnorm scale; null: no outnorm
  const float* nbi;   // (INNER)
  int outnorm;        // the tail normalizes h per head (set_tail: nsc is not null)
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
  float* gp;          // (2, NG, B*NH, S) per-source-group partial gate dots
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
  int DH, NG;         // head dim INNER / NH; groups of 64 channels, ceil(INNER / 64)
  float eps, norm_eps, rms_eps;
  // the bf16 layer (K3 in bf16, the vil16_* stages)
  const bf16* x16;    // (B, S, DIM) layer input
  const bf16* conv16; // (B, S, INNER) activated conv branch
  bf16* out16;        // (B, S, DIM)
  bf16* sv;           // under grad: (4, B, S, INNER) q, k, v, h in bf16 for the backward
  bf16* wu16;         // the products' weights rounded once (vil16_prep): proj_up (2*INNER, DIM),
  bf16* wq16;         // the headwise (NH, DH, DH) each,
  bf16* wk16;
  bf16* wv16;
  bf16* wg16;         // the stacked gate rows (2*NH, 3*INNER), input gate's first,
  bf16* wd16;         // proj_down (DIM, INNER)
  bf16* xm16;         // (B, S, INNER) x_mlstm, only ever a bf16 operand
  bf16* q16;          // (B, S, INNER) q, k, v, h in bf16: under grad the backward's saved
  bf16* k16;          // activations (the planes of sv), else null
  bf16* v16;
  bf16* h16;
  bf16* y16;          // (B, S, INNER) the tail's A operand
  bf16* c16;          // (B*NH, NS, DH, DH) the carried C, only ever a bf16 operand here
  float* kv32;        // under grad: the backward's chunk summaries (B*NH, NS, DH, DH)
  float* cprev32;     // the carried C it reads (B*NH, NS, DH, DH)
  float* ksum32;      // and the same for n: (B*NH, NS, DH) each
  float* nprev32;
};

__device__ __forceinline__ float logsigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One token's head of h normalized over its DH values, held two a lane
// (h0 = column lane, h1 = column lane + 32, zeros past DH): (h - mean) /
// sqrt(var + eps), without the affine. The whole warp calls it.
template <int DH>
__device__ __forceinline__ void head_norm(float& h0, float& h1, int lane, float eps) {
  const float mu = warp_sum(h0 + h1) / DH;
  const float d0 = lane < DH ? h0 - mu : 0.f, d1 = lane + 32 < DH ? h1 - mu : 0.f;
  const float inv = rsqrtf(warp_sum(d0 * d0 + d1 * d1) / DH + eps);
  h0 = d0 * inv;
  h1 = d1 * inv;
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
  const int wrows = 2 * INNER - c0 < tile::T ? 2 * INNER - c0 : tile::T;
  const float* xsrc = p.x + tok0 * DIM;
  const float* wsrc = p.wu + (long)c0 * DIM;
  const int nk = (DIM + KS - 1) / KS;

  auto stage = [&](int buf, int k0) {
    float* xb = sm + buf * 2 * TF;
    tile::load_async<TOK, KS>(xb, LDS, xsrc + k0, DIM, nrows, DIM - k0);
    tile::load_async<TOK, KS>(xb + TF, LDS, wsrc + k0, DIM, wrows, DIM - k0);
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

  // column pairs (gc, gc + 1) of 2*INNER: INNER is even, so a pair lies in one half
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 2 * hh, row = Acc::row(r), gc = c0 + Acc::col(j, r);
      const float sc = rinv[row];
      if (tok0 + row < ntok && gc < 2 * INNER) {
        float* dst = gc < INNER ? p.xmw + gc : p.z + (gc - INNER);
        *reinterpret_cast<float2*>(dst + (tok0 + row) * INNER) =
            make_float2(acc.c[j][r] * sc + p.bu[gc], acc.c[j][r + 1] * sc + p.bu[gc + 1]);
      }
    }
}

// K6: conv_act of 64 tokens x the ncols channels c0 .. of a group from
// x_mlstm in the workspace: the nine taps on the (H, W) grid (a tap outside
// it adds nothing), bias, SiLU; to the workspace and to the shared tile cv
// (zeros past ncols).
__device__ void conv_tile(const Params& p, float* cv, int c0, int ncols, long tok0, long ntok) {
  const int INNER = p.INNER, H = p.H, W = p.W;
  for (int i = threadIdx.x; i < TOK * GW; i += NT) {
    const int r = i / GW, cl = i % GW, c = c0 + cl;
    const long tk = tok0 + r;
    float act = 0.f;
    if (tk < ntok && cl < ncols) {
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
// at columns coff .. coff+ncols-1; rows past 2*NH and columns past ncols
// land as zeros.
__device__ void load_gate_rows(const Params& p, float* dst, int r0, int coff, int ncols) {
  const long ld = 3L * p.INNER;
  const int NH = p.NH;
  const bool vec = (ld & 3) == 0 && (coff & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(p.wgi) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(p.wgf) & 15) == 0;
  const int per = vec ? GW / 4 : GW;  // copies per row
  for (int i = threadIdx.x; i < tile::T * per; i += NT) {
    const int r = i / per, c = (vec ? 4 : 1) * (i % per), rr = r0 + r;
    const float* src = rr < NH ? p.wgi + rr * ld : rr < 2 * NH ? p.wgf + (rr - NH) * ld : nullptr;
    if (c >= ncols) src = nullptr;  // ncols is a multiple of 4
    if (vec)
      tile::cp_async16(dst + r * LDS + c, src ? src + coff + c : p.wgi, src ? 16 : 0);
    else
      tile::cp_async4(dst + r * LDS + c, src ? src + coff + c : p.wgi, src ? 4 : 0);
  }
}

// The headwise weight of group g (heads g*64/DH ..) as one 64 x 64 tile,
// [out channel][in channel] of the group: at DH 64 the head's weight, copied
// in by cp.async (the caller commits and waits); below 64 the block-diagonal
// of the group's heads, zeros elsewhere and past the ncols channels that
// exist, written directly (the caller's barrier covers it).
template <int DH>
__device__ __forceinline__ void load_headwise(float* dst, const float* w, int g, int ncols) {
  if constexpr (DH == tile::T) {
    tile::load_async<DH, DH>(dst, LDS, w + (long)g * DH * DH, DH, DH, DH);
  } else {
    const float* wg = w + (long)g * GW * DH;  // the group's first head
    for (int i = threadIdx.x; i < GW * GW; i += NT) {
      const int r = i / GW, c = i % GW;
      dst[r * LDS + c] = r / DH == c / DH && r < ncols
                             ? wg[(long)(r / DH) * DH * DH + (r % DH) * DH + c % DH]
                             : 0.f;
    }
  }
}

// Adds the bias to a headwise product of a group, keeps it in the shared
// tile and writes the token rows that exist and the ncols columns that
// exist to the workspace (the tile's other columns stay zero).
__device__ __forceinline__ void put_headwise(const Acc& a, const float* bias, float* tile_,
                                             float* dst, long tok0, long ntok, int INNER,
                                             int ncols) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 2 * hh, row = Acc::row(r), col = Acc::col(j, r);
      const bool ok = col < ncols;  // ncols is even
      const float2 v = ok ? make_float2(a.c[j][r] + bias[col], a.c[j][r + 1] + bias[col + 1])
                          : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(tile_ + row * LDS + col) = v;
      if (ok && tok0 + row < ntok)
        *reinterpret_cast<float2*>(dst + (tok0 + row) * INNER + col) = v;
    }
}

// 2. Cell prologue for 64 tokens and the 64-channel group g (one head at
// DH 64, 64 / DH heads below): headwise q/k/v and the group's partial gate
// dots. CONV (K6) computes conv_act from the workspace's x_mlstm first; the
// others stream it in.
template <bool CONV, int DH>
__global__ void __launch_bounds__(NT, 2) vil_cell_prologue(Params p) {
  extern __shared__ __align__(16) float sm[];
  float* t0 = sm;           // conv_act, then q
  float* t1 = t0 + TF;      // x_mlstm, then k
  float* t2 = t1 + TF;      // wq, then v
  float* t3 = t2 + TF;      // wk, then gate rows
  float* t4 = t3 + TF;      // wv, then gate rows
  const int g = blockIdx.y, INNER = p.INNER, NH = p.NH, NG = p.NG;
  const int c0 = g * GW, ncols = INNER - c0 < GW ? INNER - c0 : GW;
  const long ntok = (long)p.B * p.S, tok0 = (long)blockIdx.x * TOK;
  const int nrows = (int)(ntok - tok0 < TOK ? ntok - tok0 : TOK);
  const long hoff = tok0 * INNER + c0;
  if (!CONV)
    tile::load_async<TOK, GW>(t0, LDS, p.conv + hoff, INNER, nrows, ncols);
  tile::load_async<TOK, GW>(t1, LDS, p.xm + hoff, INNER, nrows, ncols);
  load_headwise<DH>(t2, p.wq, g, ncols);
  load_headwise<DH>(t3, p.wk, g, ncols);
  load_headwise<DH>(t4, p.wv, g, ncols);
  tile::cp_async_commit();
  if (CONV) conv_tile(p, t0, c0, ncols, tok0, ntok);
  tile::cp_async_wait_all();
  __syncthreads();

  {
    Acc aq, ak, av;
    aq.zero();
    ak.zero();
    av.zero();
    tile::mma<false, true>(aq, t0, LDS, t2, LDS, GW);
    tile::mma<false, true>(ak, t0, LDS, t3, LDS, GW);
    tile::mma<false, true>(av, t1, LDS, t4, LDS, GW);
    __syncthreads();
    put_headwise(aq, p.bq + c0, t0, p.q + c0, tok0, ntok, INNER, ncols);
    put_headwise(ak, p.bk + c0, t1, p.k + c0, tok0, ntok, INNER, ncols);
    put_headwise(av, p.bv + c0, t2, p.v + c0, tok0, ntok, INNER, ncols);
  }

  // this group's share of every gate pre-activation: cat(q, k, v)[:, group g]
  // against the matching columns of all 2*NH gate rows, 64 rows at a time
  const long stride = (long)p.B * NH * p.S;  // one source group's partials
  for (int r0 = 0; r0 < 2 * NH; r0 += tile::T) {
    load_gate_rows(p, t3, r0, c0, ncols);
    load_gate_rows(p, t4, r0, INNER + c0, ncols);
    tile::cp_async_commit();
    tile::cp_async_wait_all();
    __syncthreads();
    Acc ag;
    ag.zero();
    tile::mma<false, true>(ag, t0, LDS, t3, LDS, GW);
    tile::mma<false, true>(ag, t1, LDS, t4, LDS, GW);
    __syncthreads();
    load_gate_rows(p, t3, r0, 2 * INNER + c0, ncols);
    tile::cp_async_commit();
    tile::cp_async_wait_all();
    __syncthreads();
    tile::mma<false, true>(ag, t2, LDS, t3, LDS, GW);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int hc = r0 + Acc::col(j, r);
        const long tk = tok0 + Acc::row(r);
        if (hc < 2 * NH && tk < ntok) {
          const int which = hc >= NH, hh = hc - which * NH;
          const long b = tk / p.S, s = tk % p.S;
          p.gp[((long)which * NG + g) * stride + (b * NH + hh) * p.S + s] = ag.c[j][r];
        }
      }
    __syncthreads();
  }
}

// The i/f pre-activations of chunk positions s0 .. s0+63 of row bh = b*NH +
// hh: bias plus the NG source groups' partials, summed in order; written to
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
      const float* src = p.gp + (long)which * p.NG * stride + (long)bh * p.S + s;
      pre = which ? p.bgf[hh] : p.bgi[hh];
      for (int g = 0; g < p.NG; ++g) pre += src[g * stride];
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

// 3. Per-chunk state summaries: (g k)^T v and the sums of g k, the gate
// weights g applied to k in the product's fragment load. Below DH 64 the
// head's k and v land zero-padded in 64-wide tiles and the product stops at
// the DH x DH block.
template <int DH>
__global__ void __launch_bounds__(NT) vil_chunk_summary(Params p) {
  __shared__ __align__(16) float ks[TF];
  __shared__ __align__(16) float vs[TF];
  __shared__ float bcs[CS], li[CS], gw[CS];
  __shared__ float s_mloc;
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / p.NH, n = bh % p.NH;
  const int tid = threadIdx.x, s0 = j * CS;
  const int nrows = p.S - s0 < CS ? p.S - s0 : CS;
  const long hoff = ((long)b * p.S + s0) * p.INNER + (long)n * DH;

  tile::load_async<CS, tile::T>(ks, LDS, p.k + hoff, p.INNER, nrows, DH);
  tile::load_async<CS, tile::T>(vs, LDS, p.v + hoff, p.INNER, nrows, DH);
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

  const long base = (long)bh * p.NS + j;
  Acc acc;
  acc.zero();
  tile::mma<true, false>(acc, ks, LDS, vs, LDS, CS, gw, nullptr, DH, DH);  // (g k)^T v: [d][e]
  store_block<DH>(acc, p.kv + base * DH * DH);
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
template <int DH>
__global__ void __launch_bounds__(NT) vil_state_scan(Params p) {
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int idx = blockIdx.y * NT + tid;  // entry of C
  if (idx >= DH * DH) return;             // below DH 16 one CTA covers C with threads to spare
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

// 5. Per-chunk outputs h = (intra + inter) / normalizer. q_inter (row t of
// q times av[t], its inter-chunk scale over sqrt(DH)) is formed in the
// fragment load of the q C product. Below DH 64 q, k, v and C land
// zero-padded in 64-wide tiles (C to the MMA's k), the contractions over the
// head dim run to kp32<DH>() and the outputs stop at the head's DH columns.
template <int DH>
__global__ void __launch_bounds__(NT, 3) vil_chunk_output(Params p) {
  constexpr float QS = qscale<DH>();
  constexpr int KP = kp32<DH>();
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                // q, unscaled
  float* ks = qs + TF;           // k, then E: decayed q k^T / sqrt(DH) (row t, col s)
  float* vs = ks + TF;
  float* Cs = vs + TF;           // carried-in C [d][e]
  float* nv = Cs + TF;           // 64 carried-in n, zeros past DH
  float* bcs = nv + tile::T;     // CS cumsum of log f
  float* li = bcs + CS;          // CS log input gate
  float* cm = li + CS;           // CS running max of li - b
  float* stab = cm + CS;         // CS stabilizer
  float* av = stab + CS;         // CS inter-chunk scale over sqrt(DH)
  float* den = av + CS;          // CS normalizer
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / p.NH, n = bh % p.NH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, s0 = j * CS;
  const long base = (long)bh * p.NS + j;
  const int nrows = p.S - s0 < CS ? p.S - s0 : CS;
  const long hoff = ((long)b * p.S + s0) * p.INNER + (long)n * DH;

  tile::load_async<CS, tile::T>(qs, LDS, p.q + hoff, p.INNER, nrows, DH);
  tile::load_async<CS, tile::T>(ks, LDS, p.k + hoff, p.INNER, nrows, DH);
  tile::load_async<CS, tile::T>(vs, LDS, p.v + hoff, p.INNER, nrows, DH);
  tile::load_async<KP, KP>(Cs, LDS, p.cprev + base * DH * DH, DH, DH, DH);
  tile::cp_async_commit();
  load_gates(p, bh, s0, bcs, li);
  if (tid < tile::T) nv[tid] = tid < DH ? p.nprev[base * DH + tid] : 0.f;
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
    av[tid] = expf(inter_log - st) * QS;
  }
  __syncthreads();

  {
    Acc s;
    s.zero();
    tile::mma<false, true, tile::OUT_LOWER>(s, qs, LDS, ks, LDS, KP);
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
    const float qn = warp_sum(qs[t * LDS + lane] * nv[lane] +
                              qs[t * LDS + lane + 32] * nv[lane + 32]);
    if (lane == 0) den[t] = fmaxf(fabsf(es + av[t] * qn), expf(-stab[t])) + p.eps;
  }
  __syncthreads();

  Acc hv, inter;
  hv.zero();
  inter.zero();
  tile::mma<false, false, tile::K_LE_M>(hv, E, LDS, vs, LDS, CS, nullptr, nullptr, DH);
  tile::mma<false, false>(inter, qs, LDS, Cs, LDS, KP, nullptr, av, DH);
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = Acc::row(r);
      hv.c[jj][r] = (hv.c[jj][r] + inter.c[jj][r]) / den[t];
    }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 2 * hh, t = Acc::row(r);
      if (s0 + t < p.S && Acc::col(jj, r) < DH) {
        const long o = ((long)b * p.S + s0 + t) * p.INNER + n * DH + Acc::col(jj, r);
        *reinterpret_cast<float2*>(p.h + o) = make_float2(hv.c[jj][r], hv.c[jj][r + 1]);
      }
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
    float h0 = hr[lane], h1 = hr[lane + 32];  // zeros past DH
    if (p.outnorm) head_norm<DH>(h0, h1, lane, p.norm_eps);  // warp-uniform
    const long row = ((long)b * p.S + s0 + t) * p.INNER + n * DH;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int cl = lane + 32 * half, c = n * DH + cl;
      if (cl >= DH) break;
      const float hv = half ? h1 : h0;
      const float hn = p.outnorm ? hv * p.nsc[c] + p.nbi[c] : hv;
      p.y[row + cl] = (hn + p.skip[c] * p.conv[row + cl]) * silu(p.zr[row + cl]);
    }
  }
}

// 6. Epilogue for 64 tokens x 64 columns of DIM: y (the chunk outputs'
// tail product) times proj_down's slice, the K loop over the NG groups of
// 64 channels in double-buffered slices; then bias and residual.
__global__ void __launch_bounds__(NT, 3) vil_epilogue(Params p) {
  // per stage: y (64 tokens x one head's channels), then proj_down's rows
  // c0 .. c0+63 at the same channels
  extern __shared__ __align__(16) float sm[];
  const int DIM = p.DIM, INNER = p.INNER;
  const long ntok = (long)p.B * p.S, tok0 = (long)blockIdx.x * TOK;
  const int c0 = blockIdx.y * tile::T;
  const int nrows = (int)(ntok - tok0 < TOK ? ntok - tok0 : TOK);
  const int ncols = DIM - c0 < tile::T ? DIM - c0 : tile::T;
  auto stage = [&](int buf, int g) {
    float* yb = sm + buf * 2 * TF;
    const int k0 = g * GW, kc = INNER - k0 < GW ? INNER - k0 : GW;
    tile::load_async<TOK, GW>(yb, LDS, p.y + tok0 * INNER + k0, INNER, nrows, kc);
    tile::load_async<tile::T, GW>(yb + TF, LDS, p.wd + (long)c0 * INNER + k0, INNER, ncols, kc);
    tile::cp_async_commit();
  };

  Acc acc;
  acc.zero();
  stage(0, 0);
  for (int g = 0; g < p.NG; ++g) {
    const int buf = g & 1;
    if (g + 1 < p.NG) {
      stage(buf ^ 1, g + 1);
      tile::cp_async_wait_one();
    } else {
      tile::cp_async_wait_all();
    }
    __syncthreads();
    const float* yb = sm + buf * 2 * TF;
    tile::mma<false, true>(acc, yb, LDS, yb + TF, LDS, GW);
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

// ---- K3 in bf16: the vil16_* stages -------------------------------------------------

constexpr int HT = tile::HALVES;  // bf16 elements of one 64 x 64 shared tile
using tile::LDH;

// 0. The products' weights, rounded to bf16 once per call (the JAX layer
// casts its weights to the activations' dtype), four values a thread-step
// (every weight's size is a multiple of 4; the copies are 16-byte ones where
// the weight is 16-byte aligned).
__device__ __forceinline__ void round4(bf16* dst, const float* src, long n, long i0,
                                       long stride) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (long i = 4 * i0; i < n; i += 4 * stride) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
      __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst + i);
      d[0] = __floats2bfloat162_rn(v.x, v.y);
      d[1] = __floats2bfloat162_rn(v.z, v.w);
    }
  } else {
    for (long i = i0; i < n; i += stride) dst[i] = __float2bfloat16_rn(src[i]);
  }
}

__global__ void __launch_bounds__(NT) vil16_prep(Params p) {
  const long stride = (long)gridDim.x * NT, i0 = (long)blockIdx.x * NT + threadIdx.x;
  const long nw = (long)p.NH * p.DH * p.DH, ng = 3L * p.INNER * p.NH;
  round4(p.wu16, p.wu, 2L * p.INNER * p.DIM, i0, stride);
  round4(p.wq16, p.wq, nw, i0, stride);
  round4(p.wk16, p.wk, nw, i0, stride);
  round4(p.wv16, p.wv, nw, i0, stride);
  round4(p.wg16, p.wgi, ng, i0, stride);
  round4(p.wg16 + ng, p.wgf, ng, i0, stride);
  round4(p.wd16, p.wd, (long)p.DIM * p.INNER, i0, stride);
}

// 1. Head for 64 tokens x HG tiles of 64 output columns of proj_up: x's
// slices and proj_up's copied in as they are, double-buffered; each row's
// 1/rms is summed from global memory while the first slice lands; then each
// x slice is scaled in place, once for all HG column tiles, to xn = x
// (1/rms) rms_scale, rounded once (the JAX kernel's bf16 xn), and
// multiplied. x_mlstm is written in bf16 (it is only ever a bf16 operand),
// z in fp32 (it goes into SiLU).
constexpr int HG = 4;  // column tiles per head CTA
__global__ void __launch_bounds__(NT, 2) vil16_head(Params p) {
  extern __shared__ __align__(16) bf16 sh[];  // per stage: x slice, then HG tiles of proj_up's rows
  __shared__ float ns[2][KS];                 // rms_scale's slice per stage, bf16 values
  __shared__ float rinv[TOK];
  const int DIM = p.DIM, INNER = p.INNER, tid = threadIdx.x;
  const long ntok = (long)p.B * p.S, tok0 = (long)blockIdx.x * TOK;
  const int ct0 = blockIdx.y * HG;  // first column tile, of ceil(2*INNER / 64)
  const int ntiles = (2 * INNER + tile::T - 1) / tile::T;
  const int ng = ntiles - ct0 < HG ? ntiles - ct0 : HG;
  const int nrows = (int)(ntok - tok0 < TOK ? ntok - tok0 : TOK);
  const bf16* xsrc = p.x16 + tok0 * DIM;
  const bf16* wsrc = p.wu16 + (long)ct0 * tile::T * DIM;
  const int nk = (DIM + KS - 1) / KS;
  auto stage = [&](int buf, int k0) {
    bf16* xb = sh + buf * (HG + 1) * HT;
    tile::load16(xb, xsrc + k0, DIM, nrows, DIM - k0);
    for (int g = 0; g < ng; ++g) {
      const int left = 2 * INNER - (ct0 + g) * tile::T;  // proj_up's rows in this tile
      tile::load16(xb + (g + 1) * HT, wsrc + (long)g * tile::T * DIM + k0, DIM,
                   left < TOK ? left : TOK, DIM - k0);
    }
    if (tid < KS) ns[buf][tid] = k0 + tid < DIM ? round_bf16(p.nrm[k0 + tid]) : 0.f;
    tile::cp_async_commit();
  };
  stage(0, 0);
  {  // thread (row tid / 4, quarter tid % 4) sums its quarter of the row's squares
    const int r = tid >> 2, qq = tid & 3;
    float ss = 0.f;
    if (r < nrows) {
      const bf16* xr = xsrc + (long)r * DIM;
      if ((DIM & 7) == 0 && (reinterpret_cast<uintptr_t>(p.x16) & 15) == 0) {
        for (int c = 8 * qq; c < DIM; c += 32) {
          const uint4 u = *reinterpret_cast<const uint4*>(xr + c);
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h2[e]);
            ss += f.x * f.x + f.y * f.y;
          }
        }
      } else {
        for (int c = qq; c < DIM; c += 4) {
          const float v = __bfloat162float(xr[c]);
          ss += v * v;
        }
      }
    }
    ss = tile::quad_sum(ss);
    if (qq == 0) rinv[r] = rsqrtf(ss / DIM + p.rms_eps);
  }

  Acc acc[HG];
#pragma unroll
  for (int g = 0; g < HG; ++g) acc[g].zero();
  for (int i = 0; i < nk; ++i) {
    const int buf = i & 1;
    if (i + 1 < nk) {
      stage(buf ^ 1, (i + 1) * KS);
      tile::cp_async_wait_one();
    } else {
      tile::cp_async_wait_all();
    }
    __syncthreads();
    bf16* xb = sh + buf * (HG + 1) * HT;
    for (int e = tid; e < TOK * KS / 2; e += NT) {
      const int r = e / (KS / 2), c = 2 * (e % (KS / 2));
      __nv_bfloat162* x2 = reinterpret_cast<__nv_bfloat162*>(xb + r * LDH + c);
      const float2 f = __bfloat1622float2(*x2);
      *x2 = __floats2bfloat162_rn(f.x * rinv[r] * ns[buf][c], f.y * rinv[r] * ns[buf][c + 1]);
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < HG; ++g)
      if (g < ng) tile::mma16<false, true>(acc[g], xb, xb + (g + 1) * HT);
    __syncthreads();
  }

#pragma unroll
  for (int g = 0; g < HG; ++g) {
    if (g >= ng) break;
    const int c0 = (ct0 + g) * tile::T;  // first output column, of 2*INNER
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // column pair (gc, gc + 1): INNER is even, so a pair lies in one half
        const int r = 2 * hh, row = Acc::row(r), gc = c0 + Acc::col(j, r);
        if (tok0 + row >= ntok || gc >= 2 * INNER) continue;
        const float v0 = acc[g].c[j][r] + round_bf16(p.bu[gc]);
        const float v1 = acc[g].c[j][r + 1] + round_bf16(p.bu[gc + 1]);
        const long o = (tok0 + row) * INNER + (gc < INNER ? gc : gc - INNER);
        if (gc < INNER)
          *reinterpret_cast<__nv_bfloat162*>(p.xm16 + o) = __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(p.z + o) = make_float2(v0, v1);
      }
  }
}

// Adds the bias (a bf16 value, as the JAX layer casts it) to a headwise
// product of a group and puts its bf16 value in the tile t16; columns past
// ncols (the channels that exist) stay zero.
__device__ __forceinline__ void put16(const Acc& a, const float* bias, bf16* t16, int ncols) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 2 * hh, row = Acc::row(r), col = Acc::col(j, r);
      const bool ok = col < ncols;  // ncols is even
      *reinterpret_cast<__nv_bfloat162*>(t16 + row * LDH + col) =
          ok ? __floats2bfloat162_rn(a.c[j][r] + round_bf16(bias[col]),
                                     a.c[j][r + 1] + round_bf16(bias[col + 1]))
             : __floats2bfloat162_rn(0.f, 0.f);
    }
}

// Writes the first nrows rows and ncols columns of a bf16 tile to a
// row-major global matrix (row stride ld elements): 16-byte stores where the
// rows are 16-byte aligned and whole, else 2-byte ones.
__device__ __forceinline__ void store16_rows(bf16* dst, long ld, const bf16* t16, int nrows,
                                             int ncols) {
  if ((ld & 7) == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0 && ncols == tile::T) {
    for (int i = threadIdx.x; i < nrows * (tile::T / 8); i += NT) {
      const int r = i >> 3, c = 8 * (i & 7);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = *reinterpret_cast<const uint4*>(t16 + r * LDH + c);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * tile::T; i += NT) {
      const int r = i >> 6, c = i & 63;
      if (c < ncols) dst[r * ld + c] = t16[r * LDH + c];
    }
  }
}

// The bf16 headwise weight of group g as one 64 x 64 tile, as
// load_headwise: the head's weight by cp.async at DH 64 (the caller commits
// and waits), the block-diagonal of the group's heads below, written
// directly (the caller's barrier covers it).
template <int DH>
__device__ __forceinline__ void load_headwise16(bf16* dst, const bf16* w, int g, int ncols) {
  if constexpr (DH == tile::T) {
    tile::load16(dst, w + (long)g * DH * DH, DH, DH, DH);
  } else {
    const bf16* wg = w + (long)g * GW * DH;
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int i = threadIdx.x; i < GW * GW; i += NT) {
      const int r = i / GW, c = i % GW;
      dst[r * LDH + c] = r / DH == c / DH && r < ncols
                             ? wg[(long)(r / DH) * DH * DH + (r % DH) * DH + c % DH]
                             : zero;
    }
  }
}

// 2. Cell prologue for 64 tokens and the 64-channel group g (one head at
// DH 64, 64 / DH heads below, their weights as the block-diagonal):
// headwise q/k/v, then the group's partial gate dots from the bf16 q, k, v
// (the JAX kernel casts them for the gate dots) against the first 64 gate
// rows, all of it copied in by one cp.async group; the products skip the
// gate columns past 2*NH. Under grad it writes q, k, v in bf16 for the
// backward; the later stages recompute them (headwise16).
template <int DH>
__global__ void __launch_bounds__(NT, 3) vil16_prologue(Params p) {
  extern __shared__ __align__(16) bf16 sh[];
  bf16* t0 = sh;        // conv_act
  bf16* t1 = t0 + HT;   // x_mlstm
  bf16* t2 = t1 + HT;   // wq, then R(q)
  bf16* t3 = t2 + HT;   // wk, then R(k)
  bf16* t4 = t3 + HT;   // wv, then R(v)
  bf16* gq = t4 + HT;   // the gate rows' q, k and v columns of head n
  bf16* gk = gq + HT;
  bf16* gv = gk + HT;
  const int g = blockIdx.y, INNER = p.INNER, NH = p.NH;
  const int c0 = g * GW, ncols = INNER - c0 < GW ? INNER - c0 : GW;
  const long ntok = (long)p.B * p.S, tok0 = (long)blockIdx.x * TOK;
  const int nrows = (int)(ntok - tok0 < TOK ? ntok - tok0 : TOK);
  const long hoff = tok0 * INNER + c0;
  const long gld = 3L * INNER;
  auto load_gate_rows = [&](int r0) {
    const bf16* w = p.wg16 + (long)r0 * gld + c0;
    tile::load16(gq, w, gld, 2 * NH - r0, ncols);
    tile::load16(gk, w + INNER, gld, 2 * NH - r0, ncols);
    tile::load16(gv, w + 2 * INNER, gld, 2 * NH - r0, ncols);
  };
  tile::load16(t0, p.conv16 + hoff, INNER, nrows, ncols);
  tile::load16(t1, p.xm16 + hoff, INNER, nrows, ncols);
  load_headwise16<DH>(t2, p.wq16, g, ncols);
  load_headwise16<DH>(t3, p.wk16, g, ncols);
  load_headwise16<DH>(t4, p.wv16, g, ncols);
  load_gate_rows(0);
  tile::cp_async_commit();
  tile::cp_async_wait_all();
  __syncthreads();
  {  // one product at a time, each rounded into the tile its weight leaves
    Acc a;
    a.zero();
    tile::mma16<false, true>(a, t0, t2);
    __syncthreads();
    put16(a, p.bq + c0, t2, ncols);
    a.zero();
    tile::mma16<false, true>(a, t0, t3);
    __syncthreads();
    put16(a, p.bk + c0, t3, ncols);
    a.zero();
    tile::mma16<false, true>(a, t1, t4);
    __syncthreads();
    put16(a, p.bv + c0, t4, ncols);
  }
  __syncthreads();
  if (p.q16 != nullptr) {  // the backward's saved q, k, v
    store16_rows(p.q16 + hoff, INNER, t2, nrows, ncols);
    store16_rows(p.k16 + hoff, INNER, t3, nrows, ncols);
    store16_rows(p.v16 + hoff, INNER, t4, nrows, ncols);
  }

  const long stride = (long)p.B * NH * p.S;  // one source group's partials
  long gpos[2];  // the thread's two rows' offset b*NH*S + s in a gate row's partials, or -1
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const long tk = tok0 + Acc::row(2 * hh);
    gpos[hh] = tk < ntok ? (tk / p.S) * NH * p.S + tk % p.S : -1;
  }
  for (int r0 = 0; r0 < 2 * NH; r0 += tile::T) {
    if (r0 > 0) {
      __syncthreads();
      load_gate_rows(r0);
      tile::cp_async_commit();
      tile::cp_async_wait_all();
      __syncthreads();
    }
    const int nlim = 2 * NH - r0 < tile::T ? 2 * NH - r0 : tile::T;
    Acc ag;
    ag.zero();
    tile::mma16<false, true>(ag, t2, gq, GW, nlim);
    tile::mma16<false, true>(ag, t3, gk, GW, nlim);
    tile::mma16<false, true>(ag, t4, gv, GW, nlim);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int hc = r0 + Acc::col(j, r);
        const long gpo = gpos[r >> 1];
        if (hc < 2 * NH && gpo >= 0) {
          const int which = hc >= NH, hh = hc - which * NH;
          p.gp[((long)which * p.NG + g) * stride + (long)hh * p.S + gpo] = ag.c[j][r];
        }
      }
  }
}

// The headwise products of 64 rows of head n, recomputed wherever a stage
// needs q, k or v: acc = R(src) R(w)^T + R(bias), in fp32, from the bf16
// tiles of the activation (conv_act or x_mlstm) and of the head's weight.
// The same tiles through the same product give the same fp32 values bit for
// bit in every stage, so no stage reads q, k or v back from device memory.
// Below DH 64 the tiles hold one head zero-padded (its activation columns
// and its weight's rows and columns past DH are zero): the contraction runs
// to kp16<DH>() and the columns past DH stay exactly zero.
template <int DH>
__device__ __forceinline__ void headwise16(Acc& acc, const bf16* src, const bf16* w,
                                           const float* bias) {
  acc.zero();
  tile::mma16<false, true>(acc, src, w, kp16<DH>(), DH);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (Acc::col(j, r) < DH) acc.c[j][r] += round_bf16(bias[Acc::col(j, r)]);
}

// Column sums of a 64 x 64 accumulator tile, each row r weighted by w[r],
// per row quarter (a warp's 16 rows) into cpart[quarter][column] (4 x 64
// floats); the caller sums the four quarters in order after a barrier (no
// atomics).
__device__ __forceinline__ void weighted_col_sums(const Acc& a, const float* w, float* cpart) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int par = 0; par < 2; ++par) {
      float c = a.c[j][par] * w[Acc::row(par)] + a.c[j][par + 2] * w[Acc::row(par + 2)];
      c += __shfl_xor_sync(0xffffffffu, c, 4);
      c += __shfl_xor_sync(0xffffffffu, c, 8);
      c += __shfl_xor_sync(0xffffffffu, c, 16);
      if (lane < 4) cpart[(warp & 3) * tile::T + Acc::col(j, par)] = c;
    }
}

// 3. Per-chunk state summaries: R(g k)^T R(v) (g k rounded once after its
// scale, the JAX kernel's kg) and the fp32 sums of g k, with k and v
// recomputed from the bf16 conv_act and x_mlstm. Under grad (kv32) also the
// summaries the backward's state is built from, as the JAX backward's phase
// 1 computes them: from the bf16 k and v it saved, in fp32. Below DH 64 the
// head's tiles are zero-padded and the products stop at the DH x DH block.
template <int DH>
__global__ void __launch_bounds__(NT, 3) vil16_chunk_summary(Params p) {
  extern __shared__ __align__(16) bf16 sh[];
  bf16* t0 = sh;                                   // conv_act, then R(g k)
  bf16* t1 = t0 + HT;                              // x_mlstm, then R(v)
  bf16* t2 = t1 + HT;                              // wk, then under grad hi
  bf16* t3 = t2 + HT;                              // wv, then mid
  bf16* t4 = t3 + HT;                              // lo
  __shared__ float bcs[CS], li[CS], gw[CS], cpart[8 * tile::T];  // two sets of weighted_col_sums
  __shared__ float s_mloc;
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / p.NH, n = bh % p.NH;
  const int tid = threadIdx.x, s0 = j * CS;
  const int nrows = p.S - s0 < CS ? p.S - s0 : CS;
  const long hoff = ((long)b * p.S + s0) * p.INNER + (long)n * DH;
  const long woff = (long)n * DH * DH;

  tile::load16(t0, p.conv16 + hoff, p.INNER, nrows, DH);
  tile::load16(t1, p.xm16 + hoff, p.INNER, nrows, DH);
  tile::load16(t2, p.wk16 + woff, DH, DH, DH);
  tile::load16(t3, p.wv16 + woff, DH, DH, DH);
  tile::cp_async_commit();
  sum_gates(p, bh, n, s0, bcs, li);
  tile::cp_async_wait_all();
  __syncthreads();
  Acc ak, av;
  headwise16<DH>(ak, t0, t2, p.bk + n * DH);
  headwise16<DH>(av, t1, t3, p.bv + n * DH);
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
  __syncthreads();  // gw is read below; every warp is done with t0 .. t3
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 2 * hh, s = Acc::row(r), d = Acc::col(jj, r);
      *reinterpret_cast<__nv_bfloat162*>(t0 + s * LDH + d) =
          __floats2bfloat162_rn(ak.c[jj][r] * gw[s], ak.c[jj][r + 1] * gw[s]);
      *reinterpret_cast<__nv_bfloat162*>(t1 + s * LDH + d) =
          __floats2bfloat162_rn(av.c[jj][r], av.c[jj][r + 1]);
    }
  weighted_col_sums(ak, gw, cpart);  // the k sums
  const bool grad = p.kv32 != nullptr;
  if (grad) {
    // The backward's summaries: g R(k), an fp32 value, is split exactly
    // into three bf16 values (hi + mid + lo: 24 significant bits in three
    // of 8), so three bf16 products with R(v) sum to its fp32 product.
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 2 * hh, s = Acc::row(r), o = s * LDH + Acc::col(jj, r);
        ak.c[jj][r] = round_bf16(ak.c[jj][r]);
        ak.c[jj][r + 1] = round_bf16(ak.c[jj][r + 1]);
        const float x0 = ak.c[jj][r] * gw[s], x1 = ak.c[jj][r + 1] * gw[s];
        const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(h);
        const __nv_bfloat162 m = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
        const float2 mf = __bfloat1622float2(m);
        *reinterpret_cast<__nv_bfloat162*>(t2 + o) = h;
        *reinterpret_cast<__nv_bfloat162*>(t3 + o) = m;
        *reinterpret_cast<__nv_bfloat162*>(t4 + o) =
            __floats2bfloat162_rn(x0 - hf.x - mf.x, x1 - hf.y - mf.y);
      }
    weighted_col_sums(ak, gw, cpart + 4 * tile::T);  // the backward's k sums, of R(k)
  }
  __syncthreads();

  const long base = (long)bh * p.NS + j;
  if (tid < DH) {
    const float* c = cpart + tid;
    constexpr int T = tile::T;  // cpart: [set][row quarter][64 columns]
    p.ksum[base * DH + tid] = c[0] + c[T] + c[2 * T] + c[3 * T];
    if (grad) p.ksum32[base * DH + tid] = c[4 * T] + c[5 * T] + c[6 * T] + c[7 * T];
  }
  if (tid == 0) {
    p.btot[base] = btot;
    p.mloc[base] = mloc;
  }
  Acc acc;
  acc.zero();
  tile::mma16<true, false>(acc, t0, t1, CS, DH, DH);  // R(g k)^T R(v): [d][e]
  store_block<DH>(acc, p.kv + base * DH * DH);
  if (!grad) return;
  acc.zero();
  tile::mma16<true, false>(acc, t4, t1, CS, DH, DH);  // lo, mid, hi
  tile::mma16<true, false>(acc, t3, t1, CS, DH, DH);
  tile::mma16<true, false>(acc, t2, t1, CS, DH, DH);
  store_block<DH>(acc, p.kv32 + base * DH * DH);
}

// 4. Both state scans in one launch (blockIdx.z). Set 0 carries the
// forward's state over the bf16-operand summaries and writes the carried C
// in bf16 (the chunk outputs read it only as a bf16 operand), with n and m;
// set 1 (under grad) carries the backward's over the fp32 summaries, C and
// n in fp32. A thread owns two neighbouring entries and keeps the next PF
// chunks' entries in flight.
template <int DH>
__global__ void __launch_bounds__(NT) vil16_state_scan(Params p) {
  constexpr int PF = 4;
  const bool bwd = blockIdx.z == 1;
  const float* kv = bwd ? p.kv32 : p.kv;
  const float* ksum = bwd ? p.ksum32 : p.ksum;
  float* nprev = bwd ? p.nprev32 : p.nprev;
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int idx = 2 * (blockIdx.y * NT + tid);  // entries idx, idx + 1 of C
  if (idx >= DH * DH) return;  // below DH 32 one CTA covers C with threads to spare
  const bool own_n = blockIdx.y == 0 && tid < DH / 2;  // and of n
  const bool own_m = !bwd && blockIdx.y == 0 && tid == 0;
  const long row = (long)bh * p.NS;
  float2 v[PF], w[PF];
  float bt[PF], ml[PF];
  auto fetch = [&](int k, int j) {
    if (j >= p.NS) return;
    const long base = row + j;
    v[k] = *reinterpret_cast<const float2*>(kv + base * DH * DH + idx);
    w[k] = own_n ? *reinterpret_cast<const float2*>(ksum + base * DH + idx) : make_float2(0.f, 0.f);
    bt[k] = p.btot[base];
    ml[k] = p.mloc[base];
  };
#pragma unroll
  for (int k = 0; k < PF; ++k) fetch(k, k);
  float2 c = make_float2(0.f, 0.f), nn = make_float2(0.f, 0.f);
  float m = 0.f;
  for (int j = 0; j < p.NS; ++j) {
    const float2 kvv = v[0], ks = w[0];
    const float b_ = bt[0], l_ = ml[0];
#pragma unroll
    for (int k = 0; k + 1 < PF; ++k) {
      v[k] = v[k + 1];
      w[k] = w[k + 1];
      bt[k] = bt[k + 1];
      ml[k] = ml[k + 1];
    }
    fetch(PF - 1, j + PF);
    const long base = row + j;
    if (bwd)
      *reinterpret_cast<float2*>(p.cprev32 + base * DH * DH + idx) = c;
    else
      *reinterpret_cast<__nv_bfloat162*>(p.c16 + base * DH * DH + idx) =
          __floats2bfloat162_rn(c.x, c.y);
    if (own_n) *reinterpret_cast<float2*>(nprev + base * DH + idx) = nn;
    if (own_m) p.mprev[base] = m;
    const float mn = fmaxf(b_ + m, l_);
    const float dold = expf(b_ + m - mn), dnew = expf(l_ - mn);
    c = make_float2(c.x * dold + kvv.x * dnew, c.y * dold + kvv.y * dnew);
    nn = make_float2(nn.x * dold + ks.x * dnew, nn.y * dold + ks.y * dnew);
    m = mn;
  }
}

// 5. Per-chunk outputs h = (R(E) R(v) + R(q_inter) R(C)) / normalizer, then
// the tail's elementwise part y = (outnorm(h) + skip conv_act) silu(z), in
// bf16 (only ever the epilogue's operand). q, k, v are recomputed from the
// bf16 conv_act and x_mlstm; from q's fp32 accumulators come, in one pass,
// R(q / sqrt(DH)) for q k^T (the scaled q rounded, as the JAX kernel rounds
// it), R(q_inter) = R(q a / sqrt(DH)) (rounded once after its scale) and
// q . n; E's row sums come from its fp32 accumulators before E
// is rounded. Below DH 64 the head's tiles are zero-padded, the contractions
// over the head dim run to kp16<DH>() and the outputs stop at DH columns.
template <int DH>
__global__ void __launch_bounds__(NT, 3) vil16_chunk_output(Params p) {
  constexpr float QS = qscale<DH>();
  constexpr int KP = kp16<DH>();
  extern __shared__ __align__(16) bf16 sh[];
  bf16* cv = sh;              // conv_act (the tail's skip reads it too)
  bf16* k16 = cv + HT;        // x_mlstm, then R(q_inter)
  bf16* q16 = k16 + HT;       // wq, then R(q)
  bf16* qi = q16 + HT;        // wk, then R(k)
  bf16* v16 = qi + HT;        // wv, then R(v)
  bf16* C16 = v16 + HT;       // R(C) carried in, [d][e]
  bf16* E16 = C16 + HT;       // R(E): decayed q k^T / sqrt(DH)
  float* zs = reinterpret_cast<float*>(q16);      // z (fp32) for the tail, over two tiles
  float* hs = reinterpret_cast<float*>(C16);      // h (fp32) for the tail, over two tiles
  float* nv = reinterpret_cast<float*>(E16 + HT); // 64 carried-in n, zeros past DH
  float* bcs = nv + tile::T;                      // CS cumsum of log f
  float* li = bcs + CS;                           // CS log input gate
  float* cm = li + CS;                            // CS running max of li - b
  float* stab = cm + CS;                          // CS stabilizer
  float* av = stab + CS;                          // CS inter-chunk scale over sqrt(DH)
  float* den = av + CS;                           // CS normalizer
  float* qpart = den + CS;                        // 2 x CS q . n of the two column halves
  float* rpart = qpart + 2 * CS;                  // 2 x CS row sums of E's column halves
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / p.NH, n = bh % p.NH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, s0 = j * CS;
  const long base = (long)bh * p.NS + j;
  const int nrows = p.S - s0 < CS ? p.S - s0 : CS;
  const long hoff = ((long)b * p.S + s0) * p.INNER + (long)n * DH;
  const long woff = (long)n * DH * DH;
  // the warp's row sums of a per-thread quantity into part[column half][row]
  auto row_sums = [&](float (&pr)[2], float* part) {
    const float r0 = tile::quad_sum(pr[0]), r1 = tile::quad_sum(pr[1]);
    if ((tid & 3) == 0) {
      part[(tid >> 7) * CS + Acc::row(0)] = r0;
      part[(tid >> 7) * CS + Acc::row(2)] = r1;
    }
  };

  tile::load16(cv, p.conv16 + hoff, p.INNER, nrows, DH);
  tile::load16(k16, p.xm16 + hoff, p.INNER, nrows, DH);
  tile::load16(q16, p.wq16 + woff, DH, DH, DH);
  tile::load16(qi, p.wk16 + woff, DH, DH, DH);
  tile::load16(v16, p.wv16 + woff, DH, DH, DH);
  tile::load16(C16, p.c16 + base * DH * DH, DH, DH, DH);
  tile::cp_async_commit();
  load_gates(p, bh, s0, bcs, li);
  if (tid < tile::T) nv[tid] = tid < DH ? p.nprev[base * DH + tid] : 0.f;
  const float m_prev = p.mprev[base];
  __syncthreads();
  if (tid < 32) warp_scan64<false>(bcs);
  __syncthreads();
  if (tid < CS) cm[tid] = li[tid] - bcs[tid];
  __syncthreads();
  if (tid < 32) warp_scan64<true>(cm);
  __syncthreads();
  if (tid < CS) {
    const float inter_log = m_prev + bcs[tid];
    const float st = fmaxf(bcs[tid] + cm[tid], inter_log);
    stab[tid] = st;
    av[tid] = expf(inter_log - st) * QS;
  }
  tile::cp_async_wait_all();
  __syncthreads();
  // one headwise product at a time, each rounded into the tile its weight
  // leaves (k, then v over x_mlstm's weight, then q and q_inter)
  auto put = [&](const Acc& a, bf16* dst, const float* rs, float scale = 1.f) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 2 * hh, t = Acc::row(r), c = Acc::col(jj, r);
        const float sc = rs ? rs[t] : scale;
        *reinterpret_cast<__nv_bfloat162*>(dst + t * LDH + c) =
            __floats2bfloat162_rn(a.c[jj][r] * sc, a.c[jj][r + 1] * sc);
      }
  };
  {
    Acc a;
    headwise16<DH>(a, cv, qi, p.bk + n * DH);
    __syncthreads();
    put(a, qi, nullptr);  // R(k), for now in wk's tile
    headwise16<DH>(a, k16, v16, p.bv + n * DH);
    __syncthreads();
    put(a, v16, nullptr);
    headwise16<DH>(a, cv, q16, p.bq + n * DH);
    float pr[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r) pr[r >> 1] += a.c[jj][r] * nv[Acc::col(jj, r)];
    row_sums(pr, qpart);
    __syncthreads();  // every warp is done with x_mlstm and wq
    put(a, q16, nullptr, QS);  // R(q / sqrt(DH)): the JAX kernel rounds the scaled q
    put(a, k16, av);  // R(q_inter) over x_mlstm's tile
  }
  __syncthreads();
  bf16* kk = qi;  // R(k)
  qi = k16;       // R(q_inter)

  {
    Acc s;
    s.zero();
    tile::mma16<false, true, tile::OUT_LOWER>(s, q16, kk, KP);
    float pr[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = Acc::row(r), c = Acc::col(jj, r);
        const float e = c <= t ? s.c[jj][r] * expf(li[c] - bcs[c] + bcs[t] - stab[t]) : 0.f;
        s.c[jj][r] = e;
        pr[r >> 1] += e;
      }
    row_sums(pr, rpart);
    tile::store16(s, E16);
  }
  __syncthreads();  // every warp is done with R(q) and R(k): z lands over them
  tile::load_async<CS, DH>(zs, LDS, p.z + hoff, p.INNER, nrows, DH);
  tile::cp_async_commit();
  if (tid < CS)
    den[tid] = fmaxf(fabsf(rpart[tid] + rpart[CS + tid] +
                           av[tid] * (qpart[tid] + qpart[CS + tid])),
                     expf(-stab[tid])) +
               p.eps;
  __syncthreads();

  Acc hv, inter;
  hv.zero();
  inter.zero();
  tile::mma16<false, false, tile::K_LE_M>(hv, E16, v16, CS, DH);
  tile::mma16<false, false>(inter, qi, C16, KP, DH);
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int r = 0; r < 4; ++r) hv.c[jj][r] = (hv.c[jj][r] + inter.c[jj][r]) / den[Acc::row(r)];
  if (p.h16 != nullptr) {  // the backward's bf16 h
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 2 * hh, t = Acc::row(r);
        if (s0 + t < p.S && Acc::col(jj, r) < DH)
          *reinterpret_cast<__nv_bfloat162*>(
              p.h16 + ((long)b * p.S + s0 + t) * p.INNER + n * DH + Acc::col(jj, r)) =
              __floats2bfloat162_rn(hv.c[jj][r], hv.c[jj][r + 1]);
      }
  }

  // the tail's elementwise part for this head, once per token
  __syncthreads();  // every warp is done with R(C) and R(E): h takes their place
  tile::store(hv, hs, LDS);
  tile::cp_async_wait_all();
  __syncthreads();
  for (int t = warp; t < CS; t += NW) {
    if (s0 + t >= p.S) break;  // warp-uniform
    const float* hr = hs + t * LDS;
    float h0 = hr[lane], h1 = hr[lane + 32];  // zeros past DH
    if (p.outnorm) head_norm<DH>(h0, h1, lane, p.norm_eps);  // warp-uniform
    const long row = ((long)b * p.S + s0 + t) * p.INNER + n * DH;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int cl = lane + 32 * half, c = n * DH + cl;
      if (cl >= DH) break;
      const float hv = half ? h1 : h0;
      const float hn = p.outnorm ? hv * p.nsc[c] + p.nbi[c] : hv;
      const float cvv = __bfloat162float(cv[t * LDH + cl]);
      p.y16[row + cl] = __float2bfloat16_rn((hn + p.skip[c] * cvv) * silu(zs[t * LDS + cl]));
    }
  }
}

// 6. Epilogue for 64 tokens x 64 columns of DIM: R(y) times proj_down's
// slice over the heads in double-buffered 64-channel slices, then bias and
// the bf16 residual (copied in with the first slice); out in bf16.
__global__ void __launch_bounds__(NT, 3) vil16_epilogue(Params p) {
  extern __shared__ __align__(16) bf16 sh[];  // per stage: y, then proj_down's rows; x
  bf16* xs = sh + 4 * HT;
  const int DIM = p.DIM, INNER = p.INNER;
  const long ntok = (long)p.B * p.S, tok0 = (long)blockIdx.x * TOK;
  const int c0 = blockIdx.y * tile::T;
  const int nrows = (int)(ntok - tok0 < TOK ? ntok - tok0 : TOK);
  const int ncols = DIM - c0 < tile::T ? DIM - c0 : tile::T;
  auto stage = [&](int buf, int g) {
    bf16* yb = sh + buf * 2 * HT;
    const int k0 = g * GW, kc = INNER - k0 < GW ? INNER - k0 : GW;
    tile::load16(yb, p.y16 + tok0 * INNER + k0, INNER, nrows, kc);
    tile::load16(yb + HT, p.wd16 + (long)c0 * INNER + k0, INNER, ncols, kc);
    tile::cp_async_commit();
  };

  Acc acc;
  acc.zero();
  tile::load16(xs, p.x16 + tok0 * DIM + c0, DIM, nrows, ncols);
  stage(0, 0);
  for (int g = 0; g < p.NG; ++g) {
    const int buf = g & 1;
    if (g + 1 < p.NG) {
      stage(buf ^ 1, g + 1);
      tile::cp_async_wait_one();
    } else {
      tile::cp_async_wait_all();
    }
    __syncthreads();
    const bf16* yb = sh + buf * 2 * HT;
    tile::mma16<false, true>(acc, yb, yb + HT);
    __syncthreads();
  }
  const bool pairs = (DIM & 1) == 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 2 * hh, t = Acc::row(r), c = c0 + Acc::col(j, r);
      const long tk = tok0 + t;
      if (tk >= ntok || c >= DIM) continue;
      const long o = tk * DIM + c;
      const bf16* xr = xs + t * LDH + (c - c0);
      const float v0 = acc.c[j][r] + p.bd[c] + __bfloat162float(xr[0]);
      if (pairs) {  // c is even and DIM too: c + 1 < DIM
        const float v1 = acc.c[j][r + 1] + p.bd[c + 1] + __bfloat162float(xr[1]);
        *reinterpret_cast<__nv_bfloat162*>(p.out16 + o) = __floats2bfloat162_rn(v0, v1);
      } else {
        p.out16[o] = __float2bfloat16_rn(v0);
        if (c + 1 < DIM)
          p.out16[o + 1] =
              __float2bfloat16_rn(acc.c[j][r + 1] + p.bd[c + 1] + __bfloat162float(xr[1]));
      }
    }
}

// Which function of the family a call computes.
enum Kind { LAYER = 0, CELL = 1, BLOCK = 2, CONV = 3, LAYER_BF16 = 4 };

// The workspace's arrays, in this order, with their sizes in floats; the
// backward reads q/k/v/h, the gates and the carried-in states from it. z
// and x_mlstm exist for the layers only (the others stream them in or have
// none), the cell writes h to its output instead, conv_act exists for the
// conv-fused layer only, every member has the gate partials, and every
// member with the tail its A operand y. The bf16 layer has no q, k, v or h
// (its stages recompute q, k, v; under grad the four go to the saved copy),
// and its x_mlstm, y and carried C are bf16, half their slots.
enum WsArray { WQ, WK, WV, WZ, WH, WIG, WFG, WKV, WCPREV, WKSUM, WNPREV, WBTOT, WMLOC, WMPREV,
               WXM, WCONV, WGP, WY, kNumWs };

void workspace_layout(int kind, int B, int S, int INNER, int NH, long* off) {
  const long NS = (S + CS - 1) / CS;
  const long tok = (long)B * S, rows = (long)B * NH;
  const long DH = INNER / NH, NG = (INNER + GW - 1) / GW;
  const bool bf = kind == LAYER_BF16;
  const bool has_head = kind == LAYER || kind == CONV || bf;
  const long act = bf ? 0 : tok * INNER;          // q, k, v (and h)
  const long half = bf ? 2 : 1;                   // bf16 arrays take half a slot
  const long size[kNumWs] = {act, act, act, has_head ? tok * INNER : 0, kind == CELL ? 0 : act,
                             rows * S, rows * S, rows * NS * DH * DH, rows * NS * DH * DH / half,
                             rows * NS * DH, rows * NS * DH, rows * NS, rows * NS, rows * NS,
                             has_head ? tok * INNER / half : 0,
                             kind == CONV ? tok * INNER : 0, 2 * NG * rows * S,
                             kind == CELL ? 0 : tok * INNER / half};
  // every array starts 16-byte aligned: the stages' float2 stores and
  // 16-byte copies need it (the scalars' arrays, B*NH*NS floats each, may
  // have an odd length)
  off[0] = 0;
  for (int i = 0; i < kNumWs; ++i) off[i + 1] = off[i] + (size[i] + 3) / 4 * 4;
}

constexpr size_t kHeadSmem = sizeof(float) * 4 * TF;
constexpr size_t kPrologueSmem = sizeof(float) * 5 * TF;
constexpr size_t kOutputSmem = sizeof(float) * (4 * TF + tile::T + 6 * CS);
constexpr size_t kEpilogueSmem = sizeof(float) * 4 * TF;  // two stages of two tiles

template <class K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// CTAs of the state scans: one per (head row, NT of the DH x DH entries
// of C, each thread `per` of them)
template <int DH>
constexpr unsigned scan_ctas(int per) { return (DH * DH + per * NT - 1) / (per * NT); }

// The six stages of the fp32 family at head dim DH.
template <int DH>
cudaError_t launch_stages(Params& p, int kind, cudaStream_t st) {
  const long tok = (long)p.B * p.S, rows = (long)p.B * p.NH;
  const bool has_head = kind == LAYER || kind == CONV;
  cudaError_t err;
  const auto prologue = kind == CONV ? vil_cell_prologue<true, DH> : vil_cell_prologue<false, DH>;
  if ((err = allow_smem(vil_head, kHeadSmem)) != cudaSuccess) return err;
  if ((err = allow_smem(prologue, kPrologueSmem)) != cudaSuccess) return err;
  if ((err = allow_smem(vil_chunk_output<DH>, kOutputSmem)) != cudaSuccess) return err;
  if ((err = allow_smem(vil_epilogue, kEpilogueSmem)) != cudaSuccess) return err;

  const unsigned tok_tiles = (unsigned)((tok + TOK - 1) / TOK);
  if (has_head) {
    vil_head<<<dim3(tok_tiles, (2 * p.INNER + tile::T - 1) / tile::T), NT, kHeadSmem, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  prologue<<<dim3(tok_tiles, p.NG), NT, kPrologueSmem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  vil_chunk_summary<DH><<<dim3(p.NS, rows), NT, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  vil_state_scan<DH><<<dim3(rows, scan_ctas<DH>(1)), NT, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  vil_chunk_output<DH><<<dim3(p.NS, rows), NT, kOutputSmem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (kind == CELL) return cudaSuccess;
  vil_epilogue<<<dim3(tok_tiles, (p.DIM + tile::T - 1) / tile::T), NT, kEpilogueSmem, st>>>(p);
  return cudaGetLastError();
}

constexpr size_t kHead16Smem = sizeof(bf16) * 2 * (HG + 1) * HT;
constexpr size_t kPrologue16Smem = sizeof(bf16) * 8 * HT;
constexpr size_t kSummary16Smem = sizeof(bf16) * 5 * HT;
constexpr size_t kOutput16Smem = sizeof(bf16) * 7 * HT + sizeof(float) * (tile::T + 10 * CS);
constexpr size_t kEpilogue16Smem = sizeof(bf16) * 5 * HT;

// The seven launches of the bf16 layer at head dim DH.
template <int DH>
cudaError_t launch16(Params& p, cudaStream_t st) {
  const long tok = (long)p.B * p.S, rows = (long)p.B * p.NH;
  cudaError_t err;
  if ((err = allow_smem(vil16_head, kHead16Smem)) != cudaSuccess) return err;
  if ((err = allow_smem(vil16_prologue<DH>, kPrologue16Smem)) != cudaSuccess) return err;
  if ((err = allow_smem(vil16_chunk_summary<DH>, kSummary16Smem)) != cudaSuccess) return err;
  if ((err = allow_smem(vil16_chunk_output<DH>, kOutput16Smem)) != cudaSuccess) return err;
  if ((err = allow_smem(vil16_epilogue, kEpilogue16Smem)) != cudaSuccess) return err;

  const long nw = 2L * p.INNER * p.DIM;  // the largest weight
  vil16_prep<<<(unsigned)((nw + 4 * NT - 1) / (4 * NT)), NT, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const unsigned tok_tiles = (unsigned)((tok + TOK - 1) / TOK);
  const int ntiles = (2 * p.INNER + tile::T - 1) / tile::T;  // proj_up's column tiles
  vil16_head<<<dim3(tok_tiles, (ntiles + HG - 1) / HG), NT, kHead16Smem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  vil16_prologue<DH><<<dim3(tok_tiles, p.NG), NT, kPrologue16Smem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  vil16_chunk_summary<DH><<<dim3(p.NS, rows), NT, kSummary16Smem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  vil16_state_scan<DH><<<dim3(rows, scan_ctas<DH>(2), p.kv32 ? 2 : 1), NT, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  vil16_chunk_output<DH><<<dim3(p.NS, rows), NT, kOutput16Smem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  vil16_epilogue<<<dim3(tok_tiles, (p.DIM + tile::T - 1) / tile::T), NT, kEpilogue16Smem, st>>>(
      p);
  return cudaGetLastError();
}

// Points p at the workspace and launches the stages of `kind` on the stream;
// p holds the inputs, the sizes and (for the cell) h already. `bf`: the
// bf16 layer (kind LAYER only), whose bf16 arrays share the fp32 layout's
// slots: x_mlstm, y and the carried C each take the first half of their
// fp32 array (q, k, v and h have no slot: the stages recompute q, k, v,
// and under grad the four go to the saved copy). Returns 0 or the CUDA
// error code of the first failed step.
bool head_dim_ok(int DH) { return DH == 4 || DH == 8 || DH == 16 || DH == 32 || DH == 64; }

template <int DH>
cudaError_t dispatch(Params& p, int kind, cudaStream_t st, bool bf) {
  return bf ? launch16<DH>(p, st) : launch_stages<DH>(p, kind, st);
}

int run(Params& p, float* ws, int kind, void* stream, bool bf = false) {
  if (p.NH <= 0 || p.INNER % p.NH != 0 || !head_dim_ok(p.INNER / p.NH) || p.B <= 0 || p.S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf && kind != LAYER) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  p.NS = (p.S + CS - 1) / CS;
  p.DH = p.INNER / p.NH;
  p.NG = (p.INNER + GW - 1) / GW;
  long off[kNumWs + 1];
  workspace_layout(bf ? LAYER_BF16 : kind, p.B, p.S, p.INNER, p.NH, off);
  p.q = ws + off[WQ]; p.k = ws + off[WK]; p.v = ws + off[WV]; p.z = ws + off[WZ];
  if (kind != CELL) p.h = ws + off[WH];
  p.ig = ws + off[WIG]; p.fg = ws + off[WFG]; p.kv = ws + off[WKV];
  p.cprev = ws + off[WCPREV]; p.ksum = ws + off[WKSUM]; p.nprev = ws + off[WNPREV];
  p.btot = ws + off[WBTOT]; p.mloc = ws + off[WMLOC]; p.mprev = ws + off[WMPREV];
  p.gp = ws + off[WGP];
  p.y = kind == CELL ? nullptr : ws + off[WY];
  if (bf) {
    const long plane = (long)p.B * p.S * p.INNER;  // one array of the saved copy
    auto half = [&](int i) { return reinterpret_cast<bf16*>(ws + off[i]); };
    p.xm16 = half(WXM);
    p.y16 = half(WY);
    p.c16 = half(WCPREV);
    p.q16 = p.sv;
    p.k16 = p.sv ? p.sv + plane : nullptr;
    p.v16 = p.sv ? p.sv + 2 * plane : nullptr;
    p.h16 = p.sv ? p.sv + 3 * plane : nullptr;
  } else {
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
  }
  cudaError_t err;
  switch (p.DH) {
    case 4: err = dispatch<4>(p, kind, st, bf); break;
    case 8: err = dispatch<8>(p, kind, st, bf); break;
    case 16: err = dispatch<16>(p, kind, st, bf); break;
    case 32: err = dispatch<32>(p, kind, st, bf); break;
    default: err = dispatch<64>(p, kind, st, bf); break;
  }
  return static_cast<int>(err);
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
// A null nsc turns the outnorm off: y = (h + skip conv_act) silu(z).
void set_tail(Params& p, const float* nsc, const float* nbi, const float* skip, const float* wd,
              const float* bd, float* out, int DIM, float norm_eps) {
  p.nsc = nsc; p.nbi = nbi; p.skip = skip; p.wd = wd; p.bd = bd; p.out = out;
  p.DIM = DIM; p.norm_eps = norm_eps; p.outnorm = nsc != nullptr;
}

}  // namespace

extern "C" {

// Writes the offsets (in floats) of the workspace's arrays q, k, v, z, h,
// ig, fg, kv, cprev, ksum, nprev, btot, mloc, mprev, xm, conv, gp, y into
// off[0..17] and its total size into off[18]; the wrapper allocates off[18]
// floats. `kind`: 0 the layer, 1 the cell (no z, no h, no y), 2 the block
// (no z), 3 the conv-fused layer (the only one with conv), 4 the bf16 layer
// (no q, k, v, h; xm, y and cprev in bf16); z and xm exist for 0, 3 and 4.
void vil_workspace_layout(int kind, int B, int S, int INNER, int NH, long* off) {
  workspace_layout(kind, B, S, INNER, NH, off);
}

const char* vil_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each entry returns 0 on success, else the CUDA error code of the first
// failed step. Headwise weights arrive as (NH, DH_out, DH_in), gate kernels
// as (NH, 3*INNER), proj_up's weight as (2*INNER, DIM) and proj_down's as
// (DIM, INNER) (out x in, as torch's Linear keeps them). The members with
// the tail (K3, K6, K7) take nsc = nbi = null for a layer without outnorm.

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

// The bf16 elements of the weight buffer of vil_layer_fwd_bf16.
long vil16_weight_halves(int DIM, int INNER, int NH) {
  const long DH = NH > 0 ? INNER / NH : 0;
  return 3L * INNER * DIM + 3L * NH * DH * DH + 6L * NH * INNER;
}

// K3 in bf16: x and conv_act (B, S, DIM) / (B, S, INNER) in bf16, the
// weights fp32 (rounded to bf16 once, into w16: vil16_weight_halves(DIM,
// INNER, NH) bf16 values), out (B, S, DIM) in bf16. sv, when not null,
// receives (4, B, S, INNER) bf16: q, k, v (unscaled) and h, the backward's
// activations; then states32 (fp32: 2 B*NH*NS*DH*DH + 2 B*NH*NS*DH floats)
// receives the backward's chunk summaries and carried C, then its k sums
// and carried n (null when sv is). The workspace is the fp32 layer's.
int vil_layer_fwd_bf16(const bf16* x, const bf16* conv, const float* nrm, const float* wu,
                       const float* bu, const float* wq, const float* wk, const float* wv,
                       const float* bq, const float* bk, const float* bv, const float* wgi,
                       const float* bgi, const float* wgf, const float* bgf, const float* nsc,
                       const float* nbi, const float* skip, const float* wd, const float* bd,
                       bf16* out, float* ws, bf16* w16, bf16* sv, float* states32, int B, int S,
                       int DIM, int INNER, int NH, int igate_exp, float eps, float norm_eps,
                       float rms_eps, void* stream) {
  Params p = {};
  set_cell(p, nullptr, wq, wk, wv, bq, bk, bv, wgi, bgi, wgf, bgf, B, S, INNER, NH, igate_exp,
           eps);
  set_tail(p, nsc, nbi, skip, wd, bd, nullptr, DIM, norm_eps);
  p.nrm = nrm; p.wu = wu; p.bu = bu; p.rms_eps = rms_eps;
  p.x16 = x; p.conv16 = conv; p.out16 = out; p.sv = sv;
  const long DH = NH > 0 ? INNER / NH : 0;
  p.wu16 = w16;
  p.wq16 = p.wu16 + 2L * INNER * DIM;
  p.wk16 = p.wq16 + (long)NH * DH * DH;
  p.wv16 = p.wk16 + (long)NH * DH * DH;
  p.wg16 = p.wv16 + (long)NH * DH * DH;
  p.wd16 = p.wg16 + 6L * NH * INNER;
  if (states32) {
    const long rows_ns = (long)B * NH * ((S + CS - 1) / CS);
    p.kv32 = states32;
    p.cprev32 = p.kv32 + rows_ns * DH * DH;
    p.ksum32 = p.cprev32 + rows_ns * DH * DH;
    p.nprev32 = p.ksum32 + rows_ns * DH;
  }
  return run(p, ws, LAYER, stream, true);
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
