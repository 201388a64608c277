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
// streamed in. K3 is K7 plus RMSNorm and proj_up computed in the kernel, so
// the three share every stage but the prologue: K3 runs prologue, chunk
// summaries, state scan, chunk outputs, epilogue; K4 a smaller prologue and
// the middle three; K7 the smaller prologue and the other four.
//
// K6 replaces `_kernel_vil_conv` (entry `mlstm_vil_layer_conv_fused_pallas`):
// K3 plus the x_mlstm half of proj_up feeding the 3x3 depthwise conv on the
// (H, W) token grid and its SiLU, all inside: x (B, S = H*W, DIM) is the
// only activation read and out (B, S, DIM) the only one written. The TPU
// kernel kept a window of the sequence with W+1 rows of halo each side in
// fast memory; a block's shared memory holds no such window at these widths
// (a 3x3 tap reaches W+1 tokens away in sequence order, 81 at the 80-wide
// grid, against a prologue tile of 8 to 16 tokens), and recomputing proj_up
// for the halo would multiply the prologue's dominant product. So K6 runs
// two kernels in the prologue's place: a head (RMSNorm and both halves of
// proj_up, token-parallel; x_mlstm and z go to the workspace) and a conv
// prologue (per token the nine taps of x_mlstm read back through L2, the
// zero padding applied to the conv's INPUT: taps outside the grid are
// skipped, which also keeps the left and right columns from wrapping to the
// neighbouring image row; then SiLU, headwise q/k/v and the gate dots as in
// K4's prologue). The other four stages are the shared ones; x_mlstm and
// conv_act stay in the workspace for the epilogue and the backward.
//
// What bounds it on this card: at the ViL-YOLO-n shapes the layer does
// 370 (P3) to 1,200 (P5) fp32 operations per byte of x + conv_act + out,
// far above the H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20 op/B), so
// the least time is set by operations. This first version issues them as fp32 FMAs on
// the CUDA cores (no tensor cores), so the fp32 rate is the bound it is
// held to.
//
// What the design does about it: the TPU kernel walked the sequence in
// order on one core. Here the recurrence is split into the chunkwise
// parallel form so that every SM has work even at batch 1:
//   1. prologue (token-parallel, TT tokens per CTA): RMSNorm, proj_up,
//      headwise q/k/v and the gate dots; q/k/v/z and the gates go to a
//      workspace;
//   2. chunk summaries (one CTA per (chunk, batch*head)): the decayed k v^T
//      and k sums of each chunk, its total decay and local max;
//   3. state scan (one CTA per (batch*head, 256 state entries)): the only
//      sequential part, NS steps of an elementwise update of C, n, m;
//   4. chunk outputs (one CTA per (chunk, batch*head)): intra-chunk
//      attention-like term plus the carried-in state term, normalized;
//   5. epilogue (token-parallel): outnorm, skip, SiLU(z) gate, proj_down,
//      residual.
// Every product is an fp32 FMA loop over shared-memory tiles (rows padded
// to DH+1 floats against bank conflicts). The workspace round trips
// (q/k/v/z/h and the per-chunk states) cost bytes the TPU kernel avoided;
// tensor-core (wgmma) products, bf16 operands and one-launch fusion are
// later work.
//
// Head dim and chunk size are fixed at 64. A sequence that is not a
// multiple of 64 is handled by masking the last chunk: missing positions
// load as zeros with an input-gate log of -1e30, so they add nothing to any
// valid position.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int DH = 64;        // head dim
constexpr int CS = 64;        // chunk length
constexpr int LD = DH + 1;    // padded smem row stride
constexpr int TT = 16;        // tokens per CTA in the layer's prologue and the epilogue
constexpr int TC = 8;         // tokens per CTA in the cell's and block's prologue: at
                              // INNER 384 its 61 KB of shared memory let three CTAs
                              // share an SM (16 tokens: one CTA, a third slower)
constexpr int NT = 256;       // threads per CTA
constexpr int NW = NT / 32;   // warps per CTA
constexpr float NEG = -1e30f;

struct Params {
  const float* x;     // (B, S, DIM) layer input, K3 only
  const float* conv;  // (B, S, INNER) activated conv branch
  const float* xm;    // (B, S, INNER) x_mlstm streamed in, K4 and K7
  const float* zr;    // (B, S, INNER) output-gate branch the epilogue reads:
                      // the workspace's z (K3) or the streamed one (K7)
  const float* xres;  // (B, S, DIM) residual the epilogue adds: x (K3) or
                      // the streamed one (K7)
  const float* nrm;
  const float* wu;    // (DIM, 2*INNER), in x out
  const float* bu;    // (2*INNER)
  const float* wq;    // (NH, DH_in, DH_out)
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
  const float* wd;    // (INNER, DIM), in x out
  const float* bd;    // (DIM)
  float* out;         // (B, S, DIM)
  // workspace
  float* q;           // (B, S, INNER), unscaled
  float* k;
  float* v;
  float* z;           // K3 and K6: the z half of proj_up
  float* xmw;         // K6 only: (B, S, INNER) x_mlstm, written by the head
  float* convw;       // K6 only: (B, S, INNER) conv_act, written by the conv prologue
  const float* wc;    // K6 only: (9, INNER) depthwise taps, [kh*3 + kw][channel]
  const float* bc;    // K6 only: (INNER)
  int H, W;           // K6 only: the token grid, S = H * W
  float* h;           // (B, S, INNER) cell output before outnorm; K4's output
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

// Headwise (block-diagonal) q, k from conv_act and v from x_mlstm, then the
// i/f gate pre-activations, for the T tokens from tok0 on whose conv_act
// (cv) and x_mlstm (xm) rows lie in shared memory (T x INNER each); qkv is
// T x 3*INNER of scratch there. Every thread of the CTA calls it, after a
// barrier.
template <int T>
__device__ void headwise_and_gates(const Params& p, const float* cv, const float* xm,
                                   float* qkv, long tok0, long ntok) {
  const int INNER = p.INNER, NH = p.NH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int c = tid; c < INNER; c += NT) {
    const int n = c / DH, o = c % DH;
    float aq[T], ak[T], av[T];
    const float bq = p.bq[c], bk = p.bk[c], bv = p.bv[c];
#pragma unroll
    for (int t = 0; t < T; ++t) { aq[t] = bq; ak[t] = bk; av[t] = bv; }
    const long wo = (long)n * DH * DH + o;
    for (int d = 0; d < DH; ++d) {
      const float wqd = p.wq[wo + d * DH], wkd = p.wk[wo + d * DH], wvd = p.wv[wo + d * DH];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float c_in = cv[t * INNER + n * DH + d];
        aq[t] += c_in * wqd;
        ak[t] += c_in * wkd;
        av[t] += xm[t * INNER + n * DH + d] * wvd;
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      qkv[t * 3 * INNER + c] = aq[t];
      qkv[t * 3 * INNER + INNER + c] = ak[t];
      qkv[t * 3 * INNER + 2 * INNER + c] = av[t];
      if (tok0 + t < ntok) {
        const long off = (tok0 + t) * INNER + c;
        p.q[off] = aq[t];
        p.k[off] = ak[t];
        p.v[off] = av[t];
      }
    }
  }
  __syncthreads();

  // gate preacts: one warp per (gate, token, head) dot over cat(q, k, v)
  for (int job = warp; job < 2 * T * NH; job += NW) {
    const int which = job / (T * NH), r = job % (T * NH), t = r / NH, hh = r % NH;
    const float* w = (which ? p.wgf : p.wgi) + (long)hh * 3 * INNER;
    float s = 0.f;
    for (int j = lane; j < 3 * INNER; j += 32) s += qkv[t * 3 * INNER + j] * w[j];
    s = warp_sum(s);
    const long tk = tok0 + t;
    if (lane == 0 && tk < ntok) {
      const long b = tk / p.S, si = tk % p.S;
      float* dst = which ? p.fg : p.ig;
      dst[(b * NH + hh) * p.S + si] = s + (which ? p.bgf[hh] : p.bgi[hh]);
    }
  }
}

// RMSNorm and proj_up for the TT tokens from tok0 on: loads their x rows into
// xn (TT x DIM of shared memory) and normalizes them there, then column c <
// INNER of proj_up (x_mlstm) goes to xm_s (TT x INNER of shared memory) when
// that is given, else to the workspace's xmw; the other half (z) goes to the
// workspace. Every thread of the CTA calls it; it ends with a barrier.
__device__ void norm_proj_up(const Params& p, float* xn, float* xm_s, long tok0, long ntok) {
  const int DIM = p.DIM, INNER = p.INNER;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < TT * DIM; i += NT) {
    const long t = tok0 + i / DIM;
    xn[i] = t < ntok ? p.x[t * DIM + i % DIM] : 0.f;
  }
  __syncthreads();

  for (int t = warp; t < TT; t += NW) {
    float s = 0.f;
    for (int d = lane; d < DIM; d += 32) s += xn[t * DIM + d] * xn[t * DIM + d];
    s = warp_sum(s);
    const float r = rsqrtf(s / DIM + p.rms_eps);
    for (int d = lane; d < DIM; d += 32) xn[t * DIM + d] = xn[t * DIM + d] * r * p.nrm[d];
  }
  __syncthreads();

  for (int c = tid; c < 2 * INNER; c += NT) {
    float acc[TT];
    const float bias = p.bu[c];
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[t] = bias;
    for (int d = 0; d < DIM; ++d) {
      const float w = p.wu[(long)d * 2 * INNER + c];
#pragma unroll
      for (int t = 0; t < TT; ++t) acc[t] += xn[t * DIM + d] * w;
    }
    if (c < INNER && xm_s != nullptr) {
#pragma unroll
      for (int t = 0; t < TT; ++t) xm_s[t * INNER + c] = acc[t];
    } else {
      float* dst = c < INNER ? p.xmw + c : p.z + (c - INNER);
#pragma unroll
      for (int t = 0; t < TT; ++t)
        if (tok0 + t < ntok) dst[(tok0 + t) * INNER] = acc[t];
    }
  }
  __syncthreads();
}

// 1. RMSNorm + proj_up + headwise q/k/v + gate dots for TT tokens.
__global__ void __launch_bounds__(NT) vil_prologue(Params p) {
  extern __shared__ float sm[];
  const int DIM = p.DIM, INNER = p.INNER;
  float* xn = sm;                   // TT x DIM
  float* xm = xn + TT * DIM;        // TT x INNER   x_mlstm half of proj_up
  float* cv = xm + TT * INNER;      // TT x INNER   conv_act
  float* qkv = cv + TT * INNER;     // TT x 3*INNER q | k | v per token
  const long ntok = (long)p.B * p.S;
  const long tok0 = (long)blockIdx.x * TT;

  for (int i = threadIdx.x; i < TT * INNER; i += NT) {
    const long t = tok0 + i / INNER;
    cv[i] = t < ntok ? p.conv[t * INNER + i % INNER] : 0.f;
  }
  norm_proj_up(p, xn, xm, tok0, ntok);
  headwise_and_gates<TT>(p, cv, xm, qkv, tok0, ntok);
}

// 1a. K6's head: RMSNorm + proj_up for TT tokens; x_mlstm and z go to the
// workspace.
__global__ void __launch_bounds__(NT) vil_conv_head(Params p) {
  extern __shared__ float sm[];  // TT x DIM
  norm_proj_up(p, sm, nullptr, (long)blockIdx.x * TT, (long)p.B * p.S);
}

// 1b. K6's conv prologue for TC tokens: the 3x3 depthwise conv of x_mlstm on
// the (H, W) token grid (zero padding of the conv's input: a tap outside the
// grid adds nothing) and its SiLU, then headwise q/k/v and the gate dots.
// conv_act goes to the workspace for the epilogue's skip term.
__global__ void __launch_bounds__(NT) vil_conv_prologue(Params p) {
  extern __shared__ float sm[];
  const int INNER = p.INNER, H = p.H, W = p.W;
  float* xm = sm;                   // TC x INNER   x_mlstm
  float* cv = xm + TC * INNER;      // TC x INNER   conv_act
  float* qkv = cv + TC * INNER;     // TC x 3*INNER q | k | v per token
  const long ntok = (long)p.B * p.S;
  const long tok0 = (long)blockIdx.x * TC;
  for (int i = threadIdx.x; i < TC * INNER; i += NT) {
    const long tk = tok0 + i / INNER;
    const int c = i % INNER;
    float center = 0.f, act = 0.f;
    if (tk < ntok) {
      const long b = tk / p.S;
      const int s = (int)(tk % p.S), r = s / W, col = s % W;
      const float* img = p.xmw + b * p.S * INNER + c;
      float acc = p.bc[c];
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const int rr = r + kh - 1;
        if (rr < 0 || rr >= H) continue;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int cc = col + kw - 1;
          if (cc < 0 || cc >= W) continue;
          const float v = img[(long)(rr * W + cc) * INNER];
          if (kh == 1 && kw == 1) center = v;
          acc += v * p.wc[(kh * 3 + kw) * INNER + c];
        }
      }
      act = silu(acc);
      p.convw[tk * INNER + c] = act;
    }
    xm[i] = center;
    cv[i] = act;
  }
  __syncthreads();
  headwise_and_gates<TC>(p, cv, xm, qkv, tok0, ntok);
}

// 1'. The prologue of K4 and K7: conv_act and x_mlstm are streamed in, then
// headwise q/k/v and the gate dots for TC tokens.
__global__ void __launch_bounds__(NT) vil_cell_prologue(Params p) {
  extern __shared__ float sm[];
  const int INNER = p.INNER;
  float* xm = sm;                   // TC x INNER   x_mlstm
  float* cv = xm + TC * INNER;      // TC x INNER   conv_act
  float* qkv = cv + TC * INNER;     // TC x 3*INNER q | k | v per token
  const long ntok = (long)p.B * p.S;
  const long tok0 = (long)blockIdx.x * TC;
  for (int i = threadIdx.x; i < TC * INNER; i += NT) {
    const long t = tok0 + i / INNER;
    cv[i] = t < ntok ? p.conv[t * INNER + i % INNER] : 0.f;
    xm[i] = t < ntok ? p.xm[t * INNER + i % INNER] : 0.f;
  }
  __syncthreads();
  headwise_and_gates<TC>(p, cv, xm, qkv, tok0, ntok);
}

// Loads chunk j's gate logs of row bh: lf (log forget), li (log input,
// NEG where masked).
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

__device__ __forceinline__ void load_rows(const float* src, const Params& p, int b, int n,
                                          int s0, float* dst, float scale) {
  for (int i = threadIdx.x; i < CS * DH; i += NT) {
    const int r = i / DH, d = i % DH, s = s0 + r;
    dst[r * LD + d] = s < p.S ? src[((long)b * p.S + s) * p.INNER + n * DH + d] * scale : 0.f;
  }
}

// 2. Per-chunk state summaries.
__global__ void __launch_bounds__(NT) vil_chunk_summary(Params p) {
  __shared__ float ks[CS * LD], vs[CS * LD];
  __shared__ float bcs[CS], li[CS], gw[CS];
  __shared__ float s_mloc;
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / p.NH, n = bh % p.NH;
  const int tid = threadIdx.x, s0 = j * CS;

  load_gates(p, bh, s0, bcs, li);
  load_rows(p.k, p, b, n, s0, ks, 1.f);
  load_rows(p.v, p, b, n, s0, vs, 1.f);
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
  const int e = tid % DH, d0 = tid / DH;
  float acc[DH / 4];
#pragma unroll
  for (int i = 0; i < DH / 4; ++i) acc[i] = 0.f;
  for (int s = 0; s < CS; ++s) {
    const float vg = vs[s * LD + e] * gw[s];
#pragma unroll
    for (int i = 0; i < DH / 4; ++i) acc[i] += ks[s * LD + d0 + 4 * i] * vg;
  }
  float* kvo = p.kv + base * DH * DH;
#pragma unroll
  for (int i = 0; i < DH / 4; ++i) kvo[(d0 + 4 * i) * DH + e] = acc[i];
  if (tid < DH) {
    float s_ = 0.f;
    for (int s = 0; s < CS; ++s) s_ += ks[s * LD + tid] * gw[s];
    p.ksum[base * DH + tid] = s_;
  }
  if (tid == 0) {
    p.btot[base] = btot;
    p.mloc[base] = mloc;
  }
}

// 3. Sequential scan over chunks: writes the state carried into each chunk.
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

// 4. Per-chunk outputs h = (intra + inter) / normalizer.
__global__ void __launch_bounds__(NT) vil_chunk_output(Params p) {
  extern __shared__ float sm[];
  float* qs = sm;                // CS x LD, q / sqrt(DH)
  float* ks = qs + CS * LD;
  float* vs = ks + CS * LD;
  float* E = vs + CS * LD;       // CS x LD, decayed q k^T (row t, col s)
  float* Cs = E + CS * LD;       // DH x DH carried-in C
  float* nv = Cs + DH * DH;      // DH carried-in n
  float* bcs = nv + DH;          // CS cumsum of log f
  float* li = bcs + CS;          // CS log input gate
  float* cm = li + CS;           // CS running max of li - b
  float* stab = cm + CS;         // CS stabilizer
  float* av = stab + CS;         // CS inter-chunk scale
  float* den = av + CS;          // CS normalizer
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / p.NH, n = bh % p.NH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, s0 = j * CS;
  const long base = (long)bh * p.NS + j;

  load_gates(p, bh, s0, bcs, li);
  load_rows(p.q, p, b, n, s0, qs, 0.125f);  // 1 / sqrt(64)
  load_rows(p.k, p, b, n, s0, ks, 1.f);
  load_rows(p.v, p, b, n, s0, vs, 1.f);
  for (int i = tid; i < DH * DH; i += NT) Cs[i] = p.cprev[base * DH * DH + i];
  if (tid < DH) nv[tid] = p.nprev[base * DH + tid];
  const float m_prev = p.mprev[base];
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
    const int s = tid % CS, t0 = tid / CS;
    const float ws = li[s] - bcs[s];
    for (int i = 0; i < CS / 4; ++i) {
      const int t = t0 + 4 * i;
      float val = 0.f;
      if (s <= t) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < DH; ++d) dot += qs[t * LD + d] * ks[s * LD + d];
        val = dot * expf(ws + bcs[t] - stab[t]);
      }
      E[t * LD + s] = val;
    }
  }
  __syncthreads();

  for (int t = warp; t < CS; t += NW) {
    const float es = warp_sum(E[t * LD + lane] + E[t * LD + lane + 32]);
    const float qn = warp_sum(qs[t * LD + lane] * nv[lane] + qs[t * LD + lane + 32] * nv[lane + 32]);
    if (lane == 0) den[t] = fmaxf(fabsf(es + av[t] * qn), expf(-stab[t])) + p.eps;
  }
  __syncthreads();

  {
    const int e = tid % DH, t0 = tid / DH;
    for (int i = 0; i < CS / 4; ++i) {
      const int t = t0 + 4 * i, s_glob = s0 + t;
      float intra = 0.f, inter = 0.f;
      for (int s = 0; s <= t; ++s) intra += E[t * LD + s] * vs[s * LD + e];
#pragma unroll 16
      for (int d = 0; d < DH; ++d) inter += qs[t * LD + d] * Cs[d * DH + e];
      if (s_glob < p.S)
        p.h[((long)b * p.S + s_glob) * p.INNER + n * DH + e] = (intra + av[t] * inter) / den[t];
    }
  }
}

// 5. Outnorm + skip + SiLU(z) gate + proj_down + residual for TT tokens.
__global__ void __launch_bounds__(NT) vil_epilogue(Params p) {
  extern __shared__ float sm[];
  const int DIM = p.DIM, INNER = p.INNER, NH = p.NH;
  float* ys = sm;  // TT x INNER
  const long ntok = (long)p.B * p.S;
  const long tok0 = (long)blockIdx.x * TT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < TT * INNER; i += NT) {
    const long t = tok0 + i / INNER;
    ys[i] = t < ntok ? p.h[t * INNER + i % INNER] : 0.f;
  }
  __syncthreads();

  for (int job = warp; job < TT * NH; job += NW) {
    const int t = job / NH, n = job % NH;
    float* r = ys + t * INNER + n * DH;
    const float a0 = r[lane], a1 = r[lane + 32];
    const float mu = warp_sum(a0 + a1) / DH;
    const float d0 = a0 - mu, d1 = a1 - mu;
    const float inv = rsqrtf(warp_sum(d0 * d0 + d1 * d1) / DH + p.norm_eps);
    const long tk = tok0 + t;
    const bool ok = tk < ntok;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int cl = lane + 32 * half, c = n * DH + cl;
      const float hn = (half ? d1 : d0) * inv * p.nsc[c] + p.nbi[c];
      const float c_in = ok ? p.conv[tk * INNER + c] : 0.f;
      const float zz = ok ? p.zr[tk * INNER + c] : 0.f;
      r[cl] = (hn + p.skip[c] * c_in) * silu(zz);
    }
  }
  __syncthreads();

  for (int c = tid; c < DIM; c += NT) {
    float acc[TT];
    const float bias = p.bd[c];
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[t] = bias;
    for (int jj = 0; jj < INNER; ++jj) {
      const float w = p.wd[(long)jj * DIM + c];
#pragma unroll
      for (int t = 0; t < TT; ++t) acc[t] += ys[t * INNER + jj] * w;
    }
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      const long tk = tok0 + t;
      if (tk < ntok) p.out[tk * DIM + c] = acc[t] + p.xres[tk * DIM + c];
    }
  }
}

// Which function of the family a call computes.
enum Kind { LAYER = 0, CELL = 1, BLOCK = 2, CONV = 3 };

// The workspace's arrays, in this order, with their sizes in floats; the
// backward reads q/k/v/h, the gates and the carried-in states from it. z
// exists for the layer and the conv-fused layer only (the others stream it
// in or have none), the cell writes h to its output instead, and x_mlstm and
// conv_act exist for the conv-fused layer only (the others stream them in).
enum WsArray { WQ, WK, WV, WZ, WH, WIG, WFG, WKV, WCPREV, WKSUM, WNPREV, WBTOT, WMLOC, WMPREV,
               WXM, WCONV, kNumWs };

void workspace_layout(int kind, int B, int S, int INNER, int NH, long* off) {
  const long NS = (S + CS - 1) / CS;
  const long tok = (long)B * S, rows = (long)B * NH;
  const bool has_z = kind == LAYER || kind == CONV;
  const long size[kNumWs] = {tok * INNER, tok * INNER, tok * INNER,
                             has_z ? tok * INNER : 0, kind == CELL ? 0 : tok * INNER,
                             rows * S, rows * S, rows * NS * DH * DH, rows * NS * DH * DH,
                             rows * NS * DH, rows * NS * DH, rows * NS, rows * NS, rows * NS,
                             kind == CONV ? tok * INNER : 0, kind == CONV ? tok * INNER : 0};
  off[0] = 0;
  for (int i = 0; i < kNumWs; ++i) off[i + 1] = off[i] + size[i];
}

// Dynamic shared memory of the prologue: the layer's with its DIM, the
// cell's and the block's (no x rows, their own token tile) with DIM = 0.
size_t prologue_smem(int DIM, int INNER) {
  return sizeof(float) * (DIM ? TT * (DIM + 5 * (size_t)INNER) : TC * 5 * (size_t)INNER);
}

constexpr size_t kOutputSmem = sizeof(float) * (4 * CS * LD + DH * DH + DH + 6 * CS);

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
  if (kind == LAYER || kind == CONV) {
    p.zr = p.z;
    p.xres = p.x;
  }
  if (kind == CONV) {
    if (p.H <= 0 || p.W <= 0 || (long)p.H * p.W != p.S)
      return static_cast<int>(cudaErrorInvalidValue);
    p.xmw = ws + off[WXM];
    p.convw = ws + off[WCONV];
    p.conv = p.convw;
  }

  cudaError_t err;
  const auto prologue = kind == LAYER ? vil_prologue
                        : kind == CONV ? vil_conv_prologue : vil_cell_prologue;
  const size_t pro_smem = prologue_smem(kind == LAYER ? p.DIM : 0, p.INNER);
  const size_t head_smem = sizeof(float) * TT * (size_t)p.DIM;
  const size_t epi_smem = sizeof(float) * TT * (size_t)p.INNER;
  if ((err = cudaFuncSetAttribute(prologue, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)pro_smem)) != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(vil_chunk_output, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kOutputSmem)) != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(vil_epilogue, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)epi_smem)) != cudaSuccess) return err;

  const unsigned tok_blocks = (unsigned)((tok + TT - 1) / TT);
  const int pro_tile = kind == LAYER ? TT : TC;
  if (kind == CONV) {
    if ((err = cudaFuncSetAttribute(vil_conv_head, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)head_smem)) != cudaSuccess) return err;
    vil_conv_head<<<tok_blocks, NT, head_smem, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  prologue<<<(unsigned)((tok + pro_tile - 1) / pro_tile), NT, pro_smem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  vil_chunk_summary<<<dim3(p.NS, rows), NT, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  vil_state_scan<<<dim3(rows, DH * DH / NT), NT, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  vil_chunk_output<<<dim3(p.NS, rows), NT, kOutputSmem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (kind == CELL) return 0;
  vil_epilogue<<<tok_blocks, NT, epi_smem, st>>>(p);
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
// ig, fg, kv, cprev, ksum, nprev, btot, mloc, mprev, xm, conv into off[0..15]
// and its total size into off[16]; the wrapper allocates off[16] floats.
// `kind`: 0 the layer, 1 the cell (no z, no h), 2 the block (no z), 3 the
// conv-fused layer (the only one with xm and conv).
void vil_workspace_layout(int kind, int B, int S, int INNER, int NH, long* off) {
  workspace_layout(kind, B, S, INNER, NH, off);
}

// Dynamic shared memory the prologue needs (DIM = 0 for the cell and the
// block); the wrapper checks it against the device limit before launching.
long vil_prologue_smem(int DIM, int INNER) { return (long)prologue_smem(DIM, INNER); }

const char* vil_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each entry returns 0 on success, else the CUDA error code of the first
// failed step. Headwise weights arrive as (NH, DH_in, DH_out), gate kernels
// as (NH, 3*INNER).

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
