// Chunkwise mLSTM forward (K1) for NVIDIA Hopper, fp32, plain C interface.
//
// Replaces the TPU kernel `_kernel` (chunk step `_chunk_math`) in
// xlstm_yolo_tpu/kernels/mlstm_pallas.py, entered through
// `mlstm_chunkwise_pallas`. Given q/k/v (B, NH, S, DH) and the gate
// preacts (B, NH, S) it computes the stabilized mLSTM output h
// (B, NH, S, DH): log-space gates, the intra-chunk (q k^T * D) v term, the
// inter-chunk q C term on the carried state, and the normalizer
// max(|q n|, exp(-stab)) + eps.
//
// What bounds it on this card: per token and head the work is
// (CS + 1) DH + 2 DH^2 multiply-adds on 16 DH bytes of q, k, v and h, i.e.
// 24 (DH 64) to 72 (DH 256) op/B, above the fp32 ridge of 20 op/B, so the
// least time is set by operations. The products are fp32 FMAs on the CUDA
// cores (no tensor cores yet), so the fp32 rate is the bound it is held to.
//
// What the design does about it: the TPU kernel walked the chunks of a row
// in order on one core with (C, n, m) in scratch. Here the recurrence is
// split so that every SM has work, as in the ViL layer kernel:
//   1. chunk summaries (one CTA per (chunk, batch*head, value tile)): the
//      decayed k^T v and k sums of each chunk, its total decay and local max;
//   2. state scan (one CTA per (batch*head, 256 state entries)): the only
//      sequential part, NS steps of an elementwise update that turns the
//      summaries, in place, into the state carried into each chunk;
//   3. chunk outputs (one CTA per (chunk, batch*head, value tile)): the
//      intra-chunk term plus the carried-in term, normalized.
// Head dims 64, 128 and 256: a DH x DH fp32 state is 256 KB at DH 256, more
// than a block's shared memory, so the value dimension is tiled. A CTA owns
// all DH columns of q and k and a 64-column tile of v, C and h. Tiles
// need no exchange: the normalizer's inputs (q n and the row sums of the
// decay-weighted q k^T) depend on q, k and the gates only, and every tile
// recomputes them. In the output kernel the carried-in C tile is loaded
// over k's tile once q k^T is done, which keeps the CTA at 164 KB at DH 256.
//
// The stabilizer is the recurrent one per position, stab_t = max(b_t +
// cummax(logi - b)_t, m_prev + b_t), which does not depend on the chunk
// length: the result agrees with any other chunking up to rounding. The
// chunk length is 64. A sequence that is not a multiple of 64 is handled by
// masking the last chunk: missing positions load as zeros with an
// input-gate log of -1e30 and a forget-gate log of 0, so they add nothing
// to any valid position.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int CS = 64;        // chunk length
constexpr int VT = 64;        // value-tile width
constexpr int MAX_DH = 256;  // widest head dim taken
constexpr int LV = VT + 1;    // padded smem row stride of a value tile or E
constexpr int NT = 256;       // threads per CTA
constexpr int NW = NT / 32;   // warps per CTA
constexpr float NEG = -1e30f;

struct Params {
  const float* q;     // (B*NH, S, DH), unscaled
  const float* k;
  const float* v;
  const float* ig;    // (B*NH, S) gate preacts
  const float* fg;
  float* h;           // (B*NH, S, DH)
  // workspace
  float* kv;          // (B*NH, NS, DH, DH): chunk summaries, then carried-in C
  float* ksum;        // (B*NH, NS, DH): chunk k sums, then carried-in n
  float* btot;        // (B*NH, NS)
  float* mloc;        // (B*NH, NS)
  float* mprev;       // (B*NH, NS)
  int S, DH, NS, igate_exp;
  float qscale, eps;
};

__device__ __forceinline__ float logsigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

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

// Chunk j's gate logs of row bh: lf (log forget, 0 where masked), li (log
// input, NEG where masked).
__device__ __forceinline__ void load_gates(const Params& p, int bh, int s0, float* lf,
                                           float* li) {
  const int tid = threadIdx.x;
  if (tid < CS) {
    const int s = s0 + tid;
    const bool ok = s < p.S;
    const float fp = ok ? p.fg[(size_t)bh * p.S + s] : 0.f;
    const float ip = ok ? p.ig[(size_t)bh * p.S + s] : 0.f;
    lf[tid] = ok ? logsigmoid(fp) : 0.f;
    li[tid] = ok ? (p.igate_exp ? ip : logsigmoid(ip)) : NEG;
  }
}

// Rows s0..s0+CS of src (row bh, width p.DH), columns c0..c0+W, into dst with
// row stride ld, scaled; rows past S load as zeros.
__device__ __forceinline__ void load_rows(const float* src, const Params& p, int bh, int s0,
                                          int c0, int W, int ld, float* dst, float scale) {
  for (int i = threadIdx.x; i < CS * W; i += NT) {
    const int r = i / W, d = i % W, s = s0 + r;
    dst[r * ld + d] = s < p.S ? src[((size_t)bh * p.S + s) * p.DH + c0 + d] * scale : 0.f;
  }
}

// 1. Per-chunk state summaries for one value tile.
__global__ void __launch_bounds__(NT) mlstm_chunk_summary(Params p) {
  extern __shared__ float sm[];
  const int DH = p.DH, LD = DH + 1;
  float* ks = sm;               // CS x LD
  float* vs = ks + CS * LD;     // CS x LV, value tile
  float* bcs = vs + CS * LV;    // CS cumsum of log f
  float* li = bcs + CS;         // CS log input gate
  float* gw = li + CS;          // CS weights of each step in the chunk's summary
  __shared__ float s_mloc;
  const int j = blockIdx.x, bh = blockIdx.y, vt = blockIdx.z;
  const int tid = threadIdx.x, s0 = j * CS;

  load_gates(p, bh, s0, bcs, li);
  load_rows(p.k, p, bh, s0, 0, DH, LD, ks, 1.f);
  load_rows(p.v, p, bh, s0, vt * VT, VT, LV, vs, 1.f);
  __syncthreads();
  if (tid < 32) warp_scan64<false>(bcs);
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

  const size_t base = (size_t)bh * p.NS + j;
  const int e = tid % VT, d0 = tid / VT;  // d0 in 0..3
  float* kvo = p.kv + base * DH * DH + vt * VT;
  for (int dt = 0; dt < DH; dt += 64) {   // 64 rows of k^T v per pass
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    for (int s = 0; s < CS; ++s) {
      const float vg = vs[s * LV + e] * gw[s];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] += ks[s * LD + dt + d0 + 4 * i] * vg;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) kvo[(size_t)(dt + d0 + 4 * i) * DH + e] = acc[i];
  }
  if (vt == 0) {
    for (int d = tid; d < DH; d += NT) {
      float s_ = 0.f;
      for (int s = 0; s < CS; ++s) s_ += ks[s * LD + d] * gw[s];
      p.ksum[base * DH + d] = s_;
    }
    if (tid == 0) {
      p.btot[base] = btot;
      p.mloc[base] = mloc;
    }
  }
}

// 2. Sequential scan over chunks, in place: kv[j] and ksum[j] become the
// state carried into chunk j.
__global__ void __launch_bounds__(NT) mlstm_state_scan(Params p) {
  const int bh = blockIdx.x, tid = threadIdx.x, DH = p.DH;
  const size_t idx = (size_t)blockIdx.y * NT + tid;  // entry of C
  const bool own_n = idx < (size_t)DH;
  const bool own_m = idx == 0;
  const size_t row = (size_t)bh * p.NS, DD = (size_t)DH * DH;
  float c = 0.f, nn = 0.f, m = 0.f;
  float bt = p.btot[row], ml = p.mloc[row], kvv = p.kv[row * DD + idx];
  float ks = own_n ? p.ksum[row * DH + idx] : 0.f;
  for (int j = 0; j < p.NS; ++j) {
    const size_t base = row + j;
    float nbt = 0.f, nml = 0.f, nkv = 0.f, nks = 0.f;
    if (j + 1 < p.NS) {  // prefetch the next chunk's summary
      nbt = p.btot[base + 1];
      nml = p.mloc[base + 1];
      nkv = p.kv[(base + 1) * DD + idx];
      if (own_n) nks = p.ksum[(base + 1) * DH + idx];
    }
    p.kv[base * DD + idx] = c;
    if (own_n) p.ksum[base * DH + idx] = nn;
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

// 3. Per-chunk outputs h = (intra + inter) / normalizer for one value tile.
__global__ void __launch_bounds__(NT) mlstm_chunk_output(Params p) {
  extern __shared__ float sm[];
  const int DH = p.DH, LD = DH + 1;
  float* qs = sm;                // CS x LD, q / sqrt(DH)
  float* ks = qs + CS * LD;      // CS x LD; then the carried-in C tile, DH x VT
  float* vs = ks + CS * LD;      // CS x LV, value tile
  float* E = vs + CS * LV;       // CS x LV, decayed q k^T (row t, col s)
  float* nv = E + CS * LV;       // DH carried-in n
  float* bcs = nv + DH;          // CS cumsum of log f
  float* li = bcs + CS;          // CS log input gate
  float* cm = li + CS;           // CS running max of li - b
  float* stab = cm + CS;         // CS stabilizer
  float* av = stab + CS;         // CS inter-chunk scale
  float* den = av + CS;          // CS normalizer
  const int j = blockIdx.x, bh = blockIdx.y, vt = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, s0 = j * CS;
  const size_t base = (size_t)bh * p.NS + j;

  load_gates(p, bh, s0, bcs, li);
  load_rows(p.q, p, bh, s0, 0, DH, LD, qs, p.qscale);
  load_rows(p.k, p, bh, s0, 0, DH, LD, ks, 1.f);
  load_rows(p.v, p, bh, s0, vt * VT, VT, LV, vs, 1.f);
  for (int d = tid; d < DH; d += NT) nv[d] = p.ksum[base * DH + d];
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
      E[t * LV + s] = val;
    }
  }
  __syncthreads();

  // k is done: its tile now holds the carried-in C[:, vt tile]
  float* Cs = ks;
  {
    const float* csrc = p.kv + base * DH * DH + vt * VT;
    for (int i = tid; i < DH * VT; i += NT) Cs[i] = csrc[(size_t)(i / VT) * DH + i % VT];
  }
  for (int t = warp; t < CS; t += NW) {
    float es = E[t * LV + lane] + E[t * LV + lane + 32], qn = 0.f;
    for (int d = lane; d < DH; d += 32) qn += qs[t * LD + d] * nv[d];
    es = warp_sum(es);
    qn = warp_sum(qn);
    if (lane == 0) den[t] = fmaxf(fabsf(es + av[t] * qn), expf(-stab[t])) + p.eps;
  }
  __syncthreads();

  {
    const int e = tid % VT, t0 = tid / VT;
    for (int i = 0; i < CS / 4; ++i) {
      const int t = t0 + 4 * i, s_glob = s0 + t;
      float intra = 0.f, inter = 0.f;
      for (int s = 0; s <= t; ++s) intra += E[t * LV + s] * vs[s * LV + e];
#pragma unroll 16
      for (int d = 0; d < DH; ++d) inter += qs[t * LD + d] * Cs[d * VT + e];
      if (s_glob < p.S)
        p.h[((size_t)bh * p.S + s_glob) * DH + vt * VT + e] = (intra + av[t] * inter) / den[t];
    }
  }
}

size_t summary_smem(int DH) { return sizeof(float) * (CS * (DH + 1) + CS * LV + 3 * CS); }

size_t output_smem(int DH) {
  return sizeof(float) * (2 * CS * (DH + 1) + 2 * CS * LV + DH + 6 * CS);
}

}  // namespace

extern "C" {

const char* mlstm_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Writes the offsets (in floats) of the workspace's arrays for B*NH rows of
// length S, head dim DH, into off[0..4] and its total size into off[5]; the
// wrapper allocates off[5] floats. After a call the arrays hold, per row and
// chunk of 64 steps, the state carried INTO the chunk and the chunk's gate
// summaries, which the chunkwise backward reads: C (rows, NS, DH, DH) as
// [k index][v index], n (rows, NS, DH), btot (total log decay), mloc (local
// max) and m (the stabilizer carried in), each (rows, NS).
void mlstm_fwd_workspace_layout(int rows, int S, int DH, long* off) {
  const long n = (long)rows * ((S + CS - 1) / CS);
  const long size[5] = {n * DH * DH, n * DH, n, n, n};
  off[0] = 0;
  for (int i = 0; i < 5; ++i) off[i + 1] = off[i] + size[i];
}

// q/k/v (rows, S, DH), gates (rows, S) -> h (rows, S, DH), rows = B * NH, all
// contiguous fp32; ws as mlstm_fwd_workspace_layout says. Returns 0 on
// success, else the CUDA error code of the first failed step
// (cudaErrorInvalidValue for an unsupported shape).
int mlstm_fwd_f32(const float* q, const float* k, const float* v, const float* ig,
                  const float* fg, float* h, float* ws, int rows, int S, int DH, int igate_exp,
                  float eps, void* stream) {
  if ((DH != 64 && DH != 128 && DH != 256) || rows <= 0 || rows > 65535 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p;
  p.q = q; p.k = k; p.v = v; p.ig = ig; p.fg = fg; p.h = h;
  p.S = S; p.DH = DH; p.NS = (S + CS - 1) / CS;
  p.igate_exp = igate_exp; p.qscale = 1.f / sqrtf((float)DH); p.eps = eps;
  long off[6];
  mlstm_fwd_workspace_layout(rows, S, DH, off);
  p.kv = ws + off[0];
  p.ksum = ws + off[1];
  p.btot = ws + off[2];
  p.mloc = ws + off[3];
  p.mprev = ws + off[4];

  cudaError_t err;
  const size_t sum_smem = summary_smem(DH), out_smem = output_smem(DH);
  // raise the kernels' shared-memory limit once per device, to the widest head dim's need
  static int configured = -1;
  int dev;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev != configured) {
    if ((err = cudaFuncSetAttribute(mlstm_chunk_summary,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)summary_smem(MAX_DH))) != cudaSuccess) return err;
    if ((err = cudaFuncSetAttribute(mlstm_chunk_output,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)output_smem(MAX_DH))) != cudaSuccess) return err;
    configured = dev;
  }
  const dim3 chunks(p.NS, rows, DH / VT);
  mlstm_chunk_summary<<<chunks, NT, sum_smem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_state_scan<<<dim3(rows, DH * DH / NT), NT, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_chunk_output<<<chunks, NT, out_smem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return 0;
}

}  // extern "C"
