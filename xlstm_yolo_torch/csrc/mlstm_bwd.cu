// Chunkwise mLSTM backward (K2) for NVIDIA Hopper, fp32, plain C interface.
//
// Replaces the TPU kernel `_kernel` of xlstm_yolo_tpu/kernels/mlstm_pallas_bwd.py
// (entered through `mlstm_chunkwise_pallas_bwd_t`), whose per-chunk math is
// `_chunk_grads`. Gradients follow the frozen-stabilizer convention of
// `mlstm_chunkwise_bwd_ref`: the stabilizers are constants, so dq/dk/dv are
// exact and the gate gradients drop the normalizer-floor terms.
//
// Inputs, per head row r = b*NH + n: q, k, v and the output gradient dh in the
// ViL layer's natural (B, S, INNER) layout (q unscaled, as the layer kernel
// stores it), gate preacts (B*NH, S), and the carry-in state of every chunk
// as the layer kernel's forward leaves it in its workspace: C (B*NH, NS, DH,
// DH), n (B*NH, NS, DH), and the scalars m_prev, btot (total log decay) and
// m_loc (local max) (B*NH, NS). Outputs dq, dk, dv (B, S, INNER) and the gate
// preact gradients di, df (B*NH, S).
//
// What the design does about the TPU kernel's shape: the TPU kernel walks the
// chunks in reverse on one core with the (dC, dn) carry in VMEM. The carry-in
// terms dC_attn_j = sum_t a_t q_t dA_t^T and dn_attn_j depend only on chunk
// j's own data and its forward carry-in state, never on the reverse carry, so
// the reverse carry dC_{j-1} = dC_attn_j + exp(ld_old_j) dC_j is an
// elementwise linear scan. The backward therefore runs as three launches:
//   A. per chunk (one CTA per (chunk, head row)): recompute the forward
//      internals (decay matrix, normalizer, h), then every gradient that does
//      not need the reverse carry: dq in full, the intra-chunk parts of dk and
//      dv, the in-chunk gate terms, and dC_attn / dn_attn;
//   B. reverse scan (one CTA per (head row, 256 state entries)): NS steps of
//      an elementwise update, replacing dC_attn_j by the carry dC_j in place;
//   C. per chunk: the carry terms (the k v^T summary's gradient into dk and
//      dv, the gate weights' terms, dbtot), then the in-chunk reverse cumsum
//      that turns d(cumsum log f) into dlogf.
// What bounds it on this card: per chunk and head it does 3 CS (CS+1) DH +
// 5 CS DH^2 multiply-adds against 7 CS DH floats of activations, 37
// operations per byte at DH 64: above the fp32 CUDA cores' ridge (67 TFLOP/s
// over 3.35 TB/s = 20 op/B), so operations bound it there; below that of
// the tensor cores at three TF32 passes (165 TFLOP/s: 49 op/B), where the
// bytes would.
//
// What the design does about it: every product runs on the tensor cores
// through the shared 3xTF32 tile product (tile_mma.cuh, fp32 accuracy),
// with operands staged by cp.async in 64 x 64 tiles: in A the causal q k^T,
// the recomputed E v and q C, E^T dA, dA v^T, dqk k, dA C^T, dqk^T q and
// (a q)^T dA; in C k dC and dC v^T. Stage A keeps D and E in one tile (the
// decay is rebuilt from the gate logs where a product needs it), so it
// holds six tiles, 109 KB, and two CTAs share an SM; C holds three.
// Gate math, stabilizers, exp/log, normalizer and scans stay fp32 on the
// CUDA cores.
//
// The chunk is fixed at 64. At head dim 64 (the ViL family's and the small
// language model's) A and C are the kernels above, one tile product per
// head. Head dims 128 and 256 (the chunkwise forward K1 takes both) run
// the same three stages in `bwd_wide_local` and `bwd_wide_carry`: one CTA
// per (chunk, head row) still, walking the head in 64-wide slices. A
// chunk's q, k, v, dh and carried C at DH 256 are 4 x 64 KB and 256 KB, more
// than a CTA's 227 KB of shared memory, so the CTA stages two 64 x 64
// operand tiles at a time (a q or k slice c, a v or dh value tile r, the
// carried C's block C[c, r]) and holds the chunk's own CS x CS matrix (E,
// then dqk) throughout: five tiles, 92 KB at every head dim, two CTAs an
// SM. Every contraction over a head dimension becomes a sum of 64-deep tile
// products over its slices, accumulated in registers (q k^T and q n over
// c; q C[:, r] over c for the recomputed h; dA v^T over r; dA C[c, :]^T
// over r; k dC[:, r] over c and v dC[c, :]^T over r in C). Row scalings by
// the normalizer (dA = dh / normalizer) are folded into the products'
// k-scale or applied to their outputs, so dA is never materialized. The
// chunks of the language model (512 chunk-heads at batch 8, S 1024) fill
// the card without a cluster: no product waits on a peer. B is unchanged;
// it is elementwise at any DH.
// A sequence that is not a chunk multiple is masked in its last chunk
// exactly as the forward masks it: missing steps load zeros with an
// input-gate log of -1e30 and a forget-gate log of 0; nothing is written
// for them.
//
// K2 in bf16 (mlstm_bwd_bf16, head dim 64; bwd16_local, the reverse scan
// above, bwd16_carry): the TPU kernel's default arithmetic,
// `mxu_dtype="bfloat16"`, on the bf16 q, k, v the bf16 ViL layer saves (dh,
// the gates and the carry states fp32, as the JAX backward takes them).
// What bounds it on this card: its products are bf16 (989 TFLOP/s), so the
// bytes of q, k, v, dh, the carry states and the gradients bound it; a
// design that widens q, k, v into fp32 tiles and reads every operand value
// with a 4-byte load and a rounding at each product spends its time there.
// What the design does about it: every product reads bf16 tiles through
// ldmatrix into m16n8k16 (tile_bf16.cuh), q, k, v copied in as they are by
// 16-byte cp.async, the fp32 tiles (dh; the carried C, and in C the carry
// dC and C_prev) by cp.async as well, and every other operand written to
// shared memory once as the bf16 value `_chunk_grads` rounds: the carried
// C, E, q_inter (q a / sqrt(DH)), dA = dh / normalizer, dqk, and in C the
// carry dC d_new and the gate-weighted k, each rounded once after its
// scale. E stays fp32 in the registers of its product for the gate sums and
// the normalizer, which read it unrounded. Stage A holds seven bf16 tiles
// and dh in fp32, 85 KB (two CTAs an SM), C four bf16 tiles and two fp32
// ones, into which A's fp32 partials of dk and dv are copied during C's
// products (72 KB, three CTAs an SM). dq, dk, dv are written in bf16 once
// complete, as the JAX kernel returns them: dq in A, dk and dv in C. di and
// df stay fp32. The stabilizer stays frozen, as in the fp32 kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include "tile_bf16.cuh"
#include "tile_mma.cuh"

namespace {

using tile::Acc;
using tile::LDS;
using bf16 = __nv_bfloat16;

constexpr int CS = 64;             // chunk length
constexpr int NT = tile::THREADS;  // threads per CTA
constexpr int NW = NT / 32;        // warps per CTA
constexpr int TF = tile::FLOATS;   // floats of one 64 x 64 shared tile
constexpr float NEG = -1e30f;

struct Params {
  const float* q;      // (B, S, INNER), unscaled
  const float* k;
  const float* v;
  const float* dh;     // (B, S, INNER)
  const float* ig;     // (B*NH, S) gate preacts
  const float* fg;
  const float* cprev;  // (B*NH, NS, DH, DH) carried-in C, [k index][v index]
  const float* nprev;  // (B*NH, NS, DH)
  const float* mprev;  // (B*NH, NS)
  const float* btot;   // (B*NH, NS)
  const float* mloc;   // (B*NH, NS)
  float* dq;           // (B, S, INNER)
  float* dk;
  float* dv;
  float* di;           // (B*NH, S); holds d logi's in-chunk part between A and C
  float* df;           // (B*NH, S); holds d b's in-chunk part between A and C
  float* dcs;          // (B*NH, NS, DH, DH): dC_attn after A, the carry dC after B
  float* dns;          // (B*NH, NS, DH)
  int B, S, INNER, NH, NS, igate_exp;
  float eps;
  // the bf16 entry: q, k, v in and dq, dk, dv out in bf16 (dk and dv then
  // point at fp32 partials in the workspace)
  const bf16* q16;
  const bf16* k16;
  const bf16* v16;
  bf16* dq16;
  bf16* dk16;
  bf16* dv16;
};

__device__ __forceinline__ float logsigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

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
    const float fp = ok ? p.fg[(long)bh * p.S + s] : 0.f;
    const float ip = ok ? p.ig[(long)bh * p.S + s] : 0.f;
    lf[tid] = ok ? logsigmoid(fp) : 0.f;
    li[tid] = ok ? (p.igate_exp ? ip : logsigmoid(ip)) : NEG;
  }
}

// The chunk's decay scalars from the forward's carry scalars: log of the
// decay of the carried-in state (ld_old) and of the chunk summary (ld_new).
__device__ __forceinline__ void chunk_decays(const Params& p, long base, float* ld_old,
                                             float* ld_new) {
  const float bt = p.btot[base], mp = p.mprev[base], ml = p.mloc[base];
  const float mn = fmaxf(bt + mp, ml);
  *ld_old = bt + mp - mn;
  *ld_new = ml - mn;
}

// The warp's row sums (rows Acc::row(0) and Acc::row(2)) of a quantity it
// accumulated per thread in pr: quad sums into part[column half][row].
__device__ __forceinline__ void put_row_sums(float (&pr)[2], float* part) {
  const float r0 = tile::quad_sum(pr[0]), r1 = tile::quad_sum(pr[1]);
  if ((threadIdx.x & 3) == 0) {
    part[(threadIdx.x >> 7) * CS + Acc::row(0)] = r0;
    part[(threadIdx.x >> 7) * CS + Acc::row(2)] = r1;
  }
}

// Writes acc * scale to rows s0 + row < S of the (B, S, INNER) array dst at
// head column offset hcol, adding what is there when ADD.
template <bool ADD>
__device__ __forceinline__ void put_rows(const Acc& a, float* dst, const Params& p, int b,
                                         int s0, int hcol, float scale) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 2 * hh, t = Acc::row(r);
      if (s0 + t < p.S) {
        float2* o = reinterpret_cast<float2*>(dst + ((long)b * p.S + s0 + t) * p.INNER + hcol +
                                              Acc::col(j, r));
        float2 v = make_float2(a.c[j][r] * scale, a.c[j][r + 1] * scale);
        if (ADD) {
          const float2 w = *o;
          v.x += w.x;
          v.y += w.y;
        }
        *o = v;
      }
    }
}

// Writes acc * scale in bf16 to rows s0 + row < S of the (B, S, INNER)
// array dst at head column hcol.
__device__ __forceinline__ void put_rows_bf16(const Acc& a, bf16* dst, const Params& p, int b,
                                              int s0, int hcol, float scale) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 2 * hh, t = Acc::row(r);
      if (s0 + t < p.S)
        *reinterpret_cast<__nv_bfloat162*>(dst + ((long)b * p.S + s0 + t) * p.INNER + hcol +
                                           Acc::col(j, r)) =
            __floats2bfloat162_rn(a.c[j][r] * scale, a.c[j][r + 1] * scale);
    }
}

// Writes acc + the fp32 partial in the shared tile `part` (row stride LDS)
// in bf16 to rows s0 + row < S of the (B, S, INNER) array dst at head
// column hcol.
__device__ __forceinline__ void put_tile_rows_bf16(const Acc& a, bf16* dst, const float* part,
                                                   const Params& p, int b, int s0, int hcol) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 2 * hh, t = Acc::row(r), c = Acc::col(j, r);
      if (s0 + t < p.S) {
        const float2 w = *reinterpret_cast<const float2*>(part + t * LDS + c);
        *reinterpret_cast<__nv_bfloat162*>(dst + ((long)b * p.S + s0 + t) * p.INNER + hcol + c) =
            __floats2bfloat162_rn(a.c[j][r] + w.x, a.c[j][r + 1] + w.y);
      }
    }
}

// A. Per chunk: forward recompute and the carry-independent gradients.
template <int DH>
__global__ void __launch_bounds__(NT, 2) bwd_chunk_local(Params p) {
  static_assert(DH == tile::T, "one 64 x 64 tile product per head");
  constexpr float QS = 0.125f;   // 1 / sqrt(DH)
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                // q (unscaled); at the end q a_t / sqrt(DH)
  float* ks = qs + TF;
  float* vs = ks + TF;
  float* dA = vs + TF;           // dh, then dh / normalizer
  float* Cs = dA + TF;           // carried-in C [d][e]
  float* E = Cs + TF;            // row t col s: (q_t . k_s / sqrt(DH)) D_ts; later dqk = de D
  float* nv = E + TF;            // DH carried-in n
  float* bcs = nv + DH;          // CS cumsum of log f
  float* li = bcs + CS;          // CS log input gate
  float* cm = li + CS;           // CS running max of li - b; then aq
  float* stab = cm + CS;         // CS stabilizer
  float* av = stab + CS;         // CS inter-chunk scale a_t
  float* nrm = av + CS;          // CS normalizer
  float* row = nrm + CS;         // CS unnormalized row sum (its sign and size)
  float* dR = row + CS;          // CS
  float* rpart = dR + CS;        // 2 x CS row partials of the two column halves
  float* cpart = rpart + 2 * CS; // 4 x CS column partials of the four row quarters
  float* dbv = cpart + 4 * CS;   // CS d b, in-chunk part
  float* dli = dbv + CS;         // CS d log i, in-chunk part
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / p.NH, n = bh % p.NH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, s0 = j * CS;
  const long base = (long)bh * p.NS + j;
  const int nrows = p.S - s0 < CS ? p.S - s0 : CS;
  const long hoff = ((long)b * p.S + s0) * p.INNER + (long)n * DH;
  // the decay D_ts of a causal entry (s <= t)
  auto decay = [&](int t, int s) { return expf(li[s] - bcs[s] + bcs[t] - stab[t]); };

  float* aq = cm;                // CS a_t / sqrt(DH), the row scale of q_inter
  tile::load_async<CS, DH>(qs, LDS, p.q + hoff, p.INNER, nrows, DH);
  tile::load_async<CS, DH>(ks, LDS, p.k + hoff, p.INNER, nrows, DH);
  tile::load_async<CS, DH>(vs, LDS, p.v + hoff, p.INNER, nrows, DH);
  tile::load_async<CS, DH>(dA, LDS, p.dh + hoff, p.INNER, nrows, DH);
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
    const float inter_log = m_prev + bcs[tid];
    const float st = fmaxf(bcs[tid] + cm[tid], inter_log);
    stab[tid] = st;
    av[tid] = expf(inter_log - st);
  }
  __syncthreads();
  if (tid < CS) aq[tid] = av[tid] * QS;  // cm is not read again

  // E = (q k^T / sqrt(DH)) D, causal
  {
    Acc s;
    s.zero();
    tile::mma<false, true, tile::OUT_LOWER>(s, qs, LDS, ks, LDS, DH);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = Acc::row(r), c = Acc::col(jj, r);
        E[t * LDS + c] = c <= t ? s.c[jj][r] * QS * decay(t, c) : 0.f;
      }
  }
  __syncthreads();

  // normalizer
  for (int t = warp; t < CS; t += NW) {
    const float es = warp_sum(E[t * LDS + lane] + E[t * LDS + lane + 32]);
    const float qn = QS * warp_sum(qs[t * LDS + lane] * nv[lane] +
                                   qs[t * LDS + lane + 32] * nv[lane + 32]);
    if (lane == 0) {
      const float r = es + av[t] * qn;
      row[t] = r;
      nrm[t] = fmaxf(fabsf(r), expf(-stab[t])) + p.eps;
    }
  }
  __syncthreads();

  // h (recomputed), then dN_t = -sum_e dh h / normalizer
  {
    Acc intra, inter;
    intra.zero();
    inter.zero();
    tile::mma<false, false, tile::K_LE_M>(intra, E, LDS, vs, LDS, CS);
    tile::mma<false, false>(inter, qs, LDS, Cs, LDS, DH, nullptr, aq);
    float pr[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = Acc::row(r), e = Acc::col(jj, r);
        const float h = (intra.c[jj][r] + inter.c[jj][r]) / nrm[t];
        pr[r >> 1] += dA[t * LDS + e] * h;
      }
    put_row_sums(pr, rpart);
  }
  __syncthreads();
  if (tid < CS) {
    const float dN = -(rpart[tid] + rpart[CS + tid]) / nrm[tid];
    const float r = row[tid];
    dR[tid] = fabsf(r) > expf(-stab[tid]) ? (r > 0.f ? dN : (r < 0.f ? -dN : 0.f)) : 0.f;
  }
  for (int i = tid; i < CS * DH; i += NT) {
    const int t = i / DH;
    dA[t * LDS + i % DH] /= nrm[t];
  }
  __syncthreads();

  // dv (in-chunk part) = E^T dA
  {
    Acc a;
    a.zero();
    tile::mma<true, false, tile::K_GE_M>(a, E, LDS, dA, LDS, CS);
    put_rows<false>(a, p.dv, p, b, s0, n * DH, 1.f);
  }
  __syncthreads();  // E is overwritten below

  // de = dA v^T + dR (causal); G = de E gives the gate sums; E <- dqk = de D
  {
    Acc d;
    d.zero();
    tile::mma<false, true, tile::OUT_LOWER>(d, dA, LDS, vs, LDS, DH);
    float rs[2] = {0.f, 0.f};
    float cs[4][2];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      cs[jj][0] = 0.f;
      cs[jj][1] = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = Acc::row(r), s = Acc::col(jj, r);
        float g = 0.f, dqk = 0.f;
        if (s <= t) {
          const float de = d.c[jj][r] + dR[t];
          g = de * E[t * LDS + s];
          dqk = de * decay(t, s);
        }
        E[t * LDS + s] = dqk;
        rs[r >> 1] += g;
        cs[jj][r & 1] += g;
      }
    }
    put_row_sums(rs, rpart);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        float c = cs[jj][par];
        c += __shfl_xor_sync(0xffffffffu, c, 4);
        c += __shfl_xor_sync(0xffffffffu, c, 8);
        c += __shfl_xor_sync(0xffffffffu, c, 16);
        if (lane < 4) cpart[(warp & 3) * CS + Acc::col(jj, par)] = c;
      }
  }
  __syncthreads();
  if (tid < CS) {  // db[t] = rowsum G - colsum G, dlogi[s] = colsum G
    const float colsum = cpart[tid] + cpart[CS + tid] + cpart[2 * CS + tid] + cpart[3 * CS + tid];
    dli[tid] = colsum;
    dbv[tid] = rpart[tid] + rpart[CS + tid] - colsum;
  }
  __syncthreads();

  // dq = (dqk k + (dA C^T + dR n) a_t) / sqrt(DH); inter d b_t = a_t sum_d dqt q / sqrt(DH)
  {
    Acc a, c;
    a.zero();
    c.zero();
    tile::mma<false, false, tile::K_LE_M>(a, E, LDS, ks, LDS, CS);
    tile::mma<false, true>(c, dA, LDS, Cs, LDS, DH);
    float pr[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = Acc::row(r), d = Acc::col(jj, r);
        const float dqt = c.c[jj][r] + dR[t] * nv[d];
        pr[r >> 1] += dqt * qs[t * LDS + d];
        a.c[jj][r] += dqt * av[t];
      }
    put_row_sums(pr, rpart);
    put_rows<false>(a, p.dq, p, b, s0, n * DH, QS);
  }
  __syncthreads();
  if (tid < CS) dbv[tid] += av[tid] * QS * (rpart[tid] + rpart[CS + tid]);

  // dk (in-chunk part) = dqk^T q / sqrt(DH)
  {
    Acc a;
    a.zero();
    tile::mma<true, false, tile::K_GE_M>(a, E, LDS, qs, LDS, CS);
    put_rows<false>(a, p.dk, p, b, s0, n * DH, QS);
  }
  __syncthreads();  // q is rescaled below
  for (int i = tid; i < CS * DH; i += NT) {
    const int t = i / DH;
    qs[t * LDS + i % DH] *= av[t] * QS;
  }
  __syncthreads();

  // dC_attn[d][e] = sum_t a_t q_td dA_te / sqrt(DH); dn_attn[d] = sum_t dR_t a_t q_td / sqrt(DH)
  {
    Acc a;
    a.zero();
    tile::mma<true, false>(a, qs, LDS, dA, LDS, CS);
    float* dco = p.dcs + base * DH * DH;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 2 * hh;
        *reinterpret_cast<float2*>(dco + Acc::row(r) * DH + Acc::col(jj, r)) =
            make_float2(a.c[jj][r], a.c[jj][r + 1]);
      }
    if (tid < DH) {
      float acc = 0.f;
      for (int t = 0; t < CS; ++t) acc += dR[t] * qs[t * LDS + tid];
      p.dns[base * DH + tid] = acc;
    }
  }
  if (tid < CS) {
    const int sg = s0 + tid;
    if (sg < p.S) {
      p.df[(long)bh * p.S + sg] = dbv[tid];
      p.di[(long)bh * p.S + sg] = dli[tid];
    }
  }
}

// B. Reverse scan over chunks: dC_attn_j is replaced in place by the carry
// dC_j (the gradient with respect to the state chunk j leaves behind). The
// walk is elementwise and its bytes stream from device memory once; a thread
// keeps the next PF chunks' entries (and their decay scalars) in flight in
// registers, so the loads are not serialized behind each chunk's update.
template <int DH>
__global__ void __launch_bounds__(NT) bwd_state_scan(Params p) {
  constexpr int PF = 4;  // chunks in flight
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int idx = blockIdx.y * NT + tid;  // entry of C
  const bool own_n = blockIdx.y == 0 && tid < DH;
  const long row = (long)bh * p.NS;
  // chunk j's entry, its dn_attn entry (own_n) and its decay of the carried state
  float v[PF], w[PF], dold[PF];
  auto fetch = [&](int k, int j) {
    if (j < 0) return;
    const long base = row + j;
    v[k] = p.dcs[base * DH * DH + idx];
    w[k] = own_n ? p.dns[base * DH + tid] : 0.f;
    float ld_new;
    chunk_decays(p, base, &dold[k], &ld_new);
  };
#pragma unroll
  for (int k = 0; k < PF; ++k) fetch(k, p.NS - 1 - k);
  float c = 0.f, nn = 0.f;
  for (int j = p.NS - 1; j >= 0; --j) {
    const float dca = v[0], dna = w[0], d = expf(dold[0]);
#pragma unroll
    for (int k = 0; k + 1 < PF; ++k) {
      v[k] = v[k + 1];
      w[k] = w[k + 1];
      dold[k] = dold[k + 1];
    }
    fetch(PF - 1, j - PF);
    const long base = row + j;
    p.dcs[base * DH * DH + idx] = c;
    c = dca + c * d;
    if (own_n) {
      p.dns[base * DH + tid] = nn;
      nn = dna + nn * d;
    }
  }
}

// C. Per chunk: the terms that need the reverse carry, then d log f. The
// carry's products read dC d_new (scaled in shared memory) and, for dv,
// the gate-weighted k (scaled in the fragment load).
template <int DH>
__global__ void __launch_bounds__(NT, 2) bwd_chunk_carry(Params p) {
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                // CS x DH
  float* vs = ks + TF;           // CS x DH
  float* dC = vs + TF;           // DH x DH, the carry dC_j
  __shared__ float bcs[CS], li[CS], gw[CS], dks[DH], db[CS], rev[CS], rpart[2 * CS], red[NW];
  __shared__ float gsum[2];
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / p.NH, n = bh % p.NH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, s0 = j * CS;
  const long base = (long)bh * p.NS + j;
  const int nrows = p.S - s0 < CS ? p.S - s0 : CS;
  const long hoff = ((long)b * p.S + s0) * p.INNER + (long)n * DH;
  float ld_old, ld_new;
  chunk_decays(p, base, &ld_old, &ld_new);
  const float d_new = expf(ld_new), d_old = expf(ld_old);
  const float btot = p.btot[base], mloc = p.mloc[base];

  tile::load_async<CS, DH>(ks, LDS, p.k + hoff, p.INNER, nrows, DH);
  tile::load_async<CS, DH>(vs, LDS, p.v + hoff, p.INNER, nrows, DH);
  tile::load_async<DH, DH>(dC, LDS, p.dcs + base * DH * DH, DH, DH, DH);
  tile::cp_async_commit();
  load_gates(p, bh, s0, bcs, li);
  const float* dcn = p.dcs + base * DH * DH;
  const float* cpv = p.cprev + base * DH * DH;
  float acc = 0.f;  // sum dC_j * C_prev (+ dn_j * n_prev)
  for (int i = tid; i < DH * DH; i += NT) acc += dcn[i] * cpv[i];
  if (tid < DH) {
    const float g = p.dns[base * DH + tid];
    dks[tid] = g * d_new;
    acc += g * p.nprev[base * DH + tid];
  }
  acc = warp_sum(acc);
  if (lane == 0) red[warp] = acc;
  tile::cp_async_wait_all();
  __syncthreads();
  if (tid < 32) warp_scan64<false>(bcs);
  __syncthreads();
  if (tid < CS) gw[tid] = expf(li[tid] + (btot - bcs[tid]) - mloc);
  for (int i = tid; i < DH * DH; i += NT) dC[(i / DH) * LDS + i % DH] *= d_new;
  __syncthreads();

  // dv += (gw k) (d_new dC)
  {
    Acc a;
    a.zero();
    tile::mma<false, false>(a, ks, LDS, dC, LDS, DH, nullptr, gw);
    put_rows<true>(a, p.dv, p, b, s0, n * DH, 1.f);
  }
  // dk_state = v (d_new dC)^T + dksum; dk += dk_state gw; dgw = sum_d dk_state k
  {
    Acc a;
    a.zero();
    tile::mma<false, true>(a, vs, LDS, dC, LDS, DH);
    float pr[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int s = Acc::row(r), d = Acc::col(jj, r);
        const float st = a.c[jj][r] + dks[d];
        pr[r >> 1] += st * ks[s * LDS + d];
        a.c[jj][r] = st * gw[s];
      }
    put_row_sums(pr, rpart);
    put_rows<true>(a, p.dk, p, b, s0, n * DH, 1.f);
  }
  __syncthreads();

  // gate terms; d btot folds into the chunk's last slot of d b
  float gi = 0.f;
  if (tid < CS) {
    const int sg = s0 + tid;
    gi = (rpart[tid] + rpart[CS + tid]) * gw[tid];
    const float dbp = sg < p.S ? p.df[(long)bh * p.S + sg] : 0.f;
    db[tid] = dbp - gi;
  }
  const float gs = warp_sum(gi);  // warps 0 and 1 hold the chunk's gi
  if (lane == 0 && warp < 2) gsum[warp] = gs;
  __syncthreads();
  if (tid == 0) {
    float dbt = 0.f;
    for (int w = 0; w < NW; ++w) dbt += red[w];
    db[CS - 1] += dbt * d_old + gsum[0] + gsum[1];
  }
  __syncthreads();
  // reverse inclusive cumsum: dlogf_t = sum_{s >= t} db_s
  if (tid < CS) rev[tid] = db[CS - 1 - tid];
  __syncthreads();
  if (tid < 32) warp_scan64<false>(rev);
  __syncthreads();
  if (tid < CS) {
    const int sg = s0 + tid;
    if (sg < p.S) {
      const long o = (long)bh * p.S + sg;
      const float dlogf = rev[CS - 1 - tid];
      const float dli = p.di[o] + gi;
      p.df[o] = dlogf * sigmoid(-p.fg[o]);
      p.di[o] = p.igate_exp ? dli : dli * sigmoid(-p.ig[o]);
    }
  }
}

// ---- K2 in bf16: the bwd16_* stages ---------------------------------------------------

constexpr int HT = tile::HALVES;  // bf16 elements of one 64 x 64 shared tile
using tile::LDH;

// A in bf16. q, k, v copied in as they are; dh fp32 (dN reads it unrounded);
// the carried C rounded to bf16 as it is staged (here only ever a bf16
// operand); E kept fp32 in the accumulators of its product (the gate sums G
// and the normalizer read it unrounded) and written once rounded as the
// products' operand; q_inter, dA and dqk rounded once after their scales.
__global__ void __launch_bounds__(NT, 2) bwd16_local(Params p) {
  constexpr int DH = 64;
  constexpr float QS = 0.125f;   // 1 / sqrt(DH)
  extern __shared__ __align__(16) float smf[];
  float* dh = smf;                                // dh (fp32)
  bf16* qs = reinterpret_cast<bf16*>(dh + TF);    // q
  bf16* ks = qs + HT;
  bf16* vs = ks + HT;
  bf16* Cs = vs + HT;                             // R(C) carried in, [d][e]
  bf16* E = Cs + HT;                              // R(E), then R(dqk)
  bf16* dA = E + HT;                              // R(dh / normalizer)
  bf16* qi = dA + HT;                             // R(q_inter) = R(q a / sqrt(DH))
  float* nv = reinterpret_cast<float*>(qi + HT);  // DH carried-in n
  float* bcs = nv + DH;          // CS cumsum of log f
  float* li = bcs + CS;          // CS log input gate
  float* cm = li + CS;           // CS running max of li - b
  float* stab = cm + CS;         // CS stabilizer
  float* av = stab + CS;         // CS inter-chunk scale a_t
  float* aq = av + CS;           // CS a_t / sqrt(DH)
  float* qn = aq + CS;           // CS q . n / sqrt(DH)
  float* nrm = qn + CS;          // CS normalizer
  float* row = nrm + CS;         // CS unnormalized row sum (its sign and size)
  float* dR = row + CS;          // CS
  float* rpart = dR + CS;        // 2 x CS row partials of the two column halves
  float* cpart = rpart + 2 * CS; // 4 x CS column partials of the four row quarters
  float* dbv = cpart + 4 * CS;   // CS d b, in-chunk part
  float* dli = dbv + CS;         // CS d log i, in-chunk part
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / p.NH, n = bh % p.NH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, s0 = j * CS;
  const long base = (long)bh * p.NS + j;
  const int nrows = p.S - s0 < CS ? p.S - s0 : CS;
  const long hoff = ((long)b * p.S + s0) * p.INNER + (long)n * DH;
  auto decay = [&](int t, int s) { return expf(li[s] - bcs[s] + bcs[t] - stab[t]); };
  auto row_sums = [&](float (&pr)[2]) {  // the warp's row sums into rpart[column half][row]
    const float r0 = tile::quad_sum(pr[0]), r1 = tile::quad_sum(pr[1]);
    if ((tid & 3) == 0) {
      rpart[(tid >> 7) * CS + Acc::row(0)] = r0;
      rpart[(tid >> 7) * CS + Acc::row(2)] = r1;
    }
  };

  tile::load16(qs, p.q16 + hoff, p.INNER, nrows, DH);
  tile::load16(ks, p.k16 + hoff, p.INNER, nrows, DH);
  tile::load16(vs, p.v16 + hoff, p.INNER, nrows, DH);
  tile::load_async<CS, DH>(dh, LDS, p.dh + hoff, p.INNER, nrows, DH);
  float* c32 = reinterpret_cast<float*>(E);  // C (fp32) lands over E and dA, free until E
  tile::load_async<DH, DH>(c32, LDS, p.cprev + base * DH * DH, DH, DH, DH);
  tile::cp_async_commit();
  load_gates(p, bh, s0, bcs, li);
  if (tid < DH) nv[tid] = p.nprev[base * DH + tid];
  const float m_prev = p.mprev[base];
  tile::cp_async_wait_all();
  __syncthreads();
  for (int e = tid; e < DH * DH / 2; e += NT) {
    const int d = e / (DH / 2), c = 2 * (e % (DH / 2));
    *reinterpret_cast<__nv_bfloat162*>(Cs + d * LDH + c) =
        __floats2bfloat162_rn(c32[d * LDS + c], c32[d * LDS + c + 1]);
  }
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
    av[tid] = expf(inter_log - st);
    aq[tid] = av[tid] * QS;
  }
  __syncthreads();
  {  // R(q_inter) and q . n: thread (row tid / 4, quarter tid % 4)
    const int t = tid >> 2, c0 = 16 * (tid & 3);
    const float a = aq[t];
    float s_ = 0.f;
#pragma unroll
    for (int c = c0; c < c0 + 16; c += 2) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qs + t * LDH + c));
      *reinterpret_cast<__nv_bfloat162*>(qi + t * LDH + c) = __floats2bfloat162_rn(x.x * a, x.y * a);
      s_ += x.x * nv[c] + x.y * nv[c + 1];
    }
    s_ = tile::quad_sum(s_);
    if ((tid & 3) == 0) qn[t] = QS * s_;
  }

  // E = (q k^T / sqrt(DH)) D, causal: fp32 in Ef, R(E) in the tile
  Acc Ef;
  Ef.zero();
  tile::mma16<false, true, tile::OUT_LOWER>(Ef, qs, ks);
  {
    float pr[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = Acc::row(r), c = Acc::col(jj, r);
        const float e = c <= t ? Ef.c[jj][r] * QS * decay(t, c) : 0.f;
        Ef.c[jj][r] = e;
        pr[r >> 1] += e;
      }
    row_sums(pr);
    tile::store16(Ef, E);
  }
  __syncthreads();
  if (tid < CS) {  // normalizer
    const float r = rpart[tid] + rpart[CS + tid] + av[tid] * qn[tid];
    row[tid] = r;
    nrm[tid] = fmaxf(fabsf(r), expf(-stab[tid])) + p.eps;
  }
  __syncthreads();

  // h (recomputed), then dN_t = -sum_e dh h / normalizer
  {
    Acc intra, inter;
    intra.zero();
    inter.zero();
    tile::mma16<false, false, tile::K_LE_M>(intra, E, vs);
    tile::mma16<false, false>(inter, qi, Cs);
    float pr[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = Acc::row(r), e = Acc::col(jj, r);
        pr[r >> 1] += dh[t * LDS + e] * ((intra.c[jj][r] + inter.c[jj][r]) / nrm[t]);
      }
    row_sums(pr);
  }
  __syncthreads();
  if (tid < CS) {
    const float dN = -(rpart[tid] + rpart[CS + tid]) / nrm[tid];
    const float r = row[tid];
    dR[tid] = fabsf(r) > expf(-stab[tid]) ? (r > 0.f ? dN : (r < 0.f ? -dN : 0.f)) : 0.f;
  }
  for (int e = tid; e < CS * DH / 2; e += NT) {
    const int t = e / (DH / 2), c = 2 * (e % (DH / 2));
    *reinterpret_cast<__nv_bfloat162*>(dA + t * LDH + c) =
        __floats2bfloat162_rn(dh[t * LDS + c] / nrm[t], dh[t * LDS + c + 1] / nrm[t]);
  }
  __syncthreads();

  // dv (in-chunk part) = R(E)^T R(dA)
  {
    Acc a;
    a.zero();
    tile::mma16<true, false, tile::K_GE_M>(a, E, dA);
    put_rows<false>(a, p.dv, p, b, s0, n * DH, 1.f);
  }
  // de = R(dA) R(v)^T + dR (causal); G = de E gives the gate sums; E <- R(dqk), dqk = de D
  {
    Acc d;
    d.zero();
    tile::mma16<false, true, tile::OUT_LOWER>(d, dA, vs);
    __syncthreads();  // every warp is done with R(E): R(dqk) takes its place
    float rs[2] = {0.f, 0.f};
    float cs[4][2];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      cs[jj][0] = 0.f;
      cs[jj][1] = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = Acc::row(r), s = Acc::col(jj, r);
        float g = 0.f, dqk = 0.f;
        if (s <= t) {
          const float de = d.c[jj][r] + dR[t];
          g = de * Ef.c[jj][r];
          dqk = de * decay(t, s);
        }
        d.c[jj][r] = dqk;
        rs[r >> 1] += g;
        cs[jj][r & 1] += g;
      }
    }
    tile::store16(d, E);
    row_sums(rs);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        float c = cs[jj][par];
        c += __shfl_xor_sync(0xffffffffu, c, 4);
        c += __shfl_xor_sync(0xffffffffu, c, 8);
        c += __shfl_xor_sync(0xffffffffu, c, 16);
        if (lane < 4) cpart[(warp & 3) * CS + Acc::col(jj, par)] = c;
      }
  }
  __syncthreads();
  if (tid < CS) {  // db[t] = rowsum G - colsum G, dlogi[s] = colsum G
    const float colsum = cpart[tid] + cpart[CS + tid] + cpart[2 * CS + tid] + cpart[3 * CS + tid];
    dli[tid] = colsum;
    dbv[tid] = rpart[tid] + rpart[CS + tid] - colsum;
  }
  __syncthreads();

  // dq = (R(dqk) R(k) + (R(dA) R(C)^T + dR n) a_t) / sqrt(DH); inter d b_t = a_t sum_d dqt q / sqrt(DH)
  {
    Acc a, c;
    a.zero();
    c.zero();
    tile::mma16<false, false, tile::K_LE_M>(a, E, ks);
    tile::mma16<false, true>(c, dA, Cs);
    float pr[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = Acc::row(r), d = Acc::col(jj, r);
        const float dqt = c.c[jj][r] + dR[t] * nv[d];
        pr[r >> 1] += dqt * __bfloat162float(qs[t * LDH + d]);
        a.c[jj][r] += dqt * av[t];
      }
    row_sums(pr);
    put_rows_bf16(a, p.dq16, p, b, s0, n * DH, QS);
  }
  // dk (in-chunk part) = R(dqk)^T R(q) / sqrt(DH)
  {
    Acc a;
    a.zero();
    tile::mma16<true, false, tile::K_GE_M>(a, E, qs);
    put_rows<false>(a, p.dk, p, b, s0, n * DH, QS);
  }
  // dC_attn = R(q_inter)^T R(dA); dn_attn[d] = sum_t dR_t q_inter_td
  {
    Acc a;
    a.zero();
    tile::mma16<true, false>(a, qi, dA);
    float* dco = p.dcs + base * DH * DH;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 2 * hh;
        *reinterpret_cast<float2*>(dco + Acc::row(r) * DH + Acc::col(jj, r)) =
            make_float2(a.c[jj][r], a.c[jj][r + 1]);
      }
    if (tid < DH) {
      float acc = 0.f;
      for (int t = 0; t < CS; ++t) acc += dR[t] * (__bfloat162float(qs[t * LDH + tid]) * aq[t]);
      p.dns[base * DH + tid] = acc;
    }
  }
  __syncthreads();
  if (tid < CS) {
    const int sg = s0 + tid;
    if (sg < p.S) {
      p.df[(long)bh * p.S + sg] = dbv[tid] + aq[tid] * (rpart[tid] + rpart[CS + tid]);
      p.di[(long)bh * p.S + sg] = dli[tid];
    }
  }
}

// C in bf16: the carry's products read R(dC d_new) and R(g k), each rounded
// once after its scale; dC_j and C_prev are staged in fp32 (their dot is d
// btot), and A's fp32 partials of dk and dv land in their place during the
// products; dk and dv are completed and written in bf16.
__global__ void __launch_bounds__(NT, 3) bwd16_carry(Params p) {
  constexpr int DH = 64;
  extern __shared__ __align__(16) bf16 sh[];
  bf16* ks = sh;                 // k
  bf16* vs = ks + HT;            // v
  bf16* dC = vs + HT;            // R(d_new dC_j), [d][e]
  bf16* kg = dC + HT;            // R(g k)
  float* dc32 = reinterpret_cast<float*>(kg + HT);  // dC_j (fp32), then A's dv partial
  float* cp32 = dc32 + TF;                          // C_prev (fp32), then A's dk partial
  __shared__ float bcs[CS], li[CS], gw[CS], dks[DH], db[CS], rev[CS], rpart[2 * CS], red[NW];
  __shared__ float gsum[2];
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / p.NH, n = bh % p.NH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, s0 = j * CS;
  const long base = (long)bh * p.NS + j;
  const int nrows = p.S - s0 < CS ? p.S - s0 : CS;
  const long hoff = ((long)b * p.S + s0) * p.INNER + (long)n * DH;
  float ld_old, ld_new;
  chunk_decays(p, base, &ld_old, &ld_new);
  const float d_new = expf(ld_new), d_old = expf(ld_old);
  const float btot = p.btot[base], mloc = p.mloc[base];

  tile::load16(ks, p.k16 + hoff, p.INNER, nrows, DH);
  tile::load16(vs, p.v16 + hoff, p.INNER, nrows, DH);
  tile::load_async<DH, DH>(dc32, LDS, p.dcs + base * DH * DH, DH, DH, DH);
  tile::load_async<DH, DH>(cp32, LDS, p.cprev + base * DH * DH, DH, DH, DH);
  tile::cp_async_commit();
  load_gates(p, bh, s0, bcs, li);
  float acc = 0.f;  // sum dC_j * C_prev (+ dn_j * n_prev)
  if (tid < DH) {
    const float g = p.dns[base * DH + tid];
    dks[tid] = g * d_new;
    acc += g * p.nprev[base * DH + tid];
  }
  __syncthreads();
  if (tid < 32) warp_scan64<false>(bcs);
  __syncthreads();
  if (tid < CS) gw[tid] = expf(li[tid] + (btot - bcs[tid]) - mloc);
  tile::cp_async_wait_all();
  __syncthreads();
  for (int e = tid; e < DH * DH / 2; e += NT) {  // R(d_new dC_j), R(g k) and the dC_j . C_prev sum
    const int d = e / (DH / 2), c = 2 * (e % (DH / 2));
    const float g0 = dc32[d * LDS + c], g1 = dc32[d * LDS + c + 1];
    acc += g0 * cp32[d * LDS + c] + g1 * cp32[d * LDS + c + 1];
    *reinterpret_cast<__nv_bfloat162*>(dC + d * LDH + c) =
        __floats2bfloat162_rn(g0 * d_new, g1 * d_new);
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ks + d * LDH + c));
    *reinterpret_cast<__nv_bfloat162*>(kg + d * LDH + c) =
        __floats2bfloat162_rn(x.x * gw[d], x.y * gw[d]);
  }
  acc = warp_sum(acc);
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  tile::load_async<CS, DH>(dc32, LDS, p.dv + hoff, p.INNER, nrows, DH);
  tile::load_async<CS, DH>(cp32, LDS, p.dk + hoff, p.INNER, nrows, DH);
  tile::cp_async_commit();

  // dv += R(g k) R(d_new dC)
  {
    Acc a;
    a.zero();
    tile::mma16<false, false>(a, kg, dC);
    tile::cp_async_wait_all();
    __syncthreads();
    put_tile_rows_bf16(a, p.dv16, dc32, p, b, s0, n * DH);
  }
  // dk_state = R(v) R(d_new dC)^T + dksum; dk += dk_state g; dg = sum_d dk_state k
  {
    Acc a;
    a.zero();
    tile::mma16<false, true>(a, vs, dC);
    float pr[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int s = Acc::row(r), d = Acc::col(jj, r);
        const float st = a.c[jj][r] + dks[d];
        pr[r >> 1] += st * __bfloat162float(ks[s * LDH + d]);
        a.c[jj][r] = st * gw[s];
      }
    put_row_sums(pr, rpart);
    put_tile_rows_bf16(a, p.dk16, cp32, p, b, s0, n * DH);
  }
  __syncthreads();

  // gate terms; d btot folds into the chunk's last slot of d b
  float gi = 0.f;
  if (tid < CS) {
    const int sg = s0 + tid;
    gi = (rpart[tid] + rpart[CS + tid]) * gw[tid];
    const float dbp = sg < p.S ? p.df[(long)bh * p.S + sg] : 0.f;
    db[tid] = dbp - gi;
  }
  const float gs = warp_sum(gi);  // warps 0 and 1 hold the chunk's gi
  if (lane == 0 && warp < 2) gsum[warp] = gs;
  __syncthreads();
  if (tid == 0) {
    float dbt = 0.f;
    for (int w = 0; w < NW; ++w) dbt += red[w];
    db[CS - 1] += dbt * d_old + gsum[0] + gsum[1];
  }
  __syncthreads();
  // reverse inclusive cumsum: dlogf_t = sum_{s >= t} db_s
  if (tid < CS) rev[tid] = db[CS - 1 - tid];
  __syncthreads();
  if (tid < 32) warp_scan64<false>(rev);
  __syncthreads();
  if (tid < CS) {
    const int sg = s0 + tid;
    if (sg < p.S) {
      const long o = (long)bh * p.S + sg;
      const float dlogf = rev[CS - 1 - tid];
      const float dli = p.di[o] + gi;
      p.df[o] = dlogf * sigmoid(-p.fg[o]);
      p.di[o] = p.igate_exp ? dli : dli * sigmoid(-p.ig[o]);
    }
  }
}

// ---- head dims 128 and 256: the head in 64-wide slices ------------------------

// Writes a 64 x 64 accumulator tile to global memory at row stride ld.
__device__ __forceinline__ void store_global(const Acc& a, float* dst, long ld) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 2 * hh;
      *reinterpret_cast<float2*>(dst + Acc::row(r) * ld + Acc::col(jj, r)) =
          make_float2(a.c[jj][r], a.c[jj][r + 1]);
    }
}

// Slices and blocks of one (chunk, head row) at head dim DH = ND * 64.
template <int ND>
struct Slices {
  static constexpr int DH = ND * 64;
  const Params& p;
  long hoff;  // element (s0, head column 0) of the (B, S, INNER) arrays
  int nrows;  // valid rows of the chunk

  // the 64 columns 64c .. of the head block of a (B, S, INNER) array
  __device__ void slice(float* dst, const float* src, int c) const {
    tile::load_async<CS, 64>(dst, LDS, src + hoff + c * 64, p.INNER, nrows, 64);
  }
  // block (c, r) of a DH x DH matrix at `m`
  __device__ static void block(float* dst, const float* m, int c, int r) {
    tile::load_async<64, 64>(dst, LDS, m + (long)c * 64 * DH + r * 64, DH, 64, 64);
  }
};

// Waits for every copy issued, then for every thread.
__device__ __forceinline__ void ready() {
  tile::cp_async_commit();
  tile::cp_async_wait_all();
  __syncthreads();
}

constexpr size_t kWideLocalSmem = sizeof(float) * (5 * TF + 20 * CS);

// A at DH = 64 ND: the same gradients as bwd_chunk_local.
template <int ND>
__global__ void __launch_bounds__(NT, 2) bwd_wide_local(Params p) {
  constexpr int DH = ND * 64;
  const float QS = 1.f / sqrtf((float)DH);
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;                // q slice c (unscaled)
  float* Kt = Qt + TF;           // k slice c, or the value tile v_r
  float* Dt = Kt + TF;           // the value tile dh_r
  float* Ct = Dt + TF;           // block C[c, r] of the carried-in C
  float* E = Ct + TF;            // row t col s: (q_t . k_s / sqrt(DH)) D_ts; later dqk = de D
  float* nv = E + TF;            // CS: slice c of the carried-in n
  float* bcs = nv + CS;          // CS cumsum of log f
  float* li = bcs + CS;          // CS log input gate
  float* cm = li + CS;           // CS running max of li - b; then aq
  float* stab = cm + CS;         // CS stabilizer
  float* av = stab + CS;         // CS inter-chunk scale a_t
  float* nrm = av + CS;          // CS normalizer
  float* invn = nrm + CS;        // CS 1 / normalizer
  float* ascl = invn + CS;       // CS a_t / sqrt(DH) / normalizer
  float* row = ascl + CS;        // CS unnormalized row sum
  float* qnv = row + CS;         // CS q . n
  float* dR = qnv + CS;          // CS
  float* dbv = dR + CS;          // CS d b, in-chunk part
  float* dli = dbv + CS;         // CS d log i, in-chunk part
  float* rpart = dli + CS;       // 2 x CS row partials of the two column halves
  float* cpart = rpart + 2 * CS; // 4 x CS column partials of the four row quarters
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / p.NH, n = bh % p.NH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, s0 = j * CS;
  const long base = (long)bh * p.NS + j;
  const int nrows = p.S - s0 < CS ? p.S - s0 : CS;
  const Slices<ND> sl{p, ((long)b * p.S + s0) * p.INNER + (long)n * DH, nrows};
  const float* cprev = p.cprev + base * DH * DH;
  auto decay = [&](int t, int s) { return expf(li[s] - bcs[s] + bcs[t] - stab[t]); };
  auto load_n = [&](int c) {
    if (tid < 64) nv[tid] = p.nprev[base * DH + c * 64 + tid];
  };

  load_gates(p, bh, s0, bcs, li);
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
    av[tid] = expf(inter_log - st);
  }

  // q k^T (causal) and q . n, summed over the slices
  {
    Acc s;
    s.zero();
    float qn = 0.f;  // thread (row tid / 4, quarter tid % 4)'s share of q_t . n
    const int t = tid >> 2, part = 16 * (tid & 3);
    for (int c = 0; c < ND; ++c) {
      __syncthreads();
      sl.slice(Qt, p.q, c);
      sl.slice(Kt, p.k, c);
      load_n(c);
      ready();
      tile::mma<false, true, tile::OUT_LOWER>(s, Qt, LDS, Kt, LDS, 64);
#pragma unroll
      for (int i = 0; i < 16; ++i) qn += Qt[t * LDS + part + i] * nv[part + i];
    }
    qn = tile::quad_sum(qn);
    if ((tid & 3) == 0) qnv[t] = qn;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int tt = Acc::row(r), c = Acc::col(jj, r);
        E[tt * LDS + c] = c <= tt ? s.c[jj][r] * QS * decay(tt, c) : 0.f;
      }
  }
  __syncthreads();

  // normalizer
  for (int t = warp; t < CS; t += NW) {
    const float es = warp_sum(E[t * LDS + lane] + E[t * LDS + lane + 32]);
    if (lane == 0) {
      const float r = es + av[t] * QS * qnv[t];
      const float nr = fmaxf(fabsf(r), expf(-stab[t])) + p.eps;
      row[t] = r;
      nrm[t] = nr;
      invn[t] = 1.f / nr;
      ascl[t] = av[t] * QS / nr;
    }
  }

  // h (recomputed) value tile by value tile, then dN_t = -sum_e dh h / normalizer
  {
    float pr[2] = {0.f, 0.f};
    for (int r = 0; r < ND; ++r) {
      Acc inter;
      inter.zero();
      for (int c = 0; c < ND; ++c) {
        __syncthreads();
        sl.slice(Qt, p.q, c);
        Slices<ND>::block(Ct, cprev, c, r);
        if (c == 0) {
          sl.slice(Kt, p.v, r);
          sl.slice(Dt, p.dh, r);
        }
        ready();
        tile::mma<false, false>(inter, Qt, LDS, Ct, LDS, 64);
      }
      Acc intra;
      intra.zero();
      tile::mma<false, false, tile::K_LE_M>(intra, E, LDS, Kt, LDS, CS);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int t = Acc::row(rr), e = Acc::col(jj, rr);
          const float h = (intra.c[jj][rr] + av[t] * QS * inter.c[jj][rr]) / nrm[t];
          pr[rr >> 1] += Dt[t * LDS + e] * h;
        }
    }
    put_row_sums(pr, rpart);
  }
  __syncthreads();
  if (tid < CS) {
    const float dN = -(rpart[tid] + rpart[CS + tid]) / nrm[tid];
    const float r = row[tid];
    dR[tid] = fabsf(r) > expf(-stab[tid]) ? (r > 0.f ? dN : (r < 0.f ? -dN : 0.f)) : 0.f;
  }

  // dv (in-chunk part) = E^T dA; de = dA v^T summed over the value tiles
  Acc de;
  de.zero();
  for (int r = 0; r < ND; ++r) {
    __syncthreads();
    sl.slice(Kt, p.v, r);
    sl.slice(Dt, p.dh, r);
    ready();
    tile::mma<false, true, tile::OUT_LOWER>(de, Dt, LDS, Kt, LDS, 64);
    Acc a;
    a.zero();
    tile::mma<true, false, tile::K_GE_M>(a, E, LDS, Dt, LDS, CS, invn);
    put_rows<false>(a, p.dv, p, b, s0, n * DH + r * 64, 1.f);
  }
  __syncthreads();  // E is overwritten below

  // de = dA v^T + dR (causal); G = de E gives the gate sums; E <- dqk = de D
  {
    float rs[2] = {0.f, 0.f};
    float cs[4][2];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      cs[jj][0] = 0.f;
      cs[jj][1] = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = Acc::row(r), s = Acc::col(jj, r);
        float g = 0.f, dqk = 0.f;
        if (s <= t) {
          const float d = de.c[jj][r] * invn[t] + dR[t];
          g = d * E[t * LDS + s];
          dqk = d * decay(t, s);
        }
        E[t * LDS + s] = dqk;
        rs[r >> 1] += g;
        cs[jj][r & 1] += g;
      }
    }
    put_row_sums(rs, rpart);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        float c = cs[jj][par];
        c += __shfl_xor_sync(0xffffffffu, c, 4);
        c += __shfl_xor_sync(0xffffffffu, c, 8);
        c += __shfl_xor_sync(0xffffffffu, c, 16);
        if (lane < 4) cpart[(warp & 3) * CS + Acc::col(jj, par)] = c;
      }
  }
  __syncthreads();
  if (tid < CS) {  // db[t] = rowsum G - colsum G, dlogi[s] = colsum G
    const float colsum = cpart[tid] + cpart[CS + tid] + cpart[2 * CS + tid] + cpart[3 * CS + tid];
    dli[tid] = colsum;
    dbv[tid] = rpart[tid] + rpart[CS + tid] - colsum;
  }

  // per key slice c: dk (in-chunk part) = dqk^T q_c / sqrt(DH); dn_attn;
  // dq_c = (dqk k_c + (dA C[c, :]^T + dR n_c) a_t) / sqrt(DH); dC_attn[c, r]
  // = sum_t a_t q_c dA_r^T / sqrt(DH); inter d b_t = a_t sum_d dqt q / sqrt(DH)
  {
    float pq[2] = {0.f, 0.f};
    for (int c = 0; c < ND; ++c) {
      __syncthreads();
      sl.slice(Qt, p.q, c);
      sl.slice(Kt, p.k, c);
      load_n(c);
      ready();
      {
        Acc a;
        a.zero();
        tile::mma<true, false, tile::K_GE_M>(a, E, LDS, Qt, LDS, CS);
        put_rows<false>(a, p.dk, p, b, s0, n * DH + c * 64, QS);
      }
      if (tid < 64) {
        float acc = 0.f;
        for (int t = 0; t < CS; ++t) acc += dR[t] * (av[t] * QS) * Qt[t * LDS + tid];
        p.dns[base * DH + c * 64 + tid] = acc;
      }
      Acc dq, dt;
      dq.zero();
      dt.zero();
      tile::mma<false, false, tile::K_LE_M>(dq, E, LDS, Kt, LDS, CS);
      for (int r = 0; r < ND; ++r) {
        __syncthreads();
        sl.slice(Dt, p.dh, r);
        Slices<ND>::block(Ct, cprev, c, r);
        ready();
        tile::mma<false, true>(dt, Dt, LDS, Ct, LDS, 64);
        Acc a;
        a.zero();
        tile::mma<true, false>(a, Qt, LDS, Dt, LDS, CS, ascl);
        store_global(a, p.dcs + base * DH * DH + (long)c * 64 * DH + r * 64, DH);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = Acc::row(r), d = Acc::col(jj, r);
          const float dqt = dt.c[jj][r] * invn[t] + dR[t] * nv[d];
          pq[r >> 1] += dqt * Qt[t * LDS + d];
          dq.c[jj][r] += dqt * av[t];
        }
      put_rows<false>(dq, p.dq, p, b, s0, n * DH + c * 64, QS);
    }
    put_row_sums(pq, rpart);
  }
  __syncthreads();
  if (tid < CS) {
    const int sg = s0 + tid;
    if (sg < p.S) {
      p.df[(long)bh * p.S + sg] = dbv[tid] + av[tid] * QS * (rpart[tid] + rpart[CS + tid]);
      p.di[(long)bh * p.S + sg] = dli[tid];
    }
  }
}

// C at DH = 64 ND: the same terms as bwd_chunk_carry.
template <int ND>
__global__ void __launch_bounds__(NT, 2) bwd_wide_carry(Params p) {
  constexpr int DH = ND * 64;
  extern __shared__ __align__(16) float sm[];
  float* Kt = sm;                // k slice c
  float* Vt = Kt + TF;           // value tile v_r
  float* Dc = Vt + TF;           // block dC[c, r] of the carry dC_j
  __shared__ float bcs[CS], li[CS], gw[CS], dks[64], db[CS], rev[CS], rpart[2 * CS], red[NW];
  __shared__ float gsum[2];
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / p.NH, n = bh % p.NH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, s0 = j * CS;
  const long base = (long)bh * p.NS + j;
  const int nrows = p.S - s0 < CS ? p.S - s0 : CS;
  const Slices<ND> sl{p, ((long)b * p.S + s0) * p.INNER + (long)n * DH, nrows};
  float ld_old, ld_new;
  chunk_decays(p, base, &ld_old, &ld_new);
  const float d_new = expf(ld_new), d_old = expf(ld_old);
  const float btot = p.btot[base], mloc = p.mloc[base];
  const float* dcn = p.dcs + base * DH * DH;
  const float* cpv = p.cprev + base * DH * DH;

  load_gates(p, bh, s0, bcs, li);
  float acc = 0.f;  // sum dC_j * C_prev + dn_j * n_prev
  for (int i = tid; i < DH * DH; i += NT) acc += dcn[i] * cpv[i];
  for (int i = tid; i < DH; i += NT) acc += p.dns[base * DH + i] * p.nprev[base * DH + i];
  acc = warp_sum(acc);
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (tid < 32) warp_scan64<false>(bcs);
  __syncthreads();
  if (tid < CS) gw[tid] = expf(li[tid] + (btot - bcs[tid]) - mloc);

  // dv[:, r] += gw_s d_new sum_c k_c dC[c, r]
  for (int r = 0; r < ND; ++r) {
    Acc a;
    a.zero();
    for (int c = 0; c < ND; ++c) {
      __syncthreads();
      sl.slice(Kt, p.k, c);
      Slices<ND>::block(Dc, dcn, c, r);
      ready();
      tile::mma<false, false>(a, Kt, LDS, Dc, LDS, 64);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) a.c[jj][rr] *= gw[Acc::row(rr)];
    put_rows<true>(a, p.dv, p, b, s0, n * DH + r * 64, d_new);
  }
  // dk_state[:, c] = d_new sum_r v_r dC[c, r]^T + dksum_c; dk[:, c] += dk_state gw;
  // dgw = sum_d dk_state k
  {
    float pr[2] = {0.f, 0.f};
    for (int c = 0; c < ND; ++c) {
      __syncthreads();
      sl.slice(Kt, p.k, c);
      if (tid < 64) dks[tid] = p.dns[base * DH + c * 64 + tid] * d_new;
      Acc a;
      a.zero();
      for (int r = 0; r < ND; ++r) {
        if (r > 0) __syncthreads();
        sl.slice(Vt, p.v, r);
        Slices<ND>::block(Dc, dcn, c, r);
        ready();
        tile::mma<false, true>(a, Vt, LDS, Dc, LDS, 64);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int s = Acc::row(rr), d = Acc::col(jj, rr);
          const float st = a.c[jj][rr] * d_new + dks[d];
          pr[rr >> 1] += st * Kt[s * LDS + d];
          a.c[jj][rr] = st * gw[s];
        }
      put_rows<true>(a, p.dk, p, b, s0, n * DH + c * 64, 1.f);
    }
    put_row_sums(pr, rpart);
  }
  __syncthreads();

  // gate terms; d btot folds into the chunk's last slot of d b
  float gi = 0.f;
  if (tid < CS) {
    const int sg = s0 + tid;
    gi = (rpart[tid] + rpart[CS + tid]) * gw[tid];
    const float dbp = sg < p.S ? p.df[(long)bh * p.S + sg] : 0.f;
    db[tid] = dbp - gi;
  }
  const float gs = warp_sum(gi);  // warps 0 and 1 hold the chunk's gi
  if (lane == 0 && warp < 2) gsum[warp] = gs;
  __syncthreads();
  if (tid == 0) {
    float dbt = 0.f;
    for (int w = 0; w < NW; ++w) dbt += red[w];
    db[CS - 1] += dbt * d_old + gsum[0] + gsum[1];
  }
  __syncthreads();
  // reverse inclusive cumsum: dlogf_t = sum_{s >= t} db_s
  if (tid < CS) rev[tid] = db[CS - 1 - tid];
  __syncthreads();
  if (tid < 32) warp_scan64<false>(rev);
  __syncthreads();
  if (tid < CS) {
    const int sg = s0 + tid;
    if (sg < p.S) {
      const long o = (long)bh * p.S + sg;
      const float dlogf = rev[CS - 1 - tid];
      const float dli = p.di[o] + gi;
      p.df[o] = dlogf * sigmoid(-p.fg[o]);
      p.di[o] = p.igate_exp ? dli : dli * sigmoid(-p.ig[o]);
    }
  }
}

template <int DH>
constexpr size_t local_smem() {
  return sizeof(float) * (6 * TF + DH + 16 * CS);
}

constexpr size_t kCarrySmem = sizeof(float) * 3 * TF;

template <class K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The three launches at head dim DH = 64 ND.
template <int ND>
int launch(Params& p, float* ws, cudaStream_t st) {
  constexpr int DH = ND * 64;
  const long rows = (long)p.B * p.NH;
  p.dcs = ws;
  p.dns = ws + rows * p.NS * DH * DH;
  cudaError_t err;
  if constexpr (ND == 1) {
    if ((err = allow_smem(bwd_chunk_local<DH>, local_smem<DH>())) != cudaSuccess) return err;
    if ((err = allow_smem(bwd_chunk_carry<DH>, kCarrySmem)) != cudaSuccess) return err;
    bwd_chunk_local<DH><<<dim3(p.NS, rows), NT, local_smem<DH>(), st>>>(p);
  } else {
    if ((err = allow_smem(bwd_wide_local<ND>, kWideLocalSmem)) != cudaSuccess) return err;
    if ((err = allow_smem(bwd_wide_carry<ND>, kCarrySmem)) != cudaSuccess) return err;
    bwd_wide_local<ND><<<dim3(p.NS, rows), NT, kWideLocalSmem, st>>>(p);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_state_scan<DH><<<dim3(rows, DH * DH / NT), NT, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if constexpr (ND == 1) bwd_chunk_carry<DH><<<dim3(p.NS, rows), NT, kCarrySmem, st>>>(p);
  else bwd_wide_carry<ND><<<dim3(p.NS, rows), NT, kCarrySmem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return 0;
}

constexpr size_t kLocal16Smem = sizeof(float) * (TF + 64 + 20 * CS) + sizeof(bf16) * 7 * HT;
constexpr size_t kCarry16Smem = sizeof(bf16) * 4 * HT + sizeof(float) * 2 * TF;

// The three launches of the bf16 entry (head dim 64); ws holds the dC / dn
// carries, then the fp32 partials of dk and dv (B, S, INNER) each.
int launch_bf16(Params& p, float* ws, cudaStream_t st) {
  constexpr int DH = 64;
  const long rows = (long)p.B * p.NH, tok = (long)p.B * p.S * p.INNER;
  p.dcs = ws;
  p.dns = ws + rows * p.NS * DH * DH;
  p.dk = p.dns + rows * p.NS * DH;
  p.dv = p.dk + tok;
  cudaError_t err;
  if ((err = allow_smem(bwd16_local, kLocal16Smem)) != cudaSuccess) return err;
  if ((err = allow_smem(bwd16_carry, kCarry16Smem)) != cudaSuccess) return err;
  bwd16_local<<<dim3(p.NS, rows), NT, kLocal16Smem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_state_scan<DH><<<dim3(rows, DH * DH / NT), NT, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd16_carry<<<dim3(p.NS, rows), NT, kCarry16Smem, st>>>(p);
  return cudaGetLastError();
}

bool head_dim_ok(int DH) { return DH == 64 || DH == 128 || DH == 256; }

}  // namespace

extern "C" {

// Floats of scratch the wrapper must allocate for one call at head dim DH
// (the dC / dn carries of every chunk).
long mlstm_bwd_workspace_floats(int B, int S, int NH, int DH) {
  const long NS = (S + CS - 1) / CS;
  return (long)B * NH * NS * ((long)DH * DH + DH);
}

const char* mlstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bf16 q, k, v and dq, dk, dv; dh, the gates, the carry states, di and df
// fp32; head dim 64 only. ws: mlstm_bwd_workspace_floats(B, S, NH, 64) +
// 2 B S INNER floats. Returns 0 on success, else the CUDA error code.
int mlstm_bwd_bf16(const bf16* q, const bf16* k, const bf16* v, const float* dh,
                   const float* ig, const float* fg, const float* cprev, const float* nprev,
                   const float* mprev, const float* btot, const float* mloc, bf16* dq, bf16* dk,
                   bf16* dv, float* di, float* df, float* ws, int B, int S, int INNER, int NH,
                   int igate_exp, float eps, void* stream) {
  if (B <= 0 || S <= 0 || NH <= 0 || INNER != NH * 64 || (long)B * NH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.q16 = q; p.k16 = k; p.v16 = v; p.dh = dh; p.ig = ig; p.fg = fg;
  p.cprev = cprev; p.nprev = nprev; p.mprev = mprev; p.btot = btot; p.mloc = mloc;
  p.dq16 = dq; p.dk16 = dk; p.dv16 = dv; p.di = di; p.df = df;
  p.B = B; p.S = S; p.INNER = INNER; p.NH = NH;
  p.NS = (S + CS - 1) / CS;
  p.igate_exp = igate_exp; p.eps = eps;
  return launch_bf16(p, ws, static_cast<cudaStream_t>(stream));
}

// Head dim INNER / NH: 64, 128 or 256. Returns 0 on success, else the CUDA
// error code of the first failed step (cudaErrorInvalidValue for an
// unsupported shape).
int mlstm_bwd_f32(const float* q, const float* k, const float* v, const float* dh,
                  const float* ig, const float* fg, const float* cprev, const float* nprev,
                  const float* mprev, const float* btot, const float* mloc, float* dq,
                  float* dk, float* dv, float* di, float* df, float* ws, int B, int S,
                  int INNER, int NH, int igate_exp, float eps, void* stream) {
  if (B <= 0 || S <= 0 || NH <= 0 || INNER % NH != 0 || !head_dim_ok(INNER / NH) ||
      (long)B * NH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dh = dh; p.ig = ig; p.fg = fg;
  p.cprev = cprev; p.nprev = nprev; p.mprev = mprev; p.btot = btot; p.mloc = mloc;
  p.dq = dq; p.dk = dk; p.dv = dv; p.di = di; p.df = df;
  p.B = B; p.S = S; p.INNER = INNER; p.NH = NH;
  p.NS = (S + CS - 1) / CS;
  p.igate_exp = igate_exp; p.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (INNER / NH) {
    case 64: return launch<1>(p, ws, st);
    case 128: return launch<2>(p, ws, st);
    default: return launch<4>(p, ws, st);
  }
}

}  // extern "C"
