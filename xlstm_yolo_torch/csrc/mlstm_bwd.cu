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
// Every product is an fp32 FMA loop over shared-memory tiles (rows padded to
// DH+1 floats against bank conflicts); tensor cores and TMA are later work.
//
// Head dim and chunk are fixed at 64, as in the layer kernel. A sequence that
// is not a chunk multiple is masked in its last chunk exactly as the forward
// masks it: missing steps load zeros with an input-gate log of -1e30 and a
// forget-gate log of 0; nothing is written for them.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int DH = 64;        // head dim
constexpr int CS = 64;        // chunk length
constexpr int LD = DH + 1;    // padded smem row stride
constexpr int NT = 256;       // threads per CTA
constexpr int NW = NT / 32;   // warps per CTA
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

__device__ __forceinline__ void load_rows(const float* src, const Params& p, int b, int n,
                                          int s0, float* dst, float scale) {
  for (int i = threadIdx.x; i < CS * DH; i += NT) {
    const int r = i / DH, d = i % DH, s = s0 + r;
    dst[r * LD + d] = s < p.S ? src[((long)b * p.S + s) * p.INNER + n * DH + d] * scale : 0.f;
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

// A. Per chunk: forward recompute and the carry-independent gradients.
__global__ void __launch_bounds__(NT) bwd_chunk_local(Params p) {
  extern __shared__ float sm[];
  float* qs = sm;                // CS x LD, q / sqrt(DH)
  float* ks = qs + CS * LD;      // CS x LD
  float* vs = ks + CS * LD;      // CS x LD
  float* dA = vs + CS * LD;      // CS x LD, dh, then dh / normalizer
  float* E = dA + CS * LD;       // CS x LD, row t col s: (q_t . k_s) D_ts; later G
  float* D = E + CS * LD;        // CS x LD, decay D_ts (0 above the diagonal); later dqk
  float* Cs = D + CS * LD;       // DH x LD, carried-in C
  float* nv = Cs + DH * LD;      // DH carried-in n
  float* bcs = nv + DH;          // CS cumsum of log f
  float* li = bcs + CS;          // CS log input gate
  float* cm = li + CS;           // CS running max of li - b
  float* stab = cm + CS;         // CS stabilizer
  float* av = stab + CS;         // CS inter-chunk scale a_t
  float* nrm = av + CS;          // CS normalizer
  float* row = nrm + CS;         // CS unnormalized row sum (its sign and size)
  float* dR = row + CS;          // CS
  float* part = dR + CS;         // 4 x CS partial sums
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / p.NH, n = bh % p.NH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, s0 = j * CS;
  const long base = (long)bh * p.NS + j;

  load_gates(p, bh, s0, bcs, li);
  load_rows(p.q, p, b, n, s0, qs, 0.125f);  // 1 / sqrt(64)
  load_rows(p.k, p, b, n, s0, ks, 1.f);
  load_rows(p.v, p, b, n, s0, vs, 1.f);
  load_rows(p.dh, p, b, n, s0, dA, 1.f);
  for (int i = tid; i < DH * DH; i += NT) Cs[(i / DH) * LD + i % DH] = p.cprev[base * DH * DH + i];
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
    const float inter_log = m_prev + bcs[tid];
    const float st = fmaxf(bcs[tid] + cm[tid], inter_log);
    stab[tid] = st;
    av[tid] = expf(inter_log - st);
  }
  __syncthreads();

  // decay matrix and E
  {
    const int s = tid % CS, t0 = tid / CS;
    const float ws = li[s] - bcs[s];
    for (int i = 0; i < CS / 4; ++i) {
      const int t = t0 + 4 * i;
      float dv_ = 0.f, e = 0.f;
      if (s <= t) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < DH; ++d) dot += qs[t * LD + d] * ks[s * LD + d];
        dv_ = expf(ws + bcs[t] - stab[t]);
        e = dot * dv_;
      }
      D[t * LD + s] = dv_;
      E[t * LD + s] = e;
    }
  }
  __syncthreads();

  // normalizer
  for (int t = warp; t < CS; t += NW) {
    const float es = warp_sum(E[t * LD + lane] + E[t * LD + lane + 32]);
    const float qn = warp_sum(qs[t * LD + lane] * nv[lane] + qs[t * LD + lane + 32] * nv[lane + 32]);
    if (lane == 0) {
      const float r = es + av[t] * qn;
      row[t] = r;
      nrm[t] = fmaxf(fabsf(r), expf(-stab[t])) + p.eps;
    }
  }
  __syncthreads();

  // h (recomputed), then dN_t = -sum_e dh h / normalizer via per-warp partials
  {
    const int e = tid % DH, t0 = tid / DH;
    for (int i = 0; i < CS / 4; ++i) {
      const int t = t0 + 4 * i;
      float intra = 0.f, inter = 0.f;
      for (int s = 0; s <= t; ++s) intra += E[t * LD + s] * vs[s * LD + e];
#pragma unroll 16
      for (int d = 0; d < DH; ++d) inter += qs[t * LD + d] * Cs[d * LD + e];
      const float h = (intra + av[t] * inter) / nrm[t];
      const float pr = warp_sum(dA[t * LD + e] * h);
      if (lane == 0) part[2 * t + (e >> 5)] = pr;
    }
  }
  __syncthreads();
  if (tid < CS) {
    const float dN = -(part[2 * tid] + part[2 * tid + 1]) / nrm[tid];
    const float r = row[tid];
    dR[tid] = fabsf(r) > expf(-stab[tid]) ? (r > 0.f ? dN : (r < 0.f ? -dN : 0.f)) : 0.f;
  }
  for (int i = tid; i < CS * DH; i += NT) {
    const int t = i / DH, e = i % DH;
    dA[t * LD + e] /= nrm[t];
  }
  __syncthreads();

  // dv (intra part) = E^T dA, before E is overwritten
  {
    const int e = tid % DH, s0r = tid / DH;
    for (int i = 0; i < CS / 4; ++i) {
      const int s = s0r + 4 * i, sg = s0 + s;
      float acc = 0.f;
      for (int t = s; t < CS; ++t) acc += E[t * LD + s] * dA[t * LD + e];
      if (sg < p.S) p.dv[((long)b * p.S + sg) * p.INNER + n * DH + e] = acc;
    }
  }
  __syncthreads();

  // de = dA_t . v_s + dR_t (causal); D <- dqk = de D; E <- G = de E
  {
    const int s = tid % CS, t0 = tid / CS;
    for (int i = 0; i < CS / 4; ++i) {
      const int t = t0 + 4 * i;
      float de = 0.f;
      if (s <= t) {
        float dot = 0.f;
#pragma unroll 16
        for (int e = 0; e < DH; ++e) dot += dA[t * LD + e] * vs[s * LD + e];
        de = dot + dR[t];
      }
      D[t * LD + s] *= de;
      E[t * LD + s] *= de;
    }
  }
  __syncthreads();

  // gate partials: db[t] = rowsum G - colsum G, dlogi[s] = colsum G; plus the
  // inter term of db below
  if (tid < CS) {  // 64 threads sum rows, the next 64 sum columns
    float r = 0.f;
    for (int s = 0; s <= tid; ++s) r += E[tid * LD + s];
    part[tid] = r;
  } else if (tid < 2 * CS) {
    const int s = tid - CS;
    float c = 0.f;
    for (int t = s; t < CS; ++t) c += E[t * LD + s];
    part[CS + s] = c;
  }
  __syncthreads();

  // dq = (dqk k + (dA C^T + dR n) a_t) / sqrt(DH); inter db[t] = a_t sum_d dqt q
  {
    const int d = tid % DH, t0 = tid / DH;
    for (int i = 0; i < CS / 4; ++i) {
      const int t = t0 + 4 * i, sg = s0 + t;
      float intra = 0.f, dqt = 0.f;
      for (int s = 0; s <= t; ++s) intra += D[t * LD + s] * ks[s * LD + d];
#pragma unroll 16
      for (int e = 0; e < DH; ++e) dqt += dA[t * LD + e] * Cs[d * LD + e];
      dqt += dR[t] * nv[d];
      const float pr = warp_sum(dqt * qs[t * LD + d]);
      if (lane == 0) part[2 * CS + 2 * t + (d >> 5)] = pr * av[t];
      if (sg < p.S)
        p.dq[((long)b * p.S + sg) * p.INNER + n * DH + d] = (intra + dqt * av[t]) * 0.125f;
    }
  }
  __syncthreads();
  if (tid < CS) {
    const int sg = s0 + tid;
    if (sg < p.S) {
      const float colsum = part[CS + tid];
      p.df[(long)bh * p.S + sg] =
          part[tid] - colsum + part[2 * CS + 2 * tid] + part[2 * CS + 2 * tid + 1];
      p.di[(long)bh * p.S + sg] = colsum;
    }
  }

  // dk (intra part) = dqk^T q
  {
    const int d = tid % DH, s0r = tid / DH;
    for (int i = 0; i < CS / 4; ++i) {
      const int s = s0r + 4 * i, sg = s0 + s;
      float acc = 0.f;
      for (int t = s; t < CS; ++t) acc += D[t * LD + s] * qs[t * LD + d];
      if (sg < p.S) p.dk[((long)b * p.S + sg) * p.INNER + n * DH + d] = acc;
    }
  }

  // dC_attn[d][e] = sum_t a_t q_td dA_te; dn_attn[d] = sum_t dR_t a_t q_td
  {
    const int e = tid % DH, d0 = tid / DH;
    float* dco = p.dcs + base * DH * DH;
    for (int i = 0; i < DH / 4; ++i) {
      const int d = d0 + 4 * i;
      float acc = 0.f;
      for (int t = 0; t < CS; ++t) acc += av[t] * qs[t * LD + d] * dA[t * LD + e];
      dco[d * DH + e] = acc;
    }
    if (tid < DH) {
      float acc = 0.f;
      for (int t = 0; t < CS; ++t) acc += dR[t] * av[t] * qs[t * LD + tid];
      p.dns[base * DH + tid] = acc;
    }
  }
}

// B. Reverse scan over chunks: dC_attn_j is replaced in place by the carry
// dC_j (the gradient with respect to the state chunk j leaves behind).
__global__ void __launch_bounds__(NT) bwd_state_scan(Params p) {
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int idx = blockIdx.y * NT + tid;  // entry of C
  const bool own_n = blockIdx.y == 0 && tid < DH;
  const long row = (long)bh * p.NS;
  float c = 0.f, nn = 0.f;
  for (int j = p.NS - 1; j >= 0; --j) {
    const long base = row + j;
    float ld_old, ld_new;
    chunk_decays(p, base, &ld_old, &ld_new);
    const float dold = expf(ld_old);
    float* cp = p.dcs + base * DH * DH + idx;
    const float dca = *cp;
    *cp = c;
    c = dca + c * dold;
    if (own_n) {
      float* np_ = p.dns + base * DH + tid;
      const float dna = *np_;
      *np_ = nn;
      nn = dna + nn * dold;
    }
  }
}

// C. Per chunk: the terms that need the reverse carry, then d log f.
__global__ void __launch_bounds__(NT) bwd_chunk_carry(Params p) {
  extern __shared__ float sm[];
  float* ks = sm;                // CS x LD
  float* vs = ks + CS * LD;      // CS x LD
  float* dkv = vs + CS * LD;     // DH x LD, dC_j scaled by the chunk's summary decay
  __shared__ float bcs[CS], li[CS], gw[CS], dks[DH], db[CS], part[2 * CS], red[NW];
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / p.NH, n = bh % p.NH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, s0 = j * CS;
  const long base = (long)bh * p.NS + j;
  float ld_old, ld_new;
  chunk_decays(p, base, &ld_old, &ld_new);
  const float d_new = expf(ld_new), d_old = expf(ld_old);
  const float btot = p.btot[base], mloc = p.mloc[base];

  load_gates(p, bh, s0, bcs, li);
  load_rows(p.k, p, b, n, s0, ks, 1.f);
  load_rows(p.v, p, b, n, s0, vs, 1.f);
  const float* dcn = p.dcs + base * DH * DH;
  const float* cpv = p.cprev + base * DH * DH;
  float acc = 0.f;  // sum dC_j * C_prev (+ dn_j * n_prev)
  for (int i = tid; i < DH * DH; i += NT) {
    const float g = dcn[i];
    dkv[(i / DH) * LD + i % DH] = g * d_new;
    acc += g * cpv[i];
  }
  if (tid < DH) {
    const float g = p.dns[base * DH + tid];
    dks[tid] = g * d_new;
    acc += g * p.nprev[base * DH + tid];
  }
  acc = warp_sum(acc);
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (tid < 32) warp_scan64<false>(bcs);
  __syncthreads();
  if (tid < CS) gw[tid] = expf(li[tid] + (btot - bcs[tid]) - mloc);
  __syncthreads();

  // dv += (k gw) dkv
  {
    const int e = tid % DH, s0r = tid / DH;
    for (int i = 0; i < CS / 4; ++i) {
      const int s = s0r + 4 * i, sg = s0 + s;
      float a = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) a += ks[s * LD + d] * dkv[d * LD + e];
      if (sg < p.S) p.dv[((long)b * p.S + sg) * p.INNER + n * DH + e] += a * gw[s];
    }
  }
  // dk_state = v dkv^T + dksum; dk += dk_state gw; dgw = sum_d dk_state k
  {
    const int d = tid % DH, s0r = tid / DH;
    for (int i = 0; i < CS / 4; ++i) {
      const int s = s0r + 4 * i, sg = s0 + s;
      float a = dks[d];
#pragma unroll 16
      for (int e = 0; e < DH; ++e) a += dkv[d * LD + e] * vs[s * LD + e];
      const float pr = warp_sum(a * ks[s * LD + d]);
      if (lane == 0) part[2 * s + (d >> 5)] = pr;
      if (sg < p.S) p.dk[((long)b * p.S + sg) * p.INNER + n * DH + d] += a * gw[s];
    }
  }
  __syncthreads();

  // gate terms; d btot folds into the chunk's last slot of d b
  float gi = 0.f;
  if (tid < CS) {
    const int sg = s0 + tid;
    gi = (part[2 * tid] + part[2 * tid + 1]) * gw[tid];
    const float dbp = sg < p.S ? p.df[(long)bh * p.S + sg] : 0.f;
    db[tid] = dbp - gi;
  }
  float gsum = warp_sum(gi);  // warps 0 and 1 hold the chunk's gi
  __syncthreads();
  if (lane == 0 && warp < 2) part[warp] = gsum;
  __syncthreads();
  if (tid == 0) {
    float dbt = 0.f;
    for (int w = 0; w < NW; ++w) dbt += red[w];
    db[CS - 1] += dbt * d_old + part[0] + part[1];
  }
  __syncthreads();
  // reverse inclusive cumsum: dlogf_t = sum_{s >= t} db_s
  if (tid < CS) part[tid] = db[CS - 1 - tid];
  __syncthreads();
  if (tid < 32) warp_scan64<false>(part);
  __syncthreads();
  if (tid < CS) {
    const int sg = s0 + tid;
    if (sg < p.S) {
      const long o = (long)bh * p.S + sg;
      const float dlogf = part[CS - 1 - tid];
      const float dli = p.di[o] + gi;
      p.df[o] = dlogf * sigmoid(-p.fg[o]);
      p.di[o] = p.igate_exp ? dli : dli * sigmoid(-p.ig[o]);
    }
  }
}

constexpr size_t kLocalSmem =
    sizeof(float) * (6 * CS * LD + DH * LD + DH + 8 * CS + 4 * CS);
constexpr size_t kCarrySmem = sizeof(float) * (2 * CS * LD + DH * LD);

}  // namespace

extern "C" {

// Floats of scratch the wrapper must allocate for one call (the dC / dn
// carries of every chunk).
long mlstm_bwd_workspace_floats(int B, int S, int NH) {
  const long NS = (S + CS - 1) / CS;
  return (long)B * NH * NS * (DH * DH + DH);
}

const char* mlstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns 0 on success, else the CUDA error code of the first failed step.
int mlstm_bwd_f32(const float* q, const float* k, const float* v, const float* dh,
                  const float* ig, const float* fg, const float* cprev, const float* nprev,
                  const float* mprev, const float* btot, const float* mloc, float* dq,
                  float* dk, float* dv, float* di, float* df, float* ws, int B, int S,
                  int INNER, int NH, int igate_exp, float eps, void* stream) {
  if (INNER != NH * DH || B <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p;
  p.q = q; p.k = k; p.v = v; p.dh = dh; p.ig = ig; p.fg = fg;
  p.cprev = cprev; p.nprev = nprev; p.mprev = mprev; p.btot = btot; p.mloc = mloc;
  p.dq = dq; p.dk = dk; p.dv = dv; p.di = di; p.df = df;
  p.B = B; p.S = S; p.INNER = INNER; p.NH = NH;
  p.NS = (S + CS - 1) / CS;
  p.igate_exp = igate_exp; p.eps = eps;
  const long rows = (long)B * NH;
  p.dcs = ws;
  p.dns = ws + rows * p.NS * DH * DH;

  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bwd_chunk_local, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kLocalSmem)) != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(bwd_chunk_carry, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kCarrySmem)) != cudaSuccess) return err;
  bwd_chunk_local<<<dim3(p.NS, rows), NT, kLocalSmem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_state_scan<<<dim3(rows, DH * DH / NT), NT, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_chunk_carry<<<dim3(p.NS, rows), NT, kCarrySmem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return 0;
}

}  // extern "C"
