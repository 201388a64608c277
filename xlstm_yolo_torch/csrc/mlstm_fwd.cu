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
// 24 (DH 64) to 72 (DH 256) op/B, so the least time is set by operations.
// Every product runs on the tensor cores through the shared 3xTF32 tile
// product (tile_mma.cuh: fp32 accuracy at a third of the TF32 rate).
//
// What the design does about it: the TPU kernel walked the chunks of a row
// in order on one core with (C, n, m) in scratch. Here a cluster of DH / 64
// CTAs walks them the same way, in one launch; CTA r of the cluster owns
// value tile r (columns 64r .. 64r+63 of v, C and h) and the r-th 64-column
// slice of q and k. Per chunk:
//   1. the gate logs, the stabilizer and the chunk's decay weights (every
//      CTA alike, from the 64 gate preacts);
//   2. for each 64-column slice c of q and k, streamed through shared memory
//      by cp.async: the inter-chunk q_c C[c, r] (C's slice staged from
//      registers into one shared tile) and the state update C[c, r] =
//      decay C[c, r] + k_c^T (g v_r), in one k loop; at c = r also this
//      CTA's share of q k^T (q_r k_r^T) and of q n, and the n update;
//   3. with several CTAs a row, they sum their q k^T and q n shares in rank
//      order through distributed shared memory (one cluster barrier per
//      chunk, two exchange buffers by chunk parity), so q k^T is computed
//      once per chunk and head and every CTA gets the same E and normalizer;
//   4. h[:, tile r] = (E v_r + q C[:, r]) / normalizer.
// The carried C[:, r] (DH x 64) lives in registers as DH / 64 accumulator
// tiles. At DH 64 and 128 a CTA has two groups of 256 threads: group 0 runs
// the recurrence (step 2's products, then step 4) while group 1 runs the
// chunk's own part (q k^T, q n, the n update, E and the normalizer), and
// the next stage's loads fly during this one's products (ten 64 x 68 tiles
// of shared memory, 174 KB). At DH 256 a cluster of four such CTAs, one an
// SM, left only 30 clusters resident on the card and the language model's
// 32 rows ran in two waves; there a CTA has one group and one buffer (six
// tiles, 107 KB, at most 128 registers a thread) and two share an SM, so
// 62 clusters fit. Shared memory never grows with DH. Without a workspace
// nothing but h goes to device memory. With one (under autograd, where the
// chunkwise backward reads them) the state carried into each chunk is
// written as `mlstm_fwd_workspace_layout` lays it out.
//
// The walk replaced a split into three launches (chunk summaries, an
// elementwise state scan, chunk outputs) whose states round-tripped device
// memory; PERF.md has both on the card.
//
// The stabilizer is the recurrent one per position, stab_t = max(b_t +
// cummax(logi - b)_t, m_prev + b_t), with m = 0 carried into the first
// chunk; it does not depend on the chunk length, so the result agrees with
// any other chunking up to rounding. The chunk length is 64. A sequence that
// is not a multiple of 64 is handled by masking the last chunk: missing
// positions load as zeros with an input-gate log of -1e30 and a forget-gate
// log of 0, so they add nothing to any valid position.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

using tile::Acc;
using tile::LDS;

constexpr int CS = 64;                 // chunk length
constexpr int VT = 64;                 // value tile and q/k slice width
constexpr int MAX_ND = 4;              // widest head dim taken: 64 * MAX_ND
constexpr int NT = tile::THREADS;      // threads of one group (one tile product)
constexpr int TF = tile::FLOATS;       // one 64 x 68 tile
constexpr float NEG = -1e30f;

// How a head dim walks (the note at the top says why): ND = DH / 64 CTAs a
// row, groups() groups of NT threads a CTA, buffers() buffers a stage.
__host__ __device__ constexpr int groups(int nd) { return nd == 4 ? 1 : 2; }
__host__ __device__ constexpr int buffers(int nd) { return nd == 4 ? 1 : 2; }

// shared memory: q and k slices and the value tile (BUF each), the C
// staging tile and E (one tile with one group), the exchange tiles (2, by
// chunk parity), then the gate preacts (BUF) and the per-chunk vectors
__host__ __device__ constexpr size_t smem_bytes(int nd) {
  return sizeof(float) * ((3 * buffers(nd) + 2 + groups(nd)) * TF + 2 * CS * buffers(nd) +
                          8 * CS + 4 * VT + VT + 4);
}

struct Params {
  const float* q;     // (rows, S, DH), unscaled
  const float* k;
  const float* v;
  const float* ig;    // (rows, S) gate preacts
  const float* fg;
  float* h;           // (rows, S, DH)
  // workspace, or all null: the states stay on chip
  float* kv;          // (rows, NS, DH, DH): C carried into each chunk, [k index][v index]
  float* ksum;        // (rows, NS, DH): n carried in
  float* btot;        // (rows, NS): the chunk's total log decay
  float* mloc;        // (rows, NS): its local max
  float* mprev;       // (rows, NS): the stabilizer carried in
  int S, NS, igate_exp;
  float qscale, eps;
};

__device__ __forceinline__ float logsigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Barrier of the NT threads of group 1 alone (barrier 0 is __syncthreads).
__device__ __forceinline__ void group1_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(NT)); }

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

// Writes a 64 x 64 accumulator tile to global memory at row stride ld.
__device__ __forceinline__ void store_global(const Acc& acc, float* dst, long ld) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 2 * hh;
      *reinterpret_cast<float2*>(dst + Acc::row(r) * ld + Acc::col(j, r)) =
          make_float2(acc.c[j][r], acc.c[j][r + 1]);
    }
}

// One cluster of ND CTAs per row (batch * head), CTA rank r = value tile r.
template <int ND>
__global__ void __launch_bounds__(NT * groups(ND), 3 - buffers(ND)) mlstm_walk(Params p) {
  constexpr int DH = ND * VT, G = groups(ND), BUF = buffers(ND);
  extern __shared__ __align__(16) float sm[];
  float* qb = sm;                // [BUF] q slices, unscaled
  float* kb = qb + BUF * TF;     // [BUF] k slices
  float* vb = kb + BUF * TF;     // [BUF] value tile, by chunk parity
  float* Cst = vb + BUF * TF;    // C[c, r] staged for q_c C
  float* E = Cst + (G - 1) * TF; // E (row t, col s); with one group the staging tile
  float* X = E + TF;             // [2] q_r k_r^T, with q_r n_r in column 64, by chunk parity
  float* graw = X + 2 * TF;      // [BUF][2][CS] gate preacts (input, forget), by chunk parity
  float* bcs = graw + BUF * 2 * CS;  // CS cumsum of log f
  float* li = bcs + CS;          // CS log input gate
  float* cm = li + CS;           // CS running max of li - b
  float* stab = cm + CS;         // CS stabilizer
  float* av = stab + CS;         // CS inter-chunk scale
  float* den = av + CS;          // CS normalizer
  float* gwd = den + CS;         // CS weights of the chunk's steps in the state update
  float* qnv = gwd + CS;         // CS q n (one CTA a row)
  float* npart = qnv + CS;       // [4][VT] the n update's partial sums
  float* nv = npart + 4 * VT;    // VT carried n, slice r
  float* scal = nv + VT;         // [0] decay of the carried state, [1] the new m
  const int tid = threadIdx.x, lt = tile::thread_in_group(), lane = tid & 31;
  const int gwarp = lt >> 5;     // warp within the group
  const bool rec = tid < NT;               // group 0: the recurrence, E v, h
  const bool own = G == 1 || tid >= NT;    // the chunk's own part
  const int rank = ND > 1 ? (int)tile::cluster_rank() : 0;
  const int bh = blockIdx.y, S = p.S, NS = p.NS, NST = NS * ND;
  const float QS = p.qscale;
  const float* rowq = p.q + (long)bh * S * DH;
  const float* rowk = p.k + (long)bh * S * DH;
  const float* rowv = p.v + (long)bh * S * DH + rank * VT;

  // stage st = (chunk st / ND, slice st % ND): q and k slices, and with the
  // first slice of a chunk its value tile and gate preacts; issued by group 0
  auto issue = [&](int st) {
    const int j = st / ND, c = st % ND, buf = BUF == 2 ? st & 1 : 0, s0 = j * CS;
    const int cb = BUF == 2 ? j & 1 : 0;
    const int nrows = S - s0 < CS ? S - s0 : CS;
    const long off = (long)s0 * DH + c * VT;
    tile::load_async<CS, VT>(qb + buf * TF, LDS, rowq + off, DH, nrows, VT);
    tile::load_async<CS, VT>(kb + buf * TF, LDS, rowk + off, DH, nrows, VT);
    if (c == 0) {
      tile::load_async<CS, VT>(vb + cb * TF, LDS, rowv + (long)s0 * DH, DH, nrows, VT);
      if (tid < 2 * CS) {
        const int s = tid % CS;
        const float* src = tid < CS ? p.ig : p.fg;
        const long at = (long)bh * S + s0 + s;
        tile::cp_async4(graw + cb * 2 * CS + tid, s0 + s < S ? src + at : src,
                        s0 + s < S ? 4 : 0);
      }
    }
    tile::cp_async_commit();
  };

  Acc C[ND];
#pragma unroll
  for (int c = 0; c < ND; ++c) C[c].zero();
  if (tid < VT) nv[tid] = 0.f;
  float m_prev = 0.f;
  if (BUF == 2 && rec) issue(0);

  for (int j = 0; j < NS; ++j) {
    const int s0 = j * CS;
    const long base = (long)bh * NS + j;
    const int cb = BUF == 2 ? j & 1 : 0;
    const float* vs = vb + cb * TF;
    float* Xj = X + (j & 1) * TF;
    Acc inter;
    inter.zero();
    float dold = 0.f;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int st = j * ND + c, buf = BUF == 2 ? st & 1 : 0;
      __syncthreads();  // the previous stage's buffers, Cst, E and nv are free
      if (rec) {
        if (BUF == 1) issue(st);
        else if (st + 1 < NST) issue(st + 1);
        else tile::cp_async_commit();  // an empty group keeps the count
        tile::store(C[c], Cst, LDS);   // C[c, r] as carried into chunk j
        if (p.kv != nullptr) store_global(C[c], p.kv + (base * DH + c * VT) * DH + rank * VT, DH);
        if (BUF == 2) tile::cp_async_wait_one();
        else tile::cp_async_wait_all();
      }
      __syncthreads();
      if (c == 0) {
        // gate math of chunk j, by warp 0 (lane l owns positions 2l, 2l+1)
        if (tid < 32) {
          const float* gi = graw + cb * 2 * CS;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int s = 2 * lane + u;
            const bool ok = s0 + s < S;
            bcs[s] = ok ? logsigmoid(gi[CS + s]) : 0.f;
            li[s] = ok ? (p.igate_exp ? gi[s] : logsigmoid(gi[s])) : NEG;
          }
          __syncwarp();
          warp_scan64<false>(bcs);
          __syncwarp();
#pragma unroll
          for (int u = 0; u < 2; ++u) cm[2 * lane + u] = li[2 * lane + u] - bcs[2 * lane + u];
          __syncwarp();
          warp_scan64<true>(cm);
          __syncwarp();
          const float btot = bcs[CS - 1];
          float glog[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            // row max of log D: b_t + max_{s<=t}(li_s - b_s); the stabilizer
            // also covers the carried-in term m_prev + b_t
            const int s = 2 * lane + u;
            const float inter_log = m_prev + bcs[s];
            const float sv = fmaxf(bcs[s] + cm[s], inter_log);
            stab[s] = sv;
            av[s] = expf(inter_log - sv);
            glog[u] = li[s] + (btot - bcs[s]);
          }
          const float mloc = warp_max(fmaxf(glog[0], glog[1]));
          const float m_new = fmaxf(btot + m_prev, mloc);
          const float dnew = expf(mloc - m_new);
#pragma unroll
          for (int u = 0; u < 2; ++u) gwd[2 * lane + u] = expf(glog[u] - mloc) * dnew;
          if (lane == 0) {
            scal[0] = expf(btot + m_prev - m_new);
            scal[1] = m_new;
            if (p.kv != nullptr && rank == 0) {
              p.btot[base] = btot;
              p.mloc[base] = mloc;
              p.mprev[base] = m_prev;
            }
          }
        }
        if (p.kv != nullptr && tid < VT) p.ksum[base * DH + rank * VT + tid] = nv[tid];
        __syncthreads();
      }
      dold = scal[0];
      const float* qs = qb + buf * TF;
      const float* ks = kb + buf * TF;
      if (rec) {
        // q_c C[c, r] on the carried C, and C[c, r] = decay C[c, r] +
        // k_c^T (g v_r) (gwd scales column s of k_c^T), in one k loop
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) C[c].c[jj][rr] *= dold;
        tile::mma_pair<false, false, true, false>(inter, qs, Cst, C[c], ks, vs, LDS, VT, gwd);
      }
      if (own && c == rank) {
        Acc s;
        s.zero();
        tile::mma<false, true, tile::OUT_LOWER>(s, qs, LDS, ks, LDS, VT);  // q_r k_r^T
        {  // q_r n_r on the carried n: four threads a row
          const int t = lt >> 2, part = 16 * (lt & 3);
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < 16; ++i) a += qs[t * LDS + part + i] * nv[part + i];
          a = tile::quad_sum(a);
          if ((lt & 3) == 0) (ND > 1 ? Xj + t * LDS + VT : qnv + t)[0] = a;
        }
        {  // the n update's partial sums over four quarters of the chunk,
           // summed into nv after the chunk's barrier
          const int d = lt & (VT - 1), q0 = (lt >> 6) * (CS / 4);
          float a = 0.f;
#pragma unroll
          for (int s_ = 0; s_ < CS / 4; ++s_) a += gwd[q0 + s_] * ks[(q0 + s_) * LDS + d];
          npart[lt] = a;
        }
        if (ND > 1) {
          tile::store(s, Xj, LDS);
        } else {  // one CTA a row: E and the normalizer now, beside the recurrence
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int t = Acc::row(r), cc = Acc::col(jj, r);
              E[t * LDS + cc] =
                  cc <= t ? s.c[jj][r] * QS * expf(li[cc] - bcs[cc] + bcs[t] - stab[t]) : 0.f;
            }
          if (G == 2) group1_sync();
          else __syncthreads();
          const int t = lt >> 2, part = 16 * (lt & 3);
          float es = 0.f;
#pragma unroll
          for (int i = 0; i < 16; ++i) es += E[t * LDS + part + i];
          es = tile::quad_sum(es);
          if ((lt & 3) == 0)
            den[t] = fmaxf(fabsf(es + av[t] * QS * qnv[t]), expf(-stab[t])) + p.eps;
        }
      }
    }

    // with several CTAs a row: their q k^T and q n shares, summed in rank order
    if (ND > 1) tile::cluster_sync();
    else __syncthreads();
    if (own && lt < VT)  // every thread read nv before the barrier
      nv[lt] = dold * nv[lt] + ((npart[lt] + npart[VT + lt]) +
                                (npart[2 * VT + lt] + npart[3 * VT + lt]));
    if (ND > 1 && own) {
      const float* xr[ND];
#pragma unroll
      for (int r = 0; r < ND; ++r) xr[r] = tile::cluster_peer(Xj, r);
#pragma unroll
      for (int u = 0; u < CS * CS / 4 / NT; ++u) {
        const int i = lt + u * NT, t = i >> 4, s4 = 4 * (i & 15);
        float4 xs[ND];  // every share's load in flight at once
#pragma unroll
        for (int r = 0; r < ND; ++r) xs[r] = *reinterpret_cast<const float4*>(xr[r] + t * LDS + s4);
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < ND; ++r) {
          a.x += xs[r].x;
          a.y += xs[r].y;
          a.z += xs[r].z;
          a.w += xs[r].w;
        }
        const float row = bcs[t] - stab[t];
        const float av4[4] = {a.x, a.y, a.z, a.w};
        float es = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int s = s4 + w;
          const float e = s <= t ? av4[w] * QS * expf(li[s] - bcs[s] + row) : 0.f;
          E[t * LDS + s] = e;
          es += e;
        }
        // the row's sum over the 16 lanes that hold it, then its normalizer
        for (int o = 1; o < 16; o <<= 1) es += __shfl_xor_sync(0xffffffffu, es, o);
        if ((lane & 15) == 0) {
          float qn = 0.f;
#pragma unroll
          for (int r = 0; r < ND; ++r) qn += xr[r][t * LDS + VT];
          den[t] = fmaxf(fabsf(es + av[t] * QS * qn), expf(-stab[t])) + p.eps;
        }
      }
    }
    if (ND > 1) __syncthreads();
    if (rec) {
      Acc hv;
      hv.zero();
      tile::mma<false, false, tile::K_LE_M>(hv, E, LDS, vs, LDS, CS);
      float* hout = p.h + ((long)bh * S + s0) * DH + rank * VT;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 2 * hh, t = Acc::row(r);
          if (s0 + t < S) {
            const float inv = 1.f / den[t], sc = av[t] * QS;
            *reinterpret_cast<float2*>(hout + (long)t * DH + Acc::col(jj, r)) =
                make_float2((hv.c[jj][r] + sc * inter.c[jj][r]) * inv,
                            (hv.c[jj][r + 1] + sc * inter.c[jj][r + 1]) * inv);
          }
        }
    }
    m_prev = scal[1];
  }
  if (ND > 1) tile::cluster_sync();  // no CTA leaves while a peer may read its X
}

template <int ND>
cudaError_t launch(const Params& p, int rows, cudaStream_t st) {
  constexpr size_t SMEM = smem_bytes(ND);
  static int configured = -1;  // device on which the shared-memory limit is raised
  int dev;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev != configured) {
    if ((err = cudaFuncSetAttribute(mlstm_walk<ND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)SMEM)) != cudaSuccess)
      return err;
    configured = dev;
  }
  return tile::launch_cluster(mlstm_walk<ND>, dim3(ND, rows), dim3(NT * groups(ND)), SMEM, st,
                              ND, p);
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
// contiguous fp32. ws is null (no states leave the chip) or as
// mlstm_fwd_workspace_layout says. Returns 0 on success, else the CUDA error
// code of the launch (cudaErrorInvalidValue for an unsupported shape).
int mlstm_fwd_f32(const float* q, const float* k, const float* v, const float* ig,
                  const float* fg, float* h, float* ws, int rows, int S, int DH, int igate_exp,
                  float eps, void* stream) {
  if ((DH != 64 && DH != 128 && DH != 256) || rows <= 0 || rows > 65535 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p;
  p.q = q; p.k = k; p.v = v; p.ig = ig; p.fg = fg; p.h = h;
  p.S = S; p.NS = (S + CS - 1) / CS;
  p.igate_exp = igate_exp; p.qscale = 1.f / sqrtf((float)DH); p.eps = eps;
  p.kv = p.ksum = p.btot = p.mloc = p.mprev = nullptr;
  if (ws != nullptr) {
    long off[6];
    mlstm_fwd_workspace_layout(rows, S, DH, off);
    p.kv = ws + off[0];
    p.ksum = ws + off[1];
    p.btot = ws + off[2];
    p.mloc = ws + off[3];
    p.mprev = ws + off[4];
  }
  switch (DH / VT) {
    case 1: return static_cast<int>(launch<1>(p, rows, st));
    case 2: return static_cast<int>(launch<2>(p, rows, st));
    default: return static_cast<int>(launch<MAX_ND>(p, rows, st));
  }
}

}  // extern "C"
