// The bf16 tile layer shared by the port's bf16 kernels: the ViL layer in
// bf16 (K3, vil_layer.cu's `vil16_*` stages) and the chunkwise backward in
// bf16 (K2, mlstm_bwd.cu's `bwd16_*` stages). It is the arithmetic of the
// TPU kernels at their default `mxu_dtype="bfloat16"`: both operands of
// every product are bf16 values and the sums are fp32.
//
// Tiles are 64 x 64 bf16 values in shared memory at row stride `LDH` = 72
// (144 bytes): rows stay 16-byte aligned for cp.async and ldmatrix, and the
// eight 16-byte rows one ldmatrix phase reads start 4 banks apart, so they
// cover the 32 banks once (no conflicts) in either operand order. An
// operand is written to its tile once, as the bf16 value the TPU kernel
// rounds (an activation copied in as it is, or a scaled fp32 value rounded
// once after its scale), and read by `ldmatrix` (`.trans` where the tile
// holds the operand k-major) into the fragments of
// `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`.
//
// One CTA of 8 warps (or one group of 8 warps of a larger CTA, see
// tile::thread_in_group) computes a 64 x 64 fp32 output tile C += op(A)
// op(B), in the accumulator layout of the 3xTF32 product (tile::Acc): warp w
// owns rows 16*(w % 4) .. +16 and columns 32*(w / 4) .. +32. op(A)[m][k] is
// A[m][k] (or A[k][m] when TA), op(B)[k][n] is B[k][n] (or B[n][k] when TB).
// Per 16-deep step a warp issues one ldmatrix.x4 for A, two for B and four
// mma: 3 shared-memory instructions per 4 products of 16 x 8 x 16 (operand
// values read one 4-byte load each would take 24), and no conversion.
//
// wgmma is not used: the stages' products are single 64 x 64 x 64 tiles
// with gate math between them, each read once by all 8 warps of the CTA,
// and a warpgroup's m64nNk16 would leave the second warpgroup of the CTA
// without a product or split the tile's 64 rows that the gate math walks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace tile {

using bf16 = __nv_bfloat16;

constexpr int LDH = T + 8;         // bf16 tile row stride (elements)
constexpr int HALVES = T * LDH;    // bf16 elements of one tile

// x rounded to bf16 (nearest even) and back: the value a bf16 operand holds.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8. Register i holds matrix i's (row lane/4, columns 2(lane%4),
// +1), or with TRANS its (rows 2(lane%4), +1; column lane/4).
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
}

// One 16-deep step (k0 .. k0+15) of acc += op(A) op(B) for the warp's 16 x
// 32 part (rows m0.., columns n0..) of the 64 x 64 tile.
template <bool TA, bool TB, int MODE>
__device__ __forceinline__ void mma16_k16(Acc& acc, const bf16* A, const bf16* B, int k0, int m0,
                                          int n0, int lane, int nlim) {
  const int mat = lane >> 3, r = lane & 7;
  uint32_t a[4];  // fragments (m, k): (g, 2t), (g+8, 2t), (g, 2t+8), (g+8, 2t+8)
  if (TA)
    ldsm_x4<true>(a, A + (k0 + r + 8 * (mat >> 1)) * LDH + m0 + 8 * (mat & 1));
  else
    ldsm_x4<false>(a, A + (m0 + r + 8 * (mat & 1)) * LDH + k0 + 8 * (mat >> 1));
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int nb = n0 + 16 * jj;  // two 8-column blocks: (k 2t, n g), (k 2t+8, n g) each
    if ((MODE == OUT_LOWER && nb > m0 + 15) || nb >= nlim) continue;  // warp-uniform
    uint32_t b[4];
    if (TB)
      ldsm_x4<false>(b, B + (nb + r + 8 * (mat >> 1)) * LDH + k0 + 8 * (mat & 1));
    else
      ldsm_x4<true>(b, B + (k0 + r + 8 * (mat & 1)) * LDH + nb + 8 * (mat >> 1));
    mma_bf16(acc.c[2 * jj], a, b[0], b[1]);
    if ((MODE != OUT_LOWER || nb + 8 <= m0 + 15) && nb + 8 < nlim)
      mma_bf16(acc.c[2 * jj + 1], a, b[2], b[3]);
  }
}

// acc += op(A) op(B) over k in [0, K), K a multiple of 16, for the warp's
// 16 x 32 part of the 64 x 64 tile; A and B are bf16 tiles at row stride
// LDH. `Causal` as tile::mma: OUT_LOWER leaves the 16 x 8 output fragments
// above the diagonal at zero, K_LE_M runs k only to the warp's last row,
// K_GE_M from its first. Output columns >= `nlim` and rows >= `mlim` are
// left at zero (the 8-column blocks that start there, and the warps whose
// 16 rows do, are skipped): a small head's product (head dim below 64, its
// operands zero-padded in shared memory to k 16) computes only its block.
// Every warp of the CTA (or of its group) calls it; nothing here
// synchronizes.
template <bool TA, bool TB, int MODE = FULL>
__device__ __forceinline__ void mma16(Acc& acc, const bf16* A, const bf16* B, int K = T,
                                      int nlim = T, int mlim = T) {
  const int lane = threadIdx.x & 31, w = thread_in_group() >> 5;
  const int m0 = 16 * (w & 3), n0 = 32 * (w >> 2);
  if (m0 >= mlim || n0 >= nlim) return;  // warp-uniform
  int kbeg = 0, kend = K;
  if (MODE == K_LE_M) kend = K < m0 + 16 ? K : m0 + 16;
  if (MODE == K_GE_M) kbeg = m0;
#pragma unroll 4
  for (int k0 = kbeg; k0 < kend; k0 += 16)
    mma16_k16<TA, TB, MODE>(acc, A, B, k0, m0, n0, lane, nlim);
}

// Writes the accumulators, rounded to bf16, to a tile.
__device__ __forceinline__ void store16(const Acc& acc, bf16* C) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(C + Acc::row(r) * LDH + Acc::col(j, r)) =
          __floats2bfloat162_rn(acc.c[j][r], acc.c[j][r + 1]);
    }
}

// ---- staging -----------------------------------------------------------------------

// Starts the copy of a ROWS x 64 block of a row-major bf16 global matrix
// (row stride `ld` elements, `src` its element (0, 0), a valid address)
// into a tile as it is; rows >= nrows and columns >= ncols land as zeros.
// 16-byte cp.async where the rows are 16-byte aligned (the caller commits
// and waits), else plain 2-byte copies (the caller's barrier covers them).
template <int ROWS = T>
__device__ __forceinline__ void load16(bf16* dst, const bf16* src, long ld, int nrows,
                                       int ncols) {
  const bool vec = (ld & 7) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (vec) {
    for (int i = thread_in_group(); i < ROWS * (T / 8); i += THREADS) {
      const int r = i >> 3, c = 8 * (i & 7);
      const int left = ncols - c;
      const int nb = r < nrows && left > 0 ? 2 * (left < 8 ? left : 8) : 0;
      cp_async16(dst + r * LDH + c, nb ? src + r * ld + c : src, nb);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int i = thread_in_group(); i < ROWS * T; i += THREADS) {
      const int r = i >> 6, c = i & 63;
      dst[r * LDH + c] = r < nrows && c < ncols ? src[r * ld + c] : zero;
    }
  }
}

}  // namespace tile
