// The matrix products of the RNN training kernels, written once for the
// three shapes a bidirectional layer needs, G = NG H gate columns (the C
// entries of bigru_train.cu run them for K4/K5, NG = 3, and for K6, NG = 4):
//   the input projection  xg[d] = X W_ih[d] + bias       (M = L N, K = C)
//   the input gradient    dx = sum_d op(DXG[d]) W_ih[d]^T (M = L N, K = G)
//   the weight gradients  dW[d] = A^T op(B[d])            (K = L N rows)
// and, in the simt design, the column sums of B beside the weight gradients
// (the bias gradients; the tc design's backward recurrence sums them).
// rnn_proj, rnn_dx, rnn_wgrad, wg_dx and wg_wgrad at the end describe each
// as jobs.
//
// Three kernels, by design:
//   f32_tma_kernel (the simt design's products on f32 operands: K1's,
//     K2's and the K4/K6 fp32 forwards' projection xg, the K5/K6 fp32
//     backward's dx and weight and bias gradients): exact f32 FMAs on the
//     CUDA cores, no TF32. A CTA of 128 threads a 128 x 128 tile (the
//     projection and dx: 112 or 128 rows; dx by 16 .. 128 columns), 8 x 16
//     (or 7 x 16) outputs a thread, two CTAs an SM; the operands by TMA
//     into a ring of FT_STAGES = 3 slots of FT_KT = 32 k on mbarriers,
//     refilled by the last warp done with a slot (no CTA barrier and no
//     copy instructions in the k loop); K-major images under TMA's swizzle,
//     MN-major ones dense; X's rows at C % 4 != 0 by the CTA's own 4-byte
//     copies. What bounds it at the models' shapes (L N = 21,504
//     rows, C = 512, G = 768 or 1,024 a direction) is the FMA rate: the
//     projection and dx 2 L N C 2G FLOPs (33.8 / 45.1 GFLOP, 0.50 / 0.67
//     ms at 67 TFLOP/s), the weight gradients 2 L N 2G (C + H) (50.7 /
//     67.6 GFLOP, 0.76 / 1.01 ms), each far above its bytes' time; at C =
//     11 the projection and dx are bound by xg's and dxg's bytes. Each
//     output is the simt kernel's chain (below), so every bit stays.
//   gemm_simt_kernel (the simt design on bf16 operands, the shapes tc
//     refuses: H = 16; f32 operands run f32_tma_kernel): exact f32 FMAs on
//     the CUDA cores. Block tile 128 x 128, k tile 8, 8 x 8 outputs a
//     thread, operand tiles in shared memory
//     (double-buffered; the next tile is loaded into registers while the
//     current one is multiplied). It reads its operands in the layout the
//     caller already holds (no transposed copies): each side is
//     "k-contiguous" (element (i, k) at p[i ld + k]) or not (element (i, k)
//     at p[(k + koff) ld + i]), a template argument. Elements with k outside
//     [klo, khi) read as 0: the weight gradient of W_hh reads h_prev from
//     the layer output one step back in the direction's own time.
//   wgemm_kernel (the tc design's dx and weight gradients, bf16): Hopper's
//     own path, as K1's projection (birnn_tc.cu::tc_gemm_kernel) runs it.
//     TMA loads the operands' tiles into a three-stage ring on mbarriers (one
//     producer warp); two consumer warpgroups run wgmma m64nBNk16 from shared
//     memory into f32 accumulators; two CTAs an SM. The gate gradients reach
//     it as bf16 copies that the backward recurrence stores (TMA cannot round
//     f32 on the way). dx: A = DXG[d] (L N, G) and B = W_ih[d] (C, G) both
//     K-major as stored, the two directions two k segments of one
//     accumulator, BN = 16, 32, 64 or 128 columns by C. dW: A = X^T or
//     H_prev^T and B = DXG[d] or DHG[d], all MN-major as stored (A through
//     the instruction's trans-a flag); H_prev is the layer output read at
//     the row coordinate k -+ N, and TMA fills the rows outside the tensor
//     (the direction's first step) with zeros. X's rows at C % 8 != 0 (C =
//     11, 21, 28, 52: not 16-byte multiples, which TMA needs) are written
//     into the same swizzled image by the producer warp's plain loads.
// The bound of the tc products at the main path's shapes is their
// operations (bigru_train.cu's header): they read each operand once from
// device memory or L2 and are far above the card's ridge.
//
// Determinism: every output element has one owner thread (a warpgroup's
// accumulator in wgemm_kernel) that sums its k in a fixed order (in the two
// simt kernels one fmaf chain over k ascending from 0.0f: the zeros they
// pad k with add nothing, so their tile sizes do not move a bit); a long
// contraction is cut into S fixed row slices whose partials gemm_sum_slices
// adds in slice order. No atomics on data, so reruns are bit-equal.

#pragma once

#include <atomic>
#include <type_traits>

#include "mma_tile.cuh"
#include "rnn_common.cuh"
#include "wgmma_tile.cuh"

#define GM_THREADS 256
#define GM_BM 128
#define GM_BN 128
#define SG_BK 8   // k tile of the simt route
// row granularity of the simt weight-gradient slices (the k tile of the
// tensor-core route the slices were first cut for; kept, so the simt
// slices and their bits stay as they were)
#define SLICE_K 32

// One operand of one product: base pointer, row stride (elements), a storage
// row offset added to k (used where k is the row index) and the k range that
// holds data. vec: the host found ld and koff multiples of 4 and p aligned
// for a 4-element vector load.
struct GemmOp {
  const void* p;
  long long ld, koff;
  int klo, khi, vec;
};

// c (+ slice offset) = sum over nseg segments of A_seg B_seg (+ bias).
struct GemmJob {
  GemmOp a[2], b[2];
  int nseg, M, N;
  float* c;
  long long ldc;
  const float* bias0;  // c[m][n] += bias0[n] + (n < nfold ? bias1[n] : 0)
  const float* bias1;
  int nfold;
  float* colsum;  // column sums of B (segment 0, unrounded), or null
};

struct GemmParams {
  GemmJob job[4];
  int K, S, Ks;             // contraction length; S slices of Ks rows
  long long slice_stride;   // floats between two slices' outputs
};

// Read-only global loads issued exactly where they stand: volatile asm keeps
// its place among the other asm statements (the mma and ldmatrix ones), so
// the next tile's loads fly while this tile is multiplied instead of sinking
// to their first use one after another (as ld_nc_f2 in mma_tile.cuh).
__device__ __forceinline__ void gm_ld(const float* p, float v[4]) {
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "l"(p));
}
__device__ __forceinline__ void gm_ld(const __nv_bfloat16* p, float v[4]) {
  uint32_t lo, hi;
  asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];\n" : "=r"(lo), "=r"(hi) : "l"(p));
  const float2 a = unpack_bf16x2(lo), b = unpack_bf16x2(hi);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ float gm_ld1(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float gm_ld1(const __nv_bfloat16* p) {
  unsigned short v;
  asm volatile("ld.global.nc.u16 %0, [%1];\n" : "=h"(v) : "l"(p));
  return __uint_as_float((uint32_t)v << 16);
}

// four consecutive elements along an operand's contiguous dimension, widened
// to f32; bit e of mask says element e holds data (else 0)
template <typename TV>
__device__ __forceinline__ void gm_load4(const TV* p, bool vec, unsigned mask,
                                         float v[4]) {
  if (vec && mask == 0xFu) {
    gm_ld(p, v);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = ((mask >> e) & 1u) ? gm_ld1(p + e) : 0.0f;
}

// The 4-vector of operand o at (outer index i, k): KC = contiguous along k.
// Vectors run along the contiguous dimension; [k_lo, k_hi) is the k range of
// this slice that holds data, n_outer the outer size (M or N).
template <typename TV, bool KC>
__device__ __forceinline__ void gm_fetch(const GemmOp& o, int i, int k, int k_lo,
                                         int k_hi, int n_outer, float v[4]) {
  const TV* base = static_cast<const TV*>(o.p);
  unsigned mask = 0u;
  if constexpr (KC) {
    if (i < n_outer) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k + e >= k_lo && k + e < k_hi) mask |= 1u << e;
    }
    gm_load4<TV>(base + (size_t)i * o.ld + (k + o.koff), o.vec != 0, mask, v);
  } else {
    if (k >= k_lo && k < k_hi) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i + e < n_outer) mask |= 1u << e;
    }
    gm_load4<TV>(base + (size_t)(k + o.koff) * o.ld + i, o.vec != 0, mask, v);
  }
}

// the bias of output column n
__device__ __forceinline__ float gm_bias(const GemmJob& jb, int n) {
  if (jb.bias0 == nullptr) return 0.0f;
  return jb.bias0[n] + (n < jb.nfold ? jb.bias1[n] : 0.0f);
}

// ---------------------------------------------------------------- simt

// TA, TB: the operands' element types; TR: the operand type of the product
// (values are rounded to it, Op<TR>::operand, as the plain version's op()).
template <typename TA, bool A_KC, typename TB, bool B_KC, typename TR>
__global__ void __launch_bounds__(GM_THREADS, 2) gemm_simt_kernel(const GemmParams p) {
  __shared__ __align__(16) float As[2][SG_BK][GM_BM];
  __shared__ __align__(16) float Bs[2][SG_BK][GM_BN];
  const int ji = blockIdx.z / p.S, slice = blockIdx.z % p.S;
  const GemmJob& jb = p.job[ji];
  const int m0 = blockIdx.y * GM_BM, n0 = blockIdx.x * GM_BN;
  if (m0 >= jb.M || n0 >= jb.N) return;  // block-uniform, before any barrier
  const int kb = slice * p.Ks, ke = min(p.K, kb + p.Ks);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // this thread's operand vector of a k tile
  const int a_i = A_KC ? tid / 2 : (tid % 32) * 4, a_k = A_KC ? (tid % 2) * 4 : tid / 32;
  const int b_i = B_KC ? tid / 2 : (tid % 32) * 4, b_k = B_KC ? (tid % 2) * 4 : tid / 32;
  const bool do_cs = !B_KC && jb.colsum != nullptr && blockIdx.y == 0;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  float cs[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int seg = 0; seg < jb.nseg; ++seg) {
    const GemmOp& A = jb.a[seg];
    const GemmOp& B = jb.b[seg];
    const int alo = max(kb, A.klo), ahi = min(ke, A.khi);
    const int blo = max(kb, B.klo), bhi = min(ke, B.khi);
    const bool cs_here = do_cs && seg == 0;
    float ra[4], rb[4];
    auto fetch = [&](int k0) {
      gm_fetch<TA, A_KC>(A, m0 + a_i, k0 + a_k, alo, ahi, jb.M, ra);
      gm_fetch<TB, B_KC>(B, n0 + b_i, k0 + b_k, blo, bhi, jb.N, rb);
    };
    auto stash = [&](int buf) {
      if (cs_here) {
#pragma unroll
        for (int e = 0; e < 4; ++e) cs[e] += rb[e];
      }
      float av[4], bv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        av[e] = Op<TR>::operand(ra[e]);
        bv[e] = Op<TR>::operand(rb[e]);
      }
      if constexpr (A_KC) {
#pragma unroll
        for (int e = 0; e < 4; ++e) As[buf][a_k + e][a_i] = av[e];
      } else {
        *reinterpret_cast<float4*>(&As[buf][a_k][a_i]) = make_float4(av[0], av[1], av[2], av[3]);
      }
      if constexpr (B_KC) {
#pragma unroll
        for (int e = 0; e < 4; ++e) Bs[buf][b_k + e][b_i] = bv[e];
      } else {
        *reinterpret_cast<float4*>(&Bs[buf][b_k][b_i]) = make_float4(bv[0], bv[1], bv[2], bv[3]);
      }
    };
    fetch(kb);
    stash(0);
    __syncthreads();
    int buf = 0;
    for (int k0 = kb; k0 < ke; k0 += SG_BK) {
      const bool more = k0 + SG_BK < ke;
      if (more) fetch(k0 + SG_BK);
#pragma unroll
      for (int kk = 0; kk < SG_BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (more) stash(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }
  }

  const size_t so = (size_t)slice * p.slice_stride;
  const bool vec_c = jb.ldc % 4 == 0 && (uintptr_t)(jb.c + so) % 16 == 0;
#pragma unroll
  for (int jh = 0; jh < 2; ++jh) {
    const int nq = n0 + jh * 64 + tx * 4;  // this thread's 4 columns
    float bias[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) bias[e] = nq + e < jb.N ? gm_bias(jb, nq + e) : 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
      if (m >= jb.M) continue;
      float* cp = jb.c + so + (size_t)m * jb.ldc + nq;
      const float* a = &acc[i][jh * 4];
      if (vec_c && nq + 3 < jb.N) {
        *reinterpret_cast<float4*>(cp) =
            make_float4(a[0] + bias[0], a[1] + bias[1], a[2] + bias[2], a[3] + bias[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (nq + e < jb.N) cp[e] = a[e] + bias[e];
      }
    }
  }
  if (do_cs) {  // the 8 threads of a column group add their rows in k order
    float* cs_s = &As[0][0][0];  // 8 x 128 floats, free after the last barrier
#pragma unroll
    for (int e = 0; e < 4; ++e) cs_s[b_k * GM_BN + b_i + e] = cs[e];
    __syncthreads();
    if (tid < GM_BN && n0 + tid < jb.N) {
      float s = 0.0f;
      for (int r = 0; r < SG_BK; ++r) s += cs_s[r * GM_BN + tid];
      jb.colsum[so + n0 + tid] = s;
    }
  }
}

// ---------------------------------------------------------------- exact f32 products

// f32_tma_kernel: the simt design's products on f32 operands, in exact f32
// FMAs on the CUDA cores (no TF32): the input projection (A = X K-major, B =
// W_ih[d] MN-major, one job a direction), dx (both K-major, the two
// directions two k segments of one chain) and the weight gradients with
// the bias gradients beside them (both MN-major, four jobs, S row slices).
// A CTA of FT_THREADS threads, 16 thread rows (ty) by 8 thread columns
// (tx), owns a tile of BM = 16 RM rows by BN = 8 TN columns, a thread RM
// rows by TN columns (RM = 8, TN = 16: 128 x 128; two CTAs an SM).
//
// The operands reach shared memory by TMA, a ring of FT_STAGES slots of
// FT_KT k each (A's box and B's box a slot), on one mbarrier a slot that
// completes with the boxes' bytes. No CTA barrier in the k loop and no copy
// addresses or predicates in the threads: thread 0 loads the first
// FT_STAGES slots, and the last of the four warps done with a slot (a
// shared count a slot, one atomic a warp) loads the CTA's next k tile into
// it. TMA fills whatever lies outside the tensor with zeros: rows past M,
// k past the operand, and h_prev's rows before a direction's first step
// (its row coordinate k -+ N runs outside out; past L N, where the forward
// half's shifted rows still lie inside out, B's rows are zeros, and a
// finite a times 0 adds nothing). The images:
//   K-major (element (i, k) at p[i ld + k]): [i][FT_KT], a row of 64 or 128
//     bytes under TMA's 64- or 128-byte swizzle (16-byte chunk c of row r
//     at chunk c ^ ft_swz(r)); a thread's rows are ty + 16 i (A) and its
//     columns tx + 8 j (B), so a thread's swizzle is one value and the 8
//     rows a quarter warp reads lie on distinct banks;
//   MN-major (element (i, k) at p[k ld + i]): [k][128] dense, read 4
//     consecutive i at once; a thread's rows 4 ty + i and 64 + 4 ty + i - 4,
//     its columns 32 (j / 4) + 4 tx + j % 4.
// X's rows at C % 4 != 0 (C = 11, 21: no 16-byte multiple, which TMA needs)
// are written into the same image by the CTA's own 4-byte asynchronous
// copies, one CTA barrier a k tile (a_plain: layer 0's projection and dW_ih only). The
// geometry (chip_smoke.py's f32_gemm_sweep on an H100): slots of 32 k, 3 of
// them (96 KB, two CTAs an SM), and a loop body of 8 k (FT_UNROLL chunks of
// 4; 1,024 FFMA, 16 KB of code) beat slots of 16 k and tiles unrolled
// whole (32 or 64 KB of code in the loop); a refill issued later than the
// last release (by the next tile's middle, or by one loader warp that
// polls) lost at every shape. The projection and dx take 112-row tiles
// where those fill the waves better (ft_rows).
//
// What bounds it at the models' shapes (L N = 21,504 rows, C = 512, G = 768
// or 1,024 a direction) is the FMA rate: the projection and dx 2 L N C 2G
// FLOPs (33.8 / 45.1 GFLOP, 0.50 / 0.67 ms at 67 TFLOP/s), the weight
// gradients 2 L N 2G (C + H) (50.7 / 67.6 GFLOP, 0.76 / 1.01 ms), far above
// the bytes' time (xg or dxg, 132 / 176 MB: 0.04 / 0.05 ms at 3.35 TB/s); at
// C = 11 the projection and dx are bound by xg's and dxg's bytes. A k
// costs a thread RM + TN operand words for RM TN FMAs.
//
// Every bit stays: each output element is one thread's fmaf chain from
// 0.0f over the segments' k ascending (the slice's rows for the weight
// gradients; the zeros TMA pads with add nothing), then + the bias as
// gm_bias gives it (0.0f without one), as gemm_simt_kernel adds it. With a
// colsum (B MN-major), the CTAs of the first row tile also sum B's columns
// over segment 0's rows as gemm_simt_kernel does: eight plain partials a
// column from 0.0f, the rows whose index is r (mod 8) ascending in partial
// r, then added for r = 0 .. 7 from 0.0f. Slices hold a multiple of
// SLICE_K rows, so no k tile crosses a slice's end.
#ifndef FT_KT
#define FT_KT 32  // k a slot: 16 (64-byte K-major rows) or 32 (128-byte)
#endif
#ifndef FT_STAGES
#define FT_STAGES 3
#endif
#ifndef FT_UNROLL
#define FT_UNROLL 2  // 4-k chunks of a k tile in one pass of the loop body
#endif
#ifndef FT_ROWS
#define FT_ROWS 0  // rows a thread of the projection and dx: 0 by the waves (ft_rows)
#endif
#define FT_THREADS 128  // 16 thread rows x 8 thread columns, four warps
#define FT_BM 128
static_assert(FT_KT == 16 || FT_KT == 32, "a K-major row is one swizzle span");
static_assert(SLICE_K % FT_KT == 0, "k tiles end at slice ends");

// One operand of a job: its tensor map (0 or 1 of the launch's two for this
// side), read at (k + koff, i + ioff, z) K-major or (i + ioff, k + koff, z)
// MN-major, z = z0 in segment 0 and z1 in segment 1.
struct FtOp {
  int map, ioff, koff, z0, z1;
};

struct FtJob {
  FtOp a, b;
  int M, N;
  int a_plain;  // A is X by the CTA's own copies (p.x, rows of p.ldx floats)
  float* c;
  long long ldc;
  const float* bias0;  // c[m][n] += bias0[n] + (n < nfold ? bias1[n] : 0)
  const float* bias1;
  int nfold;
  float* colsum;  // column sums of B (segment 0, unrounded), or null
};

struct FtParams {
  FtJob job[4];
  int K, nseg;              // k a segment, segments
  int S, Ks;                // S slices of Ks rows (a multiple of SLICE_K)
  long long slice_stride;   // floats between two slices' outputs
  const float* x;           // a_plain: X, element (i, k) at x[i ldx + k]
  int ldx;                  // (K-major) or x[k ldx + i] (MN-major)
};

// the 16-byte chunk that chunk c of K-major row r lands in: c ^ ft_swz(r)
__host__ __device__ constexpr int ft_swz(int r) { return FT_KT == 16 ? (r >> 1) & 3 : r & 7; }

template <int RM, int TN>
struct FtShape {
  static constexpr int BM = 16 * RM, BN = 8 * TN;
  static constexpr uint32_t A_BYTES = BM * FT_KT * 4, B_BYTES = BN * FT_KT * 4;
  // each image 1024-byte aligned (the swizzle's span)
  static constexpr uint32_t A_IMG = (A_BYTES + 1023) / 1024 * 1024;
  static constexpr uint32_t B_IMG = (B_BYTES + 1023) / 1024 * 1024;
  static constexpr uint32_t STAGE = A_IMG + B_IMG;
  static constexpr size_t SMEM = (size_t)FT_STAGES * STAGE + 8 * FT_STAGES + 4 * FT_STAGES;
};

// One k tile's FMAs: acc[i][j] += A(row i, k) B(k, column j) for k = 0 ..
// 4 nc - 1 ascending, one fmaf each, from the images as and bs: its first nc
// 4-k chunks, those that hold data (the k past them, TMA's zeros, would add
// nothing). NC: nc where it is known (a whole slot, FT_KT / 4), else 0.
template <bool AK, bool BK, int RM, int TN, int NC>
__device__ __forceinline__ void ft_tile(const float* as, const float* bs, int tx, int ty,
                                        float (&acc)[RM][TN], int nc_) {
  constexpr int KT = FT_KT, BN = 8 * TN, UC = FT_UNROLL;
  const int nc = NC ? NC : nc_;
  if constexpr (AK) {
    const int asw = ft_swz(ty);
    const float* ar = as + ty * KT;  // row ty; row ty + 16 i is 16 i KT floats on
#pragma unroll (UC)
    for (int c = 0; c < nc; ++c) {
      float a[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(ar + 16 * KT * i + ((c ^ asw) << 2));
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      }
      if constexpr (BK) {  // dx: columns tx + 8 j, K-major
        const int bsw = ft_swz(tx);
        float b[TN][4];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float4 v =
              *reinterpret_cast<const float4*>(bs + (tx + 8 * j) * KT + ((c ^ bsw) << 2));
          b[j][0] = v.x;
          b[j][1] = v.y;
          b[j][2] = v.z;
          b[j][3] = v.w;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i][kk], b[j][kk], acc[i][j]);
      } else {  // the projection: columns 32 (j / 4) + 4 tx + j % 4, MN-major
        static_assert(TN == 16, "the projection's 128 columns");
        // b of k + 1 loads while k's FMAs run
        float bb[2][16];
        auto load_b = [&](int k, float (&b)[16]) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(bs + k * BN + q * 32 + tx * 4);
            b[4 * q] = v.x;
            b[4 * q + 1] = v.y;
            b[4 * q + 2] = v.z;
            b[4 * q + 3] = v.w;
          }
        };
        load_b(4 * c, bb[0]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < 3) load_b(4 * c + kk + 1, bb[(kk + 1) & 1]);
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(a[i][kk], bb[kk & 1][j], acc[i][j]);
        }
      }
    }
  } else {
    static_assert(!BK && TN == 16 && RM == 8, "the weight gradients' 128 x 128");
    // k + 1's operands load while k's FMAs run
    float bb[2][16], aa[2][8];
    auto load = [&](int k, float (&a)[8], float (&b)[16]) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(bs + k * BN + q * 32 + tx * 4);
        b[4 * q] = v.x;
        b[4 * q + 1] = v.y;
        b[4 * q + 2] = v.z;
        b[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(as + k * FT_BM + 64 * h + ty * 4);
        a[4 * h] = v.x;
        a[4 * h + 1] = v.y;
        a[4 * h + 2] = v.z;
        a[4 * h + 3] = v.w;
      }
    };
    load(0, aa[0], bb[0]);
#pragma unroll (UC)
    for (int c = 0; c < nc; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = 4 * c + kk;
        if (k + 1 < 4 * nc) load(k + 1, aa[(kk + 1) & 1], bb[(kk + 1) & 1]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 16; ++j)
            acc[i][j] = fmaf(aa[kk & 1][i], bb[kk & 1][j], acc[i][j]);
      }
    }
  }
}

// mbar_wait at the CTA's scope (the kernel runs no cluster): the phase of
// parity `parity` of the barrier at `bar` completed; traps on a wait that
// never ends
__device__ __forceinline__ void ft_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1u << 24)) __trap();
  }
}

// the descriptor of the tensor map at `map` (a kernel parameter) into the
// TMA unit's cache, ahead of the first box that reads it
__device__ __forceinline__ void prefetch_tmap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Row i of thread row ty in its CTA's tile: ty + 16 i (i < RM) where A is
// K-major, else 4 ty + i and 64 + 4 ty + i - 4 (i < 8).
template <bool AK>
__device__ __forceinline__ int ft_row(int ty, int i) {
  if (AK) return ty + 16 * i;
  return i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
}

// Rows [k0, k0 + kw) by [i0, i0 + BM) of X (element (i, k) at x[i ld + k]
// K-major, x[k ld + i] MN-major; zeros for i >= M or k >= ke) into the
// image TMA would write, by the CTA's own 4-byte asynchronous copies (the
// zeros by copies of no bytes), all in flight at once; kw: the k that
// ft_tile reads, a multiple of 4. The caller's barrier follows.
template <bool AK, int BM>
__device__ __forceinline__ void ft_plain_a(float* img, const float* x, int ld, int i0, int M,
                                           int k0, int ke, int kw, int tid) {
  const uint32_t base = smem_u32(img);
  const int n = BM * kw;
  for (int e = tid; e < n; e += FT_THREADS) {
    const int ii = AK ? e / kw : e % BM, kk = AK ? e % kw : e / BM;
    const int i = i0 + ii, k = k0 + kk;
    const bool ok = i < M && k < ke;
    const int slot = AK ? ii * FT_KT + (((kk >> 2) ^ ft_swz(ii)) << 2) + (kk & 3) : kk * BM + ii;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(base + 4 * slot),
                 "l"(ok ? x + (AK ? (size_t)i * ld + k : (size_t)k * ld + i) : x), "r"(ok ? 4 : 0)
                 : "memory");
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// c (+ the slice's offset) = sum over the job's segments of A_seg B_seg (+
// bias); A through maps ta0 / ta1, B through tb0 / tb1. Grid: (N tiles, M
// tiles, jobs x S). PART: a k tile may hold fewer than FT_KT k (the
// projection at C % FT_KT != 0), and only its chunks that hold data run.
template <bool AK, bool BK, int RM, int TN, bool AP, bool PART>
__global__ void __launch_bounds__(FT_THREADS, 2)
    f32_tma_kernel(const __grid_constant__ CUtensorMap ta0, const __grid_constant__ CUtensorMap ta1,
                   const __grid_constant__ CUtensorMap tb0, const __grid_constant__ CUtensorMap tb1,
                   const FtParams p) {
  using SH = FtShape<RM, TN>;
  constexpr int BM = SH::BM, BN = SH::BN, KT = FT_KT, ST = FT_STAGES;
  // the weight gradients sum B's columns
  constexpr bool CS = !AK && !BK;
  static_assert(AK || BM == FT_BM, "an MN-major A image is 128 wide");
  static_assert(BK || BN == FT_BM, "an MN-major B image is 128 wide");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t full = base + ST * SH::STAGE;  // a slot's boxes landed
  int* done = reinterpret_cast<int*>(smem_raw + ST * SH::STAGE + 8 * ST);  // warps done, all uses
  const int ji = blockIdx.z / p.S, slice = blockIdx.z % p.S;
  const FtJob& jb = p.job[ji];
  const int M = jb.M, N = jb.N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= M || n0 >= N) return;  // block-uniform, before any barrier
  const bool plain = AP && jb.a_plain;
  if (threadIdx.x == 0) {  // the maps' descriptors ahead of the first boxes
    if (!plain) prefetch_tmap(jb.a.map ? &ta1 : &ta0);
    prefetch_tmap(jb.b.map ? &tb1 : &tb0);
  }
  if ((base & 1023) != 0) __trap();  // the swizzled images need 1024-byte alignment
  const int kb = slice * p.Ks, ke = min(p.K, kb + p.Ks);
  const int KTS = ke > kb ? (ke - kb + KT - 1) / KT : 0;  // k tiles a segment
  const int NT = KTS * p.nseg;
  const int tid = threadIdx.x, lane = tid & 31, tx = tid % 8, ty = tid / 8;
  // this warp's first row (4 w or 16 w) lies inside the matrix
  const bool live = m0 + ft_row<AK>(tid / 32 * 4, 0) < M;
  const bool do_cs = CS && jb.colsum != nullptr && blockIdx.y == 0;

  // k tile q of the CTA's walk (segment q / KTS) into slot q % ST
  auto load = [&](int q) {
    const int s = q % ST, seg = q / KTS, k0 = kb + (q % KTS) * KT;
    const uint32_t a = base + s * SH::STAGE, b = a + SH::A_IMG, bar = full + 8 * s;
    mbar_expect_tx(bar, (plain ? 0u : SH::A_BYTES) + SH::B_BYTES);
    if (!plain) {
      const FtOp& o = jb.a;
      const int z = seg ? o.z1 : o.z0;
      const CUtensorMap* mp = o.map ? &ta1 : &ta0;
      if (AK)
        tma_load_3d(a, mp, bar, k0 + o.koff, m0 + o.ioff, z);
      else
        tma_load_3d(a, mp, bar, m0 + o.ioff, k0 + o.koff, z);
    }
    const FtOp& o = jb.b;
    const int z = seg ? o.z1 : o.z0;
    const CUtensorMap* mp = o.map ? &tb1 : &tb0;
    if (BK)
      tma_load_3d(b, mp, bar, k0 + o.koff, n0 + o.ioff, z);
    else
      tma_load_3d(b, mp, bar, n0 + o.ioff, k0 + o.koff, z);
  };
  // thread 0: the barriers, then the first FT_STAGES k tiles, in flight
  // while the CTA meets at its one barrier
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);  // one arrival: the loader's, with the boxes' bytes
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int q = 0; q < ST && q < NT; ++q) load(q);
  }
  __syncthreads();

  float acc[RM][TN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  float cs[CS ? 8 : 1];  // column tid's partials by row residue (do_cs)
#pragma unroll
  for (int r = 0; r < (CS ? 8 : 1); ++r) cs[r] = 0.0f;

  for (int q = 0; q < NT; ++q) {
    const int s = q % ST, k0 = kb + (q % KTS) * KT;
    const int nc = PART ? min(KT / 4, (ke - k0 + 3) / 4) : KT / 4;  // 4-k chunks holding data
    float* as = reinterpret_cast<float*>(smem_raw + s * SH::STAGE);
    const float* bs = reinterpret_cast<const float*>(smem_raw + s * SH::STAGE + SH::A_IMG);
    if (plain) {  // the slot's A image by the CTA's copies (its last reader
                  // passed tile q - 1's barrier)
      ft_plain_a<AK, BM>(as, p.x, p.ldx, m0, M, k0, ke, 4 * nc, tid);
      __syncthreads();
    }
    ft_wait(full + 8 * s, (q / ST) & 1);
    if constexpr (CS) {
      if (do_cs) {  // rows kb + KT q + kk, residue kk % 8
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) cs[kk % 8] += bs[kk * BN + tid];
      }
    }
    if (live) ft_tile<AK, BK, RM, TN, PART ? 0 : KT / 4>(as, bs, tx, ty, acc, nc);
    // the warp is done with the slot: the last of the four warps (the
    // count's use q / ST complete) loads k tile q + ST into it
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(done + s, 1) == (q / ST + 1) * 4 - 1 && q + ST < NT) {
        __threadfence_block();
        load(q + ST);
      }
    }
  }

  const size_t so = (size_t)slice * p.slice_stride;
  float* const c = jb.c + so;
  auto bias_of = [&](int n) {
    if (jb.bias0 == nullptr) return 0.0f;
    return jb.bias0[n] + (n < jb.nfold ? jb.bias1[n] : 0.0f);
  };
  if (live) {
    if constexpr (BK) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx + 8 * j;
        if (n >= N) continue;
        const float bias = bias_of(n);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int m = m0 + ft_row<AK>(ty, i);
          if (m < M) c[(size_t)m * jb.ldc + n] = acc[i][j] + bias;
        }
      }
    } else {
      const bool vec_c = jb.ldc % 4 == 0 && (uintptr_t)c % 16 == 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + q * 32 + tx * 4;  // this thread's 4 columns
        if (n >= N) continue;
        float bias[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) bias[e] = n + e < N ? bias_of(n + e) : 0.0f;
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int m = m0 + ft_row<AK>(ty, i);
          if (m >= M) continue;
          float* cp = c + (size_t)m * jb.ldc + n;
          const float* v = &acc[i][4 * q];
          if (vec_c && n + 3 < N) {
            *reinterpret_cast<float4*>(cp) =
                make_float4(v[0] + bias[0], v[1] + bias[1], v[2] + bias[2], v[3] + bias[3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (n + e < N) cp[e] = v[e] + bias[e];
          }
        }
      }
    }
  }
  if constexpr (CS) {
    if (do_cs && n0 + tid < N) {
      float sum = 0.0f;
#pragma unroll
      for (int r = 0; r < 8; ++r) sum += cs[r];
      jb.colsum[so + n0 + tid] = sum;
    }
  }
}

// ---------------------------------------------------------------- wgmma

#define WG_BM 128       // rows of a tile: two consumer warpgroups of 64
#define WG_BK 64        // k a stage: 64 bf16, one 128-byte swizzled row
#define WG_STAGES 3
#define WG_THREADS 288  // two consumer warpgroups and one producer warp
#define WG_BOX 8192     // bytes of one box of 64 rows of 128 bytes

// One output of wgemm_kernel: rows [0, M) of c (row stride ldc, plus the
// slice's offset). dW: A through map a_map (0 or 1) at (a_col + m, a_row +
// k), or, a_map == 2, X's rows by plain loads (stage_rows_mn); B through map
// b_map at (n, k, b_dir); dx: A at (k, m, d), B at (k, n, d) for both
// directions d in turn.
struct WgJob {
  float* c;
  int M, a_map, a_col, a_row, b_map, b_dir;
};

struct WgParams {
  WgJob job[4];
  int N;      // output columns
  int K;      // dW: the L N rows; dx: G, one direction's k
  int S, Ks;  // dW: S row slices of Ks rows (a multiple of WG_BK); dx: 1, G
  long long ldc, slice_stride;
  const __nv_bfloat16* x;  // a_map == 2: X (K rows of M = C bf16, C % 8 != 0)
};

// Rows [k0, k0 + 64) of X (K rows of ld bf16, any ld) at columns [m0, m0 +
// 128), written by the 32 lanes of a warp as the two MN-major boxes TMA
// would write (row r of a box at 128 r bytes, the 128-byte swizzle; zero
// outside X): for X whose rows are no multiple of 16 bytes, which TMA
// cannot address. The caller fences them for the async proxy.
__device__ __forceinline__ void stage_rows_mn(uint32_t a, const __nv_bfloat16* x, int ld,
                                              int K, int k0, int m0, int lane) {
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  for (int r = lane; r < WG_BK; r += 32) {
    const int k = k0 + r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        const int m = m0 + 64 * h + 8 * c8;
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (k < K && m < ld) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (m + e < ld) w[e >> 1] |= (uint32_t)__ldg(xs + (size_t)k * ld + m + e) << (16 * (e & 1));
        }
        st_shared_v4(a + h * WG_BOX + r * 128 + ((c8 ^ (r & 7)) << 4),
                     make_uint4(w[0], w[1], w[2], w[3]));
      }
    }
  }
}

// One CTA: rows [m0, m0 + 128) by columns [n0, n0 + BN) of one job (and, for
// dW, one row slice). Stage s of the ring holds A's tile (128 rows of 64 k:
// dx one K-major box, dW two MN-major boxes of 64 m, one a warpgroup) and
// B's (dx: BN rows of 64 k, K-major; dW: two MN-major boxes of 64 n);
// `full[s]` completes when TMA has written them, `empty[s]` when both
// consumer warpgroups have read them.
template <bool MN, int BN>
__global__ void __launch_bounds__(WG_THREADS, 2)
    wgemm_kernel(const __grid_constant__ CUtensorMap ta0, const __grid_constant__ CUtensorMap ta1,
                 const __grid_constant__ CUtensorMap tb0, const __grid_constant__ CUtensorMap tb1,
                 const WgParams p) {
  constexpr uint32_t A_BYTES = WG_BM * WG_BK * 2, B_BYTES = BN * WG_BK * 2;
  constexpr uint32_t STAGE = A_BYTES + B_BYTES;
  static_assert(!MN || BN == 128, "dW tiles are two 64-column boxes of B");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t full = base + WG_STAGES * STAGE, empty = full + 8 * WG_STAGES;
  const int ji = blockIdx.z / p.S, slice = blockIdx.z % p.S;
  const WgJob& jb = p.job[ji];
  const int m0 = blockIdx.y * WG_BM, n0 = blockIdx.x * BN;
  if (m0 >= jb.M) return;  // block-uniform, before any barrier
  // dW: this slice's rows; dx: each direction's G in turn
  const int kb = MN ? slice * p.Ks : 0, ke = MN ? min(p.K, kb + p.Ks) : p.K;
  const int kt_seg = ke > kb ? (ke - kb + WG_BK - 1) / WG_BK : 0;
  const int ntiles = MN ? kt_seg : 2 * kt_seg;
  const int tid = threadIdx.x, wg = tid >> 7;
  if ((base & 1023) != 0) __trap();  // the swizzled tiles need 1024-byte alignment
  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg == 2) {  // the producer warp: one thread keeps the ring full (the
                  // whole warp where it stages X's rows itself)
    const int lane = tid & 31;
    const bool plain_a = MN && jb.a_map == 2;
    if (plain_a || lane == 0) {
      const CUtensorMap* am = jb.a_map == 1 ? &ta1 : &ta0;
      const CUtensorMap* bm = jb.b_map ? &tb1 : &tb0;
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % WG_STAGES;
        if (it >= WG_STAGES) mbar_wait(empty + 8 * s, ((it / WG_STAGES) - 1) & 1);
        const uint32_t a = base + s * STAGE, b = a + A_BYTES, bar = full + 8 * s;
        if constexpr (MN) {
          const int k0 = kb + it * WG_BK;
          if (plain_a) {
            // every lane's stores, then visible to wgmma (the async proxy)
            // before lane 0's arrival completes the stage with B's bytes
            stage_rows_mn(a, p.x, jb.M, p.K, k0, m0, lane);
            fence_async_shared();
            __syncwarp();
            if (lane != 0) continue;
            mbar_expect_tx(bar, B_BYTES);
          } else {
            mbar_expect_tx(bar, STAGE);
            tma_load_2d(a, am, bar, jb.a_col + m0, jb.a_row + k0);
            tma_load_2d(a + WG_BOX, am, bar, jb.a_col + m0 + 64, jb.a_row + k0);
          }
          tma_load_3d(b, bm, bar, n0, k0, jb.b_dir);
          tma_load_3d(b + WG_BOX, bm, bar, n0 + 64, k0, jb.b_dir);
        } else {
          mbar_expect_tx(bar, STAGE);
          const int d = it / kt_seg, k0 = (it % kt_seg) * WG_BK;
          tma_load_3d(a, am, bar, k0, m0, d);
          tma_load_3d(b, bm, bar, k0, n0, d);
        }
      }
    }
    return;
  }
  const int lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, t4 = lane & 3;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % WG_STAGES;
    mbar_wait(full + 8 * s, (it / WG_STAGES) & 1);
    __syncwarp();
    // this warpgroup's 64 rows of A: the second 8 KB box (dW) or rows
    // 64 .. 127 of the K-major box (dx), 8 KB in either case
    const uint32_t a = base + s * STAGE + wg * WG_BOX, b = base + s * STAGE + A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      if constexpr (MN)
        Wgmma<BN>::template mma<1, 1>(acc, mnmajor_desc(a + 2048 * kk, WG_BOX, 1024),
                                      mnmajor_desc(b + 2048 * kk, WG_BOX, 1024), (it | kk) != 0);
      else
        Wgmma<BN>::template mma<0, 0>(acc, kmajor_desc(a + 32 * kk, 128),
                                      kmajor_desc(b + 32 * kk, 128), (it | kk) != 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous k tile's products are done: free its stage
    fence_regs(acc);
    if (it > 0 && (tid & 127) == 0) mbar_arrive(empty + 8 * ((it - 1) % WG_STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);
  float* c = jb.c + (size_t)slice * p.slice_stride;
  const bool vec = p.ldc % 2 == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * t4;  // this thread's 2 columns
    if (n >= p.N) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + wg * 64 + warp * 16 + g + 8 * hh;
      if (m >= jb.M) continue;
      float* cp = c + (size_t)m * p.ldc + n;
      const float v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
      if (vec && n + 1 < p.N) {
        *reinterpret_cast<float2*>(cp) = make_float2(v0, v1);
      } else {
        cp[0] = v0;
        if (n + 1 < p.N) cp[1] = v1;
      }
    }
  }
}

// out[i] = sum over the S slice partials part[s T + i], in slice order (i <
// T; nothing when S == 1); then bout[j] = sum over the NT tile partials
// bpart[t Tb + j], in tile order (j < Tb: the tc design's bias gradients,
// none in simt)
__global__ void __launch_bounds__(GM_THREADS)
    gemm_sum_slices(const float* part, float* out, long long T, int S, const float* bpart,
                    float* bout, long long Tb, int NT) {
  const long long nw = S > 1 ? T : 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nw + Tb;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    if (i < nw) {
      for (int sl = 0; sl < S; ++sl) s += part[(size_t)sl * T + i];
      out[i] = s;
    } else {
      const long long j = i - nw;
      for (int t = 0; t < NT; ++t) s += bpart[(size_t)t * Tb + j];
      bout[j] = s;
    }
  }
}

// One launch of gemm_simt_kernel over the jobs of p, operand type TR.
// Grid: (N tiles, M tiles, jobs x S).
template <typename TA, bool A_KC, typename TB, bool B_KC, typename TR>
static int gemm_run(const GemmParams& p, int njobs, int Mmax, int Nmax, cudaStream_t s) {
  const dim3 grid((Nmax + GM_BN - 1) / GM_BN, (Mmax + GM_BM - 1) / GM_BM, njobs * p.S);
  gemm_simt_kernel<TA, A_KC, TB, B_KC, TR><<<grid, GM_THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// One launch of wgemm_kernel<MN, BN> over maps (A0, A1, B0, B1).
template <bool MN, int BN>
static int wgemm_run(const CUtensorMap (&maps)[4], const WgParams& p, dim3 grid,
                     cudaStream_t s) {
  const size_t smem = (size_t)WG_STAGES * (WG_BM + BN) * WG_BK * 2 + 16 * WG_STAGES;
  const cudaError_t e = cudaFuncSetAttribute(
      wgemm_kernel<MN, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  wgemm_kernel<MN, BN><<<grid, WG_THREADS, smem, s>>>(maps[0], maps[1], maps[2], maps[3], p);
  return (int)cudaGetLastError();
}

static int map_error(CUresult r) {
  return r == CUDA_ERROR_NOT_SUPPORTED ? (int)cudaErrorNotSupported : (int)cudaErrorInvalidValue;
}

// a GemmOp over p with the given stride, row offset and k range; vec when a
// 4-element vector load is aligned everywhere
template <typename TV>
static GemmOp gemm_op(const void* p, long long ld, long long koff, int klo, int khi) {
  GemmOp o;
  o.p = p;
  o.ld = ld;
  o.koff = koff;
  o.klo = klo;
  o.khi = khi;
  o.vec = (ld % 4 == 0) && (koff % 4 == 0) &&
          ((uintptr_t)p % (4 * sizeof(TV)) == 0);
  return o;
}

// Rows of a weight-gradient slice: L N / S rounded up to a multiple of kt
static int slice_rows(int LN, int S, int kt) {
  return (int)((((long long)LN + S - 1) / S + kt - 1) / kt * kt);
}

// The TMA map of a contiguous f32 tensor (d2, d1, d0), innermost first,
// boxes of (b0, b1, 1) elements: a K-major box (rows of FT_KT floats) under
// the swizzle of its row's span, an MN-major one dense; a box's elements
// outside the tensor (negative coordinates too) arrive as zeros.
// CUDA_ERROR_NOT_SUPPORTED when libcuda's encoder is missing.
static CUresult ft_map(CUtensorMap* map, const void* p, cuuint64_t d0, cuuint64_t d1,
                       cuuint64_t d2, cuuint32_t b0, cuuint32_t b1, bool kmajor) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_SUPPORTED;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 4, d0 * d1 * 4};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = !kmajor       ? CU_TENSOR_MAP_SWIZZLE_NONE
                                : FT_KT == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_128B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(p), dims, strides, box,
                ones, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// an operand TMA can address: rows of a multiple of 4 floats, 16-byte aligned
static bool ft_tma_ok(const void* p, long long row) {
  return row % 4 == 0 && (uintptr_t)p % 16 == 0;
}

// dx's column tile in f32_tma_kernel: the least of 16, 32, 64 and 128
// columns that holds C (128 above).
static int dx_cols(int C) { return C <= 16 ? 16 : C <= 32 ? 32 : C <= 64 ? 64 : 128; }

// Rows a thread of a K-major-A launch of f32_tma_kernel (the projection,
// dx), 8 or 7 (tiles of 128 or 112 rows), for M rows by col_tiles column
// tiles (the directions' included): the one whose tiles take the fewest
// wave-times, a wave-time being a tile's rows and a wave two CTAs on each
// SM (8 on a tie; FT_ROWS, where set, forces one). At 1,024 rows: dx (C =
// 512, 4 column tiles) 672 tiles of 128 rows are 2.55 waves, 3 x 8 = 24,
// 768 of 112 are 2.91, 3 x 7 = 21; the LSTM's projection (16 column
// tiles) 2,688 of 128 are 10.2 waves, 11 x 8 = 88, 3,072 of 112 are 11.6,
// 12 x 7 = 84.
static int ft_rows(long long M, long long col_tiles) {
  if (FT_ROWS != 0) return FT_ROWS;
  static std::atomic<int> sm_count[64];  // each device's SMs, once read
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess && dev < 64) {
    sms = sm_count[dev].load();
    if (sms == 0 && cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
                        cudaSuccess)
      sm_count[dev].store(sms);
    if (sms <= 0) sms = 132;
  }
  const long long slots = 2LL * sms;
  auto cost = [&](int rm) {
    const long long tiles = col_tiles * ((M + 16 * rm - 1) / (16 * rm));
    return (tiles + slots - 1) / slots * rm;
  };
  return cost(7) < cost(8) ? 7 : 8;
}

// One launch of f32_tma_kernel<AK, BK, RM, TN, AP, PART> over maps (A0, A1,
// B0, B1).
template <bool AK, bool BK, int RM, int TN, bool AP, bool PART = false>
static int ft_launch(const CUtensorMap (&maps)[4], const FtParams& p, dim3 grid,
                     cudaStream_t s) {
  const size_t smem = FtShape<RM, TN>::SMEM;
  // the shared-memory limit, set once a device (bit d: set on device d): at
  // the aggregate trainer's shapes the host's time is the call's
  static std::atomic<unsigned long long> smem_set{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0ULL;
  if ((smem_set.load() & bit) == 0) {
    e = cudaFuncSetAttribute(f32_tma_kernel<AK, BK, RM, TN, AP, PART>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set.fetch_or(bit);
  }
  f32_tma_kernel<AK, BK, RM, TN, AP, PART>
      <<<grid, FT_THREADS, smem, s>>>(maps[0], maps[1], maps[2], maps[3], p);
  return (int)cudaGetLastError();
}

// The projection's instantiation: X by TMA or by the CTA's copies (whose C %
// 4 != 0 leaves a partial k tile), whole k tiles or a partial last one.
template <int RM>
static int proj_launch(const CUtensorMap (&maps)[4], const FtParams& p, dim3 grid,
                       cudaStream_t s, bool x_tma, bool part) {
  if (!x_tma) return ft_launch<true, false, RM, 16, true, true>(maps, p, grid, s);
  return part ? ft_launch<true, false, RM, 16, false, true>(maps, p, grid, s)
              : ft_launch<true, false, RM, 16, false, false>(maps, p, grid, s);
}

// The input projection on f32 operands, both directions in one launch: A =
// X (M, C) K-major through TMA, or by the CTA's own copies where its rows
// are no 16-byte multiple (C = 11, 21); B = W_ih[d] (C, G) MN-major; RM
// rows a thread by the waves (ft_rows).
static int proj_f32_run(const float* x, const float* wih, const float* bih, const float* bhh,
                        float* xg, int M, int C, int G, int nfold, cudaStream_t s) {
  if (!ft_tma_ok(wih, G)) return (int)cudaErrorInvalidValue;
  const bool x_tma = ft_tma_ok(x, C);
  const int RM = ft_rows(M, 2LL * ((G + FT_BM - 1) / FT_BM));
  CUtensorMap maps[4];
  CUresult r = ft_map(&maps[2], wih, G, C, 2, FT_BM, FT_KT, false);
  if (r == CUDA_SUCCESS && x_tma) r = ft_map(&maps[0], x, C, M, 1, FT_KT, 16 * RM, true);
  if (r != CUDA_SUCCESS) return map_error(r);
  if (!x_tma) maps[0] = maps[2];  // unread: X comes by the CTA's copies
  maps[1] = maps[0];
  maps[3] = maps[2];
  FtParams p = {};
  for (int d = 0; d < 2; ++d)
    p.job[d] = FtJob{{0, 0, 0, 0, 0}, {0, 0, 0, d, d}, M, G, !x_tma, xg + (size_t)d * M * G, G,
                     bih + d * G, bhh + d * G, nfold, nullptr};
  p.K = C;
  p.nseg = 1;
  p.S = 1;
  p.Ks = C;
  p.slice_stride = 0;
  p.x = x;
  p.ldx = C;
  const dim3 grid((G + FT_BM - 1) / FT_BM, (M + 16 * RM - 1) / (16 * RM), 2);
  return RM == 7 ? proj_launch<7>(maps, p, grid, s, x_tma, C % FT_KT != 0)
                 : proj_launch<8>(maps, p, grid, s, x_tma, C % FT_KT != 0);
}

// The input projection of both directions: xg[d] (M, G) f32 = x (M, C)
// W_ih[d] (C, G) + b_ih[d] + the first nfold columns of b_hh[d] (the GRU
// keeps b_hn, its last H, inside the reset product; the LSTM folds all G).
template <typename T>
static int rnn_proj(const void* x, const void* wih, const float* bih, const float* bhh,
                    float* xg, int M, int C, int G, int nfold, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value)
    return proj_f32_run(static_cast<const float*>(x), static_cast<const float*>(wih), bih, bhh,
                        xg, M, C, G, nfold, s);
  else {
    GemmParams gp = {};
    for (int d = 0; d < 2; ++d) {
      GemmJob& jb = gp.job[d];
      jb.a[0] = gemm_op<T>(x, C, 0, 0, C);
      jb.b[0] = gemm_op<T>(static_cast<const T*>(wih) + (size_t)d * C * G, G, 0, 0, C);
      jb.nseg = 1;
      jb.M = M;
      jb.N = G;
      jb.c = xg + (size_t)d * M * G;
      jb.ldc = G;
      jb.bias0 = bih + d * G;
      jb.bias1 = bhh + d * G;
      jb.nfold = nfold;
      jb.colsum = nullptr;
    }
    gp.K = C;
    gp.S = 1;
    gp.Ks = C;
    gp.slice_stride = 0;
    return gemm_run<T, true, T, false, T>(gp, 2, M, G, s);
  }
}

// dx on f32 operands: A = dxg[d] (M, G) and B = W_ih[d] (C, G), both K-major
// through TMA, direction d segment d of one chain; BN columns by C
// (dx_cols), RM rows a thread by the waves (ft_rows).
static int dx_f32_run(const float* dxg, const float* wih, float* dx, int M, int C, int G,
                      cudaStream_t s) {
  if (!ft_tma_ok(dxg, G) || !ft_tma_ok(wih, G)) return (int)cudaErrorInvalidValue;
  const int BN = dx_cols(C), RM = ft_rows(M, (C + BN - 1) / BN);
  CUtensorMap maps[4];
  CUresult r = ft_map(&maps[0], dxg, G, M, 2, FT_KT, 16 * RM, true);
  if (r == CUDA_SUCCESS) r = ft_map(&maps[2], wih, G, C, 2, FT_KT, BN, true);
  if (r != CUDA_SUCCESS) return map_error(r);
  maps[1] = maps[0];
  maps[3] = maps[2];
  FtParams p = {};
  p.job[0] = FtJob{{0, 0, 0, 0, 1}, {0, 0, 0, 0, 1}, M, C, 0, dx, C, nullptr, nullptr, 0,
                   nullptr};
  p.K = G;
  p.nseg = 2;
  p.S = 1;
  p.Ks = G;
  p.slice_stride = 0;
  const dim3 grid((C + BN - 1) / BN, (M + 16 * RM - 1) / (16 * RM), 1);
  if (RM == 8) {
    if (BN == 16) return ft_launch<true, true, 8, 2, false>(maps, p, grid, s);
    if (BN == 32) return ft_launch<true, true, 8, 4, false>(maps, p, grid, s);
    if (BN == 64) return ft_launch<true, true, 8, 8, false>(maps, p, grid, s);
    return ft_launch<true, true, 8, 16, false>(maps, p, grid, s);
  }
  if (BN == 16) return ft_launch<true, true, 7, 2, false>(maps, p, grid, s);
  if (BN == 32) return ft_launch<true, true, 7, 4, false>(maps, p, grid, s);
  if (BN == 64) return ft_launch<true, true, 7, 8, false>(maps, p, grid, s);
  return ft_launch<true, true, 7, 16, false>(maps, p, grid, s);
}

// The input gradient, simt: dx (M, C) f32 = sum_d op(dxg[d]) (M, G)
// W_ih[d]^T, dxg f32, W_ih read in its own (C, G) layout.
template <typename T>
static int rnn_dx(const float* dxg, const void* wih, float* dx, int M, int C, int G,
                  cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value)
    return dx_f32_run(dxg, static_cast<const float*>(wih), dx, M, C, G, s);
  else {
    GemmParams gp = {};
    GemmJob& jb = gp.job[0];
    for (int d = 0; d < 2; ++d) {
      // W_ih[d] (C, G) read as (k, n) -> p[n G + k]: W_ih^T without a copy
      jb.a[d] = gemm_op<float>(dxg + (size_t)d * M * G, G, 0, 0, G);
      jb.b[d] = gemm_op<T>(static_cast<const T*>(wih) + (size_t)d * C * G, G, 0, 0, G);
    }
    jb.nseg = 2;
    jb.M = M;
    jb.N = C;
    jb.c = dx;
    jb.ldc = C;
    jb.bias0 = jb.bias1 = nullptr;
    jb.nfold = 0;
    jb.colsum = nullptr;
    gp.K = G;
    gp.S = 1;
    gp.Ks = G;
    gp.slice_stride = 0;
    return gemm_run<float, true, T, true, T>(gp, 1, M, C, s);
  }
}

// The weight and bias gradients on f32 operands, one launch of four jobs
// (dW_ih[d], dW_hh[d]) by S row slices, all MN-major through TMA: A = X
// (rows of C; by the CTA's own copies where C % 4 != 0) or out's h_prev
// columns (d H .., rows k - N (d = 0) or k + N (d = 1): TMA's zeros outside
// out are the first step's), B = dxg[d] or dhg[d]; the column sums of dxg
// and dhg beside them (dhg's none where it is dxg). part as rnn_wgrad's.
static int wgrad_f32_run(const float* x, const float* out, const float* dxg, const float* dhg,
                         float* part, int L, int N, int C, int H, int G, int S, cudaStream_t s) {
  const int LN = L * N;
  const bool one = dhg == dxg;
  const long long o_whh = 2LL * C * G, o_bih = o_whh + 2LL * H * G, o_bhh = o_bih + 2LL * G;
  if (!ft_tma_ok(out, 2 * H) || !ft_tma_ok(dxg, G) || !ft_tma_ok(dhg, G))
    return (int)cudaErrorInvalidValue;
  const bool x_tma = ft_tma_ok(x, C);
  CUtensorMap maps[4];
  CUresult r = ft_map(&maps[1], out, 2 * H, LN, 1, FT_BM, FT_KT, false);
  if (r == CUDA_SUCCESS && x_tma) r = ft_map(&maps[0], x, C, LN, 1, FT_BM, FT_KT, false);
  if (r == CUDA_SUCCESS) r = ft_map(&maps[2], dxg, G, LN, 2, FT_BM, FT_KT, false);
  if (r == CUDA_SUCCESS) r = ft_map(&maps[3], dhg, G, LN, 2, FT_BM, FT_KT, false);
  if (r != CUDA_SUCCESS) return map_error(r);
  if (!x_tma) maps[0] = maps[1];  // unread: X comes by the CTA's copies
  FtParams p = {};
  for (int d = 0; d < 2; ++d) {
    p.job[d] = FtJob{{0, 0, 0, 0, 0}, {0, 0, 0, d, d}, C, G, !x_tma,
                     part + (size_t)d * C * G, G, nullptr, nullptr, 0, part + o_bih + d * G};
    p.job[2 + d] = FtJob{{1, d * H, d == 0 ? -N : N, 0, 0}, {1, 0, 0, d, d}, H, G, 0,
                         part + o_whh + (size_t)d * H * G, G, nullptr, nullptr, 0,
                         one ? nullptr : part + o_bhh + d * G};
  }
  p.K = LN;
  p.nseg = 1;
  p.S = S;
  p.Ks = slice_rows(LN, S, SLICE_K);
  p.slice_stride = one ? o_bhh : o_bhh + 2LL * G;
  p.x = x;
  p.ldx = C;
  const dim3 grid((G + FT_BM - 1) / FT_BM, ((C > H ? C : H) + FT_BM - 1) / FT_BM, 4 * S);
  return x_tma ? ft_launch<false, false, 8, 16, false>(maps, p, grid, s)
               : ft_launch<false, false, 8, 16, true>(maps, p, grid, s);
}

// The weight and bias gradients, simt, over the L N rows in S fixed row
// slices, into part (S slices of [dW_ih (2, C, G) | dW_hh (2, H, G) | db_ih
// (2, G) | db_hh (2, G)] f32): dW_ih[d] = X^T op(dxg[d]), dW_hh[d] = H_prev^T
// op(dhg[d]), H_prev the layer output one step back in the direction's own
// time, and the column sums of dxg and dhg. dhg == dxg (the LSTM's one gate
// gradient da): its column sum is taken once and db_hh is left out.
template <typename T>
static int rnn_wgrad(const void* x, const void* out, const float* dxg, const float* dhg,
                     float* part, int L, int N, int C, int H, int G, int S, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value)
    return wgrad_f32_run(static_cast<const float*>(x), static_cast<const float*>(out), dxg, dhg,
                         part, L, N, C, H, G, S, s);
  else {
    const int LN = L * N;
    const bool one = dhg == dxg;
    const long long o_whh = 2LL * C * G, o_bih = o_whh + 2LL * H * G, o_bhh = o_bih + 2LL * G;
    GemmParams gp = {};
    for (int d = 0; d < 2; ++d) {
      GemmJob& ih = gp.job[d];
      ih.a[0] = gemm_op<T>(x, C, 0, 0, LN);  // X^T: (m = c, k = row) at x[k C + m]
      ih.b[0] = gemm_op<float>(dxg + (size_t)d * LN * G, G, 0, 0, LN);
      ih.nseg = 1;
      ih.M = C;
      ih.N = G;
      ih.c = part + (size_t)d * C * G;
      ih.ldc = G;
      ih.bias0 = ih.bias1 = nullptr;
      ih.nfold = 0;
      ih.colsum = part + o_bih + d * G;
      GemmJob& hh = gp.job[2 + d];
      // h_prev of row k = t N + row: out[t - 1] (forward half) or out[t + 1]
      hh.a[0] = gemm_op<T>(static_cast<const T*>(out) + d * H, 2 * H, d == 0 ? -N : N,
                           d == 0 ? N : 0, d == 0 ? LN : LN - N);
      hh.b[0] = gemm_op<float>(dhg + (size_t)d * LN * G, G, 0, 0, LN);
      hh.nseg = 1;
      hh.M = H;
      hh.N = G;
      hh.c = part + o_whh + (size_t)d * H * G;
      hh.ldc = G;
      hh.bias0 = hh.bias1 = nullptr;
      hh.nfold = 0;
      hh.colsum = one ? nullptr : part + o_bhh + d * G;
    }
    gp.K = LN;
    gp.S = S;
    gp.Ks = slice_rows(LN, S, SLICE_K);
    gp.slice_stride = one ? o_bhh : o_bhh + 2LL * G;
    return gemm_run<T, false, float, false, T>(gp, 4, C > H ? C : H, G, s);
  }
}

// The input gradient, tc, on wgmma: dx (M, C) f32 = sum_d dxg[d] (M, G)
// W_ih[d]^T, dxg the bf16 copy (2, M, G) and W_ih (2, C, G) bf16, both read
// K-major as stored; BN the least of 16, 32, 64 and 128 columns that holds C
// (128 above).
static int wg_dx(const void* dxg, const void* wih, float* dx, int M, int C, int G,
                 cudaStream_t s) {
  const int BN = C <= 16 ? 16 : C <= 32 ? 32 : C <= 64 ? 64 : 128;
  CUtensorMap maps[4];
  const cuuint64_t gdims[3] = {(cuuint64_t)G, (cuuint64_t)M, 2};
  const cuuint64_t gstrides[2] = {(cuuint64_t)G * 2, (cuuint64_t)M * G * 2};
  const cuuint32_t gbox[3] = {WG_BK, WG_BM, 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)G, (cuuint64_t)C, 2};
  const cuuint64_t wstrides[2] = {(cuuint64_t)G * 2, (cuuint64_t)C * G * 2};
  const cuuint32_t wbox[3] = {WG_BK, (cuuint32_t)BN, 1};
  CUresult r = bf16_tensor_map(&maps[0], dxg, 3, gdims, gstrides, gbox);
  if (r == CUDA_SUCCESS) r = bf16_tensor_map(&maps[2], wih, 3, wdims, wstrides, wbox);
  if (r != CUDA_SUCCESS) return map_error(r);
  maps[1] = maps[0];
  maps[3] = maps[2];
  WgParams p = {};
  p.job[0] = WgJob{dx, M, 0, 0, 0, 0, 0};
  p.N = C;
  p.K = G;
  p.S = 1;
  p.Ks = G;
  p.ldc = C;
  p.slice_stride = 0;
  const dim3 grid((C + BN - 1) / BN, (M + WG_BM - 1) / WG_BM, 1);
  if (BN == 16) return wgemm_run<false, 16>(maps, p, grid, s);
  if (BN == 32) return wgemm_run<false, 32>(maps, p, grid, s);
  if (BN == 64) return wgemm_run<false, 64>(maps, p, grid, s);
  return wgemm_run<false, 128>(maps, p, grid, s);
}

// The weight gradients, tc, on wgmma, over the L N rows in S fixed row
// slices, into part (S slices of [dW_ih (2, C, G) | dW_hh (2, H, G)] f32):
// dW_ih[d] = X^T dxg[d], X through TMA where its rows are 16-byte multiples
// (C % 8 == 0), else by the producer warp's plain loads (stage_rows_mn);
// dW_hh[d] = H_prev^T dhg[d], H_prev read from out (L N, 2H) at columns d H
// .. and rows k - N (d = 0) or k + N (d = 1), zeros outside. dxg and dhg
// are the bf16 copies (2, L N, G), the same tensor for the LSTM's da.
static int wg_wgrad(const void* x, const void* out, const void* dxg, const void* dhg,
                    float* part, int L, int N, int C, int H, int G, int S, cudaStream_t s) {
  const int LN = L * N;
  const bool x_tma = C % 8 == 0;
  CUtensorMap maps[4];
  const cuuint32_t abox[2] = {64, WG_BK};
  const cuuint64_t odims[2] = {(cuuint64_t)2 * H, (cuuint64_t)LN};
  const cuuint64_t ostrides[1] = {(cuuint64_t)4 * H};
  const cuuint64_t xdims[2] = {(cuuint64_t)C, (cuuint64_t)LN};
  const cuuint64_t xstrides[1] = {(cuuint64_t)C * 2};
  const cuuint64_t gdims[3] = {(cuuint64_t)G, (cuuint64_t)LN, 2};
  const cuuint64_t gstrides[2] = {(cuuint64_t)G * 2, (cuuint64_t)LN * G * 2};
  const cuuint32_t gbox[3] = {64, WG_BK, 1};
  CUresult r = bf16_tensor_map(&maps[1], out, 2, odims, ostrides, abox);
  if (r == CUDA_SUCCESS && x_tma) r = bf16_tensor_map(&maps[0], x, 2, xdims, xstrides, abox);
  if (r == CUDA_SUCCESS) r = bf16_tensor_map(&maps[2], dxg, 3, gdims, gstrides, gbox);
  if (r == CUDA_SUCCESS) r = bf16_tensor_map(&maps[3], dhg, 3, gdims, gstrides, gbox);
  if (r != CUDA_SUCCESS) return map_error(r);
  if (!x_tma) maps[0] = maps[1];  // unread: X comes by plain loads
  WgParams p = {};
  for (int d = 0; d < 2; ++d) {
    p.job[d] = WgJob{part + (size_t)d * C * G, C, x_tma ? 0 : 2, 0, 0, 0, d};
    p.job[2 + d] =
        WgJob{part + 2LL * C * G + (size_t)d * H * G, H, 1, d * H, d == 0 ? -N : N, 1, d};
  }
  p.N = G;
  p.K = LN;
  p.S = S;
  p.Ks = slice_rows(LN, S, WG_BK);
  p.ldc = G;
  p.slice_stride = 2LL * C * G + 2LL * H * G;
  p.x = static_cast<const __nv_bfloat16*>(x);
  const dim3 grid((G + 127) / 128, ((C > H ? C : H) + WG_BM - 1) / WG_BM, 4 * S);
  return wgemm_run<true, 128>(maps, p, grid, s);
}
