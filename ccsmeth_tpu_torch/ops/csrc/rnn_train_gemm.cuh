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
// Four kernels, by design:
//   proj_f32_kernel (the simt design's input projection on f32 operands:
//     K1's, K2's and the K4/K6 fp32 forwards' xg): exact f32 FMAs on the
//     CUDA cores, a CTA of 128 threads a 128 x 128 tile, 8 x 16 outputs a
//     thread, two CTAs an SM, the operands through a 4-deep cp.async ring of
//     k tiles of 16 (X's rows as they are stored, [m][k]; W_ih [k][n]), each
//     thread's next k of W_ih loaded while this one's FMAs run. What bounds
//     it at the models' shapes (L N = 21,504 rows, C = 512, G = 768 or 1024
//     a direction) is the FMA rate: 2 L N C 2 G FLOPs against 67 TFLOP/s,
//     0.50 / 0.67 ms, far above the bytes' time; a thread's k costs it 24
//     operand words for 128 FMAs (the simt kernel's 8 x 8 tile: 16 for 64),
//     inside the rate that shared memory's 32 words a clock an SM feed. At
//     C = 11 the bytes bound it (xg, 132 MB for the GRU: 0.039 ms at 3.35
//     TB/s). Each output is the simt kernel's chain (below) with the bias
//     folded the same way, so xg keeps every bit.
//   gemm_f32_kernel (the simt design's dx and weight and bias gradients
//     on f32 operands: the K5/K6 fp32 backward's products): exact f32 FMAs
//     on the CUDA cores, no TF32. A CTA of 128 threads a 128 x 128 tile
//     (dx: 112 or 128 rows by 16 .. 128 columns), 8 x 16 outputs a thread,
//     two CTAs an SM; the operands in the layouts they are stored in (dx:
//     both K-major; the weight gradients: both MN-major) through a 4-deep
//     cp.async ring of k tiles of 16, each thread's copies set up once a
//     segment; B's column sums (the bias gradients) beside the weight
//     gradients in the first row tile's CTAs, by the residue of the row mod
//     8 as gemm_simt_kernel takes them. What bounds it at the models'
//     shapes (L N = 21,504 rows, C = 512, G = 768 or 1024 a direction) is
//     the FMA rate: dx 2 L N C 2G FLOPs (33.8 / 45.1 GFLOP, 0.50 / 0.67 ms
//     at 67 TFLOP/s), the weight gradients 2 L N 2G (C + H) (50.7 / 67.6
//     GFLOP, 0.76 / 1.01 ms), each far above its bytes' time (dxg, 132 /
//     176 MB, is read from device memory or L2: 0.04 / 0.05 ms at 3.35
//     TB/s); at C = 11 dx is bound by dxg's bytes. Each output is the simt
//     kernel's chain (below), so every bit stays.
//   gemm_simt_kernel (the simt design on bf16 operands, the shapes tc
//     refuses: H = 16; the f32 projection runs proj_f32_kernel and the f32
//     backward gemm_f32_kernel): exact f32 FMAs on the CUDA cores. Block tile 128 x
//     128, k tile 8, 8 x 8 outputs a thread, operand tiles in shared memory
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
// accumulator in wgemm_kernel) that sums its k in a fixed order (in the
// three simt kernels one fmaf chain over k ascending from 0.0f: the zeros
// they pad k with add nothing, so their tile sizes do not move a bit); a
// long
// contraction is cut into S fixed row slices whose partials gemm_sum_slices
// adds in slice order. No atomics, so reruns are bit-equal.

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

// ---------------------------------------------------------------- f32 projection

// proj_f32_kernel: the input projection of both directions in exact f32
// (the simt design's xg, f32 operands), a tile of FP_BM rows by FP_BN
// columns a CTA, FP_THREADS threads of 8 rows x 16 columns each. X's rows
// (k contiguous, [m][k] in shared memory, 4 floats of padding a row) and
// W_ih's (n contiguous, [k][n]) reach shared memory by cp.async, a
// FP_STAGES-deep ring of FP_BK-wide k tiles (16-byte copies; 4-byte ones
// for X's rows where C % 4 != 0), zeros outside the operands. A k of the
// product costs a thread 8 + 16 operand words for 128 FMAs (the simt
// kernel's 8 x 8: 16 for 64): shared memory's 32 words a clock an SM feed
// the 128 FMA lanes with room to spare. A tile of 128 columns (128
// threads, two CTAs an SM, each at most 255 registers) beat one of 256
// (256 threads, one CTA) and 3 or 5-6 stages on the card.
#define FP_BM 128
#define FP_BN 128
#define FP_TX (FP_BN / 16)         // threads along the columns, 16 columns each
#define FP_THREADS (FP_TX * 16)    // and 16 along the rows, 8 rows each
#define FP_MINB (256 / FP_THREADS)  // CTAs an SM
#define FP_BK 16
#define FP_STAGES 4
#define FP_AST (FP_BK + 4)  // X's row stride in shared memory, floats

struct F32ProjParams {
  const float* x;      // (M, K)
  const float* w;      // (2, K, G)
  const float* bias0;  // (2, G): b_ih
  const float* bias1;  // (2, G): b_hh, its first nfold columns folded
  float* xg;           // (2, M, G)
  int M, K, G, nfold;
};

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

static size_t f32_proj_smem() {
  return (size_t)FP_STAGES * (FP_BM * FP_AST + FP_BK * FP_BN) * 4;
}

// Each output element is one thread's fmaf chain over k ascending from 0.0f
// (the zeros past C add nothing), then + (b_ih + b_hh) as gemm_simt_kernel
// folds it: the same bits. XV: 16-byte copies of X's rows (C % 4 == 0, x
// 16-byte aligned), else its elements one by one; WV: 16-byte copies of
// W_ih's rows and 16-byte stores of xg (G % 4 == 0, w and xg 16-byte
// aligned: every simt shape), else one by one.
template <bool XV, bool WV>
__global__ void __launch_bounds__(FP_THREADS, FP_MINB) proj_f32_kernel(const F32ProjParams p) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                                // [STAGES][BM][AST]
  float* Bs = smem + FP_STAGES * FP_BM * FP_AST;   // [STAGES][BK][BN]
  const int d = blockIdx.z;
  const int m0 = blockIdx.y * FP_BM, n0 = blockIdx.x * FP_BN;
  const int M = p.M, K = p.K, G = p.G;
  const float* W = p.w + (size_t)d * K * G;
  const int tid = threadIdx.x, tx = tid % FP_TX, ty = tid / FP_TX;
  const int KT = (K + FP_BK - 1) / FP_BK;
  const uint32_t as0 = smem_u32(As), bs0 = smem_u32(Bs);

  // this thread's pieces of a stage: X's (row, 4 k) chunks and W's (k, 4 n)
  constexpr int ACH = FP_BM * (FP_BK / 4) / FP_THREADS, BCH = FP_BK * (FP_BN / 4) / FP_THREADS;
  static_assert(ACH * FP_THREADS == FP_BM * (FP_BK / 4) && BCH * FP_THREADS == FP_BK * (FP_BN / 4),
                "whole chunks a thread");
  const float* a_src[ACH];
  uint32_t a_dst[ACH];
  int a_k[ACH];
  bool a_row[ACH];
#pragma unroll
  for (int j = 0; j < ACH; ++j) {
    const int c = tid + j * FP_THREADS, r = c / (FP_BK / 4), kq = (c % (FP_BK / 4)) * 4;
    a_row[j] = m0 + r < M;
    a_k[j] = kq;
    a_src[j] = p.x + (size_t)(a_row[j] ? m0 + r : 0) * K + kq;
    a_dst[j] = (r * FP_AST + kq) * 4;
  }
  const float* b_src[BCH];
  uint32_t b_dst[BCH];
  int b_k[BCH];
  bool b_col[BCH];
#pragma unroll
  for (int j = 0; j < BCH; ++j) {
    const int c = tid + j * FP_THREADS, kk = c / (FP_BN / 4), nq = (c % (FP_BN / 4)) * 4;
    b_col[j] = n0 + nq < G;
    b_k[j] = kk;
    b_src[j] = W + (size_t)kk * G + (b_col[j] ? n0 + nq : 0);
    b_dst[j] = (kk * FP_BN + nq) * 4;
  }

  auto load_stage = [&](int slot, int kt) {
    const int k0 = kt * FP_BK;
    const uint32_t as = as0 + slot * FP_BM * FP_AST * 4, bs = bs0 + slot * FP_BK * FP_BN * 4;
    if constexpr (XV) {
#pragma unroll
      for (int j = 0; j < ACH; ++j) {
        const bool ok = a_row[j] && k0 + a_k[j] < K;
        cp_async_16(as + a_dst[j], ok ? a_src[j] + k0 : p.x, ok);
      }
    } else {
      for (int c = tid; c < FP_BM * FP_BK; c += FP_THREADS) {
        const int r = c / FP_BK, kk = c % FP_BK;
        const bool ok = m0 + r < M && k0 + kk < K;
        cp_async_4(as + (r * FP_AST + kk) * 4, ok ? p.x + (size_t)(m0 + r) * K + k0 + kk : p.x,
                   ok);
      }
    }
    if constexpr (WV) {
#pragma unroll
      for (int j = 0; j < BCH; ++j) {
        const bool ok = b_col[j] && k0 + b_k[j] < K;
        cp_async_16(bs + b_dst[j], ok ? b_src[j] + (size_t)k0 * G : W, ok);
      }
    } else {
      for (int c = tid; c < FP_BK * FP_BN; c += FP_THREADS) {
        const int kk = c / FP_BN, nn = c % FP_BN;
        const bool ok = k0 + kk < K && n0 + nn < G;
        cp_async_4(bs + (kk * FP_BN + nn) * 4, ok ? W + (size_t)(k0 + kk) * G + n0 + nn : W, ok);
      }
    }
  };

  float acc[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int st = 0; st < FP_STAGES - 1; ++st) {
    if (st < KT) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<FP_STAGES - 2>();
    __syncthreads();  // tile kt is here; every thread is done with tile kt - 1's slot
    if (kt + FP_STAGES - 1 < KT) load_stage((kt + FP_STAGES - 1) % FP_STAGES, kt + FP_STAGES - 1);
    cp_async_commit();
    const float* as = As + (kt % FP_STAGES) * FP_BM * FP_AST;
    const float* bs = Bs + (kt % FP_STAGES) * FP_BK * FP_BN;
    // b of k + 1 loads while k's FMAs run
    float bb[2][16];
    auto load_b = [&](int k, float (&b)[16]) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(bs + k * FP_BN + c * (FP_BN / 4) + tx * 4);
        b[4 * c] = v.x;
        b[4 * c + 1] = v.y;
        b[4 * c + 2] = v.z;
        b[4 * c + 3] = v.w;
      }
    };
    load_b(0, bb[0]);
    // a[i][kk]: rows ty 4 + i and 64 + ty 4 + i (i < 4, i >= 4), k kq + kk
    auto load_a = [&](int kq, float (&a)[8][4]) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
        const float4 v = *reinterpret_cast<const float4*>(as + r * FP_AST + kq);
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      }
    };
#pragma unroll
    for (int kq = 0; kq < FP_BK; kq += 4) {
      float a[8][4];
      load_a(kq, a);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kq + kk + 1 < FP_BK) load_b(kq + kk + 1, bb[(kq + kk + 1) & 1]);
        const float* b = bb[(kq + kk) & 1];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

  float* C = p.xg + (size_t)d * M * G;
  const float* b0 = p.bias0 + (size_t)d * G;
  const float* b1 = p.bias1 + (size_t)d * G;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int n = n0 + c * (FP_BN / 4) + tx * 4;  // this thread's 4 columns
    if (n >= G) continue;
    float bias[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      bias[e] = n + e < G ? b0[n + e] + (n + e < p.nfold ? b1[n + e] : 0.0f) : 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
      if (m >= M) continue;
      const float* v = &acc[i][4 * c];
      float* cp = C + (size_t)m * G + n;
      if constexpr (WV) {
        *reinterpret_cast<float4*>(cp) =
            make_float4(v[0] + bias[0], v[1] + bias[1], v[2] + bias[2], v[3] + bias[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < G) cp[e] = v[e] + bias[e];
      }
    }
  }
}

// ---------------------------------------------------------------- exact f32 products

// gemm_f32_kernel: the simt design's backward products on f32 operands, dx
// and the weight gradients with the bias gradients beside them, in exact
// f32 FMAs on the CUDA cores (proj_f32_kernel's recipe, for the operand
// layouts the backward holds). A CTA of GF_THREADS threads, 16 thread rows
// (ty) by 8 thread columns (tx), owns a tile of BM = 16 RM rows by BN = 8
// TN columns, a thread RM rows by TN columns (RM = 8, TN = 16: 128 x 128;
// two CTAs an SM). The operands reach shared memory by cp.async, a
// GF_STAGES-deep ring of GF_BK-wide k tiles (16-byte copies where the
// operand's rows allow, else 4-byte ones; zeros for k outside the
// operand's range and for chunks past the matrix, whose accumulators are
// never stored), each in the layout it is stored in:
//   K-major (AK / BK: element (i, k) at p[i ld + k + koff]): an image
//     [i][k] with a row stride of GF_KST floats, read 4 k of a row at once;
//     a thread's rows are ty + 16 i (A) and its columns tx + 8 j (B), so
//     the 8 rows of B that a quarter warp reads fall on distinct banks;
//   MN-major (element (i, k) at p[(k + koff) ld + i]): an image [k][i],
//     read 4 consecutive i at once; a thread's rows are 4 ty + i and 64 +
//     4 ty + i - 4, its columns 32 (j / 4) + 4 tx + j % 4.
// dx is both K-major (dxg[d]'s rows, W_ih[d] read as (c, g)), the two
// directions two k segments of one accumulator, BN sized by C (16, 32, 64
// or 128) and RM = 7 or 8 by the waves its tiles fill (dx_rows: at 1,024
// rows and C = 512, 768 tiles of 112 rows are 2.91 waves of two CTAs an SM
// where 672 of 128 would be 2.55, three wave-times either way); the weight
// gradients are both MN-major (X or out's h_prev columns; dxg or dhg), 128
// x 128, one row slice of the L N rows a grid z index. A k costs a thread
// RM + TN operand words for RM TN FMAs (the simt kernel's 8 x 8: 16 for
// 64). Warps whose rows all lie past M (a layer-0 dW_ih tile: M = C = 11)
// issue no FMAs, leaving the SM's issue slots to the other CTA.
#define GF_BM 128
#define GF_THREADS 128  // 16 thread rows x 8 thread columns
#define GF_BK 16
#define GF_STAGES 4
#define GF_KST (GF_BK + 4)  // row stride of a K-major image, floats

// One operand's share of a stage for this thread, set up once a segment so
// that a stage costs a pointer step and a compare or two a chunk (index
// arithmetic in the stage loader costs the FMAs their issue slots). A stage
// is the image of k [k0, k0 + GF_BK) by i [i0, i0 + W): K-major [i][k] of
// row stride GF_KST, chunk j rows tid / 4 + 32 j at k (tid % 4) 4; MN-major
// [k][i] of row stride W, chunk j rows k = tid / (W / 4) + j (128 / (W /
// 4)) at i (tid % (W / 4)) 4. vec: 16-byte chunks (K-major: ld, koff, klo
// and khi multiples of 4; MN-major: ld and n_outer multiples of 4; p
// aligned), zero-filled for k outside [lo, hi) and for chunks past the
// matrix; else 4-byte copies (gf_stage4).
struct GfOp {
  const float* base;  // the operand: a mapped address for the zero fills
  const float* src;   // chunk 0's source in the next stage to load
  int kstep, cstep;   // elements from one stage to the next, from chunk j to j + 1
  int dst, kq;        // chunk 0's byte offset in the image, its k within the stage
  int lo, hi;         // the k holding data, this slice's
  unsigned in;        // bit j: chunk j lies inside the matrix
  int vec;
};

template <bool KM, int W>
struct GfShape {
  static constexpr int CH = KM ? W * (GF_BK / 4) : GF_BK * (W / 4);  // chunks a stage
  static constexpr int NJ = (CH + GF_THREADS - 1) / GF_THREADS;    // chunks a thread
  static constexpr int KJ = KM ? 0 : GF_THREADS / (W / 4);         // k from chunk to chunk
  static constexpr int DSTEP = KM ? 32 * GF_KST * 4 : KJ * W * 4;  // bytes, chunk to chunk
};

template <bool KM, int W>
__device__ __forceinline__ GfOp gf_op(const GemmOp& o, int i0, int n_outer, int kb, int ke,
                                      int tid) {
  using S = GfShape<KM, W>;
  GfOp g;
  g.base = static_cast<const float*>(o.p);
  g.lo = max(kb, o.klo);
  g.hi = min(ke, o.khi);
  g.vec = o.vec;
  g.in = 0u;
  if constexpr (KM) {
    const int r = tid / 4, kq = (tid % 4) * 4;
#pragma unroll
    for (int j = 0; j < S::NJ; ++j)
      if (tid + j * GF_THREADS < S::CH && i0 + r + 32 * j < n_outer) g.in |= 1u << j;
    g.src = g.base + (long long)(i0 + r) * o.ld + o.koff + kb + kq;
    g.kstep = GF_BK;
    g.cstep = (int)(32 * o.ld);
    g.dst = (r * GF_KST + kq) * 4;
    g.kq = kq;
  } else {
    const int kk = tid / (W / 4), iq = (tid % (W / 4)) * 4;
#pragma unroll
    for (int j = 0; j < S::NJ; ++j)
      if (tid + j * GF_THREADS < S::CH && i0 + iq < n_outer) g.in |= 1u << j;
    g.src = g.base + (kb + kk + o.koff) * o.ld + i0 + iq;
    g.kstep = (int)(GF_BK * o.ld);
    g.cstep = (int)(S::KJ * o.ld);
    g.dst = (kk * W + iq) * 4;
    g.kq = kk;
  }
  return g;
}

// 4-byte copies of a stage where 16-byte ones do not fit the operand's rows
// (X's rows at C % 4 != 0): rows below n_outer only, zeros for k outside
// [lo, hi).
template <bool KM, int W>
__device__ __forceinline__ void gf_stage4(uint32_t img, const GemmOp& o, const GfOp& g, int i0,
                                          int n_outer, int k0, int tid) {
  const int rows = min(W, n_outer - i0);
  for (int c = tid; c < GF_BK * rows; c += GF_THREADS) {
    const int kk = KM ? c % GF_BK : c / rows, ii = KM ? c / GF_BK : c % rows, k = k0 + kk;
    const bool ok = k >= g.lo && k < g.hi;
    const float* src = KM ? g.base + (long long)(i0 + ii) * o.ld + k + o.koff
                          : g.base + (k + o.koff) * o.ld + i0 + ii;
    cp_async_4(img + (KM ? ii * GF_KST + kk : kk * W + ii) * 4, ok ? src : g.base, ok);
  }
}

// This thread's copies of the stage at k0 into the image img; steps g to the
// next stage. V: the operand is vec in every job of the launch (else each
// job's flag decides).
template <bool KM, int W, bool V>
__device__ __forceinline__ void gf_stage(uint32_t img, const GemmOp& o, GfOp& g, int i0,
                                         int n_outer, int k0, int tid) {
  using S = GfShape<KM, W>;
  if (V || g.vec) {
#pragma unroll
    for (int j = 0; j < S::NJ; ++j) {
      if (S::CH % GF_THREADS != 0 && tid + j * GF_THREADS >= S::CH) break;
      const int k = k0 + g.kq + j * S::KJ;
      const bool ok = ((g.in >> j) & 1u) && k >= g.lo && k < g.hi;
      cp_async_16(img + g.dst + j * S::DSTEP, ok ? g.src + j * g.cstep : g.base, ok);
    }
    g.src += g.kstep;
  } else {
    gf_stage4<KM, W>(img, o, g, i0, n_outer, k0, tid);
  }
}

// Row i of thread row ty in its CTA's tile: ty + 16 i (i < RM) where A is
// K-major, else 4 ty + i and 64 + 4 ty + i - 4 (i < 8).
template <bool AK>
__device__ __forceinline__ int gf_row(int ty, int i) {
  if (AK) return ty + 16 * i;
  return i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
}

template <bool AK, bool BK, int TN, int RM>
static size_t gf_smem() {
  return (size_t)GF_STAGES *
         ((AK ? 16 * RM * GF_KST : GF_BK * GF_BM) + (BK ? 8 * TN * GF_KST : GF_BK * 8 * TN)) * 4;
}

// One k tile's FMAs: acc[i][j] += A(row i, k) B(k, column j) for k = 0 ..
// GF_BK - 1 ascending, one fmaf each, in the images as and bs.
template <bool AK, bool BK, int TN, int RM>
__device__ __forceinline__ void gf_tile(const float* as, const float* bs, int tx, int ty,
                                        float (&acc)[RM][TN]) {
  constexpr int BN = 8 * TN;
  if constexpr (AK && BK) {
#pragma unroll
    for (int kq = 0; kq < GF_BK; kq += 4) {
      float a[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(as + gf_row<true>(ty, i) * GF_KST + kq);
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      }
      float b[TN][4];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(bs + (tx + 8 * j) * GF_KST + kq);
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
    }
  } else {
    static_assert(!AK && !BK && TN == 16 && RM == 8, "dx, or the weight gradients' 128 x 128");
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
        const float4 v = *reinterpret_cast<const float4*>(as + k * GF_BM + 64 * h + ty * 4);
        a[4 * h] = v.x;
        a[4 * h + 1] = v.y;
        a[4 * h + 2] = v.z;
        a[4 * h + 3] = v.w;
      }
    };
    load(0, aa[0], bb[0]);
#pragma unroll
    for (int k = 0; k < GF_BK; ++k) {
      if (k + 1 < GF_BK) load(k + 1, aa[(k + 1) & 1], bb[(k + 1) & 1]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(aa[k & 1][i], bb[k & 1][j], acc[i][j]);
    }
  }
}

// c (+ the slice's offset) = sum over the job's segments of A_seg B_seg (+
// bias), each element one thread's fmaf chain from 0.0f over the
// segments' k ascending (the slice's rows for the weight gradients; the
// zeros past an operand's range add nothing), then + the bias as gm_bias
// gives it (0.0f without one), as gemm_simt_kernel adds it. With a colsum
// (B MN-major), the CTAs of the first row tile also sum B's columns over
// segment 0's rows as gemm_simt_kernel does: eight plain partials a column
// from 0.0f, the rows whose index is r (mod 8) ascending in partial r, then
// added for r = 0 .. 7 from 0.0f.
template <bool AK, bool BK, int TN, int RM, bool AV>
__global__ void __launch_bounds__(GF_THREADS, 2) gemm_f32_kernel(const GemmParams p) {
  constexpr int BN = 8 * TN, BM = 16 * RM;
  // the weight gradients sum B's columns; dx's two segments share their
  // operands' layout, so the second is the first's pointers moved
  constexpr bool CS = !AK && !BK, SEG2 = AK && BK;
  constexpr int A_IMG = AK ? BM * GF_KST : GF_BK * BM;  // floats a stage
  constexpr int B_IMG = BK ? BN * GF_KST : GF_BK * BN;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + GF_STAGES * A_IMG;
  const int ji = blockIdx.z / p.S, slice = blockIdx.z % p.S;
  const GemmJob& jb = p.job[ji];
  const int M = jb.M, N = jb.N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= M || n0 >= N) return;  // block-uniform, before any barrier
  const int kb = slice * p.Ks, ke = min(p.K, kb + p.Ks);
  const int KT = ke > kb ? (ke - kb + GF_BK - 1) / GF_BK : 0;  // k tiles a segment
  const int NT = KT * jb.nseg;
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  // this warp's first row (4 ty or ty + 16 i) lies inside the matrix
  const bool live = m0 + gf_row<AK>(tid / 32 * 4, 0) < M;
  const bool do_cs = CS && jb.colsum != nullptr && blockIdx.y == 0;
  const uint32_t as0 = smem_u32(As), bs0 = smem_u32(Bs);

  // the next stage to load: its k tile in its segment
  int lkt = 0;
  GfOp ga = gf_op<AK, BM>(jb.a[0], m0, M, kb, ke, tid);
  GfOp gb = gf_op<BK, BN>(jb.b[0], n0, N, kb, ke, tid);
  // dx: from the end of segment 0 to the start of segment 1, in elements
  long long a_jump = 0, b_jump = 0;
  if constexpr (SEG2) {
    a_jump = static_cast<const float*>(jb.a[1].p) - ga.base - (long long)KT * ga.kstep;
    b_jump = static_cast<const float*>(jb.b[1].p) - gb.base - (long long)KT * gb.kstep;
  }
  auto load_stage = [&](int slot) {
    if (SEG2 && lkt == KT) {  // dx: direction 1's segment
      lkt = 0;
      ga.src += a_jump;
      gb.src += b_jump;
    }
    const int k0 = kb + lkt * GF_BK;
    gf_stage<AK, BM, AV>(as0 + slot * A_IMG * 4, jb.a[0], ga, m0, M, k0, tid);
    gf_stage<BK, BN, true>(bs0 + slot * B_IMG * 4, jb.b[0], gb, n0, N, k0, tid);
    ++lkt;
  };

  float acc[RM][TN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  float cs[CS ? 8 : 1];  // column tid's partials by row residue (do_cs)
#pragma unroll
  for (int r = 0; r < (CS ? 8 : 1); ++r) cs[r] = 0.0f;

#pragma unroll
  for (int st = 0; st < GF_STAGES - 1; ++st) {
    if (st < NT) load_stage(st);
    cp_async_commit();
  }
  for (int t = 0; t < NT; ++t) {
    cp_async_wait<GF_STAGES - 2>();
    __syncthreads();  // tile t is here; every thread is done with tile t - 1's slot
    if (t + GF_STAGES - 1 < NT) load_stage((t + GF_STAGES - 1) % GF_STAGES);
    cp_async_commit();
    const float* as = As + (t % GF_STAGES) * A_IMG;
    const float* bs = Bs + (t % GF_STAGES) * B_IMG;
    if constexpr (CS) {
      if (do_cs) {  // rows kb + 16 t + kk, residue kk % 8
#pragma unroll
        for (int kk = 0; kk < GF_BK; ++kk) cs[kk % 8] += bs[kk * BN + tid];
      }
    }
    if (live) gf_tile<AK, BK, TN, RM>(as, bs, tx, ty, acc);
  }
  cp_async_wait<0>();

  const size_t so = (size_t)slice * p.slice_stride;
  float* const c = jb.c + so;
  if (live) {
    if constexpr (BK) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx + 8 * j;
        if (n >= N) continue;
        const float bias = gm_bias(jb, n);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int m = m0 + gf_row<true>(ty, i);
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
        for (int e = 0; e < 4; ++e) bias[e] = n + e < N ? gm_bias(jb, n + e) : 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int m = m0 + gf_row<AK>(ty, i);
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
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < 8; ++r) s += cs[r];
      jb.colsum[so + n0 + tid] = s;
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

// One launch of proj_f32_kernel over both directions.
static int proj_f32_run(const float* x, const float* wih, const float* bih, const float* bhh,
                        float* xg, int M, int C, int G, int nfold, cudaStream_t s) {
  F32ProjParams pp;
  pp.x = x;
  pp.w = wih;
  pp.bias0 = bih;
  pp.bias1 = bhh;
  pp.xg = xg;
  pp.M = M;
  pp.K = C;
  pp.G = G;
  pp.nfold = nfold;
  const bool xv = C % 4 == 0 && (uintptr_t)x % 16 == 0;
  const bool wv = G % 4 == 0 && (uintptr_t)wih % 16 == 0 && (uintptr_t)xg % 16 == 0;
  const void* k = xv && wv ? (const void*)proj_f32_kernel<true, true>
                  : wv     ? (const void*)proj_f32_kernel<false, true>
                           : (const void*)proj_f32_kernel<false, false>;
  const size_t smem = f32_proj_smem();
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((G + FP_BN - 1) / FP_BN, (M + FP_BM - 1) / FP_BM, 2);
  void* args[1] = {&pp};
  e = cudaLaunchKernel(k, grid, dim3(FP_THREADS), args, smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// One launch of gemm_f32_kernel<AK, BK, TN, RM, AV> over the jobs of p.
// Grid: (N tiles, M tiles, jobs x S).
template <bool AK, bool BK, int TN, int RM, bool AV>
static int gf_launch(const GemmParams& p, int njobs, int Mmax, int Nmax, cudaStream_t s) {
  const size_t smem = gf_smem<AK, BK, TN, RM>();
  // the shared-memory limit, set once a device (bit d: set on device d): at
  // the aggregate trainer's shapes the host's time is the call's
  static std::atomic<unsigned long long> smem_set{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0ULL;
  if ((smem_set.load() & bit) == 0) {
    e = cudaFuncSetAttribute(gemm_f32_kernel<AK, BK, TN, RM, AV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set.fetch_or(bit);
  }
  const dim3 grid((Nmax + 8 * TN - 1) / (8 * TN), (Mmax + 16 * RM - 1) / (16 * RM),
                  njobs * p.S);
  gemm_f32_kernel<AK, BK, TN, RM, AV><<<grid, GF_THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// The instantiation for the jobs' operands: AV where every job's A takes
// 16-byte copies (B always does: dxg, dhg and W_ih have rows of 4 floats a
// multiple, 16-byte aligned as the wrappers check).
template <bool AK, bool BK, int TN, int RM = 8>
static int gf_run(const GemmParams& p, int njobs, int Mmax, int Nmax, cudaStream_t s) {
  bool av = true;
  for (int j = 0; j < njobs; ++j) {
    for (int g = 0; g < p.job[j].nseg; ++g) {
      av = av && p.job[j].a[g].vec;
      if (!p.job[j].b[g].vec) return (int)cudaErrorInvalidValue;
    }
  }
  if constexpr (AK && BK) {  // dx (rnn_dx): two segments of one layout, 16-byte copies
    if (!av) return (int)cudaErrorInvalidValue;
    return gf_launch<AK, BK, TN, RM, true>(p, njobs, Mmax, Nmax, s);
  } else {
    return av ? gf_launch<AK, BK, TN, RM, true>(p, njobs, Mmax, Nmax, s)
              : gf_launch<AK, BK, TN, RM, false>(p, njobs, Mmax, Nmax, s);
  }
}

// An f32 operand of gemm_f32_kernel: element (i, k) at p[i ld + k + koff]
// (kmajor) or p[(k + koff) ld + i], k in [klo, khi) holding data, i below
// outer; vec where every 16-byte copy of 4 elements along the stored rows
// is aligned and lies inside them.
static GemmOp f32_op(const float* p, long long ld, long long koff, int klo, int khi, bool kmajor,
                     int outer) {
  GemmOp o = gemm_op<float>(p, ld, koff, klo, khi);
  o.vec = ld % 4 == 0 && (uintptr_t)p % 16 == 0 &&
          (kmajor ? koff % 4 == 0 && klo % 4 == 0 && khi % 4 == 0 : outer % 4 == 0);
  return o;
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

// dx's column tile in gemm_f32_kernel: the least of 16, 32, 64 and 128
// columns that holds C (128 above).
static int dx_cols(int C) { return C <= 16 ? 16 : C <= 32 ? 32 : C <= 64 ? 64 : 128; }

// dx's rows a thread in gemm_f32_kernel, 8 or 7 (tiles of 128 or 112 rows):
// the one whose tiles take the fewest wave-times, a wave-time being a
// tile's rows and a wave two CTAs on each SM (8 on a tie). At 1,024 rows
// and C = 512: 672 tiles of 128 rows are 2.55 waves, 3 x 8 = 24; 768 of
// 112 are 2.91, 3 x 7 = 21.
static int dx_rows(int M, int C) {
  static std::atomic<int> sm_count[64];  // each device's SMs, once read
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess && dev < 64) {
    sms = sm_count[dev].load();
    if (sms == 0 && cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
                        cudaSuccess)
      sm_count[dev].store(sms);
    if (sms <= 0) sms = 132;
  }
  const long long slots = 2LL * sms, nt = (C + dx_cols(C) - 1) / dx_cols(C);
  auto cost = [&](int rm) {
    const long long tiles = nt * ((M + 16 * rm - 1) / (16 * rm));
    return (tiles + slots - 1) / slots * rm;
  };
  return cost(7) < cost(8) ? 7 : 8;
}

// The input gradient, simt: dx (M, C) f32 = sum_d op(dxg[d]) (M, G)
// W_ih[d]^T, dxg f32, W_ih read in its own (C, G) layout.
template <typename T>
static int rnn_dx(const float* dxg, const void* wih, float* dx, int M, int C, int G,
                  cudaStream_t s) {
  constexpr bool f32 = std::is_same<T, float>::value;
  GemmParams gp = {};
  GemmJob& jb = gp.job[0];
  for (int d = 0; d < 2; ++d) {
    const float* a = dxg + (size_t)d * M * G;
    // W_ih[d] (C, G) read as (k, n) -> p[n G + k]: W_ih^T without a copy
    const T* w = static_cast<const T*>(wih) + (size_t)d * C * G;
    if constexpr (f32) {
      jb.a[d] = f32_op(a, G, 0, 0, G, true, M);
      jb.b[d] = f32_op(w, G, 0, 0, G, true, C);
    } else {
      jb.a[d] = gemm_op<float>(a, G, 0, 0, G);
      jb.b[d] = gemm_op<T>(w, G, 0, 0, G);
    }
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
  if constexpr (f32) {
    const int BN = dx_cols(C);
    if (dx_rows(M, C) == 8) {
      if (BN == 16) return gf_run<true, true, 2, 8>(gp, 1, M, C, s);
      if (BN == 32) return gf_run<true, true, 4, 8>(gp, 1, M, C, s);
      if (BN == 64) return gf_run<true, true, 8, 8>(gp, 1, M, C, s);
      return gf_run<true, true, 16, 8>(gp, 1, M, C, s);
    }
    if (BN == 16) return gf_run<true, true, 2, 7>(gp, 1, M, C, s);
    if (BN == 32) return gf_run<true, true, 4, 7>(gp, 1, M, C, s);
    if (BN == 64) return gf_run<true, true, 8, 7>(gp, 1, M, C, s);
    return gf_run<true, true, 16, 7>(gp, 1, M, C, s);
  } else {
    return gemm_run<float, true, T, true, T>(gp, 1, M, C, s);
  }
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
  const int LN = L * N;
  const bool one = dhg == dxg;
  const long long o_whh = 2LL * C * G, o_bih = o_whh + 2LL * H * G, o_bhh = o_bih + 2LL * G;
  constexpr bool f32 = std::is_same<T, float>::value;
  // an MN-major operand: the f32 kernel's, or the simt kernel's
  auto op = [&](const void* p, long long ld, long long koff, int klo, int khi, int outer,
                bool gate) {
    if constexpr (f32)
      return f32_op(static_cast<const float*>(p), ld, koff, klo, khi, false, outer);
    else
      return gate ? gemm_op<float>(p, ld, koff, klo, khi) : gemm_op<T>(p, ld, koff, klo, khi);
  };
  GemmParams gp = {};
  for (int d = 0; d < 2; ++d) {
    GemmJob& ih = gp.job[d];
    ih.a[0] = op(x, C, 0, 0, LN, C, false);  // X^T: (m = c, k = row) at x[k C + m]
    ih.b[0] = op(dxg + (size_t)d * LN * G, G, 0, 0, LN, G, true);
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
    hh.a[0] = op(static_cast<const T*>(out) + d * H, 2 * H, d == 0 ? -N : N, d == 0 ? N : 0,
                 d == 0 ? LN : LN - N, H, false);
    hh.b[0] = op(dhg + (size_t)d * LN * G, G, 0, 0, LN, G, true);
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
  if constexpr (f32)
    return gf_run<false, false, 16>(gp, 4, C > H ? C : H, G, s);
  else
    return gemm_run<T, false, float, false, T>(gp, 4, C > H ? C : H, G, s);
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
