// The matrix products of the RNN training kernels, written once for the
// three shapes a bidirectional layer needs, G = NG H gate columns (the C
// entries of bigru_train.cu run them for K4/K5, NG = 3, and for K6, NG = 4):
//   the input projection  xg[d] = X W_ih[d] + bias       (M = L N, K = C)
//   the input gradient    dx = sum_d op(DXG[d]) W_ih[d]^T (M = L N, K = G)
//   the weight gradients  dW[d] = A^T op(B[d])            (K = L N rows)
// and the column sums of B beside the weight gradients (the bias gradients).
// rnn_proj, rnn_dx and rnn_wgrad at the end describe each as jobs.
//
// One kernel template per route, both over the same job description:
//   gemm_simt_kernel: exact f32 FMAs on the CUDA cores. Block tile 128 x 128,
//     k tile 8, 8 x 8 outputs a thread, operand tiles in shared memory
//     (double-buffered; the next tile is loaded into registers while the
//     current one is multiplied). No TF32.
//   gemm_tc_kernel: bf16 mma.sync.m16n8k16 with f32 accumulators. Block tile
//     128 x 128, k tile 32, eight warps of 64 x 32; operands staged as bf16
//     through registers (an f32 operand, the gate gradients, is rounded to
//     bf16 there), fragments by ldmatrix (.trans where the operand's
//     contiguous dimension is not k).
// Operands are read in the layout the caller already holds (no transposed
// copies): each side is "k-contiguous" (element (i, k) at p[i ld + k]) or not
// (element (i, k) at p[(k + koff) ld + i]), a template argument. Elements with
// k outside [klo, khi) read as 0: the weight gradient of W_hh reads h_prev
// from the layer output one step back in the direction's own time.
//
// Determinism: every output element has one owner thread that sums its k in a
// fixed order; a long contraction is cut into S fixed row slices whose
// partials gemm_sum_slices adds in slice order. No atomics, so reruns are
// bit-equal.

#pragma once

#include <type_traits>

#include "mma_tile.cuh"
#include "rnn_common.cuh"

#define GM_THREADS 256
#define GM_BM 128
#define GM_BN 128
#define SG_BK 8   // k tile of the simt route
#define TG_BK 32  // k tile of the tensor-core route

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

// ---------------------------------------------------------------- tensor cores

#define TG_KS (TG_BK + 8)   // row stride (bf16) of a k-contiguous staged tile
#define TG_IS (GM_BM + 8)   // row stride of a tile staged with i contiguous

template <typename TA, bool A_KC, typename TB, bool B_KC>
__global__ void __launch_bounds__(GM_THREADS, 1) gemm_tc_kernel(const GemmParams p) {
  typedef __nv_bfloat16 bf16;
  constexpr int A_ELEMS = A_KC ? GM_BM * TG_KS : TG_BK * TG_IS;
  constexpr int B_ELEMS = B_KC ? GM_BN * TG_KS : TG_BK * TG_IS;
  __shared__ __align__(16) bf16 As[2][A_ELEMS];
  __shared__ __align__(16) bf16 Bs[2][B_ELEMS];
  const int ji = blockIdx.z / p.S, slice = blockIdx.z % p.S;
  const GemmJob& jb = p.job[ji];
  const int m0 = blockIdx.y * GM_BM, n0 = blockIdx.x * GM_BN;
  if (m0 >= jb.M || n0 >= jb.N) return;
  const int kb = slice * p.Ks, ke = min(p.K, kb + p.Ks);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const bool do_cs = !B_KC && jb.colsum != nullptr && blockIdx.y == 0;

  // vector v = tid + 256 q of a tile: (outer i, k) offsets
  auto vec_ik = [&](bool kc, int q, int& i, int& k) {
    const int v = tid + q * GM_THREADS;
    if (kc) {
      i = v / (TG_BK / 4);
      k = (v % (TG_BK / 4)) * 4;
    } else {
      i = (v % (GM_BM / 4)) * 4;
      k = v / (GM_BM / 4);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
  float cs[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int seg = 0; seg < jb.nseg; ++seg) {
    const GemmOp& A = jb.a[seg];
    const GemmOp& B = jb.b[seg];
    const int alo = max(kb, A.klo), ahi = min(ke, A.khi);
    const int blo = max(kb, B.klo), bhi = min(ke, B.khi);
    const bool cs_here = do_cs && seg == 0;
    float ra[4][4], rb[4][4];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int i, k;
        vec_ik(A_KC, q, i, k);
        gm_fetch<TA, A_KC>(A, m0 + i, k0 + k, alo, ahi, jb.M, ra[q]);
        vec_ik(B_KC, q, i, k);
        gm_fetch<TB, B_KC>(B, n0 + i, k0 + k, blo, bhi, jb.N, rb[q]);
      }
    };
    auto stash = [&](int buf) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int i, k;
        vec_ik(A_KC, q, i, k);
        const uint2 av = make_uint2(pack_bf16x2(ra[q][0], ra[q][1]),
                                    pack_bf16x2(ra[q][2], ra[q][3]));
        *reinterpret_cast<uint2*>(As[buf] + (A_KC ? i * TG_KS + k : k * TG_IS + i)) = av;
        vec_ik(B_KC, q, i, k);
        if (cs_here) {
#pragma unroll
          for (int e = 0; e < 4; ++e) cs[e] += rb[q][e];
        }
        const uint2 bv = make_uint2(pack_bf16x2(rb[q][0], rb[q][1]),
                                    pack_bf16x2(rb[q][2], rb[q][3]));
        *reinterpret_cast<uint2*>(Bs[buf] + (B_KC ? i * TG_KS + k : k * TG_IS + i)) = bv;
      }
    };
    fetch(kb);
    stash(0);
    __syncthreads();
    int buf = 0;
    for (int k0 = kb; k0 < ke; k0 += TG_BK) {
      const bool more = k0 + TG_BK < ke;
      if (more) fetch(k0 + TG_BK);
      const bf16* as = As[buf];
      const bf16* bs = Bs[buf];
#pragma unroll
      for (int kk = 0; kk < TG_BK; kk += 16) {
        uint32_t a[4][4], b[4][2];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int mr = wm * 64 + mt * 16;
          if constexpr (A_KC)
            ldmatrix_x4(a[mt], smem_u32(as + (mr + (lane & 15)) * TG_KS + kk + (lane >> 4) * 8));
          else
            ldmatrix_x4_trans(a[mt], smem_u32(as + (kk + (lane & 7) + ((lane >> 4) << 3)) * TG_IS +
                                              mr + ((lane >> 3) & 1) * 8));
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int nc = wn * 32 + np * 16;
          uint32_t r[4];
          if constexpr (B_KC)
            ldmatrix_x4(r, smem_u32(bs + (nc + (lane & 7) + ((lane >> 4) << 3)) * TG_KS + kk +
                                    ((lane >> 3) & 1) * 8));
          else
            ldmatrix_x4_trans(r, smem_u32(bs + (kk + (lane & 15)) * TG_IS + nc + (lane >> 4) * 8));
          b[2 * np][0] = r[0];
          b[2 * np][1] = r[1];
          b[2 * np + 1][0] = r[2];
          b[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], a[mt], b[j]);
      }
      if (more) stash(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }
  }

  const size_t so = (size_t)slice * p.slice_stride;
  const bool vec_c = jb.ldc % 2 == 0 && (uintptr_t)(jb.c + so) % 8 == 0;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn * 32 + j * 8 + 2 * t4;  // this thread's 2 columns
    if (n >= jb.N) continue;
    const float b0 = gm_bias(jb, n), b1 = n + 1 < jb.N ? gm_bias(jb, n + 1) : 0.0f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * 64 + mt * 16 + g + 8 * half;
        if (m >= jb.M) continue;
        float* cp = jb.c + so + (size_t)m * jb.ldc + n;
        const float v0 = acc[mt][j][2 * half] + b0, v1 = acc[mt][j][2 * half + 1] + b1;
        if (vec_c && n + 1 < jb.N) {
          *reinterpret_cast<float2*>(cp) = make_float2(v0, v1);
        } else {
          cp[0] = v0;
          if (n + 1 < jb.N) cp[1] = v1;
        }
      }
  }
  if (do_cs) {  // B vectors of a thread share their columns: (tid % 32) * 4 ..
    float* cs_s = reinterpret_cast<float*>(&As[0][0]);  // 8 x 128 floats
    const int col = (tid % 32) * 4, kr = tid / 32;
#pragma unroll
    for (int e = 0; e < 4; ++e) cs_s[kr * GM_BN + col + e] = cs[e];
    __syncthreads();
    if (tid < GM_BN && n0 + tid < jb.N) {
      float s = 0.0f;
      for (int r = 0; r < GM_THREADS / 32; ++r) s += cs_s[r * GM_BN + tid];
      jb.colsum[so + n0 + tid] = s;
    }
  }
}

// out[i] = sum over the S slice partials of element i, in slice order
__global__ void __launch_bounds__(GM_THREADS)
    gemm_sum_slices(const float* part, float* out, long long T, int S) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < T;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int sl = 0; sl < S; ++sl) s += part[(size_t)sl * T + i];
    out[i] = s;
  }
}

// One launch over the jobs of p (tc: the bf16 route; else simt with operand
// type TR). Grid: (N tiles, M tiles, jobs x S).
template <typename TA, bool A_KC, typename TB, bool B_KC, typename TR>
static int gemm_run(bool tc, const GemmParams& p, int njobs, int Mmax, int Nmax,
                    cudaStream_t s) {
  const dim3 grid((Nmax + GM_BN - 1) / GM_BN, (Mmax + GM_BM - 1) / GM_BM, njobs * p.S);
  if constexpr (std::is_same<TR, __nv_bfloat16>::value) {
    if (tc) {
      gemm_tc_kernel<TA, A_KC, TB, B_KC><<<grid, GM_THREADS, 0, s>>>(p);
      return (int)cudaGetLastError();
    }
  }
  if (tc) return (int)cudaErrorInvalidValue;  // the tc route takes bf16 only
  gemm_simt_kernel<TA, A_KC, TB, B_KC, TR><<<grid, GM_THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
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

// The input projection of both directions: xg[d] (M, G) f32 = x (M, C)
// W_ih[d] (C, G) + b_ih[d] + the first nfold columns of b_hh[d] (the GRU
// keeps b_hn, its last H, inside the reset product; the LSTM folds all G).
template <typename T>
static int rnn_proj(const void* x, const void* wih, const float* bih, const float* bhh,
                    float* xg, int M, int C, int G, int nfold, cudaStream_t s) {
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
  return gemm_run<T, true, T, false, T>(false, gp, 2, M, G, s);
}

// The input gradient: dx (M, C) f32 = sum_d op(dxg[d]) (M, G) W_ih[d]^T, W_ih
// read in its own (C, G) layout.
template <typename T>
static int rnn_dx(bool tc, const float* dxg, const void* wih, float* dx, int M, int C, int G,
                  cudaStream_t s) {
  GemmParams gp = {};
  GemmJob& jb = gp.job[0];
  for (int d = 0; d < 2; ++d) {
    jb.a[d] = gemm_op<float>(dxg + (size_t)d * M * G, G, 0, 0, G);
    // W_ih[d] (C, G) read as (k, n) -> p[n G + k]: W_ih^T without a copy
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
  return gemm_run<float, true, T, true, T>(tc, gp, 1, M, C, s);
}

// The weight and bias gradients over the L N rows in S fixed row slices, into
// part (S slices of [dW_ih (2, C, G) | dW_hh (2, H, G) | db_ih (2, G) |
// db_hh (2, G)] f32): dW_ih[d] = X^T op(dxg[d]), dW_hh[d] = H_prev^T
// op(dhg[d]), H_prev the layer output one step back in the direction's own
// time, and the column sums of dxg and dhg. dhg == dxg (the LSTM's one gate
// gradient da): its column sum is taken once and db_hh is left out.
template <typename T>
static int rnn_wgrad(bool tc, const void* x, const void* out, const float* dxg,
                     const float* dhg, float* part, int L, int N, int C, int H, int G, int S,
                     cudaStream_t s) {
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
  gp.Ks = (int)((((long long)LN + S - 1) / S + TG_BK - 1) / TG_BK * TG_BK);
  gp.slice_stride = one ? o_bhh : o_bhh + 2LL * G;
  return gemm_run<T, false, float, false, T>(tc, gp, 4, C > H ? C : H, G, s);
}
