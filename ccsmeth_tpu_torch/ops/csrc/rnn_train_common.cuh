// The pieces of K6's backward (bilstm_train.cu, LSTM); K5 (bigru_train.cu,
// GRU) used them too until its redesign onto rnn_train_gemm.cuh, which K6
// can adopt the same way. Two phases with no atomics, so two runs on the same
// inputs give bit-equal results:
//   (a) a recurrence kernel, one block per Bt rows, that walks each
//       direction's time in reverse and writes the gate gradients to f32
//       scratch; its two products (the recurrent carry dh and dx) are
//       rec_hidden_product and rec_input_product below;
//   (b) the weight gradients dW_ih[d] = X^T B_ih[d] and dW_hh[d] =
//       H_prev^T B_hh[d] over the L N rows, with the bias gradients as column
//       sums: rnn_train_wgrad_kernel over S fixed row slices, then
//       rnn_train_sum_slices adding the S partials in slice order
//       (wgrad_run launches both).
// wgrad_run takes separate B_ih and B_hh (a GRU's dxg and dhg); the LSTM's
// are one matrix, da, whose column sum is both db_ih and db_hh.

#pragma once

#include "rnn_common.cuh"

static int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

static bool shape_ok(int L, int N, int C, int H, int block_rows_y) {
  return L >= 1 && N >= 1 && C >= 1 && H >= 4 && H % 4 == 0 &&
         block_rows_y >= 1 && (H / 4) * block_rows_y <= BIGRU_THREADS;
}

// acc[r][j] += sum_g operand(s[g][rr0 + r]) WT[g][j0 + j]: a thread's R rows
// and four hidden units of S WT, contracting over the G gate gradients of
// this step (s, [G][Bt] f32 in shared memory) against W_hh^T (G, H),
// transposed and contiguous so the reads along G stay coalesced. One weight
// load an iteration: unrolled 8 deep so eight L2 loads are in flight (with one
// block an SM, latency sets this loop's pace).
template <typename T, int R>
__device__ __forceinline__ void rec_hidden_product(const T* WT, int G, int H,
                                                   const float* s, int Bt,
                                                   int rr0, int j0,
                                                   float (&acc)[R][4]) {
#pragma unroll 8
  for (int g = 0; g < G; ++g) {
    float w[4], v[R];
    Op<T>::load4(WT + (size_t)g * H + j0, w);
    load_rows<R>(s + g * Bt + rr0, v);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float a = Op<T>::operand(v[r]);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(a, w[j], acc[r][j]);
    }
  }
}

// dx_t (+)= s^T W_ih^T for the block's Bt rows (row0 ..) of one timestep:
// dx_t is (N, C) f32, s the step's gate gradients ([G][Bt] f32, shared),
// WT = W_ih^T (G, C), transposed and contiguous. Work items of R rows x CW
// columns (CW = 4 when C % 4 == 0, else 1) spread over the block's threads;
// add = false writes (the forward direction), true adds (the backward one:
// the same thread, same element).
template <typename T, int R, int CW>
__device__ __forceinline__ void rec_input_product(const T* WT, int G, int C,
                                                  const float* s, int Bt,
                                                  int row0, int N, float* dx_t,
                                                  bool add) {
  const int n_cq = C / CW;  // dx column groups
  const int n_items = (Bt / R) * n_cq;
  for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
    const int ry = item / n_cq;
    const int c0 = (item - ry * n_cq) * CW;
    float acc[R][CW];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[r][c] = 0.0f;
#pragma unroll 8
    for (int g = 0; g < G; ++g) {
      float w[CW], v[R];
      const T* wg = WT + (size_t)g * C + c0;
      if constexpr (CW == 4) {
        Op<T>::load4(wg, w);
      } else {
        w[0] = Op<T>::to_f(wg[0]);
      }
      load_rows<R>(s + g * Bt + ry * R, v);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float a = Op<T>::operand(v[r]);
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[r][c] = fmaf(a, w[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + ry * R + r;
      if (row < N) {
        float* dxp = dx_t + (size_t)row * C + c0;
#pragma unroll
        for (int c = 0; c < CW; ++c)
          dxp[c] = add ? dxp[c] + acc[r][c] : acc[r][c];
      }
    }
  }
}

// Phase (b): out[m][n] = sum_k A(k, m) op(B[k][n]) and colsum[n] =
// sum_k B[k][n], k = t N + row over one slice of the L N rows, in order.
// A(k, m) is a[(k + koff) lda + m] for k in [klo, khi) and 0 elsewhere: the
// layer input x, or h_prev read from out one step earlier in the direction's
// own time. out and colsum are offsets into the slice's partial; colsum < 0
// skips the column sum.
struct WgradJob {
  const void* a;
  long long koff;
  int lda, klo, khi, M;
  const float* b;    // (L N, G) f32
  long long out;     // (M, G)
  long long colsum;  // (G), or -1
};

struct WgradParams {
  WgradJob job[4];  // (ih, fwd), (ih, bwd), (hh, fwd), (hh, bwd)
  float* part;      // (S, T)
  long long T;      // floats per slice partial
  int K, G, S, Ks;  // Ks rows per slice, a multiple of WG_KC
};

#define WG_TILE 64
#define WG_KC 16

template <typename T>
__global__ void __launch_bounds__(BIGRU_THREADS)
    rnn_train_wgrad_kernel(const WgradParams p) {
  __shared__ __align__(16) float As[WG_KC][WG_TILE];
  __shared__ __align__(16) float Bs[WG_KC][WG_TILE];
  const int slice = blockIdx.z % p.S;
  const WgradJob jb = p.job[blockIdx.z / p.S];
  const int k_end = min(p.K, (slice + 1) * p.Ks);
  float* part = p.part + (size_t)slice * p.T;
  const int m0 = blockIdx.y * WG_TILE;
  const int n0 = blockIdx.x * WG_TILE;
  if (m0 >= jb.M) return;  // a block-uniform exit, before any barrier
  const int G = p.G;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* a = static_cast<const T*>(jb.a);
  const bool do_colsum = (blockIdx.y == 0) && jb.colsum >= 0;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  float cs = 0.0f;

  for (int k0 = slice * p.Ks; k0 < k_end; k0 += WG_KC) {
    // stage 16 rows x 64 columns of A and of B (4 values a thread each)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = tid + q * BIGRU_THREADS;
      const int kk = i / WG_TILE, c = i % WG_TILE;
      const int k = k0 + kk;
      const int m = m0 + c, n = n0 + c;
      float av = 0.0f, bv = 0.0f;
      if (k < k_end) {
        if (m < jb.M && k >= jb.klo && k < jb.khi)
          av = Op<T>::to_f(a[(size_t)(k + jb.koff) * jb.lda + m]);
        if (n < G) bv = jb.b[(size_t)k * G + n];
      }
      As[kk][c] = av;
      Bs[kk][c] = bv;
    }
    __syncthreads();
    if (do_colsum && tid < WG_TILE) {
#pragma unroll
      for (int kk = 0; kk < WG_KC; ++kk) cs += Bs[kk][tid];
    }
#pragma unroll
    for (int kk = 0; kk < WG_KC; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bq = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float am[4] = {av.x, av.y, av.z, av.w};
      const float bn[4] = {Op<T>::operand(bq.x), Op<T>::operand(bq.y),
                           Op<T>::operand(bq.z), Op<T>::operand(bq.w)};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(am[i], bn[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= jb.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < G) part[jb.out + (size_t)m * G + n] = acc[i][j];
    }
  }
  if (do_colsum && tid < WG_TILE && n0 + tid < G)
    part[jb.colsum + n0 + tid] = cs;
}

// out[i] = sum over the S slice partials of element i, in slice order
__global__ void __launch_bounds__(BIGRU_THREADS)
    rnn_train_sum_slices(const float* part, float* out, long long T, int S) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < T;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int sl = 0; sl < S; ++sl) s += part[(size_t)sl * T + i];
    out[i] = s;
  }
}

// Phase (b) for one bidirectional layer. x (L, N, C) and out (L, N, 2H) in T;
// b_ih and b_hh (2, L N, G) f32. grads is [dW_ih (2, C, G) | dW_hh (2, H, G) |
// db_ih (2, G) | db_hh (2, G)], or with shared_bias (b_ih == b_hh) one db
// (2, G) in place of the last two; part (S, that size) f32 scratch for the S
// row slices (unused when S = 1). Everything is written in full.
template <typename T>
static int wgrad_run(const void* x, const void* out, const float* b_ih,
                     const float* b_hh, int L, int N, int C, int H, int G,
                     int S, bool shared_bias, float* grads, float* part,
                     cudaStream_t s) {
  const long long LN = (long long)L * N;
  WgradParams w;
  w.K = (int)LN;
  w.G = G;
  w.S = S;
  w.Ks = (int)(((LN + S - 1) / S + WG_KC - 1) / WG_KC * WG_KC);
  w.T = 2LL * C * G + 2LL * H * G + (shared_bias ? 2LL : 4LL) * G;
  w.part = (S == 1) ? grads : part;
  const long long o_wih = 0, o_whh = 2LL * C * G;
  const long long o_bih = o_whh + 2LL * H * G, o_bhh = o_bih + 2LL * G;
  for (int d = 0; d < 2; ++d) {
    WgradJob& ih = w.job[d];
    ih.a = x;
    ih.koff = 0;
    ih.lda = C;
    ih.klo = 0;
    ih.khi = (int)LN;
    ih.M = C;
    ih.b = b_ih + (size_t)d * LN * G;
    ih.out = o_wih + (long long)d * C * G;
    ih.colsum = o_bih + d * G;
    WgradJob& hh = w.job[2 + d];
    // h_prev of row k = t N + row: out[t - 1] (fwd half) or out[t + 1] (bwd)
    hh.a = static_cast<const T*>(out) + d * H;
    hh.koff = (d == 0) ? -(long long)N : (long long)N;
    hh.lda = 2 * H;
    hh.klo = (d == 0) ? N : 0;
    hh.khi = (d == 0) ? (int)LN : (int)(LN - N);
    hh.M = H;
    hh.b = b_hh + (size_t)d * LN * G;
    hh.out = o_whh + (long long)d * H * G;
    hh.colsum = shared_bias ? -1 : o_bhh + d * G;
  }
  const int mmax = C > H ? C : H;
  dim3 grid((G + WG_TILE - 1) / WG_TILE, (mmax + WG_TILE - 1) / WG_TILE, 4 * S);
  rnn_train_wgrad_kernel<T><<<grid, BIGRU_THREADS, 0, s>>>(w);
  if (S > 1) {
    const int e = (int)cudaGetLastError();
    if (e) return e;
    const long long blocks = (w.T + BIGRU_THREADS - 1) / BIGRU_THREADS;
    rnn_train_sum_slices<<<(int)(blocks < 4096 ? blocks : 4096), BIGRU_THREADS,
                           0, s>>>(part, grads, w.T, S);
  }
  return (int)cudaGetLastError();
}
