// Bidirectional GRU layer for training: K4, the forward that keeps the gate
// residuals, and K5, its backward. One layer per launch (dropout sits between
// layers, outside the kernels), zero h0, gate order r, z, n, b_hn inside the
// reset product.
//
// Replaces: ccsmeth_tpu/ops/bigru_pallas_vjp.py
//   K4 = _fwd_kernel (:31), launched by _fwd_call (:271)
//   K5 = _bwd_kernel (:63), launched by _bwd_call (:305)
//   which together form the custom_vjp fused_bigru_layer_tm (:502-540).
//   The TPU stores the backward direction's output in reversed time and the
//   caller flips it; here every output is in natural time order.
//
// Bound on an H100 SXM, at the main path's shapes (attbigru2s: L = 21,
//   H = 256, N = 2B = 1024 rows for batch 512; C = 11 at layer 0, 512 after):
//   K4 does 2 L N 2 (C + H) 3H FLOPs: 17.6 GFLOP at layer 0 and 50.7 GFLOP
//   at layers 1 and 2; K5 twice that (dx, dh and the two weight gradients):
//   35.3 and 101.5 GFLOP. Per row this is far above the card's ridge (the
//   bytes are the layer's input, output, residuals and K5's f32 scratch), so
//   both are compute-bound: at the 67 TFLOP/s fp32 CUDA-core peak 0.26 / 0.76
//   ms for K4 and 0.53 / 1.51 ms for K5; one training step of the BiGRU
//   (357 GFLOP at batch 512) 5.3 ms in fp32 and 0.36 ms in bf16 on the tensor
//   cores (989 TFLOP/s).
//
// What this design does about the bound: nothing yet. It is the simple,
//   correct version: f32 FMAs on the CUDA cores, weights streamed from L2 (one
//   layer's W_ih and W_hh are at most (512 + 256) x 768 x 2 f32 = 4.7 MB).
//   wgmma on bf16 tiles is for a later change.
//
// K4 (bigru_train_fwd_kernel): as K1 (bigru_stack.cu) for one layer. A block
//   owns Bt rows and runs both directions for them; thread (tx, ty) owns
//   hidden units 4tx .. 4tx+3 of R rows. Per step it writes h to out
//   (L, N, 2H) and the residuals [r, z, n, hg_n] to gates (2, L, N, 4H), both
//   in the store type (the operand type).
//
// K5, two phases in one entry point, with no atomics: two runs on the same
//   inputs give bit-equal results.
//   (a) bigru_train_bwd_rec_kernel, the recurrence. A block owns Bt rows and
//       walks each direction's time in reverse, carrying dh in registers (the
//       thread that owns (row, j) of dh is the only one to read or write it).
//       Per step: dh_total = dout + dh; dz, dn, dr from the residuals and
//       h_prev (the stored output one step earlier in the direction's own
//       time, zero at its first step); dxg = [dr, dz, dn] and
//       dhg = [dr, dz, dn r] go to shared memory (operands of this step's
//       products) and to global f32 scratch (operands of phase b);
//       dh = dh_total z + dhg W_hh^T; dx (+)= dxg W_ih^T, the backward
//       direction adding to what the forward one wrote (same thread, same
//       element). W_hh^T and W_ih^T come transposed and contiguous from the
//       wrapper so the reads along the 3H contraction stay coalesced.
//   (b) rnn_train_wgrad_kernel (rnn_train_common.cuh, shared with K6), the
//       weight gradients: dW_ih[d] = X^T DXG, dW_hh[d] = H_prev^T DHG over
//       the L N rows, and the column sums of DXG and DHG for db_ih and db_hh.
//       The rows are cut into S fixed slices (enough blocks to fill the card;
//       one block walking all 21,504 rows of a 64 x 64 tile leaves the SMs
//       waiting on its loads). Each element of a slice's partial has one
//       owner thread that sums the slice's rows in order (16-row chunks
//       staged in shared memory); then rnn_train_sum_slices adds the S
//       partials of each element in slice order.
//   Rows >= N (the ragged last tile) read zeros in (a), store nothing, and
//   phase (b) sums only the L N real rows, so they add nothing to dW.
//
// Numerics: gate math and every sum in f32. With bf16 operands, x, the
//   weights, dout, out and the residuals are bf16 values (as on the TPU);
//   dxg and dhg are rounded to bf16 as operands of the four products while
//   the bias sums use them unrounded; dx, dW and db are f32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (ops/bigru_vjp.py builds it at first use). Each C entry
//   point returns cudaGetLastError() after its launches.

#include "rnn_train_common.cuh"

struct FwdParams {
  const void* x;      // (L, N, C) T
  const void* wih;    // (2, C, 3H) T
  const float* bih;   // (2, 3H)
  const void* whh;    // (2, H, 3H) T
  const float* bhh;   // (2, 3H)
  void* out;          // (L, N, 2H) T
  void* gates;        // (2, L, N, 4H) T: r, z, n, hg_n
  int L, N, C, H;
};

template <typename T, int R>
__global__ void __launch_bounds__(BIGRU_THREADS, 1)
    bigru_train_fwd_kernel(const FwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, L = p.L, N = p.N, C = p.C, G = 3 * H;
  const int TX = H / 4;
  const int Bt = (blockDim.x / TX) * R;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int j0 = 4 * tx;
  const int rr0 = ty * R;
  const int row0 = blockIdx.x * Bt;

  float* hs_a = smem;             // [H][Bt]
  float* hs_b = smem + H * Bt;    // [H][Bt]
  float* xs = smem + 2 * H * Bt;  // [C][Bt]
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  T* gates = static_cast<T*>(p.gates);

  for (int d = 0; d < 2; ++d) {
    const T* Wih = static_cast<const T*>(p.wih) + (size_t)d * C * G;
    const T* Whh = static_cast<const T*>(p.whh) + (size_t)d * H * G;
    const float* bi = p.bih + d * G;
    const float* bh = p.bhh + d * G;
    float b_r[4], b_z[4], b_xn[4], b_hn[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b_r[j] = bi[j0 + j] + bh[j0 + j];
      b_z[j] = bi[H + j0 + j] + bh[H + j0 + j];
      b_xn[j] = bi[2 * H + j0 + j];
      b_hn[j] = bh[2 * H + j0 + j];
    }
    float* hc = hs_a;
    float* hnx = hs_b;
    for (int i = tid; i < H * Bt; i += blockDim.x) hc[i] = 0.0f;

    for (int s = 0; s < L; ++s) {
      const int t = (d == 0) ? s : L - 1 - s;
      const T* xt = x + (size_t)t * N * C;
      for (int i = tid; i < Bt * C; i += blockDim.x) {
        const int r = i / C, c = i - r * C;
        const int row = row0 + r;
        xs[c * Bt + r] = (row < N) ? Op<T>::to_f(xt[(size_t)row * C + c]) : 0.0f;
      }
      __syncthreads();

      float ar[R][4], az[R][4], axn[R][4], ahn[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ar[r][j] = b_r[j];
          az[r][j] = b_z[j];
          axn[r][j] = b_xn[j];
          ahn[r][j] = b_hn[j];
        }
      }
      gru_gate_sums<T, R>(xs, C, hc, H, Bt, rr0, j0, Wih, Whh, ar, az, axn,
                          ahn);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + rr0 + r;
        float hv[4], rv[4], zv[4], nv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          rv[j] = sigmoid_f(ar[r][j]);
          zv[j] = sigmoid_f(az[r][j]);
          nv[j] = tanhf(axn[r][j] + rv[j] * ahn[r][j]);
          const int sidx = (j0 + j) * Bt + rr0 + r;
          hv[j] = (1.0f - zv[j]) * nv[j] + zv[j] * hc[sidx];
          hnx[sidx] = hv[j];
        }
        if (row < N) {
          Op<T>::store4(out + ((size_t)t * N + row) * 2 * H + d * H + j0, hv);
          T* g = gates + (((size_t)d * L + t) * N + row) * 4 * H + j0;
          Op<T>::store4(g, rv);
          Op<T>::store4(g + H, zv);
          Op<T>::store4(g + 2 * H, nv);
          Op<T>::store4(g + 3 * H, ahn[r]);
        }
      }
      __syncthreads();
      float* tmp = hc;
      hc = hnx;
      hnx = tmp;
    }
  }
}

struct BwdParams {
  const void* dout;   // (L, N, 2H) T
  const void* x;      // (L, N, C) T
  const void* out;    // (L, N, 2H) T
  const void* gates;  // (2, L, N, 4H) T
  const void* wihT;   // (2, 3H, C) T: W_ih transposed, contiguous
  const void* whhT;   // (2, 3H, H) T: W_hh transposed, contiguous
  float* dx;          // (L, N, C)
  float* dxg;         // (2, L, N, 3H) scratch
  float* dhg;         // (2, L, N, 3H) scratch
  float* grads;       // [dW_ih (2, C, 3H) | dW_hh (2, H, 3H) | db_ih | db_hh]
  float* part;        // (S, size of grads) slice partials (grads when S = 1)
  int L, N, C, H, S;
};

// Phase (a). CW: dx columns per work item (4 when C % 4 == 0, else 1).
template <typename T, int R, int CW>
__global__ void __launch_bounds__(BIGRU_THREADS, 1)
    bigru_train_bwd_rec_kernel(const BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, L = p.L, N = p.N, C = p.C, G = 3 * H;
  const int TX = H / 4;
  const int TY = blockDim.x / TX;
  const int Bt = TY * R;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int j0 = 4 * tx;
  const int rr0 = ty * R;
  const int row0 = blockIdx.x * Bt;

  float* xg_s = smem;           // [3H][Bt] dxg of this step
  float* hg_s = smem + G * Bt;  // [3H][Bt] dhg of this step
  const T* dout = static_cast<const T*>(p.dout);
  const T* out = static_cast<const T*>(p.out);
  const T* gates = static_cast<const T*>(p.gates);

  for (int d = 0; d < 2; ++d) {
    const T* WihT = static_cast<const T*>(p.wihT) + (size_t)d * G * C;
    const T* WhhT = static_cast<const T*>(p.whhT) + (size_t)d * G * H;
    float* dxg = p.dxg + (size_t)d * L * N * G;
    float* dhg = p.dhg + (size_t)d * L * N * G;
    float dh[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) dh[r][j] = 0.0f;

    for (int s = 0; s < L; ++s) {
      // direction-local time runs backwards: L-1 .. 0
      const int t = (d == 0) ? L - 1 - s : s;
      const bool has_prev = (d == 0) ? (t > 0) : (t < L - 1);
      const int tp = (d == 0) ? t - 1 : t + 1;

      // 1) the gate gradients of this step
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int rr = rr0 + r;
        const int row = row0 + rr;
        float rg[4] = {0, 0, 0, 0}, zg[4] = {0, 0, 0, 0};
        float ng[4] = {0, 0, 0, 0}, hgn[4] = {0, 0, 0, 0};
        float dov[4] = {0, 0, 0, 0}, hp[4] = {0, 0, 0, 0};
        if (row < N) {
          const T* g = gates + (((size_t)d * L + t) * N + row) * 4 * H + j0;
          Op<T>::load4(g, rg);
          Op<T>::load4(g + H, zg);
          Op<T>::load4(g + 2 * H, ng);
          Op<T>::load4(g + 3 * H, hgn);
          Op<T>::load4(dout + ((size_t)t * N + row) * 2 * H + d * H + j0, dov);
          if (has_prev)
            Op<T>::load4(out + ((size_t)tp * N + row) * 2 * H + d * H + j0, hp);
        }
        float vr[4], vz[4], vn[4], vnr[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float dt = dov[j] + dh[r][j];
          const float dz = dt * (hp[j] - ng[j]) * zg[j] * (1.0f - zg[j]);
          const float dn = dt * (1.0f - zg[j]) * (1.0f - ng[j] * ng[j]);
          const float dr = dn * hgn[j] * rg[j] * (1.0f - rg[j]);
          dh[r][j] = dt * zg[j];
          vr[j] = dr;
          vz[j] = dz;
          vn[j] = dn;
          vnr[j] = dn * rg[j];
          xg_s[(j0 + j) * Bt + rr] = dr;
          xg_s[(H + j0 + j) * Bt + rr] = dz;
          xg_s[(2 * H + j0 + j) * Bt + rr] = dn;
          hg_s[(j0 + j) * Bt + rr] = dr;
          hg_s[(H + j0 + j) * Bt + rr] = dz;
          hg_s[(2 * H + j0 + j) * Bt + rr] = vnr[j];
        }
        if (row < N) {
          const size_t o = ((size_t)t * N + row) * G + j0;
          Op<float>::store4(dxg + o, vr);
          Op<float>::store4(dxg + o + H, vz);
          Op<float>::store4(dxg + o + 2 * H, vn);
          Op<float>::store4(dhg + o, vr);
          Op<float>::store4(dhg + o + H, vz);
          Op<float>::store4(dhg + o + 2 * H, vnr);
        }
      }
      __syncthreads();

      // 2) dh = dh_total z + dhg W_hh^T (contraction over 3H)
      {
        float acc[R][4];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;
        rec_hidden_product<T, R>(WhhT, G, H, hg_s, Bt, rr0, j0, acc);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) dh[r][j] += acc[r][j];
      }

      // 3) dx (+)= dxg W_ih^T
      rec_input_product<T, R, CW>(WihT, G, C, xg_s, Bt, row0, N,
                                  p.dx + (size_t)t * N * C, d == 1);
      __syncthreads();
    }
  }
}

template <typename T, int R>
static int fwd_typed(const FwdParams& p, int block_rows_y, cudaStream_t s) {
  const int threads = (p.H / 4) * block_rows_y;
  const int Bt = block_rows_y * R;
  const size_t smem = (size_t)(2 * p.H + p.C) * Bt * sizeof(float);
  const int e = set_smem((const void*)bigru_train_fwd_kernel<T, R>, smem);
  if (e) return e;
  bigru_train_fwd_kernel<T, R><<<(p.N + Bt - 1) / Bt, threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int R, int CW>
static int rec_typed(const BwdParams& p, int block_rows_y, cudaStream_t s) {
  const int threads = (p.H / 4) * block_rows_y;
  const int Bt = block_rows_y * R;
  const size_t smem = (size_t)6 * p.H * Bt * sizeof(float);
  const int e = set_smem((const void*)bigru_train_bwd_rec_kernel<T, R, CW>, smem);
  if (e) return e;
  bigru_train_bwd_rec_kernel<T, R, CW>
      <<<(p.N + Bt - 1) / Bt, threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int R>
static int rec_cw(const BwdParams& p, int block_rows_y, cudaStream_t s) {
  if (p.C % 4 == 0) return rec_typed<T, R, 4>(p, block_rows_y, s);
  return rec_typed<T, R, 1>(p, block_rows_y, s);
}

template <typename T>
static int bwd_typed(const BwdParams& p, int R, int block_rows_y,
                     cudaStream_t s) {
  int e = (int)cudaErrorInvalidValue;
  if (R == 8) e = rec_cw<T, 8>(p, block_rows_y, s);
  if (R == 4) e = rec_cw<T, 4>(p, block_rows_y, s);
  if (R == 2) e = rec_cw<T, 2>(p, block_rows_y, s);
  if (R == 1) e = rec_cw<T, 1>(p, block_rows_y, s);
  if (e) return e;
  return wgrad_run<T>(p.x, p.out, p.dxg, p.dhg, p.L, p.N, p.C, p.H, 3 * p.H,
                      p.S, false, p.grads, p.part, s);
}

extern "C" {

// K4. dtype: 0 = float32, 1 = bfloat16 (operands and stored outputs).
// rows_per_thread (R) in {1, 2, 4, 8}; block_rows_y (TY) threads along the
// rows, H / 4 along the hidden units, (H / 4) * TY <= 256.
// Returns 0 or a cudaError_t value.
int bigru_train_fwd_launch(int dtype, const void* x, const void* wih,
                           const void* bih, const void* whh, const void* bhh,
                           void* out, void* gates, int L, int N, int C, int H,
                           int rows_per_thread, int block_rows_y,
                           void* stream) {
  if (!shape_ok(L, N, C, H, block_rows_y)) return (int)cudaErrorInvalidValue;
  FwdParams p;
  p.x = x;
  p.wih = wih;
  p.bih = static_cast<const float*>(bih);
  p.whh = whh;
  p.bhh = static_cast<const float*>(bhh);
  p.out = out;
  p.gates = gates;
  p.L = L;
  p.N = N;
  p.C = C;
  p.H = H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = rows_per_thread, ty = block_rows_y;
  if (dtype == 0) {
    if (R == 8) return fwd_typed<float, 8>(p, ty, s);
    if (R == 4) return fwd_typed<float, 4>(p, ty, s);
    if (R == 2) return fwd_typed<float, 2>(p, ty, s);
    if (R == 1) return fwd_typed<float, 1>(p, ty, s);
  } else if (dtype == 1) {
    if (R == 8) return fwd_typed<__nv_bfloat16, 8>(p, ty, s);
    if (R == 4) return fwd_typed<__nv_bfloat16, 4>(p, ty, s);
    if (R == 2) return fwd_typed<__nv_bfloat16, 2>(p, ty, s);
    if (R == 1) return fwd_typed<__nv_bfloat16, 1>(p, ty, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K5: phase (a) then phase (b) on the same stream. dxg and dhg are
// (2, L, N, 3H) f32 scratch; grads is [dW_ih (2, C, 3H) | dW_hh (2, H, 3H) |
// db_ih (2, 3H) | db_hh (2, 3H)] f32 and part (S, the same size) f32 scratch
// for the S row slices of phase (b) (unused when S = 1). dx and grads are
// written in full (no zeroing needed). Same tiling arguments as K4.
int bigru_train_bwd_launch(int dtype, const void* dout, const void* x,
                           const void* out, const void* gates,
                           const void* wihT, const void* whhT, void* dx,
                           void* dxg, void* dhg, void* grads, void* part,
                           int slices, int L, int N, int C, int H,
                           int rows_per_thread, int block_rows_y,
                           void* stream) {
  if (!shape_ok(L, N, C, H, block_rows_y) || slices < 1 ||
      (long long)L * N >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.dout = dout;
  p.x = x;
  p.out = out;
  p.gates = gates;
  p.wihT = wihT;
  p.whhT = whhT;
  p.dx = static_cast<float*>(dx);
  p.dxg = static_cast<float*>(dxg);
  p.dhg = static_cast<float*>(dhg);
  p.grads = static_cast<float*>(grads);
  p.part = static_cast<float*>(part);
  p.S = slices;
  p.L = L;
  p.N = N;
  p.C = C;
  p.H = H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_typed<float>(p, rows_per_thread, block_rows_y, s);
  if (dtype == 1)
    return bwd_typed<__nv_bfloat16>(p, rows_per_thread, block_rows_y, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
