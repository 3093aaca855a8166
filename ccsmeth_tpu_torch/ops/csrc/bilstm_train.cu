// Bidirectional LSTM layer for training: K6, the forward that keeps the
// residuals and its backward. One layer per launch (dropout sits between
// layers, outside the kernels), zero h0 and c0, gate order i, f, g, o.
//
// Replaces: ccsmeth_tpu/ops/bigru_pallas_vjp.py
//   K6 forward  = _fwd_lstm_kernel (:122), launched by _fwd_lstm_call (:381)
//   K6 backward = _bwd_lstm_kernel (:167), launched by _bwd_lstm_call (:422)
//   which together form the custom_vjp fused_bilstm_layer_tm (:543-574).
//   The TPU stores the backward direction's outputs in reversed time and the
//   caller flips them; here every output is in natural time order.
//
// Bound on an H100 SXM, at the main path's shapes (attbilstm2s: L = 21,
//   H = 256, N = 2B = 1024 rows for batch 512; C = 11 at layer 0, 512 after):
//   the forward does 2 L N 2 (C + H) 4H FLOPs: 23.5 GFLOP at layer 0 and
//   67.7 GFLOP at layers 1 and 2; the backward twice that (dx, dh and the two
//   weight gradients): 47.0 and 135.3 GFLOP. Per row this is far above the
//   card's ridge, so both are compute-bound: at the 67 TFLOP/s fp32 CUDA-core
//   peak 0.35 / 1.01 ms forward and 0.70 / 2.02 ms backward.
//
// What this design does about the bound: nothing yet. It is the simple,
//   correct version: f32 FMAs on the CUDA cores, weights streamed from L2 (one
//   layer's W_ih and W_hh are at most (512 + 256) x 1024 x 2 f32 = 6.3 MB).
//   wgmma on bf16 tiles is for a later change.
//
// Forward (bilstm_train_fwd_kernel): as K1's LSTM cell (bigru_stack.cu) for
//   one layer. A block owns Bt rows and runs both directions for them; thread
//   (tx, ty) owns hidden units 4tx .. 4tx+3 of R rows. h (double-buffered) and
//   c are f32 in shared memory and carried in f32 from step to step. Per step
//   it writes h to out (L, N, 2H), c to cseq (2, L, N, H) and the activations
//   [i, f, g, o] to gates (2, L, N, 4H), all in the store type (the operand
//   type), as the TPU kernel stores them.
//
// Backward, two phases in one entry point (rnn_train_common.cuh), with no
//   atomics: two runs on the same inputs give bit-equal results.
//   (a) bilstm_train_bwd_rec_kernel, the recurrence. A block owns Bt rows and
//       walks each direction's time in reverse, carrying dh and dc in
//       registers (the thread that owns (row, j) is the only one to read or
//       write them). Per step, from the stored residuals:
//         tc = tanh(c); dh_t = dout + dh; dc = dh_t o (1 - tc^2) + dc
//         da = [dc g i(1-i), dc c_prev f(1-f), dc i (1-g^2), dh_t tc o(1-o)]
//         dc = dc f; dh = da W_hh^T; dx (+)= da W_ih^T
//       c_prev is the stored c one step earlier in the direction's own time
//       (zero at its first step). da goes to shared memory (the operand of
//       this step's products) and to global f32 scratch (2, L, N, 4H).
//   (b) the weight gradients dW_ih[d] = X^T DA and dW_hh[d] = H_prev^T DA
//       from the one DA matrix, and its column sum once for db_ih = db_hh
//       (rnn_train_wgrad_kernel, row slices summed in order).
//   Rows >= N (the ragged last tile) read zeros in (a), store nothing, and
//   phase (b) sums only the L N real rows, so they add nothing to dW.
//
// Numerics: gate math and every sum in f32. With bf16 operands, x, the
//   weights, dout and the residuals (out, c, gates) are bf16 values (as on the
//   TPU); da is rounded to bf16 as the operand of the four products while the
//   bias sum uses it unrounded; dx, dW and db are f32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (ops/bilstm_vjp.py builds it at first use). Each C entry
//   point returns cudaGetLastError() after its launches.

#include "rnn_train_common.cuh"

struct LstmFwdParams {
  const void* x;      // (L, N, C) T
  const void* wih;    // (2, C, 4H) T
  const float* bih;   // (2, 4H)
  const void* whh;    // (2, H, 4H) T
  const float* bhh;   // (2, 4H)
  void* out;          // (L, N, 2H) T
  void* cseq;         // (2, L, N, H) T
  void* gates;        // (2, L, N, 4H) T: i, f, g, o
  int L, N, C, H;
};

template <typename T, int R>
__global__ void __launch_bounds__(BIGRU_THREADS, 1)
    bilstm_train_fwd_kernel(const LstmFwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, L = p.L, N = p.N, C = p.C, G = 4 * H;
  const int TX = H / 4;
  const int Bt = (blockDim.x / TX) * R;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int j0 = 4 * tx;
  const int rr0 = ty * R;
  const int row0 = blockIdx.x * Bt;

  float* hs_a = smem;             // [H][Bt]
  float* hs_b = smem + H * Bt;    // [H][Bt]
  float* cs = smem + 2 * H * Bt;  // [H][Bt]
  float* xs = smem + 3 * H * Bt;  // [C][Bt]
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  T* cseq = static_cast<T*>(p.cseq);
  T* gates = static_cast<T*>(p.gates);

  for (int d = 0; d < 2; ++d) {
    const T* Wih = static_cast<const T*>(p.wih) + (size_t)d * C * G;
    const T* Whh = static_cast<const T*>(p.whh) + (size_t)d * H * G;
    const float* bi = p.bih + d * G;
    const float* bh = p.bhh + d * G;
    float b_i[4], b_f[4], b_g[4], b_o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b_i[j] = bi[j0 + j] + bh[j0 + j];
      b_f[j] = bi[H + j0 + j] + bh[H + j0 + j];
      b_g[j] = bi[2 * H + j0 + j] + bh[2 * H + j0 + j];
      b_o[j] = bi[3 * H + j0 + j] + bh[3 * H + j0 + j];
    }
    float* hc = hs_a;
    float* hnx = hs_b;
    for (int i = tid; i < H * Bt; i += blockDim.x) {
      hc[i] = 0.0f;
      cs[i] = 0.0f;
    }

    for (int s = 0; s < L; ++s) {
      const int t = (d == 0) ? s : L - 1 - s;
      const T* xt = x + (size_t)t * N * C;
      for (int i = tid; i < Bt * C; i += blockDim.x) {
        const int r = i / C, c = i - r * C;
        const int row = row0 + r;
        xs[c * Bt + r] = (row < N) ? Op<T>::to_f(xt[(size_t)row * C + c]) : 0.0f;
      }
      __syncthreads();

      float ai[R][4], af[R][4], ag[R][4], ao[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ai[r][j] = b_i[j];
          af[r][j] = b_f[j];
          ag[r][j] = b_g[j];
          ao[r][j] = b_o[j];
        }
      }
      lstm_gate_sums<T, R>(xs, C, hc, H, Bt, rr0, j0, Wih, Whh, ai, af, ag, ao);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + rr0 + r;
        float hv[4], cv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int sidx = (j0 + j) * Bt + rr0 + r;
          cv[j] = cs[sidx];
          hv[j] = lstm_update(ai[r][j], af[r][j], ag[r][j], ao[r][j], cv[j]);
          cs[sidx] = cv[j];
          hnx[sidx] = hv[j];
        }
        if (row < N) {
          Op<T>::store4(out + ((size_t)t * N + row) * 2 * H + d * H + j0, hv);
          Op<T>::store4(cseq + (((size_t)d * L + t) * N + row) * H + j0, cv);
          T* g = gates + (((size_t)d * L + t) * N + row) * G + j0;
          Op<T>::store4(g, ai[r]);
          Op<T>::store4(g + H, af[r]);
          Op<T>::store4(g + 2 * H, ag[r]);
          Op<T>::store4(g + 3 * H, ao[r]);
        }
      }
      __syncthreads();
      float* tmp = hc;
      hc = hnx;
      hnx = tmp;
    }
  }
}

struct LstmBwdParams {
  const void* dout;   // (L, N, 2H) T
  const void* cseq;   // (2, L, N, H) T
  const void* gates;  // (2, L, N, 4H) T
  const void* wihT;   // (2, 4H, C) T: W_ih transposed, contiguous
  const void* whhT;   // (2, 4H, H) T: W_hh transposed, contiguous
  float* dx;          // (L, N, C)
  float* da;          // (2, L, N, 4H) scratch
  int L, N, C, H;
};

// Phase (a). CW: dx columns per work item (4 when C % 4 == 0, else 1).
template <typename T, int R, int CW>
__global__ void __launch_bounds__(BIGRU_THREADS, 1)
    bilstm_train_bwd_rec_kernel(const LstmBwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, L = p.L, N = p.N, C = p.C, G = 4 * H;
  const int TX = H / 4;
  const int Bt = (blockDim.x / TX) * R;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int j0 = 4 * tx;
  const int rr0 = ty * R;
  const int row0 = blockIdx.x * Bt;

  float* da_s = smem;  // [4H][Bt] da of this step
  const T* dout = static_cast<const T*>(p.dout);
  const T* cseq = static_cast<const T*>(p.cseq);
  const T* gates = static_cast<const T*>(p.gates);

  for (int d = 0; d < 2; ++d) {
    const T* WihT = static_cast<const T*>(p.wihT) + (size_t)d * G * C;
    const T* WhhT = static_cast<const T*>(p.whhT) + (size_t)d * G * H;
    float* da = p.da + (size_t)d * L * N * G;
    float dh[R][4], dc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) dh[r][j] = dc[r][j] = 0.0f;

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
        float ig[4] = {0, 0, 0, 0}, fg[4] = {0, 0, 0, 0};
        float gg[4] = {0, 0, 0, 0}, og[4] = {0, 0, 0, 0};
        float cv[4] = {0, 0, 0, 0}, cp[4] = {0, 0, 0, 0};
        float dov[4] = {0, 0, 0, 0};
        if (row < N) {
          const T* g = gates + (((size_t)d * L + t) * N + row) * G + j0;
          Op<T>::load4(g, ig);
          Op<T>::load4(g + H, fg);
          Op<T>::load4(g + 2 * H, gg);
          Op<T>::load4(g + 3 * H, og);
          Op<T>::load4(cseq + (((size_t)d * L + t) * N + row) * H + j0, cv);
          if (has_prev)
            Op<T>::load4(cseq + (((size_t)d * L + tp) * N + row) * H + j0, cp);
          Op<T>::load4(dout + ((size_t)t * N + row) * 2 * H + d * H + j0, dov);
        }
        float vi[4], vf[4], vg[4], vo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float tc = tanhf(cv[j]);
          const float dt = dov[j] + dh[r][j];
          const float dcv = dt * og[j] * (1.0f - tc * tc) + dc[r][j];
          vi[j] = dcv * gg[j] * ig[j] * (1.0f - ig[j]);
          vf[j] = dcv * cp[j] * fg[j] * (1.0f - fg[j]);
          vg[j] = dcv * ig[j] * (1.0f - gg[j] * gg[j]);
          vo[j] = dt * tc * og[j] * (1.0f - og[j]);
          dc[r][j] = dcv * fg[j];
          da_s[(j0 + j) * Bt + rr] = vi[j];
          da_s[(H + j0 + j) * Bt + rr] = vf[j];
          da_s[(2 * H + j0 + j) * Bt + rr] = vg[j];
          da_s[(3 * H + j0 + j) * Bt + rr] = vo[j];
        }
        if (row < N) {
          const size_t o = ((size_t)t * N + row) * G + j0;
          Op<float>::store4(da + o, vi);
          Op<float>::store4(da + o + H, vf);
          Op<float>::store4(da + o + 2 * H, vg);
          Op<float>::store4(da + o + 3 * H, vo);
        }
      }
      __syncthreads();

      // 2) dh = da W_hh^T (contraction over 4H; no carry term, unlike the GRU)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) dh[r][j] = 0.0f;
      rec_hidden_product<T, R>(WhhT, G, H, da_s, Bt, rr0, j0, dh);

      // 3) dx (+)= da W_ih^T
      rec_input_product<T, R, CW>(WihT, G, C, da_s, Bt, row0, N,
                                  p.dx + (size_t)t * N * C, d == 1);
      __syncthreads();
    }
  }
}

template <typename T, int R>
static int lstm_fwd_typed(const LstmFwdParams& p, int block_rows_y,
                          cudaStream_t s) {
  const int threads = (p.H / 4) * block_rows_y;
  const int Bt = block_rows_y * R;
  const size_t smem = (size_t)(3 * p.H + p.C) * Bt * sizeof(float);
  const int e = set_smem((const void*)bilstm_train_fwd_kernel<T, R>, smem);
  if (e) return e;
  bilstm_train_fwd_kernel<T, R><<<(p.N + Bt - 1) / Bt, threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int R, int CW>
static int lstm_rec_typed(const LstmBwdParams& p, int block_rows_y,
                          cudaStream_t s) {
  const int threads = (p.H / 4) * block_rows_y;
  const int Bt = block_rows_y * R;
  const size_t smem = (size_t)4 * p.H * Bt * sizeof(float);
  const int e =
      set_smem((const void*)bilstm_train_bwd_rec_kernel<T, R, CW>, smem);
  if (e) return e;
  bilstm_train_bwd_rec_kernel<T, R, CW>
      <<<(p.N + Bt - 1) / Bt, threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int R>
static int lstm_rec_cw(const LstmBwdParams& p, int block_rows_y,
                       cudaStream_t s) {
  if (p.C % 4 == 0) return lstm_rec_typed<T, R, 4>(p, block_rows_y, s);
  return lstm_rec_typed<T, R, 1>(p, block_rows_y, s);
}

template <typename T>
static int lstm_fwd_rows(const LstmFwdParams& p, int R, int block_rows_y,
                         cudaStream_t s) {
  if (R == 8) return lstm_fwd_typed<T, 8>(p, block_rows_y, s);
  if (R == 4) return lstm_fwd_typed<T, 4>(p, block_rows_y, s);
  if (R == 2) return lstm_fwd_typed<T, 2>(p, block_rows_y, s);
  if (R == 1) return lstm_fwd_typed<T, 1>(p, block_rows_y, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int lstm_bwd_typed(const LstmBwdParams& p, const void* x,
                          const void* out, float* grads, float* part, int S,
                          int R, int block_rows_y, cudaStream_t s) {
  int e = (int)cudaErrorInvalidValue;
  if (R == 8) e = lstm_rec_cw<T, 8>(p, block_rows_y, s);
  if (R == 4) e = lstm_rec_cw<T, 4>(p, block_rows_y, s);
  if (R == 2) e = lstm_rec_cw<T, 2>(p, block_rows_y, s);
  if (R == 1) e = lstm_rec_cw<T, 1>(p, block_rows_y, s);
  if (e) return e;
  return wgrad_run<T>(x, out, p.da, p.da, p.L, p.N, p.C, p.H, 4 * p.H, S,
                      true, grads, part, s);
}

extern "C" {

// K6 forward. dtype: 0 = float32, 1 = bfloat16 (operands and stored
// outputs). rows_per_thread (R) in {1, 2, 4, 8}; block_rows_y (TY) threads
// along the rows, H / 4 along the hidden units, (H / 4) * TY <= 256.
// Returns 0 or a cudaError_t value.
int bilstm_train_fwd_launch(int dtype, const void* x, const void* wih,
                            const void* bih, const void* whh, const void* bhh,
                            void* out, void* cseq, void* gates, int L, int N,
                            int C, int H, int rows_per_thread,
                            int block_rows_y, void* stream) {
  if (!shape_ok(L, N, C, H, block_rows_y)) return (int)cudaErrorInvalidValue;
  LstmFwdParams p;
  p.x = x;
  p.wih = wih;
  p.bih = static_cast<const float*>(bih);
  p.whh = whh;
  p.bhh = static_cast<const float*>(bhh);
  p.out = out;
  p.cseq = cseq;
  p.gates = gates;
  p.L = L;
  p.N = N;
  p.C = C;
  p.H = H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lstm_fwd_rows<float>(p, rows_per_thread, block_rows_y, s);
  if (dtype == 1)
    return lstm_fwd_rows<__nv_bfloat16>(p, rows_per_thread, block_rows_y, s);
  return (int)cudaErrorInvalidValue;
}

// K6 backward: phase (a) then phase (b) on the same stream. x (L, N, C) and
// out (L, N, 2H) are the forward's input and output (h_prev for dW_hh); da is
// (2, L, N, 4H) f32 scratch; grads is [dW_ih (2, C, 4H) | dW_hh (2, H, 4H) |
// db (2, 4H)] f32 (db = db_ih = db_hh) and part (S, the same size) f32
// scratch for the S row slices of phase (b) (unused when S = 1). dx and
// grads are written in full. Same tiling arguments as the forward.
int bilstm_train_bwd_launch(int dtype, const void* dout, const void* x,
                            const void* out, const void* cseq,
                            const void* gates, const void* wihT,
                            const void* whhT, void* dx, void* da, void* grads,
                            void* part, int slices, int L, int N, int C, int H,
                            int rows_per_thread, int block_rows_y,
                            void* stream) {
  if (!shape_ok(L, N, C, H, block_rows_y) || slices < 1 ||
      (long long)L * N >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  LstmBwdParams p;
  p.dout = dout;
  p.cseq = cseq;
  p.gates = gates;
  p.wihT = wihT;
  p.whhT = whhT;
  p.dx = static_cast<float*>(dx);
  p.da = static_cast<float*>(da);
  p.L = L;
  p.N = N;
  p.C = C;
  p.H = H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* g = static_cast<float*>(grads);
  float* pt = static_cast<float*>(part);
  if (dtype == 0)
    return lstm_bwd_typed<float>(p, x, out, g, pt, slices, rows_per_thread,
                                 block_rows_y, s);
  if (dtype == 1)
    return lstm_bwd_typed<__nv_bfloat16>(p, x, out, g, pt, slices,
                                         rows_per_thread, block_rows_y, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
