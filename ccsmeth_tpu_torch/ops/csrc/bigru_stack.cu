// Whole-network bidirectional RNN inference (GRU or LSTM cell): every layer,
// both directions and all L timesteps of one batch tile in ONE launch, zero
// h0 (and c0). The same kernel on one layer, the directions in separate
// blocks, is kernel K2 (bigru_layer_launch at the end of this file).
//
// Replaces: ccsmeth_tpu/ops/bigru_pallas.py::_make_stack_kernel
//   (dir_batched=False), GRU cell (:232) and LSTM cell (:238-245), launched
//   there by _fused_stack_call. The TPU layouts (n_chains sub-tiles,
//   dir_batched) are MXU scheduling choices and are not carried over; the
//   math is.
//
// Bound on an H100 SXM: the attbigru2s stack (NL=3, H=256, L=21, C=11) does
//   232.7 MFLOP of matrix work per CpG site (bench.py:53-72), about 116 MFLOP
//   per strand row, against ~60 bytes of input and ~21 KB of output per row;
//   the attbilstm2s stack 4/3 of that (155 MFLOP per row). That is far above
//   the card's ~295 FLOP/byte ridge, so the stack is compute-bound: at
//   989 TFLOP/s bf16 dense (tensor cores) the least time is 0.24 us per site
//   (GRU), 0.31 us (LSTM).
//
// What this design does about that: nothing. It is the simple, correct
//   version: FP32 FMAs on the CUDA cores (67 TFLOP/s peak), no tensor cores,
//   weights streamed from L2 (the GRU network is ~2.77M parameters, 11 MB in
//   fp32, the LSTM one ~3.7M, 15 MB: both stay resident in the 50 MB L2).
//   It is what sets its pace: each block reads all of W_ih and W_hh from L2
//   at every step for its 8 rows, and the two directions run in turn.
//   It is the `l2` design of ops/bigru.py's k1_plan: it serves the shapes
//   (either dtype; exact f32 arithmetic, no TF32) that the two faster designs
//   refuse, birnn_tc.cu (bf16, tensor cores) and birnn_simt.cu (fp32 and
//   the bf16 shapes tc refuses), e.g. H = 20, 48, 80, 512. K2's l2 design is
//   this kernel on one layer (ONE_DIR, below).
//
// Design:
//   - one block owns Bt = TY * R batch rows and runs all layers and both
//     directions for them (directions one after the other), so no host round
//     trip happens between layers;
//   - thread (tx, ty) owns hidden units j0 = 4*tx .. j0+3 of rows
//     ty*R .. ty*R+R-1 and keeps, for each, the four gate sums it needs.
//     GRU: r and z (input and recurrent parts summed), the input part of n
//     and the recurrent part of n (b_hn stays inside the reset product, as in
//     torch). LSTM: i, f, g and o, input and recurrent parts summed, with
//     b_ih + b_hh folded in;
//   - per timestep the input projection x_t @ W_ih is computed in the same
//     loop as h @ W_hh: the TPU kernel also projects inside its own body;
//   - h (f32, double-buffered) and the staged x_t tile live in shared memory,
//     k-major ([k][row]) so a thread reads its R rows with vector loads. The
//     LSTM's c (f32) lives in shared memory too, [H][Bt], outside the
//     registers that the 16 R gate sums already crowd; only the thread that
//     owns (row, unit) ever reads or writes it;
//   - the next layer's input (L, N, 2H) goes to a global ping-pong buffer in
//     the operand type (the wrapper allocates it); the last layer writes the
//     output tensor itself; __syncthreads() orders the block's own writes and
//     reads, and a block only ever touches its own rows;
//   - gate math is f32 whatever the operand type; with bf16 operands the
//     weights, the layer inputs and the h operand of the recurrent product are
//     bf16 values, products are exact in f32 and sums accumulate in f32; c
//     stays f32;
//   - the ragged last tile is masked here: rows >= N read zeros and store
//     nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (ops/bigru.py builds it at first use). The C entry point
//   returns cudaGetLastError() after the launch.

#include "rnn_common.cuh"
#include "entry_device.cuh"

#define BIGRU_MAX_LAYERS 8

struct StackParams {
  const void* x;      // (L, N, C0) operand type
  void* out;          // (L, N, 2H) operand type: the last layer's output
  void* scratch;      // (L, N, 2H) operand type: ping-pong buffer (NL > 1)
  float* hn;          // (2*NL, N, H) f32, torch order [l0 fwd, l0 bwd, ...]
  const void* wih[BIGRU_MAX_LAYERS];   // (2, Cin, G) operand type
  const float* bih[BIGRU_MAX_LAYERS];  // (2, G) f32
  const void* whh[BIGRU_MAX_LAYERS];   // (2, H, G) operand type
  const float* bhh[BIGRU_MAX_LAYERS];  // (2, G) f32, G = 3H or 4H
  int NL, L, N, C0, H;
};

// ONE_DIR (kernel K2): NL = 1 and block row blockIdx.y runs direction
// blockIdx.y alone; K1's instantiations keep both directions in one block.
template <typename T, int R, bool LSTM, bool ONE_DIR>
__global__ void __launch_bounds__(BIGRU_THREADS, 1)
    bigru_stack_kernel(const StackParams p) {
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, L = p.L, N = p.N, G = (LSTM ? 4 : 3) * H;
  const int TX = H / 4;
  const int TY = blockDim.x / TX;
  const int Bt = TY * R;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int j0 = 4 * tx;
  const int rr0 = ty * R;  // this thread's first row within the tile
  const int row0 = blockIdx.x * Bt;
  const int cmax = p.C0 > 2 * H ? p.C0 : 2 * H;

  float* hs_a = smem;                // [H][Bt]
  float* hs_b = smem + H * Bt;       // [H][Bt]
  float* xs = smem + 2 * H * Bt;     // [Cin][Bt]
  float* cs = xs + cmax * Bt;        // [H][Bt], LSTM only

  for (int l = 0; l < p.NL; ++l) {
    const int Cin = (l == 0) ? p.C0 : 2 * H;
    // layer l writes out when NL-1-l is even, else scratch; layer l+1 reads it
    const T* xin =
        (l == 0) ? static_cast<const T*>(p.x)
                 : static_cast<const T*>(((p.NL - l) % 2 == 0) ? p.out
                                                                : p.scratch);
    T* xout = static_cast<T*>(((p.NL - 1 - l) % 2 == 0) ? p.out : p.scratch);
    const int d_lo = ONE_DIR ? (int)blockIdx.y : 0;
    const int d_hi = ONE_DIR ? d_lo + 1 : 2;
    for (int d = d_lo; d < d_hi; ++d) {
      const T* Wih = static_cast<const T*>(p.wih[l]) + (size_t)d * Cin * G;
      const T* Whh = static_cast<const T*>(p.whh[l]) + (size_t)d * H * G;
      const float* bi = p.bih[l] + d * G;
      const float* bh = p.bhh[l] + d * G;
      // GRU: r, z, input n, recurrent n; LSTM: i, f, g, o (b_ih + b_hh)
      float b0[4], b1[4], b2[4], b3[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b0[j] = bi[j0 + j] + bh[j0 + j];
        b1[j] = bi[H + j0 + j] + bh[H + j0 + j];
        if constexpr (LSTM) {
          b2[j] = bi[2 * H + j0 + j] + bh[2 * H + j0 + j];
          b3[j] = bi[3 * H + j0 + j] + bh[3 * H + j0 + j];
        } else {
          b2[j] = bi[2 * H + j0 + j];
          b3[j] = bh[2 * H + j0 + j];
        }
      }
      float* hc = hs_a;
      float* hnx = hs_b;
      for (int i = tid; i < H * Bt; i += blockDim.x) {
        hc[i] = 0.0f;
        if constexpr (LSTM) cs[i] = 0.0f;
      }

      for (int s = 0; s < L; ++s) {
        const int t = (d == 0) ? s : L - 1 - s;
        // stage x_t of this tile's rows as f32, k-major; ragged rows read 0
        const T* xt = xin + (size_t)t * N * Cin;
        for (int i = tid; i < Bt * Cin; i += blockDim.x) {
          const int r = i / Cin, c = i - r * Cin;
          const int row = row0 + r;
          xs[c * Bt + r] =
              (row < N) ? Op<T>::to_f(xt[(size_t)row * Cin + c]) : 0.0f;
        }
        __syncthreads();

        float a0[R][4], a1[R][4], a2[R][4], a3[R][4];
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a0[r][j] = b0[j];
            a1[r][j] = b1[j];
            a2[r][j] = b2[j];
            a3[r][j] = b3[j];
          }
        }
        if constexpr (LSTM)
          lstm_gate_sums<T, R>(xs, Cin, hc, H, Bt, rr0, j0, Wih, Whh, a0, a1,
                               a2, a3);
        else
          gru_gate_sums<T, R>(xs, Cin, hc, H, Bt, rr0, j0, Wih, Whh, a0, a1,
                              a2, a3);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = row0 + rr0 + r;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int sidx = (j0 + j) * Bt + rr0 + r;
            float hnew;
            if constexpr (LSTM) {
              // i, f, g, o -> c' = f c + i g, h' = o tanh(c') (f32)
              float c = cs[sidx];
              hnew = lstm_update(a0[r][j], a1[r][j], a2[r][j], a3[r][j], c);
              cs[sidx] = c;
            } else {
              // r, z, n = tanh(xn + r * hn), h' = (1 - z) n + z h (f32)
              const float rg = sigmoid_f(a0[r][j]);
              const float zg = sigmoid_f(a1[r][j]);
              const float ng = tanhf(a2[r][j] + rg * a3[r][j]);
              hnew = (1.0f - zg) * ng + zg * hc[sidx];
            }
            hnx[sidx] = hnew;
            if (row < N) {
              xout[((size_t)t * N + row) * 2 * H + d * H + j0 + j] =
                  Op<T>::from_f(hnew);
              if (!ONE_DIR && s == L - 1)
                p.hn[((size_t)(2 * l + d) * N + row) * H + j0 + j] = hnew;
            }
          }
        }
        __syncthreads();
        float* tmp = hc;
        hc = hnx;
        hnx = tmp;
      }
    }
  }
}

template <typename T, int R, bool LSTM, bool ONE_DIR>
static int launch_typed(const StackParams& p, int block_rows_y,
                        cudaStream_t stream) {
  const int TX = p.H / 4;
  const int threads = TX * block_rows_y;
  const int Bt = block_rows_y * R;
  const int cmax = p.C0 > 2 * p.H ? p.C0 : 2 * p.H;
  const size_t smem =
      (size_t)((LSTM ? 3 : 2) * p.H + cmax) * Bt * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bigru_stack_kernel<T, R, LSTM, ONE_DIR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((p.N + Bt - 1) / Bt, ONE_DIR ? 2 : 1);
  bigru_stack_kernel<T, R, LSTM, ONE_DIR><<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, bool LSTM, bool ONE_DIR>
static int launch_rows(const StackParams& p, int R, int block_rows_y,
                       cudaStream_t s) {
  if (R == 8) return launch_typed<T, 8, LSTM, ONE_DIR>(p, block_rows_y, s);
  if (R == 4) return launch_typed<T, 4, LSTM, ONE_DIR>(p, block_rows_y, s);
  if (R == 2) return launch_typed<T, 2, LSTM, ONE_DIR>(p, block_rows_y, s);
  if (R == 1) return launch_typed<T, 1, LSTM, ONE_DIR>(p, block_rows_y, s);
  return (int)cudaErrorInvalidValue;
}

template <bool ONE_DIR>
static int launch(const StackParams& p, int cell, int dtype, int R, int ty,
                  cudaStream_t s) {
  if (dtype == 0)
    return cell ? launch_rows<float, true, ONE_DIR>(p, R, ty, s)
                : launch_rows<float, false, ONE_DIR>(p, R, ty, s);
  if (dtype == 1)
    return cell ? launch_rows<__nv_bfloat16, true, ONE_DIR>(p, R, ty, s)
                : launch_rows<__nv_bfloat16, false, ONE_DIR>(p, R, ty, s);
  return (int)cudaErrorInvalidValue;
}

static bool bad_shape(int cell, int L, int N, int C0, int H, int block_rows_y) {
  return H < 4 || H % 4 != 0 || L < 1 || N < 1 || C0 < 1 || block_rows_y < 1 ||
         (H / 4) * block_rows_y > BIGRU_THREADS || (cell != 0 && cell != 1);
}

extern "C" {

// cell: 0 = GRU (weights (.., 3H)), 1 = LSTM (weights (.., 4H)).
// dtype: 0 = float32, 1 = bfloat16. wih/bih/whh/bhh: host arrays of NL device
// pointers. rows_per_thread (R) in {1, 2, 4, 8}; block_rows_y (TY) threads
// along the batch, TX = H / 4 along the hidden units, TX * TY <= 256.
// Returns 0 or a cudaError_t value.
int bigru_stack_launch(int cell, int dtype, const void* x, void* out,
                       void* scratch, void* hn, const uint64_t* wih,
                       const uint64_t* bih, const uint64_t* whh,
                       const uint64_t* bhh, int NL, int L, int N, int C0,
                       int H, int rows_per_thread, int block_rows_y,
                       void* stream, int device) {
  USE_DEVICE(device);
  if (NL < 1 || NL > BIGRU_MAX_LAYERS ||
      bad_shape(cell, L, N, C0, H, block_rows_y))
    return (int)cudaErrorInvalidValue;
  StackParams p;
  p.x = x;
  p.out = out;
  p.scratch = scratch;
  p.hn = static_cast<float*>(hn);
  for (int l = 0; l < NL; ++l) {
    p.wih[l] = reinterpret_cast<const void*>(wih[l]);
    p.bih[l] = reinterpret_cast<const float*>(bih[l]);
    p.whh[l] = reinterpret_cast<const void*>(whh[l]);
    p.bhh[l] = reinterpret_cast<const float*>(bhh[l]);
  }
  p.NL = NL;
  p.L = L;
  p.N = N;
  p.C0 = C0;
  p.H = H;
  return launch<false>(p, cell, dtype, rows_per_thread, block_rows_y,
                       static_cast<cudaStream_t>(stream));
}

// Kernel K2 in the l2 design: ONE bidirectional layer, zero h0 (and c0).
// Replaces ccsmeth_tpu/ops/bigru_pallas.py::_fused_kernel (GRU, :87) and
// ::_fused_lstm_kernel (LSTM, :36), launched there by _fused_layer_call once
// per layer. It is the kernel above with NL = 1 on a grid of (row tiles, 2)
// (template argument ONE_DIR): with no next layer waiting for both
// directions of a row, the two directions run in separate blocks, twice the
// blocks of a K1 launch. out (L, N, 2H) holds both directions in time order
// (the TPU kernel stores the backward one reversed and the caller flips it
// back: layout only); no h_n is written, the caller rebuilds it from out as
// the TPU entry does.
int bigru_layer_launch(int cell, int dtype, const void* x, void* out,
                       const void* wih, const void* bih, const void* whh,
                       const void* bhh, int L, int N, int C, int H,
                       int rows_per_thread, int block_rows_y, void* stream, int device) {
  USE_DEVICE(device);
  if (bad_shape(cell, L, N, C, H, block_rows_y))
    return (int)cudaErrorInvalidValue;
  StackParams p;
  p.x = x;
  p.out = out;
  p.scratch = out;
  p.hn = nullptr;  // not written with ONE_DIR
  p.wih[0] = wih;
  p.bih[0] = static_cast<const float*>(bih);
  p.whh[0] = whh;
  p.bhh[0] = static_cast<const float*>(bhh);
  p.NL = 1;
  p.L = L;
  p.N = N;
  p.C0 = C;
  p.H = H;
  return launch<true>(p, cell, dtype, rows_per_thread, block_rows_y,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
