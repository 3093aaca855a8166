// Kernels K1 and K2 in fp32 (the `simt` design): one bidirectional GRU or
// LSTM layer, zero h0 (and c0), as two launches that ops/bigru.py makes in
// order on the caller's stream, layer after layer for K1, once for K2:
//   (a) the input projection of all L steps, both directions: xg (2, L N, G)
//       f32 = X (L N, Cin) W_ih[d] + b_ih[d] + the b_hh[d] columns outside the
//       GRU's reset product (all of the LSTM's). This is bigru_train.cu's
//       k4_proj_launch as it stands (rnn_train_gemm.cuh's exact-f32 GEMM);
//   (b) the recurrence (birnn_simt_rec_launch below): rnn_train_rec.cuh's
//       simt forward, instantiated with INFER. It keeps no residuals and
//       writes each direction's last h (f32, the state, not a rounded
//       output) to h_n. A cluster of CN = H / U CTAs (U = min(H, 32)) runs
//       one (row tile, direction), both directions at once; CTA c keeps the
//       NG U columns of W_hh of its units in shared memory for all L steps,
//       the state stays f32 in the registers of the thread that owns its
//       (row, unit), and each new h goes to every CTA of the cluster once a
//       step (distributed shared memory, one cluster barrier).
//
// Replaces: ccsmeth_tpu/ops/bigru_pallas.py::_make_stack_kernel (K1: GRU
//   :232, LSTM :238-245, launched by _fused_stack_call :373) in fp32, layer by
//   layer, and ::_fused_kernel (:87) / ::_fused_lstm_kernel (:36) (K2,
//   launched by _fused_layer_call :143) in fp32. bf16 runs birnn_tc.cu (the
//   tensor-core design of the same two phases); bigru_stack.cu keeps the
//   shapes that neither design takes. ops/bigru.py::k1_plan is the shape rule.
//
// Bound on an H100 SXM: one layer at the models' shapes (H = 256, L = 21,
//   1024 rows) does 2 L N 2 (Cin + H) G FLOPs, 50.7 GFLOP (GRU, Cin = 512);
//   at the 67 TFLOP/s fp32 CUDA-core peak that is 0.76 ms, far above the
//   bytes' time, so the layer is compute-bound. What sets the design's pace
//   beside the FLOPs: the serial chain of L steps a direction, each a product
//   of a row tile by W_hh from shared memory, an exchange across the cluster
//   and a barrier; and the clusters that fit at once (8 CTAs of 196-229 KB).
//
// Numerics: exact f32 FMAs, no TF32, accurate expf and tanhf; in fp32 the
//   arithmetic and the out stores are those of K4's (GRU) and K6's (LSTM)
//   simt forward, so K1's out equals a chain of their forwards, and K2's
//   equals K1's, bit for bit. With bf16 operands (the bf16 shapes that
//   birnn_tc.cu refuses and this design takes) the weights, the layer inputs
//   and the h operand are bf16 values, as in the training forward.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (ops/bigru.py builds it at first use). The C entry point
//   makes one CUDA launch and returns cudaGetLastError() after it.

#include "rnn_train_rec.cuh"
#include "entry_device.cuh"

extern "C" {

// (b): from xg (2, L N, G) f32 to out (L, N, 2H) in the operand type and hn
// (2, N, H) f32. cell: 0 = GRU, 1 = LSTM; dtype: 0 = float32, 1 = bfloat16;
// clusters of H / U CTAs, R = 1024 UPT / U rows a tile. Returns 0 or a
// cudaError_t value.
int birnn_simt_rec_launch(int cell, int dtype, const void* xg, const void* whh,
                          const void* bhh, void* out, void* hn, int L, int N, int H, int U,
                          int R, void* stream, int device) {
  USE_DEVICE(device);
  FwdRecParams rp;
  rp.xg = static_cast<const float*>(xg);
  rp.whh = whh;
  rp.bhh = static_cast<const float*>(bhh);
  rp.out = out;
  rp.gates = nullptr;
  rp.cseq = nullptr;
  rp.hn = static_cast<float*>(hn);
  rp.L = L;
  rp.N = N;
  rp.H = H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cell == 0) return fwd_rec_run<false, true>(0, dtype, rp, U, R, s);
  if (cell == 1) return fwd_rec_run<true, true>(0, dtype, rp, U, R, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
