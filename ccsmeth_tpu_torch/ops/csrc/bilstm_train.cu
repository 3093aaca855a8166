// Bidirectional LSTM layer for training: K6, the forward that keeps the
// residuals and its backward. One layer per call (dropout sits between
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
//   peak 0.35 / 1.01 ms forward and 0.70 / 2.02 ms backward; at the 989
//   TFLOP/s bf16 tensor-core peak a fifteenth of that. What sets the pace
//   beside the FLOPs: the serial chain of L steps a direction, each a product
//   of a row tile by W_hh, an exchange across the CTAs that hold W_hh and a
//   barrier.
//
// The design is K4/K5's (bigru_train.cu) with four gates: the gate count is
// the only difference, and ops/bigru_vjp.py::k45_plan, the one shape rule of
// both layers, picks the route (`tc` for bf16, `simt` for fp32 and the bf16
// shapes tc refuses) and the geometry from it.
//   forward, two launches:
//     (a) the projection, one product a layer outside the time loop:
//         xg (2, L N, 4H) f32 = x W_ih[d] + b_ih[d] + b_hh[d] (the LSTM folds
//         all of b_hh); simt: rnn_train_gemm.cuh through bigru_train.cu's
//         k4_proj_launch; tc: K1-tc's projection kernel as it stands
//         (birnn_tc.cu, cell 1);
//     (b) the recurrence (k6_rec_launch): rnn_train_rec.cuh's forward
//         template for the LSTM. A cluster of H / U CTAs runs one (row tile,
//         direction), both directions at once; CTA c keeps its 4U columns of
//         W_hh (the i, f, g, o of its own U units) in shared memory for all
//         L steps, c stays f32 in the registers of its one owner, and the new
//         h goes to every CTA of the cluster once a step (simt: by bulk
//         copies onto the receivers' mbarriers, no cluster barrier in the
//         time loop). Per step: out, c and the gates in the store type.
//   backward, three or four launches (ops/bigru_vjp.py::bwd_cuda_launches):
//     (a) the recurrence over reversed time (k6_bwd_rec_launch), carrying dh
//         and dc: tc = tanh(c); dh_t = dout + dh; dc = dh_t o (1 - tc^2) + dc;
//         da = [dc g i(1-i), dc c_prev f(1-f), dc i (1-g^2), dh_t tc o(1-o)];
//         dc = dc f; dh = op(da) W_hh^T. dc is elementwise and stays with the
//         thread that owns its (row, unit) (simt: in its registers, where
//         the GRU keeps dt z; tc: in shared memory); dh is reduce-scattered
//         across the cluster in rank order.
//         c_prev is the stored c one step earlier in the direction's own time
//         (zero at its first step). One gate-gradient matrix da (2, L N, 4H),
//         where the GRU has two: f32 in simt, bf16 in tc (the products'
//         operands), with the row tiles' partial sums of the f32 da for the
//         bias gradient;
//     (b) dx = sum_d op(da[d]) W_ih[d]^T, one product reading W_ih in its own
//         layout (bigru_train.cu's k5_dx_launch, ng = 4; tc on wgmma);
//     (c) dW_ih[d] = X^T op(da[d]), dW_hh[d] = H_prev^T op(da[d]) and the
//         bias sum of da once (db_ih = db_hh), in fixed row slices added in
//         order (k5_wgrad_launch with dhg = dxg, tc on wgmma; k5_sum_launch,
//         which in tc also adds the bias partials in tile order). No
//         atomics: reruns are bit-equal.
//   Shared memory at H = 256: tc U = 64, clusters of 4: forward (4U + 2 x 64)
//   x (H + 8) x 2 = 202,752 bytes, backward 225,792; simt U = 32, clusters of
//   8: forward 72 rows a tile in two warp groups that take turns at the
//   product (the GRU's: two full waves at 1,024 rows), a thread 9 rows x 1
//   unit x 4 gates, W_hh slice 131,072 + h 73,728 + the barriers = 204,832
//   bytes; backward 72 rows a tile in two row halves,
//   W_hh slice 131,072 + the partials received 73,728 + a half's operand
//   21,120 + the barriers = 225,952 bytes (rnn_train_rec.cuh's simt
//   backward).
//
// Numerics: gate math and every sum in f32. With bf16 operands, x, the
//   weights, dout and the residuals (out, c, gates) are bf16 values (as on the
//   TPU); da is rounded to bf16 (nearest even) as the operand of the
//   products while the bias sum uses it unrounded; dx, dW and db are f32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (ops/bilstm_vjp.py builds it at first use). Each C entry
//   point makes one CUDA launch and returns cudaGetLastError() after it.

#include "rnn_train_rec.cuh"
#include "entry_device.cuh"

extern "C" {

// design: 0 = simt, 1 = tc (bf16 only); dtype: 0 = float32, 1 = bfloat16
// (operands and stored outputs). Clusters of H / U CTAs, R rows a tile (tc:
// 64; simt: fwd_simt_rows(H), or at H = 256 one more row a thread). Returns
// 0 or a cudaError_t value.

// K6 forward (b): from xg (2, L N, 4H) f32 and W_hh (2, H, 4H) to out
// (L, N, 2H), c (2, L, N, H) and gates (2, L, N, 4H) in the store type.
int k6_rec_launch(int design, int dtype, const void* xg, const void* whh, void* out,
                  void* cseq, void* gates, int L, int N, int H, int U, int R, void* stream,
                  int device) {
  USE_DEVICE(device);
  FwdRecParams rp;
  rp.xg = static_cast<const float*>(xg);
  rp.whh = whh;
  rp.bhh = nullptr;
  rp.out = out;
  rp.gates = gates;
  rp.cseq = cseq;
  rp.hn = nullptr;
  rp.L = L;
  rp.N = N;
  rp.H = H;
  return fwd_rec_run<true>(design, dtype, rp, U, R, static_cast<cudaStream_t>(stream));
}

// How many clusters of K6 forward (b)'s recurrence at design (0 = simt,
// 1 = tc), dtype (0 = float32, 1 = bfloat16), H and U the card holds at
// once, into *clusters, its shared memory a CTA into *smem_bytes and its rows
// a tile into *rows. Launches nothing. Returns 0 or a cudaError_t value.
int k6_rec_occupancy(int design, int dtype, int H, int U, int* clusters, int* smem_bytes,
                     int* rows, int device) {
  USE_DEVICE(device);
  return fwd_rec_occupancy<true>(design, dtype, H, U, clusters, smem_bytes, rows);
}

// K6 backward (a): da (2, L N, 4H) from dout, c, gates and W_hh, f32
// (simt) or bf16 (tc, with the row tiles' bias-gradient partials in bpart,
// (tiles, 1, 2, 4H) f32); R rows a tile (tc: 32; simt: bwd_simt_rows(H)).
int k6_bwd_rec_launch(int design, int dtype, const void* dout, const void* cseq,
                      const void* gates, const void* whh, void* da, void* bpart, int L, int N,
                      int H, int U, int R, void* stream, int device) {
  USE_DEVICE(device);
  BwdRecParams kp;
  kp.dout = dout;
  kp.out = nullptr;  // the LSTM reads c_prev, not h_prev
  kp.gates = gates;
  kp.cseq = cseq;
  kp.whh = whh;
  kp.dxg = da;
  kp.dhg = nullptr;
  kp.bpart = static_cast<float*>(bpart);
  kp.L = L;
  kp.N = N;
  kp.H = H;
  kp.U = U;
  kp.R = R;
  return bwd_rec_run<true>(design, dtype, kp, static_cast<cudaStream_t>(stream));
}

// How many clusters of K6 backward (a)'s recurrence at design (0 = simt, 1 = tc),
// dtype (0 = float32, 1 = bfloat16), H and U the card holds at once, into
// *clusters, its shared memory a CTA into *smem_bytes and its rows a tile
// into *rows. Launches nothing. Returns 0 or a cudaError_t value.
int k6_bwd_rec_occupancy(int design, int dtype, int H, int U, int* clusters, int* smem_bytes,
                         int* rows, int device) {
  USE_DEVICE(device);
  return bwd_rec_occupancy<true>(design, dtype, H, U, clusters, smem_bytes, rows);
}

}  // extern "C"
