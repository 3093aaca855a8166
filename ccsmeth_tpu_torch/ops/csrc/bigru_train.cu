// Bidirectional GRU layer for training: K4, the forward that keeps the gate
// residuals, and K5, its backward. One layer per call (dropout sits between
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
//   35.3 and 101.5 GFLOP. Per row this is far above the card's ridge, so both
//   are compute-bound: at the 67 TFLOP/s fp32 CUDA-core peak 0.26 / 0.76 ms
//   for K4 and 0.53 / 1.51 ms for K5; at the 989 TFLOP/s bf16 tensor-core
//   peak a fifteenth of that. What sets the pace beside the FLOPs: the serial
//   chain of L steps a direction, each a product of a row tile by W_hh, an
//   exchange across the CTAs that hold W_hh and a barrier.
//
// The design, the same in both routes (ops/bigru_vjp.py::k45_plan picks the
// route: `tc` for bf16, `simt` for fp32 and the bf16 shapes tc refuses), as
// the TPU kernel's own math splits it. The recurrences are the templates of
// rnn_train_rec.cuh, which K6 (bilstm_train.cu) instantiates for the LSTM;
// the products are rnn_train_gemm.cuh's, and the C entries below that run
// them take the gate count, so K6 runs its products through them too:
//   K4 (a) the input projection, one product a layer outside the time loop:
//          xg (2, L N, 3H) f32 = x W_ih[d] + b_ih[d] + (b_hr, b_hz)
//          (simt: rnn_train_gemm.cuh, k4_proj_launch; tc: K1-tc's projection
//          kernel as it stands, birnn_tc.cu::rnn_proj_kernel, the same
//          function: a 3-stage cp.async ring, 2 CTAs an SM);
//      (b) the recurrence, both directions at once, carrying only h W_hh. A
//          cluster of CN CTAs runs one (row tile, direction); CTA c owns the
//          hidden units [c U, (c+1) U) of every gate and keeps its slice of
//          W_hh in shared memory for all L steps. Per step it writes out and
//          the residuals r, z, n, hg_n = h W_hn + b_hn from the registers
//          that hold them, and sends its new h to every CTA of the cluster
//          (distributed shared memory: simt by bulk copies completing on the
//          receivers' mbarriers, no cluster barrier in the time loop; tc by
//          remote stores, one cluster barrier a step).
//   K5 (a) the recurrence that carries only dh, both directions at once.
//          Per step: dt = dout + dh; the gate gradients dr, dz, dn from the
//          residuals and h_prev (the stored output one step earlier in the
//          direction's own time); dxg = [dr, dz, dn] and dhg = [dr, dz, dn r]
//          to device memory (simt: f32 scratch, whose column sums the
//          weight-gradient launch takes; tc: bf16 copies, the operands TMA
//          feeds to (b) and (c), and each CTA's row tile sums its f32 values
//          for the bias gradients, in a fixed order, into partials that the
//          sum launch of (c) adds in tile order: no f32 scratch and no
//          column-sum pass, so a tc backward is 4 launches); then
//          dh = dt z + op(dhg) W_hh^T. The contraction runs over 3H, three
//          times h's width, so the operand is not broadcast: CTA c multiplies
//          its own 3U gate columns by its W_hh rows into a partial dh for all
//          H units and sends each CTA the U columns it owns; the owner adds
//          the CN partials in rank order (a reduce-scatter, deterministic).
//          Arithmetic at H = 256, bf16: broadcasting dhg to a 64-row tile
//          needs 2 x 64 x 768 x 2 = 196 KB beside a 96 KB W_hh slice, over
//          the 227 KB; the reduce-scatter needs 2 x R x H f32 partials
//          (64 KB at R = 32) beside 100 KB of W_hh and 13 KB of dhg;
//      (b) dx = [op(DXG_0) | op(DXG_1)] [W_ih,0^T ; W_ih,1^T], one product
//          after the recurrence (k5_dx_launch);
//      (c) dW_ih[d] = X^T op(DXG[d]), dW_hh[d] = H_prev^T op(DHG[d]) over
//          the L N rows, in S fixed row slices (simt: with the column sums
//          of DXG and DHG, db_ih and db_hh, beside them); the slices (and
//          tc's bias partials, in tile order) are added in order
//          (k5_wgrad_launch, k5_sum_launch). No atomics: reruns are
//          bit-equal.
//      In simt on f32 (b) and (c) are rnn_train_gemm.cuh's f32_tma_kernel:
//          128 x 128 tiles of 128 threads (dx: 112 or 128 rows, whichever
//          fills its waves better, by 16 .. 128 columns by C), 8 x 16
//          outputs a thread, a TMA ring on mbarriers, two CTAs an SM. Their
//          bound at C = 512 is the FMA rate: dx 33.8 GFLOP (K6: 45.1),
//          0.50 (0.67) ms at 67 TFLOP/s; the weight gradients 50.7 (67.6)
//          GFLOP, 0.76 (1.01) ms; at C = 11 dx is bound by dxg's bytes
//          (132 (176) MB, 0.04 (0.05) ms) and the weight gradients by
//          dW_hh's 16.9 (22.5) GFLOP, 0.25 (0.34) ms.
//   Routes:
//   - tc (bf16): K5's products (b) and (c) on wgmma fed by TMA
//     (rnn_train_gemm.cuh's wgemm_kernel, wgmma_tile.cuh's pieces: a
//     three-stage ring, one producer warp, two consumer warpgroups, two
//     CTAs an SM; X's rows at C % 8 != 0, which TMA cannot address, by the
//     producer warp's plain loads). K4's projection is K1-tc's mma.sync
//     kernel (its bits pinned). K4 (b) is an
//     mma.sync cluster recurrence with the residual stores: 64 rows a
//     tile, U = 64 (CN = 4 at H = 256), W_hh gate-interleaved so a thread's
//     accumulators hold every gate of its units; 168,960 bytes a CTA. K5 (a):
//     32 rows a tile, U = 64; W_hh staged [unit j][own gate column k] and
//     dhg [row][k], both k-contiguous bf16, each warp one 16-row tile by
//     H/4 units; 188,928 bytes a CTA at H = 256.
//   - simt (exact f32 FMAs on the CUDA cores, no TF32, accurate expf and
//     tanhf): U = 32, clusters of 8 at H = 256. K4 (b): rnn_train_rec.cuh's
//     simt forward, 72 rows a tile in two warp groups that take turns at
//     the product (15 tiles a direction at 1,024 rows: two full waves), a
//     thread 9 rows x 1 unit x 3 gates; W_hh slice [k][gate][u] f32 (96 KB)
//     and h [k][row] f32 (72 KB): 172,064 bytes a CTA, with no cluster
//     barrier in the time loop. K5 (a): rnn_train_rec.cuh's simt backward, 72 rows a
//     tile in two row halves, a thread 9 rows x 8 units of the partial;
//     W_hh slice [k][j] f32 (96 KB), the partials received (72 KB) and a
//     half's dhg operand (16 KB): 188,064 bytes, with no cluster barrier in
//     the time loop. The products on f32 operands: K4 (a), K5 (b) and (c)
//     f32_tma_kernel; on bf16 (H = 16) gemm_simt_kernel.
//   Rows >= N (the ragged last tile) read zeros, store nothing and add
//   nothing to dW.
//
// Numerics: gate math and every sum in f32. With bf16 operands, x, the
//   weights, dout, out and the residuals are bf16 values (as on the TPU);
//   the h operand and dxg and dhg are rounded to bf16 (nearest even) as
//   product operands, the bias sums take them unrounded; dx, dW and db are
//   f32. The tc recurrence's gate functions use __expf
//   (within ~1e-6, far inside a bf16 ulp), as K1-tc's.
//
// Bound of the tc backward's products at the main path's shapes (C = 512):
//   dx 33.8 GFLOP, dW_ih 33.8, dW_hh 16.9 (K6: 45.1, 45.1, 22.5), 0.085 /
//   0.114 ms at 989 TFLOP/s; their operands (the bf16 gate gradients, X,
//   out, W_ih) are read from L2 or once from device memory, far below the
//   operations' time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (ops/bigru_vjp.py builds it at first use). Each C entry
//   point makes one CUDA launch and returns cudaGetLastError() after it.

#include "rnn_train_rec.cuh"
#include "entry_device.cuh"

extern "C" {

// design: 0 = simt, 1 = tc (bf16 only); dtype: 0 = float32, 1 = bfloat16
// (operands and stored outputs); ng: the gate count, 3 (GRU, K4/K5) or 4
// (LSTM, K6), G = ng H. Every entry makes one CUDA launch on the stream and
// returns 0 or a cudaError_t value.

// The projection of the simt design: xg (2, M, G) f32 = x (M, C) W_ih[d]
// (C, G) + b_ih[d] + b_hh[d] outside the GRU's reset product (the GRU's r and
// z columns, all of the LSTM's). (The tc design runs K1-tc's projection
// kernel, birnn_tc.cu's birnn_tc_proj_launch, for this.)
int k4_proj_launch(int dtype, const void* x, const void* wih, const void* bih,
                   const void* bhh, void* xg, int M, int C, int H, int ng, void* stream,
                   int device) {
  USE_DEVICE(device);
  if (M < 1 || C < 1 || H < 1 || (ng != 3 && ng != 4)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bi = static_cast<const float*>(bih);
  const float* bh = static_cast<const float*>(bhh);
  float* o = static_cast<float*>(xg);
  const int G = ng * H, nfold = ng == 3 ? 2 * H : G;
  if (dtype == 0) return rnn_proj<float>(x, wih, bi, bh, o, M, C, G, nfold, s);
  if (dtype == 1) return rnn_proj<bf16>(x, wih, bi, bh, o, M, C, G, nfold, s);
  return (int)cudaErrorInvalidValue;
}

// K4 (b): from xg (2, L N, 3H) f32 to out (L, N, 2H) and gates (2, L, N, 4H)
// in the store type; R rows a tile (tc: 64; simt: fwd_simt_rows(H), or at
// H = 256 one more row a thread), clusters of H / U CTAs.
int k4_rec_launch(int design, int dtype, const void* xg, const void* whh, const void* bhh,
                  void* out, void* gates, int L, int N, int H, int U, int R, void* stream,
                  int device) {
  USE_DEVICE(device);
  FwdRecParams rp;
  rp.xg = static_cast<const float*>(xg);
  rp.whh = whh;
  rp.bhh = static_cast<const float*>(bhh);
  rp.out = out;
  rp.gates = gates;
  rp.cseq = nullptr;
  rp.hn = nullptr;
  rp.L = L;
  rp.N = N;
  rp.H = H;
  return fwd_rec_run<false>(design, dtype, rp, U, R, static_cast<cudaStream_t>(stream));
}

// K5 (a): dxg and dhg (2, L N, 3H) from dout, out, gates and W_hh, f32
// (simt) or bf16 (tc, with the row tiles' bias-gradient partials in bpart,
// (tiles, 2, 2, 3H) f32); R rows a tile (tc: 32; simt: bwd_simt_rows(H)),
// clusters of H / U CTAs.
int k5_rec_launch(int design, int dtype, const void* dout, const void* out,
                  const void* gates, const void* whh, void* dxg, void* dhg, void* bpart,
                  int L, int N, int H, int U, int R, void* stream, int device) {
  USE_DEVICE(device);
  BwdRecParams kp;
  kp.dout = dout;
  kp.out = out;
  kp.gates = gates;
  kp.cseq = nullptr;
  kp.whh = whh;
  kp.dxg = dxg;
  kp.dhg = dhg;
  kp.bpart = static_cast<float*>(bpart);
  kp.L = L;
  kp.N = N;
  kp.H = H;
  kp.U = U;
  kp.R = R;
  return bwd_rec_run<false>(design, dtype, kp, static_cast<cudaStream_t>(stream));
}

// How many clusters of K4 (b)'s recurrence at design (0 = simt, 1 = tc),
// dtype (0 = float32, 1 = bfloat16), H and U the card holds at once, into
// *clusters, its shared memory a CTA into *smem_bytes and its rows a tile
// into *rows. Launches nothing. Returns 0 or a cudaError_t value.
int k4_rec_occupancy(int design, int dtype, int H, int U, int* clusters, int* smem_bytes,
                     int* rows, int device) {
  USE_DEVICE(device);
  return fwd_rec_occupancy<false>(design, dtype, H, U, clusters, smem_bytes, rows);
}

// How many clusters of K5 (a)'s recurrence at design (0 = simt, 1 = tc),
// dtype (0 = float32, 1 = bfloat16), H and U the card holds at once, into
// *clusters, its shared memory a CTA into *smem_bytes and its rows a tile
// into *rows. Launches nothing. Returns 0 or a cudaError_t value.
int k5_rec_occupancy(int design, int dtype, int H, int U, int* clusters, int* smem_bytes,
                     int* rows, int device) {
  USE_DEVICE(device);
  return bwd_rec_occupancy<false>(design, dtype, H, U, clusters, smem_bytes, rows);
}

// dx (M, C) f32 = sum_d op(dxg[d]) (M, G) W_ih[d]^T: simt with dxg f32
// (rnn_train_gemm.cuh's f32_tma_kernel on f32 W_ih, gemm_simt_kernel on
// bf16), tc with dxg bf16 (wgemm_kernel).
int k5_dx_launch(int design, int dtype, const void* dxg, const void* wih, void* dx, int M,
                 int C, int H, int ng, void* stream, int device) {
  USE_DEVICE(device);
  if (M < 1 || C < 1 || H < 1 || (ng != 3 && ng != 4) || (design == 1 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(dx);
  if (design == 1) {
    if (H % 8 != 0) return (int)cudaErrorInvalidValue;
    return wg_dx(dxg, wih, o, M, C, ng * H, s);
  }
  const float* g = static_cast<const float*>(dxg);
  if (dtype == 0) return rnn_dx<float>(g, wih, o, M, C, ng * H, s);
  if (dtype == 1) return rnn_dx<bf16>(g, wih, o, M, C, ng * H, s);
  return (int)cudaErrorInvalidValue;
}

// The weight gradients into part, over S fixed row slices (with S = 1, part
// is the result). simt (dxg and dhg f32): S slices of [dW_ih (2, C, G) |
// dW_hh (2, H, G) | db_ih (2, G) | db_hh (2, G)], the bias gradients the
// column sums of dxg and dhg; dhg == dxg (K6's da): one bias sum, no db_hh
// slot. tc (dxg and dhg the bf16 copies): S slices of [dW_ih | dW_hh] on
// wgmma; the bias gradients come from the recurrence's partials.
int k5_wgrad_launch(int design, int dtype, const void* x, const void* out, const void* dxg,
                    const void* dhg, void* part, int L, int N, int C, int H, int ng, int S,
                    void* stream, int device) {
  USE_DEVICE(device);
  if (L < 1 || N < 1 || C < 1 || H < 1 || S < 1 || (ng != 3 && ng != 4) ||
      (long long)L * N >= (1LL << 31) || (design == 1 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(part);
  const int G = ng * H;
  if (design == 1) {
    if (H % 8 != 0) return (int)cudaErrorInvalidValue;
    return wg_wgrad(x, out, dxg, dhg, o, L, N, C, H, G, S, s);
  }
  const float* a = static_cast<const float*>(dxg);
  const float* b = static_cast<const float*>(dhg);
  if (dtype == 0) return rnn_wgrad<float>(x, out, a, b, o, L, N, C, H, G, S, s);
  if (dtype == 1) return rnn_wgrad<bf16>(x, out, a, b, o, L, N, C, H, G, S, s);
  return (int)cudaErrorInvalidValue;
}

// The slices and tiles: grads[i] = sum over the S partials of element i, in
// slice order (T floats a slice; none when S == 1), and bgrads[j] = sum over
// the NT tile partials bpart[t Tb + j], in tile order (the tc design's bias
// gradients; Tb = 0 in simt).
int k5_sum_launch(const void* part, void* grads, long long T, int S, const void* bpart,
                  void* bgrads, long long Tb, int NT, void* stream, int device) {
  USE_DEVICE(device);
  if (T < 1 || S < 1 || Tb < 0 || (Tb > 0 && (bpart == nullptr || NT < 1)) ||
      (S < 2 && Tb == 0))
    return (int)cudaErrorInvalidValue;
  const long long n = (S > 1 ? T : 0) + Tb;
  const long long blocks = (n + GM_THREADS - 1) / GM_THREADS;
  gemm_sum_slices<<<(int)(blocks < 4096 ? blocks : 4096), GM_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(grads), T, S,
      static_cast<const float*>(bpart), static_cast<float*>(bgrads), Tb, NT);
  return (int)cudaGetLastError();
}

}  // extern "C"
