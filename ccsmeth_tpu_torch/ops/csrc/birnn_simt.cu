// Kernels K1 and K2 in fp32 (the `simt` design): one bidirectional GRU or
// LSTM layer, zero h0 (and c0), as two launches that ops/bigru.py makes in
// order on the caller's stream, layer after layer for K1, once for K2:
//   (a) the input projection of all L steps, both directions: xg (2, L N,
//       G) f32 = X (L N, Cin) W_ih[d] + b_ih[d] + the b_hh[d] columns outside
//       the GRU's reset product (all of the LSTM's). This is bigru_train.cu's
//       k4_proj_launch as it stands (rnn_train_gemm.cuh's exact-f32 GEMM);
//   (b) the recurrence (birnn_rec_kernel, birnn_simt_rec_launch), both
//       directions at once from xg. A cluster of CN = H / U CTAs runs one
//       (tile of R rows, direction); CTA c keeps the NG U columns of W_hh of
//       its units [c U, (c+1) U) in shared memory for all L steps, [k][gate]
//       [u], and h of the tile's R rows, [k][row], in NB buffers. A thread
//       owns 4 rows x 2 units of every gate and keeps their state f32 in
//       registers. A step: the product of the tile's h by the W slice, the
//       gate math, then the CTA's new h (its U units, one contiguous block
//       of the buffer) goes to every other CTA of the cluster by bulk
//       copies (cp.async.bulk) that complete on the receiver's mbarrier:
//       a dataflow with no cluster barrier in the time loop (NB = 1 adds a
//       per-step `empty` handshake before the copies). The next step's xg is
//       loaded while the copies fly. No residuals: each direction's last f32
//       h goes to h_n. ops/bigru.py::k1_plan picks (U, R, NB);
//       birnn_simt_rec_occupancy reports how many clusters of a geometry the
//       card holds at once.
//
// Replaces: ccsmeth_tpu/ops/bigru_pallas.py::_make_stack_kernel (K1: GRU
//   :232, LSTM :238-245, launched by _fused_stack_call :373) in fp32, layer by
//   layer, and ::_fused_kernel (:87) / ::_fused_lstm_kernel (:36) (K2,
//   launched by _fused_layer_call :143) in fp32. bf16 runs birnn_tc.cu (the
//   tensor-core design of the same two phases); the bf16 shapes that it
//   refuses and simt takes run (b) as rnn_train_rec.cuh's simt forward
//   instantiated with INFER (the training forward's dataflow recurrence,
//   its geometry ops/bigru_vjp.py::simt_plan's); bigru_stack.cu keeps the
//   shapes that neither design takes.
//
// Bound on an H100 SXM: one layer at the models' shapes (H = 256, L = 21,
//   1024 rows) does 2 L N 2 (Cin + H) G FLOPs, 50.7 GFLOP (GRU, Cin = 512);
//   at the 67 TFLOP/s fp32 CUDA-core peak that is 0.76 ms, far above the
//   bytes' time, so the layer is compute-bound. Beside the FLOPs the
//   recurrence's pace is set by its serial chain of L steps a direction, each
//   a product of a row tile by W_hh from shared memory, an exchange across
//   the cluster and its barriers, and by the clusters that fit at once.
//
// Numerics: exact f32 FMAs, no TF32, accurate expf and tanhf. Every
//   recurrent sum is taken by one thread over k ascending from 0.0f, and the
//   gate math is that of the training forward (rnn_train_rec.cuh), written
//   the same way. So K1's out and h_n equal a chain of K4's (GRU) or K6's
//   (LSTM) simt forwards, and K2's equal K1's, bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (ops/bigru.py builds it at first use). The launching C
//   entry point makes one CUDA launch and returns cudaGetLastError() after
//   it.

#include "rnn_train_rec.cuh"
#include "wgmma_tile.cuh"  // the mbarriers and bulk copies
#include "entry_device.cuh"

struct RecParams {
  const float* xg;   // (2, L N, G) f32 from the projection
  const float* whh;  // (2, H, G)
  const float* bhh;  // (2, G): the GRU reads b_hn = columns 2H..3H
  float* out;        // (L, N, 2H)
  float* hn;         // (2, N, H): each direction's last h
  int L, N, H;
};

// U units a CTA, R rows a tile, NB h buffers. Thread (rg, ug) owns rows 4 rg
// .. 4 rg + 3 and units 2 ug, 2 ug + 1 (local) of every gate: 4 NG 2 sums,
// for each k one 16-byte load of h and NG 8-byte loads of W ([k][gate][u] in
// shared memory), so the 8 lanes of a warp that share rg read 64
// neighbouring bytes of a W row, and the 4 groups of lanes one 16-byte piece
// of h each.
//
// The exchange is a dataflow, with no cluster barrier in the time loop.
// CTA c writes its units' new h, [c U, (c+1) U) x R rows, one contiguous
// block of its own h buffer, and one thread copies that block to the same
// place in each other CTA of the cluster (cp.async.bulk, completing on the
// receiver's `full` barrier, which its thread 0 armed with the bytes to
// come). A CTA starts a step when its `full` barrier says every block has
// arrived. With two buffers (NB = 2), each with its own `full` barrier, a
// block for step s + 1 never lands on h that a CTA still reads (its sender
// had to have every block of step s, the receiver's included, which the
// receiver sends only after its own product of step s - 1), and the blocks
// of step s + 2 count on a barrier whose phase for step s the receiver has
// passed (their senders needed its block of step s + 1). With one (NB = 1)
// each CTA tells every other, on that CTA's `empty` barrier, when it has
// read h for the step, and a sender waits for all of them before it copies.
template <bool LSTM, int U, int R, int NB>
__global__ void __launch_bounds__((R / 4) * (U / 2), 1) birnn_rec_kernel(const RecParams p) {
  constexpr int NG = LSTM ? 4 : 3;
  constexpr int UG = U / 2;   // unit groups
  constexpr int UW = UG / 8;  // warps along the units, 8 lanes each
  constexpr int THREADS = (R / 4) * UG;
  static_assert(UG % 8 == 0 && R % 16 == 0 && (NB == 1 || NB == 2), "thread layout");
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, G = NG * H, L = p.L, N = p.N;
  float* ws = smem;                       // [H][NG][U]: W_hh[k][gate H + u0 + u]
  float* hs = smem + (size_t)H * NG * U;  // [NB][H][R]: the h operand
  // full[b]: the blocks of h for buffer b have arrived; empty: (NB = 1) every
  // other CTA has read h
  uint64_t* bars = reinterpret_cast<uint64_t*>(hs + (size_t)NB * H * R);
  const uint32_t full_bar = smem_u32(bars), empty_bar = smem_u32(bars + 2);
  const uint32_t crank = cluster_ctarank(), cn = cluster_nctarank();
  const int d = blockIdx.y;
  const int row0 = (blockIdx.x / cn) * R;
  const int u0 = crank * U;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ug = (warp % UW) * 8 + (lane & 7);
  const int rg = (warp / UW) * 4 + (lane >> 3);
  const int unit = u0 + 2 * ug;  // this thread's first unit (global)
  const uint32_t block_bytes = U * R * 4;  // one CTA's units of h

  const float* W = p.whh + (size_t)d * H * G;
  for (int i = tid; i < H * NG * (U / 4); i += THREADS) {
    const int u4 = i % (U / 4), gate = (i / (U / 4)) % NG, k = i / (NG * (U / 4));
    *reinterpret_cast<float4*>(ws + k * NG * U + gate * U + u4 * 4) =
        __ldg(reinterpret_cast<const float4*>(W + (size_t)k * G + gate * H + u0 + u4 * 4));
  }
  for (int i = tid; i < H * R / 4; i += THREADS)
    reinterpret_cast<float4*>(hs)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // h0 = 0
  if (tid == 0) {
    for (int b = 0; b < NB; ++b) mbar_init(full_bar + 8 * b, 1);
    mbar_init(empty_bar, cn > 1 ? cn - 1 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  float bhn[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) bhn[e] = LSTM ? 0.0f : p.bhh[(size_t)d * G + 2 * H + unit + e];
  float st[4][2];  // GRU: h; LSTM: c; f32, of rows i, units e
  float xc[4][NG][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) st[i][0] = st[i][1] = 0.0f;

  auto load_x = [&](int t) {
    const float* xt = p.xg + ((size_t)d * L + t) * N * G;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + rg * 4 + i;
#pragma unroll
      for (int gate = 0; gate < NG; ++gate) {
        const float2 v = row < N ? ld_nc_f2(xt + (size_t)row * G + gate * H + unit)
                                 : make_float2(0.0f, 0.0f);
        xc[i][gate][0] = v.x;
        xc[i][gate][1] = v.y;
      }
    }
  };

  load_x(d == 0 ? 0 : L - 1);
  cluster_sync_all();  // every CTA has staged W, zeroed h and set up its barriers

  for (int s = 0; s < L; ++s) {
    const int t = d == 0 ? s : L - 1 - s;
    const bool last = s == L - 1;
    const float* hc = hs + (size_t)(NB == 2 ? (s & 1) : 0) * H * R;
    float* hx = hs + (size_t)(NB == 2 ? ((s + 1) & 1) : 0) * H * R;
    // every block of h(s) is here: buffer s % NB's phase (s - 1) / NB
    if (s > 0) mbar_wait(full_bar + 8 * (s % NB), ((s - 1) / NB) & 1);
    float acc[4][NG][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int gate = 0; gate < NG; ++gate) acc[i][gate][0] = acc[i][gate][1] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float4 hv = *reinterpret_cast<const float4*>(hc + k * R + rg * 4);
      const float h[4] = {hv.x, hv.y, hv.z, hv.w};
      const float* wk = ws + k * NG * U + 2 * ug;
#pragma unroll
      for (int gate = 0; gate < NG; ++gate) {
        const float2 w = *reinterpret_cast<const float2*>(wk + gate * U);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][gate][0] = fmaf(h[i], w.x, acc[i][gate][0]);
          acc[i][gate][1] = fmaf(h[i], w.y, acc[i][gate][1]);
        }
      }
    }
    if (!last) {
      // this CTA has read h(s), and its copies out of the other buffer are done
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncthreads();
      if (NB == 1 && tid < (int)cn && tid != (int)crank) mbar_arrive_remote(empty_bar, tid);
    }
    float hnew[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + rg * 4 + i;
      float a[4][2];  // the cell's activations of each unit
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (LSTM) {
          a[0][e] = sigmoid_f(xc[i][0][e] + acc[i][0][e]);
          a[1][e] = sigmoid_f(xc[i][1][e] + acc[i][1][e]);
          a[2][e] = tanhf(xc[i][2][e] + acc[i][2][e]);
          a[3][e] = sigmoid_f(xc[i][3][e] + acc[i][3][e]);
          st[i][e] = fmaf(a[1][e], st[i][e], a[0][e] * a[2][e]);  // c' = f c + i g
          hnew[i][e] = a[3][e] * tanhf(st[i][e]);                // h' = o tanh(c')
        } else {
          a[0][e] = sigmoid_f(xc[i][0][e] + acc[i][0][e]);  // r
          a[1][e] = sigmoid_f(xc[i][1][e] + acc[i][1][e]);  // z
          a[3][e] = acc[i][2][e] + bhn[e];                  // hg_n
          a[2][e] = tanhf(xc[i][2][e] + a[0][e] * a[3][e]);  // n
          st[i][e] = (1.0f - a[1][e]) * a[2][e] + a[1][e] * st[i][e];
          hnew[i][e] = st[i][e];
        }
      }
      if (row < N) {
        float* o = p.out + ((size_t)t * N + row) * 2 * H + d * H + unit;
        *reinterpret_cast<float2*>(o) = make_float2(hnew[i][0], hnew[i][1]);
        if (last)
          *reinterpret_cast<float2*>(p.hn + ((size_t)d * N + row) * H + unit) =
              make_float2(hnew[i][0], hnew[i][1]);
      }
    }
    if (last) break;
    load_x(d == 0 ? s + 1 : L - 2 - s);
    // the new h of this CTA's units into its own buffer, [unit][row]
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float4*>(hx + (size_t)(unit + e) * R + rg * 4) =
          make_float4(hnew[0][e], hnew[1][e], hnew[2][e], hnew[3][e]);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the copies
    __syncthreads();
    if (tid == 0) {
      // the blocks of h(s + 1) to come (into buffer (s + 1) % NB)
      const uint32_t bar = full_bar + 8 * ((s + 1) % NB);
      mbar_expect_tx(bar, (cn - 1) * block_bytes);
      if (NB == 1 && cn > 1) mbar_wait(empty_bar, s & 1);  // every other CTA has read h(s)
      const uint32_t src = smem_u32(hx + (size_t)u0 * R);
      for (uint32_t r = 1; r < cn; ++r) bulk_to_peer(src, block_bytes, bar, (crank + r) % cn);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  cluster_sync_all();  // no CTA leaves while another may still reach its shared memory
}

// The geometries instantiated, (U, R, NB) for each cell. H = 256 takes the
// first of its cell (ops/bigru.py::SIMT_GEOMETRY); H = 16 takes (16, 128,
// 2) and H = 32 .. 128 (32, 64, 2).
#define GRU_GEOMETRIES(X) \
  X(false, 64, 32, 1)     \
  X(false, 32, 96, 1)     \
  X(false, 32, 64, 2)     \
  X(false, 16, 128, 2)
#define LSTM_GEOMETRIES(X) \
  X(true, 32, 96, 1)       \
  X(true, 32, 64, 1)       \
  X(true, 32, 64, 2)       \
  X(true, 16, 128, 2)

static const void* rec_kernel(int cell, int U, int R, int NB) {
#define REC_PICK(LS, U_, R_, NB_)                                 \
  if (cell == (LS ? 1 : 0) && U == U_ && R == R_ && NB == NB_) \
    return (const void*)birnn_rec_kernel<LS, U_, R_, NB_>;
  GRU_GEOMETRIES(REC_PICK)
  LSTM_GEOMETRIES(REC_PICK)
#undef REC_PICK
  return nullptr;
}

// W_hh's slice, NB h buffers and the three barriers (and a spare)
static size_t rec_smem(int ng, int H, int U, int R, int NB) {
  return ((size_t)H * ng * U + (size_t)NB * H * R) * 4 + 32;
}

// The kernel, its launch shape and shared memory for one geometry, with the
// shared-memory and cluster-size attributes set; nullptr if not instantiated
// or not valid for H.
static const void* rec_setup(int cell, int H, int U, int R, int NB, size_t* smem, int* threads,
                             cudaError_t* err) {
  *err = cudaSuccess;
  if ((cell != 0 && cell != 1) || U < 16 || H % U != 0 || H % 2 != 0) return nullptr;
  const int cn = H / U;
  if (cn != 1 && cn != 2 && cn != 4 && cn != 8) return nullptr;
  const void* k = rec_kernel(cell, U, R, NB);
  if (k == nullptr) return nullptr;
  *smem = rec_smem(cell == 0 ? 3 : 4, H, U, R, NB);
  *threads = (R / 4) * (U / 2);
  *err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return k;
}

static void rec_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int cn, int tiles,
                       int threads, size_t smem, cudaStream_t s) {
  *cfg = {};
  cfg->gridDim = dim3(cn * tiles, 2, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cn;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

extern "C" {

// (b): from xg (2, L N, G) f32 to out (L, N, 2H) in the operand type and hn
// (2, N, H) f32. cell: 0 = GRU, 1 = LSTM; dtype 0 = float32: this file's
// recurrence with U units a CTA (clusters of H / U), R rows a tile, NB h
// buffers; dtype 1 = bfloat16: rnn_train_rec.cuh's simt forward with INFER,
// U units a CTA and its fwd_simt_rows(H) rows R (NB unread). Returns 0 or a
// cudaError_t value.
int birnn_simt_rec_launch(int cell, int dtype, const void* xg, const void* whh,
                          const void* bhh, void* out, void* hn, int L, int N, int H, int U,
                          int R, int NB, void* stream, int device) {
  USE_DEVICE(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
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
    if (cell == 0) return fwd_rec_run<false, true>(0, dtype, rp, U, R, s);
    if (cell == 1) return fwd_rec_run<true, true>(0, dtype, rp, U, R, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  int threads = 0;
  cudaError_t e;
  const void* k = rec_setup(cell, H, U, R, NB, &smem, &threads, &e);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  RecParams q;
  q.xg = static_cast<const float*>(xg);
  q.whh = static_cast<const float*>(whh);
  q.bhh = static_cast<const float*>(bhh);
  q.out = static_cast<float*>(out);
  q.hn = static_cast<float*>(hn);
  q.L = L;
  q.N = N;
  q.H = H;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  rec_config(&cfg, attr, H / U, (N + R - 1) / R, threads, smem, s);
  void* args[1] = {&q};
  e = cudaLaunchKernelExC(&cfg, k, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of the f32 recurrence at (cell, H, U, R, NB) the
// card holds at once (cudaOccupancyMaxActiveClusters for the kernel, block
// and shared memory that birnn_simt_rec_launch launches), into *clusters,
// and its shared memory a CTA into *smem_bytes. Launches nothing. Returns 0
// or a cudaError_t value.
int birnn_simt_rec_occupancy(int cell, int H, int U, int R, int NB, int* clusters,
                             int* smem_bytes, int device) {
  USE_DEVICE(device);
  size_t smem = 0;
  int threads = 0;
  cudaError_t e;
  const void* k = rec_setup(cell, H, U, R, NB, &smem, &threads, &e);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  rec_config(&cfg, attr, H / U, 1, threads, smem, nullptr);
  *smem_bytes = (int)smem;
  return (int)cudaOccupancyMaxActiveClusters(clusters, k, &cfg);
}

}  // extern "C"
