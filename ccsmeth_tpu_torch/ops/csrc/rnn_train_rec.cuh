// The cluster recurrences of the RNN training kernels, written once for both
// cells and instantiated by each layer's source: bigru_train.cu (K4, K5; the
// GRU, NG = 3 gates r, z, n) and bilstm_train.cu (K6; the LSTM, NG = 4 gates
// i, f, g, o). The gate count, the gate math and what a step keeps are the
// only differences; the layout of W_hh in shared memory, the exchange across
// the cluster and the thread layouts are the same code. birnn_simt.cu
// instantiates the simt forward once more for inference (INFER: K1's and
// K2's simt design on the bf16 shapes their tc design refuses): no
// residuals, each direction's last h to h_n. K1's and K2's f32 recurrence
// is birnn_simt.cu's own (four warps of RT x 2 NG micro-tiles, the gate
// math written as here); the simt forward's products take their xg from
// rnn_train_gemm.cuh's f32_tma_kernel.
//
//   forward (fwd_rec_simt_kernel, fwd_rec_tc_kernel): both directions at
//     once from the projection xg (2, L N, G) f32. A cluster of CN = H / U
//     CTAs runs one (row tile, direction); CTA c owns the hidden units
//     [c U, (c+1) U) of every gate and keeps its NG U columns of W_hh in
//     shared memory for all L steps. The cell's state (the GRU's h, the
//     LSTM's c) stays f32 in the registers of the one thread that owns the
//     (row, unit). Per step each CTA writes out and the residuals (GRU r, z,
//     n, hg_n; LSTM i, f, g, o and c) and sends its new h, rounded to the
//     operand type, to every CTA of the cluster (distributed shared memory:
//     simt by bulk copies onto the receivers' mbarriers, tc by remote
//     stores and one cluster barrier a step).
//   backward (bwd_rec_simt_kernel, bwd_rec_tc_kernel): both directions at
//     once over reversed time, carrying dh (and the LSTM's dc). Per step the
//     gate gradients of a (row, unit) from the residuals go to device memory
//     for the products (simt: f32 scratch, whose column sums the simt
//     products take beside the weight gradients; tc: bf16 copies, rounded to
//     nearest even, that TMA feeds to wgmma, while each thread sums its f32
//     values for the bias gradients over its rows and steps in order, and the
//     CTA writes its tile's partial sums, added in tile order by
//     gemm_sum_slices) and, rounded to the operand type, to shared memory as
//     the operand of dh = op(dg) W_hh^T. That contraction runs over NG H, so
//     CTA c multiplies its own NG U gate columns by its W_hh rows into a
//     partial dh for all H units and sends each CTA the U columns it owns;
//     the owner adds the CN partials in rank order (a reduce-scatter,
//     deterministic). The GRU's carry term is dt z; the LSTM's dh has none,
//     and it carries dc, which never leaves its owner.
//   Rows >= N (the ragged last tile) read zeros and store nothing.
//
// Routes (ops/bigru_vjp.py::k45_plan picks one per call, for either cell):
//   simt: exact f32 FMAs (no TF32), accurate expf and tanhf. Forward
//     (fwd_rec_simt_kernel): a dataflow with no cluster barrier in the time
//     loop (the protocol above the kernel). Geometry (SimtFwdGeom): 256
//     threads in two warp groups, each half of the tile's rows; a thread
//     owns one unit, its NG gates and RT rows (a warp's lanes the CTA's 32
//     units, so a gate's W_hh is one 4-byte load a k and each quad of rows'
//     h one 16-byte load, the same address for the warp). The groups take
//     turns at the product, so that one group's gate math, stores and
//     exchange run while the other multiplies. At H = 256 (clusters of 8,
//     U = 32) R = 72 rows a tile, 36 a group, for both cells: 15 tiles a
//     direction at the train path's 1,024 rows, 30 clusters, two full waves
//     of the 15 clusters of 8 that the H100 holds at one CTA an SM
//     (cudaOccupancyMaxActiveClusters; 64 rows would take 3 waves), and
//     80 rows where that saves a wave (512 rows in one; the caller picks,
//     ops/bigru_vjp.py::simt_fwd_rows). Shared memory: the W_hh slice
//     [k][gate][u] f32 (131,072 bytes for the LSTM, 98,304 for the GRU),
//     h [k][row] of each group f32 (73,728) and four barriers: 204,832 /
//     172,064 bytes a CTA. What bounds it: shared memory's rate, one
//     128-byte wavefront a clock an SM, a 16-byte load of a warp four of
//     them: a thread's NG + RT operand words a k against NG RT FMAs
//     (36 / 13 for the LSTM, 69% of the FMA rate at best), then the chain
//     of L steps, each with its gate math, stores, barriers and waits.
//     Each (row, unit, gate) is one fmaf chain over k ascending from 0.0f
//     and the gate math is the one written below, so the outputs do not
//     depend on the geometry.
//     Backward (bwd_rec_simt_kernel): a dataflow with no cluster barrier in
//     the time loop (the protocol above the kernel), over the two row
//     halves of its tile in turn, so that one half's partials travel while
//     the other half computes. Geometry (SimtBwdGeom): 256 threads; a
//     thread owns the partial of RT rows x 8 units and the gate math of up
//     to QM quads (4 units of a row) of each half, keeping their carries
//     and the next gate math's residuals in registers (16-byte loads issued
//     between the product's k ranges, landing while it runs). At H = 256 (clusters
//     of 8, U = 32) R = 72 rows a tile, halves of 40 and 32: 15 tiles a
//     direction at the train path's 1,024 rows, 30 clusters, two full waves
//     of the 15 clusters of 8 that the H100 holds at one CTA an SM
//     (cudaOccupancyMaxActiveClusters; 64 rows would take 3 waves, the
//     parent's 32 took 4.6, and the LSTM's CTA of 80 rows does not fit).
//     Shared memory: the W_hh slice [NG U][H] f32 (131,072 bytes for the
//     LSTM, 98,304 for the GRU), the partials received [half][CN][rows][U]
//     f32 (73,728) and one half's operand [40][NG U + 4] f32 (21,120 /
//     16,000): 225,952 / 188,064 bytes a CTA. The product reads the operand
//     as 16-byte rows of 4 k and W_hh as 16-byte runs of 4 units, a warp's
//     lanes 8 unit groups x 4 rows (conflict-free); each partial is one
//     fmaf chain over k ascending from 0.0f; the partials reach their
//     owners by 16-byte st.async stores whose bytes complete on the owner's
//     mbarrier (R H x 7/8 x 4 bytes out of each CTA a step). What bounds
//     it: the product, 2 NG U H FLOPs a row and step for a CTA's 128 FMA
//     lanes, then the chain of L steps, each with its gate math, barriers
//     and waits.
//   tc (bf16): mma.sync.m16n8k16 with f32 sums, fragments by ldmatrix
//     (mma_tile.cuh). Forward: a cluster recurrence with the residual
//     stores, 64 rows a tile, W_hh gate-interleaved so a thread's
//     accumulators hold every gate of its units. Backward
//     (bwd_rec_tc_kernel): 32 rows a tile, W_hh staged [unit j][own gate
//     column k] and dg [row][k], both k-contiguous bf16, each warp one
//     16-row tile by H / 4 units, the partials double-buffered and sent by
//     8-byte remote stores, one cluster barrier a step.
//
// Numerics: gate math and every sum in f32. With bf16 operands the weights,
//   dout and the residuals are bf16 values (as on the TPU); the h operand and
//   the gate-gradient operand are rounded to bf16 for the products. The tc
//   forward's gate functions use __expf (within ~1e-6, far inside a bf16
//   ulp), as K1-tc's.

#pragma once

#include "rnn_train_gemm.cuh"

typedef __nv_bfloat16 bf16;

#define REC_THREADS 256
#define TC_FWD_ROWS 64  // rows of a tc forward tile (K1-tc's)
#define TC_BWD_ROWS 32  // rows of a tc backward tile

// one or two consecutive values in the store type
__device__ __forceinline__ void st1(float* p, float a) { *p = a; }
__device__ __forceinline__ void st1(bf16* p, float a) { *p = __float2bfloat16_rn(a); }
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}

// an 8-byte store to the same shared-memory offset in the cluster's CTA rank
__device__ __forceinline__ void st_cluster_v2(uint32_t local_addr, uint32_t rank,
                                              float a, float b) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local_addr), "r"(rank));
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(remote), "f"(a),
               "f"(b)
               : "memory");
}

__device__ __forceinline__ float sigmoid_tc(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float tanh_tc(float x) { return 2.0f * sigmoid_tc(2.0f * x) - 1.0f; }

static int launch_cluster(const void* kernel, void* params, int cn, int tiles,
                          size_t smem, cudaStream_t s) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cn * tiles, 2, 1);
  cfg.blockDim = dim3(REC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cn;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[1] = {params};
  e = cudaLaunchKernelExC(&cfg, kernel, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

static bool cluster_ok(int H, int U) {
  if (U < 16 || U % 16 != 0 || H % U != 0) return false;
  const int cn = H / U;
  return cn == 1 || cn == 2 || cn == 4 || cn == 8;
}

// ---------------------------------------------------------------- forward

struct FwdRecParams {
  const float* xg;   // (2, L N, G) f32 from the projection
  const void* whh;   // (2, H, G) T
  const float* bhh;  // (2, G): the GRU reads b_hn = columns 2H..3H
  void* out;         // (L, N, 2H) T
  void* gates;       // (2, L, N, 4H) T: GRU r, z, n, hg_n; LSTM i, f, g, o
  void* cseq;        // (2, L, N, H) T: the LSTM's cell state (GRU: unused)
  float* hn;         // (2, N, H) f32: each direction's last h (INFER only)
  int L, N, H;
};

// The simt forward's geometry at hidden width H and RT rows a thread: U =
// min(H, 32) units a CTA, clusters of CN = H / U; 256 threads in NGR = 2
// warp groups of 4 warps, a warp's lanes the U units by SW = 32 / U row
// slots (NQ = 4 SW slots a group). A thread owns one unit, its NG gates
// and RT rows; a group owns RG = NQ RT rows of the tile, R = NGR RG. RT = 8
// below H = 256 (64 rows, 128 at H = 16); at H = 256 it is K46_FWD_RT256
// (72 rows, the train path's 1,024 rows in two waves) or one more (80: 512
// rows in one wave), whichever the caller passes
// (ops/bigru_vjp.py::simt_fwd_rows; a copy of this source may define
// K46_FWD_RT256: chip_smoke.py's k46_fwd_simt_sweep).
#ifndef K46_FWD_RT256
#define K46_FWD_RT256 9
#endif

template <int H, int RT_>
struct SimtFwdGeom {
  static constexpr int U = H < 32 ? H : 32;
  static constexpr int CN = H / U;
  static constexpr int SW = 32 / U;             // row slots a warp
  static constexpr int NGR = 2;                 // warp groups
  static constexpr int NQ = 8 / NGR * SW;       // row slots of a group
  static constexpr int RT = RT_;
  static constexpr int RG = NQ * RT, R = NGR * RG;
};

// Row i (0 .. rt - 1) of the thread in row slot q, local to its group's rows
// (nq slots of rt rows): the first 4 floor(rt / 4) in quads of consecutive
// rows (quad j: rows 4 (j nq + q) ..), so that a 16-byte load of h reads a
// quad, then one row a slot (rows 4 floor(rt / 4) nq + j nq + q)
__host__ __device__ constexpr int fwd_row(int rt, int nq, int q, int i) {
  return i < rt / 4 * 4 ? (i / 4 * nq + q) * 4 + i % 4 : rt / 4 * 4 * nq + (i - rt / 4 * 4) * nq + q;
}

// a CTA barrier of the `n` threads that name barrier `id` (bar.sync: wait)
// or an arrival on it (bar.arrive: no wait)
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// simt (exact f32 FMAs): the dataflow forward recurrence. CTA c keeps W_hh's
// columns of its units, [k][gate][u], and h of its tile's rows, [k][row]
// for each warp group; each group runs its rows through the steps on its
// own (its barriers: named barrier 1 + g of its threads, and its `full` and
// `empty` mbarriers), a step:
//   1. every thread waits on the group's `full` barrier for the peers'
//      blocks of h(s);
//   2. the groups take turns at the product (named barriers 3 and 4:
//      group 0's product of step s, then group 1's, then group 0's of
//      step s + 1), so that one group's gate math, stores and exchange run
//      while the other multiplies; the product: each (row, unit, gate) one
//      fmaf chain over k ascending from 0.0f, a k a 4-byte load of W a gate
//      (the warp's units, consecutive words), a 16-byte load of h a quad of
//      rows and a 4-byte load a row past them (the same address for the
//      lanes of a row slot);
//   3. the group's first thread arms `full` with the bytes of h(s + 1) to
//      come, a group barrier says every thread has read h(s), and the group
//      tells every peer's group so on the peer's `empty` barrier;
//   4. the gate math of the group's rows, the out and residual stores
//      (fire-and-forget, in the store type), the loads of the next
//      projection (landing while the other group multiplies), and the new
//      h, rounded to the operand type, into this CTA's block of the group,
//      [k = its units][rows], contiguous;
//   5. past a group barrier, the first thread waits on `empty` for every
//      peer to have read h(s) and copies the block to each peer
//      (cp.async.bulk, completing on the peer's `full` barrier).
// One h buffer a group: a block of step s + 1 lands only after its receiver
// has read the step's h (its `empty` arrival), and a CTA overwrites its own
// block only after its copies of the last step have read it
// (cp.async.bulk.wait_group.read). `full` completes once a step (phase s:
// the peers' blocks of h(s + 1), waited for at step s + 1), `empty` once a
// step (phase s: every peer has read h(s)); neither runs a phase ahead (a
// peer's blocks of h(s + 2) need this CTA's `empty` arrival of step s + 1,
// made after its wait on `full` phase s; its arrival of step s + 1 needs
// this CTA's blocks of h(s + 1), sent after its wait on `empty` phase s).
// No cluster barrier sits in the time loop. INFER (K1's and K2's simt design
// for the bf16 shapes its tc design refuses, birnn_simt.cu) keeps no
// residuals (gates, cseq unused) and writes the f32 h of the direction's
// last step to hn; the arithmetic and the out stores are the training
// forward's.
template <typename T, bool LSTM, int H, int RT_, bool INFER = false>
__global__ void __launch_bounds__(REC_THREADS, 1) fwd_rec_simt_kernel(const FwdRecParams p) {
  using Gm = SimtFwdGeom<H, RT_>;
  constexpr int NG = LSTM ? 4 : 3, G = NG * H;
  constexpr int U = Gm::U, CN = Gm::CN, SW = Gm::SW, NGR = Gm::NGR, NQ = Gm::NQ;
  constexpr int RT = Gm::RT, RG = Gm::RG, R = Gm::R;
  constexpr int GT = REC_THREADS / NGR;  // threads a group
  static_assert(NGR == 2 && U * SW == 32 && NQ * NGR * U == REC_THREADS, "thread layout");
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;             // [H][NG][U]: W_hh[k][gate H + u0 + u]
  float* hs = ws + H * NG * U;  // [NGR][H][RG]: h of each group's rows
  const uint32_t crank = cluster_ctarank();
  const int d = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = warp / (8 / NGR), wg = warp % (8 / NGR);  // group, warp in it
  const int gtid = tid % GT;                              // thread in the group
  const int u = lane % U;                                 // this thread's unit (local)
  const int q = wg * SW + lane / U;                       // and row slot
  const int u0 = crank * U, unit = u0 + u;
  const int L = p.L, N = p.N;
  const int row0 = (blockIdx.x / CN) * R + g * RG;        // the group's first row
  float* hb = hs + g * H * RG;                            // its h, [k][row]
  const uint32_t bar0 = smem_u32(hs + H * R);
  const uint32_t full_bar = bar0 + 8 * g, empty_bar = bar0 + 16 + 8 * g;
  const T* W = static_cast<const T*>(p.whh) + (size_t)d * H * G;
  T* out = static_cast<T*>(p.out);
  T* gates = static_cast<T*>(p.gates);
  T* cseq = static_cast<T*>(p.cseq);

  for (int i = tid; i < H * NG * U; i += REC_THREADS) {
    const int k = i / (NG * U), gate = i / U % NG, uu = i % U;
    ws[i] = Op<T>::to_f(W[(size_t)k * G + gate * H + u0 + uu]);
  }
  for (int i = tid; i < H * R / 4; i += REC_THREADS)
    reinterpret_cast<float4*>(hs)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // h0 = 0
  if (CN > 1 && tid == 0) {
    for (int b = 0; b < NGR; ++b) {
      mbar_init(bar0 + 8 * b, 1);            // full
      mbar_init(bar0 + 16 + 8 * b, CN - 1);  // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  const float bhn = LSTM ? 0.0f : p.bhh[(size_t)d * G + 2 * H + unit];
  float st[RT];      // GRU: h; LSTM: c; f32, of the thread's rows
  float xc[RT][NG];  // the projection of their next step
#pragma unroll
  for (int i = 0; i < RT; ++i) st[i] = 0.0f;

  // the projection of step t for the thread's rows (zeros past N)
  auto load_x = [&](int t) {
    const float* xt = p.xg + ((size_t)d * L + t) * N * G + unit;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int row = row0 + fwd_row(RT, NQ, q, i);
#pragma unroll
      for (int gate = 0; gate < NG; ++gate)
        xc[i][gate] = row < N ? gm_ld1(xt + (size_t)row * G + gate * H) : 0.0f;
    }
  };
  load_x(d == 0 ? 0 : L - 1);
  cluster_sync_all();  // every CTA has staged W, zeroed h and set up its barriers

  for (int s = 0; s < L; ++s) {
    const int t = d == 0 ? s : L - 1 - s;
    const bool more = s + 1 < L;  // a next step reads the new h
    // 1) every block of the group's h(s) is here
    if (CN > 1 && s > 0) mbar_wait(full_bar, (s - 1) & 1);
    // 2) the product of the group's rows by this CTA's W_hh columns, in turn
    if (g == 1 || s > 0) named_sync(3 + g, REC_THREADS);
    float acc[RT][NG];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int gate = 0; gate < NG; ++gate) acc[i][gate] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      float w[NG];
#pragma unroll
      for (int gate = 0; gate < NG; ++gate) w[gate] = ws[(k * NG + gate) * U + u];
      const float* hk = hb + k * RG;
      float hv[RT];
#pragma unroll
      for (int j = 0; j < RT / 4; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(hk + (j * NQ + q) * 4);
        hv[4 * j] = v.x;
        hv[4 * j + 1] = v.y;
        hv[4 * j + 2] = v.z;
        hv[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int i = RT / 4 * 4; i < RT; ++i) hv[i] = hk[fwd_row(RT, NQ, q, i)];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int gate = 0; gate < NG; ++gate) acc[i][gate] = fmaf(hv[i], w[gate], acc[i][gate]);
    }
    if (g == 0 || more) named_arrive(4 - g, REC_THREADS);  // the other group's turn
    // 3) every thread of the group has read its h(s): the peers may send h(s + 1)
    if (CN > 1 && gtid == 0) {
      // this group's copies of its last block have read it
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      if (more) mbar_expect_tx(full_bar, (CN - 1) * U * RG * 4);
    }
    named_sync(1 + g, GT);  // the group's barrier
    if (CN > 1 && more && gtid < CN && gtid != (int)crank) mbar_arrive_remote(empty_bar, gtid);
    // 4) the gate math, the stores, the next projection and the new h
    float hnew[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int row = row0 + fwd_row(RT, NQ, q, i);
      float a[4];  // the four residuals
      float& sv = st[i];
      if constexpr (LSTM) {
        a[0] = sigmoid_f(xc[i][0] + acc[i][0]);
        a[1] = sigmoid_f(xc[i][1] + acc[i][1]);
        a[2] = tanhf(xc[i][2] + acc[i][2]);
        a[3] = sigmoid_f(xc[i][3] + acc[i][3]);
        // c' = f c + i g, the fused form written out: nvcc may fuse either
        // product, and did so differently in the INFER instantiation
        sv = fmaf(a[1], sv, a[0] * a[2]);
        hnew[i] = a[3] * tanhf(sv);  // h' = o tanh(c')
      } else {
        a[0] = sigmoid_f(xc[i][0] + acc[i][0]);  // r
        a[1] = sigmoid_f(xc[i][1] + acc[i][1]);  // z
        a[3] = acc[i][2] + bhn;                  // hg_n
        a[2] = tanhf(xc[i][2] + a[0] * a[3]);    // n
        sv = (1.0f - a[1]) * a[2] + a[1] * sv;
        hnew[i] = sv;
      }
      if (row < N) {
        st1(out + ((size_t)t * N + row) * 2 * H + d * H + unit, hnew[i]);
        if constexpr (INFER) {
          if (!more) p.hn[((size_t)d * N + row) * H + unit] = hnew[i];
        } else {
          T* gp = gates + (((size_t)d * L + t) * N + row) * 4 * H + unit;
#pragma unroll
          for (int r = 0; r < 4; ++r) st1(gp + r * H, a[r]);
          if constexpr (LSTM) st1(cseq + (((size_t)d * L + t) * N + row) * H + unit, sv);
        }
      }
    }
    if (!more) break;
    load_x(d == 0 ? s + 1 : L - 2 - s);
    float* blk = hb + unit * RG;  // this unit's row of the block
#pragma unroll
    for (int j = 0; j < RT / 4; ++j)
      *reinterpret_cast<float4*>(blk + (j * NQ + q) * 4) =
          make_float4(Op<T>::operand(hnew[4 * j]), Op<T>::operand(hnew[4 * j + 1]),
                      Op<T>::operand(hnew[4 * j + 2]), Op<T>::operand(hnew[4 * j + 3]));
#pragma unroll
    for (int i = RT / 4 * 4; i < RT; ++i) blk[fwd_row(RT, NQ, q, i)] = Op<T>::operand(hnew[i]);
    if constexpr (CN > 1) fence_async_shared();
    named_sync(1 + g, GT);  // the block is whole
    if (CN > 1 && gtid == 0) {
      // 5) the block to every peer once each has read h(s)
      mbar_wait(empty_bar, s & 1);
      const uint32_t src = smem_u32(hb + u0 * RG);
      for (uint32_t r = 1; r < CN; ++r) bulk_to_peer(src, U * RG * 4, full_bar, (crank + r) % CN);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if constexpr (CN > 1) {
    if (gtid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    cluster_sync_all();  // no CTA leaves while a peer may still reach its shared memory
  }
}

// tc (bf16): the mma.sync cluster recurrence with the residual stores. U
// hidden units a CTA; 8 warps as WR (rows) x WU (unit
// blocks of 8), each warp MT row tiles of 16 by UT unit blocks, every gate.
template <bool LSTM, int U>
__global__ void __launch_bounds__(REC_THREADS, 1) fwd_rec_tc_kernel(const FwdRecParams p) {
  constexpr int NG = LSTM ? 4 : 3;
  constexpr int NC = NG * U;
  constexpr int UB = U / 8;
  constexpr int WU = UB < 4 ? UB : 4;
  constexpr int UT = UB / WU;
  constexpr int WR = 8 / WU;
  constexpr int MT = (TC_FWD_ROWS / 16) / WR;
  static_assert(WR * WU == 8 && MT * WR * 16 == TC_FWD_ROWS, "warp layout");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = p.H, HP = H + 8, G = NG * H, L = p.L, N = p.N;
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);  // [NC][HP]
  bf16* hs = ws + NC * HP;                        // [2][TC_FWD_ROWS][HP]
  const uint32_t crank = cluster_ctarank();
  const uint32_t cn = cluster_nctarank();
  const int d = blockIdx.y;
  const int row0 = (blockIdx.x / cn) * TC_FWD_ROWS;
  const int u0 = crank * U;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp / WU, wu = warp % WU;
  bf16* out = static_cast<bf16*>(p.out);
  bf16* gates = static_cast<bf16*>(p.gates);
  bf16* cseq = static_cast<bf16*>(p.cseq);

  // this CTA's W_hh columns, gate-interleaved, k contiguous
  const bf16* W = static_cast<const bf16*>(p.whh) + (size_t)d * H * G;
  for (int i = tid; i < H * NG * UB; i += REC_THREADS) {
    const int k = i % H, ub = (i / H) % UB, gate = i / (H * UB);
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(
        W + (size_t)k * G + gate * H + u0 + ub * 8));
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    bf16* dst = ws + (ub * NG + gate) * 8 * HP + k;
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[j * HP] = e[j];
  }
  for (int i = tid; i < TC_FWD_ROWS * HP / 8; i += REC_THREADS)
    reinterpret_cast<uint4*>(hs)[i] = make_uint4(0u, 0u, 0u, 0u);  // h0 = 0

  float bhn[UT][2];
#pragma unroll
  for (int ut = 0; ut < UT; ++ut)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bhn[ut][e] = LSTM ? 0.0f
                        : p.bhh[(size_t)d * G + 2 * H + u0 + (wu * UT + ut) * 8 + 2 * t4 + e];
  float st[MT][UT][2][2];  // GRU: h; LSTM: c; f32, of rows (mt, half), units (ut, e)
  float2 xc[MT][UT][NG][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ut = 0; ut < UT; ++ut)
#pragma unroll
      for (int q = 0; q < 4; ++q) st[mt][ut][q >> 1][q & 1] = 0.0f;

  auto load_x = [&](int t) {
    const float* xt = p.xg + ((size_t)d * L + t) * N * G;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + (wr * MT + mt) * 16 + g + 8 * half;
#pragma unroll
        for (int ut = 0; ut < UT; ++ut)
#pragma unroll
          for (int gate = 0; gate < NG; ++gate) {
            const int col = gate * H + u0 + (wu * UT + ut) * 8 + 2 * t4;
            xc[mt][ut][gate][half] =
                row < N ? ld_nc_f2(xt + (size_t)row * G + col) : make_float2(0.0f, 0.0f);
          }
      }
  };

  load_x(d == 0 ? 0 : L - 1);
  cluster_sync_all();

  for (int s = 0; s < L; ++s) {
    const int t = d == 0 ? s : L - 1 - s;
    const bf16* hc = hs + (s & 1) * TC_FWD_ROWS * HP;
    bf16* hx = hs + ((s + 1) & 1) * TC_FWD_ROWS * HP;
    float acc[MT][UT][NG][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ut = 0; ut < UT; ++ut)
#pragma unroll
        for (int gate = 0; gate < NG; ++gate)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][ut][gate][q] = 0.0f;

#pragma unroll 2
    for (int k0 = 0; k0 < H; k0 += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], smem_u32(hc + ((wr * MT + mt) * 16 + (lane & 15)) * HP +
                                    k0 + (lane >> 4) * 8));
#pragma unroll
      for (int ut = 0; ut < UT; ++ut)
#pragma unroll
        for (int gate = 0; gate < NG; ++gate) {
          uint32_t b[2];
          ldmatrix_x2(b, smem_u32(ws + (((wu * UT + ut) * NG + gate) * 8 + (lane & 7)) * HP +
                                  k0 + ((lane >> 3) & 1) * 8));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][ut][gate], a[mt], b);
        }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = (wr * MT + mt) * 16 + g + 8 * half;
        const int row = row0 + rl;
#pragma unroll
        for (int ut = 0; ut < UT; ++ut) {
          const int ub0 = u0 + (wu * UT + ut) * 8;  // this 8-unit block
          const int unit = ub0 + 2 * t4;
          float hv[2], a[4][2];  // a: the four residuals of each unit
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = 2 * half + e;
            float x[NG];
#pragma unroll
            for (int gate = 0; gate < NG; ++gate)
              x[gate] = e ? xc[mt][ut][gate][half].y : xc[mt][ut][gate][half].x;
            float& sv = st[mt][ut][half][e];
            if constexpr (LSTM) {
              a[0][e] = sigmoid_tc(x[0] + acc[mt][ut][0][q]);
              a[1][e] = sigmoid_tc(x[1] + acc[mt][ut][1][q]);
              a[2][e] = tanh_tc(x[2] + acc[mt][ut][2][q]);
              a[3][e] = sigmoid_tc(x[3] + acc[mt][ut][3][q]);
              sv = a[1][e] * sv + a[0][e] * a[2][e];  // c' = f c + i g
              hv[e] = a[3][e] * tanh_tc(sv);          // h' = o tanh(c')
            } else {
              a[0][e] = sigmoid_tc(x[0] + acc[mt][ut][0][q]);
              a[1][e] = sigmoid_tc(x[1] + acc[mt][ut][1][q]);
              a[3][e] = acc[mt][ut][2][q] + bhn[ut][e];
              a[2][e] = tanh_tc(x[2] + a[0][e] * a[3][e]);
              hv[e] = (1.0f - a[1][e]) * a[2][e] + a[1][e] * sv;
              sv = hv[e];
            }
          }
          // the row's 8 units of this block (16 bytes) in each of its 4
          // lanes; lane t4 sends them to CTAs t4, t4 + 4 of the cluster
          const uint4 blk = quad_gather(pack_bf16x2(hv[0], hv[1]));
          const uint32_t la = smem_u32(hx + rl * HP + ub0);
          for (uint32_t r = t4; r < cn; r += 4) st_cluster_v4(la, r, blk);
          if (row < N) {
            if (t4 == 0)
              *reinterpret_cast<uint4*>(out + ((size_t)t * N + row) * 2 * H + d * H + ub0) = blk;
            bf16* gp = gates + (((size_t)d * L + t) * N + row) * 4 * H + unit;
#pragma unroll
            for (int q = 0; q < 4; ++q) st2(gp + q * H, a[q][0], a[q][1]);
            if constexpr (LSTM)
              st2(cseq + (((size_t)d * L + t) * N + row) * H + unit, st[mt][ut][half][0],
                  st[mt][ut][half][1]);
          }
        }
      }
    cluster_arrive_release();
    if (s + 1 < L) load_x(d == 0 ? s + 1 : L - 2 - s);
    cluster_wait_acquire();
  }
}

// ---------------------------------------------------------------- backward

struct BwdRecParams {
  const void* dout;   // (L, N, 2H) T
  const void* out;    // (L, N, 2H) T: the GRU's h_prev (LSTM: unused)
  const void* gates;  // (2, L, N, 4H) T
  const void* cseq;   // (2, L, N, H) T: the LSTM's cell state (GRU: unused)
  const void* whh;    // (2, H, G) T
  // the gate gradients (2, L N, G), f32 (simt) or bf16 (tc: the products'
  // operands, rounded to nearest even): GRU dxg = [dr, dz, dn] and dhg =
  // [dr, dz, dn r]; LSTM da = [di, df, dg, do] in dxg, dhg unused
  void* dxg;
  void* dhg;
  // tc: the bias gradients' partial sums of each row tile, (tiles, NB, 2, G)
  // f32, NB = 2 (GRU: dxg's, then dhg's) or 1 (LSTM: da's), from the
  // unrounded f32 values
  float* bpart;
  int L, N, H, U, R;  // U units a CTA, R rows a tile
};

// The simt backward's geometry at hidden width H: U = min(H, 32) units a
// CTA, clusters of CN = H / U; 256 threads, 8 warps as NJW along the units
// by NRW along the rows, a warp's lanes JL unit groups by 32 / JL row
// groups; a thread owns the partial of RT rows (row group rg, rg + NR, ...)
// by 8 units (4 jg .. +3 and H / 2 + 4 jg .. +3), R = NR RT rows a tile.
// The tile runs as NH = 2 row halves where a thread has more than one row
// (RT0 = ceil(RT / 2) of its rows in the first, R0 = NR RT0 rows), else as
// one. RT = CN below H = 256, where K56_RT256 sets it (a copy of this source
// may define it: chip_smoke.py's k56_bwd_simt_sweep).
#ifndef K56_RT256
#define K56_RT256 9
#endif

__host__ __device__ constexpr int simt_bwd_nr(int H) {
  return (8 / ((H / 8) / (H / 8 < 8 ? H / 8 : 8))) * (32 / (H / 8 < 8 ? H / 8 : 8));
}

template <int H>
struct SimtBwdGeom {
  static constexpr int U = H < 32 ? H : 32;
  static constexpr int CN = H / U;
  static constexpr int JG = H / 8;            // unit groups of 4 + 4 units
  static constexpr int JL = JG < 8 ? JG : 8;  // unit groups along a warp's lanes
  static constexpr int NJW = JG / JL;         // warps along the units
  static constexpr int NRW = 8 / NJW;         // warps along the rows
  static constexpr int NR = NRW * (32 / JL);  // row groups
  static constexpr int RT = H == 256 ? K56_RT256 : CN;
  static constexpr int R = NR * RT;
  static constexpr int NH = RT > 1 ? 2 : 1;             // row halves
  static constexpr int RT0 = NH == 2 ? (RT + 1) / 2 : RT;  // a thread's rows in the first
};

// The rows of a simt backward tile at H (0 where the design has no
// instantiation).
static int bwd_simt_rows(int H) {
  switch (H) {
    case 16: return SimtBwdGeom<16>::R;
    case 32: return SimtBwdGeom<32>::R;
    case 64: return SimtBwdGeom<64>::R;
    case 128: return SimtBwdGeom<128>::R;
    case 256: return SimtBwdGeom<256>::R;
    default: return 0;
  }
}

// Shared memory of a backward recurrence CTA, in bytes. simt: the W_hh
// slice [NG U][H] f32; the partials received, [half][CN][rows of the
// half][U] f32; the operand of the half being multiplied, [R0][NG U + 4]
// f32; the `full` and `empty` barriers of each half. tc: the partials
// [2][CN][R][U] f32, dh_s [R][U] f32 (GRU: dt z; LSTM: dc), the W_hh slice
// [H][NG U + 8] bf16 and the operand [R][NG U + 8] bf16.
struct BwdSmem {
  size_t recv, dh, w, dg, total;
};

__host__ __device__ inline BwdSmem bwd_smem(bool tc, int NG, int H, int U, int R) {
  const int cn = H / U, UG = NG * U;
  BwdSmem m;
  if (!tc) {
    const int nr = simt_bwd_nr(H), rt = R / nr, rt0 = rt > 1 ? (rt + 1) / 2 : rt;
    m.w = 0;
    m.recv = m.w + (size_t)UG * H * 4;
    m.dg = m.recv + (size_t)cn * R * U * 4;
    m.dh = m.dg + (size_t)nr * rt0 * (UG + 4) * 4;  // the barriers
    m.total = m.dh + 32;
    return m;
  }
  m.recv = 0;
  m.dh = m.recv + (size_t)2 * cn * R * U * 4;
  m.w = m.dh + (size_t)R * U * 4;
  m.dg = m.w + (size_t)H * (UG + 8) * 2;
  m.total = m.dg + (size_t)R * (UG + 8) * 2;
  return m;
}

// element e of a float4
__device__ __forceinline__ float f4_at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// four residuals of consecutive units from device memory into registers
// (read-only path, 16 bytes for f32, 8 for bf16); the loads of a half are
// issued during the other half's product and land while it runs
__device__ __forceinline__ float4 ld_res4(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ float4 ld_res4(const bf16* p) {
  uint32_t a, b;
  asm volatile("ld.global.nc.v2.b32 {%0, %1}, [%2];\n" : "=r"(a), "=r"(b) : "l"(p));
  return make_float4(__uint_as_float(a << 16), __uint_as_float(a & 0xffff0000u),
                     __uint_as_float(b << 16), __uint_as_float(b & 0xffff0000u));
}

// simt (exact f32 FMAs): the dataflow backward recurrence. A step of CTA c
// runs each row half h of its tile in turn (rows [h R0, ...)):
//   1. thread 0 waits on the half's `full` barrier for the peers' partials of
//      the last step and arms its next phase with the bytes to come; a CTA
//      barrier passes that on;
//   2. the gate math of the half's quads (4 consecutive units of a row:
//      quad g = tid + 256 j, row g / (U / 4)): dh = the carry (GRU: dt z;
//      LSTM: none) + the CN partials in rank order, the gate gradients to
//      device memory, the carry (GRU: dt z; LSTM: dc f) in registers; the
//      operand op(dg), [row][own gate column k], into the operand buffer
//      that the halves share; past a barrier it tells every peer on the
//      peer's `empty` barrier of the half that its slot is free again;
//   3. the product of the half's rows by its W_hh slice, a partial dh for
//      all H units: each partial one fmaf chain over k ascending from
//      0.0f; between its k ranges each thread issues the loads of the
//      residuals that the next gate math reads (the other half's, or the
//      next step's), which land while the product runs;
//   4. thread 0 waits on the half's `empty` barrier for every peer to have
//      read the last step's partials from its slot, a CTA barrier passes
//      that on, and each thread stores its partial into each owner's slot
//      [c][row][u] of the half: st.async into a peer, whose 16 bytes
//      complete on the peer's `full` barrier, a plain store into its own.
// A half's stores fly while the other half computes, no thread waits on its
// stores, and no cluster barrier sits in the time loop. `full` of a half
// completes once a step (phase s: the peers' bytes of step s, waited for at
// step s + 1; its own partials reach the gate math through the CTA's
// barriers); `empty` once a step from step 1 (phase s - 1: every peer has
// read step s - 1's partials, waited for before step s's stores). Neither
// runs a phase ahead: a peer stores step s + 1's partials only after its
// wait on `empty` phase s, which needs this CTA's signal of step s + 1,
// made after its own wait on `full` phase s; and it signals `empty` for
// step s + 1 only after its wait on `full` phase s, which needs this CTA's
// stores of step s, made after its own wait on `empty` phase s - 1.
template <typename T, bool LSTM, int H>
__global__ void __launch_bounds__(REC_THREADS, 1) bwd_rec_simt_kernel(const BwdRecParams p) {
  using Gm = SimtBwdGeom<H>;
  constexpr int NG = LSTM ? 4 : 3;
  constexpr int U = Gm::U, CN = Gm::CN, UG = NG * U, DS = UG + 4, G = NG * H;
  constexpr int R = Gm::R, RT = Gm::RT, NR = Gm::NR, JL = Gm::JL, NJW = Gm::NJW;
  constexpr int NH = Gm::NH, RT0 = Gm::RT0, R0 = NR * RT0;
  constexpr int UQ = U / 4;  // quads a row
  constexpr int QM = ((R0 > R - R0 || NH == 1 ? R0 : R - R0) * UQ + REC_THREADS - 1) /
                     REC_THREADS;  // quads of a half a thread, at most
  constexpr int NV = LSTM ? 7 : 6;  // residuals a unit
  constexpr int KG = UG / 4;        // 4-deep k groups of the product
  static_assert(Gm::NJW * Gm::NRW == REC_THREADS / 32 && UG % 4 == 0 && KG >= QM &&
                    (CN == 1 || H / 2 % U == 0),
                "thread layout");
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                // [UG][H]: W_hh[j][gate H + u0 + u] at k = gate U + u
  float* recv = ws + UG * H;       // [half][CN][rows of the half][U]: the partials
  float* opb = recv + CN * R * U;  // [R0][DS]: the operand of the half
  const BwdSmem m = bwd_smem(false, NG, H, U, R);
  const uint32_t bar0 = smem_u32(smem) + (uint32_t)m.dh;
  const uint32_t full_bar[2] = {bar0, bar0 + 8}, empty_bar[2] = {bar0 + 16, bar0 + 24};
  const int L = p.L, N = p.N;
  const uint32_t crank = cluster_ctarank();
  const int d = blockIdx.y;
  const int row0 = (blockIdx.x / CN) * R;
  const int u0 = crank * U;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* W = static_cast<const T*>(p.whh) + (size_t)d * H * G;
  const T* dout = static_cast<const T*>(p.dout);
  const T* out = static_cast<const T*>(p.out);
  const T* gates = static_cast<const T*>(p.gates);
  const T* cseq = static_cast<const T*>(p.cseq);
  float* dxg = static_cast<float*>(p.dxg) + (size_t)d * L * N * G;
  float* dhg = LSTM ? nullptr : static_cast<float*>(p.dhg) + (size_t)d * L * N * G;

  // stage this CTA's W_hh rows: W_hh[j][gate H + u0 + u] for its own gate
  // columns k = gate U + u, [k][j]
  for (int i = tid; i < H * (UG / 4); i += REC_THREADS) {
    const int j = i % H, k4 = (i / H) * 4;
    const int gate = k4 / U, u = k4 % U;
    float v[4];
    Op<T>::load4(W + (size_t)j * G + gate * H + u0 + u, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) ws[(k4 + e) * H + j] = v[e];
  }
  if (tid == 0 && CN > 1) {
    for (int h = 0; h < NH; ++h) {
      mbar_init(full_bar[h], 1);
      mbar_init(empty_bar[h], CN - 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // phase 0: the peers' partials of step 0
    for (int h = 0; h < NH; ++h)
      if (L > 1) mbar_expect_tx(full_bar[h], (CN - 1) * (h ? R - R0 : R0) * U * 4);
  }

  // the product's tile: rows rg + i NR, units jo[0] .. +3 and jo[1] .. +3
  const int jg = (warp % NJW) * JL + lane % JL;
  const int rg = (warp / NJW) * (32 / JL) + lane / JL;
  const int jo[2] = {4 * jg, H / 2 + 4 * jg};

  // the residuals of the half that the next gate math reads, by quad: GRU
  // r, z, n, hg_n, dout, h_prev; LSTM i, f, g, o, dout, c, c_prev; zeros
  // past N and before the direction's first step
  float4 v[QM][NV];
  auto load_quad = [&](int s, int h, int j) {
    const int g = tid + REC_THREADS * j;
    const int t = d == 0 ? L - 1 - s : s;
    const bool has_prev = d == 0 ? t > 0 : t < L - 1;
    const int tp = d == 0 ? t - 1 : t + 1;
    const int row = row0 + h * R0 + g / UQ, unit = u0 + 4 * (g % UQ);
    const float4 z4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int e = 0; e < NV; ++e) v[j][e] = z4;
    if (g < (h ? R - R0 : R0) * UQ && row < N) {
      const T* gt = gates + (((size_t)d * L + t) * N + row) * 4 * H + unit;
      v[j][0] = ld_res4(gt);
      v[j][1] = ld_res4(gt + H);
      v[j][2] = ld_res4(gt + 2 * H);
      v[j][3] = ld_res4(gt + 3 * H);
      v[j][4] = ld_res4(dout + ((size_t)t * N + row) * 2 * H + d * H + unit);
      if constexpr (LSTM) {
        v[j][5] = ld_res4(cseq + (((size_t)d * L + t) * N + row) * H + unit);
        if (has_prev) v[j][6] = ld_res4(cseq + (((size_t)d * L + tp) * N + row) * H + unit);
      } else {
        if (has_prev) v[j][5] = ld_res4(out + ((size_t)tp * N + row) * 2 * H + d * H + unit);
      }
    }
  };

  float carry[NH][QM][4];  // GRU: dt z; LSTM: dc f; of the last step, f32
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int j = 0; j < QM; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) carry[h][j][e] = 0.0f;
#pragma unroll
  for (int j = 0; j < QM; ++j) load_quad(0, 0, j);
  cluster_sync_all();  // every CTA of the cluster has staged W and set up its barriers

  for (int s = 0; s < L; ++s) {
    // direction-local time runs backwards: L-1 .. 0
    const int t = d == 0 ? L - 1 - s : s;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const int rh = (h ? RT - RT0 : RT0) * NR;  // the half's rows
      const int ni = h ? RT - RT0 : RT0;         // and a thread's of them
      float* rcv = recv + h * CN * R0 * U;       // its partials
      // the residuals that the gate math after this half's reads
      const int hn = h + 1 < NH ? h + 1 : 0, sn = h + 1 < NH ? s : s + 1;
      // 1) every partial of the half's last step is here
      if (s > 0) {
        if (CN > 1 && tid == 0) {
          mbar_wait(full_bar[h], (s - 1) & 1);
          if (s + 1 < L) mbar_expect_tx(full_bar[h], (CN - 1) * rh * U * 4);
        }
        __syncthreads();
      }

      // 2) the gate gradients of the half's quads
      float og4[QM][NG][4];  // the operand of each quad's own gate columns
#pragma unroll
      for (int j = 0; j < QM; ++j) {
        const int g = tid + REC_THREADS * j;
        if (g >= rh * UQ) break;
        const int rl = g / UQ, u = 4 * (g % UQ), row = row0 + h * R0 + rl;
        float4 part[CN];  // the partials of ranks 0 .. CN-1
        if (s > 0) {
#pragma unroll
          for (int c = 0; c < CN; ++c)
            part[c] = *reinterpret_cast<const float4*>(rcv + (c * rh + rl) * U + u);
        }
        float dx4[4][4], dh4[4][4];  // [gate][unit]: the columns of dxg and the operand
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dh = 0.0f;
          if (s > 0) {
            if constexpr (!LSTM) dh = carry[h][j][e];
#pragma unroll
            for (int c = 0; c < CN; ++c) dh += f4_at(part[c], e);
          }
          const float dt = f4_at(v[j][4], e) + dh;
          if constexpr (LSTM) {
            const float ig = f4_at(v[j][0], e), fg = f4_at(v[j][1], e);
            const float gg = f4_at(v[j][2], e), og = f4_at(v[j][3], e);
            const float tc = tanhf(f4_at(v[j][5], e));
            const float dc = dt * og * (1.0f - tc * tc) + carry[h][j][e];
            dx4[0][e] = dc * gg * ig * (1.0f - ig);
            dx4[1][e] = dc * f4_at(v[j][6], e) * fg * (1.0f - fg);
            dx4[2][e] = dc * ig * (1.0f - gg * gg);
            dx4[3][e] = dt * tc * og * (1.0f - og);
            carry[h][j][e] = __fmul_rn(dc, fg);
#pragma unroll
            for (int k = 0; k < 4; ++k) dh4[k][e] = dx4[k][e];
          } else {
            const float rg_ = f4_at(v[j][0], e), zg = f4_at(v[j][1], e);
            const float ng = f4_at(v[j][2], e), hgn = f4_at(v[j][3], e);
            const float dz = dt * (f4_at(v[j][5], e) - ng) * zg * (1.0f - zg);
            const float dn = dt * (1.0f - zg) * (1.0f - ng * ng);
            const float dr = dn * hgn * rg_ * (1.0f - rg_);
            dx4[0][e] = dh4[0][e] = dr;
            dx4[1][e] = dh4[1][e] = dz;
            dx4[2][e] = dn;
            dh4[2][e] = dn * rg_;
            carry[h][j][e] = __fmul_rn(dt, zg);
          }
        }
        if (row < N) {
          const size_t o = ((size_t)t * N + row) * G + u0 + u;
#pragma unroll
          for (int k = 0; k < NG; ++k)
            *reinterpret_cast<float4*>(dxg + o + k * H) =
                make_float4(dx4[k][0], dx4[k][1], dx4[k][2], dx4[k][3]);
          if constexpr (!LSTM) {
#pragma unroll
            for (int k = 0; k < NG; ++k)
              *reinterpret_cast<float4*>(dhg + o + k * H) =
                  make_float4(dh4[k][0], dh4[k][1], dh4[k][2], dh4[k][3]);
          }
        }
#pragma unroll
        for (int k = 0; k < NG; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) og4[j][k][e] = Op<T>::operand(dh4[k][e]);
      }
      if (s + 1 == L) {  // dh of the direction's first step is not needed
        if (h + 1 < NH) {
#pragma unroll
          for (int j = 0; j < QM; ++j) load_quad(s, hn, j);
        }
        continue;
      }
      // the other half's product has read the operand buffer (past step
      // 0, the barrier after the wait above says so)
      if (s == 0 && h > 0) __syncthreads();
#pragma unroll
      for (int j = 0; j < QM; ++j) {
        const int g = tid + REC_THREADS * j;
        if (g >= rh * UQ) break;
#pragma unroll
        for (int k = 0; k < NG; ++k)
          *reinterpret_cast<float4*>(opb + (g / UQ) * DS + k * U + 4 * (g % UQ)) =
              make_float4(og4[j][k][0], og4[j][k][1], og4[j][k][2], og4[j][k][3]);
      }
      __syncthreads();  // the operand is complete and the half's partials are read
      if (CN > 1 && s > 0 && tid < CN && tid != (int)crank) mbar_arrive_remote(empty_bar[h], tid);

      // 3) the half's partial dh of this CTA's gate columns, for all H
      // units; the residuals of the next gate math, one quad before each of
      // QM k ranges
      float acc[RT0][8];
#pragma unroll
      for (int i = 0; i < RT0; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < QM; ++j) {
        load_quad(sn, hn, j);
#pragma unroll 4
        for (int kg = j * KG / QM; kg < (j + 1) * KG / QM; ++kg) {
          const int k = 4 * kg;
          float4 w[4][2];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              w[kk][e] = *reinterpret_cast<const float4*>(ws + (k + kk) * H + jo[e]);
#pragma unroll
          for (int i = 0; i < RT0; ++i) {
            if (i >= ni) break;
            const float4 av = *reinterpret_cast<const float4*>(opb + (rg + i * NR) * DS + k);
            const float a[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                acc[i][4 * e + 0] = fmaf(a[kk], w[kk][e].x, acc[i][4 * e + 0]);
                acc[i][4 * e + 1] = fmaf(a[kk], w[kk][e].y, acc[i][4 * e + 1]);
                acc[i][4 * e + 2] = fmaf(a[kk], w[kk][e].z, acc[i][4 * e + 2]);
                acc[i][4 * e + 3] = fmaf(a[kk], w[kk][e].w, acc[i][4 * e + 3]);
              }
          }
        }
      }

      // 4) every peer has read the half's last partials from its slot of
      // this CTA: the half's partials to the CTA that owns each unit, slot
      // [crank][row][u]
      if (CN > 1 && s > 0) {
        if (tid == 0) mbar_wait(empty_bar[h], (s - 1) & 1);
        __syncthreads();
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t own = (uint32_t)(jo[e] / U);
        const int ju = jo[e] % U;
#pragma unroll
        for (int i = 0; i < RT0; ++i) {
          if (i >= ni) break;
          const uint32_t la = smem_u32(rcv + (crank * rh + rg + i * NR) * U + ju);
          const uint4 val = make_uint4(__float_as_uint(acc[i][4 * e]),
                                       __float_as_uint(acc[i][4 * e + 1]),
                                       __float_as_uint(acc[i][4 * e + 2]),
                                       __float_as_uint(acc[i][4 * e + 3]));
          if (own == crank)
            st_shared_v4(la, val);
          else
            st_async_v4(la, full_bar[h], own, val);
        }
      }
    }
  }
  cluster_sync_all();  // no CTA leaves while a peer may still reach its shared memory
}

// tc (bf16): the mma.sync backward recurrence. Per step the gate gradients
// of a (row, unit) pair from the residuals go to device memory as bf16
// copies, each thread sums its f32 values for the bias gradients, and the
// rounded values form the operand [row][own gate column k] of the partial
// dh; each warp one 16-row tile by H / 4 units; the partials reach their
// owners by 8-byte remote stores, one cluster barrier a step. NT: n8 tiles
// a warp (H / 32).
template <int NT, bool LSTM>
__global__ void __launch_bounds__(REC_THREADS, 1) bwd_rec_tc_kernel(const BwdRecParams p) {
  constexpr int NG = LSTM ? 4 : 3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = p.H, G = NG * H, L = p.L, N = p.N, U = p.U, R = p.R, UG = NG * U;
  const BwdSmem m = bwd_smem(true, NG, H, U, R);
  float* recv = reinterpret_cast<float*>(smem_raw + m.recv);
  float* dh_s = reinterpret_cast<float*>(smem_raw + m.dh);
  const uint32_t crank = cluster_ctarank(), cn = cluster_nctarank();
  const int d = blockIdx.y;
  const int row0 = (blockIdx.x / cn) * R;
  const int u0 = crank * U;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* W = static_cast<const bf16*>(p.whh) + (size_t)d * H * G;
  const bf16* dout = static_cast<const bf16*>(p.dout);
  const bf16* out = static_cast<const bf16*>(p.out);
  const bf16* gates = static_cast<const bf16*>(p.gates);
  const bf16* cseq = static_cast<const bf16*>(p.cseq);
  bf16* dxg = static_cast<bf16*>(p.dxg) + (size_t)d * L * N * G;
  bf16* dhg = LSTM ? nullptr : static_cast<bf16*>(p.dhg) + (size_t)d * L * N * G;
  // this thread's share of the bias gradients: its unit u = tid % U
  // (REC_THREADS % U == 0), its rows, every step in order; dxg's NG columns,
  // then the GRU's dhg's
  constexpr int NS = LSTM ? 4 : 6;
  float csum[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) csum[k] = 0.0f;
  const int DS = UG + 8;  // row stride of the gate-gradient operand

  // stage this CTA's W_hh rows: W_hh[j][gate H + u0 + u] for its own gate
  // columns k = gate U + u
  bf16* wb = reinterpret_cast<bf16*>(smem_raw + m.w);  // [H][DS]
  for (int i = tid; i < H * (UG / 8); i += REC_THREADS) {
    const int j = i / (UG / 8), k8 = (i % (UG / 8)) * 8;
    const int gate = k8 / U, u = k8 % U;
    *reinterpret_cast<uint4*>(wb + j * DS + k8) = __ldg(reinterpret_cast<const uint4*>(
        W + (size_t)j * G + gate * H + u0 + u));
  }
  cluster_sync_all();  // every CTA of the cluster is running and has staged W

  for (int s = 0; s < L; ++s) {
    // direction-local time runs backwards: L-1 .. 0
    const int t = d == 0 ? L - 1 - s : s;
    const bool has_prev = d == 0 ? t > 0 : t < L - 1;
    const int tp = d == 0 ? t - 1 : t + 1;
    const float* rcv = recv + (size_t)((s + 1) & 1) * cn * R * U;  // step s - 1's

    // 1) the gate gradients of this step, (row, unit) pairs in batches of
    // EB a thread, every load of a batch issued before its first use
    constexpr int EB = 4;
    constexpr int NV = LSTM ? 7 : 6;
    for (int q0 = tid; q0 < R * U; q0 += EB * REC_THREADS) {
      // GRU: r, z, n, hg_n, dout, h_prev; LSTM: i, f, g, o, dout, c, c_prev
      float v[EB][NV];
#pragma unroll
      for (int b = 0; b < EB; ++b) {
        const int q = q0 + b * REC_THREADS, r = q / U, row = row0 + r;
#pragma unroll
        for (int e = 0; e < NV; ++e) v[b][e] = 0.0f;
        if (q < R * U && row < N) {
          const int unit = u0 + q % U;
          const bf16* gt = gates + (((size_t)d * L + t) * N + row) * 4 * H + unit;
          v[b][0] = Op<bf16>::to_f(gt[0]);
          v[b][1] = Op<bf16>::to_f(gt[H]);
          v[b][2] = Op<bf16>::to_f(gt[2 * H]);
          v[b][3] = Op<bf16>::to_f(gt[3 * H]);
          v[b][4] = Op<bf16>::to_f(dout[((size_t)t * N + row) * 2 * H + d * H + unit]);
          if constexpr (LSTM) {
            v[b][5] = Op<bf16>::to_f(cseq[(((size_t)d * L + t) * N + row) * H + unit]);
            if (has_prev)
              v[b][6] = Op<bf16>::to_f(cseq[(((size_t)d * L + tp) * N + row) * H + unit]);
          } else {
            if (has_prev)
              v[b][5] = Op<bf16>::to_f(out[((size_t)tp * N + row) * 2 * H + d * H + unit]);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < EB; ++b) {
        const int q = q0 + b * REC_THREADS;
        if (q >= R * U) break;
        const int r = q / U, u = q % U, row = row0 + r, unit = u0 + u;
        float dh = 0.0f;
        if (s > 0) {
          if constexpr (!LSTM) dh = dh_s[q];
          for (uint32_t c = 0; c < cn; ++c) dh += rcv[(size_t)c * R * U + q];
        }
        const float dt = v[b][4] + dh;
        float dx4[4], dh4[4];  // this unit's columns of dxg and of the operand
        if constexpr (LSTM) {
          const float ig = v[b][0], fg = v[b][1], gg = v[b][2], og = v[b][3];
          const float tc = tanhf(v[b][5]);
          const float dc = dt * og * (1.0f - tc * tc) + (s > 0 ? dh_s[q] : 0.0f);
          dx4[0] = dc * gg * ig * (1.0f - ig);
          dx4[1] = dc * v[b][6] * fg * (1.0f - fg);
          dx4[2] = dc * ig * (1.0f - gg * gg);
          dx4[3] = dt * tc * og * (1.0f - og);
          dh_s[q] = dc * fg;
#pragma unroll
          for (int k = 0; k < 4; ++k) dh4[k] = dx4[k];
        } else {
          const float rg = v[b][0], zg = v[b][1], ng = v[b][2], hgn = v[b][3];
          const float dz = dt * (v[b][5] - ng) * zg * (1.0f - zg);
          const float dn = dt * (1.0f - zg) * (1.0f - ng * ng);
          const float dr = dn * hgn * rg * (1.0f - rg);
          dx4[0] = dh4[0] = dr;
          dx4[1] = dh4[1] = dz;
          dx4[2] = dn;
          dh4[2] = dn * rg;
          dh_s[q] = dt * zg;
        }
        if (row < N) {
          const size_t o = ((size_t)t * N + row) * G + unit;
#pragma unroll
          for (int k = 0; k < NG; ++k) st1(dxg + o + k * H, dx4[k]);
          if constexpr (!LSTM) {
#pragma unroll
            for (int k = 0; k < NG; ++k) st1(dhg + o + k * H, dh4[k]);
          }
#pragma unroll
          for (int k = 0; k < NG; ++k) {
            csum[k] += dx4[k];
            if constexpr (!LSTM) csum[NG + k] += dh4[k];
          }
        }
        bf16* dg = reinterpret_cast<bf16*>(smem_raw + m.dg) + r * DS + u;
#pragma unroll
        for (int k = 0; k < NG; ++k) dg[k * U] = __float2bfloat16_rn(dh4[k]);
      }
    }
    if (s + 1 == L) break;  // dh of the direction's first step is not needed
    __syncthreads();

    // 2) the partial dh over this CTA's gate columns, for all H units, sent
    // to the CTA that owns each unit: slot [step parity][this rank][row][u]
    float* snd = recv + (size_t)(s & 1) * cn * R * U + (size_t)crank * R * U;
    const bf16* dg = reinterpret_cast<const bf16*>(smem_raw + m.dg);
    const int mt = warp & 1, nc = (warp >> 1) * (H / 4);
    const int g = lane >> 2, t4 = lane & 3;
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
    for (int k0 = 0; k0 < UG; k0 += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, smem_u32(dg + (mt * 16 + (lane & 15)) * DS + k0 + (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r4[4];
        ldmatrix_x4(r4, smem_u32(wb + (nc + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * DS +
                                 k0 + ((lane >> 3) & 1) * 8));
        const uint32_t b0[2] = {r4[0], r4[1]}, b1[2] = {r4[2], r4[3]};
        mma_bf16(acc[2 * np], a, b0);
        mma_bf16(acc[2 * np + 1], a, b1);
      }
      if constexpr (NT % 2 == 1) {
        uint32_t b[2];
        ldmatrix_x2(b, smem_u32(wb + (nc + (NT - 1) * 8 + (lane & 7)) * DS + k0 +
                                ((lane >> 3) & 1) * 8));
        mma_bf16(acc[NT - 1], a, b);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int j = nc + nt * 8 + 2 * t4;
      const uint32_t dst = (uint32_t)(j / U);
      const int ju = j % U;
#pragma unroll
      for (int half = 0; half < 2; ++half)
        st_cluster_v2(smem_u32(snd + (mt * 16 + g + 8 * half) * U + ju), dst,
                      acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
    cluster_arrive_release();
    cluster_wait_acquire();
  }
  // the tile's bias-gradient partials: the REC_THREADS / U threads of a
  // unit add theirs in thread order through shared memory (recv, the dh
  // partials' slots: the last step sends nothing, and every peer's stores
  // into them completed before the last step's cluster barrier)
  float* red = recv;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NS; ++k) red[k * REC_THREADS + tid] = csum[k];
  __syncthreads();
  const int tile = blockIdx.x / cn;
  for (int i = tid; i < NS * U; i += REC_THREADS) {
    const int k = i / U, u = i % U;
    float sum = 0.0f;
    for (int j = 0; j < REC_THREADS / U; ++j) sum += red[k * REC_THREADS + j * U + u];
    p.bpart[(((size_t)tile * (NS / NG) + k / NG) * 2 + d) * G + (k % NG) * H + u0 + u] = sum;
  }
}

// ---------------------------------------------------------------- launch

// The rows of the simt forward's default tile at H (0 where the design has
// no instantiation).
static int fwd_simt_rows(int H) {
  switch (H) {
    case 16: return SimtFwdGeom<16, 8>::R;
    case 32: return SimtFwdGeom<32, 8>::R;
    case 64: return SimtFwdGeom<64, 8>::R;
    case 128: return SimtFwdGeom<128, 8>::R;
    case 256: return SimtFwdGeom<256, K46_FWD_RT256>::R;
    default: return 0;
  }
}

// Shared memory of a forward recurrence CTA, in bytes. simt: the W_hh slice
// [H][NG][U] f32, h of the tile's rows [H][R] f32 and the `full` and `empty`
// barriers of each pass; tc: the W_hh slice [NG U][H + 8] and h
// [2][TC_FWD_ROWS][H + 8], bf16.
static size_t fwd_smem(bool tc, int NG, int H, int U, int R) {
  if (tc) return (size_t)(NG * U + 2 * TC_FWD_ROWS) * (H + 8) * sizeof(bf16);
  return (size_t)H * NG * U * 4 + (size_t)H * R * 4 + 32;
}

// The simt forward kernel at H and R rows a tile: the default tile at every
// H, and at H = 256 (training only) also the tile of one more row a thread
template <typename T, bool LSTM, bool INFER>
static const void* fwd_simt_at(int H, int R) {
  if constexpr (!INFER) {
    if (H == 256 && R == SimtFwdGeom<256, K46_FWD_RT256 + 1>::R)
      return (const void*)fwd_rec_simt_kernel<T, LSTM, 256, K46_FWD_RT256 + 1>;
  }
  if (R != fwd_simt_rows(H)) return nullptr;
  switch (H) {
    case 16: return (const void*)fwd_rec_simt_kernel<T, LSTM, 16, 8, INFER>;
    case 32: return (const void*)fwd_rec_simt_kernel<T, LSTM, 32, 8, INFER>;
    case 64: return (const void*)fwd_rec_simt_kernel<T, LSTM, 64, 8, INFER>;
    case 128: return (const void*)fwd_rec_simt_kernel<T, LSTM, 128, 8, INFER>;
    case 256: return (const void*)fwd_rec_simt_kernel<T, LSTM, 256, K46_FWD_RT256, INFER>;
    default: return nullptr;
  }
}

// The forward recurrence kernel of the cell for design 0 = simt (U =
// min(H, 32), R = fwd_simt_rows(H), or at H = 256 the tile of one more row
// a thread; f32 at every H the design takes and bf16 at H = 16, the one
// shape tc refuses; INFER: bf16 at every H, the default tile) or 1 = tc
// (bf16, R = TC_FWD_ROWS, not INFER); nullptr where the design does not
// take H, U, R and the operand type.
template <bool LSTM, bool INFER>
static const void* fwd_rec_kernel_of(int design, int dtype, int H, int U, int R) {
  if (!cluster_ok(H, U)) return nullptr;
  if (design == 1) {
    if constexpr (!INFER) {
      if (dtype == 1 && R == TC_FWD_ROWS && U == 64)
        return (const void*)fwd_rec_tc_kernel<LSTM, 64>;
      if (dtype == 1 && R == TC_FWD_ROWS && U == 32)
        return (const void*)fwd_rec_tc_kernel<LSTM, 32>;
    }
    return nullptr;
  }
  if (design != 0 || U != (H < 32 ? H : 32)) return nullptr;
  if constexpr (INFER) {
    return dtype == 1 ? fwd_simt_at<bf16, LSTM, true>(H, R) : nullptr;
  } else {
    if (dtype == 1)
      return H == 16 && R == fwd_simt_rows(16)
                 ? (const void*)fwd_rec_simt_kernel<bf16, LSTM, 16, 8> : nullptr;
    return dtype == 0 ? fwd_simt_at<float, LSTM, false>(H, R) : nullptr;
  }
}

// The forward recurrence, both directions, in clusters of H / U CTAs of the
// kernel fwd_rec_kernel_of picks for R rows a tile. dtype 0 = f32, 1 = bf16.
// INFER (simt only): no residuals, h_n to rp.hn.
template <bool LSTM, bool INFER = false>
static int fwd_rec_run(int design, int dtype, const FwdRecParams& rp, int U, int R,
                       cudaStream_t s) {
  const void* k = fwd_rec_kernel_of<LSTM, INFER>(design, dtype, rp.H, U, R);
  if (k == nullptr || rp.L < 1 || rp.N < 1) return (int)cudaErrorInvalidValue;
  FwdRecParams q = rp;
  return launch_cluster(k, &q, rp.H / U, (rp.N + R - 1) / R,
                        fwd_smem(design == 1, LSTM ? 4 : 3, rp.H, U, R), s);
}

// How many clusters of CN CTAs of `kernel` with `smem` bytes of dynamic
// shared memory a CTA the card holds at once (cudaOccupancyMaxActiveClusters).
static int cluster_occupancy(const void* kernel, int cn, size_t smem, int* clusters) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cn, 2, 1);
  cfg.blockDim = dim3(REC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cn;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// How many clusters of the forward recurrence that fwd_rec_run launches at
// design, dtype, H and U with its default tile (simt: fwd_simt_rows(H); tc:
// TC_FWD_ROWS) the card holds at once, its shared memory a CTA and its rows
// a tile. Launches nothing.
template <bool LSTM>
static int fwd_rec_occupancy(int design, int dtype, int H, int U, int* clusters,
                             int* smem_bytes, int* rows) {
  const int R = design == 1 ? TC_FWD_ROWS : fwd_simt_rows(H);
  const void* k = fwd_rec_kernel_of<LSTM, false>(design, dtype, H, U, R);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(design == 1, LSTM ? 4 : 3, H, U, R);
  *smem_bytes = (int)smem;
  *rows = R;
  return cluster_occupancy(k, H / U, smem, clusters);
}

// The simt backward kernel of the cell at H for the operand type: f32 at
// every H the design takes, bf16 at H = 16 (the one shape tc refuses).
template <bool LSTM>
static const void* bwd_simt_kernel(int H, int dtype) {
  if (dtype == 1) return H == 16 ? (const void*)bwd_rec_simt_kernel<bf16, LSTM, 16> : nullptr;
  if (dtype != 0) return nullptr;
  switch (H) {
    case 16: return (const void*)bwd_rec_simt_kernel<float, LSTM, 16>;
    case 32: return (const void*)bwd_rec_simt_kernel<float, LSTM, 32>;
    case 64: return (const void*)bwd_rec_simt_kernel<float, LSTM, 64>;
    case 128: return (const void*)bwd_rec_simt_kernel<float, LSTM, 128>;
    case 256: return (const void*)bwd_rec_simt_kernel<float, LSTM, 256>;
    default: return nullptr;
  }
}

// The backward recurrence kernel of the cell for design 0 = simt (U =
// min(H, 32), bwd_simt_rows(H) rows a tile) or 1 = tc (bf16, TC_BWD_ROWS),
// with its rows a tile in *R; nullptr where the design does not take H, U
// and the operand type.
template <bool LSTM>
static const void* bwd_rec_kernel_of(int design, int dtype, int H, int U, int* R) {
  if (!cluster_ok(H, U)) return nullptr;
  if (design == 1) {
    if (dtype != 1 || H % 32 != 0 || REC_THREADS % U != 0) return nullptr;
    *R = TC_BWD_ROWS;
    switch (H / 32) {
      case 1: return (const void*)bwd_rec_tc_kernel<1, LSTM>;
      case 2: return (const void*)bwd_rec_tc_kernel<2, LSTM>;
      case 4: return (const void*)bwd_rec_tc_kernel<4, LSTM>;
      case 8: return (const void*)bwd_rec_tc_kernel<8, LSTM>;
      default: return nullptr;
    }
  }
  if (design != 0 || U != (H < 32 ? H : 32)) return nullptr;
  *R = bwd_simt_rows(H);
  return bwd_simt_kernel<LSTM>(H, dtype);
}

// The backward recurrence, both directions, in clusters of H / U CTAs of
// the kernel bwd_rec_kernel_of picks; kp.R must be its rows a tile.
template <bool LSTM>
static int bwd_rec_run(int design, int dtype, const BwdRecParams& kp, cudaStream_t s) {
  constexpr int NG = LSTM ? 4 : 3;
  int R = 0;
  const void* k = bwd_rec_kernel_of<LSTM>(design, dtype, kp.H, kp.U, &R);
  if (k == nullptr || kp.L < 1 || kp.N < 1 || kp.R != R ||
      (design == 1 && kp.bpart == nullptr))
    return (int)cudaErrorInvalidValue;
  BwdRecParams q = kp;
  return launch_cluster(k, &q, kp.H / kp.U, (kp.N + R - 1) / R,
                        bwd_smem(design == 1, NG, kp.H, kp.U, R).total, s);
}

// How many clusters of the backward recurrence that bwd_rec_run launches at
// design, dtype, H and U the card holds at once, its shared memory a CTA and
// its rows a tile. Launches nothing.
template <bool LSTM>
static int bwd_rec_occupancy(int design, int dtype, int H, int U, int* clusters,
                             int* smem_bytes, int* rows) {
  int R = 0;
  const void* k = bwd_rec_kernel_of<LSTM>(design, dtype, H, U, &R);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(design == 1, LSTM ? 4 : 3, H, U, R).total;
  *smem_bytes = (int)smem;
  *rows = R;
  return cluster_occupancy(k, H / U, smem, clusters);
}
