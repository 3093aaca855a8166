// The cluster recurrences of the RNN training kernels, written once for both
// cells and instantiated by each layer's source: bigru_train.cu (K4, K5; the
// GRU, NG = 3 gates r, z, n) and bilstm_train.cu (K6; the LSTM, NG = 4 gates
// i, f, g, o). The gate count, the gate math and what a step keeps are the
// only differences; the layout of W_hh in shared memory, the exchange across
// the cluster and the thread layouts are the same code. birnn_simt.cu
// instantiates the simt forward once more for inference (INFER: K1's and
// K2's simt design): no residuals, each direction's last h to h_n.
//
//   forward (fwd_rec_simt_kernel, fwd_rec_tc_kernel): both directions at
//     once from the projection xg (2, L N, G) f32. A cluster of CN = H / U
//     CTAs runs one (row tile, direction); CTA c owns the hidden units
//     [c U, (c+1) U) of every gate and keeps its NG U columns of W_hh in
//     shared memory for all L steps. The cell's state (the GRU's h, the
//     LSTM's c) stays f32 in the registers of the one thread that owns the
//     (row, unit). Per step each CTA writes out and the residuals (GRU r, z,
//     n, hg_n; LSTM i, f, g, o and c) and sends its new h, rounded to the
//     operand type, to every CTA of the cluster (distributed shared memory,
//     one cluster barrier a step).
//   backward (bwd_rec_kernel): both directions at once over reversed time,
//     carrying dh (and the LSTM's dc). Per step the gate gradients of a
//     (row, unit) from the residuals go to device memory for the products
//     (simt: f32 scratch, whose column sums the simt products take beside
//     the weight gradients; tc: bf16 copies, rounded to nearest even, that
//     TMA feeds to wgmma, while each thread sums its f32 values for the bias
//     gradients over its rows and steps in order, and the CTA writes its
//     tile's partial sums, added in tile order by gemm_sum_slices) and,
//     rounded to the operand type, to shared memory as the operand of
//     dh = op(dg) W_hh^T. That contraction runs over NG H, so CTA
//     c multiplies its own NG U gate columns by its W_hh rows into a partial
//     dh for all H units and sends each CTA the U columns it owns; the owner
//     adds the CN partials in rank order (a reduce-scatter, deterministic).
//     The GRU keeps dt z (its carry term) in the dh slot; the LSTM's dh has no
//     carry term, and the slot holds dc, which never leaves its owner.
//   Rows >= N (the ragged last tile) read zeros and store nothing.
//
// Routes (ops/bigru_vjp.py::k45_plan picks one per call, for either cell):
//   simt: exact f32 FMAs (no TF32), accurate expf and tanhf. Forward: a
//     thread owns 4 rows x UPT units of every gate, R = 1024 UPT / U rows a
//     tile (UPT = 2 where the tile fits in shared memory, else 1: the LSTM at
//     H = 256); W_hh slice [k][gate][u] f32, h double-buffered [k][row] f32.
//     Backward: a thread owns 4 rows x 8 units of the partial; R rows a tile,
//     8192 / H or fewer where that does not fit (threads past R idle).
//   tc (bf16): mma.sync.m16n8k16 with f32 sums, fragments by ldmatrix
//     (mma_tile.cuh). Forward: a cluster recurrence with the residual
//     stores, 64 rows a tile, W_hh gate-interleaved so a thread's
//     accumulators hold every gate of its units. Backward: 32 rows a tile,
//     W_hh staged [unit j][own gate column k] and dg [row][k], both
//     k-contiguous bf16, each warp one 16-row tile by H / 4 units.
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
template <int UPT, typename T>
__device__ __forceinline__ void st_units(T* p, const float (&v)[UPT]) {
  if constexpr (UPT == 2)
    st2(p, v[0], v[1]);
  else
    st1(p, v[0]);
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

// simt: U units a CTA, R = 1024 UPT / U rows a tile; thread (rg, ug) owns
// rows 4 rg .. 4 rg + 3 and units UPT ug .. UPT ug + UPT - 1 (local) of
// every gate. INFER (K1's and K2's simt design, birnn_simt.cu) keeps no
// residuals (gates, cseq unused) and writes the f32 h of the direction's last
// step to hn; the arithmetic and the out stores are the training forward's.
template <typename T, bool LSTM, int U, int UPT, bool INFER = false>
__global__ void __launch_bounds__(REC_THREADS, 1) fwd_rec_simt_kernel(const FwdRecParams p) {
  constexpr int NG = LSTM ? 4 : 3;
  constexpr int R = 1024 * UPT / U;
  constexpr int UW = U / (8 * UPT);  // warps along the units, 8 lanes each
  static_assert(U % (8 * UPT) == 0 && (R / 4) * (U / UPT) == REC_THREADS, "thread layout");
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, G = NG * H, L = p.L, N = p.N;
  float* ws = smem;                          // [H][NG U]: W_hh[k][gate H + u0 + u]
  float* hs = smem + (size_t)H * NG * U;     // [2][H][R]: the h operand
  const uint32_t crank = cluster_ctarank(), cn = cluster_nctarank();
  const int d = blockIdx.y;
  const int row0 = (blockIdx.x / cn) * R;
  const int u0 = crank * U;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ug = (warp % UW) * 8 + (lane & 7);
  const int rg = (warp / UW) * 4 + (lane >> 3);
  const T* W = static_cast<const T*>(p.whh) + (size_t)d * H * G;
  T* out = static_cast<T*>(p.out);
  T* gates = static_cast<T*>(p.gates);
  T* cseq = static_cast<T*>(p.cseq);

  for (int i = tid; i < H * NG * (U / 4); i += REC_THREADS) {
    const int u4 = i % (U / 4), gate = (i / (U / 4)) % NG, k = i / (NG * (U / 4));
    float v[4];
    Op<T>::load4(W + (size_t)k * G + gate * H + u0 + u4 * 4, v);
    *reinterpret_cast<float4*>(ws + k * NG * U + gate * U + u4 * 4) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
  for (int i = tid; i < H * R; i += REC_THREADS) hs[i] = 0.0f;  // h0 = 0

  float bhn[UPT];
#pragma unroll
  for (int e = 0; e < UPT; ++e)
    bhn[e] = LSTM ? 0.0f : p.bhh[(size_t)d * G + 2 * H + u0 + UPT * ug + e];
  float st[4][UPT];  // GRU: h; LSTM: c; f32, of rows i, units e
  float xc[4][NG][UPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < UPT; ++e) st[i][e] = 0.0f;

  auto load_x = [&](int t) {
    const float* xt = p.xg + ((size_t)d * L + t) * N * G;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + rg * 4 + i;
#pragma unroll
      for (int gate = 0; gate < NG; ++gate) {
        const float* src = xt + (size_t)row * G + gate * H + u0 + UPT * ug;
        if constexpr (UPT == 2) {
          const float2 v = row < N ? ld_nc_f2(src) : make_float2(0.0f, 0.0f);
          xc[i][gate][0] = v.x;
          xc[i][gate][1] = v.y;
        } else {
          xc[i][gate][0] = row < N ? gm_ld1(src) : 0.0f;
        }
      }
    }
  };

  load_x(d == 0 ? 0 : L - 1);
  cluster_sync_all();  // every CTA of the cluster has staged W and zeroed h

  for (int s = 0; s < L; ++s) {
    const int t = d == 0 ? s : L - 1 - s;
    const float* hc = hs + (size_t)(s & 1) * H * R;
    float* hx = hs + (size_t)((s + 1) & 1) * H * R;
    float acc[4][NG][UPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int gate = 0; gate < NG; ++gate)
#pragma unroll
        for (int e = 0; e < UPT; ++e) acc[i][gate][e] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float4 hv = *reinterpret_cast<const float4*>(hc + k * R + rg * 4);
      const float h[4] = {hv.x, hv.y, hv.z, hv.w};
      const float* wk = ws + k * NG * U + UPT * ug;
#pragma unroll
      for (int gate = 0; gate < NG; ++gate) {
        float w[UPT];
        if constexpr (UPT == 2) {
          const float2 w2 = *reinterpret_cast<const float2*>(wk + gate * U);
          w[0] = w2.x;
          w[1] = w2.y;
        } else {
          w[0] = wk[gate * U];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < UPT; ++e) acc[i][gate][e] = fmaf(h[i], w[e], acc[i][gate][e]);
      }
    }
    float hnew[4][UPT];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + rg * 4 + i;
      float a[4][UPT];  // the four residuals of each unit
#pragma unroll
      for (int e = 0; e < UPT; ++e) {
        if constexpr (LSTM) {
          a[0][e] = sigmoid_f(xc[i][0][e] + acc[i][0][e]);
          a[1][e] = sigmoid_f(xc[i][1][e] + acc[i][1][e]);
          a[2][e] = tanhf(xc[i][2][e] + acc[i][2][e]);
          a[3][e] = sigmoid_f(xc[i][3][e] + acc[i][3][e]);
          // c' = f c + i g, the fused form written out: nvcc may fuse either
          // product, and did so differently in the INFER instantiation
          st[i][e] = fmaf(a[1][e], st[i][e], a[0][e] * a[2][e]);
          hnew[i][e] = a[3][e] * tanhf(st[i][e]);               // h' = o tanh(c')
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
        const int unit = u0 + UPT * ug;
        st_units<UPT>(out + ((size_t)t * N + row) * 2 * H + d * H + unit, hnew[i]);
        if constexpr (INFER) {
          if (s == L - 1) st_units<UPT>(p.hn + ((size_t)d * N + row) * H + unit, hnew[i]);
        } else {
          T* g = gates + (((size_t)d * L + t) * N + row) * 4 * H + unit;
#pragma unroll
          for (int q = 0; q < 4; ++q) st_units<UPT>(g + q * H, a[q]);
          if constexpr (LSTM)
            st_units<UPT>(cseq + (((size_t)d * L + t) * N + row) * H + unit, st[i]);
        }
      }
    }
    // the new h (rounded to the operand type) to every CTA's next buffer
#pragma unroll
    for (int e = 0; e < UPT; ++e) {
      const uint4 v = make_uint4(__float_as_uint(Op<T>::operand(hnew[0][e])),
                                 __float_as_uint(Op<T>::operand(hnew[1][e])),
                                 __float_as_uint(Op<T>::operand(hnew[2][e])),
                                 __float_as_uint(Op<T>::operand(hnew[3][e])));
      const uint32_t la = smem_u32(hx + (size_t)(u0 + UPT * ug + e) * R + rg * 4);
      for (uint32_t r = 0; r < cn; ++r) st_cluster_v4(la, r, v);
    }
    cluster_arrive_release();
    if (s + 1 < L) load_x(d == 0 ? s + 1 : L - 2 - s);
    cluster_wait_acquire();
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

// Shared memory of a backward recurrence CTA, in bytes, with the offsets of
// its parts: the partials [2][CN][R][U] f32, dh_s [R][U] f32 (GRU: dt z;
// LSTM: dc), the W_hh slice (simt [NG U][H] f32; tc [H][NG U + 8] bf16) and
// the step's gate-gradient operand (simt [R][NG U + 1] f32; tc
// [R][NG U + 8] bf16).
struct BwdSmem {
  size_t recv, dh, w, dg, total;
};

__host__ __device__ inline BwdSmem bwd_smem(bool tc, int NG, int H, int U, int R) {
  const int cn = H / U, UG = NG * U;
  BwdSmem m;
  m.recv = 0;
  m.dh = m.recv + (size_t)2 * cn * R * U * 4;
  m.w = m.dh + (size_t)R * U * 4;
  m.dg = m.w + (tc ? (size_t)H * (UG + 8) * 2 : (size_t)UG * H * 4);
  m.total = m.dg + (tc ? (size_t)R * (UG + 8) * 2 : (size_t)R * (UG + 1) * 4);
  return m;
}

// NT: the tc route's n8 tiles a warp (H / 32); unused by simt
template <typename T, bool TC, int NT, bool LSTM>
__global__ void __launch_bounds__(REC_THREADS, 1) bwd_rec_kernel(const BwdRecParams p) {
  constexpr int NG = LSTM ? 4 : 3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = p.H, G = NG * H, L = p.L, N = p.N, U = p.U, R = p.R, UG = NG * U;
  const BwdSmem m = bwd_smem(TC, NG, H, U, R);
  float* recv = reinterpret_cast<float*>(smem_raw + m.recv);
  float* dh_s = reinterpret_cast<float*>(smem_raw + m.dh);
  const uint32_t crank = cluster_ctarank(), cn = cluster_nctarank();
  const int d = blockIdx.y;
  const int row0 = (blockIdx.x / cn) * R;
  const int u0 = crank * U;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* W = static_cast<const T*>(p.whh) + (size_t)d * H * G;
  const T* dout = static_cast<const T*>(p.dout);
  const T* out = static_cast<const T*>(p.out);
  const T* gates = static_cast<const T*>(p.gates);
  const T* cseq = static_cast<const T*>(p.cseq);
  typedef typename std::conditional<TC, bf16, float>::type GT;  // the gate gradients' type
  GT* dxg = static_cast<GT*>(p.dxg) + (size_t)d * L * N * G;
  GT* dhg = LSTM ? nullptr : static_cast<GT*>(p.dhg) + (size_t)d * L * N * G;
  // tc: this thread's share of the bias gradients: its unit u = tid % U
  // (REC_THREADS % U == 0), its rows, every step in order; dxg's NG columns,
  // then the GRU's dhg's
  constexpr int NS = LSTM ? 4 : 6;
  float csum[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) csum[k] = 0.0f;
  const int DS = TC ? UG + 8 : UG + 1;  // row stride of the gate-gradient operand

  // stage this CTA's W_hh rows: W_hh[j][gate H + u0 + u] for its own gate
  // columns k = gate U + u
  if constexpr (TC) {
    bf16* wb = reinterpret_cast<bf16*>(smem_raw + m.w);  // [H][DS]
    for (int i = tid; i < H * (UG / 8); i += REC_THREADS) {
      const int j = i / (UG / 8), k8 = (i % (UG / 8)) * 8;
      const int gate = k8 / U, u = k8 % U;
      *reinterpret_cast<uint4*>(wb + j * DS + k8) = __ldg(reinterpret_cast<const uint4*>(
          W + (size_t)j * G + gate * H + u0 + u));
    }
  } else {
    float* ws = reinterpret_cast<float*>(smem_raw + m.w);  // [NG U][H]
    for (int i = tid; i < H * (UG / 4); i += REC_THREADS) {
      const int j = i % H, k4 = (i / H) * 4;
      const int gate = k4 / U, u = k4 % U;
      float v[4];
      Op<T>::load4(W + (size_t)j * G + gate * H + u0 + u, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) ws[(k4 + e) * H + j] = v[e];
    }
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
          const T* gt = gates + (((size_t)d * L + t) * N + row) * 4 * H + unit;
          v[b][0] = Op<T>::to_f(gt[0]);
          v[b][1] = Op<T>::to_f(gt[H]);
          v[b][2] = Op<T>::to_f(gt[2 * H]);
          v[b][3] = Op<T>::to_f(gt[3 * H]);
          v[b][4] = Op<T>::to_f(dout[((size_t)t * N + row) * 2 * H + d * H + unit]);
          if constexpr (LSTM) {
            v[b][5] = Op<T>::to_f(cseq[(((size_t)d * L + t) * N + row) * H + unit]);
            if (has_prev)
              v[b][6] = Op<T>::to_f(cseq[(((size_t)d * L + tp) * N + row) * H + unit]);
          } else {
            if (has_prev)
              v[b][5] = Op<T>::to_f(out[((size_t)tp * N + row) * 2 * H + d * H + unit]);
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
          if constexpr (TC) {
#pragma unroll
            for (int k = 0; k < NG; ++k) {
              csum[k] += dx4[k];
              if constexpr (!LSTM) csum[NG + k] += dh4[k];
            }
          }
        }
        if constexpr (TC) {
          bf16* dg = reinterpret_cast<bf16*>(smem_raw + m.dg) + r * DS + u;
#pragma unroll
          for (int k = 0; k < NG; ++k) dg[k * U] = __float2bfloat16_rn(dh4[k]);
        } else {
          float* dg = reinterpret_cast<float*>(smem_raw + m.dg) + r * DS + u;
#pragma unroll
          for (int k = 0; k < NG; ++k) dg[k * U] = Op<T>::operand(dh4[k]);
        }
      }
    }
    if (s + 1 == L) break;  // dh of the direction's first step is not needed
    __syncthreads();

    // 2) the partial dh over this CTA's gate columns, for all H units, sent
    // to the CTA that owns each unit: slot [step parity][this rank][row][u]
    float* snd = recv + (size_t)(s & 1) * cn * R * U + (size_t)crank * R * U;
    if constexpr (TC) {
      const bf16* wb = reinterpret_cast<const bf16*>(smem_raw + m.w);
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
    } else {
      const float* ws = reinterpret_cast<const float*>(smem_raw + m.w);
      const float* dg = reinterpret_cast<const float*>(smem_raw + m.dg);
      // lanes: jl along 8-unit groups, 32 / jl along 4-row groups; the
      // threads past R / 4 row groups (a tile cut to fit) idle here
      const int JG = H / 8, jl = JG < 8 ? JG : 8, JB = JG / jl;
      const int jg = (warp % JB) * jl + lane % jl;
      const int rg = (warp / JB) * (32 / jl) + lane / jl;
      if (rg * 4 < R) {
        float acc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
        for (int k = 0; k < UG; ++k) {
          float a[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = dg[(rg * 4 + i) * DS + k];
          const float4 w0 = *reinterpret_cast<const float4*>(ws + k * H + jg * 8);
          const float4 w1 = *reinterpret_cast<const float4*>(ws + k * H + jg * 8 + 4);
          const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
        }
        const uint32_t dst = (uint32_t)(jg * 8 / U);
        const int ju = jg * 8 % U;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t la = smem_u32(snd + (rg * 4 + i) * U + ju);
          st_cluster_v4(la, dst,
                        make_uint4(__float_as_uint(acc[i][0]), __float_as_uint(acc[i][1]),
                                   __float_as_uint(acc[i][2]), __float_as_uint(acc[i][3])));
          st_cluster_v4(la + 16, dst,
                        make_uint4(__float_as_uint(acc[i][4]), __float_as_uint(acc[i][5]),
                                   __float_as_uint(acc[i][6]), __float_as_uint(acc[i][7])));
        }
      }
    }
    cluster_arrive_release();
    cluster_wait_acquire();
  }
  if constexpr (TC) {
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
}

// ---------------------------------------------------------------- launch

// The simt forward kernel for U units a CTA and UPT units a thread (1 only
// for the LSTM, whose 64-row tile of 2 units does not fit at H = 256).
template <typename T, bool LSTM, bool INFER>
static const void* fwd_simt_kernel(int U, int upt) {
  if (U == 32 && upt == 2) return (const void*)fwd_rec_simt_kernel<T, LSTM, 32, 2, INFER>;
  if (U == 16 && upt == 2) return (const void*)fwd_rec_simt_kernel<T, LSTM, 16, 2, INFER>;
  if constexpr (LSTM) {
    if (U == 32 && upt == 1) return (const void*)fwd_rec_simt_kernel<T, LSTM, 32, 1, INFER>;
    if (U == 16 && upt == 1) return (const void*)fwd_rec_simt_kernel<T, LSTM, 16, 1, INFER>;
  }
  return nullptr;
}

// The forward recurrence, both directions: design 0 = simt (R = 1024 UPT / U
// rows a tile, UPT 1 or 2), 1 = tc (bf16, R = TC_FWD_ROWS); dtype 0 = f32,
// 1 = bf16. Clusters of H / U CTAs. INFER (simt only): no residuals, h_n to
// rp.hn.
template <bool LSTM, bool INFER = false>
static int fwd_rec_run(int design, int dtype, const FwdRecParams& rp, int U, int R,
                       cudaStream_t s) {
  constexpr int NG = LSTM ? 4 : 3;
  if (rp.L < 1 || rp.N < 1 || !cluster_ok(rp.H, U)) return (int)cudaErrorInvalidValue;
  FwdRecParams q = rp;
  const int cn = rp.H / U, tiles = (rp.N + R - 1) / R;
  const void* k = nullptr;
  size_t smem = 0;
  if (design == 1) {
    if (INFER || dtype != 1 || R != TC_FWD_ROWS) return (int)cudaErrorInvalidValue;
    smem = (size_t)(NG * U + 2 * TC_FWD_ROWS) * (rp.H + 8) * sizeof(bf16);
    if constexpr (!INFER) {
      if (U == 64) k = (const void*)fwd_rec_tc_kernel<LSTM, 64>;
      if (U == 32) k = (const void*)fwd_rec_tc_kernel<LSTM, 32>;
    }
  } else {
    if (design != 0 || (R * U != 1024 && R * U != 2048)) return (int)cudaErrorInvalidValue;
    const int upt = R * U / 1024;
    smem = ((size_t)rp.H * NG * U + (size_t)2 * rp.H * R) * 4;
    if (dtype == 0) k = fwd_simt_kernel<float, LSTM, INFER>(U, upt);
    if (dtype == 1) k = fwd_simt_kernel<bf16, LSTM, INFER>(U, upt);
  }
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return launch_cluster(k, &q, cn, tiles, smem, s);
}

// The backward recurrence, both directions: R rows a tile (tc: TC_BWD_ROWS;
// simt: 8192 / H or a divisor of it, a multiple of 4), clusters of H / U CTAs.
template <bool LSTM>
static int bwd_rec_run(int design, int dtype, const BwdRecParams& kp, cudaStream_t s) {
  constexpr int NG = LSTM ? 4 : 3;
  const int H = kp.H, U = kp.U, R = kp.R;
  if (kp.L < 1 || kp.N < 1 || R < 4 || !cluster_ok(H, U)) return (int)cudaErrorInvalidValue;
  const bool tc = design == 1;
  if (tc ? (dtype != 1 || R != TC_BWD_ROWS || H % 32 != 0 || REC_THREADS % U != 0 ||
            kp.bpart == nullptr)
         : (design != 0 || H % 8 != 0 || R % 4 != 0 || 8192 % H != 0 || (8192 / H) % R != 0 ||
            (H / 8 > 8 && (H / 8) % 8 != 0)))
    return (int)cudaErrorInvalidValue;
  BwdRecParams q = kp;
  const size_t smem = bwd_smem(tc, NG, H, U, R).total;
  const int cn = H / U, tiles = (kp.N + R - 1) / R;
  const void* k = nullptr;
  if (tc) {
    const int nt = H / 32;
    if (nt == 1) k = (const void*)bwd_rec_kernel<bf16, true, 1, LSTM>;
    if (nt == 2) k = (const void*)bwd_rec_kernel<bf16, true, 2, LSTM>;
    if (nt == 4) k = (const void*)bwd_rec_kernel<bf16, true, 4, LSTM>;
    if (nt == 8) k = (const void*)bwd_rec_kernel<bf16, true, 8, LSTM>;
  } else if (dtype == 0) {
    k = (const void*)bwd_rec_kernel<float, false, 0, LSTM>;
  } else if (dtype == 1) {
    k = (const void*)bwd_rec_kernel<bf16, false, 0, LSTM>;
  }
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return launch_cluster(k, &q, cn, tiles, smem, s);
}
