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
// the TPU kernel's own math splits it:
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
//          (distributed shared memory, one cluster barrier a step).
//   K5 (a) the recurrence that carries only dh, both directions at once.
//          Per step: dt = dout + dh; the gate gradients dr, dz, dn from the
//          residuals and h_prev (the stored output one step earlier in the
//          direction's own time); dxg = [dr, dz, dn] and dhg = [dr, dz, dn r]
//          to f32 scratch (the bias sums use them unrounded); then
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
//          the L N rows, in S fixed row slices, with the column sums of DXG
//          and DHG (db_ih, db_hh) beside them; the slices are added in
//          order (k5_wgrad_launch, k5_sum_launch). No atomics: reruns are
//          bit-equal.
//   Routes:
//   - tc (bf16): the products on the tensor cores, mma.sync.m16n8k16 with
//     f32 sums, fragments by ldmatrix (mma_tile.cuh). K4 (b) is K1-tc's
//     cluster recurrence (birnn_tc.cu) plus the residual stores: 64 rows a
//     tile, U = 64 (CN = 4 at H = 256), W_hh gate-interleaved so a thread's
//     accumulators hold every gate of its units; 168,960 bytes a CTA. K5 (a):
//     32 rows a tile, U = 64; W_hh staged [unit j][own gate column k] and
//     dhg [row][k], both k-contiguous bf16, each warp one 16-row tile by
//     H/4 units; 188,928 bytes a CTA at H = 256.
//   - simt (exact f32 FMAs on the CUDA cores, no TF32, accurate expf and
//     tanhf): U = 32, clusters of 8 at H = 256. K4 (b): 64 rows a tile, a
//     thread 4 rows x 2 units x 3 gates; W_hh slice [k][gate][u] f32
//     (96 KB) and h double-buffered [k][row] f32 (2 x 64 KB): 229,376
//     bytes a CTA. K5 (a): R = 8192 / H rows a tile (32 at H = 256), a
//     thread 4 rows x 8 units of the partial; W_hh slice [k][j] f32 (96 KB),
//     partials 2 x R x H f32 (64 KB), dhg [row][3U + 1] f32: 180,352 bytes.
//   Rows >= N (the ragged last tile) read zeros, store nothing and add
//   nothing to dW.
//
// Numerics: gate math and every sum in f32. With bf16 operands, x, the
//   weights, dout, out and the residuals are bf16 values (as on the TPU);
//   the h operand and dxg and dhg are rounded to bf16 as product operands;
//   dx, dW and db are f32. The tc recurrence's gate functions use __expf
//   (within ~1e-6, far inside a bf16 ulp), as K1-tc's.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (ops/bigru_vjp.py builds it at first use). Each C entry
//   point makes one CUDA launch and returns cudaGetLastError() after it.

#include "rnn_train_gemm.cuh"

typedef __nv_bfloat16 bf16;

#define REC_THREADS 256
#define TC_FWD_ROWS 64   // rows of a K4 tc recurrence tile (K1-tc's)
#define TC_BWD_ROWS 32   // rows of a K5 tc recurrence tile

// two consecutive values in the store type
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

// ---------------------------------------------------------------- K4 (b)

struct K4RecParams {
  const float* xg;   // (2, L N, 3H) f32 from (a)
  const void* whh;   // (2, H, 3H) T
  const float* bhh;  // (2, 3H): b_hn = columns 2H..3H
  void* out;         // (L, N, 2H) T
  void* gates;       // (2, L, N, 4H) T: r, z, n, hg_n
  int L, N, H;
};

// simt: U units a CTA, R = 2048 / U rows a tile; thread (rg, ug) owns rows
// 4 rg .. 4 rg + 3 and units 2 ug, 2 ug + 1 (local) of every gate
template <typename T, int U>
__global__ void __launch_bounds__(REC_THREADS, 1) k4_rec_simt_kernel(const K4RecParams p) {
  constexpr int R = 2048 / U;
  constexpr int UW = U / 16;  // warps along the units, 8 unit pairs each
  static_assert(U % 16 == 0 && (R / 4) * (U / 2) == REC_THREADS, "thread layout");
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, G = 3 * H, L = p.L, N = p.N;
  float* ws = smem;                          // [H][3U]: W_hh[k][gate H + u0 + u]
  float* hs = smem + (size_t)H * 3 * U;      // [2][H][R]: the h operand
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

  for (int i = tid; i < H * 3 * (U / 4); i += REC_THREADS) {
    const int u4 = i % (U / 4), gate = (i / (U / 4)) % 3, k = i / (3 * (U / 4));
    float v[4];
    Op<T>::load4(W + (size_t)k * G + gate * H + u0 + u4 * 4, v);
    *reinterpret_cast<float4*>(ws + k * 3 * U + gate * U + u4 * 4) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
  for (int i = tid; i < H * R; i += REC_THREADS) hs[i] = 0.0f;  // h0 = 0

  float bhn[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) bhn[e] = p.bhh[(size_t)d * G + 2 * H + u0 + 2 * ug + e];
  float hp[4][2];
  float2 xc[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i) hp[i][0] = hp[i][1] = 0.0f;

  auto load_x = [&](int t) {
    const float* xt = p.xg + ((size_t)d * L + t) * N * G;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + rg * 4 + i;
#pragma unroll
      for (int gate = 0; gate < 3; ++gate)
        xc[i][gate] = row < N ? ld_nc_f2(xt + (size_t)row * G + gate * H + u0 + 2 * ug)
                              : make_float2(0.0f, 0.0f);
    }
  };

  load_x(d == 0 ? 0 : L - 1);
  cluster_sync_all();  // every CTA of the cluster has staged W and zeroed h

  for (int s = 0; s < L; ++s) {
    const int t = d == 0 ? s : L - 1 - s;
    const float* hc = hs + (size_t)(s & 1) * H * R;
    float* hx = hs + (size_t)((s + 1) & 1) * H * R;
    float acc[4][3][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) acc[i][gate][0] = acc[i][gate][1] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float4 hv = *reinterpret_cast<const float4*>(hc + k * R + rg * 4);
      const float h[4] = {hv.x, hv.y, hv.z, hv.w};
      const float* wk = ws + k * 3 * U + 2 * ug;
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
        const float2 w = *reinterpret_cast<const float2*>(wk + gate * U);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][gate][0] = fmaf(h[i], w.x, acc[i][gate][0]);
          acc[i][gate][1] = fmaf(h[i], w.y, acc[i][gate][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + rg * 4 + i;
      float rv[2], zv[2], nv[2], hn[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float xr = e ? xc[i][0].y : xc[i][0].x;
        const float xz = e ? xc[i][1].y : xc[i][1].x;
        const float xn = e ? xc[i][2].y : xc[i][2].x;
        rv[e] = sigmoid_f(xr + acc[i][0][e]);
        zv[e] = sigmoid_f(xz + acc[i][1][e]);
        hn[e] = acc[i][2][e] + bhn[e];
        nv[e] = tanhf(xn + rv[e] * hn[e]);
        hp[i][e] = (1.0f - zv[e]) * nv[e] + zv[e] * hp[i][e];
      }
      if (row < N) {
        const int unit = u0 + 2 * ug;
        st2(out + ((size_t)t * N + row) * 2 * H + d * H + unit, hp[i][0], hp[i][1]);
        T* g = gates + (((size_t)d * L + t) * N + row) * 4 * H + unit;
        st2(g, rv[0], rv[1]);
        st2(g + H, zv[0], zv[1]);
        st2(g + 2 * H, nv[0], nv[1]);
        st2(g + 3 * H, hn[0], hn[1]);
      }
    }
    // the new h (rounded to the operand type) to every CTA's next buffer
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint4 v = make_uint4(__float_as_uint(Op<T>::operand(hp[0][e])),
                                 __float_as_uint(Op<T>::operand(hp[1][e])),
                                 __float_as_uint(Op<T>::operand(hp[2][e])),
                                 __float_as_uint(Op<T>::operand(hp[3][e])));
      const uint32_t la = smem_u32(hx + (size_t)(u0 + 2 * ug + e) * R + rg * 4);
      for (uint32_t r = 0; r < cn; ++r) st_cluster_v4(la, r, v);
    }
    cluster_arrive_release();
    if (s + 1 < L) load_x(d == 0 ? s + 1 : L - 2 - s);
    cluster_wait_acquire();
  }
}

// tc (bf16): K1-tc's GRU recurrence (birnn_tc.cu::rnn_rec_kernel) with the
// residual stores. U hidden units a CTA; 8 warps as WR (rows) x WU (unit
// blocks of 8), each warp MT row tiles of 16 by UT unit blocks, every gate.
template <int U>
__global__ void __launch_bounds__(REC_THREADS, 1) k4_rec_tc_kernel(const K4RecParams p) {
  constexpr int NG = 3;
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
      bhn[ut][e] = p.bhh[(size_t)d * G + 2 * H + u0 + (wu * UT + ut) * 8 + 2 * t4 + e];
  float st[MT][UT][2][2];  // h (f32) of rows (mt, half), units (ut, e)
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
          float hv[2], rv[2], zv[2], nv[2], hn[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = 2 * half + e;
            float x[NG];
#pragma unroll
            for (int gate = 0; gate < NG; ++gate)
              x[gate] = e ? xc[mt][ut][gate][half].y : xc[mt][ut][gate][half].x;
            float& sv = st[mt][ut][half][e];
            rv[e] = sigmoid_tc(x[0] + acc[mt][ut][0][q]);
            zv[e] = sigmoid_tc(x[1] + acc[mt][ut][1][q]);
            hn[e] = acc[mt][ut][2][q] + bhn[ut][e];
            nv[e] = tanh_tc(x[2] + rv[e] * hn[e]);
            hv[e] = (1.0f - zv[e]) * nv[e] + zv[e] * sv;
            sv = hv[e];
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
            st2(gp, rv[0], rv[1]);
            st2(gp + H, zv[0], zv[1]);
            st2(gp + 2 * H, nv[0], nv[1]);
            st2(gp + 3 * H, hn[0], hn[1]);
          }
        }
      }
    cluster_arrive_release();
    if (s + 1 < L) load_x(d == 0 ? s + 1 : L - 2 - s);
    cluster_wait_acquire();
  }
}

// ---------------------------------------------------------------- K5 (a)

struct K5RecParams {
  const void* dout;   // (L, N, 2H) T
  const void* out;    // (L, N, 2H) T
  const void* gates;  // (2, L, N, 4H) T
  const void* whh;    // (2, H, 3H) T
  float* dxg;         // (2, L N, 3H) f32
  float* dhg;         // (2, L N, 3H) f32
  int L, N, H, U, R;  // U units a CTA, R rows a tile
};

// Shared memory of a K5 recurrence CTA, in bytes, with the offsets of its
// parts: the partials [2][CN][R][U] f32, dh_s [R][U] f32 (dt z, then dh),
// the W_hh slice (simt [3U][H] f32; tc [H][3U + 8] bf16) and the step's dhg
// operand (simt [R][3U + 1] f32; tc [R][3U + 8] bf16).
struct K5Smem {
  size_t recv, dh, w, dg, total;
};

__host__ __device__ inline K5Smem k5_smem(bool tc, int H, int U, int R) {
  const int cn = H / U;
  K5Smem m;
  m.recv = 0;
  m.dh = m.recv + (size_t)2 * cn * R * U * 4;
  m.w = m.dh + (size_t)R * U * 4;
  m.dg = m.w + (tc ? (size_t)H * (3 * U + 8) * 2 : (size_t)3 * U * H * 4);
  m.total = m.dg + (tc ? (size_t)R * (3 * U + 8) * 2 : (size_t)R * (3 * U + 1) * 4);
  return m;
}

// NT: the tc route's n8 tiles a warp (H / 32); unused by simt
template <typename T, bool TC, int NT>
__global__ void __launch_bounds__(REC_THREADS, 1) k5_rec_kernel(const K5RecParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = p.H, G = 3 * H, L = p.L, N = p.N, U = p.U, R = p.R, U3 = 3 * U;
  const K5Smem m = k5_smem(TC, H, U, R);
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
  float* dxg = p.dxg + (size_t)d * L * N * G;
  float* dhg = p.dhg + (size_t)d * L * N * G;
  const int DS = TC ? U3 + 8 : U3 + 1;  // row stride of the dhg operand

  // stage this CTA's W_hh rows: W_hh[j][gate H + u0 + u] for its own gate
  // columns k = gate U + u
  if constexpr (TC) {
    bf16* wb = reinterpret_cast<bf16*>(smem_raw + m.w);  // [H][DS]
    for (int i = tid; i < H * (U3 / 8); i += REC_THREADS) {
      const int j = i / (U3 / 8), k8 = (i % (U3 / 8)) * 8;
      const int gate = k8 / U, u = k8 % U;
      *reinterpret_cast<uint4*>(wb + j * DS + k8) = __ldg(reinterpret_cast<const uint4*>(
          W + (size_t)j * G + gate * H + u0 + u));
    }
  } else {
    float* ws = reinterpret_cast<float*>(smem_raw + m.w);  // [3U][H]
    for (int i = tid; i < H * (U3 / 4); i += REC_THREADS) {
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
    for (int q0 = tid; q0 < R * U; q0 += EB * REC_THREADS) {
      float v[EB][6];  // r, z, n, hg_n, dout, h_prev
#pragma unroll
      for (int b = 0; b < EB; ++b) {
        const int q = q0 + b * REC_THREADS, r = q / U, row = row0 + r;
#pragma unroll
        for (int e = 0; e < 6; ++e) v[b][e] = 0.0f;
        if (q < R * U && row < N) {
          const int unit = u0 + q % U;
          const T* gt = gates + (((size_t)d * L + t) * N + row) * 4 * H + unit;
          v[b][0] = Op<T>::to_f(gt[0]);
          v[b][1] = Op<T>::to_f(gt[H]);
          v[b][2] = Op<T>::to_f(gt[2 * H]);
          v[b][3] = Op<T>::to_f(gt[3 * H]);
          v[b][4] = Op<T>::to_f(dout[((size_t)t * N + row) * 2 * H + d * H + unit]);
          if (has_prev)
            v[b][5] = Op<T>::to_f(out[((size_t)tp * N + row) * 2 * H + d * H + unit]);
        }
      }
#pragma unroll
      for (int b = 0; b < EB; ++b) {
        const int q = q0 + b * REC_THREADS;
        if (q >= R * U) break;
        const int r = q / U, u = q % U, row = row0 + r, unit = u0 + u;
        float dh = 0.0f;
        if (s > 0) {
          dh = dh_s[q];
          for (uint32_t c = 0; c < cn; ++c) dh += rcv[(size_t)c * R * U + q];
        }
        const float rg = v[b][0], zg = v[b][1], ng = v[b][2], hgn = v[b][3];
        const float dt = v[b][4] + dh;
        const float dz = dt * (v[b][5] - ng) * zg * (1.0f - zg);
        const float dn = dt * (1.0f - zg) * (1.0f - ng * ng);
        const float dr = dn * hgn * rg * (1.0f - rg);
        const float dnr = dn * rg;
        dh_s[q] = dt * zg;
        if (row < N) {
          const size_t o = ((size_t)t * N + row) * G + unit;
          dxg[o] = dr;
          dxg[o + H] = dz;
          dxg[o + 2 * H] = dn;
          dhg[o] = dr;
          dhg[o + H] = dz;
          dhg[o + 2 * H] = dnr;
        }
        if constexpr (TC) {
          bf16* dg = reinterpret_cast<bf16*>(smem_raw + m.dg) + r * DS + u;
          dg[0] = __float2bfloat16_rn(dr);
          dg[U] = __float2bfloat16_rn(dz);
          dg[2 * U] = __float2bfloat16_rn(dnr);
        } else {
          float* dg = reinterpret_cast<float*>(smem_raw + m.dg) + r * DS + u;
          dg[0] = Op<T>::operand(dr);
          dg[U] = Op<T>::operand(dz);
          dg[2 * U] = Op<T>::operand(dnr);
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
      for (int k0 = 0; k0 < U3; k0 += 16) {
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
      // lanes: jl along 8-unit groups, 32 / jl along 4-row groups
      const int JG = H / 8, jl = JG < 8 ? JG : 8, JB = JG / jl;
      const int jg = (warp % JB) * jl + lane % jl;
      const int rg = (warp / JB) * (32 / jl) + lane / jl;
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < U3; ++k) {
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
    cluster_arrive_release();
    cluster_wait_acquire();
  }
}

// ---------------------------------------------------------------- launch

static bool cluster_ok(int H, int U) {
  if (U < 16 || U % 16 != 0 || H % U != 0) return false;
  const int cn = H / U;
  return cn == 1 || cn == 2 || cn == 4 || cn == 8;
}

template <typename T>
static int k4_rec_simt(const K4RecParams& rp, int U, cudaStream_t s) {
  const int R = 2048 / U;
  const size_t smem = ((size_t)rp.H * 3 * U + (size_t)2 * rp.H * R) * 4;
  const int tiles = (rp.N + R - 1) / R;
  K4RecParams q = rp;
  if (U == 32)
    return launch_cluster((const void*)k4_rec_simt_kernel<T, 32>, &q, rp.H / U, tiles, smem, s);
  if (U == 16)
    return launch_cluster((const void*)k4_rec_simt_kernel<T, 16>, &q, rp.H / U, tiles, smem, s);
  return (int)cudaErrorInvalidValue;
}

static int k4_rec_tc(const K4RecParams& rp, int U, cudaStream_t s) {
  const size_t smem = (size_t)(3 * U + 2 * TC_FWD_ROWS) * (rp.H + 8) * sizeof(bf16);
  const int tiles = (rp.N + TC_FWD_ROWS - 1) / TC_FWD_ROWS;
  K4RecParams q = rp;
  if (U == 64)
    return launch_cluster((const void*)k4_rec_tc_kernel<64>, &q, rp.H / U, tiles, smem, s);
  if (U == 32)
    return launch_cluster((const void*)k4_rec_tc_kernel<32>, &q, rp.H / U, tiles, smem, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int k45_proj(const void* x, const void* wih, const float* bih,
                    const float* bhh, float* xg, int M, int C, int H, cudaStream_t s) {
  const int G = 3 * H;
  GemmParams gp = {};
  for (int d = 0; d < 2; ++d) {
    GemmJob& jb = gp.job[d];
    jb.a[0] = gemm_op<T>(x, C, 0, 0, C);
    jb.b[0] = gemm_op<T>(static_cast<const T*>(wih) + (size_t)d * C * G, G, 0, 0, C);
    jb.nseg = 1;
    jb.M = M;
    jb.N = G;
    jb.c = xg + (size_t)d * M * G;
    jb.ldc = G;
    jb.bias0 = bih + d * G;
    jb.bias1 = bhh + d * G;
    jb.nfold = 2 * H;  // b_hn stays inside the reset product
    jb.colsum = nullptr;
  }
  gp.K = C;
  gp.S = 1;
  gp.Ks = C;
  gp.slice_stride = 0;
  return gemm_run<T, true, T, false, T>(false, gp, 2, M, G, s);
}

template <typename T>
static int k5_dx(bool tc, const float* dxg, const void* wih, float* dx, int M, int C,
                 int H, cudaStream_t s) {
  const int G = 3 * H;
  GemmParams gp = {};
  GemmJob& jb = gp.job[0];
  for (int d = 0; d < 2; ++d) {
    jb.a[d] = gemm_op<float>(dxg + (size_t)d * M * G, G, 0, 0, G);
    // W_ih[d] (C, G) read as (k, n) -> p[n G + k]: W_ih^T without a copy
    jb.b[d] = gemm_op<T>(static_cast<const T*>(wih) + (size_t)d * C * G, G, 0, 0, G);
  }
  jb.nseg = 2;
  jb.M = M;
  jb.N = C;
  jb.c = dx;
  jb.ldc = C;
  jb.bias0 = jb.bias1 = nullptr;
  jb.nfold = 0;
  jb.colsum = nullptr;
  gp.K = G;
  gp.S = 1;
  gp.Ks = G;
  gp.slice_stride = 0;
  return gemm_run<float, true, T, true, T>(tc, gp, 1, M, C, s);
}

template <typename T>
static int k5_wgrad(bool tc, const void* x, const void* out, const float* dxg,
                    const float* dhg, float* part, int L, int N, int C, int H, int S,
                    cudaStream_t s) {
  const int G = 3 * H, LN = L * N;
  const long long o_whh = 2LL * C * G, o_bih = o_whh + 2LL * H * G, o_bhh = o_bih + 2LL * G;
  GemmParams gp = {};
  for (int d = 0; d < 2; ++d) {
    GemmJob& ih = gp.job[d];
    ih.a[0] = gemm_op<T>(x, C, 0, 0, LN);  // X^T: (m = c, k = row) at x[k C + m]
    ih.b[0] = gemm_op<float>(dxg + (size_t)d * LN * G, G, 0, 0, LN);
    ih.nseg = 1;
    ih.M = C;
    ih.N = G;
    ih.c = part + (size_t)d * C * G;
    ih.ldc = G;
    ih.bias0 = ih.bias1 = nullptr;
    ih.nfold = 0;
    ih.colsum = part + o_bih + d * G;
    GemmJob& hh = gp.job[2 + d];
    // h_prev of row k = t N + row: out[t - 1] (forward half) or out[t + 1]
    hh.a[0] = gemm_op<T>(static_cast<const T*>(out) + d * H, 2 * H, d == 0 ? -N : N,
                         d == 0 ? N : 0, d == 0 ? LN : LN - N);
    hh.b[0] = gemm_op<float>(dhg + (size_t)d * LN * G, G, 0, 0, LN);
    hh.nseg = 1;
    hh.M = H;
    hh.N = G;
    hh.c = part + o_whh + (size_t)d * H * G;
    hh.ldc = G;
    hh.bias0 = hh.bias1 = nullptr;
    hh.nfold = 0;
    hh.colsum = part + o_bhh + d * G;
  }
  gp.K = LN;
  gp.S = S;
  gp.Ks = (int)((((long long)LN + S - 1) / S + TG_BK - 1) / TG_BK * TG_BK);
  gp.slice_stride = o_bhh + 2LL * G;
  return gemm_run<T, false, float, false, T>(tc, gp, 4, C > H ? C : H, G, s);
}

extern "C" {

// design: 0 = simt, 1 = tc (bf16 only); dtype: 0 = float32, 1 = bfloat16
// (operands and stored outputs). Every entry makes one CUDA launch on the
// stream and returns 0 or a cudaError_t value.

// K4 (a) of the simt design: xg (2, M, 3H) f32 = x (M, C) W_ih[d] (C, 3H) +
// b_ih[d] + the r and z columns of b_hh[d]. (The tc design runs K1-tc's
// projection kernel, birnn_tc.cu's birnn_tc_proj_launch, for this.)
int k4_proj_launch(int dtype, const void* x, const void* wih, const void* bih,
                   const void* bhh, void* xg, int M, int C, int H, void* stream) {
  if (M < 1 || C < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bi = static_cast<const float*>(bih);
  const float* bh = static_cast<const float*>(bhh);
  float* o = static_cast<float*>(xg);
  if (dtype == 0) return k45_proj<float>(x, wih, bi, bh, o, M, C, H, s);
  if (dtype == 1) return k45_proj<bf16>(x, wih, bi, bh, o, M, C, H, s);
  return (int)cudaErrorInvalidValue;
}

// K4 (b): from xg (2, L N, 3H) f32 to out (L, N, 2H) and gates (2, L, N, 4H)
// in the store type; clusters of H / U CTAs.
int k4_rec_launch(int design, int dtype, const void* xg, const void* whh, const void* bhh,
                  void* out, void* gates, int L, int N, int H, int U, void* stream) {
  if (L < 1 || N < 1 || !cluster_ok(H, U)) return (int)cudaErrorInvalidValue;
  K4RecParams rp;
  rp.xg = static_cast<const float*>(xg);
  rp.whh = whh;
  rp.bhh = static_cast<const float*>(bhh);
  rp.out = out;
  rp.gates = gates;
  rp.L = L;
  rp.N = N;
  rp.H = H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 1 && dtype == 1) return k4_rec_tc(rp, U, s);
  if (design == 0 && dtype == 0) return k4_rec_simt<float>(rp, U, s);
  if (design == 0 && dtype == 1) return k4_rec_simt<bf16>(rp, U, s);
  return (int)cudaErrorInvalidValue;
}

// K5 (a): dxg and dhg (2, L N, 3H) f32 from dout, out, gates and W_hh; R
// rows a tile (tc: 32; simt: 8192 / H), clusters of H / U CTAs.
int k5_rec_launch(int design, int dtype, const void* dout, const void* out,
                  const void* gates, const void* whh, void* dxg, void* dhg, int L, int N,
                  int H, int U, int R, void* stream) {
  if (L < 1 || N < 1 || !cluster_ok(H, U)) return (int)cudaErrorInvalidValue;
  const bool tc = design == 1;
  if (tc ? (dtype != 1 || R != TC_BWD_ROWS || H % 32 != 0)
         : (H % 8 != 0 || R * H != 8192 || (H / 8 > 8 && (H / 8) % 8 != 0)))
    return (int)cudaErrorInvalidValue;
  K5RecParams kp;
  kp.dout = dout;
  kp.out = out;
  kp.gates = gates;
  kp.whh = whh;
  kp.dxg = static_cast<float*>(dxg);
  kp.dhg = static_cast<float*>(dhg);
  kp.L = L;
  kp.N = N;
  kp.H = H;
  kp.U = U;
  kp.R = R;
  const size_t smem = k5_smem(tc, H, U, R).total;
  const int cn = H / U, tiles = (N + R - 1) / R;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* k = nullptr;
  if (tc) {
    const int nt = H / 32;
    if (nt == 1) k = (const void*)k5_rec_kernel<bf16, true, 1>;
    if (nt == 2) k = (const void*)k5_rec_kernel<bf16, true, 2>;
    if (nt == 4) k = (const void*)k5_rec_kernel<bf16, true, 4>;
    if (nt == 8) k = (const void*)k5_rec_kernel<bf16, true, 8>;
  } else if (dtype == 0) {
    k = (const void*)k5_rec_kernel<float, false, 0>;
  } else if (dtype == 1) {
    k = (const void*)k5_rec_kernel<bf16, false, 0>;
  }
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return launch_cluster(k, &kp, cn, tiles, smem, s);
}

// K5 (b): dx (M, C) f32 = sum_d op(dxg[d]) (M, 3H) W_ih[d]^T.
int k5_dx_launch(int design, int dtype, const void* dxg, const void* wih, void* dx, int M,
                 int C, int H, void* stream) {
  if (M < 1 || C < 1 || H < 1 || (design == 1 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(dxg);
  float* o = static_cast<float*>(dx);
  if (dtype == 0) return k5_dx<float>(design == 1, g, wih, o, M, C, H, s);
  if (dtype == 1) return k5_dx<bf16>(design == 1, g, wih, o, M, C, H, s);
  return (int)cudaErrorInvalidValue;
}

// K5 (c): into part (S slices of [dW_ih (2, C, 3H) | dW_hh (2, H, 3H) |
// db_ih (2, 3H) | db_hh (2, 3H)] f32; with S = 1, part is the result).
int k5_wgrad_launch(int design, int dtype, const void* x, const void* out, const void* dxg,
                    const void* dhg, void* part, int L, int N, int C, int H, int S,
                    void* stream) {
  if (L < 1 || N < 1 || C < 1 || H < 1 || S < 1 || (long long)L * N >= (1LL << 31) ||
      (design == 1 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(dxg);
  const float* b = static_cast<const float*>(dhg);
  float* o = static_cast<float*>(part);
  if (dtype == 0) return k5_wgrad<float>(design == 1, x, out, a, b, o, L, N, C, H, S, s);
  if (dtype == 1) return k5_wgrad<bf16>(design == 1, x, out, a, b, o, L, N, C, H, S, s);
  return (int)cudaErrorInvalidValue;
}

// K5 (c), the slices: grads[i] = sum over the S partials of element i, in
// slice order (T floats a slice).
int k5_sum_launch(const void* part, void* grads, long long T, int S, void* stream) {
  if (T < 1 || S < 2) return (int)cudaErrorInvalidValue;
  const long long blocks = (T + GM_THREADS - 1) / GM_THREADS;
  gemm_sum_slices<<<(int)(blocks < 4096 ? blocks : 4096), GM_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(part),
                                                         static_cast<float*>(grads), T, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
