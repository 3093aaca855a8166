// Kernel K1, bf16: the whole bidirectional GRU or LSTM stack on Hopper's
// tensor cores, zero h0 (and c0). Two kernels per layer, which ops/bigru.py
// launches in order on the caller's stream (birnn_tc_proj_launch, then
// birnn_tc_rec_launch, layer after layer):
//   (a) rnn_proj_kernel: the input projection of all L steps, both
//       directions: xg (2, L*N, G) f32 = X (L*N, Cin) bf16 W_ih (Cin, G) bf16
//       plus b_ih and the parts of b_hh that sit outside the reset product
//       (GRU: b_hr, b_hz; LSTM: all of b_hh);
//   (b) rnn_rec_kernel: the recurrence. A cluster of CN CTAs runs one
//       (tile of 64 rows, direction); CTA c owns hidden units
//       [c U, (c+1) U) of every gate and keeps its slice of W_hh (H x NG U
//       bf16) in shared memory for all L steps.
// K2 (one layer) runs the same two kernels once. fp32 runs birnn_simt.cu
// (the same two phases in exact f32), and the shapes neither takes run
// bigru_stack.cu; ops/bigru.py's k1_plan is the shape rule among the three.
//
// Replaces: ccsmeth_tpu/ops/bigru_pallas.py::_make_stack_kernel (GRU :232,
//   LSTM :238-245, launched by _fused_stack_call :373), as bigru_stack.cu
//   does; like the TPU kernel (:288-294) it projects each layer's input once,
//   before the recurrence, and keeps the projection in f32.
//
// Bound on an H100 SXM: the attbigru2s stack does 116 MFLOP of products per
//   row (57% of it the input projection), the attbilstm2s stack 155, so at
//   989 TFLOP/s bf16 it is compute-bound (1024 rows: 0.12 / 0.16 ms). What
//   sets this design's pace instead: the serial chain of NL * L = 63 steps,
//   each a product of 64 rows x H by H x NG U from shared memory, a cluster
//   barrier and the gate math; and the f32 xg (2.1 GB a layer at 16,384 GRU
//   rows), written once by (a) and read once by (b).
//
// What the design does about that:
//   - products on the tensor cores (mma.sync.m16n8k16, bf16 -> f32), with
//     ldmatrix from shared memory; the h operand is rounded to bf16 once,
//     where it is stored, not at every k;
//   - (a) is one product per layer, tiles of 128 x 128 over a three-stage
//     cp.async ring, so the recurrence carries only h W_hh;
//   - (b) loads W_hh once per layer into shared memory: 96 KB (GRU) or
//     128 KB (LSTM) a CTA at H = 256, U = 64, CN = 4 (the f32 kernel reads
//     all of W_ih and W_hh from L2 at every step, for 8 rows a block);
//   - W_hh's columns are staged gate-interleaved: row (ub NG + gate) 8 + i of
//     CTA c holds column gate H + c U + 8 ub + i, so each thread's mma
//     accumulators hold every gate of the same (row, unit) pairs. The gate
//     math runs in registers, and so does the GRU's f32 h and the LSTM's c,
//     for all L steps;
//   - each new h (bf16) goes to the next h buffer of every CTA of the
//     cluster through distributed shared memory, 16 bytes a store: the 4
//     lanes that hold a row's 8-unit block gather it by shuffles and each
//     sends it to one CTA; one cluster barrier a step (h double-buffered).
//     Its arrive comes before the next step's xg loads, its wait after
//     them, so those loads fly while the cluster meets;
//   - the two directions run as separate clusters at the same time: the
//     serial chain is NL * L steps, not 2 NL L;
//   - deterministic: every sum has one owner and a fixed order, no atomics.
//
// Rounding, as the f32 kernel's bf16 path and the plain version: the weights,
//   the layer inputs and the h operand are bf16 values, products sum in f32,
//   the GRU's z h term and the LSTM's c are f32, b_hn stays inside the reset
//   product. Outputs: out (L, N, 2H) bf16, h_n (2 NL, N, H) f32.
//
// Shapes: H % 16 == 0, U in {16, 32, 64} dividing H, CN = H / U in
//   {1, 2, 4, 8}, shared memory within 227 KB (bigru.py's k1_plan checks it
//   before the launch; the C entry points refuse anything else). Any Cin: a
//   layer input whose rows are not 16-byte multiples (Cin = 11) is staged
//   element by element, zero-padded to the k tile.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (ops/bigru.py builds it at first use). Each C entry
//   point returns cudaGetLastError() after its launch.

#include "mma_tile.cuh"
#include "entry_device.cuh"

typedef __nv_bfloat16 bf16;

#define TC_THREADS 256
#define TC_ROWS 64       // rows of a recurrence tile
#define PJ_BM 128
#define PJ_BN 128
#define PJ_BK 32
#define PJ_STAGES 3
#define PJ_AS (PJ_BK + 8)  // row strides of the staged tiles, in bf16
#define PJ_BS (PJ_BN + 8)

// ---------------------------------------------------------------- (a)

struct ProjParams {
  const bf16* x;     // (M, K), M = L * N
  const bf16* w;     // (2, K, G)
  const float* bih;  // (2, G)
  const float* bhh;  // (2, G)
  float* xg;         // (2, M, G)
  int M, K, G, H, lstm;
};

// VEC_A: K % 8 == 0, so rows of x are 16-byte multiples and go by cp.async
template <bool VEC_A>
__global__ void __launch_bounds__(TC_THREADS, 2)
    rnn_proj_kernel(const ProjParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [stage][BM][AS]
  bf16* Bs = As + PJ_STAGES * PJ_BM * PJ_AS;      // [stage][BK][BS]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nb = (p.G + PJ_BN - 1) / PJ_BN;
  const int d = blockIdx.y / nb;
  const int n0 = (blockIdx.y % nb) * PJ_BN;
  const int m0 = blockIdx.x * PJ_BM;
  const bf16* W = p.w + (size_t)d * p.K * p.G;
  const int ktiles = (p.K + PJ_BK - 1) / PJ_BK;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * PJ_BK;
    bf16* as = As + stage * PJ_BM * PJ_AS;
    bf16* bs = Bs + stage * PJ_BK * PJ_BS;
    if constexpr (VEC_A) {
      for (int i = tid; i < PJ_BM * PJ_BK / 8; i += TC_THREADS) {
        const int r = i / (PJ_BK / 8), c = (i % (PJ_BK / 8)) * 8;
        const bool ok = m0 + r < p.M && k0 + c < p.K;
        const bf16* src = ok ? p.x + (size_t)(m0 + r) * p.K + k0 + c : p.x;
        cp_async_16(smem_u32(as + r * PJ_AS + c), src, ok);
      }
    } else {
      for (int i = tid; i < PJ_BM * PJ_BK; i += TC_THREADS) {
        const int r = i / PJ_BK, c = i % PJ_BK;
        const bool ok = m0 + r < p.M && k0 + c < p.K;
        as[r * PJ_AS + c] =
            ok ? p.x[(size_t)(m0 + r) * p.K + k0 + c] : __float2bfloat16_rn(0.0f);
      }
    }
    for (int i = tid; i < PJ_BK * PJ_BN / 8; i += TC_THREADS) {
      const int r = i / (PJ_BN / 8), c = (i % (PJ_BN / 8)) * 8;
      const bool ok = k0 + r < p.K && n0 + c < p.G;
      const bf16* src = ok ? W + (size_t)(k0 + r) * p.G + n0 + c : W;
      cp_async_16(smem_u32(bs + r * PJ_BS + c), src, ok);
    }
  };

  // 2 x 4 warps, each a 64 x 32 tile: 4 x 4 mma tiles
  const int wm = warp >> 2, wn = warp & 3;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < PJ_STAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<PJ_STAGES - 2>();
    __syncthreads();
    const int nt = kt + PJ_STAGES - 1;
    if (nt < ktiles) load(nt % PJ_STAGES, nt);
    cp_async_commit();
    const bf16* as = As + (kt % PJ_STAGES) * PJ_BM * PJ_AS;
    const bf16* bs = Bs + (kt % PJ_STAGES) * PJ_BK * PJ_BS;
#pragma unroll
    for (int kk = 0; kk < PJ_BK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(a[mt], smem_u32(as + (wm * 64 + mt * 16 + (lane & 15)) * PJ_AS +
                                    kk + (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_u32(bs + (kk + (lane & 15)) * PJ_BS + wn * 32 +
                                      np * 16 + (lane >> 4) * 8));
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], a[mt], b[j]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t4 = lane & 3;
  const float* bi = p.bih + (size_t)d * p.G;
  const float* bh = p.bhh + (size_t)d * p.G;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn * 32 + j * 8 + 2 * t4;
    if (col >= p.G) continue;
    // b_hh joins here except the GRU's b_hn (columns >= 2H), which stays
    // inside the reset product
    const bool fold = p.lstm || col < 2 * p.H;
    const float b0 = bi[col] + (fold ? bh[col] : 0.0f);
    const float b1 = bi[col + 1] + (fold ? bh[col + 1] : 0.0f);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mt * 16 + g + 8 * half;
        if (row < p.M)
          *reinterpret_cast<float2*>(p.xg + ((size_t)d * p.M + row) * p.G + col) =
              make_float2(acc[mt][j][2 * half] + b0, acc[mt][j][2 * half + 1] + b1);
      }
    }
  }
}

// ---------------------------------------------------------------- (b)

// The recurrence's f32 gate functions: exp by ex2.approx (__expf) and a fast
// reciprocal, within about 1e-6 of sigmoid_f / tanhf (rnn_common.cuh) on
// the gates' range, far inside one bf16 ulp of h (2^-9 on [0.5, 1)), with a
// fraction of their instructions on the serial chain
__device__ __forceinline__ float sigmoid_tc(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float tanh_tc(float x) {
  return 2.0f * sigmoid_tc(2.0f * x) - 1.0f;
}

struct RecParams {
  const float* xg;   // (2, L, N, G) from (a)
  const bf16* whh;   // (2, H, G)
  const float* bhh;  // (2, G): the GRU reads b_hn = columns 2H..3H
  bf16* out;         // (L, N, 2H)
  float* hn;         // (2, N, H): this layer's two h_n slices
  int L, N, H;
};

// U hidden units a CTA; 8 warps as WR (rows) x WU (unit blocks of 8), each
// warp MT row tiles of 16 by UT unit blocks, every gate of them
template <bool LSTM, int U>
__global__ void __launch_bounds__(TC_THREADS, 1)
    rnn_rec_kernel(const RecParams p) {
  constexpr int NG = LSTM ? 4 : 3;
  constexpr int NC = NG * U;  // staged W_hh rows of this CTA
  constexpr int UB = U / 8;
  constexpr int WU = UB < 4 ? UB : 4;
  constexpr int UT = UB / WU;
  constexpr int WR = 8 / WU;
  constexpr int MT = (TC_ROWS / 16) / WR;
  static_assert(WR * WU == 8 && MT * WR * 16 == TC_ROWS, "warp layout");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = p.H, HP = H + 8, G = NG * H, L = p.L, N = p.N;
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);  // [NC][HP]
  bf16* hs = ws + NC * HP;                        // [2][TC_ROWS][HP]
  const uint32_t crank = cluster_ctarank();
  const uint32_t cn = cluster_nctarank();
  const int d = blockIdx.y;
  const int row0 = (blockIdx.x / cn) * TC_ROWS;
  const int u0 = crank * U;  // this CTA's first hidden unit
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp / WU, wu = warp % WU;

  // this CTA's W_hh columns, gate-interleaved, k contiguous; k runs fastest
  // across threads, so a warp's 2-byte stores fill consecutive k of one row
  const bf16* W = p.whh + (size_t)d * H * G;
  for (int i = tid; i < H * NG * UB; i += TC_THREADS) {
    const int k = i % H, ub = (i / H) % UB, gate = i / (H * UB);
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(
        W + (size_t)k * G + gate * H + u0 + ub * 8));
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    bf16* dst = ws + (ub * NG + gate) * 8 * HP + k;
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[j * HP] = e[j];
  }
  for (int i = tid; i < TC_ROWS * HP / 8; i += TC_THREADS)
    reinterpret_cast<uint4*>(hs)[i] = make_uint4(0u, 0u, 0u, 0u);  // h0 = 0

  float bhn[UT][2];
#pragma unroll
  for (int ut = 0; ut < UT; ++ut)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bhn[ut][e] = LSTM ? 0.0f
                        : p.bhh[(size_t)d * G + 2 * H + u0 + (wu * UT + ut) * 8 +
                                2 * t4 + e];
  // GRU: h (f32); LSTM: c (f32); of rows (mt, half), units (ut, e)
  float st[MT][UT][2][2];
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
  cluster_sync_all();  // every CTA of the cluster has staged W and zeroed h

  for (int s = 0; s < L; ++s) {
    const int t = d == 0 ? s : L - 1 - s;
    const bf16* hc = hs + (s & 1) * TC_ROWS * HP;
    bf16* hx = hs + ((s + 1) & 1) * TC_ROWS * HP;
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
          float hv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = 2 * half + e;
            float x[NG];
#pragma unroll
            for (int gate = 0; gate < NG; ++gate)
              x[gate] = e ? xc[mt][ut][gate][half].y : xc[mt][ut][gate][half].x;
            float& sv = st[mt][ut][half][e];
            if constexpr (LSTM) {
              const float gi = sigmoid_tc(x[0] + acc[mt][ut][0][q]);
              const float gf = sigmoid_tc(x[1] + acc[mt][ut][1][q]);
              const float gg = tanh_tc(x[2] + acc[mt][ut][2][q]);
              const float go = sigmoid_tc(x[3] + acc[mt][ut][3][q]);
              sv = gf * sv + gi * gg;  // c' = f c + i g, h' = o tanh(c')
              hv[e] = go * tanh_tc(sv);
            } else {
              const float rg = sigmoid_tc(x[0] + acc[mt][ut][0][q]);
              const float zg = sigmoid_tc(x[1] + acc[mt][ut][1][q]);
              const float ng = tanh_tc(x[2] + rg * (acc[mt][ut][2][q] + bhn[ut][e]));
              hv[e] = (1.0f - zg) * ng + zg * sv;
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
              *reinterpret_cast<uint4*>(p.out + ((size_t)t * N + row) * 2 * H + d * H +
                                        ub0) = blk;
            if (s == L - 1)
              *reinterpret_cast<float2*>(p.hn + ((size_t)d * N + row) * H + unit) =
                  make_float2(hv[0], hv[1]);
          }
        }
      }
    cluster_arrive_release();
    if (s + 1 < L) load_x(d == 0 ? s + 1 : L - 2 - s);
    cluster_wait_acquire();
  }
}

// ---------------------------------------------------------------- launch

static int launch_proj(const ProjParams& pp, cudaStream_t s) {
  const size_t smem =
      (size_t)PJ_STAGES * (PJ_BM * PJ_AS + PJ_BK * PJ_BS) * sizeof(bf16);
  const dim3 grid((pp.M + PJ_BM - 1) / PJ_BM, 2 * ((pp.G + PJ_BN - 1) / PJ_BN));
  cudaError_t e;
  if (pp.K % 8 == 0) {
    e = cudaFuncSetAttribute(rnn_proj_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    rnn_proj_kernel<true><<<grid, TC_THREADS, smem, s>>>(pp);
  } else {
    e = cudaFuncSetAttribute(rnn_proj_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    rnn_proj_kernel<false><<<grid, TC_THREADS, smem, s>>>(pp);
  }
  return (int)cudaGetLastError();
}

// The recurrence's launch: clusters of CN CTAs along x, one row tile of a
// direction each
template <bool LSTM, int U>
static int launch_rec_typed(const RecParams& rp, int CN, cudaStream_t s) {
  constexpr int NG = LSTM ? 4 : 3;
  const size_t smem = (size_t)(NG * U + 2 * TC_ROWS) * (rp.H + 8) * sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(
      rnn_rec_kernel<LSTM, U>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CN * ((rp.N + TC_ROWS - 1) / TC_ROWS), 2, 1);
  cfg.blockDim = dim3(TC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CN;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, rnn_rec_kernel<LSTM, U>, rp);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool LSTM>
static int launch_rec(const RecParams& rp, int U, int CN, cudaStream_t s) {
  if (U == 64) return launch_rec_typed<LSTM, 64>(rp, CN, s);
  if (U == 32) return launch_rec_typed<LSTM, 32>(rp, CN, s);
  if (U == 16) return launch_rec_typed<LSTM, 16>(rp, CN, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" {

// Phase (a) of one layer: xg (2, M, G) f32 = x (M, K) W_ih[d] (K, G) + b_ih[d]
// + b_hh[d] outside the reset product, d = 0, 1. cell: 0 = GRU (G = 3H),
// 1 = LSTM (G = 4H); x and w_ih (2, K, G) bf16, the biases (2, G) f32.
// Returns 0 or a cudaError_t value.
int birnn_tc_proj_launch(int cell, const void* x, const void* wih,
                         const void* bih, const void* bhh, void* xg, int M,
                         int K, int H, void* stream, int device) {
  USE_DEVICE(device);
  if ((cell != 0 && cell != 1) || M < 1 || K < 1 || H < 16 || H % 16 != 0)
    return (int)cudaErrorInvalidValue;
  ProjParams pp;
  pp.x = static_cast<const bf16*>(x);
  pp.w = static_cast<const bf16*>(wih);
  pp.bih = static_cast<const float*>(bih);
  pp.bhh = static_cast<const float*>(bhh);
  pp.xg = static_cast<float*>(xg);
  pp.M = M;
  pp.K = K;
  pp.G = (cell ? 4 : 3) * H;
  pp.H = H;
  pp.lstm = cell;
  return launch_proj(pp, static_cast<cudaStream_t>(stream));
}

// Phase (b) of one layer, both directions, zero h0 (and c0): from xg
// (2, L*N, G) f32 and w_hh (2, H, G) bf16 to out (L, N, 2H) bf16 and hn
// (2, N, H) f32. U hidden units a CTA, clusters of H / U CTAs. Returns 0 or
// a cudaError_t value.
int birnn_tc_rec_launch(int cell, const void* xg, const void* whh,
                        const void* bhh, void* out, void* hn, int L, int N,
                        int H, int U, void* stream, int device) {
  USE_DEVICE(device);
  if ((cell != 0 && cell != 1) || L < 1 || N < 1 || H < 16 || H % 16 != 0 ||
      (U != 16 && U != 32 && U != 64) || H % U != 0)
    return (int)cudaErrorInvalidValue;
  const int CN = H / U;
  if (CN != 1 && CN != 2 && CN != 4 && CN != 8) return (int)cudaErrorInvalidValue;
  RecParams rp;
  rp.xg = static_cast<const float*>(xg);
  rp.whh = static_cast<const bf16*>(whh);
  rp.bhh = static_cast<const float*>(bhh);
  rp.out = static_cast<bf16*>(out);
  rp.hn = static_cast<float*>(hn);
  rp.L = L;
  rp.N = N;
  rp.H = H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cell ? launch_rec<true>(rp, U, CN, s) : launch_rec<false>(rp, U, CN, s);
}

}  // extern "C"
