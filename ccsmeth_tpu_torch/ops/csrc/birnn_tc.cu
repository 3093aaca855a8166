// Kernel K1, bf16: the whole bidirectional GRU or LSTM stack on Hopper's
// tensor cores, zero h0 (and c0), layer by layer; K2 (one layer) runs the
// same kernels once. Per layer, ops/bigru.py launches in order on the
// caller's stream:
//   (a) tc_gemm_kernel (birnn_tc_gemm_launch): the input projection of all
//       L steps, both directions: xg (2, L*N, G) f32 = X (L*N, Cin) bf16
//       W_ih (Cin, G) bf16 plus b_ih and the parts of b_hh outside the reset
//       product (GRU: b_hr, b_hz; LSTM: all of b_hh). TMA loads tiles of X
//       (128 x 64) and W_ih (64 x 128, read as stored: N-major) into a
//       three-stage ring on mbarriers, one producer warp; two consumer
//       warpgroups run wgmma (m64n128k16) with f32 accumulators; the
//       epilogue adds the biases and stores xg. Cin % 8 == 0 (TMA's 16-byte
//       row strides); other widths take rnn_proj_kernel
//       (birnn_tc_proj_launch: the Ampere-style mma.sync GEMM, which K4's
//       and K6's tc forwards also call and whose bits their digests pin);
//   (b) tc_rec_kernel (birnn_tc_rec_launch): the recurrence. A cluster of
//       CN = H / U CTAs runs one (tile of R = 64 MR rows, direction); CTA c
//       owns hidden units [c U, (c+1) U) of every gate and keeps its slice of
//       W_hh (H x NG U bf16) in shared memory for all L steps. Its MR x WN
//       warpgroups each take 64 rows and U / WN units, every gate, and run
//       the step's product h W_hh on wgmma from shared memory into registers
//       that start from the step's xg (or, for layer 0, from the biases: see
//       below). With FUSED, the layer's input projection runs in the same
//       kernel: W_ih's slice (Cin <= 64, padded to KX = 16, 32 or 64) stays
//       in shared memory, each step's x_t rows are staged there, and one
//       more wgmma over KX adds x_t W_ih, so that layer's xg never reaches
//       device memory (layer 0: Cin = 11, 28, 52; one launch instead of two).
// fp32 runs birnn_simt.cu, and the shapes neither takes run bigru_stack.cu;
// ops/bigru.py's k1_plan is the shape rule among the three.
//
// Replaces: ccsmeth_tpu/ops/bigru_pallas.py::_make_stack_kernel (GRU :232,
//   LSTM :238-245, launched by _fused_stack_call :373) in bf16, as
//   bigru_stack.cu does, and ::_fused_kernel (:87) / ::_fused_lstm_kernel
//   (:36) (K2, _fused_layer_call :143); like the TPU kernel (:288-294) it
//   keeps the projection in f32, and, like it, keeps layer 0's out of device
//   memory.
//
// Bound on an H100 SXM: the attbigru2s stack does 116 MFLOP of products per
//   row (57% of it the input projection), the attbilstm2s stack 155, so at
//   989 TFLOP/s bf16 it is compute-bound (1024 rows: 0.12 / 0.16 ms). What
//   sets this design's pace instead: the serial chain of NL * L = 63 steps,
//   each a product of R rows x H by H x NG U from shared memory, the gate
//   math (MUFU: two ops a sigmoid or tanh) and the exchange of h across the
//   cluster; the clusters the card holds at once; and the f32 xg of layers
//   1 and 2, written once by (a) and read once by (b).
//
// What the design does about that:
//   - products on wgmma, Hopper's warpgroup tensor-core path, both operands
//     in shared memory in the 128-byte-swizzled K-major layout
//     (wgmma_tile.cuh); the h operand is rounded to bf16 once, where it is
//     stored;
//   - the accumulators start from xg (and the GRU's b_hn on its n gate), so
//     no xg registers are held apart from them (the GRU's n gate keeps its
//     x side, x W_in + b_in, in registers of its own: r multiplies only the h
//     side);
//   - W_hh's columns are staged gate-interleaved: B row (ub NG + gate) 8 + i
//     of CTA c holds column gate H + c U + 8 ub + i, so each thread's
//     accumulators hold every gate of the same (row, unit) pairs; the gate
//     math runs in registers, and so does the GRU's f32 h and the LSTM's c,
//     for all L steps;
//   - the geometry (U, MR, WN) is chosen per cell so that the default 1,024
//     rows take one wave: 16 clusters of 4 CTAs of 128 rows
//     (ops/bigru.py::TC_GEOMETRY), against 30 resident;
//   - the exchange is a dataflow with no cluster barrier in the time loop:
//     the h operand's K blocks of 64 units are CTA c's units [64 c, 64 c +
//     64) exactly, so each CTA's new h is one contiguous block of its buffer
//     and goes to every other CTA of the cluster as one cp.async.bulk copy
//     that completes on the receiver's mbarrier (one h buffer; each CTA
//     tells every other, on that CTA's `empty` barrier, when it has read h
//     for the step, and a sender waits for all of them before it copies, as
//     in birnn_simt.cu); the next step's xg loads fly during the exchange;
//   - the two directions run as separate clusters at the same time: the
//     serial chain is NL * L steps, not 2 NL L;
//   - deterministic: every sum has one owner and a fixed order, no atomics.
//
// Rounding, as the plain version: the weights, the layer inputs and the h
//   operand are bf16 values, products sum in f32 (inside a wgmma in the
//   instruction's own order), the GRU's z h term and the LSTM's c are f32,
//   b_hn stays inside the reset product. Outputs: out (L, N, 2H) bf16, h_n
//   (2 NL, N, H) f32.
//
// Shapes: H % 16 == 0, U = min(H, 64) (or 128 for the GRU's swept
//   geometry), CN = H / U in {1, 2, 4, 8}, CN = 1 unless U % 64 == 0, shared
//   memory within 227 KB (bigru.py's k1_plan checks it before the launch; the
//   C entry points refuse anything else). Layer 0 fuses its projection when
//   Cin <= 64 and the slice fits beside W_hh and h.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (ops/bigru.py builds it at first use). Each C entry
//   point returns cudaGetLastError() after its launch.

#include "wgmma_tile.cuh"
#include "entry_device.cuh"

typedef __nv_bfloat16 bf16;

#define TC_THREADS 256
#define PJ_BM 128
#define PJ_BN 128
#define PJ_BK 32
#define PJ_STAGES 3
#define PJ_AS (PJ_BK + 8)  // row strides of the staged tiles, in bf16
#define PJ_BS (PJ_BN + 8)
#define GM_BM 128     // (a) on TMA + wgmma: rows of a tile, two warpgroups
#define GM_BN 128     // its columns (two 64-column TMA boxes of W_ih)
#define GM_BK 64      // k a stage
#define GM_STAGES 3
#define GM_THREADS 288  // two consumer warpgroups and one producer warp
#define SMEM_LIMIT 232448

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

// ---------------------------------------------------------------- (a) on wgmma

struct GemmParams {
  const float* bih;  // (2, G)
  const float* bhh;  // (2, G)
  float* xg;         // (2, M, G)
  int M, K, G, H, lstm;
};

// One CTA: rows [m0, m0 + 128) of X by columns [n0, n0 + 128) of direction
// d's W_ih. Stage s of the ring holds X's tile (128 rows of 64 k, K-major,
// 128-byte swizzle: TMA's image) and W_ih's (64 k rows of two 64-column
// boxes, N-major, 128-byte swizzle); `full[s]` completes when TMA has
// written both, `empty[s]` when both consumer warpgroups have read them.
// Two CTAs an SM: one's loads and stores overlap the other's products.
__global__ void __launch_bounds__(GM_THREADS, 2)
    tc_gemm_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                   const GemmParams p) {
  constexpr uint32_t A_BYTES = GM_BM * GM_BK * 2, B_BYTES = GM_BK * GM_BN * 2;
  constexpr uint32_t STAGE = A_BYTES + B_BYTES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t full = base + GM_STAGES * STAGE, empty = full + 8 * GM_STAGES;
  const int nb = (p.G + GM_BN - 1) / GM_BN;
  // column blocks vary fastest, so the CTAs that read one tile of X run
  // together and X comes from device memory once
  const int d = blockIdx.x / nb, n0 = (blockIdx.x % nb) * GM_BN, m0 = blockIdx.y * GM_BM;
  const int ktiles = (p.K + GM_BK - 1) / GM_BK;
  const int tid = threadIdx.x, wg = tid >> 7;
  if ((base & 1023) != 0) __trap();  // the swizzled tiles need 1024-byte alignment
  if (tid == 0) {
    for (int s = 0; s < GM_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg == 2) {  // the producer warp: one thread keeps the ring full
    if (tid == 256) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % GM_STAGES;
        if (kt >= GM_STAGES) mbar_wait(empty + 8 * s, ((kt / GM_STAGES) - 1) & 1);
        const uint32_t a = base + s * STAGE, b = a + A_BYTES;
        mbar_expect_tx(full + 8 * s, STAGE);
        tma_load_2d(a, &tx, full + 8 * s, kt * GM_BK, m0);
        tma_load_3d(b, &tw, full + 8 * s, n0, kt * GM_BK, d);
        tma_load_3d(b + B_BYTES / 2, &tw, full + 8 * s, n0 + 64, kt * GM_BK, d);
      }
    }
    return;
  }
  const int lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, t4 = lane & 3;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % GM_STAGES;
    mbar_wait(full + 8 * s, (kt / GM_STAGES) & 1);
    __syncwarp();
    const uint32_t a = base + s * STAGE + wg * 64 * 128, b = base + s * STAGE + A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GM_BK / 16; ++kk)
      Wgmma<128>::mma<1>(acc, kmajor_desc(a + 32 * kk, 128),
                         mnmajor_desc(b + 2048 * kk, B_BYTES / 2, 1024), (kt | kk) != 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous k tile's products are done: free its stage
    fence_regs(acc);
    if (kt > 0 && (tid & 127) == 0) mbar_arrive(empty + 8 * ((kt - 1) % GM_STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);
  const float* bi = p.bih + (size_t)d * p.G;
  const float* bh = p.bhh + (size_t)d * p.G;
#pragma unroll
  for (int j = 0; j < GM_BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t4;
    if (col >= p.G) continue;
    // b_hh joins here except the GRU's b_hn (columns >= 2H), which stays
    // inside the reset product
    const bool fold = p.lstm || col < 2 * p.H;
    const float b0 = bi[col] + (fold ? bh[col] : 0.0f);
    const float b1 = bi[col + 1] + (fold ? bh[col + 1] : 0.0f);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wg * 64 + warp * 16 + g + 8 * hh;
      if (row < p.M)
        *reinterpret_cast<float2*>(p.xg + ((size_t)d * p.M + row) * p.G + col) =
            make_float2(acc[4 * j + 2 * hh] + b0, acc[4 * j + 2 * hh + 1] + b1);
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

__device__ __forceinline__ void st_shared_u16(uint32_t addr, unsigned short v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(v) : "memory");
}

__device__ __forceinline__ void st_shared_v2(uint32_t addr, uint2 v) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(addr), "r"(v.x), "r"(v.y) : "memory");
}

// The B row of a CTA's gate-interleaved operand that holds column gate of
// its unit u (0 <= u < U), NG gates: unit blocks ub of 8 rows each gate, in
// pairs (ub = 2 q + b): row i of block 2 q + b is unit 16 q + 4 (i / 2) + 2 b
// + i % 2, so the two rows 2 t4, 2 t4 + 1 of each block of a pair, which
// wgmma's accumulator layout gives thread t4, are units 16 q + 4 t4 .. + 3
__device__ __forceinline__ int b_row(int ng, int u, int gate) {
  const int q = u >> 4, r = u & 15;
  return ((2 * q + ((r >> 1) & 1)) * ng + gate) * 8 + 2 * (r >> 2) + (r & 1);
}

// 8 k rows x 8 columns of a row-major bf16 matrix at src (row stride ld; k
// rows at and past nk read as 0) into a K-major operand of WB-byte rows at
// blk: column e becomes operand row row_of(e), bytes kb .. kb + 15 (its 8 k
// values, one 16-byte chunk), transposed in registers
template <class RowOf>
__device__ __forceinline__ void stage8x8(uint32_t blk, RowOf row_of, int kb, int wb,
                                         const bf16* src, int ld, int nk) {
  uint32_t w[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint4 v = j < nk ? __ldg(reinterpret_cast<const uint4*>(src + (size_t)j * ld))
                           : make_uint4(0u, 0u, 0u, 0u);
    w[j][0] = v.x;
    w[j][1] = v.y;
    w[j][2] = v.z;
    w[j][3] = v.w;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint32_t sel = (e & 1) ? 0x7632u : 0x5410u;  // high or low halves
    const int m = e >> 1;
    const uint4 o = make_uint4(__byte_perm(w[0][m], w[1][m], sel), __byte_perm(w[2][m], w[3][m], sel),
                               __byte_perm(w[4][m], w[5][m], sel), __byte_perm(w[6][m], w[7][m], sel));
    st_shared_v4(blk + kmajor_off(row_of(e), kb, wb), o);
  }
}

struct TcRecParams {
  const float* xg;   // (2, L N, G) from (a); unread when FUSED
  const bf16* x;     // FUSED: the layer input (L, N, C)
  const bf16* wih;   // FUSED: (2, C, G)
  const float* bih;  // FUSED: (2, G)
  const bf16* whh;   // (2, H, G)
  const float* bhh;  // (2, G): b_hn (GRU), and with FUSED the rest
  bf16* out;         // (L, N, 2H)
  float* hn;         // (2, N, H): this layer's two h_n slices
  int L, N, H, C, KX;  // KX: FUSED's k extent (C rounded up to 16, 32 or 64)
};

// One CTA's shared memory, byte offsets: W_hh's slice [H / 64 K blocks][NC
// rows][128 B]; h [K blocks][R rows][128 B]; with KX, W_ih's slice [NC
// rows][2 KX B] (the GRU's n gate zero), the GRU's n-gate W_ih [U rows][2 KX
// B] and x_t [R rows][2 KX B]; the barriers; the accumulators' start a
// column ([NC]: the biases not in xg) and the GRU's x-side n-gate bias [U].
struct TcRecSmem {
  uint32_t ws, hs, bx, bxn, xs, bars, binit, bxnb, total;
};

__host__ __device__ inline uint32_t round1024(uint32_t v) { return (v + 1023u) & ~1023u; }

__host__ __device__ inline TcRecSmem tc_rec_smem(int ng, int H, int U, int R, int KX) {
  TcRecSmem s;
  const uint32_t kbh = (H + 63) / 64, nc = ng * U, wbx = 2 * KX;
  s.ws = 0;
  s.hs = s.ws + kbh * nc * 128;
  s.bx = s.hs + kbh * R * 128;
  s.bxn = s.bx + (KX ? round1024(nc * wbx) : 0);
  s.xs = s.bxn + (KX && ng == 3 ? round1024(U * wbx) : 0);
  s.bars = s.xs + (KX ? round1024(R * wbx) : 0);
  s.binit = s.bars + 16;
  s.bxnb = s.binit + 4 * nc;
  s.total = s.bxnb + 4 * U;
  return s;
}

// U units a CTA, MR x WN warpgroups: warpgroup (mr, wn) takes tile rows
// [64 mr, 64 mr + 64) and units [wn U / WN, (wn + 1) U / WN) of the CTA's,
// every gate: N = NG U / WN accumulator columns. Thread t of a warpgroup
// holds rows 16 (t / 32) + g, + 8 of them and, in each pair pw of its unit
// blocks, units 16 pw + 4 t4 .. + 3 of it, every gate (wgmma's accumulator
// layout on the B rows of b_row): 16 bytes of xg a gate and row.
template <bool LSTM, int U, int MR, int WN, bool FUSED>
__global__ void __launch_bounds__(128 * MR * WN, 1) tc_rec_kernel(const TcRecParams p) {
  constexpr int NG = LSTM ? 4 : 3;
  constexpr int NC = NG * U;   // staged W_hh columns of this CTA
  constexpr int UPW = U / WN;  // units of a warpgroup
  constexpr int NUB = UPW / 8;  // unit blocks of a warpgroup, in NUB / 2 pairs
  constexpr int NW = NG * UPW;  // a warpgroup's accumulator columns
  constexpr int R = 64 * MR;
  constexpr int THREADS = 128 * MR * WN;
  constexpr int NXN = LSTM ? 2 : UPW / 2;  // the GRU's x-side n gate
  static_assert(U % WN == 0 && UPW % 16 == 0 && NW <= 256, "warpgroup layout");

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const int H = p.H, G = NG * H, L = p.L, N = p.N;
  const TcRecSmem sm = tc_rec_smem(NG, H, U, R, FUSED ? p.KX : 0);
  const int wbx = 2 * p.KX;
  const uint32_t ws = base + sm.ws, hs = base + sm.hs;
  const uint32_t full_bar = base + sm.bars, empty_bar = full_bar + 8;
  float* binit = reinterpret_cast<float*>(smem_raw + sm.binit);
  float* bxnb = reinterpret_cast<float*>(smem_raw + sm.bxnb);
  const uint32_t crank = cluster_ctarank(), cn = cluster_nctarank();
  const int d = blockIdx.y;
  const int row0 = (blockIdx.x / cn) * R;
  const int u0 = crank * U;  // this CTA's first hidden unit
  const int tid = threadIdx.x, wg = tid >> 7;
  const int mr = wg / WN, wn = wg % WN;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int rl0 = mr * 64 + ((tid >> 5) & 3) * 16 + g;  // tile rows rl0 and rl0 + 8
  const int uw = u0 + wn * UPW + 4 * t4;                // units uw + 16 pw .. + 3
  // a CTA's new h, [u0, u0 + U): its own K blocks of the h operand
  const uint32_t block_bytes = U >= 64 ? (U / 64) * R * 128 : 0;
  if ((base & 1023) != 0) __trap();  // the swizzled operands need 1024-byte alignment

  // W_hh's slice, gate-interleaved: B row b_row(NG, u, gate) is column
  // gate H + u0 + u, its H values of k along the row
  const bf16* W = p.whh + (size_t)d * H * G;
  for (int i = tid; i < (H / 8) * NG * (U / 8); i += THREADS) {
    const int cg = i % (NG * (U / 8)), k8 = i / (NG * (U / 8));
    const int gate = cg / (U / 8), ub = cg % (U / 8);
    stage8x8(ws + (k8 >> 3) * NC * 128, [&](int e) { return b_row(NG, 8 * ub + e, gate); },
             (k8 & 7) * 16, 128, W + (size_t)k8 * 8 * G + gate * H + u0 + ub * 8, G, 8);
  }
  for (int i = tid; i < (int)((sm.bx - sm.hs) / 16); i += THREADS)
    st_shared_v4(hs + 16 * i, make_uint4(0u, 0u, 0u, 0u));  // h0 = 0
  const float* bh = p.bhh + (size_t)d * G;
  for (int n = tid; n < NC; n += THREADS) {
    const int gate = (n >> 3) % NG, ub = (n >> 3) / NG, i = n & 7;
    const int col = gate * H + u0 + 16 * (ub >> 1) + 4 * (i >> 1) + 2 * (ub & 1) + (i & 1);
    float v = 0.0f;  // xg holds b_ih and the b_hh outside the reset product
    if (!LSTM && gate == 2)
      v = bh[col];  // b_hn, inside the reset product
    else if constexpr (FUSED)
      v = p.bih[(size_t)d * G + col] + bh[col];
    binit[n] = v;
  }
  for (int u = tid; u < U; u += THREADS) {
    float v = 0.0f;
    if constexpr (FUSED && !LSTM) v = p.bih[(size_t)d * G + 2 * H + u0 + u];  // b_in
    bxnb[u] = v;
  }
  if constexpr (FUSED) {
    // W_ih's slice as W_hh's (the GRU's n gate zero: its x side runs apart),
    // k rows past C zero
    const int C = p.C;
    const bf16* Wx = p.wih + (size_t)d * C * G;
    for (int i = tid; i < (p.KX / 8) * NG * (U / 8); i += THREADS) {
      const int cg = i % (NG * (U / 8)), k8 = i / (NG * (U / 8));
      const int gate = cg / (U / 8), ub = cg % (U / 8);
      const int nk = (!LSTM && gate == 2) ? 0 : min(8, C - k8 * 8);
      stage8x8(base + sm.bx, [&](int e) { return b_row(NG, 8 * ub + e, gate); }, k8 * 16, wbx,
               Wx + (size_t)k8 * 8 * G + gate * H + u0 + ub * 8, G, nk);
    }
    if constexpr (!LSTM)
      for (int i = tid; i < (p.KX / 8) * (U / 8); i += THREADS) {
        const int ub = i % (U / 8), k8 = i / (U / 8);
        stage8x8(base + sm.bxn, [&](int e) { return b_row(1, 8 * ub + e, 0); }, k8 * 16, wbx,
                 Wx + (size_t)k8 * 8 * G + 2 * H + u0 + ub * 8, G, min(8, C - k8 * 8));
      }
    for (int i = tid; i < R * wbx / 16; i += THREADS)
      st_shared_v4(base + sm.xs + 16 * i, make_uint4(0u, 0u, 0u, 0u));
  }
  if (tid == 0) {
    mbar_init(full_bar, 1);
    mbar_init(empty_bar, cn > 1 ? cn - 1 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the bias tables

  // x_t's rows of the tile into the x operand (columns past C stay 0)
  auto stage_x = [&](int t) {
    const int C = p.C, nr = min(R, N - row0);
    const unsigned short* src =
        reinterpret_cast<const unsigned short*>(p.x + ((size_t)t * N + row0) * C);
    for (int i = tid; i < nr * C; i += THREADS) {
      const int r = i / C, c = i - r * C;
      st_shared_u16(base + sm.xs + kmajor_off(r, 2 * c, wbx), __ldg(src + i));
    }
  };

  float acc[NW / 2];
  float xn[NXN];
  float st[NUB / 2][2][4];  // GRU: h; LSTM: c (f32), of unit pair, row half, unit
#pragma unroll
  for (int pw = 0; pw < NUB / 2; ++pw)
#pragma unroll
    for (int q = 0; q < 8; ++q) st[pw][q >> 2][q & 3] = 0.0f;
#pragma unroll
  for (int i = 0; i < NXN; ++i) xn[i] = 0.0f;

  // the accumulators' start for step t: xg (and b_hn on the GRU's n gate),
  // or with FUSED the biases; the GRU's x-side n gate xg_n, or b_in.
  // Accumulator 4 (ubw NG + gate) + 2 hh + e holds row hh, unit 4 t4 + 2
  // (ubw % 2) + e of pair ubw / 2
  auto init_acc = [&](int t) {
    const float* xt = p.xg + ((size_t)d * L + t) * N * G;
#pragma unroll
    for (int pw = 0; pw < NUB / 2; ++pw)
#pragma unroll
      for (int gate = 0; gate < NG; ++gate) {
        const int n0 = (((wn * NUB + 2 * pw) * NG + gate) * 8) + 2 * t4;  // block 2 pw's row
        const float2 b0 = *reinterpret_cast<const float2*>(binit + n0);
        const float2 b1 = *reinterpret_cast<const float2*>(binit + n0 + 8 * NG);
        const int a0 = 4 * (2 * pw * NG + gate), a1 = 4 * ((2 * pw + 1) * NG + gate);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (!FUSED && (LSTM || gate < 2)) {
            const int row = row0 + rl0 + 8 * hh;
            if (row < N) v = ld_nc_f4(xt + (size_t)row * G + gate * H + uw + 16 * pw);
          }
          acc[a0 + 2 * hh] = v.x + b0.x;
          acc[a0 + 2 * hh + 1] = v.y + b0.y;
          acc[a1 + 2 * hh] = v.z + b1.x;
          acc[a1 + 2 * hh + 1] = v.w + b1.y;
        }
      }
    if constexpr (!LSTM) {
#pragma unroll
      for (int pw = 0; pw < NUB / 2; ++pw)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float4 v;
          if constexpr (FUSED) {
            v = *reinterpret_cast<const float4*>(bxnb + uw - u0 + 16 * pw);
          } else {
            const int row = row0 + rl0 + 8 * hh;
            v = row < N ? ld_nc_f4(xt + (size_t)row * G + 2 * H + uw + 16 * pw)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
          xn[8 * pw + 2 * hh] = v.x;
          xn[8 * pw + 2 * hh + 1] = v.y;
          xn[8 * pw + 4 + 2 * hh] = v.z;
          xn[8 * pw + 4 + 2 * hh + 1] = v.w;
        }
    }
  };

  init_acc(d == 0 ? 0 : L - 1);
  if constexpr (FUSED) stage_x(d == 0 ? 0 : L - 1);
  fence_async_shared();  // the staged operands, visible to wgmma
  cluster_sync_all();    // every CTA of the cluster has staged W, zeroed h, set its barriers

  for (int s = 0; s < L; ++s) {
    const int t = d == 0 ? s : L - 1 - s;
    const bool last = s == L - 1;
    // every block of h(s) is here (one buffer: the barrier's phase s - 1)
    if (s > 0) mbar_wait(full_bar, (s - 1) & 1);
    __syncwarp();
    fence_regs(acc);
    fence_regs(xn);
    wgmma_fence();
    if constexpr (FUSED) {
      const uint32_t xa = base + sm.xs + mr * 64 * wbx;
      for (int kk = 0; kk < p.KX / 16; ++kk) {
        const uint64_t da = kmajor_desc(xa + 32 * kk, wbx);
        Wgmma<NW>::template mma<0>(acc, da, kmajor_desc(base + sm.bx + wn * NW * wbx + 32 * kk, wbx),
                                   1);
        if constexpr (!LSTM)
          Wgmma<UPW>::template mma<0>(
              xn, da, kmajor_desc(base + sm.bxn + wn * UPW * wbx + 32 * kk, wbx), 1);
      }
    }
    for (int ks = 0; ks < H / 16; ++ks) {
      const uint32_t kb = ks >> 2, sub = (ks & 3) * 32;
      Wgmma<NW>::template mma<0>(acc, kmajor_desc(hs + kb * R * 128 + mr * 64 * 128 + sub, 128),
                                 kmajor_desc(ws + kb * NC * 128 + wn * NW * 128 + sub, 128), 1);
    }
    wgmma_commit();
    if constexpr (!FUSED) {
      // the next step's xg slice into L2 while the products run, so that
      // init_acc's loads come from L2 and not from device memory
      if (!last) {
        constexpr int LPR = U >= 32 ? U / 32 : 1;  // 128-byte lines of a row's units
        const float* xt = p.xg + ((size_t)d * L + (d == 0 ? s + 1 : L - 2 - s)) * N * G + u0;
        for (int i = tid; i < R * NG * LPR; i += THREADS) {
          const int row = row0 + i / (NG * LPR), gate = (i / LPR) % NG;
          if (row < N) prefetch_l2(xt + (size_t)row * G + gate * H + 32 * (i % LPR));
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(xn);
    if (!last) {
      // this CTA has read h(s), and its copies out of the buffer are done
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncthreads();
      if (tid < (int)cn && tid != (int)crank) mbar_arrive_remote(empty_bar, tid);
    }

    uint2 hp[NUB / 2][2];  // the new h of 4 units, bf16
#pragma unroll
    for (int pw = 0; pw < NUB / 2; ++pw)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float hv[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          // unit 4 t4 + v of the pair: block 2 pw + v / 2, its column v % 2
          const int ubw = 2 * pw + (v >> 1), q = 2 * hh + (v & 1);
          float& sv = st[pw][hh][v];
          if constexpr (LSTM) {
            const float gi = sigmoid_tc(acc[4 * (ubw * 4 + 0) + q]);
            const float gf = sigmoid_tc(acc[4 * (ubw * 4 + 1) + q]);
            const float gg = tanh_tc(acc[4 * (ubw * 4 + 2) + q]);
            const float go = sigmoid_tc(acc[4 * (ubw * 4 + 3) + q]);
            sv = gf * sv + gi * gg;  // c' = f c + i g, h' = o tanh(c')
            hv[v] = go * tanh_tc(sv);
          } else {
            const float rg = sigmoid_tc(acc[4 * (ubw * 3 + 0) + q]);
            const float zg = sigmoid_tc(acc[4 * (ubw * 3 + 1) + q]);
            const float ng = tanh_tc(xn[4 * ubw + q] + rg * acc[4 * (ubw * 3 + 2) + q]);
            hv[v] = (1.0f - zg) * ng + zg * sv;
            sv = hv[v];
          }
        }
        hp[pw][hh] = make_uint2(pack_bf16x2(hv[0], hv[1]), pack_bf16x2(hv[2], hv[3]));
        const int row = row0 + rl0 + 8 * hh;
        if (row < N) {
          *reinterpret_cast<uint2*>(p.out + ((size_t)t * N + row) * 2 * H + d * H + uw +
                                    16 * pw) = hp[pw][hh];
          if (last)
            *reinterpret_cast<float4*>(p.hn + ((size_t)d * N + row) * H + uw + 16 * pw) =
                make_float4(hv[0], hv[1], hv[2], hv[3]);
        }
      }
    if (last) break;
    const int tn = d == 0 ? s + 1 : L - 2 - s;
    init_acc(tn);  // its loads fly during the exchange
    // the new h of this CTA's units into its own buffer: unit k of row r at
    // K block k / 64, row r, bytes 2 (k % 64)
#pragma unroll
    for (int pw = 0; pw < NUB / 2; ++pw)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int k = uw + 16 * pw;
        st_shared_v2(hs + (k >> 6) * R * 128 + kmajor_off(rl0 + 8 * hh, (k & 63) * 2, 128),
                     hp[pw][hh]);
      }
    fence_async_shared();  // visible to the copies and to wgmma
    __syncthreads();
    if (tid == 0) {
      // the blocks of h(s + 1) to come
      mbar_expect_tx(full_bar, (cn - 1) * block_bytes);
      if (cn > 1) mbar_wait(empty_bar, s & 1);  // every other CTA has read h(s)
      const uint32_t src = hs + (u0 >> 6) * R * 128;
      for (uint32_t r = 1; r < cn; ++r) bulk_to_peer(src, block_bytes, full_bar, (crank + r) % cn);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    if constexpr (FUSED) {
      stage_x(tn);  // its loads fly while the blocks do
      fence_async_shared();
      __syncthreads();
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  cluster_sync_all();  // no CTA leaves while another may still reach its shared memory
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

// The recurrence's geometries instantiated, (U, MR, WN), both cells, with
// and without the fused projection; the GRU also (128, 1, 4), unfused
// (ops/bigru.py::TC_GEOMETRY and TC_SWEEP)
#define TC_GEOMETRIES(X) \
  X(64, 2, 2)            \
  X(64, 1, 2)            \
  X(32, 2, 2)            \
  X(16, 2, 1)

static const void* tc_rec_kernel_ptr(int cell, int U, int MR, int WN, bool fused) {
#define TC_PICK(U_, MR_, WN_)                                                    \
  if (U == U_ && MR == MR_ && WN == WN_) {                                       \
    if (cell == 0) return fused ? (const void*)tc_rec_kernel<false, U_, MR_, WN_, true> \
                                : (const void*)tc_rec_kernel<false, U_, MR_, WN_, false>; \
    return fused ? (const void*)tc_rec_kernel<true, U_, MR_, WN_, true>          \
                 : (const void*)tc_rec_kernel<true, U_, MR_, WN_, false>;        \
  }
  TC_GEOMETRIES(TC_PICK)
#undef TC_PICK
  if (cell == 0 && U == 128 && MR == 1 && WN == 4 && !fused)
    return (const void*)tc_rec_kernel<false, 128, 1, 4, false>;
  return nullptr;
}

// The kernel, its threads and shared memory for one geometry, with the
// shared-memory attribute set; nullptr if not instantiated or not valid
static const void* tc_rec_setup(int cell, int H, int U, int MR, int WN, int KX, size_t* smem,
                                int* threads, cudaError_t* err) {
  *err = cudaSuccess;
  if ((cell != 0 && cell != 1) || H < 16 || H % 16 != 0 || U < 16 || H % U != 0) return nullptr;
  const int cn = H / U;
  if (cn != 1 && cn != 2 && cn != 4 && cn != 8) return nullptr;
  if (cn > 1 && U % 64 != 0) return nullptr;  // a CTA's h block is whole K blocks
  if (KX != 0 && KX != 16 && KX != 32 && KX != 64) return nullptr;
  const void* k = tc_rec_kernel_ptr(cell, U, MR, WN, KX != 0);
  if (k == nullptr) return nullptr;
  *smem = tc_rec_smem(cell ? 4 : 3, H, U, 64 * MR, KX).total;
  if (*smem > SMEM_LIMIT) return nullptr;
  *threads = 128 * MR * WN;
  *err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return k;
}

static void tc_rec_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int cn, int tiles,
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

// Phase (a) of one layer on TMA + wgmma: xg (2, M, G) f32 = x (M, K)
// W_ih[d] (K, G) + b_ih[d] + b_hh[d] outside the reset product, d = 0, 1.
// cell: 0 = GRU (G = 3H), 1 = LSTM (G = 4H); x and w_ih (2, K, G) bf16,
// 16-byte aligned, K % 8 == 0; the biases (2, G) f32. Returns 0 or a
// cudaError_t value.
int birnn_tc_gemm_launch(int cell, const void* x, const void* wih, const void* bih,
                         const void* bhh, void* xg, int M, int K, int H, void* stream,
                         int device) {
  USE_DEVICE(device);
  if ((cell != 0 && cell != 1) || M < 1 || K < 8 || K % 8 != 0 || H < 16 || H % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wih)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int G = (cell ? 4 : 3) * H;
  CUtensorMap tx, tw;
  const cuuint64_t xdims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t xstrides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xbox[2] = {GM_BK, GM_BM};
  const cuuint64_t wdims[3] = {(cuuint64_t)G, (cuuint64_t)K, 2};
  const cuuint64_t wstrides[2] = {(cuuint64_t)G * 2, (cuuint64_t)K * G * 2};
  const cuuint32_t wbox[3] = {64, GM_BK, 1};
  const CUresult ex = bf16_tensor_map(&tx, x, 2, xdims, xstrides, xbox);
  if (ex != CUDA_SUCCESS) return ex == CUDA_ERROR_NOT_SUPPORTED ? (int)cudaErrorNotSupported
                                                                 : (int)cudaErrorInvalidValue;
  if (bf16_tensor_map(&tw, wih, 3, wdims, wstrides, wbox) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  GemmParams gp;
  gp.bih = static_cast<const float*>(bih);
  gp.bhh = static_cast<const float*>(bhh);
  gp.xg = static_cast<float*>(xg);
  gp.M = M;
  gp.K = K;
  gp.G = G;
  gp.H = H;
  gp.lstm = cell;
  const size_t smem = (size_t)GM_STAGES * (GM_BM + GM_BN) * GM_BK * 2 + 16 * GM_STAGES;
  cudaError_t e =
      cudaFuncSetAttribute(tc_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(2 * ((G + GM_BN - 1) / GM_BN), (M + GM_BM - 1) / GM_BM);
  tc_gemm_kernel<<<grid, GM_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(tx, tw, gp);
  return (int)cudaGetLastError();
}

// Phase (b) of one layer, both directions, zero h0 (and c0): from xg
// (2, L*N, G) f32, or with KX > 0 from x (L, N, C) bf16, w_ih (2, C, G)
// bf16 and b_ih (2, G) f32 (the projection fused, C <= KX in {16, 32, 64}),
// and w_hh (2, H, G) bf16, b_hh (2, G) f32, to out (L, N, 2H) bf16 and hn
// (2, N, H) f32. U hidden units a CTA, clusters of H / U CTAs, MR row blocks
// of 64 and WN unit groups a CTA. Returns 0 or a cudaError_t value.
int birnn_tc_rec_launch(int cell, const void* xg, const void* x, const void* wih,
                        const void* bih, const void* whh, const void* bhh, void* out, void* hn,
                        int L, int N, int H, int C, int U, int MR, int WN, int KX, void* stream,
                        int device) {
  USE_DEVICE(device);
  if (L < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (KX ? (x == nullptr || wih == nullptr || bih == nullptr || C < 1 || C > KX)
         : xg == nullptr)
    return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  int threads = 0;
  cudaError_t e;
  const void* k = tc_rec_setup(cell, H, U, MR, WN, KX, &smem, &threads, &e);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  TcRecParams q;
  q.xg = static_cast<const float*>(xg);
  q.x = static_cast<const bf16*>(x);
  q.wih = static_cast<const bf16*>(wih);
  q.bih = static_cast<const float*>(bih);
  q.whh = static_cast<const bf16*>(whh);
  q.bhh = static_cast<const float*>(bhh);
  q.out = static_cast<bf16*>(out);
  q.hn = static_cast<float*>(hn);
  q.L = L;
  q.N = N;
  q.H = H;
  q.C = KX ? C : 0;
  q.KX = KX;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  tc_rec_config(&cfg, attr, H / U, (N + 64 * MR - 1) / (64 * MR), threads, smem,
                static_cast<cudaStream_t>(stream));
  void* args[1] = {&q};
  e = cudaLaunchKernelExC(&cfg, k, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of the recurrence at (cell, H, U, MR, WN, KX) the card
// holds at once (cudaOccupancyMaxActiveClusters for the kernel, block and
// shared memory that birnn_tc_rec_launch launches), into *clusters, and its
// shared memory a CTA into *smem_bytes. Launches nothing. Returns 0 or a
// cudaError_t value.
int birnn_tc_rec_occupancy(int cell, int H, int U, int MR, int WN, int KX, int* clusters,
                           int* smem_bytes, int device) {
  USE_DEVICE(device);
  size_t smem = 0;
  int threads = 0;
  cudaError_t e;
  const void* k = tc_rec_setup(cell, H, U, MR, WN, KX, &smem, &threads, &e);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  tc_rec_config(&cfg, attr, H / U, 1, threads, smem, nullptr);
  *smem_bytes = (int)smem;
  return (int)cudaOccupancyMaxActiveClusters(clusters, (const void*)k, &cfg);
}

}  // extern "C"
