// Kernels K1 and K2 in fp32 (the `simt` design): one bidirectional GRU or
// LSTM layer, zero h0 (and c0), as two launches that ops/bigru.py makes in
// order on the caller's stream, layer after layer for K1, once for K2:
//   (a) the input projection of all L steps, both directions: xg (2, L N,
//       G) f32 = X (L N, Cin) W_ih[d] + b_ih[d] + the b_hh[d] columns outside
//       the GRU's reset product (all of the LSTM's): bigru_train.cu's
//       k4_proj_launch, which runs rnn_train_gemm.cuh's f32_tma_kernel
//       (128 x 128 tiles, 8 x 16 outputs a thread, a TMA ring of k tiles
//       on mbarriers);
//   (b) the recurrence (birnn_rec_kernel, birnn_simt_rec_launch), both
//       directions at once from xg. A cluster of CN = H / U CTAs runs one
//       (tile of R rows, direction); CTA c keeps the NG U columns of W_hh of
//       its units [c U, (c+1) U) in shared memory for all L steps and h of
//       the tile's R rows, [k][row], in one buffer. Four product warps: a
//       thread sums RT rows x 2 units of every gate (an SGEMM-like
//       micro-tile, 9 x 6 for the GRU, 9 x 8 for the LSTM), its operands
//       loaded a few k ahead; four gate warps: each takes one unit's sums of
//       a micro-tile through shared memory, so eight warps run the gate
//       math, each cell's state f32 in its thread's registers. A step: the
//       product of the tile's h by the W slice, the gate math, then the
//       CTA's new h (its U units, one contiguous block
//       of the buffer) goes to every other CTA of the cluster by bulk
//       copies (cp.async.bulk) that complete on the receiver's mbarrier:
//       a dataflow with no cluster barrier in the time loop, with an `empty`
//       handshake before the copies. The next step's xg is loaded while the
//       copies fly. No residuals: each direction's last f32 h goes to h_n.
//       ops/bigru.py::k1_plan picks (U, R); birnn_simt_rec_occupancy
//       reports how many clusters of a geometry the card holds at once.
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
//   recurrence's pace is set by its serial chain of L steps a direction, and
//   within a step by shared memory's operand rate: a warp's load of one word
//   a lane takes one of the SM's 128-byte wavefronts a clock (a 16-byte load
//   four, even when the lanes share the address), against four warps'
//   FFMAs a clock. A thread's micro-tile of RT rows by 2 NG columns costs
//   RT + 2 NG words a k for 2 NG RT FMAs: 15 for 54 (GRU) and 17 for 72
//   (LSTM), where a 4 x 6 tile costs 10 for 24 and the training forward's
//   (rnn_train_rec.cuh) 9 x 4 costs 13 for 36. At H = 256 (clusters
//   of 8, U = 32) R = 72: 15 tiles a direction at 1,024 rows, 30 clusters,
//   two full waves of the 15 clusters of 8 that the H100 holds at one CTA
//   an SM (the one CTA's shared memory: W_hh's slice, h and the gate warps'
//   sums, 185,888 bytes for the GRU, 223,264 for the LSTM). On the card a
//   step at 1,024 rows (chip_smoke.py --only k1_simt_probe) is ~65% the
//   product, at ~0.7 of the FMA rate inside it (5 loads and 54 / 72 FFMAs
//   a k, one warp a scheduler), ~15% the wait on `full` for the peers' h
//   and ~14% the gate math: the recurrence runs at ~0.35 of its bound. A
//   variant that streams W_hh through a TMA ring to fit 160-row tiles in
//   one wave at 1,024 rows ran slower at every row count (its product's
//   operand rate, its gate math in series, its copies' count).
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

#define K1_PW 128                 // the product's threads: a warp on each of the SM's schedulers
#define K1_THREADS (2 * K1_PW)    // and as many gate-math threads

// U units a CTA, RT rows a thread. The 128 product threads are UP = U / 2
// unit pairs by SL = 128 / UP row slots; product thread t owns the pair up =
// t % UP (units u0 + 2 up, u0 + 2 up + 1, every gate: a micro-tile of RT
// rows by 2 NG gate columns) and the RT rows of slot q = t / UP,
// fwd_row(RT, SL, q, i) (quads of consecutive rows, then one row a slot), a
// tile of R = SL RT rows. The gate math of unit u0 + 2 up + 1 of those rows
// runs in gate thread 128 + t, which takes their sums from shared memory
// (`pre`, [i][gate][t]) and keeps their state; product thread t runs unit u0
// + 2 up's. So the gate math runs in eight warps, two on each scheduler,
// half the cells a thread.
//
// Shared memory, per k: W_hh's NG U columns of the CTA's units as [up]
// [gate 0, 1][e] (16 bytes a pair) then [up][gate 2 (, 3)][e] (8 or 16);
// h as [k][row]. A k of the product costs a thread one 16-byte W load (and
// an 8- or 16-byte one), RT / 4 16-byte h loads and RT % 4 4-byte ones: NG
// 2 + RT words for 2 NG RT FMAs (GRU 15 for 54, LSTM 17 for 72). The lanes
// of a unit pair read neighbouring 16-byte pieces of W, the lanes of a row
// slot one address of h.
//
// The exchange is a dataflow, with no cluster barrier in the time loop.
// CTA c writes its units' new h, [c U, (c+1) U) x R rows, one contiguous
// block of its h buffer, and one thread copies that block to the same place
// in each other CTA of the cluster (cp.async.bulk, completing on the
// receiver's `full` barrier, which its thread 0 armed with the bytes to
// come). One h buffer: each CTA tells every other, on that CTA's `empty`
// barrier, when it has read h for the step, and a sender waits for all of
// them before it copies; a CTA overwrites its own block only after its
// copies of the last step have read it (cp.async.bulk.wait_group.read).
// `full` completes once a step (phase s: the peers' blocks of h(s + 1)),
// `empty` once a step (phase s: every peer has read h(s)); neither runs a
// phase ahead (a peer's blocks of h(s + 2) need this CTA's `empty` arrival
// of step s + 1, made after its wait on `full` phase s).
template <int U, int RT>
struct RecGeom {
  static constexpr int UP = U / 2, SL = K1_PW / UP, R = SL * RT;
};

template <bool LSTM, int U, int RT>
__global__ void __launch_bounds__(K1_THREADS, 1) birnn_rec_kernel(const RecParams p) {
  constexpr int NG = LSTM ? 4 : 3;
  constexpr int UP = RecGeom<U, RT>::UP, SL = RecGeom<U, RT>::SL, R = RecGeom<U, RT>::R;
  constexpr int NGU = NG * U, WB = 4 * UP;  // floats a k; where gate 2's block starts
  constexpr int NQ = RT / 4;                // quads of rows a thread
  // k's of operands in flight ahead of the FMAs: the four warps' loads queue
  // at shared memory, so one k ahead leaves the GRU's late; the LSTM's
  // larger tile has the registers for one
  constexpr int AHEAD = LSTM ? 1 : 3;
  static_assert(UP * SL == K1_PW && U % 16 == 0, "thread layout");
  // the product's loads of the AHEAD k's past H stay inside shared memory
  static_assert(RT * NG * K1_PW >= AHEAD * R, "room past h");
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, G = NG * H, L = p.L, N = p.N;
  float* ws = smem;                    // [H][NG U]: W_hh of the CTA's units
  float* hs = smem + (size_t)H * NGU;  // [H][R]: the h operand
  float* pre = hs + (size_t)H * R;     // [RT][NG][K1_PW]: sums for the gate threads
  const uint32_t full_bar = smem_u32(pre + RT * NG * K1_PW);
  const uint32_t empty_bar = full_bar + 8;
  const uint32_t crank = cluster_ctarank(), cn = cluster_nctarank();
  const int d = blockIdx.y;
  const int row0 = (blockIdx.x / cn) * R;
  const int u0 = crank * U;
  const int tid = threadIdx.x;
  const bool prod = tid < K1_PW;  // a product thread (else a gate thread)
  const int pt = tid % K1_PW;     // the micro-tile this thread works on
  const int up = pt % UP, q = pt / UP;
  const int unit = u0 + 2 * up + (prod ? 0 : 1);  // the unit of its gate math (global)
  const uint32_t block_bytes = U * R * 4;          // one CTA's units of h

  const float* W = p.whh + (size_t)d * H * G;
  for (int i = tid; i < H * NG * UP; i += K1_THREADS) {
    const int pu = i % UP, gate = (i / UP) % NG, k = i / (NG * UP);
    const int o = k * NGU + (gate < 2 ? pu * 4 + gate * 2 : WB + pu * (NG - 2) * 2 + (gate - 2) * 2);
    *reinterpret_cast<float2*>(ws + o) =
        __ldg(reinterpret_cast<const float2*>(W + (size_t)k * G + gate * H + u0 + 2 * pu));
  }
  for (int i = tid; i < H * R / 4; i += K1_THREADS)
    reinterpret_cast<float4*>(hs)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // h0 = 0
  if (tid == 0) {
    mbar_init(full_bar, 1);
    mbar_init(empty_bar, cn > 1 ? cn - 1 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  const float bhn = LSTM ? 0.0f : p.bhh[(size_t)d * G + 2 * H + unit];
  float st[RT];      // GRU: h; LSTM: c; f32, of the thread's cells
  float xc[RT][NG];  // the projection of their next step
#pragma unroll
  for (int i = 0; i < RT; ++i) st[i] = 0.0f;

  auto load_x = [&](int t) {
    const float* xt = p.xg + ((size_t)d * L + t) * N * G + unit;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int row = row0 + fwd_row(RT, SL, q, i);
#pragma unroll
      for (int gate = 0; gate < NG; ++gate)
        xc[i][gate] = row < N ? gm_ld1(xt + (size_t)row * G + gate * H) : 0.0f;
    }
  };
  // the operands of k: w[gate][e] of the pair's units, h of the rows (wp, hp:
  // this thread's first words of k's W and h rows)
  const float* wp = ws + 4 * up;
  const float* hp = hs + 4 * q;
  auto load_k = [&](int k, float (&w)[NG][2], float (&h)[RT]) {
    const float* wk = wp + k * NGU;
    const float4 w01 = *reinterpret_cast<const float4*>(wk);
    w[0][0] = w01.x;
    w[0][1] = w01.y;
    w[1][0] = w01.z;
    w[1][1] = w01.w;
    if constexpr (LSTM) {
      const float4 w23 = *reinterpret_cast<const float4*>(wk + WB);
      w[2][0] = w23.x;
      w[2][1] = w23.y;
      w[3][0] = w23.z;
      w[3][1] = w23.w;
    } else {
      const float2 w2 = *reinterpret_cast<const float2*>(wk + WB - 2 * up);
      w[2][0] = w2.x;
      w[2][1] = w2.y;
    }
    const float* hk = hp + k * R;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(hk + j * SL * 4);
      h[4 * j] = v.x;
      h[4 * j + 1] = v.y;
      h[4 * j + 2] = v.z;
      h[4 * j + 3] = v.w;
    }
#pragma unroll
    for (int i = NQ * 4; i < RT; ++i) h[i] = hk[fwd_row(RT, SL, q, i) - 4 * q];
  };

  load_x(d == 0 ? 0 : L - 1);
  cluster_sync_all();  // every CTA has staged W, zeroed h and set up its barriers

  for (int s = 0; s < L; ++s) {
    const int t = d == 0 ? s : L - 1 - s;
    const bool last = s == L - 1;
    float sum[RT][NG];  // the recurrent sums of this thread's cells
    if (prod) {
      // every block of h(s) is here: `full` phase s - 1
      if (cn > 1 && s > 0) mbar_wait(full_bar, (s - 1) & 1);
      // the product: each (row, unit, gate) one fmaf chain over k ascending
      // from 0.0f; the operands of k + AHEAD load while k's FMAs run, a ring
      // of NS register sets
      float acc[RT][NG][2];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int gate = 0; gate < NG; ++gate) acc[i][gate][0] = acc[i][gate][1] = 0.0f;
      constexpr int NS = AHEAD + 1;
      static_assert(16 % NS == 0, "the ring's sets divide every H (16 or a multiple of 32)");
      float wr[NS][NG][2], hr[NS][RT];
#pragma unroll
      for (int j = 0; j < AHEAD; ++j) load_k(j, wr[j], hr[j]);
      for (int k0 = 0; k0 < H; k0 += NS) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          // past H the loads read the next region (h, `pre`): unused
          load_k(k0 + j + AHEAD, wr[(j + AHEAD) % NS], hr[(j + AHEAD) % NS]);
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int gate = 0; gate < NG; ++gate) {
              acc[i][gate][0] = fmaf(hr[j][i], wr[j][gate][0], acc[i][gate][0]);
              acc[i][gate][1] = fmaf(hr[j][i], wr[j][gate][1], acc[i][gate][1]);
            }
        }
      }
      // the second unit's sums to its gate thread
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int gate = 0; gate < NG; ++gate) {
          pre[(i * NG + gate) * K1_PW + pt] = acc[i][gate][1];
          sum[i][gate] = acc[i][gate][0];
        }
    }
    if (!last && cn > 1 && tid == 0) {
      // this CTA's copies of its last block have read it; the blocks of
      // h(s + 1) to come
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      mbar_expect_tx(full_bar, (cn - 1) * block_bytes);
    }
    __syncthreads();  // every thread has read h(s) (the peers may send h(s + 1)); `pre` is whole
    if (!last && cn > 1 && tid < (int)cn && tid != (int)crank) mbar_arrive_remote(empty_bar, tid);
    if (!prod) {
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int gate = 0; gate < NG; ++gate) sum[i][gate] = pre[(i * NG + gate) * K1_PW + pt];
    }
    float hnew[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int row = row0 + fwd_row(RT, SL, q, i);
      float a[4];  // the cell's activations
      if constexpr (LSTM) {
        a[0] = sigmoid_f(xc[i][0] + sum[i][0]);
        a[1] = sigmoid_f(xc[i][1] + sum[i][1]);
        a[2] = tanhf(xc[i][2] + sum[i][2]);
        a[3] = sigmoid_f(xc[i][3] + sum[i][3]);
        st[i] = fmaf(a[1], st[i], a[0] * a[2]);  // c' = f c + i g
        hnew[i] = a[3] * tanhf(st[i]);           // h' = o tanh(c')
      } else {
        a[0] = sigmoid_f(xc[i][0] + sum[i][0]);  // r
        a[1] = sigmoid_f(xc[i][1] + sum[i][1]);  // z
        a[3] = sum[i][2] + bhn;                  // hg_n
        a[2] = tanhf(xc[i][2] + a[0] * a[3]);    // n
        st[i] = (1.0f - a[1]) * a[2] + a[1] * st[i];
        hnew[i] = st[i];
      }
      if (row < N) {
        p.out[((size_t)t * N + row) * 2 * H + d * H + unit] = hnew[i];
        if (last) p.hn[((size_t)d * N + row) * H + unit] = hnew[i];
      }
    }
    if (last) break;
    load_x(d == 0 ? s + 1 : L - 2 - s);
    // the new h of this thread's unit into the CTA's block, [unit][row]
    float* hu = hs + (size_t)unit * R;
#pragma unroll
    for (int j = 0; j < NQ; ++j)
      *reinterpret_cast<float4*>(hu + (j * SL + q) * 4) =
          make_float4(hnew[4 * j], hnew[4 * j + 1], hnew[4 * j + 2], hnew[4 * j + 3]);
#pragma unroll
    for (int i = NQ * 4; i < RT; ++i) hu[fwd_row(RT, SL, q, i)] = hnew[i];
    if (cn > 1) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the copies
    __syncthreads();  // the block is whole
    if (cn > 1 && tid == 0) {
      mbar_wait(empty_bar, s & 1);  // every other CTA has read h(s)
      const uint32_t src = smem_u32(hs + (size_t)u0 * R);
      for (uint32_t r = 1; r < cn; ++r) bulk_to_peer(src, block_bytes, full_bar, (crank + r) % cn);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (cn > 1 && tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  cluster_sync_all();  // no CTA leaves while another may still reach its shared memory
}

// The geometries instantiated, (U, RT) for each cell: H = 256 takes (32, 9)
// (ops/bigru.py::SIMT_GEOMETRY: R = 72, 15 tiles a direction at 1,024 rows,
// two full waves of the 15 clusters of 8 the card holds), H = 32 .. 128
// (32, 4): R = 32, twice the CTAs of 72 rows at the aggregate model's short
// chain (H 32, L 11), H = 16 (16, 4): R = 64. The last of a cell is a
// candidate of chip_smoke.py's SIMT_SWEEP (GRU 80 rows, LSTM 64: its 80 do
// not fit beside the LSTM's W_hh slice).
#define GRU_GEOMETRIES(X) \
  X(false, 32, 9)         \
  X(false, 32, 4)         \
  X(false, 16, 4)         \
  X(false, 32, 10)
#define LSTM_GEOMETRIES(X) \
  X(true, 32, 9)           \
  X(true, 32, 4)           \
  X(true, 16, 4)           \
  X(true, 32, 8)

static const void* rec_kernel(int cell, int U, int R) {
#define REC_PICK(LS, U_, RT_)                                            \
  if (cell == (LS ? 1 : 0) && U == U_ && R == RecGeom<U_, RT_>::R) \
    return (const void*)birnn_rec_kernel<LS, U_, RT_>;
  GRU_GEOMETRIES(REC_PICK)
  LSTM_GEOMETRIES(REC_PICK)
#undef REC_PICK
  return nullptr;
}

// W_hh's slice, the h buffer, the gate threads' sums and the two barriers
// (and a spare)
static size_t rec_smem(int ng, int H, int U, int R) {
  const int rt = R * (U / 2) / K1_PW;
  return ((size_t)H * ng * U + (size_t)H * R + (size_t)rt * ng * K1_PW) * 4 + 32;
}

// The kernel and its shared memory for one geometry, with the
// shared-memory attribute set; nullptr if not instantiated or not valid
// for H (U = min(H, 32), a cluster of 1, 2, 4 or 8 CTAs).
static const void* rec_setup(int cell, int H, int U, int R, size_t* smem, cudaError_t* err) {
  *err = cudaSuccess;
  if ((cell != 0 && cell != 1) || U != (H < 32 ? H : 32) || H % U != 0) return nullptr;
  const int cn = H / U;
  if (cn != 1 && cn != 2 && cn != 4 && cn != 8) return nullptr;
  const void* k = rec_kernel(cell, U, R);
  if (k == nullptr) return nullptr;
  *smem = rec_smem(cell == 0 ? 3 : 4, H, U, R);
  *err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return k;
}

static void rec_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int cn, int tiles,
                       size_t smem, cudaStream_t s) {
  *cfg = {};
  cfg->gridDim = dim3(cn * tiles, 2, 1);
  cfg->blockDim = dim3(K1_THREADS, 1, 1);
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
// recurrence with U units a CTA (clusters of H / U) and R rows a tile;
// dtype 1 = bfloat16: rnn_train_rec.cuh's simt forward with INFER, U units
// a CTA and its fwd_simt_rows(H) rows R. Returns 0 or a cudaError_t value.
int birnn_simt_rec_launch(int cell, int dtype, const void* xg, const void* whh,
                          const void* bhh, void* out, void* hn, int L, int N, int H, int U,
                          int R, void* stream, int device) {
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
  cudaError_t e;
  const void* k = rec_setup(cell, H, U, R, &smem, &e);
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
  rec_config(&cfg, attr, H / U, (N + R - 1) / R, smem, s);
  void* args[1] = {&q};
  e = cudaLaunchKernelExC(&cfg, k, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of the f32 recurrence at (cell, H, U, R) the card holds
// at once (cudaOccupancyMaxActiveClusters for the kernel, block and shared
// memory that birnn_simt_rec_launch launches), into *clusters, and its
// shared memory a CTA into *smem_bytes. Launches nothing. Returns 0 or a
// cudaError_t value.
int birnn_simt_rec_occupancy(int cell, int H, int U, int R, int* clusters, int* smem_bytes,
                             int device) {
  USE_DEVICE(device);
  size_t smem = 0;
  cudaError_t e;
  const void* k = rec_setup(cell, H, U, R, &smem, &e);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  rec_config(&cfg, attr, H / U, 1, smem, nullptr);
  *smem_bytes = (int)smem;
  return (int)cudaOccupancyMaxActiveClusters(clusters, k, &cfg);
}

}  // extern "C"
