// Kernel K3, fp32: the whole transencoder2s encoder plus the mean over
// positions on Hopper's CUDA cores, one tile of S samples (S L <= 64 rows)
// per CTA, in ONE launch: NL post-LayerNorm layers (multi-head
// self-attention over each sample's own L positions, then a ReLU
// feed-forward), then the mean over L. Inference only, no dropout. Exact f32
// arithmetic: FMAs on the CUDA cores, no TF32, no tensor cores, no library
// call. ops/transenc.py's k3_plan is the shape rule that picks this design
// (simt), transenc_tc.cu (tc, bf16) or transenc_encoder.cu (l2, the shapes
// neither takes).
//
// Replaces: ccsmeth_tpu/ops/transenc_pallas.py::_make_encoder_kernel (:144;
//   the default body :261-327), launched by _encoder_call (:335) through
//   encoder_pooled_pallas (:393). Per layer, as transenc_encoder.cu:
//     qkv = x Wqkv + bqkv;  per head h (HD = D / NH):
//       ctx_h = softmax(q_h k_h^T / sqrt(HD)) v_h  over the sample's L rows;
//     x = LN(x + ctx Wo + bo);  x = LN(x + relu(x W1 + b1) W2 + b2)
//   (LN: biased variance, eps 1e-5), then out = mean over L, in f32.
//
// Bound on an H100 SXM: 134.8 MFLOP of products per sample at D = 256,
//   NH = 4, FF = 512, L = 21, NL = 6: compute-bound, 2.06 ms for 1024
//   samples at 67 TFLOP/s (fp32 CUDA cores). What held the cp.async design
//   before this one at about half of the FMA rate inside a tile: every
//   thread issued the weight copies of a 2-slab ring and waited at a block
//   barrier every 16 k rows, each of the 66 products of a tile started on
//   an empty ring (~2k cycles for its first slab), and the 192- and
//   128-column products read their weights two floats at a time.
//
// What this design does about that:
//   - one producer thread (warp 8) streams every weight slab of the tile
//     (TS_BK = 16 k rows by up to TS_WMAX columns) through a ring of
//     TS_STAGES = 2 slots on mbarriers, one TMA box a slab (a head's q | k
//     | v as one 3-d box of Wqkv's column groups), in the consumers' order
//     across products, heads and layers: the 8 consumer warps issue no
//     copy, wait only for the slab they need and release it by one arrival
//     a warp, and the next product's first slabs land during an epilogue,
//     an attention head or a LayerNorm. (Per slab each warp still pays the
//     barrier's round trip: a build with no ring copy or wait at all runs
//     4-6% faster, and 8-row slabs in 4 slots slower, chip_smoke.py's
//     k3_simt_sweep, PERF.md section 5.)
//   - products are register-tiled outer products: a consumer thread owns 8
//     rows (4 ty .. 4 ty + 3 and 32 + 4 ty .. 32 + 4 ty + 3: each warp's
//     A loads are 128 contiguous bytes) by TN columns (TN = 8 for the
//     D-column products, 6 for a head's q | k | v and a 192-column chunk of
//     the hidden layer, 4 for a last chunk of <= 128), each column group
//     read as one float4 (or float2) a k. Nothing is carried in registers across products: 9 warps leave 168
//     registers a thread (one SM sub-partition holds 3 of them). The slab
//     loops are ~93% FFMA and run at ~0.75 of the FMA rate (k3_simt_probe);
//   - shared memory (229,408 bytes at the default shape), all f32 and
//     k-major ([column][row], row stride TS_LD = 68):
//       xs  [D][68]  the residual stream;
//       ctx [D][68]  the attention context, then the FF output's sum;
//       hb  [max(3 HD, TS_FC)][68]  one head's q | k | v (Wqkv's columns
//           h HD, D + h HD, 2D + h HD), then one TS_FC-column chunk of the
//           FF hidden layer relu(x W1[:, c] + b1[c]), which the next
//           product multiplies by W2[c, :] into ctx, chunk by chunk;
//       the ring (TS_STAGES x TS_BK x TS_WMAX), LayerNorm's partial sums
//       (2 x 256) and parameters (3 x 256), and the ring's mbarriers;
//   - consumers meet at named barriers only where a buffer changes hands
//     (q | k | v or the hidden chunk complete, and their last readers
//     done; the context complete; the residual complete for LayerNorm);
//     the producer joins none;
//   - attention stays on the CUDA cores (~2% of the FLOPs), one head at a
//     time, 4 threads a row: each a quarter of every score's dimensions,
//     the softmax in registers, a quarter of the context's columns;
//   - LayerNorm: 4 threads a row, partial sums through shared memory, its
//     parameters copied to shared memory at its start.
//
// Bits: the arithmetic is the cp.async design's, value for value: each
//   product element is one fmaf chain over k from 0 in order, its bias
//   added after; the feed-forward sum (P0 + P1) + P2 over its chunks; x +
//   (ctx Wo + bo) and x + (ctx + b2); LayerNorm's quarter sums combined r,
//   r + 64, r + 128, r + 192; attention's quarter scores added by two xor
//   shuffles, expf, the context over the keys in order; the mean in order.
// Rows: padded rows and the samples past N of the ragged last tile start at
//   zero, stay within their own rows (products are row by row, attention
//   never mixes samples, LayerNorm is per row), and are not stored.
// Determinism: each output element has one owner thread that sums its k in
//   a fixed order (the FF output: chunk after chunk); no atomics, so reruns
//   are bit-equal.
//
// Shapes: L <= 32, D a multiple of 16 up to 256, HD a multiple of 4 up to
//   64, FF a multiple of 16, shared memory within 227 KB (k3_plan checks them
//   before the launch; the C entry point refuses the rest).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (ops/transenc.py builds it at first use). The C entry
//   point returns cudaGetLastError() after the launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "entry_device.cuh"

#define TS_CONSUMERS 256  // 8 consumer warps
#define TS_THREADS 288    // and one producer warp
#define TS_ROWS 64
#define TS_LD 68      // k-major row stride of the 64-row operands, in floats
#define TS_LMAX 32    // L <= TS_LMAX
#define TS_BK 16      // k rows of a ring slab
#define TS_STAGES 2   // ring slots
#define TS_WMAX 256   // a slot's row width (columns): the widest product
#define TS_FC 192     // FF hidden columns a chunk
#define TS_DMAX 256   // D <= TS_DMAX
#define TS_HDMAX 64   // HD <= TS_HDMAX

struct EncSimtParams {
  const float* x;     // (N, L, D)
  float* out;         // (N, D)
  const float* bqkv;  // (NL, 3D); the weights come through the tensor maps
  const float* bo;    // (NL, D)
  const float* b1;    // (NL, FF)
  const float* b2;    // (NL, D)
  const float* ln1s;  // (NL, D) LayerNorm scale / bias, after attention
  const float* ln1b;
  const float* ln2s;  // after the feed-forward
  const float* ln2b;
  int N, L, D, NH, FF, NL, S;
};

// The weight columns of one product: pass column p (0 <= p < P) is column
// base + (p / seg) * stride + p % seg of W. seg % 4 == 0.
struct Cols {
  int base, seg, stride;
  __device__ __forceinline__ int operator()(int p) const {
    return base + (p / seg) * stride + p % seg;
  }
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 add4(float4 a, float b) {
  return make_float4(a.x + b, a.y + b, a.z + b, a.w + b);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- the ring's mbarriers and TMA loads

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// the producer's arrival, announcing `bytes` of TMA loads into the phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cta.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait for the phase of parity `parity` to complete, the thread suspended
// in try_wait (up to a 1 ms hint a try) rather than spinning; a wait that
// never ends (a broken protocol) traps after ~2^34 cycles instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cta.shared::cta.b64 p, [%1], %2, 1000000;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// TMA loads of the box at the given coordinates of a 2-d or 3-d tensor map
// into shared memory at `dst`, completing on barrier `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the consumer warps' barrier (named barrier 1; the producer never joins)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(TS_CONSUMERS) : "memory");
}

// The ring as both sides walk it: slab g of the tile's sequence lies in
// slot g % TS_STAGES, its use g / TS_STAGES of that slot.
struct Ring {
  float* slots;   // [TS_STAGES][TS_BK][TS_WMAX]
  uint64_t* bar;  // full[TS_STAGES], then empty[TS_STAGES]
  uint32_t g;     // slabs taken (consumers) or issued (producer) so far
  __device__ __forceinline__ uint32_t full(int s) const { return smem_addr(bar + s); }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return smem_addr(bar + TS_STAGES + s);
  }
};

// ---- the producer

// The slabs of one product, one TMA box each: K weight rows from row `row`
// of the map, TS_BK a slab (K % TS_BK == 0), the box at column `col` (and,
// for the 3-d map of Wqkv, group 0: q | k | v), `bytes` a box. A box lands
// as a dense [TS_BK][width] image at the slot's start.
__device__ __forceinline__ void produce(Ring& ring, const CUtensorMap* map, bool three_d, int col,
                                        int row, int K, uint32_t bytes) {
  for (int k0 = 0; k0 < K; k0 += TS_BK, ++ring.g) {
    const int s = ring.g % TS_STAGES, use = ring.g / TS_STAGES;
    if (use > 0) mbar_wait(ring.empty(s), (use - 1) & 1);
    mbar_expect_tx(ring.full(s), bytes);
    const uint32_t dst = smem_addr(ring.slots + (size_t)s * TS_BK * TS_WMAX);
    if (three_d)
      tma_load_3d(dst, map, ring.full(s), col, 0, row + k0);
    else
      tma_load_2d(dst, map, ring.full(s), col, row + k0);
  }
}

// ---- the consumers' products

// A consumer thread's rows (r < 8) and columns (c < TN) of a product's
// 64-row tile: warp w, lane = 4 ty + (lane % 4), tx = 4 w + lane % 4.
__device__ __forceinline__ int row_of(int ty, int r) { return r < 4 ? 4 * ty + r : 28 + 4 * ty + r; }

template <int TN>
__device__ __forceinline__ int col_of(int tx, int c) {
  return c < 4 ? 4 * tx + c : 128 + (TN == 6 ? 2 : 4) * tx + c - 4;
}

// acc = A (K x 64, k-major f32 in shared memory, stride TS_LD) times the
// product's K weight rows as the ring delivers them, slab by slab (each a
// [TS_BK][ws] image), each element one fmaf chain over k in order from 0
// (acc zeroed here); each warp releases a slab with one arrival. Columns
// past the product's P read the slot's other contents and are never stored.
template <int TN>
__device__ __forceinline__ void consume(Ring& ring, const float* A, int K, int ws,
                                        float (&acc)[8][TN]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty = lane >> 2, tx = warp * 4 + (lane & 3);
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.0f;
  const float* as = A + 4 * ty;
  for (int k0 = 0; k0 < K; k0 += TS_BK, ++ring.g, as += TS_BK * TS_LD) {
    const int s = ring.g % TS_STAGES;
    mbar_wait(ring.full(s), (ring.g / TS_STAGES) & 1);
    const float* slot = ring.slots + (size_t)s * TS_BK * TS_WMAX;
    const float* b0p = slot + col_of<TN>(tx, 0);
    const float* b1p = slot + col_of<TN>(tx, TN > 4 ? 4 : 0);
#pragma unroll
    for (int kk = 0; kk < TS_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * TS_LD);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * TS_LD + 32);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[TN];
      const float4 b0 = *reinterpret_cast<const float4*>(b0p + kk * ws);
      b[0] = b0.x;
      b[1] = b0.y;
      b[2] = b0.z;
      b[3] = b0.w;
      if constexpr (TN == 8) {
        const float4 b1 = *reinterpret_cast<const float4*>(b1p + kk * ws);
        b[4] = b1.x;
        b[5] = b1.y;
        b[6] = b1.z;
        b[7] = b1.w;
      } else if constexpr (TN == 6) {
        const float2 b1 = *reinterpret_cast<const float2*>(b1p + kk * ws);
        b[4] = b1.x;
        b[5] = b1.y;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty(s));
  }
}

// this thread's columns' bias, bias[cols(p)] (0 past P)
template <int TN>
__device__ __forceinline__ void load_bias(const float* bias, Cols cols, int P, float (&bv)[TN]) {
  const int tx = (threadIdx.x >> 5) * 4 + (threadIdx.x & 3);
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    const int p = col_of<TN>(tx, c);
    bv[c] = p < P ? __ldg(bias + cols(p)) : 0.0f;
  }
}

// f(dst[p][rows], v) for this thread's columns p < P (k-major dst, stride
// TS_LD), four rows a float4: v = acc + bv[c] when bias is given, else acc
template <int TN, class F>
__device__ __forceinline__ void epilogue(float* dst, int P, const float (&acc)[8][TN],
                                         const float* bias, const float (&bv)[TN], F f) {
  const int lane = threadIdx.x & 31;
  const int ty = lane >> 2, tx = (threadIdx.x >> 5) * 4 + (lane & 3);
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    const int p = col_of<TN>(tx, c);
    if (p >= P) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = make_float4(acc[4 * h][c], acc[4 * h + 1][c], acc[4 * h + 2][c],
                                   acc[4 * h + 3][c]);
      f(reinterpret_cast<float4*>(dst + (size_t)p * TS_LD + row_of(ty, 4 * h)),
        bias != nullptr ? add4(v, bv[c]) : v);
    }
  }
}

// One head of per-sample attention over hb = [q | k | v] (k-major, HD
// columns each); the context goes to ctx's columns h HD .. h HD + HD - 1.
// Four threads a row (row tid / 4, dimensions tid % 4 + 4 n): each sums its
// quarter of every score, two shuffles add the quarters, each of the four
// takes the softmax of the row's L scores in registers and writes a quarter
// of the context columns. LB (L rounded up to 8) is a compile-time count, so
// the key loops are unrolled with unconditional loads that the compiler can
// batch: keys L .. LB - 1 read rows past the sample (another sample's, the
// zeroed pad rows 64 .. 67, the next column's or the ring's first: all
// finite, all inside shared memory), their scores are dropped and their
// probabilities are 0. Rows past S L take the clamped path and store nothing.
template <int LB>
__device__ __forceinline__ void attention_head(const float* hb, float* ctx, int h, int HD,
                                               int L, int S, float scale) {
  const int row = threadIdx.x >> 2, qd = threadIdx.x & 3;
  const bool active = row < S * L;
  const int r0 = active ? (row / L) * L : 0;  // the sample's first row
  const int nd = HD / 4;  // dimensions a thread
  const float* q = hb + (size_t)qd * TS_LD + (active ? row : 0);
  const float* k = hb + (size_t)(HD + qd) * TS_LD + r0;
  const float* v = hb + (size_t)(2 * HD + qd) * TS_LD + r0;
  // this thread's quarter of every score: its dimensions in order, the
  // keys side by side (independent sums)
  float p[LB];
#pragma unroll
  for (int j = 0; j < LB; ++j) p[j] = 0.0f;
  for (int n = 0; n < nd; ++n) {
    const float qn = q[4 * n * TS_LD];
    const float* kn = k + 4 * n * TS_LD;
#pragma unroll
    for (int j = 0; j < LB; ++j) p[j] = fmaf(qn, kn[j], p[j]);
  }
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < LB; ++j) {
    p[j] += __shfl_xor_sync(0xffffffffu, p[j], 1);
    p[j] += __shfl_xor_sync(0xffffffffu, p[j], 2);
    p[j] *= scale;
    if (j < L) m = fmaxf(m, p[j]);
  }
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < LB; ++j) {
    p[j] = j < L ? expf(p[j] - m) : 0.0f;
    sum += p[j];
  }
  const float inv = 1.0f / sum;
#pragma unroll
  for (int j = 0; j < LB; ++j) p[j] *= inv;
  // a quarter of the context's columns, the keys in order
  for (int n = 0; n < nd; ++n) {
    const float* vn = v + 4 * n * TS_LD;
    float c = 0.0f;
#pragma unroll
    for (int j = 0; j < LB; ++j) c = fmaf(p[j], vn[j], c);
    if (active) ctx[(size_t)(h * HD + qd + 4 * n) * TS_LD + row] = c;
  }
}

__device__ __forceinline__ void attention(const float* hb, float* ctx, int h, int HD, int L,
                                          int S, float scale) {
  if (L <= 8) {
    attention_head<8>(hb, ctx, h, HD, L, S, scale);
  } else if (L <= 16) {
    attention_head<16>(hb, ctx, h, HD, L, S, scale);
  } else if (L <= 24) {
    attention_head<24>(hb, ctx, h, HD, L, S, scale);
  } else {
    attention_head<32>(hb, ctx, h, HD, L, S, scale);
  }
}

// In-place LayerNorm of the 64 rows of xs (k-major), after xs += add + addb
// when add is given: 4 threads a row (row tid % 64, the q-th quarter of the
// columns, q = tid / 64, the same in a warp), partial sums through red
// (2 x 256 floats); the scale, bias and addb first copied to stage (3 x 256
// floats) in one go, so that no loop waits on a global load. Ends at a
// consumer barrier.
__device__ __forceinline__ void layer_norm(float* xs, int D, const float* g, const float* b,
                                           float* red, float* stage, const float* add,
                                           const float* addb) {
  for (int i = threadIdx.x; i < D; i += TS_CONSUMERS) {
    stage[i] = __ldg(g + i);
    stage[TS_DMAX + i] = __ldg(b + i);
    if (add != nullptr) stage[2 * TS_DMAX + i] = __ldg(addb + i);
  }
  consumer_sync();
  const int r = threadIdx.x & (TS_ROWS - 1), q = threadIdx.x / TS_ROWS;
  const int c0 = q * (D / 4), c1 = c0 + D / 4;
  float s = 0.0f;
#pragma unroll 8
  for (int c = c0; c < c1; ++c) {
    float* px = xs + (size_t)c * TS_LD + r;
    if (add != nullptr) *px += add[(size_t)c * TS_LD + r] + stage[2 * TS_DMAX + c];
    s += *px;
  }
  red[threadIdx.x] = s;
  consumer_sync();
  const float mu = (red[r] + red[r + 64] + red[r + 128] + red[r + 192]) / (float)D;
  float v = 0.0f;
#pragma unroll 8
  for (int c = c0; c < c1; ++c) {
    const float d = xs[(size_t)c * TS_LD + r] - mu;
    v = fmaf(d, d, v);
  }
  red[TS_CONSUMERS + threadIdx.x] = v;
  consumer_sync();
  const float var = (red[TS_CONSUMERS + r] + red[TS_CONSUMERS + r + 64] +
                     red[TS_CONSUMERS + r + 128] + red[TS_CONSUMERS + r + 192]) /
                    (float)D;
  const float rs = 1.0f / sqrtf(var + 1e-5f);
#pragma unroll 8
  for (int c = c0; c < c1; ++c) {
    float* px = xs + (size_t)c * TS_LD + r;
    *px = (*px - mu) * rs * stage[c] + stage[TS_DMAX + c];
  }
  consumer_sync();
}

__global__ void __launch_bounds__(TS_THREADS, 1)
    transenc_simt_kernel(const __grid_constant__ CUtensorMap mqkv,
                         const __grid_constant__ CUtensorMap mo,
                         const __grid_constant__ CUtensorMap m1,
                         const __grid_constant__ CUtensorMap m2, const EncSimtParams p) {
  extern __shared__ __align__(128) float smem[];
  const int D = p.D, L = p.L, FF = p.FF, NH = p.NH, S = p.S;
  const int HD = D / NH;
  const int HB = 3 * HD > TS_FC ? 3 * HD : TS_FC;
  float* xs = smem;                            // [D][TS_LD]
  float* ctx = xs + (size_t)D * TS_LD;         // [D][TS_LD]
  float* hb = ctx + (size_t)D * TS_LD;         // [HB][TS_LD]
  float* slots = hb + (size_t)HB * TS_LD;      // [TS_STAGES][TS_BK][TS_WMAX]
  float* red = slots + TS_STAGES * TS_BK * TS_WMAX;  // [2][TS_CONSUMERS]
  float* stage = red + 2 * TS_CONSUMERS;             // [3][TS_DMAX]
  uint64_t* bars = reinterpret_cast<uint64_t*>(stage + 3 * TS_DMAX);
  const int n0 = blockIdx.x * S;                   // this tile's first sample
  const int rows = min(S * L, (p.N - n0) * L);     // real rows of this tile

  const float* x = p.x + (size_t)n0 * L * D;
  for (int i = threadIdx.x; i < TS_ROWS * D / 4; i += TS_THREADS) {
    const int r = i % TS_ROWS, c = (i / TS_ROWS) * 4;  // lanes along rows
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < rows) v = __ldg(reinterpret_cast<const float4*>(x + (size_t)r * D + c));
    xs[(size_t)c * TS_LD + r] = v.x;
    xs[(size_t)(c + 1) * TS_LD + r] = v.y;
    xs[(size_t)(c + 2) * TS_LD + r] = v.z;
    xs[(size_t)(c + 3) * TS_LD + r] = v.w;
  }
  // rows past S L never get a context, and attention reads keys past a
  // sample (pad positions, the next column's first, which may be a column
  // no product wrote yet, or the ring's first): keep them all finite
  for (int i = threadIdx.x; i < (D + HB) * TS_LD + TS_STAGES * TS_BK * TS_WMAX; i += TS_THREADS)
    ctx[i] = 0.0f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TS_STAGES; ++s) {
      mbar_init(smem_addr(bars + s), 1);                              // full: the producer
      mbar_init(smem_addr(bars + TS_STAGES + s), TS_CONSUMERS / 32);  // empty: each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the zeroed slots and the barriers before the producer's first copy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  Ring ring{slots, bars, 0u};

  const int W1B = FF < TS_FC ? FF : TS_FC;  // W1's box: a chunk's columns
  if (threadIdx.x >= TS_CONSUMERS) {
    // the producer (one thread): every slab of the tile, in the consumers'
    // order
    if (threadIdx.x == TS_CONSUMERS) {
      const uint32_t qkv_bytes = 3 * HD * TS_BK * sizeof(float);
      const uint32_t d_bytes = D * TS_BK * sizeof(float);
      const uint32_t w1_bytes = W1B * TS_BK * sizeof(float);
      for (int l = 0; l < p.NL; ++l) {
        for (int h = 0; h < NH; ++h) produce(ring, &mqkv, true, h * HD, l * D, D, qkv_bytes);
        produce(ring, &mo, false, 0, l * D, D, d_bytes);
        for (int c0 = 0; c0 < FF; c0 += TS_FC) {
          const int P = FF - c0 < TS_FC ? FF - c0 : TS_FC;
          produce(ring, &m1, false, c0, l * D, D, w1_bytes);
          produce(ring, &m2, false, 0, l * FF + c0, P, d_bytes);
        }
      }
    }
    return;
  }

  const float scale = 1.0f / sqrtf((float)HD);
  const auto store = [](float4* pd, float4 v) { *pd = v; };
  const auto relu = [](float4* pd, float4 v) {
    *pd = make_float4(fmaxf(v.x, 0.0f), fmaxf(v.y, 0.0f), fmaxf(v.z, 0.0f), fmaxf(v.w, 0.0f));
  };
  const auto add = [](float4* pd, float4 v) { *pd = add4(*pd, v); };
  for (int l = 0; l < p.NL; ++l) {
    const float* bqkv = p.bqkv + (size_t)l * 3 * D;
    const float* b1 = p.b1 + (size_t)l * FF;

    for (int h = 0; h < NH; ++h) {
      const Cols qkv_cols = {h * HD, HD, D};
      float bv[6], acc[8][6];
      load_bias(bqkv, qkv_cols, 3 * HD, bv);
      consume(ring, xs, D, 3 * HD, acc);
      consumer_sync();  // the last head's attention done with hb
      epilogue(hb, 3 * HD, acc, bqkv, bv, store);
      consumer_sync();  // q | k | v complete
      attention(hb, ctx, h, HD, L, S, scale);
    }
    consumer_sync();  // the context complete
    {
      const float* bo = p.bo + (size_t)l * D;
      float bv[8], acc[8][8];
      load_bias(bo, Cols{0, D, 0}, D, bv);
      consume(ring, ctx, D, D, acc);
      epilogue(xs, D, acc, bo, bv, add);
    }
    consumer_sync();  // the residual complete
    layer_norm(xs, D, p.ln1s + (size_t)l * D, p.ln1b + (size_t)l * D, red, stage, nullptr,
               nullptr);

    // the feed-forward, TS_FC hidden columns at a time; each chunk's
    // partial of the output added into ctx in chunk order
    for (int c0 = 0; c0 < FF; c0 += TS_FC) {
      const int P = FF - c0 < TS_FC ? FF - c0 : TS_FC;
      if (P > 128) {
        float bv[6], acc[8][6];
        load_bias(b1, Cols{c0, P, 0}, P, bv);
        consume(ring, xs, D, W1B, acc);
        consumer_sync();  // the last chunk's hidden columns read
        epilogue(hb, P, acc, b1, bv, relu);
      } else {  // the narrower tile for a last chunk of <= 128 columns
        float bv[4], acc[8][4];
        load_bias(b1, Cols{c0, P, 0}, P, bv);
        consume(ring, xs, D, W1B, acc);
        consumer_sync();
        epilogue(hb, P, acc, b1, bv, relu);
      }
      consumer_sync();  // the hidden chunk complete
      float none[8], acc[8][8];
      consume(ring, hb, P, D, acc);
      if (c0 == 0)
        epilogue(ctx, D, acc, nullptr, none, store);
      else
        epilogue(ctx, D, acc, nullptr, none, add);
    }
    consumer_sync();  // the feed-forward's sum complete
    layer_norm(xs, D, p.ln2s + (size_t)l * D, p.ln2b + (size_t)l * D, red, stage, ctx,
               p.b2 + (size_t)l * D);
  }

  // mean over each real sample's L rows
  for (int i = threadIdx.x; i < S * D; i += TS_CONSUMERS) {
    const int s = i / D, c = i - s * D;
    if (n0 + s >= p.N) continue;
    const float* col = xs + (size_t)c * TS_LD + s * L;
    float sum = 0.0f;
    for (int t = 0; t < L; ++t) sum += col[t];
    p.out[(size_t)(n0 + s) * D + c] = sum / (float)L;
  }
}

// ---- tensor maps (host)

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry-point
// query (the library does not link libcuda)
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)f;
  }
  return fn;
}

// The TMA map of an f32 tensor of `rank` (2 or 3) dimensions, innermost
// first: dims in elements, the outer dimensions' strides in bytes (multiples
// of 16, as the base address); a box of `box` elements lands densely, no
// swizzle; its elements outside the tensor arrive as zeros.
// CUDA_ERROR_NOT_SUPPORTED when libcuda's encoder is missing.
static CUresult f32_tensor_map(CUtensorMap* map, const void* p, int rank, const cuuint64_t* dims,
                               const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_SUPPORTED;
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, (cuuint32_t)rank, const_cast<void*>(p), dims,
                strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

extern "C" {

// Shared memory a CTA, in bytes (0 for a shape the kernel does not take).
size_t transenc_simt_smem(int L, int D, int NH, int FF) {
  if (L < 1 || L > TS_LMAX || D < TS_BK || D > TS_DMAX || D % TS_BK != 0 ||
      NH < 1 || D % NH != 0 || (D / NH) % 4 != 0 || D / NH > TS_HDMAX ||
      FF < TS_BK || FF % TS_BK != 0)
    return 0;
  const int HD = D / NH;
  const int HB = 3 * HD > TS_FC ? 3 * HD : TS_FC;
  return ((size_t)(2 * D + HB) * TS_LD + TS_STAGES * TS_BK * TS_WMAX + 2 * TS_CONSUMERS +
          3 * TS_DMAX) * sizeof(float) + 2 * TS_STAGES * sizeof(uint64_t);
}

// All of x, the weights, the biases, the LayerNorm parameters and out f32
// (the weights 16-byte aligned). S samples per CTA (S * L <= 64). Returns 0
// or a cudaError_t value.
int transenc_simt_launch(const void* x, void* out, const void* wqkv,
                         const void* wo, const void* w1, const void* w2,
                         const void* bqkv, const void* bo, const void* b1,
                         const void* b2, const void* ln1s, const void* ln1b,
                         const void* ln2s, const void* ln2b, int N, int L, int D,
                         int NH, int FF, int NL, int S, void* stream, int device) {
  USE_DEVICE(device);
  const size_t smem = transenc_simt_smem(L, D, NH, FF);
  if (smem == 0 || N < 1 || NL < 1 || S < 1 || S * L > TS_ROWS ||
      (reinterpret_cast<uintptr_t>(wqkv) | reinterpret_cast<uintptr_t>(wo) |
       reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int HD = D / NH;
  const cuuint32_t W1B = FF < TS_FC ? FF : TS_FC;
  CUtensorMap maps[4];
  // Wqkv (NL D, 3, D): a head's q | k | v, TS_BK k rows, as one 3-d box
  const cuuint64_t qdims[3] = {(cuuint64_t)D, 3, (cuuint64_t)NL * D};
  const cuuint64_t qstrides[2] = {(cuuint64_t)D * 4, (cuuint64_t)D * 12};
  const cuuint32_t qbox[3] = {(cuuint32_t)HD, 3, TS_BK};
  CUresult r = f32_tensor_map(&maps[0], wqkv, 3, qdims, qstrides, qbox);
  const cuuint64_t odims[2] = {(cuuint64_t)D, (cuuint64_t)NL * D};
  const cuuint64_t ostrides[1] = {(cuuint64_t)D * 4};
  const cuuint32_t obox[2] = {(cuuint32_t)D, TS_BK};
  if (r == CUDA_SUCCESS) r = f32_tensor_map(&maps[1], wo, 2, odims, ostrides, obox);
  const cuuint64_t dims1[2] = {(cuuint64_t)FF, (cuuint64_t)NL * D};
  const cuuint64_t strides1[1] = {(cuuint64_t)FF * 4};
  const cuuint32_t box1[2] = {W1B, TS_BK};
  if (r == CUDA_SUCCESS) r = f32_tensor_map(&maps[2], w1, 2, dims1, strides1, box1);
  const cuuint64_t dims2[2] = {(cuuint64_t)D, (cuuint64_t)NL * FF};
  if (r == CUDA_SUCCESS) r = f32_tensor_map(&maps[3], w2, 2, dims2, ostrides, obox);
  if (r != CUDA_SUCCESS)
    return r == CUDA_ERROR_NOT_SUPPORTED ? (int)cudaErrorNotSupported : (int)cudaErrorInvalidValue;
  EncSimtParams p;
  p.x = static_cast<const float*>(x);
  p.out = static_cast<float*>(out);
  p.bqkv = static_cast<const float*>(bqkv);
  p.bo = static_cast<const float*>(bo);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.ln1s = static_cast<const float*>(ln1s);
  p.ln1b = static_cast<const float*>(ln1b);
  p.ln2s = static_cast<const float*>(ln2s);
  p.ln2b = static_cast<const float*>(ln2b);
  p.N = N;
  p.L = L;
  p.D = D;
  p.NH = NH;
  p.FF = FF;
  p.NL = NL;
  p.S = S;
  cudaError_t e = cudaFuncSetAttribute(
      transenc_simt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (N + S - 1) / S;
  transenc_simt_kernel<<<grid, TS_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return (int)cudaGetLastError();
}

// The kernel's registers a thread into *regs and the CTAs an SM holds at
// (L, D, NH, FF) into *ctas (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// with its shared memory a CTA into *smem_bytes. Launches nothing. Returns 0
// or a cudaError_t value.
int transenc_simt_occupancy(int L, int D, int NH, int FF, int* ctas, int* regs,
                            int* smem_bytes, int device) {
  USE_DEVICE(device);
  const size_t smem = transenc_simt_smem(L, D, NH, FF);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      transenc_simt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, transenc_simt_kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *smem_bytes = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, transenc_simt_kernel,
                                                            TS_THREADS, smem);
}

}  // extern "C"
