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
//   samples at 67 TFLOP/s (fp32 CUDA cores). What held the first f32 kernel
//   (transenc_encoder.cu) at 17-18 TFLOP/s: 42 rows a CTA, one CTA of 8
//   warps an SM (205 KB of shared memory), and every warp reading each
//   weight from L1/L2 itself, 48 FMAs per two 16-byte global loads.
//
// What this design does about that:
//   - 64 rows a CTA (S = 64 / L samples: 3 at L = 21, 63 real rows), so
//     each weight byte serves 63 rows, not 42;
//   - the weights come through one cp.async ring per CTA that all 8 warps
//     share: TS_STAGES slabs of TS_BK k rows by up to 256 columns; the CTA
//     reads each weight from L2 once per tile;
//   - products are register-tiled outer products: a thread owns 8 rows x TN
//     columns (TN = 8 for the 256-column products, 6 for a head's q | k | v
//     and a 192-column chunk of the hidden layer, 4 for a last chunk of 128),
//     per k two float4 of A (8 rows of a k-major operand) and TN floats of
//     the ring slab from shared memory, 8 TN FMAs: shared memory delivers
//     128 bytes a cycle to an SM, which is 1 float per FMA at 128 FMAs a
//     cycle, so 8 x 8 is the smallest tile it keeps up with;
//   - shared memory (226,304 bytes at the default shape), all f32 and
//     k-major ([column][row], row stride TS_LD = 68):
//       xs  [D][68]  the residual stream;
//       ctx [D][68]  the attention context, then the FF output's sum;
//       hb  [max(3 HD, TS_FC)][68]  one head's q | k | v (Wqkv's columns
//           h HD, D + h HD, 2D + h HD), then one TS_FC-column chunk of the
//           FF hidden layer relu(x W1[:, c] + b1[c]), which the next
//           product multiplies by W2[c, :] into ctx, chunk by chunk;
//       the ring, and LayerNorm's partial sums (2 x 256);
//   - attention stays on the CUDA cores (~2% of the FLOPs), one head at a
//     time, 4 threads a row: each a quarter of every score's dimensions,
//     the softmax in registers, a quarter of the context's columns;
//   - LayerNorm: 4 threads a row, partial sums through shared memory.
//   What sets the pace (PERF.md, section 5): one CTA alone takes as long
//   as a full wave, so the CTA's own work does, not the L2 that 132 CTAs
//   share; the products take ~87% of it, their slab loops at about
//   two thirds of the FMA rate, each call ~2k cycles waiting for its first
//   slab; attention ~8%, LayerNorm ~4%.
//
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

#include "mma_tile.cuh"
#include "entry_device.cuh"

#define TS_THREADS 256
#define TS_ROWS 64
#define TS_LD 68      // k-major row stride of the 64-row operands, in floats
#define TS_LMAX 32    // L <= TS_LMAX; the score rows' stride
#define TS_BK 16      // k rows of a ring slab
#define TS_STAGES 2   // ring depth
#define TS_WMAX 256   // widest slab (columns): 32 TN for TN = 8
#define TS_FC 192     // FF hidden columns a chunk
#define TS_DMAX 256   // D <= TS_DMAX
#define TS_HDMAX 64   // HD <= TS_HDMAX


struct EncSimtParams {
  const float* x;     // (N, L, D)
  float* out;         // (N, D)
  const float* wqkv;  // (NL, D, 3D), columns q | k | v
  const float* wo;    // (NL, D, D)
  const float* w1;    // (NL, D, FF)
  const float* w2;    // (NL, FF, D)
  const float* bqkv;  // (NL, 3D)
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

// out (64 rows x P columns) = A (K x 64, k-major f32 in shared memory,
// stride TS_LD) times W[k][cols(p)] (f32 in device memory, row stride ldw),
// K % TS_BK == 0, P <= 32 TN, P % VW == 0, plus bias[cols(p)] when bias is
// given. The slabs of W stream through the ring (columns >= P read as 0).
// Each thread owns 8 rows, 8 ty .. 8 ty + 7, and TN columns in groups of VW
// (4, or 2 when TN = 6): VW tx + 32 VW g + e (g < TN / VW, e < VW). Shared
// memory delivers at most 128 bytes a cycle to an SM, so the thread tile
// sets the pace: (8 + TN) loaded floats per 8 TN FMAs keeps up with the FMA
// rate at TN = 8, at 86% at TN = 6 and 67% at TN = 4. Each thread reads its
// columns' bias before the products, so the epilogue waits on no load;
// every column p < P is handed to epi(p, row0, v) for row0 = 8 ty and
// 8 ty + 4, v the results of rows row0 .. row0 + 3. Ends with the ring
// drained and a block barrier.
template <int TN, class Epi>
__device__ __forceinline__ void ring_gemm(const float* A, int K, const float* W,
                                          int ldw, Cols cols, int P,
                                          const float* bias, float* ring, Epi epi) {
  constexpr int VW = TN % 4 == 0 ? 4 : 2;  // B's vector width
  constexpr int NG = TN / VW;              // B's vectors a thread
  constexpr int WS = 32 * TN;              // slab row width
  constexpr int CHUNKS = TS_BK * WS / 4;   // 16-byte copies a slab
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // a warp holds every row group and 4 column groups: its epilogue stores
  // are whole 128-byte column runs
  const int ty = lane >> 2;                // row group, 0..7
  const int tx = warp * 4 + (lane & 3);    // column group, 0..31
  const int nk = K / TS_BK;

  // this thread's 16-byte copies of a slab: the same (row, column) in
  // every slab, so their offsets in W are computed once
  constexpr int PER = (CHUNKS + TS_THREADS - 1) / TS_THREADS;
  int src_off[PER], dst_off[PER];
  bool ok[PER];
#pragma unroll
  for (int c = 0; c < PER; ++c) {
    const int i = tid + c * TS_THREADS;
    const int r = i / (WS / 4), p = (i % (WS / 4)) * 4;
    ok[c] = i < CHUNKS && p < P;
    src_off[c] = ok[c] ? r * ldw + cols(p) : 0;
    dst_off[c] = r * WS + p;
  }
  auto load = [&](int stage, int it) {
    float* rs = ring + stage * TS_BK * WS;
    const float* w = W + (size_t)it * TS_BK * ldw;
#pragma unroll
    for (int c = 0; c < PER; ++c)
      if (tid + c * TS_THREADS < CHUNKS)
        cp_async_16(smem_u32(rs + dst_off[c]), w + src_off[c], ok[c]);
  };

  float bv[TN];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      const int p = VW * tx + 32 * VW * g + e;
      bv[VW * g + e] = bias != nullptr && p < P ? __ldg(bias + cols(p)) : 0.0f;
    }
  float acc[8][TN];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.0f;
#pragma unroll
  for (int s = 0; s < TS_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<TS_STAGES - 2>();
    __syncthreads();
    const int nt = it + TS_STAGES - 1;
    if (nt < nk) load(nt % TS_STAGES, nt);
    cp_async_commit();
    const float* rs = ring + (it % TS_STAGES) * TS_BK * WS + VW * tx;
    const float* as = A + (size_t)it * TS_BK * TS_LD + 8 * ty;
#pragma unroll
    for (int kk = 0; kk < TS_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * TS_LD);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * TS_LD + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[TN];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float* pb = rs + kk * WS + 32 * VW * g;
        if constexpr (VW == 4) {
          const float4 b4 = *reinterpret_cast<const float4*>(pb);
          b[4 * g] = b4.x;
          b[4 * g + 1] = b4.y;
          b[4 * g + 2] = b4.z;
          b[4 * g + 3] = b4.w;
        } else {
          const float2 b2 = *reinterpret_cast<const float2*>(pb);
          b[2 * g] = b2.x;
          b[2 * g + 1] = b2.y;
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      const int c = VW * g + e, p = VW * tx + 32 * VW * g + e;
      if (p >= P) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = make_float4(acc[4 * h][c], acc[4 * h + 1][c],
                                     acc[4 * h + 2][c], acc[4 * h + 3][c]);
        epi(p, 8 * ty + 4 * h, bias != nullptr ? add4(v, bv[c]) : v);
      }
    }
  __syncthreads();
}

// One head of per-sample attention over hb = [q | k | v] (k-major, HD
// columns each); the context goes to ctx's columns h HD .. h HD + HD - 1.
// Four threads a row (row tid / 4, dimensions tid % 4 + 4 n): each sums its
// quarter of every score, two shuffles add the quarters, each of the four
// takes the softmax of the row's L scores in registers and writes a quarter
// of the context columns. LB (L rounded up to 8) is a compile-time count, so
// the key loops are unrolled with unconditional loads that the compiler can
// batch: keys L .. LB - 1 read rows past the sample (another sample's, the
// zeroed pad rows 64 .. 67, or the next column's: all finite, all inside
// shared memory), their scores are dropped and their probabilities are 0.
// Rows past S L take the clamped path and store nothing.
template <int LB>
__device__ __forceinline__ void attention_head(const float* hb, float* ctx,
                                               int h, int HD, int L, int S,
                                               float scale) {
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
  __syncthreads();
}

// In-place LayerNorm of the 64 rows of xs (k-major), after xs += add + addb
// when add is given: 4 threads a row (row tid % 64, the q-th quarter of the
// columns, q = tid / 64, the same in a warp), partial sums through red
// (2 x 256 floats).
__device__ __forceinline__ void layer_norm(float* xs, int D, const float* g,
                                           const float* b, float* red,
                                           const float* add, const float* addb) {
  const int r = threadIdx.x & (TS_ROWS - 1), q = threadIdx.x / TS_ROWS;
  const int c0 = q * (D / 4), c1 = c0 + D / 4;
  float s = 0.0f;
#pragma unroll 8
  for (int c = c0; c < c1; ++c) {
    float* px = xs + (size_t)c * TS_LD + r;
    if (add != nullptr) *px += add[(size_t)c * TS_LD + r] + __ldg(addb + c);
    s += *px;
  }
  red[threadIdx.x] = s;
  __syncthreads();
  const float mu = (red[r] + red[r + 64] + red[r + 128] + red[r + 192]) / (float)D;
  float v = 0.0f;
#pragma unroll 8
  for (int c = c0; c < c1; ++c) {
    const float d = xs[(size_t)c * TS_LD + r] - mu;
    v = fmaf(d, d, v);
  }
  red[TS_THREADS + threadIdx.x] = v;
  __syncthreads();
  const float var = (red[TS_THREADS + r] + red[TS_THREADS + r + 64] +
                     red[TS_THREADS + r + 128] + red[TS_THREADS + r + 192]) /
                    (float)D;
  const float rs = 1.0f / sqrtf(var + 1e-5f);
#pragma unroll 8
  for (int c = c0; c < c1; ++c) {
    float* px = xs + (size_t)c * TS_LD + r;
    *px = (*px - mu) * rs * __ldg(g + c) + __ldg(b + c);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(TS_THREADS, 1)
    transenc_simt_kernel(const EncSimtParams p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, L = p.L, FF = p.FF, NH = p.NH, S = p.S;
  const int HD = D / NH;
  const int HB = 3 * HD > TS_FC ? 3 * HD : TS_FC;
  float* xs = smem;                            // [D][TS_LD]
  float* ctx = xs + (size_t)D * TS_LD;         // [D][TS_LD]
  float* hb = ctx + (size_t)D * TS_LD;         // [HB][TS_LD]
  float* ring = hb + (size_t)HB * TS_LD;       // [stage][TS_BK][<= TS_WMAX]
  float* red = ring + TS_STAGES * TS_BK * TS_WMAX;  // [2][TS_THREADS]
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
  // rows past S L never get a context, and attention reads up to 3 rows
  // past a column's 64 (its pad rows, or the next column's first rows,
  // which may be a column no product wrote yet): keep them all finite
  for (int i = threadIdx.x; i < (D + HB) * TS_LD; i += TS_THREADS) ctx[i] = 0.0f;
  __syncthreads();

  const float scale = 1.0f / sqrtf((float)HD);
  for (int l = 0; l < p.NL; ++l) {
    const float* wqkv = p.wqkv + (size_t)l * D * 3 * D;
    const float* wo = p.wo + (size_t)l * D * D;
    const float* w1 = p.w1 + (size_t)l * D * FF;
    const float* w2 = p.w2 + (size_t)l * FF * D;
    const float* bqkv = p.bqkv + (size_t)l * 3 * D;
    const float* bo = p.bo + (size_t)l * D;
    const float* b1 = p.b1 + (size_t)l * FF;
    const float* b2 = p.b2 + (size_t)l * D;

    for (int h = 0; h < NH; ++h) {
      const Cols qkv_cols = {h * HD, HD, D};
      ring_gemm<6>(xs, D, wqkv, 3 * D, qkv_cols, 3 * HD, bqkv, ring,
                   [&](int c, int r0, float4 v) {
                     *reinterpret_cast<float4*>(hb + (size_t)c * TS_LD + r0) = v;
                   });
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
    ring_gemm<8>(ctx, D, wo, D, Cols{0, D, 0}, D, bo, ring, [&](int c, int r0, float4 v) {
      float4* px = reinterpret_cast<float4*>(xs + (size_t)c * TS_LD + r0);
      *px = add4(*px, v);
    });
    layer_norm(xs, D, p.ln1s + (size_t)l * D, p.ln1b + (size_t)l * D, red, nullptr,
               nullptr);
    for (int c0 = 0; c0 < FF; c0 += TS_FC) {
      const int P = FF - c0 < TS_FC ? FF - c0 : TS_FC;
      const auto relu_to_hb = [&](int c, int r0, float4 v) {
        *reinterpret_cast<float4*>(hb + (size_t)c * TS_LD + r0) =
            make_float4(fmaxf(v.x, 0.0f), fmaxf(v.y, 0.0f), fmaxf(v.z, 0.0f),
                        fmaxf(v.w, 0.0f));
      };
      if (P > 128)  // the narrower tile for a last chunk of <= 128 columns
        ring_gemm<6>(xs, D, w1, FF, Cols{c0, P, 0}, P, b1, ring, relu_to_hb);
      else
        ring_gemm<4>(xs, D, w1, FF, Cols{c0, P, 0}, P, b1, ring, relu_to_hb);
      ring_gemm<8>(hb, P, w2 + (size_t)c0 * D, D, Cols{0, D, 0}, D, nullptr, ring,
                   [&](int c, int r0, float4 v) {
                     float4* pc = reinterpret_cast<float4*>(ctx + (size_t)c * TS_LD + r0);
                     *pc = c0 == 0 ? v : add4(*pc, v);
                   });
    }
    layer_norm(xs, D, p.ln2s + (size_t)l * D, p.ln2b + (size_t)l * D, red, ctx, b2);
  }

  // mean over each real sample's L rows
  for (int i = threadIdx.x; i < S * D; i += TS_THREADS) {
    const int s = i / D, c = i - s * D;
    if (n0 + s >= p.N) continue;
    const float* col = xs + (size_t)c * TS_LD + s * L;
    float sum = 0.0f;
    for (int t = 0; t < L; ++t) sum += col[t];
    p.out[(size_t)(n0 + s) * D + c] = sum / (float)L;
  }
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
  return ((size_t)(2 * D + HB) * TS_LD + TS_STAGES * TS_BK * TS_WMAX +
          2 * TS_THREADS) * sizeof(float);
}

// All of x, the weights, the biases, the LayerNorm parameters and out f32.
// S samples per CTA (S * L <= 64). Returns 0 or a cudaError_t value.
int transenc_simt_launch(const void* x, void* out, const void* wqkv,
                         const void* wo, const void* w1, const void* w2,
                         const void* bqkv, const void* bo, const void* b1,
                         const void* b2, const void* ln1s, const void* ln1b,
                         const void* ln2s, const void* ln2b, int N, int L, int D,
                         int NH, int FF, int NL, int S, void* stream, int device) {
  USE_DEVICE(device);
  const size_t smem = transenc_simt_smem(L, D, NH, FF);
  if (smem == 0 || N < 1 || NL < 1 || S < 1 || S * L > TS_ROWS)
    return (int)cudaErrorInvalidValue;
  EncSimtParams p;
  p.x = static_cast<const float*>(x);
  p.out = static_cast<float*>(out);
  p.wqkv = static_cast<const float*>(wqkv);
  p.wo = static_cast<const float*>(wo);
  p.w1 = static_cast<const float*>(w1);
  p.w2 = static_cast<const float*>(w2);
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
  transenc_simt_kernel<<<grid, TS_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
