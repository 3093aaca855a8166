// Kernel K3, bf16: the whole transencoder2s encoder plus the mean over
// positions on Hopper's tensor cores, one tile of S samples (S L <= 64 rows)
// per CTA, in ONE launch. The math is transenc_encoder.cu's, which keeps the
// fp32 path; ops/transenc.py's k3_plan is the shape rule that picks this
// file or that one.
//
// Replaces: ccsmeth_tpu/ops/transenc_pallas.py::_make_encoder_kernel (:144),
//   launched by _encoder_call (:335) through encoder_pooled_pallas (:393),
//   as transenc_encoder.cu does.
//
// Bound on an H100 SXM: 134.8 MFLOP of products per sample at D = 256,
//   NH = 4, FF = 512, L = 21, NL = 6: compute-bound, 0.14 ms for 1024
//   samples at 989 TFLOP/s bf16. What sets this design's pace instead: the
//   mma.sync issue rate from shared memory (ldmatrix feeds every product),
//   and the weights: each CTA streams all six layers' 6.3 MB of bf16
//   weights from L2 once for its 63 rows, 34 GB of L2 reads at 16,384
//   samples.
//
// What the design does about that, against the f32 kernel (2 samples, 42
//   rows a block, f32 FMAs, each warp reading W from L2 itself):
//   - the four products of a layer (q|k|v D -> 3D, out D -> D, FF D -> FF ->
//     D) run on the tensor cores: mma.sync.m16n8k16 bf16 -> f32, A and B by
//     ldmatrix from shared memory;
//   - 64 rows a CTA (3 samples, 63 rows at L = 21), so each weight byte read
//     serves 63 rows, not 42;
//   - weights come through one ring per CTA that all 8 warps share: 32 x 128
//     tiles of W, three stages deep, filled by cp.async; the tiles of a
//     product stream without a break between its 128-column chunks;
//   - shared memory (226,816 bytes at the default shape): x f32 [64][D+8]
//     (the residual stream), x bf16 [64][D+8] (the product operand, rounded
//     once where LayerNorm writes it), q|k|v bf16 [64][3D+8] (the attention
//     context over q's columns, then the FF hidden layer), the ring;
//   - attention stays on the CUDA cores (~2% of the FLOPs): one thread per
//     (sample, head, query) holds its L <= 32 scores, reads bf16 q, k, v
//     16 bytes at a time and writes its context over its own q row;
//   - each 32-row k tile's fragments (both k steps) are loaded before its
//     16 mma, so the loads overlap.
//   A cluster of 2 CTAs with TMA multicast of each weight tile would halve
//   the L2 traffic; that is for a later change.
//
// Rounding, as the plain version and the f32 kernel's bf16 path: x, the
//   weights, q, k, v, the attention probabilities, the context and the
//   hidden layer are bf16 values, products sum in f32; softmax, LayerNorm
//   (biased variance, eps 1e-5), residuals and the mean stay f32.
//
// Shapes: S L <= 64, L <= 32, D and FF multiples of 32, D / NH a multiple
//   of 8, shared
//   memory within 227 KB (transenc.py's k3_plan checks it before the launch).
//   Padded rows and the samples past N of the ragged last tile start at
//   zero, stay within their own rows, and are not stored.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (ops/transenc.py builds it at first use). The C entry
//   point returns cudaGetLastError() after the launch.

#include "mma_tile.cuh"
#include "entry_device.cuh"

typedef __nv_bfloat16 bf16;

#define TE_THREADS 256
#define TE_WARPS (TE_THREADS / 32)
#define TE_ROWS 64
#define TE_LMAX 32
#define TE_BN 128
#define TE_BK 32
#define TE_STAGES 3
#define TE_WS (TE_BN + 8)  // ring row stride, in bf16

struct EncTcParams {
  const bf16* x;      // (N, L, D)
  float* out;         // (N, D)
  const bf16* wqkv;   // (NL, D, 3D), columns q | k | v
  const bf16* wo;     // (NL, D, D)
  const bf16* w1;     // (NL, D, FF)
  const bf16* w2;     // (NL, FF, D)
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

// out (64 x Nout) = A (64 x K, bf16 in shared memory, row stride lda) times
// W (K x Nout, bf16 in device memory, row-major), K % 32 == 0; handed to
// epi(row, col, v[col], v[col + 1]) a column pair at a time, one 128-column
// chunk after another. 2 x 4 warps, each a 32 x 32 tile of the chunk. The
// epilogue must not write A. Ends with the ring drained and a block barrier.
template <class Epi>
__device__ __forceinline__ void tc_gemm(const bf16* A, int lda, int K,
                                        const bf16* W, int Nout, bf16* ring,
                                        Epi epi) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int ktiles = K / TE_BK;
  const int total = ((Nout + TE_BN - 1) / TE_BN) * ktiles;

  auto load = [&](int stage, int it) {
    const int n0 = (it / ktiles) * TE_BN, k0 = (it % ktiles) * TE_BK;
    bf16* rs = ring + stage * TE_BK * TE_WS;
    for (int i = tid; i < TE_BK * TE_BN / 8; i += TE_THREADS) {
      const int r = i / (TE_BN / 8), c = (i % (TE_BN / 8)) * 8;
      const bool ok = n0 + c < Nout;
      const bf16* src = ok ? W + (size_t)(k0 + r) * Nout + n0 + c : W;
      cp_async_16(smem_u32(rs + r * TE_WS + c), src, ok);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int s = 0; s < TE_STAGES - 1; ++s) {
    if (s < total) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    const int kt = it % ktiles;
    if (kt == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.0f;
    }
    cp_async_wait<TE_STAGES - 2>();
    __syncthreads();
    const int nt = it + TE_STAGES - 1;
    if (nt < total) load(nt % TE_STAGES, nt);
    cp_async_commit();
    const bf16* rs = ring + (it % TE_STAGES) * TE_BK * TE_WS;
    // every fragment of the tile first, then its 16 mma: the loads of both
    // k steps are in flight together
    uint32_t a[2][2][4], b[2][4][2];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int kk = 16 * ks;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[ks][mt], smem_u32(A + (wm * 32 + mt * 16 + (lane & 15)) * lda +
                                        kt * TE_BK + kk + (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_u32(rs + (kk + (lane & 15)) * TE_WS + wn * 32 +
                                      np * 16 + (lane >> 4) * 8));
        b[ks][2 * np][0] = r[0];
        b[ks][2 * np][1] = r[1];
        b[ks][2 * np + 1][0] = r[2];
        b[ks][2 * np + 1][1] = r[3];
      }
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], a[ks][mt], b[ks][j]);
    if (kt == ktiles - 1) {
      const int n0 = (it / ktiles) * TE_BN;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + wn * 32 + j * 8 + 2 * t4;
          if (col >= Nout) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half)
            epi(wm * 32 + mt * 16 + g + 8 * half, col, acc[mt][j][2 * half],
                acc[mt][j][2 * half + 1]);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ void unpack8(const uint4 v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = unpack_bf16x2(w[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Per-sample multi-head attention over qb = [q | k | v] (bf16 rows): one
// thread per (sample, head, query row); its context row goes over its own q
// row, which no other thread reads. q, k and v are read 8 values (16 bytes)
// at a time; HD % 8 == 0.
__device__ __forceinline__ void attention_tc(bf16* qb, int qs, int D, int HD,
                                             int NH, int L, int S, float scale) {
  const int items = S * NH * L;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int i = it % L;
    const int sh = it / L;
    const int h = sh % NH, s = sh / NH;
    bf16* q = qb + (size_t)(s * L + i) * qs + h * HD;
    const bf16* kk = qb + (size_t)(s * L) * qs + D + h * HD;
    const bf16* vv = qb + (size_t)(s * L) * qs + 2 * D + h * HD;
    float p[TE_LMAX];
#pragma unroll
    for (int j = 0; j < TE_LMAX; ++j) p[j] = 0.0f;
    for (int dc = 0; dc < HD; dc += 8) {
      float qf[8];
      unpack8(*reinterpret_cast<const uint4*>(q + dc), qf);
#pragma unroll
      for (int j = 0; j < TE_LMAX; ++j)
        if (j < L) {
          float kf[8];
          unpack8(*reinterpret_cast<const uint4*>(kk + (size_t)j * qs + dc), kf);
#pragma unroll
          for (int e = 0; e < 8; ++e) p[j] = fmaf(qf[e], kf[e], p[j]);
        }
    }
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < TE_LMAX; ++j)
      if (j < L) {
        p[j] *= scale;
        m = fmaxf(m, p[j]);
      }
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < TE_LMAX; ++j)
      if (j < L) {
        p[j] = expf(p[j] - m);
        sum += p[j];
      }
#pragma unroll
    for (int j = 0; j < TE_LMAX; ++j)
      if (j < L) p[j] = __bfloat162float(__float2bfloat16_rn(p[j] / sum));
    for (int ec = 0; ec < HD; ec += 8) {
      float c[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) c[e] = 0.0f;
#pragma unroll
      for (int j = 0; j < TE_LMAX; ++j)
        if (j < L) {
          float vf[8];
          unpack8(*reinterpret_cast<const uint4*>(vv + (size_t)j * qs + ec), vf);
#pragma unroll
          for (int e = 0; e < 8; ++e) c[e] = fmaf(p[j], vf[e], c[e]);
        }
      uint4 o;
      o.x = pack_bf16x2(c[0], c[1]);
      o.y = pack_bf16x2(c[2], c[3]);
      o.z = pack_bf16x2(c[4], c[5]);
      o.w = pack_bf16x2(c[6], c[7]);
      *reinterpret_cast<uint4*>(q + ec) = o;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// In-place LayerNorm of the 64 rows of xf (f32), one warp per row; writes
// the bf16 copy xb, the next product's operand, beside it
__device__ __forceinline__ void layer_norm_tc(float* xf, bf16* xb, int xs, int D,
                                              const float* gm, const float* bt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < TE_ROWS; r += TE_WARPS) {
    float* row = xf + (size_t)r * xs;
    float s = 0.0f;
    for (int c = lane; c < D; c += 32) s += row[c];
    const float mu = warp_sum(s) / (float)D;
    float v = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const float d = row[c] - mu;
      v = fmaf(d, d, v);
    }
    const float rs = 1.0f / sqrtf(warp_sum(v) / (float)D + 1e-5f);
    for (int c = lane; c < D; c += 32) {
      const float y = (row[c] - mu) * rs * gm[c] + bt[c];
      row[c] = y;
      xb[(size_t)r * xs + c] = __float2bfloat16_rn(y);
    }
  }
}

__global__ void __launch_bounds__(TE_THREADS, 1)
    transenc_tc_kernel(const EncTcParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D, L = p.L, FF = p.FF, NH = p.NH;
  const int HD = D / NH;
  const int xs = D + 8;                             // x row stride
  const int qs = (3 * D > FF ? 3 * D : FF) + 8;     // q|k|v row stride
  float* xf = reinterpret_cast<float*>(smem_raw);   // [64][xs] f32
  bf16* xb = reinterpret_cast<bf16*>(xf + TE_ROWS * xs);  // [64][xs]
  bf16* qb = xb + TE_ROWS * xs;                     // [64][qs]
  bf16* ring = qb + TE_ROWS * qs;                   // [stage][BK][WS]
  const int n0 = blockIdx.x * p.S;                  // this tile's first sample
  const int rows = min(p.S * L, (p.N - n0) * L);    // real rows of this tile

  const bf16* x = p.x + (size_t)n0 * L * D;
  for (int i = threadIdx.x; i < TE_ROWS * D / 8; i += TE_THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)r * D + c));
    *reinterpret_cast<uint4*>(xb + r * xs + c) = v;
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = unpack_bf16x2(w[j]);
      xf[r * xs + c + 2 * j] = f.x;
      xf[r * xs + c + 2 * j + 1] = f.y;
    }
  }
  __syncthreads();

  const float scale = 1.0f / sqrtf((float)HD);
  for (int l = 0; l < p.NL; ++l) {
    const bf16* wqkv = p.wqkv + (size_t)l * D * 3 * D;
    const bf16* wo = p.wo + (size_t)l * D * D;
    const bf16* w1 = p.w1 + (size_t)l * D * FF;
    const bf16* w2 = p.w2 + (size_t)l * FF * D;
    const float* bqkv = p.bqkv + (size_t)l * 3 * D;
    const float* bo = p.bo + (size_t)l * D;
    const float* b1 = p.b1 + (size_t)l * FF;
    const float* b2 = p.b2 + (size_t)l * D;

    tc_gemm(xb, xs, D, wqkv, 3 * D, ring, [&](int r, int c, float v0, float v1) {
      *reinterpret_cast<uint32_t*>(qb + r * qs + c) =
          pack_bf16x2(v0 + bqkv[c], v1 + bqkv[c + 1]);
    });
    attention_tc(qb, qs, D, HD, NH, L, p.S, scale);
    __syncthreads();
    tc_gemm(qb, qs, D, wo, D, ring, [&](int r, int c, float v0, float v1) {
      float2* px = reinterpret_cast<float2*>(xf + r * xs + c);
      const float2 o = *px;
      *px = make_float2(o.x + (v0 + bo[c]), o.y + (v1 + bo[c + 1]));
    });
    layer_norm_tc(xf, xb, xs, D, p.ln1s + (size_t)l * D, p.ln1b + (size_t)l * D);
    __syncthreads();
    tc_gemm(xb, xs, D, w1, FF, ring, [&](int r, int c, float v0, float v1) {
      *reinterpret_cast<uint32_t*>(qb + r * qs + c) =
          pack_bf16x2(fmaxf(v0 + b1[c], 0.0f), fmaxf(v1 + b1[c + 1], 0.0f));
    });
    tc_gemm(qb, qs, FF, w2, D, ring, [&](int r, int c, float v0, float v1) {
      float2* px = reinterpret_cast<float2*>(xf + r * xs + c);
      const float2 o = *px;
      *px = make_float2(o.x + (v0 + b2[c]), o.y + (v1 + b2[c + 1]));
    });
    layer_norm_tc(xf, xb, xs, D, p.ln2s + (size_t)l * D, p.ln2b + (size_t)l * D);
    __syncthreads();
  }

  // mean over each real sample's L rows
  for (int i = threadIdx.x; i < p.S * D; i += TE_THREADS) {
    const int s = i / D, c = i - s * D;
    if (n0 + s >= p.N) continue;
    float sum = 0.0f;
    for (int t = 0; t < L; ++t) sum += xf[(s * L + t) * xs + c];
    p.out[(size_t)(n0 + s) * D + c] = sum / (float)L;
  }
}

extern "C" {

// All of x and the weights bf16; biases, LayerNorm parameters and out f32.
// S samples per CTA (S * L <= 64). Returns 0 or a cudaError_t value.
int transenc_tc_launch(const void* x, void* out, const void* wqkv,
                       const void* wo, const void* w1, const void* w2,
                       const void* bqkv, const void* bo, const void* b1,
                       const void* b2, const void* ln1s, const void* ln1b,
                       const void* ln2s, const void* ln2b, int N, int L, int D,
                       int NH, int FF, int NL, int S, void* stream, int device) {
  USE_DEVICE(device);
  if (N < 1 || L < 1 || L > TE_LMAX || S < 1 || S * L > TE_ROWS || D < 32 ||
      D % 32 != 0 || FF < 32 || FF % 32 != 0 || NH < 1 || D % NH != 0 ||
      (D / NH) % 8 != 0 || NL < 1)
    return (int)cudaErrorInvalidValue;
  EncTcParams p;
  p.x = static_cast<const bf16*>(x);
  p.out = static_cast<float*>(out);
  p.wqkv = static_cast<const bf16*>(wqkv);
  p.wo = static_cast<const bf16*>(wo);
  p.w1 = static_cast<const bf16*>(w1);
  p.w2 = static_cast<const bf16*>(w2);
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
  const int qw = 3 * D > FF ? 3 * D : FF;
  const size_t smem = (size_t)TE_ROWS * (D + 8) * (sizeof(float) + sizeof(bf16)) +
                      (size_t)TE_ROWS * (qw + 8) * sizeof(bf16) +
                      (size_t)TE_STAGES * TE_BK * TE_WS * sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(
      transenc_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (N + S - 1) / S;
  transenc_tc_kernel<<<grid, TE_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
