// Kernel K3, design l2 (the first f32 kernel, kept for the shapes that the
// simt and tc designs refuse): the whole transencoder2s encoder plus the
// mean over positions, for one tile of samples per block, in ONE launch: NL
// post-LayerNorm layers (multi-head self-attention over each sample's own L
// positions, then a ReLU feed-forward), then mean over L. Inference only,
// no dropout.
//
// Replaces: ccsmeth_tpu/ops/transenc_pallas.py::_make_encoder_kernel (:144;
//   the default body :261-327), launched there by _encoder_call (:335)
//   through encoder_pooled_pallas (:393). The TPU kernel packs 12 samples
//   block-diagonally into 252-row attention products under a -1e9 mask, and
//   carries five other attention layouts; all of that is layout for a
//   128 x 128 MXU. This kernel computes the per-sample math those layouts
//   compute: per layer
//     qkv = x Wqkv + bqkv;  per head h (HD = D / NH):
//       ctx_h = softmax(q_h k_h^T / sqrt(HD)) v_h  over the sample's L rows;
//     x = LN(x + ctx Wo + bo);  x = LN(x + relu(x W1 + b1) W2 + b2)
//   (LN: biased variance, eps 1e-5), then out = mean over L, in f32.
//
// Bound on an H100 SXM: 134.8 MFLOP of products per strand-sample at
//   D = 256, NH = 4, FF = 512, L = 21, NL = 6, against 21.5 KB of input
//   (fp32) and 1 KB of output: compute-bound. At 2B = 1024 samples that is
//   138.1 GFLOP: 2.06 ms at 67 TFLOP/s (fp32 CUDA cores), 0.14 ms at
//   989 TFLOP/s (bf16 tensor cores).
//
// What this design does about that: keeps the activations on chip across
//   all layers, which is what the TPU kernel is for (transenc_pallas.py:3-10);
//   device memory sees x once, the weights once per block from L2, and the
//   (N, D) output. It is the simple, correct version: FP32 FMAs on the CUDA
//   cores, no tensor cores. The weights (12.6 MB in fp32 for six layers,
//   6.3 MB in bf16) stay resident in the 50 MB L2 and are streamed from
//   there; each block reads every weight once per tile of S samples, so L2
//   traffic is 12.6 MB per tile. It serves the shapes that ops/transenc.py's
//   k3_plan sends to neither transenc_simt.cu (fp32, 64 rows a CTA, the
//   weights through a shared ring) nor transenc_tc.cu (bf16 on the tensor
//   cores), in fp32 (exact f32 arithmetic, no TF32) or bf16.
//
// Design:
//   - one block of 256 threads (8 warps) owns S samples, M = S*L rows,
//     padded to Mp = 8R rows (warp w owns rows wR .. wR+R-1); at the default
//     shape S = 2, M = 42, R = 6, Mp = 48;
//   - shared memory, all f32 and k-major ([column][row], row stride ld =
//     Mp + 2 or + 4, so a thread's R rows are one to two vector loads):
//       xs [D][ld]          the activation x (the residual stream, f32);
//       bs [max(3D,FF)][ld] q|k|v, then the attention context over q's
//                           columns, then the feed-forward hidden layer;
//     205 KB at the default shape (opted into with cudaFuncSetAttribute);
//   - products (block_gemm): lane l of every warp owns column groups
//     l and l + 32 (4 columns each) of a 256-column pass, for the warp's R
//     rows: per k, two 4-wide weight loads (coalesced across the warp, L1
//     serves the other seven warps), R/2 or R/4 shared loads (the same
//     address across the warp), 8R FMAs;
//   - attention: one thread per (sample, head, query row) holds its L
//     scores in registers (L <= 32), takes the softmax there, and writes
//     its context row over its own q row, which no other thread reads;
//   - LayerNorm: one warp per row, shuffle sums;
//   - padded rows and the samples past N of the ragged last tile start at
//     zero and stay within their own rows: attention never mixes samples,
//     and nothing of them is stored;
//   - rounding: with bf16 operands (T = __nv_bfloat16) every operand of a
//     product is a bf16 value (x and the weights, q, k, v, the attention
//     probabilities, the context, the hidden layer), products are exact in
//     f32 and sums accumulate in f32; softmax, LayerNorm, residuals and the
//     mean stay f32 (the TPU's default variant keeps its softmax in bf16;
//     f32 here is inside the bf16 envelope).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (ops/transenc.py builds it at first use). The C entry
//   point returns cudaGetLastError() after the launch.

#include "rnn_common.cuh"
#include "entry_device.cuh"

#define ENC_THREADS 256
#define ENC_WARPS (ENC_THREADS / 32)
#define ENC_LMAX 32

struct EncParams {
  const void* x;     // (N, L, D) operand type
  float* out;        // (N, D) f32
  const void* wqkv;  // (NL, D, 3D) operand type, columns q | k | v
  const void* wo;    // (NL, D, D)
  const void* w1;    // (NL, D, FF)
  const void* w2;    // (NL, FF, D)
  const float* bqkv;  // (NL, 3D)
  const float* bo;    // (NL, D)
  const float* b1;    // (NL, FF)
  const float* b2;    // (NL, D)
  const float* ln1s;  // (NL, D) LayerNorm scale / bias, after attention
  const float* ln1b;
  const float* ln2s;  // after the feed-forward
  const float* ln2b;
  int N, L, D, NH, FF, NL, S, ld;
};

// R consecutive f32 rows of one column from shared memory; R is even and the
// address 8-byte aligned (16-byte when R % 4 == 0)
template <int R>
__device__ __forceinline__ void load_col_rows(const float* p, float v[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; i += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + i);
      v[i] = q.x;
      v[i + 1] = q.y;
    }
  }
}

// out[row][col] = sum_k A[k][row] W[k][col] for the block's Mp rows and
// ncols columns, handed to epi(row, col, sum). A: k-major f32 in shared
// memory (row stride ld); W: (K, ldw) in the operand type, in device memory
// (L2). ROUND_A rounds A to the operand type (A = the f32 residual stream).
template <typename T, int R, bool ROUND_A, class Epi>
__device__ __forceinline__ void block_gemm(const float* A, int K, int ld,
                                           const T* W, int ldw, int ncols,
                                           Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * R;
  const int n4 = ncols / 4;
  for (int g0 = 0; g0 < n4; g0 += 64) {
    const int ga = g0 + lane, gb = g0 + 32 + lane;
    const bool va = ga < n4, vb = gb < n4;
    const T* wa = W + 4 * ga;
    const T* wb = W + 4 * gb;
    float acc0[R][4], acc1[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc0[r][j] = 0.0f;
        acc1[r][j] = 0.0f;
      }
    }
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float w0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float w1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float a[R];
      if (va) Op<T>::load4(wa + (size_t)k * ldw, w0);
      if (vb) Op<T>::load4(wb + (size_t)k * ldw, w1);
      load_col_rows<R>(A + k * ld + r0, a);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float av = ROUND_A ? Op<T>::operand(a[r]) : a[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc0[r][j] = fmaf(av, w0[j], acc0[r][j]);
          acc1[r][j] = fmaf(av, w1[j], acc1[r][j]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (va) epi(r0 + r, 4 * ga + j, acc0[r][j]);
        if (vb) epi(r0 + r, 4 * gb + j, acc1[r][j]);
      }
    }
  }
}

// Per-sample multi-head attention over bs = [q | k | v] (k-major, operand
// values): one thread per (sample, head, query row); its context row goes
// over its own q row.
template <typename T>
__device__ __forceinline__ void attention(float* bs, int ld, int D, int HD,
                                          int NH, int L, int S, float scale) {
  const int items = S * NH * L;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int i = it % L;
    const int sh = it / L;
    const int h = sh % NH, s = sh / NH;
    const int row = s * L + i;
    float* q = bs + (size_t)(h * HD) * ld + row;
    const float* kk = bs + (size_t)(D + h * HD) * ld + s * L;
    const float* vv = bs + (size_t)(2 * D + h * HD) * ld + s * L;
    float p[ENC_LMAX];
#pragma unroll
    for (int j = 0; j < ENC_LMAX; ++j) p[j] = 0.0f;
    for (int d = 0; d < HD; ++d) {
      const float qv = q[(size_t)d * ld];
      const float* kd = kk + (size_t)d * ld;
#pragma unroll
      for (int j = 0; j < ENC_LMAX; ++j)
        if (j < L) p[j] = fmaf(qv, kd[j], p[j]);
    }
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < ENC_LMAX; ++j) {
      if (j < L) {
        p[j] *= scale;
        m = fmaxf(m, p[j]);
      }
    }
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < ENC_LMAX; ++j) {
      if (j < L) {
        p[j] = expf(p[j] - m);
        sum += p[j];
      }
    }
#pragma unroll
    for (int j = 0; j < ENC_LMAX; ++j)
      if (j < L) p[j] = Op<T>::operand(p[j] / sum);
    for (int e = 0; e < HD; ++e) {
      const float* ve = vv + (size_t)e * ld;
      float c = 0.0f;
#pragma unroll
      for (int j = 0; j < ENC_LMAX; ++j)
        if (j < L) c = fmaf(p[j], ve[j], c);
      q[(size_t)e * ld] = Op<T>::operand(c);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// In-place LayerNorm of the rows of xs (k-major), one warp per row.
__device__ __forceinline__ void layer_norm(float* xs, int ld, int D, int rows,
                                           const float* g, const float* b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += ENC_WARPS) {
    float s = 0.0f;
    for (int c = lane; c < D; c += 32) s += xs[(size_t)c * ld + r];
    const float mu = warp_sum(s) / (float)D;
    float v = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const float d = xs[(size_t)c * ld + r] - mu;
      v = fmaf(d, d, v);
    }
    const float rs = 1.0f / sqrtf(warp_sum(v) / (float)D + 1e-5f);
    for (int c = lane; c < D; c += 32) {
      float* px = xs + (size_t)c * ld + r;
      *px = (*px - mu) * rs * g[c] + b[c];
    }
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(ENC_THREADS, 1)
    transenc_encoder_kernel(const EncParams p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, L = p.L, FF = p.FF, NH = p.NH, ld = p.ld;
  const int HD = D / NH;
  const int Mp = ENC_WARPS * R;
  const int M = p.S * L;
  const int n0 = blockIdx.x * p.S;  // this tile's first sample
  const int rows = min(M, (p.N - n0) * L);  // real rows of this tile
  float* xs = smem;                  // [D][ld]
  float* bs = smem + (size_t)D * ld; // [max(3D, FF)][ld]

  const T* x = static_cast<const T*>(p.x) + (size_t)n0 * L * D;
  for (int i = threadIdx.x; i < Mp * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D;
    xs[(size_t)c * ld + r] = (r < rows) ? Op<T>::to_f(x[(size_t)r * D + c]) : 0.0f;
  }
  __syncthreads();

  const float scale = 1.0f / sqrtf((float)HD);
  for (int l = 0; l < p.NL; ++l) {
    const T* wqkv = static_cast<const T*>(p.wqkv) + (size_t)l * D * 3 * D;
    const T* wo = static_cast<const T*>(p.wo) + (size_t)l * D * D;
    const T* w1 = static_cast<const T*>(p.w1) + (size_t)l * D * FF;
    const T* w2 = static_cast<const T*>(p.w2) + (size_t)l * FF * D;
    const float* bqkv = p.bqkv + (size_t)l * 3 * D;
    const float* bo = p.bo + (size_t)l * D;
    const float* b1 = p.b1 + (size_t)l * FF;
    const float* b2 = p.b2 + (size_t)l * D;

    block_gemm<T, R, true>(xs, D, ld, wqkv, 3 * D, 3 * D,
                           [&](int r, int c, float a) {
                             bs[(size_t)c * ld + r] = Op<T>::operand(a + bqkv[c]);
                           });
    __syncthreads();
    attention<T>(bs, ld, D, HD, NH, L, p.S, scale);
    __syncthreads();
    block_gemm<T, R, false>(bs, D, ld, wo, D, D, [&](int r, int c, float a) {
      xs[(size_t)c * ld + r] += a + bo[c];
    });
    __syncthreads();
    layer_norm(xs, ld, D, Mp, p.ln1s + (size_t)l * D, p.ln1b + (size_t)l * D);
    __syncthreads();
    block_gemm<T, R, true>(xs, D, ld, w1, FF, FF, [&](int r, int c, float a) {
      bs[(size_t)c * ld + r] = Op<T>::operand(fmaxf(a + b1[c], 0.0f));
    });
    __syncthreads();
    block_gemm<T, R, false>(bs, FF, ld, w2, D, D, [&](int r, int c, float a) {
      xs[(size_t)c * ld + r] += a + b2[c];
    });
    __syncthreads();
    layer_norm(xs, ld, D, Mp, p.ln2s + (size_t)l * D, p.ln2b + (size_t)l * D);
    __syncthreads();
  }

  // mean over each real sample's L rows
  for (int i = threadIdx.x; i < p.S * D; i += blockDim.x) {
    const int s = i / D, c = i - s * D;
    if (n0 + s >= p.N) continue;
    const float* col = xs + (size_t)c * ld + s * L;
    float sum = 0.0f;
    for (int t = 0; t < L; ++t) sum += col[t];
    p.out[(size_t)(n0 + s) * D + c] = sum / (float)L;
  }
}

template <typename T, int R>
static int launch_typed(const EncParams& p, cudaStream_t stream) {
  const int B = p.D > 0 ? (3 * p.D > p.FF ? 3 * p.D : p.FF) : 0;
  const size_t smem = (size_t)(p.D + B) * p.ld * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        transenc_encoder_kernel<T, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (p.N + p.S - 1) / p.S;
  transenc_encoder_kernel<T, R><<<grid, ENC_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_rows(const EncParams& p, int R, cudaStream_t s) {
  if (R == 2) return launch_typed<T, 2>(p, s);
  if (R == 4) return launch_typed<T, 4>(p, s);
  if (R == 6) return launch_typed<T, 6>(p, s);
  if (R == 8) return launch_typed<T, 8>(p, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and the weights; biases, LayerNorm
// parameters and out are f32). S samples per block, R rows per warp
// (2, 4, 6 or 8; S * L <= 8R), ld the shared row stride (>= 8R, even, a
// multiple of 4 when R is). Returns 0 or a cudaError_t value.
int transenc_encoder_launch(int dtype, const void* x, void* out,
                            const void* wqkv, const void* wo, const void* w1,
                            const void* w2, const void* bqkv, const void* bo,
                            const void* b1, const void* b2, const void* ln1s,
                            const void* ln1b, const void* ln2s,
                            const void* ln2b, int N, int L, int D, int NH,
                            int FF, int NL, int S, int R, int ld,
                            void* stream, int device) {
  USE_DEVICE(device);
  if (N < 1 || L < 1 || L > ENC_LMAX || D < 4 || D % 4 != 0 || NH < 1 ||
      D % NH != 0 || FF < 4 || FF % 4 != 0 || NL < 1 || S < 1 ||
      S * L > ENC_WARPS * R || ld < ENC_WARPS * R || ld % 2 != 0 ||
      (R % 4 == 0 && ld % 4 != 0))
    return (int)cudaErrorInvalidValue;
  EncParams p;
  p.x = x;
  p.out = static_cast<float*>(out);
  p.wqkv = wqkv;
  p.wo = wo;
  p.w1 = w1;
  p.w2 = w2;
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
  p.ld = ld;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_rows<float>(p, R, s);
  if (dtype == 1) return launch_rows<__nv_bfloat16>(p, R, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
