// Kernel K3, bf16: the whole transencoder2s encoder plus the mean over
// positions on Hopper's own tensor-core path (wgmma fed by TMA), one tile of
// S samples (S L <= 64 rows) a CTA, in ONE launch. fp32 runs
// transenc_simt.cu, and the shapes neither takes run transenc_encoder.cu;
// ops/transenc.py's k3_plan is the shape rule among the three.
//
// Replaces: ccsmeth_tpu/ops/transenc_pallas.py::_make_encoder_kernel (:144),
//   launched by _encoder_call (:335) through encoder_pooled_pallas (:393),
//   as transenc_encoder.cu does.
//
// Bound on an H100 SXM: 134.8 MFLOP of products per sample at D = 256,
//   NH = 4, FF = 512, L = 21, NL = 6: compute-bound, 0.14 ms for 1,024
//   samples at 989 TFLOP/s bf16. A CTA's six layers are 403 MFLOP of
//   wgmma, 54 us at one SM's share of that peak. What stands in the way:
//   the weights, 6.3 MB of bf16 that every tile of 64 rows needs in full,
//   layer after layer (one 16 KB tile of 64 x 128 every 256 tensor-core
//   cycles at the SM's rate); the chain of products, attention, LayerNorm
//   and epilogues inside a layer, which no other tile of the CTA overlaps;
//   the waves of one CTA an SM. Measured on an H100 (chip_smoke.py --only
//   k3_tc_probe), the products themselves set the pace, at about 44% of the
//   SM's tensor rate with one wgmma group in flight a warpgroup, then the
//   ring's waits at product starts and the serial chain.
//
// What the design does about that:
//   - warp specialisation: one producer thread streams the weight tiles of
//     all 4 NL products, in the order the consumers use them, with TMA into
//     one ring of TE_STAGES slots on mbarriers (`full`: TMA's bytes landed;
//     `empty`: every consumer of the slot released it). It runs ahead
//     across products and layers, so the next product's tiles arrive while
//     attention, LayerNorm and the epilogues run; the ring never drains
//     inside the kernel. A warpgroup releases a slot as soon as the
//     products that read it are done, so it holds one slot at a time;
//   - two consumer warpgroups run wgmma.m64nDWk16 (DW = D / 2): A (the x,
//     context or hidden operand, 64 rows) from shared memory, K-major under
//     the 128-byte swizzle, which the consumers write themselves; B the
//     weight tile as TMA stores it (64 k rows of 64-column boxes, MN-major,
//     128-byte swizzle, read with trans-b). Warpgroup w owns output columns
//     [w DW, w DW + DW) of the D-wide products (out, FF2) and chunks 2 j + w
//     of the wide ones (q|k|v: 6 chunks, FF1: 2 FF / D); the ring carries
//     their tiles interleaved, warpgroup 0's then 1's, k tile after k tile.
//     Each chunk's bias pairs load while its products run; its bf16
//     values go to shared memory by stmatrix, four 8 x 8 tiles a store;
//   - the f32 residual stream lives in the consumers' registers in the
//     wgmma accumulator layout (warpgroup w: columns [w DW, w DW + DW) of
//     all 64 rows, DW / 2 registers a thread), so shared memory holds only
//     the bf16 operands and the ring: 65,536 bytes of ring (TE_STAGES = 4
//     slots of 64 x 128 tiles) at D = 256. The out and FF2 epilogues add
//     bias and residual in registers; LayerNorm sums each row within a quad
//     by shuffles, then across the two warpgroups through a 2 x 64 array in
//     a fixed order (mean first, then the centred squares), and writes the
//     next product's bf16 operand;
//   - one CTA a tile, each reading every weight tile from L2 itself (6.3 MB
//     a tile of rows). Clusters of 2 sharing each tile by TMA multicast
//     halve those reads, but on an H100 they timed within 1% of one CTA a
//     tile, each at its best ring depth (PERF.md): L2 is not what sets the
//     pace, so the design keeps the single CTA;
//   - attention on the tensor cores too (~2% of the FLOPs, but 45% of a
//     layer's time on an H100 when it ran on the CUDA cores, one thread a
//     (sample, head, query)): each warpgroup takes every second
//     head of width 64, the scores of the tile's 64 rows by its 64 key rows
//     in one m64n64 wgmma chain, masked to each row's sample; softmax in
//     registers, one reciprocal a row; the probabilities through the x
//     operand's block of the head into P V;
//   - waves: S = 3 samples (63 of 64 rows) a CTA at L = 21. 1,024 samples
//     are 342 CTAs against 132 resident (132 SMs, one 193 KB CTA each):
//     2.59 waves. Fewer samples a CTA fill the last wave better (S = 2: 512
//     CTAs, 3.88 waves) but take 4 waves of the same weight stream instead
//     of 3.
//
// Rounding, as the plain version and the f32 kernel's bf16 path: x, the
//   weights, q, k, v, the attention probabilities, the context and the
//   hidden layer are bf16 values, products sum in f32 (inside a wgmma in the
//   instruction's own order); softmax (each probability its exponential,
//   by the SFU's ex2 (__expf, a few ulp of f32, far below the bf16 rounding
//   that follows), times the reciprocal of the row's sum),
//   LayerNorm (biased variance, eps 1e-5), residuals and the mean stay f32.
//   Every sum has one owner and a fixed order, no atomics: reruns are
//   bit-equal, and every ring depth gives the same bits.
//
// Shapes: D 128 or 256 (DW = 64 or 128), FF a multiple of D, heads of
//   width 64 (D = 64 NH), L <= 32, S L <= 64, shared memory
//   (transenc_tc_smem) within 227 KB. transenc.py's k3_plan checks them
//   before the launch and the C entry refuses anything else.
//   Padded rows and the samples past N of the ragged last tile start at
//   zero, stay within their own rows (a padded row's context is 0), and
//   are not stored.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (ops/transenc.py builds it at first use). The C entry
//   point returns cudaGetLastError() after the launch.

#include "wgmma_tile.cuh"
#include "entry_device.cuh"

typedef __nv_bfloat16 bf16;

#define TE_ROWS 64        // rows a CTA: one wgmma tile of M
#define TE_LMAX 32
#define TE_BK 64          // k rows of a ring tile
#define TE_BOX 8192       // a 64-row block of 128-byte rows, bytes
#define TE_CONSUMERS 256  // two consumer warpgroups
#define TE_THREADS 288    // and one producer warp
// ring slots; chip_smoke.py's k3_tc_sweep builds copies with -DTE_STAGES=n
#ifndef TE_STAGES
#define TE_STAGES 4
#endif

struct EncTcParams {
  const bf16* x;      // (N, L, D)
  float* out;         // (N, D)
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

// Shared memory a CTA, bytes: the ring (TE_STAGES tiles of 64 k rows x D /
// 2 columns), the x operand (64 x D bf16), q|k|v or the hidden layer (64 x
// max(3D, FF) bf16), LayerNorm's row sums (2 passes x 2 warpgroups x 64 f32)
// and the 2 TE_STAGES mbarriers
static inline size_t transenc_tc_smem(int D, int FF) {
  const int qw = 3 * D > FF ? 3 * D : FF;
  return (size_t)TE_STAGES * TE_BK * D + (size_t)TE_ROWS * (D + qw) * 2 + 4 * TE_ROWS * 4 +
         16 * TE_STAGES;
}

// byte offset of (row r, column c) in a 64-row bf16 operand held as blocks
// of 64 columns, each 64 rows of 128 bytes under the 128-byte swizzle: the
// K-major image a wgmma descriptor reads (wgmma_tile.cuh's kmajor_off)
__device__ __forceinline__ uint32_t sw_off(int r, int c) {
  return (uint32_t)((c >> 6) * TE_BOX + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) +
                    (c & 7) * 2);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(TE_CONSUMERS) : "memory");
}

// the packed bf16 pairs pk[2 jj + hh] of a warpgroup's wgmma fragments (rows
// 16 warp + lane / 4 + 8 hh, columns col + 8 jj + 2 (lane % 4), + 1) into
// the swizzled image at `img`, four 8 x 8 matrices a stmatrix: the bytes
// that a 4-byte store of each pair at sw_off would write
template <int NG>
__device__ __forceinline__ void store_pairs(uint32_t img, int col, const uint32_t (&pk)[2 * NG]) {
  const int lane = threadIdx.x & 31, q = lane >> 3;
  const int row = 16 * ((threadIdx.x >> 5) & 3) + (lane & 7) + 8 * (q & 1);
#pragma unroll
  for (int jj = 0; jj < NG; jj += 2)
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     img + sw_off(row, col + 8 * (jj + (q >> 1)))),
                 "r"(pk[2 * jj]), "r"(pk[2 * jj + 1]), "r"(pk[2 * jj + 2]), "r"(pk[2 * jj + 3])
                 : "memory");
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// Per-sample multi-head attention on the tensor cores, a head of width 64
// one 64-column block of q, k and v: warpgroup wg takes heads wg, wg + 2, ..
// For each, the scores Q_h K_h^T of all 64 rows by all 64 key rows
// (wgmma.m64n64k16: A the q block, B the k block, both K-major), masked to
// each row's own sample and scaled; softmax in registers (a row's 16 values
// a thread, then the quad's by xor shuffles); the bf16 probabilities into
// the x operand's block h (x is consumed); the context P V_h (A those
// probabilities, B the v block as stored: MN-major, key rows along k),
// rounded to bf16 over them. Rows past S L get probabilities 0.
__device__ __forceinline__ void attention(uint32_t base, uint32_t qb, uint32_t xb, int D, int NH,
                                          int L, int S, float scale, int wg, int r0, int t4) {
  // this thread's rows' keys: [lo, hi), those of the row's own sample
  // (none past S L)
  int lo[2], hi[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int s = (r0 + 8 * hh) / L;
    lo[hh] = s < S ? s * L : 0;
    hi[hh] = s < S ? s * L + L : 0;
  }
  for (int h = wg; h < NH; h += 2) {
    const uint32_t qa = base + qb + h * TE_BOX, ka = base + qb + (D / 64 + h) * TE_BOX;
    const uint32_t va = base + qb + (2 * D / 64 + h) * TE_BOX, pa = base + xb + h * TE_BOX;
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<64>::mma<0>(sc, kmajor_desc(qa + 32 * kk, 128), kmajor_desc(ka + 32 * kk, 128),
                        kk != 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    float m[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1, c = 8 * (i >> 2) + 2 * t4 + (i & 1);
      sc[i] = c >= lo[hh] && c < hi[hh] ? sc[i] * scale : -INFINITY;
      m[hh] = fmaxf(m[hh], sc[i]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
      m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 2));
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      sc[i] = sc[i] == -INFINITY ? 0.0f : __expf(sc[i] - m[hh]);
      sum[hh] += sc[i];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
    }
    float inv[2];  // one reciprocal a row (0 for a row without keys)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) inv[hh] = sum[hh] > 0.0f ? 1.0f / sum[hh] : 0.0f;
    uint32_t pk[16];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        pk[2 * jj + hh] =
            pack_bf16x2(sc[4 * jj + 2 * hh] * inv[hh], sc[4 * jj + 2 * hh + 1] * inv[hh]);
    store_pairs<8>(base + xb, 64 * h, pk);
    fence_async_shared();  // visible to wgmma
    warpgroup_sync(wg);
    float cx[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<64>::mma<1>(cx, kmajor_desc(pa + 32 * kk, 128), mnmajor_desc(va + 2048 * kk, TE_BOX, 1024),
                        kk != 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(cx);
    warpgroup_sync(wg);  // every warp's reads of the probabilities are done
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        pk[2 * jj + hh] = pack_bf16x2(cx[4 * jj + 2 * hh], cx[4 * jj + 2 * hh + 1]);
    store_pairs<8>(base + xb, 64 * h, pk);
  }
}

template <int DW>
__global__ void __launch_bounds__(TE_THREADS, 1)
    transenc_tc_kernel(const __grid_constant__ CUtensorMap mqkv,
                       const __grid_constant__ CUtensorMap mo,
                       const __grid_constant__ CUtensorMap m1,
                       const __grid_constant__ CUtensorMap m2, const EncTcParams p) {
  constexpr int STAGES = TE_STAGES;
  constexpr uint32_t SLOT = TE_BK * DW * 2;  // one ring tile, bytes
  constexpr int NR = DW / 2;                 // accumulator registers a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int D = p.D, L = p.L, FF = p.FF, NL = p.NL;
  const int QW = 3 * D > FF ? 3 * D : FF;
  // offsets from the base: the ring, the x operand, q|k|v (or the hidden
  // layer), LayerNorm's sums, the barriers
  const uint32_t XB = STAGES * SLOT, QB = XB + TE_ROWS * D * 2, RED = QB + TE_ROWS * QW * 2;
  const uint32_t base = smem_u32(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw + RED);  // [pass][warpgroup][row]
  const uint32_t full = base + RED + 4 * TE_ROWS * 4, empty = full + 8 * STAGES;
  const int tid = threadIdx.x;
  if ((base & 1023) != 0) __trap();  // the swizzled images need 1024-byte alignment
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= TE_CONSUMERS) {  // the producer warp: one thread keeps the ring full
    if (tid == TE_CONSUMERS) {
      int g = 0;  // tiles issued, in the consumers' order
      for (int l = 0; l < NL; ++l)
        for (int q = 0; q < 4; ++q) {  // q|k|v, out, FF1, FF2
          const CUtensorMap* map = q == 0 ? &mqkv : q == 1 ? &mo : q == 2 ? &m1 : &m2;
          const int K = q == 3 ? FF : D;                      // the weight's k rows
          const int nch = q == 0 ? 3 : q == 2 ? FF / D : 1;  // chunks a warpgroup
          for (int j = 0; j < nch; ++j)
            for (int k0 = 0; k0 < K; k0 += TE_BK)
              for (int w = 0; w < 2; ++w, ++g) {
                const int s = g % STAGES;
                if (g >= STAGES) mbar_wait(empty + 8 * s, ((g / STAGES) - 1) & 1);
                mbar_expect_tx(full + 8 * s, SLOT);
#pragma unroll
                for (int h = 0; h < DW / 64; ++h)
                  tma_load_2d(base + s * SLOT + h * TE_BOX, map, full + 8 * s,
                              (2 * j + w) * DW + 64 * h, l * K + k0);
              }
        }
    }
    return;
  }

  unsigned char* sm = smem_raw;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t4 = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);  // this thread's rows: r0, r0 + 8
  const int c0 = wg * DW + 2 * t4;         // its columns: c0 + 8 jj, + 1
  const int n0 = blockIdx.x * p.S;         // this tile's first sample
  const int rows = min(p.S * L, (p.N - n0) * L);  // its real rows

  // x into the operand image, and this thread's share of the residual
  const bf16* x = p.x + (size_t)n0 * L * D;
  for (int i = tid; i < TE_ROWS * D / 8; i += TE_CONSUMERS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)r * D + c));
    *reinterpret_cast<uint4*>(sm + XB + sw_off(r, c)) = v;
  }
  fence_async_shared();  // visible to wgmma
  consumer_sync();
  float res[NR];
#pragma unroll
  for (int jj = 0; jj < DW / 8; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 f = unpack_bf16x2(
          *reinterpret_cast<const uint32_t*>(sm + XB + sw_off(r0 + 8 * hh, c0 + 8 * jj)));
      res[4 * jj + 2 * hh] = f.x;
      res[4 * jj + 2 * hh + 1] = f.y;
    }

  // this warpgroup's tiles are every second one of the ring's order
  int g = wg;
  auto release = [&](int s) {
    if ((tid & 127) == 0) mbar_arrive(empty + 8 * s);
  };
  // out (64 x DW chunk j of this warpgroup, columns (2 j + wg) DW ..) = A
  // (64 x 64 ktiles, K-major image at `a`) times the ring's next ktiles
  // tiles, for nch chunks, each handed to epi(j, acc, bias) with this
  // thread's bias pairs, loaded while the chunk's products run
  auto product = [&](uint32_t a, int ktiles, int nch, const float* bias, auto&& epi) {
    float acc[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) acc[i] = 0.0f;
    for (int j = 0; j < nch; ++j) {
      float2 bv[DW / 8];
#pragma unroll
      for (int jj = 0; jj < DW / 8; ++jj) bv[jj] = ld_nc_f2(bias + (2 * j + wg) * DW + 2 * t4 + 8 * jj);
      for (int kt = 0; kt < ktiles; ++kt, g += 2) {
        const int s = g % STAGES;
        mbar_wait(full + 8 * s, (g / STAGES) & 1);
        __syncwarp();
        const uint32_t ak = a + kt * TE_BOX, b = base + s * SLOT;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TE_BK / 16; ++kk)
          Wgmma<DW>::template mma<1>(acc, kmajor_desc(ak + 32 * kk, 128),
                                     mnmajor_desc(b + 2048 * kk, TE_BOX, 1024), (kt | kk) != 0);
        wgmma_commit();
        // the slot goes back as soon as its products are done: a warpgroup
        // holds one slot, the other warpgroup's products fill the gap
        wgmma_wait<0>();
        fence_regs(acc);
        release(s);
      }
      epi(j, acc, bv);
    }
  };
  // the bf16 values (acc + bias, relu'd or not) of chunk j into the image at
  // `dst`, columns (2 j + wg) DW ..
  auto store_chunk = [&](uint32_t dst, bool relu, int j, float (&acc)[NR], float2 (&bv)[DW / 8]) {
    uint32_t pk[DW / 4];
#pragma unroll
    for (int jj = 0; jj < DW / 8; ++jj) {
      const float2 b = bv[jj];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v0 = acc[4 * jj + 2 * hh] + b.x, v1 = acc[4 * jj + 2 * hh + 1] + b.y;
        if (relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        pk[2 * jj + hh] = pack_bf16x2(v0, v1);
      }
    }
    store_pairs<DW / 8>(base + dst, (2 * j + wg) * DW, pk);
  };
  // residual += acc + bias, in registers
  auto add_residual = [&](float (&acc)[NR], float2 (&bv)[DW / 8]) {
#pragma unroll
    for (int jj = 0; jj < DW / 8; ++jj) {
      const float2 b = bv[jj];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        res[4 * jj + 2 * hh] += acc[4 * jj + 2 * hh] + b.x;
        res[4 * jj + 2 * hh + 1] += acc[4 * jj + 2 * hh + 1] + b.y;
      }
    }
  };
  // LayerNorm of the residual's rows in place; writes the bf16 operand of
  // the next product. A row's sum: this thread's 2 DW / 8 values in column
  // order, the quad's four by xor shuffles (every lane the same bits), then
  // warpgroup 0's plus warpgroup 1's
  auto row_sums = [&](float (&v)[2], int pass) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      v[hh] += __shfl_xor_sync(0xffffffffu, v[hh], 1);
      v[hh] += __shfl_xor_sync(0xffffffffu, v[hh], 2);
      if (t4 == 0) red[(2 * pass + wg) * TE_ROWS + r0 + 8 * hh] = v[hh];
    }
    consumer_sync();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      v[hh] = red[2 * pass * TE_ROWS + r0 + 8 * hh] + red[(2 * pass + 1) * TE_ROWS + r0 + 8 * hh];
  };
  auto layer_norm = [&](const float* gm, const float* bt) {
    float2 sv[DW / 8], tv[DW / 8];  // scale and bias, loaded while the rows sum
#pragma unroll
    for (int jj = 0; jj < DW / 8; ++jj) {
      sv[jj] = ld_nc_f2(gm + c0 + 8 * jj);
      tv[jj] = ld_nc_f2(bt + c0 + 8 * jj);
    }
    float mu[2] = {0.0f, 0.0f}, var[2] = {0.0f, 0.0f};
#pragma unroll
    for (int jj = 0; jj < DW / 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) mu[hh] += res[4 * jj + 2 * hh] + res[4 * jj + 2 * hh + 1];
    row_sums(mu, 0);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) mu[hh] /= (float)D;
#pragma unroll
    for (int jj = 0; jj < DW / 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = res[4 * jj + 2 * hh + e] - mu[hh];
          var[hh] = fmaf(d, d, var[hh]);
        }
    row_sums(var, 1);
    float rs[2];
    uint32_t pk[DW / 4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) rs[hh] = 1.0f / sqrtf(var[hh] / (float)D + 1e-5f);
#pragma unroll
    for (int jj = 0; jj < DW / 8; ++jj) {
      const float2 s = sv[jj], b = tv[jj];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float y0 = (res[4 * jj + 2 * hh] - mu[hh]) * rs[hh] * s.x + b.x;
        const float y1 = (res[4 * jj + 2 * hh + 1] - mu[hh]) * rs[hh] * s.y + b.y;
        res[4 * jj + 2 * hh] = y0;
        res[4 * jj + 2 * hh + 1] = y1;
        pk[2 * jj + hh] = pack_bf16x2(y0, y1);
      }
    }
    store_pairs<DW / 8>(base + XB, wg * DW, pk);
  };

  const float scale = 0.125f;  // 1 / sqrt(64)
  for (int l = 0; l < NL; ++l) {
    const float* bqkv = p.bqkv + (size_t)l * 3 * D;
    const float* bo = p.bo + (size_t)l * D;
    const float* b1 = p.b1 + (size_t)l * FF;
    const float* b2 = p.b2 + (size_t)l * D;
    product(base + XB, D / TE_BK, 3, bqkv, [&](int j, float (&acc)[NR], float2 (&bv)[DW / 8]) {
      store_chunk(QB, false, j, acc, bv);
    });
    fence_async_shared();
    consumer_sync();  // q|k|v complete
    attention(base, QB, XB, D, p.NH, L, p.S, scale, wg, r0, t4);
    fence_async_shared();
    consumer_sync();  // the context complete
    product(base + XB, D / TE_BK, 1, bo,
            [&](int, float (&acc)[NR], float2 (&bv)[DW / 8]) { add_residual(acc, bv); });
    layer_norm(p.ln1s + (size_t)l * D, p.ln1b + (size_t)l * D);
    fence_async_shared();
    consumer_sync();  // LayerNorm 1's operand complete
    product(base + XB, D / TE_BK, FF / D, b1, [&](int j, float (&acc)[NR], float2 (&bv)[DW / 8]) {
      store_chunk(QB, true, j, acc, bv);
    });
    fence_async_shared();
    consumer_sync();  // the hidden layer complete
    product(base + QB, FF / TE_BK, 1, b2,
            [&](int, float (&acc)[NR], float2 (&bv)[DW / 8]) { add_residual(acc, bv); });
    layer_norm(p.ln2s + (size_t)l * D, p.ln2b + (size_t)l * D);
    fence_async_shared();
    consumer_sync();  // LayerNorm 2's operand complete
  }

  // the residual as f32 rows (stride D + 8) over q|k|v's place, then the
  // mean over each real sample's L rows, t ascending
  float* xf = reinterpret_cast<float*>(sm + QB);
#pragma unroll
  for (int jj = 0; jj < DW / 8; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(xf + (r0 + 8 * hh) * (D + 8) + c0 + 8 * jj) =
          make_float2(res[4 * jj + 2 * hh], res[4 * jj + 2 * hh + 1]);
  consumer_sync();
  for (int i = tid; i < p.S * D; i += TE_CONSUMERS) {
    const int s = i / D, c = i - s * D;
    if (n0 + s >= p.N) continue;
    float sum = 0.0f;
    for (int t = 0; t < L; ++t) sum += xf[(s * L + t) * (D + 8) + c];
    p.out[(size_t)(n0 + s) * D + c] = sum / (float)L;
  }
}

// the kernel of width D (128 or 256) with its shared memory raised to what
// (D, FF) takes, or null when that is more than a CTA may have
static const void* tc_setup(int D, int FF, cudaError_t* e) {
  const void* k = D == 256 ? (const void*)transenc_tc_kernel<128>
                           : (const void*)transenc_tc_kernel<64>;
  const size_t smem = transenc_tc_smem(D, FF);
  if (smem > 232448) return nullptr;
  *e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return k;
}

// the TMA map of a stacked weight, (rows, cols) bf16 row-major: boxes of 64
// columns by TE_BK k rows under the 128-byte swizzle
static CUresult weight_map(CUtensorMap* m, const void* w, int rows, int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, TE_BK};
  return bf16_tensor_map(m, w, 2, dims, strides, box);
}

extern "C" {

// All of x and the weights bf16 (16-byte aligned); biases, LayerNorm
// parameters and out f32. S samples per CTA (S * L <= 64). Returns 0 or a
// cudaError_t value.
int transenc_tc_launch(const void* x, void* out, const void* wqkv, const void* wo,
                       const void* w1, const void* w2, const void* bqkv, const void* bo,
                       const void* b1, const void* b2, const void* ln1s, const void* ln1b,
                       const void* ln2s, const void* ln2b, int N, int L, int D, int NH, int FF,
                       int NL, int S, void* stream, int device) {
  USE_DEVICE(device);
  if (N < 1 || L < 1 || L > TE_LMAX || S < 1 || S * L > TE_ROWS || (D != 128 && D != 256) ||
      FF < D || FF % D != 0 || NH < 1 || D != 64 * NH || NL < 1 ||
      (reinterpret_cast<uintptr_t>(wqkv) | reinterpret_cast<uintptr_t>(wo) |
       reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  const void* k = tc_setup(D, FF, &e);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  CUtensorMap maps[4];
  CUresult r = weight_map(&maps[0], wqkv, NL * D, 3 * D);
  if (r == CUDA_SUCCESS) r = weight_map(&maps[1], wo, NL * D, D);
  if (r == CUDA_SUCCESS) r = weight_map(&maps[2], w1, NL * D, FF);
  if (r == CUDA_SUCCESS) r = weight_map(&maps[3], w2, NL * FF, D);
  if (r != CUDA_SUCCESS)
    return r == CUDA_ERROR_NOT_SUPPORTED ? (int)cudaErrorNotSupported : (int)cudaErrorInvalidValue;
  EncTcParams p;
  p.x = static_cast<const bf16*>(x);
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
  void* args[5] = {&maps[0], &maps[1], &maps[2], &maps[3], &p};
  e = cudaLaunchKernel(k, dim3((N + S - 1) / S), dim3(TE_THREADS), args,
                       transenc_tc_smem(D, FF), static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many CTAs of the kernel at (D, FF) an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *ctas, and its
// shared memory a CTA into *smem_bytes. Launches nothing. Returns 0 or a
// cudaError_t value.
int transenc_tc_occupancy(int D, int FF, int* ctas, int* smem_bytes, int device) {
  USE_DEVICE(device);
  if (D != 128 && D != 256) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  const void* k = tc_setup(D, FF, &e);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  *smem_bytes = (int)transenc_tc_smem(D, FF);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, k, TE_THREADS,
                                                            transenc_tc_smem(D, FF));
}

}  // extern "C"
