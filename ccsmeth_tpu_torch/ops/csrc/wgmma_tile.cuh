// Hopper's own tensor-core path, shared by the bf16 kernels that run on it
// (birnn_tc.cu: K1's and K2's recurrence and projection; rnn_train_gemm.cuh:
// the backward products of K5 and K6; transenc_tc.cu: K3's encoder) and the
// mbarrier, bulk-copy and st.async primitives of the cluster recurrences
// (birnn_tc.cu, birnn_simt.cu, rnn_train_rec.cuh's simt backward).
//
// wgmma (warpgroup matrix multiply): the 128 threads of a warpgroup issue
// wgmma.mma_async.m64nNk16 together: D (64 x N, f32, in registers) += A (64 x
// 16, bf16) B (16 x N, bf16), both read from shared memory through 64-bit
// descriptors. Accumulator register i of thread t (warp w = t / 32 of the
// warpgroup, g = lane / 4, t4 = lane % 4) holds row 16 w + g + 8 ((i / 2) % 2)
// and column 8 (i / 4) + 2 t4 + i % 2.
//
// Operand layouts in shared memory, as the descriptors encode them:
//   K-major (A, and B stored one row per column of B): rows of WB bytes (WB
//   = 32, 64 or 128: 16, 32 or 64 bf16 of k), in atoms of 8 rows (8 WB
//   bytes, aligned to 8 WB), atoms of consecutive rows contiguous; the
//   16-byte chunk c of row r lies at chunk c ^ s(r), s(r) = r % 8 (WB 128),
//   (r / 2) % 4 (64), (r / 4) % 2 (32): the 128-, 64- and 32-byte swizzles,
//   which TMA's CU_TENSOR_MAP_SWIZZLE_* produce. The descriptor holds the
//   start address, SBO = 8 WB (one atom) and the swizzle mode; a k16 step
//   inside a row adds 32 bytes to the start. A k extent above 64 is held as
//   K blocks of 64, each its own set of atoms.
//   MN-major (B of the projection, B (K x N) as stored, N contiguous): the
//   128-byte swizzle with rows along k: k row j of an N atom (64 columns) at
//   128 j bytes; SBO = the stride of 8 k rows (1024 bytes), LBO = the stride
//   of N atoms; transposed by the instruction's trans-b flag.
//
// Build: sm_90a (nvcc -gencode arch=compute_90a,code=sm_90a): wgmma exists
// only there.

#pragma once

#include <cuda.h>

#include "mma_tile.cuh"

// ---- mbarriers, bulk copies, TMA

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// this thread's arrival, announcing `bytes` of bulk copies into the phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// this thread's arrival on a barrier of its own CTA
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cta.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// an arrival on the barrier at the same offset in the cluster's CTA `rank`
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

// wait for the phase of parity `parity` to complete; a wait that never ends
// (a broken protocol) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1u << 24)) __trap();
  }
}

// `bytes` of this CTA's shared memory at `src` to the same offset in CTA
// `rank`, completing on that CTA's barrier at offset `bar`
__device__ __forceinline__ void bulk_to_peer(uint32_t src, uint32_t bytes, uint32_t bar,
                                             uint32_t rank) {
  uint32_t dst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(dst) : "r"(src), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(bar), "r"(rank));
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(rbar)
      : "memory");
}

// a 16-byte store to the shared memory of the cluster's CTA `rank`, at the
// offset of `local_addr` there, whose 16 bytes complete on that CTA's
// barrier at the offset of `bar` (st.async: no fence; the barrier's phase
// counts the bytes, as a bulk copy's)
__device__ __forceinline__ void st_async_v4(uint32_t local_addr, uint32_t bar, uint32_t rank,
                                            uint4 v) {
  uint32_t dst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(dst) : "r"(local_addr), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(bar), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(dst),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(rbar)
      : "memory");
}

// a TMA load of the box at (c0, c1) of a 2-d tensor map into shared memory
// at `dst`, completing on barrier `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// a TMA load of the box at (c0, c1, c2) of a 3-d tensor map into shared
// memory at `dst`, completing on barrier `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// a 16-byte read-only global load issued exactly here (as mma_tile.cuh's
// ld_nc_f2)
__device__ __forceinline__ float4 ld_nc_f4(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// the 128-byte line at p into L2
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// a 16-byte store to shared memory at `addr`
__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// generic-proxy writes to shared memory before this point are visible to
// the async proxy (wgmma operands, bulk copies) after a barrier
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- tensor maps (host)

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry-point
// query (the libraries do not link libcuda)
static inline EncodeTiledFn encode_tiled() {
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

// The TMA map of a bf16 tensor of `rank` (2 or 3) dimensions, innermost
// first: dims in elements, the outer dimensions' strides in bytes (multiples
// of 16, as the base address), boxes of `box` elements written under the
// 128-byte swizzle; a box's elements outside the tensor (negative
// coordinates too) arrive as zeros. CUDA_ERROR_NOT_SUPPORTED when libcuda's
// encoder is missing.
static inline CUresult bf16_tensor_map(CUtensorMap* map, const void* p, int rank,
                                       const cuuint64_t* dims, const cuuint64_t* strides,
                                       const cuuint32_t* box) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_SUPPORTED;
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(p),
                dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// ---- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the accumulators are written here as far as the compiler knows: keeps
// their reads after a wgmma_wait and their writes before a wgmma_fence
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// byte offset of (row, byte kb of the row) in a K-major operand of WB-byte
// rows (the swizzles above)
__device__ __forceinline__ uint32_t kmajor_off(int row, int kb, int wb) {
  const int s = wb == 128 ? (row & 7) : wb == 64 ? ((row >> 1) & 3) : ((row >> 2) & 1);
  return (uint32_t)((row >> 3) * 8 * wb + (row & 7) * wb + ((((kb >> 4) ^ s) << 4) | (kb & 15)));
}

// a K-major descriptor: start address, SBO one atom of 8 rows, the swizzle of
// WB-byte rows
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, int wb) {
  const uint64_t mode = wb == 128 ? 1 : wb == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * wb) >> 4) << 32) | (mode << 62);
}

// an MN-major descriptor with the 128-byte swizzle: LBO and SBO in bytes
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

// d (64 x N) += A B: wgmma.mma_async.m64nNk16, bf16 operands, f32 sums;
// scale_d = 0 starts from zero; TB = 1: B is MN-major; TA = 1: A is
// MN-major (A^T stored K x 64, M contiguous, one 64-column atom, read by the
// same descriptor form as B's)
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  template <int TB, int TA = 0>
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, %12, %11;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB), "n"(TA));
  }
};

template <>
struct Wgmma<32> {
  template <int TB, int TA = 0>
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %20, %19;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB), "n"(TA));
  }
};

template <>
struct Wgmma<48> {
  template <int TB, int TA = 0>
  __device__ __forceinline__ static void mma(float (&d)[24], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %26, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, %28, %27;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB), "n"(TA));
  }
};

template <>
struct Wgmma<64> {
  template <int TB, int TA = 0>
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %36, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB), "n"(TA));
  }
};

template <>
struct Wgmma<96> {
  template <int TB, int TA = 0>
  __device__ __forceinline__ static void mma(float (&d)[48], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %50, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, %52, %51;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB), "n"(TA));
  }
};

template <>
struct Wgmma<128> {
  template <int TB, int TA = 0>
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %68, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB), "n"(TA));
  }
};
