// Tensor-core and copy primitives shared by the bf16 kernels that run on
// Hopper's tensor cores: birnn_tc.cu (K1, bf16) and transenc_tc.cu (K3, bf16).
//
// mma.sync.m16n8k16 (bf16 x bf16 -> f32) fragments, as PTX defines them, for
// lane = 4 g + t (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 (row g, k 2t..2t+1), a1 (row g+8, k 2t..),
//     a2 (row g, k 2t+8..), a3 (row g+8, k 2t+8..);
//   B (16 x 8): b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g);
//   C (16 x 8, f32): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, ..).
// ldmatrix fills them from shared memory: x4 on a [row][k] tile gives A,
// x2 on a [col][k] tile gives B, x4.trans on a [k][col] tile gives B for two
// 8-column tiles. Every row address is 16-byte aligned; a row stride of
// (width + 8) bf16 puts the 8 rows of a matrix in 8 different bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a b, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared without registers; valid == false fills zeros
// (src must still be a mapped address)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// an 8-byte read-only global load issued exactly here: volatile asm keeps
// its place among the other asm statements (the mma and ldmatrix ones), so
// the load flies while they run instead of sinking to its first use
__device__ __forceinline__ float2 ld_nc_f2(const float* p) {
  float2 v;
  asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "l"(p));
  return v;
}

// two f32 values rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// ---- thread-block clusters (distributed shared memory)

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// the cluster barrier in two halves: writes before arrive (local and remote
// shared memory) are visible to every thread of the cluster after its wait
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync_all() {
  cluster_arrive_release();
  cluster_wait_acquire();
}

// a 16-byte store to the same shared-memory offset (16-byte aligned) in
// the cluster's CTA `rank`
__device__ __forceinline__ void st_cluster_v4(uint32_t local_addr,
                                              uint32_t rank, uint4 v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local_addr), "r"(rank));
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(remote),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// the four values of lanes 4q .. 4q+3 (q = lane / 4), in lane order, in every
// one of those lanes
__device__ __forceinline__ uint4 quad_gather(uint32_t v) {
  const int base = (threadIdx.x & 31) & ~3;
  uint4 r;
  r.x = __shfl_sync(0xffffffffu, v, base);
  r.y = __shfl_sync(0xffffffffu, v, base + 1);
  r.z = __shfl_sync(0xffffffffu, v, base + 2);
  r.w = __shfl_sync(0xffffffffu, v, base + 3);
  return r;
}
