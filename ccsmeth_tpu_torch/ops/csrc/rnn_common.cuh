// Device helpers shared by the RNN kernels: bigru_stack.cu (K1's and K2's
// l2 design, GRU and LSTM cells) and, for Op<T> and sigmoid_f, the training
// kernels bigru_train.cu (K4, K5) and bilstm_train.cu (K6) and K1's and K2's
// simt design birnn_simt.cu through rnn_train_gemm.cuh.
//
// Operand types: T is float or __nv_bfloat16. Values are widened to f32 for
// every FMA, so products of bf16 operands are exact and sums accumulate in
// f32; Op<T>::operand rounds an f32 value to the operand type (the h operand
// of a recurrent product, a gradient operand of a backward product).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BIGRU_THREADS 256

template <typename T>
struct Op;

template <>
struct Op<float> {
  static __device__ __forceinline__ void load4(const float* p, float w[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
  static __device__ __forceinline__ void store4(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
  static __device__ __forceinline__ float operand(float v) { return v; }
};

template <>
struct Op<__nv_bfloat16> {
  static __device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                               float w[4]) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = __uint_as_float(v.x << 16);
    w[1] = __uint_as_float(v.x & 0xffff0000u);
    w[2] = __uint_as_float(v.y << 16);
    w[3] = __uint_as_float(v.y & 0xffff0000u);
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p,
                                                const float v[4]) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float operand(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// R consecutive f32 values from shared memory (16-byte aligned when R % 4 == 0)
template <int R>
__device__ __forceinline__ void load_rows(const float* p, float v[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else if constexpr (R == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = p[i];
  }
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The gate sums of one GRU step for one thread's R rows (rr0 ..) and four
// hidden units (j0 ..): the input projection x_t @ W_ih and the recurrent
// product h @ W_hh, read from k-major shared tiles (xs [Cin][Bt] and
// hs [H][Bt], f32) and from W_ih (Cin, 3H) / W_hh (H, 3H) in L2. On entry the
// four sums hold their biases: ar = b_ir + b_hr, az = b_iz + b_hz, axn = b_in,
// ahn = b_hn. On return ahn is hg_n, the recurrent part of n (b_hn stays
// inside the reset product, as in torch). The h operand is rounded to T.
template <typename T, int R>
__device__ __forceinline__ void gru_gate_sums(
    const float* xs, int Cin, const float* hs, int H, int Bt, int rr0, int j0,
    const T* Wih, const T* Whh, float (&ar)[R][4], float (&az)[R][4],
    float (&axn)[R][4], float (&ahn)[R][4]) {
  const int G = 3 * H;
#pragma unroll 2
  for (int k = 0; k < Cin; ++k) {
    float wr[4], wz[4], wn[4], xv[R];
    const T* wk = Wih + (size_t)k * G + j0;
    Op<T>::load4(wk, wr);
    Op<T>::load4(wk + H, wz);
    Op<T>::load4(wk + 2 * H, wn);
    load_rows<R>(xs + k * Bt + rr0, xv);
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ar[r][j] = fmaf(xv[r], wr[j], ar[r][j]);
        az[r][j] = fmaf(xv[r], wz[j], az[r][j]);
        axn[r][j] = fmaf(xv[r], wn[j], axn[r][j]);
      }
    }
  }
#pragma unroll 2
  for (int k = 0; k < H; ++k) {
    float wr[4], wz[4], wn[4], hv[R];
    const T* wk = Whh + (size_t)k * G + j0;
    Op<T>::load4(wk, wr);
    Op<T>::load4(wk + H, wz);
    Op<T>::load4(wk + 2 * H, wn);
    load_rows<R>(hs + k * Bt + rr0, hv);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float h = Op<T>::operand(hv[r]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ar[r][j] = fmaf(h, wr[j], ar[r][j]);
        az[r][j] = fmaf(h, wz[j], az[r][j]);
        ahn[r][j] = fmaf(h, wn[j], ahn[r][j]);
      }
    }
  }
}

// The gate sums of one LSTM step for one thread's R rows (rr0 ..) and four
// hidden units (j0 ..), as gru_gate_sums: the input projection x_t @ W_ih and
// the recurrent product h @ W_hh, W_ih (Cin, 4H) / W_hh (H, 4H), gate order
// i, f, g, o. On entry each sum holds its bias b_ih + b_hh; on return it holds
// the whole pre-activation. The h operand is rounded to T.
template <typename T, int R>
__device__ __forceinline__ void lstm_gate_sums(
    const float* xs, int Cin, const float* hs, int H, int Bt, int rr0, int j0,
    const T* Wih, const T* Whh, float (&ai)[R][4], float (&af)[R][4],
    float (&ag)[R][4], float (&ao)[R][4]) {
  const int G = 4 * H;
#pragma unroll 2
  for (int k = 0; k < Cin; ++k) {
    float wi[4], wf[4], wg[4], wo[4], xv[R];
    const T* wk = Wih + (size_t)k * G + j0;
    Op<T>::load4(wk, wi);
    Op<T>::load4(wk + H, wf);
    Op<T>::load4(wk + 2 * H, wg);
    Op<T>::load4(wk + 3 * H, wo);
    load_rows<R>(xs + k * Bt + rr0, xv);
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ai[r][j] = fmaf(xv[r], wi[j], ai[r][j]);
        af[r][j] = fmaf(xv[r], wf[j], af[r][j]);
        ag[r][j] = fmaf(xv[r], wg[j], ag[r][j]);
        ao[r][j] = fmaf(xv[r], wo[j], ao[r][j]);
      }
    }
  }
#pragma unroll 2
  for (int k = 0; k < H; ++k) {
    float wi[4], wf[4], wg[4], wo[4], hv[R];
    const T* wk = Whh + (size_t)k * G + j0;
    Op<T>::load4(wk, wi);
    Op<T>::load4(wk + H, wf);
    Op<T>::load4(wk + 2 * H, wg);
    Op<T>::load4(wk + 3 * H, wo);
    load_rows<R>(hs + k * Bt + rr0, hv);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float h = Op<T>::operand(hv[r]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ai[r][j] = fmaf(h, wi[j], ai[r][j]);
        af[r][j] = fmaf(h, wf[j], af[r][j]);
        ag[r][j] = fmaf(h, wg[j], ag[r][j]);
        ao[r][j] = fmaf(h, wo[j], ao[r][j]);
      }
    }
  }
}

// One LSTM cell update from its pre-activations (f32): i, f, o sigmoid, g
// tanh, c' = f c + i g, h' = o tanh(c'). Writes the four activations back
// into the argument slots and returns h'; c is updated in place.
__device__ __forceinline__ float lstm_update(float& i, float& f, float& g,
                                             float& o, float& c) {
  i = sigmoid_f(i);
  f = sigmoid_f(f);
  g = tanhf(g);
  o = sigmoid_f(o);
  c = f * c + i * g;
  return o * tanhf(c);
}
