// Device helpers shared by the AMP stage (amp_stage.cu, K1), the activation
// chain (act_chain.cu, K4) and the alias-free activation (alias_free_act.cu,
// K5): the polynomial cos and the SnakeBeta nonlinearity (also with its
// per-channel factors made once, snake_hb), and the element loads and
// stores in an I/O type. The kernels compute in f32 and round once to the
// I/O type.
//
// audiolcm_torch/build.py hashes this header into every library's name, so
// an edited header rebuilds every kernel that includes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

template <typename IO> __device__ __forceinline__ float load_f(const IO* p);
template <> __device__ __forceinline__ float load_f<float>(const float* p) { return *p; }
template <> __device__ __forceinline__ float load_f<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <typename IO> __device__ __forceinline__ void store_f(IO* p, float v);
template <> __device__ __forceinline__ void store_f<float>(float* p, float v) { *p = v; }
template <> __device__ __forceinline__ void store_f<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Range-reduced even polynomial for cos (audiolcm_torch/nn/snake.py:fast_cos).
__device__ __forceinline__ float fast_cos(float v) {
  const float k = rintf(v * 0.15915494309189535f);
  const float xr = (v - k * 6.28125f) - k * 0.0019353071795864769f;
  const float u = xr * xr;
  float acc = 1.7369116668414461e-09f;
  acc = acc * u + -2.7113368760900975e-07f;
  acc = acc * u + 2.4773423751927707e-05f;
  acc = acc * u + -0.0013887970390010532f;
  acc = acc * u + 0.04166652435962621f;
  acc = acc * u + -0.4999999177184745f;
  acc = acc * u + 0.9999999922819011f;
  return acc;
}

// SnakeBeta with binv = 1/(beta+1e-9): h + 0.5*(1 - cos(2*alpha*h)) * binv.
__device__ __forceinline__ float snake(float h, float alpha, float binv, int fast) {
  const float arg = (2.0f * alpha) * h;
  const float c = fast ? fast_cos(arg) : cosf(arg);
  return h + 0.5f * (1.0f - c) * binv;
}

// snake() with its per-channel factors made once: al2 = 2 * alpha,
// hb = 0.5 * binv. Scaling by 0.5 is exact, so (1 - c) * hb equals
// 0.5 * (1 - c) * binv bit for bit.
template <bool FAST>
__device__ __forceinline__ float snake_hb(float h, float al2, float hb) {
  const float arg = al2 * h;
  const float c = FAST ? fast_cos(arg) : cosf(arg);
  return h + (1.0f - c) * hb;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }
