// Alias-free SnakeBeta of BigVGAN's unfused stages for Hopper (sm_90a): K5.
//
// Replaces no Pallas kernel. The JAX package computes this activation as a
// plain jnp chain, audiolcm_tpu/nn/resample.py:212 alias_free_activation
// (its polyphase twin audiolcm_tpu/nn/resample_cf.py:42 alias_free_snake_cf),
// which XLA fuses on the TPU. Eager PyTorch runs the same chain as ~25
// kernels per activation (pads, grouped convs, the snake's elementwise ops in
// f32), each reading and writing the whole (B, C, 2T) signal: at the vocoder's
// wide stages that chain was most of a generate's device time. K5 is one
// launch per activation:
//
//   out (B, C, T) = down2x(snakebeta(up2x(x))), x (B, C, T) contiguous,
//
// with the edge rule of nn/resample_cf.py:alias_free_snake_cf: x read at
// clamp(t, 0, T-1) by the up-FIR, and the activated 2x signal replicated at
// its ends (ae[0] on the left, ao[T-1] on the right) before the down-FIR,
// which equals the depthwise-conv form.
//
// What bounds it on this card: x is read once and out written once, 2 + 2
// bytes per sample in bf16 (~37 us at 30.7 M samples and 3.35 TB/s). The
// arithmetic is longer: two 6-tap up-phases, two snakes with the
// polynomial cos, two 6-tap down-phases, ~60 instructions per sample in the
// SASS, nearly all f32 on the CUDA cores (nothing of it fits the tensor
// cores), ~57 us for the same samples at 1.98 GHz. So the design spends no
// instruction it can avoid and keeps enough warps resident to hide the
// loads:
//   * one block owns one row (b, c) and one time tile; each lane holds a run
//     of RUN = 16 consecutive samples in registers and computes both snaked
//     up-phases of its run once: no snake is computed twice, except in the
//     block's two border lanes, which only supply halos (the tile is chosen
//     from T alone, pick_tile in nn/alias_free_act.py, so that these and the
//     lanes of a ragged tile are a few percent of the block);
//   * x comes in 16-byte loads (the ±3-sample halo of the up-phases in two
//     8- or 16-byte loads of the neighbours' runs, which the L1 holds), and
//     out leaves in 16-byte stores; rows of other lengths, and the lanes at
//     the row's ends, take element loads at clamped positions;
//   * the down-FIR's halo, 5 snaked samples on each side, comes from the
//     neighbour lanes through 40 bytes of shared memory per lane and the
//     block's one __syncthreads;
//   * FIR taps are compile-time constants (immediates); 2 * alpha and
//     0.5 / (beta + 1e-9) are formed once per thread, in f32, from the
//     module's own parameters (bf16 or f32, log-scale or linear), so that
//     one activation is one launch with no exp, cat or cast kernel around it;
//   * f32 inside, one rounding to the output type;
//   * at most 64 registers a thread, four blocks per SM. Blocks that loop
//     over tiles with the next tile's loads in flight needed ~125 registers
//     and ran slower (PERF.md).
//
// Plain C interface, loaded with ctypes (audiolcm_torch/nn/alias_free_act.py).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libalias_free_act.so alias_free_act.cu

#include <climits>
#include <cstdint>

#include "snake_act.cuh"

// These must match nn/alias_free_act.py.
#define RUN 16        // samples per lane
#define MAX_WARPS 8   // warps per block at most
#define MAX_LANES (32 * MAX_WARPS)

// nn/resample.py:alias_free_taps() in float32 (exact: the filter is float32,
// the up taps twice it). ue[j] = sum_d UP_E(d) x[j+d-3], uo[j] = sum_d
// UP_O(d) x[j+d-2]; y[t] = sum_d DN_E(d) ao[t+d-3] + DN_O(d) ae[t+d-2].
__device__ __forceinline__ constexpr float UP_E(int d) {
  return d == 0 ? 4.057933111e-03f : d == 1 ? -5.108692870e-02f : d == 2 ? 2.571452260e-01f
       : d == 3 ? 8.864195943e-01f : d == 4 ? -1.153147519e-01f : 1.877892762e-02f;
}
__device__ __forceinline__ constexpr float UP_O(int d) {
  return d == 0 ? 1.877892762e-02f : d == 1 ? -1.153147519e-01f : d == 2 ? 8.864195943e-01f
       : d == 3 ? 2.571452260e-01f : d == 4 ? -5.108692870e-02f : 4.057933111e-03f;
}
__device__ __forceinline__ constexpr float DN_E(int d) {
  return d == 0 ? 2.028966555e-03f : d == 1 ? -2.554346435e-02f : d == 2 ? 1.285726130e-01f
       : d == 3 ? 4.432097971e-01f : d == 4 ? -5.765737593e-02f : 9.389463812e-03f;
}
__device__ __forceinline__ constexpr float DN_O(int d) {
  return d == 0 ? 9.389463812e-03f : d == 1 ? -5.765737593e-02f : d == 2 ? 4.432097971e-01f
       : d == 3 ? 1.285726130e-01f : d == 4 ? -2.554346435e-02f : 2.028966555e-03f;
}

struct ActArgs {
  const void* x;        // (rows, T) contiguous, rows = B * C
  void* out;            // the same shape and type
  const void* alpha;    // (C,), in the parameter type
  const void* beta;     // (C,); Snake passes alpha again
  int C, T, tile, nblk;  // time tile (a multiple of RUN), tiles per row
  int logscale, param_bf16, vec;  // vec: 16-byte rows, x and out aligned
};

__device__ __forceinline__ float2 bf2(unsigned int w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// s[k] = x[p - 3 + k], k = 0 .. RUN + 5, for an interior run: p >= 4,
// p + RUN + 4 <= T, p a multiple of RUN, the row 16-byte aligned. The run in
// 16-byte loads, the 3 samples on each side in one 8- (bf16) or 16-byte load.
__device__ __forceinline__ void load_run(const __nv_bfloat16* row, int p, float s[RUN + 6]) {
  const uint2 lo = __ldg(reinterpret_cast<const uint2*>(row + p - 4));
  uint4 m[RUN / 8];
#pragma unroll
  for (int q = 0; q < RUN / 8; ++q) m[q] = __ldg(reinterpret_cast<const uint4*>(row + p) + q);
  const uint2 hi = __ldg(reinterpret_cast<const uint2*>(row + p + RUN));
  float2 f = bf2(lo.x);
  s[0] = f.y;
  f = bf2(lo.y); s[1] = f.x; s[2] = f.y;
#pragma unroll
  for (int q = 0; q < RUN / 8; ++q) {
    const unsigned int w[4] = {m[q].x, m[q].y, m[q].z, m[q].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f = bf2(w[i]);
      s[3 + 8 * q + 2 * i] = f.x;
      s[4 + 8 * q + 2 * i] = f.y;
    }
  }
  f = bf2(hi.x); s[RUN + 3] = f.x; s[RUN + 4] = f.y;
  f = bf2(hi.y); s[RUN + 5] = f.x;
}
__device__ __forceinline__ void load_run(const float* row, int p, float s[RUN + 6]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(row + p - 4));
  s[0] = lo.y; s[1] = lo.z; s[2] = lo.w;
#pragma unroll
  for (int q = 0; q < RUN / 4; ++q) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + p) + q);
    s[3 + 4 * q] = v.x; s[4 + 4 * q] = v.y; s[5 + 4 * q] = v.z; s[6 + 4 * q] = v.w;
  }
  const float4 hi = __ldg(reinterpret_cast<const float4*>(row + p + RUN));
  s[RUN + 3] = hi.x; s[RUN + 4] = hi.y; s[RUN + 5] = hi.z;
}

// out[p .. p + RUN) = y, 16-byte stores
__device__ __forceinline__ void store_run(__nv_bfloat16* row, int p, const float y[RUN]) {
#pragma unroll
  for (int q = 0; q < RUN / 8; ++q) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(y[8 * q + 2 * i], y[8 * q + 2 * i + 1]);
    reinterpret_cast<uint4*>(row + p)[q] = v;
  }
}
__device__ __forceinline__ void store_run(float* row, int p, const float y[RUN]) {
  float4* o = reinterpret_cast<float4*>(row + p);
#pragma unroll
  for (int q = 0; q < RUN / 4; ++q) o[q] = make_float4(y[4 * q], y[4 * q + 1], y[4 * q + 2], y[4 * q + 3]);
}

__device__ __forceinline__ float param_f(const void* v, int i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(v)[i])
                 : static_cast<const float*>(v)[i];
}

// At most 64 registers a thread (no spills): four blocks of MAX_LANES per SM,
// the occupancy that hid the loads best of 2, 3 and 4 blocks (PERF.md).
template <typename IO, bool FAST>
__global__ void __launch_bounds__(MAX_LANES, 4) alias_free_act_kernel(ActArgs a) {
  // what each lane hands its neighbours: its first snaked samples
  // (o0, o1, e0, e1 | e2) and its last (o13, o14, o15, e14 | e15)
  __shared__ float4 head[MAX_LANES], tail[MAX_LANES];
  __shared__ float2 mid[MAX_LANES];  // (e2, e15)
  __shared__ float edge[2];          // ae[0], ao[T-1] of the row, where the block holds them

  const int T = a.T, R = a.tile / RUN;
  const int row_i = blockIdx.x / a.nblk, t0 = (blockIdx.x % a.nblk) * a.tile;
  const int c = row_i % a.C;
  const int l = threadIdx.x;
  // lane l holds samples [p, p + RUN); lanes 1..R are the tile, lanes 0 and
  // R + 1 supply halos only
  const int p = t0 + (l - 1) * RUN;
  const bool live = l <= R + 1;
  const IO* xrow = static_cast<const IO*>(a.x) + (size_t)row_i * T;

  float e[RUN], o[RUN];
  if (live) {
    float al = param_f(a.alpha, c, a.param_bf16), be = param_f(a.beta, c, a.param_bf16);
    if (a.logscale) {
      al = expf(al);
      be = expf(be);
    }
    const float al2 = 2.0f * al, hb = 0.5f * (1.0f / (be + 1e-9f));
    float s[RUN + 6];
    if (a.vec && p >= 4 && p + RUN + 4 <= T) {
      load_run(xrow, p, s);
    } else {
#pragma unroll
      for (int k = 0; k < RUN + 6; ++k) s[k] = load_f<IO>(xrow + clampi(p - 3 + k, 0, T - 1));
    }
#pragma unroll
    for (int i = 0; i < RUN; ++i) {
      float ue = 0.f, uo = 0.f;
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        ue = fmaf(UP_E(d), s[i + d], ue);
        uo = fmaf(UP_O(d), s[i + d + 1], uo);
      }
      e[i] = snake_hb<FAST>(ue, al2, hb);
      o[i] = snake_hb<FAST>(uo, al2, hb);
    }
    head[l] = make_float4(o[0], o[1], e[0], e[1]);
    tail[l] = make_float4(o[RUN - 3], o[RUN - 2], o[RUN - 1], e[RUN - 2]);
    mid[l] = make_float2(e[2], e[RUN - 1]);
    if (p == 0) edge[0] = e[0];
    if (p <= T - 1 && T - 1 < p + RUN) {
      float v = o[0];
#pragma unroll
      for (int i = 1; i < RUN; ++i) v = (T - 1 - p == i) ? o[i] : v;
      edge[1] = v;
    }
  }
  __syncthreads();
  if (l < 1 || l > R || p >= T) return;

  // ow[m] = ao at p - 3 + m, ew[m] = ae at p - 2 + m, m = 0 .. RUN + 4
  float ow[RUN + 5], ew[RUN + 5];
  const float4 lt = tail[l - 1], rh = head[l + 1];
  const float2 lm = mid[l - 1], rm = mid[l + 1];
  ow[0] = lt.x; ow[1] = lt.y; ow[2] = lt.z;
  ew[0] = lt.w; ew[1] = lm.y;
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    ow[3 + i] = o[i];
    ew[2 + i] = e[i];
  }
  ow[RUN + 3] = rh.x; ow[RUN + 4] = rh.y;
  ew[RUN + 2] = rh.z; ew[RUN + 3] = rh.w; ew[RUN + 4] = rm.x;
  if (p < 3 || p + RUN + 2 >= T) {  // the row's ends: the activated signal replicated
    const float ae0 = edge[0], aol = edge[1];
#pragma unroll
    for (int m = 0; m < RUN + 5; ++m) {
      const int po = p - 3 + m, pe = p - 2 + m;
      ow[m] = po < 0 ? ae0 : (po >= T ? aol : ow[m]);
      ew[m] = pe < 0 ? ae0 : (pe >= T ? aol : ew[m]);
    }
  }
  float y[RUN];
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    float ye = 0.f, yo = 0.f;
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      ye = fmaf(DN_E(d), ow[i + d], ye);
      yo = fmaf(DN_O(d), ew[i + d], yo);
    }
    y[i] = ye + yo;
  }
  IO* orow = static_cast<IO*>(a.out) + (size_t)row_i * T;
  if (a.vec && p + RUN <= T) {
    store_run(orow, p, y);
  } else {
#pragma unroll
    for (int i = 0; i < RUN; ++i)
      if (p + i < T) store_f<IO>(orow + p + i, y[i]);
  }
}

template <typename IO, bool FAST>
static int launch(const ActArgs& a, int rows, cudaStream_t stream) {
  const int lanes = a.tile / RUN + 2;
  dim3 grid(rows * a.nblk), block(32 * ((lanes + 31) / 32));
  alias_free_act_kernel<IO, FAST><<<grid, block, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// Returns the CUDA error code of the launch (0 = launched).
// rows = B * C; tile: the time tile, a multiple of RUN with tile / RUN + 2
// lanes at most MAX_LANES.
extern "C" int alias_free_act_launch(const void* x, void* out, const void* alpha,
                                     const void* beta, int rows, int C, int T, int tile,
                                     int logscale, int param_bf16, int fast, int is_bf16,
                                     void* stream) {
  if (rows < 1 || C < 1 || rows % C || T < 1 || tile < RUN || tile % RUN
      || tile / RUN + 2 > MAX_LANES)
    return (int)cudaErrorInvalidValue;
  ActArgs a;
  a.x = x; a.out = out; a.alpha = alpha; a.beta = beta;
  a.C = C; a.T = T; a.tile = tile;
  a.nblk = (T + tile - 1) / tile;
  if ((long long)rows * a.nblk > INT_MAX) return (int)cudaErrorInvalidValue;
  a.logscale = logscale;
  a.param_bf16 = param_bf16;
  const long long row_bytes = (long long)T * (is_bf16 ? 2 : 4);
  a.vec = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0
          && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return fast ? launch<__nv_bfloat16, true>(a, rows, s) : launch<__nv_bfloat16, false>(a, rows, s);
  return fast ? launch<float, true>(a, rows, s) : launch<float, false>(a, rows, s);
}
