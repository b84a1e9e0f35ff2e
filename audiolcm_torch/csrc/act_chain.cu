// Chain of alias-free SnakeBeta activations for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/profile_stage_interior.py:110 act_only_fn,
// the profiling micro-kernel that times one alias-free SnakeBeta unit (2x
// up-FIR -> snake -> 2x down-FIR) of the fused AMP stage alone: n_rep
// chained "valid" activations on the edge-padded input, centre columns
// written out. out (B, C, T) = n_rep activations of x (B, T, C) with x read
// at clamp(t, 0, T-1), which is the JAX tool's mode="edge" pad.
//
// What bounds it on this card: by the published peaks, bytes (B*C*T
// elements read once and written once; ~78 FLOP per sample and activation
// is far below the bf16 tensor-core ridge). But the snake's polynomial cos
// and the 6-tap FIRs cannot use the tensor cores, so the floor that this
// f32 chain can reach is its arithmetic on the CUDA cores: ~53 f32
// instructions per output and activation at 67 TFLOP/s, about 8x the bytes
// bound at n_rep 2 and 20x at n_rep 6. One thread per output with both
// FIRs read from shared memory would spend several times that arithmetic
// on the shared-memory port (~29 accesses per output and activation
// against 32 words a clock for 128 lanes), on index division and on
// block-wide syncs.
//
// What the design does about it:
//   * a block owns ACT_CG = 8 channels of one (batch element, time tile)
//     and one warp per channel runs the chain; the window, tile + 2 * M
//     samples (M = 6 * n_rep rounded up to 16), is read once with clamped
//     global reads, 16 bytes per time sample (8 channels) when x is
//     channels-last and aligned, all of a thread's loads in flight at
//     once, and transposed into one f32 row per channel in shared memory;
//   * each lane holds a run of RUN = 16 consecutive samples of its channel
//     in registers: per activation it reads its run with four 16-byte
//     loads, takes the 3-sample halos of the signal and of the two snaked
//     up-phases from its neighbour lanes by shuffle (no snake is computed
//     twice within a warp), and writes its 16 outputs back with four
//     16-byte stores: about half a shared-memory access per output;
//   * a warp covers 32 runs and writes the 30 inner ones: lanes 0 and 31
//     only supply halos, so the edge lanes need no extra code and the
//     recompute is 32/30. The row is updated in place, chunk by chunk; the
//     one run that a chunk overwrites before the next chunk reads it (lane
//     30's, the next chunk's lane 0) is handed over in registers;
//   * runs sit RUN_PITCH = 20 floats apart, so the 8 lanes of a 16-byte
//     shared access hit 8 different bank groups;
//   * the only block-wide sync is after the load: a warp's chain touches
//     its own row alone, so activations are separated by __syncwarp. Every
//     activation runs over the whole window; the samples within 6 per
//     activation of the window's ends go wrong and never reach the centre;
//   * no integer division per element: 2 * alpha and 0.5 / (beta + 1e-9)
//     are made once per warp, and every index is a shift, a mask or a loop
//     counter;
//   * f32 inside, one rounding to the output type; the centre is stored 16
//     bytes per lane when T allows it, and a ragged last tile is masked.
//
// Plain C interface, loaded with ctypes (audiolcm_torch/nn/act_chain.py).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libact_chain.so act_chain.cu

#include <cstdint>

#include "snake_act.cuh"

// These must match nn/act_chain.py.
#define NTHREADS 256
#define ACT_CG 8       // channels per block, one warp each
#define RUN 16         // samples per lane
#define RUN_PITCH 20   // floats between runs in shared memory
#define RUNS_OUT 30    // runs a warp writes per chunk (lanes 1..30)
#define CHUNK (RUNS_OUT * RUN)
#define LOADS 8        // time samples a thread loads at once: 8 x 256 >= the 1920-sample window
#define FULL 0xffffffffu

struct ChainArgs {
  const void* x;         // (B, T, C) with element strides sb, st, sc
  void* out;             // (B, C, T) contiguous, same type
  const float* vec;      // alpha[C], then beta[C]
  long long sb, st, sc;
  int C, T, L, M;        // tile, window margin
  int chunks, nrep;      // window = chunks * CHUNK = L + 2 * M samples
  int vec_in, vec_out;   // 16-byte loads of 8 channels; 16-byte stores of 8 samples
  float up_e[6], up_o[6], dn_e[6], dn_o[6];
};

// the word of window sample p in its channel's row (run -1 is a margin)
__device__ __forceinline__ int row_word(int p) { return ((p >> 4) + 1) * RUN_PITCH + (p & 15); }

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, float4 a, float4 b) {
  reinterpret_cast<float4*>(p)[0] = a;
  reinterpret_cast<float4*>(p)[1] = b;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, float4 a, float4 b) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
  h[0] = __floats2bfloat162_rn(a.x, a.y);
  h[1] = __floats2bfloat162_rn(a.z, a.w);
  h[2] = __floats2bfloat162_rn(b.x, b.y);
  h[3] = __floats2bfloat162_rn(b.z, b.w);
  *reinterpret_cast<uint4*>(p) = raw;
}

template <typename IO, bool FAST>
__global__ void __launch_bounds__(NTHREADS, 2) act_chain_kernel(ChainArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int C = a.C, T = a.T, L = a.L, M = a.M;
  const int runs = RUNS_OUT * a.chunks, n = runs * RUN;
  const int pitch = (runs + 2) * RUN_PITCH;  // floats per channel row
  const int ngroups = (C + ACT_CG - 1) / ACT_CG;
  const int c0 = (blockIdx.x % ngroups) * ACT_CG, t0 = (blockIdx.x / ngroups) * L;
  const int b = blockIdx.y, gc = min(ACT_CG, C - c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const IO* x = static_cast<const IO*>(a.x) + b * a.sb + c0 * a.sc;

  // the margin runs (-1 and `runs`) are read by the edge lanes, never written
  for (int i = threadIdx.x; i < ACT_CG * 2 * RUN_PITCH; i += NTHREADS) {
    const int c = i / (2 * RUN_PITCH), j = i % (2 * RUN_PITCH);
    smem[c * pitch + (j < RUN_PITCH ? j : runs * RUN_PITCH + j)] = 0.f;
  }
  // window load: window sample p is x at clamp(t0 - M + p, 0, T - 1). Each
  // thread first issues LOADS loads of one time sample (8 channels) each,
  // then transposes them into the rows: the whole window is in flight at once
  for (int p0 = threadIdx.x; p0 < n; p0 += LOADS * NTHREADS) {
    float v[LOADS][8];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const long long g = clampi(t0 - M + min(p0 + u * NTHREADS, n - 1), 0, T - 1);
      if (a.vec_in) {
        load8(x + g * a.st, v[u]);
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) v[u][c] = c < gc ? load_f<IO>(x + g * a.st + c * a.sc) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int p = p0 + u * NTHREADS;
      if (p < n) {
        const int w = row_word(p);
#pragma unroll
        for (int c = 0; c < 8; ++c) smem[c * pitch + w] = v[u][c];
      }
    }
  }
  __syncthreads();
  if (warp >= gc) return;

  float* row = smem + warp * pitch;
  const float al2 = 2.0f * __ldg(a.vec + c0 + warp);
  const float hb = 0.5f * (1.0f / (__ldg(a.vec + C + c0 + warp) + 1e-9f));
  for (int r = 0; r < a.nrep; ++r) {
    float carry[8];  // the second half of lane 30's run, as it was before this chunk wrote it
    for (int k = 0; k < a.chunks; ++k) {
      // this lane's run: window run 30k - 1 + lane, row run 30k + lane
      float4* run4 = reinterpret_cast<float4*>(row + (RUNS_OUT * k + lane) * RUN_PITCH);
      float s[RUN + 6];  // the signal at run offsets -3 .. RUN + 2
      if (k == 0 || lane != 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = run4[q];
          s[3 + 4 * q] = v.x; s[4 + 4 * q] = v.y; s[5 + 4 * q] = v.z; s[6 + 4 * q] = v.w;
        }
      } else {
        // lane 0 feeds lane 1 from offsets 11..15 only; 0..7 stay unread
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[3 + j] = 0.f;
          s[11 + j] = carry[j];
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) carry[j] = __shfl_sync(FULL, s[11 + j], RUNS_OUT);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        s[j] = __shfl_up_sync(FULL, s[16 + j], 1);        // offsets -3..-1
        s[19 + j] = __shfl_down_sync(FULL, s[3 + j], 1);  // offsets 16..18
      }
      // snaked up-phases: E[i] = snake(sum_d up_e[d] * s[i + d - 3]),
      // O[i] = snake(sum_d up_o[d] * s[i + d - 2])
      float e[RUN], o[RUN];
#pragma unroll
      for (int i = 0; i < RUN; ++i) {
        float ue = 0.f, uo = 0.f;
#pragma unroll
        for (int d = 0; d < 6; ++d) {
          ue += a.up_e[d] * s[i + d];
          uo += a.up_o[d] * s[i + d + 1];
        }
        e[i] = snake_hb<FAST>(ue, al2, hb);
        o[i] = snake_hb<FAST>(uo, al2, hb);
      }
      // their halos: ow[m] = O[m - 3], ew[m] = E[m - 2], m = 0 .. RUN + 4
      float ow[RUN + 5], ew[RUN + 5];
#pragma unroll
      for (int i = 0; i < RUN; ++i) {
        ow[3 + i] = o[i];
        ew[2 + i] = e[i];
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        ow[j] = __shfl_up_sync(FULL, o[13 + j], 1);
        ew[18 + j] = __shfl_down_sync(FULL, e[j], 1);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        ew[j] = __shfl_up_sync(FULL, e[14 + j], 1);
        ow[19 + j] = __shfl_down_sync(FULL, o[j], 1);
      }
      // down-FIR: y[i] = sum_d dn_e[d] * O[i + d - 3] + dn_o[d] * E[i + d - 2]
      float y[RUN];
#pragma unroll
      for (int i = 0; i < RUN; ++i) {
        float ye = 0.f, yo = 0.f;
#pragma unroll
        for (int d = 0; d < 6; ++d) {
          ye += a.dn_e[d] * ow[i + d];
          yo += a.dn_o[d] * ew[i + d];
        }
        y[i] = ye + yo;
      }
      if (lane >= 1 && lane <= RUNS_OUT) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          run4[q] = make_float4(y[4 * q], y[4 * q + 1], y[4 * q + 2], y[4 * q + 3]);
      }
    }
    __syncwarp();
  }

  // the tile centre, window samples [M, M + L), time fastest (out is
  // channels-first)
  IO* out = static_cast<IO*>(a.out) + ((size_t)b * C + c0 + warp) * T + t0;
  const int valid = min(L, T - t0);
  if (a.vec_out) {  // T % 8 == 0: 8 samples are all inside or all outside
    for (int i = 8 * lane; i < valid; i += 8 * 32) {
      const float4* v = reinterpret_cast<const float4*>(row + row_word(M + i));
      store8(out + i, v[0], v[1]);
    }
  } else {
    for (int i = lane; i < valid; i += 32) store_f<IO>(out + i, row[row_word(M + i)]);
  }
}

template <typename IO, bool FAST>
static int launch(const ChainArgs& a, int B, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(act_chain_kernel<IO, FAST>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ngroups = (a.C + ACT_CG - 1) / ACT_CG, ntiles = (a.T + a.L - 1) / a.L;
  dim3 grid(ngroups * ntiles, B);
  act_chain_kernel<IO, FAST><<<grid, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Returns the CUDA error code of the launch (0 = launched).
// L: the time tile, M: the window margin (a multiple of RUN, >= 6 * nrep),
// with L + 2 * M a multiple of CHUNK.
// taps: 24 floats, up_even[6], up_odd[6], down_even[6], down_odd[6].
extern "C" int act_chain_launch(const void* x, void* out, const float* vec, int B, int C, int T,
                                long long sb, long long st, long long sc, int L, int M, int nrep,
                                int fast, int is_bf16, const float* taps, void* stream) {
  if (nrep < 1 || B < 1 || C < 1 || T < 1 || L < RUN || L % RUN || M % RUN || M < 6 * nrep
      || (L + 2 * M) % CHUNK)
    return (int)cudaErrorInvalidValue;
  ChainArgs a;
  a.x = x; a.out = out; a.vec = vec;
  a.sb = sb; a.st = st; a.sc = sc;
  a.C = C; a.T = T; a.L = L; a.M = M;
  a.chunks = (L + 2 * M) / CHUNK;
  a.nrep = nrep;
  const long long per16 = is_bf16 ? 8 : 4;  // elements in 16 bytes
  a.vec_in = sc == 1 && C % 8 == 0 && st % per16 == 0 && sb % per16 == 0
             && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.vec_out = T % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int i = 0; i < 6; ++i) {
    a.up_e[i] = taps[i]; a.up_o[i] = taps[6 + i];
    a.dn_e[i] = taps[12 + i]; a.dn_o[i] = taps[18 + i];
  }
  const size_t smem = sizeof(float) * ACT_CG * (size_t)(RUNS_OUT * a.chunks + 2) * RUN_PITCH;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return fast ? launch<__nv_bfloat16, true>(a, B, smem, s)
                : launch<__nv_bfloat16, false>(a, B, smem, s);
  return fast ? launch<float, true>(a, B, smem, s) : launch<float, false>(a, B, smem, s);
}
