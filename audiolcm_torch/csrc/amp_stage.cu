// Fused BigVGAN AMP stage for Hopper (sm_90a).
//
// Replaces the TPU kernel audiolcm_tpu/nn/pallas_amp_stage.py:665
// fused_amp_stage_cl_batched: one whole upsample stage of the vocoder
// (nres resblocks x nsub sub-units of alias-free SnakeBeta -> dilated conv
// -> alias-free SnakeBeta -> conv, plus the residual; output = mean of the
// resblocks), read from device memory once and written once.
//
// What bounds it on this card: operations. The convolutions do
// 252*C^2 FLOP per sample (k = 3, 7, 11; 6 convs per resblock) against
// about 4*C bytes per sample moved in bf16, far right of the H100's ridge
// point. This first kernel runs them on CUDA cores in f32, so it sits well
// above the tensor-core bound; mma/wgmma over (C_in x taps), TMA and warp
// specialisation are later work.
//
// What the design does about it:
//   * one thread block per (T-tile, batch element). The block loads the
//     tile plus R = stage radius samples each side of all C channels and
//     keeps every intermediate in shared memory in f32 (three C x (L+2R)
//     work buffers, a C x L accumulator for the resblock mean, and two
//     8 x (L+2R) scratch rows for the up-sampled snake phases);
//   * every op shrinks its valid range by its own radius, so nothing is
//     exchanged between blocks;
//   * the sequence edges are computed in global coordinates inside the
//     kernel, with each op's own rule: a conv input is zero outside [0, T);
//     the activation's up-FIR reads x clamped to [0, T-1] and its down-FIR
//     reads the snaked up-sampled signal clamped to its first/last sample.
//     So the first and last samples equal the unfused stage, with no
//     stitching pass;
//   * conv weights are read from global memory/L1 with warp-uniform
//     addresses (a broadcast); each warp task computes 4 output channels x
//     4x32 positions so one shared-memory read feeds 4 FMAs.
//
// Plain C interface, loaded with ctypes (audiolcm_torch/nn/amp_stage.py).
// The loads, stores, cos and snake live in snake_act.cuh, shared with K4.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libamp_stage.so amp_stage.cu

#include "snake_act.cuh"

#define NTHREADS 256
#define NWARPS (NTHREADS / 32)
#define MAX_RES 4
#define MAX_SUB 4
#define EO_GROUP 8  // channels per pass of the up-sampled snake scratch
#define CONV_CO 4   // output channels per warp task
#define CONV_TT 4   // positions per lane per warp task (strided by 32)

struct StageArgs {
  const void* x;     // (B, C, T), float or bf16
  void* out;         // (B, C, T), same type
  const float* w;    // conv weights, (C_out, C_in, k) per conv, in order
                     // [res][sub][conv1, conv2]
  const float* vec;  // per (res, sub): alpha1, 1/(beta1+1e-9), bias1,
                     //                 alpha2, 1/(beta2+1e-9), bias2; C each
  int C, T, L, R, N;
  int nres, nsub;
  int ks[MAX_RES];
  int ds[MAX_SUB];
  int fast;
  float up_e[6], up_o[6], dn_e[6], dn_o[6];
};

// Alias-free SnakeBeta of IN into OUT over local output range [lo, hi).
// IN must be valid over [lo-6, hi+6) (or the clamped edge sample there).
// Local index i <-> global position base + i.
__device__ void alias_free_snake(const StageArgs& a, const float* IN, float* OUT, float* E,
                                 float* O, int lo, int hi, const float* alpha,
                                 const float* binv, int base) {
  const int C = a.C, N = a.N, T = a.T;
  const int n1 = hi - lo + 6, n2 = hi - lo;
  for (int cg = 0; cg < C; cg += EO_GROUP) {
    const int gc = min(EO_GROUP, C - cg);
    // pass 1: snaked even/odd up-sampled phases over [lo-3, hi+3)
    for (int idx = threadIdx.x; idx < gc * n1; idx += NTHREADS) {
      const int cc = idx / n1, i = lo - 3 + idx % n1, c = cg + cc;
      const float* row = IN + c * N;
      const int g = base + i;
      const float al = alpha[c], bi = binv[c];
      float ve, vo;
      if (g < 0) {  // u[0] = ae[0]
        float ue = 0.f;
#pragma unroll
        for (int d = 0; d < 6; ++d) ue += a.up_e[d] * row[clampi(d - 3, 0, T - 1) - base];
        ve = vo = snake(ue, al, bi, a.fast);
      } else if (g >= T) {  // u[2T-1] = ao[T-1]
        float uo = 0.f;
#pragma unroll
        for (int d = 0; d < 6; ++d) uo += a.up_o[d] * row[clampi(T - 1 + d - 2, 0, T - 1) - base];
        ve = vo = snake(uo, al, bi, a.fast);
      } else {
        float ue = 0.f, uo = 0.f;
#pragma unroll
        for (int d = 0; d < 6; ++d) {
          ue += a.up_e[d] * row[clampi(g + d - 3, 0, T - 1) - base];
          uo += a.up_o[d] * row[clampi(g + d - 2, 0, T - 1) - base];
        }
        ve = snake(ue, al, bi, a.fast);
        vo = snake(uo, al, bi, a.fast);
      }
      E[cc * N + i] = ve;
      O[cc * N + i] = vo;
    }
    __syncthreads();
    // pass 2: down-FIR; zero outside [0, T) (the next op is a conv)
    for (int idx = threadIdx.x; idx < gc * n2; idx += NTHREADS) {
      const int cc = idx / n2, i = lo + idx % n2;
      const int g = base + i;
      float y = 0.f;
      if (g >= 0 && g < T) {
        float ye = 0.f, yo = 0.f;
#pragma unroll
        for (int d = 0; d < 6; ++d) {
          ye += a.dn_e[d] * O[cc * N + i + d - 3];
          yo += a.dn_o[d] * E[cc * N + i + d - 2];
        }
        y = ye + yo;
      }
      OUT[(cg + cc) * N + i] = y;
    }
    __syncthreads();
  }
}

// "Same" conv of IN (zero outside [0, T) already) into OUT over local output
// range [lo, hi): OUT = bias + conv, or OUT += bias + conv when accumulate.
__device__ void conv(const StageArgs& a, const float* IN, float* OUT, bool accumulate, int lo,
                     int hi, const float* W, const float* bias, int k, int d) {
  const int C = a.C, N = a.N;
  const int half = (k - 1) / 2 * d;
  const int n = hi - lo;
  const int nch = (n + 32 * CONV_TT - 1) / (32 * CONV_TT);
  const int nco = (C + CONV_CO - 1) / CONV_CO;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int task = warp; task < nco * nch; task += NWARPS) {
    const int cob = (task / nch) * CONV_CO;
    const int p0 = lo + (task % nch) * 32 * CONV_TT + lane;
    float acc[CONV_CO][CONV_TT];
#pragma unroll
    for (int o = 0; o < CONV_CO; ++o)
#pragma unroll
      for (int q = 0; q < CONV_TT; ++q) acc[o][q] = 0.f;
    for (int ci = 0; ci < C; ++ci) {
      const float* row = IN + ci * N + p0 - half;
      for (int j = 0; j < k; ++j) {
        float wv[CONV_CO];
#pragma unroll
        for (int o = 0; o < CONV_CO; ++o)
          wv[o] = (cob + o < C) ? __ldg(W + ((cob + o) * C + ci) * k + j) : 0.f;
#pragma unroll
        for (int q = 0; q < CONV_TT; ++q) {
          const float xv = (p0 + 32 * q < hi) ? row[32 * q + j * d] : 0.f;
#pragma unroll
          for (int o = 0; o < CONV_CO; ++o) acc[o][q] += wv[o] * xv;
        }
      }
    }
#pragma unroll
    for (int o = 0; o < CONV_CO; ++o) {
      if (cob + o >= C) continue;
      const float bo = bias[cob + o];
#pragma unroll
      for (int q = 0; q < CONV_TT; ++q) {
        const int p = p0 + 32 * q;
        if (p < hi) {
          float* dst = OUT + (cob + o) * N + p;
          const float v = acc[o][q] + bo;
          *dst = accumulate ? *dst + v : v;
        }
      }
    }
  }
  __syncthreads();
}

template <typename IO>
__global__ void __launch_bounds__(NTHREADS) amp_stage_kernel(StageArgs a) {
  extern __shared__ float smem[];
  const int C = a.C, N = a.N, L = a.L, R = a.R, T = a.T;
  const int t0 = blockIdx.x * L, base = t0 - R;
  float* RES = smem;         // residual stream of the current resblock
  float* H = RES + C * N;    // activation outputs (conv inputs)
  float* G = H + C * N;      // first conv's output
  float* ACC = G + C * N;    // sum of the resblocks over the tile centre
  float* E = ACC + C * L;    // snaked even up-phase, EO_GROUP channels
  float* O = E + EO_GROUP * N;
  const IO* x = static_cast<const IO*>(a.x) + (size_t)blockIdx.y * C * T;
  IO* out = static_cast<IO*>(a.out) + (size_t)blockIdx.y * C * T;
  const float* w = a.w;

  for (int bi = 0; bi < a.nres; ++bi) {
    const int k = a.ks[bi];
    int rk = 0;
    for (int si = 0; si < a.nsub; ++si) rk += 12 + (k - 1) / 2 * a.ds[si] + (k - 1) / 2;
    int lo = R - rk, hi = N - (R - rk);
    const int n = hi - lo;
    for (int idx = threadIdx.x; idx < C * n; idx += NTHREADS) {
      const int c = idx / n, i = lo + idx % n, g = base + i;
      RES[c * N + i] = (g >= 0 && g < T) ? load_f<IO>(x + (size_t)c * T + g) : 0.f;
    }
    __syncthreads();
    for (int si = 0; si < a.nsub; ++si) {
      const int d = a.ds[si];
      const float* v = a.vec + (size_t)(bi * a.nsub + si) * 6 * C;
      alias_free_snake(a, RES, H, E, O, lo + 6, hi - 6, v, v + C, base);
      lo += 6; hi -= 6;
      const int h1 = (k - 1) / 2 * d;
      conv(a, H, G, false, lo + h1, hi - h1, w, v + 2 * C, k, d);
      lo += h1; hi -= h1;
      w += (size_t)C * C * k;
      alias_free_snake(a, G, H, E, O, lo + 6, hi - 6, v + 3 * C, v + 4 * C, base);
      lo += 6; hi -= 6;
      const int h2 = (k - 1) / 2;
      conv(a, H, RES, true, lo + h2, hi - h2, w, v + 5 * C, k, 1);
      lo += h2; hi -= h2;
      w += (size_t)C * C * k;
    }
    // lo == R and hi == N - R here: the tile centre
    for (int idx = threadIdx.x; idx < C * L; idx += NTHREADS) {
      const float val = RES[(idx / L) * N + R + idx % L];
      ACC[idx] = bi == 0 ? val : ACC[idx] + val;
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < C * L; idx += NTHREADS) {
    const int c = idx / L, g = t0 + idx % L;
    if (g < T) store_f<IO>(out + (size_t)c * T + g, ACC[idx] / (float)a.nres);
  }
}

template <typename IO>
static int launch(const StageArgs& a, int B, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(amp_stage_kernel<IO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.T + a.L - 1) / a.L, B);
  amp_stage_kernel<IO><<<grid, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Returns the CUDA error code of the launch (0 = launched).
// taps: 24 floats, up_even[6], up_odd[6], down_even[6], down_odd[6].
extern "C" int amp_stage_launch(const void* x, void* out, const float* w, const float* vec,
                                int B, int C, int T, int L, int R, int nres, int nsub,
                                const int* ks, const int* ds, int fast, int is_bf16,
                                const float* taps, void* stream) {
  if (nres < 1 || nres > MAX_RES || nsub < 1 || nsub > MAX_SUB) return (int)cudaErrorInvalidValue;
  StageArgs a;
  a.x = x; a.out = out; a.w = w; a.vec = vec;
  a.C = C; a.T = T; a.L = L; a.R = R; a.N = L + 2 * R;
  a.nres = nres; a.nsub = nsub; a.fast = fast;
  for (int i = 0; i < MAX_RES; ++i) a.ks[i] = i < nres ? ks[i] : 1;
  for (int i = 0; i < MAX_SUB; ++i) a.ds[i] = i < nsub ? ds[i] : 1;
  for (int i = 0; i < 6; ++i) {
    a.up_e[i] = taps[i]; a.up_o[i] = taps[6 + i];
    a.dn_e[i] = taps[12 + i]; a.dn_o[i] = taps[18 + i];
  }
  const size_t smem = sizeof(float) * ((size_t)3 * C * a.N + (size_t)C * L + 2 * EO_GROUP * a.N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, B, smem, s) : launch<float>(a, B, smem, s);
}
