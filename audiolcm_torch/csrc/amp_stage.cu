// Fused BigVGAN AMP stage for Hopper (sm_90a): two kernels in one source.
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
// point.
//
// Both kernels share one structure:
//   * one thread block per (T-tile, batch element). The block loads the
//     tile plus R = stage radius samples each side of all C channels and
//     keeps every intermediate in shared memory;
//   * every op shrinks its valid range by its own radius, so nothing is
//     exchanged between blocks;
//   * the sequence edges are computed in global coordinates inside the
//     kernel, with each op's own rule: a conv input is zero outside [0, T);
//     the activation's up-FIR reads x clamped to [0, T-1] and its down-FIR
//     reads the snaked up-sampled signal clamped to its first/last sample.
//     So the first and last samples equal the unfused stage, with no
//     stitching pass. A ragged last tile is masked.
//
// bf16 (amp_stage_mma_kernel, the convolutions on the tensor cores; every
// generate path runs it). The TPU kernel multiplies bf16 on the MXU and sums
// in f32; so does this one:
//   * each conv is an implicit GEMM on mma.sync m16n8k16 (bf16 x bf16 ->
//     f32): M = 16 output positions per warp tile, N = C_out in NT n8 tiles,
//     K = (tap, C_in) walked in 8-channel groups flattened over the taps (the
//     JAX kstack order), two groups per k16 step. Each group is one 8x8
//     ldmatrix sub-tile whose row addresses carry the tap shift j*d, so C=24
//     x k=3 is 9 groups (padded to 10), not 24 -> 32 channels per tap;
//   * A is the conv input H in shared memory: bf16, channels-last, rows an
//     odd number of 16-byte units apart (HP = 24 at C=24, 56 at C=48), so
//     the 8 rows of an ldmatrix hit 8 distinct bank groups without a
//     swizzle; pad channels are zeroed once and meet zero weights;
//   * B is the weights, bf16 pairs packed by the wrapper in fragment order
//     (one 8-byte load per lane per n8 tile and k16 step, read through the
//     read-only cache; the next step's fragments load while this step's mma
//     run). The bias is added to the f32 accumulators in the epilogue;
//   * only the conv operands are bf16 (H, the conv inputs, and G, the first
//     conv's output, as the TPU kernel rounds them); the residual stream
//     (RES, channels-first, pitch NP = 4 mod 8 so the epilogue's RES += hits
//     32 banks), the resblock mean (ACC), the snake's up-phases and every
//     sum stay f32. The smaller footprint buys a longer tile (L = 192 at
//     C=48, 512 at C=24; halo recompute (L+81)/L);
//   * 16 warps per block: one block fills an SM's shared memory, so its own
//     warps are all the latency hiding there is (16 warps beat 8, and beat
//     two 8-warp blocks per SM at a smaller tile, PERF.md);
//   * the activations are alias_free_snake's arithmetic with the warp's
//     lanes walking channels (8 channels x 4 positions per warp), so the
//     2-byte stores of H are conflict-free; the up-phases sit in (N, 8)
//     scratch. After this redesign they are most of the kernel's time.
//
// f32 (amp_stage_kernel, CUDA cores; carries the f32 parity checks, no
// generate path runs it): every intermediate in shared memory in f32 (three
// C x (L+2R) work buffers, a C x L accumulator for the resblock mean, and
// two 8 x (L+2R) scratch rows for the up-sampled snake phases); conv weights
// are read from global memory/L1 with warp-uniform addresses (a broadcast);
// each warp task computes 4 output channels x 4x32 positions so one
// shared-memory read feeds 4 FMAs. Its f32 FMAs are ~250x above the
// tensor-core bound.
//
// Plain C interface, loaded with ctypes (audiolcm_torch/nn/amp_stage.py).
// The cos and snake live in snake_act.cuh, shared with K4.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libamp_stage.so amp_stage.cu

#include <stdint.h>

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
  const float* x = static_cast<const float*>(a.x) + (size_t)blockIdx.y * C * T;
  float* out = static_cast<float*>(a.out) + (size_t)blockIdx.y * C * T;
  const float* w = a.w;

  for (int bi = 0; bi < a.nres; ++bi) {
    const int k = a.ks[bi];
    int rk = 0;
    for (int si = 0; si < a.nsub; ++si) rk += 12 + (k - 1) / 2 * a.ds[si] + (k - 1) / 2;
    int lo = R - rk, hi = N - (R - rk);
    const int n = hi - lo;
    for (int idx = threadIdx.x; idx < C * n; idx += NTHREADS) {
      const int c = idx / n, i = lo + idx % n, g = base + i;
      RES[c * N + i] = (g >= 0 && g < T) ? x[(size_t)c * T + g] : 0.f;
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
    if (g < T) out[(size_t)c * T + g] = ACC[idx] / (float)a.nres;
  }
}

static int launch(const StageArgs& a, int B, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(amp_stage_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.T + a.L - 1) / a.L, B);
  amp_stage_kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// false unless the stage shape is one the kernels take
static bool fill_args(StageArgs& a, const void* x, void* out, const float* vec, int C, int T,
                      int L, int R, int nres, int nsub, const int* ks, const int* ds, int fast,
                      const float* taps) {
  if (nres < 1 || nres > MAX_RES || nsub < 1 || nsub > MAX_SUB || C < 1 || T < 1 || L < 1)
    return false;
  a.x = x; a.out = out; a.w = nullptr; a.vec = vec;
  a.C = C; a.T = T; a.L = L; a.R = R; a.N = L + 2 * R;
  a.nres = nres; a.nsub = nsub; a.fast = fast;
  for (int i = 0; i < MAX_RES; ++i) a.ks[i] = i < nres ? ks[i] : 1;
  for (int i = 0; i < MAX_SUB; ++i) a.ds[i] = i < nsub ? ds[i] : 1;
  for (int i = 0; i < 6; ++i) {
    a.up_e[i] = taps[i]; a.up_o[i] = taps[6 + i];
    a.dn_e[i] = taps[12 + i]; a.dn_o[i] = taps[18 + i];
  }
  return true;
}

// f32 x and out on the CUDA-core kernel. Returns the CUDA error code of the
// launch (0 = launched).
// taps: 24 floats, up_even[6], up_odd[6], down_even[6], down_odd[6].
extern "C" int amp_stage_launch(const void* x, void* out, const float* w, const float* vec,
                                int B, int C, int T, int L, int R, int nres, int nsub,
                                const int* ks, const int* ds, int fast, const float* taps,
                                void* stream) {
  StageArgs a;
  if (!fill_args(a, x, out, vec, C, T, L, R, nres, nsub, ks, ds, fast, taps))
    return (int)cudaErrorInvalidValue;
  a.w = w;
  const size_t smem = sizeof(float) * ((size_t)3 * C * a.N + (size_t)C * L + 2 * EO_GROUP * a.N);
  return launch(a, B, smem, static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
#define MMA_THREADS 512
#define MMA_WARPS (MMA_THREADS / 32)
#define MMA_MAX_NT 8  // n8 tiles of C_out: C <= 64
#define PAD_ROWS 16   // H rows past the window: a ragged 16-row M tile reads into them

struct MmaArgs {
  StageArgs s;      // s.w unused: the weights are wf
  const uint2* wf;  // per conv in stage order, (steps, NT, 32 lanes) B fragments
  int NP;           // RES row pitch in floats, NP % 8 == 4
  int HP;           // H and G row pitch in bf16, HP / 8 odd
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// alias_free_snake's arithmetic over local output range [lo, hi), from RES
// (f32, channels-first, pitch NP) or, FROM_G, from G (bf16, channels-last,
// pitch HP), into H (bf16, channels-last, pitch HP), zero outside [0, T).
// Thread t owns channel t % 8 of each 8-channel group and positions
// t / 8 + 32 i, so a warp's loads and stores walk channels; E and O are
// (N, 8) f32.
template <bool FROM_G>
__device__ void alias_free_snake_mma(const MmaArgs& m, const float* RES, const bf16* G, bf16* H,
                                     float* E, float* O, int lo, int hi, const float* alpha,
                                     const float* binv, int base) {
  const StageArgs& a = m.s;
  const int C = a.C, T = a.T;
  constexpr int STEP = MMA_THREADS / EO_GROUP;
  const int cc = threadIdx.x % EO_GROUP, i0 = threadIdx.x / EO_GROUP;
  for (int cg = 0; cg < C; cg += EO_GROUP) {
    const int c = cg + cc;
    if (c < C) {
      // pass 1: snaked even/odd up-sampled phases over [lo-3, hi+3)
      auto in = [&](int i) -> float {
        return FROM_G ? __bfloat162float(G[i * m.HP + c]) : RES[c * m.NP + i];
      };
      const float al = alpha[c], bi = binv[c];
      for (int i = lo - 3 + i0; i < hi + 3; i += STEP) {
        const int g = base + i;
        float ve, vo;
        if (g < 0) {  // u[0] = ae[0]
          float ue = 0.f;
#pragma unroll
          for (int d = 0; d < 6; ++d) ue += a.up_e[d] * in(clampi(d - 3, 0, T - 1) - base);
          ve = vo = snake(ue, al, bi, a.fast);
        } else if (g >= T) {  // u[2T-1] = ao[T-1]
          float uo = 0.f;
#pragma unroll
          for (int d = 0; d < 6; ++d) uo += a.up_o[d] * in(clampi(T - 1 + d - 2, 0, T - 1) - base);
          ve = vo = snake(uo, al, bi, a.fast);
        } else {
          float ue = 0.f, uo = 0.f;
#pragma unroll
          for (int d = 0; d < 6; ++d) {
            ue += a.up_e[d] * in(clampi(g + d - 3, 0, T - 1) - base);
            uo += a.up_o[d] * in(clampi(g + d - 2, 0, T - 1) - base);
          }
          ve = snake(ue, al, bi, a.fast);
          vo = snake(uo, al, bi, a.fast);
        }
        E[i * EO_GROUP + cc] = ve;
        O[i * EO_GROUP + cc] = vo;
      }
    }
    __syncthreads();
    if (c < C) {
      // pass 2: down-FIR; zero outside [0, T) (the next op is a conv)
      for (int i = lo + i0; i < hi; i += STEP) {
        const int g = base + i;
        float y = 0.f;
        if (g >= 0 && g < T) {
          float ye = 0.f, yo = 0.f;
#pragma unroll
          for (int d = 0; d < 6; ++d) {
            ye += a.dn_e[d] * O[(i + d - 3) * EO_GROUP + cc];
            yo += a.dn_o[d] * E[(i + d - 2) * EO_GROUP + cc];
          }
          y = ye + yo;
        }
        H[i * m.HP + c] = __float2bfloat16(y);
      }
    }
    __syncthreads();
  }
}

// "Same" conv of H (zero outside [0, T) already) over local output range
// [lo, hi) on the tensor cores: G = bf16(bias + conv), or, TO_RES,
// RES += bias + conv in f32. W: this conv's B fragments.
template <int NT, bool TO_RES>
__device__ void conv_mma(const MmaArgs& m, const bf16* H, bf16* G, float* RES, int lo, int hi,
                         const uint2* W, const float* bias, int k, int d) {
  const int C = m.s.C, HP = m.HP;
  const int half = (k - 1) / 2 * d;
  const int ng = (C + 7) / 8, nq = k * ng, steps = (nq + 1) / 2;
  const int nmt = (hi - lo + 15) / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  // this lane's ldmatrix row: position lane % 16 of the tile, in the first
  // (lane < 16) or second 8-channel group of each k16 step
  const int hsel = lane >> 4;
  const uint2* wl = W + lane;
  for (int mt = warp; mt < nmt; mt += MMA_WARPS) {
    const int p0 = lo + mt * 16;
    const uint32_t arow = smem_addr(H + (p0 + (lane & 15) - half) * HP);
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    int j = hsel / ng, cg = hsel % ng;  // group q = 2 s + hsel = j * ng + cg
    uint2 b[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) b[n] = __ldg(wl + n * 32);
    for (int s = 0; s < steps; ++s) {
      // the group past nq (odd nq) reads group 0's rows against zero weights
      const int off = 2 * s + hsel < nq ? j * d * HP + cg * 8 : 0;
      uint32_t af[4];
      ldsm_x4(arow + 2 * off, af);
      uint2 bn[NT];
      const int sn = min(s + 1, steps - 1);
#pragma unroll
      for (int n = 0; n < NT; ++n) bn[n] = __ldg(wl + (sn * NT + n) * 32);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma16816(acc[n], af, b[n].x, b[n].y);
#pragma unroll
      for (int n = 0; n < NT; ++n) b[n] = bn[n];
      cg += 2;
      if (cg >= ng) { cg -= ng; ++j; }
      if (cg >= ng) { cg -= ng; ++j; }
    }
    // epilogue: accumulator (row, col) = (g + 8 h, 2 t4 + e) of n8 tile n
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + g + 8 * h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n * 8 + 2 * t4 + e;
          if (p >= hi || co >= C) continue;
          const float v = acc[n][2 * h + e] + bias[co];
          if (TO_RES)
            RES[co * m.NP + p] += v;
          else
            G[p * HP + co] = __float2bfloat16(v);
        }
      }
    }
  }
  __syncthreads();
}

template <int NT>
__global__ void __launch_bounds__(MMA_THREADS) amp_stage_mma_kernel(const MmaArgs m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const StageArgs& a = m.s;
  const int C = a.C, N = a.N, L = a.L, R = a.R, T = a.T, NP = m.NP, HP = m.HP;
  const int t0 = blockIdx.x * L, base = t0 - R;
  float* RES = reinterpret_cast<float*>(smem_raw);      // residual stream, C x NP
  float* ACC = RES + C * NP;                            // resblock sum, C x L
  float* E = ACC + C * L;                               // snaked even up-phase, N x 8
  float* O = E + EO_GROUP * N;                          // odd, N x 8
  bf16* H = reinterpret_cast<bf16*>(O + EO_GROUP * N);  // conv inputs, (N + PAD_ROWS) x HP
  bf16* G = H + (N + PAD_ROWS) * HP;                    // first conv's output, N x HP
  // H's pad channels enter the mma (against zero weights): zero them once
  for (int i = threadIdx.x; i < (N + PAD_ROWS) * HP / 8; i += MMA_THREADS)
    reinterpret_cast<uint4*>(H)[i] = make_uint4(0, 0, 0, 0);
  const bf16* x = static_cast<const bf16*>(a.x) + (size_t)blockIdx.y * C * T;
  bf16* out = static_cast<bf16*>(a.out) + (size_t)blockIdx.y * C * T;
  const uint2* w = m.wf;
  const int ng = (C + 7) / 8;

  for (int bi = 0; bi < a.nres; ++bi) {
    const int k = a.ks[bi];
    const size_t conv_frags = (size_t)((k * ng + 1) / 2) * NT * 32;
    int rk = 0;
    for (int si = 0; si < a.nsub; ++si) rk += 12 + (k - 1) / 2 * a.ds[si] + (k - 1) / 2;
    int lo = R - rk, hi = N - (R - rk);
    const int n = hi - lo;
    for (int idx = threadIdx.x; idx < C * n; idx += MMA_THREADS) {
      const int c = idx / n, i = lo + idx % n, g = base + i;
      RES[c * NP + i] = (g >= 0 && g < T) ? __bfloat162float(x[(size_t)c * T + g]) : 0.f;
    }
    __syncthreads();
    for (int si = 0; si < a.nsub; ++si) {
      const int d = a.ds[si];
      const float* v = a.vec + (size_t)(bi * a.nsub + si) * 6 * C;
      alias_free_snake_mma<false>(m, RES, G, H, E, O, lo + 6, hi - 6, v, v + C, base);
      lo += 6; hi -= 6;
      const int h1 = (k - 1) / 2 * d;
      conv_mma<NT, false>(m, H, G, RES, lo + h1, hi - h1, w, v + 2 * C, k, d);
      lo += h1; hi -= h1;
      w += conv_frags;
      alias_free_snake_mma<true>(m, RES, G, H, E, O, lo + 6, hi - 6, v + 3 * C, v + 4 * C, base);
      lo += 6; hi -= 6;
      const int h2 = (k - 1) / 2;
      conv_mma<NT, true>(m, H, G, RES, lo + h2, hi - h2, w, v + 5 * C, k, 1);
      lo += h2; hi -= h2;
      w += conv_frags;
    }
    // lo == R and hi == N - R here: the tile centre
    for (int idx = threadIdx.x; idx < C * L; idx += MMA_THREADS) {
      const float val = RES[(idx / L) * NP + R + idx % L];
      ACC[idx] = bi == 0 ? val : ACC[idx] + val;
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < C * L; idx += MMA_THREADS) {
    const int c = idx / L, g = t0 + idx % L;
    if (g < T) out[(size_t)c * T + g] = __float2bfloat16(ACC[idx] / (float)a.nres);
  }
}

template <int NT>
static int launch_mma(const MmaArgs& m, int B, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(amp_stage_mma_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m.s.T + m.s.L - 1) / m.s.L, B);
  amp_stage_mma_kernel<NT><<<grid, MMA_THREADS, smem, stream>>>(m);
  return (int)cudaGetLastError();
}

// bf16 x and out on the tensor-core kernel; wf: the B fragments of every
// conv (nn/amp_stage.py:pack_stage_params_mma). The shared-memory size is
// nn/amp_stage.py:smem_bytes_mma (the gpu test launches pick_tile_mma's tile
// at every C it covers, up to 64). Returns the CUDA error code of the launch.
extern "C" int amp_stage_mma_launch(const void* x, void* out, const void* wf, const float* vec,
                                    int B, int C, int T, int L, int R, int nres, int nsub,
                                    const int* ks, const int* ds, int fast, const float* taps,
                                    void* stream) {
  MmaArgs m;
  if (!fill_args(m.s, x, out, vec, C, T, L, R, nres, nsub, ks, ds, fast, taps) ||
      C > 8 * MMA_MAX_NT || L % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int N = m.s.N, ng = (C + 7) / 8;
  m.wf = static_cast<const uint2*>(wf);
  m.NP = N + ((4 - N) % 8 + 8) % 8;
  m.HP = 8 * (ng % 2 ? ng : ng + 1);
  const size_t smem = sizeof(float) * ((size_t)C * m.NP + (size_t)C * L + 2 * EO_GROUP * N) +
                      sizeof(bf16) * (size_t)m.HP * (2 * N + PAD_ROWS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ng) {
    case 1: return launch_mma<1>(m, B, smem, s);
    case 2: return launch_mma<2>(m, B, smem, s);
    case 3: return launch_mma<3>(m, B, smem, s);
    case 4: return launch_mma<4>(m, B, smem, s);
    case 5: return launch_mma<5>(m, B, smem, s);
    case 6: return launch_mma<6>(m, B, smem, s);
    case 7: return launch_mma<7>(m, B, smem, s);
    default: return launch_mma<8>(m, B, smem, s);
  }
}
