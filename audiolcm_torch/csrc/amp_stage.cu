// Fused BigVGAN AMP stage for Hopper (sm_90a): two kernels in one source.
//
// Replaces the TPU kernel audiolcm_tpu/nn/pallas_amp_stage.py:665
// fused_amp_stage_cl_batched: one whole upsample stage of the vocoder
// (nres resblocks x nsub sub-units of alias-free SnakeBeta -> dilated conv
// -> alias-free SnakeBeta -> conv, plus the residual; output = mean of the
// resblocks), read from device memory once and written once.
//
// What bounds it on this card. By the published peaks, operations: the
// convolutions do 252*C^2 FLOP per sample (k = 3, 7, 11; 6 convs per
// resblock) against about 4*C bytes per sample moved in bf16, far right of
// the ridge point; at batch 8 (C = 48, T = 79 872; C = 24, T = 159 744) that
// is 0.375 and 0.19 ms at 989 TFLOP/s. But the 18 alias-free activations
// cannot use the tensor cores (a polynomial cos, 6-tap FIRs in f32). Their
// floor (chip_smoke.py:act_f32_bound_ms) is 78 FLOP per output of each
// activation (up-FIR 24, two snakes ~30, down-FIR 24) at 67 TFLOP/s of f32:
// 0.643 ms for the 18 activations over the same 30.7 M channel-samples at
// either width, above the conv bound at both; the halo each tile
// recomputes adds (L + R) / L of work on top (1.57x at C = 48, 1.16x at
// C = 24). So the CUDA cores, not the tensor cores, set the floor; C = 24
// leans on them harder (1/4 of C = 48's conv work over the same samples).
// The two kinds of work run one after the other inside a tile (each op
// needs the last one's whole range), in about equal parts of the time.
//
// Both kernels share one structure:
//   * one thread block per (T-tile, batch element). The block works on the
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
// bf16 (amp_stage_mma_kernel; every generate path runs it). The TPU kernel
// multiplies bf16 on the MXU and sums in f32; so does this one. Rounded to
// bf16: the conv inputs H and the first conv's output G, as the TPU kernel
// rounds them; the residual, the resblock sum and mean, the snake's
// up-phases, the biases and every sum stay f32. What the design does:
//   * activations from registers. A thread computes one segment of one
//     channel's outputs (C channels x segments fill the block's threads, a
//     segment a multiple of SEG_U = 8), SEG_U outputs a step: per output it
//     loads one input sample, computes one pair of snaked up-phases (both
//     from the same 6-sample window) and the down-FIR, with the last 10
//     samples and 5 phase pairs carried in registers to the next step, so
//     only a segment's first step recomputes its neighbour's 5 pairs. The
//     lanes of a warp hold consecutive channels at the same sample, so the
//     2-byte stores of H fill the same row of four channel planes, whose row
//     counts (1 mod 8) put them on four distinct bank groups. No scratch
//     and no barrier inside an activation; the clamps and the edge rules run
//     only in the blocks whose window leaves [0, T). The exact cos (the
//     parity checks) is called, not inlined;
//   * convs on wgmma. Each conv is an implicit GEMM: M = 64 output samples
//     per warpgroup tile, N = C rounded up to 8 (m64nNk16), K = (8-channel
//     group, tap) flattened in that order, two groups per k16 step, so the
//     K order needs no padding per tap. Both operands are read by wgmma from
//     shared memory as 8x8 bf16 core matrices (8 rows of 16 bytes, no
//     swizzle). A is H, stored as one plane of 16-byte rows per 8-channel
//     group: a tap's shift j*d is a shift of the descriptor's start by rows,
//     and a step's second group lies at a positive offset from its first (d
//     rows on, or the next plane), so every k16 step is one descriptor pair
//     and no thread loads A. B (the weights) is one (C_out rounded to 8) x 8
//     block per group. A tile's k16 steps issue back to back under one
//     commit; the first step overwrites the accumulators, so nothing but
//     wgmma touches them before the wait. No warp re-reads weights from L1:
//     each conv's packed weights are copied once per block into shared
//     memory by cp.async, issued before the activation that precedes the
//     conv, so the copy runs under it. What this reaches on the card: a
//     wgmma with N <= 64 costs the SM about as long as one with N = 64 (47
//     to 64 cycles, measured), so the convs run near 40 % of the tensor
//     cores' peak at C = 48 and 20 % at C = 24; putting the samples on N
//     (C_out padded to M = 64) was no faster, nor were the weights with the
//     128-byte swizzle or A from registers (ldmatrix);
//   * the weights are packed once per weight version by the wrapper's caller
//     (nn/amp_stage.py:pack_stage), outside any captured graph;
//   * four barriers per sub-unit (activation, conv, activation, conv); the
//     residual's epilogue adds in f32; the last conv of each resblock adds
//     its centre into the resblock sum, and the last one writes the mean;
//   * the stage input is read with 16-byte loads (after the first resblock
//     from L2) into the f32 residual at each resblock's start: a bf16 copy of
//     the window in shared memory would cost 2*C*(L + 2R) bytes, which at
//     C = 48 shortens the tile from 168 to 120 samples and raises the halo
//     work by about 12 %;
//   * the tile L (a multiple of 8) and the grid come from (C, B, T) and the
//     SM count (nn/amp_stage.py:pick_tile_mma): the tile that costs the
//     fewest waves of one block per SM times (L + R) samples of work, so a
//     batch-1 grid fills its last wave.
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
// The cos and snake live in snake_act.cuh, shared with K4 and K5.
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
// Three warpgroups: up to 168 registers a thread, so the activation's
// carried window does not spill (at four, with 128, it did, and ran slower).
#define MMA_THREADS 384
#define MMA_MAX_NT 8     // wgmma's N = 8 * NT: C <= 64
#define SEG_U 8          // outputs of one step of an activation's segment
#define SMEM_SLACK 64    // a segment's last step reads up to 11 samples past the last row

struct MmaArgs {
  StageArgs s;     // s.w unused: the weights are wq
  const bf16* wq;  // per conv in stage order, (groups, 8 NT, 8) (nn/amp_stage.py:pack_conv_wgmma)
  int NP;          // RES and G row pitch in elements, NP % 8 == 4
  int HROWS;       // rows of each 8-channel plane of H, N + 64 rounded up to 1 mod 8
  int LP;          // ACC row pitch in floats, L + 4
  int wbytes;      // the weight buffer: the stage's largest conv
  int vec_x;       // x takes 16-byte loads (T % 8 == 0, 16-byte aligned)
};

// clang-format off
// D (64 x 8NT, f32, in registers) = A (64 x 16 bf16) * B (16 x 8NT)
// [+ D when scale_d], both K-major in shared memory, through their
// descriptors.
__device__ __forceinline__ void wgmma_n8(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n16(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n24(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11"
      "}, %12, %13, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n32(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n40(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19"
      "}, %20, %21, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n48(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n56(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %30, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27"
      "}, %28, %29, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}


// clang-format on

template <int NT>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (NT == 1) wgmma_n8(d, da, db, scale_d);
  else if constexpr (NT == 2) wgmma_n16(d, da, db, scale_d);
  else if constexpr (NT == 3) wgmma_n24(d, da, db, scale_d);
  else if constexpr (NT == 4) wgmma_n32(d, da, db, scale_d);
  else if constexpr (NT == 5) wgmma_n40(d, da, db, scale_d);
  else if constexpr (NT == 6) wgmma_n48(d, da, db, scale_d);
  else if constexpr (NT == 7) wgmma_n56(d, da, db, scale_d);
  else wgmma_n64(d, da, db, scale_d);
}

// Keeps the compiler from moving the accumulators across the async wgmma.
template <int K>
__device__ __forceinline__ void fence_f(float* d) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A K-major, unswizzled shared-memory operand of one k16 step: two K columns
// of 8 x 8 bf16 core matrices (8 rows of 16 bytes, stored together), the
// second column `lbo` bytes after the first (the leading-dimension offset
// steps K), each column's core matrices 128 bytes apart along M or N (the
// stride offset).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

// 8-channel groups of one conv's K, (channel group, tap) flattened and padded to pairs
__device__ __forceinline__ int conv_groups(int k, int ng) { return (k * ng + 1) / 2 * 2; }

// Copies `bytes` of packed weights to the shared buffer at dst, 16 bytes per
// cp.async; weights_ready() waits for them.
__device__ __forceinline__ void stage_weights(uint32_t dst, const bf16* src, int bytes) {
  const char* s = reinterpret_cast<const char*>(src);
  for (int i = threadIdx.x * 16; i < bytes; i += MMA_THREADS * 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst + i), "l"(s + i)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The staged weights are in shared memory, and they and every thread's
// stores before it (the activation's H) are visible to every thread and to
// wgmma, which reads through the async proxy: the barrier between an
// activation and its conv.
__device__ __forceinline__ void weights_ready() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// RES[c][lo, hi) = x at base + i, zero outside [0, T): 8 samples a task, by
// one 16-byte load where the 8 lie inside [0, T) and x allows it.
__device__ __forceinline__ void load_x(const MmaArgs& m, const bf16* x, float* RES, int lo, int hi,
                                       int base) {
  const int C = m.s.C, T = m.s.T, NP = m.NP;
  const int g0 = base + lo, g1 = base + hi;
  const int ga = g0 - ((g0 % 8) + 8) % 8;  // g0 rounded down to a multiple of 8
  const int groups = (g1 - ga + 7) / 8;
  for (int idx = threadIdx.x; idx < C * groups; idx += MMA_THREADS) {
    const int c = idx / groups, gs = ga + 8 * (idx - c * groups);
    const bf16* src = x + (size_t)c * T;
    float v[8];
    if (m.vec_x && gs >= 0 && gs + 8 <= T) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src + gs));
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h2[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int g = gs + e;
        v[e] = (g >= 0 && g < T) ? __bfloat162float(src[g]) : 0.f;
      }
    }
    float* dst = RES + c * NP + (gs - base);
    if (gs >= g0 && gs + 8 <= g1 && (gs - base) % 4 == 0) {
      reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (gs + e >= g0 && gs + e < g1) dst[e] = v[e];
    }
  }
}

// snake_hb with the exact cos called, not inlined: cosf's range reduction
// has a slow path with a local array, and inlined at each of a task's 42
// snakes it would make the exact-cos kernels (the parity checks; every
// generate path takes the fast cos) several times larger and slower to build.
__device__ __noinline__ float exact_cos(float v) { return cosf(v); }

template <bool FAST>
__device__ __forceinline__ float snake_k1(float h, float al2, float hb) {
  const float arg = al2 * h;
  const float c = FAST ? fast_cos(arg) : exact_cos(arg);
  return h + (1.0f - c) * hb;
}

// alias_free_snake's arithmetic on `in` (RES: f32, or G: bf16; channels-first,
// pitch NP) over local output range [lo, hi), into H (bf16, one plane of
// HROWS rows of 16 bytes per 8-channel group: channel c of sample p at
// (c / 8, p, c % 8)). `in` must be valid over [lo - 6, hi + 6).
//
// Thread t computes one segment of one channel: c = t % C, outputs
// [lo + seg (t / C), + seg), seg a multiple of SEG_U chosen so that the C
// channels' segments fill the block's threads. It walks its segment SEG_U
// outputs a step with the input, the snaked up-phases and the outputs in
// registers: output P reads the odd phase at P - 3 .. P + 2 and the even
// one at P - 2 .. P + 3, both of which the window in[Q .. Q + 5] gives (the
// even phase at Q + 3, the odd at Q + 2), so a step loads SEG_U samples,
// computes SEG_U pairs of phases and keeps the last 10 samples and 5 pairs
// for the next step. Only a segment's first step computes the 5 pairs
// before it.
//
// EDGE (the window leaves [0, T)): reads clamp to [0, T - 1], the phases
// before the first sample take the first even phase and those past the
// last the last odd phase, and outputs outside [0, T) are zero (a conv
// reads them).
template <typename IN, bool FAST, bool EDGE>
__device__ __forceinline__ void act_mma(const MmaArgs& m, const IN* in, bf16* H, int lo, int hi,
                                        const float* alpha, const float* binv, int base) {
  const StageArgs& a = m.s;
  const int C = a.C, T = a.T;
  const int per_c = max(1, MMA_THREADS / C);
  const int seg = (hi - lo + per_c * SEG_U - 1) / (per_c * SEG_U) * SEG_U;
  const int si = threadIdx.x / C, c = threadIdx.x - si * C;
  const int pa = lo + si * seg;
  if (si >= per_c || pa >= hi) return;
  const int pb = min(pa + seg, hi);
  const IN* row = in + c * m.NP;
  const float al2 = 2.0f * __ldg(alpha + c), hb = 0.5f * __ldg(binv + c);
  float first = 0.f, last = 0.f;  // u[0] = ae[0] before the first sample, u[2T-1] = ao[T-1] past the last
  if (EDGE && base < 0) {  // each read only where the window holds that edge
    float u0 = 0.f;
#pragma unroll
    for (int d = 0; d < 6; ++d) u0 += a.up_e[d] * load_f<IN>(row + clampi(d - 3, 0, T - 1) - base);
    first = snake_k1<FAST>(u0, al2, hb);
  }
  if (EDGE && base + a.N > T) {
    float u1 = 0.f;
#pragma unroll
    for (int d = 0; d < 6; ++d)
      u1 += a.up_o[d] * load_f<IN>(row + clampi(T - 1 + d - 2, 0, T - 1) - base);
    last = snake_k1<FAST>(u1, al2, hb);
  }
  // s[i]: in at P0 - 5 + i; ew[i]: the even phase at P0 - 2 + i; ow[i]: the odd at P0 - 3 + i
  float s[SEG_U + 10], ew[SEG_U + 5], ow[SEG_U + 5];
#define K1_LOAD(i, P0) \
  s[i] = load_f<IN>(row + (EDGE ? clampi(base + (P0) - 5 + (i), 0, T - 1) - base : (P0) - 5 + (i)))
#define K1_PAIR(i, P0)                                                      \
  {                                                                         \
    float ue = 0.f, uo = 0.f;                                               \
    _Pragma("unroll") for (int d = 0; d < 6; ++d) {                         \
      ue += a.up_e[d] * s[(i) + d];                                         \
      uo += a.up_o[d] * s[(i) + d];                                         \
    }                                                                       \
    ew[i] = snake_k1<FAST>(ue, al2, hb);                                    \
    ow[i] = snake_k1<FAST>(uo, al2, hb);                                    \
    if (EDGE) {                                                             \
      const int ge = base + (P0) - 2 + (i), go = ge - 1;                    \
      ew[i] = ge < 0 ? first : (ge >= T ? last : ew[i]);                    \
      ow[i] = go < 0 ? first : (go >= T ? last : ow[i]);                    \
    }                                                                       \
  }
#pragma unroll
  for (int i = 0; i < 10; ++i) K1_LOAD(i, pa);
#pragma unroll
  for (int i = 0; i < 5; ++i) K1_PAIR(i, pa);
  for (int P0 = pa; P0 < pb; P0 += SEG_U) {
#pragma unroll
    for (int i = 10; i < SEG_U + 10; ++i) K1_LOAD(i, P0);
#pragma unroll
    for (int i = 5; i < SEG_U + 5; ++i) K1_PAIR(i, P0);
    bf16* h = H + ((c >> 3) * m.HROWS + P0) * 8 + (c & 7);
#pragma unroll
    for (int i = 0; i < SEG_U; ++i) {
      float ye = 0.f, yo = 0.f;
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        ye += a.dn_e[d] * ow[i + d];
        yo += a.dn_o[d] * ew[i + d];
      }
      float y = ye + yo;
      if (EDGE && (base + P0 + i < 0 || base + P0 + i >= T)) y = 0.f;
      if (P0 + i < pb) h[i * 8] = __float2bfloat16(y);
    }
#pragma unroll
    for (int i = 0; i < 10; ++i) s[i] = s[i + SEG_U];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      ew[i] = ew[i + SEG_U];
      ow[i] = ow[i + SEG_U];
    }
  }
#undef K1_LOAD
#undef K1_PAIR
}

// What a conv's output goes into: the first conv's G; the second conv's
// residual; a resblock's last conv adds its centre into the resblock sum (the
// first resblock's sets it); the stage's last conv writes the mean.
enum { TO_G, TO_RES, TO_ACC_FIRST, TO_ACC, TO_OUT };

// "Same" conv of H (zero outside [0, T) already) over local output range
// [lo, hi) on wgmma, A and B both read from shared memory: the weights staged
// at W (conv_groups(k, ng) groups of (8 NT) x 8), K = (channel group u, tap
// j) flattened as q = u k + j, two groups per k16 step. A's core matrices
// are 8 consecutive samples of one group's plane, so tap j of group u for a
// tile from p0 starts at row p0 - half + j d of plane u, and the step's
// second K column (the next group) lies at a positive offset from its first:
// d rows on in the same plane, or the next plane's tap 0. Warpgroup wg takes
// the 64-sample tiles wg, wg + 3, ...; a ragged tile's rows past hi read
// rows below hi + 64 + half (H holds them) and are discarded. A tile's wgmma
// issue back to back under one commit, then the epilogue.
template <int NT>
__device__ __forceinline__ void conv_mma(const MmaArgs& m, const bf16* H, uint32_t W, int lo,
                                         int hi, int k, int d, const float* bias, int mode,
                                         float* RES, bf16* G, float* ACC, bf16* out, int t0) {
  const StageArgs& a = m.s;
  const int C = a.C, NP = m.NP, R = a.R;
  constexpr uint32_t GROUP_BYTES = NT * 8 * 16;
  const uint32_t plane = m.HROWS * 16;
  const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int ng = (C + 7) / 8, nq = k * ng, steps = (nq + 1) / 2;
  const int half = (k - 1) / 2 * d;
  float bv[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = 8 * n + 2 * q4 + e;
      bv[n][e] = co < C ? __ldg(bias + co) : 0.f;
    }
  const int nmt = (hi - lo + 63) / 64;
  // the warpgroup's index, shown to the compiler to be warp-uniform, so that
  // the wgmma below do not count as on a divergent path
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
  for (int mt = wg; mt < nmt; mt += MMA_THREADS / 128) {
    const int p0 = lo + 64 * mt;
    const uint32_t row0 = smem_addr(H) + (p0 - half) * 16;  // plane 0, tap 0
    // no instruction but the wgmma writes acc before the wait (the first step
    // overwrites it), so the compiler need not fence between two steps
    float acc[4 * NT];
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    int u = 0, j = 0;  // group q = 2 s = u k + j
    for (int s = 0; s < steps; ++s) {
      const uint32_t first = row0 + u * plane + j * d * 16;
      int u1 = u, j1 = j + 1;
      if (j1 == k) { j1 = 0; ++u1; }
      // the group past nq (odd nq) meets zero weights: any rows will do
      const uint32_t lbo = 2 * s + 1 < nq ? row0 + u1 * plane + j1 * d * 16 - first : 16;
      wgmma_tile<NT>(acc, kmajor_desc(first, lbo), kmajor_desc(W + s * 2 * GROUP_BYTES, GROUP_BYTES),
                     s > 0);
      j += 2;
      if (j >= k) { j -= k; ++u; }
      if (j >= k) { j -= k; ++u; }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_f<4 * NT>(acc);
    // acc[4 n + 2 hh + e]: sample 16 w + g + 8 hh of the tile, channel 8 n + 2 q4 + e.
    // Every shared-memory read of the epilogue is issued before its first
    // store, so the reads overlap rather than wait each for the last store.
    const int pw = p0 + 16 * w + g;
    if (mode == TO_G) {
#pragma unroll
      for (int i = 0; i < 4 * NT; ++i) {
        const int p = pw + 8 * ((i >> 1) & 1), co = 8 * (i >> 2) + 2 * q4 + (i & 1);
        if (p < hi && co < C) G[co * NP + p] = __float2bfloat16(acc[i] + bv[i >> 2][i & 1]);
      }
    } else {
      float r[4 * NT];
#pragma unroll
      for (int i = 0; i < 4 * NT; ++i) {
        const int p = pw + 8 * ((i >> 1) & 1), co = 8 * (i >> 2) + 2 * q4 + (i & 1);
        r[i] = p < hi && co < C ? RES[co * NP + p] : 0.f;
      }
      if (mode == TO_RES) {
#pragma unroll
        for (int i = 0; i < 4 * NT; ++i) {
          const int p = pw + 8 * ((i >> 1) & 1), co = 8 * (i >> 2) + 2 * q4 + (i & 1);
          if (p < hi && co < C) RES[co * NP + p] = r[i] + (acc[i] + bv[i >> 2][i & 1]);
        }
      } else {  // p in the centre: the resblock's output r + the conv
        float s[4 * NT];
#pragma unroll
        for (int i = 0; i < 4 * NT; ++i) {
          const int p = pw + 8 * ((i >> 1) & 1), co = 8 * (i >> 2) + 2 * q4 + (i & 1);
          s[i] = mode != TO_ACC_FIRST && a.nres > 1 && p < hi && co < C ? ACC[co * m.LP + p - R]
                                                                        : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4 * NT; ++i) {
          const int p = pw + 8 * ((i >> 1) & 1), co = 8 * (i >> 2) + 2 * q4 + (i & 1);
          if (p >= hi || co >= C) continue;
          const float res = r[i] + (acc[i] + bv[i >> 2][i & 1]);
          if (mode == TO_ACC_FIRST) {
            ACC[co * m.LP + p - R] = res;
          } else if (mode == TO_ACC) {
            ACC[co * m.LP + p - R] = s[i] + res;
          } else {
            const int t = t0 + p - R;
            if (t < a.T)
              out[(size_t)co * a.T + t] =
                  __float2bfloat16((a.nres > 1 ? s[i] + res : res) / (float)a.nres);
          }
        }
      }
    }
  }
}

// FAST (the polynomial cos) is a template parameter: chosen at run time
// instead, the exact cos's call stays in the activation's loop, and the
// kernel ran 16-19 % slower at the serving shapes on an H100, for 13 s less
// of nvcc.
template <int NT, bool FAST>
__global__ void __launch_bounds__(MMA_THREADS, 1) amp_stage_mma_kernel(const MmaArgs m) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const StageArgs& a = m.s;
  const int C = a.C, N = a.N, L = a.L, R = a.R, T = a.T;
  const int t0 = blockIdx.x * L, base = t0 - R;
  const int ng = (C + 7) / 8;
  constexpr int GROUP_BYTES = NT * 8 * 16;
  const uint32_t W = smem_addr(smem_raw);                       // one conv's packed weights
  bf16* H = reinterpret_cast<bf16*>(smem_raw + m.wbytes);       // conv inputs, ng x HROWS x 8
  float* RES = reinterpret_cast<float*>(H + ng * m.HROWS * 8);  // residual stream, C x NP
  float* ACC = RES + C * m.NP;                                // resblock sum, C x LP
  bf16* G = reinterpret_cast<bf16*>(ACC + C * m.LP);          // first conv's output, C x NP
  const bf16* x = static_cast<const bf16*>(a.x) + (size_t)blockIdx.y * C * T;
  bf16* out = static_cast<bf16*>(a.out) + (size_t)blockIdx.y * C * T;
  const bool edge = base < 0 || base + N > T;
  const bf16* w = m.wq;  // the next conv's packed weights
  stage_weights(W, w, conv_groups(a.ks[0], ng) * GROUP_BYTES);
  // H's pad channels and rows enter the mma (against zero weights, or into
  // discarded samples): zero them once
  for (int i = threadIdx.x; i < ng * m.HROWS; i += MMA_THREADS)
    reinterpret_cast<uint4*>(H)[i] = make_uint4(0, 0, 0, 0);

  for (int bi = 0; bi < a.nres; ++bi) {
    const int k = a.ks[bi];
    const int cbytes = conv_groups(k, ng) * GROUP_BYTES;
    int rk = 0;
    for (int si = 0; si < a.nsub; ++si) rk += 12 + (k - 1) / 2 * a.ds[si] + (k - 1) / 2;
    int lo = R - rk, hi = N - (R - rk);
    load_x(m, x, RES, lo, hi, base);
    __syncthreads();
    for (int si = 0; si < a.nsub; ++si) {
      const int d = a.ds[si];
      const float* v = a.vec + (size_t)(bi * a.nsub + si) * 6 * C;
      if (edge)
        act_mma<float, FAST, true>(m, RES, H, lo + 6, hi - 6, v, v + C, base);
      else
        act_mma<float, FAST, false>(m, RES, H, lo + 6, hi - 6, v, v + C, base);
      lo += 6; hi -= 6;
      weights_ready();
      const int h1 = (k - 1) / 2 * d;
      conv_mma<NT>(m, H, W, lo + h1, hi - h1, k, d, v + 2 * C, TO_G, RES, G, ACC, out, t0);
      lo += h1; hi -= h1;
      w += cbytes / 2;
      __syncthreads();
      stage_weights(W, w, cbytes);
      if (edge)
        act_mma<bf16, FAST, true>(m, G, H, lo + 6, hi - 6, v + 3 * C, v + 4 * C, base);
      else
        act_mma<bf16, FAST, false>(m, G, H, lo + 6, hi - 6, v + 3 * C, v + 4 * C, base);
      lo += 6; hi -= 6;
      weights_ready();
      const int h2 = (k - 1) / 2;
      const bool last = si == a.nsub - 1;
      const int mode = !last ? TO_RES : bi == a.nres - 1 ? TO_OUT : bi == 0 ? TO_ACC_FIRST : TO_ACC;
      conv_mma<NT>(m, H, W, lo + h2, hi - h2, k, 1, v + 5 * C, mode, RES, G, ACC, out, t0);
      lo += h2; hi -= h2;  // after the last sub-unit: lo == R, hi == N - R, the tile centre
      w += cbytes / 2;
      __syncthreads();
      if (!last)
        stage_weights(W, w, cbytes);
      else if (bi + 1 < a.nres)
        stage_weights(W, w, conv_groups(a.ks[bi + 1], ng) * GROUP_BYTES);
    }
  }
}

template <int NT, bool FAST>
static int launch_mma(const MmaArgs& m, int B, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(amp_stage_mma_kernel<NT, FAST>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m.s.T + m.s.L - 1) / m.s.L, B);
  amp_stage_mma_kernel<NT, FAST><<<grid, MMA_THREADS, smem, stream>>>(m);
  return (int)cudaGetLastError();
}

template <int NT>
static int launch_nt(const MmaArgs& m, int B, size_t smem, cudaStream_t stream) {
  return m.s.fast ? launch_mma<NT, true>(m, B, smem, stream)
                  : launch_mma<NT, false>(m, B, smem, stream);
}

// bf16 x and out on the tensor-core kernel; wq: every conv's weights as
// nn/amp_stage.py:pack_stage packs them. L: nn/amp_stage.py:pick_tile_mma's
// tile, a multiple of 8, and the shared-memory size is its smem_bytes_mma
// (the gpu test launches every C up to 64). Returns the CUDA error code of
// the launch.
extern "C" int amp_stage_mma_launch(const void* x, void* out, const void* wq, const float* vec,
                                    int B, int C, int T, int L, int R, int nres, int nsub,
                                    const int* ks, const int* ds, int fast, const float* taps,
                                    void* stream) {
  MmaArgs m;
  if (!fill_args(m.s, x, out, vec, C, T, L, R, nres, nsub, ks, ds, fast, taps) ||
      C > 8 * MMA_MAX_NT || L % 8 != 0 || B > 65535 || reinterpret_cast<uintptr_t>(wq) % 16)
    return (int)cudaErrorInvalidValue;
  const int N = m.s.N, ng = (C + 7) / 8;
  int kmax = 1;
  for (int i = 0; i < nres; ++i) kmax = ks[i] > kmax ? ks[i] : kmax;
  m.wq = static_cast<const bf16*>(wq);
  m.NP = N + ((4 - N) % 8 + 8) % 8;
  m.HROWS = N + 64 + ((1 - (N + 64)) % 8 + 8) % 8;
  m.LP = L + 4;
  m.wbytes = (kmax * ng + 1) / 2 * 2 * ng * 8 * 16;
  m.vec_x = T % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const size_t smem = (size_t)m.wbytes + (size_t)16 * ng * m.HROWS +
                      sizeof(float) * (size_t)C * (m.NP + m.LP) + sizeof(bf16) * (size_t)C * m.NP +
                      SMEM_SLACK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ng) {
    case 1: return launch_nt<1>(m, B, smem, s);
    case 2: return launch_nt<2>(m, B, smem, s);
    case 3: return launch_nt<3>(m, B, smem, s);
    case 4: return launch_nt<4>(m, B, smem, s);
    case 5: return launch_nt<5>(m, B, smem, s);
    case 6: return launch_nt<6>(m, B, smem, s);
    case 7: return launch_nt<7>(m, B, smem, s);
    default: return launch_nt<8>(m, B, smem, s);
  }
}
