// Chain of alias-free SnakeBeta activations for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/profile_stage_interior.py:110 act_only_fn,
// the profiling micro-kernel that times one alias-free SnakeBeta unit (2x
// up-FIR -> snake -> 2x down-FIR) of the fused AMP stage alone: n_rep
// chained "valid" activations on the edge-padded input, centre columns
// written out. out (B, C, T) = n_rep activations of x (B, T, C) with x read
// at clamp(t, 0, T-1), which is the JAX tool's mode="edge" pad.
//
// What bounds it on this card: the published-peak convention makes it
// bytes (B*C*T elements read once and written once; ~78 FLOP per sample
// and activation, below the ridge point even at n_rep 6). On CUDA cores in
// f32 the arithmetic and the shared-memory traffic of the 6-tap FIRs are
// what this first kernel actually spends its time on.
//
// What the design does about it:
//   * the activation is depthwise, so one thread block owns ACT_CG channels
//     of one (batch element, time tile) and nothing else: the grid has
//     enough blocks to fill the card at any C;
//   * the block reads its window of tile + 2*6*n_rep samples once, with
//     clamped global reads, so there is no padded copy and the halo is the
//     chain's own receptive radius, not a rounded one;
//   * the chain runs in shared memory in f32: each activation writes its
//     snaked even/odd up-sampled phases (E, O) and then its down-FIR output
//     back over the input row (A), its valid range shrinking by 6 per side;
//   * the result is rounded once to the output type; a ragged last tile is
//     masked.
//
// Plain C interface, loaded with ctypes (audiolcm_torch/nn/act_chain.py).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libact_chain.so act_chain.cu

#include "snake_act.cuh"

#define NTHREADS 256
#define ACT_CG 8  // channels per block; must match nn/act_chain.py

struct ChainArgs {
  const void* x;         // (B, T, C) with element strides sb, st, sc
  void* out;             // (B, C, T) contiguous, same type
  const float* vec;      // alpha[C], then 1/(beta+1e-9)[C]
  long long sb, st, sc;
  int C, T, L, H, N, S;  // tile, halo 6*n_rep, window L+2H, row stride
  int nrep, fast;
  float up_e[6], up_o[6], dn_e[6], dn_o[6];
};

template <typename IO>
__global__ void __launch_bounds__(NTHREADS) act_chain_kernel(ChainArgs a) {
  extern __shared__ float smem[];
  const int C = a.C, T = a.T, L = a.L, H = a.H, N = a.N, S = a.S;
  float* A = smem;            // the chain's signal, ACT_CG rows of S
  float* E = A + ACT_CG * S;  // snaked even up-phase
  float* O = E + ACT_CG * S;  // snaked odd up-phase
  const int t0 = blockIdx.x * L, base = t0 - H;
  const int c0 = blockIdx.y * ACT_CG, b = blockIdx.z;
  const int gc = min(ACT_CG, C - c0);
  const IO* x = static_cast<const IO*>(a.x) + (size_t)b * a.sb + (size_t)c0 * a.sc;

  // window load, channel fastest (x is channels-last): local i <-> global
  // position clamp(base + i, 0, T - 1)
  for (int idx = threadIdx.x; idx < ACT_CG * N; idx += NTHREADS) {
    const int c = idx % ACT_CG, i = idx / ACT_CG;
    const int g = clampi(base + i, 0, T - 1);
    A[c * S + i] = c < gc ? load_f<IO>(x + (size_t)g * a.st + (size_t)c * a.sc) : 0.f;
  }
  __syncthreads();

  for (int r = 0; r < a.nrep; ++r) {
    // A is valid over [6r, N-6r); this activation's output over [lo, hi)
    const int lo = 6 * (r + 1), hi = N - 6 * (r + 1);
    const int n1 = hi - lo + 6, n2 = hi - lo;
    // pass 1: snaked up-phases over [lo-3, hi+3)
    for (int idx = threadIdx.x; idx < gc * n1; idx += NTHREADS) {
      const int c = idx / n1, i = lo - 3 + idx % n1;
      const float* row = A + c * S + i;
      float ue = 0.f, uo = 0.f;
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        ue += a.up_e[d] * row[d - 3];
        uo += a.up_o[d] * row[d - 2];
      }
      const float al = __ldg(a.vec + c0 + c), bi = __ldg(a.vec + C + c0 + c);
      E[c * S + i] = snake(ue, al, bi, a.fast);
      O[c * S + i] = snake(uo, al, bi, a.fast);
    }
    __syncthreads();
    // pass 2: down-FIR over [lo, hi), written back into A
    for (int idx = threadIdx.x; idx < gc * n2; idx += NTHREADS) {
      const int c = idx / n2, i = lo + idx % n2;
      const float* o = O + c * S + i;
      const float* e = E + c * S + i;
      float ye = 0.f, yo = 0.f;
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        ye += a.dn_e[d] * o[d - 3];
        yo += a.dn_o[d] * e[d - 2];
      }
      A[c * S + i] = ye + yo;
    }
    __syncthreads();
  }

  // the tile centre [H, H + L), time fastest (out is channels-first)
  IO* out = static_cast<IO*>(a.out) + ((size_t)b * C + c0) * T;
  for (int idx = threadIdx.x; idx < gc * L; idx += NTHREADS) {
    const int c = idx / L, i = idx % L, g = t0 + i;
    if (g < T) store_f<IO>(out + (size_t)c * T + g, A[c * S + H + i]);
  }
}

template <typename IO>
static int launch(const ChainArgs& a, int B, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(act_chain_kernel<IO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.T + a.L - 1) / a.L, (a.C + ACT_CG - 1) / ACT_CG, B);
  act_chain_kernel<IO><<<grid, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Returns the CUDA error code of the launch (0 = launched).
// taps: 24 floats, up_even[6], up_odd[6], down_even[6], down_odd[6].
extern "C" int act_chain_launch(const void* x, void* out, const float* vec, int B, int C, int T,
                                long long sb, long long st, long long sc, int L, int nrep,
                                int fast, int is_bf16, const float* taps, void* stream) {
  if (nrep < 1 || L < 1 || B < 1 || C < 1 || T < 1) return (int)cudaErrorInvalidValue;
  ChainArgs a;
  a.x = x; a.out = out; a.vec = vec;
  a.sb = sb; a.st = st; a.sc = sc;
  a.C = C; a.T = T; a.L = L; a.H = 6 * nrep; a.N = L + 2 * a.H;
  a.S = a.N | 1;  // odd row stride: the channel-fastest load hits distinct banks
  a.nrep = nrep; a.fast = fast;
  for (int i = 0; i < 6; ++i) {
    a.up_e[i] = taps[i]; a.up_o[i] = taps[6 + i];
    a.dn_e[i] = taps[12 + i]; a.dn_o[i] = taps[18 + i];
  }
  const size_t smem = sizeof(float) * 3 * ACT_CG * (size_t)a.S;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, B, smem, s) : launch<float>(a, B, smem, s);
}
