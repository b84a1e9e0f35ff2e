// Flash self-attention for Hopper (sm_90a).
//
// Replaces the TPU kernel audiolcm_tpu/nn/pallas_attention.py:72
// flash_attention (_flash_kernel): out = softmax(q k^T * scale) v over
// (B, H, T, D), blockwise with the online softmax, so the T x T logits never
// reach device memory. Numerics as the TPU kernel: q, k and v are widened to
// f32, q is scaled before the dot, logits / running max / running sum / P.V
// are f32, keys >= T are masked to -1e30, and the output is
// acc / max(l, 1e-30) rounded once to q's type. Query rows >= T are never
// written.
//
// What bounds it on this card: at the DiT's shapes (T = 467, D = 72) bytes:
// q, k, v read once and the output written once is 8*B*H*T*D bytes in bf16,
// against 4*B*H*T^2*D FLOP at the bf16 tensor-core rate. This first kernel
// runs both products on CUDA cores in f32, so it is bound instead by the
// shared-memory reads and FMAs of its inner loops, far above either bound;
// tensor cores (mma/wgmma over bf16 q, k and P with D padded to 80) and TMA
// are later work.
//
// What the design does about it:
//   * one thread block per (64 query rows, b*h); four threads per query row,
//     each owning DPT = D/4 (rounded up) contiguous head dimensions of q
//     (pre-scaled) and of the f32 accumulator in registers; the four partial
//     dot products meet by two warp shuffles;
//   * K and V tiles of 64 keys are staged in shared memory as f32, zero
//     padded to 4*DPT dimensions and past T; all threads of a warp read one
//     key row at a time (a broadcast), the four owners of a row read four
//     disjoint float2 runs, so the reads are conflict-free;
//   * the online softmax runs over chunks of 16 keys: 16 logits in
//     registers, one rescale of the accumulator per chunk; chunks that lie
//     wholly past T are skipped (their p would be exactly 0);
//   * q, k, v and out are addressed through explicit (b, h, t, d) element
//     strides, so head-split transposes and the chunk views of a fused qkv
//     projection need no copy, and the output can be written straight into
//     the (B, T, H, D) layout the output projection reads.
//
// Plain C interface, loaded with ctypes (audiolcm_torch/nn/flash_attention.py).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define BQ 64                 // query rows per block
#define BK 64                 // keys per shared-memory tile
#define KC 16                 // keys per online-softmax chunk
#define NTHREADS (4 * BQ)     // four threads per query row
#define NEG_INF (-1e30f)

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long sq[4], sk[4], sv[4], so[4];  // element strides over (b, h, t, d)
  int H, T, D;
  float scale;
};

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

template <typename IO, int DPT>
__global__ void __launch_bounds__(NTHREADS)
flash_attention_kernel(const FlashArgs a) {
  constexpr int DP = 4 * DPT;  // padded head dimension in shared memory
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * DP;

  const int T = a.T, D = a.D;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int row = blockIdx.x * BQ + threadIdx.x / 4;
  const int sub = threadIdx.x % 4;
  const int d0 = sub * DPT;

  const IO* qp = static_cast<const IO*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const IO* kp = static_cast<const IO*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const IO* vp = static_cast<const IO*>(a.v) + b * a.sv[0] + h * a.sv[1];

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = d0 + j;
    qr[j] = (row < T && d < D) ? load_f<IO>(qp + row * a.sq[2] + d * a.sq[3]) * a.scale : 0.f;
    acc[j] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  for (int k0 = 0; k0 < T; k0 += BK) {
    const int nk = min(BK, T - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < BK * DP; idx += NTHREADS) {
      const int key = idx / DP, d = idx % DP;
      float kv = 0.f, vv = 0.f;
      if (key < nk && d < D) {
        kv = load_f<IO>(kp + (k0 + key) * a.sk[2] + d * a.sk[3]);
        vv = load_f<IO>(vp + (k0 + key) * a.sv[2] + d * a.sv[3]);
      }
      Ks[idx] = kv;
      Vs[idx] = vv;
    }
    __syncthreads();

    for (int c0 = 0; c0 < nk; c0 += KC) {
      float s[KC];
      float mc = NEG_INF;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float2* kr = reinterpret_cast<const float2*>(Ks + (c0 + kk) * DP + d0);
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < DPT / 2; ++j) {
          const float2 kv = kr[j];
          part = fmaf(qr[2 * j], kv.x, part);
          part = fmaf(qr[2 * j + 1], kv.y, part);
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        s[kk] = (c0 + kk < nk) ? part : NEG_INF;
        mc = fmaxf(mc, s[kk]);
      }
      const float m_new = fmaxf(m, mc);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[j] *= alpha;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float p = expf(s[kk] - m_new);
        psum += p;
        const float2* vr = reinterpret_cast<const float2*>(Vs + (c0 + kk) * DP + d0);
#pragma unroll
        for (int j = 0; j < DPT / 2; ++j) {
          const float2 vv = vr[j];
          acc[2 * j] = fmaf(p, vv.x, acc[2 * j]);
          acc[2 * j + 1] = fmaf(p, vv.y, acc[2 * j + 1]);
        }
      }
      l = alpha * l + psum;
      m = m_new;
    }
  }

  if (row < T) {
    IO* op = static_cast<IO*>(a.out) + b * a.so[0] + h * a.so[1] + row * a.so[2];
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = d0 + j;
      if (d < D) store_f<IO>(op + d * a.so[3], acc[j] / den);
    }
  }
}

template <typename IO, int DPT>
static int launch(const FlashArgs& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * BK * 4 * DPT;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<IO, DPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.T + BQ - 1) / BQ, B * a.H);
  flash_attention_kernel<IO, DPT><<<grid, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename IO>
static int launch_d(const FlashArgs& a, int B, cudaStream_t stream) {
  // the smallest instantiated DPT with 4*DPT >= D; the rest is zero padding
  if (a.D <= 8) return launch<IO, 2>(a, B, stream);
  if (a.D <= 32) return launch<IO, 8>(a, B, stream);
  if (a.D <= 64) return launch<IO, 16>(a, B, stream);
  if (a.D <= 72) return launch<IO, 18>(a, B, stream);
  if (a.D <= 128) return launch<IO, 32>(a, B, stream);
  return (int)cudaErrorInvalidValue;
}

// Returns the CUDA error code of the launch (0 = launched).
// strides: 16 element strides, (b, h, t, d) of q, k, v and out in that order.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      const long long* strides, int B, int H, int T, int D,
                                      float scale, int is_bf16, void* stream) {
  if (B < 1 || H < 1 || T < 1 || D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  FlashArgs a;
  a.q = q; a.k = k; a.v = v; a.out = out;
  for (int i = 0; i < 4; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[4 + i];
    a.sv[i] = strides[8 + i];
    a.so[i] = strides[12 + i];
  }
  a.H = H; a.T = T; a.D = D; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_d<__nv_bfloat16>(a, B, s) : launch_d<float>(a, B, s);
}
