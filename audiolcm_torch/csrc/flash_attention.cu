// Flash attention for Hopper (sm_90a): two kernels in one source.
//
// Replaces the TPU kernel audiolcm_tpu/nn/pallas_attention.py:72
// flash_attention (_flash_kernel): out = softmax(q k^T * scale) v over
// q (B, H, T, D) and k, v (B, H, Tk, D), blockwise with the online softmax,
// so the T x Tk logits never reach device memory. Self-attention has
// Tk = T; a cross-attention (the Flag DiT's caption branch: 312 queries
// against 154 keys) has its own Tk, and every key loop, tile count and
// mask below runs over Tk, every query row over T. Keys >= Tk are masked to
// -1e30, the output is acc / max(l, 1e-30) rounded once to q's type, and
// query rows >= T are never written. q, k, v and out are addressed
// through explicit (b, h, t, d) element strides, so head-split transposes
// and the chunk views of a fused qkv projection need no copy, and the
// output goes straight into the (B, T, H, D) layout the output projection
// reads.
//
// What bounds it on this card: at the DiTs' shapes (T = 467 or 312,
// Tk = T or 154, D = 72) bytes: q, k, v read once and the output written
// once is 2*B*H*(2T + 2Tk)*D bytes in bf16, against 4*B*H*T*Tk*D FLOP at
// the bf16 tensor-core rate.
//
// bf16 (flash_attention_tc_kernel, FlashAttention-2's shape on the tensor
// cores, mma.sync m16n8k16 bf16 -> f32 with ldmatrix):
//   * one block of 8 warps per (128 query rows, b*h); each warp owns 16
//     query rows. Q is staged once in shared memory and its A-fragments are
//     re-read there per tile, so a thread needs <= 128 registers and two
//     blocks (16 warps) fit on an SM; D is zero-padded to 16*KS for the
//     Q.K^T k-steps (72 -> 80, 5 steps) and to 8*NV for the n8 tiles of P.V
//     (72 = 9 tiles, no pad);
//   * K and V tiles of 64 keys in a two-stage shared-memory ring, filled by
//     16-byte cp.async copies, so tile j+1 loads while tile j computes; keys
//     >= Tk are zero-filled (src-size 0) and their logits set to -1e30;
//     shared rows are (2*KS+1)*16 bytes apart (176 B at D = 72), an odd
//     number of 16-byte units, so the 8 rows of an ldmatrix hit 8 distinct
//     bank groups; V's B-fragments come from ldmatrix.trans;
//   * the raw bf16 dot (exact products, f32 sums) is scaled in f32 (scale
//     and log2(e) folded into one multiply before ex2): q is not rounded
//     after scaling, as it would be if pre-scaled in bf16;
//   * online softmax in registers: one rescale per 64-key tile, the row max
//     reduced across the quad with __shfl_xor_sync, l the sum of the
//     unrounded f32 p (quad-reduced once at the end);
//   * P is re-packed from the S accumulators into A-fragments in registers
//     and enters P.V as p_hi = bf16(p) and p_lo = bf16(p - p_hi), two mma
//     into one f32 accumulator: p keeps ~16 bits, so the bf16 route keeps
//     the plain version's numerics up to f32 reassociation (one bf16 P
//     would add a rounding the size of the input rounding); the split is
//     1.5x the function's FLOP;
//   * the epilogue stages the warp's rows through its own Q rows in shared
//     memory and stores 16-byte chunks;
//   * VEC = true takes q, k, v, out with d-stride 1, D % 8 == 0 and 16-byte
//     aligned bases and strides (the DiT's head splits and to_qkv chunk
//     views); VEC = false loads and stores element by element through the
//     strides, for any other layout. The wrapper picks one explicitly.
// At (16, 8, 467, 72) it runs ~7x its bytes bound: the warps' mma, softmax
// and loads do not overlap enough at 16 warps per SM (PERF.md, K3).
//
// f32 (flash_attention_f32_kernel, CUDA cores; carries the f32 parity
// checks, no generate path runs it): four threads per query row, each owning
// D/4 (rounded up) dims of q (pre-scaled in f32) and of the accumulator; K
// and V tiles staged in shared memory as f32; online softmax over chunks of
// 16 keys.
//
// Plain C interface, loaded with ctypes (audiolcm_torch/nn/flash_attention.py).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BQ 64                 // query rows per block of the f32 kernel
#define BK 64                 // keys per shared-memory tile (both kernels)
#define NEG_INF (-1e30f)

// route codes of flash_attention_launch (nn/flash_attention.py ROUTES)
#define ROUTE_F32 0
#define ROUTE_TC_VEC 1
#define ROUTE_TC_ELEMENTWISE 2

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long sq[4], sk[4], sv[4], so[4];  // element strides over (b, h, t, d)
  int H, T, Tk, D;  // T queries, Tk keys and values
  float scale;
};

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

#define KC 16                 // keys per online-softmax chunk
#define F32_THREADS (4 * BQ)  // four threads per query row

template <int DPT>
__global__ void __launch_bounds__(F32_THREADS)
flash_attention_f32_kernel(const FlashArgs a) {
  constexpr int DP = 4 * DPT;  // padded head dimension in shared memory
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * DP;

  const int T = a.T, D = a.D;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int row = blockIdx.x * BQ + threadIdx.x / 4;
  const int sub = threadIdx.x % 4;
  const int d0 = sub * DPT;

  const float* qp = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const float* kp = static_cast<const float*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const float* vp = static_cast<const float*>(a.v) + b * a.sv[0] + h * a.sv[1];

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = d0 + j;
    qr[j] = (row < T && d < D) ? qp[row * a.sq[2] + d * a.sq[3]] * a.scale : 0.f;
    acc[j] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  for (int k0 = 0; k0 < a.Tk; k0 += BK) {
    const int nk = min(BK, a.Tk - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < BK * DP; idx += F32_THREADS) {
      const int key = idx / DP, d = idx % DP;
      float kv = 0.f, vv = 0.f;
      if (key < nk && d < D) {
        kv = kp[(k0 + key) * a.sk[2] + d * a.sk[3]];
        vv = vp[(k0 + key) * a.sv[2] + d * a.sv[3]];
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
    float* op = static_cast<float*>(a.out) + b * a.so[0] + h * a.so[1] + row * a.so[2];
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = d0 + j;
      if (d < D) op[d * a.so[3]] = acc[j] / den;
    }
  }
}

template <int DPT>
static int launch_f32(const FlashArgs& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * BK * 4 * DPT;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_f32_kernel<DPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.T + BQ - 1) / BQ, B * a.H);
  flash_attention_f32_kernel<DPT><<<grid, F32_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

static int launch_f32_d(const FlashArgs& a, int B, cudaStream_t stream) {
  // the smallest instantiated DPT with 4*DPT >= D; the rest is zero padding
  if (a.D <= 8) return launch_f32<2>(a, B, stream);
  if (a.D <= 32) return launch_f32<8>(a, B, stream);
  if (a.D <= 64) return launch_f32<16>(a, B, stream);
  if (a.D <= 72) return launch_f32<18>(a, B, stream);
  return launch_f32<32>(a, B, stream);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

#define TC_WARPS 8                   // warps per block, 16 query rows each
#define TC_THREADS (32 * TC_WARPS)
#define TC_BQ (16 * TC_WARPS)        // query rows per block
#define TC_MIN_BLOCKS 2              // 16 warps per SM: <= 128 registers a thread

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the SFU (ex2.approx.ftz: ~2 ulp, subnormal results flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16-byte async copy; n = 0 writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (p0, p1) -> bf16 pairs hi = bf16(p) and lo = bf16(p - hi); p0 in the low half
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

// rows [r0, r0 + ROWS) of one (T, D) head, row stride st, d-stride sd,
// into dst (row stride LD): columns [0, 8*DC), zero past D and for rows >= T
template <bool VEC, int LD, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long st, long long sd,
                                          int r0, int T, int D) {
  const int DC = (D + 7) / 8;
  if constexpr (VEC) {
    for (int i = threadIdx.x; i < ROWS * DC; i += TC_THREADS) {
      const int r = i / DC, c = i % DC;
      const bool ok = r0 + r < T;
      const bf16* p = src + (ok ? (long long)(r0 + r) * st : 0LL) + 8 * c;
      cp_async16(smem_addr(dst + r * LD + 8 * c), p, ok ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < ROWS * 8 * DC; i += TC_THREADS) {
      const int r = i / (8 * DC), d = i % (8 * DC);
      dst[r * LD + d] = (r0 + r < T && d < D) ? src[(long long)(r0 + r) * st + d * sd] : zero;
    }
  }
}

template <int NV, bool VEC>
__global__ void __launch_bounds__(TC_THREADS, TC_MIN_BLOCKS)
flash_attention_tc_kernel(const FlashArgs a) {
  constexpr int KS = (NV + 1) / 2;   // k16 steps of Q.K^T: D padded to 16*KS
  constexpr int LD = 16 * KS + 8;    // shared row stride (elements): (2*KS+1)*16 bytes
  constexpr int TILE = BK * LD;      // one K or V stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TC_BQ * LD;  // two stages
  bf16* Vs = Ks + 2 * TILE;    // two stages

  const int T = a.T, Tk = a.Tk, D = a.D;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int q0 = blockIdx.x * TC_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group, column pair

  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.sv[0] + h * a.sv[1];

  // the pad columns [8*DC, LD) of Q and the four K/V stages: no load writes them
  {
    const int DC = (D + 7) / 8, pad = LD / 8 - DC;
    for (int i = threadIdx.x; i < (TC_BQ + 4 * BK) * pad; i += TC_THREADS)
      *reinterpret_cast<uint4*>(Qs + (i / pad) * LD + 8 * (DC + i % pad)) = make_uint4(0, 0, 0, 0);
  }
  load_rows<VEC, LD, TC_BQ>(Qs, qp, a.sq[2], a.sq[3], q0, T, D);
  load_rows<VEC, LD, BK>(Ks, kp, a.sk[2], a.sk[3], 0, Tk, D);
  load_rows<VEC, LD, BK>(Vs, vp, a.sv[2], a.sv[3], 0, Tk, D);
  cp_async_commit();

  // ldmatrix lane offsets: A (Q) rows/cols, K's B pairs, V's transposed B pairs
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + (lane >> 4) * 8, k_col = ((lane >> 3) & 1) * 8;
  const bf16* qrow = Qs + (warp * 16 + a_row) * LD + a_col;

  const float sl2 = a.scale * 1.4426950408889634f;  // scale * log2(e)
  float o[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows g and g + 8

  const int n_tiles = (Tk + BK - 1) / BK;
  for (int j = 0; j < n_tiles; ++j) {
    const bf16* Kt = Ks + (j & 1) * TILE;
    const bf16* Vt = Vs + (j & 1) * TILE;
    if (j + 1 < n_tiles) {
      bf16* Kn = Ks + ((j + 1) & 1) * TILE;
      bf16* Vn = Vs + ((j + 1) & 1) * TILE;
      load_rows<VEC, LD, BK>(Kn, kp, a.sk[2], a.sk[3], (j + 1) * BK, Tk, D);
      load_rows<VEC, LD, BK>(Vn, vp, a.sv[2], a.sv[3], (j + 1) * BK, Tk, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, eight n8 tiles; Q's A-fragments
    // are re-read from shared memory (registers allow two blocks per SM)
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      ldsm_x4(smem_addr(qrow + kk * 16), qa);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        ldsm_x4(smem_addr(Kt + (np * 16 + k_row) * LD + kk * 16 + k_col), kb);
        mma16816(s[2 * np], qa, kb[0], kb[1]);
        mma16816(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }

    // scale in f32 (log2 domain), mask keys >= Tk, online softmax
    const bool tail = (j + 1) * BK > Tk;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= sl2;
        if (tail && j * BK + n * 8 + 2 * t4 + (e & 1) >= Tk) s[n][e] = NEG_INF;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float al0 = ex2(m0 - mx0), al1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = ex2(s[n][0] - mx0);
      s[n][1] = ex2(s[n][1] - mx0);
      s[n][2] = ex2(s[n][2] - mx1);
      s[n][3] = ex2(s[n][3] - mx1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }

    // O += P V with P = p_hi + p_lo, 16 keys per k-step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      const bf16* vrow = Vt + (kk * 16 + a_row) * LD;
#pragma unroll
      for (int np = 0; np < NV / 2; ++np) {
        uint32_t vb[4];
        ldsm_x4_t(smem_addr(vrow + np * 16 + a_col), vb);
        mma16816(o[2 * np], ph, vb[0], vb[1]);
        mma16816(o[2 * np + 1], ph, vb[2], vb[3]);
        mma16816(o[2 * np], pl, vb[0], vb[1]);
        mma16816(o[2 * np + 1], pl, vb[2], vb[3]);
      }
      if constexpr (NV % 2 == 1) {
        uint32_t vb[2];
        ldsm_x2_t(smem_addr(vrow + (NV - 1) * 8), vb);
        mma16816(o[NV - 1], ph, vb[0], vb[1]);
        mma16816(o[NV - 1], pl, vb[0], vb[1]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // epilogue: out = acc / max(l, 1e-30), rounded once, staged in the warp's
  // own Q rows (no other warp reads them)
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  bf16* Os = Qs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(Os + g * LD + n * 8 + 2 * t4) =
        __floats2bfloat162_rn(o[n][0] / den0, o[n][1] / den0);
    *reinterpret_cast<__nv_bfloat162*>(Os + (g + 8) * LD + n * 8 + 2 * t4) =
        __floats2bfloat162_rn(o[n][2] / den1, o[n][3] / den1);
  }
  __syncwarp();
  bf16* op = static_cast<bf16*>(a.out) + b * a.so[0] + h * a.so[1];
  const int r_base = q0 + warp * 16;
  if constexpr (VEC) {
    const int DC = D / 8;
    for (int i = lane; i < 16 * DC; i += 32) {
      const int r = i / DC, c = i % DC;
      if (r_base + r < T)
        *reinterpret_cast<uint4*>(op + (long long)(r_base + r) * a.so[2] + 8 * c) =
            *reinterpret_cast<const uint4*>(Os + r * LD + 8 * c);
    }
  } else {
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = i / D, d = i % D;
      if (r_base + r < T) op[(long long)(r_base + r) * a.so[2] + d * a.so[3]] = Os[r * LD + d];
    }
  }
}

template <int NV, bool VEC>
static int launch_tc(const FlashArgs& a, int B, cudaStream_t stream) {
  constexpr int LD = 16 * ((NV + 1) / 2) + 8;
  const size_t smem = sizeof(bf16) * (TC_BQ + 4 * BK) * LD;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_tc_kernel<NV, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.T + TC_BQ - 1) / TC_BQ, B * a.H);
  flash_attention_tc_kernel<NV, VEC><<<grid, TC_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool VEC>
static int launch_tc_d(const FlashArgs& a, int B, cudaStream_t stream) {
  // the smallest instantiated NV with 8*NV >= D; the rest is zero padding
  const int nv = (a.D + 7) / 8;
  if (nv <= 1) return launch_tc<1, VEC>(a, B, stream);
  if (nv <= 2) return launch_tc<2, VEC>(a, B, stream);
  if (nv <= 4) return launch_tc<4, VEC>(a, B, stream);
  if (nv <= 6) return launch_tc<6, VEC>(a, B, stream);
  if (nv <= 8) return launch_tc<8, VEC>(a, B, stream);
  if (nv <= 9) return launch_tc<9, VEC>(a, B, stream);
  if (nv <= 12) return launch_tc<12, VEC>(a, B, stream);
  return launch_tc<16, VEC>(a, B, stream);
}

// the 16-byte route's preconditions on one tensor: d-stride 1, a 16-byte
// aligned base, and b/h/t strides in whole 16-byte units where they are used
static bool vec_ok(const void* p, const long long* s, int B, int H, int T) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s[3] == 1 && (B == 1 || s[0] % 8 == 0) &&
         (H == 1 || s[1] % 8 == 0) && (T == 1 || s[2] % 8 == 0);
}

// Returns the CUDA error code of the launch (0 = launched).
// strides: 16 element strides, (b, h, t, d) of q, k, v and out in that order;
// T counts the rows of q and out, Tk those of k and v.
// route: ROUTE_F32 (f32 tensors, CUDA cores), ROUTE_TC_VEC or
// ROUTE_TC_ELEMENTWISE (bf16 tensors, tensor cores).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      const long long* strides, int B, int H, int T, int Tk,
                                      int D, float scale, int route, void* stream) {
  if (B < 1 || H < 1 || T < 1 || Tk < 1 || D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  FlashArgs a;
  a.q = q; a.k = k; a.v = v; a.out = out;
  for (int i = 0; i < 4; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[4 + i];
    a.sv[i] = strides[8 + i];
    a.so[i] = strides[12 + i];
  }
  a.H = H; a.T = T; a.Tk = Tk; a.D = D; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case ROUTE_F32:
      return launch_f32_d(a, B, s);
    case ROUTE_TC_VEC:
      if (D % 8 != 0 || !vec_ok(q, a.sq, B, H, T) || !vec_ok(k, a.sk, B, H, Tk) ||
          !vec_ok(v, a.sv, B, H, Tk) || !vec_ok(out, a.so, B, H, T))
        return (int)cudaErrorInvalidValue;
      return launch_tc_d<true>(a, B, s);
    case ROUTE_TC_ELEMENTWISE:
      return launch_tc_d<false>(a, B, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
