// The resblock convs of BigVGAN's wide unfused stages for Hopper (sm_90a): K6.
//
// Replaces no Pallas kernel: the JAX package leaves these convs to XLA
// (audiolcm_tpu/models/bigvgan.py). Eager PyTorch ran each through cuDNN on
// channels-first bf16, with layout kernels around the call and separate
// element-wise passes for the resblock's residual and the stage's mean of
// resblocks. K6 is one launch per conv:
//
//   out (B, C, T) = (conv(a) + bias [+ res] [+ acc]) * scale
//   conv(a)[b, co, t] = sum_{j, ci} w[j, co, ci] * a[b, ci, t + (j - r) * dil],
//
// a, res, acc and out (B, C, T) contiguous bf16, w the conv weight permuted
// to (taps, C, C) bf16, r = (taps - 1) / 2 and zeros outside [0, T): the
// "same" padding of models/bigvgan.py's convs. The products sum in f32 in
// registers; the epilogue adds the bias and the optional residual and
// running resblock sum in f32, scales, and rounds once to bf16.
//
// What bounds it on this card: the tensor cores. A stage's 18 convs are
// 252 C^2 FLOP per sample; at (B, C, T) = (8, 768, 2496) that is ~1.5 ms at
// 989 TFLOP/s, against ~0.1 ms to read a and write out once. The design is an
// implicit GEMM per clip with time as M, output channels as N and
// (input-channel chunk, tap) as K:
//   * a block owns BM = 128 samples of one clip by N output channels (N from
//     a fixed table, 96..256, so that C = 768, 384, 192 and 96 split into
//     whole tiles); its two consumer warpgroups each keep a 64 x N f32 tile
//     in registers and issue wgmma m64nNk16 with A (the input) from
//     registers and B (the weights, K-major) from shared memory;
//   * one producer thread walks the K-steps (a 64-channel chunk of C_in
//     outer, the taps inner) and loads by TMA, per chunk, one input window
//     a[b, ci0:ci0+64, x0 : x0 + XWIN), x0 = t0 - r dil rounded down to a
//     multiple of 8 (TMA moves only 16-byte aligned rows), which every tap
//     of the chunk reads, and per K-step the weights' N x 64 tile (128-byte
//     swizzle); TMA fills what lies outside the clip or beyond C with zeros,
//     which is the convs' padding at both edges;
//   * the consumers read their A fragments from the window at the tap's
//     offset (t0 - r dil - x0) + j dil with 2-byte shared loads, which no
//     descriptor could express: 32 loads a thread per K-step against ~800
//     cycles of tensor-core work, at a window pitch that keeps them free of
//     bank conflicts; the fragments are double-buffered so that one K-step's
//     wgmma group stays in flight while the next one's loads run;
//   * full / empty mbarriers per weight stage and per window: the consumers
//     release weights once the wgmma group that read them has retired, a
//     window once the chunk's last fragments are in registers;
//   * blocks that share an input window are launched next to each other
//     (the output channel tile is the grid's fastest index), so the L2
//     serves its re-reads;
//   * what bounds it in practice, by a count of the bytes a K-step moves, is
//     shared memory: the weights' wgmma reads (64 bytes a cycle at the
//     tensor cores' rate), the fragment loads and the TMA writes together
//     come near its 128 bytes a cycle (PERF.md);
//   * the epilogue goes through shared memory (the idle ring), transposed to
//     channels-first, then 16-byte loads of the residual and running sum and
//     16-byte stores of out.
//
// Plain C interface, loaded with ctypes (audiolcm_torch/nn/wide_conv.py).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libwide_conv.so wide_conv.cu

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <initializer_list>

namespace {

// These must match nn/wide_conv.py.
constexpr int BK = 64;               // input channels per K-step
constexpr int BM = 128;              // samples per block: two consumer warpgroups of 64
constexpr int XWIN = 200;            // a window's samples: the tile and every tap's shift
constexpr int MAX_REACH = (XWIN - BM - 8) / 2;  // (taps - 1) / 2 * dil at most: 32
constexpr int XPITCH = XWIN * 2;     // bytes per window row (400: 16 mod 128, no conflicts)
constexpr int X_BYTES = BK * XPITCH; // one window (25 KiB)
constexpr int X_STAGES = 2;
constexpr int THREADS = 288;         // two consumer warpgroups and one producer warp
constexpr int EPI_PITCH = BM + 4;    // f32 words per row of the epilogue's tile

// clang-format off
// D (64 x N, f32, in registers) += A (64 x 16 bf16, in registers: a[0..3] as
// mma.m16n8k16's A fragment, warp w holding rows 16w..16w+15) * B (16 x N,
// K-major in shared memory, through its descriptor).
__device__ __forceinline__ void wgmma_n256(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n192(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n96(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// clang-format on

template <int N>
__device__ __forceinline__ void wgmma_tile(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (N == 256) wgmma_n256(d, a, db);
  else if constexpr (N == 192) wgmma_n192(d, a, db);
  else if constexpr (N == 128) wgmma_n128(d, a, db);
  else wgmma_n96(d, a, db);
}

// Keeps the compiler from moving registers that an in-flight wgmma reads or writes.
template <int K>
__device__ __forceinline__ void fence_f(float* d) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int K>
__device__ __forceinline__ void fence_u(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed; traps
// (an error the host sees, not a hung card) after SPIN_LIMIT failed polls.
constexpr uint32_t SPIN_LIMIT = 1u << 26;
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls > SPIN_LIMIT) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ uint32_t lds16(uint32_t addr) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(addr));
  return v;
}

// The K-major, 128-byte-swizzled descriptor of B: rows of 128 bytes, 8-row
// groups 1024 bytes apart (address, leading and stride offsets in 16 bytes).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

struct ConvArgs {
  const __nv_bfloat16* bias;  // (C,)
  const __nv_bfloat16* res;   // (B, C, T) or null
  const __nv_bfloat16* acc;   // (B, C, T) or null
  __nv_bfloat16* out;         // (B, C, T)
  int C, T, taps, dil;
  float scale;
};

// Blocks of N <= 96 hold few registers, so two fit an SM (one block's
// prologue and epilogue then overlap the other's main loop), each with half
// the shared memory. The ring: X_STAGES input windows (one per 64-channel
// chunk, read by every tap), then weight stages (one per K-step).
template <int N>
struct Tile {
  static constexpr int BLOCKS_PER_SM = N <= 96 ? 2 : 1;
  static constexpr int RING_BYTES = 200 * 1024 / BLOCKS_PER_SM;
  static constexpr int W_BYTES = N * BK * 2;
  static constexpr int W_STAGES_FIT = (RING_BYTES - X_STAGES * X_BYTES) / W_BYTES;
  static constexpr int W_STAGES = W_STAGES_FIT < 8 ? W_STAGES_FIT : 8;
  static constexpr int X_RING = W_STAGES * W_BYTES;  // offset of the windows
  static constexpr int BARRIERS = X_RING + X_STAGES * X_BYTES;
  static constexpr int SMEM = BARRIERS + 2 * 8 * (W_STAGES + X_STAGES) + 1024;
  static_assert(W_STAGES >= 2, "the weights need two stages at least");
  static_assert(W_BYTES % 1024 == 0 && X_BYTES % 1024 == 0, "stages must keep 1024-byte alignment");
  static_assert(N * EPI_PITCH * 4 <= BARRIERS, "the epilogue's tile must fit the ring");
};

// The ring's barriers: full / empty per weight stage, then per window.
struct Bars {
  uint32_t w_full, w_empty, x_full, x_empty;
};

// One K-step (chunk it / taps, tap j = it % taps) of one consumer warpgroup:
// at a chunk's first tap wait for its window, then for the step's weights;
// read the A fragments from the window at the tap's offset, issue the four
// wgmma of the chunk, commit; at the chunk's last tap release its window
// (the fragments are in registers); then retire the previous step's group
// and release its weights.
template <int N>
__device__ __forceinline__ void k_step(int it, float* d, uint32_t* a, uint32_t base, const Bars& bars,
                                       uint32_t frag_off, int e0, const ConvArgs& p, int lane) {
  constexpr int W_STAGES = Tile<N>::W_STAGES;
  const int chunk = it / p.taps, j = it - chunk * p.taps;
  const int xs = chunk % X_STAGES, s = it % W_STAGES;
  if (j == 0) mbar_wait(bars.x_full + 8 * xs, (chunk / X_STAGES) & 1);
  mbar_wait(bars.w_full + 8 * s, (it / W_STAGES) & 1);
  const uint32_t w_s = base + s * Tile<N>::W_BYTES;
  const uint32_t x_s = base + Tile<N>::X_RING + xs * X_BYTES + frag_off + 2 * (e0 + j * p.dil);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    // a[4kk + i]: rows (g, g + 8) x channels (2q, 2q + 1) and (2q + 8, 2q + 9)
    const uint32_t r0 = x_s + kk * 16 * XPITCH;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t at = r0 + (i & 1) * 16 + (i >> 1) * 8 * XPITCH;
      a[4 * kk + i] = __byte_perm(lds16(at), lds16(at + XPITCH), 0x5410);
    }
  }
  fence_u<16>(a);
  fence_f<N / 2>(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) wgmma_tile<N>(d, a + 4 * kk, b_desc(w_s + 32 * kk));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  fence_f<N / 2>(d);
  fence_u<16>(a);
  if (j == p.taps - 1) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bars.x_empty + 8 * xs);
  }
  if (it > 0) {
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_f<N / 2>(d);
    if (lane == 0) mbar_arrive(bars.w_empty + 8 * ((it - 1) % W_STAGES));
  }
}

// grid (ceil(C / N), ceil(T / BM), B); two consumer warpgroups, then one
// producer warp of which one thread issues the loads. With no producer
// warpgroup the register file splits over 288 threads: up to 224 registers a
// thread at one block per SM, all of them the consumers' to use.
template <int N>
__global__ void __launch_bounds__(THREADS, Tile<N>::BLOCKS_PER_SM)
    wide_conv_kernel(const __grid_constant__ CUtensorMap tm_w,
                     const __grid_constant__ CUtensorMap tm_x, const ConvArgs p) {
  constexpr int W_STAGES = Tile<N>::W_STAGES;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: stages start on that grid
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  Bars bars;
  bars.w_full = base + Tile<N>::BARRIERS;
  bars.w_empty = bars.w_full + 8 * W_STAGES;
  bars.x_full = bars.w_empty + 8 * W_STAGES;
  bars.x_empty = bars.x_full + 8 * X_STAGES;

  const int co0 = blockIdx.x * N, t0 = blockIdx.y * BM, b = blockIdx.z;
  const int chunks = (p.C + BK - 1) / BK, steps = chunks * p.taps;
  const int reach = (p.taps - 1) / 2 * p.dil;
  const int x0 = (t0 - reach) & ~7;  // the windows' start: 16-byte aligned
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(bars.w_full + 8 * s, 1);
      mbar_init(bars.w_empty + 8 * s, 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < X_STAGES; ++s) {
      mbar_init(bars.x_full + 8 * s, 1);
      mbar_init(bars.x_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer
    if (threadIdx.x == 256) {
      for (int chunk = 0, it = 0; chunk < chunks; ++chunk) {
        const int xs = chunk % X_STAGES, ci0 = chunk * BK;
        mbar_wait(bars.x_empty + 8 * xs, ((chunk / X_STAGES) & 1) ^ 1);
        mbar_expect_tx(bars.x_full + 8 * xs, X_BYTES);
        tma_load_3d(base + Tile<N>::X_RING + xs * X_BYTES, &tm_x, bars.x_full + 8 * xs, x0, ci0,
                    b);
        for (int j = 0; j < p.taps; ++j, ++it) {
          const int s = it % W_STAGES;
          mbar_wait(bars.w_empty + 8 * s, ((it / W_STAGES) & 1) ^ 1);
          mbar_expect_tx(bars.w_full + 8 * s, Tile<N>::W_BYTES);
          tma_load_3d(base + s * Tile<N>::W_BYTES, &tm_w, bars.w_full + 8 * s, ci0, co0, j);
        }
      }
    }
  } else {  // consumers: samples [64 wg, 64 wg + 64) of the tile
    const int lane = threadIdx.x % 32, w = (threadIdx.x % 128) / 32;
    const int g = lane / 4, q = lane % 4;
    // this thread's first fragment element: channel 2q, sample 64 wg + 16 w + g
    const uint32_t frag_off = 2 * q * XPITCH + 2 * (64 * wg + 16 * w + g);
    const int e0 = t0 - reach - x0;  // tap 0's offset into the windows: 0..7
    float d[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
    uint32_t a0[16], a1[16];
    for (int it = 0; it < steps; it += 2) {
      k_step<N>(it, d, a0, base, bars, frag_off, e0, p, lane);
      if (it + 1 < steps) k_step<N>(it + 1, d, a1, base, bars, frag_off, e0, p, lane);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_f<N / 2>(d);

    // epilogue. Both warpgroups are done with the ring (named barrier 1 over
    // the 256 consumer threads); d goes to shared memory as [channel][sample]
    // f32: d[4c + 2h + e] is sample 64 wg + 16 w + g + 8 h, channel 8 c + 2 q + e.
    asm volatile("bar.sync 1, 256;" ::: "memory");
    float* tile = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)));
    const int m = 64 * wg + 16 * w + g;
#pragma unroll
    for (int c = 0; c < N / 8; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tile[(8 * c + 2 * q + (i & 1)) * EPI_PITCH + m + 8 * (i >> 1)] = d[4 * c + i];
    asm volatile("bar.sync 1, 256;" ::: "memory");
    // 8 samples (16 bytes of out) a thread and turn
    for (int chunk = threadIdx.x; chunk < N * (BM / 8); chunk += 256) {
      const int n = chunk / (BM / 8), m8 = chunk % (BM / 8);
      const int co = co0 + n, t = t0 + 8 * m8;
      if (co >= p.C || t >= p.T) continue;
      const float4* src = reinterpret_cast<const float4*>(tile + n * EPI_PITCH + 8 * m8);
      const float4 lo = src[0], hi = src[1];
      float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      const float bias = __bfloat162float(p.bias[co]);
      const size_t off = (static_cast<size_t>(b) * p.C + co) * p.T + t;
#pragma unroll
      for (int src_i = 0; src_i < 2; ++src_i) {
        const __nv_bfloat16* add = src_i ? p.acc : p.res;
        if (add == nullptr) continue;
        const uint4 raw = *reinterpret_cast<const uint4*>(add + off);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(h[i]);
          v[2 * i] += f.x;
          v[2 * i + 1] += f.y;
        }
      }
      uint4 packed;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[i] = __floats2bfloat162_rn((v[2 * i] + bias) * p.scale, (v[2 * i + 1] + bias) * p.scale);
      *reinterpret_cast<uint4*>(p.out + off) = packed;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no -lcuda).
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q) == cudaSuccess
        && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 3-D bf16 tensor map (innermost dimension first) with boxes of
// box0 x box1 x 1; what lies outside the tensor reads as zero.
bool encode(CUtensorMap* map, const void* ptr, cuuint64_t d0, cuuint64_t d1, cuuint64_t d2,
            cuuint32_t box0, cuuint32_t box1, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
         == CUDA_SUCCESS;
}

template <int N>
int launch(const void* a, const void* w, const ConvArgs& p, int batch, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(wide_conv_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<N>::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap tm_w, tm_x;
  // the weights (taps, C, C) in 64-channel by N-row boxes, swizzled for wgmma;
  // the input (B, C, T) in windows of XWIN samples by 64 channels, unswizzled
  if (!encode(&tm_w, w, p.C, p.C, p.taps, BK, N, CU_TENSOR_MAP_SWIZZLE_128B)
      || !encode(&tm_x, a, p.T, p.C, batch, XWIN, BK, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  dim3 grid((p.C + N - 1) / N, (p.T + BM - 1) / BM, batch);
  wide_conv_kernel<N><<<grid, THREADS, Tile<N>::SMEM, stream>>>(tm_w, tm_x, p);
  return (int)cudaGetLastError();
}

}  // namespace

// `tile` is N, the output channels of a block: one of nn/wide_conv.py:TILES.
extern "C" int wide_conv_launch(const void* a, const void* w, const void* bias, const void* res,
                                const void* acc, void* out, int batch, int C, int T, int taps,
                                int dil, float scale, int tile, void* stream) {
  if (batch < 1 || batch > 65535 || C < 8 || C % 8 || T < 8 || T % 8 || taps < 1 || taps % 2 == 0
      || dil < 1 || (long long)(taps - 1) / 2 * dil > MAX_REACH || (long long)T + BM > INT_MAX / 2
      || (T + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  for (const void* ptr : {a, w, res, acc, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return (int)cudaErrorInvalidValue;
  ConvArgs p;
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.res = static_cast<const __nv_bfloat16*>(res);
  p.acc = static_cast<const __nv_bfloat16*>(acc);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.C = C;
  p.T = T;
  p.taps = taps;
  p.dil = dil;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 256: return launch<256>(a, w, p, batch, s);
    case 192: return launch<192>(a, w, p, batch, s);
    case 128: return launch<128>(a, w, p, batch, s);
    case 96: return launch<96>(a, w, p, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
