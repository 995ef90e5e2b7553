// Flash attention for Hopper's tensor cores (sm_90a): the forward, dK/dV
// and dQ kernels on `wgmma`, fed by TMA, for bfloat16 and float16 at head
// dims 64 and 128.
//
// Replaces, on that domain, the three Pallas TPU kernels of
// tpu_dist/ops/flash_attention.py (the SIMT kernels of flash_attention.cu
// take float32 and every other head dim):
//   flash_fwd_sm90_kernel <- `_flash_kernel` (:47): streaming softmax over
//                            key tiles; writes out and the per-row LSE.
//   flash_dkv_sm90_kernel <- `_dkv_kernel` (:184): one block per key tile,
//                            scanning query tiles; dV = P^T dO and
//                            dK = dS^T Q scale, P = exp(Q K^T scale - lse),
//                            dS = P * (dO V^T - D).
//   flash_dq_sm90_kernel  <- `_dq_kernel` (:233): one block per query tile,
//                            scanning key tiles; dQ = dS K scale.
// Same contract as the SIMT kernels: q, k, v (bh, S, d); out, dk, dv, dq in
// the input type; lse (bh, S) float32; masked probabilities exactly 0 (masked
// scores are -inf here, and 2^-inf is 0; the running max starts at -1e30,
// NEG_INF); any S (the ragged last tile is masked); 64-bit
// extents (TMA takes (d, S, bh) coordinates, so bh * S * d may pass 2^31).
// Every product accumulates in float32; P and dS are rounded to the input
// type before the products that take them (as FlashAttention-2/3 and SDPA
// do), the softmax statistics stay float32.  dK and dQ are multiplied by
// `scale` once, at write-out.
//
// What bounds it.  At the LM shape (bh 192, S 1024, d 64, causal) the
// forward does 2 products of 2*bh*S^2*d FLOP at the causal fraction, about
// 26 GFLOP, on 101 MB (q, k, v read, out written): 255 FLOP per byte, near
// the bf16 ridge (295), so bytes and tensor cores bound it alike, about
// 0.03 ms; dK/dV does 4 products on 152 MB and dQ 3 on 126 MB, and the
// tensor cores bound both.
// The SIMT kernels ran every product as float32 FMAs from shared memory,
// about 23 TFLOP/s.  Here every product is a `wgmma`, and the operands
// reach shared memory by TMA, so no thread spends instructions on loads.
//
// Design (one block = three warpgroups, 384 threads):
// - Warpgroup 0 is the producer.  Its first warp issues the TMA loads (one
//   thread) into a 3-stage ring of tiles in shared memory with full/empty
//   mbarriers; `setmaxnreg` gives it 24 registers.  Warpgroups 1 and 2
//   consume: each owns 64 rows of the block's output tile and gets 240
//   registers.
// - Tiles are (rows, 64 columns) boxes of 128-byte rows in TMA's 128-byte
//   swizzle, the layout `wgmma` descriptors read; at d = 128 a tile is two
//   such boxes, one after the other.
// - Forward: a block per (128-row query tile, bh).  S = Q K^T by
//   m64n128k16 from shared memory (both operands K-major); scale, mask and
//   the online max/sum run on the float32 accumulators, reducing a row over
//   the four threads that hold it; P is rounded in registers and is the
//   A-from-registers operand of O += P V, V read MN-major (the transpose
//   bit).  Causal blocks launch heaviest query tile first.  Shared memory:
//   112 KB at d = 64, 225 KB at d = 128.
// - dK/dV: a block per (128-row key tile, bh); K and V stay resident, Q,
//   dO, lse and D stream in 64-row tiles.  Everything runs in the key-rows
//   orientation, so no register tile needs a transpose: S^T = K Q^T and
//   dP^T = V dO^T from shared memory, P^T = exp(S^T scale - lse),
//   dS^T = P^T (dP^T - D) in registers, then dV += P^T dO and
//   dK += dS^T Q with dO and Q read MN-major.  Each block owns its output
//   rows: no atomics, the same gradients from run to run.  Shared memory:
//   82 KB at d = 64, 163 KB at d = 128.
// - dQ: a block per (128-row query tile, bh), heaviest causal tile first,
//   as the forward; Q and dO stay resident, K and V stream in 64-row tiles,
//   lse and D sit in registers for each row.  S = Q K^T and dP = dO V^T
//   from shared memory (both K-major), P = exp(S scale - lse) and
//   dS = P (dP - D) in S's accumulators, then dQ += dS K with dS as the
//   A-from-registers operand and K read MN-major, the form of the forward's
//   O += P V.  64-key tiles keep S, dP, dS and dQ (64 floats at d = 128) in
//   a consumer's 240 registers with the next tile's products in flight.
//   Each block owns its rows: no atomics.  Shared memory: 80 KB at d = 64,
//   160 KB at d = 128.
// - Wholly masked tiles are skipped with the TPU kernels' range formulas at
//   these tiles (`key_tile_range(i, S, 128, 128)`,
//   `query_tile_range(j, S, 64, 128)`, `key_tile_range(i, S, 128, 64)` in
//   ops/flash_attention.py).
// - Within a warpgroup, the softmax of one tile runs while the tensor cores
//   do the previous tile's second product: the next tile's score product
//   issues first, then the current tile's P V (or dV/dK) product, and the
//   warpgroup waits for the scores alone (FlashAttention-3's intra-warpgroup
//   overlap); the two consumer warpgroups overlap each other besides.  The
//   dK/dV kernel does so at d = 64; at d = 128 its accumulators leave no
//   registers for a second tile in flight, and each tile runs in turn.  The
//   dQ kernel does so at both head dims.

#include <cuda.h>  // CUtensorMap and the encoder's types (no -lcuda: see encoder())
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernels
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 384;         // producer + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kBoxCols = 64;          // 16-bit elements in one 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr int kTile = 128;            // forward query/key tile, dK/dV key tile
constexpr int kQTileDkv = 64;         // dK/dV query tile
constexpr int kKTileDq = 64;          // dQ key tile
constexpr int kStages = 3;  // the tile in use, the next one, one loading

enum DType { kBFloat16 = 1, kFloat16 = 2 };  // the SIMT library's codes

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Arrive, and expect `bytes` more of TMA traffic in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Expect `bytes` more of TMA traffic in this phase, without arriving.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One (64 columns, rows, 1) box at coordinates (col, row, bh) of a
// (d, S, bh) tensor map into shared memory; completes on `bar`.  Rows past
// S arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(bh)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// `wgmma` writes its accumulators (and reads its register operand) after
// the instruction issues; these empty statements tell the compiler that the
// registers change, or are still read, at the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A shared-memory matrix descriptor in the 128-byte swizzle.  K-major
// operands: `sbo` = 1024 (8 rows of 128 bytes), `lbo` unused (16).
// MN-major operands: `sbo` = 1024 (8 rows along K), `lbo` = the distance
// between 64-column boxes along M/N.  Tiles start 1024-byte aligned, so the
// base-offset field is 0; a K step inside a K-major box adds 32 bytes to
// the start address, which the swizzle then maps as TMA wrote it.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// ------------------------------------------------------------ wgmma

// D (64 x 64, f32) += A (64 x 16, shared) * B (64 x 16, shared)^T, both
// K-major; scale_d = 0 overwrites D.
template <bool kBf16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
  if constexpr (kBf16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, shared,
// MN-major: the transpose bit).
template <bool kBf16>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t b) {
  if constexpr (kBf16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}

// D (64 x 128, f32) += A (64 x 16, shared) * B (128 x 16, shared)^T, both
// K-major; scale_d = 0 overwrites D.
template <bool kBf16>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
  if constexpr (kBf16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
}

// D (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, shared,
// MN-major: the transpose bit).
template <bool kBf16>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t b) {
  if constexpr (kBf16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An m64nN accumulator in registers: thread t of the warpgroup holds, for
// each 8-column block b, the elements (r, 8b + 2(t%4)) and (r, 8b + 2(t%4)
// + 1) of row r = 16(t/32) + (t%32)/4 and the same two of row r + 8, as
// slots 4b .. 4b+3.  Slots 8k .. 8k+7 are then exactly the A-from-registers
// fragment of the k-th 16-column step, so a rounded accumulator feeds the
// next product as it is: fragment register i packs slots 2i and 2i + 1.
__device__ __forceinline__ int slot_row(int e) { return (e >> 1) & 1; }  // 0: r, 1: r + 8
__device__ __forceinline__ int slot_col(int e, int lane) {
  return 8 * (e >> 2) + 2 * (lane % 4) + (e & 1);
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && (a < 0) != (b < 0)) ? q - 1 : q;
}

// Key tiles [lo, hi) that query tile i can see (flash_attention.py:80-92).
__device__ __forceinline__ void key_tile_range(int i, int S, int bq, int bk, int causal,
                                               int window, int* lo, int* hi) {
  const long long n = (S + bk - 1) / bk;
  *hi = static_cast<int>(causal ? min(n, floor_div((i + 1LL) * bq + bk - 1, bk)) : n);
  *lo = static_cast<int>(window > 0 ? max(0LL, floor_div(1LL * i * bq - window + 1, bk)) : 0);
}

// Query tiles [lo, hi) that can see key tile j (flash_attention.py:216-225).
__device__ __forceinline__ void query_tile_range(int j, int S, int bq, int bk, int causal,
                                                 int window, int* lo, int* hi) {
  const long long n = (S + bq - 1) / bq;
  *lo = static_cast<int>(causal ? floor_div(1LL * j * bk, bq) : 0);
  *hi = static_cast<int>(
      window > 0 ? min(n, floor_div((j + 1LL) * bk - 1 + window - 1, bq) + 1) : n);
}

__device__ __forceinline__ bool visible(int qp, int kp, int S, int causal, int window) {
  if (qp >= S || kp >= S) return false;  // the ragged last tile
  if (causal && kp > qp) return false;
  if (window > 0 && kp <= qp - window) return false;
  return true;
}

// 2^x on the special-function unit (2^-inf = +0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tile of the forward's online softmax on the S accumulator (unscaled
// scores) in place: masked scores become -inf, the running max m (unscaled)
// and the thread's row-sum shares l move on, corr is the factor the output
// rows take, and sc ends as P = 2^((s - m) scale log2 e) in float32.  A
// row is reduced over the four threads that hold it (lanes 4k .. 4k+3).
__device__ __forceinline__ void online_softmax(float (&sc)[64], float (&m)[2], float (&l)[2],
                                               float (&corr)[2], bool masked, const int (&qp)[2],
                                               int k0, int lane, int S, int causal, int window,
                                               float sl2) {
  if (masked) {
#pragma unroll
    for (int e = 0; e < 64; ++e)
      if (!visible(qp[slot_row(e)], k0 + slot_col(e, lane), S, causal, window))
        sc[e] = __uint_as_float(0xff800000u);  // -inf
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int e = 0; e < 64; ++e) mx[slot_row(e)] = fmaxf(mx[slot_row(e)], sc[e]);
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = ex2((m[r] - mx[r]) * sl2);  // m starts at -1e30, not -inf: never NaN
    m[r] = mx[r];
    l[r] *= corr[r];
    mb[r] = mx[r] * sl2;
  }
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const float p = ex2(fmaf(sc[e], sl2, -mb[slot_row(e)]));
    sc[e] = p;
    l[slot_row(e)] += p;
  }
}

template <int D>
struct FwdLayout {  // byte offsets from the 1024-aligned base
  static constexpr int kBox = kTile * kRowBytes;  // (128 rows, 64 columns)
  static constexpr int kTileBytes = kBox * (D / kBoxCols);
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTileBytes;  // kStages tiles each
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;  // q_full, full[], empty[]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;  // + alignment room
};

// S (64 x 128) = Q rows (64 x D) K tile^T, both from shared memory.
template <bool kBf16, int D>
__device__ __forceinline__ void fwd_scores(float (&sc)[64], uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * FwdLayout<D>::kBox + (kk % 4) * 32;
    wgmma_ss_n128<kBf16>(sc, sw128_desc(q_rows + off, 16, 1024), sw128_desc(k_tile + off, 16, 1024),
                         kk > 0);
  }
}

// O (64 x D) += P (64 x 128, registers) V tile (128 x D, MN-major).
template <bool kBf16, int D>
__device__ __forceinline__ void fwd_pv(float (&o)[D / 2], const uint32_t (&pf)[32],
                                       uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint64_t b = sw128_desc(v_tile + kk * 16 * kRowBytes, FwdLayout<D>::kBox, 1024);
    if constexpr (D == 64) {
      wgmma_rs_n64<kBf16>(o, pf + 4 * kk, b);
    } else {
      wgmma_rs_n128<kBf16>(o, pf + 4 * kk, b);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map, T* __restrict__ out,
                          float* __restrict__ lse, int S, float scale, int causal, int window) {
  using L = FwdLayout<D>;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kBoxes = D / kBoxCols;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::kQ, k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t q_full = base + L::kBars;
  const uint32_t full = q_full + 8, empty = full + 8 * kStages;  // + 8 * stage

  const int bh = blockIdx.x;
  // Under a causal mask the last query tiles scan the most keys: first.
  const int i = causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y) : blockIdx.y;
  const int q0 = i * kTile;
  int lo, hi;
  key_tile_range(i, S, kTile, kTile, causal, window, &lo, &hi);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, L::kTileBytes);
      for (int h = 0; h < kBoxes; ++h)
        tma_load(q_s + h * L::kBox, &q_map, q_full, h * kBoxCols, q0, bh);
      for (int j = lo, n = 0; j < hi; ++j, ++n) {
        const int s = n % kStages;
        mbar_wait(empty + 8 * s, ((n / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full + 8 * s, 2 * L::kTileBytes);
        for (int h = 0; h < kBoxes; ++h) {
          const uint32_t off = s * L::kTileBytes + h * L::kBox;
          tma_load(k_s + off, &k_map, full + 8 * s, h * kBoxCols, j * kTile, bh);
          tma_load(v_s + off, &v_map, full + 8 * s, h * kBoxCols, j * kTile, bh);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int c = wg - 1;  // this warpgroup's query rows: q0 + 64c ..
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row = c * 64 + (t / 32) * 16 + lane / 4;
  const int qp[2] = {q0 + row, q0 + row + 8};
  const int wg_q0 = q0 + c * 64;
  const uint32_t q_rows = q_s + c * 64 * kRowBytes;
  const float sl2 = scale * kLog2e;  // softmax in base 2
  float o[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};  // running row max of the unscaled scores
  float l[2] = {0.0f, 0.0f};        // this thread's share of the row sums
  float corr[2];
  float sc[64];    // S = Q K^T: 64 query rows x 128 keys, then P in float32
  uint32_t pf[32];  // P in the input type: 8 A fragments of 64 x 16

  // Tile n's softmax overlaps tile n-1's O += P V: S of tile n + 1 issues
  // first, then P V of tile n, and the softmax of tile n + 1 runs while
  // that product does; o is rescaled only once it has landed.
  const int count = hi - lo;
  auto softmax = [&](int n) {
    const int k0 = (lo + n) * kTile;
    const bool masked = k0 + kTile > S || (causal && k0 + kTile - 1 > wg_q0) ||
                        (window > 0 && k0 <= wg_q0 + 63 - window);
    online_softmax(sc, m, l, corr, masked, qp, k0, lane, S, causal, window, sl2);
  };
  mbar_wait(q_full, 0);
  if (count > 0) {
    mbar_wait(full, 0);
    wgmma_fence();
    fwd_scores<kBf16, D>(sc, q_rows, k_s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0);
  }
  // P V of tile n - 1 has landed (nothing in flight at n = 0): its stage
  // is free; o takes tile n's correction and P its input type.
  auto take_tile = [&](int n) {
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pf);
    if (n > 0) mbar_arrive(empty + 8 * ((n - 1) % kStages));
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] *= corr[slot_row(e)];
#pragma unroll
    for (int e = 0; e < 32; ++e) pf[e] = pack2<T>(sc[2 * e], sc[2 * e + 1]);
  };
  // The loop issues the same products on every pass (no wgmma under a
  // branch, which would make ptxas serialise them); the last tile follows.
  for (int n = 0; n + 1 < count; ++n) {
    take_tile(n);
    const int s1 = (n + 1) % kStages;
    mbar_wait(full + 8 * s1, ((n + 1) / kStages) & 1);
    wgmma_fence();
    fwd_scores<kBf16, D>(sc, q_rows, k_s + s1 * L::kTileBytes);
    wgmma_commit();
    fwd_pv<kBf16, D>(o, pf, v_s + (n % kStages) * L::kTileBytes);
    wgmma_commit();
    wgmma_wait<1>();  // the scores of tile n + 1; P V of tile n may still run
    fence_regs(sc);
    softmax(n + 1);
  }
  if (count > 0) {
    take_tile(count - 1);
    wgmma_fence();
    fwd_pv<kBf16, D>(o, pf, v_s + ((count - 1) % kStages) * L::kTileBytes);
    wgmma_commit();
  }
  wgmma_wait<0>();  // on every path, so the epilogue reads o after it
  fence_regs(o);
  if (count > 0) mbar_arrive(empty + 8 * ((count - 1) % kStages));

  const size_t row_base = static_cast<size_t>(bh) * S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (qp[r] >= S) continue;
    const float inv = 1.0f / l[r];
    T* dst = out + (row_base + qp[r]) * D + 2 * (lane % 4);
#pragma unroll
    for (int b = 0; b < D / 8; ++b)
      *reinterpret_cast<uint32_t*>(dst + 8 * b) =
          pack2<T>(o[4 * b + 2 * r] * inv, o[4 * b + 2 * r + 1] * inv);
    if (lane % 4 == 0) lse[row_base + qp[r]] = m[r] * scale + log2f(l[r]) * kLn2;
  }
}

template <int D>
struct DkvLayout {  // byte offsets from the 1024-aligned base
  static constexpr int kKBox = kTile * kRowBytes;      // (128 key rows, 64 columns)
  static constexpr int kKTile = kKBox * (D / kBoxCols);
  static constexpr int kQBox = kQTileDkv * kRowBytes;  // (64 query rows, 64 columns)
  static constexpr int kQTile = kQBox * (D / kBoxCols);
  static constexpr int kK = 0;
  static constexpr int kV = kKTile;
  static constexpr int kQ = 2 * kKTile;  // kStages tiles each of Q and dO
  static constexpr int kO = kQ + kStages * kQTile;
  static constexpr int kRows = kO + kStages * kQTile;  // per stage: lse * log2(e), then D
  static constexpr int kBars = kRows + kStages * 2 * kQTileDkv * 4;  // kv_full, full[], empty[]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// S^T = K rows Q tile^T and dP^T = V rows dO tile^T (64 x 64 each), all
// from shared memory.
template <bool kBf16, int D>
__device__ __forceinline__ void dkv_scores(float (&st)[32], float (&dpt)[32], uint32_t k_rows,
                                           uint32_t v_rows, uint32_t q_tile, uint32_t o_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t k_off = (kk / 4) * DkvLayout<D>::kKBox + (kk % 4) * 32;
    const uint32_t q_off = (kk / 4) * DkvLayout<D>::kQBox + (kk % 4) * 32;
    wgmma_ss_n64<kBf16>(st, sw128_desc(k_rows + k_off, 16, 1024),
                        sw128_desc(q_tile + q_off, 16, 1024), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t k_off = (kk / 4) * DkvLayout<D>::kKBox + (kk % 4) * 32;
    const uint32_t q_off = (kk / 4) * DkvLayout<D>::kQBox + (kk % 4) * 32;
    wgmma_ss_n64<kBf16>(dpt, sw128_desc(v_rows + k_off, 16, 1024),
                        sw128_desc(o_tile + q_off, 16, 1024), kk > 0);
  }
}

// dV (64 x D) += P^T dO tile and dK += dS^T Q tile: A from registers, the
// tiles (64 queries x D) MN-major.
template <bool kBf16, int D>
__device__ __forceinline__ void dkv_update(float (&dv)[D / 2], float (&dk)[D / 2],
                                           const uint32_t (&pf)[16], const uint32_t (&sf)[16],
                                           uint32_t q_tile, uint32_t o_tile) {
#pragma unroll
  for (int kk = 0; kk < kQTileDkv / 16; ++kk) {
    const uint64_t b_do = sw128_desc(o_tile + kk * 16 * kRowBytes, DkvLayout<D>::kQBox, 1024);
    const uint64_t b_q = sw128_desc(q_tile + kk * 16 * kRowBytes, DkvLayout<D>::kQBox, 1024);
    if constexpr (D == 64) {
      wgmma_rs_n64<kBf16>(dv, pf + 4 * kk, b_do);
      wgmma_rs_n64<kBf16>(dk, sf + 4 * kk, b_q);
    } else {
      wgmma_rs_n128<kBf16>(dv, pf + 4 * kk, b_do);
      wgmma_rs_n128<kBf16>(dk, sf + 4 * kk, b_q);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int S, float scale, int causal,
                          int window) {
  using L = DkvLayout<D>;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kBoxes = D / kBoxCols;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base + L::kK, v_s = base + L::kV, q_s = base + L::kQ, o_s = base + L::kO;
  float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kRows);
  const uint32_t kv_full = base + L::kBars;
  const uint32_t full = kv_full + 8, empty = full + 8 * kStages;

  const int bh = blockIdx.x;
  const int j = blockIdx.y;  // under a causal mask the first key tiles scan the most queries
  const int k0 = j * kTile;
  int lo, hi;
  query_tile_range(j, S, kQTileDkv, kTile, causal, window, &lo, &hi);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 32);  // the producer warp, after it wrote lse and D
      mbar_init(empty + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer: TMA from lane 0, lse and D rows from the whole warp
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * L::kKTile);
        for (int h = 0; h < kBoxes; ++h) {
          tma_load(k_s + h * L::kKBox, &k_map, kv_full, h * kBoxCols, k0, bh);
          tma_load(v_s + h * L::kKBox, &v_map, kv_full, h * kBoxCols, k0, bh);
        }
      }
      const float* lse_bh = lse + static_cast<size_t>(bh) * S;
      const float* delta_bh = delta + static_cast<size_t>(bh) * S;
      for (int qi = lo, n = 0; qi < hi; ++qi, ++n) {
        const int s = n % kStages;
        mbar_wait(empty + 8 * s, ((n / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full + 8 * s, 2 * L::kQTile);
          for (int h = 0; h < kBoxes; ++h) {
            const uint32_t off = s * L::kQTile + h * L::kQBox;
            tma_load(q_s + off, &q_map, full + 8 * s, h * kBoxCols, qi * kQTileDkv, bh);
            tma_load(o_s + off, &do_map, full + 8 * s, h * kBoxCols, qi * kQTileDkv, bh);
          }
        }
        float* ls = rows + s * 2 * kQTileDkv;
        for (int r = lane; r < kQTileDkv; r += 32) {
          const int qp = qi * kQTileDkv + r;
          ls[r] = qp < S ? lse_bh[qp] * kLog2e : 0.0f;
          ls[kQTileDkv + r] = qp < S ? delta_bh[qp] : 0.0f;
        }
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int c = wg - 1;  // this warpgroup's key rows: k0 + 64c ..
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row = c * 64 + (t / 32) * 16 + lane / 4;
  const int kp[2] = {k0 + row, k0 + row + 8};
  const int wg_k0 = k0 + c * 64;
  const float sl2 = scale * kLog2e;
  const uint32_t k_rows = k_s + c * 64 * kRowBytes, v_rows = v_s + c * 64 * kRowBytes;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dk_acc[e] = dv_acc[e] = 0.0f;
  float st[32], dpt[32];    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
  uint32_t pf[16], sf[16];  // P^T and dS^T in the input type: 4 A fragments each

  const int count = hi - lo;
  auto scores = [&](int n) {
    const int s = n % kStages;
    dkv_scores<kBf16, D>(st, dpt, k_rows, v_rows, q_s + s * L::kQTile, o_s + s * L::kQTile);
  };
  auto probs = [&](int n) {  // st becomes P^T and dpt dS^T, in float32
    const int q0 = (lo + n) * kQTileDkv;
    const bool masked = q0 + kQTileDkv > S || (causal && wg_k0 + 63 > q0) ||
                        (window > 0 && wg_k0 <= q0 + kQTileDkv - 1 - window);
    const float* ls = rows + (n % kStages) * 2 * kQTileDkv;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = slot_col(e, lane);
      if (masked && !visible(q0 + col, kp[slot_row(e)], S, causal, window))
        st[e] = __uint_as_float(0xff800000u);  // -inf: P = 0
      const float p = ex2(fmaf(st[e], sl2, -ls[col]));
      st[e] = p;
      dpt[e] = p * (dpt[e] - ls[kQTileDkv + col]);
    }
  };
  auto round_probs = [&] {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      pf[e] = pack2<T>(st[2 * e], st[2 * e + 1]);
      sf[e] = pack2<T>(dpt[2 * e], dpt[2 * e + 1]);
    }
  };
  auto update = [&](int n) {
    const int s = n % kStages;
    dkv_update<kBf16, D>(dv_acc, dk_acc, pf, sf, q_s + s * L::kQTile, o_s + s * L::kQTile);
  };
  auto landed = [&] {
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pf);
    fence_regs(sf);
  };

  mbar_wait(kv_full, 0);
  if constexpr (D == 64) {
    // As the forward: the score products of tile n + 1 issue before the
    // gradient products of tile n, and tile n + 1's P^T and dS^T are formed
    // while those run.  (At d = 128 the accumulators leave no registers for
    // a second tile in flight.)
    if (count > 0) {
      mbar_wait(full, 0);
      wgmma_fence();
      scores(0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      probs(0);
    }
    auto take_tile = [&](int n) {  // as the forward's
      wgmma_wait<0>();
      landed();
      if (n > 0) mbar_arrive(empty + 8 * ((n - 1) % kStages));
      round_probs();
    };
    for (int n = 0; n + 1 < count; ++n) {
      take_tile(n);
      mbar_wait(full + 8 * ((n + 1) % kStages), ((n + 1) / kStages) & 1);
      wgmma_fence();
      scores(n + 1);
      wgmma_commit();
      update(n);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);
      fence_regs(dpt);
      probs(n + 1);
    }
    if (count > 0) {
      take_tile(count - 1);
      wgmma_fence();
      update(count - 1);
      wgmma_commit();
    }
    wgmma_wait<0>();  // on every path, so the epilogue reads dK/dV after it
    landed();
    if (count > 0) mbar_arrive(empty + 8 * ((count - 1) % kStages));
  } else {
    for (int n = 0; n < count; ++n) {
      mbar_wait(full + 8 * (n % kStages), (n / kStages) & 1);
      wgmma_fence();
      scores(n);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      probs(n);
      round_probs();
      wgmma_fence();
      update(n);
      wgmma_commit();
      wgmma_wait<0>();
      landed();
      mbar_arrive(empty + 8 * (n % kStages));
    }
    wgmma_wait<0>();  // as above: a wait on every path before the epilogue
    landed();
  }

  const size_t row_base = static_cast<size_t>(bh) * S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kp[r] >= S) continue;
    const size_t at = (row_base + kp[r]) * D + 2 * (lane % 4);
#pragma unroll
    for (int b = 0; b < D / 8; ++b) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * b) =
          pack2<T>(dk_acc[4 * b + 2 * r] * scale, dk_acc[4 * b + 2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * b) =
          pack2<T>(dv_acc[4 * b + 2 * r], dv_acc[4 * b + 2 * r + 1]);
    }
  }
}

template <int D>
struct DqLayout {  // byte offsets from the 1024-aligned base
  static constexpr int kQBox = kTile * kRowBytes;     // (128 query rows, 64 columns)
  static constexpr int kQTile = kQBox * (D / kBoxCols);
  static constexpr int kKBox = kKTileDq * kRowBytes;  // (64 key rows, 64 columns)
  static constexpr int kKTile = kKBox * (D / kBoxCols);
  static constexpr int kQ = 0;
  static constexpr int kO = kQTile;
  static constexpr int kK = 2 * kQTile;  // kStages tiles each of K and V
  static constexpr int kV = kK + kStages * kKTile;
  static constexpr int kBars = kV + kStages * kKTile;  // qo_full, full[], empty[]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// S = Q rows K tile^T and dP = dO rows V tile^T (64 x 64 each), all from
// shared memory, both operands K-major.
template <bool kBf16, int D>
__device__ __forceinline__ void dq_scores(float (&sc)[32], float (&dp)[32], uint32_t q_rows,
                                          uint32_t o_rows, uint32_t k_tile, uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t q_off = (kk / 4) * DqLayout<D>::kQBox + (kk % 4) * 32;
    const uint32_t k_off = (kk / 4) * DqLayout<D>::kKBox + (kk % 4) * 32;
    wgmma_ss_n64<kBf16>(sc, sw128_desc(q_rows + q_off, 16, 1024),
                        sw128_desc(k_tile + k_off, 16, 1024), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t q_off = (kk / 4) * DqLayout<D>::kQBox + (kk % 4) * 32;
    const uint32_t k_off = (kk / 4) * DqLayout<D>::kKBox + (kk % 4) * 32;
    wgmma_ss_n64<kBf16>(dp, sw128_desc(o_rows + q_off, 16, 1024),
                        sw128_desc(v_tile + k_off, 16, 1024), kk > 0);
  }
}

// dQ (64 x D) += dS (64 x 64 keys, registers) K tile (64 keys x D, MN-major).
template <bool kBf16, int D>
__device__ __forceinline__ void dq_update(float (&dq)[D / 2], const uint32_t (&sf)[16],
                                          uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < kKTileDq / 16; ++kk) {
    const uint64_t b = sw128_desc(k_tile + kk * 16 * kRowBytes, DqLayout<D>::kKBox, 1024);
    if constexpr (D == 64) {
      wgmma_rs_n64<kBf16>(dq, sf + 4 * kk, b);
    } else {
      wgmma_rs_n128<kBf16>(dq, sf + 4 * kk, b);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dq, int S, float scale, int causal, int window) {
  using L = DqLayout<D>;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kBoxes = D / kBoxCols;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::kQ, o_s = base + L::kO, k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t qo_full = base + L::kBars;
  const uint32_t full = qo_full + 8, empty = full + 8 * kStages;  // + 8 * stage

  const int bh = blockIdx.x;
  // Under a causal mask the last query tiles scan the most keys: first.
  const int i = causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y) : blockIdx.y;
  const int q0 = i * kTile;
  int lo, hi;
  key_tile_range(i, S, kTile, kKTileDq, causal, window, &lo, &hi);

  if (threadIdx.x == 0) {
    mbar_init(qo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(qo_full, 2 * L::kQTile);
      for (int h = 0; h < kBoxes; ++h) {
        tma_load(q_s + h * L::kQBox, &q_map, qo_full, h * kBoxCols, q0, bh);
        tma_load(o_s + h * L::kQBox, &do_map, qo_full, h * kBoxCols, q0, bh);
      }
      for (int j = lo, n = 0; j < hi; ++j, ++n) {
        const int s = n % kStages;
        mbar_wait(empty + 8 * s, ((n / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full + 8 * s, 2 * L::kKTile);
        for (int h = 0; h < kBoxes; ++h) {
          const uint32_t off = s * L::kKTile + h * L::kKBox;
          tma_load(k_s + off, &k_map, full + 8 * s, h * kBoxCols, j * kKTileDq, bh);
          tma_load(v_s + off, &v_map, full + 8 * s, h * kBoxCols, j * kKTileDq, bh);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int c = wg - 1;  // this warpgroup's query rows: q0 + 64c ..
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row = c * 64 + (t / 32) * 16 + lane / 4;
  const int qp[2] = {q0 + row, q0 + row + 8};
  const int wg_q0 = q0 + c * 64;
  const float sl2 = scale * kLog2e;
  const size_t row_base = static_cast<size_t>(bh) * S;
  float lse2[2], dd[2];  // lse * log2(e) and D of this thread's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = qp[r] < S ? lse[row_base + qp[r]] * kLog2e : 0.0f;
    dd[r] = qp[r] < S ? delta[row_base + qp[r]] : 0.0f;
  }
  const uint32_t q_rows = q_s + c * 64 * kRowBytes, o_rows = o_s + c * 64 * kRowBytes;
  float dq_acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dq_acc[e] = 0.0f;
  float sc[32], dp[32];  // S = Q K^T and dP = dO V^T: 64 queries x 64 keys
  uint32_t sf[16];       // dS in the input type: 4 A fragments

  const int count = hi - lo;
  auto scores = [&](int n) {
    const int s = n % kStages;
    dq_scores<kBf16, D>(sc, dp, q_rows, o_rows, k_s + s * L::kKTile, v_s + s * L::kKTile);
  };
  auto probs = [&](int n) {  // dp becomes dS = P (dP - D), in float32
    const int k0 = (lo + n) * kKTileDq;
    const bool masked = k0 + kKTileDq > S || wg_q0 + 64 > S || (causal && k0 + 63 > wg_q0) ||
                        (window > 0 && k0 <= wg_q0 + 63 - window);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = slot_row(e);
      if (masked && !visible(qp[r], k0 + slot_col(e, lane), S, causal, window))
        sc[e] = __uint_as_float(0xff800000u);  // -inf: P = 0
      const float p = ex2(fmaf(sc[e], sl2, -lse2[r]));
      dp[e] = p * (dp[e] - dd[r]);
    }
  };
  auto update = [&](int n) {
    dq_update<kBf16, D>(dq_acc, sf, k_s + (n % kStages) * L::kKTile);
  };
  auto landed = [&] {
    fence_regs(dq_acc);
    fence_regs(sf);
  };

  mbar_wait(qo_full, 0);
  // As the forward: the score products of tile n + 1 issue before dQ's
  // product of tile n, and tile n + 1's dS is formed while that runs.
  if (count > 0) {
    mbar_wait(full, 0);
    wgmma_fence();
    scores(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    probs(0);
  }
  // dQ's product of tile n - 1 has landed (nothing in flight at n = 0): its
  // stage is free, and dS of tile n takes the input type.
  auto take_tile = [&](int n) {
    wgmma_wait<0>();
    landed();
    if (n > 0) mbar_arrive(empty + 8 * ((n - 1) % kStages));
#pragma unroll
    for (int e = 0; e < 16; ++e) sf[e] = pack2<T>(dp[2 * e], dp[2 * e + 1]);
  };
  for (int n = 0; n + 1 < count; ++n) {
    take_tile(n);
    mbar_wait(full + 8 * ((n + 1) % kStages), ((n + 1) / kStages) & 1);
    wgmma_fence();
    scores(n + 1);
    wgmma_commit();
    update(n);
    wgmma_commit();
    wgmma_wait<1>();  // the scores of tile n + 1; dQ's product of tile n may still run
    fence_regs(sc);
    fence_regs(dp);
    probs(n + 1);
  }
  if (count > 0) {
    take_tile(count - 1);
    wgmma_fence();
    update(count - 1);
    wgmma_commit();
  }
  wgmma_wait<0>();  // on every path, so the epilogue reads dQ after it
  landed();
  if (count > 0) mbar_arrive(empty + 8 * ((count - 1) % kStages));

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qp[r] >= S) continue;
    T* dst = dq + (row_base + qp[r]) * D + 2 * (lane % 4);
#pragma unroll
    for (int b = 0; b < D / 8; ++b)
      *reinterpret_cast<uint32_t*>(dst + 8 * b) =
          pack2<T>(dq_acc[4 * b + 2 * r] * scale, dq_acc[4 * b + 2 * r + 1] * scale);
  }
}

// ------------------------------------------------------------------- host

constexpr int kErrNoEncoder = 2000;  // the driver has no cuTensorMapEncodeTiled
constexpr int kErrEncode = 1000;     // + the CUresult it returned

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, reached through the runtime, so the
// library links no libcuda of its own.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// (64 columns, rows, 1) boxes of a contiguous (bh, S, d) array in the
// 128-byte swizzle; rows past S read as zeros.
int make_map(CUtensorMap* map, const void* ptr, int dtype, int bh, int S, int d, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(S) * d * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kBoxCols), static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map, dtype == kBFloat16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

// Launches `kernel` on a (bh, S / 128) grid of 384 threads with `smem`
// bytes of dynamic shared memory (allowed first: past 48 KB a launch is
// refused otherwise).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int smem, int bh, int S, cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, (S + kTile - 1) / kTile), kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

struct Call {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out;   // out, dk or dq
  void* out2;  // dv
  float* lse_out;
  int bh, S, d, dtype, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int run_fwd(const Call& a) {
  CUtensorMap maps[3];
  const void* src[3] = {a.q, a.k, a.v};
  for (int i = 0; i < 3; ++i) {
    const int err = make_map(&maps[i], src[i], a.dtype, a.bh, a.S, D, kTile);
    if (err) return err;
  }
  return launch(flash_fwd_sm90_kernel<T, D>, FwdLayout<D>::kBytes, a.bh, a.S, a.stream, maps[0],
                maps[1], maps[2], static_cast<T*>(a.out), a.lse_out, a.S, a.scale, a.causal,
                a.window);
}

template <typename T, int D>
int run_dkv(const Call& a) {
  CUtensorMap maps[4];
  const void* src[4] = {a.q, a.k, a.v, a.dout};
  const int rows[4] = {kQTileDkv, kTile, kTile, kQTileDkv};
  for (int i = 0; i < 4; ++i) {
    const int err = make_map(&maps[i], src[i], a.dtype, a.bh, a.S, D, rows[i]);
    if (err) return err;
  }
  return launch(flash_dkv_sm90_kernel<T, D>, DkvLayout<D>::kBytes, a.bh, a.S, a.stream, maps[0],
                maps[1], maps[2], maps[3], a.lse_in, a.delta, static_cast<T*>(a.out),
                static_cast<T*>(a.out2), a.S, a.scale, a.causal, a.window);
}

template <typename T, int D>
int run_dq(const Call& a) {
  CUtensorMap maps[4];
  const void* src[4] = {a.q, a.k, a.v, a.dout};
  const int rows[4] = {kTile, kKTileDq, kKTileDq, kTile};
  for (int i = 0; i < 4; ++i) {
    const int err = make_map(&maps[i], src[i], a.dtype, a.bh, a.S, D, rows[i]);
    if (err) return err;
  }
  return launch(flash_dq_sm90_kernel<T, D>, DqLayout<D>::kBytes, a.bh, a.S, a.stream, maps[0],
                maps[1], maps[2], maps[3], a.lse_in, a.delta, static_cast<T*>(a.out), a.S,
                a.scale, a.causal, a.window);
}

enum Pass { kFwd, kDkv, kDq };

template <Pass kPass, typename T, int D>
int run(const Call& a) {
  if constexpr (kPass == kFwd) {
    return run_fwd<T, D>(a);
  } else if constexpr (kPass == kDkv) {
    return run_dkv<T, D>(a);
  } else {
    return run_dq<T, D>(a);
  }
}

template <Pass kPass, typename T>
int pick_width(const Call& a) {
  if (a.d == 64) return run<kPass, T, 64>(a);
  if (a.d == 128) return run<kPass, T, 128>(a);
  return cudaErrorInvalidValue;
}

template <Pass kPass>
int dispatch(const Call& a) {
  if (a.bh <= 0 || a.S <= 0 || (a.S + kTile - 1) / kTile > 65535) return cudaErrorInvalidValue;
  if (a.dtype == kBFloat16) return pick_width<kPass, __nv_bfloat16>(a);
  if (a.dtype == kFloat16) return pick_width<kPass, __half>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// Each entry point encodes the tensor maps, launches one kernel on `stream`
// and returns 0, a CUDA error code, or a tensor-map code (see
// flash_sm90_error_string).  q, k, v, dout and the outputs are contiguous,
// 16-byte aligned (bh, S, d) device arrays of one dtype (1 bfloat16, 2
// float16), d 64 or 128; lse and delta are contiguous (bh, S) float32.
// window <= 0 means no window.  The caller allocates every output.
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v, void* out, float* lse,
                              int bh, int S, int d, float scale, int dtype, int causal,
                              int window, void* stream) {
  const Call a{q,   k,  v, nullptr, nullptr, nullptr, out,    nullptr, lse,
               bh,  S,  d, dtype,   causal,  window,  scale, static_cast<cudaStream_t>(stream)};
  return dispatch<kFwd>(a);
}

extern "C" int flash_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, void* dk, void* dv, int bh,
                              int S, int d, float scale, int dtype, int causal, int window,
                              void* stream) {
  const Call a{q,  k, v, dout,  lse,    delta,  dk,    dv, nullptr,
               bh, S, d, dtype, causal, window, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<kDkv>(a);
}

extern "C" int flash_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dq, int bh, int S, int d,
                             float scale, int dtype, int causal, int window, void* stream) {
  const Call a{q,  k, v, dout,  lse,    delta,  dq,    nullptr, nullptr,
               bh, S, d, dtype, causal, window, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<kDq>(a);
}

extern "C" const char* flash_sm90_error_string(int code) {
  if (code == kErrNoEncoder) return "the driver has no cuTensorMapEncodeTiled";
  if (code >= kErrEncode) return "cuTensorMapEncodeTiled refused the tensor map (code - 1000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
