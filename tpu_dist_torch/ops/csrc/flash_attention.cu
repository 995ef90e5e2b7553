// Flash attention for Hopper (sm_90a) on the SIMT cores: forward, dK/dV and
// dQ kernels for every input type and head dim up to 256.
//
// Replaces the three Pallas TPU kernels of tpu_dist/ops/flash_attention.py,
// which the JAX package runs for dense attention under TPU_DIST_FLASH=1:
//   flash_fwd_kernel  <- `_flash_kernel` (:47): streaming softmax over key
//                        tiles with an f32 running max, denominator and
//                        accumulator; writes out and the per-row LSE.
//   flash_dkv_kernel  <- `_dkv_kernel` (:184): one block per key tile,
//                        scanning query tiles; dV = P^T dO, dK = dS^T Q scale.
//   flash_dq_kernel   <- `_dq_kernel` (:233): one block per query tile,
//                        scanning key tiles; dQ = dS K scale.
// with P = exp(Q K^T scale - lse) and dS = P * (dO V^T - D), D = rowsum(dO O).
// Same function as the TPU kernels: q, k, v (bh, S, d) in float32,
// bfloat16 or float16, every product and the softmax in float32 (FFMA, no
// TF32), out/dq/dk/dv in the input type, lse (bh, S) in float32; masked
// logits are -1e30 and masked probabilities exactly 0, as there.  `scale`
// multiplies q before the score product, as `qs = q * scale` does on the
// TPU; dK and dQ are multiplied by `scale` once, after their whole sum, as
// the plain version does.  ops/flash_attention_sm90.cu takes bfloat16 and
// float16 at head dims 64 and 128 on the tensor cores; these kernels take
// float32 (whose products TF32 would round) and every other head dim.
//
// Not the same blocking.  The TPU grid walks (bh, S/256) programs in order
// on one core, with whole K/V rows resident in VMEM.  Here each block owns
// one tile of the output (query rows for the forward and dQ, keys for
// dK/dV), streams the other side's tiles through shared memory, and keeps
// its accumulators in registers; blocks run in any order, and the two
// backward kernels each own their output, so nothing is summed across
// blocks: no atomics, and the gradients are the same from run to run.
// Causal and window tiles that are wholly masked are skipped with the TPU
// kernels' own range formulas (mirrored in Python as `key_tile_range` /
// `query_tile_range` and tested there).  A ragged last tile is masked, so
// any S works.  The head dim is padded with zeros to the template width D
// (16, 32, 64, 128 or 256).  Offsets into q, k, v and the outputs are
// 64-bit, so bh * S * d may pass 2^31.
//
// What bounds the forward and dK/dV on the H100.  At the LM shape (bh =
// 192, S = 1024, d = 64, causal) in float32 the forward is 2 products of
// 2*bh*S^2*d FLOP at the causal fraction, 25.8 GFLOP on 201 MB: operations
// bound it, 0.385 ms at the 67 TFLOP/s FFMA peak (dK/dV: 4 products, 0.770
// ms).  An SM issues 128 FFMA a clock and reads 128 bytes (32 floats) a
// clock from shared memory, so the products are fed from registers as much
// as they can be, every shared-memory read is a vector, and no load is
// waited for while the products could run.
// - Forward: both products are outer products, one step of the reduction
//   at a time, as a SIMT matrix product is.  (q * scale) and K lie in shared
//   memory transposed (head dim outermost), P^T likewise (key outermost),
//   V as it is; a thread owns 4 query rows by 8 keys of S and the same 4
//   rows by d/8 columns of O, and per step reads its 4 rows as one 16-byte
//   load (a broadcast within its quarter-warp) and its 8 keys or columns as
//   two, loaded one step ahead into registers.  This tile's V is copied
//   with 16-byte `cp.async` during the score product and softmax and
//   waited for only before P V; the next key tile's K is loaded into
//   registers during P V and stored transposed after it; so one buffer of
//   each serves and a tile takes two barriers.  q is staged times scale *
//   log2 e, so the scores are in log2 units and the softmax takes 2^x on
//   the SFU (lse = m ln 2 + ln l).  At d = 32 and 64 a block takes 128 query rows on 256
//   threads, so each K and V tile read from L2 serves 128 rows.
// - dK/dV: four products on 4 keys by 4 queries a thread (2 x 8 at D =
//   128, 1 x 4 at 256), each read from
//   shared memory 4 elements at a time along its reduction axis (the head
//   dim in S^T and dP^T, the query axis in dV and dK) as one 16-byte load
//   (8 bytes in bf16/f16); K and V stay resident, Q, dO, lse and D stream
//   in by `cp.async` (32-query tiles at d <= 64, three blocks an SM;
//   double-buffered 64- and 32-query tiles at the larger widths); P^T and
//   dS^T pass through shared memory at a pitch of cols + 8 floats, so a
//   warp's scalar stores hit 32 distinct banks.
// - Rows of K, V, Q and dO tiles lie D + 16 bytes apart, so the 8 rows a
//   quarter-warp reads fall on distinct banks and every row stays 16-byte
//   aligned; tiles wholly inside the visible band skip the mask; row max
//   and row sum are `__shfl_xor_sync` over the 8 threads of a row.
//   `__launch_bounds__` caps the registers so that two or three blocks
//   share an SM.
// dQ keeps the first design: 64-row tiles (32 at D = 256), 4 x 4 per
// thread, scalar reads from (D + 1)-float rows.
//
// The dK/dV kernel keeps what makes it exact: each dK element is one FMA
// chain over the queries in query order (the plain version's in-order
// product wherever that is one sum), scaled once after the sum; the score
// product is one FMA chain over d of q * scale and k, and P = expf(S - lse)
// as torch computes it.
//
// The forward's exponent is not expf: it is the SFU's approximate 2^x
// (`ex2.approx.ftz.f32`, at most 2 ulp from the rounded 2^x, results below
// 2^-126 flushed to 0) of scores staged as q * (scale * log2 e).  That stays
// inside float32's contract: each P is within a few ulp of exp(S - m) (the
// log2 e factor adds one rounding of the score), every row's sum holds its
// maximum's 1, so what the flush drops lies below 2^-126 of that sum, and
// masked entries are set to exactly 0 apart from the exponent.  The result
// differs from torch's expf path by float32 rounding only, well inside
// FLASH_TOL[float32] (1e-4).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

// dQ: a block of 4 * TILE threads, (TILE / 4) x 16: thread (ty, tx) owns
// the tile rows ty*4 + r (r < 4) and the columns tx + 16c of every row.
template <int TILE>
struct Tiling {
  static constexpr int kThreads = 4 * TILE;
  static constexpr int kCols = TILE / 16;  // score columns per thread
  static constexpr int kPLD = TILE + 1;    // row stride of the score tiles
};
constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernels

using index_t = long long;  // offsets into (bh, S, d) arrays

enum DType { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half(v);
}

__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && (a < 0) != (b < 0)) ? q - 1 : q;
}

__host__ __device__ __forceinline__ int num_tiles(int S, int tile) {
  return (S + tile - 1) / tile;
}

// Key tiles [lo, hi) of bk keys that query tile i of bq rows can see
// (flash_attention.py:80-92).
__device__ __forceinline__ void key_tile_range(int i, int S, int bq, int bk, int causal,
                                               int window, int* lo, int* hi) {
  const int n = num_tiles(S, bk);
  *hi = causal ? min(n, floor_div((i + 1) * bq + bk - 1, bk)) : n;
  *lo = window > 0 ? max(0, floor_div(i * bq - window + 1, bk)) : 0;
}

// Query tiles [lo, hi) of bq rows that can see key tile j of bk keys
// (flash_attention.py:216-225).
__device__ __forceinline__ void query_tile_range(int j, int S, int bq, int bk, int causal,
                                                 int window, int* lo, int* hi) {
  const int n = num_tiles(S, bq);
  *lo = causal ? floor_div(j * bk, bq) : 0;
  *hi = window > 0 ? min(n, floor_div((j + 1) * bk - 1 + window - 1, bq) + 1) : n;
}

__device__ __forceinline__ bool visible(int qp, int kp, int S, int causal,
                                        int window) {
  if (qp >= S || kp >= S) return false;  // the ragged last tile
  if (causal && kp > qp) return false;
  if (window > 0 && kp <= qp - window) return false;
  return true;
}

// ------------------------------------------------------- forward and dK/dV

constexpr int kRowGroups = 16;  // threads along the block's own tile
constexpr int kColGroups = 8;   // threads along the streamed tile: a quarter-warp
constexpr int kThreads = kRowGroups * kColGroups;

// Row pitch, in elements, of a K, V, Q or dO tile: D + 16 bytes, so eight
// consecutive rows start in eight different 16-byte bank groups.
template <typename T, int D>
__host__ __device__ constexpr int row_pitch() {
  return D + static_cast<int>(16 / sizeof(T));
}

// Reductions over the 8 threads (lanes 8g .. 8g + 7) that share a score row.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// `bytes` of 16 (or 4) copied to shared memory asynchronously, zeros after
// them; 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// N (2 or 4) consecutive elements from shared memory in one load, as float.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x, out[1] = v.y;
  }
}
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) { return __bfloat1622float2(v); }
__device__ __forceinline__ float2 to_float2(__half2 v) { return __half22float2(v); }
// bfloat16 and float16: pairs, converted as pairs
template <int N, typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  using T2 = typename std::conditional<std::is_same<T, __half>::value, __half2,
                                       __nv_bfloat162>::type;
  if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = to_float2(*reinterpret_cast<const T2*>(&raw.x));
    const float2 b = to_float2(*reinterpret_cast<const T2*>(&raw.y));
    out[0] = a.x, out[1] = a.y, out[2] = b.x, out[3] = b.y;
  } else {
    const float2 a = to_float2(*reinterpret_cast<const T2*>(p));
    out[0] = a.x, out[1] = a.y;
  }
}

// Copy rows [row0, row0 + ROWS) of a row-major (S, d) matrix into a
// (ROWS, row_pitch) shared tile in the same type; rows past S and columns
// past d are zeros, which add nothing to any product.  `vec`: 16-byte
// `cp.async` copies (d * sizeof(T) a multiple of 16 and the matrix 16-byte
// aligned), waited for at the next `cp_async_wait_all`; else element by
// element.
template <typename T, int D, int ROWS, int THREADS = kThreads>
__device__ __forceinline__ void copy_rows(T* dst, const T* __restrict__ src, int row0,
                                          int S, int d, bool vec) {
  constexpr int P = row_pitch<T, D>();
  if (vec) {
    constexpr int E = 16 / sizeof(T);  // elements per copy
    constexpr int CHUNKS = D / E;
    for (int c = threadIdx.x; c < ROWS * CHUNKS; c += THREADS) {
      const int r = c / CHUNKS;
      const int col = (c % CHUNKS) * E;
      const bool in = row0 + r < S && col < d;
      cp_async16(dst + r * P + col, in ? src + (index_t)(row0 + r) * d + col : src,
                 in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * D; e += THREADS) {
      const int r = e / D;
      const int c = e % D;
      const bool in = row0 + r < S && c < d;
      store(dst + r * P + c, in ? to_float(src[(index_t)(row0 + r) * d + c]) : 0.0f);
    }
  }
}

// Entries [row0, row0 + ROWS) of a float32 (S,) row vector; 0 past S.
template <int ROWS>
__device__ __forceinline__ void copy_vector(float* dst, const float* __restrict__ src,
                                            int row0, int S) {
  for (int r = threadIdx.x; r < ROWS; r += kThreads) {
    const bool in = row0 + r < S;
    cp_async4(dst + r, in ? src + row0 + r : src, in ? 4 : 0);
  }
}

// 2^x by the SFU, approximate (at most 2 ulp; results below 2^-126 flushed
// to 0): the forward keeps its scores in log2 units.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// N consecutive elements of row `row` of a row-major (S, d) matrix, from
// column c, as float; 0 past S and past d.  `vec`: rows are whole 16-byte
// chunks and 16-byte aligned, so 16 bytes (N = 16 / sizeof(T)) are one load.
template <int N, typename T>
__device__ __forceinline__ void load_global(const T* __restrict__ src, int row, int c, int S,
                                            int d, bool vec, float* out) {
  const T* p = src + (index_t)row * d + c;
  if (vec && row < S && c + N <= d) {
    if constexpr (sizeof(T) == 4 && N == 4) {
      load_vec<4>(reinterpret_cast<const float*>(p), out);
      return;
    } else if constexpr (sizeof(T) == 2 && N == 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p);  // one 16-byte load
      load_vec<4>(reinterpret_cast<const T*>(&raw.x), out);
      load_vec<4>(reinterpret_cast<const T*>(&raw.z), out + 4);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] = row < S && c + e < d ? to_float(p[e]) : 0.0f;
}

// The forward's tiles.  Thread (ty, tx) of RG x 8 owns TM query rows
// g * RG RW + ty RW + i, TN keys g * 8 KW + tx KW + j of each key tile and
// TD output columns g * 8 VW + tx VW + e, in runs of RW, KW and VW (4, or
// fewer where the tile is narrower) that it reads as one vector.
template <typename T, int D, int BM, int BN, int TM_>
struct FwdTile {
  static constexpr int TM = TM_;
  static constexpr int RG = BM / TM;             // row groups
  static constexpr int THREADS = RG * kColGroups;
  static constexpr int TN = BN / kColGroups;
  static constexpr int TD = D / kColGroups;
  static constexpr int RW = TM < 4 ? TM : 4;
  static constexpr int KW = TN < 4 ? TN : 4;
  static constexpr int VW = TD < 4 ? TD : 4;
  static constexpr int PP = BM + 4;                  // P^T row pitch, floats
  static constexpr int E = 16 / sizeof(T);           // elements in 16 bytes
  static constexpr int KCH = BN * D / E / THREADS;   // 16-byte K chunks a thread fetches
  static constexpr int QCH = BM * D / E / THREADS;   // 16-byte Q chunks a thread fetches
  static_assert(TM * RG == BM && TN * kColGroups == BN, "tile must split evenly");
  static_assert(KCH * E * THREADS == BN * D && THREADS % BN == 0, "K fetch must split evenly");
  static_assert(QCH * E * THREADS == BM * D && THREADS % BM == 0, "Q fetch must split evenly");
  __device__ static int row(int ty, int a) { return (a / RW) * RG * RW + ty * RW + a % RW; }
  __device__ static int key(int tx, int b) { return (b / KW) * kColGroups * KW + tx * KW + b % KW; }
  __device__ static int col(int tx, int c) { return (c / VW) * kColGroups * VW + tx * VW + c % VW; }
};

// Shared memory of a forward block: (q * scale)^T and K^T in float32, head
// dim outermost; P^T in float32; V in the input type.
template <typename T, int D, int BM, int BN, int TM>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (D * BM + D * BN + BN * FwdTile<T, D, BM, BN, TM>::PP) +
         sizeof(T) * BN * row_pitch<T, D>();
}

// One block per (query tile, batch-head), longest causal rows first.  Both
// products are outer products, one step of the reduction at a time (a head
// dim in S = (q * scale) K^T, a key in O = P V), from fragments loaded one
// step ahead into registers.  Nothing waits for a load: this tile's V is
// copied by `cp.async` during the score product and softmax and waited for
// only before P V; the next key tile's K is loaded into registers during
// P V and stored transposed after it.  MIN_BLOCKS blocks an SM bound the
// registers.
template <typename T, int D, int BM, int BN, int TM_, int MIN_BLOCKS>
__global__ void __launch_bounds__(FwdTile<T, D, BM, BN, TM_>::THREADS, MIN_BLOCKS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int S, int d, float scale,
                     int causal, int window, int vec) {
  using L = FwdTile<T, D, BM, BN, TM_>;
  constexpr int TM = L::TM, TN = L::TN, TD = L::TD, RW = L::RW, KW = L::KW, VW = L::VW;
  constexpr int PP = L::PP, E = L::E, KCH = L::KCH, QCH = L::QCH, RG = L::RG;
  constexpr int THREADS = L::THREADS;
  constexpr int VP = row_pitch<T, D>();
  extern __shared__ __align__(16) unsigned char shared[];
  float* Qt = reinterpret_cast<float*>(shared);  // [D][BM]
  float* Kt = Qt + D * BM;                        // [D][BN]
  float* Pt = Kt + D * BN;                        // [BN][PP]
  T* Vs = reinterpret_cast<T*>(Pt + BN * PP);     // [BN][VP]

  const int tx = threadIdx.x % kColGroups;
  const int ty = threadIdx.x / kColGroups;
  const index_t bh = blockIdx.x;
  const int i = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const index_t base = bh * S * d;
  const int q0 = i * BM;
  int lo, hi;
  key_tile_range(i, S, BM, BN, causal, window, &lo, &hi);

  // K chunk n of this thread: key c % BN, head dims c / BN * E .. + E - 1,
  // c = threadIdx.x + n * THREADS (K^T stores of 32 consecutive keys a warp)
  float kreg[KCH][E];
  auto fetch_k = [&](int j) {
#pragma unroll
    for (int n = 0; n < KCH; ++n) {
      const int c = threadIdx.x + n * THREADS;
      load_global<E>(k + base, j * BN + c % BN, c / BN * E, S, d, vec, kreg[n]);
    }
  };
  auto stash_k = [&]() {
#pragma unroll
    for (int n = 0; n < KCH; ++n) {
      const int c = threadIdx.x + n * THREADS;
#pragma unroll
      for (int e = 0; e < E; ++e) Kt[(c / BN * E + e) * BN + c % BN] = kreg[n][e];
    }
  };

  if (lo < hi) fetch_k(lo);
  {  // (q * scale * log2 e)^T, every load in flight, then the stores: the
     // scores come out in log2 units, so the softmax takes 2^x directly
    float qreg[QCH][E];
#pragma unroll
    for (int n = 0; n < QCH; ++n) {
      const int c = threadIdx.x + n * THREADS;
      load_global<E>(q + base, q0 + c % BM, c / BM * E, S, d, vec, qreg[n]);
    }
#pragma unroll
    for (int n = 0; n < QCH; ++n) {
      const int c = threadIdx.x + n * THREADS;
#pragma unroll
      for (int e = 0; e < E; ++e) Qt[(c / BM * E + e) * BM + c % BM] = qreg[n][e] * (scale * kLog2e);
    }
  }
  if (lo < hi) stash_k();

  float m[TM], l[TM], o[TM][TD];
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    m[a] = kNegInf;
    l[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < TD; ++c) o[a][c] = 0.0f;
  }

  for (int j = lo; j < hi; ++j) {
    __syncthreads();  // K_j^T is in; the previous tile's P^T and V are read
    copy_rows<T, D, BN, THREADS>(Vs, v + base, j * BN, S, d, vec);  // waited for before P V
    cp_async_commit();

    // S = (q * scale) K^T, one head dim a step
    float s[TM][TN];
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TN; ++b) s[a][b] = 0.0f;
    float qf[2][TM], kf[2][TN];
    auto load_qk = [&](int c, float* qa, float* kb) {
#pragma unroll
      for (int g = 0; g < TM / RW; ++g)
        load_vec<RW>(Qt + c * BM + g * RG * RW + ty * RW, qa + g * RW);
#pragma unroll
      for (int g = 0; g < TN / KW; ++g)
        load_vec<KW>(Kt + c * BN + g * kColGroups * KW + tx * KW, kb + g * KW);
    };
    load_qk(0, qf[0], kf[0]);
#pragma unroll 4
    for (int c = 0; c < D; c += 2) {
      load_qk(c + 1, qf[1], kf[1]);
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b) s[a][b] = fmaf(qf[0][a], kf[0][b], s[a][b]);
      if (c + 2 < D) load_qk(c + 2, qf[0], kf[0]);
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b) s[a][b] = fmaf(qf[1][a], kf[1][b], s[a][b]);
    }

    // online softmax of each row; P^T to shared memory
    const int k0 = j * BN;
    const bool edge = k0 + BN > S || q0 + BM > S || (causal && k0 + BN - 1 > q0) ||
                      (window > 0 && k0 <= q0 + BM - 1 - window);
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      const int qp = q0 + L::row(ty, a);
      if (edge) {
#pragma unroll
        for (int b = 0; b < TN; ++b)
          if (!visible(qp, k0 + L::key(tx, b), S, causal, window)) s[a][b] = kNegInf;
      }
      float mt = kNegInf;
#pragma unroll
      for (int b = 0; b < TN; ++b) mt = fmaxf(mt, s[a][b]);
      const float m_new = fmaxf(m[a], row_max(mt));
      const float correction = exp2_approx(m[a] - m_new);
      float ps = 0.0f;
#pragma unroll
      for (int b = 0; b < TN; ++b) {
        // a masked logit is -1e30: exactly 0 unless the whole row so far is masked
        s[a][b] = s[a][b] == kNegInf ? 0.0f : exp2_approx(s[a][b] - m_new);
        ps += s[a][b];
      }
      l[a] = l[a] * correction + row_sum(ps);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < TD; ++c) o[a][c] *= correction;
    }
#pragma unroll
    for (int b = 0; b < TN; ++b)
#pragma unroll
      for (int g = 0; g < TM / RW; ++g) {
        float* dst = Pt + L::key(tx, b) * PP + g * RG * RW + ty * RW;
        if constexpr (RW == 4) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(s[g * 4][b], s[g * 4 + 1][b], s[g * 4 + 2][b], s[g * 4 + 3][b]);
        } else {
#pragma unroll
          for (int r = 0; r < RW; ++r) dst[r] = s[g * RW + r][b];
        }
      }
    cp_async_wait_all();
    __syncthreads();  // P^T is written and V_j is in; K^T is read
    if (j + 1 < hi) fetch_k(j + 1);  // in flight during P V

    // O += P V, one key a step
    float pf[2][TM], vf[2][TD];
    auto load_pv = [&](int key, float* pa, float* vb) {
#pragma unroll
      for (int g = 0; g < TM / RW; ++g)
        load_vec<RW>(Pt + key * PP + g * RG * RW + ty * RW, pa + g * RW);
#pragma unroll
      for (int g = 0; g < TD / VW; ++g)
        load_vec<VW>(Vs + key * VP + g * kColGroups * VW + tx * VW, vb + g * VW);
    };
    load_pv(0, pf[0], vf[0]);
#pragma unroll 4
    for (int key = 0; key < BN; key += 2) {
      load_pv(key + 1, pf[1], vf[1]);
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int c = 0; c < TD; ++c) o[a][c] = fmaf(pf[0][a], vf[0][c], o[a][c]);
      if (key + 2 < BN) load_pv(key + 2, pf[0], vf[0]);
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int c = 0; c < TD; ++c) o[a][c] = fmaf(pf[1][a], vf[1][c], o[a][c]);
    }
    if (j + 1 < hi) stash_k();
  }

#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int qp = q0 + L::row(ty, a);
    if (qp >= S) continue;
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      const int col = L::col(tx, c);
      if (col < d) store(out + base + (index_t)qp * d + col, o[a][c] / l[a]);
    }
    if (tx == 0) lse[bh * S + qp] = m[a] * kLn2 + logf(l[a]);
  }
}

// The dK/dV kernel's tiles: BN keys per block (thread keys ty + 16 r,
// r < TK), BQ queries per streamed tile (thread queries tx + 8 c, c < TQ),
// dK and dV columns (c * 8 + tx) * VW + e of each key (TD per thread).
template <int D, int BN, int BQ>
struct DkvTile {
  static constexpr int TK = BN / kRowGroups;
  static constexpr int TQ = BQ / kColGroups;
  static constexpr int TD = D / kColGroups;
  static constexpr int VW = TD < 4 ? TD : 4;
  static constexpr int PLD = BQ + 8;  // P^T and dS^T row pitch, floats
  static_assert(TK * kRowGroups == BN && TQ * kColGroups == BQ, "tile must split evenly");
  static_assert(PLD % 32 == 8, "P^T rows 8 banks apart");
};

// Shared memory of a dK/dV block: K and V resident, STAGES Q and dO tiles
// in the input type, P^T and dS^T, STAGES lse and D rows.
template <typename T, int D, int BN, int BQ, int STAGES>
constexpr size_t dkv_smem_bytes() {
  return 2 * sizeof(T) * BN * row_pitch<T, D>() +
         2 * sizeof(T) * STAGES * BQ * row_pitch<T, D>() +
         2 * sizeof(float) * BN * DkvTile<D, BN, BQ>::PLD + 2 * sizeof(float) * STAGES * BQ;
}

// One block per (key tile, batch-head), the longest causal scans (low key
// tiles) first.  Q is staged unscaled: the score product scales each Q
// value as it reads it (the same float32 product as the forward's staged
// q * scale), and dK takes `scale` once at write-out, after its whole sum.
template <typename T, int D, int BN, int BQ, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int d, float scale, int causal,
                     int window, int vec) {
  using L = DkvTile<D, BN, BQ>;
  constexpr int TK = L::TK, TQ = L::TQ, TD = L::TD, VW = L::VW, PLD = L::PLD;
  constexpr int KP = row_pitch<T, D>();
  extern __shared__ __align__(16) unsigned char shared[];
  T* Ks = reinterpret_cast<T*>(shared);                        // [BN][KP]
  T* Vs = Ks + BN * KP;                                        // [BN][KP]
  T* Qs = Vs + BN * KP;                                        // [STAGES][BQ][KP]
  T* dOs = Qs + STAGES * BQ * KP;                              // [STAGES][BQ][KP]
  float* Pt = reinterpret_cast<float*>(dOs + STAGES * BQ * KP);  // [BN][PLD]
  float* dSt = Pt + BN * PLD;                                  // [BN][PLD]
  float* Ls = dSt + BN * PLD;                                  // [STAGES][BQ]
  float* Ds = Ls + STAGES * BQ;                                // [STAGES][BQ]

  const int tx = threadIdx.x % kColGroups;
  const int ty = threadIdx.x / kColGroups;
  const index_t bh = blockIdx.x;
  const int j = blockIdx.y;  // longest causal scans (low j) first
  const index_t base = bh * S * d;
  const index_t row_base = bh * S;
  const int k0 = j * BN;
  int lo, hi;
  query_tile_range(j, S, BQ, BN, causal, window, &lo, &hi);

  auto fetch = [&](int qi, int buf) {  // query tile qi's Q, dO, lse and D
    copy_rows<T, D, BQ>(Qs + buf * BQ * KP, q + base, qi * BQ, S, d, vec);
    copy_rows<T, D, BQ>(dOs + buf * BQ * KP, dout + base, qi * BQ, S, d, vec);
    copy_vector<BQ>(Ls + buf * BQ, lse + row_base, qi * BQ, S);
    copy_vector<BQ>(Ds + buf * BQ, delta + row_base, qi * BQ, S);
  };
  copy_rows<T, D, BN>(Ks, k + base, k0, S, d, vec);
  copy_rows<T, D, BN>(Vs, v + base, k0, S, d, vec);
  if (lo < hi) fetch(lo, 0);
  cp_async_commit();

  float dk_acc[TK][TD], dv_acc[TK][TD];
#pragma unroll
  for (int r = 0; r < TK; ++r)
#pragma unroll
    for (int c = 0; c < TD; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.0f;

  for (int qi = lo; qi < hi; ++qi) {
    const int buf = (qi - lo) % STAGES;
    if constexpr (STAGES == 1) {
      if (qi > lo) {
        __syncthreads();  // the previous tile's Q, dO, lse and D are no longer read
        fetch(qi, 0);
        cp_async_commit();
      }
    }
    cp_async_wait_all();
    __syncthreads();  // tile qi has landed; the previous tile's P^T and dS^T are read
    if constexpr (STAGES == 2) {
      if (qi + 1 < hi) {  // into the buffer the previous tile used
        fetch(qi + 1, buf ^ 1);
        cp_async_commit();
      }
    }
    const T* Qt = Qs + buf * BQ * KP;
    const T* dOt = dOs + buf * BQ * KP;
    const float* Lt = Ls + buf * BQ;
    const float* Dt = Ds + buf * BQ;
    const int q0 = qi * BQ;
    const bool edge = k0 + BN > S || q0 + BQ > S || (causal && k0 + BN - 1 > q0) ||
                      (window > 0 && k0 <= q0 + BQ - 1 - window);

    // S^T = K (q * scale)^T and dP^T = V dO^T over 4-wide chunks of the
    // head dim; each score one FMA chain over d in order
    float st[TK][TQ], dpt[TK][TQ];
#pragma unroll
    for (int r = 0; r < TK; ++r)
#pragma unroll
      for (int c = 0; c < TQ; ++c) st[r][c] = dpt[r][c] = 0.0f;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      float kf[TK][4], vf[TK][4];
#pragma unroll
      for (int r = 0; r < TK; ++r) {
        load_vec<4>(Ks + (ty + kRowGroups * r) * KP + c, kf[r]);
        load_vec<4>(Vs + (ty + kRowGroups * r) * KP + c, vf[r]);
      }
#pragma unroll
      for (int b = 0; b < TQ; ++b) {
        float qf[4], of[4];
        load_vec<4>(Qt + (tx + kColGroups * b) * KP + c, qf);
        load_vec<4>(dOt + (tx + kColGroups * b) * KP + c, of);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float qs = qf[e] * scale;
#pragma unroll
          for (int r = 0; r < TK; ++r) {
            st[r][b] = fmaf(qs, kf[r][e], st[r][b]);
            dpt[r][b] = fmaf(of[e], vf[r][e], dpt[r][b]);
          }
        }
      }
    }

    // P^T = exp(S^T - lse), dS^T = P^T (dP^T - D) to shared memory
#pragma unroll
    for (int r = 0; r < TK; ++r) {
      const int key = ty + kRowGroups * r;
#pragma unroll
      for (int b = 0; b < TQ; ++b) {
        const int qrow = tx + kColGroups * b;
        const bool vis = !edge || visible(q0 + qrow, k0 + key, S, causal, window);
        const float p = vis ? expf(st[r][b] - Lt[qrow]) : 0.0f;
        Pt[key * PLD + qrow] = p;
        dSt[key * PLD + qrow] = p * (dpt[r][b] - Dt[qrow]);
      }
    }
    __syncthreads();  // P^T and dS^T are written

    // dV += P^T dO and dK += dS^T Q over 4-query chunks, queries in order
#pragma unroll 2
    for (int qc = 0; qc < BQ; qc += 4) {
      float p[TK][4], ds[TK][4];
#pragma unroll
      for (int r = 0; r < TK; ++r) {
        load_vec<4>(Pt + (ty + kRowGroups * r) * PLD + qc, p[r]);
        load_vec<4>(dSt + (ty + kRowGroups * r) * PLD + qc, ds[r]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float of[TD], qf[TD];
#pragma unroll
        for (int c = 0; c < TD / VW; ++c) {
          load_vec<VW>(dOt + (qc + e) * KP + (c * kColGroups + tx) * VW, of + c * VW);
          load_vec<VW>(Qt + (qc + e) * KP + (c * kColGroups + tx) * VW, qf + c * VW);
        }
#pragma unroll
        for (int r = 0; r < TK; ++r)
#pragma unroll
          for (int c = 0; c < TD; ++c) {
            dv_acc[r][c] = fmaf(p[r][e], of[c], dv_acc[r][c]);
            dk_acc[r][c] = fmaf(ds[r][e], qf[c], dk_acc[r][c]);
          }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < TK; ++r) {
    const int kp = k0 + ty + kRowGroups * r;
    if (kp >= S) continue;
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      const int col = ((c / VW) * kColGroups + tx) * VW + c % VW;
      if (col >= d) continue;
      store(dk + base + (index_t)kp * d + col, dk_acc[r][c] * scale);
      store(dv + base + (index_t)kp * d + col, dv_acc[r][c]);
    }
  }
}

// ------------------------------------------------------------------- dQ

// Stage rows [row0, row0 + TILE) of a row-major (S, d) matrix as float32,
// times `mul`, into a (TILE, D + 1) shared tile; rows past S and columns
// past d read as 0, which adds nothing to any product.
template <typename T, int D, int TILE>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int S, int d, float mul) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < TILE * D; e += Tiling<TILE>::kThreads) {
    const int r = e / D;
    const int c = e % D;
    const int gr = row0 + r;
    float v = 0.0f;
    if (gr < S && c < d) v = to_float(src[(index_t)gr * d + c]) * mul;
    dst[r * LD + c] = v;
  }
}

template <int D, int TILE>
constexpr size_t dq_smem_floats() {
  return 4 * TILE * (D + 1) + TILE * Tiling<TILE>::kPLD;
}

// One block per (query tile, batch-head), the layout of the forward; dS
// goes through shared memory to the product over keys.
template <typename T, int D, int TILE>
__global__ void __launch_bounds__(Tiling<TILE>::kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int S,
                    int d, float scale, int causal, int window) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  constexpr int KC = Tiling<TILE>::kCols;
  constexpr int PLD = Tiling<TILE>::kPLD;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + TILE * LD;
  float* Ks = dOs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* dSs = Vs + TILE * LD;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const index_t bh = blockIdx.x;
  const int i = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const index_t base = bh * S * d;
  const index_t row_base = bh * S;
  const int q0 = i * TILE;

  load_tile<T, D, TILE>(Qs, q + base, q0, S, d, scale);
  load_tile<T, D, TILE>(dOs, dout + base, q0, S, d, 1.0f);
  float lr[4], dr[4], dq_acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty * 4 + r;
    lr[r] = qp < S ? lse[row_base + qp] : 0.0f;
    dr[r] = qp < S ? delta[row_base + qp] : 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) dq_acc[r][c] = 0.0f;
  }

  int lo, hi;
  key_tile_range(i, S, TILE, TILE, causal, window, &lo, &hi);
  for (int j = lo; j < hi; ++j) {
    const int k0 = j * TILE;
    __syncthreads();
    load_tile<T, D, TILE>(Ks, k + base, k0, S, d, 1.0f);
    load_tile<T, D, TILE>(Vs, v + base, k0, S, d, 1.0f);
    __syncthreads();

    float s[4][KC], dp[4][KC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < KC; ++c) s[r][c] = dp[r][c] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float qr[4], orow[4], kc[KC], vc[KC];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qr[r] = Qs[(ty * 4 + r) * LD + kk];
        orow[r] = dOs[(ty * 4 + r) * LD + kk];
      }
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        kc[c] = Ks[(tx + 16 * c) * LD + kk];
        vc[c] = Vs[(tx + 16 * c) * LD + kk];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          s[r][c] = fmaf(qr[r], kc[c], s[r][c]);
          dp[r][c] = fmaf(orow[r], vc[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + ty * 4 + r;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const bool vis = visible(qp, k0 + tx + 16 * c, S, causal, window);
        const float p = vis ? expf(s[r][c] - lr[r]) : 0.0f;
        dSs[(ty * 4 + r) * PLD + tx + 16 * c] = p * (dp[r][c] - dr[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < TILE; ++kk) {
      float sr[4], kv[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) sr[r] = dSs[(ty * 4 + r) * PLD + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = Ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) dq_acc[r][c] = fmaf(sr[r], kv[c], dq_acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty * 4 + r;
    if (qp >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) store(dq + base + (index_t)qp * d + col, dq_acc[r][c] * scale);
    }
  }
}


// Launches `kernel` on a (bh, S / rows) grid of `threads` with `bytes` of
// dynamic shared memory (above 48 KB a kernel must be allowed it first, or
// the launch is refused).
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t bytes, int threads, int bh, int S, int rows,
                   cudaStream_t stream, Args... args) {
  if (num_tiles(S, rows) > 65535) return cudaErrorInvalidValue;  // grid.y
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, num_tiles(S, rows));
  kernel<<<grid, threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

struct Call {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out;  // out, dk or dq
  void* out2;  // dv
  float* lse_out;
  int bh, S, d, causal, window;
  float scale;
  int rows, cols, stages;  // the forward's and dK/dV's tiling (`simt_tiling`)
  cudaStream_t stream;
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// 16-byte copies of the (bh, S, d) operands: whole rows of 16-byte chunks,
// every operand 16-byte aligned.
template <typename T>
int vector_copies(const Call& a) {
  return (a.d * sizeof(T)) % 16 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
         (a.dout == nullptr || aligned16(a.dout));
}

// Shared memory of an H100: a block may use 227 KB, and an SM holds 228 KB,
// 1 KB of it reserved for each block.
constexpr size_t kBlockShared = 232448;
constexpr size_t kSmShared = 233472;

template <size_t BYTES, int MIN_BLOCKS>
constexpr bool fits_shared() {
  return BYTES <= kBlockShared && MIN_BLOCKS * (BYTES + 1024) <= kSmShared;
}

template <typename T, int D, int BM, int BN, int TM, int MIN_BLOCKS>
cudaError_t run_fwd(const Call& a) {
  constexpr size_t bytes = fwd_smem_bytes<T, D, BM, BN, TM>();
  static_assert(fits_shared<bytes, MIN_BLOCKS>(), "MIN_BLOCKS blocks must fit an SM");
  return launch(flash_fwd_kernel<T, D, BM, BN, TM, MIN_BLOCKS>, bytes,
                FwdTile<T, D, BM, BN, TM>::THREADS, a.bh, a.S, BM, a.stream, static_cast<const T*>(a.q),
                static_cast<const T*>(a.k), static_cast<const T*>(a.v), static_cast<T*>(a.out),
                a.lse_out, a.S, a.d, a.scale, a.causal, a.window, vector_copies<T>(a));
}

template <typename T, int D, int BN, int BQ, int STAGES, int MIN_BLOCKS>
cudaError_t run_dkv(const Call& a) {
  constexpr size_t bytes = dkv_smem_bytes<T, D, BN, BQ, STAGES>();
  static_assert(fits_shared<bytes, MIN_BLOCKS>(), "MIN_BLOCKS blocks must fit an SM");
  return launch(flash_dkv_kernel<T, D, BN, BQ, STAGES, MIN_BLOCKS>, bytes,
                kThreads, a.bh, a.S, BN, a.stream, static_cast<const T*>(a.q),
                static_cast<const T*>(a.k), static_cast<const T*>(a.v),
                static_cast<const T*>(a.dout), a.lse_in, a.delta, static_cast<T*>(a.out),
                static_cast<T*>(a.out2), a.S, a.d, a.scale, a.causal, a.window,
                vector_copies<T>(a));
}

template <typename T, int D, int TILE>
cudaError_t run_dq(const Call& a) {
  return launch(flash_dq_kernel<T, D, TILE>, sizeof(float) * dq_smem_floats<D, TILE>(),
                Tiling<TILE>::kThreads, a.bh, a.S, TILE, a.stream, static_cast<const T*>(a.q),
                static_cast<const T*>(a.k), static_cast<const T*>(a.v),
                static_cast<const T*>(a.dout), a.lse_in, a.delta, static_cast<T*>(a.out), a.S,
                a.d, a.scale, a.causal, a.window);
}

enum Which { kFwd = 0, kDkv = 1, kDq = 2 };

// The one tiling of the forward and of dK/dV built at each template width
// D (`simt_tiling` in ops/flash_attention.py names its rows, cols and
// stages; any other is refused, so the two cannot drift apart unseen), and
// dQ's tile (`tile_rows` mirrors it).
template <typename T, int D>
cudaError_t run(int which, const Call& a) {
  // The forward: (query rows, key tile, thread rows, blocks an SM); 256
  // threads at D = 32 and 64, 128 at the others.  dK/dV: (keys, query
  // tile, stages, blocks an SM).
  constexpr int kFwdRows = D == 32 || D == 64 ? 128 : D <= 128 ? 64 : 32;
  constexpr int kFwdCols = D <= 64 ? 64 : D == 128 ? 32 : 16;
  constexpr int kFwdTM = D <= 128 ? 4 : 2;
  constexpr int kFwdBlocks = kFwdRows / kFwdTM * kColGroups == 256 ? 2 : D <= 64 ? 3 : 1;
  constexpr int kDkvRows = D <= 64 ? 64 : D == 128 ? 32 : 16;
  constexpr int kDkvCols = D <= 64 ? 32 : D == 128 ? 64 : 32;
  constexpr int kDkvStages = D <= 64 ? 1 : 2;
  constexpr int kDkvBlocks = D <= 64 ? 3 : 1;
  switch (which) {
    case kFwd:
      if (a.rows != kFwdRows || a.cols != kFwdCols || a.stages != 1)
        return cudaErrorInvalidValue;
      return run_fwd<T, D, kFwdRows, kFwdCols, kFwdTM, kFwdBlocks>(a);
    case kDkv:
      if (a.rows != kDkvRows || a.cols != kDkvCols || a.stages != kDkvStages)
        return cudaErrorInvalidValue;
      return run_dkv<T, D, kDkvRows, kDkvCols, kDkvStages, kDkvBlocks>(a);
    case kDq:
      return run_dq<T, D, (D <= 128 ? 64 : 32)>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t pick_width(int which, const Call& a) {
  if (a.d <= 16) return run<T, 16>(which, a);
  if (a.d <= 32) return run<T, 32>(which, a);
  if (a.d <= 64) return run<T, 64>(which, a);
  if (a.d <= 128) return run<T, 128>(which, a);
  if (a.d <= 256) return run<T, 256>(which, a);
  return cudaErrorInvalidValue;
}

int dispatch(int which, int dtype, const Call& a) {
  if (a.bh <= 0 || a.S <= 0 || a.d <= 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case kFloat32:
      return pick_width<float>(which, a);
    case kBFloat16:
      return pick_width<__nv_bfloat16>(which, a);
    case kFloat16:
      return pick_width<__half>(which, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success).  q, k, v, dout and the outputs are
// contiguous (bh, S, d) device arrays of one dtype (0 float32, 1 bfloat16,
// 2 float16), d <= 256; lse and delta are contiguous (bh, S) float32.
// window <= 0 means no window.  rows, cols, stages: the tiling
// `simt_tiling` chose (cudaErrorInvalidValue for one this source does not
// build).  The caller allocates every output.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, float* lse, int bh, int S, int d,
                         float scale, int dtype, int causal, int window, int rows,
                         int cols, int stages, void* stream) {
  Call a{q, k, v, nullptr, nullptr, nullptr, out, nullptr, lse, bh, S, d,
         causal, window, scale, rows, cols, stages, static_cast<cudaStream_t>(stream)};
  return dispatch(kFwd, dtype, a);
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int bh, int S,
                         int d, float scale, int dtype, int causal, int window, int rows,
                         int cols, int stages, void* stream) {
  Call a{q, k, v, dout, lse, delta, dk, dv, nullptr, bh, S, d,
         causal, window, scale, rows, cols, stages, static_cast<cudaStream_t>(stream)};
  return dispatch(kDkv, dtype, a);
}

extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta,
                        void* dq, int bh, int S, int d, float scale, int dtype,
                        int causal, int window, void* stream) {
  Call a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, bh, S, d,
         causal, window, scale, 0, 0, 0, static_cast<cudaStream_t>(stream)};
  return dispatch(kDq, dtype, a);
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
