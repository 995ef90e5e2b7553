// Fused dense layer for Hopper (sm_90a): out = epilogue(x @ w + b).
//
// Replaces the Pallas TPU kernel `_matmul_kernel` (tpu_dist/ops/matmul.py:38),
// which the JAX package runs behind `nn.Dense` under TPU_DIST_PALLAS_DENSE=1.
// Same function: x (M, K), w (K, N), optional b (N,), epilogue none, relu or
// tanh-gelu, float32, bfloat16 or float16 inputs, float32 accumulation, output
// in the input type, any shape whose M, N and K each fit an int: offsets are
// 64-bit and the grid is one-dimensional (up to 2^31 - 1 tiles), so an
// operand may pass 2^31 elements.  Not the same blocking: the TPU kernel walks a sequential
// (M/bm, N/bn, K/bk) grid with the sum carried in VMEM scratch and pads ragged
// dimensions with copies.  Here one thread block owns one output tile, the
// sum lives in registers, and the ragged edge is masked in the loads and the
// stores, so no operand is ever copied to be padded.
//
// What bounds it on the H100: at the shapes the MNIST ConvNet gives it
// (M = 128 in training, 1024 in evaluation; K x N = 320 x 50 and 50 x 10,
// float32) the product is 2*M*N*K = 4.1 MFLOP on 254 KB of operands at
// 128 x 320 x 50, 16 FLOP per byte, below the card's float32 ridge of 20
// (67 TFLOP/s over 3.35 TB/s); 1024 x 320 x 50 sits at about the ridge and
// the 50 x 10 layer far below it.  So bytes bound it, and at these sizes the
// launch itself and the chain of dependent memory round trips cost more
// than either bound.  Two routes; `dense_tiling` in ops/matmul.py picks one
// and its tiles, and passes them here:
// - small (outputs too small to give every SM a 64 x 64 tile): 8 x 8 or
//   16 x 16 output tiles, so the MNIST layers get 32-112 blocks, and the K
//   dimension split across the block's warps.  Every thread issues all its
//   copies of a K chunk (the whole K of these layers) at once with
//   `cp.async`, so a block pays one round trip to memory instead of one per
//   K tile; after one barrier each warp sums its K slice in registers, and
//   the warps' partial sums are added in shared memory in warp order, so
//   the result is the same from run to run.  Bias and epilogue are applied
//   there and each output is written once.
// - large: 64 x 64 tiles with 16-deep K steps, the next K tile fetched into
//   registers while the current one is multiplied out of shared memory.
// Plain float32 FMA on the SIMT cores on both routes (no TF32): tensor cores
// (wgmma) and TMA for large bfloat16 products come later.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, each owns a TM x TN patch

enum Epilogue { kNone = 0, kRelu = 1, kGelu = 2 };
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
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half(v); }

// The output tile of this block: blocks walk a one-dimensional grid, column
// tiles fastest, as a (N / BN, M / BM) grid would.
__device__ __forceinline__ void tile_origin(int BM, int BN, int N, int* row0, int* col0) {
  const long long n_tiles = (N + BN - 1LL) / BN;
  *row0 = static_cast<int>(blockIdx.x / n_tiles) * BM;
  *col0 = static_cast<int>(blockIdx.x % n_tiles) * BN;
}

template <int EPI>
__device__ __forceinline__ float apply_epilogue(float v) {
  if constexpr (EPI == kRelu) {
    return fmaxf(v, 0.0f);
  } else if constexpr (EPI == kGelu) {
    // the tanh form, which jax.nn.gelu computes by default
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
  } else {
    return v;
  }
}

template <typename T, int EPI, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
    fused_dense_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ b, T* __restrict__ out, int M,
                       int N, int K) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  constexpr int A_PER = BM * BK / kThreads;  // x elements a thread fetches
  constexpr int B_PER = BK * BN / kThreads;  // w elements a thread fetches
  static_assert(A_PER * kThreads == BM * BK, "x tile must split evenly");
  static_assert(B_PER * kThreads == BK * BN, "w tile must split evenly");

  // x is stored K-major in shared memory so the inner loop reads TM
  // neighbouring rows; the +1 keeps the transposing stores off one bank.
  __shared__ float xs[2][BK][BM + 1];
  __shared__ float ws[2][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  int row0, col0;
  tile_origin(BM, BN, N, &row0, &col0);

  float x_next[A_PER];
  float w_next[B_PER];
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // Neighbouring threads read neighbouring addresses: along K for x, along
  // N for w.  Out-of-range elements read as zero, which adds nothing.
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * kThreads;
      const int r = row0 + e / BK;
      const int k = k0 + e % BK;
      x_next[i] = (r < M && k < K) ? to_float(x[(size_t)r * K + k]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * kThreads;
      const int k = k0 + e / BN;
      const int c = col0 + e % BN;
      w_next[i] = (k < K && c < N) ? to_float(w[(size_t)k * N + c]) : 0.0f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * kThreads;
      xs[buf][e % BK][e / BK] = x_next[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * kThreads;
      ws[buf][e / BN][e % BN] = w_next[i];
    }
  };

  const int nk = (K + BK - 1) / BK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    if (t + 1 < nk) fetch((t + 1) * BK);  // in flight during the FMAs below
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], v[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[cur][kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) v[j] = ws[cur][kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
    }
    // The other buffer was last read in iteration t - 1, which ended in a
    // barrier, so it may be overwritten now.
    if (t + 1 < nk) stash(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c >= N) continue;
      float s = acc[i][j];
      if (b != nullptr) s += to_float(b[c]);
      store(out + (size_t)r * N + c, apply_epilogue<EPI>(s));
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Stage one operand element into shared memory as float: an asynchronous
// copy for float32 (nothing waits for it until the chunk's barrier), a load
// and a conversion for bfloat16 and float16; zero outside the operand.
__device__ __forceinline__ void stage(float* dst, const float* src, bool in_range) {
  if (in_range) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  } else {
    *dst = 0.0f;
  }
}
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, bool in_range) {
  *dst = in_range ? to_float(*src) : 0.0f;
}

// TN floats of a w tile row, read from shared memory in one instruction.
template <int TN>
struct alignas(4 * TN) Row {
  float f[TN];
};

constexpr int kSmallMaxWarps = 8;
constexpr int kSmallMaxSmem = 48 * 1024;  // static limit: no attribute call per launch

// Floats a small-route block keeps in shared memory: the x tile (BM rows of
// `stride`, the odd row pitch, so the warp's row reads hit distinct banks),
// the w tile (k_chunk rows of BN), and later, in the same space, the warps'
// partial sums.
__host__ __device__ __forceinline__ int small_stride(int k_chunk) { return k_chunk | 1; }
__host__ __device__ __forceinline__ long long small_floats(int bm, int bn, int k_split,
                                                          int k_chunk) {
  const long long tiles = 1LL * bm * small_stride(k_chunk) + 1LL * k_chunk * bn;
  const long long partials = 1LL * k_split * bm * bn;
  return tiles > partials ? tiles : partials;
}

// One block per BM x BN output tile, k_split warps.  Each K chunk of at most
// k_chunk columns: every thread stages its share of both tiles, one barrier,
// then warp w sums columns [w ks, (w + 1) ks) of the chunk (ks =
// ceil(chunk / k_split)); lane (ty, tx) of a warp owns rows ty TM .. and
// columns tx TN .. of the tile.  Then partial sums, in warp order.
template <typename T, int EPI, int BM, int BN>
__global__ void __launch_bounds__(32 * kSmallMaxWarps)
    fused_dense_small_kernel(const T* __restrict__ x, const T* __restrict__ w,
                             const T* __restrict__ b, T* __restrict__ out, int M, int N, int K,
                             int k_chunk) {
  constexpr int TM = BM / 8;  // a warp's lanes: 8 rows x 4 columns of patches
  constexpr int TN = BN / 4;
  static_assert(TM * 8 == BM && TN * 4 == BN, "tile must split over 8 x 4 lanes");
  extern __shared__ __align__(16) float smem[];
  const int threads = blockDim.x;
  const int k_split = threads / 32;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ty = lane / 4;
  const int tx = lane % 4;
  int row0, col0;
  tile_origin(BM, BN, N, &row0, &col0);
  const int stride = small_stride(k_chunk);
  float* xs = smem;                  // [BM][stride]
  float* ws = smem + BM * stride;    // [k_chunk][BN], 16-byte aligned: 8 | BM

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int c0 = 0; c0 < K; c0 += k_chunk) {
    const int kc = min(k_chunk, K - c0);
    if (c0 > 0) __syncthreads();  // every warp has read the previous chunk
    // Neighbouring threads copy neighbouring addresses: along K for x,
    // along N for w.
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const bool row_in = row0 + r < M;
      const T* src = x + (static_cast<size_t>(row0) + r) * K + c0;
      for (int kk = tid; kk < kc; kk += threads) stage(xs + r * stride + kk, src + kk, row_in);
    }
    for (int e = tid; e < kc * BN; e += threads) {
      const int kk = e / BN;
      const int col = col0 + e % BN;
      stage(ws + e, w + static_cast<size_t>(c0 + kk) * N + col, col < N);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    const int ks = (kc + k_split - 1) / k_split;
    const int k_hi = min(kc, (warp + 1) * ks);
#pragma unroll 4
    for (int kk = warp * ks; kk < k_hi; ++kk) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[(ty * TM + i) * stride + kk];
      const Row<TN> v = *reinterpret_cast<const Row<TN>*>(ws + kk * BN + tx * TN);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], v.f[j], acc[i][j]);
    }
  }

  __syncthreads();  // the tiles' space now takes the partial sums
  float* part = smem + warp * BM * BN;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) part[(ty * TM + i) * BN + tx * TN + j] = acc[i][j];
  __syncthreads();
  for (int o = tid; o < BM * BN; o += threads) {
    const int r = row0 + o / BN;
    const int c = col0 + o % BN;
    if (r >= M || c >= N) continue;
    float s = 0.0f;
    for (int p = 0; p < k_split; ++p) s += smem[p * BM * BN + o];
    if (b != nullptr) s += to_float(b[c]);
    store(out + static_cast<size_t>(r) * N + c, apply_epilogue<EPI>(s));
  }
}

// Output tiles, one block each, or 0 when they pass the grid's limit.
inline unsigned grid_size(int M, int N, int BM, int BN) {
  const long long tiles = ((M + BM - 1LL) / BM) * ((N + BN - 1LL) / BN);
  return tiles > 0x7fffffffLL ? 0u : static_cast<unsigned>(tiles);
}

template <typename T, int EPI, int BM, int BN>
cudaError_t launch_small(const void* x, const void* w, const void* b, void* out, int M, int N,
                         int K, int k_split, int k_chunk, cudaStream_t stream) {
  const unsigned grid = grid_size(M, N, BM, BN);
  if (grid == 0) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(4 * small_floats(BM, BN, k_split, k_chunk));
  fused_dense_small_kernel<T, EPI, BM, BN><<<grid, 32 * k_split, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(out), M, N, K, k_chunk);
  return cudaGetLastError();
}

template <typename T, int EPI, int BM, int BN, int BK>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   int M, int N, int K, cudaStream_t stream) {
  const unsigned grid = grid_size(M, N, BM, BN);
  if (grid == 0) return cudaErrorInvalidValue;
  fused_dense_kernel<T, EPI, BM, BN, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(out), M, N, K);
  return cudaGetLastError();
}

// The tiles `dense_tiling` chose: route 0 small (8 x 8 or 16 x 16, 1-8
// warps sharing K, chunks of k_chunk columns that fit the static limit),
// route 1 large (64 x 64, K steps of 16).
struct Tiling {
  int route, bm, bn, k_split, k_chunk;
};

template <typename T, int EPI>
cudaError_t pick_tile(const Tiling& t, const void* x, const void* w, const void* b, void* out,
                      int M, int N, int K, cudaStream_t stream) {
  if (t.route == 1 && t.bm == 64 && t.bn == 64 && t.k_split == 1 && t.k_chunk == 16)
    return launch<T, EPI, 64, 64, 16>(x, w, b, out, M, N, K, stream);
  if (t.route != 0 || t.k_split < 1 || t.k_split > kSmallMaxWarps || t.k_chunk < 1 ||
      4 * small_floats(t.bm, t.bn, t.k_split, t.k_chunk) > kSmallMaxSmem)
    return cudaErrorInvalidValue;
  if (t.bm == 8 && t.bn == 8)
    return launch_small<T, EPI, 8, 8>(x, w, b, out, M, N, K, t.k_split, t.k_chunk, stream);
  if (t.bm == 16 && t.bn == 16)
    return launch_small<T, EPI, 16, 16>(x, w, b, out, M, N, K, t.k_split, t.k_chunk, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t pick_epilogue(int epilogue, const Tiling& t, const void* x, const void* w,
                          const void* b, void* out, int M, int N, int K,
                          cudaStream_t stream) {
  switch (epilogue) {
    case kNone:
      return pick_tile<T, kNone>(t, x, w, b, out, M, N, K, stream);
    case kRelu:
      return pick_tile<T, kRelu>(t, x, w, b, out, M, N, K, stream);
    case kGelu:
      return pick_tile<T, kGelu>(t, x, w, b, out, M, N, K, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  `b`
// may be null (no bias).  dtype: 0 float32, 1 bfloat16, 2 float16; epilogue: 0 none,
// 1 relu, 2 gelu; route, bm, bn, k_split, k_chunk: the tiling
// `dense_tiling` chose (cudaErrorInvalidValue for one this source does not
// build).  All pointers are device pointers to contiguous row-major arrays;
// the caller allocates `out`.
extern "C" int fused_dense(const void* x, const void* w, const void* b, void* out, int M, int N,
                           int K, int dtype, int epilogue, int route, int bm, int bn, int k_split,
                           int k_chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tiling t{route, bm, bn, k_split, k_chunk};
  switch (dtype) {
    case kFloat32:
      return pick_epilogue<float>(epilogue, t, x, w, b, out, M, N, K, s);
    case kBFloat16:
      return pick_epilogue<__nv_bfloat16>(epilogue, t, x, w, b, out, M, N, K, s);
    case kFloat16:
      return pick_epilogue<__half>(epilogue, t, x, w, b, out, M, N, K, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* fused_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
