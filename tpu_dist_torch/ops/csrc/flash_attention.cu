// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ kernels.
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
// bfloat16 or float16, every product and the softmax in float32,
// out/dq/dk/dv in the input type, lse (bh, S) in float32; masked logits are
// -1e30 and masked probabilities exactly 0, as there.  `scale` multiplies q
// before the score product, as `qs = q * scale` does on the TPU; dK and dQ
// are multiplied by `scale` once, after their whole sum, as the plain
// version does.
//
// Not the same blocking.  The TPU grid walks (bh, S/256) programs in order
// on one core, with whole K/V rows resident in VMEM.  Here each block owns
// one TILE-row tile of the output (queries for the forward and dQ, keys for
// dK/dV), stages the other side's TILE-row tiles through shared memory one
// at a time, and keeps its accumulators in registers; blocks run in any order,
// and the two backward kernels each own their output, so nothing is summed
// across blocks: no atomics, and the gradients are the same from run to
// run.  Causal and window tiles that are wholly masked are skipped with the
// TPU kernels' own range formulas at this tile (mirrored in Python as
// `key_tile_range` / `query_tile_range` and tested there).  A ragged last
// tile is masked, so any S works.  The head dim is padded with zeros to the
// template width D (16, 32, 64, 128 or 256); shared-memory rows are D + 1
// floats apart so the column reads of the score products hit 16 different
// banks.  TILE is 64 rows up to D = 128; at D = 256 four 64-row tiles of
// D + 1 floats (dK/dV: K, V, Q, dO) would need 263 KB, past the 227 KB a
// block may hold, so D = 256 takes 32-row tiles (103-140 KB).  Offsets into
// q, k, v and the outputs are 64-bit, so bh * S * d may pass 2^31.
//
// What bounds it on the H100.  At the training shape (bh = 192, S = 1024,
// d = 64, causal, bf16) the forward is 2 products of 2*bh*S^2*d FLOP at the
// causal fraction, about 26 GFLOP on 75 MB: 340 FLOP per byte, above the
// bf16 ridge of 295, so on tensor cores operations would bound it.  These
// first kernels run every product as float32 FMAs on the SIMT cores from
// shared memory (each FMA pair reads one operand from shared memory, which
// caps them near half the 67 TFLOP/s float32 peak); `wgmma` on bf16 tiles
// fed by TMA, with warp specialisation, is the later step that moves them
// toward the tensor-core bound.  The design keeps what already counts
// there: the (S, S) scores never reach device memory, each K/V (or Q/dO)
// tile is read once per block, and the output is written once.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

// A block of 4 * TILE threads, (TILE / 4) x 16: thread (ty, tx) owns the
// tile rows ty*4 + r (r < 4) and the columns tx + 16c of every row.
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

// Key tiles [lo, hi) that query tile i can see (flash_attention.py:80-92).
template <int TILE>
__device__ __forceinline__ void key_tile_range(int i, int S, int causal,
                                               int window, int* lo, int* hi) {
  const int n = num_tiles(S, TILE);
  *hi = causal ? min(n, floor_div((i + 1) * TILE + TILE - 1, TILE)) : n;
  *lo = window > 0 ? max(0, floor_div(i * TILE - window + 1, TILE)) : 0;
}

// Query tiles [lo, hi) that can see key tile j (flash_attention.py:216-225).
template <int TILE>
__device__ __forceinline__ void query_tile_range(int j, int S, int causal,
                                                 int window, int* lo,
                                                 int* hi) {
  const int n = num_tiles(S, TILE);
  *lo = causal ? floor_div(j * TILE, TILE) : 0;
  *hi = window > 0
            ? min(n, floor_div((j + 1) * TILE - 1 + window - 1, TILE) + 1)
            : n;
}

__device__ __forceinline__ bool visible(int qp, int kp, int S, int causal,
                                        int window) {
  if (qp >= S || kp >= S) return false;  // the ragged last tile
  if (causal && kp > qp) return false;
  if (window > 0 && kp <= qp - window) return false;
  return true;
}

// Reductions over the 16 threads (one half-warp) that share a score row.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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
constexpr size_t fwd_smem_floats() {
  return 3 * TILE * (D + 1) + TILE * Tiling<TILE>::kPLD;
}
template <int D, int TILE>
constexpr size_t dkv_smem_floats() {
  return 4 * TILE * (D + 1) + 2 * TILE * Tiling<TILE>::kPLD + 2 * TILE;
}
template <int D, int TILE>
constexpr size_t dq_smem_floats() {
  return 4 * TILE * (D + 1) + TILE * Tiling<TILE>::kPLD;
}

// One block per (query tile, batch-head).  Thread (ty, tx) owns query rows
// ty*4 + r and, of each key tile, the keys tx + 16c; of the output it owns
// the columns tx + 16c.
template <typename T, int D, int TILE>
__global__ void __launch_bounds__(Tiling<TILE>::kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int S, int d, float scale,
                     int causal, int window) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  constexpr int KC = Tiling<TILE>::kCols;
  constexpr int PLD = Tiling<TILE>::kPLD;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* Ps = Vs + TILE * LD;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const index_t bh = blockIdx.x;
  const int i = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const index_t base = bh * S * d;
  const int q0 = i * TILE;

  load_tile<T, D, TILE>(Qs, q + base, q0, S, d, scale);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.0f;
  }

  int lo, hi;
  key_tile_range<TILE>(i, S, causal, window, &lo, &hi);
  for (int j = lo; j < hi; ++j) {
    const int k0 = j * TILE;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<T, D, TILE>(Ks, k + base, k0, S, d, 1.0f);
    load_tile<T, D, TILE>(Vs, v + base, k0, S, d, 1.0f);
    __syncthreads();

    float s[4][KC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < KC; ++c) s[r][c] = 0.0f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float a[4], b[KC];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Qs[(ty * 4 + r) * LD + kk];
#pragma unroll
      for (int c = 0; c < KC; ++c) b[c] = Ks[(tx + 16 * c) * LD + kk];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < KC; ++c) s[r][c] = fmaf(a[r], b[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + ty * 4 + r;
      bool vis[KC];
      float mt = kNegInf;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        vis[c] = visible(qp, k0 + tx + 16 * c, S, causal, window);
        if (!vis[c]) s[r][c] = kNegInf;
        mt = fmaxf(mt, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(mt));
      const float correction = expf(m[r] - m_new);
      float ps = 0.0f;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const float p = vis[c] ? expf(s[r][c] - m_new) : 0.0f;
        Ps[(ty * 4 + r) * PLD + tx + 16 * c] = p;
        ps += p;
      }
      l[r] = l[r] * correction + row_sum(ps);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= correction;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < TILE; ++kk) {
      float p[4], vv[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = Ps[(ty * 4 + r) * PLD + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[kk * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(p[r], vv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty * 4 + r;
    if (qp >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) store(out + base + (index_t)qp * d + col, acc[r][c] / l[r]);
    }
    if (tx == 0) lse[bh * S + qp] = m[r] + logf(l[r]);
  }
}

// One block per (key tile, batch-head).  Thread (ty, tx) owns key rows
// ty*4 + r and, of each query tile, the queries tx + 16c; of dK and dV it
// owns the columns tx + 16c.  The transposed score tile P^T and dS^T go
// through shared memory to the two products over queries.  Q is staged
// unscaled: the score product scales each Q value as it reads it (the
// same float32 product as the forward's staged q * scale), and dK takes
// `scale` once at write-out, after its whole sum, as the plain version.
template <typename T, int D, int TILE>
__global__ void __launch_bounds__(Tiling<TILE>::kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int d, float scale, int causal,
                     int window) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  constexpr int QC = Tiling<TILE>::kCols;
  constexpr int PLD = Tiling<TILE>::kPLD;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + TILE * LD;
  float* Qs = Vs + TILE * LD;
  float* dOs = Qs + TILE * LD;
  float* Pt = dOs + TILE * LD;
  float* dSt = Pt + TILE * PLD;
  float* Ls = dSt + TILE * PLD;
  float* Ds = Ls + TILE;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const index_t bh = blockIdx.x;
  const int j = blockIdx.y;  // longest causal scans (low j) first
  const index_t base = bh * S * d;
  const index_t row_base = bh * S;
  const int k0 = j * TILE;

  load_tile<T, D, TILE>(Ks, k + base, k0, S, d, 1.0f);
  load_tile<T, D, TILE>(Vs, v + base, k0, S, d, 1.0f);

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.0f;

  int lo, hi;
  query_tile_range<TILE>(j, S, causal, window, &lo, &hi);
  for (int qi = lo; qi < hi; ++qi) {
    const int q0 = qi * TILE;
    __syncthreads();
    load_tile<T, D, TILE>(Qs, q + base, q0, S, d, 1.0f);
    load_tile<T, D, TILE>(dOs, dout + base, q0, S, d, 1.0f);
    if (threadIdx.x < TILE) {
      const int qp = q0 + threadIdx.x;
      Ls[threadIdx.x] = qp < S ? lse[row_base + qp] : 0.0f;
      Ds[threadIdx.x] = qp < S ? delta[row_base + qp] : 0.0f;
    }
    __syncthreads();

    float st[4][QC], dpt[4][QC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < QC; ++c) st[r][c] = dpt[r][c] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float kr[4], vr[4], qc[QC], oc[QC];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        kr[r] = Ks[(ty * 4 + r) * LD + kk];
        vr[r] = Vs[(ty * 4 + r) * LD + kk];
      }
#pragma unroll
      for (int c = 0; c < QC; ++c) {
        qc[c] = Qs[(tx + 16 * c) * LD + kk] * scale;
        oc[c] = dOs[(tx + 16 * c) * LD + kk];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < QC; ++c) {
          st[r][c] = fmaf(qc[c], kr[r], st[r][c]);
          dpt[r][c] = fmaf(oc[c], vr[r], dpt[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kp = k0 + ty * 4 + r;
#pragma unroll
      for (int c = 0; c < QC; ++c) {
        const int qrow = tx + 16 * c;
        const bool vis = visible(q0 + qrow, kp, S, causal, window);
        const float p = vis ? expf(st[r][c] - Ls[qrow]) : 0.0f;
        Pt[(ty * 4 + r) * PLD + qrow] = p;
        dSt[(ty * 4 + r) * PLD + qrow] = p * (dpt[r][c] - Ds[qrow]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < TILE; ++qq) {
      float pr[4], sr[4], oc[DC], qc[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pr[r] = Pt[(ty * 4 + r) * PLD + qq];
        sr[r] = dSt[(ty * 4 + r) * PLD + qq];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        oc[c] = dOs[qq * LD + tx + 16 * c];
        qc[c] = Qs[qq * LD + tx + 16 * c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv_acc[r][c] = fmaf(pr[r], oc[c], dv_acc[r][c]);
          dk_acc[r][c] = fmaf(sr[r], qc[c], dk_acc[r][c]);
        }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kp = k0 + ty * 4 + r;
    if (kp >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col >= d) continue;
      store(dk + base + (index_t)kp * d + col, dk_acc[r][c] * scale);
      store(dv + base + (index_t)kp * d + col, dv_acc[r][c]);
    }
  }
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
  key_tile_range<TILE>(i, S, causal, window, &lo, &hi);
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

// Launches `kernel` on a (bh, S / TILE) grid with `floats` of dynamic shared
// memory (above 48 KB a kernel must be allowed it first, or the launch is
// refused).
template <int TILE, typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t floats, int bh, int S,
                   cudaStream_t stream, Args... args) {
  const int bytes = static_cast<int>(floats * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, num_tiles(S, TILE));
  kernel<<<grid, Tiling<TILE>::kThreads, bytes, stream>>>(args...);
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
  cudaStream_t stream;
};

enum Which { kFwd = 0, kDkv = 1, kDq = 2 };

template <typename T, int D, int TILE>
cudaError_t run(int which, const Call& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if (num_tiles(a.S, TILE) > 65535) return cudaErrorInvalidValue;  // grid.y
  switch (which) {
    case kFwd:
      return launch<TILE>(flash_fwd_kernel<T, D, TILE>, fwd_smem_floats<D, TILE>(),
                          a.bh, a.S, a.stream, q, k, v, static_cast<T*>(a.out),
                          a.lse_out, a.S, a.d, a.scale, a.causal, a.window);
    case kDkv:
      return launch<TILE>(flash_dkv_kernel<T, D, TILE>, dkv_smem_floats<D, TILE>(),
                          a.bh, a.S, a.stream, q, k, v, dout, a.lse_in, a.delta,
                          static_cast<T*>(a.out), static_cast<T*>(a.out2), a.S,
                          a.d, a.scale, a.causal, a.window);
    case kDq:
      return launch<TILE>(flash_dq_kernel<T, D, TILE>, dq_smem_floats<D, TILE>(),
                          a.bh, a.S, a.stream, q, k, v, dout, a.lse_in, a.delta,
                          static_cast<T*>(a.out), a.S, a.d, a.scale, a.causal,
                          a.window);
    default:
      return cudaErrorInvalidValue;
  }
}

// The template width D and the tile for head dim d (`tile_rows` in
// ops/flash_attention.py mirrors the tile).
template <typename T>
cudaError_t pick_width(int which, const Call& a) {
  if (a.d <= 16) return run<T, 16, 64>(which, a);
  if (a.d <= 32) return run<T, 32, 64>(which, a);
  if (a.d <= 64) return run<T, 64, 64>(which, a);
  if (a.d <= 128) return run<T, 128, 64>(which, a);
  if (a.d <= 256) return run<T, 256, 32>(which, a);
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
// window <= 0 means no window.  The caller allocates every output.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, float* lse, int bh, int S, int d,
                         float scale, int dtype, int causal, int window,
                         void* stream) {
  Call a{q, k, v, nullptr, nullptr, nullptr, out, nullptr, lse, bh, S, d,
         causal, window, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(kFwd, dtype, a);
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int bh, int S,
                         int d, float scale, int dtype, int causal, int window,
                         void* stream) {
  Call a{q, k, v, dout, lse, delta, dk, dv, nullptr, bh, S, d,
         causal, window, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(kDkv, dtype, a);
}

extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta,
                        void* dq, int bh, int S, int d, float scale, int dtype,
                        int causal, int window, void* stream) {
  Call a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, bh, S, d,
         causal, window, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(kDq, dtype, a);
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
