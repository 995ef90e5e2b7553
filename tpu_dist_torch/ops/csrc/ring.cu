// Ring all-reduce across processes, for Hopper (sm_90a): reduce-scatter
// then all-gather, in one launch.
//
// Replaces the Pallas TPU kernel `_ring_kernel` of
// tpu_dist/ops/pallas_ring.py (:36), which every rank of an SPMD world runs
// through `ring_all_reduce_pallas`.  That kernel is the naive ring: n - 1
// hops of the whole buffer to the right neighbour, each arrival added into
// the output.  This one computes the same all-reduce with the
// bandwidth-optimal schedule that the JAX package itself runs everywhere
// but on the TPU (`ring_all_reduce_chunked`, tpu_dist/parallel/ring.py):
//   - The flat input is cut into n chunks of m = ceil(numel / n) elements
//     (chunk c is [c m, (c + 1) m); the last is short or empty, and the
//     padding is never stored).
//   - Reduce-scatter, sends j = 0 .. n - 2: rank r sends chunk (r - j) mod
//     n, its own slice of x at j = 0, else its slice of x plus the partial
//     sum that arrived at the previous send, added in the dtype with one
//     rounding and stored straight into the right neighbour's slot.  Send
//     n - 1 completes chunk (r + 1) mod n, writes it to `out` and forwards
//     it: the first all-gather send.
//   - All-gather, sends j = n .. 2n - 3: the chunk that arrived is copied
//     into `out` and forwarded; the last arrival goes to `out` only.
// Chunk c is summed x_c + x_{c+1} + ... + x_{c+n-1} (ranks mod n), in that
// order on every rank, so every rank gets the same bits; they equal the
// port's `ring_all_reduce_chunked` on the CPU.  The naive ring gave rank r
// the sum begun at x_r, rounded differently on each rank; the partition,
// and with it the order of every sum, is fixed by the chunked ring's.
//
// What bounds it.  Each rank sends 2 (n - 1) / n of the payload over
// NVLink, the least any ring all-reduce sends (the naive ring sent n - 1
// payloads), so bytes over NVLink bound it: 2 (n - 1) / n x bytes / 450
// GB/s on an H100.  Device memory carries about three slices per send (x
// and the arrived slot read, the neighbour's slot written; `out` once per
// chunk), well under HBM's rate.  The design moves each slice once, 16
// bytes a thread, loads batched ahead of their stores, nothing on the host
// between sends, and lets a sender run up to `kSlots` sends ahead of its
// right neighbour: `kSlots` = 3 (two left a free-slot wait on the path on
// four H100s, four were no faster; slices cut into pieces, each with its
// own arrival flag, measured slower there and are not used).
//
// How it reaches the neighbour.  Every rank owns a workspace made by
// `ring_workspace_alloc` with cudaMalloc and exported with
// cudaIpcGetMemHandle; the ranks map their left and right neighbours'
// workspaces with cudaIpcOpenMemHandle (between processes on one card as
// well as between cards).  A workspace is a header of flags and `kSlots`
// payload slots of ceil(numel / n) elements each (plus per-slice padding).
//   - The grid is `blocks` blocks, the same for every call; block b owns
//     the b-th slice of every chunk and a fixed region of every slot, and
//     it synchronises only with block b of its neighbours.  Slice edges
//     fall where the partition puts them, not on 16 bytes: a slice's
//     misaligned head and tail move in scalar lanes, and a slice sits in
//     its slot region at its own offset modulo 16 bytes, so the body moves
//     16 bytes a thread on both sides.
//   - Flags count sends across calls (the caller passes each call's first
//     send), and are only ever raised.  `arrived[b]` in the receiver's
//     header: how many slices the left neighbour has stored.  `freed[b]` in
//     the sender's header: how many slices the right neighbour has
//     consumed; a send waits until the send `kSlots` earlier into the same
//     slot region was consumed.  Flags are system-scope release stores and
//     acquire loads after a __threadfence_system; slots are read with
//     ld.global.cg.
//   - The first send of every call carries a stamp (numel, dtype code,
//     shape hash, first step) into the neighbour's header; a block whose
//     left neighbour's stamp differs from its own writes error 3 and
//     exits, so ranks that pass different shapes or dtypes fail instead of
//     summing garbage.
//   - Every wait is bounded by %globaltimer: past the caller's timeout the
//     block writes an error code into a word of host-mapped memory and
//     exits, so a stuck neighbour makes the call fail, never hang.
//   - A second instantiation, launched only when the caller passes
//     `phase_ns`, adds the nanoseconds each block's thread 0 spent waiting
//     for arrivals, waiting for a free slot, and moving data into it: the
//     trace of where a send's time goes.  The other reads no timer outside
//     a wait.
// Ranks that share one card take turns on it (time-slicing, without MPS),
// so there a send can cost a time slice.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxBlocks = 128;
constexpr int kSlots = 3;  // sends a sender may run ahead of its right neighbour
constexpr int kThreads = 512;
constexpr int kUnroll = 4;  // 16-byte vectors a thread loads before it stores
constexpr long long kHeaderBytes = 64 << 10;

enum DType { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2, kInt32 = 3 };
enum Error { kOk = 0, kFreeTimeout = 1, kArrivalTimeout = 2, kMismatch = 3 };
enum Phase { kWaitArrival = 0, kWaitFree = 1, kMove = 2 };

struct Stamp {
  unsigned long long v[4];  // numel, dtype code, shape hash, the call's first step
};

struct Header {
  unsigned long long arrived[kMaxBlocks];  // raised by the left neighbour
  unsigned long long freed[kMaxBlocks];    // raised by the right neighbour
  Stamp stamp[kSlots][kMaxBlocks];         // written with a call's first send
};
static_assert(sizeof(Header) <= kHeaderBytes, "flags exceed the header");

__device__ __forceinline__ Header* header(char* ws) { return reinterpret_cast<Header*>(ws); }

__device__ __forceinline__ unsigned long long global_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// A mismatch outranks a timeout, which may follow from it on another block.
__device__ void set_error(int* error, int code) {
  volatile int* word = reinterpret_cast<volatile int*>(error);
  if (code == kMismatch || *word == kOk) *word = code;
  __threadfence_system();
}

// Thread 0 waits until *flag >= target; false (and the error word set) if
// the timeout passes first.
__device__ bool wait_at_least(const unsigned long long* flag, unsigned long long target,
                              long long timeout_ns, int* error, int code) {
  if (load_acquire(flag) >= target) return true;
  const unsigned long long start = global_timer();
  while (load_acquire(flag) < target) {
    if (static_cast<long long>(global_timer() - start) > timeout_ns) {
      set_error(error, code);
      return false;
    }
    __nanosleep(64);
  }
  return true;
}

// Elementwise sums as PyTorch computes them on the card: the half types
// through float32 with one round-to-nearest-even, int32 wrapping.
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16(__bfloat162float(a) + __bfloat162float(b));
}
__device__ __forceinline__ __half add(__half a, __half b) {
  return __float2half(__half2float(a) + __half2float(b));
}

// Bits and values, through registers only.
template <typename T>
using Bits = std::conditional_t<sizeof(T) == 2, unsigned short, unsigned int>;

__device__ __forceinline__ float from_bits(unsigned int b, float) { return __uint_as_float(b); }
__device__ __forceinline__ int from_bits(unsigned int b, int) { return static_cast<int>(b); }
__device__ __forceinline__ __nv_bfloat16 from_bits(unsigned short b, __nv_bfloat16) {
  return __ushort_as_bfloat16(b);
}
__device__ __forceinline__ __half from_bits(unsigned short b, __half) {
  return __ushort_as_half(b);
}
__device__ __forceinline__ unsigned int to_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned int to_bits(int v) { return static_cast<unsigned int>(v); }
__device__ __forceinline__ unsigned short to_bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ unsigned short to_bits(__half v) { return __half_as_ushort(v); }

// The elementwise sum of the T values packed in two 32-bit words.
template <typename T>
__device__ __forceinline__ unsigned int add_word(unsigned int a, unsigned int b) {
  if constexpr (sizeof(T) == 4) {
    return to_bits(add(from_bits(a, T()), from_bits(b, T())));
  } else {
    const unsigned int lo = to_bits(add(from_bits(static_cast<unsigned short>(a), T()),
                                        from_bits(static_cast<unsigned short>(b), T())));
    const unsigned int hi = to_bits(add(from_bits(static_cast<unsigned short>(a >> 16), T()),
                                        from_bits(static_cast<unsigned short>(b >> 16), T())));
    return lo | hi << 16;
  }
}

template <typename T>
__device__ __forceinline__ uint4 add_vec(uint4 a, uint4 b) {
  return make_uint4(add_word<T>(a.x, b.x), add_word<T>(a.y, b.y), add_word<T>(a.z, b.z),
                    add_word<T>(a.w, b.w));
}

// What one send does with a slice.
enum Op {
  kSend = 0,     // right = x
  kReduce = 1,   // right = x + recv
  kFinish = 2,   // out = right = x + recv
  kForward = 3,  // out = right = recv
  kStore = 4,    // out = recv
  kCopy = 5,     // out = x (a world of one)
};

// One slice: global elements [lo, hi) of x and out.  `recv` and `send`
// point at the slice's slot region, whose element 0 stands for global
// element base = lo - lo mod V, so that slot and global offsets agree
// modulo 16 bytes.  Scalar lanes take the head [lo, a) and the tail [e, hi)
// (fewer than V elements each); the body [a, e) moves 16 bytes a thread.
template <typename T, Op op>
__device__ void move_slice(const T* __restrict__ x, T* __restrict__ out, const T* recv, T* send,
                           long long lo, long long hi) {
  constexpr int V = 16 / sizeof(T);
  constexpr bool kReads = op != kSend && op != kCopy;  // reads the slot
  constexpr bool kAdds = op == kReduce || op == kFinish;
  constexpr bool kOut = op != kSend && op != kReduce;
  constexpr bool kSends = op != kStore && op != kCopy;
  const long long base = lo - lo % V;
  long long a = base == lo ? lo : base + V;
  if (a > hi) a = hi;
  long long e = hi - hi % V;
  if (e < a) e = a;
  const long long head = a - lo;
  if (threadIdx.x < head + (hi - e)) {
    const long long i = threadIdx.x < head ? lo + threadIdx.x : e + (threadIdx.x - head);
    T v;
    if constexpr (kReads) {
      v = from_bits(__ldcg(reinterpret_cast<const Bits<T>*>(recv + (i - base))), T());
      if constexpr (kAdds) v = add(x[i], v);
    } else {
      v = x[i];
    }
    if constexpr (kOut) out[i] = v;
    if constexpr (kSends) __stcg(reinterpret_cast<Bits<T>*>(send + (i - base)), to_bits(v));
  }
  const long long nvec = (e - a) / V;
  const uint4* x4 = reinterpret_cast<const uint4*>(x + a);
  uint4* o4 = reinterpret_cast<uint4*>(out + a);
  const uint4* r4 = kReads ? reinterpret_cast<const uint4*>(recv + (a - base)) : nullptr;
  uint4* s4 = kSends ? reinterpret_cast<uint4*>(send + (a - base)) : nullptr;
  for (long long i0 = threadIdx.x; i0 < nvec; i0 += kThreads * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // every load first
      const long long i = i0 + u * kThreads;
      if (i < nvec) {
        if constexpr (kAdds) {
          v[u] = add_vec<T>(x4[i], __ldcg(r4 + i));
        } else if constexpr (kReads) {
          v[u] = __ldcg(r4 + i);
        } else {
          v[u] = x4[i];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * kThreads;
      if (i < nvec) {
        if constexpr (kOut) o4[i] = v[u];
        if constexpr (kSends) __stcg(s4 + i, v[u]);
      }
    }
  }
}

template <typename T>
__device__ void move(Op op, const T* x, T* out, const T* recv, T* send, long long lo,
                     long long hi) {
  switch (op) {
    case kSend: move_slice<T, kSend>(x, out, recv, send, lo, hi); break;
    case kReduce: move_slice<T, kReduce>(x, out, recv, send, lo, hi); break;
    case kFinish: move_slice<T, kFinish>(x, out, recv, send, lo, hi); break;
    case kForward: move_slice<T, kForward>(x, out, recv, send, lo, hi); break;
    case kStore: move_slice<T, kStore>(x, out, recv, send, lo, hi); break;
    default: move_slice<T, kCopy>(x, out, recv, send, lo, hi); break;
  }
}

struct Geometry {
  long long numel, chunk, slice, region;  // elements, elements, elements, bytes
  int n, rank;
  long long slot_bytes;
};

// Global elements [lo, hi) of block b's slice of chunk c.
__device__ __forceinline__ void slice_bounds(const Geometry& g, int c, int b, long long* lo,
                                             long long* hi) {
  long long c_lo = c * g.chunk, c_hi = c_lo + g.chunk;
  if (c_lo > g.numel) c_lo = g.numel;
  if (c_hi > g.numel) c_hi = g.numel;
  *lo = c_lo + b * g.slice;
  *hi = *lo + g.slice;
  if (*lo > c_hi) *lo = c_hi;
  if (*hi > c_hi) *hi = c_hi;
}

// Block b's region of slot `slot` in a workspace.
template <typename T>
__device__ __forceinline__ T* region_of(char* ws, const Geometry& g, int slot, int b) {
  return reinterpret_cast<T*>(ws + kHeaderBytes + slot * g.slot_bytes + b * g.region);
}

// kTraced: add each block's waits and moves to phase_ns.
template <typename T, bool kTraced>
__global__ void __launch_bounds__(kThreads)
    ring_kernel(const T* __restrict__ x, T* __restrict__ out, char* my_ws, char* right_ws,
                char* left_ws, Geometry g, unsigned long long step0, Stamp stamp,
                long long timeout_ns, int* error, long long* phase_ns) {
  const int b = blockIdx.x;
  const int n = g.n, r = g.rank;
  long long lo, hi;
  if (n == 1) {  // one chunk of numel elements
    slice_bounds(g, 0, b, &lo, &hi);
    move<T>(kCopy, x, out, nullptr, nullptr, lo, hi);
    return;
  }
  Header* mine = header(my_ws);
  Header* right = header(right_ws);
  Header* left = header(left_ws);
  __shared__ int give_up;
  long long spent[3] = {0, 0, 0};
  const int sends = 2 * (n - 1);
  for (int j = 0; j <= sends; ++j) {  // j == sends: the last arrival, to out only
    const unsigned long long G = step0 + j;  // this send, counted across calls
    const int c = ((r - j) % n + n) % n;     // the chunk sent (or, last, stored)
    const Op op = j == 0 ? kSend : j < n - 1 ? kReduce : j == n - 1 ? kFinish
                : j < sends ? kForward : kStore;
    if (threadIdx.x == 0) {
      bool ok = true;
      unsigned long long t0 = 0, t1 = 0;
      if constexpr (kTraced) t0 = t1 = global_timer();
      if (j > 0) {  // the slice that arrived at send j - 1
        ok = wait_at_least(&mine->arrived[b], G, timeout_ns, error, kArrivalTimeout);
        if (ok && j == 1) {  // the left neighbour's stamp of this call
          const volatile unsigned long long* got = mine->stamp[step0 % kSlots][b].v;
          for (int i = 0; i < 4; ++i) ok = ok && got[i] == stamp.v[i];
          if (!ok) set_error(error, kMismatch);
        }
        if constexpr (kTraced) t1 = global_timer();
      }
      if (ok && j < sends) {  // the right neighbour's slot region is free
        ok = G < static_cast<unsigned long long>(kSlots) ||
             wait_at_least(&mine->freed[b], G - kSlots + 1, timeout_ns, error, kFreeTimeout);
        if (ok && j == 0) {
          volatile unsigned long long* put = right->stamp[G % kSlots][b].v;
          for (int i = 0; i < 4; ++i) put[i] = stamp.v[i];
        }
      }
      if constexpr (kTraced) {
        const unsigned long long t2 = global_timer();
        spent[kWaitArrival] += t1 - t0;
        spent[kWaitFree] += t2 - t1;
        spent[kMove] -= t2;
      }
      give_up = !ok;
    }
    __syncthreads();
    if (give_up) return;
    slice_bounds(g, c, b, &lo, &hi);
    const T* recv = j > 0 ? region_of<T>(my_ws, g, (G - 1) % kSlots, b) : nullptr;
    T* send = j < sends ? region_of<T>(right_ws, g, G % kSlots, b) : nullptr;
    move<T>(op, x, out, recv, send, lo, hi);
    __syncthreads();  // every store of the slice issued, every read of recv done
    if (threadIdx.x == 0) {
      if (j < sends) {
        __threadfence_system();
        store_release(&right->arrived[b], G + 1);
      }
      if (j > 0) store_release(&left->freed[b], G);
      if constexpr (kTraced) spent[kMove] += global_timer();
    }
  }
  if constexpr (kTraced) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < 3; ++i) phase_ns[3 * b + i] += spent[i];
    }
  }
}

int item_size(int dtype) {
  switch (dtype) {
    case kFloat32:
    case kInt32:
      return 4;
    case kBFloat16:
    case kFloat16:
      return 2;
    default:
      return 0;
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, void* my_ws, void* right_ws, void* left_ws,
                   const Geometry& g, int blocks, unsigned long long step0, const Stamp& stamp,
                   long long timeout_ns, int* error, long long* phase_ns, cudaStream_t stream) {
  auto* kernel = phase_ns ? ring_kernel<T, true> : ring_kernel<T, false>;
  kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<char*>(my_ws),
      static_cast<char*>(right_ws), static_cast<char*>(left_ws), g, step0, stamp, timeout_ns,
      error, phase_ns);
  return cudaGetLastError();
}

}  // namespace

// Size of the handle `ring_workspace_alloc` writes (cudaIpcMemHandle_t).
extern "C" int ring_handle_bytes() { return sizeof(cudaIpcMemHandle_t); }

// A workspace of the header and `kSlots` slots of `slot_bytes` bytes each
// on the current device, zeroed, and its IPC handle.
extern "C" int ring_workspace_alloc(long long slot_bytes, void** ptr, void* handle) {
  if (slot_bytes <= 0 || slot_bytes % 256) return cudaErrorInvalidValue;
  const long long bytes = kHeaderBytes + kSlots * slot_bytes;
  cudaError_t err = cudaMalloc(ptr, bytes);
  if (err != cudaSuccess) return err;
  err = cudaMemset(*ptr, 0, bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess) {
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  }
  if (err != cudaSuccess) cudaFree(*ptr);
  return err;
}

extern "C" int ring_workspace_open(const void* handle, void** ptr) {
  return cudaIpcOpenMemHandle(ptr, *static_cast<const cudaIpcMemHandle_t*>(handle),
                              cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int ring_workspace_close(void* ptr) { return cudaIpcCloseMemHandle(ptr); }

extern "C" int ring_workspace_free(void* ptr) { return cudaFree(ptr); }

// The error word: host memory the kernel writes and the host reads
// without a device sync.  Zeroed.
extern "C" int ring_error_word_alloc(int** host, int** device) {
  cudaError_t err = cudaHostAlloc(reinterpret_cast<void**>(host), sizeof(int),
                                  cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return err;
  **host = 0;
  err = cudaHostGetDevicePointer(reinterpret_cast<void**>(device), *host, 0);
  if (err != cudaSuccess) cudaFreeHost(*host);
  return err;
}

extern "C" int ring_error_word_free(int* host) { return cudaFreeHost(host); }

// One call: out = the all-reduce of every rank's x, as rank `rank` of `n`.
// x and out are contiguous, 16-byte aligned device arrays of `numel`
// elements of `dtype` (0 float32, 1 bfloat16, 2 float16, 3 int32); my_ws is
// this rank's workspace, right_ws and left_ws the neighbours' (unused at n
// = 1).  The grid is `blocks` blocks; a block's region in a slot is
// `region_bytes` (a multiple of 16) and the workspace holds `kSlots` slots
// of `blocks` regions.  `step0` is the number of sends every earlier call
// on these workspaces made; `stamp` (numel, dtype, shape hash, step0) must
// be every rank's own.  `phase_ns` is null, or 3 x blocks int64 that each
// block adds its waits and moves to (the traced instantiation).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ring_all_reduce(const void* x, void* out, void* my_ws, void* right_ws,
                               void* left_ws, long long numel, int dtype, int n, int rank,
                               unsigned long long step0, int blocks, long long region_bytes, const unsigned long long* stamp,
                               long long timeout_ns, int* error, long long* phase_ns,
                               void* stream) {
  const int item = item_size(dtype);
  if (item == 0 || numel <= 0 || n < 1 || rank < 0 || rank >= n || blocks < 1 ||
      blocks > kMaxBlocks) {
    return cudaErrorInvalidValue;
  }
  const long long v = 16 / item;
  Geometry g;
  g.numel = numel;
  g.n = n;
  g.rank = rank;
  g.chunk = n == 1 ? numel : (numel + n - 1) / n;
  g.slice = ((g.chunk + blocks - 1) / blocks + v - 1) / v * v;
  g.region = region_bytes;
  g.slot_bytes = blocks * region_bytes;
  if (n > 1 && ((g.slice + v) * item > region_bytes || region_bytes % 16 || !my_ws ||
                !right_ws || !left_ws)) {
    return cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16) {
    return cudaErrorMisalignedAddress;
  }
  Stamp s;
  for (int i = 0; i < 4; ++i) s.v[i] = stamp[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(x, out, my_ws, right_ws, left_ws, g, blocks, step0, s, timeout_ns,
                           error, phase_ns, st);
    case kBFloat16:
      return launch<__nv_bfloat16>(x, out, my_ws, right_ws, left_ws, g, blocks, step0, s,
                                   timeout_ns, error, phase_ns, st);
    case kFloat16:
      return launch<__half>(x, out, my_ws, right_ws, left_ws, g, blocks, step0, s, timeout_ns,
                            error, phase_ns, st);
    default:
      return launch<int>(x, out, my_ws, right_ws, left_ws, g, blocks, step0, s, timeout_ns,
                         error, phase_ns, st);
  }
}

extern "C" const char* ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
