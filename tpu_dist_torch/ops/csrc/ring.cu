// Naive ring all-reduce across processes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ring_kernel` of
// tpu_dist/ops/pallas_ring.py (:36), which every rank of an SPMD world
// runs through `ring_all_reduce_pallas`: n - 1 hops of the whole buffer to
// the right neighbour through a double-buffered comm slot, a barrier with
// both neighbours at the top of every step (:54-61), each arriving buffer
// added into the output.  Rank r's output is x_r + x_{r-1} + ... +
// x_{r-n+1} (indices mod n), summed in that order in the buffer's dtype
// (float32, bfloat16, float16 or int32), as `o_ref[:] += comm_buf[recv]`
// does hop by hop.
//
// How it reaches the neighbour.  The TPU kernel issues its own inter-chip
// DMAs and semaphores.  Here every rank owns a workspace made by
// `ring_workspace_alloc` with cudaMalloc and exported with
// cudaIpcGetMemHandle; the ranks exchange the handles and map their left
// and right neighbours' workspaces with cudaIpcOpenMemHandle (which maps
// memory between processes on one card as well as between cards).  A
// workspace is a header of flags and two payload slots.  At step s a rank
// stores its send buffer (x at s = 0, then the slot it received into) into
// slot (s + 1) % 2 of its right neighbour, then signals an arrival flag
// there, waits on its own arrival flag and adds its received slot into
// the output.
//   - Ready flags play the part of the barrier semaphore: before step s a
//     rank tells its left neighbour that the slot the left neighbour will
//     write is free (it was last read at step s - 1), and waits until its
//     right neighbour has said the same.  This is the backpressure the TPU
//     kernel's barrier gives: no slot is overwritten while it is still
//     being sent from.  Arrival flags play the part of the DMA semaphores.
//   - Flags are system-scope release stores and acquire loads; their
//     values count steps across calls (the caller passes each call's first
//     step), so back-to-back calls cannot alias and a flag is only ever
//     raised.
//   - Each thread block owns one contiguous chunk of the payload and its
//     own flags: block b of a rank synchronises only with block b of its
//     neighbours, and no grid-wide barrier is needed.
//   - Every wait is bounded by %globaltimer: past the caller's timeout the
//     block writes an error code into a word of host-mapped memory and
//     exits, so a stuck neighbour makes the call fail, never hang.
//
// What bounds it.  Each step a rank reads one payload (its send buffer)
// and writes it into the neighbour, then reads its received slot and the
// output and writes the output: about 5 payloads of device-memory traffic
// per rank per step, no arithmetic to speak of, so bytes bound it.  The
// design moves each hop once, 16 bytes per thread per access, with no
// staging copy and nothing on the host between hops.  Ranks that share one
// card take turns on it (time-slicing, without MPS), so there a hop can
// cost a time slice; across cards the stores go over NVLink.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxBlocks = 128;   // flags per workspace
constexpr int kThreads = 512;
constexpr long long kMinBlockBytes = 64 << 10;  // payload bytes per block, at least
constexpr long long kHeaderBytes = 4096;        // ready[128], arrived[128]
constexpr long long kSlotAlign = 256;

enum DType { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2, kInt32 = 3 };
enum Error { kOk = 0, kReadyTimeout = 1, kArrivalTimeout = 2 };

struct Flags {
  unsigned long long ready[kMaxBlocks];    // raised by the right neighbour
  unsigned long long arrived[kMaxBlocks];  // raised by the left neighbour
};
static_assert(sizeof(Flags) <= kHeaderBytes, "flags exceed the header");

__device__ __forceinline__ Flags* flags(char* ws) { return reinterpret_cast<Flags*>(ws); }

template <typename T>
__device__ __forceinline__ T* slot(char* ws, long long slot_bytes, int which) {
  return reinterpret_cast<T*>(ws + kHeaderBytes + which * slot_bytes);
}

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

// Thread 0 waits until *flag >= target; false (and the error word set) if
// the timeout passes first.
__device__ bool wait_at_least(const unsigned long long* flag, unsigned long long target,
                              long long timeout_ns, int* error, int code) {
  if (load_acquire(flag) >= target) return true;
  const unsigned long long start = global_timer();
  while (load_acquire(flag) < target) {
    if (static_cast<long long>(global_timer() - start) > timeout_ns) {
      *reinterpret_cast<volatile int*>(error) = code;
      __threadfence_system();
      return false;
    }
    __nanosleep(100);
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

template <typename T>
using Bits = std::conditional_t<sizeof(T) == 2, unsigned short, unsigned int>;

// A load that skips L1: slots are written by another process.
template <typename T>
__device__ __forceinline__ T load_cg(const T* p) {
  Bits<T> b = __ldcg(reinterpret_cast<const Bits<T>*>(p));
  return *reinterpret_cast<T*>(&b);
}

// dst[lo, hi) = src[lo, hi); lo is a multiple of 16 bytes' worth of T.
template <typename T>
__device__ void copy_range(T* dst, const T* src, long long lo, long long hi, bool src_is_slot) {
  constexpr int V = 16 / sizeof(T);
  const long long nvec = (hi - lo) / V;
  const uint4* s4 = reinterpret_cast<const uint4*>(src + lo);
  uint4* d4 = reinterpret_cast<uint4*>(dst + lo);
  for (long long i = threadIdx.x; i < nvec; i += kThreads) {
    __stcg(d4 + i, src_is_slot ? __ldcg(s4 + i) : s4[i]);
  }
  for (long long i = lo + nvec * V + threadIdx.x; i < hi; i += kThreads) {
    const Bits<T> b = src_is_slot ? __ldcg(reinterpret_cast<const Bits<T>*>(src + i))
                                  : *reinterpret_cast<const Bits<T>*>(src + i);
    __stcg(reinterpret_cast<Bits<T>*>(dst + i), b);
  }
}

// out[lo, hi) = a[lo, hi) + recv[lo, hi), elementwise in T.
template <typename T>
__device__ void add_range(T* out, const T* a, const T* recv, long long lo, long long hi) {
  constexpr int V = 16 / sizeof(T);
  const long long nvec = (hi - lo) / V;
  const uint4* a4 = reinterpret_cast<const uint4*>(a + lo);
  const uint4* r4 = reinterpret_cast<const uint4*>(recv + lo);
  uint4* o4 = reinterpret_cast<uint4*>(out + lo);
  for (long long i = threadIdx.x; i < nvec; i += kThreads) {
    uint4 va = a4[i];
    uint4 vr = __ldcg(r4 + i);
    const T* ea = reinterpret_cast<const T*>(&va);
    const T* er = reinterpret_cast<const T*>(&vr);
    uint4 vo;
    T* eo = reinterpret_cast<T*>(&vo);
#pragma unroll
    for (int j = 0; j < V; ++j) eo[j] = add(ea[j], er[j]);
    o4[i] = vo;
  }
  for (long long i = lo + nvec * V + threadIdx.x; i < hi; i += kThreads) {
    out[i] = add(a[i], load_cg(recv + i));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ring_kernel(const T* __restrict__ x, T* __restrict__ out, char* my_ws, char* right_ws,
                char* left_ws, long long numel, long long chunk, int n,
                unsigned long long step0, long long slot_bytes, long long timeout_ns,
                int* error) {
  const long long lo = blockIdx.x * chunk;
  const long long hi = lo + chunk < numel ? lo + chunk : numel;
  const int b = blockIdx.x;
  if (n == 1) {
    copy_range(out, x, lo, hi, false);
    return;
  }
  __shared__ int give_up;
  for (int s = 0; s < n - 1; ++s) {
    const unsigned long long g = step0 + s + 1;  // this step, counted from 1
    const T* send = s == 0 ? x : slot<T>(my_ws, slot_bytes, s % 2);
    const T* recv = slot<T>(my_ws, slot_bytes, (s + 1) % 2);
    T* right_recv = slot<T>(right_ws, slot_bytes, (s + 1) % 2);

    // Barrier: tell the left neighbour that the slot it writes this step
    // is free (read for the last time at step s - 1), and wait until the
    // right neighbour has said the same of the slot written into it.
    if (threadIdx.x == 0) {
      store_release(&flags(left_ws)->ready[b], g);
      give_up = !wait_at_least(&flags(my_ws)->ready[b], g, timeout_ns, error, kReadyTimeout);
    }
    __syncthreads();
    if (give_up) return;

    copy_range(right_recv, send, lo, hi, s > 0);
    __syncthreads();  // every store of the hop is issued before the flag
    if (threadIdx.x == 0) {
      __threadfence_system();
      store_release(&flags(right_ws)->arrived[b], g);
      give_up = !wait_at_least(&flags(my_ws)->arrived[b], g, timeout_ns, error,
                             kArrivalTimeout);
    }
    __syncthreads();
    if (give_up) return;

    add_range(out, s == 0 ? x : out, recv, lo, hi);
    __syncthreads();  // the received slot is read before the next barrier
  }
}

// Blocks and the chunk (elements, a multiple of 16 bytes) of one call; a
// function of numel and the element size only, so every rank cuts alike.
void split(long long numel, int item, int* blocks, long long* chunk) {
  const long long v = 16 / item;
  long long nb = (numel * item + kMinBlockBytes - 1) / kMinBlockBytes;
  nb = nb < 1 ? 1 : (nb > kMaxBlocks ? kMaxBlocks : nb);
  long long c = (numel + nb - 1) / nb;
  c = (c + v - 1) / v * v;
  *chunk = c;
  *blocks = static_cast<int>((numel + c - 1) / c);
}

template <typename T>
cudaError_t launch(const void* x, void* out, void* my_ws, void* right_ws, void* left_ws,
                   long long numel, int n, unsigned long long step0, long long slot_bytes,
                   long long timeout_ns, int* error, cudaStream_t stream) {
  int blocks;
  long long chunk;
  split(numel, sizeof(T), &blocks, &chunk);
  ring_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<char*>(my_ws),
      static_cast<char*>(right_ws), static_cast<char*>(left_ws), numel, chunk, n, step0,
      slot_bytes, timeout_ns, error);
  return cudaGetLastError();
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

}  // namespace

// Size of the handle `ring_workspace_alloc` writes (cudaIpcMemHandle_t).
extern "C" int ring_handle_bytes() { return sizeof(cudaIpcMemHandle_t); }

// A workspace for payloads of up to `slot_bytes` (a multiple of 256) on the
// current device, zeroed, and its IPC handle.
extern "C" int ring_workspace_alloc(long long slot_bytes, void** ptr, void* handle) {
  if (slot_bytes <= 0 || slot_bytes % kSlotAlign) return cudaErrorInvalidValue;
  cudaError_t err = cudaMalloc(ptr, kHeaderBytes + 2 * slot_bytes);
  if (err != cudaSuccess) return err;
  err = cudaMemset(*ptr, 0, kHeaderBytes + 2 * slot_bytes);
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

// One call: out = the ring sum of every rank's x.  x and out are
// contiguous, 16-byte aligned device arrays of `numel` elements of `dtype`
// (0 float32, 1 bfloat16, 2 float16, 3 int32); my_ws is this rank's
// workspace, right_ws and left_ws the neighbours' (unused at n = 1); the
// payload fits in `slot_bytes`.  `step0` is the number of steps every
// earlier call on these workspaces made.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int ring_all_reduce(const void* x, void* out, void* my_ws, void* right_ws,
                               void* left_ws, long long numel, int dtype, int n,
                               unsigned long long step0, long long slot_bytes,
                               long long timeout_ns, int* error, void* stream) {
  const int item = item_size(dtype);
  if (item == 0 || numel <= 0 || n < 1) return cudaErrorInvalidValue;
  if (n > 1 && (numel * item > slot_bytes || !my_ws || !right_ws || !left_ws)) {
    return cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16) {
    return cudaErrorMisalignedAddress;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(x, out, my_ws, right_ws, left_ws, numel, n, step0, slot_bytes,
                           timeout_ns, error, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(x, out, my_ws, right_ws, left_ws, numel, n, step0,
                                   slot_bytes, timeout_ns, error, s);
    case kFloat16:
      return launch<__half>(x, out, my_ws, right_ws, left_ws, numel, n, step0, slot_bytes,
                            timeout_ns, error, s);
    default:
      return launch<int>(x, out, my_ws, right_ws, left_ws, numel, n, step0, slot_bytes,
                         timeout_ns, error, s);
  }
}

extern "C" const char* ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
