// Paged-KV page gather (+ fused int8 dequant) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/page_gather.py:
// gather_pages_pallas (bodies _gather_kernel, _gather_dequant_kernel).
// For every (slot b, logical page p) it copies physical page table[b, p]
// of one layer's pool [P, ps, kv, hd] into out[b, p*ps:(p+1)*ps]; with
// scales [P, ps, kv] (f16) the int8 payload is dequantized on the way,
// f32(q) * f32(scale) rounded once to the output type, which is the plain
// version's arithmetic bit for bit.
//
// Bound: bytes. A page is read once and written once, no arithmetic to
// speak of. The design therefore only tries to move bytes at the memory
// rate: one block per (slot, page) so the whole grid is in flight at once
// (B*maxp blocks, 320 at the serve run's shapes), 16-byte vector loads
// and stores with neighbouring threads on neighbouring addresses, and
// each block reads its own page id from the table in device memory
// (there is no scalar prefetch on Hopper). The larger win, fusing the
// gather into decode attention so the gathered copy is never written,
// is left for a later change.
//
// C interface (loaded with ctypes by repro_torch/kernels/page_gather.py):
// pointers and the stream as void*, every entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int page_id(const int32_t* __restrict__ table,
                                       int maxp, int num_pages) {
  const int pid = table[(long long)blockIdx.y * maxp + blockIdx.x];
  // A bad id is a host bookkeeping bug: fail loudly rather than read
  // another allocation.
  if (pid < 0 || pid >= num_pages) __trap();
  return pid;
}

// Same-type gather: a raw byte copy of one page. grid = (maxp, B).
__global__ void __launch_bounds__(kThreads)
gather_copy_kernel(const uint8_t* __restrict__ pool,
                   const int32_t* __restrict__ table,
                   uint8_t* __restrict__ out, long long page_bytes,
                   int num_pages, int maxp, bool vec) {
  const int pid = page_id(table, maxp, num_pages);
  const uint8_t* src = pool + (long long)pid * page_bytes;
  uint8_t* dst = out + ((long long)blockIdx.y * maxp + blockIdx.x) * page_bytes;
  if (vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const long long n = page_bytes >> 4;
    for (long long i = threadIdx.x; i < n; i += kThreads) d4[i] = __ldg(s4 + i);
  } else {
    for (long long i = threadIdx.x; i < page_bytes; i += kThreads) dst[i] = src[i];
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// int8 payload * f16 scale of its (pos, head) row -> T. grid = (maxp, B).
// page_rows = ps * kv rows of head_dim values each.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_dequant_kernel(const int8_t* __restrict__ pool,
                      const __half* __restrict__ scales,
                      const int32_t* __restrict__ table, T* __restrict__ out,
                      int page_rows, int head_dim, int num_pages, int maxp,
                      bool vec) {
  const int pid = page_id(table, maxp, num_pages);
  const long long page_elems = (long long)page_rows * head_dim;
  const int8_t* src = pool + (long long)pid * page_elems;
  const __half* sc = scales + (long long)pid * page_rows;
  T* dst = out + ((long long)blockIdx.y * maxp + blockIdx.x) * page_elems;
  if (vec) {
    // 16 int8 per step; head_dim % 16 == 0 keeps a step inside one row
    const long long n = page_elems >> 4;
    for (long long i = threadIdx.x; i < n; i += kThreads) {
      const long long e = i << 4;
      const float s = __half2float(sc[e / head_dim]);
      const int4 raw = __ldg(reinterpret_cast<const int4*>(src) + i);
      const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
      alignas(16) T vals[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) vals[j] = from_float<T>((float)q[j] * s);
      const uint4* v4 = reinterpret_cast<const uint4*>(vals);
      uint4* d4 = reinterpret_cast<uint4*>(dst + e);
#pragma unroll
      for (int j = 0; j < (int)(16 * sizeof(T) / 16); ++j) d4[j] = v4[j];
    }
  } else {
    for (long long e = threadIdx.x; e < page_elems; e += kThreads) {
      const float s = __half2float(sc[e / head_dim]);
      dst[e] = from_float<T>((float)src[e] * s);
    }
  }
}

inline bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

template <typename T>
int launch_dequant(const void* pool, const void* scales, const void* table,
                   void* out, int page_rows, int head_dim, int num_pages,
                   int batch, int maxp, void* stream) {
  const bool vec = head_dim % 16 == 0 && aligned16(pool, out);
  gather_dequant_kernel<T><<<dim3(maxp, batch), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(pool), static_cast<const __half*>(scales),
      static_cast<const int32_t*>(table), static_cast<T*>(out), page_rows,
      head_dim, num_pages, maxp, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int page_gather_copy(const void* pool, const void* table, void* out,
                     long long page_bytes, int num_pages, int batch, int maxp,
                     void* stream) {
  const bool vec = page_bytes % 16 == 0 && aligned16(pool, out);
  gather_copy_kernel<<<dim3(maxp, batch), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pool), static_cast<const int32_t*>(table),
      static_cast<uint8_t*>(out), page_bytes, num_pages, maxp, vec);
  return (int)cudaGetLastError();
}

int page_gather_dequant_bf16(const void* pool, const void* scales,
                             const void* table, void* out, int page_rows,
                             int head_dim, int num_pages, int batch, int maxp,
                             void* stream) {
  return launch_dequant<__nv_bfloat16>(pool, scales, table, out, page_rows,
                                       head_dim, num_pages, batch, maxp,
                                       stream);
}

int page_gather_dequant_f32(const void* pool, const void* scales,
                            const void* table, void* out, int page_rows,
                            int head_dim, int num_pages, int batch, int maxp,
                            void* stream) {
  return launch_dequant<float>(pool, scales, table, out, page_rows, head_dim,
                               num_pages, batch, maxp, stream);
}

const char* page_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
