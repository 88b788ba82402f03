// Masked backup-worker gradient reduce for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/backup_reduce.py:
// backup_reduce (body _reduce_kernel): given W stacked worker gradients
// g [W, P] (f32, rows ld floats apart) and the [W] selection mask, write
//
//     out[j] = (sum_{w=0..W-1} mask[w] * g[w, j]) * inv_n
//
// the paper's Alg. 4 line 7, the mean of the gradients of the N fastest
// of N+b workers. The sum runs over w in order, in f32, with __fmul_rn /
// __fadd_rn so nvcc does not contract it into FMAs: that is the plain
// version's arithmetic (backup_reduce_plain), so the two agree bit for
// bit.
//
// Bound: bytes. Every gradient lane is read once (4*W*P bytes) and every
// output lane written once (4*P); there are 2 flops per input lane. The
// design only tries to move bytes at the memory rate:
//   * one pass, a grid-stride loop over the columns with a grid of a few
//     blocks per SM, each thread owning one column (or four);
//   * 16-byte (float4) loads and stores when P and the row stride are
//     multiples of 4 and both bases are 16-byte aligned, neighbouring
//     threads on neighbouring addresses; a scalar path otherwise;
//   * the mask in shared memory, loaded once per block;
//   * the W loads of a column unrolled, so they are in flight together;
//   * no padding: the Pallas kernel zero-pads P up to its block (a second
//     copy of the stack); here the grid-stride loop simply stops at P.
//
// C interface (loaded with ctypes by repro_torch/kernels/backup_reduce.py):
// pointers and the stream as void*, every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ void load_mask(const float* __restrict__ mask,
                                          float* m, int w_count) {
  for (int w = threadIdx.x; w < w_count; w += blockDim.x) m[w] = mask[w];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
reduce_scalar_kernel(const float* __restrict__ g,
                     const float* __restrict__ mask, float* __restrict__ out,
                     int w_count, long long p, long long ld, float inv_n) {
  extern __shared__ float m[];
  load_mask(mask, m, w_count);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < p;
       j += stride) {
    const float* col = g + j;
    float acc = 0.0f;
#pragma unroll 8
    for (int w = 0; w < w_count; ++w)
      acc = __fadd_rn(acc, __fmul_rn(m[w], __ldg(col + (long long)w * ld)));
    out[j] = __fmul_rn(acc, inv_n);
  }
}

__global__ void __launch_bounds__(kThreads)
reduce_vec4_kernel(const float4* __restrict__ g,
                   const float* __restrict__ mask, float4* __restrict__ out,
                   int w_count, long long p4, long long ld4, float inv_n) {
  extern __shared__ float m[];
  load_mask(mask, m, w_count);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < p4;
       j += stride) {
    const float4* col = g + j;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
    for (int w = 0; w < w_count; ++w) {
      const float4 v = __ldg(col + (long long)w * ld4);
      const float mw = m[w];
      acc.x = __fadd_rn(acc.x, __fmul_rn(mw, v.x));
      acc.y = __fadd_rn(acc.y, __fmul_rn(mw, v.y));
      acc.z = __fadd_rn(acc.z, __fmul_rn(mw, v.z));
      acc.w = __fadd_rn(acc.w, __fmul_rn(mw, v.w));
    }
    acc.x = __fmul_rn(acc.x, inv_n);
    acc.y = __fmul_rn(acc.y, inv_n);
    acc.z = __fmul_rn(acc.z, inv_n);
    acc.w = __fmul_rn(acc.w, inv_n);
    out[j] = acc;
  }
}

bool aligned16(const void* a, const void* b) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) %
             16 == 0;
}

long long grid_for(long long n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : blocks;
}

}  // namespace

extern "C" {

// g: [w_count, p] f32 with row stride ld (floats); mask: [w_count] f32;
// out: [p] f32. Takes the 16-byte path when p % 4 == 0, ld % 4 == 0 and
// g, out are 16-byte aligned, the scalar path otherwise.
int backup_reduce_f32(const void* g, const void* mask, void* out, int w_count,
                      long long p, long long ld, float inv_n, void* stream) {
  const size_t smem = (size_t)w_count * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p % 4 == 0 && ld % 4 == 0 && aligned16(g, out)) {
    reduce_vec4_kernel<<<grid_for(p / 4), kThreads, smem, s>>>(
        static_cast<const float4*>(g), static_cast<const float*>(mask),
        static_cast<float4*>(out), w_count, p / 4, ld / 4, inv_n);
  } else {
    reduce_scalar_kernel<<<grid_for(p), kThreads, smem, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(mask),
        static_cast<float*>(out), w_count, p, ld, inv_n);
  }
  return (int)cudaGetLastError();
}

const char* backup_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
