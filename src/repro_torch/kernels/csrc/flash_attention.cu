// Flash attention forward (causal, sliding window, tanh softcap, GQA) for
// Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body _flash_kernel). Same function: per (batch, head),
// softmax(softcap(q k^T / sqrt(D)) under the mask) v, with the mask
// 0 <= qpos - kpos (causal) and qpos - kpos < window (window > 0), the
// KV head of query head h being h / (H / KV), f32 accumulation, output in
// the input type, and the row sum divided as max(l, 1e-30).
//
// Layout: q [B, S, H, D], k/v [B, S, KV, D] read through their strides
// (last dim contiguous), so prefill hands over its projections with no
// transpose; out is a contiguous [B, S, H, D].
//
// Bound: at the serve run's prefill shapes (S <= 512, D = 128) the work
// is small and the tensor-core bound is far below this kernel's time; what
// bounds this first version is the FMA rate of the plain f32 pipes it
// uses. The design keeps every intermediate on chip, which is what the
// TPU kernel kept in VMEM: one block per (q tile of 32 rows, head, batch);
// K/V tiles of 64 keys stream through shared memory as f32; the scores
// tile, the running max m, the running sum l and the rescale factor stay
// in shared memory and the output accumulator in registers, so nothing
// of size S x S ever reaches device memory. Tiles wholly outside the
// causal / window band are skipped by the loop bounds; a ragged last tile
// (S not a multiple of 32 or 64) is masked. Masked scores become -inf and
// contribute exactly 0. Tensor cores (mma.sync / wgmma) and TMA are the
// obvious next step and are left for a later change.
//
// C interface (loaded with ctypes by repro_torch/kernels/flash_attention.py):
// pointers and the stream as void*, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;   // query rows per block
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int NT = 128;  // threads per block (4 warps)
constexpr int NW = NT / 32;

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ);
}

// grid = (ceil(S / BQ), H, B), block = NT threads.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int q_per_kv, Strides qs, Strides ks, Strides vs, int causal,
                 int window, float scale, float softcap) {
  constexpr int DP = D + 1;             // padded rows: conflict-free columns
  constexpr int PP = BK + 1;
  constexpr int TX = D < 32 ? D : 32;   // output tile: threads along D
  constexpr int TY = NT / TX;           //              threads along rows
  constexpr int RPT = BQ / TY;          // rows per thread
  constexpr int CPT = D / TX;           // columns per thread
  constexpr int RPW = BQ / NW;          // softmax rows per warp
  static_assert(BQ % TY == 0 && D % TX == 0, "tile shape");
  static_assert(BK == 64, "the softmax pass covers 64 keys as 2 per lane");

  extern __shared__ float smem[];
  float* Qs = smem;                     // [BQ][DP]
  float* Ks = Qs + BQ * DP;             // [BK][DP]
  float* Vs = Ks + BK * DP;             // [BK][D]
  float* Ps = Vs + BK * D;              // [BQ][PP] scores, then probs
  float* row_m = Ps + BQ * PP;          // running max
  float* row_l = row_m + BQ;            // running sum
  float* row_a = row_l + BQ;            // this tile's rescale factor

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (h / q_per_kv) * ks.h;
  const T* vb = v + b * vs.b + (h / q_per_kv) * vs.h;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, pos = q0 + r;
    Qs[r * DP + c] = pos < S ? to_f(qb[pos * qs.s + c]) : 0.f;
  }
  if (tid < BQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  // keys this q tile can see: the causal edge on the right, the window on
  // the left (rounded down to a tile boundary)
  const int q_end = min(q0 + BQ, S);
  const int k_end = causal ? q_end : S;
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / BK) * BK : 0;

  const int ty1 = tid / 16, tx1 = tid % 16;   // scores: 8 x 16 threads
  const int ty3 = tid / TX, tx3 = tid % TX;   // output: TY x TX threads
  const int warp = tid / 32, lane = tid % 32;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the last tile's readers are done with Ks/Vs/Ps
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D, pos = k0 + r;
      const bool in = pos < S;
      Ks[r * DP + c] = in ? to_f(kb[pos * ks.s + c]) : 0.f;
      Vs[r * D + c] = in ? to_f(vb[pos * vs.s + c]) : 0.f;
    }
    __syncthreads();

    // scores for rows ty1 + 8i, keys tx1 + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty1 + 8 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx1 + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty1 + 8 * i, c = tx1 + 16 * j;
        const int kpos = k0 + c, diff = q0 + r - kpos;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = kpos < S;
        if (causal) ok = ok && diff >= 0;
        if (window > 0) ok = ok && diff < window;
        Ps[r * PP + c] = ok ? x : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: each warp owns RPW rows, each lane 2 of the 64 keys
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      float* prow = Ps + r * PP;
      const float x0 = prow[lane], x1 = prow[lane + 32];
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      float p0 = 0.f, p1 = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {         // else: nothing unmasked yet
        alpha = expf(m_old - m_new);
        p0 = expf(x0 - m_new);
        p1 = expf(x1 - m_new);
      }
      prow[lane] = p0;
      prow[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
        row_a[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V for rows ty3 + TY i, columns tx3 + TX j
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float a = row_a[ty3 + TY * i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) vv[j] = Vs[kk * D + tx3 + TX * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = Ps[(ty3 + TY * i) * PP + kk];
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty3 + TY * i, pos = q0 + r;
    if (pos >= S) continue;
    const float l = fmaxf(row_l[r], 1e-30f);
    T* orow = o + (((long long)b * S + pos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < CPT; ++j) orow[tx3 + TX * j] = from_f<T>(acc[i][j] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, Strides qs, Strides ks, Strides vs, int causal,
           int window, float scale, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, H / KV, qs, ks, vs,
      causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int S, int H, int KV, Strides qs, Strides ks, Strides vs,
               int causal, int window, float scale, float softcap,
               cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, S, H, KV, qs, ks, vs, causal,
                           window, scale, softcap, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, H, KV, qs, ks, vs, causal,
                           window, scale, softcap, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, H, KV, qs, ks, vs, causal,
                           window, scale, softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, KV, qs, ks, vs, causal,
                            window, scale, softcap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements.
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* o, int B, int S, int H, int KV,
                        int D, long long qsb, long long qss, long long qsh,
                        long long ksb, long long kss, long long ksh,
                        long long vsb, long long vss, long long vsh,
                        int causal, int window, float scale, float softcap,
                        void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, B, S, H, KV, qs, ks, vs, causal,
                             window, scale, softcap, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, S, H, KV, qs, ks, vs,
                                     causal, window, scale, softcap, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
