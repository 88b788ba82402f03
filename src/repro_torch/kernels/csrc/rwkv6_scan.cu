// RWKV-6 wkv recurrence (data-dependent decay), forward and backward, for
// Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py: wkv6_chunked
// (body _wkv_kernel), as the model uses it through its jnp twin
// src/repro/models/rwkv6.py: wkv_chunked, which the reference
// differentiates with XLA's autodiff. The backward here is that gradient,
// written out by hand.
//
// Per (batch b, head h), with r, k, v, w [S, D] and the bonus u [D], the
// sequence is cut into chunks of C = 16 and, from S = 0, each chunk does
//
//     A    = cumsum_t log max(w, 1e-30)        (inclusive, per channel)
//     ri   = r * exp(A - log w)                (decay to the chunk start)
//     kj   = k * exp(-A)
//     out  = tril(ri kj^T, -1) v + (r u k) * v + ri S
//     S   <- diag(exp(A_C)) S + (k * exp(A_C - A))^T v
//
// (A_C is A's last row.) The upstream clamp |log w| <= 4.95 keeps exp(-A)
// finite in f32 over 16 steps. A ragged last chunk is masked: its missing
// rows read r = k = v = 0 and w = 1, the same as wkv_chunked's padding.
//
// Bound. Per chunk and (b, h) the work is the [C, D] x [D, C] scores, the
// [C, C] x [C, D] and [C, D] x [D, D] output products and the [D, C] x
// [C, D] state update: about 4 C^2 D + 4 C D^2 f32 flops; the bytes are
// r/k/v/w read once, the f32 output written once and, for the backward,
// each chunk's incoming state [D, D] written once. At the training shape
// (B 2, S 256, H 32, D 64) both are a few microseconds of the card.
//
// Forward (simple first, as a first port): one block of 256 threads per
// (b, h) walks the chunks in order, with the state [D, D] f32 and the
// chunk's tiles in shared memory (rows padded to D + 1 floats, so column
// walks hit distinct banks). Each step is a block-stride loop over
// independent items (score entries, (t, e) outputs, (d, e) state lanes,
// channels) between barriers, in f32 throughout. B * H blocks under-fill
// the 132 SMs at the training shape (64 blocks). It writes out
// [B, S, H, D] f32, optionally every chunk's incoming state states
// [B, H, n_chunks, D, D] f32 (saved for the backward) and the final state
// [B, H, D, D] f32.
//
// Backward, chunk-parallel in two kernels. The only sequential part of the
// gradient is the carried dS [D, D] (dS <- diag(exp(A_C)) dS + ri^T dO,
// in reverse); everything else in a chunk depends only on the chunk's
// inputs, its incoming state (saved by the forward) and the dS leaving it.
// Pass 1 scans dS alone, its columns split over blocks (B * H * D / 16
// blocks, 256 at the training shape, each a [D, 16] slice in registers),
// and writes the dS leaving every chunk to a scratch [B, H, n_chunks, D, D]
// f32. Pass 2 runs one block per (b, h, chunk) (1,024 at the training
// shape), all independent: from dO, the incoming state and the outgoing dS
// it forms dv, the score gradient, d ri, d kj, d k_dec, the bonus gradient
// and d a, then by the chain rule through the exponentials and the cumsum
// dr, dk and d log w (dw = d log w / w). The [16, D] x [D, D] products,
// the bulk of the work, run on tensor cores in 3xTF32 (each operand split
// into two tf32 halves), which keeps f32 accuracy; plain TF32 would break
// the gradients' 1e-4 tolerances. Both passes form their decays in base 2
// on the special-function unit. du is written per chunk to du_part
// [B, H, n_chunks, D]; the caller sums it in a fixed order (no atomics
// anywhere, so the result is deterministic).
//
// r/k/v are f32 or bf16 ([B, S, H, D], read through their strides, unit
// stride along D); w, u, the output and every gradient are f32.
//
// C interface (loaded with ctypes by repro_torch/kernels/rwkv6_scan.py):
// pointers and the stream as void*, every entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;
constexpr int kThreads = 256;

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ long long at(const Strides& st, int b, int s,
                                        int h) {
  return (long long)b * st.b + (long long)s * st.s + (long long)h * st.h;
}

// Shared-memory layout, in floats. P = D + 1 is the padded row stride.
template <int D>
struct FwdSmem {
  static constexpr int P = D + 1, CP = kChunk * P;
  static constexpr int kR = 0, kK = kR + CP, kV = kK + CP, kA = kV + CP,
                       kRi = kA + CP, kKj = kRi + CP, kKd = kKj + CP,
                       kS = kKd + CP, kSc = kS + D * P,
                       kBonus = kSc + kChunk * kChunk, kDecay = kBonus + kChunk,
                       kU = kDecay + D, kTotal = kU + D;
};

// One chunk's decays from log w (held in A on entry, inclusive cumsum on
// exit): ri, kj, k_dec and a = exp(A_C). One thread per channel.
template <int D>
__device__ __forceinline__ void chunk_decays(const float* r_s,
                                             const float* k_s, float* A_s,
                                             float* ri, float* kj, float* kd,
                                             float* decay) {
  constexpr int P = D + 1;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.0f;
    for (int t = 0; t < kChunk; ++t) {
      const float lw = A_s[t * P + d];
      acc += lw;
      A_s[t * P + d] = acc;
      ri[t * P + d] = r_s[t * P + d] * expf(acc - lw);
      kj[t * P + d] = k_s[t * P + d] * expf(-acc);
    }
    for (int t = 0; t < kChunk; ++t)
      kd[t * P + d] = k_s[t * P + d] * expf(acc - A_s[t * P + d]);
    decay[d] = expf(acc);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, Strides sr, Strides sk,
                Strides sv, Strides sw, float* __restrict__ out,
                float* __restrict__ states, float* __restrict__ final_state,
                int H, int S) {
  using L = FwdSmem<D>;
  constexpr int P = L::P, C = kChunk;
  extern __shared__ float smem[];
  float* r_s = smem + L::kR;
  float* k_s = smem + L::kK;
  float* v_s = smem + L::kV;
  float* A_s = smem + L::kA;
  float* ri = smem + L::kRi;
  float* kj = smem + L::kKj;
  float* kd = smem + L::kKd;
  float* S_s = smem + L::kS;
  float* sc = smem + L::kSc;
  float* bonus = smem + L::kBonus;
  float* decay = smem + L::kDecay;
  float* u_s = smem + L::kU;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nc = (S + C - 1) / C;
  for (int i = tid; i < D * D; i += nt) S_s[(i / D) * P + i % D] = 0.0f;
  for (int d = tid; d < D; d += nt) u_s[d] = u[h * D + d];

  for (int c = 0; c < nc; ++c) {
    const int s0 = c * C;
    // the chunk's rows, masked past S
    for (int i = tid; i < C * D; i += nt) {
      const int t = i / D, d = i % D, s = s0 + t;
      float rv = 0.0f, kv = 0.0f, vv = 0.0f, wv = 1.0f;
      if (s < S) {
        rv = to_f32(r[at(sr, b, s, h) + d]);
        kv = to_f32(k[at(sk, b, s, h) + d]);
        vv = to_f32(v[at(sv, b, s, h) + d]);
        wv = w[at(sw, b, s, h) + d];
      }
      r_s[t * P + d] = rv;
      k_s[t * P + d] = kv;
      v_s[t * P + d] = vv;
      A_s[t * P + d] = logf(fmaxf(wv, 1e-30f));
    }
    __syncthreads();
    chunk_decays<D>(r_s, k_s, A_s, ri, kj, kd, decay);
    __syncthreads();
    // strictly lower-triangular scores, and the diagonal bonus r.u.k
    for (int i = tid; i < C * C; i += nt) {
      const int t = i / C, j = i % C;
      float acc = 0.0f;
      if (j < t)
        for (int d = 0; d < D; ++d) acc += ri[t * P + d] * kj[j * P + d];
      sc[i] = acc;
    }
    for (int t = tid; t < C; t += nt) {
      float acc = 0.0f;
      for (int d = 0; d < D; ++d)
        acc += r_s[t * P + d] * u_s[d] * k_s[t * P + d];
      bonus[t] = acc;
    }
    __syncthreads();
    // out[t, e] = sum_j<t sc[t, j] v[j, e] + bonus[t] v[t, e] + ri[t] S[:, e]
    for (int i = tid; i < C * D; i += nt) {
      const int t = i / D, e = i % D, s = s0 + t;
      float acc = 0.0f;
      for (int j = 0; j < t; ++j) acc += sc[t * C + j] * v_s[j * P + e];
      acc += bonus[t] * v_s[t * P + e];
      float read = 0.0f;
      for (int d = 0; d < D; ++d) read += ri[t * P + d] * S_s[d * P + e];
      if (s < S) out[(((long long)b * S + s) * H + h) * D + e] = acc + read;
    }
    if (states != nullptr) {
      float* dst = states + ((long long)bh * nc + c) * D * D;
      for (int i = tid; i < D * D; i += nt)
        dst[i] = S_s[(i / D) * P + i % D];
    }
    __syncthreads();
    // S <- diag(a) S + k_dec^T v
    for (int i = tid; i < D * D; i += nt) {
      const int d = i / D, e = i % D;
      float acc = 0.0f;
      for (int t = 0; t < C; ++t) acc += kd[t * P + d] * v_s[t * P + e];
      S_s[d * P + e] = decay[d] * S_s[d * P + e] + acc;
    }
    __syncthreads();
  }
  if (final_state != nullptr) {
    float* dst = final_state + (long long)bh * D * D;
    for (int i = tid; i < D * D; i += nt) dst[i] = S_s[(i / D) * P + i % D];
  }
}

// ---------------------------------------------------------------------------
// Backward, in two passes
// ---------------------------------------------------------------------------

constexpr int kSlice = 16;   // dS columns per scan block
constexpr int kRowStep = kThreads / kSlice;   // rows between a thread's dS lanes
constexpr int kChunkThreads = 512;   // pass 2's block

// log2 and 2^x on the special-function unit (relative error ~2^-22). The
// backward forms its decays in base 2: exp(A) = 2^(A / ln 2), so A2, the
// cumsum of log2 w, gives the same factors as the natural-log forward.
__device__ __forceinline__ float fast_log2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously (cp.async.cg)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The cumsum of log w along one chunk, four threads per channel: the
// thread with g = item & 3 owns rows 4g..4g+3 and holds their log w. On
// return a holds the inclusive cumsum of its rows and a_last the chunk's
// total. The four are neighbouring lanes of one warp; called by whole
// warps (4 D is a multiple of 32).
__device__ __forceinline__ void chunk_cumsum4(int g, const float (&lw)[4],
                                              float (&a)[4], float& a_last) {
  float run = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    run += lw[i];
    a[i] = run;
  }
  float incl = run;
  float x = __shfl_up_sync(0xffffffffu, incl, 1, 4);
  if (g >= 1) incl += x;
  x = __shfl_up_sync(0xffffffffu, incl, 2, 4);
  if (g >= 2) incl += x;
  float before = __shfl_up_sync(0xffffffffu, incl, 1, 4);
  if (g == 0) before = 0.0f;
  a_last = __shfl_sync(0xffffffffu, incl, 3, 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] += before;
}

// Pass 1, the dS scan. grid = B * H * (D / kSlice), block = kThreads: each
// block carries kSlice columns of dS [D, D] (columns are independent in
// dS <- diag(a) dS + ri^T dO) back through the chunks, from dfinal (or
// zero), and writes the dS leaving every chunk to ds_all
// [B, H, n_chunks, D, D]. Its D x kSlice slice lives in registers, D / 16
// lanes a thread. Per chunk: the chunk's ri and decay (four threads a
// channel), then the update, which reads ri and dO transposed (a row of 16
// per channel or column) as float4; the next chunk's r, w and dO load into
// registers meanwhile, and the shared tiles are double-buffered, so a
// chunk costs two barriers.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_scan_kernel(const T* __restrict__ r, const float* __restrict__ w,
                     Strides sr, Strides sw, const float* __restrict__ dout,
                     const float* __restrict__ dfinal,
                     float* __restrict__ ds_all, int H, int S) {
  constexpr int P = D + 1, C = kChunk, NS = D / kSlice;
  constexpr int TP = C + 4;   // transposed rows: 16-byte aligned, and the
                              // rows of 8 lanes in distinct bank groups
  constexpr int RPT = C * D / kThreads;         // r / w a thread loads
  constexpr int EPT = D * kSlice / kThreads;    // dS entries it holds
  static_assert(C * kSlice == kThreads, "one dO entry per thread");
  __shared__ float r_s[2][C * P], lw_s[2][C * P];          // [t][d]
  __shared__ __align__(16) float riT[2][D * TP];            // [d][t]
  __shared__ __align__(16) float doT[2][kSlice * TP];       // [e][t]
  __shared__ float decay[2][D];

  const int bh = blockIdx.x / NS, e0 = (blockIdx.x % NS) * kSlice;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, e = tid % kSlice, d0 = tid / kSlice;
  const int nc = (S + C - 1) / C;
  float ds[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i)
    ds[i] = dfinal != nullptr
                ? dfinal[((long long)bh * D + d0 + kRowStep * i) * D + e0 + e]
                : 0.0f;

  float pr[RPT], pw[RPT], pg;
  auto fetch = [&](int c) {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int i = tid + kThreads * j, s = c * C + i / D, d = i % D;
      pr[j] = s < S ? to_f32(r[at(sr, b, s, h) + d]) : 0.0f;
      pw[j] = s < S ? w[at(sw, b, s, h) + d] : 1.0f;
    }
    const int s = c * C + tid / kSlice;
    pg = s < S ? dout[(((long long)b * S + s) * H + h) * D + e0 + e] : 0.0f;
  };
  fetch(nc - 1);
  for (int c = nc - 1; c >= 0; --c) {
    const int buf = c & 1;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int i = tid + kThreads * j, o = (i / D) * P + i % D;
      r_s[buf][o] = pr[j];
      lw_s[buf][o] = fast_log2(fmaxf(pw[j], 1e-30f));
    }
    doT[buf][e * TP + tid / kSlice] = pg;
    __syncthreads();
    if (c > 0) fetch(c - 1);
    if (tid < 4 * D) {
      const int d = tid >> 2, g = tid & 3;
      float lw[4], a[4], a_last;
#pragma unroll
      for (int i = 0; i < 4; ++i) lw[i] = lw_s[buf][(4 * g + i) * P + d];
      chunk_cumsum4(g, lw, a, a_last);
      float4 ri;
      ri.x = r_s[buf][(4 * g) * P + d] * fast_exp2(a[0] - lw[0]);
      ri.y = r_s[buf][(4 * g + 1) * P + d] * fast_exp2(a[1] - lw[1]);
      ri.z = r_s[buf][(4 * g + 2) * P + d] * fast_exp2(a[2] - lw[2]);
      ri.w = r_s[buf][(4 * g + 3) * P + d] * fast_exp2(a[3] - lw[3]);
      *reinterpret_cast<float4*>(&riT[buf][d * TP + 4 * g]) = ri;
      if (g == 0) decay[buf][d] = fast_exp2(a_last);
    }
    __syncthreads();
    float4 gv[C / 4];
#pragma unroll
    for (int q = 0; q < C / 4; ++q)
      gv[q] = *reinterpret_cast<const float4*>(&doT[buf][e * TP + 4 * q]);
    float* dst = ds_all + ((long long)bh * nc + c) * D * D + e0 + e;
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int d = d0 + kRowStep * i;
      dst[d * D] = ds[i];
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        const float4 rv = *reinterpret_cast<const float4*>(
            &riT[buf][d * TP + 4 * q]);
        acc = fmaf(rv.x, gv[q].x, acc);
        acc = fmaf(rv.y, gv[q].y, acc);
        acc = fmaf(rv.z, gv[q].z, acc);
        acc = fmaf(rv.w, gv[q].w, acc);
      }
      ds[i] = decay[buf][d] * ds[i] + acc;
    }
  }
}

// Shared-memory layout of pass 2, in floats. Rows are padded to D + 4, so
// every row starts 16-byte aligned (float4 walks along a row) and the rows
// read by 8 neighbouring lanes fall in distinct bank groups.
template <int D>
struct ChunkSmem {
  static constexpr int P = D + 4, CP = kChunk * P;
  // e1 = exp(A - log w), e2 = exp(-A), e3 = exp(A_C - A): the decays, kept
  // for the chain rule. d kj lives in S's place once S is read.
  static constexpr int kR = 0, kK = kR + CP, kV = kK + CP, kW = kV + CP,
                       kLw = kW + CP, kDo = kLw + CP, kRi = kDo + CP,
                       kKj = kRi + CP, kKd = kKj + CP, kE1 = kKd + CP,
                       kE2 = kE1 + CP, kE3 = kE2 + CP, kDri = kE3 + CP,
                       kDkd = kDri + CP, kDv = kDkd + CP, kS = kDv + CP,
                       kDkj = kS, kDs = kS + D * P, kSc = kDs + D * P,
                       kDsc = kSc + kChunk * kChunk,
                       kBonus = kDsc + kChunk * kChunk,
                       kDbonus = kBonus + kChunk, kDecay = kDbonus + kChunk,
                       kDa = kDecay + D, kU = kDa + D, kTotal = kU + D;
  static_assert(CP <= D * P, "d kj fits in S's place");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// x -> tf32 (round to nearest, ties away), as the bits of an f32
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// d += a (16 x 8, row) . b (8 x 8, col), tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp: out[16, n0..n0+7] = A [16, D] . B, with B(k, n) = M[n, k]
// (b_rows, for dO S^T and v dS^T) or M[k, n] (for k_dec dS), in 3xTF32:
// each operand split as hi + lo (both tf32), and hi.hi + hi.lo + lo.hi
// summed in f32, which keeps f32 accuracy (the lo.lo term is ~2^-22 of
// the product). Fragments are read straight from the padded f32 tiles,
// whose row stride puts the 32 lanes of each read in distinct banks.
template <int D, int P, bool b_rows>
__device__ __forceinline__ void mma3_tile(const float* A, const float* M,
                                          int n0, float* out) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
  for (int k0 = 0; k0 < D; k0 += 8) {
    const float a[4] = {A[g * P + k0 + t], A[(g + 8) * P + k0 + t],
                        A[g * P + k0 + t + 4], A[(g + 8) * P + k0 + t + 4]};
    const float bv[2] = {
        b_rows ? M[(n0 + g) * P + k0 + t] : M[(k0 + t) * P + n0 + g],
        b_rows ? M[(n0 + g) * P + k0 + t + 4] : M[(k0 + t + 4) * P + n0 + g]};
    uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ah[q] = to_tf32(a[q]);
      al[q] = to_tf32(a[q] - __uint_as_float(ah[q]));
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      bh[q] = to_tf32(bv[q]);
      bl[q] = to_tf32(bv[q] - __uint_as_float(bh[q]));
    }
    mma_tf32(acc, al, bh[0], bh[1]);
    mma_tf32(acc, ah, bl[0], bl[1]);
    mma_tf32(acc, ah, bh[0], bh[1]);
  }
  out[g * P + n0 + 2 * t] = acc[0];
  out[g * P + n0 + 2 * t + 1] = acc[1];
  out[(g + 8) * P + n0 + 2 * t] = acc[2];
  out[(g + 8) * P + n0 + 2 * t + 1] = acc[3];
}

// Pass 2, the chunk-local gradients. grid = B * H * n_chunks, block =
// kChunkThreads (16 warps: the phases below are latency-bound, and shared
// memory allows two blocks an SM): every chunk independent, from its
// inputs, its incoming state (the forward's `states`) and the dS leaving
// it (pass 1). The two [D, D] states arrive by cp.async while (1) forms
// the decays (base 2, on the special-function unit), the score gradient,
// the bonus and its gradient; then (2) the [16, D] x [D, D] products
// dO S^T, v dS^T and k_dec dS on tensor cores in 3xTF32 (f32 accuracy),
// d a and the scores; (3) the rest of d ri
// and d kj; (4) dv, and the chain through the exponentials and the cumsum,
// four threads per channel with a suffix scan by shuffles. du is written
// per chunk to du_part [B, H, n_chunks, D].
template <typename T, int D>
__global__ void __launch_bounds__(kChunkThreads)
wkv6_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, Strides sr, Strides sk,
                      Strides sv, Strides sw, const float* __restrict__ dout,
                      const float* __restrict__ states,
                      const float* __restrict__ ds_all,
                      float* __restrict__ dr, float* __restrict__ dk,
                      float* __restrict__ dv, float* __restrict__ dw,
                      float* __restrict__ du_part, int H, int S) {
  using L = ChunkSmem<D>;
  constexpr int P = L::P, C = kChunk;
  extern __shared__ __align__(16) float smem[];
  float* r_s = smem + L::kR;
  float* k_s = smem + L::kK;
  float* v_s = smem + L::kV;
  float* w_s = smem + L::kW;
  float* lw_s = smem + L::kLw;
  float* do_s = smem + L::kDo;
  float* ri = smem + L::kRi;
  float* kj = smem + L::kKj;
  float* kd = smem + L::kKd;
  float* e1_s = smem + L::kE1;
  float* e2_s = smem + L::kE2;
  float* e3_s = smem + L::kE3;
  float* dri = smem + L::kDri;
  float* dkj = smem + L::kDkj;
  float* dkd = smem + L::kDkd;
  float* dvp = smem + L::kDv;
  float* S_s = smem + L::kS;
  float* dS_s = smem + L::kDs;
  float* sc = smem + L::kSc;
  float* dsc = smem + L::kDsc;
  float* bonus = smem + L::kBonus;
  float* dbonus = smem + L::kDbonus;
  float* decay = smem + L::kDecay;
  float* da = smem + L::kDa;
  float* u_s = smem + L::kU;

  const int nc = (S + C - 1) / C;
  const int c = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int b = bh / H, h = bh % H, s0 = c * C;
  const int tid = threadIdx.x, nt = blockDim.x;

  // loads: the chunk's two [D, D] states, asynchronously (they are first
  // needed after the decays), then its rows (masked past S)
  const long long st = ((long long)bh * nc + c) * D * D;
  for (int i = tid; i < D * D / 4; i += nt) {
    const int o = ((4 * i) / D) * P + (4 * i) % D;
    cp_async_16(smem_addr(S_s + o), states + st + 4 * i, true);
    cp_async_16(smem_addr(dS_s + o), ds_all + st + 4 * i, true);
  }
  cp_async_commit();
  for (int i = tid; i < C * D; i += nt) {
    const int t = i / D, d = i % D, s = s0 + t, o = t * P + d;
    float rv = 0.0f, kv = 0.0f, vv = 0.0f, wv = 1.0f, gv = 0.0f;
    if (s < S) {
      rv = to_f32(r[at(sr, b, s, h) + d]);
      kv = to_f32(k[at(sk, b, s, h) + d]);
      vv = to_f32(v[at(sv, b, s, h) + d]);
      wv = w[at(sw, b, s, h) + d];
      gv = dout[(((long long)b * S + s) * H + h) * D + d];
    }
    r_s[o] = rv;
    k_s[o] = kv;
    v_s[o] = vv;
    w_s[o] = wv;
    lw_s[o] = fast_log2(fmaxf(wv, 1e-30f));
    do_s[o] = gv;
  }
  for (int d = tid; d < D; d += nt) u_s[d] = u[h * D + d];
  __syncthreads();

  // (1)
  if (tid < 4 * D) {             // the decays, four threads per channel
    const int d = tid >> 2, g = tid & 3;
    float lw[4], a[4], a_last;
#pragma unroll
    for (int i = 0; i < 4; ++i) lw[i] = lw_s[(4 * g + i) * P + d];
    chunk_cumsum4(g, lw, a, a_last);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = (4 * g + i) * P + d;
      const float e1 = fast_exp2(a[i] - lw[i]), e2 = fast_exp2(-a[i]),
                  e3 = fast_exp2(a_last - a[i]);
      e1_s[o] = e1;
      e2_s[o] = e2;
      e3_s[o] = e3;
      ri[o] = r_s[o] * e1;
      kj[o] = k_s[o] * e2;
      kd[o] = k_s[o] * e3;
    }
    if (g == 0) decay[d] = fast_exp2(a_last);
  }
  for (int i = tid; i < C * C + C; i += nt) {
    if (i < C * C) {                  // dsc[t, j] = dO[t] . v[j], j < t
      const int t = i / C, j = i % C;
      float acc = 0.0f;
      if (j < t)
        for (int e = 0; e < D; e += 4)
          acc = dot4(ld4(do_s + t * P + e), ld4(v_s + j * P + e), acc);
      dsc[i] = acc;
    } else {                          // the bonus and its gradient
      const int t = i - C * C;
      float acc = 0.0f, grad = 0.0f;
      for (int d = 0; d < D; ++d) {
        acc += r_s[t * P + d] * u_s[d] * k_s[t * P + d];
        grad += do_s[t * P + d] * v_s[t * P + d];
      }
      bonus[t] = acc;
      dbonus[t] = grad;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // (2): the [16, D] x [D, D] products on tensor cores (one warp per 8
  // output columns of one product), then d a and the scores
  for (int job = tid / 32; job < 3 * (D / 8); job += nt / 32) {
    const int prod = job / (D / 8), n0 = 8 * (job % (D / 8));
    if (prod == 0) {
      mma3_tile<D, P, true>(do_s, S_s, n0, dri);      // dO S^T -> d ri
    } else if (prod == 1) {
      mma3_tile<D, P, true>(v_s, dS_s, n0, dkd);      // v dS^T -> d k_dec
    } else {
      mma3_tile<D, P, false>(kd, dS_s, n0, dvp);      // k_dec dS -> dv
    }
  }
  for (int i = tid; i < D + C * C; i += nt) {
    if (i < D) {                      // d a[d] = S[d] . dS[d]
      float acc = 0.0f;
      for (int e = 0; e < D; e += 4)
        acc = dot4(ld4(S_s + i * P + e), ld4(dS_s + i * P + e), acc);
      da[i] = acc;
    } else {                          // sc[t, j] = ri[t] . kj[j], j < t
      const int tj = i - D, t = tj / C, j = tj % C;
      float acc = 0.0f;
      if (j < t)
        for (int d = 0; d < D; d += 4)
          acc = dot4(ld4(ri + t * P + d), ld4(kj + j * P + d), acc);
      sc[tj] = acc;
    }
  }
  __syncthreads();

  // (3): the rest of d ri, and d kj
  for (int i = tid; i < C * D; i += nt) {
    const int t = i / D, d = i % D;
    float g_ri = dri[t * P + d], g_kj = 0.0f;
    for (int j = 0; j < t; ++j) g_ri += dsc[t * C + j] * kj[j * P + d];
    for (int q = t + 1; q < C; ++q) g_kj += dsc[q * C + t] * ri[q * P + d];
    dri[t * P + d] = g_ri;
    dkj[t * P + d] = g_kj;
  }
  __syncthreads();

  // (4): dv, and the chain rule per channel
  for (int i = tid; i < C * D + 4 * D; i += nt) {
    if (i < C * D) {                  // dv = sc^T dO + bonus dO + k_dec dS
      const int t = i / D, e = i % D, s = s0 + t;
      float acc = dvp[t * P + e];
      for (int q = t + 1; q < C; ++q) acc += sc[q * C + t] * do_s[q * P + e];
      acc += bonus[t] * do_s[t * P + e];
      if (s < S) dv[(((long long)b * S + s) * H + h) * D + e] = acc;
      continue;
    }
    // per channel, rows 4g..4g+3: the chain through the exponentials and
    // the cumsum (a suffix sum over the chunk, and d A_C in every row)
    const int item = i - C * D, d = item >> 2, g = item & 3;
    float g_last = 0.0f, term[4], g_ex[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int o = (4 * g + m) * P + d;
      g_last += dkd[o] * kd[o];
      g_ex[m] = dri[o] * ri[o];
      term[m] = g_ex[m] - dkj[o] * kj[o] - dkd[o] * kd[o];
    }
    g_last += __shfl_xor_sync(0xffffffffu, g_last, 1);
    g_last += __shfl_xor_sync(0xffffffffu, g_last, 2);
    g_last += da[d] * decay[d];
    // suffix sums: within the thread's rows, then over the later groups
    float local[4];
    local[3] = term[3];
    for (int m = 2; m >= 0; --m) local[m] = term[m] + local[m + 1];
    float incl = local[0];
    float x = __shfl_down_sync(0xffffffffu, incl, 1, 4);
    if (g < 3) incl += x;
    x = __shfl_down_sync(0xffffffffu, incl, 2, 4);
    if (g < 2) incl += x;
    float after = __shfl_down_sync(0xffffffffu, incl, 1, 4);
    if (g == 3) after = 0.0f;
    const float ud = u_s[d];
    float du_acc = 0.0f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int t = 4 * g + m, s = s0 + t, o = t * P + d;
      const float wv = w_s[o], rt = r_s[o], kt = k_s[o], g_b = dbonus[t];
      const float g_lw = after + local[m] - g_ex[m] + g_last;
      du_acc += g_b * rt * kt;
      if (s < S) {
        const long long og = (((long long)b * S + s) * H + h) * D + d;
        dr[og] = dri[o] * e1_s[o] + g_b * ud * kt;
        dk[og] = dkj[o] * e2_s[o] + dkd[o] * e3_s[o] + g_b * ud * rt;
        dw[og] = wv > 1e-30f ? g_lw / wv : 0.0f;
      }
    }
    du_acc += __shfl_xor_sync(0xffffffffu, du_acc, 1);
    du_acc += __shfl_xor_sync(0xffffffffu, du_acc, 2);
    if (g == 0) du_part[((long long)bh * nc + c) * D + d] = du_acc;
  }
}

// Dynamic shared memory above 48 KB must be opted into, once per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

Strides strides_of(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <typename T, int D>
int fwd(const void* r, const void* k, const void* v, const void* w,
        const void* u, const long long* st, void* out, void* states,
        void* final_state, int B, int S, int H, cudaStream_t stream) {
  const size_t smem = FwdSmem<D>::kTotal * sizeof(float);
  auto kernel = wkv6_fwd_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), strides_of(st, 0), strides_of(st, 1),
      strides_of(st, 2), strides_of(st, 3), static_cast<float*>(out),
      static_cast<float*>(states), static_cast<float*>(final_state), H, S);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd(const void* r, const void* k, const void* v, const void* w,
        const void* u, const long long* st, const void* dout,
        const void* dfinal, const void* states, void* ds_all, void* dr,
        void* dk, void* dv, void* dw, void* du_part, int B, int S, int H,
        int passes, cudaStream_t stream) {
  if (passes & 1) {
    wkv6_bwd_scan_kernel<T, D><<<B * H * (D / kSlice), kThreads, 0, stream>>>(
        static_cast<const T*>(r), static_cast<const float*>(w),
        strides_of(st, 0), strides_of(st, 3), static_cast<const float*>(dout),
        static_cast<const float*>(dfinal), static_cast<float*>(ds_all), H, S);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (passes & 2) {
    const size_t smem = ChunkSmem<D>::kTotal * sizeof(float);
    auto kernel = wkv6_bwd_chunk_kernel<T, D>;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int nc = (S + kChunk - 1) / kChunk;
    kernel<<<B * H * nc, kChunkThreads, smem, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(w),
        static_cast<const float*>(u), strides_of(st, 0), strides_of(st, 1),
        strides_of(st, 2), strides_of(st, 3), static_cast<const float*>(dout),
        static_cast<const float*>(states), static_cast<const float*>(ds_all),
        static_cast<float*>(dr), static_cast<float*>(dk),
        static_cast<float*>(dv), static_cast<float*>(dw),
        static_cast<float*>(du_part), H, S);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_d(int D, const void* r, const void* k, const void* v, const void* w,
          const void* u, const long long* st, void* out, void* states,
          void* final_state, int B, int S, int H, cudaStream_t s) {
  switch (D) {
    case 16: return fwd<T, 16>(r, k, v, w, u, st, out, states, final_state, B, S, H, s);
    case 32: return fwd<T, 32>(r, k, v, w, u, st, out, states, final_state, B, S, H, s);
    case 64: return fwd<T, 64>(r, k, v, w, u, st, out, states, final_state, B, S, H, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int bwd_d(int D, const void* r, const void* k, const void* v, const void* w,
          const void* u, const long long* st, const void* dout,
          const void* dfinal, const void* states, void* ds_all, void* dr,
          void* dk, void* dv, void* dw, void* du_part, int B, int S, int H,
          int passes, cudaStream_t s) {
  switch (D) {
    case 16: return bwd<T, 16>(r, k, v, w, u, st, dout, dfinal, states, ds_all, dr, dk, dv, dw, du_part, B, S, H, passes, s);
    case 32: return bwd<T, 32>(r, k, v, w, u, st, dout, dfinal, states, ds_all, dr, dk, dv, dw, du_part, B, S, H, passes, s);
    case 64: return bwd<T, 64>(r, k, v, w, u, st, dout, dfinal, states, ds_all, dr, dk, dv, dw, du_part, B, S, H, passes, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype 0: r/k/v f32, 1: bf16. strides: 12 element strides, (b, s, h) of
// r, k, v, w in turn. states / final_state may be null (not written).
int wkv6_fwd(int dtype, const void* r, const void* k, const void* v,
             const void* w, const void* u, const long long* strides,
             void* out, void* states, void* final_state, int B, int S, int H,
             int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd_d<float>(D, r, k, v, w, u, strides, out, states, final_state,
                        B, S, H, s);
  if (dtype == 1)
    return fwd_d<__nv_bfloat16>(D, r, k, v, w, u, strides, out, states,
                                final_state, B, S, H, s);
  return (int)cudaErrorInvalidValue;
}

// The backward's two kernels on one stream: pass 1 (passes & 1) scans dS
// through the chunks and writes the dS leaving each to ds_all
// [B, H, n_chunks, D, D] f32; pass 2 (passes & 2) forms every chunk's
// gradients from ds_all. dout: [B, S, H, D] f32 contiguous; dfinal:
// [B, H, D, D] f32 or null (zero); states: the forward's; dr/dk/dv/dw:
// [B, S, H, D] f32; du_part: [B, H, n_chunks, D] f32.
int wkv6_bwd(int dtype, const void* r, const void* k, const void* v,
             const void* w, const void* u, const long long* strides,
             const void* dout, const void* dfinal, const void* states,
             void* ds_all, void* dr, void* dk, void* dv, void* dw,
             void* du_part, int B, int S, int H, int D, int passes,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_d<float>(D, r, k, v, w, u, strides, dout, dfinal, states,
                        ds_all, dr, dk, dv, dw, du_part, B, S, H, passes, s);
  if (dtype == 1)
    return bwd_d<__nv_bfloat16>(D, r, k, v, w, u, strides, dout, dfinal,
                                states, ds_all, dr, dk, dv, dw, du_part, B, S,
                                H, passes, s);
  return (int)cudaErrorInvalidValue;
}

const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
