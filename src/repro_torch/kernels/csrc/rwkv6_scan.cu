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
// Forward: the state's columns split over blocks. The recurrence is
// separable over the value columns e:
//
//     out[:, e] = tril(ri kj^T, -1) v[:, e] + bonus * v[:, e] + ri S[:, e]
//     S[:, e]  <- diag(a) S[:, e] + k_dec^T v[:, e]
//
// so a block carries a column slice S[:, e0:e0+SL] through the chunks with
// no traffic between blocks: B * H * (D / SL) blocks of 512 threads (SL =
// 32: 128 blocks at the training shape, one an SM; SL is at most D). Every
// block recomputes what all slices need from r, k and w over the full D
// (ri, kj, k_dec, a, the scores and the bonus), so r/k/w are read D / SL
// times, from L2. Only ri S[:, slice] and the update of S depend on the
// carried state; the rest of a chunk does not, so the block is two warp
// groups that overlap: a chunk group runs one chunk ahead (its rows by
// cp.async into double-buffered staging, the decays as products of w
// with one reciprocal an element, the bonus, the [16, 16] scores), while a
// state group carries the state (in mma accumulators), forms ri S and the
// update, and writes the output. Named barriers order each group, one
// block barrier a chunk hands the next chunk's tiles over. Every product
// runs on tensor cores in 3xTF32 (mma.sync m16n8k8, each operand split
// into two tf32 halves), which keeps f32 accuracy; plain TF32 would not.
//
// What bounded the first design (one block per (b, h): 64 blocks on 132
// SMs, five barriers a chunk, every product a scalar walk through shared
// memory, the decays on a quarter of the threads) was latency, ~10 us a
// chunk. What bounds this one is the chain of 16 chunks a block: per
// chunk, the longer of the two groups' latency chains (the chunk group's
// decays and scores, the state group's ri S and update) and a block
// barrier. The slice is kFwdSlice = 32 columns (at most D): on the H100 it
// beat 16 and 8 (PERF.md), because the chunk group's work, repeated by
// every slice of a head, is then done once an SM. The
// chunk-parallel three-pass form (local states, a scan over chunks, then
// the outputs) was not taken: it moves ~67 MB of states through device
// memory per call, ~20 us at 3.35 TB/s, four times the bound, where the
// fused slice scan keeps S on chip. It writes out [B, S, H, D] f32,
// optionally every chunk's incoming state [B, H, n_chunks, D, D] f32 (read
// by the backward), straight from the accumulators, and the final state
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
constexpr int kFwdSlice = 32;   // the forward's state columns a block

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

// log2 and 2^x on the special-function unit (relative error ~2^-22). The
// backward forms its decays in base 2: exp(A) = 2^(A / ln 2), so A2, the
// cumsum of log2 w, gives the same factors as the natural-log definition.
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
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

// d += a (16 x 8, row) . b (8 x 8, col), tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x as tf32 hi + lo in three instructions: hi rounded to nearest (ties
// away) by integer ops, as cvt.rna does for finite x (its NaN and Inf
// handling, four instructions a conversion on sm_90, is not needed here);
// lo = x - hi exactly, left to the tensor core to cut to tf32 (it reads the
// top 19 bits: an error of at most 2^-10 of lo, ~2^-21 of x)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// hi + lo += a . b for one warp's m16n8k8 fragments (g = lane / 4, t =
// lane % 4: a holds A(g, t), A(g + 8, t), A(g, t + 4), A(g + 8, t + 4);
// b holds B(t, g), B(t + 4, g); hi and lo hold D(g, 2t), D(g, 2t + 1),
// D(g + 8, 2t), D(g + 8, 2t + 1)) in 3xTF32: each operand split as hi + lo
// (both tf32), hi.hi summed into hi and hi.lo + lo.hi into lo (two shorter
// dependency chains), which keeps f32 accuracy (the lo.lo term is ~2^-22
// of the product); plain TF32 would not.
__device__ __forceinline__ void mma3x(float (&hi)[4], float (&lo)[4],
                                      const float (&a)[4],
                                      const float (&b)[2]) {
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int q = 0; q < 4; ++q) split_tf32(a[q], ah[q], al[q]);
#pragma unroll
  for (int q = 0; q < 2; ++q) split_tf32(b[q], bh[q], bl[q]);
  mma_tf32(lo, al, bh[0], bh[1]);
  mma_tf32(lo, ah, bl[0], bl[1]);
  mma_tf32(hi, ah, bh[0], bh[1]);
}

// 1 / x on the special-function unit (rel err ~2^-23)
__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The products of w along one chunk, four threads per channel (as
// chunk_cumsum4, multiplicative): the thread with g = lane & 3 owns rows
// 4g..4g+3 and holds their w. On return incl / excl hold the products of
// w up to and including / before each of its rows, and last the chunk's.
__device__ __forceinline__ void chunk_cumprod4(int g, const float (&w)[4],
                                               float (&incl)[4],
                                               float (&excl)[4],
                                               float& last) {
  float run = 1.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    excl[i] = run;
    run *= w[i];
  }
  float p = run;
  float x = __shfl_up_sync(0xffffffffu, p, 1, 4);
  if (g >= 1) p *= x;
  x = __shfl_up_sync(0xffffffffu, p, 2, 4);
  if (g >= 2) p *= x;
  float before = __shfl_up_sync(0xffffffffu, p, 1, 4);
  if (g == 0) before = 1.0f;
  last = __shfl_sync(0xffffffffu, p, 3, 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    excl[i] *= before;
    incl[i] = excl[i] * w[i];
  }
}

// Sums x[0..N-1] (a thread's rows) over the lanes whose bits from MASK up
// differ (a warp's channels), folded: each step keeps half the rows (the
// upper half where the lane's MASK bit is set, adding `sel` to the row it
// will hold) and adds the partner lane's copy of them; once one row is
// left, plain adds. On return x[0] is the sum for row sel.
template <int N, int MASK>
__device__ __forceinline__ void fold_rows(float* x, int lane, int& sel) {
  if constexpr (MASK < 32) {
    if constexpr (N > 1) {
      const bool up = lane & MASK;
#pragma unroll
      for (int q = 0; q < N / 2; ++q) {
        const float send = up ? x[q] : x[q + N / 2];
        const float keep = up ? x[q + N / 2] : x[q];
        x[q] = keep + __shfl_xor_sync(0xffffffffu, send, MASK);
      }
      if (up) sel += N / 2;
      fold_rows<N / 2, 2 * MASK>(x, lane, sel);
    } else {
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], MASK);
      fold_rows<1, 2 * MASK>(x, lane, sel);
    }
  }
}

// bar.sync on a named barrier: the `count` threads of one warp group
__device__ __forceinline__ void group_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count));
}

// The forward's shared memory (dynamic), in floats, then the staging
// buffers in bytes. The block is two groups of 8 warps (below); every
// array the two share is double-buffered by chunk parity. Rows are padded
// so that fragment reads and float2 stores hit distinct banks (2-way at
// worst): ri and kj [d][t] are read as (d = t4, t = g), k_dec [d][t] as
// (d = g, t = t4), rows of v, S and ri S (RP = 24 mod 32) as (row = t4,
// col = g). The staging buffers (two) hold one chunk's rows of r, k, w
// [C][D] and v [C][SL] as loaded, by cp.async in 16-byte pieces; the r, k
// and w rows padded by 16 bytes (reads of rows 4 apart fall 16 banks
// apart).
template <typename T, int D, int SL>
struct FwdSmem {
  static constexpr int C = kChunk, NWA = 4 * D / 32;   // warps of the decays
  static constexpr int TP = C + 8, KP = C + 4, SCP = C + 8,
                       RP = SL <= 24 ? 24 : 56;
  static constexpr int kRiT = 0,                     // [2][D][TP]
                       kKjT = kRiT + 2 * D * TP,     // [D][TP]
                       kKdT = kKjT + D * TP,         // [2][D][KP]
                       kV = kKdT + 2 * D * KP,       // [2][C][RP]
                       kSc = kV + 2 * C * RP,        // [2][2 halves][C][SCP]
                       kBpart = kSc + 4 * C * SCP,   // [2][NWA][C]
                       kDecay = kBpart + 2 * NWA * C,   // [2][D]
                       kS = kDecay + 2 * D,          // [D][RP]
                       kOutS = kS + D * RP,          // [2 halves][C][RP]
                       kFloats = kOutS + 2 * C * RP;
  static constexpr int E = 16 / sizeof(T);            // elements a copy
  static constexpr int RB = D * sizeof(T) + 16, WB = D * 4 + 16,
                       VB = SL * sizeof(T);           // staged row bytes
  static constexpr int kR = 0, kK = C * RB, kW = 2 * C * RB,
                       kVr = kW + C * WB, kStage = kVr + C * VB;
  static constexpr int kStage0 = (kFloats * 4 + 15) / 16 * 16,
                       kBytes = kStage0 + 2 * kStage;
  // copies a chunk: r and k, w, v
  static constexpr int NR = C * D / E, NW = C * D / 4, NV = C * SL / E;
  static_assert(SL * sizeof(T) % 16 == 0, "a v row is whole copies");
};

constexpr int kFwdThreads = 512, kGroup = 256;   // two groups of 8 warps

// The forward. grid = B * H * (D / SL), block = 512 threads, one block per
// (b, h, column slice e0..e0+SL), in two groups that overlap (named
// barriers within a group, one block barrier a chunk):
//   the chunk group (warps 0-7) runs one chunk ahead: the copies of the
//       chunk after next; the decays of the next chunk, four threads a
//       channel (thread tid < 4 D: channel ad = tid / 4, rows 4 ag..4 ag +
//       3), ri, kj, k_dec, a and the bonus summed over the warp's
//       channels, and its v; then its scores ri kj^T, strictly below the
//       diagonal, on warps 0-3 (tile j0 = 8 (w % 2), half w / 2 of K = D);
//   the state group (warps 8-15, bw = w - 8) carries this chunk's state:
//       it stores its tiles of S to shared memory (and to the chunk
//       states), then each warp updates its tiles bw, bw + 8 (m16n8 tiles
//       (i / (SL / 8), i % (SL / 8)) of the state slice, rows r0, r0 + 8 and
//       columns c0, c0 + 1 a lane, in mma accumulators): S <- diag(a) S +
//       k_dec^T v (K = 16), while warps bw < 2 SL / 8 form ri S (tile bw %
//       (SL / 8), half bw / (SL / 8) of K = D); then the chunk's output,
//       out = ri S + tril(sc, -1) v + bonus v.
// r/k/v/w rows must start 16-byte aligned (the wrapper refuses any input
// whose rows do not).
template <typename T, int D, int SL>
__global__ void __launch_bounds__(kFwdThreads)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, Strides sr, Strides sk,
                Strides sv, Strides sw, float* __restrict__ out,
                float* __restrict__ states, float* __restrict__ final_state,
                int H, int S) {
  using L = FwdSmem<T, D, SL>;
  constexpr int C = kChunk, NS = D / SL, NWA = L::NWA;
  constexpr int NT = (D / 16) * (SL / 8), NJ = 2 * (SL / 8);
  constexpr int TP = L::TP, KP = L::KP, SCP = L::SCP, RP = L::RP;
  static_assert(D % 16 == 0 && SL % 8 == 0 && SL <= D && 4 * D <= kGroup,
                "tile shapes");
  static_assert(NT <= 16 && NJ <= 8, "two state tiles, one ri S half a warp");
  extern __shared__ __align__(16) float smem[];
  unsigned char* stage = reinterpret_cast<unsigned char*>(smem) + L::kStage0;

  const int bh = blockIdx.x / NS, e0 = (blockIdx.x % NS) * SL;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int nc = (S + C - 1) / C;
  const bool chunk_group = tid < kGroup;

  if (chunk_group) {
    // ------------------------------------------------------------------
    // the chunk group
    const bool a_role = tid < 4 * D;
    const int ad = tid >> 2, ag = tid & 3;
    const float ud = a_role ? u[h * D + ad] : 0.0f;
    // chunk c's rows into staging buffer c & 1, 16 bytes a copy, zero-
    // filled past S (the decays read w = 1 there). This thread's copies
    // are fixed slots (tid + kGroup n): a row and 16 bytes of r, k, w or
    // v, whose source moves down C rows a chunk (a copy past S reads
    // nothing, from the slot's row 0).
    constexpr int NCP = 2 * L::NR + L::NW + L::NV;
    constexpr int NSLOT = (NCP + kGroup - 1) / kGroup;
    const unsigned char* src0[NSLOT];
    long long step[NSLOT];
    int dst_off[NSLOT], row_of[NSLOT];
#pragma unroll
    for (int n = 0; n < NSLOT; ++n) {
      const int i = min(tid + kGroup * n, NCP - 1);
      const Strides* ss;
      const unsigned char* base;
      int row, col, size, dst;
      if (i < 2 * L::NR) {
        const int j = i % L::NR, kk = i / L::NR;
        row = j / (D / L::E);
        col = (j % (D / L::E)) * L::E;
        ss = kk ? &sk : &sr;
        base = reinterpret_cast<const unsigned char*>(kk ? k : r);
        size = sizeof(T);
        dst = (kk ? L::kK : L::kR) + row * L::RB + col * size;
      } else if (i < 2 * L::NR + L::NW) {
        const int j = i - 2 * L::NR;
        row = j / (D / 4);
        col = (j % (D / 4)) * 4;
        ss = &sw;
        base = reinterpret_cast<const unsigned char*>(w);
        size = 4;
        dst = L::kW + row * L::WB + col * 4;
      } else {
        const int j = i - 2 * L::NR - L::NW;
        row = j / (SL / L::E);
        col = (j % (SL / L::E)) * L::E;
        ss = &sv;
        base = reinterpret_cast<const unsigned char*>(v) + e0 * sizeof(T);
        size = sizeof(T);
        dst = L::kVr + row * L::VB + col * size;
      }
      src0[n] = base + (at(*ss, b, 0, h) + col) * size;
      step[n] = ss->s * size;
      dst_off[n] = dst;
      row_of[n] = row;
    }
    auto fetch = [&](int c) {
      unsigned char* buf = stage + (c & 1) * L::kStage;
#pragma unroll
      for (int n = 0; n < NSLOT; ++n) {
        if (tid + kGroup * n < NCP) {
          const int s = c * C + row_of[n];
          cp_async_16(smem_addr(buf + dst_off[n]),
                      s < S ? src0[n] + s * step[n] : src0[n], s < S);
        }
      }
      cp_async_commit();
    };
    // chunk c: its copies have landed (the next chunk's may be in flight)
    auto prepare = [&](int c) {
      if (c + 1 < nc) {
        fetch(c + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      group_sync(1, kGroup);
      const int p = c & 1;
      const unsigned char* buf = stage + p * L::kStage;
      // the decays as products of w (exp(A) = prod w): one reciprocal an
      // element on the special-function unit, not a log and three exps
      if (a_role) {
        float rv[4], kv[4], wv[4], incl[4], excl[4], a_last;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int row = 4 * ag + m;
          rv[m] = to_f32(reinterpret_cast<const T*>(buf + L::kR + row * L::RB)[ad]);
          kv[m] = to_f32(reinterpret_cast<const T*>(buf + L::kK + row * L::RB)[ad]);
          const float x = reinterpret_cast<const float*>(buf + L::kW + row * L::WB)[ad];
          wv[m] = c * C + row < S ? fmaxf(x, 1e-30f) : 1.0f;
        }
        chunk_cumprod4(ag, wv, incl, excl, a_last);
        float ri[4], kj[4], kd[4], bo[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          ri[m] = rv[m] * excl[m];
          kj[m] = kv[m] * fast_rcp(incl[m]);
          kd[m] = kj[m] * a_last;
          bo[m] = rv[m] * ud * kv[m];
        }
        // the bonus of rows 4 ag..4 ag + 3 summed over the warp's channels
        int sel = 0;
        fold_rows<4, 4>(bo, lane, sel);
        if (!(lane & 16))
          smem[L::kBpart + (p * NWA + warp) * C + 4 * ag + sel] = bo[0];
        *reinterpret_cast<float4*>(&smem[L::kRiT + p * D * TP + ad * TP + 4 * ag]) =
            make_float4(ri[0], ri[1], ri[2], ri[3]);
        *reinterpret_cast<float4*>(&smem[L::kKjT + ad * TP + 4 * ag]) =
            make_float4(kj[0], kj[1], kj[2], kj[3]);
        *reinterpret_cast<float4*>(&smem[L::kKdT + p * D * KP + ad * KP + 4 * ag]) =
            make_float4(kd[0], kd[1], kd[2], kd[3]);
        if (ag == 0) smem[L::kDecay + p * D + ad] = a_last;
      }
      for (int i = tid; i < C * SL; i += kGroup)
        smem[L::kV + p * C * RP + (i / SL) * RP + i % SL] = to_f32(
            reinterpret_cast<const T*>(buf + L::kVr + (i / SL) * L::VB)[i % SL]);
      group_sync(1, kGroup);
      // the scores, strictly below the diagonal: [16, D] x [D, 8], half K
      if (warp < 4) {
        const int j0 = 8 * (warp % 2), half = warp / 2;
        const float* ri = smem + L::kRiT + p * D * TP;
        const float* kj = smem + L::kKjT;
        float hi[4] = {}, lo[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int k0 = half * (D / 2) + 8 * kk;
          const float fa[4] = {ri[(k0 + t4) * TP + g], ri[(k0 + t4) * TP + g + 8],
                               ri[(k0 + t4 + 4) * TP + g],
                               ri[(k0 + t4 + 4) * TP + g + 8]};
          const float fb[2] = {kj[(k0 + t4) * TP + j0 + g],
                               kj[(k0 + t4 + 4) * TP + j0 + g]};
          mma3x(hi, lo[kk % 2], fa, fb);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          hi[q] += lo[0][q] + lo[1][q];
          if (j0 + 2 * t4 + q % 2 >= g + 8 * (q / 2)) hi[q] = 0.0f;
        }
        float* dst = smem + L::kSc + (p * 2 + half) * C * SCP;
        *reinterpret_cast<float2*>(&dst[g * SCP + j0 + 2 * t4]) =
            make_float2(hi[0], hi[1]);
        *reinterpret_cast<float2*>(&dst[(g + 8) * SCP + j0 + 2 * t4]) =
            make_float2(hi[2], hi[3]);
      }
    };
    fetch(0);
    prepare(0);
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      if (c + 1 < nc) prepare(c + 1);
      __syncthreads();
    }
    return;
  }

  // --------------------------------------------------------------------
  // the state group
  const int btid = tid - kGroup, bw = warp - 8;
  float st[2][4] = {};
  auto tile_r0 = [&](int i) { return (i / (SL / 8)) * 16 + g; };
  auto tile_c0 = [&](int i) { return (i % (SL / 8)) * 8 + 2 * t4; };
  // tile i of the state slice, float2 a lane (each 32-byte sector written
  // whole by four lanes), into a [D, D] state at column e0 or the [D, RP]
  // slice in shared memory
  auto store_tile = [&](int n, float* dst, int ld) {
    const int i = bw + 8 * n;
    dst += tile_r0(i) * ld + tile_c0(i);
    *reinterpret_cast<float2*>(dst) = make_float2(st[n][0], st[n][1]);
    *reinterpret_cast<float2*>(dst + 8 * ld) = make_float2(st[n][2], st[n][3]);
  };
  float* S_s = smem + L::kS;
  float* outS = smem + L::kOutS;
  __syncthreads();              // chunk 0 prepared
  for (int c = 0; c < nc; ++c) {
    const int p = c & 1;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (bw + 8 * n < NT) {    // the state entering chunk c
        store_tile(n, S_s, RP);
        if (states != nullptr)
          store_tile(n, states + ((long long)bh * nc + c) * D * D + e0, D);
      }
    }
    group_sync(2, kGroup);
    // S <- diag(a) S + k_dec^T v, this warp's tiles
    const float* kd = smem + L::kKdT + p * D * KP;
    const float* vc = smem + L::kV + p * C * RP;
    const float* decay = smem + L::kDecay + p * D;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int i = bw + 8 * n;
      if (i < NT) {
        const int r0 = tile_r0(i), n0 = tile_c0(i) - 2 * t4;
        const float a0 = decay[r0], a1 = decay[r0 + 8];
        st[n][0] *= a0;
        st[n][1] *= a0;
        st[n][2] *= a1;
        st[n][3] *= a1;
        float lo[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int k0 = 8 * kk;
          const float fa[4] = {kd[r0 * KP + k0 + t4], kd[(r0 + 8) * KP + k0 + t4],
                               kd[r0 * KP + k0 + t4 + 4],
                               kd[(r0 + 8) * KP + k0 + t4 + 4]};
          const float fb[2] = {vc[(k0 + t4) * RP + n0 + g],
                               vc[(k0 + t4 + 4) * RP + n0 + g]};
          mma3x(st[n], lo[kk], fa, fb);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) st[n][q] += lo[0][q] + lo[1][q];
      }
    }
    // ri S: [16, D] x [D, 8], half of K, this warp's tile
    if (bw < NJ) {
      const int n0 = 8 * (bw % (SL / 8)), half = bw / (SL / 8);
      const float* ri = smem + L::kRiT + p * D * TP;
      float hi[4] = {}, lo[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int k0 = half * (D / 2) + 8 * kk;
        const float fa[4] = {ri[(k0 + t4) * TP + g], ri[(k0 + t4) * TP + g + 8],
                             ri[(k0 + t4 + 4) * TP + g],
                             ri[(k0 + t4 + 4) * TP + g + 8]};
        const float fb[2] = {S_s[(k0 + t4) * RP + n0 + g],
                             S_s[(k0 + t4 + 4) * RP + n0 + g]};
        mma3x(hi, lo[kk % 2], fa, fb);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) hi[q] += lo[0][q] + lo[1][q];
      float* dst = outS + half * C * RP;
      *reinterpret_cast<float2*>(&dst[g * RP + n0 + 2 * t4]) =
          make_float2(hi[0], hi[1]);
      *reinterpret_cast<float2*>(&dst[(g + 8) * RP + n0 + 2 * t4]) =
          make_float2(hi[2], hi[3]);
    }
    group_sync(2, kGroup);
    // the output: ri S + tril(sc, -1) v (each the sum of its two halves)
    // + bonus v (the bonus the sum of its warps' parts)
    const float* sc = smem + L::kSc + p * 2 * C * SCP;
    for (int i = btid; i < C * SL; i += kGroup) {
      const int t = i / SL, e = i % SL;
      float bonus = 0.0f;
#pragma unroll
      for (int j = 0; j < NWA; ++j)
        bonus += smem[L::kBpart + (p * NWA + j) * C + t];
      float acc = fmaf(bonus, vc[t * RP + e],
                       outS[t * RP + e] + outS[C * RP + t * RP + e]);
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        const float4 s0 = ld4(&sc[t * SCP + 4 * q]);
        const float4 s1 = ld4(&sc[C * SCP + t * SCP + 4 * q]);
        acc = fmaf(s0.x + s1.x, vc[(4 * q) * RP + e], acc);
        acc = fmaf(s0.y + s1.y, vc[(4 * q + 1) * RP + e], acc);
        acc = fmaf(s0.z + s1.z, vc[(4 * q + 2) * RP + e], acc);
        acc = fmaf(s0.w + s1.w, vc[(4 * q + 3) * RP + e], acc);
      }
      const int s = c * C + t;
      if (s < S) out[(((long long)b * S + s) * H + h) * D + e0 + e] = acc;
    }
    __syncthreads();
  }
  if (final_state != nullptr) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
      if (bw + 8 * n < NT)
        store_tile(n, final_state + (long long)bh * D * D + e0, D);
  }
}

// ---------------------------------------------------------------------------
// Backward, in two passes
// ---------------------------------------------------------------------------

constexpr int kSlice = 16;   // dS columns per scan block
constexpr int kRowStep = kThreads / kSlice;   // rows between a thread's dS lanes
constexpr int kChunkThreads = 512;   // pass 2's block

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

// One warp: out[16, n0..n0+7] = A [16, D] . B, with B(k, n) = M[n, k]
// (b_rows, for dO S^T and v dS^T) or M[k, n] (for k_dec dS), in 3xTF32
// (mma3x). Fragments are read straight from the padded f32 tiles, whose
// row stride puts the 32 lanes of each read in distinct banks.
template <int D, int P, bool b_rows>
__device__ __forceinline__ void mma3_tile(const float* A, const float* M,
                                          int n0, float* out) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float acc[4] = {}, lo[4] = {};
#pragma unroll 2
  for (int k0 = 0; k0 < D; k0 += 8) {
    const float a[4] = {A[g * P + k0 + t], A[(g + 8) * P + k0 + t],
                        A[g * P + k0 + t + 4], A[(g + 8) * P + k0 + t + 4]};
    const float bv[2] = {
        b_rows ? M[(n0 + g) * P + k0 + t] : M[(k0 + t) * P + n0 + g],
        b_rows ? M[(n0 + g) * P + k0 + t + 4] : M[(k0 + t + 4) * P + n0 + g]};
    mma3x(acc, lo, a, bv);
  }
  out[g * P + n0 + 2 * t] = acc[0] + lo[0];
  out[g * P + n0 + 2 * t + 1] = acc[1] + lo[1];
  out[(g + 8) * P + n0 + 2 * t] = acc[2] + lo[2];
  out[(g + 8) * P + n0 + 2 * t + 1] = acc[3] + lo[3];
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

// Dynamic shared memory above 48 KB must be opted into, per kernel and
// per device (the attribute lives in the current device's context), so
// every launch asks.
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

// The forward at head dim D: a column slice of min(D, kFwdSlice).
template <typename T, int D>
int fwd(const void* r, const void* k, const void* v, const void* w,
        const void* u, const long long* st, void* out, void* states,
        void* final_state, int B, int S, int H, cudaStream_t stream) {
  constexpr int SL = D < kFwdSlice ? D : kFwdSlice;
  using L = FwdSmem<T, D, SL>;
  auto kernel = wkv6_fwd_kernel<T, D, SL>;
  const cudaError_t err = allow_smem(kernel, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * H * (D / SL), kFwdThreads, L::kBytes, stream>>>(
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
int fwd_d(int D, const void* r, const void* k, const void* v,
          const void* w, const void* u, const long long* st, void* out,
          void* states, void* final_state, int B, int S, int H,
          cudaStream_t s) {
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
