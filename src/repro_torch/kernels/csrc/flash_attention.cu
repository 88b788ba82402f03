// Flash attention forward (causal, sliding window, tanh softcap, GQA) for
// Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body _flash_kernel). Same function: per (batch, head),
// softmax(softcap(q k^T / sqrt(D)) under the mask) v, with the mask
// 0 <= qpos - kpos (causal) and qpos - kpos < window (window > 0), the
// KV head of query head h being h / (H / KV), f32 row statistics, output in
// the input type, and the row sum divided as max(l, 1e-30).
//
// Layout: q [B, S, H, D], k/v [B, S, KV, D] read through their strides
// (last dim contiguous), so prefill hands over its projections with no
// transpose; out is a contiguous [B, S, H, D].
//
// Three kernels: f32, and two for bf16 (the serve path's type).
//
// bf16, head dims 16-128: tensor cores. At the serve run's prefill
// shapes (S <= 512, D = 128) the work is ~1 GFLOP and ~6 MB, under 2 us of
// the card at either peak; with 1 to 8 key tiles per block the kernel is
// bound by latency and occupancy, not by the tensor-core rate, so it is
// FA2-shaped on mma.sync rather than wgmma: one block per (64-row q tile,
// head, batch) of two groups of 4 warps, each warp owning 16 query rows;
// group 0 takes the even key tiles of the band and group 1 the odd ones,
// and the two merge their row max, sum and accumulator at the end, which
// halves the serial chain of the heaviest blocks. Q.K^T and P.V run
// as mma.sync m16n8k16 (bf16 in, f32 accumulate) with operands from
// ldmatrix (.trans for V). K/V tiles of 64 keys stream through a
// double-buffered shared-memory ring per group by cp.async (16 bytes a
// thread, a zero-fill source size for rows past S, so a ragged S needs no
// branch); rows are padded by 16 bytes, which puts the 8 rows of every ldmatrix
// phase in distinct bank groups. The online softmax lives in the mma
// accumulators: the row max and sum by quad shuffles, nothing of size S x S
// in shared or device memory. P is rounded to bf16 in registers and fed
// straight back as the A operand of the P.V mma, as the reference prefill
// rounds its probabilities before P.V; the row sum adds the rounded values,
// so the weights that multiply V sum to l exactly. Tiles wholly outside the
// causal / window band are skipped by the loop bounds, and only tiles that
// cross the diagonal, the window's edge or S are masked. The grid is 1-D
// with the heaviest q tiles (the last, under causal masking) first.
// Needs 16-byte aligned rows: the wrapper checks base pointers and the b,
// s, h strides (multiples of 8 elements) and raises otherwise.
//
// bf16, head dim 256 (gemma3-1b; namespace hop): a kernel of its own. At
// gemma3-1b's prefill (S <= 512, 4 heads, 1 KV head) the work is ~0.5
// GFLOP and ~2.6 MB, under a microsecond of the card, so what bounds it is
// the serial chain of the heaviest (q tile, head) - up to 8 key tiles of
// 64 x 256 - against a grid of only ceil(S / 64) x H x B tiles, and the
// per-tile cost of 256-wide rows: a 64 x 256 f32 output accumulator is 128
// registers a thread, and two stages of padded K/V rows do not fit a
// block's shared memory, so the mma.sync design above can neither hold Q
// in registers nor overlap copies with products at this width. The design:
// * wgmma, operands in shared memory: one warpgroup a block owns a 64-row
//   q tile; S = Q K^T is 16 wgmma m64n64k16 with Q and K both read through
//   descriptors (nothing of Q in registers), P (bf16, in registers) is the
//   A operand of 4 wgmma m64n256k16 a tile with V as an MN-major B.
// * TMA, no padding: Q, K and V tiles come in by cp.async.bulk.tensor as
//   four 64-column boxes with 128-byte swizzle (the layout wgmma reads),
//   completing on mbarriers; rows past S are zero-filled by the copy. Q's
//   and K's boxes each have a barrier, so the first products start on the
//   first boxes to land; the next tile's K streams in behind this tile's
//   softmax and P.V, its V behind the next Q.K^T. 96 KB a block: two
//   blocks an SM. The tensor maps are encoded on the host per call
//   (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint: no -lcuda).
// * The key band split over a thread-block cluster: the band of each
//   (q tile, head, batch) is cut into C chunks of at most T key tiles, one
//   block each, the C blocks one cluster (cudaLaunchKernelEx; C and T from
//   kernels/flash_attention.split_plan, which grows C while the card still
//   runs every cluster at once). The blocks then merge their f32 partials
//   (O, m, l) through distributed shared memory: each sends every other
//   block its slice of the 256 columns, and each block sums its slice's
//   partials in rank order - no atomics, so repeated calls are bit-equal.
//   Splitting changes the order of the bf16 P.V sums against one block's
//   online pass (the 2^(m - max m) weights), within the same tolerance.
// An mbarrier wait that spins 4M times traps, so a lost copy fails the
// launch instead of hanging the card.
//
// f32: the plain f32 pipes (TF32 would break the f32 callers' 1e-4
// tolerance). One block per (q tile of 32 rows, head, batch); K/V tiles of
// 64 keys stream through shared memory; the scores tile, the running max
// m, the running sum l and the rescale factor stay in shared memory and
// the output accumulator in registers. Masked scores become -inf and
// contribute exactly 0. At D = 256 the tiles take 172,928 B of dynamic
// shared memory and each thread accumulates an 8 x 8 output tile.
//
// C interface (loaded with ctypes by repro_torch/kernels/flash_attention.py):
// pointers and the stream as void*, returns cudaGetLastError() (or a code
// past the runtime's for a refused tensor map; see the error string).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include <type_traits>

namespace {

constexpr int BQ = 32;   // query rows per block
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int NT = 128;  // threads per block (4 warps)
constexpr int NW = NT / 32;

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, ldmatrix, cp.async)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 64;    // query rows per block: 4 warps x 16 per group
constexpr int BK = 64;    // keys per shared-memory tile
constexpr int GT = 128;   // threads per group (4 warps)
constexpr int NT = 2 * GT;  // two groups, over the even and the odd key tiles
constexpr int PAD = 8;    // bf16 of row padding (16 bytes): conflict-free ldmatrix
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr size_t smem_bytes() {
  // the Q tile, then K and V tiles of [2 stages][2 groups]
  return sizeof(__nv_bfloat16) * (size_t)(BQ + 8 * BK) * (D + PAD);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; a source size of 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (relative error ~2^-22; P is rounded
// to bf16 right after)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> two bf16 in one register (lo in the low half); the floats
// are replaced by their rounded values
__device__ __forceinline__ uint32_t pack_bf16(float& lo, float& hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  lo = __low2float(v);
  hi = __high2float(v);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ROWS rows of [rows][D] bf16 from global (row stride `stride`, rows from
// row0, zero past S) into shared memory, rows padded to D + PAD.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0, int S) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8, pos = row0 + r;
    const bool in = pos < S;
    cp_async_16(smem_addr(dst + r * (D + PAD) + c),
                src + (long long)(in ? pos : 0) * stride + c, in);
  }
}

// grid = ceil(S / BQ) * H * B blocks, 1-D, heaviest q tiles first;
// block = NT threads: two groups of 4 warps over the same 64 query rows
// (16 a warp), group 0 on the even key tiles of the band and group 1 on
// the odd ones, merged at the end (max, rescale, sum).
template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, int S, int H, int B,
                      int q_per_kv, Strides qs, Strides ks, Strides vs,
                      int causal, int window, float scale, float softcap) {
  constexpr int RS = D + PAD;       // shared row stride, elements
  constexpr int TILE = BK * RS;
  constexpr int KSTEPS = D / 16;    // k-steps of Q.K^T
  constexpr int NTILES = D / 8;     // n-tiles of the output
  constexpr int NB = BK / 8;        // 8-key blocks of a tile
  static_assert(D <= 128, "head dim 256 takes the wgmma kernel below");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * RS;       // [stage][group][BK][RS]
  __nv_bfloat16* Vs = Ks + 4 * TILE;      // [stage][group][BK][RS]

  const int nq = (S + BQ - 1) / BQ;
  const int hb = blockIdx.x % (H * B);
  const int q0 = (nq - 1 - (int)(blockIdx.x / (H * B))) * BQ;
  const int h = hb % H, b = hb / H;
  const int tid = threadIdx.x, grp = tid / GT, gt = tid % GT;
  const int warp = gt / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;    // mma fragment row / column pair
  const int row0 = q0 + warp * 16 + g;      // and row0 + 8
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + (long long)(h / q_per_kv) * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + (long long)(h / q_per_kv) * vs.h;

  // keys this q tile can see: the causal edge on the right, the window on
  // the left (rounded down to a tile boundary)
  const int k_end = causal ? min(q0 + BQ, S) : S;
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / BK) * BK : 0;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;
  const int n_pairs = (n_tiles + 1) / 2;
  const float scale_log2 = scale * LOG2E;
  // tile i of the band goes to stage (i / 2) % 2, group i % 2
  auto load_kv = [&](int i) {
    const int slot = ((i / 2) % 2) * 2 + i % 2;
    load_tile<D, BK>(Ks + slot * TILE, kb, ks.s, k_begin + i * BK, S);
    load_tile<D, BK>(Vs + slot * TILE, vb, vs.s, k_begin + i * BK, S);
  };

  load_tile<D, BQ>(Qs, qb, qs.s, q0, S);
  load_kv(0);
  if (n_tiles > 1) load_kv(1);
  cp_async_commit();

  uint32_t qf[KSTEPS][4];
  float acc[NTILES][4];
#pragma unroll
  for (int n = 0; n < NTILES; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};   // rows g and g + 8, log2 units
  float l_run[2] = {0.f, 0.f};               // this thread's columns only

  for (int pr = 0; pr < n_pairs; ++pr) {
    if (pr + 1 < n_pairs) {     // the next pair streams in behind this one
      load_kv(2 * pr + 2);
      if (2 * pr + 3 < n_tiles) load_kv(2 * pr + 3);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (pr == 0) {              // the warp's Q rows, held for every tile
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldmatrix_x4(qf[kk], smem_addr(Qs + (warp * 16 + lane % 16) * RS +
                                      kk * 16 + (lane / 16) * 8));
    }
    const int tile = 2 * pr + grp;
    if (tile < n_tiles) {
      const int k0 = k_begin + tile * BK;
      const __nv_bfloat16* Kt = Ks + ((pr % 2) * 2 + grp) * TILE;
      const __nv_bfloat16* Vt = Vs + ((pr % 2) * 2 + grp) * TILE;

      // scores: s[j] is the 16 x 8 block of keys 8j..8j+7
      float s[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t qa[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
#pragma unroll
        for (int jp = 0; jp < NB / 2; ++jp) {
          uint32_t bk[4];
          ldmatrix_x4(bk, smem_addr(Kt +
                                    (jp * 16 + lane % 8 + (lane / 16) * 8) *
                                        RS +
                                    kk * 16 + ((lane / 8) % 2) * 8));
          mma_16816(s[2 * jp], qa, bk[0], bk[1]);
          mma_16816(s[2 * jp + 1], qa, bk[2], bk[3]);
        }
      }

      // scale, cap, mask (only tiles crossing S, the diagonal or the
      // window edge), in log2 units; then the online softmax per row
      const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0) ||
                        (window > 0 && q0 + BQ - 1 - k0 >= window);
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = softcap > 0.f
                        ? softcap * LOG2E * tanhf(s[j][e] * scale / softcap)
                        : s[j][e] * scale_log2;
          if (edge) {
            const int kpos = k0 + 8 * j + 2 * tq + (e & 1);
            const int diff = row0 + (e >> 1) * 8 - kpos;
            bool ok = kpos < S;
            if (causal) ok = ok && diff >= 0;
            if (window > 0) ok = ok && diff < window;
            if (!ok) x = -INFINITY;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float base = mx[r] == -INFINITY ? 0.f : mx[r];  // all masked
        const float alpha = fast_exp2(m_run[r] - base);
        m_run[r] = mx[r];
        l_run[r] *= alpha;
#pragma unroll
        for (int n = 0; n < NTILES; ++n) {
          acc[n][2 * r] *= alpha;
          acc[n][2 * r + 1] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          s[j][2 * r] = fast_exp2(s[j][2 * r] - base);
          s[j][2 * r + 1] = fast_exp2(s[j][2 * r + 1] - base);
        }
      }

      // P rounded to bf16 in registers, straight into the A operand of P.V
      // (keys 16kk..16kk+15 are score blocks 2kk, 2kk + 1); the row sum
      // adds the rounded values
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float* sj = s[2 * kk + half];
          pa[2 * half] = pack_bf16(sj[0], sj[1]);
          pa[2 * half + 1] = pack_bf16(sj[2], sj[3]);
          l_run[0] += sj[0] + sj[1];
          l_run[1] += sj[2] + sj[3];
        }
#pragma unroll
        for (int np = 0; np < NTILES / 2; ++np) {
          uint32_t bv[4];
          ldmatrix_x4_trans(
              bv,
              smem_addr(Vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * RS +
                        np * 16 + (lane / 16) * 8));
          mma_16816(acc[2 * np], pa, bv[0], bv[1]);
          mma_16816(acc[2 * np + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage before refill
  }

  // merge the groups: group 1 hands its rows' max, sum and accumulator to
  // group 0 through shared memory (the K tiles, no longer read)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  float* x_acc = reinterpret_cast<float*>(Ks);   // [NTILES * 4][GT]
  float* x_ml = x_acc + NTILES * 4 * GT;         // [4][GT]: m, m, l, l
  if (grp == 1) {
#pragma unroll
    for (int n = 0; n < NTILES; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x_acc[(n * 4 + e) * GT + gt] = acc[n][e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      x_ml[r * GT + gt] = m_run[r];
      x_ml[(2 + r) * GT + gt] = l_run[r];
    }
  }
  __syncthreads();
  if (grp == 1) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = row0 + 8 * r;
    const float m1 = x_ml[r * GT + gt];
    const float mx = fmaxf(m_run[r], m1);
    const float base = mx == -INFINITY ? 0.f : mx;
    const float a0 = fast_exp2(m_run[r] - base);
    const float a1 = fast_exp2(m1 - base);
    const float l_div =
        fmaxf(l_run[r] * a0 + x_ml[(2 + r) * GT + gt] * a1, 1e-30f);
    if (pos >= S) continue;
    __nv_bfloat16* orow = o + (((long long)b * S + pos) * H + h) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < NTILES; ++n) {
      const int x = (n * 4 + 2 * r) * GT + gt;
      const float o0 = acc[n][2 * r] * a0 + x_acc[x] * a1;
      const float o1 = acc[n][2 * r + 1] * a0 + x_acc[x + GT] * a1;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(o0 / l_div, o1 / l_div);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, Strides qs, Strides ks, Strides vs, int causal,
           int window, float scale, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((S + BQ - 1) / BQ) * H * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_fwd_bf16_kernel<D><<<(unsigned)blocks, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      H, B, H / KV, qs, ks, vs, causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// bf16 at head dim 256: wgmma, TMA, the key band split over a cluster
// ---------------------------------------------------------------------------

namespace hop {

constexpr int D = 256;
constexpr int BQ = 64;                 // query rows of a tile: wgmma's m64
constexpr int BK = 64;                 // keys of a tile
constexpr int NT = 128;                // one warpgroup a block
constexpr int MAX_CLUSTER = 8;         // blocks a cluster (portable limit)
constexpr uint32_t BOX = 64 * 128;     // a TMA box: 64 rows of 64 bf16
constexpr uint32_t TILE = 4 * BOX;     // 64 rows x 256 as 4 column boxes
constexpr uint32_t OFF_K = TILE;       // Q, K, V tiles
constexpr uint32_t OFF_V = 2 * TILE;
constexpr uint32_t OFF_BAR = 3 * TILE; // mbarriers: Q, K (a box each), V
constexpr uint32_t OFF_ML = OFF_V;     // the merge's (m, l) slots, over V
constexpr uint32_t SMEM = OFF_BAR + 128 + 1024;  // + 1 KB to align
constexpr float LOG2E = 1.4426950408889634f;
// the merge's O slots ([C][32 / C][NT] float4 = 64 KB) cover Q and K, its
// (m, l) slots ([C][BQ] float2) the start of V
static_assert(32 * NT * 16 <= OFF_ML &&
                  OFF_ML + MAX_CLUSTER * BQ * 8 <= OFF_BAR,
              "the merge slots fit the tiles");

using tc::fast_exp2;
using tc::pack_bf16;
using tc::smem_addr;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nadd.u32 n, n, 1;\nsetp.lt.u32 p, n, 4000000;\n"
      "@p bra WAIT;\ntrap;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box of a 4-d tensor map (coordinates innermost first) into shared
// memory; its bytes complete on the mbarrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// a wgmma shared-memory operand, 128-byte swizzle: start address, leading
// and stride byte offsets
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// registers an in-flight wgmma reads or writes: no use moves across this
template <typename R, int N>
__device__ __forceinline__ void hold(R (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same<R, float>::value)
      asm volatile("" : "+f"(r[i])::"memory");
    else
      asm volatile("" : "+r"(r[i])::"memory");
  }
}

#define WG8(d, i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64 f32) = (accumulate ? d : 0) + A (64 x 16) . B (16 x 64)^T,
// both from shared memory, K-major
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG8(d, 0), WG8(d, 8), WG8(d, 16), WG8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 256 f32) += A (64 x 16, registers) . B (16 x 256, shared
// memory, MN-major)
__device__ __forceinline__ void wgmma_pv(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WG8(d, 0), WG8(d, 8), WG8(d, 16), WG8(d, 24), WG8(d, 32), WG8(d, 40),
        WG8(d, 48), WG8(d, 56), WG8(d, 64), WG8(d, 72), WG8(d, 80),
        WG8(d, 88), WG8(d, 96), WG8(d, 104), WG8(d, 112), WG8(d, 120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG8

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every block of the cluster; orders shared-memory writes
// before the barrier with reads after it, across the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of the same shared-memory location in block `rank`
__device__ __forceinline__ uint32_t at_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
// stores into another block's shared memory (cluster addresses)
__device__ __forceinline__ void st_cluster4(uint32_t addr, float a, float b,
                                            float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}
__device__ __forceinline__ void st_cluster2(uint32_t addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
               "f"(a), "f"(b)
               : "memory");
}

// The epilogue of a block. C = 1: O / max(l, 1e-30) straight from the
// registers. C > 1, the merge: rank d of the cluster writes column blocks
// [d NL, d NL + NL), NL = 32 / C. Once the cluster's barrier says every
// block is past its loop (its tiles free), every busy block (rank <
// n_busy) stores to each rank d its (O, m, l) for d's columns, into slot
// `rank` of d's shared memory, O in the accumulator layout (a float4 a
// thread and column block: rows row0 and row0 + 8). After a second barrier
// each block sums the slots in rank order with weights 2^(m_r - max m) and
// scales the sum by 1 / max(l, 1e-30).
template <int C>
__device__ __forceinline__ void epilogue(
    const float (&acc)[128], const float (&m)[2], const float (&l)[2],
    uint32_t base, const unsigned char* tiles, uint32_t rank, int n_busy,
    __nv_bfloat16* const (&orow)[2], const bool (&in)[2]) {
  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4;
  if constexpr (C == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      if (!in[r]) continue;
#pragma unroll
      for (int n = 0; n < 32; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow[r] + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n + 2 * r] * inv,
                                  acc[4 * n + 2 * r + 1] * inv);
    }
  } else {
    constexpr int NL = 32 / C;
    cluster_sync();
    if ((int)rank < n_busy) {
#pragma unroll
      for (int n = 0; n < 32; ++n) {
        const uint32_t slot = (rank * NL + n % NL) * NT + tid;
        st_cluster4(at_rank(base + slot * 16, n / NL), acc[4 * n],
                    acc[4 * n + 1], acc[4 * n + 2], acc[4 * n + 3]);
      }
      if (tid % 4 == 0) {
#pragma unroll
        for (int d = 0; d < C; ++d)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            st_cluster2(at_rank(base + OFF_ML +
                                    (rank * BQ + warp * 16 + g + 8 * r) * 8,
                                d),
                        m[r], l[r]);
      }
    }
    cluster_sync();
    const float2* ml = reinterpret_cast<const float2*>(tiles + OFF_ML);
    const float4* slots = reinterpret_cast<const float4*>(tiles);
    float w[C][2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (c < n_busy) mx = fmaxf(mx, ml[c * BQ + row].x);
      const float mb = mx == -INFINITY ? 0.f : mx;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        w[c][r] = 0.f;
        if (c < n_busy) {
          const float2 x = ml[c * BQ + row];
          w[c][r] = fast_exp2(x.x - mb);
          sum += w[c][r] * x.y;
        }
      }
      inv[r] = 1.f / fmaxf(sum, 1e-30f);
    }
#pragma unroll
    for (int nl = 0; nl < NL; ++nl) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < n_busy) {
          const float4 x = slots[(c * NL + nl) * NT + tid];
          a.x = fmaf(w[c][0], x.x, a.x);
          a.y = fmaf(w[c][0], x.y, a.y);
          a.z = fmaf(w[c][1], x.z, a.z);
          a.w = fmaf(w[c][1], x.w, a.w);
        }
      }
      const int n = (int)rank * NL + nl;
      if (in[0])
        *reinterpret_cast<__nv_bfloat162*>(orow[0] + 8 * n) =
            __floats2bfloat162_rn(a.x * inv[0], a.y * inv[0]);
      if (in[1])
        *reinterpret_cast<__nv_bfloat162*>(orow[1] + 8 * n) =
            __floats2bfloat162_rn(a.z * inv[1], a.w * inv[1]);
    }
  }
}

// grid = (q tiles x H x B) clusters of C blocks, 1-D, the heaviest q tiles
// (the last, under causal masking) first; block = one warpgroup, two blocks
// an SM. The block of cluster rank r takes key tiles [r T, r T + T) of its
// q tile's band (kernels/flash_attention.split_plan plans C and T); a block
// past the band holds an empty partial (m = -inf, l = 0, O = 0).
__global__ void __launch_bounds__(NT, 2)
flash_d256_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        __nv_bfloat16* __restrict__ o, int S, int H, int B,
                        int q_per_kv, int causal, int window, float scale,
                        float softcap, int T) {
  extern __shared__ __align__(1024) unsigned char smem_tma[];
  const uint32_t raw = smem_addr(smem_tma);
  const uint32_t base = (raw + 1023) & ~1023u;   // 128-byte swizzle atoms
  const uint32_t C = cluster_size(), rank = cluster_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq4 = lane % 4;   // accumulator row / column pair
  const int nq = (S + BQ - 1) / BQ;
  const int cid = blockIdx.x / C;
  const int hb = cid % (H * B);
  const int q0 = (nq - 1 - cid / (H * B)) * BQ;
  const int h = hb % H, b = hb / H, kvh = h / q_per_kv;
  const int row0 = q0 + warp * 16 + g;      // and row0 + 8

  // keys this q tile can see: the causal edge on the right, the window on
  // the left (rounded down to a tile boundary); this block's share of them
  const int k_end = causal ? min(q0 + BQ, S) : S;
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / BK) * BK : 0;
  const int n_band = (k_end - k_begin + BK - 1) / BK;
  const int t0 = (int)rank * T;
  const int n_mine = max(0, min(n_band - t0, T));

  // Q's and K's column boxes each complete on their own barrier, so the
  // first products start on the first boxes to land; V's on one
  const uint32_t qbar = base + OFF_BAR, kbar = qbar + 32, vbar = qbar + 64;
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < 9; ++c) mbar_init(qbar + 8 * c, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the K tile of share tile i (with the first, Q), box by box, and the V
  // tile, by thread 0
  auto load_k = [&](int i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (i == 0) {
        mbar_expect_tx(qbar + 8 * c, BOX);
        tma_load(base + c * BOX, &tq, qbar + 8 * c, c * 64, q0, h, b);
      }
      mbar_expect_tx(kbar + 8 * c, BOX);
      tma_load(base + OFF_K + c * BOX, &tk, kbar + 8 * c, c * 64,
               k_begin + (t0 + i) * BK, kvh, b);
    }
  };
  auto load_v = [&](int i) {
    mbar_expect_tx(vbar, TILE);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      tma_load(base + OFF_V + c * BOX, &tv, vbar, c * 64,
               k_begin + (t0 + i) * BK, kvh, b);
  };
  if (tid == 0 && n_mine > 0) {
    load_k(0);
    load_v(0);
  }

  float acc[128];   // O: columns 8n .. 8n + 7 in acc[4n .. 4n + 3]
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};   // rows row0, row0 + 8; log2
  float l_run[2] = {0.f, 0.f};               // this thread's columns only
  const float scale_log2 = scale * LOG2E;

  for (int i = 0; i < n_mine; ++i) {
    const int k0 = k_begin + (t0 + i) * BK;

    // scores: keys 8j .. 8j + 7 in s[4j .. 4j + 3]; 16 k-steps of 16
    // columns, 4 in each 128-byte box
    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      if (kk % 4 == 0) {   // the next column box of Q and K has landed
        if (i == 0) mbar_wait(qbar + 8 * (kk / 4), 0);
        mbar_wait(kbar + 8 * (kk / 4), i & 1);
      }
      const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
      wgmma_qk(s, desc(base + off, 16, 1024),
               desc(base + OFF_K + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait();
    hold(s);
    __syncthreads();   // K is read: the next tile's K streams in behind
    if (tid == 0 && i + 1 < n_mine) load_k(i + 1);

    // scale and cap in log2 units; mask only tiles that cross S, the
    // diagonal or the window's edge: key column c of row r passes when
    // lo_r <= c <= hi_r; then the online softmax per row
    if (softcap > 0.f) {
      const float cap = softcap * LOG2E, arg = scale / softcap;
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = cap * tanhf(s[j] * arg);
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] *= scale_log2;
    }
    if (k0 + BK > S || (causal && k0 + BK - 1 > q0) ||
        (window > 0 && q0 + BQ - 1 - k0 >= window)) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rel = row0 + 8 * r - k0 - 2 * tq4;   // the diagonal's c
        const int hi = min(S - 1 - k0 - 2 * tq4, causal ? rel : BK);
        const int lo = window > 0 ? rel - window + 1 : -BK;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (8 * j + e > hi || 8 * j + e < lo)
              s[4 * j + 2 * r + e] = -INFINITY;
          }
        }
      }
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < 32; ++j)
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float base_r = mx[r] == -INFINITY ? 0.f : mx[r];  // all masked
      if (i > 0) {   // (O and l are still 0 at the first tile)
        const float alpha = fast_exp2(m_run[r] - base_r);
        l_run[r] *= alpha;
#pragma unroll
        for (int n = 0; n < 32; ++n) {
          acc[4 * n + 2 * r] *= alpha;
          acc[4 * n + 2 * r + 1] *= alpha;
        }
      }
      m_run[r] = mx[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[4 * j + 2 * r] = fast_exp2(s[4 * j + 2 * r] - base_r);
        s[4 * j + 2 * r + 1] = fast_exp2(s[4 * j + 2 * r + 1] - base_r);
      }
    }

    // P rounded to bf16 in registers: the A operand of P.V, k-step kk
    // holding keys 16kk .. 16kk + 15 (score blocks 2kk, 2kk + 1); the row
    // sum adds the rounded values
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 4 * (2 * kk + half);
        pa[kk][2 * half] = pack_bf16(s[j], s[j + 1]);
        pa[kk][2 * half + 1] = pack_bf16(s[j + 2], s[j + 3]);
        l_run[0] += s[j] + s[j + 1];
        l_run[1] += s[j + 2] + s[j + 3];
      }
    }
    // O += P V: V's rows 16kk .. 16kk + 15 of every column box (the boxes
    // 8 KB apart, 8-row groups 1 KB apart)
    mbar_wait(vbar, i & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv(acc, pa[kk], desc(base + OFF_V + kk * 2048, BOX, 1024));
    wg_commit();
    wg_wait();
    hold(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hold(pa[kk]);
    __syncthreads();   // V is read: the next tile's V streams in behind
    if (tid == 0 && i + 1 < n_mine) load_v(i + 1);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  __nv_bfloat16* const orow[2] = {
      o + (((long long)b * S + row0) * H + h) * D + 2 * tq4,
      o + (((long long)b * S + row0 + 8) * H + h) * D + 2 * tq4};
  const bool in[2] = {row0 < S, row0 + 8 < S};
  // the ranks whose share of the band is not empty
  const int n_busy = min((int)C, (n_band + T - 1) / T);
  const unsigned char* tiles = smem_tma + (base - raw);
#define FLASH_EPILOGUE(c) \
  epilogue<c>(acc, m_run, l_run, base, tiles, rank, n_busy, orow, in)
  switch (C) {
    case 1: FLASH_EPILOGUE(1); break;
    case 2: FLASH_EPILOGUE(2); break;
    case 4: FLASH_EPILOGUE(4); break;
    default: FLASH_EPILOGUE(8); break;
  }
#undef FLASH_EPILOGUE
}

// codes past the CUDA runtime's: cuTensorMapEncodeTiled not found, or
// refused (ERR_TMAP + its CUresult)
constexpr int ERR_ENTRY = 1 << 20;
constexpr int ERR_TMAP = 1 << 21;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime (no -lcuda at link)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [B, S, heads, 256] bf16 tensor read through its strides, in boxes of
// 64 rows x 64 columns with 128-byte swizzle; rows past S read as zeros
int tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
               Strides st) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_ENTRY;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, BK, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TMAP + (int)r;
}

int set_attributes() {
  cudaError_t e = cudaFuncSetAttribute(
      flash_d256_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e == cudaSuccess)   // two blocks an SM: the largest shared carveout
    e = cudaFuncSetAttribute(flash_d256_wgmma_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  return (int)e;
}

cudaLaunchConfig_t config(long long blocks, int clusters, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = clusters;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

int capacity(int clusters, int* out) {
  if (clusters < 1 || clusters > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  const int err = set_attributes();
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(clusters, clusters, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, flash_d256_wgmma_kernel,
                                             &cfg);
}

int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, Strides qs, Strides ks, Strides vs, int causal,
           int window, float scale, float softcap, int clusters, int tiles,
           cudaStream_t stream) {
  if (clusters < 1 || clusters > MAX_CLUSTER || (clusters & (clusters - 1)) ||
      tiles < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int err = tensor_map(&mq, q, B, S, H, qs);
  if (!err) err = tensor_map(&mk, k, B, S, KV, ks);
  if (!err) err = tensor_map(&mv, v, B, S, KV, vs);
  if (err) return err;
  err = set_attributes();
  if (err) return err;
  const long long blocks =
      (long long)((S + BQ - 1) / BQ) * H * B * clusters;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(blocks, clusters, stream, &attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, flash_d256_wgmma_kernel, mq, mk, mv,
      static_cast<__nv_bfloat16*>(o), S, H, B, H / KV, causal, window, scale,
      softcap, tiles);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace hop

// f32: the SIMT kernel above; bf16: the mma.sync kernel up to D = 128, the
// wgmma kernel (split over `clusters` blocks of up to `tiles` key tiles) at
// D = 256
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, Strides qs, Strides ks, Strides vs, int causal,
           int window, float scale, float softcap, int clusters, int tiles,
           cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if constexpr (D == hop::D)
      return hop::launch(q, k, v, o, B, S, H, KV, qs, ks, vs, causal, window,
                         scale, softcap, clusters, tiles, stream);
    else
      return tc::launch<D>(q, k, v, o, B, S, H, KV, qs, ks, vs, causal,
                           window, scale, softcap, stream);
  } else {
    const size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S + BQ - 1) / BQ, H, B);
    flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), S, H, H / KV, qs, ks,
        vs, causal, window, scale, softcap);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int S, int H, int KV, Strides qs, Strides ks, Strides vs,
               int causal, int window, float scale, float softcap,
               int clusters, int tiles, cudaStream_t stream) {
#define FLASH_D(d)                                                          \
  case d:                                                                   \
    return launch<T, d>(q, k, v, o, B, S, H, KV, qs, ks, vs, causal, window, \
                        scale, softcap, clusters, tiles, stream);
  switch (D) {
    FLASH_D(16)
    FLASH_D(32)
    FLASH_D(64)
    FLASH_D(128)
    FLASH_D(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_D
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. clusters
// and tiles: the split of bf16 at D = 256 (split_plan in
// kernels/flash_attention.py); other calls ignore them.
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* o, int B, int S, int H, int KV,
                        int D, long long qsb, long long qss, long long qsh,
                        long long ksb, long long kss, long long ksh,
                        long long vsb, long long vss, long long vsh,
                        int causal, int window, float scale, float softcap,
                        int clusters, int tiles, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, B, S, H, KV, qs, ks, vs, causal,
                             window, scale, softcap, clusters, tiles, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, S, H, KV, qs, ks, vs,
                                     causal, window, scale, softcap, clusters,
                                     tiles, st);
  return (int)cudaErrorInvalidValue;
}

// the most clusters of `clusters` blocks of the head-dim-256 kernel the
// card runs at once, into *out
int flash_attention_cluster_capacity(int clusters, int* out) {
  return hop::capacity(clusters, out);
}

const char* flash_attention_error_string(int err) {
  static thread_local char msg[96];
  if (err == hop::ERR_ENTRY)
    return "cuTensorMapEncodeTiled not found (cudaGetDriverEntryPoint)";
  if (err >= hop::ERR_TMAP) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled refused the tensor "
             "map (CUresult %d)", err - hop::ERR_TMAP);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
