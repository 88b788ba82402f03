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
// Two kernels, one per input type.
//
// bf16 (the serve path's type): tensor cores. At the serve run's prefill
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
// Head dim 256 (gemma3-1b) takes a variant of the same kernel: the double-
// buffered ring of [2 stages][2 groups] K/V tiles would need 304,128 B of
// shared memory, over the 232,448 B a block may take, so D = 256 keeps one
// stage (168,960 B: the next pair's copies wait for this pair's mma), and
// it reloads each k-step's Q fragments from the resident Q tile by ldmatrix
// instead of holding all D / 16 of them, which leaves the registers to the
// D / 8 x 4 f32 accumulators (the register count and spills are printed
// by chip_smoke.py's phase 25).
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
// pointers and the stream as void*, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// K/V ring stages: two (prefetch the next pair of tiles) up to D = 128,
// one at D = 256, where two would not fit a block's shared memory
template <int D>
__host__ __device__ constexpr int stages() { return D > 128 ? 1 : 2; }

template <int D>
constexpr size_t smem_bytes() {
  // the Q tile, then K and V tiles of [stages][2 groups]
  return sizeof(__nv_bfloat16) * (size_t)(BQ + 4 * stages<D>() * BK) *
         (D + PAD);
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
  constexpr int ST = stages<D>();   // K/V ring stages
  constexpr bool HOLD_Q = D <= 128; // Q fragments in registers for all tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * RS;       // [stage][group][BK][RS]
  __nv_bfloat16* Vs = Ks + 2 * ST * TILE; // [stage][group][BK][RS]

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
  // tile i of the band goes to stage (i / 2) % ST, group i % 2
  auto load_kv = [&](int i) {
    const int slot = ((i / 2) % ST) * 2 + i % 2;
    load_tile<D, BK>(Ks + slot * TILE, kb, ks.s, k_begin + i * BK, S);
    load_tile<D, BK>(Vs + slot * TILE, vb, vs.s, k_begin + i * BK, S);
  };

  load_tile<D, BQ>(Qs, qb, qs.s, q0, S);
  load_kv(0);
  if (n_tiles > 1) load_kv(1);
  cp_async_commit();

  uint32_t qf[HOLD_Q ? KSTEPS : 1][4];
  // the warp's Q fragment of k-step kk, from the resident Q tile
  auto load_q = [&](int kk, uint32_t(&r)[4]) {
    ldmatrix_x4(r, smem_addr(Qs + (warp * 16 + lane % 16) * RS + kk * 16 +
                             (lane / 16) * 8));
  };
  float acc[NTILES][4];
#pragma unroll
  for (int n = 0; n < NTILES; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};   // rows g and g + 8, log2 units
  float l_run[2] = {0.f, 0.f};               // this thread's columns only

  for (int pr = 0; pr < n_pairs; ++pr) {
    if constexpr (ST == 2) {
      if (pr + 1 < n_pairs) {   // the next pair streams in behind this one
        load_kv(2 * pr + 2);
        if (2 * pr + 3 < n_tiles) load_kv(2 * pr + 3);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {                    // one stage: this pair, after the last
      if (pr > 0) {             // pair's readers (the loop's end barrier)
        load_kv(2 * pr);
        if (2 * pr + 1 < n_tiles) load_kv(2 * pr + 1);
      }
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (HOLD_Q) {
      if (pr == 0) {            // the warp's Q rows, held for every tile
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) load_q(kk, qf[kk]);
      }
    }
    const int tile = 2 * pr + grp;
    if (tile < n_tiles) {
      const int k0 = k_begin + tile * BK;
      const __nv_bfloat16* Kt = Ks + ((pr % ST) * 2 + grp) * TILE;
      const __nv_bfloat16* Vt = Vs + ((pr % ST) * 2 + grp) * TILE;

      // scores: s[j] is the 16 x 8 block of keys 8j..8j+7
      float s[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t qa[4];
        if constexpr (HOLD_Q) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
        } else {
          load_q(kk, qa);
        }
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
  // group 0 through shared memory (the K tiles, no longer read; at D = 256
  // the one stage's K tiles hold exactly the 67,584 bytes)
  static_assert((D / 8) * 4 * GT * 4 + 4 * GT * 4 <=
                    2 * ST * BK * (D + PAD) * 2,
                "the merge buffer fits the K tiles");
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

// f32: the SIMT kernel above; bf16: the tensor-core kernel
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, Strides qs, Strides ks, Strides vs, int causal,
           int window, float scale, float softcap, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return tc::launch<D>(q, k, v, o, B, S, H, KV, qs, ks, vs, causal, window,
                         scale, softcap, stream);
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
    case 256:
      return launch<T, 256>(q, k, v, o, B, S, H, KV, qs, ks, vs, causal,
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
