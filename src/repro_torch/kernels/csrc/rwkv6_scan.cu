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
// Design (simple first, as a first port): one block of 256 threads per
// (b, h) walks the chunks in order (backward: in reverse), with the state
// [D, D] f32 and the chunk's tiles in shared memory (rows padded to D + 1
// floats, so column walks hit distinct banks). Each step is a block-stride
// loop over independent items (score entries, (t, e) outputs, (d, e) state
// lanes, channels) between barriers, in f32 throughout. B * H blocks
// under-fill the 132 SMs at the training shape (64 blocks); splitting the
// state's columns over blocks is left for the PRs that make it fast.
//
// Forward: out [B, S, H, D] f32, optionally every chunk's incoming state
// states [B, H, n_chunks, D, D] f32 (saved for the backward) and the final
// state [B, H, D, D] f32. Backward: a reverse loop over the chunks carrying
// dS [D, D]; from dO, the saved incoming state and dS it forms dv, the
// score gradient, d ri, d kj, d k_dec, the bonus gradient, d a, then by
// the chain rule through the exponentials and the cumsum dr, dk and
// d log w (dw = d log w / w), and dS for the chunk before. du is summed
// per (b, h) and written to du_part [B, H, D]; the caller sums over B in a
// fixed order (no atomics anywhere, so the result is deterministic).
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

template <int D>
struct BwdSmem {
  static constexpr int P = D + 1, CP = kChunk * P;
  static constexpr int kR = 0, kK = kR + CP, kV = kK + CP, kW = kV + CP,
                       kA = kW + CP, kDo = kA + CP, kRi = kDo + CP,
                       kKj = kRi + CP, kKd = kKj + CP, kDri = kKd + CP,
                       kDkj = kDri + CP, kDkd = kDkj + CP, kS = kDkd + CP,
                       kDs = kS + D * P, kSc = kDs + D * P,
                       kDsc = kSc + kChunk * kChunk,
                       kBonus = kDsc + kChunk * kChunk,
                       kDbonus = kBonus + kChunk, kDecay = kDbonus + kChunk,
                       kDa = kDecay + D, kU = kDa + D, kDu = kU + D,
                       kTotal = kDu + D;
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, Strides sr, Strides sk,
                Strides sv, Strides sw, const float* __restrict__ dout,
                const float* __restrict__ dfinal,
                const float* __restrict__ states, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du_part, int H,
                int S) {
  using L = BwdSmem<D>;
  constexpr int P = L::P, C = kChunk;
  extern __shared__ float smem[];
  float* r_s = smem + L::kR;
  float* k_s = smem + L::kK;
  float* v_s = smem + L::kV;
  float* w_s = smem + L::kW;
  float* A_s = smem + L::kA;
  float* do_s = smem + L::kDo;
  float* ri = smem + L::kRi;
  float* kj = smem + L::kKj;
  float* kd = smem + L::kKd;
  float* dri = smem + L::kDri;
  float* dkj = smem + L::kDkj;
  float* dkd = smem + L::kDkd;
  float* S_s = smem + L::kS;
  float* dS_s = smem + L::kDs;
  float* sc = smem + L::kSc;
  float* dsc = smem + L::kDsc;
  float* bonus = smem + L::kBonus;
  float* dbonus = smem + L::kDbonus;
  float* decay = smem + L::kDecay;
  float* da = smem + L::kDa;
  float* u_s = smem + L::kU;
  float* du_s = smem + L::kDu;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nc = (S + C - 1) / C;
  for (int i = tid; i < D * D; i += nt)
    dS_s[(i / D) * P + i % D] =
        dfinal != nullptr ? dfinal[(long long)bh * D * D + i] : 0.0f;
  for (int d = tid; d < D; d += nt) {
    u_s[d] = u[h * D + d];
    du_s[d] = 0.0f;
  }

  for (int c = nc - 1; c >= 0; --c) {
    const int s0 = c * C;
    for (int i = tid; i < C * D; i += nt) {
      const int t = i / D, d = i % D, s = s0 + t;
      float rv = 0.0f, kv = 0.0f, vv = 0.0f, wv = 1.0f, gv = 0.0f;
      if (s < S) {
        rv = to_f32(r[at(sr, b, s, h) + d]);
        kv = to_f32(k[at(sk, b, s, h) + d]);
        vv = to_f32(v[at(sv, b, s, h) + d]);
        wv = w[at(sw, b, s, h) + d];
        gv = dout[(((long long)b * S + s) * H + h) * D + d];
      }
      r_s[t * P + d] = rv;
      k_s[t * P + d] = kv;
      v_s[t * P + d] = vv;
      w_s[t * P + d] = wv;
      A_s[t * P + d] = logf(fmaxf(wv, 1e-30f));
      do_s[t * P + d] = gv;
    }
    const float* src = states + ((long long)bh * nc + c) * D * D;
    for (int i = tid; i < D * D; i += nt) S_s[(i / D) * P + i % D] = src[i];
    __syncthreads();
    chunk_decays<D>(r_s, k_s, A_s, ri, kj, kd, decay);
    __syncthreads();
    // scores and their gradient dsc[t, j] = dO[t] . v[j] (j < t); the bonus
    // and its gradient; d a[d] = sum_e S[d, e] dS[d, e]
    for (int i = tid; i < C * C; i += nt) {
      const int t = i / C, j = i % C;
      float acc = 0.0f, grad = 0.0f;
      if (j < t) {
        for (int d = 0; d < D; ++d) acc += ri[t * P + d] * kj[j * P + d];
        for (int e = 0; e < D; ++e) grad += do_s[t * P + e] * v_s[j * P + e];
      }
      sc[i] = acc;
      dsc[i] = grad;
    }
    for (int t = tid; t < C; t += nt) {
      float acc = 0.0f, grad = 0.0f;
      for (int d = 0; d < D; ++d) {
        acc += r_s[t * P + d] * u_s[d] * k_s[t * P + d];
        grad += do_s[t * P + d] * v_s[t * P + d];
      }
      bonus[t] = acc;
      dbonus[t] = grad;
    }
    for (int d = tid; d < D; d += nt) {
      float acc = 0.0f;
      for (int e = 0; e < D; ++e) acc += S_s[d * P + e] * dS_s[d * P + e];
      da[d] = acc;
    }
    __syncthreads();
    // (t, d) items: d ri, d kj, d k_dec
    for (int i = tid; i < C * D; i += nt) {
      const int t = i / D, d = i % D;
      float g_ri = 0.0f, g_kj = 0.0f, g_kd = 0.0f;
      for (int j = 0; j < t; ++j) g_ri += dsc[t * C + j] * kj[j * P + d];
      for (int e = 0; e < D; ++e) {
        g_ri += do_s[t * P + e] * S_s[d * P + e];
        g_kd += v_s[t * P + e] * dS_s[d * P + e];
      }
      for (int q = t + 1; q < C; ++q) g_kj += dsc[q * C + t] * ri[q * P + d];
      dri[t * P + d] = g_ri;
      dkj[t * P + d] = g_kj;
      dkd[t * P + d] = g_kd;
    }
    // (t, e) items: dv = sc^T dO + bonus dO + k_dec dS
    for (int i = tid; i < C * D; i += nt) {
      const int t = i / D, e = i % D, s = s0 + t;
      float acc = 0.0f;
      for (int q = t + 1; q < C; ++q) acc += sc[q * C + t] * do_s[q * P + e];
      acc += bonus[t] * do_s[t * P + e];
      for (int d = 0; d < D; ++d) acc += kd[t * P + d] * dS_s[d * P + e];
      if (s < S) dv[(((long long)b * S + s) * H + h) * D + e] = acc;
    }
    __syncthreads();
    // dS for the chunk before: diag(a) dS + ri^T dO
    for (int i = tid; i < D * D; i += nt) {
      const int d = i / D, e = i % D;
      float acc = 0.0f;
      for (int t = 0; t < C; ++t) acc += ri[t * P + d] * do_s[t * P + e];
      dS_s[d * P + e] = decay[d] * dS_s[d * P + e] + acc;
    }
    // per channel: the chain through the exponentials and the cumsum
    for (int d = tid; d < D; d += nt) {
      const float a_last = A_s[(C - 1) * P + d];
      float g_last = da[d] * decay[d];
      for (int t = 0; t < C; ++t) g_last += dkd[t * P + d] * kd[t * P + d];
      const float ud = u_s[d];
      float suffix = 0.0f, du_acc = 0.0f;
      for (int t = C - 1; t >= 0; --t) {
        const int s = s0 + t;
        const float acc = A_s[t * P + d];
        const float wv = w_s[t * P + d];
        const float lw = logf(fmaxf(wv, 1e-30f));
        const float rt = r_s[t * P + d], kt = k_s[t * P + d];
        const float g_ri = dri[t * P + d], g_kj = dkj[t * P + d],
                    g_kd = dkd[t * P + d], g_b = dbonus[t];
        const float g_ex = g_ri * ri[t * P + d];
        suffix += g_ex - g_kj * kj[t * P + d] - g_kd * kd[t * P + d];
        const float g_lw = suffix - g_ex + g_last;
        du_acc += g_b * rt * kt;
        if (s < S) {
          const long long o = (((long long)b * S + s) * H + h) * D + d;
          dr[o] = g_ri * expf(acc - lw) + g_b * ud * kt;
          dk[o] = g_kj * expf(-acc) + g_kd * expf(a_last - acc) +
                  g_b * ud * rt;
          dw[o] = wv > 1e-30f ? g_lw / wv : 0.0f;
        }
      }
      du_s[d] += du_acc;
    }
    __syncthreads();
  }
  for (int d = tid; d < D; d += nt) du_part[(long long)bh * D + d] = du_s[d];
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
        const void* dfinal, const void* states, void* dr, void* dk, void* dv,
        void* dw, void* du_part, int B, int S, int H, cudaStream_t stream) {
  const size_t smem = BwdSmem<D>::kTotal * sizeof(float);
  auto kernel = wkv6_bwd_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), strides_of(st, 0), strides_of(st, 1),
      strides_of(st, 2), strides_of(st, 3), static_cast<const float*>(dout),
      static_cast<const float*>(dfinal), static_cast<const float*>(states),
      static_cast<float*>(dr), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(dw),
      static_cast<float*>(du_part), H, S);
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
          const void* dfinal, const void* states, void* dr, void* dk,
          void* dv, void* dw, void* du_part, int B, int S, int H,
          cudaStream_t s) {
  switch (D) {
    case 16: return bwd<T, 16>(r, k, v, w, u, st, dout, dfinal, states, dr, dk, dv, dw, du_part, B, S, H, s);
    case 32: return bwd<T, 32>(r, k, v, w, u, st, dout, dfinal, states, dr, dk, dv, dw, du_part, B, S, H, s);
    case 64: return bwd<T, 64>(r, k, v, w, u, st, dout, dfinal, states, dr, dk, dv, dw, du_part, B, S, H, s);
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

// dout: [B, S, H, D] f32 contiguous; dfinal: [B, H, D, D] f32 or null
// (zero); states: the forward's; dr/dk/dv/dw: [B, S, H, D] f32; du_part:
// [B, H, D] f32.
int wkv6_bwd(int dtype, const void* r, const void* k, const void* v,
             const void* w, const void* u, const long long* strides,
             const void* dout, const void* dfinal, const void* states,
             void* dr, void* dk, void* dv, void* dw, void* du_part, int B,
             int S, int H, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_d<float>(D, r, k, v, w, u, strides, dout, dfinal, states, dr,
                        dk, dv, dw, du_part, B, S, H, s);
  if (dtype == 1)
    return bwd_d<__nv_bfloat16>(D, r, k, v, w, u, strides, dout, dfinal,
                                states, dr, dk, dv, dw, du_part, B, S, H, s);
  return (int)cudaErrorInvalidValue;
}

const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
