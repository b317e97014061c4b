// Flash attention, forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/kernels/pallas_attention.py:
//   - _fwd_kernel (:127), reached without LSE through mha (:775, the
//     pallas_call at :250) and with LSE through mha_with_lse (:800) and
//     the custom VJP's forward _mha_folded_fwd (:667, the pallas_call at
//     :263): fwd_kernel, with the LSE store optional;
//   - _bwd_dq_kernel (:283, pallas_call :550), the dq pass of the two-pass
//     backward: dq_kernel;
//   - _bwd_dkv_kernel (:348, pallas_call :628), its dk/dv pass: dkv_kernel
//     with FUSED = false;
//   - _bwd_fused_kernel (:435, pallas_call :595), the one-pass backward
//     that also writes float32 dq partials: dkv_kernel with FUSED = true.
//
// Layout: q, o, do, dq [b, sq, hq, d]; k, v, dk, dv [b, sk, hk, d]; lse
// and delta [b, hq, sq] float32; segment ids [b, sq] and [b, sk] int32. A
// query head h reads kv head h / (hq / hk): K/V are never repeated in
// memory for grouped-query attention.
//
// What it computes, as the TPU kernels do: s = (q . k) * scale with
// float32 accumulation; masked entries take -1e30 (causal: key j is
// visible to query i iff j <= i + sk - sq, the bottom-right alignment of
// the dense reference; sliding window: also i + sk - sq - j < window;
// segments: equal ids); an online softmax in float32 with p rounded to
// v's dtype before the product with V; o = acc / l with l = 0 read as 1;
// lse = m + log(l). Backward: p = exp(s - lse), dp = do . v,
// ds = p * (dp - delta) * scale rounded to the input dtype, dq = ds k,
// dk = ds^T q, dv = p^T do (p rounded to the input dtype), all with
// float32 accumulation; delta = rowsum(do * o) - dlse comes from the
// caller. A query row that sees no key at all is not defined (the dense
// reference averages every value, the kernel averages the keys of the
// tiles it visits or gives zeros).
//
// What bounds it: at the Llama-2-7B train shape (b 4, s 2048, 32 heads,
// d 128, causal, bf16) the tensor cores: 4 * b * h * s^2 / 2 * d
// operations forward (137 GFLOP, 0.139 ms at 989 TFLOP/s) against 268 MB
// of q, k, v and o (0.080 ms at 3.35 TB/s); the fused backward does 2.5x
// the forward's products and the two-pass one 3.5x.
//
// Design (first version, simple and right): 128 threads per CTA; square
// tiles of B = 64 rows (32 when a padded row holds more than 256 bytes)
// staged in shared memory with the head dim zero-padded to DP = 64, 128 or
// 256. Products go through nvcuda::wmma 16x16x16 fragments with float32
// accumulators for 16-bit inputs, and a SIMT FMA loop for float32 inputs
// (tile_mma); accumulators live in shared memory, so the online-softmax
// rescale and the elementwise passes address them by row and column.
//   - fwd_kernel: one CTA per (batch, query head, q tile), heaviest causal
//     tiles first; walks the kv tiles that hold a visible key (causal stops
//     at the diagonal tile, a window starts at its first tile).
//   - dq_kernel: one CTA per (batch, query head, q tile); recomputes p from
//     lse over the same kv tiles and accumulates dq.
//   - dkv_kernel: one CTA per (batch, kv head, kv tile); loops over the
//     group's query heads and the q tiles that see the kv tile, the GQA sum
//     landing in the same dk/dv accumulators. FUSED: one CTA per (batch,
//     kv head, kv span of the JAX k block); it walks the span's kv tiles in
//     order and also accumulates ds k into the span's float32 dq partial
//     [span, b, sq_pad, hq, DP] in device memory, which it alone writes; the
//     caller sums the partials over spans in order.
// No atomics: every sum runs in a fixed order, so the backward is
// run-to-run identical.
//
// Later redesign: wgmma fed by TMA through a multi-stage shared-memory
// ring, accumulators in registers, warp specialisation.
//
// Built once per element type: compile with -DPT_FA_T=<type>
// -DPT_FA_TAG=<suffix>; the exported C functions are
// pt_flash_{fwd,bwd_dq,bwd_dkv,bwd_fused}_<suffix>. Each returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#ifndef PT_FA_T
#error "compile with -DPT_FA_T=<element type> -DPT_FA_TAG=<tag>"
#endif

#define PT_CAT2(a, b) a##b
#define PT_CAT(a, b) PT_CAT2(a, b)

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernel

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

constexpr size_t al128(size_t bytes) { return (bytes + 127) & ~size_t(127); }

// Tile geometry and shared-memory budget for element type T and padded
// head dim DP.
template <typename T, int DP>
struct Geo {
  static constexpr int B = sizeof(T) * DP <= 256 ? 64 : 32;  // tile rows
  static constexpr int LDT = DP + 8;  // q/k/v/do tiles, T
  static constexpr int LDF = DP + 4;  // [B, DP] float32 accumulators
  static constexpr int LDS = B + 4;   // [B, B] float32 score tiles
  static constexpr int LDP = B + 8;   // [B, B] T probability tiles
  static constexpr size_t kTile = al128(size_t(B) * LDT * sizeof(T));
  static constexpr size_t kAcc = al128(size_t(B) * LDF * 4);
  static constexpr size_t kScore = al128(size_t(B) * LDS * 4);
  static constexpr size_t kProb = al128(size_t(B) * LDP * sizeof(T));
  static constexpr size_t kRow = al128(size_t(B) * 4);
  // Q K V | S | P | O | m l | qseg kseg
  static constexpr size_t kFwd = 3 * kTile + kScore + kProb + kAcc + 4 * kRow;
  // Q dO K V | S dP | dS | dQ | lse delta | qseg kseg
  static constexpr size_t kDq =
      4 * kTile + 2 * kScore + kProb + kAcc + 4 * kRow;
  // K V Q dO | S dP | P dS | dK dV | lse delta | qseg kseg
  static constexpr size_t kDkv =
      4 * kTile + 2 * kScore + 2 * kProb + 2 * kAcc + 4 * kRow;
  static_assert(kDkv <= 232448, "shared memory over the per-block limit");
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  const int* qseg;
  const int* kseg;
  void* out0;   // fwd: o; dq: dq; dkv: dk; fused: dq partials (float32)
  void* out1;   // dkv and fused: dk (fused) or dv (dkv)
  void* out2;   // fused: dv
  float* lse;   // fwd: lse, or null
  int b, sq, sk, hq, hk, d, rep, causal, window, span, sq_pad;
  float scale;
};

__device__ __forceinline__ unsigned char* carve(unsigned char*& p,
                                                size_t bytes) {
  unsigned char* r = p;
  p += bytes;
  return r;
}

// C[M, N] (+)= A[M, K] B[K, N] over tiles in shared memory (C may be in
// device memory). A is row-major (A(m, k) = A[m * lda + k]) or column-
// major (A[k * lda + m]); B row-major (B[k * ldb + n]) or column-major
// (B[n * ldb + k]); C row-major float32. 16-bit T: wmma 16x16x16 with
// float32 accumulators, the warps splitting C's 16x16 tiles; float32 T:
// one FMA chain per element of C, in k order.
template <typename T, int M, int N, int K, bool A_ROW, bool B_ROW>
__device__ __forceinline__ void tile_mma(const T* A, int lda, const T* B,
                                         int ldb, float* C, int ldc,
                                         bool accumulate) {
  if constexpr (std::is_same<T, float>::value) {
    for (int e = threadIdx.x; e < M * N; e += kThreads) {
      const int m = e / N, n = e % N;
      float acc = accumulate ? C[static_cast<size_t>(m) * ldc + n] : 0.f;
      for (int kk = 0; kk < K; ++kk) {
        const float a = A_ROW ? A[m * lda + kk] : A[kk * lda + m];
        const float b = B_ROW ? B[kk * ldb + n] : B[n * ldb + kk];
        acc = fmaf(a, b, acc);
      }
      C[static_cast<size_t>(m) * ldc + n] = acc;
    }
  } else {
    using namespace nvcuda;
    using LA = typename std::conditional<A_ROW, wmma::row_major,
                                         wmma::col_major>::type;
    using LB = typename std::conditional<B_ROW, wmma::row_major,
                                         wmma::col_major>::type;
    constexpr int TN = N / 16;
    const int warp = threadIdx.x / 32;
    for (int t = warp; t < (M / 16) * TN; t += kWarps) {
      const int mi = t / TN, ni = t % TN;
      float* cp = C + static_cast<size_t>(mi) * 16 * ldc + ni * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (accumulate)
        wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(c, 0.f);
#pragma unroll 4
      for (int kk = 0; kk < K; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> b;
        wmma::load_matrix_sync(
            a, A_ROW ? A + mi * 16 * lda + kk : A + kk * lda + mi * 16, lda);
        wmma::load_matrix_sync(
            b, B_ROW ? B + kk * ldb + ni * 16 : B + ni * 16 * ldb + kk, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
    }
  }
}

// Rows [0, valid) of a [*, d] slice whose rows are `stride` elements
// apart, into a [B, LDT] tile; columns d..DP-1 and rows valid..B-1 become
// zeros. 16-byte vectors: d % 8 == 0 and a 16-byte aligned base.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          size_t stride, int valid, int d) {
  using G = Geo<T, DP>;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = DP / VEC;
  for (int e = threadIdx.x; e < G::B * VPR; e += kThreads) {
    const int r = e / VPR, c = (e % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid && c < d)
      val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * G::LDT + c) = val;
  }
}

// Whether key j is hidden from query i (both absolute positions), the
// segment ids already loaded for the tile's row r and column c.
__device__ __forceinline__ bool masked(const Args& a, int i, int j, int qs,
                                       int ks) {
  const int off = a.sk - a.sq;
  if (a.causal && j > i + off) return true;
  if (a.window && i + off - j >= a.window) return true;
  return a.qseg != nullptr && qs != ks;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) fwd_kernel(Args a) {
  using G = Geo<T, DP>;
  constexpr int B = G::B;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sp = smem;
  T* Qs = reinterpret_cast<T*>(carve(sp, G::kTile));
  T* Ks = reinterpret_cast<T*>(carve(sp, G::kTile));
  T* Vs = reinterpret_cast<T*>(carve(sp, G::kTile));
  float* S = reinterpret_cast<float*>(carve(sp, G::kScore));
  T* P = reinterpret_cast<T*>(carve(sp, G::kProb));
  float* O = reinterpret_cast<float*>(carve(sp, G::kAcc));
  float* m_s = reinterpret_cast<float*>(carve(sp, G::kRow));
  float* l_s = reinterpret_cast<float*>(carve(sp, G::kRow));
  int* qseg_s = reinterpret_cast<int*>(carve(sp, G::kRow));
  int* kseg_s = reinterpret_cast<int*>(carve(sp, G::kRow));

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int b = blockIdx.y / a.hq, h = blockIdx.y % a.hq;
  const int g = h / a.rep;
  const int q0 = qt * B;
  const int q_valid = min(B, a.sq - q0);
  const int off = a.sk - a.sq;
  int lo = 0, hi = a.sk;
  if (a.causal) hi = min(hi, q0 + q_valid + off);
  if (a.window) lo = max(0, q0 + off - a.window + 1);

  const size_t qrow = static_cast<size_t>(a.hq) * a.d;
  const size_t kvrow = static_cast<size_t>(a.hk) * a.d;
  const T* qp = static_cast<const T*>(a.q) +
                (static_cast<size_t>(b) * a.sq + q0) * qrow +
                static_cast<size_t>(h) * a.d;
  load_tile<T, DP>(Qs, qp, qrow, q_valid, a.d);
  for (int r = tid; r < B; r += kThreads) {
    qseg_s[r] = (a.qseg != nullptr && r < q_valid)
                    ? a.qseg[static_cast<size_t>(b) * a.sq + q0 + r]
                    : 0;
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  for (int e = tid; e < B * G::LDF; e += kThreads) O[e] = 0.f;

  for (int k0 = (lo / B) * B; k0 < hi; k0 += B) {
    __syncthreads();  // the previous tile's products are done with K, V, P
    const int k_valid = min(B, a.sk - k0);
    const size_t kofs = (static_cast<size_t>(b) * a.sk + k0) * kvrow +
                        static_cast<size_t>(g) * a.d;
    load_tile<T, DP>(Ks, static_cast<const T*>(a.k) + kofs, kvrow, k_valid,
                     a.d);
    load_tile<T, DP>(Vs, static_cast<const T*>(a.v) + kofs, kvrow, k_valid,
                     a.d);
    for (int c = tid; c < B; c += kThreads)
      kseg_s[c] = (a.kseg != nullptr && c < k_valid)
                      ? a.kseg[static_cast<size_t>(b) * a.sk + k0 + c]
                      : 0;
    __syncthreads();
    tile_mma<T, B, B, DP, true, false>(Qs, G::LDT, Ks, G::LDT, S, G::LDS,
                                       false);
    __syncthreads();
    // online softmax: a warp per row
    for (int r = warp; r < B; r += kWarps) {
      const int i = q0 + r;
      float sv[B / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < B / 32; ++t) {
        const int c = lane + 32 * t;
        float s = S[r * G::LDS + c] * a.scale;
        if (c >= k_valid)
          s = -INFINITY;  // past the sequence: no weight at all
        else if (masked(a, i, k0 + c, qseg_s[r], kseg_s[c]))
          s = kNegInf;
        sv[t] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < B / 32; ++t) {
        const float p = expf(sv[t] - m_new);
        P[r * G::LDP + lane + 32 * t] = from_f<T>(p);
        sum += p;
      }
      sum = warp_sum(sum);
      const float alpha = expf(m_prev - m_new);
      for (int c = lane; c < DP; c += 32) O[r * G::LDF + c] *= alpha;
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
      }
    }
    __syncthreads();
    tile_mma<T, B, DP, B, true, true>(P, G::LDP, Vs, G::LDT, O, G::LDF,
                                      true);
  }
  __syncthreads();

  T* op = static_cast<T*>(a.out0) +
          (static_cast<size_t>(b) * a.sq + q0) * qrow +
          static_cast<size_t>(h) * a.d;
  for (int e = tid; e < B * DP; e += kThreads) {
    const int r = e / DP, c = e % DP;
    if (r < q_valid && c < a.d) {
      const float l = l_s[r] == 0.f ? 1.f : l_s[r];
      op[r * qrow + c] = from_f<T>(O[r * G::LDF + c] / l);
    }
  }
  if (a.lse != nullptr) {
    float* lp = a.lse + (static_cast<size_t>(b) * a.hq + h) * a.sq + q0;
    for (int r = tid; r < q_valid; r += kThreads) {
      const float l = l_s[r] == 0.f ? 1.f : l_s[r];
      lp[r] = m_s[r] + logf(l);
    }
  }
}

// Rows of a q tile that the backward passes read beside Q and dO: lse
// (+inf past the sequence, so p = 0 there), delta and the segment ids.
template <typename T, int DP>
__device__ __forceinline__ void load_q_rows(const Args& a, int b, int h,
                                            int q0, int q_valid, float* lse_s,
                                            float* delta_s, int* qseg_s) {
  constexpr int B = Geo<T, DP>::B;
  const size_t row = (static_cast<size_t>(b) * a.hq + h) * a.sq + q0;
  for (int r = threadIdx.x; r < B; r += kThreads) {
    const bool ok = r < q_valid;
    lse_s[r] = ok ? a.lse_in[row + r] : INFINITY;
    delta_s[r] = ok ? a.delta[row + r] : 0.f;
    qseg_s[r] = (a.qseg != nullptr && ok)
                    ? a.qseg[static_cast<size_t>(b) * a.sq + q0 + r]
                    : 0;
  }
}

// p and ds of one [B, B] tile from the scores S and dP = dO V^T:
// p = exp(s - lse), ds = p * (dp - delta) * scale, both rounded to T.
// P may be null (the dq pass needs ds only).
template <typename T, int DP>
__device__ __forceinline__ void p_and_ds(const Args& a, int q0, int k0,
                                         int k_valid, const float* S,
                                         const float* dP, const float* lse_s,
                                         const float* delta_s,
                                         const int* qseg_s,
                                         const int* kseg_s, T* P, T* dS) {
  using G = Geo<T, DP>;
  constexpr int B = G::B;
  for (int e = threadIdx.x; e < B * B; e += kThreads) {
    const int r = e / B, c = e % B;
    float p = 0.f;
    if (c < k_valid) {
      float s = S[r * G::LDS + c] * a.scale;
      if (masked(a, q0 + r, k0 + c, qseg_s[r], kseg_s[c])) s = kNegInf;
      p = expf(s - lse_s[r]);
    }
    const float ds = p * (dP[r * G::LDS + c] - delta_s[r]) * a.scale;
    if (P != nullptr) P[r * G::LDP + c] = from_f<T>(p);
    dS[r * G::LDP + c] = from_f<T>(ds);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  using G = Geo<T, DP>;
  constexpr int B = G::B;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sp = smem;
  T* Qs = reinterpret_cast<T*>(carve(sp, G::kTile));
  T* dOs = reinterpret_cast<T*>(carve(sp, G::kTile));
  T* Ks = reinterpret_cast<T*>(carve(sp, G::kTile));
  T* Vs = reinterpret_cast<T*>(carve(sp, G::kTile));
  float* S = reinterpret_cast<float*>(carve(sp, G::kScore));
  float* dP = reinterpret_cast<float*>(carve(sp, G::kScore));
  T* dS = reinterpret_cast<T*>(carve(sp, G::kProb));
  float* dQ = reinterpret_cast<float*>(carve(sp, G::kAcc));
  float* lse_s = reinterpret_cast<float*>(carve(sp, G::kRow));
  float* delta_s = reinterpret_cast<float*>(carve(sp, G::kRow));
  int* qseg_s = reinterpret_cast<int*>(carve(sp, G::kRow));
  int* kseg_s = reinterpret_cast<int*>(carve(sp, G::kRow));

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / a.hq, h = blockIdx.y % a.hq;
  const int g = h / a.rep;
  const int q0 = qt * B;
  const int q_valid = min(B, a.sq - q0);
  const int off = a.sk - a.sq;
  int lo = 0, hi = a.sk;
  if (a.causal) hi = min(hi, q0 + q_valid + off);
  if (a.window) lo = max(0, q0 + off - a.window + 1);

  const size_t qrow = static_cast<size_t>(a.hq) * a.d;
  const size_t kvrow = static_cast<size_t>(a.hk) * a.d;
  const size_t qofs = (static_cast<size_t>(b) * a.sq + q0) * qrow +
                      static_cast<size_t>(h) * a.d;
  load_tile<T, DP>(Qs, static_cast<const T*>(a.q) + qofs, qrow, q_valid,
                   a.d);
  load_tile<T, DP>(dOs, static_cast<const T*>(a.dout) + qofs, qrow, q_valid,
                   a.d);
  load_q_rows<T, DP>(a, b, h, q0, q_valid, lse_s, delta_s, qseg_s);
  for (int e = tid; e < B * G::LDF; e += kThreads) dQ[e] = 0.f;

  for (int k0 = (lo / B) * B; k0 < hi; k0 += B) {
    __syncthreads();
    const int k_valid = min(B, a.sk - k0);
    const size_t kofs = (static_cast<size_t>(b) * a.sk + k0) * kvrow +
                        static_cast<size_t>(g) * a.d;
    load_tile<T, DP>(Ks, static_cast<const T*>(a.k) + kofs, kvrow, k_valid,
                     a.d);
    load_tile<T, DP>(Vs, static_cast<const T*>(a.v) + kofs, kvrow, k_valid,
                     a.d);
    for (int c = tid; c < B; c += kThreads)
      kseg_s[c] = (a.kseg != nullptr && c < k_valid)
                      ? a.kseg[static_cast<size_t>(b) * a.sk + k0 + c]
                      : 0;
    __syncthreads();
    tile_mma<T, B, B, DP, true, false>(Qs, G::LDT, Ks, G::LDT, S, G::LDS,
                                       false);
    tile_mma<T, B, B, DP, true, false>(dOs, G::LDT, Vs, G::LDT, dP, G::LDS,
                                       false);
    __syncthreads();
    p_and_ds<T, DP>(a, q0, k0, k_valid, S, dP, lse_s, delta_s, qseg_s,
                    kseg_s, static_cast<T*>(nullptr), dS);
    __syncthreads();
    tile_mma<T, B, DP, B, true, true>(dS, G::LDP, Ks, G::LDT, dQ, G::LDF,
                                      true);
  }
  __syncthreads();
  T* dqp = static_cast<T*>(a.out0) + qofs;
  for (int e = tid; e < B * DP; e += kThreads) {
    const int r = e / DP, c = e % DP;
    if (r < q_valid && c < a.d) dqp[r * qrow + c] = from_f<T>(dQ[r * G::LDF + c]);
  }
}

template <typename T, int DP, bool FUSED>
__global__ void __launch_bounds__(kThreads) dkv_kernel(Args a) {
  using G = Geo<T, DP>;
  constexpr int B = G::B;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sp = smem;
  T* Ks = reinterpret_cast<T*>(carve(sp, G::kTile));
  T* Vs = reinterpret_cast<T*>(carve(sp, G::kTile));
  T* Qs = reinterpret_cast<T*>(carve(sp, G::kTile));
  T* dOs = reinterpret_cast<T*>(carve(sp, G::kTile));
  float* S = reinterpret_cast<float*>(carve(sp, G::kScore));
  float* dP = reinterpret_cast<float*>(carve(sp, G::kScore));
  T* P = reinterpret_cast<T*>(carve(sp, G::kProb));
  T* dS = reinterpret_cast<T*>(carve(sp, G::kProb));
  float* dK = reinterpret_cast<float*>(carve(sp, G::kAcc));
  float* dV = reinterpret_cast<float*>(carve(sp, G::kAcc));
  float* lse_s = reinterpret_cast<float*>(carve(sp, G::kRow));
  float* delta_s = reinterpret_cast<float*>(carve(sp, G::kRow));
  int* qseg_s = reinterpret_cast<int*>(carve(sp, G::kRow));
  int* kseg_s = reinterpret_cast<int*>(carve(sp, G::kRow));

  const int tid = threadIdx.x;
  const int b = blockIdx.y / a.hk, g = blockIdx.y % a.hk;
  const int off = a.sk - a.sq;
  // FUSED: the CTA owns kv rows [span_lo, span_hi) and the span's dq
  // partial; two-pass: one kv tile
  const int span_lo = FUSED ? blockIdx.x * a.span : blockIdx.x * B;
  const int span_hi = min(a.sk, span_lo + (FUSED ? a.span : B));
  const size_t qrow = static_cast<size_t>(a.hq) * a.d;
  const size_t kvrow = static_cast<size_t>(a.hk) * a.d;
  T* dk_out = static_cast<T*>(FUSED ? a.out1 : a.out0);
  T* dv_out = static_cast<T*>(FUSED ? a.out2 : a.out1);
  const int pld = a.hq * DP;  // row stride of the dq partials, float32

  for (int k0 = span_lo; k0 < span_hi; k0 += B) {
    __syncthreads();  // the previous kv tile's dK/dV stores are done
    const int k_valid = min(B, span_hi - k0);
    const size_t kofs = (static_cast<size_t>(b) * a.sk + k0) * kvrow +
                        static_cast<size_t>(g) * a.d;
    load_tile<T, DP>(Ks, static_cast<const T*>(a.k) + kofs, kvrow, k_valid,
                     a.d);
    load_tile<T, DP>(Vs, static_cast<const T*>(a.v) + kofs, kvrow, k_valid,
                     a.d);
    for (int c = tid; c < B; c += kThreads)
      kseg_s[c] = (a.kseg != nullptr && c < k_valid)
                      ? a.kseg[static_cast<size_t>(b) * a.sk + k0 + c]
                      : 0;
    for (int e = tid; e < B * G::LDF; e += kThreads) {
      dK[e] = 0.f;
      dV[e] = 0.f;
    }
    // the q rows that see a key of this tile
    int q_lo = 0, q_hi = a.sq;
    if (a.causal) q_lo = max(0, k0 - off);
    if (a.window) q_hi = min(a.sq, k0 + k_valid - 1 - off + a.window);
    for (int r = 0; r < a.rep; ++r) {
      const int h = g * a.rep + r;
      for (int q0 = (q_lo / B) * B; q0 < q_hi; q0 += B) {
        const int q_valid = min(B, a.sq - q0);
        __syncthreads();  // the previous products are done with Q, dO, P, dS
        const size_t qofs = (static_cast<size_t>(b) * a.sq + q0) * qrow +
                            static_cast<size_t>(h) * a.d;
        load_tile<T, DP>(Qs, static_cast<const T*>(a.q) + qofs, qrow,
                         q_valid, a.d);
        load_tile<T, DP>(dOs, static_cast<const T*>(a.dout) + qofs, qrow,
                         q_valid, a.d);
        load_q_rows<T, DP>(a, b, h, q0, q_valid, lse_s, delta_s, qseg_s);
        __syncthreads();
        tile_mma<T, B, B, DP, true, false>(Qs, G::LDT, Ks, G::LDT, S,
                                           G::LDS, false);
        tile_mma<T, B, B, DP, true, false>(dOs, G::LDT, Vs, G::LDT, dP,
                                           G::LDS, false);
        __syncthreads();
        p_and_ds<T, DP>(a, q0, k0, k_valid, S, dP, lse_s, delta_s, qseg_s,
                        kseg_s, P, dS);
        __syncthreads();
        // dV += P^T dO, dK += dS^T Q (the transposes read P and dS
        // column-major)
        tile_mma<T, B, DP, B, false, true>(P, G::LDP, dOs, G::LDT, dV,
                                           G::LDF, true);
        tile_mma<T, B, DP, B, false, true>(dS, G::LDP, Qs, G::LDT, dK,
                                           G::LDF, true);
        if constexpr (FUSED) {
          float* part = static_cast<float*>(a.out0) +
                        ((static_cast<size_t>(blockIdx.x) * a.b + b) *
                             a.sq_pad +
                         q0) *
                            pld +
                        static_cast<size_t>(h) * DP;
          tile_mma<T, B, DP, B, true, true>(dS, G::LDP, Ks, G::LDT, part,
                                            pld, true);
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < B * DP; e += kThreads) {
      const int r = e / DP, c = e % DP;
      if (r < k_valid && c < a.d) {
        const size_t o = kofs + r * kvrow + c;
        dk_out[o] = from_f<T>(dK[r * G::LDF + c]);
        dv_out[o] = from_f<T>(dV[r * G::LDF + c]);
      }
    }
  }
}

enum Pass { kFwd = 0, kDq = 1, kDkv = 2, kFused = 3 };

template <typename KernelT>
cudaError_t launch_kernel(KernelT kernel, dim3 grid, size_t smem,
                          const Args& a, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dp(int pass, const Args& a, cudaStream_t st) {
  using G = Geo<T, DP>;
  constexpr int B = G::B;
  if (pass == kFwd || pass == kDq) {
    const dim3 grid((a.sq + B - 1) / B, a.b * a.hq);
    if (pass == kFwd) return launch_kernel(fwd_kernel<T, DP>, grid, G::kFwd, a, st);
    return launch_kernel(dq_kernel<T, DP>, grid, G::kDq, a, st);
  }
  if (pass == kDkv) {
    const dim3 grid((a.sk + B - 1) / B, a.b * a.hk);
    return launch_kernel(dkv_kernel<T, DP, false>, grid, G::kDkv, a, st);
  }
  if (a.sq_pad % B != 0 || a.sq_pad < a.sq) return cudaErrorInvalidValue;
  const dim3 grid((a.sk + a.span - 1) / a.span, a.b * a.hk);
  return launch_kernel(dkv_kernel<T, DP, true>, grid, G::kDkv, a, st);
}

int padded_dim(int d) { return d <= 64 ? 64 : (d <= 128 ? 128 : 256); }

int run(int pass, const void* q, const void* k, const void* v,
        const void* dout, const float* lse_in, const float* delta,
        const int* qseg, const int* kseg, void* out0, void* out1, void* out2,
        float* lse, int b, int sq, int sk, int hq, int hk, int d, int dp,
        int causal, int window, int span, int sq_pad, float scale,
        void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || hk < 1 || hq < hk || hq % hk != 0 ||
      d < 8 || d > 256 || d % 8 != 0 || dp != padded_dim(d) ||
      (causal != 0 && causal != 1) || window < 0 ||
      static_cast<long long>(b) * hq > 65535 || out0 == nullptr ||
      (pass != kFwd && (dout == nullptr || lse_in == nullptr ||
                        delta == nullptr)) ||
      (pass >= kDkv && out1 == nullptr) ||
      (pass == kFused && (out2 == nullptr || span < 1)) ||
      ((qseg == nullptr) != (kseg == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,    k,    v,    dout, lse_in, delta, qseg, kseg, out0,
         out1, out2, lse,  b,    sq,     sk,    hq,   hk,   d,
         hq / hk, causal, window, span, sq_pad, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using T = PT_FA_T;
  cudaError_t err;
  if (dp == 64)
    err = launch_dp<T, 64>(pass, a, st);
  else if (dp == 128)
    err = launch_dp<T, 128>(pass, a, st);
  else
    err = launch_dp<T, 256>(pass, a, st);
  return static_cast<int>(err);
}

}  // namespace

// One signature for the four passes (unused pointers null):
//   q, k, v, dout, lse_in, delta, qseg, kseg, out0, out1, out2, lse,
//   b, sq, sk, hq, hk, d, dp, causal, window, span, sq_pad, scale, stream
#define PT_FA_ENTRY(NAME, PASS)                                              \
  extern "C" int PT_CAT(NAME, PT_FA_TAG)(                                    \
      const void* q, const void* k, const void* v, const void* dout,        \
      const float* lse_in, const float* delta, const int* qseg,             \
      const int* kseg, void* out0, void* out1, void* out2, float* lse,      \
      int b, int sq, int sk, int hq, int hk, int d, int dp, int causal,     \
      int window, int span, int sq_pad, float scale, void* stream) {        \
    return run(PASS, q, k, v, dout, lse_in, delta, qseg, kseg, out0, out1,  \
               out2, lse, b, sq, sk, hq, hk, d, dp, causal, window, span,   \
               sq_pad, scale, stream);                                      \
  }

PT_FA_ENTRY(pt_flash_fwd_, kFwd)
PT_FA_ENTRY(pt_flash_bwd_dq_, kDq)
PT_FA_ENTRY(pt_flash_bwd_dkv_, kDkv)
PT_FA_ENTRY(pt_flash_bwd_fused_, kFused)
