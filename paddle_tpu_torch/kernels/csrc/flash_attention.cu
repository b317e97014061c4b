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
// Design. Two generations of bodies share the file.
//
// The redesigned kernels (16-bit inputs at DP 64 and 128, every shape of
// the Llama train path): products on mma.sync m16n8k16 with float32
// accumulators in registers; operands read from shared-memory tiles by
// ldmatrix (.trans for the transposed operands), rows padded by 16 bytes
// so the eight rows of an 8x8 read fall in distinct banks; tiles filled by
// cp.async, the next tile landing while the current one is multiplied;
// fragment reads software-pipelined ahead of the products (gemm_pipe).
//   - fwd_kernel: 4 warps, q tiles of 64 rows (16 a warp, their Q
//     fragments in registers for the whole kv loop), kv tiles of 64 keys
//     in a two-stage ring; grid (q tiles, batch x query head), a head's
//     tiles side by side (sharing its K and V in L2), the heaviest causal
//     tiles first. S stays in registers, the online
//     softmax runs there (row max and sum across the 4 lanes of a row by
//     shuffles, p = 2^(s sl2 - m sl2) by one FFMA and MUFU.EX2), p is
//     rounded to T in registers and fed as the A operand of P V, O is
//     rescaled in place. The mask is applied only on tiles that a mask
//     touches (the diagonal, a window edge, a ragged tile, segment ids).
//     O / l leaves through shared memory as 16-byte stores.
//   - dkv_kernel: 8 warps, kv tiles of 128 keys (16 a warp, whose dK and
//     dV rows accumulate in registers over the whole q loop), q tiles of 64
//     rows with lse, delta and the segment ids in a two-stage ring. It
//     computes S^T = K Q^T and dP^T = V dO^T, so p^T and ds^T, rounded to T
//     in registers, are already the A operands of dV += P^T dO and dK +=
//     dS^T Q. FUSED: dS^T is staged as a T tile and dq = dS K (ldmatrix
//     .trans) goes to a fresh register accumulator, added to the span's
//     float32 partial, which was prefetched into shared memory by cp.async
//     at the start of the q tile and is stored back as 16-byte vectors.
//     Grid (kv tiles, batch x kv head) for the two passes, a head's tiles
//     side by side; (batch x kv head, spans) for FUSED, the low spans (the
//     heaviest causal work) first. dk and dv leave through shared memory
//     as 16-byte stores.
//   - dq_kernel (row 7, the dq pass of the two-pass backward; redesigned
//     after the others, on fwd_kernel's machinery): 4 warps, q tiles of 64
//     rows with their dq rows in float32 registers, kv tiles of 64 keys
//     and their segment ids in a two-stage ring; the warp's Q fragments in
//     registers for the whole kv loop, its dO fragments too at DP 64 and
//     read by ldmatrix at DP 128. S = Q K^T and dP = dO V^T are register
//     accumulators; p and ds form in registers as dkv_kernel forms them
//     (hidden scores p = 0), ds is rounded to T by acc_to_a into the A
//     operand of dq += dS K, and K is the [key][d] B operand by ldmatrix
//     .trans. Grid and tile order as fwd_kernel's; dq leaves through
//     shared memory as 16-byte stores.
// What bounds them now (ptxas, and the flash phase of chip_smoke.py, at
// the train shape): about 190 TFLOP/s forward, 150 fused, 210 for the
// dk/dv pass and 220 for the dq pass, a fifth of the tensor cores' rate.
// The forward takes 176 registers and the dq pass 236 at DP 128, without
// spills (two CTAs, 8 warps an SM), the dk/dv passes the 255 cap with a
// few spilled words at DP 128 (one CTA of 8 warps). mma.sync with
// ldmatrix operands and 8 warps an SM is bound by operand reads from
// shared memory and by the softmax or ds arithmetic issued between the
// products, which nothing overlaps. The fused pass also reads and writes
// its float32 partial once per (kv tile, q tile) pair: 2.2 GB at the
// train shape (272 pairs of 64 KB per kv head), more than L2 holds. wgmma
// fed by TMA in 128-byte swizzled tiles, with warp specialisation so that
// the softmax overlaps the products, is what would pass SDPA.
//
// The first version's bodies (fwd_kernel_v1, dq_kernel_v1, dkv_kernel_v1)
// still serve float32 (the 1e-5 references: a SIMT FMA loop, no TF32) and
// DP 256: 128 threads, square tiles of B = 64 rows (32 when a padded row
// holds more than 256 bytes) in shared memory, nvcuda::wmma 16x16x16
// fragments for 16-bit inputs, accumulators in shared memory (tile_mma).
// fwd_kernel_v1 and dq_kernel_v1: one CTA per (batch, query head, q
// tile); dkv_kernel_v1: one per (batch, kv head, kv tile or span). dkv_kernel and dkv_kernel_v1 loop over the group's query
// heads and the q tiles that see the kv tile, the GQA sum landing in the
// same dk/dv accumulators. FUSED: one CTA per (batch, kv head, kv span of
// the JAX k block) walks the span's kv tiles in order and adds ds k into
// the span's float32 dq partial [span, b, sq_pad, hq, DP] in device
// memory, which it alone writes; the caller sums the partials over spans
// in order.
// No atomics: every sum runs in a fixed order, so the backward is
// run-to-run identical, and the fused and two-pass dk/dv are bit for bit
// the same (one loop, the same tiles: spans are whole kv tiles).
//
// Built once per element type: compile with -DPT_FA_T=<type>
// -DPT_FA_TAG=<suffix>; the exported C functions are
// pt_flash_{fwd,bwd_dq,bwd_dkv,bwd_fused}_<suffix>. Each returns
// cudaGetLastError() after its launch. pt_flash_smem_<suffix>(pass, dp)
// gives the dynamic shared memory a pass's kernel is launched with.

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
__global__ void __launch_bounds__(kThreads) fwd_kernel_v1(Args a) {
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
__global__ void __launch_bounds__(kThreads) dq_kernel_v1(Args a) {
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
__global__ void __launch_bounds__(kThreads) dkv_kernel_v1(Args a) {
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

// ---------------------------------------------------------------------------
// The redesigned kernels for 16-bit inputs at DP 64 and 128: mma.sync
// m16n8k16 with float32 accumulators in registers, operands read from
// padded shared-memory tiles by ldmatrix, tiles filled by cp.async.
// ---------------------------------------------------------------------------
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, or zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c[16x8] += a[16x16] b[16x8], float32 accumulators. Fragments as the PTX
// ISA lays them out for m16n8k16 (lane = 4 g + t): c0, c1 at (g, 2t..2t+1),
// c2, c3 at (g + 8, 2t..2t+1); a0..a3 the pairs at (g, 2t), (g + 8, 2t),
// (g, 2t + 8), (g + 8, 2t + 8); b0, b1 the pairs at k (2t, 2t + 8), n g.
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two floats rounded to T, the first in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// The A fragment of a 16x16 operand whose rows are the accumulator rows of
// c[2 kk] and c[2 kk + 1] (16 columns), rounded to T: an accumulator
// turned into the next product's A operand without leaving registers.
template <typename T, int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[N][4], int kk) {
  a[0] = pack2<T>(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack2<T>(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack2<T>(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack2<T>(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// acc[n] += A . B over KK steps of 16 (k) and NP pairs of n8 tiles,
// software-pipelined so that shared-memory reads overlap the products: the
// B fragments of each (k step, n pair) come from b_frag(kk, np, regs) PF - 1
// pairs ahead through a ring of registers, the A fragment of each k step
// from a_frag(kk, regs) one step ahead. With every loop unrolled the ring
// indices are constants and the ring stays in registers.
template <typename T, int KK, int NP, int PF, class FA, class FB>
__device__ __forceinline__ void gemm_pipe(float (&acc)[2 * NP][4], FA a_frag,
                                          FB b_frag) {
  constexpr int NJ = KK * NP;
  uint32_t aa[2][4];
  uint32_t bb[PF][4];
  a_frag(0, aa[0]);
#pragma unroll
  for (int j = 0; j < PF - 1; ++j)
    if (j < NJ) b_frag(j / NP, j % NP, bb[j]);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int kk = j / NP, np = j % NP;
    if (np == 0 && kk + 1 < KK) a_frag(kk + 1, aa[(kk + 1) & 1]);
    if (j + PF - 1 < NJ)
      b_frag((j + PF - 1) / NP, (j + PF - 1) % NP, bb[(j + PF - 1) % PF]);
    mma16816<T>(acc[2 * np], aa[kk & 1], bb[j % PF][0], bb[j % PF][1]);
    mma16816<T>(acc[2 * np + 1], aa[kk & 1], bb[j % PF][2], bb[j % PF][3]);
  }
}

// 2^x by the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to zero, far under what a bf16 or fp16 p can hold)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void copy4(uint32_t (&d)[4],
                                      const uint32_t (&s)[4]) {
  d[0] = s[0];
  d[1] = s[1];
  d[2] = s[2];
  d[3] = s[3];
}

// Lane offsets (row, column) of the ldmatrix.x4 addresses:
//   a_off: an A operand stored [m][k] (rows m0.., k0..);
//   b_off: a B operand stored [n][k] (two n8 tiles of one 16-deep k step);
//   bt_off: a B operand stored [k][n] read with .trans (two n8 tiles);
//   at_off: an A operand stored [k][m] read with .trans.
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int b_row(int lane) {
  return (lane & 7) + ((lane >> 4) << 3);
}
__device__ __forceinline__ int b_col(int lane) { return ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int bt_row(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int bt_col(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int at_row(int lane) {
  return (lane & 7) + (lane >> 4) * 8;
}
__device__ __forceinline__ int at_col(int lane) {
  return ((lane >> 3) & 1) * 8;
}

// Rows [0, valid) of a [*, d] slice (rows `stride` elements apart) into a
// [ROWS, LD] tile by cp.async; columns d..DP-1 and rows valid..ROWS-1
// become zeros. The caller commits and waits. A thread keeps one 16-byte
// column and walks rows NTHREADS / (DP / 8) apart, so a copy costs a
// pointer add and a compare.
template <typename T, int ROWS, int DP, int LD, int NTHREADS>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                size_t stride, int valid,
                                                int d) {
  constexpr int VPR = DP / 8, RSTEP = NTHREADS / VPR;
  static_assert(NTHREADS % VPR == 0 && ROWS % RSTEP == 0, "tile shape");
  const int c = (threadIdx.x % VPR) * 8, r0 = threadIdx.x / VPR;
  const bool c_ok = c < d;
  const T* sp = src + r0 * stride + c;
  T* dp = dst + r0 * LD + c;
#pragma unroll
  for (int i = 0; i < ROWS / RSTEP; ++i) {
    const bool ok = c_ok && r0 + i * RSTEP < valid;
    cp_async16(dp + i * RSTEP * LD, ok ? sp : src, ok);
    sp += RSTEP * stride;
  }
}

// Forward geometry: NW warps, each owning 16 rows of the q tile (BM = 16
// NW rows) with their Q fragments in registers; kv tiles of BN keys in a
// ring of NST stages. At bf16 d 128: 174 registers and 88 KB, so two CTAs
// (8 warps) share an SM. On the card, 8 warps a CTA, kv tiles of 32, three
// to five stages, two 16-row slices a warp (which spilled) and a wgmma
// version (Q K^T from shared memory, P V with P from registers) ran no
// faster.
template <typename T, int DP>
struct FwdCfg {
  static constexpr int NW = 4, NST = 2;
  static constexpr int kThreads = 32 * NW, BM = 16 * NW, BN = 64;
  static constexpr int LD = DP + 8;  // 16 bytes of padding: ldmatrix rows
                                     // fall in distinct banks
  static constexpr size_t kQ = al128(size_t(BM) * LD * sizeof(T));
  static constexpr size_t kKV = al128(size_t(BN) * LD * sizeof(T));
  static constexpr size_t kKseg = al128(BN * 4), kQseg = al128(BM * 4);
  static constexpr size_t kStage = 2 * kKV + kKseg;  // K V kseg
  static constexpr size_t kSmem = kQ + NST * kStage + kQseg;
  static_assert(kSmem <= 232448, "shared memory over the per-block limit");
};

// K, V and the kv segment ids of kv tile kt (batch b, kv head grp) into
// a ring stage of the forward's geometry by cp.async; the caller commits.
template <typename T, int DP>
__device__ __forceinline__ void load_kv_stage(unsigned char* base,
                                              const Args& a, int kt, int b,
                                              int grp) {
  using C = FwdCfg<T, DP>;
  constexpr int BN = C::BN, LD = C::LD, NTH = C::kThreads;
  const size_t kvrow = static_cast<size_t>(a.hk) * a.d;
  const int k0 = kt * BN, kv = min(BN, a.sk - k0);
  const size_t kofs = (static_cast<size_t>(b) * a.sk + k0) * kvrow +
                      static_cast<size_t>(grp) * a.d;
  load_tile_async<T, BN, DP, LD, NTH>(reinterpret_cast<T*>(base),
                                      static_cast<const T*>(a.k) + kofs,
                                      kvrow, kv, a.d);
  load_tile_async<T, BN, DP, LD, NTH>(reinterpret_cast<T*>(base + C::kKV),
                                      static_cast<const T*>(a.v) + kofs,
                                      kvrow, kv, a.d);
  if (a.kseg != nullptr) {
    int* ks = reinterpret_cast<int*>(base + 2 * C::kKV);
    for (int c = threadIdx.x; c < BN; c += NTH) {
      const int* src = a.kseg + static_cast<size_t>(b) * a.sk + k0 + c;
      cp_async4(ks + c, c < kv ? src : a.kseg, c < kv);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(FwdCfg<T, DP>::kThreads)
    fwd_kernel(Args a) {
  using C = FwdCfg<T, DP>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD, NST = C::NST,
                NT = BN / 8, DT = DP / 8, NTH = C::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  T* const Qs = reinterpret_cast<T*>(smem);
  unsigned char* const ring = smem + C::kQ;  // stage s at s * kStage
  int* const qsg = reinterpret_cast<int*>(ring + NST * C::kStage);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane >> 2, t4 = lane & 3;
  // grid (q tiles, b * hq): a head's q tiles run side by side and share
  // its K and V in L2, the heaviest causal tiles first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / a.hq, h = blockIdx.y % a.hq;
  const int grp = h / a.rep;
  const int q0 = qt * BM;
  const int q_valid = min(BM, a.sq - q0);
  const int off = a.sk - a.sq;
  int lo = 0, hi = a.sk;
  if (a.causal) hi = min(hi, q0 + q_valid + off);
  if (a.window) lo = max(0, q0 + off - a.window + 1);

  const size_t qrow = static_cast<size_t>(a.hq) * a.d;
  const T* qp = static_cast<const T*>(a.q) +
                (static_cast<size_t>(b) * a.sq + q0) * qrow +
                static_cast<size_t>(h) * a.d;
  load_tile_async<T, BM, DP, LD, NTH>(Qs, qp, qrow, q_valid, a.d);
  cp_async_commit();
  for (int r = tid; r < BM; r += NTH)
    qsg[r] = (a.qseg != nullptr && r < q_valid)
                 ? a.qseg[static_cast<size_t>(b) * a.sq + q0 + r]
                 : 0;

  const int kt0 = lo / BN, kt1 = hi > 0 ? (hi + BN - 1) / BN : 0;
  auto load_kv = [&](int kt, int st) {
    load_kv_stage<T, DP>(ring + st * C::kStage, a, kt, b, grp);
  };
  // the ring: tiles kt0 .. kt0 + NST - 2 in flight before the loop
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (kt0 + i < kt1) load_kv(kt0 + i, i);
    cp_async_commit();
  }
  // the warp's Q fragments stay in registers for the whole kv loop
  const int r0 = warp * 16 + gq;  // the thread's rows r0 and r0 + 8
  uint32_t qf[DP / 16][4];
  cp_async_wait<NST - 1>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    ldsm_x4(qf[kk], Qs + (warp * 16 + a_row(lane)) * LD + kk * 16 +
                        a_col(lane));

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  // running max (of the unscaled scores) and the thread's part of the
  // running sum, for rows r0 and r0 + 8. Hidden scores take -inf, not the
  // -1e30 of the first version: the same result for every row that sees
  // a key, with no 1e30-sized FFMA residue
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = a.scale * kLog2e;
  const int b_off = b_row(lane) * LD + b_col(lane);
  const int bt_off = bt_row(lane) * LD + bt_col(lane);

  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) % NST;
    cp_async_wait<NST - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with kt - 1
    // refill the stage that tile kt - 1 used, NST - 1 tiles ahead
    if (kt + NST - 1 < kt1) load_kv(kt + NST - 1, (kt - kt0 + NST - 1) % NST);
    cp_async_commit();
    const T* K = reinterpret_cast<const T*>(ring + st * C::kStage);
    const T* V = K + C::kKV / sizeof(T);
    const int* ks = reinterpret_cast<const int*>(ring + st * C::kStage +
                                                 2 * C::kKV);
    // S = Q K^T in registers
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    gemm_pipe<T, DP / 16, NT / 2, 4>(
        s, [&](int kk, uint32_t(&r)[4]) { copy4(r, qf[kk]); },
        [&](int kk, int np, uint32_t(&r)[4]) {
          ldsm_x4(r, K + np * 16 * LD + kk * 16 + b_off);
        });
    // the mask only on tiles that a mask touches
    const int k0 = kt * BN, k_valid = min(BN, a.sk - k0);
    const bool need =
        k_valid < BN || a.qseg != nullptr ||
        (a.causal && k0 + BN - 1 > q0 + off) ||
        (a.window && q0 + q_valid - 1 + off - k0 >= a.window);
    if (need) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + 2 * t4 + (e & 1), r = r0 + (e >> 1) * 8;
          if (c >= k_valid || masked(a, q0 + r, k0 + c, qsg[r], ks[c]))
            s[nt][e] = -INFINITY;
        }
    }
    // online softmax: the 4 lanes of a row hold its BN scores
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    // p = exp(scale s - scale m) = 2^(s sl2 - m sl2), one FFMA and one
    // MUFU.EX2 per score; a row with no visible key yet has m = -inf and
    // takes 0 in its place, so every p and alpha is 0
    float alpha[2], ml2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      ml2[i] = mx[i] == -INFINITY ? 0.f : mx[i] * sl2;
      alpha[i] = ex2(fmaf(m[i], sl2, -ml2[i]));
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[nt][e], sl2, -ml2[e >> 1]));
        s[nt][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }
    // O += P V, p rounded to T in registers as the A operand
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) acc_to_a<T>(pa[kk], s, kk);
    gemm_pipe<T, BN / 16, DT / 2, 4>(
        o, [&](int kk, uint32_t(&r)[4]) { copy4(r, pa[kk]); },
        [&](int kk, int dp, uint32_t(&r)[4]) {
          ldsm_x4_t(r, V + kk * 16 * LD + dp * 16 + bt_off);
        });
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: o / l (l = 0 read as 1) through shared memory to 16-byte
  // stores; lse = m + log(l)
  T* Os = Qs;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (l[i] == 0.f) l[i] = 1.f;
  }
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int c = i * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(Os + r0 * LD + c) =
        pack2<T>(o[i][0] / l[0], o[i][1] / l[0]);
    *reinterpret_cast<uint32_t*>(Os + (r0 + 8) * LD + c) =
        pack2<T>(o[i][2] / l[1], o[i][3] / l[1]);
  }
  if (a.lse != nullptr && t4 == 0) {
    float* lp = a.lse + (static_cast<size_t>(b) * a.hq + h) * a.sq + q0;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (r0 + 8 * i < q_valid) lp[r0 + 8 * i] = m[i] * a.scale + logf(l[i]);
  }
  __syncthreads();
  T* op = static_cast<T*>(a.out0) +
          (static_cast<size_t>(b) * a.sq + q0) * qrow +
          static_cast<size_t>(h) * a.d;
  constexpr int VPR = DP / 8;
  for (int e = tid; e < BM * VPR; e += NTH) {
    const int r = e / VPR, c = (e % VPR) * 8;
    if (r < q_valid && c < a.d)
      *reinterpret_cast<uint4*>(op + r * qrow + c) =
          *reinterpret_cast<const uint4*>(Os + r * LD + c);
  }
}

// dq geometry: the forward's, with dq in place of O. NW warps, each owning
// 16 rows of the q tile (BM = 16 NW) and their dq rows in registers; kv
// tiles of BN keys in a ring of NST stages. The warp's Q fragments stay in
// registers for the whole kv loop; its dO fragments too at DP 64, while at
// DP 128 they are read from the dO tile by ldmatrix for every kv tile
// (holding them as well would pass the 255-register cap).
template <typename T, int DP>
struct DqCfg : FwdCfg<T, DP> {
  using F = FwdCfg<T, DP>;
  static constexpr bool HOLD_DO = DP <= 64;
  static constexpr size_t kSmem = F::kSmem + F::kQ;  // the forward's + dO
  static_assert(kSmem <= 232448, "shared memory over the per-block limit");
};

// Row 7: dq = sum over kv tiles of dS K, dS = p (dP - delta) scale with
// p = exp(s scale - lse) and dP = dO V^T, for one q tile. S and dP are
// register accumulators; p and ds are formed in registers exactly as
// dkv_kernel forms them (one FFMA and ex2 for p, hidden scores p = 0), ds
// is rounded to T by acc_to_a into the A operand of dS K, and K is read
// as a [key][d] B operand by ldmatrix.trans. dq accumulates in float32
// registers over the kv tiles in order: no atomics.
template <typename T, int DP>
__global__ void __launch_bounds__(DqCfg<T, DP>::kThreads)
    dq_kernel(Args a) {
  using C = DqCfg<T, DP>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD, NST = C::NST,
                NT = BN / 8, DT = DP / 8, NTH = C::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  T* const Qs = reinterpret_cast<T*>(smem);
  T* const dOs = reinterpret_cast<T*>(smem + C::kQ);
  unsigned char* const ring = smem + 2 * C::kQ;  // stage s at s * kStage
  int* const qsg = reinterpret_cast<int*>(ring + NST * C::kStage);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane >> 2, t4 = lane & 3;
  // grid (q tiles, b * hq): a head's q tiles side by side sharing its K
  // and V in L2, the heaviest causal tiles first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / a.hq, h = blockIdx.y % a.hq;
  const int grp = h / a.rep;
  const int q0 = qt * BM;
  const int q_valid = min(BM, a.sq - q0);
  const int off = a.sk - a.sq;
  int lo = 0, hi = a.sk;
  if (a.causal) hi = min(hi, q0 + q_valid + off);
  if (a.window) lo = max(0, q0 + off - a.window + 1);

  const size_t qrow = static_cast<size_t>(a.hq) * a.d;
  const size_t qofs = (static_cast<size_t>(b) * a.sq + q0) * qrow +
                      static_cast<size_t>(h) * a.d;
  load_tile_async<T, BM, DP, LD, NTH>(Qs, static_cast<const T*>(a.q) + qofs,
                                      qrow, q_valid, a.d);
  load_tile_async<T, BM, DP, LD, NTH>(
      dOs, static_cast<const T*>(a.dout) + qofs, qrow, q_valid, a.d);
  cp_async_commit();
  for (int r = tid; r < BM; r += NTH)
    qsg[r] = (a.qseg != nullptr && r < q_valid)
                 ? a.qseg[static_cast<size_t>(b) * a.sq + q0 + r]
                 : 0;
  // the thread's rows r0 and r0 + 8: lse (times log2 e) and delta in
  // registers; a row past the sequence takes lse = +inf, so its p is 0
  const int r0 = warp * 16 + gq;
  float lse2[2], dl[2];
  {
    const size_t row = (static_cast<size_t>(b) * a.hq + h) * a.sq + q0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool ok = r0 + 8 * i < q_valid;
      lse2[i] = ok ? a.lse_in[row + r0 + 8 * i] * kLog2e : INFINITY;
      dl[i] = ok ? a.delta[row + r0 + 8 * i] : 0.f;
    }
  }

  const int kt0 = lo / BN, kt1 = hi > 0 ? (hi + BN - 1) / BN : 0;
  auto load_kv = [&](int kt, int st) {
    load_kv_stage<T, DP>(ring + st * C::kStage, a, kt, b, grp);
  };
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (kt0 + i < kt1) load_kv(kt0 + i, i);
    cp_async_commit();
  }
  const int a_off = (warp * 16 + a_row(lane)) * LD + a_col(lane);
  uint32_t qf[DP / 16][4];
  uint32_t dof[C::HOLD_DO ? DP / 16 : 1][4];
  cp_async_wait<NST - 1>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    ldsm_x4(qf[kk], Qs + kk * 16 + a_off);
    if constexpr (C::HOLD_DO) ldsm_x4(dof[kk], dOs + kk * 16 + a_off);
  }

  float dq[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
    dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  const float sl2 = a.scale * kLog2e;
  const int b_off = b_row(lane) * LD + b_col(lane);
  const int bt_off = bt_row(lane) * LD + bt_col(lane);

  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) % NST;
    cp_async_wait<NST - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with kt - 1
    if (kt + NST - 1 < kt1) load_kv(kt + NST - 1, (kt - kt0 + NST - 1) % NST);
    cp_async_commit();
    const T* K = reinterpret_cast<const T*>(ring + st * C::kStage);
    const T* V = K + C::kKV / sizeof(T);
    const int* ks = reinterpret_cast<const int*>(ring + st * C::kStage +
                                                 2 * C::kKV);
    // S = Q K^T and dP = dO V^T in registers
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
    gemm_pipe<T, DP / 16, NT / 2, 4>(
        s, [&](int kk, uint32_t(&r)[4]) { copy4(r, qf[kk]); },
        [&](int kk, int np, uint32_t(&r)[4]) {
          ldsm_x4(r, K + np * 16 * LD + kk * 16 + b_off);
        });
    gemm_pipe<T, DP / 16, NT / 2, 4>(
        dp,
        [&](int kk, uint32_t(&r)[4]) {
          if constexpr (C::HOLD_DO)
            copy4(r, dof[kk]);
          else
            ldsm_x4(r, dOs + kk * 16 + a_off);
        },
        [&](int kk, int np, uint32_t(&r)[4]) {
          ldsm_x4(r, V + np * 16 * LD + kk * 16 + b_off);
        });
    // p = exp(s scale - lse), masked only on tiles that a mask touches;
    // ds = p (dp - delta) scale in place of s
    const int k0 = kt * BN, k_valid = min(BN, a.sk - k0);
    const bool need =
        k_valid < BN || a.qseg != nullptr ||
        (a.causal && k0 + BN - 1 > q0 + off) ||
        (a.window && q0 + q_valid - 1 + off - k0 >= a.window);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t4 + (e & 1), r = r0 + (e >> 1) * 8;
        float p = ex2(fmaf(s[nt][e], sl2, -lse2[e >> 1]));
        if (need && (c >= k_valid || masked(a, q0 + r, k0 + c, qsg[r], ks[c])))
          p = 0.f;
        s[nt][e] = p * (dp[nt][e] - dl[e >> 1]) * a.scale;
      }
    // dq += dS K: ds, rounded to T in registers, is the A operand
    uint32_t da[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) acc_to_a<T>(da[kk], s, kk);
    gemm_pipe<T, BN / 16, DT / 2, 4>(
        dq, [&](int kk, uint32_t(&r)[4]) { copy4(r, da[kk]); },
        [&](int kk, int dpi, uint32_t(&r)[4]) {
          ldsm_x4_t(r, K + kk * 16 * LD + dpi * 16 + bt_off);
        });
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: dq through the Q tile to 16-byte stores
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int c = i * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(Qs + r0 * LD + c) =
        pack2<T>(dq[i][0], dq[i][1]);
    *reinterpret_cast<uint32_t*>(Qs + (r0 + 8) * LD + c) =
        pack2<T>(dq[i][2], dq[i][3]);
  }
  __syncthreads();
  T* dqp = static_cast<T*>(a.out0) + qofs;
  constexpr int VPR = DP / 8;
  for (int e = tid; e < BM * VPR; e += NTH) {
    const int r = e / VPR, c = (e % VPR) * 8;
    if (r < q_valid && c < a.d)
      *reinterpret_cast<uint4*>(dqp + r * qrow + c) =
          *reinterpret_cast<const uint4*>(Qs + r * LD + c);
  }
}

// dk/dv geometry: 8 warps, each owning 16 of the kv tile's 128 keys and
// their dK, dV rows in registers; q tiles of 64 rows (Q, dO, lse, delta,
// segment ids) in a two-stage ring. FUSED adds the T-typed dS^T tile and
// a float32 [64, DP] staging tile of the dq partial.
template <typename T, int DP>
struct BwdCfg {
  static constexpr int kThreads = 256, BN = 128, BQ = 64;
  // the fused dq product's warps: QG groups of 16 queries x CG column
  // blocks of DW columns
  static constexpr int QG = BQ / 16, CG = 8 / QG, DW = DP / CG;
  static_assert(DW % 16 == 0, "dq column blocks of whole 16-column pairs");
  static constexpr int LD = DP + 8;   // K, V, Q, dO tiles (T)
  static constexpr int LDS = BQ + 8;  // dS^T tile (T)
  static constexpr int LDP = DP + 4;  // dq partial tile (float32)
  static constexpr size_t kKV = al128(size_t(BN) * LD * sizeof(T));
  static constexpr size_t kQ = al128(size_t(BQ) * LD * sizeof(T));
  static constexpr size_t kRow = al128(BQ * 4);
  static constexpr size_t kStage = 2 * kQ + 3 * kRow;  // Q dO | lse delta qseg
  static constexpr size_t kKseg = al128(BN * 4);
  static constexpr size_t kBase = 2 * kKV + kKseg + 2 * kStage;
  static constexpr size_t kDs = al128(size_t(BN) * LDS * sizeof(T));
  static constexpr size_t kPart = al128(size_t(BQ) * LDP * 4);
  static constexpr size_t kFused = kBase + kDs + kPart;
  static_assert(kFused <= 232448, "shared memory over the per-block limit");
};

template <typename T, int DP, bool FUSED>
__global__ void __launch_bounds__(256, 1) dkv_kernel(Args a) {
  using C = BwdCfg<T, DP>;
  constexpr int BN = C::BN, BQ = C::BQ, LD = C::LD, LDS = C::LDS,
                LDP = C::LDP, NQ = BQ / 8, DT = DP / 8, NTH = C::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sp = smem;
  T* Ks = reinterpret_cast<T*>(carve(sp, C::kKV));
  T* Vs = reinterpret_cast<T*>(carve(sp, C::kKV));
  int* ksg = reinterpret_cast<int*>(carve(sp, C::kKseg));
  // stage s at ring + s * kStage: Q, dO (T), lse, delta (float32), qseg
  unsigned char* const ring = carve(sp, 2 * C::kStage);
  auto q_of = [&](int s) { return reinterpret_cast<T*>(ring + s * C::kStage); };
  auto do_of = [&](int s) {
    return reinterpret_cast<T*>(ring + s * C::kStage + C::kQ);
  };
  auto row_of = [&](int s, int which) {
    return ring + s * C::kStage + 2 * C::kQ + which * C::kRow;
  };
  T* dSs = FUSED ? reinterpret_cast<T*>(carve(sp, C::kDs)) : nullptr;
  float* Part = FUSED ? reinterpret_cast<float*>(carve(sp, C::kPart)) : nullptr;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane >> 2, t4 = lane & 3;
  // two-pass: grid (kv tiles, b * hk), a head's kv tiles side by side
  // sharing its Q and dO in L2; FUSED: grid (b * hk, spans), the low
  // spans (the heaviest causal work) first
  const int bg = FUSED ? blockIdx.x : blockIdx.y;
  const int b = bg / a.hk, g = bg % a.hk;
  const int off = a.sk - a.sq;
  const int span_lo = FUSED ? blockIdx.y * a.span : blockIdx.x * BN;
  const int span_hi = min(a.sk, span_lo + (FUSED ? a.span : BN));
  const size_t qrow = static_cast<size_t>(a.hq) * a.d;
  const size_t kvrow = static_cast<size_t>(a.hk) * a.d;
  T* dk_out = static_cast<T*>(FUSED ? a.out1 : a.out0);
  T* dv_out = static_cast<T*>(FUSED ? a.out2 : a.out1);
  const size_t pld = static_cast<size_t>(a.hq) * DP;  // partial row stride
  const float sl2 = a.scale * kLog2e;
  const int kr = warp * 16;  // the warp's keys in the tile
  const int a_off = (kr + a_row(lane)) * LD + a_col(lane);
  const int b_off = b_row(lane) * LD + b_col(lane);
  const int bt_off = bt_row(lane) * LD + bt_col(lane);

  for (int k0 = span_lo; k0 < span_hi; k0 += BN) {
    const int k_valid = min(BN, span_hi - k0);
    const size_t kofs = (static_cast<size_t>(b) * a.sk + k0) * kvrow +
                        static_cast<size_t>(g) * a.d;
    load_tile_async<T, BN, DP, LD, NTH>(
        Ks, static_cast<const T*>(a.k) + kofs, kvrow, k_valid, a.d);
    load_tile_async<T, BN, DP, LD, NTH>(
        Vs, static_cast<const T*>(a.v) + kofs, kvrow, k_valid, a.d);
    if (a.kseg != nullptr)
      for (int c = tid; c < BN; c += NTH) {
        const int* src = a.kseg + static_cast<size_t>(b) * a.sk + k0 + c;
        cp_async4(ksg + c, c < k_valid ? src : a.kseg, c < k_valid);
      }
    // the q rows that see a key of this tile, in q tiles of BQ rows, for
    // each query head of the group: steps = rep * nq, heads outermost
    int q_lo = 0, q_hi = a.sq;
    if (a.causal) q_lo = max(0, k0 - off);
    if (a.window) q_hi = min(a.sq, k0 + k_valid - 1 - off + a.window);
    const int qt_lo = q_lo / BQ;
    const int nq = q_hi > q_lo ? (q_hi + BQ - 1) / BQ - qt_lo : 0;
    const int steps = a.rep * nq;
    auto load_q = [&](int step, int st) {
      const int h = g * a.rep + step / nq;
      const int q0 = (qt_lo + step % nq) * BQ;
      const int qv = min(BQ, a.sq - q0);
      const size_t qofs = (static_cast<size_t>(b) * a.sq + q0) * qrow +
                          static_cast<size_t>(h) * a.d;
      load_tile_async<T, BQ, DP, LD, NTH>(
          q_of(st), static_cast<const T*>(a.q) + qofs, qrow, qv, a.d);
      load_tile_async<T, BQ, DP, LD, NTH>(
          do_of(st), static_cast<const T*>(a.dout) + qofs, qrow, qv, a.d);
      const size_t row = (static_cast<size_t>(b) * a.hq + h) * a.sq + q0;
      for (int c = tid; c < 3 * BQ; c += NTH) {
        const int r = c % BQ, which = c / BQ;
        const bool ok = r < qv && (which < 2 || a.qseg != nullptr);
        const void* src =
            which == 0 ? static_cast<const void*>(a.lse_in + row + r)
            : which == 1
                ? static_cast<const void*>(a.delta + row + r)
                : static_cast<const void*>(
                      a.qseg + static_cast<size_t>(b) * a.sq + q0 + r);
        cp_async4(row_of(st, which) + 4 * r, ok ? src : a.lse_in, ok);
      }
    };
    if (steps > 0) load_q(0, 0);
    cp_async_commit();

    float dk[DT][4], dv[DT][4];
#pragma unroll
    for (int i = 0; i < DT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

    for (int step = 0; step < steps; ++step) {
      const int st = step & 1;
      const int h = g * a.rep + step / nq;
      const int q0 = (qt_lo + step % nq) * BQ;
      float* part = nullptr;
      if constexpr (FUSED) {
        // this q tile's float32 partial, read early: its latency hides
        // behind the S and dP products
        part = static_cast<float*>(a.out0) +
               ((static_cast<size_t>(blockIdx.y) * a.b + b) * a.sq_pad + q0) *
                   pld +
               static_cast<size_t>(h) * DP;
        for (int e = tid; e < BQ * DP / 4; e += NTH) {
          const int r = e / (DP / 4), c = (e % (DP / 4)) * 4;
          cp_async16(Part + r * LDP + c, part + r * pld + c, true);
        }
        cp_async_commit();
      }
      if (step + 1 < steps) load_q(step + 1, st ^ 1);
      cp_async_commit();
      if constexpr (FUSED)
        cp_async_wait<2>();
      else
        cp_async_wait<1>();
      __syncthreads();
      const T* Q = q_of(st);
      const T* dO = do_of(st);
      const float* lse = reinterpret_cast<const float*>(row_of(st, 0));
      const float* del = reinterpret_cast<const float*>(row_of(st, 1));
      const int* qsg = reinterpret_cast<const int*>(row_of(st, 2));

      // S^T = K Q^T for the warp's 16 keys and the tile's 64 queries
      float pt[NQ][4];
#pragma unroll
      for (int i = 0; i < NQ; ++i)
        pt[i][0] = pt[i][1] = pt[i][2] = pt[i][3] = 0.f;
      gemm_pipe<T, DP / 16, NQ / 2, 4>(
          pt,
          [&](int kk, uint32_t(&r)[4]) {
            ldsm_x4(r, Ks + kk * 16 + a_off);
          },
          [&](int kk, int np, uint32_t(&r)[4]) {
            ldsm_x4(r, Q + np * 16 * LD + kk * 16 + b_off);
          });
      // p = exp(s - lse), masked only on tiles that a mask touches
      const bool need =
          k_valid < BN || q0 + BQ > a.sq || a.qseg != nullptr ||
          (a.causal && k0 + BN - 1 > q0 + off) ||
          (a.window && min(q0 + BQ, a.sq) - 1 + off - k0 >= a.window);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + 2 * t4 + (e & 1);
          const int kl = kr + gq + (e >> 1) * 8;
          float p = ex2(fmaf(pt[nt][e], sl2, -lse[c] * kLog2e));
          if (need && (kl >= k_valid || q0 + c >= a.sq ||
                       masked(a, q0 + c, k0 + kl, qsg[c], ksg[kl])))
            p = 0.f;
          pt[nt][e] = p;
        }
      // dP^T = V dO^T, then ds = p (dp - delta) scale in place
      float dst[NQ][4];
#pragma unroll
      for (int i = 0; i < NQ; ++i)
        dst[i][0] = dst[i][1] = dst[i][2] = dst[i][3] = 0.f;
      gemm_pipe<T, DP / 16, NQ / 2, 4>(
          dst,
          [&](int kk, uint32_t(&r)[4]) {
            ldsm_x4(r, Vs + kk * 16 + a_off);
          },
          [&](int kk, int np, uint32_t(&r)[4]) {
            ldsm_x4(r, dO + np * 16 * LD + kk * 16 + b_off);
          });
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + 2 * t4 + (e & 1);
          dst[nt][e] =
              pt[nt][e] * (dst[nt][e] - del[c]) * a.scale;
        }
      // dV += P^T dO and dK += dS^T Q: P^T and dS^T, rounded to T, are
      // already the A operands in registers
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        acc_to_a<T>(pa[kk], pt, kk);
        acc_to_a<T>(da[kk], dst, kk);
      }
      gemm_pipe<T, BQ / 16, DT / 2, 4>(
          dv, [&](int kk, uint32_t(&r)[4]) { copy4(r, pa[kk]); },
          [&](int kk, int dp, uint32_t(&r)[4]) {
            ldsm_x4_t(r, dO + kk * 16 * LD + dp * 16 + bt_off);
          });
      gemm_pipe<T, BQ / 16, DT / 2, 4>(
          dk, [&](int kk, uint32_t(&r)[4]) { copy4(r, da[kk]); },
          [&](int kk, int dp, uint32_t(&r)[4]) {
            ldsm_x4_t(r, Q + kk * 16 * LD + dp * 16 + bt_off);
          });
      if constexpr (FUSED) {
        // dS^T as a T tile, then dq = dS K (BQ queries x DP: warp w takes
        // queries 16 (w % QG).. and columns DW (w / QG)..) into a fresh
        // register accumulator, added to the staged partial, stored back
        // with 16-byte stores
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt) {
          const int c = nt * 8 + 2 * t4;
          *reinterpret_cast<uint32_t*>(dSs + (kr + gq) * LDS + c) =
              pack2<T>(dst[nt][0], dst[nt][1]);
          *reinterpret_cast<uint32_t*>(dSs + (kr + gq + 8) * LDS + c) =
              pack2<T>(dst[nt][2], dst[nt][3]);
        }
        __syncthreads();
        const int wq = (warp % C::QG) * 16, wn = (warp / C::QG) * C::DW;
        float dq[C::DW / 8][4];
#pragma unroll
        for (int i = 0; i < C::DW / 8; ++i)
          dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
        const int at_off = at_row(lane) * LDS + at_col(lane);
        gemm_pipe<T, BN / 16, C::DW / 16, 4>(
            dq,
            [&](int kk, uint32_t(&r)[4]) {
              ldsm_x4_t(r, dSs + kk * 16 * LDS + wq + at_off);
            },
            [&](int kk, int np, uint32_t(&r)[4]) {
              ldsm_x4_t(r, Ks + kk * 16 * LD + wn + np * 16 + bt_off);
            });
        cp_async_wait<1>();
        __syncthreads();
#pragma unroll
        for (int i = 0; i < C::DW / 8; ++i) {
          const int c = wn + i * 8 + 2 * t4;
          float2* p0 = reinterpret_cast<float2*>(Part + (wq + gq) * LDP + c);
          float2* p1 =
              reinterpret_cast<float2*>(Part + (wq + gq + 8) * LDP + c);
          p0->x += dq[i][0];
          p0->y += dq[i][1];
          p1->x += dq[i][2];
          p1->y += dq[i][3];
        }
        __syncthreads();
        for (int e = tid; e < BQ * DP / 4; e += NTH) {
          const int r = e / (DP / 4), c = (e % (DP / 4)) * 4;
          *reinterpret_cast<float4*>(part + r * pld + c) =
              *reinterpret_cast<const float4*>(Part + r * LDP + c);
        }
      }
      __syncthreads();  // stage st (and the dq staging) free again
    }
    cp_async_wait<0>();
    __syncthreads();
    // dK, dV through the K and V tiles to 16-byte stores
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      const int c = i * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(Ks + (kr + gq) * LD + c) =
          pack2<T>(dk[i][0], dk[i][1]);
      *reinterpret_cast<uint32_t*>(Ks + (kr + gq + 8) * LD + c) =
          pack2<T>(dk[i][2], dk[i][3]);
      *reinterpret_cast<uint32_t*>(Vs + (kr + gq) * LD + c) =
          pack2<T>(dv[i][0], dv[i][1]);
      *reinterpret_cast<uint32_t*>(Vs + (kr + gq + 8) * LD + c) =
          pack2<T>(dv[i][2], dv[i][3]);
    }
    __syncthreads();
    constexpr int VPR = DP / 8;
    for (int e = tid; e < BN * VPR; e += NTH) {
      const int r = e / VPR, c = (e % VPR) * 8;
      if (r < k_valid && c < a.d) {
        const size_t o = kofs + r * kvrow + c;
        *reinterpret_cast<uint4*>(dk_out + o) =
            *reinterpret_cast<const uint4*>(Ks + r * LD + c);
        *reinterpret_cast<uint4*>(dv_out + o) =
            *reinterpret_cast<const uint4*>(Vs + r * LD + c);
      }
    }
    __syncthreads();  // before the next kv tile's loads
  }
}

enum Pass { kFwd = 0, kDq = 1, kDkv = 2, kFused = 3 };

template <typename KernelT>
cudaError_t launch_kernel(KernelT kernel, dim3 grid, int threads,
                          size_t smem, const Args& a, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

// The redesigned kernels take 16-bit T at DP 64 and 128; float32 and DP
// 256 keep the first version's bodies (fwd_kernel_v1, dq_kernel_v1,
// dkv_kernel_v1).
template <typename T, int DP>
constexpr bool kRedesigned = !std::is_same<T, float>::value && DP <= 128;

template <typename T, int DP>
cudaError_t launch_dp(int pass, const Args& a, cudaStream_t st) {
  using G = Geo<T, DP>;
  constexpr int B = G::B;
  if constexpr (kRedesigned<T, DP>) {
    using F = FwdCfg<T, DP>;
    using Q = DqCfg<T, DP>;
    using W = BwdCfg<T, DP>;
    if (pass == kDq) {
      const dim3 grid((a.sq + Q::BM - 1) / Q::BM, a.b * a.hq);
      return launch_kernel(dq_kernel<T, DP>, grid, Q::kThreads, Q::kSmem, a,
                           st);
    }
    if (pass == kFwd) {
      const dim3 grid((a.sq + F::BM - 1) / F::BM, a.b * a.hq);
      return launch_kernel(fwd_kernel<T, DP>, grid, F::kThreads, F::kSmem,
                           a, st);
    }
    if (pass == kDkv) {
      const dim3 grid((a.sk + W::BN - 1) / W::BN, a.b * a.hk);
      return launch_kernel(dkv_kernel<T, DP, false>, grid, W::kThreads,
                           W::kBase, a, st);
    }
    if (a.sq_pad % W::BQ != 0 || a.sq_pad < a.sq) return cudaErrorInvalidValue;
    const dim3 grid(a.b * a.hk, (a.sk + a.span - 1) / a.span);
    return launch_kernel(dkv_kernel<T, DP, true>, grid, W::kThreads,
                         W::kFused, a, st);
  } else {
    if (pass == kDq) {
      const dim3 grid((a.sq + B - 1) / B, a.b * a.hq);
      return launch_kernel(dq_kernel_v1<T, DP>, grid, kThreads, G::kDq, a,
                           st);
    }
    if (pass == kFwd) {
      const dim3 grid((a.sq + B - 1) / B, a.b * a.hq);
      return launch_kernel(fwd_kernel_v1<T, DP>, grid, kThreads, G::kFwd, a,
                           st);
    }
    if (pass == kDkv) {
      const dim3 grid((a.sk + B - 1) / B, a.b * a.hk);
      return launch_kernel(dkv_kernel_v1<T, DP, false>, grid, kThreads,
                           G::kDkv, a, st);
    }
    if (a.sq_pad % B != 0 || a.sq_pad < a.sq) return cudaErrorInvalidValue;
    const dim3 grid((a.sk + a.span - 1) / a.span, a.b * a.hk);
    return launch_kernel(dkv_kernel_v1<T, DP, true>, grid, kThreads,
                         G::kDkv, a, st);
  }
}

int padded_dim(int d) { return d <= 64 ? 64 : (d <= 128 ? 128 : 256); }

template <typename T, int DP>
int smem_dp(int pass) {
  using G = Geo<T, DP>;
  if constexpr (kRedesigned<T, DP>) {
    if (pass == kFwd) return static_cast<int>(FwdCfg<T, DP>::kSmem);
    if (pass == kDq) return static_cast<int>(DqCfg<T, DP>::kSmem);
    return static_cast<int>(pass == kDkv ? BwdCfg<T, DP>::kBase
                                         : BwdCfg<T, DP>::kFused);
  } else {
    if (pass == kDq) return static_cast<int>(G::kDq);
    return static_cast<int>(pass == kFwd ? G::kFwd : G::kDkv);
  }
}

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

extern "C" int PT_CAT(pt_flash_smem_, PT_FA_TAG)(int pass, int dp) {
  using T = PT_FA_T;
  if (dp == 64) return smem_dp<T, 64>(pass);
  if (dp == 128) return smem_dp<T, 128>(pass);
  return smem_dp<T, 256>(pass);
}
