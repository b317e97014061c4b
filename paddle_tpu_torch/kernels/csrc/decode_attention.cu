// Fused single-token decode attention over contiguous per-slot KV caches,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/kernels/decode_attention.py:
// _fused_contig_kernel (reached through fused_contiguous_decode_attention).
// Per decoder layer and decode step, for every slot i and kv head h it
//   1. rotates the group's query rows and the new key row (RoPE, Neox
//      half-rotation, float32) at the slot's position,
//   2. rounds the new K/V row to the cache dtype and writes it in place at
//      row seq_lens[i] of ck/cv, and attends with those rounded values, as
//      the TPU kernel does, so the fused and unfused paths see the same row,
//   3. runs an online softmax over rows 0..seq_lens[i] inclusive with
//      float32 accumulation and writes the output in the query's dtype.
//
// What bounds it: memory bandwidth. Per layer and step it reads
// sum_i (seq_lens[i] + 1) * kvh * d * 2 cache elements and does about four
// floating-point operations per element read, far below the card's
// operations-per-byte balance point.
//
// Design (first version, simple and right): one CTA of 128 threads per
// (slot, kv head, block of up to 8 query heads of the group). The rotated
// query rows go through shared memory into registers; each of the four
// warps walks rows j = warp (mod 4), its lanes splitting d with vector
// loads, and keeps its own (m, l, acc) per query head; the warps merge in
// shared memory at the end. The new row never round-trips through device
// memory: every CTA rebuilds it from k_new/v_new and only the first head
// block of each (slot, kv head) writes it.
//
// Later redesign: split-K flash-decoding so that few slots still fill all
// 132 SMs, cp.async or TMA staging of K/V tiles, and CUDA-graph capture of
// the decode step.
//
// Built once per element type of the cache: compile with
// -DPT_CACHE_T=<type> -DPT_CACHE_TAG=<suffix>; the exported C function is
// pt_fused_contig_decode_<suffix>. Returns cudaGetLastError() after the
// launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef PT_CACHE_T
#error "compile with -DPT_CACHE_T=<cache element type> -DPT_CACHE_TAG=<tag>"
#endif

#define PT_CAT2(a, b) a##b
#define PT_CAT(a, b) PT_CAT2(a, b)

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX kernels

// Element-type codes of q / k_new / v_new / out, shared with the wrapper.
enum ActDtype { kF32 = 0, kF16 = 1, kBF16 = 2 };

__device__ __forceinline__ float load_act(const void* p, int dtype,
                                          size_t i) {
  if (dtype == kBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dtype == kF16) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_act(void* p, int dtype, size_t i,
                                          float v) {
  if (dtype == kBF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else if (dtype == kF16)
    static_cast<__half*>(p)[i] = __float2half_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_float<__half>(__half v) {
  return __half2float(v);
}
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Raw bit pattern of one element, and its value as float.
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  using type = unsigned int;
  static __device__ __forceinline__ float value(type b) {
    return __uint_as_float(b);
  }
};
template <>
struct Raw<__half> {
  using type = unsigned short;
  static __device__ __forceinline__ float value(type b) {
    return __half2float(__ushort_as_half(b));
  }
};
template <>
struct Raw<__nv_bfloat16> {
  using type = unsigned short;
  static __device__ __forceinline__ float value(type b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
};

// N consecutive elements at p (aligned to N * sizeof(T) bytes) as floats,
// read with the widest vector load that divides the span.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  union {
    typename Raw<T>::type r[N];
    uint4 v16[(kBytes + 15) / 16];
    uint2 v8[(kBytes + 7) / 8];
    unsigned int v4[(kBytes + 3) / 4];
    unsigned short v2[(kBytes + 1) / 2];
  } buf;
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      buf.v16[i] = reinterpret_cast<const uint4*>(p)[i];
  } else if constexpr (kBytes % 8 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 8; ++i)
      buf.v8[i] = reinterpret_cast<const uint2*>(p)[i];
  } else if constexpr (kBytes % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 4; ++i)
      buf.v4[i] = reinterpret_cast<const unsigned int*>(p)[i];
  } else {
#pragma unroll
    for (int i = 0; i < kBytes / 2; ++i)
      buf.v2[i] = reinterpret_cast<const unsigned short*>(p)[i];
  }
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] = Raw<T>::value(buf.r[e]);
}

// One element of the half-rotation: out[c] for c < d/2 is
// x1*cos - x2*sin, for c >= d/2 it is x2*cos + x1*sin. Plain IEEE
// products and sums (no contraction), as the plain version computes them.
__device__ __forceinline__ float rope_elem(float x, float partner, float c,
                                           float s, bool first_half) {
  return first_half ? __fsub_rn(__fmul_rn(x, c), __fmul_rn(partner, s))
                    : __fadd_rn(__fmul_rn(x, c), __fmul_rn(partner, s));
}

template <typename TC, int EPL, int HPB>
__global__ void __launch_bounds__(kThreads)
    fused_contig_decode_kernel(const void* __restrict__ q,
                               const void* __restrict__ k_new,
                               const void* __restrict__ v_new, int act_dtype,
                               TC* __restrict__ ck, TC* __restrict__ cv,
                               const int* __restrict__ seq_lens,
                               const int* __restrict__ positions,
                               const float* __restrict__ cos_t,
                               const float* __restrict__ sin_t,
                               void* __restrict__ out, int kvh, int group,
                               int max_len, int max_pos, float scale) {
  constexpr int D = 32 * EPL;
  constexpr int HALF = D / 2;
  constexpr int kUnroll = EPL <= 4 ? 4 : 2;  // rows in flight per warp
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int g0 = blockIdx.z * HPB;
  const int ng = min(HPB, group - g0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  __shared__ float q_s[HPB][D];
  __shared__ float kn_s[D];
  __shared__ float vn_s[D];
  __shared__ float m_s[kWarps][HPB];
  __shared__ float l_s[kWarps][HPB];
  __shared__ float acc_s[kWarps][HPB][D];

  // The engine guarantees 0 <= seq_lens[s] < max_len and positions[s] <
  // max_pos; out-of-range values are clamped, as the Pallas index maps and
  // XLA's gathers clamp them, so a bad index can never write outside the
  // cache.
  const int L = max(0, min(seq_lens[s], max_len - 1));
  const int pos = max(0, min(positions[s], max_pos - 1));
  const float* crow = cos_t + static_cast<size_t>(pos) * HALF;
  const float* srow = sin_t + static_cast<size_t>(pos) * HALF;

  // 1. rotate q rows of this head block; rebuild the new K/V row rounded
  //    to the cache dtype, and (first head block only) append it in place.
  const size_t q_base =
      ((static_cast<size_t>(s) * kvh + h) * group + g0) * D;
  for (int i = tid; i < ng * D; i += kThreads) {
    const int g = i / D;
    const int c = i % D;
    const bool first = c < HALF;
    const int cc = first ? c : c - HALF;
    const size_t row = q_base + static_cast<size_t>(g) * D;
    const float x = load_act(q, act_dtype, row + c);
    const float xp = load_act(q, act_dtype, row + (first ? c + HALF : cc));
    q_s[g][c] = rope_elem(x, xp, crow[cc], srow[cc], first);
  }
  const size_t kv_base = (static_cast<size_t>(s) * kvh + h) * D;
  const size_t append =
      ((static_cast<size_t>(s) * max_len + L) * kvh + h) * D;
  for (int c = tid; c < D; c += kThreads) {
    const bool first = c < HALF;
    const int cc = first ? c : c - HALF;
    const float x = load_act(k_new, act_dtype, kv_base + c);
    const float xp =
        load_act(k_new, act_dtype, kv_base + (first ? c + HALF : cc));
    const TC kr = from_float<TC>(rope_elem(x, xp, crow[cc], srow[cc], first));
    const TC vr = from_float<TC>(load_act(v_new, act_dtype, kv_base + c));
    kn_s[c] = to_float<TC>(kr);
    vn_s[c] = to_float<TC>(vr);
    if (blockIdx.z == 0) {
      ck[append + c] = kr;
      cv[append + c] = vr;
    }
  }
  __syncthreads();

  // 2. each lane keeps its d-slice of the rotated query rows.
  float qr[HPB][EPL];
  float m[HPB], l[HPB], acc[HPB][EPL];
#pragma unroll
  for (int g = 0; g < HPB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[g][e] = g < ng ? q_s[g][lane * EPL + e] : 0.f;
      acc[g][e] = 0.f;
    }
  }

  // 3. online softmax over this warp's rows j = warp (mod 4), j <= L.
  const size_t row_stride = static_cast<size_t>(kvh) * D;
  const TC* kbase = ck + (static_cast<size_t>(s) * max_len * kvh + h) * D +
                    lane * EPL;
  const TC* vbase = cv + (static_cast<size_t>(s) * max_len * kvh + h) * D +
                    lane * EPL;
  for (int j0 = warp; j0 <= L; j0 += kWarps * kUnroll) {
    float kf[kUnroll][EPL];
    float vf[kUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kWarps;
      if (j < L) {
        load_row<TC, EPL>(kbase + j * row_stride, kf[u]);
        load_row<TC, EPL>(vbase + j * row_stride, vf[u]);
      } else if (j == L) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          kf[u][e] = kn_s[lane * EPL + e];
          vf[u][e] = vn_s[lane * EPL + e];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u * kWarps > L) break;
#pragma unroll
      for (int g = 0; g < HPB; ++g) {
        if (g >= ng) break;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qr[g][e], kf[u][e], dot);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const float sc = dot * scale;
        const float m_new = fmaxf(m[g], sc);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(sc - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[g][e] = fmaf(p, vf[u][e], acc[g][e] * alpha);
        m[g] = m_new;
      }
    }
  }

  // 4. merge the four warps' partial softmax states.
#pragma unroll
  for (int g = 0; g < HPB; ++g) {
    if (lane == 0) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc_s[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = tid; i < ng * D; i += kThreads) {
    const int g = i / D;
    const int c = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    float denom = 0.f;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_s[w][g] - mx);
      denom += l_s[w][g] * f;
      o += acc_s[w][g][c] * f;
    }
    if (denom == 0.f) denom = 1.f;
    store_act(out, act_dtype, q_base + static_cast<size_t>(g) * D + c,
              o / denom);
  }
}

template <typename TC, int EPL>
cudaError_t launch_epl(int hpb, dim3 grid, cudaStream_t stream,
                       const void* q, const void* k_new, const void* v_new,
                       int act_dtype, TC* ck, TC* cv, const int* seq_lens,
                       const int* positions, const float* cos_t,
                       const float* sin_t, void* out, int kvh, int group,
                       int max_len, int max_pos, float scale) {
#define PT_LAUNCH(HPB)                                                    \
  fused_contig_decode_kernel<TC, EPL, HPB><<<grid, kThreads, 0, stream>>>( \
      q, k_new, v_new, act_dtype, ck, cv, seq_lens, positions, cos_t,     \
      sin_t, out, kvh, group, max_len, max_pos, scale)
  switch (hpb) {
    case 1: PT_LAUNCH(1); break;
    case 2: PT_LAUNCH(2); break;
    case 4: PT_LAUNCH(4); break;
    case 8: PT_LAUNCH(8); break;
    default: return cudaErrorInvalidValue;
  }
#undef PT_LAUNCH
  return cudaGetLastError();
}

}  // namespace

extern "C" int PT_CAT(pt_fused_contig_decode_, PT_CACHE_TAG)(
    const void* q, const void* k_new, const void* v_new, int act_dtype,
    void* ck, void* cv, const int* seq_lens, const int* positions,
    const float* cos_t, const float* sin_t, void* out, int slots, int kvh,
    int group, int d, int max_len, int max_pos, float scale, void* stream) {
  using TC = PT_CACHE_T;
  if (d < 32 || d > 256 || d % 32 != 0 || group < 1 || group > 16 ||
      slots < 1 || kvh < 1 || max_len < 1 || max_pos < 1 || act_dtype < 0 ||
      act_dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hpb = group <= 1 ? 1 : group <= 2 ? 2 : group <= 4 ? 4 : 8;
  const dim3 grid(kvh, slots, (group + hpb - 1) / hpb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TC* k = static_cast<TC*>(ck);
  TC* v = static_cast<TC*>(cv);
  cudaError_t err;
#define PT_EPL(E)                                                          \
  case E:                                                                  \
    err = launch_epl<TC, E>(hpb, grid, st, q, k_new, v_new, act_dtype, k,  \
                            v, seq_lens, positions, cos_t, sin_t, out, kvh, \
                            group, max_len, max_pos, scale);               \
    break
  switch (d / 32) {
    PT_EPL(1);
    PT_EPL(2);
    PT_EPL(3);
    PT_EPL(4);
    PT_EPL(5);
    PT_EPL(6);
    PT_EPL(7);
    PT_EPL(8);
    default:
      err = cudaErrorInvalidValue;
  }
#undef PT_EPL
  return static_cast<int>(err);
}
