// Device helpers shared by the port's decode-attention kernels
// (decode_attention.cu, paged_attention.cu): element conversions, vector
// row loads, the RoPE half-rotation, the int8 quantize-on-append of one
// row, and the attention row loop with its four-warp merge.
//
// The row loop is the design of the first decode kernel: one CTA of 128
// threads per (slot, kv head, block of up to HPB query heads); each of the
// four warps walks rows j = warp (mod 4) of its stream up to L inclusive,
// its lanes splitting d (EPL elements each) with vector loads, and keeps
// its own online-softmax state (m, l, acc) per query head; the warps merge
// in shared memory at the end. Where the stream's rows live is the
// caller's: a RowAt functor maps a row index j to the row's number in its
// array, whose elements start at number * D. Int8 caches keep one float32
// scale per row and head, and both layouts place it at the same number in
// the scale array ([slots, max_len, kvh] beside [slots, max_len, kvh, D];
// [kvh, n_pages, page_size, 1] beside [kvh, n_pages, page_size, D]), so
// the one functor addresses the payload and its scale.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pt_decode {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX kernels

constexpr float kQuantEps = 1e-8f;  // KV_QUANT_EPS of the JAX kernels

// Element-type codes of q / k_new / v_new / out, shared with the wrappers.
enum ActDtype { kF32 = 0, kF16 = 1, kBF16 = 2 };

// Whether a cache element type is the int8 payload of a quantized cache.
template <typename TC>
constexpr bool kQuantCache = std::is_same<TC, int8_t>::value;

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
template <>
struct Raw<int8_t> {
  using type = signed char;
  static __device__ __forceinline__ float value(type b) {
    return static_cast<float>(b);
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
    unsigned char v1[kBytes];
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
  } else if constexpr (kBytes % 2 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 2; ++i)
      buf.v2[i] = reinterpret_cast<const unsigned short*>(p)[i];
  } else {
#pragma unroll
    for (int i = 0; i < kBytes; ++i)
      buf.v1[i] = reinterpret_cast<const unsigned char*>(p)[i];
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

// Quantize-on-append of one D-wide row held in shared memory as float32
// (the rotated key, or the value): scale = max(absmax / 127, eps) over the
// row, q = clip(rint(x / scale), -127, 127) with an IEEE division and
// round-half-to-even, as the JAX package's kernel_quant_rows. row_s is
// overwritten with the dequantized values q * scale that attention reads;
// when ``write`` is set the payload goes to dst[0..D) and the scale to
// *dst_scale. Called by every thread of the block (it synchronises);
// red_s is one float of shared scratch per warp.
template <int D>
__device__ __forceinline__ void quantize_row(float* row_s, float* red_s,
                                             int8_t* dst, float* dst_scale,
                                             bool write) {
  const int tid = threadIdx.x;
  float amax = 0.f;
  for (int c = tid; c < D; c += kThreads) amax = fmaxf(amax, fabsf(row_s[c]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (tid % 32 == 0) red_s[tid / 32] = amax;
  __syncthreads();
  amax = red_s[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, red_s[w]);
  const float scale = fmaxf(__fdiv_rn(amax, 127.f), kQuantEps);
  for (int c = tid; c < D; c += kThreads) {
    const float q =
        fminf(fmaxf(rintf(__fdiv_rn(row_s[c], scale)), -127.f), 127.f);
    row_s[c] = __fmul_rn(q, scale);
    if (write) dst[c] = static_cast<int8_t>(q);
  }
  if (write && tid == 0) *dst_scale = scale;
  __syncthreads();  // red_s is free again, row_s final
}

// Attention of the ng (<= HPB) query rows in q_s over rows 0..L of one
// (slot, kv head) stream, written to out[q_base + g * D + c] in the
// activation dtype. row_at(j) is the number of row j in kp / vp (its
// elements start at row_at(j) * D); for an int8 cache it is also the
// index of the row's scale in ks / vs, and attention reads the
// dequantized values q * scale. With kNewInShared, row L is taken from
// kn_s / vn_s (the appended row, already rounded to the cache dtype or
// quantized and dequantized) and never read from memory; without it,
// every row 0..L is read from memory. Rows past L are never read. The
// caller has filled q_s (and kn_s / vn_s) and synchronised the block.
template <typename TC, int EPL, int HPB, bool kNewInShared, typename RowAt>
__device__ __forceinline__ void attend_rows(
    const float (&q_s)[HPB][32 * EPL], const float* kn_s, const float* vn_s,
    const TC* __restrict__ kp, const TC* __restrict__ vp,
    const float* __restrict__ ks, const float* __restrict__ vs, RowAt row_at,
    int L, int ng, float scale, void* __restrict__ out, int act_dtype,
    size_t q_base) {
  constexpr int D = 32 * EPL;
  constexpr int kUnroll = EPL <= 4 ? 4 : 2;  // rows in flight per warp
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  __shared__ float m_s[kWarps][HPB];
  __shared__ float l_s[kWarps][HPB];
  __shared__ float acc_s[kWarps][HPB][D];

  // each lane keeps its d-slice of the query rows
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

  // online softmax over this warp's rows j = warp (mod 4), j <= L
  const int last_loaded = kNewInShared ? L - 1 : L;
  const TC* klane = kp + lane * EPL;
  const TC* vlane = vp + lane * EPL;
  for (int j0 = warp; j0 <= L; j0 += kWarps * kUnroll) {
    float kf[kUnroll][EPL];
    float vf[kUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kWarps;
      if (j <= last_loaded) {
        const size_t row = row_at(j);
        load_row<TC, EPL>(klane + row * D, kf[u]);
        load_row<TC, EPL>(vlane + row * D, vf[u]);
        if constexpr (kQuantCache<TC>) {
          const float ksc = __ldg(ks + row);
          const float vsc = __ldg(vs + row);
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            kf[u][e] = __fmul_rn(kf[u][e], ksc);
            vf[u][e] = __fmul_rn(vf[u][e], vsc);
          }
        }
      } else if (kNewInShared && j == L) {
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

  // merge the four warps' partial softmax states
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
    if (denom == 0.f) denom = 1.f;  // the JAX kernels' l == 0 -> 1 guard
    store_act(out, act_dtype, q_base + static_cast<size_t>(g) * D + c,
              o / denom);
  }
}

}  // namespace pt_decode
