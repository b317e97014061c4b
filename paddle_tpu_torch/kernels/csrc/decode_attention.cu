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
//      the TPU kernel does, so the fused and unfused paths see the same row;
//      an int8 cache (the int8 branch of the TPU kernel) instead quantizes
//      the row per head (scale = max(absmax / 127, 1e-8) over d, round half
//      to even), writes payload and scale ([slots, max_len, kvh] float32)
//      together, and attends with the dequantized values,
//   3. runs an online softmax over rows 0..seq_lens[i] inclusive with
//      float32 accumulation and writes the output in the query's dtype.
//
// What bounds it: memory bandwidth. Per layer and step it reads
// sum_i (seq_lens[i] + 1) * kvh * d * 2 cache elements (int8: one byte
// each plus one float32 scale per row and head) and does about four
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
// block of each (slot, kv head) writes it. The row loop and the merge are
// attend_rows in decode_common.cuh, shared with the paged kernels.
//
// Later redesign: split-K flash-decoding so that few slots still fill all
// 132 SMs, cp.async or TMA staging of K/V tiles, and CUDA-graph capture of
// the decode step.
//
// Built once per element type of the cache (float, __half, __nv_bfloat16,
// int8_t): compile with -DPT_CACHE_T=<type> -DPT_CACHE_TAG=<suffix>; the
// exported C function is pt_fused_contig_decode_<suffix>. k_scale and
// v_scale must be null for a float cache and set for int8. Returns
// cudaGetLastError() after the launch.

#include "decode_common.cuh"

#ifndef PT_CACHE_T
#error "compile with -DPT_CACHE_T=<cache element type> -DPT_CACHE_TAG=<tag>"
#endif

#define PT_CAT2(a, b) a##b
#define PT_CAT(a, b) PT_CAT2(a, b)

namespace {

using namespace pt_decode;

// Number of row j of slot s, kv head h in a [slots, max_len, kvh, D]
// cache (its elements start at number * D); also the index of its scale
// in a [slots, max_len, kvh] scale array.
struct ContigRows {
  size_t base;    // (s * max_len) * kvh + h
  size_t stride;  // kvh
  __device__ __forceinline__ size_t operator()(int j) const {
    return base + static_cast<size_t>(j) * stride;
  }
};

template <typename TC, int EPL, int HPB>
__global__ void __launch_bounds__(kThreads)
    fused_contig_decode_kernel(const void* __restrict__ q,
                               const void* __restrict__ k_new,
                               const void* __restrict__ v_new, int act_dtype,
                               TC* __restrict__ ck, TC* __restrict__ cv,
                               float* __restrict__ ks,
                               float* __restrict__ vs,
                               const int* __restrict__ seq_lens,
                               const int* __restrict__ positions,
                               const float* __restrict__ cos_t,
                               const float* __restrict__ sin_t,
                               void* __restrict__ out, int kvh, int group,
                               int max_len, int max_pos, float scale) {
  constexpr int D = 32 * EPL;
  constexpr int HALF = D / 2;
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int g0 = blockIdx.z * HPB;
  const int ng = min(HPB, group - g0);
  const int tid = threadIdx.x;

  __shared__ float q_s[HPB][D];
  __shared__ float kn_s[D];
  __shared__ float vn_s[D];
  __shared__ float red_s[kWarps];

  // The engine guarantees 0 <= seq_lens[s] < max_len and positions[s] <
  // max_pos; out-of-range values are clamped, as the Pallas index maps and
  // XLA's gathers clamp them, so a bad index can never write outside the
  // cache.
  const int L = max(0, min(seq_lens[s], max_len - 1));
  const int pos = max(0, min(positions[s], max_pos - 1));
  const float* crow = cos_t + static_cast<size_t>(pos) * HALF;
  const float* srow = sin_t + static_cast<size_t>(pos) * HALF;

  // 1. rotate q rows of this head block; rebuild the new K/V row rounded
  //    to the cache dtype (int8: quantized), and (first head block only)
  //    append it in place.
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
  const ContigRows rows{static_cast<size_t>(s) * max_len * kvh + h,
                        static_cast<size_t>(kvh)};
  const size_t append = rows(L);
  for (int c = tid; c < D; c += kThreads) {
    const bool first = c < HALF;
    const int cc = first ? c : c - HALF;
    const float x = load_act(k_new, act_dtype, kv_base + c);
    const float xp =
        load_act(k_new, act_dtype, kv_base + (first ? c + HALF : cc));
    const float kx = rope_elem(x, xp, crow[cc], srow[cc], first);
    const float vx = load_act(v_new, act_dtype, kv_base + c);
    if constexpr (kQuantCache<TC>) {
      kn_s[c] = kx;
      vn_s[c] = vx;
    } else {
      const TC kr = from_float<TC>(kx);
      const TC vr = from_float<TC>(vx);
      kn_s[c] = to_float<TC>(kr);
      vn_s[c] = to_float<TC>(vr);
      if (blockIdx.z == 0) {
        ck[append * D + c] = kr;
        cv[append * D + c] = vr;
      }
    }
  }
  __syncthreads();
  if constexpr (kQuantCache<TC>) {
    const bool write = blockIdx.z == 0;
    quantize_row<D>(kn_s, red_s, ck + append * D, ks + append, write);
    quantize_row<D>(vn_s, red_s, cv + append * D, vs + append, write);
  }

  // 2-4. online softmax over rows 0..L (row L from shared memory), merge
  //      of the four warps, output in the query's dtype.
  attend_rows<TC, EPL, HPB, true>(q_s, kn_s, vn_s, ck, cv, ks, vs, rows, L,
                                  ng, scale, out, act_dtype, q_base);
}

template <typename TC, int EPL>
cudaError_t launch_epl(int hpb, dim3 grid, cudaStream_t stream,
                       const void* q, const void* k_new, const void* v_new,
                       int act_dtype, TC* ck, TC* cv, float* ks, float* vs,
                       const int* seq_lens,
                       const int* positions, const float* cos_t,
                       const float* sin_t, void* out, int kvh, int group,
                       int max_len, int max_pos, float scale) {
#define PT_LAUNCH(HPB)                                                    \
  fused_contig_decode_kernel<TC, EPL, HPB><<<grid, kThreads, 0, stream>>>( \
      q, k_new, v_new, act_dtype, ck, cv, ks, vs, seq_lens, positions,    \
      cos_t, sin_t, out, kvh, group, max_len, max_pos, scale)
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
    void* ck, void* cv, void* k_scale, void* v_scale, const int* seq_lens,
    const int* positions,
    const float* cos_t, const float* sin_t, void* out, int slots, int kvh,
    int group, int d, int max_len, int max_pos, float scale, void* stream) {
  using TC = PT_CACHE_T;
  if (d < 32 || d > 256 || d % 32 != 0 || group < 1 || group > 16 ||
      slots < 1 || kvh < 1 || max_len < 1 || max_pos < 1 || act_dtype < 0 ||
      act_dtype > 2 || (k_scale != nullptr) != kQuantCache<TC> ||
      (v_scale != nullptr) != kQuantCache<TC>)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hpb = group <= 1 ? 1 : group <= 2 ? 2 : group <= 4 ? 4 : 8;
  const dim3 grid(kvh, slots, (group + hpb - 1) / hpb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TC* k = static_cast<TC*>(ck);
  TC* v = static_cast<TC*>(cv);
  float* ks = static_cast<float*>(k_scale);
  float* vs = static_cast<float*>(v_scale);
  cudaError_t err;
#define PT_EPL(E)                                                          \
  case E:                                                                  \
    err = launch_epl<TC, E>(hpb, grid, st, q, k_new, v_new, act_dtype, k,  \
                            v, ks, vs, seq_lens, positions, cos_t, sin_t,  \
                            out, kvh, group, max_len, max_pos, scale);     \
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
