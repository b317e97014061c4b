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
// Design: split-K flash decoding, split_decode_kernel in decode_common.cuh
// (shared with the paged kernels, which differ in where a row lives, and
// for row 3 in reading every row from the pool with no RoPE or append).
// Each (slot, kv head, block of up to 8 query heads) stream runs on a
// thread-block cluster of R CTAs, R from the launch plan
// (decode_attention.py: _decode_plan, from the host's shapes and the
// card's occupancy, never from seq_lens); each rank takes a tile-aligned
// share of rows 0..L computed on the device, its warps (8, or 4 for rows
// over 512 bytes) stream 8-row K/V tiles through rings of cp.async buffers
// and take one max and one rescale a tile, and the ranks merge (m, l, acc)
// in rank order through distributed shared memory. The first version (one
// CTA a stream, each warp walking single rows with a shuffle-reduced dot,
// two expf and a rescale per row) left most SMs idle at few slots or long
// contexts.
//
// Row j of slot s, kv head h is row number (s * max_len + j) * kvh + h of
// the [slots, max_len, kvh, d] cache; its int8 scale has the same number
// in the [slots, max_len, kvh] scale array.
//
// Built once per element type of the cache (float, __half, __nv_bfloat16,
// int8_t): compile with -DPT_CACHE_T=<type> -DPT_CACHE_TAG=<suffix>; the
// exported C functions are pt_fused_contig_decode_<suffix> (k_scale and
// v_scale null for a float cache and set for int8; returns
// cudaErrorInvalidValue for what it does not take, else
// cudaGetLastError() after the launch) and pt_fused_contig_decode_plan_
// <suffix> (a plan's shared memory and how many of its clusters the card
// holds at once).

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
  static constexpr bool kFused = true;  // RoPE, append and attention
  size_t base;    // (s * max_len) * kvh + h
  size_t stride;  // kvh
  __device__ __forceinline__ size_t operator()(int j) const {
    return base + static_cast<size_t>(j) * stride;
  }
  static __device__ __forceinline__ ContigRows of(const SplitArgs& a, int s,
                                                  int h) {
    return {static_cast<size_t>(s) * a.max_len * a.kvh + h,
            static_cast<size_t>(a.kvh)};
  }
};

}  // namespace

extern "C" int PT_CAT(pt_fused_contig_decode_, PT_CACHE_TAG)(
    const void* q, const void* k_new, const void* v_new, int act_dtype,
    void* ck, void* cv, void* k_scale, void* v_scale, const int* seq_lens,
    const int* positions, const float* cos_t, const float* sin_t, void* out,
    int slots, int kvh, int group, int d, int max_len, int max_pos,
    float scale, int ranks, void* stream) {
  SplitArgs a{};
  a.q = q;
  a.k_new = k_new;
  a.v_new = v_new;
  a.act_dtype = act_dtype;
  a.k = ck;
  a.v = cv;
  a.k_scale = static_cast<float*>(k_scale);
  a.v_scale = static_cast<float*>(v_scale);
  a.seq_lens = seq_lens;
  a.positions = positions;
  a.cos_t = cos_t;
  a.sin_t = sin_t;
  a.out = out;
  a.kvh = kvh;
  a.group = group;
  a.max_pos = max_pos;
  a.span = max_len;
  a.scale = scale;
  a.max_len = max_len;
  return launch_split<PT_CACHE_T, ContigRows>(
      a, slots, d, ranks,
      static_cast<long long>(slots) * max_len * kvh, stream);
}

extern "C" int PT_CAT(pt_fused_contig_decode_plan_, PT_CACHE_TAG)(
    int group, int d, int ranks, int* smem_out, int* clusters_out) {
  return split_plan<PT_CACHE_T, ContigRows>(group, d, ranks, smem_out,
                                            clusters_out);
}
