// Decode attention over the head-major paged KV pool, for NVIDIA Hopper
// (sm_90a). One kernel, split_decode_kernel in decode_common.cuh (shared
// with the contiguous kernel), with two row policies:
//
// - fused, PagedRows (replaces paddle_tpu/kernels/paged_attention.py:
//   _fused_decode_kernel, reached through fused_paged_decode_attention):
//   per decoder layer and decode step, for every slot s and kv head h it
//   rotates the group's query rows and the new key row (RoPE, float32) at
//   positions[s], rounds the new K/V row to the pool dtype and writes it in
//   place on page bt[s, L / page_size], row L % page_size (L = seq_lens[s]),
//   and attends rows 0..L with the rounded new row rebuilt in shared
//   memory. An int8 pool (the int8 branch of the TPU kernel) carries
//   float32 scales [kvh, n_pages, page_size, 1] indexed by the same page
//   ids: the kernel quantizes the new row per head (scale = max(absmax /
//   127, 1e-8) over d, round half to even), writes payload and scale
//   together, and attends over the dequantized rows (q * scale), the new
//   one included;
// - block-table, TableRows (replaces paddle_tpu/kernels/paged_attention.py:
//   _decode_kernel, reached through paged_decode_attention): the same
//   attention over rows 0..seq_lens[s] of an already-appended float pool,
//   every row read from the pool, with no RoPE and no append; the pool is
//   only read. As in the JAX package, it has no int8 path: int8 pools
//   decode through the fused kernel.
//
// Row j of slot s, kv head h lives at
//   pool + ((h * n_pages + bt[s, j / page_size]) * page_size
//           + j % page_size) * d.
// Pages past seq_lens[s] / page_size are never read.
//
// What bounds it: memory bandwidth, as for the contiguous kernel. Per layer
// and step it reads sum_s (seq_lens[s] + 1) * kvh * d * 2 pool elements
// (fused: the new row from k_new / v_new instead of the pool) and one
// block-table entry per page, and does about four floating-point
// operations per element read.
//
// Design: split-K flash decoding. Each (slot, kv head, block of up to 8
// query heads) stream runs on a cluster of R CTAs (decode_attention.py:
// _decode_plan, from the host's shapes and the card's occupancy), each
// rank on a tile-aligned share of rows 0..L computed on the device; a
// warp's 8-row tile reads its rows' page ids once, one tile ahead of the
// cp.async copies that stage it in shared memory, so pages of any size and
// order are read row by row in 16-byte pieces. The fused kernel never
// reads back the row it appends: the rank that owns row L rebuilds it from
// k_new / v_new, and only that rank's first head block writes it. So
// inactive slots, which all append to the sink page 0 at row 0 in the same
// launch, race only on a row (and, int8, its scale) that nobody reads. The
// block-table kernel has no owner rank: inactive slots (an all-zero table
// row, length 0) read the sink page's row 0, and nothing is written.
//
// Out-of-range indices are clamped as the Pallas index maps clamp them:
// seq_lens to the table's span, page ids to the pool, positions to the rope
// table. The engine guarantees all three are in range.
//
// Built once per element type of the pool (float, __half, __nv_bfloat16,
// int8_t) and kernel: compile with -DPT_CACHE_T=<type>
// -DPT_CACHE_TAG=<suffix> (and -DPT_CACHE_INT8 for int8_t) for the fused
// kernel, whose exported C functions are pt_fused_paged_decode_<suffix>
// and pt_fused_paged_decode_plan_<suffix>; add -DPT_PAGED_TABLE (float
// types only) for the block-table kernel, pt_paged_decode_<suffix> and
// pt_paged_decode_plan_<suffix>. A plan entry returns a plan's dynamic
// shared memory and how many of its clusters the card holds at once. For
// the fused kernel k_scale and v_scale must be null for a float pool and
// set for int8. The launches return cudaErrorInvalidValue for what they do
// not take, else cudaGetLastError() after the launch.

#include "decode_common.cuh"

#ifndef PT_CACHE_T
#error "compile with -DPT_CACHE_T=<cache element type> -DPT_CACHE_TAG=<tag>"
#endif
#if defined(PT_PAGED_TABLE) && defined(PT_CACHE_INT8)
#error "the block-table kernel reads float pools only"
#endif

#define PT_CAT2(a, b) a##b
#define PT_CAT(a, b) PT_CAT2(a, b)

namespace {

using namespace pt_decode;

// Number of row j of one (slot, kv head) stream in a [kvh, n_pages,
// page_size, D] pool, through the slot's block-table row (its elements
// start at number * D); also the index of its scale in a [kvh, n_pages,
// page_size, 1] scale array.
struct PagedRows {
  static constexpr bool kFused = true;
  const int* bt_row;  // bt + s * max_pages
  size_t head_page0;  // h * n_pages
  int page_size;
  int n_pages;
  __device__ __forceinline__ size_t operator()(int j) const {
    const int page = min(max(__ldg(bt_row + j / page_size), 0), n_pages - 1);
    return (head_page0 + page) * page_size + j % page_size;
  }
  static __device__ __forceinline__ PagedRows of(const SplitArgs& a, int s,
                                                 int h) {
    return {a.bt + static_cast<size_t>(s) * a.max_pages,
            static_cast<size_t>(h) * a.n_pages, a.page_size, a.n_pages};
  }
};

// Row j of a block-table stream: PagedRows' addressing of an
// already-appended float pool, which the kernel only reads (row 3).
struct TableRows : PagedRows {
  static constexpr bool kFused = false;
  static __device__ __forceinline__ TableRows of(const SplitArgs& a, int s,
                                                 int h) {
    return {PagedRows::of(a, s, h)};
  }
};

}  // namespace

#ifndef PT_PAGED_TABLE
extern "C" int PT_CAT(pt_fused_paged_decode_, PT_CACHE_TAG)(
    const void* q, const void* k_new, const void* v_new, int act_dtype,
    void* k_pages, void* v_pages, void* k_scale, void* v_scale,
    const int* bt, const int* seq_lens, const int* positions,
    const float* cos_t, const float* sin_t, void* out, int slots, int kvh,
    int group, int d, int n_pages, int page_size, int max_pages, int max_pos,
    float scale, int ranks, void* stream) {
  if (n_pages < 1 || page_size < 1 || max_pages < 1 ||
      static_cast<long long>(max_pages) * page_size >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  SplitArgs a{};
  a.q = q;
  a.k_new = k_new;
  a.v_new = v_new;
  a.act_dtype = act_dtype;
  a.k = k_pages;
  a.v = v_pages;
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
  a.span = max_pages * page_size;
  a.scale = scale;
  a.bt = bt;
  a.n_pages = n_pages;
  a.page_size = page_size;
  a.max_pages = max_pages;
  return launch_split<PT_CACHE_T, PagedRows>(
      a, slots, d, ranks,
      static_cast<long long>(kvh) * n_pages * page_size, stream);
}

extern "C" int PT_CAT(pt_fused_paged_decode_plan_, PT_CACHE_TAG)(
    int group, int d, int ranks, int* smem_out, int* clusters_out) {
  return split_plan<PT_CACHE_T, PagedRows>(group, d, ranks, smem_out,
                                           clusters_out);
}

#else
extern "C" int PT_CAT(pt_paged_decode_, PT_CACHE_TAG)(
    const void* q, int act_dtype, const void* k_pages, const void* v_pages,
    const int* bt, const int* seq_lens, void* out, int slots, int kvh,
    int group, int d, int n_pages, int page_size, int max_pages, float scale,
    int ranks, void* stream) {
  if (n_pages < 1 || page_size < 1 || max_pages < 1 ||
      static_cast<long long>(max_pages) * page_size >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  SplitArgs a{};  // no positions, rope table or new row: the pool is read
  a.q = q;
  a.act_dtype = act_dtype;
  a.k = const_cast<void*>(k_pages);
  a.v = const_cast<void*>(v_pages);
  a.seq_lens = seq_lens;
  a.out = out;
  a.kvh = kvh;
  a.group = group;
  a.span = max_pages * page_size;
  a.scale = scale;
  a.bt = bt;
  a.n_pages = n_pages;
  a.page_size = page_size;
  a.max_pages = max_pages;
  return launch_split<PT_CACHE_T, TableRows>(
      a, slots, d, ranks,
      static_cast<long long>(kvh) * n_pages * page_size, stream);
}

extern "C" int PT_CAT(pt_paged_decode_plan_, PT_CACHE_TAG)(
    int group, int d, int ranks, int* smem_out, int* clusters_out) {
  return split_plan<PT_CACHE_T, TableRows>(group, d, ranks, smem_out,
                                           clusters_out);
}
#endif  // PT_PAGED_TABLE
