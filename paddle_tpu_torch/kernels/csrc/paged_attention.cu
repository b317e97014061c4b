// Decode attention over the head-major paged KV pool, for NVIDIA Hopper
// (sm_90a). Two kernels:
//
// - fused (replaces paddle_tpu/kernels/paged_attention.py:
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
// - block-table (replaces paddle_tpu/kernels/paged_attention.py:
//   _decode_kernel, reached through paged_decode_attention): the same
//   attention over rows 0..seq_lens[s] of an already-appended float pool,
//   with no RoPE and no append. As in the JAX package, it has no int8
//   path: int8 pools decode through the fused kernel.
//
// Row j of slot s, kv head h lives at
//   pool + ((h * n_pages + bt[s, j / page_size]) * page_size
//           + j % page_size) * d.
// Pages past seq_lens[s] / page_size are never read.
//
// What bounds it: memory bandwidth, as for the contiguous kernel. Per layer
// and step it reads sum_s (seq_lens[s] + 1) * kvh * d * 2 pool elements and
// one block-table entry per page, and does about four floating-point
// operations per element read.
//
// Design of the fused kernel: split-K flash decoding, split_decode_kernel
// in decode_common.cuh, shared with the contiguous kernel. Each (slot, kv
// head, block of up to 8 query heads) stream runs on a cluster of R CTAs
// (paged_attention.py: _decode_plan), each rank on a tile-aligned share of
// rows 0..L computed on the device; a warp's 8-row tile reads its rows'
// page ids once, one tile ahead of the cp.async copies that stage it in
// shared memory, so pages of any size and order are read row by row in
// 16-byte pieces. The kernel never reads back the row it appends: the
// rank that owns row L rebuilds it from k_new / v_new, and only that
// rank's first head block writes it. So inactive slots, which all append
// to the sink page 0 at row 0 in the same launch, race only on a row (and,
// int8, its scale) that nobody reads.
//
// Design of the block-table kernel (the first version's, not yet
// redesigned): attend_rows in decode_common.cuh, one CTA of 128 threads
// per (slot, kv head, block of up to 8 query heads), each row addressed
// through the block table (an L1-resident int32 per row).
//
// Out-of-range indices are clamped as the Pallas index maps clamp them:
// seq_lens to the table's span, page ids to the pool, positions to the rope
// table. The engine guarantees all three are in range.
//
// Built once per element type of the pool (float, __half, __nv_bfloat16,
// int8_t): compile with -DPT_CACHE_T=<type> -DPT_CACHE_TAG=<suffix>, and
// -DPT_CACHE_INT8 for int8_t; the exported C functions are
// pt_fused_paged_decode_<suffix>, pt_fused_paged_decode_plan_<suffix> (a
// plan's shared memory and the clusters the card holds at once) and, for
// float pools, pt_paged_decode_<suffix>. k_scale and v_scale must be null
// for a float pool and set for int8. The launches return
// cudaErrorInvalidValue for what they do not take, else cudaGetLastError()
// after the launch.

#include "decode_common.cuh"

#ifndef PT_CACHE_T
#error "compile with -DPT_CACHE_T=<cache element type> -DPT_CACHE_TAG=<tag>"
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

// The block-table kernel's arguments.
struct PagedArgs {
  const void* q;
  int act_dtype;
  const void* k_pages;
  const void* v_pages;
  const int* bt;
  const int* seq_lens;
  void* out;
  int kvh, group, n_pages, page_size, max_pages;
  float scale;
};

template <typename TC, int EPL, int HPB>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(PagedArgs a) {
  constexpr int D = 32 * EPL;
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int g0 = blockIdx.z * HPB;
  const int ng = min(HPB, a.group - g0);
  const int tid = threadIdx.x;
  const TC* kp = static_cast<const TC*>(a.k_pages);
  const TC* vp = static_cast<const TC*>(a.v_pages);

  __shared__ float q_s[HPB][D];

  const int L = max(0, min(a.seq_lens[s], a.max_pages * a.page_size - 1));
  const PagedRows rows{a.bt + static_cast<size_t>(s) * a.max_pages,
                       static_cast<size_t>(h) * a.n_pages, a.page_size,
                       a.n_pages};
  const size_t q_base =
      ((static_cast<size_t>(s) * a.kvh + h) * a.group + g0) * D;

  // 1. the query rows of this head block, as they are.
  for (int i = tid; i < ng * D; i += kThreads)
    q_s[i / D][i % D] = load_act(a.q, a.act_dtype, q_base + i);
  __syncthreads();

  // 2-4. online softmax over rows 0..L, merge of the four warps, output in
  //      the query's dtype.
  attend_rows<TC, EPL, HPB, false>(q_s, nullptr, nullptr, kp, vp, nullptr,
                                   nullptr, rows, L, ng, a.scale, a.out,
                                   a.act_dtype, q_base);
}

template <typename TC, int EPL>
cudaError_t launch_epl(int hpb, dim3 grid, cudaStream_t stream,
                       const PagedArgs& a) {
#define PT_LAUNCH(HPB) \
  paged_decode_kernel<TC, EPL, HPB><<<grid, kThreads, 0, stream>>>(a)
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

#ifndef PT_CACHE_INT8
extern "C" int PT_CAT(pt_paged_decode_, PT_CACHE_TAG)(
    const void* q, int act_dtype, const void* k_pages, const void* v_pages,
    const int* bt, const int* seq_lens, void* out, int slots, int kvh,
    int group, int d, int n_pages, int page_size, int max_pages, float scale,
    void* stream) {
  using TC = PT_CACHE_T;
  if (d < 32 || d > 256 || d % 32 != 0 || group < 1 || group > 16 ||
      slots < 1 || kvh < 1 || n_pages < 1 || page_size < 1 ||
      max_pages < 1 || act_dtype < 0 || act_dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  PagedArgs a{};  // no rope table, no new row: the pools are only read
  a.q = q;
  a.act_dtype = act_dtype;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.bt = bt;
  a.seq_lens = seq_lens;
  a.out = out;
  a.kvh = kvh;
  a.group = group;
  a.n_pages = n_pages;
  a.page_size = page_size;
  a.max_pages = max_pages;
  a.scale = scale;
  const int hpb = heads_per_block(group);
  const dim3 grid(kvh, slots, (group + hpb - 1) / hpb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define PT_EPL(E)                                 \
  case E:                                         \
    err = launch_epl<TC, E>(hpb, grid, st, a);    \
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
#endif  // PT_CACHE_INT8
