// Device helpers and the one decode-attention kernel of the port's rows
// 1-3 (decode_attention.cu, paged_attention.cu): element conversions,
// vector row loads, the RoPE half-rotation, the int8 quantize-on-append of
// one row, and the split-K decode kernel (split_decode_kernel, with its
// launch and occupancy entries).
//
// Where a stream's rows live is the caller's: a row policy maps a row index
// j to the row's number in its array, whose elements start at number * D.
// Int8 caches keep one float32 scale per row and head, and both layouts
// place it at the same number in the scale array ([slots, max_len, kvh]
// beside [slots, max_len, kvh, D]; [kvh, n_pages, page_size, 1] beside
// [kvh, n_pages, page_size, D]), so the one policy addresses the payload
// and its scale. The policy also says which function the kernel computes
// (Rows::kFused): the fused decode of rows 1 (ContigRows) and 2
// (PagedRows), RoPE and the append included, or the block-table decode of
// row 3 (TableRows), which only reads an already-appended float pool.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pt_decode {

namespace cg = cooperative_groups;

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
// round-half-to-even, as the JAX package's kernel_quant_rows. The payload
// goes to q_s[0..D) and the scale to *scale_s (shared memory), and when
// ``write`` is set also to dst[0..D) and *dst_scale. Called by every
// thread of a block of NT threads (it synchronises); red_s is one float of
// shared scratch per warp.
template <int D, int NT>
__device__ __forceinline__ void quantize_row(const float* row_s, float* red_s,
                                             int8_t* q_s, float* scale_s,
                                             int8_t* dst, float* dst_scale,
                                             bool write) {
  const int tid = threadIdx.x;
  float amax = 0.f;
  for (int c = tid; c < D; c += NT) amax = fmaxf(amax, fabsf(row_s[c]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (tid % 32 == 0) red_s[tid / 32] = amax;
  __syncthreads();
  amax = red_s[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) amax = fmaxf(amax, red_s[w]);
  const float scale = fmaxf(__fdiv_rn(amax, 127.f), kQuantEps);
  for (int c = tid; c < D; c += NT) {
    const float q =
        fminf(fmaxf(rintf(__fdiv_rn(row_s[c], scale)), -127.f), 127.f);
    q_s[c] = static_cast<int8_t>(q);
    if (write) dst[c] = static_cast<int8_t>(q);
  }
  if (tid == 0) {
    *scale_s = scale;
    if (write) *dst_scale = scale;
  }
  __syncthreads();  // red_s is free again, q_s and scale_s final
}

// ---------------------------------------------------------------------------
// split_decode_kernel: the decode attention of rows 1-3 as split-K ("flash
// decoding") over a thread-block cluster: the fused decode of rows 1
// (contiguous caches) and 2 (paged pools), and, with a read-only row policy
// (Rows::kFused false), the block-table decode of row 3.
//
// For each (slot s, kv head h, block of up to HPB query heads) stream, a
// cluster of R CTAs (R = 1, 2, 4 or 8, the launch plan's, from the host's
// shapes only) splits rows 0..L (L = seq_lens[s], read on the device): rank
// r takes rows [r c, min((r + 1) c, L + 1)) with c = ceil((L + 1) / R)
// rounded up to whole tiles of kTileRows rows, so a rank may get none (it
// then contributes m = -inf, l = 0). A CTA has W warps (8, or 4 where a
// row is over 512 bytes); warp w takes its rank's tiles w, w + W, ... and
// streams them through its own ring of 2-4 tile buffers in shared memory
// by 16-byte cp.async (an int8 tile also carries its rows' scales), the
// next tiles in flight while it computes one, so no barrier of the CTA
// sits in the row loop. A tile of a paged stream (rows 2 and 3) reads each
// row's page id once, a tile ahead of its copy.
//
// A tile's step, for a group of up to 8 query heads at a time (each K/V
// row read from shared memory and converted once a group, the group's
// reductions side by side): each lane dots its EPL elements of q with each
// of the 8 rows; one transposed butterfly (reduce_rows) sums the 8 rows
// over the lanes with 9 shuffles, leaving one row on each 4 lanes; one max
// and one sum over the rows (3 shuffles each), one rescale of the
// accumulator, and p v accumulated from shared memory with p broadcast by
// shuffles. The softmax runs in base 2 (scores prescaled by log2(e),
// ex2.approx). Int8: the row scale multiplies the score and p, not each
// element. Fused: row L is the rebuilt new row, copied from shared memory
// into its tile slot, never read from the cache. Block table: row L is
// read from the pool like every other row. Rows past L are never read.
//
// Prologue of the fused decode, off the tiles' path: the slot's length and
// position come first; then every load of the prologue (the query rows and
// their RoPE partners, the new K/V row, the cos/sin rows) is issued at
// once, before the first tiles are requested (their row numbers need only
// L); the query rows are then rotated (float32) into shared memory, and the
// rank that owns row L rebuilds the new K/V row, rounded to the cache dtype
// (int8: quantized per head); that rank's first head block alone writes it
// to the cache. Inactive paged slots all append to the sink page 0, row 0,
// which nobody reads. The block-table decode has no positions, rope table
// or new row (their pointers are null, and no load of them is compiled):
// its prologue is the length and the query rows, as they are, and it
// writes nothing but the output.
//
// Merge: the warps in warp order in shared memory; with R > 1 then the
// cluster's ranks in rank order through distributed shared memory, each
// rank writing its share of the outputs (float32, the l == 0 -> 1 guard,
// out in the query's dtype). No atomics and no partial in device memory:
// one launch a call, run-to-run identical.
// ---------------------------------------------------------------------------

constexpr int kTileRows = 8;       // rows of a warp's tile
constexpr int kRingTarget = 8192;  // bytes of a warp's ring, about
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxRanks = 8;  // CTAs of a cluster (the portable size)

// Every argument of a split launch; the layout reads its own fields.
struct SplitArgs {
  const void* q;
  const void* k_new;
  const void* v_new;
  int act_dtype;
  void* k;         // the cache or pool payload
  void* v;
  float* k_scale;  // int8 only
  float* v_scale;
  const int* seq_lens;
  const int* positions;
  const float* cos_t;
  const float* sin_t;
  void* out;
  int kvh, group, max_pos;
  int span;        // rows a stream may hold: max_len, max_pages * page_size
  float scale;
  int max_len;     // contiguous
  const int* bt;   // paged
  int n_pages, page_size, max_pages;
};

// Geometry of a split CTA over rows of D elements of TC: its warps, each
// warp's ring of kStages tiles (K rows, V rows, int8: their scales), and
// the dynamic shared memory (the rings; after the row loop the same memory
// holds the warps' states and the CTA's merged state).
template <typename TC, int D>
struct SplitGeo {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(TC));
  static constexpr int kWarps = kRowBytes <= 512 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kMinBlocks = 65536 / (128 * kThreads);  // 128 regs
  static constexpr int kChunks = kRowBytes / 16;  // 16-byte copies a row
  static constexpr int kScaleBytes = kQuantCache<TC> ? 2 * kTileRows * 4 : 0;
  static constexpr int kStageBytes = 2 * kTileRows * kRowBytes + kScaleBytes;
  static constexpr int kStages =
      kRingTarget / kStageBytes < 2
          ? 2
          : (kRingTarget / kStageBytes > 4 ? 4 : kRingTarget / kStageBytes);
  static constexpr int kRingBytes = kWarps * kStages * kStageBytes;
  // the merge: the warps' acc [W][HPB][D], the CTA's acc [HPB][D], then m
  // and l of each ([W][HPB] twice, [HPB] twice), floats
  template <int HPB>
  static constexpr int merge_bytes() {
    return 4 * ((kWarps + 1) * HPB * D + 2 * (kWarps + 1) * HPB);
  }
  // decode_attention.py: _smem_bytes mirrors it
  template <int HPB>
  static constexpr int smem() {
    return kRingBytes > merge_bytes<HPB>() ? kRingBytes : merge_bytes<HPB>();
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the cluster barrier, split: arrive after this CTA's last read of a
// neighbour's shared memory, wait before leaving
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The row of a tile that reduce_rows leaves on a lane (its halving steps
// over lane bits 16, 8, 4 pick the upper half of the rows), and a lane
// holding a given row.
__device__ __forceinline__ int row_of_lane(int lane) {
  return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}
__device__ __forceinline__ int lane_of_row(int r) {
  return ((r >> 2) & 1) << 4 | ((r >> 1) & 1) << 3 | (r & 1) << 2;
}

// The sums over the warp's lanes of v[0..8) (one partial dot product a
// row), transposed: each halving step keeps half the rows and adds the
// partner lane's half, so the lane ends with the whole sum of row
// row_of_lane(lane) after 4 + 2 + 1 shuffles, and a butterfly over lane
// bits 2 and 1 finishes it (9 shuffles, against 40 for 8 butterflies). A
// fixed order, and the four lanes of a row hold bit-identical sums. v is
// clobbered.
__device__ __forceinline__ float reduce_rows(float (&v)[kTileRows],
                                             int lane) {
#pragma unroll
  for (int n = kTileRows, bit = 16; n > 1; n /= 2, bit /= 2) {
    const bool hi = lane & bit;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float keep = hi ? v[i + n / 2] : v[i];
      const float give = hi ? v[i] : v[i + n / 2];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, give, bit);
    }
  }
  float c = v[0];
  c += __shfl_xor_sync(0xffffffffu, c, 2);
  return c + __shfl_xor_sync(0xffffffffu, c, 1);
}

// 2^x by the MUFU unit (ex2.approx, flush to zero): the softmax runs in
// base 2 on scores prescaled by log2(e)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// max and sum over the 8 rows of a tile (lanes differing in bits 2-4); a
// butterfly, so every lane holds the same value
__device__ __forceinline__ float rows_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
}
__device__ __forceinline__ float rows_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}

template <typename TC, int EPL, int HPB, typename Rows>
__global__ void __launch_bounds__(SplitGeo<TC, 32 * EPL>::kThreads,
                                  SplitGeo<TC, 32 * EPL>::kMinBlocks)
    split_decode_kernel(const SplitArgs a) {
  constexpr int D = 32 * EPL;
  constexpr int HALF = D / 2;
  using Geo = SplitGeo<TC, D>;
  constexpr int W = Geo::kWarps;
  constexpr int NT = Geo::kThreads;
  constexpr int S = Geo::kStages;
  constexpr int kTileChunks = 2 * kTileRows * Geo::kChunks;
  constexpr bool kQuant = kQuantCache<TC>;
  constexpr int kQPer = (HPB * D + NT - 1) / NT;  // query elements a thread
  // query heads a K/V row is read for at once (registers: GH x 8 partial
  // dot products beside all HPB accumulators)
  constexpr int GH = HPB < (EPL <= 2 ? 8 : EPL <= 4 ? 4 : 2)
                         ? HPB
                         : (EPL <= 2 ? 8 : EPL <= 4 ? 4 : 2);
  constexpr int kNPer = (D + NT - 1) / NT;        // new-row elements
  // fused decode (rows 1-2), or the read-only block-table decode (row 3)
  constexpr bool kFused = Rows::kFused;
  static_assert(kFused || !kQuant, "the block-table decode has no int8 path");

  const int R = static_cast<int>(gridDim.x);
  const int rank = static_cast<int>(blockIdx.x);
  const int nhb = (a.group + HPB - 1) / HPB;
  const int h = static_cast<int>(blockIdx.y) / nhb;
  const int hb = static_cast<int>(blockIdx.y) % nhb;
  const int s = static_cast<int>(blockIdx.z);
  const int g0 = hb * HPB;
  const int ng = min(HPB, a.group - g0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float q_s[HPB][D];
  // the new row of the fused decode (one element where it is compiled out)
  constexpr int kNew = kFused ? D : 1;
  constexpr int kNewQ = kFused && kQuant ? D : 1;
  __shared__ float kn_f[kNewQ];  // int8: the rotated row, float32
  __shared__ float vn_f[kNewQ];
  __shared__ __align__(16) TC kn_t[kNew];  // the new row in the cache dtype
  __shared__ __align__(16) TC vn_t[kNew];
  __shared__ float new_sc[2];              // int8: its K and V scales
  __shared__ float red_s[kFused && kQuant ? W : 1];

  // 0. The engine guarantees 0 <= seq_lens[s] < span and positions[s] <
  // max_pos; values outside are clamped, as the Pallas index maps and XLA's
  // gathers clamp them, so a bad index can never write outside the cache.
  const int L = max(0, min(a.seq_lens[s], a.span - 1));

  // 1. every load of the prologue at once: the query rows of this head
  //    block (fused: with their RoPE partners, the new K/V row and the
  //    cos/sin rows)
  const size_t q_base =
      ((static_cast<size_t>(s) * a.kvh + h) * a.group + g0) * D;
  float qx[kQPer], qp[kQPer], qc[kQPer], qs[kQPer];
  float kx[kNPer], kpart[kNPer], vx[kNPer], kc[kNPer], ks[kNPer];
  if constexpr (kFused) {
    const int pos = max(0, min(a.positions[s], a.max_pos - 1));
    const size_t kv_base = (static_cast<size_t>(s) * a.kvh + h) * D;
    const float* crow = a.cos_t + static_cast<size_t>(pos) * HALF;
    const float* srow = a.sin_t + static_cast<size_t>(pos) * HALF;
#pragma unroll
    for (int it = 0; it < kQPer; ++it) {
      const int i = tid + it * NT;
      if (i < ng * D) {
        const int c = i % D;
        const bool first = c < HALF;
        const int cc = first ? c : c - HALF;
        const size_t row = q_base + static_cast<size_t>(i / D) * D;
        qx[it] = load_act(a.q, a.act_dtype, row + c);
        qp[it] = load_act(a.q, a.act_dtype, row + (first ? c + HALF : cc));
        qc[it] = crow[cc];
        qs[it] = srow[cc];
      }
    }
#pragma unroll
    for (int it = 0; it < kNPer; ++it) {
      const int c = tid + it * NT;
      if (c < D) {
        const bool first = c < HALF;
        const int cc = first ? c : c - HALF;
        kx[it] = load_act(a.k_new, a.act_dtype, kv_base + c);
        kpart[it] = load_act(a.k_new, a.act_dtype,
                             kv_base + (first ? c + HALF : cc));
        vx[it] = load_act(a.v_new, a.act_dtype, kv_base + c);
        kc[it] = crow[cc];
        ks[it] = srow[cc];
      }
    }
  } else {
#pragma unroll
    for (int it = 0; it < kQPer; ++it) {
      const int i = tid + it * NT;
      if (i < ng * D) qx[it] = load_act(a.q, a.act_dtype, q_base + i);
    }
  }

  // 2. this rank's rows, this warp's tiles, and the first tiles requested
  const int chunk =
      ((L + R) / R + kTileRows - 1) / kTileRows * kTileRows;  // rows a rank
  const int r0 = min(rank * chunk, L + 1);
  const int r1 = min(r0 + chunk, L + 1);
  // rows [r0, lim) come from memory: all of them for the block table; the
  // fused decode takes row L from shared memory
  const int lim = kFused ? min(r1, L) : r1;
  const Rows rows = Rows::of(a, s, h);
  const TC* kc_ptr = static_cast<const TC*>(a.k);
  const TC* vc_ptr = static_cast<const TC*>(a.v);
  const int ntiles = (r1 - r0 + kTileRows - 1) / kTileRows;
  const int my_n = ntiles > warp ? (ntiles - warp + W - 1) / W : 0;
  unsigned char* ring = smem + warp * S * Geo::kStageBytes;

  // lane l < kTileRows: the number of row l of the warp's i-th tile, or 0
  // past the rows read from memory
  auto row_num = [&](int i) -> unsigned {
    const int j = r0 + (warp + W * i) * kTileRows + lane;
    return (lane < kTileRows && i < my_n && j < lim) ? rows(j) : 0u;
  };
  // request the warp's i-th tile into its ring slot, the rows' numbers in
  // lanes 0..7 of rn
  auto issue = [&](int i, unsigned rn) {
    const int t0 = r0 + (warp + W * i) * kTileRows;
    const int n = i < my_n ? min(kTileRows, lim - t0) : 0;
    unsigned char* st = ring + (i % S) * Geo::kStageBytes;
#pragma unroll 4
    for (int k = lane; k < kTileChunks; k += 32) {
      const int which = k / (kTileRows * Geo::kChunks);  // 0 K, 1 V
      const int r = (k / Geo::kChunks) % kTileRows;
      const int c = k % Geo::kChunks;
      const unsigned row = __shfl_sync(0xffffffffu, rn, r);
      if (r < n) {
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(which ? vc_ptr : kc_ptr) +
            static_cast<size_t>(row) * Geo::kRowBytes + c * 16;
        cp_async16(st + (which * kTileRows + r) * Geo::kRowBytes + c * 16,
                   src);
      }
    }
    if constexpr (kQuant) {
      const unsigned row = __shfl_sync(0xffffffffu, rn, lane % kTileRows);
      if (lane < 2 * kTileRows && lane % kTileRows < n) {
        float* dst = reinterpret_cast<float*>(
                         st + 2 * kTileRows * Geo::kRowBytes) +
                     lane;
        cp_async4(dst, (lane < kTileRows ? a.k_scale : a.v_scale) + row);
      }
    }
  };

  unsigned rn[S];
#pragma unroll
  for (int i = 0; i < S; ++i) rn[i] = row_num(i);
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    issue(i, rn[i]);
    cp_async_commit();
  }
  unsigned rn_next = rn[S - 1];

  // 3. the query rows into shared memory (fused: rotated); the fused
  //    decode's owner of row L rebuilds the new K/V row rounded to the
  //    cache dtype (int8: quantized), and its first head block appends it
  //    in place
#pragma unroll
  for (int it = 0; it < kQPer; ++it) {
    const int i = tid + it * NT;
    if (i < ng * D) {
      const int c = i % D;
      if constexpr (kFused)
        q_s[i / D][c] = rope_elem(qx[it], qp[it], qc[it], qs[it], c < HALF);
      else
        q_s[i / D][c] = qx[it];
    }
  }
  if constexpr (kFused) {
    if (r0 <= L && L < r1) {  // the owner; uniform over the CTA
      const size_t append = rows(L);
      const bool write = hb == 0;
      TC* kd = static_cast<TC*>(a.k) + append * D;
      TC* vd = static_cast<TC*>(a.v) + append * D;
#pragma unroll
      for (int it = 0; it < kNPer; ++it) {
        const int c = tid + it * NT;
        if (c < D) {
          const float kr = rope_elem(kx[it], kpart[it], kc[it], ks[it],
                                     c < HALF);
          if constexpr (kQuant) {
            kn_f[c] = kr;
            vn_f[c] = vx[it];
          } else {
            kn_t[c] = from_float<TC>(kr);
            vn_t[c] = from_float<TC>(vx[it]);
            if (write) {
              kd[c] = kn_t[c];
              vd[c] = vn_t[c];
            }
          }
        }
      }
      if constexpr (kQuant) {
        __syncthreads();
        quantize_row<D, NT>(kn_f, red_s, kn_t, &new_sc[0], kd,
                            a.k_scale + append, write);
        quantize_row<D, NT>(vn_f, red_s, vn_t, &new_sc[1], vd,
                            a.v_scale + append, write);
      }
    }
  }
  __syncthreads();

  // 4. the row loop: this warp's tiles, an online softmax per query head
  //    with one max and one rescale a tile
  float m[HPB], l[HPB], acc[HPB][EPL];
#pragma unroll
  for (int g = 0; g < HPB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }
  const int my_row = row_of_lane(lane);
  const float scale2 = a.scale * kLog2e;  // scores in base 2
  for (int i = 0; i < my_n; ++i) {
    issue(i + S - 1, rn_next);
    cp_async_commit();
    rn_next = row_num(i + S);
    cp_async_wait<S - 1>();
    __syncwarp();

    unsigned char* st = ring + (i % S) * Geo::kStageBytes;
    TC* kt = reinterpret_cast<TC*>(st);
    TC* vt = kt + kTileRows * D;
    float* kst = reinterpret_cast<float*>(st + 2 * kTileRows * Geo::kRowBytes);
    const int t0 = r0 + (warp + W * i) * kTileRows;
    const int nvalid = min(kTileRows, r1 - t0);
    if constexpr (kFused) {
      const int new_r = L - t0;  // the tile's row of the new row, if any
      if (new_r >= 0 && new_r < kTileRows) {  // the owner's last tile
        for (int c = lane; c < D; c += 32) {
          kt[new_r * D + c] = kn_t[c];
          vt[new_r * D + c] = vn_t[c];
        }
        if (kQuant && lane < 2) kst[lane * kTileRows + new_r] = new_sc[lane];
        __syncwarp();
      }
    }
    const bool valid = my_row < nvalid;
    float ksc = 1.f, vsc = 1.f;
    if constexpr (kQuant) {
      ksc = kst[my_row];
      vsc = kst[kTileRows + my_row];
    }
    // the heads in groups of GH: each K/V row is read and converted once a
    // group, and the group's reductions run side by side
#pragma unroll
    for (int h0 = 0; h0 < HPB; h0 += GH) {
      if (h0 >= ng) break;
      float qf[GH][EPL];
#pragma unroll
      for (int j = 0; j < GH; ++j)
        load_row<float, EPL>(&q_s[h0 + j][lane * EPL], qf[j]);
      float part[GH][kTileRows];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        float kf[EPL];
        load_row<TC, EPL>(kt + r * D + lane * EPL, kf);
#pragma unroll
        for (int j = 0; j < GH; ++j) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) dot = fmaf(qf[j][e], kf[e], dot);
          part[j][r] = dot;
        }
      }
      float pv[GH];
#pragma unroll
      for (int j = 0; j < GH; ++j) {
        float sc = reduce_rows(part[j], lane);
        if constexpr (kQuant) sc *= ksc;
        sc = valid ? sc * scale2 : kNegInf;
        const float m_new = fmaxf(m[h0 + j], rows_max(sc));
        const float alpha = exp2_approx(m[h0 + j] - m_new);
        const float p = valid ? exp2_approx(sc - m_new) : 0.f;
        l[h0 + j] = l[h0 + j] * alpha + rows_sum(p);
        m[h0 + j] = m_new;
        pv[j] = kQuant ? p * vsc : p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[h0 + j][e] *= alpha;
      }
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        float pr[GH];
#pragma unroll
        for (int j = 0; j < GH; ++j)
          pr[j] = __shfl_sync(0xffffffffu, pv[j], lane_of_row(r));
        if (r < nvalid) {
          float vf[EPL];
          load_row<TC, EPL>(vt + r * D + lane * EPL, vf);
#pragma unroll
          for (int j = 0; j < GH; ++j)
#pragma unroll
            for (int e = 0; e < EPL; ++e)
              acc[h0 + j][e] = fmaf(pr[j], vf[e], acc[h0 + j][e]);
        }
      }
    }
    __syncwarp();  // the slot is refilled at the next iteration
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring is drained: its memory holds the merge

  // 5. merge the warps in warp order (one rank: straight to the output),
  //    then the ranks in rank order
  float* w_acc = reinterpret_cast<float*>(smem);  // [W][HPB][D]
  float* c_acc = w_acc + W * HPB * D;             // [HPB][D]
  float* w_m = c_acc + HPB * D;                   // [W][HPB]
  float* w_l = w_m + W * HPB;
  float* c_m = w_l + W * HPB;                     // [HPB]
  float* c_l = c_m + HPB;
#pragma unroll
  for (int g = 0; g < HPB; ++g) {
    if (g >= ng) break;
    if (lane == 0) {
      w_m[warp * HPB + g] = m[g];
      w_l[warp * HPB + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      w_acc[(warp * HPB + g) * D + lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = tid; i < ng * D; i += NT) {
    const int g = i / D;
    const int c = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, w_m[w * HPB + g]);
    float lsum = 0.f;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float f = exp2_approx(w_m[w * HPB + g] - mx);
      lsum += w_l[w * HPB + g] * f;
      o += w_acc[(w * HPB + g) * D + c] * f;
    }
    if (R == 1) {
      if (lsum == 0.f) lsum = 1.f;  // the JAX kernels' l == 0 -> 1 guard
      store_act(a.out, a.act_dtype, q_base + static_cast<size_t>(g) * D + c,
                o / lsum);
    } else {
      c_acc[g * D + c] = o;
      if (c == 0) {
        c_m[g] = mx;
        c_l[g] = lsum;
      }
    }
  }
  if (R == 1) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive();  // every rank's merged state is ready
  cluster_wait();
  const int share = (ng * D + R - 1) / R;  // outputs this rank writes
  const int i1 = min(ng * D, (rank + 1) * share);
  for (int i = rank * share + tid; i < i1; i += NT) {
    const int g = i / D;
    const int c = i % D;
    float mq[kMaxRanks], lq[kMaxRanks], oq[kMaxRanks];
#pragma unroll
    for (int q = 0; q < kMaxRanks; ++q) {
      if (q < R) {
        mq[q] = cluster.map_shared_rank(c_m, q)[g];
        lq[q] = cluster.map_shared_rank(c_l, q)[g];
        oq[q] = cluster.map_shared_rank(c_acc, q)[g * D + c];
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int q = 0; q < kMaxRanks; ++q)
      if (q < R) mx = fmaxf(mx, mq[q]);
    float denom = 0.f;
    float o = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxRanks; ++q) {
      if (q < R) {
        const float f = exp2_approx(mq[q] - mx);
        denom += lq[q] * f;
        o += oq[q] * f;
      }
    }
    if (denom == 0.f) denom = 1.f;  // the JAX kernels' l == 0 -> 1 guard
    store_act(a.out, a.act_dtype, q_base + static_cast<size_t>(g) * D + c,
              o / denom);
  }
  cluster_arrive();  // this CTA reads no neighbour's shared memory again
  cluster_wait();
}

// The split kernel of one instantiation, its threads and its dynamic
// shared memory.
struct SplitKernel {
  const void* fn;
  int threads;
  int smem;
};

template <typename TC, int EPL, int HPB, typename Rows>
SplitKernel split_kernel_of() {
  using Geo = SplitGeo<TC, 32 * EPL>;
  return {(const void*)split_decode_kernel<TC, EPL, HPB, Rows>,
          Geo::kThreads, Geo::template smem<HPB>()};
}

template <typename TC, int EPL, typename Rows>
SplitKernel split_kernel_hpb(int hpb) {
  switch (hpb) {
    case 1: return split_kernel_of<TC, EPL, 1, Rows>();
    case 2: return split_kernel_of<TC, EPL, 2, Rows>();
    case 4: return split_kernel_of<TC, EPL, 4, Rows>();
    case 8: return split_kernel_of<TC, EPL, 8, Rows>();
  }
  return {nullptr, 0, 0};
}

// Query heads of a CTA for a GQA group: 1, 2, 4 or 8 (group 16: two CTAs).
inline int heads_per_block(int group) {
  return group <= 1 ? 1 : group <= 2 ? 2 : group <= 4 ? 4 : 8;
}

template <typename TC, typename Rows>
SplitKernel split_kernel(int d, int group) {
  if (d < 32 || d > 256 || d % 32 != 0 || group < 1 || group > 16)
    return {nullptr, 0, 0};
  const int hpb = heads_per_block(group);
  switch (d / 32) {
    case 1: return split_kernel_hpb<TC, 1, Rows>(hpb);
    case 2: return split_kernel_hpb<TC, 2, Rows>(hpb);
    case 3: return split_kernel_hpb<TC, 3, Rows>(hpb);
    case 4: return split_kernel_hpb<TC, 4, Rows>(hpb);
    case 5: return split_kernel_hpb<TC, 5, Rows>(hpb);
    case 6: return split_kernel_hpb<TC, 6, Rows>(hpb);
    case 7: return split_kernel_hpb<TC, 7, Rows>(hpb);
    case 8: return split_kernel_hpb<TC, 8, Rows>(hpb);
  }
  return {nullptr, 0, 0};
}

inline bool valid_ranks(int ranks) {
  return ranks == 1 || ranks == 2 || ranks == 4 || ranks == 8;
}

inline cudaLaunchConfig_t split_config(const SplitKernel& k, int ranks,
                                       int heads, int slots,
                                       cudaStream_t stream,
                                       cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, heads, slots);
  cfg.blockDim = dim3(k.threads);
  cfg.dynamicSmemBytes = k.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ranks > 1;  // one CTA: no cluster launch
  return cfg;
}

// Opt in past 48 KB of shared memory a CTA, the static arrays (at most
// about 12 KB) included.
inline cudaError_t set_smem(const SplitKernel& k) {
  if (k.smem <= 32 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              k.smem);
}

// One launch of the split kernel over `slots` slots with `ranks` CTAs a
// stream; cudaErrorInvalidValue for what it does not take (the payload's
// rows must number fewer than 2^31), else cudaGetLastError().
template <typename TC, typename Rows>
int launch_split(SplitArgs a, int slots, int d, int ranks, long long rows,
                 void* stream) {
  if (slots < 1 || slots > 65535 || a.kvh < 1 || a.span < 1 ||
      (Rows::kFused && a.max_pos < 1) || a.act_dtype < 0 || a.act_dtype > 2 ||
      !valid_ranks(ranks) || rows >= (1LL << 31) ||
      (a.k_scale != nullptr) != kQuantCache<TC> ||
      (a.v_scale != nullptr) != kQuantCache<TC>)
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitKernel k = split_kernel<TC, Rows>(d, a.group);
  if (k.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int hpb = heads_per_block(a.group);
  const int heads = a.kvh * ((a.group + hpb - 1) / hpb);
  if (heads > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_smem(k);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = split_config(
      k, ranks, heads, slots, static_cast<cudaStream_t>(stream), attr);
  void* args[] = {&a};
  err = cudaLaunchKernelExC(&cfg, k.fn, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// A plan's dynamic shared memory (which also tells its warps apart) and
// how many of its clusters the card holds at once
// (cudaOccupancyMaxActiveClusters); cudaErrorInvalidValue for a plan the
// kernels do not take.
template <typename TC, typename Rows>
int split_plan(int group, int d, int ranks, int* smem_out,
               int* clusters_out) {
  const SplitKernel k = split_kernel<TC, Rows>(d, group);
  if (k.fn == nullptr || !valid_ranks(ranks))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_smem(k);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = split_config(k, ranks, 1, 1, 0, attr);
  cfg.numAttrs = 1;
  *smem_out = k.smem;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters_out, k.fn, &cfg));
}

}  // namespace pt_decode
