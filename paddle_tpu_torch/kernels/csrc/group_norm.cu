// Fused channels-last GroupNorm (+SiLU), forward and backward, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/kernels/group_norm.py:
//   - _gn_fwd_kernel (:106) through _gn_fwd_pallas (:148), pallas_call
//     :160: gn_fwd_tile_kernel;
//   - _gn_bwd_kernel (:125) through _gn_bwd_pallas (:183), pallas_call
//     :194: gn_bwd_tile_kernel.
//
// Layout: x, y, dy, dx [n, hw, c] (NHWC with h and w flattened) in the
// element type T; gamma, beta [c] float32 (the caller casts); mean, rstd
// [n, g] float32; the backward writes dgamma and dbeta as per-sample
// partials [n, c], which the caller sums over n in order.
//
// What it computes, as the TPU kernels do, over the cg = c / g channels
// of a group and all hw rows of a sample, in float32: mean = sum(x) / N,
// var = sum((x - mean)^2) / N (two passes, no Welford), rstd = 1 /
// sqrt(var + eps), y = (x - mean) rstd gamma + beta, then y sigmoid(y)
// with the SiLU; y in T. Backward: xhat = (x - mean) rstd, dz = dy (times
// sig (1 + z (1 - sig)) with the SiLU, z = xhat gamma + beta), dgamma =
// sum_hw dz xhat, dbeta = sum_hw dz, dxhat = dz gamma, m1 = mean of dxhat
// and m2 = mean of dxhat xhat over the group, dx = rstd (dxhat - m1 -
// xhat m2) in T.
//
// What bounds it: the bytes. Each input read once and each output written
// once: the forward moves 2 n hw c elements, the backward 3 n hw c (plus
// the [n, c] and [n, g] sides); at the largest SD-UNet site at
// sample_size 32, batch 4 (960 channels at 32 x 32, bf16) 15.7 MB forward
// (4.7 us at 3.35 TB/s) and 23.6 MB backward (7.0 us).
//
// Design. The launch plan (group_norm.py: _launch_plan, passed in and
// validated here) cuts the channels into slabs of whole groups whose width is
// a multiple of the vector width V (16 bytes of T at most, narrower when c or
// a pointer is not 16-byte aligned), and the rows of a sample across a
// thread-block cluster of R CTAs (R <= 8): one cluster per (sample, slab),
// grid (R, slabs, n). It picks R and the CTA's threads so that the card holds
// the whole grid at once (it asks the card: pt_group_norm_plan_*, which sizes
// shared memory as the launch does): a second wave of clusters costs as much
// as the first. A CTA's threads lie along the slab's vector columns (a warp
// reads whole runs of a row) times rows of threads; it takes ceil(hw / R)
// consecutive rows. The CTA copies its [rows, slab] tile of x (and of dy) into
// shared memory by cp.async, all of it in flight at once, while it stages
// gamma and beta (and the backward's mean and rstd); every pass then runs from
// the tile. When the tile does not fit ("re-read"), the passes read device
// memory (L2) with kBatch vector loads in flight, still in the one launch.
// Sums: float32 per thread and channel, then per channel over the CTA's rows
// of threads in segments (a fixed order), per group by one warp in a fixed
// shuffle tree, then over the cluster's ranks in rank order through
// distributed shared memory, so every CTA holds the same statistics; a slab
// may hold more groups than the CTA has threads (cg 1), and each per-group
// step loops over them. The backward keeps dgamma and dbeta in registers while
// the dxhat sums go through shared memory, and then sums them in the same two
// arrays: the smaller footprint lets the card hold the largest UNet site's 32
// clusters of 8 at once. No atomics: both kernels are run-to-run identical.
// The last pass runs between the cluster barrier's arrive and its wait, so no
// CTA leaves while another may still read its shared memory.
//
// Built once per element type: compile with -DPT_GN_T=<type>
// -DPT_GN_TAG=<suffix>; the exported C functions are
// pt_group_norm_{fwd,bwd}_<suffix>, which return cudaErrorInvalidValue
// for a plan they do not take, else cudaGetLastError() after the launch,
// and pt_group_norm_plan_<suffix> (the plan's shared memory and
// occupancy).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef PT_GN_T
#error "compile with -DPT_GN_T=<element type> -DPT_GN_TAG=<tag>"
#endif

#define PT_CAT2(a, b) a##b
#define PT_CAT(a, b) PT_CAT2(a, b)

namespace cg = cooperative_groups;

namespace {

typedef PT_GN_T T;

constexpr int kMaxThreads = 256;  // threads of a CTA, at most
constexpr int kMaxRanks = 8;      // CTAs of a cluster (the portable size)
constexpr int kMaxVec = 16 / sizeof(T);
// vector loads in flight per tensor where a pass reads device memory:
// forward, backward (two tensors; more costs registers and was slower)
constexpr int kBatch = 4;
constexpr int kBwdBatch = 2;
constexpr size_t kSmemLimit = 227 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__half* p, float v) {
  *p = __float2half_rn(v);
}
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 1 / (1 + e^-z), the reciprocal rounded as IEEE division rounds it
__device__ __forceinline__ float sigmoid(float z) {
  return __frcp_rn(1.f + expf(-z));
}

// dz = dy, times the SiLU's derivative sig (1 + z (1 - sig)) at z = xh
// gamma + beta with the SiLU. Both backward passes compute dz here and
// round dxhat = dz gamma by __fmul_rn, never contracted into a later
// subtraction: pass 2's dxhat - m1 then cancels exactly where pass 1's
// group mean m1 is that same value (a group of one element: dx = 0, as
// the plain version gives).
__device__ __forceinline__ float dz_of(float dy, float xh, float ga,
                                       float be, int silu) {
  if (!silu) return dy;
  const float z = xh * ga + be;
  const float sg = sigmoid(z);
  return dy * (sg * (1.f + z * (1.f - sg)));
}

// V elements of T moved by one access of V sizeof(T) bytes
template <int V>
struct alignas(sizeof(T) * V) Pack {
  T e[V];
};

template <int V>
__device__ __forceinline__ Pack<V> ld(const T* p) {
  return *reinterpret_cast<const Pack<V>*>(p);
}

template <int V>
__device__ __forceinline__ void st(T* p, const Pack<V>& v) {
  *reinterpret_cast<Pack<V>*>(p) = v;
}

// the cluster barrier, split: arrive after this CTA's last read of a
// neighbour's shared memory, wait before leaving
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The geometry of a launch, from the plan.
struct Geo {
  int hw, c, g, cg;  // rows, channels, groups, channels per group
  int cb, gb;        // channels and groups of a slab
  int ncv;           // vector columns of a slab row (cb / V)
  int cols;          // threads along them (min(ncv, blockDim.x))
  int rsteps;        // rows of threads (blockDim.x / cols)
  int per;           // rows of a CTA (ceil(hw / R))
  int tile;          // bytes of one resident [per][cb] tile, 0 if none
  float inv_n;       // 1 / (hw cg)
};

// fn(r, a, b) over rows first, first + step, ... < end of one vector
// column: a from src_a, b from src_b when TWO, at src + (r - rb) pitch;
// B loads of each in flight.
template <int V, bool TWO, typename Fn, int B = TWO ? kBwdBatch : kBatch>
__device__ __forceinline__ void visit_rows(const T* src_a, const T* src_b,
                                           int pitch, int rb, int first,
                                           int end, int step, Fn fn) {
  for (int r = first; r < end; r += B * step) {
    Pack<V> a[B], b[B];
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const int rr = r + k * step;
      if (rr < end) {
        const size_t off = (size_t)(rr - rb) * pitch;
        a[k] = ld<V>(src_a + off);
        if (TWO) b[k] = ld<V>(src_b + off);
      }
    }
#pragma unroll
    for (int k = 0; k < B; ++k) {
      if (r + k * step < end) fn(r + k * step, a[k], b[k]);
    }
  }
}

// part[a][0][ch] = sum over the rows of threads rl of part[a][rl][ch],
// for arrays a < na of stride `stride`, in a fixed order: segments of
// consecutive rows summed in order (a thread for each channel and
// segment), then the segments in order. Ends with __syncthreads.
__device__ void channel_sums(float* part, int na, int stride,
                             const Geo& geo) {
  const int want = max(1, min(geo.rsteps, (int)blockDim.x / geo.cb));
  const int len = (geo.rsteps + want - 1) / want;
  const int segs = (geo.rsteps + len - 1) / len;  // each starts < rsteps
  for (int k = threadIdx.x; k < segs * geo.cb; k += blockDim.x) {
    const int ch = k % geo.cb, lo = k / geo.cb * len;
    const int hi = min(geo.rsteps, lo + len);
    for (int a = 0; a < na; ++a) {
      float* p = part + a * stride + ch;
      float s = p[lo * geo.cb];
      for (int rl = lo + 1; rl < hi; ++rl) s += p[rl * geo.cb];
      p[lo * geo.cb] = s;
    }
  }
  __syncthreads();
  if (len >= geo.rsteps) return;
  for (int ch = threadIdx.x; ch < geo.cb; ch += blockDim.x) {
    for (int a = 0; a < na; ++a) {
      float* p = part + a * stride + ch;
      float s = p[0];
      for (int lo = len; lo < geo.rsteps; lo += len) s += p[lo * geo.cb];
      p[0] = s;
    }
  }
  __syncthreads();
}

// out[gl] = sum of chan over group gl's channels: one warp per group,
// lanes in a fixed order, then a fixed shuffle tree.
__device__ void group_sums(const float* chan, const Geo& geo, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int gl = warp; gl < geo.gb; gl += nwarps) {
    float v = 0.f;
    for (int k = lane; k < geo.cg; k += 32) v += chan[gl * geo.cg + k];
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    if (lane == 0) out[gl] = v;
  }
}

// sum over the cluster's ranks, in rank order, of `local` at index k in
// each rank's shared memory: every read in flight at once
__device__ __forceinline__ float rank_sum(cg::cluster_group& cluster,
                                          float* local, int k) {
  const int ranks = (int)cluster.num_blocks();
  float v[kMaxRanks];
#pragma unroll
  for (int q = 0; q < kMaxRanks; ++q) {
    v[q] = q < ranks ? cluster.map_shared_rank(local, q)[k] : 0.f;
  }
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxRanks; ++q) {
    if (q < ranks) s += v[q];
  }
  return s;
}

// cp.async of 16, 8 or 4 bytes from device to shared memory
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Rows [r0, r1) of a slab (src at row 0, pitch c) into tile [rows][cb],
// consecutive threads on consecutive vectors of a row; by cp.async where
// a vector has 4 bytes or more, so that the whole tile is in flight.
template <int V>
__device__ __forceinline__ void stage_rows(T* tile, const T* src,
                                           const Geo& geo, int r0, int r1) {
  const int n = (r1 - r0) * geo.ncv;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int r = k / geo.ncv, col = (k - r * geo.ncv) * V;
    T* const d = tile + (size_t)r * geo.cb + col;
    const T* const s = src + (size_t)(r0 + r) * geo.c + col;
    if constexpr (V * sizeof(T) >= 4) {
      cp_async<V * sizeof(T)>(d, s);
    } else {
      st<V>(d, ld<V>(s));
    }
  }
}

template <int V, bool RES>
__global__ void __launch_bounds__(kMaxThreads)
    gn_fwd_tile_kernel(const T* __restrict__ x,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta, T* __restrict__ y,
                       float* __restrict__ mean, float* __restrict__ rstd,
                       Geo geo, float eps, int silu) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int i = blockIdx.z, c0 = blockIdx.y * geo.cb;
  const int r0 = min(geo.hw, rank * geo.per);
  const int r1 = min(geo.hw, r0 + geo.per);
  const int tid = threadIdx.x;
  const int vcl = tid % geo.cols, rl = tid / geo.cols;
  // threads past cols rsteps only pad the block to whole warps
  const int vc0 = rl < geo.rsteps ? vcl : geo.ncv;
  T* const tile = reinterpret_cast<T*>(smem);                // [per][cb]
  float* const part = reinterpret_cast<float*>(smem + geo.tile);
  float* const gsum = part + geo.rsteps * geo.cb;            // [2][gb]
  float* const smean = gsum + 2 * geo.gb;                    // [gb]
  float* const srstd = smean + geo.gb;                       // [gb]
  float* const sga = srstd + geo.gb;                         // [cb]
  float* const sbe = sga + geo.cb;                           // [cb]
  const T* const xs = x + (size_t)i * geo.hw * geo.c + c0;

  // the tile of x streams in while gamma and beta are staged
  if (RES) stage_rows<V>(tile, xs, geo, r0, r1);
  for (int ch = tid; ch < geo.cb; ch += blockDim.x) {
    sga[ch] = gamma[c0 + ch];
    sbe[ch] = beta[c0 + ch];
  }
  if (RES) cp_async_wait_all();
  __syncthreads();
  const T* const src = RES ? tile : xs;
  const int pitch = RES ? geo.cb : geo.c, rb = RES ? r0 : 0;

  // pass 1: per-channel sums of x
  for (int vc = vc0; vc < geo.ncv; vc += geo.cols) {
    const int col = vc * V;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    visit_rows<V, false>(src + col, nullptr, pitch, rb, r0 + rl, r1,
                         geo.rsteps,
                         [&](int, const Pack<V>& p, const Pack<V>&) {
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += to_f(p.e[j]);
    });
#pragma unroll
    for (int j = 0; j < V; ++j) part[rl * geo.cb + col + j] = acc[j];
  }
  __syncthreads();
  channel_sums(part, 1, 0, geo);
  group_sums(part, geo, gsum);
  cluster_sync();
  for (int gl = tid; gl < geo.gb; gl += blockDim.x) {
    smean[gl] = rank_sum(cluster, gsum, gl) * geo.inv_n;
  }
  __syncthreads();

  // pass 2: the centred second moment
  for (int vc = vc0; vc < geo.ncv; vc += geo.cols) {
    const int col = vc * V;
    float acc[V], mu[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      acc[j] = 0.f;
      mu[j] = smean[(col + j) / geo.cg];
    }
    visit_rows<V, false>(src + col, nullptr, pitch, rb, r0 + rl, r1,
                         geo.rsteps,
                         [&](int, const Pack<V>& p, const Pack<V>&) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float dv = to_f(p.e[j]) - mu[j];
        acc[j] += dv * dv;
      }
    });
#pragma unroll
    for (int j = 0; j < V; ++j) part[rl * geo.cb + col + j] = acc[j];
  }
  __syncthreads();
  channel_sums(part, 1, 0, geo);
  group_sums(part, geo, gsum + geo.gb);
  cluster_sync();
  for (int gl = tid; gl < geo.gb; gl += blockDim.x) {
    const float var = rank_sum(cluster, gsum + geo.gb, gl) * geo.inv_n;
    const float rs = 1.f / sqrtf(var + eps);
    srstd[gl] = rs;
    if (rank == 0) {
      const size_t gi = (size_t)i * geo.g + blockIdx.y * geo.gb + gl;
      mean[gi] = smean[gl];
      rstd[gi] = rs;
    }
  }
  cluster_arrive();  // this CTA reads no neighbour's shared memory again
  __syncthreads();

  // pass 3: normalise, affine, activation; vector stores
  T* const ys = y + (size_t)i * geo.hw * geo.c + c0;
  for (int vc = vc0; vc < geo.ncv; vc += geo.cols) {
    const int col = vc * V;
    float mu[V], rs[V], ga[V], be[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mu[j] = smean[(col + j) / geo.cg];
      rs[j] = srstd[(col + j) / geo.cg];
      ga[j] = sga[col + j];
      be[j] = sbe[col + j];
    }
    visit_rows<V, false>(src + col, nullptr, pitch, rb, r0 + rl, r1,
                         geo.rsteps,
                         [&](int r, const Pack<V>& p, const Pack<V>&) {
      Pack<V> o;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float v = (to_f(p.e[j]) - mu[j]) * rs[j] * ga[j] + be[j];
        if (silu) v = v * sigmoid(v);
        put(&o.e[j], v);
      }
      st<V>(ys + (size_t)r * geo.c + col, o);
    });
  }
  cluster_wait();
}

template <int V, bool RES>
__global__ void __launch_bounds__(kMaxThreads)
    gn_bwd_tile_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       const float* __restrict__ mean,
                       const float* __restrict__ rstd, T* __restrict__ dx,
                       float* __restrict__ dgamma, float* __restrict__ dbeta,
                       Geo geo, int silu) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ranks = (int)cluster.num_blocks();
  const int i = blockIdx.z, c0 = blockIdx.y * geo.cb;
  const int r0 = min(geo.hw, rank * geo.per);
  const int r1 = min(geo.hw, r0 + geo.per);
  const int tid = threadIdx.x;
  const int vcl = tid % geo.cols, rl = tid / geo.cols;
  const int vc0 = rl < geo.rsteps ? vcl : geo.ncv;  // see the forward
  T* const tx = reinterpret_cast<T*>(smem);                  // [per][cb]
  T* const tdy = reinterpret_cast<T*>(smem + geo.tile);      // [per][cb]
  // per-thread partials [arrays][rsteps][cb]: with one vector column a
  // thread, dxhat and dxhat xhat in arrays 0-1, then dgamma and dbeta
  // there (they wait in registers); else dgamma, dbeta, dxhat, dxhat xhat
  const bool two = geo.ncv <= geo.cols;
  const int ia = two ? 0 : 2;
  float* const part = reinterpret_cast<float*>(smem + 2 * geo.tile);
  const int stride = geo.rsteps * geo.cb;
  float* const gsum = part + (two ? 2 : 4) * stride;         // [2][gb]
  float* const sm1 = gsum + 2 * geo.gb;                      // [gb]
  float* const sm2 = sm1 + geo.gb;                           // [gb]
  float* const smu = sm2 + geo.gb;                           // [gb]
  float* const srs = smu + geo.gb;                           // [gb]
  float* const sga = srs + geo.gb;                           // [cb]
  float* const sbe = sga + geo.cb;                           // [cb]
  const size_t base = (size_t)i * geo.hw * geo.c + c0;
  const size_t gbase = (size_t)i * geo.g + blockIdx.y * geo.gb;
  const T* const xs = x + base;
  const T* const dys = dy + base;

  // the tiles of x and dy stream in while the parameters are staged
  if (RES) {
    stage_rows<V>(tx, xs, geo, r0, r1);
    stage_rows<V>(tdy, dys, geo, r0, r1);
  }
  for (int ch = tid; ch < geo.cb; ch += blockDim.x) {
    sga[ch] = gamma[c0 + ch];
    sbe[ch] = beta[c0 + ch];
  }
  for (int gl = tid; gl < geo.gb; gl += blockDim.x) {
    smu[gl] = mean[gbase + gl];
    srs[gl] = rstd[gbase + gl];
  }
  if (RES) cp_async_wait_all();
  __syncthreads();
  const T* const sx = RES ? tx : xs;
  const T* const sdy = RES ? tdy : dys;
  const int pitch = RES ? geo.cb : geo.c, rb = RES ? r0 : 0;

  // pass 1: per-channel dgamma, dbeta, dxhat and dxhat xhat sums
  float dg[V], db[V];
  for (int vc = vc0; vc < geo.ncv; vc += geo.cols) {
    const int col = vc * V;
    float ga[V], be[V], mu[V], rs[V], a1[V], a2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      ga[j] = sga[col + j];
      be[j] = sbe[col + j];
      mu[j] = smu[(col + j) / geo.cg];
      rs[j] = srs[(col + j) / geo.cg];
      dg[j] = db[j] = a1[j] = a2[j] = 0.f;
    }
    visit_rows<V, true>(sx + col, sdy + col, pitch, rb, r0 + rl, r1,
                        geo.rsteps,
                        [&](int, const Pack<V>& px, const Pack<V>& pd) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (to_f(px.e[j]) - mu[j]) * rs[j];
        const float dz = dz_of(to_f(pd.e[j]), xh, ga[j], be[j], silu);
        dg[j] += dz * xh;
        db[j] += dz;
        const float dxh = __fmul_rn(dz, ga[j]);  // see dz_of
        a1[j] += dxh;
        a2[j] += dxh * xh;
      }
    });
    float* const p = part + rl * geo.cb + col;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      p[ia * stride + j] = a1[j];
      p[(ia + 1) * stride + j] = a2[j];
      if (!two) {
        p[j] = dg[j];
        p[stride + j] = db[j];
      }
    }
  }
  __syncthreads();
  channel_sums(part, two ? 2 : 4, stride, geo);
  group_sums(part + ia * stride, geo, gsum);
  group_sums(part + (ia + 1) * stride, geo, gsum + geo.gb);
  if (two) {
    __syncthreads();  // the group sums have read arrays 0-1
    if (vc0 < geo.ncv) {
      float* const p = part + rl * geo.cb + vc0 * V;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        p[j] = dg[j];
        p[stride + j] = db[j];
      }
    }
    __syncthreads();
    channel_sums(part, 2, stride, geo);
  }
  cluster_sync();
  for (int gl = tid; gl < geo.gb; gl += blockDim.x) {
    sm1[gl] = rank_sum(cluster, gsum, gl) * geo.inv_n;
    sm2[gl] = rank_sum(cluster, gsum + geo.gb, gl) * geo.inv_n;
  }
  // this sample's dgamma and dbeta partials: rank q sums its share of the
  // slab's channels over the ranks, in rank order
  {
    const int share = (geo.cb + ranks - 1) / ranks;
    const int lo = rank * share, hi = min(geo.cb, lo + share);
    for (int ch = lo + tid; ch < hi; ch += blockDim.x) {
      const size_t o = (size_t)i * geo.c + c0 + ch;
      dgamma[o] = rank_sum(cluster, part, ch);
      dbeta[o] = rank_sum(cluster, part + stride, ch);
    }
  }
  cluster_arrive();  // this CTA reads no neighbour's shared memory again
  __syncthreads();

  // pass 2: dx; vector stores
  T* const dxs = dx + base;
  for (int vc = vc0; vc < geo.ncv; vc += geo.cols) {
    const int col = vc * V;
    float ga[V], be[V], mu[V], rs[V], m1[V], m2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int gl = (col + j) / geo.cg;
      ga[j] = sga[col + j];
      be[j] = sbe[col + j];
      mu[j] = smu[gl];
      rs[j] = srs[gl];
      m1[j] = sm1[gl];
      m2[j] = sm2[gl];
    }
    visit_rows<V, true>(sx + col, sdy + col, pitch, rb, r0 + rl, r1,
                        geo.rsteps,
                        [&](int r, const Pack<V>& px, const Pack<V>& pd) {
      Pack<V> o;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (to_f(px.e[j]) - mu[j]) * rs[j];
        const float dz = dz_of(to_f(pd.e[j]), xh, ga[j], be[j], silu);
        const float dxh = __fmul_rn(dz, ga[j]);  // see dz_of
        put(&o.e[j], rs[j] * (dxh - m1[j] - xh * m2[j]));
      }
      st<V>(dxs + (size_t)r * geo.c + col, o);
    });
  }
  cluster_wait();
}

// The plan's geometry and dynamic shared memory, or false when the plan
// is not one the kernels take. ptrs: the nptrs [n, hw, c] tensors, each
// aligned to the vector.
bool make_geo(int n, int hw, int c, int g, int slab, int ranks, int vec,
              int resident, int threads, bool backward,
              const void* const* ptrs, int nptrs, Geo* geo, size_t* smem) {
  if (n < 1 || n > 65535 || hw < 1 || g < 1 || c < 1 || c % g) return false;
  if (vec < 1 || vec > kMaxVec || (vec & (vec - 1)) || c % vec) return false;
  for (int k = 0; k < nptrs; ++k) {
    if (reinterpret_cast<uintptr_t>(ptrs[k]) % (vec * sizeof(T))) {
      return false;
    }
  }
  const int cg = c / g;
  if (slab < 1 || c % slab || slab % cg || slab % vec) return false;
  if (c / slab > 65535 || ranks < 1 || ranks > kMaxRanks) return false;
  if (threads < 32 || threads > kMaxThreads || threads % 32) return false;
  Geo r{};
  r.hw = hw;
  r.c = c;
  r.g = g;
  r.cg = cg;
  r.cb = slab;
  r.gb = slab / cg;
  r.ncv = slab / vec;
  r.cols = r.ncv < threads ? r.ncv : threads;
  r.rsteps = threads / r.cols;
  r.per = (hw + ranks - 1) / ranks;
  const size_t tile = ((size_t)r.per * slab * sizeof(T) + 15) / 16 * 16;
  if (resident && tile > kSmemLimit) return false;
  r.tile = resident ? (int)tile : 0;
  r.inv_n = (float)(1.0 / ((double)hw * cg));
  // tiles: x (and dy); partial arrays: 1 (2, or 4 with more than one
  // vector column a thread); gamma and beta; group
  // arrays: 4 (and the backward's mean and rstd)
  const size_t tiles = backward ? 2 : 1;
  const size_t arrays = backward ? (r.ncv <= r.cols ? 2 : 4) : 1;
  *smem = tiles * (size_t)r.tile +
          sizeof(float) * (arrays * r.rsteps * slab + 2 * (size_t)slab +
                           (backward ? 6 : 4) * (size_t)r.gb);
  if (*smem > kSmemLimit) return false;
  *geo = r;
  return true;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int n, int slabs, int ranks, int threads,
           size_t smem, void* stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, slabs, n);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ranks > 1;  // one CTA: no cluster launch (a us less)
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

typedef void (*FwdKernel)(const T*, const float*, const float*, T*, float*,
                          float*, Geo, float, int);
typedef void (*BwdKernel)(const T*, const T*, const float*, const float*,
                          const float*, const float*, T*, float*, float*,
                          Geo, int);

template <int V>
FwdKernel fwd_kernel(bool res) {
  return res ? gn_fwd_tile_kernel<V, true> : gn_fwd_tile_kernel<V, false>;
}

template <int V>
BwdKernel bwd_kernel(bool res) {
  return res ? gn_bwd_tile_kernel<V, true> : gn_bwd_tile_kernel<V, false>;
}

FwdKernel pick_fwd(int vec, bool res) {
  switch (vec) {
    case 1: return fwd_kernel<1>(res);
    case 2: return fwd_kernel<2>(res);
    case 4: return fwd_kernel<4>(res);
    case 8: return fwd_kernel<kMaxVec>(res);  // 16-bit T (make_geo)
  }
  return nullptr;
}

BwdKernel pick_bwd(int vec, bool res) {
  switch (vec) {
    case 1: return bwd_kernel<1>(res);
    case 2: return bwd_kernel<2>(res);
    case 4: return bwd_kernel<4>(res);
    case 8: return bwd_kernel<kMaxVec>(res);  // 16-bit T (make_geo)
  }
  return nullptr;
}

}  // namespace

extern "C" int PT_CAT(pt_group_norm_fwd_, PT_GN_TAG)(
    const void* x, const float* gamma, const float* beta, void* y,
    float* mean, float* rstd, int n, int hw, int c, int g, float eps,
    int silu, int slab, int ranks, int vec, int resident, int threads,
    void* stream) {
  const void* ptrs[2] = {x, y};
  Geo geo;
  size_t smem = 0;
  if (!make_geo(n, hw, c, g, slab, ranks, vec, resident, threads, false,
                ptrs, 2, &geo, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  const FwdKernel kernel = pick_fwd(vec, resident != 0);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return launch(kernel, n, c / slab, ranks, threads, smem, stream,
                (const T*)x, gamma, beta, (T*)y, mean, rstd, geo, eps, silu);
}

extern "C" int PT_CAT(pt_group_norm_bwd_, PT_GN_TAG)(
    const void* x, const void* dy, const float* gamma, const float* beta,
    const float* mean, const float* rstd, void* dx, float* dgamma,
    float* dbeta, int n, int hw, int c, int g, int silu, int slab,
    int ranks, int vec, int resident, int threads, void* stream) {
  const void* ptrs[3] = {x, dy, dx};
  Geo geo;
  size_t smem = 0;
  if (!make_geo(n, hw, c, g, slab, ranks, vec, resident, threads, true,
                ptrs, 3, &geo, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  const BwdKernel kernel = pick_bwd(vec, resident != 0);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return launch(kernel, n, c / slab, ranks, threads, smem, stream,
                (const T*)x, (const T*)dy, gamma, beta, mean, rstd, (T*)dx,
                dgamma, dbeta, geo, silu);
}

// The plan's dynamic shared memory (the launch's, from make_geo) and how
// many clusters of its kernel the card holds at once
// (cudaOccupancyMaxActiveClusters); cudaErrorInvalidValue for a plan the
// kernels do not take, else the query's error.
extern "C" int PT_CAT(pt_group_norm_plan_, PT_GN_TAG)(
    int n, int hw, int c, int g, int slab, int ranks, int vec, int resident,
    int threads, int backward, int* smem_out, int* clusters_out) {
  Geo geo;
  size_t smem = 0;
  if (!make_geo(n, hw, c, g, slab, ranks, vec, resident, threads,
                backward != 0, nullptr, 0, &geo, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  const void* kernel =
      backward ? (const void*)pick_bwd(vec, resident != 0)
               : (const void*)pick_fwd(vec, resident != 0);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, 1, 1);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  *smem_out = (int)smem;
  return (int)cudaOccupancyMaxActiveClusters(clusters_out, kernel, &cfg);
}
