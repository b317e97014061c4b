// Fused channels-last GroupNorm (+SiLU), forward and backward, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/kernels/group_norm.py:
//   - _gn_fwd_kernel (:106) through _gn_fwd_pallas (:148), pallas_call
//     :160: gn_fwd_kernel;
//   - _gn_bwd_kernel (:125) through _gn_bwd_pallas (:183), pallas_call
//     :194: gn_bwd_kernel.
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
// sample_size 32, batch 4 (640 channels at 32 x 32, bf16) 5.2 MB forward
// (1.6 us at 3.35 TB/s) and 7.9 MB backward (2.3 us).
//
// Design (first version, simple and right): one CTA per (sample, slab of
// whole groups). A group's channels are contiguous within each row, cg
// of them (10 at c = 320, 20 bytes of bf16), so a CTA per group would read
// short runs; a slab holds gb groups (the largest divisor of g with
// gb cg <= 128 channels), and its threads lie along the slab's channels
// (tcol = min(gb cg, 1024) of them) times rstep rows (up to 256 threads),
// so a warp reads whole runs of a row. Every thread owns columns of one
// group: per-thread sums, then each group's sum by one warp over its
// threads' partials in a fixed order. A thread walks its rows in batches
// of kBatch = 8 loads in flight, summing in row order. The slab is not
// kept in shared memory: the second and third passes re-read x from
// global memory, which L2 (50 MB) serves at every UNet shape (a few MB),
// and any shape with c % g == 0 runs, past the JAX kernel's VMEM budget
// too. No atomics: both kernels are run-to-run identical. Few CTAs at
// batch 4 (n g / gb, e.g. 16 at c = 320) and 2-byte loads leave each SM
// with a few KB in flight: that is what a faster version changes (rows
// split across CTAs with a second reduction pass, vector loads).
//
// Built once per element type: compile with -DPT_GN_T=<type>
// -DPT_GN_TAG=<suffix>; the exported C functions are
// pt_group_norm_{fwd,bwd}_<suffix>. Each returns cudaGetLastError() after
// its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#ifndef PT_GN_T
#error "compile with -DPT_GN_T=<element type> -DPT_GN_TAG=<tag>"
#endif

#define PT_CAT2(a, b) a##b
#define PT_CAT(a, b) PT_CAT2(a, b)

namespace {

typedef PT_GN_T T;

constexpr int kMaxThreads = 1024;
constexpr int kRowThreads = 256;   // threads of a CTA when the slab is narrow
constexpr int kSlabChannels = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

// Visit this thread's rows r0, r0 + step, ... < hw of one column in
// order, with kBatch loads in flight: fn(row, x) (fn2: fn(row, x, dy)).
constexpr int kBatch = 8;

template <typename Fn>
__device__ __forceinline__ void for_rows(const T* col, int r0, int step,
                                         int hw, int c, Fn fn) {
  for (int r = r0; r < hw; r += kBatch * step) {
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int rr = r + k * step;
      v[k] = rr < hw ? to_f(col[(size_t)rr * c]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (r + k * step < hw) fn(r + k * step, v[k]);
    }
  }
}

template <typename Fn>
__device__ __forceinline__ void for_rows2(const T* col, const T* col2,
                                          int r0, int step, int hw, int c,
                                          Fn fn) {
  for (int r = r0; r < hw; r += kBatch * step) {
    float v[kBatch], w[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int rr = r + k * step;
      v[k] = rr < hw ? to_f(col[(size_t)rr * c]) : 0.f;
      w[k] = rr < hw ? to_f(col2[(size_t)rr * c]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (r + k * step < hw) fn(r + k * step, v[k], w[k]);
    }
  }
}

// The slab geometry a CTA works on.
struct Slab {
  int cg;     // channels per group
  int gb;     // groups per slab
  int cb;     // channels per slab (gb cg)
  int tcol;   // threads along the slab's channels
  int rstep;  // threads along the rows
};

// Sum each group's per-thread partials (part[tid]) into out[gl], one warp
// per group in turn, lanes in a fixed order. Thread (r, col) sits at tid =
// r tcol + col; group gl owns columns [gl cg, min(gl cg + cg, tcol)).
__device__ void group_sums(const Slab& sl, const float* part, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int gl = warp; gl < sl.gb; gl += nwarps) {
    const int lo = gl * sl.cg;
    const int width = min(lo + sl.cg, sl.tcol) - lo;
    const int count = width * sl.rstep;
    float v = 0.f;
    for (int k = lane; k < count; k += 32) {
      const int r = k / width;
      v += part[r * sl.tcol + lo + (k - r * width)];
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    if (lane == 0) out[gl] = v;
  }
}

__global__ void gn_fwd_kernel(const T* __restrict__ x,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              T* __restrict__ y, float* __restrict__ mean,
                              float* __restrict__ rstd, int hw, int c, int g,
                              Slab sl, float inv_n, float eps, int silu) {
  extern __shared__ float smem[];
  float* part = smem;                  // [blockDim]
  float* smean = part + blockDim.x;    // [gb]
  float* srstd = smean + sl.gb;        // [gb]
  const int i = blockIdx.y, c0 = blockIdx.x * sl.cb;
  const int col0 = threadIdx.x % sl.tcol, r0 = threadIdx.x / sl.tcol;
  // threads past tcol rstep only pad the block to whole warps
  const int cstart = r0 < sl.rstep ? col0 : sl.cb;
  const int grp = col0 / sl.cg;
  const T* xs = x + (size_t)i * hw * c + c0;
  // pass 1: the mean
  float acc = 0.f;
  for (int col = cstart; col < sl.cb; col += sl.tcol) {
    for_rows(xs + col, r0, sl.rstep, hw, c,
             [&](int, float v) { acc += v; });
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  group_sums(sl, part, smean);
  __syncthreads();
  if (threadIdx.x < sl.gb) smean[threadIdx.x] *= inv_n;
  __syncthreads();
  // pass 2: the centred second moment
  const float mu = smean[grp];
  acc = 0.f;
  for (int col = cstart; col < sl.cb; col += sl.tcol) {
    for_rows(xs + col, r0, sl.rstep, hw, c, [&](int, float v) {
      const float dv = v - mu;
      acc += dv * dv;
    });
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  group_sums(sl, part, srstd);
  __syncthreads();
  if (threadIdx.x < sl.gb) {
    const int gi = blockIdx.x * sl.gb + threadIdx.x;
    const float var = srstd[threadIdx.x] * inv_n;
    srstd[threadIdx.x] = 1.f / sqrtf(var + eps);
    mean[(size_t)i * g + gi] = smean[threadIdx.x];
    rstd[(size_t)i * g + gi] = srstd[threadIdx.x];
  }
  __syncthreads();
  // pass 3: normalise, affine, activation
  const float rs = srstd[grp];
  T* ys = y + (size_t)i * hw * c + c0;
  for (int col = cstart; col < sl.cb; col += sl.tcol) {
    const float ga = gamma[c0 + col], be = beta[c0 + col];
    for_rows(xs + col, r0, sl.rstep, hw, c, [&](int r, float xv) {
      float v = (xv - mu) * rs * ga + be;
      if (silu) v = v * sigmoid(v);
      store(ys + (size_t)r * c + col, v);
    });
  }
}

__global__ void gn_bwd_kernel(const T* __restrict__ x,
                              const T* __restrict__ dy,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              const float* __restrict__ mean,
                              const float* __restrict__ rstd,
                              T* __restrict__ dx, float* __restrict__ dgamma,
                              float* __restrict__ dbeta, int hw, int c, int g,
                              Slab sl, float inv_n, int silu) {
  extern __shared__ float smem[];
  float* part1 = smem;                       // [blockDim]
  float* part2 = part1 + blockDim.x;         // [blockDim]
  float* m1 = part2 + blockDim.x;            // [gb]
  float* m2 = m1 + sl.gb;                    // [gb]
  float* pdg = m2 + sl.gb;                   // [rstep][cb]
  float* pdb = pdg + (size_t)sl.rstep * sl.cb;  // [rstep][cb]
  const int i = blockIdx.y, c0 = blockIdx.x * sl.cb;
  const int col0 = threadIdx.x % sl.tcol, r0 = threadIdx.x / sl.tcol;
  const int cstart = r0 < sl.rstep ? col0 : sl.cb;  // see gn_fwd_kernel
  const int grp = col0 / sl.cg;
  const int gi = blockIdx.x * sl.gb + grp;
  const float mu = mean[(size_t)i * g + gi], rs = rstd[(size_t)i * g + gi];
  const size_t base = (size_t)i * hw * c + c0;
  // pass 1: dgamma, dbeta per column; m1, m2 per group
  float a1 = 0.f, a2 = 0.f;
  for (int col = cstart; col < sl.cb; col += sl.tcol) {
    const float ga = gamma[c0 + col], be = beta[c0 + col];
    float dg = 0.f, db = 0.f;
    for_rows2(x + base + col, dy + base + col, r0, sl.rstep, hw, c,
              [&](int, float xv, float dyv) {
      const float xh = (xv - mu) * rs;
      float dz = dyv;
      if (silu) {
        const float z = xh * ga + be;
        const float sg = sigmoid(z);
        dz = dz * (sg * (1.f + z * (1.f - sg)));
      }
      dg += dz * xh;
      db += dz;
      const float dxh = dz * ga;
      a1 += dxh;
      a2 += dxh * xh;
    });
    pdg[(size_t)r0 * sl.cb + col] = dg;
    pdb[(size_t)r0 * sl.cb + col] = db;
  }
  part1[threadIdx.x] = a1;
  part2[threadIdx.x] = a2;
  __syncthreads();
  group_sums(sl, part1, m1);
  group_sums(sl, part2, m2);
  for (int col = threadIdx.x; col < sl.cb; col += blockDim.x) {
    float dg = 0.f, db = 0.f;
    for (int r = 0; r < sl.rstep; ++r) {
      dg += pdg[(size_t)r * sl.cb + col];
      db += pdb[(size_t)r * sl.cb + col];
    }
    dgamma[(size_t)i * c + c0 + col] = dg;
    dbeta[(size_t)i * c + c0 + col] = db;
  }
  __syncthreads();
  // pass 2: dx
  const float mm1 = m1[grp] * inv_n, mm2 = m2[grp] * inv_n;
  for (int col = cstart; col < sl.cb; col += sl.tcol) {
    const float ga = gamma[c0 + col], be = beta[c0 + col];
    for_rows2(x + base + col, dy + base + col, r0, sl.rstep, hw, c,
              [&](int r, float xv, float dyv) {
      const float xh = (xv - mu) * rs;
      float dz = dyv;
      if (silu) {
        const float z = xh * ga + be;
        const float sg = sigmoid(z);
        dz = dz * (sg * (1.f + z * (1.f - sg)));
      }
      const float dxh = dz * ga;
      store(dx + base + (size_t)r * c + col, rs * (dxh - mm1 - xh * mm2));
    });
  }
}

// The slab of whole groups a CTA takes, or cb = 0 when c % g != 0.
Slab pick_slab(int c, int g) {
  Slab sl{};
  if (g < 1 || c % g) return sl;
  sl.cg = c / g;
  sl.gb = 1;
  for (int gb = 2; gb <= g; ++gb) {
    if (g % gb == 0 && gb * sl.cg <= kSlabChannels) sl.gb = gb;
  }
  sl.cb = sl.gb * sl.cg;
  sl.tcol = std::min(sl.cb, kMaxThreads);
  sl.rstep = std::max(1, kRowThreads / sl.tcol);
  return sl;
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" int PT_CAT(pt_group_norm_fwd_, PT_GN_TAG)(
    const void* x, const float* gamma, const float* beta, void* y,
    float* mean, float* rstd, int n, int hw, int c, int g, float eps,
    int silu, void* stream) {
  const Slab sl = pick_slab(c, g);
  if (sl.cb == 0 || n < 1 || n > 65535 || hw < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = (sl.tcol * sl.rstep + 31) / 32 * 32;
  const size_t smem = sizeof(float) * ((size_t)threads + 2 * sl.gb);
  int err = set_smem((const void*)gn_fwd_kernel, smem);
  if (err) return err;
  const float inv_n = (float)(1.0 / ((double)hw * sl.cg));
  gn_fwd_kernel<<<dim3(g / sl.gb, n), threads, smem,
                  (cudaStream_t)stream>>>(
      (const T*)x, gamma, beta, (T*)y, mean, rstd, hw, c, g, sl, inv_n, eps,
      silu);
  return (int)cudaGetLastError();
}

extern "C" int PT_CAT(pt_group_norm_bwd_, PT_GN_TAG)(
    const void* x, const void* dy, const float* gamma, const float* beta,
    const float* mean, const float* rstd, void* dx, float* dgamma,
    float* dbeta, int n, int hw, int c, int g, int silu, void* stream) {
  const Slab sl = pick_slab(c, g);
  if (sl.cb == 0 || n < 1 || n > 65535 || hw < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = (sl.tcol * sl.rstep + 31) / 32 * 32;
  const size_t smem = sizeof(float) * (2 * (size_t)threads + 2 * sl.gb +
                                       2 * (size_t)sl.rstep * sl.cb);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  int err = set_smem((const void*)gn_bwd_kernel, smem);
  if (err) return err;
  const float inv_n = (float)(1.0 / ((double)hw * sl.cg));
  gn_bwd_kernel<<<dim3(g / sl.gb, n), threads, smem,
                  (cudaStream_t)stream>>>(
      (const T*)x, (const T*)dy, gamma, beta, mean, rstd, (T*)dx, dgamma,
      dbeta, hw, c, g, sl, inv_n, silu);
  return (int)cudaGetLastError();
}
