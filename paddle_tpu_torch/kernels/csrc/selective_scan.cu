// Chunked selective scan (the Mamba S6 recurrence), forward and backward,
// for NVIDIA Hopper (sm_90a). Float32 throughout: the JAX package casts
// every operand to float32 before its kernels.
//
// Replaces the TPU kernels of paddle_tpu/kernels/selective_scan.py:
//   - _scan_kernel (:43) through _scan_fwd_pallas (:99), pallas_call :122
//     (no states, a no_grad forward) and :129 (with the state entering
//     each chunk, the training forward): scan_fwd_kernel, h0s optional;
//   - _scan_bwd_kernel (:139) through _scan_bwd_pallas (:210), pallas_call
//     :258: scan_bwd_kernel.
//
// Layout: u, delta, y, g, du, ddelta [b, s, d]; B, C [b, s, n]; at = A^T
// [n, d]; h0s [b, n_chunks, n, d] with n_chunks = ceil(s / chunk); the
// backward writes dB and dC as per-d-block partials [nd, b, s, n] (nd =
// ceil(d / kThreads)) and dA^T as per-batch partials [b, n, d]; the caller
// sums both in a fixed order. No [b, s, d, n] tensor is written.
//
// What it computes, as the TPU kernels do: h_t = exp(dt_t a) h_{t-1} +
// (dt_t u_t) B_t, y_t = sum_n C_t h_t; with states, h0s[c] = the state
// entering chunk c. Backward, chunks in reverse: the chunk's states are
// recomputed from h0s, then gh += C_t g_t; du_t = dt_t sum_n gh B_t;
// dB_t = sum_d gh dt_t u_t; dC_t = sum_d h_t g_t; ghh = gh h_{t-1} exp(dt_t
// a); ddelta_t = u_t sum_n gh B_t + sum_n ghh a; dA^T += ghh dt_t; gh *=
// exp(dt_t a). expf, not __expf: the build has no fast math, and the
// float32 checks are tight.
//
// What bounds it: at the Mamba-130m train shape (b 4, s 1024, d 1536,
// n 16, chunk 128) the bytes. Forward: u, delta and y 75.5 MB, h0s 3.1 MB,
// B, C 0.5 MB, about 79 MB (0.024 ms at 3.35 TB/s) against about 0.7
// GFLOP of float32 work (0.011 ms at 67 TFLOP/s). Backward: u, delta, g,
// du, ddelta 126 MB, h0s 3.1 MB, about 130 MB (0.039 ms).
//
// Design (first version, simple and right): one thread per (batch,
// channel), its n <= 16 states in registers, kThreads = 64 channels per
// CTA, a loop over all of s inside the CTA (the TPU's sequential chunk
// axis). At the 130m shape that is 96 CTAs of 2 warps on 132 SMs: the
// recurrence is a chain of dependent steps per thread, so the time is one
// warp's chain (16 expf and ~60 FMAs per step, s steps), not the bytes; a
// later PR splits n across lanes.
//   - scan_fwd_kernel stages kTile rows of B and C, which every channel of
//     the CTA shares, in shared memory, with each thread's u and delta of
//     those rows (loaded together, so that one step does not wait on the
//     next one's loads), and writes the state at each chunk start when
//     asked.
//   - scan_bwd_kernel cannot keep a chunk's states (chunk x n x d) the way
//     the TPU kernel keeps them in VMEM: at 64 channels that would be 512
//     KB of shared memory. It checkpoints twice instead: a chunk is walked
//     in segments of kSeg = kCk x kSub steps (one segment when chunk <=
//     128); a first pass over the segment keeps the state entering each of
//     its kCk sub-spans of kSub steps (ck), and each sub-span, in reverse,
//     is recomputed from its checkpoint into shared memory (st) and then
//     walked backward. Cost: the forward recurrence twice per chunk (plus
//     one prefix recompute per later segment when chunk > 128), 184 KB of
//     shared memory at n = 16, with the segment's u and delta and the
//     sub-span's g staged there too. dB and dC (sums over d) are reduced in each
//     warp by a 31-shuffle butterfly that leaves slot l's sum on lane l
//     (dB_j in slot j, dC_j in slot 16 + j), the warps summed in order
//     after each sub-span. No atomics: the backward is run-to-run
//     identical.
//
// The exported C functions pt_selective_scan_{fwd,bwd} return
// cudaGetLastError() after their launch (cudaErrorInvalidValue for n
// outside [1, 16]).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;           // channels per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;              // forward: B/C rows staged at once
constexpr int kSub = 16;               // backward: steps per sub-span
constexpr int kCk = 8;                 // backward: sub-spans per segment
constexpr int kSeg = kSub * kCk;       // backward: steps per segment

// Slot l of v summed over the warp's 32 lanes lands on lane l (a
// reduce-scatter butterfly of 31 shuffles, in a fixed order): at stage
// OFF each lane keeps the half of v[0, 2 OFF) its lane bit selects and
// adds the partner's copy of it. OFF is a template argument so that every
// index is a constant and v stays in registers.
template <int OFF>
__device__ __forceinline__ void butterfly(float (&v)[32], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = upper ? v[i] : v[i + OFF];
    const float keep = upper ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
  if constexpr (OFF > 1) butterfly<OFF / 2>(v, lane);
}

__device__ __forceinline__ float warp_reduce_scatter32(float (&v)[32],
                                                       int lane) {
  butterfly<16>(v, lane);
  return v[0];
}

// One step of the recurrence for one channel: h = exp(dt a) h + dtu B.
template <int N>
__device__ __forceinline__ void scan_step(float (&h)[N], const float (&a)[N],
                                          float dt, float dtu,
                                          const float* brow, int n) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < n) h[j] = expf(dt * a[j]) * h[j] + dtu * brow[j];
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    scan_fwd_kernel(const float* __restrict__ u,
                    const float* __restrict__ delta,
                    const float* __restrict__ B, const float* __restrict__ C,
                    const float* __restrict__ at, float* __restrict__ y,
                    float* __restrict__ h0s, int s, int d, int n, int chunk,
                    int n_chunks) {
  __shared__ float sB[kTile * N];
  __shared__ float sC[kTile * N];
  __shared__ float sU[kTile * kThreads];  // this thread's column: tid
  __shared__ float sD[kTile * kThreads];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int ch = blockIdx.x * kThreads + tid;
  const bool on = ch < d;
  float a[N], h[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    a[j] = (on && j < n) ? at[(size_t)j * d + ch] : 0.f;
    h[j] = 0.f;
  }
  const float* Bb = B + (size_t)b * s * n;
  const float* Cb = C + (size_t)b * s * n;
  for (int t0 = 0; t0 < s; t0 += kTile) {
    const int len = min(kTile, s - t0);
    __syncthreads();
    for (int k = tid; k < len * n; k += kThreads) {
      const int r = k / n, j = k - r * n;
      sB[r * N + j] = Bb[(size_t)t0 * n + k];
      sC[r * N + j] = Cb[(size_t)t0 * n + k];
    }
    // the tile's u and delta, loaded together so that their latencies
    // overlap instead of stalling each step of the recurrence
    if (on) {
      const float* ut = u + ((size_t)b * s + t0) * d + ch;
      const float* dl = delta + ((size_t)b * s + t0) * d + ch;
#pragma unroll 8
      for (int r = 0; r < len; ++r) {
        sU[r * kThreads + tid] = ut[(size_t)r * d];
        sD[r * kThreads + tid] = dl[(size_t)r * d];
      }
    }
    __syncthreads();
    if (!on) continue;
    for (int r = 0; r < len; ++r) {
      const int t = t0 + r;
      if (h0s != nullptr && t % chunk == 0) {
        float* dst = h0s + ((size_t)b * n_chunks + t / chunk) * n * d + ch;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          if (j < n) dst[(size_t)j * d] = h[j];
        }
      }
      const size_t idx = ((size_t)b * s + t) * d + ch;
      const float dt = sD[r * kThreads + tid];
      scan_step<N>(h, a, dt, dt * sU[r * kThreads + tid], sB + r * N, n);
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j < n) acc += h[j] * sC[r * N + j];
      }
      y[idx] = acc;
    }
  }
}

template <int N>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * ((size_t)(kSub + kCk) * N * kThreads +
                          2 * (size_t)kSeg * N + (size_t)kSub * kWarps * 32 +
                          (2 * (size_t)kSeg + kSub) * kThreads);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    scan_bwd_kernel(const float* __restrict__ u,
                    const float* __restrict__ delta,
                    const float* __restrict__ B, const float* __restrict__ C,
                    const float* __restrict__ at,
                    const float* __restrict__ h0s,
                    const float* __restrict__ g, float* __restrict__ du,
                    float* __restrict__ ddelta, float* __restrict__ db_part,
                    float* __restrict__ dc_part, float* __restrict__ dat_part,
                    int nb, int s, int d, int n, int chunk, int n_chunks) {
  static_assert(N <= 16, "dB and dC share one 32-slot butterfly");
  extern __shared__ float smem[];
  float* st = smem;                          // [kSub][N][kThreads]
  float* ck = st + kSub * N * kThreads;      // [kCk][N][kThreads]
  float* sB = ck + kCk * N * kThreads;       // [kSeg][N]
  float* sC = sB + kSeg * N;                 // [kSeg][N]
  float* red = sC + kSeg * N;                // [kSub][kWarps][32]
  float* sU = red + kSub * kWarps * 32;      // [kSeg][kThreads]
  float* sD = sU + kSeg * kThreads;          // [kSeg][kThreads]
  float* sG = sD + kSeg * kThreads;          // [kSub][kThreads]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, blk = blockIdx.x;
  const int ch = blk * kThreads + tid;
  const bool on = ch < d;
  const float* Bb = B + (size_t)b * s * n;
  const float* Cb = C + (size_t)b * s * n;
  float a[N], gh[N], dat[N], h[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    a[j] = (on && j < n) ? at[(size_t)j * d + ch] : 0.f;
    gh[j] = 0.f;
    dat[j] = 0.f;
  }
  // per-channel inputs of step t (zeros past d: those lanes add nothing)
  auto load = [&](const float* p, int t) {
    return on ? p[((size_t)b * s + t) * d + ch] : 0.f;
  };
  for (int ic = n_chunks - 1; ic >= 0; --ic) {
    const int c0 = ic * chunk, c1 = min(s, c0 + chunk);
    const int n_seg = (c1 - c0 + kSeg - 1) / kSeg;
    for (int sg = n_seg - 1; sg >= 0; --sg) {
      const int s0 = c0 + sg * kSeg, s1 = min(c1, s0 + kSeg);
      // the state entering the segment, from the chunk's anchor
      const float* anchor = h0s + ((size_t)b * n_chunks + ic) * n * d + ch;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        h[j] = (on && j < n) ? anchor[(size_t)j * d] : 0.f;
      }
      for (int t = c0; t < s0; ++t) {
        const float dt = load(delta, t);
        scan_step<N>(h, a, dt, dt * load(u, t), Bb + (size_t)t * n, n);
      }
      __syncthreads();
      for (int k = tid; k < (s1 - s0) * n; k += kThreads) {
        const int r = k / n, j = k - r * n;
        sB[r * N + j] = Bb[(size_t)s0 * n + k];
        sC[r * N + j] = Cb[(size_t)s0 * n + k];
      }
      // the segment's u and delta of this thread's channel, loaded
      // together (their latencies overlap) and read from here on
#pragma unroll 8
      for (int r = 0; r < s1 - s0; ++r) {
        sU[r * kThreads + tid] = load(u, s0 + r);
        sD[r * kThreads + tid] = load(delta, s0 + r);
      }
      __syncthreads();
      // checkpoints: the state entering each sub-span of the segment
      for (int t = s0; t < s1; ++t) {
        const int r = t - s0;
        if (r % kSub == 0) {
          float* dst = ck + (size_t)(r / kSub) * N * kThreads + tid;
#pragma unroll
          for (int j = 0; j < N; ++j) dst[j * kThreads] = h[j];
        }
        const float dt = sD[r * kThreads + tid];
        scan_step<N>(h, a, dt, dt * sU[r * kThreads + tid], sB + r * N, n);
      }
      const int n_sub = (s1 - s0 + kSub - 1) / kSub;
      for (int k = n_sub - 1; k >= 0; --k) {
        const int p0 = s0 + k * kSub, p1 = min(s1, p0 + kSub);
        const float* ckk = ck + (size_t)k * N * kThreads + tid;
        // recompute the sub-span's states into shared memory
#pragma unroll
        for (int j = 0; j < N; ++j) h[j] = ckk[j * kThreads];
#pragma unroll 8
        for (int t = p0; t < p1; ++t) sG[(t - p0) * kThreads + tid] = load(g, t);
        for (int t = p0; t < p1; ++t) {
          const int r = t - s0;
          const float dt = sD[r * kThreads + tid];
          scan_step<N>(h, a, dt, dt * sU[r * kThreads + tid], sB + r * N, n);
          float* dst = st + (size_t)(t - p0) * N * kThreads + tid;
#pragma unroll
          for (int j = 0; j < N; ++j) dst[j * kThreads] = h[j];
        }
        // walk it backward: h holds h_t and becomes h_{t-1} (src)
        for (int t = p1 - 1; t >= p0; --t) {
          const float* src = t == p0
                                 ? ckk
                                 : st + (size_t)(t - p0 - 1) * N * kThreads +
                                       tid;
          const float gt = sG[(t - p0) * kThreads + tid];
          const float dt = sD[(t - s0) * kThreads + tid];
          const float ut = sU[(t - s0) * kThreads + tid];
          const float dtu = dt * ut;
          const float* brow = sB + (t - s0) * N;
          const float* crow = sC + (t - s0) * N;
          float v[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) v[i] = 0.f;
          float sum_ghb = 0.f, dd_da = 0.f;
#pragma unroll
          for (int j = 0; j < N; ++j) {
            if (j < n) {
              const float da = expf(dt * a[j]);
              v[16 + j] = h[j] * gt;  // dC_t[j], this channel's term
              gh[j] = gh[j] + crow[j] * gt;
              sum_ghb += gh[j] * brow[j];
              v[j] = gh[j] * dtu;     // dB_t[j], this channel's term
              const float prev = src[j * kThreads];  // h_{t-1}
              const float ghh = gh[j] * prev * da;
              dd_da += ghh * a[j];
              dat[j] += ghh * dt;
              gh[j] = da * gh[j];
              h[j] = prev;
            }
          }
          if (on) {
            const size_t idx = ((size_t)b * s + t) * d + ch;
            du[idx] = dt * sum_ghb;
            ddelta[idx] = ut * sum_ghb + dd_da;
          }
          red[((t - p0) * kWarps + warp) * 32 + lane] =
              warp_reduce_scatter32(v, lane);
        }
        __syncthreads();
        // the warps summed in order: this d-block's dB/dC partial rows
        for (int e = tid; e < (p1 - p0) * 2 * n; e += kThreads) {
          const int r = e / (2 * n), q = e - r * 2 * n;
          const int slot = q < n ? q : 16 + q - n;
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) {
            sum += red[(r * kWarps + w) * 32 + slot];
          }
          float* part = q < n ? db_part : dc_part;
          part[(((size_t)blk * nb + b) * s + p0 + r) * n + (q < n ? q : q - n)] =
              sum;
        }
        __syncthreads();
      }
    }
  }
  if (on) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < n) dat_part[((size_t)b * n + j) * d + ch] = dat[j];
    }
  }
}

template <int N>
int launch_bwd(const float* u, const float* delta, const float* B,
               const float* C, const float* at, const float* h0s,
               const float* g, float* du, float* ddelta, float* db_part,
               float* dc_part, float* dat_part, int b, int s, int d, int n,
               int chunk, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<N>();
  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = (s + chunk - 1) / chunk;
  dim3 grid((d + kThreads - 1) / kThreads, b);
  scan_bwd_kernel<N><<<grid, kThreads, smem, stream>>>(
      u, delta, B, C, at, h0s, g, du, ddelta, db_part, dc_part, dat_part, b,
      s, d, n, chunk, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pt_selective_scan_fwd(const float* u, const float* delta,
                                     const float* B, const float* C,
                                     const float* at, float* y, float* h0s,
                                     int b, int s, int d, int n, int chunk,
                                     void* stream) {
  if (n < 1 || n > 16 || chunk < 1) return (int)cudaErrorInvalidValue;
  const int n_chunks = (s + chunk - 1) / chunk;
  dim3 grid((d + kThreads - 1) / kThreads, b);
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 8) {
    scan_fwd_kernel<8><<<grid, kThreads, 0, st>>>(u, delta, B, C, at, y, h0s,
                                                  s, d, n, chunk, n_chunks);
  } else {
    scan_fwd_kernel<16><<<grid, kThreads, 0, st>>>(u, delta, B, C, at, y,
                                                   h0s, s, d, n, chunk,
                                                   n_chunks);
  }
  return (int)cudaGetLastError();
}

extern "C" int pt_selective_scan_bwd(const float* u, const float* delta,
                                     const float* B, const float* C,
                                     const float* at, const float* h0s,
                                     const float* g, float* du,
                                     float* ddelta, float* db_part,
                                     float* dc_part, float* dat_part, int b,
                                     int s, int d, int n, int chunk,
                                     void* stream) {
  if (n < 1 || n > 16 || chunk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 8) {
    return launch_bwd<8>(u, delta, B, C, at, h0s, g, du, ddelta, db_part,
                         dc_part, dat_part, b, s, d, n, chunk, st);
  }
  return launch_bwd<16>(u, delta, B, C, at, h0s, g, du, ddelta, db_part,
                        dc_part, dat_part, b, s, d, n, chunk, st);
}
