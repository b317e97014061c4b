// Weight-only quantized matmul for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/kernels/quant_matmul.py: _kernel
// (reached through weight_only_matmul_pallas). It computes
//   y[m, n] = x[m, k] @ dequant(W)
// with x in f32, f16 or bf16; W int8 [k, n], or int4 packed two rows per
// byte [k/2, n] (row 2i in the low nibble, 2i+1 in the high nibble,
// sign-extended as (nib ^ 8) - 8); float32 group scales [k/g, n] for any
// g that divides k; y in x's dtype. As the TPU kernel does, every weight
// is dequantized in float32 (q * scale), rounded to x's dtype, and the
// products accumulate in float32.
//
// What bounds it: at decode (m = the engine's slots, <= 16) memory
// bandwidth, since every weight byte is used by m rows only: the bytes
// are W + scales + x + y. At prefill (m = slots x chunk, 2048 at the 7B
// serving shape) the tensor-core rate.
//
// Design (first version, simple and right), two regimes:
// - small m, and f32 x at any m (skinny_kernel): a CTA of 4 warps owns
//   8 rows of x, 32 * VEC columns of W (VEC = 8 byte-wide columns per
//   thread, one 8-byte load per stored row) and one k split; the rows of x
//   are staged in shared memory as float32 in chunks, each warp walks
//   every fourth stored row of the split with 4 loads in flight, keeps the
//   current group's scales in registers, and the four warps' partial sums
//   merge in shared memory in a fixed order. n = 4096 gives only 16 column
//   blocks for 132 SMs, so k is split until about four CTAs per SM run;
//   each split writes its own float32 partial [splits, m, n] and
//   reduce_splits sums them in split order (no atomics: run-to-run
//   identical results). n not a multiple of 8 takes VEC = 1.
// - large m with 16-bit x (tiled_kernel): 128 x 128 output tiles, 8 warps
//   of 32 x 64, k in steps of 32; the x tile is copied and the W tile is
//   dequantized into shared memory in x's dtype, and nvcuda::wmma
//   16x16x16 fragments multiply them on the tensor cores with float32
//   accumulators. The next tile's global loads are issued before the
//   current tile's products (register staging). Needs n and k multiples
//   of 8; other shapes take skinny_kernel.
//
// Later redesign: wgmma with TMA-fed multi-stage shared-memory rings for
// prefill, and a split-K decode pass that fuses the reduction.
//
// Exported C function: pt_weight_only_matmul. Returns cudaGetLastError()
// after the launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum ActDtype { kF32 = 0, kF16 = 1, kBF16 = 2 };

constexpr int kSkinnyRows = 8;     // rows of x per CTA (SKINNY_ROWS)
constexpr int kSkinnyMaxM = 16;    // largest m of the skinny regime
constexpr int kSkinnyWarps = 4;    // warps along k in a CTA
constexpr int kSkinnyThreads = 32 * kSkinnyWarps;
constexpr int kChunk = 64;         // stored rows of W per staging pass
constexpr int kUnroll = 4;         // stored rows in flight per warp

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kTiledThreads = 256;
constexpr int kPad = 8;            // shared-memory row padding, elements

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Stored value -> signed weight: the byte itself for int8 (NSUB 1), its
// low (sub 0) or high (sub 1) nibble sign-extended for int4 (NSUB 2).
template <int NSUB>
__device__ __forceinline__ int weight_of(int8_t b, int sub) {
  if constexpr (NSUB == 1) {
    return b;
  } else {
    const int nib = (static_cast<int>(b) >> (4 * sub)) & 0xF;
    return (nib ^ 8) - 8;
  }
}

// The dequantized weight as the product sees it: q * scale in float32,
// rounded to x's dtype.
template <typename T>
__device__ __forceinline__ float dequant(int q, float s) {
  return to_f(from_f<T>(__fmul_rn(static_cast<float>(q), s)));
}

template <int VEC>
struct Word;
template <>
struct Word<8> {
  using type = uint2;
};
template <>
struct Word<1> {
  using type = int8_t;
};

template <int VEC>
__device__ __forceinline__ void unpack(typename Word<VEC>::type wq,
                                       int8_t (&b)[VEC]) {
  if constexpr (VEC == 8) {
    const uint32_t parts[2] = {wq.x, wq.y};
#pragma unroll
    for (int v = 0; v < 8; ++v)
      b[v] = static_cast<int8_t>((parts[v / 4] >> (8 * (v % 4))) & 0xFF);
  } else {
    b[0] = wq;
  }
}

template <typename T, int NSUB, int VEC>
__global__ void __launch_bounds__(kSkinnyThreads)
    skinny_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ sc, float* __restrict__ part,
                  T* __restrict__ y, int m, int n, int k, int g,
                  int rows_per_split) {
  using W = typename Word<VEC>::type;
  constexpr int BN = 32 * VEC;
  constexpr int LK = kChunk * NSUB;  // logical k rows per staging pass
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int j0 = blockIdx.x * BN + lane * VEC;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * kSkinnyRows;
  const int rows = k / NSUB;  // stored rows of W
  const int p_begin = min(rows, split * rows_per_split);
  const int p_end = min(rows, p_begin + rows_per_split);
  const bool col_ok = j0 < n;  // VEC columns all in range or all out

  __shared__ float xs[kSkinnyRows][LK];
  __shared__ float red[kSkinnyWarps][kSkinnyRows][BN];

  float acc[kSkinnyRows][VEC];
#pragma unroll
  for (int r = 0; r < kSkinnyRows; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;
  int cur_g = -1;
  float s[VEC];

  for (int pc = p_begin; pc < p_end; pc += kChunk) {
    const int pc_end = min(p_end, pc + kChunk);
    const int lk = (pc_end - pc) * NSUB;
    __syncthreads();
    for (int i = threadIdx.x; i < kSkinnyRows * LK; i += kSkinnyThreads) {
      const int r = i / LK;
      const int l = i % LK;
      xs[r][l] = (m0 + r < m && l < lk)
                     ? to_f(x[static_cast<size_t>(m0 + r) * k +
                              static_cast<size_t>(pc) * NSUB + l])
                     : 0.f;
    }
    __syncthreads();
    if (!col_ok) continue;
    for (int p = pc + warp; p < pc_end; p += kSkinnyWarps * kUnroll) {
      W wq[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pu = p + u * kSkinnyWarps;
        if (pu < pc_end)
          wq[u] = *reinterpret_cast<const W*>(
              w + static_cast<size_t>(pu) * n + j0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pu = p + u * kSkinnyWarps;
        if (pu >= pc_end) break;
        int8_t b[VEC];
        unpack<VEC>(wq[u], b);
#pragma unroll
        for (int sub = 0; sub < NSUB; ++sub) {
          const int kk = pu * NSUB + sub;
          const int gi = kk / g;
          if (gi != cur_g) {  // uniform across the warp
            cur_g = gi;
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              s[v] = __ldg(sc + static_cast<size_t>(gi) * n + j0 + v);
          }
          float wf[VEC];
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            wf[v] = dequant<T>(weight_of<NSUB>(b[v], sub), s[v]);
          const int l = (pu - pc) * NSUB + sub;
#pragma unroll
          for (int r = 0; r < kSkinnyRows; ++r) {
            const float xv = xs[r][l];
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              acc[r][v] = fmaf(xv, wf[v], acc[r][v]);
          }
        }
      }
    }
  }

  // merge the four warps' sums in warp order
#pragma unroll
  for (int r = 0; r < kSkinnyRows; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) red[warp][r][lane * VEC + v] = acc[r][v];
  __syncthreads();
  for (int i = threadIdx.x; i < kSkinnyRows * BN; i += kSkinnyThreads) {
    const int r = i / BN;
    const int c = i % BN;
    const int row = m0 + r;
    const int col = blockIdx.x * BN + c;
    if (row >= m || col >= n) continue;
    float t = red[0][r][c];
#pragma unroll
    for (int q = 1; q < kSkinnyWarps; ++q) t += red[q][r][c];
    const size_t at = static_cast<size_t>(row) * n + col;
    if (part != nullptr)
      part[static_cast<size_t>(split) * m * n + at] = t;
    else
      y[at] = from_f<T>(t);
  }
}

// y = the sum of the splits' partials, taken in split order.
template <typename T>
__global__ void reduce_splits(const float* __restrict__ part,
                              T* __restrict__ y, int splits, size_t mn) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
  if (i >= mn) return;
  float t = part[i];
  for (int s = 1; s < splits; ++s) t += part[static_cast<size_t>(s) * mn + i];
  y[i] = from_f<T>(t);
}

template <typename T, int NSUB>
__global__ void __launch_bounds__(kTiledThreads)
    tiled_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ sc, T* __restrict__ y, int m,
                 int n, int k, int g) {
  using namespace nvcuda;
  // B chunks of 8 stored bytes per thread per tile: 2 for int8 (32 rows x
  // 128 columns), 1 for int4 (16 packed rows)
  constexpr int kBChunks = 2 / NSUB;
  __shared__ __align__(128) T As[kBM][kBK + kPad];
  __shared__ __align__(128) T Bs[kBK][kBN + kPad];
  __shared__ __align__(128) float Cs[kTiledThreads / 32][16][16];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / 2;  // 4 x 2 warps, 32 x 64 outputs each
  const int wn = warp % 2;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 a_reg[2];
  uint2 b_reg[kBChunks];
  float s_reg[16];

  auto load_tile = [&](int kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kTiledThreads;
      const int r = c / (kBK / 8);
      const int kc = (c % (kBK / 8)) * 8;
      const int gr = row0 + r;
      const int gk = k0 + kc;
      a_reg[i] = (gr < m && gk < k)
                     ? *reinterpret_cast<const uint4*>(
                           x + static_cast<size_t>(gr) * k + gk)
                     : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int c = tid + i * kTiledThreads;
      const int pr = c / (kBN / 8);  // stored row within the tile
      const int cc = (c % (kBN / 8)) * 8;
      const int gp = k0 / NSUB + pr;
      const int gc = col0 + cc;
      const bool ok = gp * NSUB < k && gc < n;
      b_reg[i] = ok ? *reinterpret_cast<const uint2*>(
                          w + static_cast<size_t>(gp) * n + gc)
                    : make_uint2(0, 0);
#pragma unroll
      for (int sub = 0; sub < NSUB; ++sub) {
        float* dst = s_reg + (i * NSUB + sub) * 8;
        if (ok) {
          const float4* src = reinterpret_cast<const float4*>(
              sc + static_cast<size_t>((gp * NSUB + sub) / g) * n + gc);
          const float4 lo = __ldg(src);
          const float4 hi = __ldg(src + 1);
          dst[0] = lo.x; dst[1] = lo.y; dst[2] = lo.z; dst[3] = lo.w;
          dst[4] = hi.x; dst[5] = hi.y; dst[6] = hi.z; dst[7] = hi.w;
        } else {
#pragma unroll
          for (int v = 0; v < 8; ++v) dst[v] = 0.f;
        }
      }
    }
  };

  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kTiledThreads;
      *reinterpret_cast<uint4*>(&As[c / (kBK / 8)][(c % (kBK / 8)) * 8]) =
          a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int c = tid + i * kTiledThreads;
      const int pr = c / (kBN / 8);
      const int cc = (c % (kBN / 8)) * 8;
      int8_t b[8];
      unpack<8>(b_reg[i], b);
#pragma unroll
      for (int sub = 0; sub < NSUB; ++sub) {
        const float* s = s_reg + (i * NSUB + sub) * 8;
#pragma unroll
        for (int v = 0; v < 8; ++v)
          Bs[pr * NSUB + sub][cc + v] =
              from_f<T>(__fmul_rn(static_cast<float>(
                                      weight_of<NSUB>(b[v], sub)),
                                  s[v]));
      }
    }
  };

  const int n_kt = (k + kBK - 1) / kBK;
  load_tile(0);
  store_tile();
  __syncthreads();
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) load_tile(kt + 1);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][kk], kBK + kPad);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk][wn * 64 + j * 16], kBN + kPad);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (kt + 1 < n_kt) {
      store_tile();
      __syncthreads();
    }
  }

  // epilogue: each warp converts its fragments through its own scratch
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(&Cs[warp][0][0], acc[i][j], 16,
                              wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gr = row0 + wm * 32 + i * 16 + e / 16;
        const int gc = col0 + wn * 64 + j * 16 + e % 16;
        if (gr < m && gc < n)
          y[static_cast<size_t>(gr) * n + gc] =
              from_f<T>(Cs[warp][e / 16][e % 16]);
      }
      __syncwarp();
    }
  }
}

template <typename T, int NSUB>
cudaError_t launch_t(const void* x, const int8_t* w, const float* sc,
                     float* part, void* y, int m, int n, int k, int g,
                     int splits, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if constexpr (!std::is_same<T, float>::value) {
    if (m > kSkinnyMaxM && n % 8 == 0 && k % 8 == 0) {
      if (splits != 1) return cudaErrorInvalidValue;
      const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
      tiled_kernel<T, NSUB><<<grid, kTiledThreads, 0, st>>>(xt, w, sc, yt, m,
                                                            n, k, g);
      return cudaGetLastError();
    }
  }
  const int rows = k / NSUB;
  const int rows_per_split = (rows + splits - 1) / splits;
  const int vec = n % 8 == 0 ? 8 : 1;
  const dim3 grid((n + 32 * vec - 1) / (32 * vec), splits,
                  (m + kSkinnyRows - 1) / kSkinnyRows);
  float* p = splits > 1 ? part : nullptr;
  if (vec == 8)
    skinny_kernel<T, NSUB, 8><<<grid, kSkinnyThreads, 0, st>>>(
        xt, w, sc, p, yt, m, n, k, g, rows_per_split);
  else
    skinny_kernel<T, NSUB, 1><<<grid, kSkinnyThreads, 0, st>>>(
        xt, w, sc, p, yt, m, n, k, g, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = static_cast<size_t>(m) * n;
  reduce_splits<T><<<static_cast<unsigned>((mn + 255) / 256), 256, 0, st>>>(
      part, yt, splits, mn);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_nsub(int is_int4, const void* x, const int8_t* w,
                        const float* sc, float* part, void* y, int m, int n,
                        int k, int g, int splits, cudaStream_t st) {
  return is_int4 ? launch_t<T, 2>(x, w, sc, part, y, m, n, k, g, splits, st)
                 : launch_t<T, 1>(x, w, sc, part, y, m, n, k, g, splits, st);
}

}  // namespace

extern "C" int pt_weight_only_matmul(const void* x, int act_dtype,
                                     const void* w, int is_int4,
                                     const void* scale, void* part, void* y,
                                     int m, int n, int k, int g, int splits,
                                     void* stream) {
  if (m < 1 || n < 1 || k < 1 || g < 1 || k % g != 0 ||
      (is_int4 && k % 2 != 0) || splits < 1 || splits > 65535 ||
      (splits > 1 && part == nullptr) || act_dtype < 0 || act_dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  float* p = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (act_dtype == kBF16)
    err = launch_nsub<__nv_bfloat16>(is_int4, x, wq, sc, p, y, m, n, k, g,
                                     splits, st);
  else if (act_dtype == kF16)
    err = launch_nsub<__half>(is_int4, x, wq, sc, p, y, m, n, k, g, splits,
                              st);
  else
    err = launch_nsub<float>(is_int4, x, wq, sc, p, y, m, n, k, g, splits,
                             st);
  return static_cast<int>(err);
}
