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
// Three bodies; a call launches exactly one kernel. The two tensor-core
// bodies (16-bit x, n and k multiples of 8) share the W tiles: a CTA
// loads [64 logical k, 128 columns] int8 tiles by cp.async in the 128-byte
// swizzle; each warp reads its 16 columns of a tile by ldmatrix.trans as
// bytes, dequantizes them in registers (q * s in float32 by exact
// integer-to-float tricks, rounded to x's dtype) and multiplies with the
// operands swapped, y^T = W^T x^T, the dequantized W^T as the register A
// operand: every weight is dequantized once per CTA, by the warp that
// multiplies it, with no trip through shared memory. The row order of A
// is permuted (column 2i of the warp's 16 is row i, column 2i + 1 row
// i + 8) so that one ldmatrix.trans of int8 bytes lands each thread's
// fragment whole; for int4 the ldmatrix row addresses interleave the
// packed rows so that each byte holds a fragment register's k pair.
//
// - prefill_kernel (m > 16, it replaces the first version's wmma
//   tiled_kernel): wgmma m64n128k16, A from registers,
//   B the x tile. A CTA owns 128 columns of W (two warpgroups of 64) and
//   128 rows of x; k runs in stages of 64 through a four-stage cp.async
//   ring, each x row 128 bytes in the 128-byte swizzle that wgmma reads
//   (its B operand, K-major). Float32 accumulators stay in registers; a
//   wgmma is in flight while the next k step is dequantized. y leaves
//   through shared memory as 16-byte stores. Grid (x row tiles, W column
//   tiles): the CTAs of one column tile run side by side, so each weight
//   byte comes from device memory about once.
// - decode_tc_kernel (m <= 16; it replaces skinny_kernel and
//   reduce_splits for 16-bit x): mma.sync m16n8k16 with x^T as the B
//   operand (one n8 block for m <= 8, two for m <= 16). A cluster of 8
//   CTAs owns 128 columns of W and splits k eight ways in whole tiles; the
//   CTA's 8 warps own 16 columns each, so nothing merges inside a CTA. The
//   CTA stages its x rows once for its k range (in passes of 1536), its W
//   tiles stream through a four-stage ring with two in flight, and the
//   cluster sums its CTAs' float32 partials through distributed shared
//   memory in rank order: no partial goes to device memory, there is no
//   second launch and no atomic, so the result is run-to-run identical.
// - decode_kernel (float32 x at any m, and 16-bit x whose n or k is no
//   multiple of 8): SIMT FMAs (no TF32: float32 keeps the 1e-5 checks),
//   the same cluster of 8 k splits over 8 rows of x and 32 * VEC columns
//   (VEC = 8 byte-wide columns a lane, 1 when n % 8 != 0); 16 warps walk
//   every 16th stored row with 8 loads in flight, x staged as float32, the
//   warps' sums merged in a fixed tree, then the cluster's in rank order.
//
// What still holds them back (the weight-only matmul phase of
// chip_smoke.py): at prefill about 370 TFLOP/s, the dequantization (about
// four instructions a weight) ahead of every wgmma and one wait per k step
// leaving the tensor cores idle a good part of the time, with no warp
// specialisation and the x tiles by cp.async rather than TMA (CTAs of 256
// W columns, halving the L2 traffic of x, ran slower); at decode, about 3x
// the byte bound, the streaming of a CTA's 128-byte W rows itself (about
// 1.45 TB/s with the products removed) and the products not fully hidden
// behind it.
//
// Exported C function: pt_weight_only_matmul. Returns cudaGetLastError()
// after the launch. pt_weight_only_matmul_smem(body, is_int4) gives the
// dynamic shared memory a body is launched with.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

enum ActDtype { kF32 = 0, kF16 = 1, kBF16 = 2 };

// decode regime
constexpr int kDecRows = 8;       // rows of x per cluster (SKINNY_ROWS)
constexpr int kDecMaxM = 16;      // largest m of the decode regime, 16-bit x
constexpr int kDecWarps = 16;     // warps along k in a CTA
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kSplits = 8;        // CTAs of a cluster: the k splits
constexpr int kDecUnroll = 8;     // stored rows in flight per warp
constexpr int kXCap = 2048;       // logical k rows of x staged at once

// the tensor-core bodies: W tiles of 64 logical k and 128 columns
constexpr int kBN = 128;          // W columns per CTA, 16 a warp
constexpr int kPBK = 64;          // logical k per tile: 128 bytes of x

// prefill regime
constexpr int kPBM = 128;         // x rows per CTA: the wgmma N
constexpr int kPStages = 4;       // ring depth
constexpr int kPAhead = kPStages - 2;  // tiles loaded ahead of the one in use
constexpr int kPThreads = 256;    // two warpgroups of 64 W columns
constexpr int kXTile = kPBM * kPBK * 2;   // bytes
constexpr int kWTile = kPBK * kBN;        // bytes (int4 uses half)
constexpr int kPStage = kXTile + kWTile;  // a multiple of 1024
constexpr int kPSmem = kPStages * kPStage + 1024;  // + alignment slack
constexpr int kLDY = kBN + 8;     // epilogue staging row, elements
static_assert(kPStage % 1024 == 0, "swizzled tiles sit on 1024 bytes");
static_assert(kPBM * kLDY * 2 <= kPStages * kPStage, "epilogue staging");

// decode regime on the tensor cores (16-bit x)
constexpr int kDThreads = 256;    // 8 warps
constexpr int kDStages = 4;       // tile ring depth
constexpr int kDAhead = kDStages - 2;
constexpr int kDXCap = 1536;      // logical k of x staged per pass
constexpr int kDLDX = kDXCap + 8; // x row in shared memory, elements
static_assert(16 * kBN / kSplits == kDThreads, "one column sum a thread");

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

// The stored weights of byte `byte` of `word` as exact floats, without a
// conversion instruction: the byte (biased to unsigned) becomes the low
// mantissa bits of 2^23, and subtracting 2^23 plus the bias leaves it.
// int8: the byte itself; int4: its low (Q4Lo) or high (Q4Hi) nibble,
// sign-extended as (nib ^ 8) - 8.
__device__ __forceinline__ float q8f(uint32_t word, int byte) {
  return __fsub_rn(__int_as_float(static_cast<int>(
                       __byte_perm(word ^ 0x80808080u, 0x4B000000u,
                                   0x7440u | byte))),
                   8388736.f);  // 2^23 + 128
}
__device__ __forceinline__ uint32_t q4lo(uint32_t word) {
  return (word & 0x0F0F0F0Fu) ^ 0x08080808u;
}
__device__ __forceinline__ uint32_t q4hi(uint32_t word) {
  return ((word >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
}
// a byte of q4lo / q4hi as its signed nibble
__device__ __forceinline__ float q4f(uint32_t biased, int byte) {
  return __fsub_rn(__int_as_float(static_cast<int>(
                       __byte_perm(biased, 0x4B000000u, 0x7440u | byte))),
                   8388616.f);  // 2^23 + 8
}

// x rounded to T and read back as float: the dequantized weight as the
// product sees it, two at a time
template <typename T>
__device__ __forceinline__ void round2(float& a, float& b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const float2 f = __bfloat1622float2(__floats2bfloat162_rn(a, b));
    a = f.x;
    b = f.y;
  } else if constexpr (std::is_same<T, __half>::value) {
    const float2 f = __half22float2(__floats2half2_rn(a, b));
    a = f.x;
    b = f.y;
  }
}

// two floats rounded to T, the first in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
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

// The VEC stored weights of one row of a lane as floats: sub 0 the bytes
// (int8) or low nibbles (int4), sub 1 the high nibbles.
template <int NSUB, int VEC>
__device__ __forceinline__ void weights(typename Word<VEC>::type wq, int sub,
                                        float (&q)[VEC]) {
  if constexpr (VEC == 8) {
    const uint32_t parts[2] = {wq.x, wq.y};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (NSUB == 1) {
#pragma unroll
        for (int v = 0; v < 4; ++v) q[4 * h + v] = q8f(parts[h], v);
      } else {
        const uint32_t bias = sub ? q4hi(parts[h]) : q4lo(parts[h]);
#pragma unroll
        for (int v = 0; v < 4; ++v) q[4 * h + v] = q4f(bias, v);
      }
    }
  } else {
    const int b = wq;
    if constexpr (NSUB == 1) {
      q[0] = static_cast<float>(b);
    } else {
      const int nib = (b >> (4 * sub)) & 0xF;
      q[0] = static_cast<float>((nib ^ 8) - 8);
    }
  }
}

// ---------------------------------------------------------------- decode
template <int VEC>
constexpr int dec_smem_floats() {
  constexpr int bn = 32 * VEC;
  constexpr int stage = kXCap * kDecRows;
  constexpr int red = (kDecWarps / 2) * kDecRows * bn;
  return (stage > red ? stage : red) + kDecRows * bn;
}

template <typename T, int NSUB, int VEC>
__global__ void __cluster_dims__(1, kSplits, 1)
    __launch_bounds__(kDecThreads, 1)
        decode_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                      const float* __restrict__ sc, T* __restrict__ y, int m,
                      int n, int k, int g) {
  using W = typename Word<VEC>::type;
  constexpr int BN = 32 * VEC;
  constexpr int LK = kXCap / NSUB;  // stored rows per staging pass
  constexpr int kStageF = kXCap * kDecRows;
  constexpr int kRedF = (kDecWarps / 2) * kDecRows * BN;
  extern __shared__ __align__(16) float dsm[];
  // xs [logical k][kDecRows]: x as float32, the 8 rows of one k together;
  // after the k loop the same words hold the merge buffer red
  // [kDecWarps / 2][kDecRows][BN]; part [kDecRows][BN] is this CTA's sum,
  // which the cluster reads
  float* const xs = dsm;
  float* const red = dsm;
  float* const part = dsm + (kStageF > kRedF ? kStageF : kRedF);

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int j0 = blockIdx.x * BN + lane * VEC;
  const int m0 = blockIdx.z * kDecRows;
  const int rows = k / NSUB;  // stored rows of W
  const int per = (rows + kSplits - 1) / kSplits;
  const int p_begin = min(rows, split * per);
  const int p_end = min(rows, p_begin + per);
  const bool col_ok = j0 < n;  // VEC columns all in range or all out

  float acc[kDecRows][VEC];
#pragma unroll
  for (int r = 0; r < kDecRows; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;
  int gnext = 0;  // the first logical row past the current group
  float s[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) s[v] = 0.f;

  for (int pc = p_begin; pc < p_end; pc += LK) {
    const int pc_end = min(p_end, pc + LK);
    const int lk = (pc_end - pc) * NSUB;
    __syncthreads();  // the previous pass is done with xs
    for (int i = tid; i < kDecRows * lk; i += kDecThreads) {
      const int r = i / lk, l = i % lk;
      xs[l * kDecRows + r] =
          m0 + r < m ? to_f(x[static_cast<size_t>(m0 + r) * k +
                              static_cast<size_t>(pc) * NSUB + l])
                     : 0.f;
    }
    __syncthreads();
    if (!col_ok) continue;
    for (int p = pc + warp; p < pc_end; p += kDecWarps * kDecUnroll) {
      W wq[kDecUnroll];
#pragma unroll
      for (int u = 0; u < kDecUnroll; ++u) {
        const int pu = p + u * kDecWarps;
        if (pu < pc_end)
          wq[u] = __ldg(reinterpret_cast<const W*>(
              w + static_cast<size_t>(pu) * n + j0));
      }
#pragma unroll
      for (int u = 0; u < kDecUnroll; ++u) {
        const int pu = p + u * kDecWarps;
        if (pu >= pc_end) break;
#pragma unroll
        for (int sub = 0; sub < NSUB; ++sub) {
          const int kk = pu * NSUB + sub;
          if (kk >= gnext) {  // a new group: uniform across the warp
            const int gi = kk / g;
            gnext = (gi + 1) * g;
            if constexpr (VEC == 8) {
              const float4* src = reinterpret_cast<const float4*>(
                  sc + static_cast<size_t>(gi) * n + j0);
              const float4 lo = __ldg(src), hi = __ldg(src + 1);
              s[0] = lo.x; s[1] = lo.y; s[2] = lo.z; s[3] = lo.w;
              s[4] = hi.x; s[5] = hi.y; s[6] = hi.z; s[7] = hi.w;
            } else {
              s[0] = __ldg(sc + static_cast<size_t>(gi) * n + j0);
            }
          }
          float wf[VEC];
          weights<NSUB, VEC>(wq[u], sub, wf);
#pragma unroll
          for (int v = 0; v < VEC; ++v) wf[v] = __fmul_rn(wf[v], s[v]);
          if constexpr (VEC == 8) {
#pragma unroll
            for (int v = 0; v < VEC; v += 2) round2<T>(wf[v], wf[v + 1]);
          } else {
            wf[0] = to_f(from_f<T>(wf[0]));
          }
          const float* xr = xs + ((pu - pc) * NSUB + sub) * kDecRows;
          const float4 xa = *reinterpret_cast<const float4*>(xr);
          const float4 xb = *reinterpret_cast<const float4*>(xr + 4);
          const float xv[kDecRows] = {xa.x, xa.y, xa.z, xa.w,
                                      xb.x, xb.y, xb.z, xb.w};
#pragma unroll
          for (int r = 0; r < kDecRows; ++r)
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              acc[r][v] = fmaf(xv[r], wf[v], acc[r][v]);
        }
      }
    }
  }

  // the warps' sums, merged in a fixed tree: warp w + h adds into warp w
  // for h = 8, 4, 2, 1
  __syncthreads();  // every warp is done with xs
#pragma unroll
  for (int h = kDecWarps / 2; h >= 1; h /= 2) {
    if (warp >= h && warp < 2 * h) {
#pragma unroll
      for (int r = 0; r < kDecRows; ++r)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          red[((warp - h) * kDecRows + r) * BN + lane * VEC + v] = acc[r][v];
    }
    __syncthreads();
    if (warp < h) {
#pragma unroll
      for (int r = 0; r < kDecRows; ++r)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[r][v] += red[(warp * kDecRows + r) * BN + lane * VEC + v];
    }
    __syncthreads();
  }
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < kDecRows; ++r)
#pragma unroll
      for (int v = 0; v < VEC; ++v) part[r * BN + lane * VEC + v] = acc[r][v];
  }
  // the cluster's 8 sums, in rank order: CTA `split` sums and stores an
  // eighth of the columns
  cluster.sync();
  constexpr int SLICE = BN / kSplits;
  if (tid < kDecRows * SLICE) {
    const int r = tid / SLICE, c = split * SLICE + tid % SLICE;
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kSplits; ++q)
      t += cluster.map_shared_rank(part, q)[r * BN + c];
    const int row = m0 + r, col = blockIdx.x * BN + c;
    if (row < m && col < n) y[static_cast<size_t>(row) * n + col] = from_f<T>(t);
  }
  cluster.sync();  // no CTA leaves while another reads its part
}

// --------------------------------------------------------------- prefill
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// A wgmma descriptor of a K-major tile of 128-byte rows in the 128-byte
// swizzle (8-row atoms of 1024 bytes, 1024-byte aligned): stride between
// atoms 1024 bytes; the leading offset is unused by this layout.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define PT_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define PT_WGMMA_D64                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x 128] += a[64 x 16] b[16 x 128]: a from registers (the fragment
// of mma.m16n8k16 for each warp's 16 rows), b a K-major swizzled tile in
// shared memory; float32 accumulators d (warp rows 16 w + g and + 8,
// columns 8 i + 2 t and + 1 in d[4 i .. 4 i + 3]).
template <typename T>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PT_WGMMA_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : PT_D8(0), PT_D8(8), PT_D8(16), PT_D8(24), PT_D8(32), PT_D8(40),
          PT_D8(48), PT_D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " PT_WGMMA_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : PT_D8(0), PT_D8(8), PT_D8(16), PT_D8(24), PT_D8(32), PT_D8(40),
          PT_D8(48), PT_D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
  }
}

// ---------------------------------------------- the tensor-core W tiles
// Both tensor-core bodies read W the same way: a CTA loads [64 logical k,
// 128 columns] int8 tiles (WR stored rows of 128 bytes) by cp.async, the
// 16-byte chunk c of row r at chunk c ^ (r & 7) (the 128-byte swizzle),
// and warp cw reads its 16-column chunk by ldmatrix.trans as bytes: its
// rows g and g + 8 are the chunk's columns 2 gq and 2 gq + 1.
__device__ __forceinline__ int w_at(int r, int c) {
  return r * kBN + ((c ^ (r & 7)) << 4);
}

// W stored rows [p0, p0 + 64 / NSUB) of columns [n0, n0 + 128), rows at
// or past p_end and columns past n zero-filled.
template <int NSUB, int NTH>
__device__ __forceinline__ void load_w_tile(unsigned char* ws,
                                            const int8_t* w, int p0,
                                            int p_end, int n0, int n) {
  constexpr int WR = kPBK / NSUB, CH = kBN / 16;
  static_assert(WR * CH % NTH == 0, "whole pieces a thread");
  if (n % 16 == 0) {  // 16-byte pieces
#pragma unroll
    for (int i = 0; i < WR * CH / NTH; ++i) {
      const int p = threadIdx.x + i * NTH, r = p / CH, c = p % CH;
      const int gp = p0 + r, gc = n0 + c * 16;
      const bool ok = gp < p_end && gc < n;
      cp_async16(ws + w_at(r, c),
                 ok ? w + static_cast<size_t>(gp) * n + gc : w, ok);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 2 * WR * CH / NTH; ++i) {
    const int p = threadIdx.x + i * NTH, r = p / (2 * CH), h = p % (2 * CH);
    const int gp = p0 + r, gc = n0 + h * 8;
    const bool ok = gp < p_end && gc < n;
    cp_async8(ws + w_at(r, h >> 1) + (h & 1) * 8,
              ok ? w + static_cast<size_t>(gp) * n + gc : w, ok);
  }
}

// The lane's ldmatrix row within a tile: int8, matrix i = (step i / 2,
// rows 8 (i % 2)..); int4, matrix i = step i, its rows in the order 0 4 1
// 5 2 6 3 7, so that a byte holds the k pair of a fragment register.
template <int NSUB>
__device__ __forceinline__ int w_lane_row(int lane) {
  const int mi = lane >> 3, rr = lane & 7;
  return NSUB == 1 ? (mi >> 1) * 16 + (mi & 1) * 8 + rr
                   : mi * 8 + (rr >> 1) + (rr & 1) * 4;
}

// The warp's W bytes of one tile: int8 raw[h] = steps 2h and 2h + 1 (rows
// 0-7 and 8-15 of each), int4 raw[0][s] = step s.
template <int NSUB>
__device__ __forceinline__ void ldsm_w(uint32_t (&raw)[2][4],
                                       const unsigned char* ws, int cw,
                                       int lrow) {
#pragma unroll
  for (int h = 0; h < 2 / NSUB; ++h)
    ldsm_x4_t(raw[h], ws + w_at(h * 32 + lrow, cw));
}

// q[0..7] of k step kk: (row g, k 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1), then the same at k + 8
template <int NSUB>
__device__ __forceinline__ void step_q(const uint32_t (&raw)[2][4], int kk,
                                       float (&q)[8]) {
  if constexpr (NSUB == 1) {
    const uint32_t lo = raw[kk >> 1][(kk & 1) * 2];
    const uint32_t hi = raw[kk >> 1][(kk & 1) * 2 + 1];
    q[0] = q8f(lo, 0); q[1] = q8f(lo, 2);
    q[2] = q8f(lo, 1); q[3] = q8f(lo, 3);
    q[4] = q8f(hi, 0); q[5] = q8f(hi, 2);
    q[6] = q8f(hi, 1); q[7] = q8f(hi, 3);
  } else {
    const uint32_t word = raw[0][kk];
    const uint32_t l4 = q4lo(word), h4 = q4hi(word);
    q[0] = q4f(l4, 0); q[1] = q4f(h4, 0);
    q[2] = q4f(l4, 1); q[3] = q4f(h4, 1);
    q[4] = q4f(l4, 2); q[5] = q4f(h4, 2);
    q[6] = q4f(l4, 3); q[7] = q4f(h4, 3);
  }
}

// The scales of the thread's columns ncol, ncol + 1 for the k steps of a
// tile; groups past the end read as 0. GAL (g a multiple of 16): a
// 16-aligned step lies in one group, whose float2 was fetched from device
// memory a group ahead; otherwise each weight's group is found on its own.
template <bool GAL>
struct StepScales {
  const float* sc;
  int n, ncol, g, groups;
  int gi, gnext;    // GAL: the current group, where the next one begins
  float2 cur, nxt;  // GAL: their scales

  __device__ __forceinline__ float2 load(int i) const {
    if (ncol >= n || i >= groups) return make_float2(0.f, 0.f);
    return __ldg(reinterpret_cast<const float2*>(
        sc + static_cast<size_t>(i) * n + ncol));
  }
  // the first step is at logical k kstart
  __device__ __forceinline__ void init(int kstart) {
    if constexpr (GAL) {
      gi = kstart / g;
      gnext = (gi + 1) * g;
      cur = load(gi);
      nxt = load(gi + 1);
    }
  }
  // s[0..3]: the scales at k 2t, 2t + 1, 2t + 8, 2t + 9 of the step at
  // logical kabs (steps in increasing order)
  __device__ __forceinline__ void at(int kabs, int t4, float2 (&s)[4]) {
    if constexpr (GAL) {
      if (kabs >= gnext) {  // groups advance one at a time (g >= 16)
        ++gi;
        gnext += g;
        cur = nxt;
        nxt = load(gi + 1);
      }
      s[0] = s[1] = s[2] = s[3] = cur;
    } else {
      const int k2 = kabs + 2 * t4;
      s[0] = load(k2 / g);
      s[1] = load((k2 + 1) / g);
      s[2] = load((k2 + 8) / g);
      s[3] = load((k2 + 9) / g);
    }
  }
};

// The A fragment (mma.m16n8k16 layout) of the dequantized W^T: each weight
// q * s in float32, rounded to T.
template <typename T>
__device__ __forceinline__ void w_frag(uint32_t (&a)[4], const float (&q)[8],
                                       const float2 (&s)[4]) {
  a[0] = pack2<T>(__fmul_rn(q[0], s[0].x), __fmul_rn(q[1], s[1].x));
  a[1] = pack2<T>(__fmul_rn(q[2], s[0].y), __fmul_rn(q[3], s[1].y));
  a[2] = pack2<T>(__fmul_rn(q[4], s[2].x), __fmul_rn(q[5], s[3].x));
  a[3] = pack2<T>(__fmul_rn(q[6], s[2].y), __fmul_rn(q[7], s[3].y));
}

template <typename T, int NSUB, bool GAL>
__global__ void __launch_bounds__(kPThreads, 1)
    prefill_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ sc, T* __restrict__ y, int m,
                   int n, int k, int g) {
  constexpr int WR = kPBK / NSUB;  // stored W rows per stage
  extern __shared__ unsigned char psm[];
  unsigned char* const base =
      psm + ((1024 - (smem_u32(psm) & 1023)) & 1023);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.x * kPBM, n0 = blockIdx.y * kBN;
  const int rows = k / NSUB;
  const int n_kt = (k + kPBK - 1) / kPBK;
  const int cw = warp;  // the warps own the tile's 16-column chunks
  StepScales<GAL> scl{sc, n, n0 + 16 * cw + 2 * gq, g, k / g};
  scl.init(0);

  auto load_stage = [&](int kt, int st) {
    unsigned char* xs = base + st * kPStage;
    const int k0 = kt * kPBK;
    // x: 128 rows x 8 chunks of 16 bytes; chunk c of row r at c ^ (r & 7)
#pragma unroll
    for (int i = 0; i < kPBM * 8 / kPThreads; ++i) {
      const int p = tid + i * kPThreads, r = p >> 3, c = p & 7;
      const int gr = m0 + r, gk = k0 + c * 8;
      const bool ok = gr < m && gk < k;
      cp_async16(xs + r * 128 + ((c ^ (r & 7)) << 4),
                 ok ? x + static_cast<size_t>(gr) * k + gk : x, ok);
    }
    load_w_tile<NSUB, kPThreads>(xs + kXTile, w, kt * WR, rows, n0,
                                       n);
  };

#pragma unroll
  for (int i = 0; i < kPAhead; ++i) {
    if (i < n_kt) load_stage(i, i);
    cp_async_commit();
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t af[2][4];
  const int lrow = w_lane_row<NSUB>(lane);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kPStages;
    cp_async_wait<kPAhead - 1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile kt has landed; the wgmmas of kt - 2 are done
    if (kt + kPAhead < n_kt) load_stage(kt + kPAhead, (kt + kPAhead) % kPStages);
    cp_async_commit();
    const unsigned char* xs = base + st * kPStage;
    uint32_t raw[2][4];
    ldsm_w<NSUB>(raw, xs + kXTile, cw, lrow);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float q[8];
      float2 s[4];
      step_q<NSUB>(raw, kk, q);
      scl.at(kt * kPBK + kk * 16, t4, s);
      uint32_t(&a)[4] = af[kk & 1];
      w_frag<T>(a, q, s);
      wgmma_fence();
      wgmma_m64n128k16<T>(acc, a, sw128_desc(xs) + 2 * kk);  // + 32 bytes
      wgmma_commit();
      wgmma_wait<1>();  // step kk - 1 is done: its A registers are free
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: y through shared memory ([x row][W column], T) to 16-byte
  // stores; the thread holds columns nl, nl + 1 of x rows 8 i + 2 t, + 1
  T* const Ys = reinterpret_cast<T*>(base);
  const int nl = 16 * cw + 2 * gq;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int ml = 8 * i + 2 * t4;
    *reinterpret_cast<uint32_t*>(Ys + ml * kLDY + nl) =
        pack2<T>(acc[4 * i], acc[4 * i + 2]);
    *reinterpret_cast<uint32_t*>(Ys + (ml + 1) * kLDY + nl) =
        pack2<T>(acc[4 * i + 1], acc[4 * i + 3]);
  }
  __syncthreads();
  for (int e = tid; e < kPBM * (kBN / 8); e += kPThreads) {
    const int r = e / (kBN / 8), c = (e % (kBN / 8)) * 8;
    const int gr = m0 + r, gc = n0 + c;
    if (gr < m && gc < n)
      *reinterpret_cast<uint4*>(y + static_cast<size_t>(gr) * n + gc) =
          *reinterpret_cast<const uint4*>(Ys + r * kLDY + c);
  }
}

// -------------------------------------------- decode on the tensor cores
// c[16x8] += a[16x16] b[16x8], float32 accumulators (lane = 4 g + t: c0, c1
// at (g, 2t..2t+1), c2, c3 at (g + 8, 2t..2t+1); b0, b1 the pairs at k
// (2t, 2t + 8), n g)
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// a ring tile of decode_tc_kernel: one W tile
template <int NSUB>
__host__ __device__ constexpr int dtc_tile() {
  return (kPBK / NSUB) * kBN;
}

// decode_tc_kernel's shared memory for x rows of 8 (m <= 8) or 16
template <int NSUB>
__host__ __device__ constexpr int dtc_smem(int xrows) {
  return kDStages * dtc_tile<NSUB>() + xrows * kDLDX * 2 + 16 * kBN * 4;
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// 16-bit x, m <= 16, n and k multiples of 8: y^T = W^T x^T by mma.sync
// m16n8k16 (one n8 block of x rows for m <= 8, two for m <= 16) with the
// dequantized W^T as the A operand, as prefill_kernel builds it. A cluster
// of kSplits CTAs owns 128 columns of W and splits k in whole tiles; a
// CTA's 8 warps own 16 columns each, so nothing merges inside a CTA. The
// CTA stages its 8 (or 16) rows of x once for its k range (in passes of
// kDXCap) by cp.async, and its W tiles of 64 logical k stream through a
// four-stage cp.async ring, two tiles in flight; three CTAs an SM at
// m <= 8. The scales come as the prefill body's do. The cluster sums its
// CTAs' float32 [16][128] partials through distributed shared memory in
// rank order.
template <typename T, int NSUB, bool GAL>
__global__ void __cluster_dims__(1, kSplits, 1) __launch_bounds__(kDThreads)
    decode_tc_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ sc, T* __restrict__ y, int m,
                     int n, int k, int g) {
  constexpr int WR = kPBK / NSUB;            // stored W rows per tile
  constexpr int kWT = dtc_tile<NSUB>();      // bytes per ring tile
  constexpr int PR = kDXCap / NSUB;          // stored rows per x pass
  const bool two = m > 8;
  const int xrows = two ? 16 : 8;
  extern __shared__ __align__(128) unsigned char dts[];
  unsigned char* const ring = dts;           // kDStages tiles
  T* const xs = reinterpret_cast<T*>(dts + kDStages * kWT);  // [xrows][kDLDX]
  float* const part = reinterpret_cast<float*>(
      dts + kDStages * kWT + xrows * kDLDX * 2);  // [16][kBN]

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int rows = k / NSUB;
  // splits of whole tiles, so that every k step is 16-aligned
  const int per = ((rows + kSplits - 1) / kSplits + WR - 1) / WR * WR;
  const int p_begin = min(rows, split * per);
  const int p_end = min(rows, p_begin + per);
  const int cw = warp;
  StepScales<GAL> scl{sc, n, n0 + 16 * cw + 2 * gq, g, k / g};
  scl.init(p_begin * NSUB);
  const int lrow = w_lane_row<NSUB>(lane);
  // x fragments: ldmatrix.x4 matrix i = x rows 8 (i / 2).., k + 8 (i % 2);
  // ldmatrix.x2 (m <= 8) the first two
  const int xrow = two ? (lane >> 4) * 8 + (lane & 7) : lane & 7;
  const int xcol = ((lane >> 3) & 1) * 8;

  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int pc = p_begin; pc < p_end; pc += PR) {
    const int pc_end = min(p_end, pc + PR);
    const int nt = (pc_end - pc + WR - 1) / WR;  // W tiles in this pass
    const int lk = nt * kPBK;                    // logical k staged, padded
    const int kv = (pc_end - pc) * NSUB;         // of which real
    const int kx = pc * NSUB;
    __syncthreads();  // the previous pass is done with xs and the ring
    // x rows [xrows][lk] by 16-byte cp.async, zeros past m and past kv
    for (int c = tid; c < xrows * (lk / 8); c += kDThreads) {
      const int r = c / (lk / 8), j = (c % (lk / 8)) * 8;
      const bool ok = r < m && j < kv;
      cp_async16(xs + r * kDLDX + j,
                 ok ? x + static_cast<size_t>(r) * k + kx + j : x, ok);
    }
    auto load_tile = [&](int t) {
      load_w_tile<NSUB, kDThreads>(ring + (t % kDStages) * kWT, w,
                                   pc + t * WR, pc_end, n0, n);
    };
#pragma unroll
    for (int i = 0; i < kDAhead; ++i) {
      if (i < nt) load_tile(i);
      cp_async_commit();  // the first group also holds x
    }
    for (int t = 0; t < nt; ++t) {
      cp_async_wait<kDAhead - 1>();
      __syncthreads();  // tile t (and x) landed; all warps are done with t - 2
      if (t + kDAhead < nt) load_tile(t + kDAhead);
      cp_async_commit();
      uint32_t raw[2][4];
      ldsm_w<NSUB>(raw, ring + (t % kDStages) * kWT, cw, lrow);
      const int k0 = kx + t * kPBK;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float q[8];
        float2 s[4];
        uint32_t a[4], b[4];
        step_q<NSUB>(raw, kk, q);
        scl.at(k0 + kk * 16, t4, s);
        w_frag<T>(a, q, s);
        const T* xp = xs + xrow * kDLDX + t * kPBK + kk * 16 + xcol;
        if (two) {
          ldsm_x4(b, xp);
          mma16816<T>(acc[0], a, b[0], b[1]);
          mma16816<T>(acc[1], a, b[2], b[3]);
        } else {
          ldsm_x2(b[0], b[1], xp);
          mma16816<T>(acc[0], a, b[0], b[1]);
        }
      }
    }
    cp_async_wait<0>();
  }

  // the CTA's partial [x row][column]: the thread holds columns nl, nl + 1
  // of rows 2 t, 2 t + 1 (and + 8)
  const int nl = 16 * cw + 2 * gq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 8 * i + 2 * t4;
    part[r * kBN + nl] = acc[i][0];
    part[(r + 1) * kBN + nl] = acc[i][1];
    part[r * kBN + nl + 1] = acc[i][2];
    part[(r + 1) * kBN + nl + 1] = acc[i][3];
  }
  // the cluster's sums in rank order: CTA `split` sums 16 of the columns
  cluster.sync();
  {
    constexpr int SLICE = kBN / kSplits;
    const int r = tid / SLICE, c = split * SLICE + tid % SLICE;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kSplits; ++q)
      v += cluster.map_shared_rank(part, q)[r * kBN + c];
    if (r < m && n0 + c < n)
      y[static_cast<size_t>(r) * n + n0 + c] = from_f<T>(v);
  }
  cluster.sync();  // no CTA leaves while another reads its part
}

template <typename KernelT>
cudaError_t set_smem(KernelT kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int NSUB>
cudaError_t launch_t(const void* x, const int8_t* w, const float* sc,
                     void* y, int m, int n, int k, int g, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  cudaError_t err;
  if constexpr (!std::is_same<T, float>::value) {
    if (n % 8 == 0 && k % 8 == 0) {
      if (m > kDecMaxM) {
        const dim3 grid((m + kPBM - 1) / kPBM, (n + kBN - 1) / kBN);
        auto kern = g % 16 == 0 ? prefill_kernel<T, NSUB, true>
                                : prefill_kernel<T, NSUB, false>;
        if ((err = set_smem(kern, kPSmem)) != cudaSuccess) return err;
        kern<<<grid, kPThreads, kPSmem, st>>>(xt, w, sc, yt, m, n, k, g);
      } else {
        const dim3 grid((n + kBN - 1) / kBN, kSplits);
        auto kern = g % 16 == 0 ? decode_tc_kernel<T, NSUB, true>
                                : decode_tc_kernel<T, NSUB, false>;
        const int bytes = dtc_smem<NSUB>(m > 8 ? 16 : 8);
        if ((err = set_smem(kern, bytes)) != cudaSuccess) return err;
        kern<<<grid, kDThreads, bytes, st>>>(xt, w, sc, yt, m, n, k, g);
      }
      return cudaGetLastError();
    }
  }
  const int vec = n % 8 == 0 ? 8 : 1;
  if ((m + kDecRows - 1) / kDecRows > 65535) return cudaErrorInvalidValue;
  const dim3 grid((n + 32 * vec - 1) / (32 * vec), kSplits,
                  (m + kDecRows - 1) / kDecRows);
  if (vec == 8) {
    auto kern = decode_kernel<T, NSUB, 8>;
    const int bytes = dec_smem_floats<8>() * 4;
    if ((err = set_smem(kern, bytes)) != cudaSuccess) return err;
    kern<<<grid, kDecThreads, bytes, st>>>(xt, w, sc, yt, m, n, k, g);
  } else {
    auto kern = decode_kernel<T, NSUB, 1>;
    const int bytes = dec_smem_floats<1>() * 4;
    if ((err = set_smem(kern, bytes)) != cudaSuccess) return err;
    kern<<<grid, kDecThreads, bytes, st>>>(xt, w, sc, yt, m, n, k, g);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_nsub(int is_int4, const void* x, const int8_t* w,
                        const float* sc, void* y, int m, int n, int k, int g,
                        cudaStream_t st) {
  return is_int4 ? launch_t<T, 2>(x, w, sc, y, m, n, k, g, st)
                 : launch_t<T, 1>(x, w, sc, y, m, n, k, g, st);
}

}  // namespace

extern "C" int pt_weight_only_matmul(const void* x, int act_dtype,
                                     const void* w, int is_int4,
                                     const void* scale, void* y, int m,
                                     int n, int k, int g, void* stream) {
  if (m < 1 || n < 1 || k < 1 || g < 1 || k % g != 0 ||
      (is_int4 && k % 2 != 0) || act_dtype < 0 || act_dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (act_dtype == kBF16)
    err = launch_nsub<__nv_bfloat16>(is_int4, x, wq, sc, y, m, n, k, g, st);
  else if (act_dtype == kF16)
    err = launch_nsub<__half>(is_int4, x, wq, sc, y, m, n, k, g, st);
  else
    err = launch_nsub<float>(is_int4, x, wq, sc, y, m, n, k, g, st);
  return static_cast<int>(err);
}

// the dynamic shared memory a body is launched with: 0 prefill_kernel,
// 1 decode_tc_kernel at m <= 8 (is_int4 picks the W tile), 2 decode_kernel
// with 8
// byte-wide columns a lane, 3 with one
extern "C" int pt_weight_only_matmul_smem(int body, int is_int4) {
  if (body == 0) return kPSmem;
  if (body == 1) return is_int4 ? dtc_smem<2>(8) : dtc_smem<1>(8);
  return (body == 2 ? dec_smem_floats<8>() : dec_smem_floats<1>()) * 4;
}

// How many clusters of decode_tc_kernel (bf16 x, m <= 8, g a multiple of
// 16) the card holds at once, or -1 when the query fails.
extern "C" int pt_weight_only_matmul_clusters(int is_int4) {
  auto kern = is_int4 ? decode_tc_kernel<__nv_bfloat16, 2, true>
                      : decode_tc_kernel<__nv_bfloat16, 1, true>;
  const int bytes = is_int4 ? dtc_smem<2>(8) : dtc_smem<1>(8);
  if (set_smem(kern, bytes) != cudaSuccess) return -1;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = kSplits;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, kSplits, 1);
  cfg.blockDim = dim3(kDThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg) != cudaSuccess)
    return -1;
  return clusters;
}
