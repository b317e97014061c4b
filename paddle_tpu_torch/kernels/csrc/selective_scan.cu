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
// [n, d]; h0s [b, n_chunks, n, d] with n_chunks = ceil(s / chunk). The
// backward writes dB and dC as per-channel-tile partials [ceil(d / 32), b,
// s, n] and dA^T as per-(batch, rank) partials [b, ranks, n, d]; the caller
// sums both in a fixed order. It also takes a scratch hst [b, ranks x
// tiles, n, d]: the forward state entering each of its time tiles.
//
// What it computes, as the TPU kernels do: h_t = exp(dt_t a) h_{t-1} +
// (dt_t u_t) B_t, y_t = sum_n C_t h_t; with states, h0s[c] = the state
// entering chunk c. Backward: gh_t = C_t g_t + exp(dt_{t+1} a) gh_{t+1};
// du_t = dt_t sum_n gh B_t; dB_t = sum_d gh dt_t u_t; dC_t = sum_d h_t g_t;
// ghh = gh h_{t-1} exp(dt_t a); ddelta_t = u_t sum_n gh B_t + sum_n ghh a;
// dA^T = sum_t ghh dt_t. The decay is ex2.approx of dt (a log2 e) (see
// decay below), within the float32 checks' 1e-5 of a row.
//
// Design. Both recurrences are linear and diagonal per (channel, state),
// with the same decays da_t = exp(dt_t a), so each runs along time as a
// two-level scan: a segment scanned from zero gives its end value and its
// decay product P = prod da; the carries are combined in time order (c' =
// P c + end); the segment is walked again from its true carry. A CTA holds
// 32 channels, one a lane, so every u, delta, g, y, du, ddelta row is one
// 128-byte load or store, and kW warps (4, 8 or 16: a template argument,
// the plan's choice) along time: a time tile of kW x kL steps, each thread
// kL = 8 consecutive steps of its channel in registers. The states are
// looped outermost: for a state (forward: a pair of states) a thread
// keeps its steps' da, dt u B and (backward) h in registers, scans them
// from zero, publishes (P, end) in shared memory, and after one
// __syncthreads combines the warps before it (forward) or after it
// (reverse) with the carry entering the tile, in warp order (the chain is
// unrolled, its loads all in flight); one warp keeps the tile's outgoing
// carry for the next tile (planes by tile parity). One decay per (step,
// state) and sweep. B and C rows, shared by the 32 channels, are staged
// per warp in shared memory, transposed so that a state's kL values are
// two 16-byte reads.
//   - scan_fwd_kernel: two states an exchange; pass 2 walks each segment
//     from its carries, writes y = sum_n C h (accumulated over the state
//     loop) and, when h0s is not null, the state entering each chunk start
//     (a branch that only the warps holding a chunk start take). One body
//     with and without states, so y is the same bit for bit.
//   - scan_bwd_kernel: a forward sweep (phase F, pairs of states) from the
//     anchor h0s keeps the state entering each tile in hst; then the tiles
//     in reverse, one state an exchange: the segment's forward (from zero)
//     and reverse (gh from zero, which needs no states) local scans share
//     one exchange, the states of the segment are rebuilt in registers
//     from the combined forward carry, and the reverse walk with the
//     combined gh emits du and ddelta (summed over the state loop), the
//     dat partial (per warp, in shared memory) and dB_t, dC_t summed over
//     the warp's 32 channels (warp_slot_sums) into the warp's rows,
//     written as one coalesced block per tile. 128 registers a thread
//     leave no room for a second state.
//   - Few channel tiles (b 1, s 8192) or few warps an SM: a cluster of up
//     to 8 CTAs along s, each rank a range of steps. Forward: ranks before
//     the last first scan their range from zero (phase 1), and each rank
//     combines the earlier ranks' (P, end) in rank order through
//     distributed shared memory. Backward: ranks start at chunk starts, so
//     h0s anchors each; ranks after the first scan gh over their range from
//     zero, and each rank combines the later ranks' in reverse rank order.
//   No atomics: every sum (the carries, dB/dC over lanes, dat over warps)
//   runs in a fixed order, so both kernels are run-to-run identical.
//
// What bounds it: at the Mamba-130m train shape (b 4, s 1024, d 1536, n
// 16, chunk 128) the byte bound is forward 79 MB (0.024 ms at 3.35 TB/s),
// backward 130 MB (0.039 ms). Neither is within reach: a decay is a
// MUFU.EX2, which an SM issues for 16 lanes a clock, and each (step,
// channel, state) takes about 12 instructions forward and 45 backward
// (three sweeps), so the SASS's instruction issue bounds both kernels
// (chip_smoke.py: scan_sass_report prints that floor). Measured, they
// run at about a third of it: the per-state __syncthreads and each warp's
// dependent chains (the decays, the local scan, the carry chain, the
// walk) leave too few warps ready at 8-16 resident warps an SM (PERF.md).
// The launch plan (selective_scan.py: _scan_plan) picks the warps a CTA
// and the ranks a cluster by a cost model fitted to the card's times.
//
// The exported C functions pt_selective_scan_{fwd,bwd} return
// cudaGetLastError() after their launch, cudaErrorInvalidValue for a plan
// or shape the kernels do not take; pt_selective_scan_plan returns a
// plan's shared memory and how many of its clusters the card holds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kL = 8;            // consecutive steps a thread holds
constexpr int kN = 16;           // states at most
constexpr int kMaxRanks = 8;     // CTAs of a cluster along s
constexpr int kPlane = kN * 32;  // a float per (state, channel of a CTA)
// a warp's buffer for its dB/dC sums over lanes: 32 rows of 2 kL terms,
// 20 floats apart, the second 16 rows 16 floats further (warp_slot_sums)
constexpr int kRedStride = 20;
constexpr int kRedFloats = 32 * kRedStride + 16;

// Dynamic shared memory of a CTA in floats (selective_scan.py:
// _smem_bytes mirrors it). Forward: a [kN][32], the carry entering a tile
// [2][kN][32] by tile parity, the range's decay product [kN][32], the
// published (product, end) of the range [2][kN][32], the exchange float4
// [2][W][32] by step parity, and per warp B, C [2][kN][kL]. Backward: the
// same with a reverse carry [2][kN][32], and per warp also the dB/dC rows
// [2][kL][kN], dat [kN][32] and the buffer of its sums over lanes.
__host__ __device__ constexpr int smem_floats(int warps, bool backward) {
  return backward ? 8 * kPlane + warps * (2 * 32 * 4 + 4 * kN * kL + kPlane +
                                          kRedFloats)
                  : 6 * kPlane + warps * (2 * 32 * 4 + 2 * kN * kL);
}

struct Ctx {
  int s, d, n, chunk, n_chunks;
  int W, w, lane;         // warps of the CTA, this warp, this lane
  int R, rank, tpr;       // ranks, this rank, tiles a rank (at most)
  int tile_ch, nb, bb;    // channel tile, batch, this batch row
  int ch;                 // this lane's channel
  bool on;                // ch < d
  int T0, T1, n_tiles;    // this rank's steps [T0, T1), its tiles
  size_t row0;            // bb * s
};

__device__ __forceinline__ Ctx make_ctx(int s, int d, int n, int chunk,
                                        int rank_len) {
  Ctx c;
  c.s = s;
  c.d = d;
  c.n = n;
  c.chunk = chunk;
  c.n_chunks = (s + chunk - 1) / chunk;
  c.W = (int)(blockDim.x >> 5);
  c.w = (int)(threadIdx.x >> 5);
  c.lane = (int)(threadIdx.x & 31);
  c.R = (int)gridDim.x;  // the cluster spans x: rank = blockIdx.x
  c.rank = (int)blockIdx.x;
  c.tile_ch = (int)blockIdx.y;
  c.nb = (int)gridDim.z;
  c.bb = (int)blockIdx.z;
  c.ch = c.tile_ch * 32 + c.lane;
  c.on = c.ch < d;
  const int tile = c.W * kL;
  c.tpr = (rank_len + tile - 1) / tile;
  c.T0 = min(s, c.rank * rank_len);
  c.T1 = min(s, c.T0 + rank_len);
  c.n_tiles = (c.T1 - c.T0 + tile - 1) / tile;
  c.row0 = (size_t)c.bb * s;
  return c;
}

struct Smem {
  float* a;      // [kN][32]
  float* carry;  // [2][kN][32]: forward carry entering a tile
  float* rev;    // [2][kN][32]: reverse carry entering a tile (backward)
  float* prod;   // [kN][32]: decay product of the rank's range
  float* pub;    // [2][kN][32]: (product, end) of the range, for the cluster
  float4* xch;   // [2][W][32]: (P, forward end, reverse end, 0)
  float* bc;     // this warp's B, C rows, transposed: [2][kN][kL]
  float* part;   // this warp's dB, dC rows: [2][kL][kN] (backward)
  float* dat;    // warp 0's dat [W][kN][32] (backward); this warp's + w
  float* red;    // this warp's buffer of sums over lanes (backward)
};

__device__ __forceinline__ Smem carve(float* base, const Ctx& c,
                                      bool backward) {
  Smem m;
  m.a = base;
  m.carry = m.a + kPlane;
  m.prod = m.carry + 2 * kPlane;
  m.pub = m.prod + kPlane;
  m.rev = m.pub + 2 * kPlane;
  float* x = backward ? m.rev + 2 * kPlane : m.rev;  // no rev forward
  m.xch = reinterpret_cast<float4*>(x);
  float* per_warp = x + 2 * c.W * 32 * 4;
  m.bc = per_warp + c.w * 2 * kN * kL;
  m.part = per_warp + c.W * 2 * kN * kL + c.w * 2 * kL * kN;
  m.dat = per_warp + c.W * 4 * kN * kL;
  m.red = m.dat + c.W * kPlane + c.w * kRedFloats;
  return m;
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

// this thread's kL steps t0 .. t0 + kL - 1 of p [b, s, d] (zeros past T1
// and d: a zero dt is a decay of 1 and adds nothing)
__device__ __forceinline__ void load_col(const float* __restrict__ p,
                                         const Ctx& c, int t0,
                                         float (&v)[kL]) {
#pragma unroll
  for (int i = 0; i < kL; ++i) {
    v[i] = (c.on && t0 + i < c.T1) ? __ldg(p + (c.row0 + t0 + i) * c.d + c.ch)
                                   : 0.f;
  }
}

// rows t0 .. t0 + kL - 1 of X [b, s, n] (zeros past T1) into dst[j kL + i]
__device__ __forceinline__ void stage_rows(const float* __restrict__ X,
                                           const Ctx& c, int t0, float* dst) {
  const float* src = X + (c.row0 + t0) * c.n;
  for (int e = c.lane; e < kL * c.n; e += 32) {
    const int i = e / c.n, j = e - i * c.n;
    dst[j * kL + i] = t0 + i < c.T1 ? __ldg(src + e) : 0.f;
  }
}

// the kL floats of a staged row (16-byte aligned)
__device__ __forceinline__ void read_row(const float* p, float (&v)[kL]) {
#pragma unroll
  for (int q = 0; q < kL / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

// the product of the kL decays, as a tree
__device__ __forceinline__ float prod_all(const float (&v)[kL]) {
  float p[kL];
#pragma unroll
  for (int i = 0; i < kL; ++i) p[i] = v[i];
#pragma unroll
  for (int h = kL / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int i = 0; i < h; ++i) p[i] = p[i] * p[i + h];
  }
  return p[0];
}

// The 2 kL = 16 terms of v summed over the warp's 32 lanes, in a fixed
// order, through the warp's buffer: each lane stores its terms as a row;
// lane l sums column l % 16 over the 16 rows of its half (l / 16), and
// adds the other half's sum (one shuffle), so lanes l and l + 16 return
// the sum of term l % 16. Neither the 16-byte row stores nor the column
// reads meet a bank conflict (kRedStride, and the 16-float offset of the
// second half).
__device__ __forceinline__ float warp_slot_sums(float* red,
                                                const float (&v)[2 * kL],
                                                int lane) {
  static_assert(2 * kL == 16, "one term a lane of a half warp");
  float* row = red + lane * kRedStride + (lane >> 4) * 16;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    reinterpret_cast<float4*>(row)[q] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
  __syncwarp();
  const float* col =
      red + (lane >> 4) * (16 * kRedStride + 16) + (lane & 15);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) sum += col[i * kRedStride];
  return sum + __shfl_xor_sync(0xffffffffu, sum, 16);
}

// The decay exp(dt a) of a step: ex2.approx of dt (a log2 e), a having
// been scaled once a state (scale_a): one FMUL and one MUFU.EX2 where the
// accurate expf takes eight instructions (PERF.md records the error it
// adds against expf).
__device__ __forceinline__ float scale_a(float a) {
  return a * 1.4426950408889634f;
}
__device__ __forceinline__ float decay(float dt, float a2) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(dt * a2));
  return r;
}

enum Mode { kPhase1, kSaveStates, kOutput };

// One forward pass over the rank's tiles in time order, from the carry in
// plane 0 of sm.carry, two states an exchange (with an odd n the last pair's
// second state is a padding one: a = 0 and B = C = 0 rows, so a decay of 1
// that adds nothing). kPhase1: only the range's end state (in plane
// n_tiles & 1) and decay product (sm.prod); kSaveStates: also the state
// entering each tile into hst (backward, phase F); kOutput: y and, when
// h0s is not null, the state entering each chunk start.
template <int kMode, int kW>
__device__ void fwd_sweep(const Ctx& c, const Smem& sm,
                          const float* __restrict__ u,
                          const float* __restrict__ delta,
                          const float* __restrict__ B,
                          const float* __restrict__ C, float* __restrict__ y,
                          float* __restrict__ h0s, float* __restrict__ hst) {
  constexpr int tile = kW * kL;
  const int pairs = (c.n + 1) / 2;
  for (int k = 0; k < c.n_tiles; ++k) {
    const int t0 = c.T0 + k * tile + c.w * kL;
    float dt[kL], dtu[kL], yacc[kL];
    load_col(delta, c, t0, dt);
    load_col(u, c, t0, dtu);
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      dtu[i] *= dt[i];
      yacc[i] = 0.f;
    }
    stage_rows(B, c, t0, sm.bc);
    unsigned marks = 0;  // steps that open a chunk (h0s)
    float* first = nullptr;  // h0s of state 0 at the first of them
    if (kMode == kOutput) {
      stage_rows(C, c, t0, sm.bc + kN * kL);
      if (h0s != nullptr && c.on) {
#pragma unroll
        for (int i = 0; i < kL; ++i) {
          const int t = t0 + i;
          if (t < c.T1 && t % c.chunk == 0) marks |= 1u << i;
        }
        const int ci = (t0 + c.chunk - 1) / c.chunk;  // its chunk
        first = h0s + ((size_t)c.bb * c.n_chunks + ci) * c.n * c.d + c.ch;
      }
    }
    __syncwarp();
    const float* cin = sm.carry + (k & 1) * kPlane;
    float* cout = sm.carry + ((k + 1) & 1) * kPlane;
    float* hrow = kMode == kSaveStates
                      ? hst + ((size_t)(c.bb * c.R + c.rank) * c.tpr + k) *
                                  c.n * c.d
                      : nullptr;
#pragma unroll 1
    for (int jp = 0; jp < pairs; ++jp) {
      const int j = 2 * jp;
      const int q = k * pairs + jp;  // exchange buffer q & 1
      float da[2][kL], dbu[2][kL], hl[2], P[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float a2 = scale_a(sm.a[(j + m) * 32 + c.lane]);
        float bj[kL];
        read_row(sm.bc + (j + m) * kL, bj);
        hl[m] = 0.f;
#pragma unroll
        for (int i = 0; i < kL; ++i) {
          da[m][i] = decay(dt[i], a2);
          dbu[m][i] = dtu[i] * bj[i];
          hl[m] = fmaf(da[m][i], hl[m], dbu[m][i]);
        }
        P[m] = prod_all(da[m]);
      }
      float4* x = sm.xch + (q & 1) * kW * 32;
      x[c.w * 32 + c.lane] = make_float4(P[0], hl[0], P[1], hl[1]);
      __syncthreads();
      // the states entering the tile
      float h[2] = {cin[j * 32 + c.lane], cin[(j + 1) * 32 + c.lane]};
      if (kMode == kSaveStates && c.w == 0 && c.on) {
        hrow[(size_t)j * c.d + c.ch] = h[0];
        if (j + 1 < c.n) hrow[(size_t)(j + 1) * c.d + c.ch] = h[1];
      }
      if (kMode == kOutput || c.w == kW - 1) {
        // the warps before this one, in warp order
        float pr[2] = {1.f, 1.f};
#pragma unroll
        for (int v = 0; v < kW - 1; ++v) {
          if (v < c.w) {
            const float4 e = x[v * 32 + c.lane];
            h[0] = fmaf(e.x, h[0], e.y);
            h[1] = fmaf(e.z, h[1], e.w);
            pr[0] *= e.x;
            pr[1] *= e.z;
          }
        }
        if (c.w == kW - 1) {  // the tile's outgoing carries
          cout[j * 32 + c.lane] = fmaf(P[0], h[0], hl[0]);
          cout[(j + 1) * 32 + c.lane] = fmaf(P[1], h[1], hl[1]);
          if (kMode == kPhase1) {
            sm.prod[j * 32 + c.lane] *= pr[0] * P[0];
            sm.prod[(j + 1) * 32 + c.lane] *= pr[1] * P[1];
          }
        }
      }
      if (kMode == kOutput) {
        float cj[2][kL];
        read_row(sm.bc + kN * kL + j * kL, cj[0]);
        read_row(sm.bc + kN * kL + (j + 1) * kL, cj[1]);
        if (marks == 0) {  // the same arithmetic as below, no store checks
#pragma unroll
          for (int i = 0; i < kL; ++i) {
            h[0] = fmaf(da[0][i], h[0], dbu[0][i]);
            h[1] = fmaf(da[1][i], h[1], dbu[1][i]);
            yacc[i] = fmaf(cj[0][i], h[0], yacc[i]);
            yacc[i] = fmaf(cj[1][i], h[1], yacc[i]);
          }
        } else {  // the marked steps open consecutive chunks
          float* dst = first + (size_t)j * c.d;
#pragma unroll
          for (int i = 0; i < kL; ++i) {
            if (marks >> i & 1u) {
              dst[0] = h[0];
              if (j + 1 < c.n) dst[c.d] = h[1];
              dst += (size_t)c.n * c.d;
            }
            h[0] = fmaf(da[0][i], h[0], dbu[0][i]);
            h[1] = fmaf(da[1][i], h[1], dbu[1][i]);
            yacc[i] = fmaf(cj[0][i], h[0], yacc[i]);
            yacc[i] = fmaf(cj[1][i], h[1], yacc[i]);
          }
        }
      }
    }
    if (kMode == kOutput && c.on) {
#pragma unroll
      for (int i = 0; i < kL; ++i) {
        if (t0 + i < c.T1) y[(c.row0 + t0 + i) * c.d + c.ch] = yacc[i];
      }
    }
    __syncwarp();
  }
}

// Backward, ranks after the first of a cluster: gh over the rank's range
// from zero, the tiles in reverse, leaving the range's outgoing carry in
// plane n_tiles & 1 of sm.rev and its decay product in sm.prod.
template <int kW>
__device__ void rev_local_sweep(const Ctx& c, const Smem& sm,
                                const float* __restrict__ delta,
                                const float* __restrict__ C,
                                const float* __restrict__ g) {
  constexpr int tile = kW * kL;
  for (int it = 0; it < c.n_tiles; ++it) {
    const int k = c.n_tiles - 1 - it;
    const int t0 = c.T0 + k * tile + c.w * kL;
    float dt[kL], gg[kL];
    load_col(delta, c, t0, dt);
    load_col(g, c, t0, gg);
    stage_rows(C, c, t0, sm.bc + kN * kL);
    __syncwarp();
    const float* rin = sm.rev + (it & 1) * kPlane;
    float* rout = sm.rev + ((it + 1) & 1) * kPlane;
#pragma unroll 1
    for (int j = 0; j < c.n; ++j) {
      const int q = it * c.n + j;
      const float a2 = scale_a(sm.a[j * 32 + c.lane]);
      float cj[kL], da[kL];
      read_row(sm.bc + kN * kL + j * kL, cj);
#pragma unroll
      for (int i = 0; i < kL; ++i) da[i] = decay(dt[i], a2);
      float gl = 0.f;
#pragma unroll
      for (int i = kL - 1; i >= 0; --i) gl = da[i] * fmaf(cj[i], gg[i], gl);
      const float P = prod_all(da);
      float4* x = sm.xch + (q & 1) * kW * 32;
      x[c.w * 32 + c.lane] = make_float4(P, 0.f, gl, 0.f);
      __syncthreads();
      if (c.w == 0) {
        float r = rin[j * 32 + c.lane], pr = 1.f;
#pragma unroll
        for (int v = kW - 1; v >= 0; --v) {
          const float4 e = x[v * 32 + c.lane];
          r = fmaf(e.x, r, e.z);
          pr *= e.x;
        }
        rout[j * 32 + c.lane] = r;
        sm.prod[j * 32 + c.lane] *= pr;
      }
    }
    __syncwarp();
  }
}

// Backward, the tiles in reverse from the reverse carry in plane 0 of
// sm.rev, the forward state entering each tile from hst.
template <int kW>
__device__ void bwd_sweep(const Ctx& c, const Smem& sm,
                          const float* __restrict__ u,
                          const float* __restrict__ delta,
                          const float* __restrict__ B,
                          const float* __restrict__ C,
                          const float* __restrict__ g,
                          const float* hst, float* __restrict__ du,
                          float* __restrict__ ddelta,
                          float* __restrict__ db_part,
                          float* __restrict__ dc_part) {
  constexpr int tile = kW * kL;
  float* my_dat = sm.dat + c.w * kPlane;
  for (int it = 0; it < c.n_tiles; ++it) {
    const int k = c.n_tiles - 1 - it;
    const int t0 = c.T0 + k * tile + c.w * kL;
    float dt[kL], gg[kL], dtu[kL], ghb[kL], ddd[kL];
    load_col(delta, c, t0, dt);
    load_col(u, c, t0, dtu);
    load_col(g, c, t0, gg);
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      dtu[i] *= dt[i];
      ghb[i] = 0.f;
      ddd[i] = 0.f;
    }
    stage_rows(B, c, t0, sm.bc);
    stage_rows(C, c, t0, sm.bc + kN * kL);
    __syncwarp();
    const float* rin = sm.rev + (it & 1) * kPlane;
    float* rout = sm.rev + ((it + 1) & 1) * kPlane;
    const float* hrow =
        hst + ((size_t)(c.bb * c.R + c.rank) * c.tpr + k) * c.n * c.d;
    // the tile's state entering, state by state, one state ahead: written
    // by this CTA's phase F, so read through L2, not the read-only path
    float hin_next = c.on ? __ldcg(hrow + c.ch) : 0.f;
#pragma unroll 1
    for (int j = 0; j < c.n; ++j) {
      const int q = it * c.n + j;
      const float a = sm.a[j * 32 + c.lane], a2 = scale_a(a);
      const float hin = hin_next;
      if (c.on && j + 1 < c.n) {
        hin_next = __ldcg(hrow + (size_t)(j + 1) * c.d + c.ch);
      }
      float bj[kL], cj[kL], da[kL];
      read_row(sm.bc + j * kL, bj);
      read_row(sm.bc + kN * kL + j * kL, cj);
#pragma unroll
      for (int i = 0; i < kL; ++i) da[i] = decay(dt[i], a2);
      // the segment's local scans from zero: the state forward, gh back
      float hl = 0.f, gl = 0.f;
#pragma unroll
      for (int i = 0; i < kL; ++i) hl = fmaf(da[i], hl, dtu[i] * bj[i]);
#pragma unroll
      for (int i = kL - 1; i >= 0; --i) gl = da[i] * fmaf(cj[i], gg[i], gl);
      const float P = prod_all(da);
      float4* x = sm.xch + (q & 1) * kW * 32;
      x[c.w * 32 + c.lane] = make_float4(P, hl, gl, 0.f);
      __syncthreads();
      // the carries entering this segment: the forward one from the tile's
      // state and the warps before, gh from the tile's and the warps after
      float h = hin;
#pragma unroll
      for (int v = 0; v < kW - 1; ++v) {
        if (v < c.w) {
          const float4 e = x[v * 32 + c.lane];
          h = fmaf(e.x, h, e.y);
        }
      }
      float r = rin[j * 32 + c.lane];
#pragma unroll
      for (int v = kW - 1; v > 0; --v) {
        if (v > c.w) {
          const float4 e = x[v * 32 + c.lane];
          r = fmaf(e.x, r, e.z);
        }
      }
      if (c.w == 0) rout[j * 32 + c.lane] = fmaf(P, r, gl);
      // the segment's states: hs[i] enters step i, hs[i + 1] leaves it
      float hs[kL + 1];
      hs[0] = h;
#pragma unroll
      for (int i = 0; i < kL; ++i) hs[i + 1] = fmaf(da[i], hs[i], dtu[i] * bj[i]);
      float v2[2 * kL];
      float datj = 0.f;
#pragma unroll
      for (int i = kL - 1; i >= 0; --i) {
        const float gh = fmaf(cj[i], gg[i], r);
        v2[i] = gh * dtu[i];            // dB_t, this channel's term
        v2[kL + i] = hs[i + 1] * gg[i];  // dC_t, this channel's term
        ghb[i] = fmaf(gh, bj[i], ghb[i]);
        const float ghh = gh * hs[i] * da[i];
        ddd[i] = fmaf(ghh, a, ddd[i]);
        datj = fmaf(ghh, dt[i], datj);
        r = da[i] * gh;
      }
      const float sum = warp_slot_sums(sm.red, v2, c.lane);
      // term i < kL: dB of step i; kL + i: dC of step i
      if (c.lane < 2 * kL) sm.part[c.lane * kN + j] = sum;
      my_dat[j * 32 + c.lane] += datj;
    }
    __syncwarp();
    if (c.on) {
      float uu[kL];  // again (a cache hit): no registers held for it
      load_col(u, c, t0, uu);
#pragma unroll
      for (int i = 0; i < kL; ++i) {
        if (t0 + i < c.T1) {
          const size_t o = (c.row0 + t0 + i) * c.d + c.ch;
          du[o] = dt[i] * ghb[i];
          ddelta[o] = fmaf(uu[i], ghb[i], ddd[i]);
        }
      }
    }
    // this warp's dB and dC rows: kL x n floats each, contiguous
    const size_t base =
        (((size_t)c.tile_ch * c.nb + c.bb) * c.s + t0) * c.n;
    for (int e = c.lane; e < kL * c.n; e += 32) {
      const int i = e / c.n, j = e - i * c.n;
      if (t0 + i < c.T1) {
        db_part[base + e] = sm.part[i * kN + j];
        dc_part[base + e] = sm.part[(kL + i) * kN + j];
      }
    }
    __syncwarp();
  }
}

// this warp's staged B and C rows all zero: the rows of states past n stay
// so (a padding state adds nothing)
__device__ __forceinline__ void zero_rows(const Smem& sm) {
  for (int e = threadIdx.x & 31; e < 2 * kN * kL; e += 32) sm.bc[e] = 0.f;
}

__device__ __forceinline__ void init_planes(const Ctx& c, const Smem& sm,
                                            const float* __restrict__ at,
                                            bool backward) {
  for (int e = threadIdx.x; e < kPlane; e += blockDim.x) {
    const int j = e >> 5, ch = c.tile_ch * 32 + (e & 31);
    sm.a[e] = (j < c.n && ch < c.d) ? at[(size_t)j * c.d + ch] : 0.f;
    sm.carry[e] = 0.f;
    sm.prod[e] = 1.f;
    if (backward) sm.rev[e] = 0.f;
  }
}

template <int kW>
__global__ void __launch_bounds__(kW * 32, 16 / kW)
    scan_fwd_kernel(const float* __restrict__ u,
                    const float* __restrict__ delta,
                    const float* __restrict__ B, const float* __restrict__ C,
                    const float* __restrict__ at, float* __restrict__ y,
                    float* __restrict__ h0s, int s, int d, int n, int chunk,
                    int rank_len) {
  extern __shared__ float4 smem4[];
  const Ctx c = make_ctx(s, d, n, chunk, rank_len);
  const Smem sm = carve(reinterpret_cast<float*>(smem4), c, false);
  init_planes(c, sm, at, false);
  zero_rows(sm);
  __syncthreads();
  if (c.R > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (c.rank < c.R - 1) {
      fwd_sweep<kPhase1, kW>(c, sm, u, delta, B, C, nullptr, nullptr,
                             nullptr);
      __syncthreads();
      const float* end = sm.carry + (c.n_tiles & 1) * kPlane;
      for (int e = threadIdx.x; e < kPlane; e += blockDim.x) {
        sm.pub[e] = sm.prod[e];
        sm.pub[kPlane + e] = end[e];
      }
    }
    cluster_sync();
    // the carry entering this rank: the earlier ranks in rank order
    for (int e = threadIdx.x; e < kPlane; e += blockDim.x) {
      float h = 0.f;
      for (int r = 0; r < c.rank; ++r) {
        const float* p = cluster.map_shared_rank(sm.pub, r);
        h = fmaf(p[e], h, p[kPlane + e]);
      }
      sm.carry[e] = h;
    }
    cluster_arrive();  // this CTA reads no neighbour's shared memory again
    __syncthreads();
  }
  fwd_sweep<kOutput, kW>(c, sm, u, delta, B, C, y, h0s, nullptr);
  if (c.R > 1) cluster_wait();
}

template <int kW>
__global__ void __launch_bounds__(kW * 32, 16 / kW)
    scan_bwd_kernel(const float* __restrict__ u,
                    const float* __restrict__ delta,
                    const float* __restrict__ B, const float* __restrict__ C,
                    const float* __restrict__ at,
                    const float* __restrict__ h0s,
                    const float* __restrict__ g, float* __restrict__ du,
                    float* __restrict__ ddelta, float* __restrict__ db_part,
                    float* __restrict__ dc_part, float* __restrict__ dat_part,
                    float* __restrict__ hst, int s, int d, int n, int chunk,
                    int rank_len) {
  extern __shared__ float4 smem4[];
  const Ctx c = make_ctx(s, d, n, chunk, rank_len);
  const Smem sm = carve(reinterpret_cast<float*>(smem4), c, true);
  init_planes(c, sm, at, true);
  zero_rows(sm);
  for (int e = threadIdx.x; e < kW * kPlane; e += blockDim.x) {
    sm.dat[e] = 0.f;
  }
  // the anchor: the state entering the rank's first step (a chunk start)
  if (c.T0 < c.T1) {
    const float* anchor =
        h0s + ((size_t)c.bb * c.n_chunks + c.T0 / chunk) * n * d;
    for (int e = threadIdx.x; e < kPlane; e += blockDim.x) {
      const int j = e >> 5, ch = c.tile_ch * 32 + (e & 31);
      if (j < n && ch < d) sm.carry[e] = anchor[(size_t)j * d + ch];
    }
  }
  __syncthreads();
  if (c.R > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (c.rank > 0) {
      rev_local_sweep<kW>(c, sm, delta, C, g);
      __syncthreads();
      const float* end = sm.rev + (c.n_tiles & 1) * kPlane;
      for (int e = threadIdx.x; e < kPlane; e += blockDim.x) {
        sm.pub[e] = sm.prod[e];
        sm.pub[kPlane + e] = end[e];
      }
    }
    cluster_sync();
    // gh entering this rank from the right: the later ranks, last first
    for (int e = threadIdx.x; e < kPlane; e += blockDim.x) {
      float r = 0.f;
      for (int q = c.R - 1; q > c.rank; --q) {
        const float* p = cluster.map_shared_rank(sm.pub, q);
        r = fmaf(p[e], r, p[kPlane + e]);
      }
      sm.rev[e] = r;
    }
    cluster_arrive();  // this CTA reads no neighbour's shared memory again
    __syncthreads();
  }
  // phase F: the state entering each tile, from the anchor
  fwd_sweep<kSaveStates, kW>(c, sm, u, delta, B, C, nullptr, nullptr, hst);
  __syncthreads();
  bwd_sweep<kW>(c, sm, u, delta, B, C, g, hst, du, ddelta, db_part,
                dc_part);
  __syncthreads();
  // dat over the warps, in warp order
  for (int e = threadIdx.x; e < n * 32; e += blockDim.x) {
    const int j = e >> 5, ch = c.tile_ch * 32 + (e & 31);
    float sum = 0.f;
    for (int v = 0; v < kW; ++v) sum += sm.dat[v * kPlane + e];
    if (ch < d) {
      dat_part[(((size_t)c.bb * c.R + c.rank) * n + j) * d + ch] = sum;
    }
  }
  if (c.R > 1) cluster_wait();
}

// The plan's dynamic shared memory, or false for a plan or shape the
// kernels do not take: b, d and n in range, 1-16 warps, 1-8 ranks whose
// ranges of rank_len steps cover s with none empty, and (backward, more
// than one rank) ranges that start at chunk starts.
bool check_plan(int b, int s, int d, int n, int chunk, int warps, int ranks,
                int rank_len, bool backward, size_t* smem) {
  if (b < 1 || b > 65535 || s < 1 || d < 1 || (d + 31) / 32 > 65535 ||
      n < 1 || n > kN || chunk < 1) {
    return false;
  }
  if ((warps != 4 && warps != 8 && warps != 16) || ranks < 1 ||
      ranks > kMaxRanks || rank_len < 1) {
    return false;
  }
  if ((long long)rank_len * ranks < s ||
      (long long)rank_len * (ranks - 1) >= s) {
    return false;
  }
  if (backward && ranks > 1 && rank_len % chunk != 0) return false;
  *smem = sizeof(float) * (size_t)smem_floats(warps, backward);
  return *smem <= 227 * 1024;
}

cudaLaunchConfig_t make_config(int b, int d, int warps, int ranks,
                               size_t smem, cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, (d + 31) / 32, b);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ranks > 1;  // one CTA: no cluster launch
  return cfg;
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

typedef void (*FwdKernel)(const float*, const float*, const float*,
                          const float*, const float*, float*, float*, int,
                          int, int, int, int);
typedef void (*BwdKernel)(const float*, const float*, const float*,
                          const float*, const float*, const float*,
                          const float*, float*, float*, float*, float*,
                          float*, float*, int, int, int, int, int);

FwdKernel pick_fwd(int warps) {
  return warps == 4 ? scan_fwd_kernel<4>
                    : warps == 8 ? scan_fwd_kernel<8> : scan_fwd_kernel<16>;
}

BwdKernel pick_bwd(int warps) {
  return warps == 4 ? scan_bwd_kernel<4>
                    : warps == 8 ? scan_bwd_kernel<8> : scan_bwd_kernel<16>;
}

}  // namespace

extern "C" int pt_selective_scan_fwd(const float* u, const float* delta,
                                     const float* B, const float* C,
                                     const float* at, float* y, float* h0s,
                                     int b, int s, int d, int n, int chunk,
                                     int warps, int ranks, int rank_len,
                                     void* stream) {
  size_t smem = 0;
  if (!check_plan(b, s, d, n, chunk, warps, ranks, rank_len, false, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  const FwdKernel kernel = pick_fwd(warps);
  int err = set_smem(kernel, smem);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = make_config(b, d, warps, ranks, smem,
                                             (cudaStream_t)stream, attr);
  err = (int)cudaLaunchKernelEx(&cfg, kernel, u, delta, B, C, at, y, h0s, s,
                                d, n, chunk, rank_len);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

extern "C" int pt_selective_scan_bwd(const float* u, const float* delta,
                                     const float* B, const float* C,
                                     const float* at, const float* h0s,
                                     const float* g, float* du,
                                     float* ddelta, float* db_part,
                                     float* dc_part, float* dat_part,
                                     float* hst, int b, int s, int d, int n,
                                     int chunk, int warps, int ranks,
                                     int rank_len, void* stream) {
  size_t smem = 0;
  if (!check_plan(b, s, d, n, chunk, warps, ranks, rank_len, true, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  const BwdKernel kernel = pick_bwd(warps);
  int err = set_smem(kernel, smem);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = make_config(b, d, warps, ranks, smem,
                                             (cudaStream_t)stream, attr);
  err = (int)cudaLaunchKernelEx(&cfg, kernel, u, delta, B, C, at, h0s, g, du,
                                ddelta, db_part, dc_part, dat_part, hst, s,
                                d, n, chunk, rank_len);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// A plan's dynamic shared memory and how many clusters of its ranks the
// card holds at once (cudaOccupancyMaxActiveClusters);
// cudaErrorInvalidValue for a plan the kernels do not take.
extern "C" int pt_selective_scan_plan(int b, int s, int d, int n, int chunk,
                                      int warps, int ranks, int rank_len,
                                      int backward, int* smem_out,
                                      int* clusters_out) {
  size_t smem = 0;
  if (!check_plan(b, s, d, n, chunk, warps, ranks, rank_len, backward != 0,
                  &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  const void* kernel = backward ? (const void*)pick_bwd(warps)
                                : (const void*)pick_fwd(warps);
  int err = backward ? set_smem(pick_bwd(warps), smem)
                     : set_smem(pick_fwd(warps), smem);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = make_config(1, 32, warps, ranks, smem, 0, attr);
  cfg.numAttrs = 1;
  *smem_out = (int)smem;
  return (int)cudaOccupancyMaxActiveClusters(clusters_out, kernel, &cfg);
}
