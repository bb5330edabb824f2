// Causal flash attention with packed-sequence segment ids for Hopper
// (sm_90a): a forward kernel and the backward pair (dk/dv, dq), behind a
// plain C interface that distributedtraining_tpu_torch/ops/flash_attention.py
// loads with ctypes.
//
// Replaces the Pallas TPU library kernels that the JAX package's
// ops/flash_attention.py:flash_attention calls
// (jax/experimental/pallas/ops/tpu/flash_attention.py):
//   dt_flash_fwd      <- _flash_attention_impl (:589, pallas_call :758)
//   dt_flash_bwd_dkv  <- _flash_attention_bwd_dkv (:941, pallas_call :1121)
//   dt_flash_bwd_dq   <- _flash_attention_bwd_dq (:1287, pallas_call :1456)
//
// What they compute, per batch row b and head h, with s = q_i . k_j / sqrt(D)
// and visible(i, j) = j <= i and seg[b, i] == seg[b, j] (no segment test when
// seg is null):
//   forward:  o_i = sum_j P_ij v_j,  P_ij = exp(s_ij - lse_i) on visible
//             pairs and exactly 0 elsewhere, lse_i = m_i + log l_i (running
//             max m_i and normaliser l_i of an f32 online softmax).
//   dk/dv:    dv_j = sum_i P_ij do_i,  dk_j = sum_i dS_ij q_i / sqrt(D)
//   dq:       dq_i = sum_j dS_ij k_j / sqrt(D)
//   with dS_ij = P_ij (do_i . v_j - di_i), di_i = o_i . do_i (computed by
//   the caller with one PyTorch op, as the library computes it in XLA).
// Every accumulator is f32; outputs are rounded once, to the input dtype
// (lse is f32). Each output element is written by exactly one thread, so
// the results are deterministic: no atomics.
//
// Bound. At the GPT-2-124M training shape (B 8, T 1024, H 12, D 64, bf16)
// one layer's forward is two T x T x D products over the causal half,
// 2 * 2 * T^2 / 2 * D * B * H = 12.9 GFLOP, and moves q, k, v and o once,
// 4 * 12.6 MB: about 13 us of tensor-core work at 989 TFLOP/s against 15 us
// of bytes at 3.35 TB/s, so bytes bound it. The backward does five such
// products (s again, dP, dV, dQ, dK): 32 GFLOP, about 33 us, above its
// ~88 MB of bytes (26 us), so operations bound it. (H100 SXM data sheet.)
// With packed documents only the same-document pairs need work (12.7% of
// the causal pairs in a batch of the synthetic corpus), and bytes bound
// all three kernels at 15-23 us.
//
// Two routes, one per dtype, sharing the tiling, the masks, the tile
// skipping and the launch:
//  - bf16, the training path: the tensor cores, through mma.sync m16n8k16
//    (bf16 in, f32 accumulation). A block of 4 warps owns a 64-row tile,
//    16 rows a warp; tiles of q, k, v and do sit in shared memory as bf16,
//    rows padded by 8 elements so that the fragment loads hit 32 banks.
//    Scores stay in the accumulator registers: the online softmax reduces a
//    row over the 4 lanes that hold it, and P (dS in the backward) is
//    rounded to bf16 and re-packed in registers as the A operand of the
//    next product, which is where the library rounds them too
//    (p.astype(v.dtype), ds.astype(k.dtype) before its MXU products).
//  - f32: the CUDA cores, f32 FMA (no TF32), so the route agrees with the
//    plain version to summation order. A 64 x 64 tile of scores is shared
//    by 256 threads in a 16 x 16 grid; each thread owns 4 rows x 4 columns,
//    strided by 16, so a row's 16 owners are one half-warp. Tiles are
//    staged as f32 with one float of padding per row (stride D + 1).
// The kernels:
//  - forward: one block per (query tile, b * h), heaviest tiles first; it
//    walks the key tiles up to the diagonal, keeps (m, l, acc) in registers.
//    The bf16 forward first builds, once a block, the list of key tiles it
//    will walk: the diagonal tile, then the earlier tiles whose id range
//    meets the query tile's, found by one coalesced pass over the segment
//    ids of rows [0, q0 + 64) (each warp reduces whole key tiles to their
//    id range; warp 0 keeps tiles by ballot). The q tile and the diagonal
//    tile are copied while the ids are read. The listed tiles' k, v and
//    ids stream through a two-stage cp.async ring, so the next tile loads
//    while the tensor cores work on this one; Q's A fragments are loaded
//    once (ldmatrix.x4) and kept in registers, K's B fragments come by
//    ldmatrix.x4 and V's by ldmatrix.x4.trans, and the softmax runs in
//    exp2f with log2(e) folded into the scale (lse is stored in natural
//    log units, as the backward reads it).
//  - dk/dv: one block per (key tile, b * h); it walks the query tiles from
//    the diagonal down, recomputes P^T and dS^T for the tile, and
//    accumulates dV and dK in registers.
//  - dq: one block per (query tile, b * h); it walks the key tiles up to
//    the diagonal, recomputes dS, accumulates dQ.
//    The bf16 backward pair walks lists built by the forward's id pass
//    (build_tile_list): dq the forward's own list, dk/dv its transpose
//    (the diagonal query tile, then the later ones whose id range meets
//    the key tile's, from one pass over the ids of rows [k0, T)). The
//    listed tiles (dq: k, v, ids; dk/dv: q, do, lse, di, ids) stream
//    through a two-stage cp.async ring; every fragment comes by ldmatrix
//    (the own tile's A fragments kept in registers at D 64), and P is
//    exp2 of the scores scaled by log2(e) / sqrt(D) less lse in log2
//    units.
// Packing: a tile pair none of whose segment ids can match is skipped
// whole. The f32 kernels test each causal tile in turn (its ids all
// outside the other tile's id range: one __syncthreads_or over the tile's
// ids); the bf16 kernels walk their lists (ranges that do not meet), a
// rule that lists a superset. With documents of ~110 tokens in 1024-token
// rows most causal tiles are of other documents, so the work follows the
// visible pairs, not T^2 / 2. Inside a tile every pair is still masked one
// by one: a tile may be partly visible.
// q, k, v and do are read through their (batch, token, head) element
// strides, so the views of the fused [B, T, 3E] projection (token stride
// 3E) are read in place, without a copy; the head dim must be contiguous,
// and in bf16 every row must start 16-byte aligned (strides multiples of 8
// elements), as the fused projection's views do.
// Outputs are contiguous [B, T, H, D]; lse and di are contiguous [B, H, T].
// Rows and keys at or past T (the ragged last tile) are loaded as 0,
// masked, and never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;                  // query and key rows per tile
constexpr int kSide = 16;                  // f32: 16 x 16 threads per tile
constexpr int kThreads = kSide * kSide;
constexpr int kPer = kTile / kSide;        // rows (and columns) a thread owns
constexpr int kLdP = kTile + 1;            // padded row of a score tile
constexpr int kWarps = kTile / 16;         // bf16: a warp per 16 rows
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kPad = 8;                    // bf16 tile row padding
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;        // a block's shared memory, sm_90

// reductions over the 16 lanes (one half-warp) that own one row (f32)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = kSide / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = kSide / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// reductions over the 4 lanes (one quad) that hold one row of an mma
// accumulator (bf16)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

struct Strides {
  long long b, t, h;  // element strides of a [B, T, H, D] view
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* seg;     // [B, T] or null
  const void* dout;   // backward: do
  const float* lse;   // backward: [B, H, T]
  const float* di;    // backward: [B, H, T]
  void* o;            // forward: [B, T, H, D]
  float* lse_out;     // forward: [B, H, T]
  void* dq;
  void* dk;
  void* dv;
  int B, T, H;
  Strides sq, sk, sv, sdo;
  float scale;
};

// segment ids of rows [row0, row0 + kTile) into dst (0 past T, and 0
// everywhere without packing); returns whether this thread's row is real
// and its id lies in [lo, hi]
__device__ __forceinline__ bool load_seg(int* dst, const Params& p, int b,
                                         int row0, int lo = 0, int hi = 0) {
  bool in = false;
  if (threadIdx.x < kTile) {
    const int t = row0 + threadIdx.x;
    const int id = (p.seg != nullptr && t < p.T)
                       ? p.seg[(long long)b * p.T + t] : 0;
    dst[threadIdx.x] = id;
    in = t < p.T && id >= lo && id <= hi;
  }
  return in;
}

// smallest and largest segment id among the real rows of a tile whose ids
// sit in shared memory (every thread computes it; call after a barrier)
__device__ __forceinline__ int2 seg_range(const int* ids, int row0, int T) {
  int lo = ids[0], hi = ids[0];
  const int n = min(kTile, T - row0);
  for (int i = 1; i < n; ++i) {
    lo = min(lo, ids[i]);
    hi = max(hi, ids[i]);
  }
  return make_int2(lo, hi);
}

// per-row f32 values [B, H, T] of rows [row0, row0 + kTile); 0 past T
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          const Params& p, int b, int h,
                                          int row0) {
  if (threadIdx.x < kTile) {
    const int t = row0 + threadIdx.x;
    dst[threadIdx.x] =
        t < p.T ? src[((long long)b * p.H + h) * p.T + t] : 0.f;
  }
}

__device__ __forceinline__ long long out_index(const Params& p, int b,
                                               int t, int h, int D) {
  return (((long long)b * p.T + t) * p.H + h) * D;
}

// ===========================================================================
// f32 route: CUDA-core FMA
// ===========================================================================

// rows [row0, row0 + kTile) of one (b, h) slice into dst[kTile][D + 1];
// rows at or past T read as 0
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const void* src,
                                          const Strides s, int b, int h,
                                          int row0, int n_rows) {
  const float* base = static_cast<const float*>(src) + b * s.b + h * s.h;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int t = row0 + r;
    dst[r * (D + 1) + d] = t < n_rows ? base[(long long)t * s.t + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int LD = D + 1;
  constexpr int DC = D / kSide;  // output columns a thread owns
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sP = sV + kTile * LD;  // [kTile][kLdP]
  int* sSegQ = reinterpret_cast<int*>(sP + kTile * kLdP);
  int* sSegK = sSegQ + kTile;

  const int n_tiles = (p.T + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.y;  // longest walks start first
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int rg = threadIdx.x / kSide, cg = threadIdx.x % kSide;
  const int q0 = qt * kTile;

  load_tile<D>(sQ, p.q, p.sq, b, h, q0, p.T);
  load_seg(sSegQ, p, b, q0);
  __syncthreads();
  const int2 q_ids = seg_range(sSegQ, q0, p.T);

  float m[kPer], l[kPer], acc[kPer][DC];
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's sK / sV / sP reads are done
    // a key tile none of whose ids lies in the query tile's id range
    // holds no visible pair (another document): skip it whole
    if (!__syncthreads_or(load_seg(sSegK, p, b, k0, q_ids.x, q_ids.y)))
      continue;
    load_tile<D>(sK, p.k, p.sk, b, h, k0, p.T);
    load_tile<D>(sV, p.v, p.sv, b, h, k0, p.T);
    __syncthreads();

    float s[kPer][kPer];
#pragma unroll
    for (int a = 0; a < kPer; ++a)
#pragma unroll
      for (int c = 0; c < kPer; ++c) s[a][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kPer], kv[kPer];
#pragma unroll
      for (int a = 0; a < kPer; ++a) qv[a] = sQ[(rg + kSide * a) * LD + d];
#pragma unroll
      for (int c = 0; c < kPer; ++c) kv[c] = sK[(cg + kSide * c) * LD + d];
#pragma unroll
      for (int a = 0; a < kPer; ++a)
#pragma unroll
        for (int c = 0; c < kPer; ++c) s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
    }

#pragma unroll
    for (int a = 0; a < kPer; ++a) {
      const int ri = rg + kSide * a;
      const int qi = q0 + ri;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int cj = cg + kSide * c;
        const int kj = k0 + cj;
        const bool ok = kj <= qi && kj < p.T &&
                        (p.seg == nullptr || sSegQ[ri] == sSegK[cj]);
        s[a][c] = ok ? s[a][c] * p.scale : -INFINITY;
        mx = fmaxf(mx, s[a][c]);
      }
      const float m_new = fmaxf(m[a], row_max(mx));
      // a row that has seen no visible key yet keeps m = -inf: exponents
      // are then taken against 0 so that no inf - inf appears
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[a] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const float pv = expf(s[a][c] - m_use);  // exp(-inf) = 0 if masked
        sP[ri * kLdP + cg + kSide * c] = pv;
        rs += pv;
      }
      l[a] = l[a] * alpha + row_sum(rs);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = sV[kk * LD + cg + kSide * c];
#pragma unroll
      for (int a = 0; a < kPer; ++a) {
        const float pv = sP[(rg + kSide * a) * kLdP + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] = fmaf(pv, vv[c], acc[a][c]);
      }
    }
  }

  float* o = static_cast<float*>(p.o);
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int qi = q0 + rg + kSide * a;
    if (qi >= p.T) continue;
    const float inv = l[a] > 0.f ? 1.f / l[a] : 0.f;
    float* dst = o + out_index(p, b, qi, h, D);
#pragma unroll
    for (int c = 0; c < DC; ++c) dst[cg + kSide * c] = acc[a][c] * inv;
    if (cg == 0)
      p.lse_out[((long long)b * p.H + h) * p.T + qi] =
          l[a] > 0.f ? m[a] + logf(l[a]) : -INFINITY;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = D + 1;
  constexpr int DC = D / kSide;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;
  float* sDo = sQ + kTile * LD;
  float* sPt = sDo + kTile * LD;   // P^T  [key][query]
  float* sDst = sPt + kTile * kLdP;  // dS^T [key][query]
  float* sLse = sDst + kTile * kLdP;
  float* sDi = sLse + kTile;
  int* sSegQ = reinterpret_cast<int*>(sDi + kTile);
  int* sSegK = sSegQ + kTile;

  const int n_tiles = (p.T + kTile - 1) / kTile;
  const int kt = blockIdx.y;  // key tile 0 walks every query tile: first
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int rg = threadIdx.x / kSide, cg = threadIdx.x % kSide;
  const int k0 = kt * kTile;

  load_tile<D>(sK, p.k, p.sk, b, h, k0, p.T);
  load_tile<D>(sV, p.v, p.sv, b, h, k0, p.T);
  load_seg(sSegK, p, b, k0);
  __syncthreads();
  const int2 k_ids = seg_range(sSegK, k0, p.T);

  float dk[kPer][DC], dv[kPer][DC];
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[a][c] = dv[a][c] = 0.f;

  for (int qt = kt; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    // a query tile of other documents only: nothing to add
    if (!__syncthreads_or(load_seg(sSegQ, p, b, q0, k_ids.x, k_ids.y)))
      continue;
    load_tile<D>(sQ, p.q, p.sq, b, h, q0, p.T);
    load_tile<D>(sDo, p.dout, p.sdo, b, h, q0, p.T);
    load_rows(sLse, p.lse, p, b, h, q0);
    load_rows(sDi, p.di, p, b, h, q0);
    __syncthreads();

    // this thread's keys rg + 16a against queries cg + 16c
    float s[kPer][kPer], dp[kPer][kPer];
#pragma unroll
    for (int a = 0; a < kPer; ++a)
#pragma unroll
      for (int c = 0; c < kPer; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[kPer], vv[kPer], qv[kPer], dov[kPer];
#pragma unroll
      for (int a = 0; a < kPer; ++a) {
        kv[a] = sK[(rg + kSide * a) * LD + d];
        vv[a] = sV[(rg + kSide * a) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        qv[c] = sQ[(cg + kSide * c) * LD + d];
        dov[c] = sDo[(cg + kSide * c) * LD + d];
      }
#pragma unroll
      for (int a = 0; a < kPer; ++a)
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          s[a][c] = fmaf(kv[a], qv[c], s[a][c]);
          dp[a][c] = fmaf(vv[a], dov[c], dp[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < kPer; ++a) {
      const int rj = rg + kSide * a;
      const int kj = k0 + rj;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int ci = cg + kSide * c;
        const int qi = q0 + ci;
        // masked pairs are exactly 0 in P and dS: a key tile wholly
        // visible by causality can still be cut by segments
        const bool ok = qi < p.T && kj <= qi &&
                        (p.seg == nullptr || sSegQ[ci] == sSegK[rj]);
        const float pv = ok ? expf(s[a][c] * p.scale - sLse[ci]) : 0.f;
        sPt[rj * kLdP + ci] = pv;
        sDst[rj * kLdP + ci] = pv * (dp[a][c] - sDi[ci]);
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q over this query tile
#pragma unroll 4
    for (int ii = 0; ii < kTile; ++ii) {
      float dov[DC], qv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dov[c] = sDo[ii * LD + cg + kSide * c];
        qv[c] = sQ[ii * LD + cg + kSide * c];
      }
#pragma unroll
      for (int a = 0; a < kPer; ++a) {
        const float pt = sPt[(rg + kSide * a) * kLdP + ii];
        const float dst = sDst[(rg + kSide * a) * kLdP + ii];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv[a][c] = fmaf(pt, dov[c], dv[a][c]);
          dk[a][c] = fmaf(dst, qv[c], dk[a][c]);
        }
      }
    }
  }

  float* dk_out = static_cast<float*>(p.dk);
  float* dv_out = static_cast<float*>(p.dv);
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int kj = k0 + rg + kSide * a;
    if (kj >= p.T) continue;
    const long long base = out_index(p, b, kj, h, D);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk_out[base + cg + kSide * c] = dk[a][c] * p.scale;
      dv_out[base + cg + kSide * c] = dv[a][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = D + 1;
  constexpr int DC = D / kSide;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDo = sQ + kTile * LD;
  float* sK = sDo + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sDs = sV + kTile * LD;  // dS [query][key]
  float* sLse = sDs + kTile * kLdP;
  float* sDi = sLse + kTile;
  int* sSegQ = reinterpret_cast<int*>(sDi + kTile);
  int* sSegK = sSegQ + kTile;

  const int n_tiles = (p.T + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.y;  // longest walks start first
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int rg = threadIdx.x / kSide, cg = threadIdx.x % kSide;
  const int q0 = qt * kTile;

  load_tile<D>(sQ, p.q, p.sq, b, h, q0, p.T);
  load_tile<D>(sDo, p.dout, p.sdo, b, h, q0, p.T);
  load_rows(sLse, p.lse, p, b, h, q0);
  load_rows(sDi, p.di, p, b, h, q0);
  load_seg(sSegQ, p, b, q0);
  __syncthreads();
  const int2 q_ids = seg_range(sSegQ, q0, p.T);

  float dq[kPer][DC];
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[a][c] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    if (!__syncthreads_or(load_seg(sSegK, p, b, k0, q_ids.x, q_ids.y)))
      continue;
    load_tile<D>(sK, p.k, p.sk, b, h, k0, p.T);
    load_tile<D>(sV, p.v, p.sv, b, h, k0, p.T);
    __syncthreads();

    // this thread's queries rg + 16a against keys cg + 16c
    float s[kPer][kPer], dp[kPer][kPer];
#pragma unroll
    for (int a = 0; a < kPer; ++a)
#pragma unroll
      for (int c = 0; c < kPer; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kPer], dov[kPer], kv[kPer], vv[kPer];
#pragma unroll
      for (int a = 0; a < kPer; ++a) {
        qv[a] = sQ[(rg + kSide * a) * LD + d];
        dov[a] = sDo[(rg + kSide * a) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        kv[c] = sK[(cg + kSide * c) * LD + d];
        vv[c] = sV[(cg + kSide * c) * LD + d];
      }
#pragma unroll
      for (int a = 0; a < kPer; ++a)
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
          dp[a][c] = fmaf(dov[a], vv[c], dp[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < kPer; ++a) {
      const int ri = rg + kSide * a;
      const int qi = q0 + ri;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int cj = cg + kSide * c;
        const int kj = k0 + cj;
        const bool ok = qi < p.T && kj <= qi &&
                        (p.seg == nullptr || sSegQ[ri] == sSegK[cj]);
        const float pv = ok ? expf(s[a][c] * p.scale - sLse[ri]) : 0.f;
        sDs[ri * kLdP + cj] = pv * (dp[a][c] - sDi[ri]);
      }
    }
    __syncthreads();

    // dQ += dS K over this key tile
#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      float kv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = sK[jj * LD + cg + kSide * c];
#pragma unroll
      for (int a = 0; a < kPer; ++a) {
        const float ds = sDs[(rg + kSide * a) * kLdP + jj];
#pragma unroll
        for (int c = 0; c < DC; ++c) dq[a][c] = fmaf(ds, kv[c], dq[a][c]);
      }
    }
  }

  float* dq_out = static_cast<float*>(p.dq);
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int qi = q0 + rg + kSide * a;
    if (qi >= p.T) continue;
    const long long base = out_index(p, b, qi, h, D);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dq_out[base + cg + kSide * c] = dq[a][c] * p.scale;
  }
}

// ===========================================================================
// bf16 route: tensor cores, mma.sync m16n8k16
// ===========================================================================
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), lane = 4 g + t:
//   A 16 x 16, row-major: reg 0 (row g, cols 2t, 2t+1), reg 1 (row g+8),
//     reg 2 (row g, cols 2t+8, 2t+9), reg 3 (row g+8, cols 2t+8, 2t+9);
//   B 16 x 8: reg 0 (rows 2t, 2t+1 of column g), reg 1 (rows 2t+8, 2t+9);
//   C 16 x 8, f32: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// Two accumulator tiles side by side (16 x 16) thus hold exactly the
// elements of one A fragment: P and dS go from one product to the next
// without leaving the registers.

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A fragment of accumulator tiles c0 (columns 0-7) and c1 (8-15),
// rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4],
                                         const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// ldmatrix.x4 row addresses into a row-major [rows][LD] bf16 tile at
// shared address s (lanes 0-7, 8-15, 16-23, 24-31 address the rows of the
// four 8 x 8 matrices):
// the A fragment of rows r0 + [0, 16) by columns c0 + [0, 16) (matrices:
// rows 0-7 / 8-15 by columns 0-7, then by columns 8-15)
template <int LD>
__device__ __forceinline__ uint32_t a_frag_addr(uint32_t s, int r0, int c0,
                                                int lane) {
  return s + (uint32_t)((r0 + lane % 16) * LD + c0 + 8 * (lane / 16)) * 2;
}

// the B fragments of X^T, B[k][n] = X[n0 + n][k0 + k], for two 8-column
// blocks (regs 0-1: n in [0, 8), regs 2-3: n in [8, 16)), by ldmatrix.x4
template <int LD>
__device__ __forceinline__ uint32_t bt_frag_addr(uint32_t s, int n0, int k0,
                                                 int lane) {
  return s + (uint32_t)((n0 + lane % 8 + 8 * (lane / 16)) * LD + k0 +
                        8 * ((lane / 8) % 2)) * 2;
}

// the B fragments of X itself, B[k][n] = X[k0 + k][n0 + n], for two
// 8-column blocks, by ldmatrix.x4.trans
template <int LD>
__device__ __forceinline__ uint32_t b_frag_addr(uint32_t s, int k0, int n0,
                                                int lane) {
  return s + (uint32_t)((k0 + lane % 8 + 8 * ((lane / 8) % 2)) * LD + n0 +
                        8 * (lane / 16)) * 2;
}

// --- tile lists and cp.async rings -----------------------------------------

// stages of the bf16 kernels' cp.async rings (three were slower in each:
// the forward at D 64 drops from four blocks an SM to three)
constexpr int kStages = 2;

// shared memory of the bf16 forward: the q tile, the ring of k and v tiles
// and their segment ids, the q tile's ids, and per key tile its id range
// and the list (a count, then the tiles)
template <int D>
size_t fwd_mma_smem(int n_tiles) {
  const size_t tile = (size_t)kTile * (D + kPad) * sizeof(bf16);
  return (1 + 2 * kStages) * tile + (size_t)(kStages + 1) * kTile * 4 +
         (size_t)(3 * n_tiles + 1) * 4;
}

// shared memory of a bf16 backward kernel: its own two tiles, the ring of
// two streamed tiles and their rows of 64 values (dk/dv: lse, di and ids
// a stage; dq: ids), the own tile's rows (dk/dv: ids; dq: lse, di, ids),
// and per tile its id range and the list
template <int D>
size_t bwd_mma_smem(bool dkv, int n_tiles) {
  const size_t tile = (size_t)kTile * (D + kPad) * sizeof(bf16);
  const size_t rows = dkv ? 3 * kStages + 1 : kStages + 3;
  return (2 + 2 * kStages) * tile + rows * kTile * 4 +
         (size_t)(3 * n_tiles + 1) * 4;
}

// rows [row0, row0 + kTile) of one (b, h) slice into the [kTile][D + kPad]
// bf16 tile at shared address dst with cp.async, 16 bytes a copy (the
// wrapper admits only views whose rows start 16-byte aligned); rows at or
// past T are zero-filled
template <int D>
__device__ __forceinline__ void copy_tile_bf16(uint32_t dst, const void* src,
                                               const Strides s, int b, int h,
                                               int row0, int n_rows) {
  constexpr int LD = D + kPad;
  constexpr int kChunks = D / 8;
  const bf16* base = static_cast<const bf16*>(src) + b * s.b + h * s.h;
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kMmaThreads; ++i) {
    const int e = threadIdx.x + i * kMmaThreads;
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const int t = row0 + r;
    const bf16* src_row = base + (long long)min(t, n_rows - 1) * s.t + c;
    cp_async16(dst + (uint32_t)(r * LD + c) * 2, src_row, t < n_rows ? 16 : 0);
  }
}

// the segment ids of rows [row0, row0 + kTile) of one batch row into the
// shared address dst with cp.async, one a thread i in [0, kTile); 0 past T
__device__ __forceinline__ void copy_ids(uint32_t dst, const int* seg, int T,
                                         int row0, int i) {
  cp_async4(dst + 4 * i, seg + min(row0 + i, T - 1), row0 + i < T ? 4 : 0);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// rows [row0, row0 + kTile) of the f32 values `row` (one (b, h) row of a
// [B, H, T] array) into shared memory at dst with cp.async, shared by the
// threads i in [0, kTile): where the row starts 16-byte aligned (`vec`,
// the same for every tile of a block), 16-byte copies of 4 values by i <
// kTile / 4, else one 4-byte copy a thread; values at or past T are
// zero-filled. rows_of_thread names the values thread i copied.
__device__ __forceinline__ void copy_rows_f32(float* dst, const float* row,
                                              int T, int row0, int i,
                                              bool vec) {
  const int n = T - row0;  // real rows, >= 1
  if (vec) {
    if (i >= kTile / 4) return;
    const int real = min(max(n - 4 * i, 0), 4);
    cp_async16(smem_u32(dst + 4 * i), row + row0 + (real > 0 ? 4 * i : 0),
               4 * real);
  } else {
    cp_async4(smem_u32(dst + i), row + row0 + min(i, n - 1), i < n ? 4 : 0);
  }
}

// the values of a copy_rows_f32 segment that thread i copied: [first,
// first + count)
__device__ __forceinline__ int2 rows_of_thread(int i, bool vec) {
  if (vec) return i < kTile / 4 ? make_int2(4 * i, 4) : make_int2(0, 0);
  return make_int2(i, 1);
}

// The tiles a bf16 block walks, built once a block: its own tile `own`
// first, then the tiles of [first, last] other than own whose range of
// segment ids meets own's, ascending (without ids, every tile of [first,
// last]). own is first or last: the forward and dq list key tiles [0, qt]
// for query tile qt, dk/dv lists query tiles [kt, n_tiles) for key tile
// kt, the transpose of the same rule. One coalesced pass over the ids of
// those tiles' rows: each warp reduces whole tiles to their id range
// (kIds tiles at a time, all their loads in flight) into lo_of / hi_of
// (indexed by tile), the warp that reads own's ids keeps them in own_ids;
// warp 0 then keeps tiles by ballot. list: the count, then the tiles.
// Ends with a barrier; returns the count.
__device__ __forceinline__ int build_tile_list(const int* seg, int T,
                                               int own, int first, int last,
                                               int* own_ids, int* lo_of,
                                               int* hi_of, int* list) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (seg == nullptr) {
    for (int i = threadIdx.x; i < last - first; i += kMmaThreads)
      list[2 + i] = first + i + (first + i >= own ? 1 : 0);
    if (threadIdx.x == 0) {
      list[0] = last - first + 1;
      list[1] = own;
    }
  } else {
    constexpr int kIds = 4;
    for (int t0 = first + warp; t0 <= last; t0 += kWarps * kIds) {
      int a[kIds][2];
#pragma unroll
      for (int u = 0; u < kIds; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int tile = t0 + u * kWarps, i = tile * kTile + 32 * e + lane;
          a[u][e] = tile <= last && i < T ? seg[i] : 0;
        }
#pragma unroll
      for (int u = 0; u < kIds; ++u) {
        const int tile = t0 + u * kWarps;
        if (tile > last) break;  // warp-uniform
        const bool v0 = tile * kTile + lane < T;
        const bool v1 = tile * kTile + 32 + lane < T;
        int lo = min(v0 ? a[u][0] : INT_MAX, v1 ? a[u][1] : INT_MAX);
        int hi = max(v0 ? a[u][0] : INT_MIN, v1 ? a[u][1] : INT_MIN);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          lo = min(lo, __shfl_xor_sync(kFull, lo, o));
          hi = max(hi, __shfl_xor_sync(kFull, hi, o));
        }
        if (lane == 0) {
          lo_of[tile] = lo;
          hi_of[tile] = hi;
        }
        if (tile == own) {
          own_ids[lane] = a[u][0];
          own_ids[lane + 32] = a[u][1];
        }
      }
    }
    __syncthreads();
    if (warp == 0) {
      const int own_lo = lo_of[own], own_hi = hi_of[own];
      int count = 1;
      for (int base = first; base <= last; base += 32) {
        const int tile = base + lane;
        const bool keep = tile <= last && tile != own &&
                          lo_of[tile] <= own_hi && hi_of[tile] >= own_lo;
        const unsigned m = __ballot_sync(kFull, keep);
        if (keep) list[1 + count + __popc(m & ((1u << lane) - 1))] = tile;
        count += __popc(m);
      }
      if (lane == 0) {
        list[0] = count;
        list[1] = own;
      }
    }
  }
  __syncthreads();
  return list[0];
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, D == 64 ? 4 : 1)
    flash_fwd_mma_kernel(const Params p) {
  constexpr int LD = D + kPad;
  constexpr int NK = kTile / 8;  // accumulator tiles across a key tile
  constexpr int ND = D / 8;      // accumulator tiles across the head dim
  constexpr int S = kStages;
  constexpr uint32_t kTileBytes = kTile * LD * sizeof(bf16);
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const uint32_t sQ = smem_u32(smem_mma);
  const uint32_t sKV = sQ + kTileBytes;  // stage i: k at 2 i, v at 2 i + 1
  int* sSegK = reinterpret_cast<int*>(smem_mma + (1 + 2 * S) * kTileBytes);
  int* sSegQ = sSegK + S * kTile;

  const int n_tiles = (p.T + kTile - 1) / kTile;
  int* sLo = sSegQ + kTile;  // [n_tiles]
  int* sHi = sLo + n_tiles;
  int* sList = sHi + n_tiles;  // the count, then the listed key tiles
  const int qt = n_tiles - 1 - blockIdx.y;  // longest walks start first
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int warp = threadIdx.x / 32;
  const int r0 = warp * 16;  // this warp's rows of the tile
  const int q0 = qt * kTile;
  const int* seg = p.seg == nullptr ? nullptr : p.seg + (long long)b * p.T;

  // key tile kt (its k, v and ids) into ring stage st
  auto copy_kv = [&](int kt, int st) {
    const int k0 = kt * kTile;
    const uint32_t dst = sKV + st * 2 * kTileBytes;
    copy_tile_bf16<D>(dst, p.k, p.sk, b, h, k0, p.T);
    copy_tile_bf16<D>(dst + kTileBytes, p.v, p.sv, b, h, k0, p.T);
    if (seg != nullptr && threadIdx.x < kTile)
      copy_ids(smem_u32(sSegK + st * kTile), seg, p.T, k0, threadIdx.x);
  };
  // the q tile and the diagonal key tile, which is always walked (first),
  // go out before the list is known: their loads overlap the id pass
  copy_tile_bf16<D>(sQ, p.q, p.sq, b, h, q0, p.T);
  copy_kv(qt, 0);
  cp_async_commit();
  // the diagonal, then the earlier key tiles whose id range meets the q
  // tile's
  const int count = build_tile_list(seg, p.T, qt, 0, qt, sSegQ, sLo, sHi,
                                    sList);

  // listed tile j into ring stage j % S; one commit group a tile, empty
  // past the list, so that the waits count alike
  auto issue = [&](int j) {
    if (j < count) copy_kv(sList[1 + j], j % S);
    cp_async_commit();
  };
#pragma unroll
  for (int j = 1; j < S - 1; ++j) issue(j);

  // Q's A fragments, once, for the whole walk
  cp_async_wait<S - 2>();
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)
    ldmatrix_x4(qf[kd], a_frag_addr<LD>(sQ, r0, kd * 16, lane));
  const int seg_q[2] = {seg == nullptr ? 0 : sSegQ[r0 + g],
                        seg == nullptr ? 0 : sSegQ[r0 + g + 8]};
  const float sc = p.scale * kLog2e;  // log2(e) / sqrt(D)

  // rows r0 + g (index 0) and r0 + g + 8 (index 1) of the tile; m is in
  // log2 units
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int j = 0; j < count; ++j) {
    cp_async_wait<S - 2>();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    issue(j + S - 1);
    const int k0 = sList[1 + j] * kTile;
    const uint32_t sK = sKV + (j % S) * 2 * kTileBytes;
    const uint32_t sV = sK + kTileBytes;
    const int* seg_k = sSegK + (j % S) * kTile;

    // S = Q K^T for this warp's 16 rows; one ldmatrix.x4 gives the B
    // fragments of two 8-key blocks
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
#pragma unroll
      for (int n = 0; n < NK; n += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, bt_frag_addr<LD>(sK, n * 8, kd * 16, lane));
        mma16816(s[n], qf[kd], kb);
        mma16816(s[n + 1], qf[kd], kb + 2);
      }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int col = n * 8 + 2 * t;  // and col + 1
      const int2 ids = seg == nullptr
                           ? make_int2(0, 0)
                           : *reinterpret_cast<const int2*>(seg_k + col);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kj = k0 + col + i % 2;
        const bool ok = kj <= q0 + r0 + g + 8 * (i / 2) && kj < p.T &&
                        seg_q[i / 2] == (i % 2 ? ids.y : ids.x);
        s[n][i] = ok ? s[n][i] * sc : -INFINITY;
        mx[i / 2] = fmaxf(mx[i / 2], s[n][i]);
      }
    }
    float m_use[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      // a row that has seen no visible key yet keeps m = -inf: exponents
      // are then taken against 0 so that no inf - inf appears
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m[r] - m_use[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = exp2f(s[n][i] - m_use[i / 2]);  // exp2(-inf) = 0 if masked
        rs[i / 2] += s[n][i];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] *= alpha[i / 2];

    // acc += P V, P in bf16 straight from the score registers; V's B
    // fragments by ldmatrix.x4.trans
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, b_frag_addr<LD>(sV, kk * 16, n * 8, lane));
        mma16816(acc[n], a, vb);
        mma16816(acc[n + 1], a, vb + 2);
      }
    }
  }
  cp_async_wait<0>();

  bf16* o = static_cast<bf16*>(p.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    if (qi >= p.T) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    bf16* dst = o + out_index(p, b, qi, h, D) + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    // lse in natural-log units: (m + log2 l) ln 2
    if (t == 0)
      p.lse_out[((long long)b * p.H + h) * p.T + qi] =
          l[r] > 0.f ? m[r] * 0.6931471805599453f + logf(l[r]) : -INFINITY;
  }
}

// The bf16 backward pair. Each walks its tile list (build_tile_list) and
// streams the listed tiles through a kStages-stage cp.async ring; the
// own tile and the diagonal tile are copied before the list exists. Every
// fragment comes by ldmatrix, the own tile's A fragments from the tile it
// copied once (dk/dv: K and V, held in registers at D 64; dq: Q and dO,
// read for each tile, which keeps it at 3 blocks an SM). P = exp2(s *
// scale * log2(e) - lse * log2(e)), each lse converted to log2 units once
// (dq: the own rows, in registers; dk/dv: each streamed value by the
// thread that copied it, after its wait and before the barrier that
// publishes it).

// dk/dv: one block per (key tile, b * h); its 4 warps own 16 keys each. It
// walks its own (diagonal) query tile, then the later query tiles whose id
// range meets the key tile's: the transpose of dq's list. Per query tile,
// in passes of 32 (D 64) or 16 (D 128) queries, so that S^T and dP^T fit
// beside the accumulators: S^T = K Q^T and dP^T = V dO^T (B fragments of
// Q^T and dO^T by ldmatrix.x4), P^T and dS^T in the registers, then dV +=
// P^T dO and dK += dS^T Q (B fragments of dO and Q by ldmatrix.x4.trans).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkv_mma_kernel(const Params p) {
  constexpr int LD = D + kPad;
  constexpr int ND = D / 8;  // accumulator tiles across the head dim
  constexpr int S = kStages;
  // K's and V's A fragments stay in registers for the walk at D 64; at D
  // 128 they would not fit beside dK and dV and come from shared memory
  // for each tile
  constexpr bool kHoldA = D == 64;
  // a query tile in kParts passes of kTile / kParts queries, so that S^T
  // and dP^T take 64 / kParts registers a thread beside dK and dV
  constexpr int kParts = D == 64 ? 2 : 4;
  constexpr int NP = kTile / 8 / kParts;  // accumulator tiles a pass
  constexpr uint32_t kTileBytes = kTile * LD * sizeof(bf16);
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const uint32_t sK = smem_u32(smem_mma);
  const uint32_t sV = sK + kTileBytes;
  const uint32_t sQD = sV + kTileBytes;  // stage i: q at 2 i, do at 2 i + 1
  // stage i: lse, di, ids at (3 i, 3 i + 1, 3 i + 2) * kTile
  float* sRows = reinterpret_cast<float*>(smem_mma + (2 + 2 * S) * kTileBytes);
  int* sSegK = reinterpret_cast<int*>(sRows + 3 * S * kTile);

  const int n_tiles = (p.T + kTile - 1) / kTile;
  int* sLo = sSegK + kTile;  // [n_tiles]
  int* sHi = sLo + n_tiles;
  int* sList = sHi + n_tiles;  // the count, then the listed query tiles
  const int kt = blockIdx.y;  // key tile 0 walks the most: first
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = threadIdx.x / 32 * 16;  // this warp's keys of the tile
  const int k0 = kt * kTile;
  const int* seg = p.seg == nullptr ? nullptr : p.seg + (long long)b * p.T;
  const long long row = ((long long)b * p.H + h) * p.T;
  const bool lse_vec = aligned16(p.lse + row), di_vec = aligned16(p.di + row);

  // query tile qt (q, do, lse, di, ids) into ring stage st: lse by threads
  // 0-63, di and the ids by threads 64-127
  auto copy_q = [&](int qt, int st) {
    const int q0 = qt * kTile;
    const uint32_t dst = sQD + st * 2 * kTileBytes;
    copy_tile_bf16<D>(dst, p.q, p.sq, b, h, q0, p.T);
    copy_tile_bf16<D>(dst + kTileBytes, p.dout, p.sdo, b, h, q0, p.T);
    float* rows = sRows + st * 3 * kTile;
    if (threadIdx.x < kTile) {
      copy_rows_f32(rows, p.lse + row, p.T, q0, threadIdx.x, lse_vec);
    } else {
      const int i = threadIdx.x - kTile;
      copy_rows_f32(rows + kTile, p.di + row, p.T, q0, i, di_vec);
      if (seg != nullptr)
        copy_ids(smem_u32(rows + 2 * kTile), seg, p.T, q0, i);
    }
  };
  // the k and v tiles and the diagonal query tile go out before the list
  // is known: their loads overlap the id pass over rows [k0, T)
  copy_tile_bf16<D>(sK, p.k, p.sk, b, h, k0, p.T);
  copy_tile_bf16<D>(sV, p.v, p.sv, b, h, k0, p.T);
  copy_q(kt, 0);
  cp_async_commit();
  const int count = build_tile_list(seg, p.T, kt, kt, n_tiles - 1, sSegK,
                                    sLo, sHi, sList);

  // listed tile j into ring stage j % S; one commit group a tile, empty
  // past the list, so that the waits count alike
  auto issue = [&](int j) {
    if (j < count) copy_q(sList[1 + j], j % S);
    cp_async_commit();
  };
#pragma unroll
  for (int j = 1; j < S - 1; ++j) issue(j);
  // the lse values this thread copies, converted to log2 units by it
  const int2 mine = rows_of_thread(threadIdx.x, lse_vec);

  cp_async_wait<S - 2>();
  __syncthreads();
  uint32_t kf[kHoldA ? D / 16 : 1][4], vf[kHoldA ? D / 16 : 1][4];
  if constexpr (kHoldA) {
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      ldmatrix_x4(kf[kd], a_frag_addr<LD>(sK, r0, kd * 16, lane));
      ldmatrix_x4(vf[kd], a_frag_addr<LD>(sV, r0, kd * 16, lane));
    }
  }
  const int seg_k[2] = {seg == nullptr ? 0 : sSegK[r0 + g],
                        seg == nullptr ? 0 : sSegK[r0 + g + 8]};
  const float sc = p.scale * kLog2e;

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  for (int j = 0; j < count; ++j) {
    cp_async_wait<S - 2>();
    float* lse = sRows + (j % S) * 3 * kTile;
    if (threadIdx.x < kTile)
      for (int e = 0; e < mine.y; ++e) lse[mine.x + e] *= kLog2e;
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    issue(j + S - 1);
    const int q0 = sList[1 + j] * kTile;
    const uint32_t sQ = sQD + (j % S) * 2 * kTileBytes;
    const uint32_t sDo = sQ + kTileBytes;
    const float* di = lse + kTile;
    const int* seg_q = reinterpret_cast<const int*>(lse + 2 * kTile);

#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      const int c0 = part * (kTile / kParts);  // this pass's first query
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x the pass's
      // queries
      float st[NP][4], dpt[NP][4];
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[n][i] = dpt[n][i] = 0.f;
      // at D 128 two head-dim steps at a time: unrolled whole, the
      // loads the compiler hoists spill the registers
#pragma unroll (D == 64 ? D / 16 : 2)
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t ak[4], av[4];
        if constexpr (kHoldA) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ak[i] = kf[kd][i];
            av[i] = vf[kd][i];
          }
        } else {
          ldmatrix_x4(ak, a_frag_addr<LD>(sK, r0, kd * 16, lane));
          ldmatrix_x4(av, a_frag_addr<LD>(sV, r0, kd * 16, lane));
        }
#pragma unroll
        for (int n = 0; n < NP; n += 2) {
          uint32_t qb[4], ob[4];
          ldmatrix_x4(qb, bt_frag_addr<LD>(sQ, c0 + n * 8, kd * 16, lane));
          ldmatrix_x4(ob, bt_frag_addr<LD>(sDo, c0 + n * 8, kd * 16, lane));
          mma16816(st[n], ak, qb);
          mma16816(st[n + 1], ak, qb + 2);
          mma16816(dpt[n], av, ob);
          mma16816(dpt[n + 1], av, ob + 2);
        }
      }
      // P^T into st, dS^T into dpt; masked pairs are exactly 0 in both: a
      // listed tile can still be cut by causality and by segments
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        const int col = c0 + n * 8 + 2 * t;  // and col + 1
        const float2 l2 = *reinterpret_cast<const float2*>(lse + col);
        const float2 d2 = *reinterpret_cast<const float2*>(di + col);
        const int2 ids = seg == nullptr
                             ? make_int2(0, 0)
                             : *reinterpret_cast<const int2*>(seg_q + col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = q0 + col + i % 2;
          const bool ok = k0 + r0 + g + 8 * (i / 2) <= qi && qi < p.T &&
                          seg_k[i / 2] == (i % 2 ? ids.y : ids.x);
          const float pv =
              ok ? exp2f(st[n][i] * sc - (i % 2 ? l2.y : l2.x)) : 0.f;
          st[n][i] = pv;
          dpt[n][i] = pv * (dpt[n][i] - (i % 2 ? d2.y : d2.x));
        }
      }
      // dV += P^T dO, dK += dS^T Q over this pass's queries
#pragma unroll
      for (int kk = 0; kk < NP / 2; ++kk) {
        uint32_t ap[4], ads[4];
        acc_to_a(ap, st[2 * kk], st[2 * kk + 1]);
        acc_to_a(ads, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < ND; n += 2) {
          uint32_t ob[4], qb[4];
          ldmatrix_x4_trans(ob, b_frag_addr<LD>(sDo, c0 + kk * 16, n * 8,
                                                lane));
          ldmatrix_x4_trans(qb, b_frag_addr<LD>(sQ, c0 + kk * 16, n * 8,
                                                lane));
          mma16816(dv[n], ap, ob);
          mma16816(dv[n + 1], ap, ob + 2);
          mma16816(dk[n], ads, qb);
          mma16816(dk[n + 1], ads, qb + 2);
        }
      }
    }
  }
  cp_async_wait<0>();

  bf16* dk_out = static_cast<bf16*>(p.dk);
  bf16* dv_out = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + r0 + g + 8 * r;
    if (kj >= p.T) continue;
    const long long base = out_index(p, b, kj, h, D) + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk_out + base + n * 8) =
          __floats2bfloat162_rn(dk[n][2 * r] * p.scale,
                                dk[n][2 * r + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_out + base + n * 8) =
          __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// dq: one block per (query tile, b * h), longest walks first; its 4 warps
// own 16 queries each. It walks the forward's list: the diagonal key tile,
// then the earlier key tiles whose id range meets the query tile's. Per
// key tile: S = Q K^T and dP = dO V^T (B fragments of K^T and V^T by
// ldmatrix.x4), dS in the registers, then dQ += dS K (B fragments of K by
// ldmatrix.x4.trans).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_mma_kernel(const Params p) {
  constexpr int LD = D + kPad;
  constexpr int NK = kTile / 8;  // accumulator tiles across a key tile
  constexpr int ND = D / 8;
  constexpr int S = kStages;
  constexpr uint32_t kTileBytes = kTile * LD * sizeof(bf16);
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const uint32_t sQ = smem_u32(smem_mma);
  const uint32_t sDo = sQ + kTileBytes;
  const uint32_t sKV = sDo + kTileBytes;  // stage i: k at 2 i, v at 2 i + 1
  float* sLse = reinterpret_cast<float*>(smem_mma + (2 + 2 * S) * kTileBytes);
  float* sDi = sLse + kTile;
  int* sSegK = reinterpret_cast<int*>(sDi + kTile);  // [S][kTile]
  int* sSegQ = sSegK + S * kTile;

  const int n_tiles = (p.T + kTile - 1) / kTile;
  int* sLo = sSegQ + kTile;  // [n_tiles]
  int* sHi = sLo + n_tiles;
  int* sList = sHi + n_tiles;  // the count, then the listed key tiles
  const int qt = n_tiles - 1 - blockIdx.y;  // longest walks start first
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = threadIdx.x / 32 * 16;  // this warp's rows of the tile
  const int q0 = qt * kTile;
  const int* seg = p.seg == nullptr ? nullptr : p.seg + (long long)b * p.T;
  const long long row = ((long long)b * p.H + h) * p.T;

  // key tile kt (its k, v and ids) into ring stage st
  auto copy_kv = [&](int kt, int st) {
    const int k0 = kt * kTile;
    const uint32_t dst = sKV + st * 2 * kTileBytes;
    copy_tile_bf16<D>(dst, p.k, p.sk, b, h, k0, p.T);
    copy_tile_bf16<D>(dst + kTileBytes, p.v, p.sv, b, h, k0, p.T);
    if (seg != nullptr && threadIdx.x < kTile)
      copy_ids(smem_u32(sSegK + st * kTile), seg, p.T, k0, threadIdx.x);
  };
  // the own tile (q, do, lse by threads 0-63, di by 64-127) and the
  // diagonal key tile go out before the list is known
  copy_tile_bf16<D>(sQ, p.q, p.sq, b, h, q0, p.T);
  copy_tile_bf16<D>(sDo, p.dout, p.sdo, b, h, q0, p.T);
  if (threadIdx.x < kTile)
    copy_rows_f32(sLse, p.lse + row, p.T, q0, threadIdx.x,
                  aligned16(p.lse + row));
  else
    copy_rows_f32(sDi, p.di + row, p.T, q0, threadIdx.x - kTile,
                  aligned16(p.di + row));
  copy_kv(qt, 0);
  cp_async_commit();
  const int count = build_tile_list(seg, p.T, qt, 0, qt, sSegQ, sLo, sHi,
                                    sList);

  // listed tile j into ring stage j % S; one commit group a tile, empty
  // past the list, so that the waits count alike
  auto issue = [&](int j) {
    if (j < count) copy_kv(sList[1 + j], j % S);
    cp_async_commit();
  };
#pragma unroll
  for (int j = 1; j < S - 1; ++j) issue(j);

  cp_async_wait<S - 2>();
  __syncthreads();
  // rows r0 + g (index 0) and r0 + g + 8 (index 1): lse in log2 units
  const float lse2[2] = {sLse[r0 + g] * kLog2e, sLse[r0 + g + 8] * kLog2e};
  const float di[2] = {sDi[r0 + g], sDi[r0 + g + 8]};
  const int seg_q[2] = {seg == nullptr ? 0 : sSegQ[r0 + g],
                        seg == nullptr ? 0 : sSegQ[r0 + g + 8]};
  const float sc = p.scale * kLog2e;

  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;

  for (int j = 0; j < count; ++j) {
    cp_async_wait<S - 2>();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    issue(j + S - 1);
    const int k0 = sList[1 + j] * kTile;
    const uint32_t sK = sKV + (j % S) * 2 * kTileBytes;
    const uint32_t sV = sK + kTileBytes;
    const int* seg_k = sSegK + (j % S) * kTile;

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x 64 keys
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      // Q's and dO's A fragments from shared memory for each tile: held
      // in registers for the walk they cost a block an SM (3 blocks at
      // 162 registers, 2 at 177, at D 64)
      uint32_t aq[4], ao[4];
      ldmatrix_x4(aq, a_frag_addr<LD>(sQ, r0, kd * 16, lane));
      ldmatrix_x4(ao, a_frag_addr<LD>(sDo, r0, kd * 16, lane));
#pragma unroll
      for (int n = 0; n < NK; n += 2) {
        uint32_t kb[4], vb[4];
        ldmatrix_x4(kb, bt_frag_addr<LD>(sK, n * 8, kd * 16, lane));
        ldmatrix_x4(vb, bt_frag_addr<LD>(sV, n * 8, kd * 16, lane));
        mma16816(s[n], aq, kb);
        mma16816(s[n + 1], aq, kb + 2);
        mma16816(dp[n], ao, vb);
        mma16816(dp[n + 1], ao, vb + 2);
      }
    }
    // dS into dp (exactly 0 where masked)
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int col = n * 8 + 2 * t;  // and col + 1
      const int2 ids = seg == nullptr
                           ? make_int2(0, 0)
                           : *reinterpret_cast<const int2*>(seg_k + col);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + r0 + g + 8 * (i / 2);
        const bool ok = k0 + col + i % 2 <= qi && qi < p.T &&
                        seg_q[i / 2] == (i % 2 ? ids.y : ids.x);
        const float pv = ok ? exp2f(s[n][i] * sc - lse2[i / 2]) : 0.f;
        dp[n][i] = pv * (dp[n][i] - di[i / 2]);
      }
    }

    // dQ += dS K over this key tile
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, b_frag_addr<LD>(sK, kk * 16, n * 8, lane));
        mma16816(dq[n], a, kb);
        mma16816(dq[n + 1], a, kb + 2);
      }
    }
  }
  cp_async_wait<0>();

  bf16* dq_out = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    if (qi >= p.T) continue;
    const long long base = out_index(p, b, qi, h, D) + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dq_out + base + n * 8) =
          __floats2bfloat162_rn(dq[n][2 * r] * p.scale,
                                dq[n][2 * r + 1] * p.scale);
  }
}

// ===========================================================================
// launch
// ===========================================================================

enum class Which { kFwd, kDkv, kDq };

// dynamic shared memory of each kernel: the f32 route's q/k/v/do tiles,
// score tiles and per-row values / segment ids; the bf16 kernels'
// (fwd_mma_smem, bwd_mma_smem) grow with their tile lists
template <int D>
size_t smem_bytes(Which w, bool bf16_route, int n_tiles) {
  if (bf16_route)
    return w == Which::kFwd ? fwd_mma_smem<D>(n_tiles)
                            : bwd_mma_smem<D>(w == Which::kDkv, n_tiles);
  const size_t rows = (size_t)kTile * sizeof(float);
  const size_t tile = (size_t)kTile * (D + 1) * sizeof(float);
  const size_t scores = (size_t)kTile * kLdP * sizeof(float);
  switch (w) {
    case Which::kFwd: return 3 * tile + scores + 2 * rows;
    case Which::kDkv: return 4 * tile + 2 * scores + 4 * rows;
    default: return 4 * tile + scores + 4 * rows;
  }
}

template <int D>
cudaError_t launch(Which w, bool bf16_route, const Params& p,
                   cudaStream_t stream) {
  const int n_tiles = (p.T + kTile - 1) / kTile;
  const size_t bytes = smem_bytes<D>(w, bf16_route, n_tiles);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  void (*kernel)(const Params);
  if (bf16_route)
    kernel = w == Which::kFwd   ? flash_fwd_mma_kernel<D>
             : w == Which::kDkv ? flash_bwd_dkv_mma_kernel<D>
                                : flash_bwd_dq_mma_kernel<D>;
  else
    kernel = w == Which::kFwd   ? flash_fwd_kernel<D>
             : w == Which::kDkv ? flash_bwd_dkv_kernel<D>
                                : flash_bwd_dq_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  // b * h along x, tiles along y: blocks start in x-major order, so every
  // (b, h) starts its longest tile before any starts a short one
  const dim3 grid(p.B * p.H, n_tiles);
  kernel<<<grid, bf16_route ? kMmaThreads : kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// strides: (batch, token, head) element strides of q, k, v, then do
cudaError_t run(Which w, Params& p, int B, int T, int H, int D,
                const long long* strides, int dtype, int device,
                void* stream) {
  if (B < 1 || T < 1 || H < 1 || (T + kTile - 1) / kTile > 65535 ||
      (dtype != 0 && dtype != 1) || (D != 64 && D != 128))
    return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  p.B = B;
  p.T = T;
  p.H = H;
  Strides* all[4] = {&p.sq, &p.sk, &p.sv, &p.sdo};
  const int n = w == Which::kFwd ? 3 : 4;
  for (int i = 0; i < n; ++i)
    *all[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.scale = 1.0f / sqrtf((float)D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16_route = dtype == 1;
  return D == 64 ? launch<64>(w, bf16_route, p, s)
                 : launch<128>(w, bf16_route, p, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. device: the CUDA device the tensors and
// the stream belong to (this library links its own static CUDA runtime,
// whose current device is not the caller's). seg may be null (no packing).
// Each returns a cudaError_t (0 = launched).
extern "C" int dt_flash_fwd(const void* q, const void* k, const void* v,
                            const void* seg, void* o, void* lse, int B,
                            int T, int H, int D, const long long* strides,
                            int dtype, int device, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.seg = static_cast<const int*>(seg);
  p.o = o;
  p.lse_out = static_cast<float*>(lse);
  return run(Which::kFwd, p, B, T, H, D, strides, dtype, device, stream);
}

extern "C" int dt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* seg, const void* dout,
                                const void* lse, const void* di, void* dk,
                                void* dv, int B, int T, int H, int D,
                                const long long* strides, int dtype,
                                int device, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.seg = static_cast<const int*>(seg);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.dk = dk;
  p.dv = dv;
  return run(Which::kDkv, p, B, T, H, D, strides, dtype, device, stream);
}

extern "C" int dt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* seg, const void* dout,
                               const void* lse, const void* di, void* dq,
                               int B, int T, int H, int D,
                               const long long* strides, int dtype,
                               int device, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.seg = static_cast<const int*>(seg);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.dq = dq;
  return run(Which::kDq, p, B, T, H, D, strides, dtype, device, stream);
}
