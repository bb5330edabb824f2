// Paged-attention decode for Hopper (sm_90a), behind a plain C interface
// that distributedtraining_tpu_torch/ops/paged_attention.py loads with
// ctypes.
//
// Replaces: distributedtraining_tpu/ops/paged_attention.py:_decode_kernel
// (the Pallas TPU kernel that _build_call wraps in pl.pallas_call).
//
// What it computes, for every slot b and query head j = h * G + g
// (G = Hq / Hkv query heads share kv head h):
//   out[b, j] = softmax over { q[b, j] . k_t / sqrt(D) } of the v_t, where
//   t runs over the slot's context positions t < min(seq_lens[b], MP * P),
//   read from page page_tables[b, t / P] at row t % P of one layer's pool
//   [pages, P, Hkv, D], plus the step's own fresh column (k_new, v_new),
//   which is not in the pool yet. Positions at or past seq_lens[b] are
//   never read, so the contents of padded table entries (trash page 0)
//   cannot reach the output. Loads are in the pool dtype (f32 or bf16);
//   all arithmetic is f32.
//
// Bound: bytes. The work is one multiply-add per loaded K element and one
// per V element for each of the G query heads of the group: about G f32
// operations per byte of bf16 K/V (G / 2 for f32), far below the ~20 per
// byte at which the CUDA cores (67 TFLOP/s f32 against 3.35 TB/s, H100
// SXM data sheet) would be the limit. So the least time is the bytes
// over 3.35 TB/s:
//   sum_b min(seq_len_b, MP * P) * Hkv * D * 2 * sizeof(dtype)
// of K and V, plus q, k_new, v_new, out and the tables.
//
// Design: flash-decoding, the context split across blocks. Reaching the
// memory rate takes many bytes in flight; a slot's context walked by one
// block (the first design here) kept a few rows in flight and left a third
// of the SMs idle at serving shapes. One call enqueues two kernels:
//  - split: grid (Hkv, B, S). Block (h, b, s) owns context positions
//    [s C, s C + C) of slot b, C a multiple of P chosen by the host
//    planner (ops/paged_attention.py:plan_split, from the table's width,
//    never from seq_lens, so the call reads nothing back from the card).
//    A block whose chunk starts at or past the slot's context exits at
//    once. The rest read the chunk's table entries once, then copy every
//    K and V row of the chunk's real positions into shared memory with
//    cp.async, 16 bytes a thread, all in flight before the first use (K
//    and V in two groups, so the scores start while V still lands). The
//    scores of the G query rows (lanes split a row in 16-byte pieces and
//    reduce with shuffles), their max m and sum l (exp2f, log2(e) folded
//    into the scale) and the unnormalised acc[D] = sum_t p_t v_t go to an
//    f32 scratch [B, Hq, S, D + 2] (acc, then m, then l) that the wrapper
//    allocates.
//  - merge: grid (Hq, B), D threads. It folds the slot's active splits
//    (ceil(ctx / C) of them: the same rule the split kernel exits by) and
//    the fresh column, whose score it computes, into one online softmax,
//    and writes acc / l in the pool dtype. l >= 1 always: the largest
//    score contributes exp(0).
// The kernel allocates nothing; the C entry launches both kernels on the
// caller's stream and returns the first launch error.
//
// The window kernels (dt_paged_window, dt_paged_window_split) serve the
// forwards with more than one query a slot: the speculative verify (W =
// draft_k + 1 queries a slot) and the prefix cache's suffix prefill (one
// slot, W from the prefill ladder). They replace no Pallas kernel: the JAX
// package computes this in XLA (ops/paged_attention.py:paged_decode_reference
// with Tq > 1, ops/attention.py:cached_attention's mask). Query t of slot b
// sees the slot's context positions t' < min(seq_lens[b], MP * P), read
// through the page table, and the window's own fresh rows 0..t (k_new,
// v_new [B, W, Hkv, D], not in the pool yet): causal inside the window.
//
// Bound, at the two shapes the server runs (GPT-2: Hq = Hkv = 12, D 64,
// bf16; H100 SXM data sheet):
//  - verify, B 8, W 5, contexts 8-900: 8.3 MB of K/V against 0.22 GFLOP,
//    bytes: 2.6 us at 3.35 TB/s. With 5 queries a slot, a block has little
//    to do per byte, so what sets the time is how many bytes are in flight
//    across the card and the latency of each block's walk.
//  - suffix prefill, B 1, W 512 over 900 positions: 1.82 GFLOP against
//    4 MB, 1.84 us at 989 TFLOP/s. The operations bound holds only on the
//    tensor cores: the first design here, on the CUDA cores in f32 FMA,
//    took 0.21 ms, 4.7x behind SDPA. wgmma would add little: at 1.8 us of
//    tensor-core work, bytes, latency and the grid's fill set the time,
//    so mma.sync suffices. (Times: PERF.md, from chip_smoke.py.)
//
// Design, bf16 (paged_window_mma_kernel):
//  - rows: a slot's W * G (query, head-of-group) pairs of kv head h, row
//    t * G + g; a block of 4 warps owns a 64-row tile, 16 rows a warp, so
//    a GQA group's query heads share every K/V tile they read. A warp with
//    no real row (the verify's 5 rows fill one warp of four) only copies.
//  - the keys a block walks, in 64-row tiles: the context's tiles, then
//    the window's fresh tiles. Context tiles at or past the slot's context
//    and fresh tiles past the tile's last query are skipped (both lists are
//    prefixes, so the walk is two ranges, not a list in memory); a tile
//    that every row of a warp sees whole is not masked.
//  - products on the tensor cores, mma.sync m16n8k16 (bf16 in, f32
//    accumulation): S = Q K^T with Q's A fragments held in registers, the
//    scores kept in the accumulators under an f32 online softmax (exp2f,
//    log2(e) / sqrt(D) folded into the exponent). P is not rounded once to
//    bf16, as the flash kernel rounds it: over hundreds of positions that
//    moves outputs past the card's bf16 limit (chip_smoke.py
//    _window_bf16_ratio; tests/test_torch_paged_window.py holds both).
//    P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi), and acc +=
//    P_hi V + P_lo V (two products), which keeps P to ~16 bits, so the
//    output is rounded only at the store.
//  - K/V rows reach shared memory by cp.async, 16 bytes a lane, through
//    the page table (a shift for a power-of-two page), into a 4-stage ring
//    of 64-row tiles, rows padded by 16 bytes for ldmatrix; rows past the
//    context or the window are zero-filled and never read from device
//    memory.
//  - the walk is split across blocks when the grid is short (the verify's
//    96 (kv head, slot) pairs, a suffix prefill's 8 row tiles x 12 heads):
//    grid (row tiles, Hkv, B x splits), split s walks key tiles [s T, s T +
//    T) of the list, T chosen by the host planner
//    (ops/paged_attention.py:plan_window) from shapes alone. Each split
//    writes an f32 partial (acc, m, l) a row; a merge kernel folds a row's
//    splits (those whose walk is not empty: the rule the split kernel
//    exits by), 4 columns a thread, and writes acc / l in bf16. Folding
//    them in the last block of each row tile instead (an atomic count)
//    was slower: one block a row tile then reads all its partials. With
//    one split the kernel writes the output itself and no merge runs.
// Design, f32 (paged_window_f32_kernel): the CUDA cores, f32 FMA (no TF32),
// so it agrees with the plain version to summation order; no split. Grid
// (Hq, B, ceil(W / 8)); a block of 4 warps owns 8 queries of one head (2 a
// warp) and walks the slot's context in tiles of 32 rows, then the fresh
// rows its last query can see, through a two-stage cp.async ring. A warp
// scores a query against a tile's 32 rows (lane r, row r) and accumulates
// P V with its lanes on the head's columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kThreads = 128;  // split kernel: threads a block
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90

struct Args {
  const void* q;            // [B, Hq, D]
  const void* k_pages;      // [pages, P, Hkv, D], one layer
  const void* v_pages;
  const int* page_tables;   // [B, MP]
  const int* seq_lens;      // [B]
  const void* k_new;        // [B, Hkv, D]
  const void* v_new;
  float* part;              // [B, Hq, S, D + 2] f32 scratch
  void* out;                // [B, Hq, D]
  int batch, n_kv_heads, page_size, max_pages, chunk, splits;
  float scale;              // log2(e) / sqrt(D)
};

// the values in 16 bytes of a row, as f32
__device__ __forceinline__ void load16(const float* p, float* o) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* o) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// two neighbouring values of a row, as f32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int context(const Args& a, int b) {
  return max(0, min(a.seq_lens[b], a.max_pages * a.page_size));
}

// shared memory of the split kernel: K and V rows of a chunk, the scores
// [G][C], the PV product's per-row-group sums [256 / D ... ][G][D], (m, l)
// per query row and the chunk's page numbers
template <typename T, int D, int G>
constexpr size_t split_smem(int chunk, int page_size) {
  return 2 * (size_t)chunk * D * sizeof(T) + (size_t)G * chunk * 4 +
         (size_t)(2 * kThreads / D) * G * D * 4 + 2 * G * 4 +
         (size_t)(chunk / page_size) * 4;
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
    paged_decode_split_kernel(const Args a) {
  constexpr int V16 = 16 / sizeof(T);  // values in 16 bytes
  constexpr int L = D / V16;           // 16-byte pieces a row
  constexpr int RP = kThreads / L;     // rows a pass of the score loop
  constexpr int DP = D / 2;            // column pairs of the PV product
  constexpr int RS = kThreads / DP;    // its row groups
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int C = a.chunk, P = a.page_size;
  const int c0 = split * C;
  const int ctx = context(a, b);
  if (c0 >= ctx) return;
  const int n = min(C, ctx - c0);  // real positions of this chunk
  const int hq = a.n_kv_heads * G;

  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);  // [C][D]
  T* sV = sK + (size_t)C * D;
  float* sS = reinterpret_cast<float*>(sV + (size_t)C * D);  // [G][C]
  float* sRed = sS + G * C;                                   // [RS][G][D]
  float* sML = sRed + RS * G * D;                             // [G][2]
  int* sPage = reinterpret_cast<int*>(sML + 2 * G);           // [C / P]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int* table = a.page_tables + (size_t)b * a.max_pages + c0 / P;
  for (int i = tid; i * P < n; i += kThreads) sPage[i] = table[i];

  // this thread's 16-byte piece of the G query rows, pre-scaled
  const int pc = tid % L;
  float qr[G][V16];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load16(static_cast<const T*>(a.q) +
               ((size_t)b * hq + (size_t)h * G + g) * D + pc * V16,
           qr[g]);
#pragma unroll
    for (int i = 0; i < V16; ++i) qr[g][i] *= a.scale;
  }
  __syncthreads();

  // every real row of the chunk, K then V, all in flight
  const size_t row = (size_t)a.n_kv_heads * D;
  const T* kp = static_cast<const T*>(a.k_pages) + (size_t)h * D;
  const T* vp = static_cast<const T*>(a.v_pages) + (size_t)h * D;
  for (int e = tid; e < n * L; e += kThreads) {
    const int r = e / L, c = e % L;
    const size_t off = ((size_t)sPage[r / P] * P + r % P) * row + c * V16;
    cp_async16(smem_u32(sK + r * D + c * V16), kp + off);
  }
  cp_async_commit();
  for (int e = tid; e < n * L; e += kThreads) {
    const int r = e / L, c = e % L;
    const size_t off = ((size_t)sPage[r / P] * P + r % P) * row + c * V16;
    cp_async16(smem_u32(sV + r * D + c * V16), vp + off);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // scores: L lanes a row, 16 bytes each, reduced across the L lanes
  const int passes = (n + RP - 1) / RP;
  for (int k = 0; k < passes; ++k) {
    const int r = k * RP + tid / L;
    float kr[V16];
    if (r < n) {
      load16(sK + r * D + pc * V16, kr);
    } else {
#pragma unroll
      for (int i = 0; i < V16; ++i) kr[i] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < V16; ++i) s = fmaf(qr[g][i], kr[i], s);
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (pc == 0 && r < n) sS[g * C + r] = s;
    }
  }
  __syncthreads();

  // the chunk's max and sum per query row; the scores become p
  for (int g = warp; g < G; g += kWarps) {
    float m = -INFINITY;
    for (int r = lane; r < n; r += 32) m = fmaxf(m, sS[g * C + r]);
    m = warp_max(m);
    float l = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float p = exp2f(sS[g * C + r] - m);
      sS[g * C + r] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      sML[2 * g] = m;
      sML[2 * g + 1] = l;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // acc = sum_t p_t v_t: thread (rs, dp) owns columns 2 dp, 2 dp + 1 of
  // the rows rs, rs + RS, ...
  const int dp = tid % DP, rs = tid / DP;
  float acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;
  for (int r = rs; r < n; r += RS) {
    const float2 v = load2(sV + r * D + 2 * dp);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = sS[g * C + r];
      acc[g][0] = fmaf(p, v.x, acc[g][0]);
      acc[g][1] = fmaf(p, v.y, acc[g][1]);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    sRed[(rs * G + g) * D + 2 * dp] = acc[g][0];
    sRed[(rs * G + g) * D + 2 * dp + 1] = acc[g][1];
  }
  __syncthreads();

  const size_t stride = (size_t)a.splits * (D + 2);  // one query row
  float* part = a.part + ((size_t)b * hq + (size_t)h * G) * stride +
                (size_t)split * (D + 2);
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < RS; ++i) sum += sRed[(i * G + g) * D + d];
    part[g * stride + d] = sum;
  }
  if (tid < 2 * G) part[(tid / 2) * stride + D + tid % 2] = sML[tid];
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(D) paged_decode_merge_kernel(const Args a) {
  const int j = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int h = j / G;
  const int hq = a.n_kv_heads * G;
  __shared__ float red[D / 32];

  // the fresh column's score, reduced over the block
  const size_t new_off = ((size_t)b * a.n_kv_heads + h) * D + d;
  const float qd = to_f32(static_cast<const T*>(a.q)[((size_t)b * hq + j) *
                                                         D + d]);
  float s = warp_sum(qd * a.scale *
                     to_f32(static_cast<const T*>(a.k_new)[new_off]));
  if (d % 32 == 0) red[d / 32] = s;
  __syncthreads();
  s = 0.f;
#pragma unroll
  for (int w = 0; w < D / 32; ++w) s += red[w];

  // fold the active splits into (m, num, den), starting from the fresh
  // column
  float m = s, num = to_f32(static_cast<const T*>(a.v_new)[new_off]);
  float den = 1.f;
  const int n = (context(a, b) + a.chunk - 1) / a.chunk;
  const float* part =
      a.part + ((size_t)b * hq + j) * (size_t)a.splits * (D + 2);
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const float* p = part + (size_t)i * (D + 2);
    const float mi = p[D], li = p[D + 1], ai = p[d];
    const float mx = fmaxf(m, mi);
    const float c_old = exp2f(m - mx), c_new = exp2f(mi - mx);
    num = num * c_old + ai * c_new;
    den = den * c_old + li * c_new;
    m = mx;
  }
  store_val(static_cast<T*>(a.out) + ((size_t)b * hq + j) * D + d,
            num / den);
}

template <typename T, int D, int G>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = split_smem<T, D, G>(a.chunk, a.page_size);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_split_kernel<T, D, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 split_grid(a.n_kv_heads, a.batch, a.splits);
  paged_decode_split_kernel<T, D, G>
      <<<split_grid, kThreads, bytes, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 merge_grid(a.n_kv_heads * G, a.batch);
  paged_decode_merge_kernel<T, D, G><<<merge_grid, D, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_group(int group, const Args& a, cudaStream_t stream) {
  switch (group) {
    case 1: return launch<T, D, 1>(a, stream);
    case 2: return launch<T, D, 2>(a, stream);
    case 3: return launch<T, D, 3>(a, stream);
    case 4: return launch<T, D, 4>(a, stream);
    case 5: return launch<T, D, 5>(a, stream);
    case 6: return launch<T, D, 6>(a, stream);
    case 7: return launch<T, D, 7>(a, stream);
    case 8: return launch<T, D, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_dim(int head_dim, int group, const Args& a,
                   cudaStream_t stream) {
  if (head_dim == 64) return by_group<T, 64>(group, a, stream);
  if (head_dim == 128) return by_group<T, 128>(group, a, stream);
  return cudaErrorInvalidValue;
}

// ===========================================================================
// The window kernels
// ===========================================================================

struct WinArgs {
  const void* q;            // [B, W, Hq, D]
  const void* k_pages;      // [pages, P, Hkv, D], one layer
  const void* v_pages;
  const int* page_tables;   // [B, MP]
  const int* seq_lens;      // [B]
  const void* k_new;        // [B, W, Hkv, D]
  const void* v_new;
  float* part;              // bf16, splits > 1: [B, Hkv, W G, splits, D + 4]
  void* out;                // [B, W, Hq, D]
  int batch, window, n_q_heads, n_kv_heads, page_size, max_pages;
  int tiles, splits;        // bf16: key tiles a split walks, and splits
  float scale;              // log2(e) / sqrt(D)
};

__device__ __forceinline__ int win_context(const WinArgs& a, int b) {
  return max(0, min(a.seq_lens[b], a.max_pages * a.page_size));
}

// --- f32 route: CUDA-core FMA ---------------------------------------------

constexpr int kWinQ = 8;        // queries a block
constexpr int kWinRows = 32;    // context / fresh rows a tile
constexpr int kWinWarps = 4;    // 2 queries a warp
constexpr int kWinThreads = kWinWarps * 32;

// a ring stage: K then V, kWinRows rows each, rows padded by 16 bytes
template <int D>
__host__ __device__ constexpr int win_row() {
  return D + 4;
}

template <int D>
constexpr size_t win_smem() {
  return (size_t)kWinQ * D * 4 + 2 * 2 * (size_t)kWinRows * win_row<D>() * 4;
}

// issue the copies of tile `tile` (context tiles first, then fresh ones)
// into ring stage `stage`
template <int D>
__device__ __forceinline__ void win_load(const WinArgs& a, float* sK,
                                         float* sV, int b, int h, int tile,
                                         int ctx_tiles, int ctx,
                                         int fresh_rows) {
  constexpr int L = D / 4;
  constexpr int R = win_row<D>();
  const int tid = threadIdx.x;
  const size_t row = (size_t)a.n_kv_heads * D;
  const float* kp = static_cast<const float*>(a.k_pages);
  const float* vp = static_cast<const float*>(a.v_pages);
  const float* kn = static_cast<const float*>(a.k_new);
  const float* vn = static_cast<const float*>(a.v_new);
  for (int e = tid; e < kWinRows * L; e += kWinThreads) {
    const int r = e / L, c = e % L;
    const float* ksrc;
    const float* vsrc;
    int bytes = 16;
    if (tile < ctx_tiles) {
      const int p = tile * kWinRows + r;
      if (p < ctx) {
        const int page = a.page_tables[(size_t)b * a.max_pages +
                                       p / a.page_size];
        const size_t off =
            ((size_t)page * a.page_size + p % a.page_size) * row +
            (size_t)h * D + c * 4;
        ksrc = kp + off;
        vsrc = vp + off;
      } else {
        ksrc = kp;
        vsrc = vp;
        bytes = 0;
      }
    } else {
      const int f = (tile - ctx_tiles) * kWinRows + r;
      if (f < fresh_rows) {
        const size_t off = ((size_t)b * a.window + f) * row +
                           (size_t)h * D + c * 4;
        ksrc = kn + off;
        vsrc = vn + off;
      } else {
        ksrc = kn;
        vsrc = vn;
        bytes = 0;
      }
    }
    cp_async16(smem_u32(sK + r * R + c * 4), ksrc, bytes);
    cp_async16(smem_u32(sV + r * R + c * 4), vsrc, bytes);
  }
}

template <int D>
__global__ void __launch_bounds__(kWinThreads)
    paged_window_f32_kernel(const WinArgs a) {
  constexpr int R = win_row<D>();
  constexpr int NC = D / 32;     // P V columns a lane
  const int j = blockIdx.x, b = blockIdx.y;
  const int q0 = blockIdx.z * kWinQ;
  const int G = a.n_q_heads / a.n_kv_heads;
  const int h = j / G;
  const int W = a.window;
  const int ctx = win_context(a, b);
  const int ctx_tiles = (ctx + kWinRows - 1) / kWinRows;
  // fresh rows the block's last query sees
  const int fresh_rows = min(W, q0 + kWinQ);
  const int tiles = ctx_tiles + (fresh_rows + kWinRows - 1) / kWinRows;

  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // [kWinQ][D], pre-scaled
  float* ring = sQ + kWinQ * D;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  for (int e = tid; e < kWinQ * D; e += kWinThreads) {
    const int t = q0 + e / D;
    sQ[e] = t < W ? static_cast<const float*>(a.q)[
                        (((size_t)b * W + t) * a.n_q_heads + j) * D +
                        e % D] * a.scale
                  : 0.f;
  }
  win_load<D>(a, ring, ring + kWinRows * R, b, h, 0, ctx_tiles, ctx,
              fresh_rows);
  cp_async_commit();

  float m[2], l[2], acc[2][NC];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int tile = 0; tile < tiles; ++tile) {
    if (tile + 1 < tiles) {
      float* nxt = ring + (size_t)((tile + 1) % 2) * 2 * kWinRows * R;
      win_load<D>(a, nxt, nxt + kWinRows * R, b, h, tile + 1, ctx_tiles,
                  ctx, fresh_rows);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* sK = ring + (size_t)(tile % 2) * 2 * kWinRows * R;
    const float* sV = sK + kWinRows * R;
    const bool fresh = tile >= ctx_tiles;
    const int r0 = fresh ? (tile - ctx_tiles) * kWinRows : tile * kWinRows;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = warp * 2 + i;
      const int t = q0 + qi;
      if (t >= W) continue;
      // lane r scores row r of the tile
      float s = 0.f;
      const float* qrow = sQ + qi * D;
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        float kr[4];
        load16(sK + lane * R + c, kr);
#pragma unroll
        for (int v = 0; v < 4; ++v) s = fmaf(qrow[c + v], kr[v], s);
      }
      const int p_row = r0 + lane;
      const bool ok = fresh ? (p_row <= t && p_row < W) : p_row < ctx;
      s = ok ? s : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(s));
      if (m_new == -INFINITY) continue;   // nothing visible yet
      const float alpha = exp2f(m[i] - m_new);
      const float p = exp2f(s - m_new);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
#pragma unroll 8
      for (int r = 0; r < kWinRows; ++r) {
        const float pr = __shfl_sync(0xffffffffu, p, r);
        const float* vr = sV + r * R + lane * NC;
#pragma unroll
        for (int c = 0; c < NC; c += 2) {
          const float2 v = load2(vr + c);
          acc[i][c] = fmaf(pr, v.x, acc[i][c]);
          acc[i][c + 1] = fmaf(pr, v.y, acc[i][c + 1]);
        }
      }
    }
    __syncthreads();   // the stage is refilled by the next iteration
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + warp * 2 + i;
    if (t >= W) continue;
    float* o = static_cast<float*>(a.out) +
               (((size_t)b * W + t) * a.n_q_heads + j) * D + lane * NC;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[c] = acc[i][c] / l[i];
  }
}

template <int D>
cudaError_t launch_window_f32(const WinArgs& a, cudaStream_t stream) {
  const size_t bytes = win_smem<D>();
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_window_f32_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.n_q_heads, a.batch, (a.window + kWinQ - 1) / kWinQ);
  paged_window_f32_kernel<D><<<grid, kWinThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// --- bf16 route: tensor cores, mma.sync m16n8k16 ----------------------------
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), lane = 4 g + t:
//   A 16 x 16, row-major: reg 0 (row g, cols 2t, 2t+1), reg 1 (row g+8),
//     reg 2 (row g, cols 2t+8, 2t+9), reg 3 (row g+8, cols 2t+8, 2t+9);
//   B 16 x 8: reg 0 (rows 2t, 2t+1 of column g), reg 1 (rows 2t+8, 2t+9);
//   C 16 x 8, f32: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// Two accumulator tiles side by side (16 x 16) hold exactly the elements of
// one A fragment, so P goes from the scores to the PV product in registers.

constexpr int kTile = 64;                    // query rows, key rows a tile
constexpr int kMmaThreads = 128;             // 4 warps, 16 rows each
constexpr int kStages = 4;                   // the K/V ring
constexpr int kPad = 8;                      // bf16 row padding

// The key tiles split `split` walks for a row tile whose last query is
// t_max, in a slot with context ctx: context tiles [c0, c1), then fresh
// tiles [f0, f1). Both the split kernel (which exits on an empty walk) and
// the merge (which skips that split) take it from here.
struct Walk {
  int c0, c1, f0, f1;
  __device__ int count() const { return (c1 - c0) + (f1 - f0); }
};

__device__ __forceinline__ Walk win_walk(const WinArgs& a, int split,
                                         int ctx, int t_max) {
  const int ctx_tiles = (a.max_pages * a.page_size + kTile - 1) / kTile;
  const int all = ctx_tiles + (a.window + kTile - 1) / kTile;
  const int lo = split * a.tiles, hi = min(lo + a.tiles, all);
  Walk w;
  w.c0 = min(lo, ctx_tiles);
  w.c1 = max(w.c0, min(hi, (ctx + kTile - 1) / kTile));
  w.f0 = max(lo - ctx_tiles, 0);
  w.f1 = max(w.f0, min(hi - ctx_tiles, t_max / kTile + 1));
  return w;
}

// the last query of row tile rt among a slot's W G rows
__device__ __forceinline__ int win_t_max(const WinArgs& a, int rt) {
  const int G = a.n_q_heads / a.n_kv_heads;
  return (min((rt + 1) * kTile, a.window * G) - 1) / G;
}

// reductions over the 4 lanes (one quad) that hold one row of an mma
// accumulator
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A fragments of accumulator tiles c0 (columns 0-7) and c1 (8-15) as
// two bf16 parts: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void acc_to_a2(uint32_t hi[4], uint32_t lo[4],
                                          const float c0[4],
                                          const float c1[4]) {
  const float x[8] = {c0[0], c0[1], c0[2], c0[3],
                      c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(x[2 * i] - hf.x, x[2 * i + 1] - hf.y);
  }
}

// ldmatrix.x4 row addresses into a row-major [rows][LD] bf16 tile at shared
// address s: the A fragment of rows r0 + [0, 16) by columns c0 + [0, 16)
template <int LD>
__device__ __forceinline__ uint32_t a_frag_addr(uint32_t s, int r0, int c0,
                                                int lane) {
  return s + (uint32_t)((r0 + lane % 16) * LD + c0 + 8 * (lane / 16)) * 2;
}

// the B fragments of X^T, B[k][n] = X[n0 + n][k0 + k], for two 8-column
// blocks (regs 0-1: n in [0, 8), regs 2-3: n in [8, 16))
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

// the K/V ring; the query tile waits in the last stage's K slot, which the
// walk first fills after every warp has taken its Q fragments
template <int D>
constexpr size_t win_mma_smem() {
  return (size_t)(2 * kStages) * kTile * (D + kPad) * 2;
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    paged_window_mma_kernel(const WinArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + kPad;
  constexpr int NK = kTile / 8;  // accumulator tiles across a key tile
  constexpr int ND = D / 8;      // accumulator tiles across the head dim
  constexpr int CH = D / 8;      // 16-byte pieces a row
  constexpr uint32_t kTileBytes = kTile * LD * 2;
  const int rt = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / a.splits, split = blockIdx.z % a.splits;
  const int G = a.n_q_heads / a.n_kv_heads;
  const int W = a.window, rows = W * G, row0 = rt * kTile;
  const int ctx = win_context(a, b);
  const int t_max = win_t_max(a, rt);
  const Walk w = win_walk(a, split, ctx, t_max);
  const int count = w.count();
  if (count == 0) return;       // not counted: the merge skips it by the rule
  const int n_ctx = w.c1 - w.c0;

  extern __shared__ __align__(16) unsigned char smem_win[];
  const uint32_t sKV = smem_u32(smem_win);  // stage i: k at 2 i, v at 2 i + 1
  const uint32_t sQ = sKV + (kStages - 1) * 2 * kTileBytes;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = warp * 16;
  const size_t kv_row = (size_t)a.n_kv_heads * D;

  // the row tile's queries; rows past W G zero-filled
  const bf16* q = static_cast<const bf16*>(a.q);
#pragma unroll
  for (int i = 0; i < kTile * CH / kMmaThreads; ++i) {
    const int e = tid + i * kMmaThreads;
    const int r = e / CH, c = (e % CH) * 8;
    const int R = row0 + r;
    const bool real = R < rows;
    const int t = real ? R / G : 0, hq = h * G + (real ? R % G : 0);
    cp_async16(sQ + (uint32_t)(r * LD + c) * 2,
               q + (((size_t)b * W + t) * a.n_q_heads + hq) * D + c,
               real ? 16 : 0);
  }

  // walk tile j (context tiles first, then fresh ones) into ring stage st;
  // rows past the context or the window zero-filled, never read
  const bf16* kp = static_cast<const bf16*>(a.k_pages) + (size_t)h * D;
  const bf16* vp = static_cast<const bf16*>(a.v_pages) + (size_t)h * D;
  const bf16* kn = static_cast<const bf16*>(a.k_new) + (size_t)h * D;
  const bf16* vn = static_cast<const bf16*>(a.v_new) + (size_t)h * D;
  const int* table = a.page_tables + (size_t)b * a.max_pages;
  const int P = a.page_size;
  const int p_shift = (P & (P - 1)) == 0 ? __ffs(P) - 1 : -1;  // -1: divide
  auto copy_kv = [&](int j, int st) {
    const bool fresh = j >= n_ctx;
    const int base = (fresh ? w.f0 + j - n_ctx : w.c0 + j) * kTile;
    const uint32_t dk = sKV + st * 2 * kTileBytes, dv = dk + kTileBytes;
#pragma unroll
    for (int i = 0; i < kTile * CH / kMmaThreads; ++i) {
      const int e = tid + i * kMmaThreads;
      const int r = e / CH, c = (e % CH) * 8;
      const int p = base + r;
      const bf16* ks = kn;
      const bf16* vs = vn;
      int bytes = 0;
      if (!fresh && p < ctx) {
        const int pg = p_shift >= 0 ? p >> p_shift : p / P;
        const size_t off =
            ((size_t)table[pg] * P + (p - pg * P)) * kv_row + c;
        ks = kp + off;
        vs = vp + off;
        bytes = 16;
      } else if (fresh && p < W) {
        const size_t off = ((size_t)b * W + p) * kv_row + c;
        ks = kn + off;
        vs = vn + off;
        bytes = 16;
      }
      cp_async16(dk + (uint32_t)(r * LD + c) * 2, ks, bytes);
      cp_async16(dv + (uint32_t)(r * LD + c) * 2, vs, bytes);
    }
  };
  copy_kv(0, 0);
  cp_async_commit();              // the queries and tile 0
  // one commit group a tile, empty past the walk, so the waits count alike
  auto issue = [&](int j) {
    if (j < count) copy_kv(j, j % kStages);
    cp_async_commit();
  };
#pragma unroll
  for (int j = 1; j < kStages - 1; ++j) issue(j);

  cp_async_wait<kStages - 2>();
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)
    ldmatrix_x4(qf[kd], a_frag_addr<LD>(sQ, r0, kd * 16, lane));
  // the queries of this thread's rows r0 + g and r0 + g + 8 (rows past
  // W G are never stored; they take the last query's mask)
  int t_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    t_row[r] = min(row0 + r0 + g + 8 * r, rows - 1) / G;
  // the warp's first query; a warp with no real row computes nothing
  const int t_row_lo = min(row0 + r0, rows - 1) / G;
  const bool idle = row0 + r0 >= rows;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int j = 0; j < count; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    issue(j + kStages - 1);
    if (idle) continue;  // no real row: the warp only copies
    const bool fresh = j >= n_ctx;
    const int base = (fresh ? w.f0 + j - n_ctx : w.c0 + j) * kTile;
    const uint32_t sK = sKV + (j % kStages) * 2 * kTileBytes;
    const uint32_t sV = sK + kTileBytes;

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

    // context column p is visible below ctx; fresh column f to queries
    // t >= f. A tile every row of the warp sees whole needs no mask
    // (warp-uniform); the scale waits for the exponent (scale > 0, so the
    // max of the raw scores gives the max of the scaled ones).
    if (fresh ? base + kTile - 1 > t_row_lo : base + kTile > ctx) {
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = base + n * 8 + 2 * t4 + i % 2;
          if (fresh ? p > t_row[i / 2] : p >= ctx) s[n][i] = -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i / 2] = fmaxf(mx[i / 2], s[n][i]);
    float m_use[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]) * a.scale);
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
        // 0 where masked
        s[n][i] = exp2f(fmaf(s[n][i], a.scale, -m_use[i / 2]));
        rs[i / 2] += s[n][i];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] *= alpha[i / 2];

    // acc += P_hi V + P_lo V; V's B fragments by ldmatrix.x4.trans
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t ph[4], pl[4];
      acc_to_a2(ph, pl, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, b_frag_addr<LD>(sV, kk * 16, n * 8, lane));
        mma16816(acc[n], ph, vb);
        mma16816(acc[n + 1], ph, vb + 2);
        mma16816(acc[n], pl, vb);
        mma16816(acc[n + 1], pl, vb + 2);
      }
    }
  }
  cp_async_wait<0>();

  if (a.splits == 1) {
    // the whole walk: every real row saw its fresh row 0, so l >= 1
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int R = row0 + r0 + g + 8 * r;
      if (R >= rows) continue;  // an idle warp stores nothing
      const float inv = 1.f / l[r];
      bf16* o = static_cast<bf16*>(a.out) +
                (((size_t)b * W + R / G) * a.n_q_heads + h * G + R % G) * D +
                2 * t4;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<__nv_bfloat162*>(o + n * 8) =
            __floats2bfloat162_rn(acc[n][2 * r] * inv,
                                  acc[n][2 * r + 1] * inv);
    }
    return;
  }

  // the partial (acc, m, l) of each real row; a row that saw nothing in
  // this walk has m = -inf, l = 0, acc = 0
  constexpr int PS = D + 4;  // a partial's floats (16-byte rows)
  const size_t tile_rows = ((size_t)b * a.n_kv_heads + h) * rows;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int R = row0 + r0 + g + 8 * r;
    if (R >= rows) continue;
    float* o = a.part + ((tile_rows + R) * a.splits + split) * PS;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(o + n * 8 + 2 * t4) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    if (t4 == 0) *reinterpret_cast<float2*>(o + D) = make_float2(m[r], l[r]);
  }
}

// grid (ceil(W G / RB), Hkv, B), RB = 128 / (D / 4) rows a block: thread
// (row, c) folds the row's splits (those with a walk, by the rule the
// split kernel exits by; a row that saw nothing in a walk has m = -inf,
// l = 0, acc = 0) into one softmax and stores columns c..c+3 of acc / l in
// bf16. Two passes, the max and then the weighted sums, so that no load
// waits on an earlier split's arithmetic.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    paged_window_merge_kernel(const WinArgs a) {
  constexpr int PS = D + 4;
  constexpr int RB = kMmaThreads / (D / 4);
  const int G = a.n_q_heads / a.n_kv_heads;
  const int rows = a.window * G;
  const int R = blockIdx.x * RB + threadIdx.x / (D / 4);
  const int c = 4 * (threadIdx.x % (D / 4));
  const int h = blockIdx.y, b = blockIdx.z;
  if (R >= rows) return;
  const int ctx = win_context(a, b);
  const int t_max = win_t_max(a, R / kTile);
  const float* p =
      a.part + (((size_t)b * a.n_kv_heads + h) * rows + R) * a.splits * PS;
  float mx = -INFINITY;  // finite: the row saw its fresh row 0 somewhere
#pragma unroll 4
  for (int s = 0; s < a.splits; ++s)
    if (win_walk(a, s, ctx, t_max).count() > 0)
      mx = fmaxf(mx, p[s * PS + D]);
  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
  float den = 0.f;
#pragma unroll 4
  for (int s = 0; s < a.splits; ++s)
    if (win_walk(a, s, ctx, t_max).count() > 0) {
      const float2 ml = *reinterpret_cast<const float2*>(p + s * PS + D);
      const float4 v = *reinterpret_cast<const float4*>(p + s * PS + c);
      const float w = exp2f(ml.x - mx);  // 0 for a row that saw nothing
      num.x = fmaf(v.x, w, num.x);
      num.y = fmaf(v.y, w, num.y);
      num.z = fmaf(v.z, w, num.z);
      num.w = fmaf(v.w, w, num.w);
      den = fmaf(ml.y, w, den);
    }
  const float inv = 1.f / den;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.out) +
                     (((size_t)b * a.window + R / G) * a.n_q_heads + h * G +
                      R % G) * D + c;
  *reinterpret_cast<__nv_bfloat162*>(o) =
      __floats2bfloat162_rn(num.x * inv, num.y * inv);
  *reinterpret_cast<__nv_bfloat162*>(o + 2) =
      __floats2bfloat162_rn(num.z * inv, num.w * inv);
}

template <int D>
cudaError_t launch_window_mma(const WinArgs& a, cudaStream_t stream) {
  constexpr size_t bytes = win_mma_smem<D>();
  static_assert(bytes <= kMaxSmem, "the window ring must fit a block");
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_window_mma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const int rows = a.window * (a.n_q_heads / a.n_kv_heads);
  const dim3 grid((rows + kTile - 1) / kTile, a.n_kv_heads,
                  a.batch * a.splits);
  paged_window_mma_kernel<D><<<grid, kMmaThreads, bytes, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  constexpr int RB = kMmaThreads / (D / 4);
  const dim3 merge_grid((rows + RB - 1) / RB, a.n_kv_heads, a.batch);
  paged_window_merge_kernel<D><<<merge_grid, kMmaThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_window(int dtype, const WinArgs& a, cudaStream_t stream) {
  return dtype == 0 ? launch_window_f32<D>(a, stream)
                    : launch_window_mma<D>(a, stream);
}

// the checks and the launch behind both C entries
int window_entry(const void* q, const void* k_pages, const void* v_pages,
                 const void* page_tables, const void* seq_lens,
                 const void* k_new, const void* v_new, float* part,
                 void* out, int batch, int window, int n_q_heads,
                 int n_kv_heads, int head_dim, int page_size, int max_pages,
                 int tiles, int splits, int dtype, int device,
                 void* stream) {
  if (batch < 1 || window < 1 || n_kv_heads < 1 || n_q_heads < 1 ||
      n_q_heads % n_kv_heads != 0 || n_kv_heads > 65535 || page_size < 1 ||
      max_pages < 1 || (head_dim != 64 && head_dim != 128) ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const long long all =
      ((long long)max_pages * page_size + kTile - 1) / kTile +
      (window + kTile - 1) / kTile;
  if (dtype == 0) {
    // the f32 route takes the whole walk in one kernel
    if (splits != 1 || batch > 65535 || (window + kWinQ - 1) / kWinQ > 65535)
      return cudaErrorInvalidValue;
  } else if (tiles < 1 || splits < 1 || (long long)splits * tiles < all ||
             (long long)(splits - 1) * tiles >= all ||
             (long long)batch * splits > 65535 ||
             (splits > 1) != (part != nullptr)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  WinArgs a;
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.page_tables = static_cast<const int*>(page_tables);
  a.seq_lens = static_cast<const int*>(seq_lens);
  a.k_new = k_new;
  a.v_new = v_new;
  a.part = part;
  a.out = out;
  a.batch = batch;
  a.window = window;
  a.n_q_heads = n_q_heads;
  a.n_kv_heads = n_kv_heads;
  a.page_size = page_size;
  a.max_pages = max_pages;
  a.tiles = tiles;
  a.splits = splits;
  a.scale = kLog2e / sqrtf((float)head_dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch_window<64>(dtype, a, s);
  return launch_window<128>(dtype, a, s);
}

}  // namespace

// part: f32 scratch [B, Hq, splits, D + 2]; chunk: context positions a
// block of the split kernel covers (a multiple of page_size), splits:
// ceil(max_pages * page_size / chunk). dtype: 0 = float32, 1 = bfloat16.
// device: the CUDA device the tensors and the stream belong to (this
// library links its own static CUDA runtime, whose current device is not
// the caller's). Returns a cudaError_t (0 = both kernels launched).
extern "C" int dt_paged_decode(const void* q, const void* k_pages,
                               const void* v_pages, const void* page_tables,
                               const void* seq_lens, const void* k_new,
                               const void* v_new, void* part, void* out,
                               int batch, int n_q_heads, int n_kv_heads,
                               int head_dim, int page_size, int max_pages,
                               int chunk, int splits, int dtype, int device,
                               void* stream) {
  if (batch < 1 || batch > 65535 || n_kv_heads < 1 || page_size < 1 ||
      max_pages < 1 || n_q_heads % n_kv_heads != 0 || chunk < 1 ||
      chunk % page_size != 0 || splits < 1 || splits > 65535 ||
      (long long)splits * chunk < (long long)max_pages * page_size)
    return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  Args a;
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.page_tables = static_cast<const int*>(page_tables);
  a.seq_lens = static_cast<const int*>(seq_lens);
  a.k_new = k_new;
  a.v_new = v_new;
  a.part = static_cast<float*>(part);
  a.out = out;
  a.batch = batch;
  a.n_kv_heads = n_kv_heads;
  a.page_size = page_size;
  a.max_pages = max_pages;
  a.chunk = chunk;
  a.splits = splits;
  a.scale = kLog2e / sqrtf((float)head_dim);
  const int group = n_q_heads / n_kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_dim<float>(head_dim, group, a, s);
  if (dtype == 1) return by_dim<__nv_bfloat16>(head_dim, group, a, s);
  return cudaErrorInvalidValue;
}

// The window kernels: q, out [B, W, Hq, D]; k_new, v_new [B, W, Hkv, D];
// the pools, tables and seq_lens as dt_paged_decode's. dtype: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t (0 = launched).
// dt_paged_window walks every key tile in one kernel a (row tile, kv head,
// slot).
extern "C" int dt_paged_window(const void* q, const void* k_pages,
                               const void* v_pages, const void* page_tables,
                               const void* seq_lens, const void* k_new,
                               const void* v_new, void* out, int batch,
                               int window, int n_q_heads, int n_kv_heads,
                               int head_dim, int page_size, int max_pages,
                               int dtype, int device, void* stream) {
  const long long all =
      ((long long)max_pages * page_size + kTile - 1) / kTile +
      (window + kTile - 1) / kTile;
  return window_entry(q, k_pages, v_pages, page_tables, seq_lens, k_new,
                      v_new, nullptr, out, batch, window, n_q_heads,
                      n_kv_heads, head_dim, page_size, max_pages,
                      (int)all, 1, dtype, device, stream);
}

// dt_paged_window_split (bf16 only): the key tiles split across blocks,
// `tiles` a split, `splits` of them (ceil(all tiles / tiles)); part: f32
// scratch [B, Hkv, W * Hq / Hkv, splits, D + 4] that the call's merge
// kernel folds.
extern "C" int dt_paged_window_split(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_tables, const void* seq_lens, const void* k_new,
    const void* v_new, void* part, void* out, int batch, int window,
    int n_q_heads, int n_kv_heads, int head_dim, int page_size,
    int max_pages, int tiles, int splits, int device, void* stream) {
  if (splits < 2) return cudaErrorInvalidValue;
  return window_entry(q, k_pages, v_pages, page_tables, seq_lens, k_new,
                      v_new, static_cast<float*>(part), out, batch, window,
                      n_q_heads, n_kv_heads, head_dim, page_size, max_pages,
                      tiles, splits, 1, device, stream);
}
