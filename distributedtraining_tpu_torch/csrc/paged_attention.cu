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
