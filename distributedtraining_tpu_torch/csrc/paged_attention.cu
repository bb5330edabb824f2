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
//   skipped, never multiplied by zero, so the contents of padded table
//   entries (trash page 0) cannot reach the output. Loads are in the pool
//   dtype (f32 or bf16); all arithmetic is f32.
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
// Design, simple and right first. One block per (kv head, slot), 8 warps.
// Warps take context positions round-robin, 4 consecutive positions at a
// time (their K/V rows are loaded before any is used, so each warp keeps
// 4 row loads in flight). Lanes split D (2 values a lane at D = 64, 4 at
// D = 128; one row of one head is one coalesced 128-512 byte load). Each
// warp keeps, for the G query rows of its group, an f32 online softmax in
// registers: running max m, normaliser l and the unnormalised
// accumulator; dot products reduce across lanes with shuffles. At the end
// the warps merge their (m, l, acc) through shared memory, warp 0 folds in
// the fresh column and writes acc / l in the output dtype. l >= 1 always:
// the largest score contributes exp(0).
//
// What the simple design leaves on the table: at GPT-2-124M serving
// shapes (B = 8 slots x Hkv = 12 heads) the grid is 96 blocks on 132 SMs,
// so a third of the card idles and each SM has one block's few row loads
// in flight — far fewer bytes in flight than the memory system needs to
// reach its rate. Splitting the context across blocks (split-K with a
// second merge pass), deeper pipelining with cp.async or TMA into shared
// memory, and wider loads are later work; PERF.md records the gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;   // warps per block
constexpr int kUnroll = 4;  // context positions a warp loads before use

// Load VPT consecutive values of one row as f32.
template <int VPT>
__device__ __forceinline__ void load_row(const float* p, float* o) {
  if constexpr (VPT == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x;
    o[1] = x.y;
  } else {
    static_assert(VPT == 4, "D must be 64 or 128");
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x;
    o[1] = x.y;
    o[2] = x.z;
    o[3] = x.w;
  }
}

template <int VPT>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* o) {
  if constexpr (VPT == 2) {
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = x.x;
    o[1] = x.y;
  } else {
    static_assert(VPT == 4, "D must be 64 or 128");
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 c =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    o[0] = a.x;
    o[1] = a.y;
    o[2] = c.x;
    o[3] = c.y;
  }
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

struct Args {
  const void* q;            // [B, Hq, D]
  const void* k_pages;      // [pages, P, Hkv, D], one layer
  const void* v_pages;
  const int* page_tables;   // [B, MP]
  const int* seq_lens;      // [B]
  const void* k_new;        // [B, Hkv, D]
  const void* v_new;
  void* out;                // [B, Hq, D]
  int batch, n_kv_heads, page_size, max_pages;
  float scale;
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_kernel(const Args a) {
  constexpr int VPT = D / 32;
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k_pages = static_cast<const T*>(a.k_pages);
  const T* __restrict__ v_pages = static_cast<const T*>(a.v_pages);
  const int h = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // slot
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d0 = lane * VPT;
  const int hq = a.n_kv_heads * G;

  float qr[G][VPT];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_row<VPT>(q + ((size_t)b * hq + (size_t)h * G + g) * D + d0, qr[g]);
#pragma unroll
    for (int i = 0; i < VPT; ++i) qr[g][i] *= a.scale;
  }
  float m[G], l[G], acc[G][VPT];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) acc[g][i] = 0.f;
  }

  const int ctx = max(0, min(a.seq_lens[b], a.max_pages * a.page_size));
  const int* table = a.page_tables + (size_t)b * a.max_pages;
  const size_t row_stride = (size_t)a.n_kv_heads * D;  // one pool row
  const size_t head_off = (size_t)h * D + d0;

  for (int t0 = warp * kUnroll; t0 < ctx; t0 += kWarps * kUnroll) {
    float kr[kUnroll][VPT], vr[kUnroll][VPT];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < ctx) {  // warp-uniform
        const int page = table[t / a.page_size];
        const size_t off =
            ((size_t)page * a.page_size + t % a.page_size) * row_stride +
            head_off;
        load_row<VPT>(k_pages + off, kr[u]);
        load_row<VPT>(v_pages + off, vr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < ctx) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < VPT; ++i) s += qr[g][i] * kr[u][i];
          s = warp_sum(s);
          const float m_new = fmaxf(m[g], s);
          const float alpha = expf(m[g] - m_new);  // 0 while m is -inf
          const float p = expf(s - m_new);
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int i = 0; i < VPT; ++i)
            acc[g][i] = acc[g][i] * alpha + p * vr[u][i];
          m[g] = m_new;
        }
      }
    }
  }

  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < VPT; ++i) sm_acc[warp][g][d0 + i] = acc[g][i];
  }
  __syncthreads();
  if (warp != 0) return;

  // fold the fresh column in last, merge the warps, normalise, store
  float kn[VPT], vn[VPT];
  const size_t new_off = ((size_t)b * a.n_kv_heads + h) * D + d0;
  load_row<VPT>(static_cast<const T*>(a.k_new) + new_off, kn);
  load_row<VPT>(static_cast<const T*>(a.v_new) + new_off, vn);
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) s += qr[g][i] * kn[i];
    s = warp_sum(s);
    float mx = s;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    const float pn = expf(s - mx);
    float tot = pn;
    float o[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) o[i] = pn * vn[i];
    for (int w = 0; w < kWarps; ++w) {
      const float lw = sm_l[w][g];
      if (lw > 0.f) {  // a warp that saw no position holds nothing
        const float c = expf(sm_m[w][g] - mx);
        tot += lw * c;
#pragma unroll
        for (int i = 0; i < VPT; ++i) o[i] += c * sm_acc[w][g][d0 + i];
      }
    }
    T* dst = out + ((size_t)b * hq + (size_t)h * G + g) * D + d0;
#pragma unroll
    for (int i = 0; i < VPT; ++i) store_val(dst + i, o[i] / tot);
  }
}

template <typename T, int D, int G>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.n_kv_heads, a.batch);
  paged_decode_kernel<T, D, G><<<grid, kWarps * 32, 0, stream>>>(a);
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

// dtype: 0 = float32, 1 = bfloat16. device: the CUDA device the tensors
// and the stream belong to (this library links its own static CUDA
// runtime, whose current device is not the caller's). Returns a
// cudaError_t (0 = launched).
extern "C" int dt_paged_decode(const void* q, const void* k_pages,
                               const void* v_pages, const void* page_tables,
                               const void* seq_lens, const void* k_new,
                               const void* v_new, void* out, int batch,
                               int n_q_heads, int n_kv_heads, int head_dim,
                               int page_size, int max_pages, int dtype,
                               int device, void* stream) {
  if (batch < 1 || n_kv_heads < 1 || page_size < 1 || max_pages < 1 ||
      n_q_heads % n_kv_heads != 0)
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
  a.out = out;
  a.batch = batch;
  a.n_kv_heads = n_kv_heads;
  a.page_size = page_size;
  a.max_pages = max_pages;
  a.scale = 1.0f / sqrtf((float)head_dim);
  const int group = n_q_heads / n_kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_dim<float>(head_dim, group, a, s);
  if (dtype == 1) return by_dim<__nv_bfloat16>(head_dim, group, a, s);
  return cudaErrorInvalidValue;
}
