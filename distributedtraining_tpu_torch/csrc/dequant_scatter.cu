// Dequantize -> scatter-add of one packed wire-v2 leaf into the averager's
// f32 accumulator, in place, for Hopper (sm_90a), behind a plain C
// interface that distributedtraining_tpu_torch/ops/dequant_scatter.py loads
// with ctypes.
//
// Replaces: distributedtraining_tpu/ops/dequant_scatter.py:_scatter_kernel
// (the Pallas TPU kernel that _build_call wraps in pl.pallas_call).
//
// What it computes, for one indexed-form entry {idx, q, scale} folded with
// merge weight w (sw = w * scale, one f32 product taken by the caller):
//   for j in [0, k):  acc[idx[j]] = acc[idx[j]] + float(q[j]) * sw
// with q int8 or f32, every idx[j] in [0, n) (checked at admission; an
// index outside it is dropped here, never written), and
// duplicate indices summed in j order, exactly as the TPU kernel's serial
// loop sums them. val = float(q) * sw and acc + val are two rounded
// operations (__fmul_rn, __fadd_rn: no contraction into one FMA, which
// would differ from the serial loop in the last bit).
//
// Bound: bytes. Each entry reads idx (4 B) and q (1 B int8, 4 B f32) once
// and reads and writes one accumulator word (8 B): 13 B an int8 entry, one
// multiply and one add. So the least time is the bytes over 3.35 TB/s
// (H100 SXM data sheet); 4-byte updates at random positions move whole
// 32-byte sectors, so the accumulator traffic the memory system really
// carries is up to 8x the bound's 8 B an entry.
//
// Design. The TPU kernel loops over j in order on one core. Here blocks run
// in parallel, and float atomics would add duplicates in an order that
// changes from run to run. Honest encodings have unique top-k indices, so
// a plain read-modify-write per j is race-free; a hostile one may repeat
// an index. So each call first detects collisions in O(k):
//   1. dsc_mark: every j sets bit idx[j] of a persistent n-bit bitmap with
//      atomicOr; a bit that was already set raises the collision flag.
//   2. dsc_scatter: without a collision, every j does its read-modify-write
//      (grid-stride, int64 offsets). With one, block 0 alone takes the
//      ordered path: it walks j in chunks of its threads; within a chunk
//      the first thread holding each index sums that index's values in
//      chunk order onto acc, and the chunks run one after the other, so
//      every index's additions happen in j order, bit-equal to the serial
//      loop. Either way every j clears its bitmap bit again, so the bitmap
//      is all zero between calls and no pass ever touches all n words.
// A bit left set by a call that never finished only sends a later call
// down the ordered path, which is right for any input. The bitmap and the
// flag are scratch the wrapper owns (one per device); calls on one stream
// use them one after the other.
//
// What the simple design leaves on the table: one call per leaf (50 for a
// GPT-2-124M contribution) is three launches each, which at these sizes
// costs more than the memory traffic; batching the leaves of a
// contribution into one launch and vectorising the idx/q loads are later
// work. PERF.md records the times.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_q(const void* q, int64_t j,
                                        int q_int8) {
  return q_int8 ? static_cast<float>(static_cast<const int8_t*>(q)[j])
                : static_cast<const float*>(q)[j];
}

__device__ __forceinline__ bool in_range(int32_t p, int64_t n) {
  return p >= 0 && p < n;
}

__global__ void dsc_mark(const int32_t* __restrict__ idx, int64_t k,
                         int64_t n, unsigned int* __restrict__ bitmap,
                         int* __restrict__ flag) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       j < k; j += stride) {
    if (!in_range(idx[j], n)) continue;
    const uint32_t p = static_cast<uint32_t>(idx[j]);
    const unsigned int bit = 1u << (p & 31u);
    const unsigned int old = atomicOr(&bitmap[p >> 5], bit);
    if (old & bit) atomicExch(flag, 1);
  }
}

// The ordered path: one block, chunks of blockDim.x entries in j order.
__device__ void ordered_block(float* __restrict__ acc,
                              const int32_t* __restrict__ idx, const void* q,
                              int q_int8, int64_t k, int64_t n, float sw) {
  __shared__ int32_t s_idx[kThreads];
  __shared__ float s_val[kThreads];
  const int t = threadIdx.x;
  for (int64_t base = 0; base < k; base += blockDim.x) {
    const int cnt = static_cast<int>(
        k - base < blockDim.x ? k - base : blockDim.x);
    if (t < cnt) {
      s_idx[t] = idx[base + t];
      s_val[t] = __fmul_rn(load_q(q, base + t, q_int8), sw);
    }
    __syncthreads();
    if (t < cnt && in_range(s_idx[t], n)) {
      const int32_t p = s_idx[t];
      bool first = true;
      for (int u = 0; u < t; ++u) {
        if (s_idx[u] == p) {
          first = false;
          break;
        }
      }
      if (first) {
        float a = acc[p];
        for (int u = t; u < cnt; ++u)
          if (s_idx[u] == p) a = __fadd_rn(a, s_val[u]);
        acc[p] = a;
      }
    }
    __syncthreads();   // this chunk's sums land before the next chunk reads
  }
}

__global__ void dsc_scatter(float* __restrict__ acc,
                            const int32_t* __restrict__ idx, const void* q,
                            int q_int8, int64_t k, int64_t n, float sw,
                            unsigned int* __restrict__ bitmap,
                            const int* __restrict__ flag) {
  const bool collided = *flag != 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (!collided) {
    for (int64_t j = first; j < k; j += stride) {
      const int32_t p = idx[j];
      if (!in_range(p, n)) continue;
      const float v = __fmul_rn(load_q(q, j, q_int8), sw);
      acc[p] = __fadd_rn(acc[p], v);
    }
  } else if (blockIdx.x == 0) {
    ordered_block(acc, idx, q, q_int8, k, n, sw);
  }
  // every bit this call set goes back to 0 (the mark pass has finished:
  // the launches are ordered on the stream)
  for (int64_t j = first; j < k; j += stride) {
    if (!in_range(idx[j], n)) continue;
    const uint32_t p = static_cast<uint32_t>(idx[j]);
    atomicAnd(&bitmap[p >> 5], ~(1u << (p & 31u)));
  }
}

}  // namespace

// acc f32 [n] (updated in place), idx int32 [k], q int8 or f32 [k]
// (q_int8 = 1 or 0), sw the folded f32 weight; scratch: one int flag
// (reset here) followed by ceil(n / 32) bitmap words, all zero on entry
// and on return. Returns a cudaError_t (0 = launched).
extern "C" int dt_dequant_scatter(void* acc, const void* idx, const void* q,
                                  int q_int8, int64_t k, int64_t n, float sw,
                                  void* scratch, int device, void* stream) {
  if (k < 1 || n < 1 || k > n) return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* flag = static_cast<int*>(scratch);
  unsigned int* bitmap = reinterpret_cast<unsigned int*>(flag + 1);
  cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  int64_t blocks = (k + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride beyond this
  const int32_t* ix = static_cast<const int32_t*>(idx);
  dsc_mark<<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
      ix, k, n, bitmap, flag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dsc_scatter<<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
      static_cast<float*>(acc), ix, q, q_int8, k, n, sw, bitmap, flag);
  return cudaGetLastError();
}
