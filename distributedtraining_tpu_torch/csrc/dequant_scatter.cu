// Dequantize -> scatter-add of every indexed leaf of one packed wire-v2
// contribution into the averager's f32 accumulators, in place, in one pair
// of launches, for Hopper (sm_90a), behind a plain C interface that
// distributedtraining_tpu_torch/ops/dequant_scatter.py loads with ctypes.
//
// Replaces: distributedtraining_tpu/ops/dequant_scatter.py:_scatter_kernel
// (the Pallas TPU kernel that _build_call wraps in pl.pallas_call), which
// the JAX package runs once per indexed leaf.
//
// What it computes, for each leaf L of the contribution {idx, q, scale}
// folded with merge weight w (sw = w * scale, one f32 product taken by the
// caller):
//   for j in [0, k_L):  acc_L[idx[j]] = acc_L[idx[j]] + float(q[j]) * sw_L
// with q int8 or f32 (per leaf), every idx[j] in [0, n_L) (checked at
// admission; an index outside it is dropped here, never written), and
// duplicate indices summed in j order, exactly as the TPU kernel's serial
// loop sums them. val = float(q) * sw and acc + val are two rounded
// operations (__fmul_rn, __fadd_rn: no contraction into one FMA, which
// would differ from the serial loop in the last bit).
//
// Bound: bytes. Each entry reads idx (4 B) and q (1 B int8, 4 B f32) once
// and reads and writes one accumulator word (8 B): 13 B an int8 entry, one
// multiply and one add; a GPT-2-124M contribution (50 indexed leaves,
// 1,943,040 entries) is 25 MB, 7.5 us at 3.35 TB/s (H100 SXM data sheet).
// 4-byte updates at random positions move whole 32-byte sectors, so the
// accumulator traffic the memory system really carries is up to 8x the
// bound's 8 B an entry. At these sizes the device work is a few
// microseconds a leaf: what a call costs is set by the host's enqueue.
//
// Design: one call folds a whole contribution.
//  - The caller concatenates the leaves' idx (int32, each leaf at an entry
//    offset that is a multiple of 4) and q (bytes, each leaf at a 16-byte
//    aligned offset) into two device buffers, and passes one table: a Leaf
//    record per leaf (accumulator, n, offsets, k, sw, q type, the leaf's
//    first word in the bitmap, its collision flag, 0 in the copy) followed
//    by a Block record per block of the grid (leaf, first entry). Every
//    block owns kPerBlock consecutive entries of one leaf, 4 a thread, read
//    with one 16-byte idx load and one 4- or 16-byte q load. The table's
//    copy from pinned memory, enqueued here before the two launches, is the
//    only host->device traffic of a call; its zeroed flags replace a
//    memset.
//  - Blocks run in parallel and float atomics would add duplicates in an
//    order that changes from run to run. Honest encodings have unique
//    top-k indices, so a plain read-modify-write per entry is race-free; a
//    hostile one may repeat an index. So each call first detects
//    collisions in O(k):
//    1. dsc_mark: every entry sets bit idx[j] of its leaf's range of one
//       persistent bitmap with atomicOr (the leaves' ranges are disjoint
//       and word-aligned); a bit that was already set raises the leaf's
//       flag.
//    2. dsc_scatter: in a leaf without a collision, every entry does its
//       read-modify-write. In a leaf with one, the leaf's first block alone
//       takes the ordered path and the leaf's other blocks skip it: it
//       walks j in chunks of its threads; within a chunk the first thread
//       holding each index sums that index's values in chunk order onto
//       acc, and the chunks run one after the other, so every index's
//       additions happen in j order, bit-equal to the serial loop. Either
//       way every entry clears its bitmap bit again, so the bitmap is all
//       zero between calls and no pass ever touches all n words.
// A bit left set by a call that never finished only sends a later call
// down the ordered path, which is right for any input. The bitmap is
// scratch the wrapper owns (one per device); calls on one stream use it
// one after the other.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                       // entries a thread
constexpr int kPerBlock = kThreads * kVec;    // entries a block

// one leaf of the contribution (56 bytes; ops/dequant_scatter.py's LEAF)
struct Leaf {
  float* acc;       // f32 [n], updated in place
  int64_t n;
  int64_t e0;       // first entry in idx[], a multiple of 4
  int64_t qb;       // first byte in q[], a multiple of 16
  int64_t w0;       // first bitmap word of this leaf's n bits
  int32_t k;
  float sw;
  int32_t q_int8;   // 1: int8 q, 0: f32 q
  int32_t flag;     // 0 in the copy; dsc_mark sets it on a repeated index
};
static_assert(sizeof(Leaf) == 56, "Leaf layout");

// one block of the grid: entries [j0, j0 + kPerBlock) of leaf `leaf`
struct Block {
  int32_t leaf;
  int32_t j0;
};
static_assert(sizeof(Block) == 8, "Block layout");

__device__ __forceinline__ bool in_range(int32_t p, int64_t n) {
  return p >= 0 && p < n;
}

__device__ __forceinline__ float load_q(const uint8_t* q, const Leaf& L,
                                        int64_t j) {
  return L.q_int8
             ? static_cast<float>(reinterpret_cast<const int8_t*>(q + L.qb)[j])
             : reinterpret_cast<const float*>(q + L.qb)[j];
}

// entries j .. j + 3 of leaf L (j a multiple of 4, j < k): cnt of them lie
// below k; vector loads when all four do
__device__ __forceinline__ int load4(const Leaf& L, const int32_t* idx,
                                     const uint8_t* q, int j, int32_t p[4],
                                     float v[4], bool with_q) {
  const int cnt = L.k - j < kVec ? L.k - j : kVec;
  if (cnt == kVec) {
    const int4 pv = *reinterpret_cast<const int4*>(idx + L.e0 + j);
    p[0] = pv.x, p[1] = pv.y, p[2] = pv.z, p[3] = pv.w;
    if (with_q) {
      if (L.q_int8) {
        const char4 c = *reinterpret_cast<const char4*>(q + L.qb + j);
        v[0] = c.x, v[1] = c.y, v[2] = c.z, v[3] = c.w;
      } else {
        const float4 f = *reinterpret_cast<const float4*>(q + L.qb + 4 * j);
        v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
      }
    }
    return cnt;
  }
  for (int u = 0; u < cnt; ++u) {
    p[u] = idx[L.e0 + j + u];
    if (with_q) v[u] = load_q(q, L, j + u);
  }
  return cnt;
}

__global__ void __launch_bounds__(kThreads)
    dsc_mark(Leaf* __restrict__ leaves, const Block* __restrict__ blocks,
             const int32_t* __restrict__ idx,
             unsigned int* __restrict__ bitmap) {
  const Block b = blocks[blockIdx.x];
  const Leaf& L = leaves[b.leaf];
  const int j = b.j0 + kVec * threadIdx.x;
  if (j >= L.k) return;
  int32_t p[kVec];
  float unused[kVec];
  const int cnt = load4(L, idx, nullptr, j, p, unused, false);
  for (int u = 0; u < cnt; ++u) {
    if (!in_range(p[u], L.n)) continue;
    const uint32_t pu = static_cast<uint32_t>(p[u]);
    const unsigned int bit = 1u << (pu & 31u);
    const unsigned int old = atomicOr(&bitmap[L.w0 + (pu >> 5)], bit);
    if (old & bit) atomicExch(&leaves[b.leaf].flag, 1);
  }
}

// The ordered path over the whole of leaf L: one block, chunks of
// blockDim.x entries in j order.
__device__ void ordered_leaf(const Leaf& L, const int32_t* __restrict__ idx,
                             const uint8_t* __restrict__ q) {
  __shared__ int32_t s_idx[kThreads];
  __shared__ float s_val[kThreads];
  const int t = threadIdx.x;
  for (int64_t base = 0; base < L.k; base += blockDim.x) {
    const int cnt = static_cast<int>(
        L.k - base < blockDim.x ? L.k - base : blockDim.x);
    if (t < cnt) {
      s_idx[t] = idx[L.e0 + base + t];
      s_val[t] = __fmul_rn(load_q(q, L, base + t), L.sw);
    }
    __syncthreads();
    if (t < cnt && in_range(s_idx[t], L.n)) {
      const int32_t p = s_idx[t];
      bool first = true;
      for (int u = 0; u < t; ++u) {
        if (s_idx[u] == p) {
          first = false;
          break;
        }
      }
      if (first) {
        float a = L.acc[p];
        for (int u = t; u < cnt; ++u)
          if (s_idx[u] == p) a = __fadd_rn(a, s_val[u]);
        L.acc[p] = a;
      }
    }
    __syncthreads();   // this chunk's sums land before the next chunk reads
  }
}

__global__ void __launch_bounds__(kThreads)
    dsc_scatter(const Leaf* __restrict__ leaves,
                const Block* __restrict__ blocks,
                const int32_t* __restrict__ idx,
                const uint8_t* __restrict__ q,
                unsigned int* __restrict__ bitmap) {
  const Block b = blocks[blockIdx.x];
  const Leaf L = leaves[b.leaf];   // the flag as dsc_mark left it
  const int j = b.j0 + kVec * threadIdx.x;
  int32_t p[kVec];
  float v[kVec];
  const int cnt = j < L.k ? load4(L, idx, q, j, p, v, true) : 0;
  if (!L.flag) {
    for (int u = 0; u < cnt; ++u) {
      if (!in_range(p[u], L.n)) continue;
      L.acc[p[u]] = __fadd_rn(L.acc[p[u]], __fmul_rn(v[u], L.sw));
    }
  } else if (b.j0 == 0) {   // block-uniform: every thread of it goes here
    ordered_leaf(L, idx, q);
  }
  // every bit this call set goes back to 0 (the mark pass has finished:
  // the launches are ordered on the stream)
  for (int u = 0; u < cnt; ++u) {
    if (!in_range(p[u], L.n)) continue;
    const uint32_t pu = static_cast<uint32_t>(p[u]);
    atomicAnd(&bitmap[L.w0 + (pu >> 5)], ~(1u << (pu & 31u)));
  }
}

}  // namespace

// host_table: n_leaves Leaf records then n_blocks Block records (the flags
// zero) in pinned host memory, copied on the stream into table, device
// memory of the same size; idx: int32 entries, q: bytes, both as the
// records place them; bitmap: at least the words the records reach, all
// zero on entry and on return. Returns a cudaError_t (0 = enqueued).
extern "C" int dt_dequant_scatter(const void* host_table, void* table,
                                  int n_leaves, int n_blocks,
                                  const void* idx, const void* q,
                                  void* bitmap, int device, void* stream) {
  if (n_leaves < 1 || n_blocks < 1) return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = sizeof(Leaf) * n_leaves + sizeof(Block) * n_blocks;
  cudaError_t err = cudaMemcpyAsync(table, host_table, bytes,
                                    cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return err;
  Leaf* leaves = static_cast<Leaf*>(table);
  const Block* blocks = reinterpret_cast<const Block*>(leaves + n_leaves);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  unsigned int* bm = static_cast<unsigned int*>(bitmap);
  dsc_mark<<<n_blocks, kThreads, 0, s>>>(leaves, blocks, ix, bm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dsc_scatter<<<n_blocks, kThreads, 0, s>>>(
      leaves, blocks, ix, static_cast<const uint8_t*>(q), bm);
  return cudaGetLastError();
}
