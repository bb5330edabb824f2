// Fused linear cross-entropy for Hopper (sm_90a): the forward and the
// backward (dh and dW) kernels, behind a plain C interface that
// distributedtraining_tpu_torch/ops/fused_ce.py loads with ctypes.
//
// Replaces the Pallas TPU kernels of the JAX package's ops/pallas_ce.py:
//   dt_ce_fwd  <- _fwd_call (:172, pallas_call :178) -> _fwd_kernel (:74)
//   dt_ce_bwd  <- _bwd_calls (:196, pallas_call :201) -> _dh_kernel (:124)
//                 and (pallas_call :220) -> _dw_kernel (:143), bf16
//   dt_ce_dh, dt_ce_dw <- the same two, f32
//
// What they compute, with z = h W^T (h [N, E], W [V, E]):
//   forward: per row n the max m_n, the sum s_n = sum_v exp(z_nv - m_n) and
//            loss_n = m_n + log s_n - z_{n, y_n} (0 for the label logit of
//            a label outside [0, V));
//   dh:      dh = dz W,   dW = dz^T h   with
//   dz_nv = (exp(z_nv - m_n) / s_n - [v == y_n]) g_n rounded to h's dtype
//            (as _dz_tile rounds it), every product summed in f32; dh comes
//            back in h's dtype, dW in f32.
// Columns past V (the ragged last vocab tile) are loaded as 0 and masked;
// rows past N are loaded as 0 and never stored.
//
// Bound. At the GPT-2-124M training shape (N 8184, V 50304, E 768, bf16)
// the forward is 2 N V E = 0.63 TFLOP, 0.64 ms at 989 TFLOP/s, against
// 12.6 MB of h and 77 MB of W (27 us at 3.35 TB/s): operations bound it.
// The backward needs z once more and two products of the same size:
// 6 N V E, 1.92 ms. (H100 SXM data sheet.)
//
// Two routes, one per dtype:
//  - bf16, the training path: the tensor cores, mma.sync m16n8k16 (bf16 in,
//    f32 accumulation), 8 warps a block.
//  - f32: the CUDA cores, f32 FMA (no TF32), K-chunked through shared
//    memory, so the route agrees with the plain version to summation order.
//    Its forward and dh take 32 rows a block and vocab tiles of 64, dW 64
//    vocab rows a block and token tiles of 32.
// The kernels:
//  - forward, bf16 (ce_fwd_mma): a tiled GEMM mainloop with the online
//    softmax as its epilogue. What bounds it is the tensor cores; what held
//    a simple design far from that is feeding them: with 32 rows a block
//    every block streamed all of W (77 MB) from L2 or HBM, 256 times at
//    N 8184, in plain loads between two barriers (no overlap of loads and
//    mma), and 32-bit fragment loads made shared memory the pace. So a
//    block owns kFM = 128 rows and walks its split's vocab tiles of
//    32 kFwdNT columns (W now streams N / 128 times: 64 at N 8184); each
//    tile's z is summed over E in K chunks of 64 for h and W alike through
//    a ring of cp.async stages, so the next chunks load while the tensor
//    cores work on this one; fragments come from swizzled rows with
//    ldmatrix.x4, one shared load for two (A) or four (B) 32-bit registers;
//    each warp owns a 64 x 8 kFwdNT tile of z. The epilogue of each vocab
//    tile masks the columns at or past V, writes the label logit from the
//    one thread whose column holds it, and updates each thread's online
//    (max, sum) of its 8 rows; the quad and the 4 warps along the vocab
//    are merged through shared memory at the end. Any E that is a multiple
//    of 64 is taken. The vocab is split across blocks when the row tiles
//    alone leave SMs idle (ops/fused_ce.py _fwd_splits: N 8184 has 64 row
//    tiles, N 504 has 4); the grid runs row tiles fastest, so the blocks
//    in flight walk the same W tiles together and share them in L2. Each
//    block writes one partial (max, sum, label logit) per (split, row), and
//    ce_fwd_merge merges the splits into (loss, m, s); with one split the
//    block writes (loss, m, s) itself.
//  - backward, bf16 (dt_ce_bwd): three products of the same kind as the
//    forward's, each C = A B^T with A and B K-contiguous, each a 128 x 128
//    output tile a block on the forward's mainloop (tile_mma: the cp.async
//    ring, the swizzle, ldmatrix.x4), two blocks an SM. z is formed once:
//    the vocab is walked in chunks of Vc columns (Vc from the wrapper: the
//    dz scratch stays within 256 MiB), and per chunk
//      ce_dz_mma:   z = h W_c^T, epilogue dz = (exp(z - m) / s - onehot) g
//                   rounded to bf16, 0 at columns >= V, staged in shared
//                   memory and stored twice: dz [Np, Vc] and dz^T [Vc, Np];
//      ce_prod_mma: both products in one launch (their tiles one grid, so
//                   one tail a chunk):
//                   dh += dz_c (W^T)_c^T, K = the chunk's columns, added to
//                   an f32 accumulator in chunk order and rounded to bf16 by
//                   the last chunk;
//                   dW_c = dz_c^T (h^T)^T, K = N, written once in f32.
//    W^T [E, Vp] and h^T [E, Np] are formed once per backward by
//    ce_transpose (Np, Vp: N, V rounded up to 128, zeros in the padding),
//    so every operand is K-contiguous and every K extent a multiple of 64
//    that the zero padding ends (the ragged K tail costs no masking).
//    When the output tiles leave SMs idle (dh at N 504: 24 tiles over
//    K = V), K is split across blocks (z of the grid) into f32 partials
//    that ce_sum_splits adds in split order: dh keeps one accumulator a
//    split across the chunks and sums them once at the end, dW sums a
//    chunk's partials into its rows.
//    A call may ask for dh or dW alone: dz is then stored in the one layout
//    its product reads, and only that product's transpose is formed.
// Every output element is written by one thread; no atomics, so results
// are deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 32;      // f32 forward and dh: tokens per block
constexpr int kVTile = 64;     // f32: vocab columns per step (dW: per block)
constexpr int kFChunk = 32;    // f32: K chunk
constexpr int kFLd = kFChunk + 1;
constexpr int kFPass = 64;     // f32: E columns per pass
constexpr unsigned kFull = 0xffffffffu;


struct Args {
  const void* h;        // [N, E]
  const void* w;        // [V, E], h's dtype
  const int* y;         // [N]
  const float* m;       // [N] (backward)
  const float* s;       // [N] (backward)
  const float* g;       // [N] (backward)
  float* part;          // forward: [3][splits][N]; f32 dh: [splits][N][E]
  float* loss;          // forward outputs [N]
  float* m_out;
  float* s_out;
  void* dh;             // [N, E], f32 (the f32 route)
  float* dw;            // [V, E]
  int N, V, E, splits, tiles_per_split;
};

// (m, s) of one set of columns merged into (m, s) of another: the online
// softmax's merge, with empty sets (s == 0, m == -inf) kept exact
__device__ __forceinline__ void merge_ms(float& m, float& s, float mo,
                                         float so) {
  const float mn = fmaxf(m, mo);
  if (mn == -INFINITY) return;
  s = (s > 0.f ? s * expf(m - mn) : 0.f) + (so > 0.f ? so * expf(mo - mn) : 0.f);
  m = mn;
}

// one row's (max, sum, label logit) over this split's columns: the
// outputs themselves with one split, else the split's partial
__device__ __forceinline__ void store_fwd(const Args& a, int split, int n,
                                          float m, float s, float ll) {
  if (a.splits == 1) {
    a.loss[n] = m + logf(s) - ll;
    a.m_out[n] = m;
    a.s_out[n] = s;
    return;
  }
  const long long i = (long long)split * a.N + n;
  const long long plane = (long long)a.splits * a.N;
  a.part[i] = m;
  a.part[plane + i] = s;
  a.part[2 * plane + i] = ll;
}

// ===========================================================================
// bf16 route: tensor cores
// ===========================================================================
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), lane = 4 g + t:
//   A 16 x 16, row-major: reg 0 (row g, cols 2t, 2t+1), reg 1 (row g+8),
//     reg 2 (row g, cols 2t+8, 2t+9), reg 3 (row g+8, cols 2t+8, 2t+9);
//   B 16 x 8: reg 0 (rows 2t, 2t+1 of column g), reg 1 (rows 2t+8, 2t+9);
//   C 16 x 8, f32: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// (mma16816 in ptx.cuh computes c += a b on them.)

// dz of one element: (softmax - onehot) g, 0 past V
__device__ __forceinline__ float dz_of(float z, int col, int V, float m,
                                       float s, float g, int y) {
  const float p = col < V ? expf(z - m) / s : 0.f;
  return (p - (col == y ? 1.f : 0.f)) * g;
}

// ---------------------------------------------------------------------------
// The forward's tiled mainloop: a block owns kFM rows and walks its split's
// vocab tiles of 32 NT columns; each tile's z = h W^T is accumulated over E
// in K chunks of kFK through a ring of kStages<NT> cp.async stages (h and W
// chunks alike), read with ldmatrix.x4 from 128-byte rows swizzled in 16-byte
// units (chunk c of row r at c ^ (r & 7): the 8 rows of one ldmatrix phase
// hit 8 distinct bank groups).
// ---------------------------------------------------------------------------

constexpr int kFM = 128;       // forward: rows per block
constexpr int kFK = 64;        // forward: K chunk (128 bytes of bf16 a row)
constexpr int kFwdNT = 8;      // forward: 8-column n tiles a warp (BN 256)

template <int NT>
constexpr int kStages = NT == 4 ? 3 : 4;

template <int NT>
constexpr size_t fwd_smem_bytes() {
  return (size_t)kStages<NT> * (kFM + 32 * NT) * kFK * 2 + 2 * kFM * 4;
}

// byte offset of 16-byte chunk c of row r in a [rows][kFK] bf16 tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * (kFK * 2) + ((c ^ (r & 7)) << 4));
}

// rows [r0, r0 + R) of a [n_rows, E] bf16 matrix, K chunk kc, into a
// swizzled [R][kFK] tile; rows at or past n_rows are zero-filled
template <int R>
__device__ __forceinline__ void load_chunk(uint32_t dst, const bf16* src,
                                           int r0, int n_rows, int E,
                                           int kc) {
#pragma unroll
  for (int i = 0; i < R * 8 / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 3, ch = c & 7;
    const int row = r0 + r;
    const bf16* p =
        src + (long long)(row < n_rows ? row : n_rows - 1) * E + kc * kFK +
        ch * 8;
    cp_async16(dst + swz(r, ch), p, row < n_rows ? 16 : 0);
  }
}

// Warp w owns rows (w % 2) 64 + [0, 64) and columns (w / 2) 8 NT + [0, 8 NT)
// of each tile: 4 x NT mma tiles, acc[mt][nt] (C layout above). Its thread
// keeps the online (max, sum) of 8 rows (mt, half) over its columns; the
// label logit goes straight to shared memory from the one thread whose
// column holds it.
template <int NT>
__global__ void __launch_bounds__(kThreads, NT == 4 ? 2 : 1)
    ce_fwd_mma(const Args a) {
  constexpr int BN = 32 * NT, S = kStages<NT>;
  constexpr uint32_t A_BYTES = kFM * kFK * 2, STAGE = A_BYTES + BN * kFK * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  int* sY = reinterpret_cast<int*>(smem + S * STAGE);
  float* sLL = reinterpret_cast<float*>(sY + kFM);
  float* sRed = reinterpret_cast<float*>(smem);  // [2][4][kFM], after the loop
  const bf16* H = static_cast<const bf16*>(a.h);
  const bf16* W = static_cast<const bf16*>(a.w);
  const uint32_t base = smem_u32(smem);

  const int KC = a.E / kFK;
  const int row0 = blockIdx.x * kFM, split = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % 2, wn = warp / 2;
  const int n_vt = (a.V + BN - 1) / BN;
  const int tps = (n_vt + a.splits - 1) / a.splits;
  const int vt0 = split * tps, vt1 = min(n_vt, vt0 + tps);
  const int iters = max(0, vt1 - vt0) * KC;

  if (threadIdx.x < kFM) {
    const int n = row0 + threadIdx.x;
    sY[threadIdx.x] = n < a.N ? a.y[n] : -1;
    sLL[threadIdx.x] = 0.f;
  }

  // iteration it: vocab tile vt0 + it / KC, K chunk it % KC, ring slot it % S
  auto load = [&](int it) {
    const uint32_t st = base + (it % S) * STAGE;
    const int kc = it % KC;
    load_chunk<kFM>(st, H, row0, a.N, a.E, kc);
    load_chunk<BN>(st + A_BYTES, W, (vt0 + it / KC) * BN, a.V, a.E, kc);
  };
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < iters) load(i);
    cp_async_commit();
  }

  // this thread's ldmatrix rows: A row wm 64 + mt 16 + (lane & 15), B row
  // wn 8 NT + np 16 + (lane & 7) + 8 (lane >> 4); both have r & 7 == lane & 7
  const uint32_t a_off = (wm * 64 + (lane & 15)) * (kFK * 2);
  const uint32_t b_off =
      A_BYTES + (wn * 8 * NT + (lane & 7) + ((lane >> 4) << 3)) * (kFK * 2);
  const int a_ch = lane >> 4, b_ch = (lane >> 3) & 1, x = lane & 7;

  float acc[4][NT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  float m[8], s[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) m[r] = -INFINITY, s[r] = 0.f;

  for (int it = 0; it < iters; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();  // chunk it landed; slot (it - 1) % S is free again
    if (it + S - 1 < iters) load(it + S - 1);
    cp_async_commit();
    const uint32_t st = base + (it % S) * STAGE;
#pragma unroll
    for (int kk = 0; kk < kFK / 16; ++kk) {
      uint32_t af[4][4], bfr[NT][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], st + a_off + mt * 16 * (kFK * 2) +
                                (((2 * kk + a_ch) ^ x) << 4));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, st + b_off + np * 16 * (kFK * 2) +
                           (((2 * kk + b_ch) ^ x) << 4));
        bfr[2 * np][0] = r[0], bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2], bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma16816(acc[mt][nt], af[mt], bfr[nt]);
    }
    if (it % KC != KC - 1) continue;
    // epilogue of vocab tile vt: mask (the ragged last tile only), label
    // logit, online (max, sum) with the exponentials on the SFU (__expf)
    const int vt = vt0 + it / KC;
    const int c0 = vt * BN + wn * 8 * NT + 2 * t;
    const bool edge = (vt + 1) * BN > a.V;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = wm * 64 + mt * 16 + g + 8 * hf, slot = 2 * mt + hf;
        const int d = sY[r] - c0;   // the label column past this thread's c0
        float tmax = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& z = acc[mt][nt][2 * hf + j];
            if (edge && c0 + nt * 8 + j >= a.V) z = -INFINITY;
            else if (nt * 8 + j == d) sLL[r] = z;
            tmax = fmaxf(tmax, z);
          }
        if (tmax != -INFINITY) {
          const float mn = fmaxf(m[slot], tmax);
          float sum = s[slot] > 0.f ? s[slot] * __expf(m[slot] - mn) : 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              sum += __expf(acc[mt][nt][2 * hf + j] - mn);
          s[slot] = sum;
          m[slot] = mn;
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) acc[mt][nt][2 * hf + j] = 0.f;
      }
  }
  cp_async_wait<0>();
  // merge over the quad that shares a row, then over the 4 warps along N
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float mo = __shfl_xor_sync(kFull, m[r], o);
      const float so = __shfl_xor_sync(kFull, s[r], o);
      merge_ms(m[r], s[r], mo, so);
    }
  __syncthreads();  // every ring read is done: sRed may alias the ring
  if (t == 0)
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = wm * 64 + (r / 2) * 16 + g + 8 * (r % 2);
      sRed[wn * kFM + row] = m[r];
      sRed[(4 + wn) * kFM + row] = s[r];
    }
  __syncthreads();
  if (threadIdx.x < kFM && row0 + threadIdx.x < a.N) {
    const int row = threadIdx.x;
    float M = -INFINITY, Sm = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      merge_ms(M, Sm, sRed[q * kFM + row], sRed[(4 + q) * kFM + row]);
    store_fwd(a, split, row0 + row, M, Sm, sLL[row]);
  }
}

// ---------------------------------------------------------------------------
// The backward (bf16): the forward's mainloop for one output tile a block,
// with one epilogue for dz and one for the two products.
// ---------------------------------------------------------------------------

constexpr int kBwdNT = 4;          // 8-column n tiles a warp: 128 x 128 tiles
constexpr int kBN = 32 * kBwdNT;
constexpr size_t kBwdRing = (size_t)kStages<kBwdNT> * (kFM + kBN) * kFK * 2;
// the ring and the dz kernel's per-row m, 1/s, g, y: two blocks an SM
constexpr size_t kBwdSmem = kBwdRing + 4 * kFM * 4;

// acc = rows [a_r0, a_r0 + kFM) of A times rows [b_r0, b_r0 + 32 NT) of B,
// transposed, summed over the K chunks [kc0, kc0 + iters) of kFK: A and B
// are [rows][K] with row strides lda and ldb (multiples of 8 elements, so
// every 16-byte copy is aligned); rows at or past a_rows and b_rows read as
// 0. The warps and the accumulator's layout are ce_fwd_mma's. When it
// returns every copy has landed and every read of the ring is done, so the
// caller may reuse the shared memory.
template <int NT>
__device__ __forceinline__ void tile_mma(float acc[4][NT][4],
                                         unsigned char* smem, const bf16* A,
                                         int lda, int a_r0, int a_rows,
                                         const bf16* B, int ldb, int b_r0,
                                         int b_rows, int kc0, int iters) {
  constexpr int S = kStages<NT>;
  constexpr uint32_t A_BYTES = kFM * kFK * 2, STAGE = A_BYTES + 32 * NT * kFK * 2;
  const uint32_t base = smem_u32(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 2, wn = warp / 2;

  // iteration it: K chunk kc0 + it, ring slot it % S
  auto load = [&](int it) {
    const uint32_t st = base + (it % S) * STAGE;
    load_chunk<kFM>(st, A, a_r0, a_rows, lda, kc0 + it);
    load_chunk<32 * NT>(st + A_BYTES, B, b_r0, b_rows, ldb, kc0 + it);
  };
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < iters) load(i);
    cp_async_commit();
  }
  const uint32_t a_off = (wm * 64 + (lane & 15)) * (kFK * 2);
  const uint32_t b_off =
      A_BYTES + (wn * 8 * NT + (lane & 7) + ((lane >> 4) << 3)) * (kFK * 2);
  const int a_ch = lane >> 4, b_ch = (lane >> 3) & 1, x = lane & 7;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  for (int it = 0; it < iters; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();  // chunk it landed; slot (it - 1) % S is free again
    if (it + S - 1 < iters) load(it + S - 1);
    cp_async_commit();
    const uint32_t st = base + (it % S) * STAGE;
#pragma unroll
    for (int kk = 0; kk < kFK / 16; ++kk) {
      uint32_t af[4][4], bfr[NT][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], st + a_off + mt * 16 * (kFK * 2) +
                                (((2 * kk + a_ch) ^ x) << 4));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, st + b_off + np * 16 * (kFK * 2) +
                           (((2 * kk + b_ch) ^ x) << 4));
        bfr[2 * np][0] = r[0], bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2], bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma16816(acc[mt][nt], af[mt], bfr[nt]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

struct Bwd {
  const bf16* h;   // [N, E]
  const bf16* w;   // [V, E]
  const int* y;    // [N]
  const float* m;  // [N], from the forward
  const float* s;  // [N]
  const float* g;  // [N], the upstream gradient
  bf16* ht;        // [E, Np]: h^T, zeros past N (dW only)
  bf16* wt;        // [E, Vp]: W^T, zeros past V (dh only)
  bf16* dz;        // [Np, Vc]: this chunk's dz (dh only)
  bf16* dzt;       // [Vc, Np]: this chunk's dz^T (dW only)
  float* acc;      // [s_dh][N][E]: dh's f32 sums across chunks
  float* part;     // [s_dw][Vc][E]: a chunk's dW partials
  bf16* dh;        // [N, E], or null: no dh
  float* dw;       // [V, E], or null: no dW
  int N, V, E, Np, Vp, Vc, s_dh, s_dw;
};

// dz of the chunk's columns [v0 + 128 y, + 128) for rows [128 x, + 128):
// z = h W^T on the mainloop, then (exp(z - m) / s - onehot) g rounded to
// bf16, 0 at columns >= V (rows >= N come out 0: their g is 0). The tile is
// staged in shared memory in both layouts and stored with 16-byte writes.
__global__ void __launch_bounds__(kThreads, 2) ce_dz_mma(const Bwd a, int v0) {
  constexpr int LDZ = kBN + 8, LDT = kFM + 8;  // staged rows, 16-byte aligned
  extern __shared__ __align__(128) unsigned char smem[];
  float* sM = reinterpret_cast<float*>(smem + kBwdRing);
  float* sR = sM + kFM;  // 1 / s
  float* sG = sR + kFM;
  int* sY = reinterpret_cast<int*>(sG + kFM);
  const int row0 = blockIdx.x * kFM, col0 = blockIdx.y * kBN;
  const int vt = v0 + col0;  // the tile's first vocab column
  if (threadIdx.x < kFM) {
    const int n = row0 + threadIdx.x;
    const bool in = n < a.N;
    sM[threadIdx.x] = in ? a.m[n] : 0.f;
    sR[threadIdx.x] = in ? 1.f / a.s[n] : 1.f;
    sG[threadIdx.x] = in ? a.g[n] : 0.f;
    sY[threadIdx.x] = in ? a.y[n] : -1;
  }
  float acc[4][kBwdNT][4];
  tile_mma<kBwdNT>(acc, smem, a.h, a.E, row0, a.N, a.w, a.E, vt, a.V, 0,
                   a.E / kFK);

  bf16* sZ = reinterpret_cast<bf16*>(smem);  // [kFM][LDZ], over the ring
  bf16* sT = sZ + kFM * LDZ;                 // [kBN][LDT]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wm = warp % 2, wn = warp / 2;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wm * 64 + mt * 16 + g + 8 * hf;
      const float mr = sM[r], rs = sR[r], gr = sG[r];
      const int yc = sY[r] - vt;  // the label's column in this tile
#pragma unroll
      for (int nt = 0; nt < kBwdNT; ++nt) {
        const int cc = wn * 8 * kBwdNT + nt * 8 + 2 * t;
        float d[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = __expf(acc[mt][nt][2 * hf + j] - mr) * rs;
          d[j] = vt + cc + j < a.V ? (p - (cc + j == yc ? 1.f : 0.f)) * gr
                                   : 0.f;
        }
        const __nv_bfloat162 d2 = __floats2bfloat162_rn(d[0], d[1]);
        *reinterpret_cast<__nv_bfloat162*>(sZ + r * LDZ + cc) = d2;
        sT[cc * LDT + r] = d2.x;
        sT[(cc + 1) * LDT + r] = d2.y;
      }
    }
  __syncthreads();
  if (a.dz)
    for (int i = threadIdx.x; i < kFM * kBN / 8; i += kThreads) {
      const int r = i / (kBN / 8), q = i % (kBN / 8);
      *reinterpret_cast<uint4*>(a.dz + (long long)(row0 + r) * a.Vc + col0 +
                                q * 8) =
          *reinterpret_cast<const uint4*>(sZ + r * LDZ + q * 8);
    }
  if (a.dzt)
    for (int i = threadIdx.x; i < kBN * kFM / 8; i += kThreads) {
      const int c = i / (kFM / 8), q = i % (kFM / 8);
      *reinterpret_cast<uint4*>(a.dzt + (long long)(col0 + c) * a.Np + row0 +
                                q * 8) =
          *reinterpret_cast<const uint4*>(sT + c * LDT + q * 8);
    }
}

// One product C = A B^T of the backward (dh or dW), K split across blocks:
// block l of the product owns the 128 x 128 tile (l % m_tiles, l / m_tiles
// % n_tiles) of C and the K chunks [z kps, min(iters, (z + 1) kps)) of
// split z = l / (m_tiles n_tiles) (none: it stores zeros or adds them).
struct Prod {
  const bf16* a;    // [a_rows][K], row stride lda
  const bf16* b;    // [b_rows][K], row stride ldb
  int lda, ldb, a_rows, b_rows;
  int iters, kps;   // K chunks of kFK in all, and per split
  int M, ncol, ldo; // C rows and columns stored, the output's row stride
  float* out;       // f32 output, or the splits' planes of partials
  long long plane;  // elements from one split's plane to the next
  int add;          // add the f32 value already at out (an earlier chunk's)
  bf16* out_bf16;   // else null: round the sum and store it here instead
  int m_tiles, n_tiles, blocks;  // blocks = m_tiles n_tiles splits
};

__device__ __forceinline__ void prod_tile(const Prod& p, int l,
                                          unsigned char* smem) {
  const int m0 = (l % p.m_tiles) * kFM;
  const int n0 = (l / p.m_tiles % p.n_tiles) * kBN;
  const int sp = l / (p.m_tiles * p.n_tiles);
  const int k0 = sp * p.kps, k1 = min(p.iters, k0 + p.kps);
  float acc[4][kBwdNT][4];
  tile_mma<kBwdNT>(acc, smem, p.a, p.lda, m0, p.a_rows, p.b, p.ldb, n0,
                   p.b_rows, k0, max(0, k1 - k0));
  float* out = p.out ? p.out + sp * p.plane : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wm = warp % 2, wn = warp / 2;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = m0 + wm * 64 + mt * 16 + g + 8 * hf;
      if (r >= p.M) continue;
#pragma unroll
      for (int nt = 0; nt < kBwdNT; ++nt) {
        const int col = n0 + wn * 8 * kBwdNT + nt * 8 + 2 * t;
        if (col >= p.ncol) continue;  // ncol is even: col + 1 is in too
        float2 v = make_float2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
        const long long i = (long long)r * p.ldo + col;
        if (p.add) {
          const float2 o = *reinterpret_cast<const float2*>(out + i);
          v.x = o.x + v.x;
          v.y = o.y + v.y;
        }
        if (p.out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(p.out_bf16 + i) =
              __floats2bfloat162_rn(v.x, v.y);
        else
          *reinterpret_cast<float2*>(out + i) = v;
      }
    }
}

// A chunk's two products in one launch (they read dz in its two layouts
// and write apart): blocks [0, p0.blocks) take p0's tiles, the rest p1's,
// so the tail of one overlaps the other. p1.blocks is 0 for one product.
__global__ void __launch_bounds__(kThreads, 2) ce_prod_mma(const Prod p0,
                                                           const Prod p1) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int l = blockIdx.x;
  if (l < p0.blocks)
    prod_tile(p0, l, smem);
  else
    prod_tile(p1, l - p0.blocks, smem);
}

// dst[c][r] = src[r][c] for r < rows and 0 for r up to the grid's end (src
// [rows, cols], cols a multiple of 64; dst rows ld elements apart, ld a
// multiple of 8): 64 x 64 tiles through shared memory, 16 bytes a global
// read or write, 8 threads a 128-byte row segment.
__global__ void __launch_bounds__(kThreads) ce_transpose(const bf16* src,
                                                         int rows, int cols,
                                                         bf16* dst, int ld) {
  __shared__ uint32_t tile[64 * 33];  // 64 rows of 64 bf16, + 1 word a row
  const int r0 = blockIdx.x * 64, c0 = blockIdx.y * 64;
  for (int i = threadIdx.x; i < 64 * 8; i += kThreads) {
    const int r = i / 8, q = i % 8;
    const uint4 v = r0 + r < rows
                        ? *reinterpret_cast<const uint4*>(
                              src + (long long)(r0 + r) * cols + c0 + q * 8)
                        : make_uint4(0, 0, 0, 0);
    uint32_t* d = tile + r * 33 + q * 4;
    d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
  }
  __syncthreads();
  const unsigned short* e = reinterpret_cast<const unsigned short*>(tile);
  for (int i = threadIdx.x; i < 64 * 8; i += kThreads) {
    const int c = i / 8, q = i % 8;  // dst row c0 + c, columns r0 + 8 q + [0, 8)
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = q * 8 + 2 * k;
      w[k] = e[r * 66 + c] | (uint32_t(e[(r + 1) * 66 + c]) << 16);
    }
    *reinterpret_cast<uint4*>(dst + (long long)(c0 + c) * ld + r0 + q * 8) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}


// ===========================================================================
// f32 route: CUDA-core FMA
// ===========================================================================
// A block of 16 x 16 threads: thread (tr, tc) holds z for rows tr and
// tr + 16 of a 32-row tile and columns tc + 16 j (j < 4) of a 64-column
// tile; a row's 16 owners are one half-warp.

// z[r][j] = h[row0 + tr + 16 r] . W[v0 + tc + 16 j], summed over E in
// chunks staged through sA[32][kFLd] and sB[64][kFLd]
__device__ __forceinline__ void z_tile_f32(float z[2][4], const float* H,
                                           int row0, int N, const float* W,
                                           int v0, int V, int E, float* sA,
                                           float* sB) {
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) z[r][j] = 0.f;
  for (int k0 = 0; k0 < E; k0 += kFChunk) {
    __syncthreads();  // the previous chunk's reads are done
    for (int e = threadIdx.x; e < 32 * kFChunk; e += kThreads) {
      const int r = e / kFChunk, c = e % kFChunk;
      sA[r * kFLd + c] =
          row0 + r < N ? H[(long long)(row0 + r) * E + k0 + c] : 0.f;
    }
    for (int e = threadIdx.x; e < 64 * kFChunk; e += kThreads) {
      const int r = e / kFChunk, c = e % kFChunk;
      sB[r * kFLd + c] = v0 + r < V ? W[(long long)(v0 + r) * E + k0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kFChunk; ++k) {
      const float a0 = sA[tr * kFLd + k], a1 = sA[(tr + 16) * kFLd + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = sB[(tc + 16 * j) * kFLd + k];
        z[0][j] = fmaf(a0, b, z[0][j]);
        z[1][j] = fmaf(a1, b, z[1][j]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) ce_fwd_f32(const Args a) {
  __shared__ float sA[32 * kFLd], sB[64 * kFLd];
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int row0 = blockIdx.x * kRows, split = blockIdx.y;
  const float* H = static_cast<const float*>(a.h);
  const float* W = static_cast<const float*>(a.w);
  int y[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = row0 + tr + 16 * r;
    y[r] = n < a.N ? a.y[n] : -1;
  }
  float m[2] = {-INFINITY, -INFINITY}, s[2] = {0.f, 0.f}, ll[2] = {0.f, 0.f};
  const int n_vt = (a.V + kVTile - 1) / kVTile;
  const int vt0 = split * a.tiles_per_split;
  const int vt1 = min(n_vt, vt0 + a.tiles_per_split);
  for (int vt = vt0; vt < vt1; ++vt) {
    const int v0 = vt * kVTile;
    float z[2][4];
    z_tile_f32(z, H, row0, a.N, W, v0, a.V, a.E, sA, sB);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = v0 + tc + 16 * j;
        if (col >= a.V) z[r][j] = -INFINITY;
        else if (col == y[r]) ll[r] += z[r][j];
        tmax = fmaxf(tmax, z[r][j]);
      }
      if (tmax == -INFINITY) continue;
      const float mn = fmaxf(m[r], tmax);
      float acc = s[r] > 0.f ? s[r] * expf(m[r] - mn) : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc += expf(z[r][j] - mn);
      s[r] = acc;
      m[r] = mn;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float mo = __shfl_xor_sync(kFull, m[r], o);
      const float so = __shfl_xor_sync(kFull, s[r], o);
      ll[r] += __shfl_xor_sync(kFull, ll[r], o);
      merge_ms(m[r], s[r], mo, so);
    }
  if (tc == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = row0 + tr + 16 * r;
      if (n < a.N) store_fwd(a, split, n, m[r], s[r], ll[r]);
    }
}

__global__ void __launch_bounds__(kThreads) ce_dh_f32(const Args a) {
  __shared__ float sA[32 * kFLd], sB[64 * kFLd];
  __shared__ float sDz[32 * 65];
  __shared__ float sWe[64 * (kFPass + 1)];
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int row0 = blockIdx.x * kRows, split = blockIdx.y;
  const int e0 = blockIdx.z * kFPass;
  const float* H = static_cast<const float*>(a.h);
  const float* W = static_cast<const float*>(a.w);
  float rm[2], rs[2], rg[2];
  int ry[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = row0 + tr + 16 * r;
    const bool in = n < a.N;
    rm[r] = in ? a.m[n] : 0.f;
    rs[r] = in ? a.s[n] : 1.f;
    rg[r] = in ? a.g[n] : 0.f;
    ry[r] = in ? a.y[n] : -1;
  }
  float acc[2][kFPass / 16];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < kFPass / 16; ++j) acc[r][j] = 0.f;
  const int n_vt = (a.V + kVTile - 1) / kVTile;
  const int vt0 = split * a.tiles_per_split;
  const int vt1 = min(n_vt, vt0 + a.tiles_per_split);
  for (int vt = vt0; vt < vt1; ++vt) {
    const int v0 = vt * kVTile;
    float z[2][4];
    z_tile_f32(z, H, row0, a.N, W, v0, a.V, a.E, sA, sB);
    // the previous tile's sDz / sWe reads finished before z_tile_f32's
    // barriers
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sDz[(tr + 16 * r) * 65 + tc + 16 * j] = dz_of(
            z[r][j], v0 + tc + 16 * j, a.V, rm[r], rs[r], rg[r], ry[r]);
    for (int e = threadIdx.x; e < 64 * kFPass; e += kThreads) {
      const int r = e / kFPass, c = e % kFPass;
      sWe[r * (kFPass + 1) + c] =
          v0 + r < a.V ? W[(long long)(v0 + r) * a.E + e0 + c] : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < kVTile; ++k) {
      const float d0 = sDz[tr * 65 + k], d1 = sDz[(tr + 16) * 65 + k];
#pragma unroll
      for (int j = 0; j < kFPass / 16; ++j) {
        const float wv = sWe[k * (kFPass + 1) + tc + 16 * j];
        acc[0][j] = fmaf(d0, wv, acc[0][j]);
        acc[1][j] = fmaf(d1, wv, acc[1][j]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = row0 + tr + 16 * r;
    if (n >= a.N) continue;
    const long long off = (long long)n * a.E + e0 + tc;
    float* dst = a.splits == 1 ? static_cast<float*>(a.dh) + off
                               : a.part + (long long)split * a.N * a.E + off;
#pragma unroll
    for (int j = 0; j < kFPass / 16; ++j) dst[16 * j] = acc[r][j];
  }
}

__global__ void __launch_bounds__(kThreads) ce_dw_f32(const Args a) {
  __shared__ float sA[32 * kFLd], sB[64 * kFLd];
  __shared__ float sDz[32 * 65];
  __shared__ float sHe[32 * (kFPass + 1)];
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int v0 = blockIdx.x * kVTile;
  const int e0 = blockIdx.y * kFPass;
  const float* H = static_cast<const float*>(a.h);
  const float* W = static_cast<const float*>(a.w);
  float acc[4][kFPass / 16];  // vocab rows tr + 16 q, columns tc + 16 j
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < kFPass / 16; ++j) acc[q][j] = 0.f;
  for (int t0 = 0; t0 < a.N; t0 += 32) {
    float z[2][4];  // tokens t0 + tr + 16 r, vocab v0 + tc + 16 j
    z_tile_f32(z, H, t0, a.N, W, v0, a.V, a.E, sA, sB);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = t0 + tr + 16 * r;
      const bool in = n < a.N;
      const float m = in ? a.m[n] : 0.f, s = in ? a.s[n] : 1.f;
      const float g = in ? a.g[n] : 0.f;
      const int y = in ? a.y[n] : -1;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sDz[(tr + 16 * r) * 65 + tc + 16 * j] =
            dz_of(z[r][j], v0 + tc + 16 * j, a.V, m, s, g, y);
    }
    for (int e = threadIdx.x; e < 32 * kFPass; e += kThreads) {
      const int r = e / kFPass, c = e % kFPass;
      sHe[r * (kFPass + 1) + c] =
          t0 + r < a.N ? H[(long long)(t0 + r) * a.E + e0 + c] : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < 32; ++k) {
      float hv[kFPass / 16];
#pragma unroll
      for (int j = 0; j < kFPass / 16; ++j)
        hv[j] = sHe[k * (kFPass + 1) + tc + 16 * j];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float d = sDz[k * 65 + tr + 16 * q];
#pragma unroll
        for (int j = 0; j < kFPass / 16; ++j)
          acc[q][j] = fmaf(d, hv[j], acc[q][j]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int v = v0 + tr + 16 * q;
    if (v >= a.V) continue;
    float* dst = a.dw + (long long)v * a.E + e0 + tc;
#pragma unroll
    for (int j = 0; j < kFPass / 16; ++j) dst[16 * j] = acc[q][j];
  }
}


// ===========================================================================
// split merges
// ===========================================================================

__global__ void ce_fwd_merge(const Args a) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;
  const long long plane = (long long)a.splits * a.N;
  float M = -INFINITY, S = 0.f, L = 0.f;
  for (int sp = 0; sp < a.splits; ++sp) {
    const long long i = (long long)sp * a.N + n;
    merge_ms(M, S, a.part[i], a.part[plane + i]);
    L += a.part[2 * plane + i];
  }
  a.loss[n] = M + logf(S) - L;
  a.m_out[n] = M;
  a.s_out[n] = S;
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// out[i] = the splits' f32 partials part[sp plane + i], summed in split
// order and rounded once to T, for i < n
template <typename T>
__global__ void ce_sum_splits(const float* part, long long plane, int splits,
                              long long n, T* out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int sp = 0; sp < splits; ++sp) acc += part[sp * plane + i];
    out[i] = from_f32<T>(acc);
  }
}

template <typename T>
void sum_splits(const float* part, long long plane, int splits, long long n,
                T* out, cudaStream_t st) {
  const int blocks = (int)((n + 1023) / 1024 < 4096 ? (n + 1023) / 1024 : 4096);
  ce_sum_splits<T><<<blocks, 256, 0, st>>>(part, plane, splits, n, out);
}

// ===========================================================================
// launch
// ===========================================================================

enum class Which { kFwd, kDh, kDw };

cudaError_t prepare(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// the forward (both dtypes) and the f32 dh and dW; the bf16 backward is
// run_bwd
cudaError_t run(Which w, Args& a, int dtype, int device, void* stream) {
  if (a.N < 1 || a.V < 1 || a.E < 64 || a.E % 64 || a.splits < 1 ||
      a.splits > 65535 || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && w != Which::kFwd))
    return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  const int n_vt = (a.V + kVTile - 1) / kVTile;
  a.tiles_per_split = (n_vt + a.splits - 1) / a.splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_tiles = (a.N + kRows - 1) / kRows;
  if (w == Which::kFwd) {
    if (dtype == 1) {
      // row tiles fastest: the blocks in flight walk one split's W tiles
      const dim3 grid((a.N + kFM - 1) / kFM, a.splits);
      const size_t bytes = fwd_smem_bytes<kFwdNT>();
      cudaError_t err = prepare((const void*)ce_fwd_mma<kFwdNT>, bytes);
      if (err != cudaSuccess) return err;
      ce_fwd_mma<kFwdNT><<<grid, kThreads, bytes, st>>>(a);
    } else {
      ce_fwd_f32<<<dim3(row_tiles, a.splits), kThreads, 0, st>>>(a);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || a.splits == 1) return err;
    ce_fwd_merge<<<(a.N + 255) / 256, 256, 0, st>>>(a);
    return cudaGetLastError();
  }
  if (a.E % kFPass) return cudaErrorInvalidValue;
  if (w == Which::kDh) {
    ce_dh_f32<<<dim3(row_tiles, a.splits, a.E / kFPass), kThreads, 0, st>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || a.splits == 1) return err;
    const long long total = (long long)a.N * a.E;
    sum_splits(a.part, total, a.splits, total, static_cast<float*>(a.dh), st);
    return cudaGetLastError();
  }
  const dim3 grid((a.V + kVTile - 1) / kVTile, a.E / kFPass);
  ce_dw_f32<<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

// The bf16 backward, every launch on one stream: W^T (for dh) and h^T (for
// dW), then per vocab chunk the dz kernel, the dh and dW products in one
// launch (and the sum of dW's splits), then the sum of dh's splits.
cudaError_t run_bwd(const Bwd& a, int device, cudaStream_t st) {
  const bool want_dh = a.dh != nullptr, want_dw = a.dw != nullptr;
  const int chunks = a.Vc > 0 ? (a.Vp + a.Vc - 1) / a.Vc : 0;
  if (a.N < 1 || a.V < 1 || a.E < 64 || a.E % 64 || a.Vc < kBN || a.Vc % kBN ||
      a.s_dh < 1 || a.s_dh > 65535 || a.s_dw < 1 || a.s_dw > 65535 ||
      !(want_dh || want_dw) ||
      (want_dh && (!a.wt || !a.dz ||
                   (!a.acc && (chunks > 1 || a.s_dh > 1)))) ||
      (want_dw && (!a.ht || !a.dzt || (!a.part && a.s_dw > 1))))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = prepare((const void*)ce_dz_mma, kBwdSmem);
  if (err == cudaSuccess) err = prepare((const void*)ce_prod_mma, kBwdSmem);
  if (err != cudaSuccess) return err;
  const int E = a.E, e_tiles = (E + kBN - 1) / kBN;
  if (want_dh) {
    ce_transpose<<<dim3(a.Vp / 64, E / 64), kThreads, 0, st>>>(a.w, a.V, E,
                                                               a.wt, a.Vp);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (want_dw) {
    ce_transpose<<<dim3(a.Np / 64, E / 64), kThreads, 0, st>>>(a.h, a.N, E,
                                                               a.ht, a.Np);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  for (int c = 0; c < chunks; ++c) {
    const int v0 = c * a.Vc, wc = min(a.Vc, a.Vp - v0);
    ce_dz_mma<<<dim3(a.Np / kFM, wc / kBN), kThreads, kBwdSmem, st>>>(a, v0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    Prod pr[2] = {};
    int n = 0;
    if (want_dh) {
      // dh (+)= dz_c W_c: K = the chunk's columns; split z adds into its
      // own f32 plane, and with one split the last chunk rounds into dh
      Prod& p = pr[n++];
      p.a = a.dz, p.lda = a.Vc, p.a_rows = a.N;
      p.b = a.wt + v0, p.ldb = a.Vp, p.b_rows = E;
      p.iters = wc / kFK, p.kps = (p.iters + a.s_dh - 1) / a.s_dh;
      p.M = a.N, p.ncol = E, p.ldo = E;
      p.out = a.acc, p.plane = (long long)a.N * E, p.add = c > 0;
      if (a.s_dh == 1 && c == chunks - 1) p.out_bf16 = a.dh;
      p.m_tiles = (a.N + kFM - 1) / kFM, p.n_tiles = e_tiles;
      p.blocks = p.m_tiles * e_tiles * a.s_dh;
    }
    float* dw_rows = want_dw ? a.dw + (long long)v0 * E : nullptr;
    const int dw_m = min(wc, a.V - v0);
    if (want_dw) {
      // dW rows [v0, v0 + dw_m) = dz_c^T h: K = N (Np, zeros past N)
      Prod& p = pr[n++];
      p.a = a.dzt, p.lda = a.Np, p.a_rows = dw_m;
      p.b = a.ht, p.ldb = a.Np, p.b_rows = E;
      p.iters = a.Np / kFK, p.kps = (p.iters + a.s_dw - 1) / a.s_dw;
      p.M = dw_m, p.ncol = E, p.ldo = E;
      p.out = a.s_dw == 1 ? dw_rows : a.part;
      p.plane = (long long)a.Vc * E;
      p.m_tiles = (dw_m + kFM - 1) / kFM, p.n_tiles = e_tiles;
      p.blocks = p.m_tiles * e_tiles * a.s_dw;
    }
    ce_prod_mma<<<pr[0].blocks + pr[1].blocks, kThreads, kBwdSmem, st>>>(
        pr[0], pr[1]);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (want_dw && a.s_dw > 1) {
      sum_splits(a.part, (long long)a.Vc * E, a.s_dw, (long long)dw_m * E,
                 dw_rows, st);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  if (want_dh && a.s_dh > 1) {
    const long long total = (long long)a.N * E;
    sum_splits(a.acc, total, a.s_dh, total, a.dh, st);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// device: the CUDA device the tensors and the stream belong to (this
// library links its own static CUDA runtime, whose current device is not
// the caller's). All tensors are contiguous. Each returns a cudaError_t (0 =
// launched).

// dtype: 0 = float32, 1 = bfloat16 (h and w share it). part: f32 scratch
// [3][splits][N] (unused, may be null, with one split); loss, m, s: f32 [N]
extern "C" int dt_ce_fwd(const void* h, const void* w, const void* y,
                         void* part, void* loss, void* m, void* s, int N,
                         int V, int E, int splits, int dtype, int device,
                         void* stream) {
  Args a = {};
  a.h = h;
  a.w = w;
  a.y = static_cast<const int*>(y);
  a.part = static_cast<float*>(part);
  a.loss = static_cast<float*>(loss);
  a.m_out = static_cast<float*>(m);
  a.s_out = static_cast<float*>(s);
  a.N = N;
  a.V = V;
  a.E = E;
  a.splits = splits;
  return run(Which::kFwd, a, dtype, device, stream);
}

// f32 dh. part: f32 scratch [splits][N][E] (unused, may be null, with one
// split); dh: f32 [N, E]. dtype must be 0 (bf16 takes dt_ce_bwd).
extern "C" int dt_ce_dh(const void* h, const void* w, const void* y,
                        const void* m, const void* s, const void* g,
                        void* part, void* dh, int N, int V, int E, int splits,
                        int dtype, int device, void* stream) {
  Args a = {};
  a.h = h;
  a.w = w;
  a.y = static_cast<const int*>(y);
  a.m = static_cast<const float*>(m);
  a.s = static_cast<const float*>(s);
  a.g = static_cast<const float*>(g);
  a.part = static_cast<float*>(part);
  a.dh = dh;
  a.N = N;
  a.V = V;
  a.E = E;
  a.splits = splits;
  return run(Which::kDh, a, dtype, device, stream);
}

// f32 dW: f32 [V, E]. dtype must be 0.
extern "C" int dt_ce_dw(const void* h, const void* w, const void* y,
                        const void* m, const void* s, const void* g, void* dw,
                        int N, int V, int E, int dtype, int device,
                        void* stream) {
  Args a = {};
  a.h = h;
  a.w = w;
  a.y = static_cast<const int*>(y);
  a.m = static_cast<const float*>(m);
  a.s = static_cast<const float*>(s);
  a.g = static_cast<const float*>(g);
  a.dw = static_cast<float*>(dw);
  a.N = N;
  a.V = V;
  a.E = E;
  a.splits = 1;
  return run(Which::kDw, a, dtype, device, stream);
}

// The bf16 backward: dh (bf16 [N, E]) and/or dW (f32 [V, E]); a null dh or
// dw skips that product and the scratch only it needs. Np and Vp are N and
// V rounded up to 128, Vc the vocab chunk (a multiple of 128), s_dh and
// s_dw the K splits of the two products. Scratch, all from the caller: ht
// bf16 [E, Np], wt bf16 [E, Vp], dz bf16 [Np, Vc], dzt bf16 [Vc, Np], acc
// f32 [s_dh][N][E] (null when there is one chunk and one split), part f32
// [s_dw][Vc][E] (null with one split). Returns the first launch's error.
extern "C" int dt_ce_bwd(const void* h, const void* w, const void* y,
                         const void* m, const void* s, const void* g,
                         void* ht, void* wt, void* dz, void* dzt, void* acc,
                         void* part, void* dh, void* dw, int N, int V, int E,
                         int Vc, int s_dh, int s_dw, int device,
                         void* stream) {
  Bwd a = {};
  a.h = static_cast<const bf16*>(h);
  a.w = static_cast<const bf16*>(w);
  a.y = static_cast<const int*>(y);
  a.m = static_cast<const float*>(m);
  a.s = static_cast<const float*>(s);
  a.g = static_cast<const float*>(g);
  a.ht = static_cast<bf16*>(ht);
  a.wt = static_cast<bf16*>(wt);
  a.dz = static_cast<bf16*>(dz);
  a.dzt = static_cast<bf16*>(dzt);
  a.acc = static_cast<float*>(acc);
  a.part = static_cast<float*>(part);
  a.dh = static_cast<bf16*>(dh);
  a.dw = static_cast<float*>(dw);
  a.N = N;
  a.V = V;
  a.E = E;
  a.Np = (N + kFM - 1) / kFM * kFM;
  a.Vp = (V + kBN - 1) / kBN * kBN;
  a.Vc = Vc;
  a.s_dh = s_dh;
  a.s_dw = s_dw;
  return run_bwd(a, device, static_cast<cudaStream_t>(stream));
}
