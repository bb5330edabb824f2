// Fused linear cross-entropy for Hopper (sm_90a): the forward, dh and dW
// kernels, behind a plain C interface that
// distributedtraining_tpu_torch/ops/fused_ce.py loads with ctypes.
//
// Replaces the Pallas TPU kernels of the JAX package's ops/pallas_ce.py:
//   dt_ce_fwd  <- _fwd_call (:172, pallas_call :178) -> _fwd_kernel (:74)
//   dt_ce_dh   <- _bwd_calls (:196, pallas_call :201) -> _dh_kernel (:124)
//   dt_ce_dw   <- _bwd_calls (pallas_call :220) -> _dw_kernel (:143)
//
// What they compute, with z = h W^T (h [N, E], W [V, E], z never stored):
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
// dh and dW each recompute z and do one more product of the same size:
// 1.28 ms each. (H100 SXM data sheet.)
//
// Two routes, one per dtype:
//  - bf16, the training path: the tensor cores, mma.sync m16n8k16 (bf16 in,
//    f32 accumulation), 8 warps a block.
//  - f32: the CUDA cores, f32 FMA (no TF32), K-chunked through shared
//    memory, so the route agrees with the plain version to summation order.
//    Its forward has the decomposition of bf16 dh below (32 rows a block,
//    vocab tiles of 64).
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
//  - dh, bf16: rows of h and W sit in shared memory as bf16 over the whole
//    E (rows padded by 8 elements, so that fragment loads hit 32 banks), so
//    E <= 1024 (the wrapper refuses more); a warp computes a 16 x 16 tile
//    of z. A block owns 32 rows, one vocab split and a pass of E columns
//    (all of E = 768 in one pass), with its dh accumulator in registers
//    (96 floats a thread). It walks its vocab tiles of 64: z tile, dz
//    (rounded, to shared memory), dh += dz W. Recompute factor E / pass
//    (1 at E = 768). With one split the block rounds dh and writes it;
//    with more, partials per split are f32 and a reduce kernel sums the
//    splits in order and rounds once to h's dtype.
//  - dW, bf16: staged as dh; a block owns 32 vocab rows and a pass of E,
//    and walks all the tokens in tiles of 64: z tile, dz, dW += dz^T h. It
//    writes dW once.
// Every output element is written by one thread; no atomics, so results
// are deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kPad = 8;        // bf16 row padding (elements)
constexpr int kRows = 32;      // dh, f32 forward: tokens per block
constexpr int kVTile = 64;     // dh, f32 forward: vocab columns per step
constexpr int kWRows = 32;     // dW: vocab rows per block
constexpr int kTTile = 64;     // dW: tokens per step
constexpr int kLdDh = kVTile + kPad;   // dz tile row (dh)
constexpr int kLdDw = kWRows + kPad;   // dz tile row (dW)
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
  float* part;          // forward: [3][splits][N]; dh: [splits][N][E]
  float* loss;          // forward outputs [N]
  float* m_out;
  float* s_out;
  void* dh;             // [N, E], h's dtype
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

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment: rows r0 + [0, 16), columns c0 + [0, 16) of a row-major tile
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* s, int ld,
                                       int r0, int c0, int g, int t) {
  const bf16* p = s + (r0 + g) * ld + c0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// A fragment of X^T for a row-major tile X: A[m][k] = X[k0 + k][m0 + m]
__device__ __forceinline__ void frag_at(uint32_t a[4], const bf16* s, int ld,
                                        int m0, int k0, int g, int t) {
  const unsigned short* p =
      reinterpret_cast<const unsigned short*>(s) + (k0 + 2 * t) * ld + m0 + g;
  a[0] = p[0] | (uint32_t(p[ld]) << 16);
  a[1] = p[8] | (uint32_t(p[ld + 8]) << 16);
  a[2] = p[8 * ld] | (uint32_t(p[9 * ld]) << 16);
  a[3] = p[8 * ld + 8] | (uint32_t(p[9 * ld + 8]) << 16);
}

// B fragment of X^T for a row-major tile X: B[k][n] = X[n0 + n][k0 + k]
__device__ __forceinline__ void frag_bt(uint32_t b[2], const bf16* s, int ld,
                                        int n0, int k0, int g, int t) {
  const bf16* p = s + (n0 + g) * ld + k0 + 2 * t;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment of a row-major tile X itself: B[k][n] = X[k0 + k][n0 + n]
__device__ __forceinline__ void frag_b(uint32_t b[2], const bf16* s, int ld,
                                       int k0, int n0, int g, int t) {
  const unsigned short* p =
      reinterpret_cast<const unsigned short*>(s) + (k0 + 2 * t) * ld + n0 + g;
  b[0] = p[0] | (uint32_t(p[ld]) << 16);
  b[1] = p[8 * ld] | (uint32_t(p[9 * ld]) << 16);
}

// rows [row0, row0 + R) of a [n_rows, E] bf16 matrix into dst[R][E + kPad],
// 16 bytes a load; rows at or past n_rows read as 0
__device__ __forceinline__ void load_rows_bf16(bf16* dst, const void* src,
                                               int row0, int R, int n_rows,
                                               int E) {
  const bf16* base = static_cast<const bf16*>(src);
  const int chunks = E / 8, ld = E + kPad;
  for (int e = threadIdx.x; e < R * chunks; e += kThreads) {
    const int r = e / chunks, c = (e % chunks) * 8;
    const int row = row0 + r;
    const uint4 v =
        row < n_rows
            ? *reinterpret_cast<const uint4*>(base + (long long)row * E + c)
            : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

// c[n] (n = 0, 1) = rows ra + [0, 16) of sA times rows rb + 8 n + [0, 8) of
// sB, transposed: a 16 x 16 tile of z, summed over the whole E
__device__ __forceinline__ void z_tile(float c[2][4], const bf16* sA, int ra,
                                       const bf16* sB, int rb, int E, int g,
                                       int t) {
  const int ld = E + kPad;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[n][i] = 0.f;
  for (int k = 0; k < E; k += 16) {
    uint32_t a[4];
    frag_a(a, sA, ld, ra, k, g, t);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      uint32_t b[2];
      frag_bt(b, sB, ld, rb + 8 * n, k, g, t);
      mma16816(c[n], a, b);
    }
  }
}

// per-row values of rows [row0, row0 + R): m, s, g, y (0, 1, 0, -1 past N)
__device__ __forceinline__ void load_stats(float* sM, float* sS, float* sG,
                                           int* sY, const Args& a, int row0,
                                           int R) {
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const int n = row0 + r;
    const bool in = n < a.N;
    sM[r] = in ? a.m[n] : 0.f;
    sS[r] = in ? a.s[n] : 1.f;
    sG[r] = in ? a.g[n] : 0.f;
    sY[r] = in ? a.y[n] : -1;
  }
}

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a [rows][kFK] bf16 tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * (kFK * 2) + ((c ^ (r & 7)) << 4));
}

// 16 bytes global -> shared, zero-filled when src_bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

template <int NT>
__global__ void __launch_bounds__(kThreads) ce_dh_mma(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = a.E, ld = E + kPad;
  bf16* sH = reinterpret_cast<bf16*>(smem);
  bf16* sW = sH + kRows * ld;
  bf16* sDz = sW + kVTile * ld;
  float* sM = reinterpret_cast<float*>(sDz + kRows * kLdDh);
  float* sS = sM + kRows;
  float* sG = sS + kRows;
  int* sY = reinterpret_cast<int*>(sG + kRows);

  const int row0 = blockIdx.x * kRows, split = blockIdx.y;
  const int e0 = blockIdx.z * (64 * NT);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ra = (warp % 2) * 16, cb = (warp / 2) * 16;
  const int ew = e0 + warp * 8 * NT;  // this warp's columns of dh

  load_rows_bf16(sH, a.h, row0, kRows, a.N, E);
  load_stats(sM, sS, sG, sY, a, row0, kRows);

  float acc[2][NT][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[q][n][i] = 0.f;

  const int n_vt = (a.V + kVTile - 1) / kVTile;
  const int vt0 = split * a.tiles_per_split;
  const int vt1 = min(n_vt, vt0 + a.tiles_per_split);
  for (int vt = vt0; vt < vt1; ++vt) {
    const int v0 = vt * kVTile;
    __syncthreads();  // the previous tile's sW and sDz reads are done
    load_rows_bf16(sW, a.w, v0, kVTile, a.V, E);
    __syncthreads();
    float c[2][4];
    z_tile(c, sH, ra, sW, cb, E, g, t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ra + g + 8 * r;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = cb + 8 * n + 2 * t;
        const float d0 = dz_of(c[n][2 * r], v0 + col, a.V, sM[row], sS[row],
                               sG[row], sY[row]);
        const float d1 = dz_of(c[n][2 * r + 1], v0 + col + 1, a.V, sM[row],
                               sS[row], sG[row], sY[row]);
        *reinterpret_cast<__nv_bfloat162*>(sDz + row * kLdDh + col) =
            __floats2bfloat162_rn(d0, d1);
      }
    }
    __syncthreads();
    // dh[32 x pass] += dz[32 x 64] W[64 x pass]
#pragma unroll
    for (int kk = 0; kk < kVTile; kk += 16) {
      uint32_t af[2][4];
      frag_a(af[0], sDz, kLdDh, 0, kk, g, t);
      frag_a(af[1], sDz, kLdDh, 16, kk, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b[2];
        frag_b(b, sW, ld, kk, ew + 8 * n, g, t);
        mma16816(acc[0][n], af[0], b);
        mma16816(acc[1][n], af[1], b);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n_row = row0 + q * 16 + g + 8 * r;
      if (n_row >= a.N) continue;
      const long long off = (long long)n_row * E + ew + 2 * t;
      if (a.splits == 1) {  // dh itself, rounded once
        bf16* dst = static_cast<bf16*>(a.dh) + off;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
              __floats2bfloat162_rn(acc[q][n][2 * r], acc[q][n][2 * r + 1]);
        continue;
      }
      float* dst = a.part + (long long)split * a.N * E + off;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(acc[q][n][2 * r], acc[q][n][2 * r + 1]);
    }
}

template <int NT>
__global__ void __launch_bounds__(kThreads) ce_dw_mma(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = a.E, ld = E + kPad;
  bf16* sW = reinterpret_cast<bf16*>(smem);
  bf16* sH = sW + kWRows * ld;
  bf16* sDz = sH + kTTile * ld;
  float* sM = reinterpret_cast<float*>(sDz + kTTile * kLdDw);
  float* sS = sM + kTTile;
  float* sG = sS + kTTile;
  int* sY = reinterpret_cast<int*>(sG + kTTile);

  const int v0 = blockIdx.x * kWRows;
  const int e0 = blockIdx.y * (64 * NT);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ta = (warp % 4) * 16, vb = (warp / 4) * 16;
  const int ew = e0 + warp * 8 * NT;

  load_rows_bf16(sW, a.w, v0, kWRows, a.V, E);

  float acc[2][NT][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[q][n][i] = 0.f;

  for (int t0 = 0; t0 < a.N; t0 += kTTile) {
    __syncthreads();  // the previous tile's sH and sDz reads are done
    load_rows_bf16(sH, a.h, t0, kTTile, a.N, E);
    load_stats(sM, sS, sG, sY, a, t0, kTTile);
    __syncthreads();
    float c[2][4];  // z for tokens ta + [0, 16), vocab rows vb + [0, 16)
    z_tile(c, sH, ta, sW, vb, E, g, t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tok = ta + g + 8 * r;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = vb + 8 * n + 2 * t;
        const float d0 = dz_of(c[n][2 * r], v0 + col, a.V, sM[tok], sS[tok],
                               sG[tok], sY[tok]);
        const float d1 = dz_of(c[n][2 * r + 1], v0 + col + 1, a.V, sM[tok],
                               sS[tok], sG[tok], sY[tok]);
        *reinterpret_cast<__nv_bfloat162*>(sDz + tok * kLdDw + col) =
            __floats2bfloat162_rn(d0, d1);
      }
    }
    __syncthreads();
    // dW[32 x pass] += dz^T[32 x 64] h[64 x pass]
#pragma unroll
    for (int kk = 0; kk < kTTile; kk += 16) {
      uint32_t af[2][4];
      frag_at(af[0], sDz, kLdDw, 0, kk, g, t);
      frag_at(af[1], sDz, kLdDw, 16, kk, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b[2];
        frag_b(b, sH, ld, kk, ew + 8 * n, g, t);
        mma16816(acc[0][n], af[0], b);
        mma16816(acc[1][n], af[1], b);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int v = v0 + q * 16 + g + 8 * r;
      if (v >= a.V) continue;
      float* dst = a.dw + (long long)v * E + ew + 2 * t;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(acc[q][n][2 * r], acc[q][n][2 * r + 1]);
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
// split merges (both routes)
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

// dh = sum of the splits' f32 partials, in split order, rounded once
template <typename T>
__global__ void ce_dh_reduce(const Args a) {
  const long long total = (long long)a.N * a.E;
  T* dh = static_cast<T*>(a.dh);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int sp = 0; sp < a.splits; ++sp) acc += a.part[sp * total + i];
    dh[i] = from_f32<T>(acc);
  }
}

// ===========================================================================
// launch
// ===========================================================================

enum class Which { kFwd, kDh, kDw };

size_t smem_bytes(Which w, int E) {
  const size_t ld = E + kPad;
  if (w == Which::kFwd) return fwd_smem_bytes<kFwdNT>();
  if (w == Which::kDh)
    return (kRows + kVTile) * ld * 2 + kRows * kLdDh * 2 + 4 * kRows * 4;
  return (kWRows + kTTile) * ld * 2 + kTTile * kLdDw * 2 + 4 * kTTile * 4;
}

// widest pass (in 8-column tiles a warp) that divides E: all of E 768 or
// half of E 1024 (GPT-2-124M, -355M); 64 columns for any other E (the
// tiny and mini presets)
int pass_tiles(int E) {
  const int choices[3] = {12, 8, 1};
  for (int nt : choices)
    if (E % (64 * nt) == 0) return nt;
  return 0;
}

cudaError_t prepare(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int NT>
cudaError_t launch_bwd_mma(Which w, const Args& a, cudaStream_t st) {
  const size_t bytes = smem_bytes(w, a.E);
  const int passes = a.E / (64 * NT);
  if (w == Which::kDh) {
    cudaError_t err = prepare((const void*)ce_dh_mma<NT>, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.N + kRows - 1) / kRows, a.splits, passes);
    ce_dh_mma<NT><<<grid, kThreads, bytes, st>>>(a);
  } else {
    cudaError_t err = prepare((const void*)ce_dw_mma<NT>, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.V + kWRows - 1) / kWRows, passes);
    ce_dw_mma<NT><<<grid, kThreads, bytes, st>>>(a);
  }
  return cudaGetLastError();
}

cudaError_t launch_bwd_mma_any(Which w, const Args& a, cudaStream_t st) {
  switch (pass_tiles(a.E)) {
    case 12: return launch_bwd_mma<12>(w, a, st);
    case 8: return launch_bwd_mma<8>(w, a, st);
    case 1: return launch_bwd_mma<1>(w, a, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run(Which w, Args& a, int dtype, int device, void* stream) {
  if (a.N < 1 || a.V < 1 || a.E < 64 || a.E % 64 || a.splits < 1 ||
      a.splits > 65535 || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && smem_bytes(w, a.E) > 232448))
    return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  const int n_vt = (a.V + kVTile - 1) / kVTile;
  a.tiles_per_split = (n_vt + a.splits - 1) / a.splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_tiles = (a.N + kRows - 1) / kRows;
  const bool bf = dtype == 1;
  if (w == Which::kFwd) {
    if (bf) {
      // row tiles fastest: the blocks in flight walk one split's W tiles
      const dim3 grid((a.N + kFM - 1) / kFM, a.splits);
      const size_t bytes = smem_bytes(w, a.E);
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
  if (w == Which::kDh) {
    cudaError_t err;
    if (bf) {
      err = launch_bwd_mma_any(w, a, st);
    } else {
      const dim3 grid(row_tiles, a.splits, a.E / kFPass);
      if (a.E % kFPass) return cudaErrorInvalidValue;
      ce_dh_f32<<<grid, kThreads, 0, st>>>(a);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess || a.splits == 1) return err;
    const long long total = (long long)a.N * a.E;
    const int blocks = (int)((total + 1023) / 1024 < 4096 ? (total + 1023) / 1024
                                                          : 4096);
    if (bf)
      ce_dh_reduce<bf16><<<blocks, 256, 0, st>>>(a);
    else
      ce_dh_reduce<float><<<blocks, 256, 0, st>>>(a);
    return cudaGetLastError();
  }
  if (bf) return launch_bwd_mma_any(w, a, st);
  if (a.E % kFPass) return cudaErrorInvalidValue;
  const dim3 grid((a.V + kVTile - 1) / kVTile, a.E / kFPass);
  ce_dw_f32<<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (h and w share it). device: the CUDA
// device the tensors and the stream belong to (this library links its own
// static CUDA runtime, whose current device is not the caller's). All
// tensors are contiguous. Each returns a cudaError_t (0 = launched).

// part: f32 scratch [3][splits][N] (unused, may be null, with one split);
// loss, m, s: f32 [N]
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

// part: f32 scratch [splits][N][E] (unused, may be null, with one
// split); dh: [N, E] in h's dtype
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

// dw: f32 [V, E]
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
