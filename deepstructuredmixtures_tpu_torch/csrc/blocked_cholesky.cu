// In-place batched lower Cholesky of SPD matrices: two-level blocking, a
// short serial chain, and a lookahead that hides the chain behind the big
// update.
//
// Replaces the Pallas TPU kernel `hbm_blocked_cholesky` of
// deepstructuredmixtures_tpu/ops/pallas_potrf.py (kernel body
// `_potrf_kernel`; helpers `_sweep`, `_trinv`, `_chol_trinv`) and computes
// the same thing: for each of G matrices a[g] (n x n, row-major float32,
// only the lower triangle read), the lower factor L with L L^T = a[g],
// written over a[g]. The contract is stricter than the TPU kernel's:
//   * the strict upper triangle comes back exactly 0 (the TPU kernel's
//     `tril=True`);
//   * identity-padded rows and columns (row i of the identity for
//     i >= the valid size) stay exactly the identity: every update they
//     take is a product with exact zeros, the inverse of an identity block
//     is the identity exactly, and the diagonal is the exact square root;
//   * a matrix that is not positive definite takes the square root of a
//     negative pivot, and the NaN spreads through the rest of that matrix
//     (through the inverse of its diagonal block too) and through no other
//     matrix: the result is non-finite, nothing raises;
//   * any n >= 1 and any 1 <= G <= 65535; ragged edges are masked.
//
// What bounds it on an H100. A matrix of n rows needs n^3/3 floating-point
// operations on 2 n^2 * 4 bytes. At 67 TFLOP/s (float32 FMA outside the
// tensor cores) against 3.35 TB/s the factorization is operation-bound at
// every bucket size, but only if the trailing update is: with a rank-k
// update every trailing element is read and written once per k columns,
// (n^3/3) * 4 / k bytes in all. At k = 64 that traffic took longer than
// the operations; at k = 256 it is a quarter of it (6.6 ms of 21 ms at
// n = 16232). Beside that stands the serial chain: the diagonal block of a
// step can only be factored after the step before it, and it costs
// microseconds whatever n is. Below n of about 5000 the chain, not the
// update, is what the call takes.
//
// The design.
//   * Outer panels of NBO = 256 columns, inner steps of NB = 64 columns.
//     An inner step touches only its own 64 columns (left-looking inside
//     the outer panel), so between two rank-256 updates only an n x 256
//     slab moves, and it stays in L2.
//   * The diagonal block (`diag_factor_inv`, 256 threads): 64 x 64 in
//     shared memory, factored by a 2 x 2 split into 32-wide sub-blocks
//     (one warp, one row per lane, the pivot by rsqrt, the diagonal itself
//     the exact sqrt). It also returns inv(L11), as the TPU kernel's
//     `_chol_trinv` does: the two 32-wide inverses by substitution (one
//     column per lane) on warps that run beside the factoring warp, the
//     off-diagonal block of the inverse as one more substitution. inv(L11)
//     goes to a scratch of 2 x 64 x 64 floats per matrix that the wrapper
//     allocates. `diag_inv_kernel` runs it for the first block of an outer
//     panel; the later blocks are factored inside the panel kernel.
//   * `panel_kernel`, one block per (matrix, 64 rows below the diagonal
//     block): T = A21 - L[rows, S:s] L[cols, S:s]^T (the left-looking
//     update from the earlier inner steps of this outer panel, its operand
//     blocks prefetched through registers), then L21 = T inv(L11)^T, a
//     product and no substitution; the block zeroes the mirror image of
//     its rows in the strict upper triangle, and if its rows hold a later
//     diagonal block of the same outer panel it brings that block up to
//     date (A[r, r] -= L21 L21^T). Block 0 holds the next step's diagonal
//     block, final by then: it factors and inverts it on the spot, so an
//     inner step is one launch.
//   * The rank-256 update A22 -= L21 L21^T, one block per 128 x 128 tile
//     on or below the diagonal: the tile's 8 x 8 outputs per thread stay
//     in registers over the whole k = 256 while the two panel slices
//     stream through a ring of three shared-memory stages filled by
//     cp.async (32 columns per stage, row stride 36 floats so that the
//     float4 reads along k fall on distinct banks); the C tile is fetched
//     by cp.async into shared memory behind the first stages, so the
//     epilogue waits for no load from device memory; float32 FMA.
//   * Lookahead on a second stream. The update of outer step K is split:
//     `lookahead_update_kernel` updates the 256 columns of panel K+1 (in
//     64-row tiles when 128-row ones would not fill the card) and runs
//     with the factorization of panel K+1 on a high-priority side stream,
//     while `trailing_update_kernel` updates the rest on the caller's
//     stream. Events order them (the rest waits for its panel, the next
//     lookahead waits for the rest before it), the side stream starts
//     after the caller's stream and the caller's stream waits for it at
//     the end, so the call as a whole is one unit of work on the caller's
//     stream. The chain is hidden as long as the rest of an update takes
//     longer than the next panel.
//
// What was tried on an H100 (700 W) and what it gave is in PERF.md. In
// short: 256-wide outer panels, the inverse in place of the substitution
// and the lookahead took (1, 16232) from 86.7 to 65 ms; one block per SM
// with 254 registers instead of two with spills, to 53; the C tile staged
// by cp.async, to 45. The diagonal block went from 31 to 14 microseconds
// (float4 loads, no predicates, the column broadcast through shared
// memory instead of shuffles, the square root off the chain); factoring
// it inside the panel kernel and 64-row lookahead tiles took (1, 4576)
// from 3.3 to 2.9 ms. Wider update tiles (8 x 16 outputs per thread), a
// two-stage 64-column ring, software-pipelined fragment loads and loops
// in place of unrolled code were each slower or no faster.
//
// Tensor cores: see the note above `update_tile`.
//
// Plain C interface for ctypes (built with nvcc -shared, no PyTorch
// headers): dsm_blocked_cholesky launches on the given stream (and on its
// own side stream, joined before it returns to the caller's stream),
// checks cudaGetLastError() after every launch and returns the first error
// (0 on success). It allocates no device memory: `work` is G * 2 * 64 * 64
// floats from the caller.

#include <cuda_runtime.h>

#include <initializer_list>
#include <mutex>

// NB, SUB, LDD, LDP, the diagonal block (`diag_factor_inv`) and `mma64`
#include "chol_common.cuh"

namespace {

// NB (64) is the inner step, the width of a diagonal block
constexpr int NBO = 256;             // outer panel: rank of the big update
constexpr int PANEL_THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int TILE = 128;            // update output tile edge
constexpr int KC = 32;               // columns of the panel per ring stage
constexpr int LDK = KC + 4;          // shared row stride of a stage
constexpr int STAGES = 3;
constexpr int UPDATE_THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int STAGE_FLOATS = 2 * TILE * LDK;
constexpr int LDC = TILE + 4;         // shared row stride of the staged C tile
constexpr size_t UPDATE_SMEM =
    (size_t)(STAGES * STAGE_FLOATS + TILE * LDC) * sizeof(float);
static_assert(NBO % NB == 0 && NBO % KC == 0 && NBO == 2 * TILE,
              "the lookahead is two tile columns");
static_assert(LDK % 32 == 4, "float4 reads along k: 8 rows, 32 banks");
static_assert(PANEL_THREADS == DIAG_THREADS, "block 0 of the panel kernel factors");

// The factor of the w x w diagonal block at (s, s) from sm.D to the
// matrix, and its inverse from sm.Inv to `work` (64 x 64 floats)
__device__ __forceinline__ void diag_store(const DiagSmem& sm, float* A, float* work, int n,
                                           int s, int w, int tid) {
  if ((n % 4) == 0 && w == NB) {
    for (int e = tid; e < NB * NB / 4; e += DIAG_THREADS) {
      const int r = e / (NB / 4), c = 4 * (e % (NB / 4));
      const float* d = sm.D + r * LDD + c;
      *reinterpret_cast<float4*>(A + (size_t)(s + r) * n + s + c) =
          make_float4(d[0], d[1], d[2], d[3]);
    }
  } else {
    for (int e = tid; e < w * w; e += DIAG_THREADS) {
      const int r = e / w, c = e % w;
      A[(size_t)(s + r) * n + s + c] = sm.D[r * LDD + c];
    }
  }
  float4* W = reinterpret_cast<float4*>(work);
  for (int e = tid; e < NB * NB / 4; e += DIAG_THREADS) {
    const float* d = sm.Inv + (e / (NB / 4)) * LDD + 4 * (e % (NB / 4));
    W[e] = make_float4(d[0], d[1], d[2], d[3]);
  }
}

// The first diagonal block of an outer panel (the later ones are factored
// by the panel kernel)
__global__ void __launch_bounds__(DIAG_THREADS)
diag_inv_kernel(float* __restrict__ a, float* __restrict__ work, int n, int s, int w) {
  __shared__ DiagSmem sm;
  float* A = a + (size_t)blockIdx.x * n * n;
  const int tid = threadIdx.x;

  // the w x w diagonal block (lower triangle), identity beyond w
  if ((n % 4) == 0 && w == NB) {
    for (int e = tid; e < NB * NB / 4; e += DIAG_THREADS) {
      const int r = e / (NB / 4), c = 4 * (e % (NB / 4));
      const float4 v = *reinterpret_cast<const float4*>(A + (size_t)(s + r) * n + s + c);
      float* d = sm.D + r * LDD + c;
      d[0] = (c + 0 <= r) ? v.x : 0.0f;
      d[1] = (c + 1 <= r) ? v.y : 0.0f;
      d[2] = (c + 2 <= r) ? v.z : 0.0f;
      d[3] = (c + 3 <= r) ? v.w : 0.0f;
    }
  } else {
    for (int e = tid; e < NB * NB; e += DIAG_THREADS) {
      const int r = e / NB, c = e % NB;
      float v;
      if (r < w && c < w)
        v = (c <= r) ? A[(size_t)(s + r) * n + s + c] : 0.0f;
      else
        v = (r == c) ? 1.0f : 0.0f;
      sm.D[r * LDD + c] = v;
    }
  }
  diag_factor_inv(sm, tid);
  diag_store(sm, A, work + (size_t)blockIdx.x * 2 * NB * NB, n, s, w, tid);
}

// ------------------------------------------------------------------- panel

// 64 x 64 elements A[row0 + r][col0 + c] into registers, four float4 per
// thread (0 for rows at or beyond `rlimit`; float4 loads where the rows
// start on 16 bytes), and from there to dst[r * LDP + c]: in two steps, so
// that the next block's loads are in flight while this one is multiplied
__device__ __forceinline__ void gload64(float4 (&v)[4], const float* A, int n, int row0,
                                        int rlimit, int col0, bool vec, int tid) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int idx = tid + q * PANEL_THREADS;
    const int r = idx / (NB / 4), c = 4 * (idx % (NB / 4));
    v[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < rlimit) {
      const float* src = A + (size_t)(row0 + r) * n + col0 + c;
      if (vec) {
        v[q] = *reinterpret_cast<const float4*>(src);
      } else {
        v[q] = make_float4(src[0], src[1], src[2], src[3]);
      }
    }
  }
}

__device__ __forceinline__ void sstore64(float* dst, const float4 (&v)[4], int tid) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int idx = tid + q * PANEL_THREADS;
    *reinterpret_cast<float4*>(dst + (idx / (NB / 4)) * LDP + 4 * (idx % (NB / 4))) = v[q];
  }
}

union PanelSmem {
  float pq[2 * NB * LDP];  // the two operand blocks of the products
  DiagSmem diag;           // block 0 afterwards
};

// The rows below the diagonal block [s, s+64) of the outer panel that
// starts at column S; `pe` is the end of that outer panel. `work` holds
// inv(L11) of this step in one half of the matrix's scratch; block 0
// writes the next step's into the other half.
__global__ void __launch_bounds__(PANEL_THREADS)
panel_kernel(float* __restrict__ a, float* __restrict__ work, int n, int S, int s, int pe) {
  __shared__ __align__(16) PanelSmem sm;
  float* P = sm.pq;
  float* Q = sm.pq + NB * LDP;
  float* A = a + (size_t)blockIdx.y * n * n;
  // inv(L11) of this step in one half of the matrix's scratch; the next
  // step's goes to the other half
  const int half = ((s - S) / NB) & 1;
  const float* W = work + ((size_t)blockIdx.y * 2 + half) * NB * NB;
  float* Wnext = work + ((size_t)blockIdx.y * 2 + (half ^ 1)) * NB * NB;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int r0 = s + NB + blockIdx.x * NB;  // first row of this block
  const bool vec = (n % 4) == 0;

  // this thread's elements of A21, asked for before the update's loads
  float t[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      t[i][j] = (r < n) ? A[(size_t)r * n + s + tx + 16 * j] : 0.0f;
  }

  // left-looking update from the earlier inner steps of this outer panel
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  float4 gp[4], gq[4];
  if (S < s) {
    gload64(gp, A, n, r0, n, S, vec, tid);
    gload64(gq, A, n, s, n, S, vec, tid);
  }
  for (int kc = S; kc < s; kc += NB) {
    sstore64(P, gp, tid);
    sstore64(Q, gq, tid);
    __syncthreads();
    if (kc + NB < s) {
      gload64(gp, A, n, r0, n, kc + NB, vec, tid);
      gload64(gq, A, n, s, n, kc + NB, vec, tid);
    } else {
      gload64(gq, W, NB, 0, NB, 0, true, tid);  // inv(L11) for the product below
    }
    mma64(P, Q, ty, tx, acc);
    __syncthreads();
  }
  if (S == s) gload64(gq, W, NB, 0, NB, 0, true, tid);

  // T = A21 - update, then L21 = T inv(L11)^T
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      P[(ty + 16 * i) * LDP + tx + 16 * j] = t[i][j] - acc[i][j];
  sstore64(Q, gq, tid);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  mma64(P, Q, ty, tx, acc);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      P[(ty + 16 * i) * LDP + tx + 16 * j] = acc[i][j];
      if (r < n) A[(size_t)r * n + s + tx + 16 * j] = acc[i][j];
    }
  }

  // the mirror image in the strict upper triangle: rows s..s+63, columns
  // r0..r0+rows-1
  const int rows = min(NB, n - r0);
  for (int e = tid; e < NB * rows; e += PANEL_THREADS) {
    const int j = e / rows, c = e % rows;
    A[(size_t)(s + j) * n + r0 + c] = 0.0f;
  }

  // these rows hold a later diagonal block of the same outer panel: bring
  // it up to date, A[r, r] -= L21 L21^T on and below the diagonal
  if (r0 < pe) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    mma64(P, P, ty, tx, acc);
    float d[4][4];  // loads first, then stores
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        d[i][j] = (c <= r && r0 + r < n) ? A[(size_t)(r0 + r) * n + r0 + c] : 0.0f;
      }
    }
    if (blockIdx.x != 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          if (c <= r && r0 + r < n) A[(size_t)(r0 + r) * n + r0 + c] = d[i][j] - acc[i][j];
        }
      }
    } else {
      // the diagonal block of the next inner step is final now: factor and
      // invert it here, beside the other blocks, and save a launch
      const int w = min(NB, n - r0);
      __syncthreads();  // the products above read the memory that D overlays
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          float v = c <= r ? d[i][j] - acc[i][j] : 0.0f;
          if (r >= w || c >= w) v = (r == c) ? 1.0f : 0.0f;
          sm.diag.D[r * LDD + c] = v;
        }
      }
      diag_factor_inv(sm.diag, tid);
      diag_store(sm.diag, A, Wnext, n, r0, w, tid);
    }
  }
}

// ------------------------------------------------------------------ update

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

// One stage of the ring: ROWS rows x 32 columns of the panel, rows
// row0.. of the trailing matrix (zeros at and beyond M), columns k0..
template <int ROWS>
__device__ __forceinline__ void stage_load(float* dst, const float* L, int n, int row0,
                                           int M, int k0, bool vec, int tid) {
#pragma unroll
  for (int q = 0; q < (ROWS * KC / 4) / UPDATE_THREADS; ++q) {
    const int idx = tid + q * UPDATE_THREADS;
    const int r = idx / (KC / 4), c = 4 * (idx % (KC / 4));
    const bool in = row0 + r < M;
    const float* src = L + (size_t)(in ? row0 + r : 0) * n + k0 + c;
    float* d = dst + r * LDK + c;
    if (vec) {
      cp_async16(d, src, in ? 16 : 0);
    } else {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (in) v = make_float4(src[0], src[1], src[2], src[3]);
      *reinterpret_cast<float4*>(d) = v;
    }
  }
}

// The tile of 16 RI rows from r0 and 128 columns from c0 of the trailing
// matrix that starts at row and column t0 = S + 256:
// C -= L21[rows] L21[cols]^T on and below the diagonal, with L21 the 256
// columns from S. RI = 8 is the 128 x 128 tile of the big update (the tile
// on the diagonal stages its panel slice once); RI = 4 halves the tile for
// a lookahead update that would otherwise leave most of the card idle.
//
// Arithmetic: float32 FMA. Plain TF32 is ruled out, because the update
// cancels O(|K|) down to O(noise) and 10 mantissa bits leave negative
// pivots. The split ("3xTF32") product, hi*hi + hi*lo + lo*hi with float32
// accumulation, was tried on this tile and measured (PERF.md has the
// table): as three mma.sync.m16n8k8 per product it was at most 5% faster
// than the FMA tile (the splitting and the scalar fragment reads take what
// the tensor cores save), and the factor's error against float64 roughly
// doubled (4.8-5.5e-6 against 2.1-2.6e-6 at the G = 1 shapes), past
// cholesky_ex's at four of the six shapes, so the FMA tile stays and the
// variant is not kept in the source.
template <int RI>
__device__ __forceinline__ void update_tile(float* __restrict__ A, int n, int S, int r0,
                                            int c0, float* smem) {
  constexpr int BM = 16 * RI;
  const int t0 = S + NBO;
  const int M = n - t0;
  const float* L = A + (size_t)t0 * n + S;  // L21: row r is L + r * n
  const bool diag = BM == TILE && r0 == c0;
  const bool vec = (n % 4) == 0;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  constexpr int NCH = NBO / KC;
  float* Cs = smem + STAGES * STAGE_FLOATS;

  auto load = [&](int chunk) {
    float* st = smem + (chunk % STAGES) * STAGE_FLOATS;
    stage_load<BM>(st, L, n, r0, M, chunk * KC, vec, tid);
    if (!diag) stage_load<TILE>(st + TILE * LDK, L, n, c0, M, chunk * KC, vec, tid);
  };
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    load(c);
    if (c == STAGES - 2) {
      // the C tile itself, whole rows of 512 bytes, into shared memory
      // behind the first stages: by the time the products are done it has
      // long arrived, and the epilogue waits for no load from device memory
      for (int idx = tid; idx < BM * TILE / 4; idx += UPDATE_THREADS) {
        const int r = idx / (TILE / 4), c4 = 4 * (idx % (TILE / 4));
        const bool in = r0 + r < M && c0 + c4 < M;  // c0 + c4 + 3 < M: M % 4 == 0
        const float* src = A + (size_t)(t0 + (in ? r0 + r : 0)) * n + t0 + (in ? c0 + c4 : 0);
        float* d = Cs + r * LDC + c4;
        if (vec) {
          cp_async16(d, src, in ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            d[e] = (r0 + r < M && c0 + c4 + e < M) ? src[e] : 0.0f;
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  float acc[RI][8];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int c = 0; c < NCH; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();
    if (c + STAGES - 1 < NCH) load(c + STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const float* As = smem + (c % STAGES) * STAGE_FLOATS;
    const float* Bs = diag ? As : As + TILE * LDK;
#pragma unroll
    for (int k = 0; k < KC; k += 4) {
      float4 p[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        p[i] = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * LDK + k);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 q = *reinterpret_cast<const float4*>(Bs + (tx + 16 * j) * LDK + k);
        // RI independent accumulators per component, so that no FMA waits
        // for the one before it
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] += p[i].x * q.x;
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] += p[i].y * q.y;
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] += p[i].z * q.z;
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] += p[i].w * q.w;
      }
    }
  }

  // C -= acc on and below the diagonal, C read from its staged copy
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    if (r0 + r >= M) continue;
    float* row = A + (size_t)(t0 + r0 + r) * n + t0 + c0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 16 * j;
      if (c0 + c <= r0 + r) row[c] = Cs[r * LDC + c] - acc[i][j];
    }
  }
}

// The first two tile columns, the 256 columns of the next outer panel, in
// tiles of 16 RI rows, `ntr` tile rows in all: column 0 from tile row 0,
// column 1 from the first tile row that reaches its diagonal.
template <int RI>
__global__ void __launch_bounds__(UPDATE_THREADS, 1)
lookahead_update_kernel(float* __restrict__ a, int n, int S, int ntr) {
  extern __shared__ __align__(16) float smem[];
  constexpr int FIRST = TILE / (16 * RI);  // first tile row of column 1
  const int t = blockIdx.x;
  const int bj = t < ntr ? 0 : 1;
  const int bi = t < ntr ? t : t - ntr + FIRST;
  update_tile<RI>(a + (size_t)blockIdx.y * n * n, n, S, bi * 16 * RI, bj * TILE, smem);
}

// the lower 128 x 128 tiles from tile column 2 on
__global__ void __launch_bounds__(UPDATE_THREADS, 1)
trailing_update_kernel(float* __restrict__ a, int n, int S) {
  extern __shared__ __align__(16) float smem[];
  const int t = blockIdx.x;
  int bi = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  while (bi * (bi + 1) / 2 > t) --bi;
  while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
  const int bj = t - bi * (bi + 1) / 2;
  update_tile<8>(a + (size_t)blockIdx.y * n * n, n, S, (bi + 2) * TILE, (bj + 2) * TILE,
                 smem);
}

// ------------------------------------------------------------------- host

struct DeviceState {
  bool ready = false;
  int sms = 0;  // multiprocessors of the device
  cudaStream_t side = nullptr;
  cudaEvent_t start = nullptr, panel = nullptr, rest = nullptr;
};
constexpr int MAX_DEVICES = 64;
DeviceState g_state[MAX_DEVICES];
std::mutex g_mutex;

cudaError_t make_state(DeviceState& st, int dev) {
  cudaError_t err;
  if ((err = cudaDeviceGetAttribute(&st.sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  int least = 0, greatest = 0;
  if ((err = cudaDeviceGetStreamPriorityRange(&least, &greatest)) != cudaSuccess) return err;
  if ((err = cudaStreamCreateWithPriority(&st.side, cudaStreamNonBlocking, greatest)) !=
      cudaSuccess)
    return err;
  cudaEvent_t* events[3] = {&st.start, &st.panel, &st.rest};
  for (cudaEvent_t* e : events)
    if ((err = cudaEventCreateWithFlags(e, cudaEventDisableTiming)) != cudaSuccess) return err;
  const void* updates[3] = {(const void*)lookahead_update_kernel<4>,
                            (const void*)lookahead_update_kernel<8>,
                            (const void*)trailing_update_kernel};
  for (const void* f : updates)
    if ((err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)UPDATE_SMEM)) != cudaSuccess)
      return err;
  return cudaSuccess;
}

cudaError_t device_state(DeviceState** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  DeviceState& st = g_state[dev];
  if (!st.ready) {
    if ((err = make_state(st, dev)) != cudaSuccess) {
      // a later call starts afresh and finds nothing half made
      if (st.side) cudaStreamDestroy(st.side);
      for (cudaEvent_t e : {st.start, st.panel, st.rest})
        if (e) cudaEventDestroy(e);
      st = DeviceState();
      return err;
    }
    st.ready = true;
  }
  *out = &st;
  return cudaSuccess;
}

}  // namespace

#define DSM_CHECK(call)                                  \
  do {                                                   \
    cudaError_t e_ = (call);                             \
    if (e_ != cudaSuccess) return (int)e_;               \
  } while (0)

extern "C" int dsm_blocked_cholesky(void* a, void* work, int G, int n, void* stream) {
  if (G < 0 || n < 0 || G > 65535) return (int)cudaErrorInvalidValue;
  if (G == 0 || n == 0) return 0;
  std::lock_guard<std::mutex> lock(g_mutex);
  DeviceState* st = nullptr;
  DSM_CHECK(device_state(&st));
  cudaStream_t caller = static_cast<cudaStream_t>(stream);
  cudaStream_t side = st->side;
  float* A = static_cast<float*>(a);
  float* W = static_cast<float*>(work);

  // the side stream starts after whatever the caller's stream holds
  DSM_CHECK(cudaEventRecord(st->start, caller));
  DSM_CHECK(cudaStreamWaitEvent(side, st->start, 0));
  bool rest_pending = false;  // a rest update the next lookahead must wait for
  for (int S = 0; S < n; S += NBO) {
    const int pe = n - S < NBO ? n : S + NBO;
    // the panel's first diagonal block, then one launch per inner step:
    // the rows below the step's block, and the next step's block with them
    diag_inv_kernel<<<G, DIAG_THREADS, 0, side>>>(A, W, n, S, n - S < NB ? n - S : NB);
    DSM_CHECK(cudaGetLastError());
    for (int s = S; s < pe && n - s > NB; s += NB) {
      panel_kernel<<<dim3((n - s - 1) / NB, G), PANEL_THREADS, 0, side>>>(A, W, n, S, s, pe);
      DSM_CHECK(cudaGetLastError());
    }
    const int M = n - pe;
    if (M <= 0) break;
    const int nt = (M + TILE - 1) / TILE;
    DSM_CHECK(cudaEventRecord(st->panel, side));
    if (rest_pending) DSM_CHECK(cudaStreamWaitEvent(side, st->rest, 0));
    rest_pending = false;
    // 128-row tiles if they give every multiprocessor two, else 64-row ones
    if ((long long)(2 * nt - 1) * G >= 2LL * st->sms) {
      lookahead_update_kernel<8><<<dim3(nt > 1 ? 2 * nt - 1 : 1, G), UPDATE_THREADS,
                                   UPDATE_SMEM, side>>>(A, n, S, nt);
    } else {
      const int ntr = (M + TILE / 2 - 1) / (TILE / 2);
      lookahead_update_kernel<4><<<dim3(ntr > 2 ? 2 * ntr - 2 : ntr, G), UPDATE_THREADS,
                                   UPDATE_SMEM, side>>>(A, n, S, ntr);
    }
    DSM_CHECK(cudaGetLastError());
    if (nt > 2) {
      const long long m = nt - 2;
      DSM_CHECK(cudaStreamWaitEvent(caller, st->panel, 0));
      trailing_update_kernel<<<dim3((unsigned)(m * (m + 1) / 2), G), UPDATE_THREADS,
                               UPDATE_SMEM, caller>>>(A, n, S);
      DSM_CHECK(cudaGetLastError());
      DSM_CHECK(cudaEventRecord(st->rest, caller));
      rest_pending = true;
    }
  }
  // the caller's stream goes on after the side stream
  DSM_CHECK(cudaEventRecord(st->panel, side));
  DSM_CHECK(cudaStreamWaitEvent(caller, st->panel, 0));
  return 0;
}
