// In-place batched lower Cholesky of SPD matrices, blocked and right-looking.
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
//     i >= the valid size) stay exactly the identity, because every update
//     they take is a product with exact zeros;
//   * a matrix that is not positive definite takes the square root of a
//     negative pivot, and the NaN spreads through the rest: the result is
//     non-finite, nothing raises;
//   * any n >= 1 and any G >= 1 (the TPU kernel needed n % 256 == 0 and
//     G <= 4 for its VMEM scratch); a ragged last panel is masked.
//
// What bounds it on an H100. A matrix of n rows needs n^3/3 floating-point
// operations (n^3/6 FMAs) on 2 n^2 * 4 bytes (read once, written once). At
// 67 TFLOP/s (float32 FMA outside the tensor cores) against 3.35 TB/s that
// is compute-bound at every bucket size: the 23 buckets of the N=100k
// headline tree hold 19.9 TFLOP of padded work, 0.297 s at peak, against
// about 16 ms for their bytes. Tensor cores are ruled out: the trailing
// update cancels O(|K|) down to O(noise), and a reduced-precision pass gave
// negative diagonals on the TPU (ops/pallas_chol.py:204-206), so TF32 is
// not used.
//
// The design. The hybrid fit factors one leaf at a time for n >= 4096, so
// the parallelism has to come from the tiles of one matrix. For each
// 64-wide panel s = 0, 64, ... the host launches on PyTorch's stream:
//   a. `diag_factor_kernel`, one block per matrix: the 64 x 64 diagonal
//      block in shared memory, factored by a 2 x 2 split into 32-wide
//      sub-blocks, each factored by one warp in registers (one row per
//      lane, columns broadcast by shuffle, the pivot by rsqrt); the upper
//      part of the block is written as 0. This is the serial critical
//      path, the same one that bounded the TPU kernel
//      (pallas_potrf.py:40-54): tens of microseconds per panel;
//   b. `panel_solve_kernel`, one block per (matrix, 64 rows below the
//      panel): L21 = A21 L11^{-T} by substitution, one row per thread in
//      registers, L11 and the reciprocals of its diagonal broadcast from
//      shared memory; the block also writes
//      0 over the mirror image of its rows in the strict upper triangle;
//   c. `trailing_update_kernel`, one block per (matrix, 128 x 128 tile on
//      or below the diagonal of the trailing matrix): A22 -= L21 L21^T as
//      a float32-FMA SYRK, the two 128 x 64 panel slices staged in shared
//      memory (k-major, padded stride, coalesced loads and conflict-free
//      stores) and 8 x 8 outputs per thread in registers, read from
//      shared memory as float4 (4 loads per 64 FMAs); only elements on or
//      below the diagonal are written, 4 at a time where n % 4 == 0.
// Step c is nearly all of the work. With a rank-64 update each trailing
// element is read and written once per panel, so the update moves about
// (n^3/3) / 16 bytes in all, on the order of the FLOP bound at 3.35 TB/s:
// a wider panel, wgmma with 3xTF32 splitting, and a lookahead that
// overlaps step a with step c are left for later work.
//
// Plain C interface for ctypes (built with nvcc -shared, no PyTorch
// headers): dsm_blocked_cholesky launches on the given stream, checks
// cudaGetLastError() after every launch and returns the first error
// (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int NB = 64;               // panel width
constexpr int SUB = 32;              // warp-factored sub-block of a panel
constexpr int LDD = NB + 1;          // padded shared row stride
constexpr int DIAG_THREADS = 256;
constexpr int ROWS = 64;             // panel-solve rows per block
constexpr int TILE = 128;            // trailing-update output tile edge
constexpr int TT = 16;               // threads per tile edge: 8 x 8 outputs each
constexpr int LDT = TILE + 4;        // padded shared stride of a staged slice
constexpr int UPDATE_THREADS = TT * TT;
constexpr unsigned FULL = 0xffffffffu;
static_assert(TILE == 8 * TT, "8 x 8 outputs per thread");
static_assert(NB % SUB == 0, "the panel splits into warp sub-blocks");
static_assert(NB % 8 == 0 && TILE % 16 == 0, "staging covers whole units");

__global__ void __launch_bounds__(DIAG_THREADS)
diag_factor_kernel(float* __restrict__ a, int n, int s, int w) {
  __shared__ float D[NB * LDD];
  __shared__ float rd[NB];  // reciprocals of the factor's diagonal
  float* A = a + (size_t)blockIdx.x * n * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the w x w diagonal block (lower triangle), identity beyond w
  for (int e = tid; e < NB * NB; e += DIAG_THREADS) {
    const int r = e / NB, c = e % NB;
    float v;
    if (r < w && c < w)
      v = (c <= r) ? A[(size_t)(s + r) * n + s + c] : 0.0f;
    else
      v = (r == c) ? 1.0f : 0.0f;
    D[r * LDD + c] = v;
  }
  __syncthreads();

  for (int p = 0; p < NB; p += SUB) {
    // 1. warp 0 factors the sub-block D[p:p+32, p:p+32]; lane i holds row p+i
    if (warp == 0) {
      float v[SUB];
      float* row = D + (p + lane) * LDD + p;
#pragma unroll
      for (int c = 0; c < SUB; ++c) v[c] = row[c];
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        // the rows below scale by one rsqrt instead of a square root and
        // a division on the serial chain (as the TPU kernel's _sweep
        // does); the diagonal itself is the exact square root, off the
        // chain, so that identity padding stays exactly 1
        const float pivot = __shfl_sync(FULL, v[j], j);
        const float rj = rsqrtf(pivot);
        if (lane == j) v[j] = sqrtf(pivot);
        if (lane > j) v[j] = v[j] * rj;
        if (lane == j) rd[p + j] = rj;
#pragma unroll
        for (int c = j + 1; c < SUB; ++c) {
          const float lcj = __shfl_sync(FULL, v[j], c);
          if (lane >= c) v[c] -= v[j] * lcj;
        }
      }
#pragma unroll
      for (int c = 0; c < SUB; ++c) row[c] = (c <= lane) ? v[c] : 0.0f;
    }
    __syncthreads();
    const int m = NB - p - SUB;  // rows of the block below the sub-block
    if (m > 0) {
      // 2. those rows: X = A21 Lpp^{-T}, one row per thread
      if (tid < m) {
        float v[SUB];
        float* row = D + (p + SUB + tid) * LDD + p;
#pragma unroll
        for (int c = 0; c < SUB; ++c) v[c] = row[c];
#pragma unroll
        for (int j = 0; j < SUB; ++j) {
          const float x = v[j] * rd[p + j];
          v[j] = x;
#pragma unroll
          for (int c = j + 1; c < SUB; ++c) v[c] -= x * D[(p + c) * LDD + p + j];
        }
#pragma unroll
        for (int c = 0; c < SUB; ++c) row[c] = v[c];
      }
      __syncthreads();
      // 3. the rest of the block: D22 -= X X^T, lower triangle
      for (int e = tid; e < m * m; e += DIAG_THREADS) {
        const int i = e / m, j = e % m;
        if (j <= i) {
          const float* xi = D + (p + SUB + i) * LDD + p;
          const float* xj = D + (p + SUB + j) * LDD + p;
          float acc = 0.0f;
#pragma unroll
          for (int q = 0; q < SUB; ++q) acc += xi[q] * xj[q];
          D[(p + SUB + i) * LDD + p + SUB + j] -= acc;
        }
      }
      __syncthreads();
    }
  }

  // the factor of the w x w block, its strict upper part as 0
  for (int e = tid; e < w * w; e += DIAG_THREADS) {
    const int r = e / w, c = e % w;
    A[(size_t)(s + r) * n + s + c] = (c <= r) ? D[r * LDD + c] : 0.0f;
  }
}

__global__ void __launch_bounds__(ROWS)
panel_solve_kernel(float* __restrict__ a, int n, int s) {
  __shared__ float Lp[NB * LDD];    // L11
  __shared__ float P[ROWS * LDD];   // this block's rows of the panel
  __shared__ float rd[NB];          // reciprocals of L11's diagonal
  float* A = a + (size_t)blockIdx.y * n * n;
  const int tid = threadIdx.x;
  const int r0 = s + NB + blockIdx.x * ROWS;  // first row of this block
  const int rows = min(ROWS, n - r0);

  for (int e = tid; e < NB * NB; e += ROWS) {
    const int r = e / NB, c = e % NB;
    Lp[r * LDD + c] = (c <= r) ? A[(size_t)(s + r) * n + s + c] : 0.0f;
  }
  for (int e = tid; e < rows * NB; e += ROWS) {
    const int r = e / NB, c = e % NB;
    P[r * LDD + c] = A[(size_t)(r0 + r) * n + s + c];
  }
  __syncthreads();
  for (int j = tid; j < NB; j += ROWS) rd[j] = 1.0f / Lp[j * LDD + j];
  __syncthreads();

  if (tid < rows) {
    float v[NB];
    float* row = P + tid * LDD;
#pragma unroll
    for (int c = 0; c < NB; ++c) v[c] = row[c];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float x = v[j] * rd[j];  // multiplies on the serial chain
      v[j] = x;
#pragma unroll
      for (int c = j + 1; c < NB; ++c) v[c] -= x * Lp[c * LDD + j];
    }
#pragma unroll
    for (int c = 0; c < NB; ++c) row[c] = v[c];
  }
  __syncthreads();

  for (int e = tid; e < rows * NB; e += ROWS) {
    const int r = e / NB, c = e % NB;
    A[(size_t)(r0 + r) * n + s + c] = P[r * LDD + c];
  }
  // the mirror image in the strict upper triangle: rows s..s+NB-1,
  // columns r0..r0+rows-1
  for (int e = tid; e < NB * rows; e += ROWS) {
    const int j = e / rows, c = e % rows;
    A[(size_t)(s + j) * n + r0 + c] = 0.0f;
  }
}

__device__ __forceinline__ int quad_index(int i, int t) {
  // the i-th of a thread's 8 rows (or columns): two groups of 4 adjacent
  // ones, TILE / 2 apart, so that each group is one float4
  return (i < 4 ? 0 : TILE / 2) + 4 * t + (i & 3);
}

__global__ void __launch_bounds__(UPDATE_THREADS, 2)
trailing_update_kernel(float* __restrict__ a, int n, int s) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;               // [NB][LDT] the tile's row slice of L21
  float* Bs = smem + NB * LDT;    // [NB][LDT] its column slice
  float* A = a + (size_t)blockIdx.y * n * n;
  const int t0 = s + NB;          // first row and column of the trailing matrix
  const int M = n - t0;
  const bool vec = (n % 4) == 0;  // rows start on 16 bytes: float4 access

  // lower tile number t -> (bi, bj), bj <= bi
  const int t = blockIdx.x;
  int bi = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  while (bi * (bi + 1) / 2 > t) --bi;
  while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
  const int bj = t - bi * (bi + 1) / 2;
  const int r0 = bi * TILE, c0 = bj * TILE;

  // stage both slices k-major: a warp reads 16 rows x 8 consecutive k
  // (two float4 per row, coalesced) and its transposed stores fall on 32
  // distinct banks (row stride LDT = TILE + 4)
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int u = warp; u < (TILE / 16) * (NB / 8); u += UPDATE_THREADS / 32) {
    const int r = 16 * (u / (NB / 8)) + (lane & 15);
    const int k = 8 * (u % (NB / 8)) + 4 * (lane >> 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* dst = h ? Bs : As;
      const int row = (h ? c0 : r0) + r;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < M) {
        const float* src = A + (size_t)(t0 + row) * n + s + k;
        if (vec) {
          v = *reinterpret_cast<const float4*>(src);
        } else {
          v = make_float4(src[0], src[1], src[2], src[3]);
        }
      }
      dst[(k + 0) * LDT + r] = v.x;
      dst[(k + 1) * LDT + r] = v.y;
      dst[(k + 2) * LDT + r] = v.z;
      dst[(k + 3) * LDT + r] = v.w;
    }
  }
  __syncthreads();

  const int tx = tid % TT, ty = tid / TT;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < NB; ++k) {
    const float* ak = As + k * LDT + 4 * ty;
    const float* bk = Bs + k * LDT + 4 * tx;
    const float4 a0 = *reinterpret_cast<const float4*>(ak);
    const float4 a1 = *reinterpret_cast<const float4*>(ak + TILE / 2);
    const float4 b0 = *reinterpret_cast<const float4*>(bk);
    const float4 b1 = *reinterpret_cast<const float4*>(bk + TILE / 2);
    const float pa[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float pb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += pa[i] * pb[j];
  }

  // C -= acc on and below the diagonal; 4 adjacent columns at a time
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + quad_index(i, ty);
    if (r >= M) continue;
    float* row = A + (size_t)(t0 + r) * n + t0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + quad_index(4 * h, tx);
      if (c > r) continue;
      if (vec && c + 3 <= r) {
        float4* p = reinterpret_cast<float4*>(row + c);
        float4 v = *p;
        v.x -= acc[i][4 * h + 0];
        v.y -= acc[i][4 * h + 1];
        v.z -= acc[i][4 * h + 2];
        v.w -= acc[i][4 * h + 3];
        *p = v;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j <= r) row[c + j] -= acc[i][4 * h + j];
      }
    }
  }
}

}  // namespace

extern "C" int dsm_blocked_cholesky(void* a, int G, int n, void* stream) {
  if (G < 0 || n < 0 || G > 65535) return (int)cudaErrorInvalidValue;
  if (G == 0 || n == 0) return 0;
  const size_t smem = 2 * NB * LDT * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      trailing_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* A = static_cast<float*>(a);
  for (int s = 0; s < n; s += NB) {
    const int w = n - s < NB ? n - s : NB;
    diag_factor_kernel<<<G, DIAG_THREADS, 0, st>>>(A, n, s, w);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int M = n - s - w;
    if (M <= 0) break;
    panel_solve_kernel<<<dim3((M + ROWS - 1) / ROWS, G), ROWS, 0, st>>>(A, n, s);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const long long nt = (M + TILE - 1) / TILE;
    trailing_update_kernel<<<dim3((unsigned)(nt * (nt + 1) / 2), G),
                             UPDATE_THREADS, smem, st>>>(A, n, s);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
