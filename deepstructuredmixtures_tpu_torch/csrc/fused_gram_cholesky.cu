// Fused IsoSE gram + blocked Cholesky, one thread-block cluster per leaf.
//
// Replaces the Pallas TPU kernel `fused_gram_cholesky` of
// deepstructuredmixtures_tpu/ops/pallas_chol.py (kernel body `_fused_kernel`)
// and computes the same thing: for each leaf l with n[l] valid rows of
// x[l] (N x D, zero-padded to N),
//
//   K[i][j] = exp(2 logsigma) * exp(-0.5 * max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0)
//                                    * exp(-2 logl))          (i, j < n)
//   K[i][i] += noise + eps                                     (i < n)
//   K[i][i]  = 1, K[i][j] = 0 elsewhere                        (padding)
//
// followed by the lower Cholesky factor of K, written in place into
// out[l] (N x N, row-major). The strict upper triangle of out is exactly 0;
// padded rows and columns come out as the identity exactly.
//
// What bounds it on an H100. A leaf of N <= 1024 needs N^3/6 FMAs for the
// factor (about 1.8e8 at N = 1024) on N^2 * 4 bytes (4 MiB) of output. The
// TPU kernel keeps the whole [G, N, N] block in VMEM; a Hopper block has at
// most 227 KB of shared memory, so that design does not carry over, and
// one block per leaf would leave most of the 132 SMs idle at the 12-16
// leaves of a bucket. Here each leaf gets a cluster of 8 blocks when the
// clusters of all L leaves fit on the card at once
// (cudaOccupancyMaxActiveClusters), else of 4 — a second wave of clusters
// costs more than the narrower cluster (measured on an H100 at 16 leaves).
// The factor lives in global memory (L2-resident at these sizes); the
// algorithm is right-looking with 32-wide panels:
//   1. the blocks of the cluster write the gram's rows round-robin, lower
//      triangle only (upper = 0);
//   2. for each panel s = 0, 32, ...: each thread of the cluster loads one
//      row of the sub-panel A[s+32:N, s:s+32] into registers; every block
//      stages the 32 x 32 diagonal block and one warp factors it in
//      registers (one row per lane, column broadcasts by shuffle) —
//      redundantly, the same arithmetic in every block — while the row
//      loads are in flight; each thread solves its row against L11^T and
//      writes it back; after a cluster barrier every block reloads the
//      solved sub-panel into shared memory (row stride 33: conflict-free
//      column reads) and takes its share of the 64 x 64 tiles of the
//      rank-32 trailing update A22 -= P P^T (lower triangle only), 4 x 4
//      outputs per thread.
// The trailing update is the bulk of the work: 16 FMAs per 8 shared-memory
// loads, bound by shared-memory bandwidth on each SM, and every panel step
// streams the trailing triangle through L2 once. The sequential chain is
// N/32 steps of diagonal factor, row solve, panel reload and two cluster
// barriers; global loads are issued several at a time so that they wait on
// the L2 latency together. All loads of the factor bypass L1
// (ld.global.cg), because another SM of the cluster may have written the
// line since; the cluster barrier's release/acquire orders those writes.
// wgmma tiles, leaf stacking and fewer barriers are left for later work.
//
// Precision: float32 FMA throughout, no TF32 and no bf16 — the trailing
// update cancels O(|K|) down to O(noise), and low-precision passes gave
// negative diagonals on the TPU (ops/pallas_chol.py:204-206).
//
// Plain C interface for ctypes (built with nvcc -shared, no PyTorch headers):
// dsm_fused_gram_cholesky launches on the given stream and returns
// cudaGetLastError() (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_CLUSTER = 8;      // blocks per leaf (the portable maximum)
constexpr int MIN_CLUSTER = 4;      // ... when the wide clusters would not fit
constexpr int PANEL = 32;           // panel width: one row per lane of warp 0
constexpr int STRIDE = PANEL + 1;   // padded shared row stride
constexpr int THREADS = 256;
constexpr int UT = 64;              // trailing-update output tile edge
constexpr int MAX_N = 1024;
constexpr int LOADS = 8;            // float4 loads in flight per thread
// every sub-panel row gets its own thread of the cluster
static_assert(MIN_CLUSTER * THREADS >= MAX_N - PANEL, "one row per thread");
// the diagonal block is staged as one float4 per thread
static_assert(THREADS * 4 == PANEL * PANEL, "one float4 per thread");

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

__global__ void __launch_bounds__(THREADS, 1)
fused_gram_cholesky_kernel(const float* __restrict__ x,
                           const int* __restrict__ nvalid,
                           const float* __restrict__ logl,
                           const float* __restrict__ logsigma,
                           const float* __restrict__ noise,
                           float* __restrict__ out, int N, int D, float eps) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int leaf = blockIdx.x / csize;
  const int tid = threadIdx.x;
  const float* xl = x + (size_t)leaf * N * D;
  float* A = out + (size_t)leaf * N * N;
  const int n = nvalid[leaf];
  const float amp = expf(2.0f * logsigma[leaf]);
  const float il2 = expf(-2.0f * logl[leaf]);
  const float dadd = noise[leaf] + eps;

  // ---- 1. gram + noise + identity padding, rows round-robin ---------------
  float* sq = smem;  // [N] squared norms
  for (int i = tid; i < N; i += THREADS) {
    float s = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float v = xl[(size_t)i * D + d];
      s += v * v;
    }
    sq[i] = s;
  }
  __syncthreads();
  for (int i = rank; i < N; i += csize) {
    const float* xi = xl + (size_t)i * D;
    for (int j = tid; j < N; j += THREADS) {
      float v = 0.0f;
      if (j <= i) {
        if (i < n) {  // j <= i < n: both rows valid
          const float* xj = xl + (size_t)j * D;
          float cross = 0.0f;
          for (int d = 0; d < D; ++d) cross += xi[d] * xj[d];
          const float d2 = fmaxf(sq[i] + sq[j] - 2.0f * cross, 0.0f);
          v = amp * expf(-0.5f * d2 * il2);
          if (i == j) v += dadd;
        } else if (i == j) {
          v = 1.0f;
        }
      }
      A[(size_t)i * N + j] = v;
    }
  }
  cluster.sync();

  // ---- 2. right-looking blocked Cholesky, in place -------------------------
  float* L11 = smem;                    // [PANEL][STRIDE] diagonal block
  float* P = smem + PANEL * STRIDE;     // sub-panel rows, [N - s - PANEL][STRIDE]
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int myrow = PANEL + rank * THREADS + tid;  // sub-panel row, from s
  for (int s = 0; s < N; s += PANEL) {
    const int R = N - s;  // panel rows, diagonal block included
    const bool solver = myrow < R;

    // a. this thread's sub-panel row into registers, the diagonal block
    //    into shared memory
    float v[PANEL];
    float* vrow = A + (size_t)(s + myrow) * N + s;
    if (solver) {
#pragma unroll
      for (int q = 0; q < PANEL / 4; ++q) {
        const float4 t = ld4(vrow + 4 * q);
        v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z; v[4 * q + 3] = t.w;
      }
    }
    {
      const int r = tid / (PANEL / 4), q = tid % (PANEL / 4);  // 256 float4
      const float4 t = ld4(A + (size_t)(s + r) * N + s + 4 * q);
      float* d = L11 + r * STRIDE + 4 * q;
      d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
    }
    __syncthreads();

    // b. factor the diagonal block: lane i holds row i in registers
    if (warp == 0) {
      float a[PANEL];
#pragma unroll
      for (int c = 0; c < PANEL; ++c) a[c] = L11[lane * STRIDE + c];
#pragma unroll
      for (int j = 0; j < PANEL; ++j) {
        const float dj = sqrtf(__shfl_sync(0xffffffffu, a[j], j));
        if (lane == j) a[j] = dj;
        if (lane > j) a[j] = a[j] / dj;
#pragma unroll
        for (int c = j + 1; c < PANEL; ++c) {
          const float lcj = __shfl_sync(0xffffffffu, a[j], c);
          if (lane >= c) a[c] -= a[j] * lcj;
        }
      }
#pragma unroll
      for (int c = 0; c < PANEL; ++c) {
        const float w = (c <= lane) ? a[c] : 0.0f;
        L11[lane * STRIDE + c] = w;
        if (rank == 0) A[(size_t)(s + lane) * N + s + c] = w;
      }
    }
    __syncthreads();

    // c. solve this thread's row: v <- v * L11^{-T}, written back
    if (solver) {
#pragma unroll
      for (int j = 0; j < PANEL; ++j) {
        float acc = v[j];
#pragma unroll
        for (int m = 0; m < j; ++m) acc -= v[m] * L11[j * STRIDE + m];
        v[j] = acc / L11[j * STRIDE + j];
      }
#pragma unroll
      for (int q = 0; q < PANEL / 4; ++q)
        *reinterpret_cast<float4*>(vrow + 4 * q) =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
    cluster.sync();

    // d. reload the solved sub-panel rows s+PANEL..N-1 into P
    const int M = R - PANEL;  // trailing size
    const int nq = M * (PANEL / 4);
    for (int base = tid; base < nq; base += LOADS * THREADS) {
      float4 t[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int e = base + u * THREADS;
        if (e < nq)
          t[u] = ld4(A + (size_t)(s + PANEL + e / (PANEL / 4)) * N + s +
                     4 * (e % (PANEL / 4)));
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int e = base + u * THREADS;
        if (e < nq) {
          float* d = P + (e / (PANEL / 4)) * STRIDE + 4 * (e % (PANEL / 4));
          d[0] = t[u].x; d[1] = t[u].y; d[2] = t[u].z; d[3] = t[u].w;
        }
      }
    }
    __syncthreads();

    // e. this block's tiles of the trailing update A22 -= P P^T
    const int t0 = s + PANEL;
    const int tx = tid & 15, ty = tid >> 4;
    const int nt = (M + UT - 1) / UT;
    int tile = 0;
    for (int bi = 0; bi < nt; ++bi) {
      for (int bj = 0; bj <= bi; ++bj, ++tile) {
        if (tile % csize != rank) continue;
        const int r0 = bi * UT + ty;
        const int c0 = bj * UT + tx;
        // the tile's current values, in flight during the FMA loop
        float cur[4][4], acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int r = r0 + 16 * a;
          const float* row = A + (size_t)(t0 + r) * N + t0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int c = c0 + 16 * b;
            cur[a][b] = (r < M && c <= r) ? __ldcg(row + c) : 0.0f;
            acc[a][b] = 0.0f;
          }
        }
#pragma unroll 4
        for (int m = 0; m < PANEL; ++m) {
          float pa[4], pb[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int r = r0 + 16 * a;
            pa[a] = (r < M) ? P[r * STRIDE + m] : 0.0f;
          }
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int c = c0 + 16 * b;
            pb[b] = (c < M) ? P[c * STRIDE + m] : 0.0f;
          }
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[a][b] += pa[a] * pb[b];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int r = r0 + 16 * a;
          if (r >= M) continue;
          float* row = A + (size_t)(t0 + r) * N + t0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int c = c0 + 16 * b;
            if (c <= r) row[c] = cur[a][b] - acc[a][b];
          }
        }
      }
    }
    cluster.sync();
  }
}

}  // namespace

extern "C" int dsm_fused_gram_cholesky(const void* x, const void* n,
                                       const void* logl, const void* logsigma,
                                       const void* noise, void* out, int L,
                                       int N, int D, float eps, void* stream) {
  if (L < 0 || N <= 0 || N % PANEL != 0 || N > MAX_N || D <= 0)
    return (int)cudaErrorInvalidValue;
  if (L == 0) return 0;
  // the gram's squared norms (N floats), then L11 and the sub-panel
  const size_t smem = (size_t)N * STRIDE * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_gram_cholesky_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = MAX_CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L * MAX_CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, fused_gram_cholesky_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (active < L) {
    attr.val.clusterDim.x = MIN_CLUSTER;
    cfg.gridDim = dim3(L * MIN_CLUSTER);
  }
  err = cudaLaunchKernelEx(
      &cfg, fused_gram_cholesky_kernel, static_cast<const float*>(x),
      static_cast<const int*>(n), static_cast<const float*>(logl),
      static_cast<const float*>(logsigma), static_cast<const float*>(noise),
      static_cast<float*>(out), N, D, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
