// Forward substitution of the cached predict's right-hand sides against
// lower-triangular factors, fused with the two moment reductions that
// follow it, for a whole table of leaves in one launch.
//
// Replaces no TPU kernel: the JAX package leaves this solve to XLA
// (deepstructuredmixtures_tpu/ops/cholesky.py `solve_lower`, a
// `solve_triangular`, in fit.py's streamed and cached predicts).
// The port solved it with cuBLAS's float64 `trsm`, one leaf chunk at a
// time, on a float64 copy of every float32 factor made at every request
// (fit._forward_solve until this kernel). That `trsm` ran at about 2
// TFLOP/s (65 right-hand sides on one large triangle is latency-bound),
// and the copy read 4 and wrote 8 bytes of every factor element.
//
// What it computes. For each leaf l of the table: the factor L (n x n,
// row-major, float32 or float64, lower triangle read, identity-padded
// rows allowed) and the right-hand side B = [y | K_nt] (n x W, row-major,
// the factor's type). Every element is turned into float64 in registers
// (exact), and in float64 throughout:
//   Z = L^{-1} B,  z = Z[:, 0],  V = Z[:, 1:],
//   s1[l, t] = sum_r V[r, t] z[r]   (the mean is m + s1),
//   s2[l, t] = sum_r V[r, t]^2      (the variance is k_tt - s2 + noise),
// and z itself where the caller asks for it. V is never written to device
// memory for the moments. A non-finite factor gives non-finite results
// (nothing is masked), as `trsm` does.
//
// What bounds it on an H100. Per leaf n^2 W / 2 multiply-adds on n^2 / 2
// float32 factor elements. The serving path's chunk (W = 65 over 144
// leaves, sum n^2 = 6.95e9) needs 0.45 TFLOP over the padded columns and
// 13.9 GB of factor reads: 6.7 ms at 67 TFLOP/s (float64 tensor cores,
// DMMA) against 4.1 ms at 3.35 TB/s, so operation-bound if the solutions
// re-read by the later row blocks stay in L2, byte-bound if they come
// from device memory (about twice the factor's bytes at W = 65).
//
// The design.
//   * Left-looking blocked substitution in row blocks of BR = 64 rows.
//     One thread block owns (leaf, row block i, column tile c): it streams
//     its row panel L[i, :i] as 64 x 64 factor tiles, with the solutions
//     X_j of the earlier row blocks of the same column tile, through a
//     two-stage cp.async ring in shared memory, and accumulates
//     sum_j L_ij X_j in float64 on the tensor cores (mma.sync m8n8k4 f64;
//     4 warps, 16 rows x CT columns each; a factor element is converted
//     from float32 when its fragment is loaded). Then it solves its 64 x
//     64 diagonal block against B_i minus that sum, blocked by 16 rows: a
//     16-row sub-block one column a thread (right-looking, the reciprocal
//     diagonal computed beforehand), the rows below it updated on the
//     tensor cores; it writes X_i to a float64 workspace and releases its
//     ready flag.
//   * Dependencies through ready flags in device memory: thread 0 reads
//     flag j with acquire before X_j is loaded (a poll while the block
//     still has a tile to compute, a wait with back-off when it has none),
//     and writes its own with release after every thread has fenced its
//     writes. No deadlock: a block takes a ticket from an atomic counter
//     when it starts, and the ticket names its (leaf, row block, column
//     tile) in an order where every producer comes first, so the producers
//     of a waiting block have started, and the one with the lowest
//     unfinished ticket waits for nothing.
//   * The order is row block major across the leaves (all leaves' block
//     0, then all leaves' block 1, ...), so that a block's predecessor was
//     issued one round before it and most of its panel is computed while
//     that predecessor finishes. The serial chain is one diagonal step per
//     row block (254 for the 16,232-point leaf), and one launch over every
//     leaf overlaps the chains of all of them. On one leaf alone the chain
//     is what a call takes: about 15-21 us a step on an H100 (the hand-off
//     2.3, the last tile 5-6, the diagonal step 6-8, the stores and the
//     fence 2), in which every resident block of the leaf works on the
//     same tile beside the chain's own; taking inv(L_ii) off the chain
//     made the hand-off longer by as much (PERF.md).
//   * Column tiles of CT = 72 columns, as many as the width needs
//     (ops/trsm.py `column_tiles`): every tile carries y as its column 0
//     (solved again in each tile, the same arithmetic, so that z is at
//     hand without a dependency between tiles) and up to 71 columns of
//     K_nt, spread evenly over the tiles. 72 columns let two blocks share
//     a multiprocessor in float32 (110 KB of shared memory each), and hold
//     the serving path's 65 in one tile and the streamed pass's 321 in
//     five.
//   * Fused moments, deterministic: each block writes its 64 rows' partial
//     sums of V z and V^2 per column; the block of the last row block of a
//     (leaf, tile) has acquired every earlier flag, so it adds the
//     partials in row block order and writes s1 and s2. No atomics on the
//     sums: the same inputs give the same bits.
//   * Padding: identity-padded rows with zero right-hand sides solve to
//     exact zeros, so they need no special case; rows past n (the last row
//     block's ragged edge) are zero-filled on load and solved as identity.
//   * Factor rows are copied 16 bytes at a time: n times the element size
//     is a multiple of 16 and the factor 16-byte aligned (every bucket's
//     nmax is a multiple of 8; ops/trsm.py checks it).
//
// Plain C interface for ctypes (built with nvcc -shared, no PyTorch
// headers): dsm_trsm_moments zeroes the flags and the ticket counter with
// cudaMemsetAsync and launches one kernel on the given stream; it returns
// cudaGetLastError() (0 on success). It allocates no device memory: the
// leaf table, the ticket order, the workspace, the partial sums, the
// flags and the outputs come from the caller.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BR = 64;           // rows of a row block and of a diagonal block
constexpr int CT = 72;           // columns of a column tile
constexpr int THREADS = 128;     // 4 warps, 16 rows of the block each
constexpr int LDL = BR + 4;      // shared row stride of a factor tile: conflict-free
                                 // fragment loads (8 rows x 4 columns a warp)
// the four 16 x 16 diagonal sub-blocks of a diagonal block, transposed, in
// float64
constexpr int DT_BYTES = 4 * 16 * 16 * 8;

// One row of the leaf table (int64 fields, written by ops/trsm.py).
struct Leaf {
  const void* lf;   // the factor, n x n
  const void* rhs;  // the right-hand side, n x W
  long long n;
  long long ws;     // offset of its workspace (doubles): [tiles][nb * BR][CT]
  long long flags;  // offset of its ready flags: [tiles][nb]
  long long part;   // offset of its partial sums (doubles): [tiles][nb][2][CT]
  double* z;        // z out (n doubles), or null
  long long row;    // its row in s1 and s2
};

struct Params {
  const Leaf* leaves;
  const long long* order;  // per ticket: leaf << 32 | row block << 16 | tile
  int W;                   // columns of the right-hand side: 1 + T
  int T;                   // columns of s1 and s2
  int tc;                  // columns of K_nt a tile
  double* ws;
  double* part;
  int* flags;
  unsigned* ticket;
  double* s1;
  double* s2;
};

// ------------------------------------------------------------ primitives

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, through L2 only (the workspace is written by other
// multiprocessors); src_bytes 0 fills zeros
__device__ __forceinline__ void cp16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

template <typename T>
__device__ __forceinline__ void cp_elem(T* dst, const T* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(smem_addr(dst)), "l"(src), "n"(sizeof(T)),
                  "r"(ok ? (int)sizeof(T) : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" :: "l"(p), "r"(v) : "memory");
}

// A flag that stays unset for about 20 s at the card's clocks is a fault
// of the table or the order, not a slow producer: the kernel stops with an
// error instead of hanging the device.
constexpr long long WAIT_LIMIT = 1LL << 35;

__device__ __forceinline__ void wait_flag(const int* p) {
  const long long t0 = clock64();
  while (ld_acquire(p) == 0) {
    __nanosleep(32);
    if (clock64() - t0 > WAIT_LIMIT) __trap();
  }
}

// d += a b on the float64 tensor cores: A 8 x 4 (row = lane / 4, k =
// lane % 4), B 4 x 8 (k = lane % 4, column = lane / 4), D 8 x 8 (row =
// lane / 4, columns 2 (lane % 4) + {0, 1})
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d[0]), "+d"(d[1]) : "d"(a), "d"(b));
}

// --------------------------------------------------------------- loads

// The factor tile L[r0:r0+64, k0:k0+64] into dst (stride LDL), 16 bytes a
// copy; what lies past row or column n is zero.
template <typename T>
__device__ __forceinline__ void load_factor(T* dst, const T* L, int n, int r0, int k0,
                                            int tid) {
  constexpr int E = 16 / sizeof(T);  // elements a copy
  constexpr int PER_ROW = BR / E;
#pragma unroll 4
  for (int q = tid; q < BR * PER_ROW; q += THREADS) {
    const int r = q / PER_ROW, k = (q % PER_ROW) * E;
    const bool ok = r0 + r < n && k0 + k < n;
    cp16(dst + r * LDL + k, ok ? L + (long long)(r0 + r) * n + k0 + k : L, ok ? 16 : 0);
  }
}

// The workspace rows j*64 .. j*64+63 of a tile (contiguous, CT doubles a
// row) into dst (stride CT + 4)
__device__ __forceinline__ void load_solution(double* dst, const double* X, int tid) {
  constexpr int PER_ROW = CT / 2;
#pragma unroll 4
  for (int q = tid; q < BR * PER_ROW; q += THREADS) {
    const int r = q / PER_ROW, k = (q % PER_ROW) * 2;
    cp16(dst + r * (CT + 4) + k, X + r * CT + k, 16);
  }
}

// The right-hand side rows r0.. of tile c into dst (T, stride CT): column
// 0 is y, columns 1..tc are K_nt's columns c*tc .. c*tc+tc-1; the rest,
// and rows past n, are zero.
template <typename T>
__device__ __forceinline__ void load_rhs(T* dst, const T* B, int n, int W, int r0, int c,
                                         int tc, int tid) {
#pragma unroll 4
  for (int q = tid; q < BR * CT; q += THREADS) {
    const int r = q / CT, t = q % CT;
    const int col = t == 0 ? 0 : c * tc + t;
    const bool ok = r0 + r < n && (t == 0 || (t <= tc && col < W));
    cp_elem(dst + q, ok ? B + (long long)(r0 + r) * W + col : B, ok);
  }
}

// ------------------------------------------------------------ compute

// acc += A B on the tensor cores, for one warp's 16 rows: A is KSTEPS * 4
// columns of rows a_row[0] (this lane's row and column) and a_row[8 * LDL]
// (the second 8-row fragment), stride LDL, converted to float64 as loaded;
// B is b_col[0] at this lane's row and column of a row-major float64 tile
// of stride ldb, CT columns.
template <typename T, int KSTEPS>
__device__ __forceinline__ void mma_rows(double (&acc)[2][CT / 8][2], const T* a_row,
                                         const double* b_col, int ldb) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const double a0 = static_cast<double>(a_row[4 * kk]);
    const double a1 = static_cast<double>(a_row[8 * LDL + 4 * kk]);
#pragma unroll
    for (int nt = 0; nt < CT / 8; ++nt) {
      const double b = b_col[4 * kk * ldb + 8 * nt];
      dmma(acc[0][nt], a0, b);
      dmma(acc[1][nt], a1, b);
    }
  }
}

// acc += L_ij X_j over one 64 x 64 factor tile: warp w owns rows 16 w ..
// 16 w + 15 (two 8-row fragments) and all CT columns.
template <typename T>
__device__ __forceinline__ void update(double (&acc)[2][CT / 8][2], const T* Ls,
                                       const double* Xs, int warp, int lane) {
  mma_rows<T, BR / 4>(acc, Ls + (warp * 16 + (lane >> 2)) * LDL + (lane & 3),
                      Xs + (lane & 3) * (CT + 4) + (lane >> 2), CT + 4);
}

// One column of a 16-row diagonal sub-block: x = D^{-1} x in place on the
// column (stride ldx); Dt holds D transposed (Dt[k * SUBROWS + r] = D[r][k])
// with the reciprocal diagonal in its diagonal. Right-looking: each solved
// element updates the rest at once.
constexpr int SUBROWS = 16;
__device__ __forceinline__ void solve_sub(double* col, int ldx, const double* Dt) {
  double x[SUBROWS];
#pragma unroll
  for (int r = 0; r < SUBROWS; ++r) x[r] = col[r * ldx];
#pragma unroll
  for (int r = 0; r < SUBROWS; ++r) {
    const double* dc = Dt + r * SUBROWS;
    x[r] *= dc[r];
#pragma unroll
    for (int q = r + 1; q < SUBROWS; ++q) x[q] = fma(-dc[q], x[r], x[q]);
  }
#pragma unroll
  for (int r = 0; r < SUBROWS; ++r) col[r * ldx] = x[r];
}

template <typename T>
struct Layout {
  static constexpr int LDX = CT + 4;
  static constexpr int L_BYTES = BR * LDL * sizeof(T);
  static constexpr int X_BYTES = BR * LDX * 8;
  // a stage: a factor tile and a solution tile; in the epilogue one stage
  // holds the diagonal block, the right-hand side and then the residual,
  // the other the diagonal sub-blocks in float64
  static constexpr int STAGE = L_BYTES + X_BYTES;
  static_assert(STAGE >= DT_BYTES, "the sub-blocks fit a stage");
  static constexpr int SMEM = 2 * STAGE;
  static_assert(CT % 8 == 0, "column tiles are whole 8-column fragments");
  static_assert(L_BYTES % 16 == 0 && STAGE % 16 == 0, "16-byte aligned stages");
  static_assert(LDX % 16 == 4 || LDX % 16 == 12, "conflict-free B fragments");
};

template <typename T>
__global__ void __launch_bounds__(THREADS) fused_trsm_moments_kernel(Params p) {
  using Lay = Layout<T>;
  constexpr int LDX = Lay::LDX;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned s_ticket;
  __shared__ int s_ready;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) s_ticket = atomicAdd(p.ticket, 1u);
  __syncthreads();
  const long long code = p.order[s_ticket];
  const int li = static_cast<int>(code >> 32);
  const int i = static_cast<int>((code >> 16) & 0xffff);
  const int c = static_cast<int>(code & 0xffff);
  const Leaf leaf = p.leaves[li];
  const int n = static_cast<int>(leaf.n);
  const int nb = (n + BR - 1) / BR;
  const int r0 = i * BR;
  const T* L = static_cast<const T*>(leaf.lf);
  const T* B = static_cast<const T*>(leaf.rhs);
  double* X = p.ws + leaf.ws + (long long)c * nb * BR * CT;
  int* flag = p.flags + leaf.flags + c * nb;

  auto stage_l = [&](int s) { return reinterpret_cast<T*>(smem + s * Lay::STAGE); };
  auto stage_x = [&](int s) {
    return reinterpret_cast<double*>(smem + s * Lay::STAGE + Lay::L_BYTES);
  };

  double acc[2][CT / 8][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < CT / 8; ++nt) acc[m][nt][0] = acc[m][nt][1] = 0.0;

  // the stage that takes the diagonal block and the right-hand side
  const int P = i & 1;
  if (i == 0) {
    load_factor(stage_l(P), L, n, r0, r0, tid);
    load_rhs<T>(reinterpret_cast<T*>(stage_x(P)), B, n, p.W, r0, c, p.tc, tid);
    cp_commit();
  } else {
    if (tid == 0) wait_flag(flag);
    __syncthreads();
    load_factor(stage_l(0), L, n, r0, 0, tid);
    load_solution(stage_x(0), X, tid);
    cp_commit();
    for (int j = 0; j < i; ++j) {
      const int s = j & 1;
      const bool more = j + 1 < i;
      if (tid == 0) s_ready = more ? ld_acquire(flag + j + 1) : 0;
      cp_wait_all();
      __syncthreads();  // tile j has landed; stage s ^ 1 is free
      const bool issued = more && s_ready != 0;
      if (issued) {
        load_factor(stage_l(s ^ 1), L, n, r0, (j + 1) * BR, tid);
        load_solution(stage_x(s ^ 1), X + (long long)(j + 1) * BR * CT, tid);
        cp_commit();
      } else if (!more) {  // the last tile: the diagonal block comes behind it
        load_factor(stage_l(P), L, n, r0, r0, tid);
        load_rhs<T>(reinterpret_cast<T*>(stage_x(P)), B, n, p.W, r0, c, p.tc, tid);
        cp_commit();
      }
      update<T>(acc, stage_l(s), stage_x(s), warp, lane);
      __syncthreads();  // stage s is read
      if (more && !issued) {
        if (tid == 0) wait_flag(flag + j + 1);
        __syncthreads();
        load_factor(stage_l(s ^ 1), L, n, r0, (j + 1) * BR, tid);
        load_solution(stage_x(s ^ 1), X + (long long)(j + 1) * BR * CT, tid);
        cp_commit();
      }
    }
  }
  cp_wait_all();
  __syncthreads();

  // the epilogue: stage P holds L_ii (rows past n zero) and B_i; the
  // other stage takes the four 16 x 16 diagonal sub-blocks of L_ii
  // transposed in float64, identity past n, with the reciprocal diagonal
  const T* Lraw = stage_l(P);
  const T* Braw = reinterpret_cast<const T*>(stage_x(P));
  double* Dt = reinterpret_cast<double*>(smem + (P ^ 1) * Lay::STAGE);
  for (int q = tid; q < 4 * SUBROWS * SUBROWS; q += THREADS) {
    const int sb = q / (SUBROWS * SUBROWS), r = (q / SUBROWS) % SUBROWS, k = q % SUBROWS;
    const int row = sb * SUBROWS + r;
    double v = 0.0;
    if (k <= r)
      v = r0 + row < n ? static_cast<double>(Lraw[row * LDL + sb * SUBROWS + k]) : (k == r ? 1.0 : 0.0);
    if (k == r) v = 1.0 / v;
    Dt[(sb * SUBROWS + k) * SUBROWS + r] = v;
  }
  // the residual B_i - sum_j L_ij X_j, in the fragments' places
  const int fr = warp * 16 + (lane >> 2), fc = 2 * (lane & 3);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < CT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        acc[m][nt][e] = static_cast<double>(Braw[(fr + 8 * m) * CT + 8 * nt + fc + e]) -
                        acc[m][nt][e];
  __syncthreads();  // B_i is read: the residual goes over it
  double* R = stage_x(P);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < CT / 8; ++nt)
      *reinterpret_cast<double2*>(R + (fr + 8 * m) * LDX + 8 * nt + fc) =
          make_double2(acc[m][nt][0], acc[m][nt][1]);
  __syncthreads();
  // the diagonal step, blocked by 16 rows: a sub-block's rows solved one
  // column a thread, then the rows below it updated on the tensor cores by
  // the warps that own them (warp w owns the sub-block w)
  for (int sb = 0; sb < 4; ++sb) {
    if (tid < CT) solve_sub(R + sb * SUBROWS * LDX + tid, LDX, Dt + sb * SUBROWS * SUBROWS);
    __syncthreads();
    if (sb < 3) {
      if (warp > sb) {
        double* strip = R + fr * LDX + fc;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int nt = 0; nt < CT / 8; ++nt) {
            const double2 v = *reinterpret_cast<const double2*>(strip + 8 * m * LDX + 8 * nt);
            acc[m][nt][0] = -v.x;
            acc[m][nt][1] = -v.y;
          }
        mma_rows<T, SUBROWS / 4>(acc, Lraw + fr * LDL + sb * SUBROWS + (lane & 3),
                                 R + (sb * SUBROWS + (lane & 3)) * LDX + (lane >> 2), LDX);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int nt = 0; nt < CT / 8; ++nt)
            *reinterpret_cast<double2*>(strip + 8 * m * LDX + 8 * nt) =
                make_double2(-acc[m][nt][0], -acc[m][nt][1]);
      }
      __syncthreads();
    }
  }

  // X_i to the workspace for the later row blocks, z, and the partial sums
  for (int q = tid; q < BR * CT; q += THREADS) {
    const int r = q / CT, t = q % CT;
    X[(long long)(r0 + r) * CT + t] = R[r * LDX + t];
  }
  if (c == 0 && leaf.z != nullptr && tid < BR && r0 + tid < n) leaf.z[r0 + tid] = R[tid * LDX];
  double* part = p.part + leaf.part + (long long)(c * nb + i) * 2 * CT;
  if (tid < CT) {
    double vz = 0.0, vv = 0.0;
#pragma unroll 8
    for (int r = 0; r < BR; ++r) {
      const double v = R[r * LDX + tid];
      vz = fma(v, R[r * LDX], vz);
      vv = fma(v, v, vv);
    }
    part[tid] = vz;
    part[CT + tid] = vv;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) st_release(flag + i, 1);

  // the last row block of the tile adds the partial sums in row block
  // order: it has acquired every earlier flag
  if (i == nb - 1 && tid >= 1 && tid <= p.tc && c * p.tc + tid <= p.T) {
    const double* base = p.part + leaf.part + (long long)c * nb * 2 * CT + tid;
    double vz = 0.0, vv = 0.0;
    for (int j = 0; j < nb; ++j) {
      vz += __ldcg(base + (long long)j * 2 * CT);
      vv += __ldcg(base + (long long)j * 2 * CT + CT);
    }
    const long long o = leaf.row * p.T + c * p.tc + tid - 1;
    p.s1[o] = vz;
    p.s2[o] = vv;
  }
}

template <typename T>
cudaError_t launch(const Params& p, int n_blocks, cudaStream_t stream) {
  constexpr int smem = Layout<T>::SMEM;
  auto* k = fused_trsm_moments_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k<<<n_blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// leaves: n_leaves x 8 int64 (struct Leaf); order: n_blocks int64; flags:
// 1 + n_flags ints (the ticket counter first), zeroed here; dtype 0 =
// float32, 1 = float64; tc at most CT - 1.
extern "C" int dsm_trsm_moments(const void* leaves, const void* order, int n_blocks,
                                int dtype, int W, int T, int tc, void* ws,
                                void* part, void* flags, long long n_flags, void* s1,
                                void* s2, void* stream) {
  if (n_blocks < 0 || W < 1 || T < 0 || tc < 0 || tc >= CT || n_flags < 0)
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(flags, 0, (size_t)(n_flags + 1) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.leaves = static_cast<const Leaf*>(leaves);
  p.order = static_cast<const long long*>(order);
  p.W = W;
  p.T = T;
  p.tc = tc;
  p.ws = static_cast<double*>(ws);
  p.part = static_cast<double*>(part);
  p.ticket = static_cast<unsigned*>(flags);
  p.flags = static_cast<int*>(flags) + 1;
  p.s1 = static_cast<double*>(s1);
  p.s2 = static_cast<double*>(s2);
  if (dtype == 0) return (int)launch<float>(p, n_blocks, s);
  if (dtype == 1) return (int)launch<double>(p, n_blocks, s);
  return (int)cudaErrorInvalidValue;
}
