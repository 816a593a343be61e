// Pieces shared by the two Cholesky kernels of the port
// (blocked_cholesky.cu, fused_gram_cholesky.cu): the 64 x 64 diagonal
// block factored and inverted by one block of 256 threads, and the
// 64 x 64 x 64 product of two row-major operand tiles in shared memory.
// Both sources include this header and are built separately, so each
// library has its own copy of these functions.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int NB = 64;               // width of a diagonal block
constexpr int SUB = 32;              // warp-factored sub-block of a diagonal block
constexpr int LDD = NB + 1;          // padded shared row stride of a diagonal block
constexpr int DIAG_THREADS = 256;    // threads of a block that factors one
constexpr int LDP = NB + 4;          // shared row stride of a product operand
static_assert(NB == 2 * SUB, "the diagonal block is a 2 x 2 split");
static_assert(LDP % 32 == 4, "float4 reads along k: 8 rows, 32 banks");

// ---------------------------------------------------------------- diagonal

// One warp, lane = row: the 32 x 32 block at D[p.., p..] factored in
// registers (its strict upper part written back as 0); the reciprocal
// diagonal goes to rd[p..]. Column j is broadcast through shared memory:
// every lane stores its element of the column, unscaled, into the
// column's own place in D and reads the others back (all lanes the same
// address); that measured 2.6 times faster than one shuffle per element.
// The rows below a pivot scale by one rsqrt instead of a square root and
// a division on the serial chain, and the update takes the unscaled
// column times rsqrt^2, so that it does not wait for the scaled one; the
// diagonal itself is the exact square root, off the chain, so that
// identity padding stays exactly 1. The updates are not predicated on the
// lower triangle: what a lane computes above its diagonal is never read
// by another lane and is dropped at the end. Not inlined, so that the
// second call finds the code in the instruction cache.
__device__ __noinline__ void warp_factor32(float* D, float* rd, int p, int lane) {
  float v[SUB];
  float dj = 1.0f;  // this lane's diagonal element
  float* row = D + (p + lane) * LDD + p;
#pragma unroll
  for (int c = 0; c < SUB; ++c) v[c] = row[c];
#pragma unroll
  for (int j = 0; j < SUB; ++j) {
    row[j] = v[j];
    __syncwarp();
    const float* col = D + p * LDD + p + j;  // col[c * LDD]: row c of column j
    const float pivot = col[j * LDD];
    float l[SUB];
#pragma unroll
    for (int c = j + 1; c < SUB; ++c) l[c] = col[c * LDD];
    const float rj = rsqrtf(pivot);
    if (lane == j) {
      dj = sqrtf(pivot);
      rd[p + j] = rj;
    }
    const float t = v[j] * (rj * rj);
    v[j] *= rj;
#pragma unroll
    for (int c = j + 1; c < SUB; ++c) v[c] -= t * l[c];
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < SUB; ++c) row[c] = c < lane ? v[c] : (c == lane ? dj : 0.0f);
}

// One thread: x = L^{-1} b for the 32 x 32 lower L at D[p.., p..] with the
// reciprocal diagonal rd[p..], by forward substitution. b[c] is
// scale * src[c * sstride], or column `unit` of the identity where src is
// null; x[j] goes to out[j * ostride]. Every lane of a warp reads the same
// element of L (a broadcast). Not inlined: four calls share the code.
__device__ __noinline__ void trsolve32(const float* D, const float* rd, int p,
                                       const float* src, int sstride, float scale,
                                       int unit, float* out, int ostride) {
  float b[SUB];
#pragma unroll
  for (int c = 0; c < SUB; ++c)
    b[c] = src ? scale * src[c * sstride] : (c == unit ? 1.0f : 0.0f);
#pragma unroll
  for (int j = 0; j < SUB; ++j) {
    const float x = b[j] * rd[p + j];
    out[j * ostride] = x;
    float l[SUB];  // the column's loads ahead of its FMAs
#pragma unroll
    for (int c = j + 1; c < SUB; ++c) l[c] = D[(p + c) * LDD + p + j];
#pragma unroll
    for (int c = j + 1; c < SUB; ++c) b[c] -= x * l[c];
  }
}

// Shared memory of a block that factors a diagonal block
struct DiagSmem {
  float D[NB * LDD];    // the block (lower triangle, identity padding), then its factor
  float Inv[NB * LDD];  // inv(L11)
  float Y[SUB * (SUB + 1)];
  float rd[NB];         // reciprocals of the factor's diagonal
};

// All 256 threads of a block: the 64 x 64 block in sm.D factored in place
// (strict upper part 0) and its inverse into sm.Inv. Starts and ends with
// a barrier.
__device__ __forceinline__ void diag_factor_inv(DiagSmem& sm, int tid) {
  float* D = sm.D;
  float* Inv = sm.Inv;
  float* Y = sm.Y;
  float* rd = sm.rd;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  __syncthreads();

  if (warp == 0) warp_factor32(D, rd, 0, lane);
  __syncthreads();

  if (warp == 0) {
    // L10 = D10 L00^{-T}: lane = row of D10, solved in place
    float* row = D + (SUB + lane) * LDD;
    trsolve32(D, rd, 0, row, 1, 1.0f, 0, row, 1);
  } else if (warp == 1) {
    // inv(L00): lane = column
    trsolve32(D, rd, 0, nullptr, 0, 1.0f, lane, Inv + lane, LDD);
  } else if (warp == 2) {
#pragma unroll
    for (int c = 0; c < SUB; ++c) Inv[c * LDD + SUB + lane] = 0.0f;
  }
  __syncthreads();

  // D11 -= L10 L10^T: column `lane` of rows warp, warp + 8, ... per thread
  {
    float acc[SUB / 8];
#pragma unroll
    for (int m = 0; m < SUB / 8; ++m) acc[m] = 0.0f;
    const float* xj = D + (SUB + lane) * LDD;
#pragma unroll 8
    for (int q = 0; q < SUB; ++q) {
      const float x = xj[q];
#pragma unroll
      for (int m = 0; m < SUB / 8; ++m) acc[m] += D[(SUB + warp + 8 * m) * LDD + q] * x;
    }
#pragma unroll
    for (int m = 0; m < SUB / 8; ++m)
      D[(SUB + warp + 8 * m) * LDD + SUB + lane] -= acc[m];
  }
  __syncthreads();

  if (warp == 0) {
    warp_factor32(D, rd, SUB, lane);
  } else if (warp >= 4) {
    // Y = L10 inv(L00), beside the factoring warp
    for (int e = tid - 128; e < SUB * SUB; e += 128) {
      const int r = e / SUB, c = e % SUB;
      const float* x = D + (SUB + r) * LDD;
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < SUB; ++q) acc += x[q] * Inv[q * LDD + c];
      Y[r * (SUB + 1) + c] = acc;
    }
  }
  __syncthreads();

  if (warp == 0) {
    // inv(L11): lane = column
    trsolve32(D, rd, SUB, nullptr, 0, 1.0f, lane, Inv + SUB * LDD + SUB + lane, LDD);
  } else if (warp == 1) {
    // the block below the diagonal of the inverse: -inv(L11) L10 inv(L00)
    trsolve32(D, rd, SUB, Y + lane, SUB + 1, -1.0f, 0, Inv + SUB * LDD + lane, LDD);
  }
  __syncthreads();
}

// The product of two 64 x 64 operand tiles in shared memory (row stride
// LDP), 256 threads in a 16 x 16 grid with 4 x 4 outputs each:
// acc[i][j] += sum_k P[(ty + 16 i)][k] Q[(tx + 16 j)][k] over 64 k
__device__ __forceinline__ void mma64(const float* P, const float* Q, int ty, int tx,
                                      float (&acc)[4][4]) {
#pragma unroll 4
  for (int k = 0; k < NB; k += 4) {
    float4 p[4], q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * LDP + k);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      q[j] = *reinterpret_cast<const float4*>(Q + (tx + 16 * j) * LDP + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] += p[i].x * q[j].x;
        acc[i][j] += p[i].y * q[j].y;
        acc[i][j] += p[i].z * q[j].z;
        acc[i][j] += p[i].w * q[j].w;
      }
  }
}

}  // namespace
