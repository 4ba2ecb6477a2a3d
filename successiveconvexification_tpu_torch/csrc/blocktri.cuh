// Device functions of the block-tridiagonal Cholesky and of the small
// Cholesky factor, shared by the fused factorization (fused_factor.cu) and
// kkt.cu (tridiag_factor; chol and fused_chol_solve factor with kkt.cu's
// lean form of warp_chol_rows, warp_chol_lower).
//
// For the SPD block-tridiagonal M with diagonal blocks D_k and couplings
// M[k-1, k] = O_{k-1}, step k of the factorization is
//   C_k = L_{k-1}^-1 O_{k-1}   forward substitution, column by column:
//                              C[a][c] = (O[a][c] - sum_{m<a, ascending}
//                              L[a][m] C[m][c]) / L[a][a]
//   S_k = D_k - C_k' C_k       lower triangle: S[a][c] = D[a][c] - sum_{t
//                              ascending} C[t][a] C[t][c]
//   L_k = chol(S_k)            left-looking sums: L[a][j] = (S[a][j] -
//                              sum_{k<j, ascending} L[a][k] L[j][k]) / d_j,
//                              a true division by d_j = sqrt(the pivot
//                              S[j][j] - sum_{k<j} L[j][k]^2)
// Every matrix is n x n, row-major. warp_tri_step runs a step with its
// working set in registers of one warp and warp_chol_rows as its Cholesky
// (tridiag_factor's warp and the fused factorization's recurrence warp;
// the fused producers factor H_k with warp_chol_rows too, and the chol
// kernels with its lean form). These orders are those of the first
// designs, which worked in shared memory one column at a time; the kernels
// keep them, so their results stay those designs' bit for bit.

#pragma once

#include <cuda_runtime.h>

constexpr int kMaxN = 32;

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// Lower Cholesky factor of an n x n SPD matrix by one warp, n <= NMAX <= 32,
// lane a holding row a in registers (lanes >= n shadow row 0): right-
// looking, at column j lane j's pivot comes by one shuffle, each lane
// scales its own L[a][j], and L[c][j] comes from lane c by one shuffle
// per column c > j. Every value takes the header's operations in their
// order: L[a][c] starts from S[a][c] and loses L[a][j] L[c][j] at each
// column j < c, ascending, as the left-looking sum does, and the division
// is a true one by sqrt of the pivot. The code has no branch that depends
// on the lane: the lanes compute every entry and keep the ones on and
// below the diagonal by selects, so with n a compile-time constant the
// whole factor is straight-line code. A lane's entries above the diagonal
// are divided too and thrown away; a zero among them, as any zero
// dividend, takes the division's slow path (kkt.cu's lean form of this
// factor, warp_chol_lower, avoids it).
// Returns true on every lane when a pivot is <= 0 or NaN (smallla.chol's
// test, LAPACK potrf's): an infinite pivot factors on, to an infinite
// diagonal entry and zeros below it, as potrf's does. On a breakdown `row`
// holds garbage; else, on return, row[b] = L[a][b] for b <= a.
template <typename T, int NMAX>
__device__ __forceinline__ bool warp_chol_rows(T (&row)[NMAX], int n,
                                               int li) {
  static_assert(NMAX >= 1 && NMAX <= kMaxN, "one lane a row");
  const unsigned full = 0xffffffffu;
  const int lc = li < n ? li : 0;
  bool bad = false;  // warp-uniform: every lane tests the same pivot
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    if (j < n) {
      const T piv = __shfl_sync(full, row[j], j);
      bad = bad || !(piv > T(0));
      const T d = sqrt(piv);
      const T q = row[j] / d;
      row[j] = lc == j ? d : (lc > j ? q : row[j]);
      const T lj = row[j];  // L[lc][j] where lc >= j
#pragma unroll
      for (int c = j + 1; c < NMAX; ++c) {
        if (c < n) {
          const T lcj = __shfl_sync(full, lj, c);  // L[c][j]
          const T upd = row[c] - lj * lcj;
          row[c] = lc >= c ? upd : row[c];
        }
      }
    }
  }
  return bad;
}

// One step of the block-tridiagonal Cholesky by one warp, n <= NMAX <= 32,
// with the step's working set in registers: lane c owns column c of C_k,
// then lane a row a of S_k and of L_k.
//   C_k = L_{k-1}^-1 O_{k-1}     (Op == nullptr: C_k = 0)
//   S_k = D_k - C_k' C_k         (Dk: D_k, lower triangle read)
//   L_k = chol(S_k)              (warp_chol_rows)
// Every value takes the operations of the header's step in their order
// (and so their rounding). Lp: L_{k-1} in shared memory
// (lower triangle and diagonal read, by every lane alike); Op: O_{k-1} and
// Dk: D_k, in shared memory. Out: C_k in sC (n x n) and L_k's lower triangle and
// diagonal in sL, which may be Lp (every read of Lp comes first); when a
// pivot is <= 0 or NaN (warp_chol_rows), sL holds NaN wherever written, so
// every later step of the lane comes out NaN too. Where C_dst and L_dst (device
// memory) are not null, C_k goes there too, and L_k with zeros above the
// diagonal, or NaN everywhere on a breakdown (the chol kernel's form):
// each lane stores its own column or row as soon as it has it. Returns the
// breakdown flag, the same on every lane. The warp syncs on entry and
// before it returns.
// With n a compile-time constant (the caller's template dispatch) the step
// is straight-line code: no guard splits it into blocks, so the loads and
// shuffles of a phase issue back to back instead of one latency each.
template <typename T, int NMAX>
__device__ __forceinline__ bool warp_tri_step(const T* Lp, const T* Op,
                                              const T* Dk, T* sC, T* sL, int n,
                                              int li, T* C_dst, T* L_dst) {
  static_assert(NMAX >= 1 && NMAX <= kMaxN, "one lane a row");
  const int lc = li < n ? li : 0;  // lanes >= n shadow lane 0, write nothing
  __syncwarp();
  T cc[NMAX];  // column lc of C_k
#pragma unroll
  for (int a = 0; a < NMAX; ++a) cc[a] = T(0);
  if (Op != nullptr) {
#pragma unroll
    for (int a = 0; a < NMAX; ++a) {
      if (a < n) {
        T s = Op[a * n + lc];
#pragma unroll
        for (int m = 0; m < a; ++m) s -= Lp[a * n + m] * cc[m];
        cc[a] = s / Lp[a * n + a];
      }
    }
  }
  if (li < n) {
#pragma unroll
    for (int a = 0; a < NMAX; ++a) {
      if (a < n) {
        sC[a * n + li] = cc[a];
        if (C_dst != nullptr) C_dst[a * n + li] = cc[a];
      }
    }
  }
  __syncwarp();
  T srow[NMAX];  // row lc of S_k (entries above the diagonal unused)
#pragma unroll
  for (int b = 0; b < NMAX; ++b) {
    T acc = T(0);
    if (b < n) {
      acc = Dk[lc * n + (b <= lc ? b : lc)];
#pragma unroll
      for (int t = 0; t < NMAX; ++t)
        if (t < n) acc -= cc[t] * sC[t * n + b];
    }
    srow[b] = acc;
  }
  const bool bad = warp_chol_rows<T, NMAX>(srow, n, li);
  if (li < n) {
    const T nan = quiet_nan<T>();
#pragma unroll
    for (int b = 0; b < NMAX; ++b) {
      if (b < n) {
        const T l = bad ? nan : (b <= li ? srow[b] : T(0));
        if (b <= li) sL[li * n + b] = l;
        if (L_dst != nullptr) L_dst[li * n + b] = l;
      }
    }
  }
  __syncwarp();
  return bad;
}
