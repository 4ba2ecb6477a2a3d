// Device functions of the block-tridiagonal Cholesky and of the small
// Cholesky factor and solves, shared by the fused factorization
// (fused_factor.cu) and kkt.cu (chol, cho_solve, tridiag_factor,
// fused_chol_solve).
//
// For the SPD block-tridiagonal M with diagonal blocks D_k and couplings
// M[k-1, k] = O_{k-1}, step k of the factorization is
//   C_k = L_{k-1}^-1 O_{k-1}   forward substitution, column by column:
//                              C[a][c] = (O[a][c] - sum_{m<a, ascending}
//                              L[a][m] C[m][c]) / L[a][a]
//   S_k = D_k - C_k' C_k       lower triangle: S[a][c] = D[a][c] - sum_{t
//                              ascending} C[t][a] C[t][c]
//   L_k = chol(S_k)            warp_chol's order (below)
// Every matrix is n x n, row-major. warp_tri_step runs a step with its
// working set in registers of one warp and warp_chol_rows as its Cholesky
// (tridiag_factor's warp and the fused factorization's recurrence warp;
// the fused producers factor H_k with warp_chol_rows too). These orders
// are those of the first designs, which worked in shared memory; the
// kernels keep them, so their results stay those designs' bit for bit.

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

// In-place lower Cholesky of the n x n row-major block `a` in shared memory
// by the whole warp (lane li), left-looking, column by column; the upper
// triangle is not read. Returns true (on every lane) when a pivot is <= 0
// or NaN (LAPACK potrf's test, smallla.chol's); `a` then holds garbage. An
// infinite pivot factors on, as potrf's does: an infinite diagonal entry,
// zeros below it, and the rest the factor of the block without that row
// and column.
template <typename T>
__device__ bool warp_chol(T* a, int n, int li) {
  const unsigned full = 0xffffffffu;
  bool bad = false;  // warp-uniform: every lane tests the same pivot
  for (int j = 0; j < n; ++j) {
    // lane i >= j: s_i = A[i][j] - sum_{k<j} L[i][k] L[j][k]; columns < j of
    // the lower part of a already hold L
    T s = T(0);
    if (li >= j && li < n) {
      s = a[li * n + j];
      for (int k = 0; k < j; ++k) s -= a[li * n + k] * a[j * n + k];
    }
    const T piv = __shfl_sync(full, s, j);
    bad = bad || !(piv > T(0));
    const T d = sqrt(piv);
    // lane i only rewrites its own entry of column j, which no other lane
    // reads in this step
    if (li == j) {
      a[j * n + j] = d;
    } else if (li > j && li < n) {
      a[li * n + j] = s / d;
    }
    __syncwarp();
  }
  return bad;
}

// Copy the lower triangle of the n x n block `src` into `a` (coalesced).
template <typename T>
__device__ __forceinline__ void warp_load_lower(const T* src, T* a, int n,
                                                int li) {
  for (int t = li; t < n * n; t += 32) {
    const int r = t / n, c = t - r * n;
    if (c <= r) a[t] = src[t];
  }
}

// Write the factor in `a` to `dst` with zeros above the diagonal, or NaN
// everywhere when `bad`.
template <typename T>
__device__ __forceinline__ void warp_store_factor(const T* a, T* dst, int n,
                                                  bool bad, int li) {
  const T nan = quiet_nan<T>();
  for (int t = li; t < n * n; t += 32) {
    const int r = t / n, c = t - r * n;
    dst[t] = bad ? nan : (c <= r ? a[t] : T(0));
  }
}

// Lane li < m solves (l l') x = b for column li of the n x m row-major
// right-hand side; l (lower, in shared memory) is read by every lane alike.
template <typename T>
__device__ __forceinline__ void lane_cho_solve_col(const T* l, const T* Bb,
                                                   T* Xb, int n, int m,
                                                   int li) {
  T y[kMaxN];
  // forward: L y = b
  for (int r = 0; r < n; ++r) {
    T s = Bb[r * m + li];
    for (int k = 0; k < r; ++k) s -= l[r * n + k] * y[k];
    y[r] = s / l[r * n + r];
  }
  // backward: L' x = y
  for (int r = n - 1; r >= 0; --r) {
    T s = y[r];
    for (int k = r + 1; k < n; ++k) s -= l[k * n + r] * y[k];
    y[r] = s / l[r * n + r];
  }
  for (int r = 0; r < n; ++r) Xb[r * m + li] = y[r];
}

// Lower Cholesky factor of an n x n SPD matrix by one warp, n <= NMAX <= 32,
// lane a holding row a in registers (lanes >= n shadow row 0): right-
// looking, at column j lane j's pivot comes by one shuffle, each lane
// scales its own L[a][j], and L[c][j] comes from lane c by one shuffle
// per column c > j. Every value takes warp_chol's operations in its order.
// The code has no branch that depends on the lane: the lanes compute every
// entry and keep the ones on and below the diagonal by selects, so with n
// a compile-time constant the whole factor is straight-line code.
// Returns true on every lane when a pivot is <= 0 or NaN (warp_chol's
// test, smallla.chol's, LAPACK potrf's): an infinite pivot factors on, to
// an infinite diagonal entry and zeros below it, as potrf's does. On a
// breakdown `row` holds garbage; else, on return, row[b] = L[a][b] for
// b <= a.
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
// Every value takes the operations of the header's step and of warp_chol in
// their order (and so their rounding). Lp: L_{k-1} in shared memory
// (lower triangle and diagonal read, by every lane alike); Op: O_{k-1} and
// Dk: D_k, in shared memory. Out: C_k in sC (n x n) and L_k's lower triangle and
// diagonal in sL, which may be Lp (every read of Lp comes first); when a
// pivot is <= 0 or NaN (warp_chol_rows), sL holds NaN wherever written, so
// every later step of the lane comes out NaN too. Where C_dst and L_dst (device
// memory) are not null, C_k goes there too, and L_k with zeros above the
// diagonal, or NaN everywhere on a breakdown (warp_store_factor's form):
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
