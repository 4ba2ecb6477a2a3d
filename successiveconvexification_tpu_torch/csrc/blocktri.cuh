// Device functions of the block-tridiagonal Cholesky step, shared by the
// fused factorization (fused_factor.cu, one thread block per lane) and the
// standalone factor kernel (kkt.cu tridiag_factor, one warp per lane).
//
// For the SPD block-tridiagonal M with diagonal blocks D_k and couplings
// M[k-1, k] = O_{k-1}, step k of the factorization is
//   C_k = L_{k-1}^-1 O_{k-1}          (tri_coupling)
//   S_k = D_k - C_k' C_k              (tri_schur, lower triangle)
//   L_k = chol(S_k)                   (the caller's Cholesky)
// Every matrix is n x n, row-major. The caller's threads split the work:
// thread tid of nt owns columns tid, tid + nt, ... of C and entries tid,
// tid + nt, ... of S; the caller synchronizes between the calls.

#pragma once

// C = L^-1 O by forward substitution, one column per thread. L lower
// triangular (its upper triangle is not read); O and C must not alias.
template <typename T>
__device__ __forceinline__ void tri_coupling(const T* Lp, const T* O, T* C,
                                             int n, int tid, int nt) {
  for (int c = tid; c < n; c += nt) {
    for (int a = 0; a < n; ++a) {
      T s = O[a * n + c];
      for (int m = 0; m < a; ++m) s -= Lp[a * n + m] * C[m * n + c];
      C[a * n + c] = s / Lp[a * n + a];
    }
  }
}

// The lower triangle of S = D - C' C; only D's lower triangle is read.
template <typename T>
__device__ __forceinline__ void tri_schur(const T* D, const T* C, T* S, int n,
                                          int tid, int nt) {
  for (int i = tid; i < n * n; i += nt) {
    const int a = i / n, c = i % n;
    if (c > a) continue;
    T acc = D[i];
    for (int t = 0; t < n; ++t) acc -= C[t * n + a] * C[t * n + c];
    S[i] = acc;
  }
}
