// Block factorizations and solves of the structured KKT system, written for
// Hopper (sm_90a).
//
// Six kernels with a plain C interface (loaded with ctypes by
// ops/cuda_kkt.py). Every entry point launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError().
//
// ---------------------------------------------------------------------------
// cho_solve_vec: (L L') x = b for N independent n x n blocks.
//   Replaces the TPU kernel successiveconvexification_tpu/ops/pallas_kkt.py
//   _cho_solve_kernel as launched by cho_solve_vec (the stage-Hessian solves
//   of ipm._H_solve, n = nw = 17, N = B*K = 12,800 at the main path).
//   Bound on the H100: bytes. Each block is read once (n*n + n values in,
//   n out) and does ~2 n^2 flops, about 0.25 flop per byte in float32.
//   Design: one thread per block, forward and backward substitution in
//   registers/local memory; the ragged edge is a bounds check, where the TPU
//   padded the batch with identity blocks. Simple first: neighbouring
//   threads read addresses n*n apart, so the loads are not coalesced.
//
// ---------------------------------------------------------------------------
// tridiag_solve: M u = r for a block-tridiagonal SPD M given its block
//   Cholesky factors (L_k lower, C_k = L_{k-1}^{-1} O_{k-1}, C_0 = 0):
//     forward   L_k v_k   = r_k - C_k' v_{k-1}
//     backward  L_k' u_k  = v_k - C_{k+1} u_{k+1}
//   Replaces pallas_kkt.py _tridiag_solve_fwd_kernel and
//   _tridiag_solve_bwd_kernel (two launches plus an XLA-built shifted copy
//   of C on the TPU). Bound on the H100: bytes (every L and C block read
//   once, ~6 n^2 flops per block), and in practice the latency of the
//   sequential sweep along N.
//   Design: ONE launch does both sweeps. One warp per scenario lane; lane
//   i of the warp owns row i (n <= 32). The triangular solves broadcast
//   each solved entry with __shfl_sync. v stays in shared memory between
//   the sweeps and is overwritten by u, so no intermediate goes through
//   device memory.
//
// ---------------------------------------------------------------------------
// chol: lower Cholesky factor of N independent n x n SPD blocks.
//   Replaces pallas_kkt.py _chol_kernel (pallas_kkt.chol: the stage-Hessian
//   factor of the unfused factorize, ipm.py:208; n = nw = 17, N = K = 50 on
//   the single-lane replan path). Bound on the H100: bytes (the lower
//   triangle in, n^2 values out, n^3/3 flops a block); at the
//   replan shapes launch latency sets its time.
//   Design: one warp per block, several warps per CTA, the ragged edge a
//   bounds check (the TPU padded with identity blocks). The warp copies the
//   block's lower triangle into shared memory with consecutive lanes on
//   consecutive addresses and factors it column by column in place
//   (left-looking):
//   lane i forms s_i = A[i][j] - sum_k L[i][k] L[j][k] for its row, the
//   pivot s_j comes from lane j by a shuffle, and lane i writes
//   L[i][j] = s_i / sqrt(s_j); one __syncwarp per column. The block goes
//   back with zeros above the diagonal, again coalesced. Breakdown follows
//   ops/smallla.py chol: a block with any pivot <= 0 or non-finite comes
//   out ENTIRELY NaN (the IPM masks lanes by finiteness, so a block that is
//   finite in part would be wrong). Every non-finite entry of L feeds the
//   pivot of its row, so the pivot test also catches non-finite inputs in
//   the lower triangle; the upper triangle is never read (as cholesky_ex).
//
// ---------------------------------------------------------------------------
// cho_solve: (L L') X = B for N independent blocks, B and X n x m (m <= 32).
//   Replaces pallas_kkt.py _cho_solve_kernel as launched by cho_solve (the
//   matrix right-hand sides H^-1 E', H^-1 F' of the unfused factorize,
//   ipm.py:209-210; n = 17, m = 13, N = K-1 = 49 on the replan path).
//   Bound on the H100: bytes (L's lower triangle and B read once, X written
//   once, 2 n^2 m flops a block).
//   Design: one warp per block; L is copied into shared memory once per
//   block and lane c owns column c of the right-hand side, running its own
//   forward and backward substitution with no shuffles (every lane reads the
//   same L entry: a shared-memory broadcast). Row i of B and of X is m
//   consecutive values, so the lanes' reads and writes are coalesced. B must
//   be row-major (N, n, m): the wrapper materializes a transposed view
//   (E' of the port's E) with .contiguous() rather than folding the
//   transpose into the indexing, which would put the lanes n values apart.
//
// ---------------------------------------------------------------------------
// tridiag_factor: block Cholesky of B SPD block-tridiagonal systems, each
//   with N diagonal blocks D_k and couplings M[k, k+1] = O_k (n x n):
//     C_k = L_{k-1}^-1 O_{k-1}  (C_0 = 0),  L_k = chol(D_k - C_k' C_k).
//   Replaces pallas_kkt.py _tridiag_factor_kernel (pallas_kkt.tridiag_factor
//   under vmap: the Schur system of the unfused `scan` factorization,
//   ipm.py:243-244, which runs when the subproblem has rank-one quadratic
//   rows; N = K-1 = 49, n = 13 at B = 256 on the penalized path). Bound on
//   the H100: bytes (D's lower triangle and O read once, L and C written
//   once, about 2.3 n^3 flops a block). The steps along N are sequential.
//   Design: one warp per lane walks k = 0..N-1, keeping L_{k-1}, C_k and S_k
//   in shared memory (3 n^2 values). C_k comes by forward substitution, one
//   column per lane of the warp, reading O_{k-1} straight from device memory
//   (the lanes read consecutive addresses); S_k = D_k - C_k'C_k, one entry
//   per lane; then the warp Cholesky of `chol` below. The first two steps
//   are the device functions of blocktri.cuh, which the fused factorization
//   (fused_factor.cu) runs with a thread block instead of a warp. The TPU
//   carried L_{k-1} in VMEM scratch between grid steps along N; here the
//   loop along N runs inside the warp. Breakdown follows
//   smallla.blocktridiag_factor: a block with a pivot <= 0 or non-finite
//   comes out entirely NaN, and so does every later block of its lane (a NaN
//   L_k makes C_{k+1} NaN), which the IPM's stall exit relies on.
//
// ---------------------------------------------------------------------------
// fused_chol_solve: A X = B for N independent SPD blocks, A n x n, B and X
//   n x m (n, m <= 32), the factor and both solves in one launch.
//   Replaces pallas_kkt.py _fused_chol_solve_kernel (fused_chol_solve, which
//   the JAX package runs only in tests/test_pallas_kkt.py, as a layout test
//   vehicle). Bound on the H100: bytes (A's lower triangle and B read once,
//   X written once; n^3/3 + 2 n^2 m flops a block).
//   Design: `chol` and `cho_solve` below composed in one warp per block: the
//   warp copies A's lower triangle into shared memory, factors it there, and
//   lane c solves column c against the factor, which never leaves shared
//   memory. A block whose factor breaks down comes out entirely NaN.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blocktri.cuh"

namespace {

constexpr int kMaxN = 32;

template <typename T>
__global__ void cho_solve_vec_kernel(const T* __restrict__ L,
                                     const T* __restrict__ b,
                                     T* __restrict__ x, int N, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const T* Li = L + (size_t)i * n * n;
  const T* bi = b + (size_t)i * n;
  T y[kMaxN];
  for (int r = 0; r < n; ++r) {
    T s = bi[r];
    for (int k = 0; k < r; ++k) s -= Li[r * n + k] * y[k];
    y[r] = s / Li[r * n + r];
  }
  for (int r = n - 1; r >= 0; --r) {
    T s = y[r];
    for (int k = r + 1; k < n; ++k) s -= Li[k * n + r] * y[k];
    y[r] = s / Li[r * n + r];
  }
  T* xi = x + (size_t)i * n;
  for (int r = 0; r < n; ++r) xi[r] = y[r];
}

template <typename T>
__global__ void tridiag_solve_kernel(const T* __restrict__ L,
                                     const T* __restrict__ C,
                                     const T* __restrict__ r,
                                     T* __restrict__ u, int B, int N, int n) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x / 32;
  const int li = threadIdx.x % 32;
  const int lane_b = blockIdx.x * (blockDim.x / 32) + warp;
  if (lane_b >= B) return;  // the whole warp leaves together
  const unsigned full = 0xffffffffu;
  const bool act = li < n;
  T* v = smem + (size_t)warp * N * n;
  const size_t nn = (size_t)n * n;
  const T* Lb = L + (size_t)lane_b * N * nn;
  const T* Cb = C + (size_t)lane_b * N * nn;
  const T* rb = r + (size_t)lane_b * N * n;
  T* ub = u + (size_t)lane_b * N * n;

  // forward sweep: L_k v_k = r_k - C_k' v_{k-1}
  for (int k = 0; k < N; ++k) {
    const T* Lk = Lb + k * nn;
    T val = T(0);
    if (act) {
      val = rb[k * n + li];
      if (k > 0) {
        const T* Ck = Cb + k * nn;
        const T* vp = v + (k - 1) * n;
        for (int t = 0; t < n; ++t) val -= Ck[t * n + li] * vp[t];
      }
    }
    for (int j = 0; j < n; ++j) {
      if (li == j) val = val / Lk[j * n + j];
      const T vj = __shfl_sync(full, val, j);
      if (act && li > j) val -= Lk[li * n + j] * vj;
    }
    if (act) v[k * n + li] = val;
    __syncwarp();
  }

  // backward sweep: L_k' u_k = v_k - C_{k+1} u_{k+1}; u_k overwrites v_k
  for (int k = N - 1; k >= 0; --k) {
    const T* Lk = Lb + k * nn;
    T val = T(0);
    if (act) {
      val = v[k * n + li];
      if (k + 1 < N) {
        const T* Cn = Cb + (k + 1) * nn;
        const T* un = v + (k + 1) * n;
        for (int t = 0; t < n; ++t) val -= Cn[li * n + t] * un[t];
      }
    }
    for (int j = n - 1; j >= 0; --j) {
      if (li == j) val = val / Lk[j * n + j];
      const T uj = __shfl_sync(full, val, j);
      if (act && li < j) val -= Lk[j * n + li] * uj;
    }
    __syncwarp();
    if (act) {
      v[k * n + li] = val;
      ub[k * n + li] = val;
    }
    __syncwarp();
  }
}

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
// or not finite; `a` then holds garbage.
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
    bad = bad || !(piv > T(0)) || isinf(piv);
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

template <typename T>
__global__ void chol_kernel(const T* __restrict__ A, T* __restrict__ L, int N,
                            int n) {
  extern __shared__ unsigned char smem_raw[];
  const int warp = threadIdx.x / 32;
  const int li = threadIdx.x % 32;
  const int blk = blockIdx.x * (blockDim.x / 32) + warp;
  if (blk >= N) return;  // the whole warp leaves together
  const size_t nn = (size_t)n * n;
  T* a = reinterpret_cast<T*>(smem_raw) + (size_t)warp * nn;
  warp_load_lower(A + blk * nn, a, n, li);
  __syncwarp();
  const bool bad = warp_chol(a, n, li);
  warp_store_factor(a, L + blk * nn, n, bad, li);
}

template <typename T>
__global__ void cho_solve_kernel(const T* __restrict__ L,
                                 const T* __restrict__ B, T* __restrict__ X,
                                 int N, int n, int m) {
  extern __shared__ unsigned char smem_raw[];
  const int warp = threadIdx.x / 32;
  const int li = threadIdx.x % 32;
  const int blk = blockIdx.x * (blockDim.x / 32) + warp;
  if (blk >= N) return;  // the whole warp leaves together
  const size_t nn = (size_t)n * n;
  T* l = reinterpret_cast<T*>(smem_raw) + (size_t)warp * nn;
  warp_load_lower(L + blk * nn, l, n, li);  // only the lower triangle is read
  __syncwarp();
  if (li >= m) return;
  lane_cho_solve_col(l, B + (size_t)blk * n * m, X + (size_t)blk * n * m, n,
                     m, li);
}

template <typename T>
__global__ void fused_chol_solve_kernel(const T* __restrict__ A,
                                        const T* __restrict__ B,
                                        T* __restrict__ X, int N, int n,
                                        int m) {
  extern __shared__ unsigned char smem_raw[];
  const int warp = threadIdx.x / 32;
  const int li = threadIdx.x % 32;
  const int blk = blockIdx.x * (blockDim.x / 32) + warp;
  if (blk >= N) return;  // the whole warp leaves together
  const size_t nn = (size_t)n * n;
  T* a = reinterpret_cast<T*>(smem_raw) + (size_t)warp * nn;
  warp_load_lower(A + blk * nn, a, n, li);
  __syncwarp();
  const bool bad = warp_chol(a, n, li);
  T* Xb = X + (size_t)blk * n * m;
  if (bad) {
    const T nan = quiet_nan<T>();
    for (int t = li; t < n * m; t += 32) Xb[t] = nan;
    return;
  }
  if (li < m) lane_cho_solve_col(a, B + (size_t)blk * n * m, Xb, n, m, li);
}

template <typename T>
__global__ void tridiag_factor_kernel(const T* __restrict__ D,
                                      const T* __restrict__ O,
                                      T* __restrict__ L, T* __restrict__ C,
                                      int B, int N, int n) {
  extern __shared__ unsigned char smem_raw[];
  const int warp = threadIdx.x / 32;
  const int li = threadIdx.x % 32;
  const int lane_b = blockIdx.x * (blockDim.x / 32) + warp;
  if (lane_b >= B) return;  // the whole warp leaves together
  const size_t nn = (size_t)n * n;
  T* sLp = reinterpret_cast<T*>(smem_raw) + (size_t)warp * 3 * nn;  // L_{k-1}
  T* sC = sLp + nn;                                                  // C_k
  T* sS = sC + nn;                                         // S_k, then L_k
  const T* Db = D + (size_t)lane_b * N * nn;
  const T* Ob = O + (size_t)lane_b * (N - 1) * nn;
  T* Lb = L + (size_t)lane_b * N * nn;
  T* Cb = C + (size_t)lane_b * N * nn;
  const T nan = quiet_nan<T>();
  for (int k = 0; k < N; ++k) {
    if (k == 0) {
      for (int t = li; t < (int)nn; t += 32) sC[t] = T(0);
    } else {
      tri_coupling(sLp, Ob + (k - 1) * nn, sC, n, li, 32);
    }
    __syncwarp();
    tri_schur(Db + k * nn, sC, sS, n, li, 32);
    __syncwarp();
    const bool bad = warp_chol(sS, n, li);
    warp_store_factor(sS, Lb + k * nn, n, bad, li);
    for (int t = li; t < (int)nn; t += 32) {
      Cb[k * nn + t] = sC[t];
      if (bad) sS[t] = nan;  // every later block of the lane comes out NaN
    }
    __syncwarp();
    T* tmp = sLp;  // L_k becomes L_{(k+1)-1}
    sLp = sS;
    sS = tmp;
  }
}

template <typename T>
int warp_per_block_grid(int N, int n, int* blocks, int* warps,
                          size_t* smem) {
  // one warp per n x n block, its copy in shared memory; four warps a CTA
  if (n < 1 || n > kMaxN || N < 0) return (int)cudaErrorInvalidValue;
  *warps = 4;
  *blocks = (N + *warps - 1) / *warps;
  *smem = (size_t)(*warps) * n * n * sizeof(T);
  return (int)cudaSuccess;
}

template <typename T>
int launch_chol(const void* A, void* L, int N, int n, void* stream) {
  int blocks, warps;
  size_t smem;
  const int err = warp_per_block_grid<T>(N, n, &blocks, &warps, &smem);
  if (err != (int)cudaSuccess) return err;
  if (N == 0) return (int)cudaSuccess;
  chol_kernel<T><<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
      (const T*)A, (T*)L, N, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cho_solve(const void* L, const void* B, void* X, int N, int n,
                     int m, void* stream) {
  if (m < 1 || m > 32) return (int)cudaErrorInvalidValue;
  int blocks, warps;
  size_t smem;
  const int err = warp_per_block_grid<T>(N, n, &blocks, &warps, &smem);
  if (err != (int)cudaSuccess) return err;
  if (N == 0) return (int)cudaSuccess;
  cho_solve_kernel<T><<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
      (const T*)L, (const T*)B, (T*)X, N, n, m);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fused_chol_solve(const void* A, const void* B, void* X, int N,
                            int n, int m, void* stream) {
  if (m < 1 || m > 32) return (int)cudaErrorInvalidValue;
  int blocks, warps;
  size_t smem;
  const int err = warp_per_block_grid<T>(N, n, &blocks, &warps, &smem);
  if (err != (int)cudaSuccess) return err;
  if (N == 0) return (int)cudaSuccess;
  fused_chol_solve_kernel<T><<<blocks, warps * 32, smem,
                               (cudaStream_t)stream>>>(
      (const T*)A, (const T*)B, (T*)X, N, n, m);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tridiag_factor(const void* D, const void* O, void* L, void* C,
                          int B, int N, int n, void* stream) {
  if (n < 1 || n > kMaxN || N < 1 || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  // L_{k-1}, C_k and S_k of each warp's lane in shared memory
  const size_t per_warp = 3 * (size_t)n * n * sizeof(T);
  const size_t limit = 48 * 1024;
  int warps = 4;
  while (warps > 1 && warps * per_warp > limit) --warps;
  const int blocks = (B + warps - 1) / warps;
  tridiag_factor_kernel<T><<<blocks, warps * 32, warps * per_warp,
                             (cudaStream_t)stream>>>(
      (const T*)D, (const T*)O, (T*)L, (T*)C, B, N, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cho_solve_vec(const void* L, const void* b, void* x, int N, int n,
                         void* stream) {
  if (n < 1 || n > kMaxN || N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const int threads = 128;
  const int blocks = (N + threads - 1) / threads;
  cho_solve_vec_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)L, (const T*)b, (T*)x, N, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tridiag_solve(const void* L, const void* C, const void* r, void* u,
                         int B, int N, int n, void* stream) {
  if (n < 1 || n > 32 || N < 1 || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const size_t per_warp = (size_t)N * n * sizeof(T);
  const size_t limit = 48 * 1024;
  if (per_warp > limit) return (int)cudaErrorInvalidValue;
  int warps = 4;
  while (warps > 1 && warps * per_warp > limit) --warps;
  const int blocks = (B + warps - 1) / warps;
  tridiag_solve_kernel<T><<<blocks, warps * 32, warps * per_warp,
                            (cudaStream_t)stream>>>(
      (const T*)L, (const T*)C, (const T*)r, (T*)u, B, N, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int scvx_cho_solve_vec_f32(const void* L, const void* b, void* x, int N, int n,
                           void* stream) {
  return launch_cho_solve_vec<float>(L, b, x, N, n, stream);
}

int scvx_cho_solve_vec_f64(const void* L, const void* b, void* x, int N, int n,
                           void* stream) {
  return launch_cho_solve_vec<double>(L, b, x, N, n, stream);
}

int scvx_tridiag_solve_f32(const void* L, const void* C, const void* r, void* u,
                           int B, int N, int n, void* stream) {
  return launch_tridiag_solve<float>(L, C, r, u, B, N, n, stream);
}

int scvx_tridiag_solve_f64(const void* L, const void* C, const void* r, void* u,
                           int B, int N, int n, void* stream) {
  return launch_tridiag_solve<double>(L, C, r, u, B, N, n, stream);
}

int scvx_chol_f32(const void* A, void* L, int N, int n, void* stream) {
  return launch_chol<float>(A, L, N, n, stream);
}

int scvx_chol_f64(const void* A, void* L, int N, int n, void* stream) {
  return launch_chol<double>(A, L, N, n, stream);
}

int scvx_cho_solve_f32(const void* L, const void* B, void* X, int N, int n,
                       int m, void* stream) {
  return launch_cho_solve<float>(L, B, X, N, n, m, stream);
}

int scvx_cho_solve_f64(const void* L, const void* B, void* X, int N, int n,
                       int m, void* stream) {
  return launch_cho_solve<double>(L, B, X, N, n, m, stream);
}

int scvx_fused_chol_solve_f32(const void* A, const void* B, void* X, int N,
                              int n, int m, void* stream) {
  return launch_fused_chol_solve<float>(A, B, X, N, n, m, stream);
}

int scvx_fused_chol_solve_f64(const void* A, const void* B, void* X, int N,
                              int n, int m, void* stream) {
  return launch_fused_chol_solve<double>(A, B, X, N, n, m, stream);
}

int scvx_tridiag_factor_f32(const void* D, const void* O, void* L, void* C,
                            int B, int N, int n, void* stream) {
  return launch_tridiag_factor<float>(D, O, L, C, B, N, n, stream);
}

int scvx_tridiag_factor_f64(const void* D, const void* O, void* L, void* C,
                            int B, int N, int n, void* stream) {
  return launch_tridiag_factor<double>(D, O, L, C, B, N, n, stream);
}

}  // extern "C"
