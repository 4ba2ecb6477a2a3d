// Block solves of the structured KKT system, written for Hopper (sm_90a).
//
// Two kernels with a plain C interface (loaded with ctypes by
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

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // extern "C"
