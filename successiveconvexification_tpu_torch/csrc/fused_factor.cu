// Fused KKT factorization of the stage SOCP, written for Hopper (sm_90a).
//
// Replaces the TPU kernel successiveconvexification_tpu/ops/pallas_fused.py
// _fused_factor_kernel (launched by _fused_factor_batched / fused_factor).
// Per scenario lane b and node k it computes, in order:
//
//   H_k      = sum_r wrow_r g_r g_r' + sum_s uc_s u_s u_s' + diag(hdiag),
//              u_s = sum_{r in SOC range s} uv_r g_r           (G rows g_r)
//   LH_k     = chol(H_k)                                        -> chol_Hw
//   XE_k     = H_k^-1 E_k',  XF_{k-1} = H_k^-1 F_{k-1}'
//   D_{k-1}  = E_{k-1} XE_{k-1} + F_{k-1} XF_{k-1} + diag(dpq_{k-1})
//   O_{k-1}  = F_{k-1} XE_k
//   C_{k-1}  = L_{k-2}^-1 O_{k-2}   (C_0 = 0)                   -> C
//   L_{k-1}  = chol(D_{k-1} - C_{k-1}' C_{k-1})                 -> L
//
// so H, XE, XF, D and O never reach device memory.
//
// Bound on the H100: bytes. At the main path (B=256, K=50, R=38, nw=17,
// nrx=13, float32) the inputs and outputs are about 93 MB (G alone is
// 33 MB) against about 0.77 GFLOP, i.e. ~28 us at 3.35 TB/s against
// ~11 us at 67 TFLOP/s.
//
// Design: on the TPU a sequential (batch-tile, node) grid carried XE, E, O
// and L_prev in VMEM scratch between grid steps. Blocks on Hopper run in no
// order, so the node loop runs INSIDE the kernel: one thread block per
// scenario lane walks k = 0..K-1 and keeps the carries (E_{k-1}, XE_{k-1},
// O_{k-2}, L_{k-2}) in shared memory next to the per-node working set
// (~15 KB in float32). The block's threads split the lower entries of H,
// the 2*nrx independent right-hand-side columns of the XE/XF solves, and
// the nrx*nrx entries of D, O and S; __syncthreads() separates the
// sequential Cholesky columns. The SOC row ranges arrive as an int32 array
// argument (the TPU code passed them through a module-global side channel).
// This first kernel is latency-bound on its ~70 barriers per node; making
// it reach the bound is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blocktri.cuh"

namespace {

constexpr int kThreads = 128;

// In-place lower Cholesky of the n x n row-major matrix A in shared memory
// (the upper triangle is not read). Right-looking, one column at a time.
template <typename T>
__device__ void block_chol(T* A, int n) {
  const int tid = threadIdx.x;
  for (int j = 0; j < n; ++j) {
    if (tid == 0) A[j * n + j] = sqrt(A[j * n + j]);
    __syncthreads();
    const T d = A[j * n + j];
    for (int i = j + 1 + tid; i < n; i += blockDim.x) A[i * n + j] /= d;
    __syncthreads();
    const int m = n - j - 1;
    for (int idx = tid; idx < m * m; idx += blockDim.x) {
      const int i = j + 1 + idx / m;
      const int c = j + 1 + idx % m;
      if (c <= i) A[i * n + c] -= A[i * n + j] * A[c * n + j];
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void fused_factor_kernel(
    const T* __restrict__ G, const T* __restrict__ wrow,
    const T* __restrict__ uv, const T* __restrict__ ucoef,
    const T* __restrict__ hdiag, const T* __restrict__ E,
    const T* __restrict__ F, const T* __restrict__ dpq,
    const int* __restrict__ soc_ranges, T* __restrict__ chol_out,
    T* __restrict__ L_out, T* __restrict__ C_out, int K, int R, int nw,
    int nrx, int S) {
  extern __shared__ unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  int* rng = reinterpret_cast<int*>(smem_raw);
  // keep the float area aligned to 16 bytes
  size_t off = ((2 * (size_t)S * sizeof(int)) + 15) / 16 * 16;
  T* base = reinterpret_cast<T*>(smem_raw + off);
  T* sG = base;            base += R * nw;
  T* sW = base;            base += R;
  T* sUv = base;           base += R;
  T* sUc = base;           base += S;
  T* sHd = base;           base += nw;
  T* sU = base;            base += S * nw;
  T* sH = base;            base += nw * nw;
  T* sE = base;            base += nrx * nw;   // E_k
  T* sEp = base;           base += nrx * nw;   // E_{k-1}
  T* sF = base;            base += nrx * nw;   // F_{k-1}
  T* sXE = base;           base += nw * nrx;   // XE_k   (column-major by rhs)
  T* sXEp = base;          base += nw * nrx;   // XE_{k-1}
  T* sXF = base;           base += nw * nrx;   // XF_{k-1}
  T* sD = base;            base += nrx * nrx;
  T* sO = base;            base += nrx * nrx;  // O_{k-1}
  T* sOp = base;           base += nrx * nrx;  // O_{k-2}
  T* sLp = base;           base += nrx * nrx;  // L_{k-2}
  T* sC = base;            base += nrx * nrx;
  T* sS = base;            base += nrx * nrx;

  for (int i = tid; i < 2 * S; i += nt) rng[i] = soc_ranges[i];

  const size_t RW = (size_t)R * nw;
  const size_t EW = (size_t)nrx * nw;
  const size_t NN = (size_t)nrx * nrx;
  const size_t HW = (size_t)nw * nw;

  for (int k = 0; k < K; ++k) {
    const size_t bk = (size_t)b * K + k;
    const bool has_e = k <= K - 2;   // E_k, XE_k exist
    const bool has_prev = k >= 1;    // block k-1 is finished at this node

    // ---- load node data ---------------------------------------------------
    for (int i = tid; i < RW; i += nt) sG[i] = G[bk * RW + i];
    for (int i = tid; i < R; i += nt) {
      sW[i] = wrow[bk * R + i];
      sUv[i] = uv[bk * R + i];
    }
    for (int i = tid; i < S; i += nt) sUc[i] = ucoef[bk * S + i];
    for (int i = tid; i < nw; i += nt) sHd[i] = hdiag[bk * nw + i];
    const size_t bk1 = (size_t)b * (K - 1);
    if (has_e)
      for (int i = tid; i < EW; i += nt) sE[i] = E[(bk1 + k) * EW + i];
    if (has_prev)
      for (int i = tid; i < EW; i += nt) sF[i] = F[(bk1 + k - 1) * EW + i];
    __syncthreads();

    // ---- u_s = sum_{r in range s} uv_r g_r ----------------------------------
    for (int i = tid; i < S * nw; i += nt) {
      const int s = i / nw, a = i % nw;
      T acc = T(0);
      for (int r = rng[2 * s]; r < rng[2 * s + 1]; ++r)
        acc += sUv[r] * sG[r * nw + a];
      sU[i] = acc;
    }
    __syncthreads();

    // ---- H lower triangle -------------------------------------------------
    for (int i = tid; i < nw * nw; i += nt) {
      const int a = i / nw, c = i % nw;
      if (c > a) continue;
      T acc = T(0);
      for (int r = 0; r < R; ++r) acc += sW[r] * sG[r * nw + a] * sG[r * nw + c];
      for (int s = 0; s < S; ++s) acc += sUc[s] * sU[s * nw + a] * sU[s * nw + c];
      if (a == c) acc += sHd[a];
      sH[i] = acc;
    }
    __syncthreads();

    block_chol(sH, nw);
    for (int i = tid; i < nw * nw; i += nt) {
      const int a = i / nw, c = i % nw;
      chol_out[bk * HW + i] = c <= a ? sH[i] : T(0);
    }

    // ---- XE_k = H^-1 E_k', XF_{k-1} = H^-1 F_{k-1}' : one column per thread --
    for (int col = tid; col < 2 * nrx; col += nt) {
      const bool is_e = col < nrx;
      const int c = is_e ? col : col - nrx;
      if (is_e ? !has_e : !has_prev) continue;
      const T* src = (is_e ? sE : sF) + c * nw;  // row c of E_k / F_{k-1}
      T* X = is_e ? sXE : sXF;                  // X[a * nrx + c]
      for (int a = 0; a < nw; ++a) {
        T s = src[a];
        for (int m = 0; m < a; ++m) s -= sH[a * nw + m] * X[m * nrx + c];
        X[a * nrx + c] = s / sH[a * nw + a];
      }
      for (int a = nw - 1; a >= 0; --a) {
        T s = X[a * nrx + c];
        for (int m = a + 1; m < nw; ++m) s -= sH[m * nw + a] * X[m * nrx + c];
        X[a * nrx + c] = s / sH[a * nw + a];
      }
    }
    __syncthreads();

    if (has_prev) {
      // ---- D_{k-1}, O_{k-1} ---------------------------------------------------
      for (int i = tid; i < nrx * nrx; i += nt) {
        const int a = i / nrx, c = i % nrx;
        T acc = T(0);
        for (int w = 0; w < nw; ++w)
          acc += sEp[a * nw + w] * sXEp[w * nrx + c] +
                 sF[a * nw + w] * sXF[w * nrx + c];
        if (a == c) acc += dpq[(bk1 + k - 1) * nrx + a];
        sD[i] = acc;
        if (has_e) {
          T o = T(0);
          for (int w = 0; w < nw; ++w) o += sF[a * nw + w] * sXE[w * nrx + c];
          sO[i] = o;
        }
      }
      // ---- C_{k-1} = L_{k-2}^-1 O_{k-2} (C_0 = 0): one column per thread ----
      if (k >= 2) {
        tri_coupling(sLp, sOp, sC, nrx, tid, nt);
      } else {
        for (int i = tid; i < nrx * nrx; i += nt) sC[i] = T(0);
      }
      __syncthreads();
      // ---- S = D - C'C (lower), L_{k-1} = chol(S) ----------------------------
      tri_schur(sD, sC, sS, nrx, tid, nt);
      __syncthreads();
      block_chol(sS, nrx);
      const size_t o = (bk1 + k - 1) * NN;
      for (int i = tid; i < nrx * nrx; i += nt) {
        const int a = i / nrx, c = i % nrx;
        const T l = c <= a ? sS[i] : T(0);
        L_out[o + i] = l;
        C_out[o + i] = sC[i];
        sLp[i] = l;        // L_{k-1} becomes L_{(k+1)-2}
        sOp[i] = sO[i];    // O_{k-1} becomes O_{(k+1)-2}
      }
    }
    // ---- carries: E_{k-1} <- E_k, XE_{k-1} <- XE_k ---------------------------
    if (has_e) {
      for (int i = tid; i < EW; i += nt) {
        sEp[i] = sE[i];
        sXEp[i] = sXE[i];
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch_fused_factor(const void* G, const void* wrow, const void* uv,
                        const void* ucoef, const void* hdiag, const void* E,
                        const void* F, const void* dpq, const void* soc_ranges,
                        void* chol_out, void* L_out, void* C_out, int B, int K,
                        int R, int nw, int nrx, int S, void* stream) {
  if (B < 0 || K < 2 || R < 1 || nw < 1 || nrx < 1 || S < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const size_t nT = (size_t)R * nw + 2 * (size_t)R + S + nw + (size_t)S * nw +
                    (size_t)nw * nw + 3 * (size_t)nrx * nw +
                    3 * (size_t)nw * nrx + 6 * (size_t)nrx * nrx;
  const size_t smem =
      ((2 * (size_t)S * sizeof(int)) + 15) / 16 * 16 + nT * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      fused_factor_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_factor_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)G, (const T*)wrow, (const T*)uv, (const T*)ucoef,
      (const T*)hdiag, (const T*)E, (const T*)F, (const T*)dpq,
      (const int*)soc_ranges, (T*)chol_out, (T*)L_out, (T*)C_out, K, R, nw,
      nrx, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int scvx_fused_factor_f32(const void* G, const void* wrow, const void* uv,
                          const void* ucoef, const void* hdiag, const void* E,
                          const void* F, const void* dpq,
                          const void* soc_ranges, void* chol_out, void* L_out,
                          void* C_out, int B, int K, int R, int nw, int nrx,
                          int S, void* stream) {
  return launch_fused_factor<float>(G, wrow, uv, ucoef, hdiag, E, F, dpq,
                                    soc_ranges, chol_out, L_out, C_out, B, K, R,
                                    nw, nrx, S, stream);
}

int scvx_fused_factor_f64(const void* G, const void* wrow, const void* uv,
                          const void* ucoef, const void* hdiag, const void* E,
                          const void* F, const void* dpq,
                          const void* soc_ranges, void* chol_out, void* L_out,
                          void* C_out, int B, int K, int R, int nw, int nrx,
                          int S, void* stream) {
  return launch_fused_factor<double>(G, wrow, uv, ucoef, hdiag, E, F, dpq,
                                     soc_ranges, chol_out, L_out, C_out, B, K,
                                     R, nw, nrx, S, stream);
}

}  // extern "C"
