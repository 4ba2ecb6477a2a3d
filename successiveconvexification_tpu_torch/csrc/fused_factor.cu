// Fused KKT factorization of the stage SOCP, written for Hopper (sm_90a).
//
// Replaces the TPU kernel successiveconvexification_tpu/ops/pallas_fused.py
// _fused_factor_kernel (launched by _fused_factor_batched / fused_factor).
// Per scenario lane b and node k it computes
//
//   H_k      = sum_r wrow_r g_r g_r' + sum_s uc_s u_s u_s' + diag(hdiag),
//              u_s = sum_{r in SOC range s} uv_r g_r           (G rows g_r)
//   LH_k     = chol(H_k)                                        -> chol_Hw
//   XE_k     = H_k^-1 E_k',  XF_{k-1} = H_k^-1 F_{k-1}'
//   D_j      = E_j XE_j + F_j XF_j + diag(dpq_j)
//   O_j      = F_j XE_{j+1}
//   C_j      = L_{j-1}^-1 O_{j-1}   (C_0 = 0)                   -> C
//   L_j      = chol(D_j - C_j' C_j)                             -> L
//
// so H, XE, XF, D and O never reach device memory.
//
// Bound on the H100: bytes. At the main path (B=256, K=50, R=38, nw=17,
// nrx=13, float32) the inputs and outputs are about 93 MB (G alone is
// 33 MB) against about 0.77 GFLOP, i.e. ~28 us at 3.35 TB/s against
// ~11 us at 67 TFLOP/s. What holds a lane back is latency: the 49 steps of
// the block-tridiagonal recurrence (C_j, S_j, L_j) depend on each other,
// and each is a chain of small triangular solves and square roots.
//
// Design: one CTA a lane (the TPU's sequential grid step along K becomes
// a loop inside the CTA), with its warps specialized.
//   - W producer warps (W = 3, fewer when K or shared memory is short:
//     with 7, the producers' instructions slowed the recurrence warp's
//     step from 7,600 to 12,200 cycles and the kernel took 0.457 ms
//     against 0.346 with 3, which still keep ahead of it).
//     Warp w takes the nodes k = w, w + W, ... Everything of node k but the
//     recurrence depends on node data alone: the warp stages G_k, wrow_k,
//     uv_k, ucoef_k, hdiag_k, E_k and F_{k-1} in its own shared memory with
//     cp.async (element-sized copies, see async.cuh), one node ahead in a
//     second buffer; lane a builds row a of H_k in registers and the warp
//     factors it there (warp_chol_rows: a block with a pivot <= 0 or NaN
//     comes out entirely NaN, as smallla.chol's); the factor goes through
//     shared memory to chol_Hw_k; lane c then solves column c of
//     H_k^-1 [E_k' | F_{k-1}'] (all 26 columns in one pass, the first
//     design's order: forward s = b_r, k ascending, a true division by
//     L[r][r]; backward s = y_r, k = r+1.. ascending, the division; the
//     factor read by every lane alike) and
//     forms column c of O_{k-1} = F_{k-1} XE_k in registers. Last, with
//     unit k-1's E_{k-1} and XE_{k-1} from its slot, it forms D_{k-1} =
//     E_{k-1} XE_{k-1} + F_{k-1} XF_{k-1} + diag(dpq_{k-1}) in the first
//     design's one sum per entry (the f64 check of the main path against
//     the CPU moved by 1e-4 in one lane when D was two sums). E_k's rows,
//     XE_k, XF_{k-1}, O_{k-1} and D_{k-1} go to a slot of a ring in shared
//     memory: the unit of node k.
//   - One recurrence warp. Step j reads O_{j-1} from unit j and D_j from
//     unit j + 1 and runs warp_tri_step (blocktri.cuh) with C_j and S_j,
//     L_j in registers, n = nrx a template bound, storing C_j and L_j.
//     Every output takes the first design's operations in its order, so
//     the results are its results bit for bit. A broken L_j is all NaN,
//     and so is every later block of the lane, which the IPM's stall exit
//     relies on.
//   - Each ring slot has a full and an empty mbarrier (32 arrivals each:
//     the producer's lanes, the recurrence warp's lanes); the use count of
//     a slot gives the phase parity. Slot k % NSLOT, NSLOT = W + 2.
// Shared memory stays under 112 KB in float32 at the main path's shapes,
// so two CTAs share an SM and the 256 lanes run in one wave on 132 SMs.
// The models' widths (nw, nrx = 17, 13 and 11, 7) are compile-time
// constants of their own kernels: with no run-time bound in them, the
// unrolled loops are straight-line code whose loads and shuffles issue
// back to back (a guard per iteration made each wait out its latency, ~30
// cycles: a 13 x 13 step alone cost 15,900 cycles with the bound read at
// run time, 4,800 with it compiled in, on the H100).
// No tensor cores: TF32 and bf16 are barred from the solver's algebra
// (ops/precision.py; bf16 KKT algebra converged 0/256), and the ~0.77
// GFLOP are ~11 us at the float32 peak anyway; the limit is the
// recurrence's latency, not arithmetic. Takes nw <= 32 and nrx <= 32 (one
// lane a row).

#include <cuda_runtime.h>
#include <stdint.h>

#include "async.cuh"
#include "blocktri.cuh"

namespace {

constexpr int kMaxProducers = 3;

// Values of one node's staged inputs: G_k, wrow_k, uv_k, ucoef_k, hdiag_k,
// E_k and F_{k-1}, in that order, each row-major as in device memory.
__host__ __device__ __forceinline__ size_t stage_elems(int R, int nw, int nrx,
                                                       int S) {
  return (size_t)R * nw + 2 * (size_t)R + S + nw + 2 * (size_t)nrx * nw;
}

// Values of one producer warp's working set: two stage buffers, the cone
// vectors u_s and the factor of H_k.
__host__ __device__ __forceinline__ size_t producer_elems(int R, int nw,
                                                          int nrx, int S) {
  return 2 * stage_elems(R, nw, nrx, S) + (size_t)S * nw + (size_t)nw * nw;
}

// Values of one unit in the ring: E_k's rows, XE_k = H_k^-1 E_k' (nw x
// nrx), XF_{k-1} = H_k^-1 F_{k-1}' (nw x nrx), O_{k-1} and D_{k-1} (nrx x
// nrx each).
__host__ __device__ __forceinline__ size_t unit_elems(int nw, int nrx) {
  return 3 * (size_t)nrx * nw + 2 * (size_t)nrx * nrx;
}

// Byte offsets of the CTA's shared memory: mbarriers (full, then empty),
// SOC ranges, the ring, the recurrence warp's L and C, the producers.
struct Carve {
  size_t ranges, ring, rec, prod, total;
};

__host__ __device__ __forceinline__ Carve carve(int W, int nslot, int R,
                                                int nw, int nrx, int S,
                                                size_t esize) {
  const size_t nn = (size_t)nrx * nrx;
  Carve c;
  c.ranges = 2 * (size_t)nslot * sizeof(uint64_t);
  c.ring = align16(c.ranges + 2 * (size_t)S * sizeof(int));
  c.rec = c.ring + (size_t)nslot * unit_elems(nw, nrx) * esize;
  c.prod = align16(c.rec + 2 * nn * esize);
  c.total = c.prod + (size_t)W * align16(producer_elems(R, nw, nrx, S) * esize);
  return c;
}

// The lane's copies of node k's inputs into stage buffer `st`, one group.
template <typename T>
__device__ __forceinline__ void stage_node(
    T* st, const T* G, const T* wrow, const T* uv, const T* ucoef,
    const T* hdiag, const T* E, const T* F, int b, int k, int K, int R,
    int nw, int nrx, int S, int li) {
  const size_t bk = (size_t)b * K + k;
  const size_t bk1 = (size_t)b * (K - 1);
  const int RW = R * nw, EW = nrx * nw;
  T* sG = st;
  T* sW = sG + RW;
  T* sUv = sW + R;
  T* sUc = sUv + R;
  T* sHd = sUc + S;
  T* sE = sHd + nw;
  T* sF = sE + EW;
  for (int i = li; i < RW; i += 32) cp_async_elem(sG + i, G + bk * RW + i);
  for (int i = li; i < R; i += 32) {
    cp_async_elem(sW + i, wrow + bk * R + i);
    cp_async_elem(sUv + i, uv + bk * R + i);
  }
  for (int i = li; i < S; i += 32) cp_async_elem(sUc + i, ucoef + bk * S + i);
  for (int i = li; i < nw; i += 32) cp_async_elem(sHd + i, hdiag + bk * nw + i);
  if (k <= K - 2)
    for (int i = li; i < EW; i += 32)
      cp_async_elem(sE + i, E + (bk1 + k) * EW + i);
  if (k >= 1)
    for (int i = li; i < EW; i += 32)
      cp_async_elem(sF + i, F + (bk1 + k - 1) * EW + i);
  cp_async_commit();
}

// NW, NR: nw and nrx when EXACT, else their bounds (the launch dispatches).
template <typename T, int NW, int NR, bool EXACT>
__global__ void __launch_bounds__(32 * (kMaxProducers + 1),
                                   sizeof(T) == 4 ? 2 : 1)
    fused_factor_kernel(const T* __restrict__ G, const T* __restrict__ wrow,
                        const T* __restrict__ uv, const T* __restrict__ ucoef,
                        const T* __restrict__ hdiag, const T* __restrict__ E,
                        const T* __restrict__ F, const T* __restrict__ dpq,
                        const int* __restrict__ soc_ranges,
                        T* __restrict__ chol_out, T* __restrict__ L_out,
                        T* __restrict__ C_out, int K, int R, int nw, int nrx,
                        int S, int nslot) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (EXACT) {
    nw = NW;
    nrx = NR;
  }
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int li = tid % 32;
  const int W = blockDim.x / 32 - 1;  // producers; the last warp recurs
  const Carve cv = carve(W, nslot, R, nw, nrx, S, sizeof(T));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + nslot;
  int* rng = reinterpret_cast<int*>(smem_raw + cv.ranges);
  T* ring = reinterpret_cast<T*>(smem_raw + cv.ring);

  const size_t nn = (size_t)nrx * nrx;
  const size_t bk1 = (size_t)b * (K - 1);
  if (tid == 0) {
    for (int s = 0; s < nslot; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 32);
    }
  }
  for (int i = tid; i < 2 * S; i += blockDim.x) rng[i] = soc_ranges[i];
  mbar_fence_init();
  __syncthreads();

  if (warp < W) {
    // ---- producer: the units of nodes warp, warp + W, ... ------------------
    // Lane a < nw owns row a of H_k and of its factor; lane c < 2 nrx then
    // owns column c of [E_k' | F_{k-1}'] through the solves and products.
    const int m = 2 * nrx;
    const int EW = nrx * nw;
    const size_t st_n = stage_elems(R, nw, nrx, S);
    T* area = reinterpret_cast<T*>(
        smem_raw + cv.prod +
        warp * align16(producer_elems(R, nw, nrx, S) * sizeof(T)));
    T* sU = area + 2 * st_n;         // u_s, S x nw
    T* sL = sU + (size_t)S * nw;     // the factor of H_k, nw x nw
    const T nan = quiet_nan<T>();
    const int lc = li < nw ? li : 0;
    stage_node(area, G, wrow, uv, ucoef, hdiag, E, F, b, warp, K, R, nw, nrx,
               S, li);  // W <= K: every producer has a node
    for (int k = warp, it = 0; k < K; k += W, ++it) {
      const size_t bk = (size_t)b * K + k;
      const bool has_e = k <= K - 2;  // E_k exists
      const bool has_f = k >= 1;      // F_{k-1} exists
      __syncwarp();  // the previous node's reads of the other buffer are done
      if (k + W < K)
        stage_node(area + ((it + 1) & 1) * st_n, G, wrow, uv, ucoef, hdiag,
                   E, F, b, k + W, K, R, nw, nrx, S, li);
      else
        cp_async_commit();  // an empty group keeps one group in flight
      cp_async_wait_prior();
      T* sG = area + (it & 1) * st_n;  // stage_node's layout
      T* sW = sG + R * nw;
      T* sUv = sW + R;
      T* sUc = sUv + R;
      T* sHd = sUc + S;
      T* sE = sHd + nw;
      T* sF = sE + EW;
      if (!has_e)  // the last node has no E_k, the first no F_{k-1}
        for (int i = li; i < EW; i += 32) sE[i] = T(0);
      if (!has_f)
        for (int i = li; i < EW; i += 32) sF[i] = T(0);
      __syncwarp();

      // u_s[a] = sum_{r in range s} uv_r g_r[a], lane a
      for (int s = 0; s < S; ++s) {
        T acc = T(0);
        for (int r = rng[2 * s]; r < rng[2 * s + 1]; ++r)
          acc += sUv[r] * sG[r * nw + lc];
        if (li < nw) sU[s * nw + li] = acc;
      }
      __syncwarp();
      // row lc of H_k (the whole row; warp_chol_rows reads its lower part)
      T h[NW];
#pragma unroll
      for (int c = 0; c < NW; ++c) h[c] = T(0);
      for (int r = 0; r < R; ++r) {
        const T wg = sW[r] * sG[r * nw + lc];
#pragma unroll
        for (int c = 0; c < NW; ++c)
          if (c < nw) h[c] += wg * sG[r * nw + c];
      }
      for (int s = 0; s < S; ++s) {
        const T ug = sUc[s] * sU[s * nw + lc];
#pragma unroll
        for (int c = 0; c < NW; ++c)
          if (c < nw) h[c] += ug * sU[s * nw + c];
      }
      const T hd = sHd[lc];
#pragma unroll
      for (int c = 0; c < NW; ++c) h[c] = c == lc ? h[c] + hd : h[c];
      const bool bad = warp_chol_rows<T, NW>(h, nw, li);
      if (li < nw) {
#pragma unroll
        for (int c = 0; c < NW; ++c)
          if (c < nw) sL[li * nw + c] = bad ? nan : (c <= li ? h[c] : T(0));
      }
      __syncwarp();
      for (int t = li; t < nw * nw; t += 32)
        chol_out[bk * nw * nw + t] = sL[t];

      // the unit into slot k % nslot, once the recurrence has released the
      // slot's previous unit: E_k's and F_{k-1}'s rows, their solves and
      // O_{k-1}
      const int slot = k % nslot, use = k / nslot;
      if (use >= 1) mbar_wait(&empty[slot], (use - 1) & 1);
      T* uE = ring + (size_t)slot * unit_elems(nw, nrx);
      T* uXE = uE + EW;
      T* uXF = uXE + EW;
      T* uO = uXF + EW;
      T* uD = uO + nn;
      if (has_e)
        for (int i = li; i < EW; i += 32) uE[i] = sE[i];
      // column cl of H_k^-1 [E_k' | F_{k-1}'] by lane cl % 32 (one pass
      // while 2 nrx <= 32): forward and backward substitution (the order
      // of the note at the top), the factor read by every lane alike; a
      // broken factor is NaN, and so is every column
      for (int c0 = 0; c0 < m; c0 += 32) {
        const int cl = c0 + li;
        const int col = cl < m ? cl : 0;
        const T* brow = col < nrx ? sE + col * nw : sF + (col - nrx) * nw;
        T y[NW];
#pragma unroll
        for (int r = 0; r < NW; ++r) {
          y[r] = T(0);
          if (r < nw) {
            T s = brow[r];
#pragma unroll
            for (int q = 0; q < r; ++q) s -= sL[r * nw + q] * y[q];
            y[r] = s / sL[r * nw + r];
          }
        }
#pragma unroll
        for (int r = NW - 1; r >= 0; --r) {
          if (r < nw) {
            T s = y[r];
#pragma unroll
            for (int q = r + 1; q < NW; ++q)
              if (q < nw) s -= sL[q * nw + r] * y[q];
            y[r] = s / sL[r * nw + r];
          }
        }
        if (cl < nrx) {
          // column cl of XE_k, and of O_{k-1} = F_{k-1} XE_k
#pragma unroll
          for (int w = 0; w < NW; ++w)
            if (w < nw && has_e) uXE[w * nrx + cl] = y[w];
          if (has_e && has_f) {
#pragma unroll
            for (int a = 0; a < NR; ++a) {
              if (a < nrx) {
                T o = T(0);
#pragma unroll
                for (int w = 0; w < NW; ++w)
                  if (w < nw) o += sF[a * nw + w] * y[w];
                uO[a * nrx + cl] = o;
              }
            }
          }
        } else if (cl < m && has_f) {
#pragma unroll
          for (int w = 0; w < NW; ++w)
            if (w < nw) uXF[w * nrx + cl - nrx] = y[w];
        }
      }
      // D_{k-1} = E_{k-1} XE_{k-1} + F_{k-1} XF_{k-1} + diag(dpq_{k-1}) in
      // the first design's one sum per entry (the f64 check of the main
      // path against the CPU moved by 1e-4 in one lane when D was two
      // sums): E_{k-1} and XE_{k-1} from unit k-1's slot, which stays until
      // the recurrence has used this unit's D
      if (has_f) {
        const int pslot = (k - 1) % nslot;
        mbar_wait(&full[pslot], ((k - 1) / nslot) & 1);
        __syncwarp();  // this warp's XF_{k-1} columns are in the slot
        const T* pE = ring + (size_t)pslot * unit_elems(nw, nrx);
        const T* pXE = pE + EW;
        const T* dk = dpq + (bk1 + k - 1) * nrx;
        for (int i = li; i < (int)nn; i += 32) {
          const int a = i / nrx, c = i - a * nrx;
          T acc = T(0);
#pragma unroll
          for (int w = 0; w < NW; ++w)
            if (w < nw)
              acc += pE[a * nw + w] * pXE[w * nrx + c] +
                     sF[a * nw + w] * uXF[w * nrx + c];
          if (a == c) acc += dk[a];
          uD[i] = acc;
        }
      }
      mbar_arrive(&full[slot]);
    }
  } else {
    // ---- recurrence: steps j = 0..K-2 --------------------------------------
    T* sL = reinterpret_cast<T*>(smem_raw + cv.rec);  // L_{j-1}, then L_j
    T* sC = sL + nn;
    mbar_wait(&full[0], 0);
    for (int j = 0; j <= K - 2; ++j) {
      const int s0 = j % nslot, s1 = (j + 1) % nslot;
      mbar_wait(&full[s1], ((j + 1) / nslot) & 1);
      // O_{j-1} from unit j, D_j from unit j + 1
      const T* O0 = ring + (size_t)s0 * unit_elems(nw, nrx) + 3 * nrx * nw;
      const T* D1 = ring + (size_t)s1 * unit_elems(nw, nrx) + 3 * nrx * nw + nn;
      warp_tri_step<T, NR>(sL, j ? O0 : nullptr, D1, sC, sL, nrx, li,
                           C_out + (bk1 + j) * nn, L_out + (bk1 + j) * nn);
      mbar_arrive(&empty[s0]);
    }
  }
}

template <typename T, int NW, int NR, bool EXACT>
int launch_fused_factor_n(const void* G, const void* wrow, const void* uv,
                          const void* ucoef, const void* hdiag, const void* E,
                          const void* F, const void* dpq,
                          const void* soc_ranges, void* chol_out, void* L_out,
                          void* C_out, int B, int K, int R, int nw, int nrx,
                          int S, void* stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // as many producers (at most 3, at most K) as leave room for two CTAs an
  // SM; else as many as fit at all
  const int wmax = K < kMaxProducers ? K : kMaxProducers;
  int W = wmax;
  while (W > 1 &&
         carve(W, W + 2, R, nw, nrx, S, sizeof(T)).total > kTwoPerSm)
    --W;
  if (carve(W, W + 2, R, nw, nrx, S, sizeof(T)).total > kTwoPerSm) {
    W = wmax;
    while (W > 1 &&
           carve(W, W + 2, R, nw, nrx, S, sizeof(T)).total > (size_t)optin)
      --W;
  }
  const size_t smem = carve(W, W + 2, R, nw, nrx, S, sizeof(T)).total;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fused_factor_kernel<T, NW, NR, EXACT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_factor_kernel<T, NW, NR, EXACT><<<B, 32 * (W + 1), smem,
                                          (cudaStream_t)stream>>>(
      (const T*)G, (const T*)wrow, (const T*)uv, (const T*)ucoef,
      (const T*)hdiag, (const T*)E, (const T*)F, (const T*)dpq,
      (const int*)soc_ranges, (T*)chol_out, (T*)L_out, (T*)C_out, K, R, nw,
      nrx, S, W + 2);
  return (int)cudaGetLastError();
}

// The models' widths get kernels with nw and nrx compiled in (the 6-DoF
// rocket's 17 and 13, the 3-DoF point mass's 11 and 7); any other width up
// to 32 takes the kernel with both bounded by 32 and read at run time.
template <typename T>
int launch_fused_factor(const void* G, const void* wrow, const void* uv,
                        const void* ucoef, const void* hdiag, const void* E,
                        const void* F, const void* dpq, const void* soc_ranges,
                        void* chol_out, void* L_out, void* C_out, int B, int K,
                        int R, int nw, int nrx, int S, void* stream) {
  if (B < 0 || K < 2 || R < 1 || nw < 1 || nw > kMaxN || nrx < 1 ||
      nrx > kMaxN || S < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  if (nw == 17 && nrx == 13)
    return launch_fused_factor_n<T, 17, 13, true>(
        G, wrow, uv, ucoef, hdiag, E, F, dpq, soc_ranges, chol_out, L_out,
        C_out, B, K, R, nw, nrx, S, stream);
  if (nw == 11 && nrx == 7)
    return launch_fused_factor_n<T, 11, 7, true>(
        G, wrow, uv, ucoef, hdiag, E, F, dpq, soc_ranges, chol_out, L_out,
        C_out, B, K, R, nw, nrx, S, stream);
  return launch_fused_factor_n<T, kMaxN, kMaxN, false>(
      G, wrow, uv, ucoef, hdiag, E, F, dpq, soc_ranges, chol_out, L_out, C_out,
      B, K, R, nw, nrx, S, stream);
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
