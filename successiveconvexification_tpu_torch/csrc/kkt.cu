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
//   What a block waits on is its chain: n divisions forward, and backward
//   a serial chain of n divisions and n(n-1)/2 dependent FMAs.
//   Design: a warp takes 32 consecutive blocks, one a lane. The warp first
//   stages the 32 blocks of L and of b into shared memory together, by
//   cp.async (16-byte copies where the tensors are 16-byte aligned: a
//   warp's range is contiguous in device memory), so the loads are
//   coalesced and none sits inside a chain. Each lane then solves its own
//   block from shared memory with the first design's operations in their
//   order (forward: s = b_r, k ascending, a true division by L[r][r];
//   backward: s = y_r, k = r+1.. ascending, the division), so the results
//   are that design's bit for bit; a block's stride in shared memory is
//   odd, so the 32 lanes read 32 banks. x goes back through shared memory,
//   coalesced. The models' widths (nw = 17 for the rocket, 11 for the point
//   mass) are compiled into their own kernels, which unroll the chains and
//   keep y in registers; other widths take the kernel bounded by 32. One
//   warp a CTA: 400 CTAs at the main path's 12,800 blocks spread over all
//   132 SMs. More lanes a block (a row a lane) would not shorten the
//   backward chain, whose order is fixed, and would issue it once a block
//   instead of once per 32 blocks. The ragged edge is a bounds check,
//   where the TPU padded the batch with identity blocks.
//
// ---------------------------------------------------------------------------
// tridiag_solve: M u = r for a block-tridiagonal SPD M given its block
//   Cholesky factors (L_k lower, C_k = L_{k-1}^{-1} O_{k-1}, C_0 = 0):
//     forward   L_k v_k   = r_k - C_k' v_{k-1}
//     backward  L_k' u_k  = v_k - C_{k+1} u_{k+1}
//   Replaces pallas_kkt.py _tridiag_solve_fwd_kernel and
//   _tridiag_solve_bwd_kernel (two launches plus an XLA-built shifted copy
//   of C on the TPU). Bound on the H100: bytes (every L and C block read
//   once, ~6 n^2 flops per block); what a lane waits on is the latency of
//   its 2N dependent steps, each a chain of n divisions.
//   Design: ONE launch does both sweeps, one warp a lane and one lane a
//   CTA, so B=256 lanes spread over all 132 SMs (n <= 32; the models' 13
//   and 7 compiled in, other widths bounded by 32). The lane's L and C
//   blocks (and r) go to shared memory in chunks of 4 nodes by cp.async
//   (element-sized copies, see async.cuh), each chunk with an mbarrier the
//   sweep waits on, issued two chunks ahead: the forward sweep starts when
//   the first chunk lands. Where the lane's blocks fit with room for two
//   CTAs an SM (float32 at the main path: 2 x 33 KB), each chunk keeps its
//   slot and the backward sweep reads them again from shared memory;
//   otherwise (float64 there) three slots are refilled, forward then
//   backward. At each node lane i forms row i of the coupled right-hand
//   side (its C row or column prefetched into registers a node ahead), the
//   warp shares the n values by shuffles, and every lane runs the whole
//   triangular solve with L_k read from shared memory by all lanes alike:
//   the chain of divisions has no shuffle and no divergent branch in it.
//   Every value takes the first design's operations in their order (t
//   ascending in the C products, j ascending forward and descending
//   backward, a true division by the diagonal), so the results are its
//   results bit for bit: the f64 card-vs-CPU gate of the penalized path
//   has no margin against a change of summation order.
//
// ---------------------------------------------------------------------------
// chol: lower Cholesky factor of N independent n x n SPD blocks.
//   Replaces pallas_kkt.py _chol_kernel (pallas_kkt.chol: the stage-Hessian
//   factor of the unfused factorize, ipm.py:208; n = nw = 17, N = K = 50 on
//   the single-lane replan path, N = B K = 12,800 on the penalized path).
//   Bound on the H100: bytes (the lower triangle in, n^2 values out, n^3/3
//   flops a block); at the replan shapes launch latency sets its time.
//   What a block waits on is its chain of n pivots, each a shuffle, a
//   square root and a division, and what the batch waits on is issue slots:
//   a row a lane spends about a thousand warp instructions a 17 x 17 block.
//   Design: one warp a block, one row a lane, in registers: lane a loads
//   row a of the staged block with the upper triangle filled from the lower
//   one (row[b] = A[a][min(a, b)]: only the lower triangle is read, as
//   cholesky_ex does), and the warp factors it with warp_chol_lower, the
//   lean form of blocktri.cuh's warp_chol_rows: no selects (the upper
//   triangle is left garbage), a zero dividend's quotient taken as the
//   signed zero it is (off the division's slow path), and each column
//   handed on through shared memory as 16-byte broadcasts instead of one
//   shuffle an entry (at n = 17 in float32, 70 shared-memory accesses a
//   block on the pipe that also serves the shuffles, where the shuffles were
//   136; at 12,800 blocks on an H100, 0.0235 ms with the shuffles, 0.0208
//   with the exchange). Its operations on every kept value
//   are the first design's (left-looking sums, k ascending, a true division
//   by the square root of the pivot) in their order, so the results are
//   that design's bit for bit. The rocket's n = 17 is compiled in (the
//   whole factor straight-line code); other widths take the kernel bounded
//   by 32. Each warp owns a run of consecutive blocks and stages the next
//   one by cp.async (16-byte copies at the source's alignment phase, the
//   ragged ends by element) into a two-slot ring while the current one
//   factors. Row a goes back into the slot (L on and below the diagonal,
//   zeros above it) and the block leaves from the slot with coalesced
//   16-byte stores. The grid is one wave: the runs are as long as the
//   resident warps (the occupancy API) need to cover N; where N is small
//   (the replan path's 50) every block has its own warp and a CTA holds
//   fewer warps, so the CTAs spread over the SMs. Breakdown follows
//   ops/smallla.py chol (LAPACK potrf's test): a block with a pivot <= 0 or
//   NaN comes out ENTIRELY NaN (the IPM masks lanes by finiteness, so a
//   broken block that is finite in part would pass). An infinite pivot
//   factors on, as potrf's does: an infinite diagonal entry, zeros below
//   it, and the factor of the rest. A NaN or infinite entry of L below the
//   diagonal feeds the pivot of its row, which then comes out NaN or -inf,
//   so the pivot test catches such inputs in the lower triangle.
//
// ---------------------------------------------------------------------------
// cho_solve: (L L') X = B for N independent blocks, B and X n x m (m <= 32).
//   Replaces pallas_kkt.py _cho_solve_kernel as launched by cho_solve (the
//   matrix right-hand sides H^-1 E', H^-1 F' of the unfused factorize,
//   ipm.py:192-193; n = 17, m = 13, N = K-1 = 49 on the replan path and
//   B (K-1) = 12,544 on the penalized path). Bound on the H100: bytes (L's
//   lower triangle and B read once, X written once, 2 n^2 m flops a block).
//   What a lane waits on is its chain: n dependent divisions forward and
//   n backward, with n(n-1)/2 dependent FMAs each way.
//   Design: one (block, column) pair a lane, so every lane works: a CTA
//   takes nbc consecutive blocks (32 where they fit with room for two CTAs
//   an SM) and ceil(nbc m / 32) warps, lane p of the CTA the pair (p / m,
//   p % m); at m = 13 that is 13 warps for 32 blocks, none idle, and in
//   float32 three such CTAs share an SM (the launch bound caps a thread at
//   52 registers; it needs 40, since each row's loads of L wait for the
//   rows before it instead of all being hoisted ahead of the chain). The CTA
//   first stages its blocks' L and B into shared memory by cp.async,
//   16-byte copies wherever source and destination share their alignment
//   (each block is placed at its source's offset modulo 16 bytes; the
//   ragged ends go by element), so no load sits inside a chain. L is read
//   in place with a lane stride (the caller's chol_Hw[:, :-1] and
//   chol_Hw[:, 1:], blocks l_inner to a lane, lanes l_outer elements
//   apart); B either row-major (N, n, m) or as the transpose of a
//   contiguous (N, m, n) (b_trans: E' and F' of the IPM's E and F, whose
//   rows are the columns here). Each lane loads its column of B into
//   registers and solves with L read from shared memory: the lanes of one
//   block read the same entry (a broadcast), and the few blocks of a warp
//   sit at offsets that fall in different banks. The rocket's (n, m) =
//   (17, 13) is compiled into its own kernel (chains unrolled, the column
//   in registers); other widths take the kernel bounded by 32. Every value
//   takes the first design's operations in their order (forward: s = b_r,
//   k ascending, the division by L[r][r]; backward: s = y_r, k = r+1..
//   ascending, the division; lane_cho_solve, which fused_chol_solve
//   shares), with the division by div_zs (divide.cuh:
//   the same bits, a zero dividend off the slow path; E and F hold many
//   exact zeros). A NaN or infinite factor passes through as in the first
//   design. X goes back through shared memory, coalesced. The ragged edge
//   is a bounds check, where the TPU padded the batch with identity blocks.
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
//   once, about 2.3 n^3 flops a block). The steps along N are sequential:
//   what a lane waits on is N steps of dependent divisions, roots and
//   shuffles.
//   Design: one warp a lane and one lane a CTA, so B = 256 lanes spread over
//   all 132 SMs (as tridiag_solve). Each step is warp_tri_step
//   (blocktri.cuh, the fused factorization's recurrence step): C_k, S_k and
//   L_k in registers, lane c a column of C, lane a a row of S and L, with
//   the models' width (the rocket's nrx = 13) compiled in and other widths
//   bounded by 32; C_k and L_k go to device memory from its stores. D_k and
//   O_{k-1} come into shared memory in chunks of up to 4 nodes by cp.async,
//   a ring of three slots, each chunk with an mbarrier, issued two chunks
//   ahead, so a step never waits on device memory. L_{k-1} and C_k stay in
//   shared memory between steps. The TPU carried L_{k-1} in VMEM scratch
//   between grid steps along N; here the loop along N runs inside the warp.
//   Every value takes the first design's operations (blocktri.cuh's step:
//   left-looking sums, k ascending, a true division by the square root of
//   the pivot) in their order, so the results are that design's bit for
//   bit wherever no block breaks down: the penalized path's f64
//   card-vs-CPU gate has no margin against a change of order. Breakdown
//   follows smallla.blocktridiag_factor: a block with a pivot <= 0 or NaN
//   comes out entirely NaN, and so does every later block of its lane (a NaN
//   L_k makes C_{k+1} NaN), which the IPM's stall exit relies on; an
//   infinite pivot factors on, as `chol` does.
//
// ---------------------------------------------------------------------------
// fused_chol_solve: A X = B for N independent SPD blocks, A n x n, B and X
//   n x m (n, m <= 32), the factor and both solves in one launch.
//   Replaces pallas_kkt.py _fused_chol_solve_kernel (fused_chol_solve, which
//   the JAX package runs only in tests/test_pallas_kkt.py, as a layout test
//   vehicle: N = 300, (n, m) = (13, 2)). Bound on the H100: bytes (A's
//   lower triangle and B read once, X written once; n^3/3 + 2 n^2 m flops
//   a block).
//   Design: `chol`'s factor and `cho_solve`'s solve in one CTA, the factor
//   never leaving shared memory. A CTA takes nbc consecutive blocks and
//   stages their A and B by cp.async at the sources' alignment phase. Its
//   warps factor the blocks as `chol` does (mirrored rows,
//   warp_chol_lower), each L back into its A slot and one breakdown flag a
//   block in shared memory; then one (block, column) pair a lane solves
//   with cho_solve's operations (lane_cho_solve, the one device function
//   both kernels call). X leaves through shared memory, coalesced. The CTA
//   has enough warps for both phases: ceil(nbc m / 32) for the solve, and
//   one a block to factor up to 16 (so none factors more than two
//   blocks); nbc follows N, so the vehicle's 300 blocks spread over all
//   SMs and the 12,800 of a sweep's stage Hessians fill whole waves. The vehicle's (13, 2) and the
//   stage-Hessian shape (17, 13) are compiled in; other widths take the
//   kernel bounded by 32. A block whose factor breaks down (`chol`'s test)
//   comes out entirely NaN; at an infinite pivot the factor goes on, and
//   the solves give that unknown 0, as smallla.cho_solve does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async.cuh"
#include "blocktri.cuh"
#include "divide.cuh"

namespace {

// cho_solve_vec: blocks a warp, one a lane (a CTA is one warp), where they
// fit in shared memory with room for two CTAs an SM (fewer for widths
// above 20 in float64 and 29 in float32).
constexpr int kVecBlocks = 32;

// dst (shared) <- src (global), `count` elements by the warp: 16-byte
// copies where src is 16-byte aligned (dst is, by the caller's layout),
// element copies for the rest. Not waited for.
template <typename T>
__device__ __forceinline__ void warp_stage(T* dst, const T* src, int count,
                                           int li) {
  constexpr int V = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = count / V;
    for (int i = li; i < nv; i += 32) cp_async_16(dst + i * V, src + i * V);
    done = nv * V;
  }
  for (int i = done + li; i < count; i += 32) cp_async_elem(dst + i, src + i);
}

// nb consecutive blocks of `len` elements from src (global) to dst
// (shared) at a stride of `stride` >= len elements, by the warp.
template <typename T>
__device__ __forceinline__ void warp_stage_blocks(T* dst, const T* src, int nb,
                                                  int len, int stride,
                                                  int li) {
  if (stride == len) {
    warp_stage(dst, src, nb * len, li);
    return;
  }
  for (int t = li; t < nb * len; t += 32) {
    const int blk = t / len;
    cp_async_elem(dst + blk * stride + (t - blk * len), src + t);
  }
}

// An odd stride (in elements) for blocks of `len` in shared memory: lanes
// that read the same entry of their own blocks then hit 32 banks (4-byte
// words; 8-byte ones are served half a warp at a time).
__host__ __device__ __forceinline__ int odd_stride(int len) { return len | 1; }

// NMAX: n when EXACT, else its bound, 32 (the launch dispatches).
template <typename T, int NMAX, bool EXACT>
__global__ void __launch_bounds__(32)
    cho_solve_vec_kernel(const T* __restrict__ L, const T* __restrict__ b,
                         T* __restrict__ x, int N, int n, int nbw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (EXACT) n = NMAX;
  const int li = threadIdx.x;
  const int blk0 = blockIdx.x * nbw;
  const int nb = min(nbw, N - blk0);
  const int nn = n * n;
  const int sl = odd_stride(nn), sb = odd_stride(n);
  T* Ls = reinterpret_cast<T*>(smem_raw);
  T* bs = reinterpret_cast<T*>(
      smem_raw + align16((size_t)nbw * sl * sizeof(T)));
  warp_stage_blocks(Ls, L + (size_t)blk0 * nn, nb, nn, sl, li);
  warp_stage_blocks(bs, b + (size_t)blk0 * n, nb, n, sb, li);
  cp_async_wait_all();
  __syncwarp();
  if (li < nb) {
    const T* l = Ls + li * sl;
    T* v = bs + li * sb;  // b, then x
    T y[NMAX];
#pragma unroll
    for (int r = 0; r < NMAX; ++r) {
      if (EXACT || r < n) {
        T s = v[r];
#pragma unroll
        for (int k = 0; k < r; ++k) s -= l[r * n + k] * y[k];
        y[r] = s / l[r * n + r];
      }
    }
#pragma unroll
    for (int r = NMAX - 1; r >= 0; --r) {
      if (EXACT || r < n) {
        T s = y[r];
#pragma unroll
        for (int k = r + 1; k < NMAX; ++k)
          if (EXACT || k < n) s -= l[k * n + r] * y[k];
        y[r] = s / l[r * n + r];
      }
    }
#pragma unroll
    for (int r = 0; r < NMAX; ++r)
      if (EXACT || r < n) v[r] = y[r];
  }
  __syncwarp();
  T* xb = x + (size_t)blk0 * n;
  for (int t = li; t < nb * n; t += 32) {
    const int blk = t / n;
    xb[t] = bs[blk * sb + (t - blk * n)];
  }
}

// Column lc of an n x n row-major block in shared memory.
template <typename T, int NMAX>
__device__ __forceinline__ void load_col(const T* M, int n, int lc,
                                         T (&out)[NMAX]) {
#pragma unroll
  for (int t = 0; t < NMAX; ++t) out[t] = t < n ? M[t * n + lc] : T(0);
}

// Row lc of an n x n row-major block in shared memory.
template <typename T, int NMAX>
__device__ __forceinline__ void load_row(const T* M, int n, int lc,
                                         T (&out)[NMAX]) {
#pragma unroll
  for (int t = 0; t < NMAX; ++t) out[t] = t < n ? M[lc * n + t] : T(0);
}

// Entry li of a register array (li < NMAX).
template <typename T, int NMAX>
__device__ __forceinline__ T pick(const T (&x)[NMAX], int li) {
  T out = x[0];
#pragma unroll
  for (int t = 1; t < NMAX; ++t)
    if (t == li) out = x[t];
  return out;
}

// One warp a lane, one lane a CTA (see the note at the top). Slot layout:
// the chunk's L blocks, its C blocks, its r rows. `resident`: every chunk
// has its own slot; otherwise three slots are refilled two chunks ahead,
// forward in the forward sweep and backward in the backward one (which
// does not use r).
// NMAX: n when EXACT, else its bound, 32 (the launch dispatches).
template <typename T, int NMAX, bool EXACT>
__global__ void __launch_bounds__(32)
    tridiag_solve_kernel(const T* __restrict__ L, const T* __restrict__ C,
                         const T* __restrict__ r, T* __restrict__ u, int N,
                         int n, int ch, int nslots, int resident) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (EXACT) n = NMAX;
  const unsigned full = 0xffffffffu;
  const int li = threadIdx.x;
  const int lane_b = blockIdx.x;
  const bool act = li < n;
  const int lc = act ? li : 0;  // lanes >= n read row 0 and write nothing
  const size_t nn = (size_t)n * n;
  const size_t v_off = align16((size_t)nslots * sizeof(uint64_t));
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  T* vs = reinterpret_cast<T*>(smem_raw + v_off);  // v_k, row i by lane i
  T* ring = reinterpret_cast<T*>(
      smem_raw + v_off + align16((size_t)N * n * sizeof(T)));
  const size_t slot_elems = (size_t)ch * (2 * nn + n);
  const T* Lb = L + (size_t)lane_b * N * nn;
  const T* Cb = C + (size_t)lane_b * N * nn;
  const T* rb = r + (size_t)lane_b * N * n;
  T* ub = u + (size_t)lane_b * N * n;
  const int nc = (N + ch - 1) / ch;
  // the copy sequence: chunks 0..nc-1, then (streaming) nc-1..0 again
  const int nseq = resident ? nc : 2 * nc;

  if (li == 0)
    for (int s = 0; s < nslots; ++s) mbar_init(&bar[s], 32);
  mbar_fence_init();
  __syncwarp();

  auto issue = [&](int s) {
    if (s >= nseq) return;
    const int c = s < nc ? s : 2 * nc - 1 - s;
    const int k0 = c * ch;
    const int blk = min(ch, N - k0) * (int)nn;
    T* sl = ring + (size_t)(s % nslots) * slot_elems;
    for (int i = li; i < blk; i += 32) {
      cp_async_elem(sl + i, Lb + k0 * nn + i);
      cp_async_elem(sl + ch * nn + i, Cb + k0 * nn + i);
    }
    if (s < nc) {
      const int nr = min(ch, N - k0) * n;
      for (int i = li; i < nr; i += 32)
        cp_async_elem(sl + 2 * ch * nn + i, rb + (size_t)k0 * n + i);
    }
    cp_async_mbar_arrive(&bar[s % nslots]);
  };

  // forward sweep: L_k v_k = r_k - C_k' v_{k-1}
  T v[NMAX];  // v_{k-1}, then v_k, on every lane
#pragma unroll
  for (int t = 0; t < NMAX; ++t) v[t] = T(0);
  issue(0);
  issue(1);
  for (int c = 0; c < nc; ++c) {
    mbar_wait(&bar[c % nslots], (c / nslots) & 1);
    __syncwarp();  // every lane is done with the slot issue(c + 2) refills
    issue(c + 2);
    const T* sl = ring + (size_t)(c % nslots) * slot_elems;
    const int k0 = c * ch, cnt = min(ch, N - k0);
    T cn[NMAX];  // column lc of the next node's C, prefetched
    load_col<T, NMAX>(sl + ch * nn, n, lc, cn);
    T rn = sl[2 * ch * nn + lc];
    for (int i = 0; i < cnt; ++i) {
      T cr[NMAX];
#pragma unroll
      for (int t = 0; t < NMAX; ++t) cr[t] = cn[t];
      T val = rn;  // row lc of r_k - C_k' v_{k-1}
      if (i + 1 < cnt) {
        load_col<T, NMAX>(sl + (ch + i + 1) * nn, n, lc, cn);
        rn = sl[2 * ch * nn + (i + 1) * n + lc];
      }
      const int k = k0 + i;
      const T* Lk = sl + i * nn;
      if (k > 0) {
#pragma unroll
        for (int t = 0; t < NMAX; ++t)
          if (t < n) val -= cr[t] * v[t];
      }
      T s[NMAX];
#pragma unroll
      for (int t = 0; t < NMAX; ++t)
        s[t] = t < n ? __shfl_sync(full, val, t) : T(0);
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        if (j < n) {
          v[j] = s[j] / Lk[j * n + j];
#pragma unroll
          for (int t = j + 1; t < NMAX; ++t)
            if (t < n) s[t] -= Lk[t * n + j] * v[j];
        }
      }
      if (act) vs[(size_t)k * n + li] = pick<T, NMAX>(v, li);
    }
  }
  __syncwarp();

  // backward sweep: L_k' u_k = v_k - C_{k+1} u_{k+1}
  T w[NMAX];      // u_{k+1}, then u_k, on every lane
  T cnext[NMAX];  // row lc of C_{k+1}
#pragma unroll
  for (int t = 0; t < NMAX; ++t) w[t] = cnext[t] = T(0);
  for (int s = nc; s < 2 * nc; ++s) {
    const int c = 2 * nc - 1 - s;
    int slot = c;
    if (!resident) {
      mbar_wait(&bar[s % nslots], (s / nslots) & 1);
      __syncwarp();
      issue(s + 2);
      slot = s % nslots;
    }
    const T* sl = ring + (size_t)slot * slot_elems;
    const int k0 = c * ch, cnt = min(ch, N - k0);
    T cn[NMAX];  // row lc of the next (lower) node's C, prefetched
    load_row<T, NMAX>(sl + (ch + cnt - 1) * nn, n, lc, cn);
    for (int i = cnt - 1; i >= 0; --i) {
      T cr[NMAX];
#pragma unroll
      for (int t = 0; t < NMAX; ++t) cr[t] = cn[t];
      if (i > 0) load_row<T, NMAX>(sl + (ch + i - 1) * nn, n, lc, cn);
      const int k = k0 + i;
      const T* Lk = sl + i * nn;
      T val = vs[(size_t)k * n + lc];  // row lc of v_k - C_{k+1} u_{k+1}
      if (k + 1 < N) {
#pragma unroll
        for (int t = 0; t < NMAX; ++t)
          if (t < n) val -= cnext[t] * w[t];
      }
      T s[NMAX];
#pragma unroll
      for (int t = 0; t < NMAX; ++t)
        s[t] = t < n ? __shfl_sync(full, val, t) : T(0);
#pragma unroll
      for (int j = NMAX - 1; j >= 0; --j) {
        if (j < n) {
          w[j] = s[j] / Lk[j * n + j];
#pragma unroll
          for (int t = 0; t < j; ++t) s[t] -= Lk[j * n + t] * w[j];
        }
      }
      if (act) ub[(size_t)k * n + li] = pick<T, NMAX>(w, li);
#pragma unroll
      for (int t = 0; t < NMAX; ++t) cnext[t] = cr[t];
    }
  }
}

// p's offset in elements from 16-byte alignment (its phase).
template <typename T>
__device__ __forceinline__ int phase_of(const T* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) / sizeof(T)) % (16 / sizeof(T)));
}

// dst_slot (shared, 16-byte aligned) <- src (global), `count` elements by
// threads li = 0.. of nl, placed at dst_slot + ph where ph is src's phase,
// so that 16-byte copies fit wherever the range allows; the ragged ends go
// by element. Returns ph. Not waited for.
template <typename T>
__device__ __forceinline__ int stage_aligned(T* dst_slot, const T* src,
                                             int count, int li, int nl) {
  constexpr int V = 16 / sizeof(T);
  const int ph = phase_of(src);
  T* dst = dst_slot + ph;
  const int head = min(count, (V - ph) % V);
  const int nv = (count - head) / V;
  for (int i = li; i < head; i += nl) cp_async_elem(dst + i, src + i);
  for (int i = li; i < nv; i += nl)
    cp_async_16(dst + head + i * V, src + head + i * V);
  for (int i = head + nv * V + li; i < count; i += nl)
    cp_async_elem(dst + i, src + i);
  return ph;
}

// dst (global) <- slot + ph (shared, the slot 16-byte aligned), `count`
// elements by threads li = 0.. of nl: 16-byte stores wherever dst's phase
// is ph (stage_aligned's placement when source and destination share
// their phase), the ragged ends by element; element stores, coalesced,
// otherwise.
template <typename T>
__device__ __forceinline__ void store_aligned(T* dst, const T* slot, int ph,
                                              int count, int li, int nl) {
  constexpr int V = 16 / sizeof(T);
  const T* src = slot + ph;
  int head = count, nv = 0;
  if (phase_of(dst) == ph) {
    head = min(count, (V - ph) % V);
    nv = (count - head) / V;
  }
  for (int i = li; i < head; i += nl) dst[i] = src[i];
  for (int i = li; i < nv; i += nl)
    reinterpret_cast<int4*>(dst + head)[i] =
        reinterpret_cast<const int4*>(src + head)[i];
  for (int i = head + nv * V + li; i < count; i += nl) dst[i] = src[i];
}

// Elements a block's slot of L holds in shared memory: n*n and room for
// its phase (stage_aligned), rounded to 16 bytes.
template <typename T>
__host__ __device__ __forceinline__ int cho_l_slot(int nn) {
  constexpr int V = 16 / sizeof(T);
  return (nn + V - 1 + V - 1) / V * V;
}

// Values of a column exchange buffer of warp_chol_lower: NMAX rounded up
// to 16 bytes.
template <typename T, int NMAX>
__host__ __device__ constexpr int xcol_len() {
  return (NMAX + 16 / (int)sizeof(T) - 1) / (16 / (int)sizeof(T)) *
         (16 / (int)sizeof(T));
}

// The lean form of blocktri.cuh's warp_chol_rows, for the chol kernels:
// the same operations on every value on and below the diagonal, in their
// order (so the same bits), and less around them. No select keeps the
// entries above the diagonal, which come out garbage (no kept value reads
// one); no guard skips the columns c >= n (none is read either); a zero
// dividend divides d by itself instead, its quotient taken as the signed
// zero s * copysign(1, d), which is s / d's bits for every d but a zero or
// NaN one, that is, in every block that does not break down (divide.cuh),
// so no quotient takes the division's slow path; and the column L[.][j]
// goes through shared memory: each lane writes its entry into `xcol` (2
// xcol_len values the warp owns, 16-byte aligned, the two halves taking
// turns) and reads the entries c > j back as 16-byte broadcasts, where
// warp_chol_rows shuffles them one by one.
template <typename T, int NMAX>
__device__ __forceinline__ bool warp_chol_lower(T (&row)[NMAX], int n, int li,
                                                T* xcol) {
  static_assert(NMAX >= 1 && NMAX <= kMaxN, "one lane a row");
  constexpr int V = 16 / sizeof(T), NP = xcol_len<T, NMAX>();
  const unsigned full = 0xffffffffu;
  const int lc = li < n ? li : 0;
  bool bad = false;  // warp-uniform: every lane tests the same pivot
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    if (j < n) {
      const T piv = __shfl_sync(full, row[j], j);
      bad = bad || !(piv > T(0));
      const T d = sqrt(piv);
      const bool z = row[j] == T(0);
      const T q = (z ? d : row[j]) / d;
      row[j] = lc == j ? d : (z ? row[j] * copysign(T(1), d) : q);
      T* col = xcol + (j & 1) * NP;
      if (li < NMAX) col[li] = row[j];  // L[li][j] where li >= j
      __syncwarp();
      T lcol[NP];  // L[c][j] for the 16-byte pieces that hold c > j
#pragma unroll
      for (int v = (j + 1) / V; v < NP / V; ++v) {
        if constexpr (V == 4) {
          const float4 w = reinterpret_cast<const float4*>(col)[v];
          lcol[4 * v] = w.x;
          lcol[4 * v + 1] = w.y;
          lcol[4 * v + 2] = w.z;
          lcol[4 * v + 3] = w.w;
        } else {
          const double2 w = reinterpret_cast<const double2*>(col)[v];
          lcol[2 * v] = w.x;
          lcol[2 * v + 1] = w.y;
        }
      }
#pragma unroll
      for (int c = j + 1; c < NMAX; ++c) row[c] -= row[j] * lcol[c];
    }
  }
  return bad;
}

// The n x n block at `a` (shared memory, row-major, the lower triangle
// read) factored in place by the warp, one row a lane: lane a loads row a
// with the upper triangle mirrored from the lower (row[b] = A[a][min(a,
// b)]; lanes >= n shadow row 0), factors with warp_chol_lower (xcol its
// exchange buffer) and writes row a back: L on and below the diagonal and
// zeros above it, or NaN everywhere when a pivot is <= 0 or NaN. Returns
// that breakdown flag, on every lane; the warp syncs before it writes and
// before it returns.
template <typename T, int NMAX>
__device__ __forceinline__ bool warp_factor_slot(T* a, int n, int li,
                                                 T* xcol) {
  const int lc = li < n ? li : 0;
  T row[NMAX];
#pragma unroll
  for (int b = 0; b < NMAX; ++b)
    row[b] = b < n ? a[lc * n + (b <= lc ? b : lc)] : T(0);
  const bool bad = warp_chol_lower<T, NMAX>(row, n, li, xcol);
  __syncwarp();  // every lane has read its row
  if (li < n) {
    const T nan = quiet_nan<T>();
#pragma unroll
    for (int b = 0; b < NMAX; ++b)
      if (b < n) a[li * n + b] = bad ? nan : (b <= li ? row[b] : T(0));
  }
  __syncwarp();
  return bad;
}

// Warps a chol CTA holds at most (fewer where N is small).
constexpr int kCholWarps = 4;

// Elements of shared memory a chol warp owns: its two slots and its
// column exchange buffer.
template <typename T, int NMAX>
__host__ __device__ __forceinline__ int chol_warp_elems(int nn) {
  return 2 * cho_l_slot<T>(nn) + 2 * xcol_len<T, NMAX>();
}

// One warp a run of bpw consecutive blocks (see the note at the top): the
// warp's two slots take turns, block i + 1 staged by cp.async into one
// while block i factors in the other and leaves from it.
// NMAX: n when EXACT, else its bound, 32 (the launch dispatches).
template <typename T, int NMAX, bool EXACT>
__global__ void __launch_bounds__(kCholWarps * 32)
    chol_kernel(const T* __restrict__ A, T* __restrict__ L, int N, int n,
                int bpw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (EXACT) n = NMAX;
  const int warp = threadIdx.x / 32, li = threadIdx.x % 32;
  const int nn = n * n, sl = cho_l_slot<T>(nn);
  const int b0 = (blockIdx.x * (blockDim.x / 32) + warp) * bpw;
  const int nb = min(bpw, N - b0);
  if (nb <= 0) return;  // the whole warp leaves together
  T* ring = reinterpret_cast<T*>(smem_raw) +
            (size_t)warp * chol_warp_elems<T, NMAX>(nn);
  T* xcol = ring + 2 * sl;
  stage_aligned(ring, A + (size_t)b0 * nn, nn, li, 32);
  cp_async_commit();
  for (int i = 0; i < nb; ++i) {
    const size_t off = (size_t)(b0 + i) * nn;
    if (i + 1 < nb)
      stage_aligned(ring + ((i + 1) & 1) * sl, A + off + nn, nn, li, 32);
    cp_async_commit();      // (empty at the last block: the count stays)
    cp_async_wait_prior();  // block i has landed
    __syncwarp();
    T* slot = ring + (i & 1) * sl;
    const int ph = phase_of(A + off);
    warp_factor_slot<T, NMAX>(slot + ph, n, li, xcol);
    store_aligned(L + off, slot, ph, nn, li, 32);
    __syncwarp();  // every lane is done with the slot block i + 2 refills
  }
}

// (L L') y = b for one column by one thread, y holding b on entry and x on
// return: forward s = b_r, k ascending, the division by L[r][r]; backward
// s = y_r, k = r+1.. ascending, the division; each division by div_zs
// (divide.cuh: the same bits, a zero dividend off the slow path). These
// are the first designs' operations in their order. `l`: the block's L,
// n x n row-major, in shared memory (its lower triangle and diagonal
// read). cho_solve and fused_chol_solve both solve here.
template <typename T, int NMAX, bool EXACT>
__device__ __forceinline__ void lane_cho_solve(const T* l, int n,
                                               T (&y)[NMAX]) {
  // forward: L y = b. The empty asm keeps a row's loads of L from being
  // hoisted above the rows before it: the chain is serial, and loads in
  // flight for every row would take the registers that let three CTAs
  // share an SM.
#pragma unroll
  for (int r = 0; r < NMAX; ++r) {
    if (EXACT || r < n) {
      asm volatile("" ::: "memory");
      T s = y[r];
#pragma unroll
      for (int k = 0; k < r; ++k) s -= l[r * n + k] * y[k];
      y[r] = div_zs(s, l[r * n + r]);
    }
  }
  // backward: L' x = y
#pragma unroll
  for (int r = NMAX - 1; r >= 0; --r) {
    if (EXACT || r < n) {
      asm volatile("" ::: "memory");
      T s = y[r];
#pragma unroll
      for (int k = r + 1; k < NMAX; ++k)
        if (EXACT || k < n) s -= l[k * n + r] * y[k];
      y[r] = div_zs(s, l[r * n + r]);
    }
  }
}

// One (block, column) pair a lane (see the note at the top). Shared
// memory: nbc slots of L, then the CTA's B range (and X, which overwrites
// it once every lane holds its column).
// NMAX, MMAX: n and m when EXACT, else their bound, 32 (the launch
// dispatches).
template <typename T, int NMAX, int MMAX, bool EXACT>
__global__ void __launch_bounds__(EXACT ? (32 * MMAX + 31) / 32 * 32 : 512,
                                  EXACT && sizeof(T) == 4 ? 3 : 1)
    cho_solve_kernel(const T* __restrict__ L, const T* __restrict__ B,
                     T* __restrict__ X, int N, int n, int m, int l_inner,
                     int l_outer, int b_trans, int nbc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (EXACT) {
    n = NMAX;
    m = MMAX;
  }
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, li = tid % 32, nwarps = nthr / 32;
  const int blk0 = blockIdx.x * nbc;
  const int nb = min(nbc, N - blk0);
  const int nn = n * n, nm = n * m;
  const int sl = cho_l_slot<T>(nn);
  T* Ls = reinterpret_cast<T*>(smem_raw);
  T* Bs = Ls + (size_t)nbc * sl;  // 16-byte aligned, as sl is a multiple of V
  auto l_src = [&](int j) {
    const int g = blk0 + j;
    return L + (size_t)(g / l_inner) * l_outer + (size_t)(g % l_inner) * nn;
  };
  for (int j = warp; j < nb; j += nwarps)
    stage_aligned(Ls + (size_t)j * sl, l_src(j), nn, li, 32);
  const int phb = stage_aligned(Bs, B + (size_t)blk0 * nm, nb * nm, tid, nthr);
  cp_async_wait_all();
  __syncthreads();

  const int j = tid / m, c = tid - j * m;
  const bool act = j < nb;
  T y[NMAX];  // the column of B, then of Y, then of X
  if (act) {
    const T* bc = Bs + phb + (size_t)j * nm + (b_trans ? c * n : c);
    const int bs = b_trans ? 1 : m;
#pragma unroll
    for (int r = 0; r < NMAX; ++r)
      if (EXACT || r < n) y[r] = bc[r * bs];
  }
  __syncthreads();  // every column read before X overwrites B
  if (act) {
    lane_cho_solve<T, NMAX, EXACT>(
        Ls + (size_t)j * sl + phase_of(l_src(j)), n, y);
    T* xc = Bs + (size_t)j * nm + c;  // X row-major, from the slot's start
#pragma unroll
    for (int r = 0; r < NMAX; ++r)
      if (EXACT || r < n) xc[r * m] = y[r];
  }
  __syncthreads();
  T* xb = X + (size_t)blk0 * nm;
  for (int t = tid; t < nb * nm; t += nthr) xb[t] = Bs[t];
}

// Threads a fused_chol_solve CTA holds at most.
constexpr int kFcsThreads = 512;

// A CTA nbc consecutive blocks (see the note at the top). Shared memory:
// nbc slots of A (then L), the CTA's B range (then X), a column exchange
// buffer a warp (warp_chol_lower), a breakdown flag a block.
// NMAX, MMAX: n and m when EXACT, else their bound, 32 (the launch
// dispatches).
template <typename T, int NMAX, int MMAX, bool EXACT>
__global__ void __launch_bounds__(kFcsThreads,
                                  EXACT && sizeof(T) == 4 ? 2 : 1)
    fused_chol_solve_kernel(const T* __restrict__ A, const T* __restrict__ B,
                            T* __restrict__ X, int N, int n, int m, int nbc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (EXACT) {
    n = NMAX;
    m = MMAX;
  }
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, li = tid % 32, nwarps = nthr / 32;
  const int blk0 = blockIdx.x * nbc;
  const int nb = min(nbc, N - blk0);
  const int nn = n * n, nm = n * m;
  const int sl = cho_l_slot<T>(nn);
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + (size_t)nbc * sl;  // 16-byte aligned, as sl is a multiple of V
  T* xcols = reinterpret_cast<T*>(
      reinterpret_cast<unsigned char*>(Bs) +
      align16(((size_t)nbc * nm + 16 / sizeof(T)) * sizeof(T)));
  int* bad = reinterpret_cast<int*>(xcols + nwarps * 2 * xcol_len<T, NMAX>());
  const T* A0 = A + (size_t)blk0 * nn;
  for (int j = warp; j < nb; j += nwarps)
    stage_aligned(As + (size_t)j * sl, A0 + (size_t)j * nn, nn, li, 32);
  const int phb = stage_aligned(Bs, B + (size_t)blk0 * nm, nb * nm, tid, nthr);
  cp_async_wait_all();
  __syncthreads();

  // factor: warp w the blocks w, w + nwarps, ..., L back into the A slot
  for (int j = warp; j < nb; j += nwarps) {
    const bool bj = warp_factor_slot<T, NMAX>(
        As + (size_t)j * sl + phase_of(A0 + (size_t)j * nn), n, li,
        xcols + warp * 2 * xcol_len<T, NMAX>());
    if (li == 0) bad[j] = bj;
  }
  __syncthreads();

  // solve: lane p of the CTA the pair (block p / m, column p % m)
  const int j = tid / m, c = tid - j * m;
  const bool act = j < nb;
  T y[NMAX];  // the column of B, then of Y, then of X
  if (act) {
    const T* bc = Bs + phb + (size_t)j * nm + c;
#pragma unroll
    for (int r = 0; r < NMAX; ++r)
      if (EXACT || r < n) y[r] = bc[r * m];
  }
  __syncthreads();  // every column read before X overwrites B
  T* Xb = X + (size_t)blk0 * nm;
  const int phx = phase_of(Xb);
  if (act) {
    if (bad[j]) {
      const T nan = quiet_nan<T>();
#pragma unroll
      for (int r = 0; r < NMAX; ++r) y[r] = nan;
    } else {
      lane_cho_solve<T, NMAX, EXACT>(
          As + (size_t)j * sl + phase_of(A0 + (size_t)j * nn), n, y);
    }
    T* xc = Bs + phx + (size_t)j * nm + c;  // X row-major at X's phase
#pragma unroll
    for (int r = 0; r < NMAX; ++r)
      if (EXACT || r < n) xc[r * m] = y[r];
  }
  __syncthreads();
  store_aligned(Xb, Bs, phx, nb * nm, tid, nthr);
}

// One warp a lane, one lane a CTA (see the note at the top). Shared
// memory: the ring's mbarriers, L_{k-1} (overwritten by L_k), C_k, and a
// ring of nslots slots of ch nodes, each slot the chunk's D blocks and then
// its O blocks (O_{k-1} beside D_k; node 0 has none).
// NMAX: n when EXACT, else its bound, 32 (the launch dispatches).
template <typename T, int NMAX, bool EXACT>
__global__ void __launch_bounds__(32)
    tridiag_factor_kernel(const T* __restrict__ D, const T* __restrict__ O,
                          T* __restrict__ L, T* __restrict__ C, int N, int n,
                          int ch, int nslots) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (EXACT) n = NMAX;
  const int li = threadIdx.x;
  const int lane_b = blockIdx.x;
  const size_t nn = (size_t)n * n;
  const size_t w_off = align16((size_t)nslots * sizeof(uint64_t));
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  T* sL = reinterpret_cast<T*>(smem_raw + w_off);  // L_{k-1}, then L_k
  T* sC = sL + nn;                                   // C_k
  T* ring = reinterpret_cast<T*>(smem_raw + w_off +
                                 align16(2 * nn * sizeof(T)));
  const size_t slot_elems = (size_t)ch * 2 * nn;
  const T* Db = D + (size_t)lane_b * N * nn;
  const T* Ob = O + (size_t)lane_b * (N - 1) * nn;
  T* Lb = L + (size_t)lane_b * N * nn;
  T* Cb = C + (size_t)lane_b * N * nn;
  const int nc = (N + ch - 1) / ch;

  if (li == 0)
    for (int s = 0; s < nslots; ++s) mbar_init(&bar[s], 32);
  mbar_fence_init();
  __syncwarp();

  // chunk c: D_k and O_{k-1} of its nodes k0 .. k0 + cnt - 1
  auto issue = [&](int c) {
    if (c >= nc) return;
    const int k0 = c * ch, cnt = min(ch, N - k0);
    T* sl = ring + (size_t)(c % nslots) * slot_elems;
    const int nd = cnt * (int)nn;
    for (int i = li; i < nd; i += 32)
      cp_async_elem(sl + i, Db + k0 * nn + i);
    const int o0 = k0 == 0 ? 1 : 0;  // the chunk's first node with an O
    const int no = (cnt - o0) * (int)nn;
    T* so = sl + (ch + o0) * nn;
    for (int i = li; i < no; i += 32)
      cp_async_elem(so + i, Ob + (k0 + o0 - 1) * nn + i);
    cp_async_mbar_arrive(&bar[c % nslots]);
  };

  issue(0);
  issue(1);
  for (int c = 0; c < nc; ++c) {
    mbar_wait(&bar[c % nslots], (c / nslots) & 1);
    __syncwarp();  // every lane is done with the slot issue(c + 2) refills
    issue(c + 2);
    const T* sl = ring + (size_t)(c % nslots) * slot_elems;
    const int k0 = c * ch, cnt = min(ch, N - k0);
    for (int i = 0; i < cnt; ++i) {
      const int k = k0 + i;
      warp_tri_step<T, NMAX>(sL, k == 0 ? nullptr : sl + (ch + i) * nn,
                             sl + i * nn, sC, sL, n, li, Cb + k * nn,
                             Lb + k * nn);
    }
  }
}

// The card's SM count and the CTAs of `kernel` an SM holds at `threads`
// threads and `smem` bytes of dynamic shared memory a CTA (at least 1).
template <typename K>
int sm_occupancy(K kernel, int threads, size_t smem, int* sms, int* ctas) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, threads,
                                                        smem);
  *ctas = max(*ctas, 1);
  return (int)err;
}

template <typename T, int NMAX, bool EXACT>
int launch_chol_n(const void* A, void* L, int N, int n, void* stream) {
  const auto kernel = chol_kernel<T, NMAX, EXACT>;
  const size_t smem_warp =
      (size_t)chol_warp_elems<T, NMAX>(n * n) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kCholWarps * smem_warp));
  if (err != cudaSuccess) return (int)err;
  // one wave: the runs as long as the resident warps need to cover N (the
  // occupancy query once per width)
  static int sms_of[kMaxN + 1], ctas_of[kMaxN + 1];
  if (ctas_of[n] == 0) {
    const int e = sm_occupancy(kernel, kCholWarps * 32,
                               kCholWarps * smem_warp, &sms_of[n],
                               &ctas_of[n]);
    if (e != (int)cudaSuccess) {
      ctas_of[n] = 0;
      return e;
    }
  }
  const int sms = sms_of[n];
  const int slots = sms * ctas_of[n] * kCholWarps;
  const int bpw = (N + slots - 1) / slots;
  const int warps = (N + bpw - 1) / bpw;
  // few warps: CTAs of fewer warps, spread over the SMs
  const int wpc = min(kCholWarps, max(1, warps / sms));
  const int blocks = (warps + wpc - 1) / wpc;
  chol_kernel<T, NMAX, EXACT><<<blocks, wpc * 32, wpc * smem_warp,
                                (cudaStream_t)stream>>>((const T*)A, (T*)L, N,
                                                        n, bpw);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chol(const void* A, void* L, int N, int n, void* stream) {
  if (n < 1 || n > kMaxN || N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  // the rocket's nw = 17 compiled in; other widths the kernel bounded by 32
  if (n == 17) return launch_chol_n<T, 17, true>(A, L, N, n, stream);
  return launch_chol_n<T, kMaxN, false>(A, L, N, n, stream);
}

template <typename T, int NMAX, int MMAX, bool EXACT>
int launch_cho_solve_n(const void* L, const void* B, void* X, int N, int n,
                       int m, int l_inner, int l_outer, int b_trans,
                       void* stream) {
  auto smem_of = [&](int nbc) {
    return (size_t)nbc * cho_l_slot<T>(n * n) * sizeof(T) +
           align16(((size_t)nbc * n * m + 16 / sizeof(T)) * sizeof(T));
  };
  // 32 blocks a CTA where that leaves room for two CTAs an SM (every width
  // in float32), at most 512 threads a CTA
  int nbc = 32;
  while (nbc > 1 && (smem_of(nbc) > kTwoPerSm || nbc * m > 512)) --nbc;
  const size_t smem = smem_of(nbc);
  const cudaError_t err = cudaFuncSetAttribute(
      cho_solve_kernel<T, NMAX, MMAX, EXACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (nbc * m + 31) / 32 * 32;
  const int blocks = (N + nbc - 1) / nbc;
  cho_solve_kernel<T, NMAX, MMAX, EXACT><<<blocks, threads, smem,
                                           (cudaStream_t)stream>>>(
      (const T*)L, (const T*)B, (T*)X, N, n, m, l_inner, l_outer, b_trans,
      nbc);
  return (int)cudaGetLastError();
}

// L's blocks: l_inner consecutive blocks of n*n a lane, lanes l_outer
// elements apart; B row-major (N, n, m), or (b_trans) the transpose of a
// contiguous (N, m, n); X row-major (N, n, m).
template <typename T>
int launch_cho_solve(const void* L, const void* B, void* X, int N, int n,
                     int m, int l_inner, int l_outer, int b_trans,
                     void* stream) {
  if (n < 1 || n > kMaxN || m < 1 || m > 32 || N < 0 || l_inner < 1 ||
      l_outer < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  // the rocket's (nw, nrx) = (17, 13) compiled in; other widths the kernel
  // bounded by 32
  if (n == 17 && m == 13)
    return launch_cho_solve_n<T, 17, 13, true>(L, B, X, N, n, m, l_inner,
                                               l_outer, b_trans, stream);
  return launch_cho_solve_n<T, kMaxN, 32, false>(L, B, X, N, n, m, l_inner,
                                                 l_outer, b_trans, stream);
}

template <typename T, int NMAX, int MMAX, bool EXACT>
int launch_fused_chol_solve_n(const void* A, const void* B, void* X, int N,
                              int n, int m, void* stream) {
  const auto kernel = fused_chol_solve_kernel<T, NMAX, MMAX, EXACT>;
  // warps for the solve's pairs, and one to factor each block up to the
  // CTA's 16 (so none factors more than two)
  auto threads_of = [&](int nbc) {
    return max((nbc * m + 31) / 32, min(nbc, kFcsThreads / 32)) * 32;
  };
  auto smem_of = [&](int nbc) {
    return (size_t)nbc * cho_l_slot<T>(n * n) * sizeof(T) +
           align16(((size_t)nbc * n * m + 16 / sizeof(T)) * sizeof(T)) +
           (size_t)threads_of(nbc) / 32 * 2 * xcol_len<T, NMAX>() * sizeof(T) +
           align16((size_t)nbc * sizeof(int));
  };
  // at most 32 blocks a CTA, with room for two CTAs an SM
  int nmax = 32;
  while (nmax > 1 &&
         (smem_of(nmax) > kTwoPerSm || threads_of(nmax) > kFcsThreads))
    --nmax;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_of(nmax));
  if (err != cudaSuccess) return (int)err;
  // nbc from N: as few waves of CTAs as nmax allows, each wave full (the
  // occupancy query once per shape), and where N is small one CTA an SM
  // or more
  static int cache_n = -1, cache_m = -1, sms = 0, ctas = 0;
  if (cache_n != n || cache_m != m) {
    const int e = sm_occupancy(kernel, threads_of(nmax), smem_of(nmax), &sms,
                               &ctas);
    if (e != (int)cudaSuccess) return e;
    cache_n = n;
    cache_m = m;
  }
  const int slots = sms * ctas;
  const int waves = ((N + nmax - 1) / nmax + slots - 1) / slots;
  const int nbc = min(nmax, (N + waves * slots - 1) / (waves * slots));
  const int blocks = (N + nbc - 1) / nbc;
  fused_chol_solve_kernel<T, NMAX, MMAX, EXACT><<<
      blocks, threads_of(nbc), smem_of(nbc), (cudaStream_t)stream>>>(
      (const T*)A, (const T*)B, (T*)X, N, n, m, nbc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fused_chol_solve(const void* A, const void* B, void* X, int N,
                            int n, int m, void* stream) {
  if (n < 1 || n > kMaxN || m < 1 || m > 32 || N < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  // its JAX test vehicle's (13, 2) and the stage-Hessian shape (17, 13)
  // compiled in; other widths the kernel bounded by 32
  if (n == 13 && m == 2)
    return launch_fused_chol_solve_n<T, 13, 2, true>(A, B, X, N, n, m, stream);
  if (n == 17 && m == 13)
    return launch_fused_chol_solve_n<T, 17, 13, true>(A, B, X, N, n, m,
                                                      stream);
  return launch_fused_chol_solve_n<T, kMaxN, 32, false>(A, B, X, N, n, m,
                                                        stream);
}

template <typename T, int NMAX, bool EXACT>
int launch_tridiag_factor_n(const void* D, const void* O, void* L, void* C,
                            int B, int N, int n, void* stream) {
  const size_t nn = (size_t)n * n;
  const int nslots = 3;
  auto smem_of = [&](int ch) {
    return align16((size_t)nslots * sizeof(uint64_t)) +
           align16(2 * nn * sizeof(T)) + (size_t)nslots * ch * 2 * nn * sizeof(T);
  };
  // chunks of 4 nodes where that leaves room for two CTAs an SM (every
  // width in float32, 13 in float64), else as many as fit
  int ch = 4;
  while (ch > 1 && smem_of(ch) > kTwoPerSm) --ch;
  const size_t smem = smem_of(ch);
  const cudaError_t err = cudaFuncSetAttribute(
      tridiag_factor_kernel<T, NMAX, EXACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tridiag_factor_kernel<T, NMAX, EXACT><<<B, 32, smem,
                                          (cudaStream_t)stream>>>(
      (const T*)D, (const T*)O, (T*)L, (T*)C, N, n, ch, nslots);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tridiag_factor(const void* D, const void* O, void* L, void* C,
                          int B, int N, int n, void* stream) {
  if (n < 1 || n > kMaxN || N < 1 || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  // the rocket's nrx = 13 (the penalized path) compiled in; other widths
  // the kernel bounded by 32
  if (n == 13)
    return launch_tridiag_factor_n<T, 13, true>(D, O, L, C, B, N, n, stream);
  return launch_tridiag_factor_n<T, kMaxN, false>(D, O, L, C, B, N, n, stream);
}

template <typename T, int NMAX, bool EXACT>
int launch_cho_solve_vec_n(const void* L, const void* b, void* x, int N, int n,
                           void* stream) {
  auto smem_of = [&](int nbw) {
    return align16((size_t)nbw * odd_stride(n * n) * sizeof(T)) +
           (size_t)nbw * odd_stride(n) * sizeof(T);
  };
  int nbw = kVecBlocks;
  while (nbw > 1 && smem_of(nbw) > kTwoPerSm) --nbw;
  const size_t smem = smem_of(nbw);
  const cudaError_t err = cudaFuncSetAttribute(
      cho_solve_vec_kernel<T, NMAX, EXACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + nbw - 1) / nbw;
  cho_solve_vec_kernel<T, NMAX, EXACT><<<blocks, 32, smem,
                                         (cudaStream_t)stream>>>(
      (const T*)L, (const T*)b, (T*)x, N, n, nbw);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cho_solve_vec(const void* L, const void* b, void* x, int N, int n,
                         void* stream) {
  if (n < 1 || n > kMaxN || N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  // the models' stage widths (the rocket's nw = 17, the point mass's 11)
  // compiled in; other widths the kernel bounded by 32
  if (n == 17)
    return launch_cho_solve_vec_n<T, 17, true>(L, b, x, N, n, stream);
  if (n == 11)
    return launch_cho_solve_vec_n<T, 11, true>(L, b, x, N, n, stream);
  return launch_cho_solve_vec_n<T, kMaxN, false>(L, b, x, N, n, stream);
}

template <typename T, int NMAX, bool EXACT>
int launch_tridiag_solve_n(const void* L, const void* C, const void* r,
                           void* u, int B, int N, int n, void* stream) {
  const size_t nn = (size_t)n * n;
  const size_t per_node = (2 * nn + n) * sizeof(T);
  const size_t v_bytes = align16((size_t)N * n * sizeof(T));
  auto smem_of = [&](int nslots, int ch) {
    return align16((size_t)nslots * sizeof(uint64_t)) + v_bytes +
           (size_t)nslots * ch * per_node;
  };
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // every chunk its own slot where that leaves room for two CTAs an SM;
  // else a ring of three slots of as many nodes (at most 4) as fit
  int ch = 4, resident = 1;
  int nslots = (N + ch - 1) / ch;
  size_t smem = smem_of(nslots, ch);
  if (smem > kTwoPerSm) {
    resident = 0;
    nslots = 3;
    while (ch > 1 && smem_of(nslots, ch) > kTwoPerSm) --ch;
    smem = smem_of(nslots, ch);
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  }
  err = cudaFuncSetAttribute(tridiag_solve_kernel<T, NMAX, EXACT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  tridiag_solve_kernel<T, NMAX, EXACT><<<B, 32, smem,
                                         (cudaStream_t)stream>>>(
      (const T*)L, (const T*)C, (const T*)r, (T*)u, N, n, ch, nslots,
      resident);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tridiag_solve(const void* L, const void* C, const void* r, void* u,
                         int B, int N, int n, void* stream) {
  if (n < 1 || n > kMaxN || N < 1 || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  // the models' widths (the rocket's nrx = 13, the point mass's 7) get
  // kernels with n compiled in; other widths the one bounded by 32
  if (n == 13)
    return launch_tridiag_solve_n<T, 13, true>(L, C, r, u, B, N, n, stream);
  if (n == 7)
    return launch_tridiag_solve_n<T, 7, true>(L, C, r, u, B, N, n, stream);
  return launch_tridiag_solve_n<T, kMaxN, false>(L, C, r, u, B, N, n, stream);
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
                       int m, int l_inner, int l_outer, int b_trans,
                       void* stream) {
  return launch_cho_solve<float>(L, B, X, N, n, m, l_inner, l_outer, b_trans,
                                 stream);
}

int scvx_cho_solve_f64(const void* L, const void* B, void* X, int N, int n,
                       int m, int l_inner, int l_outer, int b_trans,
                       void* stream) {
  return launch_cho_solve<double>(L, B, X, N, n, m, l_inner, l_outer, b_trans,
                                  stream);
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
