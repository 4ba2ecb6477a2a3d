// RK4 multiple-shooting linearization (discretize) of the time-dilated
// dynamics, written for Hopper (sm_90a).
//
// Replaces the TPU kernel successiveconvexification_tpu/ops/pallas_disc.py
// discretize_lanes (its pallas_call body runs discretize._aug_rk4_soa with
// lane_fanout=False). One lane is one (scenario b, interval k); there are
// L = B (K-1) lanes. Each integrates, over `substeps` fixed RK4 steps with
// first-order-hold controls u(tau) = lam_m u_k + lam_p u_{k+1}
// (lam_p = tau / h; zero-order hold: lam_p = 0):
//
//   xdot   = sigma f(x, u)
//   Phidot = sA Phi,            Pdot  = -P sA        (P = Phi^-1, integrated)
//   Bmdot  = lam_m P sB,        Bpdot = lam_p P sB
//   Sdot   = P f,               zdot  = -P (sA x + sB u)
//
// with sA = sigma df/dx, sB = sigma df/du, and writes A = Phi, Phi Bm,
// Phi Bp, Phi S, Phi z and x_end, batch-first: (B, K-1, nx, nx),
// (B, K-1, nx, nu), (B, K-1, nx) (the plain version:
// ops/cuda_disc.py discretize_lanes_plain). The Jacobian columns are exact:
// each model's dynamics are written once here as a device function templated
// on its scalar type and evaluated on a one-direction dual number per
// column, as forward-mode AD does (the TPU traced model.f through jax.jvp,
// so one kernel served every model; here the kernel is a template over the
// dynamics struct, instantiated once per model: Rocket6DoF, nx = 14, and
// PointMass3DoF, nx = 7, each with its own entry points).
//
// Bound on the H100: operations. Per lane and RK stage about 16 kFLOP
// (sA Phi and P sA are 5.5 kFLOP each, P sB 1.2 kFLOP, 17 dual-number
// evaluations of the dynamics), 32 stages at the main path: ~0.6 MFLOP a
// lane against 322 output values.
//
// Design: one warp per lane, four lanes a block. The TPU kernel put 128
// lanes on the vector lanes and kept the whole 714-value carry in VMEM;
// one thread per lane here would hold 518 carry values plus the RK4 stage
// sums and spill. The algebra splits by columns and rows instead: column j
// of Phi evolves by sA Phi[:, j] and row j of P by -P[j, :] sA, and row j of
// Bm, Bp, S and z needs only row j of P. So thread j < nx owns column j of
// Phi and state component x_j, thread nx + j owns row j of P and of Bm, Bp,
// S, z: each holds its nx (+ up to 2 nu + 2) values three times (the carry,
// the RK4 stage sum, the stage input) in registers. This needs 2 nx <= 32
// and nx + nu <= 32 threads, which both models meet. Per stage evaluation:
//   A. threads 0..nx+nu-1 each evaluate the dynamics on a dual number
//      seeded in direction j (x_0.., u_0..) and write sigma * column j of
//      [A | B] to shared memory twice: sA row-major for the Phi columns and
//      transposed for the P rows (which read -sA'), sB transposed (thread 0
//      also f);
//   B. thread i < nx forms row i of sA x + sB u (from the transposes, so
//      the threads read consecutive words);
//   C. every thread runs the same code for its nx derivatives: out[i] =
//      sum_j M[i][j] v[j] with M its matrix's base pointer (sA for a Phi
//      column, sA' for a P row, negated); then the P rows form P sB, P f
//      and P w and a column its x_t derivative (the first design's branch:
//      as one select it moved nvcc's contraction of the Bm, Bp sums), then
//      every thread the RK4 update.
// Every row in shared memory is padded to a multiple of 16 bytes (row_ld:
// an odd count of 16-byte chunks, so eight threads storing rows t, t+1, ..
// hit 32 banks) and read by 16-byte loads: phase C's row of 14 is 4 loads
// in float32 where it was 14 scalar loads at run-time strides. The
// divisions of the dual numbers go by div_zs (divide.cuh): most of their
// tangent numerators are exact zeros, which the IEEE division sends down
// its slow path; the one exception is the tangent of ||v|| (dsqrt), where
// the A/B against the first design showed nvcc contracting the drag terms
// otherwise. Every value keeps the first design's operations in their
// order (the same sums in the same order, true divisions and square roots),
// so the outputs are that design's bit for bit. A lane's working set in
// shared memory is lane_smem<T, Dyn>() values (700 for the rocket in
// float32, 2.8 KB), the scenario's params among them. Constants are formed
// in double and rounded to the scalar type, as the plain version's Python
// floats are. A lane whose inputs are not finite comes out not finite;
// nothing faults. Threads nx+nu..31 idle in phase A (17..31 for the rocket,
// 10..31 for the point mass); each direction recomputes the dynamics'
// primal.

#include <cuda_runtime.h>
#include <stdint.h>

#include "divide.cuh"

namespace {

constexpr int kWarps = 4;        // lanes per block

// ---------------------------------------------------------------- duals
template <typename T>
struct Dual {
  T v, d;
};

template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) {
  return {a.v + b.v, a.d + b.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) {
  return {a.v - b.v, a.d - b.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a) {
  return {-a.v, -a.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(T c, Dual<T> a) {
  return {c * a.v, c * a.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, T c) {
  return {a.v + c, a.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator+(T c, Dual<T> a) {
  return {c + a.v, a.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(T c, Dual<T> a) {
  return {c - a.v, -a.d};
}
// The quotients by div_zs: the IEEE quotient, a zero dividend off the
// division's slow path (most tangent numerators are exact zeros: a
// direction touches few outputs).
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T q = div_zs(a.v, b.v);
  return {q, div_zs(a.d - q * b.d, b.v)};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, T c) {
  return {div_zs(a.v, c), div_zs(a.d, c)};
}
// sqrt: its tangent's quotient by a true division. The same bits, but with
// div_zs there nvcc contracted the drag terms that use ||v|| into other
// FMAs than the first design's (up to 5e-5 relative in Phi on the H100);
// dsqrt_zs, by div_zs, serves a norm whose tangent feeds products only
// (the thrust's).
template <typename T>
__device__ __forceinline__ Dual<T> dsqrt(Dual<T> a) {
  const T s = sqrt(a.v);
  return {s, a.d / (T(2) * s)};
}
template <typename T>
__device__ __forceinline__ Dual<T> dsqrt_zs(Dual<T> a) {
  const T s = sqrt(a.v);
  return {s, div_zs(a.d, T(2) * s)};
}

// ------------------------------------------------------------ dynamics
// The 6-DoF rocket (models/rocket6dof.py dynamics), term for term:
//   x = (m, r[3], v[3], q[4], w[3]), u = T_B[3];
//   p = (alpha_m, cd_a, g_i[3], J_b[3], r_t[3])  (rocket6dof.kernel_params)
//   mdot = -alpha_m ||u||,  rdot = v,
//   vdot = (C_IB(q) u - cd_a ||v|| v) / m + g_i,
//   qdot = 0.5 q (x) (0, w),  wdot = (r_t x u - w x (J_b w)) / J_b,
// with ||.|| = sqrt(sum + 1e-12) (base.safe_norm) and C_IB as
// utils/quaternion.py quat_to_dcm.
struct Rocket6DoF {
  static constexpr int NX = 14, NU = 3, NP = 11;

  template <typename T, typename S>
  __device__ __forceinline__ static void f(const T* p, const S* x,
                                           const S* u, S* out) {
    const T one = T(1), two = T(2), eps = T(1e-12);
    const S m = x[0];
    const S v0 = x[4], v1 = x[5], v2 = x[6];
    const S q0 = x[7], q1 = x[8], q2 = x[9], q3 = x[10];
    const S w0 = x[11], w1 = x[12], w2 = x[13];
    const S u0 = u[0], u1 = u[1], u2 = u[2];
    // quat_to_dcm
    const S c00 = one - two * (q2 * q2 + q3 * q3);
    const S c01 = two * (q1 * q2 - q0 * q3);
    const S c02 = two * (q1 * q3 + q0 * q2);
    const S c10 = two * (q1 * q2 + q0 * q3);
    const S c11 = one - two * (q1 * q1 + q3 * q3);
    const S c12 = two * (q2 * q3 - q0 * q1);
    const S c20 = two * (q1 * q3 - q0 * q2);
    const S c21 = two * (q2 * q3 + q0 * q1);
    const S c22 = one - two * (q1 * q1 + q2 * q2);
    const S t0 = c00 * u0 + c01 * u1 + c02 * u2;
    const S t1 = c10 * u0 + c11 * u1 + c12 * u2;
    const S t2 = c20 * u0 + c21 * u1 + c22 * u2;
    const S nu = dsqrt_zs(u0 * u0 + u1 * u1 + u2 * u2 + eps);
    const S nv = dsqrt(v0 * v0 + v1 * v1 + v2 * v2 + eps);
    const S cn = p[1] * nv;
    out[0] = -(p[0] * nu);
    out[1] = v0;
    out[2] = v1;
    out[3] = v2;
    out[4] = (t0 + (-cn) * v0) / m + p[2];
    out[5] = (t1 + (-cn) * v1) / m + p[3];
    out[6] = (t2 + (-cn) * v2) / m + p[4];
    // 0.5 * quat_multiply(q, (0, w))
    const T half = T(0.5);
    out[7] = half * (-(q1 * w0) - q2 * w1 - q3 * w2);
    out[8] = half * (q0 * w0 + q2 * w2 - q3 * w1);
    out[9] = half * (q0 * w1 - q1 * w2 + q3 * w0);
    out[10] = half * (q0 * w2 + q1 * w1 - q2 * w0);
    const T J0 = p[5], J1 = p[6], J2 = p[7];
    const T r0 = p[8], r1 = p[9], r2 = p[10];
    const S j0 = J0 * w0, j1 = J1 * w1, j2 = J2 * w2;
    out[11] = ((r1 * u2 - r2 * u1) - (w1 * j2 - w2 * j1)) / J0;
    out[12] = ((r2 * u0 - r0 * u2) - (w2 * j0 - w0 * j2)) / J1;
    out[13] = ((r0 * u1 - r1 * u0) - (w0 * j1 - w1 * j0)) / J2;
  }
};

// The 3-DoF point mass (models/pointmass3dof.py dynamics), term for term:
//   x = (m, r[3], v[3]), u = T_I[3];  p = (alpha_m, g_i[3])
//   (pointmass3dof.kernel_params)
//   mdot = -alpha_m ||u||,  rdot = v,  vdot = u / m + g_i,
// with ||.|| = sqrt(sum + 1e-12) (base.safe_norm). No retraction.
struct PointMass3DoF {
  static constexpr int NX = 7, NU = 3, NP = 4;

  template <typename T, typename S>
  __device__ __forceinline__ static void f(const T* p, const S* x,
                                           const S* u, S* out) {
    const T eps = T(1e-12);
    const S m = x[0];
    const S u0 = u[0], u1 = u[1], u2 = u[2];
    const S nu = dsqrt_zs(u0 * u0 + u1 * u1 + u2 * u2 + eps);
    out[0] = -(p[0] * nu);
    out[1] = x[4];
    out[2] = x[5];
    out[3] = x[6];
    out[4] = u0 / m + p[1];
    out[5] = u1 / m + p[2];
    out[6] = u2 / m + p[3];
  }
};

// Row stride in shared memory for rows of nx values: a multiple of 16
// bytes, with an odd count of 16-byte chunks (rocket: 20 floats, 14
// doubles; point mass: 12 floats, 10 doubles).
template <typename T>
__host__ __device__ constexpr int row_ld(int nx) {
  constexpr int V = 16 / sizeof(T);
  return ((nx + V - 1) / V) % 2 == 1 ? (nx + V - 1) / V * V
                                     : (nx + V - 1) / V * V + V;
}

// Shared values per lane: the stage phases hold sA, sA', sB', f, w, x and
// the scenario's params (2 nx + nu + 4 rows); the final products Phi, Bm,
// Bp, S and z (fewer).
template <typename T, class Dyn>
__host__ __device__ constexpr int lane_smem() {
  constexpr int nx = Dyn::NX, nu = Dyn::NU;
  constexpr int stage = (2 * nx + nu + 4) * row_ld<T>(nx);
  constexpr int final_ = nx * nx + 2 * nx * nu + 2 * nx;
  constexpr int V = 16 / sizeof(T);
  return ((stage > final_ ? stage : final_) + V - 1) / V * V;
}

// sum_{j < N, ascending} row[j] * v[j] from 0, as `a += row[j] * v[j]`:
// row 16-byte aligned in shared memory, read by 16-byte loads.
template <int N>
__device__ __forceinline__ float dot_row(const float* row,
                                         const float (&v)[N]) {
  float a = 0.0f;
#pragma unroll
  for (int q = 0; q < (N + 3) / 4; ++q) {
    const float4 w = reinterpret_cast<const float4*>(row)[q];
    const float e[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * q + i < N) a += e[i] * v[4 * q + i];
  }
  return a;
}
template <int N>
__device__ __forceinline__ double dot_row(const double* row,
                                          const double (&v)[N]) {
  double a = 0.0;
#pragma unroll
  for (int q = 0; q < (N + 1) / 2; ++q) {
    const double2 w = reinterpret_cast<const double2*>(row)[q];
    const double e[2] = {w.x, w.y};
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (2 * q + i < N) a += e[i] * v[2 * q + i];
  }
  return a;
}

// v[0..N) <- row[0..N), row 16-byte aligned in shared memory.
template <int N>
__device__ __forceinline__ void load_vec(const float* row, float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < (N + 3) / 4; ++q) {
    const float4 w = reinterpret_cast<const float4*>(row)[q];
    const float e[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * q + i < N) v[4 * q + i] = e[i];
  }
}
template <int N>
__device__ __forceinline__ void load_vec(const double* row, double (&v)[N]) {
#pragma unroll
  for (int q = 0; q < (N + 1) / 2; ++q) {
    const double2 w = reinterpret_cast<const double2*>(row)[q];
    v[2 * q] = w.x;
    if (2 * q + 1 < N) v[2 * q + 1] = w.y;
  }
}

// row[0..N) <- v[0..N) by 16-byte stores (the padding after N is written
// with zeros), row 16-byte aligned in shared memory.
template <int N>
__device__ __forceinline__ void store_vec(float* row, const float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < (N + 3) / 4; ++q) {
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = 4 * q + i < N ? v[4 * q + i] : 0.0f;
    reinterpret_cast<float4*>(row)[q] = make_float4(e[0], e[1], e[2], e[3]);
  }
}
template <int N>
__device__ __forceinline__ void store_vec(double* row, const double (&v)[N]) {
#pragma unroll
  for (int q = 0; q < (N + 1) / 2; ++q) {
    const double hi = 2 * q + 1 < N ? v[2 * q + 1] : 0.0;
    reinterpret_cast<double2*>(row)[q] = make_double2(v[2 * q], hi);
  }
}

// ---------------------------------------------------------------- kernel
template <typename T, class Dyn>
__global__ void __launch_bounds__(kWarps * 32)
    discretize_kernel(const T* __restrict__ prm, const T* __restrict__ X,
                      const T* __restrict__ U, const T* __restrict__ sig,
                      T* __restrict__ A_out, T* __restrict__ Bm_out,
                      T* __restrict__ Bp_out, T* __restrict__ S_out,
                      T* __restrict__ z_out, T* __restrict__ xe_out, int Bn,
                      int K, int substeps, int foh) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU, NP = Dyn::NP;
  constexpr int NE = 2 * NU + 2;  // extras a P row owns: Bm, Bp, S, z
  constexpr int kSmem = lane_smem<T, Dyn>();
  constexpr int LD = row_ld<T>(NX);
  static_assert(2 * NX <= 32 && NX + NU <= 32, "one warp per lane");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32;
  const int t = threadIdx.x % 32;
  const int Lk = K - 1;
  const int lane = blockIdx.x * kWarps + warp;
  if (lane >= Bn * Lk) return;  // the whole warp leaves together
  const int b = lane / Lk, k = lane - b * Lk;

  // rows of LD values, each 16-byte aligned
  T* sm = reinterpret_cast<T*>(smem_raw) + (size_t)warp * kSmem;
  T* sA = sm;                    // sigma df/dx, row-major NX x NX
  T* sAT = sA + NX * LD;         // its transpose
  T* sBT = sAT + NX * LD;        // sigma df/du, transposed: NU x NX
  T* fs = sBT + NU * LD;         // f
  T* ws = fs + LD;               // sA x + sB u
  T* xs = ws + LD;               // the stage input x
  T* ps = xs + LD;               // the params the dynamics read (NP <= LD)

  const bool col = t < NX;                 // owns Phi[:, t] and x_t
  const bool row = t >= NX && t < 2 * NX;  // owns P[r, :], Bm/Bp/S/z row r
  const int r = col ? t : t - NX;
  const int tc = col ? t : 0;          // a column every thread may read
  const T* Mc = col ? sA : sAT;        // phase C's matrix: sA, or sA'

  // the params from shared memory: in registers they pushed the rocket's
  // float32 kernel past the 168 registers that let 12 warps share an SM
  static_assert(NP <= LD, "params in one row");
  if (t < NP) ps[t] = prm[(size_t)b * NP + t];
  const T* p = ps;
  const T sg = sig[b];
  const T* xk = X + ((size_t)b * K + k) * NX;
  T uk[NU], up[NU];
#pragma unroll
  for (int c = 0; c < NU; ++c) {
    uk[c] = U[((size_t)b * K + k) * NU + c];
    up[c] = U[((size_t)b * K + k + 1) * NU + c];
  }

  // carry y, RK4 stage sum acc, stage input st: the owned vector (Phi column
  // or P row; threads 2 NX.. carry zeros) and the extras (x_t for a column;
  // Bm, Bp, S, z for a row)
  T y[NX], acc[NX], st[NX], ye[NE], acce[NE], ste[NE];
#pragma unroll
  for (int i = 0; i < NX; ++i) y[i] = st[i] = (i == r) ? T(1) : T(0);
#pragma unroll
  for (int e = 0; e < NE; ++e) ye[e] = ste[e] = T(0);
  if (col) {
    ye[0] = ste[0] = xk[t];
    xs[t] = xk[t];
  }
  __syncwarp();

  const double h = 1.0 / Lk;
  const double dt = h / substeps;
  const T c_half = (T)(dt / 2), c_full = (T)dt, c_sixth = (T)(dt / 6);
  const T sgn = col ? T(1) : T(-1);

  for (int it = 0; it < substeps; ++it) {
    const double tau0 = (double)it * dt;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const double tau = s == 0 ? tau0 : (s == 3 ? tau0 + dt : tau0 + dt / 2);
      const double lpd = foh ? tau / h : 0.0;
      const T lp = (T)lpd, lm = (T)(1.0 - lpd);
      T u[NU];
#pragma unroll
      for (int c = 0; c < NU; ++c) u[c] = lm * uk[c] + lp * up[c];

      // A. column t of sigma [A | B] by one dual-number evaluation
      if (t < NX + NU) {
        T xv[NX];
        load_vec<NX>(xs, xv);
        Dual<T> xd[NX], ud[NU], fd[NX];
#pragma unroll
        for (int j = 0; j < NX; ++j) xd[j] = {xv[j], j == t ? T(1) : T(0)};
#pragma unroll
        for (int c = 0; c < NU; ++c) ud[c] = {u[c], NX + c == t ? T(1) : T(0)};
        Dyn::f(p, xd, ud, fd);
        T cv[NX];  // sigma * column t of [A | B]
#pragma unroll
        for (int i = 0; i < NX; ++i) cv[i] = sg * fd[i].d;
        if (t < NX) {
#pragma unroll
          for (int i = 0; i < NX; ++i) sA[i * LD + t] = cv[i];
          store_vec<NX>(sAT + t * LD, cv);
        } else {
          store_vec<NX>(sBT + (t - NX) * LD, cv);
        }
        if (t == 0) {
          T fv[NX];
#pragma unroll
          for (int i = 0; i < NX; ++i) fv[i] = fd[i].v;
          store_vec<NX>(fs, fv);
        }
      }
      __syncwarp();

      // B. w = sA x + sB u, row t (every thread alike; columns store)
      {
        T xv[NX];
        load_vec<NX>(xs, xv);
        T a = T(0), bb = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) a += sAT[j * LD + tc] * xv[j];
#pragma unroll
        for (int c = 0; c < NU; ++c) bb += sBT[c * LD + tc] * u[c];
        if (col) ws[t] = a + bb;
      }
      __syncwarp();

      // C. the owned derivatives, then the RK4 update
      {
        T kv[NX], ke[NE];
#pragma unroll
        for (int i = 0; i < NX; ++i) kv[i] = sgn * dot_row<NX>(Mc + i * LD, st);
#pragma unroll
        for (int e = 0; e < NE; ++e) ke[e] = T(0);
        if (col) {
          ke[0] = sg * fs[t];
        } else {
          // a P row's extras: P sB (lam_m, lam_p), P f, -P w
#pragma unroll
          for (int c = 0; c < NU; ++c) {
            const T a = dot_row<NX>(sBT + c * LD, st);
            ke[c] = lm * a;
            ke[NU + c] = lp * a;
          }
          ke[2 * NU] = dot_row<NX>(fs, st);
          ke[2 * NU + 1] = -dot_row<NX>(ws, st);
        }
        // acc = ((k1 + 2 k2) + 2 k3) + k4; y += dt/6 acc; stage inputs
        // y + dt/2 k1, y + dt/2 k2, y + dt k3
        const T cin = s == 2 ? c_full : c_half;
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          if (s == 0) acc[i] = kv[i];
          else if (s == 3) acc[i] = acc[i] + kv[i];
          else acc[i] = acc[i] + T(2) * kv[i];
          if (s == 3) {
            y[i] = y[i] + c_sixth * acc[i];
            st[i] = y[i];
          } else {
            st[i] = y[i] + cin * kv[i];
          }
        }
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          if (s == 0) acce[e] = ke[e];
          else if (s == 3) acce[e] = acce[e] + ke[e];
          else acce[e] = acce[e] + T(2) * ke[e];
          if (s == 3) {
            ye[e] = ye[e] + c_sixth * acce[e];
            ste[e] = ye[e];
          } else {
            ste[e] = ye[e] + cin * ke[e];
          }
        }
        if (col) xs[t] = ste[0];
      }
      __syncwarp();
    }
  }

  // Phi@Bm, Phi@Bp, Phi@S, Phi@z: the Phi columns and the rows of Bm, Bp, S,
  // z meet in shared memory (the phase buffers are free after the last sync)
  T* PhiS = sm;
  T* BmS = sm + NX * NX;
  T* BpS = BmS + NX * NU;
  T* SS = BpS + NX * NU;
  T* zS = SS + NX;
  const size_t lo = (size_t)lane;
  if (col) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      PhiS[i * NX + t] = y[i];
      A_out[(lo * NX + i) * NX + t] = y[i];
    }
    xe_out[lo * NX + t] = ye[0];
  } else if (row) {
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      BmS[r * NU + c] = ye[c];
      BpS[r * NU + c] = ye[NU + c];
    }
    SS[r] = ye[2 * NU];
    zS[r] = ye[2 * NU + 1];
  }
  __syncwarp();
  if (col || row) {
    // thread i: row i of Phi Bm and Phi S; thread 14 + i: of Phi Bp, Phi z
    const T* M = col ? BmS : BpS;
    const T* v = col ? SS : zS;
    T* o3 = col ? Bm_out : Bp_out;
    T* o1 = col ? S_out : z_out;
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      T a = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) a += PhiS[r * NX + j] * M[j * NU + c];
      o3[(lo * NX + r) * NU + c] = a;
    }
    T a = T(0);
#pragma unroll
    for (int j = 0; j < NX; ++j) a += PhiS[r * NX + j] * v[j];
    o1[lo * NX + r] = a;
  }
}

template <typename T, class Dyn>
int launch_discretize(const void* prm, const void* X, const void* U,
                      const void* sig, void* A, void* Bm, void* Bp, void* S,
                      void* z, void* xe, int Bn, int K, int substeps, int foh,
                      void* stream) {
  if (Bn < 0 || K < 2 || substeps < 1)
    return (int)cudaErrorInvalidValue;
  const long long L = (long long)Bn * (K - 1);
  if (L == 0) return (int)cudaSuccess;
  if (L > (long long)0x7fffffff - kWarps) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((L + kWarps - 1) / kWarps);
  const size_t smem = (size_t)kWarps * lane_smem<T, Dyn>() * sizeof(T);
  discretize_kernel<T, Dyn>
      <<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
          (const T*)prm, (const T*)X, (const T*)U, (const T*)sig, (T*)A,
          (T*)Bm, (T*)Bp, (T*)S, (T*)z, (T*)xe, Bn, K, substeps, foh);
  return (int)cudaGetLastError();
}

}  // namespace

// One pair of entry points per model's dynamics:
// scvx_discretize_lanes_<model>_<dtype>.
#define SCVX_DISCRETIZE_ENTRY(MODEL, DYN, SFX, T)                            \
  int scvx_discretize_lanes_##MODEL##_##SFX(                                 \
      const void* prm, const void* X, const void* U, const void* sig,       \
      void* A, void* Bm, void* Bp, void* S, void* z, void* xe, int Bn,      \
      int K, int substeps, int foh, void* stream) {                         \
    return launch_discretize<T, DYN>(prm, X, U, sig, A, Bm, Bp, S, z, xe,   \
                                     Bn, K, substeps, foh, stream);         \
  }

extern "C" {

SCVX_DISCRETIZE_ENTRY(rocket6dof, Rocket6DoF, f32, float)
SCVX_DISCRETIZE_ENTRY(rocket6dof, Rocket6DoF, f64, double)
SCVX_DISCRETIZE_ENTRY(pointmass3dof, PointMass3DoF, f32, float)
SCVX_DISCRETIZE_ENTRY(pointmass3dof, PointMass3DoF, f64, double)

}  // extern "C"
