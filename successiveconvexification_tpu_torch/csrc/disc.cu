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
//      [A | B] to shared memory (thread 0 also f);
//   B. thread i < nx forms row i of sA x + sB u;
//   C. threads 0..2nx-1 form their own nx derivatives with ONE loop,
//      out[i] = sum_k M[i][k] v[k] where M is sA for a Phi column and sA'
//      (negated) for a P row, so the warp does not diverge on the nx^2-term
//      products; the P rows then add P sB, P f and P w.
// __syncwarp() separates the phases; a lane's working set in shared memory
// is lane_smem<Dyn>() values (320 for the rocket, 1.25 KB in float32; 128
// for the point mass). Constants are formed in double and rounded to the
// scalar type, as the plain version's Python floats are. A lane whose
// inputs are not finite comes out not finite; nothing faults.
// First version: correct and simple. It recomputes the dynamics' primal in
// every direction and leaves threads nx+nu..31 idle in phase A (17..31 for
// the rocket, 10..31 for the point mass).

#include <cuda_runtime.h>
#include <stdint.h>

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
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, T c) {
  return {a.v / c, a.d / c};
}
template <typename T>
__device__ __forceinline__ Dual<T> dsqrt(Dual<T> a) {
  const T s = sqrt(a.v);
  return {s, a.d / (T(2) * s)};
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
    const S nu = dsqrt(u0 * u0 + u1 * u1 + u2 * u2 + eps);
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
    const S nu = dsqrt(u0 * u0 + u1 * u1 + u2 * u2 + eps);
    out[0] = -(p[0] * nu);
    out[1] = x[4];
    out[2] = x[5];
    out[3] = x[6];
    out[4] = u0 / m + p[1];
    out[5] = u1 / m + p[2];
    out[6] = u2 / m + p[3];
  }
};

// Shared values per lane: the stage phases hold sA, sB, f, w and x; the
// final products Phi, Bm, Bp, S and z. Rounded up to a multiple of 32.
template <class Dyn>
__host__ __device__ constexpr int lane_smem() {
  constexpr int nx = Dyn::NX, nu = Dyn::NU;
  constexpr int stage = nx * nx + nx * nu + 3 * nx;
  constexpr int final_ = nx * nx + 2 * nx * nu + 2 * nx;
  return ((stage > final_ ? stage : final_) + 31) / 32 * 32;
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
  constexpr int kSmem = lane_smem<Dyn>();
  static_assert(2 * NX <= 32 && NX + NU <= 32, "one warp per lane");
  extern __shared__ unsigned char smem_raw[];
  const int warp = threadIdx.x / 32;
  const int t = threadIdx.x % 32;
  const int Lk = K - 1;
  const int lane = blockIdx.x * kWarps + warp;
  if (lane >= Bn * Lk) return;  // the whole warp leaves together
  const int b = lane / Lk, k = lane - b * Lk;

  T* sm = reinterpret_cast<T*>(smem_raw) + (size_t)warp * kSmem;
  T* sA = sm;                    // sigma df/dx, row-major NX x NX
  T* sB = sm + NX * NX;          // sigma df/du, NX x NU
  T* fs = sB + NX * NU;          // f
  T* ws = fs + NX;               // sA x + sB u
  T* xs = ws + NX;               // the stage input x

  const bool col = t < NX;                 // owns Phi[:, t] and x_t
  const bool row = t >= NX && t < 2 * NX;  // owns P[r, :], Bm/Bp/S/z row r
  const int r = col ? t : t - NX;

  T p[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) p[i] = prm[(size_t)b * NP + i];
  const T sg = sig[b];
  const T* xk = X + ((size_t)b * K + k) * NX;
  T uk[NU], up[NU];
#pragma unroll
  for (int c = 0; c < NU; ++c) {
    uk[c] = U[((size_t)b * K + k) * NU + c];
    up[c] = U[((size_t)b * K + k + 1) * NU + c];
  }

  // carry y, RK4 stage sum acc, stage input st: the owned vector (Phi column
  // or P row) and the extras (x_t for a column; Bm, Bp, S, z for a row)
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
  const int s1 = col ? NX : 1, s2 = col ? 1 : NX;  // M = sA or sA'

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
        Dual<T> xd[NX], ud[NU], fd[NX];
#pragma unroll
        for (int j = 0; j < NX; ++j) xd[j] = {xs[j], j == t ? T(1) : T(0)};
#pragma unroll
        for (int c = 0; c < NU; ++c) ud[c] = {u[c], NX + c == t ? T(1) : T(0)};
        Dyn::f(p, xd, ud, fd);
        if (t < NX) {
#pragma unroll
          for (int i = 0; i < NX; ++i) sA[i * NX + t] = sg * fd[i].d;
        } else {
#pragma unroll
          for (int i = 0; i < NX; ++i) sB[i * NU + (t - NX)] = sg * fd[i].d;
        }
        if (t == 0) {
#pragma unroll
          for (int i = 0; i < NX; ++i) fs[i] = fd[i].v;
        }
      }
      __syncwarp();

      // B. w = sA x + sB u, row t
      if (col) {
        T a = T(0), bb = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) a += sA[t * NX + j] * xs[j];
#pragma unroll
        for (int c = 0; c < NU; ++c) bb += sB[t * NU + c] * u[c];
        ws[t] = a + bb;
      }
      __syncwarp();

      // C. the owned derivatives, then the RK4 update
      if (col || row) {
        T kv[NX], ke[NE];
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          T a = T(0);
#pragma unroll
          for (int j = 0; j < NX; ++j) a += sA[i * s1 + j * s2] * st[j];
          kv[i] = sgn * a;
        }
#pragma unroll
        for (int e = 0; e < NE; ++e) ke[e] = T(0);
        if (col) {
          ke[0] = sg * fs[t];
        } else {
#pragma unroll
          for (int c = 0; c < NU; ++c) {
            T a = T(0);
#pragma unroll
            for (int j = 0; j < NX; ++j) a += st[j] * sB[j * NU + c];
            ke[c] = lm * a;
            ke[NU + c] = lp * a;
          }
          T a = T(0), bb = T(0);
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            a += st[j] * fs[j];
            bb += st[j] * ws[j];
          }
          ke[2 * NU] = a;
          ke[2 * NU + 1] = -bb;
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
  const size_t smem = (size_t)kWarps * lane_smem<Dyn>() * sizeof(T);
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
