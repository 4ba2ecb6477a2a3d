"""The discretize kernel's plain version against the JAX package, on the CPU.

``cuda_disc.discretize_lanes_plain`` is what the CUDA kernel
(csrc/disc.cu) is held to on the card. Here it is held, in f64, to the body
the Pallas kernel runs: the JAX package's ``discretize._aug_rk4_soa`` with
``lane_fanout=False`` (``pallas_disc.discretize_lanes`` itself is held to
that function by tests/test_pallas_disc.py), for first- and zero-order hold;
and the port's ``discretize`` to the JAX ``discretize`` (vmapped). The three
JAX integrations compile together, once. Inputs are made with numpy from a
seed: B=3 dispersed scenarios, each with its own alpha_m, J_b, r_t, g_i, one
with drag (cd_a > 0); K=6, 3 substeps. Tolerance: 1e-10 relative to the
largest entry of each output (rounding-order differences only).

The kernel wrapper raises on CPU tensors, on mixed dtypes and on a model
without CUDA dynamics; off the CPU nothing falls back to the plain version.
On the CPU ``propagate`` (the merit's end states) equals ``discretize``'s
x_prop bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from successiveconvexification_tpu.models import rocket6dof as jrk
from successiveconvexification_tpu.ops import discretize as jdisc

from successiveconvexification_tpu_torch.models import rocket6dof as trk
from successiveconvexification_tpu_torch.ops import cuda_disc
from successiveconvexification_tpu_torch.ops import discretize as tdisc

K, B, SUBSTEPS = 6, 3, 3
RTOL = 1e-10
F64 = torch.float64
OUTPUTS = ("A", "Bm", "Bp", "S", "z", "x_end")


def _params_np(seed):
    """Dispersed scenarios with per-scenario vehicle parameters (numpy)."""
    base = jrk.default_params(jnp.float64)
    rng = np.random.default_rng(seed)
    d = {f.name: np.broadcast_to(np.asarray(getattr(base, f.name)),
                                 (B,) + np.shape(getattr(base, f.name))).copy()
         for f in dataclasses.fields(base)}
    d["r_init"] = d["r_init"] + 0.2 * rng.standard_normal((B, 3))
    d["v_init"] = d["v_init"] + 0.1 * rng.standard_normal((B, 3))
    d["m_wet"] = d["m_wet"] * (1.0 + 0.03 * rng.standard_normal(B))
    d["alpha_m"] = d["alpha_m"] * (1.0 + 0.2 * rng.random(B))
    d["J_b"] = d["J_b"] * (1.0 + 0.5 * rng.random((B, 3)))
    d["r_t"] = d["r_t"] + 3e-3 * rng.standard_normal((B, 3))
    d["g_i"] = d["g_i"] + 0.05 * rng.standard_normal((B, 3))
    d["cd_a"] = np.array([0.0, 0.3, 0.0])
    return d


def _inputs(seed):
    """Perturbed straight-line trajectories for the dispersed scenarios."""
    d = _params_np(seed)
    pt = trk.params_from_numpy(d, device="cpu", dtype=F64)
    X, U, sig = (a.numpy() for a in trk.initial_guess(pt, K))
    rng = np.random.default_rng(seed + 1)
    X = X + 0.05 * rng.standard_normal((B, K, trk.NX))
    X[..., 7:11] /= np.linalg.norm(X[..., 7:11], axis=-1, keepdims=True)
    X[..., 11:] += 0.2 * rng.standard_normal((B, K, 3))
    U = U + 0.3 * rng.standard_normal((B, K, trk.NU))
    sig = sig * (1.0 + 0.1 * rng.standard_normal(B))
    return d, X, U, sig


@jax.jit
def _jax_side(pj, X, U, sig):
    """vmap(discretize) with FOH, and _aug_rk4_soa(lane_fanout=False) on the
    flat lane axis with FOH and ZOH: one compile."""
    mj = jrk.rocket6dof_model()
    disc = jax.vmap(lambda p, x, u, s: jdisc.discretize(
        mj, p, x, u, s, substeps=SUBSTEPS, foh=True))(pj, X, U, sig)
    L = B * (K - 1)

    def flat(a):  # (B, K-1, d) -> (d, L)
        return jnp.moveaxis(a, -1, 0).reshape(a.shape[-1], L)

    pflat = jax.tree.map(
        lambda a: jnp.moveaxis(jnp.repeat(a, K - 1, axis=0), 0, -1), pj)
    lanes = {foh: jdisc._aug_rk4_soa(
        mj, pflat, flat(X[:, :-1]), flat(U[:, :-1]), flat(U[:, 1:]),
        jnp.repeat(sig, K - 1), 1.0 / (K - 1), SUBSTEPS, foh,
        lane_fanout=False) for foh in (True, False)}
    return disc, lanes


def _unflat(a):
    """(..., L) SoA -> (B, K-1, ...) batch-first."""
    a = np.asarray(a)
    a = a.reshape(a.shape[:-1] + (B, K - 1))
    return np.moveaxis(np.moveaxis(a, -1, 0), -1, 0)


@pytest.fixture(scope="module")
def case():
    d, X, U, sig = _inputs(0)
    pj = jrk.Rocket6DoFParams(**{k: jnp.asarray(v) for k, v in d.items()})
    disc_j, lanes_j = _jax_side(pj, jnp.asarray(X), jnp.asarray(U),
                                jnp.asarray(sig))
    pt = trk.params_from_numpy(d, device="cpu", dtype=F64)
    t = lambda a: torch.as_tensor(a, dtype=F64)  # noqa: E731
    return dict(pt=pt, X=t(X), U=t(U), sig=t(sig), disc_j=disc_j,
                lanes_j={foh: [_unflat(o) for o in outs]
                         for foh, outs in lanes_j.items()})


def _close(a, ref, name):
    ref = np.asarray(ref)
    np.testing.assert_allclose(a.detach().numpy(), ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max(), err_msg=name)


@pytest.mark.parametrize("foh", [True, False], ids=["foh", "zoh"])
def test_plain_matches_aug_rk4_soa(case, foh):
    outs = cuda_disc.discretize_lanes_plain(
        trk.rocket6dof_model(), case["pt"], case["X"], case["U"], case["sig"],
        SUBSTEPS, foh)
    for name, a, ref in zip(OUTPUTS, outs, case["lanes_j"][foh]):
        assert a.shape == ref.shape, name
        _close(a, ref, name)
    if not foh:
        assert float(outs[2].abs().max()) == 0.0   # ZOH: no u_{k+1} term


def test_discretize_matches_jax(case):
    """After the move, the port's discretize (plain on the CPU, with the
    retraction composed outside) still matches the JAX discretize."""
    disc_t = tdisc.discretize(trk.rocket6dof_model(), case["pt"], case["X"],
                              case["U"], case["sig"], SUBSTEPS)
    for f in disc_t._fields:
        _close(getattr(disc_t, f), getattr(case["disc_j"], f), f)


def test_kernel_params_packing():
    """kernel_params: (P..., 11) in the kernel's field order, for a batched,
    an unbatched and a broadcast field."""
    d = _params_np(3)
    pt = trk.params_from_numpy(d, device="cpu", dtype=F64)
    pk = trk.kernel_params(pt)
    want = np.concatenate([np.reshape(d[k], (B, -1))
                           for k in trk.KERNEL_FIELDS], axis=1)
    assert pk.shape == (B, 11) and pk.is_contiguous()
    np.testing.assert_array_equal(pk.numpy(), want)
    p0 = trk.default_params(F64)
    assert trk.kernel_params(p0).shape == (11,)
    pb = pt.replace(alpha_m=torch.tensor(0.5, dtype=F64))   # broadcast field
    pkb = trk.kernel_params(pb)
    assert pkb.shape == (B, 11) and bool((pkb[:, 0] == 0.5).all())
    np.testing.assert_array_equal(pkb[:, 1:].numpy(), want[:, 1:])


def test_kernel_wrapper_refuses(case):
    """On CPU tensors, on mixed dtypes and on a model without CUDA dynamics
    the kernel wrapper raises (the last names the model)."""
    model = trk.rocket6dof_model()
    args = (case["pt"], case["X"], case["U"], case["sig"], SUBSTEPS)
    with pytest.raises(ValueError, match="cpu"):
        cuda_disc.discretize_lanes(model, *args)
    with pytest.raises(ValueError, match="mixed dtypes"):
        cuda_disc.discretize_lanes(model, case["pt"], case["X"].float(),
                                   case["U"], case["sig"], SUBSTEPS)
    bare = dataclasses.replace(model, name="rocket6dof_bare",
                               cuda_params=None)
    with pytest.raises(ValueError, match="rocket6dof_bare"):
        cuda_disc.discretize_lanes(bare, *args)
    assert cuda_disc.discretize_lanes.launches == 0


def test_discretize_off_the_cpu_never_falls_back(case, monkeypatch):
    """Off the CPU discretize takes the kernel wrapper, which launches or
    raises ('meta' tensors are neither CPU nor CUDA); the plain version is
    never called, also for a model without CUDA dynamics."""
    def plain(*args):
        raise AssertionError("the plain version ran off the CPU")

    monkeypatch.setattr(cuda_disc, "discretize_lanes_plain", plain)
    model = trk.rocket6dof_model()
    pm = case["pt"].map(lambda v, tail: v.to("meta"))
    args = (pm, case["X"].to("meta"), case["U"].to("meta"),
            case["sig"].to("meta"), SUBSTEPS)
    with pytest.raises(ValueError, match="meta"):
        tdisc.discretize(model, *args)
    bare = dataclasses.replace(model, name="rocket6dof_bare",
                               cuda_params=None)
    with pytest.raises(ValueError, match="rocket6dof_bare"):
        tdisc.discretize(bare, *args)
    assert cuda_disc.discretize_lanes.launches == 0


def test_discretize_on_the_cpu_takes_the_plain_version(case, monkeypatch):
    calls = []
    plain = cuda_disc.discretize_lanes_plain

    def counted(*args):
        calls.append(args)
        return plain(*args)

    monkeypatch.setattr(cuda_disc, "discretize_lanes_plain", counted)
    tdisc.discretize(trk.rocket6dof_model(), case["pt"], case["X"], case["U"],
                     case["sig"], 1)
    assert len(calls) == 1 and cuda_disc.discretize_lanes.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("foh", [True, False], ids=["foh", "zoh"])
def test_propagate_equals_discretize_x_prop_bitwise(case, dtype, foh):
    """SCvx takes the subproblem's defect at the reference from discretize
    and the merit's from propagate: on the CPU both run the plain RK4 and
    agree exactly, in f32 too."""
    model = trk.rocket6dof_model()
    pt = case["pt"].map(lambda v, tail: v.to(dtype))
    args = (pt, case["X"].to(dtype), case["U"].to(dtype),
            case["sig"].to(dtype), SUBSTEPS, foh)
    x_lin = tdisc.discretize(model, *args).x_prop
    x_nl = tdisc.propagate(model, *args)
    assert x_nl.dtype == dtype and torch.equal(x_lin, x_nl)

