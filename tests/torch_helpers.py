"""Helpers of the port's tests: ranks of a ``torch.distributed`` run on the
CPU, and trees of the two packages compared by name.

Each rank is a child process running a worker script with gloo on a port
found free by binding port 0 (never a fixed port: the JAX package's tests
hold several). Every child is waited for with a timeout and killed by its
exact PID when a test ends early.
"""

import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def child_env() -> dict:
    """One torch thread a child; the repository on the path."""
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))


def spawn(argvs) -> list:
    """One child a command line in ``argvs``, run with this interpreter."""
    procs = []
    try:
        for argv in argvs:
            procs.append(subprocess.Popen(
                [sys.executable, *argv], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, env=child_env(), cwd=ROOT))
    except BaseException:
        kill(procs)
        raise
    return procs


def finish(procs, timeout: float = 120) -> list:
    """Each child's output once it has exited; raises if one fails."""
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {i} exited with {p.returncode}:\n"
                                 f"{out[-3000:]}")
    return outs


def kill(procs) -> None:
    """Kill every child still running, by its PID, and reap it."""
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=60)
        if p.stdout is not None:
            p.stdout.close()


def random_like(shapes, rng):
    """Distinct random leaves (numpy) of the shapes and dtypes of a tree of
    ``jax.ShapeDtypeStruct``, so that leaves swapped in order cannot
    compare equal."""
    import jax
    import jax.numpy as jnp

    def one(a):
        if a.dtype == np.bool_:
            return jnp.asarray(rng.random(a.shape) > 0.5)
        if np.issubdtype(a.dtype, np.integer):
            return jnp.asarray(rng.integers(0, 1000, a.shape), a.dtype)
        return jnp.asarray(rng.standard_normal(a.shape), a.dtype)
    return jax.tree.map(one, shapes)


def assert_same_by_name(port, ref, where=""):
    """Every leaf of the port's tree equals the JAX tree's leaf of the same
    field name or key, bit for bit (matched by name, not by order)."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), where
        for k in ref:
            assert_same_by_name(port[k], ref[k], f"{where}[{k!r}]")
    elif hasattr(ref, "_fields"):
        assert port._fields == ref._fields, where
        for f in ref._fields:
            assert_same_by_name(getattr(port, f), getattr(ref, f),
                                f"{where}.{f}")
    else:
        assert tuple(port.shape) == tuple(ref.shape), where
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref),
                                      err_msg=where)
