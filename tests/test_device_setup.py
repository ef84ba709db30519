"""What keeps the GPU path honest: matmul precision pins, the compile-cache
path rule, and ``chip_smoke.py`` refusing to run anywhere but on a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

import jax
import jax.numpy as jnp
from jax.lax import Precision

from loam_jax import profiling
from loam_jax.geometry import Pose3
from loam_jax.params import RegistrationParams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dot_precisions(jaxpr, out):
    """Precision of every dot_general in a jaxpr, sub-jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for param in eqn.params.values():
            for sub in param if isinstance(param, (list, tuple)) else [param]:
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    _dot_precisions(inner, out)
    return out


def _lm_solve_jaxpr():
    from loam_jax.registration.associate import (
        EdgeAssociations, PlaneAssociations,
    )
    from loam_jax.registration.solver import _Problem, lm_solve

    n = 8
    ea = EdgeAssociations(jnp.zeros((n, 3)), jnp.ones((n, 3)),
                          jnp.ones(n, bool), jnp.zeros(n, jnp.int32))
    pa = PlaneAssociations(jnp.zeros((n, 3)), jnp.zeros(n),
                           jnp.ones(n, bool), jnp.zeros(n, jnp.int32))
    prob = _Problem(jnp.zeros((n, 3)), ea, jnp.zeros((n, 3)), pa)
    return jax.make_jaxpr(lambda p: lm_solve(p, RegistrationParams()))(prob)


def _chain(n=8):
    q = jnp.tile(jnp.asarray([1.0, 0.0, 0.0, 0.0]), (n, 1))
    t = jnp.arange(n * 3, dtype=jnp.float32).reshape(n, 3) * 0.1
    return Pose3(q, t)


def _pose_graph_jaxpr():
    from loam_jax.pose_graph import odometry_edges, optimize_pose_graph

    traj = _chain()
    edges = odometry_edges(traj)
    return jax.make_jaxpr(
        lambda t: optimize_pose_graph(t, edges, iterations=1)
    )(traj)


def _pose_graph_sharded_jaxpr():
    from loam_jax.parallel import make_mesh
    from loam_jax.pose_graph import odometry_edges, optimize_pose_graph_sharded

    traj = _chain(9)  # 8 edges: divides the 8-device test mesh
    edges = odometry_edges(traj)
    mesh = make_mesh(line_axis=1)
    return jax.make_jaxpr(
        lambda t: optimize_pose_graph_sharded(t, edges, mesh, iterations=1)
    )(traj)


@pytest.mark.parametrize("build", [
    _lm_solve_jaxpr, _pose_graph_jaxpr, _pose_graph_sharded_jaxpr,
])
def test_normal_equations_pinned_to_highest(build):
    """The normal-equation contractions must not run in TF32 on a GPU."""
    precisions = _dot_precisions(build().jaxpr, [])
    assert precisions, "no contraction found"
    assert all(p == (Precision.HIGHEST, Precision.HIGHEST)
               for p in precisions), precisions


def test_compile_cache_follows_env(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert profiling.compile_cache_dir() == "/some/where"
    assert profiling.enable_compile_cache() == "/some/where"
    assert calls == []  # JAX reads the variable itself; no other dir is set


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = profiling.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    assert profiling.compile_cache_dir({}) == path  # no time/pid/tmp parts


def test_compile_cache_dir_is_gitignored():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _smoke(ROOT, "chip_smoke.py")
    assert r.returncode != 0
    assert "GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_needs_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _smoke(str(tmp_path), "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
