"""The pieces that decide where the program runs: the compile-cache
directory, the distributed-init switch, and chip_smoke.py's device check
and plain reference (checked against numpy on the CPU)."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_dir_defaults_to_checkout(monkeypatch):
    from vq_tpu import cli

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cli.compilation_cache_dir() == os.path.join(ROOT, ".jax_cache")
    ignored = open(os.path.join(ROOT, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_compile_cache_dir_honours_env(monkeypatch):
    from vq_tpu import cli

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert cli.compilation_cache_dir() is None
    before = jax.config.jax_compilation_cache_dir
    cli._enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_dist_init_failure_raises(monkeypatch):
    """With VQ_DIST_INIT set, a failed jax.distributed.initialize() must
    surface instead of silently running as one process."""
    from vq_tpu.dist import mesh

    def boom(*a, **kw):
        raise RuntimeError("no coordinator")

    monkeypatch.setenv("VQ_DIST_INIT", "1")
    monkeypatch.setattr(jax.distributed, "initialize", boom)
    with pytest.raises(RuntimeError, match="coordinator"):
        mesh.maybe_init_distributed()
    monkeypatch.delenv("VQ_DIST_INIT")
    mesh.maybe_init_distributed()  # unset: no-op


def test_chip_smoke_refuses_cpu(capsys):
    import chip_smoke

    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok": true' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the repo, the script exits non-zero
    and prints no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("metric", ["l2", "ip", "nip"])
def test_chip_smoke_reference_matches_numpy(metric):
    import chip_smoke

    rng = np.random.default_rng(5)
    n, d, nq, k = 1000, 24, 7, 6
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    norms = np.linalg.norm(x, axis=1) * rng.uniform(0.5, 2.0, n)
    allowed = rng.random((nq, n)) < 0.4
    s, i = chip_smoke.reference_topk(
        q, lambda i0, i1: x[i0:i1], n, k, metric,
        norms=norms.astype(np.float32),
        allowed_fn=lambda i0, i1: allowed[:, i0:i1], chunk=300)

    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    if metric == "l2":
        score = -((q64[:, None, :] - x64[None]) ** 2).sum(-1)
    elif metric == "ip":
        score = q64 @ x64.T
    else:
        score = (q64 @ x64.T) / norms[None, :]
    score = np.where(allowed, score, -np.inf)
    ref_i = np.argsort(-score, axis=1, kind="stable")[:, :k]
    ref_s = np.take_along_axis(score, ref_i, axis=1)
    if metric == "l2":
        ref_s = -ref_s
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(s, ref_s, rtol=1e-5, atol=1e-4)
    assert chip_smoke.overlap(i, ref_i) == 1.0
