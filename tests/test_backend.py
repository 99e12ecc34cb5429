"""Backend-dependent choices: the solver default on an accelerator, the
object dtype through the fast paths, the compile-cache directory, and
``chip_smoke.py`` refusing to run without a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

import xerus_tpu as xe
from xerus_tpu import TTTensor
from xerus_tpu.examples import heisenberg_mpo, laplace_operator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def backend(monkeypatch):
    """Make jax.default_backend() report the given platform."""
    import jax

    def set_to(name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)
    return set_to


@pytest.mark.parametrize("platform,expected", [("gpu", "lanczos"),
                                               ("cpu", "exact")])
def test_smallest_eigenvalue_default_solver(backend, monkeypatch, platform,
                                            expected):
    from xerus_tpu.algorithms import eigensolver
    from xerus_tpu.config import on_accelerator
    from xerus_tpu.ops import dmrg_kernels
    backend(platform)
    assert on_accelerator() == (platform != "cpu")
    taken = []
    monkeypatch.setattr(dmrg_kernels, "dmrg_groundstate_scan",
                        lambda *a, **k: taken.append("lanczos") or -1.0)

    class Exact:
        def __init__(self, *a):
            pass

        def __call__(self, *a):
            taken.append("exact")
            return -1.0
    monkeypatch.setattr(eigensolver, "EigenALSVariant", Exact)
    x = TTTensor.random([2] * 4, 2)
    assert xe.smallest_eigenvalue(heisenberg_mpo(4), x, max_rank=2) == -1.0
    assert taken == [expected]


def _spy(monkeypatch, module, name, seen):
    """Wrap module.name so the dtype string it is built for is recorded."""
    real = getattr(module, name)

    def spy(shape_key, *args, **kwargs):
        seen.extend(a for a in args if a in ("float32", "float64"))
        return real(shape_key, *args, **kwargs)
    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("path", ["als", "dmrg", "round_fast"])
def test_fast_paths_keep_f64_on_accelerator(backend, monkeypatch, path):
    """With an accelerator backend the kernels run in the object dtype
    (float64) and reach f64-level accuracy — no downcast to float32."""
    from xerus_tpu.ops import dmrg_kernels, tt_kernels
    backend("gpu")
    seen = []
    if path == "als":
        _spy(monkeypatch, tt_kernels, "make_als_run", seen)
        dims = [2] * 6
        A, b = laplace_operator(dims), TTTensor.ones(dims)
        x = TTTensor.random(dims, 6)
        xe.ALS_SPD(A, x, b, 1e-13)
        Am = A.to_tensor().to_ndarray().reshape(64, 64)
        xv = x.to_tensor().to_ndarray().reshape(-1)
        assert np.linalg.norm(Am @ xv - 1.0) / 8.0 < 1e-11
    elif path == "dmrg":
        _spy(monkeypatch, dmrg_kernels, "make_dmrg_run", seen)
        H = heisenberg_mpo(6)
        x = TTTensor.random([2] * 6, 8)
        lam = xe.smallest_eigenvalue(H, x, max_rank=8)
        exact = np.linalg.eigvalsh(
            H.to_tensor().to_ndarray().reshape(64, 64))[0]
        assert abs(lam - exact) < 1e-10 * abs(exact)
    else:
        x = TTTensor.random([2] * 8, 8)
        dense = x.to_tensor().to_ndarray()
        x.round_fast(16, method="svd")       # lossless: ranks already <= 8
        seen.extend(str(c.to_ndarray().dtype) for c in x.components)
        assert (np.linalg.norm(x.to_tensor().to_ndarray() - dense)
                < 1e-12 * np.linalg.norm(dense))
    assert seen and set(seen) == {"float64"}


@pytest.mark.parametrize("env_dir", [True, False])
def test_enable_compile_cache(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise <repo>/.jax_cache.
    Either way exactly that directory is handed to JAX."""
    import jax
    from xerus_tpu.config import enable_compile_cache
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
    assert enable_compile_cache() == want
    assert updates["jax_compilation_cache_dir"] == want


def test_chip_smoke_refuses_cpu_backend(monkeypatch, capsys):
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    monkeypatch.setattr(chip_smoke, "_nvidia_smi",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(chip_smoke, "phase0_gpu_tests", lambda: {})
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert chip_smoke.main([]) != 0
    out, err = capsys.readouterr()
    assert '"ok"' not in out and "not a GPU" in err


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """Without the rest of the repository (and without a GPU) the script
    fails and prints no result line."""
    src = os.path.join(REPO, "chip_smoke.py")
    dst = tmp_path / "chip_smoke.py"
    dst.write_text(open(src).read())
    r = subprocess.run([sys.executable, str(dst)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
