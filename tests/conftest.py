"""Test configuration: force CPU with 8 virtual devices so multi-device
sharding tests run without accelerator hardware (SURVEY.md §4 rebuild
mapping).

``XERUS_TEST_ON_GPU=1`` (set by ``chip_smoke.py`` for its phase 0) keeps
the session's default platform instead; it changes the platform only,
never which tests are collected.  The ``gpu``-marked tests
(tests/test_gpu.py) decide inside a fixture whether a card is present.
"""

import os
import resource

# XLA's CPU compiler (LLVM passes) can recurse deeply on large fused
# programs (whole-sweep scan kernels); the default 8 MiB main-thread
# stack has been observed to segfault mid-compile late in the suite.
# The Linux main stack grows on demand up to the CURRENT soft rlimit,
# so raising it here (hard limit is unlimited in this image) gives the
# compiler room without any spawning tricks.
_soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
if _hard == resource.RLIM_INFINITY or _hard >= 512 * 1024 * 1024:
    resource.setrlimit(resource.RLIMIT_STACK, (512 * 1024 * 1024, _hard))

ON_GPU = os.environ.get("XERUS_TEST_ON_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _fresh_compile_state_per_module():
    """Drop all jitted executables before each test module.

    The XLA CPU compiler segfaults (rc=139, inside
    `backend_compile_and_load`) once a single process has accumulated a
    few hundred compiled programs — reproduced at different modules on
    different runs (test_parallel.py in r1, test_mixed_precision.py in
    r2), while every module passes in isolation and a raised
    RLIMIT_STACK does not help.  Clearing the caches at module
    boundaries reproduces the passing fresh-process condition
    everywhere instead of papering over one module at a time; the
    recompile cost is bounded by each module's own program set (the
    reference suite runs all 154 tests in one process,
    test.cpp:196-214, which is the invariant this preserves)."""
    jax.clear_caches()
    yield


@pytest.fixture(autouse=True)
def _deterministic_seed(request):
    """Deterministic seed per test (reference: 0xBAADF00D, test.cpp:90-96).

    Runner parity with the reference's `XerusTest group:test:seed`
    (test.cpp:196-214): set XERUS_TEST_SEED=<int> to replay a specific
    seed, or XERUS_TRULY_RANDOM_UNITTESTS=1 for a fresh random seed per
    test — the chosen seed is printed on failure for replay
    (test.cpp:131-133 semantics)."""
    import secrets
    import xerus_tpu
    if "XERUS_TEST_SEED" in os.environ:
        seed = int(os.environ["XERUS_TEST_SEED"], 0)
    elif os.environ.get("XERUS_TRULY_RANDOM_UNITTESTS"):
        seed = secrets.randbits(32)
    else:
        seed = 0xBAADF00D
    request.node._xerus_seed = seed
    xerus_tpu.set_seed(seed)
    yield


def pytest_runtest_makereport(item, call):
    if (call.when == "call" and call.excinfo is not None
            and not call.excinfo.errisinstance(pytest.skip.Exception)):
        seed = getattr(item, "_xerus_seed", None)
        if seed is not None:
            print(f"\n[xerus_tpu] failing seed: replay with "
                  f"XERUS_TEST_SEED={seed}")


def pytest_sessionfinish(session, exitstatus):
    """XERUS_TEST_COVERAGE=1: dump the require()-landmark hit set
    (reference XERUS_TEST_COVERAGE, test.h:40-51); report with
    `python -m xerus_tpu.misc.coverage`."""
    if os.environ.get("XERUS_TEST_COVERAGE"):
        from xerus_tpu.misc import coverage
        coverage.dump(os.path.join(".require_coverage", f"{os.getpid()}.txt"))
