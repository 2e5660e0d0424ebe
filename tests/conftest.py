"""Test configuration: the suite runs on the CPU backend with a simulated
8-device mesh, so multi-device sharding paths are exercised without
accelerators. Tests marked `card` need a GPU: they skip elsewhere and run
on the card inside `python chip_smoke.py` (or with
`JAX_PLATFORMS=cuda python -m pytest tests -m card -o addopts=`).
"""
import os
import resource

import pytest

# XLA:CPU's LLVM compile of the big fused programs (the multi-stage MLE
# ladder) intermittently segfaults mid-suite in constrained environments —
# the faulting frame is always backend_compile_and_load on a fresh
# (uncached) compile. glibc sizes NEW pthread stacks from the soft
# RLIMIT_STACK, so raise it to 64 MB BEFORE jax (and its compile thread
# pool) starts: deep LLVM pass recursion then has headroom. Must precede
# `import jax`.
try:
    _soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
    _want = 64 * 1024 * 1024
    if _soft != resource.RLIM_INFINITY and _soft < _want:
        _cap = _hard if _hard != resource.RLIM_INFINITY else _want
        resource.setrlimit(resource.RLIMIT_STACK, (min(_want, _cap), _hard))
except (ValueError, OSError):  # pragma: no cover - restricted environments
    pass

# CPU unless the caller chose a platform; a process that already started
# JAX (chip_smoke.py running the card tests) keeps its backend
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


@pytest.fixture
def card():
    """The GPU a `card`-marked test runs on; skips where there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU, found {dev.platform}; runs on the card in chip_smoke.py")
    return dev
