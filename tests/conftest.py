import os
import subprocess
import sys
import textwrap

import pytest

# The container has no `hypothesis`; fall back to the minimal deterministic
# shim in tests/_shims (same @given/@settings/strategies surface).  conftest
# is imported before any test module, so the path is in place in time.
try:
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "_shims"))

# NOTE: no XLA_FLAGS here on purpose — unit/smoke tests must see the real
# (single) device.  Multi-device tests spawn subprocesses via `run_devices`.

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_devices(script: str, n_devices: int = 8, timeout: int = 900) -> str:
    """Run `script` in a subprocess with n host devices; returns stdout."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + f" --xla_force_host_platform_device_count={n_devices}").strip()
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(script)],
                       capture_output=True, text=True, timeout=timeout,
                       env=env)
    if r.returncode != 0:
        raise AssertionError(f"subprocess failed:\nSTDOUT:\n{r.stdout}\n"
                             f"STDERR:\n{r.stderr[-4000:]}")
    return r.stdout


@pytest.fixture
def subproc():
    return run_devices


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
