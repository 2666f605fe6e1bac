"""Build polypolish_tpu's native library and replica binary under a lock
before any test module is imported (see tests/torch_builds.py): the
package's own builds, which some test modules run at import, are
unlocked and race under pytest-xdist."""

import subprocess


def pytest_configure(config):
    from tests import torch_builds

    try:
        torch_builds.build_jax_native()
        torch_builds.build_jax_replica()
    except (OSError, subprocess.SubprocessError):
        pass  # no compiler: the package's own build reports it and skips
