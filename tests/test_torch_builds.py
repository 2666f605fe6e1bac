"""tests/torch_builds.py's locked builds: a file is fresh only when it is
newer than its source AND usable (executable, or loadable for a
library); otherwise it is rebuilt under the lock.  A half-linked binary
renamed into place by an unlocked build is newer than its source but not
executable, and must not be trusted."""

import os
import stat
import sys

from tests import torch_builds


def _copy_cmd(src):
    # a stand-in compiler: copy the source and mark it executable
    return lambda out: [sys.executable, "-c",
                        "import os, shutil, sys; shutil.copy(sys.argv[1], "
                        "sys.argv[2]); os.chmod(sys.argv[2], 0o755)",
                        src, out]


def _case(tmp_path):
    src = tmp_path / "tool.src"
    src.write_text("new build\n")
    out = tmp_path / "tool"
    out.write_text("old build\n")
    later = os.path.getmtime(src) + 10
    os.utime(out, (later, later))  # newer than its source
    return str(src), str(out)


def test_fresh_executable_is_kept(tmp_path):
    src, out = _case(tmp_path)
    os.chmod(out, 0o755)
    torch_builds.locked_build(out, src, _copy_cmd(src),
                              torch_builds._executable)
    assert open(out).read() == "old build\n"


def test_fresh_but_not_executable_is_rebuilt(tmp_path):
    src, out = _case(tmp_path)
    os.chmod(out, 0o644)  # what a half-linked rename leaves behind
    torch_builds.locked_build(out, src, _copy_cmd(src),
                              torch_builds._executable)
    assert open(out).read() == "new build\n"
    assert os.stat(out).st_mode & stat.S_IXUSR
    assert sorted(os.listdir(tmp_path)) == ["tool", "tool.lock",
                                            "tool.src"]


def test_library_that_does_not_load_is_rebuilt(tmp_path):
    src, out = _case(tmp_path)
    assert not torch_builds._loads(out)  # text, not a shared object
    torch_builds.locked_build(out, src, _copy_cmd(src), torch_builds._loads)
    assert open(out).read() == "new build\n"


def test_stale_file_is_rebuilt(tmp_path):
    src, out = _case(tmp_path)
    os.chmod(out, 0o755)
    earlier = os.path.getmtime(src) - 10
    os.utime(out, (earlier, earlier))
    torch_builds.locked_build(out, src, _copy_cmd(src),
                              torch_builds._executable)
    assert open(out).read() == "new build\n"


def test_jax_package_binaries_usable():
    """After the root conftest's builds both JAX-package binaries are
    in place and usable."""
    assert torch_builds._loads(torch_builds.LIB)
    assert torch_builds._executable(torch_builds.PPREF)
