"""The port's host library build (`particlesfm_tpu_torch/native.py`
`ensure_built`) across processes: one builder at a time, and the library's
path never names a half-written file.

Under xdist every worker collects every module, in file-name order. This
module sorts before tests/test_native.py, so each worker's collection of it
builds the shared library once, under the lock, before test_native.py's
collection looks for a whole one.
"""
import fcntl
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from particlesfm_tpu_torch import native

pytestmark = pytest.mark.skipif(not native.ensure_built(),
                                reason="native toolchain unavailable")

REPO = Path(__file__).resolve().parents[1]

# A process that loads native.py on its own (no package import), points it at
# a copy of native/, builds and loads the library, and runs one entry point.
CHILD = textwrap.dedent("""
    import importlib.util, sys
    from pathlib import Path
    import numpy as np
    spec = importlib.util.spec_from_file_location("native_under_test", sys.argv[1])
    native = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(native)
    d = Path(sys.argv[2])
    native._NATIVE_DIR, native._LIB_PATH = d, d / "libparticlesfm_host.so"
    native._LOCK_PATH = d / ".build.lock"
    built = native.ensure_built()
    labels = native.connected_components(4, np.array([[0, 1], [2, 3]], np.int32))
    print(built, labels is not None and labels[0] == labels[1] != labels[2] == labels[3])
""")


def _native_copy(tmp_path):
    d = tmp_path / "native"
    d.mkdir()
    for f in ("Makefile", "hostops.cc"):
        shutil.copy2(REPO / "native" / f, d)
    return d


def _child(d):
    return subprocess.Popen([sys.executable, "-c", CHILD,
                             str(REPO / "particlesfm_tpu_torch" / "native.py"), str(d)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _ok(p):
    out, err = p.communicate(timeout=180)
    assert p.returncode == 0, err
    assert out.split() == ["True", "True"], (out, err)


@pytest.mark.parametrize("n", [1, 4])
def test_concurrent_builds_leave_one_whole_library(tmp_path, n):
    d = _native_copy(tmp_path)
    procs = [_child(d) for _ in range(n)]
    for p in procs:
        _ok(p)
    assert sorted(f.name for f in d.iterdir()) == [
        ".build.lock", "Makefile", "hostops.cc", "libparticlesfm_host.so"]


def test_a_waiting_builder_builds_after_the_lock_is_released(tmp_path):
    d = _native_copy(tmp_path)
    with open(d / ".build.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        p = _child(d)
        time.sleep(1.0)
        assert p.poll() is None, "the builder did not wait for the lock"
        assert not (d / "libparticlesfm_host.so").exists()
        fcntl.flock(lock, fcntl.LOCK_UN)
        _ok(p)
    assert (d / "libparticlesfm_host.so").exists()
