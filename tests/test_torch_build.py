"""PyTorch port: the kernel build (``ops/_build.py``) on the CPU, with a
temporary ``csrc`` directory and, where a build runs, a stand-in ``nvcc``
script on ``PATH`` (the CPU tests run without a CUDA compiler): a library
is named by its source, every ``csrc/*.cuh`` header and the flags, so an
edited header is never served from a stale library; a build keeps
``ptxas``'s report beside the library, builds once, and raises with the
compiler's errors."""

import os
import stat

import pytest

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import _build


@pytest.fixture(autouse=True, scope="module")
def _detached_compile_trackers():
    """A compile tracker that an earlier telemetry test installed in this
    worker rejects the ``fun_name`` keyword jax 0.9 passes to duration
    listeners, failing every later jax compile in the worker. Remove every
    installed tracker before and after this module, leaving the worker as a
    fresh one would be (a later telemetry test installs its own)."""
    _drop_compile_trackers()
    yield
    _drop_compile_trackers()


def _drop_compile_trackers():
    try:
        from jax import monitoring

        from huggingface_sagemaker_tensorflow_distributed_tpu.obs import watchdog
    except ImportError:
        return
    for tracker in watchdog._INSTALLED:
        try:
            monitoring.unregister_event_duration_listener(tracker.observe)
        except AssertionError:
            pass
    watchdog._INSTALLED.clear()


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "k_tc.cuh"\nint k() { return 1; }\n')
    (src / "k_tc.cuh").write_text("#pragma once\n")
    (src / "mma.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build" / "kernels")
    return src


EDITS = [
    # name, edit of the csrc directory, whether the library name changes
    ("included_header", lambda d: (d / "k_tc.cuh").write_text("#pragma once\n// v2\n"), True),
    ("other_header", lambda d: (d / "mma.cuh").write_text("#pragma once\n// v2\n"), True),
    ("new_header", lambda d: (d / "new.cuh").write_text("#pragma once\n"), True),
    ("source", lambda d: (d / "k.cu").write_text("int k() { return 2; }\n"), True),
    ("other_source", lambda d: (d / "other.cu").write_text("int other();\n"), False),
    ("text_file", lambda d: (d / "notes.txt").write_text("notes\n"), False),
]


@pytest.mark.parametrize("edit", EDITS, ids=[e[0] for e in EDITS])
def test_library_path_follows_source_and_headers(csrc, edit):
    _, change, renamed = edit
    before = _build.library_path("k")
    assert before.parent == _build.BUILD_DIR and before.name.startswith("k-")
    change(csrc)
    assert (_build.library_path("k") != before) is renamed


def test_library_path_follows_flags(csrc, monkeypatch):
    before = _build.library_path("k")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("k") != before
    assert _build.build_log("k") == _build.library_path("k").with_suffix(".log")


def _fake_nvcc(bindir, script_body):
    bindir.mkdir(exist_ok=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + script_body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return nvcc


def test_build_keeps_the_ptxas_report_and_builds_once(csrc, tmp_path, monkeypatch):
    calls = tmp_path / "calls"
    # writes the file after -o, reports like ptxas on stderr, counts calls
    _fake_nvcc(tmp_path / "bin", f"""
echo call >> {calls}
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
printf 'lib' > "$out"
echo "ptxas info    : Used 96 registers, 400 bytes cmem[0]" >&2
""")
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}")
    _build.build("k")
    lib = _build.library_path("k")
    assert lib.read_text() == "lib"
    assert "Used 96 registers" in _build.build_log("k").read_text()
    assert not list(lib.parent.glob("*.tmp"))
    _build.build("k")                           # already built: nvcc is not run
    assert calls.read_text().count("call") == 1
    (csrc / "k_tc.cuh").write_text("#pragma once\n// edited\n")
    _build.build("k")                           # a header edit rebuilds
    assert calls.read_text().count("call") == 2 and _build.library_path("k").exists()


def test_failed_build_raises_with_the_compiler_errors(csrc, tmp_path, monkeypatch):
    _fake_nvcc(tmp_path / "bin", 'echo "k.cu(2): error: expected a ;" >&2\nexit 2\n')
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}")
    with pytest.raises(RuntimeError, match=r"csrc/k.cu \(exit 2\):\nk.cu\(2\): error"):
        _build.build("k")
    assert not _build.library_path("k").exists()
    assert not _build.build_log("k").exists()
