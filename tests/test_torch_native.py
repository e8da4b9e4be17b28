"""PyTorch port: the C++ host library (``csrc/host/*.cc``, built by
``ops/_build.py::build_host`` with ``g++`` into ``build/host/``, bound in
``data/native.py``) against the JAX package's native helpers on the same
seeded numpy inputs: the epoch permutation, the row gather, the row
lengths and the line index are equal, from the C++ build and from the
numpy twins. The build lands in the port's build directory, never in the
JAX package's ``native/``; a failed build raises, and nothing falls back
to Python unless the caller asks for it."""

import shutil
from pathlib import Path

import numpy as np
import pytest

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import native as t_native
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import tokenization as t_tok
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import _build

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ on PATH: the host library cannot be built")


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


@needs_gxx
def test_build_lands_in_the_port_build_dir(tmp_path, monkeypatch):
    """A build from the sources goes to ``build/host`` (here a temporary
    one), named by a hash of the sources and flags, and is reused; the
    library the port loads is never the JAX package's ``native/`` one."""
    loaded = Path(t_native.load_native()._name)
    assert loaded == _build.host_library_path()
    assert loaded.parent.name == "host" and loaded.parent.parent.name == "build"
    assert "native" not in loaded.parts
    assert _build.HOST_DIR.parent.name == "csrc" and _build.HOST_DIR.parents[1].name.endswith(
        "_torch")
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "host")
    path = _build.host_library_path()
    assert path.parent == tmp_path / "host" and path.name == loaded.name
    assert _build.build_host() == path and path.exists()
    mtime = path.stat().st_mtime_ns
    assert _build.build_host() == path and path.stat().st_mtime_ns == mtime


@needs_gxx
def test_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s errors; no g++
    raises; and ``load_tokenizer`` of a ``vocab.txt`` then raises instead
    of handing back the Python twin, unless the caller asks for it."""
    src = tmp_path / "csrc"
    src.mkdir()
    for name in _build.HOST_SOURCES:
        (src / name).write_text("int broken( {\n")
    monkeypatch.setattr(_build, "HOST_DIR", src)
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "host")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _build.build_host()
    assert not list((tmp_path / "host").glob("*.so"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.build_host()

    monkeypatch.setattr(t_native, "_lib", None)
    _build.load_host.cache_clear()
    try:
        wp = tmp_path / "wp"
        wp.mkdir()
        (wp / "vocab.txt").write_text("[PAD]\n[UNK]\n[CLS]\n[SEP]\nhello\n")
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            t_tok.load_tokenizer(str(wp))
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            t_native.native_row_lengths(np.ones((2, 3), np.int32))
        tok = t_tok.load_tokenizer(str(wp), prefer_native=False)
        assert type(tok).__name__ == "WordPieceTokenizer"
        np.testing.assert_array_equal(
            t_native.native_row_lengths(np.ones((2, 3), np.int32), native=False), [3, 3])
    finally:
        _build.load_host.cache_clear()


@needs_gxx
@pytest.mark.parametrize("native", [True, False], ids=["cpp", "numpy"])
@pytest.mark.parametrize("n,seed", [(1, 0), (37, 5), (1000, 43), (10_000, 2**40 + 3)])
def test_permutation_matches_jax(native, n, seed):
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.native import (
        native_permutation,
    )

    got = t_native.native_permutation(n, seed, native=native)
    np.testing.assert_array_equal(got, native_permutation(n, seed))
    assert got.dtype == np.int64 and sorted(got.tolist()) == list(range(n))


@needs_gxx
@pytest.mark.parametrize("native", [True, False], ids=["cpp", "numpy"])
def test_gather_matches_jax(native):
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.native import native_gather

    rng = np.random.RandomState(0)
    src2 = rng.randint(0, 1000, size=(97, 33)).astype(np.int32)
    src1 = rng.randint(0, 1000, size=97).astype(np.int32)
    idx = rng.randint(0, 97, size=64)
    for src in (src2, src1, src2.astype(np.int64), src2[:, ::2]):
        np.testing.assert_array_equal(t_native.native_gather(src, idx, native=native),
                                      native_gather(src, idx))
    out = np.empty((64, 33), np.int32)
    assert t_native.native_gather(src2, idx, out=out, native=native) is out
    np.testing.assert_array_equal(out, src2[idx])
    mask = rng.rand(97) > 0.5
    np.testing.assert_array_equal(t_native.native_gather(src2, mask, native=native),
                                  native_gather(src2, mask))
    np.testing.assert_array_equal(t_native.native_gather(src2, np.array([-1, 0]),
                                                         native=native), src2[[-1, 0]])
    with pytest.raises(IndexError):
        t_native.native_gather(src2, np.array([0, 97]), native=native)


@needs_gxx
@pytest.mark.parametrize("native", [True, False], ids=["cpp", "numpy"])
def test_row_lengths_match_jax(native):
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.native import (
        native_row_lengths,
    )

    rng = np.random.RandomState(1)
    lengths = rng.randint(0, 65, size=300)
    mask = (np.arange(64)[None, :] < lengths[:, None]).astype(np.int32)
    mask[5, 10] = 7          # any nonzero counts
    got = t_native.native_row_lengths(mask, native=native)
    np.testing.assert_array_equal(got, native_row_lengths(mask))
    assert got.dtype == np.int32


def _corpus(path: Path, n: int, seed: int, trailing: str) -> Path:
    rng = np.random.RandomState(seed)
    lines = ["x" * int(k) + ("é" if k % 3 == 0 else "") for k in rng.randint(0, 120, size=n)]
    path.write_text("\n".join(lines) + trailing, encoding="utf-8")
    return path


@needs_gxx
@pytest.mark.parametrize("native", [True, False], ids=["cpp", "numpy"])
@pytest.mark.parametrize("trailing", ["\n", "", "\r\n"], ids=["lf", "none", "crlf"])
def test_line_boundaries_match_jax(tmp_path, native, trailing):
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.native import (
        native_line_boundaries,
    )

    for n, seed in ((1, 0), (500, 1), (5000, 2)):
        path = _corpus(tmp_path / f"c{n}.txt", n, seed, trailing)
        got = t_native.native_line_boundaries(str(path), native=native)
        np.testing.assert_array_equal(got, native_line_boundaries(str(path)))
    empty = tmp_path / "empty.txt"
    empty.write_text("")
    np.testing.assert_array_equal(t_native.native_line_boundaries(str(empty), native=native),
                                  [0])
