"""ctypes bindings of the port's C++ host library (counterpart of the JAX
package's ``data/native.py``).

The library is built from the port's own copy of the sources
(``csrc/host/wordpiece.cc``, ``csrc/host/dataloader.cc``) by
``ops/_build.py`` with ``g++`` into ``build/host/`` at first use; the port
never writes into, or loads from, the JAX package's ``native/``
directory. A native path that is asked for builds and loads, or raises:
nothing falls back to Python behind the caller's back. Each helper has a
Python twin with identical results, which runs only when the caller asks
for it (``native=False``, ``prefer_native=False``).

- :class:`CppWordPieceTokenizer`: WordPiece with the per-character hot
  path in multithreaded C++; assembly is inherited from the Python twin
  so both produce identical arrays.
- :func:`native_permutation`: the deterministic epoch shuffle.
- :func:`native_gather`: parallel batch row-gather into a contiguous
  buffer.
- :func:`native_row_lengths`: token count per row (length bucketing).
- :func:`native_line_boundaries`: the line-offset index of a text file
  (the streaming tier's).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence

import numpy as np

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.pipeline import (
    epoch_permutation,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.wordpiece import (
    WordPieceTokenizer,
    tokenize_batch_py,
)

_lib = None
_lib_lock = threading.Lock()
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def load_native() -> ctypes.CDLL:
    """The host library with its C signatures bound (built at first use;
    raises when it cannot be built or loaded)."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops._build import (
            load_host,
        )

        lib = load_host()
        lib.wp_new.restype = ctypes.c_void_p
        lib.wp_new.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                               ctypes.c_int32]
        lib.wp_free.argtypes = [ctypes.c_void_p]
        lib.wp_vocab_size.restype = ctypes.c_int32
        lib.wp_vocab_size.argtypes = [ctypes.c_void_p]
        lib.wp_token_id.restype = ctypes.c_int32
        lib.wp_token_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.wp_tokenize_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, _i64p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _i32p, _i32p, _i32p, _i32p, _i32p]
        lib.dl_permutation.argtypes = [ctypes.c_int64, ctypes.c_uint64, _i64p]
        lib.dl_gather.argtypes = [_i32p, ctypes.c_int64, _i64p, ctypes.c_int64,
                                  _i32p, ctypes.c_int32]
        lib.dl_row_lengths.argtypes = [_i32p, ctypes.c_int64, ctypes.c_int64,
                                       _i32p, ctypes.c_int32]
        lib.dl_line_index.restype = ctypes.c_int64
        lib.dl_line_index.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                      ctypes.c_int64, ctypes.c_int32]
        _lib = lib
        return _lib


def _default_threads() -> int:
    return max(1, min(os.cpu_count() or 1, 16))


# ---------------------------------------------------------------------------
# WordPiece (C++-backed)
# ---------------------------------------------------------------------------

# The C++ core's Unicode tables equal the Python twin's (unicodedata) for
# code points below this boundary: ASCII, Latin-1 supplement, Latin
# Extended-A, which covers BERT-uncased English and Western-European
# corpora. Rows holding ANY code point at or above it are tokenized by the
# Python twin, so C++ and Python give the same ids for every input by
# construction, not by table completeness. This routing is a property of
# the row, the same on every host; it is not a fallback from a failure.
_CPP_SAFE_BOUNDARY = 0x0180


class CppWordPieceTokenizer(WordPieceTokenizer):
    """WordPiece tokenizer with the char-level core in C++.

    Drop-in for :class:`WordPieceTokenizer` (assembly inherited). Raises
    at construction when the host library cannot be built or loaded, or
    when the vocab's ids are not 0..n-1 (the C interface numbers tokens by
    position); rows past ``_CPP_SAFE_BOUNDARY`` go to the Python core."""

    def __init__(self, vocab: dict[str, int], lowercase: bool = True,
                 n_threads: Optional[int] = None, **kw):
        super().__init__(vocab, lowercase=lowercase, **kw)
        if sorted(vocab.values()) != list(range(len(vocab))):
            # a vocab with gaps or duplicate ids would shift ids in C++ only
            raise RuntimeError("the C++ tokenizer needs contiguous vocab ids "
                               "0..n-1; load with prefer_native=False")
        lib = load_native()
        self._lib = lib
        self.n_threads = n_threads or _default_threads()
        inv = sorted(vocab.items(), key=lambda kv: kv[1])
        blob = "\n".join(token for token, _ in inv).encode("utf-8")
        self._handle = lib.wp_new(blob, len(blob), int(lowercase),
                                  self.unk_token_id)
        if lib.wp_vocab_size(self._handle) != len(vocab):
            raise RuntimeError("native vocab size mismatch")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle and getattr(self, "_lib", None):
            self._lib.wp_free(handle)
            self._handle = None

    def _tokenize_batch(self, texts: Sequence[str], cap: int):
        n = len(texts)
        encoded = [t.encode("utf-8") for t in texts]
        # rows with code points past the boundary take the Python core;
        # ASCII bytes are < 0x80 so a cheap max-byte scan decides most rows
        py_rows = [r for r, b in enumerate(encoded)
                   if (max(b) >= 0xC0 if b else False)
                   and any(ord(c) >= _CPP_SAFE_BOUNDARY for c in texts[r])]
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum([len(b) for b in encoded], out=offsets[1:])
        blob = b"".join(encoded)
        ids = np.zeros((n, cap), np.int32)
        word_ids = np.full((n, cap), -1, np.int32)
        starts = np.zeros((n, cap), np.int32)
        ends = np.zeros((n, cap), np.int32)
        counts = np.zeros(n, np.int32)
        if n:
            self._lib.wp_tokenize_batch(
                self._handle, blob, offsets, n, cap,
                min(self.n_threads, n), ids, word_ids, starts, ends, counts)
        if py_rows:
            p_ids, p_wids, p_starts, p_ends, p_cnt = tokenize_batch_py(
                self.vocab, [texts[r] for r in py_rows], self.lowercase,
                self.unk_token_id, cap)
            rows = np.asarray(py_rows)
            ids[rows], word_ids[rows] = p_ids, p_wids
            starts[rows], ends[rows], counts[rows] = p_starts, p_ends, p_cnt
        return ids, word_ids, starts, ends, counts


def load_wordpiece(path: str, prefer_native: bool = True, **kw):
    """A ``vocab.txt`` directory or file as a WordPiece tokenizer: the
    C++-backed one (which raises when the host library cannot be built),
    or the Python twin when ``prefer_native=False``."""
    if prefer_native:
        return CppWordPieceTokenizer.from_pretrained(path, **kw)
    return WordPieceTokenizer.from_pretrained(path, **kw)


# ---------------------------------------------------------------------------
# Data-loader primitives (C++; numpy twins on request)
# ---------------------------------------------------------------------------

def native_permutation(n: int, seed: int, native: bool = True) -> np.ndarray:
    """The deterministic epoch permutation, identical on every host and
    platform; ``native=False`` gives the numpy twin
    (``data/pipeline.py::epoch_permutation``, bit-identical)."""
    if not native:
        return epoch_permutation(n, seed)
    out = np.empty(n, np.int64)
    load_native().dl_permutation(n, ctypes.c_uint64(seed & ((1 << 64) - 1)), out)
    return out


def native_gather(src: np.ndarray, idx: np.ndarray,
                  out: Optional[np.ndarray] = None, native: bool = True) -> np.ndarray:
    """out[b] = src[idx[b]] for a C-contiguous 1-D/2-D int32 ``src``, a
    multithreaded memcpy; other dtypes, layouts, boolean or negative
    indices take numpy's fancy indexing (as the JAX package's helper does),
    as does ``native=False``."""
    idx = np.asarray(idx)
    if (not native or src.dtype != np.int32 or not src.flags.c_contiguous
            or idx.dtype == np.bool_ or (len(idx) and idx.min() < 0)):
        result = src[idx]
        if out is not None:
            out[...] = result
            return out
        return result
    lib = load_native()
    idx = np.ascontiguousarray(idx, np.int64)
    if len(idx) and idx.max() >= src.shape[0]:
        # numpy's failure mode (dl_gather is an unchecked memcpy)
        raise IndexError(
            f"index {int(idx.max())} out of bounds for axis 0 with size {src.shape[0]}")
    row_elems = int(np.prod(src.shape[1:], dtype=np.int64)) if src.ndim > 1 else 1
    shape = (len(idx),) + src.shape[1:]
    if out is None:
        out = np.empty(shape, np.int32)
    lib.dl_gather(src.reshape(src.shape[0], -1) if src.ndim > 1 else src,
                  row_elems, idx, len(idx),
                  out.reshape(len(idx), -1) if out.ndim > 1 else out,
                  _default_threads())
    return out


def native_row_lengths(mask: np.ndarray, native: bool = True) -> np.ndarray:
    """Token count per row of an attention-mask matrix (bucketing)."""
    mask = np.ascontiguousarray(mask, np.int32)
    if not native:
        return (mask != 0).sum(axis=1).astype(np.int32)
    n, L = mask.shape
    out = np.empty(n, np.int32)
    load_native().dl_row_lengths(mask, n, L, out, _default_threads())
    return out


def _py_line_boundaries(path: str) -> np.ndarray:
    offsets = [0]
    with open(path, "rb") as f:
        for line in f:
            offsets.append(offsets[-1] + len(line))
    return np.asarray(offsets, np.int64)


def native_line_boundaries(path: str, native: bool = True) -> np.ndarray:
    """Line-start boundaries of a text/jsonl file: ``[0, start_1, ...,
    file_size]`` (the streaming tier's offset index), by a parallel
    pread+memchr scan in C++; ``native=False`` gives the Python line loop
    (the same result). Raises ``OSError`` when the scan fails or the file
    changes between its two passes."""
    if not native:
        return _py_line_boundaries(path)
    lib = load_native()
    pb = os.fsencode(path)
    size = os.path.getsize(path)
    # a generous first guess (>= 16 bytes a line) so the common case is
    # ONE scan; a shorter-lined file pays a second, exact pass (the C side
    # fills up to cap and returns the true count)
    cap = int(size // 16) + 1024
    newlines = np.empty(cap, np.int64)
    count = lib.dl_line_index(pb, newlines.ctypes.data_as(ctypes.c_void_p), cap,
                              _default_threads())
    if count < 0:
        raise OSError(f"line index scan of {path!r} failed")
    if count > cap:
        newlines = np.empty(int(count), np.int64)
        got = lib.dl_line_index(pb, newlines.ctypes.data_as(ctypes.c_void_p), count,
                                _default_threads())
        if got != count:
            raise OSError(f"{path!r} changed between the line index's two scans")
    if size == 0:
        return np.zeros(1, np.int64)
    starts = np.concatenate([np.zeros(1, np.int64), newlines[: int(count)] + 1])
    if starts[-1] != size:
        # the last line has no trailing newline: close its boundary
        starts = np.append(starts, np.int64(size))
    return starts
