"""PyTorch port: the WordPiece tokenizer (``data/wordpiece.py``, the
Python twin, and ``data/native.py::CppWordPieceTokenizer``, its C++ core
built from ``csrc/host/wordpiece.cc``) against the JAX package's
``WordPieceTokenizer`` and ``CppWordPieceTokenizer`` on the same texts:
ids, masks, token types, word ids and code-point offsets equal exactly,
over accents, CJK, control and format characters, truncation, pairs,
``encode_words``, ``encode_qa`` with and without doc stride, and rows past
``_CPP_SAFE_BOUNDARY`` (which the C++ tokenizer routes to the Python core).
Texts come from a seeded numpy generator and from a fixed list of hard
cases; the vocab is built inline."""

import shutil

import numpy as np
import pytest

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import native as t_native
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import tokenization as t_tok
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import wordpiece as t_wp

VOCAB_TOKENS = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
    "the", "quick", "brown", "fox", "jump", "##ed", "##s", "over", "lazy",
    "dog", "un", "##aff", "##able", "run", "!", ",", ".", "-", "hello",
    "world", "re", "##sum", "##e", "2023", "#", "is", "a", "b", "##c",
    "ab", "##b", "new", "york", "city", "in", "of", "what", "?", "and",
    "to", "it", "was", "big", "small", "##ly", "##ing", "work", "play",
    "cafe", "naive", "uber", "senor", "日", "本", "語", "中", "文", "text",
]

HARD_TEXTS = [
    "The quick brown fox jumped over the lazy dog!",
    "Hello, WORLD! unaffable résumé abc",
    "runs runs RUNS",
    "#2023 is a, b !!",
    "",
    "   \t\n  ",
    "newly working PLAYING bigly",
    "New York City -- in 2023?",
    "a" * 150 + " ok",                 # past max_input_chars_per_word: UNK
    "naïve café über señor",           # accents stripped
    "日本語 text 中文",                 # CJK split standalone
    "what is this",          # unicode spaces
    "zero​width and bell\x07char",  # control and format chars dropped
    "co­operate soft­hyphen",
    # past the C++ boundary: the C++ tokenizer hands these rows to the
    # Python core, so parity must still hold exactly
    "Łódź złoty ŁÓDŹ",
    "kapalı ılık TOPKAPı",
    "İSTANBUL İzmir diyarbakır",
    "ёлка and ЁЛКА",
    "άλφα ΆΛΦΑ βήτα",
    "што؟ arabic ، question",
]

_PIECES = ["the", "quick", "brown", "fox", "jumped", "over", "lazy", "dog",
           "unaffable", "résumé", "naïve", "CAFÉ", "über", "señor", "日本語",
           "中文", "hello", "world", "runs", "playing", "newly", "2023", "abc",
           "New", "York", "zzz", "qqq", ",", "!", "?", "--", "#", ".", "\t",
           "\x07", "​", "­", " ", "ł", "ı", "ё", "βήτα"]


def random_texts(n: int, seed: int) -> list[str]:
    """``n`` texts of 0-40 pieces joined by spaces or nothing, drawn with
    numpy's seeded generator."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        k = rng.randint(0, 41)
        parts = [_PIECES[i] for i in rng.randint(0, len(_PIECES), size=k)]
        seps = rng.choice([" ", " ", "", "  "], size=k)
        out.append("".join(p + s for p, s in zip(parts, seps)))
    return out


TEXTS = HARD_TEXTS + random_texts(40, seed=7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


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


@pytest.fixture(scope="module")
def vocab():
    return {t: i for i, t in enumerate(VOCAB_TOKENS)}


@pytest.fixture(scope="module")
def toks(vocab):
    """The four tokenizers: the port's Python twin and C++ build, the JAX
    package's Python twin and native tokenizer."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.native import (
        CppWordPieceTokenizer,
        native_available,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.wordpiece import (
        WordPieceTokenizer,
    )

    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the port's C++ tokenizer cannot be built")
    out = {"port_py": t_wp.WordPieceTokenizer(vocab),
           "port_cpp": t_native.CppWordPieceTokenizer(vocab),
           "jax_py": WordPieceTokenizer(vocab)}
    if native_available():
        out["jax_cpp"] = CppWordPieceTokenizer(vocab)
    return out


def _assert_same(got: dict, want: dict, what: str):
    assert sorted(got) == sorted(want), what
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]),
                                      err_msg=f"{what}: {key}")


@pytest.mark.parametrize("max_length", [8, 32, 128])
def test_call_matches_jax(toks, max_length):
    want = toks["jax_py"](TEXTS, max_length=max_length)
    for name, tok in toks.items():
        _assert_same(tok(TEXTS, max_length=max_length), want, f"{name} @ {max_length}")


def test_token_streams_match_jax(toks):
    """ids, word ids, code-point starts and ends, and counts of the core."""
    want = toks["jax_py"]._tokenize_batch(TEXTS, 64)
    for name, tok in toks.items():
        got = tok._tokenize_batch(TEXTS, 64)
        for field, g, w in zip(("ids", "word_ids", "starts", "ends", "counts"), got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"{name}: {field}")


@pytest.mark.parametrize("max_length", [8, 12, 16, 40])
def test_pairs_with_truncation_match_jax(toks, max_length):
    qs, cs = TEXTS[:20], TEXTS[20:40]
    want = toks["jax_py"](qs, text_pairs=cs, max_length=max_length)
    for name, tok in toks.items():
        _assert_same(tok(qs, text_pairs=cs, max_length=max_length), want, name)


def test_no_truncation_and_longest_padding_match_jax(toks):
    want = toks["jax_py"](TEXTS, truncation=False, padding="longest", max_length=16)
    for name, tok in toks.items():
        _assert_same(tok(TEXTS, truncation=False, padding="longest", max_length=16),
                     want, name)
        with pytest.raises(ValueError, match="truncation"):
            tok(TEXTS, truncation=False, padding="max_length", max_length=16)
    short = toks["jax_py"](TEXTS[:4], padding="longest", max_length=64,
                           add_special_tokens=False)
    _assert_same(toks["port_cpp"](TEXTS[:4], padding="longest", max_length=64,
                                  add_special_tokens=False), short, "no specials")


def test_encode_words_matches_jax(toks):
    rng = np.random.RandomState(3)
    words = [[_PIECES[i] for i in rng.randint(0, 30, size=rng.randint(1, 12))]
             for _ in range(16)]
    want = toks["jax_py"].encode_words(words, max_length=16)
    for name, tok in toks.items():
        _assert_same(tok.encode_words(words, max_length=16), want, name)


@pytest.mark.parametrize("doc_stride", [0, 4])
def test_encode_qa_matches_jax(toks, doc_stride):
    """Answer spans from code-point offsets; with ``doc_stride`` the
    context becomes overlapping windows, ``example_ids`` mapping features
    to inputs."""
    contexts = [t for t in TEXTS if len(t.split()) > 6][:12]
    rng = np.random.RandomState(doc_stride + 11)
    questions, starts, answers = [], [], []
    for c in contexts:
        words = c.split()
        ans = words[rng.randint(0, len(words))]
        questions.append(" ".join(words[:3]) + " ?")
        starts.append(c.index(ans))
        answers.append(ans)
    kw = dict(max_length=24, return_offsets=True, doc_stride=doc_stride)
    want = toks["jax_py"].encode_qa(questions, contexts, starts, answers, **kw)
    if doc_stride:
        assert len(want["example_ids"]) > len(contexts)     # windows were made
    assert want["start_positions"].any()
    for name, tok in toks.items():
        _assert_same(tok.encode_qa(questions, contexts, starts, answers, **kw), want, name)
        _assert_same(tok.encode_qa(questions, contexts, max_length=24),
                     toks["jax_py"].encode_qa(questions, contexts, max_length=24),
                     f"{name}, unlabeled")


def test_rows_past_the_boundary_take_the_python_core(toks, monkeypatch):
    """Rows with a code point at or past ``_CPP_SAFE_BOUNDARY`` go to the
    Python core (the same ids by construction); other rows never do."""
    past = [t for t in TEXTS if any(ord(c) >= t_native._CPP_SAFE_BOUNDARY for c in t)]
    assert past and len(past) < len(TEXTS)
    seen = []
    real = t_native.tokenize_batch_py

    def spy(vocab, texts, *a):
        seen.extend(texts)
        return real(vocab, texts, *a)

    monkeypatch.setattr(t_native, "tokenize_batch_py", spy)
    got = toks["port_cpp"](TEXTS, max_length=32)
    assert sorted(seen) == sorted(past)
    _assert_same(got, toks["jax_py"](TEXTS, max_length=32), "routed rows")


def test_decode_and_tokens_match_jax(toks):
    ids = toks["jax_py"](TEXTS[:12], max_length=32)["input_ids"]
    for name, tok in toks.items():
        for row in ids:
            assert tok.convert_ids_to_tokens(row) == \
                toks["jax_py"].convert_ids_to_tokens(row), name
            for skip in (True, False):
                assert tok.decode(row, skip) == toks["jax_py"].decode(row, skip), name


def test_save_and_load_match_jax(toks, tmp_path):
    """The port's export loads back through the JAX ``load_tokenizer`` (a
    WordPiece) to the same ids, and a JAX export through the port's."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.tokenization import (
        load_tokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.wordpiece import (
        WordPieceTokenizer,
    )

    tok = toks["port_cpp"]
    tok.model_max_length = 128
    try:
        tok.save_pretrained(str(tmp_path / "port"))
        toks["jax_py"].save_pretrained(str(tmp_path / "jax"))
    finally:
        tok.model_max_length = 512
    jax_back = load_tokenizer(str(tmp_path / "port"))
    port_back = t_tok.load_tokenizer(str(tmp_path / "jax"))
    assert isinstance(jax_back, WordPieceTokenizer) and jax_back.model_max_length == 128
    assert type(port_back) is t_native.CppWordPieceTokenizer
    want = toks["jax_py"](TEXTS, max_length=32)
    _assert_same(jax_back(TEXTS, max_length=32), want, "jax load of the port's export")
    _assert_same(port_back(TEXTS, max_length=32), want, "port load of the jax export")
    py_back = t_tok.load_tokenizer(str(tmp_path / "jax"), prefer_native=False)
    assert type(py_back) is t_wp.WordPieceTokenizer
    assert (tmp_path / "port" / "vocab.txt").read_text() == \
        (tmp_path / "jax" / "vocab.txt").read_text()


def test_cpp_threads_and_vocab_checks(vocab):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the port's C++ tokenizer cannot be built")
    texts = random_texts(257, seed=2)
    one = t_native.CppWordPieceTokenizer(vocab, n_threads=1)(texts, max_length=32)
    many = t_native.CppWordPieceTokenizer(vocab, n_threads=8)(texts, max_length=32)
    _assert_same(one, many, "1 against 8 threads")
    with pytest.raises(RuntimeError, match="contiguous"):
        t_native.CppWordPieceTokenizer({"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3,
                                        "a": 5})
    with pytest.raises(ValueError, match="special token"):
        t_wp.WordPieceTokenizer({"<pad>": 0, "hello": 1})
