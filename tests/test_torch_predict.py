"""PyTorch port: the predict CLI (``predict.py``) against the JAX
package's ``scripts/predict.py`` on the same exports, through each
package's own parser: every task's rows carry the JAX row's keys;
probabilities agree within 1e-4 and ids exactly (greedy, beam, sampled
when the port draws with JAX's noise for the seed, self-speculative,
``--quantize int8``, ``--kv_cache int8``, ``--prefill_chunk``); the
refusals are the JAX ``SystemExit`` messages word for word."""

import json
import os
import sys

import numpy as np
import pytest

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import predict as t_predict
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import generate as t_gen
from torch_decode_pairs import (  # noqa: F401  (autouse fixtures)
    detached_compile_trackers,
    feed_noise,
    jax_gumbel_stream,
    one_torch_thread,
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))


def _jax_predict():
    import predict as predict_mod

    return predict_mod


def _export(tmp_path, kind: str) -> str:
    """A JAX export (random weights, seed 0) both packages read."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.auto import init_params
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.layers import EncoderConfig

    enc = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
               max_position_embeddings=32)
    if kind in ("bert", "qa", "mlm"):
        from huggingface_sagemaker_tensorflow_distributed_tpu.models.bert import (
            BertForMaskedLM,
            BertForQuestionAnswering,
            BertForSequenceClassification,
        )

        words = ["[PAD]", "[CLS]", "[SEP]", "[UNK]", "[MASK]", "the", "movie", "was",
                 "good", "bad"]
        cfg = (EncoderConfig(vocab_size=256, use_pooler=kind == "bert", **enc)
               if kind != "mlm" else EncoderConfig(vocab_size=len(words), use_pooler=False,
                                                   **enc))
        model = {"bert": lambda: BertForSequenceClassification(cfg, num_labels=2),
                 "qa": lambda: BertForQuestionAnswering(cfg),
                 "mlm": lambda: BertForMaskedLM(cfg)}[kind]()
        family = "bert"
    elif kind == "rtd":
        from huggingface_sagemaker_tensorflow_distributed_tpu.models.electra import (
            ElectraForPreTraining,
        )

        cfg = EncoderConfig(vocab_size=256, use_pooler=False, **enc)
        model, family = ElectraForPreTraining(cfg), "electra"
    elif kind == "gpt2":
        from huggingface_sagemaker_tensorflow_distributed_tpu.models.gpt2 import (
            Gpt2Config,
            Gpt2LMHeadModel,
        )

        cfg = Gpt2Config(vocab_size=256, hidden_size=32, num_layers=2, num_heads=4,
                         intermediate_size=64, max_position_embeddings=64)
        model, family = Gpt2LMHeadModel(cfg), "gpt2"
    else:
        from huggingface_sagemaker_tensorflow_distributed_tpu.models.t5 import (
            T5Config,
            T5ForConditionalGeneration,
        )

        cfg = T5Config(vocab_size=256, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                       num_decoder_layers=2, num_heads=4, dropout_rate=0.0)
        model, family = T5ForConditionalGeneration(cfg), "t5"
    params = init_params(model, cfg)
    out = str(tmp_path / kind)
    j_auto.save_pretrained(out, params, family, cfg)
    if kind == "mlm":
        (tmp_path / kind / "vocab.txt").write_text("\n".join(words))
    return out


def _both(argv, monkeypatch=None, noise=None):
    """(port rows, JAX rows) of the same argv through each parser."""
    tail = ["--max_seq_length", "32", "--max_new_tokens", "4"]
    jm = _jax_predict()
    want = jm.predict(jm.build_parser().parse_args(argv + tail))
    if noise is not None:
        feed_noise(monkeypatch, t_gen, noise)
    got = t_predict.predict(t_predict.build_parser().parse_args(
        argv + tail + ["--device", "cpu"]))
    return got, want


def _same_rows(got, want, prob_keys=()):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            if key in prob_keys:
                np.testing.assert_allclose(np.asarray(g[key]), np.asarray(w[key]),
                                           rtol=0, atol=1e-4)
            else:
                assert g[key] == w[key], key


def test_predict_seq_cls(tmp_path):
    got, want = _both(["--model_dir", _export(tmp_path, "bert"), "--task", "seq-cls",
                       "--text", "a fine film"])
    assert got[0]["label"] in (0, 1) and abs(sum(got[0]["probs"]) - 1.0) < 1e-3
    _same_rows(got, want, prob_keys=("probs",))


def test_predict_qa_and_batch_file(tmp_path):
    f = tmp_path / "in.jsonl"
    f.write_text(json.dumps({"text": "who is it?", "context": "it is ada."}) + "\n"
                 + json.dumps({"text": "what now?"}) + "\n")
    got, want = _both(["--model_dir", _export(tmp_path, "qa"), "--task", "qa",
                       "--input_file", str(f)])
    assert got[0]["answer"] and got[0]["answer"] in "it is ada."
    assert got[1]["answer"] == "" and got[1]["start"] == -1
    _same_rows(got, want)


@pytest.mark.parametrize("extra", [
    [], ["--num_beams", "3", "--length_penalty", "0.6"], ["--self_speculate_layers", "1"],
    ["--quantize", "int8"], ["--kv_cache", "int8"], ["--prefill_chunk", "2"]],
    ids=["greedy", "beam", "self-speculative", "quantize-int8", "kv-int8", "prefill-chunk"])
def test_predict_causal_lm(tmp_path, extra):
    got, want = _both(["--model_dir", _export(tmp_path, "gpt2"), "--task", "causal-lm",
                       "--text", "hello world"] + extra)
    assert len(got[0]["generated_ids"]) == 4 and isinstance(got[0]["generated"], str)
    _same_rows(got, want)


def test_predict_causal_lm_sampled_on_shared_noise(tmp_path, monkeypatch):
    got, want = _both(["--model_dir", _export(tmp_path, "gpt2"), "--task", "causal-lm",
                       "--text", "hello world", "--temperature", "0.8", "--top_p", "0.9",
                       "--seed", "3"], monkeypatch, jax_gumbel_stream(3, (1, 256), 4))
    _same_rows(got, want)


@pytest.mark.parametrize("extra", [[], ["--num_beams", "2"], ["--quantize", "int8"]],
                         ids=["greedy", "beam", "quantize-int8"])
def test_predict_seq2seq(tmp_path, extra):
    got, want = _both(["--model_dir", _export(tmp_path, "t5"), "--task", "seq2seq",
                       "--text", "summarize: a b c"] + extra)
    _same_rows(got, want)


def test_predict_mlm_fills(tmp_path):
    got, want = _both(["--model_dir", _export(tmp_path, "mlm"), "--task", "mlm",
                       "--text", "the movie was [MASK]", "--top_k", "3"])
    assert got[0]["fills"] and len(got[0]["fills"][0]["top_tokens"]) == 3
    _same_rows(got, want)


def test_predict_rtd(tmp_path):
    got, want = _both(["--model_dir", _export(tmp_path, "rtd"), "--task", "rtd",
                       "--text", "a plain sentence"])
    assert len(got[0]["tokens"]) == len(got[0]["replaced_prob"])
    _same_rows(got, want, prob_keys=("replaced_prob",))


def test_predict_with_lora_adapter(tmp_path):
    """``--adapter`` merges a sidecar the JAX package wrote: the rows equal
    the merged export's and the JAX script's, and differ from the base's."""
    import jax
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.lora import (
        init_lora_params,
        lora_scaling,
        merge_lora,
        save_adapters,
    )

    base = _export(tmp_path, "bert")
    _, params, _, cfg = j_auto.from_pretrained(base, task="seq-cls")
    lora = init_lora_params(params, rank=4, targets="attention", seed=3)
    lora = jax.tree.map(lambda x: jnp.asarray(
        np.random.RandomState(0).normal(0, 0.1, x.shape), x.dtype), lora)
    adapter = str(tmp_path / "adapter")
    save_adapters(adapter, lora, rank=4, alpha=16.0, targets="attention")
    merged = str(tmp_path / "merged")
    j_auto.save_pretrained(merged, merge_lora(params, lora, lora_scaling(4, 16.0)), "bert", cfg)
    text = ["--task", "seq-cls", "--text", "a fine day"]
    got, want = _both(["--model_dir", base, "--adapter", adapter] + text)
    _same_rows(got, want, prob_keys=("probs",))
    via_merged, _ = _both(["--model_dir", merged] + text)
    np.testing.assert_allclose(got[0]["probs"], via_merged[0]["probs"], atol=1e-6)
    plain, _ = _both(["--model_dir", base] + text)
    assert not np.allclose(got[0]["probs"], plain[0]["probs"])


@pytest.mark.parametrize("task,extra", [
    ("seq-cls", ["--kv_cache", "int8"]), ("seq-cls", ["--quantize", "int8"]),
    ("seq2seq", ["--self_speculate_layers", "1"]), ("seq2seq", ["--prefill_chunk", "4"]),
    ("causal-lm", ["--prefill_chunk", "4", "--self_speculate_layers", "1"]),
    ("causal-lm", ["--prefill_chunk", "4", "--num_beams", "2"]),
    ("causal-lm", ["--self_speculate_layers", "1", "--top_k", "3"]),
    ("causal-lm", ["--self_speculate_layers", "1", "--num_beams", "2"]),
    ("causal-lm", ["--self_speculate_layers", "-1", "--draft_dir", "x"]),
    ("causal-lm", ["--num_beams", "2", "--temperature", "0.5"]),
    ("seq2seq", ["--draft_dir", "x", "--num_beams", "2"])])
def test_predict_refusals_are_the_jax_scripts(tmp_path, task, extra):
    kind = {"seq-cls": "bert", "seq2seq": "t5", "causal-lm": "gpt2"}[task]
    argv = ["--model_dir", _export(tmp_path, kind), "--task", task, "--text", "a b"] + extra
    jm = _jax_predict()
    with pytest.raises(SystemExit) as want:
        jm.predict(jm.build_parser().parse_args(argv))
    with pytest.raises(SystemExit) as got:
        t_predict.predict(t_predict.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert str(got.value) == str(want.value) and str(got.value)


def test_predict_cli_main_prints_one_row_per_input(tmp_path, capsys):
    f = tmp_path / "in.jsonl"
    f.write_text("".join(json.dumps({"text": t}) + "\n" for t in ("a b", "c d e")))
    t_predict.main(["--model_dir", _export(tmp_path, "gpt2"), "--task", "causal-lm",
                    "--input_file", str(f), "--max_new_tokens", "3", "--device", "cpu"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["text"] for r in rows] == ["a b", "c d e"]
    assert all(len(r["generated_ids"]) == 3 for r in rows)
