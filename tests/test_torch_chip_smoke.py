"""``chip_smoke.py``'s paged-kernel, flash-kernel, vocab-CE-kernel and
training phases rehearsed on the CPU at a tiny size: with ``DEVICE = "cpu"`` every wrapper
takes its plain version, so this checks the phases' own logic (cases,
comparisons, bounds, launch accounting, results files, reload), not the
kernels. The phases run for real only on the card."""

import json
import math
import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import flash_attention as fa
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import paged_attention as pa
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import vocab_ce as vc
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread per test worker runs
    them faster than a pool contending with the other workers."""
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
    fresh one would be (a later telemetry test installs its own). (The
    card's machine runs the ``gpu`` tests without JAX: nothing to remove.)"""
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
def on_cpu(monkeypatch):
    """chip_smoke pointed at the CPU, timing stubbed, tiny widths, and the
    flash and vocab-CE wrappers counted on every call (on the CPU they
    launch nothing)."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "_cuda_ms", lambda fn, sets, iters=40: (fn(*sets[0]), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "_device_ms",
                        lambda fn, sets, match=None, **kw: (fn(*sets[0]), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "_host_ms", lambda fn, sets, **kw: (fn(*sets[0]), 0.0)[1])
    monkeypatch.setattr(fa, "load_kernel", lambda: None)
    monkeypatch.setattr(vc, "load_kernel", lambda: None)
    monkeypatch.setattr(pa, "load_kernel", lambda: None)
    monkeypatch.setattr(chip_smoke, "BERT_BASE", dict(
        chip_smoke.BERT_BASE, hidden_size=64, num_hidden_layers=2, num_attention_heads=1,
        intermediate_size=128))
    monkeypatch.setattr(chip_smoke, "GPT2_124M", dict(
        chip_smoke.GPT2_124M, vocab_size=300, n_positions=64, n_embd=64, n_layer=2,
        n_head=1))
    monkeypatch.setattr(chip_smoke, "GPT2_SEQ", 32)
    tiny = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=1,
                intermediate_size=128)
    monkeypatch.setattr(chip_smoke, "BERT_LARGE", dict(chip_smoke.BERT_LARGE, **tiny))
    # the phases' depth cuts of BERT-large and BERT-base, at the tiny model's depth
    for depth in ("LAUNCH_DEPTH", "OPTIM_DEPTH", "ENCODER_LARGE_DEPTH", "MLM_LARGE_DEPTH",
                  "LIFECYCLE_DEPTH", "BUDGET_DEPTH", "BREADTH_DEPTH"):
        monkeypatch.setattr(chip_smoke, depth, tiny["num_hidden_layers"])
    monkeypatch.setattr(chip_smoke, "ROBERTA_BASE", dict(chip_smoke.ROBERTA_BASE, **tiny,
                                                         vocab_size=300))
    monkeypatch.setattr(chip_smoke, "ELECTRA_SMALL", dict(chip_smoke.ELECTRA_SMALL, **tiny,
                                                          embedding_size=32))
    monkeypatch.setattr(chip_smoke, "ALBERT_BASE", dict(chip_smoke.ALBERT_BASE, **tiny,
                                                        embedding_size=32, vocab_size=300))
    monkeypatch.setattr(chip_smoke, "DISTILBERT_BASE", dict(
        chip_smoke.DISTILBERT_BASE, dim=64, n_layers=2, n_heads=1, hidden_dim=128))
    monkeypatch.setattr(chip_smoke, "T5_SMALL", dict(
        chip_smoke.T5_SMALL, vocab_size=600, d_model=64, d_kv=16, d_ff=128, num_layers=2,
        num_decoder_layers=2, num_heads=4))
    monkeypatch.setattr(chip_smoke, "DEBERTA_V3_BASE", dict(
        chip_smoke.DEBERTA_V3_BASE, **tiny, vocab_size=600, position_buckets=32))
    monkeypatch.setattr(chip_smoke, "BART_BASE", dict(
        chip_smoke.BART_BASE, vocab_size=600, d_model=64, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=128,
        decoder_ffn_dim=128))
    for mod, names in ((fa, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
                       (vc, ("fused_ce_fwd",))):
        for name in names:
            real = getattr(mod, name)

            def counted(*a, _real=real, _mod=mod, _name=name, **kw):
                getattr(_mod, _name).launches += 1
                return _real(*a, **kw)

            counted.launches = 0
            monkeypatch.setattr(mod, name, counted)
    # the backward: one call counts dH and dW as it is asked for them, as on
    # the card (``fused_ce_bwd_dh`` and ``fused_ce_bwd_dw`` go through it)
    real_bwd = vc.fused_ce_bwd
    for name in ("fused_ce_bwd_dh", "fused_ce_bwd_dw"):
        monkeypatch.setattr(getattr(vc, name), "launches", 0)

    def counted_bwd(*a, need_dh=True, need_dw=True, **kw):
        vc.fused_ce_bwd_dh.launches += int(need_dh)
        vc.fused_ce_bwd_dw.launches += int(need_dw)
        return real_bwd(*a, need_dh=need_dh, need_dw=need_dw, **kw)

    monkeypatch.setattr(vc, "fused_ce_bwd", counted_bwd)


def test_kernel_phase_on_cpu(on_cpu, monkeypatch, capsys):
    """The paged phase's cases (ragged, one slot at full context, contexts
    on the chunk edges under a window and one past the width),
    comparisons, chunk plan, block counts, device/event/host/library
    times and bounds, at a tiny size; a card of 4 SMs so that one slot of
    2 kv heads must fill it."""
    monkeypatch.setattr(pa, "H100_SMS", 4)
    monkeypatch.setattr(chip_smoke, "KERNEL_CASES", [
        ("gpt2", 4, 2, 2, 64, 16, 64, "float32", False, None, "ragged"),
        ("int8_bf16", 3, 4, 2, 128, 8, 48, "bfloat16", True, 24, "ragged"),
        ("single", 1, 2, 2, 64, 16, 256, "float32", False, None, "full"),
        ("chunk_edges", 8, 2, 2, 64, 16, 160, "float32", False, 80, "chunk_edges")])
    rows = chip_smoke.kernel_phase()
    assert list(rows) == ["gpt2", "int8_bf16", "single", "chunk_edges"]
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["case"] for r in out] == list(rows)
    for row in out:
        assert row["phase"] == "kernel" and row["status"] == "pass"
        assert row["bound_ms"] > 0 and row["bound_by"] == "bytes"
        for key in ("kernel_ms", "kernel_event_ms", "kernel_host_ms", "plain_ms",
                    "library_ms", "library_event_ms"):
            assert row[key] == 0.0                      # the stubbed timers
        assert row["chunk"] % pa.TILE == 0 and row["chunk"] % row["block_size"] == 0
        assert row["blocks_with_keys"] <= row["grid_blocks"]
    assert rows["single"]["contexts"] == [256] and rows["single"]["blocks_with_keys"] == 2 * 4
    # window 80 over 8 slots of 2 kv heads: 2 chunks of 64 positions; the
    # last slot's band [160, 240) lies past the width of 160: no block
    edges = rows["chunk_edges"]
    assert edges["chunk"] == pa.MIN_CHUNK == 64 and edges["grid_blocks"] == 2 * 8 * 2
    assert edges["contexts"] == [0, 1, 63, 64, 65, 128, 160, 240]
    assert edges["blocks_with_keys"] == 2 * (1 + 1 + 1 + 2 + 2 + 2)
    # the bound: q and out once, each valid key's K and V row (and scales),
    # the walked table entries and the context lengths
    case = chip_smoke.KERNEL_CASES[2]
    assert chip_smoke._work(case, [256]) == (2 * 2 * 64 * 4 + 256 * 2 * 2 * 64 * 4 + 16 * 4 + 4,
                                             256 * 2 * 64 * 4)


def test_paged_kernel_names_are_the_sources():
    """The names the kernel and profile phases sum device time by are the
    ``__global__`` functions ``csrc/paged_attention.cu`` defines, the
    split kernel first; none is a substring of another or of the earlier
    design's ``paged_decode_kernel``; the build report reads every
    instance's template arguments from its mangled name."""
    src = (Path(pa.__file__).parents[1] / "csrc" / "paged_attention.cu").read_text()
    defined = re.findall(r"__global__ void __launch_bounds__\(\w+\) (\w+)\(", src)
    assert tuple(defined) == chip_smoke.PAGED_KERNEL_NAMES
    names = chip_smoke.PAGED_KERNEL_NAMES + ("paged_decode_kernel",)
    assert not any(a in b for a in names for b in names if a != b)
    ns = "_ZN12_GLOBAL__N_1"
    assert chip_smoke._paged_instance(
        f"{ns}25paged_decode_split_kernelIffLi64ELi1EEEvNS_4ArgsE") == (
        "paged_decode_split_kernel", 64, "float32", "float32", 1)
    assert chip_smoke._paged_instance(
        f"{ns}25paged_decode_split_kernelI13__nv_bfloat16S1_Li128ELi4EEEvNS_4ArgsE") == (
        "paged_decode_split_kernel", 128, "bfloat16", "bfloat16", 4)
    assert chip_smoke._paged_instance(
        f"{ns}25paged_decode_split_kernelI13__nv_bfloat16aLi128ELi8EEEvNS_4ArgsE") == (
        "paged_decode_split_kernel", 128, "bfloat16", "int8", 8)
    assert chip_smoke._paged_instance(
        f"{ns}27paged_decode_combine_kernelIfLi64EEEvNS_4ArgsE") == (
        "paged_decode_combine_kernel", 64, "float32", None, None)
    assert {c[0] for c in chip_smoke.KERNEL_CASES} >= {"gpt2", "gqa", "int8_bf16", "single",
                                                      "chunk_edges"}


def test_flash_phase_on_cpu(on_cpu, monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "FLASH_CASES", [
        ("bert_fp32", 2, 2, 64, 64, "float32", True, False, None, False, False),
        ("bert_bf16", 2, 2, 64, 64, "bfloat16", True, False, None, False, False),
        ("ragged", 2, 2, 40, 64, "float32", True, False, None, True, True),
        ("ragged_bf16", 2, 2, 40, 64, "bfloat16", True, False, None, True, True),
        ("causal_window", 1, 2, 64, 64, "float32", False, True, 16, False, False),
        ("causal_window_bf16", 1, 2, 64, 64, "bfloat16", False, True, 16, False, False)])
    rows = chip_smoke.flash_phase()
    assert len(rows) == 18 and all(r["status"] == "pass" for r in rows.values())
    assert rows[("bert_bf16", "flash_fwd")]["kernel_name"] == "flash_fwd_tc_kernel"
    assert rows[("bert_bf16", "flash_bwd_dq")]["kernel_name"] == "flash_bwd_dq_tc_kernel"
    assert rows[("bert_fp32", "flash_bwd_dq")]["kernel_name"] == "flash_bwd_dq_kernel"
    assert rows[("bert_fp32", "flash_bwd_dkv")]["kernel_name"] == "flash_bwd_dkv_kernel"
    for line in capsys.readouterr().out.splitlines():
        row = json.loads(line)
        assert row["phase"] == "flash_kernel" and row["bound_ms"] > 0
        assert row["bound_by"] in ("bytes", "operations")
    # the bound counts the (query, key) pairs the data needs
    case = ("c", 1, 2, 64, 64, "float32", False, True, 16, False, False)
    pairs = 2 * sum(min(i + 1, 16) for i in range(64))
    assert chip_smoke._flash_work(case, None)["flash_fwd"][1] == 4 * 64 * pairs
    masked = ("m", 2, 1, 8, 64, "bfloat16", True, False, None, False, True)
    nbytes, flops = chip_smoke._flash_work(masked, torch.tensor([0, 3]))["flash_bwd_dkv"]
    assert flops == 8 * 64 * (8 * (8 + 3))
    assert nbytes == 7 * 2 * 8 * 64 * 2 + 2 * 8 * 4 + 2 * 8 * 4 + 2 * 8 * 4


def _small_vocab(monkeypatch, vocab=600, positions=None):
    """The rehearsal's encoder configs at a small vocab (the unfused MLM
    logits are [B, S, V]), and optionally fewer positions."""
    for name in ("BERT_BASE", "BERT_LARGE", "ROBERTA_BASE", "ELECTRA_SMALL",
                 "ALBERT_BASE", "DISTILBERT_BASE", "DEBERTA_V3_BASE"):
        cfg = dict(getattr(chip_smoke, name), vocab_size=vocab)
        if positions:
            cfg["max_position_embeddings"] = positions + (2 if name == "ROBERTA_BASE" else 0)
        monkeypatch.setattr(chip_smoke, name, cfg)


def test_train_phases_on_cpu(on_cpu, monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "CLI_STEPS", 2)
    monkeypatch.setattr(chip_smoke, "CLI_EVAL_SAMPLES", 4)
    _small_vocab(monkeypatch)
    rows = chip_smoke.train_parity_phase()
    for row in rows.values():
        assert row["loss_rel_err"] <= row["loss_rtol"] and row["params"] > 0
    assert rows["bfloat16"]["grad_dist_ratio_max"] <= rows["bfloat16"]["grad_dist_ratio_tol"]
    # the other families, one fp32 and one bf16 step each at depth 2; then
    # an MLM step of each family (flash and the fused MLM loss against the
    # plain path), ELECTRA's RTD step, and a T5 and a BART seq2seq step
    # (the fused seq2seq loss against the unfused logits)
    families = ("roberta", "distilbert", "electra", "albert")
    assert sorted(rows) == sorted(["float32", "bfloat16"] + [
        f"{f}/{dt}" for f in families for dt in ("float32", "bfloat16")] + [
        f"{f}-mlm/{dt}" for f in ("bert",) + families for dt in ("float32", "bfloat16")] + [
        f"electra-rtd/{dt}" for dt in ("float32", "bfloat16")] + [
        f"{f}-seq2seq/{dt}" for f in ("t5", "bart") for dt in ("float32", "bfloat16")] + [
        f"{n}/{dt}" for n in ("bert-lora", "gpt2-segment-packing", "deberta-mlm")
        for dt in ("float32", "bfloat16")])
    # LoRA: the adapters' and the heads' gradients only (the base frozen);
    # DeBERTa holds no key bias apart (its p2c term gives it a gradient)
    assert rows["bert-lora/float32"]["params"] == 2 * 4 * 2 + 4
    assert rows["deberta-mlm/float32"]["key_bias_grad_norm_over_global"] == 0.0
    assert all(rows[f"{n}/bfloat16"]["grad_dist_step_ratio"] <= 2.0
               for n in ("bert-lora", "gpt2-segment-packing", "deberta-mlm"))
    # T5 has no key bias; BART's self- and cross-attention key biases are
    # held apart in both stacks
    assert rows["t5-seq2seq/float32"]["key_bias_grad_norm_over_global"] == 0.0
    assert rows["bart-seq2seq/float32"]["params"] == rows["bart-seq2seq/bfloat16"]["params"]
    assert all(rows[f"{f}-seq2seq/bfloat16"]["grad_dist_step_ratio"] <= 2.0
               for f in ("t5", "bart"))
    assert all(rows[f"{f}/float32"]["layers"] == 2 for f in ("roberta", "albert"))
    assert all(rows[f"{f}-mlm/bfloat16"]["grad_dist_step_ratio"] <= 2.0
               for f in ("bert",) + families)
    # the RTD head's one-number bias is held to the whole step's gate
    assert list(rows["electra-rtd/bfloat16"]["one_dof_held_apart"]) == \
        ["disc_prediction.bias"]
    assert rows["bert-mlm/bfloat16"]["one_dof_held_apart"] == {}
    # on the CPU `auto` picks the plain path; the CLI is asked for flash
    run = cli.run
    monkeypatch.setattr(cli, "run", lambda argv: run(argv + ["--attention_impl", "flash"]))
    row = chip_smoke.train_cli_phase(tmp_path)
    assert row["launches"] == {"flash_fwd": 2 * (2 + 1), "flash_bwd_dq": 2 * 2,
                               "flash_bwd_dkv": 2 * 2}
    assert row["idle_share"] == "not measured" and row["train_steps"] == 2


def test_encoder_tasks_phase_on_cpu(on_cpu, monkeypatch, tmp_path, capsys):
    """The encoder runs (BERT-large-shaped QA at 384 and windowed at 64,
    RoBERTa token-cls, DistilBERT, ELECTRA and ALBERT seq-cls) at tiny
    widths and 3 steps: the launch accounting (QA-eval forwards and
    ALBERT's uses of its one layer included), the results keys, the
    reloaded exports, the windows, the idle-share pass, and the rows."""
    run = cli.run
    monkeypatch.setattr(cli, "run", lambda argv: run(argv + ["--attention_impl", "flash"]))
    monkeypatch.setattr(chip_smoke, "ENCODER_EVAL_SAMPLES", 8)
    monkeypatch.setattr(chip_smoke, "QA_EVAL_SAMPLES", 6)
    monkeypatch.setattr(chip_smoke, "ENCODER_PROFILED_STEPS", 2)
    runs = chip_smoke._encoder_runs
    monkeypatch.setattr(chip_smoke, "_encoder_runs",
                        lambda: [r[:4] + (3,) + r[5:] for r in runs()])
    rows = chip_smoke.encoder_tasks_phase(tmp_path, "cpu rehearsal")
    assert list(rows) == ["qa_bert_large", "qa_windowed", "token_cls_roberta",
                          "seq_cls_distilbert", "seq_cls_electra", "seq_cls_albert"]
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert [p["run"] for p in printed if p.get("phase") == "encoder_tasks"] == list(rows)
    qa, win = rows["qa_bert_large"], rows["qa_windowed"]
    assert qa["seq"] == 384 and qa["eval_steps"] == 2 and qa["qa_eval_examples"] == 6
    assert qa["launches"]["flash_fwd"] == 2 * (3 + 2 + math.ceil(qa["qa_eval_windows"] / 4))
    assert set(qa["eval"]) == {"eval_loss", "eval_accuracy", "eval_exact_match", "eval_f1"}
    assert qa["idle_share"] == "not measured" and qa["profiled_steps"] == 2
    assert win["seq"] == 64 and win["qa_eval_windows"] > 6 and win["eval_rows"] > 8
    assert set(rows["token_cls_roberta"]["eval"]) == {"eval_loss", "eval_accuracy", "eval_f1"}
    assert rows["seq_cls_albert"]["layers"] == 2 and rows["seq_cls_albert"]["embedding_size"] == 32
    for row in rows.values():
        assert row["train_steps"] == 3 and row["card"] == "cpu rehearsal"
        assert row["launches"]["flash_bwd_dq"] == row["launches"]["flash_bwd_dkv"] == 2 * 3
        assert row["train_mfu"] == "not measured"


def test_train_lifecycle_phase_on_cpu(on_cpu, monkeypatch, tmp_path, capsys):
    """The three CLI runs (uninterrupted, stopped after epoch 0 step 7,
    resumed from step 5) and the telemetry off/on reruns, the bitwise resume
    equality, the launch counts, the export against the best epoch (epoch
    0, epoch 1 scripted worse), the telemetry's validity, and the keys of
    the printed line."""
    run = cli.run
    monkeypatch.setattr(cli, "run", lambda argv: run(argv + ["--attention_impl", "flash"]))
    monkeypatch.setattr(chip_smoke, "BERT_BASE", dict(chip_smoke.BERT_BASE,
                                                      max_position_embeddings=64))
    monkeypatch.setattr(chip_smoke, "CLI_STEPS", 6)
    monkeypatch.setattr(chip_smoke, "CLI_EVAL_SAMPLES", 4)
    train = tmp_path / "train"      # the train phase's fit, exported for the rerun drift
    cli.run(chip_smoke._train_argv(train, train / "output", train / "model"))
    row = chip_smoke.train_lifecycle_phase(tmp_path / "lifecycle", "cpu rehearsal",
                                           tmp_path / "train" / "model")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(row))
    assert row["train_steps"] == {"full": 24, "cut": 8, "resumed": 19}
    assert row["launches"]["cut"] == {"flash_fwd": 2 * 8, "flash_bwd_dq": 2 * 8,
                                      "flash_bwd_dkv": 2 * 8}
    assert row["launches"]["resumed"]["flash_fwd"] == 2 * (19 + 3 * 8)
    assert row["resume_bitwise"] and row["resume_max_abs_diff"] == 0.0
    assert row["resume_weight_drift"] == {} and row["rerun_weight_drift"] == {}
    assert len(row["save_stall_ms_async"]) == 6 and len(row["save_stall_ms_sync"]) == 5
    assert len(row["write_ms_async"]) == 6 and len(row["restore_ms"]) == 1
    assert row["checkpoint_bytes"] > 0 and row["train_mfu"] == "not measured"
    assert row["train_achieved_tflops_per_chip"] > 0
    for split in (row["split_async_saves"], row["split_sync_saves"]):
        assert set(split["span_s"]) == set(split["span_share"]) == set(
            chip_smoke.LIFECYCLE_SPANS)
        assert abs(sum(split["span_share"].values()) - 1) < 1e-9
        assert split["first_step_dispatch_s"] > 0 and split["step_time_ms"]
        unprofiled = split["without_profiled_windows"]
        assert 0 < unprofiled["steps"] < row["train_steps"]["full"] - 4
        assert unprofiled["samples_per_s"] > 0 and unprofiled["mfu"] == "not measured"
    # epoch 1 scripted worse: keep-best loads epoch 0 back, early stopping
    # stops after epoch 1
    assert row["best_epoch"] == 0 and row["keep_best_restore_exercised"]
    assert row["eval_loss_scripted"] == {"epoch": 1, "added": 1.0}
    assert len(row["eval_loss"]) == 2 and row["eval_loss"][1] > row["eval_loss"][0]
    cost = row["telemetry_cost"]
    assert cost["telemetry"] == [False, True] and cost["on_over_off"] > 0
    assert all(x > 0 for x in cost["train_samples_per_second_per_chip"])
    assert {"card", "profile_names_kernels", "events", "wall_s"} <= set(row)
    assert set(row["events"]) == {"full", "cut", "resumed", "rerun1"}


def test_vocab_ce_phase_on_cpu(on_cpu, monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "VOCAB_CASES", [
        ("gpt2_bf16", 64, 300, 32, "bfloat16", 0.0, False),
        ("ragged", 50, 101, 24, "float32", 0.0, False),
        ("smooth0.1", 32, 200, 16, "float32", 0.1, False),
        ("ties", 32, 130, 16, "float32", 0.0, True),
        # the MLM cases' routes: the forward and the backward on the wgmma
        # routes at every H
        ("mlm_base_bf16", 16, 300, 776, "bfloat16", 0.0, False),
        ("mlm_large_bf16", 16, 300, 808, "bfloat16", 0.0, False),
        ("mlm_eval_bf16", 8, 300, 776, "bfloat16", 0.0, False)])
    rows = chip_smoke.vocab_ce_phase()
    assert len(rows) == 28 and all(r["status"] == "pass" for r in rows.values())
    for kname, kernel, fp32 in (
            ("fused_ce_fwd", "vocab_ce_fwd_wgmma_kernel", "vocab_ce_fwd_kernel"),
            ("fused_ce_bwd_dh", "vocab_ce_dh_wgmma_kernel", "vocab_ce_bwd_dh_kernel"),
            ("fused_ce_bwd_dw", "vocab_ce_dw_wgmma_kernel", "vocab_ce_bwd_dw_kernel"),
            ("fused_ce_bwd", "vocab_ce_ds_wgmma_kernel", "vocab_ce_bwd_dh_kernel")):
        for case in ("gpt2_bf16", "mlm_base_bf16", "mlm_large_bf16", "mlm_eval_bf16"):
            assert rows[(case, kname)]["kernel_name"] == kernel
            assert rows[(case, kname)]["route"] == "wgmma"
        assert rows[("ragged", kname)]["kernel_name"] == fp32
        assert rows[("ragged", kname)]["route"] == "CUDA cores"
    joint = rows[("gpt2_bf16", "fused_ce_bwd")]
    assert joint["kernels"] == list(chip_smoke.VOCAB_KERNEL_NAMES[("fused_ce_bwd", "bfloat16")])
    assert joint["chunks"] == 1 and joint["scratch_ms"] > 0 and "chunks" not in rows[
        ("ragged", "fused_ce_bwd")]
    # the bf16 forward's chunks and its own traffic: the split of W (16
    # bytes a W element) and the per-tile statistics (20 bytes a 128-id
    # tile and token, written and read back)
    fwd = rows[("gpt2_bf16", "fused_ce_fwd")]
    assert fwd["kernels"] == ["vocab_ce_fwd_wgmma_kernel", "vocab_ce_fwd_split_w_kernel",
                              "vocab_ce_combine_kernel"]
    assert (fwd["vocab_chunk"], fwd["chunks"]) == (384, 1)
    assert fwd["scratch_bytes"] == vc.fwd_plan(64, 300, 32)[1]
    assert fwd["scratch_ms"] == pytest.approx(
        (16 * 300 * 32 + 2 * 20 * 3 * 64) / chip_smoke.HBM_BYTES_PER_S * 1e3)
    assert "chunks" not in rows[("ragged", "fused_ce_fwd")]
    for line in capsys.readouterr().out.splitlines():
        row = json.loads(line)
        assert row["phase"] == "vocab_kernel" and row["bound_ms"] > 0
        assert row["bound_by"] in ("bytes", "operations")
        assert row["bound_fp32_ms"] >= row["bound_ms"]
    # the bound: every input read and every output written once; with bf16
    # hidden the split route's bf16 tensor-core passes of 2·N·V·H (3 for
    # the logits, 6 for dH, 4 for dW, 7 for both from one dS) at 989
    # TFLOP/s, with fp32 hidden one pass (two for dH or dW, three for both)
    # at 67 TFLOP/s
    logits = 2 * 4096 * 50257 * 768
    work = chip_smoke._ce_work(("c", 4096, 50257, 768, "bfloat16", 0.0, False))
    assert {k: w[1] for k, w in work.items()} == {
        "fused_ce_fwd": 3 * logits, "fused_ce_bwd_dh": 6 * logits, "fused_ce_bwd_dw": 4 * logits,
        "fused_ce_bwd": 7 * logits}
    assert {w[2] for w in work.values()} == {989e12}
    assert [round(w[1] / w[2] * 1e3, 3) for w in work.values()] == [0.959, 1.918, 1.279, 2.238]
    assert work["fused_ce_bwd_dh"][0] == (4096 * 768 * 2 * 2 + 50257 * 768 * 4 + 3 * 4096 * 4)
    assert work["fused_ce_bwd"][0] == work["fused_ce_bwd_dh"][0] + 50257 * 768 * 4
    work = chip_smoke._ce_work(("c", 4096, 50257, 768, "float32", 0.0, False))
    assert {k: w[1:] for k, w in work.items()} == {
        "fused_ce_fwd": (logits, 67e12), "fused_ce_bwd_dh": (2 * logits, 67e12),
        "fused_ce_bwd_dw": (2 * logits, 67e12), "fused_ce_bwd": (3 * logits, 67e12)}
    # the bf16 routes' launches a call: the backward's split, dS and the
    # products once a vocab chunk, hᵀ and the dH cast once; the forward's
    # split and statistics once a chunk of its own walk, the combine once
    llama3 = ("c", 1024, 128256, 4096, "bfloat16", 0.0, False)
    chunks = -(-128256 // vc.bwd_plan(1024, 128256, 4096)[0])
    assert chunks == 26
    assert chip_smoke.vocab_launch_counts("fused_ce_bwd", llama3) == {
        "vocab_ce_ds_wgmma_kernel": chunks, "vocab_ce_dh_wgmma_kernel": chunks,
        "vocab_ce_dw_wgmma_kernel": chunks, "vocab_ce_split_w_kernel": chunks,
        "vocab_ce_transpose_h_kernel": 1, "vocab_ce_dh_reduce_kernel": 1}
    fwd_chunks = -(-128256 // vc.fwd_plan(1024, 128256, 4096)[0])
    assert fwd_chunks == 13
    assert chip_smoke.vocab_launch_counts("fused_ce_fwd", llama3) == {
        "vocab_ce_fwd_wgmma_kernel": fwd_chunks, "vocab_ce_fwd_split_w_kernel": fwd_chunks,
        "vocab_ce_combine_kernel": 1}
    assert set(chip_smoke.vocab_launch_counts(
        "fused_ce_fwd", ("c", 1024, 128256, 4096, "float32", 0.0, False)).values()) == {1}
    # limits: a bf16 output against max|want| alone, fp32 against max(1, max|want|)
    bf16, fp32 = torch.zeros(1, dtype=torch.bfloat16), torch.zeros(1)
    assert chip_smoke._limit(bf16, 0.09) == 0.09 / 64
    assert chip_smoke._limit(fp32, 0.09) == 1e-4
    assert chip_smoke._limit(fp32, 4.5) == pytest.approx(4.5e-4)


def test_gpt2_train_phases_on_cpu(on_cpu, monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "GPT2_CLI_STEPS", 2)
    monkeypatch.setattr(chip_smoke, "GPT2_EVAL_SAMPLES", 4)
    rows = chip_smoke.gpt2_parity_phase()
    for row in rows.values():
        assert row["loss_rel_err"] <= row["loss_rtol"] and row["params"] > 0
    assert rows["bfloat16"]["grad_dist_ratio_max"] <= rows["bfloat16"]["grad_dist_ratio_tol"]
    # on the CPU `auto` picks the plain path; the CLI is asked for flash
    run = cli.run
    monkeypatch.setattr(cli, "run", lambda argv: run(argv + ["--attention_impl", "flash"]))
    row = chip_smoke.gpt2_cli_phase(tmp_path)
    assert row["launches"] == {"fused_ce_fwd": 2 + 1, "fused_ce_bwd_dh": 2,
                               "fused_ce_bwd_dw": 2, "flash_fwd": 2 * 1,
                               "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert row["idle_share"] == "not measured" and row["train_steps"] == 2



def test_data_phase_on_cpu(on_cpu, monkeypatch, tmp_path, capsys):
    """The data phase at a tiny width: the host build, the whole corpus
    through both WordPiece cores, runs A (bucketed, autotuned prefetch), A'
    (autotune off, the same losses) and C (streaming against materialized,
    the same losses), the launch accounting and the printed line."""
    monkeypatch.setattr(chip_smoke, "DATA_STEPS", 3)
    monkeypatch.setattr(chip_smoke, "DATA_SHORT_STEPS", 2)
    monkeypatch.setattr(chip_smoke, "DATA_EVAL_SAMPLES", 4)
    monkeypatch.setattr(chip_smoke, "DATA_PROFILED_STEPS", 2)
    run = cli.run
    monkeypatch.setattr(cli, "run", lambda argv: run(argv + ["--attention_impl", "flash"]))
    row = chip_smoke.data_phase(tmp_path, "cpu rehearsal")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(row))
    assert row["corpus_rows"] == 5000 and row["cpp_equals_python"]
    assert row["host_build_s"] > 0 and row["host_library"].startswith("libhstd_host-")
    assert row["vocab_tokens"] < chip_smoke.BERT_BASE["vocab_size"]
    assert 15 <= row["real_tokens_per_row"]["min"] < row["real_tokens_per_row"]["max"] <= 512
    a = row["run_a"]
    assert a["launches"] == {"flash_fwd": 2 * (3 + 1), "flash_bwd_dq": 2 * 3,
                             "flash_bwd_dkv": 2 * 3}
    assert sum(a["widths_seen"].values()) == 3
    assert all(int(w) % 64 == 0 for w in a["widths_seen"])
    assert a["real_over_512"] < a["real_over_padded"] <= 1
    assert a["idle_share"] == "not measured" and a["achieved_depth"] >= 1
    assert a["consumer_wait_s"] >= 0 and a["producer_wait_s"] >= 0
    assert row["run_a_prime"]["depth"] == 2 and row["run_a_prime"]["losses_equal_run_a"]
    assert row["run_c"]["losses_equal_materialized"]
    # the vocab: specials first, then words, then characters and continuations
    vocab = chip_smoke.review_vocab(["Naïve café, naive CAFE!"], n_words=1)
    assert vocab == chip_smoke.SPECIAL_TOKENS + ["naive", "!", ",", "a", "c", "e", "f", "i",
                                                 "n", "v", "##!", "##,", "##a", "##c",
                                                 "##e", "##f", "##i", "##n", "##v"]
    assert chip_smoke.FLASH_CASES[-2][:4] == ("bucket64_bf16", 8, 12, 64)
    assert chip_smoke.FLASH_CASES[-1][:4] == ("bucket128_bf16", 8, 12, 128)

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119flash_fwd_tc_kernelILi64EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119flash_fwd_tc_kernelILi64EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 2048 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi128EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_fwd_kernelIfLi128EEEvNS_4ArgsE
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, 400 bytes cmem[0]
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_119flash_fwd_tc_kernelILi64EEEvNS_4ArgsE
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0020*/               @P0 HMMA.16816.F32.BF16 R16, R8, R20, R16 ;
        /*0030*/                   LDSM.16.M88.4 R8, [R2] ;
\t\tFunction : _ZN12_GLOBAL__N_116flash_fwd_kernelIfLi128EEEvNS_4ArgsE
        /*0000*/                   FFMA R4, R8, R12, R4 ;
"""


def test_ptxas_report_and_sass_counts_parse_the_build_outputs():
    """The build report reads registers and spills per kernel from
    ``nvcc -Xptxas -v`` and counts tensor-core instructions per function
    in ``cuobjdump -sass`` (predicated ones too)."""
    tc = "_ZN12_GLOBAL__N_119flash_fwd_tc_kernelILi64EEEvNS_4ArgsE"
    fp32 = "_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi128EEEvNS_4ArgsE"
    report = chip_smoke._ptxas_report(PTXAS_LOG)
    assert report[tc] == {"stack_bytes": 0, "spill_store_bytes": 0, "spill_load_bytes": 0,
                          "registers": 128, "static_smem_bytes": 2048}
    assert report[fp32] == {"stack_bytes": 8, "spill_store_bytes": 12, "spill_load_bytes": 16,
                            "registers": 255, "static_smem_bytes": 0}
    assert chip_smoke._sass_counts(SASS, "HMMA") == {tc: 2, fp32: 0}
    assert chip_smoke._sass_counts(SASS, "LDSM") == {tc: 1, fp32: 0}


def test_flash_kernel_names_cover_every_wrapper_and_dtype():
    """Every (wrapper, dtype) the flash phase times names the kernel that
    launches: the tensor-core kernels in bf16, the CUDA-core ones in
    fp32; every tensor-core kernel is held to HMMA and no spill."""
    names = chip_smoke.FLASH_KERNEL_NAMES
    assert set(names) == {(k, dt) for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                          for dt in ("float32", "bfloat16")}
    assert all(("_tc_" in n) == (dt == "bfloat16") for (k, dt), n in names.items())
    held = {k for k, *_ in chip_smoke.TC_KERNELS}
    assert {n for n in names.values() if "_tc_" in n} <= held
    cases = {c[0]: c for c in chip_smoke.FLASH_CASES}
    for name in ("ragged200", "causal", "causal_window64", "pad_row", "dmask"):
        assert cases[name][5] == "float32"
        assert cases[f"{name}_bf16"][1:5] + cases[f"{name}_bf16"][6:] == \
            cases[name][1:5] + cases[name][6:]
        assert cases[f"{name}_bf16"][5] == "bfloat16"


def test_pooled_device_time_tolerates_dropped_records():
    """An unnamed call's device time (the library yardsticks) pools each
    record name over the windows: its mean duration times the most records
    one window held, so a record the profiler drops costs one sample of a
    mean, not a call's time, and the loss is counted."""
    full = {"gemm": (0.010, 10), "softmax": (0.002, 10)}
    lossy = {"gemm": (0.002, 2), "softmax": (0.0018, 9)}
    ms, lost = chip_smoke._pooled_ms([full, lossy, full], iters=5)
    assert lost == 8 + 1
    gemm = (0.010 + 0.002 + 0.010) / 22 * 10
    softmax = (0.002 + 0.0018 + 0.002) / 29 * 10
    assert ms == pytest.approx((gemm + softmax) / 5 * 1e3)
    assert chip_smoke._pooled_ms([full, full], iters=5) == (pytest.approx(2.4), 0)


def test_one_session_splits_into_its_windows_at_the_markers():
    """The profiled windows of one profiler session split at each run
    of marker spin kernels, each window's records by name; records out of
    start order sort first; a window whose markers were all dropped merges
    into the one before (and the caller then retakes the session)."""
    spin = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    events = [(spin, 0, 5), (spin, 10, 5), ("k", 20, 1000), ("k", 1100, 1000),
              (spin, 3000, 5), ("k", 3100, 3000), ("lib", 3050, 500),
              (spin, 9000, 5), (spin, 9010, 5), ("k", 9100, 2000)]
    windows = chip_smoke._window_records(list(reversed(events)))
    assert windows == [{"k": (2e-6, 2)}, {"lib": (5e-7, 1), "k": (3e-6, 1)},
                       {"k": (2e-6, 1)}]
    merged = chip_smoke._window_records([e for e in events if e[1] != 3000])
    assert len(merged) == 2 and merged[0]["k"] == (pytest.approx(5e-6), 3)


def test_fresh_process_phases_hand_their_rows_back(tmp_path, monkeypatch):
    """A phase run by ``--phase NAME OUT`` writes its rows to OUT, keyed as
    in the process that reads them (a tuple key stays a tuple), and the
    flash and vocab-CE cases, the optimizer/remat phase (it profiles), the
    obs phase's compile-budget run (its K1 library loads inside its fit)
    the mesh phase (its own process group) and the tp_serve and ring_train
    phases (their ranks' processes) all run so (the llama K3
    cases time with the others in the kernel phase); any other
    argument raises."""
    assert set(chip_smoke.FRESH_PROCESS_PHASES) == {
        "flash_phase", "vocab_ce_phase", "optim_memory_phase", "compile_budget_phase",
        "mesh_train_phase", "tp_serve_phase", "ring_train_phase"}
    rows = {("bert_bf16", "flash_fwd"): {"kernel_ms": 0.5, "contexts": [0, 3]},
            "gpt2": {"kernel_ms": 0.25, "status": "pass"}}
    monkeypatch.setitem(chip_smoke.FRESH_PROCESS_PHASES, "flash_phase", lambda: rows)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    out = tmp_path / "rows.json"
    assert chip_smoke.main(["--phase", "flash_phase", str(out)]) == 0
    assert chip_smoke._read_rows(out) == rows
    with pytest.raises(RuntimeError, match="--phase NAME OUT"):
        chip_smoke.main(["--phase", "serve_phase", str(out)])
    with pytest.raises(RuntimeError, match="--phase NAME OUT"):
        chip_smoke.main(["--bogus"])


def test_a_fresh_process_that_fails_fails_the_run():
    """The parent waits for its child and fails with the child's exit code:
    here the child finds no card and exits 2."""
    with pytest.raises(RuntimeError, match="flash_phase in its own process exited with 2"):
        chip_smoke._fresh_process("flash_phase")


def test_vocab_kernel_names_cover_every_wrapper_and_dtype():
    """Every (wrapper, hidden dtype) the vocab-CE phase times names the
    kernels that launch, the main one first: the wgmma forward and
    backward with bf16 hidden, the CUDA-core kernels with float32 hidden,
    each with its helpers (the forward's own split of W and the combine;
    the backward's split of W, dS, hᵀ and dH's cast; dH's split reduce on
    CUDA cores); every wgmma kernel is held to HGMMA, none may spill, and
    the kernels line reads each main kernel's build row. A train step's
    profile counts the forward's kernels for the forward and shares the
    joint backward's out between dH and dW, each counted once: no kernel
    name is counted twice."""
    names = chip_smoke.VOCAB_KERNEL_NAMES
    wrappers = ("fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_dw", "fused_ce_bwd")
    assert set(names) == {(k, dt) for k in wrappers for dt in ("float32", "bfloat16")}
    main = {"fused_ce_fwd": "vocab_ce_fwd", "fused_ce_bwd_dh": "vocab_ce_bwd_dh",
            "fused_ce_bwd_dw": "vocab_ce_bwd_dw", "fused_ce_bwd": "vocab_ce_bwd_dh"}
    for k in wrappers:
        assert names[(k, "float32")][0] == f"{main[k]}_kernel"
        assert all("_tc_" not in n and "_wgmma_" not in n for n in names[(k, "float32")])
    assert names[("fused_ce_fwd", "bfloat16")] == ("vocab_ce_fwd_wgmma_kernel",
                                                   "vocab_ce_fwd_split_w_kernel",
                                                   "vocab_ce_combine_kernel")
    assert names[("fused_ce_bwd_dh", "float32")][1] == "vocab_ce_dh_reduce_kernel"
    joint = set(names[("fused_ce_bwd", "bfloat16")])
    assert joint == set(names[("fused_ce_bwd_dh", "bfloat16")]) | set(
        names[("fused_ce_bwd_dw", "bfloat16")])
    assert names[("fused_ce_bwd_dh", "bfloat16")][0] == "vocab_ce_dh_wgmma_kernel"
    assert names[("fused_ce_bwd_dw", "bfloat16")][0] == "vocab_ce_dw_wgmma_kernel"
    step = chip_smoke.VOCAB_STEP_NAMES
    assert set(step["fused_ce_bwd_dh"]) | set(step["fused_ce_bwd_dw"]) == joint
    assert not set(step["fused_ce_bwd_dh"]) & set(step["fused_ce_bwd_dw"])
    fwd = chip_smoke.vocab_step_names("fused_ce_fwd", "bfloat16")
    assert not set(fwd) & joint
    # a step profile matches names by substring: no name holds another
    counted = list(fwd) + list(step["fused_ce_bwd_dh"]) + list(step["fused_ce_bwd_dw"])
    assert not [(a, b) for a in counted for b in counted if a != b and a in b]
    held = {k: (op or ["HMMA"])[0] for k, _, *op in chip_smoke.TC_KERNELS}
    assert "vocab_ce_fwd_tc_kernel" not in held
    assert {n for n in joint | set(fwd) if "_wgmma_" in n} == {
        k for k, op in held.items() if op == "HGMMA"}
    assert all(dims == (None,) for k, dims, *_ in chip_smoke.TC_KERNELS
               if k.startswith("vocab_ce"))
    assert chip_smoke.VOCAB_MAIN == "gpt2_bf16"


def test_vocab_kernel_names_follow_the_route():
    """The vocab-CE kernels a wrapper launches are named by hidden dtype
    alone: bf16 runs the wgmma forward and backward at every H (the
    forward's old H cap of 1216 is gone), float32 the CUDA-core kernels;
    the MLM cases are in the phase."""
    names = chip_smoke.vocab_kernel_names
    assert names("fused_ce_bwd_dw", "bfloat16")[0] == "vocab_ce_dw_wgmma_kernel"
    assert names("fused_ce_bwd_dh", "bfloat16")[0] == "vocab_ce_dh_wgmma_kernel"
    assert chip_smoke.vocab_step_names("fused_ce_bwd_dw", "bfloat16") == \
        chip_smoke.VOCAB_STEP_NAMES["fused_ce_bwd_dw"]
    assert names("fused_ce_fwd", "bfloat16")[0] == "vocab_ce_fwd_wgmma_kernel"
    assert chip_smoke.vocab_step_names("fused_ce_fwd", "bfloat16") == \
        names("fused_ce_fwd", "bfloat16")
    assert names("fused_ce_fwd", "float32")[0] == "vocab_ce_fwd_kernel"
    assert names("fused_ce_bwd_dh", "float32")[0] == "vocab_ce_bwd_dh_kernel"
    assert chip_smoke.vocab_step_names("fused_ce_bwd_dh", "float32") == \
        names("fused_ce_bwd_dh", "float32")
    cases = {c[0]: c[1:] for c in chip_smoke.VOCAB_CASES}
    assert cases["mlm_base_bf16"] == (1024, 30522, 776, "bfloat16", 0.0, False)
    assert cases["mlm_large_bf16"] == (1024, 30522, 1032, "bfloat16", 0.0, False)
    assert cases["mlm_eval_bf16"] == (512, 30522, 776, "bfloat16", 0.0, False)
    assert set(chip_smoke.VOCAB_MLM) <= set(cases)


def test_every_mlm_phase_shape_is_held_against_its_plain_version():
    """Each shape the mlm phase's runs launch K1 and K2 at is a case of the
    flash or vocab-CE phase, which holds it against the plain version: K1
    at each run's heads and head width at sequence 512, masked (the batch
    sizes only the grid); K2 at the K rows gathered from a train batch of
    8 and, where the run evaluates, an eval batch of 4 (the forward's
    splits follow N), at the bias-folded width."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import (
        bias_fold_width,
        mlm_gather_rows,
    )

    flash = {c[2:6] for c in chip_smoke.FLASH_CASES if c[6] and not c[7] and not c[9]}
    vocab = {c[1:5] for c in chip_smoke.VOCAB_CASES}
    cap = TrainConfig.fused_mlm_mask_cap
    fused_runs = 0
    for name, _, hf, task, _, extra in chip_smoke._mlm_runs():
        heads = hf["num_attention_heads"]
        assert (heads, 512, hf["hidden_size"] // heads, "bfloat16") in flash, name
        if task != "mlm" or extra[extra.index("--fused_vocab_ce") + 1] != "true":
            continue
        fused_runs += 1
        width = bias_fold_width(hf.get("embedding_size") or hf["hidden_size"])
        for batch in (8, 4) if "--max_eval_samples" in extra else (8,):
            shape = (mlm_gather_rows(batch * 512, cap), hf["vocab_size"], width, "bfloat16")
            assert shape in vocab, (name, batch, shape)
    assert fused_runs == 3


def test_mlm_phase_on_cpu(on_cpu, monkeypatch, tmp_path, capsys):
    """The mlm phase at hidden 64, 2 layers, a small vocab and 3 steps:
    the WordPiece directory, the launch accounting (K1 and K2 in one step,
    eval steps, the unfused and RTD runs without K2), masked tokens and K,
    ``ce_dropped`` 0, the reloaded exports, the profiled passes, the first
    losses of the fused and unfused runs within the bf16 gate, the rows
    and the summary."""
    run = cli.run
    monkeypatch.setattr(cli, "run", lambda argv: run(argv + ["--attention_impl", "flash"]))
    _small_vocab(monkeypatch, positions=128)
    for name, value in (("MLM_STEPS", 3), ("MLM_LARGE_STEPS", 2), ("RTD_STEPS", 2),
                        ("MLM_STREAM_STEPS", 2), ("MLM_EVAL_SAMPLES", 8),
                        ("MLM_PROFILED_STEPS", 2), ("MLM_LARGE_PROFILED_STEPS", 1)):
        monkeypatch.setattr(chip_smoke, name, value)
    rows = chip_smoke.mlm_phase(tmp_path, "cpu rehearsal")
    assert list(rows) == ["bert_base_fused", "bert_base_unfused", "bert_large_fused",
                          "electra_small_rtd", "bert_base_streaming"]
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert [p["run"] for p in printed if p.get("phase") == "mlm"] == list(rows)
    summary = [p for p in printed if p.get("phase") == "mlm_summary"]
    assert len(summary) == 1 and summary[0]["first_loss_fused_over_unfused_rel"] <= 2.0 ** -6
    base, unfused = rows["bert_base_fused"], rows["bert_base_unfused"]
    assert base["launches"] == {"flash_fwd": 2 * (3 + 2), "flash_bwd_dq": 2 * 3,
                                "flash_bwd_dkv": 2 * 3, "fused_ce_fwd": 3 + 2,
                                "fused_ce_bwd_dh": 3, "fused_ce_bwd_dw": 3}
    assert unfused["launches"]["fused_ce_fwd"] == 0 and unfused["launches"]["flash_fwd"] == 10
    assert base["seq"] == 128 and base["gather_rows_k"] == 256
    assert base["ce_dropped_train"] == base["ce_dropped_wanted"] == 0
    assert unfused["ce_dropped_train"] == "not fused"
    assert 0 < base["masked_tokens_per_batch"]["min"] <= base["masked_tokens_per_batch"]["max"]
    assert base["bias_fold_width"] == 72 and base["wordpiece_tokens"] <= 600
    large = rows["bert_large_fused"]
    assert large["launches"]["fused_ce_bwd_dw"] == 2 and large["eval_steps"] == 0
    assert large["profiled_steps"] == 1 and base["profiled_steps"] == 2
    rtd = rows["electra_small_rtd"]
    assert rtd["launches"] == {"flash_fwd": 2 * (2 + 2), "flash_bwd_dq": 4, "flash_bwd_dkv": 4,
                               "fused_ce_fwd": 0, "fused_ce_bwd_dh": 0, "fused_ce_bwd_dw": 0}
    assert set(rtd["eval"]) == {"eval_loss", "eval_accuracy"}
    stream = rows["bert_base_streaming"]
    assert stream["streaming"] and stream["launches"]["fused_ce_fwd"] == 2
    for row in rows.values():
        assert row["export_reloads_bit_for_bit"] and row["card"] == "cpu rehearsal"
        assert math.isfinite(row["loss"]) and row["dtype"] == "bfloat16"
    assert base["idle_share"] == "not measured" or isinstance(base["idle_share"], float)


def test_every_seq2seq_phase_shape_is_held_against_its_plain_version():
    """Each shape the seq2seq phase's fused runs launch K2 at is a case of
    the vocab-CE phase, which holds it against the plain version: B·T rows
    of a train batch of 8 (smoothing 0.1) and, where the run evaluates, of
    an eval batch of 4 (the plain CE; the forward's splits follow N), at
    the target length (span corruption's raised one), the model's vocab
    and width, bf16 hidden. No run launches K1."""
    vocab = {c[1:6] for c in chip_smoke.VOCAB_CASES}
    fused_runs = 0
    for name, family, hf, _, eval_samples, extra in chip_smoke._seq2seq_runs():
        if extra[extra.index("--fused_vocab_ce") + 1] != "true":
            continue
        fused_runs += 1
        span = "--span_corruption" in extra
        target = int(chip_smoke.S2S_SEQ * 0.2) + 4 if span else chip_smoke.S2S_TARGET
        assert target == (106 if span else 64)
        shapes = [(8 * target, 0.1)] + ([(4 * target, 0.0)] if eval_samples else [])
        for n, eps in shapes:
            shape = (n, hf["vocab_size"], hf["d_model"], "bfloat16", eps)
            assert shape in vocab, (name, shape)
    assert fused_runs == 4
    assert set(chip_smoke.VOCAB_SEQ2SEQ) == {c[0] for c in chip_smoke.VOCAB_CASES
                                             if c[2] in (32128, 50265)}


def test_seq2seq_phase_on_cpu(on_cpu, monkeypatch, tmp_path, capsys):
    """The seq2seq phase at d_model 64, 2 + 2 layers, a vocab of 600 and 3
    steps: the launch accounting (K2 on the fused runs' train and eval
    steps, none unfused, K1 none), span corruption's target of 106, the
    results keys with ROUGE-L, the reloaded exports, the profiled passes,
    the generation check, the first losses of the fused and unfused runs
    within the bf16 gate, the rows and the summary."""
    for name, value in (("S2S_STEPS", 3), ("S2S_SHORT_STEPS", 2), ("BART_STEPS", 2),
                        ("S2S_EVAL_SAMPLES", 8), ("S2S_SHORT_EVAL_SAMPLES", 4),
                        ("S2S_ROUGE_SAMPLES", 4), ("BART_ROUGE_SAMPLES", 2),
                        ("S2S_PROFILED_STEPS", 2), ("BART_PROFILED_STEPS", 1),
                        ("GEN_ROWS", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    rows = chip_smoke.seq2seq_phase(tmp_path, "cpu rehearsal")
    assert list(rows) == ["t5_small_fused", "t5_small_unfused", "t5_small_span",
                          "t5_small_streaming", "bart_base_fused"]
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert [p["run"] for p in printed if p.get("phase") == "seq2seq"] == list(rows)
    summary = [p for p in printed if p.get("phase") == "seq2seq_summary"]
    assert len(summary) == 1 and summary[0]["first_loss_fused_over_unfused_rel"] <= 2.0 ** -6
    fused, unfused = rows["t5_small_fused"], rows["t5_small_unfused"]
    no_k1 = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert fused["launches"] == {**no_k1, "fused_ce_fwd": 3 + 2, "fused_ce_bwd_dh": 3,
                                 "fused_ce_bwd_dw": 3}
    assert unfused["launches"] == {**no_k1, "fused_ce_fwd": 0, "fused_ce_bwd_dh": 0,
                                   "fused_ce_bwd_dw": 0}
    assert set(fused["eval"]) == {"eval_loss", "eval_accuracy", "rougeL_precision",
                                  "rougeL_recall", "rougeL_f1"}
    assert fused["optimizer"] == "adafactor" and fused["label_smoothing"] == 0.1
    span = rows["t5_small_span"]
    assert span["target"] == 106 and span["launches"]["fused_ce_fwd"] == 2 + 1
    assert rows["t5_small_streaming"]["streaming"] and rows["t5_small_streaming"]["eval_steps"] == 0
    bart = rows["bart_base_fused"]
    assert bart["optimizer"] == "adamw" and bart["launches"]["fused_ce_bwd_dw"] == 2
    assert fused["profiled_steps"] == 2 and bart["profiled_steps"] == 1
    assert set(fused["k2_ms_per_step"]) == {"fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_dw"}
    assert fused["achieved_tflops"] > 0 and fused["mfu"] == "not measured"
    gen = fused["generation"]
    assert gen["tokens_compared"] >= 2 and gen["decode_tokens_per_s"] > 0
    for row in rows.values():
        assert row["export_reloads_bit_for_bit"] and row["card"] == "cpu rehearsal"
        assert math.isfinite(row["loss"]) and row["dtype"] == "bfloat16"


def test_every_packing_lora_deberta_phase_shape_is_held_against_its_plain_version():
    """Each shape the packing, LoRA and DeBERTa phases launch K1 and K2 at
    is a case the flash or vocab-CE phase holds against the plain version:
    K1 at BERT-large's 16 heads and BERT-base's 12 at sequence 512 (masked)
    and GPT-2's causal eval steps; K2 at GPT-2's B·S rows (train 8, eval 4
    rows of 512), the K rows gathered from BERT-base's and DeBERTa-v3-base's
    MLM batches at the bias-folded width. The segment-packed and DeBERTa
    runs launch no K1."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import (
        bias_fold_width,
        mlm_gather_rows,
    )

    masked = {c[1:6] for c in chip_smoke.FLASH_CASES if c[6] and not c[7] and not c[9]}
    causal = {c[1:6] for c in chip_smoke.FLASH_CASES if c[7] and c[8] is None}
    vocab = {c[1:5] for c in chip_smoke.VOCAB_CASES}
    cap = TrainConfig.fused_mlm_mask_cap
    large, base = chip_smoke.BERT_LARGE, chip_smoke.BERT_BASE
    for hf in (large, base):
        heads = hf["num_attention_heads"]
        assert (8, heads, 512, hf["hidden_size"] // heads, "bfloat16") in masked
    gpt2 = chip_smoke.GPT2_124M
    assert (8, gpt2["n_head"], 512, gpt2["n_embd"] // gpt2["n_head"], "bfloat16") in causal
    for batch in (8, 4):
        assert (batch * 512, gpt2["vocab_size"], gpt2["n_embd"], "bfloat16") in vocab
        for hf in (base, chip_smoke.DEBERTA_V3_BASE):
            shape = (mlm_gather_rows(batch * 512, cap), hf["vocab_size"],
                     bias_fold_width(hf["hidden_size"]), "bfloat16")
            assert shape in vocab, shape
    assert set(chip_smoke.VOCAB_DEBERTA) == {c[0] for c in chip_smoke.VOCAB_CASES
                                             if c[2] == 128100}
    assert [r[0] for r in chip_smoke._packing_runs()] == [
        "gpt2_unpacked", "gpt2_segment", "gpt2_packed", "bert_mlm_segment"]


def _breadth_small(monkeypatch, **values):
    run = cli.run
    monkeypatch.setattr(cli, "run", lambda argv: run(argv + ["--attention_impl", "flash"]))
    _small_vocab(monkeypatch, positions=64)
    # the EOS-joined rows take GPT-2's EOS, which must lie in the small vocab
    monkeypatch.setattr(chip_smoke, "GPT2_124M", dict(chip_smoke.GPT2_124M, eos_token_id=299,
                                                      bos_token_id=299))
    for name, value in values.items():
        monkeypatch.setattr(chip_smoke, name, value)


def _printed(capsys) -> list:
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_packing_phase_on_cpu(on_cpu, monkeypatch, tmp_path, capsys):
    """The packing phase at hidden 64, 2 layers and 3 steps: the launch
    accounting (no K1 on segment-packed steps, K1 on the EOS-joined rows'
    eval steps, K2 on every step), real over padded tokens (1 for the
    EOS-joined rows), ``ce_dropped`` 0, the profiled passes, the exactness
    gate's rows and the summary."""
    _breadth_small(monkeypatch, PACK_STEPS=3, PACK_EVAL_SAMPLES=8, PACK_PROFILED_STEPS=2,
                   PACK_EXACT_EXAMPLES=6)
    rows = chip_smoke.packing_phase(tmp_path, "cpu rehearsal")
    assert list(rows) == ["gpt2_unpacked", "gpt2_segment", "gpt2_packed", "bert_mlm_segment"]
    printed = _printed(capsys)
    assert [p["run"] for p in printed if p.get("phase") == "packing"] == list(rows)
    exact = [p for p in printed if p.get("phase") == "packing_exactness"]
    assert [p["loss"] for p in exact] == ["causal-lm", "mlm"]
    assert all(p["loss_sum_rel_err"] <= 1e-5 and p["rows_packed"] <= p["rows_unpacked"]
               for p in exact)
    assert len([p for p in printed if p.get("phase") == "packing_summary"]) == 1
    un, seg, packed, mlm = (rows[n] for n in rows)
    L = 2
    assert un["launches"] == {"flash_fwd": L * un["eval_steps"], "flash_bwd_dq": 0,
                              "flash_bwd_dkv": 0, "fused_ce_fwd": 3 + un["eval_steps"],
                              "fused_ce_bwd_dh": 3, "fused_ce_bwd_dw": 3}
    assert un["eval_steps"] == 2 and 0 < seg["eval_steps"] <= 2
    assert seg["launches"]["flash_fwd"] == 0 and seg["launches"]["fused_ce_bwd_dw"] == 3
    assert packed["real_over_padded_tokens"] == 1.0
    assert packed["launches"]["flash_fwd"] == L * packed["eval_steps"]
    assert mlm["launches"]["flash_fwd"] == 0 and mlm["ce_dropped_train"] == 0.0
    assert mlm["launches"]["fused_ce_fwd"] == 3 + mlm["eval_steps"]
    assert seg["real_over_padded_tokens"] >= un["real_over_padded_tokens"]
    for row in rows.values():
        assert row["card"] == "cpu rehearsal" and math.isfinite(row["loss"])
        assert row["profiled_steps"] == 2 and set(row["k2_ms_per_step"]) == set(
            ("fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_dw"))


def test_lora_phase_on_cpu(on_cpu, monkeypatch, tmp_path, capsys):
    """The LoRA phase at hidden 64, 2 layers: the launch accounting (K1 on
    every train and eval step of the BERT run; K2's forward and dH on the
    GPT-2 run's steps, no dW: its tied embedding is frozen), the
    frozen base (only adapters, classifier and pooler moved), the merged
    export and the sidecar reloaded, the resume bit for bit, the full
    fine-tune's figures and the summary."""
    _breadth_small(monkeypatch, LORA_STEPS=6, LORA_EVAL_SAMPLES=8, LORA_FULL_STEPS=2,
                   LORA_CKPT_EVERY=2, LORA_STOP_AFTER=3, LORA_GPT2_STEPS=2,
                   LORA_GPT2_EVAL_SAMPLES=4, LORA_PROFILED_STEPS=2,
                   LORA_FULL_PROFILED_STEPS=1)
    rows = chip_smoke.lora_phase(tmp_path, "cpu rehearsal")
    assert list(rows) == ["bert_large_lora", "bert_large_full_finetune", "gpt2_lora_fused"]
    a, b, g = rows.values()
    assert a["launches"] == {"flash_fwd": 2 * (6 + 2), "flash_bwd_dq": 2 * 6,
                             "flash_bwd_dkv": 2 * 6, "fused_ce_fwd": 0, "fused_ce_bwd_dh": 0,
                             "fused_ce_bwd_dw": 0}
    assert a["resume_bit_for_bit"] and a["resumed_steps"] == 4
    assert a["export_reloads_bit_for_bit"] and a["sidecar_reloads"]
    assert set(a["moved"]) == {"backbone.pooler.pooler.weight", "backbone.pooler.pooler.bias",
                               "classifier.weight", "classifier.bias"}
    assert a["adapter_params"] == 2 * 4 * 8 * (64 + 64)
    assert a["optimizer_state_bytes"] < b["optimizer_state_bytes"] / 5
    assert b["train_steps"] == 2 and b["trainable_params"] > 10 * a["adapter_params"]
    assert a["profiled_steps"] == 2 and b["profiled_steps"] == 1
    assert g["launches"] == {"flash_fwd": 2 * 1, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                             "fused_ce_fwd": 2 + 1, "fused_ce_bwd_dh": 2,
                             "fused_ce_bwd_dw": 0}
    summary = [p for p in _printed(capsys) if p.get("phase") == "lora_summary"]
    assert len(summary) == 1 and summary[0]["lora_over_full_optimizer_bytes"] < 0.2


def test_deberta_phase_on_cpu(on_cpu, monkeypatch, tmp_path, capsys):
    """The DeBERTa phase at hidden 64, 2 layers: no K1 on any run, K2 on the
    fused MLM run's train and eval steps, the exports reloaded bit for bit,
    the profiled passes, the v2-style run's conv and separate position
    projections, the summary."""
    _breadth_small(monkeypatch, DEBERTA_STEPS=3, DEBERTA_EVAL_SAMPLES=8,
                   DEBERTA_MLM_STEPS=2, DEBERTA_MLM_EVAL_SAMPLES=4, DEBERTA_V2_STEPS=2,
                   DEBERTA_PROFILED_STEPS=2, DEBERTA_MLM_PROFILED_STEPS=1)
    rows = chip_smoke.deberta_phase(tmp_path, "cpu rehearsal")
    assert list(rows) == ["v3_base_seq_cls", "v3_base_mlm_fused", "v2_style_depth2"]
    no_k1 = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    seq_cls, mlm, v2 = rows.values()
    assert seq_cls["launches"] == {**no_k1, "fused_ce_fwd": 0, "fused_ce_bwd_dh": 0,
                                   "fused_ce_bwd_dw": 0}
    assert mlm["launches"] == {**no_k1, "fused_ce_fwd": 2 + 1, "fused_ce_bwd_dh": 2,
                               "fused_ce_bwd_dw": 2}
    assert mlm["ce_dropped_train"] == 0.0 and mlm["profiled_steps"] == 1
    assert not v2["share_att_key"] and v2["conv_kernel_size"] == 3 and v2["layers"] == 2
    assert seq_cls["pos_att_type"] == ["p2c", "c2p"] and seq_cls["eval_steps"] == 2
    for row in rows.values():
        assert row["export_reloads_bit_for_bit"] and math.isfinite(row["loss"])
    summary = [p for p in _printed(capsys) if p.get("phase") == "deberta_summary"]
    assert len(summary) == 1


# -- decoding, the sampled and int8 serve runs, the predict CLI ---------------------

SERVE_TINY = dict(vocab_size=300, max_position_embeddings=128, hidden_size=64, num_layers=2,
                  num_heads=1, intermediate_size=128, eos_token_id=299, pad_token_id=0)


@pytest.fixture
def serve_on_cpu(on_cpu, monkeypatch):
    """The serve phase at a tiny width (contexts up to 124 of 128), the
    paged kernel counted where the model calls it (on the CPU the plain
    path runs and counts nothing); returns the shapes each call handed it."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import gpt2 as t_gpt2

    monkeypatch.setattr(chip_smoke, "SERVE_CONFIG", SERVE_TINY)
    monkeypatch.setattr(chip_smoke, "SERVE_MAX_LEN", 128)
    monkeypatch.setattr(chip_smoke, "SERVE_LONG_PROMPTS", (40, 61))
    monkeypatch.setattr(chip_smoke, "SERVE_TIGHT_BLOCKS", 1 + 12)
    shapes = []
    real = t_gpt2.paged_attention

    def counted(q, k_pool, v_pool, block_tables, context_lens, **kw):
        pa.paged_decode_attention.launches += 1
        shapes.append((q.shape[0], q.shape[1], k_pool.shape[2], q.shape[2], k_pool.shape[1],
                       block_tables.shape[1] * k_pool.shape[1], str(q.dtype).split(".")[1],
                       kw.get("k_scale_pool") is not None))
        return real(q, k_pool, v_pool, block_tables, context_lens, **kw)

    monkeypatch.setattr(t_gpt2, "paged_attention", counted)
    return shapes


def test_serve_phases_on_cpu(serve_on_cpu, capsys):
    """The serve phase and its sampled and int8 runs at a tiny width: K3's
    count per decode step, greedy tokens against ``generate_causal``,
    sampled streams equal under preemption and equal to the plain draws,
    int8 pools against the int8 dense cache, the pool bytes and what equal
    bytes admit."""
    row, model, trace = chip_smoke.serve_phase()
    assert row["paged_kernel_launches"] == row["decode_steps"] * 2
    assert row["tokens_compared_with_plain"] > 0
    runs = chip_smoke.serve_sampling_int8_phase(model, trace, {"int8": {"kernel_ms": 0.0}})
    assert list(runs) == ["sampled", "sampled_tight", "int8"]
    for r in runs.values():
        assert r["paged_kernel_launches"] == r["decode_steps"] * 2 > 0
    assert runs["sampled_tight"]["preemptions"] >= 1 and runs["sampled"]["sampled_requests"] == 10
    sampled = runs["sampled"]
    assert sampled["sampled_tokens_compared_with_plain"] > 0
    assert sampled["greedy_tokens_compared_with_plain"] > 0
    int8 = runs["int8"]
    assert int8["tokens_compared_with_plain_int8"] > 0
    assert int8["bytes_per_token_per_head"] == {"fp32": 2 * 4 * 64, "int8": 2 * (64 + 4)}
    assert int8["pool_bytes_per_token"]["int8"] * 256 == int8["pool_bytes_per_token"]["fp32"] * 68
    assert int8["equal_bytes"]["ratio"] > 3.5
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert [p["phase"] for p in printed] == ["serve", "serve_sampled", "serve_sampled",
                                             "serve_int8"]
    # the rehearsal's K3 calls: every slot of the tiny engine at the full
    # table width, fp32 on the sampled runs, the int8 route on the last
    assert {s[:7] for s in serve_on_cpu} == {(8, 1, 1, 64, 16, 128, "float32")}
    assert {s[7] for s in serve_on_cpu} == {False, True}


def test_every_serve_run_k3_shape_is_held_against_its_plain_version(monkeypatch):
    """K3's launch configuration follows its shape: each serve run (the
    greedy, the sampled and the int8 ones) launches it on every slot of
    the engine at the full table width (``SERVE_MAX_LEN``; the trace's
    contexts reach 896 + 64 tokens) with GPT-2 124M's heads and head dim,
    fp32 queries; the fp pools match the kernel phase's ``gpt2`` case and
    the int8 ones its ``int8`` case, plan included."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.gpt2 import Gpt2Config

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")       # plan for the H100's SMs
    cfg = Gpt2Config(**chip_smoke.SERVE_CONFIG)
    H, D, bs, slots = cfg.num_heads, cfg.hidden_size // cfg.num_heads, 16, 8
    assert chip_smoke.SERVE_LONG_PROMPTS[1] - 1 + 64 <= chip_smoke.SERVE_MAX_LEN
    cases = {c[0]: c for c in chip_smoke.KERNEL_CASES}
    for int8, name in ((False, "gpt2"), (True, "int8")):
        case = cases[name]
        assert case[1:9] == (slots, H, H, D, bs, chip_smoke.SERVE_MAX_LEN, "float32", int8)
        assert case[9] is None
        plan = pa.split_plan(slots, H, chip_smoke.SERVE_MAX_LEN, bs, pa.H100_SMS)
        assert chip_smoke._plan(case) == plan


def _tiny_gpt2_export(path):
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.tokenization import (
        WordHashTokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import init_gpt2
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.gpt2 import Gpt2Config

    cfg = Gpt2Config(**SERVE_TINY, hidden_dropout=0.0, embd_dropout=0.0,
                     attention_dropout=0.0)
    model = init_gpt2(cfg, seed=0, device="cpu")
    auto.save_pretrained(str(path), model, "gpt2", cfg)
    WordHashTokenizer(vocab_size=cfg.vocab_size).save_pretrained(str(path))
    return path


def test_decode_phase_on_cpu(on_cpu, monkeypatch, tmp_path, capsys):
    """The decode phase on a tiny GPT-2 export (2 layers): every run in
    fp32 and bf16, the exactness gates (speculative, chunked and beam 1
    against greedy up to the first near-tie; sampled twice equal), the
    int8 weight-only quality contract and the byte counts."""
    for name, value in (("DECODE_ROWS", 3), ("DECODE_PROMPT", 12), ("DECODE_NEW", 6),
                        ("DECODE_DRAFT_LAYERS", 1), ("DECODE_CHUNK", 4)):
        monkeypatch.setattr(chip_smoke, name, value)
    rows = chip_smoke.decode_phase(_tiny_gpt2_export(tmp_path / "gpt2"), "cpu rehearsal")
    names = ["greedy", "sampled", "beam4", "speculative", "chunked_prefill", "int8_kv",
             "int8_weights"]
    assert [k[0] for k in rows if k[1] == "float32" and k[0] != "gates"] == names
    assert [k for k in rows if k[1] == "bfloat16"] == [(n, "bfloat16") for n in names]
    for key, row in rows.items():
        if key[0] == "gates":
            continue
        assert row["ttft_s"] > 0 and row["decode_tokens_per_sec"] > 0
        assert ("idle_share" in row) == (key[1] == "float32")
    spec = rows[("speculative", "float32")]
    assert spec["window_ceiling"] == chip_smoke.DECODE_K + 1
    assert 1.0 <= spec["tokens_per_target_pass"] <= chip_smoke.DECODE_K + 1
    gates = rows[("gates", "float32")]
    assert gates["speculative_tokens_compared"] > 0 and gates["beam1_tokens_compared"] > 0
    assert gates["int8_logits_correlation"] > 0.999
    assert gates["weight_bytes_int8"] < gates["weight_bytes_fp32"]
    assert rows[("int8_weights", "float32")]["kernels_quantized"] == 2 * 4


def test_seq2seq_decode_phase_on_cpu(on_cpu, monkeypatch, tmp_path, capsys):
    """T5 and BART decoding at d_model 64: greedy, sampled, beam 4 (its
    score at least greedy's), T5's speculative run equal to greedy up to
    the first near-tie (BART's refused), the int8 model's logits read."""
    for name, value in (("DECODE_ROWS", 2), ("S2S_SEQ", 24), ("S2S_DECODE_NEW", 5)):
        monkeypatch.setattr(chip_smoke, name, value)
    rows = chip_smoke.seq2seq_decode_phase(tmp_path)
    assert [k for k in rows if k[0] == "t5_small"] == [
        ("t5_small", n) for n in ("greedy", "sampled", "beam4", "int8_weights", "speculative",
                                  "gates")]
    assert ("bart_base", "speculative") not in rows
    assert rows[("bart_base", "gates")]["speculative"].startswith("refused: ")
    assert rows[("t5_small", "gates")]["speculative_tokens_compared"] > 0
    for key, row in rows.items():
        if key[1] == "gates":
            assert row["int8_logits_max_rel_err"] >= 0 and row["int8_logits_correlation"] <= 1
        else:
            assert row["tokens_per_sec"] > 0


def test_predict_phase_on_cpu(on_cpu, monkeypatch, tmp_path, capsys):
    """The predict CLI's entry, run in this process, on tiny exports of
    each kind: the JAX rows' keys, generated ids equal to the direct
    calls'."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.tokenization import (
        WordHashTokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
        init_encoder,
        init_seq2seq,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.layers import (
        EncoderConfig,
    )

    monkeypatch.setattr(chip_smoke, "PREDICT_NEW", 4)
    monkeypatch.setattr(chip_smoke, "DECODE_DRAFT_LAYERS", 1)
    exports = {"causal-lm": _tiny_gpt2_export(tmp_path / "gpt2")}
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "movie", "was", "and",
             "long"]
    for task, n_vocab in (("seq-cls", 300), ("mlm", len(words))):
        cfg = EncoderConfig(vocab_size=n_vocab, hidden_size=32, num_layers=1, num_heads=2,
                            intermediate_size=64, max_position_embeddings=128,
                            use_pooler=task == "seq-cls")
        model = init_encoder(auto.build_model("bert", task, cfg), device="cpu")
        path = tmp_path / task
        auto.save_pretrained(str(path), model, "bert", cfg)
        if task == "mlm":
            (path / "vocab.txt").write_text("\n".join(words) + "\n")
        else:
            WordHashTokenizer(vocab_size=n_vocab).save_pretrained(str(path))
        exports[task] = path
    hf = dict(chip_smoke.T5_SMALL)
    model, _, cfg = auto.from_pretrained(str(chip_smoke._config_dir(tmp_path / "t5", hf)),
                                         task="seq2seq", device="cpu")
    auto.save_pretrained(str(tmp_path / "t5" / "model"), init_seq2seq(model, device="cpu"),
                         "t5", cfg)
    exports["seq2seq"] = tmp_path / "t5" / "model"
    rows = chip_smoke.predict_phase(tmp_path / "predict", exports)
    assert set(rows) == {"seq-cls", "mlm", "causal-lm_beam", "causal-lm_sampled",
                         "causal-lm_self_speculative", "seq2seq", "wall_s"}
    for name, row in rows.items():
        if name == "wall_s":
            continue
        assert row["keys"] == chip_smoke.PREDICT_ROW_KEYS[name.split("_")[0]]
        if name.startswith(("causal", "seq2seq")):
            assert row["generated_ids_equal_direct_call"]


def test_serve_engine_phase_on_cpu(serve_on_cpu, monkeypatch, capsys):
    """The serve_engine phase at a tiny width: (a) the prefix cache on and
    off on a templated trace, (a') copy-on-write on and off on nested
    templates whose shorter one ends off the chunk grid, (b) the width
    ladder auto and full, (b') the gather route, (c) speculation (no K3
    launch), (d) swap against recompute on a thrash trace that preempts,
    (e) overlap on and off with sampled requests and a profiled window, (f)
    the events valid, every timeline summing, and deadline-ordered
    admission under ``policy='slo'``."""
    for name, value in (
            ("PREFIX_REQUESTS", 8), ("PREFIX_LEN", 24), ("PREFIX_TAILS", (2, 6)),
            ("PREFIX_NEW", ((3, 6), (3, 6))),
            ("PREFIX_ENGINE", dict(num_slots=4, block_size=8, prefill_chunk=16,
                                   max_model_len=64, num_blocks=18)),
            ("COW_REQUESTS", 8), ("COW_LEN", 24), ("COW_EXT", 32),
            ("THRASH", dict(n_requests=12, n_templates=3, template_len=24, tail_lo=2,
                            tail_hi=6, short_new=(3, 6), long_new=24, long_every=4)),
            ("THRASH_ENGINE", dict(num_slots=4, block_size=8, prefill_chunk=8,
                                   max_model_len=64, num_blocks=13)),
            ("SPEC_DRAFT_LAYERS", 1), ("OVERLAP_PROFILED", (2, 6))):
        monkeypatch.setattr(chip_smoke, name, value)
    _, model, trace = chip_smoke.serve_phase()
    capsys.readouterr()
    rows = chip_smoke.serve_engine_phase(model, trace)
    assert list(rows) == ["prefix_on", "prefix_off", "cow_on", "cow_off", "ladder_auto",
                          "ladder_full", "xla_route", "speculative", "swap_always",
                          "recompute", "overlap_on", "overlap_off", "telemetry"]
    assert rows["prefix_on"]["cache_hit_rate"] > 0.5 and rows["prefix_on"]["cow_copies"] >= 0
    assert rows["prefix_on"]["same_tokens_as_off"]["identical"] == 8
    assert rows["cow_on"]["cow_copies"] > 0 and rows["cow_off"]["cow_copies"] == 0
    assert rows["cow_on"]["same_tokens_as_off"]["identical"] == 8
    assert rows["xla_route"]["paged_kernel_launches"] == 0
    assert rows["xla_route"]["same_tokens_as_k3"]["identical"] == len(trace)
    assert rows["xla_route"]["idle_share"] == "not measured"
    assert rows["ladder_auto"]["bucket_switches"] >= 1
    assert set(rows["ladder_auto"]["k3_launches_by_width"]) == {"32", "128"}
    assert rows["ladder_full"]["k3_launches_by_width"].keys() == {"128"}
    assert rows["speculative"]["paged_kernel_launches"] == 0
    assert rows["speculative"]["same_tokens_as_plain"]["identical"] == len(trace)
    assert rows["swap_always"]["swap_outs"] >= 1 and rows["recompute"]["preemptions"] >= 1
    assert rows["overlap_on"]["same_tokens_as_off"]["identical"] == len(trace)
    assert rows["overlap_on"]["sync_free_dispatches"] > 0
    assert rows["overlap_on"]["idle_share"] == "not measured"        # no card
    assert rows["overlap_on"]["window_iterations"] == [2, 6]
    tel = rows["telemetry"]
    assert tel["events"] > 0 and tel["request_timelines"] >= 8 + 8 + 20 + 12
    assert tel["policy_slo_admission_order"] == sorted(chip_smoke.POLICY_DEADLINES)
    for name, r in rows.items():
        if name not in ("speculative", "xla_route", "telemetry"):
            assert r["paged_kernel_launches"] == r["decode_steps"] * 2 > 0
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert [p["run"] for p in printed] == list(rows)


def test_every_serve_engine_k3_shape_is_held_against_its_plain_version(monkeypatch):
    """K3's launch configuration follows its shape: every (slots, width)
    the serve_engine phase's plain-decode engines can launch it at (each
    width of each engine's ladder) is a kernel case with GPT-2 124M's
    heads, fp32 queries, block 16 and a table of max_model_len, plan
    included; so is every (slots, width) of the serve_router phase's
    replicas (a table at least theirs); the shared-block cases walk the
    prefix engine's widest width over a template of shared blocks."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.gpt2 import Gpt2Config
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import (
        parse_gather_buckets,
    )

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")       # plan for the H100's SMs
    cfg = Gpt2Config(**chip_smoke.SERVE_CONFIG)
    H, D = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    engines = [(8, chip_smoke.SERVE_MAX_LEN, 16)]          # (b), (e)
    for kw in (chip_smoke.PREFIX_ENGINE, chip_smoke.THRASH_ENGINE):
        engines.append((kw["num_slots"], kw["max_model_len"], kw["block_size"]))
    cases = {c[0]: c for c in chip_smoke.KERNEL_CASES}
    launched = set()
    for slots, max_len, bs in engines:
        for width in parse_gather_buckets("auto", max_len, bs):
            launched.add((slots, width))
            case = cases[chip_smoke.LADDER_CASES[(slots, width)]]
            assert case[1:10] == (slots, H, H, D, bs, width, "float32", False, None)
            assert chip_smoke.TABLE_BLOCKS[case[0]] == max_len // bs
            assert chip_smoke._plan(case) == pa.split_plan(slots, H, width, bs, pa.H100_SMS)
    # the serve_router phase's engines (every replica runs K3 over its ladder)
    for kw in (chip_smoke.ROUTER_ENGINE, chip_smoke.FLEET4_ENGINE):
        slots, max_len, bs = kw["num_slots"], kw["max_model_len"], kw["block_size"]
        for width in parse_gather_buckets(kw["gather_buckets"], max_len, bs):
            launched.add((slots, width))
            case = cases[chip_smoke.LADDER_CASES[(slots, width)]]
            assert case[1:10] == (slots, H, H, D, bs, width, "float32", False, None)
            assert chip_smoke.TABLE_BLOCKS[case[0]] >= max_len // bs
            assert chip_smoke._plan(case) == pa.split_plan(slots, H, width, bs, pa.H100_SMS)
    assert {(4, 128), (4, 256), (8, 128), (8, 256)} <= launched
    assert launched == set(chip_smoke.LADDER_CASES)
    prefix = chip_smoke.PREFIX_ENGINE
    for name, int8 in (("shared", False), ("shared_int8", True)):
        case = cases[name]
        assert case[1:9] == (prefix["num_slots"], H, H, D, prefix["block_size"],
                             prefix["max_model_len"], "float32", int8)
        assert case[10] == "shared" and chip_smoke.SHARED_PREFIX == chip_smoke.PREFIX_LEN


def test_kernel_phase_shared_blocks_on_cpu(on_cpu, monkeypatch):
    """The shared-block case at a tiny size: every slot's table starts with
    the same template blocks, its contexts cover the template and a tail,
    the kernel agrees with the plain version, and the bound reads the
    template's K/V once however many slots share it."""
    monkeypatch.setattr(pa, "H100_SMS", 4)
    monkeypatch.setattr(chip_smoke, "SHARED_PREFIX", 32)
    monkeypatch.setattr(chip_smoke, "TABLE_BLOCKS", {"shared": 8})
    case = ("shared", 4, 2, 2, 64, 16, 96, "float32", True, None, "shared")
    monkeypatch.setattr(chip_smoke, "KERNEL_CASES", [case])
    row = chip_smoke.kernel_phase()["shared"]
    assert row["status"] == "pass" and row["int8"] and row["width"] == 96
    assert all(32 < c <= 96 for c in row["contexts"])
    gen = torch.Generator().manual_seed(0)
    t, _ = chip_smoke._make_inputs(case, gen, "cpu")
    tables = t["block_tables"]
    assert tables.shape == (4, 8) and bool((tables[:, :2] == tables[0, :2]).all())
    assert len(set(tables[:, 2:].flatten().tolist())) == 4 * 6
    ctx = row["contexts"]
    unshared = ("shared", 4, 2, 2, 64, 16, 96, "float32", True, None, "ragged")
    assert (chip_smoke._work(unshared, ctx)[0] - chip_smoke._work(case, ctx)[0]
            == 3 * 32 * 2 * (2 * 64 + 8))
    assert chip_smoke._work(unshared, ctx)[1] == chip_smoke._work(case, ctx)[1]


def test_serve_router_phase_on_cpu(serve_on_cpu, monkeypatch, capsys):
    """The serve_router phase at a tiny width: (a) one engine against two
    replicas under each placement on a mixed trace and on a primed
    templated one, every fleet's tokens the one engine's; (b) a live drain
    of replica 1 mid-trace, its residents migrated and every trace stitched
    complete; (c) prefill/decode roles against mixed replicas on the
    virtual clock, every request migrated once, no decode step on the
    prefill replica; (d) the open loop replayed exactly, then the wall
    clock; per-replica K3 counts summing to the global one."""
    for name, value in (
            ("ROUTER_ENGINE", dict(num_slots=2, block_size=8, prefill_chunk=8,
                                   max_model_len=64, gather_buckets=[32, 64])),
            ("ROUTER_TRACE", dict(n_requests=8, prompt_lo=4, prompt_hi=8, short_new=(6, 10),
                                  long_new=(10, 16), long_every=4)),
            ("ROUTER_FAMILIES", (3, 3, 16)),
            ("ROUTER_BLOCKS", 1 + 2 * 6 + 2 * 5), ("ROUTER_PROFILED", (2, 6)),
            ("FLEET4_ENGINE", dict(num_slots=2, block_size=8, prefill_chunk=8,
                                   max_model_len=64, gather_buckets=[32, 64])),
            ("DISAGG", dict(n=8, prompt=(4, 16), new=(3, 6), rate=300.0, ttft_s=0.02)),
            ("OPEN_LOOP", dict(n=8, prompt=(4, 8), new=(3, 6), rates=(40.0, 100000.0),
                               wall_rates=(200.0,)))):
        monkeypatch.setattr(chip_smoke, name, value)
    _, model, _ = chip_smoke.serve_phase()
    capsys.readouterr()
    rows = chip_smoke.serve_router_phase(model, "cpu")
    assert list(rows) == ["single", "round_robin", "least_loaded", "affinity",
                          "templated_round_robin", "templated_affinity", "drain", "roles",
                          "open_loop", "summary"]
    for name in ("round_robin", "least_loaded", "affinity", "drain"):
        assert rows[name]["same_tokens_as_single"]["identical"] == 8, name
        assert set(rows[name]["k3_launches_by_replica"]) == {"0", "1"}
    assert rows["single"]["k3_launches_by_replica"].keys() == {"0"}
    for name in ("single", "round_robin", "affinity", "drain", "roles", "open_loop"):
        r = rows[name]
        assert sum(v["launches"] for v in r["k3_launches_by_replica"].values()) \
            == r["paged_kernel_launches"] > 0, name
        assert r["sync_free_calls"] > 0, name
    assert (rows["templated_affinity"]["cache_hit_rate"]
            >= rows["templated_round_robin"]["cache_hit_rate"] > 0)
    drain = rows["drain"]
    assert drain["drains"] == 1 and drain["residents_migrated"] > 0
    assert drain["stitched"]["complete_traces"] == drain["stitched"]["traces"] == 8
    roles = rows["roles"]
    assert roles["migrations"] == 8 and roles["prefill_decode_steps"] == 0
    assert roles["k3_launches_by_replica"]["0"]["launches"] == 0
    assert roles["same_tokens_as_mixed"]["identical"] == 8
    assert roles["stitched"]["traces"] == 8 and roles["stitched"]["hops_by_trace"] == [1]
    loop = rows["open_loop"]
    assert loop["virtual_replay_identical"] and loop["virtual"]["40.0"]["slo_attainment"] == 1.0
    assert loop["virtual"]["100000.0"]["dominant_miss_phase"] == "queue"
    assert set(loop["wall"]) == {"200.0"}
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert [p["run"] for p in printed] == list(rows)


def test_every_llama_phase_shape_is_held_against_its_plain_version(monkeypatch):
    """K3's, K1's and K2's launch configurations follow their shapes: every
    (slots, width, heads, K/V heads, D, dtype, int8, window) the llama
    phase's engines launch K3 at (each width of the Llama-3.1-8B run's
    ladder, fp and int8 pools; the Mistral run's full width, where its
    contexts past the window sit) is a kernel case, plan included, and so
    are TinyLlama's G 8 at D 64 and Qwen2's G 7; every (B, H, S, D, window)
    of the TinyLlama and Mixtral training steps is a flash case, and every
    (N, V, H) of their causal-LM loss a vocab case, forward and backward
    on the wgmma routes."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.llama import (
        llama_config_from_hf,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import (
        parse_gather_buckets,
    )

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")       # plan for the H100's SMs
    cases = {c[0]: c for c in chip_smoke.KERNEL_CASES}
    held = set()
    llama = llama_config_from_hf(chip_smoke.LLAMA_31_8B)
    eng = chip_smoke.LLAMA_ENGINE
    slots, max_len, bs = eng["num_slots"], eng["max_model_len"], eng["block_size"]
    tr = chip_smoke.LLAMA_TRACE
    assert tr["hi"] + tr["new"] <= max_len
    for width in parse_gather_buckets(None, max_len, bs):
        for int8 in (False, True):
            name = chip_smoke.LLAMA_LADDER_CASES[(slots, width, int8)]
            case = cases[name]
            assert case[1:10] == (slots, llama.num_heads, llama.num_kv_heads,
                                  llama.resolved_head_dim, bs, width, "bfloat16", int8, None)
            assert chip_smoke.TABLE_BLOCKS[name] == max_len // bs
            assert chip_smoke._plan(case) == pa.split_plan(
                slots, llama.num_kv_heads, width, bs, pa.H100_SMS)
            held.add(name)
    mistral = llama_config_from_hf(chip_smoke.MISTRAL_7B)
    eng = chip_smoke.MISTRAL_ENGINE
    widths = parse_gather_buckets(None, eng["max_model_len"], eng["block_size"])
    # the one request decodes past the ladder's lower width: only the full one walks
    assert chip_smoke.MISTRAL_PROMPT > widths[0] and widths[-1] == eng["max_model_len"]
    assert chip_smoke.MISTRAL_PROMPT + chip_smoke.MISTRAL_NEW <= eng["max_model_len"]
    case = cases["mistral_window"]
    assert case[1:10] == (eng["num_slots"], mistral.num_heads, mistral.num_kv_heads,
                          mistral.resolved_head_dim, eng["block_size"], eng["max_model_len"],
                          "bfloat16", False, mistral.sliding_window)
    assert chip_smoke.TABLE_BLOCKS["mistral_window"] == eng["max_model_len"] // eng["block_size"]
    ctx = chip_smoke.LISTED_CONTEXTS["mistral_window"]
    assert min(ctx) < mistral.sliding_window < max(ctx) <= eng["max_model_len"]
    tiny = llama_config_from_hf(chip_smoke.TINYLLAMA)
    assert cases["tinyllama"][2:5] == (tiny.num_heads, tiny.num_kv_heads, tiny.resolved_head_dim)
    assert cases["qwen2_g7"][2] // cases["qwen2_g7"][3] == 7
    assert set(chip_smoke.LLAMA_KERNEL_CASES) == held | {"mistral_window", "tinyllama",
                                                         "qwen2_g7"}
    flash = {c[0]: c for c in chip_smoke.FLASH_CASES}
    mixtral = llama_config_from_hf(chip_smoke.MIXTRAL_8X7B)
    run, mrun = chip_smoke.TINYLLAMA_RUN, chip_smoke.MIXTRAL_RUN
    for name, cfg, B, S, window in (
            ("tinyllama_causal_bf16", tiny, run["batch"], run["seq"], None),
            ("mixtral_causal_bf16", mixtral, mrun["batch"], mrun["seq"], None),
            ("mistral_window_bf16", mistral, 1, 6144, mistral.sliding_window)):
        assert flash[name][1:9] == (B, cfg.num_heads, S, cfg.resolved_head_dim, "bfloat16",
                                    False, True, window)
    assert 6144 > mistral.sliding_window            # the band bites
    assert set(chip_smoke.FLASH_LLAMA) <= set(flash)
    vocab = {c[0]: c for c in chip_smoke.VOCAB_CASES}
    for name, cfg, N in (("tinyllama_ce", tiny, run["batch"] * run["seq"]),
                         ("mixtral_ce", mixtral, mrun["batch"] * mrun["seq"])):
        assert vocab[name][1:5] == (N, cfg.vocab_size, cfg.hidden_size, "bfloat16")
        for k in ("fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_dw"):
            assert "_wgmma_" in chip_smoke.vocab_kernel_names(k, "bfloat16")[0]
    # Llama-3's vocab at Mixtral's N and width: a multi-chunk walk at a real V
    llama3 = llama_config_from_hf(chip_smoke.LLAMA_31_8B)
    assert vocab["llama3_vocab_ce"][1:5] == (mrun["batch"] * mrun["seq"], llama3.vocab_size,
                                             llama3.hidden_size, "bfloat16")
    assert set(chip_smoke.VOCAB_LLAMA) == {"tinyllama_ce", "mixtral_ce", "llama3_vocab_ce"}
    # Gemma at head_dim 256: each width of the Gemma-7B serve run's ladder,
    # fp and int8 pools, plan included; Gemma-2B's MQA group of 8 (and both
    # group widths over fp32 pools); the Gemma-2B run's and fp32 gate's K1
    # shapes (the one K/V head repeated to the query heads) and its K2
    # shape with the tied head at vocab 256000
    gemma7 = llama_config_from_hf(chip_smoke.GEMMA_7B)
    gemma2 = llama_config_from_hf(chip_smoke.GEMMA_2B)
    assert gemma7.resolved_head_dim == gemma2.resolved_head_dim == 256
    assert gemma7.tie_word_embeddings and gemma2.tie_word_embeddings
    eng = chip_smoke.LLAMA_ENGINE
    slots, max_len, bs = eng["num_slots"], eng["max_model_len"], eng["block_size"]
    g = chip_smoke.GEMMA_TRACE
    assert g["hi"] + g["new"] <= max_len
    gemma_held = set()
    for width in parse_gather_buckets(None, max_len, bs):
        for int8 in (False, True):
            name = chip_smoke.GEMMA_LADDER_CASES[(slots, width, int8)]
            case = cases[name]
            assert case[1:10] == (slots, gemma7.num_heads, gemma7.num_kv_heads, 256, bs, width,
                                  "bfloat16", int8, None)
            assert chip_smoke.TABLE_BLOCKS[name] == max_len // bs
            chunk, chunks = chip_smoke._plan(case)
            assert (chunk, chunks) == pa.split_plan(slots, gemma7.num_kv_heads, width, bs,
                                                    pa.H100_SMS)
            assert chunk * chunks >= width and chunk % pa.TILE == 0
            gemma_held.add(name)
    assert cases["gemma2b_mqa"][2:5] == (gemma2.num_heads, gemma2.num_kv_heads, 256)
    assert gemma2.num_heads // gemma2.num_kv_heads == pa.MAX_GROUP
    for name, G in (("gemma7b_fp32", 1), ("gemma2b_mqa_fp32", 8)):
        assert cases[name][4] == 256 and cases[name][7] == "float32"
        assert cases[name][2] // cases[name][3] == G
    assert set(chip_smoke.GEMMA_KERNEL_CASES) == gemma_held | {
        "gemma2b_mqa", "gemma7b_fp32", "gemma2b_mqa_fp32"}
    grun, gate = chip_smoke.GEMMA_RUN, chip_smoke.LLAMA_GATE
    for name, B, S, dt in (("gemma2b_causal_bf16", grun["batch"], grun["seq"], "bfloat16"),
                           ("gemma2b_gate_fp32", gate["batch"], gate["seq"], "float32")):
        assert flash[name][1:9] == (B, gemma2.num_heads, S, 256, dt, False, True, None)
    assert flash["pad96_bf16"][4] == 96 and fa.kernel_head_dim(96) == 128
    assert set(chip_smoke.FLASH_GEMMA) == {"gemma2b_causal_bf16", "gemma2b_gate_fp32",
                                           "pad96_bf16"}
    assert vocab["gemma_vocab_ce"][1:5] == (grun["batch"] * grun["seq"], gemma2.vocab_size,
                                            gemma2.hidden_size, "bfloat16")
    assert set(chip_smoke.VOCAB_GEMMA) == {"gemma_vocab_ce"}


LLAMA_TINY = dict(vocab_size=300, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
                  eos_token_id=299)
GEMMA_TINY = dict(num_attention_heads=2, num_key_value_heads=2, head_dim=256, pad_token_id=0)


def test_llama_phase_on_cpu(on_cpu, monkeypatch, tmp_path, capsys):
    """The llama phase at a tiny width: (a) the serve runs on fp pools, int8
    pools and the gather route against the batched plain decode and each
    other, K3 counted a layer a decode step where the model calls it;
    (b) the window run, every K3 call with the window; (c) the TinyLlama
    CLI run's K1/K2 counts and the fp32 gate; (d) the Mixtral steps with
    the aux loss, the routing counts, its gate and greedy decode."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import llama as t_llama

    real = t_llama.paged_attention

    def counted(*args, **kw):
        pa.paged_decode_attention.launches += 1
        return real(*args, **kw)

    monkeypatch.setattr(t_llama, "paged_attention", counted)
    run = cli.run
    monkeypatch.setattr(cli, "run", lambda argv: run(argv + ["--attention_impl", "flash"]))
    scaling = dict(chip_smoke.LLAMA_31_8B["rope_scaling"], original_max_position_embeddings=16)
    for name, value in (
            ("LLAMA_31_8B", dict(chip_smoke.LLAMA_31_8B, **LLAMA_TINY, rope_scaling=scaling)),
            ("MISTRAL_7B", dict(chip_smoke.MISTRAL_7B, **LLAMA_TINY, sliding_window=16)),
            ("TINYLLAMA", dict(chip_smoke.TINYLLAMA, **{**LLAMA_TINY, "vocab_size": 600})),
            ("MIXTRAL_8X7B", dict(chip_smoke.MIXTRAL_8X7B, **{**LLAMA_TINY,
                                                               "num_hidden_layers": 1},
                                  num_local_experts=4)),
            ("LLAMA_ENGINE", dict(num_slots=2, block_size=8, prefill_chunk=8,
                                  max_model_len=128)),
            ("LLAMA_TRACE", dict(n=4, lo=8, hi=40, new=6)), ("OVERLAP_PROFILED", (2, 6)),
            ("MISTRAL_ENGINE", dict(num_slots=2, block_size=8, prefill_chunk=8,
                                    max_model_len=64)),
            ("MISTRAL_PROMPT", 40), ("MISTRAL_NEW", 6),
            ("TINYLLAMA_RUN", dict(batch=2, seq=64, steps=3, eval_samples=8,
                                   train_samples=64, profiled=2)),
            ("LLAMA_GATE", dict(depth=1, batch=2, seq=32, steps=2, lr=1e-5)),
            ("MIXTRAL_RUN", dict(batch=2, seq=32, steps=2)),
            ("MIXTRAL_GATE", dict(batch=1, seq=32)),
            ("MIXTRAL_DECODE", dict(prompt=8, new=4, capacity_factor=2.0)),
            # Gemma at head_dim 256 (the width the port's kernels now take),
            # narrow hidden widths
            ("GEMMA_7B", dict(chip_smoke.GEMMA_7B, **{**LLAMA_TINY, **GEMMA_TINY})),
            ("GEMMA_2B", dict(chip_smoke.GEMMA_2B, **{**LLAMA_TINY, **GEMMA_TINY,
                                                      "vocab_size": 600,
                                                      "num_key_value_heads": 1})),
            ("GEMMA_TRACE", dict(n=3, lo=8, hi=30, new=5)),
            ("GEMMA_RUN", dict(batch=2, seq=64, steps=2, eval_samples=8, train_samples=64,
                               profiled=2))):
        monkeypatch.setattr(chip_smoke, name, value)
    rows = chip_smoke.llama_phase(tmp_path, "cpu")
    assert list(rows) == ["llama3_8b_fp", "llama3_8b_int8", "llama3_8b_xla", "mistral_window",
                          "tinyllama", "mixtral", "gemma7b_fp", "gemma7b_int8", "gemma2b"]
    for name in ("llama3_8b_fp", "llama3_8b_int8", "mistral_window", "gemma7b_fp",
                 "gemma7b_int8"):
        r = rows[name]
        assert r["paged_kernel_launches"] == r["decode_steps"] * 2 > 0, name
        assert r["tokens_compared_with_plain"] > 0, name
    assert rows["gemma7b_fp"]["head_dim"] == 256
    assert rows["gemma7b_fp"]["kv_bytes_per_token"] == 2 * 2 * 2 * 256 * 2
    assert "idle_share" in rows["gemma7b_fp"]
    assert rows["llama3_8b_xla"]["paged_kernel_launches"] == 0
    assert rows["llama3_8b_xla"]["same_tokens_as_k3"]["identical"] + \
        rows["llama3_8b_xla"]["same_tokens_as_k3"]["near_tie_splits"] == 4
    assert rows["llama3_8b_int8"]["kv_bytes_per_token"] == 2 * 2 * 2 * (16 + 4)
    assert rows["llama3_8b_fp"]["kv_bytes_per_token"] == 2 * 2 * 2 * 16 * 2
    assert rows["mistral_window"]["k3_window_calls"] == rows["mistral_window"][
        "paged_kernel_launches"]
    assert set(rows["mistral_window"]["k3_launches_by_width"]) == {"64"}
    tl = rows["tinyllama"]
    steps, ev = tl["train_steps"], tl["eval_steps"]
    assert steps == 3 and ev >= 1
    assert tl["launches"] == {"flash_fwd": 2 * (steps + ev), "flash_bwd_dq": 2 * steps,
                              "flash_bwd_dkv": 2 * steps, "fused_ce_fwd": steps + ev,
                              "fused_ce_bwd_dh": steps, "fused_ce_bwd_dw": steps}
    gm = rows["gemma2b"]
    assert gm["head_dim"] == 256 and gm["train_steps"] == 2 and gm["eval_steps"] >= 1
    assert gm["launches"] == {
        "flash_fwd": 2 * (2 + gm["eval_steps"]), "flash_bwd_dq": 2 * 2, "flash_bwd_dkv": 2 * 2,
        "fused_ce_fwd": 2 + gm["eval_steps"], "fused_ce_bwd_dh": 2, "fused_ce_bwd_dw": 2}
    for run in ("tinyllama", "mixtral", "gemma2b"):
        gate = rows[run]["gate"]
        assert gate["loss_rel_err"] <= 1e-5 and gate["grad_rel_l2_max"] <= 1e-3
        assert len(gate["curve_kernels"]) == 2
    mx = rows["mixtral"]
    assert mx["launches"] == {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
                              "fused_ce_fwd": 2, "fused_ce_bwd_dh": 2, "fused_ce_bwd_dw": 2}
    assert sum(mx["tokens_per_expert"]) + mx["capacity_drops"] == mx["assignments"] == 2 * 2 * 32
    assert mx["decode"]["compared_with_full_forward"] > 0
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert printed[-1]["phase"] == "llama_summary"
    assert set(printed[-1]["wall_seconds"]) == {"serve", "window", "train", "moe",
                                                "gemma_serve", "gemma_train"}


def test_launch_phase_on_cpu(on_cpu, monkeypatch, tmp_path, capsys):
    """The launch phase at hidden 64, 2 layers, 3 steps: ``python -m
    <port>.launch`` on the CPU slice (``cpu-1``) as a real child process,
    the job directory's files, the results keys, the child's telemetry
    counts (0 on the CPU: the plain versions run), the reloaded export,
    and the single-node entry's unscaled learning rate."""
    monkeypatch.setattr(chip_smoke, "LAUNCH_STEPS", 3)
    monkeypatch.setattr(chip_smoke, "LAUNCH_EVAL_SAMPLES", 8)
    rows = chip_smoke.launch_phase(tmp_path, "cpu rehearsal")
    a, b = rows["bert_large_wwm"], rows["single_node"]
    assert a["slice"] == "cpu-1" and a["layers"] == 2 and a["eval_steps"] == 2
    assert a["job_files"] == ["host_0.log", "model", "output"]
    assert a["launches"] == {k: 0 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                            "fused_ce_fwd", "fused_ce_bwd_dh",
                                            "fused_ce_bwd_dw")}
    assert a["samples_per_sec"] > 0 and math.isfinite(a["eval_loss"]) and a["job_wall_s"] > 0
    assert b["scale_lr_by_world_size"] is False
    printed = [p["phase"] for p in _printed(capsys) if "phase" in p]
    assert printed == ["launch", "launch_single_node"]


def test_optim_memory_phase_on_cpu(on_cpu, monkeypatch, capsys):
    """The optimizer and remat phase at hidden 64, 2 layers, 3 steps a run:
    six runs from the same weights, the bf16 moments at half the fp32
    moments' bytes, LAMB's state as AdamW's, the flash forward twice a
    layer a step under every remat policy (counted on the CPU by the
    fixture), every first-step loss equal, and the summary."""
    monkeypatch.setattr(chip_smoke, "OPTIM_TIMED_STEPS", 1)
    monkeypatch.setattr(chip_smoke, "OPTIM_PROFILED_STEPS", 1)
    rows = chip_smoke.optim_memory_phase()
    assert list(rows) == [r[0] for r in chip_smoke.OPTIM_RUNS]
    fp32, bf16, lamb = rows["adamw_fp32"], rows["adamw_bf16_moments"], rows["lamb"]
    assert bf16["moment_bytes"] * 2 == fp32["moment_bytes"] == lamb["moment_bytes"]
    assert bf16["moment_dtype"] == "torch.bfloat16" and lamb["moment_dtype"] == "torch.float32"
    assert len({r["first_step_loss"] for r in rows.values()}) == 1
    for name, r in rows.items():
        assert r["k1_launches_per_step"]["flash_fwd"] == 2 * (2 if r["remat_policy"] else 1)
        assert r["peak_gib"] == "not measured" and r["step_ms"] > 0
    summary = [p for p in _printed(capsys) if p.get("phase") == "optim_memory_summary"]
    assert len(summary) == 1 and summary[0]["first_step_losses_bitwise_equal"]


def test_optim_parity_and_resume_phases_on_cpu(on_cpu, tmp_path, capsys):
    """The card-against-CPU optimizer steps (here CPU against CPU: equal),
    the fp32 step under each remat policy against the plain step, and the
    bitwise resume of LAMB and bf16-moment AdamW through the
    ``Checkpointer``, at hidden 64 and 2 layers."""
    rows = chip_smoke.optim_parity_phase()
    assert rows["lamb"]["param_rel_err_max"] == 0.0
    assert rows["adamw_bf16_moments"]["moment_dtypes"] == ["torch.bfloat16"]
    assert [k for k in rows if k.startswith("remat_")] == [
        "remat_full", "remat_dots", "remat_dots_no_batch"]
    assert all(rows[k]["loss_rel_err"] == 0.0 for k in rows if k.startswith("remat_"))
    resumed = chip_smoke.optim_resume_phase(tmp_path)
    for name, row in resumed.items():
        assert row["losses_bitwise"] and row["moments_bitwise"] and not row["params_differing"]
        assert row["resumed_at"] == chip_smoke.RESUME_STEPS // 2
    assert resumed["adamw_bf16_moments"]["moment_dtypes"] == ["torch.bfloat16"]
    phases = [p["phase"] for p in _printed(capsys) if "phase" in p]
    assert phases.count("optim_parity") == 5 and phases.count("optim_resume") == 2


def test_obs_phase_on_cpu(serve_on_cpu, monkeypatch, tmp_path, capsys):
    """The obs phase's checks (a)-(e) over telemetry made on the CPU at a
    tiny width: a 3-step training CLI run, an engine run with timelines, a
    two-replica run drained mid-trace and two wall-clock open-loop runs
    over two replicas; the compile-budget run in this process, with the K1
    library's load (which the CPU never makes) reported at its first
    step."""
    import numpy as np

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
        init_gpt2,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.gpt2 import Gpt2Config
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.watchdog import (
        report_compile,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import ServeEngine
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.loadgen import (
        SloSpec,
        make_schedule,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.router import Router
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(chip_smoke, "CLI_STEPS", 3)
    monkeypatch.setattr(chip_smoke, "CLI_EVAL_SAMPLES", 8)

    def sink(name):
        obs.reset(out_dir=str(tmp_path / name), enabled=True)
        return tmp_path / name

    job = sink("job")
    try:
        chip_smoke._counted_run(chip_smoke._train_argv(tmp_path / "cli", tmp_path / "out",
                                                       tmp_path / "model"))
    finally:
        obs.reset()
    model = init_gpt2(Gpt2Config(hidden_dropout=0.0, embd_dropout=0.0, attention_dropout=0.0,
                                 **SERVE_TINY), seed=0, device="cpu")
    rng = np.random.RandomState(0)
    trace = [(rng.randint(1, 290, (int(rng.randint(4, 12)),)).astype(np.int32),
              int(rng.randint(3, 8))) for _ in range(8)]
    kw = dict(num_slots=2, block_size=8, prefill_chunk=8, max_model_len=64)
    engine_tel = sink("engine")
    try:
        eng = ServeEngine(model, device="cpu", **kw)
        for p, m in trace:
            eng.submit(p, m)
        eng.run()
        drain_tel = sink("drain")
        router = Router(model, replicas=2, device="cpu", **kw)
        for p, m in trace:
            router.submit(p, m)
        router.warmup()
        for _ in range(3):
            router.step()
        router.drain(1)
        router.run()
    finally:
        obs.reset()
    open_loop = {}
    for rate in (50.0, 400.0):
        schedule = make_schedule(8, 290, process="poisson", rate=rate, seed=11, prompt_lo=4,
                                 prompt_hi=8, new_lo=3, new_hi=6, eos_token_id=299,
                                 groups=("interactive", "batch"))
        tel = sink(f"wall_{rate:g}")
        try:
            run = chip_smoke._open_loop_run(Router(model, replicas=2, device="cpu", **kw),
                                            schedule, "wall", SloSpec(ttft_s=0.5, tpot_s=0.25),
                                            rate)
        finally:
            obs.reset()
        open_loop[str(rate)] = dict(run["summary"], telemetry=str(tel))

    real_step, loaded = Trainer.train_step, []

    def step(self, batch):
        if not loaded:
            loaded.append(True)
            report_compile("/hstd/compile/load/flash_attention", 1e-3)
        return real_step(self, batch)

    monkeypatch.setattr(Trainer, "train_step", step)
    capsys.readouterr()
    rows = chip_smoke.obs_phase(tmp_path / "obs", "cpu", job, engine_tel,
                                {"telemetry": str(drain_tel), "requests": len(trace)}, open_loop)
    assert list(rows) == ["report", "goodput", "timelines", "fleet", "budget", "summary"]
    assert rows["report"]["host"]["step_time_s"]["count"] > 0
    assert rows["goodput"]["runs"] == 2
    assert rows["timelines"]["requests"] == len(trace)
    assert rows["fleet"]["traces"] == rows["fleet"]["complete_traces"] == len(trace)
    assert rows["fleet"]["most_hops"] >= 1
    budget = rows["budget"]
    assert budget["compiles"] == ["/hstd/compile/load/flash_attention"]
    assert len(budget["widths"]) == chip_smoke.BUDGET_STEPS
    assert all(w % chip_smoke.DATA_BUCKET == 0 for w in budget["widths"])
    # the lengths climb in the one sorted window: every batch cut under the
    # cap that would have minted a new width takes the full width instead
    assert budget["widths"][-1] == chip_smoke.BERT_BASE["max_position_embeddings"]
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert [p["run"] for p in printed if p.get("phase") == "obs"] == [
        r["run"] for r in rows.values()]


# -- time limits ----------------------------------------------------------------

def _calls(tree):
    import ast

    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)]


def test_every_subprocess_call_and_wait_has_a_time_limit():
    """Each ``subprocess.run`` (and ``check_output``/``call``), ``wait`` and
    ``communicate`` in ``chip_smoke.py`` passes a timeout: a child that
    hangs fails the run within its limit instead of using it up."""
    import ast

    tree = ast.parse(Path(chip_smoke.__file__).read_text())
    checked = 0
    for call in _calls(tree):
        f = call.func
        if not isinstance(f, ast.Attribute):
            continue
        is_run = (f.attr in ("run", "check_output", "call", "check_call")
                  and isinstance(f.value, ast.Name) and f.value.id == "subprocess")
        if is_run or f.attr in ("wait", "communicate"):
            keywords = {k.arg for k in call.keywords}
            positional = f.attr in ("wait", "communicate") and call.args
            assert "timeout" in keywords or positional, \
                f"chip_smoke.py:{call.lineno}: {f.attr}(...) without a timeout"
            checked += 1
    assert checked >= 6


def test_mesh_train_phase_runs_in_its_own_process_within_two_minutes():
    assert chip_smoke.FRESH_PROCESS_PHASES["mesh_train_phase"] is chip_smoke.mesh_train_phase
    assert chip_smoke.FRESH_PROCESS_TIMEOUTS_S["mesh_train_phase"] <= 120
    assert chip_smoke.MESH_GROUP_TIMEOUT_S <= 120


def test_every_phase_limit_is_a_named_constant_beside_its_phase():
    """Each fresh-process phase's limit is ``<PHASE>_TIMEOUT_S``, defined
    within a few lines of the phase's ``def``, under 600 s (the one limit
    they all once shared); so is the launched job's limit."""
    import ast

    source = Path(chip_smoke.__file__).read_text()
    tree = ast.parse(source)
    assigned = {t.id: node.lineno for node in tree.body if isinstance(node, ast.Assign)
                for t in node.targets if isinstance(t, ast.Name)}
    defined = {node.name: node.lineno for node in tree.body
               if isinstance(node, ast.FunctionDef)}
    assert "FRESH_PROCESS_TIMEOUT_S" not in assigned
    assert set(chip_smoke.FRESH_PROCESS_TIMEOUTS_S) == set(chip_smoke.FRESH_PROCESS_PHASES)
    for phase, limit in chip_smoke.FRESH_PROCESS_TIMEOUTS_S.items():
        const = f"{phase.upper()}_TIMEOUT_S"
        assert getattr(chip_smoke, const) == limit, phase
        assert abs(assigned[const] - defined[phase]) <= 40, (const, phase)
        assert 60 <= limit < 600, (phase, limit)
    assert chip_smoke.LAUNCH_TIMEOUT_S < 600
    assert abs(assigned["LAUNCH_TIMEOUT_S"] - defined["_start_launch"]) <= 40


def test_a_fresh_process_past_its_limit_fails_the_run(monkeypatch):
    """Running past the limit kills the child and fails, naming the phase
    (it is never skipped)."""
    import subprocess

    def hang(*args, timeout=None, **kw):
        raise subprocess.TimeoutExpired(args[0], timeout)

    monkeypatch.setattr(chip_smoke.subprocess, "run", hang)
    with pytest.raises(RuntimeError, match="mesh_train_phase .* past its limit of 120 s"):
        chip_smoke._fresh_process("mesh_train_phase")


def test_mesh_train_phase_on_cpu(on_cpu, monkeypatch, capsys):
    """The mesh phase at a tiny width: a gloo world of one, a (1, 1, 1)
    mesh, shard_model's trainer with and without the tensor-parallel plan
    against the plain one (fp32 losses and gradients, launches a step),
    then bf16 steps of the three; the process group is gone after it."""
    import torch.distributed as dist

    monkeypatch.setattr(chip_smoke, "TINYLLAMA", dict(
        chip_smoke.TINYLLAMA, vocab_size=300, hidden_size=64, intermediate_size=128,
        num_attention_heads=4, num_key_value_heads=2))
    monkeypatch.setattr(chip_smoke, "MESH_SEQ", 64)
    rows = chip_smoke.mesh_train_phase()
    assert not dist.is_initialized()
    fp32 = rows["fp32"]
    depth = chip_smoke.MESH_DEPTH
    assert fp32["launches_per_step"] == {"flash_fwd": depth, "flash_bwd_dq": depth,
                                         "flash_bwd_dkv": depth, "fused_ce_fwd": 1,
                                         "fused_ce_bwd_dh": 1, "fused_ce_bwd_dw": 1}
    for name in ("fsdp", "mesh"):
        assert max(fp32[f"loss_rel_err_{name}"]) <= chip_smoke.MESH_LOSS_RTOL
        assert fp32[f"grad_rel_l2_{name}"] <= chip_smoke.MESH_GRAD_REL_L2
        assert len(fp32[f"loss_{name}"]) == chip_smoke.MESH_FP32_STEPS
    assert fp32["head_weight_aligned"]
    for name in ("plain", "fsdp", "mesh"):
        assert all(math.isfinite(x) for x in rows["bf16"][name]["loss"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert [r["run"] for r in printed if r.get("phase") == "mesh_train"] == ["fp32", "bf16"]


def test_tp_serve_phase_runs_in_its_own_process_within_its_limit():
    assert chip_smoke.FRESH_PROCESS_PHASES["tp_serve_phase"] is chip_smoke.tp_serve_phase
    assert chip_smoke.FRESH_PROCESS_TIMEOUTS_S["tp_serve_phase"] <= 150
    # a hung rank fails the phase (its followers' wait) well inside the limit
    assert chip_smoke.TP_GROUP_TIMEOUT_S + 15 < chip_smoke.TP_SERVE_PHASE_TIMEOUT_S
    assert chip_smoke.TP_ENGINE["kernel"] == "xla"


def _tp_tiny(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "LLAMA_31_8B", dict(
        chip_smoke.LLAMA_31_8B, vocab_size=300, hidden_size=64, intermediate_size=128,
        num_attention_heads=4, num_key_value_heads=2))
    monkeypatch.setattr(chip_smoke, "TP_DEPTH", 2)
    monkeypatch.setattr(chip_smoke, "TP_ENGINE", dict(chip_smoke.TP_ENGINE, max_model_len=64,
                                                      gather_buckets=[32, 64]))
    monkeypatch.setattr(chip_smoke, "TP_FP32_TRACE", dict(n=3, lo=8, hi=20, new=6))
    monkeypatch.setattr(chip_smoke, "TP_BF16_TRACE", dict(n=6, lo=8, hi=20, new=8))
    # 256 bytes a token in bf16 at this width: 16 blocks at tp 1, 32 at tp 2
    monkeypatch.setattr(chip_smoke, "TP_KV_POOL_BYTES", 16 * 16 * 256)
    monkeypatch.setattr(chip_smoke, "OVERLAP_PROFILED", (2, 4))


def test_tp_serve_phase_on_cpu(monkeypatch, capsys):
    """The tp_serve phase at a tiny width: two spawned ranks in a gloo world
    on the CPU, the fp32 tokens and teacher-forced logits of the two-rank
    engine against the one-rank engine's, then the bf16 runs at one KV
    budget (about twice the blocks at tp 2); rank 1 followed every run."""
    _tp_tiny(monkeypatch)
    rows = chip_smoke.tp_serve_phase()
    fp32, tp1, tp2 = rows["fp32"], rows["bf16_tp1"], rows["bf16_tp2"]
    assert fp32["requests_equal"] + fp32["requests_split_at_a_tie"] == fp32["requests"] == 3
    assert fp32["logit_max_abs_err"] <= fp32["logit_tol"]
    assert fp32["kernel"] == "xla" and fp32["tp"] == 2 and fp32["rank1"]["ops_followed"] > 0
    assert tp1["tp"] == 1 and tp2["tp"] == 2
    assert tp1["num_blocks"] == 17 and tp2["num_blocks"] == 33
    assert tp2["blocks_over_tp1"] >= chip_smoke.TP_CAPACITY_RATIO
    assert tp2["kv_bytes_per_token"] * 2 == tp1["kv_bytes_per_token"]
    for row in (tp1, tp2):      # one budget a device: within a block of it
        block = 16 * row["kv_bytes_per_token"]
        assert row["kv_pool_bytes"] < row["kv_pool_bytes_per_device"] <= \
            row["kv_pool_bytes"] + block
    assert tp2["rank1"]["ops_followed"] > 0 and tp2["rank1"]["peak_gib"] == "not measured"
    host = tp2["host"]
    # the same trace and schedule on either engine (neither preempts)
    assert host["iterations"] == tp1["host"]["iterations"]
    # two row-parallel layers a block: every forward all-reduces 2 x depth times
    assert host["row_all_reduces"] % (2 * chip_smoke.TP_DEPTH) == 0
    assert host["row_all_reduces"] >= 2 * chip_smoke.TP_DEPTH * host["iterations"] > 0
    assert host["descriptors"] >= host["iterations"]
    for row in (tp1, tp2):
        assert {"tokens_per_sec", "idle_share", "peak_gib", "kv_pool_bytes_per_device",
                "window_iterations"} <= set(row)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [r["run"] for r in lines if r.get("phase") == "tp_serve"] == [
        "fp32", "bf16_tp1", "bf16_tp2"]


def test_tp_serve_follower_ends_when_the_leaders_group_times_out(monkeypatch):
    """A leader that sends nothing: the follower's wait ends at the group's
    timeout, the rank fails and so does the phase, long before its limit."""
    import time

    _tp_tiny(monkeypatch)
    task = dict(chip_smoke._tp_task(), leader_hangs=True, group_timeout_s=3)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=r"ranks exited with \[0, 1\]"):
        chip_smoke._spawned_world(chip_smoke._tp_rank, task, chip_smoke.TP_RANKS, 60,
                                  "tp_serve")
    assert time.perf_counter() - t0 < 45


# -- the ring_train phase ---------------------------------------------------------------

def test_ring_train_phase_runs_in_its_own_process_within_its_limit():
    assert chip_smoke.FRESH_PROCESS_PHASES["ring_train_phase"] is chip_smoke.ring_train_phase
    assert chip_smoke.FRESH_PROCESS_TIMEOUTS_S["ring_train_phase"] == \
        chip_smoke.RING_TRAIN_PHASE_TIMEOUT_S == 150
    # a hung rank fails the phase at its group's timeout, well inside the limit
    assert chip_smoke.RING_GROUP_TIMEOUT_S + 15 < chip_smoke.RING_TRAIN_PHASE_TIMEOUT_S


def test_ring_train_ranks_set_timeouts_and_turn_tf32_off():
    """Each rank turns TF32 off before any work, and its process group and
    every mesh group carry the phase's timeout."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(chip_smoke._ring_rank))
    calls = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = getattr(node.func, "attr", getattr(node.func, "id", None))
            calls.setdefault(name, []).append({k.arg for k in node.keywords})
    assert "_no_tf32" in calls
    assert all("timeout" in kw for kw in calls["init_process_group"])
    assert all("timeout" in kw for kw in calls["build_mesh"])
    assert chip_smoke._ring_task()["group_timeout_s"] == chip_smoke.RING_GROUP_TIMEOUT_S


def _ring_shape(name, spec):
    """(S / sp, query heads, K/V heads, head width) of a ring_train model."""
    hf = getattr(chip_smoke, spec["hf"])
    if name == "t5_small":
        heads, kv, d = hf["num_heads"], hf["num_heads"], hf["d_kv"]
    else:
        heads = hf["num_attention_heads"]
        kv = hf.get("num_key_value_heads", heads)
        d = hf["hidden_size"] // heads
    return spec["seq"] // chip_smoke.RING_RANKS, heads, kv, d


def test_every_ring_shape_has_a_cpu_case():
    """Each ring the card's ring_train phase runs (its block of the
    sequence, heads, K/V heads and head width) is a case of
    ``tests/test_torch_ring_attention.py`` over the same ``sp``, at the
    same shape."""
    import test_torch_ring_attention as ring_tests

    assert set(ring_tests.CHIP_SHAPES) == set(chip_smoke.RING_MODELS)
    assert ring_tests.TRAIN_SHAPE[2] == chip_smoke.RING_RANKS
    for name, spec in chip_smoke.RING_MODELS.items():
        case = ring_tests.CHIP_SHAPES[name]
        assert (case["s"] // ring_tests.TRAIN_SHAPE[2], case["h"], case["kv"], case["d"]) == \
            _ring_shape(name, spec), name
        assert case.get("causal", False) == (name == "tinyllama"), name


def test_ring_train_phase_on_cpu(monkeypatch, capsys):
    """The ring_train phase at a tiny width: two spawned ranks in a gloo
    world on the CPU over sp 2; each model's fp32 losses and first-update
    gradients against the plain one-process trainer's, then the bf16 runs
    (sp 1 plain and flash on rank 0, sp 2 on both, ring shifts counted)."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    tiny = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=128)
    monkeypatch.setattr(chip_smoke, "BERT_LARGE", dict(chip_smoke.BERT_LARGE, **tiny,
                                                       vocab_size=300))
    monkeypatch.setattr(chip_smoke, "TINYLLAMA", dict(chip_smoke.TINYLLAMA, **tiny,
                                                      vocab_size=300, num_key_value_heads=2))
    monkeypatch.setattr(chip_smoke, "T5_SMALL", dict(chip_smoke.T5_SMALL, vocab_size=300,
                                                     d_model=64, d_kv=16, d_ff=128,
                                                     num_heads=4))
    monkeypatch.setattr(chip_smoke, "RING_MODELS", {
        "bert_large_wwm": dict(hf="BERT_LARGE", depth=2, rows=4, seq=32),
        "tinyllama": dict(hf="TINYLLAMA", depth=2, rows=1, seq=64),
        "t5_small": dict(hf="T5_SMALL", depth=2, rows=4, seq=32, target=8)})
    monkeypatch.setattr(chip_smoke, "RING_ROW_LENGTHS", (32, 27, 19, 6))
    monkeypatch.setattr(chip_smoke, "RING_BF16_STEPS", 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)         # the one-process references run here
    try:
        rows = chip_smoke.ring_train_phase()
    finally:
        torch.set_num_threads(threads)
    for name in chip_smoke.RING_MODELS:
        row = rows[f"{name}_fp32"]
        assert max(row["loss_rel_err"]) <= chip_smoke.RING_LOSS_RTOL, name
        assert row["grad_rel_l2"] <= row["grad_rel_l2_tol"], name
        assert row["grad_rel_l2_tol"] >= chip_smoke.RING_GRAD_REL_L2, name
        assert len(row["loss_sp2"]) == chip_smoke.RING_FP32_STEPS
        assert row["rank1"]["launches_per_step"] == row["launches_per_step"]
    bf16 = rows["tinyllama_bf16"]
    for run in ("sp1_xla", "sp1_flash", "sp2"):
        assert math.isfinite(bf16[run]["loss"]), run
    # sp 2 is one hop: a layer shifts its K/V block and its padding mask
    # forward, and the K/V gradient back
    for rank_row in (bf16, bf16["rank1"]):
        assert rank_row["sp2"]["ring_shifts_per_step"] == 3 * 2
        assert rank_row["sp2"]["grad_all_reduce_host_s_per_step"] > 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [r["run"] for r in lines if r.get("phase") == "ring_train"] == [
        "bert_large_wwm_fp32", "tinyllama_fp32", "t5_small_fp32", "tinyllama_bf16"]
