"""Fine-tuning and pretraining entry point (counterpart of the JAX
package's ``scripts/train.py::main`` for tasks ``seq-cls``, ``token-cls``,
``qa``, ``causal-lm``, ``mlm``, ``rtd`` and ``seq2seq``).

    python -m huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.cli \\
        --model_name_or_path DIR --dataset vendored_reviews [--device cpu] ...

Hyperparameters are the JAX CLI's ``--key value`` arguments (same
``TrainConfig``); ``--device`` (default ``cuda``) picks where the model
runs, and without a card ``cuda`` raises. The run: join the process group
the environment names, load or seed the model from ``DIR/config.json``,
load the tokenizer ``DIR`` holds (``load_tokenizer``: a ``vocab.txt``
gives the WordPiece with its C++ core, a ``tokenizer.json`` the HF
tokenizer, none the word-hash tokenizer), tokenize the train and test
splits (a ``--dataset_path`` of ``{split}.jsonl`` files or a
``datasets.save_to_disk`` directory; with ``--streaming true`` the train
split stays on disk and is tokenized batch by batch; token-cls labels a
word's first subword, QA with ``--qa_doc_stride`` trains on overlapping
context windows, ``mlm`` masks whole words afresh each epoch
(``--mlm_static_masking`` pins epoch 0's masks; ``--fused_vocab_ce``
gathers the masked rows into the fused vocab cross-entropy), ``rtd``
replaces random tokens for ELECTRA's discriminator, ``seq2seq`` pairs
sources with LM-style targets, or with ``--span_corruption`` turns texts
into T5's span-corruption pairs, its target length raised to fit the
spans; ``--segment_packing`` packs causal-LM and MLM examples into
shared rows behind segment ids, ``--packed_sequences`` cuts EOS-joined
causal-LM documents into full rows; ``--num_experts E`` with
``--expert_top_k`` and ``--moe_every`` makes every ``moe_every``-th
layer an expert bank, on the encoder families, GPT-2 and the Llama
family, whose config directories (Llama, Mistral, Qwen2, Gemma,
Mixtral) train ``causal-lm``), batch them
(``--bucket_multiple``: length buckets of its multiples), restore the
latest checkpoint under ``--checkpoint_dir`` (unless ``--resume
false``), fit, evaluate (token-cls adds ``eval_f1``; QA with
``--eval_qa_samples N`` decodes N test answers over their windows and adds
SQuAD's ``eval_exact_match`` and ``eval_f1``; seq2seq with
``--eval_rouge_samples N`` generates greedily for the first N test rows
and adds ``rougeL_precision``, ``rougeL_recall`` and ``rougeL_f1``), write
``train_results.txt``/``eval_results.txt`` to ``output_data_dir``, and
export the model and tokenizer in HF layout to ``model_dir`` (rank 0;
with ``--keep_best`` the best epoch's weights; with ``--lora_rank r`` the
base frozen and rank-r adapters trained, the export merged and the
adapters written beside it to ``model_dir/adapter``). Rerunning an interrupted
command resumes it ("resuming from epoch N"). Telemetry goes to
``HSTD_TELEMETRY_DIR`` when set; run as a script with
``TPU_OUTPUT_DATA_DIR``/``SM_OUTPUT_DATA_DIR`` set and no
``HSTD_TELEMETRY_DIR``, to ``<output_data_dir>/telemetry``; the run's
K1 and K2 launch counts end it as ``kernel_launches/<wrapper>`` metrics.
Several processes on one host: start one per card with
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` (or the
``TPU_*`` triplet) set, or through the launcher (``launch/``). With
``--fsdp F``, ``--sp S`` and/or ``--tp T`` (``--dp`` -1 takes the rest of
the ranks) the ranks form a ``(dp, fsdp, sp, tp)`` mesh
(``parallel/mesh.py``): FSDP2 shards the model over ``fsdp``, ring
attention splits each row's tokens over ``sp``
(``parallel/ring_attention.py``) and the Megatron plan cuts it over ``tp``
(``parallel/sharding.py``), each of the ``dp x fsdp`` replicas takes
``train_batch_size`` rows a step, and rank 0 exports the gathered model.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs, resolve_device
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.config import (
    TrainConfig,
    parse_args,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.pipeline import (
    ArrayDataset,
    ShardedBatcher,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.sources import (
    load_qa,
    load_seq2seq,
    load_text_classification,
    load_token_classification,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.streaming import (
    LineCorpus,
    StreamingTextDataset,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.tokenization import (
    load_tokenizer,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.generate import generate
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.lora import save_adapters
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.mesh import (
    MeshConfig,
    build_mesh,
    data_parallel_size,
    mesh_shape,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.distributed import (
    initialize_distributed,
    local_device,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.checkpoint import (
    Checkpointer,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.logging import (
    get_logger,
    setup_logging,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.metrics import (
    best_windowed_answers,
    extract_answer_spans,
    rouge_l,
    squad_em_f1,
)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def _check_num_labels(labels, num_labels: int, task: str) -> None:
    """A label past the head's width would index past the logits: fail at
    data-build time instead."""
    top = max((label for label in labels if label >= 0), default=0)
    if top >= num_labels:
        raise ValueError(f"{task}: dataset contains label {top} but --num_labels is "
                         f"{num_labels}; pass --num_labels {top + 1} (conll2003 needs 9)")


def _seq2seq_ids(model_config) -> dict:
    """The decoder start, pad and EOS ids the seq2seq builders take."""
    return dict(decoder_start_token_id=getattr(model_config, "decoder_start_token_id", 0),
                pad_token_id=getattr(model_config, "pad_token_id", 0),
                eos_token_id=getattr(model_config, "eos_token_id", 1))


def build_streaming_dataset(config: TrainConfig, tokenizer, split: str, max_len: int,
                            max_samples, model_config=None) -> StreamingTextDataset:
    """``--streaming true``: the corpus stays on disk and is tokenized per
    batch. Sources: ``dataset_path/{split}.jsonl`` or ``.txt``; the
    synthetic tier writes its corpus to a file in the temporary directory
    once, so its path is that of a real on-disk corpus (the JAX CLI's
    ``build_streaming_dataset``)."""
    if config.dataset_path:
        base = os.path.join(config.dataset_path, split)
        path = next((base + ext for ext in (".jsonl", ".txt")
                     if os.path.exists(base + ext)), None)
        if path is None:
            raise ValueError(f"--streaming: no {base}.jsonl or .txt")
    elif config.dataset == "synthetic":
        n = max_samples or 2000
        path = os.path.join(tempfile.gettempdir(),
                            f"stream_synth_{config.task}_{split}_{n}_{config.seed}.jsonl")
        if not os.path.exists(path):
            if config.task == "seq2seq":
                sources, targets = load_seq2seq("synthetic", split, max_samples=n,
                                                seed=config.seed)
                rows = [{"source": a, "target": b} for a, b in zip(sources, targets)]
            else:
                texts, labels = load_text_classification("synthetic", split,
                                                         max_samples=n, seed=config.seed)
                rows = [{"text": a, "label": b} for a, b in zip(texts, labels)]
            # a process-unique temporary file and an atomic replace: ranks
            # may race to write the same (deterministic) file
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                for rec in rows:
                    f.write(json.dumps(rec) + "\n")
            os.replace(tmp, path)
    else:
        raise ValueError("--streaming needs --dataset_path (train.jsonl/.txt) or "
                         "--dataset synthetic")
    seq2seq_kwargs = None
    if config.task == "seq2seq":
        seq2seq_kwargs = dict(max_target_length=config.max_target_length,
                              **_seq2seq_ids(model_config))
    return StreamingTextDataset(LineCorpus(path, max_rows=max_samples), tokenizer,
                                task=config.task, max_length=max_len, seed=config.seed,
                                num_labels=config.num_labels
                                if config.task == "seq-cls" else None,
                                seq2seq_kwargs=seq2seq_kwargs)


def build_dataset(config: TrainConfig, tokenizer, split: str, max_len: int,
                  max_samples, model_config=None):
    if config.streaming and split == "train":
        return build_streaming_dataset(config, tokenizer, split, max_len, max_samples,
                                       model_config)
    kw = dict(dataset_path=config.dataset_path, max_samples=max_samples, seed=config.seed)
    if config.task == "seq2seq" and config.span_corruption:
        try:
            texts, _ = load_text_classification(config.dataset, split, **kw)
        except ValueError:
            # a seq2seq corpus (cnn_dailymail, ...) corrupts its sources
            texts, _ = load_seq2seq(config.dataset, split, **kw)
        # a corrupted source of max_len tokens needs about 0.2 max_len
        # target tokens (spans, sentinels, the final sentinel)
        tgt_len = max(config.max_target_length, int(max_len * 0.2) + 4)
        if tgt_len != config.max_target_length:
            get_logger("train").info(
                "span_corruption: raising max_target_length %d → %d to fit the "
                "corrupted spans", config.max_target_length, tgt_len)
        return ArrayDataset.from_span_corruption_texts(
            tokenizer, texts, max_source_length=max_len, max_target_length=tgt_len,
            seed=config.seed, **_seq2seq_ids(model_config))
    if config.task == "seq2seq":
        sources, targets = load_seq2seq(config.dataset, split, **kw)
        return ArrayDataset.from_seq2seq(
            tokenizer, sources, targets, max_source_length=max_len,
            max_target_length=config.max_target_length, **_seq2seq_ids(model_config))
    if config.task == "token-cls":
        sents, tags = load_token_classification(config.dataset, split, **kw)
        _check_num_labels([t for ts in tags for t in ts], config.num_labels, config.task)
        return ArrayDataset.from_token_classification(tokenizer, sents, tags, max_len)
    if config.task == "qa":
        questions, contexts, starts, answers = load_qa(config.dataset, split, **kw)
        return ArrayDataset.from_qa(tokenizer, questions, contexts, starts, answers,
                                    max_len, doc_stride=config.qa_doc_stride)
    texts, labels = load_text_classification(config.dataset, split, **kw)
    # any text source works as an LM, MLM or RTD corpus; its labels are ignored
    if config.task == "causal-lm":
        ds = ArrayDataset.from_lm_texts(
            tokenizer, texts, max_len, packed=config.packed_sequences,
            eos_token_id=getattr(model_config, "eos_token_id", None))
        # per-example boundaries: segment ids and restarting positions
        return ds.pack(max_len, causal=True) if config.segment_packing else ds
    if config.task == "mlm":
        ds = ArrayDataset.from_mlm_texts(tokenizer, texts, max_len, seed=config.seed,
                                         static_masking=config.mlm_static_masking)
        if config.segment_packing:
            if not config.mlm_static_masking:
                raise ValueError(
                    "--segment_packing with task=mlm requires "
                    "--mlm_static_masking true (packing freezes the "
                    "masking draw at build time)")
            ds = ds.pack(max_len)
        return ds
    if config.task == "rtd":
        return ArrayDataset.from_rtd_texts(tokenizer, texts, max_len, seed=config.seed)
    _check_num_labels(labels, config.num_labels, config.task)
    return ArrayDataset.from_texts(tokenizer, texts, labels, max_len)


def rouge_metrics(config: TrainConfig, model, tokenizer, eval_ds) -> dict:
    """ROUGE-L of greedy ``generate`` (``max_target_length`` new tokens)
    over the first ``eval_rouge_samples`` eval rows against their labels,
    both decoded by the tokenizer (the JAX CLI's seq2seq eval)."""
    n = min(config.eval_rouge_samples, len(eval_ds))
    cols = eval_ds[np.arange(n)]
    model.eval()
    out = generate(model, cols["input_ids"], cols["attention_mask"],
                   max_new_tokens=config.max_target_length).cpu().numpy()
    preds = [tokenizer.decode(row) for row in out]
    refs = [tokenizer.decode(row[row != -100]) for row in cols["labels"]]
    return rouge_l(preds, refs)


@torch.no_grad()
def qa_answer_metrics(config: TrainConfig, model, tokenizer, max_len: int,
                      batch_size: int, device: torch.device) -> dict:
    """SQuAD's answer-text exact match and F1 over the first
    ``eval_qa_samples`` test examples: each example's windows (with
    ``qa_doc_stride``) go through the model, each window's best span is
    decoded from its character offsets, and an example's answer is its
    best-scoring window's (the JAX CLI's QA eval)."""
    questions, contexts, starts, answers = load_qa(
        config.dataset, "test", dataset_path=config.dataset_path,
        max_samples=config.eval_qa_samples, seed=config.seed)
    enc = tokenizer.encode_qa(questions, contexts, starts, answers, max_length=max_len,
                              return_offsets=True, doc_stride=config.qa_doc_stride)
    ex_ids = np.asarray(enc["example_ids"])
    feat_ctx = [contexts[i] for i in ex_ids]
    model.eval()
    texts_scores: list = []
    n_feat = enc["input_ids"].shape[0]
    for lo in range(0, n_feat, batch_size):
        sl = slice(lo, min(lo + batch_size, n_feat))

        def col(name):
            return torch.as_tensor(np.asarray(enc[name][sl]), dtype=torch.long, device=device)

        s_log, e_log = model(col("input_ids"), col("attention_mask"),
                             token_type_ids=col("token_type_ids")
                             if "token_type_ids" in enc else None)
        texts_scores.extend(extract_answer_spans(
            s_log.float().cpu().numpy(), e_log.float().cpu().numpy(),
            enc["offset_starts"][sl], enc["offset_ends"][sl], feat_ctx[sl],
            with_scores=True))
    preds = best_windowed_answers([t for t, _ in texts_scores],
                                  [sc for _, sc in texts_scores], ex_ids, len(questions))
    em_f1 = squad_em_f1(preds, list(answers))
    return {"eval_exact_match": em_f1["exact_match"], "eval_f1": em_f1["f1"],
            "eval_qa_windows": n_feat}


def main(argv=None) -> dict:
    """Train, evaluate and export; returns ``{"train": history, "eval":
    metrics}`` (the keys that ran)."""
    return run(argv)[0]


def run(argv=None) -> tuple[dict, Trainer]:
    """:func:`main`, also handing back the trainer (and through it the
    trained model)."""
    config = parse_args(argv)
    extra = argparse.ArgumentParser(allow_abbrev=False)
    extra.add_argument("--device", default="cuda")
    device_type = resolve_device(extra.parse_known_args(argv)[0].device).type
    rank, world = initialize_distributed(device_type)
    try:
        return _run(config, local_device(device_type), rank, world)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(config: TrainConfig, device: torch.device, rank: int,
         world: int) -> tuple[dict, Trainer]:
    setup_logging(process_index=rank, all_hosts=config.log_all_hosts)
    logger = get_logger("train")
    logger.info("config: %s", config.to_json())
    logger.info("rank %d/%d on %s", rank, world, device)
    # dropout draws from torch's default generators, seeded per run
    torch.manual_seed(config.seed)

    attention_impl = config.resolve_attention_impl(device.type)
    if config.segment_packing and attention_impl == "flash":
        logger.warning(
            "--segment_packing builds a [B,1,S,S] block-diagonal mask, which "
            "the flash kernels treat as a general mask and leave to the plain "
            "attention — long-sequence memory is O(S^2) on this run, not O(S)")
    moe_overrides = {}
    if config.num_experts:
        moe_overrides = dict(num_experts=config.num_experts,
                             expert_top_k=config.expert_top_k,
                             moe_every=config.moe_every)
    model, family, model_config = auto.from_pretrained(
        config.model_name_or_path, task=config.task, num_labels=config.num_labels,
        dtype=DTYPES[config.dtype], param_dtype=DTYPES[config.param_dtype],
        seed=config.seed, from_scratch=config.from_scratch, device=device,
        attention_impl=attention_impl, remat=config.remat,
        remat_policy=config.remat_policy, **moe_overrides)
    if config.num_experts:
        logger.info("MoE: %d experts (top-%d) every %d layers, ep=%d",
                    config.num_experts, config.expert_top_k, config.moe_every, config.ep)
    if attention_impl == "ring":
        if family == "t5":
            logger.info("sp=%d: ring attention on the T5 encoder (relative bias re-tiled "
                        "per ring step); the decoder and cross-attention run whole on "
                        "every seq rank", config.sp)
        else:
            logger.info("sp=%d: ring attention selected", config.sp)
    if config.segment_packing and family not in ("gpt2", "bert"):
        raise ValueError(
            "--segment_packing needs a model wired for segment_ids/"
            "position_ids (gpt2 causal-lm, bert mlm); "
            f"got family {family!r}")
    if config.segment_packing and attention_impl == "ring":
        raise ValueError(
            "--segment_packing builds a [B,1,S,S] block-diagonal "
            "mask, which ring attention (sp>1) cannot shard over the "
            "seq axis — drop --sp or --segment_packing")
    tokenizer = load_tokenizer(config.model_name_or_path,
                               vocab_size=model_config.vocab_size)

    max_len = min(config.max_seq_length,
                  getattr(model_config, "max_position_embeddings", config.max_seq_length))
    train_ds = build_dataset(config, tokenizer, "train", max_len, config.max_train_samples,
                             model_config)
    eval_ds = build_dataset(config, tokenizer, "test", max_len, config.max_eval_samples,
                            model_config)
    buckets = config.bucket_sizes(max_len)
    if buckets:
        logger.info("length bucketing at widths %s", buckets)
    # --fsdp/--sp/--tp: the (dp, fsdp, sp, tp) mesh the Trainer runs over; a
    # batch per data-parallel replica (the seq and tensor ranks of one share it)
    mesh, replicas = None, world
    if config.fsdp > 1 or config.sp > 1 or config.tp > 1:
        mesh = build_mesh(MeshConfig(dp=config.dp, fsdp=config.fsdp, sp=config.sp,
                                     tp=config.tp), device_type=device.type)
        replicas = data_parallel_size(mesh)
        logger.info("mesh %s: %d data-parallel replicas", mesh_shape(mesh), replicas)
    train_batcher = ShardedBatcher(train_ds, config.train_batch_size * replicas,
                                   shuffle=True, seed=config.seed, device=device,
                                   bucket_sizes=buckets, mesh=mesh)
    eval_batcher = ShardedBatcher(eval_ds, config.eval_batch_size * replicas,
                                  shuffle=False, drop_remainder=False, device=device,
                                  bucket_sizes=buckets, mesh=mesh)

    total_steps = train_batcher.steps_per_epoch() * config.epochs
    trainer = Trainer(config, model, total_steps=total_steps, mesh=mesh)

    checkpointer = None
    start_epoch = start_step_in_epoch = 0
    if config.checkpoint_dir:
        checkpointer = Checkpointer(config.checkpoint_dir, max_to_keep=config.keep_checkpoints,
                                    async_save=config.async_checkpointing)
        if config.resume:
            with obs.span("train/restore"):
                restored = checkpointer.restore()
                if restored is not None:
                    state, start_epoch, start_step_in_epoch = restored
                    trainer.load_state_dict(state)
                    del state
            if restored is not None:
                logger.info("resuming from epoch %d (step-in-epoch %d)",
                            start_epoch, start_step_in_epoch)
                if config.keep_best or config.early_stopping_patience:
                    logger.warning(
                        "--keep_best/--early_stopping_patience across a resume: "
                        "best-metric and patience tracking live in host RAM, not the "
                        "checkpoint — both restart at this epoch (earlier epochs can "
                        "no longer win, and the patience budget is fresh)")

    results: dict = {}
    try:
        if config.do_train:
            logger.info("*** Train ***")
            history = trainer.fit(
                train_batcher, checkpointer=checkpointer, start_epoch=start_epoch,
                start_step_in_epoch=start_step_in_epoch,
                eval_batcher=eval_batcher if config.eval_each_epoch else None)
            if config.keep_best and trainer.best_epoch is not None:
                logger.info("exporting best epoch %d (%s = %.4f)", trainer.best_epoch,
                            config.best_metric, trainer._best_metric)
            trainer.write_train_results(history)
            results["train"] = history
        if config.do_eval:
            logger.info("*** Evaluate ***")
            eval_results = trainer.evaluate(eval_batcher)
            if config.task == "seq2seq" and config.eval_rouge_samples:
                eval_results.update(rouge_metrics(config, model, tokenizer, eval_ds))
                logger.info("ROUGE-L over %d generated summaries: F1 %.4f",
                            min(config.eval_rouge_samples, len(eval_ds)),
                            eval_results["rougeL_f1"])
            if config.task == "qa" and config.eval_qa_samples:
                qa = qa_answer_metrics(config, model, tokenizer, max_len,
                                       config.eval_batch_size * replicas, device)
                eval_results["eval_exact_match"] = qa["eval_exact_match"]
                eval_results["eval_f1"] = qa["eval_f1"]
                logger.info("QA answers over %d windows: exact match %.2f, F1 %.2f",
                            qa["eval_qa_windows"], qa["eval_exact_match"], qa["eval_f1"])
            trainer.write_eval_results(eval_results)
            results["eval"] = eval_results
        # with LoRA the export is the merged model
        auto.save_pretrained(config.model_dir, model, family, model_config,
                             state=trainer.export_params)
        if rank == 0:
            # the tokenizer this run used, beside the model (a WordPiece
            # export is a vocab.txt and tokenizer_config.json)
            tokenizer.save_pretrained(config.model_dir)
            if trainer.lora is not None:
                # the adapter sidecar beside the merged export: megabytes
                # to ship instead of the whole model
                save_adapters(os.path.join(config.model_dir, "adapter"), trainer.lora,
                              rank=config.lora_rank, alpha=config.lora_alpha,
                              targets=config.lora_targets)
    finally:
        # commits an in-flight async checkpoint write even when fit or
        # eval raise: a crash after "save started" must not lose it
        if checkpointer is not None:
            checkpointer.close()
    emit_kernel_launches()
    return results, trainer


def emit_kernel_launches() -> None:
    """The K1 and K2 wrappers' launch counts of this process as telemetry
    metrics (``kernel_launches/<wrapper>``): how a launched job shows which
    kernels its steps ran (0 on the CPU, where the plain versions run)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import (
        flash_attention,
        vocab_ce,
    )

    for mod, names in ((flash_attention, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
                       (vocab_ce, ("fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_dw"))):
        for name in names:
            obs.scalar(f"kernel_launches/{name}", getattr(mod, name).launches)


def script(argv, entry=None) -> None:
    """A script run of ``entry`` (:func:`main` unless given) on ``argv``:
    its telemetry defaults into the output directory (in-process callers
    opt in through ``HSTD_TELEMETRY_DIR`` or ``obs.configure``, so calling
    ``main()`` writes no telemetry files as a side effect), and is shut
    down at the end."""
    if not os.environ.get("HSTD_TELEMETRY_DIR", "").strip():
        out = os.environ.get("TPU_OUTPUT_DATA_DIR", os.environ.get("SM_OUTPUT_DATA_DIR", ""))
        if out:
            obs.configure(out_dir=os.path.join(out, "telemetry"))
    try:
        (entry or main)(argv)
    finally:
        obs.shutdown()


if __name__ == "__main__":
    script(sys.argv[1:])
