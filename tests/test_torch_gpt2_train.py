"""PyTorch port: GPT-2 causal-LM training (``models/gpt2.py`` training
forward, ``train/trainer.py`` causal-LM losses, ``data/pipeline.py``
``from_lm_texts``, ``models/auto.py``/``convert.py`` for family ``gpt2``,
``train/cli.py --task causal-lm``) against the JAX package on a tiny GPT-2
(H 128, so the JAX fused loss really runs its Pallas kernels in interpret
mode): the training forward and ``hidden_and_embedding``, the JAX
``Trainer``'s fp32 loss curve over 5 steps unfused and fused, one batch's
fused loss and gradients against ``make_fused_causal_lm_loss(interpret=
True)``, two gloo ranks with unequal valid-token counts equal to one
process, the LM dataset, the CLI's files, an export the JAX
``from_pretrained`` reads back, and ``remat`` (each block recomputed in
backward): bit for bit the plain step, within the tolerances below of the
JAX GPT-2's ``nn.remat`` step, and through the CLI.

Tolerances: logits 1e-4 (fp32 through two layers in two frameworks),
loss curves and losses 1e-5 relative (fp32, sums in other orders),
gradients rtol 1e-4 / atol 1e-6."""

import json
import logging
import math
import multiprocessing as mp
import os
import socket

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import config as t_config
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import pipeline as t_pipe
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import sources as t_src
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import tokenization as t_tok
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto as t_auto
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import convert as t_convert
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import gpt2 as t_gpt2
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import trainer as t_trainer
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.results import (
    read_results_file,
)

TINY = dict(vocab_size=300, hidden_size=128, num_layers=2, num_heads=2,
            intermediate_size=256, max_position_embeddings=64,
            hidden_dropout=0.0, embd_dropout=0.0, attention_dropout=0.0,
            eos_token_id=299, pad_token_id=0)
SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread per test worker runs
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


def _pair(seed=0, **overrides):
    """(jax model, jax params, port model) on the same weights."""
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.auto import init_params
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.gpt2 import (
        Gpt2Config,
        Gpt2LMHeadModel,
    )

    cfg = {**TINY, **overrides}
    jmodel = Gpt2LMHeadModel(Gpt2Config(dtype=jnp.float32, **cfg))
    params = init_params(jmodel, seed=seed)
    model = t_gpt2.Gpt2LMHeadModel(t_gpt2.Gpt2Config(**cfg))
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    model.load_state_dict(t_convert.params_from_jax(flat), strict=True)
    return jmodel, params, model


def _texts(n, seed):
    """Synthetic reviews cut to varied lengths, so rows hold different
    numbers of valid tokens (and padding)."""
    texts, _ = t_src.synthetic_text_classification(n, seed=seed)
    return [" ".join(t.split()[:3 + 5 * (i % 7)]) for i, t in enumerate(texts)]


def _lm_dataset(n, seed=0):
    return t_pipe.ArrayDataset.from_lm_texts(t_tok.WordHashTokenizer(TINY["vocab_size"]),
                                             _texts(n, seed), SEQ)


def _to_torch(batch):
    return {k: torch.from_numpy(v).long() if k != "valid" else torch.from_numpy(v)
            for k, v in batch.items()}


def _jax_batch(batch):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in batch.items()}


# -- model ---------------------------------------------------------------------

def test_training_forward_and_hidden_and_embedding_match_jax():
    import jax
    import jax.numpy as jnp

    jmodel, params, model = _pair()
    ds = _lm_dataset(4, seed=1)
    ids, mask = ds.columns["input_ids"], ds.columns["attention_mask"]
    model.train()
    logits = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    want = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                        deterministic=False)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    hidden, emb = model.hidden_and_embedding(torch.from_numpy(ids).long(),
                                             torch.from_numpy(mask).long())
    jh, je = jax.jit(lambda p, i, m: jmodel.apply(
        {"params": p}, i, m, deterministic=False,
        method=jmodel.hidden_and_embedding))(params, jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_allclose(hidden.detach().numpy(), np.asarray(jh), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(emb.detach().numpy(), np.asarray(je))
    assert emb is model.backbone.wte.weight


def test_bf16_compute_keeps_fp32_embedding_and_params():
    """The JAX dtype discipline: hidden in bf16, the tied embedding handed
    to the fused loss uncast (fp32), the head's logits cast before the
    product and returned fp32."""
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.gpt2 import (
        Gpt2Config,
        Gpt2LMHeadModel,
    )

    cfg = t_gpt2.Gpt2Config(dtype=torch.bfloat16, attention_impl="flash", **TINY)
    model = t_convert.init_gpt2(cfg, seed=0, device="cpu", trainable=True)
    ids = torch.from_numpy(_lm_dataset(2).columns["input_ids"]).long()
    hidden, emb = model.hidden_and_embedding(ids)
    assert hidden.dtype == torch.bfloat16 and emb.dtype == torch.float32
    assert model(ids).dtype == torch.float32
    assert all(p.dtype == torch.float32 and p.requires_grad for p in model.parameters())
    jmodel = Gpt2LMHeadModel(Gpt2Config(dtype=jnp.bfloat16, **TINY))
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.auto import init_params

    jh, je = jmodel.apply({"params": init_params(jmodel)}, jnp.asarray(ids.numpy()),
                          method=jmodel.hidden_and_embedding)
    assert (str(jh.dtype), str(je.dtype)) == ("bfloat16", "float32")


def test_attention_dropout_takes_the_unfused_softmax_and_warns_once(caplog, monkeypatch):
    monkeypatch.setattr(t_gpt2, "_flash_dropout_warned", False)
    cfg = t_gpt2.Gpt2Config(**{**TINY, "attention_dropout": 0.5}, attention_impl="flash")
    model = t_convert.init_gpt2(cfg, seed=0, device="cpu", trainable=True)
    ids = torch.from_numpy(_lm_dataset(2).columns["input_ids"]).long()
    with caplog.at_level(logging.WARNING):
        model.train()
        torch.manual_seed(0)
        a = model(ids)
        b = model(ids)
    assert sum("no flash hook" in r.getMessage() for r in caplog.records) == 1
    model.eval()
    with torch.no_grad():
        c = model(ids)
    assert not torch.equal(a, b) and torch.isfinite(a).all()
    xla = t_gpt2.Gpt2LMHeadModel(t_gpt2.Gpt2Config(**{**TINY, "attention_dropout": 0.5}))
    xla.load_state_dict(model.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(xla.eval()(ids), c, rtol=1e-5, atol=1e-5)


def test_xla_attention_applies_the_dropout_hook_to_the_probabilities():
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import attention as t_attn

    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 2, 8, 16)).astype(np.float32))
               for _ in range(3))
    plain = t_attn.dot_product_attention(q, k, v, impl="xla", causal=True)
    same = t_attn.dot_product_attention(q, k, v, impl="xla", causal=True,
                                        dropout=torch.nn.Dropout(0.5).eval())
    torch.testing.assert_close(same, plain, rtol=0, atol=0)
    halved = t_attn.dot_product_attention(q, k, v, impl="xla", causal=True,
                                          dropout=lambda p: 0.5 * p)
    torch.testing.assert_close(halved, 0.5 * plain, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="needs impl='xla'"):
        t_attn.dot_product_attention(q, k, v, impl="flash", causal=True,
                                     dropout=torch.nn.Dropout(0.5))


# -- trainer -------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_five_fp32_steps_match_jax_trainer(fused):
    """Same weights, same LM batches, AdamW with decay, clipping and a
    cosine warmup: the port's causal-LM loss curve is the JAX Trainer's."""
    import jax
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.train import Trainer as JaxTrainer

    kw = dict(task="causal-lm", fused_vocab_ce=fused, epochs=1, dtype="float32",
              learning_rate=1e-3, scale_lr_by_world_size=False, weight_decay=0.01,
              max_grad_norm=1.0, warmup_ratio=0.4, lr_schedule="cosine", log_every_steps=0)
    jmodel, params, model = _pair(seed=2)
    batches = list(t_pipe.ShardedBatcher(_lm_dataset(40, seed=3), 4, seed=0)
                   .local_batches(0))[:5]
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jtrainer = JaxTrainer(TrainConfig(**kw), jmodel, params, mesh, total_steps=5)
    trainer = t_trainer.Trainer(t_config.TrainConfig(**kw), model, total_steps=5)
    want, got, accs = [], [], []
    for b in batches:
        jtrainer.state, m = jtrainer._train_step(jtrainer.state,
                                                 {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(jax.device_get(m["loss"])))
        out = trainer.train_step(_to_torch(b))
        got.append(out["loss"].item())
        accs.append((out["accuracy"].item(), float(jax.device_get(m["accuracy"]))))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert all(a == pytest.approx(b, abs=1e-6) for a, b in accs)
    assert trainer.updates == 5 and len(set(np.round(want, 6))) == 5


def test_fused_loss_and_gradients_match_pallas_interpret():
    """One batch through the JAX ``make_fused_causal_lm_loss`` with the
    Pallas kernels in interpret mode and through the port's fused loss:
    the same loss, sums and gradient of every parameter."""
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.train.trainer import (
        make_fused_causal_lm_loss as jax_fused,
    )

    jmodel, params, model = _pair(seed=4)
    batch = _lm_dataset(4, seed=5)[np.arange(4)]
    assert batch["attention_mask"].sum(1).min() < SEQ          # padded rows
    jloss_fn = jax_fused(jmodel, interpret=True)

    def f(p):
        return jloss_fn(jmodel.apply, p, {k: jnp.asarray(v) for k, v in batch.items()},
                        {}, True)

    (want, jsums), jgrads = jax.value_and_grad(f, has_aux=True)(params)
    model.train()
    loss, sums = t_trainer.make_fused_causal_lm_loss(model)(model, _to_torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for key in ("loss_sum", "correct", "count"):
        np.testing.assert_allclose(sums[key].item(), float(jsums[key]), rtol=1e-5)
    flat = {k: np.asarray(v) for k, v in flatten_dict(jgrads, sep="/").items()}
    want_grads = t_convert.params_from_jax(flat)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def _remat_step(model, batch, seed):
    torch.manual_seed(seed)
    model.train()
    loss, _ = t_trainer.causal_lm_loss(model, _to_torch(batch))
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_remat_step_equals_the_plain_step_and_the_jax_remat_step():
    """``remat`` recomputes each block in backward: with dropout on and
    the same generator the step's loss and every gradient equal the plain
    step's bit for bit (fp32); with dropout 0 it is within 1e-5 of the JAX
    GPT-2 with ``remat=True`` (its blocks under ``nn.remat``)."""
    import dataclasses

    import jax
    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.train.trainer import (
        causal_lm_loss as jax_causal_lm_loss,
    )

    batch = _lm_dataset(4, seed=6)[np.arange(4)]
    cfg = t_gpt2.Gpt2Config(**dict(TINY, hidden_dropout=0.1, embd_dropout=0.1,
                                   attention_dropout=0.1))
    plain = t_convert.init_gpt2(cfg, seed=1, device="cpu", trainable=True)
    remat = t_convert.init_gpt2(dataclasses.replace(cfg, remat=True), seed=1, device="cpu",
                                trainable=True)
    (loss_a, grads_a), (loss_b, grads_b) = (_remat_step(m, batch, seed=11)
                                            for m in (plain, remat))
    assert loss_a == loss_b
    for name, g in grads_a.items():
        assert torch.equal(g, grads_b[name]), name

    jmodel, params, model = _pair(seed=7, remat=True)
    assert model.config.remat

    def f(p):
        return jax_causal_lm_loss(jmodel.apply, p, _jax_batch(batch),
                                  {"dropout": jax.random.PRNGKey(0)}, True)

    (want, _), jgrads = jax.value_and_grad(f, has_aux=True)(params)
    loss, grads = _remat_step(model, batch, seed=0)
    np.testing.assert_allclose(loss, float(want), rtol=1e-5)
    flat = {k: np.asarray(v) for k, v in flatten_dict(jgrads, sep="/").items()}
    want_grads = t_convert.params_from_jax(flat)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_causal_lm_cli_runs_with_remat(tmp_path):
    """``--task causal-lm --remat true`` trains (it raised before remat was
    ported) and its first loss equals the run without remat."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli

    model_dir = _tiny_model_dir(tmp_path / "cfg")
    common = ["--model_name_or_path", model_dir, "--from_scratch", "true",
              "--task", "causal-lm", "--dataset", "vendored_reviews",
              "--max_train_samples", "8", "--max_eval_samples", "4", "--epochs", "1",
              "--train_batch_size", "4", "--eval_batch_size", "4", "--dtype", "float32",
              "--log_every_steps", "0", "--max_seq_length", str(SEQ), "--device", "cpu"]
    runs = {}
    for remat in ("false", "true"):
        out = tmp_path / remat
        res, trainer = cli.run(common + ["--remat", remat, "--output_data_dir", str(out / "o"),
                                         "--model_dir", str(out / "m")])
        assert trainer.model.config.remat == (remat == "true")
        runs[remat] = res["train"]["loss"]
    assert runs["true"] == runs["false"] and math.isfinite(runs["true"][0])


def test_fused_vocab_ce_needs_a_causal_lm_model():
    model = t_convert.init_gpt2(t_gpt2.Gpt2Config(**TINY), seed=0, device="cpu",
                                trainable=True)
    with pytest.raises(ValueError, match="fused_vocab_ce requires.*causal-lm.*mlm.*seq2seq"):
        t_trainer.Trainer(t_config.TrainConfig(fused_vocab_ce=True), model)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp_lm_run(steps):
    """``steps`` train steps; returns the logged losses, the gradients the
    optimizer took at each step (after the all-reduce) and the final
    parameters."""
    ds = _lm_dataset(24, seed=7)
    cfg = t_config.TrainConfig(task="causal-lm", fused_vocab_ce=True, learning_rate=1e-3,
                               scale_lr_by_world_size=False, max_grad_norm=1.0)
    trainer = t_trainer.Trainer(cfg, t_convert.init_gpt2(t_gpt2.Gpt2Config(**TINY), seed=2,
                                                         device="cpu", trainable=True))
    grads, step = [], trainer.optimizer.step

    def step_and_record(*a, **kw):
        grads.append({n: p.grad.clone() for n, p in trainer.model.named_parameters()})
        return step(*a, **kw)

    trainer.optimizer.step = step_and_record
    losses = []
    for i, batch in enumerate(t_pipe.ShardedBatcher(ds, 8, seed=3).global_arrays(0)):
        if i == steps:
            break
        losses.append(trainer.train_step(batch)["loss"].item())
    return losses, grads, {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def _dp_lm_worker(rank, world, port, steps, out_path):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank))
    torch.set_num_threads(1)
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )

    initialize_distributed("cpu")
    try:
        losses, grads, params = _dp_lm_run(steps)
        torch.save({"losses": losses, "grads": grads, "params": params}, out_path)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def test_two_gloo_ranks_with_unequal_valid_tokens_match_one_process(tmp_path):
    """The loss is the global token mean: two ranks whose halves hold
    different numbers of valid tokens take the same steps, and log the
    same loss, as one process on the joined batch."""
    steps = 3
    first = next(t_pipe.ShardedBatcher(_lm_dataset(24, seed=7), 8, seed=3).local_batches(0))
    valid = first["attention_mask"][:, 1:].sum(1)
    assert valid[:4].sum() != valid[4:].sum()
    want_losses, want_grads, want_params = _dp_lm_run(steps)
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_dp_lm_worker,
                         args=(r, 2, port, steps, str(tmp_path / f"{r}.pt")))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs)
    ranks = [torch.load(str(tmp_path / f"{r}.pt")) for r in range(2)]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want_losses, rtol=1e-5)
        for got, want in zip(r["grads"], want_grads):       # after the all-reduce
            for key, value in want.items():
                np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=1e-4,
                                           atol=1e-7, err_msg=key)
        # Adam divides by sqrt(v) + 1e-8: where a gradient is near 0 its
        # rounding differences become parameter differences up to
        # lr * dg / eps, so parameters hold to 2e-5 (2% of one lr step)
        for key, value in want_params.items():
            np.testing.assert_allclose(r["params"][key].numpy(), value.numpy(), rtol=1e-4,
                                       atol=2e-5, err_msg=key)


# -- data, export, CLI -----------------------------------------------------------

def test_from_lm_texts_matches_jax():
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import (
        ArrayDataset,
        WordHashTokenizer,
    )

    texts = _texts(12, seed=8)
    want = ArrayDataset.from_lm_texts(WordHashTokenizer(TINY["vocab_size"]), texts, SEQ)
    got = _lm_dataset(12, seed=8)
    assert list(got.columns) == list(want.columns)
    for key, value in want.columns.items():
        np.testing.assert_array_equal(got.columns[key], np.asarray(value), err_msg=key)
    assert (got.columns["labels"][got.columns["attention_mask"] == 0] == -100).all()
    # the EOS-joined layout (ROADMAP item 6, ported): the JAX rows exactly
    packed = t_pipe.ArrayDataset.from_lm_texts(t_tok.WordHashTokenizer(300), texts, SEQ,
                                               packed=True, eos_token_id=299)
    want = ArrayDataset.from_lm_texts(WordHashTokenizer(300), texts, SEQ, packed=True,
                                      eos_token_id=299)
    for key, value in want.columns.items():
        np.testing.assert_array_equal(packed.columns[key], np.asarray(value), err_msg=key)
    assert (packed.columns["attention_mask"] == 1).all()


def _tiny_model_dir(path):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(t_gpt2.gpt2_config_to_hf(
        t_gpt2.Gpt2Config(**TINY))))
    return str(path)


def test_save_pretrained_reads_back_in_jax_and_in_the_port(tmp_path):
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as jax_auto

    model_dir = _tiny_model_dir(tmp_path / "cfg")
    model, family, cfg = t_auto.from_pretrained(model_dir, task="causal-lm", seed=3,
                                                from_scratch=True, device="cpu")
    assert family == "gpt2" and all(p.requires_grad for p in model.parameters())
    out = str(tmp_path / "export")
    t_auto.save_pretrained(out, model, family, cfg)
    ids = _lm_dataset(2, seed=9).columns["input_ids"]
    with torch.no_grad():
        logits = model(torch.from_numpy(ids).long()).numpy()
    jmodel, params, jfamily, _ = jax_auto.from_pretrained(out, task="causal-lm")
    assert jfamily == "gpt2"
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
    np.testing.assert_allclose(logits, want, rtol=1e-4, atol=1e-4)
    again, _, _ = t_auto.from_pretrained(out, task="causal-lm", device="cpu")
    for key, value in model.state_dict().items():
        assert torch.equal(again.state_dict()[key], value), key
    with pytest.raises(ValueError, match="causal-lm"):
        t_auto.from_pretrained(out, task="seq-cls", device="cpu")


def test_gpt2_hf_names_transpose_conv1d_and_tie_the_head():
    sd = t_convert.init_gpt2(t_gpt2.Gpt2Config(**TINY), seed=0, device="cpu").state_dict()
    hf = t_convert.gpt2_to_hf(sd)
    assert "lm_head.weight" not in hf and len(hf) == len(sd)
    assert hf["transformer.h.1.attn.c_attn.weight"].shape == (128, 384)
    assert torch.equal(hf["transformer.h.1.attn.c_attn.weight"].t(),
                       sd["backbone.h.1.attention.qkv.weight"])
    back = t_convert.gpt2_from_hf({k.removeprefix("transformer."): v for k, v in hf.items()})
    assert set(back) == set(sd) and all(torch.equal(back[k], v) for k, v in sd.items())
    head_only = {k: v for k, v in hf.items() if k != "transformer.wte.weight"}
    head_only["lm_head.weight"] = hf["transformer.wte.weight"]
    head_only["transformer.h.0.attn.bias"] = torch.ones(1, 1, 4, 4)   # mask buffer
    assert torch.equal(t_convert.gpt2_from_hf(head_only)["backbone.wte.weight"],
                       sd["backbone.wte.weight"])


def test_causal_lm_cli_on_cpu_writes_the_jax_cli_files(tmp_path):
    from scripts.train import main as jax_main

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli

    model_dir = _tiny_model_dir(tmp_path / "cfg")
    common = ["--model_name_or_path", model_dir, "--from_scratch", "true",
              "--task", "causal-lm", "--fused_vocab_ce", "true",
              "--dataset", "vendored_reviews", "--max_train_samples", "16",
              "--max_eval_samples", "6", "--epochs", "1", "--train_batch_size", "4",
              "--eval_batch_size", "4", "--dtype", "float32", "--log_every_steps", "0",
              "--max_seq_length", str(SEQ)]
    outs = {}
    for name, run in (("port", lambda a: cli.main(a + ["--device", "cpu"])),
                      ("jax", jax_main)):
        out, mdir = tmp_path / name / "out", tmp_path / name / "model"
        res = run(common + ["--output_data_dir", str(out), "--model_dir", str(mdir)])
        outs[name] = (out, mdir, res)
    for fname in ("train_results.txt", "eval_results.txt"):
        got = read_results_file(str(outs["port"][0] / fname))
        want = read_results_file(str(outs["jax"][0] / fname))
        assert list(got) == list(want), fname
    assert sorted(p.name for p in outs["port"][1].iterdir()) == \
        sorted(p.name for p in outs["jax"][1].iterdir())
    res = outs["port"][2]
    assert math.isfinite(res["eval"]["eval_loss"]) and len(res["train"]["loss"]) == 1
    exported = json.loads((outs["port"][1] / "config.json").read_text())
    assert exported == json.loads((outs["jax"][1] / "config.json").read_text())
