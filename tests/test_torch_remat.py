"""PyTorch port: the remat policies (``models/layers.py:remat_policy``,
ROADMAP queue 1, item 4) in every family that takes one: the encoder
(BERT), GPT-2, Llama, T5, BART and DeBERTa.

- Under each policy (``full``, ``dots``, ``dots_no_batch``) a train step's
  loss and every gradient equal the port's step without remat, with
  dropout on (the recompute replays the forward's draws): fp32, 1e-6
  relative.
- Under ``dots`` and ``dots_no_batch`` the port's step equals the JAX
  package's under the same policy (its layers under ``nn.remat(policy=...)``,
  dropout 0): the loss within 1e-5 relative, each gradient within 1e-3
  relative L2 (a gradient that is 0 in exact arithmetic, an attention key
  bias's, within 1e-6 of the largest gradient's norm).
- On one encoder layer of the plain (``xla``) attention path, the products
  the port's policy marks must-save match the ``dot_general``s of
  ``jax.make_jaxpr`` of the JAX layer that the JAX policy saves, in number
  and in batch-or-not (the batch dimensions read from each
  ``dimension_numbers``)."""

import json

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto as t_auto
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import layers as t_layers
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import params_from_jax
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import trainer as t_trainer

VOCAB, SEQ, TGT, ROWS = 128, 12, 8, 3


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


def _hf(family: str, dropout: float) -> dict:
    """A tiny config of ``family`` in its HF dialect, every dropout at
    ``dropout`` (Llama has none)."""
    p = dropout
    return {
        "bert": {"model_type": "bert", "vocab_size": VOCAB, "hidden_size": 32,
                 "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 64,
                 "max_position_embeddings": 64, "hidden_dropout_prob": p,
                 "attention_probs_dropout_prob": p},
        "gpt2": {"model_type": "gpt2", "vocab_size": VOCAB, "n_positions": 64, "n_embd": 32,
                 "n_layer": 2, "n_head": 2, "resid_pdrop": p, "embd_pdrop": p,
                 "attn_pdrop": p},
        "llama": {"model_type": "llama", "vocab_size": VOCAB, "hidden_size": 32,
                  "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
                  "num_key_value_heads": 2, "max_position_embeddings": 64},
        "t5": {"model_type": "t5", "vocab_size": VOCAB, "d_model": 32, "d_kv": 8, "d_ff": 64,
               "num_layers": 2, "num_decoder_layers": 2, "num_heads": 4,
               "relative_attention_num_buckets": 32, "relative_attention_max_distance": 128,
               "dropout_rate": p},
        "bart": {"model_type": "bart", "vocab_size": VOCAB, "d_model": 32, "encoder_layers": 2,
                 "decoder_layers": 2, "encoder_attention_heads": 4,
                 "decoder_attention_heads": 4, "encoder_ffn_dim": 64, "decoder_ffn_dim": 64,
                 "max_position_embeddings": 64, "dropout": p, "attention_dropout": p,
                 "activation_dropout": p},
        "deberta": {"model_type": "deberta-v2", "vocab_size": VOCAB, "hidden_size": 32,
                    "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 64,
                    "max_position_embeddings": 64, "relative_attention": True,
                    "position_buckets": 16, "share_att_key": True, "pos_att_type": "p2c|c2p",
                    "norm_rel_ebd": "layer_norm", "position_biased_input": False,
                    "hidden_dropout_prob": p, "attention_probs_dropout_prob": p},
    }[family]


TASK = {"bert": "seq-cls", "gpt2": "causal-lm", "llama": "causal-lm", "t5": "seq2seq",
        "bart": "seq2seq", "deberta": "seq-cls"}
FAMILIES = list(TASK)


def _dir(tmp_path, family: str, dropout: float) -> str:
    path = tmp_path / f"{family}-{dropout}"
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(_hf(family, dropout)))
    return str(path)


def _batch(task: str, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, VOCAB, (ROWS, SEQ))
    mask = np.ones((ROWS, SEQ), np.int64)
    mask[1, 8:] = 0
    ids[1, 8:] = 0
    batch = {"input_ids": ids, "attention_mask": mask}
    if task == "seq-cls":
        batch["labels"] = rng.randint(0, 2, (ROWS,))
    elif task == "causal-lm":
        batch["labels"] = np.where(mask > 0, ids, -100)
    else:
        dec = rng.randint(4, VOCAB, (ROWS, TGT))
        labels = rng.randint(4, VOCAB, (ROWS, TGT))
        labels[2, 5:] = -100
        batch.update(decoder_input_ids=dec, decoder_attention_mask=(labels != -100) * 1,
                     labels=labels)
    return batch


PORT_LOSS = {"seq-cls": t_trainer.seq_cls_loss, "causal-lm": t_trainer.causal_lm_loss,
             "seq2seq": t_trainer.seq2seq_loss}


def _port_step(model, task: str, batch: dict, seed: int) -> tuple[float, dict]:
    """One fp32 train step of ``task`` (dropout from ``seed``): the loss and
    every gradient."""
    torch.manual_seed(seed)
    model.train()
    loss, _ = PORT_LOSS[task](
        model, {k: torch.from_numpy(np.asarray(v)).long() for k, v in batch.items()})
    loss.backward()
    return loss.item(), {n: p.grad.detach().clone() for n, p in model.named_parameters()
                         if p.grad is not None}


def _port_model(path: str, task: str, state=None, **remat):
    model, _, _ = t_auto.from_pretrained(path, task=task, from_scratch=True, seed=0,
                                         device="cpu", **remat)
    if state is not None:
        model.load_state_dict(state, strict=True)
    return model


@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch"])
@pytest.mark.parametrize("family", FAMILIES)
def test_policy_step_equals_the_plain_step(family, policy, tmp_path):
    """Dropout 0.1 where the family has dropout, the same generator seed:
    the remat step's loss and gradients equal the plain step's within
    1e-6 relative (the recompute draws the forward's masks again)."""
    task = TASK[family]
    path = _dir(tmp_path, family, 0.1)
    plain = _port_model(path, task)
    remat = _port_model(path, task, state=plain.state_dict(), remat=True, remat_policy=policy)
    assert remat.config.remat and remat.config.remat_policy == policy
    batch = _batch(task, seed=1)
    loss_a, grads_a = _port_step(plain, task, batch, seed=11)
    loss_b, grads_b = _port_step(remat, task, batch, seed=11)
    assert abs(loss_b - loss_a) <= 1e-6 * abs(loss_a)
    assert grads_a.keys() == grads_b.keys()
    for name, g in grads_a.items():
        err = float((grads_b[name] - g).abs().max())
        assert err <= 1e-6 * max(float(g.abs().max()), 1e-30), (name, err)


def _jax_pair(path: str, task: str, policy: str):
    """(JAX model under the policy, its params, the port's model under the
    policy on the same weights)."""
    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto

    jmodel, params, _, jcfg = j_auto.from_pretrained(path, task=task, seed=3, remat=True,
                                                     remat_policy=policy)
    assert jcfg.remat and jcfg.remat_policy == policy
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    model = _port_model(path, task, state=params_from_jax(flat), remat=True,
                        remat_policy=policy)
    return jmodel, params, model


def _jax_step(jmodel, params, batch: dict, task: str):
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.train import trainer as j_trainer

    fn = {"seq-cls": j_trainer.seq_cls_loss, "causal-lm": j_trainer.causal_lm_loss,
          "seq2seq": j_trainer.seq2seq_loss}[task]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.value_and_grad(
        lambda p: fn(jmodel.apply, p, jbatch, {"dropout": jax.random.PRNGKey(0)}, True),
        has_aux=True)(params)
    flat = {k: np.asarray(v) for k, v in flatten_dict(grads, sep="/").items()}
    return float(loss), params_from_jax(flat)


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
@pytest.mark.parametrize("family", FAMILIES)
def test_policy_step_matches_the_jax_policy_step(family, policy, tmp_path):
    task = TASK[family]
    jmodel, params, model = _jax_pair(_dir(tmp_path, family, 0.0), task, policy)
    batch = _batch(task, seed=2)
    want_loss, want = _jax_step(jmodel, params, batch, task)
    loss, grads = _port_step(model, task, batch, seed=0)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    largest = max(float(torch.linalg.vector_norm(w)) for w in want.values())
    for name, g in grads.items():
        w = want[name]
        diff, norm = float(torch.linalg.vector_norm(g - w)), float(torch.linalg.vector_norm(w))
        if norm < 1e-6 * largest:
            # a gradient that is 0 in exact arithmetic (an attention key
            # bias: the softmax is shift-invariant along the keys) is
            # rounding in both packages: held to the step's scale instead
            assert diff <= 1e-6 * largest, (name, diff)
        else:
            assert diff <= 1e-3 * norm, (name, diff / norm)


def _jax_dots(jaxpr) -> list:
    """Every ``dot_general`` of ``jaxpr`` and its sub-jaxprs: True where it
    has batch dimensions."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (_, _), (lhs_batch, _) = eqn.params["dimension_numbers"]
            out.append(len(lhs_batch) > 0)
        for value in eqn.params.values():
            sub = getattr(value, "jaxpr", value)
            if hasattr(sub, "eqns"):
                out += _jax_dots(sub)
    return out


BATCHED = {torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default}


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
def test_marked_products_match_the_jax_layers_dot_generals(policy):
    """One BERT encoder layer on the plain attention path (the attention
    core under its own checkpoint in both packages, ``remat_attention``):
    the products the port's policy marks must-save are, in number and in
    batch-or-not, the ``dot_general``s the JAX policy saves (all of them
    under ``dots``; those without batch dimensions under
    ``dots_no_batch``): six projections (q, k, v, the attention output and
    the two FFN denses) and the two attention products with batch
    dimensions (B, heads)."""
    import jax
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import layers as j_layers

    widths = dict(vocab_size=VOCAB, hidden_size=32, num_layers=1, num_heads=2,
                  intermediate_size=64, max_position_embeddings=64, hidden_dropout=0.0,
                  attention_dropout=0.0)
    rng = np.random.RandomState(4)
    x = rng.randn(ROWS, SEQ, 32).astype(np.float32)
    mask = np.zeros((ROWS, 1, 1, SEQ), np.float32)
    mask[1, ..., 8:] = -1e9
    jlayer = j_layers.EncoderLayer(j_layers.EncoderConfig(dtype=jnp.float32, **widths))
    jparams = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    dots = _jax_dots(jax.make_jaxpr(lambda p: jlayer.apply(p, x, mask))(jparams).jaxpr)
    want = [b for b in dots if policy == "dots" or not b]

    layer = t_layers.EncoderLayer(t_layers.EncoderConfig(**widths))
    marked: list = []
    xt = torch.from_numpy(x).requires_grad_()
    out = torch.utils.checkpoint.checkpoint(
        layer, xt, torch.from_numpy(mask), use_reentrant=False,
        context_fn=t_layers.remat_policy(policy, marked))
    out.sum().backward()
    got = [op in BATCHED for op in marked]
    assert sorted(got) == sorted(want)
    assert (len(want), sum(want)) == ((8, 2) if policy == "dots" else (6, 0))
    assert xt.grad is not None and torch.isfinite(xt.grad).all()


def test_full_policy_is_the_plain_checkpoint_and_unknown_raises():
    assert t_layers.remat_policy("full") is torch.utils.checkpoint.noop_context_fn
    with pytest.raises(ValueError, match="unknown remat_policy 'dotz'"):
        t_layers.remat_policy("dotz")
