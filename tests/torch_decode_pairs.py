"""Shared set-up of the decoding and serving parity tests
(``test_torch_generate.py``, ``test_torch_speculative.py``,
``test_torch_quant.py``, ``test_torch_llama.py``, ``test_torch_moe.py``,
the ``test_torch_*`` serving files): tiny JAX
models with their port twins on the same weights (carried across with
``params_from_jax``), JAX's own Gumbel noise for a seed, the fixtures
every port test module runs under, and :func:`as_port`, which runs a JAX
package's serving host test on the port's classes and functions."""

import dataclasses

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import bart as t_bart
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import gpt2 as t_gpt2
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import llama as t_llama
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import t5 as t_t5
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
    params_from_jax,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models are tiny: one intra-op thread per test worker runs them
    faster than a pool contending with the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def detached_compile_trackers():
    """A compile tracker that an earlier telemetry test installed in this
    worker rejects the ``fun_name`` keyword jax 0.9 passes to duration
    listeners, failing every later jax compile in the worker. Remove every
    installed tracker before and after the module, and run the JAX package
    with its telemetry off (it then installs none)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu import obs as jax_obs

    drop_compile_trackers()
    jax_obs.reset(enabled=False)
    yield
    jax_obs.reset()
    drop_compile_trackers()


def drop_compile_trackers():
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


_PORT = {"Gpt2Config": (t_gpt2.Gpt2Config, t_gpt2.Gpt2LMHeadModel),
         "T5Config": (t_t5.T5Config, t_t5.T5ForConditionalGeneration),
         "BartConfig": (t_bart.BartConfig, t_bart.BartForConditionalGeneration),
         "LlamaConfig": (t_llama.LlamaConfig, t_llama.LlamaForCausalLM)}


def port_of(jmodel, params, **overrides):
    """The port's model of ``jmodel``'s config (fp32) holding ``params``."""
    from flax.traverse_util import flatten_dict

    cfg_cls, model_cls = _PORT[type(jmodel.config).__name__]
    kw = {f.name: getattr(jmodel.config, f.name) for f in dataclasses.fields(cfg_cls)
          if f.name not in ("dtype", "param_dtype")}
    kw.update(overrides)
    model = model_cls(cfg_cls(**kw))
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    model.load_state_dict(params_from_jax(flat), strict=True)
    return model.eval()


def gpt2_pair(num_layers=2, seed=0, vocab=128, **kw):
    """(JAX GPT-2, its params, the port's GPT-2): hidden 32, 4 heads,
    dropout 0; ``kw`` overrides any field."""
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.auto import init_params
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.gpt2 import (
        Gpt2Config,
        Gpt2LMHeadModel,
    )

    cfg = Gpt2Config(**{**dict(vocab_size=vocab, hidden_size=32, num_layers=num_layers,
                               num_heads=4, intermediate_size=64, max_position_embeddings=128,
                               hidden_dropout=0.0, embd_dropout=0.0, attention_dropout=0.0,
                               dtype=jnp.float32), **kw})
    jmodel = Gpt2LMHeadModel(cfg)
    params = init_params(jmodel, cfg, seed=seed)
    return jmodel, params, port_of(jmodel, params)


def llama_pair(seed=0, **kw):
    """(JAX Llama-family model, its params, the port's model): the JAX
    tests' tiny shape (vocab 128, hidden 32, 3 layers, 4 heads, 2 K/V
    heads, intermediate 64); ``kw`` overrides any field (``model_type``,
    ``sliding_window``, ``num_experts``, ...)."""
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.auto import init_params
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
    )

    base = dict(vocab_size=128, hidden_size=32, num_layers=3, num_heads=4, num_kv_heads=2,
                intermediate_size=64, max_position_embeddings=64, dtype=jnp.float32)
    cfg = LlamaConfig(**{**base, **kw})
    jmodel = LlamaForCausalLM(cfg)
    params = init_params(jmodel, cfg, seed=seed)
    return jmodel, params, port_of(jmodel, params)


def seq2seq_pair(variant="t5", num_layers=2, seed=0, vocab=96, **kw):
    """(JAX model, params, port model) of a tiny T5, BART or mBART (mBART:
    pre-LN, scaled embeddings, forced BOS 7), dropout 0."""
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.auto import init_params

    if variant == "t5":
        from huggingface_sagemaker_tensorflow_distributed_tpu.models.t5 import (
            T5Config as Cfg,
            T5ForConditionalGeneration as Model,
        )

        cfg = Cfg(vocab_size=vocab, d_model=32, d_kv=8, d_ff=64, num_layers=num_layers,
                  num_decoder_layers=num_layers, num_heads=4, dropout_rate=0.0,
                  dtype=jnp.float32, **kw)
    else:
        from huggingface_sagemaker_tensorflow_distributed_tpu.models.bart import (
            BartConfig as Cfg,
            BartForConditionalGeneration as Model,
        )

        extra = (dict(normalize_before=True, stack_final_ln=True, scale_embedding=True,
                      forced_bos_token_id=7) if variant == "mbart" else {})
        cfg = Cfg(vocab_size=vocab, d_model=32, encoder_layers=num_layers,
                  decoder_layers=num_layers, encoder_attention_heads=4,
                  decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64,
                  max_position_embeddings=64, dropout=0.0, attention_dropout=0.0,
                  dtype=jnp.float32, **extra, **kw)
    jmodel = Model(cfg)
    params = init_params(jmodel, cfg, seed=seed)
    return jmodel, params, port_of(jmodel, params)


def with_eos(jmodel, model, eos: int):
    """Both models with ``eos_token_id`` set to ``eos``."""
    jm = jmodel.clone(config=dataclasses.replace(jmodel.config, eos_token_id=eos))
    model.config = dataclasses.replace(model.config, eos_token_id=eos)
    return jm, model


def jax_gumbel_stream(seed: int, shape, steps: int) -> list:
    """The Gumbel noise JAX's ``generate_causal`` and ``generate`` draw
    with for ``seed``: each step splits the carried key and draws
    ``jax.random.categorical``'s noise from the subkey."""
    import jax

    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        out.append(torch.from_numpy(np.array(jax.random.gumbel(sub, shape))))
    return out


def feed_noise(monkeypatch, t_gen, noise: list) -> list:
    """Make the port's ``_gumbel`` hand out ``noise`` in order; returns the
    list of what is left (empty once every draw was taken)."""
    left = list(noise)

    def gumbel(shape, generator, device):
        got = left.pop(0)
        assert tuple(got.shape) == tuple(shape)
        return got.to(device)

    monkeypatch.setattr(t_gen, "_gumbel", gumbel)
    return left


_JAX_PKG = "huggingface_sagemaker_tensorflow_distributed_tpu."
_PORTED_HOST = ("serve.paged_kv", "serve.scheduler", "serve.policy", "serve.loadgen",
                "serve.router", "serve.transport", "obs.trace")


def as_port(monkeypatch, module, keep=()) -> None:
    """Point every name ``module`` took from the JAX package's serving host
    modules (``serve/paged_kv.py``, ``scheduler.py``, ``policy.py``,
    ``loadgen.py``, ``router.py``, ``transport.py``) and from
    ``obs/trace.py`` at the port's object of the same name, so that the
    module's test functions run on the port. Names in ``keep`` (what the
    port does not have, such as the trace renderers) stay the JAX
    package's: they then read what the port produced."""
    import importlib

    for name, value in list(vars(module).items()):
        src = getattr(value, "__module__", None) or ""
        if not src.startswith(_JAX_PKG) or name in keep:
            continue
        sub = src[len(_JAX_PKG):]
        if sub in _PORTED_HOST:
            port = importlib.import_module(
                "huggingface_sagemaker_tensorflow_distributed_tpu_torch." + sub)
            monkeypatch.setattr(module, name, getattr(port, name))
