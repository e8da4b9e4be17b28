"""PyTorch port: the Llama family (``models/llama.py``) against the JAX
package's ``models/llama.py`` on the same weights (carried across with
``params_from_jax``) and the same numpy inputs from a seed: logits of
Llama (GQA and MHA), Mistral with a binding window (kernel band and
position band), Qwen2 (q/k/v biases, a per-layer window start), Gemma
(head_dim apart from hidden / heads, the unit-offset norm, the embedding
scale, ``gelu_pytorch_tanh``) and RoPE scaling (linear, llama3), on the
plain and the flash path; the cached decode against the full forward;
``generate_causal`` (left and right padding, the window binding),
sampling on JAX's noise, chunked prefill, beam search and speculation
against JAX; HF-layout exports read across both ways; five fp32
causal-LM steps with the fused CE against the JAX ``Trainer``; int8
weights and LoRA; the JAX refusals; the serving engine on Llama, Mistral
past its window and int8 pools against the JAX engine; and per-token
FLOPs against JAX's accounting.

Tolerances: logits 1e-4 absolute (fp32 both sides, different summation
orders); the cached decode 1e-4 against the port's own full forward;
tokens exact; loss curves 1e-5 relative; FLOPs 1e-12 relative."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto as t_auto
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import generate as t_gen
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import llama as t_llama
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
    init_llama,
    params_from_jax,
)
from torch_decode_pairs import (  # noqa: F401  (autouse fixtures)
    detached_compile_trackers,
    feed_noise,
    jax_gumbel_stream,
    llama_pair,
    one_torch_thread,
    port_of,
)

LOGIT_TOL = 1e-4
VARIANTS = {
    "llama_gqa": dict(),
    "llama_mha": dict(num_kv_heads=4),
    "mistral": dict(model_type="mistral", sliding_window=4),
    "qwen2": dict(model_type="qwen2", qkv_bias=True, sliding_window=4,
                  sliding_window_start_layer=1),
    "gemma": dict(model_type="gemma", head_dim=16, rms_unit_offset=True, embed_scale=True,
                  hidden_act="gelu_pytorch_tanh", tie_word_embeddings=True),
    "rope_linear": dict(rope_scaling=(("factor", 4.0), ("rope_type", "linear"))),
    "rope_llama3": dict(rope_scaling=tuple(sorted({
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 16}.items()))),
}


def _j():
    from huggingface_sagemaker_tensorflow_distributed_tpu.models import generate as j_gen

    return j_gen


def _perturb_biases(jmodel, params, seed=0):
    """Nonzero q/k/v biases (the init's are zero): a Qwen2 case that does
    not exercise them would pass with them dropped."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)

    def bump(path, x):
        if path[-1].key == "bias":
            return jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.5)
        return x

    params = jax.tree_util.tree_map_with_path(bump, params)
    return params, port_of(jmodel, params)


def _variant(name, seed=0, **kw):
    jmodel, params, model = llama_pair(seed=seed, **{**VARIANTS[name], **kw})
    if VARIANTS[name].get("qkv_bias"):
        params, model = _perturb_biases(jmodel, params, seed)
    return jmodel, params, model


def _ids(batch=3, seq=20, seed=0, pad_row=True):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 128, (batch, seq)).astype(np.int32)
    mask = np.ones_like(ids)
    if pad_row:
        mask[1, -5:] = 0
    return ids, mask


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_logits_match_jax(name, impl):
    """The full forward at S 20 (past Mistral's window of 4 and the
    llama3 scaling's original context of 16), a right-padded row; the
    real tokens' logits (a pad query whose window holds only pads has no
    valid key: its row is junk on every path)."""
    import jax.numpy as jnp

    jmodel, params, model = _variant(name)
    if impl == "flash":
        model = port_of(jmodel, params, attention_impl="flash")
    ids, mask = _ids()
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    real = mask > 0
    np.testing.assert_allclose(got.numpy()[real], want[real], rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("name", ["mistral", "qwen2"])
def test_explicit_positions_take_the_position_band(name):
    """With position_ids the window is a band of positions (the general
    [B, 1, S, S] mask), not the kernel's band of rows: offset positions
    give the JAX logits."""
    import jax.numpy as jnp

    jmodel, params, model = _variant(name)
    ids, mask = _ids(pad_row=False)
    pos = np.broadcast_to(np.arange(ids.shape[1]) + 3, ids.shape).astype(np.int32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                                   position_ids=jnp.asarray(pos)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                    torch.from_numpy(pos).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("name,kv", [("llama_gqa", "fp"), ("mistral", "fp"),
                                     ("llama_gqa", "int8")])
def test_incremental_decode_matches_full_forward(name, kv):
    """A prefill of 6 tokens then one token a step through the dense cache
    (K/V cached per K/V head) gives the full forward's last logits; int8
    storage within its quantization error."""
    jmodel, params, model = _variant(name, kv_cache_dtype=kv)
    ids = torch.from_numpy(np.random.RandomState(1).randint(3, 128, (2, 14))).long()
    B, P = ids.shape[0], 6
    cache = model.new_dense_cache(B, 14)
    assert cache.keys[0].shape[1] == model.config.num_kv_heads
    with torch.no_grad():
        full = model(ids)
        steps = [model(ids[:, :P], None, None, cache)[:, -1]]
        for t in range(P, 14):
            steps.append(model(ids[:, t:t + 1], None, None, cache)[:, -1])
    tol = LOGIT_TOL if kv == "fp" else 5e-2
    np.testing.assert_allclose(torch.stack(steps[1:], 1).numpy(), full[:, P:].numpy(),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(steps[0].numpy(), full[:, P - 1].numpy(), rtol=0, atol=tol)


def test_windowed_decode_requires_position_ids_with_mask():
    """The JAX refusal: a windowed dense-cache call with a mask and no
    position_ids would mix logical keys with slot queries."""
    _, _, model = _variant("mistral")
    ids = torch.ones(2, 8, dtype=torch.long)
    cache = model.new_dense_cache(2, 8)
    with pytest.raises(ValueError, match="position_ids"):
        model(ids, torch.ones(2, 8, dtype=torch.long), None, cache)
    assert torch.isfinite(model(ids, None, None, model.new_dense_cache(2, 8))).all()


def _gen_case(name, side):
    rng = np.random.RandomState({"left": 2, "right": 3, "none": 4}[side])
    real = rng.randint(3, 128, (2, 9)).astype(np.int32)
    if side == "none":
        return real, np.ones_like(real)
    ids = np.zeros((2, 12), np.int32)
    mask = np.zeros((2, 12), np.int32)
    cols = slice(3, None) if side == "left" else slice(0, 9)
    ids[:, cols], mask[:, cols] = real, 1
    ids[0], mask[0] = np.r_[real[0], rng.randint(3, 128, 3)], 1      # an unpadded row
    return ids, mask


@pytest.mark.parametrize("name,side", [("llama_gqa", "left"), ("llama_mha", "right"),
                                       ("mistral", "left"), ("mistral", "right"),
                                       ("qwen2", "right"), ("gemma", "left")])
def test_generate_causal_matches_jax(name, side):
    """Greedy tokens exact against JAX, padded prompts; Mistral's window
    of 4 binds on the 9-12-token prompts (counted in logical positions on
    padded rows)."""
    import jax.numpy as jnp

    jmodel, params, model = _variant(name)
    ids, mask = _gen_case(name, side)
    want = np.asarray(_j().generate_causal(jmodel, params, jnp.asarray(ids),
                                           jnp.asarray(mask), max_new_tokens=8))
    got = t_gen.generate_causal(model, ids, mask, max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mistral_window_is_logical_on_padded_prompts():
    """JAX ``tests/test_llama.py``'s windowed decode: a right- and a
    left-padded prompt continue as the unpadded one does."""
    _, _, model = _variant("mistral")
    prompt = np.asarray([[5, 6, 7, 8, 9, 10]])
    a = t_gen.generate_causal(model, prompt, max_new_tokens=5)
    for ids, mask in ((np.c_[prompt, [[0, 0]]], [[1] * 6 + [0, 0]]),
                      (np.c_[[[0, 0]], prompt], [[0, 0] + [1] * 6])):
        assert torch.equal(t_gen.generate_causal(model, ids, np.asarray(mask),
                                                 max_new_tokens=5), a)


@pytest.mark.parametrize("name", ["llama_gqa", "mistral"])
def test_sampled_generate_matches_jax_on_shared_noise(monkeypatch, name):
    import jax.numpy as jnp

    jmodel, params, model = _variant(name, seed=3)
    ids, mask = _gen_case(name, "left")
    T, knobs = 8, dict(temperature=0.8, top_k=20, top_p=0.9)
    want = np.asarray(_j().generate_causal(jmodel, params, jnp.asarray(ids), jnp.asarray(mask),
                                           max_new_tokens=T, seed=11, **knobs))
    feed_noise(monkeypatch, t_gen, jax_gumbel_stream(11, (2, 128), T))
    got = t_gen.generate_causal(model, ids, mask, max_new_tokens=T, seed=11, **knobs)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["llama_gqa", "mistral"])
def test_chunked_prefill_matches_jax(name):
    import jax.numpy as jnp

    jmodel, params, model = _variant(name)
    ids, mask = _gen_case(name, "right")
    single = t_gen.generate_causal(model, ids, mask, max_new_tokens=6)
    got = t_gen.generate_causal(model, ids, mask, max_new_tokens=6, prefill_chunk=5)
    assert torch.equal(got, single)
    want = _j().generate_causal(jmodel, params, jnp.asarray(ids), jnp.asarray(mask),
                                max_new_tokens=6, prefill_chunk=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["llama_gqa", "mistral"])
def test_beam_search_matches_jax(name):
    import jax.numpy as jnp

    jmodel, params, model = _variant(name, seed=2)
    ids, mask = _gen_case(name, "left")
    kw = dict(num_beams=3, max_new_tokens=6, length_penalty=0.6, return_scores=True)
    want, want_s = _j().beam_search_causal(jmodel, params, jnp.asarray(ids),
                                           jnp.asarray(mask), **kw)
    got, got_s = t_gen.beam_search_causal(model, ids, mask, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["llama_gqa", "mistral"])
def test_self_speculation_matches_jax(name):
    """Greedy speculation with the target's first layer as the draft:
    JAX's tokens, which are ``generate_causal``'s."""
    import jax.numpy as jnp

    jmodel, params, model = _variant(name)
    ids, mask = _gen_case(name, "right")
    jd, jp = _j().self_draft(jmodel, params, 1)
    want = np.asarray(_j().generate_speculative(jmodel, params, jd, jp, jnp.asarray(ids),
                                                jnp.asarray(mask), max_new_tokens=8,
                                                speculate_k=3))
    draft = t_gen.self_draft(model, 1)
    assert draft.backbone.embed_tokens is model.backbone.embed_tokens
    assert draft.lm_head is model.lm_head and len(draft.backbone.layers) == 1
    got = t_gen.generate_speculative(model, draft, ids, mask, max_new_tokens=8, speculate_k=3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, t_gen.generate_causal(model, ids, mask, max_new_tokens=8))


# -- exports --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["llama_gqa", "qwen2", "gemma", "rope_llama3"])
def test_hf_export_reads_across_both_ways(name, tmp_path):
    """The port's export is the JAX package's: each reads the other's
    ``model.safetensors`` and ``config.json`` to the same logits."""
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto

    jmodel, params, model = _variant(name)
    t_auto.save_pretrained(str(tmp_path / "port"), model, "llama", model.config)
    jm, jp, fam, jcfg = j_auto.from_pretrained(str(tmp_path / "port"), task="causal-lm")
    assert fam == "llama" and jcfg.model_type == model.config.model_type
    ids, mask = _ids(pad_row=False)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
    np.testing.assert_allclose(np.asarray(jm.apply({"params": jp}, jnp.asarray(ids))), want,
                               rtol=0, atol=1e-6)
    j_auto.save_pretrained(str(tmp_path / "jax"), params, "llama", jmodel.config)
    cfg_port = json.load(open(tmp_path / "port" / "config.json"))
    assert cfg_port == json.load(open(tmp_path / "jax" / "config.json"))
    back, fam, cfg = t_auto.from_pretrained(str(tmp_path / "jax"), task="causal-lm",
                                            device="cpu")
    assert fam == "llama" and cfg == model.config
    with torch.no_grad():
        np.testing.assert_allclose(back(torch.from_numpy(ids).long()).numpy(), want,
                                   rtol=0, atol=LOGIT_TOL)
    flat = {k: np.asarray(v) for k, v in flatten_dict(jp, sep="/").items()}
    assert set(params_from_jax(flat)) == set(model.state_dict())


def test_llama_config_from_hf_matches_jax():
    """Every guard and default of the JAX builder: rope types, Qwen2's
    window policy, Gemma's defaults, Mixtral's fields, pad fallback."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.llama import (
        llama_config_from_hf as j_from_hf,
    )

    base = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64)
    cases = [
        dict(base, model_type="llama", num_key_value_heads=2, pad_token_id=None,
             rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                           "high_freq_factor": 4.0, "original_max_position_embeddings": 16}),
        dict(base, model_type="mistral", sliding_window=8),
        dict(base, model_type="qwen2", use_sliding_window=True, sliding_window=8,
             max_window_layers=1),
        dict(base, model_type="qwen2"),
        dict(base, model_type="gemma", head_dim=16),
        dict(base, model_type="gemma", hidden_activation="gelu"),
        dict(base, model_type="mixtral", num_local_experts=4),
        dict(base, model_type="llama", rope_scaling={"type": "linear", "factor": 2.0}),
    ]
    for hf in cases:
        j = j_from_hf(hf)
        p = t_llama.llama_config_from_hf(hf)
        for f in dataclasses.fields(p):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(p, f.name) == getattr(j, f.name), (hf, f.name)


def test_llama_refusals_match_jax():
    """JAX ``tests/test_llama.py``'s refusals raise the same errors, and
    the unported pipeline and ring attention name their ROADMAP item."""
    base = dict(vocab_size=128, hidden_size=32, num_hidden_layers=1,
                num_attention_heads=4, intermediate_size=64)
    with pytest.raises(ValueError, match="rope_scaling"):
        t_llama.llama_config_from_hf({**base, "rope_scaling": {"rope_type": "llama3",
                                                               "factor": 8.0}})
    t_llama.llama_config_from_hf({**base, "rope_scaling": None})
    t_llama.llama_config_from_hf({**base, "rope_scaling": {"rope_type": "default"}})
    with pytest.raises(ValueError, match="attention_bias"):
        t_llama.llama_config_from_hf({**base, "attention_bias": True})
    with pytest.raises(ValueError, match="yarn"):
        t_llama.llama_config_from_hf({**base, "model_type": "llama", "rope_scaling": {
            "rope_type": "yarn", "factor": 2.0}})
    with pytest.raises(ValueError, match="num_experts > 0 is not supported"):
        t_llama.LlamaConfig(num_experts=2, model_type="qwen2")
    assert t_llama.LlamaConfig(num_experts=2, model_type="mistral").model_type == "mixtral"


# -- training, int8, LoRA -----------------------------------------------------------

def _lm_batches(n_steps=5, B=4, S=16, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_steps):
        ids = rng.randint(3, 128, (B, S)).astype(np.int32)
        mask = np.ones_like(ids)
        mask[0, S - 4:] = 0
        labels = np.where(mask > 0, ids, -100).astype(np.int32)
        out.append({"input_ids": ids, "attention_mask": mask, "labels": labels})
    return out


TRAIN_KW = dict(task="causal-lm", epochs=1, dtype="float32", learning_rate=1e-3,
                scale_lr_by_world_size=False, weight_decay=0.01, max_grad_norm=1.0,
                warmup_ratio=0.4, lr_schedule="cosine", log_every_steps=0)


def _jax_curve(jmodel, params, batches, **kw):
    import jax
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.train import Trainer

    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    trainer = Trainer(TrainConfig(**TRAIN_KW, **kw), jmodel, params, mesh,
                      total_steps=len(batches))
    losses = []
    for b in batches:
        trainer.state, m = trainer._train_step(
            trainer.state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(jax.device_get(m["loss"])))
    return losses


def _port_curve(model, batches, **kw):
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer

    model.requires_grad_(True)
    trainer = Trainer(TrainConfig(**TRAIN_KW, **kw), model, total_steps=len(batches))
    return [float(trainer.train_step({k: torch.from_numpy(v).long() for k, v in b.items()})
                  ["loss"]) for b in batches]


@pytest.mark.parametrize("name", ["llama_gqa", "mistral"])
def test_five_fused_ce_steps_match_jax_trainer(name):
    """Five fp32 AdamW steps of causal-LM with the fused vocab CE (the
    untied ``[V, H]`` head): the JAX Trainer's losses within 1e-5."""
    jmodel, params, model = _variant(name, hidden_size=128, num_heads=2, num_kv_heads=1,
                                     intermediate_size=128, num_layers=2)
    batches = _lm_batches()
    want = _jax_curve(jmodel, params, batches, fused_vocab_ce=True)
    got = _port_curve(model, batches, fused_vocab_ce=True)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert len(set(np.round(want, 6))) == 5


def test_int8_weights_and_lora_compose():
    """JAX ``tests/test_llama.py``'s contract: int8 quantizes the seven
    projections a layer (``lm_head`` stays fp), logits stay correlated
    above 0.999 and equal the JAX int8 model's; LoRA's attention preset
    targets q/k/v/o."""
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.quant import (
        quantize_for_generation as j_quant,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.lora import (
        init_lora_params,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.quant import (
        Int8Linear,
        quantize_for_generation,
    )

    jmodel, params, model = _variant("llama_gqa")
    qmodel, stats = quantize_for_generation(model)
    assert stats["kernels_quantized"] == 3 * 7
    assert not isinstance(qmodel.lm_head, Int8Linear)
    ids = np.random.RandomState(0).randint(3, 128, (2, 12)).astype(np.int32)
    with torch.no_grad():
        fp = model(torch.from_numpy(ids).long()).numpy()
        q8 = qmodel(torch.from_numpy(ids).long()).numpy()
    assert np.corrcoef(fp.ravel(), q8.ravel())[0, 1] > 0.999
    jq, jqp, _ = j_quant(jmodel, params)
    np.testing.assert_allclose(q8, np.asarray(jq.apply({"params": jqp}, jnp.asarray(ids))),
                               rtol=0, atol=LOGIT_TOL)
    np.testing.assert_array_equal(
        t_gen.generate_causal(qmodel, ids[:, :6], max_new_tokens=4).numpy(),
        np.asarray(_j().generate_causal(jq, jqp, jnp.asarray(ids[:, :6]), max_new_tokens=4)))
    lora = init_lora_params(model, rank=4, targets="attention")
    assert len(lora) == 3 * 4
    assert all(p.endswith(("q_proj/kernel", "k_proj/kernel", "v_proj/kernel",
                           "o_proj/kernel")) for p in lora)


# -- serving --------------------------------------------------------------------------

def _serve_trace(seed, shapes):
    rng = np.random.RandomState(seed)
    return [(rng.randint(3, 120, (p,)).astype(np.int32), m) for p, m in shapes]


def _run_port(model, trace, **kw):
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import ServeEngine

    eng = ServeEngine(model, device="cpu", **kw)
    reqs = [eng.submit(p, m) for p, m in trace]
    eng.run()
    return eng, [[int(t) for t in eng.output_ids(r)] for r in reqs]


def _run_jax(jmodel, params, trace, **kw):
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve.engine import (
        ServeEngine as JaxServeEngine,
    )

    eng = JaxServeEngine(jmodel, params, **{"kernel": "xla", "overlap": "off",
                                            "timeline": "off", **kw})
    reqs = [eng.submit(p, m) for p, m in trace]
    eng.run()
    return eng, [[int(t) for t in eng.output_ids(r)] for r in reqs]


@pytest.mark.parametrize("name,kv,kernel", [("llama_gqa", "fp", "pallas"),
                                            ("llama_gqa", "int8", "pallas"),
                                            ("mistral", "fp", "pallas"),
                                            ("mistral", "fp", "xla"),
                                            ("qwen2", "int8", "xla")])
def test_serve_engine_matches_jax_engine(name, kv, kernel):
    """The port's engine (K3's route or the gather route) gives the JAX
    engine's tokens per request on the same weights: GQA pools of
    ``num_kv_heads``, Mistral's window of 4 on contexts far past it, int8
    pools; ``kv_token_bytes`` is the JAX pools' bytes per token."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import (
        kv_token_bytes,
    )

    jmodel, params, model = _variant(name, eos_token_id=127)
    trace = _serve_trace(7, [(5, 10), (19, 12), (3, 20), (27, 8), (11, 16)])
    kw = dict(num_slots=3, block_size=4, num_blocks=40, prefill_chunk=8, max_model_len=64,
              kv_cache_dtype=kv)
    jeng, want = _run_jax(jmodel, params, trace, **kw)
    eng, got = _run_port(model, trace, kernel=kernel, **kw)
    assert got == want
    assert eng.blocks.token_bytes == jeng.blocks.token_bytes
    assert eng.blocks.token_bytes == kv_token_bytes(model.config, kv == "int8")
    assert eng.k_pools[0].shape[2] == model.config.num_kv_heads


def test_serve_engine_refuses_moe_as_jax_does():
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve.engine import (
        ServeEngine as JaxServeEngine,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import ServeEngine

    jmodel, params, model = llama_pair(num_experts=2, num_layers=1)
    with pytest.raises(ValueError, match="does not support MoE") as want:
        JaxServeEngine(jmodel, params)
    with pytest.raises(ValueError, match="does not support MoE") as got:
        ServeEngine(model, device="cpu")
    assert str(got.value) == str(want.value)


# -- FLOPs ----------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(num_kv_heads=4), dict(num_experts=4),
                                dict(num_experts=8, expert_top_k=2, moe_every=2)],
                         ids=["llama_gqa", "llama_mha", "mixtral", "mixtral_every2"])
@pytest.mark.parametrize("task", ["causal-lm", "mlm"])
def test_flops_per_token_match_jax(kw, task):
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.llama import (
        LlamaConfig as JCfg,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import flops as j_flops
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import flops as t_flops

    shape = {**dict(vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
                    num_kv_heads=8, intermediate_size=14336), **kw}
    want = j_flops.trainer_flops_per_token(JCfg(**shape), task, 2048)
    got = t_flops.trainer_flops_per_token(t_llama.LlamaConfig(**shape), task, 2048)
    assert got[1] == want[1] and abs(got[0] - want[0]) <= 1e-12 * want[0]


def test_init_llama_is_seeded_and_follows_the_jax_init():
    cfg = t_llama.LlamaConfig(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                              num_kv_heads=2, intermediate_size=128, model_type="gemma",
                              rms_unit_offset=True, head_dim=32)
    a, b = init_llama(cfg, seed=3, device="cpu"), init_llama(cfg, seed=3, device="cpu")
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    sd = a.state_dict()
    assert float(sd["backbone.final_ln.weight"].abs().sum()) == 0.0      # Gemma's offsets
    std = float(sd["backbone.embed_tokens.weight"].std())
    assert abs(std - cfg.initializer_range) < 0.1 * cfg.initializer_range
    assert not any(p.requires_grad for p in a.parameters())


# -- Gemma at head_dim 256 through the slice ------------------------------------------

GEMMA_256 = dict(VARIANTS["gemma"], head_dim=256, num_layers=2)


def test_gemma_head_dim_256_five_steps_match_jax_trainer():
    """Gemma at its head_dim of 256 (2 layers, hidden 128, 2 query heads
    over 1 K/V head, tied head) on the port's flash path (the K1 wrappers:
    their plain versions on the CPU) and the fused vocab CE: five fp32
    AdamW steps, the JAX Trainer's losses within 1e-5."""
    from torch_decode_pairs import port_of

    jmodel, params, _ = _variant("gemma", **GEMMA_256, hidden_size=128, num_heads=2,
                                 num_kv_heads=1, intermediate_size=128)
    model = port_of(jmodel, params, attention_impl="flash")
    assert model.config.resolved_head_dim == 256 and model.config.tie_word_embeddings
    batches = _lm_batches()
    want = _jax_curve(jmodel, params, batches, fused_vocab_ce=True)
    got = _port_curve(model, batches, fused_vocab_ce=True)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert len(set(np.round(want, 6))) == 5


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_gemma_head_dim_256_serve_engine_matches_jax_engine(kv):
    """The port's engine on K3's route (here its plain version) at head_dim
    256, fp and int8 pools, gives the JAX engine's greedy tokens per
    request on the same Gemma weights."""
    jmodel, params, model = _variant("gemma", **GEMMA_256, eos_token_id=127)
    trace = _serve_trace(9, [(5, 10), (19, 12), (3, 20), (27, 8), (11, 16)])
    kw = dict(num_slots=3, block_size=4, num_blocks=40, prefill_chunk=8, max_model_len=64,
              kv_cache_dtype=kv)
    jeng, want = _run_jax(jmodel, params, trace, **kw)
    eng, got = _run_port(model, trace, kernel="pallas", **kw)
    assert got == want
    assert eng.k_pools[0].shape[-1] == 256
    assert eng.blocks.token_bytes == jeng.blocks.token_bytes


def test_gemma_head_dim_256_causal_lm_cli_writes_the_jax_cli_files(tmp_path):
    """A Gemma ``config.json`` at head_dim 256 through the port's train CLI
    (causal-LM, the fused CE, flash attention, fp32) and the JAX CLI on the
    same arguments: the same results keys, export files and exported
    config; finite losses."""
    import math

    from scripts.train import main as jax_main

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.results import (
        read_results_file,
    )

    cfg_dir = tmp_path / "cfg"
    cfg_dir.mkdir()
    (cfg_dir / "config.json").write_text(json.dumps({
        "model_type": "gemma", "architectures": ["GemmaForCausalLM"], "vocab_size": 512,
        "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 256,
        "max_position_embeddings": 64, "rms_norm_eps": 1e-6, "hidden_act": "gelu",
        "bos_token_id": 2, "eos_token_id": 1, "pad_token_id": 0}))
    common = ["--model_name_or_path", str(cfg_dir), "--from_scratch", "true",
              "--task", "causal-lm", "--fused_vocab_ce", "true",
              "--dataset", "vendored_reviews", "--max_train_samples", "16",
              "--max_eval_samples", "6", "--epochs", "1", "--train_batch_size", "4",
              "--eval_batch_size", "4", "--dtype", "float32", "--log_every_steps", "0",
              "--max_seq_length", "32"]
    outs = {}
    for name, run in (("port", lambda a: cli.main(a + ["--device", "cpu",
                                                        "--attention_impl", "flash"])),
                      ("jax", jax_main)):
        out, mdir = tmp_path / name / "out", tmp_path / name / "model"
        res = run(common + ["--output_data_dir", str(out), "--model_dir", str(mdir)])
        outs[name] = (out, mdir, res)
    for fname in ("train_results.txt", "eval_results.txt"):
        assert list(read_results_file(str(outs["port"][0] / fname))) == \
            list(read_results_file(str(outs["jax"][0] / fname))), fname
    assert sorted(p.name for p in outs["port"][1].iterdir()) == \
        sorted(p.name for p in outs["jax"][1].iterdir())
    exported = json.loads((outs["port"][1] / "config.json").read_text())
    assert exported == json.loads((outs["jax"][1] / "config.json").read_text())
    assert exported["head_dim"] == 256
    res = outs["port"][2]
    assert all(math.isfinite(x) for x in res["train"]["loss"])
    assert math.isfinite(res["eval"]["eval_loss"])
