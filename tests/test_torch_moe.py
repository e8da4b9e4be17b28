"""PyTorch port: Mixture-of-Experts (``models/moe.py``) against the JAX
package's ``models/moe.py`` on the same weights and numpy inputs:
``topk_dispatch``'s combine tensor under both slot priorities (ties,
capacity drops), the Switch aux loss, ``MoeFeedForward`` and
``MixtralMoeBlock``; the logits of BERT with MoE layers, GPT-2 MoE and
Mixtral; Mixtral's HF export and a dense Llama upcycled; the encoder
families' ``moe.safetensors`` sidecar both ways and its layout check;
five-step loss curves with the aux loss against the JAX ``Trainer``; the
JAX refusals; the causal priority's no-future-leak property.

Tolerances: the combine tensor exact (the same fp32 arithmetic on the
same probabilities); the aux loss 1e-6; the MoE blocks' outputs 1e-5;
logits 1e-4; loss curves 1e-5 relative (all absolute unless said)."""

import json

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto as t_auto
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import generate as t_gen
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import moe as t_moe
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
    params_from_jax,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.layers import (
    EncoderConfig,
    is_moe_layer,
)
from torch_decode_pairs import (  # noqa: F401  (autouse fixtures)
    detached_compile_trackers,
    gpt2_pair,
    llama_pair,
    one_torch_thread,
)

SEQ = 16
MOE = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
           max_position_embeddings=SEQ, num_experts=4, expert_top_k=2, moe_every=2,
           hidden_dropout=0.0, attention_dropout=0.0)
NO_DROP = 4.0          # a capacity factor at which dispatch never drops (E / k = 2)


def _flat(params) -> dict:
    from flax.traverse_util import flatten_dict

    return {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}


def _jax_cfg(**kw):
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.layers import (
        EncoderConfig as JCfg,
    )

    return JCfg(**{**MOE, **kw})


def _probs(seed, B=2, S=SEQ, E=4, ties=False):
    rng = np.random.RandomState(seed)
    p = rng.rand(B, S, E).astype(np.float32)
    if ties:
        p[:, ::3] = np.array([0.3, 0.3, 0.2, 0.2], np.float32)   # ties in both rounds
        p[:, 1::5, :3] = 0.25
    return p / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("causal", [False, True], ids=["round_major", "position_major"])
@pytest.mark.parametrize("C", [4, 8, 16], ids=["drops", "some", "no_drop"])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_topk_dispatch_equals_jax_exactly(causal, C, ties):
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import moe as j_moe

    p = _probs(C, ties=ties)
    want_c, want_t = j_moe.topk_dispatch(jnp.asarray(p), 2, C, causal)
    got_c, got_t = t_moe.topk_dispatch(torch.from_numpy(p), 2, C, causal)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    if ties:            # the first of equal maxima: expert 0, then 1
        assert got_t[0, 0].argmax() == 0 and got_c[0, 0, 1].sum() > 0
    if C == 4:          # the tiny capacity drops choices
        assert (got_c > 0).sum() < 2 * p.shape[0] * p.shape[1]


def test_expert_capacity_and_placement_match_jax():
    from huggingface_sagemaker_tensorflow_distributed_tpu.models import moe as j_moe
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.layers import (
        is_moe_layer as j_is_moe,
    )

    for kw in (dict(), dict(expert_capacity_factor=0.3), dict(num_experts=8, expert_top_k=1)):
        for S in (8, 16, 512, 1000):
            assert t_moe.expert_capacity(EncoderConfig(**{**MOE, **kw}), S) == \
                j_moe.expert_capacity(_jax_cfg(**kw), S)
    for every in (1, 2, 3):
        cfg = EncoderConfig(**{**MOE, "num_layers": 6, "moe_every": every})
        assert [is_moe_layer(cfg, i) for i in range(6)] == \
            [j_is_moe(_jax_cfg(num_layers=6, moe_every=every), i) for i in range(6)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("factor", [0.3, 1.25, NO_DROP])
def test_moe_feed_forward_and_aux_loss_match_jax(causal, factor):
    import jax
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.moe import (
        MoeFeedForward as JMoe,
    )

    jcfg = _jax_cfg(expert_capacity_factor=factor)
    layer = JMoe(jcfg, causal=causal)
    x = np.array(jax.random.normal(jax.random.PRNGKey(0), (2, SEQ, 32), jnp.float32))
    params = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want, state = layer.apply({"params": params}, jnp.asarray(x), mutable=["losses"])
    (want_aux,) = jax.tree.leaves(state["losses"])
    mod = t_moe.MoeFeedForward(EncoderConfig(**{**MOE, "expert_capacity_factor": factor}),
                               causal=causal).eval()
    mod.load_state_dict(params_from_jax(_flat(params)))
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    aux = float(mod.aux_loss)
    assert abs(aux - float(want_aux)) <= 1e-6
    assert float(t_moe.moe_aux_loss(mod)) == aux
    assert t_moe.moe_aux_loss(mod) is None          # read once


def test_mixtral_block_matches_jax():
    import jax
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.llama import (
        LlamaConfig as JL,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.moe import MixtralMoeBlock
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.llama import (
        LlamaConfig,
    )

    shape = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=4, num_kv_heads=2,
                 intermediate_size=48, num_experts=4, expert_capacity_factor=1.0,
                 model_type="mixtral")
    block = MixtralMoeBlock(JL(**shape))
    x = np.array(jax.random.normal(jax.random.PRNGKey(2), (3, 12, 32), jnp.float32))
    params = block.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    want, state = block.apply({"params": params}, jnp.asarray(x), mutable=["losses"])
    mod = t_moe.MixtralMoeBlock(LlamaConfig(**shape))
    mod.load_state_dict(params_from_jax(_flat(params)))
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert abs(float(t_moe.moe_aux_loss(mod)) - float(jax.tree.leaves(state["losses"])[0])) \
        <= 1e-6


def _bert_pair(seed=0, **kw):
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.auto import init_params
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.bert import (
        BertForSequenceClassification as JBert,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.bert import (
        BertForSequenceClassification,
    )

    jcfg = _jax_cfg(dtype=jnp.float32, **kw)
    jmodel = JBert(jcfg, num_labels=2)
    params = init_params(jmodel, jcfg, seed=seed)
    model = BertForSequenceClassification(EncoderConfig(**{**MOE, **kw}), num_labels=2)
    model.load_state_dict(params_from_jax(_flat(params)), strict=True)
    return jmodel, params, model.eval()


def _batch(seed=0, B=4, vocab=256):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, vocab, (B, SEQ)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, SEQ - 5:] = 0
    return ids, mask


@pytest.mark.parametrize("family", ["bert", "gpt2", "mixtral"])
def test_logits_match_jax(family):
    import jax.numpy as jnp

    if family == "bert":
        jmodel, params, model = _bert_pair()
        assert hasattr(model.backbone.encoder.layer[1], "moe")
        assert hasattr(model.backbone.encoder.layer[0], "ffn")
    elif family == "gpt2":
        jmodel, params, model = gpt2_pair(num_experts=4, expert_top_k=2, vocab=256)
        assert hasattr(model.backbone.h[1], "moe") and hasattr(model.backbone.h[0], "mlp")
    else:
        jmodel, params, model = llama_pair(num_experts=4, vocab_size=256,
                                           expert_capacity_factor=1.0)
        assert all(hasattr(b, "moe") for b in model.backbone.layers)
    ids, mask = _batch()
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    real = mask > 0 if got.dim() == 3 else slice(None)
    np.testing.assert_allclose(got.numpy()[real], want[real], rtol=0, atol=1e-4)


def test_mixtral_hf_export_round_trips_and_a_dense_llama_upcycles(tmp_path):
    """Mixtral's banks travel in HF's per-expert layout (no sidecar):
    JAX reads the port's export and the port the JAX one; a dense Llama
    export loaded with ``num_experts`` becomes a Mixtral with fresh banks
    and the dense weights kept."""
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto

    jmodel, params, model = llama_pair(num_experts=4, expert_capacity_factor=NO_DROP)
    t_auto.save_pretrained(str(tmp_path / "port"), model, "llama", model.config)
    assert not (tmp_path / "port" / "moe.safetensors").exists()
    cfg = json.load(open(tmp_path / "port" / "config.json"))
    assert cfg["model_type"] == "mixtral" and cfg["num_local_experts"] == 4
    jm, jp, _, jcfg = j_auto.from_pretrained(str(tmp_path / "port"), task="causal-lm")
    ids, _ = _batch(vocab=128)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
    np.testing.assert_allclose(np.asarray(jm.apply({"params": jp}, jnp.asarray(ids))), want,
                               rtol=0, atol=1e-6)
    j_auto.save_pretrained(str(tmp_path / "jax"), params, "llama", jmodel.config)
    back, _, bcfg = t_auto.from_pretrained(str(tmp_path / "jax"), task="causal-lm",
                                           device="cpu")
    assert bcfg == model.config
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    # upcycling
    _, _, dense = llama_pair()
    t_auto.save_pretrained(str(tmp_path / "dense"), dense, "llama", dense.config)
    up, _, ucfg = t_auto.from_pretrained(str(tmp_path / "dense"), task="causal-lm",
                                         device="cpu", num_experts=4)
    assert ucfg.model_type == "mixtral" and ucfg.num_experts == 4
    sd = up.state_dict()
    assert torch.equal(sd["backbone.layers.0.self_attn.q_proj.weight"],
                       dense.state_dict()["backbone.layers.0.self_attn.q_proj.weight"])
    assert sd["backbone.layers.0.moe.w1"].shape == (4, 32, 64)


@pytest.mark.parametrize("family", ["bert", "gpt2"])
def test_encoder_sidecar_round_trips_both_ways(family, tmp_path):
    """The banks without an HF layout travel in ``moe.safetensors`` under
    their JAX paths, the MoE shape in ``config.json``: each package
    reloads the other's export to the same weights."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto

    if family == "bert":
        jmodel, params, model = _bert_pair()
        task = "seq-cls"
    else:
        jmodel, params, model = gpt2_pair(num_experts=4, expert_top_k=2, vocab=256)
        task = "causal-lm"
    t_auto.save_pretrained(str(tmp_path / "port"), model, family, model.config)
    j_auto.save_pretrained(str(tmp_path / "jax"), params, family, jmodel.config)
    for name in ("config.json",):
        assert json.load(open(tmp_path / "port" / name)) == \
            json.load(open(tmp_path / "jax" / name))
    _, jp, _, jcfg = j_auto.from_pretrained(str(tmp_path / "port"), task=task)
    assert jcfg.num_experts == 4
    want = {k: v for k, v in _flat(params).items() if "/moe/" in k}
    got = {k: v for k, v in _flat(jp).items() if "/moe/" in k}
    assert set(got) == set(want) and len(want) == 3
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    back, _, cfg = t_auto.from_pretrained(str(tmp_path / "jax"), task=task, device="cpu")
    assert cfg.num_experts == 4
    for k, v in model.state_dict().items():
        if ".moe." in k or family == "gpt2":
            assert torch.equal(back.state_dict()[k], v), k


def test_sidecar_layout_mismatch_refuses_as_jax_does(tmp_path):
    """JAX ``tests/test_moe.py``: reloading an MoE export with another
    ``moe_every`` fails loudly (a dense FFN missing, or the sidecar off
    the model's banks) in both packages."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto

    jmodel, params, model = _bert_pair(num_layers=4)          # experts at 1, 3
    t_auto.save_pretrained(str(tmp_path / "moe4"), model, "bert", model.config)
    with pytest.raises(ValueError, match="sidecar|missing"):
        j_auto.from_pretrained(str(tmp_path / "moe4"), task="seq-cls", moe_every=4)
    with pytest.raises(ValueError, match="sidecar|missing"):
        t_auto.from_pretrained(str(tmp_path / "moe4"), task="seq-cls", moe_every=4,
                               device="cpu")
    # the sidecar's own check: more experts than it holds
    with pytest.raises(ValueError, match="shape mismatch"):
        t_auto.from_pretrained(str(tmp_path / "moe4"), task="seq-cls", num_experts=8,
                               device="cpu")


def test_moe_refused_for_unsupported_families(tmp_path):
    d = tmp_path / "albert"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "model_type": "albert", "vocab_size": 128, "hidden_size": 32,
        "embedding_size": 16, "num_hidden_layers": 2, "num_attention_heads": 4,
        "intermediate_size": 64, "max_position_embeddings": 32}))
    with pytest.raises(ValueError, match="not supported"):
        t_auto.from_pretrained(str(d), task="seq-cls", num_experts=4, device="cpu")


def test_decoders_refuse_mixtral_as_jax_does():
    """JAX ``tests/test_mixtral.py``: chunked prefill, speculation (target
    or draft) and beam search refuse MoE models with JAX's messages."""
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import generate as j_gen

    jm, jp, moe = llama_pair(num_experts=2, num_layers=2)
    jd, jdp, dense = llama_pair(num_layers=1)
    ids = np.ones((1, 8), np.int64) * 5
    calls = [
        (lambda: j_gen.generate_speculative(jm, jp, jd, jdp, jnp.asarray(ids)),
         lambda: t_gen.generate_speculative(moe, dense, ids)),
        (lambda: j_gen.generate_speculative(jd, jdp, jm, jp, jnp.asarray(ids)),
         lambda: t_gen.generate_speculative(dense, moe, ids)),
        (lambda: j_gen.generate_causal(jm, jp, jnp.asarray(ids), prefill_chunk=4),
         lambda: t_gen.generate_causal(moe, ids, prefill_chunk=4)),
        (lambda: j_gen.beam_search_causal(jm, jp, jnp.asarray(ids)),
         lambda: t_gen.beam_search_causal(moe, ids)),
    ]
    for jax_call, port_call in calls:
        with pytest.raises(ValueError, match="capacity") as want:
            jax_call()
        with pytest.raises(ValueError, match="capacity") as got:
            port_call()
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("family", ["mixtral", "gpt2"])
def test_pipelined_moe_names_item_11(family):
    """Where the JAX package refuses pipelined MoE with a ValueError, the
    port has no pipeline stages at all: NotImplementedError, item 11."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.gpt2 import Gpt2Config
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.llama import (
        LlamaConfig,
    )

    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 11"):
        if family == "mixtral":
            LlamaConfig(num_experts=2, model_type="mixtral", pipeline_stages=2)
        else:
            Gpt2Config(num_experts=4, pipeline_stages=2)


def test_causal_priority_leaks_no_future_token():
    """Under heavy congestion, changing the last token changes no earlier
    position's output with position-major priority, and does with
    round-major (JAX ``tests/test_moe.py``)."""
    cfg = EncoderConfig(**{**MOE, "expert_capacity_factor": 0.3})
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, SEQ, 32, generator=gen)
    x2 = x.clone()
    x2[:, -1] = torch.randn(2, 32, generator=gen)
    for causal in (True, False):
        torch.manual_seed(1)
        mod = t_moe.MoeFeedForward(cfg, causal=causal).eval()
        with torch.no_grad():
            for p in mod.parameters():
                p.normal_(0, 0.5, generator=gen)
            y, y2 = mod(x), mod(x2)
        assert torch.equal(y[:, :-1], y2[:, :-1]) == causal


# -- training -------------------------------------------------------------------------

TRAIN_KW = dict(epochs=1, dtype="float32", learning_rate=1e-3, scale_lr_by_world_size=False,
                weight_decay=0.01, max_grad_norm=1.0, warmup_ratio=0.4, lr_schedule="cosine",
                log_every_steps=0)


def _batches(task, vocab, n=5, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids, mask = _batch(rng.randint(1 << 20), vocab=vocab)
        if task == "seq-cls":
            out.append({"input_ids": ids, "attention_mask": mask,
                        "token_type_ids": np.zeros_like(ids),
                        "labels": rng.randint(0, 2, (ids.shape[0],)).astype(np.int32)})
        else:
            out.append({"input_ids": ids, "attention_mask": mask,
                        "labels": np.where(mask > 0, ids, -100).astype(np.int32)})
    return out


@pytest.mark.parametrize("case", ["bert", "gpt2", "gpt2_fused", "mixtral"])
def test_five_steps_with_the_aux_loss_match_jax_trainer(case):
    """The aux loss joins the task loss on the plain and the fused CE
    paths; the port's curve is the JAX Trainer's (aux coefficient 1.0 on
    GPT-2, so the aux term shows)."""
    import jax
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig as JTC
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.train import Trainer as JTrainer
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer

    fused = case == "gpt2_fused"
    if case == "bert":
        jmodel, params, model = _bert_pair()
        task, vocab = "seq-cls", 256
    elif case.startswith("gpt2"):
        jmodel, params, model = gpt2_pair(num_experts=4, expert_top_k=2, vocab=256,
                                          hidden_size=128, intermediate_size=128,
                                          router_aux_coef=1.0) if fused else \
            gpt2_pair(num_experts=4, expert_top_k=2, vocab=256, router_aux_coef=1.0)
        task, vocab = "causal-lm", 256
    else:
        jmodel, params, model = llama_pair(num_experts=4, num_layers=2)
        task, vocab = "causal-lm", 128
    kw = dict(TRAIN_KW, task=task, fused_vocab_ce=fused, num_experts=4)
    batches = _batches(task, vocab)
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jt = JTrainer(JTC(**kw), jmodel, params, mesh, total_steps=5)
    model.requires_grad_(True)
    pt = Trainer(TrainConfig(**kw), model, total_steps=5)
    want, got = [], []
    for b in batches:
        jt.state, m = jt._train_step(jt.state, {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(jax.device_get(m["loss"])))
        got.append(float(pt.train_step({k: torch.from_numpy(v).long() for k, v in b.items()})
                         ["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert t_moe.moe_aux_loss(model) is None        # every step read its aux


def test_mixtral_greedy_decode_equals_full_forward():
    """JAX ``tests/test_mixtral.py``: at a capacity that cannot bind,
    greedy ``generate_causal`` is the full forward's argmax a token at a
    time, and equals JAX's."""
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import generate as j_gen

    jm, jp, model = llama_pair(num_experts=4, num_layers=2, expert_capacity_factor=NO_DROP)
    ids = np.random.RandomState(2).randint(3, 128, (2, 6))
    got = t_gen.generate_causal(model, ids, max_new_tokens=5)
    cur = torch.from_numpy(ids).long()
    with torch.no_grad():
        for _ in range(5):
            cur = torch.cat([cur, model(cur)[:, -1].argmax(-1, keepdim=True)], 1)
    want = cur[:, 6:]
    for b in range(2):
        row = want[b].tolist()
        upto = row.index(2) + 1 if 2 in row else 5
        assert got[b, :upto].tolist() == row[:upto]
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_gen.generate_causal(jm, jp, jnp.asarray(ids),
                                                      max_new_tokens=5)))


def test_gpt2_moe_residual_flow_init():
    """JAX ``tests/test_moe.py``: the expert bank's ``wo`` takes GPT-2's
    1/sqrt(2·n_layer) residual-flow std, ``wi`` and the router the plain
    ``initializer_range``."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import init_gpt2
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.gpt2 import Gpt2Config

    cfg = Gpt2Config(vocab_size=256, hidden_size=64, num_layers=8, num_heads=4,
                     intermediate_size=128, max_position_embeddings=SEQ, num_experts=4)
    sd = init_gpt2(cfg, device="cpu").state_dict()
    resid = cfg.initializer_range / (2 * cfg.num_layers) ** 0.5
    assert float(sd["backbone.h.1.moe.wo"].std()) == pytest.approx(resid, rel=0.15)
    for key in ("wi", "router"):
        assert float(sd[f"backbone.h.1.moe.{key}"].std()) == pytest.approx(
            cfg.initializer_range, rel=0.15)


def _aux_step(model, batch) -> dict:
    """One port ``Trainer`` step of ``model`` on ``batch`` (fp32, no
    clipping): its loss and the routers' gradients as the optimizer sees
    them (after the data-parallel mean)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer

    model.requires_grad_(True)
    trainer = Trainer(TrainConfig(**dict(TRAIN_KW, max_grad_norm=0.0, task="causal-lm",
                                         num_experts=4)), model, total_steps=1)
    grads, step = {}, trainer.optimizer.step

    def recorded(*args, **kwargs):
        grads.update({n: p.grad.detach().clone() for n, p in model.named_parameters()
                      if n.endswith("router")})
        return step(*args, **kwargs)

    trainer.optimizer.step = recorded
    batch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    return {"loss": float(trainer.train_step(batch)["loss"]), "grads": grads}


def _save_model(model, path) -> None:
    torch.save({"cls": type(model), "config": model.config, "state": model.state_dict()}, path)


def _load_model(path):
    saved = torch.load(path, weights_only=False)
    model = saved["cls"](saved["config"])
    model.load_state_dict(saved["state"], strict=True)
    return model.eval()


def _aux_dp_worker(rank, world, port, model_path, batch_path, out_path):
    """One data-parallel rank: its half of the global batch's rows."""
    import os

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank))
    torch.set_num_threads(1)
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )

    initialize_distributed("cpu")
    try:
        batch = dict(np.load(batch_path))
        n = batch["input_ids"].shape[0] // world
        out = _aux_step(_load_model(model_path),
                        {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()})
        torch.save(out, out_path)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def test_aux_loss_under_two_gloo_processes_is_the_global_batchs(tmp_path):
    """GPT-2 MoE (aux coefficient 1, routers scaled 50x so routing follows
    the tokens) with the two ranks' rows drawn from the two halves of the
    vocabulary, so each rank's experts are loaded unevenly and the mean of
    the ranks' own aux losses is not the global batch's. Two gloo ranks
    give the loss and the router gradients of one process on the global
    batch (1e-6 relative, fp32), and those of the JAX Trainer's loss on the
    same weights (1e-5 relative: the frameworks sum in other orders)."""
    import multiprocessing as mp
    import socket

    import jax
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig as JTC
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.train import Trainer as JTrainer
    from torch_decode_pairs import port_of

    jmodel, params, _ = gpt2_pair(num_experts=4, expert_top_k=2, vocab=256,
                                  router_aux_coef=1.0)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 50.0 if "router" in jax.tree_util.keystr(path) else x, params)
    model = port_of(jmodel, params)
    rng = np.random.RandomState(5)
    ids = np.concatenate([rng.randint(3, 128, (2, SEQ)), rng.randint(128, 256, (2, SEQ))])
    batch = {"input_ids": ids.astype(np.int32), "attention_mask": np.ones_like(ids, np.int32),
             "labels": ids.astype(np.int32)}
    model_path, batch_path = tmp_path / "model.pt", tmp_path / "batch.npz"
    _save_model(model, model_path)
    np.savez(batch_path, **batch)
    want = _aux_step(_load_model(model_path), batch)

    # the rows are unbalanced: the ranks' own aux losses average elsewhere
    probe = _load_model(model_path)
    with torch.no_grad():
        halves = []
        for r in range(2):
            probe(torch.from_numpy(ids[2 * r:2 * r + 2]).long())
            halves.append(float(t_moe.moe_aux_loss(probe)))
        probe(torch.from_numpy(ids).long())
        whole = float(t_moe.moe_aux_loss(probe))
    assert abs(np.mean(halves) - whole) > 1e-2 * whole

    ctx = mp.get_context("spawn")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=_aux_dp_worker,
                         args=(r, 2, port, str(model_path), str(batch_path),
                               str(tmp_path / f"{r}.pt"))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs)
    ranks = [torch.load(str(tmp_path / f"{r}.pt")) for r in range(2)]
    for got in ranks:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        assert got["grads"].keys() == want["grads"].keys() and want["grads"]
        for name, g in want["grads"].items():
            assert float((got["grads"][name] - g).norm() / g.norm()) <= 1e-6, name

    # the JAX Trainer's loss (task + sown aux) and its router gradients
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jt = JTrainer(JTC(**dict(TRAIN_KW, task="causal-lm", num_experts=4)), jmodel, params,
                  mesh, total_steps=5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_of(p):
        sown = []

        def apply_fn(variables, *a, **kw):
            out, mut = jmodel.apply(variables, *a, mutable=["losses"], **kw)
            sown.append(mut.get("losses", {}))
            return out

        loss, _ = jt.loss_fn(apply_fn, p, jbatch, {"dropout": jax.random.PRNGKey(0)}, True)
        return loss + sum(jnp.asarray(x, jnp.float32) for x in jax.tree.leaves(sown))

    jloss, jgrads = jax.value_and_grad(loss_of)(params)
    np.testing.assert_allclose(want["loss"], float(jloss), rtol=1e-5)
    flat = {jax.tree_util.keystr(path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]
            if "router" in jax.tree_util.keystr(path)}
    assert len(flat) == len(want["grads"])
    for name, g in want["grads"].items():
        layer = name.split(".")[2]          # backbone.h.<i>.moe.router
        (jg,) = [v for k, v in flat.items() if f"['h_{layer}']" in k]
        rel = np.linalg.norm(g.numpy() - jg) / np.linalg.norm(jg)
        assert rel <= 1e-5, (name, rel)
