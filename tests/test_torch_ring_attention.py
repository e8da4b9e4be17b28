"""PyTorch port: ring attention and the ``seq`` mesh axis
(``parallel/ring_attention.py``, ``parallel/collectives.py``'s ring shift
and gather, the models' sequence split, the Trainer, the batcher and the
CLI under ``sp > 1``) held against one process, the port's plain attention
and the JAX ring on the same inputs.

Each world is a gloo CPU world of spawned processes
(``tests/torch_ring_worker.py``), spawned once for this module, one intra-op
thread a rank; every assertion is a parametrised case over its results.

- The ring itself, a world of 4 (``dp 1 × sp 4``): each rank attends its
  block of the queries, the blocks gathered. Against JAX ``ring_attention``
  on the 8-device mesh (``MeshConfig(dp=2, sp=4)``) and the port's plain
  attention at atol 1e-5: no mask, a padding mask, causal, causal with
  padding at S 512, T5's bias tiles; the three gradients of ``sum(out**2)``
  against JAX's ``value_and_grad`` at atol 2e-5; bf16 against the fp32
  reference at JAX's tolerance (3e-2); GQA's un-repeated K/V heads; the
  indivisible-``S`` ``ValueError``; the gathered route of a banded mask
  against JAX's ``ring_attention_or_fallback``.
- The ring shapes of ``chip_smoke.py``'s ring_train phase (``CHIP_SHAPES``:
  the same sequence, heads and head width) over ``sp`` 2 against the plain
  attention, at atol 1e-5.
- Training, a world of 4 (``dp 2 × sp 2``), weights the JAX package
  initialised (carried with ``params_from_jax``): BERT seq-cls, GPT-2 and
  Llama-GQA causal-LM (fused CE), T5 seq2seq, 3 fp32 steps each. Losses
  within 1e-5 relative of one process, the first update's gradients within
  1e-5 relative L2, losses within 2e-5 of the JAX ``Trainer`` on the same
  mesh, the evaluation equal to one process's, T5's greedy generation under
  the mesh equal to the plain path's tokens, the replica check over ``data``
  and ``seq`` 0.0.
- All axes but data, a world of 8 (``fsdp 2 × sp 2 × tp 2``): a 2-layer BERT,
  3 steps, against one process and the JAX ``Trainer`` at
  ``MeshConfig(dp=1, fsdp=2, sp=2, tp=2)``.
- The CLI: ``--sp 2`` under the launcher over two gloo processes against
  one process, and the ``--segment_packing`` refusal.
- Single-process cases: ``ring`` at ``sp`` 1 equals the plain path in
  every family; ``resolve_attention_impl`` and the flash-with-``sp`` error
  as JAX's; the batcher's bucket check; what still raises under ``sp > 1``.
"""

import json
import multiprocessing as mp
import os
import re
import socket

import numpy as np
import pytest
import torch

import torch_ring_worker as worker
from huggingface_sagemaker_tensorflow_distributed_tpu_torch import config as t_config
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import pipeline as t_pipe
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import sources as t_src
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import tokenization as t_tok
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto as t_auto
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
    params_from_jax,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.attention import (
    make_attention_mask,
    make_banded_causal_mask,
    make_causal_mask,
    relative_position_bias,
    xla_attention,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel import mesh as t_mesh
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel import sharding
from torch_decode_pairs import detached_compile_trackers  # noqa: F401  (autouse)

ITEM_11 = r"ROADMAP queue 1, item 11\b"
WORLD_TIMEOUT_S = 240
RING_SHAPE = (1, 1, 4, 1)          # (dp, fsdp, sp, tp)
TRAIN_SHAPE = (2, 1, 2, 1)
AXES_SHAPE = (1, 2, 2, 2)
LR = 1e-3
STEPS = 3
SEQ = 32
TGT = 8
VOCAB = 300
TRAIN_KW = dict(epochs=1, dtype="float32", learning_rate=LR, scale_lr_by_world_size=False,
                weight_decay=0.01, max_grad_norm=1.0, warmup_ratio=0.4, lr_schedule="cosine",
                log_every_steps=0)
CONFIGS = {
    "bert": dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                 intermediate_size=128, max_position_embeddings=SEQ,
                 hidden_dropout=0.0, attention_dropout=0.0),
    "gpt2": dict(vocab_size=VOCAB, hidden_size=128, num_layers=2, num_heads=4,
                 intermediate_size=256, max_position_embeddings=64, hidden_dropout=0.0,
                 embd_dropout=0.0, attention_dropout=0.0, eos_token_id=VOCAB - 1,
                 pad_token_id=0),
    "llama": dict(vocab_size=VOCAB, hidden_size=128, num_layers=2, num_heads=8,
                  num_kv_heads=4, intermediate_size=256, max_position_embeddings=64),
    "t5": dict(vocab_size=512, d_model=64, d_kv=16, d_ff=128, num_layers=2,
               num_decoder_layers=2, num_heads=4, relative_attention_num_buckets=8,
               relative_attention_max_distance=20, dropout_rate=0.0),
}
FAMILIES = tuple(CONFIGS)
TASKS = {"bert": dict(task="seq-cls"), "gpt2": dict(task="causal-lm", fused_vocab_ce=True),
         "llama": dict(task="causal-lm", fused_vocab_ce=True),
         # T5's own optimizer: Adam turns the rounding of its near-zero
         # gradient entries into whole steps (ROADMAP queue 3, known traps)
         "t5": dict(task="seq2seq", optimizer="adafactor", weight_decay=0.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- worlds --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(shape: tuple, spec: dict, out) -> list:
    """Spawn the world of ``shape`` on ``spec``; its processes."""
    spec_path = str(out / "spec.pt")
    torch.save(spec, spec_path)
    ctx = mp.get_context("spawn")
    port, world = _free_port(), int(np.prod(shape))
    procs = [ctx.Process(target=worker.run_world,
                         args=(r, world, port, shape, spec_path, str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join(procs: list, out, what: str) -> dict:
    for p in procs:
        p.join(timeout=WORLD_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, f"{what}: a rank ran past {WORLD_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * len(procs), what
    return torch.load(str(out / "results.pt"), weights_only=False)


# -- the ring itself ---------------------------------------------------------------

B, H, D = 2, 4, 8
RING_CASES = ("plain", "padding", "causal", "causal_padding_512", "t5_bias", "grads",
              "bf16", "gqa", "banded")
JAX_CASES = ("plain", "padding", "causal", "causal_padding_512", "t5_bias")
T5_SPEC = (True, 32, 128)
WINDOW = 8


def _padding(rows: int, s: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    am = (rng.rand(rows, s) > 0.3).astype(np.float32)
    am[:, :4] = 1                      # no fully masked row
    return np.asarray(make_attention_mask(torch.from_numpy(am)))


def _ring_cases() -> dict:
    """Every ``attention`` case: whole float64 inputs (cast by the ranks)."""
    def qkv(seed, s=SEQ, h=H, kv_heads=H):
        rng = np.random.RandomState(seed)
        return dict(q=rng.randn(B, h, s, D), k=rng.randn(B, kv_heads, s, D),
                    v=rng.randn(B, kv_heads, s, D))

    rng = np.random.RandomState(9)
    return {
        "plain": dict(qkv(0)),
        "padding": dict(qkv(1), mask=_padding(B, SEQ, 1)),
        "causal": dict(qkv(2), causal=True),
        "causal_padding_512": dict(qkv(3, s=512, h=2, kv_heads=2), causal=True,
                                   mask=_padding(B, 512, 3)),
        "t5_bias": dict(qkv(4), mask=_padding(B, SEQ, 4), scale=1.0,
                        table=rng.randn(T5_SPEC[1], H).astype(np.float32), spec=T5_SPEC),
        "grads": dict(qkv(5), mask=_padding(B, SEQ, 5), grad=True),
        "bf16": dict(qkv(6), dtype=torch.bfloat16),
        "gqa": dict(qkv(7, kv_heads=2), causal=True, mask=_padding(B, SEQ, 7)),
        "banded": dict(qkv(8), causal=True,
                       mask=np.asarray(make_banded_causal_mask(SEQ, WINDOW))
                       + _padding(B, SEQ, 8)),
    }


def _plain_reference(case: dict, heads_at_once: int = 8) -> torch.Tensor:
    """The port's plain attention on the whole fp32 inputs, ``heads_at_once``
    heads at a time (a chip shape's ``[S, S]`` logits stay small)."""
    q, k, v = (torch.from_numpy(case[n]).float() for n in ("q", "k", "v"))
    h, s = q.shape[1], q.shape[2]
    k, v = (t.repeat_interleave(h // t.shape[1], dim=1) for t in (k, v))
    mask = None if case.get("mask") is None else torch.from_numpy(case["mask"]).float()
    if case.get("causal"):
        cm = make_causal_mask(s)
        mask = cm if mask is None else mask + cm
    table = None if case.get("table") is None else torch.from_numpy(case["table"])
    outs = []
    for lo in range(0, h, heads_at_once):
        part = mask
        if table is not None:
            bias = relative_position_bias(table[:, lo:lo + heads_at_once],
                                          torch.arange(s)[:, None], torch.arange(s)[None, :],
                                          bidirectional=True, num_buckets=T5_SPEC[1],
                                          max_distance=T5_SPEC[2])
            part = bias if part is None else part + bias
        heads = slice(lo, lo + heads_at_once)
        outs.append(xla_attention(q[:, heads], k[:, heads], v[:, heads], mask=part,
                                  scale=case.get("scale")))
    return torch.cat(outs, dim=1)


# the ring shapes of chip_smoke.py's ring_train phase at sp 2, each a case of
# the training world (sp 2) here: the sequence, query heads, K/V heads and
# head width of one layer's attention; one row, random inputs
CHIP_SHAPES = {"bert_large_wwm": dict(s=512, h=16, kv=16, d=64, mask=True),
               "tinyllama": dict(s=4096, h=32, kv=4, d=64, causal=True),
               "t5_small": dict(s=512, h=8, kv=8, d=64, mask=True, t5=True)}


def _chip_shape_case(name: str) -> dict:
    shape = CHIP_SHAPES[name]
    rng = np.random.RandomState(11)
    s, h, kv, d = shape["s"], shape["h"], shape["kv"], shape["d"]
    case = dict(q=rng.randn(1, h, s, d), k=rng.randn(1, kv, s, d), v=rng.randn(1, kv, s, d),
                causal=shape.get("causal", False))
    if shape.get("mask"):
        case["mask"] = _padding(1, s, 11)
    if shape.get("t5"):
        case.update(scale=1.0, table=rng.randn(T5_SPEC[1], h).astype(np.float32),
                    spec=T5_SPEC)
    return case


def _jax_ring(case: dict, mesh, grads: bool = False):
    """JAX ``ring_attention`` on the global fp32 arrays (the output, or the
    loss and the three gradients of ``sum(out ** 2)``)."""
    import jax
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import ring_attention

    q, k, v = (jnp.asarray(case[n], jnp.float32) for n in ("q", "k", "v"))
    mask = None if case.get("mask") is None else jnp.asarray(case["mask"])
    table = None if case.get("table") is None else jnp.asarray(case["table"])

    def fn(q, k, v):
        return ring_attention(q, k, v, mask=mask, scale=case.get("scale"), mesh=mesh,
                              causal=case.get("causal", False), rel_bias_table=table,
                              rel_bias_spec=case.get("spec"))

    if grads:
        return jax.jit(jax.value_and_grad(lambda *a: jnp.sum(fn(*a) ** 2),
                                          argnums=(0, 1, 2)))(q, k, v)
    return jax.jit(fn)(q, k, v)


@pytest.fixture(scope="module")
def jax_ring_mesh(devices8):
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
    )

    return build_mesh(MeshConfig(dp=2, sp=4), devices=devices8)


# -- training ---------------------------------------------------------------------

def _jax_model(family: str, cfg: dict, impl: str):
    import jax.numpy as jnp

    if family == "bert":
        from huggingface_sagemaker_tensorflow_distributed_tpu.models.bert import (
            BertForSequenceClassification,
        )
        from huggingface_sagemaker_tensorflow_distributed_tpu.models.layers import (
            EncoderConfig,
        )
        jcfg = EncoderConfig(dtype=jnp.float32, attention_impl=impl, **cfg)
        return BertForSequenceClassification(jcfg, num_labels=2), jcfg
    if family == "gpt2":
        from huggingface_sagemaker_tensorflow_distributed_tpu.models.gpt2 import (
            Gpt2Config,
            Gpt2LMHeadModel,
        )
        jcfg = Gpt2Config(dtype=jnp.float32, attention_impl=impl, **cfg)
        return Gpt2LMHeadModel(jcfg), jcfg
    if family == "llama":
        from huggingface_sagemaker_tensorflow_distributed_tpu.models.llama import (
            LlamaConfig,
            LlamaForCausalLM,
        )
        jcfg = LlamaConfig(dtype=jnp.float32, attention_impl=impl, **cfg)
        return LlamaForCausalLM(jcfg), jcfg
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.t5 import (
        T5Config,
        T5ForConditionalGeneration,
    )
    jcfg = T5Config(dtype=jnp.float32, attention_impl=impl, **cfg)
    return T5ForConditionalGeneration(jcfg), jcfg


def _jax_pair(family: str, cfg: dict):
    """(JAX ring model, its params, the port's weights)."""
    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.auto import init_params

    plain, jcfg = _jax_model(family, cfg, "xla")
    params = init_params(plain, jcfg, seed=0) if family in ("llama", "t5") else \
        init_params(plain, seed=0)
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    return _jax_model(family, cfg, "ring")[0], params, params_from_jax(flat)


def _columns() -> dict:
    texts, labels = t_src.synthetic_text_classification(48, seed=1)
    cls = t_pipe.ArrayDataset.from_texts(t_tok.WordHashTokenizer(512), texts, labels, SEQ)
    # varied lengths: the rows hold different numbers of valid tokens
    lm_texts = [" ".join(t.split()[:3 + 5 * (i % 7)]) for i, t in enumerate(texts)]
    lm = t_pipe.ArrayDataset.from_lm_texts(t_tok.WordHashTokenizer(VOCAB), lm_texts, SEQ)
    docs, sums = t_src.synthetic_summarization(48, seed=1)
    s2s = t_pipe.ArrayDataset.from_seq2seq(
        t_tok.WordHashTokenizer(512), docs, sums, max_source_length=SEQ,
        max_target_length=TGT, decoder_start_token_id=0, pad_token_id=0, eos_token_id=1)
    return {"bert": cls.columns, "gpt2": lm.columns, "llama": lm.columns, "t5": s2s.columns}


def _case(family: str, state: dict, columns: dict, impl: str, config=None) -> dict:
    return dict(family=family, config=dict(config or CONFIGS[family], attention_impl=impl),
                state=state, train=dict(TRAIN_KW, **TASKS[family]), columns=columns,
                steps=STEPS, scenario="curve")


def _generate_case(state: dict, columns: dict, impl: str) -> dict:
    return dict(config=dict(CONFIGS["t5"], attention_impl=impl), state=state,
                input_ids=columns["input_ids"][:4], attention_mask=columns["attention_mask"][:4],
                new=6, scenario="generate")


def _jax_losses(jmodel, params, case: dict, shape: tuple, devices) -> list:
    """The JAX ``Trainer``'s losses on ``case``'s batches over the mesh of
    ``shape`` (dp, fsdp, sp, tp)."""
    import jax
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel.sharding import (
        batch_sharding,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.train import Trainer as JaxTrainer

    dp, fsdp, sp, tp = shape
    mesh = build_mesh(MeshConfig(dp=dp, fsdp=fsdp, sp=sp, tp=tp),
                      devices=devices[:int(np.prod(shape))])
    jtrainer = JaxTrainer(TrainConfig(**case["train"], dp=dp, fsdp=fsdp, sp=sp, tp=tp),
                          jmodel, jax.tree_util.tree_map(jnp.array, params), mesh,
                          total_steps=STEPS)
    losses = []
    for batch in worker.mesh_worker.batches(case["columns"], STEPS):
        arrays = {k: jax.device_put(v.numpy().astype(np.int32), batch_sharding(mesh))
                  for k, v in batch.items()}
        jtrainer.state, m = jtrainer._train_step(jtrainer.state, arrays)
        losses.append(float(jax.device_get(m["loss"])))
    return losses


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, devices8, jax_ring_mesh):
    """The ring world and the training world, spawned together; meanwhile in
    this process the references: JAX's ring, the one-process runs (plain
    attention) and the JAX Trainer's losses on the training mesh."""
    ring = _ring_cases()
    ring_spec = {n: dict(c, scenario="attention") for n, c in ring.items()}
    ring_spec["indivisible"] = dict(length=30, scenario="indivisible")
    columns = _columns()
    pairs = {f: _jax_pair(f, CONFIGS[f]) for f in FAMILIES}
    train_spec = {f: _case(f, pairs[f][2], columns[f], "ring") for f in FAMILIES}
    train_spec["generate"] = _generate_case(pairs["t5"][2], columns["t5"], "ring")
    chip = {n: _chip_shape_case(n) for n in CHIP_SHAPES}
    train_spec.update({f"chip_{n}": dict(c, scenario="attention") for n, c in chip.items()})
    outs = {n: tmp_path_factory.mktemp(n) for n in ("ring", "train")}
    procs = {"ring": _start(RING_SHAPE, ring_spec, outs["ring"]),
             "train": _start(TRAIN_SHAPE, train_spec, outs["train"])}
    try:
        refs = {"plain": {n: _plain_reference(c) for n, c in ring.items()},
                "jax": {n: np.asarray(_jax_ring(ring[n], jax_ring_mesh)) for n in JAX_CASES},
                "jax_grads": _jax_ring(ring["grads"], jax_ring_mesh, grads=True),
                "chip": {n: _plain_reference(c) for n, c in chip.items()},
                "one": {f: worker.run_curve(_case(f, pairs[f][2], columns[f], "xla"))
                        for f in FAMILIES},
                "generate": worker.run_generate(_generate_case(pairs["t5"][2], columns["t5"],
                                                               "xla")),
                "jax_losses": {f: _jax_losses(pairs[f][0], pairs[f][1], train_spec[f],
                                              TRAIN_SHAPE, devices8) for f in FAMILIES}}
    finally:
        results = {n: _join(p, outs[n], n) for n, p in procs.items()}
    return results, refs


@pytest.mark.parametrize("case", JAX_CASES)
def test_ring_matches_the_jax_ring(worlds, case):
    results, refs = worlds
    np.testing.assert_allclose(results["ring"][case]["out"].numpy(), refs["jax"][case],
                               atol=1e-5)


@pytest.mark.parametrize("case", [c for c in RING_CASES if c != "bf16"])
def test_ring_matches_the_plain_attention(worlds, case):
    results, refs = worlds
    np.testing.assert_allclose(results["ring"][case]["out"].numpy(),
                               refs["plain"][case].numpy(), atol=1e-5)


@pytest.mark.parametrize("which", range(3), ids=["dq", "dk", "dv"])
def test_ring_gradients_match_jax_value_and_grad(worlds, which):
    results, refs = worlds
    _, jgrads = refs["jax_grads"]
    np.testing.assert_allclose(results["ring"]["grads"]["grads"][which].numpy(),
                               np.asarray(jgrads[which]), atol=2e-5)


def test_ring_bf16_close_to_the_fp32_reference(worlds):
    results, refs = worlds
    out = results["ring"]["bf16"]["out"]
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), refs["plain"]["bf16"].numpy(), atol=3e-2)


def test_indivisible_sequence_raises_the_jax_error(worlds, jax_ring_mesh):
    """The port splits the sequence where JAX's ring checks it: the same
    ``ValueError``."""
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import ring_attention

    results, _ = worlds
    with pytest.raises(ValueError) as err:
        x = jnp.zeros((2, 1, 30, 8))
        ring_attention(x, x, x, mesh=jax_ring_mesh)
    assert results["ring"]["indivisible"]["error"] == str(err.value)


def test_gathered_route_of_a_banded_mask_matches_jax(worlds, jax_ring_mesh):
    """A general ``[b, 1, S, S]`` mask (Mistral's band) under ``sp`` 4: K and
    V gathered over ``seq``, against JAX's ``ring_attention_or_fallback``
    under the mesh."""
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import use_mesh
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel.ring_attention import (
        ring_attention_or_fallback,
    )

    results, _ = worlds
    case = _ring_cases()["banded"]
    q, k, v = (jnp.asarray(case[n], jnp.float32) for n in ("q", "k", "v"))
    with use_mesh(jax_ring_mesh):
        want = ring_attention_or_fallback(q, k, v, mask=jnp.asarray(case["mask"]),
                                          causal=True)
    np.testing.assert_allclose(results["ring"]["banded"]["out"].numpy(), np.asarray(want),
                               atol=1e-5)


@pytest.mark.parametrize("name", list(CHIP_SHAPES))
def test_chip_ring_shapes_match_the_plain_attention(worlds, name):
    """Each ring shape the card's ring_train phase launches, over ``sp`` 2."""
    results, refs = worlds
    np.testing.assert_allclose(results["train"][f"chip_{name}"]["out"].numpy(),
                               refs["chip"][name].numpy(), atol=1e-5)


def _flat(tensors: dict) -> torch.Tensor:
    return torch.cat([tensors[k].reshape(-1).double() for k in sorted(tensors)])


def _rel_l2(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    return float(torch.linalg.vector_norm(_flat(got) - _flat(want))
                 / torch.linalg.vector_norm(_flat(want)))


@pytest.mark.parametrize("family", FAMILIES)
def test_sp_losses_match_one_process(worlds, family):
    results, refs = worlds
    np.testing.assert_allclose(results["train"][family]["losses"],
                               refs["one"][family]["losses"], rtol=1e-5)
    assert len(set(np.round(refs["one"][family]["losses"], 6))) == STEPS


@pytest.mark.parametrize("family", FAMILIES)
def test_sp_first_update_gradients_match_one_process(worlds, family):
    results, refs = worlds
    err = _rel_l2(results["train"][family]["grads"], refs["one"][family]["grads"])
    assert err <= 1e-5, err


@pytest.mark.parametrize("family", FAMILIES)
def test_sp_losses_match_the_jax_trainer_on_the_same_mesh(worlds, family):
    results, refs = worlds
    np.testing.assert_allclose(results["train"][family]["losses"],
                               refs["jax_losses"][family], atol=2e-5)


@pytest.mark.parametrize("family", FAMILIES)
def test_sp_evaluation_equals_one_process(worlds, family):
    results, refs = worlds
    got, want = results["train"][family]["eval"], refs["one"][family]["eval"]
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-5, err_msg=key)


def test_t5_generation_under_the_seq_mesh_equals_the_plain_tokens(worlds):
    results, refs = worlds
    assert torch.equal(results["train"]["generate"]["tokens"], refs["generate"]["tokens"])


@pytest.mark.parametrize("family", FAMILIES)
def test_replica_check_over_data_and_seq_is_zero(worlds, family):
    results, _ = worlds
    assert results["train"][family]["divergence"] == 0.0


# -- all axes but data ------------------------------------------------------------

@pytest.fixture(scope="module")
def axes_world(tmp_path_factory, devices8):
    """A 2-layer BERT over ``fsdp 2 × sp 2 × tp 2`` (8 ranks); meanwhile one
    process's run and the JAX Trainer's at the same mesh."""
    columns = _columns()
    jmodel, params, state = _jax_pair("bert", CONFIGS["bert"])
    case = _case("bert", state, columns["bert"], "ring")
    out = tmp_path_factory.mktemp("axes")
    procs = _start(AXES_SHAPE, {"bert": case}, out)
    try:
        refs = {"one": worker.run_curve(_case("bert", state, columns["bert"], "xla")),
                "jax": _jax_losses(jmodel, params, case, AXES_SHAPE, devices8)}
    finally:
        results = _join(procs, out, "fsdp2_sp2_tp2")
    return results["bert"], refs


@pytest.mark.parametrize("against", ["one_process", "jax_trainer", "gradients"])
def test_fsdp_sp_tp_world_matches(axes_world, against):
    got, refs = axes_world
    if against == "one_process":
        np.testing.assert_allclose(got["losses"], refs["one"]["losses"], rtol=1e-5)
    elif against == "jax_trainer":
        np.testing.assert_allclose(got["losses"], refs["jax"], atol=2e-5)
    else:
        assert _rel_l2(got["grads"], refs["one"]["grads"]) <= 1e-5
    assert got["divergence"] == 0.0


# -- the CLI -----------------------------------------------------------------------

CLI_GPT2 = {"model_type": "gpt2", "vocab_size": VOCAB, "n_positions": 64, "n_embd": 64,
            "n_layer": 2, "n_head": 4, "resid_pdrop": 0.0, "embd_pdrop": 0.0,
            "attn_pdrop": 0.0}


def _cli_argv(cfg_dir, out):
    return ["--model_name_or_path", str(cfg_dir), "--from_scratch", "true",
            "--task", "causal-lm", "--fused_vocab_ce", "true", "--dataset", "synthetic",
            "--max_seq_length", "32", "--max_train_samples", "32", "--max_eval_samples", "8",
            "--train_batch_size", "4", "--eval_batch_size", "4", "--epochs", "1",
            "--dtype", "float32", "--learning_rate", "1e-3",
            "--scale_lr_by_world_size", "false", "--log_every_steps", "0",
            "--output_data_dir", str(out / "output"), "--model_dir", str(out / "model")]


def test_cli_over_sp_matches_one_process(tmp_path):
    """``python -m <port>.launch --slice cpu-2 --num_hosts 2 ... --sp 2``: one
    replica whose two seq ranks share its rows, against one process at the
    same batch: the same results keys, the epoch loss within 1e-5."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.launch import (
        __main__ as t_launch,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.results import (
        read_results_file,
    )

    cfg_dir = tmp_path / "cfg"
    cfg_dir.mkdir()
    (cfg_dir / "config.json").write_text(json.dumps(CLI_GPT2))
    one = tmp_path / "one"
    cli.main(_cli_argv(cfg_dir, one) + ["--device", "cpu"])
    root = tmp_path / "jobs"
    assert t_launch.main(["--slice", "cpu-2", "--num_hosts", "2", "--job_root", str(root),
                          "--timeout", str(WORLD_TIMEOUT_S), "--sp", "2"]
                         + _cli_argv(cfg_dir, tmp_path / "unused")[:-4]) == 0
    (job,) = [root / d for d in os.listdir(root)]
    assert "sp=2: ring attention selected" in (job / "host_0.log").read_text()
    for name in ("train_results.txt", "eval_results.txt"):
        want = read_results_file(str(one / "output" / name))
        got = read_results_file(str(job / "output" / name))
        assert [k for k in got if k not in ("train_achieved_tflops_per_chip", "train_mfu")] \
            == list(want), name
    loss = [float(read_results_file(str(d / "train_results.txt"))["loss"].strip("[]"))
            for d in (job / "output", one / "output")]
    np.testing.assert_allclose(loss[0], loss[1], rtol=1e-5)


def test_cli_refuses_segment_packing_with_ring_as_jax(tmp_path):
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli

    cfg_dir = tmp_path / "cfg"
    cfg_dir.mkdir()
    (cfg_dir / "config.json").write_text(json.dumps(CLI_GPT2))
    with pytest.raises(ValueError, match=r"ring attention \(sp>1\) cannot shard"):
        cli.main(_cli_argv(cfg_dir, tmp_path) + ["--device", "cpu", "--sp", "2",
                                                  "--segment_packing", "true"])


# -- single process -------------------------------------------------------------------

HF = {
    "bert": {"model_type": "bert", "vocab_size": 256, "hidden_size": 64,
             "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 128,
             "max_position_embeddings": 32},
    "roberta": {"model_type": "roberta", "vocab_size": 256, "hidden_size": 64,
                "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 128,
                "max_position_embeddings": 34, "pad_token_id": 1, "type_vocab_size": 1},
    "distilbert": {"model_type": "distilbert", "vocab_size": 256, "dim": 64, "n_layers": 2,
                   "n_heads": 4, "hidden_dim": 128, "max_position_embeddings": 32},
    "electra": {"model_type": "electra", "vocab_size": 256, "embedding_size": 32,
                "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
                "intermediate_size": 128, "max_position_embeddings": 32},
    "albert": {"model_type": "albert", "vocab_size": 256, "embedding_size": 32,
               "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
               "intermediate_size": 128, "max_position_embeddings": 32},
    "deberta": {"model_type": "deberta-v2", "vocab_size": 256, "hidden_size": 64,
                "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 128,
                "max_position_embeddings": 32, "relative_attention": True,
                "position_buckets": 16, "share_att_key": True, "pos_att_type": "p2c|c2p",
                "norm_rel_ebd": "layer_norm", "position_biased_input": False},
    "gpt2": {"model_type": "gpt2", "vocab_size": 256, "n_positions": 32, "n_embd": 64,
             "n_layer": 2, "n_head": 4},
    "mistral": {"model_type": "mistral", "vocab_size": 256, "hidden_size": 64,
                "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 8,
                "num_key_value_heads": 4, "max_position_embeddings": 32,
                "sliding_window": 6},
    "t5": {"model_type": "t5", "vocab_size": 256, "d_model": 64, "d_kv": 16, "d_ff": 128,
           "num_layers": 2, "num_decoder_layers": 2, "num_heads": 4},
    "bart": {"model_type": "bart", "vocab_size": 256, "d_model": 64, "encoder_layers": 2,
             "decoder_layers": 2, "encoder_attention_heads": 4,
             "decoder_attention_heads": 4, "encoder_ffn_dim": 128,
             "decoder_ffn_dim": 128, "max_position_embeddings": 32},
}
# what has no sequence-parallel layout yet besides BART and DeBERTa: MoE layers
MIXTRAL = {"model_type": "mixtral", "vocab_size": 256, "hidden_size": 64,
           "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
           "num_key_value_heads": 2, "num_local_experts": 4, "num_experts_per_tok": 2,
           "max_position_embeddings": 32}
HF_TASKS = {"gpt2": "causal-lm", "mistral": "causal-lm", "mixtral": "causal-lm",
            "t5": "seq2seq", "bart": "seq2seq"}


def _hf_model(tmp_path, family: str, **kw):
    path = tmp_path / family
    path.mkdir(exist_ok=True)
    (path / "config.json").write_text(json.dumps({**HF, "mixtral": MIXTRAL}[family]))
    model, _, _ = t_auto.from_pretrained(str(path), task=HF_TASKS.get(family, "seq-cls"),
                                         from_scratch=True, seed=1, device="cpu", **kw)
    return model


def _forward(model, family: str, ids, mask):
    if family in ("t5", "bart"):
        return model(ids, mask, decoder_input_ids=ids[:, :8])
    out = model(ids, mask)
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("family", list(HF))
def test_ring_at_sp_1_equals_the_plain_path(tmp_path, family):
    """Without a ``seq`` axis ``attention_impl='ring'`` is the plain
    attention (bias and causal mask whole), in every family: BART and
    DeBERTa, which have no ring site, included."""
    plain = _hf_model(tmp_path, family, attention_impl="xla")
    ring = _hf_model(tmp_path, family, attention_impl="ring")
    ring.load_state_dict(plain.state_dict())
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(3, 256, (2, 16)))
    mask = torch.ones_like(ids)
    mask[1, 11:] = 0
    with torch.no_grad():
        want, got = (_forward(m, family, ids, mask) for m in (plain, ring))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("sp", [1, 2])
@pytest.mark.parametrize("impl", ["auto", "xla", "ring"])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_resolve_attention_impl_under_sp_as_jax(sp, impl, device):
    """A ``seq`` axis forces ring, ``auto`` included; the port's ``cuda`` is
    JAX's ``tpu`` (the flash kernels)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig

    want = TrainConfig(sp=sp, attention_impl=impl).resolve_attention_impl(
        "tpu" if device == "cuda" else "cpu")
    assert t_config.TrainConfig(sp=sp, attention_impl=impl).resolve_attention_impl(
        device) == want


def test_flash_with_sp_raises_the_jax_error():
    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig

    with pytest.raises(ValueError) as want:
        TrainConfig(sp=2, attention_impl="flash")
    with pytest.raises(ValueError) as got:
        t_config.TrainConfig(sp=2, attention_impl="flash")
    assert str(got.value) == str(want.value)


class _SeqMesh:
    """A stand-in ``DeviceMesh`` of the ported axes, ``sp`` ranks over
    ``seq``, at rank 0."""

    def __init__(self, sp):
        self.mesh_dim_names = t_mesh.PORTED_AXES
        self.mesh = torch.arange(sp).reshape(1, 1, sp, 1)

    def get_local_rank(self, name):
        return 0


@pytest.mark.parametrize("buckets,bad", [([16, 32], None), ([12, 20, 32], [12, 20])])
def test_batcher_refuses_a_bucket_the_seq_axis_does_not_divide(buckets, bad):
    """The JAX batcher's check (bucket widths that ``sp`` 8 does not
    divide), its message; the ``seq`` ranks take the rows of their
    replica."""
    ds = t_pipe.ArrayDataset({"input_ids": np.ones((16, 32), np.int64),
                              "attention_mask": np.ones((16, 32), np.int64),
                              "labels": np.arange(16)})
    if bad is None:
        batcher = t_pipe.ShardedBatcher(ds, 8, shuffle=False, native=False,
                                        bucket_sizes=buckets, mesh=_SeqMesh(8))
        assert (batcher.process_index, batcher.process_count) == (0, 1)
        return
    msg = (f"bucket_sizes {bad} not divisible by the mesh seq axis (size 8); pad bucket "
           "widths to multiples of 8")
    with pytest.raises(ValueError, match=re.escape(msg)):
        t_pipe.ShardedBatcher(ds, 8, shuffle=False, native=False, bucket_sizes=buckets,
                              mesh=_SeqMesh(8))


@pytest.mark.parametrize("family", ["bart", "deberta", "mixtral"])
def test_what_has_no_sp_layout_yet_raises_naming_item_11(tmp_path, family):
    """BART, DeBERTa and MoE layers under ``sp > 1``: each names ROADMAP
    queue 1, item 11."""
    model = _hf_model(tmp_path, family)
    with pytest.raises(NotImplementedError, match=ITEM_11):
        sharding.check_sequence_parallel(model, 2)
    sharding.check_sequence_parallel(model, 1)
