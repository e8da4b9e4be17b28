"""PyTorch port: training over a ``dp × fsdp × tp`` mesh
(``parallel/mesh.py``, ``parallel/sharding.py``, the Trainer, the
optimizers, the checkpoint and the export over FSDP2 and tensor
parallelism) held against one process and against the JAX ``Trainer`` on
the same mesh.

Each mesh shape is one gloo CPU world of 4 processes
(``tests/torch_mesh_worker.py``), spawned once for this module; every
assertion is a parametrised case over its results. The cases, on weights
the JAX package initialised (carried across with ``params_from_jax``) and
the same global batches of 8 rows:

- BERT seq-cls, GPT-2 causal-LM and Llama-GQA causal-LM (8 query over 4
  K/V heads), both with the fused vocab CE, 5 fp32 AdamW steps with
  clipping and a cosine warmup: losses within 1e-5 (relative) of one
  process, the first update's all-reduced gradients within 1e-5 relative
  L2 (all of a model's gradients as one vector: BERT's key biases have a
  gradient of 0 up to rounding), the exported weights within 2% of one
  step (``lr``; parameters whose step-1 gradient is 0 up to rounding are
  held to two steps: Adam turns rounding noise into full steps, the trap in
  ``ROADMAP.md``), and the losses within 2e-5 of the JAX ``Trainer`` on the
  same mesh over four of the eight virtual CPU devices (the tolerance of
  ``tests/test_sharding.py``);
- LAMB with clipping and Adafactor (factored at hidden 128) on a BERT of
  hidden 128, 3 steps: losses within 1e-5 of one process;
- GPT-2 (the permuted fused qkv) stopped after 2 of 4 steps, checkpointed
  and restored onto the mesh: losses and weights bit for bit those of the
  uninterrupted run; the same stopped after 3 of 6 micro-steps at 2 an
  update, so the checkpoint holds partial gradient accumulators;
- the gathered checkpoint state and export on rank 0's host only: every
  tensor whole and on the CPU there, none on the other ranks;
- each family's HF export, written by rank 0, read by the JAX
  ``from_pretrained`` and equal to the one-process export within the
  weight tolerance above;
- the replica check over the ``data`` axis: 0.0;
- the training CLI under the launcher, ``--fsdp 2 --tp 2`` over four gloo
  processes: the JAX CLI's results keys, the epoch loss within 1e-5 of one
  process on the same global batch, and a gathered export the JAX
  ``from_pretrained`` reads, every weight within 2% of one step of the
  one-process export.
"""

import multiprocessing as mp
import os
import socket

import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import pipeline as t_pipe
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import sources as t_src
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import tokenization as t_tok
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
    params_from_jax,
)
from torch_decode_pairs import detached_compile_trackers  # noqa: F401  (autouse)

SHAPES = {"dp2_fsdp2": (2, 2, 1), "fsdp2_tp2": (1, 2, 2), "dp2_tp2": (2, 1, 2),
          "fsdp4": (1, 4, 1), "tp4": (1, 1, 4)}
FAMILIES = ("bert", "gpt2", "llama")
OPTIMIZERS = ("lamb", "adafactor")
LR = 1e-3
STEPS = 5
TRAIN_KW = dict(epochs=1, dtype="float32", learning_rate=LR, scale_lr_by_world_size=False,
                weight_decay=0.01, max_grad_norm=1.0, warmup_ratio=0.4, lr_schedule="cosine",
                log_every_steps=0)
SEQ = 32
VOCAB = 300
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
}
# the optimizer cases' BERT: two axes of at least 128, so Adafactor factors
OPT_CONFIG = dict(CONFIGS["bert"], hidden_size=128, intermediate_size=256)
WORLD_TIMEOUT_S = 300


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_pair(family, cfg):
    """(JAX model, its params, the port's weights)."""
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.auto import init_params

    if family == "bert":
        from huggingface_sagemaker_tensorflow_distributed_tpu.models.bert import (
            BertForSequenceClassification,
        )
        from huggingface_sagemaker_tensorflow_distributed_tpu.models.layers import (
            EncoderConfig,
        )
        jmodel = BertForSequenceClassification(EncoderConfig(dtype=jnp.float32, **cfg),
                                               num_labels=2)
        params = init_params(jmodel, seed=0)
    elif family == "gpt2":
        from huggingface_sagemaker_tensorflow_distributed_tpu.models.gpt2 import (
            Gpt2Config,
            Gpt2LMHeadModel,
        )
        jmodel = Gpt2LMHeadModel(Gpt2Config(dtype=jnp.float32, **cfg))
        params = init_params(jmodel, seed=0)
    else:
        from huggingface_sagemaker_tensorflow_distributed_tpu.models.llama import (
            LlamaConfig,
            LlamaForCausalLM,
        )
        jcfg = LlamaConfig(dtype=jnp.float32, **cfg)
        jmodel = LlamaForCausalLM(jcfg)
        params = init_params(jmodel, jcfg, seed=0)
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    return jmodel, params, params_from_jax(flat)


def _columns():
    texts, labels = t_src.synthetic_text_classification(48, seed=1)
    cls = t_pipe.ArrayDataset.from_texts(t_tok.WordHashTokenizer(512), texts, labels, SEQ)
    # cut to varied lengths: the ranks hold different numbers of valid tokens
    lm_texts = [" ".join(t.split()[:3 + 5 * (i % 7)]) for i, t in enumerate(texts)]
    lm = t_pipe.ArrayDataset.from_lm_texts(t_tok.WordHashTokenizer(VOCAB), lm_texts, SEQ)
    return {"bert": cls.columns, "gpt2": lm.columns, "llama": lm.columns}


@pytest.fixture(scope="module")
def cases():
    """``(spec, jax pairs)``: every case a world runs."""
    columns = _columns()
    spec, pairs = {}, {}
    for family in FAMILIES:
        jmodel, params, state = _jax_pair(family, CONFIGS[family])
        pairs[family] = (jmodel, params)
        task = {"task": "seq-cls"} if family == "bert" else {"task": "causal-lm",
                                                              "fused_vocab_ce": True}
        spec[family] = dict(family=family, config=CONFIGS[family], state=state,
                            train=dict(TRAIN_KW, **task), columns=columns[family],
                            steps=STEPS, scenario="curve", export_dir=True)
    _, _, opt_state = _jax_pair("bert", OPT_CONFIG)
    for opt in OPTIMIZERS:
        train = dict(TRAIN_KW, task="seq-cls", optimizer=opt, max_grad_norm=0.5,
                     weight_decay=0.0 if opt == "adafactor" else 0.01)
        spec[opt] = dict(family="bert", config=OPT_CONFIG, state=opt_state, train=train,
                         columns=columns["bert"], steps=3, scenario="curve")
    spec["resume"] = dict(spec["gpt2"], steps=4, scenario="resume", checkpoint_dir=True)
    del spec["resume"]["export_dir"]
    accum = dict(spec["gpt2"]["train"], gradient_accumulation_steps=2)
    spec["resume_accum"] = dict(spec["resume"], train=accum, steps=6)
    spec["holders"] = dict(spec["gpt2"], train=accum, steps=3, scenario="holders")
    del spec["holders"]["export_dir"]
    return spec, pairs


@pytest.fixture(scope="module")
def one_process(cases, tmp_path_factory):
    """Every curve case run in this process, without a mesh."""
    spec, _ = cases
    out = {}
    for name, case in spec.items():
        if case["scenario"] == "curve":
            case = dict(case)
            if "export_dir" in case:
                case["export_dir"] = str(tmp_path_factory.mktemp(f"one_{name}"))
            out[name] = worker.run_curve(case)
            out[name]["export_dir"] = case.get("export_dir")
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", params=list(SHAPES))
def world(request, cases, tmp_path_factory):
    """One gloo world of 4 ranks at a mesh shape: ``(shape name, rank 0's
    results, out dir)``."""
    spec, _ = cases
    out = tmp_path_factory.mktemp(f"world_{request.param}")
    spec_path = str(out / "spec.pt")
    torch.save(spec, spec_path)
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=worker.run_world,
                         args=(r, 4, port, SHAPES[request.param], spec_path, str(out)))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=WORLD_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, f"{request.param}: a rank ran past {WORLD_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * 4, request.param
    results = torch.load(str(out / "results.pt"), weights_only=False)
    return request.param, results, out


def _flat(tensors: dict) -> torch.Tensor:
    return torch.cat([tensors[k].reshape(-1).double() for k in sorted(tensors)])


def _weights_agree(got: dict, want: dict, grads: dict, steps: int) -> None:
    """``got`` within 2% of one step (``LR``) of ``want``; a parameter
    whose step-1 gradient is 0 up to rounding within two steps a step."""
    scale = float(torch.linalg.vector_norm(_flat(grads)))
    for key, value in want.items():
        tol = 0.02 * LR
        g = grads.get(key)
        if g is not None and float(torch.linalg.vector_norm(g.double())) < 1e-7 * scale:
            tol = 2 * LR * steps
        err = float((got[key].double() - value.double()).abs().max())
        assert err <= tol, f"{key}: {err:.3e} > {tol:.1e}"


@pytest.mark.parametrize("family", FAMILIES)
def test_losses_match_one_process(world, one_process, family):
    name, results, _ = world
    np.testing.assert_allclose(results[family]["losses"], one_process[family]["losses"],
                               rtol=1e-5, err_msg=name)
    assert len(set(np.round(one_process[family]["losses"], 6))) == STEPS


@pytest.mark.parametrize("family", FAMILIES)
def test_first_update_gradients_match_one_process(world, one_process, family):
    name, results, _ = world
    got, want = results[family]["grads"], one_process[family]["grads"]
    assert got.keys() == want.keys()
    err = torch.linalg.vector_norm(_flat(got) - _flat(want)) / torch.linalg.vector_norm(
        _flat(want))
    assert float(err) <= 1e-5, (name, float(err))


@pytest.mark.parametrize("family", FAMILIES)
def test_weights_within_two_percent_of_a_step(world, one_process, family):
    _, results, _ = world
    _weights_agree(results[family]["params"], one_process[family]["params"],
                   one_process[family]["grads"], STEPS)


@pytest.mark.parametrize("family", FAMILIES)
def test_losses_match_jax_trainer_on_the_same_mesh(world, cases, devices8, family):
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

    name, results, _ = world
    spec, pairs = cases
    jmodel, params = pairs[family]
    dp, fsdp, tp = SHAPES[name]
    mesh = build_mesh(MeshConfig(dp=dp, fsdp=fsdp, tp=tp), devices=devices8[:4])
    jtrainer = JaxTrainer(TrainConfig(**spec[family]["train"], dp=dp, fsdp=fsdp, tp=tp),
                          jmodel, jax.tree_util.tree_map(jnp.array, params), mesh,
                          total_steps=STEPS)
    losses = []
    for batch in worker.batches(spec[family]["columns"], STEPS):
        arrays = {k: jax.device_put(v.numpy().astype(np.int32), batch_sharding(mesh))
                  for k, v in batch.items()}
        jtrainer.state, m = jtrainer._train_step(jtrainer.state, arrays)
        losses.append(float(jax.device_get(m["loss"])))
    np.testing.assert_allclose(results[family]["losses"], losses, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_lamb_clip_and_adafactor_match_one_process(world, one_process, optimizer):
    name, results, _ = world
    np.testing.assert_allclose(results[optimizer]["losses"],
                               one_process[optimizer]["losses"], rtol=1e-5, err_msg=name)
    _weights_agree(results[optimizer]["params"], one_process[optimizer]["params"],
                   one_process[optimizer]["grads"], 3)


def test_resume_on_the_mesh_is_bitwise(world):
    name, results, _ = world
    r = results["resume"]
    assert r["resumed_losses"] == r["losses"], name
    for key, value in r["params"].items():
        assert torch.equal(r["resumed_params"][key], value), (name, key)


def test_resume_mid_accumulation_on_the_mesh_is_bitwise(world):
    """The checkpoint taken after 3 micro-steps at 2 an update holds the
    whole partial accumulators; restored (rank 0's broadcast, each rank
    keeping its shard), the run ends bit for bit where the straight one
    does."""
    name, results, _ = world
    r = results["resume_accum"]
    assert r["resumed_losses"] == r["losses"], name
    for key, value in r["params"].items():
        assert torch.equal(r["resumed_params"][key], value), (name, key)


@pytest.mark.parametrize("part", ("model", "optimizer", "grads", "export"))
def test_gathered_state_only_on_rank_0_host(world, cases, part):
    """``state_dict()`` and ``export_params`` gather to rank 0's host: there
    every tensor is whole and on the CPU (the model's and the export's
    shapes those of the unwrapped model; the accumulators one a
    parameter); every other rank holds no tensor of them."""
    name, results, _ = world
    spec, _ = cases
    held = results["holders"]
    assert len(held) == 4
    for rank, mine in enumerate(held[1:], 1):
        assert mine[part] == [], (name, rank, part, mine[part][:3])
    rank0 = held[0][part]
    assert rank0 and all(device == "cpu" for _, device in rank0), (name, part)
    whole = sorted(tuple(v.shape) for v in spec["holders"]["state"].values())
    if part != "optimizer":
        assert sorted(shape for shape, _ in rank0) == whole, (name, part)
    else:   # AdamW's two moments a parameter, whole, and its step counts
        moments = sorted(shape for shape, _ in rank0 if shape != ())
        assert moments == sorted(whole * 2), (name, part)


@pytest.mark.parametrize("family", FAMILIES)
def test_export_reads_in_jax_and_equals_the_one_process_export(world, one_process, family):
    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as jax_auto

    _, _, out = world
    task = "seq-cls" if family == "bert" else "causal-lm"
    read = {}
    for side, path in (("mesh", str(out / f"{family}_export_dir")),
                       ("one", one_process[family]["export_dir"])):
        _, params, jfamily, _ = jax_auto.from_pretrained(path, task=task)
        assert jfamily == family
        # back under the port's names, to hold them to the port's gradients
        read[side] = params_from_jax({k: np.asarray(v)
                                      for k, v in flatten_dict(params, sep="/").items()})
    assert read["mesh"].keys() == read["one"].keys() == one_process[family]["params"].keys()
    _weights_agree(read["mesh"], read["one"], one_process[family]["grads"], STEPS)


def test_replica_check_is_zero(world):
    name, results, _ = world
    for family in FAMILIES:
        assert results[family]["divergence"] == 0.0, (name, family)


CLI_GPT2 = {"model_type": "gpt2", "vocab_size": VOCAB, "n_positions": 64, "n_embd": 64,
            "n_layer": 2, "n_head": 4, "resid_pdrop": 0.0, "embd_pdrop": 0.0,
            "attn_pdrop": 0.0}


def _cli_argv(cfg_dir, out, batch):
    return ["--model_name_or_path", str(cfg_dir), "--from_scratch", "true",
            "--task", "causal-lm", "--fused_vocab_ce", "true", "--dataset", "synthetic",
            "--max_seq_length", "32", "--max_train_samples", "64", "--max_eval_samples", "16",
            "--train_batch_size", str(batch), "--eval_batch_size", "4", "--epochs", "1",
            "--dtype", "float32", "--learning_rate", "1e-3",
            "--scale_lr_by_world_size", "false", "--log_every_steps", "0",
            "--output_data_dir", str(out / "output"), "--model_dir", str(out / "model")]


def test_cli_over_fsdp_and_tp_matches_one_process(tmp_path):
    """``python -m <port>.launch --slice cpu-4 --num_hosts 4 ... --fsdp 2
    --tp 2``: two replicas of batch 4 each (their tensor pairs sharing
    rows) against one process at batch 8."""
    import json

    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as jax_auto
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
    cli.main(_cli_argv(cfg_dir, one, 8) + ["--device", "cpu"])
    root = tmp_path / "jobs"
    assert t_launch.main(["--slice", "cpu-4", "--num_hosts", "4", "--job_root", str(root),
                          "--timeout", str(WORLD_TIMEOUT_S), "--fsdp", "2", "--tp", "2"]
                         + _cli_argv(cfg_dir, tmp_path / "unused", 4)[:-4]) == 0
    (job,) = [root / d for d in os.listdir(root)]
    assert "mesh {" in (job / "host_0.log").read_text()
    for name in ("train_results.txt", "eval_results.txt"):
        want = read_results_file(str(one / "output" / name))
        got = read_results_file(str(job / "output" / name))
        # the launched job's telemetry adds the MFU keys
        assert [k for k in got if k not in ("train_achieved_tflops_per_chip", "train_mfu")] \
            == list(want), name
    loss = [float(read_results_file(str(d / "train_results.txt"))["loss"].strip("[]"))
            for d in (job / "output", one / "output")]
    np.testing.assert_allclose(loss[0], loss[1], rtol=1e-5)
    _, params, family, _ = jax_auto.from_pretrained(str(job / "model"), task="causal-lm")
    _, ref, _, _ = jax_auto.from_pretrained(str(one / "model"), task="causal-lm")
    assert family == "gpt2"
    got, want = (flatten_dict(p, sep="/") for p in (params, ref))
    assert got.keys() == want.keys()
    for key, value in want.items():
        # 2% of one step (an export that missed an update, or took one on
        # half the batch, is a whole step off)
        err = float(np.abs(np.asarray(got[key]) - np.asarray(value)).max())
        assert err <= 0.02 * LR, f"{key}: {err:.3e}"
