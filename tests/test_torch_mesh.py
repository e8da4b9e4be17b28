"""PyTorch port: the mesh and the sharding rules (``parallel/mesh.py``,
``parallel/sharding.py``) against the JAX package's.

- ``MeshConfig.resolve`` equals JAX's over a grid of device counts and
  axes, its ``ValueError`` messages included; the axis names and
  ``data_axis_names()`` are JAX's;
- the rule table gives each parameter of a tiny BERT, GPT-2 and Llama the
  ``tensor`` dim JAX's ``param_shardings`` gives it (the port's weights are
  ``[out, in]``, the JAX kernels ``[in, out]``; a column-parallel layer's
  bias is cut with its output features, which JAX leaves to GSPMD), and
  where the heads do not divide over ``tensor`` the port raises where JAX
  replicates (``tests/test_sharding.py``'s non-divisible case);
- what is not ported raises ``NotImplementedError`` naming ROADMAP queue 1,
  item 11: ``pp``, ``sp``, ``ep``, ``dcn_dp``, ring attention, ``tp`` with
  MoE, T5, BART, DeBERTa or DistilBERT, and ``tp`` not dividing the heads;
- ``world_size`` and ``data_parallel_size`` differ by ``tensor``; the
  batcher shards by the data-parallel rank;
- on a gloo world of one process, ``shard_model`` over a ``(1, 1, 1)``
  mesh wraps every family in FSDP2 (and the tensor-parallel plan where it
  is ported), and two fp32 steps equal the plain Trainer's (losses within
  1e-6 relative and the first update's gradients within 1e-5 relative L2,
  the card phase's gates);
- GPT-2's fused qkv permutation comes back to ``[q | k | v]`` exactly.
"""

import datetime
import json
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import config as t_config
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import pipeline as t_pipe
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto as t_auto
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
    params_from_jax,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel import mesh as t_mesh
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel import sharding
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer
import torch_mesh_worker as worker
from torch_decode_pairs import detached_compile_trackers, one_torch_thread  # noqa: F401

ITEM_11 = r"ROADMAP queue 1, item 11\b"

RESOLVE_CONFIGS = [dict(), dict(dp=2), dict(dp=4), dict(fsdp=2), dict(fsdp=4), dict(tp=2),
                   dict(tp=4), dict(fsdp=2, tp=2), dict(dp=2, fsdp=2, tp=2),
                   dict(dp=3, fsdp=3), dict(fsdp=3), dict(ep=4), dict(pp=4), dict(sp=2),
                   dict(dcn_dp=2), dict(dcn_dp=3), dict(dcn_dp=2, tp=2),
                   dict(dp=1, fsdp=4, tp=2)]


def _ids(kw):
    return "-".join(f"{k}{v}" for k, v in kw.items()) or "default"


def test_axis_names_match_jax():
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import mesh as j_mesh

    assert t_mesh.MESH_AXES == j_mesh.MESH_AXES
    assert t_mesh.data_axis_names() == j_mesh.data_axis_names()
    assert t_mesh.AXIS_TENSOR not in t_mesh.data_axis_names()
    assert t_mesh.AXIS_SEQ not in t_mesh.data_axis_names()
    assert t_mesh.PORTED_AXES == (t_mesh.AXIS_DATA, t_mesh.AXIS_FSDP, t_mesh.AXIS_SEQ,
                                  t_mesh.AXIS_TENSOR)


@pytest.mark.parametrize("kw", RESOLVE_CONFIGS, ids=_ids)
def test_resolve_matches_jax(kw):
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel.mesh import MeshConfig

    for n in (1, 2, 4, 6, 8, 9, 16):
        try:
            want = MeshConfig(**kw).resolve(n)
        except ValueError as err:
            with pytest.raises(ValueError) as got:
                t_mesh.MeshConfig(**kw).resolve(n)
            assert str(got.value) == str(err), (kw, n)
            continue
        assert t_mesh.MeshConfig(**kw).resolve(n) == want, (kw, n)


# -- the rule table --------------------------------------------------------------

def _model_dir(tmp_path, family, **kw):
    cfgs = {
        "bert": {"model_type": "bert", "vocab_size": 256, "hidden_size": 64,
                 "num_hidden_layers": 2, "num_attention_heads": 4,
                 "intermediate_size": 128, "max_position_embeddings": 32},
        "gpt2": {"model_type": "gpt2", "vocab_size": 256, "n_positions": 32, "n_embd": 64,
                 "n_layer": 2, "n_head": 4},
        "llama": {"model_type": "llama", "vocab_size": 256, "hidden_size": 64,
                  "intermediate_size": 128, "num_hidden_layers": 2,
                  "num_attention_heads": 8, "num_key_value_heads": 4,
                  "max_position_embeddings": 32},
        "mixtral": {"model_type": "mixtral", "vocab_size": 256, "hidden_size": 64,
                    "intermediate_size": 128, "num_hidden_layers": 2,
                    "num_attention_heads": 4, "num_key_value_heads": 2,
                    "num_local_experts": 4, "num_experts_per_tok": 2,
                    "max_position_embeddings": 32},
        "roberta": {"model_type": "roberta", "vocab_size": 256, "hidden_size": 64,
                    "num_hidden_layers": 2, "num_attention_heads": 4,
                    "intermediate_size": 128, "max_position_embeddings": 34,
                    "pad_token_id": 1, "type_vocab_size": 1},
        "distilbert": {"model_type": "distilbert", "vocab_size": 256, "dim": 64,
                       "n_layers": 2, "n_heads": 4, "hidden_dim": 128,
                       "max_position_embeddings": 32},
        "deberta": {"model_type": "deberta-v2", "vocab_size": 256, "hidden_size": 64,
                    "num_hidden_layers": 2, "num_attention_heads": 4,
                    "intermediate_size": 128, "max_position_embeddings": 32,
                    "relative_attention": True, "position_buckets": 16,
                    "share_att_key": True, "pos_att_type": "p2c|c2p",
                    "norm_rel_ebd": "layer_norm", "position_biased_input": False},
        "t5": {"model_type": "t5", "vocab_size": 256, "d_model": 64, "d_kv": 16,
               "d_ff": 128, "num_layers": 2, "num_decoder_layers": 2, "num_heads": 4},
        "bart": {"model_type": "bart", "vocab_size": 256, "d_model": 64,
                 "encoder_layers": 2, "decoder_layers": 2,
                 "encoder_attention_heads": 4, "decoder_attention_heads": 4,
                 "encoder_ffn_dim": 128, "decoder_ffn_dim": 128,
                 "max_position_embeddings": 32},
    }
    path = tmp_path / family
    path.mkdir(exist_ok=True)
    (path / "config.json").write_text(json.dumps({**cfgs[family], **kw}))
    return str(path)


TASKS = {"bert": "seq-cls", "roberta": "seq-cls", "distilbert": "seq-cls",
         "deberta": "seq-cls", "gpt2": "causal-lm", "llama": "causal-lm",
         "mixtral": "causal-lm", "t5": "seq2seq", "bart": "seq2seq"}


def _port_model(tmp_path, family, **kw):
    model, _, _ = t_auto.from_pretrained(_model_dir(tmp_path, family, **kw),
                                         task=TASKS[family], from_scratch=True, seed=1,
                                         device="cpu")
    return model


def _jax_tensor_dims(tmp_path, family, tp, devices):
    """``{port parameter name: dim}`` of JAX ``param_shardings`` at a
    ``tp`` mesh, moved to the port's layout (None: not over ``tensor``)."""
    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
        param_shardings,
    )

    jmodel, params, _, _ = j_auto.from_pretrained(_model_dir(tmp_path, family),
                                                  task=TASKS[family], from_scratch=True)
    mesh = build_mesh(MeshConfig(dp=1, tp=tp), devices=devices[:tp])
    specs = flatten_dict(param_shardings(params, mesh), sep="/")
    flat = flatten_dict(params, sep="/")
    out = {}
    for path, sh in specs.items():
        name = next(iter(params_from_jax({path: np.zeros(np.shape(flat[path]))})))
        spec = list(sh.spec)
        dim = spec.index("tensor") if "tensor" in spec else None
        if dim is not None and path.endswith("kernel"):
            dim = 1 - dim                   # [in, out] -> [out, in]
        out[name] = dim
    return out


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("family", ["bert", "gpt2", "llama"])
def test_tensor_dims_match_jax_param_shardings(tmp_path, devices8, family, tp):
    want = _jax_tensor_dims(tmp_path, family, tp, devices8)
    model = _port_model(tmp_path, family)
    sharding.check_tensor_parallel(model, tp)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    sharded = 0
    for name in names:
        got = sharding.tensor_dim(name)
        if name.endswith(".bias") and want[name] is None and got is not None:
            # a column-parallel bias: cut with its layer's output features
            assert got == 0 and sharding.tensor_dim(name[:-4] + "weight") == 0, name
            continue
        assert got == want[name], name
        sharded += got is not None
    # the Megatron weights of 2 layers: BERT's 6, GPT-2's 4, Llama's 7 a layer
    assert sharded == {"bert": 12, "gpt2": 8, "llama": 14}[family]


def test_heads_that_do_not_divide_raise_where_jax_replicates(tmp_path, devices8):
    """JAX (``tests/test_sharding.py``): hidden 64 over tp 8 shards the
    query kernel's columns and replicates the 2-class classifier. The
    port's plan is head-granular: 4 heads over 8 ranks raise."""
    want = _jax_tensor_dims(tmp_path, "bert", 8, devices8)
    assert want["backbone.encoder.layer.0.attention.query.weight"] == 0
    assert want["classifier.weight"] is None
    model = _port_model(tmp_path, "bert")
    assert sharding.tensor_dim("classifier.weight") is None
    with pytest.raises(NotImplementedError, match=ITEM_11) as err:
        sharding.check_tensor_parallel(model, 8)
    assert "num_heads=4" in str(err.value)


def _sp_mesh_is_ported():
    """``sp`` 2 gets past the port check: without a process group the mesh
    asks for one."""
    with pytest.raises(RuntimeError, match="build_mesh needs a process group"):
        t_mesh.build_mesh(t_mesh.MeshConfig(sp=2))


def _unported_sites(tmp_path):
    return {
        "mesh-pp": lambda: t_mesh.build_mesh(t_mesh.MeshConfig(pp=2)),
        # item 11's step 1, ported: the seq axis builds, ring attention runs
        "mesh-sp": _sp_mesh_is_ported,
        "mesh-ep": lambda: t_mesh.build_mesh(t_mesh.MeshConfig(ep=2)),
        "mesh-dcn_dp": lambda: t_mesh.build_mesh(t_mesh.MeshConfig(dcn_dp=2)),
        "shard_map_compat": lambda: t_mesh.shard_map_compat(None, mesh=None, in_specs=(),
                                                            out_specs=()),
        "config-pp": lambda: t_config.TrainConfig(pp=2),
        "config-sp": lambda: t_config.TrainConfig(sp=2).resolve_attention_impl("cuda") == "ring",
        "config-dcn_dp": lambda: t_config.TrainConfig(dcn_dp=2),
        "config-ring": lambda: t_config.TrainConfig(attention_impl="ring").resolve_attention_impl(
            "cpu") == "ring",
        "tp-moe": lambda: sharding.check_tensor_parallel(_port_model(tmp_path, "mixtral"), 2),
        "tp-t5": lambda: sharding.check_tensor_parallel(_port_model(tmp_path, "t5"), 2),
        "tp-bart": lambda: sharding.check_tensor_parallel(_port_model(tmp_path, "bart"), 2),
        "tp-deberta": lambda: sharding.check_tensor_parallel(
            _port_model(tmp_path, "deberta"), 2),
        "tp-distilbert": lambda: sharding.check_tensor_parallel(
            _port_model(tmp_path, "distilbert"), 2),
        "tp-heads": lambda: sharding.check_tensor_parallel(
            _port_model(tmp_path, "gpt2", n_head=2), 4),
        "tp-kv-heads": lambda: sharding.check_tensor_parallel(
            _port_model(tmp_path, "llama", num_key_value_heads=2), 4),
    }


# the sites of item 11 that are ported now: each call runs and returns True
# (or None, having checked what it must)
PORTED_SITES = ("mesh-sp", "config-sp", "config-ring")


@pytest.mark.parametrize("site", list(_unported_sites(None)))
def test_unported_raise_names_item_11(tmp_path, site):
    if site in PORTED_SITES:
        assert _unported_sites(tmp_path)[site]() in (True, None)
        return
    with pytest.raises(NotImplementedError, match=ITEM_11):
        _unported_sites(tmp_path)[site]()


@pytest.mark.parametrize("case", ["no-group", "built"])
def test_tensor_parallel_mesh(case):
    """Without a process group of ``tp`` ranks the serving mesh names the
    world size; in a gloo world of one, a degree of 1 is a ``tensor`` mesh
    of one rank, the same object for every caller, and 0 raises the JAX
    error."""
    if case == "no-group":
        with pytest.raises(ValueError, match="needs a process group of 2 ranks, the world "
                                             "has 1"):
            t_mesh.tensor_parallel_mesh(2)
        return
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = t_mesh.tensor_parallel_mesh(1, device_type="cpu")
        assert t_mesh.tensor_parallel_mesh(1, device_type="cpu") is mesh
        assert mesh.mesh_dim_names == ("tensor",)
        assert t_mesh.mesh_shape(mesh) == {ax: 1 for ax in t_mesh.MESH_AXES}
        with pytest.raises(ValueError, match="tensor-parallel degree must be >= 1, got 0"):
            t_mesh.tensor_parallel_mesh(0)
        with pytest.raises(ValueError, match="the world has 1"):
            t_mesh.tensor_parallel_mesh(2)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kw", [dict(fsdp=2), dict(tp=2), dict(dp=2, fsdp=2, tp=2)], ids=_ids)
def test_fsdp_and_tp_configs_build(kw):
    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig

    assert t_config.TrainConfig(**kw).to_dict() == TrainConfig(**kw).to_dict()


def test_current_mesh_is_lifo():
    assert t_mesh.maybe_current_mesh() is None
    with pytest.raises(RuntimeError, match="no ambient mesh"):
        t_mesh.current_mesh()
    with t_mesh.use_mesh("a"):
        with t_mesh.use_mesh("b"):
            assert t_mesh.current_mesh() == "b"
        assert t_mesh.current_mesh() == "a"
    assert t_mesh.maybe_current_mesh() is None


# -- sizes and the batch -----------------------------------------------------------

class _GridMesh:
    """A stand-in ``DeviceMesh`` of the ported axes at rank ``rank``."""

    def __init__(self, shape, rank):
        self.mesh_dim_names = t_mesh.PORTED_AXES
        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)
        self._coords = [int(c) for c in np.unravel_index(rank, shape)]

    def get_local_rank(self, name):
        return self._coords[self.mesh_dim_names.index(name)]


@pytest.mark.parametrize("shape", [(2, 2, 1, 2), (1, 2, 1, 4), (4, 1, 1, 2), (1, 1, 1, 8),
                                   (2, 1, 2, 2), (1, 2, 4, 1)])
def test_sizes_and_batch_shards_follow_the_data_parallel_rank(shape):
    """(dp, fsdp, sp, tp): the seq and tensor ranks of a replica take its
    rows."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import mesh as j_mesh

    dp, fsdp, sp, tp = shape
    world = dp * fsdp * sp * tp
    assert t_mesh.world_size(_GridMesh(shape, 0)) == world
    assert t_mesh.data_parallel_size(_GridMesh(shape, 0)) == dp * fsdp
    jshape = dict(zip(j_mesh.MESH_AXES, t_mesh.MeshConfig(dp=dp, fsdp=fsdp, sp=sp, tp=tp)
                      .resolve(world)))
    assert t_mesh.mesh_shape(_GridMesh(shape, 0)) == jshape
    n = 32
    ds = t_pipe.ArrayDataset({"input_ids": np.arange(n * 4).reshape(n, 4),
                              "labels": np.arange(n)})
    for rank in range(world):
        mesh = _GridMesh(shape, rank)
        assert t_mesh.seq_rank(mesh) == np.unravel_index(rank, shape)[2]
        batch = next(t_pipe.ShardedBatcher(ds, 16, shuffle=False, native=False,
                                           mesh=mesh).local_batches(0))
        d, f, _, _ = np.unravel_index(rank, shape)
        per = 16 // (dp * fsdp)
        lo = (d * fsdp + f) * per
        assert batch["labels"].tolist() == list(range(lo, lo + per)), (shape, rank)


def test_qkv_permutation_comes_back(tmp_path):
    model = _port_model(tmp_path, "gpt2")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sharding._permute_qkv(model, 2)
    key = "backbone.h.0.attention.qkv.weight"
    assert not torch.equal(model.state_dict()[key], before[key])
    h = 64 // 2
    # rank 0's slice: the first head group's q, k and v
    assert torch.equal(model.state_dict()[key][:3 * h],
                       torch.cat([before[key][i * 64:i * 64 + h] for i in range(3)]))
    back = sharding.canonical_state(model, model.state_dict())
    for k, v in before.items():
        assert torch.equal(back[k], v), k


# -- a world of one ----------------------------------------------------------------

@pytest.fixture(scope="module")
def world_of_one():
    """A gloo process group of this one process (torn down after the
    module) and its (1, 1, 1) mesh."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        yield t_mesh.build_mesh(t_mesh.MeshConfig(), device_type="cpu")
    finally:
        dist.destroy_process_group()


def _batch(family, seed=0):
    rng = np.random.RandomState(seed)
    ids = torch.from_numpy(rng.randint(3, 250, (4, 16))).long()
    mask = torch.ones_like(ids)
    mask[1, -4:] = 0
    batch = {"input_ids": ids, "attention_mask": mask}
    if TASKS[family] == "seq-cls":
        batch["labels"] = torch.tensor([0, 1, 1, 0])
    elif TASKS[family] == "causal-lm":
        batch["labels"] = ids.masked_fill(mask == 0, -100)
    else:
        batch["decoder_input_ids"] = ids[:, :8]
        batch["decoder_attention_mask"] = mask[:, :8]
        batch["labels"] = ids[:, 1:9]
    return batch


@pytest.mark.parametrize("family", list(TASKS))
def test_one_rank_mesh_steps_equal_the_plain_trainer(tmp_path, world_of_one, family):
    assert t_mesh.world_size(world_of_one) == t_mesh.data_parallel_size(world_of_one) == 1
    kw = dict(task=TASKS[family], dtype="float32", learning_rate=1e-3, max_grad_norm=1.0,
              scale_lr_by_world_size=False, fused_vocab_ce=family in ("gpt2", "llama"))
    plain = Trainer(t_config.TrainConfig(**kw), _port_model(tmp_path, family))
    model = sharding.shard_model(_port_model(tmp_path, family), world_of_one)
    assert all(sharding.is_dtensor(p) for p in model.parameters())
    wrapped = Trainer(t_config.TrainConfig(**kw), model)
    assert wrapped.sharded and not plain.sharded
    grads = [worker._grad_capture(t) for t in (plain, wrapped)]
    for seed in range(2):
        # the same dropout draws for both
        torch.manual_seed(seed)
        want = plain.train_step(_batch(family, seed))["loss"]
        torch.manual_seed(seed)
        got = wrapped.train_step(_batch(family, seed))["loss"]
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    want, got = (torch.cat([g[k].reshape(-1) for k in sorted(grads[0])]) for g in grads)
    assert float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)) <= 1e-5
    assert wrapped.export_params.keys() == plain.model.state_dict().keys()


def test_k2_refuses_a_misaligned_head_weight():
    """FSDP2's unsharded parameters are fresh allocations; a W that is not
    (a view 2 bytes into a buffer) makes K2's wgmma routes raise instead of
    quietly running anything else."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import vocab_ce

    hidden = torch.zeros(4, 64, dtype=torch.bfloat16)
    flat = torch.zeros(64 * 10 + 1, dtype=torch.bfloat16)
    weight = flat[1:].view(10, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        vocab_ce._tma_operands(hidden, weight)
    assert vocab_ce._tma_operands(hidden, flat[:640].view(10, 64))[2] == 64
