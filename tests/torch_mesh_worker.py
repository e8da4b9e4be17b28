"""One rank of a gloo CPU world over a ``dp × fsdp × tp`` mesh, for
``tests/test_torch_mesh_train.py``. It imports torch and the port only (a
spawned rank imports this module, never JAX).

:func:`run_world` joins the world, builds the mesh and runs every case of a
spec the test wrote with ``torch.save``: each case is a model (family,
config, weights), a training config, the global dataset's columns and a
scenario. Rank 0 writes every case's results to ``out_dir/results.pt``
and each export under ``out_dir/<case>``.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import config as t_config
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import pipeline as t_pipe
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto as t_auto
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import bert as t_bert
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import gpt2 as t_gpt2
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import layers as t_layers
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import llama as t_llama
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel import mesh as t_mesh
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel import sharding
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.checkpoint import Checkpointer
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer

# how long a world's collectives wait for a peer before failing
WORLD_TIMEOUT = timedelta(seconds=120)


def build_model(family: str, cfg: dict) -> torch.nn.Module:
    if family == "bert":
        return t_bert.BertForSequenceClassification(t_layers.EncoderConfig(**cfg),
                                                    num_labels=2)
    if family == "gpt2":
        return t_gpt2.Gpt2LMHeadModel(t_gpt2.Gpt2Config(**cfg))
    return t_llama.LlamaForCausalLM(t_llama.LlamaConfig(**cfg))


def model_config(family: str, model):
    return model.config if family != "bert" else model.backbone.cfg


def batches(columns: dict, n: int, mesh=None) -> list:
    """The first ``n`` global batches of 8 rows of ``columns``, this
    rank's shard of each (all of each without a mesh), as tensors."""
    ds = t_pipe.ArrayDataset({k: v.copy() for k, v in columns.items()})
    out = []
    for b in t_pipe.ShardedBatcher(ds, 8, shuffle=False, native=False,
                                   mesh=mesh).local_batches(0):
        out.append({k: torch.from_numpy(v).long() if k != "valid" else torch.from_numpy(v)
                    for k, v in b.items()})
        if len(out) == n:
            break
    return out


def trainer_for(case: dict, mesh=None, model=None) -> Trainer:
    model = model or build_model(case["family"], case["config"])
    if model.state_dict().keys() != case["state"].keys():
        raise KeyError("the case's weights do not fit its model")
    model.load_state_dict(case["state"])
    shape = {} if mesh is None else {k: t_mesh.mesh_shape(mesh)[ax] for k, ax in (
        ("dp", "data"), ("fsdp", "fsdp"), ("sp", "seq"), ("tp", "tensor"))}
    cfg = t_config.TrainConfig(**case["train"], **{k: int(v) for k, v in shape.items()})
    return Trainer(cfg, model, total_steps=case["steps"], mesh=mesh)


def _grad_capture(trainer: Trainer) -> dict:
    """Fills with the whole gradients of the first update, named, in the
    unwrapped layout (a collective inside the optimizer's step)."""
    grads: dict = {}
    names = {id(p): n for n, p in trainer.model.named_parameters()}

    def hook(opt, args, kwargs):
        if not grads:
            whole = {names[id(p)]: sharding.full_tensor(p.grad).detach().clone()
                     for p in trainer.params if p.grad is not None}
            grads.update(sharding.canonical_state(trainer.model, whole))

    trainer.optimizer.register_step_pre_hook(hook)
    return grads


def _export(trainer: Trainer) -> dict:
    return {k: v.detach().clone() for k, v in trainer.export_params.items()}


def run_curve(case: dict, mesh=None) -> dict:
    """``steps`` train steps: the losses, the first update's gradients, the
    exported weights, the replica check; with ``export`` the HF export
    (rank 0)."""
    trainer = trainer_for(case, mesh)
    grads = _grad_capture(trainer)
    losses = [float(trainer.train_step(b)["loss"])
              for b in batches(case["columns"], case["steps"], mesh)]
    params = _export(trainer)
    out = {"losses": losses, "grads": grads, "params": params,
           "divergence": trainer.check_replica_divergence()}
    if case.get("export_dir") and (mesh is None or dist.get_rank() == 0):
        t_auto.save_pretrained(case["export_dir"], trainer.model, case["family"],
                               model_config(case["family"], trainer.model), host0_only=False,
                               state=params)
    return out


def run_resume(case: dict, mesh=None) -> dict:
    """``steps`` steps uninterrupted, and the same run stopped after half of
    them, checkpointed, restored into a new trainer and finished: both
    losses and both exports."""
    data = batches(case["columns"], case["steps"], mesh)
    half = case["steps"] // 2
    straight = trainer_for(case, mesh)
    want = [float(straight.train_step(b)["loss"]) for b in data]
    first = trainer_for(case, mesh)
    got = [float(first.train_step(b)["loss"]) for b in data[:half]]
    ckpt = Checkpointer(case["checkpoint_dir"], async_save=False)
    ckpt.save(first.state_dict(), epoch=0, step_in_epoch=half)
    second = trainer_for(case, mesh)
    state, _, step_in_epoch = ckpt.restore()
    second.load_state_dict(state)
    got += [float(second.train_step(b)["loss"]) for b in data[step_in_epoch:]]
    ckpt.close()
    return {"losses": want, "resumed_losses": got, "params": _export(straight),
            "resumed_params": _export(second)}


def _tensors(obj) -> list:
    """``(shape, device type)`` of every tensor in ``obj`` (nested dicts,
    lists and tuples)."""
    if isinstance(obj, torch.Tensor):
        return [(tuple(obj.shape), obj.device.type)]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return []


def run_holders(case: dict, mesh=None) -> list:
    """``steps`` micro-steps (an update's accumulators left partway), then
    ``state_dict()`` and ``export_params``: what each rank holds of them,
    ``{part: [(shape, device type), ...]}`` a rank, gathered from every
    rank."""
    trainer = trainer_for(case, mesh)
    for b in batches(case["columns"], case["steps"], mesh):
        trainer.train_step(b)
    state = trainer.state_dict()
    mine = {"model": _tensors(state["model"]), "optimizer": _tensors(state["optimizer"]),
            "grads": _tensors(state["grads"]), "export": _tensors(trainer.export_params)}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


SCENARIOS = {"curve": run_curve, "resume": run_resume, "holders": run_holders}


def run_world(rank: int, world: int, port: int, shape: tuple, spec_path: str,
              out_dir: str) -> None:
    """One rank: join the gloo world, build the ``(dp, fsdp, tp)`` mesh, run
    every case of the spec; rank 0 writes the results."""
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=WORLD_TIMEOUT)
    try:
        dp, fsdp, tp = shape
        mesh = t_mesh.build_mesh(t_mesh.MeshConfig(dp=dp, fsdp=fsdp, tp=tp), device_type="cpu",
                                 timeout=WORLD_TIMEOUT)
        spec = torch.load(spec_path, weights_only=False)
        results = {}
        for name, case in spec.items():
            case = dict(case)
            for key in ("export_dir", "checkpoint_dir"):
                if key in case:
                    case[key] = os.path.join(out_dir, f"{name}_{key}")
            results[name] = SCENARIOS[case["scenario"]](case, mesh)
        if rank == 0:
            torch.save(results, os.path.join(out_dir, "results.pt"))
    finally:
        dist.destroy_process_group()
