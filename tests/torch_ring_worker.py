"""One rank of a gloo CPU world over a ``dp × fsdp × sp × tp`` mesh, for
``tests/test_torch_ring_attention.py``. It imports torch and the port only
(a spawned rank imports this module, never JAX).

:func:`run_world` joins the world, builds the mesh and runs every case of a
spec the test wrote with ``torch.save``; rank 0 writes every case's results
to ``out_dir/results.pt``. The scenarios:

- ``attention``: whole q, k, v (and a mask, a T5 bias table) from the test;
  each rank attends its block of the queries through
  ``ring_attention_or_fallback`` under the mesh, and the blocks are gathered
  (with the gradients of ``sum(out ** 2)`` when the case asks);
- ``indivisible``: the ``ValueError`` of a sequence the ``seq`` axis does not
  divide;
- ``curve``: a Trainer's steps on the mesh (``torch_mesh_worker.run_curve``'s
  figures) and its evaluation;
- ``generate``: T5's greedy generation under the mesh.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

import torch_mesh_worker as mesh_worker
from huggingface_sagemaker_tensorflow_distributed_tpu_torch import config as t_config
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import pipeline as t_pipe
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import generate as t_gen
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import t5 as t_t5
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel import mesh as t_mesh
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel import ring_attention as ra
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer

WORLD_TIMEOUT = timedelta(seconds=120)
MESH_KEYS = (("dp", "data"), ("fsdp", "fsdp"), ("sp", "seq"), ("tp", "tensor"))


def build_model(family: str, cfg: dict) -> torch.nn.Module:
    if family == "t5":
        return t_t5.T5ForConditionalGeneration(t_t5.T5Config(**cfg))
    return mesh_worker.build_model(family, cfg)


def trainer_for(case: dict, mesh=None) -> Trainer:
    model = build_model(case["family"], case["config"])
    model.load_state_dict(case["state"], strict=True)
    shape = {} if mesh is None else {k: t_mesh.mesh_shape(mesh)[ax] for k, ax in MESH_KEYS}
    cfg = t_config.TrainConfig(**case["train"], **shape)
    return Trainer(cfg, model, total_steps=case["steps"], mesh=mesh)


def run_attention(case: dict, mesh) -> dict:
    seq = ra.seq_shard(mesh)
    dtype = case.get("dtype", torch.float32)
    grad = case.get("grad", False)
    q, k, v = (seq.local(torch.from_numpy(case[n]).to(dtype), 2).requires_grad_(grad)
               for n in ("q", "k", "v"))
    mask = case.get("mask")
    mask = None if mask is None else seq.local_mask(torch.from_numpy(mask).float())
    table = case.get("table")
    table = None if table is None else torch.from_numpy(table).float()
    with t_mesh.use_mesh(mesh):
        out = ra.ring_attention_or_fallback(
            q, k, v, mask=mask, scale=case.get("scale"), causal=case.get("causal", False),
            rel_bias_table=table, rel_bias_spec=case.get("spec"))
    result = {"out": seq.gather(out.detach(), 2)}
    if grad:
        # each rank's share of sum(out ** 2): the ring's backward carries
        # the K/V gradients of every rank's queries home
        grads = torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))
        result["grads"] = tuple(seq.gather(g, 2) for g in grads)
    return result


def run_indivisible(case: dict, mesh) -> dict:
    seq = ra.seq_shard(mesh)
    try:
        seq.local(torch.zeros(1, case["length"]))
    except ValueError as err:
        return {"error": str(err)}
    return {"error": None}


def run_curve(case: dict, mesh=None) -> dict:
    """The evaluation of the initial weights, then ``steps`` train steps
    (losses, the first update's gradients, the replica check)."""
    trainer = trainer_for(case, mesh)
    grads = mesh_worker._grad_capture(trainer)
    ds = t_pipe.ArrayDataset({k: v.copy() for k, v in case["columns"].items()})
    evaluated = trainer.evaluate(t_pipe.ShardedBatcher(ds, 8, shuffle=False, native=False,
                                                       drop_remainder=False, mesh=mesh))
    losses = [float(trainer.train_step(b)["loss"])
              for b in mesh_worker.batches(case["columns"], case["steps"], mesh)]
    return {"losses": losses, "grads": grads, "eval": evaluated,
            "divergence": trainer.check_replica_divergence()}


def run_generate(case: dict, mesh=None) -> dict:
    """Greedy T5 generation on every rank (the whole batch each), under the
    mesh when there is one."""
    model = build_model("t5", case["config"]).eval()
    model.load_state_dict(case["state"], strict=True)
    ids, mask = (torch.from_numpy(case[n]).long() for n in ("input_ids", "attention_mask"))
    ctx = t_mesh.use_mesh(mesh) if mesh is not None else torch.no_grad()
    with ctx, torch.no_grad():
        tokens = t_gen.generate(model, ids, mask, max_new_tokens=case["new"])
    return {"tokens": tokens}


SCENARIOS = {"attention": run_attention, "indivisible": run_indivisible, "curve": run_curve,
             "generate": run_generate}


def run_world(rank: int, world: int, port: int, shape: tuple, spec_path: str,
              out_dir: str) -> None:
    """One rank: join the gloo world, build the ``(dp, fsdp, sp, tp)`` mesh,
    run every case of the spec; rank 0 writes the results."""
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=WORLD_TIMEOUT)
    try:
        dp, fsdp, sp, tp = shape
        mesh = t_mesh.build_mesh(t_mesh.MeshConfig(dp=dp, fsdp=fsdp, sp=sp, tp=tp),
                                 device_type="cpu", timeout=WORLD_TIMEOUT)
        spec = torch.load(spec_path, weights_only=False)
        results = {name: SCENARIOS[case["scenario"]](case, mesh) for name, case in spec.items()}
        if rank == 0:
            torch.save(results, os.path.join(out_dir, "results.pt"))
    finally:
        dist.destroy_process_group()
