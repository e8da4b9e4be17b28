"""One rank of a gloo CPU world serving over a ``tensor`` mesh, for
``tests/test_torch_tp_serve.py``. It imports torch and the port only (a
spawned rank imports this module, never JAX).

:func:`run_world` joins the world and runs every case of a spec the test
wrote with ``torch.save``. A serving case builds a tensor-parallel
``ServeEngine`` from its whole model on every rank; rank 0 serves its runs
and the other ranks follow. A generation case runs greedy, beam and
speculative generation over the model cut for serving, on every rank.
Rank 0 writes every case's results to ``out_dir/results.pt``; the orphan
case's follower writes what it saw to ``out_dir/orphan.pt``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import generate as t_gen
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import gpt2 as t_gpt2
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import llama as t_llama
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel import mesh as t_mesh
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel import sharding
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import ServeEngine

# how long a world's collectives wait for a peer before failing
WORLD_TIMEOUT = timedelta(seconds=120)
# the orphan case's control group: a follower that hears nothing ends after it
ORPHAN_TIMEOUT = timedelta(seconds=3)


def spec_of(model) -> dict:
    """A whole model as a spec entry: its family, config fields and weights."""
    family = "gpt2" if isinstance(model, t_gpt2.Gpt2LMHeadModel) else "llama"
    fields = {f.name: getattr(model.config, f.name)
              for f in dataclasses.fields(model.config)}
    return {"family": family, "config": fields, "state": model.state_dict()}


def build(spec: dict):
    """A fresh whole model from :func:`spec_of`'s entry."""
    if spec["family"] == "gpt2":
        model = t_gpt2.Gpt2LMHeadModel(t_gpt2.Gpt2Config(**spec["config"]))
    else:
        model = t_llama.LlamaForCausalLM(t_llama.LlamaConfig(**spec["config"]))
    model.load_state_dict(spec["state"])
    return model.eval()


def serve(engine, trace, kws=None) -> list:
    """``trace``'s requests through ``engine`` (rank 0): each one's ids."""
    kws = kws or [{}] * len(trace)
    reqs = [engine.submit(p, m, **kw) for (p, m), kw in zip(trace, kws)]
    engine.run()
    return [[int(t) for t in engine.output_ids(r)] for r in reqs]


def engine_facts(engine) -> dict:
    stats = engine.stats()._asdict()
    return {"stats": stats, "summary": engine.slo_summary(),
            "num_blocks": engine.blocks.num_blocks, "token_bytes": engine.blocks.token_bytes,
            "pool_bytes": engine.blocks.pool_bytes, "block_bytes": engine.blocks.block_bytes,
            "peak_resident": engine.peak_resident, "kernel": engine.kernel,
            "pool_dtypes": sorted({str(p.dtype) for p in engine._kv.all()}),
            "pool_heads": int(engine._kv.k[0].shape[2]),
            "draft_pool_heads": (int(engine._dkv.k[0].shape[2])
                                 if engine._dkv is not None else None)}


def _watch_mesh(engine) -> list:
    """Whether each prefill ``engine`` runs sees its mesh as the ambient one."""
    seen, op = [], engine._op_prefill

    def run(*args):
        seen.append(t_mesh.maybe_current_mesh() is engine.mesh)
        return op(*args)

    engine._op_prefill = run
    return seen


def run_serve(case: dict, rank: int) -> dict | None:
    """Each run of ``case`` on a fresh engine over a fresh copy of its
    model; rank 0's ids and engine facts by run name."""
    out = {}
    for name, run in case["runs"].items():
        model = build(case["model"])
        engine = ServeEngine(model, mesh=2, device="cpu", **{**case["engine"], **run})
        seen = _watch_mesh(engine)
        if rank == 0:
            out[name] = {"ids": serve(engine, case["trace"], case.get("kws")),
                         **engine_facts(engine)}
            engine.close()
        else:
            out[name] = {"ops": engine.follow(), "pool_heads": int(engine._kv.k[0].shape[2])}
        out[name]["prefills_under_mesh"] = (len(seen), all(seen))
    return out


def run_generate(case: dict, mesh) -> dict:
    """Greedy, beam and speculative generation over the model cut for
    serving (every rank makes the same calls)."""
    model = sharding.shard_for_serving(build(case["model"]), mesh)
    ids = torch.as_tensor(case["ids"])
    with torch.inference_mode():
        greedy = t_gen.generate_causal(model, ids, max_new_tokens=10)
        beam = t_gen.beam_search_causal(model, ids, num_beams=3, max_new_tokens=8)
        spec = t_gen.generate_speculative(model, t_gen.self_draft(model, 1), ids,
                                          max_new_tokens=10)
    return {"greedy": greedy.tolist(), "beam": beam.tolist(), "spec": spec.tolist(),
            "qkv_rows": int(model.backbone.layers[0].self_attn.q_proj.weight.shape[0]),
            "cache_heads": int(model.new_dense_cache(1, 4).keys[0].shape[1])}


def run_orphan(case: dict, rank: int, out_dir: str) -> None:
    """A follower whose leader sends nothing: its loop must end, raising,
    within the control group's timeout."""
    group = dist.new_group([0, 1], timeout=ORPHAN_TIMEOUT)
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh.from_group(group, "cpu", mesh=torch.arange(2),
                                 mesh_dim_names=(t_mesh.AXIS_TENSOR,))
    engine = ServeEngine(build(case["model"]), mesh=mesh, device="cpu",
                         **case["engine"])
    if rank == 0:
        time.sleep(ORPHAN_TIMEOUT.total_seconds() + 2)
        return
    t0 = time.perf_counter()
    try:
        engine.follow()
        seen = {"raised": None}
    except Exception as err:            # noqa: BLE001 (what the follower saw is the result)
        seen = {"raised": type(err).__name__, "message": str(err)[:200]}
    seen["seconds"] = time.perf_counter() - t0
    torch.save(seen, os.path.join(out_dir, "orphan.pt"))


def run_world(rank: int, world: int, port: int, spec_path: str, out_dir: str) -> None:
    """One rank: join the gloo world, run every case of the spec; rank 0
    writes the results."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=WORLD_TIMEOUT)
    try:
        mesh = t_mesh.tensor_parallel_mesh(world, device_type="cpu", timeout=WORLD_TIMEOUT)
        assert t_mesh.tensor_parallel_mesh(world, device_type="cpu") is mesh
        spec = torch.load(spec_path, weights_only=False)
        results = {"mesh": t_mesh.mesh_shape(mesh)}
        for name, case in spec.items():
            if case["kind"] == "serve":
                results[name] = run_serve(case, rank)
            elif case["kind"] == "generate":
                results[name] = run_generate(case, mesh)
            else:
                run_orphan(case, rank, out_dir)
        if rank == 0:
            torch.save(results, os.path.join(out_dir, "results.pt"))
        else:
            torch.save(results, os.path.join(out_dir, f"results_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
