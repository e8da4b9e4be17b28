"""PyTorch port: tensor-parallel serving (``ServeEngine(mesh=2)``,
``serve/tp.py``, ``parallel/sharding.py:shard_for_serving``,
``parallel/mesh.py:tensor_parallel_mesh``) and generation over a model cut
for serving, held against one process and against the JAX engine on a
``tp=2`` mesh of the virtual CPU devices, on the same weights (the JAX
package's, carried across with ``params_from_jax``).

One gloo world of 2 spawned processes (``tests/torch_tp_worker.py``) runs
every case, module-scoped; the JAX runs and the one-process runs are made in
this process while it works. The cases mirror the JAX package's
``tests/test_serve.py`` TP cases and ``tests/test_sharded_generation.py``:

- token-exact across a gather-bucket boundary, the per-device bytes a token
  half the model's, ``tp`` and ``kv_pool_bytes_per_device`` in the summary;
- token-exact under forced recompute preemption, half the bytes a token and
  a pool on the same geometry;
- one ``kv_pool_bytes`` budget admitting at least twice the residents;
- speculation, the prefix cache and int8 pools composed (the draft's pools
  cut like the target's);
- sampled requests seed-deterministic across a rerun and across preemption,
  and equal to one process;
- swap under preemption (block sets leave the pools whole and come back
  cut), equal to one process;
- greedy, beam and speculative generation equal to one process and to the
  JAX package's under a ``tp=2`` mesh;
- a follower whose leader sends nothing ends, raising, within its control
  group's timeout.

Greedy tokens are compared exactly (the all-reduce's order of summation moves
logits by ulps; these seeds hold no near tie). The rejections are
single-process cases in ``tests/test_torch_serve_engine.py``.
"""

import json
import multiprocessing as mp
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_tp_worker as worker
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import ServeEngine
from torch_decode_pairs import (  # noqa: F401
    detached_compile_trackers,
    gpt2_pair,
    llama_pair,
)

WORLD_TIMEOUT_S = 300
# the JAX package's test model (tests/test_serve.py's gpt2_setup): 2 heads
GPT2 = dict(num_heads=2, eos_token_id=127, pad_token_id=0)
LLAMA = dict(num_layers=2, max_position_embeddings=128, eos_token_id=127, pad_token_id=0)
BUCKET = dict(num_slots=3, block_size=4, num_blocks=40, prefill_chunk=8, max_model_len=32,
              gather_buckets=[16, 32])
PREEMPT = dict(num_slots=4, block_size=4, num_blocks=10, prefill_chunk=8, max_model_len=32)
COMPOSE = dict(num_slots=3, block_size=4, num_blocks=60, prefill_chunk=8, max_model_len=48,
               speculate_k=2, draft=1, prefix_cache=True, kv_cache_dtype="int8")
SAMPLED = dict(num_slots=3, block_size=4, prefill_chunk=8, max_model_len=32)
SAMPLING = [dict(temperature=0.9, top_k=20, top_p=0.9, seed=s) for s in (1, 2, 3)] + [{}]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _trace(seed, shapes):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, 120, (p,)).astype(np.int32), m) for p, m in shapes]


def _templated():
    rng = np.random.RandomState(33)
    shared = rng.randint(1, 120, (8,)).astype(np.int32)
    return [(np.concatenate([shared, rng.randint(1, 120, (t,)).astype(np.int32)]), 6)
            for t in (5, 3, 4, 6)]


def _budget(model) -> int:
    """4 blocks of the single-device engine's bytes (the JAX test's budget)."""
    lone = ServeEngine(model, num_slots=1, block_size=4, num_blocks=4, prefill_chunk=8,
                       max_model_len=32, device="cpu")
    return 4 * 4 * lone.blocks.token_bytes


@pytest.fixture(scope="module")
def models():
    """``{name: (JAX model, params, port model)}``."""
    return {"gpt2": gpt2_pair(**GPT2), "llama": llama_pair(**LLAMA)}


@pytest.fixture(scope="module")
def cases(models):
    gpt2 = models["gpt2"][2]
    llama = models["llama"][2]
    budget = dict(num_slots=6, block_size=4, num_blocks=999, prefill_chunk=8,
                  max_model_len=32, kv_pool_bytes=_budget(gpt2))
    return {
        "bucket": dict(kind="serve", model=gpt2, engine=BUCKET, runs={"tp": {}},
                       trace=_trace(31, [(5, 9), (15, 6), (12, 8)])),
        "preempt": dict(kind="serve", model=gpt2, engine=PREEMPT, runs={"tp": {}},
                        trace=_trace(1, [(9, 18)] * 5)),
        "budget": dict(kind="serve", model=gpt2, engine=budget, runs={"tp": {}},
                       trace=_trace(32, [(6, 2)] * 8)),
        "compose": dict(kind="serve", model=gpt2, engine=COMPOSE, runs={"tp": {}},
                        trace=_templated()),
        "sampled": dict(kind="serve", model=gpt2, engine=SAMPLED, kws=SAMPLING,
                        runs={"roomy": dict(num_blocks=40), "again": dict(num_blocks=40),
                              "tight": dict(num_blocks=9)},
                        trace=_trace(35, [(9, 14)] * 4)),
        "swap": dict(kind="serve", model=llama, engine=dict(PREEMPT, swap="always"),
                     runs={"tp": {}}, trace=_trace(1, [(9, 18)] * 5)),
        "generate": dict(kind="generate", model=llama,
                         ids=np.random.RandomState(0).randint(3, 128, (2, 7))),
        "orphan": dict(kind="orphan", model=gpt2, engine=BUCKET),
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _one_process(case) -> dict:
    """Each serving run of ``case`` on the single-device engine."""
    out = {}
    for name, run in case["runs"].items():
        engine = ServeEngine(case["model"], device="cpu", **{**case["engine"], **run})
        out[name] = {"ids": worker.serve(engine, case["trace"], case.get("kws")),
                     **worker.engine_facts(engine)}
    return out


def _jax_serve(pair, case, run="tp") -> list:
    """The JAX engine's ids on a ``tp=2`` mesh (greedy requests only: the
    two packages' sampling noise differs)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve.engine import (
        ServeEngine as JaxEngine,
    )

    jmodel, params, _ = pair
    engine = JaxEngine(jmodel, params, mesh=2, **{**case["engine"], **case["runs"][run]})
    assert engine.tp == 2
    kws = case.get("kws") or [{}] * len(case["trace"])
    greedy = [(p, m) for (p, m), kw in zip(case["trace"], kws) if not kw]
    reqs = [engine.submit(p, m) for p, m in greedy]
    engine.run()
    return [[int(t) for t in engine.output_ids(r)] for r in reqs]


def _jax_generate(pair, ids) -> dict:
    import jax

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.generate import (
        beam_search_causal,
        generate_causal,
        generate_speculative,
        self_draft,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
        param_shardings,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel.mesh import use_mesh

    model, params, _ = pair
    draft, d_params = self_draft(model, params, 1)
    mesh = build_mesh(MeshConfig(dp=1, tp=2), devices=jax.devices()[:2])
    sharded = jax.device_put(params, param_shardings(params, mesh))
    d_sharded = jax.device_put(d_params, param_shardings(d_params, mesh))
    with use_mesh(mesh):
        return {"greedy": np.asarray(generate_causal(model, sharded, ids,
                                                     max_new_tokens=10)).tolist(),
                "beam": np.asarray(beam_search_causal(model, sharded, ids, num_beams=3,
                                                      max_new_tokens=8)).tolist(),
                "spec": np.asarray(generate_speculative(model, sharded, draft, d_sharded, ids,
                                                        max_new_tokens=10)).tolist()}


def _port_generate(model, ids) -> dict:
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import generate as t_gen

    ids = torch.as_tensor(ids)
    with torch.inference_mode():
        return {"greedy": t_gen.generate_causal(model, ids, max_new_tokens=10).tolist(),
                "beam": t_gen.beam_search_causal(model, ids, num_beams=3,
                                                 max_new_tokens=8).tolist(),
                "spec": t_gen.generate_speculative(model, t_gen.self_draft(model, 1), ids,
                                                   max_new_tokens=10).tolist()}


@pytest.fixture(scope="module")
def world(cases, models, devices8, tmp_path_factory):
    """``(rank 0's results, rank 1's, the orphan's, one process's, JAX's)``:
    the world runs while this process makes the other two."""
    out = tmp_path_factory.mktemp("tp_world")
    spec_path = str(out / "spec.pt")
    torch.save({name: dict(c, model=worker.spec_of(c["model"])) for name, c in cases.items()},
               spec_path)
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=worker.run_world, args=(r, 2, port, spec_path, str(out)))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        one = {name: _one_process(c) for name, c in cases.items() if c["kind"] == "serve"}
        one["generate"] = _port_generate(cases["generate"]["model"], cases["generate"]["ids"])
        jax = {name: _jax_serve(models["llama" if name == "swap" else "gpt2"], c,
                                run=next(iter(c["runs"])))
               for name, c in cases.items() if c["kind"] == "serve" and name != "swap"}
        jax["generate"] = _jax_generate(models["llama"], cases["generate"]["ids"])
    finally:
        for p in procs:
            p.join(timeout=WORLD_TIMEOUT_S)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
    assert not alive, f"a rank ran past {WORLD_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0, 0]
    load = lambda name: torch.load(str(out / name), weights_only=False)  # noqa: E731
    return (load("results.pt"), load("results_rank1.pt"), load("orphan.pt"), one, jax)


SERVE_CASES = ("bucket", "preempt", "budget", "compose", "sampled", "swap")


def test_the_world_runs_on_a_tensor_mesh(world):
    got, follower, *_ = world
    assert got["mesh"]["tensor"] == 2 == follower["mesh"]["tensor"]
    assert sum(got["mesh"].values()) == 2 + 6          # the other six axes are 1


@pytest.mark.parametrize("case", SERVE_CASES)
def test_tp_engine_equals_one_process(world, case):
    got, _, _, one, _ = world
    for run, r in got[case].items():
        assert r["ids"] == one[case][run]["ids"], run
        assert r["kernel"] == "xla" and r["stats"]["tp"] == 2


@pytest.mark.parametrize("case", ("bucket", "preempt", "budget", "compose"))
def test_tp_engine_equals_the_jax_tp_engine(world, case):
    got, _, _, _, jax = world
    assert got[case]["tp"]["ids"] == jax[case]


def test_sampled_greedy_rider_equals_the_jax_tp_engine(world):
    got, _, _, _, jax = world
    greedy = [ids for ids, kw in zip(got["sampled"]["roomy"]["ids"], SAMPLING) if not kw]
    assert greedy == jax["sampled"]


@pytest.mark.parametrize("case", SERVE_CASES)
def test_follower_ran_every_operation_on_its_heads(world, case):
    got, follower, _, one, _ = world
    for run, r in follower[case].items():
        assert r["ops"] > 0
        assert r["pool_heads"] * 2 == one[case][run]["pool_heads"] == \
            got[case][run]["pool_heads"] * 2
        # every rank's device work runs under the engine's mesh (JAX _mesh_ctx)
        for rank in (got, follower):
            n, all_under = rank[case][run]["prefills_under_mesh"]
            assert n > 0 and all_under


def test_bucket_boundary_and_per_device_bytes(world, models):
    got, _, _, one, _ = world
    r = got["bucket"]["tp"]
    cfg = models["gpt2"][2].config
    assert r["stats"]["bucket_switches"] > 0
    assert r["token_bytes"] * 2 == cfg.num_layers * 2 * cfg.hidden_size * 4
    assert r["summary"]["tp"] == 2
    assert r["summary"]["kv_pool_bytes_per_device"] == r["pool_bytes"]
    assert one["bucket"]["tp"]["summary"]["tp"] == 1


def test_preemption_on_the_same_geometry_halves_the_bytes(world):
    got, _, _, one, _ = world
    r, lone = got["preempt"]["tp"], one["preempt"]["tp"]
    assert r["stats"]["preemptions"] > 0
    assert r["token_bytes"] * 2 == lone["token_bytes"]
    assert r["pool_bytes"] * 2 == lone["pool_bytes"]
    assert r["num_blocks"] == lone["num_blocks"]


def test_kv_pool_bytes_budget_doubles_admission(world, cases):
    got, _, _, one, _ = world
    r, lone = got["budget"]["tp"], one["budget"]["tp"]
    assert lone["num_blocks"] == 5 and r["num_blocks"] == 9
    assert r["peak_resident"] >= 2 * lone["peak_resident"]
    assert r["pool_bytes"] <= cases["budget"]["engine"]["kv_pool_bytes"] + r["block_bytes"]


def test_speculation_prefix_cache_and_int8_compose(world):
    got, *_ = world
    r = got["compose"]["tp"]
    assert r["stats"]["draft_proposed"] > 0
    assert r["stats"]["prefix_cached_tokens"] > 0
    assert r["pool_dtypes"] == ["torch.float32", "torch.int8"]
    assert r["draft_pool_heads"] == r["pool_heads"] == 1


def test_sampled_serving_is_seed_deterministic_across_preemption(world):
    got, *_ = world
    runs = got["sampled"]
    assert runs["again"]["ids"] == runs["roomy"]["ids"]
    assert runs["tight"]["stats"]["preemptions"] > 0
    assert runs["tight"]["ids"] == runs["roomy"]["ids"]


def test_swap_moves_whole_block_sets(world):
    got, _, _, one, _ = world
    r, lone = got["swap"]["tp"], one["swap"]["tp"]
    assert r["stats"]["swap_outs"] > 0 and r["stats"]["swap_ins"] > 0
    # the host holds every head: the same bytes as the single-device engine's
    assert r["stats"]["swap_bytes"] == lone["stats"]["swap_bytes"]


@pytest.mark.parametrize("how", ("greedy", "beam", "spec"))
def test_generation_over_a_cut_model(world, how):
    got, follower, _, one, jax = world
    assert got["generate"][how] == one["generate"][how] == jax["generate"][how]
    assert follower["generate"][how] == got["generate"][how]


def test_generation_holds_this_ranks_heads(world, models):
    got, *_ = world
    cfg = models["llama"][2].config
    assert got["generate"]["qkv_rows"] * 2 == cfg.num_heads * cfg.resolved_head_dim
    assert got["generate"]["cache_heads"] * 2 == cfg.num_kv_heads


def test_a_follower_without_a_leader_ends_within_its_timeout(world):
    orphan = world[2]
    limit = worker.ORPHAN_TIMEOUT.total_seconds()
    assert orphan["raised"] is not None and "Timed out" in orphan["message"], orphan
    assert limit - 0.5 <= orphan["seconds"] < limit + 10


CLI = [sys.executable, "-m", "huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.cli",
       "--device", "cpu", "--requests", "4", "--max_new_tokens", "6", "--num_slots", "2"]


def _lines(text: str) -> list:
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def test_cli_serves_over_two_ranks(tmp_path):
    """The CLI started once per rank as ``torchrun`` starts it (rank 0 with
    ``--tp 2``, rank 1 with ``HSTD_SERVE_TP=2``): rank 0's rows are one
    process's (``--kernel xla``, the route TP serves on) with ``tp`` 2, its
    summary carries ``tp`` and ``kv_pool_bytes_per_device`` at half the
    single-device pool's; rank 1 prints nothing."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2", OMP_NUM_THREADS="1")
    env.pop("HSTD_SERVE_TP", None)
    ranks = [subprocess.Popen(CLI + (["--tp", "2"] if r == 0 else []), cwd=root,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r),
                                       **({"HSTD_SERVE_TP": "2"} if r else {})),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=WORLD_TIMEOUT_S) for p in ranks]
    assert [p.returncode for p in ranks] == [0, 0], [err[-2000:] for _, err in outs]
    one = subprocess.run(CLI + ["--kernel", "xla"], cwd=root, capture_output=True, text=True,
                         timeout=WORLD_TIMEOUT_S,
                         env={k: v for k, v in env.items() if k not in ("WORLD_SIZE",)})
    assert one.returncode == 0, one.stderr[-2000:]
    got, want = _lines(outs[0][0]), _lines(one.stdout)
    assert _lines(outs[1][0]) == []
    assert [r["output_ids"] for r in got[:-1]] == [r["output_ids"] for r in want[:-1]]
    assert all(r["tp"] == 2 for r in got[:-1]) and all(r["tp"] == 1 for r in want[:-1])
    summary, lone = got[-1], want[-1]
    assert summary["tp"] == 2 and summary["kernel"] == "xla"
    assert summary["kv_pool_bytes_per_device"] * 2 == lone["kv_pool_bytes_per_device"]
