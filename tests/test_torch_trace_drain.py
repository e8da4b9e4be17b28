"""PyTorch port: a drained resident's stitched phases when the cohort's
block-set pull is slow (``serve/router.py``'s drain, ``serve/transport.py``'s
``migrate_request``, ``obs/trace.py``'s decomposition).

A drain pulls every hot resident's block set in one call and gives each an
even share of its seconds as ``extract_s``; the stitcher takes the hops'
``extract_s`` out of the migration hold (``decode_admission = hold -
extract``). The hold must therefore contain the pull: a prefetched
resident's hold opens where the pull began. Here the pull is slowed to
``PULL_S`` so that it outweighs the hold that follows it on a destination
that re-admits at once, as one wait for a whole cohort does on the card.
The port's stitched traces must pass ``check_trace`` (its tolerance and
decomposition as they are) with no negative ``decode_admission`` and
``transport >= extract_s``. The JAX router, on the same schedule with the
same slowed pull, opens the hold after the pull (``serve/transport.py:168``)
and shows the negative phase that ``check_trace`` flags."""

import time

import numpy as np
import pytest

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import schema as t_schema
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import trace as t_trace
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve import router as t_router
from torch_decode_pairs import (  # noqa: F401
    detached_compile_trackers,
    gpt2_pair,
    one_torch_thread,
)

EOS = 127
PULL_S = 0.15                   # the slowed cohort pull, seconds
# eight slots a replica: the destination holds its own three requests and
# re-admits the three migrants in its next iteration
KW = dict(num_slots=8, block_size=4, num_blocks=64, prefill_chunk=8, max_model_len=64,
          gather_buckets=[16, 32], timeline="on")
STEPS_BEFORE_DRAIN = 3


@pytest.fixture(scope="module")
def pair():
    return gpt2_pair(num_layers=2, vocab=128, eos_token_id=EOS, pad_token_id=0)


def _trace():
    """Six requests: round robin puts three on each replica, every prompt
    one prefill chunk, each decoding well past the drain."""
    rng = np.random.RandomState(5)
    return [(rng.randint(1, 120, (int(rng.randint(5, 9)),)).astype(np.int32), 16)
            for _ in range(6)]


def _slowed(module, monkeypatch):
    real = module.extract_block_sets
    pulls = []

    def slow(*args, **kwargs):
        time.sleep(PULL_S)
        sets = real(*args, **kwargs)
        pulls.append(len(sets))
        return sets

    monkeypatch.setattr(module, "extract_block_sets", slow)
    return pulls


def _drained(router, trace, out):
    obs_mod = out["obs"]
    obs_mod.reset(out_dir=str(out["dir"]), enabled=True)
    try:
        for prompt, new in trace:
            router.submit(prompt, new)
        router.warmup()
        for _ in range(STEPS_BEFORE_DRAIN):
            router.step()
        router.drain(0)
        router.run()
        obs_mod.flush()
    finally:
        obs_mod.reset()
    events = [e for _, e, err in t_schema.iter_events(str(out["dir"] / "events.jsonl"))
              if err is None]
    return events


def _admissions(traces) -> list:
    return [t["phases"]["decode_admission"] for t in traces if t["hops"]]


def test_port_drain_hold_contains_the_cohort_pull(pair, tmp_path, monkeypatch):
    _, _, model = pair
    pulls = _slowed(t_router, monkeypatch)
    router = t_router.Router(model, replicas=2, placement="round_robin", device="cpu", **KW)
    events = _drained(router, _trace(), {"obs": obs, "dir": tmp_path / "port"})
    assert pulls == [3], f"one cohort pull of the three hot residents, got {pulls}"
    assert router.migrations == 3
    traces = t_trace.collect_traces(events)
    assert len(traces) == 6 and all(t["complete"] for t in traces)
    moved = [t for t in traces if t["hops"]]
    assert len(moved) == 3
    for tr in traces:
        assert t_trace.check_trace(tr) == [], tr["trace_id"]
    for tr in moved:
        extract = sum(float(m.get("extract_s") or 0.0) for m in tr["migrates"])
        assert extract >= PULL_S / 3 * 0.9
        assert tr["phases"]["decode_admission"] >= 0, tr["phases"]
        assert tr["phases"]["transport"] >= extract


def test_jax_router_shows_the_negative_admission(pair, tmp_path, monkeypatch):
    """The reference on the same schedule: its hold opens after the pull,
    so each prefetched resident's admission reads negative by about its
    share of the pull, past ``check_trace``'s tolerance."""
    from huggingface_sagemaker_tensorflow_distributed_tpu import obs as j_obs
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import trace as j_trace
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve import router as j_router

    jmodel, params, _ = pair
    pulls = _slowed(j_router, monkeypatch)
    router = j_router.Router(jmodel, params, replicas=2, placement="round_robin", **KW)
    events = _drained(router, _trace(), {"obs": j_obs, "dir": tmp_path / "jax"})
    assert pulls == [3]
    traces = j_trace.collect_traces(events)
    assert len(traces) == 6 and all(t["complete"] for t in traces)
    admissions = _admissions(traces)
    assert len(admissions) == 3
    assert min(admissions) < -PULL_S / 6, admissions
    assert any("negative decode_admission" in e
               for tr in traces for e in j_trace.check_trace(tr))
