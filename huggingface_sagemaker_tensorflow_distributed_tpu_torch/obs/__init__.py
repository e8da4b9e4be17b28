"""``obs``: the port's telemetry (counterpart of the JAX package's
``obs``), with the same environment contract and file names, so
``scripts/obsctl.py`` and ``scripts/check_telemetry_schema.py`` read the
port's event files::

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs

    with obs.span("train/step_dispatch"):
        ...
    obs.scalar("train/loss", 0.31, step=120)

The data pipeline's spans are ``data/next_batch`` (the consumer's wait on
the prefetch queue), ``data/h2d_stage`` around ``data/host_to_device``
(staging a batch onto the card), ``data/stream_batch`` (a streaming
batch read and tokenized) and ``data/corpus_read``; its metrics
``data/producer_wait_s``, ``data/consumer_wait_s`` (with the achieved
depth) and ``data/h2d_stage_s``, and :func:`autotune` its controllers'
decisions.

- ``HSTD_TELEMETRY=0`` disables everything.
- ``HSTD_TELEMETRY_DIR=<dir>`` (or :func:`configure`) writes
  ``<dir>/events.jsonl`` and ``<dir>/trace.json``; unset, spans and
  metrics are no-ops.
- ``HSTD_HEARTBEAT_SECS`` sets the liveness cadence (default 60).

One process-wide :class:`~.core.ObsState` backs the functions below. The
heartbeat and the anomaly detector are created on first use; the
trainer asks for them only on instrumented runs, so a fit without a
telemetry directory starts no thread. :func:`shutdown` stops them.
"""

from __future__ import annotations

import os
from typing import Optional

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import flops  # noqa: F401
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.anomaly import (
    AnomalyDetector,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.core import (
    ENV_HEARTBEAT,
    MetricsSink,
    ObsState,
    Tracer,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.watchdog import Heartbeat

_state = ObsState()
_tracer = Tracer(_state)
_metrics = MetricsSink(_state)
_heartbeat: Optional[Heartbeat] = None
_detector: Optional[AnomalyDetector] = None


def state() -> ObsState:
    return _state


def has_sink() -> bool:
    """True when THIS process streams events to disk (rank 0 of an
    instrumented run)."""
    return _state.events is not None


def configured() -> bool:
    """True when telemetry is on with an output dir. Unlike
    :func:`has_sink` this is the same on every rank, so it is the guard
    for collectives that feed telemetry (the per-epoch straggler gather)."""
    return _state.enabled and _state.dir is not None


def configure(out_dir: Optional[str] = None, enabled: Optional[bool] = None) -> None:
    _state.configure(out_dir=out_dir, enabled=enabled)


def set_host(index: int, count: int) -> None:
    _state.set_host(index, count)


def span(name: str, args: Optional[dict] = None):
    """Nestable wall-time span (context manager); the shared no-op span
    when telemetry is off or has no directory."""
    return _tracer.span(name, args)


def scalar(name: str, value, step: Optional[int] = None,
           args: Optional[dict] = None) -> None:
    _metrics.scalar(name, value, step, args)


def metrics() -> MetricsSink:
    return _metrics


def autotune(name: str, depth: int, reason: str,
             args: Optional[dict] = None) -> None:
    """One input-pipeline controller decision (the schema's ``autotune``
    event): ``name`` is the tuned knob (``data/prefetch_depth``,
    ``data/read_coalesce_gap``), ``depth`` its new value, ``reason`` the
    trigger. No-op without a file sink, like :func:`scalar`."""
    if not _state.enabled or _state.events is None:
        return
    fields: dict = {"name": name, "depth": int(depth), "reason": str(reason)}
    if args:
        fields["args"] = args
    _state.events.emit("autotune", fields)


def serve(event: str, **fields) -> None:
    """One serving-engine event (the schema's ``serve`` type): ``event``
    names it (``submit``, ``admit``, ``first_token``, ``finish``,
    ``preempt``, ``bucket_switch``, ``swap_out``, ``swap_in``,
    ``request_timeline``, ``iteration_ledger``, ``report``), the fields
    ride along. No-op without a file sink, like :func:`scalar`."""
    if not _state.enabled or _state.events is None:
        return
    _state.events.emit("serve", {"event": str(event), **fields})


def anomalies() -> AnomalyDetector:
    """The process anomaly detector (created on first use; reads
    ``HSTD_ANOMALY``, ``HSTD_ANOMALY_COOLDOWN_S``, ``HSTD_STRAGGLER_ALERT``,
    ``HSTD_FLIGHT_RING`` and ``HSTD_PROFILE_ON_ANOMALY``)."""
    global _detector
    if _detector is None:
        _detector = AnomalyDetector(_state, recorder=_state.ring)
    return _detector


def _heartbeat_env_interval() -> float:
    """``HSTD_HEARTBEAT_SECS`` as a float; unset or malformed gives 60."""
    raw = os.environ.get(ENV_HEARTBEAT, "").strip()
    try:
        return float(raw) if raw else 60.0
    except ValueError:
        return 60.0


def _stall_to_detector(age: float, thread: str) -> None:
    # only a detector that already exists hears of a stall: the heartbeat
    # thread creates no policy object behind the run's back
    if _detector is not None and _detector._state is _state:
        _detector.observe_stall(age, thread)


def heartbeat() -> Heartbeat:
    """The process heartbeat (created on first use, not started; interval
    from ``HSTD_HEARTBEAT_SECS``)."""
    global _heartbeat
    if _heartbeat is None:
        _heartbeat = Heartbeat(_state, interval=_heartbeat_env_interval(),
                               on_stall=_stall_to_detector)
    return _heartbeat


def pulse() -> None:
    """Mark forward progress for the stall watchdog (no-op until a
    heartbeat exists)."""
    hb = _heartbeat
    if hb is not None:
        hb.pulse()


def flush() -> None:
    """Write trace.json from the span buffer."""
    _state.flush_trace()


def shutdown() -> None:
    """Stop the heartbeat, close any anomaly profiler window, write
    trace.json and close the event file."""
    global _heartbeat, _detector
    if _heartbeat is not None:
        _heartbeat.stop()
        _heartbeat = None
    if _detector is not None:
        _detector.shutdown()
        _detector = None
    _state.shutdown()


def reset(out_dir: Optional[str] = None, enabled: Optional[bool] = None) -> ObsState:
    """:func:`shutdown`, then a fresh process state (the environment read
    again), optionally configured with ``out_dir``/``enabled``."""
    global _state, _tracer, _metrics
    shutdown()
    _state = ObsState()
    _tracer = Tracer(_state)
    _metrics = MetricsSink(_state)
    if out_dir is not None or enabled is not None:
        _state.configure(out_dir=out_dir, enabled=enabled)
    return _state
