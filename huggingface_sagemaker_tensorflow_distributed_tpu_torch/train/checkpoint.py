"""Checkpoint / resume (counterpart of the JAX package's
``train/checkpoint.py`` ``Checkpointer``; Orbax has no PyTorch
counterpart, so the port writes its own format).

One directory per checkpoint, named by the trainer's micro-step count:
``<dir>/<step>/state.pt`` (``torch.save`` of the trainer's state dict:
model and optimizer state, ``step`` and ``updates``, the partial
gradient accumulators, the CPU and CUDA generator states) and
``<dir>/<step>/meta.json`` (``{"epoch", "step_in_epoch"}``: the data
position). It is written under a temporary name, flushed to disk, and
renamed when complete, so a crash never leaves a half checkpoint that
``latest_step`` would pick; the oldest beyond ``max_to_keep`` are
deleted.

- ``save`` copies the state to host memory (pinned buffers kept across
  saves on CUDA) and waits for that copy before it returns: the next
  optimizer step mutates the device tensors in place, so a write from
  them on a thread would save a torn state. With ``async_save`` the
  write then runs on a background thread; saves are serialised (a new
  save waits for the previous write), and a failed write raises at the
  next ``save``, ``restore``, ``wait_until_finished`` or ``close``.
- As Orbax does, a save whose step is not past the latest checkpoint is
  skipped, and ``force`` saves it anyway unless that step exists.
- Only rank 0 writes; every rank restores; a barrier follows every save.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import torch
import torch.distributed as dist

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.distributed import (
    rank,
    world_size,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

STATE_FILE = "state.pt"
META_FILE = "meta.json"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class Checkpointer:
    """Saves and restores the trainer's state dict under ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 3, async_save: bool = True):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._rank, self._world = rank(), world_size()
        if self._rank == 0:
            os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pinned: dict = {}    # reusable host buffers, by position in the state

    # -- host copy -------------------------------------------------------------

    def _to_host(self, obj: Any, key: tuple = ()) -> Any:
        """``obj`` with every tensor copied to host memory; device copies
        are queued into pinned buffers and waited for by the caller."""
        if isinstance(obj, torch.Tensor):
            if obj.device.type == "cpu":
                return obj.detach().clone()
            buf = self._pinned.get(key)
            if buf is None or buf.shape != obj.shape or buf.dtype != obj.dtype:
                buf = torch.empty(obj.shape, dtype=obj.dtype, pin_memory=True)
                self._pinned[key] = buf
            buf.copy_(obj.detach(), non_blocking=True)
            return buf
        if isinstance(obj, dict):
            return {k: self._to_host(v, key + (k,)) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._to_host(v, key + (i,)) for i, v in enumerate(obj))
        return obj

    # -- save ------------------------------------------------------------------

    def save(self, state: dict, epoch: int = 0, step_in_epoch: int = 0,
             force: bool = False) -> None:
        """Checkpoint ``state`` (a trainer state dict with an integer
        ``step``) with the data position ``epoch``/``step_in_epoch``, so
        a mid-epoch resume continues the epoch's permutation instead of
        replaying it."""
        step = int(state["step"])
        if self._rank == 0:
            self.wait_until_finished()
            latest = self.latest_step()
            if not force and latest is not None and latest >= step:
                logger.info("checkpoint at step %d already exists — skipped", step)
            elif os.path.exists(self._step_dir(step)):
                raise FileExistsError(f"checkpoint for step {step} already exists "
                                      f"in {self.directory}")
            else:
                host = self._to_host(state)
                if torch.cuda.is_available() and torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                meta = {"epoch": int(epoch), "step_in_epoch": int(step_in_epoch)}
                if self.async_save:
                    self._thread = threading.Thread(target=self._write_guarded,
                                                    args=(step, host, meta),
                                                    name="hstd-checkpoint", daemon=False)
                    self._thread.start()
                else:
                    self._write(step, host, meta)
                logger.info("checkpoint save started at step %d (epoch %d, step-in-epoch "
                            "%d) → %s", step, epoch, step_in_epoch, self.directory)
        if self._world > 1:
            dist.barrier()

    def _write_guarded(self, step: int, host: dict, meta: dict) -> None:
        try:
            self._write(step, host, meta)
        except BaseException as e:  # noqa: BLE001 - re-raised by wait_until_finished
            self._error = e

    def _write(self, step: int, host: dict, meta: dict) -> None:
        with obs.span("train/checkpoint_write", {"step": step}):
            final = self._step_dir(step)
            tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            with open(os.path.join(tmp, STATE_FILE), "wb") as f:
                torch.save(host, f)
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(tmp, META_FILE), "w", encoding="utf-8") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
            _fsync_dir(self.directory)
            for old in self._steps()[:-self.max_to_keep]:   # 0 keeps every one
                shutil.rmtree(self._step_dir(old))

    def wait_until_finished(self) -> None:
        """Block until an in-flight async save is on disk; raise its
        error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    # -- restore ---------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self) -> Optional[tuple[dict, int, int]]:
        """The latest checkpoint as ``(state dict on the CPU, epoch,
        step_in_epoch)``, or None when there is none. A just-started
        async save counts."""
        self.wait_until_finished()
        if self._world > 1:
            dist.barrier()
        step = self.latest_step()
        if step is None:
            return None
        path = self._step_dir(step)
        state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                           weights_only=True)
        with open(os.path.join(path, META_FILE), encoding="utf-8") as f:
            meta = json.load(f)
        logger.info("restored checkpoint step %d (epoch %d, step-in-epoch %d) from %s",
                    step, meta["epoch"], meta["step_in_epoch"], self.directory)
        return state, int(meta["epoch"]), int(meta["step_in_epoch"])

    def close(self) -> None:
        """Commit any in-flight write (raising if it failed) and release
        the host buffers."""
        try:
            self.wait_until_finished()
        finally:
            self._pinned = {}
