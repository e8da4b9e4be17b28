"""Job launcher: hyperparameters -> training processes (counterpart of the
JAX package's ``launch/launcher.py``).

The reference submits its job as a SageMaker ``HuggingFace`` estimator
(``entry_point``, ``hyperparameters``, an instance type and a distribution
knob, then ``estimator.fit()``, reference ``launch.py:36-55``). The port
keeps what the platform does, in the repository:

- **hyperparameters -> argv** (``--key value`` strings, reference
  ``launch.py:51``): :func:`to_argv`, the JAX package's function.
- **job naming** (``{base}-{timestamp}``): :func:`make_job_name`, the JAX
  package's function.
- **the environment contract** (the platform's ``SM_*`` variables): every
  process gets ``TPU_OUTPUT_DATA_DIR``/``TPU_MODEL_DIR`` (the job directory's
  ``output/`` and ``model/``), ``HSTD_TELEMETRY_DIR`` (the caller's, else
  ``output/telemetry``), ``HSTD_COMPILE_CACHE_DIR`` (the caller's, else a
  caller's ``TPU_COMPILATION_CACHE_DIR``, else ``<job_root>/compile_cache``:
  the JAX package's precedence; the port accepts the variable and caches
  nothing with it, its kernels being built once per checkout under
  ``build/kernels``) and the rendezvous triplet ``TPU_COORDINATOR_ADDRESS``
  / ``TPU_NUM_PROCESSES`` / ``TPU_PROCESS_ID`` that
  ``parallel/distributed.py`` reads.
- **process launch**: :class:`LocalBackend` starts the processes on this
  machine: on ``cpu-N`` one per simulated host, each on the CPU over gloo
  (no GPU visible to it, and the entry point asked for ``--device cpu``);
  on ``h100-N`` one per GPU, each host's processes given that host's GPUs
  of this machine (``CUDA_VISIBLE_DEVICES``, ``LOCAL_RANK``) and NCCL. A
  GPU slice larger than this machine's GPUs raises; it never falls back to
  the CPU. :class:`NodeBackend` builds, for a slice of several nodes, one
  ``ssh <node> 'cd <src> && ... torchrun --nnodes N --node_rank i ...'``
  command per node (``torchrun`` sets the ``RANK``, ``WORLD_SIZE`` and
  ``LOCAL_RANK`` the port reads), and prints them rather than running them
  unless ``execute=True``.
- **artifacts**: the job directory holds each process's log
  (``host_<i>.log``) beside ``model/`` and ``output/``.
"""

from __future__ import annotations

import datetime
import os
import shlex
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.launch.slice import SliceConfig
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

PKG = "huggingface_sagemaker_tensorflow_distributed_tpu_torch"
# the port's training CLI: the default entry point, run as a module
TRAIN_ENTRY = f"{PKG}.train.cli"
# the checkout that holds the package: the default source directory
SOURCE_ROOT = str(Path(__file__).resolve().parents[2])
# seconds a terminated process has to exit before it is killed
KILL_AFTER_S = 5.0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def to_argv(hyperparameters: dict) -> list[str]:
    """Serialize a hyperparameter dict to ``--key value`` CLI strings (the
    platform contract of reference ``launch.py:51``: every value
    stringified, booleans as ``true``/``false``)."""
    argv: list[str] = []
    for key, value in hyperparameters.items():
        argv.append(f"--{key}")
        if isinstance(value, bool):
            argv.append("true" if value else "false")
        else:
            argv.append(str(value))
    return argv


def make_job_name(base: str, when: Optional[float] = None) -> str:
    """``{base}-{YYYY-mm-dd-HH-MM-SS}`` with ``/`` and ``_`` made ``-``."""
    ts = datetime.datetime.fromtimestamp(time.time() if when is None else when)
    safe = base.replace("/", "-").replace("_", "-").strip("-")
    return f"{safe}-{ts.strftime('%Y-%m-%d-%H-%M-%S')}"


def entry_command(entry_point: str) -> list[str]:
    """How ``entry_point`` starts after the interpreter: a ``.py`` path as a
    script, anything else as a module (``-m``)."""
    return [entry_point] if entry_point.endswith(".py") else ["-m", entry_point]


def compile_cache_dir(env: dict, job_root: str) -> str:
    """``HSTD_COMPILE_CACHE_DIR``, else ``TPU_COMPILATION_CACHE_DIR``, else
    ``<job_root>/compile_cache`` (an operator's setting wins under either
    spelling)."""
    return (env.get("HSTD_COMPILE_CACHE_DIR") or env.get("TPU_COMPILATION_CACHE_DIR")
            or os.path.join(job_root, "compile_cache"))


def _default_job_root() -> str:
    return os.path.join(tempfile.gettempdir(), "gpu_jobs")


@dataclass
class GPUJob:
    """Estimator-style job (the JAX package's ``TPUJob`` fields, reference
    ``launch.py:36-54``): an entry point (a module of the port, or a
    script) run from ``source_dir`` on a slice (``h100-N``, ``h200-N`` or
    ``cpu-N``) with the hyperparameters as ``--key value`` arguments."""

    entry_point: str = TRAIN_ENTRY
    source_dir: str = SOURCE_ROOT
    slice_spec: str = "h100-1"           # h100-N / h200-N; cpu-N = local simulator
    num_hosts: Optional[int] = None      # simulated hosts (local backend)
    hyperparameters: dict = field(default_factory=dict)
    base_job_name: str = "gpu-finetune"
    job_root: str = field(default_factory=_default_job_root)
    coordinator_port: Optional[int] = None   # None: a free port per job
    env: dict = field(default_factory=dict)

    def __post_init__(self):
        self.slice = SliceConfig.parse(self.slice_spec)

    def fit(self, wait: bool = True, backend=None) -> "JobHandle":
        """Submit the job (``estimator.fit()``, reference ``launch.py:55``):
        on this machine when the slice is ``cpu-N`` or one node
        (:class:`LocalBackend`), else the node commands
        (:class:`NodeBackend`, printed, not run), unless ``backend`` is
        given."""
        job_name = make_job_name(self.base_job_name)
        job_dir = os.path.join(self.job_root, job_name)
        os.makedirs(job_dir, exist_ok=True)
        if backend is None:
            local = self.slice.accelerator == "cpu" or self.slice.num_hosts == 1
            backend = LocalBackend() if local else NodeBackend()
        handle = backend.launch(self, job_name, job_dir)
        if wait:
            handle.wait()
        return handle


class JobHandle:
    """A launched job: its processes (local, or one ``ssh`` a node) or the
    node commands it printed."""

    def __init__(self, job_name: str, job_dir: str, procs: Optional[list] = None,
                 remote_command: Optional[list] = None):
        self.job_name = job_name
        self.job_dir = job_dir
        self.procs = procs or []
        self.remote_command = remote_command
        self.returncodes: Optional[list[int]] = None
        self.first_failure: Optional[tuple[int, int]] = None   # (process index, code)

    @property
    def model_dir(self) -> str:
        return os.path.join(self.job_dir, "model")

    @property
    def output_data_dir(self) -> str:
        return os.path.join(self.job_dir, "output")

    @property
    def returncode(self) -> Optional[int]:
        """The job's code: the first failing process's (by time, then by
        index), 0 when all succeeded, None before :meth:`wait` ends."""
        if self.returncodes is None:
            return None
        return 0 if self.first_failure is None else self.first_failure[1]

    def wait(self, timeout: Optional[float] = None, grace_period: float = 10.0) -> list[int]:
        """Block until every process exits; raise if any failed (all or
        nothing: the reference's platform ends the job when a rank dies).
        Polls every process: once one has failed, the survivors (as a rule
        waiting for the dead rank at the next collective) get
        ``grace_period`` seconds, then are terminated. Past ``timeout``
        every process is terminated and ``subprocess.TimeoutExpired``
        raised."""
        if not self.procs:
            return []
        deadline = None if timeout is None else time.time() + timeout
        failed_at: Optional[float] = None
        while True:
            codes = [p.poll() for p in self.procs]
            if all(c is not None for c in codes):
                break
            now = time.time()
            self._note_failure(codes)
            if self.first_failure is not None and failed_at is None:
                failed_at = now
            if failed_at is not None and now - failed_at > grace_period:
                self.terminate()
            if deadline is not None and now > deadline:
                self.terminate()
                raise subprocess.TimeoutExpired(cmd=f"job {self.job_name}", timeout=timeout)
            time.sleep(0.2)
        self._note_failure(codes)
        self.returncodes = codes
        if any(codes):
            raise RuntimeError(f"job {self.job_name}: process(es) failed with codes {codes} "
                               f"(first: {self.returncode}); logs under {self.job_dir}")
        return codes

    def _note_failure(self, codes: list) -> None:
        if self.first_failure is None:
            failed = [(i, c) for i, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                self.first_failure = failed[0]

    def terminate(self) -> None:
        """SIGTERM to each live process's group (its children too), then
        SIGKILL to those still alive after ``KILL_AFTER_S``."""
        live = [p for p in self.procs if p.poll() is None]
        for p in live:
            _signal_group(p, signal.SIGTERM)
        end = time.time() + KILL_AFTER_S
        while any(p.poll() is None for p in live) and time.time() < end:
            time.sleep(0.1)
        for p in live:
            if p.poll() is None:
                _signal_group(p, signal.SIGKILL)
                p.wait()


def _signal_group(proc, sig) -> None:
    try:
        os.killpg(proc.pid, sig)
    except (ProcessLookupError, PermissionError):
        pass


def _spawn(argv: list, env: Optional[dict], cwd: Optional[str], log_path: str):
    """``argv`` in a session of its own (so :meth:`JobHandle.terminate`
    reaches its children), stdout and stderr to ``log_path``."""
    with open(log_path, "w") as log:   # the child inherits the descriptor
        return subprocess.Popen(argv, env=env, cwd=cwd, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)


def visible_gpus() -> list[str]:
    """The GPUs this process may hand out: ``CUDA_VISIBLE_DEVICES`` when
    set, else every GPU torch counts."""
    listed = os.environ.get("CUDA_VISIBLE_DEVICES")
    if listed is not None:
        return [d for d in listed.split(",") if d.strip()]
    import torch

    return [str(i) for i in range(torch.cuda.device_count())]


class LocalBackend:
    """The job on this machine: ``cpu-N`` as ``num_hosts`` CPU processes
    over gloo (the slice simulator), ``h100-N`` as one process per GPU of
    this machine over NCCL; every process told the rendezvous, its rank and
    the job's directories."""

    def launch(self, job: GPUJob, job_name: str, job_dir: str) -> JobHandle:
        handle = JobHandle(job_name, job_dir)
        cpu = job.slice.accelerator == "cpu"
        n_hosts = job.num_hosts or job.slice.num_hosts
        if cpu:
            per_host, gpus = 1, []
        else:
            gpus = visible_gpus()
            if job.slice.num_chips > len(gpus):
                raise ValueError(
                    f"slice {job.slice.name} needs {job.slice.num_chips} GPUs; this "
                    f"machine offers {len(gpus)} (use cpu-N for the CPU simulator)")
            if job.slice.num_chips % n_hosts:
                raise ValueError(f"{job.slice.num_chips} GPUs do not split over "
                                 f"{n_hosts} hosts")
            per_host = job.slice.num_chips // n_hosts
        world = n_hosts * per_host
        argv = ([sys.executable] + entry_command(job.entry_point)
                + to_argv(job.hyperparameters))
        if cpu and "device" not in job.hyperparameters:
            argv += ["--device", "cpu"]
        coord = f"127.0.0.1:{job.coordinator_port or _free_port()}"
        base = {**os.environ, **job.env}
        pythonpath = [SOURCE_ROOT] + ([base["PYTHONPATH"]] if base.get("PYTHONPATH") else [])
        procs = []
        for host in range(n_hosts):
            for local in range(per_host):
                rank = host * per_host + local
                env = dict(base, PYTHONPATH=os.pathsep.join(pythonpath))
                env.update({
                    "TPU_COORDINATOR_ADDRESS": coord,
                    "TPU_NUM_PROCESSES": str(world),
                    "TPU_PROCESS_ID": str(rank),
                    "TPU_OUTPUT_DATA_DIR": handle.output_data_dir,
                    "TPU_MODEL_DIR": handle.model_dir,
                    # every rank gets the same directory; only rank 0 writes
                    "HSTD_TELEMETRY_DIR": base.get("HSTD_TELEMETRY_DIR")
                    or os.path.join(handle.output_data_dir, "telemetry"),
                    "HSTD_COMPILE_CACHE_DIR": compile_cache_dir(base, job.job_root),
                })
                if cpu:
                    env["CUDA_VISIBLE_DEVICES"] = ""
                else:
                    env["CUDA_VISIBLE_DEVICES"] = ",".join(
                        gpus[host * per_host:(host + 1) * per_host])
                    env["LOCAL_RANK"] = str(local)
                name = f"host_{host}.log" if local == 0 else f"host_{host}.rank_{rank}.log"
                procs.append(_spawn(argv, env, job.source_dir, os.path.join(job_dir, name)))
        handle.procs = procs
        logger.info("local job %s: %d host(s) x %d process(es) on %s, logs in %s", job_name,
                    n_hosts, per_host, "the CPU" if cpu else f"GPUs {gpus[:world]}", job_dir)
        return handle


class NodeBackend:
    """A slice of several nodes: one ``ssh`` command a node that starts
    ``torchrun`` there (the port's form of the reference's MPI
    distribution knob, reference ``launch.py:22``). ``nodes`` names the
    hosts in rank order (``$NODE_<i>`` placeholders when not given); the
    first is the rendezvous. The commands are printed, and run (one
    process a node, its output in ``node_<i>.log``) only with
    ``execute=True``."""

    def __init__(self, nodes: Optional[list] = None, master_port: int = 29500,
                 ssh: str = "ssh", execute: bool = False):
        self.nodes = nodes
        self.master_port = master_port
        self.ssh = ssh
        self.execute = execute

    def commands(self, job: GPUJob, job_dir: str) -> list[list[str]]:
        n, per_node = job.slice.num_hosts, job.slice.chips_per_host
        nodes = list(self.nodes) if self.nodes else [f"$NODE_{i}" for i in range(n)]
        if len(nodes) != n:
            raise ValueError(f"slice {job.slice.name} is {n} nodes; {len(nodes)} named")
        env = {"TPU_OUTPUT_DATA_DIR": os.path.join(job_dir, "output"),
               "TPU_MODEL_DIR": os.path.join(job_dir, "model"),
               "HSTD_COMPILE_CACHE_DIR": compile_cache_dir(os.environ, job.job_root)}
        cmds = []
        for i, node in enumerate(nodes):
            run = (["torchrun", "--nnodes", str(n), "--node_rank", str(i),
                    "--nproc_per_node", str(per_node), "--master_addr", nodes[0],
                    "--master_port", str(self.master_port)]
                   + entry_command(job.entry_point) + to_argv(job.hyperparameters))
            remote = (f"cd {shlex.quote(job.source_dir)} && "
                      + " ".join(f"{k}={shlex.quote(v)}" for k, v in env.items()) + " "
                      + " ".join(_quote(a) for a in run))
            cmds.append([self.ssh, node, remote])
        return cmds

    def launch(self, job: GPUJob, job_name: str, job_dir: str) -> JobHandle:
        cmds = self.commands(job, job_dir)
        handle = JobHandle(job_name, job_dir, remote_command=cmds)
        if self.execute:
            handle.procs = [_spawn(c, None, None, os.path.join(job_dir, f"node_{i}.log"))
                            for i, c in enumerate(cmds)]
        else:
            print(f"job {job_name}: run on the {len(cmds)} nodes with:", flush=True)
            for c in cmds:
                print("  " + " ".join(_quote(a) for a in c), flush=True)
        return handle


def _quote(arg: str) -> str:
    """Shell-quoted, but a ``$NAME`` placeholder stays open to expansion."""
    return arg if arg.startswith("$") else shlex.quote(arg)
