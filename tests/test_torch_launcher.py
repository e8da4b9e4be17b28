"""PyTorch port: the launcher (``launch/``, ROADMAP queue 1, item 5), held
against the JAX package's ``launch/`` and ported from
``tests/test_launcher.py``: hyperparameter serialization and job names
equal to the JAX functions', the GPU slice topology, the node commands
(built and printed, and run through a stub ``ssh`` and ``torchrun`` on
``PATH``), the all-or-nothing wait (a failed rank terminates the
survivors, a failing subset keeps its artifacts, the first failure's code
wins, a hung worker times out), the environment contract of the CPU and
the GPU slices, a two-host job of the port's training CLI on the CPU over
gloo, and the kill-relaunch-resume drill. The dcn-axis and
expert-parallel jobs of the JAX tests wait for ROADMAP item 11.

Every subprocess runs under a timeout of its own, at tiny widths."""

import json
import os
import re
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.launch import (
    GPUJob,
    LocalBackend,
    NodeBackend,
    SliceConfig,
    make_job_name,
    to_argv,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.launch import __main__ as t_main
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.launch import launcher as t_launcher

PKG = "huggingface_sagemaker_tensorflow_distributed_tpu_torch"
JOB_TIMEOUT_S = 60
TINY_BERT = {"model_type": "bert", "vocab_size": 256, "hidden_size": 32,
             "num_hidden_layers": 1, "num_attention_heads": 4, "intermediate_size": 64,
             "max_position_embeddings": 64}


@pytest.mark.parametrize("hp", [
    {"epochs": 3, "learning_rate": 5e-5, "do_train": True, "model_name_or_path": "bert-base"},
    {"remat": False, "train_batch_size": 8, "slice": "h100-16", "weight_decay": 0.01},
    {},
], ids=["reference", "mixed", "empty"])
def test_to_argv_and_job_name_equal_jax(hp):
    from huggingface_sagemaker_tensorflow_distributed_tpu.launch import launcher as j_launcher

    assert to_argv(hp) == j_launcher.to_argv(hp)
    for base, when in (("bert/large_wwm", 1700000000.0), ("-gpu_finetune-", 1.5e9)):
        assert make_job_name(base, when) == j_launcher.make_job_name(base, when)
    assert to_argv({"epochs": 3, "do_train": True}) == ["--epochs", "3", "--do_train", "true"]


def test_slice_topology():
    s = SliceConfig.parse("h100-16")
    assert (s.num_hosts, s.chips_per_host, s.name) == (2, 8, "h100-16")
    assert (SliceConfig.parse("h100-8").num_hosts, SliceConfig.parse("h100-8").chips_per_host) \
        == (1, 8)
    assert SliceConfig.parse("h100-1").chips_per_host == 1
    assert SliceConfig.parse("H200-32").num_hosts == 4
    cpu = SliceConfig.parse("cpu-8")
    assert (cpu.accelerator, cpu.num_hosts, cpu.chips_per_host) == ("cpu", 1, 8)
    for bad in ("h100", "h100-0", "gpu:8"):
        with pytest.raises(ValueError, match="bad slice spec"):
            SliceConfig.parse(bad)
    # a TPU slice names no accelerator the port knows, as an unknown one
    # raises in the JAX package
    with pytest.raises(ValueError, match="unknown accelerator 'v5e'"):
        SliceConfig.parse("v5e-32").num_hosts
    with pytest.raises(ValueError, match="must fill its nodes"):
        SliceConfig.parse("h100-12").num_hosts


def test_node_command_built_not_run(tmp_path, capsys):
    job = GPUJob(slice_spec="h100-16", hyperparameters={"epochs": 1},
                 job_root=str(tmp_path), source_dir="/src dir")
    handle = NodeBackend(nodes=["gpu-a", "gpu-b"]).launch(job, "jobname",
                                                          str(tmp_path / "jobname"))
    assert handle.procs == []
    cmds = handle.remote_command
    assert [c[:2] for c in cmds] == [["ssh", "gpu-a"], ["ssh", "gpu-b"]]
    for i, (_, _, remote) in enumerate(cmds):
        assert remote.startswith("cd '/src dir' && TPU_OUTPUT_DATA_DIR=")
        assert f"TPU_MODEL_DIR={tmp_path}/jobname/model" in remote
        assert (f"torchrun --nnodes 2 --node_rank {i} --nproc_per_node 8 --master_addr gpu-a "
                f"--master_port 29500 -m {PKG}.train.cli --epochs 1") in remote
    printed = capsys.readouterr().out
    assert "run on the 2 nodes" in printed and printed.count("ssh gpu-") == 2
    # a multi-node slice through fit(): the node backend, placeholders printed
    handle = GPUJob(slice_spec="h100-16", job_root=str(tmp_path)).fit()
    assert handle.procs == [] and handle.remote_command[1][1] == "$NODE_1"
    assert "ssh $NODE_0 " in capsys.readouterr().out
    with pytest.raises(ValueError, match="2 nodes; 1 named"):
        NodeBackend(nodes=["only"]).commands(job, str(tmp_path))


def _stubs(tmp_path, monkeypatch):
    """A stub ``ssh`` that runs the command it is given in a local shell,
    and a stub ``torchrun`` that runs the entry once with ``NODE_RANK``
    set (the real one starts ``--nproc_per_node`` ranks)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "ssh").write_text(textwrap.dedent("""\
        #!/bin/bash
        # stub: $1 is the node, $2 the command; run it here
        exec bash -c "$2"
    """))
    (bin_dir / "torchrun").write_text(textwrap.dedent(f"""\
        #!/bin/bash
        while [ $# -gt 0 ]; do
          case "$1" in
            --node_rank) export NODE_RANK=$2; shift 2;;
            --nnodes|--nproc_per_node|--master_addr|--master_port) shift 2;;
            *) break;;
          esac
        done
        exec {sys.executable} "$@"
    """))
    for f in ("ssh", "torchrun"):
        (bin_dir / f).chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")


def _node_job(tmp_path, entry: str, hp=None):
    src = tmp_path / "src"
    src.mkdir(exist_ok=True)
    (src / "entry.py").write_text(textwrap.dedent(entry))
    job = GPUJob(entry_point="entry.py", source_dir=str(src), slice_spec="h100-16",
                 hyperparameters=hp or {}, job_root=str(tmp_path / "jobs"))
    job_dir = tmp_path / "jobs" / "j"
    job_dir.mkdir(parents=True)
    return NodeBackend(nodes=["n0", "n1"], execute=True).launch(job, "j", str(job_dir))


def test_node_backend_executes_through_stub_ssh(tmp_path, monkeypatch):
    """``execute=True`` end to end through the stubs: one process a node,
    each node's entry run with the job's argv and directories, its output
    in ``node_<i>.log``."""
    _stubs(tmp_path, monkeypatch)
    handle = _node_job(tmp_path, """
        import json, os, sys
        out = os.environ["TPU_OUTPUT_DATA_DIR"]
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"ran_{os.environ['NODE_RANK']}.json"), "w") as f:
            json.dump({"argv": sys.argv[1:], "model_dir": os.environ["TPU_MODEL_DIR"],
                       "cache": os.environ["HSTD_COMPILE_CACHE_DIR"]}, f)
        print("node", os.environ["NODE_RANK"], "done")
    """, hp={"epochs": 2})
    assert len(handle.procs) == 2
    assert handle.wait(timeout=JOB_TIMEOUT_S) == [0, 0] and handle.returncode == 0
    for i in range(2):
        ran = json.loads((tmp_path / "jobs" / "j" / "output" / f"ran_{i}.json").read_text())
        assert ran["argv"] == ["--epochs", "2"] and ran["model_dir"] == handle.model_dir
        assert f"node {i} done" in (tmp_path / "jobs" / "j" / f"node_{i}.log").read_text()


def test_node_subset_failure_raises_and_keeps_artifacts(tmp_path, monkeypatch):
    """One node of two dies mid-job: wait() raises with its code, and both
    nodes' outputs and the dying node's last words are kept."""
    _stubs(tmp_path, monkeypatch)
    handle = _node_job(tmp_path, """
        import json, os, sys
        w = os.environ["NODE_RANK"]
        out = os.environ["TPU_OUTPUT_DATA_DIR"]
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"ran_w{w}.json"), "w") as f:
            json.dump({"worker": w}, f)
        if w == "1":
            print("worker 1 dying mid-job", file=sys.stderr)
            sys.exit(7)
    """)
    with pytest.raises(RuntimeError, match="failed with codes"):
        handle.wait(timeout=JOB_TIMEOUT_S)
    assert handle.returncodes == [0, 7] and handle.returncode == 7
    out = tmp_path / "jobs" / "j" / "output"
    assert (out / "ran_w0.json").exists() and (out / "ran_w1.json").exists()
    assert "worker 1 dying mid-job" in (tmp_path / "jobs" / "j" / "node_1.log").read_text()


def test_node_failures_first_code_wins(tmp_path, monkeypatch):
    """Both nodes fail, node 1 first: the job's code is node 1's."""
    _stubs(tmp_path, monkeypatch)
    handle = _node_job(tmp_path, """
        import os, sys, time
        if os.environ["NODE_RANK"] == "0":
            time.sleep(1.5)
            sys.exit(3)
        sys.exit(5)
    """)
    with pytest.raises(RuntimeError, match="first: 5"):
        handle.wait(timeout=JOB_TIMEOUT_S)
    assert handle.returncodes == [3, 5] and handle.returncode == 5


def test_hung_worker_times_out_and_is_terminated(tmp_path, monkeypatch):
    """A node that never returns: wait(timeout) terminates every process
    of the job (the ssh and the entry under it) and raises."""
    _stubs(tmp_path, monkeypatch)
    t0 = time.time()
    handle = _node_job(tmp_path, """
        import os, time
        open(os.path.join(os.environ["TPU_MODEL_DIR"] + ".pid." + os.environ["NODE_RANK"]),
             "w").write(str(os.getpid()))
        time.sleep(120 if os.environ["NODE_RANK"] == "1" else 0)
    """)
    with pytest.raises(subprocess.TimeoutExpired):
        handle.wait(timeout=3)
    assert time.time() - t0 < JOB_TIMEOUT_S
    assert all(p.poll() is not None for p in handle.procs)
    pid = int(open(handle.model_dir + ".pid.1").read())
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)


def test_failed_rank_terminates_survivors(tmp_path):
    """On the CPU simulator one rank dies, the other hangs as at a
    collective: wait() terminates the survivor after the grace period and
    raises with the dead rank's code, well before the hang ends."""
    entry = tmp_path / "crashy.py"
    entry.write_text(textwrap.dedent("""
        import os, sys, time
        if os.environ["TPU_PROCESS_ID"] == "1":
            sys.exit(3)
        time.sleep(120)
    """))
    job = GPUJob(entry_point=str(entry), source_dir=str(tmp_path), slice_spec="cpu-2",
                 num_hosts=2, job_root=str(tmp_path / "jobs"))
    t0 = time.time()
    handle = job.fit(wait=False)
    with pytest.raises(RuntimeError, match="failed with codes"):
        handle.wait(grace_period=2.0, timeout=JOB_TIMEOUT_S)
    assert handle.returncode == 3 and handle.returncodes[1] == 3
    assert time.time() - t0 < JOB_TIMEOUT_S


ENV_ENTRY = """
    import json, os, sys
    keys = ["TPU_COORDINATOR_ADDRESS", "TPU_NUM_PROCESSES", "TPU_PROCESS_ID",
            "TPU_OUTPUT_DATA_DIR", "TPU_MODEL_DIR", "HSTD_TELEMETRY_DIR",
            "HSTD_COMPILE_CACHE_DIR", "CUDA_VISIBLE_DEVICES", "LOCAL_RANK"]
    out = os.environ["TPU_OUTPUT_DATA_DIR"]
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"env_{os.environ['TPU_PROCESS_ID']}.json"), "w") as f:
        json.dump({"argv": sys.argv[1:], **{k: os.environ.get(k) for k in keys}}, f)
"""


def _env_job(tmp_path, spec: str, hosts: int):
    entry = tmp_path / "env_entry.py"
    entry.write_text(textwrap.dedent(ENV_ENTRY))
    handle = GPUJob(entry_point=str(entry), source_dir=str(tmp_path), slice_spec=spec,
                    num_hosts=hosts, hyperparameters={"epochs": 1},
                    job_root=str(tmp_path / "jobs")).fit(wait=False)
    handle.wait(timeout=JOB_TIMEOUT_S)
    out = handle.output_data_dir
    return handle, [json.loads(open(os.path.join(out, f"env_{r}.json")).read())
                    for r in range(len(handle.procs))]


def test_cpu_slice_env_contract(tmp_path, monkeypatch):
    """``cpu-2`` over 2 hosts: each process sees no GPU, is asked for the
    CPU, and gets the rendezvous triplet, the job's directories, the
    telemetry directory and the compile-cache precedence (an operator's
    ``TPU_COMPILATION_CACHE_DIR`` wins over the default)."""
    monkeypatch.delenv("HSTD_COMPILE_CACHE_DIR", raising=False)
    monkeypatch.delenv("HSTD_TELEMETRY_DIR", raising=False)
    monkeypatch.setenv("TPU_COMPILATION_CACHE_DIR", str(tmp_path / "legacy"))
    handle, envs = _env_job(tmp_path, "cpu-2", 2)
    assert [e["TPU_PROCESS_ID"] for e in envs] == ["0", "1"]
    assert len({e["TPU_COORDINATOR_ADDRESS"] for e in envs}) == 1
    for e in envs:
        assert e["argv"] == ["--epochs", "1", "--device", "cpu"]
        assert e["CUDA_VISIBLE_DEVICES"] == "" and e["LOCAL_RANK"] is None
        assert e["TPU_NUM_PROCESSES"] == "2" and e["TPU_MODEL_DIR"] == handle.model_dir
        assert e["HSTD_TELEMETRY_DIR"] == os.path.join(handle.output_data_dir, "telemetry")
        assert e["HSTD_COMPILE_CACHE_DIR"] == str(tmp_path / "legacy")
    assert os.path.exists(os.path.join(handle.job_dir, "host_1.log"))
    env = {"HSTD_COMPILE_CACHE_DIR": "/a", "TPU_COMPILATION_CACHE_DIR": "/b"}
    assert t_launcher.compile_cache_dir(env, "/r") == "/a"
    assert t_launcher.compile_cache_dir({}, "/r") == "/r/compile_cache"


def test_gpu_slice_gives_each_host_its_gpus(tmp_path, monkeypatch):
    """``h100-4`` over 2 simulated hosts on a machine whose visible GPUs
    are 3, 5, 6 and 7: one process a GPU, host 0's ranks on GPUs 3 and 5,
    host 1's on 6 and 7, ``LOCAL_RANK`` within the host, no ``--device``
    forced (the entry runs on the card). The processes here only report
    their environment."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5,6,7")
    handle, envs = _env_job(tmp_path, "h100-4", 2)
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["3,5", "3,5", "6,7", "6,7"]
    assert [e["LOCAL_RANK"] for e in envs] == ["0", "1", "0", "1"]
    assert all(e["TPU_NUM_PROCESSES"] == "4" and e["argv"] == ["--epochs", "1"]
               for e in envs)
    assert sorted(os.listdir(handle.job_dir)) == [
        "host_0.log", "host_0.rank_1.log", "host_1.log", "host_1.rank_3.log", "output"]


@pytest.mark.parametrize("visible", [None, "0"], ids=["no_gpu", "one_gpu"])
def test_gpu_slice_larger_than_the_machine_raises(tmp_path, monkeypatch, visible):
    """A GPU slice this machine cannot hold raises before any process
    starts: it never falls back to the CPU."""
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        if torch.cuda.is_available():
            pytest.skip("this machine has a GPU")
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    job = GPUJob(slice_spec="h100-2", job_root=str(tmp_path))
    with pytest.raises(ValueError, match="needs 2 GPUs"):
        LocalBackend().launch(job, "j", str(tmp_path / "j"))
    with pytest.raises(ValueError, match="needs 2 GPUs"):
        job.fit()


def _config_dir(tmp_path) -> str:
    cfg = tmp_path / "cfg"
    cfg.mkdir()
    (cfg / "config.json").write_text(json.dumps(TINY_BERT))
    return str(cfg)


def test_launch_main_two_host_training_job(tmp_path, capsys):
    """``python -m ...launch --slice cpu-2 --num_hosts 2`` (its ``main``)
    with the reference's hyperparameters and pass-through extras: two
    processes of the port's training CLI rendezvous over gloo, shard the
    batch, all-reduce, evaluate, and rank 0 writes the results and the HF
    export, which loads back."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto as t_auto

    root = tmp_path / "jobs"
    assert t_main.main([
        "--slice", "cpu-2", "--num_hosts", "2", "--job_root", str(root),
        "--model_name_or_path", _config_dir(tmp_path), "--train_batch_size", "2",
        "--from_scratch", "true", "--dataset", "synthetic", "--dtype", "float32",
        "--max_seq_length", "32", "--max_train_samples", "32", "--max_eval_samples", "16",
        "--learning_rate", "1e-3", "--scale_lr_by_world_size", "false",
        "--optimizer", "lamb", "--log_every_steps", "0"]) == 0
    (job_dir,) = [root / d for d in os.listdir(root) if d.startswith("huggingface-gpu-")]
    assert f"artifacts in {job_dir}" in capsys.readouterr().out
    log0 = (job_dir / "host_0.log").read_text()
    assert "rank 0/2 on cpu" in log0 and '"optimizer": "lamb"' in log0
    assert '"epochs": 1' in log0 and '"eval_batch_size": 4' in log0
    out = job_dir / "output"
    results = (out / "train_results.txt").read_text()
    assert "train_runtime" in results and "eval_loss" in (out / "eval_results.txt").read_text()
    events = [json.loads(line) for line in (out / "telemetry" / "events.jsonl").open()]
    launches = {e["name"]: e["value"] for e in events if e["type"] == "metric"
                and e["name"].startswith("kernel_launches/")}
    assert launches == {f"kernel_launches/{k}": 0.0 for k in (
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "fused_ce_fwd", "fused_ce_bwd_dh",
        "fused_ce_bwd_dw")}
    model, family, cfg = t_auto.from_pretrained(str(job_dir / "model"), device="cpu")
    assert family == "bert" and cfg.num_layers == 1
    assert sum(p.numel() for p in model.parameters()) > 0


def test_hyperparameters_pass_extras_through():
    """The reference's hyperparameters, then the extras: ``--key value``
    pairs as given, a bare ``--flag`` as ``true`` (the JAX ``launch.py``'s
    rule)."""
    import argparse

    ns = argparse.Namespace(epochs=1, train_batch_size=8, eval_batch_size=4,
                            model_name_or_path="bert-large-uncased-whole-word-masking",
                            learning_rate=5e-5)
    extra = ["--dataset", "synthetic", "--remat", "--fp16", "--x", "1"]
    hp = t_main.hyperparameters(ns, extra)
    assert hp == {"epochs": 1, "train_batch_size": 8, "eval_batch_size": 4,
                  "model_name_or_path": "bert-large-uncased-whole-word-masking",
                  "learning_rate": 5e-5, "dataset": "synthetic", "remat": "true",
                  "fp16": "true", "x": "1"}


def test_single_node_entry_turns_lr_scaling_off(monkeypatch):
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import single_node

    seen = []
    monkeypatch.setattr(cli, "main", lambda argv: seen.append(argv) or {})
    single_node.main(["--epochs", "1"])
    single_node.main(["--scale_lr_by_world_size", "true"])
    assert seen == [["--epochs", "1", "--scale_lr_by_world_size", "false"],
                    ["--scale_lr_by_world_size", "true"]]


def test_kill_relaunch_resume_drill(tmp_path):
    """Preemption end to end on the CPU simulator: a 2-host job loses rank
    1 to SIGKILL right after a mid-epoch checkpoint commits; the launcher
    ends the survivor and raises; relaunching the same job resumes from
    the committed mid-epoch position and runs to the end, writing the
    results once."""
    ckpt, out, model = (str(tmp_path / d) for d in ("ckpt", "out", "model"))
    entry = tmp_path / "drill_entry.py"
    entry.write_text(textwrap.dedent(f"""
        import os, signal, sys, threading, time

        if os.environ.get("DRILL_KILL") == "1" and os.environ["TPU_PROCESS_ID"] == "1":
            def watchdog():
                while True:
                    try:
                        if any(d.isdigit() and int(d) > 0 for d in os.listdir({ckpt!r})):
                            os.kill(os.getpid(), signal.SIGKILL)
                    except FileNotFoundError:
                        pass
                    time.sleep(0.05)

            threading.Thread(target=watchdog, daemon=True).start()
        from {PKG}.train import cli
        cli.script(sys.argv[1:])
    """))
    hyper = {"model_name_or_path": _config_dir(tmp_path), "from_scratch": True,
             "dataset": "synthetic", "epochs": 2, "train_batch_size": 2, "dtype": "float32",
             "max_seq_length": 32, "max_train_samples": 128, "max_eval_samples": 16,
             "learning_rate": 1e-3, "scale_lr_by_world_size": False,
             "optimizer_state_dtype": "bfloat16", "checkpoint_dir": ckpt,
             "checkpoint_every_steps": 4, "output_data_dir": out, "model_dir": model,
             "log_every_steps": 0}
    common = dict(entry_point=str(entry), source_dir=str(tmp_path), slice_spec="cpu-2",
                  num_hosts=2, hyperparameters=hyper, job_root=str(tmp_path / "jobs"))
    handle = GPUJob(env={"DRILL_KILL": "1"}, **common).fit(wait=False)
    with pytest.raises(RuntimeError, match="failed with codes"):
        handle.wait(grace_period=5.0, timeout=JOB_TIMEOUT_S)
    assert [d for d in os.listdir(ckpt) if d.isdigit()], "no committed checkpoint survived"
    assert not os.path.exists(os.path.join(out, "train_results.txt"))

    handle = GPUJob(**common).fit(wait=False)
    assert handle.wait(timeout=JOB_TIMEOUT_S) == [0, 0]
    log0 = open(os.path.join(handle.job_dir, "host_0.log")).read()
    m = re.search(r"resuming from epoch (\d+) \(step-in-epoch (\d+)\)", log0)
    assert m and int(m.group(2)) > 0, "the relaunch did not resume mid-epoch"
    assert open(os.path.join(out, "train_results.txt")).read().count("train_runtime") == 1
    assert os.path.exists(os.path.join(out, "eval_results.txt"))
    assert os.path.exists(os.path.join(model, "model.safetensors"))
