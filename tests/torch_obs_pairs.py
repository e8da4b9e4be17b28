"""Shared set-up of the telemetry-reader parity tests
(``tests/test_torch_obsctl.py``, ``test_torch_timeline.py``,
``test_torch_trace.py``): the JAX package's own reader tests run with each
reader they call, and each ``scripts/obsctl.py`` run they make, paired
with the port's counterpart on the same inputs. A paired function returns
the JAX package's result after holding the port's equal to it byte for
byte (``json.dumps(..., sort_keys=True)``, or the rendered text); a paired
CLI run returns the JAX script's process after holding ``python -m
<port>.obs`` on the same arguments to the same exit code, stdout, stderr
and written files."""

import copy
import importlib
import json
import os
import subprocess
import sys
from types import SimpleNamespace

JAX_PKG = "huggingface_sagemaker_tensorflow_distributed_tpu"
PORT_PKG = "huggingface_sagemaker_tensorflow_distributed_tpu_torch"
PORT_OBS = f"{PORT_PKG}.obs"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBSCTL = os.path.join(REPO, "scripts", "obsctl.py")
# the flags whose value is a file the command writes
OUT_FLAGS = ("-o", "--out", "--trace")


def dump(value) -> str:
    return value if isinstance(value, str) else json.dumps(value, sort_keys=True)


def port_twin(fn):
    """The port's function of the same module path and name as ``fn``."""
    mod = importlib.import_module(PORT_PKG + fn.__module__[len(JAX_PKG):])
    return getattr(mod, fn.__name__)


class Pairs:
    """Counts the paired calls and CLI runs a case made (a case that made
    none held nothing)."""

    def __init__(self):
        self.calls = {}

    def function(self, jax_fn):
        port_fn = port_twin(jax_fn)

        def both(*args, **kw):
            want = jax_fn(*copy.deepcopy(args), **copy.deepcopy(kw))
            got = port_fn(*copy.deepcopy(args), **copy.deepcopy(kw))
            assert dump(got) == dump(want), jax_fn.__name__
            self.calls[jax_fn.__name__] = self.calls.get(jax_fn.__name__, 0) + 1
            return want

        return both

    def cli_run(self, real_run):
        def run(argv, *args, **kw):
            if len(argv) < 3 or argv[1] != OBSCTL:
                return real_run(argv, *args, **kw)
            rest = list(argv[2:])
            outs = [rest[i + 1] for i, a in enumerate(rest[:-1]) if a in OUT_FLAGS]
            port = real_run([argv[0], "-m", PORT_OBS, *rest], *args, **kw)
            port_files = {p: _take(p) for p in outs}
            ref = real_run(argv, *args, **kw)
            ref_files = {p: _read(p) for p in outs}
            assert (port.returncode, port.stdout, port.stderr) == (
                ref.returncode, ref.stdout, ref.stderr), rest
            assert port_files == ref_files, rest
            self.calls[rest[0]] = self.calls.get(rest[0], 0) + 1
            return ref

        return run


def _read(path):
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return f.read()


def _take(path):
    data = _read(path)
    if data is not None:
        os.remove(path)
    return data


def pair_case(monkeypatch, module, modules=()) -> Pairs:
    """Pair every JAX reader function ``module`` (a JAX test module)
    imported, every public function of the JAX ``modules`` (for the tests
    that import inside their bodies), and ``module``'s ``scripts/obsctl.py``
    runs."""
    pairs = Pairs()
    for name, value in list(vars(module).items()):
        if callable(value) and not isinstance(value, type) and \
                getattr(value, "__module__", "").startswith(f"{JAX_PKG}.obs."):
            monkeypatch.setattr(module, name, pairs.function(value))
    for sub in modules:
        mod = importlib.import_module(f"{JAX_PKG}.obs.{sub}")
        for name in getattr(mod, "__all__", ()) or [n for n in vars(mod) if not n.startswith("_")]:
            value = getattr(mod, name)
            if callable(value) and not isinstance(value, type) and \
                    getattr(value, "__module__", "") == mod.__name__:
                monkeypatch.setattr(mod, name, pairs.function(value))
    if hasattr(module, "subprocess"):
        monkeypatch.setattr(module, "subprocess", SimpleNamespace(
            run=pairs.cli_run(subprocess.run), Popen=subprocess.Popen,
            PIPE=subprocess.PIPE, STDOUT=subprocess.STDOUT))
    return pairs


def port_classes(monkeypatch, module, names) -> None:
    """Point ``module``'s JAX reader classes ``names`` at the port's."""
    for name in names:
        monkeypatch.setattr(module, name, port_twin(getattr(module, name)))


def run_port_cli(*argv, poison=("jax", "torch"), **kw):
    """``python -m <port>.obs ARGV`` in a subprocess whose ``sys.modules``
    holds ``None`` for each of ``poison`` (an import of one raises)."""
    code = ("import runpy, sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in poison)
            + f"sys.argv = ['obs'] + {list(argv)!r}\n"
            + f"runpy.run_module({PORT_OBS!r}, run_name='__main__')\n")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, **kw)


def port_script(path) -> str:
    """A script at ``path`` that runs ``python -m <port>.obs`` with its own
    arguments (for the tests that start ``scripts/obsctl.py`` by its path)."""
    with open(path, "w", encoding="utf-8") as f:
        f.write("import runpy, sys\n"
                f"sys.path.insert(0, {REPO!r})\n"
                f"runpy.run_module({PORT_OBS!r}, run_name='__main__', alter_sys=True)\n")
    return str(path)
