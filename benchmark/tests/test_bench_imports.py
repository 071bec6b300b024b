"""No module a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``poseidon_tpu`` (compared whole: ``poseidon_tpu_torch``
begins with ``poseidon_tpu``), and the yardstick's reference imports
nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "poseidon_tpu"}
# the yardstick: none of it may import the program
YARDSTICK = ("prototxt.py", "refnet.py", "reference.py", "costs.py",
             "synth.py", "trace.py", "control.py")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for dirpath, _, files in os.walk(BENCH):
        if ".cache" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_whole_names_compared():
    from benchmark.run import FORBIDDEN as RUN_FORBIDDEN
    assert set(RUN_FORBIDDEN) == FORBIDDEN
    assert "poseidon_tpu_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources()))
def test_no_source_imports_jax(path):
    assert not set(_imports(path)) & FORBIDDEN, path


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    mods = set(_imports(os.path.join(BENCH, name)))
    assert not mods & (FORBIDDEN | {"poseidon_tpu_torch"}), name


def test_loaded_modules_of_a_run():
    """Import what a run imports, build the program's CLI and the
    reference, and read ``sys.modules`` in a fresh process."""
    code = (
        "import sys, json\n"
        "import benchmark.run, benchmark.harness, benchmark.control\n"
        "from poseidon_tpu_torch.runtime import cli, engine\n"
        "cli.build_parser()\n"
        "from benchmark.run import loaded_forbidden\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps([loaded_forbidden(), tops]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    import json
    bad, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert bad == []
    assert "poseidon_tpu_torch" in tops
    assert not FORBIDDEN & set(tops)


def test_reference_process_loads_no_program():
    code = ("import sys\n"
            "import benchmark.reference, benchmark.refnet, "
            "benchmark.costs, benchmark.synth, benchmark.prototxt\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'poseidon_tpu_torch', 'poseidon_tpu', 'jax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
