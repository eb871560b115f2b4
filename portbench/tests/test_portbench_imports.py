"""No module the benchmark loads is JAX's or the JAX package's, compared by
whole top-level name (``qeft_tpu_torch`` begins with ``qeft_tpu`` and is
the program), and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import run

ROOT = run.HERE.parent


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("names,found", [
    (["qeft_tpu_torch", "qeft_tpu_torch.ops.qmm", "jaxtyping", "flaxen"], []),
    (["qeft_tpu.ops"], ["qeft_tpu.ops"]),
    (["jax", "jaxlib.xla_client"], ["jax", "jaxlib.xla_client"]),
    (["flax.linen", "qeft_tpu"], ["flax.linen", "qeft_tpu"]),
])
def test_forbidden_by_whole_top_level_name(monkeypatch, names, found):
    for n in [k for k in sys.modules if k.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, n)
    for n in names:
        monkeypatch.setitem(sys.modules, n, object())
    assert run.forbidden_modules() == sorted(found)


def test_sources_import_neither_jax_nor_the_jax_package():
    for path in run.HERE.rglob("*.py"):
        assert not imported_tops(path) & set(run.FORBIDDEN), path
    for path in (run.HERE / "reference").glob("*.py"):
        assert "qeft_tpu_torch" not in imported_tops(path), path
        assert "qeft_tpu_torch" not in path.read_text(), path


def test_a_whole_small_run_loads_no_jax():
    code = (
        "import sys, torch\n"
        "from portbench import run\n"
        "from portbench.tests import small\n"
        "for cell in ('opt-6.7b.chat-b1', 'opt-6.7b.wct-train'):\n"
        "    run.execute(small.BENCH, cell, 7, 0.2, False, torch.device('cpu'),\n"
        "                files=small.files(cell))\n"
        "print(run.forbidden_modules())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'qeft_tpu_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-3:-1] == ["[]", "['qeft_tpu_torch']"]
