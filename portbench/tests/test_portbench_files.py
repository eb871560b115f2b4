"""Every configuration, traffic mix, cell and metric is a file found by its
name, and a file dropped in is found with no edit to any other."""

import json
import shutil

import pytest

from portbench import run, shapes, traffic
from portbench.tests.small import BENCH


def test_benchmark_names_files_that_exist():
    for c in BENCH["configs"]:
        assert run.find("configs", c["name"]).as_posix().endswith(c["file"])
        shapes.dims(run.load_json(run.find("configs", c["name"])))
    for w in BENCH["workloads"]:
        mix = run.load_json(run.find("traffic", w["traffic"]))
        assert (run.HERE / "drivers" / f"{mix['kind']}.py").is_file()
        assert run.load_json(run.find("cells", w["name"]))["limits"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(run.load_reader(m["name"]).read)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = {m["name"] for m in run.cell_metrics(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = run.cell_metrics(BENCH, cell, True)
    assert layer and all(m["moves"] in e2e for m in layer)


def test_a_new_file_is_found_by_name(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(run.HERE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "traffic" / "long-chat.json").write_text(json.dumps(
        dict(run.load_json(run.find("traffic", "chat-b1")), prompt={
            "dist": "loguniform", "min": 1024, "max": 1900, "classes": 8})))
    (root / "metrics" / "answer.decode.py").write_text("def read(run):\n    return 42.0\n")
    mix = run.load_json(run.find("traffic", "long-chat", root=root))
    assert len(traffic.walk(mix, 5)) == 8 * mix["repeats"]
    assert run.load_reader("answer.decode", root=root).read(None) == 42.0
    bench = dict(BENCH, per_layer=BENCH["per_layer"] + [{
        "name": "answer.decode", "unit": "%", "better": "higher", "source": "device_trace",
        "layer": "model", "moves": "gen_tokens_s", "workloads": ["opt-6.7b.chat-b1"]}])
    assert "answer.decode" in {m["name"] for m in run.cell_metrics(bench, "opt-6.7b.chat-b1", True)}
    with pytest.raises(FileNotFoundError):
        run.find("traffic", "no-such-mix", root=root)
