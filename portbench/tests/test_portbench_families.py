"""Model families as plug-ins of the yardstick (``portbench/families/``).

The golden numbers were computed with the yardstick as it stood before the
families moved into modules of their own, and are written here as
literals: the sizes, each step's operations and bytes, the calls a traced
stretch must hold with the sums the roofline readers take over them, and,
at the CPU tests' small sizes, hashes of the weights and of the
reference's logits.  Moving a family's code must leave every one equal.

A family that exists only in the test then runs a whole cell, and no
generic module names a family."""

import dataclasses
import hashlib
import os
import re
import subprocess
import sys
import types

import pytest
import torch

from portbench import check, costs, expect, families, run, shapes, weights
from portbench.reference import common, family, layer_params
from portbench.tests import small

H100 = costs.peaks("NVIDIA H100 80GB HBM3")


def full(name):
    return shapes.dims(run.load_json(run.find("configs", name)))


DIMS = {
    "opt-6.7b": {
        "family": "opt", "layers": 32, "hidden": 4096, "heads": 32, "kv_heads": 32,
        "head_dim": 128, "vocab": 50272, "group": 128, "n_outlier": 128,
        "linears": (("q", 4096, 4096), ("k", 4096, 4096), ("v", 4096, 4096),
                    ("o", 4096, 4096), ("fc1", 4096, 16384), ("fc2", 16384, 4096)),
        "ffn": 16384, "positions": 2048, "biases": True, "eps": 1e-05, "rope_theta": 0.0,
        "out_linear": "o", "norm_fed": ("q", "k", "v")},
    "falcon-7b": {
        "family": "falcon", "layers": 32, "hidden": 4544, "heads": 71, "kv_heads": 1,
        "head_dim": 64, "vocab": 65024, "group": 64, "n_outlier": 128,
        "linears": (("qkv", 4544, 4672), ("dense", 4544, 4544), ("fc1", 4544, 18176),
                    ("fc2", 18176, 4544)),
        "ffn": 18176, "positions": 2048, "biases": False, "eps": 1e-05,
        "rope_theta": 10000.0, "out_linear": "dense", "norm_fed": ("qkv", "fc1")},
}

DECODE_STEP = {  # (config, batch, keys): (operations, bytes)
    ("opt-6.7b", 1, 1): (13599244288, 4139253760),
    ("opt-6.7b", 1, 600): (13913292800, 4453302272),
    ("opt-6.7b", 1, 2048): (14672461824, 5212471296),
    ("opt-6.7b", 8, 1): (108793954304, 4142923776),
    ("opt-6.7b", 8, 600): (111306342400, 6655311872),
    ("opt-6.7b", 8, 2048): (117379694592, 12728664064),
    ("falcon-7b", 1, 1): (14105042944, 4579663872),
    ("falcon-7b", 1, 600): (14453440512, 4584570880),
    ("falcon-7b", 1, 2048): (15295643648, 4596432896),
    ("falcon-7b", 8, 1): (112840343552, 4579721216),
    ("falcon-7b", 8, 600): (115627524096, 4618977280),
    ("falcon-7b", 8, 2048): (122365149184, 4713873408),
}

TRAIN_STEP_OPS = {"opt-6.7b": 56938918313984, "falcon-7b": 58799033417728}

# each cell's traced stretch, fixed: decode requests (prompt, output, batch)
# or training steps; per list of calls: count, operations, bytes and the
# readers' least time on the H100's peaks
TRACED = {"opt-6.7b.chat-b1": {"requests": [(1217, 97, 1), (128, 33, 1)]},
          "falcon-7b.batch8": {"requests": [(512, 200, 8)]},
          "opt-6.7b.wct-train": {"steps": 2}}
EXPECT = {
    "opt-6.7b.chat-b1": {
        "qgemv": (24576, 1687922147328, 477647339520, 0.14258129537910447),
        "qgemm": (384, 17736369438720, 13795590144, 0.017926389163856884),
        "steps": (128, 1806755168256, 595876380672, 0.17787354646925374)},
    "falcon-7b.batch8": {
        "qgemv": (25472, 21513528934400, 800249544704, 0.23888046110567165),
        "qgemm": (128, 55351391027200, 20698824704, 0.05594440168506165),
        "steps": (199, 23020988792832, 919332978688, 0.2744277548322388)},
    "opt-6.7b.wct-train": {
        "qgemm": (768, 108027017428992, 53552873472, 0.10918437176975138),
        "qgemm_t": (378, 52364241272832, 26314014720, 0.05292524891129169)},
}

# small sizes (tests/small.py), seed 3: the weights' tree and the f32 and
# float8 reference logits of two rows of 24 tokens
SMALL = {
    "opt-6.7b": ("efdee1afd8f5289e952c1ef73b23b4bbfe4d604179d0b0391c4aec0d5ca6a03b",
                 "2ff236e99e6e2201a89a5956fdfd698e3e76776a61373b80021bc40bdb7944da",
                 "36a3bb65688c1b05c85a84d6e606ae2a3890c1dccfb1fafb0538e4dd2034c955"),
    "falcon-7b": ("541cab632a944aed8ba96410d291f853a1364faa9c72afcd159fa90c1a6e66e4",
                  "f95b031caf80bc97d7922925956d1bb77d3afa8e7970b9cb3bf8c998324eed74",
                  "45ea2da48530b5cd24e7b401ca3d7fa7db9559b69d86f39f95406c5f744507e6"),
}


@pytest.mark.parametrize("name", sorted(DIMS))
def test_dims_fields(name):
    assert dataclasses.asdict(full(name)) == DIMS[name]


@pytest.mark.parametrize("name,batch,keys", sorted(DECODE_STEP))
def test_decode_step(name, batch, keys):
    assert costs.decode_step(full(name), batch, keys) == DECODE_STEP[(name, batch, keys)]


@pytest.mark.parametrize("name", sorted(TRAIN_STEP_OPS))
def test_train_step_ops(name):
    assert costs.train_step_ops(full(name), 4, 512) == TRAIN_STEP_OPS[name]


def sums(pairs):
    pairs = list(pairs)
    return (len(pairs), sum(o for o, _ in pairs), sum(b for _, b in pairs),
            sum(costs.least_time(o, b, H100) for o, b in pairs))


@pytest.mark.parametrize("cell", sorted(EXPECT))
def test_expected_calls_and_their_costs(cell):
    w = next(w for w in small.BENCH["workloads"] if w["name"] == cell)
    d = full(w["config"])
    r = types.SimpleNamespace(dims=d, traced=TRACED[cell],
                              mix=run.load_json(run.find("traffic", w["traffic"])))
    if "steps" in TRACED[cell]:
        e = expect.train(r)
        got = {"qgemm": sums(costs.qgemm_call(*c[:5]) for c in e["qgemm"]),
               "qgemm_t": sums(costs.qgemm_t_call(*c[:5]) for c in e["qgemm_t"])}
    else:
        e = expect.decode(r)
        got = {"qgemv": sums(costs.qgemv_call(*c) for c in e["qgemv"]),
               "qgemm": sums(costs.qgemm_call(*c[:5]) for c in e["qgemm"]),
               "steps": sums(costs.decode_step(d, *s) for s in e["steps"])}
    assert got == EXPECT[cell]


def tree_digest(tree, h, path=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            tree_digest(v, h, f"{path}{k}/")
        else:
            h.update(f"{path}{k}:{v.dtype}:{tuple(v.shape)}".encode())
            h.update(v.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(SMALL))
def test_small_weights_and_reference_logits_bit_equal(name):
    d = shapes.dims(small.config(name))
    raw = weights.make(d, 3, torch.device("cpu"))
    fam = family(d.family)
    tokens = torch.randint(0, d.vocab, (2, 24), generator=torch.Generator().manual_seed(1))
    got = [tree_digest(raw, hashlib.sha256())]
    for ar in (common.F32, common.FP8):
        x = fam.embed(raw, d, tokens)
        for l in range(d.layers):
            x = fam.block(layer_params(fam)(raw, d, l), x, d, ar)
        got.append(hashlib.sha256(fam.logits(raw, d, x, ar).numpy().tobytes()).hexdigest())
    assert tuple(got) == SMALL[name]


def test_packed_linears_take_leading_axes():
    d = shapes.dims(small.config("falcon-7b"))
    k, n = d.linear("fc1")
    lin = weights.packed(d, 3, "fc1", torch.device("cpu"), lead=(3,))
    assert lin["qweight"].shape == (d.layers, 3, k // 8, n)
    assert lin["scales"].shape == lin["szeros"].shape == (d.layers, 3, k // d.group, n)
    assert lin["oweight"].shape == (d.layers, 3, d.n_outlier, n)


def test_a_missing_family_is_named():
    with pytest.raises(ModuleNotFoundError, match=r"portbench/families/nosuch\.py"):
        families.family("nosuch")


def reexport(name, module):
    out = types.ModuleType(name)
    out.__dict__.update({k: v for k, v in vars(module).items() if not k.startswith("__")})
    return out


class Clock:
    """A host clock that moves 10 ms a reading, so a window holds the same
    requests in every run."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.01
        return self.t


def served_run(monkeypatch, cfg, seed=2**31 + 29):
    from portbench.drivers import decode

    cell = "falcon-7b.batch8"
    seen = []
    real = check.run
    monkeypatch.setattr(check, "run", lambda ctx: seen.append(ctx) or real(ctx))
    monkeypatch.setattr(decode, "time", Clock())
    files = dict(small.files(cell), config=cfg)
    res = run.execute(small.BENCH, cell, seed, 0.5, False, torch.device("cpu"), files=files)
    ctx = seen[0]
    ctx.traced = {"requests": [(r["prompt"], r["output"], r["batch"]) for r in ctx.requests]}
    return res, ctx


def test_a_family_added_by_files_alone_runs_a_cell(monkeypatch):
    from portbench.families import falcon
    from portbench.reference import falcon as ref_falcon

    toy = reexport("portbench.families.toyfam", falcon)
    toy.port_family = "falcon"
    monkeypatch.setitem(sys.modules, "portbench.families.toyfam", toy)
    monkeypatch.setitem(sys.modules, "portbench.reference.toyfam",
                        reexport("portbench.reference.toyfam", ref_falcon))
    cfg = small.config("falcon-7b")
    base, base_ctx = served_run(monkeypatch, cfg)
    res, ctx = served_run(monkeypatch, dict(cfg, family="toyfam"))
    assert ctx.dims.family == "toyfam" and base_ctx.dims.family == "falcon"
    assert res["correct"] is base["correct"] is True
    assert res["check"] == base["check"] and res["attempted"] == base["attempted"] > 1
    want, got = expect.decode(base_ctx), expect.decode(ctx)
    assert {k: len(v) for k, v in got.items()} == {k: len(v) for k, v in want.items()}
    assert got == want and all(got.values())
    assert all(torch.equal(a, b) for a, b in zip(ctx.served_tokens, base_ctx.served_tokens))


def generic_modules():
    """Every module of the benchmark but the families' own: ``families/``,
    ``reference/<family>.py`` of each real family and the tests."""
    own = {p.stem for p in (run.HERE / "families").glob("*.py")} - {"__init__", "dense"}
    for path in sorted(run.HERE.rglob("*.py")):
        rel = path.relative_to(run.HERE)
        if rel.parts[0] in ("families", "tests"):
            continue
        if rel.parts[0] == "reference" and path.stem in own:
            continue
        yield path


def test_no_generic_module_names_a_family():
    names = re.compile(r"\b(opt|falcon)\b", re.IGNORECASE)
    paths = list(generic_modules())
    assert {"shapes.py", "program.py", "weights.py", "costs.py", "expect.py", "check.py",
            "control.py", "run.py", "train.py", "serve.py", "common.py",
            "step_mfu.decode.py"} <= {p.name for p in paths}
    assert {"reference/__init__.py", "reference/common.py"} <= {
        str(p.relative_to(run.HERE)) for p in paths}
    for path in paths:
        assert not names.search(path.read_text()), path


YARDSTICK = """
import sys, torch
from portbench import costs, expect, run, shapes, weights
from portbench.reference import common, family, layer_params
from portbench.tests import small
for name in ("opt-6.7b", "falcon-7b"):
    costs.decode_step(shapes.dims(run.load_json(run.find("configs", name))), 8, 600)
    d = shapes.dims(small.config(name))
    costs.train_step_ops(d, 2, 16)
    expect.decode(type("Run", (), {"dims": d, "traced": {"requests": [(16, 4, 2)]}}))
    raw = weights.make(d, 3, torch.device("cpu"))
    fam = family(d.family)
    x = fam.embed(raw, d, torch.zeros((1, 8), dtype=torch.long))
    for l in range(d.layers):
        x = fam.block(layer_params(fam)(raw, d, l), x, d, common.F32)
    fam.logits(raw, d, x, common.F32)
print(sorted({m.split(".")[0] for m in sys.modules} & {"qeft_tpu_torch", "qeft_tpu", "jax"}))
"""


def python(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=run.HERE.parent, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_the_yardstick_and_the_reference_load_nothing_of_the_port():
    """The family modules name the port only inside `config` and `tree`,
    which `portbench.program` alone calls: sizes, costs, expected calls,
    weights and a reference forward load none of it."""
    assert python(YARDSTICK).split("\n")[-2] == "[]"


@pytest.mark.parametrize("module", ["families.dense", "families.opt", "families.falcon",
                                    "costs", "weights", "shapes", "expect"])
def test_each_yardstick_module_imports_first(module):
    """No import cycle: each module loads alone in a fresh interpreter."""
    python(f"import portbench.{module}")
