"""Small versions of the cells for the CPU: the real configuration and
traffic files with their sizes cut (every other key as it stands)."""

from __future__ import annotations

import json
from typing import Dict

from portbench import run

BENCH = json.loads((run.HERE.parent / "BENCHMARK.json").read_text())
FAMILY_OF = {"opt-6.7b": "opt", "falcon-7b": "falcon"}


def config(name: str, layers: int = 2, hidden: int = 128, vocab: int = 256) -> Dict:
    c = run.load_json(run.find("configs", name))
    c.update(hidden_size=hidden, num_attention_heads=4, num_hidden_layers=layers,
             vocab_size=vocab, max_position_embeddings=128)
    if c["family"] == "opt":
        c.update(ffn_dim=2 * hidden, word_embed_proj_dim=hidden)
    else:
        c.update(ffn_hidden_size=4 * hidden)
    c["qeft"] = dict(c["qeft"], group_size=64, n_outlier=8)
    return c


def traffic(name: str) -> Dict:
    m = run.load_json(run.find("traffic", name))
    if m["kind"] == "decode":
        m.update(cache_slots=64, batch=min(m["batch"], 2), repeats=2,
                 prompt={"dist": "loguniform", "min": 9, "max": 40, "classes": 4},
                 output={"dist": "uniform", "min": 4, "max": 12})
    else:
        m.update(batch=2, seq=32, max_steps=12,
                 prompt={"dist": "loguniform", "min": 4, "max": 16, "classes": 8},
                 response={"dist": "uniform", "min": 4, "max": 24})
    return m


def files(cell: str, limits: Dict = None) -> Dict:
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    lim = limits or run.load_json(run.find("cells", cell))["limits"]
    return {"config": config(w["config"]), "traffic": traffic(w["traffic"]), "cell": {"limits": lim}}
