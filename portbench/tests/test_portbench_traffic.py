"""The traffic generator: every seed draws the same multiset of lengths, in
its own order, and any stretch of the walk holds the classes evenly."""

import collections

import numpy as np
import pytest
import torch

from portbench import run, traffic

SEEDS = [0, 1, 2**31 + 11, 2**33 + 7, 987654321]


@pytest.mark.parametrize("name", ["chat-b1", "batch8"])
def test_every_seed_gives_the_same_multiset(name):
    mix = run.load_json(run.find("traffic", name))
    walks = [traffic.walk(mix, s) for s in SEEDS]
    assert all(collections.Counter(w) == collections.Counter(walks[0]) for w in walks)
    # the order is the seed's, unless the mix fixes it
    assert len({tuple(w) for w in walks}) == (1 if mix.get("order") == "fixed" else len(SEEDS))
    n_cls = mix["prompt"]["classes"]
    for w in walks:
        for r in range(mix["repeats"]):
            assert len({p for p, _ in w[r * n_cls:(r + 1) * n_cls]}) == n_cls
    lo, hi = mix["prompt"]["min"], mix["prompt"]["max"]
    assert all(lo <= p <= hi for p, _ in walks[0])
    assert all(p + o <= mix["cache_slots"] for p, o in walks[0])


def test_chat_lengths_are_the_quantiles():
    mix = run.load_json(run.find("traffic", "chat-b1"))
    prompts, outs = traffic.classes(mix)
    assert prompts[0] == 138 and prompts[-1] == 1421 and prompts[-2] == 1217
    flat = sorted(o for os_ in outs for o in os_)
    assert flat == sorted(traffic.quantile_lengths(mix["output"], 64))
    long_outs = [o for p, os_ in zip(prompts, outs) for o in os_ if p >= prompts[-4]]
    assert 60 < np.mean(long_outs) < 130  # long prompts do not all get long answers


def test_train_rows_are_prompt_masked_and_seeded():
    mix = run.load_json(run.find("traffic", "wct-train"))
    a_ids, a_lab = traffic.train_rows(mix, 5, 6, 50272)
    b_ids, b_lab = traffic.train_rows(mix, 5, 6, 50272)
    c_ids, _ = traffic.train_rows(mix, 6, 6, 50272)
    assert (a_ids == b_ids).all() and (a_lab == b_lab).all() and not (a_ids == c_ids).all()
    assert a_ids.shape == (6, mix["batch"], mix["seq"])
    rows = a_ids.reshape(-1, mix["seq"])
    assert len({r.tobytes() for r in rows}) == len(rows)
    labelled = a_lab != traffic.IGNORE_INDEX
    assert (a_lab[labelled] == a_ids[labelled]).all()
    for ids, lab in zip(a_ids.reshape(-1, mix["seq"]), a_lab.reshape(-1, mix["seq"])):
        first = np.argmax(lab != traffic.IGNORE_INDEX)
        assert first >= mix["prompt"]["min"]


def test_prompt_tokens_depend_on_seed_and_request():
    a = traffic.prompt_tokens(3, "window0", 2, 16, 100, "cpu")
    assert torch.equal(a, traffic.prompt_tokens(3, "window0", 2, 16, 100, "cpu"))
    assert not torch.equal(a, traffic.prompt_tokens(3, "window1", 2, 16, 100, "cpu"))
    assert not torch.equal(a, traffic.prompt_tokens(4, "window0", 2, 16, 100, "cpu"))
    assert int(a.min()) >= 0 and int(a.max()) < 100
