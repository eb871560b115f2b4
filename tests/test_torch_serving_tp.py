"""The port's serving on a tensor-parallel mesh, on real Gloo ranks on the
CPU, in f32, against ``qeft_tpu``'s single-device serving on the same tree
(the cases of tests/test_serving_tp.py): the ragged decode tick at tp 2
and 4, the burst against tick-by-tick decoding, ``Engine(mesh=...)``
against the JAX package's ``Engine`` (burst 1 and 3), ``MultiHostEngine``
of two tp-2 replicas, ``measure_engine_throughput(mesh=...)``, and
``run_benchmark --tp 2 --device cpu`` (which starts its own ranks).  Logits
and cache slots within 2e-3; tokens equal."""

import jax.numpy as jnp
import numpy as np
import pytest

from qeft_tpu.models import LLAMA_PRESETS, init_kv_cache
from qeft_tpu.models.llama import llama_decode_step_ragged, llama_prefill
from qeft_tpu.serving import Engine as JaxEngine
from qeft_tpu.serving import Request as JaxRequest
from qeft_tpu_torch import run_benchmark
from tests import torch_ranks as R
from tests.torch_parity import to_port, torch_cfg, torch_tree, tp_packed_tiny_v2

CFG = LLAMA_PRESETS["tiny-v2"]
TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_tp_forward.py
MESHES = {2: (2, 2), 4: (1, 4)}  # tp -> (dp, tp) over the four ranks
PROMPTS = [np.random.default_rng(3).integers(0, CFG.vocab_size, size=n) for n in (4, 6, 3, 5)]
N_NEW = [5, 3, 6, 4]


@pytest.fixture(scope="module")
def run():
    packed = tp_packed_tiny_v2()
    tree, tcfg = to_port(packed), torch_cfg("tiny-v2")
    refs, cases = {}, []

    cache = init_kv_cache(CFG, 2, 32, dtype=jnp.float32)
    _, cache = llama_prefill(packed, jnp.asarray([[1, 2, 3, 4, 5, 6], [7, 8, 9, 1, 2, 3]]),
                             cache, CFG)
    tok, pos = np.array([[5], [9]]), np.array([6, 4])  # ragged positions
    refs["ragged"] = llama_decode_step_ragged(packed, jnp.asarray(tok), cache,
                                              jnp.asarray(pos, jnp.int32), CFG)
    for tp in (2, 4):
        cases.append((f"ragged{tp}", R.tp_decode, dict(
            params=tree, cfg=tcfg, cache=torch_tree(cache), tok=tok, pos=pos,
            shape=MESHES[tp], ragged=True)))

    cache = init_kv_cache(CFG, 2, 32, dtype=jnp.float32)
    _, cache = llama_prefill(packed, jnp.asarray([[1, 2, 3, 4], [5, 6, 7, 8]]), cache, CFG)
    cur, c, p, steps = jnp.asarray([[9], [2]]), cache, jnp.asarray([4, 4], jnp.int32), []
    for _ in range(4):
        logits, c = llama_decode_step_ragged(packed, cur, c, p, CFG)
        nxt = jnp.argmax(logits, axis=-1)
        steps.append(np.asarray(nxt))
        cur, p = nxt[:, None].astype(jnp.int32), p + 1
    refs["burst"] = np.stack(steps, axis=1)
    cases.append(("burst", R.tp_burst, dict(
        params=tree, cfg=tcfg, cache=torch_tree(cache), tok=np.array([[9], [2]]),
        pos=np.array([4, 4]), n=4, shape=MESHES[2])))

    eng = JaxEngine(packed, CFG, max_batch=2, max_len=32, cache_dtype=jnp.float32)
    for i, (pr, n) in enumerate(zip(PROMPTS, N_NEW)):
        eng.submit(JaxRequest(request_id=i, prompt=pr, max_new_tokens=n))
    refs["engine"] = {r.request_id: list(r.output) for r in eng.run()}
    for burst in (1, 3):
        cases.append((f"engine{burst}", R.tp_engine, dict(
            params=tree, cfg=tcfg, prompts=PROMPTS, n_new=N_NEW, shape=MESHES[2],
            max_batch=2, max_len=32, burst=burst)))
    cases.append(("multihost", R.multihost_engine, dict(
        params=tree, cfg=tcfg, prompts=PROMPTS, n_new=N_NEW, shape=(2, 2), max_batch=2,
        max_len=32)))
    cases.append(("measure", R.measure_tp, dict(params=tree, cfg=tcfg, shape=MESHES[4])))
    return refs, R.spawn_cases(4, cases)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_ragged_decode_matches_single_device(run, tp):
    refs, results = run
    ref_logits, ref_cache = refs["ragged"]
    for rank in range(4):
        res = R.result(results, f"ragged{tp}", rank)
        np.testing.assert_allclose(res["logits"], np.asarray(ref_logits), **TOL)
        h, t = res["cache_k"].shape[2], res["coords"]["tp"]
        for b, p in enumerate([6, 4]):  # each sequence's K/V at its own position
            np.testing.assert_allclose(res["cache_k"][:, b, :, p],
                                       np.asarray(ref_cache["k"])[:, b, t * h: (t + 1) * h, p],
                                       **TOL)


def test_tp_decode_burst_matches_stepwise(run):
    refs, results = run
    res = R.result(results, "burst")
    np.testing.assert_array_equal(res["burst"], res["steps"])
    np.testing.assert_array_equal(res["burst"], refs["burst"])


@pytest.mark.parametrize("burst", [1, 3])
def test_tp_engine_matches_single_device_engine(run, burst):
    refs, results = run
    for rank in range(4):
        assert R.result(results, f"engine{burst}", rank)["outputs"] == refs["engine"]


def test_multihost_engine_serves_each_request_once(run):
    """Two tp-2 replicas (a (dp 2, tp 2) mesh): requests routed by id, each
    replica's tokens those of the single-device engine, totals all-reduced."""
    refs, results = run
    served = {}
    for rank in range(4):
        res = R.result(results, "multihost", rank)
        replica = res["coords"]["dp"]
        assert res["taken"] == [i % 2 == replica for i in range(4)]
        for rid, toks in res["outputs"].items():
            assert toks == refs["engine"][rid]
            served.setdefault(rid, set()).add(replica)
        assert res["stats"]["requests_total"] == 4
        assert res["stats"]["tokens_total"] == sum(N_NEW)
        assert res["stats"]["requests_seen"] == 4
    assert served == {i: {i % 2} for i in range(4)}


def test_measure_engine_throughput_on_a_mesh(run):
    _, results = run
    assert all(R.result(results, "measure", rank)["tps"] > 0 for rank in range(4))


@pytest.mark.parametrize("method", ["engine", "qeft"])
def test_run_benchmark_tp_on_the_cpu(method):
    """``--tp 2 --device cpu`` starts two ranks itself and returns rank 0's
    result line, with its tp."""
    res = run_benchmark.main(["--method", method, "--tp", "2", "--device", "cpu", "--model",
                              "tiny", "--context", "8", "--gen", "4", "--reps", "1", "--batch",
                              "2", "--requests", "2", "--burst", "2"])
    assert res["tp"] == 2 and res["device"] == "cpu" and res["method"] == method
    assert res["served_tokens_per_s" if method == "engine" else "tokens_per_s"] > 0
