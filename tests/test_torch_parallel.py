"""The port's mesh and layouts (``qeft_tpu_torch.parallel.mesh`` and the
host-side layout of ``tp_forward`` / ``tp_pp``) against ``qeft_tpu``'s:

- ``_interleave_perm`` and ``_shard_major_words`` bit for bit;
- each rank's part of ``tp_shard_packed_params`` (tp 2 and 4; tiny, whose
  upgate halves the JAX loader pads, and tiny-v2) and of
  ``tppp_shard_params`` (pp 2 x tp 2, the cache included) byte-equal to the
  matching device shard (``addressable_shards``) of JAX's on the same tree;
- the ``param_shardings`` / ``cache_shardings`` tables equal to JAX's specs
  (non-dividing cache axes replicated), and ``shard_params`` byte-equal to
  ``jax.device_put`` under them on a (dp 2, tp 4) mesh;
- on four real Gloo ranks: every collective of the mesh, and a dense tree
  on the tp layouts with the batch split over dp, against JAX's
  single-device forward (2e-4, tests/test_parallel.py's bound)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from qeft_tpu.models import LLAMA_PRESETS, init_params
from qeft_tpu.models.llama import init_kv_cache, llama_prefill
from qeft_tpu.models.registry import get_model_meta as jax_meta
from qeft_tpu.parallel import make_mesh as jax_make_mesh
from qeft_tpu.parallel import cache_shardings as jax_cache_shardings
from qeft_tpu.parallel import param_shardings as jax_param_shardings
from qeft_tpu.parallel.tp_forward import _interleave_perm as jax_interleave_perm
from qeft_tpu.parallel.tp_forward import _shard_major_words as jax_shard_major_words
from qeft_tpu.parallel.tp_forward import tp_shard_packed_params as jax_tp_shard
from qeft_tpu.parallel.tp_pp import tppp_shard_params as jax_tppp_shard
from qeft_tpu.testing import build_packed_model
from qeft_tpu_torch.models.registry import get_model_meta
from qeft_tpu_torch.ops.packing import QLinearParams
from qeft_tpu_torch.parallel.mesh import Mesh, cache_shardings, param_shardings, shard_params
from qeft_tpu_torch.parallel.tp_forward import (
    _interleave_perm,
    _shard_major_words,
    tp_shard_packed_params,
)
from qeft_tpu_torch.parallel.tp_pp import tppp_shard_params
from tests import torch_ranks as R
from tests.torch_parity import dense_to_port, to_port, torch_cfg, torch_tree

_QFIELDS = ("qweight", "scales", "scaled_zeros", "oweight", "bias")


def _packed(name):
    """JAX's fused packed tree (as its loader lays it out: upgate halves
    padded to 1024, the banded o-gather attached) of preset ``name``."""
    return build_packed_model(LLAMA_PRESETS[name], jax.random.PRNGKey(0), g=64, r=16,
                              fuse_stages=True, dtype=jnp.float32)


def _leaves(tree, prefix=""):
    """(path, leaf) of every tensor of a port tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, QLinearParams):
        for f in _QFIELDS:
            if getattr(tree, f) is not None:
                yield f"{prefix}/{f}", getattr(tree, f)
    else:
        yield prefix, tree


def _jax_leaf(tree, path):
    for part in path.strip("/").split("/"):
        tree = tree[part] if isinstance(tree, dict) else getattr(tree, part)
    return tree


def _device_shard(arr, device):
    return np.asarray(next(s.data for s in arr.addressable_shards if s.device == device))


def _assert_shards_equal(port_tree, jax_tree, device):
    n = 0
    for path, leaf in _leaves(port_tree):
        want = _device_shard(_jax_leaf(jax_tree, path), device)
        got = leaf.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
        n += 1
    assert n >= 10


@pytest.mark.parametrize("sizes,tp", [([512, 512, 512], 2), ([256, 128, 128], 4),
                                      ([1024, 1024], 4), ([8192, 1024, 1024], 4)])
def test_interleave_perm_matches_jax(sizes, tp):
    np.testing.assert_array_equal(_interleave_perm(sizes, tp), jax_interleave_perm(sizes, tp))


@pytest.mark.parametrize("lead,k,n,g,tp", [((), 512, 64, 64, 2), ((3,), 1024, 32, 128, 4),
                                           ((2,), 11008, 16, 128, 2),
                                           ((), 2048, 8, 64, 4)])
def test_shard_major_words_matches_jax(lead, k, n, g, tp):
    qw = np.random.default_rng(k).integers(-2 ** 31, 2 ** 31, size=(*lead, k // 8, n),
                                           dtype=np.int64).astype(np.int32)
    want = np.asarray(jax_shard_major_words(jnp.asarray(qw), g, tp))
    np.testing.assert_array_equal(_shard_major_words(torch.from_numpy(qw), g, tp).numpy(), want)


@pytest.mark.parametrize("name,tp", [("tiny", 2), ("tiny-v2", 2), ("tiny-v2", 4)])
def test_tp_shard_packed_params_matches_jax_device_shards(name, tp):
    jparams = _packed(name)
    jmesh = jax_make_mesh((1, tp), axis_names=("dp", "tp"), devices=jax.devices()[:tp])
    want = jax_tp_shard(jparams, jmesh, LLAMA_PRESETS[name])
    params = to_port(jparams)
    for t in range(tp):
        got = tp_shard_packed_params(params, Mesh({"dp": 1, "tp": tp}, rank=t), torch_cfg(name))
        _assert_shards_equal(got, want, jmesh.devices[0, t])


def test_tppp_shard_params_matches_jax_device_shards():
    cfg = LLAMA_PRESETS["tiny-v2"]
    jparams = _packed("tiny-v2")
    jcache = init_kv_cache(cfg, 2, 32, dtype=jnp.float32)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("pp", "tp"))
    want, want_cache = jax_tppp_shard(jparams, jcache, jmesh, cfg)
    params, cache = to_port(jparams), torch_tree(jcache)
    for rank in range(4):
        p, t = divmod(rank, 2)
        got, got_cache = tppp_shard_params(params, cache, Mesh({"pp": 2, "tp": 2}, rank=rank),
                                           torch_cfg("tiny-v2"))
        _assert_shards_equal(got, want, jmesh.devices[p, t])
        for k, v in got_cache.items():
            np.testing.assert_array_equal(v.numpy(), _device_shard(want_cache[k],
                                                                   jmesh.devices[p, t]))


def _spec(sharding, ndim):
    spec = tuple(sharding.spec)
    return spec + (None,) * (ndim - len(spec))


def test_param_shardings_and_shard_params_match_jax():
    """The table spec for spec, then every rank's slices byte-equal to
    ``jax.device_put`` under it."""
    jparams = _packed("tiny-v2")
    jmesh = jax_make_mesh((2, 4))
    jspecs = jax_param_shardings(jparams, jmesh, jax_meta("llama"))
    params = to_port(jparams)
    specs = param_shardings(params, Mesh({"dp": 2, "tp": 4}), get_model_meta("llama"))
    n = 0
    for path, leaf in _leaves(params):
        want = _jax_leaf(jspecs, path)
        assert isinstance(want, NamedSharding)
        assert _jax_leaf(specs, path) == _spec(want, leaf.dim()), path
        n += 1
    assert n >= 10
    placed = jax.device_put(jparams, jspecs)
    for rank in range(8):
        d, t = divmod(rank, 4)
        got = shard_params(params, Mesh({"dp": 2, "tp": 4}, rank=rank), get_model_meta("llama"))
        _assert_shards_equal(got, placed, jmesh.devices[d, t])


@pytest.mark.parametrize("batch,heads,quantized", [(2, 4, False), (3, 4, True), (2, 2, False),
                                                   (0, 8, True)])
def test_cache_shardings_match_jax(batch, heads, quantized):
    """Batch over dp and kv heads over tp; an axis that does not divide
    falls back to replication, as in JAX."""
    jspecs = jax_cache_shardings(jax_make_mesh((2, 4)), batch=batch, n_kv_heads=heads,
                                 quantized=quantized)
    specs = cache_shardings(Mesh({"dp": 2, "tp": 4}), batch=batch, n_kv_heads=heads,
                            quantized=quantized)
    assert set(specs) == set(jspecs)
    for k, s in specs.items():
        assert s == _spec(jspecs[k], len(s)), k


# ---------------------------------------------------------------------------
# on four ranks


@pytest.fixture(scope="module")
def run():
    cfg = LLAMA_PRESETS["tiny"]
    params = init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 8))
    ref, _ = llama_prefill(params, jnp.asarray(tokens), init_kv_cache(cfg, 2, 16,
                                                                      dtype=jnp.float32), cfg)
    cases = [("collectives", R.collectives, dict(shape=(2, 2), names=("dp", "tp"))),
             ("ring4", R.collectives, dict(shape=(4,), names=("pp",))),
             ("dense", R.dense_tp_forward, dict(params=dense_to_port(params),
                                                cfg=torch_cfg("tiny"), tokens=tokens,
                                                shape=(2, 2)))]
    return np.asarray(ref), R.spawn_cases(4, cases)


@pytest.mark.parametrize("name,shape,names", [("collectives", (2, 2), ("dp", "tp")),
                                              ("ring4", (4,), ("pp",))])
def test_mesh_collectives(run, name, shape, names):
    """psum / pmax / tiled all_gather / one ring step along each axis, in
    bf16, against the values every rank's coordinates give."""
    _, results = run
    ranks = np.arange(4).reshape(shape)
    for rank in range(4):
        res = R.result(results, name, rank)
        assert res["rank"] == rank
        for i, axis in enumerate(names):
            idx = list(np.unravel_index(rank, shape))
            line = []
            for j in range(shape[i]):
                idx[i] = j
                line.append(int(ranks[tuple(idx)]))
            assert res["coords"][axis] == line.index(rank)
            np.testing.assert_array_equal(res[f"psum_{axis}"], [sum(line), len(line)])
            np.testing.assert_array_equal(res[f"pmax_{axis}"], [max(line), 1])
            np.testing.assert_array_equal(res[f"gather_{axis}"],
                                          [[r, 1] for r in line])
            prev = line[(line.index(rank) - 1) % len(line)]
            np.testing.assert_array_equal(res[f"ring_{axis}"], [prev, 1])


def test_dense_tree_on_the_tp_layouts_matches_single_device(run):
    """A dense tree's linears as matmuls on their column and row shards, the
    batch split over dp: each rank's rows of the logits."""
    ref, results = run
    for rank in range(4):
        res = R.result(results, "dense", rank)
        lo, hi = res["rows"]
        assert (lo, hi) == (rank // 2, rank // 2 + 1)
        np.testing.assert_allclose(res["logits"], ref[lo:hi], rtol=2e-4, atol=2e-4)
