"""The plain versions of the probe kernels (``qeft_tpu_torch/probes``) against
the Pallas kernels of their scripts under ``scripts/``, in interpret mode on
the CPU, at tiny shapes.

The scripts run their measurements when imported (``entry_overhead_probe.py``
builds a 7B model), so they are not imported: the kernel definitions are
taken out of each file with ``ast`` and run in a namespace holding ``jax``,
``jnp``, ``pl`` and ``pltpu``, with the scripts' own BlockSpecs.  Inputs come
from a numpy seed.  Tolerances: P1, P2 and P3 exact (their results are
integers, or an int32 word cast to f32 plus an f32 value, computed the same
way on both sides); the nine P4 variants within 1e-2 of the output's scale
(bf16 outputs of f32 sums taken in another order).
"""

import ast
import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from qeft_tpu_torch.probes import dma, dma2, entry_overhead, ring_sweep
from qeft_tpu_torch.probes import gemv_ablation as p4
from tests.torch_parity import f32  # noqa: F401  (one torch thread per worker)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
P4_RTOL = 1e-2
# pl with every pallas_call in interpret mode (for the script functions that
# make their own call)
PL_INTERPRET = types.SimpleNamespace(
    pallas_call=functools.partial(pl.pallas_call, interpret=True), BlockSpec=pl.BlockSpec)


def _script_defs(script: str, names, **scope):
    """The top-level functions ``names`` of ``scripts/<script>`` defined in a
    fresh namespace with jax, jnp, pl, pltpu and ``scope``."""
    tree = ast.parse((SCRIPTS / script).read_text())
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert {n.name for n in body} == set(names), f"{script} lacks one of {names}"
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, **scope)
    exec(compile(ast.Module(body=body, type_ignores=[]), str(SCRIPTS / script), "exec"), ns)
    return ns


def _words(k8, n, seed):
    return np.random.default_rng(seed).integers(-(2 ** 31), 2 ** 31, (k8, n),
                                                dtype=np.int64).astype(np.int32)


def test_p1_add_one_plain_is_the_tiny_kernel():
    ns = _script_defs("entry_overhead_probe.py", {"_tiny_kernel"})
    x = np.random.default_rng(0).standard_normal((8, 128)).astype(np.float32)
    ref = pl.pallas_call(ns["_tiny_kernel"], out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
                         interpret=True)(jnp.asarray(x))
    got = entry_overhead.add_one(torch.from_numpy(x))  # a CPU tensor: the plain version
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert entry_overhead.chain(entry_overhead.add_one, torch.zeros(8, 128))[0, 0] == 512


@pytest.mark.parametrize("name", ["dma_only", "unpack_only"])
@pytest.mark.parametrize("k8,n,bn", [(16, 256, 128), (40, 512, 256)])
def test_p2_column_sums_are_the_script_kernels(name, k8, n, bn):
    ns = _script_defs("dma_probe.py", {"dma_kernel", "unpack_kernel", "dma_only", "unpack_only"},
                      K=8 * k8, N=n, BN=bn)
    ns["pl"] = PL_INTERPRET
    qw = _words(k8, n, seed=k8)
    ref = np.asarray(ns[name](jnp.asarray(qw)))
    got = getattr(dma, name)(torch.from_numpy(qw))
    assert got.dtype == torch.float32 and got.shape == (8, n)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_p2_sums_wrap_as_int32():
    qw = np.full((4, 8), 2 ** 30, dtype=np.int32)  # 2^32 wraps to 0
    assert dma.dma_only(torch.from_numpy(qw))[0, 0].item() == 0.0
    assert dma.unpack_only(torch.from_numpy(qw))[0, 0].item() == 4 * 4.0  # nibble 7 is 4


@pytest.mark.parametrize("bn", [64, 128, 256])
def test_p3_dma_tile_plain_is_the_script_kernel(bn):
    k8, n = 24, 256
    qw = _words(k8, n, seed=bn)
    s = np.random.default_rng(bn + 1).standard_normal((8, n)).astype(np.float32)
    ns = _script_defs("dma_probe2.py", {"make"}, K8=k8, N=n, qw=jnp.asarray(qw))
    ns["pl"] = PL_INTERPRET
    ref = np.asarray(ns["make"](bn)(jnp.asarray(s)))
    got = dma2.dma_tile(torch.from_numpy(qw), torch.from_numpy(s), bn)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("variant", p4.VARIANTS)
def test_p4_ablation_plain_is_the_script_kernel(variant):
    """``make_kernel`` under ``build``'s BlockSpecs (grid (1, N / bn)), K =
    1024, N = 256, g = 128: 8 scale rows tiled over 128 word rows."""
    k, n, g, bn = 1024, 256, 128, 128
    ns = _script_defs("gemv_ablation_probe.py", {"make_kernel"})
    call = pl.pallas_call(
        ns["make_kernel"](variant, k // g),
        out_shape=jax.ShapeDtypeStruct((8, n), jnp.bfloat16),
        grid=(1, n // bn),
        in_specs=[pl.BlockSpec((8, k), lambda i, j: (i, 0)),
                  pl.BlockSpec((k // 8, bn), lambda i, j: (0, j)),
                  pl.BlockSpec((k // g, bn), lambda i, j: (0, j))],
        out_specs=pl.BlockSpec((8, bn), lambda i, j: (i, j)),
        interpret=True)
    x, qw, s = p4.random_inputs(k, n, g, seed=3, device="cpu")
    ref = np.asarray(call(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                          jnp.asarray(qw.numpy()), jnp.asarray(s.numpy())).astype(jnp.float32))
    got = p4.gemv_ablation(variant, x, qw, s, bn)
    assert got.dtype == torch.bfloat16 and got.shape == (8, n)
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= P4_RTOL * np.abs(ref).max(), err


def test_p4_scales_are_tiled_not_repeated():
    """Word row w takes scale row w mod K/g (pltpu.repeat tiles): with one
    nonzero scale row, only word rows 0, G, 2G, ... contribute."""
    k, n, g = 1024, 128, 128
    x, qw, s = p4.random_inputs(k, n, g, seed=5, device="cpu")
    s = torch.zeros_like(s)
    s[0] = 1.0
    keep = torch.zeros(k // 8, dtype=torch.bool)
    keep[:: k // g] = True
    masked = torch.where(keep[:, None], qw, torch.zeros_like(qw))
    torch.testing.assert_close(p4.gemv_ablation("v6_f32dot", x, qw, s),
                               p4.gemv_ablation("v6_f32dot", x, masked, s), rtol=0, atol=0)


def test_p4_dequantized_weight_is_v0_full():
    k, n, g = 1024, 256, 128
    x, qw, s = p4.random_inputs(k, n, g, seed=7, device="cpu")
    want = p4.gemv_ablation_plain("v0_full", x, qw, s).float()
    got = (x.float() @ p4.dequantized(torch.bfloat16, qw, s).float())
    assert (got - want).abs().max() <= P4_RTOL * want.abs().max()


@pytest.mark.parametrize("module", [entry_overhead, dma, dma2, p4, ring_sweep])
def test_probe_mains_need_a_gpu_unless_cpu_is_named(monkeypatch, capsys, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main([])
    res = module.main(["--device", "cpu"])
    assert res["device"] == "cpu" and res["times"] == "not measured"
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("{")
