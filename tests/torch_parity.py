"""Shared helpers of the tests/test_torch_*.py parity tests: one packed model
built by the JAX package, carried into the PyTorch port through the
checkpoint key format.  Not a test module itself."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from qeft_tpu.checkpoint import _flatten
from qeft_tpu.models import LLAMA_PRESETS
from qeft_tpu.testing import build_packed_model as jax_build_packed_model
from qeft_tpu_torch.checkpoint import from_flat
from qeft_tpu_torch.models.llama import LLAMA_PRESETS as TORCH_PRESETS
from qeft_tpu_torch.models.registry import get_model_meta
from qeft_tpu_torch.pipeline import fuse_packed_stages

# The suite runs several pytest workers on one host, each collecting every
# test module.  Torch's default of one intra-op thread per core then
# oversubscribes the host several times over, and its spinning OpenMP
# threads slow some tiny CPU parity tests a hundredfold; one thread per
# worker keeps them near their time alone.
torch.set_num_threads(1)


def gptq_packed_tiny(seed=0):
    """The ``packed_tiny`` recipe of tests/test_finetune.py: real GPTQ, real
    OGR o_reorder, f32, g = 64, r = 8, on the ``tiny`` preset."""
    from tests.test_finetune import packed_tiny

    return packed_tiny(seed)


def random_packed(name, seed=0):
    """``qeft_tpu.testing.build_packed_model`` on preset ``name`` (f32, g = 64,
    r = 8; identity ``o_reorder``): seconds to build where the GPTQ recipe
    takes about fifteen."""
    return jax_build_packed_model(LLAMA_PRESETS[name], jax.random.PRNGKey(seed),
                                  g=64, r=8, fuse_stages=False, dtype=jnp.float32)


def random_packed_tiny_gemma(seed=0):
    return random_packed("tiny-gemma", seed)


def random_packed_tiny(seed=0):
    return random_packed("tiny", seed)


# the random packed models of the serving parity tests, by preset: family
RANDOM_MODELS = {"tiny": "llama", "tiny-gemma": "gemma"}


def random_models():
    """{preset: (JAX params, port params, JAX config, port f32 config,
    family)} for every entry of RANDOM_MODELS."""
    built = {}
    for name, family in RANDOM_MODELS.items():
        jparams = random_packed(name)
        built[name] = (jparams, to_port(jparams, family), LLAMA_PRESETS[name], torch_cfg(name),
                       family)
    return built


def random_tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def assert_close_to_scale(got, ref):
    """Within 1e-4 relative and 1e-4 of max |ref|: the model parity bound."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(f32(got), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def to_port(jax_params, family="llama"):
    """JAX packed tree -> the port's fused tree (CPU tensors)."""
    return fuse_packed_stages(from_flat(_flatten(jax_params)), get_model_meta(family))


def torch_cfg(name):
    """The port's preset ``name`` with f32 activations (parity runs in f32)."""
    return dataclasses.replace(TORCH_PRESETS[name], dtype=torch.float32)


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def oweights_to_port(jax_oweights, family="llama"):
    """A JAX ``oweights`` dict (per linear name, ``[L, r, N]``) -> the port's
    trainable form: fused stages, per-layer f32 leaves."""
    from qeft_tpu_torch.pipeline import fuse_tensors

    per_name = {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in jax_oweights.items()}
    fused = fuse_tensors(per_name, get_model_meta(family))
    return {k: [t.clone().requires_grad_() for t in v.unbind(0)] for k, v in fused.items()}


def oweights_from_port(oweights, cfg, family="llama"):
    """The port's per-layer leaves -> numpy ``[L, r, N]`` per linear name."""
    from qeft_tpu_torch.pipeline import member_widths, split_fused

    meta = get_model_meta(family)
    stacked = {k: torch.stack([t.detach() for t in v]) for k, v in oweights.items()}
    return {k: v.numpy() for k, v in split_fused(stacked, meta, member_widths(cfg, meta)).items()}


# the tiny family models of tests/test_torch_families.py: preset -> (family,
# whether the JAX package packs it with the global reorder; without it every
# linear carries its own reorder_ids)
FAMILY_MODELS = {
    "opt-tiny": ("opt", True),
    "opt-tiny-350m": ("opt", False),
    "phi-tiny": ("phi", True),
    "bloom-tiny": ("bloom", False),
    "falcon-tiny": ("falcon", True),
    "falcon-tiny-40b": ("falcon", False),
}


def family_presets(family):
    """(JAX module, its presets, the port's presets) of ``family``."""
    import importlib

    jmod = importlib.import_module(f"qeft_tpu.models.{family}")
    tmod = importlib.import_module(f"qeft_tpu_torch.models.{family}")
    key = f"{family.upper()}_PRESETS"
    return jmod, getattr(jmod, key), getattr(tmod, key)


def quantized_family(name, seed=5, reorder=None):
    """Preset ``name`` of FAMILY_MODELS quantized (GPTQ-OWQ, 4 bits, group
    32, rank 8, 2 x 16 calibration tokens) and packed in f32 by the JAX
    package, as tests/test_families.py does -> (JAX params, port params,
    JAX config, port f32 config, family).  ``reorder`` overrides the
    preset's global reorder."""
    from qeft_tpu.models.registry import get_model_meta as jax_meta
    from qeft_tpu.pipeline import QuantizeArgs, extract_global_outidx, pack_model, quantize_model
    from qeft_tpu.quant.quantizer import QuantSpec

    family, preset_reorder = FAMILY_MODELS[name]
    reorder = preset_reorder if reorder is None else reorder
    jmod, jpresets, tpresets = family_presets(family)
    cfg = jpresets[name]
    meta = jax_meta(family)
    params = jmod.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    calib = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 16))
    args = QuantizeArgs(spec=QuantSpec(bits=4, sym=False, mse=False, group_size=32),
                        target_rank=8, no_frob_norm=True, nsamples=2, reorder=reorder)
    outidx = extract_global_outidx(params, calib, cfg, meta, args)[0] if reorder else None
    qparams, quantizers = quantize_model(params, calib, cfg, meta, args, outidx)
    packed = pack_model(qparams, quantizers, cfg, meta, dtype=jnp.float32)
    return (packed, to_port(packed, family), cfg,
            dataclasses.replace(tpresets[name], dtype=torch.float32), family)


def random_packed_linear(seed, layers, k, n, g, r):
    """A stacked ``[layers, ...]`` packed linear of the port in f32: codes,
    scales, zero points and an oweight of ``r`` rows (none at 0) drawn with
    numpy from ``seed``, the codes packed by the JAX package's
    ``pack_codes`` (the checkpoint format)."""
    from qeft_tpu.ops.packing import pack_codes
    from qeft_tpu_torch.ops.packing import QLinearParams

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 16, size=(layers, k, n)).astype(np.int32)
    qw = np.stack([np.array(pack_codes(jnp.asarray(c), g)) for c in codes])
    sc = (rng.random((layers, k // g, n)) * 0.02 + 0.01).astype(np.float32)
    sz = (-rng.random((layers, k // g, n)) * 0.16).astype(np.float32)
    ow = (rng.normal(size=(layers, r, n)) * 0.02).astype(np.float32) if r else None
    return QLinearParams(torch.from_numpy(qw), torch.from_numpy(sc), torch.from_numpy(sz),
                         oweight=None if ow is None else torch.from_numpy(ow), group_size=g)


def states_to_port(states):
    """JAX quantizer states {(block, name): QuantizerState} -> the port's."""
    from qeft_tpu_torch.pipeline import QuantizerState

    return {k: QuantizerState(
        scale_group=torch.from_numpy(np.array(st.scale_group)),
        zero_group=torch.from_numpy(np.array(st.zero_group)),
        out_ids=torch.from_numpy(np.array(st.out_ids)), sym=st.sym, bits=st.bits,
        group_size=st.group_size) for k, st in states.items()}


def tp_packed_tiny_v2():
    """The model of tests/test_tp_forward.py and test_serving_tp.py: tiny-v2
    (4 heads of 128, f = 1024) quantized by GPTQ-OWQ with the real OGR in
    f32, g = 128, r = 16, packed with fused stages by the JAX package."""
    from qeft_tpu.models import init_params
    from qeft_tpu.models.registry import get_model_meta as jax_meta
    from qeft_tpu.pipeline import QuantizeArgs, extract_global_outidx, pack_model, quantize_model
    from qeft_tpu.quant.quantizer import QuantSpec

    cfg, meta = LLAMA_PRESETS["tiny-v2"], jax_meta("llama")
    params = init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    calib = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 16))
    args = QuantizeArgs(spec=QuantSpec(bits=4, sym=False, mse=False, group_size=128),
                        target_rank=16, no_frob_norm=True, nsamples=2)
    outidx, _ = extract_global_outidx(params, calib, cfg, meta, args)
    qparams, quantizers = quantize_model(params, calib, cfg, meta, args, outidx)
    return jax.tree.map(jnp.asarray, pack_model(qparams, quantizers, cfg, meta,
                                                dtype=jnp.float32, fuse_stages=True))


def with_bias_no_outlier(packed):
    """tests/test_tp_forward.py's hardening tree: every fused stage biased,
    upgate and down without weak columns."""
    rng = np.random.default_rng(1)
    layers = dict(packed["layers"])
    for name in ("qkv", "o", "upgate", "down"):
        lin = layers[name]
        nl, n = lin.qweight.shape[0], lin.qweight.shape[-1]
        bias = jnp.asarray(rng.normal(size=(nl, n)).astype(np.float32) * 0.1)
        ow = None if name in ("upgate", "down") else lin.oweight
        layers[name] = dataclasses.replace(lin, bias=bias, oweight=ow)
    return dict(packed, layers=layers)


def dense_to_port(jax_params, family="llama"):
    """A dense JAX tree (member names) -> the port's fused dense tree."""
    from qeft_tpu_torch.pipeline import fuse_dense_stages

    return fuse_dense_stages(from_flat(_flatten(jax_params)), get_model_meta(family))


def torch_tree(tree):
    """JAX arrays (a cache, a dict of leaves) -> CPU tensors."""
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
