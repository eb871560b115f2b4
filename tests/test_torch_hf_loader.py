"""The port's Hugging Face reader (``qeft_tpu_torch.models.hf_loader``)
against ``qeft_tpu.models.hf_loader`` on tiny random models of every family,
written by ``transformers``' ``save_pretrained`` as tests/test_hf_parity.py
writes them: the two trees and configs are equal, bit for bit, in f32 and
in bf16.  The port's safetensors reader against the ``safetensors``
package on the same files (a bf16 tensor and a sharded index included),
and the quantization CLIs with ``--model <dir>``."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qeft_tpu.checkpoint import _flatten
from qeft_tpu.models.hf_loader import load_hf_model as jax_load_hf_model
from qeft_tpu_torch.checkpoint import to_flat
from qeft_tpu_torch.models.hf_loader import load_hf_model, read_safetensors


def _llama():
    from transformers import LlamaConfig, LlamaForCausalLM

    return LlamaForCausalLM(LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        tie_word_embeddings=False))


def _gemma():
    from transformers import GemmaConfig, GemmaForCausalLM

    return GemmaForCausalLM(GemmaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, max_position_embeddings=64))


def _opt():
    from transformers import OPTConfig, OPTForCausalLM

    return OPTForCausalLM(OPTConfig(
        vocab_size=128, hidden_size=64, ffn_dim=128, num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=64, word_embed_proj_dim=64, do_layer_norm_before=True))


def _opt_350m():
    from transformers import OPTConfig, OPTForCausalLM

    return OPTForCausalLM(OPTConfig(
        vocab_size=128, hidden_size=64, ffn_dim=128, num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=64, word_embed_proj_dim=32, do_layer_norm_before=False))


def _phi():
    from transformers import PhiConfig, PhiForCausalLM

    return PhiForCausalLM(PhiConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4, partial_rotary_factor=0.5,
        max_position_embeddings=64))


def _bloom():
    from transformers import BloomConfig, BloomForCausalLM

    return BloomForCausalLM(BloomConfig(vocab_size=128, hidden_size=64, n_layer=2, n_head=4))


def _falcon():
    from transformers import FalconConfig, FalconForCausalLM

    return FalconForCausalLM(FalconConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        multi_query=True, parallel_attn=True, bias=False, new_decoder_architecture=False,
        alibi=False))


def _falcon_40b():
    from transformers import FalconConfig, FalconForCausalLM

    return FalconForCausalLM(FalconConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_kv_heads=2, parallel_attn=True, bias=False, new_decoder_architecture=True,
        alibi=False))


MODELS = {"llama": _llama, "gemma": _gemma, "opt": _opt, "opt-350m": _opt_350m, "phi": _phi,
          "bloom": _bloom, "falcon": _falcon, "falcon-40b": _falcon_40b}


def _save(name, path, noisy=True, **kw):
    torch.manual_seed(0)
    model = MODELS[name]()
    if noisy:  # the norms and biases random too, so that each leaf is checked
        for p in model.parameters():
            p.data.add_(torch.randn_like(p) * 0.02)
    model.save_pretrained(str(path), safe_serialization=True, **kw)
    return str(path)


def _assert_same_tree(port, jax_tree):
    got, want = to_flat(port), _flatten(jax_tree)
    assert sorted(got) == sorted(want)
    for key, v in want.items():
        v = np.asarray(v)
        if v.dtype == jnp.bfloat16:
            v = v.view(np.uint16)
        assert got[key].shape == v.shape, key
        np.testing.assert_array_equal(got[key], v, err_msg=key)


@pytest.mark.parametrize("name", list(MODELS))
def test_tree_equals_the_jax_loaders(name, tmp_path):
    path = _save(name, tmp_path)
    for tdtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        params, cfg, family = load_hf_model(path, dtype=tdtype, device="cpu")
        jparams, jcfg, jfamily = jax_load_hf_model(path, dtype=jdtype)
        assert family == jfamily
        _assert_same_tree(params, jparams)
        got, want = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
        assert str(got.pop("dtype")).split(".")[-1] == jnp.dtype(want.pop("dtype")).name
        assert got == want


def test_a_sharded_checkpoint_reads_as_one(tmp_path):
    """``save_pretrained`` with a small shard size writes
    ``model.safetensors.index.json`` and several shards."""
    path = _save("opt", tmp_path, max_shard_size="40KB")
    assert os.path.exists(os.path.join(path, "model.safetensors.index.json"))
    assert len([f for f in os.listdir(path) if f.endswith(".safetensors")]) > 2
    params, _, _ = load_hf_model(path, dtype=torch.float32, device="cpu")
    jparams, _, _ = jax_load_hf_model(path, dtype=jnp.float32)
    _assert_same_tree(params, jparams)


def test_safetensors_reader_equals_the_safetensors_package(tmp_path):
    from safetensors.numpy import load_file as np_load, save_file as np_save
    from safetensors.torch import load_file as torch_load, save_file as torch_save

    rng = np.random.default_rng(0)
    arrays = {"f32": rng.normal(size=(3, 5)).astype(np.float32),
              "f16": rng.normal(size=(7,)).astype(np.float16),
              "f64": rng.normal(size=(2, 2, 2)),
              "i64": rng.integers(-9, 9, size=(4,)),
              "i32": rng.integers(-9, 9, size=(2, 3)).astype(np.int32),
              "i8": rng.integers(-9, 9, size=(5,)).astype(np.int8),
              "u8": rng.integers(0, 255, size=(6,)).astype(np.uint8),
              "bool": rng.random(4) > 0.5,
              "scalar": np.asarray(1.5, np.float32),
              "empty": np.zeros((0, 3), np.float32)}
    np_save(arrays, str(tmp_path / "a.safetensors"), metadata={"format": "np"})
    got = read_safetensors(str(tmp_path / "a.safetensors"))
    want = np_load(str(tmp_path / "a.safetensors"))
    assert sorted(got) == sorted(want)
    for key, v in want.items():
        assert got[key].numpy().dtype == v.dtype and got[key].shape == v.shape, key
        np.testing.assert_array_equal(got[key].numpy(), v, err_msg=key)
    bf16 = {"w": torch.randn(4, 6).to(torch.bfloat16), "b": torch.randn(6).to(torch.bfloat16)}
    torch_save(bf16, str(tmp_path / "b.safetensors"))
    got = read_safetensors(str(tmp_path / "b.safetensors"), {"w"})
    want = torch_load(str(tmp_path / "b.safetensors"))
    assert list(got) == ["w"] and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), want["w"].view(torch.int16))


def test_quantization_clis_read_a_hugging_face_directory(tmp_path):
    """``extract_outidx --model <dir>`` and ``main --model <dir> --reorder
    --packing`` on an OPT directory, on the CPU: the tree quantized is the
    one the loader reads (bf16, the model's own initialisation), and JAX
    reads the packed checkpoint."""
    from qeft_tpu.checkpoint import load_packed as jax_load_packed
    from qeft_tpu_torch import extract_outidx, main

    path = _save("opt", tmp_path / "hf", noisy=False)
    common = ["--model", path, "--device", "cpu", "--wbits", "4", "--target_rank", "8",
              "--groupsize", "32", "--no_frob_norm", "--nsamples", "2", "--seqlen", "16"]
    res = extract_outidx.main(common + ["--output_dir", str(tmp_path / "oidx")])
    assert res["outidx"].shape == (8,)
    save = str(tmp_path / "ckpt")
    res = main.main(common + ["--reorder", "--outidx_file", os.path.join(res["dir"], "outidx.npy"),
                              "--packing", "--save", save, "--eval", "--eval_windows", "2"])
    assert res["fake_vs_packed_delta"] < 1e-2 and np.isfinite(res["ppl_synthetic"])
    jparams, jcfg, family = jax_load_packed(save + "_packed")
    with open(os.path.join(path, "config.json")) as f:
        assert family == "opt" and jcfg.hidden_size == json.load(f)["hidden_size"]


def test_the_port_writes_a_directory_both_readers_read_back(tmp_path):
    """``testing.write_hf_opt`` (the writer ``chip_smoke.py`` uses) on the
    ``opt-tiny`` preset, in one file and in three shards with an index:
    the port's reader gives the tree written, bit for bit, and the
    ``safetensors`` package and JAX's loader read the same tensors."""
    from safetensors.torch import load_file

    from qeft_tpu_torch.models.opt import OPT_PRESETS, init_params
    from qeft_tpu_torch.testing import write_hf_opt

    cfg = OPT_PRESETS["opt-tiny"]
    params = init_params(cfg, seed=3, dtype=torch.bfloat16, device="cpu")
    want = to_flat(params)
    for shards in (1, 3):
        path = str(tmp_path / f"s{shards}")
        write_hf_opt(path, params, cfg, shards=shards)
        got, lcfg, family = load_hf_model(path, device="cpu")
        assert family == "opt" and lcfg == cfg
        flat = to_flat(got)
        assert sorted(flat) == sorted(want)
        for key, v in want.items():
            np.testing.assert_array_equal(flat[key], v, err_msg=key)
        _assert_same_tree(got, jax_load_hf_model(path)[0])
    files = [f for f in os.listdir(path) if f.endswith(".safetensors")]
    assert len(files) == 3
    for f in files:
        ours = read_safetensors(os.path.join(path, f))
        theirs = load_file(os.path.join(path, f))
        assert sorted(ours) == sorted(theirs)
        assert all(torch.equal(ours[k].view(torch.int16), theirs[k].view(torch.int16))
                   for k in ours)
