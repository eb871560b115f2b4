"""The port's importer of reference (xvyaward/qeft) checkpoints
(``qeft_tpu_torch.import_reference``) and its test writers
(``testing.write_reference_packed`` / ``write_reference_wct``) against
``qeft_tpu.import_reference``, on the CPU.  No file of the reference is
needed: a reference-format dict is built from a random packed ``tiny``
model (two layers, g = 64, r = 8) and both packages import the same dict.

Tolerances, all exact:
- ``unpack_awq`` equals JAX's on random int16 words, bit for bit;
- ``write_reference_packed`` then ``unpack_awq`` gives the codes back;
- both packages' imports of the same packed dict, and of a WCT overlay on
  it, write byte-equal packed checkpoints;
- the imported tree equals the source tree wherever its bf16 values are
  exact in fp16 (codes, ``o_reorder``: everywhere);
- the CLI's checkpoint equals the library's import, and ``main --load``
  evaluates it as the source model (PPL within 1e-4 relative: the slab
  values not exact in fp16 move it by less).
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from qeft_tpu import checkpoint as jckpt
from qeft_tpu import import_reference as jimp
from qeft_tpu.models import LLAMA_PRESETS as JAX_PRESETS
from qeft_tpu_torch import import_reference as timp
from qeft_tpu_torch import main as tmain
from qeft_tpu_torch.checkpoint import save_packed
from qeft_tpu_torch.data import get_loaders
from qeft_tpu_torch.eval import eval_ppl
from qeft_tpu_torch.models.llama import LLAMA_PRESETS
from qeft_tpu_torch.models.registry import get_model_meta
from qeft_tpu_torch.ops.packing import QLinearParams, unpack_codes
from qeft_tpu_torch.pipeline import fuse_packed_stages
from qeft_tpu_torch.testing import (
    build_packed_model,
    write_reference_packed,
    write_reference_wct,
)

torch.set_num_threads(1)
CFG = dataclasses.replace(LLAMA_PRESETS["tiny"], dtype=torch.float32)  # 2 layers


@pytest.fixture(scope="module")
def source():
    """A random packed tiny model and its reference-format dict."""
    params = build_packed_model(CFG, seed=3, g=64, r=8, device="cpu")
    return params, write_reference_packed(params, CFG)


@pytest.mark.parametrize("n,k", [(8, 64), (32, 128), (12, 192), (256, 512)])
def test_unpack_awq_matches_jax(n, k):
    q = np.random.default_rng(n + k).integers(-2 ** 15, 2 ** 15, size=(n // 4, k)).astype(
        np.int16)
    got = timp.unpack_awq(torch.from_numpy(q), n, k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jimp.unpack_awq(q, n, k))


@pytest.mark.parametrize("n,k", [(8, 64), (44, 320)])
def test_awq_pack_then_unpack_is_the_identity(n, k):
    from qeft_tpu_torch.testing import _awq_pack

    codes = torch.from_numpy(np.random.default_rng(k).integers(0, 16, size=(n, k)))
    src = torch.from_numpy(timp._awq_nibble_source_map(n, k))
    packed = _awq_pack(codes, src)
    assert packed.dtype == torch.int16 and packed.shape == (n // 4, k)
    assert torch.equal(timp.unpack_awq(packed, n, k), codes.to(torch.int32))
    np.testing.assert_array_equal(jimp.unpack_awq(packed.numpy(), n, k), codes.numpy())


def test_write_reference_packed_holds_the_source_codes(source):
    params, ckpt = source
    sd = ckpt["model_state_dict"]
    q = params["layers"]["qkv"]
    hd = CFG.num_heads * CFG.head_dim
    want = unpack_codes(q.qweight[1], q.group_size)[:, :hd].t()  # q of layer 1, [N, K]
    got = timp.unpack_awq(sd["model.layers.1.self_attn.q_proj.qweight"], hd, CFG.hidden_size)
    assert torch.equal(got, want)
    assert all(qi.reorder for qi in ckpt["quantinfos"].values())
    assert sd["model.layers.0.mlp.down_proj.oweight"].shape == (CFG.hidden_size, 8)


def _exact_in_fp16(t):
    return t.to(torch.float16).to(t.dtype) == t


def test_import_gives_back_the_source_tree(source):
    params, ckpt = source
    got, family = timp.import_reference_packed("unused.pth", CFG, ckpt=ckpt, device="cpu")
    got = fuse_packed_stages(got, get_model_meta(family))
    assert family == "llama"
    for name, lin in params["layers"].items():
        have = got["layers"][name]
        if not isinstance(lin, QLinearParams):  # norms; o_reorder exact
            exact = _exact_in_fp16(lin) if lin.is_floating_point() else slice(None)
            assert torch.equal(have[exact], lin[exact]), name
            continue
        assert torch.equal(have.qweight, lin.qweight), name
        for field in ("scales", "scaled_zeros", "oweight"):
            want = getattr(lin, field)
            exact = _exact_in_fp16(want)
            assert exact.float().mean() > 0.99
            assert torch.equal(getattr(have, field)[exact], want[exact]), (name, field)
    for key in ("embed", "final_ln", "lm_head"):
        exact = _exact_in_fp16(params[key])
        assert torch.equal(got[key][exact], params[key][exact]), key


def _npz_equal(a, b):
    with np.load(a + ".npz") as za, np.load(b + ".npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for key in za.files:
            np.testing.assert_array_equal(za[key], zb[key], err_msg=key)


def test_both_packages_import_the_same_packed_tree(source, tmp_path):
    _, ckpt = source
    jparams, jfam = jimp.import_reference_packed("unused.pth", JAX_PRESETS["tiny"], ckpt=ckpt)
    tparams, tfam = timp.import_reference_packed("unused.pth", CFG, ckpt=ckpt, device="cpu")
    assert jfam == tfam == "llama"
    jckpt.save_packed(str(tmp_path / "jax"), jparams, JAX_PRESETS["tiny"], family=jfam)
    save_packed(str(tmp_path / "port"), tparams, CFG, family=tfam)
    _npz_equal(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_both_packages_overlay_the_same_wct_slabs(source, tmp_path):
    _, ckpt = source
    base = str(tmp_path / "ref_packed.pth")
    torch.save(ckpt, base)
    hd = CFG.num_heads * CFG.head_dim
    gen = torch.Generator().manual_seed(9)
    slabs = {(1, "q"): torch.randn(8, hd, generator=gen) * 0.1,
             (0, "down"): torch.randn(8, CFG.hidden_size, generator=gen) * 0.1}
    wct = write_reference_wct(slabs, base)
    jparams, _ = jimp.import_reference_wct("unused.pth", JAX_PRESETS["tiny"], ckpt=wct)
    tparams, _ = timp.import_reference_wct("unused.pth", CFG, ckpt=wct, device="cpu")
    jckpt.save_packed(str(tmp_path / "jax"), jparams, JAX_PRESETS["tiny"])
    save_packed(str(tmp_path / "port"), tparams, CFG)
    _npz_equal(str(tmp_path / "jax"), str(tmp_path / "port"))
    for (i, name), w in slabs.items():
        assert torch.equal(tparams["layers"][name].oweight[i],
                           w.to(torch.float16).to(torch.bfloat16))
    base_params, _ = timp.import_reference_packed(base, CFG, device="cpu")
    assert torch.equal(tparams["layers"]["q"].oweight[0], base_params["layers"]["q"].oweight[0])


def test_a_checkpoint_without_the_reorder_raises_as_jax(source):
    _, ckpt = source
    infos = {k: type(v)(**{**vars(v), "reorder": False}) for k, v in ckpt["quantinfos"].items()}
    bad = {**ckpt, "quantinfos": infos}
    with pytest.raises(NotImplementedError) as jerr:
        jimp.import_reference_packed("unused.pth", JAX_PRESETS["tiny"], ckpt=bad)
    with pytest.raises(NotImplementedError) as terr:
        timp.import_reference_packed("unused.pth", CFG, ckpt=bad, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_cli_imports_and_main_serves_it_on_the_cpu(source, tmp_path):
    params, ckpt = source
    src, dst = str(tmp_path / "ref.pth"), str(tmp_path / "imported")
    torch.save(ckpt, src)
    timp.main([src, dst, "--model", "tiny", "--device", "cpu"])
    lib, _ = timp.import_reference_packed(src, LLAMA_PRESETS["tiny"], device="cpu")
    save_packed(str(tmp_path / "lib"), lib, LLAMA_PRESETS["tiny"])
    _npz_equal(dst, str(tmp_path / "lib"))
    with contextlib.redirect_stdout(io.StringIO()):
        res = tmain.main(["--load", dst, "--device", "cpu", "--eval", "--eval_windows", "2",
                          "--seqlen", "32"])
    test = get_loaders("synthetic", train=False, vocab_size=CFG.vocab_size)
    want = eval_ppl(params, test, LLAMA_PRESETS["tiny"], seqlen=32, max_windows=2,
                    device="cpu")
    np.testing.assert_allclose(res["ppl_synthetic"], want, rtol=1e-4)
