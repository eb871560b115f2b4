"""The plain reference against the port's CPU path, at small OPT and Falcon
sizes, on the benchmark's own weights: the packed layout read back bit for
bit, the forward's logits, and WCT's loss and slab gradients."""

import pytest
import torch

from portbench import program, shapes, weights
from portbench.reference import common, family
from portbench.reference import train as ref_train
from portbench.tests import small

CONFIGS = ["opt-6.7b", "falcon-7b"]


def setup(name, seed=3):
    dims = shapes.dims(small.config(name))
    return dims, weights.make(dims, seed, torch.device("cpu"))


def test_unpack_matches_the_port_bit_for_bit():
    from qeft_tpu_torch.ops.packing import pack_codes, unpack_codes

    gen = torch.Generator().manual_seed(0)
    for g in (64, 128):
        codes = torch.randint(0, 16, (256, 40), generator=gen, dtype=torch.int32)
        words = pack_codes(codes, g)
        assert torch.equal(common.unpack_codes(words, g).to(torch.int32), codes)
    dims, raw = setup("falcon-7b")
    lin = raw["layers"]["fc2"]
    assert torch.equal(common.unpack_codes(lin["qweight"][1], 64).to(torch.int32),
                       unpack_codes(lin["qweight"][1], 64))


def ref_logits(dims, raw, tokens, ar=common.F32):
    fam = family(dims.family)
    x = fam.embed(raw, dims, tokens)
    for l in range(dims.layers):
        x = fam.block(common.layer_params(raw, dims, l), x, dims, ar)
    return fam.logits(raw, dims, x, ar)


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_agrees_with_the_port(name):
    dims, raw = setup(name)
    api = program.api(dims)
    tokens = torch.randint(0, dims.vocab, (2, 24), generator=torch.Generator().manual_seed(1))
    port = api.forward(program.tree(dims, raw), tokens, program.config(dims)).float()
    ref = ref_logits(dims, raw, tokens)
    scale = ref.std()
    # the tied head (embeddings of std 0.02) over unit-variance features
    assert 0.5 < float(scale) / (0.02 * dims.hidden ** 0.5) < 2
    err = (port - ref).abs().amax() / scale
    assert err < 0.05, err  # bf16 activations through two layers
    low = ref_logits(dims, raw, tokens, common.FP8)
    assert (low - ref).abs().amax() / scale > 2 * err  # float8 is coarser than the port


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_and_cached_decode_agree_with_the_reference(name):
    from qeft_tpu_torch.generate import generate

    dims, raw = setup(name)
    api, cfg = program.api(dims), program.config(dims)
    prompt = torch.randint(0, dims.vocab, (2, 20), generator=torch.Generator().manual_seed(2))
    cache = api.init_cache(cfg, 2, 64, device=torch.device("cpu"))
    served, _ = generate(program.tree(dims, raw), prompt, cache, cfg, 8, api=api, device="cpu")
    ref = ref_logits(dims, raw, torch.cat([prompt, served[:, :-1]], 1))[:, 19:]
    gap = ref.amax(-1) - ref.gather(-1, served[..., None])[..., 0]
    assert float(gap.amax()) < 0.05 * float(ref.std())


def test_training_reference_agrees_with_the_port():
    from qeft_tpu_torch.finetune import split_wct, wct_loss

    dims, raw = setup("opt-6.7b")
    mix = small.traffic("wct-train")
    gen = torch.Generator().manual_seed(4)
    ids = torch.randint(0, dims.vocab, (1, 2, 32), generator=gen)
    labels = ids.clone()
    labels[..., :6] = -100
    oweights, frozen = split_wct(program.tree(dims, raw))
    loss = wct_loss(oweights, frozen, ids[0], labels[0], program.config(dims), True, "opt")
    loss.backward()
    slabs = {n: [t.detach().clone().requires_grad_() for t in ts] for n, ts in oweights.items()}
    ref = ref_train.loss_fn(dims, raw, slabs, ids[0], labels[0], common.F32)
    ref.backward()
    assert abs(float(loss.detach()) - float(ref.detach())) / float(ref.detach()) < 1e-2
    for n in slabs:
        for p, r in zip(oweights[n], slabs[n]):
            # bf16 activations: each element off by some percent, the norm by less
            assert (p.grad - r.grad).norm() / r.grad.norm() < 0.15
            assert abs(p.grad.norm() - r.grad.norm()) / r.grad.norm() < 0.03
    out = ref_train.run(dims, raw, mix, ids.expand(3, -1, -1), labels.expand(3, -1, -1))
    assert len(out["losses"]) == 3 and len(out["grad1"]) == len(out["change"]) == 6 * 2
    assert all(v > 0 for v in out["change"].values())
