"""The reference over served requests: one full forward of each prompt with
its served tokens, layer by layer over all the sampled requests (one
layer's f32 weights on the card at a time), and the widest gap by which a
served token's logit lies below the reference's best at its position.
With ``control`` the same forward runs beside it in float8 (`common.FP8`),
and the gap of the token the float8 forward puts first is read too."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference import common, family, layer_params


@torch.no_grad()
def gaps(dims, raw: Dict, seqs: List[Tuple[torch.Tensor, int, torch.Tensor]],
         control: bool = False) -> Dict[str, float]:
    """``seqs``: (prompt [B, P], P, served [B, T]) on the card.  -> {"gap":
    widest gap of a served token, and with ``control`` "control_gap", the
    widest gap of the float8 forward's first choice at each position}."""
    common.no_tf32()
    fam = family(dims.family)
    params = layer_params(fam)
    ariths = [common.F32] + ([common.FP8] if control else [])
    xs = {ar: [fam.embed(raw, dims, torch.cat([p, s[:, :-1]], dim=1)) for p, _, s in seqs]
          for ar in ariths}
    for l in range(dims.layers):
        lp = params(raw, dims, l)
        for ar in ariths:
            xs[ar] = [fam.block(lp, x, dims, ar) for x in xs[ar]]
        del lp
    gaps_of = {"": []} if not control else {"": [], "control_": []}
    for j, (_, plen, served) in enumerate(seqs):
        ref = fam.logits(raw, dims, xs[common.F32][j][:, plen - 1:], common.F32)
        best = ref.amax(dim=-1)
        gaps_of[""].append(best - ref.gather(-1, served[..., None].to(torch.int64))[..., 0])
        if control:
            low = fam.logits(raw, dims, xs[common.FP8][j][:, plen - 1:], common.FP8)
            gaps_of["control_"].append(best - ref.gather(-1, low.argmax(-1, keepdim=True))[..., 0])
    return {prefix + "gap": max(float(g.amax()) for g in parts)
            for prefix, parts in gaps_of.items()}
