"""What the families' references share: the packed layout read back, the
linear with its weak-column slab, LayerNorm, softmax attention, and the
arithmetic the reference runs in.

`Arith` is the precision: ``F32`` (float32, TF32 off) is the reference;
``FP8`` rounds both operands of every product (the linears, the two of
attention and the head) to float8 e4m3 with a per-tensor scale, summing in
float32: the control that sits one precision below the configurations'
bfloat16."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

F8_MAX = 448.0  # largest float8 e4m3fn value


def no_tf32() -> None:
    """Float32 products in float32: TF32 off for matmul and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in f32;
    the gradient passes straight through."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / F8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t).detach()


@dataclasses.dataclass(frozen=True)
class Arith:
    fp8: bool = False

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x, w = to_fp8(x), to_fp8(w)
        return torch.matmul(x, w)


F32 = Arith()
FP8 = Arith(fp8=True)


def unpack_codes(words: torch.Tensor, group: int) -> torch.Tensor:
    """int32 [K/8, N] -> codes [K, N] (0..15).  Word row ``jj*G + gi`` holds,
    in nibble p, K-row ``gi*g + p*(g/8) + jj`` of group gi."""
    k8, n = words.shape
    k, h = k8 * 8, group // 8
    w = words.to(torch.int64).reshape(h, k // group, n)  # [jj, gi, N]
    nib = torch.stack([(w >> (4 * p)) & 0xF for p in range(8)])  # [p, jj, gi, N]
    return nib.permute(2, 0, 1, 3).reshape(k, n)  # row gi*g + p*h + jj


def dequant(lin: Dict[str, torch.Tensor], l: int, group: int) -> torch.Tensor:
    """Layer ``l``'s INT4 weight [K, N] in f32: code * scale + scaled zero."""
    codes = unpack_codes(lin["qweight"][l], group).to(torch.float32)
    s = lin["scales"][l].to(torch.float32).repeat_interleave(group, dim=0)
    z = lin["szeros"][l].to(torch.float32).repeat_interleave(group, dim=0)
    return codes * s + z


def linear(x: torch.Tensor, w: torch.Tensor, slab: torch.Tensor,
           bias: Optional[torch.Tensor], ar: Arith) -> torch.Tensor:
    """``x @ W + x[..., K-r:] @ slab (+ bias)``: the INT4 product over all K
    rows and the weak rows' slab on top of it."""
    r = slab.shape[0]
    y = ar.mm(x, w) + ar.mm(x[..., x.shape[-1] - r:], slab)
    return y if bias is None else y + bias


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ar: Arith) -> torch.Tensor:
    """Causal softmax attention: q [B, S, H, Dh], k / v [B, S, Hkv, Dh], each
    key head serving H/Hkv query heads -> [B, S, H*Dh]."""
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    qh = q.transpose(1, 2).reshape(b, hkv, h // hkv, s, dh)
    kh = k.transpose(1, 2)[:, :, None]  # [B, Hkv, 1, S, Dh]
    vh = v.transpose(1, 2)[:, :, None]
    scores = ar.mm(qh, kh.transpose(-1, -2)) / dh ** 0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    ctx = ar.mm(torch.softmax(scores, dim=-1), vh)  # [B, Hkv, H/Hkv, S, Dh]
    return ctx.reshape(b, h, s, dh).transpose(1, 2).reshape(b, s, h * dh)


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def layer_params(raw: Dict, dims, l: int, slabs: Optional[Dict] = None) -> Dict:
    """Layer ``l`` in f32: each linear's dequantized weight, slab and bias
    (``slabs``: trainable f32 slabs by linear name, each a list over layers,
    in place of the packed model's), the norms and the o-projection's input
    gather."""
    lay = raw["layers"]
    p = {"o_reorder": lay["o_reorder"][l].to(torch.int64)}
    for name in ("attn_ln", "attn_ln_b", "final_ln", "final_ln_b"):
        if name in lay:
            p[name] = f32(lay[name][l])
    for name, _, _ in dims.linears:
        b = lay.get(name + "_b")
        p[name] = {"w": dequant(lay[name], l, dims.group),
                   "slab": slabs[name][l] if slabs is not None else f32(lay[name]["oweight"][l]),
                   "bias": None if b is None else f32(b[l])}
    return p


def apply(p: Dict, name: str, x: torch.Tensor, ar: Arith) -> torch.Tensor:
    lin = p[name]
    return linear(x, lin["w"], lin["slab"], lin["bias"], ar)
