"""The quantization pipeline of every family (GPTQ-OWQ with OGR's global
reorder, packing), and the stage fusion of packed and dense trees.

Counterpart of ``qeft_tpu/pipeline.py``:

- `extract_global_outidx` -- OGR step 1: blocks run over the calibration
  samples one by one, the normalised Hessian diagonals of the
  residual-stream stages add up, the global top ``target_rank`` channels
  are the weak set;
- `quantize_model` -- GPTQ-OWQ of every linear block by block (each
  block's calibration forward through its quantized linears feeds the
  next), then `reorder_model`, OGR step 2;
- `pack_model` -- every quantized linear into the packed layout the
  kernels read, optionally with q/k/v and up/gate fused;
- `rtn_pack_linear` -- a round-to-nearest packed head;
- `fuse_packed_stages` -- load-time stage fusion, without the TPU-only
  steps (no zero-padding of the upgate halves, no banded o-permutation
  operands), and `split_fused` its inverse for one field (WCT checkpoints
  carry the base checkpoint's linear names).

The port's dense tree fuses ``qkv`` and ``upgate`` (``models.llama.
init_params``); the pipeline quantizes their members one by one under
JAX's names (``q``, ``k``, ``v``, ``up``, ``gate``), and the fake tree it
returns carries those names, as JAX's does (`fuse_dense_stages` fuses it
for the model functions).  Block 0's input and the calibration forward of
a block are the family's `ModelApi` surfaces ``embed`` and
``calibration_block``: the llama family's run K3 on the GPU
(``ops.flash.flash_window_attention_any``), as JAX's run its flash kernel on
the TPU; OPT, Phi, Bloom and Falcon run their blocks
(`models.common.pipeline_block_forward`) with the plain attention, as JAX's
run XLA's.

A tree that lives on the card is quantized and packed there.  A tree held
in host memory (a model larger than the card, ``extract_outidx.
load_model_and_meta``) streams when the caller names the device the blocks
run on, as JAX streams its host trees and the reference moves blocks
between CPU and GPU: each block moves to that device (`_block_at`), is
forwarded, its Hessians built and its linears quantized there, and goes
back into host arrays allocated once; the calibration activations stay on
the device.  `reorder_model_host` permutes the host tree leaf by leaf, and
`pack_model` packs it block by block (`_to_host`, `_stack_host`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from qeft_tpu_torch.checkpoint import tree_map
from qeft_tpu_torch.models.api import get_model_api
from qeft_tpu_torch.models.registry import ModelMeta
from qeft_tpu_torch.ops.packing import QLinearParams, pack_layer
from qeft_tpu_torch.quant.gptq import ColumnLoops, LayerQuantResult, gptq_quantize, gram
from qeft_tpu_torch.quant.outliers import frob_norm_error, hessian_sort_ids, select_global_outliers
from qeft_tpu_torch.quant.quantizer import QuantSpec, find_params
from qeft_tpu_torch.quant.reorder import sparse_to_dense_ids


def _fuse_stage(layers: Dict, names: Sequence[str], fused_name: str) -> None:
    """Concatenate same-stage packed linears along N (every field carries N
    on its last axis); valid because they share one input permutation."""
    lins = [layers.pop(n) for n in names]
    if any(l.reorder_ids is not None for l in lins):
        # qeft_tpu/pipeline.py:861-864 asserts the same
        raise ValueError(
            f"stage fusion of {names} needs a statically reordered model (one shared input "
            "permutation); these linears carry their own reorder_ids, which cannot be fused: "
            "serve the tree unfused, or pack it with --reorder")

    def cat(field):
        parts = [getattr(l, field) for l in lins]
        return None if parts[0] is None else torch.cat(parts, dim=-1)

    layers[fused_name] = QLinearParams(
        qweight=cat("qweight"), scales=cat("scales"), scaled_zeros=cat("scaled_zeros"),
        oweight=cat("oweight"), bias=cat("bias"), group_size=lins[0].group_size,
    )


def fused_stages(meta: ModelMeta) -> Dict[str, Tuple[str, ...]]:
    """Fused stage name -> its members, in concatenation order, as
    ``qeft_tpu/pipeline.py::fuse_packed_stages`` fuses them: q/k/v only for
    the llama topology (llama, gemma), up/gate only where ffn1 has two
    members.  The OPT, Phi, Bloom and Falcon blocks read their linears by
    their own names and get nothing fused."""
    out = {}
    if meta.family in ("llama", "gemma") and len(meta.qkv) == 3:
        out["qkv"] = meta.qkv
    if len(meta.ffn1) == 2:
        out["upgate"] = meta.ffn1
    return out


def per_linear_reorder(params: Dict) -> bool:
    """Whether a packed tree's linears carry their own ``reorder_ids`` (it
    was packed without the global reorder, so its stages cannot fuse)."""
    return any(isinstance(l, QLinearParams) and l.reorder_ids is not None
               for l in params["layers"].values())


def fuse_packed_stages(params: Dict, meta: ModelMeta) -> Dict:
    """q/k/v -> ``qkv`` and up/gate -> ``upgate`` on a stacked packed model
    (see `fused_stages`); a model already fused, or of a family with nothing
    to fuse, passes through unchanged."""
    layers = dict(params["layers"])
    for fused, names in fused_stages(meta).items():
        if all(n in layers for n in names):
            _fuse_stage(layers, names, fused)
    return {**params, "layers": layers}


def member_widths(cfg, meta: ModelMeta) -> Dict[str, int]:
    """Output width N of each member of a fused stage (empty for a family
    with nothing to fuse)."""
    stages = fused_stages(meta)
    out = {}
    if "qkv" in stages:
        q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        out.update(zip(stages["qkv"], (q, kv, kv)))
    if "upgate" in stages:
        out.update(dict.fromkeys(stages["upgate"], cfg.intermediate_size))
    return out


def split_fused(tensors: Dict[str, torch.Tensor], meta: ModelMeta, widths: Dict[str, int],
                keep: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """Inverse of the N-concatenation of `_fuse_stage` for one field: every
    fused stage of ``tensors`` not named in ``keep`` is cut along its last
    axis into its members (``widths`` from `member_widths`)."""
    out = {}
    for name, t in tensors.items():
        names = fused_stages(meta).get(name)
        if names is None or name in keep:
            out[name] = t
            continue
        if t.shape[-1] != sum(widths[n] for n in names):
            raise ValueError(f"{name} is {t.shape[-1]} wide, its members "
                             f"{names} sum to {sum(widths[n] for n in names)}")
        out.update(zip(names, torch.split(t, [widths[n] for n in names], dim=-1)))
    return out


def fuse_tensors(tensors: Dict[str, torch.Tensor], meta: ModelMeta) -> Dict[str, torch.Tensor]:
    """Per-member tensors of one field concatenated into their fused stages
    along N, as `_fuse_stage` concatenates each field."""
    out = dict(tensors)
    for fused, names in fused_stages(meta).items():
        if all(n in out for n in names):
            out[fused] = torch.cat([out.pop(n) for n in names], dim=-1)
    return out


def fuse_dense_stages(params: Dict, meta: ModelMeta) -> Dict:
    """A dense tree with member names (a fake-quantized tree) fused along N
    into the ``qkv`` / ``upgate`` stages the model functions read."""
    return {**params, "layers": fuse_tensors(params["layers"], meta)}


# ---------------------------------------------------------------------------
# the quantization pipeline (llama family)


@dataclasses.dataclass
class QuantizeArgs:
    """The quantization options (``qeft_tpu/pipeline.py::QuantizeArgs``)."""

    spec: QuantSpec = QuantSpec(bits=4, sym=False, mse=True, group_size=128)
    target_rank: Optional[int] = 128
    target_bit: Optional[float] = None
    percdamp: float = 0.01
    act_order: bool = False
    no_frob_norm: bool = False
    reorder: bool = True
    rtn: bool = False  # nearest_owq
    true_sequential: bool = False
    nsamples: int = 128
    perhead: Optional[int] = None
    # OWQ weak columns only in these linears; the others take 0
    owq_layers: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass
class QuantizerState:
    """One linear's quantization metadata, carried into packing and fake
    checkpoints: group parameters [OC, G] in the reordered layout, the weak
    column ids [n_out] (ascending, original order) and, only under
    ``act_order``, the full quantization permutation the group parameters
    follow."""

    scale_group: torch.Tensor
    zero_group: torch.Tensor
    out_ids: torch.Tensor
    sym: bool
    bits: int
    group_size: int
    perm_ids: Optional[torch.Tensor] = None


_ALL_STAGES = ("qkv", "out", "ffn1", "ffn2")
_STAGE_CAP = {"qkv": "qkv_in", "out": "o_in", "ffn1": "ffn1_in", "ffn2": "ffn2_in"}


def _stage_of(meta: ModelMeta, name: str) -> str:
    for stage, names in zip(_ALL_STAGES, (meta.qkv, meta.out, meta.ffn1, meta.ffn2)):
        if name in names:
            return stage
    raise KeyError(name)


def _member_layers(params: Dict, cfg, meta: ModelMeta) -> Dict[str, torch.Tensor]:
    """The dense layers by member name: a fused ``qkv`` / ``upgate`` is cut
    into views of its members (no copy)."""
    return split_fused(params["layers"], meta, member_widths(cfg, meta))


def _block_layers(blk: Dict[str, torch.Tensor], meta: ModelMeta) -> Dict[str, torch.Tensor]:
    """One block (member names, ``[K, N]`` tensors) as the one-layer fused
    tree ``models.llama.llama_block`` reads."""
    one = {k: v[None] for k, v in blk.items()}
    return fuse_tensors(one, meta)


def _block_forward(blk, inps: torch.Tensor, cfg, meta: ModelMeta, stages=(),
                   outputs: bool = True):
    """The block over every calibration sample, one sample a call (the JAX
    ``scan``); -> (outputs [n, S, D] or None without ``outputs``, {stage:
    sum of x^T x} for ``stages``)."""
    n, s, _ = inps.shape
    block = get_model_api(meta.family).calibration_block(_block_layers(blk, meta), cfg, s,
                                                         inps.device)
    # a stage's Hessian is as wide as its linears' inputs ([K, N] member tensors)
    firsts = dict(zip(_ALL_STAGES, (meta.qkv[0], meta.out[0], meta.ffn1[0], meta.ffn2[0])))
    hs = {st: torch.zeros(blk[firsts[st]].shape[0], blk[firsts[st]].shape[0],
                          dtype=torch.float32, device=inps.device) for st in stages}
    outs = torch.empty_like(inps) if outputs else None
    with torch.no_grad():
        for i in range(n):
            cap = {} if stages else None
            y = block(inps[i: i + 1], cap)
            if outputs:
                outs[i] = y[0]
            for st in stages:
                a = cap[_STAGE_CAP[st]]
                hs[st] += gram(a.reshape(-1, a.shape[-1]))
    return outs, hs


def block_hessians(blk: Dict, inps: torch.Tensor, cfg, meta: ModelMeta,
                   stages: Sequence[str] = _ALL_STAGES):
    """One block over all calibration samples ``inps`` [n, S, D]: (outputs
    [n, S, D], {stage: H_sum}) with ``H_sum`` the sum of x^T x over the
    samples' tokens (the caller scales by 2 / nsamples); ``stages`` limits
    the Hessians built (extraction needs qkv and ffn1 only)."""
    return _block_forward(blk, inps, cfg, meta, tuple(stages))


def block_forward_batch(blk: Dict, inps: torch.Tensor, cfg, meta: ModelMeta) -> torch.Tensor:
    """A (quantized) block over all samples: its outputs [n, S, D]."""
    return _block_forward(blk, inps, cfg, meta)[0]


def _n_out_dict(layers: Dict, meta: ModelMeta, args: QuantizeArgs) -> Dict[str, int]:
    """Per-linear weak-column budget (``qeft_tpu/pipeline.py::_n_out_dict``)."""
    if args.owq_layers is not None:
        unknown = set(args.owq_layers) - set(meta.all_linears)
        if unknown:
            raise ValueError(f"unknown --layers {sorted(unknown)}; available: "
                             f"{list(meta.all_linears)}")
        selected = [l for l in meta.all_linears if l in args.owq_layers]
    else:
        selected = list(meta.all_linears)
    n_out = {l: 0 for l in meta.all_linears}
    if args.target_bit is not None:
        wbits = args.spec.bits
        r = (12 / (16 - wbits)) * (args.target_bit - wbits) / len(selected)
        for l in selected:
            n = round(layers[l].shape[-2] * r * meta.ratios[l])
            n_out[l] = n + 1 if n % 2 == 1 else n
    elif args.target_rank is not None:
        for l in selected:
            n_out[l] = args.target_rank
    return n_out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _placement(params: Dict, device) -> Tuple[torch.device, bool]:
    """-> (the device the blocks run on, whether they stream from the host).
    ``device=None``: where the tree lives.  A tree in host memory streams to
    the device the caller names (``"cpu"`` included: the branch then runs
    with host and device the same)."""
    home = params["embed"].device
    if device is None:
        return home, False
    device = torch.device(device)
    if home.type != "cpu" and home.type != device.type:
        raise ValueError(f"the tree lives on {home}: it streams only from the host, not to "
                         f"{device}")
    return device, home.type == "cpu"


def _block_at(layers: Dict, i: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Block ``i`` of a stacked layers tree on ``device``: views where the
    tree lives there, copies where it lives on the host."""
    return {k: v[i].to(device) for k, v in layers.items()}


def _to_host(tree):
    """A block's tensors and packed linears, or a quantizer state, in host
    memory."""
    if isinstance(tree, QuantizerState):
        return dataclasses.replace(tree, **{f: None if getattr(tree, f) is None
                                            else getattr(tree, f).cpu()
                                            for f in ("scale_group", "zero_group", "out_ids",
                                                      "perm_ids")})
    return tree_map(lambda t: t.cpu(), tree)


def _stack_host(blocks) -> Dict:
    """Per-block trees (tensors and packed linears) stacked ``[L, ...]``
    where they live."""
    return {k: (_stack_linears([b[k] for b in blocks])
                if isinstance(blocks[0][k], QLinearParams)
                else torch.stack([b[k] for b in blocks]))
            for k in blocks[0]}


def _top_at(params: Dict, device: torch.device) -> Dict:
    """The leaves outside the blocks that block 0's input needs (the
    embedding, OPT's positions and projection, Bloom's embedding norm) on
    ``device``."""
    return {k: v.to(device) for k, v in params.items() if k not in ("layers", "lm_head")}


def _block_done(kind: str, i: int, n_layers: int, tick: float, device: torch.device) -> None:
    """A block's line: its seconds and, on the card, its peak device memory
    (the peak statistic is reset at each block's start)."""
    _sync(device)
    line = f"{kind}: block {i + 1}/{n_layers} in {time.perf_counter() - tick:.2f} s"
    if device.type == "cuda":
        line += f", peak {torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB"
    print(line, flush=True)


def _block_start(device: torch.device) -> float:
    """On the card each block starts with the allocator's cache released:
    what the card holds beside the tree is one block's working set, not the
    fragments of every block before it."""
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    return time.perf_counter()


def extract_global_outidx(params: Dict, calib_tokens: np.ndarray, cfg, meta: ModelMeta,
                          args: QuantizeArgs, device=None) -> Tuple[np.ndarray, Dict]:
    """OGR step 1: the sorted global top-``target_rank`` channels (int32)
    and each qkv/ffn1 linear's own weak ids {(block, name): ids}.  Every
    linear of those stages adds ``diag(H) / mean`` of its Hessian diagonal
    (times its Frobenius error unless ``no_frob_norm``), so q/k/v count
    three times and up/gate twice, as in the JAX package.  ``device``: where
    the blocks run (`_placement`; a host tree streams there)."""
    target_rank = args.target_rank
    if args.perhead is not None:
        target_rank = args.perhead * cfg.num_heads
    device, _ = _placement(params, device)
    layers = _member_layers(params, cfg, meta)
    inps = get_model_api(meta.family).embed(
        _top_at(params, device), torch.as_tensor(calib_tokens, device=device), cfg)
    n_out = _n_out_dict(layers, meta, args)
    sensitivity = torch.zeros(cfg.hidden_size, dtype=torch.float32, device=device)
    per_layer = {}
    n_layers = cfg.num_layers
    for i in range(n_layers):
        tick = _block_start(device)
        blk = _block_at(layers, i, device)
        outs, h_sums = block_hessians(blk, inps, cfg, meta, stages=("qkv", "ffn1"))
        for stage, names in (("qkv", meta.qkv), ("ffn1", meta.ffn1)):
            h_diag_base = torch.diagonal(h_sums[stage]) * (2.0 / args.nsamples)
            for name in names:
                h_diag = h_diag_base
                if not args.no_frob_norm:
                    h_diag = h_diag * frob_norm_error(blk[name].t(), args.spec, num=30)
                _, out_ids = hessian_sort_ids(h_diag, n_out[name])
                per_layer[(i, name)] = out_ids.cpu().numpy()
                sensitivity = sensitivity + h_diag / torch.mean(h_diag)
        inps = outs
        del blk, outs, h_sums
        _block_done("extract", i, n_layers, tick, device)
    outidx = select_global_outliers(sensitivity, target_rank)
    return outidx.cpu().numpy().astype(np.int32), per_layer


def quantize_model(params: Dict, calib_tokens: np.ndarray, cfg, meta: ModelMeta,
                   args: QuantizeArgs, outidx: Optional[np.ndarray] = None,
                   device=None) -> Tuple[Dict, Dict]:
    """Layerwise GPTQ-OWQ of every block -> (fake tree, {(block, name):
    QuantizerState}).

    ``params`` is a dense tree, fused or with member names; it is not
    changed.  The fake tree has member names and the model's dtype, and
    lives where ``params`` does (a streamed tree's blocks and states come
    back into host arrays allocated once); with ``args.reorder`` it is
    globally reordered (`reorder_model`, `reorder_model_host`) and each
    block carries ``o_reorder``, the o-projection's input gather.
    ``device``: where the blocks run (`_placement`).  On the card the GPTQ
    column blocks replay programs captured once per linear shape and kept
    for the whole model (`gptq.ColumnLoops`)."""
    if args.reorder and outidx is None:
        raise ValueError("the global reorder needs the extracted outidx "
                         "(run extract_global_outidx first)")
    spec = args.spec
    device, streamed = _placement(params, device)
    layers = _member_layers(params, cfg, meta)
    inps = get_model_api(meta.family).embed(
        _top_at(params, device), torch.as_tensor(calib_tokens, device=device), cfg)
    n_out = _n_out_dict(layers, meta, args)
    global_out = None if outidx is None else torch.as_tensor(
        np.asarray(outidx), dtype=torch.int32, device=device)
    # the MSE grid of a group re-fit: 40 points in the GPTQ loop, 1 in the
    # nearest-rounding loop, 100 for one whole-row group
    num_groups = 1 if args.rtn else (100 if spec.group_size <= 0 else 40)
    # true_sequential: each stage's Hessian from the block with its earlier
    # stages already quantized
    stage_order = ([(meta.qkv, ("qkv",)), (meta.out, ("out",)), (meta.ffn1, ("ffn1",)),
                    (meta.ffn2, ("ffn2",))] if args.true_sequential
                   else [(meta.all_linears, _ALL_STAGES)])
    # the outputs where the tree lives: on the host for a streamed tree
    out_layers = {k: (torch.empty_like(v, memory_format=torch.contiguous_format)
                      if k in meta.all_linears else v.clone())
                  for k, v in layers.items() if k != "o_reorder"}
    quantizers: Dict = {}
    loops = ColumnLoops()  # the GPTQ column programs, one per linear shape
    for i in range(cfg.num_layers):
        tick = _block_start(device)
        blk = _block_at({k: v for k, v in layers.items() if k != "o_reorder"}, i, device)
        new_blk = dict(blk)
        h_sums = None
        for names, stages in stage_order:
            if args.true_sequential or h_sums is None:
                _, h_sums = _block_forward(new_blk, inps, cfg, meta, stages, outputs=False)
            for name in names:
                _quantize_one(name, blk, new_blk, h_sums, quantizers, i, meta, args,
                              global_out, n_out, num_groups, loops)
        del h_sums
        inps = block_forward_batch(new_blk, inps, cfg, meta)
        for name in meta.all_linears:
            out_layers[name][i] = new_blk[name]
            if streamed:
                quantizers[(i, name)] = _to_host(quantizers[(i, name)])
        del blk, new_blk
        _block_done("quantize", i, cfg.num_layers, tick, device)
    del loops
    new_params = {**params, "layers": out_layers}
    if args.reorder:
        reorder = reorder_model_host if streamed else reorder_model
        new_params = reorder(new_params, quantizers, global_out, cfg, meta)
    return new_params, quantizers


def _quantize_one(name, blk, new_blk, h_sums, quantizers, i, meta, args, global_out, n_out,
                  num_groups, loops) -> None:
    """GPTQ of linear ``name`` of block ``i``: its fake weight into
    ``new_blk``, its state into ``quantizers``."""
    spec = args.spec
    h = h_sums[_stage_of(meta, name)] * (2.0 / args.nsamples)
    w_nk = blk[name].t().to(torch.float32)  # [OC, IC]
    is_global = args.reorder and name in meta.qkv + meta.ffn1
    # the Frobenius weighting: under the reorder only for the per-layer stages
    use_frob = not args.no_frob_norm and not is_global
    frob = frob_norm_error(w_nk, spec, num=40) if use_frob else None
    ids, out_ids = hessian_sort_ids(torch.diagonal(h), n_out[name], frob_norm=frob,
                                    outidx=global_out if is_global else None,
                                    actorder=args.act_order)
    res: LayerQuantResult = gptq_quantize(w_nk, h, spec, ids, out_ids, percdamp=args.percdamp,
                                          num=num_groups, rtn=args.rtn, loops=loops)
    new_blk[name] = res.w_fake.t().to(blk[name].dtype)
    quantizers[(i, name)] = QuantizerState(
        scale_group=res.scale_group, zero_group=res.zero_group, out_ids=res.out_ids,
        sym=spec.sym, bits=spec.bits, group_size=spec.group_size,
        perm_ids=ids.to(torch.int32) if args.act_order else None)


def _permute_state_rows(quantizers: Dict, key, ids: torch.Tensor) -> None:
    st: QuantizerState = quantizers[key]
    quantizers[key] = QuantizerState(
        scale_group=st.scale_group[ids], zero_group=st.zero_group[ids], out_ids=st.out_ids,
        sym=st.sym, bits=st.bits, group_size=st.group_size)


def reorder_model(params: Dict, quantizers: Dict, global_out: torch.Tensor, cfg,
                  meta: ModelMeta) -> Dict:
    """OGR step 2: permute the model so the weak channels come last
    (``qeft_tpu/pipeline.py::reorder_model``).

    The residual stream (embedding columns, OPT's learned positions, norms
    and their biases, Bloom's embedding LayerNorm, lm_head rows, qkv/ffn1
    input rows, o/ffn2 output columns and biases) by the global dense ids;
    the MLP's inner dim (ffn1 output columns and biases, ffn2 input rows)
    by ffn2's own ids; the o-projection's input rows by o's own ids, whose
    gather (``o_reorder``) the model applies at run time.  The group
    parameters of each permuted output dimension follow it.  A norm a block
    lacks (Falcon-7b's ``mlp_ln``) is skipped; a tree whose stream passes
    through ``project_in`` (opt-350m) raises, as in the JAX package.  The
    layer tensors of ``params`` are permuted in place, one ``[K, N]``
    temporary at a time (one copy of the model on the device); the returned
    tree holds them."""
    if "project_in" in params:
        raise ValueError(
            "global reorder is not supported for models whose residual stream passes through "
            "embedding projections (opt-350m project_in/out): the token-embedding space and "
            "the hidden stream have different widths.  Quantize without --reorder (per-linear "
            "outlier path).")
    d = cfg.hidden_size
    device = params["embed"].device
    g_ids = sparse_to_dense_ids(torch.as_tensor(global_out, device=device), d).long()
    new = dict(params)
    new["embed"] = params["embed"][:, g_ids]
    new["lm_head"] = params["lm_head"][g_ids]
    if "embed_pos" in params:
        new["embed_pos"] = params["embed_pos"][:, g_ids]
    for key in ("final_ln", "final_ln_b", "embed_ln", "embed_ln_b"):
        if key in params:
            new[key] = params[key][g_ids]
    layers = {k: v for k, v in params["layers"].items() if k != "o_reorder"}
    (o_name,) = meta.out
    (f2_name,) = meta.ffn2
    hd = layers[o_name].shape[-2]
    o_reorder = torch.empty(cfg.num_layers, hd, dtype=torch.int32, device=device)

    def permute(name, i, ids):  # a per-layer vector, if the block has it
        if name in layers:
            layers[name][i] = layers[name][i][ids]

    for i in range(cfg.num_layers):
        for name in meta.qkv + meta.ffn1:
            layers[name][i] = layers[name][i][g_ids]
        for ln in meta.ln:
            permute(ln, i, g_ids)
            permute(ln + "_b", i, g_ids)
        o_ids = sparse_to_dense_ids(quantizers[(i, o_name)].out_ids, hd).long()
        layers[o_name][i] = layers[o_name][i][o_ids][:, g_ids]
        permute(o_name + "_b", i, g_ids)
        o_reorder[i] = o_ids
        _permute_state_rows(quantizers, (i, o_name), g_ids)
        f_ids = sparse_to_dense_ids(quantizers[(i, f2_name)].out_ids,
                                    layers[f2_name].shape[-2]).long()
        for name in meta.ffn1:
            layers[name][i] = layers[name][i][:, f_ids]
            permute(name + "_b", i, f_ids)
            _permute_state_rows(quantizers, (i, name), f_ids)
        layers[f2_name][i] = layers[f2_name][i][f_ids][:, g_ids]
        permute(f2_name + "_b", i, g_ids)
        _permute_state_rows(quantizers, (i, f2_name), g_ids)
    layers["o_reorder"] = o_reorder
    new["layers"] = layers
    return new


def reorder_model_host(params: Dict, quantizers: Dict, global_out, cfg,
                       meta: ModelMeta) -> Dict:
    """OGR step 2 on a tree held in host memory (``qeft_tpu/pipeline.py::
    reorder_model_host``): `reorder_model`'s permutations, which already go
    leaf by leaf and block by block in place (one ``[K, N]`` temporary at a
    time), run where the tree lives; the quantizer states are on the host
    too, as a streamed `quantize_model` leaves them."""
    if params["embed"].device.type != "cpu":
        raise ValueError(f"reorder_model_host: the tree lives on {params['embed'].device}; "
                         "use reorder_model")
    return reorder_model(params, quantizers, torch.as_tensor(np.asarray(
        global_out.cpu() if isinstance(global_out, torch.Tensor) else global_out)), cfg, meta)


# ---------------------------------------------------------------------------
# packing


def rtn_pack_linear(w_kn: torch.Tensor, bits: int = 4, group_size: int = 128,
                    dtype=torch.bfloat16) -> QLinearParams:
    """A dense ``[K, N]`` linear round-to-nearest quantized (per-group
    min-max, no weak columns, no Hessian) and packed: the lm_head under
    ``QEFT_QUANT_LMHEAD`` (``qeft_tpu/pipeline.py::rtn_pack_linear``)."""
    k, n = w_kn.shape
    g = group_size if group_size > 0 else k
    if k % g:
        raise ValueError(f"K={k} is not a multiple of the group size {g}")
    n_groups = k // g
    spec = QuantSpec(bits=bits, sym=False, mse=False, group_size=g)
    rows = w_kn.reshape(n_groups, g, n).permute(2, 0, 1).reshape(n * n_groups, g)
    qp = find_params(rows.to(torch.float32), spec)
    return pack_layer(w_kn, qp.scale.reshape(n, n_groups), qp.zero.reshape(n, n_groups),
                      n_outlier=0, group_size=g, sym=False, bits=bits, dtype=dtype)


def _stack_linears(lins) -> QLinearParams:
    def stack(field):
        parts = [getattr(l, field) for l in lins]
        return None if parts[0] is None else torch.stack(parts)

    return QLinearParams(
        qweight=stack("qweight"), scales=stack("scales"), scaled_zeros=stack("scaled_zeros"),
        oweight=stack("oweight"), bias=stack("bias"), reorder_ids=stack("reorder_ids"),
        group_size=lins[0].group_size)


def pack_model(params: Dict, quantizers: Dict, cfg, meta: ModelMeta, dtype=torch.bfloat16,
               fuse_stages: bool = False, device=None) -> Dict:
    """Every quantized linear of a fake tree swapped for its packed form,
    stacked ``[L, ...]``, bit for bit as ``qeft_tpu/pipeline.py::
    pack_model``; float leaves cast to ``dtype``.

    A reordered tree (``o_reorder`` present) has every linear's weak rows
    last already.  Without the reorder each linear's rows are put in its
    own outliers-last order and it keeps the input gather as
    ``reorder_ids``.  ``fuse_stages``: q/k/v -> ``qkv`` and up/gate ->
    ``upgate`` where `fused_stages` names them (needs the reorder; a family
    with nothing to fuse raises, as in the JAX package).  ``device``: where
    the packing runs (`_placement`): a tree in host memory is packed there
    block by block and the packed blocks come back to the host."""

    def cast_float(v):
        return v.to(dtype) if v.is_floating_point() else v

    device, streamed = _placement(params, device)
    new = {k: cast_float(v) for k, v in params.items() if k != "layers"}
    layers = params["layers"]
    reordered = "o_reorder" in layers
    if fuse_stages and not fused_stages(meta):
        raise ValueError(f"fuse_stages: family {meta.family!r} has no fusable stages (its qkv "
                         "is already a single linear and its ffn1 is unary)")
    if fuse_stages and not reordered:
        raise ValueError("stage fusion needs a statically reordered model (shared input "
                         "permutation); per-linear input gathers cannot be fused")
    blocks = []
    for i in range(cfg.num_layers):
        blk = _block_at(layers, i, device)
        nb = {k: cast_float(v) for k, v in blk.items() if k not in meta.all_linears}
        for name in meta.all_linears:
            st: QuantizerState = quantizers[(i, name)]
            w_kn = blk[name]
            k_in = w_kn.shape[0]
            group = st.group_size if st.group_size > 0 else k_in
            reorder_ids = None
            if st.perm_ids is not None:
                if reordered:
                    raise ValueError(
                        "--act_order quantization cannot be packed with the static global "
                        "reorder: its group parameters follow each linear's own permutation; "
                        "pack without --reorder or quantize without --act_order")
                reorder_ids = st.perm_ids.to(device=device, dtype=torch.int32)
            elif not reordered and st.out_ids.shape[0] > 0:
                reorder_ids = sparse_to_dense_ids(st.out_ids.to(device), k_in)
            if reorder_ids is not None:
                w_kn = w_kn[reorder_ids.long()]
            lin = pack_layer(w_kn, st.scale_group.to(device), st.zero_group.to(device),
                             n_outlier=int(st.out_ids.shape[0]), group_size=group, sym=st.sym,
                             bits=st.bits, dtype=dtype)
            lin.reorder_ids = reorder_ids
            nb[name] = lin
        if fuse_stages:
            for fused, names in fused_stages(meta).items():
                _fuse_stage(nb, names, fused)
        blocks.append(_to_host(nb) if streamed else nb)
    new["layers"] = _stack_host(blocks)
    return new
