"""A device mesh over ``torch.distributed``, its collectives, and the table of
which parameter and cache leaf shards on which mesh axis.  Counterpart of
``qeft_tpu/parallel/mesh.py``.

JAX drives every device of a mesh from one process through ``shard_map``.
Here the model is SPMD, as in Megatron inference: one process (a rank) per
mesh position, each calling the same function on its own shard, the outputs
coming back replicated.  A `Mesh` names the axes (``dp``, ``tp``, ``pp``,
``sp``), lays the world's ranks out on them row-major (the last axis
fastest, as ``np.reshape`` lays out JAX's device array), holds one process
group per axis line through this rank, and gives the collectives the names
the JAX code uses: `Mesh.psum`, `Mesh.pmax`, `Mesh.all_gather` (tiled) and
`Mesh.ppermute` (a ring step through ``batch_isend_irecv``).

Backends, by where the ranks run:

- on the CPU: Gloo;
- one rank per card: NCCL;
- ranks that share a card: Gloo, with every CUDA tensor copied through a
  pinned host buffer inside the collectives above (NCCL refuses two ranks
  on one device).  Such collectives cross host memory: their time says
  nothing of a multi-card deployment's.

The backend is chosen from that rule, never switched after a failure; asking
for NCCL where ranks share a card raises.  Rank ``r`` runs on
``cuda:(r % device_count)``.

`param_shardings` and `cache_shardings` return the JAX package's tables
(one spec, a tuple of axis names or None per dimension, for each leaf), and
`shard_tree` / `shard_params` apply one by slicing out this rank's part,
byte for byte the device shard a ``NamedSharding`` gives.  JAX's GSPMD
path, which runs such a tree under ``jit``, has no counterpart: the
explicit layouts of `tp_forward`, `pp`, `tp_pp` and `sp` run the model.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from qeft_tpu_torch.models.registry import ModelMeta
from qeft_tpu_torch.ops.packing import QLinearParams

Spec = Tuple[Optional[str], ...]  # an axis name (or None) per dimension

_QFIELDS = ("qweight", "scales", "scaled_zeros", "oweight", "bias", "reorder_ids")


@dataclasses.dataclass
class Mesh:
    """This rank's place in a mesh of ``shape`` (axis name -> size, in
    order) and one process group per axis.  Without groups (a world of one,
    or a mesh made only to lay out shards) every collective over an axis of
    size 1 is the identity and any other raises."""

    shape: Dict[str, int]
    rank: int = 0
    device: torch.device = torch.device("cpu")
    groups: Dict[str, object] = dataclasses.field(default_factory=dict)
    staged: bool = False  # CUDA tensors cross through pinned host buffers (Gloo)
    backend: str = "gloo"

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Mesh coordinates of ``rank`` (default: this one), row-major."""
        rank = self.rank if rank is None else rank
        out = {}
        for name in reversed(self.axis_names):
            out[name] = rank % self.shape[name]
            rank //= self.shape[name]
        return {name: out[name] for name in self.axis_names}

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 for an axis the mesh lacks,
        as ``lax.axis_index`` of an absent axis would be meaningless)."""
        return self.coords().get(axis, 0)

    def rank_at(self, **coords) -> int:
        """Global rank at this rank's coordinates with ``coords`` replaced."""
        c = {**self.coords(), **coords}
        rank = 0
        for name in self.axis_names:
            rank = rank * self.shape[name] + c[name]
        return rank

    def check(self, t: torch.Tensor, what: str = "the model") -> None:
        """Raise unless ``t`` lives on this mesh's device type: a mesh made
        for the card never runs the CPU's plain versions."""
        from qeft_tpu_torch.device import check_on

        check_on(t, self.device, what)

    def _group(self, axis: str):
        if axis not in self.groups:
            raise RuntimeError(f"mesh axis {axis!r} of size {self.shape[axis]} has no process "
                               "group: make the mesh with make_mesh on initialized ranks")
        return self.groups[axis]

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of ``t`` a collective may write: in pinned host memory when
        the collectives are staged."""
        if self.staged and t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return buf.copy_(t)
        return t.contiguous().clone()

    def _back(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return t.to(like.device) if t.device != like.device else t

    def psum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of ``t`` over ``axis``, replicated on it, in ``t``'s dtype
        (bf16 partial sums are rounded before the sum, as JAX's psum of bf16
        values rounds them).  One all-gather and the parts added in
        coordinate order on every rank, so every rank holds the same bits;
        a gather is one ring pass where an all-reduce is two, which halves
        the latency of the small reductions of a decode step."""
        return self._fold(t, axis, torch.add)

    def pmax(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        return self._fold(t, axis, torch.maximum)

    def _fold(self, t, axis, op):
        if self.shape.get(axis, 1) == 1:
            return t
        parts = self._gather(t, axis)
        out = parts[0]
        for part in parts[1:]:
            out = op(out, part)
        return self._back(out, t)

    def _gather(self, t, axis):
        buf = self._out(t)
        parts = [torch.empty_like(buf) for _ in range(self.shape[axis])]
        dist.all_gather(parts, buf, group=self._group(axis))
        return parts

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = -1) -> torch.Tensor:
        """The ``axis`` shards of ``t`` concatenated along ``dim`` in
        coordinate order (``lax.all_gather(..., tiled=True)``)."""
        if self.shape.get(axis, 1) == 1:
            return t
        return self._back(torch.cat(self._gather(t, axis), dim=dim), t)

    def ppermute(self, t: torch.Tensor, axis: str, shift: int = 1) -> torch.Tensor:
        """One ring step along ``axis``: this rank sends ``t`` to coordinate
        ``i + shift`` and returns what coordinate ``i - shift`` sent."""
        n = self.shape.get(axis, 1)
        if n == 1:
            return t
        i = self.index(axis)
        buf = self._out(t)
        recv = torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, buf, self.rank_at(**{axis: (i + shift) % n})),
               dist.P2POp(dist.irecv, recv, self.rank_at(**{axis: (i - shift) % n}))]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return self._back(recv, t)


def _shares_cards(world: int) -> bool:
    """Whether ranks of this host share a card: more local ranks than cards
    (``LOCAL_WORLD_SIZE`` under torchrun, else the whole world)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return local > torch.cuda.device_count()


def choose_backend(device: torch.device, world: int, backend: Optional[str] = None) -> str:
    """The backend rule of the module docstring; raises for NCCL where ranks
    share a card or run on the CPU."""
    shared = device.type == "cuda" and _shares_cards(world)
    if backend is None:
        return "nccl" if device.type == "cuda" and not shared else "gloo"
    if backend == "nccl" and (device.type != "cuda" or shared):
        raise ValueError("NCCL needs one rank per card: "
                         + ("ranks share a card" if shared else f"ranks run on {device}")
                         + "; use Gloo")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def rank_device(device, rank: int) -> torch.device:
    """``cuda:(rank % device_count)`` for a CUDA mesh, the CPU for a CPU one;
    ``None`` means the GPU, which must exist (`device.resolve_device`)."""
    from qeft_tpu_torch.device import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            resolve_device(None)  # raises, naming device='cpu'
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def _axis_lines(shape: Sequence[int], axis: int):
    """Rank lists of every line along ``axis`` of a row-major mesh, in a
    fixed order (every rank must create the same groups in the same order)."""
    others = [range(s) if i != axis else [0] for i, s in enumerate(shape)]
    lines = []
    for base in itertools.product(*others):
        line = []
        for j in range(shape[axis]):
            c = list(base)
            c[axis] = j
            r = 0
            for ci, s in zip(c, shape):
                r = r * s + ci
            line.append(r)
        lines.append(line)
    return lines


def make_mesh(shape=None, axis_names=("dp", "tp"), backend: Optional[str] = None,
              device=None) -> Mesh:
    """The mesh of ``shape`` over the world process group (``launch_ranks``,
    ``init_distributed`` or torchrun made it), with one subgroup per axis;
    ``shape`` defaults to (1, world).  ``device`` None means the GPU (which
    must exist; ``"cpu"`` runs the plain versions); this rank's device is
    ``cuda:(rank % device_count)``.  A world of one needs no process group."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if shape is None:
        shape = (1, world)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} does not name its axes {axis_names}")
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs {n} ranks, the world has "
                         f"{world}")
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = choose_backend(dev, world, backend)
    staged = dev.type == "cuda" and backend == "gloo"
    mesh = Mesh(dict(zip(axis_names, shape)), rank=rank, device=dev, staged=staged,
                backend=backend)
    if world > 1:
        for i, name in enumerate(axis_names):
            if shape[i] == 1:
                continue
            for line in _axis_lines(shape, i):
                group = dist.new_group(line, backend=backend)
                if rank in line:
                    mesh.groups[name] = group
    if staged and rank == 0:
        print(f"[mesh] {world} ranks share {torch.cuda.device_count()} card(s): collectives run "
              "over Gloo through pinned host buffers (host-staged; not a multi-card speed)",
              flush=True)
    return mesh


# ---------------------------------------------------------------------------
# the sharding tables


def _linear_spec(field: str, shard_n: bool) -> Spec:
    """Spec of one stacked QLinearParams field (leading L axis)."""
    if field == "qweight":
        return (None, None, "tp") if shard_n else (None, "tp", None)
    if field in ("scales", "scaled_zeros"):
        # row-parallel: the group count (86 for the 7B down) rarely divides
        # tp -- replicated; scales are about 1/32 of the int4 bytes
        return (None, None, "tp") if shard_n else (None, None, None)
    if field == "oweight":
        return (None, None, "tp")
    if field == "reorder_ids":
        return (None, None)
    return (None, "tp") if shard_n else (None, None)  # bias


def param_shardings(params: Dict, mesh: Mesh, meta: ModelMeta) -> Dict:
    """The spec tree of ``params`` (packed or dense, stacked), the JAX
    package's table: column-parallel linears (qkv- and ffn1-like, the fused
    ``qkv``/``upgate`` included) shard N over ``tp``, row-parallel ones K;
    the head shards the vocabulary; everything else is replicated."""
    col = set(meta.qkv + meta.ffn1) | {"qkv", "upgate"}
    row = set(meta.out + meta.ffn2)

    def rep(t):
        return (None,) * t.dim()

    def layer_spec(name, leaf):
        if name in col or name in row:
            shard_n = name in col
            if isinstance(leaf, QLinearParams):
                return QLinearParams(**{f: None if getattr(leaf, f) is None
                                        else _linear_spec(f, shard_n) for f in _QFIELDS},
                                     group_size=leaf.group_size)
            return (None, None, "tp") if shard_n else (None, "tp", None)
        return rep(leaf)

    out = {}
    for top, v in params.items():
        if top == "layers":
            out[top] = {name: layer_spec(name, leaf) for name, leaf in v.items()}
        elif top == "lm_head":
            out[top] = (None, "tp")
        else:
            out[top] = rep(v)
    return out


def cache_shardings(mesh: Mesh, batch: int = 0, n_kv_heads: int = 0,
                    quantized: bool = False) -> Dict[str, Spec]:
    """Specs of the head-major cache [L, B, H_kv, S, Dh]: batch over ``dp``,
    kv heads over ``tp``; an axis that does not divide falls back to
    replication.  ``quantized`` adds the int8 cache's scale planes [L, B,
    H_kv, S]."""
    dp = "dp" if batch and batch % mesh.shape.get("dp", 1) == 0 else None
    tp = "tp" if n_kv_heads and n_kv_heads % mesh.shape.get("tp", 1) == 0 else None
    out = {"k": (None, dp, tp, None, None), "v": (None, dp, tp, None, None)}
    if quantized:
        out["k_scale"] = out["v_scale"] = (None, dp, tp, None)
    return out


def shard_leaf(t: Optional[torch.Tensor], spec: Spec, mesh: Mesh) -> Optional[torch.Tensor]:
    """This rank's block of ``t`` under ``spec`` (contiguous; ``t`` itself
    where nothing is sharded)."""
    if t is None:
        return None
    if len(spec) > t.dim():
        raise ValueError(f"spec {spec} has more dimensions than {tuple(t.shape)}")
    out = t
    for dim, axis in enumerate(spec):
        if axis is None or mesh.shape.get(axis, 1) == 1:
            continue
        n = mesh.shape[axis]
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not divide over "
                             f"{axis}={n}")
        w = t.shape[dim] // n
        out = out.narrow(dim, mesh.index(axis) * w, w)
    return out if out is t else out.contiguous()


def shard_tree(tree, specs, mesh: Mesh):
    """Apply a spec tree (`param_shardings`, `cache_shardings`,
    `pp.pp_shardings`) to a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, QLinearParams):
        return QLinearParams(**{f: shard_leaf(getattr(tree, f), getattr(specs, f), mesh)
                                for f in _QFIELDS}, group_size=tree.group_size)
    return shard_leaf(tree, specs, mesh)


def shard_params(params: Dict, mesh: Mesh, meta: ModelMeta) -> Dict:
    return shard_tree(params, param_shardings(params, mesh, meta), mesh)
