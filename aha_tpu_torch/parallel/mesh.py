"""Device mesh and sharding layer (counterpart of aha_tpu/parallel/mesh.py).

The JAX package builds a `jax.sharding.Mesh` and lets GSPMD place every
tensor by `PartitionRule`s; one program runs over all devices.  Here a
mesh is a dp × tp grid of `torch.device`s plus this process's place in it
and, for tp > 1, its process group: each rank of the tp axis is a process
of its own (parallel/ranks.py starts them), holds only its slice of each
tensor (`shard_params`) and runs the sharded layers (parallel/layers.py),
whose collectives go through `Mesh.all_reduce` / `Mesh.broadcast`.  The dp
axis is replicas in one process (parallel/replicas.py), with no
collectives at all.

Axis conventions, as in the JAX package:
    "dp" — data / batch axis (the continuous-batching slots; params
           replicated)
    "tp" — tensor / model axis (attention heads, MLP hidden, vocab)

The backend follows the device: NCCL for cuda, one rank a card; gloo on
the CPU.  A caller may ask for gloo over cuda devices, several ranks on
one card (`devices=[cuda:0, cuda:0], backend="gloo"`): gloo takes only
`all_reduce` and `broadcast` on CUDA tensors, which is all the sharded
layers use.  NCCL refuses two ranks on one card, so `make_mesh` does too.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape.  Defaults to everything on one device."""

    dp: int = 1
    tp: int = 1

    @property
    def n_devices(self) -> int:
        return self.dp * self.tp


class Mesh:
    """A dp × tp grid of devices (`devices[i][j]` the device of dp index i,
    tp index j), the flat rank of this process in it (i·tp + j), the
    backend of its collectives and, once `join`ed, its process group."""

    def __init__(self, devices: Sequence[Sequence[torch.device]],
                 rank: int = 0, backend: str = "gloo", group=None):
        self.devices = [list(row) for row in devices]
        self.rank = rank
        self.backend = backend
        self.group = group

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": len(self.devices), "tp": len(self.devices[0])}

    @property
    def tp(self) -> int:
        return self.shape["tp"]

    @property
    def dp(self) -> int:
        return self.shape["dp"]

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    def index(self, axis: str) -> int:
        return self.tp_rank if axis == "tp" else self.dp_rank

    @property
    def device(self) -> torch.device:
        return self.devices[self.dp_rank][self.tp_rank]

    def at(self, rank: int) -> "Mesh":
        """The same grid seen from another rank (no process group)."""
        return Mesh(self.devices, rank, self.backend)

    def join(self, init_method: str, timeout: float = 300.0) -> "Mesh":
        """Join the tp process group of this rank's row: every rank calls
        it with the same `init_method` (a file:// store); it returns once
        all tp ranks have joined.  `timeout` (seconds) bounds the join and
        every collective of the group: a rank may build the kernels
        (tens of seconds) while the others wait in its first collective."""
        import datetime

        import torch.distributed as dist

        if self.dp != 1:
            raise ValueError("a process group spans one tp row; dp "
                             "replicas share no group")
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        dist.init_process_group(
            self.backend, init_method=init_method, rank=self.rank,
            world_size=self.tp, timeout=datetime.timedelta(seconds=timeout))
        self.group = dist.group.WORLD
        return self

    def leave(self) -> None:
        import torch.distributed as dist

        if self.group is not None and dist.is_initialized():
            dist.destroy_process_group()
        self.group = None

    # -- collectives (tp axis) ---------------------------------------------

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the tp ranks, in place; returns it."""
        import torch.distributed as dist

        dist.all_reduce(t, group=self.group)
        COLLECTIVES["all_reduce"] += 1
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s `t` on every tp rank, in place; returns it."""
        import torch.distributed as dist

        dist.broadcast(t, src, group=self.group)
        COLLECTIVES["broadcast"] += 1
        return t


#: collectives this process has issued, by kind
COLLECTIVES = {"all_reduce": 0, "broadcast": 0}


def make_mesh(cfg: MeshConfig | None = None,
              devices: Optional[Sequence[torch.device | str]] = None,
              backend: str | None = None, rank: int = 0) -> Mesh:
    """A mesh over the given devices, the first dp·tp of them in order,
    seen from `rank`; by default one card a rank or replica
    (utils/device.mesh_devices: the CPU where AHA_DEVICE=cpu asks for it).
    The backend defaults to the devices' own: NCCL for cuda, gloo for the
    CPU; NCCL over a card listed twice is refused, as NCCL refuses it."""
    from aha_tpu_torch.utils.device import mesh_devices

    cfg = cfg or MeshConfig()
    devices = [torch.device(d) for d in (
        devices if devices is not None else mesh_devices(cfg.tp, cfg.dp))]
    if cfg.n_devices > len(devices):
        raise ValueError(
            f"mesh {cfg} needs {cfg.n_devices} devices, have {len(devices)}")
    devices = devices[:cfg.n_devices]
    kinds = {d.type for d in devices}
    if len(kinds) != 1:
        raise ValueError(f"a mesh spans one kind of device, got {kinds}")
    if backend is None:
        backend = "nccl" if kinds == {"cuda"} else "gloo"
    if backend == "nccl":
        if kinds != {"cuda"}:
            raise ValueError("NCCL runs on cuda devices only")
        if cfg.tp > 1 and len({str(d) for d in devices}) < len(devices):
            raise ValueError("NCCL takes one card a rank: a card listed "
                             "twice needs backend='gloo'")
    grid = [devices[i * cfg.tp:(i + 1) * cfg.tp] for i in range(cfg.dp)]
    return Mesh(grid, rank, backend)


# ---------------------------------------------------------------------------
# Partition rules: regex on a parameter's dotted path → a spec, one mesh
# axis name (or None) per dimension
# ---------------------------------------------------------------------------

PartitionRule = tuple[str, tuple[Any, ...]]


def spec_for(path: str, rules: Sequence[PartitionRule]) -> tuple:
    """The first rule whose pattern is found in `path` gives the spec;
    none: () — replicated."""
    for pattern, spec in rules:
        if re.search(pattern, path):
            return tuple(spec)
    return ()


def spec_axis(entry) -> tuple[Any, int]:
    """(mesh axis, chunks) of one entry of a spec: an axis name (or None),
    or (name, chunks) — the dimension is `chunks` equal blocks side by
    side (a fused [gate | up]), each block split over the axis and a
    rank's parts of the blocks kept side by side (GLM-OCR's gate_up)."""
    return entry if isinstance(entry, tuple) else (entry, 1)


def placed_spec(shape: Sequence[int], spec: tuple, mesh: Mesh) -> tuple:
    """`spec` as it places a tensor of `shape`: truncated to its rank (a
    rule written for a 5-D cache applied to the flat 4-D layout), and an
    axis that does not divide its dimension (each of its blocks')
    replicated, as the JAX shard_params does (a model's check refuses
    such a tp where its ranks need equal slices: check_text_tp)."""
    fixed = []
    for size, entry in zip(shape, spec[:len(shape)]):
        axis, chunks = spec_axis(entry)
        fixed.append(None if axis is not None
                     and size % (mesh.shape[axis] * chunks) else entry)
    return tuple(fixed)


def check_divides(tp: int, sizes: dict[str, int]) -> None:
    """Refuse a tp that does not divide each named dimension of `sizes`,
    naming the first that it does not divide.  The JAX shard_params
    replicates such a tensor and lets GSPMD reconcile the rest; the port's
    per-rank layers need an equal slice of each on every rank."""
    if tp <= 1:
        return
    for name, size in sizes.items():
        if size % tp:
            raise ValueError(f"--tp {tp} does not divide {name} ({size}): "
                             "each rank holds an equal slice of it")


def text_dims(config) -> dict[str, int]:
    """The dimensions a decoder's ranks split: kv heads, heads, MLP
    columns and vocab rows (a Qwen3Config's or a LlamaConfig's fields)."""
    return {"num_key_value_heads": config.num_key_value_heads,
            "num_attention_heads": config.num_attention_heads,
            "intermediate_size": config.intermediate_size,
            "vocab_size": config.vocab_size}


def check_text_tp(config, tp: int) -> None:
    """Refuse, before a rank's decoder is built, a tp that does not divide
    its heads, kv heads, MLP or vocab, naming the dimension (Qwen3's
    151,936 divides by 2, 4 and 8)."""
    check_divides(tp, text_dims(config))


def check_vl_tp(config, tp: int) -> None:
    """Refuse, before loading, a tp that does not divide a VL model's text
    dimensions (`config.text`), its tower's MLP or its mergers' hidden
    width (spatial_merge_size² × the tower's width: Qwen3-VL's main and
    deepstack mergers, Qwen2.5-VL's merger), naming the dimension."""
    v = config.vision
    check_divides(tp, {**text_dims(config.text),
                       "vision intermediate_size": v.intermediate_size,
                       "the merger's hidden width":
                       v.spatial_merge_size ** 2 * v.hidden_size})


def local_shape(shape: Sequence[int], spec: tuple, mesh: Mesh) -> tuple:
    """The shape of this rank's slice of a tensor of `shape` under
    `spec` (placed as `placed_spec` places it)."""
    placed = placed_spec(shape, spec, mesh)
    return tuple(size if i >= len(placed) or placed[i] is None
                 else size // mesh.shape[spec_axis(placed[i])[0]]
                 for i, size in enumerate(shape))


def shard_slice(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of `t` under `spec` (already placed): a view where
    the slice is contiguous (dimension 0, or a whole tensor), else a
    contiguous copy; a chunked entry takes the rank's part of each block
    and keeps them side by side."""
    out = t
    for dim, entry in enumerate(spec):
        axis, chunks = spec_axis(entry)
        if axis is None:
            continue
        block = out.shape[dim] // chunks
        n = block // mesh.shape[axis]
        start = mesh.index(axis) * n
        parts = [out.narrow(dim, c * block + start, n) for c in range(chunks)]
        out = parts[0] if chunks == 1 else torch.cat(parts, dim)
    return out if out.is_contiguous() else out.contiguous()


def _walk(tree, fn, path=""):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}.{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, f"{path}.{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def shard_params(params: Any, mesh: Mesh,
                 rules: Sequence[PartitionRule] = (),
                 device: torch.device | str | None = None) -> Any:
    """This rank's slice of every tensor of a parameter tree, by partition
    rules: each leaf's dotted path (e.g. "layers.q.w") is matched against
    `rules`; the first hit gives its spec, otherwise it is replicated.
    Leaves that are one tensor (a tied head and its embedding) stay one
    slice.  Moved to `device` where given."""
    memo: dict[tuple, torch.Tensor] = {}

    def place(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        spec = placed_spec(leaf.shape, spec_for(path, rules), mesh)
        key = (id(leaf), spec)
        if key not in memo:
            out = shard_slice(leaf, spec, mesh)
            memo[key] = out if device is None else out.to(device)
        return memo[key]

    return _walk(params, place)
