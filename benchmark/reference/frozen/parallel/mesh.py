"""The ray mesh on ``torch.distributed`` (port of ``apnerf/parallel/mesh.py``).

The JAX package replicates the parameters, shards the ray batch over a 1-D
device mesh and lets GSPMD insert the collectives, so that its program
keeps the single-device semantics: every static-budget compaction still
runs over the global batch. Here a rank is a process. To keep those
semantics, every rank holds the whole global batch and runs the cheap
sampling and every compaction itself, so that the surviving samples and
their order are the single-device run's on every rank; the expensive work
a surviving slot takes (the grid gather, the MLPs, the k-NN kernels and
the heads) runs on the rank's contiguous block of the slots
(``shard_rows``), and the blocks' outputs are all-gathered before the
scatter back and the composite, so the loss is the same on every rank.
The all-gather's backward hands each rank its own block: summed over the
ranks (``MaskedAdam.reduce``), the blocks' parameter gradients are the
whole batch's. A loss term that every rank computes whole (the
regularisers) passes ``count_once``, so that it enters the sum once.

Parameters are replicated: ``put_replicated`` broadcasts them from rank 0
at build time. The Adam moments are ZeRO-1 split (``zero1_split``): a
rank holds 1/world of every moment leaf of at least ``ZERO1_MIN_SIZE``
elements, as a contiguous range of the flattened leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

ZERO1_MIN_SIZE = 8192  # moment leaves smaller than this stay replicated


@dataclasses.dataclass(frozen=True)
class Mesh:
    """What ``mesh=`` receives: the process group (``None``: the default
    group), this process's rank, the world size and the device the rank's
    tensors lie on."""
    group: Optional[object]
    rank: int
    world: int
    device: torch.device


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The 1-D mesh over the ranks of the process group
    (``distributed.initialize``); ``n_devices``, when given, must be its
    size. Its device is this rank's card where the group is NCCL's, else
    the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "apnerf_torch.parallel.initialize first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"a mesh of {n_devices} devices in a group of "
                         f"{world} ranks")
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(None, rank, world, device)


def writer(mesh: Optional[Mesh]) -> bool:
    """True where this process writes files: no mesh, or rank 0."""
    return mesh is None or mesh.rank == 0


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _gather_into(out: torch.Tensor, x: torch.Tensor, mesh: Mesh) -> None:
    fn = (getattr(dist, "all_gather_single", None)
          or dist.all_gather_into_tensor)
    fn(out, x.contiguous(), group=mesh.group)


def all_gather_flat(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[b, ...] on each rank -> [world * b, ...], rank-major (no
    gradient). Bool tensors travel as uint8."""
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    out = src.new_empty((mesh.world * src.shape[0], *src.shape[1:]))
    _gather_into(out, src, mesh)
    return out.bool() if x.dtype == torch.bool else out


class _AllGatherRows(torch.autograd.Function):
    """All-gather of row blocks whose backward takes this rank's block of
    the (replicated) upstream gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return all_gather_flat(x, mesh)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.rank * ctx.rows
        return g[lo:lo + ctx.rows], None


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable ``all_gather_flat``: the gradient of a rank's block
    is its part of the gathered tensor's gradient."""
    if x.requires_grad and torch.is_grad_enabled():
        return _AllGatherRows.apply(x, mesh)
    return all_gather_flat(x, mesh)


class _CountOnce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rank):
        ctx.rank = rank
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.rank == 0 else torch.zeros_like(g)), None


def count_once(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` unchanged; its gradient reaches the parameters on rank 0 only.
    For a term every rank computes whole, so that the ranks' summed
    gradients hold it once (exactly: the other ranks add zeros)."""
    if mesh is None or not (x.requires_grad and torch.is_grad_enabled()):
        return x
    return _CountOnce.apply(x, mesh.rank)


def block(n: int, mesh: Mesh):
    """(start, size) of this rank's block of ``n`` rows: ceil(n / world)
    rows a rank, the last block cut at ``n`` (its size is then padded by
    ``shard_rows``)."""
    per = -(-n // mesh.world)
    return min(mesh.rank * per, n), per


def shard_rows(mesh: Optional[Mesh], fn: Callable, *inputs):
    """``fn(*inputs)`` with its rows split over the ranks: each rank runs
    ``fn`` on its block of the leading axis of every tensor input (``None``
    inputs pass as they are), and the outputs' blocks (a tensor, a tuple or
    a dict of them, each with the block's rows first; ``None`` passes) are
    all-gathered back to ``n`` rows. Without a mesh: ``fn(*inputs)``. A
    block short of ``ceil(n / world)`` rows repeats the last row; the
    repeats are cut from the result, so their gradient is zero."""
    if mesh is None:
        return fn(*inputs)
    n = next(x.shape[0] for x in inputs if torch.is_tensor(x))
    lo, per = block(n, mesh)
    if lo + per <= n:
        parts = [x[lo:lo + per] if torch.is_tensor(x) else x for x in inputs]
    else:
        rows = torch.arange(lo, lo + per, device=mesh.device).clamp(
            max=n - 1)
        parts = [x.index_select(0, rows) if torch.is_tensor(x) else x
                 for x in inputs]
    out = fn(*parts)

    def gather(y):
        return None if y is None else all_gather_rows(y, mesh)[:n]

    if isinstance(out, dict):
        return {k: gather(v) if torch.is_tensor(v) or v is None else v
                for k, v in out.items()}
    if isinstance(out, tuple):
        return tuple(gather(y) for y in out)
    return gather(out)


def all_reduce_(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``x`` over the ranks in place."""
    dist.all_reduce(x, group=mesh.group)
    return x


def all_reduce_grads(grads: Dict[str, Optional[torch.Tensor]],
                     mesh: Mesh) -> Dict[str, Optional[torch.Tensor]]:
    """The ranks' gradients summed in fp32, in one all-reduce of their
    flat concatenation (``None`` stays ``None``: no rank has one)."""
    names = [n for n, g in grads.items() if g is not None]
    if not names:
        return dict(grads)
    flat = torch.cat([grads[n].float().reshape(-1) for n in names])
    all_reduce_(flat, mesh)
    out = dict(grads)
    off = 0
    for n in names:
        k = grads[n].numel()
        out[n] = flat[off:off + k].view(grads[n].shape)
        off += k
    return out


@torch.no_grad()
def broadcast_(tensors, mesh: Optional[Mesh], src: int = 0) -> None:
    """Copy rank ``src``'s values of ``tensors`` to every rank in place."""
    if mesh is None:
        return
    for t in tensors:
        # the collective takes a contiguous tensor of a type it knows
        u = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        dist.broadcast(u, src, group=mesh.group)
        if u is not t:
            t.copy_(u)


def put_replicated(module: torch.nn.Module, mesh: Optional[Mesh],
                   extra=()) -> None:
    """Replicated placement: ``module``'s parameters and buffers, and the
    tensors of ``extra`` (a mapping or a sequence; other entries are
    skipped), broadcast from rank 0, so that the replicas start equal
    whatever each rank computed."""
    if mesh is None:
        return
    vals = extra.values() if isinstance(extra, dict) else extra
    broadcast_([*module.parameters(), *module.buffers(),
                *(t for t in vals if torch.is_tensor(t))], mesh)


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None:
        dist.barrier(group=mesh.group)


# ---------------------------------------------------------------------------
# ZeRO-1
# ---------------------------------------------------------------------------

def zero1_split(numel: int, world: int,
                min_size: int = ZERO1_MIN_SIZE) -> Optional[int]:
    """Elements a rank holds of a moment leaf of ``numel`` elements:
    ceil(numel / world), the rank's contiguous range of the flattened leaf
    (the last rank's range padded with zeros), or ``None`` for a leaf under
    ``min_size`` that stays replicated."""
    if numel < min_size:
        return None
    return -(-numel // world)
