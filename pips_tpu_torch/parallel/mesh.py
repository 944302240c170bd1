"""Process mesh and sharding (counterpart of ``pips_tpu/parallel/mesh.py``).

A 2-D mesh ("data", "point") as in the JAX package: the batch B shards over
"data", the query points N over "point", and the parameters are replicated.
PyTorch runs one process per device, so the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group, rank r at row r // P, column r % P of a (D, P) mesh, and it holds every
rank of the group.

The JAX train step is one computation over the whole mesh, so its masked
means divide by the mask's count over the whole batch. Here each rank runs
the step on its own slice of the batch: ``global_masked_means`` sums every
masked mean's denominator over the ranks before it divides, so that the
ranks' losses add up to the loss of the whole batch, and the gradients are
summed (not averaged) over the ranks before the optimizer clips their global
norm and updates. A step at world size W then gives the loss, gradients and
parameters of the step at world size 1 on the same global batch, up to the
order of summation.

For inference both mesh axes fold over N: each rank tracks its slice of the
points through the same frames (``point_shard``), padded to a multiple of
the mesh's size by repeating the last point, and ``gather_points`` puts the
slices back together.

NCCL is the backend on CUDA and gloo on the CPU. gloo also reduces CUDA
tensors (it does not gather them), so ``gather_points`` gathers by a sum of
zero-filled slots, which is exact, on every backend.
"""

from __future__ import annotations

import contextlib
import math
import os
import socket
from typing import Callable, Iterator, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from pips_tpu_torch.models.pips import resolve_device
from pips_tpu_torch.ops.reduce import denominators_summed

DATA_AXIS = "data"
POINT_AXIS = "point"


def default_mesh_shape(ndev: int, B: int, N: int) -> tuple[int, int]:
    """Largest (data, point) mesh whose axes divide the batch/point dims.

    Prefers data parallelism, then spends leftover devices on the point
    axis (e.g. 8 devices, B=4, N=768 -> (4, 2); B=1, N=16 -> (1, 8)).
    """
    d = math.gcd(B, ndev)
    p = math.gcd(N, ndev // d)
    return (d, p)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def distributed_init(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, backend: Optional[str] = None,
                     device="cuda") -> None:
    """Join the process group: ``coordinator`` ("host:port" of rank 0),
    ``num_processes`` and ``process_id``, each taken from the environment a
    launcher sets (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    as ``torchrun`` does) where not given; a lone process with neither joins
    a group of one on a free local port. On CUDA the process takes the card
    ``LOCAL_RANK`` (or its rank) modulo the cards present. NCCL on CUDA and
    gloo on the CPU, unless ``backend`` names another. Raises without CUDA
    unless ``device="cpu"``; a repeat call is a no-op."""
    if dist.is_initialized():
        return
    device = resolve_device(device)
    env = os.environ
    world = num_processes or int(env.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None and process_id >= 0 else int(env.get("RANK", 0))
    if coordinator:
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    elif "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = "env://"
    elif world == 1:
        init_method = f"tcp://localhost:{_free_port()}"
    else:
        raise ValueError(f"{world} processes need a coordinator (host:port of rank 0) or "
                         f"MASTER_ADDR and MASTER_PORT")
    if device.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                            init_method=init_method, world_size=world, rank=rank)


def _world() -> tuple[int, int]:
    """(rank, world size); (0, 1) outside a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def make_mesh(shape: Optional[Sequence[int]] = None, device="cuda") -> DeviceMesh:
    """(data, point) mesh over every rank of the process group (joined here,
    as a group of one, if the process has none). Default: all ranks on the
    data axis. A shape that does not hold exactly the group's ranks raises:
    with one process per device, a rank outside the mesh would have no work."""
    device = resolve_device(device)
    distributed_init(device=device)
    world = dist.get_world_size()
    shape = tuple(int(s) for s in shape) if shape is not None else (world, 1)
    if len(shape) != 2 or math.prod(shape) != world:
        raise ValueError(f"a (data, point) mesh must hold the {world} processes of the group, "
                         f"one per device; got {shape}")
    return DeviceMesh(device.type, torch.arange(world).reshape(shape),
                      mesh_dim_names=(DATA_AXIS, POINT_AXIS))


def local_world_size() -> int:
    """Processes on this host: ``LOCAL_WORLD_SIZE`` as ``torchrun`` sets it,
    else 1 (each process a host of its own)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", 1))


def make_hybrid_mesh(ici_shape: Sequence[int], dcn_data: Optional[int] = None,
                     device="cuda") -> DeviceMesh:
    """Multi-host mesh: each host's ranks form an ``ici_shape`` (data, point)
    block, and the hosts (``dcn_data``, by default the group's size over
    ``local_world_size()``) stack on the data axis, so point-axis
    collectives stay inside a host. Ranks must be numbered host by host, as
    ``torchrun`` numbers them."""
    distributed_init(device=device)
    hosts = dcn_data or max(dist.get_world_size() // local_world_size(), 1)
    return make_mesh((hosts * int(ici_shape[0]), int(ici_shape[1])), device)


def parse_mesh_arg(arg: str, device="cuda") -> Optional[DeviceMesh]:
    """CLI ``--mesh`` string -> mesh (eval runners / chain engines).

    "" -> None (one process, no mesh); "auto" -> every rank on the point
    axis (inference: each rank tracks a slice of the points); "D,P" -> that
    (data, point) shape, e.g. "1,8".
    """
    if not arg:
        return None
    if arg == "auto":
        distributed_init(device=device)
        return make_mesh((1, dist.get_world_size()), device)
    shape = tuple(int(v) for v in arg.strip("()[] ").split(",") if v)
    if len(shape) != 2:
        raise ValueError(f"--mesh wants 'D,P', got {arg!r}")
    return make_mesh(shape, device)


def _coord(mesh: DeviceMesh, axis: str) -> tuple[int, int]:
    """(this rank's index along ``axis``, the axis's size)."""
    return mesh.get_local_rank(axis), mesh.shape[mesh.mesh_dim_names.index(axis)]


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0 to every rank
    of the group (a mesh holds them all), in place; returns the module."""
    if _world()[1] > 1:
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=0)
    return module


def batch_pspecs(grad_acc: int = 1) -> dict[str, tuple]:
    """The mesh axis of each dim of a train batch (None: not sharded), as the
    JAX PartitionSpecs: B on data, N on point, after the (grad_acc,)
    microbatch axis when there is one."""
    lead = (None,) * (1 if grad_acc > 1 else 0)
    return {
        "rgbs": (*lead, DATA_AXIS),
        "trajs": (*lead, DATA_AXIS, None, POINT_AXIS),
        "visibles": (*lead, DATA_AXIS, None, POINT_AXIS),
        "valids": (*lead, DATA_AXIS, None, POINT_AXIS),
    }


def shard_batch(mesh: DeviceMesh, batch: dict, grad_acc: int = 1, hosts: int = 1) -> dict:
    """This rank's slice of a train batch (numpy arrays or tensors): its share
    of B on "data" and of N on "point"; keys the step does not read are
    dropped. With ``hosts`` > 1 the batch is this host's (B per host, as the
    JAX multi-host loop loads it) and spreads over the host's rows of the
    data axis. Each sharded dim must divide evenly."""
    out = {}
    for key, spec in batch_pspecs(grad_acc).items():
        v = batch[key]
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            i, n = _coord(mesh, axis)
            if axis == DATA_AXIS:
                n //= hosts
                i %= n
            size = v.shape[dim]
            if size % n:
                raise ValueError(f"{key} dim {dim} ({size}) does not split over {n} "
                                 f"'{axis}' ranks")
            step = size // n
            v = v[(slice(None),) * dim + (slice(i * step, (i + 1) * step),)]
        out[key] = v
    return out


def _sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over every rank (a new tensor)."""
    t = t.detach().clone()
    if _world()[1] > 1:
        dist.all_reduce(t)
    return t


def rank_values(value: float, device) -> list[float]:
    """``value`` of every rank of the group, in rank order (one reduction)."""
    rank, world = _world()
    slots = torch.zeros(world, dtype=torch.float64, device=device)
    slots[rank] = value
    return _sum(slots).tolist()


@contextlib.contextmanager
def global_masked_means(mesh: Optional[DeviceMesh]) -> Iterator[None]:
    """Inside the block every masked mean (``ops.reduce``) divides by its
    mask's count over the whole mesh, as the JAX step's global masked means
    do; without a mesh, a no-op."""
    if mesh is None:
        yield
        return
    with denominators_summed(_sum):
        yield


def sum_metrics(metrics: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Each 0-d metric summed over the ranks, in one reduction: the whole
    batch's value where each rank's is its share of a global masked mean."""
    keys = sorted(metrics)
    total = _sum(torch.stack([metrics[k].float() for k in keys]))
    return dict(zip(keys, total.unbind()))


@torch.no_grad()
def sum_grads(params: Sequence[torch.nn.Parameter]) -> None:
    """Every parameter's grad summed over the ranks, in place, in one
    reduction (a missing grad counts as zeros)."""
    if _world()[1] == 1:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    for g, f in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(f.view_as(g))


class _GradsSummed:
    """``optimizer`` for ``train.make_train_step``: its ``step`` first sums
    the grads over the ranks, so that the clip sees the global norm."""

    def __init__(self, optimizer, model):
        self.optimizer = optimizer
        self.params = [p for p in model.parameters() if p.requires_grad]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad()

    def step(self):
        sum_grads(self.params)
        return self.optimizer.step()


def make_sharded_train_step(model, optimizer, mesh: DeviceMesh, iters: int = 4,
                            horz_flip: bool = True, vert_flip: bool = True, grad_acc: int = 1,
                            use_fused_corr: bool = False, remat: bool = False,
                            sync_metrics: bool = True) -> Callable[[dict], dict]:
    """``train.make_train_step`` over the mesh: ``step(shard)`` takes this
    rank's ``shard_batch`` slice, divides every masked mean by the whole
    batch's count, sums the grads over the ranks before the optimizer's clip
    and update (so the global norm is the whole batch's), and returns the
    whole batch's metrics (floats, or 0-d tensors with ``sync_metrics=False``).
    The replicated parameters stay equal on every rank."""
    from pips_tpu_torch.train.step import make_train_step

    step = make_train_step(model, _GradsSummed(optimizer, model), iters=iters,
                           horz_flip=horz_flip, vert_flip=vert_flip, grad_acc=grad_acc,
                           use_fused_corr=use_fused_corr, remat=remat, sync_metrics=False)

    def sharded_step(shard: dict) -> dict:
        with global_masked_means(mesh):
            metrics = sum_metrics(step(shard))
        return {k: float(v) for k, v in metrics.items()} if sync_metrics else metrics

    return sharded_step


def point_shard(x: torch.Tensor, mesh: DeviceMesh, dim: int = 1) -> tuple[torch.Tensor, int]:
    """This rank's slice of ``x``'s point axis ``dim`` over the whole mesh,
    after padding that axis to a multiple of the mesh's size by repeating the
    last point (as the JAX ``WindowTracker._pad_points``). Returns (slice,
    the unpadded count)."""
    k, r = mesh.size(), _world()[0]
    n = x.shape[dim]
    pad = -n % k
    if pad:
        last = x.narrow(dim, n - 1, 1)
        x = torch.cat([x, last.expand(*x.shape[:dim], pad, *x.shape[dim + 1:])], dim=dim)
    per = x.shape[dim] // k
    return x.narrow(dim, r * per, per), n


def gather_points(x: torch.Tensor, mesh: DeviceMesh, dim: int, n: int) -> torch.Tensor:
    """Every rank's ``point_shard`` slice of a result, put back together in
    mesh order along ``dim``, the padding sliced off to ``n`` points."""
    k, r = mesh.size(), _world()[0]
    if k == 1:
        return x.narrow(dim, 0, n)
    low = x.dtype in (torch.bfloat16, torch.float16)
    slots = torch.zeros((k, *x.shape), dtype=torch.float32 if low else x.dtype, device=x.device)
    slots[r] = x
    dist.all_reduce(slots)  # x + 0 == x; gloo's one collective for CUDA tensors too
    out = torch.cat(slots.unbind(0), dim=dim).narrow(dim, 0, n)
    return out.to(x.dtype) if low else out


def make_sharded_forward(model, mesh: DeviceMesh, iters: int = 6, corr_mode: str = "onehot"):
    """Eval-mode forward with the points sharded over the whole mesh (both
    axes) and the video replicated: ``fwd(xys (B, N, 2), rgbs (B, S, H, W,
    3))`` -> (coords (B, S, N, 2), vis logits (B, S, N), ffeat (B, N, C)),
    tensors on the model's device, equal on every rank."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def fwd(xys, rgbs):
        xys = torch.as_tensor(xys, dtype=torch.float32).to(device)
        rgbs = torch.as_tensor(rgbs, dtype=torch.float32).to(device)
        part, n = point_shard(xys, mesh, dim=1)
        out = model(part, rgbs, iters=iters, is_train=False, corr_mode=corr_mode)
        return (gather_points(out.coord_predictions[-1], mesh, 2, n),
                gather_points(out.vis_e, mesh, 2, n), gather_points(out.ffeat, mesh, 1, n))

    return fwd


__all__ = ["DATA_AXIS", "POINT_AXIS", "batch_pspecs", "default_mesh_shape",
           "distributed_init", "gather_points", "global_masked_means", "local_world_size",
           "make_hybrid_mesh", "make_mesh", "make_sharded_forward", "make_sharded_train_step",
           "parse_mesh_arg", "point_shard", "rank_values", "replicate", "shard_batch",
           "sum_grads", "sum_metrics"]
