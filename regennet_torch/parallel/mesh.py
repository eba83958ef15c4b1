"""Process groups, the device mesh and the sharded training state over
torch.distributed (counterpart of regennet_tpu/parallel/mesh.py).

One process per card, started by a launcher (`torchrun --nproc_per_node
N`), which gives each process RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR
and MASTER_PORT. The backend is NCCL on cuda and gloo on the CPU; a group
that is already initialised (a test's, or two ranks sharing one card over
gloo) is used as it is. The ranks form a ("data", "model") DeviceMesh,
rank = data_index * model + model_index.

* data axis: rank r trains on its stride of the data; the global batch is
  the concatenation of the ranks' local batches and the loss its mean.
  The gradients are averaged over "data" explicitly, in one flat buffer
  after backward() (the JAX package's gradient psum over 'data'): the
  bf16 route runs the model through functional_call on cast copies, which
  a DistributedDataParallel wrapper would not see. Every random draw of a
  step (t, the q_sample noise, the dropouts, the attention's row seeds) is
  made at the global batch's shape from the same seeded generator on
  every rank, and each rank takes its rows (`ShardedDraws`): a step does
  not depend on the world size.
* model axis: tensor parallelism of the transformer, by the JAX package's
  name rules. Column-parallel: q, k and v (the packed in_proj_weight
  [3D, D] is split within each of its three blocks, by heads) and
  linear1; row-parallel: out_proj and linear2, whose bias is added once,
  after the all-reduce; everything else replicated. A rank's attention
  runs its D/N columns as num_heads/N heads of the same head dim, and its
  dropout bits are those of the same heads of the whole model.
* --param_sharding fsdp: the parameters' float32 master copy, the AdamW
  moments and the EMA of each rank's (tensor-parallel) parameters are one
  flat buffer sharded over "data" (`FlatShard`). A step all-gathers the
  parameters into the module, reduce-scatters the gradients and updates
  the rank's shard; between steps the module holds no parameters.

One process without a launcher trains in the same code as a rank of a
group: `setup` gives it a one-rank Layout (no groups), whose draws are
torch.Generator's own, whose averages and reductions are no-ops and
whose FSDP shard is the whole buffer.

FSDP's all-gather and reduce-scatter are the backend's own (NCCL on
cards, gloo on the CPU). Gathering a tensor-parallel checkpoint, which is
off the step's path, sums zero-padded blocks with an all-reduce, which
every backend offers (gloo has no all-gather for CUDA tensors, and two
ranks may share one card over gloo).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

# the JAX package's name rules in the port's names: its column-parallel
# q_proj, k_proj and v_proj are the port's packed in_proj (split within each
# third), then linear1; row-parallel out_proj and linear2
_COL_PARALLEL = ("linear1",)
_ROW_PARALLEL = ("out_proj", "linear2")
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


# ---------------------------------------------------------------------------
# process group and mesh
# ---------------------------------------------------------------------------

def init_distributed(device: torch.device) -> bool:
    """Join the launcher's process group. True when a group is (now)
    initialised, False without a launcher environment (one process).
    NCCL when `device` is a card (made the current device), else gloo."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    missing = [k for k in LAUNCHER_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE is set but {missing} are not: launch with "
                           f"torchrun, or export all of {LAUNCHER_ENV}")
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def local_device(device: torch.device) -> torch.device:
    """cuda:LOCAL_RANK for a cuda `device` under a launcher whose process
    group is not started yet (one process per card); else `device`."""
    if device.type == "cuda" and "LOCAL_RANK" in os.environ and not dist.is_initialized():
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_mesh(data: int = -1, model: int = 1, device_type: str = "cpu"):
    """A ("data", "model") DeviceMesh over every rank of the process
    group; data=-1 means world // model. Raises unless data * model is
    the world size (no rank idles, none is missing)."""
    from torch.distributed.device_mesh import DeviceMesh

    n = world_size()
    if model < 1 or n % model:
        raise ValueError(f"{n} ranks are not divisible by model={model}")
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f"a {data}x{model} mesh needs {data * model} ranks; the "
                         f"process group has {n}")
    mesh = torch.arange(n).view(data, model)
    return DeviceMesh(device_type, mesh, mesh_dim_names=("data", "model"))


@dataclasses.dataclass
class Layout:
    """Where this rank sits: its indices on "data" and "model", the two
    axes' groups, and whether the state is FSDP-sharded. One process
    without a launcher is the one-rank layout (`one_process`): no mesh and
    no groups."""

    mesh: object
    data_rank: int
    data_size: int
    model_rank: int
    model_size: int
    data_group: object
    model_group: object
    fsdp: bool

    @property
    def is_main(self) -> bool:
        return global_rank() == 0

    def draws(self, generator: torch.Generator, local_rows: int) -> "ShardedDraws":
        return ShardedDraws(generator, self.data_rank * local_rows,
                            self.data_size * local_rows, self.model_rank, self.model_size)

    def sum_over_data(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over "data", in place."""
        if self.data_size > 1:
            dist.all_reduce(x, group=self.data_group)
        return x

    def barrier(self) -> None:
        """Every rank of the mesh waits for the others."""
        if self.mesh is not None:
            dist.barrier()


def one_process(fsdp: bool = False) -> Layout:
    """The layout of one process without a process group."""
    return Layout(None, 0, 1, 0, 1, None, None, fsdp)


def layout_from_mesh(mesh, fsdp: bool = False) -> Layout:
    return Layout(mesh, mesh.get_local_rank("data"), mesh.size(0),
                  mesh.get_local_rank("model"), mesh.size(1),
                  mesh.get_group("data"), mesh.get_group("model"), fsdp)


def setup(args, device: torch.device) -> Layout:
    """The training layout of --data_parallel, --tensor_parallel and
    --param_sharding: `one_process` without a launcher, where more than
    one rank asked for raises, as does a mesh the group cannot fill."""
    data = int(getattr(args, "data_parallel", -1))
    model = int(getattr(args, "tensor_parallel", 1))
    fsdp = getattr(args, "param_sharding", "replicated") == "fsdp"
    if not init_distributed(device):
        if data not in (-1, 1) or model != 1:
            raise RuntimeError(
                f"--data_parallel {data} --tensor_parallel {model} needs "
                f"{max(data, 1) * model} processes, but no launcher environment "
                "(RANK, WORLD_SIZE, ...) was found: start one process per card "
                "with torchrun --nproc_per_node N")
        return one_process(fsdp)
    return layout_from_mesh(make_mesh(data, model, device.type), fsdp)


def process_shard_info(layout: Optional[Layout] = None) -> Tuple[int, int]:
    """(shard, num_shards) for the feeder's striding: the rank's index on
    "data" and the data size. The ranks of one tensor-parallel group read
    the same shard. (0, 1) for one process."""
    if layout is None:
        if not dist.is_initialized():
            return 0, 1
        return global_rank(), world_size()
    return layout.data_rank, layout.data_size


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_gather_flat(shard: torch.Tensor, group, size: int) -> torch.Tensor:
    """The ranks' equal 1-D shards concatenated in rank order."""
    if size == 1:
        return shard.clone()
    out = torch.empty(size * shard.numel(), dtype=shard.dtype, device=shard.device)
    dist.all_gather_into_tensor(out, shard.contiguous(), group=group)
    return out


def reduce_scatter_flat(full: torch.Tensor, group, size: int) -> torch.Tensor:
    """This rank's 1-D shard of the sum of the ranks' `full` tensors."""
    if size == 1:
        return full.clone()
    out = torch.empty(full.numel() // size, dtype=full.dtype, device=full.device)
    dist.reduce_scatter_tensor(out, full.contiguous(), group=group)
    return out


def gather_by_sum(shard: torch.Tensor, group, size: int, rank: int) -> torch.Tensor:
    """all_gather_flat by one all-reduce of zero-padded shards, on every
    backend (gloo too, for CUDA tensors)."""
    out = torch.zeros(size * shard.numel(), dtype=shard.dtype, device=shard.device)
    out[rank * shard.numel():(rank + 1) * shard.numel()] = shard.reshape(-1)
    dist.all_reduce(out, group=group)
    return out


def gather_objects(obj, group=None) -> list:
    """Every rank's picklable `obj`, in rank order."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


# ---------------------------------------------------------------------------
# random draws of a sharded step
# ---------------------------------------------------------------------------

class ShardedDraws:
    """A torch.Generator whose draws are made at the global batch's shape
    and sliced: rows [row0, row0 + B) of `rows` on dim 0, and on a
    tensor-parallel dim, this model rank's block. Every rank holds the
    same generator state, so a rank's slice is what one process would
    draw for those rows. With the defaults (one process) a draw is the
    generator's own draw of the shape asked for."""

    def __init__(self, generator: torch.Generator, row0: int = 0, rows: Optional[int] = None,
                 model_rank: int = 0, model_size: int = 1):
        self.generator = generator
        self.row0, self.rows = row0, rows
        self.model_rank, self.model_size = model_rank, model_size

    def _global(self, shape, shard_dim):
        full = list(shape)
        if self.rows is not None:
            full[0] = self.rows
        if shard_dim is not None:
            full[shard_dim] *= self.model_size
        return full

    def _slice(self, x, shape, shard_dim):
        x = x[self.row0:self.row0 + shape[0]]
        if shard_dim is not None and self.model_size > 1:
            n = shape[shard_dim]
            x = x.narrow(shard_dim, self.model_rank * n, n)
        return x.contiguous()

    def rand(self, shape, device, shard_dim: Optional[int] = None) -> torch.Tensor:
        x = torch.rand(self._global(shape, shard_dim), generator=self.generator, device=device)
        return self._slice(x, shape, shard_dim)

    def randn(self, shape, device, dtype=torch.float32) -> torch.Tensor:
        x = torch.randn(self._global(shape, None), generator=self.generator, device=device,
                        dtype=dtype)
        return self._slice(x, shape, None)

    def randint(self, low, high, shape, device, dtype) -> torch.Tensor:
        x = torch.randint(low, high, self._global(shape, None), generator=self.generator,
                          device=device, dtype=dtype)
        return self._slice(x, shape, None)


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over "model" (the input
    of a column-parallel matmul)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.all_reduce(grad), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce over "model" forward (a row-parallel matmul's partial
    products); identity gradient."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class TensorParallel:
    """A module's place on the "model" axis: its group, rank and size."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group, reduced in float32, in x's dtype."""
        y = x.detach().float().clone()
        dist.all_reduce(y, group=self.group)
        return y.to(x.dtype)

    def copy(self, x):
        return _CopyToModel.apply(x, self)

    def reduce(self, x):
        return _ReduceFromModel.apply(x, self)

    def __deepcopy__(self, memo):
        return self  # the group is shared, not copied


def tp_kind(name: str) -> Optional[str]:
    """How a parameter (or a tensor named like one) is split over "model":
    'qkv' (dim 0 within each third), 'col' (dim 0), 'row' (dim 1), or
    None (replicated), by the JAX package's name rules."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("in_proj_weight", "in_proj_bias"):
        return "qkv"
    module = name.rsplit(".", 2)[-2] if "." in name else ""
    if module in _COL_PARALLEL:
        return "col"
    if module in _ROW_PARALLEL:
        return "row" if leaf == "weight" else None  # the bias follows the all-reduce
    return None


def shard_tensor(name: str, full: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """This model rank's block of a full tensor."""
    kind = tp_kind(name)
    if kind is None or size == 1:
        return full
    if kind == "qkv":
        return torch.cat([blk.chunk(size, dim=0)[rank] for blk in full.chunk(3, dim=0)])
    return full.chunk(size, dim=0 if kind == "col" else 1)[rank]


def unshard_tensor(name: str, local: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The full tensor from every model rank's block (a collective)."""
    kind = tp_kind(name)
    if kind is None or tp.size == 1:
        return local
    dim = 1 if kind == "row" else 0
    blocks = local.chunk(3, dim=0) if kind == "qkv" else (local,)
    out = []
    for blk in blocks:
        moved = blk.movedim(dim, 0).contiguous()
        full = gather_by_sum(moved.reshape(-1), tp.group, tp.size, tp.rank)
        out.append(full.view(tp.size * moved.shape[0], *moved.shape[1:]).movedim(0, dim))
    return torch.cat(out) if kind == "qkv" else out[0]


def shard_model_(model: nn.Module, tp: TensorParallel) -> None:
    """Replace the model's tensor-parallel parameters by this rank's blocks
    and hand the attention and feed-forward modules `tp`: heads and the
    feed-forward width must divide by the model size."""
    for prefix, module in model.named_modules():
        if hasattr(module, "in_proj_weight"):
            if module.num_heads % tp.size:
                raise ValueError(f"{module.num_heads} heads do not split over "
                                 f"tensor_parallel={tp.size}")
            module.num_heads //= tp.size
        elif not (hasattr(module, "linear1") and hasattr(module, "linear2")):
            continue
        if hasattr(module, "linear1") and module.linear1.out_features % tp.size:
            raise ValueError(f"ff_size {module.linear1.out_features} does not split "
                             f"over tensor_parallel={tp.size}")
        module.tp = tp
    for name, p in list(model.named_parameters()):
        if tp_kind(name) is None:
            continue
        owner, leaf = _owner(model, name)
        setattr(owner, leaf, nn.Parameter(shard_tensor(name, p.detach(), tp.rank,
                                                       tp.size).clone()))


def _owner(model: nn.Module, name: str):
    path, leaf = name.rsplit(".", 1)
    return model.get_submodule(path), leaf


def sharded_flags(names: Sequence[str], layout: Layout) -> List[bool]:
    """Whether each named tensor is split over "model" in `layout`."""
    return [layout.model_size > 1 and tp_kind(n) is not None for n in names]


# ---------------------------------------------------------------------------
# FSDP: one flat buffer sharded over "data"
# ---------------------------------------------------------------------------

class FlatShard:
    """The listed parameters as one flat float32 buffer, padded to a
    multiple of the data size; this rank keeps `shard`, its slice, as the
    master copy AdamW updates. `gather_()` puts the full parameters into
    the module, `release_()` frees them; `reduce_grads_()` sets the shard's
    gradient to the data-average of the module's."""

    def __init__(self, params: List[nn.Parameter], layout: Layout):
        self.params = params
        self.layout = layout
        self.shapes = [p.shape for p in params]
        self.numels = [p.numel() for p in params]
        total = sum(self.numels)
        self.size = -(-total // layout.data_size) * layout.data_size
        self.per_rank = self.size // layout.data_size
        self.shard = nn.Parameter(self.shard_of([p.detach() for p in params]))

    def _flat(self, tensors) -> torch.Tensor:
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        return torch.nn.functional.pad(flat, (0, self.size - flat.numel()))

    def shard_of(self, tensors) -> torch.Tensor:
        """This rank's slice of full tensors laid out as the parameters."""
        r = self.layout.data_rank
        return self._flat(tensors)[r * self.per_rank:(r + 1) * self.per_rank].clone()

    def full_of(self, shard: torch.Tensor) -> List[torch.Tensor]:
        """Full tensors, laid out as the parameters, from every rank's shard."""
        flat = all_gather_flat(shard.detach(), self.layout.data_group, self.layout.data_size)
        return [t.view(s) for t, s in zip(flat[:sum(self.numels)].split(self.numels),
                                          self.shapes)]

    def flags(self, per_param: Sequence[bool]) -> torch.Tensor:
        """A per-parameter flag laid out as this rank's shard (padding False)."""
        return self.shard_of([torch.full(s, float(f)) for s, f in
                              zip(self.shapes, per_param)]).to(self.shard.device) > 0.5

    @torch.no_grad()
    def gather_(self) -> None:
        for p, full in zip(self.params, self.full_of(self.shard)):
            p.data = full.to(p.dtype).clone()

    @torch.no_grad()
    def release_(self) -> None:
        for p in self.params:
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
            p.grad = None

    @torch.no_grad()
    def reduce_grads_(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        g = reduce_scatter_flat(self._flat(grads), self.layout.data_group,
                                self.layout.data_size)
        self.shard.grad = g / self.layout.data_size
        for p in self.params:
            p.grad = None


def average_grads_(params: Sequence[nn.Parameter], layout: Layout) -> None:
    """Average the gradients over "data" in one flat all-reduce."""
    if layout.data_size == 1:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=layout.data_group)
    flat /= layout.data_size
    for p, g in zip(params, flat.split([g.numel() for g in grads])):
        p.grad = g.view(p.shape)


def global_norm(tensors: Sequence[torch.Tensor], sharded: Sequence, layout: Layout,
                over_data: bool = False) -> torch.Tensor:
    """sqrt of the sum of squares of every entry of the whole model
    (optax.global_norm): tensors split over "model" (`sharded`, a flag per
    tensor or a boolean mask shaped like it) are summed over that group,
    the others counted once; over_data: the tensors are FSDP shards,
    summed over "data"."""
    replicated, split = [], []
    for t, s in zip(tensors, sharded):
        if torch.is_tensor(s):
            replicated.append(torch.where(s, 0.0, t))
            split.append(torch.where(s, t, 0.0))
        else:
            (split if s else replicated).append(t)
    device = tensors[0].device

    def sum_sq(ts):
        if not ts:
            return torch.zeros((), dtype=torch.float32, device=device)
        return torch.stack(torch._foreach_norm([t.float() for t in ts])).square().sum()

    sq = torch.stack([sum_sq(replicated), sum_sq(split)])
    if over_data:
        layout.sum_over_data(sq)
    if layout.model_size > 1:
        part = sq[1:].clone()
        dist.all_reduce(part, group=layout.model_group)
        sq = torch.stack([sq[0], part[0]])
    return torch.sqrt(sq.sum())
