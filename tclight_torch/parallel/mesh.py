"""A ('data', 'model') device mesh over torch.distributed (counterpart of
tclight_tpu/parallel/mesh.py).

JAX builds a `jax.sharding.Mesh` and lets XLA insert the collectives; here
the mesh is a set of process groups, one rank per device, and the
collectives are explicit. Rank r sits at data index r // model_parallel
and model index r % model_parallel, the row-major layout of JAX's
`np.asarray(devices).reshape(n // model_parallel, model_parallel)`.

- 'data': frame / chunk / token parallelism. Each data rank computes its
  share of a batch (`data_rows`, `split_rows`) and the shares are
  gathered (`gather_rows`) before anything that mixes them.
- 'model': tensor parallelism. `shard_params` makes the Linear, Conv and
  Embedding modules whose output features pass `_kernel_spec`'s rule
  column-parallel: each model rank keeps its slice of the output features
  and all-gathers the output over its model group, the all-gather XLA
  inserts on its own. Biases stay whole and are added after the gather.

Launch one process per device (`torchrun --nproc_per_node N`) and call
`init_distributed()`; NCCL serves CUDA tensors, gloo CPU tensors.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

__all__ = ["Mesh", "make_mesh", "init_distributed", "shard_params", "unshard_params",
           "data_rows", "split_rows", "gather_rows", "_kernel_spec"]


def init_distributed(backend: str | None = None, init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     device: str | torch.device | None = None) -> None:
    """Initialise the default process group, once: NCCL when `device` is a
    CUDA device (or, without one, when the card is there), gloo on the
    CPU. Without `init_method` the rendezvous comes from torchrun's
    environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE); a CUDA rank
    takes the card of its LOCAL_RANK."""
    if dist.is_initialized():
        return
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if init_method is None:
        init_method = "env://"
        world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
        rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", device.index or 0)))
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(minutes=10))


@dataclasses.dataclass
class Mesh:
    """This rank's place in the ('data', 'model') mesh and its two groups:
    `data_group` holds the ranks of its model column (same model index),
    `model_group` those of its data row (same data index)."""

    n_devices: int
    model_parallel: int
    rank: int
    data_group: object
    model_group: object

    @property
    def shape(self) -> dict:
        return {"data": self.n_devices // self.model_parallel, "model": self.model_parallel}

    @property
    def data_index(self) -> int:
        return self.rank // self.model_parallel

    @property
    def model_index(self) -> int:
        return self.rank % self.model_parallel

    def data_ranks(self) -> list[int]:
        """Global ranks of this rank's data group, by data index."""
        return [d * self.model_parallel + self.model_index for d in range(self.shape["data"])]


def make_mesh(n_devices: int | None = None, model_parallel: int = 1) -> Mesh:
    """The ('data', 'model') mesh over an initialised process group of
    `n_devices` ranks (default: the world). Every rank must call it, with
    the same arguments: it creates one group per data row and per model
    column, on every rank in the same order."""
    n = n_devices
    if n is not None and n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    if not dist.is_initialized():
        raise ValueError(f"a mesh of {n} devices needs an initialised process group "
                         "(torchrun, or init_distributed); there is none")
    world = dist.get_world_size()
    n = world if n is None else n
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a world of {n} ranks, found {world}")
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    rank = dist.get_rank()
    mp = model_parallel
    data_group = model_group = None
    for row in range(n // mp):  # data rows: the model groups
        g = dist.new_group(list(range(row * mp, (row + 1) * mp)))
        if rank // mp == row:
            model_group = g
    for col in range(mp):  # model columns: the data groups
        g = dist.new_group(list(range(col, n, mp)))
        if rank % mp == col:
            data_group = g
    return Mesh(n, mp, rank, data_group, model_group)


# ------------------------------------------------------------ batch shares


def data_rows(b: int, mesh: Mesh | None) -> slice:
    """The rows of a batch of `b` that this rank's data index computes:
    equal contiguous shares (b must divide by the data size)."""
    if mesh is None:
        return slice(0, b)
    d = mesh.shape["data"]
    if b % d:
        raise ValueError(f"a batch of {b} does not split over {d} data ranks")
    share = b // d
    return slice(mesh.data_index * share, (mesh.data_index + 1) * share)


def split_rows(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """This rank's share of x's leading axis."""
    return x[data_rows(x.shape[0], mesh)]


def gather_rows(x: torch.Tensor, mesh: Mesh | None, dim: int = 0) -> torch.Tensor:
    """The data group's shares of axis `dim` (the leading one by default),
    joined in data order."""
    if mesh is None:
        return x
    return _all_gather_cat(x, mesh.shape["data"], mesh.data_group, dim)


def _all_gather_cat(x: torch.Tensor, size: int, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


# ------------------------------------------------------------ tensor parallel


def _kernel_spec(path_leaf: str, shape: tuple, model_size: int) -> tuple:
    """Tensor-parallel rule, on the flax leaf name and shape: shard the
    output-feature (last) axis of Dense / Conv kernels and embeddings
    when it divides by the model size and is at least 8 times it;
    replicate everything else. Returns the partition spec's axes."""
    if model_size <= 1 or not shape:
        return ()
    if (path_leaf in ("kernel", "embedding") and shape[-1] % model_size == 0
            and shape[-1] >= model_size * 8):
        return tuple([None] * (len(shape) - 1) + ["model"])
    return ()


def _flax_leaf(module: nn.Module) -> tuple[str, tuple] | None:
    """The flax leaf name and shape of a module's weight: a Linear's
    kernel (in, out), a Conv's (k..., in, out), an Embedding's (num, dim)."""
    w = module.weight
    if isinstance(module, nn.Linear):
        return "kernel", (w.shape[1], w.shape[0])
    if isinstance(module, (nn.Conv1d, nn.Conv2d, nn.Conv3d)):
        return "kernel", tuple(w.shape[2:]) + (w.shape[1], w.shape[0])
    if isinstance(module, nn.Embedding):
        return "embedding", tuple(w.shape)
    return None


def _column_forward(module: nn.Module, mesh: Mesh):
    """The forward of a column-parallel module: its slice of the output
    features, all-gathered over the model group, then the whole bias."""
    size, group = mesh.shape["model"], mesh.model_group
    bias = module.bias if hasattr(module, "bias") else None

    if isinstance(module, nn.Linear):
        def fwd(x):
            y = _all_gather_cat(F.linear(x, module.weight), size, group, -1)
            return y if bias is None else y + bias
    elif isinstance(module, nn.Embedding):
        def fwd(x):
            return _all_gather_cat(F.embedding(x, module.weight), size, group, -1)
    else:
        conv = module._conv_forward

        def fwd(x):
            y = _all_gather_cat(conv(x, module.weight, None), size, group, 1)
            if bias is None:
                return y
            return y + bias.view((1, -1) + (1,) * (y.dim() - 2))
    return fwd


def shard_params(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Make `module`'s Linear / Conv / Embedding submodules column-parallel
    over the model group where `_kernel_spec` shards their kernel (in
    place; returns the module). `_kernel_spec` shards nothing with one
    model rank."""
    with torch.inference_mode(False), torch.no_grad():
        _shard_modules(module, mesh, mesh.shape["model"])
    return module


def _shard_modules(module: nn.Module, mesh: Mesh, size: int) -> None:
    for sub in module.modules():
        leaf = _flax_leaf(sub) if hasattr(sub, "weight") else None
        if leaf is None or getattr(sub, "_tp_full_out", None) is not None:
            continue
        if not _kernel_spec(leaf[0], leaf[1], size):
            continue
        w = sub.weight
        dim = 1 if isinstance(sub, nn.Embedding) else 0
        share = w.shape[dim] // size
        part = w.detach().narrow(dim, mesh.model_index * share, share).clone()
        sub._tp_full_out = (dim, w.shape[dim])
        sub.weight = nn.Parameter(part, requires_grad=w.requires_grad)
        sub.forward = _column_forward(sub, mesh)


def unshard_params(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Undo `shard_params`: all-gather each sharded weight over the model
    group and restore the module's own forward (in place)."""
    with torch.inference_mode(False), torch.no_grad():
        for sub in module.modules():
            full = getattr(sub, "_tp_full_out", None)
            if full is None:
                continue
            w = _all_gather_cat(sub.weight.detach(), mesh.shape["model"], mesh.model_group,
                                full[0])
            sub.weight = nn.Parameter(w, requires_grad=sub.weight.requires_grad)
            del sub.forward, sub._tp_full_out
    return module
