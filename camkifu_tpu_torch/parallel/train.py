"""Training of the neural stone classifier over several processes (port of
camkifu_tpu/parallel/train.py): data parallel over a "data" axis, the two
dense layers split over a "model" axis.

- **dp**: each batch splits by rows over "data"; the gradients are summed
  over the data group by explicit ``all_reduce`` and averaged.
- **tp**: ``Dense_0``'s kernel is split by columns (its bias by the same
  slices), ``Dense_1``'s by rows, Megatron-style: each rank computes its
  slice of the hidden layer and a partial product of the output, and one
  sum over the model group (``torch.distributed.nn.functional
  .all_reduce``, which autograd differentiates) completes the forward.
  The convolutions and ``Dense_1``'s bias are replicated.

Ranks are laid out as the reference lays out devices: rank r sits at
("data", "model") = (r // mp, r % mp). The caller starts the processes
and their group (``process_group``, or ``torch.distributed`` directly):
NCCL takes one rank a card, gloo runs the layout on the CPU.

    python -m camkifu_tpu_torch.models.neural --sharded            # 1 card
    torchrun --nproc_per_node 4 -m camkifu_tpu_torch.models.neural \\
        --sharded --device cpu                                     # gloo
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.nn.functional import all_reduce

from camkifu_tpu_torch.config import cvconf
from camkifu_tpu_torch.models import neural


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the ("data", "model") layout and the groups
    of its row and column."""

    shape: dict                   # {"data": dp, "model": mp}
    data_index: int
    model_index: int
    data_group: object            # the ranks sharing this model index
    model_group: object           # the ranks sharing this data index


def make_mesh(devices_or_world=None, model_parallel: int = 2) -> Mesh:
    """The ("data", "model") layout of the initialized default group:
    ``devices_or_world`` is its world size or a sequence of that length
    (None: the group's). ``model_parallel`` falls back to 1 where it does
    not divide the world or exceeds it, as in the reference. Every rank
    must call it (each builds every group)."""
    world = dist.get_world_size()
    n = world if devices_or_world is None else (
        devices_or_world if isinstance(devices_or_world, int)
        else len(devices_or_world))
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    mp = model_parallel if n % model_parallel == 0 and n >= model_parallel \
        else 1
    dp = n // mp
    rank = dist.get_rank()
    model_groups = [dist.new_group(list(range(d * mp, (d + 1) * mp)))
                    for d in range(dp)]
    data_groups = [dist.new_group(list(range(m, n, mp))) for m in range(mp)]
    return Mesh({"data": dp, "model": mp}, rank // mp, rank % mp,
                data_groups[rank % mp], model_groups[rank // mp])


def param_sharding(params, mesh: Mesh) -> dict:
    """Partition specs of a flax-layout tree (``neural.params_to_jax``),
    one tuple a leaf naming the mesh axis each dimension is split over:
    ``Dense_0``'s kernel (None, "model") and bias ("model",), ``Dense_1``'s
    kernel ("model", None), every other leaf replicated. Raises where the
    model axis does not divide a split dimension."""
    mp = mesh.shape["model"]

    def spec(layer, a):
        nd = np.ndim(a)
        out = {("Dense_0", 2): (None, "model"), ("Dense_0", 1): ("model",),
               ("Dense_1", 2): ("model", None)}.get((layer, nd), (None,) * nd)
        for size, axis in zip(np.shape(a), out):
            if axis == "model" and size % mp:
                raise ValueError(f"{layer}: {size} does not split {mp} ways")
        return out

    return {"params": {layer: {leaf: spec(layer, a)
                               for leaf, a in leaves.items()}
                       for layer, leaves in params["params"].items()}}


class ShardedPatchNet(neural.PatchNet):
    """``neural.PatchNet`` holding this rank's slices of ``Dense_0`` and
    ``Dense_1`` (``param_sharding``); the trunk, the casts to bf16 and the
    bias order are PatchNet's. Made by ``shard_model``."""

    def __init__(self, mesh: Mesh, features: int = 32,
                 zone: int = cvconf.zone_size):
        super().__init__(features, zone)
        part = 4 * features // mesh.shape["model"]
        meta = {"device": "meta"}
        self.Dense_0 = nn.Linear((zone // 4) ** 2 * 2 * features, part,
                                 **meta)
        self.Dense_1 = nn.Linear(part, neural.NUM_CLASSES, **meta)
        self.mesh = mesh

    def head(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's hidden slice and its partial product of the
        logits, summed over the model group in float32 (the sum of two
        bf16 partials is exact there, so rounding it to bf16 is the bf16
        sum), then ``Dense_1``'s bias, as PatchNet adds it."""
        bf = torch.bfloat16
        x = F.relu(F.linear(flat, self.Dense_0.weight.to(bf))
                   + self.Dense_0.bias.to(bf))
        part = F.linear(x, self.Dense_1.weight.to(bf)).to(torch.float32)
        x = all_reduce(part, group=self.mesh.model_group).to(bf) \
            + self.Dense_1.bias.to(bf)
        return x.to(torch.float32)

    def sharded_parameters(self) -> list:
        return [self.Dense_0.weight, self.Dense_0.bias, self.Dense_1.weight]

    def full_tree(self) -> dict:
        """The whole net's flax-layout tree of float32 numpy arrays, each
        split leaf gathered over the model group. Every rank of the group
        must call it."""
        local = neural.params_to_jax(self)
        specs = param_sharding(local, self.mesh)["params"]
        mp = self.mesh.shape["model"]
        dev = self.Dense_0.weight.device
        out = {}
        for layer, leaves in local["params"].items():
            out[layer] = {}
            for leaf, a in leaves.items():
                spec = specs[layer][leaf]
                if "model" in spec:
                    t = torch.from_numpy(a).to(dev)
                    parts = [torch.empty_like(t) for _ in range(mp)]
                    dist.all_gather(parts, t, group=self.mesh.model_group)
                    a = torch.cat(parts, dim=spec.index("model")).cpu() \
                        .numpy()
                out[layer][leaf] = a
        return {"params": out}


def shard_model(model: neural.PatchNet, mesh: Mesh) -> ShardedPatchNet:
    """This rank's ``ShardedPatchNet`` of a whole PatchNet (the same on
    every rank), on the model's device: each split leaf sliced at the
    rank's model index."""
    tree = neural.params_to_jax(model)
    specs = param_sharding(tree, mesh)["params"]
    mp, m = mesh.shape["model"], mesh.model_index
    local = {}
    for layer, leaves in tree["params"].items():
        local[layer] = {}
        for leaf, a in leaves.items():
            spec = specs[layer][leaf]
            if "model" in spec:
                a = np.split(a, mp, axis=spec.index("model"))[m]
            local[layer][leaf] = a
    f = model.Conv_0.out_channels
    # Dense_0 reads the (zone / 4)² · 2f pooled features.
    zone = 4 * math.isqrt(model.Dense_0.in_features // (2 * f))
    out = ShardedPatchNet(mesh, f, zone).to_empty(
        device=model.Conv_0.weight.device)
    neural.copy_leaves(out, local)
    return out


def _sum_grads(params: list, group, dp: int) -> None:
    """Each gradient summed over ``group`` (None: every rank) in one
    call, then divided by the data-parallel size."""
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    flat /= dp
    i = 0
    for p in params:
        p.grad.copy_(flat[i:i + p.numel()].view_as(p))
        i += p.numel()


def make_train_step(mesh: Mesh, tx: torch.optim.Optimizer,
                    model: ShardedPatchNet):
    """One AdamW step of ``model`` (this rank's shards, stepped by ``tx``)
    on a global batch: ``train_step(patches, labels)`` takes the batch
    every rank holds, keeps this rank's rows of it, and returns the whole
    batch's (mean loss, accuracy), 0-d tensors.

    Each rank backpropagates its rows' mean loss divided by the model
    size: the forward's sum over the model group sums the model ranks'
    gradients again on the way back, so each split leaf gets its rows'
    gradient, and each replicated leaf, summed over the model group, too.
    Every gradient is then averaged over the data group."""
    dp, mp = mesh.shape["data"], mesh.shape["model"]
    split = model.sharded_parameters()
    replicated = [p for p in model.parameters()
                  if all(p is not q for q in split)]

    def train_step(patches: torch.Tensor, labels: torch.Tensor):
        if patches.shape[0] % dp:
            raise ValueError(f"a batch of {patches.shape[0]} does not split "
                             f"over {dp} data ranks")
        rows = patches.shape[0] // dp
        lo = mesh.data_index * rows
        tx.zero_grad(set_to_none=True)
        loss, acc = neural.loss_fn(model, patches[lo:lo + rows],
                                   labels[lo:lo + rows])
        (loss / mp).backward()
        _sum_grads(replicated, None, dp)
        _sum_grads(split, mesh.data_group, dp)
        tx.step()
        stats = torch.stack([loss.detach(), acc])
        dist.all_reduce(stats, group=mesh.data_group)
        stats /= dp
        return stats[0], stats[1]

    return train_step


def train_sharded(patches: torch.Tensor, labels: torch.Tensor,
                  mesh: Mesh | None = None, epochs: int = 2,
                  batch: int = 2048, lr: float = 3e-3, seed: int = 0,
                  log=None):
    """Data + model parallel training on ``patches``' device (every rank
    holds the same patches and calls it) → (this rank's ShardedPatchNet,
    the last batch's accuracy over all ranks). Batches follow numpy
    ``default_rng(seed)``'s permutation, as ``neural.train`` and the
    reference do; the net starts from ``neural.init_params`` of the seed
    on every rank."""
    from camkifu_tpu_torch.core.feeder import to_device

    mesh = mesh or make_mesh()
    dev = patches.device
    model = shard_model(neural.init_params(
        torch.Generator().manual_seed(seed), zone=patches.shape[1],
        device=dev), mesh)
    tx = neural.make_optimizer(model, lr)
    step = make_train_step(mesh, tx, model)
    n = len(patches)
    rng = np.random.default_rng(seed)
    loss = acc = torch.zeros(())
    for epoch in range(epochs):
        order = to_device(rng.permutation(n), dev)
        for i in range(0, n - batch + 1, batch):
            sel = order[i:i + batch]
            loss, acc = step(patches[sel], labels[sel])
        if log:
            log(f"epoch {epoch}: loss {float(loss):.4f} acc {float(acc):.4f}")
    return model, float(acc)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def process_group(device="cuda"):
    """This process's group, destroyed on exit → its device. Under
    ``torchrun`` (``WORLD_SIZE`` set) the group comes from the
    environment, a card a rank (``LOCAL_RANK``); otherwise it is a world
    of one on a free localhost port. NCCL on the card, gloo on the CPU;
    a backend that fails to start raises."""
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend,
                                init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)
    try:
        yield dev
    finally:
        dist.destroy_process_group()
