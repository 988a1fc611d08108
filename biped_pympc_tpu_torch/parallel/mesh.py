"""The env batch split over ranks with torch.distributed (twin of
`biped_pympc_tpu/parallel/mesh.py`).

The JAX package shards the env batch over a device mesh. Here the mesh is a
process group: each rank is one process that owns a contiguous shard of the
envs, and their state, on its own device (the card `cuda:<local rank>`, or
the CPU when asked). Every env's MPC solve is independent, so the sharded
step has no collective on its hot path: on the card each rank's step is one
replay of its core's captured `control_step`. Only metrics cross ranks: with
metrics, the mean cost and the hybrid's counters are summed in one
all-reduce after the replay, and `metrics_summary` gathers a (B,) metric.

On the card, start one process per card with torchrun, which sets RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT:

    torchrun --nproc_per_node=4 -m biped_pympc_tpu_torch.examples.train_rl_mpc_tpu --mesh

and in each process `torch.distributed.init_process_group("nccl")` before
`make_mesh()`. On the CPU the group is "gloo" and `make_mesh("cpu")`.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from biped_pympc_tpu_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the group: its rank, the number of ranks and the
    device its shard lives on; `group` None is the default process group."""

    rank: int
    world: int
    device: torch.device
    group: object = None


def make_mesh(device=None, group=None) -> Mesh:
    """The mesh of the initialized process group `group` (None: the
    default). `device` None is the card of this rank's local rank
    (LOCAL_RANK, as torchrun sets it, else the rank modulo the visible
    cards); pass "cpu" for a gloo group on the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "torch.distributed.init_process_group first")
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device=\"cpu\" for a gloo "
                               "group on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        device = torch.device("cuda", local)
    return Mesh(rank, world, torch.device(device), group)


def shard_range(batch: int, mesh: Mesh) -> tuple[int, int]:
    """[lo, hi) of this rank's contiguous shard of `batch` envs; the batch
    must split evenly over the ranks."""
    if batch % mesh.world:
        raise ValueError(f"a batch of {batch} envs does not split evenly over {mesh.world} ranks")
    n = batch // mesh.world
    return mesh.rank * n, (mesh.rank + 1) * n


def shard_state(tree, mesh: Mesh):
    """This rank's shard of every tensor of `tree` (a tensor, or dataclasses,
    tuples and lists of them, each with the global env batch as its leading
    axis), on the mesh's device."""
    def take(t):
        lo, hi = shard_range(t.shape[0], mesh)
        return t[lo:hi].to(mesh.device)
    return tree_map(take, tree)


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's shard of `t`, concatenated in rank order along axis 0."""
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts)


def controller_step(core, mesh: Mesh, with_metrics: bool = False):
    """The sharded control step of a `BipedControllerCore` built on the
    mesh's device: step(state, obs, twist, height) runs `core.control_step`
    on this rank's shard (the state's, obs's, twist's and height's leading
    axis are the shard's envs) and returns (tau, MpcOutput), with no
    collective. On the card that is one replay of the core's captured graph
    for the shard's batch (the JAX step jits it under `shard_map`); with
    gloo on the CPU it runs eagerly. The hybrid's counters are per shard, so
    they are dropped there (`mesh.py:87-102`). With `with_metrics` it also
    returns the global mean cost (the mean of the shards' means) or, in the
    hybrid mode, (mean cost, counters summed over ranks), the counters moved
    out of the MpcOutput: both in one all-reduce after the replay, outside
    the graph, the counters carried in the cost's dtype (exact below 2^24
    envs)."""
    if core.device != mesh.device:
        raise ValueError(f"the controller runs on {core.device}, the mesh's shard on "
                         f"{mesh.device}")

    def step(state, obs, twist, height):
        tau, out = core.control_step(state, obs, twist, height)
        counts, out.hybrid_counts = out.hybrid_counts, None
        if not with_metrics:
            return tau, out
        cost = out.cost.mean()[None]
        packed = cost if counts is None else torch.cat([cost, counts.to(cost.dtype)])
        dist.all_reduce(packed, group=mesh.group)
        mean_cost = packed[0] / mesh.world
        if counts is None:
            return tau, out, mean_cost
        return tau, out, (mean_cost, packed[1:].to(counts.dtype))

    return step


def metrics_summary(values: torch.Tensor, mesh: Mesh) -> dict:
    """{"mean", "max", "p50"} of a sharded (B,) metric over the global
    batch, each a 0-d tensor; p50 interpolates between the two middle
    values of an even count, as `jnp.median` does."""
    v = all_gather(values, mesh)
    return {"mean": v.mean(), "max": v.amax(), "p50": torch.quantile(v, 0.5)}
