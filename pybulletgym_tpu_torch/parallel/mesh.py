"""Data parallelism over the env axis on `torch.distributed`: the
counterpart of the JAX package's `parallel/mesh.py`, keeping its names.

One rank is one process with one env shard on one device. The env batch is
split into contiguous blocks over the ranks in rank order (host-major on a
``('host', 'env')`` mesh, as ranks are numbered host by host), and the
learners' parameters are replicated. Where the JAX package lets XLA insert
the collectives from sharding annotations, the port's learners call them
where they are needed (`parallel/ppo.py`, `parallel/sac.py`): gathers of
the rollout along the env axis and one gradient reduction a minibatch.
An env shard keeps its envs' global `env_id`s, so resets and auto-resets
draw the Threefry streams (keyed by seed, env_id and epoch) that the
unsharded batch draws, and a sharded env step is bitwise the slice of the
unsharded one.

The backend follows the devices: NCCL when every rank has a GPU of its
own, gloo on the CPU or when ranks share a card (gloo carries CUDA tensors
through the host; NCCL refuses two ranks on one device). Asking for NCCL
where ranks share a card raises.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: the world size, its rank, the axis
    names and sizes (``('env',)`` or ``('host', 'env')``), its device and the
    process group the collectives run on."""

    world: int
    rank: int
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    device: torch.device
    group: Any = None

    def block(self, batch_size: int) -> Tuple[int, int]:
        """[lo, hi): this rank's envs in a global batch of `batch_size`."""
        if batch_size % self.world:
            raise ValueError(f"batch {batch_size} does not split over {self.world} ranks")
        b = batch_size // self.world
        return self.rank * b, (self.rank + 1) * b


def _cuda_slot(local_rank: int, local_world: int) -> Tuple[torch.device, bool]:
    """This rank's card and whether the host's ranks share cards."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("device='cuda': no CUDA device is available")
    return torch.device("cuda", local_rank % n), local_world > n


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device="cuda") -> torch.device:
    """Join the world of ranks; returns this rank's device.

    With no address, torchrun's variables say where and who this rank is
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT``): the counterpart of JAX's TPU-pod
    auto-detection. Otherwise `coordinator_address` is ``host:port``, a
    ``tcp://`` or a ``file://`` URL, and the `num_processes` ranks run on one
    host. `backend` None picks NCCL when each of the host's ranks has a card
    of its own and gloo otherwise (on the CPU, or ranks sharing cards)."""
    if coordinator_address is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"init_distributed(): no address given and {missing} unset "
                               "(start the ranks with torchrun, or pass the address)")
        init_method, rank, world = "env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    else:
        if num_processes is None or process_id is None:
            raise ValueError("init_distributed(address): give num_processes and process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        rank, world = int(process_id), int(num_processes)
        local_rank, local_world = rank, world
    dev = torch.device(device)
    if dev.type == "cuda":
        dev, shared = _cuda_slot(local_rank, local_world)
        torch.cuda.set_device(dev)
    elif dev.type == "cpu":
        shared = True
    else:
        raise ValueError(f"unsupported device {device!r}")
    if backend is None:
        backend = "gloo" if shared else "nccl"
    if backend == "nccl" and shared:
        raise ValueError("backend='nccl' needs a card for each rank: "
                         f"{local_world} ranks on {dev.type} would share devices (use gloo)")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            device_id=dev if backend == "nccl" else None)
    return dev


def _rank_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type != "cuda" and dist.get_backend() == "nccl":
        raise ValueError(f"an NCCL world runs on CUDA devices, not {dev}")
    return dev


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A 1-D ``('env',)`` mesh over every rank of the world (init_distributed
    first). `n_devices`, if given, must be the world size. The device is the
    rank's card (set by init_distributed) unless the caller asks for the CPU."""
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}): the mesh spans the world's {world} ranks")
    return Mesh(world, dist.get_rank(), ("env",), (world,), _rank_device(device),
                dist.group.WORLD)


def make_mesh_2d(n_hosts: Optional[int] = None, device="cuda") -> Mesh:
    """A ``('host', 'env')`` mesh: the env batch splits over both axes,
    host-major (rank r is host r // per_host), so a host's env blocks are
    neighbours. `n_hosts` defaults to the world size over torchrun's
    ``LOCAL_WORLD_SIZE`` (1 without it)."""
    world = dist.get_world_size()
    if n_hosts is None:
        n_hosts = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if n_hosts < 1 or world % n_hosts:
        raise ValueError(f"{world} ranks do not split over {n_hosts} hosts")
    return Mesh(world, dist.get_rank(), ("host", "env"), (n_hosts, world // n_hosts),
                _rank_device(device), dist.group.WORLD)


# ---------------------------------------------------------------------------
# env state: shard, gather
# ---------------------------------------------------------------------------


def _map_state(state, fn):
    return type(state)(*[{k: fn(x) for k, x in f.items()} if isinstance(f, dict) else fn(f)
                         for f in state])


def _state_tensors(state) -> List[torch.Tensor]:
    return [x for f in state for x in ([f[k] for k in sorted(f)] if isinstance(f, dict) else [f])]


def shard_env_state(state, mesh: Mesh):
    """This rank's contiguous block of a global `EnvState` along the trailing
    env axis, on the rank's device. `env_id` keeps its global values."""
    lo, hi = mesh.block(state.q.shape[-1])
    return _map_state(state, lambda x: x[..., lo:hi].contiguous().to(mesh.device))


def all_gather_env(xs: Sequence[torch.Tensor], mesh: Mesh, dims: Sequence[int]):
    """Every rank's block of each tensor of `xs`, joined in rank order along
    that tensor's env axis `dims[i]`: one all_gather of one flat buffer. The
    tensors share one dtype and have the same shapes on every rank."""
    flat = torch.cat([x.reshape(-1) for x in xs])
    parts = [torch.empty_like(flat) for _ in range(mesh.world)]
    dist.all_gather(parts, flat, group=mesh.group)
    sizes = [x.numel() for x in xs]
    split = [p.split(sizes) for p in parts]
    return [torch.cat([s[i].view(x.shape) for s in split], dim=d)
            for i, (x, d) in enumerate(zip(xs, dims))]


def global_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows `x` (b, ...) at their block of a (b * world, ...)
    tensor of zeros. A product over it has the global batch's shape, so the
    library picks the kernel that the unsharded product gets, and each of
    this rank's rows rounds as it does there (PPO's rollout)."""
    b = x.shape[0]
    full = x.new_zeros((b * mesh.world, *x.shape[1:]))
    full[mesh.rank * b:(mesh.rank + 1) * b] = x
    return full


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A 4-byte (or bool) tensor as int32 for transport, bit for bit."""
    return x.to(torch.int32) if x.dtype == torch.bool else x.view(torch.int32)


def _unbits(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(torch.bool) if dtype == torch.bool else x.view(dtype)


def gather_env_state(state, mesh: Mesh):
    """The global `EnvState` from every rank's shard (the inverse of
    `shard_env_state`), on every rank, bit for bit."""
    leaves = _state_tensors(state)
    for x in leaves:
        if x.element_size() != 4 and x.dtype != torch.bool:
            raise TypeError(f"gather_env_state: {x.dtype} is not a 4-byte or bool dtype")
    full = iter([_unbits(g, x.dtype) for g, x in zip(
        all_gather_env([_bits(x) for x in leaves], mesh, [-1] * len(leaves)), leaves)])
    return type(state)(*[{k: next(full) for k in sorted(f)} if isinstance(f, dict) else next(full)
                         for f in state])


# ---------------------------------------------------------------------------
# replicated learner state
# ---------------------------------------------------------------------------


def _replicas(tree):
    """The tensors and generators of a learner state, in a fixed order."""
    if isinstance(tree, (torch.Tensor, torch.Generator)):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _replicas(tree[k])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _replicas(x)


@torch.no_grad()
def shard_params(params, mesh: Mesh):
    """Replicate a learner state over the mesh: every tensor (and each
    generator's state) broadcast from rank 0, in place. Returns `params`.
    A tensor that is not contiguous (a checkpoint's column-major leaf)
    crosses as a contiguous copy: NCCL takes no other."""
    for x in _replicas(params):
        if isinstance(x, torch.Generator):
            buf = x.get_state().to(mesh.device)
            dist.broadcast(buf, 0, group=mesh.group)
            x.set_state(buf.cpu())
        else:
            buf = x.data.contiguous()
            dist.broadcast(buf, 0, group=mesh.group)
            if buf.data_ptr() != x.data_ptr():
                x.data.copy_(buf)
    return params


replicated = shard_params  # the JAX package's two names for one placement


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------


def _rank_main(fn, rank, world, init_method, device, backend, args, results):
    try:
        init_distributed(init_method, world, rank, backend=backend, device=device)
        results.put((rank, True, fn(*args)))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, world: int, *args, device="cuda", backend: Optional[str] = None,
           timeout: float = 900.0) -> list:
    """Run ``fn(*args)`` in `world` new processes (the spawn start method),
    one rank each, after `init_distributed` joined them through a file store
    in a fresh temporary directory (no port to agree on). Returns the ranks'
    return values in rank order. `fn` must be a module-level function and
    return what pickles without CUDA (numbers, numpy arrays, CPU tensors).
    Raises with the failing rank's traceback if a rank fails, dies or runs
    past `timeout` seconds; the other ranks are then killed."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, init, device, backend, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out, deadline = {}, time.monotonic() + timeout
        try:
            while len(out) < world:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                            and r not in out]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} before reporting")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"launch: ranks {sorted(set(range(world)) - set(out))} "
                                           f"did not finish in {timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world)]
