"""Multi-process runs over ``torch.distributed`` (port of
``thunder_tpu.parallel.distributed``; the reference's MPI ranks,
src/Parallel.cpp:17-67, and per-rank particle ranges,
src/Database.cpp:621-645).

Every rank runs the same program on its own slots of the half-plane
layout (``local_plane_rows``) and on its own device. The collectives below
are the ones the optimiser needs; without a process group (one process)
each returns its input, so the single-process path calls them too.

- ``maybe_initialize`` joins the group from explicit arguments, from
  torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
  MASTER_ADDR / MASTER_PORT through ``env://``) or from the JAX package's
  (JAX_COORDINATOR_ADDRESS as host:port, JAX_NUM_PROCESSES,
  JAX_PROCESS_ID); torchrun's win where both are set. The backend is
  ``nccl`` when every rank on the host has a GPU of its own and ``gloo``
  otherwise: on the CPU, or with more ranks than GPUs (NCCL refuses two
  ranks on one device). Under gloo the collectives stage CUDA tensors
  through host memory; the compute stays on the card.
- ``all_reduce_sum`` / ``all_reduce_max``, ``broadcast``, ``gather_plane``
  (the global (2, S, ...) plane on every rank, the counterpart of
  ``host_np``) and the object collectives.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# a rank that fails leaves its peers waiting at their next collective for
# this long, not for torch's default of 30 minutes
TIMEOUT = datetime.timedelta(minutes=5)


def launch_settings(coordinator=None, num_processes=None, process_id=None,
                    env=None):
    """The multi-process launch this process belongs to, as a dict
    (init_method, world, rank, local_rank, local_world), or None for a
    single process. Explicit arguments win over the environment."""
    env = os.environ if env is None else env
    torchrun = "RANK" in env and "WORLD_SIZE" in env
    if coordinator is None:
        coordinator = ("env://" if torchrun
                       else env.get("JAX_COORDINATOR_ADDRESS"))
    if num_processes is None:
        num_processes = env.get("WORLD_SIZE" if torchrun
                                else "JAX_NUM_PROCESSES")
    if process_id is None:
        process_id = env.get("RANK" if torchrun else "JAX_PROCESS_ID")
    if num_processes is None:
        if coordinator is not None:
            raise ValueError(f"coordinator {coordinator!r} is set but not "
                             "the number of processes (WORLD_SIZE or "
                             "JAX_NUM_PROCESSES)")
        return None
    world = int(num_processes)
    if world <= 1:
        return None
    if coordinator is None or process_id is None:
        raise ValueError(f"a launch of {world} processes needs a coordinator "
                         "address and this process's id")
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    rank = int(process_id)
    # the JAX package's variables name no host: a launch that sets
    # LOCAL_WORLD_SIZE runs that many consecutive ranks a host, else it is
    # taken to run every rank on this one
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    return dict(init_method=coordinator, world=world, rank=rank,
                local_rank=int(env.get("LOCAL_RANK", rank % local_world)),
                local_world=local_world)


def maybe_initialize(coordinator=None, num_processes=None, process_id=None,
                     cpu=False):
    """Join the process group when the launch has several processes (see
    ``launch_settings``); return this rank's device: the CPU with ``cpu``,
    else ``cuda:(local rank % device count)``. Raises when the caller asks
    for CUDA and there is none."""
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on the CPU with --cpu")
    launch = launch_settings(coordinator, num_processes, process_id)
    if launch is None:
        return torch.device("cpu" if cpu else "cuda")
    if cpu:
        device, backend = torch.device("cpu"), "gloo"
    else:
        n_dev = torch.cuda.device_count()
        device = torch.device("cuda", launch["local_rank"] % n_dev)
        torch.cuda.set_device(device)
        backend = "nccl" if launch["local_world"] <= n_dev else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=launch["init_method"],
                                world_size=launch["world"],
                                rank=launch["rank"], timeout=TIMEOUT)
    return device


def shutdown():
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def rank():
    return dist.get_rank() if dist.is_initialized() else 0


def is_main():
    """True on the rank that writes the run's files (rank 0)."""
    return rank() == 0


def backend():
    """The group's backend name, None for a single process."""
    return dist.get_backend() if dist.is_initialized() else None


def split_sizes(s, world):
    """Slots per rank of a plane of ``s`` slots: ``np.array_split``'s
    uneven split (the draws keep the global shape, so S is not padded)."""
    return [len(a) for a in np.array_split(np.arange(s), world)]


def local_plane_rows(s, world, index):
    """Rank ``index``'s slot range of the (2, S, ...) half-plane layout of
    a ``world``-rank run, as a slice of the S axis (both halves' rows: the
    data axis is split, the half axis is not)."""
    sizes = split_sizes(s, world)
    lo = sum(sizes[:index])
    return slice(lo, lo + sizes[index])


def _comm_device():
    """Where the backend takes its tensors: the rank's card under nccl,
    host memory under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _real(x):
    return torch.view_as_real(x.contiguous()) if x.is_complex() else x


def _collective(x, op):
    """``op`` in place on a contiguous real copy of ``x`` on the backend's
    device; the result comes back on ``x``'s device and dtype."""
    buf = _real(x).to(_comm_device(), copy=True).contiguous()
    op(buf)
    out = buf.to(x.device)
    return torch.view_as_complex(out) if x.is_complex() else out


def all_reduce_sum(x):
    """The sum of tensor ``x`` over the ranks, on every rank."""
    if world_size() == 1:
        return x
    return _collective(x, lambda b: dist.all_reduce(b, dist.ReduceOp.SUM))


def all_reduce_max(x):
    """The element-wise maximum of real tensor ``x`` over the ranks."""
    if world_size() == 1:
        return x
    return _collective(x, lambda b: dist.all_reduce(b, dist.ReduceOp.MAX))


def broadcast(x, src=0):
    """Rank ``src``'s tensor ``x`` on every rank."""
    if world_size() == 1:
        return x
    return _collective(x, lambda b: dist.broadcast(b, src))


def gather_plane(x, s):
    """This rank's rows (2, s_loc, ...) of a plane of ``s`` slots -> the
    global (2, s, ...) tensor on every rank, on ``x``'s device."""
    world = world_size()
    if world == 1:
        return x
    sizes = split_sizes(s, world)
    xr = _real(x).to(_comm_device())
    pad = xr.new_zeros((xr.shape[0], max(sizes)) + xr.shape[2:])
    pad[:, :xr.shape[1]] = xr
    parts = [torch.empty_like(pad) for _ in range(world)]
    dist.all_gather(parts, pad)
    out = torch.cat([p[:, :m] for p, m in zip(parts, sizes)], dim=1)
    out = out.to(x.device)
    return torch.view_as_complex(out) if x.is_complex() else out


def broadcast_object(obj, src=0):
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def all_gather_object(obj):
    """Every rank's picklable ``obj``, in rank order, on every rank."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out
