"""Process groups and the (chain, trial) device mesh.

Counterpart of ``gpcsd_tpu.parallel.mesh``.  The JAX package lays its
loops over a ``jax.sharding.Mesh`` with two axes:

- ``chain``: NUTS chains / SMC particle blocks / MAP restarts;
- ``trial``: LFP trials (likelihood terms, summed over the axis).

Here the mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with
the same two named axes, and the program is SPMD over processes, one
process (rank) per device, launched by ``torchrun`` or
``torch.multiprocessing`` with the ``spawn`` start method.  Every rank
builds the same model from the full LFP and calls the same entry point;
:func:`shard_trials` hands each rank its own block of trials.

``chain_spec``, ``trial_spec`` and ``replicated`` of the JAX module are
``PartitionSpec`` helpers for ``shard_map``.  An SPMD program states its
layout by which rows each rank computes, so they have no counterpart.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

MESH_DIMS = ("chain", "trial")


def init_distributed(coordinator=None, num_processes=None, process_id=None, backend=None):
    """Create the default process group (``torch.distributed``).

    :param coordinator: the rendezvous, an ``init_method`` URL
        (``"tcp://host:port"``, ``"file:///path"``) or ``"host:port"``.
        When None: ``"env://"`` (the variables ``torchrun`` sets), or, with
        ``num_processes=1``, an in-process store.
    :param num_processes: the world size (None: from the environment).
    :param process_id: this process's rank (None: from the environment).
    :param backend: ``"nccl"`` (the default) or ``"gloo"``, which the CPU
        takes and which must be named.

    Unlike ``jax.distributed``, a single process is not a no-op here: a
    mesh of one rank still needs a process group, so a world of size 1 is
    created.  With NCCL the process's current CUDA device is set to
    ``LOCAL_RANK`` (from ``torchrun``), else to the rank modulo the device
    count.
    """
    backend = backend or "nccl"
    kw = {}
    if coordinator is None and num_processes == 1:
        kw["store"] = dist.HashStore()
        process_id = 0 if process_id is None else process_id
    elif coordinator is None:
        kw["init_method"] = "env://"
    else:
        kw["init_method"] = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(backend, **kw)
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(
            int(local) if local is not None else dist.get_rank() % torch.cuda.device_count()
        )


def make_mesh(chain: int | None = None, trial: int | None = None, ranks=None,
              device_type: str = "cuda") -> DeviceMesh:
    """A ``(chain, trial)`` mesh over the ranks of the default group.

    If both sizes are omitted, all ranks go to the chain axis; if one is,
    it takes what the other leaves.  ``chain * trial`` may not exceed the
    number of ranks; the ranks after the first ``chain * trial`` take no
    part (the drivers return None there).  Every rank of the default group
    must call this, as every rank creates the mesh's process groups.

    :param ranks: the ranks to lay out, in order (default: all)
    :param device_type: ``"cuda"``, or ``"cpu"`` with the gloo backend
    """
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    n = len(ranks)
    if chain is None and trial is None:
        chain, trial = n, 1
    elif chain is None:
        chain = n // trial
    elif trial is None:
        trial = n // chain
    need = chain * trial
    if chain < 1 or trial < 1 or need > n:
        raise ValueError(f"mesh ({chain}x{trial}) needs {need} ranks, have {n}")
    grid = torch.tensor(ranks[:need], dtype=torch.int64).reshape(chain, trial)
    return DeviceMesh(device_type, grid, mesh_dim_names=MESH_DIMS)


def in_mesh(mesh: DeviceMesh) -> bool:
    """Whether this rank is one of the mesh's."""
    return mesh.get_coordinate() is not None


def rank_device(mesh: DeviceMesh) -> torch.device:
    """The device of this rank: the CPU, or its current CUDA device."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_trials(mesh: DeviceMesh, Y):
    """This rank's block of the ``(ntrials, nx, nt)`` trial batch, the trial
    axis zero-padded to a multiple of the mesh's ``trial`` size
    (:func:`pad_to_multiple`), as a float64 tensor on :func:`rank_device`.
    The SPMD counterpart of ``device_put`` with ``P("trial")``."""
    if isinstance(Y, torch.Tensor):
        Y = Y.detach().cpu().numpy()
    n_trial = mesh.shape[MESH_DIMS.index("trial")]
    Yp, _ = pad_to_multiple(np.asarray(Y, dtype=np.float64), n_trial)
    block = Yp.shape[0] // n_trial
    i = mesh.get_local_rank("trial")
    return torch.as_tensor(Yp[i * block:(i + 1) * block], device=rank_device(mesh))


def pad_to_multiple(Y, multiple: int, axis: int = 0):
    """Zero-pad the trial axis so it divides the mesh axis; returns
    (padded, true_count).  Zero trials contribute zero to the quad form, and
    the log-determinant term uses the true count, so padding is exact."""
    n = Y.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return Y, n
    pad = [(0, 0)] * Y.ndim
    pad[axis] = (0, rem)
    return np.pad(np.asarray(Y), pad), n
