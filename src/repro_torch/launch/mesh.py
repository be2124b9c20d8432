"""Production and debug meshes, and local multi-rank runs.

Port of ``repro/launch/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names over an initialised process group, one rank a device:

  production  ("data", "model") 16 × 16 = 256 ranks a pod; multi-pod adds a
              leading 2-pod axis ("pod", "data", "model"), 512 ranks;
  debug       ("data", "model") (1, n) over the group's n ranks.

Defined as functions, not module constants, so importing this module
touches no process group.  ``make_mesh`` raises when the group's world size
is not the mesh's size: no mesh silently stands on fewer ranks.

``run_ranks`` runs a function on n local ranks (spawned processes joined by
a ``file://`` store), for tests on the CPU with gloo and for one card's
multi-rank checks.
"""

from __future__ import annotations

import math
import multiprocessing
import os
import queue
import time
import traceback
import uuid

import torch
import torch.distributed as dist


def make_mesh(shape, axis_names, *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axis_names`` over the whole
    initialised process group."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the process group "
                         f"has WORLD_SIZE {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axis_names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16×16 = 256 ranks a pod; multi-pod adds a leading 2-pod axis (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_debug_mesh(n_devices: int | None = None, *, device_type: str = "cuda"):
    """A (1, n) ("data", "model") mesh over the group's n ranks."""
    n = n_devices or dist.get_world_size()
    return make_mesh((1, n), ("data", "model"), device_type=device_type)


def rank_device(dev: torch.device) -> torch.device:
    """This rank's card (``LOCAL_RANK`` over the cards), or ``dev``."""
    if dev.type != "cuda":
        return dev
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    return torch.device("cuda", local % torch.cuda.device_count())


def launch_mesh(dev: torch.device, *, backend: str | None = None,
                production: bool = False):
    """A launcher's mesh: (mesh or None, this rank's device, whether the
    caller owns the process group and must destroy it).

    One process (``WORLD_SIZE`` 1, no group) runs without a mesh.  On
    several ranks (an initialised group, or ``torchrun``'s environment:
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/
    ``MASTER_PORT``) the group is initialised if it is not (``backend``:
    NCCL for ranks on cards, gloo on the CPU), and the mesh is the debug
    mesh, or with ``production`` the 16 × 16 pod mesh, which needs exactly
    256 ranks."""
    world = dist.get_world_size() if dist.is_initialized() else \
        int(os.environ.get("WORLD_SIZE", "1"))
    if production and world != 256:
        raise ValueError(f"the production mesh is 16 x 16 and needs 256 ranks; WORLD_SIZE "
                         f"is {world}")
    if world == 1 and not production:
        return None, dev, False
    dev = rank_device(dev)
    own_group = not dist.is_initialized()
    if own_group:
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                rank=int(os.environ.get("RANK", "0")), world_size=world,
                                device_id=dev if dev.type == "cuda" else None)
    mesh = (make_production_mesh(device_type=dev.type) if production
            else make_debug_mesh(device_type=dev.type))
    return mesh, dev, own_group


# --------------------------------------------------------------------------
# Local multi-rank runs
# --------------------------------------------------------------------------


def _host(tree):
    """Tensors of a result tree as numpy arrays (a child's results cross
    the process boundary by pickle)."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return tree


def _rank_main(fn, rank, world, init_file, backend, threads, args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=world)
        try:
            out = _host(fn(rank, *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world_size: int, *, store_dir: str, backend: str = "gloo", args=(),
              timeout: float = 120.0, threads: int | None = 1) -> list:
    """``fn(rank, *args)`` on ``world_size`` spawned ranks of one process
    group (``backend``; a ``file://`` store in ``store_dir``); returns the
    ranks' results in rank order, tensors as numpy arrays.

    ``fn`` and ``args`` must pickle (``fn`` a module-level function).  Each
    rank runs ``threads`` intra-op threads (None: torch's default).  A rank
    that raises, or a run that passes ``timeout`` seconds, raises
    RuntimeError here with the ranks' tracebacks; every process is ended
    before this returns or raises.
    """
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_file = os.path.join(store_dir, f"store_{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, init_file, backend, threads, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    got, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        for _ in range(world_size):
            try:
                rank, ok, out = results.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                errors.append(f"timed out after {timeout} s with ranks "
                              f"{sorted(set(range(world_size)) - set(got))} outstanding")
                break
            if ok:
                got[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
    finally:
        for p in procs:
            p.join(timeout=5 if errors else max(5.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    if errors:
        raise RuntimeError("run_ranks failed: " + "\n".join(errors))
    return [got[r] for r in range(world_size)]


__all__ = ["launch_mesh", "make_debug_mesh", "make_mesh", "make_production_mesh",
           "rank_device", "run_ranks"]
