"""Process groups for the port's multi-rank paths.

The reference's ranks are the XLA devices of one process; the port's are
processes joined by ``torch.distributed``.  This module (the port's own,
no counterpart in ``repro``) starts and ends them:

* ``backend_for(device)``: ``nccl`` for ``cuda``, ``gloo`` for ``cpu``.
  The backend follows the device; a caller may name another one (gloo
  ranks sharing one card), and nothing switches it on failure.
* ``process_group(rank, world, init_method, device)``: a context manager
  that starts the default group and destroys it in ``finally``.  With
  NCCL each rank takes card ``rank`` of its host (NCCL cannot put two
  ranks on one card), and asking for more ranks than cards raises.
* ``file_rendezvous(directory)``: a ``file://`` init method under a
  directory of the caller's (never a fixed TCP port).
* ``spawn(fn, world, *args, device=..., timeout=..., what=...)``:
  ``world`` ranks started with the ``spawn`` method (never ``fork``),
  each running ``fn(rank, world, device, *args)`` inside
  ``process_group``; raises if a rank fails, and with ``timeout`` kills
  a group that outlives it and raises ``TimeoutError`` naming ``what``.
* ``torchrun_env()``: ``(rank, world)`` when the process runs under
  ``torchrun``'s environment, else ``None``.

The group of the first ``n`` ranks that the elastic runtime trains on is
the ``data`` group of ``launch.mesh.make_mesh((n, 1), ...)``'s mesh.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import tempfile
import time
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# A collective that waits longer than this raises instead of hanging.
TIMEOUT = datetime.timedelta(seconds=300)


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def file_rendezvous(directory) -> str:
    """A ``file://`` init method: a file that does not exist yet under
    ``directory`` (every rank of one group passes the same string)."""
    path = Path(directory) / "rendezvous"
    if path.exists():
        raise FileExistsError(f"{path}: a rendezvous file is used once")
    return f"file://{path}"


def torchrun_env() -> Optional[Tuple[int, int]]:
    """``(RANK, WORLD_SIZE)`` under ``torchrun`` (which also sets
    ``MASTER_ADDR`` / ``MASTER_PORT`` for ``env://``), else ``None``."""
    keys = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
    if not all(k in os.environ for k in keys):
        return None
    return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])


@contextlib.contextmanager
def process_group(rank: int, world: int, init_method: str, device="cuda",
                  backend: Optional[str] = None, timeout=TIMEOUT):
    """The default process group for the life of the ``with`` block.

    ``device`` picks the backend (``backend_for``) unless ``backend`` is
    given.  Under NCCL, rank ``r`` takes card ``LOCAL_RANK`` (``r`` when
    unset).  Yields the rank's device."""
    backend = backend or backend_for(device)
    dev = resolve_device(device)
    if dev.type == "cuda" and backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        if local >= torch.cuda.device_count():
            raise ValueError(
                f"NCCL rank {rank} needs card {local}, but "
                f"{torch.cuda.device_count()} are present (NCCL cannot put "
                f"two ranks on one card; gloo ranks can share one)")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=timeout)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def _run_rank(rank, fn, world, init_method, device, backend, args):
    with process_group(rank, world, init_method, device, backend) as dev:
        fn(rank, world, dev, *args)


def spawn(fn, world: int, *args, device="cuda", backend=None,
          timeout: Optional[float] = None, what: Optional[str] = None):
    """Run ``fn(rank, world, device, *args)`` in ``world`` new processes
    (the ``spawn`` start method), each inside ``process_group`` over a
    ``file://`` rendezvous in a fresh temporary directory.  ``fn`` must
    be importable by name (a module-level function).  Returns when every
    rank has ended; raises if one failed.  With ``timeout`` (wall
    seconds), a group still running after it is killed, every rank, and
    ``TimeoutError`` names ``what`` (``fn``'s name by default): a hung
    collective fails the caller fast instead of waiting out
    ``TIMEOUT``."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _run_rank, args=(fn, world, file_rendezvous(tmp), device,
                             backend, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(None if deadline is None else
                           max(deadline - time.monotonic(), 0.0)):
            if deadline is not None and time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(
                    f"{what or fn.__name__}: {world} ranks still running "
                    f"after {timeout:.0f} s; killed")
