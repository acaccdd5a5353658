"""Checkpoint stores — the paper's three interruption-handling substrates.

Port of ``repro.core.checkpointing`` from jax pytrees to trees of torch
tensors: dicts, lists, tuples, named tuples and dataclasses whose leaves
are tensors.  Leaves that are not tensors ride along as they are (not
copied).

* ``InMemoryStore``   — Charm++'s Linux-shared-memory checkpoint (§II-B):
                        state pulled to host RAM.  From the card it copies
                        into pinned host memory, every leaf's copy queued
                        before one wait, so the link runs at its rate; the
                        copy back is the same in reverse.
* ``DeviceStore``     — the GPU *daemon process* checkpoint (§IV-A, CUDA
                        IPC): a second, independent copy on the tensor's
                        own device, so interruption handling never crosses
                        the host link (HBM-to-HBM copy).
* ``FilesystemStore`` — the traditional shared-filesystem checkpoint
                        (Mode A in §IV-C): the host tree written with
                        ``torch.save``.

Every store reports per-stage timings; a stage on the card ends with
``torch.cuda.synchronize``, so the timer covers the copy itself.
``restore(name, device=...)`` takes the place of the reference's
``shardings=`` and, like every entry point of the port, defaults to the
card.  ``nbytes`` of the memory and device stores is the reference's for
the same tree (the sum of the leaves' bytes); the filesystem store's is
the file's size.
"""

from __future__ import annotations

import dataclasses
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.device import resolve_device


def tree_map(fn: Callable[[torch.Tensor], Any], tree):
    """``fn`` applied to every tensor leaf; the containers are rebuilt."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def tree_leaves(tree) -> List[torch.Tensor]:
    leaves: List[torch.Tensor] = []
    tree_map(leaves.append, tree)
    return leaves


def _sync(tree):
    """Wait for the cards that ``tree``'s tensors live on."""
    for dev in {t.device for t in tree_leaves(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """An independent host copy: pinned and queued from the card, a
    clone on the CPU (the port's caches are updated in place)."""
    if t.is_cuda:
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
            t, non_blocking=True)
    return t.clone()


def _to_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """An independent copy of ``t`` on ``dev``."""
    return t.to(dev, non_blocking=t.is_pinned(), copy=True)


class StageTimer:
    def __init__(self):
        self.stages: Dict[str, float] = {}

    def time(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                timer.stages[name] = timer.stages.get(name, 0.0) + (
                    time.perf_counter() - self.t0)
        return _Ctx()


class InMemoryStore:
    """Host-RAM checkpoint (Linux shm analogue).

    ``save`` copies the state into host memory; ``restore`` copies it
    onto a (possibly different) device -- the shrink/expand path of
    §II-B.
    """

    def __init__(self):
        self._data: Dict[str, Any] = {}
        self.timer = StageTimer()

    def save(self, name: str, state) -> float:
        with self.timer.time("checkpoint"):
            host = tree_map(_to_host, state)
            _sync(state)
            self._data[name] = host
        return self.timer.stages["checkpoint"]

    def restore(self, name: str, device="cuda"):
        dev = resolve_device(device)
        with self.timer.time("restore"):
            out = tree_map(lambda h: _to_device(h, dev), self._data[name])
            _sync(out)
        return out

    def exists(self, name: str) -> bool:
        return name in self._data

    def nbytes(self, name: str) -> int:
        return sum(t.nbytes for t in tree_leaves(self._data[name]))

    def drop(self, name: str):
        self._data.pop(name, None)


class DeviceStore:
    """Device-resident checkpoint replica (daemon-process analogue).

    The copy stays in device memory (a distinct buffer), so a
    checkpoint/restore never crosses the host link -- mirroring the
    paper's observation that device-local daemon copies beat host
    staging.  A store built for a ``device`` holds its copy there, host
    leaves included, as the reference's ``save`` puts every leaf on its
    device; ``device=None`` keeps each copy on its leaf's own device.
    """

    def __init__(self, device=None):
        self.device = None if device is None else resolve_device(device)
        self._data: Dict[str, Any] = {}
        self.timer = StageTimer()

    def save(self, name: str, state) -> float:
        with self.timer.time("checkpoint"):
            snap = tree_map(lambda x: _to_device(x, self.device or x.device),
                            state)
            _sync(snap)
            self._data[name] = snap
        return self.timer.stages["checkpoint"]

    def restore(self, name: str, device="cuda"):
        dev = resolve_device(device)
        with self.timer.time("restore"):
            out = tree_map(lambda x: _to_device(x, dev), self._data[name])
            _sync(out)
        return out

    def exists(self, name: str) -> bool:
        return name in self._data

    def nbytes(self, name: str) -> int:
        return sum(t.nbytes for t in tree_leaves(self._data[name]))

    def drop(self, name: str):
        self._data.pop(name, None)


class FilesystemStore:
    """Shared-filesystem checkpoint (Mode A / EFS analogue)."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.timer = StageTimer()

    def _path(self, name: str) -> Path:
        return self.root / f"{name}.ckpt"

    def save(self, name: str, state) -> float:
        with self.timer.time("checkpoint"):
            torch.save(tree_map(lambda t: t.cpu(), state), self._path(name))
        return self.timer.stages["checkpoint"]

    def restore(self, name: str, device="cuda"):
        dev = resolve_device(device)
        with self.timer.time("restore"):
            # the store's own files, which hold dataclasses of tensors
            host = torch.load(self._path(name), map_location="cpu",
                              weights_only=False)
            out = tree_map(lambda h: h.to(dev), host)
            _sync(out)
        return out

    def exists(self, name: str) -> bool:
        return self._path(name).exists()

    def nbytes(self, name: str) -> int:
        return self._path(name).stat().st_size

    def drop(self, name: str):
        self._path(name).unlink(missing_ok=True)


def make_store(kind: str, root: Optional[Path] = None):
    if kind == "memory":
        return InMemoryStore()
    if kind == "device":
        return DeviceStore()
    if kind == "filesystem":
        return FilesystemStore(
            root or Path(tempfile.gettempdir()) / "repro_torch_ckpt")
    raise ValueError(kind)
