"""Deterministic synthetic LM data pipeline.

Port of ``repro.data.pipeline``.  Goals: (a) reproducible across
restarts: a shrink/expand or spot interruption resumes on exactly the
batch it would have seen (the elastic tests assert continuity); (b) the
same batches as the reference, bit for bit: ``SyntheticLM.batch_at`` is
the reference's numpy code (sorted keys, ``SeedSequence([seed, step,
i])`` per key, the same shapes and dtypes); (c) prefetchable.

numpy has no bf16 without ``ml_dtypes``, so a bf16 leaf (an enc_dec
model's ``frames``, a vlm model's ``patch_embeds``) comes back as a CPU
``torch.bfloat16`` tensor: the reference's float32 numpy draw rounded to
bf16 by torch, round-to-nearest-even as ``ml_dtypes`` rounds it, so its
bits are the reference's.  Integer leaves stay numpy arrays.

The "dataset" is a deterministic token stream keyed by (seed, step): a
counter-mode PRNG, so batch(step) never depends on history.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import batch_spec

# a host batch's leaf: numpy int32, or a CPU bf16 tensor
Leaf = Union[np.ndarray, torch.Tensor]


class SyntheticLM:
    """Counter-mode synthetic batches matching ``batch_spec(cfg, shape)``."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.spec = batch_spec(cfg, shape)

    def batch_at(self, step: int) -> Dict[str, Leaf]:
        """Integer leaves as numpy int32, bf16 leaves as CPU bf16 tensors
        (see the module's docstring)."""
        out = {}
        for i, (k, v) in enumerate(sorted(self.spec.items())):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, i]))
            if v.dtype == torch.int32:
                out[k] = rng.integers(0, self.cfg.vocab_size, v.shape,
                                      dtype=np.int32)
            else:
                out[k] = torch.from_numpy(rng.standard_normal(
                    v.shape, dtype=np.float32)).to(v.dtype)
        return out

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, Leaf]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy arrays or CPU tensors) -> tensors on
    ``device``, copied on the calling thread's current stream: a copy
    from pinned memory is queued there without a wait, and the work
    queued after it on that stream reads it landed."""
    dev = resolve_device(device)
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
        out[k] = t.to(dev, non_blocking=t.is_pinned())
    return out


class Prefetcher:
    """Background-thread prefetch of host batches.

    The thread makes each batch (pinned, where ``device`` is a card, so
    the copy can be asynchronous); ``next`` copies it to ``device`` on
    the caller's thread and current stream, so no copy issued from
    another thread's stream is ever read before it lands.  Without a
    ``device``, ``next`` returns the host (numpy) batch."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 device=None, depth: int = 2):
        self.source = source
        self.device = None if device is None else resolve_device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        pin = self.device is not None and self.device.type == "cuda"
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            if pin:
                batch = {k: torch.as_tensor(v).pin_memory()
                         for k, v in batch.items()}
            try:
                self._q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def next(self):
        step, batch = self._q.get()
        if self.device is not None:
            batch = to_device(batch, self.device)
        return step, batch

    def stop(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
