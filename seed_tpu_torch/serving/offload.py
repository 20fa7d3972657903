"""Host <-> device parameter offload (counterpart of
seed_tpu/serving/offload.py).

The reference's serving trick is dynamic offload: the visual tokenizer (and
the diffusion de-tokenizer) live in host memory and are moved onto the
accelerator only for the duration of an encode/decode call, so the language
model keeps the device to itself (gradio_demo/seed_llama_flask.py:53-84).

Here the params are held in pinned host memory; ``acquire()`` copies them to
the card, ``release()`` drops the device copy, which returns its memory to
PyTorch's allocator for the next prefill. The compute functions are
unchanged: they take params as arguments.

Sync contract: callers bring their results to the host (``.cpu()``) before
``release()``; every serving call site does so through its host transfer.
"""
from __future__ import annotations

import threading
from typing import Any, Optional

import torch

from .. import resolve_device
from ..utils.tree import leaves, tree_map


class OffloadedParams:
    """A param tree held on the host, swappable onto the compute device.

    Usage::

        off = OffloadedParams(params)          # host copy (pinned for CUDA)
        with off as p:                         # copy to the device
            out = fn(p, x).cpu()               # sync BEFORE exit
        # device copy dropped; its memory is free again

    Re-entrant ``with`` blocks share one device copy (refcounted), so a loop
    that calls encode_image per request under an outer acquire pays one
    swap, not N.
    """

    def __init__(self, params: Any, device="cuda"):
        self.device = resolve_device(device)
        pin = self.device.type == "cuda"

        def to_host(t: torch.Tensor) -> torch.Tensor:
            t = t.detach().to("cpu")
            return t.pin_memory() if pin else t

        self.params = tree_map(to_host, params)
        self._live: Optional[Any] = None
        self._depth = 0
        self._lock = threading.Lock()   # request threads share one wrapper
        self.swap_count = 0     # host -> device transfers (tests/telemetry)

    @property
    def resident(self) -> bool:
        return self._live is not None

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in leaves(self.params))

    def acquire(self) -> Any:
        with self._lock:
            if self._live is None:
                # device == host (CPU runs): the host tensors are the live copy
                self._live = (self.params if self.device.type == "cpu" else
                              tree_map(lambda t: t.to(self.device,
                                                      non_blocking=True),
                                       self.params))
                self.swap_count += 1
            self._depth += 1
            return self._live

    def release(self) -> None:
        with self._lock:
            if self._depth > 0:
                self._depth -= 1
            if self._depth == 0:
                self._live = None

    def __enter__(self) -> Any:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class ResidentParams:
    """No-op stand-in with the same interface, for offload=False paths:
    call sites write one code path and the flag decides the behaviour."""

    def __init__(self, params: Any, device=None):
        self.params = (params if device is None else
                       tree_map(lambda t: t.to(device), params))
        self.swap_count = 0

    @property
    def resident(self) -> bool:
        return True

    def acquire(self) -> Any:
        return self.params

    def release(self) -> None:
        pass

    def __enter__(self) -> Any:
        return self.params

    def __exit__(self, *exc) -> None:
        pass


def wrap_params(params: Any, offload: bool, device="cuda"):
    """OffloadedParams when ``offload`` else ResidentParams."""
    return (OffloadedParams(params, device=device) if offload
            else ResidentParams(params))
