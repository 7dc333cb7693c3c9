"""Kernel-layout copies of a module's parameters."""

from __future__ import annotations

from typing import Any, Callable

import torch


class KernelLayout:
    """Caches ``build(*params)``, the copy of some parameters in the layout a
    kernel reads, and rebuilds it only when one of them has changed: replaced
    (``module.to(...)``, a new tensor) or written in place (a load, an
    optimizer step).  A call on unchanged weights returns the cached copy."""

    def __init__(self, build: Callable[..., Any]):
        self._build = build
        self._stamp = None
        self._value = None

    def get(self, *params: torch.Tensor) -> Any:
        stamp = tuple((p.device, p.data_ptr(), p._version) for p in params)
        if stamp != self._stamp:
            with torch.no_grad():
                self._value = self._build(*(p.detach() for p in params))
            self._stamp = stamp
        return self._value
