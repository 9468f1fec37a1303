"""Shared pieces of the port's autograd Functions.

Every kernel on the differentiable path is a linear map whose adjoint is
the same hand kernel on transformed inputs, so each entry point (the
complex transform in ``dispatch.py``, the real transforms in ``fft.py``,
FastConv's maps in ``conv_kernel.py``, the polyphase FIR in
``pfb_kernel.py``) wraps its kernels in a ``torch.autograd.Function`` whose
backward calls the same entry point again: the backward runs the hand
kernels, and is itself differentiable.

A call enters its Function only where :func:`needed` says so; otherwise
the entry point runs as it does without autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["needed", "batched"]

# bound once: the check runs on every call, with or without gradients
_grad_enabled = torch.is_grad_enabled
_transforms_active = torch._C._are_functorch_transforms_active


def needed(*ts: torch.Tensor) -> bool:
    """Whether a call enters its autograd Function: gradients are being
    recorded and one of ``ts`` requires one, or a ``torch.func`` transform
    (``grad``, ``vjp``, ``vmap``) is active around the call."""

    if _grad_enabled():
        for t in ts:
            if t.requires_grad:
                return True
    return _transforms_active()


def batched(x: torch.Tensor, bdim: Optional[int], size: int, dim: int) -> torch.Tensor:
    """A ``vmap`` rule's input with its mapped dimension moved to ``dim``;
    an input that is not mapped (``bdim`` None) is expanded there."""

    if bdim is None:
        return x.unsqueeze(dim).expand(*x.shape[:dim], size, *x.shape[dim:])
    return x.movedim(bdim, dim)
