"""A kernel forward whose backward is autograd of a plain twin.

The JAX package has no backward kernel for K1, K2 or K6: each custom VJP
recomputes an XLA twin and differentiates it (small_attention.py:167-170,
fused_site.py:507-519 and :591-595). ``KernelWithTwin`` is that pattern as a
``torch.autograd.Function``: the forward runs ``fwd`` (the kernel on CUDA
tensors, its plain version on CPU tensors) without recording a graph and
saves its inputs; the backward re-runs ``twin`` on them under autograd and
returns its gradients. Arguments after ``fwd`` and ``twin`` are tensors or
None; settings are closed over by the two callables.
"""
from __future__ import annotations

import torch


class KernelWithTwin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fwd, twin, *args):
        ctx.twin = twin
        ctx.save_for_backward(*args)
        return fwd(*args)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            ins = [a if a is None else a.detach().requires_grad_(n)
                   for a, n in zip(ctx.saved_tensors, need)]
            out = ctx.twin(*ins)
        wrt = [a for a, n in zip(ins, need) if n]
        grads = iter(torch.autograd.grad(out, wrt, grad, allow_unused=True))
        return (None, None, *[next(grads) if n else None for n in need])
