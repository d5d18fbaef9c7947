"""Gradients of the port's kernels: the VJP of their plain versions.

Each Pallas kernel of the reference carries a `jax.custom_vjp` whose
backward is XLA autodiff of the mathematically identical dense path
(`pallas_spn.py:219-227`, `pallas_likelihood.py:246-255`,
`stove.py:326-333`); there is no backward kernel.  `with_plain_vjp` is the
PyTorch counterpart: the forward runs `fast` (a kernel launch on the card,
the plain version itself on the CPU), the backward re-runs `plain` on the
saved inputs under `torch.enable_grad()` and returns its VJP.
"""

from __future__ import annotations

from typing import Callable

import torch


class _PlainVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fast: Callable, plain: Callable, *inputs):
        ctx.set_materialize_grads(False)     # unused outputs pass None
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return fast(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[2:]
        leaves = [x.detach().requires_grad_(n)
                  for x, n in zip(ctx.saved_tensors, need)]
        wrt = [x for x, n in zip(leaves, need) if n]
        with torch.enable_grad():
            outs = ctx.plain(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if o.requires_grad and g is not None]
        if not wrt or not pairs:
            return (None, None) + (None,) * len(leaves)
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       allow_unused=True))
        return (None, None) + tuple(next(got) if n else None for n in need)


def with_plain_vjp(fast: Callable, plain: Callable, *inputs: torch.Tensor):
    """`fast(*inputs)` forward, the VJP of `plain(*inputs)` backward."""
    return _PlainVJP.apply(fast, plain, *inputs)
