"""Matmul precision of the pipeline's contractions.

A GPU with tensor cores may run a float32 dot as TF32, which keeps a 10-bit
mantissa (about 3 decimal digits). That is too little here: the
Gauss-Newton systems (BA, coarse tracker, coarse initializer, event tracker,
immature-point tracer) hold priors of 1e8 and more next to data terms of
order one, and a TF32 projection ``X @ R.T`` moves a 640-pixel image
coordinate by a fraction of a pixel. Every function that forms or solves a
normal equation, and each public pipeline step, is wrapped in ``full_f32``:
its body runs inside ``jax.default_matmul_precision("float32")``, so each
dot traced or dispatched in it is a full-precision float32 dot on every
backend.
"""
from __future__ import annotations

import functools

import jax


def full_f32(fn):
    """Decorator: trace ``fn`` with float32 matmul precision."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)
    return wrapped
