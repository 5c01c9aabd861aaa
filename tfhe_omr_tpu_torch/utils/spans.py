"""Named ranges around the program's stages, seen by ``torch.profiler``.

``span(name)`` marks a stage of the program: the detector's stages, the
digest encoders and each device's share of them, the sharded reduce and
the recipient's decode. While a profiler records, it is the profiler range
``tfhe_omr:<name>``, on the clock of the profiler's device trace, so that
a trace can set each gap of a card against the host step it falls in. While
none records, it is one shared context that does nothing. Nothing switches
the spans on but a recording profiler; they keep no log of their own.

Record them with any ``torch.profiler.profile`` over the program,
for example ``examples/omr_torch.py --profile DIR``.
"""

from __future__ import annotations

import contextlib
import functools

import torch

#: prefix of every range the program records
PREFIX = "tfhe_omr:"
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context over one stage of the program: the profiler range
    ``tfhe_omr:<name>`` while a profiler records, else a no-op."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap
