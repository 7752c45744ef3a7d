"""The one hook into a receiver's call.

A tap wraps one attribute (a module-level function) for the length of a
``with`` block: the wrapped callable runs unchanged, and a hook sees its
arguments and result. The taps are removed when the block ends, whatever
happens inside it. An attribute that no longer exists is left untapped,
so what it would have recorded stays missing and its gap reads
``compare.MISSING``.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def tapped(taps):
    """``taps``: (owner, attribute, hook(args, kwargs, result)) triples."""
    saved = []
    try:
        for owner, name, hook in taps:
            inner = getattr(owner, name, None)
            if inner is None:
                continue
            saved.append((owner, name, inner))

            def outer(*args, _inner=inner, _hook=hook, **kwargs):
                result = _inner(*args, **kwargs)
                _hook(args, kwargs, result)
                return result

            setattr(owner, name, outer)
        yield
    finally:
        for owner, name, inner in reversed(saved):
            setattr(owner, name, inner)
