"""Launch counts of the kernel wrappers.

Each wrapper that launches a hand-written kernel is registered here with
`counted`: it carries one plain integer per total it keeps (`launches`,
and for the residual forward `residual_launches`) and a Counter
`entry_launches` of the entry points it launched, by name. A run reads
them to show that the main path went through the kernels.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, Tuple

_wrappers: Dict[str, Tuple[Callable, Tuple[str, ...]]] = {}


def counted(*totals: str) -> Callable[[Callable], Callable]:
    """Decorator: give the wrapper the integer counts `totals` (each 0) and
    an empty `entry_launches`, and register it under its name."""
    def register(fn: Callable) -> Callable:
        for name in totals:
            setattr(fn, name, 0)
        fn.entry_launches = Counter()
        _wrappers[fn.__name__] = (fn, totals)
        return fn
    return register


def launch_counts() -> Counter:
    """A snapshot of the wrappers' launch counts: (wrapper, count name) for
    the totals, (wrapper, entry point) for `entry_launches`."""
    counts = Counter()
    for name, (fn, totals) in _wrappers.items():
        counts.update({(name, t): getattr(fn, t) for t in totals})
        counts.update({(name, e): n for e, n in fn.entry_launches.items()})
    return counts


def add_launch_counts(delta: Counter, times: int = 1) -> None:
    """Add `times` x `delta` (a difference of two `launch_counts()`) to the
    counts. A CUDA graph's capture records its kernels without launching
    them, and each replay launches them again without a Python call: the
    capture takes back what its wrapper calls counted (times=-1), and every
    replay adds it (`train.graphs.StepGraph`)."""
    for (name, key), n in delta.items():
        fn, totals = _wrappers[name]
        if key in totals:
            setattr(fn, key, getattr(fn, key) + times * n)
        else:
            fn.entry_launches[key] += times * n
