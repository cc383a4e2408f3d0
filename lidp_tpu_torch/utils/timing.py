"""The `timer full` breakdown by force term (lidp_tpu/utils/timing.py, an
own copy on the port's ForceField).

The analog of Timer::stamp's categories (timer.h:25-28) and of the lines
Finish::end prints (finish.cpp:64, e.g. "Pair time (%) = 5.47743
(99.7331)").  A step evaluates every term in one pass, so the terms are
timed apart after the run: each is evaluated alone with its device
synchronized between stamps.  On a GPU the stamps are CUDA events
(torch.cuda.Event); on the CPU the host clock.

The port evaluates the force field cumulatively, the pair term alone,
then with the k-space term, then with the bonded terms, then whole (the
polarization), and takes each category as the difference of two
neighbours: compute_forces needs its pair table on the cell grid, so the
JAX package's k-space-alone variant (pair None) has no counterpart.  The
categories and the lines are the JAX function's.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

import torch

_KSPACE = ("ewald", "pppm", "msm", "pppm_disp", "ewald6")
_BONDED = ("bond", "angle", "dihedral", "improper")


class Timer:
    """Seconds by category, stamped on the host clock or, for CUDA
    tensors, by events recorded on the current stream."""

    def __init__(self, device=None):
        self.t = OrderedDict()
        self.cuda = device is not None and torch.device(device).type == "cuda"

    def time(self, fn, repeats: int) -> float:
        """Mean seconds of fn() over `repeats` calls after one warm call."""
        fn()
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(repeats):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e-3 / repeats
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        return (time.perf_counter() - t0) / repeats

    def report(self, log=print):
        tot = sum(self.t.values())
        for k, v in self.t.items():
            pct = 100.0 * v / tot if tot else 0.0
            log(f"{k:<6s}time (%) = {v:.6g} ({pct:.4g})")


def force_levels(ff) -> "OrderedDict[str, object]":
    """The cumulative force fields: Pair, then + Kspce, + Bond and +
    Polar, each present only where the force field holds its terms."""
    from lidp_tpu_torch.forcefield import ForceField

    assert isinstance(ff, ForceField)
    no_k = {k: None for k in _KSPACE}
    no_b = {k: () for k in _BONDED}
    has_k = any(getattr(ff, k) is not None for k in _KSPACE)
    has_b = any(getattr(ff, k) for k in _BONDED)
    levels = OrderedDict()
    levels["Pair"] = dataclasses.replace(ff, polar=None, **no_k, **no_b)
    if has_k:
        levels["Kspce"] = dataclasses.replace(ff, polar=None, **no_b)
    if has_b:
        levels["Bond"] = dataclasses.replace(ff, polar=None)
    if ff.polar is not None:
        levels["Polar"] = ff
    return levels


def profile_forces(sys, ff, nlist=None, repeats: int = 3, log=print):
    """Evaluate the force terms apart on `sys` (on `nlist`'s cell grid, or
    the dense route for None) and log the breakdown, in seconds an
    evaluation.  Returns the Timer (its `t` by category)."""
    from lidp_tpu_torch.forcefield import compute_forces

    nlist = getattr(nlist, "nlist", nlist)   # the cell grid of a carry
    timer = Timer(sys.x.device)
    prev = 0.0
    for name, ff_k in force_levels(ff).items():
        def call(ff_k=ff_k):
            return compute_forces(sys, ff_k, nlist).f
        t = timer.time(call, repeats)
        timer.t[name] = t - prev
        prev = t
    timer.report(log=log)
    return timer
