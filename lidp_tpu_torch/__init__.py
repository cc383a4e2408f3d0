"""PyTorch/CUDA port of lidp_tpu: the polarizable MD step on the panel
engine and the LJ melt on the cell engine.

The JAX package `lidp_tpu` stays the reference; this package mirrors its
layout (units, box, state, topology, ops/, integrate/, parallel/, models/)
with PyTorch idiom: plain functions on tensors, the polar MD step as an
`nn.Module` whose force-field tables are buffers, the cell engine's runners
as Python loops over device work, and the O(N^2) panel kernels and the LJ
cell kernels as hand-written CUDA C++ (`csrc/`, built at first use by
`kernels/build.py`).

Entry points run on the GPU unless the caller passes `device="cpu"`; on a
machine without CUDA they raise instead of silently falling back.
"""

from __future__ import annotations

import torch

# the elementwise functions torch may route through MKL's vector math on
# the CPU
_VECTOR_MATH = (torch.sqrt, torch.rsqrt, torch.exp, torch.expm1, torch.log,
                torch.log1p, torch.log2, torch.log10, torch.sin, torch.cos,
                torch.tan, torch.asin, torch.acos, torch.atan, torch.sinh,
                torch.cosh, torch.tanh, torch.erf, torch.erfc)


def warm_vector_math():
    """Call each of _VECTOR_MATH once, float64 and float32, on every CPU
    thread, and discard the results.  The first call of such a function in
    a process with several threads can come out with one thread's chunk at
    ~35-bit accuracy (torch.sqrt in float64: relative errors of 3.07e-11
    on one chunk of 8, in about one fresh process in 150 under load); the
    calls after it are right.  The first float64 evaluation of a run then
    differed from a one-thread run's in one chunk of rows (ROADMAP queue 3
    item 1).  Called once when the package is imported."""
    n = 4096 * max(1, torch.get_num_threads())
    for dtype in (torch.float64, torch.float32):
        x = torch.linspace(0.5, 1.0, n, dtype=dtype)
        for fn in _VECTOR_MATH:
            fn(x)


warm_vector_math()


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for
    and absent (the CPU runs only when the caller says so)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
