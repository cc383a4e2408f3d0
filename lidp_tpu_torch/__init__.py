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


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for
    and absent (the CPU runs only when the caller says so)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
