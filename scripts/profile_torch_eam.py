#!/usr/bin/env python3
"""Where the EAM term's time goes on one GPU (lidp_tpu_torch/ops/eam.py).

    python3 scripts/profile_torch_eam.py [--reps 3]

On in.eam's lattice (20^3 fcc unit cells at 3.615 A, 32,000 atoms, each
site jittered +-0.1 A from a seed; cells of the synthetic Cu_synth.eam's
cutoff plus in.eam's skin, 12^3 x cap 32), the quiet evaluation
(need_ev=False, as a step runs it):
  * groups: eam_cell_forces in float32 and float64 at GROUP_PAIRS 2^21,
    2^23 and 2^25 slot pairs a group, in turns, `--reps` rounds; ms a
    call by CUDA events (median of 5) and the peak memory;
  * gather: eam_cell_forces and eam_alloy_cell_forces (half the atoms of
    type 2 from the seed) with the segment coefficients gathered as the
    module does (the segment's row of the function's block), as that row
    from a contiguous copy of the block, and coefficient by coefficient
    from contiguous columns, in turns (forward then backward), `--reps`
    rounds, each form's forces checked against the module's;
  * profile: torch.profiler over 3 evaluations of eam_cell_forces in
    float32 at the module's GROUP_PAIRS: device ms an evaluation and the
    operators by device time.
Every figure is printed beside the card's name and power limit.  Needs a
CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lattice(n_side=20, a=3.615, seed=1):
    import numpy as np

    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                     [0, 0.5, 0.5]])
    g = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    L = n_side * a
    rng = np.random.default_rng(seed)
    x = np.mod(((g[:, None] + base[None]) * a).reshape(-1, 3)
               + rng.uniform(-0.1, 0.1, (len(g) * 4, 3)), L)
    return x, L, rng.integers(1, 3, len(x))


def setup(kind, path, dtype, x, L, types):
    """(callable evaluating the quiet EAM term, cell config)."""
    import numpy as np
    import torch

    from lidp_tpu_torch.box import Box
    from lidp_tpu_torch.ops import cells as tcells
    from lidp_tpu_torch.ops import eam as team

    if kind == "eam":
        p, _ = team.build_eam_params(path, dtype=dtype)
    else:
        p, _ = team.build_eam_alloy_params(path, ["Cu", "Al"], dtype=dtype)
    box = Box.create(np.zeros(3), np.full(3, L), dtype=dtype, device="cuda")
    cfg = tcells.CellConfig.for_box(np.full(3, L), float(p.cut) + 1.0,
                                    density=len(x) / L ** 3, cap_slack=1.7)
    xt = torch.as_tensor(x, dtype=dtype, device="cuda")
    mask = torch.ones(len(x), dtype=torch.bool, device="cuda")
    ty = torch.as_tensor(types, device="cuda")
    cells = tcells.build_cells(xt, mask, box, cfg)
    if kind == "eam":
        return (lambda: team.eam_cell_forces(xt, mask, cells, box, p,
                                             need_ev=False)), cfg
    return (lambda: team.eam_alloy_cell_forces(xt, ty, mask, cells, box, p,
                                               need_ev=False)), cfg


def contiguous_rows(table, k, row, xi, deg):
    c = table[:, k * (deg + 1):(k + 1) * (deg + 1)].contiguous()[row]
    acc = c[..., deg]
    for j in range(deg - 1, -1, -1):
        acc = acc * xi + c[..., j]
    return acc


def columns(table, k, row, xi, deg):
    cols = table[:, k * (deg + 1):(k + 1) * (deg + 1)].t().contiguous()
    acc = cols[deg][row]
    for j in range(deg - 1, -1, -1):
        acc = acc * xi + cols[j][row]
    return acc


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_eam: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from lidp_tpu_torch.ops import eam as team

    smi = chip_smoke.smi_line()
    print(f"card: {smi}")
    d = tempfile.mkdtemp()
    paths = {"eam": chip_smoke.eam_funcfl_case(d),
             "alloy": chip_smoke.eam_setfl_case(d)}
    x, L, types = lattice()
    default = team.GROUP_PAIRS

    # groups
    for dtype in (torch.float32, torch.float64):
        fn, cfg = setup("eam", paths["eam"], dtype, x, L, types)
        res = {}
        for _ in range(args.reps):
            for gp in (1 << 21, 1 << 23, 1 << 25):
                team.GROUP_PAIRS = gp
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ms = chip_smoke.cuda_ms(fn, reps=5)
                res.setdefault(gp, []).append(
                    (ms, torch.cuda.max_memory_allocated() / 2**20))
        team.GROUP_PAIRS = default
        for gp, v in res.items():
            print(f"groups: eam_cell_forces {dtype} grid {cfg.nbins} x "
                  f"{cfg.cap}, GROUP_PAIRS 2^{gp.bit_length() - 1}: median "
                  f"{statistics.median(m for m, _ in v):.4f} ms of "
                  f"{[round(m, 4) for m, _ in v]}, peak "
                  f"{max(pk for _, pk in v):.1f} MiB; {smi}")

    # gather
    forms = {"row of the block (the module's)": team._horner,
             "row of a contiguous copy": contiguous_rows,
             "coefficient by coefficient": columns}
    try:
        for kind in ("eam", "alloy"):
            for dtype in (torch.float32, torch.float64):
                fn, _ = setup(kind, paths[kind], dtype, x, L, types)
                ref = fn()[0]
                bar = 1e-12 if dtype == torch.float64 else 1e-5
                res = {}
                for _ in range(args.reps):
                    for name, h in (list(forms.items())
                                    + list(reversed(forms.items()))):
                        team._horner = h
                        res.setdefault(name, []).append(
                            chip_smoke.cuda_ms(fn, reps=5))
                        err = float((fn()[0] - ref).abs().max())
                        if not err <= bar * float(ref.abs().max()):
                            raise AssertionError(f"{kind} {name}: {err}")
                    team._horner = forms["row of the block (the module's)"]
                for name, v in res.items():
                    print(f"gather: {kind} {dtype} {name}: median "
                          f"{statistics.median(v):.4f} ms of "
                          f"{[round(t, 3) for t in v]}; {smi}")
    finally:
        team._horner = forms["row of the block (the module's)"]

    # profile
    from torch.profiler import ProfilerActivity, profile

    fn, cfg = setup("eam", paths["eam"], torch.float32, x, L, types)
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    dev = sum(e.self_device_time_total for e in ka)
    print(f"profile: eam_cell_forces float32, GROUP_PAIRS "
          f"2^{default.bit_length() - 1}: device time {dev / 3e3:.4f} ms "
          f"an evaluation; {smi}")
    print(ka.table(sort_by="self_cuda_time_total", row_limit=20))
    return 0


if __name__ == "__main__":
    sys.exit(main())
