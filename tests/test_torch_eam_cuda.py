"""The EAM cell forces (ops/eam.py, plain PyTorch) on the GPU against the
same functions on the CPU, for pair_style eam, eam/alloy and eam/fs on
chip_smoke's synthetic potentials.  Marked `cuda`: they skip without a
CUDA device.  On a GPU host (which has no JAX, so the suite's conftest is
left out):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_eam_cuda.py

Bars: float64 forces 1e-10 of max |f|, energy and virial rel 1e-10 (sums
in another order); float32 1e-5.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from lidp_tpu_torch.box import Box
from lidp_tpu_torch.ops import cells as tcells
from lidp_tpu_torch.ops import eam as team

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _forces(kind, path, x, L, types, dtype, device):
    n = len(x)
    if kind == "eam":
        p, _ = team.build_eam_params(path, dtype=dtype, device=device)
    else:
        p, _ = team.build_eam_alloy_params(path, ["Cu", "Al"], dtype=dtype,
                                           device=device, fs=kind == "fs")
    box = Box.create(np.zeros(3), np.full(3, L), dtype=dtype, device=device)
    cfg = tcells.CellConfig.for_box(np.full(3, L), float(p.cut) + 1.0,
                                    density=n / L ** 3, cap_slack=1.7)
    xt = torch.as_tensor(x, dtype=dtype, device=device)
    mask = torch.ones(n, dtype=torch.bool, device=device)
    cells = tcells.build_cells(xt, mask, box, cfg)
    if kind == "eam":
        out = team.eam_cell_forces(xt, mask, cells, box, p)
    else:
        out = team.eam_alloy_cell_forces(
            xt, torch.as_tensor(types, device=device), mask, cells, box, p)
    return [o.cpu().numpy() for o in out]


@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("kind", ["eam", "alloy", "fs"])
def test_eam_cell_forces_on_cuda_match_cpu(dev, tmp_path, kind, dtype, bar):
    path = (chip_smoke.eam_funcfl_case(str(tmp_path)) if kind == "eam"
            else chip_smoke.eam_setfl_case(str(tmp_path), fs=kind == "fs"))
    rng = np.random.default_rng(3)
    n_side, a = 10, 3.615
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    g = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    L = n_side * a
    x = np.mod(((g[:, None] + base[None]) * a).reshape(-1, 3)
               + rng.uniform(-0.1, 0.1, (len(g) * 4, 3)), L)
    types = rng.integers(1, 3, len(x)).astype(np.int32)
    fg, eg, vg = _forces(kind, path, x, L, types, dtype, dev)
    fc, ec, vc = _forces(kind, path, x, L, types, dtype, "cpu")
    np.testing.assert_allclose(fg, fc, rtol=0, atol=bar * np.abs(fc).max())
    assert float(eg) == pytest.approx(float(ec), rel=bar)
    np.testing.assert_allclose(vg, vc, rtol=0, atol=bar * np.abs(vc).max())
