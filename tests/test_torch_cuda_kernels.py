"""The port's CUDA panel kernels against their plain PyTorch versions, on
the GPU.  Marked `cuda`: they skip without a CUDA device.  On a GPU host
(which has no JAX, so the suite's conftest is left out):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Tolerances as in chip_smoke.py: per-row outputs rtol 1e-4,
atol 1e-5*max|ref|, scalars rel 1e-4 (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

from lidp_tpu_torch.models import polar_bench
from lidp_tpu_torch.ops import panel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(dev, n=1000, npad=1024, L=28.0, seed=5):
    """Ragged rows, masked atoms, alpha=0 atoms, 3-atom molecules with
    special lists; float32 on `dev`."""
    rng = np.random.RandomState(seed)
    side = int(np.ceil(n ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n]
    h = L / side
    x = np.zeros((npad, 3))
    x[:n] = (g + 0.5) * h + rng.uniform(-0.2, 0.2, (n, 3)) * h
    mask = np.zeros(npad)
    mask[:n] = 1.0
    mask[rng.choice(n, 40, replace=False)] = 0.0
    alpha = np.zeros(npad)
    alpha[:n] = rng.uniform(0.5, 2.0, n)
    alpha[rng.choice(n, 50, replace=False)] = 0.0
    alpha *= mask
    mu = np.zeros((npad, 3))
    mu[:n] = rng.normal(0, 1e-2, (n, 3))
    mu[alpha == 0] = 0.0
    q = np.zeros(npad)
    q[:n] = rng.normal(0, 0.5, n)
    typ = np.zeros(npad)
    typ[:n] = rng.randint(1, 3, n)
    mol = np.zeros(npad)
    mol[:n] = np.arange(n) // 3 + 1
    i = np.arange(npad)
    base, k = 3 * (i // 3), i % 3
    sp = np.full((npad, 8), n, np.int32)
    sp[:, 0], sp[:, 1] = base + (k + 1) % 3, base + (k + 2) % 3
    sp[(sp >= n) | (i[:, None] >= n)] = n
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    sysd = polar_bench.synthetic_system(2)
    ff = polar_bench.synthetic_forcefield(sysd, torch.float32, dev)
    p = ff.pair
    tabs = torch.stack([p.lj3, p.lj4, p.offset, p.cut_ljsq, p.cutsq])
    return dict(x=t(x), q=t(q), type=t(typ), mol=t(mol), mask=t(mask),
                alpha=t(alpha), mu=t(mu), L=t([L, L, L]), tabs=tabs,
                sp=torch.as_tensor(sp, device=dev), pair=p, s=ff.polar)


def _close(got, ref):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        g, r = g.double().cpu().numpy(), r.double().cpu().numpy()
        if g.ndim == 2:
            np.testing.assert_allclose(g, r, rtol=1e-4,
                                       atol=1e-5 * np.abs(r).max())
        else:
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=1e-4 * np.abs(r).max())


def _calls(c, rows):
    """{kernel: (wrapper, plain, args, kwargs)}; rows: None for the full
    panel, else a slice: a row strip against all columns, row0 = start."""
    s, p = c["s"], c["pair"]
    r = slice(None) if rows is None else rows

    def strip(*cols):
        kw = {} if rows is None else dict(cols=cols, row0=rows.start)
        return [a[r] for a in cols], kw

    e_args, e_kw = strip(c["x"], c["alpha"], c["mu"])
    pw_args, pw_kw = strip(c["x"], c["q"], c["type"], c["mol"], c["mask"])
    dp_args, dp_kw = strip(c["x"], c["q"], c["mol"], c["alpha"], c["mu"],
                           c["mask"])
    return {
        "eind": (panel.eind_panel, panel.eind_panel_plain,
                 (*e_args, c["L"], s.polar_damp),
                 dict(damping_type=s.damping_type, **e_kw)),
        "pair_wolf": (panel.pair_wolf_panel, panel.pair_wolf_panel_plain,
                      (*pw_args, c["tabs"], c["L"], p.cut_coulsq, p.qqrd2e,
                       p.g_ewald),
                      dict(sp=c["sp"][r], **pw_kw)),
        "dipole": (panel.dipole_panel, panel.dipole_panel_plain,
                   (*dp_args, c["L"], s.polar_damp, p.cut_coulsq, p.qqrd2e),
                   dict(damping_type=s.damping_type, **dp_kw)),
    }


@pytest.mark.parametrize("kernel", ["eind", "pair_wolf", "dipole"])
@pytest.mark.parametrize("rows", [None, slice(96, 544)],
                         ids=["full", "strip"])
def test_kernel_matches_plain(dev, kernel, rows):
    c = _case(dev)
    wrapper, plain, args, kw = _calls(c, rows)[kernel]
    before = wrapper.launches
    got = wrapper(*args, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _close(got, plain(*args, **kw))


def test_kernels_are_deterministic(dev):
    """Per-CTA partials are summed in block order: repeated launches give
    bit-identical outputs."""
    c = _case(dev)
    for wrapper, _, args, kw in _calls(c, None).values():
        a, b = wrapper(*args, **kw), wrapper(*args, **kw)
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_float64_on_cuda_raises(dev):
    c = _case(dev)
    with pytest.raises(NotImplementedError, match="later slice"):
        panel.eind_panel(c["x"].double(), c["alpha"].double(),
                         c["mu"].double(), c["L"].double(), 2.1304)
    with pytest.raises(NotImplementedError, match="later slice"):
        polar_bench.build_synthetic(4, dtype=torch.float64)


def test_step_through_kernels_matches_plain(dev):
    """Initial forces + 2 steps of a 1,536-atom fluid: the kernel path
    against the plain float32 path on the same card."""
    out = []
    for panel_kind in ("kernel", "scan"):
        bench = polar_bench.build_synthetic(8, panel=panel_kind)
        f0, en0 = polar_bench.setup_forces(bench)
        f, per_step = polar_bench.run(bench, 2)
        out.append((f0, en0, f, per_step))
    (kf0, ken0, kf, kper), (pf0, pen0, pf, pper) = out
    n = 3 * 8**3
    for a, b in ((kf0, pf0), (kf, pf)):
        a, b = a[:n].double().cpu().numpy(), b[:n].double().cpu().numpy()
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=2e-4 * np.abs(b).max())
    for k in ("evdwl", "ecoul", "elong"):
        assert float(ken0[k]) == pytest.approx(float(pen0[k]), rel=1e-5)
    assert float(ken0["epol"]) == pytest.approx(float(pen0["epol"]),
                                                rel=1e-4, abs=2e-2)
    for a, b in zip(kper, pper):
        assert abs(a["scf_iters"] - b["scf_iters"]) <= 1
