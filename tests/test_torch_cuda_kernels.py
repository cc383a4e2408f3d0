"""The port's CUDA panel kernels against their plain PyTorch versions, on
the GPU.  Marked `cuda`: they skip without a CUDA device.  On a GPU host
(which has no JAX, so the suite's conftest is left out):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Tolerances as in chip_smoke.py: float32 kernels per-row rtol 1e-4,
atol 1e-5*max|ref|, scalars rel 1e-4 (float32 sums in another order);
float64 (`*_df`) kernels per-row rtol 1e-9, atol 1e-11*max|ref|, scalars
rel 1e-10 — a double kernel that dropped to float32 anywhere misses that
by four orders.
"""

import dataclasses

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


def _case(dev, dtype=torch.float32, n=1000, npad=1024, L=28.0, seed=5):
    """Ragged rows, masked atoms, alpha=0 atoms, 3-atom molecules with
    special lists; `dtype` on `dev`."""
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
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa
    sysd = polar_bench.synthetic_system(2)
    ff = polar_bench.synthetic_forcefield(sysd, dtype, dev)
    p = ff.pair
    tabs = torch.stack([p.lj3, p.lj4, p.offset, p.cut_ljsq, p.cutsq])
    return dict(x=t(x), q=t(q), type=t(typ), mol=t(mol), mask=t(mask),
                alpha=t(alpha), mu=t(mu), L=t([L, L, L]), tabs=tabs,
                sp=torch.as_tensor(sp, device=dev), pair=p, s=ff.polar)


def _close(got, ref):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    f64 = got[0].dtype == torch.float64
    rtol, atol, srel = (1e-9, 1e-11, 1e-10) if f64 else (1e-4, 1e-5, 1e-4)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        g, r = g.double().cpu().numpy(), r.double().cpu().numpy()
        if g.ndim == 2:
            np.testing.assert_allclose(g, r, rtol=rtol,
                                       atol=atol * np.abs(r).max())
        else:
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=srel * np.abs(r).max())


KERNELS = ["eind", "pair_wolf", "dipole", "pair", "pair_lj", "wolf",
           "eind_df", "pair_df", "pair_wolf_df", "dipole_df"]


def _calls(dev, kernel, rows):
    """(wrapper, plain, args, kwargs) of one kernel on the case of its
    dtype; rows: None for the full panel, else a slice: a row strip against
    all columns, row0 = start."""
    df = kernel.endswith("_df")
    c = _case(dev, torch.float64 if df else torch.float32)
    s, p = c["s"], c["pair"]
    r = slice(None) if rows is None else rows

    def strip(*cols):
        kw = {} if rows is None else dict(cols=cols, row0=rows.start)
        return [a[r] for a in cols], kw

    pair_tail = (c["tabs"], c["L"], p.cut_coulsq, p.qqrd2e, p.g_ewald)
    damp = dict(damping_type=s.damping_type)
    if kernel in ("eind", "eind_df"):
        args, kw = strip(c["x"], c["alpha"], c["mu"])
        fns = ((panel.eind_panel_df, panel.eind_panel_df_plain) if df
               else (panel.eind_panel, panel.eind_panel_plain))
        return (*fns, (*args, c["L"], s.polar_damp), dict(**damp, **kw))
    if kernel in ("dipole", "dipole_df"):
        args, kw = strip(c["x"], c["q"], c["mol"], c["alpha"], c["mu"],
                         c["mask"])
        fns = ((panel.dipole_panel_df, panel.dipole_panel_df_plain) if df
               else (panel.dipole_panel, panel.dipole_panel_plain))
        return (*fns, (*args, c["L"], s.polar_damp, p.cut_coulsq, p.qqrd2e),
                dict(**damp, **kw))
    if kernel == "pair_wolf":
        args, kw = strip(c["x"], c["q"], c["type"], c["mol"], c["mask"])
        return (panel.pair_wolf_panel, panel.pair_wolf_panel_plain,
                (*args, *pair_tail), dict(sp=c["sp"][r], **kw))
    if kernel == "wolf":
        args, kw = strip(c["x"], c["q"], c["mol"], c["mask"])
        return (panel.wolf_panel, panel.wolf_panel_plain,
                (*args, c["L"], p.cut_coulsq), kw)
    if kernel == "pair_wolf_df":
        args, kw = strip(c["x"], c["q"], c["type"], c["mask"], c["mol"])
        return (panel.pair_panel_df, panel.pair_panel_df_plain,
                (*args[:4], *pair_tail),
                dict(sp=c["sp"][r], mol=args[4], **kw))
    args, kw = strip(c["x"], c["q"], c["type"], c["mask"])
    if kernel == "pair_df":
        return (panel.pair_panel_df, panel.pair_panel_df_plain,
                (*args, *pair_tail), dict(sp=c["sp"][r], **kw))
    # pair: with the special lists; pair_lj: LJ only, without them
    extra = dict(sp=c["sp"][r]) if kernel == "pair" else dict(coul=False)
    return (panel.pair_panel, panel.pair_panel_plain, (*args, *pair_tail),
            dict(**extra, **kw))


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("rows", [None, slice(96, 544)],
                         ids=["full", "strip"])
def test_kernel_matches_plain(dev, kernel, rows):
    wrapper, plain, args, kw = _calls(dev, kernel, rows)
    before = wrapper.launches
    got = wrapper(*args, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _close(got, plain(*args, **kw))


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernels_are_deterministic(dev, kernel):
    """Per-CTA partials are summed in block order: repeated launches give
    bit-identical outputs."""
    wrapper, _, args, kw = _calls(dev, kernel, None)
    a, b = wrapper(*args, **kw), wrapper(*args, **kw)
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kernel", KERNELS)
def test_wrong_dtype_raises(dev, kernel):
    """float64 into an f32 wrapper and float32 into a *_df wrapper raise
    TypeError: nothing is cast and nothing falls back."""
    wrapper, _, args, kw = _calls(dev, kernel, None)
    other = (torch.float32 if kernel.endswith("_df") else torch.float64)

    def flip(a):
        return a.to(other) if torch.is_tensor(a) and a.is_floating_point() \
            else a

    kw = {k: flip(v) for k, v in kw.items()}
    before = wrapper.launches
    with pytest.raises(TypeError, match="expected torch.float"):
        wrapper(*[flip(a) for a in args], **kw)
    assert wrapper.launches == before


# --------------- eind: the whole-panel kernel (cols=None) ---------------

EIND = {"eind": (panel.eind_panel, torch.float32),
        "eind_df": (panel.eind_panel_df, torch.float64)}


def _eind_args(dev, kernel, npad):
    wrapper, dtype = EIND[kernel]
    c = _case(dev, dtype, npad=npad)
    return wrapper, (c["x"], c["alpha"], c["mu"], c["L"],
                     c["s"].polar_damp)


DAMPINGS = {"exp": panel.DAMP_EXP, "none": panel.DAMP_NONE}


@pytest.mark.parametrize("damping", list(DAMPINGS))
@pytest.mark.parametrize("npad", [1024, 1000])
@pytest.mark.parametrize("kernel", list(EIND))
def test_eind_whole_matches_plain_and_strip(dev, kernel, npad, damping):
    """The ragged case (1,000 live rows, masked and alpha=0 atoms) at an
    npad that is a multiple of the tile (1024) and one that is not (1000),
    exponential damping and none: the whole-panel kernel against the plain
    version and against the strip kernel at the same shape, one launch
    counted per call, two launches bit-identical."""
    wrapper, args = _eind_args(dev, kernel, npad)
    kw = dict(damping_type=DAMPINGS[damping])
    before = wrapper.launches
    whole = wrapper(*args, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    strip = wrapper(*args, cols=args[:3], row0=0, **kw)
    assert wrapper.launches == before + 2
    _close(whole, panel.eind_panel_plain(*args, **kw))
    _close(whole, strip)
    assert torch.equal(whole, wrapper(*args, **kw))


@pytest.mark.parametrize("kernel", list(EIND))
def test_eind_skip_is_exact(dev, kernel, monkeypatch):
    """64 polarizable atoms 25 A apart in a 100 A box: every pair lies
    beyond the skip threshold (12.7 A in float32, 23 A in float64), so
    every warp vote skips the exponential, and the result is bit for bit
    that of the kernels with the skip turned off by a huge threshold."""
    wrapper, dtype = EIND[kernel]
    g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    rng = np.random.RandomState(0)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa
    x = t(25.0 * g + rng.uniform(-0.5, 0.5, g.shape))
    alpha, mu = t(np.full(64, 1.1)), t(rng.normal(0, 0.1, (64, 3)))
    args = (x, alpha, mu, t([100.0] * 3), 2.1304)
    forms = ({}, dict(cols=(x, alpha, mu), row0=0))
    on = [wrapper(*args, **kw) for kw in forms]
    for kw in forms:
        steps, skipped = panel.eind_skip_share(*args, **kw)
        assert steps > 0 and skipped == steps
    monkeypatch.setitem(panel.EIND_SKIP_U, dtype, float("inf"))
    off = [wrapper(*args, **kw) for kw in forms]
    for kw in forms:    # only votes on masked pairs alone still skip
        steps, skipped = panel.eind_skip_share(*args, **kw)
        assert skipped < steps
    for a, b in zip(on, off):
        assert torch.equal(a, b)
        assert bool(a.abs().max() > 0)
    _close(on[0], panel.eind_panel_plain(*args))


# -------------- dipole: the whole-panel kernel (cols=None) --------------

DIPOLE = {"dipole": (panel.dipole_panel, torch.float32),
          "dipole_df": (panel.dipole_panel_df, torch.float64)}
# (live atoms, npad, box edge): the ragged case at an npad that is not a
# multiple of either tile and one that is, and the main paths' shape
DIPOLE_SHAPES = {"1000": (1000, 1000, 28.0), "1024": (1000, 1024, 28.0),
                 "12288": (10_125, 12_288, 60.0)}


@pytest.mark.parametrize("damping", list(DAMPINGS))
@pytest.mark.parametrize("shape", list(DIPOLE_SHAPES))
@pytest.mark.parametrize("kernel", list(DIPOLE))
def test_dipole_whole_matches_plain_and_strip(dev, kernel, shape, damping,
                                              monkeypatch):
    """Masked atoms that keep their charge, alpha=0 atoms and padding: the
    whole-panel kernel against the plain version and against the strip
    kernel at the same shape, one launch counted per call (the strip
    launches apart), repeated launches bit-identical, and the kernel with
    its warp skips off (DIPOLE_SKIP) bit-identical too."""
    wrapper, dtype = DIPOLE[kernel]
    n, npad, L = DIPOLE_SHAPES[shape]
    c = _case(dev, dtype, n=n, npad=npad, L=L)
    args = (c["x"], c["q"], c["mol"], c["alpha"], c["mu"], c["mask"],
            c["L"], c["s"].polar_damp, c["pair"].cut_coulsq,
            c["pair"].qqrd2e)
    kw = dict(damping_type=DAMPINGS[damping])
    before, strips = wrapper.launches, wrapper.launches_strip
    whole = wrapper(*args, **kw)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.launches_strip) == (before + 1,
                                                          strips)
    strip = wrapper(*args, cols=args[:6], row0=0, **kw)
    assert (wrapper.launches, wrapper.launches_strip) == (before + 2,
                                                          strips + 1)
    _close(whole, panel.dipole_panel_plain(*args, **kw))
    _close(whole, strip)
    votes, cd_skipped, dd_skipped = panel.dipole_skip_share(*args, **kw)
    assert 0 < cd_skipped < votes and dd_skipped < votes
    for a, b in zip(whole, wrapper(*args, **kw)):
        assert torch.equal(a, b)
    monkeypatch.setattr(panel, "DIPOLE_SKIP", False)
    for a, b in zip(whole, wrapper(*args, **kw)):
        assert torch.equal(a, b)


# ---- pair and wolf: the whole-panel kernels (cols=None), one template ----

PAIR = ["pair_wolf", "pair", "pair_lj", "pair_df", "pair_wolf_df", "wolf"]


def _pair_calls(dev, kernel, n, npad, L):
    """(wrapper, plain, args, kwargs, cols of the strip form) of a kernel
    on the pair template (wolf: the field alone) on the ragged case at
    this shape."""
    df = kernel.endswith("_df")
    c = _case(dev, torch.float64 if df else torch.float32, n=n, npad=npad,
              L=L)
    p = c["pair"]
    if kernel == "wolf":
        args = (c["x"], c["q"], c["mol"], c["mask"], c["L"], p.cut_coulsq)
        return panel.wolf_panel, panel.wolf_panel_plain, args, {}, args[:4]
    tail = (c["tabs"], c["L"], p.cut_coulsq, p.qqrd2e, p.g_ewald)
    base = (c["x"], c["q"], c["type"])
    if kernel == "pair_wolf":
        args = (*base, c["mol"], c["mask"], *tail)
        return (panel.pair_wolf_panel, panel.pair_wolf_panel_plain, args,
                dict(sp=c["sp"]), args[:5])
    args = (*base, c["mask"], *tail)
    if kernel == "pair_wolf_df":
        return (panel.pair_panel_df, panel.pair_panel_df_plain, args,
                dict(sp=c["sp"], mol=c["mol"]), (*args[:4], c["mol"]))
    if kernel == "pair_df":
        return (panel.pair_panel_df, panel.pair_panel_df_plain, args,
                dict(sp=c["sp"]), args[:4])
    kw = dict(sp=c["sp"]) if kernel == "pair" else dict(sp=c["sp"],
                                                         coul=False)
    return panel.pair_panel, panel.pair_panel_plain, args, kw, args[:4]


@pytest.mark.parametrize("shape", list(DIPOLE_SHAPES))
@pytest.mark.parametrize("kernel", PAIR)
def test_pair_whole_matches_plain_and_strip(dev, kernel, shape,
                                            monkeypatch):
    """Masked atoms that keep their charge, padding at the origin (whose
    field rows are not zero), special lists: the whole-panel kernel
    against the plain version and against the strip kernel at the same
    shape, one launch counted per call (the strip launches apart: a strip
    of rows 96-543 counts one more, and equals those rows of the whole
    panel within the bars), repeated launches bit-identical, and the
    kernel with its warp skip, its tile-pair test or both off
    bit-identical too."""
    n, npad, L = DIPOLE_SHAPES[shape]
    wrapper, plain, args, kw, cols = _pair_calls(dev, kernel, n, npad, L)
    before, strips = wrapper.launches, wrapper.launches_strip
    whole = wrapper(*args, **kw)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.launches_strip) == (before + 1,
                                                          strips)
    strip = wrapper(*args, cols=cols, row0=0, **kw)
    assert (wrapper.launches, wrapper.launches_strip) == (before + 2,
                                                          strips + 1)
    ref = plain(*args, **kw)
    _close(whole, ref)
    _close(whole, strip)
    whole, ref = _tuple(whole), _tuple(ref)
    if len(ref) in (1, 5) and npad > n:     # the padding's field rows
        assert bool(ref[-1][n:].abs().sum(1).gt(0).any())
    if kernel == "wolf":
        rows = slice(96, 544)
        part = wrapper(*[a[rows] for a in args[:4]], *args[4:], cols=cols,
                       row0=rows.start)
        assert (wrapper.launches, wrapper.launches_strip) == (before + 3,
                                                              strips + 2)
        _close(part, whole[0][rows])
        votes, skipped, dropped, npairs = panel.wolf_skip_share(*args)
    else:
        mol = kw.get("mol", args[3] if kernel == "pair_wolf" else None)
        pargs = args if kernel != "pair_wolf" else args[:3] + args[4:]
        votes, skipped, dropped, npairs = panel.pair_skip_share(
            *pargs[:3], mol, *pargs[3:], sp=kw["sp"],
            coul=kw.get("coul", True))
    assert 0 < skipped < votes and dropped < npairs
    if shape == "12288":
        assert dropped > 0
    for a, b in zip(whole, _tuple(wrapper(*args, **kw))):
        assert torch.equal(a, b)
    for flags in ((False, True), (True, False), (False, False)):
        monkeypatch.setattr(panel, "PAIR_SKIP", flags[0])
        monkeypatch.setattr(panel, "PAIR_CULL", flags[1])
        for a, b in zip(whole, _tuple(wrapper(*args, **kw))):
            assert torch.equal(a, b)


def _tuple(v):
    """A kernel's outputs as a tuple (wolf_panel returns one tensor)."""
    return v if isinstance(v, tuple) else (v,)


def test_pair_whole_refuses_asymmetric_tables(dev):
    """The whole-panel pair kernel uses one force for both atoms of a pair:
    a type table that is not symmetric raises there (no launch), while the
    strip kernel, one-sided like the plain version, takes it."""
    wrapper, plain, args, kw, cols = _pair_calls(dev, "pair", 1000, 1024,
                                                 28.0)
    tabs = args[4].clone()
    tabs[0, 1, 2] *= 1.5
    bad = (*args[:4], tabs, *args[5:])
    before = wrapper.launches
    with pytest.raises(ValueError, match="symmetric"):
        wrapper(*bad, **kw)
    assert wrapper.launches == before
    _close(wrapper(*bad, cols=cols, row0=0, **kw), plain(*bad, **kw))


def test_per_type_cutoff_kernel_build_raises_on_cuda(dev):
    """The pair kernels take one outer cutoff: a kernel build with
    cut[1,1] = 7.0 above the others' 6.5 raises on the GPU, naming
    panel='scan', which takes it."""
    from lidp_tpu_torch.parallel import shard

    sysd = polar_bench.synthetic_system(4)
    ff = polar_bench.synthetic_forcefield(sysd, torch.float32, dev)
    cutsq = ff.pair.cutsq.clone()
    cutsq[1, 1] = 49.0
    ff = dataclasses.replace(ff, pair=dataclasses.replace(ff.pair,
                                                          cutsq=cutsq))
    kw = dict(n=3 * 4**3, dt=0.5, ftm2v=1.0, device=dev)
    with pytest.raises(ValueError, match="panel='scan'"):
        shard.build_sharded_polar_step(None, ff, ff.polar, panel="kernel",
                                       **kw)
    shard.build_sharded_polar_step(None, ff, ff.polar, panel="scan", **kw)


def test_float64_build_runs_on_cuda(dev):
    """A float64 build on the GPU goes through the f64-grade kernels and
    agrees with the plain float64 path."""
    names = ("pair_panel_df", "eind_panel_df", "dipole_panel_df")
    before = {k: panel.WRAPPERS[k].launches for k in names}
    bench = polar_bench.build_synthetic(4, dtype=torch.float64,
                                        precision=1e-11)
    f, en = polar_bench.setup_forces(bench)
    for k in names:
        assert panel.WRAPPERS[k].launches > before[k], k
    ref = polar_bench.build_synthetic(4, dtype=torch.float64,
                                      precision=1e-11, panel="scan")
    rf, ren = polar_bench.setup_forces(ref)
    assert abs(en["scf_iters"] - ren["scf_iters"]) <= 1
    for k in ("evdwl", "ecoul", "elong"):
        assert float(en[k]) == pytest.approx(float(ren[k]), rel=1e-10)
    assert float(en["epol"]) == pytest.approx(float(ren["epol"]), rel=1e-8)
    np.testing.assert_allclose(f.cpu().numpy(), rf.cpu().numpy(), rtol=0,
                               atol=1e-8 * rf.abs().max().item())


def test_float64_lj_only_kernel_build_raises_on_cuda(dev):
    """No f64-grade LJ-only kernel exists: a float64 kernel build of an
    LJ-only table on the GPU raises instead of running the plain version;
    panel="scan" is the plain path."""
    from lidp_tpu_torch.parallel import shard

    sysd = polar_bench.synthetic_system(4)
    ff = polar_bench.synthetic_forcefield(sysd, torch.float64, dev)
    ff = dataclasses.replace(ff, pair=dataclasses.replace(ff.pair,
                                                          coul=False),
                             ewald=None)
    kw = dict(n=3 * 4**3, dt=0.5, ftm2v=1.0, dtype=torch.float64, device=dev)
    with pytest.raises(NotImplementedError, match="panel='scan'"):
        shard.build_sharded_polar_step(None, ff, None, panel="kernel", **kw)
    shard.build_sharded_polar_step(None, ff, None, panel="scan", **kw)


@pytest.mark.parametrize("mixed", [False, True])
def test_float64_strips_run_kernels_on_cuda(dev, mixed):
    """Row strips of a float64 build go through the f64-grade kernels with
    cols=/row0= and agree with the whole block."""
    names = ("pair_panel_df", "eind_panel_df", "dipole_panel_df")
    out = []
    for strips in (1, 4):
        bench = polar_bench.build_synthetic(4, dtype=torch.float64,
                                            precision=1e-11,
                                            host_strips=strips)
        before = {k: panel.WRAPPERS[k].launches for k in names}
        strip_before = panel.eind_panel_df.launches_strip
        dstrip_before = panel.dipole_panel_df.launches_strip
        pstrip_before = panel.pair_panel_df.launches_strip
        f, en = polar_bench.host_setup_forces(bench, mixed=mixed)
        grew = {k: panel.WRAPPERS[k].launches - before[k] for k in names}
        assert grew["pair_panel_df"] == strips
        assert grew["dipole_panel_df"] == strips
        assert grew["eind_panel_df"] >= strips and \
            grew["eind_panel_df"] % strips == 0
        # one block: the whole-panel kernel; row strips: the strip kernel
        strip_grew = panel.eind_panel_df.launches_strip - strip_before
        assert strip_grew == (0 if strips == 1 else grew["eind_panel_df"])
        assert panel.dipole_panel_df.launches_strip - dstrip_before == (
            0 if strips == 1 else strips)
        assert panel.pair_panel_df.launches_strip - pstrip_before == (
            0 if strips == 1 else strips)
        assert en["scf_converged"]
        out.append((f, en))
    (f1, en1), (f4, en4) = out
    assert en1["scf_iters"] == en4["scf_iters"]
    for k in ("evdwl", "ecoul", "elong", "epol"):
        assert float(en4[k]) == pytest.approx(float(en1[k]), rel=1e-10)
    np.testing.assert_allclose(f4.cpu().numpy(), f1.cpu().numpy(), rtol=1e-9,
                               atol=1e-9 * f1.abs().max().item())


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


# ------------------------- the LJ cell kernels ---------------------------
#
# float32 against the plain versions (Newton half stencil, another
# summation order than the kernels' full stencil): forces 5e-6 of the
# largest force, evdwl and virial rel 1e-5 (tests/test_slot_runner.py's
# bar, chip_smoke.py's too).

def _load_chip_smoke():
    """chip_smoke.py at the repository root, as a module (it imports only
    the standard library until one of its functions is called)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lj_case(dev, which):
    """`ragged`: chip_smoke.ragged_lj_case; `cubic`: 6^3 fcc cells of the
    melt, jittered.  Returns (x, mask, box, pair, cells, slot runner)."""
    from lidp_tpu_torch.forcefield import ForceField
    from lidp_tpu_torch.integrate.slot_runner import SlotRunner
    from lidp_tpu_torch.models import lj_melt
    from lidp_tpu_torch.ops.cells import build_cells

    if which == "ragged":
        c = _load_chip_smoke().ragged_lj_case(dev)
        x, mask, box, pair, cfg, n = (c[k] for k in (
            "x", "mask", "box", "pair", "cfg", "n"))
    else:
        melt = lj_melt.build(scale=0.3, dtype=torch.float32,
                             neighbor="slots", cap_slack=3.0, device=dev)
        s = melt.system
        g = torch.Generator(device=dev).manual_seed(1)
        x = s.x + 0.1 * (torch.rand(s.x.shape, generator=g, device=dev) - 0.5)
        mask, box, pair = s.mask, s.box, melt.runner.ff.pair
        cfg, n = melt.runner.neighbor_cfg, melt.natoms
    cells = build_cells(x, mask, box, cfg)
    assert not bool(cells.overflow)
    sr = SlotRunner(ff=ForceField(pair=pair), neighbor_cfg=cfg, dt=0.005,
                    ftm2v=1.0, n=n)
    return x, mask, box, pair, cells, sr


def _lj_calls(dev, which, kernel, need_ev):
    from lidp_tpu_torch.ops import cell_kernels as ck

    x, mask, box, pair, cells, sr = _lj_case(dev, which)
    n = x.shape[0]
    if kernel == "cell_pair_forces_lj":
        args = (x, mask, cells, box, pair)
        return (ck.cell_pair_forces_lj, ck.cell_pair_forces_lj_plain, args,
                dict(need_ev=need_ev))
    xs = sr._slotify(x, torch.zeros_like(x), torch.ones(n, device=dev),
                     torch.arange(n, dtype=torch.int32, device=dev), mask,
                     box)[0]

    def flat(out):
        fg, ev, vir = out
        return torch.stack(list(fg), -1).reshape(-1, 3), ev, vir

    args = ([xs[..., d] for d in range(3)], box, pair)
    return (lambda *a, **k: flat(ck.slot_lj_forces(*a, **k)),
            lambda *a, **k: flat(ck.slot_lj_forces_plain(*a, **k)), args,
            dict(need_ev=need_ev))


def _lj_close(got, ref, need_ev):
    f, r = got[0].double().cpu().numpy(), ref[0].double().cpu().numpy()
    assert np.abs(r).max() > 1.0
    np.testing.assert_allclose(f, r, rtol=0, atol=5e-6 * np.abs(r).max())
    for g, r in zip(got[1:], ref[1:]):
        g, r = g.double().cpu().numpy(), r.double().cpu().numpy()
        if need_ev:
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=1e-5 * np.abs(r).max())
        else:
            assert not g.any()


LJ_KERNELS = ["slot_lj_forces", "cell_pair_forces_lj"]


@pytest.mark.parametrize("need_ev", [True, False])
@pytest.mark.parametrize("which", ["ragged", "cubic"])
@pytest.mark.parametrize("kernel", LJ_KERNELS)
def test_lj_cell_kernel_matches_plain(dev, kernel, which, need_ev):
    from lidp_tpu_torch.ops import cell_kernels as ck

    wrapper, plain, args, kw = _lj_calls(dev, which, kernel, need_ev)
    before = ck.WRAPPERS[kernel].launches
    got = wrapper(*args, **kw)
    torch.cuda.synchronize()
    assert ck.WRAPPERS[kernel].launches == before + 1
    _lj_close(got, plain(*args, **kw), need_ev)
    again = wrapper(*args, **kw)
    for a, b in zip(got, again):
        assert torch.equal(a, b)        # no atomics: bit-identical


@pytest.mark.parametrize("need_ev", [True, False])
@pytest.mark.parametrize("which", ["full", "scattered"])
@pytest.mark.parametrize("kernel", LJ_KERNELS)
def test_lj_cell_kernel_full_and_scattered_grids(dev, kernel, which,
                                                 need_ev):
    """A grid whose every slot holds an atom (chip_smoke.full_lj_case), and
    the ragged grid with each cell's slots in a random order, so that the
    live slots are no prefix of their cell (chip_smoke.scatter_slots):
    the kernel against its plain version, repeats bit-identical."""
    from lidp_tpu_torch.ops import cell_kernels as ck

    cs = _load_chip_smoke()
    c = cs.full_lj_case(dev) if which == "full" else cs.ragged_lj_case(dev)
    calls = cs.lj_kernel_calls(*(c[k] for k in ("x", "mask", "box", "pair",
                                                "cfg", "n")),
                               scatter=which == "scattered")
    _, live, kern, plain, timed = calls[kernel]
    assert bool(live.all()) == (which == "full")
    before = ck.WRAPPERS[kernel].launches
    got = kern(need_ev)
    torch.cuda.synchronize()
    assert ck.WRAPPERS[kernel].launches == before + 1

    def flat(out):
        return (out[0].reshape(-1, 3), *out[1:])

    _lj_close(flat(got), flat(plain(need_ev)), need_ev)
    for again in (kern(need_ev), timed(need_ev)):
        for a, b in zip(got, again):
            assert torch.equal(a, b)    # no atomics: bit-identical


@pytest.mark.parametrize("where", ["wide_last", "narrow_first",
                                   "parent_last", "narrow_last"])
@pytest.mark.parametrize("kernel", LJ_KERNELS)
def test_lj_cell_kernel_at_the_tile_caps(dev, kernel, where):
    """Dense grids (chip_smoke.dense_lj_case) at the caps where the
    launcher changes tile: the wide tile's largest, the narrow tile's
    smallest and largest, and 358, the largest the kernel took before the
    narrow tile; the kernel against its plain version, repeats
    bit-identical.  One past the narrow tile's largest raises."""
    from lidp_tpu_torch.ops import cell_kernels as ck
    from lidp_tpu_torch.ops.cells import build_cells

    cs = _load_chip_smoke()
    cw, cn = cs.tile_caps(kernel)
    assert 100 < cw < 358 <= cn
    cap, tile = dict(wide_last=(cw, 1), narrow_first=(cw + 1, 2),
                     parent_last=(358, 2), narrow_last=(cn, 2))[where]
    assert ck.kernel_tile(kernel, (3, 3, 3, cap), dev.index or 0)[0] == tile
    c = cs.dense_lj_case(cap, dev)
    keys = ("x", "mask", "box", "pair", "cfg", "n")
    _, live, kern, plain, _ = cs.lj_kernel_calls(
        *(c[k] for k in keys))[kernel]
    assert int(live.sum(-1).max()) > 0.8 * cap
    for need_ev in (True, False):
        got = kern(need_ev)
        torch.cuda.synchronize()
        _lj_close((got[0].reshape(-1, 3), *got[1:]),
                  (plain(need_ev)[0].reshape(-1, 3), *plain(need_ev)[1:]),
                  need_ev)
        for a, b in zip(got, kern(need_ev)):
            assert torch.equal(a, b)    # no atomics: bit-identical
    if where == "narrow_last":
        over = build_cells(c["x"], c["mask"], c["box"],
                           dataclasses.replace(c["cfg"], cap=cn + 1))
        with pytest.raises(ValueError, match="shared memory"):
            if kernel == "slot_lj_forces":
                ck.slot_lj_forces([over.atom_of_slot.float()] * 3, c["box"],
                                  c["pair"])
            else:
                ck.cell_pair_forces_lj(c["x"], c["mask"], over, c["box"],
                                       c["pair"])


def test_cell_pair_forces_lj_on_an_overflowing_grid(dev):
    """chip_smoke.overflow_lj_parity: on a grid whose cap the full cell
    overflows, the kernel equals its plain version (need_ev off and on,
    repeats bit-identical), so the atoms that found no slot take the force
    of the slot they share, which is not zero; one launch a call."""
    from lidp_tpu_torch.ops import cell_kernels as ck

    before = ck.cell_pair_forces_lj.launches
    _, missed = _load_chip_smoke().overflow_lj_parity()
    assert missed > 0
    assert ck.cell_pair_forces_lj.launches == before + 4


def test_runner_forces_follow_a_changing_box(dev):
    """Runner on the cell kernel with an end_of_step hook that scales the
    box and the atoms by 1.002 at every step, as fix press/berendsen does:
    each step's forces match the plain version on that step's box (the
    kernel's scalars hold the box lengths, so scalars kept from an earlier
    box would shift the periodic images wrongly)."""
    from lidp_tpu_torch.models import lj_melt
    from lidp_tpu_torch.ops import cell_kernels as ck
    from lidp_tpu_torch.ops.cells import build_cells

    melt = lj_melt.build(scale=0.5, dtype=torch.float32, neighbor="cells",
                         device=dev)
    cfg, pair = melt.runner.neighbor_cfg, melt.runner.ff.pair
    # the fcc lattice's forces cancel to rounding: jitter it
    rs = np.random.RandomState(11)
    x0 = melt.system.x + torch.as_tensor(
        rs.uniform(-0.05, 0.05, tuple(melt.system.x.shape)),
        dtype=torch.float32, device=dev)
    seen = []

    def grow(sys, res):
        lo, L = sys.box.lo, sys.box.lengths
        box = dataclasses.replace(sys.box, hi=lo + 1.002 * L)
        return sys.replace(x=lo + 1.002 * (sys.x - lo), box=box)

    def check(sys, f):
        cells = build_cells(sys.x, sys.mask, sys.box, cfg)
        ref = ck.cell_pair_forces_lj_plain(sys.x, sys.mask, cells, sys.box,
                                           pair, need_ev=False)[0]
        seen.append((f.clone(), ref, float(sys.box.lengths[0])))
        return f

    runner = dataclasses.replace(melt.runner, end_of_step=grow,
                                 post_force=check, rebuild_every=1)
    before = ck.cell_pair_forces_lj.launches
    runner.run(*runner.setup(melt.system.replace(x=x0)), 5)
    assert ck.cell_pair_forces_lj.launches - before >= 6
    assert len(seen) >= 6
    assert seen[-1][2] > seen[0][2] * 1.009     # the box grew
    for f, ref, _ in seen:
        assert float(ref.abs().max()) > 1.0
        np.testing.assert_allclose(
            f.double().cpu().numpy(), ref.double().cpu().numpy(), rtol=0,
            atol=5e-6 * float(ref.abs().max()))


def test_slot_lj_forces_separate_grids(dev):
    """Three contiguous grids and the three columns of one (...,3) tensor
    are the same input."""
    from lidp_tpu_torch.ops import cell_kernels as ck

    _, _, (grids, box, pair), kw = _lj_calls(dev, "ragged", "slot_lj_forces",
                                             True)
    a = ck.slot_lj_forces(grids, box, pair)
    b = ck.slot_lj_forces([g.contiguous() for g in grids], box, pair)
    for u, v in zip((*a[0], *a[1:]), (*b[0], *b[1:])):
        assert torch.equal(u, v)
    with pytest.raises(ValueError, match="strided"):
        ck.slot_lj_forces([g.transpose(0, 1) for g in grids], box, pair)


@pytest.mark.parametrize("kernel", LJ_KERNELS)
def test_lj_cell_kernel_float64_raises(dev, kernel):
    """float64 goes to ops/cells.cell_pair_forces, never into the kernels:
    the wrappers raise TypeError, cast nothing and fall back to nothing."""
    from lidp_tpu_torch.ops import cell_kernels as ck

    x, mask, box, pair, cells, sr = _lj_case(dev, "ragged")
    before = ck.WRAPPERS[kernel].launches
    with pytest.raises(TypeError, match="expected torch.float32"):
        if kernel == "cell_pair_forces_lj":
            ck.cell_pair_forces_lj(x.double(), mask, cells, box, pair)
        else:
            g = torch.zeros((3, 4, 5, 16), dtype=torch.float64, device=dev)
            ck.slot_lj_forces([g, g, g], box, pair)
    assert ck.WRAPPERS[kernel].launches == before


def test_lj_cell_kernel_two_bins_raises(dev):
    from lidp_tpu_torch.ops import cell_kernels as ck

    _, _, box, pair, _, _ = _lj_case(dev, "ragged")
    g = torch.zeros((2, 4, 5, 16), device=dev)
    with pytest.raises(ValueError, match=">= 3 bins"):
        ck.slot_lj_forces([g, g, g], box, pair)


def test_compute_forces_routes_on_cuda(dev):
    """On the GPU compute_forces launches cell_pair_forces_lj when its gate
    holds (one type, float32) and runs the plain roll kernel when it does
    not (two types), counting only the former."""
    from lidp_tpu_torch.forcefield import ForceField, compute_forces
    from lidp_tpu_torch.ops import cell_kernels as ck
    from lidp_tpu_torch.ops.cells import cell_pair_forces
    from lidp_tpu_torch.ops.pair import make_pair_params
    from lidp_tpu_torch.state import make_system

    x, mask, box, pair, cells, _ = _lj_case(dev, "ragged")
    sys1 = make_system(x, box=box, mask=mask, device=dev)
    before = ck.cell_pair_forces_lj.launches
    res = compute_forces(sys1, ForceField(pair=pair), cells)
    assert ck.cell_pair_forces_lj.launches == before + 1
    ref = cell_pair_forces(x, sys1.q, sys1.type, mask, cells, box, pair)
    _lj_close((res.f, res.evdwl, res.virial), (ref[0], ref[1], ref[3]), True)
    assert not res.f[~mask].any()

    e = np.ones((3, 3)); e[0] = e[:, 0] = 0.0
    two = make_pair_params(e, e, 2.5 * e, coul=False, dtype=torch.float32,
                           device=dev)
    typ = torch.arange(x.shape[0], device=dev) % 2 + 1
    sys2 = dataclasses.replace(sys1, type=typ.to(torch.int32))
    res2 = compute_forces(sys2, ForceField(pair=two), cells)
    assert ck.cell_pair_forces_lj.launches == before + 1
    _lj_close((res2.f, res2.evdwl, res2.virial), (ref[0], ref[1], ref[3]),
              True)


# ------------------- the pair kernels at the cutoff ----------------------

def test_cutoff_pairs_strip_and_whole_kernels(dev):
    """chip_smoke.cutoff_pairs_case: a pair at exactly the outer cutoff and
    one ulp inside it, which a rsq contracted into fused multiply-adds puts
    on the other side.  The strip kernel (cols, row0) and the whole kernel
    decide each pair as the plain version does (the same rows take a force
    and the field, exactly zero elsewhere), float32 and float64
    (chip_smoke.cutoff_pairs_parity)."""
    sysd = polar_bench.synthetic_system(2)
    ff = polar_bench.synthetic_forcefield(sysd, torch.float32, dev)
    _load_chip_smoke().cutoff_pairs_parity(ff.pair)


def test_dipole_cutoff_pairs_strip_and_whole_kernels(dev):
    """chip_smoke.dipole_cutoff_case: the same pairs with dipoles, one or
    every atom of them polar.  The dipole strip kernel (cols, row0) and
    whole kernel, float32 and float64, give the plain version's forces and
    scalars at the bars above, and with one polar atom put the charge-
    dipole force on the plain version's rows, 2 and 3 only
    (chip_smoke.dipole_cutoff_parity)."""
    sysd = polar_bench.synthetic_system(2)
    ff = polar_bench.synthetic_forcefield(sysd, torch.float32, dev)
    _load_chip_smoke().dipole_cutoff_parity(ff.pair, ff.polar)


# --------------- rigid molecules through FastPolarRunner ----------------

def _rigid_run(panel_kind, n_side, steps):
    bench = polar_bench.build_rigid(n_side, panel=panel_kind)
    rows = [polar_bench.setup_rigid(bench)]
    states = [bench.state]
    for _ in range(steps):
        rows += polar_bench.run_rigid(bench, 1)
        states.append(bench.state)
    return bench, rows, states


def test_rigid_step_through_kernels_matches_plain(dev):
    """Path G's step on the 375-atom fluid as rigid molecules (float32,
    fused): setup + 3 steps through the kernels against the plain float32
    route (panel="scan") on the same card: forces rtol 1e-3, atol 2e-4 of
    max |f| (test_step_through_kernels_matches_plain's bar), energies rel
    1e-5 (epol rel 1e-4, abs 2e-2), positions 1e-5 of the box,
    quaternions 1e-5."""
    (kb, krows, kst), (pb, prows, pst) = (_rigid_run(p, 5, 3)
                                         for p in ("kernel", "scan"))
    n = kb.natoms
    for (ks, kr, ki), (ps, pr, pi), kw, pw in zip(kst, pst, krows, prows):
        a, b = kr.f[:n].double().cpu(), pr.f[:n].double().cpu()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=2e-4 * b.abs().max().item())
        for k in ("evdwl", "ecoul", "elong"):
            assert kw[k] == pytest.approx(pw[k], rel=1e-5), k
        assert kw["epol"] == pytest.approx(pw["epol"], rel=1e-4, abs=2e-2)
        np.testing.assert_allclose(ks.x[:n].cpu().numpy(),
                                   ps.x[:n].cpu().numpy(), rtol=0,
                                   atol=1e-5 * 20.0)
        np.testing.assert_allclose(ki.quat.cpu().numpy(),
                                   pi.quat.cpu().numpy(), rtol=0, atol=1e-5)


def test_unwrapped_shift_through_kernels(dev):
    """The 1,536-atom fluid moved by +L/2 along x and left unwrapped (half
    of the atoms beyond the box, 12 tiles of the whole kernels, so the
    tile-pair test drops some) through the kernels, against the plain
    route on the wrapped coordinates: forces and dipoles at the float32
    bars above."""
    out = []
    for panel_kind, wrap in (("kernel", False), ("scan", True)):
        bench = polar_bench.build_rigid(8, panel=panel_kind)
        s = bench.system
        L = s.box.lengths
        x = s.x + torch.tensor([0.5 * float(L[0]), 0.0, 0.0], device=dev)
        if wrap:
            x = x - torch.floor(x / L) * L
        x = torch.where(s.mask[:, None], x, 0.0)
        out.append(bench.runner.forces(s.replace(x=x)))
    n = 3 * 8**3
    for name in ("f", "mu"):
        a = getattr(out[0], name)[:n].double().cpu().numpy()
        b = getattr(out[1], name)[:n].double().cpu().numpy()
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=2e-4 * np.abs(b).max(), err_msg=name)
