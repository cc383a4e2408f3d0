"""Shared inputs and runners of the k-space breadth tests
(tests/test_torch_dispersion.py, test_torch_pppm_disp.py,
test_torch_tip4p.py, test_torch_msm.py, test_torch_kspace_routes.py):
each script through the JAX package's LammpsScript and the port's, float64
on the CPU, in this process, with the dense cap of both mocked where a
case runs on the cell grid."""

import os
from unittest import mock

import numpy as np
import torch

import chip_smoke
from lidp_tpu import sim as jsim
from lidp_tpu.io import script as jscript
from lidp_tpu_torch.io import script as tscript
from lidp_tpu_torch.parallel import fast_polar as tfast

QQRD2E = 332.06371
# the thermo columns of the point-charge fluid's rows
COLS = chip_smoke.G64_COLS
FLUID_PAIR = "pair_style lj/cut/coul/long 6.0 6.5"


def fluid_long(pair, kspace="ewald/disp 1e-4", extra=""):
    """chip_smoke.point_charge_script with `pair_style <pair>` for the
    fluid's lj/cut/coul/long, `kspace_style <kspace>`, and `extra` lines
    after read_data."""
    t = chip_smoke.point_charge_script().replace(FLUID_PAIR,
                                                 f"pair_style {pair}")
    t = t.replace("kspace_style ewald/disp 1e-4", f"kspace_style {kspace}")
    return t.replace("read_data fluid.data\n",
                     "read_data fluid.data\n" + extra)


def buck_long(kspace="ewald/disp 1e-4", extra=""):
    """The fluid with buck/long/coul/long: every type pair set, the C
    table geometric (C_12 = sqrt(C_11 C_22)), A and rho as a Buckingham
    water-like pair would have them."""
    c11, c22 = 600.0, 30.0
    t = fluid_long("buck/long/coul/long long long 6.0 6.5", kspace, extra)
    return t.replace(
        "pair_coeff 1 1 0.1 3.0\npair_coeff 1 2 0.05 2.7\n"
        "pair_coeff 2 2 0.03 2.5\n",
        f"pair_coeff 1 1 50000.0 0.25 {c11}\n"
        f"pair_coeff 1 2 9000.0 0.24 {float(np.sqrt(c11 * c22))!r}\n"
        f"pair_coeff 2 2 2000.0 0.23 {c22}\n")


def run(pkg, d, text, nstep=None, cap=None, name=None, log=None):
    """`text` (written to d/in.<name or pkg>) through the JAX package's
    or the port's LammpsScript in float64 (the port on the CPU), with
    `nstep` set where given and both packages' dense cap mocked to `cap`;
    LIDP_FAST_POLAR unset.  Returns the script."""
    path = d / f"in.{name or pkg}"
    path.write_text(text)
    kw = {} if log is None else dict(log=log)
    if pkg == "jax":
        import jax.numpy as jnp

        s = jscript.LammpsScript(dtype=jnp.float64, **kw)
    else:
        s = tscript.LammpsScript(dtype=torch.float64, device="cpu", **kw)
    if nstep is not None:
        s.variables["nstep"] = str(nstep)
    cap = cap or jsim.DENSE_PATH_MAX_ATOMS
    env = {k: v for k, v in os.environ.items()
           if k not in ("LIDP_FAST_POLAR", "LIDP_FAST_POLAR_MODE")}
    with mock.patch.dict(os.environ, env, clear=True), \
            mock.patch.object(jsim, "DENSE_PATH_MAX_ATOMS", cap), \
            mock.patch.object(tfast, "DENSE_PATH_MAX_ATOMS", cap):
        s.file(str(path))
    return s


def rows_match(tag, ts, js, cols=COLS, rel=1e-8, cancel=None):
    """The port's rows within rel of max(1, |value|) of JAX's (plus
    chip_smoke.CANCEL_REL of `cancel`), as many rows on each side; the
    final x and v within 1e-8 of their largest entry."""
    assert len(ts.thermo_rows) == len(js.thermo_rows) > 0
    chip_smoke.rows_agree(tag, ts.thermo_rows, js.thermo_rows,
                          [rel] * len(js.thermo_rows), cols=cols,
                          cancel=cancel)
    n = ts._sim.natoms
    for k in ("x", "v"):
        a = getattr(ts._sim.sys, k)[:n].numpy()
        b = np.asarray(getattr(js._sim.sys, k))[:n]
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-8 * np.abs(b).max(),
                                   err_msg=f"{tag} {k}")


def close(a, b, tol, msg=""):
    """a within tol of max |b| of b, entry by entry."""
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=tol * max(np.abs(b).max(), 1e-300),
                               err_msg=msg)


def scalar_close(a, b, rel, msg=""):
    a, b = float(a), float(b)
    assert abs(a - b) <= rel * max(abs(b), 1e-300), (msg, a, b)
