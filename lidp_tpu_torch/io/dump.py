"""Trajectory dump writer: ``dump custom`` and ``dump atom`` text frames
(lidp_tpu/io/dump.py write_dump_frame, an own copy reading the port's
tensors; the Python row formatter, not the compiled one).

Matches the reference Dump::write (dump.cpp:302) / DumpCustom text layout
(columns like ``x y z type mol``), with ``dump_modify sort id`` ordering
(the arrays are already id-ordered).  The per-atom compute columns c_ID
and c_ID[i] (computes.eval_peratom) and fix ave/atom's f_ID and f_ID[i]
(zeros before its first Nfreq), as the JAX writer forms them (its
io/dump.py:45-60).  The xyz, dcd, cfg, image and movie styles and dump
local are not ported (ROADMAP queue 1 items 6.17 and 6.15).
"""

from __future__ import annotations

import numpy as np

_INT_COLS = {"id", "type", "mol"}
COLUMNS = ("id", "type", "mol", "x", "y", "z", "xs", "ys", "zs", "xu", "yu",
           "zu", "vx", "vy", "vz", "q", "fx", "fy", "fz", "mux", "muy",
           "muz")


def _np(t, n):
    return t[:n].double().cpu().numpy()


def write_dump_frame(spec, sys, script, gmask, f=None):
    """Append one frame of dump `spec` (style custom or atom) for the atoms
    of the group mask `gmask` (numpy, the script's real atoms): positions
    wrapped into the box on periodic dimensions (the engine keeps rigid
    coordinates unwrapped), unwrapped ones as xu yu zu.  f: the forces of
    the frame's step (zeros when absent)."""
    for c in spec.columns:
        if c not in COLUMNS and not c.startswith(("c_", "f_")):
            raise NotImplementedError(
                f"dump column {c} is not ported (only {', '.join(COLUMNS)}, "
                "c_ID and f_ID; ROADMAP queue 1 item 4)")
    n = len(gmask)
    x = _np(sys.x, n)
    v = _np(sys.v, n)
    mu = _np(sys.mu, n)
    fv = _np(f, n) if f is not None else np.zeros_like(x)
    # wrap into the box for output, only on periodic dims: the reference
    # never remaps f/s/m boundaries (Dump::write, dump.cpp)
    lo = sys.box.lo.double().cpu().numpy()
    hi = sys.box.hi.double().cpu().numpy()
    L = hi - lo
    per = np.asarray(sys.box.periodic, bool)
    xw = np.where(per, x - np.floor((x - lo) / L) * L, x)
    ids = np.nonzero(gmask)[0]
    colvec = {
        "id": ids + 1,
        "x": xw[ids, 0], "y": xw[ids, 1], "z": xw[ids, 2],
        # scaled coords (dump atom default)
        "xs": (xw[ids, 0] - lo[0]) / L[0],
        "ys": (xw[ids, 1] - lo[1]) / L[1],
        "zs": (xw[ids, 2] - lo[2]) / L[2],
        "xu": x[ids, 0], "yu": x[ids, 1], "zu": x[ids, 2],
        "type": np.asarray(script.type)[ids],
        "mol": np.asarray(script.mol)[ids],
        "vx": v[ids, 0], "vy": v[ids, 1], "vz": v[ids, 2],
        "q": _np(sys.q, n)[ids],
        "fx": fv[ids, 0], "fy": fv[ids, 1], "fz": fv[ids, 2],
        "mux": mu[ids, 0], "muy": mu[ids, 1], "muz": mu[ids, 2],
    }
    for c in spec.columns:
        if c.startswith(("c_", "f_")):
            colvec[c] = _peratom_column(script, c, n)[ids]
    mode = "a" if getattr(spec, "_started", False) else "w"
    with open(spec.path, mode) as fh:
        fh.write("ITEM: TIMESTEP\n%d\n" % int(sys.step))
        fh.write("ITEM: NUMBER OF ATOMS\n%d\n" % len(ids))
        fh.write("ITEM: BOX BOUNDS pp pp pp\n")
        for d in range(3):
            fh.write("%-1.16e %-1.16e\n" % (lo[d], hi[d]))
        fh.write("ITEM: ATOMS " + " ".join(spec.columns) + "\n")
        vals = np.stack([np.asarray(colvec[c], np.float64)
                         for c in spec.columns], axis=1)
        flags = [c in _INT_COLS for c in spec.columns]
        ffmt = getattr(spec, "float_fmt", "%g")
        for r in range(vals.shape[0]):
            fh.write(" ".join(
                str(int(vals[r, c])) if flags[c] else ffmt % vals[r, c]
                for c in range(vals.shape[1])) + "\n")
    spec._started = True


def _peratom_column(script, c, n):
    """A dump column c_ID[/i] (a per-atom compute, a chunk/atom compute's
    chunk ids) or f_ID[/i] (fix ave/atom's average, zeros before it has
    one) as an (n,) numpy array."""
    from lidp_tpu_torch import computes

    sim = script._sim
    name = c[2:].split("[")[0]
    if c.startswith("c_"):
        if name not in sim.peratom_computes \
                and name not in sim.chunk_computes:
            raise ValueError(f"dump column {c}: compute {name} is not a "
                             "per-atom compute")
    elif script.fixes[name].style != "ave/atom":
        raise NotImplementedError(
            f"dump column {c}: only fix ave/atom's per-atom values are "
            "ported (fix store/state: ROADMAP queue 1 item 6.16)")
    return computes.peratom_column(sim, c).cpu().numpy()[:n]
