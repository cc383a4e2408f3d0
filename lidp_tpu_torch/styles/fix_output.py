"""The output fixes (lidp_tpu/sim.py _host_fixes, _fix_vector_sample,
_ave_time, _ave_histo, _histo_emit, _ave_correlate, _ave_chunk,
_global_array, eval_slice): fix print, ave/time, ave/atom, ave/histo,
ave/histo/weight, ave/correlate, vector, ave/chunk, store/state and
controller, sampled on the host at run-chunk boundaries (their periods
fold into the chunk gcd, Simulation.run).

Each keeps its buffers and its file on its FixSpec, so that they carry
over a second `run` as the reference's fix objects do, and writes its file
line for line as the JAX package does.  The global values come from the
Simulation's thermo row (one device read a row); the per-atom ones from
computes.peratom_column; the global arrays (the */chunk computes,
heat/flux, compute slice of them) from global_array.  Where the JAX
package reads a keyword nowhere, or samples 0.0 for a value its thermo row
lacks, the port raises NotImplementedError naming ROADMAP queue 3 items 25
and 26.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from lidp_tpu_torch import computes

# the output fix styles, which have no builder (styles/__init__.py)
OUTPUT_STYLES = ("print", "ave/time", "ave/atom", "ave/histo",
                 "ave/histo/weight", "ave/correlate", "vector", "ave/chunk",
                 "store/state", "controller")
_SKIPPED = "ROADMAP queue 3 item 25, keywords JAX skips"
_NO_VALUE = "ROADMAP queue 3 item 26, values JAX's thermo row lacks"
# fix ave/chunk's per-atom values (fix_ave_chunk.cpp as the JAX package
# takes them)
AVE_CHUNK_VALUES = ("vx", "vy", "vz", "fx", "fy", "fz", "density/number",
                    "density/mass", "temp")


def _skipped(style, kw):
    raise NotImplementedError(
        f"fix {style} keyword {kw}: the JAX package reads it nowhere, and the "
        f"port does not take it ({_SKIPPED})")


def parse_print(args):
    """fix print N "message" [file F]: (N, message, file or None).  The
    tokenizer split the quoted message; it is put back together."""
    msg_toks = []
    rest = list(args[1:])
    while rest:
        t = rest.pop(0)
        msg_toks.append(t)
        if t.endswith('"') and (len(msg_toks) > 1 or len(t) > 1):
            break
    msg = " ".join(msg_toks).strip('"')
    fpath = None
    while rest:
        if rest[0] == "file":
            fpath = rest[1]
        else:
            _skipped("print", rest[0])
        rest = rest[2:]
    return int(args[0]), msg, fpath


def parse_ave_time(args):
    """fix ave/time Nevery Nrepeat Nfreq value... [mode scalar|vector]
    [file F]: (Nevery, Nrepeat, Nfreq, values, mode, file)."""
    nev, nrep, nfreq = int(args[0]), int(args[1]), int(args[2])
    vals, mode, fpath = [], "scalar", None
    i = 3
    while i < len(args):
        if args[i] == "mode":
            mode = args[i + 1]
            i += 2
        elif args[i] == "file":
            fpath = args[i + 1]
            i += 2
        elif args[i] in ("ave", "start", "format", "off", "title1",
                         "title2", "title3"):
            # JAX's _ave_time skips them: one window of Nrepeat, its own
            # format and titles
            _skipped("ave/time", args[i])
        else:
            vals.append(args[i])
            i += 1
    return nev, nrep, nfreq, vals, mode, fpath


def parse_ave_histo(args):
    """fix ave/histo[/weight] Nevery Nrepeat Nfreq lo hi Nbin value...
    [file F]."""
    nev, nrep, nfreq = int(args[0]), int(args[1]), int(args[2])
    lo, hi, nbin = float(args[3]), float(args[4]), int(args[5])
    vals, fpath = [], None
    i = 6
    while i < len(args):
        if args[i] == "file":
            fpath = args[i + 1]
            i += 2
        elif args[i] in ("mode", "ave", "start", "beyond", "overwrite",
                         "title1", "title2", "title3", "kind"):
            _skipped("ave/histo", args[i])
        else:
            vals.append(args[i])
            i += 1
    return nev, nrep, nfreq, lo, hi, nbin, vals, fpath


def parse_ave_correlate(args):
    """fix ave/correlate Nevery Nrepeat Nfreq value... [type auto] [file
    F]: the JAX package computes the auto-correlation whatever `type`
    says, so only `type auto` is taken."""
    nev, nrep, nfreq = int(args[0]), int(args[1]), int(args[2])
    vals, fpath = [], None
    i = 3
    while i < len(args):
        if args[i] == "file":
            fpath = args[i + 1]
            i += 2
        elif args[i] == "type" and args[i + 1] == "auto":
            i += 2
        elif args[i] in ("type", "ave", "start", "prefactor", "overwrite",
                         "title1", "title2", "title3"):
            _skipped("ave/correlate", f"{args[i]} {args[i + 1]}"
                     if args[i] == "type" else args[i])
        else:
            vals.append(args[i])
            i += 1
    return nev, nrep, nfreq, vals, fpath


def parse_ave_chunk(args):
    """fix ave/chunk Nevery Nrepeat Nfreq chunkID value... [file F]:
    (Nevery, Nrepeat, Nfreq, chunkID, values, file).  The JAX package
    steps over any other word by two (so a c_ID value takes the word after
    it) and reads norm, ave and bias without using them: the port raises
    on them, as on every value it does not take."""
    nev, nrep, nfreq = int(args[0]), int(args[1]), int(args[2])
    vals, fpath = [], None
    i = 4
    while i < len(args):
        if args[i] in AVE_CHUNK_VALUES:
            vals.append(args[i])
            i += 1
        elif args[i] == "file":
            fpath = args[i + 1]
            i += 2
        else:
            _skipped("ave/chunk", args[i])
    return nev, nrep, nfreq, args[3], vals, fpath


def check_global(script, tok, what):
    """A global vector or array input c_ID / c_ID[j] (global_array): of a
    */chunk compute that gives an array, or of heat/flux."""
    name = tok[2:].split("[")[0] if tok.startswith("c_") else None
    spec = script.computes.get(name)
    style = spec[1] if spec else None
    if style == "temp/chunk" and not computes.temp_chunk_keywords(
            spec[2]["extra"], script.dimension)[3]:
        style = None          # its scalar (the JAX package's too)
    if style not in computes.CHUNK_AGG_STYLES + ("heat/flux",):
        raise ValueError(f"{what} input {tok}: not a global vector or array "
                         "compute (the */chunk computes, heat/flux)")


def check_spec(script, spec):
    """Parse a new output fix's arguments at its definition (raising on
    what the port does not take), and its values against the script."""
    st = spec.style
    a = list(spec.args)
    if st == "print":
        parse_print(a)
        return
    if st == "ave/time":
        vals, mode = parse_ave_time(a)[3:5]
        if mode not in ("scalar", "vector"):
            raise ValueError(f"fix ave/time mode {mode}")
        if mode == "vector":
            for t in vals:
                name = t[2:].split("[")[0] if t.startswith("c_") else None
                if script.computes.get(name, (None, None))[1] != "slice":
                    check_global(script, t, "fix ave/time mode vector")
        else:
            _check_scalars(script, "ave/time", vals)
        return
    if st in ("ave/histo", "ave/histo/weight"):
        vals = parse_ave_histo(a)[6]
        if st == "ave/histo/weight" and len(vals) != 2:
            raise ValueError("fix ave/histo/weight takes two values")
        return
    if st == "ave/correlate":
        _check_scalars(script, "ave/correlate", parse_ave_correlate(a)[3])
        return
    if st == "vector":
        _check_scalars(script, "vector", a[1:])
        return
    if st == "ave/chunk":
        nev, nrep, nfreq, ccid = parse_ave_chunk(a)[:4]
        if not (nev > 0 and nrep > 0 and nfreq > 0 and nfreq % nev == 0
                and nrep * nev <= nfreq):
            raise ValueError("Illegal fix ave/chunk command: Nfreq a "
                             "multiple of Nevery, Nrepeat*Nevery <= Nfreq")
        if script.computes.get(ccid, (None, None))[1] != "chunk/atom":
            raise ValueError(f"fix ave/chunk: chunk/atom compute {ccid} "
                             "does not exist")
        return
    if st == "store/state":
        check_store_state(script, a)
        return
    if st == "controller":
        check_controller(script, a)
        return
    if st == "ave/atom":
        for t in a[3:]:
            if t.startswith("v_"):
                raise NotImplementedError(
                    f"fix ave/atom input {t}: atom-style variables are not "
                    "ported (ROADMAP queue 1 item 6, breadth)")


def _check_scalars(script, style, vals):
    for t in vals:
        if t.startswith("f_"):
            raise NotImplementedError(
                f"fix {style} value {t}: JAX's thermo row has no fix's "
                f"value; it samples 0.0 ({_NO_VALUE})")
        if t.startswith("c_") and t[2:].split("[")[0] not in script.computes:
            raise ValueError(f"fix {style}: compute {t[2:]} does not exist")


def _row_value(sim, what, style):
    """A global value of the thermo row (lidp_tpu/sim.py's lookup: c_ID
    and c_ID[i], thermo keywords, v_NAME of the thermo columns).  The JAX
    package samples 0.0 where the row lacks it; the port raises."""
    row = sim.thermo_row()
    key = what[2:] if what.startswith("c_") else what.lower()
    v = row.get("c_" + key, row.get(key))
    if v is None:
        raise NotImplementedError(
            f"fix {style} value {what}: not in the thermo row (the JAX "
            f"package samples 0.0; {_NO_VALUE})")
    return float(v)


def host_fixes(sim, step):
    """Every output fix at step, in declaration order (_host_fixes)."""
    for spec in list(sim.script.fixes.values()):
        st = spec.style
        if st == "print":
            fix_print(sim, spec, step)
        elif st == "ave/atom":
            ave_atom(sim, spec, step)
        elif st in ("ave/histo", "ave/histo/weight"):
            ave_histo(sim, spec, step)
        elif st == "ave/correlate":
            ave_correlate(sim, spec, step)
        elif st == "vector":
            vector_sample(sim, spec, step)
        elif st == "ave/time":
            ave_time(sim, spec, step)
        elif st == "ave/chunk":
            ave_chunk(sim, spec, step)
        elif st == "store/state":
            store_state(sim, spec, step)
        elif st == "controller":
            controller(sim, spec, step)


def _write(sim, spec, fpath, text):
    """Append text to the fix's file (truncated at its first write)."""
    mode = "a" if getattr(spec, "_started", False) else "w"
    with open(os.path.join(sim.script.root, fpath), mode) as fh:
        fh.write(text)
    spec._started = True


def fix_print(sim, spec, step):
    """fix print (fix_print.cpp): the message with ${name} substituted
    (a thermo keyword of the row, else a variable; floats %.8g) every N
    steps, to the log or the file."""
    nev, msg, fpath = parse_print(spec.args)
    if not nev or step % nev:
        return
    row = sim.thermo_row()

    def sub(m):
        k = m.group(1)
        v = row.get(k.lower())
        if v is None:
            v = sim.script.var_str(k)
            if v is None:
                v = ""
        return f"{v:.8g}" if isinstance(v, float) else str(v)

    out = re.sub(r"\$\{(\w+)\}", sub, msg)
    if fpath:
        _write(sim, spec, fpath, out + "\n")
    else:
        sim.script.log(out)


def ave_atom(sim, spec, step):
    """fix ave/atom Nevery Nrepeat Nfreq value... (fix_ave_atom.cpp): the
    per-atom means of the last Nrepeat samples, refreshed every Nfreq and
    read as f_ID[col] by dumps and compute reduce."""
    a = spec.args
    nev, nrep, nfreq = int(a[0]), int(a[1]), int(a[2])
    if nev and step % nev == 0:
        cols = [computes.peratom_column(sim, t) for t in a[3:]]
        sample = cols[0] if len(cols) == 1 else torch.stack(cols, dim=1)
        buf = getattr(spec, "_samples", [])
        buf.append(sample)
        spec._samples = buf[-nrep:]
    if nfreq and step % nfreq == 0 and getattr(spec, "_samples", None):
        spec._peratom_store = torch.stack(spec._samples).mean(0)
        sim.bump_generation()


def vector_sample(sim, spec, step):
    """fix vector Nevery value... (fix_vector.cpp): append the values to a
    growing series on the Nevery grid; also at run setup (FixVector::setup
    samples when the step is on the grid).  _last_step guards against a
    sample taken twice at a run boundary."""
    nev = int(spec.args[0])
    if not nev or step % nev != 0:
        return
    if getattr(spec, "_last_step", None) == step:
        return
    spec._last_step = step
    vals = [_row_value(sim, t, "vector") for t in spec.args[1:]]
    buf = getattr(spec, "_series", [])
    buf.append(vals[0] if len(vals) == 1 else vals)
    spec._series = buf


def ave_time(sim, spec, step):
    """fix ave/time (fix_ave_time.cpp as the JAX package runs it): the
    mean of the last Nrepeat samples taken every Nevery, written every
    Nfreq; mode scalar `step v1 v2 ...` rows (%.10g), mode vector a `step
    nrows` header and `row v1 v2 ...` rows."""
    nev, nrep, nfreq, vals, mode, fpath = parse_ave_time(spec.args)
    if nev and step % nev == 0:
        if mode == "vector":
            sample = np.concatenate([_resolve_vector(sim, t) for t in vals],
                                    axis=1)
        else:
            sample = np.asarray([_row_value(sim, t, "ave/time")
                                 for t in vals])
        buf = getattr(spec, "_avebuf", [])
        buf.append(sample)
        spec._avebuf = buf[-nrep:]
    if nfreq and step % nfreq == 0 and getattr(spec, "_avebuf", None):
        ave = np.mean(spec._avebuf, axis=0)
        sim.script.ave_time_values.setdefault(spec.fid, []).append(
            (step, ave if ave.size > 1 else float(ave.reshape(-1)[0])))
        if fpath:
            if mode == "vector":
                text = f"{step} {ave.shape[0]}\n" + "".join(
                    " ".join([str(r + 1)] + [f"{v:.10g}" for v in ave[r]])
                    + "\n" for r in range(ave.shape[0]))
            else:
                text = " ".join([str(step)] + [f"{v:.10g}"
                                               for v in ave.reshape(-1)]) \
                    + "\n"
            _write(sim, spec, fpath, text)


def _resolve_vector(sim, tok):
    """ave/time mode vector's input as a 2-d numpy array: c_ID of a compute
    slice (its columns; c_ID[j] one of them), else a global array
    (global_array)."""
    mm = re.match(r"c_(\w+)(?:\[(\d+)\])?$", tok)
    if mm and mm.group(1) in sim.slice_computes:
        arr = eval_slice(sim, mm.group(1))
        if mm.group(2):
            arr = arr[:, [int(mm.group(2)) - 1]]
    else:
        arr = global_array(sim, tok)
    return arr.cpu().numpy()


def global_array(sim, tok):
    """c_ID / c_ID[j] of a global vector or array compute (a */chunk
    compute's (nchunk, k) array, heat/flux's 6-vector as a column) as a
    2-d float64 tensor on the run's device, c_ID[j] its column j
    (lidp_tpu/sim.py _global_array)."""
    mm = re.match(r"c_(\w+)(?:\[(\d+)\])?$", tok)
    if not mm:
        raise ValueError(f"global array input {tok}")
    name = mm.group(1)
    if name in sim.chunkagg_computes:
        arr = computes.eval_chunk_agg(sim, name)
    elif name in sim.hf_computes:
        arr = computes.eval_heat_flux(sim, name)
    else:
        raise ValueError(f"{tok}: not a global vector/array compute")
    if arr.ndim == 0:
        raise ValueError(f"{tok}: compute {name} is a scalar")
    if arr.ndim == 1:
        arr = arr[:, None]
    if mm.group(2):
        arr = arr[:, [int(mm.group(2)) - 1]]
    return arr


def eval_slice(sim, cid):
    """compute slice Nstart Nstop Nskip input... (ComputeSlice::
    extract_one): rows Nstart, Nstart+Nskip, ... below Nstop (exclusive,
    1-based) of each input's global array, one column per input, a 2-d
    float64 tensor."""
    spec = sim.slice_computes[cid]
    sel = slice(spec["start"] - 1, spec["stop"] - 1, spec["skip"])
    return torch.cat([global_array(sim, t)[sel] for t in spec["inputs"]],
                     dim=1)


def ave_chunk(sim, spec, step):
    """fix ave/chunk (fix_ave_chunk.cpp as lidp_tpu/sim.py _ave_chunk runs
    it): every Nevery the per-chunk totals of the values (count, v, f,
    mass, m v^2) accumulated; every Nfreq the rows `chunk [coord...]
    count value...` (norm all: a value's total over the samples' atoms;
    density/number and density/mass over the bin volume, the box's over
    nchunk for type and molecule chunks; temp sum m v^2 / (dim count
    boltz), the chunk's vcm kept) into ave_chunk_values and the file (%g),
    and the accumulators reset.  Like the JAX package, every Nevery sample
    since the last output is accumulated, whatever Nrepeat (ROADMAP queue
    3 items 41-42: where this parts from LAMMPS's)."""
    nev, _, nfreq, ccid, vals, fpath = parse_ave_chunk(spec.args)
    if nev and step % nev == 0:
        ids, nchunk, coord = computes.chunk_ids(sim, ccid)
        n = sim.natoms
        tab = computes.ChunkTable(ids, nchunk)
        v = sim.sys.v[:n].double()
        m = sim.thermo_params.mass_atom[:n].double()
        cols = []
        for w in vals:
            if w in ("vx", "vy", "vz"):
                src = v[:, "xyz".index(w[1])]
            elif w in ("fx", "fy", "fz"):
                src = sim.res.f[:n, "xyz".index(w[1])].double()
            elif w == "density/mass":
                src = m
            elif w == "temp":
                src = (m[:, None] * v * v).sum(1)
            else:
                src = None
            cols.append(tab.count.double() if src is None
                        else tab.sum(src))
        sample = torch.stack(cols + [tab.count.double()]).cpu().numpy()
        buf = getattr(spec, "_chunkbuf", None)
        if buf is None or buf[0] != nchunk:
            buf = (nchunk, np.zeros((len(vals), nchunk)), np.zeros(nchunk),
                   0)
        spec._chunkbuf = (nchunk, buf[1] + sample[:len(vals)],
                          buf[2] + sample[-1], buf[3] + 1, coord)
    if not (nfreq and step % nfreq == 0
            and getattr(spec, "_chunkbuf", None)):
        return
    nchunk, acc_cols, acc_cnt, nsamp, coord = spec._chunkbuf
    tp = sim.thermo_params
    cspec = sim.chunk_computes[ccid][1]
    L = sim.sys.box.lengths.double().cpu().numpy()
    if cspec["which"] == "bin/1d" and nchunk > 1 and coord is not None:
        # bin volume = delta x the cross-section (bin_volumes), even where
        # the last bin overhangs the box
        delta_eff = float(coord[1] - coord[0])
        vol_chunk = delta_eff * float(np.prod(L)) / float(L[cspec["dim"]])
    elif cspec["which"] in ("bin/2d", "bin/3d") and coord is not None:
        vol_chunk = float(np.prod(L))
        for col, d in enumerate(cspec["dims"]):
            u = np.unique(coord[:, col])
            de = float(u[1] - u[0]) if len(u) > 1 else float(L[d])
            vol_chunk *= de / float(L[d])
    else:
        vol_chunk = float(L[0] * L[1] * L[2]) / max(nchunk, 1)
    out_rows = []
    safe = np.maximum(acc_cnt, 1.0)
    for k in range(nchunk):
        row = [k + 1]
        if coord is not None:
            if np.ndim(coord) == 2:
                row.extend(coord[k])
            else:
                row.append(coord[k])
        row.append(acc_cnt[k] / nsamp)
        for wi, w in enumerate(vals):
            tot = acc_cols[wi, k]
            if w in ("density/number", "density/mass"):
                row.append(tot / nsamp / vol_chunk)
            elif w == "temp":
                dof = tp.dim * max(acc_cnt[k] / nsamp, 1e-300)
                row.append(tot / nsamp * tp.mvv2e / (dof * tp.boltz))
            else:
                row.append(tot / safe[k])
        out_rows.append(row)
    sim.script.ave_chunk_values[spec.fid] = (step, out_rows)
    if fpath:
        head = ("" if getattr(spec, "_started", False)
                else f"# Chunk-averaged data for fix {spec.fid}\n")
        text = head + f"{step} {nchunk} {acc_cnt.sum() / max(nsamp, 1):g}\n"
        text += "".join("  " + " ".join(f"{v_:g}" for v_ in row) + "\n"
                        for row in out_rows)
        _write(sim, spec, fpath, text)
    spec._chunkbuf = None


def _histo_state(nbin):
    return dict(hist=np.zeros(nbin), total=0.0, missing=0.0, vmin=np.inf,
                vmax=-np.inf, nsamp=0)


def ave_histo(sim, spec, step):
    """fix ave/histo[/weight] (fix_ave_histo.cpp as the JAX package runs
    it): a histogram of per-atom values (the fix's group) or global ones,
    Nrepeat samples accumulated, written every Nfreq: `step nbins total
    missing min max`, then `i coord count count/total` rows.  /weight:
    the first value binned, the second the weights."""
    nev, nrep, nfreq, lo, hi, nbin, vals, fpath = \
        parse_ave_histo(spec.args)
    if nev and step % nev == 0:
        gm = np.asarray(sim.script.groups[spec.group])[:sim.natoms]
        samples = []
        for t in vals:
            try:
                arr = computes.peratom_column(sim, t)
                samples.append(arr.cpu().numpy()[gm])
            except KeyError:
                samples.append(np.array([_row_value(sim, t, spec.style)]))
        if spec.style == "ave/histo/weight":
            data, weights = samples[0], samples[1]
            inside = (data >= lo) & (data <= hi)
            hist, _ = np.histogram(data[inside], bins=nbin, range=(lo, hi),
                                   weights=weights[inside])
            st = getattr(spec, "_histo", None) or _histo_state(nbin)
            st["hist"] = st["hist"] + hist
            st["total"] += float(weights[inside].sum())
            st["missing"] += float(weights[~inside].sum())
            if len(data):
                st["vmin"] = min(st["vmin"], float(data.min()))
                st["vmax"] = max(st["vmax"], float(data.max()))
            st["nsamp"] += 1
            spec._histo = st
            histo_emit(sim, spec, step, nfreq, nbin, lo, hi, fpath)
            return
        data = np.concatenate(samples)
        inside = (data >= lo) & (data <= hi)
        hist, _ = np.histogram(data[inside], bins=nbin, range=(lo, hi))
        st = getattr(spec, "_histo", None) or _histo_state(nbin)
        st["hist"] = st["hist"] + hist
        st["total"] += inside.sum()
        st["missing"] += (~inside).sum()
        if len(data):
            st["vmin"] = min(st["vmin"], float(data.min()))
            st["vmax"] = max(st["vmax"], float(data.max()))
        st["nsamp"] += 1
        if st["nsamp"] > nrep:
            st = dict(hist=np.asarray(hist, float),
                      total=float(inside.sum()),
                      missing=float((~inside).sum()),
                      vmin=float(data.min()) if len(data) else np.inf,
                      vmax=float(data.max()) if len(data) else -np.inf,
                      nsamp=1)
        spec._histo = st
    histo_emit(sim, spec, step, nfreq, nbin, lo, hi, fpath)


def histo_emit(sim, spec, step, nfreq, nbin, lo, hi, fpath):
    """Write and reset the accumulated histogram at an Nfreq step."""
    if not (nfreq and step % nfreq == 0 and getattr(spec, "_histo", None)):
        return
    st = spec._histo
    sim.script.ave_histo_values[spec.fid] = dict(st)
    if fpath:
        binw = (hi - lo) / nbin
        tot = max(st["total"], 1.0)
        text = (f"{step} {nbin} {st['total']:.8g} {st['missing']:.8g} "
                f"{st['vmin']:.8g} {st['vmax']:.8g}\n")
        for b in range(nbin):
            text += (f"{b + 1} {lo + (b + 0.5) * binw:.8g} "
                     f"{st['hist'][b]:.8g} {st['hist'][b] / tot:.8g}\n")
        _write(sim, spec, fpath, text)
    spec._histo = None


def ave_correlate(sim, spec, step):
    """fix ave/correlate (type auto, as the JAX package runs it): <A(t)
    A(t + m Nevery)> over the last Nrepeat samples, written every Nfreq:
    `step nlags`, then `m+1 m*Nevery count c1 c2 ...` rows (%.8g)."""
    nev, nrep, nfreq, vals, fpath = parse_ave_correlate(spec.args)
    if nev and step % nev == 0:
        samp = [_row_value(sim, t, "ave/correlate") for t in vals]
        buf = getattr(spec, "_series", [])
        buf.append(samp)
        spec._series = buf[-nrep:]
    if not (nfreq and step % nfreq == 0 and getattr(spec, "_series", None)):
        return
    series = np.asarray(spec._series)      # (nsamp, nval)
    nsamp = len(series)
    corr = np.zeros((nrep, series.shape[1]))
    cnt = np.zeros(nrep)
    for m in range(min(nrep, nsamp)):
        corr[m] = (series[:nsamp - m] * series[m:]).mean(axis=0)
        cnt[m] = nsamp - m
    sim.script.ave_correlate_values[spec.fid] = (corr, cnt)
    if fpath:
        text = f"{step} {min(nrep, nsamp)}\n" + "".join(
            f"{m + 1} {m * nev} {int(cnt[m])} "
            + " ".join(f"{c:.8g}" for c in corr[m]) + "\n"
            for m in range(min(nrep, nsamp)))
        _write(sim, spec, fpath, text)


def chunk_periods(script):
    """The output fixes' Nevery periods, and fix ave/chunk's Nfreq
    (Simulation.run's chunk gcd)."""
    out = []
    for spec in script.fixes.values():
        if spec.style == "store/state" and int(spec.args[0]) == 0:
            # a snapshot at setup alone: no period (the JAX package folds
            # in 1, a sample every step that takes nothing)
            continue
        if spec.style in OUTPUT_STYLES:
            out.append(max(1, int(spec.args[0])))
        if spec.style == "ave/chunk":
            out.append(max(1, int(spec.args[2])))
    return out


# fix store/state's per-atom inputs besides c_ID and f_ID (the JAX
# package's peratom_column)
STORE_STATE_FIELDS = ("x", "y", "z", "vx", "vy", "vz", "fx", "fy", "fz", "q",
                      "type", "mol", "mass", "id")


def check_store_state(script, a):
    """fix store/state N input... (fix_store_state.cpp as the JAX package
    takes it): per-atom inputs, no keywords."""
    if len(a) < 2 or int(a[0]) < 0:
        raise ValueError("Illegal fix store/state command")
    for t in a[1:]:
        if t in ("com", "keep"):
            raise NotImplementedError(
                f"fix store/state keyword {t}: the JAX package does not take "
                f"it ({_SKIPPED})")
        if t.startswith("v_"):
            raise NotImplementedError(
                f"fix store/state input {t}: atom-style variables are not "
                "ported (ROADMAP queue 1 item 6, breadth)")
        if t.startswith("c_"):
            if t[2:].split("[")[0] not in script.computes:
                raise ValueError(f"fix store/state: compute {t[2:]} does not "
                                 "exist")
        elif t.startswith("f_"):
            name = t[2:].split("[")[0]
            if script.fixes.get(name, None) is None or script.fixes[
                    name].style not in ("ave/atom", "store/state"):
                raise NotImplementedError(
                    f"fix store/state input {t}: only fix ave/atom's and "
                    "store/state's per-atom values are ported (ROADMAP queue "
                    "1 item 6.1)")
        elif t not in STORE_STATE_FIELDS:
            raise ValueError(f"fix store/state input {t}")


def store_state(sim, spec, step):
    """fix store/state N input... (fix_store_state.cpp): the inputs'
    per-atom values (computes.peratom_column) stored at the run's setup
    and every N steps (N = 0: at setup alone), read as f_ID and f_ID[i] by
    dump custom and the per-atom inputs."""
    nev = int(spec.args[0])
    if getattr(spec, "_peratom_store", None) is not None and (
            not nev or step % nev):
        return
    cols = [computes.peratom_column(sim, t).clone() for t in spec.args[1:]]
    spec._peratom_store = (cols[0] if len(cols) == 1
                           else torch.stack(cols, dim=1))
    sim.bump_generation()


def check_controller(script, a):
    """fix controller Nevery alpha Kp Ki Kd pvar setpoint cvar
    (fix_controller.cpp): pvar a global compute c_ID[/i] or an
    equal-style v_NAME, cvar an internal-style variable."""
    if len(a) != 8:
        raise ValueError("Illegal fix controller command")
    if int(a[0]) <= 0:
        raise ValueError("Illegal fix controller command: Nevery <= 0")
    pvar, cvar = a[5], a[7]
    if pvar.startswith("c_"):
        if pvar[2:].split("[")[0] not in script.computes:
            raise ValueError(f"fix controller: compute {pvar[2:]} does not "
                             "exist")
    elif pvar.startswith("f_"):
        raise NotImplementedError(
            f"fix controller pvar {pvar}: JAX's thermo row has no fix's "
            f"value ({_NO_VALUE})")
    elif not pvar.startswith("v_"):
        raise ValueError(f"Illegal fix controller command: pvar {pvar}")
    if cvar not in script._internal_vars:
        raise ValueError(f"Fix controller variable {cvar} is not "
                         "internal-style")


def controller(sim, spec, step):
    """fix controller (fix_controller.cpp end_of_step, the JAX package's
    _host_fixes): every Nevery steps the PID update
    cv += -alpha (Kp tau err + Ki tau^2 sumerr + Kd deltaerr), tau =
    Nevery dt, of the internal variable cvar from the process variable's
    error against the setpoint; the first sample takes no derivative."""
    a = spec.args
    nev = int(a[0])
    if step % nev:
        return
    alpha, kp, ki, kd = (float(v) for v in a[1:5])
    pvar, setpt, cvar = a[5], float(a[6]), a[7]
    if pvar.startswith("v_"):
        cur = float(sim.script.var_value(pvar[2:]))
    else:
        cur = _row_value(sim, pvar, "controller")
    st = getattr(spec, "_ctrl", None)
    if st is None:
        st = {"control": float(sim.script.var_value(cvar)), "sumerr": 0.0,
              "olderr": 0.0, "first": True}
        spec._ctrl = st
    err = cur - setpt
    if st["first"]:
        st["first"] = False
        deltaerr = 0.0
    else:
        deltaerr = err - st["olderr"]
        st["sumerr"] += err
    tau = nev * sim.script.dt
    st["control"] += -kp * alpha * tau * err
    st["control"] += -ki * alpha * tau * tau * st["sumerr"]
    st["control"] += -kd * alpha * deltaerr
    st["olderr"] = err
    sim.script._internal_vars[cvar] = float(st["control"])
