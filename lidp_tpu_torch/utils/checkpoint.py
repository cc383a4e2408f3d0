"""Checkpoint and resume of a run's state (lidp_tpu/utils/checkpoint.py, an
own copy reading the port's tensors).

The analog of the reference's restart files (write_restart.cpp:239,
read_restart.cpp:75), in the port's own format: NOT LAMMPS's binary
layout.  A file is one compressed numpy archive (.npz, under the exact
name the script gives) of named arrays:

  * ``sys.<field>``: every tensor of the System (x, v, q, type, mol,
    alpha, the induced dipoles mu, the image flags, the mask, the box's
    lo and hi) and its step;
  * ``istate.<path>``: the integrator's state, whatever its structure
    (a Nose-Hoover chain's eta_dot, the barostat's strain rates, the
    rigid bodies' quaternions and momenta, Kahan nve's compensations),
    flattened by attribute and index.

The force field, the fixes and the groups are not stored: they come from
the script, whose commands before read_restart must define them (the
JAX package's rule).  Tensors go to numpy and back unchanged, so a state
read back equals the state written bit for bit.

Unlike the reference, which drops the induced dipoles from its restart
payload, the dipoles are kept, and with them the next SCF's warm start.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


def _flatten(prefix: str, obj, out: dict):
    if obj is None:
        return
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _flatten(f"{prefix}{f.name}.", getattr(obj, f.name), out)
    elif isinstance(obj, (tuple, list)):
        for k, v in enumerate(obj):
            _flatten(f"{prefix}{k}.", v, out)
    elif isinstance(obj, torch.Tensor):
        out[prefix.rstrip(".")] = obj.detach().cpu().numpy()
    elif isinstance(obj, (np.ndarray, np.generic, bool, int, float)):
        out[prefix.rstrip(".")] = np.asarray(obj)
    # strings and callables are static structure: they live in code


def flatten_state(sys, istate=None) -> dict:
    """{name: numpy array} of a System and an integrator state."""
    out: dict = {}
    _flatten("sys.", sys, out)
    _flatten("istate.", istate, out)
    return out


def save_checkpoint(path: str, sys, istate=None):
    """Write `sys` and `istate` to `path` (the literal name: np.savez's
    .npz suffix is taken off again, as write_restart writes the name it
    is given)."""
    np.savez_compressed(path, **flatten_state(sys, istate))
    if not str(path).endswith(".npz"):
        os.replace(f"{path}.npz", path)


def load_checkpoint(path: str) -> dict:
    """{name: numpy array} of a checkpoint file."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def restore(template, data: dict, prefix: str):
    """`template` with every leaf that `data` holds under `prefix`
    replaced by the stored array, on the template leaf's device and
    dtype; leaves the file lacks keep the template's, and so do a
    dataclass's FRAME_FIELDS (a rigid body's quaternions, relative to the
    body frame the template's Simulation built).  A stored array of
    another shape than its template raises (the script built another
    integrator or system than the one written)."""
    if template is None:
        return None
    if dataclasses.is_dataclass(template):
        frame = getattr(template, "FRAME_FIELDS", ())
        kw = {f.name: restore(getattr(template, f.name), data,
                              f"{prefix}{f.name}.")
              for f in dataclasses.fields(template) if f.name not in frame}
        return dataclasses.replace(template, **kw)
    if isinstance(template, (tuple, list)):
        return type(template)(restore(v, data, f"{prefix}{k}.")
                              for k, v in enumerate(template))
    key = prefix.rstrip(".")
    if key not in data:
        return template
    val = data[key]
    if isinstance(template, torch.Tensor):
        if tuple(val.shape) != tuple(template.shape):
            raise ValueError(f"restart field {key} has shape {val.shape}, "
                             f"the script's {tuple(template.shape)}")
        return torch.as_tensor(val).to(device=template.device,
                                       dtype=template.dtype)
    if isinstance(template, np.ndarray):
        if val.shape != template.shape:
            raise ValueError(f"restart field {key} has shape {val.shape}, "
                             f"the script's {template.shape}")
        return val.astype(template.dtype)
    if isinstance(template, (bool, int, float, np.generic)):
        return type(template)(val)
    return template
