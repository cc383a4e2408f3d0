"""Style registry (lidp_tpu/styles/__init__.py): the analog of the
reference's macro-expanded style maps (Modify::add_fix dispatch built from
style_*.h, force.cpp:83-88, modify.cpp:778).

Each fix style registers a builder with @fix_style(name); a builder
receives the shared FixBuildCtx and sets ctx.integ (the time-integration
styles) and the dof bookkeeping.  Simulation.from_script loops the
registry.  The port registers the integrators the panel engine composes
with, nve and rigid/nve, and the Nose-Hoover styles and barostats of the
dense route and the cell grid, rigid/nvt, nvt, npt, nph, rigid/npt and
rigid/nph (styles/fix_integrators.py), and the modifier fixes
(styles/fix_modifiers.py): the constraint fixes shake and rattle, the
post_force styles (langevin, setforce, addforce, aveforce, spring,
spring/self, viscous, efield, planeforce, lineforce), the end_of_step
styles (momentum, recenter, temp/csld), the deferred temp/rescale and
temp/berendsen, fix enforce2d and fix box/relax (which only `minimize`
reads); the output fixes of styles/fix_output.py have no builder (the
Simulation samples them between run chunks); any other fix style with no
builder raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

FIX_BUILDERS: Dict[str, Callable] = {}


def fix_style(*names, integrator: bool = False):
    """Register a fix builder.  integrator=True marks time-integration
    styles (at most one per run, like the reference's single Verlet update
    loop over integrate fixes)."""
    def deco(fn):
        fn._integrator = integrator
        for nm in names:
            FIX_BUILDERS[nm] = fn
        return fn
    return deco


def is_integrator(style: str) -> bool:
    b = FIX_BUILDERS.get(style)
    return bool(b is not None and getattr(b, "_integrator", False))


@dataclasses.dataclass
class FixBuildCtx:
    """Mutable build context threaded through fix builders.  Inputs are set
    by Simulation.from_script; builders set `integ` and add to the dof
    bookkeeping."""

    script: Any
    groups: Any            # {name: (npad,) numpy bool}
    u: Any                 # units table
    dtype: Any
    device: Any
    mass_atom: Any         # (npad,) numpy
    padA: Callable         # pad an (n, ...) array to (npad, ...)
    n: int = 0             # real atoms
    dim: int = 3
    dof_removed: float = 0.0
    integ: Any = None
    # (group name, RigidSetup) of each rigid fix: the dof a compute temp
    # loses when all of a fix's bodies lie in its group
    rigid_groups: list = dataclasses.field(default_factory=list)
    # the System under construction (fix shake moves x onto its
    # constraints at setup)
    sys: Any = None
    # fix shake / rattle: the clusters of the pre-pass (ops/shake
    # find_clusters, None for none), (tolerance, max_iter), the
    # constraints removed from the dof, rattle's ShakeParams
    shake_found: Any = None
    shake_cfg: Any = None
    shake_dof_removed: int = 0
    rattle_params: Any = None
    # post_force hooks, fn(sys, f) -> (f, extra virial6), in fix order
    # (Modify::post_force, modify.cpp:454); the setup pass's variants
    pf_hooks: list = dataclasses.field(default_factory=list)
    pf_hooks_setup: list = dataclasses.field(default_factory=list)
    # Modify::post_integrate hooks, fn(sys) -> sys, and the end_of_step
    # hooks, fn(sys, res) -> sys, in declaration order
    pi_hooks: list = dataclasses.field(default_factory=list)
    eos_hooks: list = dataclasses.field(default_factory=list)
    # fix shake's constraints as their two atoms' indices (pa, qa): those
    # a temperature group holds whole leave its dof
    shake_pairs: Any = None
    # temp/rescale or temp/berendsen, built after the fix loop
    pending_temp_fix: Any = None


def build_fixes(ctx: FixBuildCtx):
    """Run every fix spec through the registry (declaration order, like
    Modify's per-hook fan-out lists)."""
    from lidp_tpu_torch.styles import fix_integrators  # noqa: F401
    from lidp_tpu_torch.styles import fix_modifiers  # noqa: F401

    n_integrators = sum(1 for f in ctx.script.fixes.values()
                        if is_integrator(f.style))
    if n_integrators > 1:
        raise NotImplementedError("multiple simultaneous integrator fixes")
    from lidp_tpu_torch.styles.fix_output import OUTPUT_STYLES

    for spec in ctx.script.fixes.values():
        if spec.style in OUTPUT_STYLES + ("cmap",):
            # sampled by the Simulation between run chunks
            # (styles/fix_output.py); fix cmap is a force-field term
            # (sim.py builds ForceField.cmap)
            continue
        builder = FIX_BUILDERS.get(spec.style)
        if builder is None:
            raise NotImplementedError(
                f"fix style {spec.style} is not ported (ROADMAP queue 1 "
                "item 6.1, the modifier fixes)")
        builder(ctx, spec)
    return ctx
