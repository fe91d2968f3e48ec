"""Structural checks on traced programs: which primitives a jaxpr holds, and
whether every float32 matrix product pins its precision.

An f32 ``dot_general`` without an explicit precision may run in TF32 on
NVIDIA tensor cores (about three decimal digits), which perturbs the
operator by ~1e-3 and stalls PCG and the mixed-precision refinement.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.extend.core import ClosedJaxpr, Jaxpr


def iter_eqns(jaxpr):
    """Every equation of ``jaxpr`` (a Jaxpr or ClosedJaxpr), recursing into
    the sub-jaxprs of control flow and nested calls."""
    jaxpr = getattr(jaxpr, "jaxpr", jaxpr)
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else (v,):
                if isinstance(sub, (Jaxpr, ClosedJaxpr)):
                    yield from iter_eqns(sub)


def primitive_names(jaxpr) -> set[str]:
    return {eqn.primitive.name for eqn in iter_eqns(jaxpr)}


def unpinned_f32_dots(jaxpr) -> list:
    """``dot_general`` equations with a float32 operand whose precision is
    not HIGHEST on both operands."""
    highest = jax.lax.Precision.HIGHEST
    bad = []
    for eqn in iter_eqns(jaxpr):
        if eqn.primitive.name != "dot_general":
            continue
        if not any(np.dtype(v.aval.dtype) == np.float32 for v in eqn.invars):
            continue
        prec = eqn.params.get("precision")
        if not (isinstance(prec, tuple) and all(p == highest for p in prec)):
            bad.append(eqn)
    return bad
