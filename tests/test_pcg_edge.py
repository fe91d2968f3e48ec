"""PCG driver edge cases (review findings): zero/converged entries, chunk
budgets, and converged-flag agreement between the drivers."""

import jax.numpy as jnp
import numpy as np
import pytest

from spacetime.solver.pcg import pcg, pcg_chunk, pcg_fused, pcg_init


@pytest.fixture(scope="module")
def spd():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((12, 12))
    A = A @ A.T + 12 * np.eye(12)
    b = rng.standard_normal(12)
    return jnp.asarray(A), jnp.asarray(b)


def _ops(A):
    return (lambda x: A @ x), (lambda r: r)


def test_pcg_zero_rhs(spd):
    A, _ = spd
    S, KX = _ops(A)
    out = pcg(S, KX, jnp.zeros(12), 1e-8, 20)
    assert bool(out.converged) and int(out.iterations) == 0
    assert np.all(np.asarray(out.U) == 0.0)
    assert not np.isnan(out.U).any()


def test_pcg_warm_start_already_converged(spd):
    A, b = spd
    S, KX = _ops(A)
    x = jnp.linalg.solve(A, b)
    out = pcg(S, KX, b, 1e-8, 20, x0=x)
    assert bool(out.converged) and int(out.iterations) == 0
    assert not np.isnan(out.U).any()
    np.testing.assert_allclose(out.U, x, rtol=1e-12)


def test_pcg_fused_zero_rhs(spd):
    A, _ = spd
    S, KX = _ops(A)
    out = pcg_fused(S, KX, jnp.zeros(12), 1e-8, 20)
    assert bool(out.converged) and int(out.iterations) == 0
    assert not np.isnan(out.U).any()


def test_fused_converged_flag_at_exact_maxiter(spd):
    """Convergence achieved on the maxiter-th update must report
    converged=True, matching pcg()'s flag for the identical history."""
    A, b = spd
    S, KX = _ops(A)
    ref = pcg_fused(S, KX, b, 1e-10, 50)
    n = int(ref.iterations)
    assert bool(ref.converged) and 0 < n < 50
    tight = pcg_fused(S, KX, b, 1e-10, n)
    assert bool(tight.converged)
    assert int(tight.iterations) == n
    np.testing.assert_allclose(
        tight.residuals[: n + 1], ref.residuals[: n + 1], rtol=1e-12
    )


def test_chunk_does_not_overrun_budget(spd):
    """k trips past the history buffer's maxiter are exact no-ops: a chunk
    size that does not divide the budget must not scatter past the buffer
    or report iterations > maxiter."""
    A, b = spd
    S, KX = _ops(A)
    # a tolerance the solve cannot reach, so the budget is the binding limit
    st = pcg_init(S, KX, b, maxiter=5)
    for _ in range(3):
        st = pcg_chunk(S, KX, st, 1e-30, 4)  # 12 trips vs budget 5
    assert int(st.it) == 5
    assert st.res.shape == (6,)
    assert np.isfinite(np.asarray(st.res)).all()
    # the recorded history must equal the unchunked driver's first 5 entries
    ref = pcg(S, KX, b, 1e-30, 5)
    np.testing.assert_allclose(st.res, ref.residuals, rtol=1e-13)


def test_chunk_zero_rhs_finishes(spd):
    A, _ = spd
    S, KX = _ops(A)
    st = pcg_init(S, KX, jnp.zeros(12), maxiter=5)
    st = pcg_chunk(S, KX, st, 1e-8, 3)
    assert bool(st.done) and int(st.it) == 0
    assert not np.isnan(st.U).any()


def test_chunk_matches_while_loop(spd):
    """Normal path unchanged: chunked == while-loop histories bitwise."""
    A, b = spd
    S, KX = _ops(A)
    ref = pcg(S, KX, b, 1e-9, 30)
    st = pcg_init(S, KX, b, maxiter=30)
    while int(st.it) < 30 and not bool(st.done):
        st = pcg_chunk(S, KX, st, 1e-9, 7)
    assert int(st.it) == int(ref.iterations)
    np.testing.assert_array_equal(
        np.asarray(st.res)[: int(st.it) + 1],
        np.asarray(ref.residuals)[: int(ref.iterations) + 1],
    )
