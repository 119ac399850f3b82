"""Debug-mode numerical sanitizers.

The reference scatters runtime asserts through the hot path
(non-negativity of beta and phi stm.py:534,1117; Q row sums :152-154;
probability checks :294-295; PD eigenvalue checks :1017-1021) — in a
jitted device program those become host-side validations of the E-step
outputs, run per EM iteration when ``STMConfig.debug_checks`` is on
(SURVEY.md §5 "keep these as debug-mode assertions").
"""

from __future__ import annotations

import numpy as np


class NumericalCheckError(AssertionError):
    pass


def validate_state(state, iteration: int) -> None:
    """Host-side checks of an STMState after an EM iteration."""
    beta = np.asarray(state.beta)
    theta = np.asarray(state.theta)
    sigma = np.asarray(state.sigma)
    bound = float(np.asarray(state.bound))

    if not np.all(beta >= 0):
        raise NumericalCheckError(
            f"iter {iteration}: beta has negative entries (min {beta.min()})"
        )
    if not np.all(np.isfinite(beta)):
        raise NumericalCheckError(f"iter {iteration}: beta has non-finite entries")
    row_sums = beta.sum(axis=-1)
    if not np.allclose(row_sums[row_sums > 0], 1.0, atol=1e-3):
        raise NumericalCheckError(
            f"iter {iteration}: beta rows do not sum to 1 (range "
            f"{row_sums.min()}..{row_sums.max()})"
        )
    if not np.all(np.isfinite(theta)):
        raise NumericalCheckError(f"iter {iteration}: theta has non-finite entries")
    if not np.allclose(theta.sum(axis=1), 1.0, atol=1e-3):
        raise NumericalCheckError(f"iter {iteration}: theta rows do not sum to 1")
    if not np.all(np.isfinite(sigma)):
        raise NumericalCheckError(f"iter {iteration}: sigma has non-finite entries")
    if not np.allclose(sigma, sigma.T, atol=1e-4):
        raise NumericalCheckError(f"iter {iteration}: sigma is not symmetric")
    eig = np.linalg.eigvalsh(sigma)
    if eig.min() < -1e-4:
        raise NumericalCheckError(
            f"iter {iteration}: sigma has negative eigenvalue {eig.min()}"
        )
    if not np.isfinite(bound):
        raise NumericalCheckError(f"iter {iteration}: bound is {bound}")
