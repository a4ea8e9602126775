"""Tests that need a GPU: what only the card can show.  Elsewhere they skip
(the ``gpu`` fixture decides at run time).  On the card:

    JAX_PLATFORMS=cuda python -m pytest -m chip tests/
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

pytestmark = pytest.mark.chip


def test_accumulate_on_gpu_matches_f64_oracle(gpu):
    """The day accumulate as the GPU runs it (scatter-add by atomics, in
    a run-dependent order) against the f64 host oracle."""
    from tests.test_accumulate import _check_against_oracle

    _check_against_oracle(1, 0, (21.1, 10.6, 0.3))
    _check_against_oracle(1, 0, (21.1, 10.6, 0.99))


def test_dense_metric_products_are_full_f32_on_gpu(gpu):
    """An f32 product run in TF32 keeps ~3 decimal digits; the NUTS
    kinetic energy and velocity must not."""
    from parasitoids_tpu.bayes import nuts

    rng = np.random.default_rng(0)
    d = 31
    A = rng.normal(size=(d, d))
    M = A @ A.T + 1e-2 * np.eye(d)
    p = rng.normal(size=d)
    ke = float(jax.jit(nuts._kinetic)(jnp.asarray(M, jnp.float32),
                                      jnp.asarray(p, jnp.float32)))
    v = np.asarray(jax.jit(nuts._mv)(jnp.asarray(M, jnp.float32),
                                     jnp.asarray(p, jnp.float32)))
    np.testing.assert_allclose(ke, 0.5 * p @ M @ p, rtol=1e-5)
    np.testing.assert_allclose(v, M @ p, rtol=1e-4,
                               atol=1e-5 * np.abs(M @ p).max())
