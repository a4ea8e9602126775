"""Bivariate-normal cell integration (L2 core numeric).

Replaces the reference's adaptive-ring Fortran integrator
(``ParasitoidModel.get_mvn_cdf_values``, ParasitoidModel.py:311-380; Genz's
MVNDST via ``scipy.stats.mvn.mvnun``) with *fixed-window*, fully
vectorizable schemes suited to XLA: every cell of a static ``(2K+1, 2K+1)``
window is integrated in one dense batch, so the op ``vmap``s over the 1,440
per-minute kernels of a day and fuses.  Unlike the reference, the window
never grows at runtime: choose K so it covers the adaptive stopping rule's
0.999 mass for all plausible σ (SURVEY.md section 7 "hard parts";
bayes/model.py derives K from the priors' quantiles).

Default scheme — **corner CDFs with inclusion–exclusion**
(:func:`bvn_cell_masses`): evaluate the upper-orthant probability
``L(h, k) = P(X > h, Y > k)`` on the ``(2K+2)²`` lattice of cell corners
(shared between adjacent cells) with the Drezner–Wesolowsky / Genz
algorithm — Gauss–Legendre quadrature of the correlation integral

    L(h, k) = Φ(−h) Φ(−k) + (1/2π) ∫₀^{arcsin ρ} exp(−(h²+k²−2hk sin θ)
                                                      / (2cos²θ)) dθ

with the node count selected by |ρ| as in Genz's published code (6/12/20
for |ρ| < 0.3 / 0.75 / 0.925) and the complementary asymptotic-series form
beyond 0.925; ρ is a single traced scalar per call, so the branch is one
``lax.switch`` that executes only the needed branch.  Cell masses are the
four-corner differences.  Properties that make this the right scheme here:

* **accuracy is uniform in ρ and μ** (~1e-7 absolute in f32, validated in
  tests against the f64 host oracle) — there is no x-quadrature over the
  cell, so nothing degrades for narrow/anisotropic/highly-correlated
  kernels;
* **window mass telescopes**: the sum over the window reduces to the four
  outer corners, so total-mass accounting (the loss bookkeeping of
  ops/daily_kernel.py) is exact by construction;
* **cost**: ~(2K+2)²·Gρ exp evaluations per call with corner sharing —
  measured ~100× faster than the conditional-quadrature scheme below at
  prior-typical ρ, and ~13× at ρ = 0.95.

The previous scheme — conditional decomposition with probability-space
Gauss–Legendre quadrature through the x marginal — is kept as
:func:`bvn_cell_masses_quad` (a useful independent cross-check).

Everything is differentiable (saturating branches double-``where``
guarded), so the whole forward model admits gradient-based MAP/NUTS.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.scipy.special import ndtr, ndtri

__all__ = ['bvn_cell_masses', 'bvn_cell_masses_batched',
           'bvn_cell_masses_quad', 'bvn_upper_grid', 'bvn_upper_grid_select',
           'gauss_legendre']

_TWO_PI = 2.0 * np.pi
_SQRT_2PI = np.sqrt(2.0 * np.pi)


@lru_cache(maxsize=None)
def gauss_legendre(n: int):
    """Gauss–Legendre nodes/weights on [-1, 1] (host-side, static)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return x, w


def _upper_lowcorr(h, k, rho, G, phi_prod=None):
    """P(X > h, Y > k) for |ρ| ≤ 0.925: G-node Gauss–Legendre quadrature of
    the correlation integral (Drezner & Wesolowsky 1990).  ``h``/``k``
    arrays, ``rho`` scalar.  The integrand's exponent is ≤ 0 for every node
    (|sin θ| ≤ |ρ| < 1), so ``exp`` never overflows.  ``phi_prod``
    optionally supplies the independence term Φ(−h)Φ(−k) (callers with a
    separable corner lattice compute it from two 1-D edge vectors instead
    of a full-grid ``ndtr``)."""
    x_np, w_np = gauss_legendre(G)
    x = jnp.asarray(x_np, h.dtype)
    w = jnp.asarray(w_np, h.dtype)
    hk = h * k
    hs = 0.5 * (h * h + k * k)
    asr = jnp.arcsin(rho)
    sn = jnp.sin(asr * 0.5 * (1.0 + x))                       # (G,)
    expo = (sn * hk[..., None] - hs[..., None]) / (1.0 - sn * sn)
    total = jnp.sum(w * jnp.exp(expo), axis=-1)
    if phi_prod is None:
        phi_prod = ndtr(-h) * ndtr(-k)
    return total * asr / (2.0 * _TWO_PI) + phi_prod


def _upper_highcorr(h, k, rho, G=20):
    """|ρ| > 0.925: complementary asymptotic series + tail quadrature
    (Genz 2004 BVND).  All exponentials are arg-clipped and ``where``
    -guarded twice so both the value and its autodiff gradients stay
    finite in f32."""
    x_np, w_np = gauss_legendre(G)
    x = jnp.asarray(x_np, h.dtype)
    w = jnp.asarray(w_np, h.dtype)
    sgn = jnp.sign(rho)
    k = k * sgn                                   # ρ < 0: flip k
    hk = h * k
    a_sq = jnp.maximum((1.0 - rho) * (1.0 + rho), 1e-30)
    a = jnp.sqrt(a_sq)
    bs = (h - k) ** 2
    c = (4.0 - hk) / 8.0
    d = (12.0 - hk) / 16.0
    asr = -(bs / a_sq + hk) / 2.0
    bvn = jnp.where(asr > -80.0,
                    a * jnp.exp(jnp.clip(asr, -80.0, 0.0)) *
                    (1.0 - c * (bs - a_sq) * (1.0 - d * bs / 5.0) / 3.0 +
                     c * d * a_sq * a_sq / 5.0), 0.0)
    # b = |h − k| with the sqrt guarded for autodiff at h == k
    b = jnp.sqrt(jnp.where(bs > 1e-30, bs, 1e-30))
    term = (jnp.exp(jnp.clip(-hk / 2.0, -80.0, 80.0)) * _SQRT_2PI *
            ndtr(-b / a) * b * (1.0 - c * bs * (1.0 - d * bs / 5.0) / 3.0))
    bvn = bvn - jnp.where(-hk < 80.0, term, 0.0)
    a_half = a / 2.0
    xs = (a_half * (1.0 + x)) ** 2                             # (G,)
    rs = jnp.sqrt(1.0 - xs)
    asr1 = -(bs[..., None] / xs + hk[..., None]) / 2.0
    sp = 1.0 + c[..., None] * xs * (1.0 + d[..., None] * xs)
    ep = jnp.exp(-hk[..., None] * (1.0 - rs) / (2.0 * (1.0 + rs))) / rs
    contrib = jnp.where(asr1 > -80.0,
                        a_half * w * jnp.exp(jnp.clip(asr1, -80.0, 0.0)) *
                        (ep - sp), 0.0)
    bvn = bvn + jnp.sum(contrib, axis=-1)
    bvn = -bvn / _TWO_PI
    pos = bvn + ndtr(-jnp.maximum(h, k))
    neg = -bvn + jnp.where(k > h, ndtr(k) - ndtr(h), 0.0)
    return jnp.where(sgn > 0, pos, neg)


def bvn_upper_grid(h, k, rho, phi_prod=None):
    """Upper-orthant probabilities P(X > hᵢ, Y > kⱼ) on a grid, standard
    bivariate normal with correlation ``rho`` (traced scalar).  Node count
    follows Genz's |ρ| thresholds via one executed ``lax.switch`` branch."""
    ar = jnp.abs(rho)
    idx = ((ar >= 0.3).astype(jnp.int32)
           + (ar >= 0.75).astype(jnp.int32)
           + (ar >= 0.925).astype(jnp.int32))
    return lax.switch(
        idx,
        [lambda _: _upper_lowcorr(h, k, rho, 6, phi_prod),
         lambda _: _upper_lowcorr(h, k, rho, 12, phi_prod),
         lambda _: _upper_lowcorr(h, k, rho, 20, phi_prod),
         lambda _: _upper_highcorr(h, k, rho)],
        operand=None)


def bvn_upper_grid_select(h, k, rho, phi_prod=None):
    """Batch-friendly variant of :func:`bvn_upper_grid`: a two-branch
    ``jnp.where`` select over the fixed-G (20-node) low-corr quadrature and
    the high-corr series instead of the 4-way ``lax.switch``.

    Rationale (VERDICT r4 item 4): a *batched* predicate ``lax.switch``
    lowers to executing EVERY branch with a select — 6+12+20-node low-corr
    sweeps plus the high-corr series, ~58 node-sweeps per call.  Under an
    ensemble ``vmap`` (per-particle traced ρ) that cost is unavoidable per
    branch structure, so this variant keeps only the two members whose
    union covers (−1, 1): G=20 low-corr (Genz's own node count for
    |ρ| < 0.925 — strictly more accurate than the 6/12-node tiers it
    replaces) and the asymptotic-series high-corr form.  Both branches are
    NaN-free over the full clipped ρ range (the low-corr exponent is ≤ 0
    for every node since |sin θ| ≤ |ρ| < 1; the high-corr form is
    arg-clipped), so the unselected branch never poisons the select.

    For a SCALAR-ρ program this is a pessimization (both branches always
    execute); use :func:`bvn_upper_grid`."""
    low = _upper_lowcorr(h, k, rho, 20, phi_prod)
    high = _upper_highcorr(h, k, rho)
    return jnp.where(jnp.abs(rho) <= 0.925, low, high)


def _cell_masses_value(mu, sig_x, sig_y, rho, cell, K, upper_fn):
    """Corner-CDF cell masses on sanitized inputs — the shared value
    computation behind :func:`_cell_masses_core` (scalar-ρ ``lax.switch``
    node selection) and :func:`_cell_masses_core_sel` (batch-friendly
    two-branch select)."""
    dtype = mu.dtype
    n = 2 * K + 1

    # standardized corner coordinates (x ascending with column index,
    # y descending with row index — reference orientation)
    xe = ((jnp.arange(n + 1, dtype=dtype) - K - 0.5) * cell - mu[0]) / sig_x
    ye = ((K + 0.5 - jnp.arange(n + 1, dtype=dtype)) * cell - mu[1]) / sig_y
    H = jnp.broadcast_to(xe[:, None], (n + 1, n + 1))
    Kg = jnp.broadcast_to(ye[None, :], (n + 1, n + 1))
    # the independence term is separable on the corner lattice: two 1-D
    # ndtr sweeps instead of 2(n+1)^2 full-grid evaluations
    phi_prod = ndtr(-xe)[:, None] * ndtr(-ye)[None, :]
    U = upper_fn(H, Kg, rho, phi_prod)        # [x_edge, y_edge]

    # cell (row i, col j): x ∈ [xe[j], xe[j+1]], y ∈ [ye[i+1], ye[i]]
    rect = (U[:-1, 1:] - U[1:, 1:]) - (U[:-1, :-1] - U[1:, :-1])
    # clamp f32 differencing noise (~1e-8) in the far tails
    return jnp.maximum(rect.T, 0.0)           # -> [row, col]


@partial(jax.custom_jvp, nondiff_argnums=(5,))
def _cell_masses_core(mu, sig_x, sig_y, rho, cell, K):
    """Corner-CDF cell masses on sanitized inputs (see
    :func:`bvn_cell_masses` for the contract).  Carries a custom JVP: the
    quadrature evaluates only the *value*; tangents use the closed-form BVN
    CDF derivatives (no quadrature, no ``lax.switch``), which makes
    reverse-mode gradients (MAP/NUTS) cost ~a forward pass instead of
    differentiating through every Gauss–Legendre node."""
    return _cell_masses_value(mu, sig_x, sig_y, rho, cell, K,
                              bvn_upper_grid)


@partial(jax.custom_jvp, nondiff_argnums=(5,))
def _cell_masses_core_sel(mu, sig_x, sig_y, rho, cell, K):
    """As :func:`_cell_masses_core` but with the two-branch select node
    scheme (:func:`bvn_upper_grid_select`) — the ensemble-batched variant
    (``vmap`` over particles with per-particle ρ)."""
    return _cell_masses_value(mu, sig_x, sig_y, rho, cell, K,
                              bvn_upper_grid_select)


def _cell_masses_tangent(K, primals, tangents, primal_out):
    """Closed-form tangent of the corner-CDF cell masses.

    With L(h, k; ρ) = P(X > h, Y > k) the upper-orthant probability,

        ∂L/∂h = −φ(h) Φ(−(k − ρh)/√(1−ρ²))
        ∂L/∂k = −φ(k) Φ(−(h − ρk)/√(1−ρ²))
        ∂L/∂ρ = φ₂(h, k; ρ)                    (Plackett's identity)

    — all branch-free and quadrature-free.  The cell-mass tangent is the
    same four-corner difference applied to dU.  Linear in the input
    tangents, so JAX transposes this rule to get the reverse-mode VJP.
    Shared by both core variants (the tangent is scheme-independent).
    """
    mu, sig_x, sig_y, rho, cell = primals
    dmu, dsig_x, dsig_y, drho, dcell = tangents
    dtype = mu.dtype
    n = 2 * K + 1

    jcol = jnp.arange(n + 1, dtype=dtype) - K - 0.5          # x multipliers
    irow = K + 0.5 - jnp.arange(n + 1, dtype=dtype)          # y multipliers
    xe = (jcol * cell - mu[0]) / sig_x
    ye = (irow * cell - mu[1]) / sig_y
    dxe = (jcol * dcell - dmu[0]) / sig_x - xe * (dsig_x / sig_x)
    dye = (irow * dcell - dmu[1]) / sig_y - ye * (dsig_y / sig_y)

    s2 = jnp.maximum(1.0 - rho * rho, jnp.asarray(1e-12, dtype))
    s = jnp.sqrt(s2)
    H = xe[:, None]
    Kg = ye[None, :]
    pdf_x = jnp.exp(-0.5 * xe * xe) / _SQRT_2PI              # φ(h), (n+1,)
    pdf_y = jnp.exp(-0.5 * ye * ye) / _SQRT_2PI              # φ(k), (n+1,)
    Lh = -pdf_x[:, None] * ndtr(-(Kg - rho * H) / s)         # ∂L/∂h
    Lk = -pdf_y[None, :] * ndtr(-(H - rho * Kg) / s)         # ∂L/∂k
    # ∂L/∂ρ = bivariate density; the exponent is ≤ 0 (PD quadratic form),
    # so exp only ever underflows to 0
    Q = (H * H - 2.0 * rho * H * Kg + Kg * Kg) / s2
    Lrho = jnp.exp(-0.5 * Q) / (_TWO_PI * s)

    dU = dxe[:, None] * Lh + dye[None, :] * Lk + drho * Lrho
    rect_t = (dU[:-1, 1:] - dU[1:, 1:]) - (dU[:-1, :-1] - dU[1:, :-1])
    # the primal clamps tail differencing noise at 0; zero those tangents
    return jnp.where(primal_out > 0, rect_t.T, 0.0)


@_cell_masses_core.defjvp
def _cell_masses_jvp(K, primals, tangents):
    primal_out = _cell_masses_core(*primals, K)
    return primal_out, _cell_masses_tangent(K, primals, tangents,
                                            primal_out)


@_cell_masses_core_sel.defjvp
def _cell_masses_sel_jvp(K, primals, tangents):
    primal_out = _cell_masses_core_sel(*primals, K)
    return primal_out, _cell_masses_tangent(K, primals, tangents,
                                            primal_out)


@partial(jax.jit, static_argnames=('K', 'G'))
def bvn_cell_masses(mu, sig_x, sig_y, rho, cell, K, G=None):
    """Integrate N(mu, S) over every cell of a (2K+1)×(2K+1) grid window.

    Args:
        mu: (2,) distribution mean (x, y) in meters, relative to the center
            cell's center.
        sig_x, sig_y: standard deviations (m); rho: correlation.
        cell: cell side length (m).
        K: static window half-width in cells.
        G: unused by this scheme (node count is auto-selected from |ρ|);
            accepted for signature compatibility with
            :func:`bvn_cell_masses_quad`.

    Returns:
        (2K+1, 2K+1) array of cell probabilities; row 0 is the top (+y) row,
        column 0 the left (−x) column, center cell at [K, K] — the same
        orientation as the reference's ``cdf_mat``
        (ParasitoidModel.py:377-378).
    """
    dtype = jnp.result_type(float)
    mu = jnp.asarray(mu, dtype)
    sig_x = jnp.maximum(jnp.asarray(sig_x, dtype), 1e-8)
    sig_y = jnp.maximum(jnp.asarray(sig_y, dtype), 1e-8)
    rho = jnp.clip(jnp.asarray(rho, dtype), -1 + 1e-6, 1 - 1e-6)
    cell = jnp.asarray(cell, dtype)
    return _cell_masses_core(mu, sig_x, sig_y, rho, cell, K)


@partial(jax.jit, static_argnames=('K', 'G'))
def bvn_cell_masses_batched(mu, sig_x, sig_y, rho, cell, K, G=None):
    """Ensemble-batched variant of :func:`bvn_cell_masses`: identical
    contract and closed-form JVP, but the ρ node-count ``lax.switch`` is
    replaced by a fixed-G (20-node) two-branch ``jnp.where`` select
    (:func:`bvn_upper_grid_select`) so a particle-``vmap`` with
    per-particle ρ executes exactly two branch bodies instead of four
    (VERDICT r4 item 4).  Accuracy is the same or better than the scalar
    path (G=20 everywhere |ρ| < 0.925; the identical series beyond).  For
    scalar-ρ programs prefer :func:`bvn_cell_masses`."""
    dtype = jnp.result_type(float)
    mu = jnp.asarray(mu, dtype)
    sig_x = jnp.maximum(jnp.asarray(sig_x, dtype), 1e-8)
    sig_y = jnp.maximum(jnp.asarray(sig_y, dtype), 1e-8)
    rho = jnp.clip(jnp.asarray(rho, dtype), -1 + 1e-6, 1 - 1e-6)
    cell = jnp.asarray(cell, dtype)
    return _cell_masses_core_sel(mu, sig_x, sig_y, rho, cell, K)


@partial(jax.jit, static_argnames=('K', 'G'))
def bvn_cell_masses_quad(mu, sig_x, sig_y, rho, cell, K, G=16):
    """Conditional-decomposition scheme (the previous default; kept as an
    independent cross-check):

        mass(i, j) = ∫_{x in col_j} φ_{μx,σx}(x) ·
                     [Φ((y_hi(i) − m(x))/s) − Φ((y_lo(i) − m(x))/s)] dx

    with ``m(x) = μy + ρ σy (x − μx)/σx``, ``s = σy sqrt(1 − ρ²)``, and the
    outer integral in probability space ``u = Φ((x − μx)/σx)`` under G-node
    Gauss–Legendre (the same variable change Genz's algorithm uses).
    Accuracy degrades gracefully as |ρ| → 1 with strong anisotropy; prefer
    :func:`bvn_cell_masses`."""
    dtype = jnp.result_type(float)
    mu = jnp.asarray(mu, dtype)
    sig_x = jnp.maximum(jnp.asarray(sig_x, dtype), 1e-8)
    sig_y = jnp.maximum(jnp.asarray(sig_y, dtype), 1e-8)
    rho = jnp.clip(jnp.asarray(rho, dtype), -1 + 1e-7, 1 - 1e-7)
    cell = jnp.asarray(cell, dtype)

    n = 2 * K + 1
    t_np, w_np = gauss_legendre(G)
    t = jnp.asarray(t_np, dtype)
    w = jnp.asarray(w_np, dtype)

    # x edges ascending with column index: col j spans [(j-K-.5)c, (j-K+.5)c]
    xe = (jnp.arange(n + 1, dtype=dtype) - K - 0.5) * cell
    u_edges = ndtr((xe - mu[0]) / sig_x)                      # (n+1,)
    lo, hi = u_edges[:-1], u_edges[1:]
    half = 0.5 * (hi - lo)                                    # (n,)
    mid = 0.5 * (hi + lo)

    # Saturated quadrature nodes (u at 0 or 1) are replaced by a harmless
    # midpoint before ndtri and patched with a large constant after: the
    # naive clip produces 0-gradient x inf-slope = NaN under autodiff
    # (ndtri' = 1/phi overflows f32 beyond |z| ~ 12).
    tiny = jnp.asarray(np.finfo(np.dtype(dtype)).tiny, dtype)
    uu0 = mid[:, None] + half[:, None] * t[None, :]           # (n, G)
    in_range = (uu0 > tiny) & (uu0 < 1.0 - jnp.finfo(dtype).eps)
    z_safe = ndtri(jnp.where(in_range, uu0, 0.5))
    z = jnp.where(in_range, z_safe,
                  jnp.where(uu0 <= tiny, -38.0, 38.0))        # standardized x

    m_cond = mu[1] + rho * sig_y * z                          # (n, G)
    s_cond = jnp.maximum(sig_y * jnp.sqrt(1.0 - rho * rho), 1e-12)

    # y edges descending with row index: row i spans [(K-i-.5)c, (K-i+.5)c]
    ye = (K + 0.5 - jnp.arange(n + 1, dtype=dtype)) * cell    # (n+1,)
    zz = (ye[None, None, :] - m_cond[:, :, None]) / s_cond    # (n, G, n+1)
    cdf = ndtr(zz)
    d_phi = cdf[..., :-1] - cdf[..., 1:]                      # (n, G, n) cols,G,rows

    # mass(i, j) = sum_g half_j * w_g * d_phi[j, g, i]
    # HIGHEST precision: the default contraction precision may truncate
    # f32 inputs (TF32 on a GPU), costing ~1e-3 relative error; these
    # contractions are tiny, so full f32 is free.
    return jnp.einsum('j,jgi,g->ij', half, d_phi, w,
                      precision=jax.lax.Precision.HIGHEST)
