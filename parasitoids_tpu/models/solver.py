"""Multi-day FFT-convolution propagation (L3).

Accelerator replacement for the reference's convolution solvers — the
scipy FFTPACK CPU path (CalcSol.py) and the Reikna/PyCUDA GPU path
(cuda_lib.py).  Design departures, deliberate:

* density fields stay **dense in device memory** end to end (an 801² f32
  field is ~2.6 MB); the reference's COO/CSR sparse bookkeeping disappears,
* all transforms are **real** FFTs (`rfft2`/`irfft2`) — fields and kernels
  are real, so the Hermitian half-spectrum halves both FLOPs and memory
  versus the reference's complex FFTs (scipy fftpack / Reikna complex64),
* the FFT pad is a *static* shape ≥ dom_len + rad_res, which is exactly
  alias-free for every **single-kernel** convolution of a domain-limited
  signal (see ``SolverConfig.for_domain``) — and the solvers are structured
  so that single-kernel convolutions are the only kind in the chain: the
  population model carries each release cohort as its own truncated field
  rather than multiplying several kernel spectra at once.  (The reference
  sizes its pad from the largest trimmed kernel per run, CalcSol.py:20-21,
  which is data dependent and aliases when wrong.)  The one exception,
  ``propagate_prob_logdepth``, builds k-fold spectral products and
  therefore uses the larger 2·dom_len − 1 pad with a documented caveat,
* the zero/absorbing boundary is enforced **every day**: the daily update
  truncates the solution to the domain and re-transforms it.  The reference
  does this lazily — it detects pad-region mass and re-FFTs only then (the
  ``bndry_flag``, CalcSol.py:28-41,199-201, re-injecting the *truncated,
  un-thresholded* field) — but on the headline workloads the flag fires
  every single day (measured on Kalbar: 17/17 days at population scale), so
  a `lax.cond` would skip nothing.  Unconditional daily absorption is the
  same physics, branch-free, and strictly enforces the boundary,
* kernels are corner-shifted ("fftshift by hand", CalcSol.py:56-64) with a
  single ``jnp.roll`` on the padded array.

Population mode reproduces ``CalcSol.get_populations`` (CalcSol.py:205-325):
instead of the reference's per-day ``back_solve`` re-convolution of earlier
cohorts from the current solution (CalcSol.py:72-109), each release cohort
is carried forward as its own domain-truncated field and all cohorts
advance with the day's kernel in one *batched* FFT — same chain of
single-kernel convolutions (so the D + rad_res pad stays exact), one scan,
no spectral products.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.daily_kernel import r_small_vals_dense

__all__ = ['SolverConfig', 'signal_fft', 'filter_fft', 'fft_conv_once',
           'propagate_prob', 'propagate_prob_logdepth', 'propagate_pop',
           'next_fast_len']


def next_fast_len(n: int) -> int:
    """Smallest integer >= n of the form 2^k, 3*2^k or 5*2^k: FFT sizes
    with at most one odd factor (3 or 5).  Whether the GPU's FFT would
    rather take general 5-smooth sizes is not measured yet."""
    best = 1 << (n - 1).bit_length()
    for odd in (3, 5):
        p = odd
        while p < n:
            p *= 2
        if p < best:
            best = p
    return best


class SolverConfig(NamedTuple):
    dom_len: int     # D = 2*rad_res + 1
    fft_len: int     # P >= D + rad_res for alias-free daily convolution

    @classmethod
    def for_domain(cls, rad_res: int):
        """Alias-free transform size for the daily chain.

        The signal is always domain-limited (the absorbing boundary truncates
        it to D x D every day) and every daily kernel is a *centered* D x D
        array, so its support radius is at most ``rad_res`` by construction.
        Output cells [0, D)^2 then alias only if P < D + rad_res: a wrapped
        contribution needs |true_lag - P| <= rad_res with |true_lag| < D.
        P >= D + rad_res is therefore exact — wrapped mass can land only in
        the discarded pad region.  (The reference pads to signal + kernel/2,
        CalcSol.py:20-21, from the *trimmed* kernel — data dependent; this
        bound is static and never aliases.)
        """
        D = 2 * rad_res + 1
        return cls(dom_len=D, fft_len=next_fast_len(D + rad_res))


def signal_fft(field, P):
    """Real FFT of a domain field placed at the top-left of the padded grid
    (ref CalcSol.fft2, CalcSol.py:11-24)."""
    D = field.shape[-1]
    pad = [(0, 0)] * (field.ndim - 2) + [(0, P - D), (0, P - D)]
    return jnp.fft.rfft2(jnp.pad(field, pad))


def filter_fft(kernel, P):
    """Real FFT of an odd-sized convolution kernel, corner-shifted so its
    center sits at index (0, 0) with wraparound (ref CalcSol.fftconv2,
    CalcSol.py:56-65)."""
    D = kernel.shape[-1]
    c = D // 2
    pad = [(0, 0)] * (kernel.ndim - 2) + [(0, P - D), (0, P - D)]
    shifted = jnp.roll(jnp.pad(kernel, pad), (-c, -c), axis=(-2, -1))
    return jnp.fft.rfft2(shifted)


def _irfft(x_hat, P):
    return jnp.fft.irfft2(x_hat, s=(P, P))


def fft_conv_once(field, kernel, P):
    """One alias-free FFT convolution of a domain field with a domain-sized
    kernel (testing / single-step use)."""
    D = field.shape[-1]
    out = _irfft(signal_fft(field, P) * filter_fft(kernel, P), P)
    return out[..., :D, :D]


@partial(jax.jit, static_argnames=('config',))
def propagate_prob(kernels, config: SolverConfig):
    """Chain daily kernels into per-day probability fields
    (ref CalcSol.get_solutions, CalcSol.py:140-201, CPU semantics; the
    boundary re-FFT applied unconditionally — see module docstring).

    Args:
        kernels: (ndays, D, D) daily pmfs; day 0 is the recentered initial
            spread (Run.py:453-458 does this recentering in the reference).
    Returns:
        (ndays, D, D) per-day probability fields, each thresholded at 1e-8
        with removed mass redistributed (prob-model ``r_small_vals``).
    """
    D, P = config.dom_len, config.fft_len
    # all daily filter transforms as ONE batched FFT before the scan — a
    # third of the chain's transforms, at much better MXU/VPU utilization
    # than one small FFT per sequential scan step
    k_hat = filter_fft(kernels[1:], P)

    def step(dom, kh):
        full = _irfft(signal_fft(dom, P) * kh, P)
        dom_next = full[:D, :D]
        out = r_small_vals_dense(dom_next, prob_model=True)
        return dom_next, out

    _, rest = lax.scan(step, kernels[0], k_hat)
    return jnp.concatenate([kernels[:1], rest], axis=0)


@partial(jax.jit, static_argnames=('config', 'segment'))
def propagate_prob_logdepth(kernels, config: SolverConfig, segment=None):
    """Log-depth variant of :func:`propagate_prob` via
    ``lax.associative_scan`` over per-day kernel spectra (SURVEY.md
    section 5: convolution is associative, so the day chain need not be
    sequential).

    ``segment=None`` (pure mode) applies NO absorbing-boundary truncation
    between days — the chain is the raw convolution product, so mass that
    leaves the domain mid-run is not absorbed, and day-k composes k kernel
    spectra (support up to k·rad_res) against a fixed 2·dom_len − 1 pad:
    once composite spread exceeds that budget the output aliases.  Parity
    with the sequential solver holds only while no mass reaches the pad
    (tests/test_solver.py probes the violating regime explicitly).

    ``segment=s`` (segmented absorption) re-imposes the absorbing boundary
    every ``s`` days: within a segment the prefix products run at log
    depth (batched ``associative_scan`` over segments), and segment
    boundaries truncate the carried field to the domain — the same physics
    as the sequential solver applied at s-day granularity, with an
    *honestly sized* alias-free pad ``next_fast_len(D + s·rad_res)``
    (composite in-segment support is at most s·rad_res).  ``segment=1``
    reproduces :func:`propagate_prob` exactly.  Depth is
    O(n/s + log s); pick s to trade pad size (FFT cost per point) against
    sequential depth.

    Outputs are thresholded and renormalized per day exactly like the
    default in both modes.
    """
    D = config.dom_len
    n = kernels.shape[0]
    if segment is not None and n == 1:
        return kernels                       # day-0 kernel only; nothing to do
    if segment is None:
        P = max(config.fft_len, next_fast_len(2 * D - 1))
        k_hat = filter_fft(kernels[1:], P)                # (n-1, P, Ph)
        prefix = lax.associative_scan(jnp.multiply, k_hat, axis=0)
        sol_hat = signal_fft(kernels[0], P)[None] * prefix
        fields = _irfft(sol_hat, P)[:, :D, :D]
        rest = jax.vmap(lambda f: r_small_vals_dense(f, prob_model=True))(
            fields)
        return jnp.concatenate([kernels[:1], rest], axis=0)

    # a segment can't be longer than the day chain; clamping (rather than
    # falling back to pure mode) keeps the segmented guarantee: the pad
    # below is sized for the actual in-segment composite support, so a
    # caller who asked for segmented (alias-free) mode never gets pure
    # mode's smaller 2D-1 pad
    s = int(min(segment, n - 1))
    rad_res = (D - 1) // 2
    P = next_fast_len(D + s * rad_res)
    m = -(-(n - 1) // s)                                  # segments
    pad_days = m * s - (n - 1)
    # pad the tail with identity kernels (delta at center -> all-ones
    # spectrum) so segments are uniform; padded outputs are dropped
    if pad_days:
        delta = jnp.zeros((pad_days, D, D), kernels.dtype)
        delta = delta.at[:, D // 2, D // 2].set(1.0)
        k_rest = jnp.concatenate([kernels[1:], delta], axis=0)
    else:
        k_rest = kernels[1:]
    k_hat = filter_fft(k_rest, P).reshape(m, s, P, P // 2 + 1)
    prefix = lax.associative_scan(jnp.multiply, k_hat, axis=1)

    def seg_step(dom, pref):
        # dom: the absorbed (domain-truncated) field at segment start
        sol_hat = signal_fft(dom, P)[None] * pref          # (s, P, Ph)
        fields = _irfft(sol_hat, P)[:, :D, :D]             # absorbed daily
        return fields[-1], fields

    _, fields = lax.scan(seg_step, kernels[0], prefix)
    fields = fields.reshape(m * s, D, D)[:n - 1]
    rest = jax.vmap(lambda f: r_small_vals_dense(f, prob_model=True))(
        fields)
    return jnp.concatenate([kernels[:1], rest], axis=0)


@partial(jax.jit, static_argnames=('config', 'r_dur'))
def propagate_pop(kernels, r_dur: int, r_number, dist_weights,
                  config: SolverConfig):
    """Expected population fields with multi-day releases
    (ref CalcSol.get_populations, CalcSol.py:205-325).

    Cohort d (released on day d < r_dur) spreads with kernels d..n by day n;
    day-n population = r_number * sum_d dist(d+1) * cohort_d(n), with
    not-yet-released mass held at the origin during the release ramp
    (CalcSol.py:236-237,273-274,305-306).

    Each cohort is carried forward as its own domain-truncated field, so
    every transform in the chain is a single-kernel convolution — exactly
    the regime for which ``SolverConfig.for_domain``'s P >= D + rad_res pad
    is alias-free.  (A spectral suffix-product back-solve would multiply
    several kernel spectra at once; the composite support, up to
    r_dur*rad_res, overruns that pad.  The reference's ``back_solve`` also
    applies one filter at a time with an inverse transform between
    applications, CalcSol.py:88-106.)  The per-day cohort transforms are
    batched — one batched FFT per day over the (r_dur, D, D) cohort state.

    Args:
        kernels: (ndays, D, D) daily pmfs; entries 0..r_dur-1 are the
            release-day spreads (day 0 built with the release start time).
        r_dur: number of release days (static).
        r_number: total wasps released.
        dist_weights: (r_dur,) emergence distribution over release days.
    Returns:
        (ndays, D, D) per-day expected population fields, thresholded at
        1e-8 (no renormalization — population mode).
    """
    D, P = config.dom_len, config.fft_len
    ndays = kernels.shape[0]
    c = D // 2
    dtype = kernels.dtype

    def thresh(x):
        return r_small_vals_dense(x, prob_model=False)

    # cohort state: (r_dur, D, D); cohort d activates on day d
    cohorts0 = jnp.zeros((r_dur, D, D), dtype)
    cohorts0 = cohorts0.at[0].set(kernels[0])

    day0 = thresh(kernels[0]) * (r_number * dist_weights[0])
    day0 = day0.at[c, c].add(r_number * (1.0 - dist_weights[0]))

    def step(cohorts, xs):
        kernel, kh, day = xs
        # all active cohorts advance with today's kernel (one batched FFT);
        # cohorts not yet released stay zero (0 * kh = 0)
        moved = _irfft(signal_fft(cohorts, P) * kh[None], P)[:, :D, :D]
        # a release day seeds its own cohort with today's spread instead
        d_idx = jnp.arange(r_dur)
        cohorts = jnp.where((d_idx == day)[:, None, None],
                            kernel[None], moved)
        active = (d_idx <= day).astype(dtype)
        w = dist_weights * active
        pop = thresh(jnp.tensordot(w, cohorts, axes=1,
                                   precision=lax.Precision.HIGHEST)
                     * r_number)
        # unreleased mass waits at the origin (ref :236-237,273-274,305-306)
        pop = pop.at[c, c].add(r_number * (1.0 - jnp.sum(w)))
        return cohorts, pop

    if ndays > 1:
        # all daily filter transforms as ONE batched FFT before the scan
        _, rest = lax.scan(
            step, cohorts0,
            (kernels[1:], filter_fft(kernels[1:], P),
             jnp.arange(1, ndays)))
        out = jnp.concatenate([day0[None], rest], axis=0)
    else:
        out = day0[None]
    return out.astype(dtype)
