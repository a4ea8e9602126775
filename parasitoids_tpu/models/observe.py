"""Observation model (L3→L4 bridge): population fields → expected counts.

Rebuilds the reference's ``Bayes_funcs`` projections
(popdensity_to_emergence Bayes_funcs.py:20-152, popdensity_grid :156-179,
popdensity_card :183-221) in an accelerator-friendly form.  The reference
loops over oviposition days and grid points in Python per MCMC sample; here
every projection is factored into *static* gather indices and weight matrices
(precomputed once from LocInfo on the host), so inside the jitted likelihood
each projection is a gather plus a small matmul:

    emergence[n, obs_col] = sum_day pop[day, point_n] * W[day, obs_col]

where ``W = M @ B`` combines the incubation-time distribution M (oviposition
day → feasible emergence day, 19-25 days at weights .05/.1/.2/.3/.2/.1/.05,
Bayes_funcs.py:17-18) and the binning matrix B (emergence day → observation
date, Bayes_funcs.py:76-89).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ['ObservationOps', 'INCUBATION_TIME', 'MAX_INCUBATION']

# oviposition-to-emergence time distribution (19..25 days inclusive),
# ref Bayes_funcs.py:17-18
INCUBATION_TIME = np.array([0.05, 0.1, 0.2, 0.3, 0.2, 0.1, 0.05])
MAX_INCUBATION = 25


def _emergence_weights(collection_day, obs_cols, ndays):
    """W[day, obs_col]: contribution of day-``day`` population (per wasp) to
    expected emergence counted on observation column ``obs_col``."""
    M = np.zeros((ndays, MAX_INCUBATION))
    start_day = max(collection_day - MAX_INCUBATION, 0)
    for day in range(start_day, min(collection_day, ndays)):
        max_post = day + MAX_INCUBATION - collection_day
        if max_post < 0:
            continue
        min_post = max(0, max_post + 1 - INCUBATION_TIME.size)
        span = max_post - min_post + 1
        M[day, min_post:max_post + 1] = INCUBATION_TIME[-span:]
    B = np.zeros((MAX_INCUBATION, len(obs_cols)))
    col_indices = [int(c) - collection_day for c in obs_cols]
    B[0:col_indices[0] + 1, 0] = 1.0
    for n, col in enumerate(col_indices[1:]):
        B[col_indices[n] + 1:col + 1, n + 1] = 1.0
    return M @ B


def _exposure_weights(obs_days, ndays):
    """W[day, obs_col] for the rotating-sentinel ('exposure') protocol:
    observation column ``col`` (dated ``obs_days[col]`` days post-release)
    counts the eventual emergence from plants exposed during
    ``(obs_days[col-1], obs_days[col]]`` — a direct census of that
    window's oviposition, so each window day contributes its population
    with weight 1 and no incubation offset (day index i = day i+1
    post-release, the same convention as ``_emergence_weights``)."""
    W = np.zeros((ndays, len(obs_days)))
    prev = 0
    for col, d in enumerate(obs_days):
        if d <= prev:
            raise ValueError('exposure-protocol observation dates must be '
                             'strictly increasing and after the release '
                             '(got day {} after day {})'.format(d, prev))
        W[prev:min(d, ndays), col] = 1.0
        prev = d
    return W


class _Projection(NamedTuple):
    point_rows: np.ndarray     # flattened gather index (row*D + col)
    weights: np.ndarray        # (ndays, n_obs_cols)


class ObservationOps:
    """Precomputed observation projections for one LocInfo + domain.

    Methods are jit-compatible; build once per inference run.
    """

    def __init__(self, locinfo, domain_info, ndays):
        D = int(domain_info[1]) * 2 + 1
        res = domain_info[0] / domain_info[1]
        self.dom_len = D
        self.ndays = ndays

        # a simulation shorter than the observation timeline silently
        # truncates oviposition windows / clamps day gathers — legitimate
        # for deliberately tiny smoke configs, a misconfiguration
        # otherwise, so warn with the needed horizon (the reference
        # instead dies with a bare IndexError, Bayes_funcs.py:167-173)
        need = [d.days for d in locinfo.collection_datesPR]
        need += [d.days for d in locinfo.grid_obs_datesPR]
        need += [d.days for d in locinfo.card_obs_datesPR]
        if need and max(need) > ndays:
            import warnings
            warnings.warn(
                'simulation covers {} day(s) but observations run to day '
                '{} post-release; late oviposition/observation days are '
                'truncated to the simulated horizon'.format(
                    ndays, max(need)), RuntimeWarning, stacklevel=2)

        ### release-field grid emergence (per collection)
        # generic sites may skip the release channel on some collections
        # (release_coll_idx maps kept frames to collection entries) and may
        # use the rotating-sentinel 'exposure' protocol instead of the
        # Kalbar lab-incubation one (LocInfo._generic_sentinel)
        rel_idx = getattr(locinfo, 'release_coll_idx', None)
        if rel_idx is None:
            rel_idx = list(range(len(locinfo.release_DataFrames)))
        protocols = getattr(locinfo, 'sent_protocols', None)
        if protocols is None:
            protocols = ['lab'] * len(locinfo.sent_DataFrames)
        self.release_proj = []
        for nframe, dframe in enumerate(locinfo.release_DataFrames):
            ncoll = rel_idx[nframe]
            cd = locinfo.collection_datesPR[ncoll].days
            obs = [int(d / np.timedelta64(1, 'D'))
                   for d in dframe['datePR'].unique()]
            idx = np.array([r * D + c for r, c in
                            locinfo.emerg_grids[nframe]], np.int32)
            if protocols[ncoll] == 'exposure':
                W = _exposure_weights(obs, ndays)
            else:
                W = _emergence_weights(cd, obs, ndays)
            self.release_proj.append(_Projection(
                idx, np.asarray(W, np.float32)))

        ### sentinel-field emergence (per collection)
        # field sums via concatenated cell gather + per-field segment ids
        cells = []
        seg = []
        for n, fid in enumerate(locinfo.sent_ids):
            fc = locinfo.field_cells[fid]
            cells.append(fc[:, 0] * D + fc[:, 1])
            seg.append(np.full(fc.shape[0], n))
        self.sent_cells = np.concatenate(cells).astype(np.int32)
        self.sent_seg = np.concatenate(seg).astype(np.int32)
        self.n_sent = len(locinfo.sent_ids)
        self.sentinel_W = []
        for nframe, dframe in enumerate(locinfo.sent_DataFrames):
            cd = locinfo.collection_datesPR[nframe].days
            obs = [int(d / np.timedelta64(1, 'D'))
                   for d in dframe['datePR'].unique()]
            if protocols[nframe] == 'exposure':
                W = _exposure_weights(obs, ndays)
            else:
                W = _emergence_weights(cd, obs, ndays)
            self.sentinel_W.append(np.asarray(W, np.float32))

        ### grid adult counts: end-of-day density at sampled cells
        # (ref Bayes_funcs.py:167-173: modelsol[date.days-1])
        gidx = np.array([r * D + c for r, c in locinfo.grid_cells], np.int32)
        self.grid_idx = gidx
        self.grid_days = np.array(
            [d.days - 1 for d in locinfo.grid_obs_datesPR], np.int32)
        if (self.grid_days < 0).any():
            # day 0 would gather index -1: the jitted path wraps to the
            # LAST day (as the reference's modelsol[-1] Python wrap does,
            # a latent bug there) while the host path clips to day 0 —
            # neither is meaningful, so reject it
            raise ValueError('grid observation dated on/before the '
                             'release day (day {})'.format(
                                 int(self.grid_days.min()) + 1))
        # keep the jitted gather and the host variant consistent on runs
        # shorter than the observation schedule: both clamp to the last
        # simulated day (see the horizon warning above)
        self.grid_days = np.minimum(self.grid_days, ndays - 1)

        ### cardinal-direction transects (list of static gathers per day)
        self.card_gathers = []
        center = int(domain_info[1])
        # generic sites record the true per-observation transect distances
        # (LocInfo.card_dists, (4, obslen) per day); the reference formula
        # 5 + step_size*(1..n) m is its one site's hard-coded sampling
        # geometry (ref Bayes_funcs.py:193-215), kept for kalbar parity
        card_dists = getattr(locinfo, 'card_dists', None)
        for nday, date in enumerate(locinfo.card_obs_datesPR):
            obslen = locinfo.card_obs[nday].shape[1]
            if card_dists is not None:
                dist = np.asarray(card_dists[nday], float)   # (4, obslen)
            else:
                dist = np.broadcast_to(
                    5 + locinfo.step_size[nday] * (1 + np.arange(obslen)),
                    (4, obslen))
            delta = (dist // res).astype(np.int32)
            rows = np.stack([center - delta[0], center + delta[1],
                             np.full(obslen, center),
                             np.full(obslen, center)])
            cols = np.stack([np.full(obslen, center),
                             np.full(obslen, center),
                             center + delta[2], center - delta[3]])
            day = int(date.days) - 1
            if day < 0:
                raise ValueError('cardinal observation dated on/before '
                                 'the release day')
            self.card_gathers.append(
                (min(day, ndays - 1),             # clamp like grid_days
                 rows * D + cols))                # (4, obslen) flat index

    # ------------------------------------------------------------------
    @partial(jax.jit, static_argnums=(0,))
    def project_emergence(self, fields):
        """fields (ndays, D, D) → (release_emerg list, sentinel_emerg list)
        matching the reference's array layout: rows = grid points / fields,
        cols = observation dates (Bayes_funcs.py:145-152)."""
        flat = fields.reshape(fields.shape[0], -1)       # (ndays, D*D)
        release = []
        for proj in self.release_proj:
            pts = flat[:, proj.point_rows]               # (ndays, n_pts)
            release.append(jnp.matmul(pts.T, proj.weights,
                                      precision=lax.Precision.HIGHEST))
        sentinel = []
        cell_vals = flat[:, self.sent_cells]             # (ndays, n_cells)
        field_tot = jax.ops.segment_sum(
            cell_vals.T, self.sent_seg, num_segments=self.n_sent)
        for W in self.sentinel_W:
            sentinel.append(jnp.matmul(field_tot, W,
                                       precision=lax.Precision.HIGHEST))
        return release, sentinel

    @partial(jax.jit, static_argnums=(0,))
    def project_grid(self, fields):
        """fields → (n_grid_points, n_obs_dates) expected counts
        (ref Bayes_funcs.py:156-179)."""
        flat = fields.reshape(fields.shape[0], -1)
        pts = flat[:, self.grid_idx]                     # (ndays, n_grid)
        return pts[self.grid_days].T                     # (n_grid, n_dates)

    @partial(jax.jit, static_argnums=(0,))
    def project_card(self, fields):
        """fields → list of (4, obslen) cardinal transect densities
        (ref Bayes_funcs.py:183-221)."""
        flat = fields.reshape(fields.shape[0], -1)
        return [flat[day][idx] for day, idx in self.card_gathers]

    # --- host (NumPy) variants for viz/analysis tooling ----------------
    # Same math as the jitted methods, no jax involvement: plotting tools
    # need not initialize the accelerator backend or compile anything.

    def project_emergence_np(self, fields):
        flat = np.asarray(fields).reshape(len(fields), -1)
        release = [flat[:, p.point_rows].T @ p.weights
                   for p in self.release_proj]
        cell_vals = flat[:, self.sent_cells]             # (ndays, n_cells)
        field_tot = np.zeros((self.n_sent, flat.shape[0]),
                             cell_vals.dtype)
        np.add.at(field_tot, self.sent_seg, cell_vals.T)
        sentinel = [field_tot @ W for W in self.sentinel_W]
        return release, sentinel

    def project_grid_np(self, fields):
        flat = np.asarray(fields).reshape(len(fields), -1)
        days = np.clip(self.grid_days, 0, flat.shape[0] - 1)  # jnp-gather clamp
        return flat[:, self.grid_idx][days].T

    def project_card_np(self, fields):
        flat = np.asarray(fields).reshape(len(fields), -1)
        return [flat[min(day, flat.shape[0] - 1)][idx]
                for day, idx in self.card_gathers]
