"""Replica-exchange MCMC (parallel tempering) over a device mesh.

Beyond-reference capability: the reference's PyMC AdaptiveMetropolis runs a
single chain on the posterior (Bayes_Run.py:484-487) and can stall in a
basin of the 20-parameter landscape; here a ladder of inverse temperatures
``1 = beta_0 > beta_1 > ... > beta_{T-1}`` runs one adaptive-Metropolis
replica per temperature against ``prior + beta * loglik`` (likelihood-only
tempering — every replica keeps the exact prior support), with periodic
even–odd nearest-neighbor state swaps accepted at

    log alpha = (beta_i - beta_j) * (loglik_j - loglik_i),

so hot replicas explore and the cold chain (index 0) is the posterior.

Two execution paths, numerically identical (tested against each other):

* ``run_pt`` — one compiled program on a single chip: ``lax.map`` over the
  replica axis (never ``vmap``: a replica-batched forward pass batches the
  BVN integrator's rho ``lax.switch`` and pays every branch, see
  parallel/chains.py), swaps as gathers on the stacked axis.
* ``run_pt_sharded`` — one replica per device over a ``jax.sharding.Mesh``:
  each device advances its replica locally; the swap phase ``ppermute``s
  log-likelihoods and swap state to both ladder neighbors and selects
  acceptance with ``jnp.where`` — nearest-neighbor ICI traffic only, no
  gathers.

Replica adaptation state (Haario moments, proposal scale) is *not*
swapped: each temperature keeps adapting to its own tempered target, which
preserves diminishing adaptation across exchanges.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, random
from jax.sharding import NamedSharding, PartitionSpec as P

from .model import BayesSetup
from .sampler import ChainState, MCMCConfig, mcmc_step

__all__ = ['PTConfig', 'geometric_ladder', 'power_ladder', 'init_pt_states',
           'run_pt', 'run_pt_sharded', 'log_evidence', 'tune_ladder']

# chain-state fields exchanged on an accepted swap (position + everything
# cached at that position); adaptation fields stay with the temperature
_SWAP_FIELDS = ('m', 'o', 'loglik', 'prior_m', 'prior_o', 'proj')


class PTConfig(NamedTuple):
    n_rounds: int             # swap rounds
    swap_every: int = 10      # AM steps between swap attempts
    adapt_start: int = 500    # as MCMCConfig
    obs_scale: float = 0.05
    obs_sweeps: int = 1       # as MCMCConfig (ridge-mixing knob)


def geometric_ladder(n_temps, beta_min=0.1):
    """Geometric inverse-temperature ladder from 1.0 down to ``beta_min``."""
    if n_temps < 1:
        raise ValueError('need at least one temperature')
    if n_temps == 1:
        return np.ones(1, np.float32)
    expo = np.arange(n_temps) / (n_temps - 1)
    return np.asarray(beta_min ** expo, np.float32)


def logsumexp(x):
    x = np.asarray(x, np.float64)
    m = np.max(x)
    if not np.isfinite(m):
        return m
    return m + np.log(np.sum(np.exp(x - m)))


def power_ladder(n_temps, power=5.0):
    """Power-law inverse-temperature ladder from 1.0 down to **0.0**.

    ``beta_k = (1 - k/(T-1))^power`` — the standard ladder for marginal-
    likelihood estimation (Xie et al. 2011 recommend power ~3-5): unlike
    ``geometric_ladder`` it reaches the prior (beta = 0), so
    ``log_evidence`` covers the whole [0, 1] path and yields the actual
    model evidence rather than a ratio.  Rungs crowd toward beta = 0,
    where E_beta[loglik] changes fastest.
    """
    if n_temps < 2:
        raise ValueError('an evidence ladder needs at least two rungs')
    frac = 1.0 - np.arange(n_temps) / (n_temps - 1)
    return np.asarray(frac ** power, np.float32)


def log_evidence(betas, logliks, burn=0):
    """Marginal-likelihood estimates from per-replica log-likelihood draws.

    ``betas``: (T,) descending inverse temperatures (as run_pt uses);
    ``logliks``: (T, n_steps) untempered log-likelihood at each replica's
    position per step; ``burn``: steps to drop from the front.

    Returns a dict with two estimators over the ladder span
    [beta_min, 1]:

    * ``'ti'`` — thermodynamic integration (trapezoid over
      ``E_beta[loglik]``), the path-sampling identity
      ``log Z = \\int_0^1 E_beta[loglik] d beta``;
    * ``'ss'`` — stepping-stone (Xie et al. 2011): for each rung,
      ``log r_k = logsumexp((b_hi - b_lo) ll_lo) - log N`` with draws from
      the *colder-in-likelihood* (lower-beta) rung, summed up the ladder —
      unbiased per rung and typically tighter than TI on coarse ladders.

    Both equal ``log Z(posterior) - log Z(beta_min)``; with a ladder that
    reaches beta = 0 (``power_ladder``) that lower state is the prior,
    ``Z(0) = 1``, so the values ARE ``log Z``.  ``'complete'`` in the
    returned dict says whether that holds.  The reference has no evidence
    machinery at all (its only model-comparison number is the MAP AIC,
    Bayes_MAP.py:494-517).

    ``'equilibrated'``: at equilibrium the TI integrand is non-decreasing
    in beta exactly (d/dbeta E_beta[loglik] = Var_beta[loglik] >= 0), so a
    decreasing pair of rung means — beyond Monte-Carlo noise, gauged by the
    rungs' standard errors — is a hard diagnostic that some replica has
    not equilibrated and the estimates are untrustworthy; the offending
    rung indices are in ``'nonmonotone_at'``.
    """
    betas = np.asarray(betas, np.float64)
    ll = np.asarray(logliks, np.float64)[:, burn:]
    if ll.shape[0] != betas.shape[0]:
        raise ValueError('betas/logliks replica-count mismatch')
    if ll.shape[1] < 1:
        raise ValueError('no post-burn draws')
    order = np.argsort(betas)          # ascending for the integration
    b = betas[order]
    ll = ll[order]
    mean_ll = ll.mean(axis=1)
    ti = float(np.trapezoid(mean_ll, b))
    n = ll.shape[1]
    ss = 0.0
    for k in range(len(b) - 1):
        d = b[k + 1] - b[k]
        ss += float(logsumexp(d * ll[k]) - np.log(n))
    # crude per-rung standard error (ignores autocorrelation, so this
    # under-flags rather than over-flags)
    se = ll.std(axis=1) / np.sqrt(n)
    drop = mean_ll[1:] + 3.0 * (se[1:] + se[:-1]) < mean_ll[:-1]
    return {'ti': ti, 'ss': ss,
            'betas': b, 'mean_loglik': mean_ll,
            'equilibrated': bool(not drop.any()),
            'nonmonotone_at': np.flatnonzero(drop),
            'complete': bool(b[0] == 0.0)}


def tune_ladder(betas, swap_rates, kappa=0.5):
    """One Vousden-et-al-style ladder adaptation step toward uniform swap
    acceptance (Vousden, Farr & Mandel 2016, MNRAS 455:1919, eq. 11-12),
    applied on the host between checkpoint chunks during burn-in.

    ``betas``: (T,) descending; endpoints are pinned (beta_0 = 1 and the
    final rung, whether 0 or a geometric beta_min).  ``swap_rates``: (T-1,)
    measured per-adjacent-pair acceptance over the last adaptation window.

    Interior rungs are parameterized by log-beta gaps between *finite*
    rungs; the gap under pair ``j`` is scaled by
    ``exp(kappa * (A_j - mean(A)))`` — a pair accepting more than the
    ladder average gets pulled apart, one accepting less gets pushed
    together, so the fixed point is uniform acceptance across every pair
    (a zero-bottom pair owns no finite gap; its rate steers the others
    through the mean, and at the fixed point it must equal them).  A
    pinned-finite bottom rung is preserved by rescaling the gaps to their
    original total.  Returns the new (T,) ladder.
    """
    betas = np.asarray(betas, np.float64)
    rates = np.asarray(swap_rates, np.float64)
    T = betas.shape[0]
    if T < 3:
        return np.asarray(betas, np.float32)   # nothing interior to move
    if rates.shape[0] != T - 1:
        raise ValueError('need one swap rate per adjacent pair')
    zero_bottom = betas[-1] == 0.0
    fin = betas[:-1] if zero_bottom else betas     # finite rungs
    logb = np.log(fin)
    gaps = -np.diff(logb)                          # (n_fin - 1,) positive
    n_g = gaps.shape[0]
    d = rates[:n_g] - rates.mean()
    gaps = gaps * np.exp(np.clip(kappa * d, -1.0, 1.0))
    if not zero_bottom:
        gaps *= -np.log(betas[-1]) / gaps.sum()    # keep beta_min pinned
    new_logb = np.concatenate([[0.0], -np.cumsum(gaps)])
    new = np.exp(new_logb)
    if zero_bottom:
        new = np.concatenate([new, [0.0]])
    return np.asarray(new, np.float32)


def init_pt_states(setup: BayesSetup, key, n_temps, jitter=0.05):
    """Stacked per-temperature chain states with jittered starts."""
    from ..parallel.chains import init_chains
    return init_chains(setup, key, n_temps, jitter=jitter)


def _advance(setup, state, beta, cfg: PTConfig):
    """``swap_every`` tempered AM steps on one replica."""
    mcfg = MCMCConfig(n_samples=cfg.swap_every, adapt_start=cfg.adapt_start,
                      obs_scale=cfg.obs_scale, obs_sweeps=cfg.obs_sweeps)

    def step(s, _):
        s, sample = mcmc_step(setup, s, mcfg, beta=beta)
        # untempered loglik alongside the position trace: the raw material
        # for log_evidence (TI needs E_beta[loglik] at every rung)
        return s, (sample, s.loglik)

    return lax.scan(step, state, None, length=cfg.swap_every)


def _pairing(rank, parity, T):
    """Even–odd pairing at a swap round: pairs are (p, p+1), (p+2, p+3)...

    Returns (is_left, is_right, pair_id) where ``pair_id`` is the index of
    the pair's *left* member (= the adjacent-pair index for diagnostics).
    """
    off = (rank - parity) % 2
    is_left = (off == 0) & (rank + 1 < T) & (rank >= parity)
    is_right = (off == 1) & (rank - 1 >= parity)
    pair_id = jnp.clip(jnp.where(is_left, rank, rank - 1), 0, max(T - 2, 0))
    return is_left, is_right, pair_id


def _swap_log_alpha(betas, ll_left, ll_right, pair_id, T):
    """Exchange log-acceptance — written once so the stacked and sharded
    paths multiply identical operands in the same order (bitwise-equal
    accept decisions on every member of a pair)."""
    b_l = betas[pair_id]
    b_r = betas[jnp.minimum(pair_id + 1, T - 1)]
    return (b_l - b_r) * (ll_right - ll_left)


def _swap_sweep_stacked(states, betas, key, parity):
    """One even–odd swap sweep on stacked (T, ...) states via gathers."""
    T = betas.shape[0]
    idx = jnp.arange(T)
    is_left, is_right, pair_id = _pairing(idx, parity, T)
    paired = is_left | is_right
    ll = states.loglik
    la = _swap_log_alpha(betas, ll[pair_id],
                         ll[jnp.minimum(pair_id + 1, T - 1)], pair_id, T)
    u = jax.vmap(lambda i: random.uniform(random.fold_in(key, i)))(pair_id)
    accept = paired & (jnp.log(u) < la)
    partner = jnp.clip(jnp.where(is_left, idx + 1, idx - 1), 0, T - 1)
    perm = jnp.where(accept, partner, idx)
    repl = {f: jax.tree.map(lambda x: jnp.take(x, perm, axis=0),
                            getattr(states, f)) for f in _SWAP_FIELDS}
    states = states._replace(**repl)
    acc = jnp.zeros(T - 1).at[pair_id].add(
        jnp.where(is_left & accept, 1.0, 0.0))
    att = jnp.zeros(T - 1).at[pair_id].add(jnp.where(is_left, 1.0, 0.0))
    return states, acc, att


@partial(jax.jit, static_argnames=('setup', 'cfg'))
def run_pt(setup: BayesSetup, states, betas, swap_key, cfg: PTConfig,
           round_offset=0):
    """Parallel tempering as one compiled single-chip program.

    ``states``: stacked ChainState with leading temperature axis matching
    ``betas`` (index 0 must be beta = 1).  Returns
    ``(states, traces (T, n_rounds*swap_every, dim), swap_stats)`` where
    ``traces[0]`` is the posterior (cold) chain and ``swap_stats`` holds
    per-adjacent-pair attempt/accept counts plus the untempered per-replica
    log-likelihood trace (T, n_rounds*swap_every) for ``log_evidence``.

    ``round_offset`` is the global index of this call's first swap round:
    a run driven in checkpointed chunks (run.py ``--sampler pt``) passes
    the rounds already done, so swap parity and swap randomness continue
    exactly as one monolithic call would.
    """
    betas = jnp.asarray(betas, jnp.float32)
    T = betas.shape[0]
    round_offset = jnp.asarray(round_offset, jnp.int32)

    def one_round(carry, r):
        states, att, acc = carry
        rr = round_offset + r
        states, (traces, lls) = lax.map(
            lambda sb: _advance(setup, sb[0], sb[1], cfg), (states, betas))
        if T > 1:
            states, pa, pt_att = _swap_sweep_stacked(
                states, betas, random.fold_in(swap_key, rr), rr % 2)
            att, acc = att + pt_att, acc + pa
        return (states, att, acc), (traces, lls)

    zero = jnp.zeros(max(T - 1, 0))
    (states, att, acc), (traces, lls) = lax.scan(
        one_round, (states, zero, zero), jnp.arange(cfg.n_rounds))
    # (rounds, T, swap_every, dim) -> (T, rounds*swap_every, dim)
    traces = jnp.transpose(traces, (1, 0, 2, 3)).reshape(
        T, cfg.n_rounds * cfg.swap_every, -1)
    lls = jnp.transpose(lls, (1, 0, 2)).reshape(
        T, cfg.n_rounds * cfg.swap_every)
    return states, traces, {'swap_attempts': att, 'swap_accepts': acc,
                            'loglik': lls}


def _swap_step_collective(s, betas, key, parity, rank, T, axis):
    """One swap attempt for this device's replica, neighbors via ppermute."""
    perm_from_next = [(i, i - 1) for i in range(1, T)]
    perm_from_prev = [(i, i + 1) for i in range(T - 1)]
    ll_next = lax.ppermute(s.loglik, axis, perm_from_next)
    ll_prev = lax.ppermute(s.loglik, axis, perm_from_prev)
    is_left, is_right, pair_id = _pairing(rank, parity, T)
    ll_left = jnp.where(is_left, s.loglik, ll_prev)
    ll_right = jnp.where(is_left, ll_next, s.loglik)
    la = _swap_log_alpha(betas, ll_left, ll_right, pair_id, T)
    u = random.uniform(random.fold_in(key, pair_id))
    accept = (is_left | is_right) & (jnp.log(u) < la)

    swap_tree = {f: getattr(s, f) for f in _SWAP_FIELDS}
    from_next = jax.tree.map(
        lambda x: lax.ppermute(x, axis, perm_from_next), swap_tree)
    from_prev = jax.tree.map(
        lambda x: lax.ppermute(x, axis, perm_from_prev), swap_tree)
    take_next = accept & is_left
    take_prev = accept & is_right
    new = jax.tree.map(
        lambda own, nx, pv: jnp.where(take_next, nx,
                                      jnp.where(take_prev, pv, own)),
        swap_tree, from_next, from_prev)
    s = s._replace(**new)
    acc = jnp.where(is_left & accept, 1.0, 0.0)
    att = jnp.where(is_left, 1.0, 0.0)
    return s, acc, att


def run_pt_sharded(setup: BayesSetup, states, betas, swap_key,
                   cfg: PTConfig, mesh, round_offset=0):
    """Parallel tempering with one replica per device over ``mesh``.

    Identical transition/swap randomness to ``run_pt`` (tested equal).
    Cross-device traffic is nearest-neighbor ``ppermute`` only: each swap
    round every device sends its scalar log-likelihood and its full swap
    tree (~20 floats of position + the cached projections) to both ladder
    neighbors unconditionally — under SPMD a collective cannot be made
    acceptance-conditional, so acceptance selects with ``jnp.where``
    afterward.  A few KB per round per link, trivially ICI-friendly.
    """
    betas = jnp.asarray(betas, jnp.float32)
    T = int(betas.shape[0])
    if mesh.devices.size != T:
        raise ValueError('run_pt_sharded wants one temperature per device '
                         '(got {} temps over {} devices)'.format(
                             T, mesh.devices.size))
    f = _sharded_pt_prog(setup, cfg, mesh, T)
    sharding = NamedSharding(mesh, P(mesh.axis_names[0]))
    states = jax.tree.map(lambda x: jax.device_put(x, sharding), states)
    states, traces, lls, att, acc = f(
        states, betas, swap_key, jnp.asarray(round_offset, jnp.int32))
    # per-device counters hold the pair whose LEFT member lives there;
    # device T-1 is never a left, so the first T-1 entries are the ladder
    return states, traces, {'swap_attempts': att[:T - 1],
                            'swap_accepts': acc[:T - 1],
                            'loglik': lls}


@lru_cache(maxsize=None)
def _sharded_pt_prog(setup, cfg: PTConfig, mesh, T):
    """Build + jit the per-device PT program once per (setup, cfg, mesh, T)
    — the CLI drives checkpointed chunks through repeated calls, which must
    hit jit's cache rather than retrace the full forward model each time."""
    from jax import shard_map

    axis = mesh.axis_names[0]

    def device_fn(states1, betas_all, key, off):
        s = jax.tree.map(lambda x: x[0], states1)     # local shard size 1
        rank = lax.axis_index(axis)
        b = betas_all[rank]

        def one_round(carry, r):
            s, att, acc = carry
            rr = off + r
            s, (traces, lls) = _advance(setup, s, b, cfg)
            s, pa, pt_att = _swap_step_collective(
                s, betas_all, random.fold_in(key, rr), rr % 2, rank, T,
                axis)
            return (s, att + pt_att, acc + pa), (traces, lls)

        (s, att, acc), (traces, lls) = lax.scan(
            one_round, (s, jnp.zeros(()), jnp.zeros(())),
            jnp.arange(cfg.n_rounds))
        traces = traces.reshape(cfg.n_rounds * cfg.swap_every, -1)
        lls = lls.reshape(cfg.n_rounds * cfg.swap_every)
        out = jax.tree.map(lambda x: x[None], s)
        return out, traces[None], lls[None], att[None], acc[None]

    return jax.jit(shard_map(
        device_fn, mesh=mesh,
        in_specs=(P(axis), P(), P(), P()),
        out_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
        check_vma=False))
