#!/usr/bin/env python3
"""Smoke test of the system's main path on NVIDIA GPUs, in one process.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the multi-card paths only

One card, at the full Kalbar configuration (801x801 cells of 25 m, 18 wind
days of 1,440 flight minutes, a 130,000-wasp release):

1. forward: ``cli.main(['--pop', '--no_plot', '--no_output'])``, checked
   against the population model's mass invariants;
2. the Bayes forward at the prior-coverage kernel windows (K=44), with
   ``compiled.memory_analysis()`` of that program;
3. log-posterior value and gradient of ``BayesSetup()``;
4. a few adaptive-Metropolis steps and a few NUTS transitions through
   ``bayes.run.main(argv)``, into ``output/chip_smoke/``;
5. the f32 results of 1 and 3 against the f64 XLA path (``use_f64=True``).

Four cards: 4 AM chains sharded over the cards (``parallel/chains.py``)
against the same chains and keys on one card, and the minute-sharded
log-posterior value and gradient (``parallel/domain.py``) against one card.

Every timed phase runs once untimed first (compilation), then once timed.
A failed phase raises; a failed comparison is reported and the script
exits 1 after the last phase.  Only a run in which everything passed
prints the final JSON line.  There is no CPU mode: without a GPU the
script exits before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from parasitoids_tpu import cli  # noqa: E402
from parasitoids_tpu.bayes import run as bayes_run  # noqa: E402
from parasitoids_tpu.bayes.model import prior_coverage_windows  # noqa: E402
from parasitoids_tpu.bayes.nuts import make_transformed_logpdf  # noqa: E402
from parasitoids_tpu.config import Params  # noqa: E402
from parasitoids_tpu.models.forward import (forward_fields,  # noqa: E402
                                            setup_forward)

FORWARD_ARGV = ['--pop', '--no_plot', '--no_output']
OUT_DIR = os.path.join('output', 'chip_smoke')
# a posterior draw of the default (Poisson, 801x801) Kalbar model, in the
# unconstrained z-space of make_transformed_logpdf: the log-posterior is
# compared here as well as at the prior point (the NUTS --init prior start)
POSTERIOR_DRAW = os.path.join('runs', 'nuts_r4.npz')

# --- tolerances, each with its reason ------------------------------------
# forward fields, f32 GPU vs f64: per-cell f32 rounding of the daily
# kernels (~1e-7 of a cell's mass) and of the 2-D FFTs (~1e-7 of the
# field's peak per transform, 18 chained days), plus GPU scatter-add
# atomics that sum the 1,440 minute blocks in a run-dependent order.
# Measured on an H100 (700 W): rel L1 1.3e-5, max/peak 1.0e-5 (worst day).
TOL_FIELD_REL_L1 = 1e-4      # sum|f32 - f64| / sum|f64|, each day
TOL_FIELD_MAX_PEAK = 1e-4    # max|f32 - f64| / max|f64|, each day
# population mass invariants (the reference's lost-wasp accounting):
# day 1 holds the release up to what the first day advects off the domain;
# by day 18 the Kalbar run has lost ~2.8% off the 10 km domain
TOL_DAY1_MASS = 1e-2          # |sum(day 1) / r_number - 1|
LOSS_DAY18 = (0.01, 0.05)     # 1 - sum(day 18) / r_number
TOL_MONOTONE = 1e-5           # relative growth allowed between days
# log-posterior and its gradient, f32 GPU vs f64: the fields' relative
# error carried through 505 observation terms.  Measured on an H100
# (700 W), prior / posterior draw: value 4.6e-6 / 4.8e-7, gradient
# 1.9e-4 / 2.4e-5.  The bounds sit ~20x above that, so the run-to-run
# order of the atomics cannot trip them, and below the ~1e-3 that a
# wrong kernel block or an f32 product run in TF32 would give.
TOL_LOGP_REL = {'prior': 1e-4, 'posterior': 1e-5}
TOL_GRAD_REL = {'prior': 5e-3, 'posterior': 1e-3}   # |g32 - g64| / |g64|
# multi-card against one card: same f32 program, only the order of the
# sums differs (psum of partial buffers, atomics), so the bounds are those
# of f32 reordering, not of f32 against f64.  Measured on four H100s
# (400 W): parameter columns identical, log-posterior column 1.0e-5,
# minute-sharded value 3.9e-6 and gradient 8.6e-5.
TOL_SHARD_PARAM = 1e-5        # AM parameter columns (same proposals)
TOL_SHARD_LOGP = 1e-4         # AM log-posterior column, relative
TOL_SHARD_VALUE = 1e-4        # minute-sharded log-posterior, relative
TOL_SHARD_GRAD = 2e-3         # minute-sharded gradient, relative norm


def require_gpu():
    """The devices JAX found; exits unless the first one is a GPU."""
    devices = jax.devices()
    if devices[0].platform != 'gpu':
        raise SystemExit('chip_smoke.py needs a GPU; JAX found {}'.format(
            devices[0].platform))
    return devices


def card_line():
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def result_line(devices):
    """The final line: the device as JAX reports it."""
    return json.dumps({'ok': True, 'device': {
        'platform': devices[0].platform, 'kind': devices[0].device_kind,
        'count': len(devices)}})


class Checks:
    """Comparisons against their limits; the run fails if any fails."""

    def __init__(self):
        self.failed = []

    def le(self, name, value, limit):
        ok = bool(np.isfinite(value)) and value <= limit
        print('  {}: {:.3e} (limit {:.1e}) {}'.format(
            name, value, limit, 'ok' if ok else 'FAIL'), flush=True)
        if not ok:
            self.failed.append(name)

    def true(self, name, ok, detail=''):
        print('  {}: {} {}'.format(name, detail, 'ok' if ok else 'FAIL'),
              flush=True)
        if not ok:
            self.failed.append(name)


def timed(label, fn):
    """Run ``fn`` once to compile, then once timed; returns the second
    result.  Results are made ready on the device inside the timing."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    dt = time.perf_counter() - t0
    print('time {}: {:.4f} s steady state (first call, with compilation: '
          '{:.2f} s)'.format(label, dt, t_first), flush=True)
    return out


def rel(a, b):
    return float(np.linalg.norm(np.ravel(a - b))
                 / max(np.linalg.norm(np.ravel(b)), 1e-300))


def bayes_params(overrides=()):
    """Params of the Bayes forward: Kalbar population model, prior-
    coverage kernel windows (bayes/model.py), CLI-style overrides."""
    p = Params()
    p.cmd_line_chg(FORWARD_ARGV + list(overrides))
    cell = p.domain_info[0] / p.domain_info[1]
    p.kernel_rad, p.kernel_rad_local = prior_coverage_windows(cell)
    return p


def header(devices):
    print('card: {}'.format(card_line()))
    print('devices: {} x {}'.format(len(devices), devices[0].device_kind))
    print('jax {}'.format(jax.__version__))
    print('XLA_FLAGS={}'.format(os.environ.get('XLA_FLAGS', '')), flush=True)


def forward_invariants(checks, fields, p):
    s = setup_forward(p)
    shape = (s.ndays, s.scfg.dom_len, s.scfg.dom_len)
    r_number = float(p.r_number)
    sums = np.asarray(fields, np.float64).sum(axis=(1, 2))
    print('forward day sums: {}'.format(
        ' '.join('{:.1f}'.format(s) for s in sums)))
    checks.true('forward shape', fields.shape == shape, str(fields.shape))
    checks.true('forward finite', bool(np.isfinite(fields).all()))
    checks.le('day-1 mass vs r_number', abs(sums[0] / r_number - 1),
              TOL_DAY1_MASS)
    loss = 1 - sums[-1] / r_number
    checks.true('last-day loss', LOSS_DAY18[0] <= loss <= LOSS_DAY18[1],
                '{:.4f} in [{}, {}]'.format(loss, *LOSS_DAY18))
    growth = float(np.max(sums[1:] / sums[:-1] - 1, initial=0.0))
    checks.le('day-to-day mass growth', growth, TOL_MONOTONE)


def bayes_forward_phase(overrides):
    """The Bayes forward at K=44 as one program; prints its memory."""
    p = bayes_params(overrides)
    s = setup_forward(p)
    hparams = tuple(np.float32(v) for v in (p.lam, *p.g_params,
                                            *p.f_params))
    w = jnp.asarray(s.dist_weights, jnp.float32)

    @jax.jit
    def fwd(mu_r):
        return forward_fields(
            s.wind_flat, s.wind_cumsum, hparams, p.Dparams, p.Dlparams,
            mu_r, jnp.int32(p.n_periods), s.rad_dist, jnp.int32(0),
            float(p.r_number), w, s.kcfg, s.scfg, s.ndays, int(p.r_dur),
            False)

    mu_r = jnp.float32(p.mu_r)
    print('bayes forward: K={}, K_local={}, fft_len={}'.format(
        s.kcfg.K, s.kcfg.K_local, s.scfg.fft_len))
    print('bayes forward memory_analysis: {}'.format(
        fwd.lower(mu_r).compile().memory_analysis()), flush=True)
    fields = timed('bayes_forward_k{}'.format(s.kcfg.K), lambda: fwd(mu_r))
    return np.asarray(fields), p


def posterior_draw(dim):
    """The stored posterior draw at which the log-posterior is compared."""
    z_post = np.load(POSTERIOR_DRAW)['z_samples'][0, -1]
    if z_post.shape != (dim,):
        raise SystemExit('{} holds {}-dim draws; the model has {}'.format(
            POSTERIOR_DRAW, z_post.shape[0], dim))
    return z_post


def pointwise_loglik(setup, z):
    """Per-observation log-likelihood terms at z (bayes/model.py)."""
    from parasitoids_tpu.bayes.sampler import _as_model, _as_obs
    _, constrain, _ = make_transformed_logpdf(setup)
    m, o, _ = constrain(jnp.asarray(z, setup.setup.wind_flat.dtype))
    proj = setup.forward_projections(_as_model(m))
    return np.asarray(setup.pointwise_loglik(proj, _as_obs(o, setup.n_sent)),
                      np.float64)


def logpost_values(setup, z0, z_post, label):
    logpdf, _, _ = make_transformed_logpdf(setup)
    vg = jax.jit(jax.value_and_grad(logpdf))
    dtype = setup.setup.wind_flat.dtype
    out = {}
    for name, z in (('prior', z0), ('posterior', z_post)):
        z = jnp.asarray(z, dtype)
        v, g = (timed('{}_{}'.format(label, name), lambda: vg(z))
                if name == 'prior' else vg(z))
        print('{} logpost at {}: {:.6f}'.format(label, name, float(v)))
        out[name] = (float(v), np.asarray(g, np.float64),
                     pointwise_loglik(setup, z))
    return out


def sampler_phases(checks, overrides):
    os.makedirs(OUT_DIR, exist_ok=True)
    am_db = os.path.join(OUT_DIR, 'am')
    timed('am_4_steps', lambda: bayes_run.main(
        ['--new', '4', '0', am_db] + list(overrides)))
    with np.load(am_db + '.npz') as d:
        tr = d['traces']
    checks.true('AM traces', tr.shape[:2] == (1, 4)
                and bool(np.isfinite(tr).all()), str(tr.shape))

    nuts_db = os.path.join(OUT_DIR, 'nuts')
    timed('nuts_2_draws_10_warmup', lambda: bayes_run.main(
        ['--sampler', 'nuts', '--init', 'prior', '--max-depth', '3',
         '--new', '2', '10', nuts_db] + list(overrides)))
    with np.load(nuts_db + '.npz') as d:
        tr = d['traces']
    checks.true('NUTS traces', tr.shape[:2] == (1, 2)
                and bool(np.isfinite(tr).all()), str(tr.shape))


def run_one_card(overrides=()):
    """Every one-card phase; ``overrides`` are Params key=value pairs
    applied to all of them (empty: the full configuration)."""
    checks = Checks()
    overrides = list(overrides)

    print('== forward through cli.main', flush=True)
    fields32, _ = timed('forward_cli', lambda: cli.main(
        argv=FORWARD_ARGV + overrides))
    fields32 = np.asarray(fields32)
    p = Params()
    p.cmd_line_chg(FORWARD_ARGV + overrides)
    forward_invariants(checks, fields32, p)

    print('== Bayes forward at the prior-coverage windows', flush=True)
    bfields, bp = bayes_forward_phase(overrides)
    forward_invariants(checks, bfields, bp)

    print('== log-posterior value and gradient (f32)', flush=True)
    setup32 = bayes_run.build_setup(overrides)
    _, _, z0 = make_transformed_logpdf(setup32)
    z0 = np.asarray(z0)
    z_post = posterior_draw(z0.shape[0])
    lp32 = logpost_values(setup32, z0, z_post, 'f32')
    for name, (v, g, _) in lp32.items():
        checks.true('f32 logpost finite at ' + name,
                    bool(np.isfinite(v) and np.isfinite(g).all()))

    print('== samplers through bayes.run.main', flush=True)
    sampler_phases(checks, overrides)

    # f64 last: use_f64 switches JAX to 64-bit for the rest of the process
    print('== f32 against the f64 XLA path', flush=True)
    fields64, _ = cli.main(argv=FORWARD_ARGV + overrides + ['use_f64=True'])
    fields64 = np.asarray(fields64)
    diff = np.abs(fields32.astype(np.float64) - fields64)
    ref = np.abs(fields64)
    worst_l1 = float(np.max(diff.sum(axis=(1, 2)) / ref.sum(axis=(1, 2))))
    worst_peak = float(np.max(diff.max(axis=(1, 2)) / ref.max(axis=(1, 2))))
    print('forward f32 vs f64: worst max abs diff {:.4e} wasps'.format(
        float(diff.max())))
    checks.le('forward rel L1 (worst day)', worst_l1, TOL_FIELD_REL_L1)
    checks.le('forward max diff / peak (worst day)', worst_peak,
              TOL_FIELD_MAX_PEAK)

    setup64 = bayes_run.build_setup(overrides + ['use_f64=True'])
    lp64 = logpost_values(setup64, z0, z_post, 'f64')
    for name in ('prior', 'posterior'):
        (v32, g32, pw32), (v64, g64, pw64) = lp32[name], lp64[name]
        d = pw32 - pw64
        big = np.abs(d) > 0.01
        print('pointwise loglik at {}: {} terms, {} differ by > 0.01 nat '
              '(sum {:.4f}), max |diff| of the rest {:.3e}'.format(
                  name, d.size, int(big.sum()), float(d[big].sum()),
                  float(np.abs(d[~big]).max(initial=0.0))))
        checks.le('logpost rel diff at ' + name,
                  abs(v32 - v64) / abs(v64), TOL_LOGP_REL[name])
        checks.le('gradient rel diff at ' + name, rel(g32, g64),
                  TOL_GRAD_REL[name])
    return checks


def run_four_cards(overrides=(), n_devices=4):
    """The multi-card paths, each against the same work on one card."""
    from jax import random

    from parasitoids_tpu.bayes.sampler import MCMCConfig
    from parasitoids_tpu.parallel.chains import (chain_mesh, init_chains,
                                                 run_chains)
    from parasitoids_tpu.parallel.domain import minute_mesh

    checks = Checks()
    devices = jax.devices()[:n_devices]
    if len(devices) != n_devices:
        raise SystemExit('--four-cards needs {} devices, JAX found {}'
                         .format(n_devices, len(devices)))
    setup = bayes_run.build_setup(list(overrides))

    print('== {} AM chains: sharded over {} cards vs one card'.format(
        n_devices, n_devices), flush=True)
    states = init_chains(setup, random.PRNGKey(0), n_devices)
    cfg = MCMCConfig(n_samples=3)
    mesh = chain_mesh(devices=devices)
    _, tr_shard = timed('am_chains_sharded', lambda: run_chains(
        setup, states, cfg, mesh=mesh))
    _, tr_one = timed('am_chains_one_card', lambda: run_chains(
        setup, states, cfg))
    tr_shard, tr_one = np.asarray(tr_shard), np.asarray(tr_one)
    checks.true('AM traces finite', bool(np.isfinite(tr_shard).all()
                                         and np.isfinite(tr_one).all()))
    checks.le('AM parameter columns, max rel diff',
              float(np.max(np.abs(tr_shard[..., :-1] - tr_one[..., :-1])
                           / (np.abs(tr_one[..., :-1]) + 1e-12))),
              TOL_SHARD_PARAM)
    checks.le('AM log-posterior column, max rel diff',
              float(np.max(np.abs(tr_shard[..., -1] - tr_one[..., -1])
                           / np.abs(tr_one[..., -1]))), TOL_SHARD_LOGP)

    print('== minute-sharded value and gradient vs one card', flush=True)
    logpdf, _, z0 = make_transformed_logpdf(setup)
    sharded = setup.with_forward_mesh(minute_mesh(devices=devices))
    logpdf_s, _, _ = make_transformed_logpdf(sharded)
    vg_one = jax.jit(jax.value_and_grad(logpdf))
    vg_sharded = jax.jit(jax.value_and_grad(logpdf_s))
    v1, g1 = timed('fwd_grad_one_card', lambda: vg_one(z0))
    vs, gs = timed('fwd_grad_minute_sharded', lambda: vg_sharded(z0))
    checks.le('minute-sharded value rel diff',
              abs(float(vs) - float(v1)) / abs(float(v1)), TOL_SHARD_VALUE)
    checks.le('minute-sharded gradient rel diff',
              rel(np.asarray(gs, np.float64), np.asarray(g1, np.float64)),
              TOL_SHARD_GRAD)
    return checks, devices


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--four-cards', action='store_true',
                    help='run only the four-card paths and their one-card '
                         'comparisons')
    args = ap.parse_args(argv)
    os.chdir(REPO)     # data files are addressed repo-relative
    devices = require_gpu()
    header(devices)
    t0 = time.perf_counter()
    if args.four_cards:
        checks, devices = run_four_cards()
    else:
        checks = run_one_card()
        devices = devices[:1]
    print('total wall time: {:.1f} s'.format(time.perf_counter() - t0))
    if checks.failed:
        print('FAILED: {}'.format(', '.join(checks.failed)), flush=True)
        return 1
    print(result_line(devices), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
