"""Benchmark harness — prints ONE JSON line within a global wall-clock
budget, measured on a GPU; without one it exits non-zero and prints no
result (a CPU number is never a device metric).

Headline metric (BASELINE.json): full forward simulations per hour on the
reference Bayes workload — Kalbar population model, 801x801 domain at 25 m,
18 wind days x 1440 minute-kernels, release + FFT propagation + observation
projections.  Every MCMC likelihood evaluation runs exactly this program,
so sims/hr bounds achievable samples/hr.

``vs_baseline`` compares against the measured single-stream reference CPU
path (BASELINE_MEASURED.json: per-day prob_mass + per-day conv on this
machine, scaled to 18 days).  The reference publishes no numbers
(BASELINE.md), so the baseline is measured, not copied.

The JSON line also carries ``extra_metrics`` — the inference-layer
north-star numbers:

* ``am_steps_per_hr`` / ``am_ess_per_hr``: adaptive Metropolis at the FULL
  reference MCMC config (801x801 @ 25 m, every step a complete forward
  simulation — the workload of Bayes_Run.py:484-537, whose only perf
  counter is the 'sec./model' print, Bayes_MAP.py:344-346),
* ``nuts_801_transitions_per_hr`` / ``nuts_801_ess_per_hr``: warm-started
  NUTS at the same full config (the production --mass laplace recipe),
* ``nuts_transitions_per_hr_map_domain``: NUTS at the reference MAP domain
  (401x401 @ 50 m, Bayes_MAP.py:95),
* ``forward_tflops``: achieved-FLOPs estimate for the forward simulation
  against the card's f32 peak (``PEAK_F32_TFLOPS``, keyed by
  ``device_kind``; a card missing from the table is an error).

**Budget discipline.**  ONE global wall-clock budget
(``PARA_BENCH_BUDGET_S``, default 1500 s) is shared by all children: the
headline runs first with most of the budget available, each extra only
dispatches if the remaining budget covers its estimated need (otherwise
it reports ``"skipped_for_budget"``).  Each measurement runs in its own
child process, one after another, so one JAX process holds the card at a
time and the parent never touches it.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

_T0 = time.time()
_BUDGET_S = float(os.environ.get('PARA_BENCH_BUDGET_S', 1500))


def _remaining():
    return _BUDGET_S - (time.time() - _T0)


# f32 peak outside the tensor cores, dense, at the card's full power limit
# (NVIDIA H100 data sheet, SXM part): the forward runs f32 elementwise,
# transcendental and FFT work, none of it on the tensor cores
PEAK_F32_TFLOPS = {'NVIDIA H100 80GB HBM3': 67.0}


def peak_f32_tflops(device_kind):
    """The card's f32 peak; an unknown card is an error, not a default."""
    try:
        return PEAK_F32_TFLOPS[device_kind]
    except KeyError:
        raise KeyError('no f32 peak on record for {!r}; add it to '
                       'PEAK_F32_TFLOPS with its source'.format(device_kind))


def require_gpu():
    """The first JAX device; exits (code 3) unless it is a GPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        sys.stderr.write('bench.py measures a GPU; JAX found {}\n'.format(
            dev.platform))
        sys.exit(3)
    return dev


def estimate_forward_flops(p, kcfg, scfg, ndays):
    """Analytic FLOP estimate for ONE full forward simulation (documented
    model, good to ~2x):

    * kernel construction: T = 48*interp_num minute steps/day; each builds
      a (2K+2)^2 corner-CDF grid with G_rho-node quadrature (~12 flops per
      exp-node: ops/bvn.py cost note) plus the (2K+1)^2 scatter-add, and
      the local-diffusion kernel once per day;
    * propagation: per day one rfft2 + pointwise complex multiply + irfft2
      on the P^2 padded grid (5 N log2 N real-FFT flops each way).
    """
    T = 48 * int(p.interp_num)
    K, Kl, G = int(kcfg.K), int(kcfg.K_local), int(kcfg.G)
    per_min = (2 * K + 2) ** 2 * G * 12.0 + (2 * K + 1) ** 2
    per_day_kernel = T * per_min + (2 * Kl + 2) ** 2 * G * 12.0
    P = int(scfg.fft_len)
    N = float(P * P)
    fft = 2.5 * N * np.log2(N)          # one real-input 2-D FFT
    per_day_prop = 2 * fft + 8 * N      # fwd+inv FFT + complex multiply
    return ndays * (per_day_kernel + per_day_prop)


def measure(n_iters=20):
    import jax
    import jax.numpy as jnp
    from parasitoids_tpu.config import Params
    from parasitoids_tpu.models.forward import forward_fields, setup_forward
    from parasitoids_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    p = Params()
    p.cmd_line_chg(['--kalbar'])
    p.PLOT = False
    p.OUTPUT = False
    p.PROB_MODEL = False
    # prior-coverage kernel windows — the widths the MCMC likelihood must
    # use (sigma varies per proposal; see bayes/model.py), so the benchmark
    # measures the true per-likelihood-evaluation cost
    from parasitoids_tpu.bayes.model import prior_coverage_windows
    cell = p.domain_info[0] / p.domain_info[1]
    p.kernel_rad, p.kernel_rad_local = prior_coverage_windows(cell)
    s = setup_forward(p)
    hparams = tuple(np.float32(v)
                    for v in (p.lam, *p.g_params, *p.f_params))
    w = jnp.asarray(s.dist_weights, jnp.float32)

    def run(mu_r):
        fields = forward_fields(
            s.wind_flat, s.wind_cumsum, hparams, p.Dparams, p.Dlparams,
            mu_r, jnp.int32(p.n_periods), s.rad_dist, jnp.int32(0),
            float(p.r_number), w, s.kcfg, s.scfg, s.ndays, int(p.r_dur),
            False)
        return fields[-1].sum()

    # chain each sim's input on the previous result so the device must
    # execute the sims strictly sequentially, and keep the WHOLE chain in
    # one device program (lax.scan): this is exactly how the MCMC layer
    # consumes forward sims, and it keeps per-iteration host<->device
    # round-trips out of the measurement
    from jax import lax

    @jax.jit
    def chained(mu0):
        def step(mu, _):
            out = run(mu)
            return jnp.float32(1.179) + out * jnp.float32(1e-12), out
        acc, outs = lax.scan(step, mu0, None, length=n_iters)
        return acc + outs.sum() * jnp.float32(1e-12)

    # warm-up / compile (the transfer to the host forces completion)
    float(chained(jnp.float32(1.179)))
    t0 = time.time()
    v = float(chained(jnp.float32(1.179)))
    assert np.isfinite(v)
    dt = (time.time() - t0) / n_iters
    flops = estimate_forward_flops(p, s.kcfg, s.scfg, s.ndays)
    return dt, s.ndays, flops


def measure_am(n_steps=2400, chunk=300):
    """Adaptive-Metropolis steps/hr AND ESS/hr at the full reference MCMC
    config, timed over ``n_steps`` transitions dispatched in ``chunk``-step
    programs (one warm chunk first, untimed, absorbing the compile).  The
    timed trace also yields min/median effective-sample-size rates over
    the 25 sampled parameters — steps/hr alone is information-free when
    the ridge parameters mix slowly."""
    import jax
    from parasitoids_tpu.bayes.diagnostics import effective_sample_size
    from parasitoids_tpu.bayes.model import BayesSetup
    from parasitoids_tpu.bayes.sampler import (MCMCConfig, init_chain_state,
                                               run_mcmc)
    from parasitoids_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    setup = BayesSetup()                      # Bayes_Run config: 801x801
    state = init_chain_state(setup, jax.random.PRNGKey(0))
    cfg = MCMCConfig(n_samples=chunk)
    run = jax.jit(lambda s: run_mcmc(setup, s, cfg))
    state, trace = jax.block_until_ready(run(state))   # compile, untimed
    assert np.isfinite(float(np.asarray(trace)[-1, -1]))
    t0 = time.time()
    parts = []
    for _ in range(max(1, n_steps // chunk)):
        state, trace = jax.block_until_ready(run(state))
        parts.append(np.asarray(trace))
    dt = time.time() - t0
    n_done = sum(p.shape[0] for p in parts)
    tr = np.concatenate(parts)[:, :25]        # drop trailing logpost col
    assert np.isfinite(tr).all()
    ess = np.array([effective_sample_size(tr[:, j]) for j in range(25)])
    return {'s_per_step': dt / n_done,
            'min_ess_per_hr': float(ess.min() * 3600.0 / dt),
            'median_ess_per_hr': float(np.median(ess) * 3600.0 / dt)}


def measure_nuts(n_draws=24, n_warmup=32, steps_per_call=4):
    """NUTS transitions/hr at the reference MAP domain (401x401 @ 50 m,
    Bayes_MAP.py:95).  Warmup (adaptation + compile) is untimed; the rate
    comes from the per-chunk progress timestamps of the sampling phase,
    skipping the first chunk (which may include the draw-program compile)."""
    import jax
    import jax.numpy as jnp
    from jax import random
    from parasitoids_tpu.bayes.model import BayesSetup
    from parasitoids_tpu.bayes.nuts import (NUTSConfig,
                                            make_transformed_logpdf,
                                            nuts_sample_stepwise)
    from parasitoids_tpu.config import Params
    from parasitoids_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    p = Params()
    p.cmd_line_chg(['--kalbar'])
    p.PLOT = False
    p.OUTPUT = False
    p.PROB_MODEL = False
    p.domain_info = (10000.0, 200)            # Bayes_MAP.py:95
    setup = BayesSetup(p)
    logpdf, _, z0 = make_transformed_logpdf(setup)
    cfg = NUTSConfig(num_warmup=n_warmup, num_samples=n_draws, max_depth=6)
    stamps = []

    def progress(phase, i, total):
        if phase == 'sample':
            stamps.append((i, time.time()))

    out = nuts_sample_stepwise(
        logpdf, z0[None], random.split(random.PRNGKey(0), 1), cfg,
        progress=progress, steps_per_call=steps_per_call)
    assert np.isfinite(np.asarray(out['logp'])).all()
    if len(stamps) < 2:
        raise RuntimeError('not enough timing chunks')
    (i0, t0), (i1, t1) = stamps[0], stamps[-1]
    return (t1 - t0) / (i1 - i0)              # s per transition


def measure_nuts_801(n_draws=None, n_warmup=16, map_steps=None,
                     steps_per_call=4):
    if n_draws is None:
        n_draws = int(os.environ.get('PARA_N801_DRAWS', 48))
    if map_steps is None:
        map_steps = int(os.environ.get('PARA_N801_MAP_STEPS', 150))
    return _measure_nuts_801(n_draws, n_warmup, map_steps, steps_per_call)


def _measure_nuts_801(n_draws, n_warmup, map_steps, steps_per_call):
    """NUTS at the FULL 801x801 Bayes config with the Laplace warm start
    (bayes/run.py --mass laplace): MAP fit -> fixed dense Hessian metric ->
    step-size-only warmup -> ``n_draws`` transitions.  Reports both the
    transition rate (sampling phase only, untimed warmup/MAP) and min/
    median ESS/hr over the 25 sampled parameters."""
    import jax.numpy as jnp
    from jax import random
    from parasitoids_tpu.bayes.diagnostics import effective_sample_size
    from parasitoids_tpu.bayes.map_fit import laplace_warm_mass
    from parasitoids_tpu.bayes.model import BayesSetup
    from parasitoids_tpu.bayes.nuts import (NUTSConfig,
                                            make_transformed_logpdf,
                                            nuts_sample_stepwise)
    from parasitoids_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    setup = BayesSetup()                      # Bayes_Run config: 801x801
    logpdf, _, _ = make_transformed_logpdf(setup)
    # the production --mass laplace recipe (bayes/run.py), shared helper
    fit, inv0 = laplace_warm_mass(setup, n_steps=map_steps)
    cfg = NUTSConfig(num_warmup=n_warmup, num_samples=n_draws, max_depth=6,
                     dense_mass=True, fixed_mass=True)
    stamps = []

    def progress(phase, i, total):
        if phase == 'sample':
            stamps.append((i, time.time()))

    out = nuts_sample_stepwise(
        logpdf, jnp.asarray(fit['z'], jnp.float32)[None],
        random.split(random.PRNGKey(0), 1), cfg, progress=progress,
        steps_per_call=steps_per_call, init_inv_mass=inv0[None])
    assert np.isfinite(np.asarray(out['logp'])).all()
    if len(stamps) < 2:
        raise RuntimeError('not enough timing chunks')
    (i0, t0), (i1, t1) = stamps[0], stamps[-1]
    spt = (t1 - t0) / (i1 - i0)
    z = np.asarray(out['samples'])[0]          # (draws, dim) z-space
    ess = np.array([effective_sample_size(z[:, j])
                    for j in range(z.shape[1])])
    return {'s_per_transition': spt,
            'min_ess_per_hr': float(ess.min() * 3600.0 / (spt * n_draws)),
            'median_ess_per_hr': float(np.median(ess) * 3600.0
                                       / (spt * n_draws))}


def _child_subprocess(mode, timeout_s, env_extra=None):
    """Run one measurement in a bounded child process (one JAX process on
    the card at a time).  Returns the child's JSON dict, or a short
    ``'failed(...)'`` string for the record — a failure reason is a
    visible record, a bare null is silence.  Never raises."""
    if timeout_s <= 0:
        return 'failed(no budget)'
    env = dict(os.environ)
    env.update(env_extra or {})
    try:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), mode],
                           timeout=timeout_s, capture_output=True,
                           text=True, env=env)
    except subprocess.TimeoutExpired:
        return 'failed(timeout {}s)'.format(int(timeout_s))
    except (subprocess.SubprocessError, OSError) as e:
        return 'failed({})'.format(type(e).__name__)
    if r.returncode != 0:
        tail = (r.stderr or r.stdout or '').strip().splitlines()
        tail = tail[-1][-160:] if tail else ''
        return 'failed(rc={}: {})'.format(r.returncode, tail)
    try:
        return json.loads(r.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return 'failed(unparseable child output)'


def _child_forward():
    import jax
    dev = jax.devices()
    dt, ndays, flops = measure(20)
    return {'dt': dt, 'ndays': ndays, 'flops': flops,
            'device': {'platform': dev[0].platform,
                       'kind': dev[0].device_kind, 'count': len(dev)}}


_CHILDREN = {
    '--child-forward': _child_forward,
    '--child-am': measure_am,
    '--child-nuts': lambda: {'s_per_transition': measure_nuts()},
    '--child-nuts801': measure_nuts_801,
}


def main():
    for flag, fn in _CHILDREN.items():
        if flag in sys.argv:
            require_gpu()
            print(json.dumps(fn()))
            return

    # ------------------------------------------------------------------
    # headline (gets the whole budget minus a 60 s reserve for the
    # extras bookkeeping + final print); it also decides that there is a
    # GPU: without one, the child exits and so does the bench
    res = _child_subprocess('--child-forward',
                            min(0.6 * _BUDGET_S, _remaining() - 60))
    if not isinstance(res, dict):
        sys.stderr.write('bench.py: forward measurement {}\n'.format(res))
        sys.exit(1)
    device = res['device']

    vs_baseline = None
    ref_total = None
    base_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             'BASELINE_MEASURED.json')
    if os.path.exists(base_path):
        with open(base_path) as f:
            base = json.load(f)
        ref_total = (base['per_day_prob_mass_s'] +
                     base['conv_per_day_s']) * base['ndays']

    extras = {}
    dt, ndays, flops = float(res['dt']), int(res['ndays']), res.get('flops')
    sims_per_hr = 3600.0 / dt
    sim_days_per_sec = ndays / dt
    if ref_total:
        vs_baseline = ref_total / dt
    if flops:
        tflops = flops / dt / 1e12
        peak = peak_f32_tflops(device['kind'])
        extras['forward_tflops'] = {
            'value': round(tflops, 3),
            'unit': 'achieved TFLOP/s, forward sim (analytic FLOP model, '
                    '~2x), {:.2f}% of the {} TF/s f32 peak'.format(
                        100.0 * tflops / peak, peak),
            'vs_baseline': None}

    # ------------------------------------------------------------------
    # inference-layer extras (each step is a full forward sim).  Dispatch
    # order: AM ESS/hr, then 801^2 NUTS ESS/hr, then the MAP-domain NUTS
    # rate.  Each extra runs only if the remaining budget covers its
    # floor (warm-cache estimate + margin); otherwise it reports
    # 'skipped_for_budget' — a skipped number is a visible record, a
    # timeout is silence.
    skipped = 'skipped_for_budget'
    if _remaining() > 420:
        am = _child_subprocess('--child-am', _remaining() - 60)
    else:
        am = skipped
    if isinstance(am, dict):
        sps = am['s_per_step']
        extras['am_steps_per_hr'] = {
            'value': round(3600.0 / sps, 1),
            'unit': 'AM MCMC steps/hr, full 801x801 Bayes config',
            # reference AM step = one full forward sim, single stream
            'vs_baseline': (round((3600.0 / sps) / (3600.0 / ref_total),
                                  1) if ref_total else None)}
        extras['am_ess_per_hr'] = {
            'value': round(am['min_ess_per_hr'], 1),
            'unit': 'min ESS/hr over 25 params (median {:.0f}), '
                    '2400-step AM chain, 801x801'.format(
                        am['median_ess_per_hr']),
            'vs_baseline': None}   # reference records no ESS anywhere
    else:
        extras['am_steps_per_hr'] = am
        extras['am_ess_per_hr'] = am

    # 801^2 warm NUTS: MAP fit + metric + draws; shrink the draw count to
    # fit the remaining budget
    rem = _remaining()
    if rem > 480:
        n_draws = int(max(16, min(48, (rem - 360) / 4.0)))
        n801 = _child_subprocess(
            '--child-nuts801', _remaining() - 45,
            env_extra={'PARA_N801_DRAWS': str(n_draws)})
    else:
        n801, n_draws = skipped, 0
    if isinstance(n801, dict):
        spt = n801['s_per_transition']
        extras['nuts_801_transitions_per_hr'] = {
            'value': round(3600.0 / spt, 1),
            'unit': 'NUTS transitions/hr, full 801x801 config, '
                    'Laplace warm start (fixed dense metric)',
            'vs_baseline': None}
        extras['nuts_801_ess_per_hr'] = {
            'value': round(n801['min_ess_per_hr'], 1),
            'unit': 'min ESS/hr over params (median {:.0f}), {}-draw '
                    'warm-started NUTS, 801x801'.format(
                        n801['median_ess_per_hr'], n_draws),
            'vs_baseline': None}
    else:
        extras['nuts_801_transitions_per_hr'] = n801
        extras['nuts_801_ess_per_hr'] = n801

    if _remaining() > 420:
        nuts = _child_subprocess('--child-nuts', _remaining() - 30)
    else:
        nuts = skipped
    if isinstance(nuts, dict):
        spt = nuts['s_per_transition']
        extras['nuts_transitions_per_hr_map_domain'] = {
            'value': round(3600.0 / spt, 1),
            'unit': 'NUTS transitions/hr, 401x401 MAP domain, depth 6',
            'vs_baseline': None}   # the reference has no NUTS at all
    else:
        extras['nuts_transitions_per_hr_map_domain'] = nuts

    print(json.dumps({
        'metric': 'kalbar_full_forward_sims_per_hr',
        'value': round(sims_per_hr, 1),
        'unit': 'sims/hr on {} x{} (801x801, 18 days; sim-days/s={:.1f}; '
                'budget {:.0f}s, used {:.0f}s)'.format(
                    device['kind'], device['count'], sim_days_per_sec,
                    _BUDGET_S, time.time() - _T0),
        'vs_baseline': round(vs_baseline, 1) if vs_baseline else None,
        'device': device,
        'extra_metrics': extras,
    }))


if __name__ == '__main__':
    main()
