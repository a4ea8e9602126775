"""What the program does about the machine it runs on: the compilation
cache's directory, ``chip_smoke.py``'s refusal to run without a GPU and
its result line, and full-f32 matrix products in the samplers (a GPU may
otherwise run an f32 product in TF32)."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- compilation cache -----------------------------------------------------

@pytest.mark.parametrize('env_dir', [None, 'elsewhere'])
def test_compilation_cache_directory(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR when set, else the checkout's fixed
    .jax_cache/ — never a machine-dependent path."""
    from parasitoids_tpu.utils import cache

    if env_dir is None:
        monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
        want = os.path.join(REPO, '.jax_cache')
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', want)
    assert cache.cache_dir() == want

    # on the CPU the cache stays off unless opted in
    monkeypatch.delenv('PARA_CACHE_CPU', raising=False)
    assert cache.enable_compilation_cache() is None

    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    monkeypatch.setenv('PARA_CACHE_CPU', '1')
    try:
        assert cache.enable_compilation_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert os.path.isdir(want)
    finally:
        jax.config.update('jax_compilation_cache_dir', before[0])
        jax.config.update('jax_persistent_cache_min_compile_time_secs',
                          before[1])


# ---- chip_smoke.py ---------------------------------------------------------

def _last_json(stdout):
    lines = [ln for ln in stdout.strip().splitlines() if ln.strip()]
    if not lines:
        return None
    try:
        return json.loads(lines[-1])
    except ValueError:
        return None


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    r = subprocess.run([sys.executable, os.path.join(REPO, 'chip_smoke.py')],
                       capture_output=True, text=True, timeout=240, env=env)
    assert r.returncode != 0
    assert 'needs a GPU; JAX found cpu' in r.stderr
    assert _last_json(r.stdout) is None


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot run, and
    prints no result."""
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    r = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                       capture_output=True, text=True, timeout=240, env=env)
    assert r.returncode != 0
    assert _last_json(r.stdout) is None


def test_chip_smoke_result_line():
    sys.path.insert(0, REPO)
    import chip_smoke

    devs = [SimpleNamespace(platform='gpu', device_kind='NVIDIA H100 80GB '
                            'HBM3')] * 4
    rec = json.loads(chip_smoke.result_line(devs[:1]))
    assert rec == {'ok': True, 'device': {
        'platform': 'gpu', 'kind': 'NVIDIA H100 80GB HBM3', 'count': 1}}
    assert json.loads(chip_smoke.result_line(devs))['device']['count'] == 4


# ---- full-f32 products in the samplers ------------------------------------

def _highest_products(jaxpr):
    """Precision of every dot_general in a (closed) jaxpr, sub-jaxprs
    included."""
    out = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == 'dot_general':
                out.append(eqn.params['precision'])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)
    walk(jaxpr.jaxpr)
    return out


def _nuts_case(name):
    from parasitoids_tpu.bayes import nuts

    d = 5
    A = jnp.asarray(np.random.default_rng(0).normal(size=(d, d)))
    M = A @ A.T + d * jnp.eye(d)
    p = jnp.ones(d)
    if name == 'kinetic':
        return jax.make_jaxpr(nuts._kinetic)(M, p)
    if name == 'turning':
        return jax.make_jaxpr(nuts._is_turning)(M, p, p, p)
    if name == 'inv_mass_from_hessian':
        return jax.make_jaxpr(nuts.inv_mass_from_hessian)(M)
    if name == 'whiten_logpdf':
        f = nuts.whiten_logpdf(lambda z: -0.5 * jnp.sum(z * z),
                               np.asarray(A), np.zeros(d))
        return jax.make_jaxpr(f)(p)
    raise ValueError(name)


@pytest.mark.parametrize('name', ['kinetic', 'turning',
                                  'inv_mass_from_hessian', 'whiten_logpdf'])
def test_nuts_products_ask_for_highest_precision(name):
    precisions = _highest_products(_nuts_case(name))
    assert precisions
    for prec in precisions:
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), prec


def test_am_proposal_product_asks_for_highest_precision():
    """The adaptive-Metropolis proposal ``m + chol @ eps``."""
    from jax import random
    from parasitoids_tpu.bayes.model import BayesSetup
    from parasitoids_tpu.bayes.sampler import (MCMCConfig, _mcmc_step,
                                               init_chain_state)
    from parasitoids_tpu.config import Params

    p = Params()
    p.cmd_line_chg(['--kalbar', '--pop', '--no_plot', '--no_output',
                    'ndays=2', 'domain_info=(10000.0,50)', 'interp_num=2',
                    'kernel_rad=6', 'kernel_rad_local=3', 'quad_nodes=8'])
    setup = BayesSetup(p)
    state = init_chain_state(setup, random.PRNGKey(0))
    jx = jax.make_jaxpr(lambda s: _mcmc_step(setup, s, MCMCConfig(1)))(state)
    precisions = _highest_products(jx)
    assert precisions
    for prec in precisions:
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), prec
