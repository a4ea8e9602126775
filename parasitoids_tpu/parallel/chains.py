"""Multi-chain / multi-chip MCMC execution.

The reference runs a single sequential PyMC chain per process; parallel
chains meant parallel *processes* (SURVEY.md section 2: multiprocessing is
the only parallelism).  Here chains are a batch axis: ``vmap`` over chain
states runs them in lockstep on one chip, and placing the chain axis on a
``jax.sharding.Mesh`` runs them data-parallel across chips — the XLA SPMD
partitioner splits every per-chain array, and no collectives are needed
until diagnostics gather the traces.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import random
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..bayes.model import BayesSetup
from ..bayes.sampler import (ChainState, MCMCConfig, init_chain_state,
                             run_mcmc)

__all__ = ['chain_mesh', 'init_chains', 'shard_chain_states', 'run_chains']


def axis_mesh(axis, n_devices=None, devices=None):
    """1-D mesh over ``axis`` (all devices by default) — the shared
    constructor behind chain_mesh and domain.minute_mesh."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def chain_mesh(n_devices=None, devices=None):
    """1-D mesh over a ``chains`` axis."""
    return axis_mesh('chains', n_devices, devices)


def init_chains(setup: BayesSetup, key, n_chains, jitter=0.05):
    """Initialize ``n_chains`` states with jittered starting points.

    Over-dispersed starts make Gelman–Rubin meaningful.  The jitter is
    applied in UNCONSTRAINED space (the transforms of bayes/transforms.py)
    so every start is guaranteed inside the prior support — a
    multiplicative jitter on the constrained values can push bounded
    parameters out of support (lam starts at 0.95 with a (0,1) Beta
    prior; an out-of-support start has -inf prior, and with the tiny
    per-parameter proposal scales the chain would never re-enter —
    silently frozen for the whole run).  Observation parameters start
    identically across chains.
    """
    keys = random.split(key, n_chains)
    from ..bayes.priors import initial_model_params
    from ..bayes.transforms import MODEL_TRANSFORMS
    m0 = initial_model_params()
    z0 = np.array([0.0 if i == 13 else float(t.fwd(v))
                   for i, (t, v) in enumerate(zip(MODEL_TRANSFORMS, m0))])
    states = []
    for i in range(n_chains):
        k_init, k_chain = random.split(keys[i])
        z_i = z0 + jitter * np.asarray(random.normal(k_init, z0.shape))
        m_i = np.array([30.0 if j == 13 else float(t.inv(z))
                        for j, (t, z) in enumerate(zip(MODEL_TRANSFORMS,
                                                       z_i))])
        states.append(init_chain_state(setup, k_chain, m0=m_i))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def shard_chain_states(states, mesh):
    """Place chain-stacked states with the chain axis over the mesh."""
    sharding = NamedSharding(mesh, P('chains'))

    def put(x):
        return jax.device_put(x, sharding)

    return jax.tree.map(put, states)


# Per-device, chains advance through ``lax.map`` (sequential), NOT ``vmap``:
# a chain-batched forward pass batches the BVN integrator's rho-dependent
# ``lax.switch``, and a batched-predicate switch lowers to executing EVERY
# branch with a select.  Sequential chains per device cost exactly N x
# single-chain; cross-device parallelism comes from ``shard_map`` over the
# mesh (each device runs its local chains unbatched).


@partial(jax.jit, static_argnames=('setup', 'cfg'))
def _run_chains(setup, states, cfg):
    return jax.lax.map(lambda s: run_mcmc(setup, s, cfg), states)


@partial(jax.jit, static_argnames=('setup', 'cfg', 'mesh'))
def _run_chains_sharded(setup, states, cfg, mesh):
    # jitted at module scope with (setup, cfg, mesh) as static keys: the
    # checkpoint loop calls run_chains once per chunk, and a per-call
    # jit(shard_map(lambda ...)) would re-trace the multi-chain program
    # every chunk (minutes per compile at full config)
    from jax import shard_map

    spec = P('chains')
    f = shard_map(
        lambda st: jax.lax.map(lambda s: run_mcmc(setup, s, cfg), st),
        mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False)
    return f(states)


def run_chains(setup: BayesSetup, states, cfg: MCMCConfig, mesh=None):
    """Advance all chains; returns (states, traces (n_chains, n, dim)).

    With a mesh, the chain axis is sharded over devices (data-parallel;
    chain count must divide the device count — the CLI falls back to the
    unsharded path otherwise); within a device, local chains run
    sequentially (see note above).
    """
    if mesh is None:
        return _run_chains(setup, states, cfg)
    n_chains = jax.tree.leaves(states)[0].shape[0]
    n_dev = int(np.prod(list(mesh.shape.values())))
    if n_chains % n_dev:
        raise ValueError(
            '{} chains cannot shard evenly over {} devices; use a chain '
            'count divisible by the device count (or mesh=None)'.format(
                n_chains, n_dev))
    states = shard_chain_states(states, mesh)
    return _run_chains_sharded(setup, states, cfg, mesh)
