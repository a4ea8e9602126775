# %% [markdown]
# # Prior choices
#
# Executable counterpart of the reference's `Bayesian_Model.ipynb`: what
# each prior in the Bayes layer says, drawn and plotted from the actual
# samplers the inference code uses (bayes/priors.py — same distributions
# and hyperparameters as Bayes_Run.py:102-196).
#
# Run: `JAX_PLATFORMS=cpu python docs/notebooks/prior_choices.py`

# %%
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'out')
os.makedirs(OUT, exist_ok=True)

import matplotlib
matplotlib.use('Agg')
import matplotlib.pyplot as plt
import jax
from jax import random

from parasitoids_tpu.bayes.priors import (MODEL_PARAM_NAMES,
                                          sample_prior_model)

# %% [markdown]
# ## The 15-parameter model block
#
# Draws from the exact prior samplers (the reference never samples its
# priors — PyMC 2 only evaluates their densities).  Note the
# reparameterized coordinates: `corr_p` is (corr+1)/2 ~ Beta(5,5)
# (so corr is symmetric about 0), `f_b*_p` is f_b − 1 ~ Gamma(2,1)
# (so f_b > 1 and activity transitions stay smooth).

# %%
keys = random.split(random.PRNGKey(0), 4000)
draws = np.asarray(jax.vmap(sample_prior_model)(keys))

ncol = 5
nrow = 3
fig, axes = plt.subplots(nrow, ncol, figsize=(3.2 * ncol, 2.5 * nrow))
for i, name in enumerate(MODEL_PARAM_NAMES):
    ax = axes[i // ncol][i % ncol]
    ax.hist(draws[:, i], bins=50, density=True)
    ax.set_title(name, fontsize=10)
    ax.set_yticks([])
fig.suptitle('prior draws, model block (4,000 samples)')
fig.tight_layout()
fig.savefig(os.path.join(OUT, 'priors_model.png'), dpi=120)
print('wrote', os.path.join(OUT, 'priors_model.png'))

# %% [markdown]
# ## What the priors imply physically
#
# * `sig_x ~ Gamma(26, 0.15)` concentrates daily flight spread near
#   ~170 m with a tail to ~330 m — this sets the static kernel-window
#   size every compiled likelihood must cover
#   (bayes/model.prior_coverage_windows).
# * `lam ~ Beta(5, 1)` leans toward most wasps attempting flight.
# * `n_periods ~ Poisson(30)` is the discrete flight-duration slot — the
#   AM sampler rounds it in proposals; NUTS either fixes it at 30 (as the
#   reference's MAP does) or Gibbs-samples it (`--gibbs-n`).

# %%
q = np.percentile(draws[:, MODEL_PARAM_NAMES.index('sig_x')],
                  [5, 50, 95, 99.99])
print('sig_x prior quantiles 5/50/95/99.99%:', np.round(q, 1))
print('  -> 3.3 sigma coverage at q99.99:', round(3.3 * q[-1], 0),
      'm (the prior-coverage kernel window, bayes/model.py)')

# %% [markdown]
# ## Sentinel observation probabilities
#
# Each sentinel field gets `Beta(alpha_k, 40)` with mean
# `A_collected / field_area` — bigger fields have smaller per-wasp
# detection probability (Bayes_Run.py:155-166).

# %%
from parasitoids_tpu.bayes.priors import sent_obs_prior_alpha

areas = np.array([3600.0, 10000.0, 40000.0])
alpha = np.asarray(sent_obs_prior_alpha(2500.0, areas))
for a, al in zip(areas, alpha):
    mean = al / (al + 40.0)
    print('field area {:>7.0f} m^2: Beta({:.2f}, 40), mean {:.3f}'.format(
        a, float(al), float(mean)))
