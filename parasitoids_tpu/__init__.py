"""parasitoids_tpu — JAX rebuild of the Parasitoids drift–diffusion
framework (reference: mountaindust/Parasitoids).

The reference implements an analytic wind-advected dispersal model for
parasitoid wasps (forward model) plus a Bayesian inference layer that re-runs
the forward model inside every MCMC likelihood evaluation.  This package
re-designs the whole stack as jitted device programs:

* per-minute flight kernels are built densely on-device with a closed-form
  bivariate-normal cell integrator under ``vmap`` (replacing the adaptive
  Fortran ``mvnun`` ring loop of ``ParasitoidModel.get_mvn_cdf_values``),
* multi-day spread is a ``lax.scan`` over Fourier-space products using XLA's
  FFT (replacing ``CalcSol.py``/``cuda_lib.py`` scipy/Reikna paths and all
  host sparse bookkeeping),
* the Bayes layer is a jit-compiled adaptive-Metropolis sampler / autodiff MAP
  optimizer whose every log-posterior evaluation runs the full forward
  simulation on the device (replacing PyMC 2.x), with chains run on one card
  and sharded across a ``jax.sharding.Mesh`` for multi-card runs.

Layer map (mirrors SURVEY.md section 1):
  config.py            L0 flags/params       (ref: Run.py Params)
  io/                  L1 data ingestion     (ref: ParasitoidModel wind IO, Data_Import)
  ops/                 L2 kernel construction(ref: ParasitoidModel model funcs)
  models/              L3 propagation + observation projection
                                             (ref: CalcSol, Bayes_funcs)
  bayes/               L4 inference          (ref: Bayes_Run, Bayes_MAP)
  viz/, cli.py         L5 drivers & analysis (ref: Run.py main, Plot_*, CompareToData)
  parallel/            multi-chip meshes/sharding (no reference equivalent;
                                             replaces multiprocessing.Pool)
"""

__version__ = "0.1.0"
