"""PyTorch/CUDA port of the MU-SplitFed system (``repro`` is the JAX reference).

Module names follow ``repro`` so each module has an obvious counterpart:

    configs/        ModelConfig, SFLConfig, the dense decoder archs
    core/prng       threefry2x32 PRNGKey / fold_in / split on raw uint32 keys
    core/zo         SPSA with gaussian, sphere and counter noise: perturb,
                    replay, spsa_step, zo_gradient
    core/splitfed   mu_splitfed_round (paper Algorithm 1), mu_split_round
    core/population client fleets (cohorts, delays, availability)
    core/straggler  straggler schedules, round-time models, plan_tau
    core/engine     the synchronous engine: run_rounds, AdaptiveTau
    kernels/        hand-written CUDA kernels (zo_update, zo_replay, flash
                    attention, rmsnorm, threefry), their plain PyTorch
                    versions, the nvcc build
    models/         dense decoder LM over stacked-unit parameter dicts
    data/           synthetic LM data, Dirichlet partition, federated loader
    launch/train    the synchronous training driver

The package imports torch and numpy only: never jax, never ``repro``.
"""
