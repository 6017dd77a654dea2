"""Batched episodes of one built model on one card (port of
:mod:`sspslam_tpu.parallel.trials`; the JAX package's device-mesh sharding
is not carried)."""

from .trials import BatchedEpisodes, run_batched_episodes, run_seed_sweep

__all__ = ["BatchedEpisodes", "run_batched_episodes", "run_seed_sweep"]
