"""Batched episodes of one built model on one card, and the VCO path
integrator split into oscillator shards (port of
:mod:`sspslam_tpu.parallel`; the JAX package's device-mesh sharding is not
carried)."""

from .shard_step import make_sharded_vco_scan, pad_vco_params
from .trials import BatchedEpisodes, run_batched_episodes, run_seed_sweep

__all__ = ["BatchedEpisodes", "run_batched_episodes", "run_seed_sweep",
           "make_sharded_vco_scan", "pad_vco_params"]
