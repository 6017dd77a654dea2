"""Multi-device execution (port of :mod:`sspslam_tpu.parallel`): the mesh
and its launcher on ``torch.distributed`` (one process per device, NCCL on
the card, gloo on the CPU) and the per-leaf split rules; batched episodes
of one built model, over a data axis and with a model axis inside each
episode; the VCO path integrator split into oscillator shards, on CUDA
streams of one card or on the ranks of a model axis."""

from .sharding import (Mesh, gather_state, init_rank, make_mesh,
                       params_shardings, shard_params, shard_state, spawn,
                       state_shardings)
from .shard_step import make_sharded_vco_scan, pad_vco_params
from .trials import BatchedEpisodes, run_batched_episodes, run_seed_sweep

__all__ = ["Mesh", "make_mesh", "init_rank", "spawn", "shard_state",
           "shard_params", "gather_state", "state_shardings",
           "params_shardings", "BatchedEpisodes", "run_batched_episodes",
           "run_seed_sweep", "make_sharded_vco_scan", "pad_vco_params"]
