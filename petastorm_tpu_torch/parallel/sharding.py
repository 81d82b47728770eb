"""Rank-aware shard assignment.

Counterpart of ``petastorm_tpu/parallel/sharding.py``'s
``default_shard_info``. The JAX package shards by ``jax.process_index()``
of ``jax.process_count()`` when its runtime is already live; the port
shards by the rank and world size of a ``torch.distributed`` default
process group that is already initialized. Neither ever brings a runtime
up: building a reader must not join (or hang on) a rendezvous. Shards stay
disjoint by construction, with no communication.
"""

import logging
import os
import sys

logger = logging.getLogger(__name__)

_warned_uninitialized = False


def _process_group_info():
    """``(rank, world_size)`` of an ALREADY initialized default process
    group, else ``(None, None)``. A launcher that says more than one rank
    (``WORLD_SIZE``) while no group is up yet gets one warning: its readers
    would each read the whole dataset. A process that never imported
    ``torch.distributed`` has no group, so this imports nothing."""
    dist = sys.modules.get('torch.distributed')
    if dist is not None and dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    global _warned_uninitialized
    try:
        launched = int(os.environ.get('WORLD_SIZE', '1')) > 1
    except ValueError:
        launched = False
    if launched and not _warned_uninitialized:
        _warned_uninitialized = True
        logger.warning(
            'WORLD_SIZE=%s but no torch.distributed process group is initialized '
            'yet; shard defaults are OFF for this reader. Call '
            'torch.distributed.init_process_group() (or pass cur_shard/shard_count '
            'explicitly) BEFORE building readers, or every rank will read the full '
            'dataset.', os.environ.get('WORLD_SIZE'))
    return None, None


def default_shard_info(cur_shard, shard_count):
    """Resolve ``(cur_shard, shard_count)``, filling defaults from the
    process group.

    * both None: no sharding, unless a default process group of more than
      one rank is live, in which case shard by rank;
    * both set: used as given (validated);
    * one set: ambiguous, an error.
    """
    if cur_shard is None and shard_count is None:
        rank, world = _process_group_info()
        if world is not None and world > 1:
            logger.info('Sharding dataset by torch.distributed rank: shard %d of %d',
                        rank, world)
            return rank, world
        return None, None
    if cur_shard is None or shard_count is None:
        raise ValueError('cur_shard and shard_count must be specified together '
                         '(got cur_shard=%r, shard_count=%r)'
                         % (cur_shard, shard_count))
    if not 0 <= cur_shard < shard_count:
        raise ValueError('cur_shard %r must be in [0, shard_count=%r)'
                         % (cur_shard, shard_count))
    return cur_shard, shard_count
