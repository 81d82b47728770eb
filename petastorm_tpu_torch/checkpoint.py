"""Joint training and data-position checkpoints (counterpart of
``petastorm_tpu/jax/checkpoint.py``).

The readers, the loader and the mixture carry JSON iteration state
(``state_dict``/``load_state_dict``). :class:`TrainCheckpointer` pairs it
with the model's and the optimizer's ``state_dict`` in one step-indexed
checkpoint, so a job that is killed resumes both consistently: the model
from the exact step, the data from the same point of the same epoch
(at-least-once row-groups; a mixture resumes exactly at a step boundary).

Usage::

    ckpt = TrainCheckpointer('/tmp/run1')
    step = ckpt.restore_loader(loader)          # 0 on a fresh run
    ckpt.restore_state({'model': model, 'optimizer': optimizer})
    for batch in loader.iter_steps(...):
        loss = train_step(batch['tokens'])
        step += 1
        if step % 100 == 0:
            ckpt.save(step, {'model': model, 'optimizer': optimizer}, loader)

Each step is a directory of its own, written under a temporary name and
renamed into place::

    <directory>/<step>/train_state/state.pt      torch.save of the state dicts
    <directory>/<step>/loader_state/metadata     JSON {str(rank): loader state}

(``train_state/state.<rank>.pt``, one per rank, for a model split over
ranks).

The loader file sits where the JAX package's orbax checkpointer writes
its JSON item and holds the same dict, so the loader position of a
checkpoint that either package wrote restores in the other.

With an initialized ``torch.distributed`` process group every rank calls
``save``: the loader states are gathered, keyed by rank, and rank 0
writes (the model and optimizer states of data-parallel ranks are
replicas). A model split over ranks (``init_transformer(mesh=)`` with a
``'model'`` dim of more than one rank) holds a different shard on each,
so every rank writes its own train state and reads its own back, on the
same number of ranks. A checkpoint restored on a different number of
ranks merges every rank's progress (:func:`merge_loader_states`, or
:func:`~petastorm_tpu_torch.mixture.merge_mixture_states` for a mixture)
and re-deals it under the new layout.
"""

import json
import logging
import os
import shutil
import tempfile

import torch

logger = logging.getLogger(__name__)

_STATE_DIR = 'train_state'
_STATE_FILE = 'state.pt'
_LOADER_DIR = 'loader_state'
_LOADER_FILE = 'metadata'


def merge_loader_states(states):
    """Merge per-process loader states into one elastic resume state.

    Used when a checkpoint written by N data-parallel processes is
    restored on M != N: each saved state carries its shard's consumed work
    as shard-independent ``(piece_index, drop, drop_count)`` identities
    (``items_global``), so the union re-expresses global progress that any
    new shard layout can re-localize (``Reader.load_state_dict`` with
    ``consumed_global``).

    Semantics stay at-least-once: the resume epoch is the earliest epoch
    any old shard was still in (a shard already past it consumed its whole
    item set there); rows in flight anywhere are re-read, none are lost.
    Every state must carry ``items_global``; states without it raise
    ``ValueError`` (callers fall back to a fresh start).
    """
    states = list(states)
    if not states:
        raise ValueError('no loader states to merge')
    if any(not isinstance(s, dict) for s in states):
        # a malformed entry must surface as ValueError, which
        # restore_loader's starts-fresh fallback catches
        raise ValueError('malformed loader state entries: %s'
                         % sorted({type(s).__name__ for s in states}))
    if any('items_global' not in s for s in states):
        raise ValueError('loader state(s) predate elastic resume '
                         '(no items_global); cannot merge')
    # the states must be one complete shard family: every shard exactly
    # once, all agreeing on the count
    shard_counts = {s.get('shard_count') for s in states}
    shards = [s.get('cur_shard') for s in states]
    if shard_counts == {None}:
        pass  # unsharded loaders carry no family to validate
    elif None in shard_counts:
        raise ValueError('loader states mix sharded and unsharded '
                         'entries; cannot merge')
    else:
        if len(shard_counts) != 1:
            raise ValueError('loader states disagree on shard_count: %s'
                             % sorted(shard_counts))
        (count,) = shard_counts
        if any(not isinstance(sh, int) for sh in shards):
            raise ValueError('loader state(s) carry shard_count without '
                             'an integer cur_shard: %s' % shards)
        if sorted(shards) != list(range(count)):
            raise ValueError('loader states are not one complete shard '
                             'family: got shards %s of %s'
                             % (sorted(shards), count))
    # the entries come in a JSON object's arbitrary order, and shards may
    # disagree on the seed (seed=None draws one per process): any
    # deterministic pick serves an at-least-once resume
    seed = sorted({s.get('seed') for s in states}, key=repr)[0]
    epoch = min(s['epoch'] for s in states)
    consumed = set()
    for s in states:
        idents = [tuple(ident) for ident in s['items_global']]
        if s['epoch'] > epoch:
            # this shard finished the resume epoch entirely
            consumed.update(idents)
        else:
            consumed.update(idents[i] for i in s['consumed_items'])
    if any(s['iterations_remaining'] is None for s in states):
        iterations_remaining = None  # infinite epochs
    else:
        # epoch + remaining is the configured total on every shard; max()
        # re-reads rather than loses if they ever disagreed
        iterations_remaining = max(
            s['epoch'] + s['iterations_remaining'] for s in states) - epoch
    return {
        'version': 1,
        'seed': seed,
        'epoch': epoch,
        'iterations_remaining': iterations_remaining,
        'consumed_global': [list(ident) for ident in sorted(consumed)],
    }


def _world():
    """``(world_size, rank)`` of the initialized process group, else (1, 0)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _gather_per_process(state):
    """``{str(rank): state}`` with every rank's entry, on every rank."""
    world, _ = _world()
    if world == 1:
        return {'0': state}
    gathered = [None] * world
    torch.distributed.all_gather_object(gathered, state)
    return {str(rank): s for rank, s in enumerate(gathered)}


def _barrier():
    if _world()[0] > 1:
        torch.distributed.barrier()


def _rank_file(rank):
    return 'state.%d.pt' % rank


def _split_modules(value):
    """Whether a train state holds a module split over ``'model'`` ranks
    (its ``parallel.tp`` above one)."""
    if isinstance(value, dict):
        return any(_split_modules(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return any(_split_modules(v) for v in value)
    par = getattr(value, 'parallel', None)
    return getattr(par, 'tp', 1) > 1


def _state_of(value):
    """What is saved for one train-state entry: an object's ``state_dict``
    (a module, an optimizer, a scheduler), or the value itself (tensors,
    numbers, nested dicts and lists of them)."""
    if hasattr(value, 'state_dict'):
        return value.state_dict()
    if isinstance(value, dict):
        return {k: _state_of(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_state_of(v) for v in value)
    return value


def _restore_into(template, saved):
    """The template with the saved state in it: objects with
    ``load_state_dict`` load in place and are returned; tensors come back
    on the template's device and dtype, shape checked."""
    if hasattr(template, 'load_state_dict'):
        template.load_state_dict(saved)
        return template
    if isinstance(template, dict):
        missing = sorted(set(template) - set(saved))
        if missing:
            raise KeyError('checkpoint has no train-state entries %s' % missing)
        return {k: _restore_into(v, saved[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(template) != len(saved):
            raise ValueError('checkpoint has %d entries where the template has %d'
                             % (len(saved), len(template)))
        return type(template)(_restore_into(t, s) for t, s in zip(template, saved))
    if isinstance(template, torch.Tensor):
        if tuple(saved.shape) != tuple(template.shape):
            raise ValueError('checkpoint tensor of shape %s where the template has %s'
                             % (tuple(saved.shape), tuple(template.shape)))
        return saved.to(device=template.device, dtype=template.dtype)
    return saved


class TrainCheckpointer:
    """Step-indexed checkpoints of (train state, loader position).

    :param directory: checkpoint root on a local or shared filesystem
        (created if missing).
    :param max_to_keep: checkpoints kept; older ones are removed.
    """

    def __init__(self, directory, max_to_keep=3):
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError('max_to_keep must be >= 1 or None, got %r' % (max_to_keep,))
        self._directory = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        os.makedirs(self._directory, exist_ok=True)

    def all_steps(self):
        """Every checkpointed step, ascending (temporary directories of an
        unfinished save are not steps)."""
        return sorted(int(name) for name in os.listdir(self._directory)
                      if name.isdigit()
                      and os.path.isdir(os.path.join(self._directory, name)))

    @property
    def latest_step(self):
        """Most recent checkpointed step, or None on a fresh run."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step):
        return os.path.join(self._directory, str(int(step)))

    def save(self, step, train_state, loader=None, force=False):
        """Write one checkpoint: the train state (a dict of modules,
        optimizers and tensors; see :meth:`restore_state`) plus, optionally,
        the iteration state of ``loader`` (a TorchLoader, a reader, or any
        object with ``state_dict()``). Every rank calls it.

        As orbax's ``CheckpointManager.save``: without ``force``, a step
        not after the latest checkpointed one is skipped; with ``force``
        it is written, and a step that already exists raises
        ``ValueError``. Returns the step's directory, or None when the
        step was skipped, where orbax returns True or False."""
        step = int(step)
        latest = self.latest_step
        if not force and latest is not None and step <= latest:
            return None
        final = self._step_dir(step)
        payload = (_gather_per_process(loader.state_dict())
                   if loader is not None else None)
        _, rank = _world()
        per_rank = _split_modules(train_state)
        tmp = None
        if rank == 0:
            if os.path.exists(final):
                raise ValueError('checkpoint step %d already exists in %s'
                                 % (step, self._directory))
            tmp = tempfile.mkdtemp(prefix='.tmp-%d-' % step, dir=self._directory)
            os.makedirs(os.path.join(tmp, _STATE_DIR))
        if per_rank:
            # every rank writes its file into rank 0's temporary directory
            # before rank 0 renames it into place
            shared = [tmp]
            torch.distributed.broadcast_object_list(shared, src=0)
            tmp = shared[0]
            torch.save(_state_of(train_state),
                       os.path.join(tmp, _STATE_DIR, _rank_file(rank)))
            _barrier()
        if rank == 0:
            try:
                if not per_rank:
                    torch.save(_state_of(train_state),
                               os.path.join(tmp, _STATE_DIR, _STATE_FILE))
                if payload is not None:
                    os.makedirs(os.path.join(tmp, _LOADER_DIR))
                    with open(os.path.join(tmp, _LOADER_DIR, _LOADER_FILE), 'w') as f:
                        json.dump(payload, f)
                os.rename(tmp, final)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            if self._max_to_keep is not None:
                for old in self.all_steps()[:-self._max_to_keep]:
                    shutil.rmtree(self._step_dir(old))
        _barrier()
        return final

    def restore_state(self, train_state_template, step=None):
        """The checkpointed train state, or the template itself on a fresh
        run. Modules and optimizers in the template load the saved state
        in place; tensors are returned on the template's device and dtype."""
        step = self.latest_step if step is None else step
        if step is None:
            return train_state_template
        directory = os.path.join(self._step_dir(step), _STATE_DIR)
        name = _STATE_FILE
        if _split_modules(train_state_template):
            world, rank = _world()
            saved_ranks = sum(f.startswith('state.') and f != _STATE_FILE
                              for f in os.listdir(directory))
            if saved_ranks != world:
                raise ValueError('checkpoint step %d holds the split train states of %d '
                                 'ranks; it restores on %d ranks, not %d'
                                 % (step, saved_ranks, saved_ranks, world))
            name = _rank_file(rank)
        saved = torch.load(os.path.join(directory, name), map_location='cpu',
                           weights_only=True)
        return _restore_into(train_state_template, saved)

    def restore_loader(self, loader, step=None):
        """Reposition ``loader`` to the checkpointed data position (before
        iteration starts). Returns the restored step, or 0 on a fresh run.

        A checkpoint saved without loader state starts the data position
        fresh, with a warning. A loader state that is present but cannot
        be read raises."""
        step = self.latest_step if step is None else step
        if step is None:
            return 0
        path = os.path.join(self._step_dir(step), _LOADER_DIR, _LOADER_FILE)
        if not os.path.exists(path):
            logger.warning('checkpoint step %s was saved without loader '
                           'state; data position starts fresh', step)
            return step
        with open(path) as f:
            payload = json.load(f)
        world, rank = _world()
        if isinstance(payload, dict) and len(payload) != world:
            # resized between save and restore (N writers, M readers):
            # merge every shard's progress and re-deal it under the new
            # layout; a state that cannot merge starts fresh
            try:
                values = list(payload.values())
                if all(isinstance(s, dict) and 'mixture' in s for s in values):
                    # a mixture re-shards at the packed-row ordinal
                    from petastorm_tpu_torch.mixture import merge_mixture_states
                    merged = merge_mixture_states(values)
                    position = 'ordinal %s' % merged.get('resume_ordinal')
                else:
                    merged = merge_loader_states(values)
                    position = 'epoch %s' % merged['epoch']
                loader.load_state_dict(merged)
                logger.info('checkpoint step %s: loader state merged from %d '
                            'processes onto %d (elastic resume, %s)',
                            step, len(payload), world, position)
            except ValueError as e:
                logger.warning('checkpoint step %s: cannot merge resized '
                               'loader state (%s); data position starts '
                               'fresh', step, e)
            return step
        try:
            loader_state = payload[str(rank)]
        except (KeyError, TypeError) as e:
            logger.warning('checkpoint step %s has no loader state for this '
                           'process (%s); data position starts fresh', step, e)
            return step
        loader.load_state_dict(loader_state)
        return step

    def close(self):
        """Nothing stays open between calls; kept for the JAX API's shape."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()
