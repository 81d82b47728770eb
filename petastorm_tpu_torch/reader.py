"""Reader: the read-path front end, ``make_batch_reader``.

Counterpart of ``petastorm_tpu/reader.py`` on the dummy and thread pools.
It opens a (materialized or plain) Parquet dataset, enumerates and shards
its row-groups, ventilates them to a decode pool and iterates whole
row-groups as namedtuples of column arrays. Its ``state_dict`` has the
reference's shape, so a checkpoint saved by either package resumes in the
other. Kwargs that reach unported code raise ``NotImplementedError``
naming their ``ROADMAP.md`` item.
"""

import os
import time

from petastorm_tpu_torch.arrow_worker import RowGroupWorker, defer_config_ok
from petastorm_tpu_torch.errors import NoDataAvailableError, unported
from petastorm_tpu_torch.etl.dataset_metadata import (
    ParquetDatasetInfo, infer_or_load_unischema, load_row_groups,
)
from petastorm_tpu_torch.telemetry import note_consumer_wait, span
from petastorm_tpu_torch.transform import transform_schema
from petastorm_tpu_torch.workers import EmptyResultError
from petastorm_tpu_torch.workers.dummy_pool import DummyPool
from petastorm_tpu_torch.workers.thread_pool import ThreadPool
from petastorm_tpu_torch.workers.ventilator import ConcurrentVentilator

# row-groups ventilated beyond the worker count: bounds host memory while
# keeping workers busy
_VENTILATE_EXTRA_ROWGROUPS = 2

# pulls shorter than this are per-result work, not starvation
_PULL_NOTE_FLOOR_S = 0.01


def make_batch_reader(dataset_url_or_urls, schema_fields=None,
                      reader_pool_type='thread', workers_count=None,
                      results_queue_size=50, shuffle_row_groups=True,
                      shuffle_row_drop_partitions=1, predicate=None,
                      rowgroup_selector=None, num_epochs=1, cur_shard=None,
                      shard_count=None, seed=0, cache_type='null',
                      cache_location=None, cache_size_limit=None,
                      cache_row_size_estimate=None, transform_spec=None,
                      filters=None, storage_options=None, filesystem=None,
                      defer_image_decode=False, poison_policy=None,
                      mixture_interleave=None, max_staleness_s=None):
    """Reader yielding whole row-groups as namedtuples of column arrays,
    over any Parquet store, petastorm metadata or not.

    :param schema_fields: field names/regexes to read (None: all).
    :param reader_pool_type: ``'thread'`` or ``'dummy'`` (synchronous,
        deterministic order).
    :param shuffle_row_groups: permute the row-group order each epoch,
        from ``seed``.
    :param shuffle_row_drop_partitions: split each row-group into this
        many contiguous parts, ventilated as separate items.
    :param num_epochs: epochs to read; None = infinite.
    :param cur_shard: this reader's shard (with ``shard_count``): row-group
        ``n`` of the list goes to shard ``n % shard_count``.
    :param transform_spec: a :class:`~petastorm_tpu_torch.transform.TransformSpec`
        run on the workers.
    :param defer_image_decode: workers hand fixed-shape image columns on
        still encoded, as :class:`~petastorm_tpu_torch.fused.EncodedImageColumn`
        (the torch loader asks for this and decodes them straight into its
        staging slots); declined with a TransformSpec.

    The reference's other kwargs are taken under its names and at its
    positions; each one set raises ``NotImplementedError`` naming the
    ``ROADMAP.md`` item that ports it.
    """
    if predicate is not None:
        raise unported('make_batch_reader(predicate=)', 3)
    if rowgroup_selector is not None:
        raise unported('make_batch_reader(rowgroup_selector=)', 10)
    if cache_type not in (None, 'null', 'none'):
        raise unported('cache_type=%r' % (cache_type,), 3)
    for name, value in (('cache_location', cache_location),
                        ('cache_size_limit', cache_size_limit),
                        ('cache_row_size_estimate', cache_row_size_estimate)):
        if value is not None:
            raise unported('make_batch_reader(%s=)' % name, 3)
    if filters:
        raise unported('make_batch_reader(filters=)', 3)
    if poison_policy is not None:
        raise unported('poison_policy=', 9)
    if mixture_interleave is not None:
        raise unported('make_batch_reader(mixture_interleave=)', 7)
    if max_staleness_s is not None:
        raise unported('make_batch_reader(max_staleness_s=)', 10)
    info = ParquetDatasetInfo(dataset_url_or_urls, storage_options, filesystem=filesystem)
    return Reader(info, schema_fields=schema_fields,
                  reader_pool_type=reader_pool_type, workers_count=workers_count,
                  results_queue_size=results_queue_size,
                  shuffle_row_groups=shuffle_row_groups,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions,
                  num_epochs=num_epochs, cur_shard=cur_shard,
                  shard_count=shard_count, seed=seed,
                  transform_spec=transform_spec, defer_image_decode=defer_image_decode)


def _make_pool(reader_pool_type, workers_count, results_queue_size):
    if reader_pool_type in ('process', 'service'):
        raise unported("reader_pool_type=%r" % reader_pool_type, 9)
    if reader_pool_type == 'dummy':
        return DummyPool()
    if reader_pool_type != 'thread':
        raise ValueError("reader_pool_type must be 'thread' or 'dummy'; got %r"
                         % (reader_pool_type,))
    if workers_count is None:
        # decode needs a core each: more workers than cores only thrash
        workers_count = max(1, min(4, os.cpu_count() or 1))
    return ThreadPool(workers_count, results_queue_size)


def _resolve_shards(cur_shard, shard_count):
    """Both None: no sharding. Both set: validated. One set: ambiguous."""
    if cur_shard is None and shard_count is None:
        return None, None
    if cur_shard is None or shard_count is None:
        raise ValueError('cur_shard and shard_count must be specified together '
                         '(got cur_shard=%r, shard_count=%r)'
                         % (cur_shard, shard_count))
    if not 0 <= cur_shard < shard_count:
        raise ValueError('cur_shard %r must be in [0, shard_count=%r)'
                         % (cur_shard, shard_count))
    return cur_shard, shard_count


class Reader:
    """Iterator over a dataset's row-groups as column batches.

    Construction: resolve the schema, take the requested view, enumerate
    and shard row-groups, build the ventilator, start the worker pool.
    Ventilation begins at the first read, so ``load_state_dict`` can
    reposition the cursor first.
    """

    batched_output = True

    def __init__(self, dataset_info, schema_fields=None, reader_pool_type='thread',
                 workers_count=None, results_queue_size=50, shuffle_row_groups=True,
                 shuffle_row_drop_partitions=1, num_epochs=1, cur_shard=None,
                 shard_count=None, seed=0, transform_spec=None, defer_image_decode=False):
        self.dataset_info = dataset_info
        self.stored_schema = infer_or_load_unischema(dataset_info)
        if schema_fields is not None:
            self.loaded_schema = self.stored_schema.create_schema_view(schema_fields)
            if schema_fields and not len(self.loaded_schema):
                raise ValueError(
                    'No fields matching the criteria %r in schema %s'
                    % (schema_fields, list(self.stored_schema.fields)))
        else:
            self.loaded_schema = self.stored_schema
        self.schema = (transform_schema(self.loaded_schema, transform_spec)
                       if transform_spec is not None else self.loaded_schema)

        all_pieces = load_row_groups(dataset_info)
        self.cur_shard, self.shard_count = _resolve_shards(cur_shard, shard_count)
        piece_indices = list(range(len(all_pieces)))
        if self.shard_count is not None:
            if self.shard_count > len(piece_indices):
                raise NoDataAvailableError(
                    'Number of row-groups in the dataset (%d) must be greater or '
                    'equal to the number of requested shards (%d)'
                    % (len(piece_indices), self.shard_count))
            piece_indices = [i for n, i in enumerate(piece_indices)
                             if n % self.shard_count == self.cur_shard]
        if not piece_indices:
            raise NoDataAvailableError('No row-groups left to read for this '
                                       'reader (dataset %s)' % dataset_info.url)

        items = []
        for idx in piece_indices:
            for drop in range(shuffle_row_drop_partitions):
                items.append({'piece_index': idx,
                              'shuffle_row_drop_partition':
                                  (drop, shuffle_row_drop_partitions),
                              'item_index': len(items)})
        self._num_items = len(items)
        # shard-independent identity of each local item: (global piece
        # index, drop partition, drop partition count)
        self._items_identity = [
            (it['piece_index'],) + tuple(it['shuffle_row_drop_partition'])
            for it in items]

        self._pool = _make_pool(reader_pool_type, workers_count, results_queue_size)
        self._num_epochs = num_epochs
        self._ventilator = ConcurrentVentilator(
            self._pool.ventilate, items, iterations=num_epochs,
            max_ventilation_queue_size=lambda: (
                self._pool.workers_count + _VENTILATE_EXTRA_ROWGROUPS),
            randomize_item_order=shuffle_row_groups, random_seed=seed,
            pass_epoch=True)
        if defer_image_decode and not defer_config_ok(transform_spec):
            # counted here, once per Reader, not by each worker
            from petastorm_tpu_torch.fused import count_fallback
            count_fallback('worker-config')
        self._pool.start(RowGroupWorker,
                         worker_args={
                             'dataset_info': dataset_info,
                             'schema': self.schema,
                             'loaded_schema': self.loaded_schema,
                             'stored_schema': self.stored_schema,
                             'transform_spec': transform_spec,
                             'row_groups': all_pieces,
                             'defer_image_decode': defer_image_decode,
                         },
                         ventilator=self._ventilator, start_ventilator=False)
        self.last_row_consumed = False
        self._started = False
        self._stopped = False
        # per-epoch sets of consumed item indices (exact resume)
        self._consumed_by_epoch = {}

    # -- iteration -----------------------------------------------------------

    def __iter__(self):
        return self

    def _pull_result(self):
        """One pool result under the ``queue_wait`` span; a long block is
        consumer wait."""
        with span('queue_wait'):
            t0 = time.monotonic()
            try:
                return self._pool.get_results()
            finally:
                waited = time.monotonic() - t0
                if waited > _PULL_NOTE_FLOOR_S:
                    note_consumer_wait(waited)

    def __next__(self):
        columns, _, _ = self.next_batch_info()
        return self.schema.make_namedtuple(**columns)

    def next_batch_info(self):
        """``(columns_dict, item_index, epoch)`` for one row-group batch:
        the provenance-carrying flavor of ``__next__`` for consumers that
        buffer rows downstream. Raises StopIteration at the end."""
        if self._stopped:
            raise RuntimeError('Trying to read a sample from a stopped reader')
        if not self._started:
            self._ventilator.start()
            self._started = True
        try:
            batch = self._pull_result()
        except EmptyResultError:
            self.last_row_consumed = True
            raise StopIteration from None
        self._consumed_by_epoch.setdefault(batch.epoch, set()).add(batch.item_index)
        columns = {name: batch.columns[name] for name in self.schema.fields
                   if name in batch.columns}
        return columns, batch.item_index, batch.epoch

    # -- lifecycle -----------------------------------------------------------

    def reset(self):
        """Restart the epoch sweep; valid only after full consumption."""
        if not self.last_row_consumed:
            raise NotImplementedError(
                'Resetting a reader while in the middle of iteration is not '
                'supported; consume all samples first')
        self._ventilator.reset()
        self.last_row_consumed = False
        self._consumed_by_epoch = {}

    def stop(self):
        self._pool.stop()
        self._stopped = True

    def join(self):
        self._pool.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        self.join()

    @property
    def diagnostics(self):
        return self._pool.diagnostics

    # -- checkpointable iteration state --------------------------------------

    def state_dict(self):
        """Row-group-granular, at-least-once iteration state: resume starts
        at the earliest epoch with unconsumed row-groups and skips the ones
        already consumed in it."""
        return self.resume_state_from(self._consumed_by_epoch)

    def resume_state_from(self, consumed_by_epoch):
        """A ``state_dict``-shaped resume point from an external
        ``{epoch: {item_index, ...}}`` consumption record (the loader's
        delivery-accurate one)."""
        epochs_seen = sorted(consumed_by_epoch)
        if not epochs_seen:
            resume_epoch, consumed = 0, []
        else:
            # walk epochs from 0: an absent epoch is maximally incomplete
            resume_epoch = None
            for e in range(epochs_seen[-1] + 1):
                if len(consumed_by_epoch.get(e, ())) < self._num_items:
                    resume_epoch = e
                    break
            if resume_epoch is None:
                resume_epoch, consumed = epochs_seen[-1] + 1, []
            else:
                consumed = sorted(consumed_by_epoch.get(resume_epoch, ()))
        if self._num_epochs is None:
            iterations_remaining = None
        else:
            iterations_remaining = max(0, self._num_epochs - resume_epoch)
        return {
            'version': 1,
            'seed': self._ventilator.state_dict()['seed'],
            'epoch': resume_epoch,
            'iterations_remaining': iterations_remaining,
            'consumed_items': consumed,
            'items_global': [list(ident) for ident in self._items_identity],
            'shard_count': self.shard_count,
            'cur_shard': self.cur_shard,
        }

    def _localize_state(self, state):
        """Normalize a state to LOCAL ``consumed_items``: a merged state's
        ``consumed_global`` identities, or a saver whose item list differs
        from ours, translate through the per-item identities."""
        if 'consumed_global' in state:
            consumed = {tuple(ident) for ident in state['consumed_global']}
            state = dict(state)
            state['consumed_items'] = [i for i, ident in enumerate(self._items_identity)
                                       if ident in consumed]
            return state
        saved = state.get('items_global')
        if saved is not None:
            saved = [tuple(ident) for ident in saved]
            if saved != self._items_identity:
                position = {ident: i for i, ident in enumerate(self._items_identity)}
                state = dict(state)
                state['consumed_items'] = sorted(
                    position[saved[i]] for i in state['consumed_items']
                    if i < len(saved) and saved[i] in position)
                state['items_global'] = [list(ident) for ident in self._items_identity]
        return state

    def load_state_dict(self, state):
        """Reposition the iteration before the first read."""
        if self._started:
            raise RuntimeError('load_state_dict must be called before iteration '
                               'starts')
        state = self._localize_state(state)
        self._ventilator.load_state_dict({
            'epoch': state['epoch'],
            'cursor': 0,
            'seed': state['seed'],
            'iterations_remaining': state['iterations_remaining'],
        })
        self._ventilator.exclude_from_next_epoch(state['consumed_items'])
        self._consumed_by_epoch = self.consumption_record_for_resume(state)

    def consumption_record_for_resume(self, state):
        """``{epoch: {item_index}}`` as of the restored position: epochs
        before the resume epoch complete, the resume epoch holding its
        already-consumed items."""
        state = self._localize_state(state)
        record = {e: set(range(self._num_items)) for e in range(state['epoch'])}
        record[state['epoch']] = set(state['consumed_items'])
        return record
