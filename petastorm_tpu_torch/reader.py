"""Reader: the read-path front end, ``make_reader`` and
``make_batch_reader``.

Counterpart of ``petastorm_tpu/reader.py`` on the dummy and thread pools.
It opens a (materialized or plain) Parquet dataset, enumerates its
row-groups, prunes them against ``filters=``/``predicate=`` (partition
values before sharding, footer statistics after, see
:mod:`petastorm_tpu_torch.pushdown`), shards them (by the live
``torch.distributed`` rank unless ``cur_shard``/``shard_count`` say
otherwise), ventilates them to a decode pool and iterates them: whole
row-groups as namedtuples of column arrays (``make_batch_reader``), or one
namedtuple per row, or one ``{timestep: namedtuple}`` per NGram window
(``make_reader``). Its ``state_dict`` has the reference's shape, so a
checkpoint saved by either package resumes in the other. Kwargs that
reach unported code raise ``NotImplementedError`` naming their
``ROADMAP.md`` item.
"""

import os
import time
import warnings

from petastorm_tpu_torch import pushdown
from petastorm_tpu_torch.arrow_worker import (
    RowGroupWorker, defer_config_ok, typed_partition_value,
)
from petastorm_tpu_torch.errors import MetadataError, NoDataAvailableError, unported
from petastorm_tpu_torch.etl.dataset_metadata import (
    ParquetDatasetInfo, get_schema, infer_or_load_unischema, load_row_groups,
)
from petastorm_tpu_torch.filters import (
    FiltersPredicate, describe_clauses, prune_row_group_indices,
)
from petastorm_tpu_torch.parallel.sharding import default_shard_info
from petastorm_tpu_torch.predicates import in_reduce
from petastorm_tpu_torch.telemetry import note_consumer_wait, obs_server, span, tracing
from petastorm_tpu_torch.transform import transform_schema
from petastorm_tpu_torch.workers import EmptyResultError
from petastorm_tpu_torch.workers.dummy_pool import DummyPool
from petastorm_tpu_torch.workers.thread_pool import ThreadPool
from petastorm_tpu_torch.workers.ventilator import ConcurrentVentilator, epoch_order

# row-groups ventilated beyond the worker count: bounds host memory while
# keeping workers busy
_VENTILATE_EXTRA_ROWGROUPS = 2

# pulls shorter than this are per-result work, not starvation
_PULL_NOTE_FLOOR_S = 0.01


def _refuse_unported(entry, rowgroup_selector, cache_type, cache_location, cache_size_limit,
                     cache_row_size_estimate, poison_policy):
    """Raise the ``unported`` error of the first reference kwarg that is
    set and reaches code the port lacks."""
    if rowgroup_selector is not None:
        raise unported('%s(rowgroup_selector=)' % entry, 10)
    if cache_type not in (None, 'null', 'none'):
        raise unported('cache_type=%r' % (cache_type,), 3)
    for name, value in (('cache_location', cache_location),
                        ('cache_size_limit', cache_size_limit),
                        ('cache_row_size_estimate', cache_row_size_estimate)):
        if value is not None:
            raise unported('%s(%s=)' % (entry, name), 3)
    if poison_policy is not None:
        raise unported('poison_policy=', 9)


def make_reader(dataset_url, schema_fields=None, reader_pool_type='thread',
                workers_count=None, results_queue_size=50, shuffle_row_groups=True,
                shuffle_row_drop_partitions=1, predicate=None,
                rowgroup_selector=None, num_epochs=1, cur_shard=None,
                shard_count=None, seed=0, cache_type='null', cache_location=None,
                cache_size_limit=None, cache_row_size_estimate=None,
                transform_spec=None, ngram=None, filters=None,
                storage_options=None, filesystem=None, poison_policy=None):
    """Reader over a petastorm materialized dataset, iterating rows as
    namedtuples with every codec decoded, or NGram windows as
    ``{timestep: namedtuple}`` dicts.

    :param ngram: an :class:`~petastorm_tpu_torch.ngram.NGram`: the reader
        yields its windows, formed within each row-group (and, with
        ``shuffle_row_drop_partitions``, each partition borrows the next
        one's first ``ngram.length - 1`` rows); ``schema_fields`` is then
        ignored.

    The other kwargs are :func:`make_batch_reader`'s, under the
    reference's names and at its positions; those that reach unported
    code raise ``NotImplementedError`` naming their ``ROADMAP.md`` item.
    Use :func:`make_batch_reader` for plain Parquet stores or column-batch
    output.
    """
    _refuse_unported('make_reader', rowgroup_selector, cache_type, cache_location,
                     cache_size_limit, cache_row_size_estimate, poison_policy)
    info = ParquetDatasetInfo(dataset_url, storage_options, filesystem=filesystem)
    try:
        get_schema(info)
    except MetadataError:
        warnings.warn('Dataset at %s is missing petastorm metadata; the schema '
                      'will be inferred. Consider make_batch_reader for plain '
                      'Parquet stores' % dataset_url)
    return Reader(info, schema_fields=schema_fields,
                  reader_pool_type=reader_pool_type, workers_count=workers_count,
                  results_queue_size=results_queue_size,
                  shuffle_row_groups=shuffle_row_groups,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions,
                  predicate=predicate, num_epochs=num_epochs, cur_shard=cur_shard,
                  shard_count=shard_count, seed=seed,
                  transform_spec=transform_spec, ngram=ngram, filters=filters,
                  batched_output=False)


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
    :param predicate: a :class:`~petastorm_tpu_torch.predicates.PredicateBase`
        the workers evaluate on its own columns first; the other columns of
        a row-group decode for its surviving rows only. Row-groups the
        footer statistics prove empty are never read.
    :param num_epochs: epochs to read; None = infinite.
    :param cur_shard: this reader's shard (with ``shard_count``): row-group
        ``n`` of the list goes to shard ``n % shard_count``. With neither
        set, a live ``torch.distributed`` default group of more than one
        rank shards by rank and world size.
    :param transform_spec: a :class:`~petastorm_tpu_torch.transform.TransformSpec`
        run on the workers.
    :param filters: pyarrow-style DNF filters
        (:mod:`petastorm_tpu_torch.filters`), exact at row level and ANDed
        with ``predicate``; row-groups their partition values or footer
        statistics exclude are dropped before sharding.
    :param defer_image_decode: workers hand fixed-shape image columns on
        still encoded, as :class:`~petastorm_tpu_torch.fused.EncodedImageColumn`
        (the torch loader asks for this and decodes them straight into its
        staging slots); declined with a TransformSpec.
    :param mixture_interleave: set by the mixture engine
        (:mod:`petastorm_tpu_torch.mixture`) when this reader serves one
        source of a weighted mixture: a dict with the source's exact
        interleave ``share`` in (0, 1]. It is validated and kept on the
        reader as ``mixture_interleave`` and changes nothing in the stream:
        in the JAX package it sizes the readahead plan, which is ROADMAP
        item 3.

    The reference's other kwargs are taken under its names and at its
    positions; each one set raises ``NotImplementedError`` naming the
    ``ROADMAP.md`` item that ports it.
    """
    _refuse_unported('make_batch_reader', rowgroup_selector, cache_type, cache_location,
                     cache_size_limit, cache_row_size_estimate, poison_policy)
    if mixture_interleave is not None:
        share = float(mixture_interleave.get('share', 1.0))
        if not 0.0 < share <= 1.0:
            raise ValueError('interleave share must be in (0, 1], got %r' % (share,))
        mixture_interleave = dict(mixture_interleave, share=share)
    if max_staleness_s is not None:
        raise unported('make_batch_reader(max_staleness_s=)', 10)
    info = ParquetDatasetInfo(dataset_url_or_urls, storage_options, filesystem=filesystem)
    return Reader(info, schema_fields=schema_fields,
                  reader_pool_type=reader_pool_type, workers_count=workers_count,
                  results_queue_size=results_queue_size,
                  shuffle_row_groups=shuffle_row_groups,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions,
                  predicate=predicate, num_epochs=num_epochs, cur_shard=cur_shard,
                  shard_count=shard_count, seed=seed,
                  transform_spec=transform_spec, filters=filters,
                  defer_image_decode=defer_image_decode,
                  mixture_interleave=mixture_interleave)


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


class Reader:
    """Iterator over a dataset's row-groups as column batches
    (``batched_output``), or over its rows or NGram windows.

    Construction: resolve the schema, take the requested view, enumerate
    and shard row-groups, build the ventilator, start the worker pool.
    Ventilation begins at the first read, so ``load_state_dict`` can
    reposition the cursor first.
    """

    def __init__(self, dataset_info, schema_fields=None, reader_pool_type='thread',
                 workers_count=None, results_queue_size=50, shuffle_row_groups=True,
                 shuffle_row_drop_partitions=1, predicate=None, num_epochs=1,
                 cur_shard=None, shard_count=None, seed=0, transform_spec=None,
                 ngram=None, filters=None, defer_image_decode=False,
                 mixture_interleave=None, batched_output=True):
        self.dataset_info = dataset_info
        self.mixture_interleave = mixture_interleave
        self.batched_output = batched_output and ngram is None
        self.ngram = ngram
        if ngram is not None and not ngram.timestamp_overlap and \
                shuffle_row_drop_partitions > 1:
            raise NotImplementedError('Using timestamp deduplication with '
                                      'shuffle_row_drop_partitions is not supported')
        self._filter_clauses = None
        # the predicate filters= alone made: the pre-shard prune already
        # proved what statistics can prove for it, so the planner skips it
        filters_born = None
        if filters:
            filters_predicate = FiltersPredicate(filters)
            self._filter_clauses = filters_predicate.clauses
            if predicate is not None:
                predicate = in_reduce([predicate, filters_predicate], all)
            else:
                predicate = filters_born = filters_predicate
        self.stored_schema = infer_or_load_unischema(dataset_info)
        if ngram is not None:
            ngram.resolve_regex_field_names(self.stored_schema)
            fields = ngram.get_field_names_at_all_timesteps()
            self.loaded_schema = (self.stored_schema.create_schema_view(fields)
                                  if fields else self.stored_schema)
        elif schema_fields is not None:
            self.loaded_schema = self.stored_schema.create_schema_view(schema_fields)
            if schema_fields and not len(self.loaded_schema):
                raise ValueError(
                    'No fields matching the criteria %r in schema %s'
                    % (schema_fields, list(self.stored_schema.fields)))
        else:
            self.loaded_schema = self.stored_schema
        self.schema = (transform_schema(self.loaded_schema, transform_spec)
                       if transform_spec is not None else self.loaded_schema)

        # row-groups: filters' partition and statistics prune, partition-key
        # predicates, then shards
        all_pieces = load_row_groups(dataset_info)
        self._row_groups = all_pieces
        piece_indices = list(range(len(all_pieces)))
        filters_emptied = False
        if self._filter_clauses is not None:
            piece_indices = prune_row_group_indices(
                dataset_info, all_pieces, piece_indices, self._filter_clauses,
                stored_schema=self.stored_schema)
            filters_emptied = not piece_indices
        piece_indices, worker_predicate = self._apply_predicate_pushdown(piece_indices,
                                                                         predicate)
        piece_indices = self._apply_sharding(piece_indices, cur_shard, shard_count)
        if not piece_indices:
            detail = 'check shard/predicate/selector configuration'
            if filters_emptied:
                detail = 'filters %s matched no row-groups' % describe_clauses(
                    self._filter_clauses)
            raise NoDataAvailableError(
                'No row-groups left to read for this reader (dataset %s): %s'
                % (dataset_info.url, detail))
        self._piece_indices = piece_indices

        items = []
        for idx in piece_indices:
            for drop in range(shuffle_row_drop_partitions):
                items.append({'piece_index': idx,
                              'worker_predicate': worker_predicate,
                              'shuffle_row_drop_partition':
                                  (drop, shuffle_row_drop_partitions),
                              'item_index': len(items)})
        self._num_items = len(items)
        # shard-independent identity of each local item: (global piece
        # index, drop partition, drop partition count)
        self._items_identity = [
            (it['piece_index'],) + tuple(it['shuffle_row_drop_partition'])
            for it in items]

        # statistics pruning runs AFTER sharding and keeps every item in
        # the list: pruned items are never ventilated and count as
        # completed with zero rows, so shards, item indices and states
        # are those of an unpruned reader
        self._pruned_items = frozenset()
        self._pushdown_plan = None
        if worker_predicate is not None and worker_predicate is not filters_born \
                and pushdown.pushdown_enabled():
            with span('rowgroup_prune'):
                self._pushdown_plan = pushdown.plan_rowgroup_pruning(
                    dataset_info, all_pieces, piece_indices, predicate=worker_predicate,
                    stored_schema=self.stored_schema)
            pruned_pieces = set(self._pushdown_plan.pruned)
            self._pruned_items = frozenset(it['item_index'] for it in items
                                           if it['piece_index'] in pruned_pieces)

        self._pool = _make_pool(reader_pool_type, workers_count, results_queue_size)
        self._num_epochs = num_epochs
        self._shuffle_row_groups = shuffle_row_groups
        # the resume epoch's already-consumed items, which never ventilate
        # again: ventilation_order leaves them out too
        self._resume_excluded = {}
        self._ventilator = ConcurrentVentilator(
            self._pool.ventilate, items, iterations=num_epochs,
            max_ventilation_queue_size=lambda: (
                self._pool.workers_count + _VENTILATE_EXTRA_ROWGROUPS),
            randomize_item_order=shuffle_row_groups, random_seed=seed,
            pass_epoch=True, always_exclude=self._pruned_items, trace_shard=self.cur_shard)
        # only batched consumers can take encoded image stubs
        defer = defer_image_decode and self.batched_output
        if defer and not defer_config_ok(transform_spec, ngram):
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
                             'ngram': ngram,
                             'row_groups': all_pieces,
                             'defer_image_decode': defer,
                         },
                         ventilator=self._ventilator, start_ventilator=False)
        self.last_row_consumed = False
        self._started = False
        self._stopped = False
        # the row reader's current row-group and its next row
        self._current_batch = None
        self._batch_cursor = 0
        # per-epoch sets of consumed item indices (exact resume)
        self._consumed_by_epoch = {}
        # the live plane's /health entry; unarmed, a shared no-op handle
        # and no thread or socket
        self._obs_mount = obs_server.mount('reader', health=self._obs_health)

    # -- construction helpers ------------------------------------------------

    def _apply_predicate_pushdown(self, piece_indices, predicate):
        """A predicate over partition keys only keeps or drops whole
        row-groups here; any other goes to the workers."""
        if predicate is None:
            return piece_indices, None
        pred_fields = predicate.get_fields()
        if pred_fields and pred_fields <= set(self.dataset_info.partition_keys):
            kept = [i for i in piece_indices
                    if predicate.do_include(
                        {k: typed_partition_value(
                            self.stored_schema.fields.get(k),
                            self._row_groups[i].partition_values.get(k))
                         for k in pred_fields})]
            return kept, None
        return piece_indices, predicate

    def _apply_sharding(self, piece_indices, cur_shard, shard_count):
        """Row-group ``n`` of the list goes to shard ``n % shard_count``;
        with neither given, a live ``torch.distributed`` group shards by
        rank. ``cur_shard``/``shard_count`` expose the resolved values."""
        self.cur_shard, self.shard_count = default_shard_info(cur_shard, shard_count)
        if self.shard_count is None:
            return piece_indices
        if self.shard_count > len(piece_indices):
            raise NoDataAvailableError(
                'Number of row-groups in the dataset (%d) must be greater or '
                'equal to the number of requested shards (%d)'
                % (len(piece_indices), self.shard_count))
        return [i for n, i in enumerate(piece_indices)
                if n % self.shard_count == self.cur_shard]

    # -- iteration -----------------------------------------------------------

    def __iter__(self):
        return self

    def _pull_result(self):
        """One pool result under the ``queue_wait`` span; a long block is
        consumer wait. Traced, the wait also lands on the arrived item's
        trace and the producer-bound auto-dump is polled."""
        with span('queue_wait'):
            t0 = time.monotonic()
            result = None
            try:
                result = self._pool.get_results()
                return result
            finally:
                waited = time.monotonic() - t0
                if waited > _PULL_NOTE_FLOOR_S:
                    note_consumer_wait(waited)
                if tracing.trace_enabled():
                    self._note_trace_pull(result, waited)
                    tracing.maybe_autodump()

    def _note_trace_pull(self, result, waited):
        """A ``queue_wait`` event on the consumer track of the pulled
        item's trace: the context is re-derived from the result's item
        index and epoch, so the result path carries nothing extra."""
        item_index = getattr(result, 'item_index', None)
        epoch = getattr(result, 'epoch', None)
        if item_index is None and isinstance(result, dict):
            item_index = result.get('item_index')
            epoch = result.get('epoch')
        ctx = tracing.ctx_for(item_index, epoch, self.cur_shard)
        if ctx is not None:
            tracing.record_complete('queue_wait', time.time() - waited, waited, ctx,
                                    track='consumer')

    def _ensure_started(self):
        if not self._started:
            self._ventilator.start()
            self._started = True

    def __next__(self):
        if self._stopped:
            raise RuntimeError('Trying to read a sample from a stopped reader')
        self._ensure_started()
        if self.batched_output:
            columns, _, _ = self.next_batch_info()
            return self.schema.make_namedtuple(**columns)
        if self.ngram is not None:
            # workers publish {timestep: dict} windows; they become
            # namedtuples here, on the consumer
            try:
                wrapped = self._pull_result()
            except EmptyResultError:
                self.last_row_consumed = True
                raise StopIteration from None
            if wrapped['last'] and wrapped['epoch'] is not None:
                self._consumed_by_epoch.setdefault(
                    wrapped['epoch'], set()).add(wrapped['item_index'])
            return self.ngram.make_namedtuple(self.schema, wrapped['window'])
        # one row at a time over the column batches; a row-group counts as
        # consumed when the read after its last row moves past it
        while self._current_batch is None or self._batch_cursor >= self._current_batch.length:
            if self._current_batch is not None:
                self._mark_consumed(self._current_batch)
            try:
                self._current_batch = self._pull_result()
                self._batch_cursor = 0
            except EmptyResultError:
                self.last_row_consumed = True
                self._current_batch = None
                raise StopIteration from None
        row = self._current_batch.row(self._batch_cursor)
        self._batch_cursor += 1
        return self.schema.make_namedtuple(**row)

    def next(self):
        return self.__next__()

    def _mark_consumed(self, batch):
        if batch.item_index is not None and batch.epoch is not None:
            self._consumed_by_epoch.setdefault(batch.epoch, set()).add(batch.item_index)

    def next_batch_info(self):
        """``(columns_dict, item_index, epoch)`` for one row-group batch:
        the provenance-carrying flavor of ``__next__`` for consumers that
        buffer rows downstream (batched readers only). Raises
        StopIteration at the end."""
        if not self.batched_output:
            raise TypeError('next_batch_info requires a batched reader')
        if self._stopped:
            raise RuntimeError('Trying to read a sample from a stopped reader')
        self._ensure_started()
        try:
            batch = self._pull_result()
        except EmptyResultError:
            self.last_row_consumed = True
            raise StopIteration from None
        self._mark_consumed(batch)
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
        self._current_batch = None
        self._batch_cursor = 0
        self._consumed_by_epoch = {}
        self._resume_excluded = {}

    def ventilation_order(self, epoch):
        """Item indices the ventilator will emit for ``epoch``, in order:
        the epoch's permutation under the ventilator's live seed, without
        the items a restored reader's resume epoch already consumed. The
        mixture engine's ordered sources turn the pool's completion-order
        deliveries back into this order."""
        order = epoch_order(self._num_items, self._ventilator.state_dict()['seed'],
                            epoch, self._shuffle_row_groups)
        skip = set(self._pruned_items)
        skip.update(self._resume_excluded.get(epoch, ()))
        return [int(i) for i in order if i not in skip]

    @property
    def num_epochs(self):
        """Requested epoch count (None = infinite)."""
        return self._num_epochs

    def _obs_health(self):
        """This reader's ``/health`` entry: iteration state and the pool's
        diagnostics (JSON-ready scalars). The reference's ``readahead``
        key comes with the readahead planner."""
        return dict({
            'started': self._started,
            'stopped': self._stopped,
            'last_row_consumed': self.last_row_consumed,
            'num_epochs': self._num_epochs,
            'row_groups': len(self._piece_indices),
            'cur_shard': self.cur_shard,
            'shard_count': self.shard_count,
            'pruned_items': len(self._pruned_items),
            'ventilate_extra': _VENTILATE_EXTRA_ROWGROUPS,
        }, **self._pool.diagnostics)

    def stop(self):
        self._obs_mount.close()
        self._pool.stop()
        self._stopped = True

    def join(self):
        self._pool.join()

    def cleanup(self):
        pass

    def exit(self):
        self.stop()
        self.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        self.join()

    @property
    def diagnostics(self):
        return self._pool.diagnostics

    def pipeline_report(self, wall_time_s=None):
        """Per-stage time breakdown and stall attribution of this
        process's pipeline
        (:func:`petastorm_tpu_torch.telemetry.pipeline_report`); the
        thread pool's worker stages record into the same registry."""
        from petastorm_tpu_torch.telemetry import pipeline_report
        return pipeline_report(wall_time_s=wall_time_s)

    def dump_trace(self, path):
        """Write the flight recorder's per-item trace as Chrome trace-event
        JSON (Perfetto); needs ``PETASTORM_TPU_TRACE=1`` during the read.
        Returns the number of events written."""
        from petastorm_tpu_torch.telemetry import dump_trace
        return dump_trace(path)

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
        # statistics-pruned items are completed with zero rows: no
        # delivery ever marks them, and without them every epoch would
        # read as incomplete
        pruned = self._pruned_items

        def consumed_in(epoch):
            return set(consumed_by_epoch.get(epoch, ())) | pruned

        epochs_seen = sorted(consumed_by_epoch)
        if not epochs_seen:
            resume_epoch, consumed = 0, []
        else:
            # walk epochs from 0: an absent epoch is maximally incomplete
            resume_epoch = None
            for e in range(epochs_seen[-1] + 1):
                if len(consumed_in(e)) < self._num_items:
                    resume_epoch = e
                    break
            if resume_epoch is None:
                resume_epoch, consumed = epochs_seen[-1] + 1, []
            else:
                consumed = sorted(consumed_in(resume_epoch))
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
        self._resume_excluded = {int(state['epoch']): frozenset(state['consumed_items'])}
        self._consumed_by_epoch = self.consumption_record_for_resume(state)

    def consumption_record_for_resume(self, state):
        """``{epoch: {item_index}}`` as of the restored position: epochs
        before the resume epoch complete, the resume epoch holding its
        already-consumed items."""
        state = self._localize_state(state)
        record = {e: set(range(self._num_items)) for e in range(state['epoch'])}
        record[state['epoch']] = set(state['consumed_items'])
        return record
