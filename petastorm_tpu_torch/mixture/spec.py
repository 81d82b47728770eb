"""MixtureSpec: the declarative description of a multi-source stream
(counterpart of ``petastorm_tpu/mixture/spec.py``).

A mixture is a list of named, weighted sources plus the global knobs
that make the stream reproducible: the interleave ``seed``, the packed
row length ``seq_len`` (``None`` streams raw documents), and the column
``token_field`` holding each row's token array. The spec is pure data:
it builds no readers, so it can be embedded in a checkpoint fingerprint
and compared across ranks.

Each :class:`MixtureSource` names either a ``url`` (read with
``make_batch_reader``) or a ``reader_factory`` callable (anything that
returns a reader with the batched reader's surface). Weights are
normalized exactly (see :mod:`petastorm_tpu_torch.mixture.interleave`),
so ``[3, 1]`` and ``[0.75, 0.25]`` describe the same mixture.

:meth:`MixtureSpec.fingerprint` digests the fields that define the
stream's identity (names, weights, seed, seq_len, token_field). A
checkpoint records it and restore refuses a mismatch. The digest is the
JAX package's, byte for byte, so a state saved by either package is
checked against a spec of either.
"""

import hashlib
import json


class MixtureSource:
    """One weighted leg of a mixture."""

    def __init__(self, name, weight, url=None, reader_factory=None,
                 reader_kwargs=None):
        if not name:
            raise ValueError('Every mixture source needs a name')
        if weight is None or float(weight) <= 0:
            raise ValueError(
                'Source %r weight must be positive, got %r' % (name, weight))
        if (url is None) == (reader_factory is None):
            raise ValueError(
                'Source %r needs exactly one of url= or reader_factory=' %
                (name,))
        self.name = str(name)
        self.weight = weight
        self.url = url
        self.reader_factory = reader_factory
        self.reader_kwargs = dict(reader_kwargs or {})

    def __repr__(self):
        return 'MixtureSource(name=%r, weight=%r, url=%r)' % (
            self.name, self.weight, self.url)


class MixtureSpec:
    """Sources + seed + packing geometry of a deterministic mixture."""

    def __init__(self, sources, seed=0, seq_len=None, token_field='tokens',
                 open_bins=None, pad_id=0):
        sources = list(sources)
        if not sources:
            raise ValueError('A mixture needs at least one source')
        for source in sources:
            if not isinstance(source, MixtureSource):
                raise TypeError(
                    'sources must be MixtureSource instances, got %r' %
                    (source,))
        names = [s.name for s in sources]
        if len(set(names)) != len(names):
            raise ValueError('Duplicate source names: %r' % (names,))
        if seq_len is not None and int(seq_len) <= 0:
            raise ValueError('seq_len must be positive, got %r' % (seq_len,))
        self.sources = sources
        self.seed = int(seed)
        self.seq_len = int(seq_len) if seq_len is not None else None
        self.token_field = str(token_field)
        self.open_bins = open_bins
        self.pad_id = int(pad_id)

    @property
    def weights(self):
        return [s.weight for s in self.sources]

    @property
    def names(self):
        return [s.name for s in self.sources]

    def fingerprint(self):
        """Stable digest of the stream-identity fields."""
        payload = json.dumps({
            'names': self.names,
            'weights': [str(w) for w in self.weights],
            'seed': self.seed,
            'seq_len': self.seq_len,
            'token_field': self.token_field,
        }, sort_keys=True)
        return hashlib.sha256(payload.encode('utf-8')).hexdigest()[:16]

    def __repr__(self):
        return 'MixtureSpec(%d sources, seed=%d, seq_len=%r)' % (
            len(self.sources), self.seed, self.seq_len)
