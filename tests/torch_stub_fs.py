"""Fake remote filesystems for the port's storage tests (no network, no
Hadoop). They import only fsspec, so a spawned process-pool worker that
unpickles one by class reference imports nothing of the JAX package.

* :func:`fake_object_store_class` — an in-memory store bound to a
  protocol (``gs``, ``s3``), with its own bytes and a record of the
  ``storage_options`` each instance was built with (the reference's
  ``tests/test_object_store.py`` fake);
* :func:`strict_store_class` — the same store enforcing remote
  semantics: every path keeps its bucket, localizing calls raise, and
  read opens and seeks are recorded;
* :class:`DiskGsStore` — a ``gs`` store whose objects are files under a
  local root, so its bytes are visible to a spawned process.

A read open returns a handle of its own over the object's bytes, as an
object store's stream is (fsspec's memory store hands every reader the
one stored file object and its one position).
"""

import contextlib

import fsspec
from fsspec.implementations.dirfs import DirFileSystem
from fsspec.implementations.local import LocalFileSystem
from fsspec.implementations.memory import MemoryFile, MemoryFileSystem


def fake_object_store_class(proto):
    """A memory store bound to ``proto`` with its own bytes; ``cachable``
    is False, so every resolution builds an instance and records its
    options."""

    class FakeObjectStore(MemoryFileSystem):
        protocol = proto
        store = {}
        pseudo_dirs = ['']
        captured_options = []
        cachable = False

        def __init__(self, **storage_options):
            type(self).captured_options.append(dict(storage_options))
            super().__init__()

        @classmethod
        def _strip_protocol(cls, path):
            path = str(path)
            if path.startswith(cls.protocol + '://'):
                path = path[len(cls.protocol) + 3:]
            return '/' + path.lstrip('/')

        def _open(self, path, mode='rb', **kwargs):
            path = self._strip_protocol(path)
            if mode == 'rb' and path in self.store:
                return MemoryFile(None, path, self.store[path].getvalue())
            return super()._open(path, mode=mode, **kwargs)

    FakeObjectStore.__name__ = FakeObjectStore.__qualname__ = 'Fake%sStore' % proto.title()
    return FakeObjectStore


def strict_store_class(proto, bucket='bucket'):
    """:func:`fake_object_store_class` enforcing remote semantics: a path
    that lost its bucket raises, ``get``/``get_file``/``download``/
    ``open_local`` raise, and every read open (``reads``) and seek
    (``seeks``: path, offset, whence) is recorded."""
    base = fake_object_store_class(proto)

    class StrictStore(base):
        reads = []
        seeks = []

        @classmethod
        def _strip_protocol(cls, path):
            p = super()._strip_protocol(path)
            if not (p == '/' or p == '/' + bucket or p.startswith('/%s/' % bucket)):
                raise AssertionError('non-bucket path reached the object store: %r' % (path,))
            return p

        def _forbidden(self, *args, **kwargs):
            raise AssertionError('localizing API used on a remote store')

        get = get_file = download = open_local = _forbidden

        def _open(self, path, mode='rb', **kwargs):
            f = super()._open(path, mode=mode, **kwargs)
            if 'r' in mode:
                cls = type(self)
                cls.reads.append(path)
                seek = f.seek

                def recording_seek(pos, whence=0):
                    cls.seeks.append((path, pos, whence))
                    return seek(pos, whence)

                f.seek = recording_seek
            return f

    StrictStore.__name__ = StrictStore.__qualname__ = 'Strict%sStore' % proto.title()
    return StrictStore


class DiskGsStore(DirFileSystem):
    """A ``gs`` store kept as files under ``root``: ``gs://bucket/x`` is
    ``<root>/bucket/x``, and paths read as gcsfs's do (``bucket/x``).
    Built from ``storage_options`` (``root`` and, ignored, ``token``) and
    pickled with them, so a spawned worker reads the same objects."""

    protocol = 'gs'
    cachable = False

    def __init__(self, root, token=None, **kwargs):
        super().__init__(path=root, fs=LocalFileSystem(), **kwargs)
        self.token = token

    @classmethod
    def _strip_protocol(cls, path):
        path = str(path)
        if path.startswith('gs://'):
            path = path[len('gs://'):]
        return path.strip('/')


@contextlib.contextmanager
def registered(proto, cls):
    """Bind ``proto`` to ``cls`` for the block; then put back what was
    bound before, or drop the binding (so a later resolution raises the
    missing backend's error, never reads an empty fake)."""
    from fsspec.registry import _registry
    before = _registry.get(proto)
    fsspec.register_implementation(proto, cls, clobber=True)
    try:
        yield cls
    finally:
        if before is not None:
            fsspec.register_implementation(proto, before, clobber=True)
        else:
            _registry.pop(proto, None)
        store = getattr(cls, 'store', None)
        if store is not None:
            store.clear()
