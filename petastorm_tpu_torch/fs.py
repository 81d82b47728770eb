"""URL → filesystem resolution (counterpart of ``petastorm_tpu/fs.py``).

Every scheme fsspec serves resolves through :func:`fsspec.core.url_to_fs`
(local disk, ``gs://``, ``s3://``, ``memory://``, ...); ``hdfs://`` goes
through :func:`petastorm_tpu_torch.hdfs.connect_hdfs_url`, which expands a
high-availability nameservice and fails over between its namenodes. An
explicit ``filesystem=`` (any fsspec instance, e.g. a pre-authenticated
``gcsfs``) bypasses the resolution.
"""

from urllib.parse import urlparse

import fsspec

#: schemes whose URL netloc is a bucket, kept in the dataset path
_BUCKET_SCHEMES = ('s3', 's3a', 's3n', 'gs', 'gcs')


def normalize_dir_url(url):
    """Strip a trailing slash so paths are stable."""
    if not isinstance(url, str):
        raise ValueError('Expected a string url, got %r' % (url,))
    return url.rstrip('/')


def get_dataset_path(url):
    """Path component of a dataset URL; the bucket stays in the path for
    object stores (``gs://b/x`` → ``b/x``)."""
    parsed = urlparse(url)
    if parsed.scheme in _BUCKET_SCHEMES:
        return parsed.netloc + parsed.path
    return parsed.path


def get_filesystem_and_path_or_paths(url_or_urls, storage_options=None,
                                     filesystem=None):
    """Resolve one URL (or a list of URLs on one filesystem) to
    ``(fsspec_fs, path_or_paths)``. URLs in a list must share scheme and
    netloc.

    :param storage_options: keyword arguments for the filesystem the URL's
        scheme constructs (credentials, project, endpoint, ...).
    :param filesystem: an fsspec filesystem to use instead of resolving
        one; paths go through its own ``_strip_protocol``. A URL's scheme
        must be one of its protocols (a bare path passes). Mutually
        exclusive with ``storage_options``, which only a construction
        could apply.
    """
    urls = url_or_urls if isinstance(url_or_urls, list) else [url_or_urls]
    parsed = [urlparse(u) for u in urls]
    if len({(p.scheme, p.netloc) for p in parsed}) != 1:
        raise ValueError('All dataset URLs must share scheme and netloc: %r' % urls)
    if filesystem is not None:
        if storage_options:
            raise ValueError('filesystem and storage_options are mutually exclusive: the '
                             'explicit filesystem was already constructed, so the options '
                             'cannot apply')
        scheme = parsed[0].scheme
        protocols = (filesystem.protocol if isinstance(filesystem.protocol, (tuple, list))
                     else (filesystem.protocol,))
        # a mismatched scheme would be mangled by _strip_protocol
        # (LocalFileSystem turns 'gs://b/x' into '<cwd>/gs:/b/x') and
        # surface as a not-found error far downstream
        if scheme and scheme not in protocols:
            raise ValueError('URL scheme %r does not match the explicit filesystem '
                             '(protocol %r)' % (scheme, filesystem.protocol))
        paths = [filesystem._strip_protocol(u) for u in urls]
        return filesystem, (paths if isinstance(url_or_urls, list) else paths[0])
    if parsed[0].scheme == 'hdfs':
        from petastorm_tpu_torch.hdfs import connect_hdfs_url
        fs, path0 = connect_hdfs_url(urls[0], storage_options=storage_options)
        paths = [path0] + [p.path for p in parsed[1:]]
    else:
        fs, path0 = fsspec.core.url_to_fs(urls[0], **(storage_options or {}))
        paths = [path0] + [fsspec.core.url_to_fs(u, **(storage_options or {}))[1]
                           for u in urls[1:]]
    return fs, (paths if isinstance(url_or_urls, list) else paths[0])
