"""URL → filesystem resolution (counterpart of ``petastorm_tpu/fs.py``).

Only ``file://`` URLs and bare local paths are ported; HDFS and object
stores wait for their roadmap item.
"""

from urllib.parse import urlparse

import fsspec

from petastorm_tpu_torch.errors import unported


def normalize_dir_url(url):
    """Strip a trailing slash so paths are stable."""
    if not isinstance(url, str):
        raise ValueError('Expected a string url, got %r' % (url,))
    return url.rstrip('/')


def get_filesystem_and_path_or_paths(url_or_urls, storage_options=None,
                                     filesystem=None):
    """Resolve one URL (or a list of URLs on one filesystem) to
    ``(fsspec_fs, path_or_paths)``."""
    urls = url_or_urls if isinstance(url_or_urls, list) else [url_or_urls]
    parsed = [urlparse(u) for u in urls]
    if len({(p.scheme, p.netloc) for p in parsed}) != 1:
        raise ValueError('All dataset URLs must share scheme and netloc: %r' % urls)
    if filesystem is not None or storage_options:
        raise unported('filesystem=/storage_options=', 9)
    if parsed[0].scheme not in ('', 'file'):
        raise unported('the %r URL scheme' % parsed[0].scheme, 9)
    fs, _ = fsspec.core.url_to_fs(urls[0])
    paths = [fsspec.core.url_to_fs(u)[1] for u in urls]
    return fs, (paths if isinstance(url_or_urls, list) else paths[0])
