"""HDFS high-availability namenode resolution and failover (counterpart of
``petastorm_tpu/hdfs.py``).

A logical nameservice from the Hadoop configuration expands to its
namenode list. Connecting tries the namenodes in turn
(:class:`HdfsConnector`); for a nameservice of several namenodes the
filesystem is an :class:`HAHdfsFilesystem` proxy, whose calls fail over to
the next namenode on an I/O error (at most ``MAX_FAILOVER_ATTEMPTS`` a
call), every failover logged.

The configuration is a dict (e.g. a Spark ``HadoopConfiguration``'s
entries) or the site XMLs under ``$HADOOP_HOME``, ``$HADOOP_PREFIX`` or
``$HADOOP_INSTALL`` ``etc/hadoop/``.
"""

import functools
import logging
import os
import xml.etree.ElementTree as ET
from urllib.parse import urlparse

logger = logging.getLogger(__name__)

_HADOOP_ENV_VARS = ('HADOOP_HOME', 'HADOOP_PREFIX', 'HADOOP_INSTALL')
#: namenodes a plain connection tries, in order
MAX_NAMENODE_ATTEMPTS = 2
#: reconnects to the next namenode a proxied call may make
MAX_FAILOVER_ATTEMPTS = 2
_DEFAULT_PORT = 8020


class HdfsConnectError(RuntimeError):
    pass


class HdfsNamenodeResolver:
    """Resolve HDFS nameservices to namenode ``host:port`` lists."""

    def __init__(self, hadoop_configuration=None):
        self._hadoop_env = None
        self._hadoop_path = None
        if hadoop_configuration is None:
            hadoop_configuration = self._load_from_environment()
        self._config = hadoop_configuration or {}

    def _load_from_environment(self):
        for env in _HADOOP_ENV_VARS:
            if env in os.environ:
                self._hadoop_env = env
                self._hadoop_path = os.environ[env]
                config = {}
                for site in ('hdfs-site.xml', 'core-site.xml'):
                    self._parse_site_xml(os.path.join(self._hadoop_path, 'etc', 'hadoop', site),
                                         config)
                return config
        logger.warning('No Hadoop configuration found (none of %s set); HDFS nameservice '
                       'resolution is unavailable', ', '.join(_HADOOP_ENV_VARS))
        return {}

    @staticmethod
    def _parse_site_xml(xml_path, into):
        try:
            root = ET.parse(xml_path).getroot()
        except (OSError, ET.ParseError) as e:
            logger.debug('Could not parse %s: %s', xml_path, e)
            return
        for prop in root.iter('property'):
            name = prop.find('name')
            value = prop.find('value')
            if name is not None and value is not None:
                into[name.text] = value.text

    def resolve_hdfs_name_service(self, nameservice):
        """The namenode ``host:port`` list of a nameservice, or None when
        the name is no configured nameservice (it may be a hostname)."""
        namenode_ids = self._config.get('dfs.ha.namenodes.%s' % nameservice)
        if not namenode_ids:
            return None
        addresses = []
        for nn in namenode_ids.split(','):
            key = 'dfs.namenode.rpc-address.%s.%s' % (nameservice, nn.strip())
            address = self._config.get(key)
            if not address:
                raise HdfsConnectError('Hadoop configuration declares namenode %r of '
                                       'nameservice %r but provides no %r'
                                       % (nn, nameservice, key))
            addresses.append(address)
        return addresses

    def resolve_default_hdfs_service(self):
        """``(nameservice, [namenode addresses])`` from ``fs.defaultFS``."""
        default_fs = self._config.get('fs.defaultFS')
        if not default_fs or not default_fs.startswith('hdfs://'):
            raise HdfsConnectError('fs.defaultFS is missing or not an hdfs:// URL: %r'
                                   % default_fs)
        nameservice = default_fs[len('hdfs://'):].split('/')[0]
        namenodes = self.resolve_hdfs_name_service(nameservice)
        if not namenodes:
            raise HdfsConnectError('Unable to get namenodes for the default nameservice %r'
                                   % nameservice)
        return nameservice, namenodes


def _connect_first_alive(candidates, storage_options, connect_fn):
    """``(filesystem, index)`` of the first ``(index, address)`` candidate
    that connects; :class:`HdfsConnectError` listing every attempt when
    none does."""
    errors = []
    for index, address in candidates:
        host, _, port = address.partition(':')
        try:
            return connect_fn(host, int(port) if port else _DEFAULT_PORT, storage_options), index
        except Exception as e:  # noqa: BLE001 - the next namenode may answer
            logger.warning('Failed to connect to namenode %s: %s', address, e)
            errors.append('%s: %s' % (address, e))
    raise HdfsConnectError('Could not connect to any namenode of %s; attempts: %s'
                           % ([address for _, address in candidates], errors))


class HdfsConnector:
    """Connection attempts over resolved namenodes, in order."""

    @staticmethod
    def _connect_one(host, port, storage_options):
        import fsspec
        return fsspec.filesystem('hdfs', host=host, port=port, **(storage_options or {}))

    @classmethod
    def connect(cls, namenodes, storage_options=None, max_attempts=MAX_NAMENODE_ATTEMPTS,
                connect_fn=None):
        """The first of the first ``max_attempts`` namenodes that accepts
        a connection; each is tried once."""
        fs, _ = _connect_first_alive(list(enumerate(namenodes))[:max_attempts],
                                     storage_options, connect_fn or cls._connect_one)
        return fs


class HAHdfsFilesystem:
    """Failover proxy over an fsspec filesystem, rotating through a
    nameservice's namenodes.

    Attributes delegate to the live filesystem. A proxied method that
    raises an :class:`OSError` other than :class:`FileNotFoundError` (a
    missing path is an answer, not an outage) reconnects to the next
    namenode and retries, at most ``max_failovers`` times a call. Pickling
    keeps the namenode list and reconnects on unpickle with the default
    connector: a custom ``connect_fn`` is not pickled. A file handle from
    ``open()`` keeps the connection that made it; the next ``open`` fails
    over.
    """

    def __init__(self, namenodes, storage_options=None, max_failovers=MAX_FAILOVER_ATTEMPTS,
                 connect_fn=None):
        if not namenodes:
            raise ValueError('HAHdfsFilesystem needs at least one namenode')
        self._namenodes = list(namenodes)
        self._storage_options = storage_options
        self._max_failovers = max_failovers
        self._connect_fn = connect_fn or HdfsConnector._connect_one
        self._active = 0
        self._fs = None
        self._connect(initial=True)

    def _connect(self, initial=False):
        """Connect to the first live namenode from ``self._active`` on,
        each tried once."""
        n = len(self._namenodes)
        rotation = [((self._active + offset) % n, self._namenodes[(self._active + offset) % n])
                    for offset in range(n)]
        self._fs, self._active = _connect_first_alive(rotation, self._storage_options,
                                                      self._connect_fn)
        if not initial:
            logger.warning('HDFS failover: now connected to namenode %s',
                           self._namenodes[self._active])

    def _failover(self):
        self._active = (self._active + 1) % len(self._namenodes)
        self._connect()

    def _call_with_failover(self, name, *args, **kwargs):
        failovers = 0
        while True:
            try:
                return getattr(self._fs, name)(*args, **kwargs)
            except FileNotFoundError:
                raise
            except OSError as e:
                if failovers >= self._max_failovers:
                    raise
                failovers += 1
                logger.warning('HDFS %s() failed on namenode %s (%s); failing over (%d/%d)',
                               name, self._namenodes[self._active], e, failovers,
                               self._max_failovers)
                self._failover()

    def __getattr__(self, name):
        if name.startswith('_'):
            raise AttributeError(name)
        value = getattr(self._fs, name)
        if callable(value):
            return functools.partial(self._call_with_failover, name)
        return value

    def __reduce__(self):
        return type(self), (self._namenodes, self._storage_options, self._max_failovers)

    def __repr__(self):
        return 'HAHdfsFilesystem(namenodes=%r, active=%r)' % (self._namenodes,
                                                              self._namenodes[self._active])


def connect_hdfs_url(url, hadoop_configuration=None, storage_options=None, connect_fn=None,
                     max_failovers=MAX_FAILOVER_ATTEMPTS):
    """``(fs, path)`` for an ``hdfs://`` URL.

    * ``hdfs:///path``: the ``fs.defaultFS`` nameservice;
    * ``hdfs://nameservice/path``: its namenodes, or the netloc as a plain
      host on port 8020 when it names no nameservice;
    * ``hdfs://host:port/path``: that namenode.

    Several namenodes give an :class:`HAHdfsFilesystem`; one gives the
    plain filesystem.
    """
    parsed = urlparse(url)
    resolver = HdfsNamenodeResolver(hadoop_configuration)
    if not parsed.netloc:
        _, namenodes = resolver.resolve_default_hdfs_service()
    elif ':' in parsed.netloc:
        namenodes = [parsed.netloc]
    else:
        namenodes = (resolver.resolve_hdfs_name_service(parsed.netloc)
                     or ['%s:%d' % (parsed.netloc, _DEFAULT_PORT)])
    if len(namenodes) > 1:
        fs = HAHdfsFilesystem(namenodes, storage_options, max_failovers=max_failovers,
                              connect_fn=connect_fn)
    else:
        fs = HdfsConnector.connect(namenodes, storage_options, connect_fn=connect_fn)
    return fs, parsed.path
