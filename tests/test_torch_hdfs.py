"""The port's HDFS namenode resolution and failover against the JAX
package's, case for case with ``tests/test_hdfs.py`` (mocked Hadoop
configuration and connections; no HDFS): the same namenode lists, the
same connect order, the same ids after a failover mid-epoch."""

import logging
import pickle

import fsspec
import pytest

from petastorm_tpu import hdfs as jax_hdfs
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu_torch import hdfs as torch_hdfs
from petastorm_tpu_torch.reader import make_batch_reader as torch_make_batch_reader
from tests.torch_telemetry_common import plane_guard, write_small_dataset  # noqa: F401

HDFS = {'jax': jax_hdfs, 'torch': torch_hdfs}
PACKAGES = ('jax', 'torch')

HC = {
    'fs.defaultFS': 'hdfs://myns/',
    'dfs.ha.namenodes.myns': 'nn1,nn2',
    'dfs.namenode.rpc-address.myns.nn1': 'nn-a.example.com:8020',
    'dfs.namenode.rpc-address.myns.nn2': 'nn-b.example.com:8020',
}


def _both(fn):
    """``fn(module)`` for each package's hdfs module; the two results."""
    return [fn(HDFS[package]) for package in PACKAGES]


def _outcome(fn):
    """``('ok', value)`` or ``('raised', type name, message)``."""
    try:
        return ('ok', fn())
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return ('raised', type(e).__name__, str(e))


class TestResolver:
    def test_nameservice_resolution(self):
        got = _both(lambda m: m.HdfsNamenodeResolver(HC).resolve_hdfs_name_service('myns'))
        assert got[0] == got[1] == ['nn-a.example.com:8020', 'nn-b.example.com:8020']

    def test_unknown_nameservice_returns_none(self):
        got = _both(lambda m: m.HdfsNamenodeResolver(HC).resolve_hdfs_name_service('other'))
        assert got == [None, None]

    def test_missing_rpc_address_raises(self):
        broken = dict(HC)
        del broken['dfs.namenode.rpc-address.myns.nn2']
        got = _both(lambda m: _outcome(
            lambda: m.HdfsNamenodeResolver(broken).resolve_hdfs_name_service('myns')))
        assert got[0] == got[1]
        assert got[1][:2] == ('raised', 'HdfsConnectError') and 'rpc-address' in got[1][2]

    def test_default_service(self):
        got = _both(lambda m: m.HdfsNamenodeResolver(HC).resolve_default_hdfs_service())
        assert got[0] == got[1] == ('myns', ['nn-a.example.com:8020', 'nn-b.example.com:8020'])

    def test_default_service_missing(self):
        got = _both(lambda m: _outcome(
            lambda: m.HdfsNamenodeResolver({}).resolve_default_hdfs_service()))
        assert got[0] == got[1]
        assert got[1][:2] == ('raised', 'HdfsConnectError') and 'defaultFS' in got[1][2]

    @pytest.mark.parametrize('env', ['HADOOP_HOME', 'HADOOP_PREFIX', 'HADOOP_INSTALL'])
    def test_site_xml_parsing(self, tmp_path, monkeypatch, env):
        conf_dir = tmp_path / 'hadoop' / 'etc' / 'hadoop'
        conf_dir.mkdir(parents=True)
        (conf_dir / 'hdfs-site.xml').write_text(
            '<configuration>'
            '<property><name>dfs.ha.namenodes.x</name><value>a</value></property>'
            '<property><name>dfs.namenode.rpc-address.x.a</name>'
            '<value>h1:9000</value></property>'
            '</configuration>')
        (conf_dir / 'core-site.xml').write_text(
            '<configuration><property><name>fs.defaultFS</name>'
            '<value>hdfs://x/</value></property></configuration>')
        for var in ('HADOOP_HOME', 'HADOOP_PREFIX', 'HADOOP_INSTALL'):
            monkeypatch.delenv(var, raising=False)
        monkeypatch.setenv(env, str(tmp_path / 'hadoop'))
        got = _both(lambda m: m.HdfsNamenodeResolver().resolve_default_hdfs_service())
        assert got[0] == got[1] == ('x', ['h1:9000'])

    def test_no_configuration_warns_and_resolves_nothing(self, monkeypatch, caplog):
        for var in ('HADOOP_HOME', 'HADOOP_PREFIX', 'HADOOP_INSTALL'):
            monkeypatch.delenv(var, raising=False)
        with caplog.at_level(logging.WARNING):
            got = _both(lambda m: m.HdfsNamenodeResolver().resolve_hdfs_name_service('x'))
        assert got == [None, None]
        assert sum('No Hadoop configuration found' in r.getMessage()
                   for r in caplog.records) == 2


class _FakeFS:
    def __init__(self, host, port):
        self.host, self.port = host, port


def _connector_fn(fail_hosts, attempts):
    def connect(host, port, storage_options):
        attempts.append((host, port))
        if host in fail_hosts:
            raise ConnectionError('refused: %s' % host)
        return _FakeFS(host, port)
    return connect


def _connect(namenodes, fail_hosts, **kwargs):
    """Each package's ``HdfsConnector.connect`` outcome and the
    ``(host, port)`` attempts it made."""
    got = []
    for package in PACKAGES:
        attempts = []
        outcome = _outcome(lambda: HDFS[package].HdfsConnector.connect(
            namenodes, connect_fn=_connector_fn(fail_hosts, attempts), **kwargs))
        if outcome[0] == 'ok':
            outcome = ('ok', (outcome[1].host, outcome[1].port))
        got.append((outcome, attempts))
    return got


class TestConnector:
    def test_first_namenode_wins(self):
        got = _connect(['a:1', 'b:2'], set())
        assert got[0] == got[1] == (('ok', ('a', 1)), [('a', 1)])

    def test_failover_to_second(self):
        got = _connect(['a:1', 'b:2'], {'a'})
        assert got[0] == got[1] == (('ok', ('b', 2)), [('a', 1), ('b', 2)])

    def test_all_fail_raises(self):
        got = _connect(['a:1', 'b:2'], {'a', 'b'})
        assert got[0] == got[1]
        assert got[1][0][:2] == ('raised', 'HdfsConnectError')
        assert 'any namenode' in got[1][0][2]

    def test_max_attempts_bounds_candidates(self):
        got = _connect(['a:1', 'b:2', 'c:3'], {'a', 'b'})
        assert got[0] == got[1]
        assert got[1][0][:2] == ('raised', 'HdfsConnectError')
        assert got[1][1] == [('a', 1), ('b', 2)]   # c is never tried
        assert torch_hdfs.MAX_NAMENODE_ATTEMPTS == jax_hdfs.MAX_NAMENODE_ATTEMPTS == 2

    def test_port_defaults_to_8020(self):
        got = _connect(['a'], set())
        assert got[0] == got[1] == (('ok', ('a', 8020)), [('a', 8020)])


class _FlakyFS:
    """A filesystem stand-in that raises I/O errors after ``healthy_calls``
    successful calls (a namenode dying mid-use)."""

    def __init__(self, host, healthy_calls=0, exc=OSError):
        self.host = host
        self._budget = healthy_calls
        self._exc = exc

    def ls(self, path):
        if self._budget <= 0:
            raise self._exc('namenode %s is down' % self.host)
        self._budget -= 1
        return ['%s:%s' % (self.host, path)]


def _flaky_connector(budgets, connects=None):
    """A ``connect_fn`` whose filesystem for each host has a healthy-call
    budget (None: always healthy)."""
    def connect(host, port, storage_options):
        if connects is not None:
            connects.append(host)
        budget = budgets.get(host)
        return _FlakyFS(host, float('inf') if budget is None else budget)
    return connect


class TestRuntimeFailover:
    """A live filesystem that starts raising I/O errors: calls move to the
    next namenode, as the JAX package's proxy moves them."""

    def test_midstream_error_fails_over(self, caplog):
        got = []
        for package in PACKAGES:
            connects = []
            fs = HDFS[package].HAHdfsFilesystem(
                ['a:1', 'b:2'], connect_fn=_flaky_connector({'a': 2, 'b': None}, connects))
            with caplog.at_level(logging.WARNING, logger=HDFS[package].__name__):
                answers = [fs.ls('/x'), fs.ls('/y'), fs.ls('/z')]
            got.append((answers, connects, repr(fs)))
        assert got[0] == got[1]
        assert got[1][0] == [['a:/x'], ['a:/y'], ['b:/z']]
        assert "active='b:2'" in got[1][2]
        # every failover is logged
        failovers = [r for r in caplog.records if r.name == torch_hdfs.__name__
                     and 'now connected to namenode b:2' in r.getMessage()]
        assert len(failovers) == 1

    def test_rotation_wraps_and_comes_back(self):
        got = []
        for package in PACKAGES:
            budgets = {'a': 1, 'b': 1}
            connects = []

            def connect(host, port, storage_options):
                connects.append(host)
                healthy = float('inf') if len(connects) > 3 else budgets[host]
                return _FlakyFS(host, healthy)

            fs = HDFS[package].HAHdfsFilesystem(['a:1', 'b:2'], connect_fn=connect)
            got.append(([fs.ls('/1'), fs.ls('/2'), fs.ls('/3')], connects))
        assert got[0] == got[1]
        assert got[1] == ([['a:/1'], ['b:/2'], ['a:/3']], ['a', 'b', 'a'])

    def test_file_not_found_is_not_retried(self):
        got = []
        for package in PACKAGES:
            calls = []

            class _FS:
                def info(self, path):
                    calls.append(path)
                    raise FileNotFoundError(path)

            fs = HDFS[package].HAHdfsFilesystem(['a:1', 'b:2'], connect_fn=lambda *a: _FS())
            with pytest.raises(FileNotFoundError):
                fs.info('/missing')
            got.append((calls, fs._active))
        assert got[0] == got[1] == (['/missing'], 0)   # one attempt, no failover

    def test_failover_budget_exhausted_reraises(self):
        got = []
        for package in PACKAGES:
            connects = []
            fs = HDFS[package].HAHdfsFilesystem(
                ['a:1', 'b:2'], max_failovers=2,
                connect_fn=_flaky_connector({'a': 0, 'b': 0}, connects))
            with pytest.raises(OSError, match='down'):
                fs.ls('/x')
            got.append(connects)
        assert got[0] == got[1] == ['a', 'b', 'a']
        assert torch_hdfs.MAX_FAILOVER_ATTEMPTS == jax_hdfs.MAX_FAILOVER_ATTEMPTS == 2

    def test_non_callable_attributes_pass_through(self):
        got = _both(lambda m: m.HAHdfsFilesystem(
            ['a:1'], connect_fn=_flaky_connector({'a': None})).host)
        assert got == ['a', 'a']

    def test_private_attributes_do_not_delegate(self):
        for package in PACKAGES:
            fs = HDFS[package].HAHdfsFilesystem(['a:1'], connect_fn=_flaky_connector({}))
            with pytest.raises(AttributeError):
                fs._budget

    def test_pickle_reconnects(self, monkeypatch):
        # the proxy pickles its namenode list and reconnects on unpickle
        # with the default connector (a custom connect_fn is not carried)
        got = []
        for package in PACKAGES:
            monkeypatch.setattr(HDFS[package].HdfsConnector, '_connect_one',
                                staticmethod(_flaky_connector({'a': None, 'b': None})))
            fs = HDFS[package].HAHdfsFilesystem(['a:1', 'b:2'],
                                                connect_fn=_flaky_connector({'a': 0}))
            clone = pickle.loads(pickle.dumps(fs))
            got.append((clone.ls('/x'), clone._max_failovers, clone._namenodes,
                        clone._storage_options))
            assert clone._max_failovers == fs._max_failovers
        assert got[0] == got[1] == (['a:/x'], 2, ['a:1', 'b:2'], None)

    def test_reader_completes_epoch_across_failover(self, monkeypatch, tmp_path):
        """A reader mid-epoch on a namenode that starts raising I/O errors
        fails over and finishes the epoch on the standby, with the ids the
        JAX reader reads through the same failover."""
        url = write_small_dataset('file://%s/ds' % tmp_path, rows=100)
        root = url[len('file://'):]
        local = fsspec.filesystem('file')

        class _DyingLocal:
            """A local filesystem that dies for good after ``budget`` opens."""

            def __init__(self, budget):
                self._budget = budget

            def __getattr__(self, name):
                attr = getattr(local, name)
                if name == 'open':
                    def flaky_open(*args, **kwargs):
                        if self._budget <= 0:
                            raise OSError('namenode nn-a lost')
                        self._budget -= 1
                        return attr(*args, **kwargs)
                    return flaky_open
                return attr

        got = {}
        for package, make_batch_reader in (('jax', jax_make_batch_reader),
                                           ('torch', torch_make_batch_reader)):
            def connect(host, port, storage_options):
                # nn-a survives the metadata reads and the first row-groups
                return _DyingLocal(4) if host == 'nn-a' else local

            proxy = HDFS[package].HAHdfsFilesystem(['nn-a:8020', 'nn-b:8020'],
                                                   connect_fn=connect)
            target = ('petastorm_tpu%s.etl.dataset_metadata.get_filesystem_and_path_or_paths'
                      % ('_torch' if package == 'torch' else ''))
            monkeypatch.setattr(target, lambda url, storage_options=None, filesystem=None:
                                (proxy, root))
            with make_batch_reader('hdfs://myns' + root, shuffle_row_groups=False,
                                   reader_pool_type='dummy') as reader:
                ids = [int(i) for batch in reader for i in batch.id]
            # the epoch finished on the standby namenode
            got[package] = (ids, proxy._namenodes[proxy._active])
        assert got['torch'] == got['jax']
        assert sorted(got['torch'][0]) == list(range(100))
        assert got['torch'][1] == 'nn-b:8020'


class TestConnectUrl:
    @pytest.mark.parametrize('url,fail,want', [
        ('hdfs://myns/data/set', {'nn-a.example.com'}, ('nn-b.example.com', 8020, '/data/set')),
        ('hdfs://host:9000/x', set(), ('host', 9000, '/x')),
        ('hdfs:///x', set(), ('nn-a.example.com', 8020, '/x')),
        ('hdfs://plainhost/x', set(), ('plainhost', 8020, '/x')),
    ], ids=['nameservice', 'direct-host-port', 'default-fs', 'plain-hostname'])
    def test_connect_url(self, url, fail, want):
        got = []
        for package in PACKAGES:
            attempts = []
            fs, path = HDFS[package].connect_hdfs_url(
                url, HC, connect_fn=_connector_fn(fail, attempts))
            got.append(((fs.host, fs.port, path), type(fs).__name__, attempts))
        assert got[0] == got[1]
        assert got[1][0] == want

    def test_nameservice_url_is_the_ha_proxy(self):
        for package in PACKAGES:
            fs, _ = HDFS[package].connect_hdfs_url('hdfs://myns/x', HC,
                                                   connect_fn=_connector_fn(set(), []))
            assert isinstance(fs, HDFS[package].HAHdfsFilesystem)

    def test_hdfs_url_resolves_through_the_site_xmls(self, tmp_path, monkeypatch):
        """``hdfs://ns/...`` through each package's URL resolver: the
        configuration from ``$HADOOP_HOME``, the connection from the
        default connector, the proxy on the nameservice's namenodes."""
        from petastorm_tpu import fs as jax_fs
        from petastorm_tpu_torch import fs as torch_fs
        conf_dir = tmp_path / 'hadoop' / 'etc' / 'hadoop'
        conf_dir.mkdir(parents=True)
        (conf_dir / 'hdfs-site.xml').write_text(
            '<configuration>' + ''.join(
                '<property><name>%s</name><value>%s</value></property>' % item
                for item in HC.items()) + '</configuration>')
        for var in ('HADOOP_PREFIX', 'HADOOP_INSTALL'):
            monkeypatch.delenv(var, raising=False)
        monkeypatch.setenv('HADOOP_HOME', str(tmp_path / 'hadoop'))
        got = []
        for package, fs_module in (('jax', jax_fs), ('torch', torch_fs)):
            attempts = []
            monkeypatch.setattr(HDFS[package].HdfsConnector, '_connect_one',
                                staticmethod(_connector_fn({'nn-a.example.com'}, attempts)))
            fs, paths = fs_module.get_filesystem_and_path_or_paths(
                ['hdfs://myns/d/1.parquet', 'hdfs://myns/d/2.parquet'])
            got.append((fs._namenodes, fs._namenodes[fs._active], paths, attempts))
        assert got[0] == got[1]
        assert got[1][1:3] == ('nn-b.example.com:8020', ['/d/1.parquet', '/d/2.parquet'])
