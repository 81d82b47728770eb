"""The shared Spark-session flags of command-line tools (counterpart of
``petastorm_tpu/tools/spark_session_cli.py``): a tool adds ``--master``
and ``--spark-session-config`` with :func:`add_configure_spark_arguments`
and applies them with :func:`configure_spark`.

The builder is duck-typed (anything with ``.config(key, value)`` and
``.master(url)``), so the flags need no pyspark; only the caller's
``SparkSession.builder...getOrCreate()`` does.
"""


def add_configure_spark_arguments(argparser):
    """Add the shared Spark-session flags to an ``argparse.ArgumentParser``."""
    argparser.add_argument(
        '--master', type=str, default=None,
        help='Spark master URL, e.g. "local[4]". Uses the environment '
             'default when omitted.')
    argparser.add_argument(
        '--spark-session-config', type=str, nargs='+', default=None,
        help='key=value pairs applied to the SparkSession builder, e.g. '
             '--spark-session-config spark.executor.cores=2 '
             'spark.executor.memory=10g')


def configure_spark(spark_session_builder, args):
    """Apply parsed :func:`add_configure_spark_arguments` flags to a
    ``SparkSession.Builder`` (returned, for chaining)."""
    if not hasattr(args, 'spark_session_config') or not hasattr(args, 'master'):
        raise RuntimeError(
            'args is missing --master/--spark-session-config; call '
            'add_configure_spark_arguments() on the parser first')
    for key, value in parse_session_config(args.spark_session_config).items():
        spark_session_builder = spark_session_builder.config(key, value)
    if args.master:
        spark_session_builder = spark_session_builder.master(args.master)
    return spark_session_builder


def parse_session_config(pairs):
    """``['k=v', ...]`` → dict, rejecting malformed entries."""
    config = {}
    for pair in pairs or []:
        key, sep, value = pair.partition('=')
        if not sep or not key or not value:
            raise ValueError('Spark session config entries must be key=value, got %r' % pair)
        config[key] = value
    return config
