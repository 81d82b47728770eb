"""The naming contracts the port records under: canonical stage names
and environment knobs.

The port keeps its own copy of the names it uses from
``petastorm_tpu/analysis/contracts.py`` (it imports nothing of the JAX
package), so its spans read the same as the reference's.
"""

#: pipeline stages the port records, ventilator → device:
#: ``ventilate`` hand item to pool · ``io`` parquet row-group read ·
#: ``decode`` codec decode · ``transform`` TransformSpec · ``queue_wait``
#: consumer blocked pulling · ``collate`` re-batch/shuffle buffer ·
#: ``h2d_ready`` staging ring blocked until a slot's previous transfer
#: completed · ``stage_fill`` cast/pad/mask copy into the slot ·
#: ``h2d_dispatch`` async transfer dispatch · ``encode`` write-path codec
#: encode · ``write_flush`` one row-group flushed into a part file
STAGES = ('ventilate', 'io', 'decode', 'transform', 'queue_wait', 'collate',
          'h2d_ready', 'stage_fill', 'h2d_dispatch', 'encode', 'write_flush')

#: environment knobs the port reads
KNOWN_KNOBS = frozenset([
    'PETASTORM_TPU_METRICS',
    'PETASTORM_TPU_STAGING_SLOTS',
])

#: knob-truthiness spellings shared by every switch
DISABLED_VALUES = ('0', 'false', 'off', 'no')
