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
#: ``decode_fused`` encoded image cells decoded straight into the slot's
#: rows · ``h2d_dispatch`` async transfer dispatch · ``pack`` mixture
#: documents packed into fixed rows · ``encode`` write-path codec encode ·
#: ``write_flush`` one row-group flushed into a part file
STAGES = ('ventilate', 'io', 'decode', 'transform', 'queue_wait', 'collate',
          'h2d_ready', 'stage_fill', 'decode_fused', 'h2d_dispatch', 'pack', 'encode',
          'write_flush')

#: environment knobs the port reads (the native decoders read the two
#: ``JPEG`` ones in C)
KNOWN_KNOBS = frozenset([
    'PETASTORM_TPU_IMAGE_DECODER_THREADS',
    'PETASTORM_TPU_JPEG_DCT',
    'PETASTORM_TPU_JPEG_FANCY',
    'PETASTORM_TPU_METRICS',
    'PETASTORM_TPU_MIXTURE_OPEN_BINS',
    'PETASTORM_TPU_MIXTURE_RESEQ_MAX',
    'PETASTORM_TPU_NATIVE',
    'PETASTORM_TPU_STAGING',
    'PETASTORM_TPU_STAGING_SLOTS',
])

#: knob-truthiness spellings shared by every switch
DISABLED_VALUES = ('0', 'false', 'off', 'no')
