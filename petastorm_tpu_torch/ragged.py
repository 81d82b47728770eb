"""Diagnosis of object-dtype columns where batches become tensors.

Counterpart of ``petastorm_tpu/ragged.py``. A decoded column arrives as a
1-d object array in exactly three cases: ragged numeric cells
(variable-shape fields), string or decimal cells, or all-None (nullable)
cells. Every dense consumer rejects them with one classifier and one
message per case, so identical data gets one diagnosis.
"""

import numpy as np

RAGGED_MESSAGE = (
    'Field %r has variable shape (rows of differing sizes) and cannot be '
    'collated into one dense tensor; project it away (fields=), densify it '
    'with a TransformSpec, or use make_torch_loader(pad_ragged=...) / '
    'bucket_boundaries= for static-shape padded batches')
STRING_MESSAGE = (
    'Field %r holds strings or decimals, which have no dense tensor '
    'representation; project it away (fields=/TransformSpec) or convert it '
    'in a TransformSpec')
NULL_MESSAGE = (
    'Field %r is entirely None in this batch (nullable field); fill or '
    'filter nulls before dense collation, or project the field away '
    '(fields=)')


def classify_object_column(arr):
    """``'ragged' | 'string' | 'null'`` for a 1-d object column."""
    first = next((c for c in arr if c is not None), None)
    if first is None:
        return 'null'
    if isinstance(first, (np.ndarray, list, tuple)):
        return 'ragged'
    return 'string'


def reject_object_column(name, arr):
    """Raise the classified, actionable ``TypeError`` for ``arr``."""
    kind = classify_object_column(arr)
    message = {'ragged': RAGGED_MESSAGE, 'string': STRING_MESSAGE,
               'null': NULL_MESSAGE}[kind]
    raise TypeError(message % name)
