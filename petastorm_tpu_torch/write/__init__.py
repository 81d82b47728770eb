"""petastorm_tpu_torch.write: the write plane (counterpart of
``petastorm_tpu/write``), on the port's dummy and thread pools.

1. **Writer** (:mod:`.writer`): ``DistributedDatasetWriter`` shards encode
   and write over a pool (``pool=None`` inline) with tmp + rename
   publication and a commit manifest.
2. **Layout** (:mod:`.layout`): row-groups sized to the readahead window,
   and the post-write ``self_check`` through the read path's planners.
3. **Compaction** (:mod:`.compact`): small appended files folded into
   readahead-sized ones under an atomic manifest swap.
4. **Append** (:mod:`.append`): monotonic manifest generations; followers
   pick up rows committed seconds ago.
"""

from petastorm_tpu_torch.write.append import AppendFollower, follow_dataset
from petastorm_tpu_torch.write.compact import (
    CompactionDaemon, compact_dataset, plan_compaction,
)
from petastorm_tpu_torch.write.layout import self_check, target_rowgroup_bytes
from petastorm_tpu_torch.write.manifest import (
    ManifestError, gc_superseded, load as load_manifest, staleness_s,
)
from petastorm_tpu_torch.write.writer import (
    DistributedDatasetWriter, WriteShardWorker, write_dataset_distributed,
)

__all__ = [
    'AppendFollower', 'CompactionDaemon', 'DistributedDatasetWriter',
    'ManifestError', 'WriteShardWorker', 'compact_dataset',
    'follow_dataset', 'gc_superseded', 'load_manifest', 'plan_compaction',
    'self_check', 'staleness_s', 'target_rowgroup_bytes',
    'write_dataset_distributed',
]
