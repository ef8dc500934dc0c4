from tpuvdb_torch.store.wal import WriteAheadLog
from tpuvdb_torch.store.kv import DocStore
from tpuvdb_torch.store.checkpoint import CheckpointManager

__all__ = ["WriteAheadLog", "DocStore", "CheckpointManager"]
