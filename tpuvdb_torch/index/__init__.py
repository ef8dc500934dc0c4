from tpuvdb_torch.index.layout import ShardMirror, StackedLayout
from tpuvdb_torch.index.exact import DeviceExactIndex

__all__ = ["ShardMirror", "StackedLayout", "DeviceExactIndex"]
