"""Typed errors for tpuvdb."""


# Engine get/delete miss responses start with this prefix. The federated
# coordinator keys its read-failover decision on it (a reachable master's
# CLEAN miss is authoritative; any other error fails over to replicas), so
# the coupling is a named constant, not a magic string — and
# tests/test_federation.py asserts the engine side still emits it.
NOT_FOUND_PREFIX = "key not found"


class TpuVdbError(Exception):
    """Base class for all tpuvdb errors."""


class DimensionMismatch(TpuVdbError):
    """Vector dimension does not match the configured VECTOR_DIM.

    Parity: the reference rejects wrong-dim puts with a failure Response
    (src/datanode/handler.py:228)."""


class KeyNotFound(TpuVdbError):
    """get/delete on a missing key."""


class CapacityExceeded(TpuVdbError):
    """Shard is full and cannot grow further.

    Parity: hnswlib max_elements exhaustion surfaced to clients with a
    capacity hint (clip/db_operation.py:83-85)."""


class NodeOffline(TpuVdbError):
    """The shard master for a key is not online.

    Parity: src/coordinator/handler.py:124-130."""


class WalCorruption(TpuVdbError):
    """A WAL record failed to decode during replay."""


class CheckpointError(TpuVdbError):
    """Checkpoint save/restore failure."""
