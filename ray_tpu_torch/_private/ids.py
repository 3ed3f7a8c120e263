"""Binary entity IDs for the runtime.

Mirrors the lineage-embedding layout of the reference's id scheme
(reference: src/ray/common/id.h): a JobID is embedded in every ActorID,
an ActorID in every TaskID, and an ObjectID is its producing TaskID plus
a return/put index.  This lets any component recover "who made this"
from the ID bytes alone, without a directory lookup.

Sizes (bytes):
    JobID    4
    ActorID  16 = 12 random + 4 job
    TaskID   24 = 8 random + 16 actor (zeros for non-actor tasks' actor part
                  except the embedded job id)
    ObjectID 28 = 24 task + 4 little-endian index
    NodeID / WorkerID / PlacementGroupID: 28 random
"""

from __future__ import annotations

import os
import random as _random
import threading as _threading

_JOB_ID_SIZE = 4
_ACTOR_ID_SIZE = 16
_TASK_ID_SIZE = 24
_OBJECT_ID_SIZE = 28
_UNIQUE_ID_SIZE = 28

_rand_lock = _threading.Lock()
_rand_state = None  # [pid, Random, buffer, position]
_RAND_CHUNK = 4096


def _random_id_bytes(n: int) -> bytes:
    """Process-local PRNG for ID minting.  os.urandom is a SYSCALL per
    call — ~1 ms on syscall-throttled sandboxes, and it sat directly on
    every task-submission hot path (one TaskID per .remote()).  IDs
    need uniqueness, not cryptographic strength: a 128-bit-seeded PRNG
    stream gives the same 8-byte collision behavior.  Seeded from
    os.urandom once per process and re-seeded on pid change, so a
    forked child can never clone the parent's stream.  Bytes are drawn
    from a buffered chunk: one bigint draw amortizes over ~300 ids
    (id minting showed up at ~7% of driver submit-path samples)."""
    global _rand_state
    pid = os.getpid()
    with _rand_lock:
        st = _rand_state
        if st is None or st[0] != pid:
            rng = _random.Random(int.from_bytes(os.urandom(16), "little"))
            st = [pid, rng, rng.randbytes(_RAND_CHUNK), 0]
            _rand_state = st
        pos = st[3]
        if pos + n > _RAND_CHUNK:
            st[2] = st[1].randbytes(_RAND_CHUNK)
            pos = 0
        st[3] = pos + n
        return st[2][pos:pos + n]


class BaseID:
    SIZE = _UNIQUE_ID_SIZE
    __slots__ = ("_bytes",)

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(id_bytes)}"
            )
        self._bytes = bytes(id_bytes)

    @classmethod
    def from_random(cls):
        return cls(_random_id_bytes(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.SIZE

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __hash__(self):
        return hash((type(self).__name__, self._bytes))

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = _JOB_ID_SIZE

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(_JOB_ID_SIZE, "little"))

    def int_value(self) -> int:
        return int.from_bytes(self._bytes, "little")


class UniqueID(BaseID):
    SIZE = _UNIQUE_ID_SIZE


class NodeID(UniqueID):
    pass


class WorkerID(UniqueID):
    pass


class ClusterID(UniqueID):
    pass


class PlacementGroupID(UniqueID):
    pass


class ActorID(BaseID):
    SIZE = _ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(_random_id_bytes(_ACTOR_ID_SIZE - _JOB_ID_SIZE)
                   + job_id.binary())

    @classmethod
    def nil_for_job(cls, job_id: JobID) -> "ActorID":
        """Actor part zeroed but job id embedded (used for non-actor tasks)."""
        return cls(b"\x00" * (_ACTOR_ID_SIZE - _JOB_ID_SIZE) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[-_JOB_ID_SIZE:])


class TaskID(BaseID):
    SIZE = _TASK_ID_SIZE

    @classmethod
    def for_normal_task(cls, job_id: JobID) -> "TaskID":
        return cls(_random_id_bytes(8)
                   + ActorID.nil_for_job(job_id).binary())

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(_random_id_bytes(8) + actor_id.binary())

    @classmethod
    def for_actor_creation(cls, actor_id: ActorID) -> "TaskID":
        return cls(b"\xff" * 8 + actor_id.binary())

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        return cls(b"\x00" * 8 + ActorID.nil_for_job(job_id).binary())

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[8:])

    def job_id(self) -> JobID:
        return self.actor_id().job_id()


class ObjectID(BaseID):
    SIZE = _OBJECT_ID_SIZE

    @classmethod
    def from_index(cls, task_id: TaskID, index: int) -> "ObjectID":
        """index >= 1 for task returns; matches the reference's return-index scheme."""
        return cls(task_id.binary() + index.to_bytes(4, "little"))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:_TASK_ID_SIZE])

    def index(self) -> int:
        return int.from_bytes(self._bytes[_TASK_ID_SIZE:], "little")

    def job_id(self) -> JobID:
        return self.task_id().job_id()
