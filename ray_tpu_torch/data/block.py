"""Block representation and accessors.

Equivalent of the reference's block layer
(reference: python/ray/data/_internal/arrow_block.py, block.py):
a block is a pyarrow Table; the accessor converts to/from rows, numpy
batches, and pandas.  Arrow's buffer layout serializes into the
shared-memory store with the pickle5 out-of-band path, so cross-process
block handoff is zero-copy on read.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np
import pyarrow as pa


def build_block(rows: List[Dict[str, Any]]) -> pa.Table:
    if not rows:
        return pa.table({})
    return pa.Table.from_pylist(rows)


def block_from_numpy(arrays: Dict[str, np.ndarray]) -> pa.Table:
    import json

    cols = {}
    fields = []
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        if arr.ndim == 1:
            a = pa.array(arr)
            cols[name] = a
            fields.append(pa.field(name, a.type))
        else:
            # tensor columns: fixed-size lists keep the buffer contiguous;
            # the element shape rides in field metadata so to_numpy can
            # restore rank>2 tensors (reference: ArrowTensorArray)
            width = max(int(np.prod(arr.shape[1:])), 1)
            flat = arr.reshape(arr.shape[0], width)
            a = pa.FixedSizeListArray.from_arrays(pa.array(flat.ravel()), width)
            cols[name] = a
            fields.append(pa.field(
                name, a.type,
                metadata={b"tensor_shape": json.dumps(arr.shape[1:]).encode()}))
    return pa.table(cols, schema=pa.schema(fields))


class BlockAccessor:
    def __init__(self, block: pa.Table):
        self.block = block

    def num_rows(self) -> int:
        return self.block.num_rows

    def size_bytes(self) -> int:
        return self.block.nbytes

    def to_rows(self) -> List[Dict[str, Any]]:
        return self.block.to_pylist()

    def to_numpy(self) -> Dict[str, np.ndarray]:
        import json

        out = {}
        for i, name in enumerate(self.block.column_names):
            col = self.block.column(name)
            if pa.types.is_fixed_size_list(col.type):
                combined = col.combine_chunks()
                width = col.type.list_size
                arr = np.asarray(combined.values).reshape(-1, width)
                meta = self.block.schema.field(i).metadata or {}
                shape = meta.get(b"tensor_shape")
                if shape is not None:
                    arr = arr.reshape(-1, *json.loads(shape))
                out[name] = arr
            else:
                out[name] = col.to_numpy(zero_copy_only=False)
        return out

    def to_pandas(self):
        return self.block.to_pandas()

    def slice(self, start: int, end: int) -> pa.Table:
        return self.block.slice(start, end - start)

    def schema(self):
        return self.block.schema

    @staticmethod
    def concat(blocks: List[pa.Table]) -> pa.Table:
        blocks = [b for b in blocks if b.num_rows > 0]
        if not blocks:
            return pa.table({})
        return pa.concat_tables(blocks, promote_options="default")
