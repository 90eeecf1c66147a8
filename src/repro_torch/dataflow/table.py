"""Table: the tuple-stream representation of the dataflow engine.

A Table is a struct-of-arrays with a fixed *capacity* and a validity
mask, as in the JAX reference:

  * every column is a tensor of shape ``(capacity,)`` (numeric) or
    ``(capacity, width)`` (fixed-width byte strings, dtype uint8);
  * ``valid`` is a boolean ``(capacity,)`` mask — Filter marks rows
    invalid instead of compacting; compaction happens on the artifact
    store's write path (see ``host_compact``), on the card through the
    ``filter_project`` kernel when the table lives there.

Hash lanes are the reference's uint32 values carried in int64, masked
to 32 bits: PyTorch's uint32 lacks shifts, adds and comparisons on the
CPU.  Every multiply is kept exact (below 2**63) so no result depends
on signed wrap-around.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve

# ---------------------------------------------------------------------------
# Schema


@dataclasses.dataclass(frozen=True)
class ColumnType:
    """dtype + optional byte-width (width > 0 means fixed-width string)."""

    dtype: str  # numpy dtype name, e.g. "int32", "float32", "uint8"
    width: int = 0  # 0 => scalar column; >0 => (capacity, width) bytes

    @property
    def is_string(self) -> bool:
        return self.width > 0

    def key(self) -> Tuple:
        return ("col", self.dtype, self.width)


INT = ColumnType("int32")
FLOAT = ColumnType("float32")


def STR(width: int = 20) -> ColumnType:
    return ColumnType("uint8", width)


Schema = Dict[str, ColumnType]


def schema_key(schema: Schema) -> Tuple:
    return tuple(sorted((n, t.key()) for n, t in schema.items()))


_TORCH_DTYPES = {"int32": torch.int32, "float32": torch.float32,
                 "uint8": torch.uint8, "bool": torch.bool}


def torch_dtype(name: str) -> torch.dtype:
    """numpy dtype name -> torch dtype."""
    return _TORCH_DTYPES[name]


def dtype_name(dt: torch.dtype) -> str:
    """torch dtype -> numpy dtype name (the schema's spelling)."""
    return str(dt).replace("torch.", "")


def to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy -> tensor on ``device``; never aliases the caller's array
    (a CPU tensor gets its own copy, as ``jnp.asarray`` gives one)."""
    a = np.ascontiguousarray(a)
    if device.type == "cpu" or not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


# ---------------------------------------------------------------------------
# Table


@dataclasses.dataclass
class Table:
    columns: Dict[str, torch.Tensor]
    valid: torch.Tensor  # bool (capacity,)

    # -- accessors ----------------------------------------------------------
    @property
    def capacity(self) -> int:
        return int(self.valid.shape[0])

    @property
    def device(self) -> torch.device:
        return self.valid.device

    @property
    def names(self):
        return sorted(self.columns)

    def col(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def schema(self) -> Schema:
        out: Schema = {}
        for n, c in self.columns.items():
            if c.ndim == 2:
                out[n] = ColumnType("uint8", int(c.shape[1]))
            else:
                out[n] = ColumnType(dtype_name(c.dtype))
        return out

    def num_valid(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)

    def nbytes(self) -> int:
        """Logical bytes at full capacity (the T_load/T_store proxy)."""
        total = self.valid.numel()  # 1 byte/bool
        for c in self.columns.values():
            total += c.numel() * c.element_size()
        return int(total)

    # -- construction helpers ----------------------------------------------
    @staticmethod
    def from_numpy(cols: Dict[str, np.ndarray], nvalid: int | None = None,
                   capacity: int | None = None, device=None,
                   valid: np.ndarray | None = None) -> "Table":
        """Columns (and optionally an explicit ``valid`` mask, as the
        reference's ``to_numpy(only_valid=False)`` + ``valid`` give
        them) -> Table on ``device`` (None: the card)."""
        device = resolve(device)
        n = len(next(iter(cols.values())))
        nvalid = n if nvalid is None else nvalid
        capacity = n if capacity is None else capacity
        out = {}
        for name, a in cols.items():
            a = np.asarray(a)
            if capacity != n:
                pad = [(0, capacity - n)] + [(0, 0)] * (a.ndim - 1)
                a = np.pad(a, pad)
            out[name] = to_tensor(a, device)
        if valid is not None:
            v = to_tensor(np.asarray(valid, bool), device)
        else:
            v = torch.arange(capacity, device=device) < nvalid
        return Table(out, v)

    def to_numpy(self, only_valid: bool = True) -> Dict[str, np.ndarray]:
        mask = self.valid.cpu().numpy()
        out = {}
        for n, c in self.columns.items():
            a = c.cpu().numpy()
            out[n] = a[mask] if only_valid else a
        return out

    # -- row ops used by physical operators ----------------------------------
    def gather(self, idx: torch.Tensor, valid: torch.Tensor) -> "Table":
        idx = idx.long()
        cols = {n: c.index_select(0, idx) for n, c in self.columns.items()}
        return Table(cols, valid)

    def with_valid(self, valid: torch.Tensor) -> "Table":
        return Table(dict(self.columns), valid)

    def select(self, names) -> "Table":
        return Table({n: self.columns[n] for n in names}, self.valid)

    def compact(self) -> "Table":
        """Reorder rows so valid rows form a prefix (stable).  ``order[j]``
        = index of the j-th valid row, found by binary-searching the
        running count of valid rows."""
        cnt = torch.cumsum(self.valid.to(torch.int32), 0, dtype=torch.int32)
        want = torch.arange(1, self.capacity + 1, dtype=torch.int32,
                            device=self.device)
        order = torch.searchsorted(cnt, want)
        order = order.clamp(0, self.capacity - 1)
        iota = torch.arange(self.capacity, device=self.device)
        return self.gather(order, iota < cnt[-1])

    def host_compact(self, capacity: int, nvalid: int
                     ) -> "Dict[str, np.ndarray]":
        """Compaction for the store's write path: extract the ``nvalid``
        valid rows (stable), pad to ``capacity``.  Returns numpy column
        arrays plus ``__valid__``; runs on the flusher thread.

        A table on the card is compacted there by the ``filter_compact``
        kernel (one count of the mask, one scatter per column), and only
        the first ``min(nvalid, capacity)`` rows of each column cross to
        the host; a CPU table compacts in numpy.  Either way the arrays
        equal the reference's byte for byte."""
        out: Dict[str, np.ndarray] = {}
        if self.valid.is_cuda:
            from ..kernels.filter_project.ops import compact_columns
            keep = min(nvalid, capacity)
            comps, _total = compact_columns(
                [c.contiguous() for c in self.columns.values()],
                self.valid.contiguous())
            for n, comp in zip(self.columns, comps):
                a = comp[:keep].cpu().numpy()
                if len(a) < capacity:
                    pad = [(0, capacity - len(a))] + [(0, 0)] * (a.ndim - 1)
                    a = np.pad(a, pad)
                out[n] = a
        else:
            mask = self.valid.numpy().astype(bool)
            for n, c in self.columns.items():
                a = c.numpy()[mask][:capacity]
                if len(a) < capacity:
                    pad = [(0, capacity - len(a))] + [(0, 0)] * (a.ndim - 1)
                    a = np.pad(a, pad)
                out[n] = a
        out["__valid__"] = np.arange(capacity) < nvalid
        return out


def concat_tables(parts, capacity: int | None = None) -> Table:
    """Host-side concatenation of the *valid* rows of ``parts``, in
    order — the append primitive of incremental artifact maintenance
    (DESIGN.md §12).  Schemas must match exactly; the result lives on
    the first part's device."""
    assert parts, "concat_tables: no inputs"
    names = parts[0].names
    for p in parts[1:]:
        assert p.names == names, "concat_tables: schema mismatch"
    cols: Dict[str, np.ndarray] = {}
    for n in names:
        cols[n] = np.concatenate(
            [p.col(n).cpu().numpy()[p.valid.cpu().numpy()] for p in parts])
    nvalid = len(cols[names[0]])
    cap = capacity if capacity is not None else max(nvalid, 8)
    return Table.from_numpy(cols, nvalid=nvalid, capacity=cap,
                            device=parts[0].device)


def slice_valid(table: Table, lo: int, hi: int | None = None,
                round_pow2: bool = False, cols=None) -> Table:
    """Table holding valid rows ``[lo:hi]`` of ``table`` (host-side),
    on the table's device (DESIGN.md §12).  ``round_pow2`` pads the
    capacity to the next power of two; ``cols`` restricts the slice to
    a column subset."""
    rows = np.flatnonzero(table.valid.cpu().numpy())[lo:hi]
    names = table.names if cols is None else sorted(cols)
    out: Dict[str, np.ndarray] = {}
    for n in names:
        out[n] = table.col(n).cpu().numpy()[rows]
    nvalid = len(rows)
    cap = max(nvalid, 8)
    if round_pow2:
        cap = 1 << (cap - 1).bit_length()
    return Table.from_numpy(out, nvalid=nvalid, capacity=cap,
                            device=table.device)


def pad_capacity(table: Table, multiple: int) -> Table:
    """Pad ``table`` with invalid rows so its capacity is a multiple of
    ``multiple``."""
    cap = table.capacity
    if multiple <= 1 or cap % multiple == 0:
        return table
    new_cap = ((cap + multiple - 1) // multiple) * multiple
    cols = {}
    for n, c in table.columns.items():
        pad = torch.zeros((new_cap - cap,) + tuple(c.shape[1:]),
                          dtype=c.dtype, device=c.device)
        cols[n] = torch.cat([c, pad])
    valid = torch.cat([table.valid,
                       torch.zeros(new_cap - cap, dtype=torch.bool,
                                   device=table.device)])
    return Table(cols, valid)


def encode_strings(values, width: int = 20) -> np.ndarray:
    """Python strings -> (n, width) uint8, truncated/zero-padded."""
    out = np.zeros((len(values), width), dtype=np.uint8)
    for i, s in enumerate(values):
        b = s.encode("utf-8")[:width]
        out[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    return out


def decode_strings(arr: np.ndarray):
    return ["".join(chr(c) for c in row if c) for row in np.asarray(arr)]


# ---------------------------------------------------------------------------
# Hashing: the reference's uint32 lanes, carried in int64 masked to 32 bits

_M32 = 0xFFFFFFFF
_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) and a constant c < 2**32.
    c is split into 16-bit halves so every product stays below 2**48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor, seed: int) -> torch.Tensor:
    """splitmix-style avalanche on a uint32 lane."""
    x = (x & _M32) ^ seed
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _as_u32(col: torch.Tensor) -> torch.Tensor:
    """A 1-D column's bits as a uint32 lane in int64: floats are
    bitcast as float32 (keeping -0.0 and NaN bits), integers wrap
    modulo 2**32 as the reference's ``astype(uint32)`` does."""
    if col.is_floating_point():
        col = col.to(torch.float32).view(torch.int32)
    return col.to(torch.int64) & _M32


def hash_column(col: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """uint32 hash (int64 carrier) of one column (1-D or 2-D bytes)."""
    if col.ndim == 2:  # fixed-width string: FNV-1a fold, then mix
        h = torch.full(col.shape[:1], _FNV_OFFSET, dtype=torch.int64,
                       device=col.device)
        for j in range(col.shape[1]):
            h = _mul32(h ^ col[:, j].to(torch.int64), _FNV_PRIME)
        return _mix32(h, seed)
    return _mix32(_as_u32(col), seed)


def hash_columns(table: Table, names, seed: int = 0) -> torch.Tensor:
    """Combined uint32 hash over several key columns (sorted names)."""
    h = torch.zeros(table.capacity, dtype=torch.int64, device=table.device)
    for i, n in enumerate(sorted(names)):
        h = _mix32(h * 31 + hash_column(table.col(n), seed + i), seed)
    return h


def key_hash(table: Table, keys, seed: int = 0) -> torch.Tensor:
    """uint32 key hash mixing the key columns in the GIVEN order (the
    two sides of a JOIN carry differently-named key columns, and their
    hashes only agree if column i is hashed alike on both sides)."""
    h = torch.zeros(table.capacity, dtype=torch.int64, device=table.device)
    for i, n in enumerate(keys):
        h = _mix32(h * 31 + hash_column(table.col(n), seed + i), seed)
    return h


def partition_finalize(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 over an already-computed ``key_hash`` lane
    (DESIGN.md §11: every component that assigns rows to shards must
    agree bit-for-bit on hash(keys) % P)."""
    h = h & _M32
    h = _mul32(h ^ (h >> 16), 0x85EBCA6B)
    h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


def partition_hash(table: Table, keys) -> torch.Tensor:
    """Canonical uint32 partition hash: ``partition_finalize`` of the
    positional seed-0 ``key_hash``."""
    return partition_finalize(key_hash(table, keys, seed=0))


def cols_equal(table_a: Table, idx_a, table_b: Table, idx_b,
               names) -> torch.Tensor:
    """Exact row equality on key columns between gathered row indices."""
    idx_a, idx_b = idx_a.long(), idx_b.long()
    eq = torch.ones(idx_a.shape, dtype=torch.bool, device=idx_a.device)
    for n in names:
        ca = table_a.col(n)[idx_a]
        cb = table_b.col(n)[idx_b]
        e = ca == cb
        if e.ndim == idx_a.ndim + 1:
            e = e.all(dim=-1)
        eq = eq & e
    return eq
