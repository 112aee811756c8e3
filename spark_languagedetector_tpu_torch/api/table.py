"""Columnar table: the framework's DataFrame-in/DataFrame-out currency.

Port of ``spark_languagedetector_tpu.api.table``. The reference's public API
is Spark ``Dataset``/``DataFrame`` in and out; padded batches are built from
contiguous column arrays, so the analog is a thin immutable columnar table
with a typed schema, cheap column selection, and append-column semantics
(the reference's ``SchemaUtils.appendColumn``).

Columns are numpy object/primitive arrays; string columns are numpy arrays of
Python str (object dtype) so slicing/fancy-indexing are vectorized. Interop:
``from_pandas``/``to_pandas`` and pyarrow round-trip for the persistence layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, Mapping, Sequence

import numpy as np

# Minimal type vocabulary; mirrors what the reference's schemas actually use.
STRING = "string"
INT = "int"
LONG = "long"
DOUBLE = "double"
BINARY = "binary"
ARRAY_DOUBLE = "array<double>"

_NUMPY_KINDS = {
    "U": STRING,
    "O": STRING,  # object arrays of str (or bytes → BINARY, resolved per value)
    "i": LONG,
    "u": LONG,
    "f": DOUBLE,
    "b": INT,
}


def _infer_type(values: np.ndarray) -> str:
    kind = values.dtype.kind
    if kind == "O" and len(values) > 0:
        v = values[0]
        if isinstance(v, (bytes, bytearray)):
            return BINARY
        if isinstance(v, (list, np.ndarray)):
            return ARRAY_DOUBLE
    return _NUMPY_KINDS.get(kind, STRING)


def _to_object_column(values) -> np.ndarray:
    """Coerce a python sequence to a 1-D object array without numpy collapsing
    nested equal-length lists into a 2-D array (needed for array<double>
    columns like per-language probability vectors)."""
    if isinstance(values, np.ndarray):
        return values
    arr = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        arr[i] = v
    return arr


@dataclass(frozen=True)
class Field:
    name: str
    dtype: str
    nullable: bool = True


class Schema:
    """Ordered collection of fields; supports the reference's schema ops."""

    def __init__(self, fields: Sequence[Field]):
        self.fields = list(fields)
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names in schema: {names}")

    @property
    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    def __contains__(self, name: str) -> bool:
        return name in self.names

    def __getitem__(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def __len__(self) -> int:
        return len(self.fields)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Schema) and self.fields == other.fields

    def __repr__(self) -> str:
        inner = ", ".join(f"{f.name}:{f.dtype}" for f in self.fields)
        return f"Schema({inner})"

    def append(self, name: str, dtype: str, nullable: bool = True) -> "Schema":
        """Append a column; errors if present (Spark's appendColumn contract)."""
        if name in self:
            raise ValueError(f"column {name!r} already exists")
        return Schema(self.fields + [Field(name, dtype, nullable)])

    def drop(self, name: str) -> "Schema":
        return Schema([f for f in self.fields if f.name != name])


class Table:
    """Immutable columnar table."""

    def __init__(
        self,
        columns: Mapping[str, Sequence[Any] | np.ndarray],
        schema: Schema | None = None,
    ):
        self._columns: dict[str, np.ndarray] = {}
        lengths = set()
        for name, values in columns.items():
            arr = _to_object_column(values)
            if arr.ndim != 1:
                raise ValueError(f"column {name!r} must be 1-D, got {arr.shape}")
            self._columns[name] = arr
            lengths.add(len(arr))
        if len(lengths) > 1:
            raise ValueError(f"ragged columns: lengths {sorted(lengths)}")
        self._num_rows = lengths.pop() if lengths else 0
        if schema is None:
            schema = Schema(
                [Field(n, _infer_type(c)) for n, c in self._columns.items()]
            )
        if set(schema.names) != set(self._columns):
            raise ValueError(
                f"schema names {schema.names} != column names {list(self._columns)}"
            )
        self.schema = schema

    # -- constructors ----------------------------------------------------------
    @staticmethod
    def from_rows(rows: Sequence[Mapping[str, Any]], names: Sequence[str] | None = None) -> "Table":
        if not rows:
            return Table({})
        names = list(names or rows[0].keys())
        return Table({n: [r[n] for r in rows] for n in names})

    @staticmethod
    def from_pandas(df) -> "Table":
        return Table({c: df[c].to_numpy() for c in df.columns})

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame({n: self._columns[n] for n in self.schema.names})

    # -- access ----------------------------------------------------------------
    @property
    def num_rows(self) -> int:
        return self._num_rows

    def __len__(self) -> int:
        return self._num_rows

    def column(self, name: str) -> np.ndarray:
        if name not in self._columns:
            raise KeyError(
                f"column {name!r} not in table (have {self.schema.names})"
            )
        return self._columns[name]

    def __getitem__(self, name: str) -> np.ndarray:
        return self.column(name)

    def rows(self) -> Iterator[dict[str, Any]]:
        names = self.schema.names
        cols = [self._columns[n] for n in names]
        for i in range(self._num_rows):
            yield {n: c[i] for n, c in zip(names, cols)}

    def to_rows(self) -> list[dict[str, Any]]:
        return list(self.rows())

    # -- transforms ------------------------------------------------------------
    def select(self, *names: str) -> "Table":
        return Table(
            {n: self._columns[n] for n in names},
            Schema([self.schema[n] for n in names]),
        )

    def with_column(self, name: str, values: Sequence[Any] | np.ndarray, dtype: str | None = None) -> "Table":
        """Append a column (new table); name must not already exist."""
        arr = _to_object_column(values)
        if len(arr) != self._num_rows:
            raise ValueError(f"length {len(arr)} != num_rows {self._num_rows}")
        cols = dict(self._columns)
        cols[name] = arr
        return Table(cols, self.schema.append(name, dtype or _infer_type(arr)))

    def replace_column(self, name: str, values: Sequence[Any] | np.ndarray, dtype: str | None = None) -> "Table":
        """Drop ``name`` then re-append it last — the reference preprocessors'
        in-place column-replace schema semantics
        (``LowerCasePreprocessor.scala:38-42``)."""
        arr = _to_object_column(values)
        cols = {n: v for n, v in self._columns.items() if n != name}
        cols[name] = arr
        schema = self.schema.drop(name).append(name, dtype or _infer_type(arr))
        return Table(cols, schema)

    def take(self, n: int) -> "Table":
        return Table(
            {k: v[:n] for k, v in self._columns.items()}, self.schema
        )

    def __repr__(self) -> str:
        return f"Table(num_rows={self._num_rows}, schema={self.schema})"


def require_string_column(schema: Schema, name: str) -> None:
    """The reference's transformSchema check (``LanguageDetectorModel.scala:206-209``)."""
    if name not in schema:
        raise KeyError(f"column {name!r} not found in schema {schema.names}")
    dtype = schema[name].dtype
    if dtype != STRING:
        raise TypeError(f"Input type must be {STRING} but got {dtype}.")
