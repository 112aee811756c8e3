"""One batch's wire format, shared by the transform runner (``api.runner``)
and the device fit's pipeline (``ops.fit_pipeline``). :class:`Batch` alone
owns:

* the form rule: ``wire``, the raw bytes (``ops.encode_device``'s
  ``wire_from_docs``, or ``gather_wire`` off a byte plane), where the caller
  asks for it; else ``ragged`` (``native.pack_ragged``) where the caller
  takes it and ``ops.encoding.ragged_fit`` finds it smaller than the padded
  form; else ``padded`` (``native.pack_batch``);
* each form's layout in one pinned buffer: its byte and int32 index fields,
  then the caller's int32 columns (the runner's ``limit``, the fit's
  ``langs`` and ``mult``);
* the rebuild on the device into the padded uint8 ``[rows, pad_to]`` batch
  (``ops.encoding.unpack_ragged``, ``ops.encode_device.encode_batch``), bit
  for bit ``ops.encoding.pad_batch``'s;
* on a mesh, this rank's rows (:func:`mesh_rows`).

The callers keep their spans, fault sites, threads and counter names: each
takes the buffer, fills it (:meth:`Batch.fill`), copies it
(``Staged.to_device``) and rebuilds it (:meth:`Batch.rebuild`) where it
times that step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .. import native
from ..ops.encode_device import encode_batch, gather_wire, wire_capacity, wire_from_docs
from ..ops.encoding import RAGGED_CHUNK, ragged_fit, unpack_ragged

PADDED, RAGGED, WIRE = "padded", "ragged", "wire"
_U8, _I32 = np.uint8, np.int32


class Spans(NamedTuple):
    """A batch's documents as ``(start, length)`` spans into one byte plane:
    the runner's ``DocBlock`` lane, which ships the wire form only."""

    flat: np.ndarray
    starts: np.ndarray
    lengths: np.ndarray


def mesh_rows(mesh, docs, columns: dict) -> tuple[list, dict]:
    """This rank's rows of a batch on ``mesh``: ``docs`` and ``columns``
    (``{name: (array or None, pad value)}``) padded with empty rows to a
    multiple of the data axis (``parallel.mesh.pad_rows_for_mesh``), then
    cut to the rank's shard → ``(docs, {name: array or None})``. Pad rows
    score and count nothing; a caller drops their results after the
    gather."""
    from ..parallel.mesh import DATA_AXIS, pad_rows_for_mesh

    named = [(name, col) for name, col in columns.items() if col[0] is not None]
    docs, *cols = pad_rows_for_mesh(
        list(docs), int(mesh.shape[DATA_AXIS]), *(col for _, col in named)
    )
    out = dict.fromkeys(columns)
    out.update((name, mesh.shard_rows(col)) for (name, _), col in zip(named, cols))
    return mesh.shard_rows(docs), out


class Batch:
    """One planned batch in its wire format: ``docs`` (``bytes`` each, or
    :class:`Spans`) no longer than ``pad_to``, and ``columns`` mapping each
    extra int32 column to ``(values or None, mesh pad value)`` (a None
    column is not shipped). ``wire`` asks for the wire form, ``ragged``
    lets the ragged form win; on a ``mesh`` the batch is this rank's shard.
    ``fields`` is the layout to take; ``capacity`` counts the form's byte
    field, ``index_bytes`` its int32 fields, ``nbytes`` every field, and
    ``fill_ratio`` is ``real_bytes`` over ``capacity``."""

    def __init__(self, docs, pad_to: int, columns: dict, *, wire: bool = False,
                 ragged: bool = False, mesh=None):
        if mesh is not None:
            docs, cols = mesh_rows(mesh, docs, columns)
        else:
            cols = {name: values for name, (values, _) in columns.items()}
        self.docs, self.pad_to = docs, pad_to
        self.columns = {name: values for name, values in cols.items() if values is not None}
        if isinstance(docs, Spans):
            rows, self.real_bytes = len(docs.lengths), int(docs.lengths.sum())
        else:
            rows, self.real_bytes = len(docs), sum(map(len, docs))
        self.rows = rows
        fit = None if wire or not ragged else ragged_fit(docs, pad_to)
        if wire:
            self.form, self.capacity = WIRE, wire_capacity(self.real_bytes, rows, pad_to)
            fields = [("wire", _U8, (self.capacity,)), ("starts", _I32, (rows,))]
        elif fit is not None:
            rows_flat, self._flat_step = fit
            self.form, self.capacity = RAGGED, rows_flat * RAGGED_CHUNK
            fields = [("flat", _U8, (rows_flat, RAGGED_CHUNK)), ("offs", _I32, (rows,))]
        else:
            self.form, self.capacity = PADDED, rows * pad_to
            fields = [("batch", _U8, (rows, pad_to))]
        fields.append(("lengths", _I32, (rows,)))
        self.fields = fields + [(name, _I32, (rows,)) for name in self.columns]
        self.index_bytes = 4 * rows * (len(fields) - 1)
        self.nbytes = self.capacity + 4 * rows * (len(self.fields) - 1)
        self.fill_ratio = self.real_bytes / self.capacity if self.capacity else 1.0

    def fill(self, views: dict) -> None:
        """Pack the batch into a taken buffer's ``views`` (laid out as
        :attr:`fields`)."""
        docs, v = self.docs, views
        if self.form == PADDED:
            native.pack_batch(docs, self.pad_to, out=v["batch"], lengths_out=v["lengths"])
        else:
            if self.form == RAGGED:
                _, index, lengths = native.pack_ragged(
                    docs, self.pad_to, flat_step=self._flat_step, out=v["flat"]
                )
            elif isinstance(docs, Spans):
                _, index, lengths = gather_wire(*docs, self.capacity, out=v["wire"])
            else:
                _, index, lengths = wire_from_docs(docs, self.capacity, out=v["wire"])
            v["offs" if self.form == RAGGED else "starts"][:] = index
            v["lengths"][:] = lengths
        for name, values in self.columns.items():
            v[name][:] = values

    def rebuild(self, dev: dict):
        """The staged tensors ``dev`` (``Staged.to_device``) → ``(uint8
        [rows, pad_to] batch, int32 lengths)`` on their device."""
        if self.form == WIRE:
            batch = encode_batch(dev["wire"], dev["starts"], dev["lengths"], self.pad_to)
        elif self.form == RAGGED:
            batch = unpack_ragged(dev["flat"], dev["offs"], dev["lengths"], self.pad_to)
        else:
            batch = dev["batch"]
        return batch, dev["lengths"]
