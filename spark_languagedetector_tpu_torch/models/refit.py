"""Incremental refit: the count table as a persisted sufficient statistic.

Port of ``spark_languagedetector_tpu.models.refit`` (single device).

The device fit is count then reduce, and the int32 count table is a
sufficient statistic for the whole model: weighting, top-k and the profile
depend on nothing else. ``index_put_(accumulate=True)`` is exact in any
order, so counts accumulated over any sequence of document batches equal
the counts of one pass over the concatenated corpus. A fit can therefore be
grown: new batches update the accumulator through the same pipelined count
path the from-scratch fit uses (:func:`..ops.fit_tpu.accumulate_counts`),
and a refit re-runs only the finalize (:func:`..ops.fit_tpu.finalize_counts`),
bit-identical to fitting from scratch on everything seen so far.

:class:`FitAccumulator` owns that state: the int32 ``[V, L]`` table on the
estimator's device (the CUDA card unless the caller asks for the CPU),
per-language document coverage for the estimator's validation, and the
resume token ``committed`` (how many source batches the table holds).
``save``/``load`` persist it through the crash-atomic fit-state codec of
:mod:`..persist.io` (the JAX package's layout: a state saved by either
package loads in the other); the token rides inside the state, so counts
and token never commit separately.

The streaming loop that feeds this from a source and pushes refits
through the serving registry's hot swap is :mod:`..stream.refit`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops.encoding import UTF8, texts_to_bytes
from ..ops.fit_tpu import accumulate_counts, finalize_counts
from ..ops.vocab import EXACT, MAX_DEVICE_ID_GRAM_LEN, VocabSpec
from ..telemetry import span, trace_request
from ..utils.device import resolve_device
from ..utils.logging import get_logger, log_event

_log = get_logger("models.refit")


class FitAccumulator:
    """Checkpointable incremental device fit: update counts, finalize later.

    Built from an estimator (``LanguageDetector.accumulator()``) or
    restored from disk (:meth:`load`). Not thread-safe — one updater at a
    time (the auto-refit loop owns it from a single thread).

    Supported specs are the ones one dense table can hold: hashed vocabs
    (any gram lengths) and exact vocabs with gram lengths up to
    ``MAX_DEVICE_ID_GRAM_LEN``. The exact long-gram split fit has no
    one-table statistic, so it is refused. ``mesh`` is not supported yet:
    the table lives on one device.
    """

    def __init__(
        self,
        spec: VocabSpec,
        languages: Sequence[str],
        *,
        profile_size: int,
        weight_mode: str = "parity",
        train_encoding: str = UTF8,
        label_col: str = "lang",
        input_col: str = "fulltext",
        batch_rows: int | None = None,
        device=None,
        mesh=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "the port's FitAccumulator keeps its count table on one device; "
                "a mesh-sharded accumulator is not ported yet"
            )
        if spec.mode == EXACT and max(spec.gram_lengths) > MAX_DEVICE_ID_GRAM_LEN:
            raise ValueError(
                "incremental refit needs a single dense count table; exact "
                f"gram lengths > {MAX_DEVICE_ID_GRAM_LEN} take the split "
                "host/device fit, which has no one-table sufficient "
                "statistic — use hashed vocab or fit from scratch"
            )
        self.spec = spec
        self.languages = tuple(languages)
        self.profile_size = int(profile_size)
        self.weight_mode = weight_mode
        self.train_encoding = train_encoding
        self.label_col = label_col
        self.input_col = input_col
        self.batch_rows = batch_rows
        self.device = resolve_device(device)
        self._lang_to_idx = {l: i for i, l in enumerate(self.languages)}
        self.counts = torch.zeros(
            (spec.id_space_size, len(self.languages)), dtype=torch.int32, device=self.device
        )
        self.committed = 0  # resume token: source batches in the table
        self.docs_seen = 0
        self.lang_docs = np.zeros(len(self.languages), dtype=np.int64)
        # The count pass updates the table in place, so a raising update
        # leaves it partly updated: the in-memory state is then unusable
        # and must be reloaded from the last checkpoint.
        self._poisoned = False

    # -------------------------------------------------------- constructors --
    @classmethod
    def for_estimator(cls, estimator, mesh=None) -> "FitAccumulator":
        """Accumulator configured exactly like ``estimator.fit`` would fit
        (spec, languages, weight mode, profile size, encoding, batch rows,
        device)."""
        return cls(
            estimator._vocab_spec(),
            list(estimator.get("supportedLanguages")),
            profile_size=estimator.get("languageProfileSize"),
            weight_mode=estimator.get("weightMode"),
            train_encoding=estimator.get("trainEncoding"),
            label_col=estimator.get_label_col(),
            input_col=estimator.get_input_col(),
            batch_rows=estimator.get("fitBatchRows"),
            device=estimator.get("device"),
            mesh=mesh,
        )

    @classmethod
    def load(cls, path, *, device=None, mesh=None) -> "FitAccumulator":
        """Restore a persisted accumulator (either package's save) onto
        ``device`` (None: the CUDA card): the sparse rows scatter back into
        a fresh dense table there; the resume token comes along."""
        from ..persist.io import load_fit_state

        state = load_fit_state(path)
        acc = cls(
            state["spec"],
            state["languages"],
            profile_size=state["profile_size"],
            weight_mode=state["weight_mode"],
            train_encoding=state["train_encoding"],
            label_col=state["label_col"],
            input_col=state["input_col"],
            batch_rows=state["batch_rows"],
            device=device,
            mesh=mesh,
        )
        if len(state["ids"]):
            if int(state["rows"].max(initial=0)) > np.iinfo(np.int32).max:
                raise ValueError(
                    "persisted counts exceed int32 — this accumulator "
                    "outgrew the device fit's precision contract"
                )
            ids = torch.tensor(state["ids"], device=acc.device)
            acc.counts[ids] = torch.tensor(state["rows"].astype(np.int32), device=acc.device)
        acc.committed = state["committed"]
        acc.docs_seen = state["docs_seen"]
        acc.lang_docs = np.asarray(state["lang_docs"], dtype=np.int64)
        log_event(
            _log, "refit.state_loaded", path=str(path),
            committed=acc.committed, docs=acc.docs_seen,
        )
        return acc

    # ------------------------------------------------------------- updates --
    def _check_usable(self) -> None:
        if self._poisoned:
            raise RuntimeError(
                "accumulator state was invalidated by a failed update "
                "(the count pass updates the table in place); reload it "
                "from the last checkpoint"
            )

    def update(self, dataset) -> int:
        """Accumulate one Table of (label, text) rows; returns rows added.

        The same validation as ``LanguageDetector.fit``'s first check
        (unknown labels raise, message kept verbatim); coverage is checked
        cumulatively at :meth:`finalize`.
        """
        labels = dataset.column(self.label_col).tolist()
        texts = dataset.column(self.input_col).tolist()
        for lang in dict.fromkeys(labels):
            if lang not in self._lang_to_idx:
                raise ValueError(
                    f"Input data contians {lang}, but it is not "
                    f"in the list of supported languages"
                )
        docs = texts_to_bytes(texts, self.train_encoding)
        lang_idx = np.asarray([self._lang_to_idx[l] for l in labels], dtype=np.int32)
        return self.update_raw(docs, lang_idx)

    def update_raw(self, byte_docs, lang_indices) -> int:
        """Accumulate pre-encoded docs through the pipelined count path."""
        self._check_usable()
        lang_arr = np.asarray(lang_indices, dtype=np.int32)
        if len(byte_docs) != len(lang_arr):
            raise ValueError(f"{len(byte_docs)} docs vs {len(lang_arr)} labels")
        if len(byte_docs) == 0:
            self.committed += 1
            return 0
        self._poisoned = True  # cleared on success; see _check_usable
        with trace_request(), span(
            "fit", rows=len(byte_docs), backend="device", incremental=True,
            languages=len(self.languages),
        ):
            self.counts = accumulate_counts(
                self.counts, byte_docs, lang_arr,
                spec=self.spec, num_langs=len(self.languages),
                batch_rows=self.batch_rows,
            )
        self._poisoned = False
        self.committed += 1
        self.docs_seen += len(byte_docs)
        np.add.at(self.lang_docs, lang_arr, 1)
        return len(byte_docs)

    # ------------------------------------------------------------ finalize --
    def coverage_gaps(self) -> list[str]:
        """Supported languages with zero training docs so far (finalize
        refuses while non-empty — the estimator's second validation)."""
        return [lang for lang, n in zip(self.languages, self.lang_docs) if n == 0]

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """(ids, float64 weights) — the reduce half only: weighting, top-k
        and the winners' collect over the accumulated table, bit-identical
        to a from-scratch fit over everything updated so far."""
        self._check_usable()
        missing = self.coverage_gaps()
        if missing:
            raise ValueError(
                f"No training examples found for language {missing[0]}. "
                f"Provide examples for each language"
            )
        return finalize_counts(
            self.counts,
            num_langs=len(self.languages),
            profile_size=self.profile_size,
            weight_mode=self.weight_mode,
        )

    # ----------------------------------------------------------- persistence --
    def nonzero_rows(self) -> tuple[np.ndarray, np.ndarray]:
        """(ids int64 [R], counts int64 [R, L]) of the occurring rows:
        occurrence is decided on the device and only those rows are copied
        to the host."""
        ids = torch.nonzero((self.counts != 0).any(dim=1)).squeeze(1)
        rows = self.counts[ids].cpu().numpy().astype(np.int64)
        return ids.cpu().numpy().astype(np.int64), rows

    def save(self, path) -> None:
        """Checkpoint the accumulator (sparse nonzero rows + resume token)
        through the crash-atomic fit-state codec."""
        self._check_usable()
        from ..persist.io import save_fit_state

        ids, rows = self.nonzero_rows()
        save_fit_state(
            path,
            spec=self.spec,
            languages=self.languages,
            weight_mode=self.weight_mode,
            profile_size=self.profile_size,
            train_encoding=self.train_encoding,
            label_col=self.label_col,
            input_col=self.input_col,
            batch_rows=self.batch_rows,
            committed=self.committed,
            docs_seen=self.docs_seen,
            lang_docs=self.lang_docs,
            ids=ids,
            rows=rows,
        )

    def matches_estimator(self, estimator) -> bool:
        """Whether this state was produced under the estimator's exact fit
        configuration (spec, languages, weight mode, profile size, train
        encoding) — the precondition for ``fit_from_accumulator`` and for
        resuming a persisted state under an ``AutoRefit`` built from it."""
        return (
            self.spec == estimator._vocab_spec()
            and self.languages == tuple(estimator.get("supportedLanguages"))
            and self.weight_mode == estimator.get("weightMode")
            and self.profile_size == estimator.get("languageProfileSize")
            and self.train_encoding == estimator.get("trainEncoding")
        )
