"""LanguageDetector (Estimator) and LanguageDetectorModel (Model/Transformer).

Port of ``spark_languagedetector_tpu.models.estimator``: the reference's
Spark ML pair with the same Params, defaults and validation messages
(``inputCol="fulltext"``, ``labelCol``/``outputCol="lang"``). Fit builds a
columnar :class:`GramProfile` with the host numpy fit or, with
``fitBackend="device"``, the device fit of :mod:`..ops.fit_tpu` (torch ops
on the model's device; the split fit for exact n = 4..5), both bit for bit
the same profile; transform ships micro-batches through
:class:`~..api.runner.BatchRunner`, whose CUDA kernels label documents on the
card (the fused kernel for dense and LUT profiles; the bigram and
row-histogram kernels of the hybrid strategy for exact n = 4..5 profiles).

``resultMode="segment"`` switches ``transform``/``detect`` to the
segmentation result type: byte-offset spans, calibrated top-k languages and
the unknown reject, decoded by :func:`..segment.segment_documents` over the
runner's per-cell device scores (the CUDA fused-segment kernel for a fused
runner). ``calibrate(heldout)`` fits the per-language temperatures the
calibrated probabilities use; an uncalibrated model segments with T = 1.0
and stamps ``calibrated: false`` on every result.

Where the JAX package had a ``backend`` switch, the port has ``device``:
None means the CUDA card (and raises when there is none); ``"cpu"`` runs
the plain PyTorch versions; ``"mesh"`` and ``"mesh:vocab"`` keep JAX's
meaning over the ranks of the initialised process group
(``init_distributed``): transform shards its batches over every rank
(``api.runner.resolve_mesh``), and ``"mesh:vocab"`` also stripes a dense
weight table, whose budget widens by the mesh size. ``fitBackend="device"``
fits over ``api.runner.resolve_fit_mesh()``, every rank of the group (a
single device without one). As in JAX, every rank passes the same table to
``fit`` and ``transform`` and gets the whole profile and every label.

``model.write().save(path)`` and ``LanguageDetectorModel.load`` use the JAX
package's directory layout (:mod:`..persist.io`), so a model saved by
either package loads in the other, its calibration included.
"""

from __future__ import annotations

import json
import threading
from typing import Sequence

import numpy as np

from ..api.params import HasInputCol, HasLabelCol, HasOutputCol, Param
from ..api.runner import MESH_BACKENDS, BatchRunner, resolve_fit_mesh, resolve_mesh
from ..api.table import STRING, Schema, Table, require_string_column
from ..ops import fit as fit_ops
from ..ops.encoding import LOW_BYTE, UTF8, texts_to_bytes
from ..ops.vocab import (
    EXACT,
    HASHED,
    MAX_DEVICE_ID_GRAM_LEN,
    MAX_EXACT_GRAM_LEN,
    VocabSpec,
)
from ..segment import SegmentOptions, segment_documents
from ..segment.calibrate import Calibration, fit_calibration, normalize_scores
from ..telemetry import flightrec, span, trace_request
from ..utils.device import resolve_device
from ..utils.logging import get_logger, log_event
from .profile import DENSE_TABLE_BUDGET_BYTES, GramProfile

_log = get_logger("models.estimator")

RESULT_MODES = ("label", "segment")


def _run_fit(fn, *, site: str, rows: int, **span_attrs):
    """``fn()`` under one request trace, the root ``fit`` span (the count,
    finalize and collect spans nest under it) and the env-tuned retry
    policy at ``site``; a raise dumps the flight recorder first."""
    from ..resilience.policy import RetryPolicy

    policy = RetryPolicy.from_env()
    try:
        with trace_request(), span("fit", rows=rows, **span_attrs):
            return policy.run(fn, site=site, log_fields={"rows": rows})
    except Exception as e:
        flightrec.record_crash("fit", e)
        raise


def _positive_int(v) -> bool:
    return isinstance(v, int) and v > 0


def _valid_reject_threshold(v) -> bool:
    return isinstance(v, (int, float)) and 0.0 <= float(v) < 1.0


def _valid_device(v) -> bool:
    return v is None or isinstance(v, str)


def session_device(value):
    """The torch device a ``device`` param value runs this process on: a
    mesh value (``"mesh"``, ``"mesh:vocab"``) means this rank's device (the
    card without a process group); anything else as ``resolve_device``
    reads it."""
    if value in MESH_BACKENDS:
        from ..parallel.distributed import rank_device

        value = rank_device()
    return resolve_device(value)


class _ResultModeParams:
    """Segmentation result-type params, shared by estimator and model."""

    result_mode = Param(
        "resultMode",
        "transform output type: 'label' (the reference's one-language "
        "argmax column) or 'segment' (span-level code-switch decode: the "
        "output column carries a JSON object per document with byte-"
        "offset spans, calibrated top-k languages, and the unknown reject)",
        lambda v: v in RESULT_MODES,
    )
    top_k = Param(
        "topK",
        "segment mode: candidate languages returned per document with "
        "calibrated probabilities",
        _positive_int,
    )
    reject_threshold = Param(
        "rejectThreshold",
        "segment mode: calibrated-probability floor in [0, 1) below which "
        "a document answers 'unknown'; 0 disables the reject",
        _valid_reject_threshold,
    )


class _DeviceParam:
    device = Param(
        "device",
        "torch device transform runs on: None ⇒ the CUDA card (an error "
        "when none is visible), 'cpu' ⇒ the plain PyTorch versions, "
        "any torch device string such as 'cuda:1', or 'mesh' | 'mesh:vocab' "
        "(every rank of the process group; 'mesh:vocab' also stripes a "
        "dense weight table over a vocab axis). A property of the "
        "session, not of the stage: persistence does not save it, so a "
        "loaded model runs on the card unless its loader names a device",
        _valid_device,
        persisted=False,
    )


class _DetectorParams(HasInputCol, HasLabelCol, _ResultModeParams, _DeviceParam):
    """Params shared by the estimator (model adds output col instead)."""

    supported_languages = Param(
        "supportedLanguages", "languages the detector can emit, in vector order"
    )
    gram_lengths = Param("gramLengths", "byte n-gram window sizes")
    language_profile_size = Param(
        "languageProfileSize", "top-k grams kept per language", _positive_int
    )
    save_grams_to = Param(
        "saveGrams",
        "optional path: persist the fitted gram-probability dataset (the "
        "reference's saveGramsToHDFS)",
    )
    vocab_mode = Param(
        "vocabMode",
        f"'exact' (bijective ids, gram lengths <= {MAX_EXACT_GRAM_LEN}), "
        "'hashed' (2^hashBits buckets, any length), or 'auto'",
        lambda v: v in ("auto", EXACT, HASHED),
    )
    hash_bits = Param("hashBits", "log2 bucket count for hashed vocab", _positive_int)
    hash_scheme = Param(
        "hashScheme",
        "hashed bucket scheme: 'auto' (exact12 when hashBits >= 17), "
        "'exact12' (grams <= 2 bytes keep collision-free polynomial ids; "
        "longer grams FNV-fold into the remaining buckets), or 'fnv1a' (all "
        "lengths FNV-folded)",
        lambda v: v in ("auto", "fnv1a", "exact12"),
    )
    weight_mode = Param(
        "weightMode",
        "'parity': reference formula log(1+presence/#langs); "
        "'counts': corrected log(1+count/total)",
        lambda v: v in fit_ops.WEIGHT_MODES,
    )
    train_encoding = Param(
        "trainEncoding",
        "text→bytes for fit: 'utf8' (reference fit behavior)",
        lambda v: v in (UTF8, LOW_BYTE),
    )
    fit_backend = Param(
        "fitBackend",
        "'cpu' (host fit — the reference keeps fit on CPU) or 'device': "
        "streaming dense-count fit on the model's device (micro-batched "
        "scatter-add + device weighting/top-k). Exact gram lengths 4..5 "
        "are counted on the host; an exact vocabulary with no length <= 3 "
        "therefore fits wholly on the host",
        lambda v: v in ("cpu", "device"),
    )
    fit_batch_rows = Param(
        "fitBatchRows",
        "device-fit micro-batch rows per count dispatch; None ⇒ rows adapt "
        "per length bucket under an 8MB padded-batch budget. Ignored by "
        "fitBackend='cpu'",
        lambda v: v is None or _positive_int(v),
    )
    quantization = Param(
        "quantization",
        "weight-table quantization stamped onto the fitted model: 'int8' | "
        "'int16' score through int8/int16 tables with per-language f32 "
        "scales; None keeps f32 tables",
        lambda v: v in (None, "int8", "int16"),
    )


class LanguageDetector(_DetectorParams):
    """Estimator: ``fit(table) -> LanguageDetectorModel``."""

    def __init__(
        self,
        supported_languages: Sequence[str],
        gram_lengths: Sequence[int],
        language_profile_size: int,
        uid: str | None = None,
        device: str | None = None,
    ):
        super().__init__(uid, uid_prefix="LanguageDetector")
        self.set_default(
            inputCol="fulltext",
            labelCol="lang",
            saveGrams=None,
            vocabMode="auto",
            hashBits=20,
            hashScheme="auto",
            weightMode=fit_ops.PARITY,
            trainEncoding=UTF8,
            fitBackend="cpu",
            fitBatchRows=None,
            device=None,
        )
        self.set("supportedLanguages", list(supported_languages))
        self.set("gramLengths", [int(n) for n in gram_lengths])
        self.set("languageProfileSize", int(language_profile_size))
        if device is not None:
            self.set("device", device)

    @classmethod
    def _from_param_metadata(cls, uid: str, metadata: dict) -> "LanguageDetector":
        """Rebuild an estimator from persisted params (pipeline persistence:
        the constructor arguments are Params, so they come back out of the
        metadata)."""
        flat = {**metadata.get("defaultParams", {}), **metadata.get("params", {})}
        det = cls(
            flat["supportedLanguages"],
            flat["gramLengths"],
            flat["languageProfileSize"],
            uid=uid,
        )
        det._set_params_from_metadata(metadata)
        return det

    # -- convenience setters (Spark ML style) ---------------------------------
    def set_save_grams_to(self, path: str | None):
        return self.set("saveGrams", path)

    def set_fit_backend(self, value: str):
        return self.set("fitBackend", value)

    def set_fit_batch_rows(self, value: int | None):
        return self.set("fitBatchRows", value)

    def set_device(self, value: str | None):
        return self.set("device", value)

    def set_quantization(self, value: str | None):
        return self.set("quantization", value)

    def set_vocab_mode(self, mode: str):
        return self.set("vocabMode", mode)

    def set_hash_bits(self, bits: int):
        return self.set("hashBits", bits)

    def set_hash_scheme(self, scheme: str):
        return self.set("hashScheme", scheme)

    def set_weight_mode(self, mode: str):
        return self.set("weightMode", mode)

    def set_result_mode(self, mode: str):
        return self.set("resultMode", mode)

    def set_top_k(self, k: int):
        return self.set("topK", k)

    def set_reject_threshold(self, value: float):
        return self.set("rejectThreshold", value)

    # -- contract --------------------------------------------------------------
    def transform_schema(self, schema: Schema) -> Schema:
        """Estimator schema pass-through."""
        return schema

    def _vocab_spec(self) -> VocabSpec:
        gram_lengths = tuple(self.get("gramLengths"))
        mode = self.get("vocabMode")
        if mode == "auto":
            # Dense/LUT id forms first: exact through n = 3, hashed beyond.
            mode = EXACT if max(gram_lengths) <= MAX_DEVICE_ID_GRAM_LEN else HASHED
        return VocabSpec(
            mode,
            gram_lengths,
            hash_bits=self.get("hashBits"),
            hash_scheme=self.get("hashScheme"),
        )

    def fit(self, dataset: Table) -> "LanguageDetectorModel":
        # The model (and a device fit) runs where the estimator says;
        # resolving here makes a machine without a card fail before the
        # fit, not after it.
        device = session_device(self.get("device"))
        label_col, input_col = self.get_label_col(), self.get_input_col()
        supported = list(self.get("supportedLanguages"))
        labels = dataset.column(label_col)
        texts = dataset.column(input_col)
        lang_to_idx = {lang: i for i, lang in enumerate(supported)}

        # Validation A: all training labels must be supported. Message kept
        # verbatim, typo included — it is the reference's observable
        # behavior.
        label_list = labels.tolist()
        for lang in dict.fromkeys(label_list):
            if lang not in lang_to_idx:
                raise ValueError(
                    f"Input data contians {lang}, but it is not "
                    f"in the list of supported languages"
                )
        # Validation B: every supported language needs a training row.
        label_set = set(label_list)
        for lang in supported:
            if lang not in label_set:
                raise ValueError(
                    f"No training examples found for language {lang}. "
                    f"Provide examples for each language"
                )

        spec = self._vocab_spec()
        docs = texts_to_bytes(texts.tolist(), self.get("trainEncoding"))
        lang_idx = np.asarray([lang_to_idx[l] for l in label_list])
        # Each attempt builds its count table from scratch, so a replay of
        # the whole fit is exact.
        ids, weights = _run_fit(
            lambda: self._fit_profile(spec, docs, lang_idx, len(supported), device),
            site="fit/count", rows=dataset.num_rows,
            backend=self.get("fitBackend"), languages=len(supported),
        )
        profile = GramProfile(
            spec=spec, languages=tuple(supported), ids=ids, weights=weights
        )
        log_event(
            _log, "fit.done", rows=dataset.num_rows, grams=profile.num_grams,
            languages=len(supported),
        )
        save_path = self.get("saveGrams")
        if save_path is not None:
            from ..persist.io import save_gram_dump

            save_gram_dump(save_path, profile)
        return self._build_model(profile)

    # -- incremental refit -----------------------------------------------------
    def accumulator(self):
        """An empty incremental-fit accumulator configured exactly like this
        estimator's device fit (spec, languages, weight mode, profile size,
        encoding, batch rows, device). Feed it batches with
        ``acc.update(table)`` — the count path ``fit`` uses — then
        :meth:`fit_from_accumulator`. See :mod:`.refit`."""
        from .refit import FitAccumulator

        return FitAccumulator.for_estimator(self)

    def fit_from_accumulator(self, acc) -> "LanguageDetectorModel":
        """Model from an accumulated count table: re-runs only the finalize
        (weighting, top-k, winners' collect), bit-identical to ``fit`` on
        the concatenation of every batch the accumulator has seen. The
        accumulator must have been built under this estimator's exact fit
        configuration, and every supported language must have coverage."""
        if not acc.matches_estimator(self):
            raise ValueError(
                "accumulator state does not match this estimator's fit "
                "configuration (vocab spec / languages / weightMode / "
                "languageProfileSize); refit needs the exact fit setup "
                "its counts were accumulated under"
            )
        # The finalize only reads the count table, so it replays exactly.
        ids, weights = _run_fit(
            acc.finalize, site="fit/finalize", rows=acc.docs_seen,
            backend="device", incremental=True, languages=len(acc.languages),
        )
        profile = GramProfile(
            spec=acc.spec, languages=acc.languages, ids=ids, weights=weights
        )
        log_event(
            _log, "refit.done", rows=acc.docs_seen, grams=profile.num_grams,
            languages=len(acc.languages), committed=acc.committed,
        )
        return self._build_model(profile)

    def _fit_profile(self, spec, docs, lang_idx, num_langs: int, device):
        """(ids, weights) through the configured fit backend; the device
        fit runs on ``device``. Exact gram lengths 4..5 have no dense
        device table, so they take the split fit (lengths <= 3 counted on
        the device, the long lengths by the exact host path)."""
        args = (
            docs, lang_idx, num_langs, spec,
            self.get("languageProfileSize"), self.get("weightMode"),
        )
        if self.get("fitBackend") != "device":
            return fit_ops.fit_profile_numpy(*args)
        from ..ops.fit_tpu import fit_profile_device, fit_profile_device_split

        split = spec.mode == EXACT and max(spec.gram_lengths) > MAX_DEVICE_ID_GRAM_LEN
        fit = fit_profile_device_split if split else fit_profile_device
        mesh = resolve_fit_mesh()
        return fit(*args, batch_rows=self.get("fitBatchRows"),
                   device=device if mesh is None else None, mesh=mesh)

    def _build_model(self, profile: GramProfile) -> "LanguageDetectorModel":
        """Profile → configured model (the estimator stamps its params)."""
        model = LanguageDetectorModel(profile)
        model.set_default(inputCol=self.get_or_default("inputCol"))
        for p in ("device", "quantization", "resultMode", "topK", "rejectThreshold"):
            if self.is_set(p):
                model.set(p, self.get(p))
        return model


class LanguageDetectorModel(HasInputCol, HasOutputCol, _ResultModeParams, _DeviceParam):
    """Model/Transformer: appends the detected-language column."""

    predict_encoding = Param(
        "predictEncoding",
        "text→bytes for transform: 'utf8' (default) or 'low_byte' — the "
        "reference's predict path truncates UTF-16 units to their low byte; "
        "'low_byte' reproduces that for parity runs",
        lambda v: v in (UTF8, LOW_BYTE),
    )
    batch_size = Param(
        "batchSize",
        "micro-batch rows per device dispatch; None ⇒ auto per strategy",
        lambda v: v is None or _positive_int(v),
    )
    quantization = Param(
        "quantization",
        "'int8' | 'int16': score through the fused kernel with a quantized "
        "weight table (per-language f32 scales, exact integer sums) — 4x/2x "
        "fewer table bytes at a bounded argmax-agreement cost. None keeps "
        "f32 tables",
        lambda v: v in (None, "int8", "int16"),
    )
    max_score_bytes = Param(
        "maxScoreBytes",
        "score only the first N bytes of each document (UTF-8-boundary-safe "
        "truncation). None ⇒ score everything (reference behavior)",
        lambda v: v is None or _positive_int(v),
    )

    def __init__(self, profile: GramProfile, uid: str | None = None, device: str | None = None):
        super().__init__(uid, uid_prefix="LanguageDetectorModel")
        self.profile = profile
        # Serving reads ``runner`` from several threads at once (the
        # dispatcher, a swap's prewarm, HTTP handlers): one build, one
        # runner, under this lock.
        self._runner_lock = threading.Lock()
        self._runner_holds = 0
        self.set_default(
            inputCol="fulltext",
            outputCol="lang",
            predictEncoding=UTF8,
            device=None,
            batchSize=None,
            maxScoreBytes=None,
            quantization=None,
            resultMode="label",
            topK=3,
            rejectThreshold=0.0,
        )
        if device is not None:
            self.set("device", device)
        self._runner: BatchRunner | None = None
        # Per-language temperature calibration (segment.calibrate): not a
        # Param, fitted state. None ⇒ segment results say calibrated: false.
        self.calibration: Calibration | None = None

    @staticmethod
    def from_gram_map(
        gram_probabilities: dict[bytes, "Sequence[float]"],
        gram_lengths: Sequence[int],
        languages: Sequence[str],
        uid: str | None = None,
        device: str | None = None,
    ) -> "LanguageDetectorModel":
        """Hand-built model from a gram→weights map (the reference's primary
        constructor shape)."""
        profile = GramProfile.from_gram_map(
            gram_probabilities, tuple(languages), tuple(gram_lengths)
        )
        return LanguageDetectorModel(profile, uid, device)

    def set_device(self, value: str | None):
        return self.set("device", value)

    def set_predict_encoding(self, value: str):
        return self.set("predictEncoding", value)

    def set_batch_size(self, value: int):
        return self.set("batchSize", value)

    def set_max_score_bytes(self, value: int | None):
        return self.set("maxScoreBytes", value)

    def set_quantization(self, value: str | None):
        return self.set("quantization", value)

    def set_result_mode(self, mode: str):
        return self.set("resultMode", mode)

    def set_top_k(self, k: int):
        return self.set("topK", k)

    def set_reject_threshold(self, value: float):
        return self.set("rejectThreshold", value)

    @property
    def supported_languages(self) -> tuple[str, ...]:
        return self.profile.languages

    @property
    def gram_lengths(self) -> tuple[int, ...]:
        return self.profile.spec.gram_lengths

    # The reference misspells this public accessor (gramLenghts); keep the
    # alias so ported user code works.
    @property
    def gram_lenghts(self) -> tuple[int, ...]:
        return self.gram_lengths

    @property
    def gram_probabilities(self) -> dict[bytes, np.ndarray]:
        return self.profile.gram_probabilities

    # -- transform -------------------------------------------------------------
    def transform_schema(self, schema: Schema) -> Schema:
        """StringType check + append nullable string output column."""
        require_string_column(schema, self.get_input_col())
        return schema.append(self.get_output_col(), STRING, nullable=True)

    def set(self, param, value):
        # Any param change invalidates the cached runner.
        self._runner = None
        return super().set(param, value)

    def __getstate__(self):
        # Copies (Params.copy deep-copies) never share the runner's device
        # tensors; they rebuild it lazily. A lock cannot be copied: each
        # copy makes its own.
        state = self.__dict__.copy()
        state.pop("_runner_lock", None)
        state["_runner"] = None
        state["_runner_holds"] = 0
        # A baked artifact's membership tables are views of a local file's
        # mapping; copies rebuild membership from the profile.
        state.pop("_prebuilt_membership", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.__dict__.setdefault("_runner_holds", 0)
        self._runner_lock = threading.Lock()

    @property
    def runner(self) -> BatchRunner:
        """The model's runner, built once on first use (uploads the fused
        table), however many threads ask at the same time."""
        with self._runner_lock:
            return self._runner_locked()

    def _runner_locked(self) -> BatchRunner:
        if self._runner is None:
            # Host arrays of the profile's device view (dense table, LUT or
            # cuckoo table); the runner uploads what its strategy reads. A
            # baked artifact's loader attached them already mapped: when
            # they were built under the dense budget used here, the runner
            # reads the mapped views and nothing is rebuilt.
            device = self.get("device")
            # A mesh value starts from the data-parallel mesh; 'mesh:vocab'
            # carves a vocab axis only when the dense table is the device
            # form (a LUT or cuckoo profile has nothing to stripe, and a
            # smaller data axis would only repeat work), and a stripe makes
            # the dense form affordable at the mesh size x the budget.
            mesh = resolve_mesh("mesh") if device in MESH_BACKENDS else None
            budget = DENSE_TABLE_BUDGET_BYTES
            if device == "mesh:vocab":
                budget *= mesh.size
            prebuilt = getattr(self, "_prebuilt_membership", None)
            if (prebuilt is not None and mesh is None
                    and prebuilt["dense_budget_bytes"] == budget):
                weights, lut, cuckoo = (
                    prebuilt["weights"], prebuilt["lut"], prebuilt["cuckoo"]
                )
            else:
                weights, lut, cuckoo = self.profile.device_membership(
                    device="cpu", dense_budget_bytes=budget
                )
            if device == "mesh:vocab":
                if (lut is None and cuckoo is None
                        and weights.shape[0] == self.profile.spec.id_space_size):
                    mesh = resolve_mesh(
                        "mesh:vocab",
                        table_bytes=int(weights.numel() * weights.element_size()),
                    )
                else:
                    log_event(
                        _log, "mesh_vocab.fallback_data_parallel",
                        reason="device form is compact (cuckoo/LUT); the vocab "
                        "axis would stripe nothing",
                    )
            self._runner = BatchRunner(
                weights=weights,
                lut=lut,
                cuckoo=cuckoo,
                spec=self.profile.spec,
                device=None if mesh is not None else device,
                mesh=mesh,
                batch_size=self.get("batchSize"),
                quantization=self.get("quantization"),
                max_score_bytes=self.get("maxScoreBytes"),
                # maxScoreBytes truncation must know how the docs were
                # encoded: low_byte docs take a hard slice.
                score_encoding=self.get("predictEncoding"),
            )
        return self._runner

    def hold_runner(self, runner: BatchRunner | None = None) -> BatchRunner:
        """Take one hold on the cached runner (``runner``, or the model's
        own, built if needed): it stays cached until every hold is given
        back through :meth:`release_runner`. Registries that share one model
        (a fleet's replicas, tenants of a zoo) hold it once per serving
        version, so one replica's retirement does not drop a runner the
        others still serve from, and a re-activation finds it."""
        with self._runner_lock:
            if runner is None:
                runner = self._runner_locked()
            elif self._runner is None:
                self._runner = runner
            self._runner_holds += 1
            return runner

    def release_runner(self) -> None:
        """Give back one hold; with none left, drop the cached runner, so its
        device tables and pinned staging can be freed once no caller holds
        it. The next ``runner`` read builds a new one."""
        with self._runner_lock:
            self._runner_holds = max(0, self._runner_holds - 1)
            if self._runner_holds == 0:
                self._runner = None

    def transform(self, dataset: Table) -> Table:
        out_schema = self.transform_schema(dataset.schema)
        texts = dataset.column(self.get_input_col()).tolist()
        docs = texts_to_bytes(texts, self.get("predictEncoding"))
        if self.get("resultMode") == "segment":
            # One canonical JSON object per document (sort_keys ⇒ byte-
            # stable for identical results), in the same STRING column as
            # label mode, so every Table consumer composes unchanged.
            detected = [
                json.dumps(r, sort_keys=True) for r in self.segment_bytes(docs)
            ]
        else:
            detected = self.runner.predict(docs, self.profile.languages)
        result = dataset.with_column(self.get_output_col(), detected, STRING)
        if result.schema != out_schema:
            raise RuntimeError(
                "transform produced a schema that disagrees with "
                f"transform_schema: {result.schema} != {out_schema}"
            )
        return result

    def detect(self, text: str):
        """Single-document convenience (the reference's static ``detect``).
        In ``resultMode="segment"`` this returns the decoded result dict
        (spans, top-k, reject) instead of one label string."""
        if self.get("resultMode") == "segment":
            return self.segment([text])[0]
        return self.transform(Table({self.get_input_col(): [text]})).column(
            self.get_output_col()
        )[0]

    # -- segmentation ----------------------------------------------------------
    def _segment_options(self) -> SegmentOptions:
        return SegmentOptions(
            top_k=int(self.get("topK")),
            reject_threshold=float(self.get("rejectThreshold")),
        )

    def segment(self, texts: Sequence[str]) -> list[dict]:
        """Span-level code-switch decode for ``texts``: one dict per document
        with byte-offset ``spans``, calibrated ``topk`` candidates and the
        ``unknown`` reject, regardless of the ``resultMode`` param
        (``transform`` consults the param; this method is segment mode)."""
        return self.segment_bytes(
            texts_to_bytes(list(texts), self.get("predictEncoding"))
        )

    def segment_bytes(self, byte_docs: Sequence[bytes]) -> list[dict]:
        return segment_documents(
            self.runner,
            byte_docs,
            self.profile.languages,
            options=self._segment_options(),
            calibration=self.calibration,
        )

    def calibrate(
        self, heldout: Table, *, label_col: str = "lang"
    ) -> "LanguageDetectorModel":
        """Fit the per-language temperature calibration on a held-out
        labeled table (``inputCol`` text + ``label_col`` true language).
        Deterministic (fixed grids, no RNG); the fitted state lives on
        ``self.calibration`` and stamps every segment result
        ``calibrated: true``. Returns ``self``.
        """
        texts = heldout.column(self.get_input_col()).tolist()
        labels = heldout.column(label_col).tolist()
        langs = list(self.profile.languages)
        lang_idx = {l: i for i, l in enumerate(langs)}
        unknown = sorted({l for l in labels if l not in lang_idx})
        if unknown:
            raise ValueError(
                f"held-out labels {unknown} not in supportedLanguages"
            )
        docs = texts_to_bytes(texts, self.get("predictEncoding"))
        runner = self.runner
        scores = runner.score(docs)
        # Length-normalize by the byte count the runner scored
        # (maxScoreBytes truncation included): the transform the segment
        # decode applies, or the temperatures would be fit on another logit
        # scale than they are used on.
        lens = [len(d) for d in runner.scored_docs(docs)]
        self.calibration = fit_calibration(
            normalize_scores(np.asarray(scores, dtype=np.float64), lens),
            np.asarray([lang_idx[l] for l in labels], dtype=np.int64),
            len(langs),
        )
        return self

    # -- persistence -----------------------------------------------------------
    def write(self) -> "_ModelWriter":
        return _ModelWriter(self)

    def save(self, path: str) -> None:
        """Overwrite semantics, like the reference's writer
        (SaveMode.Overwrite). ``write().save(path)`` refuses an existing
        path."""
        self.write().overwrite().save(path)

    @staticmethod
    def load(path: str, device: str | None = None) -> "LanguageDetectorModel":
        """Load a model directory saved by this package or the JAX package
        (native or reference layout) to run on ``device`` (None ⇒ the CUDA
        card). No saved model names a device: that is the caller's."""
        from ..persist.io import load_model

        profile, uid, params, calibration = load_model(path)
        model = LanguageDetectorModel(profile, uid=uid)
        model._set_params_from_metadata(params)
        if device is not None:
            model.set("device", device)
        if calibration is not None:
            model.calibration = Calibration.from_dict(calibration)
        return model


class _ModelWriter:
    """``model.write().save(path)``: the MLWritable shape."""

    def __init__(self, model: LanguageDetectorModel):
        self._model = model
        self._overwrite = False  # destructive only after .overwrite()
        self._layout = "native"
        self._quantize: str | None = None

    def overwrite(self) -> "_ModelWriter":
        self._overwrite = True
        return self

    def quantized(self, dtype: str = "int8") -> "_ModelWriter":
        """Store the weight table quantized ('int8' | 'int16'): integer
        parquet rows + per-language f32 scales in the metadata (native
        layout only; see :func:`..persist.io.save_model`)."""
        self._quantize = dtype
        return self

    def reference_layout(self) -> "_ModelWriter":
        """Write the Scala implementation's on-disk shape (tuple-column
        probabilities parquet, JVM class name). Exact vocabs only."""
        self._layout = "reference"
        return self

    def save(self, path: str) -> None:
        from ..persist.io import save_model

        calibration = self._model.calibration
        save_model(
            path,
            self._model.profile,
            self._model.uid,
            self._model.param_metadata(),
            overwrite=self._overwrite,
            layout=self._layout,
            quantize=self._quantize,
            calibration=None if calibration is None else calibration.to_dict(),
        )
