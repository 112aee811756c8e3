"""LanguageDetector (Estimator) and LanguageDetectorModel (Model/Transformer).

Port of ``spark_languagedetector_tpu.models.estimator`` in label mode: the
reference's Spark ML pair with the same Params, defaults and validation
messages (``inputCol="fulltext"``, ``labelCol``/``outputCol="lang"``). Fit
builds a columnar :class:`GramProfile` with the host numpy fit; transform
ships micro-batches through :class:`~..api.runner.BatchRunner`, whose fused
CUDA kernel labels documents on the card.

Where the JAX package had a ``backend`` switch, the port has ``device``:
None means the CUDA card (and raises when there is none); ``"cpu"`` runs
the plain PyTorch versions. ``fitBackend="device"``, ``resultMode="segment"``
and model persistence belong to later slices of the port and raise
NotImplementedError.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..api.params import HasInputCol, HasLabelCol, HasOutputCol, Param
from ..api.runner import BatchRunner
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
from ..utils.device import resolve_device
from .profile import GramProfile

RESULT_MODES = ("label", "segment")


def _positive_int(v) -> bool:
    return isinstance(v, int) and v > 0


def _valid_reject_threshold(v) -> bool:
    return isinstance(v, (int, float)) and 0.0 <= float(v) < 1.0


def _valid_device(v) -> bool:
    return v is None or isinstance(v, str)


def _later_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the PyTorch port yet; a later slice brings it over"
    )


class _ResultModeParams:
    """Segmentation result-type params, shared by estimator and model."""

    result_mode = Param(
        "resultMode",
        "transform output type: 'label' (the reference's one-language "
        "argmax column) or 'segment' (span-level code-switch decode; not in "
        "the PyTorch port yet)",
        lambda v: v in RESULT_MODES,
    )
    top_k = Param(
        "topK",
        "segment mode: candidate languages returned per document",
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
        "when none is visible), 'cpu' ⇒ the plain PyTorch versions, or "
        "any torch device string such as 'cuda:1'",
        _valid_device,
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
        "reference's saveGramsToHDFS; not in the PyTorch port yet)",
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
        "'cpu' (host fit — the reference keeps fit on CPU) or 'device' "
        "(not in the PyTorch port yet)",
        lambda v: v in ("cpu", "device"),
    )
    fit_batch_rows = Param(
        "fitBatchRows",
        "device-fit micro-batch rows per count dispatch; ignored by "
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
        # The model runs where the estimator says; resolving here makes a
        # machine without a card fail before the fit, not after it.
        resolve_device(self.get("device"))
        if self.get("fitBackend") == "device":
            raise _later_slice("fitBackend='device'")
        if self.get("saveGrams") is not None:
            raise _later_slice("saveGrams (gram dump persistence)")
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
        ids, weights = fit_ops.fit_profile_numpy(
            docs,
            lang_idx,
            len(supported),
            spec,
            self.get("languageProfileSize"),
            self.get("weightMode"),
        )
        profile = GramProfile(
            spec=spec, languages=tuple(supported), ids=ids, weights=weights
        )
        return self._build_model(profile)

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
        # tensors; they rebuild it lazily.
        state = self.__dict__.copy()
        state["_runner"] = None
        return state

    @property
    def runner(self) -> BatchRunner:
        """The model's runner, built on first use (uploads the fused table)."""
        if self._runner is None:
            weights, lut = self.profile.host_membership()
            self._runner = BatchRunner(
                weights=weights,
                lut=lut,
                spec=self.profile.spec,
                device=self.get("device"),
                batch_size=self.get("batchSize"),
                quantization=self.get("quantization"),
                max_score_bytes=self.get("maxScoreBytes"),
                # maxScoreBytes truncation must know how the docs were
                # encoded: low_byte docs take a hard slice.
                score_encoding=self.get("predictEncoding"),
            )
        return self._runner

    def transform(self, dataset: Table) -> Table:
        if self.get("resultMode") == "segment":
            raise _later_slice("resultMode='segment'")
        out_schema = self.transform_schema(dataset.schema)
        texts = dataset.column(self.get_input_col()).tolist()
        docs = texts_to_bytes(texts, self.get("predictEncoding"))
        detected = self.runner.predict(docs, self.profile.languages)
        result = dataset.with_column(self.get_output_col(), detected, STRING)
        if result.schema != out_schema:
            raise RuntimeError(
                "transform produced a schema that disagrees with "
                f"transform_schema: {result.schema} != {out_schema}"
            )
        return result

    def detect(self, text: str) -> str:
        """Single-document convenience (the reference's static ``detect``)."""
        return self.transform(Table({self.get_input_col(): [text]})).column(
            self.get_output_col()
        )[0]
