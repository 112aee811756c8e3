"""Model persistence: the JAX package's parquet layout, read and written.

Port of ``spark_languagedetector_tpu.persist.io`` (``save_model``,
``load_model``, ``save_gram_dump``, and the incremental fit's
``save_fit_state``/``recover_fit_state``/``load_fit_state``). A model
directory holds

    <path>/metadata/part-00000  one JSON line: class, uid, paramMap, and
                                (native layout) vocab, languages, optional
                                quantization scales and calibration
    <path>/probabilities/       parquet of (gram bytes | bucket id, weights)
    <path>/supportedLanguages/  parquet of language strings
    <path>/gramLengths/         parquet of ints

which is the reference's layout (``LanguageDetectorModel.scala:27-105``) plus
the JAX package's extras. Directories are byte-compatible both ways: a model
saved here loads in the JAX package and one saved there loads here. The JAX
loader accepts only its own class string or the Spark one, so this writer
stores the JAX package's class string as plain data, and the reader accepts
either. Nothing of the JAX package is imported.

``layout="reference"`` writes the Scala implementation's tuple columns
(``_1`` list<int8> signed JVM bytes, ``_2`` list<double>) under the Spark
class name, for exact vocabularies only. pyarrow is imported inside each
function, never when the package is imported.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path

import numpy as np

from ..models.profile import QUANT_DTYPES, GramProfile, quantize_weights
from ..ops.vocab import EXACT, VocabSpec
from ..utils.logging import get_logger, log_event

_log = get_logger("persist.io")

# Class strings are data here: the JAX package's loader checks for one of
# these two (its persist/io.py:46-49), so a port-saved model carries the
# first, and a reference-layout save the Spark one.
_CLASS_NAME = "spark_languagedetector_tpu.models.estimator.LanguageDetectorModel"
_SPARK_CLASS_NAME = (
    "org.apache.spark.ml.feature.languagedetection.LanguageDetectorModel"
)


def _write_parquet(path: Path, table) -> None:
    import pyarrow.parquet as pq

    path.mkdir(parents=True, exist_ok=True)
    pq.write_table(table, path / "part-00000.parquet")


def _read_parquet(path: Path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    files = sorted(path.glob("*.parquet"))
    if not files:
        raise FileNotFoundError(f"no parquet files under {path}")
    return pa.concat_tables([pq.read_table(f) for f in files])


def swap_in(tmp: Path, root: Path) -> None:
    """Replace ``root`` with the complete tree at ``tmp`` by two renames:
    the old root is renamed aside, ``tmp`` renamed in, and the old tree
    deleted only after that succeeded (a failed rename restores it). Stale
    ``.tmp``/``.old`` siblings of crashed earlier saves are then removed."""
    backup = None
    if root.exists():
        backup = root.parent / f".{root.name}.old.{os.getpid()}"
        if backup.exists():
            shutil.rmtree(backup)
        os.replace(root, backup)
    try:
        os.replace(tmp, root)
    except BaseException:
        if backup is not None:
            os.replace(backup, root)
        raise
    if backup is not None:
        shutil.rmtree(backup)
    for stale in _siblings(root):
        shutil.rmtree(stale, ignore_errors=True)


def _siblings(root: Path) -> list[Path]:
    """The ``.tmp``/``.old`` siblings a save of ``root`` builds or keeps."""
    return list(root.parent.glob(f".{root.name}.tmp.*")) + list(
        root.parent.glob(f".{root.name}.old.*")
    )


def fresh_tmp(root: Path) -> Path:
    """An empty temp sibling of ``root`` to build a save under."""
    tmp = root.parent / f".{root.name}.tmp.{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    return tmp


def _list_column(rows: np.ndarray, value_type):
    """A [R, L] array as an arrow list<value_type> column, one list per row
    (the JAX package's column type), built from the flat buffer."""
    import pyarrow as pa

    rows = np.ascontiguousarray(rows)
    R, L = rows.shape
    offsets = pa.array(np.arange(0, (R + 1) * L, L, dtype=np.int32))
    values = pa.array(rows.reshape(-1), type=value_type)
    return pa.ListArray.from_arrays(offsets, values)


def _rows_of(column, width: int) -> np.ndarray:
    """A list<number> column of equal-length lists as float64 [R, width]."""
    flat = column.combine_chunks().flatten().to_numpy(zero_copy_only=False)
    if len(flat) != len(column) * width:
        raise ValueError(
            f"probability rows carry {len(flat)} values for {len(column)} rows "
            f"of {width} languages"
        )
    return flat.astype(np.float64).reshape(len(column), width)


def _gram_rows_table(profile: GramProfile, rows, value_type):
    """probabilities/ of the native layout: gram bytes (exact) or bucket
    ids (hashed, compact rows) beside the weight rows."""
    import pyarrow as pa

    probs = _list_column(np.asarray(rows), value_type)
    if profile.spec.mode == EXACT:
        grams = [profile.spec.id_to_gram(int(i)) for i in profile.ids]
        return pa.table({"gram": pa.array(grams, type=pa.binary()), "probabilities": probs})
    return pa.table(
        {"bucket": pa.array(profile.ids.tolist(), type=pa.int64()), "probabilities": probs}
    )


def save_model(
    path: str | Path,
    profile: GramProfile,
    uid: str,
    params: dict,
    overwrite: bool = True,
    layout: str = "native",
    quantize: str | None = None,
    calibration: dict | None = None,
) -> None:
    """Write the model directory, crash-atomically.

    The tree is built under a temp sibling and swapped in with renames, so
    a process killed mid-save leaves the previous model or the new one at
    ``path``, never a torn tree. ``overwrite=False`` refuses an existing
    path.

    ``layout="reference"`` writes the Scala shape (tuple columns, the Spark
    class name, paramMap cut to ``inputCol``/``outputCol``); exact vocabs
    only, no quantization, and a calibration is dropped with a logged event
    (the loaded model segments with ``calibrated: false``).

    ``quantize`` ('int8' | 'int16') stores integer rows plus per-language
    f32 scales in the metadata (:func:`quantize_weights`); the loader
    rebuilds ``q * scale``, a fixed point of quantize∘dequantize.

    ``calibration`` is ``Calibration.to_dict()``: it rides in the metadata
    JSON, whose ``repr`` round-trips doubles exactly.
    """
    import pyarrow as pa

    if layout not in ("native", "reference"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "reference" and profile.spec.mode != EXACT:
        raise ValueError(
            "layout='reference' requires an exact vocab — the reference "
            "implementation stores gram bytes and has no hashed mode"
        )
    if quantize is not None:
        if quantize not in QUANT_DTYPES:
            raise ValueError(
                f"unknown quantize dtype {quantize!r}; expected one of "
                f"{tuple(QUANT_DTYPES)}"
            )
        if layout == "reference":
            raise ValueError(
                "quantize is a native-layout extension — the reference "
                "format stores float64 rows only"
            )
    root = Path(path)
    if root.exists() and not overwrite:
        raise FileExistsError(f"{root} already exists")
    if calibration is not None and layout == "reference":
        log_event(
            _log, "model.calibration_dropped", path=str(root),
            reason="reference layout has no calibration field; the loaded "
            "model serves segmentation with calibrated=false provenance",
        )
        calibration = None

    if layout == "reference":
        flat = {**params.get("defaultParams", {}), **params.get("params", {})}
        meta = {
            "class": _SPARK_CLASS_NAME,
            "timestamp": int(time.time() * 1000),
            "sparkVersion": "2.2.0",
            "uid": uid,
            "paramMap": {k: v for k, v in flat.items() if k in ("inputCol", "outputCol")},
        }
    else:
        meta = {
            "class": _CLASS_NAME,
            "timestamp": int(time.time() * 1000),
            "uid": uid,
            "paramMap": params,
            "vocab": {
                "mode": profile.spec.mode,
                "gramLengths": list(profile.spec.gram_lengths),
                "hashBits": profile.spec.hash_bits,
                "hashScheme": profile.spec.hash_scheme,
            },
            "languages": list(profile.languages),
        }
        if calibration is not None:
            n_temps = len(calibration.get("temperatures", ()))
            if n_temps != len(profile.languages):
                raise ValueError(
                    f"calibration covers {n_temps} languages, profile has "
                    f"{len(profile.languages)}"
                )
            meta["calibration"] = calibration

    tmp = fresh_tmp(root)
    try:
        compact = profile.compacted()
        if layout == "reference":
            grams = [profile.spec.id_to_gram(int(i)) for i in profile.ids]
            prob_table = pa.table(
                {
                    "_1": pa.array(
                        [np.frombuffer(g, np.uint8).astype(np.int8).tolist() for g in grams],
                        type=pa.list_(pa.int8()),
                    ),
                    "_2": _list_column(profile.weights.astype(np.float64), pa.float64()),
                }
            )
        elif quantize is not None:
            q, scales = quantize_weights(compact.weights, quantize)
            meta["quantization"] = {
                "dtype": quantize,
                "scales": [float(s) for s in scales],
            }
            prob_table = _gram_rows_table(compact, q.astype(np.int32), pa.int32())
        else:
            prob_table = _gram_rows_table(
                compact, compact.weights.astype(np.float64), pa.float64()
            )
        meta_dir = tmp / "metadata"
        meta_dir.mkdir()
        (meta_dir / "part-00000").write_text(json.dumps(meta) + "\n")
        _write_parquet(tmp / "probabilities", prob_table)
        _write_parquet(
            tmp / "supportedLanguages",
            pa.table({"value": pa.array(list(profile.languages), type=pa.string())}),
        )
        _write_parquet(
            tmp / "gramLengths",
            pa.table(
                {"value": pa.array(list(profile.spec.gram_lengths), type=pa.int32())}
            ),
        )
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    swap_in(tmp, root)
    log_event(
        _log, "model.saved", path=str(root), grams=profile.num_grams,
        calibrated=calibration is not None,
    )
    # With the bake_on_save knob on, every native save also bakes the
    # mmap-ready artifact (same quantization codec, same calibration), so
    # later cold loads map it instead of parsing this tree. The save has
    # committed already: a failed bake is logged, never raised.
    from ..exec import config as exec_config

    if layout == "native" and exec_config.resolve("bake_on_save"):
        from ..artifacts.bake import artifact_path_for, bake_artifact

        try:
            bake_artifact(
                artifact_path_for(root), profile, uid, params,
                calibration=calibration, quantize=quantize,
            )
        except Exception as e:
            log_event(_log, "model.bake_failed", path=str(root), error=repr(e))


def load_model(path: str | Path) -> tuple[GramProfile, str, dict, dict | None]:
    """Read a model directory → (profile, uid, params, calibration).

    Reads both column layouts (native ``gram``/``bucket`` + ``probabilities``
    and the reference's ``_1``/``_2`` tuple columns, whose signed JVM bytes
    wrap back to raw gram bytes) and checks the stored class name like the
    reference reader. ``calibration`` is None for a model saved without
    one: an uncalibrated model stays uncalibrated. A Spark-written flat
    paramMap is nested under ``"params"``.
    """
    root = Path(path)
    meta = json.loads((root / "metadata" / "part-00000").read_text().splitlines()[0])
    if meta.get("class") not in (_CLASS_NAME, _SPARK_CLASS_NAME):
        raise ValueError(
            f"metadata class mismatch: expected {_CLASS_NAME} or "
            f"{_SPARK_CLASS_NAME}, got {meta.get('class')}"
        )
    languages = tuple(_read_parquet(root / "supportedLanguages")["value"].to_pylist())
    gram_lengths = tuple(
        int(v) for v in _read_parquet(root / "gramLengths")["value"].to_pylist()
    )
    vocab_meta = meta.get("vocab", {})
    mode = vocab_meta.get("mode", EXACT)
    # Models saved before bucket schemes existed used pure FNV-1a.
    spec = VocabSpec(
        mode,
        gram_lengths,
        hash_bits=vocab_meta.get("hashBits", 20),
        hash_scheme=vocab_meta.get("hashScheme", "fnv1a"),
    )
    prob = _read_parquet(root / "probabilities")
    L = len(languages)
    if "_1" in prob.column_names:
        if mode != EXACT:
            raise ValueError(
                "reference-layout probabilities imply an exact vocab, but "
                f"metadata says mode={mode!r}"
            )
        # Signed JVM bytes wrap back to raw gram bytes.
        keys = [
            spec.gram_to_id(np.asarray(g, dtype=np.int8).astype(np.uint8).tobytes())
            for g in prob["_1"].to_pylist()
        ]
        rows = _rows_of(prob["_2"], L)
    else:
        rows = _rows_of(prob["probabilities"], L)
        if mode == EXACT:
            keys = [spec.gram_to_id(bytes(g)) for g in prob["gram"].to_pylist()]
        else:
            keys = prob["bucket"].to_pylist()
    keys = np.asarray(keys, dtype=np.int64)
    order = np.argsort(keys, kind="stable")
    ids = keys[order]
    weights = rows[order]
    quant_meta = meta.get("quantization")
    if quant_meta and len(weights):
        # Integer rows read back as float64 times the f32 scales: the
        # product is exact, so the device cast equals dequantize_weights.
        weights = weights * np.asarray(quant_meta["scales"], dtype=np.float64)
    profile = GramProfile(spec=spec, languages=languages, ids=ids, weights=weights)
    params = meta.get("paramMap", {})
    if meta.get("class") == _SPARK_CLASS_NAME:
        params = {"params": params}
    return profile, meta["uid"], params, meta.get("calibration")


# The incremental fit's state directory (:mod:`..models.refit`). The class
# string is the JAX package's, as data: its loader checks it (its
# persist/io.py:625-628), so a state saved by either package loads in the
# other.
_FIT_STATE_CLASS = "spark_languagedetector_tpu.models.refit.FitAccumulator"
FIT_STATE_VERSION = 1


def save_fit_state(
    path: str | Path,
    *,
    spec: VocabSpec,
    languages,
    weight_mode: str,
    profile_size: int,
    train_encoding: str,
    label_col: str,
    input_col: str,
    batch_rows: int | None,
    committed: int,
    docs_seen: int,
    lang_docs,
    ids: np.ndarray,
    rows: np.ndarray,
) -> None:
    """Persist an incremental-fit count accumulator (the fit's sufficient
    statistic) as a checkpoint directory.

    ``metadata/part-00000`` is one JSON line (spec, languages, weight mode,
    profile size, per-language doc coverage, and the resume token
    ``committed`` — the number of source batches whose counts the table
    already contains); ``counts/`` is parquet of the nonzero table rows
    (``id`` int64, ``counts`` list<int64> per language), so a 2^20 x 176
    table with a few hundred thousand occurring grams stores those rows,
    not the 738 MB dense form.

    Crash-atomic like a model save: the tree is built under a temp sibling
    and swapped in with two renames (:func:`swap_in`). The token travels
    inside the state, so counts and token never commit separately.
    """
    import pyarrow as pa

    root = Path(path)
    meta = {
        "class": _FIT_STATE_CLASS,
        "version": FIT_STATE_VERSION,
        "timestamp": int(time.time() * 1000),
        "vocab": {
            "mode": spec.mode,
            "gramLengths": list(spec.gram_lengths),
            "hashBits": spec.hash_bits,
            "hashScheme": spec.hash_scheme,
        },
        "languages": list(languages),
        "weightMode": weight_mode,
        "profileSize": int(profile_size),
        # Part of the statistic: the same corpus under another text→bytes
        # encoding counts other grams.
        "trainEncoding": train_encoding,
        "labelCol": label_col,
        "inputCol": input_col,
        "fitBatchRows": batch_rows,
        "committed": int(committed),
        "docsSeen": int(docs_seen),
        "langDocs": [int(c) for c in lang_docs],
    }
    tmp = fresh_tmp(root)
    try:
        meta_dir = tmp / "metadata"
        meta_dir.mkdir()
        (meta_dir / "part-00000").write_text(json.dumps(meta) + "\n")
        ids_np = np.ascontiguousarray(np.asarray(ids, dtype=np.int64))
        rows_np = np.asarray(rows, dtype=np.int64).reshape(len(ids_np), len(meta["languages"]))
        _write_parquet(
            tmp / "counts",
            pa.table({"id": pa.array(ids_np), "counts": _list_column(rows_np, pa.int64())}),
        )
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    swap_in(tmp, root)
    log_event(
        _log, "fit_state.saved", path=str(root), committed=int(committed),
        nonzero_rows=int(len(ids_np)),
    )


def recover_fit_state(path: str | Path) -> bool:
    """Finish a checkpoint swap a crash interrupted; True when recovered.

    Killed between "root renamed aside" and "tmp renamed in", the path
    holds no state: it lives complete in a ``.<name>.tmp.<pid>`` (new) or
    ``.<name>.old.<pid>`` (previous) sibling. When ``path`` is missing,
    this promotes the newest candidate (by mtime) that fully loads — a
    kill mid-build can leave a torn tmp whose metadata parses but whose
    counts are missing, so :func:`load_fit_state` is the guard. Other
    siblings are deleted only after a candidate was promoted. No-op when
    ``path`` exists.
    """
    root = Path(path)
    if root.exists():
        return False
    for cand in sorted(_siblings(root), key=lambda p: p.stat().st_mtime, reverse=True):
        try:
            state = load_fit_state(cand)
        except Exception:
            continue  # torn or foreign candidate: never promote it
        os.replace(cand, root)
        for stale in _siblings(root):
            shutil.rmtree(stale, ignore_errors=True)
        log_event(
            _log, "fit_state.recovered", path=str(root), source=cand.name,
            committed=state["committed"],
        )
        return True
    return False


def load_fit_state(path: str | Path) -> dict:
    """Read a persisted fit accumulator → dict with the metadata fields of
    :func:`save_fit_state` plus ``spec`` (a VocabSpec), ``ids`` (int64 [R])
    and ``rows`` (int64 [R, L]) sparse count rows."""
    root = Path(path)
    meta = json.loads((root / "metadata" / "part-00000").read_text().splitlines()[0])
    if meta.get("class") != _FIT_STATE_CLASS:
        raise ValueError(
            f"metadata class mismatch: expected {_FIT_STATE_CLASS}, got "
            f"{meta.get('class')}"
        )
    vocab = meta["vocab"]
    spec = VocabSpec(
        vocab["mode"],
        tuple(int(n) for n in vocab["gramLengths"]),
        hash_bits=vocab.get("hashBits", 20),
        hash_scheme=vocab.get("hashScheme", "fnv1a"),
    )
    table = _read_parquet(root / "counts")
    L = len(meta["languages"])
    ids = table["id"].combine_chunks().to_numpy(zero_copy_only=False).astype(np.int64, copy=False)
    flat = table["counts"].combine_chunks().flatten().to_numpy(zero_copy_only=False)
    if len(flat) != len(ids) * L:
        raise ValueError(
            f"count rows carry {len(flat)} values for {len(ids)} grams, "
            f"metadata says {L} languages"
        )
    rows = flat.astype(np.int64, copy=False).reshape(len(ids), L)
    return {
        "spec": spec,
        "languages": tuple(meta["languages"]),
        "weight_mode": meta["weightMode"],
        "profile_size": int(meta["profileSize"]),
        "train_encoding": meta.get("trainEncoding", "utf8"),
        "label_col": meta.get("labelCol", "lang"),
        "input_col": meta.get("inputCol", "fulltext"),
        "batch_rows": meta.get("fitBatchRows"),
        "committed": int(meta["committed"]),
        "docs_seen": int(meta["docsSeen"]),
        "lang_docs": [int(c) for c in meta["langDocs"]],
        "ids": ids,
        "rows": rows,
    }


def save_gram_dump(path: str | Path, profile: GramProfile) -> None:
    """The reference's ``saveGramsToHDFS`` artifact
    (``LanguageDetector.scala:167-171``): the fitted gram-probability
    dataset as parquet, overwrite mode."""
    import pyarrow as pa

    root = Path(path)
    if root.exists():
        shutil.rmtree(root)
    compact = profile.compacted()
    _write_parquet(root, _gram_rows_table(compact, compact.weights, pa.float64()))
    log_event(_log, "grams.saved", path=str(root))
