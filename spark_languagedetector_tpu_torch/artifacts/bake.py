"""Baked model artifacts: mmap-ready tables for the cold-start plane.

Port of ``spark_languagedetector_tpu.artifacts.bake``, in the same
``ldbake`` v1 format byte for byte, so either package loads the other's
bake. Loading the parquet model tree (``persist/io``) is a parse: every row
goes through Arrow into Python lists, ids are re-sorted and the device
membership tables (dense table, LUT or cuckoo) are rebuilt in every process.
A baked artifact is the same model laid out for page-in: raw little-endian
numpy blocks (quantized int8/int16 rows or f64 weights, sorted ids, the LUT
or cuckoo state, the f32 device table) behind one JSON header. Loading is
``np.memmap``: no parse, no table rebuild, and replicas on one host share
the page cache because they map the same file.

Layout (a directory, beside the parquet tree it shadows)::

    <name>.baked/
      header.json   format/version, class/uid/paramMap/vocab/languages,
                    calibration, quantization scales, device form,
                    cuckoo seeds, the block table, file_bytes
      blocks.bin    4096-aligned little-endian blocks + 8-byte end magic

The tree is built under a ``.<name>.tmp.<pid>`` sibling and swapped in with
the two-rename protocol of ``persist.io.save_model``; :func:`recover_artifact`
promotes, when the root is missing, the newest sibling that fully validates
(a build killed mid-write leaves a header that parses over truncated blocks;
the ``file_bytes`` and end-magic checks refuse it) and deletes the other
siblings only after a successful promotion.

A quantized bake stores the integer rows and per-language f32 scales of the
parquet quantization codec, and the loader rebuilds the weights with the
same exact f64 product, so a baked model scores bit for bit as the
parquet-loaded one. The mapped blocks are read-only: the runner reads them
on the host and sends them to the card through a pinned buffer
(``exec.staging.upload``), and on the CPU copies them before any op could
write through them.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np

from ..models.profile import (
    DENSE_TABLE_BUDGET_BYTES,
    GramProfile,
    quantize_weights,
)
from ..ops.vocab import VocabSpec
from ..persist.io import _CLASS_NAME, _siblings, fresh_tmp, swap_in
from ..telemetry.registry import REGISTRY
from ..utils.logging import get_logger, log_event

_log = get_logger("artifacts.bake")

FORMAT = "ldbake"
FORMAT_VERSION = 1
HEADER_NAME = "header.json"
BLOCKS_NAME = "blocks.bin"
ARTIFACT_SUFFIX = ".baked"
# Every block starts on an mmap page boundary, so a reader faults exactly
# the pages it touches.
_ALIGN = 4096
# Written after the last block: a truncated blocks.bin cannot carry it, so
# its presence and the header's file_bytes detect a torn write without
# reading every page up front.
MAGIC = b"LDBAKED1"


class ArtifactError(ValueError):
    """A baked artifact that must not be loaded (torn, foreign, or from a
    different format version)."""


# ----------------------------------------------------------------- paths ----
def artifact_path_for(
    model_path: str | Path, artifact_dir: str | None = None, env=os.environ
) -> Path:
    """Where the baked artifact for ``model_path`` lives: ``<model
    name>.baked`` under the ``artifact_dir`` knob (or the explicit
    argument), else a ``<model>.baked`` sibling of the model tree."""
    from ..exec import config as exec_config

    resolved = exec_config.resolve("artifact_dir", artifact_dir, env)
    base = Path(model_path)
    if resolved:
        return Path(resolved) / (base.name + ARTIFACT_SUFFIX)
    return base.parent / (base.name + ARTIFACT_SUFFIX)


# ------------------------------------------------------------------ bake ----
def _device_form(compact: GramProfile, budget: int):
    """(form, blocks, cuckoo_meta): the host arrays of
    ``GramProfile.device_membership`` at f32, so the baked tables are those
    a parquet load's runner would build."""
    weights, lut, cuckoo = compact.device_membership(
        device="cpu", dense_budget_bytes=budget
    )
    w = weights.numpy()
    if cuckoo is not None:
        blocks = [
            ("dev_weights", w),
            ("cuckoo_slots", cuckoo.slots),
            ("cuckoo_keys_lo", cuckoo.keys_lo),
            ("cuckoo_keys_hi", cuckoo.keys_hi),
        ]
        return "cuckoo", blocks, {"seed1": cuckoo.seed1, "seed2": cuckoo.seed2}
    if lut is None:
        return "dense", [("dev_dense", w)], None
    return "lut", [("dev_weights", w), ("dev_lut", lut.numpy())], None


def bake_artifact(
    path: str | Path,
    profile: GramProfile,
    uid: str,
    params: dict,
    *,
    calibration: dict | None = None,
    quantize: str | None = None,
    dense_budget_bytes: int = DENSE_TABLE_BUDGET_BYTES,
) -> str:
    """Write the baked artifact directory for one model (overwrite
    semantics, crash-atomic). ``quantize`` ('int8' | 'int16') stores the
    integer rows and per-language f32 scales of the
    ``persist.io.save_model(quantize=...)`` codec; None bakes the f64
    rows."""
    compact = profile.compacted()
    arrays: list[tuple[str, np.ndarray]] = [
        ("ids", np.ascontiguousarray(compact.ids, dtype=np.int64))
    ]
    quant_meta = None
    if quantize is not None:
        q, scales = quantize_weights(compact.weights, quantize)
        quant_meta = {"dtype": quantize, "scales": [float(s) for s in scales]}
        arrays.append(("weights_q", q))
        # The device tables mirror what a parquet load of the same codec
        # builds: the dequantized q * scale product, not the weights before
        # quantization (those would drift by one rounding step).
        compact = GramProfile(
            spec=compact.spec,
            languages=compact.languages,
            ids=compact.ids,
            weights=q.astype(np.float64) * np.asarray(scales, dtype=np.float64),
        )
    else:
        arrays.append(
            ("weights_f64", np.ascontiguousarray(compact.weights, np.float64))
        )
    form, dev_blocks, cuckoo_meta = _device_form(compact, dense_budget_bytes)
    arrays.extend(dev_blocks)

    blocks = []
    offset = 0
    for name, arr in arrays:
        arr = np.ascontiguousarray(arr)
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        offset = -(-offset // _ALIGN) * _ALIGN
        blocks.append({
            "name": name,
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
            "offset": offset,
            "nbytes": int(arr.nbytes),
        })
        offset += int(arr.nbytes)
    file_bytes = offset + len(MAGIC)

    header = {
        "format": FORMAT,
        "version": FORMAT_VERSION,
        "class": _CLASS_NAME,
        "uid": uid,
        "paramMap": params,
        "vocab": {
            "mode": compact.spec.mode,
            "gramLengths": list(compact.spec.gram_lengths),
            "hashBits": compact.spec.hash_bits,
            "hashScheme": compact.spec.hash_scheme,
        },
        "languages": list(compact.languages),
        "calibration": calibration,
        "quantization": quant_meta,
        "device_form": form,
        "dense_budget_bytes": int(dense_budget_bytes),
        "cuckoo": cuckoo_meta,
        "blocks": blocks,
        "file_bytes": file_bytes,
    }

    root = Path(path)
    tmp = fresh_tmp(root)
    try:
        with open(tmp / BLOCKS_NAME, "wb") as fh:
            for spec_row, (_, arr) in zip(blocks, arrays):
                fh.seek(spec_row["offset"])
                fh.write(np.ascontiguousarray(arr).tobytes())
            fh.seek(file_bytes - len(MAGIC))
            fh.write(MAGIC)
        (tmp / HEADER_NAME).write_text(json.dumps(header) + "\n")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    swap_in(tmp, root)
    log_event(
        _log, "artifact.baked", path=str(root), grams=compact.num_grams,
        device_form=form, quantize=quantize, bytes=file_bytes,
    )
    return str(root)


def bake_model(model, path: str | Path, *, quantize: str | None = None) -> str:
    """Bake a fitted or loaded ``LanguageDetectorModel``."""
    calibration = model.calibration
    return bake_artifact(
        path,
        model.profile,
        model.uid,
        model.param_metadata(),
        calibration=None if calibration is None else calibration.to_dict(),
        quantize=quantize,
    )


# ------------------------------------------------------------------ load ----
# One live mapping per blocks file: every reader's block views slice the
# same buffer. Keyed on (realpath, size, mtime_ns), so a re-baked artifact
# maps fresh.
_MMAP_CACHE: dict[tuple, np.memmap] = {}


def _mapped(blocks_path: Path) -> np.memmap:
    st = os.stat(blocks_path)
    key = (os.path.realpath(blocks_path), st.st_size, st.st_mtime_ns)
    mm = _MMAP_CACHE.get(key)
    if mm is None:
        mm = np.memmap(blocks_path, dtype=np.uint8, mode="r")
        _MMAP_CACHE[key] = mm
    return mm


class BakedArtifact:
    """A validated, mapped artifact: ``header`` and read-only block views."""

    def __init__(self, path: Path, header: dict, buf: np.memmap):
        self.path = path
        self.header = header
        self._buf = buf
        self._blocks = {b["name"]: b for b in header["blocks"]}

    def block(self, name: str) -> np.ndarray:
        spec = self._blocks.get(name)
        if spec is None:
            raise ArtifactError(
                f"{self.path}: no block {name!r}; artifact carries "
                f"{sorted(self._blocks)}"
            )
        off, nbytes = spec["offset"], spec["nbytes"]
        view = self._buf[off : off + nbytes].view(np.dtype(spec["dtype"]))
        return view.reshape(tuple(spec["shape"]))


def load_artifact(path: str | Path) -> BakedArtifact:
    """Map and validate one baked artifact; raises :class:`ArtifactError`
    on anything torn or foreign."""
    root = Path(path)
    header_path = root / HEADER_NAME
    blocks_path = root / BLOCKS_NAME
    try:
        header = json.loads(header_path.read_text())
    except (OSError, ValueError) as e:
        raise ArtifactError(f"{root}: unreadable header: {e}") from e
    if header.get("format") != FORMAT or header.get("version") != FORMAT_VERSION:
        raise ArtifactError(
            f"{root}: format {header.get('format')!r} v"
            f"{header.get('version')!r}; this build reads {FORMAT} "
            f"v{FORMAT_VERSION}"
        )
    file_bytes = header.get("file_bytes")
    try:
        actual = os.stat(blocks_path).st_size
    except OSError as e:
        raise ArtifactError(f"{root}: missing {BLOCKS_NAME}: {e}") from e
    if actual != file_bytes:
        raise ArtifactError(
            f"{root}: {BLOCKS_NAME} holds {actual} bytes, header promises "
            f"{file_bytes} — torn write, refusing to load"
        )
    buf = _mapped(blocks_path)
    if bytes(buf[-len(MAGIC):]) != MAGIC:
        raise ArtifactError(f"{root}: end magic missing — torn write")
    for spec_row in header.get("blocks", ()):
        end = spec_row["offset"] + spec_row["nbytes"]
        if spec_row["offset"] % _ALIGN or end > file_bytes - len(MAGIC):
            raise ArtifactError(
                f"{root}: block {spec_row['name']!r} lies outside the "
                f"mapped region"
            )
    return BakedArtifact(root, header, buf)


def recover_artifact(path: str | Path) -> bool:
    """Finish a bake swap a crash interrupted; True when recovered.

    When ``path`` is missing, promote the newest ``.tmp``/``.old`` sibling
    that fully validates (:func:`load_artifact`), deleting the other
    siblings only after the promotion. No-op when ``path`` exists."""
    root = Path(path)
    if root.exists():
        return False
    candidates = _siblings(root)
    candidates.sort(key=lambda p: p.stat().st_mtime, reverse=True)
    for cand in candidates:
        try:
            load_artifact(cand)
        except Exception:
            continue  # a torn or foreign candidate is never promoted
        os.replace(cand, root)
        for stale in _siblings(root):
            shutil.rmtree(stale, ignore_errors=True)
        log_event(_log, "artifact.recovered", path=str(root), source=cand.name)
        return True
    return False


def load_baked_model(path: str | Path, device: str | None = None):
    """Artifact directory → ``LanguageDetectorModel`` on ``device`` (None ⇒
    the CUDA card, as ``LanguageDetectorModel.load``).

    The profile's weights are the exact f64 ``q * scale`` product the
    parquet loader computes, and the device membership tables are attached
    as mapped views (``_prebuilt_membership``), so the runner build skips
    the LUT and cuckoo rebuild."""
    art = load_artifact(path)
    h = art.header
    spec = VocabSpec(
        h["vocab"]["mode"],
        tuple(int(n) for n in h["vocab"]["gramLengths"]),
        hash_bits=h["vocab"].get("hashBits", 20),
        hash_scheme=h["vocab"].get("hashScheme", "fnv1a"),
    )
    ids = art.block("ids")
    quant = h.get("quantization")
    if quant is not None:
        weights = art.block("weights_q").astype(np.float64) * np.asarray(
            quant["scales"], dtype=np.float64
        )
    else:
        weights = art.block("weights_f64")
    profile = GramProfile(
        spec=spec, languages=tuple(h["languages"]), ids=ids, weights=weights
    )

    from ..models.estimator import LanguageDetectorModel
    from ..segment.calibrate import Calibration

    model = LanguageDetectorModel(profile, uid=h["uid"])
    model._set_params_from_metadata(h.get("paramMap", {}))
    if device is not None:
        model.set("device", device)
    if h.get("calibration") is not None:
        model.calibration = Calibration.from_dict(h["calibration"])

    form = h["device_form"]
    if form == "dense":
        weights_dev, lut, cuckoo = art.block("dev_dense"), None, None
    elif form == "lut":
        weights_dev, lut, cuckoo = art.block("dev_weights"), art.block("dev_lut"), None
    else:
        from ..ops.cuckoo import CuckooTable

        weights_dev, lut = art.block("dev_weights"), None
        cuckoo = CuckooTable(
            slots=art.block("cuckoo_slots"),
            keys_lo=art.block("cuckoo_keys_lo"),
            keys_hi=art.block("cuckoo_keys_hi"),
            seed1=int(h["cuckoo"]["seed1"]),
            seed2=int(h["cuckoo"]["seed2"]),
        )
    model._prebuilt_membership = {
        "dense_budget_bytes": int(h["dense_budget_bytes"]),
        "weights": weights_dev,
        "lut": lut,
        "cuckoo": cuckoo,
    }
    REGISTRY.incr("artifacts/baked_loads")
    return model


def maybe_load_baked(
    model_path: str | Path,
    artifact: str | Path | None = None,
    env=os.environ,
    device: str | None = None,
):
    """The cold-load fast path: the baked model on ``device`` when a valid
    artifact exists for ``model_path``, else None (the caller loads the
    parquet tree).

    Runs the sibling recovery first. A torn or foreign artifact is counted
    (``artifacts/load_errors``), logged, and answered with None: the parquet
    tree serves that load."""
    cand = (
        Path(artifact)
        if artifact is not None
        else artifact_path_for(model_path, env=env)
    )
    try:
        recover_artifact(cand)
    except OSError:
        pass
    if not cand.exists():
        return None
    try:
        return load_baked_model(cand, device=device)
    except Exception as e:
        REGISTRY.incr("artifacts/load_errors")
        log_event(
            _log, "artifact.load_failed", path=str(cand), error=str(e),
            fallback="parquet",
        )
        return None
