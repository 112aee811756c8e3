"""Pipeline: chain preprocessors and an estimator into one fit/transform unit.

Port of ``spark_languagedetector_tpu.api.pipeline``, with Spark ML's
semantics: stages run in declaration order; in ``Pipeline.fit`` only the
stages strictly before the last estimator transform the training data (the
last estimator's model, and the stages after it, join the
``PipelineModel`` without running on the training table); ``copy``
deep-copies the stage list.

Persistence uses the JAX package's directory layout: a ``metadata/`` JSON
names the stages in order, and each stage saves under
``stages/<idx>_<uid>/``: the detector model through its own writer, the
params-only stages (the preprocessors and the estimator) as a metadata-only
directory. Saves are crash-atomic (built under a temp sibling, swapped in
by renames).

Stage classes are looked up in a fixed table, never imported by name: the
table maps the JAX package's class strings (which this writer stores, so
the JAX package loads a pipeline saved here) and the port's own to the
port's classes, and any other name is refused.
"""

from __future__ import annotations

import copy as _copy
import json
import re
import shutil
import time
from pathlib import Path
from typing import Sequence

from ..models.estimator import LanguageDetector, LanguageDetectorModel
from ..models.preprocessing import LowerCasePreprocessor, SpecialCharPreprocessor
from ..persist.io import fresh_tmp, swap_in
from ..utils.identifiable import Identifiable

_JAX_PACKAGE = "spark_languagedetector_tpu"
_PIPELINE_CLASS = f"{_JAX_PACKAGE}.api.pipeline.Pipeline"
_PIPELINE_MODEL_CLASS = f"{_JAX_PACKAGE}.api.pipeline.PipelineModel"

# Every stage class the JAX package saves, under the class string it writes
# (module path + name), and the port module that holds the same class.
_STAGE_MODULES = {
    LanguageDetector: "models.estimator",
    LanguageDetectorModel: "models.estimator",
    LowerCasePreprocessor: "models.preprocessing",
    SpecialCharPreprocessor: "models.preprocessing",
}
_WRITE_NAME = {
    cls: f"{_JAX_PACKAGE}.{mod}.{cls.__name__}" for cls, mod in _STAGE_MODULES.items()
}
_STAGE_CLASSES = {
    f"{package}.{mod}.{cls.__name__}": cls
    for cls, mod in _STAGE_MODULES.items()
    for package in (_JAX_PACKAGE, f"{_JAX_PACKAGE}_torch")
}


def _write_metadata(stage_dir: Path, payload: dict) -> None:
    """``<dir>/metadata/part-00000``, one JSON line, Spark-style."""
    meta_dir = stage_dir / "metadata"
    meta_dir.mkdir(parents=True)
    (meta_dir / "part-00000").write_text(json.dumps(payload) + "\n")


def _read_metadata(stage_dir: Path) -> dict:
    return json.loads((stage_dir / "metadata" / "part-00000").read_text().splitlines()[0])


class Pipeline(Identifiable):
    """Estimator over an ordered list of stages (transformers/estimators)."""

    def __init__(self, stages: Sequence[object], uid: str | None = None):
        super().__init__(uid, uid_prefix="Pipeline")
        for s in stages:
            if not hasattr(s, "transform") and not hasattr(s, "fit"):
                raise TypeError(f"pipeline stage {s!r} has neither transform nor fit")
        self.stages = list(stages)

    def fit(self, dataset) -> "PipelineModel":
        last_fit = max(
            (i for i, s in enumerate(self.stages) if hasattr(s, "fit")), default=-1
        )
        fitted = []
        current = dataset
        for i, stage in enumerate(self.stages):
            fitted_stage = stage.fit(current) if hasattr(stage, "fit") else stage
            fitted.append(fitted_stage)
            if i < last_fit:
                current = fitted_stage.transform(current)
        return PipelineModel(fitted)

    def copy(self, extra=None):
        return Pipeline([_copy.deepcopy(s) for s in self.stages], uid=self.uid)

    def write(self) -> "_PipelineWriter":
        return _PipelineWriter(self, _PIPELINE_CLASS)

    def save(self, path: str) -> None:
        self.write().overwrite().save(path)

    @staticmethod
    def load(path: str, device: str | None = None) -> "Pipeline":
        """Load a pipeline saved by this package or the JAX package;
        ``device`` (None ⇒ the CUDA card; no save names one) is set on
        every stage that has the param."""
        meta, stages = _load_pipeline_dir(Path(path), _PIPELINE_CLASS, device)
        return Pipeline(stages, uid=meta["uid"])


class PipelineModel(Identifiable):
    """Transformer chaining the fitted stages of a :class:`Pipeline`."""

    def __init__(self, stages: Sequence[object], uid: str | None = None):
        super().__init__(uid, uid_prefix="PipelineModel")
        self.stages = list(stages)

    def transform(self, dataset):
        current = dataset
        for stage in self.stages:
            current = stage.transform(current)
        return current

    def copy(self, extra=None):
        return PipelineModel([_copy.deepcopy(s) for s in self.stages], uid=self.uid)

    def write(self) -> "_PipelineWriter":
        return _PipelineWriter(self, _PIPELINE_MODEL_CLASS)

    def save(self, path: str) -> None:
        """Overwrite semantics; ``write().save(path)`` refuses an existing
        path."""
        self.write().overwrite().save(path)

    @staticmethod
    def load(path: str, device: str | None = None) -> "PipelineModel":
        """Load a fitted pipeline saved by this package or the JAX package;
        ``device`` (None ⇒ the CUDA card; no save names one) is set on
        every stage that has the param."""
        meta, stages = _load_pipeline_dir(Path(path), _PIPELINE_MODEL_CLASS, device)
        return PipelineModel(stages, uid=meta["uid"])


def _stage_class(name: str):
    try:
        return _STAGE_CLASSES[name]
    except KeyError:
        raise ValueError(
            f"refusing pipeline stage class {name!r}: not one of "
            f"{sorted(_STAGE_CLASSES)}"
        ) from None


def _load_pipeline_dir(root: Path, expected_class: str, device: str | None):
    """(metadata, stages) of a saved pipeline directory."""
    meta = _read_metadata(root)
    accepted = (expected_class, expected_class.replace(_JAX_PACKAGE, f"{_JAX_PACKAGE}_torch", 1))
    if meta.get("class") not in accepted:
        raise ValueError(
            f"metadata class mismatch: expected {expected_class}, got {meta.get('class')}"
        )
    stages = []
    for info in meta["stages"]:
        cls = _stage_class(info["class"])
        # The directory name comes from the metadata file: confine it to a
        # plain child of stages/.
        dir_name = info["dir"]
        if not re.fullmatch(r"[A-Za-z0-9._-]+", dir_name) or dir_name in ("..", "."):
            raise ValueError(
                f"refusing stage directory name {dir_name!r}: must be a "
                "plain name under stages/"
            )
        sdir = root / "stages" / dir_name
        if info.get("writable"):
            stage = cls.load(str(sdir))
        else:
            smeta = _read_metadata(sdir)
            pmeta = smeta.get("paramMap", {})
            if hasattr(cls, "_from_param_metadata"):
                stage = cls._from_param_metadata(smeta["uid"], pmeta)
            else:
                stage = cls(uid=smeta["uid"])
                stage._set_params_from_metadata(pmeta)
        if device is not None and "device" in type(stage).params():
            stage.set("device", device)
        stages.append(stage)
    return meta, stages


class _PipelineWriter:
    """``pipeline.write().save(path)`` for ``Pipeline`` and
    ``PipelineModel`` (the metadata class tells the loaders apart)."""

    def __init__(self, model, class_name: str):
        self._model = model
        self._class_name = class_name
        self._overwrite = False

    def overwrite(self) -> "_PipelineWriter":
        self._overwrite = True
        return self

    def save(self, path: str) -> None:
        root = Path(path)
        if root.exists() and not self._overwrite:
            raise FileExistsError(f"{root} already exists")
        tmp = fresh_tmp(root)
        try:
            self._write_tree(tmp)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        swap_in(tmp, root)

    def _write_tree(self, tmp: Path) -> None:
        stage_info = []
        for i, stage in enumerate(self._model.stages):
            cls_name = _WRITE_NAME.get(type(stage))
            if cls_name is None:
                raise TypeError(
                    f"cannot persist pipeline stage {stage!r}: only "
                    f"{sorted(c.__name__ for c in _WRITE_NAME)} stages load back"
                )
            writable = hasattr(stage, "write")
            dir_name = f"{i:02d}_{stage.uid}"
            sdir = tmp / "stages" / dir_name
            if writable:
                sdir.parent.mkdir(parents=True, exist_ok=True)
                stage.write().save(str(sdir))
            else:
                _write_metadata(
                    sdir,
                    {
                        "class": cls_name,
                        "uid": stage.uid,
                        "timestamp": int(time.time() * 1000),
                        "paramMap": stage.param_metadata(),
                    },
                )
            stage_info.append(
                {"class": cls_name, "uid": stage.uid, "dir": dir_name, "writable": writable}
            )
        _write_metadata(
            tmp,
            {
                "class": self._class_name,
                "uid": self._model.uid,
                "timestamp": int(time.time() * 1000),
                "stages": stage_info,
            },
        )
