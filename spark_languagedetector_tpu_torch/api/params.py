"""Uniform hyper-parameter system for all pipeline stages.

Port of ``spark_languagedetector_tpu.api.params``: Spark ML's
``Param``/``Params`` framework as the reference uses it, except that *every*
hyper-parameter is a ``Param`` (the reference keeps ``supportedLanguages``,
``gramLengths`` and ``languageProfileSize`` as constructor arguments outside
``copy``), so ``copy()`` and persistence cover all of them uniformly.
"""

from __future__ import annotations

import copy as _copy
from typing import Any, Callable, Generic, TypeVar

from ..utils.identifiable import Identifiable

T = TypeVar("T")


class Param(Generic[T]):
    """A named, documented parameter slot declared on a ``Params`` class.

    ``persisted=False`` marks a property of the session rather than of the
    saved stage (the torch ``device``): persistence neither writes it nor
    reads it back, so a loaded stage takes it from its caller."""

    def __init__(
        self,
        name: str,
        doc: str,
        validator: Callable[[Any], bool] | None = None,
        *,
        persisted: bool = True,
    ):
        self.name = name
        self.doc = doc
        self.validator = validator
        self.persisted = persisted

    def __repr__(self) -> str:
        return f"Param({self.name})"


class Params(Identifiable):
    """Base class for anything configurable: estimators, models, transformers.

    Semantics mirror the Spark ML contract the reference relies on:
    - class-level ``Param`` declarations, discovered via the MRO;
    - ``set_default`` values overridable per-instance with ``set``;
    - ``get_or_default`` raising if neither set nor default exists;
    - ``copy(extra)`` producing a same-uid deep copy with overrides applied.
    """

    def __init__(self, uid: str | None = None, *, uid_prefix: str | None = None):
        super().__init__(uid, uid_prefix=uid_prefix)
        self._param_values: dict[str, Any] = {}
        self._param_defaults: dict[str, Any] = {}

    # -- declaration discovery -------------------------------------------------
    @classmethod
    def params(cls) -> dict[str, Param]:
        out: dict[str, Param] = {}
        for klass in reversed(cls.__mro__):
            for key, value in vars(klass).items():
                if isinstance(value, Param):
                    out[value.name] = value
        return out

    def _resolve(self, param: Param | str) -> Param:
        name = param.name if isinstance(param, Param) else param
        declared = type(self).params()
        if name not in declared:
            raise KeyError(f"{type(self).__name__} has no param {name!r}")
        return declared[name]

    # -- get/set ---------------------------------------------------------------
    def set(self, param: Param | str, value: Any):
        p = self._resolve(param)
        if p.validator is not None and not p.validator(value):
            raise ValueError(f"Invalid value for param {p.name}: {value!r}")
        self._param_values[p.name] = value
        return self

    def set_default(self, **kwargs: Any):
        for name, value in kwargs.items():
            p = self._resolve(name)
            self._param_defaults[p.name] = value
        return self

    def is_set(self, param: Param | str) -> bool:
        return self._resolve(param).name in self._param_values

    def has_default(self, param: Param | str) -> bool:
        return self._resolve(param).name in self._param_defaults

    def is_defined(self, param: Param | str) -> bool:
        return self.is_set(param) or self.has_default(param)

    def get_or_default(self, param: Param | str) -> Any:
        p = self._resolve(param)
        if p.name in self._param_values:
            return self._param_values[p.name]
        if p.name in self._param_defaults:
            return self._param_defaults[p.name]
        raise KeyError(f"Param {p.name!r} is neither set nor has a default")

    def get(self, param: Param | str) -> Any:
        return self.get_or_default(param)

    def explain_params(self) -> str:
        lines = []
        for name, p in sorted(type(self).params().items()):
            current = (
                repr(self._param_values.get(name, self._param_defaults.get(name)))
                if self.is_defined(name)
                else "undefined"
            )
            lines.append(f"{name}: {p.doc} (current: {current})")
        return "\n".join(lines)

    # -- copy ------------------------------------------------------------------
    def copy(self, extra: dict[str, Any] | None = None):
        """Deep copy preserving uid, then apply ``extra`` overrides.

        Matches the reference's ``defaultCopy`` behavior
        (``LanguageDetector.scala:208``) but covers all params because all
        hyper-parameters live in the params system here.
        """
        new = _copy.deepcopy(self)
        for name, value in (extra or {}).items():
            new.set(name, value)
        return new

    # -- persistence support ---------------------------------------------------
    def _persisted_names(self) -> set[str]:
        return {name for name, p in type(self).params().items() if p.persisted}

    def param_metadata(self) -> dict[str, Any]:
        """JSON-serializable map of explicitly set params (+ defaults map):
        the ``paramMap`` that model and pipeline persistence write. Params
        declared ``persisted=False`` are left out."""
        keep = self._persisted_names()
        return {
            "params": {k: v for k, v in self._param_values.items() if k in keep},
            "defaultParams": {k: v for k, v in self._param_defaults.items() if k in keep},
        }

    def _set_params_from_metadata(self, metadata: dict[str, Any]) -> None:
        """Apply a persisted ``paramMap``. Names this class does not declare
        (the JAX package's ``backend``), and params declared
        ``persisted=False``, are skipped."""
        keep = self._persisted_names()
        for name, value in metadata.get("defaultParams", {}).items():
            if name in keep:
                self._param_defaults[name] = value
        for name, value in metadata.get("params", {}).items():
            if name in keep:
                self.set(name, value)


# --- shared column traits (Spark ML's HasInputCol/HasLabelCol/HasOutputCol) ---


class HasInputCol(Params):
    input_col = Param("inputCol", "name of the input text column")

    def set_input_col(self, value: str):
        return self.set(HasInputCol.input_col, value)

    def get_input_col(self) -> str:
        return self.get_or_default(HasInputCol.input_col)


class HasLabelCol(Params):
    label_col = Param("labelCol", "name of the label (language) column")

    def set_label_col(self, value: str):
        return self.set(HasLabelCol.label_col, value)

    def get_label_col(self) -> str:
        return self.get_or_default(HasLabelCol.label_col)


class HasOutputCol(Params):
    output_col = Param("outputCol", "name of the output column")

    def set_output_col(self, value: str):
        return self.set(HasOutputCol.output_col, value)

    def get_output_col(self) -> str:
        return self.get_or_default(HasOutputCol.output_col)
