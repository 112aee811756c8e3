"""Text preprocessors: lower-casing and special-character cleanup.

Port of ``spark_languagedetector_tpu.models.preprocessing``: the reference's
two Transformers, with its deliberate API quirks kept because they are
observable behavior (SURVEY.md §2.9 Q8):

  * ``set_input_col`` sets the OUTPUT column (the transformers work in place
    on one column, reading and writing ``outputCol``);
  * ``transform_schema`` drops the column and re-appends it last.

The reference's broken behaviors are fixed as the JAX package fixes them,
not replicated (SURVEY.md Q3/Q4: its symbol regex is invalid and its
whitespace rule deletes every space): the symbol set the reference meant is
stripped and whitespace runs squash to one space.
"""

from __future__ import annotations

import re

from ..api.params import HasLabelCol, HasOutputCol
from ..api.table import STRING, Schema, Table

# The characters the reference's regex literal tried to express
# (SpecialCharPreprocessor.scala:55): /_[]*()%^&@$#:|{}<>~`"\
_SYMBOL_RE = re.compile(r'[/_\[\]*()%^&@$#:|{}<>~`"\\]')
_WHITESPACE_RE = re.compile(r"\s+")

# Java's String.toLowerCase(Locale) differs from the root locale only for
# Turkish/Azerbaijani (dotted/dotless i) and Lithuanian (which Python's
# str.lower matches closely enough for byte profiles). The reference takes
# the locale from the row's label column (LowerCasePreprocessor.scala:60).
_TURKIC = {"tr", "az"}


def _lower_locale(text: str, lang_tag: str) -> str:
    base = lang_tag.split("-")[0].lower() if lang_tag else ""
    if base in _TURKIC:
        # Java tr/az rules: I → ı, İ → i.
        text = text.replace("İ", "i").replace("I", "ı")
    return text.lower()


class _InPlaceColumnTransformer(HasOutputCol):
    """Shared shape: read ``outputCol``, rewrite it, move it last."""

    def set_input_col(self, value: str):
        # Reference quirk Q8: setInputCol sets outputCol.
        return self.set("outputCol", value)

    def transform_schema(self, schema: Schema) -> Schema:
        col = self.get_output_col()
        if col in schema:
            schema = schema.drop(col)
        return schema.append(col, STRING, nullable=True)


class LowerCasePreprocessor(_InPlaceColumnTransformer, HasLabelCol):
    """Locale-aware lower-casing with the row's label as locale tag
    (``LowerCasePreprocessor.scala:19-77``)."""

    def __init__(self, uid: str | None = None):
        super().__init__(uid, uid_prefix="LowerCasePreprocessor")
        self.set_default(outputCol="fulltext", labelCol="lang")

    def transform(self, dataset: Table) -> Table:
        col, label_col = self.get_output_col(), self.get_label_col()
        texts = dataset.column(col)
        labels = dataset.column(label_col)
        lowered = [_lower_locale(t, l) for t, l in zip(texts, labels)]
        return dataset.replace_column(col, lowered, STRING)


class SpecialCharPreprocessor(_InPlaceColumnTransformer):
    """Strip symbols and squash whitespace runs to one space
    (``SpecialCharPreprocessor.scala:19-71``, its intended behavior)."""

    def __init__(self, uid: str | None = None):
        super().__init__(uid, uid_prefix="SpecialCharPreprocessor")
        self.set_default(outputCol="fulltext")

    def transform(self, dataset: Table) -> Table:
        col = self.get_output_col()
        texts = dataset.column(col)
        cleaned = [_WHITESPACE_RE.sub(" ", _SYMBOL_RE.sub("", t)) for t in texts]
        return dataset.replace_column(col, cleaned, STRING)
