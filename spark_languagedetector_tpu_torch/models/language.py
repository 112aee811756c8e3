"""Language enumeration: ISO 639-1 codes in canonical vector order.

Port of ``spark_languagedetector_tpu.models.language``: the reference's
``Language`` enumeration (``Language.scala:11-201``), the same 182 ISO 639-1
codes in the same order, where the index of a code is its intended position
in a full-coverage probability vector. As in the reference the estimator and
model accept any sequence of language strings; this enum is the documented
canonical ordering plus a validation vocabulary.
"""

from __future__ import annotations

# Same codes, same order as the reference enum (Language.scala:13-196).
ISO_LANGUAGE_CODES: tuple[str, ...] = (
    "ab", "aa", "af", "ak", "sq", "am", "ar", "an", "hy", "as",
    "av", "ae", "ay", "az", "bm", "ba", "eu", "be", "bn", "bh",
    "bi", "bs", "br", "bg", "my", "ca", "km", "ch", "ce", "ny",
    "zh", "cu", "cv", "kw", "co", "cr", "hr", "cs", "da", "dv",
    "nl", "dz", "en", "eo", "et", "ee", "fj", "fi", "fr", "ff",
    "gd", "gl", "lg", "ka", "de", "ki", "el", "kl", "gn", "gu",
    "ht", "ha", "he", "hz", "hi", "ho", "hu", "is", "io", "ig",
    "id", "ia", "ie", "iu", "ik", "ga", "it", "ja", "jv", "kn",
    "kr", "ks", "kk", "rw", "kv", "kg", "ko", "kj", "ku", "ky",
    "lo", "la", "lv", "lb", "li", "ln", "lt", "lu", "mk", "mg",
    "ms", "ml", "mt", "gv", "mi", "mr", "mh", "ro", "mn", "na",
    "nv", "nd", "ng", "ne", "se", "no", "nb", "nn", "ii", "oc",
    "oj", "or", "om", "os", "pi", "pa", "ps", "fa", "pl", "pt",
    "qu", "rm", "rn", "ru", "sm", "sg", "sa", "sc", "sr", "sn",
    "sd", "si", "sk", "sl", "so", "st", "nr", "es", "su", "sw",
    "ss", "sv", "tl", "ty", "tg", "ta", "tt", "te", "th", "bo",
    "ti", "to", "ts", "tn", "tr", "tk", "tw", "uk", "ur", "uz",
    "ve", "vi", "vo", "wa", "cy", "fy", "wo", "xh", "yi", "yo",
    "za", "zu",
)

_INDEX: dict[str, int] = {code: i for i, code in enumerate(ISO_LANGUAGE_CODES)}


class Language:
    """Enumeration value: a code plus its canonical vector position."""

    __slots__ = ("code", "id")

    def __init__(self, code: str):
        if code not in _INDEX:
            raise KeyError(f"No language with name {code!r}")
        self.code = code
        self.id = _INDEX[code]

    # Reference API: ``Language.withName("de")`` (LanguageSpecs.scala:10-14).
    @staticmethod
    def with_name(code: str) -> "Language":
        return Language(code)

    @staticmethod
    def is_supported(code: str) -> bool:
        return code in _INDEX

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Language) and other.code == self.code

    def __hash__(self) -> int:
        return hash(self.code)

    def __repr__(self) -> str:
        return f"Language({self.code!r}, id={self.id})"

    def __str__(self) -> str:
        return self.code
