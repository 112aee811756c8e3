"""Seeded synthetic corpora for the benchmark: training tables and the
documents a traffic mix sends.

The word model is a copy of the one ``chip_smoke.py`` uses (itself the JAX
package's ``bench.py`` corpus): language families sharing alphabets,
Zipf-weighted vocabularies, shared function words and loanwords, with the
per-language word lists drawn from fixed crc32 seeds. It is copied here so
that the yardstick does not move when the program's own scripts change.

:func:`make_docs` is the benchmark's own generator over that word model:
every seed gets the same multiset of document lengths (quantiles of the
mix's length distribution) and the same number of documents per language,
in a seed-drawn order, and seed-drawn words. So two seeds do the same
amount of work, and only the content differs.
"""

from __future__ import annotations

from statistics import NormalDist

import numpy as np

# The synthetic corpus of the JAX package's bench.py (same crc32 seeds, so
# the same documents): language families sharing alphabets, Zipf-weighted
# vocabularies, shared function words and loanwords.
_LANG_CHARS = {
    "en": "the quick brown fox jumps over lazy dog and that is very nice ",
    "de": "der schnelle braune fuchs springt über den faulen hund schön ",
    "fr": "le renard brun rapide saute par dessus chien paresseux très ",
    "es": "el zorro marrón rápido salta sobre perro perezoso muy bien ",
    "it": "la volpe marrone veloce salta sopra il cane pigro molto bene ",
    "nl": "de snelle bruine vos springt over de luie hond erg mooi ",
    "pt": "a raposa marrom rápida pula sobre o cão preguiçoso muito bom ",
    "sv": "den snabba bruna räven hoppar över den lata hunden mycket fin ",
    "pl": "szybki brązowy lis przeskakuje nad leniwym psem bardzo ładnie ",
    "fi": "nopea ruskea kettu hyppää laiskan koiran yli erittäin mukava ",
}
_ALPHABET = "abcdefghijklmnopqrstuvwxyzäöüßéèêñçåøæšžčłćİığj"
_LOANWORDS = [
    "internet", "hotel", "taxi", "radio", "metro",
    "video", "pizza", "banana", "foto", "bank",
]
_REAL_FAMILY = {
    "fr": "romance", "es": "romance", "it": "romance", "pt": "romance",
    "en": "germanic", "de": "germanic", "nl": "germanic", "sv": "germanic",
    "pl": "balto", "fi": "balto",
}


def language_names(n: int) -> list[str]:
    real = list(_LANG_CHARS)
    return real[:n] if n <= len(real) else real + [
        f"l{i:03d}" for i in range(len(real), n)
    ]


def family_of(lang: str) -> str:
    if lang in _REAL_FAMILY:
        return _REAL_FAMILY[lang]
    return f"syn{(int(lang[1:]) - 10) // 4}"


def _rng_of(tag: str) -> np.random.Generator:
    import zlib

    return np.random.default_rng(zlib.crc32(tag.encode()))


def _gen_word(rng, letters, lo: int, hi: int) -> str:
    return "".join(rng.choice(letters, size=int(rng.integers(lo, hi))))


def _family_alphabet(fam: str) -> list[str]:
    return list(_rng_of("alpha:" + fam).choice(
        list(_ALPHABET), size=15, replace=False
    ))


def _family_shared(fam: str) -> list[str]:
    rng = _rng_of("shared:" + fam)
    letters = _family_alphabet(fam)
    return list(dict.fromkeys(
        _gen_word(rng, letters, 2, 5) for _ in range(18)
    ))[:12]


def _family_roots(fam: str) -> list[str]:
    rng = _rng_of("roots:" + fam)
    letters = _family_alphabet(fam)
    return list(dict.fromkeys(
        _gen_word(rng, letters, 4, 9) for _ in range(40)
    ))[:30]


_word_cache: dict[str, list[str]] = {}


def word_list(lang: str) -> list[str]:
    cached = _word_cache.get(lang)
    if cached is not None:
        return cached
    fam = family_of(lang)
    rng = _rng_of("lang:" + lang)
    letters = _family_alphabet(fam)
    suffix = _gen_word(rng, letters, 1, 3)
    roots = _family_roots(fam)
    mutated = []
    for i in rng.choice(len(roots), size=20, replace=False):
        w = roots[int(i)]
        if rng.random() < 0.5:
            j = int(rng.integers(0, len(w)))
            w = w[:j] + str(rng.choice(letters)) + w[j + 1:]
        if rng.random() < 0.6:
            w = w + suffix
        mutated.append(w)
    unique = _LANG_CHARS[lang].split() if lang in _LANG_CHARS else []
    while len(unique) < 26:
        unique.append(_gen_word(rng, letters, 3, 9))
    tail: list[str] = []
    for m, u in zip(mutated, unique):
        tail.extend((m, u))
    tail.extend(mutated[len(unique):] + unique[len(mutated):])
    ranked = _family_shared(fam) + _LOANWORDS + tail
    out = list(dict.fromkeys(ranked))
    _word_cache[lang] = out
    return out


def _zipf_probs(n: int, s: float = 1.05) -> np.ndarray:
    w = 1.0 / np.power(np.arange(1, n + 1) + 2.0, s)
    return w / w.sum()


def make_corpus(langs, n_docs, mean_len=1500, seed=0):
    rng = np.random.default_rng(seed)
    words = {l: np.asarray(word_list(l)) for l in langs}
    probs = {l: _zipf_probs(len(words[l])) for l in langs}
    docs, labels = [], []
    for i in range(n_docs):
        lang = langs[i % len(langs)]
        target = max(30, int(rng.normal(mean_len, mean_len / 4)))
        n_words = max(3, target // 7)
        docs.append(" ".join(rng.choice(words[lang], size=n_words, p=probs[lang])))
        labels.append(lang)
    return docs, labels


def make_codeswitch_corpus(langs, n_docs, block_bytes=1280, blocks=(2, 3), seed=23):
    """Block-structured code-switched documents with known span boundaries
    (the JAX package's bench.py corpus of the same name): each document
    concatenates 2-3 single-language blocks of about ``block_bytes`` bytes,
    adjacent blocks in different languages; the truth is byte-offset spans
    ``[(start, end, lang), ...]`` partitioning the document."""
    rng = np.random.default_rng(seed)
    words = {l: np.asarray(word_list(l)) for l in langs}
    probs = {l: _zipf_probs(len(words[l])) for l in langs}

    def block(lang, target):
        out = []
        size = -1  # first word adds no separator
        while size < target:
            w = str(rng.choice(words[lang], p=probs[lang]))
            out.append(w)
            size += len(w.encode("utf-8")) + 1
        return " ".join(out)

    docs, truth = [], []
    for _ in range(n_docs):
        seq = []
        for _ in range(int(rng.choice(list(blocks)))):
            prev = seq[-1] if seq else None
            seq.append(str(rng.choice([l for l in langs if l != prev])))
        parts = [block(l, block_bytes) for l in seq]
        spans, pos = [], 0
        for lang, part in zip(seq, parts):
            # The joining space after a block belongs to that block.
            end = pos + len(part.encode("utf-8")) + 1
            spans.append([pos, end, lang])
            pos = end
        spans[-1][1] = pos - 1  # no trailing separator on the last block
        docs.append(" ".join(parts))
        truth.append([tuple(s) for s in spans])
    return docs, truth



# ------------------------------------------------- the benchmark's own ------


def length_quantiles(dist: dict, n: int) -> np.ndarray:
    """``n`` document lengths in bytes: the quantiles at ``(k + 0.5) / n`` of
    the normal ``dist`` (``mean``, ``sd``), clipped below at ``min``, in
    ascending order. The same ``dist`` and ``n`` give the same lengths
    whatever the seed."""
    if n <= 0:
        return np.zeros(0, np.int64)
    nd = NormalDist(float(dist["mean"]), float(dist["sd"]))
    q = np.array([nd.inv_cdf((k + 0.5) / n) for k in range(n)])
    return np.maximum(np.rint(q), int(dist.get("min", 1))).astype(np.int64)


def doc_lengths(mix_lengths: dict, long: dict | None, n: int, rng) -> np.ndarray:
    """Lengths of ``n`` documents in the order they are sent: every
    ``long["every"]``-th document (positions ``every - 1``, ``2 * every - 1``,
    ...) draws from ``long``, the rest from ``mix_lengths``; each class is the
    fixed set of :func:`length_quantiles`, shuffled by ``rng``."""
    is_long = np.zeros(n, bool)
    if long:
        every = int(long["every"])
        is_long[every - 1 :: every] = True
    out = np.empty(n, np.int64)
    out[~is_long] = rng.permutation(length_quantiles(mix_lengths, int((~is_long).sum())))
    if is_long.any():
        out[is_long] = rng.permutation(length_quantiles(long, int(is_long.sum())))
    return out


def make_docs(langs, lang_of: np.ndarray, lengths: np.ndarray, rng) -> list[str]:
    """One document per entry of ``lang_of`` (indices into ``langs``): Zipf
    draws from that language's word list joined by spaces, cut to
    ``lengths`` bytes at a UTF-8 character boundary (so a document may be up
    to three bytes shorter than asked). Words are drawn per language in one
    call each, joined once, and each document is a slice of that text."""
    docs: list[str | None] = [None] * len(lang_of)
    for li in np.unique(lang_of):
        words = np.asarray(word_list(langs[li]), dtype=object)
        probs = _zipf_probs(len(words))
        word_bytes = np.array([len(w.encode()) + 1 for w in words])  # with its separator
        mean_bytes = float(probs @ word_bytes)
        which = np.flatnonzero(lang_of == li)
        need = np.ceil(lengths[which] / mean_bytes * 1.25).astype(np.int64) + 4
        drawn = rng.choice(len(words), size=int(need.sum()), p=probs)
        text = " ".join(words[drawn]).encode()
        # Byte offset of each drawn word in ``text``, and one past the last.
        offset = np.concatenate([[0], np.cumsum(word_bytes[drawn])])
        first = np.cumsum(need) - need
        for d, i, n, target in zip(which, first, need, lengths[which]):
            start, stop = int(offset[i]), int(offset[i + n]) - 1
            raw = text[start : min(stop, start + int(target))]
            while len(raw) < target:  # a short draw: extend, rarely needed
                more = words[rng.choice(len(words), size=int(n), p=probs)]
                raw += b" " + " ".join(more).encode()
            docs[d] = raw[: int(target)].decode("utf-8", "ignore")
    return docs  # type: ignore[return-value]


def balanced_languages(n_langs: int, n: int, rng) -> np.ndarray:
    """Language index of ``n`` documents: round robin over ``n_langs`` (as
    equal counts as ``n`` allows), in a ``rng``-drawn order."""
    return rng.permutation(np.arange(n) % n_langs)


def training_table(config: dict, seed: int, docs_per_language: int | None = None,
                   lengths: dict | None = None) -> tuple[list[str], list[str]]:
    """The training corpus of ``config`` (``training``: ``docs_per_language``
    and ``lengths``) for ``seed`` (any integer; a negative one is taken
    modulo 2**64): texts and their language labels."""
    langs = language_names(int(config["languages"]))
    train = config["training"]
    per = int(docs_per_language or train["docs_per_language"])
    rng = np.random.default_rng([int(seed) % 2**64, 1])
    lang_of = balanced_languages(len(langs), per * len(langs), rng)
    lens = doc_lengths(lengths or train["lengths"], None, len(lang_of), rng)
    return make_docs(langs, lang_of, lens, rng), [langs[i] for i in lang_of]


def split_shares(cs: dict, n: int) -> np.ndarray:
    """Share of each of ``n`` code-switched documents that its first
    language takes: the quantiles at ``(k + 0.5) / n`` of uniform(``lo``,
    ``hi``), in ascending order (the same for every seed)."""
    lo, hi = float(cs["lo"]), float(cs["hi"])
    return lo + (hi - lo) * (np.arange(n) + 0.5) / max(n, 1)


def traffic_pool(config: dict, mix: dict, seed: int) -> list[str]:
    """The documents a label mix sends for ``seed``: ``pool_docs`` distinct
    documents over ``config``'s languages, lengths from the mix.

    With ``codeswitch`` (``every``, ``lo``, ``hi``) in the mix, every
    ``every``-th document from position ``every // 2 - 1`` on joins two
    blocks of two different languages by a space: the first block takes a
    share of its length from :func:`split_shares` (in a seed-drawn order),
    and its second language is a seed-drawn other one, so every seed sends
    the same block sizes."""
    langs = language_names(int(config["languages"]))
    rng = np.random.default_rng([int(seed) % 2**64, 2])
    n = int(mix["pool_docs"])
    lang_of = balanced_languages(len(langs), n, rng)
    lens = doc_lengths(mix["lengths"], mix.get("long"), n, rng)
    cs = mix.get("codeswitch")
    if not cs:
        return make_docs(langs, lang_of, lens, rng)
    every = int(cs["every"])
    mixed = np.arange(every // 2 - 1, n, every)
    first = np.maximum(1, np.rint(lens[mixed] * rng.permutation(split_shares(cs, mixed.size))))
    first = np.minimum(first, lens[mixed] - 2).astype(np.int64)
    other = (lang_of[mixed] + rng.integers(1, len(langs), mixed.size)) % len(langs)
    parts_lang = np.concatenate([lang_of, other])
    parts_len = np.concatenate([lens, lens[mixed] - first - 1])
    parts_len[mixed] = first
    parts = make_docs(langs, parts_lang, parts_len, rng)
    docs = parts[:n]
    for i, d in enumerate(mixed):
        docs[d] = docs[d] + " " + parts[n + i]
    return docs
