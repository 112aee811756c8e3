#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``spark_languagedetector_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py           # every phase; the last line is the verdict
    python3 chip_smoke.py --quick   # phases 1-3 only (build + kernel checks)
    python3 chip_smoke.py --baseline OLD   # also builds the kernels of OLD,
                                    # another version's checkout (or its csrc/),
                                    # and times them in turns with these

Phases, one line or more each; any failure exits non-zero before the verdict:

1. device   — ``nvidia-smi`` name and power limit, torch's view of the card;
2. build    — every kernel of the path compiled with nvcc from ``csrc/``;
3. kernels  — each kernel held against its plain PyTorch version on the card:
   fused detect over five table layouts x {f32, int16, int8} x {score,
   detect}, with and without window limits, a wide-L case, on three
   batches: edge documents, documents that repeat one gram to the width
   (the largest count per row) and random bytes whose distinct rows exceed
   the kernel's row-count table several times over (flushes); f32 scores
   of two launches bit-identical; int8/int16 at the int32 guard's edge;
   the row histogram on both sides of its shared-memory threshold; the
   bigram histogram (mask_n 1 and 2) and bigram score (L = 3 and 16) over
   edge documents with and without window limits, the bigram score also
   (L = 3, 10, 16) on repeated-gram batches (held against a float64 sum)
   and random-byte ones (which flush its key counts), two launches
   bit-identical; fused segment over the
   same five layouts x {f32, int16, int8} x cell {128, 256, 512} (2048 on
   the random bytes) on the same three kinds of batch, widths no cell
   multiple, with unaligned window limits, skipped cells exactly zero;
4. main     — ``LanguageDetector.fit`` → ``LanguageDetectorModel.transform``
   at the 176-language hashed config (gram lengths 1..5, 2^20 buckets,
   profile size 400; the JAX package's ``bench.py`` config 5) on the same
   synthetic corpus, checked against the plain version on the card and the
   host float64 scorer, then again with int16 and int8 tables;
5. times    — the kernel, its plain version and ``embedding_bag`` at the
   runner's largest config-5 batch (CUDA events on a held card; each
   kernel in turns with its ``--baseline`` builds, whose outputs are
   compared with its), the kernel's lower bound, and end-to-end docs/s;
6. config3  — bench config 3 (50 languages, exact n = 1..5, profile 1,000;
   cuckoo membership): fit → transform through the hybrid strategy, i.e.
   the bigram-histogram kernel (n <= 2) and the row-histogram kernel
   (n = 3..5), chunked, empty and all-miss documents included; labels
   against the plain versions on the card and the host float64 scorer;
   scores unchanged with TF32 allowed process-wide;
7. kernel5  — the bigram-score kernel's paths: the same exact n = 1..5
   shape at 10 languages (auto → hybrid; then a warm transform's docs/s and
   the device's busy share) and bench config 1 (3 languages, exact bigrams,
   profile 2,000) with strategy='pallas';
8. times    — the three histogram-side kernels at the config-3 runner's
   largest batch: kernel, plain version, lower bound and one library call
   each (``bincount``, ``bincount``, ``embedding_bag``), the bigram score
   at L = 10 and 16 and an empty kernel launch beside its bound, then
   end-to-end config-3 docs/s and the device's busy share;
9. segment  — the config-5 model with ``resultMode="segment"``, calibrated
   on a held-out split, transforms a code-switched corpus (2-3 blocks of
   ~1,280 bytes, two ~20 KB documents that chunk on a cell-aligned stride,
   the empty document) through the fused-segment kernel: per-cell scores
   against the plain version and the host float64 oracle, cell sums against
   ``runner.score``, byte-span macro F1 against the known boundaries,
   whole-doc labels unchanged by the segment traffic; then the kernel's
   time, plain version, bound and ``embedding_bag`` at the largest config-5
   batch, and a warm segment transform's docs/s and busy share;
10. segment3 — the config-3 model (hybrid) segments a smaller corpus through
   the gather cell scorer (cuckoo membership; no kernel on this route)
   and matches the host float64 oracle.
11. fit5     — ``fitBackend='device'`` at config 5 on the card (the naive
   finalize over the 0.74 GB int32 count table): the profile bit-identical
   to phase 4's host fit; count and finalize walls beside the host fit's;
   the device-fitted model labels phase 4's documents identically through
   the fused kernel; then both fits, warm, on an eight-fold training corpus
   (bit-identical profiles);
12. fit3     — the same at config 3 (the split fit: lengths 1..3 on the card,
   the blocked finalize over a 3.37 GB table; 4..5 on the host), bit-
   identical to phase 6's host fit, labels identical through the hybrid
   kernels; then a parity count table whose tie plateaus cross the block
   boundaries, where ``top_k_rows``, ``top_k_rows_blocked`` and
   ``finalize_topk_blocked`` give numpy's (value desc, id asc) top-k;
13. persist  — save and load on the card (pyarrow; the phase says so and
   stands aside if pyarrow cannot be imported): the config-5 model in
   float64 and int8, the calibrated segment model of phase 9 and the
   config-3 model in the reference (Spark) layout (the float64 model saved
   from a CPU session, reloaded with no device named); each reload gives the
   saved model's f32 scores bit for bit and its labels, and the segment
   model its calibration and per-cell scores.

Each phase prints its seconds.

It imports nothing of JAX. Without a CUDA card, or without the package
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
ATOL, RTOL = 1e-4, 1e-5  # reduction-order tolerance class (f32 sums)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


class FitCase(NamedTuple):
    """A host fit of a path, kept for the device-fit phase to compare with:
    the estimator, its training table, the host-fitted model and its wall,
    and the evaluation texts with the model's labels (language indices)."""

    det: object
    table: object
    model: object
    host_fit_s: float
    texts: list
    ids: np.ndarray


# ------------------------------------------------------------- corpus ------
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


def macro_span_f1(truths, results, doc_lens, name_of=lambda lang: lang) -> float:
    """Macro-averaged byte F1 over the languages of the truth: per document
    the byte labelling that the true and the decoded spans induce, tallied
    per language (``name_of`` maps a language to the class it is scored
    as, e.g. its family)."""
    agg: dict[str, list[int]] = {}
    for truth, res, n in zip(truths, results, doc_lens):
        names: list[str] = []

        def idx(lang):
            lang = name_of(lang)
            if lang not in names:
                names.append(lang)
            return names.index(lang)

        t = np.full(n, -1, dtype=np.int64)
        q = np.full(n, -2, dtype=np.int64)
        for start, end, lang in truth:
            t[start:end] = idx(lang)
        for sp in res["spans"]:
            q[sp["start"]:sp["end"]] = idx(sp["lang"])
        for i, lang in enumerate(names):
            a = agg.setdefault(lang, [0, 0, 0])
            a[0] += int(np.sum((t == i) & (q == i)))
            a[1] += int(np.sum((t != i) & (q == i)))
            a[2] += int(np.sum((t == i) & (q != i)))
    f1s = [2 * tp / (2 * tp + fp + fn) for tp, fp, fn in agg.values() if tp + fn]
    return float(np.mean(f1s)) if f1s else 0.0


# ------------------------------------------------------------- helpers -----


HOLD_CYCLES = 20_000_000  # about 10 ms of spinning at the H100's clocks


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call on the card: CUDA events around ``reps``
    back-to-back calls, after ``warmup`` calls, queued while a spin kernel
    (``torch.cuda._sleep``) keeps the card busy, so the time is the card's
    and not the host's launch rate (which sets the pace of a kernel shorter
    than its wrapper's Python)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _agreement(torch, got, ref) -> str:
    """How a baseline build's output ``got`` compares with the kernel's
    ``ref`` (a tensor or a tuple of them): bit-identical, the largest float
    difference, or the number of labels that differ. A baseline is another
    version, held to nothing here: a variant that sums in another order
    may differ by up to twice the tolerance that each meets."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    notes = []
    for g, r in zip(got, ref):
        if torch.equal(g, r):
            continue
        if g.is_floating_point():
            notes.append(f"max abs diff {float((g - r).abs().max()):.3g}")
        else:
            notes.append(f"{int((g != r).sum())} labels differ")
    return ", ".join(notes) or "bit-identical"


def timed_in_turns(torch, what: str, run, module, attr: str, baselines, reps: int = 20) -> float:
    """``cuda_ms`` of ``run``, which launches the kernel that ``module.attr``
    names, in turns with each baseline build of that kernel (``baselines``:
    (label, {kernel name: CudaKernel}) pairs, from ``--baseline``): kernel,
    baselines, baselines in reverse, kernel. Each baseline's output is first
    compared with the kernel's on the same inputs. Prints every reading and
    returns the mean of the kernel's two."""
    name = getattr(module, attr).name
    builds = [(label, ks[name]) for label, ks in baselines if name in ks]
    ref = run()
    agree = []
    for label, k in builds:
        with swapped(module, attr, k):
            agree.append(f"{label} {_agreement(torch, run(), ref)}")
    times: dict[str, list[float]] = {}
    for label, k in [("kernel", None), *builds, *reversed(builds), ("kernel", None)]:
        with swapped(module, attr, k) if k else contextlib.nullcontext():
            times.setdefault(label, []).append(cuda_ms(torch, run, reps=reps))
    say("times", f"{what}: " + "; ".join(
        f"{label} " + ", ".join(f"{t:.4f}" for t in ts) for label, ts in times.items())
        + " ms (held card, in turns)" + (f"; against the kernel: {'; '.join(agree)}"
                                         if agree else ""))
    return float(np.mean(times["kernel"]))


def near_tie(scores: np.ndarray) -> np.ndarray:
    """Rows whose top-2 gap is within the f32 tolerance (argmax may flip)."""
    top2 = -np.sort(-scores, axis=1)[:, :2]
    return (top2[:, 0] - top2[:, 1]) <= ATOL + RTOL * np.abs(top2[:, 0])


def check_labels(what: str, got: np.ndarray, ref: np.ndarray, ref_scores: np.ndarray) -> int:
    """Labels must agree except on near-ties of the reference scores;
    returns the number of (allowed) near-tie disagreements."""
    diff = got != ref
    hard = diff & ~near_tie(ref_scores)
    if hard.any():
        fail(f"{what}: {int(hard.sum())} labels differ outside near-ties "
             f"(first rows {np.flatnonzero(hard)[:5].tolist()})")
    return int(diff.sum())


# ------------------------------------------------------------- phases ------


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    say("device", f"nvidia-smi: {smi_line}")
    say("device", f"torch {torch.__version__} (CUDA {torch.version.cuda}): "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible")
    return smi_line


def phase_build(kernels) -> None:
    from spark_languagedetector_tpu_torch.ops._kernels import build_all

    t0 = time.perf_counter()
    built = build_all(kernels, force=True)
    say("build", f"{len(built)} kernel(s) built in {time.perf_counter() - t0:.2f}s "
        "(one nvcc per source, in parallel)")
    for name, (seconds, log) in built.items():
        say("build", f"{name}: {seconds:.2f}s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                say("build", f"  {line.strip()}")


def _layout_cases(VocabSpec, L: int, seed: int):
    """The CPU tests' five layouts: (name, spec, weights, lut)."""
    rng = np.random.default_rng(seed)

    def dense(spec, n_learned):
        w = np.zeros((spec.id_space_size, L), np.float32)
        learned = rng.choice(spec.id_space_size, n_learned, replace=False)
        w[learned] = rng.normal(size=(n_learned, L)).astype(np.float32)
        return w, None

    def lut(spec, n_rows):
        lut = np.full(spec.id_space_size, n_rows, np.int32)
        lut[rng.choice(spec.id_space_size, n_rows, replace=False)] = np.arange(n_rows)
        w = np.zeros((n_rows + 1, L), np.float32)
        w[:-1] = rng.normal(size=(n_rows, L)).astype(np.float32)
        return w, lut

    specs = [
        ("dense_exact_bigram", VocabSpec("exact", (2,)), lambda s: dense(s, 500)),
        ("dense_hashed_fnv1a", VocabSpec("hashed", (1, 2, 3), 12), lambda s: dense(s, 600)),
        ("dense_hashed_exact12_fold", VocabSpec("hashed", (1, 2, 3, 4, 5), 17),
         lambda s: dense(s, 900)),
        ("lut_exact12_n1_5", VocabSpec("hashed", (1, 2, 3, 4, 5), 17), lambda s: lut(s, 300)),
        ("lut_exact_n1_3", VocabSpec("exact", (1, 2, 3)), lambda s: lut(s, 300)),
    ]
    for name, spec, build in specs:
        w, lt = build(spec)
        yield name, spec, w, lt


def _edge_batch(rng, n_random: int, pad: int):
    docs = [bytes(rng.integers(97, 112, int(rng.integers(0, 60))).tolist())
            for _ in range(n_random)]
    docs += [b"", b"a", b"ab", b"\x00\xff\x00", bytes(rng.integers(0, 256, 200).tolist())]
    docs += [bytes(rng.integers(0, 256, int(rng.integers(pad // 2, pad))).tolist())
             for _ in range(n_random)]
    lim = np.where(np.arange(len(docs)) % 2 == 0,
                   rng.integers(1, 40, len(docs)), pad).astype(np.int32)
    return docs, lim


def _repeat_batch(rng, pad: int):
    """Documents that each repeat one gram up to the padded width, the
    largest count a row can reach: one byte, a byte pair, 0xFF and a
    three-byte gram, plus a short one; window limits on every other row."""
    docs = [b"a" * pad, b"ab" * (pad // 2), b"\xff" * pad, b"xyz" * (pad // 3),
            b"e" * (pad // 3)]
    lim = np.where(np.arange(len(docs)) % 2 == 0,
                   rng.integers(1, pad, len(docs)), pad).astype(np.int32)
    return docs, lim


def _distinct_batch(rng, pad: int):
    """Random-byte documents whose distinct rows exceed a block's row-count
    table several times over, so the kernels flush; window limits on every
    other row."""
    docs = [bytes(rng.integers(0, 256, pad - i).tolist()) for i in range(4)]
    lim = np.where(np.arange(len(docs)) % 2 == 0,
                   rng.integers(pad // 2, pad, len(docs)), pad).astype(np.int32)
    return docs, lim


def distinct_rows(torch, SF, inp, lay, cell: int | None = None) -> tuple[int, int]:
    """(distinct (document, row) pairs -- or (document, cell, row) triples
    with ``cell`` -- of the batch's counted windows, the most of them in
    one document or cell): what the fused kernels count before they touch
    the table."""
    keys = []
    for r, m in SF.window_rows(inp, lay):
        blk = torch.arange(inp.batch.shape[0], device=r.device)[:, None].expand_as(r)
        if cell is not None:
            pos = torch.arange(r.shape[1], device=r.device)[None, :]
            blk = blk * (-(-inp.batch.shape[1] // cell)) + pos // cell
        keys.append((blk * lay.rows + r)[m])
    uniq = torch.unique(torch.cat(keys))
    if not uniq.numel():
        return 0, 0
    return int(uniq.numel()), int(torch.bincount(uniq // lay.rows).max())


def _guard_case(VocabSpec, SF, route: str, quant: str, L: int = 6):
    """The int32 guard's edge: one document of 'a' repeated so that 5
    lengths x its windows x qmax sits just under 2^31, on a table whose rows
    of 'a' x n are +-qmax (even / odd languages), inline-only ("dense") or
    with lengths 3..5 through the LUT rows plane ("lut"). Returns (spec,
    FusedTables, S) with S the longest document the guard admits."""
    from spark_languagedetector_tpu_torch.models.profile import QUANT_DTYPES
    from spark_languagedetector_tpu_torch.ops.vocab import window_ids_numpy

    spec = VocabSpec("hashed", (1, 2, 3, 4, 5), 17)
    rng = np.random.default_rng(29)
    probe = np.frombuffer(b"aaaaa", np.uint8)[None, :]
    hot = [int(window_ids_numpy(probe, n, spec)[0, 0]) for n in range(1, 6)]
    sign = np.where(np.arange(L) % 2 == 0, 1.0, -1.0).astype(np.float32)
    if route == "dense":
        w = (0.1 * rng.normal(size=(spec.id_space_size, L))).astype(np.float32)
        w[hot] = sign
        lut = None
    else:
        n_rows = 300
        lut = np.full(spec.id_space_size, n_rows, np.int32)
        picks = rng.choice(spec.id_space_size, n_rows, replace=False)
        picks = np.concatenate([hot, picks[~np.isin(picks, hot)]])[:n_rows]
        lut[picks] = np.arange(n_rows)
        w = np.zeros((n_rows + 1, L), np.float32)
        w[:n_rows] = 0.1 * rng.normal(size=(n_rows, L))
        w[:len(hot)] = sign
    ft = SF.build_fused_tables(w, lut, spec, quant)
    qmax = QUANT_DTYPES[quant][1]
    return spec, ft, (2**31 - 1) // (len(spec.gram_lengths) * qmax)


def compare_kernel(torch, SF, inp, wq, scales, layout, what: str) -> tuple[float, int]:
    """Kernel vs plain version on the same device inputs, both variants.
    Returns (max abs score error, near-tie label flips)."""
    got = SF.fused_kernel(inp, wq, scales, layout, want_labels=False)
    labels, best = SF.fused_kernel(inp, wq, scales, layout, want_labels=True)
    again = SF.fused_kernel(inp, wq, scales, layout, want_labels=False)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail(f"{what}: two launches on the same batch differ "
             f"(max abs {float((got - again).abs().max()):.3g})")
    ref = SF.fused_plain(inp, wq, scales, layout, want_labels=False)
    rl, rb = SF.fused_plain(inp, wq, scales, layout, want_labels=True)
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    if not np.allclose(got, ref, atol=ATOL, rtol=RTOL):
        fail(f"{what}: kernel scores differ from the plain version (max abs err {err:.3g})")
    if layout.quant is not None and err != 0.0:
        fail(f"{what}: integer sums must be bit-identical, max abs err {err:.3g}")
    if not np.allclose(best.cpu().numpy(), rb.cpu().numpy(), atol=ATOL, rtol=RTOL):
        fail(f"{what}: detect best scores differ")
    flips = check_labels(what, labels.cpu().numpy(), rl.cpu().numpy(), ref)
    if got.size and not np.array_equal(labels.cpu().numpy(), np.argmax(got, axis=1)):
        fail(f"{what}: detect labels are not the first max of the score variant")
    return err, flips


def _guard_checks(torch, dev, SF, VocabSpec, pad_batch, segment: bool) -> None:
    """The int32 guard's edge on the card, for int8 and int16 tables and
    both input routes: one document of 'a' as long as the guard admits
    (fused detect: windows per sum = S) or one cell that wide (fused
    segment), against the plain version bit for bit; one byte more
    must be refused by the wrapper."""
    for quant in ("int8", "int16"):
        for route in ("dense", "lut"):
            spec, ft, n_max = _guard_case(VocabSpec, SF, route, quant)
            if segment:
                n_max -= n_max % 128
            wq = torch.from_numpy(ft.wq).to(dev)
            scales = torch.from_numpy(ft.scales).to(dev)
            lut_d = None if ft.lut is None else torch.from_numpy(ft.lut).to(dev)
            batch, lengths = pad_batch([b"a" * n_max], n_max)
            inp = SF.prepare_fused_inputs(torch.from_numpy(batch).to(dev),
                                          torch.from_numpy(lengths).to(dev), lut_d, None,
                                          spec, ft.layout)
            what = f"guard {route} {quant} S={n_max}"
            if not segment:
                compare_kernel(torch, SF, inp, wq, scales, ft.layout, what)
                ref = SF.fused_plain(inp, wq, scales, ft.layout, want_labels=False)
                over = lambda: SF.fused_kernel(  # noqa: E731
                    SF.prepare_fused_inputs(torch.cat([inp.batch, inp.batch[:, :1]], 1),
                                            inp.lengths, lut_d, None, spec, ft.layout),
                    wq, scales, ft.layout, want_labels=False)
            else:
                got = SF.fused_segment_kernel(inp, wq, scales, ft.layout, n_max)
                torch.cuda.synchronize()
                ref = SF.fused_segment_plain(inp, wq, scales, ft.layout, n_max)
                if not torch.equal(got, ref):
                    fail(f"fused_segment {what}: integer sums differ from the plain version "
                         f"(max abs err {float((got - ref).abs().max()):.3g})")
                over = lambda: SF.fused_segment_kernel(  # noqa: E731
                    inp, wq, scales, ft.layout, n_max + 128)
            total = float((ref.abs() / scales).max())
            try:
                over()
            except ValueError:
                pass
            else:
                fail(f"{what}: the wrapper admitted a sum past its int32 guard")
            say("kernels", f"{'fused_segment' if segment else 'fused_detect'} {what}: "
                f"bit-identical to the plain version, |sum| up to {total:.0f} "
                f"(2^31 = {2**31}); one more {'cell step' if segment else 'byte'} "
                f"is refused")


def phase_kernels(torch, dev) -> float:
    from spark_languagedetector_tpu_torch.ops import score_fused as SF
    from spark_languagedetector_tpu_torch.ops.encoding import pad_batch
    from spark_languagedetector_tpu_torch.ops.vocab import VocabSpec

    max_err = 0.0
    rng = np.random.default_rng(7)
    for L in (6, 1100):  # one column per thread, and two
        for name, spec, w, lut in _layout_cases(VocabSpec, L, seed=L):
            if L > 6 and name != "dense_exact_bigram":
                continue
            # Edge documents; one gram repeated to the width (the largest
            # count per row); random bytes whose distinct rows exceed the
            # kernel's row-count table several times over (flushes).
            for label, (docs, lim), pad in (("edges", _edge_batch(rng, 11, 256), 256),
                                            ("repeat", _repeat_batch(rng, 2048), 2048),
                                            ("distinct", _distinct_batch(rng, 8192), 8192)):
                batch, lengths = pad_batch(docs, pad)
                case_err, flips, pairs = 0.0, 0, None
                for quant in (None, "int16", "int8"):
                    ft = SF.build_fused_tables(w, lut, spec, quant)
                    wq = torch.from_numpy(ft.wq).to(dev)
                    scales = torch.from_numpy(ft.scales).to(dev)
                    lut_d = None if ft.lut is None else torch.from_numpy(ft.lut).to(dev)
                    for limit in (None, lim):
                        inp = SF.prepare_fused_inputs(
                            torch.from_numpy(batch).to(dev),
                            torch.from_numpy(lengths).to(dev), lut_d,
                            None if limit is None else torch.from_numpy(limit).to(dev),
                            spec, ft.layout,
                        )
                        what = (f"{name} L={L} {label} {quant or 'f32'} "
                                f"limit={'yes' if limit is not None else 'no'}")
                        err, f = compare_kernel(torch, SF, inp, wq, scales, ft.layout, what)
                        case_err, flips = max(case_err, err), flips + f
                        if pairs is None:
                            pairs = distinct_rows(torch, SF, inp, ft.layout)
                max_err = max(max_err, case_err)
                say("kernels", f"{name} L={L} {label} B={len(docs)} S={pad} f32/int16/int8 "
                    f"with and without limits: max abs err {case_err:.3g}, integer tables "
                    f"bit-identical, f32 launches repeat bit for bit, near-tie label flips "
                    f"{flips}; {pairs[0]} distinct (doc, row) pairs, up to {pairs[1]} in a "
                    f"document (the kernel holds {SF.FUSED_MAX_ROWS} before a flush)")
    _guard_checks(torch, dev, SF, VocabSpec, pad_batch, segment=False)
    # All-miss documents: zero scores, label 0.
    spec = VocabSpec("exact", (2,))
    ft = SF.build_fused_tables(np.zeros((spec.id_space_size, 6), np.float32), None, spec, "int8")
    batch, lengths = pad_batch([b"", b"anything", bytes(range(200, 240))], 128)
    inp = SF.prepare_fused_inputs(torch.from_numpy(batch).to(dev),
                                  torch.from_numpy(lengths).to(dev), None, None, spec, ft.layout)
    labels, best = SF.fused_kernel(inp, torch.from_numpy(ft.wq).to(dev),
                                   torch.from_numpy(ft.scales).to(dev), ft.layout, want_labels=True)
    if labels.cpu().tolist() != [0, 0, 0] or best.cpu().tolist() != [0.0, 0.0, 0.0]:
        fail(f"all-miss documents must label 0 with best 0.0, got {labels.tolist()} {best.tolist()}")
    say("kernels", "all-miss documents: labels 0, best 0.0")
    return max_err


def phase_kernels_segment(torch, dev) -> float:
    """The fused-segment kernel against its plain version on the card: the
    five layouts x {f32, int16, int8} x cell {128, 256, 512}, with and
    without unaligned window limits, on edge documents (empty, shorter than
    n, mostly-miss random bytes) in a batch whose width is no multiple of
    any cell, on documents that repeat one gram, and on random bytes whose
    cells (2048 wide too) hold more distinct rows than the kernel's
    row-count table; f32 within ATOL/RTOL and bit-identical across two
    launches, integer tables bit for bit, skipped cells exactly zero; then
    the int32 guard's edge. Returns the max abs error."""
    from spark_languagedetector_tpu_torch.ops import score_fused as SF
    from spark_languagedetector_tpu_torch.ops.encoding import pad_batch
    from spark_languagedetector_tpu_torch.ops.vocab import VocabSpec

    max_err = 0.0
    rng = np.random.default_rng(13)
    for L in (6, 1100):
        for name, spec, w, lut in _layout_cases(VocabSpec, L, seed=L):
            if L > 6 and name != "lut_exact12_n1_5":
                continue
            docs, _ = _edge_batch(rng, 7, 1300)  # 10.2 cells of 128, 5.1 of 256, 2.5 of 512
            docs.append(b"\xff" * 1300)  # fills the width: last cell is ragged
            lim = np.where(np.arange(len(docs)) % 2 == 0,
                           rng.integers(1, 1300, len(docs)), 1300).astype(np.int32)
            batches = (("edges", (docs, lim), 1300, (128, 256, 512)),
                       ("repeat", _repeat_batch(rng, 1300), 1300, (128, 256, 512)),
                       ("distinct", _distinct_batch(rng, 4100), 4100, (128, 512, 2048)))
            for label, (docs, lim), pad, cells in batches:
                batch, lengths = pad_batch(docs, pad)
                bd = torch.from_numpy(batch).to(dev)
                ld = torch.from_numpy(lengths).to(dev)
                case_err, triples = 0.0, None
                for quant in (None, "int16", "int8"):
                    ft = SF.build_fused_tables(w, lut, spec, quant)
                    wq = torch.from_numpy(ft.wq).to(dev)
                    scales = torch.from_numpy(ft.scales).to(dev)
                    lut_d = None if ft.lut is None else torch.from_numpy(ft.lut).to(dev)
                    for limit in (None, lim):
                        lim_d = None if limit is None else torch.from_numpy(limit).to(dev)
                        inp = SF.prepare_fused_inputs(bd, ld, lut_d, lim_d, spec, ft.layout)
                        for cell in cells:
                            what = (f"fused_segment {name} L={L} {label} {quant or 'f32'} "
                                    f"cell={cell} limit={'yes' if limit is not None else 'no'}")
                            got = SF.fused_segment_kernel(inp, wq, scales, ft.layout, cell)
                            again = SF.fused_segment_kernel(inp, wq, scales, ft.layout, cell)
                            torch.cuda.synchronize()
                            if not torch.equal(got, again):
                                fail(f"{what}: two launches on the same batch differ")
                            ref = SF.fused_segment_plain(inp, wq, scales, ft.layout, cell)
                            err = float((got - ref).abs().max())
                            if not torch.allclose(got, ref, atol=ATOL, rtol=RTOL):
                                fail(f"{what}: differs from the plain version "
                                     f"(max abs err {err:.3g})")
                            if quant is not None and not torch.equal(got, ref):
                                fail(f"{what}: integer sums must be bit-identical, "
                                     f"max abs err {err:.3g}")
                            starts = torch.arange(got.shape[1], device=dev)[None, :] * cell
                            dead = (starts >= inp.lengths[:, None]) | (starts >= inp.lim[:, None])
                            if bool((got[dead] != 0).any()):
                                fail(f"{what}: a cell at or past min(len, lim) is not zero")
                            whole = SF.fused_kernel(inp, wq, scales, ft.layout,
                                                    want_labels=False)
                            if not torch.allclose(got.sum(dim=1), whole, atol=1e-2, rtol=1e-4):
                                fail(f"{what}: cells do not sum to the whole-document scores")
                            case_err = max(case_err, err)
                            if triples is None and cell == cells[-1]:
                                triples = distinct_rows(torch, SF, inp, ft.layout, cell)
                max_err = max(max_err, case_err)
                say("kernels", f"fused_segment {name} L={L} {label} B={len(docs)} S={pad} "
                    f"f32/int16/int8 cells {'/'.join(map(str, cells))} with and without "
                    f"limits: max abs err {case_err:.3g}, integer tables bit-identical, f32 "
                    f"launches repeat bit for bit; at cell {cells[-1]} {triples[0]} distinct "
                    f"(doc, cell, row) triples, up to {triples[1]} in a cell (the kernel "
                    f"holds {SF.FUSED_MAX_ROWS} before a flush)")
    _guard_checks(torch, dev, SF, VocabSpec, pad_batch, segment=True)
    return max_err


def window_bytes(lengths, lim, n: int):
    """int64 [B]: the bytes of each document that its owned full windows of
    length n read (starts s < min(len - n + 1, lim), bytes s..s+n-1)."""
    c = (lengths.long() - n + 1).minimum(lim.long()).clamp(min=0)
    return (c + n - 1) * (c > 0)


def _bigram_edge_batch(rng, pad: int):
    """Edge documents for the bigram kernels: empty, 1 byte, 0x00/0xFF,
    short and long random documents, one that fills the padded width (its
    last window's next byte is past the width), window limits on half the
    rows; 28 rows (not a multiple of 8)."""
    docs, lim = _edge_batch(rng, 11, pad)
    docs.append(b"\xff" * pad)
    lim = np.append(lim, pad).astype(np.int32)
    return docs, lim


def phase_kernels_hist(torch, dev) -> dict[str, float]:
    """The row-histogram, bigram-histogram and bigram-score kernels against
    their plain versions on the card: counts bit for bit, scores within
    ATOL/RTOL, two launches of the bigram score bit-identical. Returns the
    max abs error per kernel."""
    from spark_languagedetector_tpu_torch.ops import score_fused as SF
    from spark_languagedetector_tpu_torch.ops import score_hist as SH
    from spark_languagedetector_tpu_torch.ops import score_pallas as SP
    from spark_languagedetector_tpu_torch.ops.encoding import pad_batch

    rng = np.random.default_rng(11)
    errs = {"row_hist": 0.0, "bigram_hist": 0.0, "bigram_score": 0.0}

    # Row histogram: random rows planes (misses, out-of-range ids, the miss
    # row) with per-document vmax, Rhi on both sides of the shared-memory
    # threshold.
    for rhi in (8, SH.SHARED_MEMORY_ROWS // 256, SH.SHARED_MEMORY_ROWS // 256 + 8, 536):
        R = rhi * 256
        B, K, W = 13, 3, 700
        rows = rng.integers(-2, R + 2, (B, K * W)).astype(np.int32)
        hot = rng.random((B, K * W)) < 0.3  # a hot row and the miss row
        rows[hot] = rng.choice([5, R - 1], int(hot.sum()))
        vmax = rng.integers(0, W + 1, B).astype(np.int32)
        vmax[:3] = (0, 1, W)
        rows_d = torch.from_numpy(rows).to(dev)
        vmax_d = torch.from_numpy(vmax).to(dev)
        got = SH.row_hist_kernel(rows_d, vmax_d, W, rhi, R - 1)
        torch.cuda.synchronize()
        ref = SH.row_hist_plain(rows_d, vmax_d, W, rhi, R - 1)
        errs["row_hist"] = max(errs["row_hist"], float((got - ref).abs().max()))
        if not torch.equal(got, ref):
            fail(f"row_hist Rhi={rhi}: counts differ from the plain version "
                 f"({int((got != ref).sum())} entries)")
        path = "shared" if R <= SH.SHARED_MEMORY_ROWS else "global"
        say("kernels", f"row_hist Rhi={rhi} ({path} counts) B={B}: bit-exact, "
            f"{int(ref.sum())} windows counted")

    # Bigram histogram and bigram score over edge documents.
    for pad in (128, 512):
        docs, lim = _bigram_edge_batch(rng, pad)
        batch, lengths = pad_batch(docs, pad)
        bd = torch.from_numpy(batch).to(dev)
        ld = torch.from_numpy(lengths).to(dev)
        for limit in (np.full(len(docs), pad, np.int32), lim):
            md = torch.from_numpy(limit).to(dev)
            for mask_n in (1, 2):
                got = SP.bigram_hist_kernel(bd, ld, md, mask_n)
                torch.cuda.synchronize()
                ref = SP.bigram_hist_plain(bd, ld, md, mask_n)
                errs["bigram_hist"] = max(errs["bigram_hist"],
                                          float((got - ref).abs().max()))
                if not torch.equal(got, ref):
                    fail(f"bigram_hist S={pad} mask_n={mask_n}: counts differ from "
                         f"the plain version ({int((got != ref).sum())} entries)")
            for L in (3, 16):
                errs["bigram_score"] = max(errs["bigram_score"], check_bigram_score(
                    torch, SP, rng, bd, ld, md, L, f"bigram_score edges S={pad}")[0])
        say("kernels", f"bigram_hist S={pad} B={len(docs)} mask_n 1,2 with and without "
            f"limits: bit-exact; bigram_score L=3,16: max abs err "
            f"{errs['bigram_score']:.3g}, two launches bit-identical")
    # Bigram score on documents that repeat one gram (hot keys, large
    # counts) and on random bytes whose distinct bigrams flush the kernel's
    # key counts several times. Signed weights times counts of 2,000 cancel
    # to sums far below their terms, so on the repeated grams the kernel is
    # held against a float64 sum, beside which the plain version's float32
    # sum over 2,000 windows is shown too.
    for label, (docs, lim), pad in (("repeat", _repeat_batch(rng, 2048), 2048),
                                    ("distinct", _distinct_batch(rng, 8192), 8192)):
        batch, lengths = pad_batch(docs, pad)
        bd = torch.from_numpy(batch).to(dev)
        ld = torch.from_numpy(lengths).to(dev)
        err, plain64 = 0.0, 0.0
        for limit in (np.full(len(docs), pad, np.int32), lim):
            md = torch.from_numpy(limit).to(dev)
            for L in (3, 10, 16):
                e, p = check_bigram_score(torch, SP, rng, bd, ld, md, L,
                                          f"bigram_score {label} S={pad}",
                                          f64=label == "repeat")
                err, plain64 = max(err, e), max(plain64, p)
        errs["bigram_score"] = max(errs["bigram_score"], err)
        ref = (f"the float64 sum (the plain version's float32 sum: max abs err {plain64:.3g})"
               if label == "repeat" else "the plain version")
        b0 = bd.long()
        keys = (torch.arange(len(docs), device=dev)[:, None] * 65536 + b0 * 256
                + torch.nn.functional.pad(bd[:, 1:], (0, 1)).long())
        owned = torch.arange(pad, device=dev)[None, :] <= ld.long()[:, None] - 2
        per_doc = torch.bincount(torch.unique(keys[owned]) // 65536, minlength=len(docs))
        say("kernels", f"bigram_score {label} B={len(docs)} S={pad} L=3,10,16 with and "
            f"without limits: max abs err {err:.3g} against {ref}, two launches "
            f"bit-identical; up to "
            f"{int(per_doc.max())} distinct bigrams in a document (the kernel holds "
            f"{SF.FUSED_MAX_ROWS} before a flush)")
    return errs


def random_bigram_weights(torch, rng, L: int, dev):
    """(w1 [256, L], w2 [65536, L]) float32 on ``dev``, standard normal."""
    return tuple(torch.from_numpy(rng.normal(size=(n, L)).astype(np.float32)).to(dev)
                 for n in (256, 65536))


def bigram_score_f64(torch, bd, ld, md, w1, w2, has1: bool, has2: bool):
    """The bigram score summed in float64, one sum a document: the plain
    version's function without its float32 accumulator."""
    B, S = bd.shape
    s = torch.arange(S, device=bd.device)[None, :]
    b0 = bd.long()
    b1 = torch.nn.functional.pad(bd[:, 1:], (0, 1)).long()
    owned = s < md.long()[:, None]
    out = torch.zeros((B, w1.shape[1]), dtype=torch.float64, device=bd.device)
    if has2:
        m2 = (s <= ld.long()[:, None] - 2) & owned
        out += (w2.double()[b0 * 256 + b1] * m2[..., None]).sum(dim=1)
    if has1:
        m1 = (s <= ld.long()[:, None] - 1) & owned
        out += (w1.double()[b0] * m1[..., None]).sum(dim=1)
    return out


def check_bigram_score(torch, SP, rng, bd, ld, md, L: int, what: str, w=None,
                       f64: bool = False) -> tuple[float, float]:
    """The bigram-score kernel on one batch for has1+has2, has2 and has1
    (random weights from ``rng`` unless ``w`` = (w1, w2) is given), held
    within ATOL/RTOL of its plain version, or with ``f64`` of a float64 sum;
    two launches bit-identical. Returns the kernel's max abs error and, with
    ``f64``, the plain version's from the float64 sum (else 0)."""
    w1, w2 = w if w is not None else random_bigram_weights(torch, rng, L, bd.device)
    err, plain_err = 0.0, 0.0
    for has1, has2 in ((True, True), (False, True), (True, False)):
        got = SP.bigram_score_kernel(bd, ld, md, w1, w2, has1, has2)
        again = SP.bigram_score_kernel(bd, ld, md, w1, w2, has1, has2)
        torch.cuda.synchronize()
        case = f"{what} L={L} has1={has1} has2={has2}"
        if not torch.equal(got, again):
            fail(f"{case}: two launches on the same batch differ "
                 f"(max abs {float((got - again).abs().max()):.3g})")
        ref = SP.bigram_score_plain(bd, ld, md, w1, w2, has1, has2)
        if f64:
            exact = bigram_score_f64(torch, bd, ld, md, w1, w2, has1, has2)
            plain_err = max(plain_err, float((ref.double() - exact).abs().max()))
            ref = exact
        e = float((got.double() - ref.double()).abs().max())
        if not torch.allclose(got.double(), ref.double(), atol=ATOL, rtol=RTOL):
            fail(f"{case}: max abs err {e:.3g}")
        err = max(err, e)
    return err, plain_err


@contextlib.contextmanager
def swapped(module, name: str, value):
    """``module.name`` set to ``value`` for the duration."""
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def plain_version(SF):
    """Route every kernel wrapper's CUDA branch to its plain PyTorch version
    (the fused detect and segment, row-histogram, bigram-histogram and
    bigram-score kernels), so
    the runner's whole path (plan, chunking, argmax) runs unchanged on the
    same device with the kernels swapped out."""
    from spark_languagedetector_tpu_torch.ops import score_hist as SH
    from spark_languagedetector_tpu_torch.ops import score_pallas as SP

    swaps = [(SF, "fused_kernel", SF.fused_plain),
             (SF, "fused_segment_kernel", SF.fused_segment_plain),
             (SH, "row_hist_kernel", SH.row_hist_plain),
             (SP, "bigram_hist_kernel", SP.bigram_hist_plain),
             (SP, "bigram_score_kernel", SP.bigram_score_plain)]
    with contextlib.ExitStack() as stack:
        for mod, name, plain in swaps:
            stack.enter_context(swapped(mod, name, plain))
        yield


def phase_main(torch, dev):
    from spark_languagedetector_tpu_torch import LanguageDetector, Table
    from spark_languagedetector_tpu_torch.ops import score_fused as SF
    from spark_languagedetector_tpu_torch.ops.score import score_batch_numpy

    langs = language_names(176)
    train, train_labels = make_corpus(langs, 30 * len(langs), seed=1)
    t0 = time.perf_counter()
    det = (LanguageDetector(langs, [1, 2, 3, 4, 5], 400, device=str(dev))
           .set_vocab_mode("hashed").set_hash_bits(20))
    train_table = Table({"lang": train_labels, "fulltext": train})
    model = det.fit(train_table)
    host_fit_s = time.perf_counter() - t0
    p = model.profile
    say("main", f"fit {len(train)} docs ({sum(map(len, train)) / 1e6:.2f} MB) in "
        f"{host_fit_s:.1f}s: {p.num_grams} grams, {p.spec}")

    eval_docs, eval_labels = make_corpus(langs, 6000, seed=2)
    long_docs, long_labels = make_corpus(langs[:4], 4, mean_len=20000, seed=3)
    texts = eval_docs + long_docs
    truth = eval_labels + long_labels
    byte_docs = [t.encode() for t in texts]
    runner = model.runner
    lay = runner.layout
    say("main", f"runner strategy={runner.strategy} ({runner.strategy_reason}); layout "
        f"inline={[e[:2] for e in lay.inline]} rows_lengths={lay.rows_lengths} "
        f"rows={lay.rows} L={lay.n_langs}; table {runner.table_bytes() / 1e6:.1f} MB; "
        f"{sum(len(d) > runner.max_chunk for d in byte_docs)} docs chunked")
    if runner.strategy != "fused":
        fail(f"runner strategy is {runner.strategy!r}, expected 'fused'")
    if [n for n, *_ in lay.inline] != [1, 2] or lay.rows_lengths != (3, 4, 5):
        fail("config 5 should score lengths 1-2 inline and 3-5 through the rows plane")

    reset_launches()
    t0 = time.perf_counter()
    pred = model.transform(Table({"fulltext": texts})).column("lang").tolist()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = SF.FUSED_DETECT.launches
    say("main", f"transform {len(texts)} docs: {cold_s:.2f}s (first call), "
        f"fused_detect launches {launches}")
    if launches <= 0:
        fail("the main path never launched the fused kernel")
    idx = {l: i for i, l in enumerate(langs)}
    ids = np.asarray([idx[l] for l in pred])
    acc = float(np.mean(ids == np.asarray([idx[l] for l in truth])))
    say("main", f"accuracy vs corpus labels {acc:.4f}")

    with plain_version(SF):
        plain_scores = runner.score(byte_docs)
    flips = check_labels("main f32 kernel vs plain", ids, np.argmax(plain_scores, 1), plain_scores)
    say("main", f"labels vs the plain version on the card: {len(ids) - flips}/{len(ids)} "
        f"identical, {flips} near-tie exceptions")

    n_host = min(1000, len(byte_docs))
    w, sorted_ids = p.host_arrays()
    host = score_batch_numpy(byte_docs[:n_host], w, sorted_ids, p.spec)
    flips = check_labels("main f32 kernel vs host f64", ids[:n_host], np.argmax(host, 1), host)
    say("main", f"label agreement with score_batch_numpy (host f64) on {n_host} docs: "
        f"{1 - flips / n_host:.4f} ({flips} near-tie exceptions)")

    quant_runners = {}
    for quant, gate in (("int16", 1.0), ("int8", 0.999)):
        qmodel = model.copy({"quantization": quant})
        SF.FUSED_DETECT.launches = 0
        qpred = qmodel.transform(Table({"fulltext": texts})).column("lang").tolist()
        qids = np.asarray([idx[l] for l in qpred])
        qlaunch = SF.FUSED_DETECT.launches
        with plain_version(SF):
            qplain = qmodel.runner.predict_ids(byte_docs)
        if not np.array_equal(qids, qplain):
            fail(f"{quant}: kernel labels differ from the plain version "
                 f"({int((qids != qplain).sum())} docs; integer sums are exact)")
        agree = float(np.mean(qids == ids))
        say("main", f"{quant}: agreement with f32 labels {agree:.5f} (gate {gate}), "
            f"identical to its plain version, launches {qlaunch}, "
            f"table {qmodel.runner.table_bytes() / 1e6:.1f} MB")
        if agree < gate:
            fail(f"{quant} agreement {agree} below the gate {gate}")
        quant_runners[quant] = qmodel.runner
    fit_case = FitCase(det, train_table, model, host_fit_s, texts, ids)
    return model, runner, quant_runners, texts, ids, eval_docs, launches, fit_case


def device_breakdown(torch, fn, wall_ms: float, top: int = 8) -> None:
    """Where one warm call's time goes: device time by kernel name
    (torch.profiler, device-side events only) and the device's busy share
    of ``wall_ms``, the same call's wall time measured without the profiler
    (whose start-up would otherwise dominate the wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    if not rows:
        say("profile", "device time not measured (the profiler recorded no "
            "device activity)")
        return
    busy_ms = sum(r[1] for r in rows)
    say("profile", f"device busy {busy_ms:.2f} ms of a {wall_ms:.1f} ms warm call "
        f"(unprofiled wall) = {busy_ms / wall_ms:.1%} busy, "
        f"{1 - busy_ms / wall_ms:.1%} idle")
    for key, ms, count in rows[:top]:
        say("profile", f"  {ms:8.3f} ms  {count:5d}x  {key[:90]}")


def fused_compulsory_inputs(torch, SF, inp, lay):
    """What a fused kernel must read of one batch besides the table: (rows
    int64 [B, ΣW], mask bool [B, ΣW] of the counted windows of every length,
    input bytes, distinct table rows touched). Input bytes: the bytes that
    the inline lengths' owned windows cover, the rows-plane entries of owned
    windows, the partial-window rows and the two per-document vectors;
    padding past a document's end is not counted."""
    pairs = list(SF.window_rows(inp, lay))
    rows = torch.cat([r for r, _ in pairs], dim=1)
    mask = torch.cat([m for _, m in pairs], dim=1)
    plane_entries = sum(int(m.sum()) for _, m in pairs[len(lay.inline):])
    byte_reads = torch.zeros_like(inp.lengths, dtype=torch.int64)
    for n, *_ in lay.inline:
        short = (inp.lengths > 0) & (inp.lengths < n)
        byte_reads = torch.maximum(byte_reads, torch.where(
            short, inp.lengths.long(), window_bytes(inp.lengths, inp.lim, n)))
    in_bytes = (int(byte_reads.sum()) + plane_entries * 4 + inp.prow.numel() * 4
                + inp.batch.shape[0] * 8)
    return rows, mask, in_bytes, int(torch.unique(rows[mask]).numel())


def phase_times(torch, dev, model, runner, quant_runners, eval_docs, baselines=()):
    from spark_languagedetector_tpu_torch import Table
    from spark_languagedetector_tpu_torch.ops import score_fused as SF
    from spark_languagedetector_tpu_torch.ops.encoding import pad_batch

    byte_docs = [t.encode() for t in eval_docs]
    sel, pad_to = max(runner.plan([len(d) for d in byte_docs]),
                      key=lambda item: len(item[0]) * item[1])
    batch, lengths = pad_batch([byte_docs[k] for k in sel], pad_to)
    batch = torch.from_numpy(batch).to(dev)
    lengths = torch.from_numpy(lengths).to(dev)
    lay = runner.layout
    inp = SF.prepare_fused_inputs(batch, lengths, runner.table_lut, None, runner.spec, lay)
    B, S = batch.shape
    L = lay.n_langs
    say("times", f"config-5 batch: B={B} x S={S} (the runner's largest planned batch)")

    def kernel(r=runner, labels=True):
        return SF.fused_kernel(inp, r.table, r.scales, r.layout, want_labels=labels)

    # The kernel against its plain version at the main path's shapes.
    c5_err, flips = compare_kernel(torch, SF, inp, runner.table, runner.scales, lay,
                                   "config-5 batch f32")
    say("times", f"config-5 batch kernel vs plain: max abs err {c5_err:.3g}, "
        f"near-tie label flips {flips}")
    for q, r in quant_runners.items():
        qinp = SF.prepare_fused_inputs(batch, lengths, r.table_lut, None, r.spec, r.layout)
        q_err, _ = compare_kernel(torch, SF, qinp, r.table, r.scales, r.layout,
                                  f"config-5 batch {q}")
        say("times", f"config-5 batch {q} kernel vs plain: max abs err {q_err:.3g}")

    ms = timed_in_turns(torch, "fused_detect f32 detect", kernel, SF, "FUSED_DETECT",
                        baselines)
    score_ms = timed_in_turns(torch, "fused_detect f32 score", lambda: kernel(labels=False),
                              SF, "FUSED_DETECT", baselines)
    plain_ms = cuda_ms(torch, lambda: SF.fused_plain(
        inp, runner.table, runner.scales, lay, want_labels=True), reps=3, warmup=1)
    q_ms = {q: timed_in_turns(torch, f"fused_detect {q} detect", lambda r=r: kernel(r), SF,
                              "FUSED_DETECT", baselines)
            for q, r in quant_runners.items()}

    rows, mask, in_bytes, touched = fused_compulsory_inputs(torch, SF, inp, lay)
    weights = mask.to(torch.float32)
    lib = lambda: torch.nn.functional.embedding_bag(  # noqa: E731
        rows, runner.table, mode="sum", per_sample_weights=weights)
    library_ms = cuda_ms(torch, lib, reps=5, warmup=1)
    lib_err = float((lib() - kernel(labels=False)).abs().max())
    say("times", f"embedding_bag vs kernel scores: max abs err {lib_err:.3g}")

    # Lower bound: the larger of compulsory bytes (each input read once:
    # the bytes the inline lengths' owned windows cover, the rows-plane
    # entries of owned windows, partial-window rows, per-doc vectors, the
    # table rows this batch touches, scales; labels + best written once)
    # over HBM bandwidth, and the f32 operations the function needs over
    # the f32 rate. Padding past a document's end is not counted. A
    # document's score is the sum over its distinct rows of count x w[row],
    # so it needs one multiply-add (2 operations) per distinct (document,
    # row) pair and language, however often the gram repeats.
    valid = int(mask.sum())
    pairs = distinct_rows(torch, SF, inp, lay)[0]
    itemsize = runner.table.element_size()
    total_bytes = in_bytes + touched * L * itemsize + L * 4 + B * 8
    bytes_ms = total_bytes / HBM_BYTES_PER_S * 1e3
    ops = 2 * pairs * L
    ops_ms = ops / F32_OPS_PER_S * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    say("times", f"counted windows {valid}, distinct (doc, row) pairs {pairs}, table rows "
        f"touched {touched}, compulsory bytes {total_bytes / 1e6:.1f} MB -> "
        f"{bytes_ms:.4f} ms; f32 ops {ops / 1e9:.3f} G -> {ops_ms:.4f} ms; "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    say("times", f"fused_detect f32 detect {ms:.4f} ms, score {score_ms:.4f} ms; "
        + ", ".join(f"{q} detect {t:.4f} ms" for q, t in q_ms.items())
        + f"; plain {plain_ms:.3f} ms; embedding_bag {library_ms:.3f} ms; "
        f"kernel at {bound_ms / ms:.1%} of its bound")

    table = Table({"fulltext": eval_docs})
    model.transform(table)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.transform(table)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    say("times", f"end-to-end transform of {len(eval_docs)} docs: {e2e_s:.3f}s = "
        f"{len(eval_docs) / e2e_s:.0f} docs/s (host clock, warm)")
    device_breakdown(torch, lambda: model.transform(table), e2e_s * 1e3)
    return c5_err, dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=library_ms), inp


def reset_launches() -> None:
    from spark_languagedetector_tpu_torch.ops._kernels import KERNELS

    for k in KERNELS:
        k.launches = 0


def read_launches() -> dict[str, int]:
    from spark_languagedetector_tpu_torch.ops._kernels import KERNELS

    return {k.name: k.launches for k in KERNELS}


def check_path(torch, SF, what: str, runner, byte_docs, ids, profile, n_host: int) -> None:
    """Labels of one path against the plain versions on the card (whole
    input) and the host float64 scorer (first ``n_host`` documents), both
    outside near-ties."""
    from spark_languagedetector_tpu_torch.ops.score import score_batch_numpy

    n_host = min(n_host, len(byte_docs))
    with plain_version(SF):
        plain_scores = runner.score(byte_docs)
    flips = check_labels(f"{what} kernels vs plain", ids, np.argmax(plain_scores, 1),
                         plain_scores)
    say(what, f"labels vs the plain versions on the card: {len(ids) - flips}/{len(ids)} "
        f"identical, {flips} near-tie exceptions")
    w, sorted_ids = profile.host_arrays()
    host = score_batch_numpy(byte_docs[:n_host], w, sorted_ids, profile.spec)
    flips = check_labels(f"{what} kernels vs host f64", ids[:n_host], np.argmax(host, 1), host)
    say(what, f"label agreement with score_batch_numpy (host f64) on {n_host} docs: "
        f"{1 - flips / n_host:.4f} ({flips} near-tie exceptions)")


def phase_config3(torch, dev):
    """Bench config 3 (50 languages, exact n = 1..5, profile 1,000) through
    fit → transform: auto picks hybrid, which runs the bigram-histogram
    kernel for n <= 2 (50 > 16 languages) and the row-histogram kernel for
    n = 3..5."""
    from spark_languagedetector_tpu_torch import LanguageDetector, Table
    from spark_languagedetector_tpu_torch.ops import score_fused as SF

    langs = language_names(50)
    train, train_labels = make_corpus(langs, 40 * len(langs), seed=1)
    t0 = time.perf_counter()
    det = LanguageDetector(langs, [1, 2, 3, 4, 5], 1000, device=str(dev)).set_vocab_mode("exact")
    train_table = Table({"lang": train_labels, "fulltext": train})
    model = det.fit(train_table)
    p = model.profile
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    runner = model.runner
    say("config3", f"fit {len(train)} docs ({sum(map(len, train)) / 1e6:.2f} MB) in "
        f"{fit_s:.1f}s: G={p.num_grams} grams, {p.spec}; runner built in "
        f"{time.perf_counter() - t0:.1f}s (cuckoo + bucket tables, dense n<=2 sub-table)")
    say("config3", f"runner strategy={runner.strategy} ({runner.strategy_reason}); "
        f"batch size {runner.batch_size}")
    if runner.strategy != "hybrid" or runner.hist_state is None:
        fail(f"config 3 should run hybrid with the row histogram, got {runner.strategy!r} "
             f"(hist state {'set' if runner.hist_state is not None else 'missing'})")

    eval_docs, eval_labels = make_corpus(langs, 8000, seed=2)
    long_docs, long_labels = make_corpus(langs[:3], 3, mean_len=20000, seed=3)
    edge = ["", "\x01\x02\x03\x04\x05\x06", "\x01"]  # empty and all-miss: label 0
    texts = eval_docs + long_docs + edge
    byte_docs = [t.encode() for t in texts]
    reset_launches()
    t0 = time.perf_counter()
    pred = model.transform(Table({"fulltext": texts})).column("lang").tolist()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = read_launches()
    say("config3", f"transform {len(texts)} docs ({len(long_docs)} chunked, "
        f"{len(edge)} edge): {cold_s:.2f}s (first call); launches {launches}")
    if launches["row_hist"] <= 0 or launches["bigram_hist"] <= 0:
        fail("config 3 never launched the row-histogram or bigram-histogram kernel")
    idx = {l: i for i, l in enumerate(langs)}
    ids = np.asarray([idx[l] for l in pred])
    truth = np.asarray([idx[l] for l in eval_labels + long_labels])
    acc = float(np.mean(ids[: len(truth)] == truth))
    say("config3", f"accuracy vs corpus labels {acc:.4f}")
    if ids[-3:].tolist() != [0, 0, 0]:
        fail(f"empty and all-miss documents must label 0, got {ids[-3:].tolist()}")
    check_path(torch, SF, "config3", runner, byte_docs, ids, p, 1000)

    # TF32 allowed process-wide must not reach the histogram contractions.
    sample = byte_docs[:2000]
    ref_scores, ref_ids = runner.score(sample), runner.predict_ids(sample)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf_scores, tf_ids = runner.score(sample), runner.predict_ids(sample)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    if not (np.array_equal(tf_scores, ref_scores) and np.array_equal(tf_ids, ref_ids)):
        fail("allow_tf32=True changed config-3 scores or labels "
             f"(max abs diff {float(np.abs(tf_scores - ref_scores).max()):.3g})")
    say("config3", f"allow_tf32=True: {len(sample)} docs' scores and labels identical")

    sel, pad_to = max(runner.plan([len(d) for d in byte_docs[: len(eval_docs)]]),
                      key=lambda item: len(item[0]) * item[1])
    h = runner.hist_state
    B, K, L = len(sel), len(runner.pallas_state.rest), runner.num_langs
    W = pad_to - min(runner.pallas_state.rest) + 1
    mb = 1e6
    say("config3", f"G={p.num_grams}, Rhi={h.rhi} ({h.rhi * 256} padded rows); tables: "
        f"weights {h.weights_pad.numel() * 4 / mb:.1f} MB as f32 "
        f"({h.weights_pad.numel() * 8 / mb:.1f} MB held as f64), bucket "
        f"{h.bucket.numel() * 4 / mb:.2f} MB, bigram views "
        f"{(runner.pallas_state.w1.numel() + runner.pallas_state.w2.numel()) * 4 / mb:.1f} MB; "
        f"largest batch B={B} x S={pad_to}: rows plane {B * K * W * 4 / mb:.1f} MB, "
        f"row histogram {B * h.rhi * 256 * 4 / mb:.1f} MB, bigram histogram "
        f"{B * 65536 * 4 / mb:.1f} MB")
    return model, runner, eval_docs, launches, FitCase(det, train_table, model, fit_s, texts, ids)


def phase_kernel5(torch, dev):
    """The bigram-score kernel's paths: exact n = 1..5 at 10 languages (auto
    → hybrid, L <= 16) and bench config 1 (3 languages, exact bigrams,
    profile 2,000) with strategy='pallas'."""
    from spark_languagedetector_tpu_torch import LanguageDetector, Table
    from spark_languagedetector_tpu_torch.api.runner import BatchRunner
    from spark_languagedetector_tpu_torch.ops import score_fused as SF

    langs = language_names(10)
    train, train_labels = make_corpus(langs, 40 * len(langs), seed=1)
    model = (LanguageDetector(langs, [1, 2, 3, 4, 5], 1000, device=str(dev))
             .set_vocab_mode("exact")
             .fit(Table({"lang": train_labels, "fulltext": train})))
    runner10 = model.runner
    if runner10.strategy != "hybrid":
        fail(f"10-language exact n=1..5 should run hybrid, got {runner10.strategy!r}")
    texts, _ = make_corpus(langs, 2000, seed=2)
    texts += make_corpus(langs[:2], 2, mean_len=20000, seed=3)[0]
    byte_docs = [t.encode() for t in texts]
    reset_launches()
    pred = model.transform(Table({"fulltext": texts})).column("lang").tolist()
    torch.cuda.synchronize()
    launches = read_launches()
    say("kernel5", f"10 languages, exact n=1..5: strategy={runner10.strategy}, "
        f"{len(texts)} docs, launches {launches}")
    if launches["bigram_score"] <= 0 or launches["row_hist"] <= 0:
        fail("the 10-language path never launched the bigram-score or row-histogram kernel")
    idx = {l: i for i, l in enumerate(langs)}
    ids = np.asarray([idx[l] for l in pred])
    check_path(torch, SF, "kernel5", runner10, byte_docs, ids, model.profile, 500)
    table = Table({"fulltext": texts})
    model.transform(table)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.transform(table)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    say("kernel5", f"end-to-end 10-language transform of {len(texts)} docs: {e2e_s:.3f}s = "
        f"{len(texts) / e2e_s:.0f} docs/s (host clock, warm)")
    device_breakdown(torch, lambda: model.transform(table), e2e_s * 1e3)

    langs3 = language_names(3)
    train, train_labels = make_corpus(langs3, 60 * len(langs3), seed=1)
    c1 = (LanguageDetector(langs3, [2], 2000, device=str(dev)).set_vocab_mode("exact")
          .fit(Table({"lang": train_labels, "fulltext": train})))
    w, lut, cuckoo = c1.profile.device_membership(device=str(dev))
    runner1 = BatchRunner(weights=w, lut=lut, cuckoo=cuckoo, spec=c1.profile.spec,
                          device=str(dev), strategy="pallas")
    texts, _ = make_corpus(langs3, 2000, seed=2)
    byte_docs = [t.encode() for t in texts]
    reset_launches()
    ids = runner1.predict_ids(byte_docs)
    torch.cuda.synchronize()
    c1_launches = read_launches()
    say("kernel5", f"config 1 (3 languages, exact bigrams, k=2000) strategy=pallas: "
        f"{len(texts)} docs, launches {c1_launches}")
    if c1_launches["bigram_score"] <= 0:
        fail("config 1 with strategy='pallas' never launched the bigram-score kernel")
    check_path(torch, SF, "kernel5", runner1, byte_docs, ids, c1.profile, 500)
    return runner10, launches


def _kernel_entry(name, source, replaces, launches, err, ms, plain_ms, bytes_, ops,
                  library_ms) -> dict:
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    say("times", f"{name}: {ms:.4f} ms; plain {plain_ms:.3f} ms; library {library_ms:.3f} ms; "
        f"compulsory bytes {bytes_ / 1e6:.1f} MB -> {bytes_ms:.4f} ms, operations "
        f"{ops / 1e9:.4f} G -> {ops_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}); "
        f"kernel at {bound_ms / ms:.1%} of its bound")
    return {"name": name, "route": "cuda",
            "source": f"spark_languagedetector_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def phase_times_hist(torch, dev, model, runner, runner10, eval_docs, launches3, launches10,
                     errs, baselines=()) -> list[dict]:
    """The three kernels at the config-3 runner's largest batch (bigram score
    with the 10-language runner's weights, and at L = 16), their plain
    versions, their bounds and one library call each, and an empty kernel
    launch; then the end-to-end config-3 transform and the device's busy
    share."""
    from spark_languagedetector_tpu_torch import Table
    from spark_languagedetector_tpu_torch.ops import score_hist as SH
    from spark_languagedetector_tpu_torch.ops import score_pallas as SP
    from spark_languagedetector_tpu_torch.ops.encoding import pad_batch

    byte_docs = [t.encode() for t in eval_docs]
    sel, pad_to = max(runner.plan([len(d) for d in byte_docs]),
                      key=lambda item: len(item[0]) * item[1])
    batch, lengths = pad_batch([byte_docs[k] for k in sel], pad_to)
    batch = torch.from_numpy(batch).to(dev)
    lengths = torch.from_numpy(lengths).to(dev)
    B, S = batch.shape
    lim = torch.full((B,), S, dtype=torch.int32, device=dev)
    doc = torch.arange(B, device=dev)[:, None]
    say("times", f"config-3 batch: B={B} x S={S} (the runner's largest planned batch)")
    out = []

    # Kernel 3: the row histogram of the long lengths.
    h = runner.hist_state
    miss = h.weights_pad.shape[0] - 1
    rows, vmax, W = SH.hist_rows_plane(
        batch, lengths, miss, h.lut, h.bucket, spec=runner.spec, bucket_seed=h.seed,
        bucket_kind=h.kind, gram_lengths_subset=runner.pallas_state.rest)
    R = h.rhi * 256
    # Compulsory bytes of every kernel below: the entries or bytes that the
    # documents' own windows cover (padding past a document's end, or past
    # its vmax, is not counted), the per-doc vectors, the weights touched,
    # and the output written once.
    got = SH.row_hist_kernel(rows, vmax, W, h.rhi, miss)
    ref = SH.row_hist_plain(rows, vmax, W, h.rhi, miss)
    err3 = float((got - ref).abs().max())
    if not torch.equal(got, ref):
        fail("config-3 batch: row_hist counts differ from the plain version")
    r = rows.long()
    local = torch.arange(rows.shape[1], device=dev) % W
    read = local[None, :] < vmax.long()[:, None]
    valid = read & (r >= 0) & (r < R) & (r != miss)
    idx3 = (doc * R + r)[valid]
    out.append(_kernel_entry(
        "row_hist", "row_hist.cu", "spark_languagedetector_tpu/ops/score_hist.py:67",
        launches3["row_hist"], max(errs["row_hist"], err3),
        timed_in_turns(torch, "row_hist", lambda: SH.row_hist_kernel(rows, vmax, W, h.rhi, miss),
                       SH, "ROW_HIST", baselines),
        cuda_ms(torch, lambda: SH.row_hist_plain(rows, vmax, W, h.rhi, miss), reps=3,
                warmup=1),
        int(read.sum()) * 4 + B * 4 + B * R * 4, int(valid.sum()),
        cuda_ms(torch, lambda: torch.bincount(idx3, minlength=B * R), reps=5, warmup=1)))

    # Kernel 4: the bigram histogram.
    got = SP.bigram_hist_kernel(batch, lengths, lim, 2)
    ref = SP.bigram_hist_plain(batch, lengths, lim, 2)
    err4 = float((got - ref).abs().max())
    if not torch.equal(got, ref):
        fail("config-3 batch: bigram_hist counts differ from the plain version")
    b0 = batch.long()
    b1 = torch.nn.functional.pad(batch[:, 1:], (0, 1)).long()
    s = torch.arange(S, device=dev)[None, :]
    m2 = s <= lengths.long()[:, None] - 2
    idx4 = (doc * 65536 + b0 * 256 + b1)[m2]
    out.append(_kernel_entry(
        "bigram_hist", "bigram_hist.cu",
        "spark_languagedetector_tpu/ops/score_pallas.py:177",
        launches3["bigram_hist"], max(errs["bigram_hist"], err4),
        timed_in_turns(torch, "bigram_hist", lambda: SP.bigram_hist_kernel(batch, lengths, lim, 2),
                       SP, "BIGRAM_HIST", baselines),
        cuda_ms(torch, lambda: SP.bigram_hist_plain(batch, lengths, lim, 2), reps=3,
                warmup=1),
        int(window_bytes(lengths, lim, 2).sum()) + B * 8 + B * 65536 * 4, int(m2.sum()),
        cuda_ms(torch, lambda: torch.bincount(idx4, minlength=B * 65536), reps=5,
                warmup=1)))

    # Kernel 5: the bigram score, with the 10-language hybrid's weights (the
    # path's L) and with random weights at L = 16, the widest it takes.
    st = runner10.pallas_state
    L = st.w1.shape[1]
    w16 = random_bigram_weights(torch, np.random.default_rng(5), 16, dev)
    err5 = max(check_bigram_score(torch, SP, None, batch, lengths, lim, w[0].shape[1],
                                  "config-3 batch bigram_score", w=w)[0]
               for w in ((st.w1, st.w2), w16))
    got = SP.bigram_score_kernel(batch, lengths, lim, st.w1, st.w2, True, True)
    m1 = s <= lengths.long()[:, None] - 1
    table = torch.cat([st.w2, st.w1])  # [65536 + 256, L]
    bag = torch.cat([b0 * 256 + b1, 65536 + b0], dim=1)
    bag_w = torch.cat([m2, m1], dim=1).to(torch.float32)
    lib = lambda: torch.nn.functional.embedding_bag(  # noqa: E731
        bag, table, mode="sum", per_sample_weights=bag_w)
    lib_err = float((lib() - got).abs().max())
    say("times", f"config-3 batch bigram_score at L={L} and L=16, has1/has2 combinations: "
        f"max abs err {err5:.3g} vs the plain version, two launches bit-identical; "
        f"embedding_bag vs bigram_score: max abs err {lib_err:.3g}")
    pairs2 = int(torch.unique(idx4).numel())
    pairs1 = int(torch.unique((doc * 256 + b0)[m1]).numel())
    touched = int(torch.unique((b0 * 256 + b1)[m2]).numel())
    k5_ms, _ = (timed_in_turns(
        torch, f"bigram_score L={w[0].shape[1]}",
        lambda w=w: SP.bigram_score_kernel(batch, lengths, lim, *w, True, True), SP,
        "BIGRAM_SCORE", baselines, reps=50) for w in ((st.w1, st.w2), w16))
    out.append(_kernel_entry(
        "bigram_score", "bigram_score.cu",
        "spark_languagedetector_tpu/ops/score_pallas.py:119",
        launches10["bigram_score"], max(errs["bigram_score"], err5), k5_ms,
        cuda_ms(torch, lambda: SP.bigram_score_plain(batch, lengths, lim, st.w1, st.w2,
                                                     True, True), reps=3, warmup=1),
        int(torch.maximum(window_bytes(lengths, lim, 1), window_bytes(lengths, lim, 2)).sum())
        + B * 8 + (touched + 256) * L * 4 + B * L * 4, 2 * (pairs2 + pairs1) * L,
        cuda_ms(torch, lib, reps=5, warmup=1)))
    say("times", f"bigram_score at L={L}: {int(m2.sum())} counted bigram windows, {pairs2} "
        f"distinct (doc, bigram) and {pairs1} distinct (doc, byte) pairs, {touched} w2 rows "
        f"touched")
    floor_ms = cuda_ms(torch, lambda: torch.cuda._sleep(0), reps=200)
    say("times", f"empty kernel launch (torch.cuda._sleep(0): one thread, no work) "
        f"{floor_ms:.4f} ms per launch, back to back on a held card, beside bigram_score's "
        f"bound {out[-1]['bound_ms']:.6f} ms and its {k5_ms:.4f} ms")

    table = Table({"fulltext": eval_docs})
    model.transform(table)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.transform(table)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    say("times", f"end-to-end config-3 transform of {len(eval_docs)} docs: {e2e_s:.3f}s = "
        f"{len(eval_docs) / e2e_s:.0f} docs/s (host clock, warm)")
    device_breakdown(torch, lambda: model.transform(table), e2e_s * 1e3)
    return out


CELL_ATOL = 1e-3  # per-cell f32 sums against float64 (the gather-vs-oracle class)
SPAN_F1_GATE = 0.85  # the JAX package's segmentation gate (bench.py smoke_segment)


def check_cells(what: str, got, ref, atol: float, rtol: float) -> float:
    """Per-document cell arrays against a reference: same shapes, values
    within atol/rtol. Returns the max abs error."""
    err = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        if g.shape != r.shape:
            fail(f"{what}: doc {i} cells {g.shape} != {r.shape}")
        if g.size:
            err = max(err, float(np.abs(g - r).max()))
        if not np.allclose(g, r, atol=atol, rtol=rtol):
            fail(f"{what}: doc {i} differs (max abs err {float(np.abs(g - r).max()):.3g})")
    return err


def phase_segment(torch, dev, model, main_ids, main_docs):
    """Segment mode at full width: the config-5 model (176 languages),
    calibrated on a held-out split, transforms a code-switched corpus with
    ``resultMode="segment"`` through the fused-segment kernel."""
    from spark_languagedetector_tpu_torch import Table
    from spark_languagedetector_tpu_torch.api.runner import SEGMENT_CELL
    from spark_languagedetector_tpu_torch.ops import score_fused as SF
    from spark_languagedetector_tpu_torch.ops.score import window_scores_numpy

    langs = list(model.profile.languages)
    held, held_labels = make_corpus(langs, 2 * len(langs), mean_len=250, seed=77)
    t0 = time.perf_counter()
    model.calibrate(Table({"fulltext": held, "lang": held_labels}))
    meta = model.calibration.meta
    say("segment", f"calibrated on {len(held)} held-out docs in {time.perf_counter() - t0:.1f}s: "
        f"NLL {meta['nll_before']} -> {meta['nll_after']}, ECE {meta['ece_before']} -> "
        f"{meta['ece_after']}")
    seg = model.copy({"resultMode": "segment"})
    seg.calibration = model.calibration
    runner = seg.runner
    if runner.strategy != "fused":
        fail(f"segment runner strategy is {runner.strategy!r}, expected 'fused'")
    main_bytes = [t.encode() for t in main_docs]
    if not np.array_equal(runner.predict_ids(main_bytes), main_ids):
        fail("the segment-mode model's whole-doc labels differ from phase main's")

    cs_docs, truth = make_codeswitch_corpus(langs, 300, seed=23)
    long_docs, long_labels = make_corpus(langs[:2], 2, mean_len=20000, seed=5)
    texts = cs_docs + long_docs + [""]
    truth = truth + [[(0, len(d.encode()), l)] for d, l in zip(long_docs, long_labels)] + [[]]
    byte_docs = [t.encode() for t in texts]
    n_chunked = sum(len(d) > runner.max_chunk for d in byte_docs)

    plain_calls = []
    real_plain = SF.fused_segment_plain
    SF.fused_segment_plain = lambda *a, **k: plain_calls.append(1) or real_plain(*a, **k)
    try:
        reset_launches()
        t0 = time.perf_counter()
        out = seg.transform(Table({"fulltext": texts})).column("lang").tolist()
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        SF.fused_segment_plain = real_plain
    results = [json.loads(v) for v in out]
    say("segment", f"transform {len(texts)} docs ({sum(map(len, byte_docs)) / 1e6:.2f} MB, "
        f"{n_chunked} chunked, cell {SEGMENT_CELL}): {cold_s:.2f}s (first call); "
        f"launches {launches}; plain-version calls {len(plain_calls)}")
    if launches["fused_segment"] <= 0:
        fail("the segment path never launched the fused-segment kernel")
    if plain_calls:
        fail("the segment path reached the plain version (a CPU tensor) on the card")
    if n_chunked != len(long_docs):
        fail(f"expected {len(long_docs)} chunked documents, got {n_chunked}")

    # Results: shape, partition of every document, finite probabilities.
    for r, d in zip(results, byte_docs):
        if set(r) != {"label", "rejected", "calibrated", "topk", "spans"} or not r["calibrated"]:
            fail(f"segment result malformed: {sorted(r)} calibrated={r.get('calibrated')}")
        spans = r["spans"]
        if d and (spans[0]["start"] != 0 or spans[-1]["end"] != len(d)
                  or any(a["end"] != b["start"] for a, b in zip(spans, spans[1:]))):
            fail("segment spans do not partition their document")
        if not d and spans:
            fail("the empty document must have no spans")
        if not all(np.isfinite(e["prob"]) and 0.0 <= e["prob"] <= 1.0 for e in r["topk"]):
            fail("segment top-k probabilities are not finite probabilities")

    # Per-cell scores: kernel vs the plain version on the card (whole input),
    # vs the host float64 oracle (a sample, the chunked and the empty
    # documents included), and their sums vs the whole-document scores.
    cells, scored = runner.segment_cells(byte_docs)
    with plain_version(SF):
        plain_cells, _ = runner.segment_cells(byte_docs)
    err_plain = check_cells("segment kernel vs plain", cells, plain_cells, ATOL, RTOL)
    sample = list(range(60)) + list(range(len(cs_docs), len(byte_docs)))
    w, sorted_ids = model.profile.host_arrays()
    oracle = window_scores_numpy([byte_docs[i] for i in sample], w, sorted_ids,
                                 model.profile.spec, SEGMENT_CELL)
    err_host = check_cells("segment kernel vs host f64", [cells[i] for i in sample], oracle,
                           CELL_ATOL, RTOL)
    whole = runner.score(byte_docs)
    sums = np.stack([c.sum(axis=0) for c in cells])
    if not np.allclose(sums, whole, rtol=1e-4, atol=1e-2):
        fail(f"cell sums differ from runner.score (max abs {float(np.abs(sums - whole).max()):.3g})")
    if cells[-1].shape != (1, len(langs)) or cells[-1].any():
        fail("the empty document must be one all-zero cell")
    say("segment", f"cells: max abs err {err_plain:.3g} vs the plain version on the card "
        f"({len(cells)} docs, atol {ATOL}), {err_host:.3g} vs window_scores_numpy (host f64, "
        f"{len(sample)} docs, atol {CELL_ATOL}); cell sums = runner.score within "
        f"rtol 1e-4/atol 1e-2")

    lens = [len(d) for d in byte_docs]
    f1 = macro_span_f1(truth, results, lens)
    f1_family = macro_span_f1(truth, results, lens, name_of=family_of)
    top1 = float(np.mean([r["label"] in {l for _, _, l in t} for r, t in
                          zip(results[:len(cs_docs)], truth)]))
    say("segment", f"byte-span macro F1 vs the known boundaries: {f1:.4f} by language "
        f"(gate {SPAN_F1_GATE}), {f1_family:.4f} by family; top-1 label among the "
        f"document's true languages {top1:.4f}; spans per doc "
        f"{np.mean([len(r['spans']) for r in results[:len(cs_docs)]]):.2f}")
    if f1 < SPAN_F1_GATE:
        fail(f"segmentation span F1 {f1:.4f} below the gate {SPAN_F1_GATE}")

    if not np.array_equal(runner.predict_ids(main_bytes), main_ids):
        fail("whole-doc labels changed after the segment traffic")
    say("segment", f"whole-doc labels of {len(main_ids)} phase-main docs unchanged after "
        "the segment traffic")

    table = Table({"fulltext": cs_docs})
    seg.transform(table)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seg.transform(table)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    runner.segment_cells([t.encode() for t in cs_docs])
    cells_s = time.perf_counter() - t0
    say("segment", f"end-to-end segment transform of {len(cs_docs)} docs: {e2e_s:.3f}s = "
        f"{len(cs_docs) / e2e_s:.0f} docs/s (host clock, warm); of it segment_cells "
        f"{cells_s * 1e3:.1f} ms, host decode (segment/) {(e2e_s - cells_s) * 1e3:.1f} ms")
    device_breakdown(torch, lambda: seg.transform(table), e2e_s * 1e3)
    return launches["fused_segment"], err_plain


def phase_times_segment(torch, dev, runner, quant_runners, inp, launches: int,
                        errs: float, baselines=()) -> dict:
    """The fused-segment kernel at the runner's largest config-5 batch (the
    batch phase 5 timed the fused-detect kernel on), cell 256: kernel (f32,
    and the int16 and int8 tables, each held bit for bit against its plain
    version), plain version, bound and ``embedding_bag`` with one bag per
    (document, cell)."""
    from spark_languagedetector_tpu_torch.api.runner import SEGMENT_CELL as cell
    from spark_languagedetector_tpu_torch.ops import score_fused as SF

    lay = runner.layout
    B, S = inp.batch.shape
    L = lay.n_langs
    C = -(-S // cell)
    got = SF.fused_segment_kernel(inp, runner.table, runner.scales, lay, cell)
    torch.cuda.synchronize()
    ref = SF.fused_segment_plain(inp, runner.table, runner.scales, lay, cell)
    err = float((got - ref).abs().max())
    if not torch.allclose(got, ref, atol=ATOL, rtol=RTOL):
        fail(f"config-5 batch: fused_segment differs from the plain version ({err:.3g})")
    say("times", f"config-5 batch B={B} x S={S}, cell {cell} ({C} cells): fused_segment vs "
        f"plain max abs err {err:.3g}")
    ms = timed_in_turns(torch, "fused_segment f32", lambda: SF.fused_segment_kernel(
        inp, runner.table, runner.scales, lay, cell), SF, "FUSED_SEGMENT", baselines)
    q_ms = {}
    for q, r in quant_runners.items():
        qinp = SF.prepare_fused_inputs(inp.batch, inp.lengths, r.table_lut, None, r.spec,
                                       r.layout)
        if not torch.equal(SF.fused_segment_kernel(qinp, r.table, r.scales, r.layout, cell),
                           SF.fused_segment_plain(qinp, r.table, r.scales, r.layout, cell)):
            fail(f"config-5 batch: fused_segment {q} differs from the plain version")
        q_ms[q] = timed_in_turns(torch, f"fused_segment {q}", lambda qinp=qinp, r=r:
                                 SF.fused_segment_kernel(qinp, r.table, r.scales, r.layout,
                                                         cell), SF, "FUSED_SEGMENT", baselines)
    say("times", f"fused_segment f32 {ms:.4f} ms, "
        + ", ".join(f"{q} {t:.4f} ms (bit-identical to its plain version)"
                    for q, t in q_ms.items()))
    plain_ms = cuda_ms(torch, lambda: SF.fused_segment_plain(
        inp, runner.table, runner.scales, lay, cell), reps=3, warmup=1)

    # One bag per (document, cell): the rows of every length's windows that
    # start in the cell, masked windows weighted 0.
    bags, bag_w = [], []
    for r, m in SF.window_rows(inp, lay):
        padn = C * cell - r.shape[1]
        bags.append(torch.nn.functional.pad(r, (0, padn)).reshape(B, C, cell))
        bag_w.append(torch.nn.functional.pad(m, (0, padn)).reshape(B, C, cell))
    bag = torch.cat(bags, dim=2).reshape(B * C, -1)
    mask = torch.cat(bag_w, dim=2).reshape(B * C, -1)
    weights = mask.to(torch.float32)
    lib = lambda: torch.nn.functional.embedding_bag(  # noqa: E731
        bag, runner.table, mode="sum", per_sample_weights=weights)
    library_ms = cuda_ms(torch, lib, reps=3, warmup=1)
    starts = torch.arange(C, device=dev)[None, :] * cell
    live = (starts < inp.lengths[:, None]) & (starts < inp.lim[:, None])
    lib_out = torch.where(live[..., None], lib().reshape(B, C, L) * runner.scales, 0.0)
    say("times", f"embedding_bag (one bag per document and cell) vs fused_segment: max abs "
        f"err {float((lib_out - got).abs().max()):.3g}")

    # Bound: compulsory bytes (the inputs of fused_compulsory_inputs, the
    # table rows touched, scales; the owned cells of the output written
    # once) over the memory rate, against one multiply-add per distinct
    # (document, cell, row) and language over the f32 rate.
    _, _, in_bytes, touched = fused_compulsory_inputs(torch, SF, inp, lay)
    triples = distinct_rows(torch, SF, inp, lay, cell)[0]
    owned = int(live.sum())
    total_bytes = (in_bytes + touched * L * runner.table.element_size() + L * 4
                   + owned * L * 4)
    say("times", f"fused_segment: {int(mask.sum())} counted windows, {triples} distinct "
        f"(doc, cell, row) triples, {touched} table rows touched, {owned} of {B * C} cells "
        f"owned ({owned * L * 4 / 1e6:.1f} MB of a {B * C * L * 4 / 1e6:.1f} MB output)")
    return _kernel_entry(
        "fused_segment", "fused_segment.cu",
        "spark_languagedetector_tpu/ops/score_fused.py:509", launches, max(errs, err),
        ms, plain_ms, total_bytes, 2 * triples * L, library_ms)


def phase_segment3(torch, dev, model3) -> None:
    """The non-fused route: the config-3 model (hybrid, cuckoo membership)
    segments a smaller code-switched corpus through the gather cell scorer
    and matches the host float64 oracle. No kernel runs on this route."""
    from spark_languagedetector_tpu_torch import Table
    from spark_languagedetector_tpu_torch.api.runner import SEGMENT_CELL
    from spark_languagedetector_tpu_torch.ops.score import window_scores_numpy

    langs = list(model3.profile.languages)
    cs_docs, truth = make_codeswitch_corpus(langs, 60, seed=29)
    texts = cs_docs + make_corpus(langs[:1], 1, mean_len=20000, seed=5)[0] + ["", "\x01"]
    byte_docs = [t.encode() for t in texts]
    seg = model3.copy({"resultMode": "segment"})
    runner = seg.runner
    if runner.strategy != "hybrid":
        fail(f"config 3 should segment from a hybrid runner, got {runner.strategy!r}")
    reset_launches()
    t0 = time.perf_counter()
    results = [json.loads(v) for v in
               seg.transform(Table({"fulltext": texts})).column("lang").tolist()]
    torch.cuda.synchronize()
    seg_s = time.perf_counter() - t0
    launches = read_launches()
    if any(launches.values()):
        fail(f"the gather cell route launched a kernel: {launches}")
    cells, _ = runner.segment_cells(byte_docs)
    w, sorted_ids = model3.profile.host_arrays()
    oracle = window_scores_numpy(byte_docs, w, sorted_ids, model3.profile.spec, SEGMENT_CELL)
    err = check_cells("config-3 gather cells vs host f64", cells, oracle, CELL_ATOL, RTOL)
    f1 = macro_span_f1(truth, results, [len(d) for d in byte_docs])
    say("segment3", f"config 3 ({len(langs)} languages, strategy={runner.strategy}) segmented "
        f"{len(texts)} docs through window_scores_batch_cuckoo in {seg_s:.2f}s (first call; "
        f"uncalibrated): cells max abs err {err:.3g} vs window_scores_numpy (atol {CELL_ATOL}); "
        f"byte-span macro F1 {f1:.4f}")
    if f1 < SPAN_F1_GATE:
        fail(f"config-3 segmentation span F1 {f1:.4f} below the gate {SPAN_F1_GATE}")


# --------------------------------------------------- device fit, persistence --
@contextlib.contextmanager
def phase_clock(name: str):
    """Print the phase's seconds on the host clock when it ends."""
    t0 = time.perf_counter()
    yield
    say(name, f"phase took {time.perf_counter() - t0:.1f}s")


@contextlib.contextmanager
def walls_of(torch, module, names, walls: dict):
    """Wrap ``module.<name>`` for each name so its calls add their host-clock
    seconds (card synchronized at both ends) to ``walls[name]``."""
    def timed(name, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
        return call

    with contextlib.ExitStack() as stack:
        for name in names:
            stack.enter_context(swapped(module, name, timed(name, getattr(module, name))))
        yield


def device_fit(torch, what: str, case: FitCase, kernels, smi_line: str):
    """``fitBackend='device'`` on the card for ``case``'s estimator and table:
    the profile must equal the host fit's bit for bit; then the fitted model
    transforms ``case.texts`` through ``kernels``, labels identical to the
    host-fitted model's."""
    from spark_languagedetector_tpu_torch import Table
    from spark_languagedetector_tpu_torch.ops import fit as fit_ops
    from spark_languagedetector_tpu_torch.ops import fit_tpu as FT

    det = case.det.copy({"fitBackend": "device"})
    runs = []
    for _ in range(2):  # the first call in the process, then a warm one
        walls: dict[str, float] = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with walls_of(torch, FT, ("accumulate_counts", "finalize_counts"), walls), \
                walls_of(torch, fit_ops, ("extract_gram_counts",), walls):
            t0 = time.perf_counter()
            model = det.fit(case.table)
            torch.cuda.synchronize()
            walls["fit"] = time.perf_counter() - t0
        runs.append(walls)
        p, h = model.profile, case.model.profile
        if not (p.spec == h.spec and np.array_equal(p.ids, h.ids)
                and np.array_equal(p.weights, h.weights)):
            fail(f"{what}: the device fit's profile differs from the host fit's "
                 f"({len(p.ids)} vs {len(h.ids)} grams)")
    peak = torch.cuda.max_memory_allocated()
    # The host fit once more, warm like the device fit's second call.
    t0 = time.perf_counter()
    case.det.fit(case.table)
    host_warm_s = time.perf_counter() - t0
    spec = p.spec
    if spec.mode == "exact" and max(spec.gram_lengths) > 3:
        from spark_languagedetector_tpu_torch.ops.vocab import VocabSpec

        spec = VocabSpec("exact", tuple(n for n in spec.gram_lengths if n <= 3))
    V, L = spec.id_space_size, len(p.languages)
    blocked = V * L > FT.TOPK_SORT_BUDGET_ELEMS
    def split(w):
        host_half = (f", host long-gram count {w['extract_gram_counts']:.3f}s"
                     if "extract_gram_counts" in w else "")
        return (f"{w['fit']:.3f}s (count {w['accumulate_counts']:.3f}s, finalize "
                f"{w['finalize_counts']:.3f}s {'blocked' if blocked else 'naive'}"
                f"{host_half})")

    say(what, f"device fit of {case.table.num_rows} docs on the card: first call "
        f"{split(runs[0])}, warm {split(runs[1])}; host fit first call "
        f"{case.host_fit_s:.2f}s, warm {host_warm_s:.2f}s; "
        f"count table {V} x {L} int32 = {V * L * 4 / 1e9:.3f} GB; peak device memory "
        f"{peak / 1e9:.2f} GB (warm fit); card {smi_line}")
    say(what, f"profile bit-identical to the host fit, both fits: {len(p.ids)} grams, "
        "ids and float64 weights")
    reset_launches()
    t0 = time.perf_counter()
    pred = model.transform(Table({"fulltext": case.texts})).column("lang").tolist()
    torch.cuda.synchronize()
    launches = read_launches()
    if any(launches[k] <= 0 for k in kernels):
        fail(f"{what}: the device-fitted model's transform launched {launches}, "
             f"expected {kernels}")
    idx = {l: i for i, l in enumerate(p.languages)}
    if not np.array_equal(np.asarray([idx[l] for l in pred]), case.ids):
        fail(f"{what}: the device-fitted model's labels differ from the host-fitted model's")
    say(what, f"transform {len(case.texts)} docs: {time.perf_counter() - t0:.2f}s, launches "
        f"{launches}; labels identical to the host-fitted model's")
    return model


def plateau_topk(torch, dev) -> None:
    """A parity count table whose tie plateaus cross the finalize's block
    boundaries (three blocks of 2^21 rows, the last sliding back): the
    card's ``top_k_rows``, ``top_k_rows_blocked`` and
    ``finalize_topk_blocked`` must give numpy's (value desc, id asc) top-k."""
    from spark_languagedetector_tpu_torch.ops import fit_tpu as FT

    rng = np.random.default_rng(31)
    block, L, k = FT.TOPK_BLOCK, 6, 1000
    V = 2 * block + 12345
    counts = np.zeros((V, L), np.int32)
    for l in range(L):
        # 200 grams only this language saw (the top weight), a plateau of
        # about 1,500 shared with the next language around a block boundary
        # (about 350 below it), and sparse noise seen by 3-6 languages.
        counts[rng.choice(V, 200, replace=False), l] = 1
        b = block * (1 + l % 2)
        plateau = np.arange(b - 350, b + 1150)
        counts[plateau, l] += 2
        counts[plateau, (l + 1) % L] += 1
    noise = rng.choice(V, 20000, replace=False)
    counts[noise] += (rng.random((len(noise), L)) < 0.7).astype(np.int32)
    present = counts > 0
    n = present.sum(axis=1, keepdims=True)
    occurred = n[:, 0] > 0
    w = np.where(present, np.log1p(1.0 / np.maximum(n, 1)), 0.0)
    w[~occurred] = -np.inf
    ids = np.arange(V)
    want = [np.lexsort((ids, -w[:, l]))[:k] for l in range(L)]
    crossing = sum(int((r < block).any() and (r >= block).any()) for r in want)
    t = torch.from_numpy(counts).to(dev)
    masked = FT.masked_candidate_weights(t, weight_mode="parity")
    got = {
        "top_k_rows": FT.top_k_rows(masked, k=k),
        "top_k_rows_blocked": FT.top_k_rows_blocked(masked, k=k, block=block),
        "finalize_topk_blocked": FT.finalize_topk_blocked(t, weight_mode="parity", k=k),
    }
    for name, rows in got.items():
        rows = rows.cpu().numpy()
        for l in range(L):
            order = sorted(rows[l].tolist(), key=lambda i: (-w[i, l], i))
            if order != want[l].tolist():
                fail(f"plateau table: {name} differs from numpy's (value desc, id asc) "
                     f"top-{k} for language {l}")
    say("fit3", f"plateau table {V} x {L} (block {block}, tail sliding back), k = {k}: "
        f"{', '.join(got)} equal numpy's (value desc, id asc) order; {crossing}/{L} "
        "languages' winners span a block boundary")


def fit_at_scale(torch, case: FitCase, factor: int, smi_line: str) -> None:
    """Config 5's device and host fits, both warm, on a training corpus
    ``factor`` times phase 4's (fresh documents, seed 4), where the count
    pass, the part that grows with training data, carries weight beside
    the finalize; the profiles must be bit-identical."""
    from spark_languagedetector_tpu_torch import Table
    from spark_languagedetector_tpu_torch.ops import fit_tpu as FT

    langs = list(case.model.profile.languages)
    t0 = time.perf_counter()
    train, labels = make_corpus(langs, factor * case.table.num_rows, seed=4)
    table = Table({"lang": labels, "fulltext": train})
    make_s = time.perf_counter() - t0
    walls: dict[str, float] = {}
    with walls_of(torch, FT, ("accumulate_counts", "finalize_counts"), walls):
        t0 = time.perf_counter()
        dev_model = case.det.copy({"fitBackend": "device"}).fit(table)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_model = case.det.fit(table)
    host_s = time.perf_counter() - t0
    p, h = dev_model.profile, host_model.profile
    if not (np.array_equal(p.ids, h.ids) and np.array_equal(p.weights, h.weights)):
        fail(f"fit5 x{factor}: the device fit's profile differs from the host fit's")
    say("fit5", f"x{factor} corpus: {len(train)} docs ({sum(map(len, train)) / 1e6:.2f} MB, "
        f"made in {make_s:.1f}s): device fit {dev_s:.3f}s (count "
        f"{walls['accumulate_counts']:.3f}s, finalize {walls['finalize_counts']:.3f}s), "
        f"host fit {host_s:.2f}s, both warm; profiles bit-identical ({len(p.ids)} grams); "
        f"card {smi_line}")


def phase_fit5(torch, dev, case: FitCase, smi_line: str):
    """Config 5 through ``fitBackend='device'``: the naive finalize over the
    0.74 GB count table; then both fits on an eight-fold corpus."""
    model = device_fit(torch, "fit5", case, ("fused_detect",), smi_line)
    fit_at_scale(torch, case, 8, smi_line)
    return model


def phase_fit3(torch, dev, case: FitCase, smi_line: str) -> None:
    """Config 3 through ``fitBackend='device'``: the split fit, lengths 1..3
    on the card (the blocked finalize over a 3.37 GB table), 4..5 on the
    host; then the plateau table."""
    device_fit(torch, "fit3", case, ("row_hist", "bigram_hist"), smi_line)
    plateau_topk(torch, dev)


def reload_check(torch, what: str, before, after, docs, table_texts, kernel: str) -> None:
    """``after`` (a reloaded model) must stay on the card and give ``before``'s
    f32 scores bit for bit and its labels through ``transform``."""
    from spark_languagedetector_tpu_torch import Table

    if after.runner.device.type != "cuda":
        fail(f"persist {what}: the reloaded model runs on {after.runner.device}")
    if not np.array_equal(after.runner.score(docs), before.runner.score(docs)):
        fail(f"persist {what}: reloaded f32 scores differ from the saved model's")
    reset_launches()
    labels = after.transform(Table({"fulltext": table_texts})).column("lang").tolist()
    launches = read_launches()
    if launches[kernel] <= 0:
        fail(f"persist {what}: the reloaded model's transform never launched {kernel}")
    if labels != before.transform(Table({"fulltext": table_texts})).column("lang").tolist():
        fail(f"persist {what}: reloaded labels differ from the saved model's")


def phase_persist(torch, dev, model5, texts5, model3, texts3) -> None:
    """Save and load on the card: the config-5 model (native float64, and
    int8-quantized), the calibrated segment model of phase 9, and the
    config-3 model in the reference (Spark) layout. Every reload stays on
    the card and gives the saved model's scores and labels."""
    try:
        import pyarrow  # noqa: F401
    except ImportError as e:
        say("persist", f"not run: pyarrow cannot be imported on this machine ({e}); "
            "persistence is held by the CPU tests only")
        return
    import shutil

    from spark_languagedetector_tpu_torch import LanguageDetectorModel
    from spark_languagedetector_tpu_torch.api.runner import SEGMENT_CELL

    out = ROOT / "build" / "persist_smoke"
    shutil.rmtree(out, ignore_errors=True)
    sample5, sample3 = texts5[:2000], texts3[:2000]
    docs5, docs3 = [t.encode() for t in sample5], [t.encode() for t in sample3]
    try:
        # 1. Native float64, uncalibrated, saved from a CPU session: the
        # device is the session's, so the reload (no device named) runs on
        # the card.
        plain = model5.copy()
        plain.calibration = None
        t0 = time.perf_counter()
        plain.copy({"device": "cpu"}).write().save(str(out / "c5"))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = LanguageDetectorModel.load(str(out / "c5"))
        load_s = time.perf_counter() - t0
        if loaded.calibration is not None:
            fail("persist: an uncalibrated model came back calibrated")
        reload_check(torch, "config 5", plain, loaded, docs5, sample5, "fused_detect")
        size = sum(f.stat().st_size for f in (out / "c5").rglob("*") if f.is_file())
        say("persist", f"config 5 native f64 ({model5.profile.num_grams} rows, "
            f"{size / 1e6:.1f} MB on disk): save {save_s:.2f}s, load {load_s:.2f}s; "
            f"scores of {len(docs5)} docs and labels identical on the card")
        # 2. int8: the reloaded q * scale requantizes to the saved integers.
        model5.write().quantized("int8").save(str(out / "c5_int8"))
        q_before = model5.copy({"quantization": "int8"})
        q_after = LanguageDetectorModel.load(str(out / "c5_int8")).copy({"quantization": "int8"})
        reload_check(torch, "config 5 int8", q_before, q_after, docs5, sample5, "fused_detect")
        size = sum(f.stat().st_size for f in (out / "c5_int8").rglob("*") if f.is_file())
        say("persist", f"config 5 int8 ({size / 1e6:.1f} MB on disk): fused int8 scores and "
            "labels identical to the pre-save int8 model's")
        # 3. The calibrated segment model.
        seg_before = model5.copy({"resultMode": "segment"})
        seg_before.calibration = model5.calibration
        seg_before.write().save(str(out / "c5_seg"))
        seg_after = LanguageDetectorModel.load(str(out / "c5_seg"))
        cal = seg_after.calibration
        if cal is None or not cal.calibrated or cal.to_dict() != model5.calibration.to_dict():
            fail("persist: the calibrated model lost or changed its calibration")
        cs = [t.encode() for t in make_codeswitch_corpus(list(model5.profile.languages), 60,
                                                         seed=41)[0]]
        reset_launches()
        cells_after, _ = seg_after.runner.segment_cells(cs, cell=SEGMENT_CELL)
        if read_launches()["fused_segment"] <= 0:
            fail("persist: the reloaded segment model never launched fused_segment")
        cells_before, _ = seg_before.runner.segment_cells(cs, cell=SEGMENT_CELL)
        if not all(np.array_equal(a, b) for a, b in zip(cells_after, cells_before)):
            fail("persist: the reloaded segment model's per-cell scores differ")
        seg_texts = [d.decode() for d in cs]
        from spark_languagedetector_tpu_torch import Table

        res_after = seg_after.transform(Table({"fulltext": seg_texts})).column("lang").tolist()
        res_before = seg_before.transform(Table({"fulltext": seg_texts})).column("lang").tolist()
        if res_after != res_before or not all(json.loads(r)["calibrated"] for r in res_after):
            fail("persist: the reloaded segment model's results differ or lost calibrated: true")
        say("persist", f"calibrated segment model: calibration identical, per-cell scores of "
            f"{len(cs)} code-switched docs bit-identical, segment JSON identical "
            "(calibrated: true)")
        # 4. Config 3 in the reference layout.
        model3.write().reference_layout().save(str(out / "c3_ref"))
        meta = json.loads((out / "c3_ref" / "metadata" / "part-00000").read_text())
        ref3 = LanguageDetectorModel.load(str(out / "c3_ref"), device=str(dev))
        reload_check(torch, "config 3 reference layout", model3, ref3, docs3, sample3,
                     "row_hist")
        say("persist", f"config 3 reference layout ({meta['class']}): scores of "
            f"{len(docs3)} docs and labels identical on the card (hybrid)")
    finally:
        shutil.rmtree(out, ignore_errors=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="stop after the kernel checks (phases 1-3)")
    ap.add_argument("--baseline", type=Path, metavar="DIR", action="append", default=[],
                    help="another version's checkout, or its csrc/ directory: every kernel "
                    "whose source it holds (same C entry point) is built from it and timed "
                    "in turns with this checkout's; repeatable")
    args = ap.parse_args()

    if not (ROOT / "spark_languagedetector_tpu_torch" / "__init__.py").is_file():
        fail("the spark_languagedetector_tpu_torch package is not beside this script")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs the CUDA card")
    import spark_languagedetector_tpu_torch as port
    from spark_languagedetector_tpu_torch.ops._kernels import KERNELS

    if Path(port.__file__).resolve().parent.parent != ROOT:
        fail(f"imported the port from {port.__file__}, not from this checkout")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi_line = phase_device(torch)
    from spark_languagedetector_tpu_torch.ops._kernels import CudaKernel

    baselines = []
    for i, base in enumerate(args.baseline):
        csrc = base / "spark_languagedetector_tpu_torch" / "csrc"
        csrc = csrc if csrc.is_dir() else base
        builds = {k.name: CudaKernel(f"baseline{i}_{k.name}",
                                     str((csrc / k.source.name).resolve()), k.symbol,
                                     k.argtypes, k.restype)
                  for k in KERNELS if (csrc / k.source.name).is_file()}
        if not builds:
            fail(f"--baseline {base}: no kernel source there")
        baselines.append((base.resolve().name, builds))
    phase_build(KERNELS + tuple(k for _, builds in baselines for k in builds.values()))
    kernel_err = phase_kernels(torch, dev)
    hist_errs = phase_kernels_hist(torch, dev)
    segment_err = phase_kernels_segment(torch, dev)
    if args.quick:
        say("done", f"quick run ok in {time.perf_counter() - t_start:.1f}s")
        return
    with phase_clock("main"):
        (model, runner, quant_runners, main_docs, main_ids, eval_docs, launches,
         fit5_case) = phase_main(torch, dev)
    with phase_clock("times"):
        c5_err, times, c5_inp = phase_times(torch, dev, model, runner, quant_runners,
                                            eval_docs, baselines)
    with phase_clock("config3"):
        model3, runner3, eval3, launches3, fit3_case = phase_config3(torch, dev)
    with phase_clock("kernel5"):
        runner10, launches10 = phase_kernel5(torch, dev)
    with phase_clock("times"):
        hist_entries = phase_times_hist(torch, dev, model3, runner3, runner10, eval3,
                                        launches3, launches10, hist_errs, baselines)
    with phase_clock("segment"):
        seg_launches, seg_path_err = phase_segment(torch, dev, model, main_ids, main_docs)
        segment_entry = phase_times_segment(torch, dev, runner, quant_runners, c5_inp,
                                            seg_launches, max(segment_err, seg_path_err),
                                            baselines)
    with phase_clock("segment3"):
        phase_segment3(torch, dev, model3)
    with phase_clock("fit5"):
        phase_fit5(torch, dev, fit5_case, smi_line)
    with phase_clock("fit3"):
        phase_fit3(torch, dev, fit3_case, smi_line)
    with phase_clock("persist"):
        phase_persist(torch, dev, model, main_docs, model3, fit3_case.texts)
    bad = [k for k in ("jax", "jaxlib", "spark_languagedetector_tpu") if k in sys.modules]
    if bad:
        fail(f"JAX modules were imported: {bad}")
    say("done", f"all phases ok in {time.perf_counter() - t_start:.1f}s")
    print(smi_line)
    print(json.dumps({"kernels": [{
        "name": "fused_detect",
        "route": "cuda",
        "source": "spark_languagedetector_tpu_torch/csrc/fused_detect.cu",
        "replaces": "spark_languagedetector_tpu/ops/score_fused.py:308",
        "launches": launches,
        "max_abs_err": max(kernel_err, c5_err),
        **times,
    }, segment_entry] + hist_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
