#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``spark_languagedetector_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py           # every phase; the last line is the verdict
    python3 chip_smoke.py --quick   # phases 1-3 only (build + kernel checks)

Phases, one line or more each; any failure exits non-zero before the verdict:

1. device   — ``nvidia-smi`` name and power limit, torch's view of the card;
2. build    — every kernel of the path compiled with nvcc from ``csrc/``;
3. kernels  — each kernel held against its plain PyTorch version on the card
   (five table layouts x {f32, int16, int8} x {score, detect}, edge
   documents, window limits, a wide-L case);
4. main     — ``LanguageDetector.fit`` → ``LanguageDetectorModel.transform``
   at the 176-language hashed config (gram lengths 1..5, 2^20 buckets,
   profile size 400; the JAX package's ``bench.py`` config 5) on the same
   synthetic corpus, checked against the plain version on the card and the
   host float64 scorer, then again with int16 and int8 tables;
5. times    — the kernel, its plain version and ``embedding_bag`` at the
   runner's largest config-5 batch (CUDA events), the kernel's lower bound,
   and end-to-end transform docs/s.

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


# ------------------------------------------------------------- helpers -----


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call on the card (CUDA events around ``reps``
    back-to-back calls, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def compare_kernel(torch, SF, inp, wq, scales, layout, what: str) -> tuple[float, int]:
    """Kernel vs plain version on the same device inputs, both variants.
    Returns (max abs score error, near-tie label flips)."""
    got = SF.fused_kernel(inp, wq, scales, layout, want_labels=False)
    labels, best = SF.fused_kernel(inp, wq, scales, layout, want_labels=True)
    torch.cuda.synchronize()
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


def phase_kernels(torch, dev) -> float:
    from spark_languagedetector_tpu_torch.ops import score_fused as SF
    from spark_languagedetector_tpu_torch.ops.encoding import pad_batch
    from spark_languagedetector_tpu_torch.ops.vocab import VocabSpec

    max_err = 0.0
    rng = np.random.default_rng(7)
    pad = 256
    for L in (6, 1100):  # one column per thread, and two
        for name, spec, w, lut in _layout_cases(VocabSpec, L, seed=L):
            if L > 6 and name != "dense_exact_bigram":
                continue
            docs, lim = _edge_batch(rng, 11, pad)
            batch, lengths = pad_batch(docs, pad)
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
                    what = f"{name} L={L} {quant or 'f32'} limit={'yes' if limit is not None else 'no'}"
                    err, flips = compare_kernel(torch, SF, inp, wq, scales, ft.layout, what)
                    max_err = max(max_err, err)
                    say("kernels", f"{what}: max abs err {err:.3g}, near-tie label flips {flips}")
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


@contextlib.contextmanager
def plain_version(SF):
    """Route the fused wrapper's CUDA branch to the plain PyTorch version, so
    the runner's whole path (plan, chunking, argmax) runs unchanged on the
    same device with the kernel swapped out."""
    real = SF.fused_kernel
    SF.fused_kernel = SF.fused_plain
    try:
        yield
    finally:
        SF.fused_kernel = real


def phase_main(torch, dev):
    from spark_languagedetector_tpu_torch import LanguageDetector, Table
    from spark_languagedetector_tpu_torch.ops import score_fused as SF
    from spark_languagedetector_tpu_torch.ops.score import score_batch_numpy

    langs = language_names(176)
    train, train_labels = make_corpus(langs, 30 * len(langs), seed=1)
    t0 = time.perf_counter()
    det = (LanguageDetector(langs, [1, 2, 3, 4, 5], 400, device=str(dev))
           .set_vocab_mode("hashed").set_hash_bits(20))
    model = det.fit(Table({"lang": train_labels, "fulltext": train}))
    p = model.profile
    say("main", f"fit {len(train)} docs ({sum(map(len, train)) / 1e6:.2f} MB) in "
        f"{time.perf_counter() - t0:.1f}s: {p.num_grams} grams, {p.spec}")

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

    SF.FUSED_DETECT.launches = 0
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
    return model, runner, quant_runners, eval_docs, launches


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


def phase_times(torch, dev, model, runner, quant_runners, eval_docs):
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

    ms = cuda_ms(torch, kernel, reps=20)
    score_ms = cuda_ms(torch, lambda: kernel(labels=False), reps=20)
    plain_ms = cuda_ms(torch, lambda: SF.fused_plain(
        inp, runner.table, runner.scales, lay, want_labels=True), reps=3, warmup=1)
    q_ms = {q: cuda_ms(torch, lambda r=r: kernel(r), reps=20) for q, r in quant_runners.items()}

    pairs = list(SF.window_rows(inp, lay))
    rows = torch.cat([r for r, _ in pairs], dim=1)
    mask = torch.cat([m for _, m in pairs], dim=1)
    weights = mask.to(torch.float32)
    lib = lambda: torch.nn.functional.embedding_bag(  # noqa: E731
        rows, runner.table, mode="sum", per_sample_weights=weights)
    library_ms = cuda_ms(torch, lib, reps=5, warmup=1)
    lib_err = float((lib() - kernel(labels=False)).abs().max())
    say("times", f"embedding_bag vs kernel scores: max abs err {lib_err:.3g}")

    # Lower bound: the larger of compulsory bytes (each input read once:
    # byte plane, rows plane, per-doc vectors, the table rows this batch
    # touches, scales; labels + best written once) over HBM bandwidth, and
    # the f32 operations the function needs over the f32 rate. A document's
    # score is the sum over its distinct rows of count x w[row], so it needs
    # one multiply-add (2 operations) per distinct (document, row) pair and
    # language, however often the gram repeats.
    valid = int(mask.sum())
    touched = int(torch.unique(rows[mask]).numel())
    doc = torch.arange(B, device=rows.device)[:, None].expand_as(rows)
    pairs = int(torch.unique((doc * lay.rows + rows)[mask]).numel())
    itemsize = runner.table.element_size()
    in_bytes = sum(t.numel() * t.element_size() for t in inp if t is not None)
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
                        bound_by=bound_by, library_ms=library_ms)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="stop after the kernel checks (phases 1-3)")
    args = ap.parse_args()

    if not (ROOT / "spark_languagedetector_tpu_torch" / "__init__.py").is_file():
        fail("the spark_languagedetector_tpu_torch package is not beside this script")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs the CUDA card")
    import spark_languagedetector_tpu_torch as port
    from spark_languagedetector_tpu_torch.ops import score_fused as SF

    if Path(port.__file__).resolve().parent.parent != ROOT:
        fail(f"imported the port from {port.__file__}, not from this checkout")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi_line = phase_device(torch)
    phase_build([SF.FUSED_DETECT])
    kernel_err = phase_kernels(torch, dev)
    if args.quick:
        say("done", f"quick run ok in {time.perf_counter() - t_start:.1f}s")
        return
    model, runner, quant_runners, eval_docs, launches = phase_main(torch, dev)
    c5_err, times = phase_times(torch, dev, model, runner, quant_runners, eval_docs)
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
