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
14. runner   — the execution layer on the card, with the config-5 and config-3
   models of phases 4 and 6: config 5's 6,004 documents give the same f32
   scores and labels, bit for bit, whatever the transfer form (ragged where
   smaller, padded, the raw wire form), input lane (list, ``DocBlock``) and
   number of dispatch workers (1, 2), and phase 4's labels; the same again
   with a spin kernel queued ahead of every host-to-device copy, one
   pinned buffer per size class and 256-row batches, so a buffer handed out
   again before its copy ran would corrupt a batch; 2,000 repeated documents added, dedup on
   equals dedup off (bit-exact at config 5; labels identical, scores in the
   reduction-order class at config 3); fault plans on the card: a dispatch
   fault at configs 5 and 3 (kernel paths) replays, and with one attempt
   propagates with no degraded rung; a fetch fault replays; on a
   ``strategy="gather"`` runner (no kernel) a dispatch fault and a
   wire-build fault take the ladder's host rung, bit for bit the gather
   scorer on the CPU, with the breaker opening and closing again on a fake
   clock; a swapped kernel launch raising ``KernelLaunchError`` propagates
   with no retry and no rung; a clean transform afterwards counts no retry,
   no degraded batch and no breaker short-circuit. Then, claiming nothing:
   warm docs/s over three runs, the device's busy share, the H2D bytes per
   document of each form and the ``score/pack``/``dispatch``/``fetch`` wall
   split read from the telemetry registry.
15. serve    — online serving on the card. ``fused_detect`` scores 64
   documents alone, in a batch of 64 and in the 4,096-row batch bit for
   bit. A copy of the config-5 model is installed in a ``ModelRegistry``
   behind ``ServingServer(port=0)`` (batcher ``max_wait_ms=5,
   max_rows=256``); eight ``ServeClient`` threads send 16 rounds of 8
   evaluation documents each, mixing /score, /detect and
   /detect?mode=segment, while one client swaps over /admin/swap to a
   config-5 model refitted with profile size 300 and saved to disk, then
   rolls back. Every answer equals the direct runner of the version that
   served it, bit for bit; none is dropped; dispatches coalesce requests;
   ``fused_detect`` and ``fused_segment`` launch; device memory after the
   two swaps is back within one staging ring of before. Then a short
   profiled run (the device's busy share) and a burst of 32 concurrent
   bulk requests against ``max_queue_rows=16`` (answered or shed with 503,
   at least one shed). Config 3 (hybrid) runs the shorter form (four
   clients, eight rounds, the burst): ``row_hist`` and ``bigram_hist``
   launch, answers equal the direct runner bit for bit or, where the f64
   matmul's order moved, in the JAX package's matmul-strategy class
   (labels and spans exact, scores ``rtol=1e-4, atol=1e-5``; said so).
   Printed: requests/s and docs/s under load, ``serve/total_s`` p50/p99,
   ``serve/queue_wait_s`` p99, the swap's and rollback's milliseconds.
16. stream   — bench config 4 (10 languages, exact n = 1..3, profile 3,000,
   fitted on 60 documents per language; auto → fused) through
   ``stream.run_stream`` over 10,000 evaluation documents of ~1.5 KB in
   8,192-row ``memory_source`` batches: with prefetch 0 x 1 worker and
   prefetch 6 x 4 workers the sink sees every row once in source order,
   labels bit for bit ``model.transform``'s (which hold against the plain
   version on the card outside near-ties), ``fused_detect`` launched. Four
   workers share the runner with a spin kernel queued ahead of every H2D
   copy, one pinned buffer per size class and 64-row runner batches
   (1,024-row source batches): labels bit for bit one worker's, and a take
   waited on a pending copy (up to three runs until one has). The JAX chaos smoke's plan
   (``seed=7;stream/batch:error@2;score/dispatch:error@6;
   stream/batch:poison=2@3``, 1,024-row batches, 4 workers) with a
   ``DeadLetterQueue``: the healthy rows' labels equal the fault-free run's,
   the DLQ holds exactly the poisoned rows (batch 2, their row indices),
   ``stream/retries`` >= 1, no degraded batch. A ``checkpoint_path`` run
   cut at ``max_batches=1``, then rerun: ``resumed_from == 1``, the corpus
   sunk once. Printed, claiming nothing: rows/s over three runs, per-batch
   latency p50/p95 and the device's busy share.
17. refit    — the continuous-learning loop at config 5: phase 4's 5,280
   training documents as 12 labeled batches of 440 into ``AutoRefit``
   (the accumulator is the 0.738 GB int32 [2^20, 176] table on the card,
   a fit-state checkpoint after every batch); run 1 refits every 2
   batches and stops after 6 (the kill; its saved state reads back as the
   accumulator's rows), run 2 resumes on the same state (``resumed_from ==
   6``), refits every 4 and at the end. The served profile is bit-identical
   to phase 11's device fit and phase 4's host fit, the served version's
   ``refit_token`` is 12, ``fit/collect_bytes`` per finalize is under half
   the table, the served runner answers phase 4's documents through
   ``fused_detect`` bit for bit the from-scratch model's runner, retired
   versions released their runners, and device memory after the last swap
   is within one staging ring of (before + the table). Printed: update,
   finalize, checkpoint and swap times, and the peak device memory.
18. fleet    — ``ServeFleet.from_path`` of phase 4's model (saved) with three
   replicas sharing one model and runner behind ``RouterServer`` (probes
   every 40 ms on a pausable thread, breaker threshold 2, cooldown 0.3 s,
   quarantine off; batchers ``max_wait_ms=4, max_rows=256,
   max_queue_rows=1024``) and a ``FleetCollector``: six clients x 14 rounds
   x 8 config-5 documents, /detect, /score and /detect?mode=segment by
   (client + round) mod 3; at round 2 r0 is killed and that client sends
   until a failover, at round 7 r0 is revived and re-admitted, at round 11
   an /admin/swap to a profile-300 refit, then an /admin/rollback. Gates:
   nothing dropped, every answer bit for bit the direct runner of the
   version that served it, at least one failover, ejection and
   re-admission, both versions served and no client seeing v1 after its
   first v2, ``fused_detect`` and ``fused_segment`` launched, one runner
   build per distinct model per swap and rollback, the live CUDA tensor
   bytes after the swap exactly before - table A + table B and after the
   rollback exactly before, the collector's merged ``serve/requests`` the
   sum of the replicas' scrapes. Printed, claiming nothing: requests/s,
   docs/s, ``fleet/request_s`` p50/p99, swap and rollback ms, the busy
   share and each dispatcher thread's busy share; then the same clients
   with no kill and no swap on uncached documents, in turns: through the
   router, to replica r0 alone, through the router again (requests/s and
   dispatcher busy shares; every answer bit for bit).
19. storm    — the JAX bench's storm drill at config 5 on three replicas
   behind the router's HTTP front, manual probes: a query of death
   (``QuarantineTable(2)``) quarantined after exactly two deaths, its third
   send a 422 before any dispatch and in the serve DLQ, a control batch
   answered, a request under the deadline floor a 504; an outage under
   ``RetryBudget(burst=1)`` (one failover granted, the next denied,
   dispatches within offered x (1 + fraction) + burst); a seeded 0.4 s
   straggler plan with hedging off then on (the hedged p99 lower); overload
   with a drained budget (no hedge, each request answered or shed with
   Retry-After). Every answer the direct runner's labels.
20. zoo      — twelve tenants (and ``noisy``, ``TenantQuota(max_queue_rows=8)``)
   at the config-5 spec, each device-fitted on its own seeded 60% of phase
   4's training documents (f32 scores pairwise distinct), behind
   ``ServingServer(ModelZoo(resident_bytes = 3 tenants' tables))``: six
   clients x 16 rounds x 8 documents to seeded tenants, /score and /detect;
   at round 5 five 48-document bulk requests to ``noisy``, at round 13
   ``zoo.auto_refit("t00")`` over four batches of 440 documents. Gates:
   every answer its own tenant's direct runner for the version that
   answered and no /score answer another tenant's, no cross-tenant reject,
   evictions and cold reloads, no busy tenant evicted, the burst shedding
   ``noisy`` only, the refit moving t00 alone to a profile bit for bit a
   from-scratch device fit, ``zoo/resident_bytes`` equal to the live CUDA
   tensor bytes the zoo holds, and none left after ``zoo.close()``.
   Printed: ``zoo/cold_load_s`` p50/p99, evictions, requests/s, busy share.
21. observe  — the telemetry's read side, device gauges, cost model, profiler
   trace, shape tuner and NaN checks on the models of phases 4 and 6. A fresh
   runner of each transforms its phase's documents with a JSONL capture,
   ``LANGDETECT_TRACE_DIR`` and ``LANGDETECT_TELEMETRY_FENCE=1``: labels bit
   for bit the phase's, a Chrome trace naming ``fused_detect`` (config 5) or
   ``row_hist`` and ``bigram_hist`` (config 3), those kernels launched, the
   ``program_flops`` and ``program_bytes_accessed`` gauges of
   ``score/dispatch`` (and ``score/fused``), ``langdetect_table_bytes`` equal
   to ``runner.table_bytes()``, and every fenced bytes and flops utilization
   in ``stage_summary()`` in (0, 1.05]. A segment transform of 60
   code-switched documents launches ``fused_segment`` with ``segment/docs``,
   ``/rejects`` and ``/spans`` equal to the results' counts.
   ``device_bytes_in_use{device="cuda:0"}`` equals ``memory_stats()``'s
   allocated bytes, and a warm ``build_all()`` counts a hit per kernel and no
   miss. Phase 11's device fit sets the ``fit/count`` cost gauges. The report
   renders the config-5 capture, ``compare`` of it against itself exits 0 and
   against a copy with its ``score/*`` spans twice as slow 1, ``stitch`` of
   the two captures writes a trace whose spans nest in their parents. Three
   replicas behind ``RouterServer(slo=SloEvaluator(...))`` with one dispatch
   attempt: a kill sheds and burns availability (``/healthz`` carries the
   reason), a revival and a clean leg clear it; time moves through
   ``ingest(now=)`` and a fake breaker clock. ``exec.tune.solve`` of the
   config-5 capture gives a profile whose runner labels phase 4's documents
   bit for bit. Under ``nan_checks()`` a weight table with a NaN raises
   ``ValueError``; outside, it builds and scores. Printed, claiming nothing:
   the roofline shares, the memory gauges, the padded bytes before and after
   tuning, and the profiler's kernel times.
22. coldstart — phase 4's model saved (parquet, f32 and the int16 codec) and
   baked twice (``artifacts.bake_model``: f32, int16). One fresh process
   (``chip_smoke.py --cold-load``) times its CUDA context, the pyarrow import
   and a warm-up (a baked load and its prewarm: the kernel libraries loaded
   and first launched) apart, then loads each model from parquet and from
   its bake, in their parts: the load (parse or map), the membership build,
   ``build_fused_tables``, the upload through pinned memory, the runner build
   they make up, ``prewarm_lattice``, then a transform of phase 4's 6,004
   docs whose labels are phase 4's and whose scores are the reference's bit
   for bit (f32: phase 4's; int16: the codec's parquet model); the baked legs
   count ``artifacts/baked_loads`` 1, the parquet ones 0. A torn copy of the
   artifact is refused (``artifacts/load_errors`` 1) and served from
   parquet. Two replica children on the card, one after the other, on an
   empty kernel build cache: the first builds (``compile_cache/misses`` >= 1,
   ``prewarm_mode`` ``full``), the second loads (``sentinel``, verified, no
   miss); both answer phase 4's labels and scores, and their ``warmup_s`` is
   printed. Phase 20's zoo traffic again with the tenants baked (no parquet
   tree): every answer its tenant's direct runner bit for bit, every cold
   load a baked one, ``zoo/cold_load_s`` beside phase 20's, the resident
   bytes the resident tenants' device tables and the live CUDA bytes exactly.
23. scale    — three ``ProcessReplica`` children on the card
   (``ReplicaSupervisor``, the bake and the build cache of phase 2) behind
   ``FleetRouter``: phase 18's no-fault traffic mix, one closed-loop window
   of ``SCALE_WINDOW_S`` seconds each through the three processes, through
   three in-process replicas (``ServeFleet``), and to one replica alone, in
   process (as phase 18 measured it) and in its own process, the score cache
   off, every answer bit for bit the direct runner; printed,
   claiming nothing (one card shows no scaling): requests/s,
   ``fleet/request_s`` p50/p99 and the card's busy share (``nvidia-smi``
   utilization over all processes). A SIGKILLed child mid-traffic: failover,
   the supervisor's restart on its pinned port, the breaker's re-admission,
   every answer bit for bit, every shed explicit. An ``ElasticFleet`` moved by
   ``Autoscaler.tick()`` only: a burst against a 32-row queue sheds, the next
   tick takes the fleet from 1 to 2 replicas, silence brings it back to 1
   under a ``scale/decision:error@3`` plan that skips exactly tick 3, no
   response dropped. The children's ``fused_detect`` and ``fused_segment``
   launches, as their wrappers counted them (the
   ``langdetect_kernel_launches`` gauge of each child's terminal snapshot in
   its JSONL capture), join the kernels line; a child that dispatched and
   launched nothing fails the phase.
24. mesh     — multi-device on the one card, in child processes started from
   this checkout (the kernel build directory is warm), so the parent's CUDA
   context and process group are untouched. First one rank on NCCL
   (``init_distributed`` with a ``file://`` rendezvous; NCCL's version
   printed), then two ranks sharing the card over gloo. Each rank: a
   config-5 device fit through ``resolve_fit_mesh()`` (phase 4's training
   corpus; the table stripes over the data axis) with phase 11's ids and
   weights; a ``device="mesh"`` transform of phase 4's 6,004 documents with
   phase 4's labels through ``fused_detect``; ``resultMode="segment"`` over
   120 code-switched documents with the single-device JSON through
   ``fused_segment``; phase 6's config-3 model (hybrid: ``row_hist``,
   ``bigram_hist``) and a 10-language exact n = 1..5 model (hybrid, its
   n <= 2 part through ``bigram_score``) with the single-device labels; ``device="mesh:vocab"``
   on a dense 2^16 x 176 table (data 1 x vocab 2 on two ranks, a striped
   gather) with the replicated gather's scores in the reduction-order
   class; a 400 KB document through ``score_long_document`` and
   ``ring_score_chunks``, equal to each other and in that class of the
   single-device sum. Each rank writes its kernels' launches
   (``langdetect_kernel_launches{kernel, stage="mesh"}``) into a terminal
   snapshot; the kernels line adds them up, and every rank must have
   launched all five kernels. Printed, claiming nothing (two ranks on one
   card measure no scaling): the sharded fit's walls against fit5's, and
   the transform's docs/s on one rank and on two.

Each phase prints its seconds. Phase 2 also builds the native packer
(``native/*.cpp`` with g++) and fails if it cannot.

It imports nothing of JAX. Without a CUDA card, or without the package
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import tempfile
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
# Spin queued ahead of each staged copy in the staging checks (phases 14
# and 16): about 20 ms, longer than packing a batch takes even on a loaded
# host (a 5 ms spin once let every copy finish before the next take), so
# an early reuse lands before the copy.
STAGING_SPIN_CYCLES = 40_000_000
# Runs of a staging check until a take has waited on a copy. A run of
# either leg has queued copies ahead of its takes unless something on the
# dispatch path drains the stream per batch (a pageable copy does: one on
# the exact-vocab path once left the stream leg 0 to 26 waits a run, and
# six runs with none), so a run without a wait is a finding.
STAGING_ATTEMPTS = 6
STAGING_BATCH = 256  # rows per batch there: many batches of one size class per call
LADDER_DOCS = 400  # documents of the ladder check (its host rung scores on the CPU)
LADDER_BATCH = 128  # rows per batch there, so the open breaker short-circuits some


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

    from spark_languagedetector_tpu_torch import native

    t0 = time.perf_counter()
    built = build_all(kernels, force=True)
    say("build", f"{len(built)} kernel(s) built in {time.perf_counter() - t0:.2f}s "
        "(one nvcc per source, in parallel)")
    t0 = time.perf_counter()
    if not native.available():
        fail("the native packer did not build (g++ on native/packer.cpp, refscorer.cpp); "
             "the numpy packers would serve in its place")
    say("build", f"native packer {native.library_path().name} ready in "
        f"{time.perf_counter() - t0:.2f}s")
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
        return None
    busy_ms = sum(r[1] for r in rows)
    say("profile", f"device busy {busy_ms:.2f} ms of a {wall_ms:.1f} ms warm call "
        f"(unprofiled wall) = {busy_ms / wall_ms:.1%} busy, "
        f"{1 - busy_ms / wall_ms:.1%} idle")
    for key, ms, count in rows[:top]:
        say("profile", f"  {ms:8.3f} ms  {count:5d}x  {key[:90]}")
    return busy_ms


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
    """Wrap ``module.<name>`` (a module or a class) for each name so each
    call appends its host-clock seconds (card synchronized at both ends) to
    ``walls[name]``."""
    def timed(name, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                walls.setdefault(name, []).append(time.perf_counter() - t0)
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
    from spark_languagedetector_tpu_torch.ops import fit_tpu as FT

    det = case.det.copy({"fitBackend": "device"})
    runs = []
    for _ in range(2):  # the first call in the process, then a warm one
        walls: dict[str, list[float]] = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with walls_of(torch, FT, ("accumulate_counts", "finalize_counts", "count_long_grams",
                                  "select_long_grams"), walls):
            t0 = time.perf_counter()
            model = det.fit(case.table)
            torch.cuda.synchronize()
            walls["fit"] = [time.perf_counter() - t0]
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
        w = {k: sum(v) for k, v in w.items()}
        long_half = (f", long-gram count {w['count_long_grams']:.3f}s, select "
                     f"{w['select_long_grams']:.3f}s" if "count_long_grams" in w else "")
        return (f"{w['fit']:.3f}s (count {w['accumulate_counts']:.3f}s, finalize "
                f"{w['finalize_counts']:.3f}s {'blocked' if blocked else 'naive'}"
                f"{long_half})")

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
    walls: dict[str, list[float]] = {}
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
        f"{sum(walls['accumulate_counts']):.3f}s, finalize "
        f"{sum(walls['finalize_counts']):.3f}s), "
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
    in the dense table on the card (the blocked finalize over a 3.37 GB
    table), 4..5 as sorted (gram, language) keys counted and ranked on the
    card too, only the winners' cells to the host; then the plateau table."""
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


def _counts(REGISTRY, *names) -> dict[str, int]:
    counters = REGISTRY.snapshot()["counters"]
    return {n: counters.get(n, 0) for n in names}


def _same(what: str, got, ref) -> None:
    if not np.array_equal(got, ref):
        diff = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
        fail(f"{what}: not bit-identical ({int((diff > 0).sum())} entries differ, "
             f"max abs {float(diff.max()):.3g})")


def staging_stress(torch, dev, r5, docs5, ref_s, ref_l) -> None:
    """Forms x dispatch workers again with a spin kernel queued ahead of
    every host-to-device copy, one pinned buffer per size class and batches
    of STAGING_BATCH rows (so that consecutive batches share a size class):
    a buffer handed out again before its copy has run, or a result read
    before its copy back, changes the scores, and the phase fails. Every
    run is checked; runs repeat (up to STAGING_ATTEMPTS) until a take has
    waited on a pending copy, the reuse under test."""
    from spark_languagedetector_tpu_torch.api import runner as runner_mod
    from spark_languagedetector_tpu_torch.exec import staging

    real_to_device = staging.Staged.to_device

    def delayed(self):
        torch.cuda._sleep(STAGING_SPIN_CYCLES)
        return real_to_device(self)

    ring = r5._staging
    r5._staging = staging.HostStaging(dev)
    saved = {k: getattr(r5, k) for k in ("device_encode", "dispatch_workers", "batch_size")}
    r5.batch_size = STAGING_BATCH
    try:
        with swapped(staging, "RING_DEPTH", 1), swapped(staging.Staged, "to_device", delayed):
            for runs in range(1, STAGING_ATTEMPTS + 1):
                for form, size_test, encode in (("ragged", runner_mod.ragged_fit, False),
                                                ("padded", lambda *a: None, False),
                                                ("wire", runner_mod.ragged_fit, True)):
                    for workers in (1, 2):
                        r5.device_encode, r5.dispatch_workers = encode, workers
                        with swapped(runner_mod, "ragged_fit", size_test):
                            s, l = r5.score(docs5), r5.predict_ids(docs5)
                        _same(f"staging check: scores, {form} form, {workers} worker(s)",
                              s, ref_s)
                        _same(f"staging check: labels, {form} form, {workers} worker(s)",
                              l, ref_l)
                if r5._staging.waits:
                    break
        waits = r5._staging.waits
    finally:
        r5._staging = ring
        for k, v in saved.items():
            setattr(r5, k, v)
    if not waits:
        fail(f"staging check: in {runs} runs no take waited on a copy, so no reuse was tested")
    say("runner", f"staging check: a {STAGING_SPIN_CYCLES:,}-cycle spin ahead of every H2D "
        f"copy, one pinned buffer per size class, {STAGING_BATCH}-row batches: 3 forms x "
        f"1-2 workers bit for bit; {waits} takes waited on a copy's event ({runs} run(s))")


def phase_runner(torch, dev, model5, texts5, ids5, model3, case3: FitCase, smi_line) -> None:
    """The execution layer on the card (phase 14 of the module docstring)."""
    from spark_languagedetector_tpu_torch import Table
    from spark_languagedetector_tpu_torch.api import runner as runner_mod
    from spark_languagedetector_tpu_torch.api.runner import BatchRunner
    from spark_languagedetector_tpu_torch.ops import KernelLaunchError
    from spark_languagedetector_tpu_torch.ops import score_fused as SF
    from spark_languagedetector_tpu_torch.ops.encode_device import DocBlock
    from spark_languagedetector_tpu_torch.ops.encoding import texts_to_bytes
    from spark_languagedetector_tpu_torch.resilience import faults
    from spark_languagedetector_tpu_torch.resilience.faults import FaultPlan
    from spark_languagedetector_tpu_torch.resilience.policy import CircuitBreaker, RetryPolicy
    from spark_languagedetector_tpu_torch.telemetry import REGISTRY

    r5, r3 = model5.runner, model3.runner
    docs5 = [t.encode() for t in texts5]
    docs3 = [t.encode() for t in case3.texts]
    def batches() -> int:
        """Batches run since the registry's last reset (one latency each)."""
        h = REGISTRY.histograms.get("score/batch_latency_s")
        return 0 if h is None else h.count

    REGISTRY.reset()
    r5.score(docs5)
    n5 = batches()
    say("runner", f"config 5: {len(docs5)} docs in {n5} batches; config 3: {len(docs3)} "
        f"docs; card {smi_line}")
    if n5 < 2:
        fail("config 5 runs a single batch: the fetch fault at call 2 would not fire")

    # 1. Forms x lanes x dispatch workers, bit for bit.
    unpacks = []
    real_unpack = runner_mod.unpack_ragged
    saved = {k: getattr(r5, k) for k in ("device_encode", "dispatch_workers")}
    ref_s = ref_l = None
    per_doc = {}
    forms = (("ragged", runner_mod.ragged_fit, False), ("padded", lambda *a: None, False),
             ("wire", runner_mod.ragged_fit, True))
    with swapped(runner_mod, "unpack_ragged", lambda *a: unpacks.append(1) or real_unpack(*a)):
        for form, size_test, encode in forms:
            for workers in (1, 2):
                for lane in ("list", "DocBlock"):
                    r5.device_encode, r5.dispatch_workers = encode, workers
                    inp = docs5 if lane == "list" else DocBlock.from_bytes(docs5)
                    REGISTRY.reset()
                    with swapped(runner_mod, "ragged_fit", size_test):
                        s, l = r5.score(inp), r5.predict_ids(inp)
                    if ref_s is None:
                        ref_s, ref_l = s, l
                    _same(f"scores, {form} form, {lane}, {workers} worker(s)", s, ref_s)
                    _same(f"labels, {form} form, {lane}, {workers} worker(s)", l, ref_l)
                    if workers == 1 and lane == "list":
                        c = _counts(REGISTRY, "score/wire_bytes", "score/wire_docs")
                        per_doc[form] = c["score/wire_bytes"] / max(1, c["score/wire_docs"])
    for k, v in saved.items():
        setattr(r5, k, v)
    _same("runner labels vs phase 4's transform", ref_l, ids5)
    if not unpacks:
        fail("the ragged form never ran at config 5")
    say("runner", f"config 5: 3 forms x 2 lanes x 1-2 workers: f32 scores and labels bit for "
        f"bit, labels = phase 4's; ragged batches {len(unpacks)}; staging ring "
        f"{r5._staging.pinned_bytes / 1e6:.1f} MB pinned, {r5._staging.waits} waits")
    say("runner", "H2D bytes per document (score/wire_bytes / score/wire_docs, index arrays "
        "included): " + ", ".join(f"{f} {b:.0f}" for f, b in per_doc.items())
        + f"; raw text {sum(map(len, docs5)) / len(docs5):.0f} ({smi_line})")
    staging_stress(torch, dev, r5, docs5, ref_s, ref_l)

    # 2. Dedup on against off, 2,000 repeated documents added.
    for name, r, docs, exact in (("config 5", r5, docs5, True), ("config 3", r3, docs3, False)):
        dup = docs + docs[:2000]
        r.dedup = True
        REGISTRY.reset()
        s_on, l_on = r.score(dup), r.predict_ids(dup)
        c = _counts(REGISTRY, "dedup/rows_in", "dedup/rows_unique")
        r.dedup = False
        s_off, l_off = r.score(dup), r.predict_ids(dup)
        r.dedup = True
        _same(f"{name} dedup labels", l_on, l_off)
        if exact:
            _same(f"{name} dedup scores", s_on, s_off)
        elif not np.allclose(s_on, s_off, atol=ATOL, rtol=RTOL):
            fail(f"{name} dedup scores outside the reduction-order class "
                 f"(max abs {float(np.abs(s_on - s_off).max()):.3g})")
        say("runner", f"{name}: {len(dup)} docs, dedup {c['dedup/rows_in']} -> "
            f"{c['dedup/rows_unique']} rows: labels identical, scores "
            f"{'bit for bit' if exact else 'within atol=1e-4, rtol=1e-5'} "
            f"(max abs {float(np.abs(s_on - s_off).max()):.3g})")

    # 3. Faults on the card. The kernel paths replay under the policy and
    # then raise: no rung stands in for a CUDA kernel on the card.
    policies = {id(r): (r.retry_policy, r.breaker) for r in (r5, r3)}
    for name, r, docs in (("config 5", r5, docs5), ("config 3", r3, docs3)):
        ref = r.score(docs)
        r.retry_policy = RetryPolicy(max_attempts=2, base_delay_s=0.0)
        REGISTRY.reset()
        with faults.plan_scope(FaultPlan.parse("score/dispatch:error@1")):
            s = r.score(docs)
        c = _counts(REGISTRY, "score/retries", "resilience/degraded_batches")
        _same(f"{name} dispatch fault: scores vs the fault-free run", s, ref)
        if c != {"score/retries": 1, "resilience/degraded_batches": 0}:
            fail(f"{name} dispatch fault: counters {c}")
        r.retry_policy = RetryPolicy(max_attempts=1, base_delay_s=0.0)
        r.breaker = CircuitBreaker(1, cooldown_s=1e9, name="score")
        REGISTRY.reset()
        try:
            with faults.plan_scope(FaultPlan.parse("score/dispatch:error@1")):
                r.score(docs)
        except faults.InjectedFault:
            pass
        else:
            fail(f"{name}: a dispatch fault with one attempt did not propagate")
        c = REGISTRY.snapshot()["counters"]
        bad = {k: v for k, v in c.items()
               if k.startswith("resilience/") and k != "resilience/faults_injected"}
        if bad:
            fail(f"{name}: a kernel path took the ladder on the card: {bad}")
        say("runner", f"{name}: score/dispatch:error@1 -> replayed, bit for bit the fault-free "
            "run; with one attempt it propagates, no degraded rung")
        r.retry_policy, r.breaker = policies[id(r)]
    r5.retry_policy = RetryPolicy(max_attempts=2, base_delay_s=0.0)
    REGISTRY.reset()
    with faults.plan_scope(FaultPlan.parse("score/fetch:error@2")):
        s = r5.score(docs5)
    c = _counts(REGISTRY, "score/retries", "resilience/degraded_batches")
    _same("config 5 fetch fault: scores vs the fault-free run", s, ref_s)
    if c != {"score/retries": 1, "resilience/degraded_batches": 0}:
        fail(f"config 5 fetch fault: counters {c}")
    say("runner", f"config 5: score/fetch:error@2 -> batch 2 replayed, bit for bit; "
        f"counters {c}")
    r5.retry_policy = policies[id(r5)][0]

    # The ladder on the card: a gather runner (no kernel) falls to the host
    # rung, the same scorer on the CPU, whose scores a CPU gather runner
    # gives bit for bit.
    w, lut, cuckoo = model5.profile.device_membership(device="cpu")
    sub = docs5[:LADDER_DOCS]

    def gather_runner(device, **kw):
        return BatchRunner(weights=w, lut=lut, cuckoo=cuckoo, spec=model5.profile.spec,
                           device=device, strategy="gather", block=256,
                           batch_size=LADDER_BATCH, **kw)

    host_s = gather_runner("cpu").score(sub)
    clk = [0.0]
    g = gather_runner(dev, retry_policy=RetryPolicy(max_attempts=1, base_delay_s=0.0),
                      breaker=CircuitBreaker(1, cooldown_s=10.0, clock=lambda: clk[0],
                                             name="score"))
    card_s = g.score(sub)
    REGISTRY.reset()
    with faults.plan_scope(FaultPlan.parse("score/dispatch:error@1")):
        s = g.score(sub)
    c = _counts(REGISTRY, "resilience/degraded_gather", "resilience/degraded_host",
                "resilience/breaker_opened", "resilience/breaker_short_circuit")
    _same("gather runner dispatch fault: scores vs the CPU gather runner", s, host_s)
    if (c["resilience/degraded_host"] != batches() or c["resilience/degraded_gather"]
            or c["resilience/breaker_opened"] != 1 or g.breaker.state != "open"
            or not c["resilience/breaker_short_circuit"]):
        fail(f"gather runner dispatch fault: counters {c}, breaker {g.breaker.state}")
    _same("gather runner dispatch fault: labels vs the card's",
          s.argmax(axis=1), card_s.argmax(axis=1))
    say("runner", f"config 5 gather runner, {len(sub)} docs: score/dispatch:error@1 -> host "
        f"rung for every batch, bit for bit the CPU gather runner, labels = the card's "
        f"(max abs vs the card {float(np.abs(s - card_s).max()):.3g}); counters {c}")
    clk[0] += 11.0
    g.device_encode = True
    g.retry_policy = RetryPolicy(max_attempts=2, base_delay_s=0.0)
    REGISTRY.reset()
    with faults.plan_scope(FaultPlan.parse("score/pack:error")):
        s = g.score(sub)
    c = _counts(REGISTRY, "resilience/degraded_host", "score/retries",
                "resilience/breaker_opened", "score/encoded_batches")
    _same("gather runner pack fault: scores vs the CPU gather runner", s, host_s)
    if g.breaker.state != "open" or c["score/encoded_batches"] or not c["score/retries"]:
        fail(f"gather runner pack fault: counters {c}, breaker {g.breaker.state}")
    clk[0] += 11.0
    REGISTRY.reset()
    s = g.score(sub)
    gauge = dict((tuple(sorted(k.items())), v) for k, v in
                 REGISTRY.gauge_series().get("langdetect_degraded", []))
    _same("gather runner after the pack fault: wire-form scores", s, card_s)
    if g.breaker.state != "closed" or gauge.get((), 1.0) != 0.0:
        fail(f"gather runner: breaker {g.breaker.state} and langdetect_degraded "
             f"{gauge} after the cooldown")
    say("runner", f"config 5 gather runner: score/pack:error -> retried once, then the host "
        f"rung (bit for bit); breaker open; after the fake cooldown the wire form again, "
        f"breaker closed, langdetect_degraded 0; counters {c}")

    # 4. A kernel launch that fails propagates: no retry, no rung.

    def refuse(*args):
        raise KernelLaunchError("fused_detect launch failed: CUDA error 700 (swapped in "
                                "by chip_smoke.py)")

    REGISTRY.reset()
    with swapped(SF.FUSED_DETECT, "launch", refuse):
        try:
            r5.predict_ids(docs5[:300])
        except KernelLaunchError:
            pass
        else:
            fail("a KernelLaunchError in the fused kernel's launch did not propagate")
    c = REGISTRY.snapshot()["counters"]
    bad = {k: v for k, v in c.items() if k.startswith(("resilience/", "score/retries"))}
    if bad or r5.breaker.state != "closed":
        fail(f"the kernel launch failure was retried or degraded: {bad}, "
             f"breaker {r5.breaker.state}")
    say("runner", "swapped fused_detect launch raising KernelLaunchError: propagated, "
        "no retry, no degraded rung, breaker closed")

    # 5. Clean transforms afterwards count nothing.
    for name, model, texts, ids in (("config 5", model5, texts5, ids5),
                                    ("config 3", model3, case3.texts, case3.ids)):
        REGISTRY.reset()
        pred = model.transform(Table({"fulltext": texts})).column("lang").tolist()
        idx = {l: i for i, l in enumerate(model.profile.languages)}
        _same(f"{name} clean transform labels", np.asarray([idx[l] for l in pred]), ids)
        c = _counts(REGISTRY, "resilience/degraded_batches", "score/retries",
                    "resilience/breaker_short_circuit")
        if any(c.values()) or model.runner.breaker.state != "closed":
            fail(f"{name}: the clean transform after the faults counted {c}")
        say("runner", f"{name}: clean transform after the faults, labels unchanged; {c}")

    # 6. Numbers, claiming nothing.
    for name, model, texts in (("config 5", model5, texts5), ("config 3", model3, case3.texts)):
        table = Table({"fulltext": texts})
        model.transform(table)
        torch.cuda.synchronize()
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            model.transform(table)
            torch.cuda.synchronize()
            rates.append(len(texts) / (time.perf_counter() - t0))
        med = float(np.median(rates))
        say("runner", f"{name}: warm transform of {len(texts)} docs, three runs: "
            + ", ".join(f"{x:.0f}" for x in rates)
            + f" docs/s (median {med:.0f}, spread {(max(rates) - min(rates)) / med:.1%}; "
            f"host clock) ({smi_line})")
        REGISTRY.reset()
        t0 = time.perf_counter()
        model.transform(table)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stages = REGISTRY.stage_summary()
        split = {p: stages.get(p, {}).get("total_s", 0.0)
                 for p in ("score", "score/pack", "score/dispatch", "score/fetch")}
        t0 = time.perf_counter()
        byte_docs = texts_to_bytes(texts)
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        model.runner.predict_ids(byte_docs)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        say("runner", f"{name}: one warm transform {wall * 1e3:.1f} ms; spans (host clock, "
            "registry): " + ", ".join(f"{p} {t * 1e3:.1f} ms" for p, t in split.items())
            + f"; apart, text encode {enc_s * 1e3:.1f} ms and the whole runner call "
            f"{run_s * 1e3:.1f} ms ({smi_line})")
        busy = device_breakdown(torch, lambda: model.transform(table), wall * 1e3, top=5)
        if busy is not None:
            say("runner", f"{name}: device busy {busy / (wall * 1e3):.1%} of the warm "
                f"transform ({smi_line})")


SERVE_CLIENTS, SERVE_ROUNDS, SERVE_DOCS = 8, 16, 8  # config 5 under load (clients x rounds x docs)
SERVE3_CLIENTS, SERVE3_ROUNDS = 4, 8  # config 3, the shorter run
SERVE_BURST = 32  # concurrent bulk requests of SERVE_DOCS each against max_queue_rows=16
SERVE_KINDS = ("score", "detect", "segment")


def serve_load(ServeClient, address, texts, clients: int, rounds: int, actions=None):
    """``clients`` threads, each sending ``rounds`` requests of SERVE_DOCS
    distinct texts to the server at ``address``, the kind cycling through
    /score, /detect and /detect?mode=segment. ``actions`` maps (client,
    round) to a callable run by that client before that request (the swap
    and rollback). Returns the answered requests as (kind, texts, answer,
    meta), the wall seconds and each action's milliseconds; any error
    fails the phase (a dropped response)."""
    import threading

    records, errors, action_ms = [], [], {}
    lock = threading.Lock()
    barrier = threading.Barrier(clients)

    def work(c):
        client = ServeClient(*address)
        barrier.wait(timeout=60)
        for r in range(rounds):
            if actions and (c, r) in actions:
                name, act = actions[c, r]
                t0 = time.perf_counter()
                try:
                    act(client)
                except Exception as e:
                    errors.append(f"{name}: {e!r}")
                    return
                action_ms[name] = (time.perf_counter() - t0) * 1e3
            kind = SERVE_KINDS[(c + r) % len(SERVE_KINDS)]
            start = ((c * rounds + r) * SERVE_DOCS) % (len(texts) - SERVE_DOCS)
            sub = texts[start:start + SERVE_DOCS]
            try:
                if kind == "score":
                    answer, meta = client.score(sub)
                elif kind == "detect":
                    answer, meta = client.detect(sub)
                else:
                    answer, meta = client.segment(sub)
            except Exception as e:
                errors.append(f"client {c} round {r} {kind}: {e!r}")
                return
            with lock:
                records.append((kind, sub, answer, meta))

    threads = [threading.Thread(target=work, args=(c,)) for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        fail(f"serve: {len(errors)} requests not answered: {errors[:3]}")
    if len(records) != clients * rounds:
        fail(f"serve: {clients * rounds - len(records)} responses dropped")
    return records, wall, action_ms


def serve_check(what: str, records, refs: dict, exact: bool) -> str:
    """Every answered request against the direct runner of the version that
    served it (``refs``: version -> model whose runner and params are the
    reference), the request's own documents scored alone. ``exact``: bit
    for bit; else labels and segment spans exact, scores within the JAX
    package's matmul-strategy serving class (rtol=1e-4, atol=1e-5)."""
    from spark_languagedetector_tpu_torch.segment import SegmentOptions, segment_documents

    worst, inexact = 0.0, 0
    for kind, sub, answer, meta in records:
        model = refs[meta["version"]]
        runner, docs = model.runner, [t.encode() for t in sub]
        if kind == "score":
            ref = runner.score(docs)
            if not np.array_equal(answer, ref):
                inexact += 1
                worst = max(worst, float(np.abs(answer - ref).max()))
                if exact or not np.allclose(answer, ref, rtol=1e-4, atol=1e-5):
                    fail(f"{what}: /score answer of {meta['version']} differs from its direct "
                         f"runner (max abs {float(np.abs(answer - ref).max()):.3g})")
        elif kind == "detect":
            names = model.profile.languages
            ref = [names[i] for i in runner.predict_ids(docs)]
            if answer != ref:
                fail(f"{what}: /detect labels of {meta['version']} differ from its direct "
                     f"runner's ({sum(a != b for a, b in zip(answer, ref))} of {len(ref)})")
        else:
            ref = segment_documents(
                runner, docs, model.profile.languages, calibration=model.calibration,
                options=SegmentOptions(top_k=int(model.get("topK")),
                                       reject_threshold=float(model.get("rejectThreshold"))))
            if answer != ref:
                inexact += 1
                spans = [[(s["start"], s["end"], s["lang"]) for s in r["spans"]] for r in ref]
                got = [[(s["start"], s["end"], s["lang"]) for s in r["spans"]] for r in answer]
                if exact or spans != got or [r["label"] for r in ref] != [
                        r["label"] for r in answer]:
                    fail(f"{what}: segment answer of {meta['version']} differs from its direct "
                         "runner's")
    if not inexact:
        return "bit for bit"
    return (f"{inexact} answers not bit-identical (max abs {worst:.3g}), all within the "
            "matmul-strategy class: labels and spans exact, scores rtol=1e-4, atol=1e-5")


def serve_busy_share(torch, run) -> str:
    """The device's busy share over ``run()`` (torch.profiler, CUDA activity
    only, kernels of every thread), or "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.self_device_time_total / 1e3 for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    if busy_ms <= 0:
        return "device busy share not measured (the profiler recorded no device activity)"
    return f"device busy {busy_ms:.1f} ms of {wall_ms:.0f} ms = {busy_ms / wall_ms:.1%}"


def serve_burst(ServeClient, ServeHTTPError, server, texts) -> tuple[int, int]:
    """SERVE_BURST concurrent bulk requests against max_queue_rows=16:
    every one is answered, either 200 or an explicit 503 shed with
    Retry-After. Returns (answered, shed)."""
    import threading

    server.batcher.max_queue_rows = 16
    outcomes, lock = [], threading.Lock()
    barrier = threading.Barrier(SERVE_BURST)

    def work(i):
        client = ServeClient(*server.address)
        sub = texts[i * SERVE_DOCS:(i + 1) * SERVE_DOCS]
        barrier.wait(timeout=60)
        try:
            client.detect(sub, priority="bulk")
            out = "ok"
        except ServeHTTPError as e:
            out = "shed" if e.status == 503 and e.shed and e.retry_after_s > 0 else repr(e)
        except Exception as e:
            out = repr(e)
        with lock:
            outcomes.append(out)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(SERVE_BURST)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    server.batcher.max_queue_rows = 4096
    bad = [o for o in outcomes if o not in ("ok", "shed")]
    if bad or len(outcomes) != SERVE_BURST:
        fail(f"serve burst: {SERVE_BURST - len(outcomes)} dropped, errors {bad[:3]}")
    return outcomes.count("ok"), outcomes.count("shed")


def serve_stats(REGISTRY) -> str:
    h = REGISTRY.snapshot()["histograms"]
    tot, wait, rows = h["serve/total_s"], h["serve/queue_wait_s"], h["serve/rows_per_dispatch"]
    reqs = h["serve/requests_per_dispatch"]
    return (f"serve/total_s p50 {tot['p50'] * 1e3:.2f} ms, p99 {tot['p99'] * 1e3:.2f} ms; "
            f"serve/queue_wait_s p99 {wait['p99'] * 1e3:.2f} ms; mean {rows['mean']:.2f} rows "
            f"and {reqs['mean']:.2f} requests per dispatch over {rows['count']} dispatches")


def serve_split(REGISTRY, wall: float) -> str:
    """Host-clock span totals of a serve run beside its wall: the
    dispatcher's time (``serve/dispatch``) and, nested in it, the runner's
    ``score`` span (``serve/dispatch/score``; ``segment_cells`` records one
    too) and the rest (the runner's work before its span, the segment
    decode on the host, the cache)."""
    stages = REGISTRY.stage_summary()
    tot = {p: stages.get("serve/dispatch/" * (p != "serve/dispatch") + p, {}).get("total_s", 0.0)
           for p in ("serve/dispatch", "score", "score/pack", "score/dispatch", "score/fetch")}
    disp = REGISTRY.snapshot()["histograms"]["serve/dispatch_s"]
    return (f"dispatcher busy {tot['serve/dispatch']:.3f} s of the {wall:.2f} s wall "
            f"({tot['serve/dispatch'] / wall:.0%}); inside it the runner's score span "
            f"{tot['score']:.3f} s (pack {tot['score/pack']:.3f}, dispatch "
            f"{tot['score/dispatch']:.3f}, fetch {tot['score/fetch']:.3f}), the rest "
            f"{tot['serve/dispatch'] - tot['score']:.3f} s; serve/dispatch_s p50 "
            f"{disp['p50'] * 1e3:.2f} ms, p99 {disp['p99'] * 1e3:.2f} ms")


def phase_serve(torch, dev, model5, texts5, case5: FitCase, model3, case3: FitCase,
                smi_line) -> None:
    """Online serving on the card (phase 15 of the module docstring)."""
    import gc

    from spark_languagedetector_tpu_torch import LanguageDetectorModel
    from spark_languagedetector_tpu_torch.serve import (
        ModelRegistry, ServeClient, ServeHTTPError, ServingServer)
    from spark_languagedetector_tpu_torch.telemetry import REGISTRY

    # 1. fused_detect does not depend on the batch around a document: one
    # document alone, inside 64, and inside the 4,096-row batch.
    r5 = model5.runner
    docs = [t.encode() for t in texts5[:4096]]
    s64, l64 = r5.score(docs[:64]), r5.predict_ids(docs[:64])
    solo = np.concatenate([r5.score([d]) for d in docs[:64]])
    solo_ids = np.concatenate([r5.predict_ids([d]) for d in docs[:64]])
    s4096, l4096 = r5.score(docs)[:64], r5.predict_ids(docs)[:64]
    _same("fused_detect scores: alone vs in a batch of 64", solo, s64)
    _same("fused_detect scores: in 64 vs in 4,096", s4096, s64)
    _same("fused_detect ids: alone / 64 / 4,096", np.stack([solo_ids, l4096]),
          np.stack([l64, l64]))
    say("serve", f"fused_detect: 64 documents scored alone, in a batch of 64 and in "
        f"4,096 ({len(r5.plan([len(d) for d in docs]))} micro-batches): f32 scores and ids "
        "bit for bit")

    with tempfile.TemporaryDirectory(prefix="serve_smoke_") as tmp:
        # 2. The swap target: a second config-5 model, profile size 300.
        t0 = time.perf_counter()
        m300 = case5.det.copy({"languageProfileSize": 300, "fitBackend": "device"}).fit(
            case5.table)
        path300 = f"{tmp}/c5_p300"
        m300.save(path300)
        ref300 = LanguageDetectorModel.load(path300, device=str(dev))
        ref300.runner.score(docs[:8])
        say("serve", f"swap target: config 5 refitted with profile 300 ({m300.profile.num_grams} "
            f"grams) and saved in {time.perf_counter() - t0:.1f}s")
        del m300

        # 3. Config 5 behind the HTTP server, eight clients, a swap and a
        # rollback over HTTP mid-run. The registry serves a copy, so the
        # runner it releases is the only one of its version.
        registry = ModelRegistry(device=str(dev))
        t0 = time.perf_counter()
        registry.install(model5.copy())
        say("serve", f"registry: v1 installed and prewarmed in {time.perf_counter() - t0:.2f}s "
            f"(kernel libraries loaded: {[k.name for k in registry.peek().runner.kernels()]})")
        with ServingServer(registry, port=0, max_wait_ms=5, max_rows=256) as server:
            texts = texts5[:2000]
            warm = ServeClient(*server.address)
            warm.score(texts5[5000:5008])
            warm.detect(texts5[5008:5016])
            warm.segment(texts5[5016:5024])
            torch.cuda.synchronize()
            gc.collect()
            mem_before = torch.cuda.memory_allocated(dev)
            ring = registry.peek().runner._staging.pinned_bytes
            REGISTRY.reset()
            reset_launches()
            actions = {(0, 5): ("swap", lambda c: c.swap(path300)),
                       (0, 11): ("rollback", lambda c: c.rollback())}
            records, wall, action_ms = serve_load(ServeClient, server.address, texts,
                                                  SERVE_CLIENTS, SERVE_ROUNDS, actions)
            launches = read_launches()
            stats = serve_stats(REGISTRY)
            split = serve_split(REGISTRY, wall)
            hists = REGISTRY.snapshot()["histograms"]
            rows_mean = hists["serve/rows_per_dispatch"]["mean"]
            reqs_mean = hists["serve/requests_per_dispatch"]["mean"]
            served = sorted({m["version"] for *_, m in records})
            n_docs = sum(len(sub) for _, sub, _, _ in records)
            say("serve", f"config 5: {len(records)} requests ({n_docs} docs) from "
                f"{SERVE_CLIENTS} clients in {wall:.2f}s: {len(records) / wall:.1f} requests/s, "
                f"{n_docs / wall:.0f} docs/s; {stats}; swap {action_ms['swap']:.0f} ms, "
                f"rollback {action_ms['rollback']:.0f} ms (client side, load and prewarm "
                f"included); versions served {served}; launches {launches} ({smi_line})")
            say("serve", f"config 5 time split (host clock): {split}")
            if served != ["v1", "v2"]:
                fail(f"serve: the swap and rollback served versions {served}")
            if registry.current_version() != "v1":
                fail("serve: the rollback did not restore v1")
            if launches["fused_detect"] <= 0 or launches["fused_segment"] <= 0:
                fail(f"serve: config 5 answered without the fused kernels: {launches}")
            if rows_mean <= 1 or reqs_mean <= 1:
                fail(f"serve: no coalescing (mean rows per dispatch {rows_mean}, requests "
                     f"per dispatch {reqs_mean})")
            note = serve_check("serve config 5", records, {"v1": model5, "v2": ref300},
                               exact=True)
            say("serve", f"config 5: every answer equals the direct runner of its version, "
                f"{note}")
            gc.collect()
            torch.cuda.synchronize()
            mem_after = torch.cuda.memory_allocated(dev)
            say("serve", f"device memory allocated before the swaps {mem_before / 1e6:.1f} MB, "
                f"after swap + rollback {mem_after / 1e6:.1f} MB (v2's runner released: "
                f"{registry.versions()[1]['strategy'] is None}; staging ring {ring / 1e6:.1f} "
                "MB pinned)")
            if mem_after - mem_before > ring:
                fail(f"serve: device memory grew by {(mem_after - mem_before) / 1e6:.1f} MB "
                     f"across the swaps, more than one staging ring ({ring / 1e6:.1f} MB)")
            busy = serve_busy_share(torch, lambda: serve_load(
                ServeClient, server.address, texts5[2000:3000], SERVE_CLIENTS, 4))
            say("serve", f"config 5, {SERVE_CLIENTS} clients x 4 rounds under the profiler: "
                f"{busy} ({smi_line})")
            REGISTRY.reset()
            ok, shed = serve_burst(ServeClient, ServeHTTPError, server, texts5[3000:4000])
            say("serve", f"config 5 burst: {SERVE_BURST} concurrent bulk requests against "
                f"max_queue_rows=16: {ok} answered, {shed} shed with 503 + Retry-After, none "
                f"dropped; counters {_counts(REGISTRY, 'serve/shed_queue_full', 'serve/requests')}")
            if not shed:
                fail("serve: the burst against max_queue_rows=16 shed nothing")
        del registry, server

    # 4. Config 3 (hybrid: bigram_hist + row_hist), the shorter run.
    registry = ModelRegistry(device=str(dev))
    registry.install(model3)
    with ServingServer(registry, port=0, max_wait_ms=5, max_rows=256) as server:
        REGISTRY.reset()
        reset_launches()
        records, wall, _ = serve_load(ServeClient, server.address, case3.texts[:4000],
                                      SERVE3_CLIENTS, SERVE3_ROUNDS)
        launches = read_launches()
        n_docs = sum(len(sub) for _, sub, _, _ in records)
        say("serve", f"config 3: {len(records)} requests ({n_docs} docs) from {SERVE3_CLIENTS} "
            f"clients in {wall:.2f}s: {len(records) / wall:.1f} requests/s, "
            f"{n_docs / wall:.0f} docs/s; {serve_stats(REGISTRY)}; launches {launches} "
            f"({smi_line})")
        say("serve", f"config 3 time split (host clock): {serve_split(REGISTRY, wall)}")
        if launches["row_hist"] <= 0 or launches["bigram_hist"] <= 0:
            fail(f"serve: config 3 answered without the histogram kernels: {launches}")
        note = serve_check("serve config 3", records, {"v1": model3}, exact=False)
        say("serve", f"config 3: every answer equals the direct runner, {note}")
        ok, shed = serve_burst(ServeClient, ServeHTTPError, server, case3.texts[4000:5000])
        say("serve", f"config 3 burst: {ok} answered, {shed} shed, none dropped")
        if not shed:
            fail("serve: the config-3 burst against max_queue_rows=16 shed nothing")


# ------------------------------------------------------- stream, refit ------
STREAM_BATCH = 8192  # bench config 4's source batch rows
STREAM_SMALL_BATCH = 1024  # the chaos and spin legs: ten batches, four in flight
STREAM_SPIN_ROWS = 64  # runner batch rows in the spin leg: 16 takes per source batch
STREAM_PLAN = "seed=7;stream/batch:error@2;score/dispatch:error@6;stream/batch:poison=2@3"
REFIT_BATCH = 440  # phase 4's 5,280 training documents as 12 labeled batches


def stream_labels(run_stream, model, source, **kw):
    """(labels, texts) the sink saw, in the order it saw them, and the query."""
    labels, texts = [], []

    def sink(t):
        labels.extend(t.column("lang").tolist())
        texts.extend(t.column("fulltext").tolist())

    return labels, texts, run_stream(model, source, sink, **kw)


def spin_check(torch, dev, runner, run, ref) -> tuple[int, int]:
    """Four stream workers share ``runner`` with a spin kernel queued ahead
    of every host-to-device copy and one pinned buffer per size class: a
    buffer handed to one worker's batch before another's copy ran would
    change labels. Each run's labels must equal ``ref``; runs repeat (up to
    STAGING_ATTEMPTS) until a take has waited on a pending copy, which is
    the reuse under test. Returns (runs, takes that waited)."""
    from spark_languagedetector_tpu_torch.exec import staging

    real_to_device = staging.Staged.to_device

    def delayed(self):
        torch.cuda._sleep(STAGING_SPIN_CYCLES)
        return real_to_device(self)

    ring = runner._staging
    runner._staging = staging.HostStaging(dev)
    try:
        with swapped(staging, "RING_DEPTH", 1), swapped(staging.Staged, "to_device", delayed):
            for runs in range(1, STAGING_ATTEMPTS + 1):
                got = run()
                if got != ref:
                    bad = sum(a != b for a, b in zip(got, ref))
                    fail(f"stream spin check: 4 workers under the spin gave {bad} labels "
                         "other than 1 worker's")
                if runner._staging.waits:
                    break
        waits = runner._staging.waits
    finally:
        runner._staging = ring
    if not waits:
        fail(f"stream spin check: in {runs} runs no take waited on a copy, so no reuse "
             "was tested")
    return runs, waits


def phase_stream(torch, dev, smi_line) -> int:
    """Bench config 4 through ``run_stream`` (phase 16 of the module
    docstring); returns the ``fused_detect`` launches of its gated runs."""

    from spark_languagedetector_tpu_torch import LanguageDetector, Table
    from spark_languagedetector_tpu_torch.ops import score_fused as SF
    from spark_languagedetector_tpu_torch.resilience import DeadLetterQueue, faults
    from spark_languagedetector_tpu_torch.resilience.faults import FaultPlan
    from spark_languagedetector_tpu_torch.resilience.policy import RetryPolicy
    from spark_languagedetector_tpu_torch.stream import memory_source, run_stream
    from spark_languagedetector_tpu_torch.telemetry import REGISTRY

    langs = language_names(10)
    train, train_labels = make_corpus(langs, 60 * len(langs), seed=1)
    model = LanguageDetector(langs, [1, 2, 3], 3000, device=str(dev)).fit(
        Table({"lang": train_labels, "fulltext": train}))
    texts, _ = make_corpus(langs, 10000, seed=2)
    rows = [{"fulltext": t} for t in texts]
    runner = model.runner
    if runner.strategy != "fused":
        fail(f"config 4 runner strategy is {runner.strategy!r}, expected 'fused'")
    t0 = time.perf_counter()
    ref = model.transform(Table({"fulltext": texts})).column("lang").tolist()
    say("stream", f"config 4: {model.profile.num_grams} grams ({model.profile.spec}), strategy "
        f"{runner.strategy}; {len(texts)} docs ({sum(map(len, texts)) / 1e6:.2f} MB); "
        f"model.transform of the whole corpus {time.perf_counter() - t0:.2f}s")
    idx = {l: i for i, l in enumerate(langs)}
    ref_ids = np.asarray([idx[l] for l in ref])
    byte_docs = [t.encode() for t in texts]
    with plain_version(SF):
        plain_scores = runner.score(byte_docs)
    flips = check_labels("stream: transform vs plain", ref_ids, np.argmax(plain_scores, 1),
                         plain_scores)
    say("stream", f"model.transform labels vs the plain version on the card: "
        f"{len(ref) - flips}/{len(ref)} identical, {flips} near-tie exceptions")

    # 1. The gated runs: every row once, in source order, labels = transform's.
    reset_launches()
    for prefetch, workers in ((0, 1), (6, 4)):
        labels, seen, query = stream_labels(run_stream, model,
                                            memory_source(rows, STREAM_BATCH),
                                            prefetch=prefetch, workers=workers)
        if seen != texts:
            fail(f"stream prefetch={prefetch} workers={workers}: the sink did not see every "
                 "row once in source order")
        if labels != ref:
            fail(f"stream prefetch={prefetch} workers={workers}: "
                 f"{sum(a != b for a, b in zip(labels, ref))} labels differ from "
                 "model.transform's")
    launches = read_launches()["fused_detect"]
    if launches <= 0:
        fail("stream: the streamed batches never launched fused_detect")
    say("stream", f"{STREAM_BATCH}-row batches, prefetch 0 x 1 worker and prefetch 6 x 4 "
        f"workers: every row once in source order, labels bit for bit model.transform's; "
        f"fused_detect launches {launches}")

    # 2. Spin check: four workers on one runner, a spin ahead of every copy,
    # small runner batches so consecutive takes share a size class.
    saved_rows = runner.batch_size
    runner.batch_size = STREAM_SPIN_ROWS
    try:
        small_ref, _, _ = stream_labels(run_stream, model,
                                        memory_source(rows, STREAM_SMALL_BATCH),
                                        prefetch=0, workers=1)
        runs, waits = spin_check(torch, dev, runner, lambda: stream_labels(
            run_stream, model, memory_source(rows, STREAM_SMALL_BATCH), prefetch=6,
            workers=4)[0], small_ref)
    finally:
        runner.batch_size = saved_rows
    if small_ref != ref:
        fail("stream: labels of the 1-worker stream at a small runner batch differ from "
             "model.transform's")
    say("stream", f"spin check: {STREAM_SMALL_BATCH}-row source batches, {STREAM_SPIN_ROWS}-row "
        f"runner batches, 4 workers, a {STAGING_SPIN_CYCLES:,}-cycle spin ahead of every H2D "
        f"copy, one pinned buffer per size class: labels bit for bit 1 worker's and "
        f"model.transform's; {waits} takes waited on a copy's event ({runs} run(s))")

    # 3. Chaos leg: the JAX chaos smoke's plan with a dead-letter queue.
    plan = FaultPlan.parse(STREAM_PLAN)
    poison = plan.poison_rows(3, STREAM_SMALL_BATCH)
    REGISTRY.reset()
    dlq = DeadLetterQueue()
    with faults.plan_scope(plan):
        labels, seen, query = stream_labels(
            run_stream, model, memory_source(rows, STREAM_SMALL_BATCH),
            retry_policy=RetryPolicy(max_attempts=3, base_delay_s=0.0), dlq=dlq,
            prefetch=6, workers=4)
    base = 2 * STREAM_SMALL_BATCH
    dropped = {base + r for r in poison}
    keep = [i for i in range(len(texts)) if i not in dropped]
    if seen != [texts[i] for i in keep] or labels != [ref[i] for i in keep]:
        fail("stream chaos: the healthy rows' labels differ from the fault-free run's")
    if [(r["batch"], r["row_index"], r["row"]["fulltext"]) for r in dlq.records] != [
            (2, r, texts[base + r]) for r in poison]:
        fail(f"stream chaos: the DLQ holds {[(r['batch'], r['row_index']) for r in dlq.records]}"
             f", expected batch 2 rows {poison}")
    counters = _counts(REGISTRY, "stream/retries", "score/retries",
                       "resilience/quarantined_batches", "resilience/degraded_batches")
    if counters["stream/retries"] < 1:
        fail(f"stream chaos: no stream retry counted ({counters})")
    if counters["resilience/degraded_batches"]:
        fail(f"stream chaos: a kernel path took the degraded ladder on the card ({counters})")
    say("stream", f"chaos plan {STREAM_PLAN!r} with a DLQ, 4 workers: {query.batches} batches, "
        f"healthy labels = the fault-free run's, DLQ = batch 2 rows {poison}; {counters}")

    # 4. Checkpoint leg: one batch, then a rerun on the same checkpoint.
    with tempfile.TemporaryDirectory(prefix="stream_smoke_") as tmp:
        ck = f"{tmp}/ck.json"
        _, first, q1 = stream_labels(run_stream, model, memory_source(rows, STREAM_BATCH),
                                     checkpoint_path=ck, max_batches=1)
        _, rest, q2 = stream_labels(run_stream, model, memory_source(rows, STREAM_BATCH),
                                    checkpoint_path=ck, prefetch=6, workers=4)
    if q2.resumed_from != 1 or first + rest != texts:
        fail(f"stream checkpoint: resumed_from {q2.resumed_from}, {len(first)} + {len(rest)} "
             f"rows sunk, expected 1 and the corpus once")
    say("stream", f"checkpoint: max_batches=1 sank {len(first)} rows, the rerun resumed from "
        f"batch {q2.resumed_from} and sank {len(rest)}: the corpus, each row once")

    # 5. Claiming nothing: rows/s, per-batch latency, busy share.
    rates, lat = [], []
    for _ in range(3):
        batch_s = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_stream(model, memory_source(rows, STREAM_BATCH), lambda t: None, prefetch=6,
                   workers=4, on_progress=lambda q: batch_s.append(q.last_batch_seconds))
        torch.cuda.synchronize()
        rates.append(len(rows) / (time.perf_counter() - t0))
        lat += batch_s
    busy = serve_busy_share(torch, lambda: run_stream(
        model, memory_source(rows, STREAM_BATCH), lambda t: None, prefetch=6, workers=4))
    say("stream", f"config 4, {STREAM_BATCH}-row batches, prefetch 6 x 4 workers: "
        f"{', '.join(f'{r:.0f}' for r in rates)} rows/s (median {np.median(rates):.0f}, "
        f"spread {max(rates) - min(rates):.0f}); per-batch latency p50 "
        f"{np.percentile(lat, 50) * 1e3:.1f} ms, p95 {np.percentile(lat, 95) * 1e3:.1f} ms "
        f"over {len(lat)} batches; {busy} ({smi_line})")
    return launches


def live_cuda_tensors(torch) -> dict:
    """{id: (bytes, shape, dtype)} of the CUDA tensors Python holds."""
    import gc

    return {(id(o), o.data_ptr()): (o.numel() * o.element_size(), tuple(o.shape), str(o.dtype))
            for o in gc.get_objects() if isinstance(o, torch.Tensor) and o.is_cuda}


def phase_refit(torch, dev, case: FitCase, fit5_model, smi_line) -> int:
    """The continuous-learning loop at config 5 (phase 17 of the module
    docstring); returns the ``fused_detect`` launches of the served model's
    answers."""
    import gc

    from spark_languagedetector_tpu_torch import Table
    from spark_languagedetector_tpu_torch.models.refit import FitAccumulator
    from spark_languagedetector_tpu_torch.persist.io import load_fit_state
    from spark_languagedetector_tpu_torch.serve import ModelRegistry
    from spark_languagedetector_tpu_torch.stream import AutoRefit
    from spark_languagedetector_tpu_torch.telemetry import REGISTRY

    det = case.det.copy({"fitBackend": "device"})
    labels = case.table.column("lang").tolist()
    texts = case.table.column("fulltext").tolist()
    batches = [Table({"lang": labels[i:i + REFIT_BATCH], "fulltext": texts[i:i + REFIT_BATCH]})
               for i in range(0, len(texts), REFIT_BATCH)]
    if len(batches) != 12:
        fail(f"refit: {len(texts)} training docs make {len(batches)} batches, expected 12")
    docs = [t.encode() for t in case.texts]
    registry = ModelRegistry(device=str(dev))
    registry.install(fit5_model.copy(), version="scratch")
    with registry.lease() as entry:
        entry.runner.score(docs)  # a version that has served: its staging ring in use
    gc.collect()
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated(dev)
    live_before = live_cuda_tensors(torch)
    ring = registry.peek().runner._staging.pinned_bytes
    torch.cuda.reset_peak_memory_stats()
    REGISTRY.reset()
    times: dict[str, list[float]] = {}
    with tempfile.TemporaryDirectory(prefix="refit_smoke_") as tmp, \
            walls_of(torch, FitAccumulator, ("update", "save", "finalize"), times), \
            walls_of(torch, ModelRegistry, ("install", "commit"), times):
        state = f"{tmp}/state"
        first = AutoRefit(det, registry, state_path=state, refit_every_batches=2,
                          final_refit=False)
        table_bytes = first.acc.counts.numel() * first.acc.counts.element_size()
        p1 = first.run(batches, max_batches=6)
        ids, rows = first.acc.nonzero_rows()
        saved = load_fit_state(state)
        if not (np.array_equal(saved["ids"], ids) and np.array_equal(saved["rows"], rows)
                and saved["committed"] == 6):
            fail("refit: the fit state saved after 6 batches does not read back as the "
                 "accumulator's rows")
        state_bytes = sum(f.stat().st_size for f in Path(state).rglob("*") if f.is_file())
        say("refit", f"run 1: {p1.batches} batches, {p1.refits} refits; the saved state "
            f"reads back with the accumulator's {len(ids)} nonzero rows and token 6 "
            f"({state_bytes / 1e6:.1f} MB on disk, {rows.nbytes / 1e6:.0f} MB of int64 rows)")
        del first  # the kill
        gc.collect()
        second = AutoRefit(det, registry, state_path=state, refit_every_batches=4)
        p2 = second.run(batches)
        gc.collect()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        mem_after = torch.cuda.memory_allocated(dev)
        live_after = live_cuda_tensors(torch)
        if p2.resumed_from != 6 or p2.batches != 6:
            fail(f"refit: the second run resumed from {p2.resumed_from} and consumed "
                 f"{p2.batches} batches, expected 6 and 6")
    served = registry.peek()
    meta = served.describe().get("metadata") or {}
    if meta.get("refit_token") != 12 or meta.get("docs_seen") != len(texts):
        fail(f"refit: the served version's metadata is {meta}, expected token 12")
    sp, dp, hp = served.model.profile, fit5_model.profile, case.model.profile
    for what, other in (("phase 11's device fit", dp), ("phase 4's host fit", hp)):
        if not (np.array_equal(sp.ids, other.ids) and np.array_equal(sp.weights, other.weights)):
            fail(f"refit: the served profile differs from {what}")
    n_refits = p1.refits + p2.refits
    collect = REGISTRY.snapshot()["counters"].get("fit/collect_bytes", 0) / n_refits
    if not 0 < collect < table_bytes / 2:
        fail(f"refit: fit/collect_bytes per finalize {collect:.0f}, table {table_bytes}")
    say("refit", f"run 2 resumed from batch {p2.resumed_from}, consumed {p2.batches}; served "
        f"{served.version} with {meta}: profile ids and float64 weights bit-identical to "
        f"phase 11's device fit and phase 4's host fit ({len(sp.ids)} grams); "
        f"fit/collect_bytes per finalize {collect / 1e6:.2f} MB of the {table_bytes / 1e9:.3f} "
        f"GB table")

    reset_launches()
    with registry.lease() as entry:
        got_s, got_l = entry.runner.score(docs), entry.runner.predict_ids(docs)
    torch.cuda.synchronize()
    launches = read_launches()["fused_detect"]
    if launches <= 0:
        fail("refit: the served model answered without fused_detect")
    _same("refit: served scores vs the from-scratch model's direct runner", got_s,
          fit5_model.runner.score(docs))
    _same("refit: served labels vs phase 4's", got_l, case.ids)
    retired = [e for e in registry._history if e is not served]
    if any(e.runner is not None for e in retired):
        fail("refit: a retired version kept its runner")
    grew = mem_after - (mem_before + table_bytes)

    def ms(name):
        v = times.get(name, [])
        return f"{np.median(v) * 1e3:.1f} (n={len(v)})" if v else "none"

    say("refit", f"timings, median ms: update per batch {ms('update')}, finalize per refit "
        f"{ms('finalize')}, checkpoint {ms('save')}, install (runner build + prewarm + "
        f"flip) {ms('install')}, flip {ms('commit')}; peak device memory {peak / 1e9:.2f} GB "
        f"({smi_line})")
    new = sorted((v for k, v in live_after.items() if k not in live_before), reverse=True)
    gone = sorted((v for k, v in live_before.items() if k not in live_after), reverse=True)
    held = sum(v[0] for v in new) - sum(v[0] for v in gone)
    say("refit", f"served model: {len(docs)} docs of phase 4, fused_detect launches {launches}, "
        f"scores bit for bit the from-scratch model's direct runner, labels phase 4's; "
        f"{len(retired)} retired versions released their runners; device memory allocated "
        f"{mem_before} B before, {mem_after} B after the last swap: the table "
        f"({table_bytes} B) {grew:+d} B, staging ring {ring} B; CUDA tensors Python holds: "
        f"{held:+d} B ({len(new)} new, largest {new[:2]}; {len(gone)} gone)")
    if held != table_bytes:
        fail(f"refit: the CUDA tensors held after the last swap grew by {held} B, not by the "
             f"accumulator's table ({table_bytes} B): a retired version or an old table leaked")
    if abs(grew) > ring:
        fail(f"refit: device memory after the last swap is {grew / 1e6:.1f} MB away from "
             "before + the table, more than one staging ring")
    del second
    return launches


# --------------------------------------------------- fleet, storm, zoo ------
FLEET_CLIENTS, FLEET_ROUNDS, FLEET_DOCS = 6, 14, 8  # config 5 through the router
FLEET_KINDS = ("detect", "score", "segment")
FLEET_KILL_ROUND, FLEET_REVIVE_ROUND, FLEET_SWAP_ROUND = 2, 7, 11
STORM_STRAGGLE_S = 0.4  # the injected straggler: dwarfs a config-5 dispatch
STORM_HEDGE_MIN_MS = 150.0  # the hedge delay floor, between the two
ZOO_TENANTS, ZOO_CLIENTS, ZOO_ROUNDS, ZOO_DOCS = 12, 6, 16, 8
ZOO_BURST_ROUND, ZOO_REFIT_ROUND = 5, 13
ZOO_SUBSAMPLE = 0.6  # each tenant fits a distinct seeded 60% of phase 4's training docs


def live_cuda_bytes(torch) -> int:
    """Bytes of the CUDA storages that Python-held tensors reference, each
    storage once."""
    import gc

    storages = {}
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.is_cuda:
            st = o.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
    return sum(storages.values())


def quiesce(torch) -> int:
    """Collect garbage, wait for the card, and return ``live_cuda_bytes``."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    return live_cuda_bytes(torch)


class Prober:
    """The router's probe rounds on a thread of this script, every
    ``router.probe_interval_s``, with a pause: a kill is made while no probe
    runs, so the next requests meet the dead replica before a probe marks
    it unready (the failover a real crash mid-traffic gives)."""

    def __init__(self, router):
        import threading

        self.router = router
        self.running = threading.Event()
        self.running.set()
        self._stop = threading.Event()
        self._idle = threading.Lock()
        self._thread = threading.Thread(target=self._loop, name="smoke-prober", daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self.router.probe_interval_s):
            if self.running.is_set():
                with self._idle:
                    self.router.probe_once()

    @contextlib.contextmanager
    def paused(self):
        self.running.clear()
        with self._idle:  # a round in progress ends first
            pass
        try:
            yield
        finally:
            self.running.set()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)


def wait_until(what: str, cond, timeout_s: float = 30.0) -> float:
    """Poll ``cond`` every 2 ms; its seconds, or fail after ``timeout_s``."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout_s:
            fail(f"{what}: not reached in {timeout_s:.0f}s")
        time.sleep(0.002)
    return time.perf_counter() - t0


def timed_dispatchers(fleet, busy: dict) -> None:
    """Time each replica batcher's dispatches (``busy[replica]`` gathers
    seconds); a revived replica's new batcher is wrapped again."""
    for rep in fleet.replicas:
        b = rep.server.batcher if rep.server is not None else None
        if b is None or getattr(b, "_smoke_timed", False):
            continue
        inner = b._dispatch

        def timed(batch, inner=inner, name=rep.name):
            t0 = time.perf_counter()
            try:
                return inner(batch)
            finally:
                busy[name] = busy.get(name, 0.0) + time.perf_counter() - t0

        b._dispatch = timed
        b._smoke_timed = True


def fleet_load(ServeClient, address, texts, actions, sheds: list | None = None
               ) -> tuple[list, float, dict]:
    """FLEET_CLIENTS threads, FLEET_ROUNDS requests each of FLEET_DOCS
    texts to the router at ``address``, the kind cycling /detect, /score,
    /detect?mode=segment by (client + round) mod 3; ``actions[(client,
    round)]`` runs first (it may send requests of its own and returns them).
    Returns (client, kind, texts, answer, meta) in each client's order, the
    wall seconds and each action's milliseconds; any error fails the
    phase, except, when a ``sheds`` list is given, an explicit shed (503
    with Retry-After), which is appended there as (client, kind, texts)."""
    import threading

    from spark_languagedetector_tpu_torch.serve import ServeHTTPError

    records, errors, action_ms = [], [], {}
    lock = threading.Lock()
    barrier = threading.Barrier(FLEET_CLIENTS)

    def send(client, c, kind, sub):
        call = {"detect": client.detect, "score": client.score,
                "segment": client.segment}[kind]
        try:
            answer, meta = call(sub)
        except ServeHTTPError as e:
            if sheds is None or not (e.status == 503 and e.shed and e.retry_after_s > 0):
                raise
            with lock:
                sheds.append((c, kind, sub))
            return None
        with lock:
            records.append((c, kind, sub, answer, meta))
        return meta

    def work(c):
        client = ServeClient(*address)
        barrier.wait(timeout=60)
        for r in range(FLEET_ROUNDS):
            start = ((c * FLEET_ROUNDS + r) * FLEET_DOCS) % (len(texts) - FLEET_DOCS)
            sub = texts[start:start + FLEET_DOCS]
            try:
                if (c, r) in actions:
                    name, act = actions[c, r]
                    t0 = time.perf_counter()
                    act(lambda kind, s=sub: send(client, c, kind, s))
                    action_ms[name] = (time.perf_counter() - t0) * 1e3
                send(client, c, FLEET_KINDS[(c + r) % 3], sub)
            except Exception as e:
                errors.append(f"client {c} round {r}: {e!r}")
                return

    threads = [threading.Thread(target=work, args=(c,)) for c in range(FLEET_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        fail(f"fleet: {len(errors)} clients stopped on an unanswered request: {errors[:3]}")
    return records, wall, action_ms


class RunnerBuilds:
    """Counts runner builds per model object while active (wraps
    ``LanguageDetectorModel._runner_locked``)."""

    def __init__(self, Model):
        self.Model, self.builds = Model, {}

    def __enter__(self):
        real = self.Model._runner_locked
        builds = self.builds

        def counting(model):
            if model._runner is None:
                builds[id(model)] = builds.get(id(model), 0) + 1
            return real(model)

        self._swap = swapped(self.Model, "_runner_locked", counting)
        self._swap.__enter__()
        return self

    def __exit__(self, *exc):
        self._swap.__exit__(*exc)

    def of(self, model) -> int:
        return self.builds.get(id(model), 0)


def phase_fleet(torch, dev, model5, texts5, case5: FitCase, tmp, smi_line) -> tuple[dict, tuple]:
    """A three-replica fleet at config 5 behind the router (phase 18 of the
    module docstring). Returns the launches and the two model directories."""
    from spark_languagedetector_tpu_torch import LanguageDetectorModel
    from spark_languagedetector_tpu_torch.serve import (
        QuarantineTable, RouterServer, ServeClient, ServeFleet)
    from spark_languagedetector_tpu_torch.telemetry import REGISTRY
    from spark_languagedetector_tpu_torch.telemetry.aggregate import FleetCollector
    from spark_languagedetector_tpu_torch.zoo.zoo import _table_bytes

    dir_a, dir_b = f"{tmp}/c5", f"{tmp}/c5_p300"
    t0 = time.perf_counter()
    model5.save(dir_a)
    m300 = case5.det.copy({"languageProfileSize": 300, "fitBackend": "device"}).fit(case5.table)
    m300.save(dir_b)
    del m300
    ref_a = LanguageDetectorModel.load(dir_a, device=str(dev))
    ref_b = LanguageDetectorModel.load(dir_b, device=str(dev))
    say("fleet", f"phase 4's model and a profile-300 refit saved and reloaded as references in "
        f"{time.perf_counter() - t0:.1f}s")
    texts = texts5[:3000]
    with RunnerBuilds(LanguageDetectorModel) as builds:
        ref_a.runner.score([t.encode() for t in texts[:8]])
        ref_b.runner.score([t.encode() for t in texts[:8]])
        t0 = time.perf_counter()
        fleet = ServeFleet.from_path(
            dir_a, replicas=3, device=str(dev),
            router_kw=dict(probe_interval_ms=40, breaker_threshold=2, breaker_cooldown_s=0.3,
                           quarantine=QuarantineTable(0, name="fleet-smoke")),
            max_wait_ms=4, max_rows=256, max_queue_rows=1024)
        fleet.start(probe=False)
        model_a = fleet.replicas[0].registry.peek().model
        say("fleet", f"ServeFleet.from_path: 3 replicas sharing one model and one runner, up in "
            f"{time.perf_counter() - t0:.2f}s")
        prober = Prober(fleet.router)
        collector = FleetCollector()
        busy: dict[str, float] = {}
        try:
            with RouterServer(fleet.router, fleet=fleet, port=0, collector=collector) as front:
                warm = ServeClient(*front.address)
                for kind in FLEET_KINDS:
                    getattr(warm, kind)(texts5[5000:5008])
                table_a = _table_bytes(model_a.runner)
                live0 = quiesce(torch)
                REGISTRY.reset()
                reset_launches()
                timed_dispatchers(fleet, busy)

                def kill(send):
                    with prober.paused():
                        fleet.replica("r0").kill()
                        n = 0
                        while REGISTRY.counters.get("fleet/failovers", 0) < 1:
                            n += 1
                            if n > 50:
                                fail("fleet: 50 requests after the kill and no failover")
                            send("detect")
                    say("fleet", f"r0 killed at round {FLEET_KILL_ROUND}: {n} request(s) until "
                        "the first failover")

                def revive(send):
                    wait_until("fleet: an ejection",
                               lambda: REGISTRY.counters.get("fleet/ejections", 0) >= 1)
                    fleet.replica("r0").revive()
                    timed_dispatchers(fleet, busy)
                    s = wait_until("fleet: three eligible replicas",
                                   lambda: len(fleet.router.eligible()) == 3)
                    say("fleet", f"r0 revived; three replicas eligible after {s:.2f}s")

                def swap(send):
                    ServeClient(*front.address).swap(dir_b)

                actions = {(0, FLEET_KILL_ROUND): ("kill", kill),
                           (0, FLEET_REVIVE_ROUND): ("revive", revive),
                           (0, FLEET_SWAP_ROUND): ("swap", swap)}
                records, wall, action_ms = fleet_load(ServeClient, front.address, texts, actions)
                busy_main = dict(busy)
                launches = read_launches()
                counters = dict(REGISTRY.counters)
                hist = REGISTRY.snapshot()["histograms"]["fleet/request_s"]
                table_b = _table_bytes(fleet.replicas[0].registry.peek().runner)
                live1 = quiesce(torch)
                t0 = time.perf_counter()
                if warm.rollback() != "v1":
                    fail("fleet: the rollback did not land on v1")
                rollback_ms = (time.perf_counter() - t0) * 1e3
                live2 = quiesce(torch)
                # Steady traffic, no kill and no swap, in turns: the fleet
                # through the router, then replica r0 alone on its own port.
                # Each leg sends documents no replica has cached.
                steady = {}
                for k, (leg, address) in enumerate((
                        ("fleet", front.address), ("r0 alone", fleet.replica("r0").address),
                        ("fleet again", front.address))):
                    busy.clear()
                    recs, w, _ = fleet_load(ServeClient, address,
                                            texts5[3000 + 700 * k:3700 + 700 * k], {})
                    serve_check(f"fleet steady ({leg})",
                                [(k, sub, ans, meta) for _, k, sub, ans, meta in recs],
                                {"v1": ref_a}, exact=True)
                    steady[leg] = (len(recs) / w, dict(busy), w)
                scrapes = {rep.name: ServeClient(*rep.address).telemetryz()
                           for rep in fleet.replicas}
                for name, snap in scrapes.items():
                    collector.record(name, snap)
                merged = collector.counter("serve/requests", include_local=False)
                per = [s["counters"].get("serve/requests", 0) for s in scrapes.values()]
                busy_note = serve_busy_share(torch, lambda: [
                    ServeClient(*front.address).detect(texts[i:i + FLEET_DOCS])
                    for i in range(0, 24 * FLEET_DOCS, FLEET_DOCS)])
        finally:
            prober.stop()
            fleet.close()
        builds_a, builds_b = builds.of(model_a), sum(
            v for k, v in builds.builds.items() if k not in (id(model_a), id(ref_a), id(ref_b)))

    n_docs = sum(len(sub) for _, _, sub, _, _ in records)
    say("fleet", f"{len(records)} requests ({n_docs} docs) from {FLEET_CLIENTS} clients in "
        f"{wall:.2f}s: {len(records) / wall:.1f} requests/s, {n_docs / wall:.0f} docs/s; "
        f"fleet/request_s p50 {hist['p50'] * 1e3:.2f} ms, p99 {hist['p99'] * 1e3:.2f} ms; swap "
        f"{action_ms['swap']:.0f} ms, rollback {rollback_ms:.0f} ms (client side); "
        f"{busy_note}; dispatcher threads busy "
        f"{ {k: f'{v / wall:.0%}' for k, v in sorted(busy_main.items())} } of the wall "
        f"(r0's two batchers, before the kill and after the revival, summed); launches "
        f"{launches} ({smi_line})")
    for leg, (rps, per_thread, w) in steady.items():
        say("fleet", f"steady, {FLEET_CLIENTS} clients x {FLEET_ROUNDS} rounds, {leg}: "
            f"{rps:.1f} requests/s over {w:.2f}s; dispatcher threads busy "
            f"{ {k: f'{v / w:.0%}' for k, v in sorted(per_thread.items())} } ({smi_line})")
    say("fleet", "counters " + str({k: counters.get(k, 0) for k in (
        "fleet/requests", "fleet/dispatches", "fleet/failovers", "fleet/ejections",
        "fleet/readmissions", "fleet/swaps", "fleet/replica_kernel_errors")}))
    if len(records) < FLEET_CLIENTS * FLEET_ROUNDS:
        fail(f"fleet: {FLEET_CLIENTS * FLEET_ROUNDS - len(records)} responses dropped")
    for name, want in (("fleet/failovers", 1), ("fleet/ejections", 1),
                       ("fleet/readmissions", 1)):
        if counters.get(name, 0) < want:
            fail(f"fleet: {name} is {counters.get(name, 0)}, expected at least {want}")
    served = sorted({m["version"] for *_, m in records})
    if served != ["v1", "v2"]:
        fail(f"fleet: versions served {served}, expected both v1 and v2")
    for c in range(FLEET_CLIENTS):
        stream = [m["version"] for cc, *_, m in records if cc == c]
        if "v2" in stream and "v1" in stream[stream.index("v2"):]:
            fail(f"fleet: client {c} saw v1 after its first v2 answer: {stream}")
    if launches["fused_detect"] <= 0 or launches["fused_segment"] <= 0:
        fail(f"fleet: answered without the fused kernels: {launches}")
    note = serve_check("fleet", [(k, sub, ans, meta) for _, k, sub, ans, meta in records],
                       {"v1": ref_a, "v2": ref_b}, exact=True)
    say("fleet", f"every answer equals the direct runner of the version that served it, {note}; "
        f"no client stream saw v1 after v2")
    say("fleet", f"runner builds: model A {builds_a} (the fleet's start, the rollback), model B "
        f"{builds_b} (the swap)")
    if builds_a != 2 or builds_b != 1:
        fail(f"fleet: runner builds A {builds_a}, B {builds_b}; expected one per distinct model "
             "per swap and rollback (2 and 1)")
    say("fleet", f"live CUDA tensor bytes: before the swap {live0}, after it {live1} (before "
        f"- table A {table_a} + table B {table_b} = {live0 - table_a + table_b}), after the "
        f"rollback {live2}")
    if live1 != live0 - table_a + table_b or live2 != live0:
        fail("fleet: the device tables held across the swap and rollback are not exactly "
             "one runner's per distinct model")
    say("fleet", f"collector: merged serve/requests {merged:.0f} = the sum of the three "
        f"replicas' scrapes {per} (one process: each scrape carries the process registry)")
    if merged != sum(per):
        fail(f"fleet: the collector merged {merged} serve/requests, the scrapes sum {sum(per)}")
    return launches, (dir_a, dir_b, ref_a)


def phase_storm(torch, dev, dirs, texts5, smi_line) -> dict:
    """The storm drill at config 5 behind the router's HTTP front (phase 19
    of the module docstring). Returns the launches."""
    from spark_languagedetector_tpu_torch.resilience import faults
    from spark_languagedetector_tpu_torch.resilience.faults import FaultPlan
    from spark_languagedetector_tpu_torch.resilience.policy import RetryBudget
    from spark_languagedetector_tpu_torch.serve import (
        QuarantineTable, RouterServer, ServeClient, ServeFleet, ServeHTTPError, signature_of)
    from spark_languagedetector_tpu_torch.telemetry import REGISTRY

    dir_a, _, ref = dirs
    docs = texts5[3000:3400]
    answered: list = []
    c = lambda name: REGISTRY.counters.get(name, 0)  # noqa: E731
    with tempfile.TemporaryDirectory(prefix="storm_smoke_") as tmp:
        dlq_path = f"{tmp}/quarantine_dlq.jsonl"
        fleet = ServeFleet.from_path(dir_a, replicas=3, device=str(dev), router_kw=dict(
            probe_interval_ms=40.0, breaker_threshold=2, breaker_cooldown_s=0.3,
            probe_timeout_s=2.0, drain_timeout_s=5.0, deadline_floor_ms=5.0,
            retry_budget=RetryBudget(0.2, 10.0, name="storm"),
            quarantine=QuarantineTable(2, dlq_path=dlq_path, name="storm"),
            hedge_enable=False, hedge_quantile=0.05, hedge_min_ms=STORM_HEDGE_MIN_MS,
        ), max_wait_ms=4, max_rows=64, max_queue_rows=512)
        fleet.start(probe=False)
        router = fleet.router
        REGISTRY.reset()
        reset_launches()
        try:
            with RouterServer(router, fleet=fleet, port=0) as front:
                client = ServeClient(*front.address)

                def ask(texts, **kw):
                    try:
                        got, meta = client.detect(texts, **kw)
                    except ServeHTTPError as e:
                        return ("http", e.status, bool(e.payload.get("quarantined")),
                                e.retry_after_s > 0)
                    answered.append((texts, got))
                    return ("ok", meta["replica"])

                def readmit():
                    for h in router._handles:
                        h.breaker._opened_at -= 10.0  # the cooldown, elapsed
                    router.probe_once()
                    return router.eligible()

                # Leg 1: the query of death.
                poison = [f"query of death {i} ☠" for i in range(4)]
                fleet.replica("r0").kill()
                first = [ask(poison), ask(poison)]
                q = router.quarantine.describe()
                before = c("fleet/dispatches")
                third = ask(poison)
                dispatched = c("fleet/dispatches") - before
                control = ask(docs[:4])
                subfloor = ask(docs[:4], deadline_ms=2.0)
                fleet.replica("r0").revive()
                back = readmit()
                say("storm", f"leg 1: poison answered {first} (r0 dead), quarantined "
                    f"{q['quarantined']} after {q['deaths_threshold']} deaths; third send "
                    f"{third} with {dispatched} dispatches; control {control}; deadline 2 ms "
                    f"under the 5 ms floor {subfloor} ({c('fleet/deadline_rejects')} deadline "
                    f"rejects); DLQ {len(router.quarantine.dlq)} row(s)")
                if first != [("ok", "r1"), ("ok", "r1")] or q["quarantined"] != [
                        signature_of(poison)]:
                    fail("storm: the poison batch was not quarantined after exactly 2 deaths")
                if third != ("http", 422, True, False) or dispatched != 0:
                    fail(f"storm: the quarantined send answered {third} after {dispatched} "
                         "dispatches, expected a 422 before any")
                if len(router.quarantine.dlq) != 1 or Path(dlq_path).read_text().count(
                        "\n") != 1:
                    fail("storm: the quarantined request is not in the serve DLQ")
                if control[0] != "ok" or subfloor[:2] != ("http", 504):
                    fail(f"storm: control {control}, sub-floor deadline {subfloor}")
                if back != ["r0", "r1", "r2"]:
                    fail(f"storm: r0 not re-admitted after leg 1: {back}")
                # Leg 2: an outage under RetryBudget(burst=1).
                router.retry_budget = RetryBudget(0.05, 1.0, name="storm-outage")
                base = c("fleet/dispatches")
                fleet.replica("r0").kill()
                outcomes = [ask(docs[i * 3:i * 3 + 3]) for i in range(16)]
                dispatches = c("fleet/dispatches") - base
                budget = router.retry_budget.describe()
                bound = len(outcomes) * (1 + 0.05) + 1.0
                fleet.replica("r0").revive()
                back = readmit()
                say("storm", f"leg 2: 16 requests with r0 dead: {sum(o[0] == 'ok' for o in outcomes)}"
                    f" answered, {outcomes.count(('http', 503, False, True))} shed by the budget; "
                    f"{dispatches} dispatches (bound {bound:.2f}); budget {budget}")
                if budget["spent"] != 1 or budget["denied"] < 1 or dispatches > bound:
                    fail(f"storm: the retry budget granted {budget['spent']} and denied "
                         f"{budget['denied']} failovers over {dispatches} dispatches")
                if sum(o[0] == "ok" for o in outcomes) < len(outcomes) - 1 or back != [
                        "r0", "r1", "r2"]:
                    fail(f"storm: leg 2 outcomes {outcomes}, eligible {back}")
                # Leg 3: the same straggler plan, hedging off then on.
                router.retry_budget = RetryBudget(0.5, 10.0, name="storm-hedge")
                plan = f"seed=11;fleet/dispatch:delay={STORM_STRAGGLE_S}@2,5"

                def leg3():
                    lats = []
                    with faults.plan_scope(FaultPlan.parse(plan)):
                        for i in range(8):
                            t0 = time.perf_counter()
                            out = ask(docs[100 + 4 * i:104 + 4 * i])
                            lats.append(time.perf_counter() - t0)
                            if out[0] != "ok":
                                fail(f"storm: leg 3 request answered {out}")
                    return np.asarray(lats)

                lat_off = leg3()
                router.hedge_enable = True
                hedges0 = c("fleet/hedges")
                lat_on = leg3()
                hedges = c("fleet/hedges") - hedges0
                # The hedges' losers still sleep in their injected delay;
                # their admissions would count in leg 4's plan.
                wait_until("storm: the hedges' losers", lambda: not any(
                    router.outstanding(h.name) for h in router._handles))
                p99_off, p99_on = np.percentile(lat_off, 99), np.percentile(lat_on, 99)
                say("storm", f"leg 3: {STORM_STRAGGLE_S:.1f} s stragglers at dispatches 2 and 5 "
                    f"of 8: p99 {p99_off * 1e3:.1f} ms unhedged, {p99_on * 1e3:.1f} ms hedged "
                    f"(p50 {np.median(lat_off) * 1e3:.1f} / {np.median(lat_on) * 1e3:.1f} ms); "
                    f"{hedges} hedges, {c('fleet/hedge_wins')} wins ({smi_line})")
                if not (p99_on < p99_off and lat_on.max() < STORM_STRAGGLE_S and hedges >= 1):
                    fail("storm: hedging did not cut the stragglers' tail")
                # Leg 4: overload with a drained budget.
                drained = RetryBudget(0.05, 1.0, name="storm-overload")
                drained.try_spend(reason="storm_drain")
                router.retry_budget = drained
                hedges0 = c("fleet/hedges")
                with faults.plan_scope(FaultPlan.parse(
                        f"seed=13;fleet/dispatch:delay={STORM_STRAGGLE_S}@2;"
                        "serve/admit:error@1,3,4")):
                    outcomes = [ask(docs[200 + 3 * i:203 + 3 * i]) for i in range(6)]
                hedges = c("fleet/hedges") - hedges0
                say("storm", f"leg 4: stragglers and admission sheds with a drained budget: "
                    f"{outcomes}; hedges {hedges}")
                if hedges != 0 or not all(o[0] == "ok" or o[1:] == (503, False, True)
                                          for o in outcomes):
                    fail("storm: under overload a hedge fired or a request was neither "
                         "answered nor shed with Retry-After")
        finally:
            fleet.close()
    launches = read_launches()
    names = ref.profile.languages
    for texts, got in answered:
        want = [names[i] for i in ref.runner.predict_ids([t.encode() for t in texts])]
        if got != want:
            fail("storm: an answered request differs from the direct runner")
    say("storm", f"{len(answered)} answered requests, every one the direct runner's labels; "
        f"launches {launches}")
    if launches["fused_detect"] <= 0:
        fail("storm: answered without fused_detect")
    return launches


def zoo_tenant_models(case5: FitCase, n: int):
    """``n`` tenants fitted with fitBackend='device', each on its own seeded
    ZOO_SUBSAMPLE of phase 4's training documents."""
    from spark_languagedetector_tpu_torch import Table

    det = case5.det.copy({"fitBackend": "device"})
    labels = case5.table.column("lang").tolist()
    texts = case5.table.column("fulltext").tolist()
    models = []
    for t in range(n):
        keep = np.sort(np.random.default_rng(700 + t).choice(
            len(texts), int(len(texts) * ZOO_SUBSAMPLE), replace=False))
        models.append(det.fit(Table({"lang": [labels[i] for i in keep],
                                     "fulltext": [texts[i] for i in keep]})))
    return det, models


def phase_zoo(torch, dev, case5: FitCase, texts5, smi_line):
    """The model zoo at the config-5 spec (phase 20 of the module
    docstring). Returns the launches, the tenants' models, their direct
    runners' answers on the request pool and the ``zoo/cold_load_s``
    histogram (phase 22 reruns the traffic with the tenants baked)."""
    import threading

    from spark_languagedetector_tpu_torch import Table
    from spark_languagedetector_tpu_torch.serve import ServeClient, ServeHTTPError, ServingServer
    from spark_languagedetector_tpu_torch.telemetry import REGISTRY
    from spark_languagedetector_tpu_torch.zoo import ModelZoo, TenantQuota
    from spark_languagedetector_tpu_torch.zoo.zoo import _table_bytes

    live_start = quiesce(torch)
    t0 = time.perf_counter()
    det, models = zoo_tenant_models(case5, ZOO_TENANTS + 1)
    tenants = [f"t{i:02d}" for i in range(ZOO_TENANTS)]
    by_name = dict(zip(tenants + ["noisy"], models))
    pool = texts5[4000:4400]
    pool_docs = [t.encode() for t in pool]
    refs = {}
    for name, m in by_name.items():
        refs[name, "v1"] = (m.runner.score(pool_docs), m.runner.predict_ids(pool_docs))
        table = _table_bytes(m.runner)
        m.release_runner()
    fit_s = time.perf_counter() - t0
    for a in range(len(tenants)):
        for b in range(a):
            if np.array_equal(refs[tenants[a], "v1"][0], refs[tenants[b], "v1"][0]):
                fail(f"zoo: tenants {tenants[a]} and {tenants[b]} score alike")
    say("zoo", f"{len(models)} tenants fitted on the card (fitBackend='device', a seeded "
        f"{ZOO_SUBSAMPLE:.0%} of phase 4's {len(case5.table)} docs each) and scored on "
        f"{len(pool)} docs in {fit_s:.1f}s: f32 scores pairwise distinct; one tenant's device "
        f"tables {table / 1e6:.1f} MB")
    live0 = quiesce(torch)
    zoo = ModelZoo(device=str(dev), resident_bytes=3 * table, max_wait_ms=4, max_rows=256,
                   max_queue_rows=1024)
    for name in tenants:
        zoo.add_tenant(name, by_name[name])
    zoo.add_tenant("noisy", by_name["noisy"], quota=TenantQuota(max_queue_rows=8))
    busy_evictions = []
    real_evict = zoo._evict_locked

    def watched_evict(name):
        rt = zoo._entries[name].runtime
        stats = rt.batcher.stats()
        if rt.registry.busy() or stats["queued_rows"] or stats["inflight_rows"]:
            busy_evictions.append(name)
        return real_evict(name)

    zoo._evict_locked = watched_evict
    REGISTRY.reset()
    reset_launches()
    records, errors, burst, refit = [], [], [], {}
    lock = threading.Lock()
    barrier = threading.Barrier(ZOO_CLIENTS)
    refit_batches = [Table({"lang": case5.table.column("lang").tolist()[i:i + REFIT_BATCH],
                            "fulltext": case5.table.column("fulltext").tolist()[i:i + REFIT_BATCH]})
                     for i in range(0, 4 * REFIT_BATCH, REFIT_BATCH)]
    with ServingServer(zoo, port=0) as server:
        def burst_noisy():
            def one(k):
                try:
                    ServeClient(*server.address).detect(pool[k * 48:(k + 1) * 48],
                                                        tenant="noisy", priority="bulk")
                    out = "ok"
                except ServeHTTPError as e:
                    out = "shed" if e.status == 503 and e.shed and e.retry_after_s > 0 else repr(e)
                with lock:
                    burst.append(out)

            threads = [threading.Thread(target=one, args=(k,)) for k in range(5)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

        def do_refit():
            t0 = time.perf_counter()
            ar = zoo.auto_refit("t00", det, refit_every_batches=4, final_refit=False)
            progress = ar.run(refit_batches)
            refit.update(version=zoo.version("t00"), model=ar.last_model, refits=progress.refits,
                         s=time.perf_counter() - t0)
            del ar

        def work(ci):
            crng = np.random.default_rng(900 + ci)
            client = ServeClient(*server.address)
            barrier.wait(timeout=60)
            for r in range(ZOO_ROUNDS):
                if ci == 0 and r == ZOO_BURST_ROUND:
                    burst_noisy()
                if ci == 0 and r == ZOO_REFIT_ROUND:
                    do_refit()
                tenant = tenants[int(crng.integers(len(tenants)))]
                lo = int(crng.integers(0, len(pool) - ZOO_DOCS))
                kind = ("score", "detect")[(ci + r) % 2]
                try:
                    out, meta = getattr(client, kind)(pool[lo:lo + ZOO_DOCS], tenant=tenant)
                except Exception as e:
                    errors.append(f"client {ci} round {r} [{tenant}]: {e!r}")
                    return
                with lock:
                    records.append((tenant, kind, lo, out, meta))

        threads = [threading.Thread(target=work, args=(ci,)) for ci in range(ZOO_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        launches = read_launches()
        counters = dict(REGISTRY.counters)
        snap = REGISTRY.snapshot()
        cold = snap["histograms"].get("zoo/cold_load_s", {})
        gauge = snap["gauges"]["langdetect_zoo_resident_bytes"][""]
        resident = zoo.resident()
        live1 = quiesce(torch)
        health = zoo.healthz()
        versions = {t: zoo.version(t) for t in tenants + ["noisy"]}
        warm = list(resident)
        busy_note = serve_busy_share(torch, lambda: [
            ServeClient(*server.address).score(pool[i:i + ZOO_DOCS],
                                               tenant=warm[(i // ZOO_DOCS) % len(warm)])
            for i in range(0, 24 * ZOO_DOCS, ZOO_DOCS)])
    zoo.close()
    live2 = quiesce(torch)

    if errors:
        fail(f"zoo: {len(errors)} requests not answered: {errors[:3]}")
    cold_reloads = sum(max(0, b["loads"] - 1) for b in health["tenants"].values())
    say("zoo", f"{len(records)} requests from {ZOO_CLIENTS} clients over {len(tenants)} tenants "
        f"in {wall:.2f}s: {len(records) / wall:.1f} requests/s; zoo/cold_load_s p50 "
        f"{cold.get('p50', 0) * 1e3:.1f} ms, p99 {cold.get('p99', 0) * 1e3:.1f} ms over "
        f"{cold.get('count', 0)} loads; {counters.get('zoo/evictions', 0)} evictions, "
        f"{cold_reloads} cold reloads; {busy_note}; launches {launches} ({smi_line})")
    if counters.get("zoo/cross_tenant_rejects", 0):
        fail("zoo: a cross-tenant runtime was refused")
    if counters.get("zoo/evictions", 0) < 1 or cold_reloads < 1:
        fail("zoo: no eviction or no cold reload under a three-tenant byte budget")
    if busy_evictions:
        fail(f"zoo: leased or busy tenants evicted: {busy_evictions}")
    victims = {t: counters.get(f"zoo/shed/{t}", 0) for t in tenants}
    say("zoo", f"noisy burst: {burst}; zoo/shed/noisy {counters.get('zoo/shed/noisy', 0)}, every "
        f"other tenant's {sum(victims.values())}")
    if (burst.count("shed") < 1 or any(o not in ("ok", "shed") for o in burst)
            or any(victims.values())):
        fail(f"zoo: the noisy burst shed {burst}, victims {victims}")
    moved = {t: v for t, v in versions.items() if v != "v1"}
    if moved != {"t00": "v2"} or refit.get("refits") != 1:
        fail(f"zoo: the refit moved {moved} ({refit.get('refits')} refits), expected t00 only")
    scratch = det.fit(Table({"lang": [x for b in refit_batches for x in b.column("lang").tolist()],
                             "fulltext": [x for b in refit_batches
                                          for x in b.column("fulltext").tolist()]}))
    sp, fp = refit["model"].profile, scratch.profile
    if not (np.array_equal(sp.ids, fp.ids) and np.array_equal(sp.weights, fp.weights)):
        fail("zoo: t00's refit profile differs from a from-scratch device fit of its 1,760 docs")
    say("zoo", f"refit of t00 over 4 x {REFIT_BATCH} docs in {refit['s']:.1f}s: served "
        f"{refit['version']}, profile bit for bit a from-scratch device fit; no other tenant "
        "moved")
    by_name["t00@v2"] = refit["model"]
    refs["t00", "v2"] = (refit["model"].runner.score(pool_docs),
                         refit["model"].runner.predict_ids(pool_docs))
    refit["model"].release_runner()
    names = models[0].profile.languages
    for tenant, kind, lo, out, meta in records:
        if meta.get("tenant") != tenant:
            fail(f"zoo: a request to {tenant} was answered by {meta.get('tenant')}")
        want_s, want_l = refs[tenant, meta["version"]]
        if kind == "score":
            if not np.array_equal(out, want_s[lo:lo + ZOO_DOCS]):
                fail(f"zoo: {tenant} {meta['version']} scores differ from its direct runner")
            for (other, v), (s, _) in refs.items():
                if other != tenant and np.array_equal(out, s[lo:lo + ZOO_DOCS]):
                    fail(f"zoo: an answer of {tenant} equals {other} {v}'s")
        elif out != [names[i] for i in want_l[lo:lo + ZOO_DOCS]]:
            fail(f"zoo: {tenant} {meta['version']} labels differ from its direct runner")
    say("zoo", f"every answer is its own tenant's direct runner for the version that answered, "
        f"bit for bit, and no /score answer equals another tenant's")
    say("zoo", f"resident at the end {list(resident)}: zoo/resident_bytes {gauge:.0f}, live CUDA "
        f"tensor bytes above the zoo's start {live1 - live0} (before the zoo {live0}, at the "
        f"start of the phase {live_start}); after close {live2}")
    if gauge != sum(resident.values()) or live1 - live0 != gauge:
        fail("zoo: zoo/resident_bytes is not the resident tenants' live table bytes")
    if abs(live2 - live0) > 0:
        fail(f"zoo: {live2 - live0} B of CUDA tensors outlived zoo.close()")
    return launches, {"models": {t: by_name[t] for t in tenants}, "refs": refs, "cold": cold,
                      "budget": 3 * table}


# ------------------------------------------------------------ observe ------
OBSERVE_SLO_REQUESTS = 10  # requests per leg of the SLO drill
OBSERVE_KERNELS = ("fused_detect", "fused_segment", "row_hist", "bigram_hist")


@contextlib.contextmanager
def env_set(**values):
    """Set environment variables for the block, then restore them."""
    import os

    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def telemetry_capture(path):
    """The registry, reset, with a JSONL sink on ``path``; a snapshot is
    flushed into it when the block ends."""
    from spark_languagedetector_tpu_torch.telemetry import REGISTRY
    from spark_languagedetector_tpu_torch.telemetry.export import JsonlSink

    REGISTRY.reset()
    sink = JsonlSink(str(path))
    REGISTRY.add_sink(sink)
    try:
        yield REGISTRY
        REGISTRY.flush()
    finally:
        REGISTRY.remove_sink(sink)
        sink.close()


def trace_kernel_ms(trace_dir) -> dict[str, list[float]]:
    """Each port kernel's launches (ms each) in the Chrome traces under
    ``trace_dir``, found by name among the profiler's kernel events."""
    from spark_languagedetector_tpu_torch.ops._kernels import KERNELS

    out: dict[str, list[float]] = {}
    for f in sorted(Path(trace_dir).rglob("trace.json")):
        for ev in json.loads(f.read_text())["traceEvents"]:
            if ev.get("cat") != "kernel":
                continue
            for k in KERNELS:
                if k.name in str(ev.get("name", "")):
                    out.setdefault(k.name, []).append(float(ev.get("dur", 0.0)) / 1e3)
    return out


def roofline_shares(what: str, summary: dict) -> dict[str, float]:
    """Every fenced stage's bytes and flops utilization, each gated in
    (0, 1.05]: more than the peak means the cost model is wrong."""
    shares = {}
    for path, entry in sorted(summary.items()):
        if "device_mean" not in entry:
            continue
        for key in ("bytes_utilization", "flops_utilization"):
            if key in entry:
                v = entry[key]
                if not 0.0 < v <= 1.05:
                    fail(f"observe: {what} {path} {key} = {v} is outside (0, 1.05]")
                shares[f"{path} {key.split('_')[0]}"] = v
    if not shares:
        fail(f"observe: {what}: no fenced roofline share in stage_summary()")
    return shares


def min_nesting_slack(flows) -> tuple[float, int]:
    """The least slack by which a span lies inside a span of its parent
    path in the same request flow (the clock-aligned starts and ends of
    ``stitch.trace_flows``), and the number of spans checked."""
    least, checked = float("inf"), 0
    for spans in flows.values():
        by_path: dict[str, list] = {}
        for s in spans:
            by_path.setdefault(s["path"], []).append(s)
        for s in spans:
            parents = by_path.get(s["path"].rsplit("/", 1)[0]) if "/" in s["path"] else None
            if not parents:
                continue
            end = s["start_s"] + s["wall_s"]
            least = min(least, max(min(s["start_s"] - p["start_s"],
                                       p["start_s"] + p["wall_s"] - end) for p in parents))
            checked += 1
    return least, checked


def observe_capture(torch, what: str, model, texts, want_ids, tmp, kernels) -> dict:
    """One transform of ``texts`` by a fresh runner of ``model`` under a
    JSONL capture, a profiler trace per score call and fenced spans; gated
    on its labels, its trace, its cost gauges and its roofline shares."""
    from spark_languagedetector_tpu_torch import Table

    fresh = model.copy()  # a runner of its own: its first call records the cost
    cap = Path(tmp) / f"{what}.jsonl"
    trace_dir = Path(tmp) / f"trace_{what}"
    langs = list(model.profile.languages)
    with env_set(LANGDETECT_TELEMETRY_FENCE="1", LANGDETECT_TRACE_DIR=str(trace_dir)):
        reset_launches()
        with telemetry_capture(cap) as reg:
            t0 = time.perf_counter()
            pred = fresh.transform(Table({"fulltext": texts})).column("lang").tolist()
            wall = time.perf_counter() - t0
            runner = fresh.runner
            runner._cost_thread.join()
            if runner._cost_error is not None:
                fail(f"observe: {what}: the cost gauges failed: {runner._cost_error!r}")
            launches = read_launches()
            summary = reg.stage_summary()
            gauges = reg.snapshot()["gauges"]
    idx = {l: i for i, l in enumerate(langs)}
    ids = np.asarray([idx[l] for l in pred])
    if not np.array_equal(ids, want_ids):
        fail(f"observe: {what}: {int((ids != want_ids).sum())} labels differ from the phase's")
    for k in kernels:
        if launches[k] <= 0:
            fail(f"observe: {what}: {k} was not launched")
    traced = trace_kernel_ms(trace_dir)
    if not list(trace_dir.rglob("trace.json")):
        fail(f"observe: {what}: no Chrome trace under {trace_dir}")
    for k in kernels:
        if not traced.get(k):
            fail(f"observe: {what}: the Chrome trace names no {k} kernel")
    for gauge in ("program_flops", "program_bytes_accessed"):
        for program in ("score/dispatch",) + (("score/fused",) if runner.strategy == "fused"
                                              else ()):
            if not gauges.get(gauge, {}).get(f"program={program}", 0) > 0:
                fail(f"observe: {what}: {gauge}{{program={program}}} is not set")
    tb = gauges.get("langdetect_table_bytes", {})
    if list(tb.values()) != [float(runner.table_bytes())]:
        fail(f"observe: {what}: langdetect_table_bytes {tb} is not runner.table_bytes() "
             f"{runner.table_bytes()}")
    shares = roofline_shares(what, summary)
    d = summary["score/dispatch"]
    say("observe", f"{what}: {len(texts)} docs ({runner.strategy}) under the trace, fenced, in "
        f"{wall:.2f}s; labels bit for bit the phase's; launches "
        f"{ {k: launches[k] for k in kernels} }; table {runner.table_bytes()} B; score/dispatch "
        f"{d['count']} calls, device mean {d['device_mean'] * 1e3:.3f} ms, model "
        f"{d['est_flops_per_call'] / 1e9:.3f} GFLOP and {d['est_bytes_per_call'] / 1e6:.1f} MB "
        f"per call")
    say("observe", f"{what}: roofline shares (fenced, analytic model, claiming nothing): "
        + ", ".join(f"{k} {v:.4%}" for k, v in shares.items()))
    return {"capture": cap, "launches": launches, "traced": traced, "shares": shares,
            "runner": runner}


def slo_drill(torch, dev, model5, texts5) -> None:
    """Three replicas of phase 4's model behind the router front with an
    SloEvaluator: a kill sheds (one dispatch attempt), the availability
    objective burns and /healthz carries its reason; after a revival and a
    clean leg it clears. Time moves through ingest(now=) and a fake breaker
    clock, never through sleeps."""
    from spark_languagedetector_tpu_torch.serve import (
        QuarantineTable, RouterServer, ServeClient, ServeFleet, ServeOverloaded)
    from spark_languagedetector_tpu_torch.telemetry import REGISTRY
    from spark_languagedetector_tpu_torch.telemetry.aggregate import FleetCollector
    from spark_languagedetector_tpu_torch.telemetry.slo import SloEvaluator

    class Clock:
        t = 1000.0

        def __call__(self):
            return self.t

    clock = Clock()
    REGISTRY.reset()
    fleet = ServeFleet([model5] * 3, device=str(dev), max_wait_ms=4, router_kw=dict(
        dispatch_attempts=1, breaker_threshold=2, breaker_cooldown_s=30.0, clock=clock,
        quarantine=QuarantineTable(0, name="observe-slo"))).start(probe=False)
    slo = SloEvaluator(short_window_s=10.0, long_window_s=30.0)
    collector = FleetCollector()
    docs = texts5[:8]
    steps = []
    try:
        with RouterServer(fleet.router, fleet=fleet, port=0, collector=collector, slo=slo) as front:
            client = ServeClient(*front.address)

            def leg(now: float) -> tuple[int, int]:
                shed = 0
                for _ in range(OBSERVE_SLO_REQUESTS):
                    try:
                        fleet.router.detect(docs)
                    except ServeOverloaded:
                        shed += 1
                slo.ingest(collector.aggregate(), now=now)
                health = client.healthz()
                if health["slo"] != slo.status():
                    fail("observe: /healthz's slo block is not the evaluator's status")
                reasons = [r for r in health.get("reasons", []) if r.startswith("slo_")]
                steps.append((now, shed, health["slo"]["burning"], reasons))
                return shed, len(reasons)

            leg(0.0)
            fleet.replica("r0").kill()
            shed, _ = leg(1.0)
            if shed < 1:
                fail("observe: the kill shed nothing with one dispatch attempt")
            fleet.replica("r0").revive()
            clock.t += 31.0  # past the breaker cooldown: the half-open probe re-admits
            fleet.router.probe_once()
            if "r0" not in fleet.router.eligible():
                fail("observe: r0 was not re-admitted after its revival")
            leg(20.0)
    finally:
        fleet.close()
    burning = [s for s in steps if s[2]]
    if [s[2] for s in steps] != [False, True, False] or burning[0][3] != ["slo_availability_burn"]:
        fail(f"observe: the SLO did not trip on the kill and clear after the revival: {steps}")
    say("observe", "SLO drill (now, shed, burning, /healthz slo reasons): "
        + "; ".join(str(s) for s in steps)
        + f"; slo/alerts {REGISTRY.snapshot()['counters'].get('slo/alerts')}")


def phase_observe(torch, dev, model5, texts5, ids5, case3: FitCase, case5: FitCase, tmp,
                  smi_line) -> dict[str, int]:
    """Phase 21: the telemetry's read side, device gauges, the cost model,
    the profiler trace, the shape tuner and the NaN checks on the card.
    Returns the kernels' launches."""
    import os

    from spark_languagedetector_tpu_torch import Table
    from spark_languagedetector_tpu_torch.api.runner import BatchRunner
    from spark_languagedetector_tpu_torch.exec import config as exec_config
    from spark_languagedetector_tpu_torch.exec import tune
    from spark_languagedetector_tpu_torch.ops import _kernels
    from spark_languagedetector_tpu_torch.telemetry import REGISTRY, compare, report, stitch
    from spark_languagedetector_tpu_torch.telemetry.gauges import sample_device_gauges
    from spark_languagedetector_tpu_torch.utils.debug import nan_checks

    total = dict.fromkeys(OBSERVE_KERNELS, 0)
    c5 = observe_capture(torch, "config5", model5, texts5, ids5, tmp, ("fused_detect",))
    c3 = observe_capture(torch, "config3", case3.model, case3.texts, case3.ids, tmp,
                         ("row_hist", "bigram_hist"))
    for c in (c5, c3):
        for k in total:
            total[k] += c["launches"][k]

    # Segment mode: the counters against the results.
    langs = list(model5.profile.languages)
    cs_docs, _ = make_codeswitch_corpus(langs, 60, seed=31)
    seg = model5.copy({"resultMode": "segment"})
    reset_launches()
    with telemetry_capture(Path(tmp) / "segment.jsonl") as reg:
        results = [json.loads(v) for v in
                   seg.transform(Table({"fulltext": cs_docs})).column("lang").tolist()]
        counters = reg.snapshot()["counters"]
        merge = reg.stage_summary().get("segment/merge", {}).get("count")
    total["fused_segment"] += read_launches()["fused_segment"]
    want = {"segment/docs": len(results), "segment/rejects": sum(r["rejected"] for r in results),
            "segment/spans": sum(len(r["spans"]) for r in results)}
    got = {k: counters.get(k, 0) for k in want}
    if got != want or merge != 1 or total["fused_segment"] <= 0:
        fail(f"observe: segment counters {got} (segment/merge spans {merge}, fused_segment "
             f"launches {total['fused_segment']}) against the results {want}")
    say("observe", f"segment: {len(cs_docs)} code-switched docs, counters {got} equal the "
        f"results, fused_segment launches {total['fused_segment']}")

    # Device gauges and the build cache.
    REGISTRY.reset()
    torch.cuda.synchronize()
    sampled = sample_device_gauges()
    stats = torch.cuda.memory_stats()
    in_use = sampled.get("device_bytes_in_use", {}).get("cuda:0")
    if in_use != float(stats["allocated_bytes.all.current"]):
        fail(f"observe: device_bytes_in_use {in_use} is not memory_stats()'s "
             f"{stats['allocated_bytes.all.current']}")
    if sampled["live_buffer_bytes"]["cuda:0"] != float(torch.cuda.memory_allocated(0)):
        fail("observe: live_buffer_bytes is not torch.cuda.memory_allocated()")
    gauge = REGISTRY.snapshot()["gauges"]["device_bytes_in_use"]['device=cuda:0']
    rebuilt = _kernels.build_all()
    counters = REGISTRY.snapshot()["counters"]
    if rebuilt or counters.get("compile_cache/hits") != len(_kernels.KERNELS) \
            or counters.get("compile_cache/misses"):
        fail(f"observe: a warm rebuild built {sorted(rebuilt)}, counters {counters}")
    say("observe", f"device gauges: device_bytes_in_use{{device=cuda:0}} {gauge:.0f} B = "
        f"memory_stats() allocated, live_buffer_bytes {sampled['live_buffer_bytes']['cuda:0']:.0f}"
        f" B, reserved {torch.cuda.memory_reserved(0)} B; warm rebuild: "
        f"compile_cache/hits {counters['compile_cache/hits']}, no miss")

    # The device fit's count cost (phase 11's fit).
    with env_set(LANGDETECT_TELEMETRY_FENCE="1"):
        REGISTRY.reset()
        case5.det.copy({"fitBackend": "device"}).fit(case5.table)
        fit_summary = REGISTRY.stage_summary()
        fit_gauges = REGISTRY.snapshot()["gauges"]
    for gauge in ("program_flops", "program_bytes_accessed"):
        if not fit_gauges.get(gauge, {}).get("program=fit/count", 0) > 0:
            fail(f"observe: the device fit set no {gauge}{{program=fit/count}}")
    fit_shares = roofline_shares("fit5", fit_summary)
    say("observe", "fit5 device fit roofline shares (fenced, claiming nothing): "
        + ", ".join(f"{k} {v:.4%}" for k, v in fit_shares.items() if k.startswith("fit/")))

    # The read side on the captures.
    def quiet(main, argv) -> int:
        """A CLI's exit code, its report kept off this script's output."""
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            return main(argv)

    events5 = report.load_events(str(c5["capture"]))
    text = report.render_report(events5)
    if "score" not in text or "counters (last snapshot):" not in text:
        fail("observe: the report did not render the config-5 capture")
    if quiet(compare.main, [str(c5["capture"]), str(c5["capture"])]) != 0:
        fail("observe: compare of the config-5 capture against itself did not exit 0")
    slow = Path(tmp) / "config5_slow.jsonl"
    with open(slow, "w") as fh:
        for ev in events5:
            if ev.get("event") == "telemetry.span" and ev["path"].startswith("score"):
                ev = {**ev, "wall_s": 2 * ev["wall_s"]}
                if isinstance(ev.get("device_s"), (int, float)):
                    ev["device_s"] = 2 * ev["device_s"]
            fh.write(json.dumps(ev) + "\n")
    if quiet(compare.main, [str(c5["capture"]), str(slow)]) != 1:
        fail("observe: compare against the x2-slow copy did not exit 1")
    stitched = Path(tmp) / "stitched.json"
    if quiet(stitch.main, [str(c5["capture"]), str(c3["capture"]), "-o", str(stitched)]) != 0:
        fail("observe: stitch of the config-5 and config-3 captures failed")
    trace_events = json.loads(stitched.read_text())["traceEvents"]
    captures = stitch.load_captures([str(c5["capture"]), str(c3["capture"])])
    slack, checked = min_nesting_slack(stitch.trace_flows(captures))
    if checked == 0 or slack < -2e-3:
        fail(f"observe: stitched spans do not nest in their parents (least slack {slack} s "
             f"over {checked} spans)")
    say("observe", f"read side: report {len(text.splitlines())} lines; compare self 0, x2 "
        f"copy 1; stitch {len(trace_events)} trace events, {checked} spans nested in their "
        f"parents, least slack {slack * 1e3:.3f} ms")

    slo_drill(torch, dev, model5, texts5)

    # The shape tuner on the config-5 capture.
    profile = tune.solve(events5)
    prof_path = Path(tmp) / "profile.json"
    profile.save(str(prof_path))
    with env_set(**{exec_config.PROFILE_ENV: str(prof_path)}):
        exec_config.reload_profile()
        try:
            tuned = model5.copy()
            reset_launches()
            pred = tuned.transform(Table({"fulltext": texts5})).column("lang").tolist()
            total["fused_detect"] += read_launches()["fused_detect"]
            buckets = tuned.runner.length_buckets
        finally:
            exec_config.reload_profile()
    idx = {l: i for i, l in enumerate(langs)}
    if buckets != tuple(profile.tuned["length_buckets"]) or not np.array_equal(
            np.asarray([idx[l] for l in pred]), ids5):
        fail(f"observe: the tuned runner (buckets {buckets}) did not give phase 4's labels")
    src = profile.source
    say("observe", f"tune: profile {profile.version}, length_buckets {list(buckets)}; padded "
        f"bytes {src['padded_bytes_default_lattice']} -> {src['padded_bytes_tuned_lattice']} "
        f"({src['predicted_padded_reduction']:.1%} fewer); labels bit for bit phase 4's")

    # nan_checks: a weight table with one NaN.
    r5 = model5.runner
    w = np.array(r5._host_weights)
    w[0, 0] = np.nan
    with nan_checks():
        try:
            BatchRunner(w, r5._host_lut, r5.spec, device=str(dev))
            fail("observe: a NaN weight table built a runner under nan_checks()")
        except ValueError as e:
            if "non-finite" not in str(e):
                raise
    plain_runner = BatchRunner(w, r5._host_lut, r5.spec, device=str(dev))
    plain_runner.predict_ids([t.encode() for t in texts5[:64]])
    say("observe", f"nan_checks: the NaN table raised ValueError inside, built and scored "
        f"outside")

    for what, c, names in (("config-5", c5, ("fused_detect",)),
                           ("config-3", c3, ("row_hist", "bigram_hist"))):
        say("observe", f"profiler trace, {what} (claiming nothing): " + "; ".join(
            f"{k} {len(c['traced'][k])} launches, mean {np.mean(c['traced'][k]):.4f} ms, min "
            f"{min(c['traced'][k]):.4f} ms" for k in names) + f"; {smi_line}")
    say("observe", "beside PERF.md's kernel table (CUDA events at each kernel's largest batch): "
        "fused_detect 0.3374-0.3378, row_hist 0.0894-0.0903, bigram_hist 0.0917-0.0927 ms")
    return total


# ------------------------------------------------------------ coldstart ----
COLD_PARTS = ("load", "membership", "fused_tables", "upload", "runner", "prewarm", "transform")
SCALE_BURST, SCALE_BURST_DOCS = 16, 16  # concurrent bulk requests against a 32-row queue
# Phase 23's three fleet forms serve with the score cache off, so a
# window may send a document twice and still reach the runner.
SCALE_CHILD_ENV = {"LANGDETECT_SERVE_MAX_WAIT_MS": "4", "LANGDETECT_SERVE_MAX_ROWS": "256",
                   "LANGDETECT_SERVE_QUEUE_ROWS": "1024", "LANGDETECT_CACHE_ENABLE": "0"}
SCALE_WINDOW_S = 3.0  # each fleet form's closed-loop window


def cold_load_child(spec_path: str) -> None:
    """``chip_smoke.py --cold-load SPEC``: phase 22's cold loads in this fresh
    process, each timed in its parts and followed by a transform of phase
    4's documents, compared with the parent's answers. The CUDA context, the
    pyarrow import and a warm-up (a baked load and its prewarm: the kernel
    libraries loaded and first launched) are timed apart first, so that
    every leg finds the process in the same state. Prints one JSON object."""
    sys.path.insert(0, str(ROOT))
    import torch

    from spark_languagedetector_tpu_torch import LanguageDetectorModel, Table
    from spark_languagedetector_tpu_torch.api import runner as runner_mod
    from spark_languagedetector_tpu_torch.artifacts import maybe_load_baked, prewarm_lattice
    from spark_languagedetector_tpu_torch.models.profile import GramProfile
    from spark_languagedetector_tpu_torch.ops import score_fused as SF
    from spark_languagedetector_tpu_torch.telemetry import REGISTRY

    spec = json.loads(Path(spec_path).read_text())
    dev = torch.device(spec["device"])
    if dev.type == "cuda" and not torch.cuda.is_available():
        fail("cold-load child: no CUDA card")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()
    texts = json.loads(Path(spec["texts"]).read_text())
    byte_docs = [t.encode() for t in texts]
    parts: dict[str, float] = {}

    def timed(name, fn, sync=False):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if sync:
                    sync_fn()
                parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
        return wrapper

    sync_fn = sync
    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    sync()
    out = {"cuda_init_s": time.perf_counter() - t0, "legs": []}
    # pyarrow's import apart from the first parquet parse (a mapped load
    # needs no pyarrow at all).
    t0 = time.perf_counter()
    import pyarrow.parquet  # noqa: F401

    out["pyarrow_import_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = maybe_load_baked(spec["warmup"]["path"], spec["warmup"]["artifact"], device=str(dev))
    prewarm_lattice(warm.runner)
    warm.release_runner()
    del warm
    sync()
    out["warmup_s"] = time.perf_counter() - t0
    out["warmup_launches"] = SF.FUSED_DETECT.launches
    GramProfile.device_membership = timed("membership", GramProfile.device_membership)
    SF.build_fused_tables = timed("fused_tables", SF.build_fused_tables)
    runner_mod.upload = timed("upload", runner_mod.upload, sync=True)
    if dev.type == "cpu":  # a CPU rehearsal counts the plain version's calls as launches
        plain = SF.fused_plain

        def counted(*a, **k):
            SF.FUSED_DETECT.launches += 1
            return plain(*a, **k)

        SF.fused_plain = counted
    for leg in spec["legs"]:
        parts.clear()
        SF.FUSED_DETECT.launches = 0
        baked0 = REGISTRY.counters.get("artifacts/baked_loads", 0)
        t0 = time.perf_counter()
        if leg["artifact"]:
            model = maybe_load_baked(leg["path"], leg["artifact"], device=str(dev))
            if model is None:
                fail(f"cold-load child: {leg['artifact']} did not load as a bake")
        else:
            model = LanguageDetectorModel.load(leg["path"], device=str(dev))
        parts["load"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        runner = model.runner
        sync()
        parts["runner"] = time.perf_counter() - t0
        parts["prewarm"] = prewarm_lattice(runner)["seconds"]
        t0 = time.perf_counter()
        labels = model.transform(Table({"fulltext": texts})).column("lang").tolist()
        scores = runner.score(byte_docs)
        sync()
        parts["transform"] = time.perf_counter() - t0
        idx = {name: i for i, name in enumerate(model.profile.languages)}
        ids = np.asarray([idx[name] for name in labels])
        out["legs"].append({
            "name": leg["name"], "baked": bool(leg["artifact"]),
            **{p: parts.get(p, 0.0) for p in COLD_PARTS},
            "baked_loads": REGISTRY.counters.get("artifacts/baked_loads", 0) - baked0,
            "strategy": runner.strategy, "launches": SF.FUSED_DETECT.launches,
            "scores_equal": bool(np.array_equal(scores, np.load(leg["ref_scores"]))),
            "labels_equal": bool(np.array_equal(ids, np.load(leg["ref_ids"]))),
        })
        del model, runner
    print(json.dumps(out))


def run_cold_loads(tmp, dev, name: str, legs: list, warmup: dict) -> dict:
    """Run ``legs`` in one fresh ``--cold-load`` process on ``dev`` after
    ``warmup`` (a leg's path and artifact); its result and wall seconds
    (interpreter start and imports included)."""
    spec = Path(tmp) / f"{name}.json"
    spec.write_text(json.dumps({"texts": f"{tmp}/texts.json", "legs": legs,
                                "warmup": warmup, "device": dev.type}))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--cold-load", str(spec)],
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"coldstart: the {name} process failed: {res.stderr[-3000:]}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    out["wall_s"] = wall
    return out


def capture_launches(paths) -> dict[str, int]:
    """Kernel launches of replica children as their kernels' wrappers
    counted them: each child process ends its ``--metrics-jsonl`` capture
    with a terminal ``telemetry.snapshot`` whose gauge
    ``langdetect_kernel_launches{kernel, stage}`` holds its launches before
    READY (``prewarm``) and after (``serve``). A process killed by a signal
    writes no snapshot and adds nothing. Fails if a capture holds no
    terminal snapshot, or a process that dispatched requests launched no
    kernel after READY."""
    out: dict[str, int] = {}
    for path in paths:
        terminal = 0
        for line in Path(path).read_text().splitlines():
            e = json.loads(line) if line else {}
            series = (e.get("gauges") or {}).get("langdetect_kernel_launches")
            if e.get("event") != "telemetry.snapshot" or not series:
                continue
            terminal += 1
            served = 0
            for key, n in series.items():
                labels = dict(kv.split("=", 1) for kv in key.split(","))
                out[labels["kernel"]] = out.get(labels["kernel"], 0) + int(n)
                served += int(n) if labels["stage"] == "serve" else 0
            dispatches = (e.get("counters") or {}).get("serve/dispatches", 0)
            if dispatches and not served:
                fail(f"a replica child made {dispatches} dispatches and no kernel launch "
                     f"({Path(path).name})")
        if not terminal:
            fail(f"a replica child's capture holds no terminal snapshot ({Path(path).name})")
    return out


def spawn_child(ProcessReplica, dev, name, path, artifact, cache, tmp, **kw):
    """One replica child on ``dev``'s type (the card, pinned by
    CUDA_VISIBLE_DEVICES) with a JSONL capture; its READY line read."""
    rep = ProcessReplica(name, path, device=dev.type, compile_cache_dir=cache, artifact=artifact,
                         metrics_jsonl=f"{tmp}/{name}.jsonl", env={"PYTHONPATH": str(ROOT)},
                         spawn_timeout_s=300.0, **kw)
    return rep.spawn()


def phase_coldstart(torch, dev, model5, texts5, ids5, zoo_state, tmp, smi_line):
    """The cold-start plane at config 5 (phase 22 of the module docstring).
    Returns the launches, the saved model directories and their bakes."""
    import os
    import shutil
    import threading

    from spark_languagedetector_tpu_torch import LanguageDetectorModel
    from spark_languagedetector_tpu_torch.artifacts import artifact_path_for, bake_model
    from spark_languagedetector_tpu_torch.artifacts.bake import BLOCKS_NAME
    from spark_languagedetector_tpu_torch.scale import ProcessReplica
    from spark_languagedetector_tpu_torch.serve import ModelRegistry, ServeClient, ServingServer
    from spark_languagedetector_tpu_torch.telemetry import REGISTRY
    from spark_languagedetector_tpu_torch.zoo import ModelZoo

    byte_docs = [t.encode() for t in texts5]
    dirs = {"f32": f"{tmp}/c5", "int16": f"{tmp}/c5_q16"}
    t0 = time.perf_counter()
    model5.save(dirs["f32"])
    model5.write().overwrite().quantized("int16").save(dirs["int16"])
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    arts = {"f32": bake_model(model5, artifact_path_for(dirs["f32"])),
            "int16": bake_model(model5, artifact_path_for(dirs["int16"]), quantize="int16")}
    bake_s = time.perf_counter() - t0
    sizes = {k: Path(a, BLOCKS_NAME).stat().st_size for k, a in arts.items()}
    say("coldstart", f"phase 4's model saved as parquet, f32 and int16 codec, in {save_s:.1f}s; "
        f"baked in {bake_s:.2f}s ({sizes['f32'] / 1e6:.1f} MB and {sizes['int16'] / 1e6:.1f} MB "
        "of blocks)")
    q16 = LanguageDetectorModel.load(dirs["int16"], device=str(dev))
    refs = {"f32": (model5.runner.score(byte_docs), np.asarray(ids5)),
            "int16": (q16.runner.score(byte_docs), np.asarray(ids5))}
    q16_ids = q16.runner.predict_ids(byte_docs)
    agree = float(np.mean(q16_ids == np.asarray(ids5)))
    say("coldstart", f"the int16 codec's labels agree with phase 4's on {agree:.5f} of "
        f"{len(byte_docs)} docs (int16 class: 1.0)")
    if agree < 1.0:
        fail("coldstart: the int16 codec's labels differ from phase 4's")
    q16.release_runner()
    del q16
    Path(tmp, "texts.json").write_text(json.dumps(list(texts5)))
    for k, (s, i) in refs.items():
        np.save(f"{tmp}/ref_{k}_scores.npy", s)
        np.save(f"{tmp}/ref_{k}_ids.npy", i)

    legs = [{"name": f"{'baked' if baked else 'parquet'} {k}", "path": dirs[k],
             "artifact": arts[k] if baked else None,
             "ref_scores": f"{tmp}/ref_{k}_scores.npy", "ref_ids": f"{tmp}/ref_{k}_ids.npy"}
            for k in ("f32", "int16") for baked in (False, True)]
    out = run_cold_loads(tmp, dev, "cold", legs, {"path": dirs["int16"], "artifact": arts["int16"]})
    child_launches = out["warmup_launches"]
    say("coldstart", f"fresh process: {out['wall_s']:.2f}s wall, CUDA context "
        f"{out['cuda_init_s'] * 1e3:.0f} ms, pyarrow import {out['pyarrow_import_s'] * 1e3:.0f} "
        f"ms, warm-up (baked int16 load and prewarm: the kernels loaded and first launched, "
        f"{out['warmup_launches']} fused_detect launches) {out['warmup_s'] * 1e3:.0f} ms before "
        f"the legs ({smi_line})")
    for leg in out["legs"]:
        child_launches += leg["launches"]
        say("coldstart", f"  {leg['name']}: " + ", ".join(
            f"{p} {leg[p] * 1e3:.1f} ms" for p in COLD_PARTS)
            + f" (runner = membership + fused tables + upload + the rest); "
            f"artifacts/baked_loads +{leg['baked_loads']}, fused_detect launches "
            f"{leg['launches']}")
        if not (leg["scores_equal"] and leg["labels_equal"]):
            fail(f"coldstart: {leg['name']}: the transform's scores or labels differ from "
                 "the reference bit for bit")
        if leg["strategy"] != "fused" or leg["launches"] <= 0:
            fail(f"coldstart: {leg['name']} did not score through fused_detect")
        if leg["baked_loads"] != leg["baked"]:
            fail(f"coldstart: {leg['name']} counted {leg['baked_loads']} baked loads")
    say("coldstart", "every cold load's transform of phase 4's 6,004 docs gives phase 4's "
        "labels and the reference scores bit for bit (f32: phase 4's; int16: the codec's "
        "parquet model in this process)")

    # A torn copy of the artifact: refused, counted, served from parquet.
    torn = f"{tmp}/torn"
    shutil.copytree(dirs["f32"], torn)
    shutil.copytree(arts["f32"], artifact_path_for(torn))
    blocks = artifact_path_for(torn) / BLOCKS_NAME
    with open(blocks, "r+b") as fh:
        fh.truncate(blocks.stat().st_size // 2)
    REGISTRY.reset()
    reg = ModelRegistry(device=str(dev))
    reg.load(torn)
    counters = dict(REGISTRY.counters)
    same = np.array_equal(reg.peek().runner.score(byte_docs), refs["f32"][0])
    reg.close()
    say("coldstart", f"torn artifact: artifacts/load_errors {counters.get('artifacts/load_errors', 0)}"
        f", artifacts/baked_loads {counters.get('artifacts/baked_loads', 0)}; served from "
        f"parquet, scores bit for bit phase 4's: {same}")
    if counters.get("artifacts/load_errors", 0) != 1 or counters.get("artifacts/baked_loads", 0):
        fail("coldstart: a torn artifact was not refused exactly once")
    if not same:
        fail("coldstart: the parquet load behind a torn artifact scores differently")

    # Two children, one after the other, on an empty build cache.
    cache = f"{tmp}/kernel_cache"
    os.makedirs(cache)
    platform = "gpu" if dev.type == "cuda" else dev.type
    children = []
    for i, want_mode in enumerate(("full", "sentinel")):
        rep = spawn_child(ProcessReplica, dev, f"cold{i}", dirs["f32"], arts["f32"], cache, tmp)
        try:
            client = ServeClient(*rep.address)
            labels, meta = client.detect(texts5[:64])
            scores, _ = client.score(texts5[64:128])
            counters = client.telemetryz()["counters"]
        finally:
            rep.stop()
        names = model5.profile.languages
        if (labels != [names[j] for j in ids5[:64]]
                or not np.array_equal(scores, refs["f32"][0][64:128])):
            fail(f"coldstart: child cold{i} answered differently from phase 4")
        children.append((rep, counters))
        say("coldstart", f"child cold{i}: READY in {rep.last_spawn_ready_s:.2f}s, warmup_s "
            f"{rep.last_warmup_s:.3f} (load + prewarm), prewarm_mode {rep.last_prewarm_mode}, "
            f"compile_cache/misses {counters.get('compile_cache/misses', 0)}, hits "
            f"{counters.get('compile_cache/hits', 0)}, platform {rep.last_ready['platform']}")
        if rep.last_prewarm_mode != want_mode or rep.last_ready["platform"] != platform:
            fail(f"coldstart: child cold{i} prewarmed {rep.last_prewarm_mode!r} on "
                 f"{rep.last_ready['platform']!r}, expected {want_mode!r} on {platform!r}")
    # Off the card a runner launches no kernel, so there is nothing to build.
    if dev.type == "cuda" and children[0][1].get("compile_cache/misses", 0) < 1:
        fail("coldstart: the first child on an empty cache built nothing")
    if children[1][1].get("compile_cache/misses", 0) != 0:
        fail("coldstart: the second child built a kernel the cache held")
    built = sorted(p.name for p in Path(cache).glob("lib*.so"))
    say("coldstart", f"the cache holds {built} and a manifest; warmup_s cold "
        f"{children[0][0].last_warmup_s:.3f} s, warm {children[1][0].last_warmup_s:.3f} s "
        f"({smi_line})")
    cold_child = capture_launches([f"{tmp}/cold{i}.jsonl" for i in range(2)])
    if cold_child["fused_detect"] <= 0:
        fail(f"coldstart: a child served with no launch: {cold_child}")

    # Phase 20's zoo traffic, the tenants baked (no parquet tree at all).
    zdir = f"{tmp}/zoo"
    t0 = time.perf_counter()
    for name, m in zoo_state["models"].items():
        bake_model(m, artifact_path_for(f"{zdir}/{name}"))
    say("coldstart", f"{len(zoo_state['models'])} zoo tenants baked in "
        f"{time.perf_counter() - t0:.1f}s")
    tenants = sorted(zoo_state["models"])
    pool = texts5[4000:4400]
    live0 = quiesce(torch)
    zoo = ModelZoo(device=str(dev), resident_bytes=zoo_state["budget"], max_wait_ms=4,
                   max_rows=256, max_queue_rows=1024)
    for name in tenants:
        zoo.add_tenant(name, path=f"{zdir}/{name}")
    REGISTRY.reset()
    reset_launches()
    records, errors, lock = [], [], threading.Lock()
    barrier = threading.Barrier(ZOO_CLIENTS)
    with ServingServer(zoo, port=0) as server:
        def work(ci):
            crng = np.random.default_rng(900 + ci)
            client = ServeClient(*server.address)
            barrier.wait(timeout=60)
            for r in range(ZOO_ROUNDS):
                tenant = tenants[int(crng.integers(len(tenants)))]
                lo = int(crng.integers(0, len(pool) - ZOO_DOCS))
                kind = ("score", "detect")[(ci + r) % 2]
                try:
                    out, meta = getattr(client, kind)(pool[lo:lo + ZOO_DOCS], tenant=tenant)
                except Exception as e:
                    errors.append(f"client {ci} round {r} [{tenant}]: {e!r}")
                    return
                with lock:
                    records.append((tenant, kind, lo, out, meta))

        threads = [threading.Thread(target=work, args=(ci,)) for ci in range(ZOO_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        zoo_launches = read_launches()["fused_detect"]
        counters = dict(REGISTRY.counters)
        snap = REGISTRY.snapshot()
        cold = snap["histograms"].get("zoo/cold_load_s", {})
        gauge = snap["gauges"]["langdetect_zoo_resident_bytes"][""]
        resident = zoo.resident()
        live1 = quiesce(torch)
    zoo.close()
    live2 = quiesce(torch)
    if errors:
        fail(f"coldstart zoo: {len(errors)} requests not answered: {errors[:3]}")
    names = zoo_state["models"][tenants[0]].profile.languages
    for tenant, kind, lo, out, meta in records:
        want_s, want_l = zoo_state["refs"][tenant, "v1"]
        if meta.get("tenant") != tenant:
            fail(f"coldstart zoo: a request to {tenant} was answered by {meta.get('tenant')}")
        if kind == "score" and not np.array_equal(out, want_s[lo:lo + ZOO_DOCS]):
            fail(f"coldstart zoo: {tenant}'s baked scores differ from its direct runner")
        if kind == "detect" and out != [names[i] for i in want_l[lo:lo + ZOO_DOCS]]:
            fail(f"coldstart zoo: {tenant}'s baked labels differ from its direct runner")
    old = zoo_state["cold"]
    loads = counters.get("zoo/cold_loads", 0)
    say("coldstart", f"zoo, tenants baked: {len(records)} requests in {wall:.2f}s "
        f"({len(records) / wall:.1f} requests/s); zoo/cold_load_s p50 "
        f"{cold.get('p50', 0) * 1e3:.1f} ms, p99 {cold.get('p99', 0) * 1e3:.1f} ms over "
        f"{cold.get('count', 0)} loads (phase 20, from the fitted models: p50 "
        f"{old.get('p50', 0) * 1e3:.1f} ms, p99 {old.get('p99', 0) * 1e3:.1f} ms over "
        f"{old.get('count', 0)}); artifacts/baked_loads {counters.get('artifacts/baked_loads', 0)}"
        f" of {loads} cold loads; every answer its tenant's direct runner bit for bit "
        f"({smi_line})")
    if loads < 1 or counters.get("artifacts/baked_loads", 0) != loads:
        fail("coldstart zoo: a cold load did not map its tenant's bake")
    say("coldstart", f"zoo/resident_bytes {gauge:.0f} = the resident tenants' device tables "
        f"{sum(resident.values())} = live CUDA bytes above the zoo's start {live1 - live0}; "
        f"after close {live2 - live0}")
    if gauge != sum(resident.values()) or live1 - live0 != gauge or live2 != live0:
        fail("coldstart zoo: resident bytes are not the resident tenants' device tables")
    launches = {"fused_detect": child_launches + cold_child["fused_detect"] + zoo_launches,
                "fused_segment": cold_child["fused_segment"]}
    say("coldstart", f"launches: cold-load processes {child_launches} fused_detect, replica "
        f"children {cold_child}, zoo {zoo_launches} fused_detect")
    return launches, dirs, arts


def window_load(ServeClient, address, texts, seconds: float) -> tuple[list, float]:
    """FLEET_CLIENTS closed-loop clients against ``address`` for ``seconds``:
    each sends FLEET_DOCS texts at a time, the kind cycling as in
    :func:`fleet_load`, and starts no request after the window. Returns
    (client, kind, texts, answer, meta) records and the wall seconds to the
    last answer. Any error fails the phase."""
    import threading

    records, errors, lock = [], [], threading.Lock()
    barrier = threading.Barrier(FLEET_CLIENTS + 1)
    span = len(texts) - FLEET_DOCS

    def work(c):
        client = ServeClient(*address)
        barrier.wait(timeout=60)
        end, r = time.perf_counter() + seconds, 0
        while time.perf_counter() < end:
            start = ((r * FLEET_CLIENTS + c) * FLEET_DOCS) % span
            sub, kind = texts[start:start + FLEET_DOCS], FLEET_KINDS[(c + r) % 3]
            try:
                answer, meta = getattr(client, kind)(sub)
            except Exception as e:
                errors.append(f"client {c} request {r}: {e!r}")
                return
            with lock:
                records.append((c, kind, sub, answer, meta))
            r += 1

    threads = [threading.Thread(target=work, args=(c,)) for c in range(FLEET_CLIENTS)]
    for t in threads:
        t.start()
    barrier.wait(timeout=60)
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        fail(f"scale: {len(errors)} clients stopped on an unanswered request: {errors[:3]}")
    return records, wall


def smi_busy(run) -> str:
    """``run()`` while a thread samples ``nvidia-smi``'s utilization.gpu (the
    share of time a kernel of any process ran on the card); the mean of the
    samples, or "not measured"."""
    import threading

    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            try:
                res = subprocess.run(["nvidia-smi", "--query-gpu=utilization.gpu",
                                      "--format=csv,noheader,nounits"],
                                     capture_output=True, text=True, timeout=30)
                samples.append(float(res.stdout.strip().splitlines()[0]))
            except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
                return
            stop.wait(0.05)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        run()
    finally:
        stop.set()
        thread.join(timeout=30)
    if not samples:
        return "card busy not measured (nvidia-smi gave no utilization)"
    return f"card busy {np.mean(samples):.1f}% (nvidia-smi utilization.gpu, {len(samples)} samples)"


def phase_scale(torch, dev, model5, texts5, dirs, arts, tmp, smi_line) -> dict:
    """Process replicas, the supervisor, the autoscaler and the elastic fleet
    on the one card (phase 23 of the module docstring). Returns the
    launches, the children's included."""
    import threading

    from spark_languagedetector_tpu_torch.ops import _kernels
    from spark_languagedetector_tpu_torch.resilience import faults
    from spark_languagedetector_tpu_torch.resilience.faults import FaultPlan
    from spark_languagedetector_tpu_torch.scale import Autoscaler, ElasticFleet, ReplicaSupervisor
    from spark_languagedetector_tpu_torch.serve import (
        FleetRouter, QuarantineTable, RouterServer, ServeClient, ServeFleet, ServeHTTPError)
    from spark_languagedetector_tpu_torch.telemetry import REGISTRY
    from spark_languagedetector_tpu_torch.telemetry.slo import SloEvaluator

    cache = str(_kernels.BUILD_DIR)  # phase 2 built every kernel there: no child builds
    env = {"PYTHONPATH": str(ROOT), **SCALE_CHILD_ENV}
    router_kw = dict(probe_interval_ms=40, breaker_threshold=2, breaker_cooldown_s=0.3)
    refs = {"v1": model5}
    reset_launches()
    platform = "gpu" if dev.type == "cuda" else dev.type
    sup = ReplicaSupervisor(dirs["f32"], device=dev.type, fleet_name="smoke-scale",
                            pidfile_dir=f"{tmp}/pids", compile_cache_dir=cache,
                            artifact=arts["f32"], child_env=env, metrics_dir=f"{tmp}/metrics",
                            spawn_timeout_s=300.0)
    reps, errors = {}, []

    def spawn(name):
        try:
            reps[name] = sup.spawn(name)
        except Exception as e:
            errors.append(f"{name}: {e!r}")

    elastic = {}

    def start_elastic():
        # The elastic fleet's founder starts with the three children; it
        # idles until the elastic leg below.
        try:
            elastic["fleet"] = ElasticFleet(
                dirs["f32"], replicas=1, device=dev.type, fleet_name="smoke-elastic",
                slo=SloEvaluator(short_window_s=0.25, long_window_s=0.25),
                pidfile_dir=f"{tmp}/epids", compile_cache_dir=cache, artifact=arts["f32"],
                child_env={"PYTHONPATH": str(ROOT), "LANGDETECT_SERVE_QUEUE_ROWS": "32",
                           "LANGDETECT_SERVE_MAX_WAIT_MS": "4"},
                metrics_dir=f"{tmp}/emetrics", spawn_timeout_s=300.0,
                router_kw=dict(router_kw, dispatch_attempts=1,
                               quarantine=QuarantineTable(0, name="elastic-smoke")))
        except Exception as e:
            errors.append(f"elastic founder: {e!r}")

    prober = inproc = iprober = None
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=spawn, args=(f"r{i}",)) for i in range(3)]
        threads.append(threading.Thread(target=start_elastic))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            fail(f"scale: a replica child did not start: {errors}")
        say("scale", f"three replica children (and the elastic fleet's founder) on the card in "
            f"{time.perf_counter() - t0:.2f}s: "
            + ", ".join(f"{n} warmup_s {r.last_warmup_s:.3f} ({r.last_prewarm_mode}, "
                        f"{r.last_ready['platform']})" for n, r in sorted(reps.items())))
        if any(r.last_ready["platform"] != platform for r in reps.values()):
            fail(f"scale: a child is not serving on {platform}")
        router = FleetRouter([reps[f"r{i}"] for i in range(3)],
                             quarantine=QuarantineTable(0, name="scale-smoke"), **router_kw)
        router.start(probe=False)
        prober = Prober(router)
        # Phase 4's model, which dirs["f32"] holds, already warm: no load.
        inproc = ServeFleet(
            [model5] * 3, device=str(dev), max_wait_ms=4, max_rows=256,
            max_queue_rows=1024, cache_enable=False,
            router_kw=dict(router_kw, quarantine=QuarantineTable(0, name="scale-inproc")))
        inproc.start(probe=False)
        iprober = Prober(inproc.router)
        results: dict[str, float] = {}
        with RouterServer(router, port=0) as pfront, \
                RouterServer(inproc.router, fleet=inproc, port=0) as ifront:
            for address in (pfront.address, ifront.address):
                for kind in FLEET_KINDS:
                    getattr(ServeClient(*address), kind)(texts5[5900:5908])
            # Each form serves phase 18's traffic mix for one window of
            # SCALE_WINDOW_S seconds, the score cache off on every replica.
            legs = [("process", pfront.address), ("in-process", ifront.address),
                    ("single in-process", inproc.replica("r0").address),
                    ("single process", reps["r0"].address)]
            for leg, address in legs:
                REGISTRY.reset()
                got = {}
                busy = smi_busy(lambda: got.update(res=window_load(
                    ServeClient, address, texts5[:5900], SCALE_WINDOW_S)))
                recs, wall = got["res"]
                # A window repeats requests: every answer to one request
                # must be the same, and one of them the direct runner's.
                first = {}
                for _, kind, sub, ans, meta in recs:
                    key = (kind, tuple(sub), meta["version"])
                    if key not in first:
                        first[key] = (kind, sub, ans, meta)
                    elif not (np.array_equal(ans, first[key][2]) if kind == "score"
                              else ans == first[key][2]):
                        fail(f"scale ({leg}): two answers to one {kind} request differ")
                serve_check(f"scale ({leg})", list(first.values()), refs, exact=True)
                hist = REGISTRY.snapshot()["histograms"].get("fleet/request_s")
                lat = ("no router" if hist is None else
                       f"fleet/request_s p50 {hist['p50'] * 1e3:.2f} ms, p99 "
                       f"{hist['p99'] * 1e3:.2f} ms")
                results[leg] = len(recs) / wall
                say("scale", f"{leg}: {len(recs)} requests in {wall:.2f}s, "
                    f"{len(recs) / wall:.1f} requests/s; {lat}; {busy}; every answer bit for "
                    f"bit the direct runner ({smi_line})")
            say("scale", f"requests/s, one {SCALE_WINDOW_S:.0f} s window each: " + ", ".join(
                f"{leg} {v:.1f}" for leg, v in results.items())
                + f"; three processes / one process "
                f"{results['process'] / results['single process']:.2f}; one card shows no "
                "scaling, and none is claimed")

            # SIGKILL a child mid-traffic: failover, a restart on its pinned
            # port, the breaker's re-admission.
            port0 = reps["r0"].address[1]
            restart = {}

            def kill(send):
                with prober.paused():
                    reps["r0"].proc.kill()
                    n = 0
                    while REGISTRY.counters.get("fleet/failovers", 0) < 1:
                        n += 1
                        if n > 50:
                            fail("scale: 50 requests after the SIGKILL and no failover")
                        send("detect")
                say("scale", f"r0 SIGKILLed: {n} request(s) until the first failover")

            def revive(send):
                wait_until("scale: an ejection",
                           lambda: REGISTRY.counters.get("fleet/ejections", 0) >= 1)
                t0 = time.perf_counter()
                restart["events"] = sup.poll_once()
                restart["s"] = time.perf_counter() - t0
                wait_until("scale: three eligible replicas", lambda: len(router.eligible()) == 3)

            REGISTRY.reset()
            sheds = []
            recs, wall, _ = fleet_load(
                ServeClient, pfront.address, texts5[:5900],
                {(0, FLEET_KILL_ROUND): ("kill", kill), (0, FLEET_REVIVE_ROUND): ("revive", revive)},
                sheds=sheds)
            counters = dict(REGISTRY.counters)
            serve_check("scale kill", [(kind, sub, ans, meta) for _, kind, sub, ans, meta in recs],
                        refs, exact=True)
            say("scale", f"kill drill: {len(recs)} answered and {len(sheds)} shed explicitly in "
                f"{wall:.2f}s; supervisor {restart.get('events')} in {restart.get('s', 0):.2f}s on "
                f"port {reps['r0'].address[1]} (pinned {port0}); " + str({k: counters.get(k, 0) for k in (
                    "fleet/failovers", "fleet/ejections", "fleet/readmissions")}))
            if restart.get("events") != ["r0:restarted"] or reps["r0"].address[1] != port0:
                fail("scale: the SIGKILLed child was not restarted on its pinned port; its "
                     f"last lines: {reps['r0'].output_tail()[-4:]}")
            if any(counters.get(k, 0) < 1 for k in ("fleet/failovers", "fleet/ejections",
                                                     "fleet/readmissions")):
                fail("scale: no failover, ejection or re-admission around the SIGKILL")
            if len(recs) + len(sheds) < FLEET_CLIENTS * FLEET_ROUNDS:
                fail("scale: a response was dropped in the kill drill")
    except BaseException:
        if "fleet" in elastic:
            elastic["fleet"].close()
        raise
    finally:
        for p in (prober, iprober):
            if p is not None:
                p.stop()
        if inproc is not None:
            inproc.close()
        sup.close()
    launches = capture_launches(sorted(Path(tmp, "metrics").glob("replica-*.jsonl")))
    say("scale", f"the children's launches, as their kernels counted them: {launches} (the "
        "SIGKILLed r0 process wrote no terminal snapshot: its launches are not in the count)")
    if launches["fused_detect"] <= 0:
        fail("scale: the replica children served with no fused_detect launch")

    # The elastic fleet, moved by Autoscaler.tick() alone. Its collector and
    # SLO read this leg's traffic only (the registry is reset); the SLO
    # windows are short, so the burst's burn has cleared after the
    # silence's first ticks.
    REGISTRY.reset()
    ef = elastic["fleet"]
    ef.start(probe=False)
    sc = Autoscaler(ef, scale_min=1, scale_max=2, up_ticks=1, down_ticks=2,
                    pressure_wait_ms=50.0, idle_rows_per_s=1.0, interval_ms=60_000.0)
    try:
        with RouterServer(ef.router, port=0) as front:
            timeline = [ef.target]
            first = sc.tick()
            outcomes, answered, lock = [], [], threading.Lock()
            barrier = threading.Barrier(SCALE_BURST)

            def burst(i):
                sub = texts5[5000 + i * SCALE_BURST_DOCS:5000 + (i + 1) * SCALE_BURST_DOCS]
                barrier.wait(timeout=60)
                try:
                    labels, meta = ServeClient(*front.address).detect(sub, priority="bulk")
                    with lock:
                        answered.append(("detect", sub, labels, meta))
                    out = "ok"
                except ServeHTTPError as e:
                    out = "shed" if e.status == 503 and e.shed and e.retry_after_s > 0 else repr(e)
                except Exception as e:
                    out = repr(e)
                with lock:
                    outcomes.append(out)

            threads = [threading.Thread(target=burst, args=(i,)) for i in range(SCALE_BURST)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            bad = [o for o in outcomes if o not in ("ok", "shed")]
            if bad or len(outcomes) != SCALE_BURST or "shed" not in outcomes:
                fail(f"scale elastic: the burst gave {outcomes}")
            t0 = time.perf_counter()
            up = sc.tick()
            up_s = time.perf_counter() - t0
            timeline.append(ef.target)
            ef.router.probe_once()
            for i in range(4):
                labels, meta = ServeClient(*front.address).detect(texts5[5400 + 8 * i:5408 + 8 * i])
                answered.append(("detect", texts5[5400 + 8 * i:5408 + 8 * i], labels, meta))
            decisions = []
            skips0 = REGISTRY.counters.get("scale/decision_skips", 0)
            t0 = time.perf_counter()
            with faults.plan_scope(FaultPlan.parse("scale/decision:error@3")):
                while ef.target > 1 and len(decisions) < 400:
                    decisions.append(sc.tick())
            down_s = time.perf_counter() - t0
            timeline.append(ef.target)
            skips = REGISTRY.counters.get("scale/decision_skips", 0) - skips0
            labels, meta = ServeClient(*front.address).detect(texts5[5500:5508])
            answered.append(("detect", texts5[5500:5508], labels, meta))
            serve_check("scale elastic", answered, refs, exact=True)
            live = ef.live_count()
    finally:
        ef.close()
    elaunch = capture_launches(sorted(Path(tmp, "emetrics").glob("replica-*.jsonl")))
    say("scale", f"elastic: first tick {first!r}; a burst of {SCALE_BURST} x "
        f"{SCALE_BURST_DOCS} docs against a 32-row queue: {outcomes.count('ok')} answered, "
        f"{outcomes.count('shed')} shed with Retry-After; tick {up!r} in {up_s:.2f}s (the "
        f"joiner's spawn); silence: {len(decisions)} ticks in {down_s:.2f}s, "
        f"{decisions.count('skipped')} skipped (plan scale/decision:error@3), the last "
        f"{decisions[-1] if decisions else None!r}; replicas {timeline}; every answer bit for "
        f"bit; children's launches {elaunch} ({smi_line})")
    if first != "hold" or up != "up" or timeline != [1, 2, 1] or live != 1:
        fail(f"scale elastic: replicas {timeline} (ticks {first!r}, {up!r}), expected 1 -> 2 -> 1")
    if decisions[2:3] != ["skipped"] or decisions.count("skipped") != 1 or skips != 1:
        fail(f"scale elastic: the decision plan skipped {decisions.count('skipped')} ticks "
             f"({skips} counted), expected exactly tick 3")
    if elaunch["fused_detect"] <= 0:
        fail("scale elastic: the children served with no fused_detect launch")
    own = read_launches()
    return {k: own[k] + launches[k] + elaunch[k] for k in ("fused_detect", "fused_segment")}


# ------------------------------------------------------------- phase 24 ----
MESH_SEGMENT_DOCS = 120  # code-switched documents of the segment check
MESH_VOCAB_DOCS = 1000  # documents of the mesh:vocab score check
MESH_LONG_DOC_BYTES = 400_000  # the long document of the sequence check
MESH_VOCAB_BITS = 16  # the mesh:vocab model's hashed buckets: a dense 2^16 x 176 table
MESH_KERNELS = ("fused_detect", "fused_segment", "row_hist", "bigram_hist", "bigram_score")


def mesh_child(spec_path: str, rank: int) -> None:
    """``chip_smoke.py --mesh-rank SPEC RANK``: one rank of phase 24. Joins
    the process group through ``init_distributed``, runs the checks against
    the parent's single-device answers, writes its kernels' launch counts
    into a terminal snapshot of its JSONL capture and prints one JSON
    object; any check that does not hold fails the process."""
    sys.path.insert(0, str(ROOT))
    import torch

    import spark_languagedetector_tpu_torch as port
    from spark_languagedetector_tpu_torch import LanguageDetector, LanguageDetectorModel, Table
    from spark_languagedetector_tpu_torch.api.runner import resolve_fit_mesh, resolve_mesh
    from spark_languagedetector_tpu_torch.artifacts import maybe_load_baked
    from spark_languagedetector_tpu_torch.ops import _kernels
    from spark_languagedetector_tpu_torch.ops import score_fused as SF
    from spark_languagedetector_tpu_torch.ops import score_hist as SH
    from spark_languagedetector_tpu_torch.ops import score_pallas as SP
    from spark_languagedetector_tpu_torch.parallel import distributed
    from spark_languagedetector_tpu_torch.parallel.sequence import (
        chunk_grid, ring_score_chunks, score_long_document)
    from spark_languagedetector_tpu_torch.telemetry import REGISTRY
    from spark_languagedetector_tpu_torch.telemetry.export import JsonlSink

    spec = json.loads(Path(spec_path).read_text())
    tmp = Path(spec["tmp"])
    world = spec["world"]
    on_card = spec["device"] == "cuda"
    if on_card and not torch.cuda.is_available():
        fail("mesh child: no CUDA card")
    REGISTRY.add_sink(JsonlSink(spec["captures"][rank]))
    if not on_card:  # a CPU rehearsal counts the plain versions' calls as launches
        for mod, name, kernel in ((SF, "fused_plain", _kernels.FUSED_DETECT),
                                  (SF, "fused_segment_plain", _kernels.FUSED_SEGMENT),
                                  (SH, "row_hist_plain", _kernels.ROW_HIST),
                                  (SP, "bigram_hist_plain", _kernels.BIGRAM_HIST),
                                  (SP, "bigram_score_plain", _kernels.BIGRAM_SCORE)):
            def counted(*a, _f=getattr(mod, name), _k=kernel, **k):
                _k.launches += 1
                return _f(*a, **k)

            setattr(mod, name, counted)
    t0 = time.perf_counter()
    port.init_distributed(spec["init"], world, rank, device=None if on_card else "cpu")
    import torch.distributed as dist

    out = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "init_s": time.perf_counter() - t0}
    if out["backend"] == "nccl":
        out["nccl"] = ".".join(map(str, torch.cuda.nccl.version()))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    for k in _kernels.KERNELS:
        k.launches = 0
    texts = json.loads(Path(tmp, "texts5.json").read_text())
    train = json.loads(Path(tmp, "train5.json").read_text())

    # The sharded device fit through resolve_fit_mesh().
    mesh = resolve_fit_mesh()
    det = (LanguageDetector(train["languages"], [1, 2, 3, 4, 5], 400)
           .set_vocab_mode("hashed").set_hash_bits(20).set_fit_backend("device")
           .set_device("mesh"))
    table = Table({"lang": train["lang"], "fulltext": train["fulltext"]})
    fit_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        fitted = det.fit(table)
        sync()
        fit_s.append(time.perf_counter() - t0)
    ids = np.load(tmp / "fit5_ids.npy")
    weights = np.load(tmp / "fit5_weights.npy")
    if not np.array_equal(fitted.profile.ids, ids):
        fail(f"mesh rank {rank}/{world}: the sharded fit's ids differ from fit5's")
    if not np.allclose(fitted.profile.weights, weights, rtol=0, atol=1e-12):
        fail(f"mesh rank {rank}/{world}: the sharded fit's weights differ from fit5's")
    out.update(fit_mesh=dict(mesh.shape), fit_s=fit_s,
               fit_bit_identical=bool(np.array_equal(fitted.profile.weights, weights)))
    del fitted

    def labels_of(model, docs):
        got = model.transform(Table({"fulltext": docs})).column("lang").tolist()
        idx = {name: i for i, name in enumerate(model.profile.languages)}
        return np.asarray([idx[name] for name in got])

    def check(what, got, want):
        if not np.array_equal(got, want):
            fail(f"mesh rank {rank}/{world}: {what}: {int((got != want).sum())} of {len(want)} "
                 "labels differ from the single-device run")

    # Label mode at config 5 through fused_detect (the baked model).
    m5 = maybe_load_baked(tmp / "m5", device="mesh")
    runner = m5.runner
    if runner.mesh is None or runner.strategy != "fused":
        fail(f"mesh rank {rank}: config 5 runner {runner.strategy} on mesh {runner.mesh}")
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        got = labels_of(m5, texts)
        sync()
        walls.append(time.perf_counter() - t0)
    check("config 5 labels", got, np.load(tmp / "ids5.npy"))
    out.update(transform_docs=len(texts), transform_s=walls, mesh=dict(runner.mesh.shape))

    # Segment mode through fused_segment: spans identical.
    seg = m5.copy({"resultMode": "segment"})
    seg.calibration = m5.calibration
    seg_texts = json.loads(Path(tmp, "seg_texts.json").read_text())
    got_seg = seg.transform(Table({"fulltext": seg_texts})).column("lang").tolist()
    if got_seg != json.loads(Path(tmp, "seg_ref.json").read_text()):
        fail(f"mesh rank {rank}/{world}: segment results differ from the single-device run")

    # Config 3 (hybrid: row_hist, and bigram_hist for n <= 2 at 50
    # languages) and the 10-language exact n = 1..5 profile (hybrid: its
    # n <= 2 part through bigram_score, L <= 16).
    for name, strategy in (("m3", "hybrid"), ("m10", "hybrid")):
        model = LanguageDetectorModel.load(str(tmp / name), device="mesh")
        if model.runner.strategy != strategy:
            fail(f"mesh rank {rank}: {name} runner strategy {model.runner.strategy}")
        docs = json.loads(Path(tmp, f"texts_{name}.json").read_text())
        check(f"{name} labels", labels_of(model, docs), np.load(tmp / f"ids_{name}.npy"))

    # mesh:vocab on the dense gather table: scores in the reduction-order class.
    mv = LanguageDetectorModel.load(str(tmp / "mv"), device="mesh:vocab")
    ref_v = np.load(tmp / "vocab_ref.npy")
    got_v = mv.runner.score([t.encode() for t in texts[: len(ref_v)]])
    err = float(np.abs(got_v - ref_v).max())
    if not np.all(np.abs(got_v - ref_v) <= ATOL + RTOL * np.abs(ref_v)):
        fail(f"mesh rank {rank}: mesh:vocab scores {err} from the replicated gather")
    out.update(vocab_mesh=dict(mv.runner.mesh.shape), vocab_strategy=mv.runner.strategy,
               vocab_max_abs_err=err)

    # One long document over the data axis: psum and ring.
    w5, lut5, _ = m5.profile.device_membership(device=str(runner.device))
    long_doc = Path(tmp, "long_doc.bin").read_bytes()
    data_mesh = resolve_mesh("mesh")
    t0 = time.perf_counter()
    psum = score_long_document(long_doc, w5, lut5, m5.profile.spec, data_mesh)
    b, ln, lim = chunk_grid(long_doc, data_mesh.shape["data"], 8192, m5.profile.spec.gram_lengths)
    ring = ring_score_chunks(b, ln, lim, w5, lut5, m5.profile.spec, data_mesh).cpu().numpy()
    sync()
    out["long_doc_s"] = time.perf_counter() - t0
    single = np.load(tmp / "long_ref.npy")
    if not np.array_equal(psum, ring):
        fail(f"mesh rank {rank}: the ring's sum differs from the psum's")
    if not np.all(np.abs(psum - single) <= ATOL + RTOL * np.abs(single)):
        fail(f"mesh rank {rank}: the long document's sum is "
             f"{float(np.abs(psum - single).max())} from the single-device sum")
    out["long_doc_err"] = float(np.abs(psum - single).max())

    launches = {k.name: k.launches for k in _kernels.KERNELS}
    missing = [k for k in MESH_KERNELS if launches.get(k, 0) <= 0]
    if missing:
        fail(f"mesh rank {rank}/{world}: no launch of {missing} ({launches})")
    for k in _kernels.KERNELS:
        REGISTRY.set_gauge("langdetect_kernel_launches", k.launches, kernel=k.name, stage="mesh")
    REGISTRY.flush()
    out["launches"] = launches
    dist.barrier()
    distributed.shutdown()
    print(json.dumps(out))


def run_mesh_children(tmp: Path, world: int, device: str) -> list[dict]:
    """Phase 24's ``world`` rank processes, started together from this
    checkout (its kernel build directory is warm) and waited for; each
    one's JSON result."""
    spec = tmp / f"mesh{world}.json"
    captures = [str(tmp / f"mesh{world}_r{r}.jsonl") for r in range(world)]
    spec.write_text(json.dumps({"tmp": str(tmp), "world": world, "device": device,
                                "init": f"file://{tmp}/init{world}", "captures": captures}))
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
                               str(spec), str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = []
    try:
        for r, p in enumerate(procs):
            stdout, stderr = p.communicate(timeout=300)
            if p.returncode != 0:
                fail(f"mesh: rank {r} of {world} failed (exit {p.returncode}): {stderr[-3000:]}")
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def phase_mesh(torch, dev, model5, texts5, ids5, case5: FitCase, fit5_model, model3,
               case3: FitCase, tmp, smi_line) -> dict:
    """Multi-device on the one card (phase 24 of the module docstring).
    Returns the children's launches."""
    from spark_languagedetector_tpu_torch import LanguageDetector, Table
    from spark_languagedetector_tpu_torch.api.runner import BatchRunner
    from spark_languagedetector_tpu_torch.artifacts import artifact_path_for, bake_model
    from spark_languagedetector_tpu_torch.parallel.mesh import build_mesh
    from spark_languagedetector_tpu_torch.parallel.sequence import score_long_document

    tmp = Path(tmp)
    t_setup = time.perf_counter()
    langs = list(model5.profile.languages)
    # The single-device answers the ranks are held to.
    model5.save(str(tmp / "m5"))
    bake_model(model5, artifact_path_for(tmp / "m5"))
    (tmp / "texts5.json").write_text(json.dumps(texts5))
    np.save(tmp / "ids5.npy", ids5)
    (tmp / "train5.json").write_text(json.dumps({
        "languages": langs, "lang": case5.table.column("lang").tolist(),
        "fulltext": case5.table.column("fulltext").tolist()}))
    np.save(tmp / "fit5_ids.npy", fit5_model.profile.ids)
    np.save(tmp / "fit5_weights.npy", fit5_model.profile.weights)
    det5 = case5.det.copy({"fitBackend": "device"})
    t0 = time.perf_counter()
    det5.fit(case5.table)
    torch.cuda.synchronize() if dev.type == "cuda" else None
    fit5_s = time.perf_counter() - t0
    seg = model5.copy({"resultMode": "segment"})
    seg.calibration = model5.calibration
    seg_texts, _ = make_codeswitch_corpus(langs, MESH_SEGMENT_DOCS, seed=41)
    (tmp / "seg_texts.json").write_text(json.dumps(seg_texts))
    (tmp / "seg_ref.json").write_text(json.dumps(
        seg.transform(Table({"fulltext": seg_texts})).column("lang").tolist()))
    model3.save(str(tmp / "m3"))
    (tmp / "texts_m3.json").write_text(json.dumps(case3.texts))
    np.save(tmp / "ids_m3.npy", case3.ids)
    langs10 = language_names(10)
    train10, labels10 = make_corpus(langs10, 60 * len(langs10), seed=43)
    m10 = (LanguageDetector(langs10, [1, 2, 3, 4, 5], 1000, device=str(dev))
           .set_vocab_mode("exact").fit(Table({"lang": labels10, "fulltext": train10})))
    if m10.runner.strategy != "hybrid":
        fail(f"mesh: the 10-language runner strategy is {m10.runner.strategy!r}, not hybrid")
    texts10, _ = make_corpus(langs10, 2000, seed=44)
    (tmp / "texts_m10.json").write_text(json.dumps(texts10))
    np.save(tmp / "ids_m10.npy", m10.runner.predict_ids([t.encode() for t in texts10]))
    m10.save(str(tmp / "m10"))
    # A dense hashed table (2^16 buckets x 176 languages; n = 1..5 so that
    # enough buckets are learned for the dense form) for mesh:vocab.
    mv = (LanguageDetector(langs, [1, 2, 3, 4, 5], 400, device=str(dev))
          .set_vocab_mode("hashed").set_hash_bits(MESH_VOCAB_BITS).set_fit_backend("device")
          .fit(case5.table))
    w, lut, _ = mv.profile.device_membership(device="cpu")
    if lut is not None:
        fail("mesh: the mesh:vocab model's device form is not the dense table")
    vdocs = [t.encode() for t in texts5[:MESH_VOCAB_DOCS]]
    np.save(tmp / "vocab_ref.npy", BatchRunner(weights=w, lut=None, spec=mv.profile.spec,
                                               device=dev, strategy="gather").score(vdocs))
    mv.save(str(tmp / "mv"))
    long_doc = " ".join(texts5[:400]).encode()[:MESH_LONG_DOC_BYTES]
    (tmp / "long_doc.bin").write_bytes(long_doc)
    w5, lut5, _ = model5.profile.device_membership(device=str(dev))
    np.save(tmp / "long_ref.npy", score_long_document(long_doc, w5, lut5, model5.profile.spec,
                                                      build_mesh(device=dev)))
    say("mesh", f"references on one device in {time.perf_counter() - t_setup:.1f}s: "
        f"fit5 (device fit, warm) {fit5_s:.3f}s; {len(texts5)} config-5, {len(case3.texts)} "
        f"config-3 and {len(texts10)} 10-language (exact n = 1..5) docs, {len(seg_texts)} "
        f"code-switched, a "
        f"{len(long_doc)}-byte document")

    results = {}
    for world in (1, 2):
        t0 = time.perf_counter()
        outs = run_mesh_children(tmp, world, dev.type)
        wall = time.perf_counter() - t0
        results[world] = outs
        r0 = outs[0]
        backends = {o["backend"] for o in outs}
        say("mesh", f"{world} rank(s) ({', '.join(sorted(backends))}"
            f"{', NCCL ' + r0['nccl'] if 'nccl' in r0 else ''}) in {wall:.1f}s: sharded fit "
            f"{dict(r0['fit_mesh'])} first {r0['fit_s'][0]:.3f}s, warm {r0['fit_s'][1]:.3f}s "
            f"(profile bit-identical to fit5: {all(o['fit_bit_identical'] for o in outs)}); "
            f"config-5 labels identical through fused_detect on mesh {r0['mesh']}, "
            f"{r0['transform_docs']} docs warm {r0['transform_docs'] / r0['transform_s'][1]:.0f} "
            f"docs/s; segment spans, config-3 and 10-language (hybrid) labels "
            f"identical; mesh:vocab {r0['vocab_mesh']} ({r0['vocab_strategy']}) max |err| "
            f"{max(o['vocab_max_abs_err'] for o in outs):.3g}; long document psum == ring, "
            f"{max(o['long_doc_err'] for o in outs):.3g} from one device; launches "
            f"{[o['launches'] for o in outs]}")
        if world == 1 and dev.type == "cuda" and backends != {"nccl"}:
            fail(f"mesh: the one-rank group's backend is {backends}, expected nccl")
        if world == 2 and backends != {"gloo"}:
            fail(f"mesh: two ranks on one card run {backends}, expected gloo")
    one, two = results[1][0], results[2][0]
    say("mesh", f"sharded fit warm: 1 rank {one['fit_s'][1]:.3f}s, 2 ranks "
        f"{two['fit_s'][1]:.3f}s against fit5's {fit5_s:.3f}s on one device; transform docs/s "
        f"(warm): 1 rank {one['transform_docs'] / one['transform_s'][1]:.0f}, 2 ranks sharing "
        f"the card {two['transform_docs'] / two['transform_s'][1]:.0f} — two ranks on one "
        f"card measure no scaling ({smi_line})")
    captures = sorted(tmp.glob("mesh*_r*.jsonl"))
    launches = capture_launches(captures)
    if len(captures) != 3 or any(launches.get(k, 0) <= 0 for k in MESH_KERNELS):
        fail(f"mesh: the children's captures {len(captures)} counted launches {launches}")
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="stop after the kernel checks (phases 1-3)")
    ap.add_argument("--baseline", type=Path, metavar="DIR", action="append", default=[],
                    help="another version's checkout, or its csrc/ directory: every kernel "
                    "whose source it holds (same C entry point) is built from it and timed "
                    "in turns with this checkout's; repeatable")
    ap.add_argument("--cold-load", metavar="SPEC", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-rank", nargs=2, metavar=("SPEC", "RANK"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.cold_load:  # phase 22's fresh process
        cold_load_child(args.cold_load)
        return
    if args.mesh_rank:  # one rank of phase 24
        mesh_child(args.mesh_rank[0], int(args.mesh_rank[1]))
        return

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
        fit5_model = phase_fit5(torch, dev, fit5_case, smi_line)
    with phase_clock("fit3"):
        phase_fit3(torch, dev, fit3_case, smi_line)
    with phase_clock("persist"):
        phase_persist(torch, dev, model, main_docs, model3, fit3_case.texts)
    with phase_clock("runner"):
        phase_runner(torch, dev, model, main_docs, main_ids, model3, fit3_case, smi_line)
    with phase_clock("serve"):
        phase_serve(torch, dev, model, main_docs, fit5_case, model3, fit3_case, smi_line)
    with phase_clock("stream"):
        stream_launches = phase_stream(torch, dev, smi_line)
    with phase_clock("refit"):
        refit_launches = phase_refit(torch, dev, fit5_case, fit5_model, smi_line)
    with tempfile.TemporaryDirectory(prefix="fleet_smoke_") as tmp:
        with phase_clock("fleet"):
            fleet_launches, fleet_dirs = phase_fleet(torch, dev, model, main_docs, fit5_case,
                                                     tmp, smi_line)
        with phase_clock("storm"):
            storm_launches = phase_storm(torch, dev, fleet_dirs, main_docs, smi_line)
        del fleet_dirs
    with phase_clock("zoo"):
        zoo_launches, zoo_state = phase_zoo(torch, dev, fit5_case, main_docs, smi_line)
    with tempfile.TemporaryDirectory(prefix="observe_smoke_") as tmp, phase_clock("observe"):
        observe_launches = phase_observe(torch, dev, model, main_docs, main_ids, fit3_case,
                                         fit5_case, tmp, smi_line)
    with tempfile.TemporaryDirectory(prefix="coldstart_smoke_") as tmp:
        with phase_clock("coldstart"):
            cold_launches, dirs, arts = phase_coldstart(torch, dev, model, main_docs, main_ids,
                                                        zoo_state, tmp, smi_line)
        del zoo_state
        with phase_clock("scale"):
            scale_launches = phase_scale(torch, dev, model, main_docs, dirs, arts, tmp, smi_line)
    with tempfile.TemporaryDirectory(prefix="mesh_smoke_") as tmp, phase_clock("mesh"):
        mesh_launches = phase_mesh(torch, dev, model, main_docs, main_ids, fit5_case, fit5_model,
                                   model3, fit3_case, tmp, smi_line)
    segment_entry["launches"] += (fleet_launches["fused_segment"] + observe_launches["fused_segment"]
                                  + cold_launches["fused_segment"] + scale_launches["fused_segment"]
                                  + mesh_launches["fused_segment"])
    for entry in hist_entries:
        entry["launches"] += observe_launches.get(entry["name"], 0) + mesh_launches[entry["name"]]
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
        "launches": (launches + stream_launches + refit_launches
                     + fleet_launches["fused_detect"] + storm_launches["fused_detect"]
                     + zoo_launches["fused_detect"] + observe_launches["fused_detect"]
                     + cold_launches["fused_detect"] + scale_launches["fused_detect"]
                     + mesh_launches["fused_detect"]),
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
