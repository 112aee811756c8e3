"""Entry ``fit``: ``LanguageDetector.fit`` back to back on one corpus.

Set-up generates the mix's training corpus (``docs_per_language`` documents
of each language, lengths from the mix) as one ``Table`` and fits it once,
so the window's fits find every kernel built and every allocation made.
The window then fits the same table again and again, each fit a new
profile from scratch, until ``seconds`` have passed.

The outputs judged are the profiles of every fit of the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import checks, corpus, program
from ..count import fit_work
from ..phases import Phases
from ..reference import fit as ref_fit
from ..reference.vocab import Vocab


def setup(config: dict, mix: dict, seed: int, device: str) -> dict:
    clock = Phases(device)
    langs = corpus.language_names(int(config["languages"]))
    texts, labels = corpus.training_table(config, seed, mix["docs_per_language"], mix["lengths"])
    clock.done("training corpus")
    det = program.estimator(config, langs, device)
    table = program.table({"lang": labels, "fulltext": texts})
    det.fit(table)
    clock.done("warm fit")
    return {"det": det, "table": table, "langs": langs, "train": (texts, labels),
            "phases": clock.phases}


def window(state: dict, seconds: float) -> list[dict]:
    det, table = state["det"], state["table"]
    out, start = [], time.perf_counter()
    while True:
        t0, e0 = time.perf_counter(), time.time()
        try:
            p = det.fit(table).profile
        except Exception as e:  # a failed fit is counted, and the loop goes on
            profile, err = None, repr(e)
        else:
            profile, err = (p.ids, p.weights), None
        t1, e1 = time.perf_counter(), time.time()
        out.append({"t0": t0, "t1": t1, "epoch0": e0, "epoch1": e1, "docs": table.num_rows,
                    "ok": err is None, "error": err, "profile": profile})
        if t1 - start >= seconds:
            return out


def outputs(state: dict, calls: list[dict]) -> dict:
    profiles = [c.pop("profile") for c in calls]
    index = {l: i for i, l in enumerate(state["langs"])}
    texts, labels = state["train"]
    return {
        "profiles": [(np.asarray(i, np.int64), np.asarray(w, np.float64)) for i, w in profiles
                     if i is not None],
        "fits_failed": sum(p is None for p in profiles),
        "train": ([t.encode() for t in texts], np.array([index[l] for l in labels])),
    }


def reference(config: dict, out: dict, device: str) -> dict:
    vocab = Vocab.of(config)
    keys = ref_fit.presence_pairs(vocab, *out["train"], int(config["languages"]), device)
    profile = ref_fit.finalize(keys, int(config["languages"]), int(config["languageProfileSize"]))
    return {"profile": profile, "keys": keys}


def readings(out: dict, ref: dict) -> dict:
    profiles = out["profiles"]
    if not profiles:
        return {"fits_failed": out["fits_failed"], "fits_differing": 0,
                "profile_grams_differing": int(ref["profile"][0].size), "profile_weight_gap": 1.0}
    return {
        "fits_failed": out["fits_failed"],
        "fits_differing": sum(not checks.same_profile(p, profiles[0]) for p in profiles[1:]),
        **checks.profile_gaps(profiles[0], ref["profile"]),
    }


def control(config: dict, out: dict, ref: dict, device: str) -> dict:
    """The reference in the program's place, one precision down: weights
    computed in float32."""
    low = ref_fit.finalize(ref["keys"], int(config["languages"]),
                           int(config["languageProfileSize"]), torch.float32)
    return {**out, "profiles": [low], "fits_failed": 0}


def faults(config: dict, out: dict, ref: dict, device: str) -> dict:
    """The reference fit in the program's place, with one fault planted
    each: its count step leaving the state unchanged (no pair counted),
    half of every batch left out (the second half of the corpus), one
    weight altered by one unit in the last place."""
    L, P = int(config["languages"]), int(config["languageProfileSize"])
    docs, langs = out["train"]
    n = len(docs) // 2
    half = ref_fit.finalize(ref_fit.presence_pairs(Vocab.of(config), docs[:n], langs[:n], L, device), L, P)
    empty = ref_fit.finalize(ref["keys"][:0], L, P)
    ids, w = ref["profile"]
    w = w.copy()
    w[0, np.argmax(w[0])] = np.nextafter(w[0].max(), 2.0)
    return {name: {**out, "profiles": [p], "fits_failed": 0}
            for name, p in (("unchanged", empty), ("half", half), ("altered", (ids, w)))}


def work(config: dict, out: dict, ref: dict, calls: list[dict], device: str) -> dict:
    """Compulsory work of the window's fits (:mod:`..count`)."""
    one = fit_work(Vocab.of(config), [len(d) for d in out["train"][0]], int(ref["keys"].numel()),
                   int(ref["profile"][0].size), int(config["languages"]))
    n = sum(c["ok"] for c in calls)
    return {k: v * n for k, v in one.items()}
