"""Entry ``transform``: one closed-loop caller of ``LanguageDetectorModel.transform``.

Set-up fits the configuration's profile on the device from the seed's
training corpus, generates the mix's pool of distinct documents and cuts it
into calls of ``docs_per_call`` consecutive documents; then it runs every
call once, so every batch shape the window sends is warm. The window sends
the calls in turn, back to back, each as a fresh ``Table``, until
``seconds`` have passed; every document of a call differs from every other.

The outputs judged are the profile fitted in set-up and the labels of every
call of the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import checks, corpus, program
from ..count import transform_work
from ..phases import Phases
from ..reference import fit as ref_fit
from ..reference import score as ref_score
from ..reference.vocab import Vocab, window_ids


def setup(config: dict, mix: dict, seed: int, device: str) -> dict:
    clock = Phases(device)
    langs = corpus.language_names(int(config["languages"]))
    texts, labels = corpus.training_table(config, seed)
    clock.done("training corpus")
    model = program.fitted_model(config, langs, texts, labels, device)
    clock.done("fit")
    pool = corpus.traffic_pool(config, mix, seed)
    per = int(mix["docs_per_call"])
    calls = [pool[i : i + per] for i in range(0, len(pool) - per + 1, per)]
    clock.done("traffic")
    for docs in calls:
        model.transform(program.table({"fulltext": docs}))
    clock.done("warm calls")
    return {"model": model, "calls": calls, "langs": langs, "train": (texts, labels),
            "phases": clock.phases}


def window(state: dict, seconds: float) -> list[dict]:
    model, calls = state["model"], state["calls"]
    out, start, i = [], time.perf_counter(), 0
    while True:
        k = i % len(calls)
        t0, e0 = time.perf_counter(), time.time()
        try:
            labels = model.transform(program.table({"fulltext": calls[k]})).column("lang")
        except Exception as e:  # a failed call is counted, and the loop goes on
            labels, err = None, repr(e)
        else:
            err = None
        t1, e1 = time.perf_counter(), time.time()
        out.append({"t0": t0, "t1": t1, "epoch0": e0, "epoch1": e1, "docs": len(calls[k]),
                    "ok": err is None, "error": err, "call": k, "labels": labels})
        i += 1
        if t1 - start >= seconds:
            return out


def outputs(state: dict, calls: list[dict]) -> dict:
    """Host copies of what the timed path produced (labels as language
    indices, -1 for any other string; a call with the wrong row count
    counts as failed)."""
    langs = state["langs"]
    index = {l: i for i, l in enumerate(langs)}
    labelled, failed = [], 0
    for c in calls:
        lab = c.pop("labels")
        if lab is None or len(lab) != c["docs"]:
            c["ok"] = False
            failed += 1
            continue
        labelled.append((c["call"], np.fromiter((index.get(x, -1) for x in lab), np.int64, len(lab))))
    p = state["model"].profile
    texts, labels = state["train"]
    return {
        "profile": (np.asarray(p.ids, np.int64), np.asarray(p.weights, np.float64)),
        "labelled": labelled,
        "calls_failed": failed,
        "docs": [[t.encode() for t in docs] for docs in state["calls"]],
        "train": ([t.encode() for t in texts], np.array([index[l] for l in labels])),
    }


def reference(config: dict, out: dict, device: str) -> dict:
    profile = ref_fit.fit(config, *out["train"], device)
    scores = [ref_score.score(config, docs, *profile, device) for docs in out["docs"]]
    return {"profile": profile, "scores": scores}


def readings(out: dict, ref: dict) -> dict:
    gap = 0.0
    for k, lab in out["labelled"]:
        gap = max(gap, float(checks.label_gaps(ref["scores"][k], lab).max(initial=0.0)))
    return {"calls_failed": out["calls_failed"], **checks.profile_gaps(out["profile"], ref["profile"]),
            "label_gap": gap}


def control(config: dict, out: dict, ref: dict, device: str, sum_dtype=torch.float32) -> dict:
    """The reference in the program's place, one precision down: the
    profile's weights rounded to bfloat16, and every call's labels from
    sums of the bfloat16 table in ``sum_dtype``."""
    ids, w = ref["profile"]
    low = torch.from_numpy(w).to(torch.bfloat16).double().numpy()
    labels = [ref_score.labels(ref_score.score(config, docs, ids, w, device, table_dtype=torch.bfloat16,
                                               sum_dtype=sum_dtype))
              for docs in out["docs"]]
    return {**out, "profile": (ids, low), "calls_failed": 0,
            "labelled": [(k, labels[k]) for k, _ in out["labelled"]]}


def faults(config: dict, out: dict, ref: dict, device: str) -> dict:
    """The reference's own labels in the program's place, each with one
    fault planted where the answers are produced: one label of every call
    altered; the second half of every call left out (its documents take
    the first language); every call answered with the previous call's
    labels; every call scored without its longest gram length (a partial
    scorer, which flips near ties such as code-switched documents)."""
    right = [ref_score.labels(s) for s in ref["scores"]]
    part = dict(config, gramLengths=list(config["gramLengths"])[:-1])
    partial = [ref_score.labels(ref_score.score(part, docs, *ref["profile"], device))
               for docs in out["docs"]]
    L = int(config["languages"])
    altered, half, stale = [], [], []
    for i, (k, _) in enumerate(out["labelled"]):
        lab = right[k].copy()
        lab[1] = (lab[1] + 1) % L
        altered.append((k, lab))
        lab = right[k].copy()
        lab[len(lab) // 2 :] = 0
        half.append((k, lab))
        prev = out["labelled"][i - 1][0] if i else (k - 1) % len(right)
        stale.append((k, right[prev] if len(right[prev]) == len(right[k]) else lab))
    base = {**out, "profile": ref["profile"], "calls_failed": 0}
    got = {"altered": altered, "half": half, "stale": stale,
           "partial": [(k, partial[k]) for k, _ in out["labelled"]]}
    return {name: {**base, "labelled": lab} for name, lab in got.items()}


def work(config: dict, out: dict, ref: dict, calls: list[dict], device: str) -> dict:
    """Compulsory work of the window's calls (:mod:`..count`)."""
    vocab = Vocab.of(config)
    ids_t = torch.as_tensor(ref["profile"][0], device=device)
    wb = {"float32": 4, "int16": 2, "int8": 1}[config.get("dtype", "float32")]
    per_call = []
    for docs in out["docs"]:
        grams = torch.unique(window_ids(vocab, docs, device)[0])
        rows = int(torch.isin(grams, ids_t).sum())
        per_call.append(transform_work(vocab, [len(d) for d in docs], rows, int(config["languages"]), wb))
    total = {"ops": 0.0, "bytes": 0.0}
    for c in calls:
        if c["ok"]:
            for key in total:
                total[key] += per_call[c["call"]][key]
    return total
