"""The port's incremental refit held against the JAX package's, on the CPU.

The count table is the fit's sufficient statistic. On the same inputs, made
from a seed, the port's :class:`FitAccumulator` over any split of a corpus
gives the ids and float64 weights of the JAX package's accumulator, of the
port's own from-scratch device fit and of its host fit, bit for bit; a fit
state saved by either package loads in the other; the validations keep
their messages; and the auto-refit loop checkpoints, resumes and hot
swaps through the port's serving registry. The two cases of the JAX
package's tests that need a mesh are not here: the port's accumulator has
no mesh yet. A card-only case (``cuda`` marker) repeats the fuzz on the
card.
"""

import itertools
import json
import os
import shutil

import numpy as np
import pytest
import torch

import spark_languagedetector_tpu_torch.models.refit as refit_mod
from spark_languagedetector_tpu import LanguageDetector as JaxDetector
from spark_languagedetector_tpu import Table as JaxTable
from spark_languagedetector_tpu.models.refit import FitAccumulator as JaxAccumulator
from spark_languagedetector_tpu.ops.vocab import VocabSpec as JaxSpec
from spark_languagedetector_tpu_torch import LanguageDetector, Table
from spark_languagedetector_tpu_torch.models.refit import FitAccumulator
from spark_languagedetector_tpu_torch.ops.fit import COUNTS, PARITY, fit_profile_numpy
from spark_languagedetector_tpu_torch.ops.fit_tpu import fit_profile_device
from spark_languagedetector_tpu_torch.ops.vocab import EXACT, HASHED, VocabSpec
from spark_languagedetector_tpu_torch.persist.io import recover_fit_state
from spark_languagedetector_tpu_torch.resilience import faults
from spark_languagedetector_tpu_torch.resilience.faults import FaultPlan
from spark_languagedetector_tpu_torch.serve import ModelRegistry
from spark_languagedetector_tpu_torch.stream import AutoRefit
from spark_languagedetector_tpu_torch.telemetry import REGISTRY


def _corpus(rng, n_docs, n_langs, max_len=90):
    docs, langs = [], []
    for i in range(n_docs):
        ln = int(rng.integers(0, max_len))
        docs.append(bytes(rng.integers(97, 105, ln, dtype=np.uint8)))
        langs.append(i % n_langs)
    return docs, np.asarray(langs, dtype=np.int32)


def _random_splits(rng, n, pieces):
    cuts = sorted(rng.choice(np.arange(1, n), size=pieces - 1, replace=False))
    return list(zip([0, *cuts], [*cuts, n]))


def _jax_spec(spec):
    return JaxSpec(spec.mode, spec.gram_lengths, hash_bits=spec.hash_bits,
                   hash_scheme=spec.hash_scheme)


def _same_profile(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def _det(*args, **kw):
    return LanguageDetector(*args, device="cpu", **kw)


# --------------------------------------------------- refit ≡ from-scratch ----
FUZZ_SPECS = [
    (VocabSpec(EXACT, (1, 2)), PARITY),
    (VocabSpec(EXACT, (2,)), COUNTS),
    (VocabSpec(HASHED, (1, 2, 3), hash_bits=12), PARITY),
]


def _fuzz(spec, weight_mode, device, seed=7, trials=3, with_jax=True):
    rng = np.random.default_rng(seed)
    for _ in range(trials):
        n = int(rng.integers(23, 61))
        docs, langs = _corpus(rng, n, 3)
        docs += [b"", b"x"]
        langs = np.concatenate([langs, [0, 1]]).astype(np.int32)
        splits = _random_splits(rng, len(docs), int(rng.integers(2, 5)))
        acc = FitAccumulator(spec, ("aa", "bb", "cc"), profile_size=25,
                             weight_mode=weight_mode, device=device)
        for lo, hi in splits:
            acc.update_raw(docs[lo:hi], langs[lo:hi])
        got = acc.finalize()
        _same_profile(got, fit_profile_device(docs, langs, 3, spec, 25, weight_mode,
                                              device=device))
        _same_profile(got, fit_profile_numpy(docs, langs, 3, spec, 25, weight_mode))
        if with_jax:
            jacc = JaxAccumulator(_jax_spec(spec), ("aa", "bb", "cc"), profile_size=25,
                                  weight_mode=weight_mode)
            for lo, hi in splits:
                jacc.update_raw(docs[lo:hi], langs[lo:hi])
            _same_profile(got, jacc.finalize())


@pytest.mark.parametrize("spec,weight_mode", FUZZ_SPECS)
def test_incremental_equals_from_scratch_fuzz(spec, weight_mode):
    """Random corpus splits across updates finalize bit-identical to the
    port's from-scratch device fit, its host fit and the JAX package's
    accumulator over the same splits."""
    _fuzz(spec, weight_mode, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("spec,weight_mode", FUZZ_SPECS)
def test_incremental_equals_from_scratch_on_the_card(spec, weight_mode):
    """The same fuzz with the count table on the card (``index_put_`` and
    the finalize there); the host fit is the reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the accumulator's table lives there")
    _fuzz(spec, weight_mode, "cuda", with_jax=False)


# ----------------------------------------------------- estimator surface ----
def _rows():
    return {
        "lang": ["de"] * 4 + ["en"] * 4,
        "fulltext": [
            "der schnelle braune fuchs", "das ist ja sehr schön",
            "noch ein deutscher satz", "wo ist der bahnhof bitte",
            "the quick brown fox", "that is very nice",
            "one more english sentence", "where is the station please",
        ],
    }


def test_estimator_accumulator_matches_fit():
    rows = _rows()
    det = lambda: _det(["de", "en"], [1, 2], 120)  # noqa: E731
    scratch = det().set_fit_backend("device").fit(Table(rows))
    acc = det().accumulator()
    assert acc.device == torch.device("cpu")
    acc.update(Table({k: v[:3] for k, v in rows.items()}))
    acc.update(Table({k: v[3:] for k, v in rows.items()}))
    model = det().fit_from_accumulator(acc)
    _same_profile((model.profile.ids, model.profile.weights),
                  (scratch.profile.ids, scratch.profile.weights))
    jdet = JaxDetector(["de", "en"], [1, 2], 120)
    jacc = jdet.accumulator()
    jacc.update(JaxTable({k: v[:3] for k, v in rows.items()}))
    jacc.update(JaxTable({k: v[3:] for k, v in rows.items()}))
    jmodel = jdet.fit_from_accumulator(jacc)
    _same_profile((model.profile.ids, model.profile.weights),
                  (jmodel.profile.ids, jmodel.profile.weights))
    out = model.transform(Table({"fulltext": ["ein schöner deutscher text"]}))
    assert list(out.column("lang")) == ["de"]


def _raises_alike(port_call, jax_call, exc, match):
    """Both packages raise ``exc`` with the same message."""
    with pytest.raises(exc, match=match) as mine:
        port_call()
    with pytest.raises(exc, match=match) as ref:
        jax_call()
    assert str(mine.value) == str(ref.value)


def test_accumulator_validations():
    acc = _det(["de", "en"], [1, 2], 50).accumulator()
    jacc = JaxDetector(["de", "en"], [1, 2], 50).accumulator()
    # Unknown label: the reference's message, typo included.
    bad = {"lang": ["fr"], "fulltext": ["bonjour"]}
    _raises_alike(lambda: acc.update(Table(bad)), lambda: jacc.update(JaxTable(bad)),
                  ValueError, "contians fr")
    # Coverage is checked cumulatively at finalize.
    one = {"lang": ["de"], "fulltext": ["hallo welt"]}
    acc.update(Table(one))
    jacc.update(JaxTable(one))
    assert acc.coverage_gaps() == jacc.coverage_gaps() == ["en"]
    _raises_alike(acc.finalize, jacc.finalize, ValueError, "No training examples .* en")
    # Estimator/accumulator config mismatch refuses the refit.
    _raises_alike(
        lambda: _det(["de", "en"], [1, 2, 3], 50).fit_from_accumulator(acc),
        lambda: JaxDetector(["de", "en"], [1, 2, 3], 50).fit_from_accumulator(jacc),
        ValueError, "does not match",
    )
    # trainEncoding is part of the statistic.
    low = _det(["de", "en"], [1, 2], 50).set("trainEncoding", "low_byte")
    with pytest.raises(ValueError, match="does not match"):
        low.fit_from_accumulator(acc)


def test_split_vocab_and_mesh_refused():
    _raises_alike(
        lambda: _det(["de", "en"], [1, 2, 3, 4, 5], 50).set_vocab_mode("exact").accumulator(),
        lambda: JaxDetector(["de", "en"], [1, 2, 3, 4, 5], 50).set_vocab_mode("exact")
        .accumulator(),
        ValueError, "split",
    )
    with pytest.raises(NotImplementedError, match="not ported yet"):
        FitAccumulator(VocabSpec(EXACT, (1, 2)), ("de", "en"), profile_size=5,
                       device="cpu", mesh=object())


def test_empty_update_commits_token():
    acc = _det(["de", "en"], [1, 2], 50).accumulator()
    assert acc.update(Table({"lang": [], "fulltext": []})) == 0
    assert acc.committed == 1 and acc.docs_seen == 0


def test_accumulator_wants_the_card_without_a_device(monkeypatch):
    """With no device named and no card, the accumulator raises, never
    counts on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LanguageDetector(["de", "en"], [1, 2], 50).accumulator()


# --------------------------------------------------------- persistence ------
def test_save_load_resume_bit_exact(tmp_path):
    rows = _rows()
    det = lambda: _det(["de", "en"], [1, 2], 120)  # noqa: E731
    scratch = det().set_fit_backend("device").fit(Table(rows))
    acc = det().accumulator()
    acc.update(Table({k: v[:5] for k, v in rows.items()}))
    state = tmp_path / "state"
    acc.save(state)
    acc.save(state)  # overwriting checkpoint (the per-batch cadence)
    restored = FitAccumulator.load(state, device="cpu")
    assert restored.committed == 1 and restored.docs_seen == 5
    assert restored.matches_estimator(det())
    assert torch.equal(restored.counts, acc.counts)
    restored.update(Table({k: v[5:] for k, v in rows.items()}))
    model = det().fit_from_accumulator(restored)
    _same_profile((model.profile.ids, model.profile.weights),
                  (scratch.profile.ids, scratch.profile.weights))


def test_save_load_keeps_custom_columns(tmp_path):
    det = (
        _det(["de", "en"], [1, 2], 60)
        .set("labelCol", "language")
        .set("inputCol", "body")
        .set_fit_batch_rows(32)
    )
    acc = det.accumulator()
    acc.update(Table({"language": ["de", "en"], "body": ["hallo", "hello"]}))
    acc.save(tmp_path / "state")
    restored = FitAccumulator.load(tmp_path / "state", device="cpu")
    assert restored.label_col == "language"
    assert restored.input_col == "body"
    assert restored.batch_rows == 32
    restored.update(Table({"language": ["de"], "body": ["welt"]}))
    assert restored.docs_seen == 3


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_fit_state_loads_across_packages(tmp_path, direction):
    """A state saved by either package loads in the other with equal ids,
    rows, token, coverage and columns, and finalizes to the same profile."""
    rows = _rows()
    port_acc = _det(["de", "en"], [1, 2, 3], 90).set_hash_bits(12).set_vocab_mode(
        "hashed").accumulator()
    jax_acc = JaxDetector(["de", "en"], [1, 2, 3], 90).set_hash_bits(12).set_vocab_mode(
        "hashed").accumulator()
    for acc, T in ((port_acc, Table), (jax_acc, JaxTable)):
        acc.update(T({k: v[:3] for k, v in rows.items()}))
        acc.update(T({"lang": [], "fulltext": []}))
        acc.update(T({k: v[3:7] for k, v in rows.items()}))
    path = tmp_path / "state"
    if direction == "port_to_jax":
        port_acc.save(path)
        loaded, saved = JaxAccumulator.load(path), port_acc
        ids = np.nonzero(np.asarray(loaded.counts).sum(axis=1) > 0)[0]
        got_rows = np.asarray(loaded.counts)[ids]
    else:
        jax_acc.save(path)
        loaded, saved = FitAccumulator.load(path, device="cpu"), jax_acc
        ids, got_rows = loaded.nonzero_rows()
    want_ids, want_rows = port_acc.nonzero_rows()
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(got_rows, want_rows)
    assert (loaded.committed, loaded.docs_seen) == (saved.committed, saved.docs_seen) == (3, 7)
    np.testing.assert_array_equal(loaded.lang_docs, saved.lang_docs)
    assert loaded.languages == saved.languages
    assert (loaded.spec.mode, loaded.spec.gram_lengths, loaded.spec.hash_bits) == (
        saved.spec.mode, saved.spec.gram_lengths, saved.spec.hash_bits)
    assert (loaded.label_col, loaded.input_col) == ("lang", "fulltext")
    _same_profile(loaded.finalize(), port_acc.finalize())


def test_recover_fit_state_after_interrupted_swap(tmp_path):
    """Killed between the swap's two renames, the checkpoint path holds
    nothing; ``AutoRefit`` recovers the complete sibling and never promotes a
    torn one, even a newer one whose metadata parses."""
    _, batches = _stream_fixture()
    det = lambda: _det(["de", "en"], [1, 2], 80)  # noqa: E731
    state = tmp_path / "state"
    AutoRefit(det(), state_path=str(state), final_refit=False).run(batches, max_batches=3)
    aside = tmp_path / f".state.old.{os.getpid()}"
    os.replace(state, aside)
    assert not state.exists()
    torn = tmp_path / ".state.tmp.99999"
    shutil.copytree(aside, torn)
    shutil.rmtree(torn / "counts")
    torn2 = tmp_path / ".state.tmp.99998"
    (torn2 / "metadata").mkdir(parents=True)
    (torn2 / "metadata" / "part-00000").write_text("{not json")
    assert json.loads((torn / "metadata" / "part-00000").read_text())["committed"] == 3
    resumed = AutoRefit(det(), state_path=str(state))
    assert resumed.acc.committed == 3
    assert state.exists() and not aside.exists()
    assert not torn.exists() and not torn2.exists()
    assert recover_fit_state(state) is False


def test_resume_refuses_short_source(tmp_path):
    _, batches = _stream_fixture()
    state = str(tmp_path / "state")
    det = lambda: _det(["de", "en"], [1, 2], 80)  # noqa: E731
    AutoRefit(det(), state_path=state, final_refit=False).run(batches, max_batches=4)
    with pytest.raises(RuntimeError, match="source does not match"):
        AutoRefit(det(), state_path=state).run(batches[:2])


def test_load_rejects_foreign_directory(tmp_path):
    (tmp_path / "metadata").mkdir()
    (tmp_path / "metadata" / "part-00000").write_text('{"class": "nope"}\n')
    with pytest.raises(ValueError, match="class mismatch"):
        FitAccumulator.load(tmp_path, device="cpu")


def test_poisoned_accumulator_refuses(monkeypatch):
    """A raising update leaves the in-place table partly updated: the
    accumulator refuses further use. Both a replaced count pass and a real
    one failing at its second count step (a ``fit/count`` fault, after the
    first step already wrote into the table) poison it."""
    det = _det(["de", "en"], [1, 2], 50).set_fit_batch_rows(2)
    acc = det.accumulator()
    acc.update(Table({"lang": ["de", "en"], "fulltext": ["hallo", "hello"]}))

    def boom(*a, **k):
        raise RuntimeError("injected mid-update failure")

    monkeypatch.setattr(refit_mod, "accumulate_counts", boom)
    with pytest.raises(RuntimeError, match="injected"):
        acc.update(Table({"lang": ["de"], "fulltext": ["welt"]}))
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="invalidated"):
        acc.update(Table({"lang": ["de"], "fulltext": ["welt"]}))
    with pytest.raises(RuntimeError, match="invalidated"):
        acc.finalize()

    acc = det.accumulator()
    before = acc.counts.clone()
    four = Table({"lang": ["de", "en", "de", "en"],
                  "fulltext": ["aaaa", "bbbb", "cccc", "dddd"]})
    with faults.plan_scope(FaultPlan.parse("fit/count:error@2")):
        with pytest.raises(faults.InjectedFault):
            acc.update(four)
    assert not torch.equal(acc.counts, before)  # the first step landed
    with pytest.raises(RuntimeError, match="invalidated"):
        acc.save("unused")


def test_fit_records_spans_collect_bytes_and_replays_a_count_fault():
    """The device fit records the JAX package's span paths and the
    ``fit/collect_bytes`` counter (winner ids plus winner rows, far below
    the table), and a transient ``fit/count`` fault replays the whole fit
    under the retry policy to the same profile."""
    rows = _rows()
    det = _det(["de", "en"], [1, 2], 30).set_fit_backend("device")
    REGISTRY.reset()
    clean = det.fit(Table(rows))
    stages = REGISTRY.stage_summary()
    assert {"fit", "fit/count", "fit/finalize", "fit/collect"} <= set(stages)
    collect = REGISTRY.snapshot()["counters"]["fit/collect_bytes"]
    table_bytes = 256 * 256 * 2 * 4
    assert 0 < collect < table_bytes // 2
    REGISTRY.reset()
    with faults.plan_scope(FaultPlan.parse("fit/count:error@1")):
        again = det.fit(Table(rows))
    _same_profile((again.profile.ids, again.profile.weights),
                  (clean.profile.ids, clean.profile.weights))
    counters = REGISTRY.snapshot()["counters"]
    assert counters["resilience/retries"] == 1
    assert counters["resilience/faults_injected"] == 1


# ------------------------------------------------------- auto-refit loop ----
def _stream_fixture(T=Table):
    de = ["der alte %d hund schläft %d" % (i, i) for i in range(24)]
    en = ["the old %d dog sleeps %d" % (i, i) for i in range(24)]
    rows = {
        "lang": ["de", "en"] * 24,
        "fulltext": [t for pair in zip(de, en) for t in pair],
    }
    batches = [T({k: v[lo:lo + 8] for k, v in rows.items()}) for lo in range(0, 48, 8)]
    return rows, batches


def test_auto_refit_hot_swaps_bit_exact(tmp_path):
    """Every refit swaps in through the registry with its provenance, and
    the served profile equals the port's from-scratch fit and the JAX
    package's auto-refit's served profile."""
    from spark_languagedetector_tpu.serve import ModelRegistry as JaxRegistry
    from spark_languagedetector_tpu.stream import AutoRefit as JaxAutoRefit

    rows, batches = _stream_fixture()
    det = lambda: _det(["de", "en"], [1, 2], 150).set_fit_backend("device")  # noqa: E731
    registry = ModelRegistry(device="cpu", drain_timeout_s=1.0)
    loop = AutoRefit(det(), registry, state_path=str(tmp_path / "state"),
                       refit_every_batches=2)
    progress = loop.run(batches)
    assert progress.batches == 6 and progress.refits == 3
    assert registry.current_version() == progress.last_version
    served = registry.peek()
    meta = served.describe()["metadata"]
    assert meta == {"refit_token": 6, "docs_seen": 48}
    scratch = det().fit(Table(rows))
    _same_profile((served.model.profile.ids, served.model.profile.weights),
                  (scratch.profile.ids, scratch.profile.weights))
    counters = REGISTRY.snapshot()["counters"]
    assert counters["refit/batches"] >= 6 and counters["refit/refits"] >= 3

    jregistry = JaxRegistry(drain_timeout_s=1.0)
    _, jbatches = _stream_fixture(JaxTable)
    JaxAutoRefit(JaxDetector(["de", "en"], [1, 2], 150).set_fit_backend("device"), jregistry,
                 refit_every_batches=2).run(jbatches)
    jserved = jregistry.peek()
    assert jserved.describe()["metadata"] == meta
    _same_profile((served.model.profile.ids, served.model.profile.weights),
                  (jserved.model.profile.ids, jserved.model.profile.weights))


def test_auto_refit_resumes_from_state(tmp_path):
    rows, batches = _stream_fixture()
    det = lambda: _det(["de", "en"], [1, 2], 150).set_fit_backend("device")  # noqa: E731
    state = str(tmp_path / "state")
    registry = ModelRegistry(device="cpu", drain_timeout_s=1.0)
    AutoRefit(det(), registry, state_path=state, final_refit=False).run(
        batches, max_batches=2
    )
    # The kill: a new AutoRefit on the same state fast-forwards, re-counts nothing.
    second = AutoRefit(det(), registry, state_path=state)
    progress = second.run(batches)
    assert progress.resumed_from == 2
    assert progress.batches == 4
    scratch = det().fit(Table(rows))
    served = registry.peek().model
    _same_profile((served.profile.ids, served.profile.weights),
                  (scratch.profile.ids, scratch.profile.weights))
    with pytest.raises(ValueError, match="different fit configuration"):
        AutoRefit(_det(["de", "en"], [1, 2, 3], 150), state_path=state)


def test_auto_refit_defers_until_coverage():
    only_de = Table({"lang": ["de"] * 4,
                     "fulltext": ["hallo welt %d" % i for i in range(4)]})
    both = Table({"lang": ["de", "en"], "fulltext": ["noch ein satz", "one more sentence"]})
    loop = AutoRefit(_det(["de", "en"], [1, 2], 80), refit_every_batches=1)
    progress = loop.run([only_de, both])
    assert progress.refits >= 1
    assert loop.last_model is not None
    assert loop.acc.coverage_gaps() == []


def test_auto_refit_background_start_stop():
    _, batches = _stream_fixture()
    loop = AutoRefit(
        _det(["de", "en"], [1, 2], 80).set_fit_backend("device"),
        refit_every_batches=100,  # only the final refit
    )
    loop.start(itertools.chain(batches))
    progress = loop.wait(timeout=120)
    assert progress.batches == 6
    assert loop.last_model is not None
    assert loop.stop().batches == 6
    assert not loop._thread.is_alive()
