"""Model persistence of the port against the JAX package's.

Models fitted in both packages on one corpus (numpy seed) are saved by one
package and loaded by the other: exact n = 1..3, hashed exact12 n = 1..5 and
exact n = 1..5 (cuckoo) profiles, the int8/int16 codec, the calibration,
the reference (Spark) layout, the gram dump and the overwrite contract.
Profiles and calibrations must come back bit for bit; a reloaded model must
score bit for bit as before the save in its package, and label as the other
package's model does.
"""

import functools
import json

import numpy as np
import pyarrow.parquet as pq
import pytest

from spark_languagedetector_tpu import LanguageDetector as JaxDetector
from spark_languagedetector_tpu import LanguageDetectorModel as JaxModel
from spark_languagedetector_tpu import Table as JaxTable
from spark_languagedetector_tpu.persist import io as jio
from spark_languagedetector_tpu_torch import LanguageDetector, LanguageDetectorModel, Table
from spark_languagedetector_tpu_torch.models.profile import dequantize_weights, quantize_weights
from spark_languagedetector_tpu_torch.persist import io as tio

LANGS = ["aa", "bb", "cc", "dd"]
CONFIGS = {
    "exact_n1_3": ([1, 2, 3], "exact"),
    "hashed_exact12_n1_5": ([1, 2, 3, 4, 5], "hashed"),
    "exact_n1_5_cuckoo": ([1, 2, 3, 4, 5], "exact"),
}
JAX_CLASS = "spark_languagedetector_tpu.models.estimator.LanguageDetectorModel"
SPARK_CLASS = "org.apache.spark.ml.feature.languagedetection.LanguageDetectorModel"


def _corpus(n_per_lang, seed, mean_words=15):
    rng = np.random.default_rng(seed)
    alphabet = list("abcdefghijklmnopéèäöü")
    vocab = [
        ["".join(rng.choice(alphabet[4 * i : 4 * i + 8], int(rng.integers(2, 6))))
         for _ in range(25)]
        for i in range(len(LANGS))
    ]
    texts, labels = [], []
    for k in range(n_per_lang * len(LANGS)):
        i = k % len(LANGS)
        texts.append(" ".join(rng.choice(vocab[i], max(1, int(rng.normal(mean_words, 4))))))
        labels.append(LANGS[i])
    return texts, labels


EVAL = _corpus(5, seed=2, mean_words=5)[0] + ["", "a", "éé", "zzzz"]


@functools.lru_cache(maxsize=None)
def _fitted(name):
    grams, vocab = CONFIGS[name]
    texts, labels = _corpus(12, seed=1)
    jax_model = (
        JaxDetector(LANGS, grams, 40).set_vocab_mode(vocab).set_hash_bits(14)
        .fit(JaxTable({"lang": labels, "fulltext": texts}))
    )
    model = (
        LanguageDetector(LANGS, grams, 40, device="cpu").set_vocab_mode(vocab)
        .set_hash_bits(14).fit(Table({"lang": labels, "fulltext": texts}))
    )
    np.testing.assert_array_equal(model.profile.ids, jax_model.profile.ids)
    return jax_model, model


def _labels(model, table_cls):
    return model.transform(table_cls({"fulltext": EVAL})).column("lang").tolist()


def _scores(model):
    return model.runner.score([t.encode() for t in EVAL])


def _same_profile(a, b):
    assert a.spec.mode == b.spec.mode and a.spec.gram_lengths == b.spec.gram_lengths
    if a.spec.mode == "hashed":  # an exact spec ignores them (the Spark layout has none)
        assert (a.spec.hash_bits, a.spec.hash_scheme) == (b.spec.hash_bits, b.spec.hash_scheme)
    assert tuple(a.languages) == tuple(b.languages)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.weights, b.weights)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_save_loads_in_jax_and_port(name, tmp_path):
    jax_model, model = _fitted(name)
    model.set("outputCol", "lang")  # an explicitly set param rides along
    model.write().save(str(tmp_path / "m"))
    meta = json.loads((tmp_path / "m" / "metadata" / "part-00000").read_text())
    assert meta["class"] == JAX_CLASS
    assert "device" not in {**meta["paramMap"]["params"], **meta["paramMap"]["defaultParams"]}
    jloaded = JaxModel.load(str(tmp_path / "m"))
    tloaded = LanguageDetectorModel.load(str(tmp_path / "m"), device="cpu")
    assert jloaded.uid == tloaded.uid == model.uid
    _same_profile(jloaded.profile, model.profile)
    _same_profile(tloaded.profile, model.profile)
    assert tloaded.get("outputCol") == "lang" and tloaded.calibration is None
    np.testing.assert_array_equal(_scores(tloaded), _scores(model))
    labels = _labels(model, Table)
    assert _labels(tloaded, Table) == labels == _labels(jloaded, JaxTable)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_jax_save_loads_in_port(name, tmp_path):
    jax_model, model = _fitted(name)
    jax_model.write().save(str(tmp_path / "m"))
    tloaded = LanguageDetectorModel.load(str(tmp_path / "m"), device="cpu")
    assert tloaded.uid == jax_model.uid
    _same_profile(tloaded.profile, jax_model.profile)
    np.testing.assert_array_equal(_scores(tloaded), _scores(model))
    assert _labels(tloaded, Table) == _labels(jax_model, JaxTable) == _labels(model, Table)
    # Without device= the JAX save names no device: the card, which is absent here.
    assert LanguageDetectorModel.load(str(tmp_path / "m")).get("device") is None


@pytest.mark.parametrize("saver", ["port", "jax"])
@pytest.mark.parametrize("dtype", ["int8", "int16"])
@pytest.mark.parametrize("name", ["exact_n1_3", "hashed_exact12_n1_5"])
def test_quantized_save_reloads_as_q_times_scale(name, dtype, saver, tmp_path):
    """Integer rows + per-language scales reload as ``q * scale`` (float64
    product of the stored integers and the f32 scales) bit for bit in both
    packages, and requantize to the stored integers, so the reloaded
    model's quantized scores equal the pre-save quantized model's."""
    jax_model, model = _fitted(name)
    path = str(tmp_path / "q")
    (model if saver == "port" else jax_model).write().quantized(dtype).save(path)
    meta = json.loads((tmp_path / "q" / "metadata" / "part-00000").read_text())
    assert meta["quantization"]["dtype"] == dtype
    compact = model.profile.compacted()
    q, scales = quantize_weights(compact.weights, dtype)
    want = q.astype(np.float64) * scales.astype(np.float64)
    for loaded in (LanguageDetectorModel.load(path, device="cpu"), JaxModel.load(path)):
        np.testing.assert_array_equal(loaded.profile.compacted().ids, compact.ids)
        np.testing.assert_array_equal(loaded.profile.compacted().weights, want)
    tloaded = LanguageDetectorModel.load(path, device="cpu")
    q2, s2 = quantize_weights(tloaded.profile.compacted().weights, dtype)
    np.testing.assert_array_equal(q2, q)
    np.testing.assert_array_equal(s2, scales)
    np.testing.assert_array_equal(dequantize_weights(q2, s2), dequantize_weights(q, scales))
    before = model.copy({"quantization": dtype})
    after = tloaded.copy({"quantization": dtype})
    assert after.runner.layout.quant == dtype
    np.testing.assert_array_equal(_scores(after), _scores(before))
    assert _labels(after, Table) == _labels(before, Table)


def _calibrated(name):
    jax_model, model = _fitted(name)
    held, held_labels = _corpus(3, seed=9)
    model = model.copy()
    model.calibrate(Table({"fulltext": held, "lang": held_labels}))
    return model


@pytest.mark.parametrize("name", ["hashed_exact12_n1_5", "exact_n1_3"])
def test_calibration_round_trips_both_ways(name, tmp_path):
    model = _calibrated(name)
    assert model.calibration.calibrated
    model.write().save(str(tmp_path / "c"))
    tloaded = LanguageDetectorModel.load(str(tmp_path / "c"), device="cpu")
    jloaded = JaxModel.load(str(tmp_path / "c"))
    assert tloaded.calibration.to_dict() == model.calibration.to_dict()
    assert jloaded.calibration.to_dict() == model.calibration.to_dict()
    assert tloaded.calibration.version == model.calibration.version
    seg_before = model.copy({"resultMode": "segment"})
    seg_before.calibration = model.calibration
    seg_after = tloaded.copy({"resultMode": "segment"})
    docs = Table({"fulltext": EVAL + [" ".join(EVAL)]})
    got = seg_after.transform(docs).column("lang").tolist()
    assert got == seg_before.transform(docs).column("lang").tolist()
    assert all(json.loads(r)["calibrated"] for r in got)
    # The JAX package's calibrated save loads here with the same state.
    jloaded.write().save(str(tmp_path / "cj"))
    back = LanguageDetectorModel.load(str(tmp_path / "cj"), device="cpu")
    assert back.calibration.to_dict() == model.calibration.to_dict()


def test_uncalibrated_model_stays_uncalibrated(tmp_path):
    jax_model, model = _fitted("exact_n1_3")
    model.write().save(str(tmp_path / "u"))
    meta = json.loads((tmp_path / "u" / "metadata" / "part-00000").read_text())
    assert "calibration" not in meta
    loaded = LanguageDetectorModel.load(str(tmp_path / "u"), device="cpu")
    assert loaded.calibration is None and JaxModel.load(str(tmp_path / "u")).calibration is None
    seg = loaded.copy({"resultMode": "segment"})
    assert json.loads(seg.transform(Table({"fulltext": ["aab"]})).column("lang")[0])[
        "calibrated"] is False


@pytest.mark.parametrize("name", ["exact_n1_3", "exact_n1_5_cuckoo"])
def test_reference_layout_carries_spark_class_and_signed_bytes(name, tmp_path):
    model = _calibrated(name)
    path = tmp_path / "ref"
    model.write().reference_layout().save(str(path))
    meta = json.loads((path / "metadata" / "part-00000").read_text())
    assert meta["class"] == SPARK_CLASS and meta["sparkVersion"] == "2.2.0"
    assert set(meta["paramMap"]) <= {"inputCol", "outputCol"}
    assert "calibration" not in meta  # no field for it: dropped
    table = pq.read_table(sorted((path / "probabilities").glob("*.parquet"))[0])
    assert table.column_names == ["_1", "_2"]
    grams = table["_1"].to_pylist()
    assert any(b < 0 for g in grams for b in g)  # é's bytes as signed JVM bytes
    want = {model.profile.spec.id_to_gram(int(i)) for i in model.profile.ids}
    assert {np.asarray(g, np.int8).astype(np.uint8).tobytes() for g in grams} == want
    for loaded in (LanguageDetectorModel.load(str(path), device="cpu"), JaxModel.load(str(path))):
        _same_profile(loaded.profile, model.profile)
        assert loaded.calibration is None
    # The JAX package's reference-layout save loads here too.
    _fitted(name)[0].write().reference_layout().save(str(tmp_path / "jref"))
    back = LanguageDetectorModel.load(str(tmp_path / "jref"), device="cpu")
    _same_profile(back.profile, model.profile)
    assert _labels(back, Table) == _labels(model, Table)


def test_reference_layout_and_quantize_refusals(tmp_path):
    _, hashed = _fitted("hashed_exact12_n1_5")
    with pytest.raises(ValueError, match="exact"):
        hashed.write().reference_layout().save(str(tmp_path / "x"))
    _, exact = _fitted("exact_n1_3")
    with pytest.raises(ValueError, match="native-layout"):
        exact.write().reference_layout().quantized("int8").save(str(tmp_path / "y"))
    with pytest.raises(ValueError, match="quantize dtype"):
        exact.write().quantized("int4").save(str(tmp_path / "z"))
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("name", ["exact_n1_3", "hashed_exact12_n1_5"])
def test_gram_dump_equals_jax_dump(name, tmp_path):
    jax_model, model = _fitted(name)
    tio.save_gram_dump(tmp_path / "t", model.profile)
    jio.save_gram_dump(tmp_path / "j", jax_model.profile)
    read = [pq.read_table(sorted((tmp_path / d).glob("*.parquet"))[0]) for d in ("t", "j")]
    assert read[0].equals(read[1])
    assert read[0].column_names[0] == ("gram" if name == "exact_n1_3" else "bucket")
    # The estimator's saveGrams param writes the same dump after a fit.
    texts, labels = _corpus(12, seed=1)
    grams, vocab = CONFIGS[name]
    (LanguageDetector(LANGS, grams, 40, device="cpu").set_vocab_mode(vocab).set_hash_bits(14)
     .set_save_grams_to(str(tmp_path / "s")).fit(Table({"lang": labels, "fulltext": texts})))
    assert pq.read_table(sorted((tmp_path / "s").glob("*.parquet"))[0]).equals(read[1])


def test_load_without_device_wants_the_card(tmp_path, monkeypatch):
    """The device is the session's: a model saved from a device='cpu'
    session loads onto the card when the loader names no device, and
    transform raises where there is none instead of running on the CPU."""
    import torch

    _, model = _fitted("exact_n1_3")
    assert model.get("device") == "cpu"
    model.write().save(str(tmp_path / "m"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loaded = LanguageDetectorModel.load(str(tmp_path / "m"))
    assert loaded.get("device") is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loaded.transform(Table({"fulltext": EVAL}))
    assert LanguageDetectorModel.load(str(tmp_path / "m"), device="cpu").get("device") == "cpu"


def test_overwrite_versus_fail_if_exists(tmp_path):
    path = str(tmp_path / "model")
    m1 = LanguageDetectorModel.from_gram_map({b"a": [1.0]}, [1], ["aa"], device="cpu")
    m1.write().save(path)
    with pytest.raises(FileExistsError):
        m1.write().save(path)
    m2 = LanguageDetectorModel.from_gram_map({b"b": [2.0]}, [1], ["aa"], device="cpu")
    m2.save(path)  # save() overwrites, as the reference's writer does
    assert LanguageDetectorModel.load(path).gram_probabilities.keys() == {b"b"}
    m1.write().overwrite().save(path)
    assert JaxModel.load(path).gram_probabilities.keys() == {b"a"}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["model"]  # no temp siblings


def test_failed_save_keeps_the_previous_model(tmp_path, monkeypatch):
    path = tmp_path / "model"
    LanguageDetectorModel.from_gram_map({b"a": [1.0]}, [1], ["aa"]).save(str(path))

    def broken(p, table):
        raise OSError("disk full")

    monkeypatch.setattr(tio, "_write_parquet", broken)
    with pytest.raises(OSError, match="disk full"):
        LanguageDetectorModel.from_gram_map({b"b": [1.0]}, [1], ["aa"]).save(str(path))
    monkeypatch.undo()
    assert LanguageDetectorModel.load(str(path)).gram_probabilities.keys() == {b"a"}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["model"]


def test_load_refuses_a_foreign_class(tmp_path):
    path = tmp_path / "model"
    LanguageDetectorModel.from_gram_map({b"a": [1.0]}, [1], ["aa"]).save(str(path))
    meta_file = path / "metadata" / "part-00000"
    meta = json.loads(meta_file.read_text())
    meta["class"] = "spark_languagedetector_tpu_torch.models.estimator.LanguageDetectorModel"
    meta_file.write_text(json.dumps(meta) + "\n")
    with pytest.raises(ValueError, match="class mismatch"):
        LanguageDetectorModel.load(str(path))
