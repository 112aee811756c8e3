"""The port's Pipeline, preprocessors and Language against the JAX package's.

The same tables go through both packages: the preprocessors and Language
must give the JAX package's results exactly; a pipeline (lower-case →
special-char → detector) must fit the same profile and label identically;
fitted and unfitted pipelines saved by either package must load in the
other and transform identically.
"""

import json

import numpy as np
import pytest

import spark_languagedetector_tpu as jax_pkg
import spark_languagedetector_tpu_torch as port_pkg
from spark_languagedetector_tpu_torch import (
    ISO_LANGUAGE_CODES,
    Language,
    LanguageDetector,
    LowerCasePreprocessor,
    Pipeline,
    PipelineModel,
    SpecialCharPreprocessor,
    Table,
)
from spark_languagedetector_tpu_torch.api import pipeline as port_pipeline

LANGS = ["de", "en", "tr"]
ROWS = {
    "lang": ["de"] * 4 + ["en"] * 4 + ["tr"] * 4,
    "fulltext": [
        "Dies ist ein (deutscher) Text",
        "Das ist ja SEHR schön",
        "Dieser Text ist  auch deutsch",
        "Und noch ein deutscher Satz!",
        "This is an {english} text",
        "That is VERY nice indeed",
        "This text is also english",
        "And one more english sentence",
        "IŞIK İstanbul ILIK",
        "Bu bir Türkçe METİN",
        "Işık ve ılık <su>",
        "Bir cümle daha İşte",
    ],
}
PROBE = {
    "lang": ["de", "en", "tr", "en"],
    "fulltext": ["Schöner (Text) HIER", "nice {TEXT} indeed", "ILIK SU", ""],
}
JAX_PREFIX = "spark_languagedetector_tpu."


def _stages(pkg):
    lower = pkg.LowerCasePreprocessor().set_input_col("fulltext")
    clean = pkg.SpecialCharPreprocessor().set_input_col("fulltext")
    return [lower, clean]


def _port_pipeline():
    return Pipeline(_stages(port_pkg) + [LanguageDetector(LANGS, [1, 2, 3], 60, device="cpu")])


def _jax_pipeline():
    return jax_pkg.Pipeline(_stages(jax_pkg) + [jax_pkg.LanguageDetector(LANGS, [1, 2, 3], 60)])


def _detected(model, table_cls):
    model.stages[-1].set("outputCol", "detected")
    return model.transform(table_cls(PROBE)).column("detected").tolist()


@pytest.mark.parametrize(
    "rows",
    [
        ROWS,
        {"lang": ["tr", "az", "en", "tr-TR", ""], "fulltext": [
            "IŞIK İstanbul", "İI", "III", "DİYARBAKIR", "ÀÉÎ"]},
        {"lang": ["en"], "fulltext": ['a/b_c[d]e*f(g)h%i^j&k@l$m#n:o|p{q}r<s>t~u`v"w\\x  y\t\nz']},
    ],
)
def test_preprocessors_match_jax(rows):
    for name in ("LowerCasePreprocessor", "SpecialCharPreprocessor"):
        got = getattr(port_pkg, name)().transform(Table(rows))
        ref = getattr(jax_pkg, name)().transform(jax_pkg.Table(rows))
        assert got.schema.names == ref.schema.names
        assert got.column("fulltext").tolist() == ref.column("fulltext").tolist()


def test_preprocessor_quirks_kept():
    """setInputCol sets outputCol, and the column moves last (SURVEY.md
    §2.9 Q8), as in the JAX package."""
    p = LowerCasePreprocessor().set_input_col("body")
    assert p.get_output_col() == "body"
    t = Table({"body": ["ABC"], "lang": ["en"], "id": [1]})
    out = p.transform(t)
    assert out.schema.names == ["lang", "id", "body"] and out.column("body").tolist() == ["abc"]
    assert SpecialCharPreprocessor().transform_schema(Table({"fulltext": ["x"], "k": [1]}).schema).names == ["k", "fulltext"]


def test_language_matches_jax():
    assert ISO_LANGUAGE_CODES == jax_pkg.ISO_LANGUAGE_CODES
    assert len(ISO_LANGUAGE_CODES) == 182
    for code in ("ab", "de", "zu", "en"):
        assert Language.with_name(code).id == jax_pkg.Language.with_name(code).id
        assert str(Language(code)) == code
    assert Language("de") == Language.with_name("de") and Language("de") != Language("en")
    assert Language.is_supported("en") and not Language.is_supported("xx")
    with pytest.raises(KeyError, match="No language with name"):
        Language("xx")


def test_pipeline_fit_transform_matches_jax():
    model = _port_pipeline().fit(Table(ROWS))
    jmodel = _jax_pipeline().fit(jax_pkg.Table(ROWS))
    assert isinstance(model, PipelineModel) and len(model.stages) == 3
    p, jp = model.stages[-1].profile, jmodel.stages[-1].profile
    np.testing.assert_array_equal(p.ids, jp.ids)
    np.testing.assert_array_equal(p.weights, jp.weights)
    grams = set(model.stages[-1].gram_probabilities)
    assert not any(any(0x41 <= b <= 0x5A for b in g) for g in grams)  # lower-cased
    assert not any(b"(" in g or b"{" in g for g in grams)  # symbols stripped
    assert _detected(model, Table) == _detected(jmodel, jax_pkg.Table)


def test_stage_after_estimator_not_applied_during_fit():
    det = LanguageDetector(LANGS, [2, 3], 50, device="cpu")
    post = SpecialCharPreprocessor().set_input_col("fulltext")
    model = Pipeline([det, post]).fit(Table(ROWS))  # the model's 'lang' would collide
    model.stages[0].set("outputCol", "detected")
    out = model.transform(Table({"fulltext": ["Dies ist ein deutscher Text"]}))
    assert out.column("detected").tolist() == ["de"]
    with pytest.raises(TypeError):
        Pipeline([object()])


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_fitted_pipeline_loads_across_packages(direction, tmp_path):
    path = str(tmp_path / "pipe")
    if direction == "port_to_jax":
        model = _port_pipeline().fit(Table(ROWS))
        model.stages[-1].set("outputCol", "detected")
        model.write().save(path)
        loaded = jax_pkg.PipelineModel.load(path)
        want, got = _detected(model, Table), _detected(loaded, jax_pkg.Table)
        meta = json.loads((tmp_path / "pipe" / "metadata" / "part-00000").read_text())
        assert meta["class"] == JAX_PREFIX + "api.pipeline.PipelineModel"
        assert all(s["class"].startswith(JAX_PREFIX + "models.") for s in meta["stages"])
    else:
        model = _jax_pipeline().fit(jax_pkg.Table(ROWS))
        model.stages[-1].set("outputCol", "detected")
        model.write().save(path)
        loaded = PipelineModel.load(path, device="cpu")
        want, got = _detected(model, jax_pkg.Table), _detected(loaded, Table)
    assert loaded.uid == model.uid
    assert [s.uid for s in loaded.stages] == [s.uid for s in model.stages]
    assert [type(s).__name__ for s in loaded.stages] == [
        "LowerCasePreprocessor", "SpecialCharPreprocessor", "LanguageDetectorModel"]
    assert loaded.stages[-1].get("outputCol") == "detected"
    np.testing.assert_array_equal(loaded.stages[-1].profile.weights,
                                  model.stages[-1].profile.weights)
    assert got == want


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port", "port_to_port"])
def test_unfitted_pipeline_loads_across_packages(direction, tmp_path):
    """The estimator rebuilds from its params (an explicit weightMode set
    survives) and fitting the loaded pipeline gives the same model."""
    path = str(tmp_path / "unfitted")
    src = _jax_pipeline() if direction == "jax_to_port" else _port_pipeline()
    src.stages[-1].set("weightMode", "counts")
    src.write().save(path)
    loaded = (jax_pkg.Pipeline.load(path) if direction == "port_to_jax"
              else Pipeline.load(path, device="cpu"))
    det = loaded.stages[-1]
    assert loaded.uid == src.uid
    assert det.get("supportedLanguages") == LANGS and det.get("gramLengths") == [1, 2, 3]
    assert det.get("weightMode") == "counts" and det.get("languageProfileSize") == 60
    m_loaded = loaded.fit((jax_pkg.Table if direction == "port_to_jax" else Table)(ROWS))
    m_port = _port_pipeline().stages[-1].set("weightMode", "counts")
    m_port = Pipeline(_stages(port_pkg) + [m_port]).fit(Table(ROWS))
    np.testing.assert_array_equal(m_loaded.stages[-1].profile.ids, m_port.stages[-1].profile.ids)
    np.testing.assert_array_equal(m_loaded.stages[-1].profile.weights,
                                  m_port.stages[-1].profile.weights)


def test_loaded_pipeline_without_device_wants_the_card(tmp_path, monkeypatch):
    """No save names a device: a pipeline fitted and saved with
    device='cpu' loads onto the card when the loader names none, and fit
    and transform raise where there is none."""
    import torch

    pipe = _port_pipeline()
    assert pipe.stages[-1].get("device") == "cpu"
    pipe.save(str(tmp_path / "pipe"))
    fitted = pipe.fit(Table(ROWS))
    fitted.stages[-1].set("outputCol", "detected")
    fitted.save(str(tmp_path / "pm"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loaded_pipe = Pipeline.load(str(tmp_path / "pipe"))
    loaded_pm = PipelineModel.load(str(tmp_path / "pm"))
    assert loaded_pipe.stages[-1].get("device") is None
    assert loaded_pm.stages[-1].get("device") is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loaded_pipe.fit(Table(ROWS))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loaded_pm.transform(Table(PROBE))
    cpu_pm = PipelineModel.load(str(tmp_path / "pm"), device="cpu")
    assert _detected(cpu_pm, Table) == _detected(fitted, Table)


def test_pipeline_save_contract_and_class_table(tmp_path, monkeypatch):
    """fail-if-exists without overwrite(); a mid-save failure keeps the old
    save and leaves no temp tree; the loader refuses a class outside its
    table and a stage directory outside stages/; the writer refuses a stage
    it could not load back."""
    model = _port_pipeline().fit(Table(ROWS))
    path = tmp_path / "pipe"
    model.write().save(str(path))
    with pytest.raises(FileExistsError):
        model.write().save(str(path))
    model.save(str(path))

    def broken(self, tmp):
        raise OSError("disk full")

    monkeypatch.setattr(port_pipeline._PipelineWriter, "_write_tree", broken)
    with pytest.raises(OSError, match="disk full"):
        model.save(str(path))
    monkeypatch.undo()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["pipe"]
    assert len(PipelineModel.load(str(path), device="cpu").stages) == 3

    meta_file = path / "metadata" / "part-00000"
    meta = json.loads(meta_file.read_text())
    for field, bad, match in (("class", "os.path.join", "refusing pipeline stage class"),
                              ("dir", "../../etc", "refusing stage directory")):
        broken_meta = json.loads(json.dumps(meta))
        broken_meta["stages"][0][field] = bad
        meta_file.write_text(json.dumps(broken_meta) + "\n")
        with pytest.raises(ValueError, match=match):
            PipelineModel.load(str(path))
    meta_file.write_text(json.dumps(meta) + "\n")

    class Custom:
        uid = "Custom_1"

        def transform(self, t):
            return t

    with pytest.raises(TypeError, match="cannot persist"):
        PipelineModel([Custom()]).save(str(tmp_path / "custom"))
