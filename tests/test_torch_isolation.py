"""The port stands alone: no JAX, no JAX package, no quiet CPU fall-back.

* A subprocess fits and transforms with ``device="cpu"`` (an exact n = 1..3
  model through the fused path and an exact n = 1..5 model through the
  hybrid path) and then finds neither ``jax`` nor
  ``spark_languagedetector_tpu`` in ``sys.modules``.
* A second subprocess, in which ``jax`` and the JAX package cannot be
  imported at all, calibrates a model and transforms in segment mode, fits
  with ``fitBackend="device"``, saves and loads the model and a pipeline
  (whose metadata names the JAX package's classes, as data) and transforms.
* An AST scan finds no import of either anywhere in the port, ``segment/``
  included, nor in ``chip_smoke.py``, and no ``importlib`` in the port's
  pipeline loader, which looks stage classes up in a fixed table.
* With no device given and no CUDA card, the entry points raise.
"""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import spark_languagedetector_tpu_torch as port
from spark_languagedetector_tpu_torch import LanguageDetector, LanguageDetectorModel, Table
from spark_languagedetector_tpu_torch.api.runner import BatchRunner
from spark_languagedetector_tpu_torch.models.profile import GramProfile
from spark_languagedetector_tpu_torch.ops.vocab import VocabSpec
from spark_languagedetector_tpu_torch.utils.device import resolve_device

PORT_DIR = Path(port.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "spark_languagedetector_tpu")


def test_fit_and_transform_leave_jax_unimported():
    script = textwrap.dedent(
        """
        import sys
        from spark_languagedetector_tpu_torch import LanguageDetector, Table
        det = LanguageDetector(["en", "de"], [1, 2, 3], 50, device="cpu")
        model = det.fit(Table({"lang": ["en", "de"] * 3,
                               "fulltext": ["the cat", "der hund", "a dog",
                                            "die katze", "the end", "das ende"]}))
        out = model.transform(Table({"fulltext": ["the dog", "der kater"]}))
        assert out.column("lang").tolist() == ["en", "de"], out.column("lang")
        exact5 = det.copy({"gramLengths": [1, 2, 3, 4, 5], "vocabMode": "exact"})
        model5 = exact5.fit(Table({"lang": ["en", "de"] * 3,
                                   "fulltext": ["the cat", "der hund", "a dog",
                                                "die katze", "the end", "das ende"]}))
        out = model5.transform(Table({"fulltext": ["the dog", "der kater"]}))
        assert out.column("lang").tolist() == ["en", "de"], out.column("lang")
        assert model5.runner.strategy == "hybrid", model5.runner.strategy
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "spark_languagedetector_tpu"))
        assert not bad, bad
        print("isolated")
        """
    )
    res = subprocess.run(
        [sys.executable, "-c", script],
        cwd=PORT_DIR.parent, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("isolated")


def test_segment_mode_runs_with_jax_unimportable():
    script = textwrap.dedent(
        """
        import json, sys
        for name in ("jax", "jaxlib", "spark_languagedetector_tpu"):
            sys.modules[name] = None  # any import of it raises ImportError
        from spark_languagedetector_tpu_torch import LanguageDetector, Table
        table = Table({"lang": ["en", "de"] * 3,
                       "fulltext": ["the cat sat", "der hund lief", "a dog barks",
                                    "die katze schläft", "the end is near",
                                    "das ende ist nah"]})
        model = LanguageDetector(["en", "de"], [1, 2, 3], 50, device="cpu").fit(table)
        model.calibrate(table)
        seg = model.copy({"resultMode": "segment"})
        doc = "the dog barks " * 40 + "der hund und die katze " * 30
        out = seg.transform(Table({"fulltext": [doc, ""]})).column("lang").tolist()
        first = json.loads(out[0])
        assert first["calibrated"] and [s["lang"] for s in first["spans"]] == ["en", "de"], first
        assert first["spans"][0]["start"] == 0 and first["spans"][-1]["end"] == len(doc)
        assert json.loads(out[1])["spans"] == []
        assert seg.detect("der hund")["label"] == "de"

        import tempfile
        from spark_languagedetector_tpu_torch import (
            LanguageDetectorModel, LowerCasePreprocessor, Pipeline, PipelineModel)
        det = LanguageDetector(["en", "de"], [1, 2, 3, 4, 5], 50, device="cpu")
        for vocab in ("hashed", "exact"):
            dev_fit = det.copy({"fitBackend": "device", "vocabMode": vocab}).fit(table)
            host_fit = det.copy({"vocabMode": vocab}).fit(table)
            assert (dev_fit.profile.ids == host_fit.profile.ids).all()
            assert (dev_fit.profile.weights == host_fit.profile.weights).all()
        dev_fit.calibrate(table)
        out_dir = tempfile.mkdtemp()
        dev_fit.write().quantized("int16").save(out_dir + "/model")
        back = LanguageDetectorModel.load(out_dir + "/model", device="cpu")
        assert back.calibration.to_dict() == dev_fit.calibration.to_dict()
        probe = Table({"fulltext": ["the dog barks", "der hund"]})
        assert back.transform(probe).column("lang").tolist() == ["en", "de"]
        lower = LowerCasePreprocessor().set_input_col("fulltext")
        pipe = Pipeline([lower, det.copy({"fitBackend": "device"})])
        pipe.save(out_dir + "/pipe")
        pm = Pipeline.load(out_dir + "/pipe", device="cpu").fit(table)
        pm.stages[-1].set("outputCol", "detected")
        pm.save(out_dir + "/pm")
        loaded = PipelineModel.load(out_dir + "/pm", device="cpu")
        labeled = Table({"fulltext": ["THE DOG BARKS", "DER HUND"], "lang": ["en", "de"]})
        assert loaded.transform(labeled).column("detected").tolist() == ["en", "de"]
        meta = json.load(open(out_dir + "/pm/metadata/part-00000"))
        assert meta["class"] == "spark_languagedetector_tpu.api.pipeline.PipelineModel"
        bad = sorted(m for m, mod in sys.modules.items() if mod is not None
                     and m.split(".")[0] in ("jax", "jaxlib", "spark_languagedetector_tpu"))
        assert not bad, bad
        try:
            import jax
        except ImportError:
            print("isolated")
        """
    )
    res = subprocess.run(
        [sys.executable, "-c", script],
        cwd=PORT_DIR.parent, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("isolated")


def test_no_module_of_the_port_imports_jax():
    offenders = []
    for path in sorted(PORT_DIR.rglob("*.py")) + [PORT_DIR.parent / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [
                f"{path.relative_to(PORT_DIR.parent)}:{node.lineno} {n}"
                for n in names
                if n.split(".")[0] in FORBIDDEN
            ]
    assert not offenders, offenders
    scanned = {p.name for p in PORT_DIR.rglob("*.py")}
    assert len(scanned) >= 15
    assert {"cuckoo.py", "bucket.py", "score_hist.py", "score_pallas.py"} <= scanned
    assert {"fit_tpu.py", "fit_pipeline.py", "io.py", "pipeline.py", "preprocessing.py",
            "language.py", "logging.py"} <= scanned
    assert {"api.py", "spans.py", "topk.py", "calibrate.py"} <= {
        p.name for p in (PORT_DIR / "segment").glob("*.py")
    }


def test_pipeline_loader_imports_nothing_by_name():
    """The port's pipeline loader looks stage classes up in a fixed table:
    no ``importlib`` (nor ``__import__``) anywhere in ``api/pipeline.py``,
    so stored class strings never become imports."""
    path = PORT_DIR / "api" / "pipeline.py"
    calls = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            calls += [a.name for a in node.names if a.name.split(".")[0] == "importlib"]
        elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith("importlib"):
            calls.append(node.module)
        elif isinstance(node, ast.Name) and node.id in ("importlib", "__import__"):
            calls.append(node.id)
        elif isinstance(node, ast.Attribute) and node.attr == "import_module":
            calls.append(node.attr)
    assert not calls, calls
    from spark_languagedetector_tpu_torch.api import pipeline

    assert set(pipeline._STAGE_CLASSES.values()) == set(pipeline._WRITE_NAME)
    assert all(name.startswith("spark_languagedetector_tpu.") for name in pipeline._WRITE_NAME.values())


def test_entry_points_without_device_raise_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    table = Table({"lang": ["en", "de"], "fulltext": ["the cat", "der hund"]})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LanguageDetector(["en", "de"], [1, 2], 10).fit(table)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LanguageDetector(["en", "de"], [1, 2], 10).set_fit_backend("device").fit(table)
    profile = GramProfile.from_gram_map({b"a": [1.0, 0.0]}, ["en", "de"], [1, 2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LanguageDetectorModel(profile).transform(Table({"fulltext": ["a"]}))
    w, lut = profile.host_membership()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchRunner(weights=w, lut=lut, spec=profile.spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile.device_arrays()
    # Asked for explicitly, the CPU runs the plain versions.
    model = LanguageDetectorModel.from_gram_map(
        {b"a": [1.0, 0.0]}, [1, 2], ["en", "de"], device="cpu"
    )
    assert model.detect("a") == "en"


def test_exact_long_grams_name_the_later_slice():
    """Exact gram lengths > 3 were refused until the cuckoo slice; now their
    device view is a cuckoo table (no dense form, no LUT) and a model built
    on one labels documents."""
    profile = GramProfile.from_gram_map(
        {b"abcd": [0.0, 2.0], b"ab": [1.0, 0.0], b"q": [0.5, 0.0]},
        ["en", "de"], [1, 2, 3, 4],
    )
    with pytest.raises(ValueError, match="device_membership"):
        profile.host_membership()
    w, lut, cuckoo = profile.device_membership(device="cpu")
    assert lut is None and cuckoo is not None and cuckoo.num_slots >= 16
    assert tuple(w.shape) == (4, 2) and not w[-1].any()  # zeros miss row
    model = LanguageDetectorModel(profile, device="cpu")
    assert model.transform(Table({"fulltext": ["xabcdx", "abq", ""]})).column(
        "lang"
    ).tolist() == ["de", "en", "en"]
    assert model.runner.strategy == "hybrid"
