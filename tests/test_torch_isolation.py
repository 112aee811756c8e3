"""The port stands alone: no JAX, no JAX package, no quiet CPU fall-back.

* A subprocess fits and transforms with ``device="cpu"`` and then finds
  neither ``jax`` nor ``spark_languagedetector_tpu`` in ``sys.modules``.
* An AST scan finds no import of either anywhere in the port.
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


def test_no_module_of_the_port_imports_jax():
    offenders = []
    for path in sorted(PORT_DIR.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [
                f"{path.relative_to(PORT_DIR)}:{node.lineno} {n}"
                for n in names
                if n.split(".")[0] in FORBIDDEN
            ]
    assert not offenders, offenders
    assert len(list(PORT_DIR.rglob("*.py"))) >= 15


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
    profile = GramProfile(
        spec=VocabSpec("exact", (1, 2, 3, 4)),
        languages=("en",),
        ids=np.asarray([5], np.int64),
        weights=np.ones((1, 1)),
    )
    with pytest.raises(NotImplementedError, match="later slice"):
        profile.host_membership()
