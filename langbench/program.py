"""The system under test, as the benchmark drives it.

The only module of the benchmark that imports the program
(``spark_languagedetector_tpu_torch``): it builds the estimator a
configuration states and hands the harness the program's span registry and
its kernel build directory. The entry points call the program's public API
through what is built here; nothing else of the benchmark reaches into the
program.
"""

from __future__ import annotations

from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def use_checkout_build_dirs() -> None:
    """Keep the program's compiled kernels in ``build/kernels`` of this
    checkout (a fixed path, so a second run finds them built)."""
    from spark_languagedetector_tpu_torch.ops import _kernels

    _kernels.set_build_dir(CHECKOUT / "build" / "kernels")


def registry():
    """The program's telemetry registry (its spans are read from there)."""
    from spark_languagedetector_tpu_torch.telemetry import REGISTRY

    return REGISTRY


def table(columns: dict):
    """A program ``Table`` of ``columns``."""
    from spark_languagedetector_tpu_torch import Table

    return Table(columns)


def estimator(config: dict, languages, device: str):
    """The ``LanguageDetector`` that ``config`` states, on ``device``."""
    from spark_languagedetector_tpu_torch import LanguageDetector

    det = (
        LanguageDetector(languages, list(config["gramLengths"]),
                         int(config["languageProfileSize"]), device=device)
        .set_vocab_mode(config["vocabMode"])
        .set_weight_mode(config.get("weightMode", "parity"))
        .set_fit_backend(config["fitBackend"])
    )
    if config["vocabMode"] == "hashed":
        det = det.set_hash_bits(int(config["hashBits"])).set_hash_scheme(config["hashScheme"])
    if config.get("dtype", "float32") != "float32":
        det = det.set_quantization(config["dtype"])
    return det


def fitted_model(config: dict, languages, texts, labels, device: str):
    """``estimator(...).fit`` on the training table; the model scores whole
    documents unless ``config`` caps them (``maxScoreBytes``)."""
    model = estimator(config, languages, device).fit(table({"lang": labels, "fulltext": texts}))
    return model.set_max_score_bytes(config.get("maxScoreBytes"))
