"""The plain reference against the JAX package on the CPU, at a tiny size:
the same profile bit for bit, and the same labels."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from langbench import corpus  # noqa: E402
from langbench.reference import fit as ref_fit  # noqa: E402
from langbench.reference import score as ref_score  # noqa: E402

CONFIGS = {
    "hashed-exact12": {"vocabMode": "hashed", "hashBits": 18, "hashScheme": "exact12",
                       "gramLengths": [1, 2, 3, 4, 5], "languageProfileSize": 60},
    "exact-n5": {"vocabMode": "exact", "gramLengths": [1, 2, 3, 4, 5], "languageProfileSize": 80},
    "hashed-fnv-deficient": {"vocabMode": "hashed", "hashBits": 12, "hashScheme": "fnv1a",
                             "gramLengths": [2, 3], "languageProfileSize": 5000},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_matches_jax_package(name):
    from spark_languagedetector_tpu import LanguageDetector, Table

    cfg = dict(CONFIGS[name], languages=7, weightMode="parity",
               training={"docs_per_language": 4, "lengths": {"mean": 150, "sd": 100, "min": 1}})
    langs = corpus.language_names(7)
    texts, labels = corpus.training_table(cfg, 2**33 + 3)
    det = (LanguageDetector(langs, cfg["gramLengths"], cfg["languageProfileSize"])
           .set_vocab_mode(cfg["vocabMode"]))
    if cfg["vocabMode"] == "hashed":
        det = det.set_hash_bits(cfg["hashBits"]).set_hash_scheme(cfg["hashScheme"])
    model = det.fit(Table({"lang": labels, "fulltext": texts}))
    index = {l: i for i, l in enumerate(langs)}
    ids, w = ref_fit.fit(cfg, [t.encode() for t in texts], [index[l] for l in labels], "cpu")
    assert np.array_equal(ids, np.asarray(model.profile.ids))
    assert np.array_equal(w, np.asarray(model.profile.weights))

    docs = corpus.traffic_pool(cfg, {"pool_docs": 40, "lengths": {"mean": 120, "sd": 90, "min": 0}}, 5)
    docs += ["", "a", "zz"]
    got = model.transform(Table({"fulltext": docs})).column("lang")
    scores = ref_score.score(cfg, [d.encode() for d in docs], ids, w, "cpu")
    assert [langs[i] for i in ref_score.labels(scores)] == list(got)
