"""Exact byte grams n = 1..5 through the port's normal path, against the
benchmark's plain reference (``langbench/reference``), on the CPU.

The ``wili235-exact5`` form at a small size: 20 languages (more than
``MAX_PALLAS_LANGS`` = 16, so the hybrid route's lengths 1 and 2 take
``bigram_hist`` and a matmul), parity weights, seeded corpora from
``langbench/corpus.py``. ``LanguageDetector.fit`` takes the split device fit
(n <= 3 in a dense table, n = 4..5 on the host), whose profile must be the
reference's ids and float64 weights bit for bit; ``transform`` under
``auto`` takes ``hybrid`` and must give the reference's labels, with scores
in the reduction-order class (``atol=1e-4, rtol=1e-5``). One case trains on
documents shorter than 5 bytes, whose partial windows the split fit adds as
extras. The profile of 40 grams a language holds grams of lengths 1..3 only
(each language has more than 40 grams no other holds, and ties go to the
lowest id); the profile of 300 takes 4- and 5-grams too, so the bucket
table's packed keys of every length hit.

The ``cuda`` cases hold ``csrc/row_hist.cu`` against its plain version on
the card, bit for bit, at the profile's padded row count (94,208 rows: the
global-atomic path) and under the shared-memory limit (51,200 rows). This
module imports neither JAX nor the JAX package, so it runs on a machine
without them (``pytest --noconftest``).
"""

import numpy as np
import pytest
import torch

from langbench import corpus
from langbench.reference import fit as ref_fit
from langbench.reference import score as ref_score
from spark_languagedetector_tpu_torch import LanguageDetector, Table
from spark_languagedetector_tpu_torch.ops import score_hist
from spark_languagedetector_tpu_torch.telemetry import REGISTRY

LANGS = corpus.language_names(20)
INDEX = {l: i for i, l in enumerate(LANGS)}
SEED = 2**33 + 18
SHORT_TRAIN = ["a", "zz", "abc", "abcd", "xyzw", "qq"]  # shorter than 5 bytes


def _config(profile: int) -> dict:
    return {"languages": len(LANGS), "gramLengths": [1, 2, 3, 4, 5], "vocabMode": "exact",
            "languageProfileSize": profile, "weightMode": "parity",
            "training": {"docs_per_language": 4, "lengths": {"mean": 300, "sd": 120, "min": 140}}}


def _training(cfg: dict, short: bool):
    texts, labels = corpus.training_table(cfg, SEED)
    if short:
        texts = texts + SHORT_TRAIN
        labels = labels + [LANGS[i % len(LANGS)] for i in range(len(SHORT_TRAIN))]
    return texts, labels


def _fit(cfg: dict, texts, labels):
    det = (LanguageDetector(LANGS, cfg["gramLengths"], cfg["languageProfileSize"], device="cpu")
           .set_vocab_mode("exact").set_weight_mode("parity").set_fit_backend("device"))
    return det.fit(Table({"lang": labels, "fulltext": texts}))


def _reference_profile(cfg: dict, texts, labels):
    return ref_fit.fit(cfg, [t.encode() for t in texts], [INDEX[l] for l in labels], "cpu")


@pytest.fixture(scope="module")
def fitted():
    """``fitted(profile, short)``: (config, model, reference profile), each
    fitted once per module."""
    cache = {}

    def get(profile: int, short: bool):
        if (profile, short) not in cache:
            cfg = _config(profile)
            texts, labels = _training(cfg, short)
            cache[profile, short] = (cfg, _fit(cfg, texts, labels),
                                     _reference_profile(cfg, texts, labels))
        return cache[profile, short]

    return get


@pytest.mark.parametrize("profile,short", [(40, False), (40, True), (300, False)])
def test_split_device_fit_is_the_reference_profile(fitted, profile, short):
    _, model, (ids, w) = fitted(profile, short)
    got = model.profile
    np.testing.assert_array_equal(np.asarray(got.ids, np.int64), ids)
    np.testing.assert_array_equal(np.asarray(got.weights, np.float64), w)
    offsets = np.cumsum([256**n for n in range(1, 5)])  # the first id of lengths 2..5
    lengths = np.searchsorted(offsets, ids, side="right") + 1
    if profile == 300:  # every length, so the long part's packed keys hit
        assert set(lengths.tolist()) >= {3, 4, 5}


@pytest.mark.parametrize("profile,short", [(40, False), (40, True), (300, False)])
def test_hybrid_transform_gives_the_reference_labels(fitted, profile, short):
    cfg, model, (ids, w) = fitted(profile, short)
    mix = {"pool_docs": 96, "lengths": {"mean": 400, "sd": 200, "min": 140},
           "codeswitch": {"every": 4, "lo": 0.25, "hi": 0.75}}
    docs = corpus.traffic_pool(cfg, mix, SEED + 1) + ["", "a", "zz", "abc", "abcd"]
    labels = model.transform(Table({"fulltext": docs})).column("lang")
    runner = model.runner
    assert runner.strategy == "hybrid" and runner.long_route == "bucket"
    byte_docs = [d.encode() for d in docs]
    ref = ref_score.score(cfg, byte_docs, ids, w, "cpu")
    assert list(labels) == [LANGS[i] for i in ref_score.labels(ref)]
    np.testing.assert_allclose(runner.score(byte_docs), ref, atol=1e-4, rtol=1e-5)


def _rows_plane(rng, B: int, K: int, W: int, R: int, miss: int):
    """A row-histogram input: row ids of every kind (in range, the miss row,
    out of range) and per-document limits from 0 to W."""
    rows = rng.integers(0, R, size=(B, K * W))
    rows[:, ::7] = miss
    rows[:, 5::11] = R + 3
    rows[0, :] = rows[0, 0]  # one document hammering one row
    vmax = rng.integers(0, W + 1, size=B)
    vmax[:2] = W
    return (torch.as_tensor(rows, dtype=torch.int32), torch.as_tensor(vmax, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("rhi", [368, 200])  # 94,208 rows (global atomics); 51,200 (shared)
def test_row_hist_kernel_is_the_plain_version_on_the_card(rhi):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU form")
    R, W, K = rhi * 256, 1021, 3
    miss = R - 1
    rows, vmax = _rows_plane(np.random.default_rng(rhi), 48, K, W, R, miss)
    want = score_hist.row_hist_plain(rows, vmax, W, rhi, miss)
    dev = torch.device("cuda", 0)
    before = REGISTRY.snapshot()["counters"].get("score/hist/global_atomic", 0)
    got = score_hist.row_hist(rows.to(dev), vmax.to(dev), W, rhi, miss)
    torch.cuda.synchronize()
    after = REGISTRY.snapshot()["counters"].get("score/hist/global_atomic", 0)
    assert torch.equal(got.cpu(), want)
    assert after - before == (1 if R > score_hist.SHARED_MEMORY_ROWS else 0)
