"""The port's runner strategies on the CPU (their kernels' plain versions).

* ``auto`` picks fused → pallas → hybrid → hist → gather, as the JAX runner
  does on an accelerator, whatever the device.
* Every strategy that covers a profile form gives the JAX gather runner's
  labels and, within the reduction-order class (``atol=1e-4, rtol=1e-5``),
  its scores.
* Strategies that do not cover a form, and quantization off the fused
  strategy, are refused.
"""

import numpy as np
import pytest

from spark_languagedetector_tpu.api.runner import BatchRunner as JaxRunner
from spark_languagedetector_tpu.ops.vocab import VocabSpec as JaxVocabSpec
from spark_languagedetector_tpu_torch.api import runner as runner_mod
from spark_languagedetector_tpu_torch.api.runner import BatchRunner
from spark_languagedetector_tpu_torch.models.profile import GramProfile
from spark_languagedetector_tpu_torch.ops.encoding import pad_batch
from spark_languagedetector_tpu_torch.ops.vocab import VocabSpec, window_ids_numpy

ATOL, RTOL = 1e-4, 1e-5


def _docs(seed=0):
    rng = np.random.default_rng(seed)
    docs = [bytes(rng.integers(97, 106, int(rng.integers(0, 80))).tolist()) for _ in range(20)]
    return docs + [b"", b"a", b"ab", b"abc", b"\x00\xff\x00\xff\x00", b"abcdefgh" * 40]


def _profile(mode, glens, bits=20, seed=1, langs="abcd"):
    """A profile that learns half of the docs' grams plus random ids (more
    than four languages take a hashed profile to the LUT form)."""
    rng = np.random.default_rng(seed)
    spec = VocabSpec(mode, glens, bits)
    batch, _ = pad_batch(_docs(), 512)
    seen = np.unique(np.concatenate([window_ids_numpy(batch, n, spec).ravel() for n in glens]))
    ids = np.unique(np.concatenate([
        rng.choice(seen, len(seen) // 2, replace=False),
        rng.choice(spec.id_space_size, 100, replace=False),
    ]))
    w = rng.normal(size=(len(ids), len(langs)))
    return GramProfile(spec=spec, languages=tuple(langs), ids=ids, weights=w)


def _runner(profile, strategy="auto", **kw):
    w, lut, cuckoo = profile.device_membership(device="cpu")
    return BatchRunner(
        weights=w, lut=lut, cuckoo=cuckoo, spec=profile.spec, device="cpu",
        strategy=strategy, length_buckets=(128, 256), **kw,
    )


def _jax_reference(profile, docs):
    from spark_languagedetector_tpu.models.profile import GramProfile as JaxProfile

    jp = JaxProfile(
        spec=JaxVocabSpec(profile.spec.mode, profile.spec.gram_lengths, profile.spec.hash_bits),
        languages=profile.languages, ids=profile.ids, weights=profile.weights,
    )
    w, lut, cuckoo = jp.device_membership()
    jr = JaxRunner(weights=w, lut=lut, cuckoo=cuckoo, spec=jp.spec, strategy="gather",
                   length_buckets=(128, 256))
    return jr.score(docs), jr.predict_ids(docs)


AUTO = [
    (("exact", (1, 2, 3)), "fused"),
    (("hashed", (1, 2, 3, 4, 5), 17), "fused"),
    (("exact", (1, 2, 3, 4, 5)), "hybrid"),
    (("exact", (2, 4)), "hybrid"),
    (("exact", (3, 4, 5)), "hist"),
    (("exact", (4,)), "hist"),
]


@pytest.mark.parametrize("args,expected", AUTO)
def test_auto_strategy_and_scores(args, expected):
    profile = _profile(*args)
    runner = _runner(profile)
    assert runner.strategy == expected, runner.strategy_reason
    docs = _docs(1) + [b"abcdefgh" * 100]  # one document chunked
    ref_scores, ref_ids = _jax_reference(profile, docs)
    np.testing.assert_allclose(runner.score(docs), ref_scores, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(runner.predict_ids(docs), ref_ids)
    assert runner.table_bytes() > 0
    heavy = any(n >= 4 for n in profile.spec.gram_lengths)
    if expected in ("hybrid", "hist"):
        assert runner.batch_size == (1024 if heavy else 4096)


@pytest.mark.parametrize(
    "args,strategies",
    [
        (("hashed", (1, 2, 3, 4, 5), 17, 1, "abcdefgh"), ["hybrid", "hist", "gather"]),
        (("exact", (1, 2, 3)), ["hybrid", "hist", "gather"]),
        (("exact", (1, 2)), ["pallas", "gather"]),
        (("exact", (1, 2, 3, 4, 5)), ["hist", "gather"]),
    ],
)
def test_explicit_strategies_match_jax(args, strategies):
    profile = _profile(*args)
    docs = _docs(2)
    ref_scores, ref_ids = _jax_reference(profile, docs)
    _, lut, _ = profile.device_membership(device="cpu")
    assert (lut is not None) == (len(args) > 2 or args[1] == (1, 2, 3))  # the LUT forms
    for strategy in strategies:
        runner = _runner(profile, strategy)
        assert runner.strategy == strategy and runner.strategy_reason == "explicit"
        np.testing.assert_allclose(runner.score(docs), ref_scores, atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(runner.predict_ids(docs), ref_ids)


def test_hybrid_gathers_long_grams_without_a_bucket_table(monkeypatch):
    """No zero-overflow bucket seed: hybrid scores n >= 3 through the cuckoo
    gather, and auto on a long-gram-only profile falls back to gather."""
    monkeypatch.setattr(runner_mod.bucket_ops, "build_buckets_exact", lambda *a, **k: None)
    profile = _profile("exact", (1, 2, 3, 4, 5))
    runner = _runner(profile)
    assert runner.strategy == "hybrid" and runner.hist_state is None
    docs = _docs(3)
    ref_scores, ref_ids = _jax_reference(profile, docs)
    np.testing.assert_allclose(runner.score(docs), ref_scores, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(runner.predict_ids(docs), ref_ids)
    assert _runner(_profile("exact", (3, 4, 5))).strategy == "gather"
    with pytest.raises(ValueError, match="strategy='hist' needs"):
        _runner(profile, "hist")


def test_strategies_that_do_not_cover_a_form_are_refused():
    cuckoo = _profile("exact", (1, 2, 3, 4, 5))
    with pytest.raises(ValueError, match="strategy='fused' needs"):
        _runner(cuckoo, "fused")
    with pytest.raises(ValueError, match="strategy='pallas' needs"):
        _runner(cuckoo, "pallas")
    with pytest.raises(ValueError, match="quantization needs the fused strategy"):
        _runner(cuckoo, quantization="int8")
    with pytest.raises(ValueError, match="quantization applies to the fused strategy only"):
        _runner(cuckoo, "hybrid", quantization="int8")
    with pytest.raises(ValueError, match="strategy='hybrid' needs"):
        _runner(_profile("exact", (1, 2)), "hybrid")
    with pytest.raises(ValueError, match="unknown strategy"):
        _runner(cuckoo, "onehot")
