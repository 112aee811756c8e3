"""The device fit's ingest in its three forms, and its knobs, against the JAX
package's fit pipeline and the host fit.

* ``iter_device_batches`` ships padded, ragged (where the chunk-aligned
  flat buffer is smaller) and wire batches; every one rebuilds
  ``pad_batch``'s batch on the device, in plan order, with the same
  ``fit/*`` counters as the JAX pipeline;
* fits through the ragged and the wire ingest give profiles bit-identical
  to the host fit;
* ``LANGDETECT_FIT_BATCH_ROWS``, ``LANGDETECT_FIT_BATCH_BYTES``,
  ``LANGDETECT_DEDUP`` and ``LANGDETECT_LENGTH_BUCKETS`` are read through
  ``exec.config``, with the JAX package's results.
"""

import numpy as np
import pytest
import torch

from spark_languagedetector_tpu.ops import fit_pipeline as jfp
from spark_languagedetector_tpu.ops.vocab import VocabSpec as JaxVocabSpec
from spark_languagedetector_tpu.telemetry import REGISTRY as JREGISTRY
from spark_languagedetector_tpu_torch.ops import fit_pipeline as fp
from spark_languagedetector_tpu_torch.ops import fit_tpu as ft
from spark_languagedetector_tpu_torch.ops.encoding import pad_batch
from spark_languagedetector_tpu_torch.ops.fit import PARITY, fit_profile_numpy
from spark_languagedetector_tpu_torch.ops.vocab import HASHED, VocabSpec
from spark_languagedetector_tpu_torch.telemetry import REGISTRY

SPEC = (HASHED, (1, 2, 3, 4, 5), 12)


def _corpus(seed=0, n=150):
    """Short documents that land in wide buckets (so the ragged form wins),
    oversized ones (chunk-split) and duplicated (document, language) pairs."""
    rng = np.random.default_rng(seed)
    docs = [bytes(rng.integers(97, 104, int(rng.integers(0, 700))).tolist()) for _ in range(n)]
    docs += [b"", b"a", b"xyz" * 3000, bytes(rng.integers(97, 99, 8199).tolist())]
    langs = [i % 3 for i in range(len(docs))]
    return docs + docs[:7], np.asarray(langs + langs[:7])


def _drain(items, item_langs, plan, mult, **kw):
    return list(fp.iter_device_batches(items, item_langs, plan, item_mult=mult,
                                       device=torch.device("cpu"), **kw))


@pytest.mark.parametrize("device_encode", [False, True], ids=["padded_ragged", "wire"])
def test_every_form_rebuilds_pad_batch_in_plan_order(device_encode, monkeypatch):
    forms = []
    for name in ("unpack_ragged", "encode_batch"):
        real = getattr(fp, name)
        monkeypatch.setattr(fp, name, lambda *a, _r=real, _n=name: forms.append(_n) or _r(*a))
    docs, langs = _corpus()
    spec = VocabSpec(*SPEC)
    items, item_langs, plan, _, mult = fp.plan_fit_batches(docs, langs, spec, batch_rows=64)
    REGISTRY.reset()
    monkeypatch.setenv("LANGDETECT_DEVICE_ENCODE", "1" if device_encode else "0")
    got = _drain(items, item_langs, plan, mult)
    assert len(got) == len(plan)
    for (batch, lengths, blangs, bmult, rows, pad_to), (sel, want_pad) in zip(got, plan):
        want_b, want_l = pad_batch([items[i] for i in sel], want_pad)
        assert (rows, pad_to) == (len(sel), want_pad)
        np.testing.assert_array_equal(batch.numpy(), want_b)
        np.testing.assert_array_equal(lengths.numpy(), want_l)
        np.testing.assert_array_equal(blangs.numpy(), item_langs[sel])
        np.testing.assert_array_equal(bmult.numpy(), mult[sel])
    counters = REGISTRY.snapshot()["counters"]
    if device_encode:
        assert forms.count("encode_batch") == len(plan) == counters["fit/encoded_batches"]
    else:
        assert 0 < forms.count("unpack_ragged") == counters["fit/ragged_batches"] < len(plan)
    # The JAX pipeline ships the same forms and the same bytes.
    import jax  # noqa: F401  (the JAX pipeline puts on the CPU backend)

    jitems, jlangs, jplan, _, jmult = jfp.plan_fit_batches(docs, langs, JaxVocabSpec(*SPEC),
                                                           batch_rows=64)
    JREGISTRY.reset()
    for jb, mine in zip(jfp.iter_device_batches(jitems, jlangs, jplan, item_mult=jmult,
                                                 device_encode=device_encode), got):
        np.testing.assert_array_equal(np.asarray(jb[0]), mine[0].numpy())
    keys = ("fit/real_bytes", "fit/capacity_bytes", "fit/wire_bytes", "fit/ragged_batches",
            "fit/encoded_batches")
    jc = JREGISTRY.snapshot()["counters"]
    assert {k: counters.get(k) for k in keys} == {k: jc.get(k) for k in keys}


def test_without_duplicates_mult_rides_none():
    docs = [b"abc", b"de", b"fgh" * 100]
    spec = VocabSpec(*SPEC)
    items, item_langs, plan, _, mult = fp.plan_fit_batches(docs, np.array([0, 1, 2]), spec)
    assert mult is None
    (batch, lengths, blangs, bmult, rows, pad_to), = _drain(items, item_langs, plan, None)
    assert bmult is None and rows == 3


@pytest.mark.parametrize("env", [{}, {"LANGDETECT_DEVICE_ENCODE": "1"},
                                 {"LANGDETECT_FIT_BATCH_ROWS": "16"},
                                 {"LANGDETECT_FIT_BATCH_BYTES": "65536", "LANGDETECT_DEDUP": "0"}],
                         ids=["ragged", "wire", "rows", "bytes_nodedup"])
def test_device_fit_through_each_ingest_equals_the_host_fit(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    docs, langs = _corpus(1)
    spec = VocabSpec(*SPEC)
    host = fit_profile_numpy(docs, langs, 3, spec, 40, PARITY)
    got = ft.fit_profile_device(docs, langs, 3, spec, 40, PARITY, device="cpu")
    np.testing.assert_array_equal(got[0], host[0])
    np.testing.assert_array_equal(got[1], host[1])


def test_fit_knobs_resolve_through_exec_config_as_in_jax(monkeypatch):
    assert fp.resolve_fit_batching() == jfp.resolve_fit_batching() == (None, 8 << 20)
    assert fp.resolve_fit_batching(7) == jfp.resolve_fit_batching(7)
    monkeypatch.setenv("LANGDETECT_FIT_BATCH_ROWS", "32")
    monkeypatch.setenv("LANGDETECT_FIT_BATCH_BYTES", "1048576")
    assert fp.resolve_fit_batching() == jfp.resolve_fit_batching() == (32, 1 << 20)
    assert fp.resolve_fit_batching(5) == (5, 1 << 20)
    with pytest.raises(ValueError):
        fp.resolve_fit_batching(0)
    monkeypatch.setenv("LANGDETECT_FIT_BATCH_ROWS", "lots")
    with pytest.raises(ValueError):
        fp.resolve_fit_batching()
    monkeypatch.delenv("LANGDETECT_FIT_BATCH_ROWS")
    monkeypatch.setenv("LANGDETECT_DEDUP", "off")
    monkeypatch.setenv("LANGDETECT_LENGTH_BUCKETS", "128,512,1024")
    docs, langs = _corpus(2)
    spec, jspec = VocabSpec(*SPEC), JaxVocabSpec(*SPEC)
    ref = jfp.plan_fit_batches(docs, langs, jspec, byte_budget=1 << 16)
    monkeypatch.setenv("LANGDETECT_FIT_BATCH_BYTES", str(1 << 16))
    got = fp.plan_fit_batches(docs, langs, spec)
    assert got[4] is None and ref[4] is None  # dedup off: no multiplicities
    assert got[0] == ref[0] and max(len(d) for d in got[0]) <= 1024
    assert [(s.tolist(), p) for s, p in got[2]] == [(s.tolist(), p) for s, p in ref[2]]
    for rows_budget in (1 << 16, 8 << 20):
        for pad_to in (128, 512, 1024):
            assert fp.rows_for_fit_bucket(pad_to, rows_budget) == jfp.rows_for_fit_bucket(
                pad_to, rows_budget)
