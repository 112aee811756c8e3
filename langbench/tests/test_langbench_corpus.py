"""The generator: deterministic per seed, the same work for every seed."""

import numpy as np
import pytest

from langbench import corpus

CFG = {"languages": 12, "training": {"docs_per_language": 4, "lengths": {"mean": 300, "sd": 75, "min": 30}}}
MIX = {"pool_docs": 256, "lengths": {"mean": 200, "sd": 50, "min": 30},
       "long": {"every": 16, "mean": 3000, "sd": 500, "min": 30}}
MIX_CS = dict(MIX, codeswitch={"every": 8, "lo": 0.25, "hi": 0.75})


def test_same_seed_same_documents():
    assert corpus.traffic_pool(CFG, MIX, 2**33 + 1) == corpus.traffic_pool(CFG, MIX, 2**33 + 1)
    assert corpus.training_table(CFG, 5) == corpus.training_table(CFG, 5)
    assert corpus.training_table(CFG, -3) == corpus.training_table(CFG, 2**64 - 3)


@pytest.mark.parametrize("mix", [MIX, MIX_CS], ids=["one-language", "codeswitch"])
def test_seeds_differ_in_content_not_in_sizes(mix):
    a, b = (corpus.traffic_pool(CFG, mix, s) for s in (1, 2))
    assert a != b
    la, lb = (np.sort([len(d.encode()) for d in p]) for p in (a, b))
    # Cut at a character boundary: at most three bytes short of the size asked.
    assert np.abs(la - lb).max() <= 3
    assert len(set(a)) == len(a)


def test_long_documents_every_nth_and_languages_balanced():
    pool = corpus.traffic_pool(CFG, MIX, 9)
    lens = np.array([len(d.encode()) for d in pool])
    assert lens[15::16].min() > 1500 > np.delete(lens, np.s_[15::16]).max()
    texts, labels = corpus.training_table(CFG, 9)
    assert len(texts) == 48 and set(np.unique(labels, return_counts=True)[1]) == {4}


def test_length_quantiles_fixed():
    q = corpus.length_quantiles({"mean": 100, "sd": 30, "min": 50}, 1000)
    assert q.min() == 50 and abs(np.median(q) - 100) <= 1 and np.all(np.diff(q) >= 0)


def test_codeswitch_documents_join_two_languages_at_fixed_shares():
    langs = corpus.language_names(CFG["languages"])
    lists = [set(corpus.word_list(l)) for l in langs]
    # Words of one language alone.
    own = [ws - set().union(*(o for o in lists if o is not ws)) for ws in lists]
    mix = {"pool_docs": 64, "lengths": {"mean": 2000, "sd": 100, "min": 30},
           "codeswitch": {"every": 8, "lo": 0.25, "hi": 0.75}}
    for i, doc in enumerate(corpus.traffic_pool(CFG, mix, 2**33 + 3)):
        toks = set(doc.split(" "))
        found = sum(bool(toks & ws) for ws in own)
        assert found == (2 if i % 8 == 3 else 1), (i, found)
    assert np.allclose(corpus.split_shares({"lo": 0.25, "hi": 0.75}, 4),
                       [0.3125, 0.4375, 0.5625, 0.6875])
