"""The batch wire format (``exec/pack.py``) that the transform runner and
the device fit share.

Every form the packer ships — padded, ragged, and the wire form from
``bytes`` and from a byte plane's spans (the runner's ``DocBlock`` lane) —
with no extra column, the runner's ``limit``, or the fit's ``langs`` and
``mult``, packed into a staged buffer, copied and rebuilt on the device,
equals ``ops.encoding.pad_batch``'s batch and lengths, and its columns come
back unchanged. The ``cuda`` case runs the whole grid through pinned memory
on the card. This module imports neither JAX nor the JAX package, so it
runs on a machine without them (``pytest --noconftest``).
"""

import numpy as np
import pytest
import torch

from spark_languagedetector_tpu_torch.exec.pack import PADDED, RAGGED, WIRE, Batch, Spans
from spark_languagedetector_tpu_torch.exec.staging import HostStaging
from spark_languagedetector_tpu_torch.ops.encode_device import DocBlock
from spark_languagedetector_tpu_torch.ops.encoding import pad_batch

PAD_TO = 2048
# name: (Batch keywords, the form the batch must take, spans input)
FORMS = {
    "padded": ({}, PADDED, False),
    "ragged": ({"ragged": True}, RAGGED, False),
    "wire": ({"wire": True}, WIRE, False),
    "wire_spans": ({"wire": True}, WIRE, True),
}
COLUMNS = {"none": (), "limit": ("limit",), "langs_mult": ("langs", "mult")}


def _docs(rng, rows=64):
    """Short documents in a wide bucket (so the ragged form is the smaller
    one), an empty one and one that fills the bucket."""
    docs = [rng.integers(0, 256, int(rng.integers(0, 400)), dtype=np.uint8).tobytes()
            for _ in range(rows - 2)]
    return docs + [b"", rng.integers(0, 256, PAD_TO, dtype=np.uint8).tobytes()]


def _round_trip(device, form, cols, seed=0):
    kw, want_form, spans = FORMS[form]
    rng = np.random.default_rng(seed)
    docs = _docs(rng)
    values = {name: rng.integers(-(2**31), 2**31, len(docs)).astype(np.int32)
              for name in COLUMNS[cols]}
    if spans:
        block = DocBlock.from_bytes(docs)
        docs_in = Spans(block.flat, block.starts(), block.lengths())
    else:
        docs_in = docs
    b = Batch(docs_in, PAD_TO, {name: (v, 0) for name, v in values.items()}, **kw)
    assert b.form == want_form and b.rows == len(docs)
    assert b.real_bytes == sum(map(len, docs))
    st = HostStaging(device).take(b.fields)
    with st:
        b.fill(st.views)
    assert b.nbytes == sum(a.nbytes for a in st.views.values())
    assert b.nbytes == b.capacity + b.index_bytes + 4 * len(docs) * len(values)
    dev = st.to_device()
    batch, lengths = b.rebuild(dev)
    assert batch.device.type == device.type and batch.dtype == torch.uint8
    want_batch, want_lengths = pad_batch(docs, PAD_TO)
    np.testing.assert_array_equal(batch.cpu().numpy(), want_batch)
    np.testing.assert_array_equal(lengths.cpu().numpy(), want_lengths)
    assert set(dev) == {name for name, _, _ in b.fields}
    for name, v in values.items():
        np.testing.assert_array_equal(dev[name].cpu().numpy(), v)


@pytest.mark.parametrize("cols", COLUMNS)
@pytest.mark.parametrize("form", FORMS)
def test_every_form_rebuilds_pad_batch_with_its_columns(form, cols):
    _round_trip(torch.device("cpu"), form, cols)


@pytest.mark.cuda
def test_every_form_round_trips_through_pinned_memory_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the staged buffer is pinned and copied to it")
    for seed, form in enumerate(FORMS):
        for cols in COLUMNS:
            _round_trip(torch.device("cuda"), form, cols, seed)
    torch.cuda.synchronize()
