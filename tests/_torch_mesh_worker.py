"""A pool of gloo ranks for the port's mesh tests, and the cases they run.

:class:`RankPool` spawns ``world`` processes (``torch.multiprocessing``,
``spawn``), each of which joins one gloo process group on the CPU through
the port's ``parallel.distributed.initialize`` with a ``file://`` rendezvous
under the test's temporary directory (never a TCP port: parallel test
workers would collide on it), and then runs cases until told to stop. A
case is a function of this module, called on every rank with the same
arguments; :meth:`RankPool.run` returns each rank's result in rank order.
Each call has its own timeout: a rank that hangs fails that call, and the
pool is torn down and started again for the next one.

This module imports torch, numpy and the port, never ``jax`` or the JAX
package: the JAX references run in the test process.
"""

from __future__ import annotations

import os
import sys
import traceback
from pathlib import Path

import numpy as np

CASE_TIMEOUT_S = 120.0
START_TIMEOUT_S = 120.0


class RankPoolError(RuntimeError):
    """A case raised on a rank, or a rank did not answer in time."""


def _serve(rank: int, world: int, init_file: str, conn, path: list) -> None:
    """One rank: join the group, then run cases until ``None`` arrives."""
    sys.path[:0] = [p for p in path if p not in sys.path]
    import torch

    torch.set_num_threads(1)
    from spark_languagedetector_tpu_torch.parallel import distributed

    try:
        distributed.initialize(f"file://{init_file}", world, rank, backend="gloo", device="cpu")
        conn.send(("ready", rank))
    except BaseException:
        conn.send(("err", traceback.format_exc()))
        return
    cases = sys.modules[__name__]
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            break
        if msg is None:
            break
        name, args, kwargs = msg
        try:
            conn.send(("ok", getattr(cases, name)(*args, **kwargs)))
        except BaseException:
            conn.send(("err", traceback.format_exc()))
    distributed.shutdown()


class RankPool:
    """``world`` gloo ranks on the CPU; see the module docstring."""

    def __init__(self, world: int, tmpdir):
        import torch.multiprocessing as mp

        self.world = world
        self._tmpdir = Path(tmpdir)
        self._generation = 0
        self._ctx = mp.get_context("spawn")
        self._procs: list = []
        self._conns: list = []
        self._start()

    def _start(self) -> None:
        self._generation += 1
        init_file = self._tmpdir / f"gloo_init_{os.getpid()}_{self._generation}"
        for rank in range(self.world):
            parent, child = self._ctx.Pipe()
            p = self._ctx.Process(
                target=_serve, args=(rank, self.world, str(init_file), child, list(sys.path)),
                daemon=True,
            )
            p.start()
            child.close()
            self._procs.append(p)
            self._conns.append(parent)
        self._collect(START_TIMEOUT_S, "start")

    def _collect(self, timeout: float, what: str) -> list:
        out, errors = [], []
        for rank, conn in enumerate(self._conns):
            if not conn.poll(timeout):
                self._kill()
                raise RankPoolError(f"rank {rank} did not answer {what} in {timeout:.0f}s")
            try:
                kind, value = conn.recv()
            except EOFError:
                self._kill()
                raise RankPoolError(f"rank {rank} died during {what}")
            if kind == "err":
                errors.append(f"rank {rank}:\n{value}")
            out.append(value)
        if errors:
            raise RankPoolError(f"{what} failed\n" + "\n".join(errors))
        return out

    def run(self, name: str, *args, timeout: float = CASE_TIMEOUT_S, **kwargs) -> list:
        """Call case ``name`` on every rank; each rank's result, in rank
        order. A pool left broken by an earlier call starts again first."""
        if not self._procs:
            self._start()
        for conn in self._conns:
            conn.send((name, args, kwargs))
        return self._collect(timeout, name)

    def _kill(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(timeout=10)
        self._procs, self._conns = [], []

    def close(self) -> None:
        for conn in self._conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=20)
        self._kill()


# ------------------------------------------------------------------ cases ---
# Every case runs on every rank of the pool's group, in the same order.


def _P():
    import spark_languagedetector_tpu_torch as P

    return P


def mesh_info(data=None, vocab=1):
    from spark_languagedetector_tpu_torch.parallel.mesh import build_mesh

    m = build_mesh(data=data, vocab=vocab)
    return {"shape": dict(m.shape), "coords": m.coords, "backend": m.backend,
            "ranks": m.ranks, "device": str(m.device)}


def mesh_request_raises(data, vocab=1):
    from spark_languagedetector_tpu_torch.parallel.mesh import build_mesh

    try:
        build_mesh(data=data, vocab=vocab)
    except ValueError as e:
        return str(e)
    return None


def collectives(data, vocab):
    """psum, all_gather, reduce_scatter and one ring hop on both axes."""
    import torch

    from spark_languagedetector_tpu_torch.parallel.mesh import build_mesh

    m = build_mesh(data=data, vocab=vocab)
    out = {}
    for ax in ("data", "vocab"):
        n = m.shape[ax]
        c = m.coord(ax)
        t = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * m.rank
        out[f"psum_{ax}"] = m.psum(t, ax).numpy()
        out[f"gather_{ax}"] = m.all_gather(t, ax).numpy()
        big = torch.arange(2 * n * 3, dtype=torch.int32).reshape(2 * n, 3) + m.rank
        out[f"rs_{ax}"] = m.reduce_scatter(big, ax).numpy()
        out[f"ring_{ax}"] = m.ring_shift(torch.tensor([float(c)]), ax).numpy()
    return out


def host_shard(n_items):
    from spark_languagedetector_tpu_torch.parallel.distributed import host_shard as hs

    s = hs(n_items)
    return (s.start, s.stop)


def global_batch(rows):
    from spark_languagedetector_tpu_torch.parallel.distributed import global_batch as gb
    from spark_languagedetector_tpu_torch.parallel.mesh import build_mesh

    m = build_mesh()
    local = np.arange(rows * 3, dtype=np.int32).reshape(rows, 3) + 100 * m.rank
    return gb(local, m).numpy()


def _membership(weights, lut):
    """Weights and LUT as given, or built here from ``weights`` =
    ``{"gram_map", "languages", "gram_lengths"}`` (a profile whose id space
    is too large to send to every rank): the LUT form."""
    if not isinstance(weights, dict):
        return weights, lut
    from spark_languagedetector_tpu_torch.models.profile import GramProfile

    profile = GramProfile.from_gram_map(weights["gram_map"], weights["languages"],
                                        weights["gram_lengths"])
    w, lut = profile.device_arrays(device="cpu", dense_budget_bytes=0)
    return w, lut


def sharded_score(data, vocab, spec_args, batch, lengths, weights, lut, shard_vocab):
    from spark_languagedetector_tpu_torch.ops.vocab import VocabSpec
    from spark_languagedetector_tpu_torch.parallel.mesh import build_mesh
    from spark_languagedetector_tpu_torch.parallel.sharded import make_sharded_scorer

    m = build_mesh(data=data, vocab=vocab)
    weights, lut = _membership(weights, lut)
    scorer = make_sharded_scorer(m, VocabSpec(*spec_args[:2], **spec_args[2]),
                                 shard_vocab=shard_vocab)
    return scorer(batch, lengths, weights, lut).numpy()


def sharded_fit_step(data, vocab, spec_args, num_langs, batch, lengths, langs, mult=None):
    """This rank's own table after one step, and the tables summed."""
    import torch

    from spark_languagedetector_tpu_torch.ops.vocab import VocabSpec
    from spark_languagedetector_tpu_torch.parallel.mesh import build_mesh
    from spark_languagedetector_tpu_torch.parallel.sharded import (
        make_sharded_fit_step,
        reduce_counts,
    )

    m = build_mesh(data=data, vocab=vocab)
    spec = VocabSpec(*spec_args[:2], **spec_args[2])
    acc = torch.zeros((spec.id_space_size, num_langs), dtype=torch.int32)
    step = make_sharded_fit_step(m, spec, num_langs)
    local = step(batch, lengths, langs, acc, mult)
    total = reduce_counts(m, local, table_sharded=False)
    return local.numpy().copy(), total.numpy()


def training_step(data, vocab, spec_args, num_langs, k, batch, lengths, langs):
    import torch

    from spark_languagedetector_tpu_torch.ops.vocab import VocabSpec
    from spark_languagedetector_tpu_torch.parallel.mesh import build_mesh
    from spark_languagedetector_tpu_torch.parallel.sharded import training_step as ts

    m = build_mesh(data=data, vocab=vocab)
    spec = VocabSpec(*spec_args[:2], **spec_args[2])
    acc = torch.zeros((spec.id_space_size, num_langs), dtype=torch.int32)
    _, weights, top = ts(m, spec, num_langs, k)(batch, lengths, langs, acc)
    return weights.numpy(), top.numpy()


def finalize_topk(data, vocab, counts, k, weight_mode="parity", block=None):
    """The sharded top-k over this rank's stripe of ``counts`` (every rank
    holds the whole table; the stripe is cut here), and the single-device
    top-k of the whole table."""
    import torch

    from spark_languagedetector_tpu_torch.ops import fit_tpu
    from spark_languagedetector_tpu_torch.parallel.mesh import build_mesh, table_shards
    from spark_languagedetector_tpu_torch.parallel.sharded import (
        make_sharded_finalize_topk,
        stripe_offset,
    )

    m = build_mesh(data=data, vocab=vocab)
    t = torch.from_numpy(counts)
    rows = t.shape[0] // table_shards(m)
    off = stripe_offset(m, rows)
    kw = {} if block is None else {"block": block}
    fn = make_sharded_finalize_topk(m, profile_size=k, weight_mode=weight_mode, **kw)
    sharded = fn(t[off : off + rows].clone())
    single = fit_tpu.top_k_rows(fit_tpu.masked_candidate_weights(t, weight_mode=weight_mode), k=k)
    return sharded.numpy(), single.numpy(), fn is make_sharded_finalize_topk(
        m, profile_size=k, weight_mode=weight_mode, **kw)


def finalize_local_counts(data, vocab, counts_by_rank, num_langs, k, weight_mode="parity"):
    """``finalize_counts`` over the mesh, each rank holding its own table
    (``counts_by_rank[rank]``); also whether the table striped."""
    import torch

    from spark_languagedetector_tpu_torch.ops.fit_tpu import finalize_counts
    from spark_languagedetector_tpu_torch.parallel.mesh import build_mesh
    from spark_languagedetector_tpu_torch.parallel.sharded import table_is_sharded

    m = build_mesh(data=data, vocab=vocab)
    local = torch.from_numpy(counts_by_rank[m.rank].copy())
    before = local.clone()
    ids, w = finalize_counts(local, num_langs=num_langs, profile_size=k,
                             weight_mode=weight_mode, mesh=m)
    return ids, w, table_is_sharded(m, local.shape[0]), bool(torch.equal(local, before))


def device_fit(data, vocab, docs, langs, num_langs, spec_args, k, weight_mode="parity",
               batch_rows=None, env=None):
    from spark_languagedetector_tpu_torch.ops.fit_tpu import (
        fit_profile_device,
        fit_profile_device_split,
    )
    from spark_languagedetector_tpu_torch.ops.vocab import VocabSpec
    from spark_languagedetector_tpu_torch.parallel.mesh import build_mesh

    m = build_mesh(data=data, vocab=vocab)
    spec = VocabSpec(*spec_args[:2], **spec_args[2])
    split = spec.mode == "exact" and max(spec.gram_lengths) > 3
    fit = fit_profile_device_split if split else fit_profile_device
    old = {key: os.environ.get(key) for key in (env or {})}
    os.environ.update(env or {})
    try:
        return fit(docs, langs, num_langs, spec, k, weight_mode, batch_rows=batch_rows, mesh=m)
    finally:
        for key, v in old.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v


def fit_batches(data, docs, langs, spec_args):
    """Each planned batch of the fit pipeline as this rank packs it on the
    mesh: (batch, lengths, langs, mult or None) numpy arrays."""
    import torch

    from spark_languagedetector_tpu_torch.ops.fit_pipeline import (
        iter_device_batches,
        plan_fit_batches,
    )
    from spark_languagedetector_tpu_torch.ops.vocab import VocabSpec
    from spark_languagedetector_tpu_torch.parallel.mesh import build_mesh

    from spark_languagedetector_tpu_torch.telemetry import REGISTRY

    m = build_mesh(data=data)
    spec = VocabSpec(*spec_args[:2], **spec_args[2])
    os.environ["LANGDETECT_DEVICE_ENCODE"] = "1"  # the mesh turns it off
    encoded = REGISTRY.counters.get("fit/encoded_batches", 0)
    try:
        items, item_langs, plan, _, item_mult = plan_fit_batches(docs, langs, spec)
        out = []
        for b, ln, lg, mu, _, _ in iter_device_batches(
            items, item_langs, plan, item_mult=item_mult, device=torch.device("cpu"), mesh=m
        ):
            out.append((b.numpy().copy(), ln.numpy().copy(), lg.numpy().copy(),
                        None if mu is None else mu.numpy().copy()))
        return out, REGISTRY.counters.get("fit/encoded_batches", 0) - encoded
    finally:
        os.environ.pop("LANGDETECT_DEVICE_ENCODE", None)


def long_document(data, vocab, spec_args, doc, weights, lut, chunk_size):
    """score_long_document and ring_score_chunks over the data axis."""
    from spark_languagedetector_tpu_torch.ops.vocab import VocabSpec
    from spark_languagedetector_tpu_torch.parallel.mesh import build_mesh
    from spark_languagedetector_tpu_torch.parallel.sequence import (
        chunk_grid,
        ring_score_chunks,
        score_long_document,
    )

    m = build_mesh(data=data, vocab=vocab)
    spec = VocabSpec(*spec_args[:2], **spec_args[2])
    weights, lut = _membership(weights, lut)
    psum = score_long_document(doc, weights, lut, spec, m, chunk_size=chunk_size)
    b, ln, lim = chunk_grid(doc, m.shape["data"], chunk_size, spec.gram_lengths)
    ring = ring_score_chunks(b, ln, lim, weights, lut, spec, m).numpy()
    return psum, ring


# -- the public API on a mesh ---------------------------------------------------
def _model_of(spec: dict):
    """A model from a spec: ``{"rows": {...}, "languages", "grams", "k",
    "vocab": (mode, hash_bits) | None, "fit_backend"}``, fitted by the
    port's host fit (or device fit) on the CPU."""
    P = _P()
    det = P.LanguageDetector(spec["languages"], spec["grams"], spec["k"]).set_device("cpu")
    if spec.get("vocab"):
        mode, bits = spec["vocab"]
        det = det.set_vocab_mode(mode)
        if bits:
            det = det.set_hash_bits(bits)
    if spec.get("fit_backend"):
        det = det.set_fit_backend(spec["fit_backend"])
    return det.fit(P.Table(spec["rows"]))


def fit_profile(model_spec):
    m = _model_of(model_spec)
    return m.profile.ids, m.profile.weights


def transform_labels(model_spec, texts, device, batch_size=None):
    """Labels of ``texts`` with the model's ``device`` set (``"cpu"``,
    ``"mesh"``, ``"mesh:vocab"``), the runner's strategy and mesh shape."""
    P = _P()
    model = _model_of(model_spec).set_device(device)
    if batch_size:
        model.set_batch_size(batch_size)
    labels = model.transform(P.Table({"fulltext": texts})).column("lang").tolist()
    r = model.runner
    return labels, r.strategy, None if r.mesh is None else dict(r.mesh.shape)


def runner_scores(model_spec, docs, device, strategy="auto", batch_size=None,
                  length_buckets=None, labels=False, block_input=False):
    """A runner over the model's membership on ``device`` (``"cpu"`` or a
    mesh value): scores (or labels) of ``docs``, its strategy and mesh."""
    from spark_languagedetector_tpu_torch.api.runner import BatchRunner, resolve_mesh
    from spark_languagedetector_tpu_torch.ops.encode_device import DocBlock

    model = _model_of(model_spec)
    w, lut, cuckoo = model.profile.device_membership(device="cpu")
    mesh = resolve_mesh(device)
    r = BatchRunner(weights=w, lut=lut, cuckoo=cuckoo, spec=model.profile.spec,
                    device=None if mesh is not None else device, mesh=mesh,
                    strategy=strategy, batch_size=batch_size,
                    length_buckets=length_buckets)
    inp = DocBlock.from_bytes(docs) if block_input else docs
    out = r.predict_ids(inp) if labels else r.score(inp)
    return out, r.strategy, None if mesh is None else dict(mesh.shape)


def raw_runner_scores(weights, lut, spec_args, docs, device, strategy="auto",
                      length_buckets=None, cuckoo_keys=None):
    """A runner over given membership arrays (dense table or LUT, or a
    cuckoo table built from packed keys) on ``device``."""
    from spark_languagedetector_tpu_torch.api.runner import BatchRunner, resolve_mesh
    from spark_languagedetector_tpu_torch.ops.cuckoo import build_cuckoo
    from spark_languagedetector_tpu_torch.ops.vocab import VocabSpec

    mesh = resolve_mesh(device)
    cuckoo = None if cuckoo_keys is None else build_cuckoo(*cuckoo_keys)
    r = BatchRunner(weights=weights, lut=lut, cuckoo=cuckoo,
                    spec=VocabSpec(*spec_args[:2], **spec_args[2]),
                    device=None if mesh is not None else device, mesh=mesh,
                    strategy=strategy, length_buckets=length_buckets)
    return r.score(docs), r.strategy, None if mesh is None else dict(mesh.shape)


def segment_cells(model_spec, docs, device, length_buckets=None):
    from spark_languagedetector_tpu_torch.api.runner import BatchRunner, resolve_mesh

    model = _model_of(model_spec)
    w, lut, cuckoo = model.profile.device_membership(device="cpu")
    mesh = resolve_mesh(device)
    r = BatchRunner(weights=w, lut=lut, cuckoo=cuckoo, spec=model.profile.spec,
                    device=None if mesh is not None else device, mesh=mesh,
                    length_buckets=length_buckets)
    cells, _ = r.segment_cells(docs, cell=128)
    return cells, r.strategy


def segment_results(model_spec, texts, device):
    P = _P()
    model = _model_of(model_spec).set_device(device)
    model = model.copy({"resultMode": "segment"})
    return model.transform(P.Table({"fulltext": texts})).column("lang").tolist()


def accumulator_roundtrip(model_spec, batches, path, device):
    """FitAccumulator on ``device`` (``"mesh"`` resolves the fit mesh):
    update, finalize, update, finalize, save (rank 0 writes), load and
    finalize again; the three profiles."""
    P = _P()
    from spark_languagedetector_tpu_torch.api.runner import resolve_fit_mesh
    from spark_languagedetector_tpu_torch.models.refit import FitAccumulator

    det = P.LanguageDetector(model_spec["languages"], model_spec["grams"], model_spec["k"])
    if model_spec.get("vocab"):
        mode, bits = model_spec["vocab"]
        det = det.set_vocab_mode(mode)
        if bits:
            det = det.set_hash_bits(bits)
    mesh = resolve_fit_mesh() if device == "mesh" else None
    acc = FitAccumulator.for_estimator(det.set_device("cpu"), mesh=mesh)
    out = []
    acc.update(P.Table(batches[0]))
    out.append(acc.finalize())
    acc.update(P.Table(batches[1]))
    out.append(acc.finalize())
    acc.save(path)
    loaded = FitAccumulator.load(path, mesh=mesh, device=None if mesh else "cpu")
    out.append(loaded.finalize())
    return out, acc.mesh is not None, loaded.committed


def resolve_info(backend, table_bytes=None):
    from spark_languagedetector_tpu_torch.api.runner import resolve_fit_mesh, resolve_mesh

    m = resolve_mesh(backend, table_bytes)
    fit = resolve_fit_mesh()
    return (None if m is None else dict(m.shape)), dict(fit.shape)


def jax_modules():
    """The modules of JAX or of the JAX package this rank has loaded."""
    return sorted(m for m, mod in sys.modules.items() if mod is not None
                  and m.split(".")[0] in ("jax", "jaxlib", "spark_languagedetector_tpu"))
