"""Micro-batching runner: documents → device batches → scores, labels or cells.

Port of ``spark_languagedetector_tpu.api.runner.BatchRunner`` for the
``score`` / ``predict_ids`` / ``predict`` path and segment mode's
``segment_cells``, execution layer included. A call runs the JAX runner's
sequence (``_execute_traced`` / ``_segment_traced``, whose batches both run
through one loop, ``_run_plan``):

  truncate → dedup → chunk table → plan → pack (padded, ragged or wire) →
  pinned H2D copy → dispatch under policy/breaker/ladder → asynchronous D2H
  into pinned memory → scatter-back

* ``max_score_bytes`` scores only a UTF-8-safe prefix of each document;
* duplicate documents are planned, copied and scored once, and every
  duplicate reads its unique row's result (``out = out[inverse]``); a
  :class:`~..ops.encode_device.DocBlock` input skips dedup, as in JAX;
* documents longer than the largest bucket are chunked with
  ``max(gram_lengths) - 1`` bytes of overlap; a non-final chunk owns window
  starts ``[0, stride)`` through ``window_limit``, and the chunks' score rows
  are summed before the argmax, so chunked documents label exactly;
* chunks are grouped into padded-length buckets and byte-budgeted
  micro-batches (``exec.core.plan_micro_batches``);
* each batch ships in the wire format of :mod:`..exec.pack`, which the
  device fit shares: packed into pinned host memory (``exec.staging``)
  padded, ragged where the flat buffer is smaller than the padded one, or
  as raw bytes (the wire form) when ``device_encode`` is on or the input is
  a ``DocBlock``; copied ``non_blocking`` and rebuilt into the padded batch
  on the card;
* batches dispatch in plan order on ``dispatch_workers`` threads
  (``exec.core.run_ordered``) under ``exec.core.guarded_dispatch``: a
  retryable failure replays under the ``RetryPolicy``; a ``CircuitBreaker``
  that has opened, or a replay that is exhausted, sends the batch down the
  degradation ladder — the device gather scorer on the profile's f32
  weights, then the same scorer on the host — exact at every rung, counted
  (``resilience/degraded_*``, ``langdetect_degraded``) and logged. The
  ladder never stands in for a CUDA kernel: where the path launches one
  (every strategy but ``gather`` on the card; in segment mode, ``fused``),
  a failure replays under the policy and then raises;
* every result's copy into pinned memory starts before the first fetch; a
  fetch that fails replays its batch, then takes the ladder where allowed;
* in label mode the argmax runs on the device and only labels (plus the few
  score rows of chunked documents) are fetched;
* in segment mode the device returns one score vector per cell of
  ``SEGMENT_CELL`` window starts; long documents chunk on a cell-aligned
  stride, so each cell is owned by one chunk; only owned cells are copied
  back.

A kernel that fails to build or launch (``KernelBuildError``,
``KernelLaunchError``) or any CUDA error is not retryable: it propagates,
with no replay and no ladder. The spans ``score``, ``score/pack``,
``score/dispatch``, ``score/fetch`` and ``score/degraded`` and the JAX
runner's counters are recorded in ``telemetry.REGISTRY`` under the same
names, and a call that raises dumps the flight recorder. The port adds
``runner/prepare`` (truncate through the chunk ranks, before ``score``) and
``runner/finish`` (the chunked argmax and the scatter-back, after it),
siblings of ``score`` under one request trace per call. A ``hybrid``
batch's dispatch records its two parts, ``hybrid/short`` (lengths ≤ 2) and
``hybrid/long`` (the rest), inside ``score/dispatch``; a runner that holds
row-histogram operands sets the ``runner/hist_rows`` gauge to their padded
row count, and its ``runner.strategy`` event names the long grams' route
(``long_route``).

Strategies, chosen by ``auto`` in this order (the JAX package's accelerator
order; the choice does not depend on the device — on the CPU each strategy
runs its kernels' plain versions):

* ``"fused"``: dense and LUT profiles (the CUDA fused-detect kernel);
* ``"pallas"``: exact vocabs with gram lengths ⊆ {1, 2} over the dense
  table (bigram-score kernel up to 16 languages, bigram-histogram kernel and
  a matmul beyond);
* ``"hybrid"``: exact short-gram ids with longer grams (cuckoo profiles,
  exact n = 1..5): lengths ≤ 2 through the pallas scorer over a dense
  sub-table, the rest through ``hist`` (or the cuckoo/LUT gather when no
  bucket table could be built);
* ``"hist"``: compact-row membership (a bucket table from the cuckoo keys or
  the LUT): the row-histogram kernel and a matmul;
* ``"gather"``: the row-gather reference (dense, LUT or cuckoo), explicit
  or when nothing above applies.

Every ``score``/``predict_ids`` call runs under
:func:`~..utils.profiling.trace` (a no-op unless the ``trace_dir`` knob is
set), and the first call of each runner records the roofline cost gauges
of :mod:`..telemetry.cost` on a background thread (``_cost_thread``).

On a mesh (``mesh=``, a :class:`~..parallel.mesh.Mesh` of process-group
ranks; :func:`resolve_mesh`), every rank calls with the same documents and
runs the same plan. Each planned batch is padded with empty rows to a
multiple of the data axis (``parallel.mesh.pad_rows_for_mesh``); each rank
packs, copies and scores its data shard of the rows with the strategy's
own kernels, and an ``all_gather`` over the data axis gives every rank the
whole batch's result before the fetch, so every rank returns every
document's answer (JAX's ``process_allgather``). The ragged and wire forms
are off there (a ``DocBlock`` input is materialized), one dispatch thread
keeps the collectives in one order on every rank, and on a mesh of more
than one rank a failure replays under the policy on every rank alike and
never takes the ladder, which one rank alone would take. The vocab axis
stripes the dense weight table of the ``gather`` strategy only (``auto``
picks it on a vocab mesh with a dense table): each vocab rank gathers its
stripe's rows and a ``psum`` over the vocab line sums the parts; every
other form is replicated over the vocab axis.
"""

from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from .. import native
from ..exec import config as exec_config
from ..exec.core import (
    dedup_counted,
    guarded_dispatch,
    plan_micro_batches,
    rows_under_byte_budget,
    run_ordered,
)
from ..exec.pack import Batch, Spans
from ..exec.staging import HostStaging, copy_to_host_async, host_numpy, upload
from ..ops import bucket as bucket_ops
from ..ops import cuckoo as cuckoo_ops
from ..ops import score as score_ops
from ..ops import _kernels, score_fused, score_hist, score_pallas
from ..ops.encode_device import DocBlock, chunk_table, utf8_safe_lengths
from ..ops.encoding import ENCODINGS, UTF8, chunk_document, truncate_utf8
from ..ops.vocab import EXACT, EXACT12, HASHED, VocabSpec
from ..resilience import faults
from ..resilience.policy import CLOSED, CircuitBreaker, RetryPolicy
from ..telemetry import REGISTRY, current_trace_id, flightrec, span, trace_request
from ..utils.debug import check_finite
from ..utils.device import resolve_device
from ..utils.logging import get_logger, log_event
from ..utils.metrics import Metrics
from ..utils.profiling import trace

_log = get_logger("api.runner")

MESH_BACKENDS = ("mesh", "mesh:vocab")


def resolve_mesh(backend: str, table_bytes: int | None = None):
    """The mesh for a ``device`` value of ``"mesh"`` or ``"mesh:vocab"``
    over every rank of the initialised process group (a one-rank mesh
    without one), or None for any other value.

    ``"mesh"`` is data-parallel. ``"mesh:vocab"`` carves a vocab axis so
    the dense weight table stripes instead of replicating: the smallest
    power of two whose per-rank stripe fits the replication budget
    (``table_bytes`` hint; 2 when unknown), capped at the rank count, the
    rest data-parallel — JAX's ``resolve_mesh`` over ranks for devices."""
    from ..models.profile import DENSE_TABLE_BUDGET_BYTES
    from ..parallel.distributed import process_count
    from ..parallel.mesh import build_mesh

    n = process_count()
    if backend == "mesh:vocab":
        vocab = 2
        if table_bytes is not None:
            while vocab * 2 <= n and table_bytes / vocab > DENSE_TABLE_BUDGET_BYTES:
                vocab *= 2
        vocab = min(vocab, n)
        return build_mesh(data=n // vocab, vocab=vocab)
    if backend == "mesh":
        return build_mesh(data=n, vocab=1)
    return None


def resolve_fit_mesh():
    """The mesh of ``fitBackend="device"``: every rank of the initialised
    process group on the data axis (one rank included, whose collectives
    are then real calls), or None without a group — one policy site shared
    with :func:`resolve_mesh`, as in JAX."""
    import torch.distributed as dist

    from ..parallel.mesh import build_mesh

    if not (dist.is_available() and dist.is_initialized()):
        return None
    return build_mesh(data=dist.get_world_size(), vocab=1)

DEFAULT_BATCH_SIZE = 256
# The fused and pallas kernels keep per-document state on chip (no
# O(B·vocab) buffers), so they take much larger micro-batches.
DEFAULT_FUSED_BATCH_SIZE = 4096
# Hybrid and hist micro-batches (the JAX runner's sizes): the histograms are
# [B, 65536] and [B, Rhi·256] float32 buffers, and gram lengths ≥ 4 (three
# long-gram membership passes per document) take the smaller batch.
DEFAULT_HYBRID_BATCH_SIZE = 4096
DEFAULT_HEAVY_BATCH_SIZE = 1024
# Default dispatch threads (``dispatch_workers=None`` and no
# ``LANGDETECT_DISPATCH_WORKERS``), the JAX runner's default.
DISPATCH_WORKERS = 1
STRATEGIES = ("auto", "fused", "pallas", "hybrid", "hist", "gather")
# Segment-mode cell width: window start positions per device score vector
# (a multiple of 128; the JAX package's default).
SEGMENT_CELL = 256

_NO_POS = np.zeros(0, dtype=np.int64)


def _host_array(x, dtype=None) -> np.ndarray:
    """A membership operand as a host array: a numpy array (a baked
    artifact's read-only mapping included) as it is, a tensor copied to the
    host."""
    if isinstance(x, np.ndarray):
        return np.asarray(x, dtype=dtype)
    return np.asarray(torch.as_tensor(x).cpu(), dtype=dtype)


@dataclass(frozen=True)
class HistState:
    """Row-histogram operands: the padded weight table (float64, for the
    contraction), Rhi, and the membership — a bucket table (``kind``
    'exact' for packed gram keys, 'hashed' for window ids) or, when
    ``bucket`` is None, the id→row LUT."""

    weights_pad: torch.Tensor
    rhi: int
    bucket: torch.Tensor | None
    seed: int
    kind: str
    lut: torch.Tensor | None


@dataclass(frozen=True)
class PallasState:
    """Bigram-scorer operands: the exact sub-spec of lengths ≤ 2, its
    weight views, and the lengths left for the long-gram part (hybrid)."""

    spec: VocabSpec
    w1: torch.Tensor
    w2: torch.Tensor
    rest: tuple[int, ...]


@dataclass
class _Work:
    """One whole-document call's work items: item ``k`` is ``chunks[k]``
    (list lane) or the span ``(chunk_starts[k], chunk_lens[k])`` of
    ``block``'s byte plane (block lane) of unique document ``doc_idx[k]``,
    with window limit ``limits[k]``. ``chunk_rank`` numbers the chunked
    documents; in label mode ``chunked`` marks their items."""

    n_in: int
    block: DocBlock | None = None
    n: int = 0
    inverse: np.ndarray | None = None
    chunks: list | None = None
    chunk_starts: np.ndarray | None = None
    chunk_lens: np.ndarray | None = None
    doc_idx: np.ndarray | None = None
    limits: np.ndarray | None = None
    plan: list = field(default_factory=list)
    chunk_rank: dict = field(default_factory=dict)
    chunked: np.ndarray | None = None

    def docs(self, sel) -> list[bytes]:
        """Materialized chunk bytes of one batch (the ladder's input)."""
        if self.chunks is not None:
            return [self.chunks[k] for k in sel]
        flat = self.block.flat
        return [
            flat[s : s + ln].tobytes()
            for s, ln in zip(self.chunk_starts[sel], self.chunk_lens[sel])
        ]

    def chunk_pos(self, sel) -> np.ndarray:
        """Rows of a batch that hold chunks of chunked documents."""
        return _NO_POS if self.chunked is None else np.flatnonzero(self.chunked[sel])


@dataclass
class BatchRunner:
    """Scores document collections through fixed-shape micro-batches on one
    device. One runner per (profile, configuration); reuse it across calls.

    ``weights`` / ``lut`` / ``cuckoo`` are the profile's membership
    (``GramProfile.device_membership``; arrays may be numpy or tensors).
    ``device`` None means the CUDA card and raises when there is none;
    ``mesh`` (not with ``device``) runs on that mesh's ranks, each on its
    own device, as the module docstring says. After
    construction the strategy's device operands are built once: for
    ``fused``, ``table`` / ``scales`` / ``table_lut`` in the
    :func:`~..ops.score_fused.build_fused_tables` layout ``layout``; for the
    bigram strategies ``pallas_state``; for the row histogram ``hist_state``
    (None where the hybrid's long grams gather instead); for gathers
    ``table`` / ``table_lut`` and the cuckoo entries.

    Execution knobs, each resolved through ``exec.config`` when None
    (explicit value > ``LANGDETECT_*`` env > tuning profile > default):
    ``length_buckets``, ``batch_bytes``, ``dispatch_workers``,
    ``device_encode`` (ship the raw wire form; off by default),
    ``degraded_fallback`` (the ladder where no CUDA kernel runs, see
    :meth:`_ladder_allowed`; on) and ``dedup`` (on). ``retry_policy``
    and ``breaker`` default to ``RetryPolicy.from_env()`` and
    ``CircuitBreaker.from_env(name="score")``; ``metrics`` holds the
    runner's own counters and timers.

    Concurrent callers may score on one runner from several threads: each
    call plans, packs and scatters into its own state, the lazily built
    operands are guarded by ``_state_lock``, and the metrics, the registry
    and the staging ring lock internally.
    """

    weights: object
    lut: object | None
    spec: VocabSpec
    cuckoo: cuckoo_ops.CuckooTable | None = None
    device: object | None = None
    batch_size: int | None = None  # None ⇒ by strategy
    length_buckets: tuple[int, ...] | None = None
    batch_bytes: int | None = None
    block: int = score_ops.DEFAULT_BLOCK  # gather window block
    strategy: str = "auto"
    quantization: str | None = None  # 'int8' | 'int16' fused tables
    max_score_bytes: int | None = None
    score_encoding: str = UTF8
    dispatch_workers: int | None = None
    device_encode: bool | None = None
    retry_policy: RetryPolicy | None = None
    breaker: CircuitBreaker | None = None
    degraded_fallback: bool | None = None
    dedup: bool | None = None
    mesh: object | None = None
    metrics: Metrics = field(default_factory=Metrics)

    def __post_init__(self):
        self._ndata, self._striped, self._multiproc = 1, False, False
        if self.mesh is not None:
            if self.device is not None:
                raise ValueError("pass either device or mesh, not both")
            from ..parallel.mesh import DATA_AXIS

            self.device = self.mesh.device
            self._ndata = int(self.mesh.shape[DATA_AXIS])
            # A failure one rank alone falls back from would break the
            # collective order.
            self._multiproc = self.mesh.size > 1
        self.device = resolve_device(self.device)
        # Created first: the lazily built operands resolve through it.
        self._state_lock = threading.Lock()
        self.length_buckets = tuple(
            exec_config.resolve("length_buckets", self.length_buckets)
        )
        self.batch_bytes = int(exec_config.resolve("batch_bytes", self.batch_bytes))
        if self.dispatch_workers is None:
            self.dispatch_workers = exec_config.resolve("dispatch_workers")
        if self.retry_policy is None:
            self.retry_policy = RetryPolicy.from_env()
        if self.breaker is None:
            self.breaker = CircuitBreaker.from_env(name="score")
        if self.degraded_fallback is None:
            self.degraded_fallback = bool(exec_config.resolve("degraded"))
        if self.dedup is None:
            self.dedup = bool(exec_config.resolve("dedup"))
        if self.device_encode is None:
            self.device_encode = bool(exec_config.resolve("device_encode"))
        if self.mesh is not None:
            self.device_encode = False
        # True while the last dispatch rode the degradation ladder; drives
        # the langdetect_degraded gauge's reset on fast-path recovery.
        self._degraded_mode = False
        # The roofline cost gauges: recorded once, by _start_cost_thread.
        self._cost_recorded = False
        self._cost_thread: threading.Thread | None = None
        self._cost_error: Exception | None = None
        self._staging = HostStaging(self.device)
        if self.score_encoding not in ENCODINGS:
            raise ValueError(
                f"unknown score_encoding {self.score_encoding!r}; expected "
                f"one of {ENCODINGS}"
            )
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown strategy {self.strategy!r}; expected one of {STRATEGIES}"
            )
        if self.quantization not in (None, *score_fused.QUANT_DTYPES):
            raise ValueError(
                f"unknown quantization {self.quantization!r}; expected one "
                f"of {tuple(score_fused.QUANT_DTYPES)} or None"
            )
        if self.quantization is not None and self.strategy not in ("auto", "fused"):
            raise ValueError(
                "quantization applies to the fused strategy only; got "
                f"strategy={self.strategy!r}"
            )
        w = _host_array(self.weights, np.float32)
        lut = None if self.lut is None else _host_array(self.lut)
        if lut is not None and lut.size == 0:
            lut = None
        if lut is not None and self.cuckoo is not None:
            raise ValueError("pass a LUT or a cuckoo table for membership, not both")
        self.num_langs = w.shape[1]
        # Host membership (the profile's f32 weights), kept for the gather
        # scorer's operands: uploaded on the first segment request of a
        # non-fused runner or the first degraded batch, and the host rung.
        self._host_weights, self._host_lut = w, lut
        self._gather_ops = None
        self._host_ops = None
        fused_ok = score_fused.fused_supported(
            self.spec, w.shape[0], w.shape[1], lut=lut, cuckoo=self.cuckoo
        )
        pallas_ok = (
            lut is None
            and self.cuckoo is None
            and score_pallas.pallas_supported(self.spec, w.shape[0], w.shape[1])
        )
        hybrid_ok = self._hybrid_supported()
        self.hist_state = None
        stripes = (
            self.mesh is not None
            and int(self.mesh.shape["vocab"]) > 1
            and lut is None
            and self.cuckoo is None
            and w.shape[0] == self.spec.id_space_size
        )
        if self.strategy == "auto" and stripes and self.quantization is None:
            self.strategy = "gather"
            self.strategy_reason = "vocab mesh over a dense table ⇒ striped gather"
        elif self.strategy == "auto":
            self.strategy, self.strategy_reason = self._auto_select(
                w, lut, fused_ok, pallas_ok, hybrid_ok
            )
        else:
            self.strategy_reason = "explicit"
        self._striped = stripes and self.strategy == "gather"
        if self.strategy in ("hybrid", "hist") and self.hist_state is None:
            self.hist_state = self._build_hist_state(w, lut)
        for name, ok, need in (
            ("fused", fused_ok, "dense or LUT membership (exact gram lengths "
             "<= 3, or a hashed vocab); cuckoo profiles use hybrid/hist"),
            ("pallas", pallas_ok, "an exact vocab with gram lengths <= 2 and "
             "the dense weight table"),
            ("hybrid", hybrid_ok, "exact short-gram ids (exact vocab or hashed "
             "'exact12' scheme) with gram lengths both <= 2 and > 2"),
            ("hist", self.hist_state is not None, "compact-row membership (a "
             "cuckoo table whose bucket build succeeds, or an id->row LUT)"),
        ):
            if self.strategy == name and not ok:
                raise ValueError(f"strategy={name!r} needs {need}")
        self._build_operands(w, lut)
        self.long_route = self._long_route()
        self._check_tables()
        if self.batch_size is None:
            if self.strategy in ("fused", "pallas"):
                self.batch_size = DEFAULT_FUSED_BATCH_SIZE
            elif self.strategy in ("hybrid", "hist"):
                heavy = any(n >= 4 for n in self.spec.gram_lengths)
                self.batch_size = (
                    DEFAULT_HEAVY_BATCH_SIZE if heavy else DEFAULT_HYBRID_BATCH_SIZE
                )
            else:
                self.batch_size = DEFAULT_BATCH_SIZE
        log_event(
            _log, "runner.strategy", strategy=self.strategy,
            reason=self.strategy_reason, long_route=self.long_route,
            device=str(self.device), quantization=self.quantization,
            mesh=None if self.mesh is None else dict(self.mesh.shape),
        )
        # The one-time packer build happens here, not inside the first
        # call's hot loop.
        native.available()

    # -- strategy selection and operands ---------------------------------------
    def _hybrid_supported(self) -> bool:
        """Gram lengths both ≤ 2 and > 2 whose short-gram ids are exact
        polynomial ids: exact vocabs, and hashed vocabs under ``exact12``
        (whose buckets [0, 65792) are exactly the short-gram ids)."""
        glens = self.spec.gram_lengths
        ids_exact12 = self.spec.mode == EXACT or (
            self.spec.mode == HASHED and self.spec.hash_scheme == EXACT12
        )
        return ids_exact12 and min(glens) <= 2 < max(glens)

    def _auto_select(self, w, lut, fused_ok, pallas_ok, hybrid_ok) -> tuple[str, str]:
        """(strategy, reason) for strategy='auto': fused → pallas → hybrid →
        hist → gather, whatever the device. Deciding on hist builds its
        operands (``hist_state``)."""
        if self.quantization is not None:
            if not fused_ok:
                raise ValueError(
                    "quantization needs the fused strategy, which does not "
                    "support this profile form (cuckoo membership)"
                )
            return "fused", "quantization requested ⇒ fused table"
        if fused_ok:
            return "fused", "dense/LUT membership ⇒ fused kernel"
        if pallas_ok:
            return "pallas", "exact short-gram dense table ⇒ bigram kernels"
        if hybrid_ok:
            return "hybrid", (
                "exact short-gram ids with long grams ⇒ bigram kernels for "
                "n <= 2, row histogram (or gather) for the rest"
            )
        self.hist_state = self._build_hist_state(w, lut)
        if self.hist_state is not None:
            return "hist", "compact-row membership ⇒ row-histogram kernel"
        return "gather", "no kernel strategy covers this profile form"

    def _build_hist_state(self, w: np.ndarray, lut: np.ndarray | None) -> HistState | None:
        """Row-histogram operands, or None where the strategy cannot apply
        (no compact membership, or a cuckoo profile whose bucket build found
        no zero-overflow seed). The bucket table comes from the cuckoo keys
        (packed-key slots) or from the LUT's learned ids (id slots); when a
        LUT's bucket build fails the LUT itself is the membership."""
        if self.cuckoo is not None:
            table = bucket_ops.build_buckets_exact(
                self.cuckoo.keys_lo[:-1], self.cuckoo.keys_hi[:-1]
            )
            if table is None:
                return None
        elif lut is not None:
            ids = np.flatnonzero(lut != w.shape[0] - 1).astype(np.int32)
            table = bucket_ops.build_buckets_hashed(ids, lut[ids])
        else:
            return None
        wp, rhi = score_hist.pad_weights(w)
        REGISTRY.set_gauge("runner/hist_rows", float(wp.shape[0]))
        dev = self.device
        return HistState(
            weights_pad=upload(wp, dev).to(torch.float64),
            rhi=rhi,
            bucket=None if table is None else upload(table.rows, dev),
            seed=0 if table is None else table.seed,
            kind="hashed" if table is None else table.kind,
            lut=upload(lut, dev) if table is None else None,
        )

    def _long_route(self) -> str | None:
        """How the grams the bigram scorers leave are scored: ``bucket``
        or ``lut`` (the row histogram's membership), else the gather's
        ``striped``, ``cuckoo``, ``lut`` or ``dense`` form; None for
        ``fused`` and ``pallas``, which leave none."""
        if self.strategy in ("fused", "pallas"):
            return None
        h = self.hist_state
        if h is not None:
            return "bucket" if h.bucket is not None else "lut"
        if self._striped:
            return "striped gather"
        if self.cuckoo is not None:
            return "cuckoo gather"
        return "lut gather" if self.table_lut is not None else "dense gather"

    def _build_pallas_state(self, w: np.ndarray, lut: np.ndarray | None) -> PallasState:
        """Bigram-scorer operands on the device. For ``pallas`` the whole
        dense table; for ``hybrid`` the dense sub-table of lengths ≤ 2,
        gathered once from the profile through the cuckoo table (every 1- and
        2-gram key looked up on the host), the LUT, or the dense table's
        first rows (the exact id layout stacks lengths ascending, so the
        sub-spec's ids are the full spec's first rows)."""
        if self.strategy == "pallas":
            table = upload(w, self.device)
            return PallasState(self.spec, *score_pallas.weight_views(table, self.spec), rest=())
        sub = tuple(n for n in self.spec.gram_lengths if n <= 2)
        rest = tuple(n for n in self.spec.gram_lengths if n > 2)
        spec12 = VocabSpec(EXACT, sub)
        V12 = spec12.id_space_size
        if self.cuckoo is not None:
            v = np.arange(256, dtype=np.uint32)
            a = np.repeat(v, 256)
            b = np.tile(v, 256)
            lo = np.concatenate([v << 24, (a << 24) | (b << 16)]).astype(np.int32)
            hi = np.concatenate(
                [np.full(256, 1 << 8, np.int32), np.full(65536, 2 << 8, np.int32)]
            )
            rows = cuckoo_ops.lookup_numpy(self.cuckoo, lo, hi)[:V12]
        elif lut is not None:
            rows = lut[:V12]
        else:
            rows = np.arange(V12)
        table = upload(w[rows], self.device)
        return PallasState(spec12, *score_pallas.weight_views(table, spec12), rest=rest)

    def _build_operands(self, w: np.ndarray, lut: np.ndarray | None) -> None:
        """Upload what the strategy reads, once."""
        dev = self.device
        self.layout = self.scales = self.table = self.table_lut = None
        self.pallas_state = None
        self._cuckoo_entries = None
        if self.strategy == "fused":
            ft = score_fused.build_fused_tables(w, lut, self.spec, self.quantization)
            self.layout = ft.layout
            self._table_bytes = ft.table_bytes
            self.table = upload(ft.wq, dev)
            self.scales = upload(ft.scales, dev)
            self.table_lut = None if ft.lut is None else upload(ft.lut, dev)
            return
        held = []
        if self.strategy in ("pallas", "hybrid"):
            self.pallas_state = self._build_pallas_state(w, lut)
            held += [self.pallas_state.w1, self.pallas_state.w2]
        if self.hist_state is not None:
            held += [
                t for t in (self.hist_state.weights_pad, self.hist_state.bucket,
                            self.hist_state.lut) if t is not None
            ]
        elif self._striped:
            from ..parallel.sharded import stripe_operands

            self.table, self.table_lut = stripe_operands(self.mesh, w)
            held += [self.table, self.table_lut]
        elif self.strategy in ("hybrid", "gather"):
            self.table = upload(w, dev)
            held.append(self.table)
            if self.cuckoo is not None:
                self._cuckoo_entries = upload(self.cuckoo.entries(), dev)
                held.append(self._cuckoo_entries)
            elif lut is not None:
                self.table_lut = upload(lut, dev)
                held.append(self.table_lut)
        self._table_bytes = sum(t.numel() * t.element_size() for t in held)

    def weight_tables(self) -> list[torch.Tensor]:
        """The weight tensors the strategy's dispatch reads: the table in
        its stored dtype, the bigram views, the row-histogram operand.
        Views may share a storage."""
        out = [self.table]
        if self.pallas_state is not None:
            out += [self.pallas_state.w2, self.pallas_state.w1]
        if self.hist_state is not None:
            out.append(self.hist_state.weights_pad)
        return [t for t in out if t is not None]

    def _check_tables(self) -> None:
        """Under ``utils.debug.nan_checks``: the uploaded weight tables and
        scales, checked on their device."""
        check_finite(self.weight_tables() + [self.scales], "runner weight table")

    def kernels(self) -> tuple:
        """The CUDA kernels this runner's strategy can launch, none off the
        card: the fused pair for ``fused`` (its segment mode included), the
        bigram kernel of its width for ``pallas``/``hybrid``, and the row
        histogram where the runner holds its operands."""
        if self.device.type != "cuda":
            return ()
        if self.strategy == "fused":
            return (_kernels.FUSED_DETECT, _kernels.FUSED_SEGMENT)
        out = []
        if self.pallas_state is not None:
            out.append(
                _kernels.BIGRAM_HIST
                if self.num_langs > score_pallas.MAX_PALLAS_LANGS
                else _kernels.BIGRAM_SCORE
            )
        if self.hist_state is not None:
            out.append(_kernels.ROW_HIST)
        return tuple(out)

    @property
    def max_chunk(self) -> int:
        return self.length_buckets[-1]

    def table_bytes(self) -> int:
        """Device bytes of the active strategy's tables and membership."""
        return int(self._table_bytes)

    def device_tables(self) -> list[torch.Tensor]:
        """Every table tensor this runner holds on its device: the weight
        table in its stored dtype and its scales, the LUT or cuckoo
        entries, the bigram and row-histogram operands, and the gather
        operands once built. Views may share a storage (the bigram weight
        views of a ``pallas`` table do)."""
        out = [self.table, self.scales, self.table_lut, self._cuckoo_entries]
        if self.pallas_state is not None:
            out += [self.pallas_state.w1, self.pallas_state.w2]
        if self.hist_state is not None:
            out += [self.hist_state.weights_pad, self.hist_state.bucket, self.hist_state.lut]
        out += list(self._gather_ops or ())
        return [t for t in out if t is not None]

    def plan(self, sizes: Sequence[int]) -> list[tuple[np.ndarray, int]]:
        """The micro-batch plan for items of these byte sizes."""
        return plan_micro_batches(
            sizes,
            length_buckets=self.length_buckets,
            rows_for=lambda pad_to: rows_under_byte_budget(
                pad_to, self.batch_bytes, self.batch_size
            ),
        )

    # -- device work ----------------------------------------------------------
    def _scores(self, batch, lengths, window_limit) -> torch.Tensor:
        if self.strategy == "fused":
            return score_fused.score_batch_fused(
                batch, lengths, self.table, self.scales, self.table_lut, window_limit,
                spec=self.spec, layout=self.layout,
            )
        if self.strategy in ("pallas", "hybrid"):
            # Lengths ≤ 2 through the bigram kernels; a hybrid's longer
            # lengths through the row histogram or the gather. Each part
            # applies its own lengths' partial-window rules, so the sum is
            # exact.
            st = self.pallas_state
            if not st.rest:
                return score_pallas.score_batch_pallas(
                    batch, lengths, st.w1, st.w2, window_limit, spec=st.spec
                )
            with span("hybrid/short"):
                short = score_pallas.score_batch_pallas(
                    batch, lengths, st.w1, st.w2, window_limit, spec=st.spec
                )
            with span("hybrid/long", route=self.long_route):
                long = self._long_scores(batch, lengths, window_limit, st.rest)
            return short + long
        return self._long_scores(batch, lengths, window_limit, None)

    def _long_scores(self, batch, lengths, window_limit, subset) -> torch.Tensor:
        """Row-histogram scores where the runner has the operands, else the
        gather (cuckoo, LUT or dense) — the hybrid's long-gram route when no
        bucket table could be built, and the explicit ``gather``."""
        h = self.hist_state
        if h is not None:
            return score_hist.score_batch_hist(
                batch, lengths, h.weights_pad, h.lut, h.bucket, window_limit,
                spec=self.spec, rhi=h.rhi, bucket_seed=h.seed, bucket_kind=h.kind,
                gram_lengths_subset=subset,
            )
        block = self.block if subset is None else min(self.block, 256)
        if self._striped:
            from ..parallel.sharded import striped_scores

            return striped_scores(
                self.mesh, batch, lengths, self.table, self.table_lut, spec=self.spec,
                block=block, window_limit=window_limit,
            )
        if self.cuckoo is not None:
            return score_ops.score_batch_cuckoo(
                batch, lengths, self.table, self._cuckoo_entries,
                seed1=self.cuckoo.seed1, seed2=self.cuckoo.seed2, spec=self.spec,
                block=block, window_limit=window_limit, gram_lengths_subset=subset,
            )
        return score_ops.score_batch(
            batch, lengths, self.table, self.table_lut, spec=self.spec,
            block=block, window_limit=window_limit, gram_lengths_subset=subset,
        )

    def _gather_operands(self):
        """(table, lut, cuckoo entries) of the gather scorers on the device:
        the profile's own f32 membership, never a quantized table. The
        gather strategies hold it already; the kernel strategies upload it
        on first use (a segment request, or the ladder's gather rung)."""
        ops = self._gather_ops
        if ops is not None:
            return ops
        with self._state_lock:
            if self._gather_ops is None:
                dev = self.device
                table, lut, entries = self.table, self.table_lut, self._cuckoo_entries
                if table is None or self.strategy == "fused":
                    table = upload(self._host_weights, dev)
                    lut = entries = None
                    if self.cuckoo is not None:
                        entries = upload(self.cuckoo.entries(), dev)
                    elif self._host_lut is not None:
                        lut = upload(self._host_lut, dev)
                    self._table_bytes += sum(
                        t.numel() * t.element_size()
                        for t in (table, lut, entries) if t is not None
                    )
                self._gather_ops = (table, lut, entries)
            return self._gather_ops

    def _host_operands(self):
        """(table, lut, cuckoo entries) as CPU tensors: the ladder's host
        rung. Built at its first use; keeping them would double resident
        table memory for a path that normally never runs."""
        ops = self._host_ops
        if ops is not None:
            return ops
        with self._state_lock:
            if self._host_ops is None:
                cpu = torch.device("cpu")
                self._host_ops = (
                    upload(self._host_weights, cpu),
                    None if self._host_lut is None else upload(self._host_lut, cpu),
                    None if self.cuckoo is None else upload(self.cuckoo.entries(), cpu),
                )
            return self._host_ops

    def _gather_scores_on(self, operands, batch, lengths, window_limit) -> torch.Tensor:
        """The gather scorer (cuckoo, LUT or dense) over ``operands`` on
        their device: the ladder's escape hatch, exact for every profile
        form, so degraded results are bit-identical to ``strategy='gather'``."""
        table, lut, entries = operands
        block = min(self.block, 256)
        if self.cuckoo is not None:
            return score_ops.score_batch_cuckoo(
                batch, lengths, table, entries,
                seed1=self.cuckoo.seed1, seed2=self.cuckoo.seed2, spec=self.spec,
                block=block, window_limit=window_limit,
            )
        return score_ops.score_batch(
            batch, lengths, table, lut, spec=self.spec, block=block,
            window_limit=window_limit,
        )

    def _window_scores_on(self, operands, batch, lengths, window_limit, cell) -> torch.Tensor:
        """The gather cell scorer over ``operands`` on their device."""
        table, lut, entries = operands
        if self.cuckoo is not None:
            return score_ops.window_scores_batch_cuckoo(
                batch, lengths, table, entries,
                seed1=self.cuckoo.seed1, seed2=self.cuckoo.seed2, spec=self.spec,
                cell=cell, block=min(self.block, 1024), window_limit=window_limit,
            )
        return score_ops.window_scores_batch(
            batch, lengths, table, lut, spec=self.spec, cell=cell,
            block=min(self.block, 1024), window_limit=window_limit,
        )

    def _window_scores_device(self, batch, lengths, window_limit, cell) -> torch.Tensor:
        """Gather-formulation per-cell scorer: segment mode's exactness
        oracle, and the route of every non-fused strategy (the bigram and
        row-histogram kernels have no per-cell form)."""
        return self._window_scores_on(
            self._gather_operands(), batch, lengths, window_limit, cell
        )

    def _gather_escape(self, batch, lengths, window_limit) -> torch.Tensor:
        """The ladder's device rung: the gather scorer on the runner's
        device over the profile's f32 weights, whatever the strategy. Only
        a kernel strategy takes it, so only on the CPU
        (:meth:`_ladder_allowed`)."""
        return self._gather_scores_on(self._gather_operands(), batch, lengths, window_limit)

    def _host_scores(self, batch, lengths, window_limit) -> torch.Tensor:
        """The ladder's last rung: the same gather scorer on CPU tensors."""
        return self._gather_scores_on(self._host_operands(), batch, lengths, window_limit)

    def _host_window_scores(self, batch, lengths, window_limit, cell) -> torch.Tensor:
        """The segment ladder's last rung: the gather cell scorer on CPU
        tensors."""
        return self._window_scores_on(self._host_operands(), batch, lengths, window_limit, cell)

    def _segment_dispatch_device(self, batch, lengths, window_limit, cell) -> torch.Tensor:
        """One packed batch → f32 [B, ceil(pad_to / cell), L] raw cell
        scores: the fused-segment kernel for a fused runner, the gather cell
        scorer for every other strategy. Fault site ``score/dispatch``."""
        faults.inject("score/dispatch")
        if self.strategy == "fused":
            return score_fused.segment_batch_fused(
                batch, lengths, self.table, self.scales, self.table_lut, window_limit,
                spec=self.spec, layout=self.layout, cell=cell,
            )
        cells = self._window_scores_device(batch, lengths, window_limit, cell)
        if self._striped:
            cells = self.mesh.psum(cells, "vocab")
        return cells

    def _dispatch_device(self, batch, lengths, window_limit, labels: bool = False):
        """One batch on the device through the strategy: f32 [B, L] scores,
        or int32 [B] labels when ``labels``. Fault site ``score/dispatch``
        (the padded and ragged forms; the wire form's site is
        ``score/pack``, as in the JAX runner)."""
        faults.inject("score/dispatch")
        return self._strategy_dispatch(batch, lengths, window_limit, labels)

    def _strategy_dispatch(self, batch, lengths, window_limit, labels: bool):
        if labels:
            return self._labels(batch, lengths, window_limit)
        return self._scores(batch, lengths, window_limit)

    def _labels(self, batch, lengths, window_limit) -> torch.Tensor:
        if self.strategy == "fused":
            labels, _ = score_fused.detect_batch_fused(
                batch, lengths, self.table, self.scales, self.table_lut, window_limit,
                spec=self.spec, layout=self.layout,
            )
            return labels
        return score_ops.argmax_language(self._scores(batch, lengths, window_limit))

    # -- public API -----------------------------------------------------------
    def score(self, byte_docs) -> np.ndarray:
        """float32 [N, L] scores in input order (exact over any doc length).
        ``byte_docs`` is a sequence of ``bytes`` or a
        :class:`~..ops.encode_device.DocBlock` (one byte plane + offsets,
        the all-unique lane: no per-document Python objects, the raw wire
        form, the padded batch rebuilt on the card)."""
        return self._execute(byte_docs, want_labels=False)

    def predict_ids(self, byte_docs) -> np.ndarray:
        """int32 [N] argmax language indices in input order. The argmax runs
        on the device; only chunked documents fetch score rows, which are
        summed across chunks before their argmax."""
        return self._execute(byte_docs, want_labels=True)

    def predict(self, byte_docs: Sequence[bytes], languages: Sequence[str]) -> list[str]:
        return [languages[i] for i in self.predict_ids(byte_docs)]

    def scored_docs(self, byte_docs: Sequence[bytes]) -> list[bytes]:
        """The documents as scored: cut to ``max_score_bytes`` where set
        (UTF-8 documents at a character boundary)."""
        cap = self.max_score_bytes
        if not cap:
            return list(byte_docs)
        if self.score_encoding == UTF8:
            return [truncate_utf8(d, cap) for d in byte_docs]
        return [d[:cap] for d in byte_docs]

    # -- host side of one batch --------------------------------------------------
    def _limit_np(self, limits: np.ndarray) -> np.ndarray | None:
        """int32 window limits of a batch, or None when no chunk of it is
        limited (the common case: one fewer copy)."""
        if bool((limits == self.max_chunk).all()):
            return None
        return limits.astype(np.int32)

    def _fetch(self, tensors, started=None) -> tuple:
        """Host numpy values of a batch's result tensors (None stays None):
        each from its started pinned copy (``started``, see
        :meth:`_start_fetches`) once the copy's event has synchronized, else
        a synchronous copy. Every result byte the runner pulls off the
        device goes through here (``score/fetch_bytes``): a label request
        fetches 4·B bytes of ids plus the chunked documents' few score rows,
        on every rung. On a mesh the tensors already hold the whole batch
        (the dispatch gathered it over the data axis), so every rank fetches
        every row."""
        out = []
        for t, h in zip(tensors, started or [None] * len(tensors)):
            host = None if t is None else host_numpy(h or copy_to_host_async(t))
            if host is not None:
                REGISTRY.incr("score/fetch_bytes", int(host.nbytes))
            out.append(host)
        return tuple(out)

    @staticmethod
    def _start_fetches(tensors):
        """Start each tensor's copy to pinned host memory (None stays None).
        A copy that cannot start (an error surfacing early) is left to the
        fetch loop, which replays it under the policy."""
        out = []
        for t in tensors:
            try:
                out.append(None if t is None else copy_to_host_async(t))
            except Exception:
                out.append(None)
        return out

    def _fence(self, t) -> None:
        """Wait for the device work queued so far (a ladder rung counts as
        a success only once its scores exist, so a deferred error surfaces
        inside the ladder and not in the caller's fetch loop)."""
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()

    # -- degraded-mode fallback --------------------------------------------------
    def _ladder_allowed(self, segment: bool = False) -> bool:
        """Whether a failed batch may fall down the degradation ladder:
        ``degraded_fallback`` is on, and the path launches no CUDA kernel.
        On the card every strategy but ``gather`` launches one (in segment
        mode only ``fused`` does); there a failure replays under the policy
        and then raises, so a kernel that cannot build, load or run is never
        replaced by the gather scorer or the CPU."""
        if not self.degraded_fallback:
            return False
        if self.device.type != "cuda":
            return True
        return self.strategy != "fused" if segment else self.strategy == "gather"

    def _degrade(self, level: str, rows: int, pad_to: int, cause, **extra) -> None:
        self._degraded_mode = True
        self.metrics.incr("degraded_batches")
        REGISTRY.incr("resilience/degraded_batches")
        REGISTRY.incr(f"resilience/degraded_{level}")
        REGISTRY.set_gauge("langdetect_degraded", 1.0)
        log_event(
            _log, "runner.degraded", level=level, rows=rows, pad_to=pad_to,
            breaker=self.breaker.state,
            cause=repr(cause) if cause is not None else None, **extra,
        )

    def _recovered(self) -> None:
        """A fast-path success after degraded batches: once the breaker
        agrees the path is healthy, reset ``langdetect_degraded``."""
        if self._degraded_mode and self.breaker.state == CLOSED:
            self._degraded_mode = False
            REGISTRY.set_gauge("langdetect_degraded", 0.0)
            log_event(_log, "runner.degraded_recovered")

    def _ladder(self, batch_docs, batch_limits, pad_to: int, cause, device_rung, host_rung,
                **attrs):
        """Run one batch down the degradation ladder after the fast path
        failed (or while the breaker holds it open):

          1. ``gather`` — ``device_rung``, the gather scorer on the card
             over the profile's f32 weights (None where the fast path is
             that program already);
          2. ``host``   — ``host_rung``, the same scorer on CPU tensors.

        Each rung takes ``(batch, lengths, window_limit)`` tensors on its
        device. Each rung is fenced before it counts as a success; a
        retryable failure moves down a rung, anything else raises. Exact at
        every rung: degraded mode trades throughput, never correctness."""
        limit_np = self._limit_np(np.asarray(batch_limits))
        batch_np, lengths_np = native.pack_batch(batch_docs, pad_to)
        levels = ["host"] if device_rung is None else ["gather", "host"]
        last = cause
        for level in levels:
            try:
                with span(
                    "score/degraded", rows=len(batch_docs), pad_to=pad_to,
                    level=level, degraded=True, **attrs,
                ) as sp:
                    if level == "gather":
                        faults.inject("score/dispatch")
                        dev, rung = self.device, device_rung
                    else:
                        dev, rung = torch.device("cpu"), host_rung
                    out = rung(
                        torch.from_numpy(batch_np).to(dev),
                        torch.from_numpy(lengths_np).to(dev),
                        None if limit_np is None else torch.from_numpy(limit_np).to(dev),
                    )
                    self._fence(out)
                    sp.fence(out)
            except Exception as e:
                if not self.retry_policy.classify(e):
                    raise
                last = e
                continue
            self._degrade(level, len(batch_docs), pad_to, cause, **attrs)
            return out
        raise last if last is not None else RuntimeError(
            "degraded ladder exhausted with no recorded cause"
        )

    # -- whole-document execution ----------------------------------------------
    def _execute(self, byte_docs, *, want_labels: bool):
        # Flight-recorder hook: a raising call dumps the recent telemetry
        # ring (when LANGDETECT_FLIGHT_RECORDER armed it) before propagating.
        try:
            # One request trace per call (an ambient one is joined); every
            # span of the call, the dispatch workers' included, stamps its id.
            with trace_request():
                return self._execute_traced(byte_docs, want_labels=want_labels)
        except Exception as e:
            flightrec.record_crash("score", e)
            raise

    def _execute_traced(self, byte_docs, *, want_labels: bool):
        # Host work of the call before the ``score`` span: truncation,
        # dedup, chunking, the plan and the chunk ranks.
        with span("runner/prepare", docs=len(byte_docs)) as prep:
            w = self._prepare(byte_docs, want_labels)
            L = self.num_langs
            out = np.zeros(w.n, dtype=np.int32) if want_labels else np.zeros((w.n, L), dtype=np.float32)
            if w.n == 0:
                return out
            chunk_acc = None
            if w.chunked is not None:
                chunk_acc = np.zeros((len(w.chunk_rank), L), dtype=np.float32)
            prep.set(unique=w.n, chunks=len(w.doc_idx), batches=len(w.plan))
        wire = self.device_encode or w.block is not None
        # The wire form's fault site is ``score/pack``, the others'
        # ``score/dispatch`` (:meth:`_dispatch_device`), as in the JAX runner.
        dispatch = self._strategy_dispatch if wire else self._dispatch_device

        def build(sel, pad_to):
            """Pack, copy and dispatch one planned batch: labels straight
            from the device when no row is a chunk (the fused kernel's
            in-kernel argmax), else scores. Re-invocable: scoring is
            stateless, so a replay packs the batch again."""
            labels = want_labels and w.chunk_pos(sel).size == 0
            if w.block is not None:
                docs = Spans(w.block.flat, w.chunk_starts[sel], w.chunk_lens[sel])
            else:
                docs = [w.chunks[k] for k in sel]
            return self._pack_dispatch(
                docs, pad_to, self._limit_np(w.limits[sel]),
                lambda batch, lengths, limit: dispatch(batch, lengths, limit, labels),
                parent=score_span, wire=wire, ragged=self.mesh is None,
            )

        def project(sel, result):
            """A batch's device result → (tensors to fetch, chunk positions):
            in label mode ((argmax ids [rows], chunk-row scores or None),
            positions of the chunk rows); else ((scores,), None). A ladder
            rung always returns scores."""
            if not want_labels:
                return (result,), None
            if result.dim() == 1:
                return (result, None), _NO_POS
            pos = w.chunk_pos(sel)
            am = score_ops.argmax_language(result)
            sub = result[upload(pos, result.device)] if pos.size else None
            return (am, sub), pos

        def degraded(sel, pad_to, cause):
            # A kernel strategy (fused, pallas, hybrid, hist; on the CPU,
            # their plain versions) falls to the device gather first,
            # ``gather`` straight to the host.
            return self._ladder(
                w.docs(sel), w.limits[sel], pad_to, cause,
                None if self.strategy == "gather" else self._gather_escape, self._host_scores,
            )

        def scatter(sel, fetched, pos):
            if not want_labels:
                np.add.at(out, w.doc_idx[sel], fetched[0][: len(sel)])
                return
            am_host, sub_host = fetched
            whole = np.ones(len(sel), dtype=bool)
            if pos.size:
                whole[pos] = False
                rows = [w.chunk_rank[int(w.doc_idx[sel[p]])] for p in pos]
                np.add.at(chunk_acc, rows, sub_host)
            out[w.doc_idx[sel][whole]] = am_host[: len(sel)][whole]

        with trace(label="score"), span(
            "score", docs=w.n_in, unique=w.n, batches=len(w.plan), strategy=self.strategy,
            strategy_reason=getattr(self, "strategy_reason", "explicit"),
        ) as score_span:
            retries = self._run_plan(
                w.plan, build, project, degraded, scatter,
                ladder=self._ladder_allowed() and not self._multiproc,
            )

        # Host work of the call after ``score``: the chunked documents'
        # argmax, the dedup scatter-back and the call's bookkeeping.
        with span("runner/finish", docs=w.n_in):
            if chunk_acc is not None:
                for i, r in w.chunk_rank.items():
                    out[i] = int(np.argmax(chunk_acc[r]))
            if w.inverse is not None:
                # Deterministic scatter-back: every duplicate reads its unique
                # row's result — bit-exact against an undeduped call on
                # geometry-stable strategies (gather, fused), the reduction-
                # order class on the matmul ones (hist, hybrid, pallas).
                out = out[w.inverse]
            self.metrics.incr("docs_scored", w.n_in)
            REGISTRY.observe("score/retries_per_call", retries)
            log_event(
                _log, "runner.score", docs=w.n_in, unique=w.n, chunks=len(w.doc_idx),
                batches=len(w.plan), trace_id=current_trace_id(),
            )
            if w.plan and not self._cost_recorded:
                self._start_cost_thread(len(w.plan[0][0]), w.plan[0][1])
        return out

    def _unique_docs(self, byte_docs) -> tuple[list[bytes], np.ndarray | None]:
        """The documents as scored (:meth:`scored_docs`), each once, and the
        ``inverse`` that gives every duplicate its unique row's result (None
        when dedup is off or finds none). Dedup keys on the truncated bytes
        the kernel would see."""
        docs = self.scored_docs(byte_docs)
        if self.dedup and len(docs) > 1:
            d = dedup_counted(docs)
            if d is not None:
                first_idx, inverse, _ = d
                return [docs[int(i)] for i in first_idx], inverse
        return docs, None

    def _prepare(self, byte_docs, want_labels: bool) -> _Work:
        """One whole-document call's work items, truncated, deduplicated,
        chunked and planned. A ``DocBlock`` is the all-unique lane: content
        dedup would re-materialize per-document bytes just to key on them."""
        block = byte_docs if isinstance(byte_docs, DocBlock) else None
        if block is not None and self.mesh is not None:
            # A mesh shards padded rows: block inputs materialize (exact,
            # not zero-copy), as in JAX.
            byte_docs, block = [block.doc(i) for i in range(len(block))], None
        w = _Work(n_in=len(byte_docs), block=block)
        max_chunk = self.max_chunk
        overlap = max(self.spec.gram_lengths) - 1
        if block is not None:
            doc_starts, doc_lens = block.starts(), block.lengths()
            if self.max_score_bytes:
                cap = self.max_score_bytes
                if self.score_encoding == UTF8:
                    doc_lens = utf8_safe_lengths(block.flat, doc_starts, doc_lens, cap)
                else:
                    doc_lens = np.minimum(doc_lens, cap)
            w.n = len(block)
            if w.n == 0:
                return w
            w.doc_idx, w.chunk_starts, w.chunk_lens, w.limits = chunk_table(
                doc_starts, doc_lens, max_chunk, overlap
            )
            sizes = w.chunk_lens
            chunked_docs = np.flatnonzero(doc_lens > max_chunk).tolist()
        else:
            docs, w.inverse = self._unique_docs(byte_docs)
            w.n = len(docs)
            if w.n == 0:
                return w
            stride = max_chunk - overlap
            doc_idx: list[int] = []
            chunks: list[bytes] = []
            limits: list[int] = []
            chunked_docs = []
            for i, doc in enumerate(docs):
                if len(doc) <= max_chunk:
                    doc_idx.append(i)
                    chunks.append(doc)
                    limits.append(max_chunk)  # no-op limit
                    continue
                chunked_docs.append(i)
                parts = chunk_document(doc, max_chunk, overlap)
                for j, part in enumerate(parts):
                    doc_idx.append(i)
                    chunks.append(part)
                    limits.append(stride if j < len(parts) - 1 else max_chunk)
            w.chunks = chunks
            w.doc_idx = np.asarray(doc_idx, dtype=np.int64)
            w.limits = np.asarray(limits, dtype=np.int64)
            sizes = [len(c) for c in chunks]
        w.plan = self.plan(sizes)
        # The chunk-length distribution at 64-byte granularity (the JAX
        # package's tuner reads it): after truncation and chunking, the
        # population the lattice pads.
        edges = np.minimum(
            -(-np.maximum(np.asarray(sizes, dtype=np.int64), 1) // 64) * 64, max_chunk
        )
        for edge, cnt in zip(*np.unique(edges, return_counts=True)):
            REGISTRY.incr(f"exec/len/{int(edge)}", int(cnt))
        # Chunked documents (longer than max_chunk) need their full score
        # rows fetched and summed across chunks before the argmax; in label
        # mode every other document fetches one int32.
        w.chunk_rank = {i: r for r, i in enumerate(chunked_docs)}
        if want_labels and chunked_docs:
            w.chunked = np.isin(w.doc_idx, np.asarray(chunked_docs, dtype=np.int64))
        return w

    def _pack_dispatch(self, docs, pad_to: int, limit_np, run, *, parent, wire: bool = False,
                       ragged: bool = False, segment: bool = False):
        """One batch packed in its wire format (:class:`~..exec.pack.Batch`)
        under ``score/pack``; copied, rebuilt and run as ``run(batch,
        lengths, window_limit)`` under ``score/dispatch``. On a mesh this
        rank packs its shard and the result is gathered over the data axis.
        Segment batches count no fill and tag no ``shards``, as before."""
        b = Batch(docs, pad_to, {"limit": (limit_np, self.max_chunk)}, wire=wire,
                  ragged=ragged, mesh=self.mesh)
        attrs = {"wire": True} if wire else {}
        with span("score/pack", parent=parent, rows=b.rows, pad_to=pad_to, **attrs):
            if wire:
                faults.inject("score/pack")
            st = self._staging.take(b.fields)
            with st:
                b.fill(st.views)
        if not segment:
            # Counted once the pack succeeded, so a replay after a failed
            # wire build never counts its bytes twice. The window limits
            # count in the wire form's bytes only, as in the JAX runner.
            REGISTRY.observe("score/batch_fill_ratio", b.fill_ratio)
            REGISTRY.observe("score/padding_waste", 1.0 - b.fill_ratio)
            REGISTRY.incr("score/real_bytes", b.real_bytes)
            REGISTRY.incr("score/capacity_bytes", b.capacity)
            REGISTRY.incr("score/wire_bytes", b.nbytes if wire else b.capacity + b.index_bytes)
            REGISTRY.incr("score/wire_docs", b.rows)
            if wire:
                REGISTRY.incr("score/encoded_batches")
            if self.mesh is not None:
                attrs["shards"] = self._ndata
        with span("score/dispatch", parent=parent, rows=b.rows, pad_to=pad_to, **attrs) as sp:
            dev = st.to_device()
            batch, lengths = b.rebuild(dev)
            result = run(batch, lengths, dev.get("limit"))
            if self.mesh is not None:
                result = self.mesh.all_gather(result, "data")
            sp.fence(result)
        return result

    def _run_plan(self, plan, build, project, degraded, scatter, *, ladder: bool,
                  segment: bool = False) -> int:
        """Run one call's planned batches; returns the call's retries.

        ``build(sel, pad_to)`` runs on the dispatch workers (one on a mesh,
        so every rank's collectives keep one order) under
        ``guarded_dispatch``, with ``degraded(sel, pad_to, cause)`` as the
        ladder where ``ladder``; ``project(sel, result)`` gives (tensors to
        fetch, positions). Every copy to pinned memory starts before the
        first fetch; a failed fetch replays its batch under the policy,
        then takes the ladder where allowed. The host arrays go to
        ``scatter(sel, fetched, positions)`` in plan order. Segment calls
        keep what they had: logs that say ``segment``, and no batch
        latency, no gauge reset on recovery, no finiteness check and no
        ``score/fetch`` fault in a replay."""
        retries: list[int] = []

        def on_retry(attempt_no, delay_s, exc):
            # RetryPolicy.run logs the attempt itself. A list append is
            # atomic under the GIL, so dispatch workers need no extra lock.
            self.metrics.incr("retries")
            REGISTRY.incr("score/retries")
            retries.append(1)

        def run_one(item):
            sel, pad_to = item
            t0 = time.perf_counter()
            result = guarded_dispatch(
                lambda: build(sel, pad_to),
                policy=self.retry_policy,
                site="score/dispatch",
                breaker=self.breaker if ladder else None,
                degraded=(lambda cause: degraded(sel, pad_to, cause)) if ladder else None,
                on_retry=on_retry,
                on_recovered=None if segment else self._recovered,
                log_fields={"rows": len(sel), "segment": True} if segment else {"rows": len(sel)},
            )
            if not segment:
                REGISTRY.observe("score/batch_latency_s", time.perf_counter() - t0)
            return sel, pad_to, project(sel, result)

        workers = DISPATCH_WORKERS if self.dispatch_workers is None else self.dispatch_workers
        pending = run_ordered(plan, run_one, 1 if self.mesh is not None else workers)
        with span("score/fetch", batches=len(plan)):
            started = [self._start_fetches(tensors) for _, _, (tensors, _) in pending]
            for (sel, pad_to, (tensors, pos)), handles in zip(pending, started):
                try:
                    faults.inject("score/fetch")
                    if not segment:
                        check_finite(tensors, "fetched score batch")
                    fetched = self._fetch(tensors, handles)
                except Exception as e:
                    if not self.retry_policy.classify(e):
                        raise

                    def replay(sel=sel, pad_to=pad_to):
                        if not segment:
                            faults.inject("score/fetch")
                        got, got_pos = project(sel, build(sel, pad_to))
                        return self._fetch(got), got_pos

                    try:
                        fetched, pos = self.retry_policy.run(
                            replay, site="score/fetch", breaker=self.breaker,
                            on_retry=on_retry, initial_error=e,
                            log_fields={"rows": len(sel)},
                        )
                    except Exception as e2:
                        if not ladder or not self.retry_policy.classify(e2):
                            raise
                        got, pos = project(sel, degraded(sel, pad_to, e2))
                        fetched = self._fetch(got)
                scatter(sel, fetched, pos)
        return len(retries)

    def _start_cost_thread(self, rows: int, pad_to: int) -> None:
        """The roofline cost gauges, once per runner, at the shape of the
        first batch it ran, off the dispatch path. Join ``_cost_thread`` to
        wait for them; a failure is kept in ``_cost_error`` and logged. The
        thread is shielded from fault plans, so it consumes no call of one,
        and non-daemon, so interpreter exit waits for it. It holds the
        runner weakly: a runner released before the thread ran (a zoo
        page-out) frees its device tables at once."""
        self._cost_recorded = True
        ref = weakref.ref(self)

        def record():
            from ..telemetry import cost

            runner = ref()
            if runner is None:
                return
            try:
                with faults.shield():
                    cost.record_runner_cost(runner, rows, pad_to)
            except Exception as e:
                runner._cost_error = e.with_traceback(None)
                log_event(_log, "runner.cost_gauges_failed", error=repr(e))

        self._cost_thread = threading.Thread(
            target=record, name="runner-cost-gauges", daemon=False
        )
        self._cost_thread.start()

    # -- segmentation (per-cell) path -------------------------------------------
    def segment_cells(
        self, byte_docs: Sequence[bytes], *, cell: int | None = None
    ) -> tuple[list[np.ndarray], list[bytes]]:
        """Raw per-cell scores for span-level decoding.

        Returns ``(cells, scored_docs)``: ``cells[i]`` is float32
        ``[C_i, L]`` with ``C_i = max(1, ceil(len_i / cell))``; entry ``[c]``
        sums every window (every gram length) whose start byte lies in
        ``[c·cell, (c+1)·cell)`` of the document. ``scored_docs[i]`` is the
        byte string the cells describe (the input after ``max_score_bytes``
        truncation), so the host span decoder snaps boundaries on the
        content that was scored.

        Long documents chunk on a cell-aligned stride (the whole-doc path's
        overlap rule rounded so that chunk ownership boundaries land on cell
        boundaries), so every global cell is owned by exactly one chunk and
        the assembled cells are exact. Duplicates are dedup'd, batches
        dispatch under the retry policy and the breaker, and a failure
        rides the ladder (fused → device gather cells → host gather cells),
        exact at every rung. Cells past a batch's longest owned range are
        padding and are not copied back (the JAX runner fetches them, so
        ``score/fetch_bytes`` counts less here in segment mode).
        """
        cell = int(cell or SEGMENT_CELL)
        if cell < 128 or cell % 128:
            raise ValueError(
                f"segment cell must be a positive multiple of 128, got {cell}"
            )
        if cell > self.max_chunk:
            raise ValueError(
                f"segment cell {cell} exceeds the largest length bucket "
                f"{self.max_chunk}"
            )
        try:
            return self._segment_traced(byte_docs, cell)
        except Exception as e:
            flightrec.record_crash("segment", e)
            raise

    def _segment_traced(self, byte_docs, cell: int):
        N_in = len(byte_docs)
        byte_docs, inverse = self._unique_docs(byte_docs)
        L = self.num_langs
        out: list[np.ndarray] = []
        if not byte_docs:
            return [], []

        overlap = max(self.spec.gram_lengths) - 1
        # Cell-aligned chunk stride: ownership boundaries must land on cell
        # edges so each global cell belongs to exactly one chunk.
        stride = ((self.max_chunk - overlap) // cell) * cell

        # Work items: (doc index, chunk bytes, window limit, global cell
        # offset, owned cell count).
        doc_idx: list[int] = []
        chunks: list[bytes] = []
        limits: list[int] = []
        cell_offs: list[int] = []
        takes: list[int] = []
        for i, doc in enumerate(byte_docs):
            n_cells = max(1, -(-len(doc) // cell))
            out.append(np.zeros((n_cells, L), dtype=np.float32))
            if len(doc) <= self.max_chunk:
                doc_idx.append(i)
                chunks.append(doc)
                limits.append(self.max_chunk)
                cell_offs.append(0)
                takes.append(n_cells)
                continue
            if stride < cell:
                # Only a document that needs chunking needs the stride;
                # single-chunk documents segment even when max_chunk leaves
                # no room for one.
                raise ValueError(
                    f"document of {len(doc)} bytes needs chunking, but "
                    f"segment cell {cell} leaves no cell-aligned chunk "
                    f"stride under max_chunk {self.max_chunk} "
                    f"(overlap {overlap})"
                )
            parts = chunk_document(doc, stride + overlap, overlap)
            for j, part in enumerate(parts):
                doc_idx.append(i)
                chunks.append(part)
                off = j * stride // cell
                cell_offs.append(off)
                if j < len(parts) - 1:
                    limits.append(stride)
                    takes.append(stride // cell)
                else:
                    limits.append(self.max_chunk)
                    takes.append(n_cells - off)
        limits_arr = np.asarray(limits, dtype=np.int64)
        plan = self.plan([len(c) for c in chunks])

        def owned(sel, cells):
            # Cells past the longest owned range of the batch are padding.
            return cells[:, : max(takes[k] for k in sel)]

        def build(sel, pad_to):
            return owned(sel, self._pack_dispatch(
                [chunks[k] for k in sel], pad_to, self._limit_np(limits_arr[sel]),
                lambda batch, lengths, limit: self._segment_dispatch_device(
                    batch, lengths, limit, cell
                ),
                parent=seg_span, segment=True,
            ))

        def degraded(sel, pad_to, cause):
            # Only a fused runner has another device program to fall back
            # from: every other strategy's segment dispatch is the gather
            # cell scorer already.
            return owned(sel, self._ladder(
                [chunks[k] for k in sel], limits_arr[sel], pad_to, cause,
                (lambda b, ln, lim: self._window_scores_device(b, ln, lim, cell))
                if self.strategy == "fused" else None,
                lambda b, ln, lim: self._host_window_scores(b, ln, lim, cell), segment=True,
            ))

        def scatter(sel, fetched, pos):
            host = fetched[0]
            for r, k in enumerate(sel):
                off, take = cell_offs[k], takes[k]
                out[doc_idx[k]][off : off + take] = host[r, :take]

        with trace_request(), span(
            "score", docs=N_in, unique=len(byte_docs), batches=len(plan),
            strategy=self.strategy, segment=True, cell=cell,
        ) as seg_span:
            self._run_plan(
                plan, build, lambda sel, cells: ((cells,), None), degraded, scatter,
                ladder=self._ladder_allowed(segment=True) and not self._multiproc,
                segment=True,
            )

        self.metrics.incr("docs_scored", N_in)
        log_event(
            _log, "runner.segment", docs=N_in, unique=len(byte_docs),
            chunks=len(chunks), batches=len(plan), cell=cell,
        )
        if inverse is not None:
            return [out[int(j)] for j in inverse], [byte_docs[int(j)] for j in inverse]
        return out, list(byte_docs)
