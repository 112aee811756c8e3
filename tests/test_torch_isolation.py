"""The port stands alone: no JAX, no JAX package, no quiet CPU fall-back.

* A subprocess fits and transforms with ``device="cpu"`` (an exact n = 1..3
  model through the fused path and an exact n = 1..5 model through the
  hybrid path) and then finds neither ``jax`` nor
  ``spark_languagedetector_tpu`` in ``sys.modules``.
* A second subprocess, in which ``jax`` and the JAX package cannot be
  imported at all, calibrates a model and transforms in segment mode, fits
  with ``fitBackend="device"``, saves and loads the model and a pipeline
  (whose metadata names the JAX package's classes, as data) and transforms.
* A third subprocess, with ``jax`` unimportable as well, transforms through
  the execution layer: the ragged form, dedup, two dispatch workers and a
  fault plan (a dispatch fault replayed, a fetch fault replayed, a wire
  build fault down the ladder), and maps no packer library of the JAX
  package (its own comes from ``build/native/``).
* A fourth, with ``jax`` unimportable, serves a saved model over HTTP on
  the CPU (``ModelRegistry``, ``ServingServer``, ``ServeClient``): labels
  and a segment result.
* A fifth, with ``jax`` unimportable, streams through ``run_stream`` under
  a fault plan with a dead-letter queue, a checkpoint and four workers, and
  runs the auto-refit loop (accumulator, fit-state checkpoint, kill,
  resume, hot swap through the registry) with a metrics sink armed.
* A sixth, with ``jax`` unimportable, runs a three-replica fleet behind the
  router's HTTP front (a kill and failover, a quarantined query of death, a
  fleet swap and rollback, the collector's scrape) and a model zoo of
  tenants saved on disk behind the HTTP server (an eviction, a cold
  reload).
* A seventh, with ``jax`` unimportable, writes a capture from a traced,
  cost-gauged transform and a segment transform, runs the four CLIs on it
  as ``__main__`` (``telemetry.report``, ``telemetry.compare``,
  ``telemetry.stitch``, ``exec.tune``), loads the tuned profile into a
  runner, and fronts a fleet with ``RouterServer(slo=)``.
* An AST scan finds no import of either anywhere in the port, ``segment/``,
  ``serve/router.py``, ``serve/fleet.py``, ``serve/quarantine.py``,
  ``zoo/``, the telemetry read side (``report``, ``compare``, ``stitch``,
  ``slo``), ``gauges``, ``cost``, ``utils/profiling.py`` and
  ``exec/tune.py`` included, nor in ``chip_smoke.py``, and no
  ``importlib`` in the port's pipeline loader, which looks stage classes up
  in a fixed table.
* An eighth, with ``jax`` unimportable, bakes and maps a model, prewarms
  through the kernel build cache, and supervises two replica children that
  cannot import ``jax`` either.
* A ninth, with ``jax`` unimportable, runs a device fit on two gloo ranks
  (the mesh test's rank pool, whose ranks cannot import ``jax`` either),
  bit-identical to the host fit, and the contract checker's CLI.
* The AST scan covers ``parallel/``, ``analysis/`` and the tests' rank
  worker (``tests/_torch_*.py``) too.
* With no device given and no CUDA card, the entry points raise, the
  serving ones (``ModelRegistry.load``, ``python -m
  spark_languagedetector_tpu_torch.serve.server``, ``ServeFleet.from_path``
  and a zoo tenant's cold load, which sheds that tenant) included.
"""

import ast
import os
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
        exact5 = det.copy({"gramLengths": [1, 2, 3, 4, 5], "vocabMode": "exact"})
        model5 = exact5.fit(Table({"lang": ["en", "de"] * 3,
                                   "fulltext": ["the cat", "der hund", "a dog",
                                                "die katze", "the end", "das ende"]}))
        out = model5.transform(Table({"fulltext": ["the dog", "der kater"]}))
        assert out.column("lang").tolist() == ["en", "de"], out.column("lang")
        assert model5.runner.strategy == "hybrid", model5.runner.strategy
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


def test_segment_mode_runs_with_jax_unimportable():
    script = textwrap.dedent(
        """
        import json, sys
        for name in ("jax", "jaxlib", "spark_languagedetector_tpu"):
            sys.modules[name] = None  # any import of it raises ImportError
        from spark_languagedetector_tpu_torch import LanguageDetector, Table
        table = Table({"lang": ["en", "de"] * 3,
                       "fulltext": ["the cat sat", "der hund lief", "a dog barks",
                                    "die katze schläft", "the end is near",
                                    "das ende ist nah"]})
        model = LanguageDetector(["en", "de"], [1, 2, 3], 50, device="cpu").fit(table)
        model.calibrate(table)
        seg = model.copy({"resultMode": "segment"})
        doc = "the dog barks " * 40 + "der hund und die katze " * 30
        out = seg.transform(Table({"fulltext": [doc, ""]})).column("lang").tolist()
        first = json.loads(out[0])
        assert first["calibrated"] and [s["lang"] for s in first["spans"]] == ["en", "de"], first
        assert first["spans"][0]["start"] == 0 and first["spans"][-1]["end"] == len(doc)
        assert json.loads(out[1])["spans"] == []
        assert seg.detect("der hund")["label"] == "de"

        import tempfile
        from spark_languagedetector_tpu_torch import (
            LanguageDetectorModel, LowerCasePreprocessor, Pipeline, PipelineModel)
        det = LanguageDetector(["en", "de"], [1, 2, 3, 4, 5], 50, device="cpu")
        for vocab in ("hashed", "exact"):
            dev_fit = det.copy({"fitBackend": "device", "vocabMode": vocab}).fit(table)
            host_fit = det.copy({"vocabMode": vocab}).fit(table)
            assert (dev_fit.profile.ids == host_fit.profile.ids).all()
            assert (dev_fit.profile.weights == host_fit.profile.weights).all()
        dev_fit.calibrate(table)
        out_dir = tempfile.mkdtemp()
        dev_fit.write().quantized("int16").save(out_dir + "/model")
        back = LanguageDetectorModel.load(out_dir + "/model", device="cpu")
        assert back.calibration.to_dict() == dev_fit.calibration.to_dict()
        probe = Table({"fulltext": ["the dog barks", "der hund"]})
        assert back.transform(probe).column("lang").tolist() == ["en", "de"]
        lower = LowerCasePreprocessor().set_input_col("fulltext")
        pipe = Pipeline([lower, det.copy({"fitBackend": "device"})])
        pipe.save(out_dir + "/pipe")
        pm = Pipeline.load(out_dir + "/pipe", device="cpu").fit(table)
        pm.stages[-1].set("outputCol", "detected")
        pm.save(out_dir + "/pm")
        loaded = PipelineModel.load(out_dir + "/pm", device="cpu")
        labeled = Table({"fulltext": ["THE DOG BARKS", "DER HUND"], "lang": ["en", "de"]})
        assert loaded.transform(labeled).column("detected").tolist() == ["en", "de"]
        meta = json.load(open(out_dir + "/pm/metadata/part-00000"))
        assert meta["class"] == "spark_languagedetector_tpu.api.pipeline.PipelineModel"
        bad = sorted(m for m, mod in sys.modules.items() if mod is not None
                     and m.split(".")[0] in ("jax", "jaxlib", "spark_languagedetector_tpu"))
        assert not bad, bad
        try:
            import jax
        except ImportError:
            print("isolated")
        """
    )
    res = subprocess.run(
        [sys.executable, "-c", script],
        cwd=PORT_DIR.parent, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("isolated")


def test_execution_layer_runs_with_jax_unimportable():
    script = textwrap.dedent(
        """
        import sys
        for name in ("jax", "jaxlib", "spark_languagedetector_tpu"):
            sys.modules[name] = None  # any import of it raises ImportError
        import numpy as np
        from spark_languagedetector_tpu_torch import LanguageDetector, Table, native
        from spark_languagedetector_tpu_torch.exec import pack as pack_mod
        from spark_languagedetector_tpu_torch.resilience import faults
        from spark_languagedetector_tpu_torch.resilience.faults import FaultPlan
        from spark_languagedetector_tpu_torch.telemetry import REGISTRY
        rng = np.random.default_rng(0)
        words = {"en": ["the", "dog", "and", "cat", "with"],
                 "de": ["der", "hund", "und", "katze", "mit"]}
        texts, labels = [], []
        for i in range(120):
            lang = ("en", "de")[i % 2]
            texts.append(" ".join(rng.choice(words[lang], int(rng.integers(3, 150)))))
            labels.append(lang)
        det = LanguageDetector(["en", "de"], [1, 2, 3], 50, device="cpu")
        model = det.fit(Table({"lang": labels, "fulltext": texts}))
        unpacks = []
        real = pack_mod.unpack_ragged
        pack_mod.unpack_ragged = lambda *a: unpacks.append(1) or real(*a)
        docs = texts + texts[:40]  # duplicates
        r = model.runner
        r.length_buckets, r.batch_size, r.dispatch_workers = (128, 2048), 64, 2
        r.retry_policy = type(r.retry_policy)(max_attempts=2, base_delay_s=0.0)
        want = model.transform(Table({"fulltext": docs})).column("lang").tolist()
        assert want == labels + labels[:40], want
        assert unpacks, "the ragged form never ran"
        counters = REGISTRY.snapshot()["counters"]
        assert counters["dedup/rows_in"] == 160 and counters["dedup/rows_unique"] == 120
        plan = "seed=1;score/dispatch:error@1;score/fetch:error@2;score/pack:error@1-9"
        with faults.plan_scope(FaultPlan.parse(plan)):
            got = model.transform(Table({"fulltext": docs})).column("lang").tolist()
            r.device_encode = True
            wire = model.transform(Table({"fulltext": docs})).column("lang").tolist()
        assert got == want and wire == want
        counters = REGISTRY.snapshot()["counters"]
        assert counters["score/retries"] >= 2 and counters["resilience/degraded_batches"] >= 1
        assert native.available()
        maps = open("/proc/self/maps").read()
        assert str(native.library_path()) in maps
        assert "spark_languagedetector_tpu/native" not in maps
        bad = sorted(m for m, mod in sys.modules.items() if mod is not None
                     and m.split(".")[0] in ("jax", "jaxlib", "spark_languagedetector_tpu"))
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


def test_serving_over_http_runs_with_jax_unimportable():
    script = textwrap.dedent(
        """
        import sys, tempfile
        for name in ("jax", "jaxlib", "spark_languagedetector_tpu"):
            sys.modules[name] = None  # any import of it raises ImportError
        from spark_languagedetector_tpu_torch import LanguageDetector, Table
        from spark_languagedetector_tpu_torch.serve import (
            ModelRegistry, ServeClient, ServingServer)
        table = Table({"lang": ["en", "de"] * 3,
                       "fulltext": ["the cat sat", "der hund lief", "a dog barks",
                                    "die katze schläft", "the end is near",
                                    "das ende ist nah"]})
        path = tempfile.mkdtemp() + "/model"
        LanguageDetector(["en", "de"], [1, 2, 3], 50, device="cpu").fit(table).save(path)
        registry = ModelRegistry(device="cpu")
        registry.load(path)
        with ServingServer(registry, port=0, max_wait_ms=2) as server:
            client = ServeClient(*server.address)
            labels, meta = client.detect(["the dog barks", "der hund"])
            assert labels == ["en", "de"] and meta["version"] == "v1", (labels, meta)
            results, _ = client.segment(["the dog barks " * 20])
            assert results[0]["label"] == "en", results
        bad = sorted(m for m, mod in sys.modules.items() if mod is not None
                     and m.split(".")[0] in ("jax", "jaxlib", "spark_languagedetector_tpu"))
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


def test_streaming_and_refit_run_with_jax_unimportable():
    script = textwrap.dedent(
        """
        import sys, tempfile
        for name in ("jax", "jaxlib", "spark_languagedetector_tpu"):
            sys.modules[name] = None  # any import of it raises ImportError
        from spark_languagedetector_tpu_torch import LanguageDetector, Table
        from spark_languagedetector_tpu_torch.resilience import DeadLetterQueue, faults
        from spark_languagedetector_tpu_torch.resilience.faults import FaultPlan
        from spark_languagedetector_tpu_torch.resilience.policy import RetryPolicy
        from spark_languagedetector_tpu_torch.serve import ModelRegistry
        from spark_languagedetector_tpu_torch.stream import AutoRefit, memory_source, run_stream
        from spark_languagedetector_tpu_torch.telemetry import REGISTRY
        from spark_languagedetector_tpu_torch.telemetry.export import JsonlSink
        out_dir = tempfile.mkdtemp()
        REGISTRY.add_sink(JsonlSink(out_dir + "/events.jsonl"))
        texts = ["the cat sat", "der hund lief", "a dog barks", "die katze schläft",
                 "the end is near", "das ende ist nah"] * 4
        labels = ["en", "de"] * 12
        det = LanguageDetector(["en", "de"], [1, 2, 3], 50, device="cpu").set_fit_backend("device")
        batches = [Table({"lang": labels[i:i + 6], "fulltext": texts[i:i + 6]})
                   for i in range(0, 24, 6)]
        registry = ModelRegistry(device="cpu")
        state = out_dir + "/state"
        AutoRefit(det, registry, state_path=state, final_refit=False).run(batches, max_batches=2)
        progress = AutoRefit(det, registry, state_path=state, refit_every_batches=1).run(batches)
        assert progress.resumed_from == 2 and progress.batches == 2, progress
        assert registry.peek().describe()["metadata"]["refit_token"] == 4
        model = registry.peek().model
        scratch = det.fit(Table({"lang": labels, "fulltext": texts}))
        assert (model.profile.ids == scratch.profile.ids).all()
        assert (model.profile.weights == scratch.profile.weights).all()
        rows = [{"fulltext": t} for t in texts]
        sunk, dlq = [], DeadLetterQueue()
        plan = "seed=7;stream/batch:error@2;score/dispatch:error@3;stream/batch:poison=1@2"
        with faults.plan_scope(FaultPlan.parse(plan)):
            q = run_stream(model, memory_source(rows, 4), lambda t: sunk.extend(t.column("lang")),
                           retry_policy=RetryPolicy(max_attempts=3, base_delay_s=0.0), dlq=dlq,
                           checkpoint_path=out_dir + "/ck.json", prefetch=6, workers=4)
        assert q.batches == 6 and len(dlq) == 1 and len(sunk) == 23, (q, len(dlq), len(sunk))
        REGISTRY.flush()
        assert "stream/batch" in open(out_dir + "/events.jsonl").read()
        bad = sorted(m for m, mod in sys.modules.items() if mod is not None
                     and m.split(".")[0] in ("jax", "jaxlib", "spark_languagedetector_tpu"))
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


def test_fleet_and_zoo_run_with_jax_unimportable():
    script = textwrap.dedent(
        """
        import sys, tempfile
        for name in ("jax", "jaxlib", "spark_languagedetector_tpu"):
            sys.modules[name] = None  # any import of it raises ImportError
        from spark_languagedetector_tpu_torch import LanguageDetector, Table
        from spark_languagedetector_tpu_torch.serve import (
            QuarantineTable, RouterServer, ServeClient, ServeFleet, ServeHTTPError,
            ServingServer)
        from spark_languagedetector_tpu_torch.telemetry import REGISTRY
        from spark_languagedetector_tpu_torch.telemetry.aggregate import FleetCollector
        from spark_languagedetector_tpu_torch.zoo import ModelZoo
        table = Table({"lang": ["en", "de"] * 3,
                       "fulltext": ["the cat sat", "der hund lief", "a dog barks",
                                    "die katze schläft", "the end is near",
                                    "das ende ist nah"]})
        root = tempfile.mkdtemp()
        for k, size in (("a", 50), ("b", 30), ("c", 40)):
            LanguageDetector(["en", "de"], [1, 2, 3], size, device="cpu").fit(table).save(
                f"{root}/{k}")
        fleet = ServeFleet.from_path(f"{root}/a", replicas=3, device="cpu", router_kw=dict(
            breaker_threshold=2, quarantine=QuarantineTable(2)), max_wait_ms=2)
        fleet.start(probe=False)
        collector = FleetCollector()
        with RouterServer(fleet.router, fleet=fleet, port=0, collector=collector) as front:
            client = ServeClient(*front.address)
            assert client.detect(["the dog barks", "der hund"])[0] == ["en", "de"]
            fleet.replica("r0").kill()
            labels, meta = client.detect(["a dog"])
            assert labels == ["en"] and meta["replica"] == "r1", meta
            client.detect(["a dog"])  # a second death: quarantined
            try:
                client.detect(["a dog"])
                raise AssertionError("not quarantined")
            except ServeHTTPError as e:
                assert e.status == 422 and e.payload["quarantined"], e
            assert client.swap(f"{root}/b") == "v2" and client.rollback() == "v1"
            assert collector.scrape("r1", ServeClient(*fleet.replica("r1").address).telemetryz)
        fleet.close()
        zoo = ModelZoo(device="cpu", resident_models=1, max_wait_ms=2)
        for k in "abc":
            zoo.add_tenant(f"t{k}", path=f"{root}/{k}")
        with ServingServer(zoo, port=0) as server:
            client = ServeClient(*server.address)
            for tenant in ("ta", "tb", "ta"):
                labels, meta = client.detect(["der hund"], tenant=tenant)
                assert labels == ["de"] and meta["tenant"] == tenant, meta
            assert list(zoo.resident()) == ["ta"]
        counters = REGISTRY.snapshot()["counters"]
        assert counters["zoo/evictions"] == 2 and counters["zoo/cold_loads"] == 3, counters
        bad = sorted(m for m, mod in sys.modules.items() if mod is not None
                     and m.split(".")[0] in ("jax", "jaxlib", "spark_languagedetector_tpu"))
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


def test_telemetry_clis_and_tuner_run_with_jax_unimportable(tmp_path):
    script = textwrap.dedent(
        f"""
        import json, os, runpy, sys
        for name in ("jax", "jaxlib", "spark_languagedetector_tpu"):
            sys.modules[name] = None  # any import of it raises ImportError
        from spark_languagedetector_tpu_torch import LanguageDetector, Table
        from spark_languagedetector_tpu_torch.telemetry import REGISTRY
        from spark_languagedetector_tpu_torch.telemetry.export import JsonlSink
        from spark_languagedetector_tpu_torch.telemetry.gauges import sample_device_gauges
        from spark_languagedetector_tpu_torch.telemetry.slo import SloEvaluator
        from spark_languagedetector_tpu_torch.utils.debug import nan_checks
        from spark_languagedetector_tpu_torch.utils.profiling import trace
        tmp = {str(tmp_path)!r}
        table = Table({{"lang": ["en", "de"] * 3,
                       "fulltext": ["the cat sat", "der hund lief", "a dog barks",
                                    "die katze schläft", "the end is near",
                                    "das ende ist nah"]}})
        cap = os.path.join(tmp, "cap.jsonl")
        sink = JsonlSink(cap)
        REGISTRY.add_sink(sink)
        model = LanguageDetector(["en", "de"], [1, 2, 3], 50, device="cpu").fit(table)
        with trace(os.path.join(tmp, "trace"), label="transform"), nan_checks():
            out = model.transform(Table({{"fulltext": ["the dog " * k for k in range(1, 90)]}}))
        assert set(out.column("lang").tolist()) == {{"en"}}
        model.copy({{"resultMode": "segment"}}).transform(Table({{"fulltext": ["der hund"]}}))
        model.runner._cost_thread.join()
        assert sample_device_gauges() == {{}}
        REGISTRY.flush()
        sink.close()

        def cli(module, *argv):
            sys.argv = [module, *argv]
            try:
                runpy.run_module(module, run_name="__main__")
            except SystemExit as e:
                return e.code
            return 0

        pkg = "spark_languagedetector_tpu_torch"
        assert cli(pkg + ".telemetry.report", cap) == 0
        assert cli(pkg + ".telemetry.compare", cap, cap) == 0
        assert cli(pkg + ".telemetry.stitch", cap, "-o", os.path.join(tmp, "s.json")) == 0
        prof = os.path.join(tmp, "profile.json")
        assert cli(pkg + ".exec.tune", cap, "-o", prof) == 0
        os.environ["LANGDETECT_TUNING_PROFILE"] = prof
        from spark_languagedetector_tpu_torch.exec import config
        config.reload_profile()
        tuned = model.copy()  # a copy builds its own runner
        assert tuned.runner.length_buckets == tuple(json.load(open(prof))["tuned"][
            "length_buckets"])
        from spark_languagedetector_tpu_torch.serve import RouterServer, ServeClient, ServeFleet
        fleet = ServeFleet([model] * 2, device="cpu", max_wait_ms=2).start(probe=False)
        slo = SloEvaluator()
        slo.ingest({{"counters": {{"fleet/requests": 10, "fleet/shed_requests": 0}}}}, now=0.0)
        with RouterServer(fleet.router, fleet=fleet, port=0, slo=slo) as front:
            assert ServeClient(*front.address).healthz()["slo"] == slo.status()
        fleet.close()
        bad = sorted(m for m, mod in sys.modules.items() if mod is not None
                     and m.split(".")[0] in ("jax", "jaxlib", "spark_languagedetector_tpu"))
        assert not bad, bad
        print("isolated")
        """
    )
    res = subprocess.run(
        [sys.executable, "-c", script],
        cwd=PORT_DIR.parent, capture_output=True, text=True, timeout=180,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip().endswith("isolated")


def test_cold_start_and_replica_children_run_with_jax_unimportable(tmp_path):
    """An eighth subprocess, with ``jax`` unimportable, bakes a model, maps
    it back, prewarms through the build cache, and supervises two replica
    children whose own interpreters cannot import ``jax`` either (a
    ``sitecustomize`` on their ``PYTHONPATH`` blocks it): both reach READY
    on the verified-warm cache and answer over HTTP."""
    blocker = tmp_path / "blocker"
    blocker.mkdir()
    (blocker / "sitecustomize.py").write_text(
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'spark_languagedetector_tpu'):\n"
        "    sys.modules[name] = None\n"
    )
    script = textwrap.dedent(
        f"""
        import os, sys
        for name in ("jax", "jaxlib", "spark_languagedetector_tpu"):
            sys.modules[name] = None  # any import of it raises ImportError
        from spark_languagedetector_tpu_torch import LanguageDetector, Table
        from spark_languagedetector_tpu_torch.artifacts import (
            artifact_path_for, bake_model, enable_compile_cache, maybe_load_baked,
            prewarm_lattice)
        from spark_languagedetector_tpu_torch.scale import ReplicaSupervisor
        from spark_languagedetector_tpu_torch.serve import ServeClient
        root = {str(tmp_path)!r}
        table = Table({{"lang": ["en", "de"] * 3,
                       "fulltext": ["the cat sat", "der hund lief", "a dog barks",
                                    "die katze schläft", "the end is near",
                                    "das ende ist nah"]}})
        model = LanguageDetector(["en", "de"], [1, 2, 3], 50, device="cpu").fit(table)
        model.save(f"{{root}}/m")
        bake_model(model, artifact_path_for(f"{{root}}/m"), quantize="int16")
        baked = maybe_load_baked(f"{{root}}/m", device="cpu")
        assert baked is not None and hasattr(baked, "_prebuilt_membership")
        docs = [b"the dog barks", b"der hund"]
        assert list(baked.runner.predict_ids(docs)) == [0, 1]
        cache = enable_compile_cache(f"{{root}}/cc")
        assert prewarm_lattice(baked.runner, cache_dir=cache)["mode"] == "full"
        sup = ReplicaSupervisor(
            f"{{root}}/m", device="cpu", pidfile_dir=f"{{root}}/pids", compile_cache_dir=cache,
            child_env={{"PYTHONPATH": {str(blocker)!r}}})
        try:
            first = sup.spawn("r0")
            second = sup.spawn("r1")
            # The manifest this process's full prewarm wrote serves both.
            for rep in (first, second):
                assert rep.last_prewarm_mode == "sentinel", rep.last_ready
            for rep in (first, second):
                labels, meta = ServeClient(*rep.address).detect(["the dog barks", "der hund"])
                assert labels == ["en", "de"] and meta["server"]["platform"] == "cpu", meta
        finally:
            sup.close()
        bad = sorted(m for m, mod in sys.modules.items() if mod is not None
                     and m.split(".")[0] in ("jax", "jaxlib", "spark_languagedetector_tpu"))
        assert not bad, bad
        print("isolated")
        """
    )
    res = subprocess.run(
        [sys.executable, "-c", script],
        cwd=PORT_DIR.parent, capture_output=True, text=True, timeout=180,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip().endswith("isolated")


def test_mesh_fit_and_checker_run_with_jax_unimportable(tmp_path):
    """A ninth subprocess, with ``jax`` unimportable, fits on two gloo ranks
    whose interpreters cannot import it either (a ``sitecustomize`` on
    their ``PYTHONPATH``), bit-identical to the host fit, and runs the
    contract checker's CLI on the shipped tree: exit 0."""
    blocker = tmp_path / "blocker"
    blocker.mkdir()
    (blocker / "sitecustomize.py").write_text(
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'spark_languagedetector_tpu'):\n"
        "    sys.modules[name] = None\n"
    )
    script = textwrap.dedent(
        f"""
        import json, os, subprocess, sys
        for name in ("jax", "jaxlib", "spark_languagedetector_tpu"):
            sys.modules[name] = None  # any import of it raises ImportError
        import numpy as np
        from spark_languagedetector_tpu_torch.ops.fit import fit_profile_numpy
        from spark_languagedetector_tpu_torch.ops.vocab import VocabSpec
        from tests._torch_mesh_worker import RankPool
        rng = np.random.default_rng(1)
        docs = [bytes(rng.integers(97, 104, int(rng.integers(0, 200))).tolist())
                for _ in range(60)]
        langs = np.arange(60, dtype=np.int32) % 2
        spec_args = ("hashed", (1, 2, 3), {{"hash_bits": 10}})
        want = fit_profile_numpy(docs, langs, 2, VocabSpec("hashed", (1, 2, 3), hash_bits=10), 30)
        pool = RankPool(2, {str(tmp_path)!r})
        try:
            for ids, w in pool.run("device_fit", 2, 1, docs, langs, 2, spec_args, 30,
                                   batch_rows=7):
                assert np.array_equal(ids, want[0]) and np.array_equal(w, want[1])
            assert pool.run("jax_modules") == [[], []]
        finally:
            pool.close()
        res = subprocess.run([sys.executable, "-m",
                              "spark_languagedetector_tpu_torch.analysis.check", "--json"],
                             capture_output=True, text=True, timeout=60)
        assert res.returncode == 0, res.stdout + res.stderr
        assert json.loads(res.stdout)["ok"] is True
        bad = sorted(m for m, mod in sys.modules.items() if mod is not None
                     and m.split(".")[0] in ("jax", "jaxlib", "spark_languagedetector_tpu"))
        assert not bad, bad
        print("isolated")
        """
    )
    path = [str(blocker), str(PORT_DIR.parent), os.environ.get("PYTHONPATH", "")]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in path if p)}
    res = subprocess.run(
        [sys.executable, "-c", script],
        cwd=PORT_DIR.parent, capture_output=True, text=True, timeout=180, env=env,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip().endswith("isolated")


def test_serving_entry_points_raise_without_a_card(tmp_path):
    """``ModelRegistry.load`` with no device, and the server's module entry
    point, need the card: with none visible they raise, never serve on the
    CPU."""
    from spark_languagedetector_tpu_torch.serve import ModelRegistry

    model = LanguageDetectorModel.from_gram_map(
        {b"a": [1.0, 0.0]}, [1, 2], ["en", "de"], device="cpu"
    )
    model.save(str(tmp_path / "m"))
    script = textwrap.dedent(
        f"""
        import torch
        torch.cuda.is_available = lambda: False
        from spark_languagedetector_tpu_torch.serve import ModelRegistry
        from spark_languagedetector_tpu_torch.serve import ServeFleet
        from spark_languagedetector_tpu_torch.zoo import ModelZoo, TenantLoadShed
        for call in (lambda: ModelRegistry().load({str(tmp_path / "m")!r}),
                     lambda: ServeFleet.from_path({str(tmp_path / "m")!r}, replicas=2)):
            try:
                call()
                raise AssertionError("served without a card")
            except RuntimeError as e:
                assert "no CUDA device" in str(e), e
        zoo = ModelZoo(max_wait_ms=2)
        zoo.add_tenant("t", path={str(tmp_path / "m")!r})
        try:
            zoo.runtime("t")
            raise AssertionError("a tenant loaded without a card")
        except TenantLoadShed as e:
            assert "no CUDA device" in str(e.__cause__), e.__cause__
        print("refused")
        """
    )
    res = subprocess.run(
        [sys.executable, "-c", script],
        cwd=PORT_DIR.parent, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("refused")
    res = subprocess.run(
        [sys.executable, "-m", "spark_languagedetector_tpu_torch.serve.server",
         str(tmp_path / "m"), "127.0.0.1:0"],
        cwd=PORT_DIR.parent, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert res.returncode != 0 and "no CUDA device" in res.stderr, res.stderr[-2000:]
    assert "serving" not in res.stdout
    assert ModelRegistry(device="cpu").load(str(tmp_path / "m")) == "v1"


def test_no_module_of_the_port_imports_jax():
    offenders = []
    workers = sorted((PORT_DIR.parent / "tests").glob("_torch_*.py"))
    assert {p.name for p in workers} >= {"_torch_mesh_worker.py"}
    for path in sorted(PORT_DIR.rglob("*.py")) + [PORT_DIR.parent / "chip_smoke.py"] + workers:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [
                f"{path.relative_to(PORT_DIR.parent)}:{node.lineno} {n}"
                for n in names
                if n.split(".")[0] in FORBIDDEN
            ]
    assert not offenders, offenders
    scanned = {p.name for p in PORT_DIR.rglob("*.py")}
    assert len(scanned) >= 15
    assert {"cuckoo.py", "bucket.py", "score_hist.py", "score_pallas.py"} <= scanned
    assert {"fit_tpu.py", "fit_pipeline.py", "io.py", "pipeline.py", "preprocessing.py",
            "language.py", "logging.py"} <= scanned
    assert {"api.py", "spans.py", "topk.py", "calibrate.py"} <= {
        p.name for p in (PORT_DIR / "segment").glob("*.py")
    }
    assert {"__init__.py", "batcher.py", "cache.py", "registry.py", "client.py",
            "server.py", "router.py", "fleet.py", "quarantine.py"} <= {
        p.name for p in (PORT_DIR / "serve").glob("*.py")
    }
    assert {"__init__.py", "residency.py", "zoo.py"} <= {
        p.name for p in (PORT_DIR / "zoo").glob("*.py")
    }
    assert {"aggregate.py", "report.py", "compare.py", "stitch.py", "slo.py", "gauges.py",
            "cost.py"} <= {p.name for p in (PORT_DIR / "telemetry").glob("*.py")}
    for rel in ("utils/profiling.py", "utils/debug.py", "exec/tune.py"):
        assert (PORT_DIR / rel).is_file(), rel
    assert {"__init__.py", "microbatch.py", "refit.py"} <= {
        p.name for p in (PORT_DIR / "stream").glob("*.py")
    }
    assert {"__init__.py", "mesh.py", "distributed.py", "sharded.py", "sequence.py"} <= {
        p.name for p in (PORT_DIR / "parallel").glob("*.py")
    }
    assert {"__init__.py", "allowlist.py", "check.py", "harvest.py", "rules.py"} <= {
        p.name for p in (PORT_DIR / "analysis").glob("*.py")
    }
    for rel in ("models/refit.py", "persist/checkpoint.py", "resilience/dlq.py",
                "telemetry/export.py", "artifacts/bake.py", "artifacts/compile_cache.py",
                "scale/replica.py", "scale/autoscaler.py", "scale/elastic.py"):
        assert (PORT_DIR / rel).is_file(), rel


def test_pipeline_loader_imports_nothing_by_name():
    """The port's pipeline loader looks stage classes up in a fixed table:
    no ``importlib`` (nor ``__import__``) anywhere in ``api/pipeline.py``,
    so stored class strings never become imports."""
    path = PORT_DIR / "api" / "pipeline.py"
    calls = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            calls += [a.name for a in node.names if a.name.split(".")[0] == "importlib"]
        elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith("importlib"):
            calls.append(node.module)
        elif isinstance(node, ast.Name) and node.id in ("importlib", "__import__"):
            calls.append(node.id)
        elif isinstance(node, ast.Attribute) and node.attr == "import_module":
            calls.append(node.attr)
    assert not calls, calls
    from spark_languagedetector_tpu_torch.api import pipeline

    assert set(pipeline._STAGE_CLASSES.values()) == set(pipeline._WRITE_NAME)
    assert all(name.startswith("spark_languagedetector_tpu.") for name in pipeline._WRITE_NAME.values())


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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LanguageDetector(["en", "de"], [1, 2], 10).set_fit_backend("device").fit(table)
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
    """Exact gram lengths > 3 were refused until the cuckoo slice; now their
    device view is a cuckoo table (no dense form, no LUT) and a model built
    on one labels documents."""
    profile = GramProfile.from_gram_map(
        {b"abcd": [0.0, 2.0], b"ab": [1.0, 0.0], b"q": [0.5, 0.0]},
        ["en", "de"], [1, 2, 3, 4],
    )
    with pytest.raises(ValueError, match="device_membership"):
        profile.host_membership()
    w, lut, cuckoo = profile.device_membership(device="cpu")
    assert lut is None and cuckoo is not None and cuckoo.num_slots >= 16
    assert tuple(w.shape) == (4, 2) and not w[-1].any()  # zeros miss row
    model = LanguageDetectorModel(profile, device="cpu")
    assert model.transform(Table({"fulltext": ["xabcdx", "abq", ""]})).column(
        "lang"
    ).tolist() == ["de", "en", "en"]
    assert model.runner.strategy == "hybrid"
