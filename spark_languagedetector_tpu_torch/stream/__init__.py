"""stream subpackage: micro-batch scoring (:mod:`.microbatch`) and the
continuous-learning auto-refit loop (:mod:`.refit`).

Port of ``spark_languagedetector_tpu.stream``."""

from .microbatch import StreamingQuery, kafka_source, memory_source, run_stream  # noqa: F401
from .refit import AutoRefit, RefitProgress  # noqa: F401
