"""Training result — reference ``python/ray/train/_internal/result.py`` /
``ray.air.Result``: final metrics + best/latest checkpoint + error."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from .checkpoint import Checkpoint


@dataclasses.dataclass
class Result:
    metrics: Optional[Dict[str, Any]]
    checkpoint: Optional[Checkpoint]
    path: Optional[str] = None
    error: Optional[BaseException] = None
    metrics_history: Optional[List[Dict[str, Any]]] = None
    best_checkpoints: Optional[List[Tuple[Checkpoint, Dict[str, Any]]]] = None
    config: Optional[Dict[str, Any]] = None  # the trial's hyperparameters
    #: training-observability rollup (train/observability.py aggregate):
    #: steps, compile_s, step-time p50, MFU, goodput, per-rank snapshots;
    #: elastic runs add "resizes" (per-transition records) and
    #: "run_goodput" (productive seconds / wall across every resize)
    train_obs: Optional[Dict[str, Any]] = None
    #: elastic worker-group transitions, newest last (empty for rigid runs)
    resizes: Optional[List[Dict[str, Any]]] = None

    @property
    def num_resizes(self) -> int:
        return len(self.resizes or [])

    @property
    def metrics_dataframe(self):
        import pandas as pd
        return pd.DataFrame(self.metrics_history or [])
