"""JSON-lines metrics logger, schema-compatible with the reference's dllogger.

The reference logs one JSON line per epoch to ``{results}/{logname}.json``
plus a human line on stdout with step format ``Epoch: N`` (reference
``model/plt.py:35-40, 104-124``).  Keeping the exact schema means downstream
tooling keeps working:

  {"step": <epoch|[]>, "data": {"f1": ..., "val_loss": ..., "top_f1": ...,
   "D1": ..., "D2": ..., "D3": ..., "D4": ...}}
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence


class MetricsLogger:
    def __init__(self, results_dir: str, logname: str = "logs"):
        os.makedirs(results_dir, exist_ok=True)
        self.path = os.path.join(results_dir, f"{logname}.json")
        self._fh = open(self.path, "a")

    def log(self, step, data: Dict[str, Any]) -> None:
        self._fh.write(json.dumps({"step": step, "data": data}) + "\n")
        self._fh.flush()
        step_str = f"Epoch: {step} " if step != () else ""
        kv = " ".join(f"{k}: {v}" for k, v in data.items())
        print(f"{step_str}{kv}", flush=True)

    def close(self) -> None:
        self._fh.close()


def test_metrics(f1: float, dmgs_f1: Optional[Sequence[float]]) -> Dict[str, Any]:
    """Test payload (reference plt.py:117-124)."""
    metrics = {"f1": round(float(f1), 3)}
    if dmgs_f1 is not None:
        for i in range(4):
            metrics[f"D{i + 1}"] = round(float(dmgs_f1[i]), 3)
    return metrics


def epoch_metrics(f1: float, val_loss: float, top_f1: float,
                  dmgs_f1: Optional[Sequence[float]]) -> Dict[str, Any]:
    """Validation-epoch payload (reference plt.py:104-112, 84-87)."""
    metrics = {"f1": round(float(f1), 3), "val_loss": round(float(val_loss), 3),
               "top_f1": round(float(top_f1), 3)}
    if dmgs_f1 is not None:
        for i in range(4):
            metrics[f"D{i + 1}"] = round(float(dmgs_f1[i]), 3)
    return metrics
