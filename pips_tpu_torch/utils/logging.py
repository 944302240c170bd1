"""Scalar/metric logging: a copy of ``pips_tpu/utils/logging.py``.

JSONL event files (one line per scalar batch), with TensorBoard pass-through
only when ``tensorboardX`` or ``torch.utils.tensorboard`` can be imported.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping


def _try_tensorboard(log_dir: str):
    try:
        from tensorboardX import SummaryWriter  # type: ignore
        return SummaryWriter(log_dir)
    except Exception:
        pass
    try:
        from torch.utils.tensorboard import SummaryWriter  # type: ignore
        return SummaryWriter(log_dir)
    except Exception:
        return None


class MetricWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "events.jsonl")
        self._f = open(self.path, "a")
        self.tb = _try_tensorboard(log_dir) if use_tensorboard else None

    def scalars(self, step: int, values: Mapping[str, float]) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.tb is not None:
            for k, v in values.items():
                self.tb.add_scalar(k, float(v), step)

    def close(self) -> None:
        self._f.close()
        if self.tb is not None:
            self.tb.close()
