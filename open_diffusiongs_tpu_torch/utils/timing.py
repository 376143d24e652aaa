"""Host seconds of a run's stages, closed at synchronized edges: the one
clock of the pipeline, the training / evaluation CLI and the mesh export."""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch


class StageClock:
    """Adds the host seconds since the previous edge to `seconds[name]` at
    each `stage(name)`, synchronizing a CUDA device at every edge; does
    nothing when `seconds` is None."""

    def __init__(self, seconds: Optional[Dict[str, float]], device):
        self.seconds = seconds
        self.cuda = torch.device(device).type == "cuda"
        self.t = self._now()

    def _now(self) -> float:
        if self.seconds is not None and self.cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    def stage(self, name: str) -> None:
        if self.seconds is None:
            return
        t = self._now()
        self.seconds[name] = self.seconds.get(name, 0.0) + t - self.t
        self.t = t
