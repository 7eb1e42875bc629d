"""Per-video evaluation API (counterpart of `sam_pt_tpu/vos_eval/evaluator.py`;
reference sam_pt/vos_eval/evaluator.py:7-60)."""
from __future__ import annotations

import abc
from typing import Dict


class VOSEvaluator(abc.ABC):
    """Abstract per-video evaluator: video dict in, predictions dict out."""

    def __init__(self, cfg=None, model=None):
        self.cfg = cfg
        self.model = model

    @abc.abstractmethod
    def evaluate_video(self, video: Dict) -> Dict:
        ...


class SamPtEvaluator(VOSEvaluator):
    """Runs SamPt.forward on the video (the model uploads the frames to its
    own device and returns device tensors)."""

    def evaluate_video(self, video: Dict) -> Dict:
        return self.model.forward(video)
