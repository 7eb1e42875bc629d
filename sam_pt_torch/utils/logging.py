"""Experiment logging (counterpart of `RunLogger` and `StageTimer` in
`sam_pt_tpu/utils/logging.py`).

A local-first logger in place of the reference's mandatory wandb backbone:
metrics stream to a JSONL file; if wandb happens to be installed and
WANDB_DISABLED is not set, it mirrors there transparently.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional


class RunLogger:
    def __init__(self, output_dir: str = "outputs/logs",
                 exp_id: Optional[str] = None, config: Optional[Dict] = None,
                 logging_cfg: Optional[Dict] = None):
        """`logging_cfg` is the composed `logging:` config group
        (configs/logging/*.yaml — reference surface configs/logging/base.yaml):
        {exp_id, wandb: {entity, project, ...}}. Explicit `exp_id` wins,
        falling back to logging_cfg['exp_id'], then 'run'; the wandb project
        falls back to the WANDB_PROJECT env var."""
        logging_cfg = logging_cfg or {}
        wandb_cfg = logging_cfg.get("wandb") or {}
        exp_id = exp_id or logging_cfg.get("exp_id") or "run"
        self.output_dir = output_dir
        self.exp_id = exp_id
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, f"{exp_id}.jsonl")
        self.summary: Dict[str, Any] = {}
        self._wandb = None
        if os.environ.get("WANDB_DISABLED", "").lower() not in ("1", "true"):
            try:
                import wandb  # optional

                self._wandb = wandb
                wandb.init(project=wandb_cfg.get("project")
                           or os.environ.get("WANDB_PROJECT", "sam-pt-tpu"),
                           entity=wandb_cfg.get("entity"),
                           name=exp_id, config=config or {})
                try:
                    if wandb_cfg.get("log_code", True) and wandb.run:
                        # reference uploads the run's code as a wandb
                        # artifact (sam_pt/vos_eval/eval.py:49 log_code("."))
                        wandb.run.log_code(wandb_cfg.get("log_code_root", "."))
                except Exception:
                    pass  # code upload is best-effort, never fatal
            except Exception:
                self._wandb = None
        if config:
            self._write({"type": "config", "config": config})

    def _write(self, record: Dict) -> None:
        record = dict(record)
        record.setdefault("ts", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=str) + "\n")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        self._write({"type": "metrics", "step": step, **metrics})
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def set_summary(self, **kwargs) -> None:
        self.summary.update(kwargs)
        self._write({"type": "summary", **kwargs})
        if self._wandb is not None:
            for k, v in kwargs.items():
                self._wandb.run.summary[k] = v

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()


class StageTimer:
    """Per-stage wall-clock totals on the host's clock (time of work on
    a device counts only where the stage waits for it)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, float]:
        """The totals, longest first."""
        return dict(sorted(self.totals.items(), key=lambda kv: -kv[1]))
