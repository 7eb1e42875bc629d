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
from typing import Any, Dict, List, Optional

import torch
from torch._C._profiler import _RecordFunctionFast


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
    a device counts only where the stage waits for it).

    Every stage is also kept as a span (the port's tracer,
    `utils/tracing.py`, reads them): its name, its start and end
    in Unix nanoseconds (`time.time_ns()`, the clock `torch.profiler`
    stamps its events on), its parent (the innermost stage open when it
    began), the video it works for (its own `video`, else its parent's,
    else the last video started), and its counts (given at its start and
    added to by `count`). While a `torch.profiler` run is active a stage
    also opens the profiler range `sam_pt:<name>`, as an operator's range
    (a user annotation would be copied onto the device's timeline). A
    stage at depth 0 or 1 on a CUDA `device` (inherited like `video`)
    records a timing event on the current stream at each end; `export`
    resolves them. Nothing here reads a device tensor."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.spans: List[Dict] = []
        self.video = None  # the id of the last video started
        self._videos = 0
        self._open: List[Dict] = []

    @contextlib.contextmanager
    def stage(self, name: str, *, video=None, device=None, **counts):
        span = self._begin(name, video, device, counts)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            self._end(span)

    def new_video(self, video_id=None):
        """Start a video: `video_id`, or the running number of videos
        started, is the id later root stages take."""
        self.video = self._videos if video_id is None else video_id
        self._videos += 1
        return self.video

    def count(self, name: str, n=1) -> None:
        """Add `n` to the counter `name` of the innermost open stage (with
        no stage open, nothing is kept)."""
        if self._open:
            counts = self._open[-1]["counts"]
            counts[name] = counts.get(name, 0) + n

    def _begin(self, name, video, device, counts) -> Dict:
        parent = self._open[-1] if self._open else None
        if parent is None:
            depth = 0
            video = self.video if video is None else video
        else:
            depth = parent["depth"] + 1
            video = parent["video"] if video is None else video
            device = parent["device"] if device is None else device
        span = {"name": name, "id": len(self.spans),
                "parent": None if parent is None else parent["id"],
                "depth": depth, "video": video, "device": device,
                "counts": counts, "events": None, "range": None,
                "end_ns": None}
        if depth <= 1 and device is not None and device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(device))
            span["events"] = (start, None)
        span["start_ns"] = time.time_ns()
        if torch.autograd._profiler_enabled():
            span["range"] = _RecordFunctionFast("sam_pt:" + name)
            span["range"].__enter__()
        self.spans.append(span)
        self._open.append(span)
        return span

    def _end(self, span: Dict) -> None:
        if span["range"] is not None:
            span["range"].__exit__(None, None, None)
            span["range"] = None
        span["end_ns"] = time.time_ns()
        if span["events"] is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(span["device"]))
            span["events"] = (span["events"][0], end)
        self._open.pop()

    def export(self) -> List[Dict]:
        """The spans, oldest first: name, start_ns, end_ns (None while
        open), parent (a span's index in this list, or None), video,
        counts, and device_ms (the device's time between the span's two
        events; None without them). Waits for the events it reads."""
        out = []
        for span in self.spans:
            device_ms = None
            events = span["events"]
            if events is not None and events[1] is not None:
                events[1].synchronize()
                device_ms = events[0].elapsed_time(events[1])
            out.append({"name": span["name"], "start_ns": span["start_ns"],
                        "end_ns": span["end_ns"],
                        "parent": span["parent"], "video": span["video"],
                        "counts": dict(span["counts"]),
                        "device_ms": device_ms})
        return out

    def report(self) -> Dict[str, float]:
        """The totals, longest first."""
        return dict(sorted(self.totals.items(), key=lambda kv: -kv[1]))

