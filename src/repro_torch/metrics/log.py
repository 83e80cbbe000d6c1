"""JSONL metric logging — append-only, crash-safe, restart-friendly
(re-logging a step after restart simply supersedes the earlier line)."""
from __future__ import annotations

import json
import os
import time


class MetricLogger:
    def __init__(self, path: str | None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, step: int, **metrics):
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            if hasattr(v, "tolist"):
                v = v.tolist()
            rec[k] = v
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
                f.flush()
        return rec

    def read(self):
        if not self.path or not os.path.exists(self.path):
            return []
        rows = {}
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue           # trailing partial line after a crash
                rows[rec["step"]] = rec     # later lines supersede
        return [rows[s] for s in sorted(rows)]


def throughput_tokens_per_s(global_batch: int, seq_len: int,
                            step_seconds: float) -> float:
    return global_batch * seq_len / max(step_seconds, 1e-9)
