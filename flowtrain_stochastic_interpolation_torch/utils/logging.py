"""The metrics writer: ``metrics.csv``.

The CSV part of ``flowtrain_stochastic_interpolation_tpu/utils/logging.py``
(which imports no JAX), copied so that nothing here imports the JAX package:
rows go to ``metrics.csv``, whose header is widened in place, atomically,
when a new metric appears. wandb is left out on purpose (ROADMAP Queue 1).
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.csv_path = os.path.join(out_dir, "metrics.csv")
        self._file = open(self.csv_path, "a", newline="")
        self._writer = None
        # resume: adopt the existing header so appended rows stay aligned
        self._fieldnames = None
        if os.path.getsize(self.csv_path) > 0:
            with open(self.csv_path, newline="") as f:
                first = f.readline().strip()
            if first:
                self._fieldnames = first.split(",")
                self._writer = csv.DictWriter(
                    self._file, fieldnames=self._fieldnames, extrasaction="ignore"
                )

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": step, "time": time.time(), **metrics}
        new_keys = [k for k in row if k not in (self._fieldnames or [])]
        if new_keys:
            # expand the header in place: different callers log different
            # metric sets (e.g. the pre-train smoke logs time_to_solve before
            # the first train_loss row) and no column may be dropped
            self._fieldnames = (self._fieldnames or []) + new_keys
            self._rewrite_with_header()
        self._writer.writerow(row)
        self._file.flush()

    def _rewrite_with_header(self) -> None:
        # Atomic header expansion: write the widened file to a temp path and
        # os.replace() it, so a crash mid-rewrite (common around periodic
        # inference, which introduces new columns) cannot lose the history.
        self._file.close()
        rows = []
        if os.path.exists(self.csv_path) and os.path.getsize(self.csv_path) > 0:
            with open(self.csv_path, newline="") as f:
                rows = list(csv.DictReader(f))
        tmp_path = self.csv_path + ".tmp"
        with open(tmp_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fieldnames, extrasaction="ignore")
            w.writeheader()
            w.writerows(rows)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_path, self.csv_path)
        self._file = open(self.csv_path, "a", newline="")
        self._writer = csv.DictWriter(
            self._file, fieldnames=self._fieldnames, extrasaction="ignore"
        )

    def log_image(self, step: int, name: str, image_path: str, retries: int = 3) -> bool:
        """Whether the image ``image_path`` exists, tried ``retries`` times
        against a slow filesystem (the JAX writer's retry loop, without its
        wandb upload)."""
        for attempt in range(retries):
            if os.path.exists(image_path):
                return True
            print(f"[MetricsWriter] image log attempt {attempt + 1}/{retries} "
                  f"failed for {name}: {image_path}")
            time.sleep(0.5)
        return False

    def close(self) -> None:
        self._file.close()
