"""Checkpoints of the whole training state, with resume and best-k retention.

Port of ``flowtrain_stochastic_interpolation_tpu/train/checkpoint.py``, which
wraps an orbax ``CheckpointManager``. Here each checkpoint is a directory
``<dir>/<step>/`` holding ``state.pt`` (``torch.save`` of
:meth:`train.state.TrainState.state_dict`) and ``metrics.json``; it is
written under a temporary name and renamed, so a run cut mid-save leaves no
half checkpoint. ``<dir>/config.json`` is the experiment config, written once.

Retention is orbax's rule for the options the JAX manager sets
(``max_to_keep``, ``best_fn`` on ``keep_best_on`` with ``best_mode="min"``,
``keep_checkpoints_without_metrics=True``), applied after every save to the
steps on disk, the new one included:

* with ``keep_best_on`` set and more than ``max_to_keep`` checkpoints, keep
  the ``max_to_keep`` with the lowest metric, and every one saved without
  metrics. So a save can delete the newest step. Among equal metrics the
  later step is kept (orbax sorts stably, descending, and keeps the tail);
* without it, keep the latest ``max_to_keep``.

``best_step`` is the step with the lowest metric (the latest on ties; None
when no checkpoint has metrics), or the latest step without ``keep_best_on``.
A save at a step at or below the latest one is skipped, as orbax's
``should_save`` skips it.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, List, Optional

import torch

from flowtrain_stochastic_interpolation_torch.config import ExperimentConfig
from flowtrain_stochastic_interpolation_torch.train.state import TrainState

_STATE, _METRICS = "state.pt", "metrics.json"


class CheckpointManager:
    """Save and restore :class:`TrainState` under ``directory``."""

    def __init__(self, directory: str, config: Optional[ExperimentConfig] = None, *,
                 max_to_keep: Optional[int] = 3, keep_best_on: Optional[str] = "train_loss"):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.keep_best_on = keep_best_on
        os.makedirs(self.directory, exist_ok=True)
        cfg_path = os.path.join(self.directory, "config.json")
        if config is not None and not os.path.exists(cfg_path):
            with open(cfg_path, "w") as f:
                f.write(config.to_json())

    def all_steps(self) -> List[int]:
        return find_steps(self.directory)

    def _metrics(self, step: int) -> Optional[Dict[str, float]]:
        path = os.path.join(self.directory, str(step), _METRICS)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def _metric(self, metrics: Dict[str, float]) -> float:
        return metrics[self.keep_best_on]

    def _kept(self, steps: List[int]) -> List[int]:
        n = self.max_to_keep
        if n is None or len(steps) <= n:
            return steps
        if self.keep_best_on is None:
            return steps[len(steps) - n:] if n else []
        infos = [(step, self._metrics(step)) for step in steps]
        ranked = sorted([i for i in infos if i[1] is not None],
                        key=lambda i: self._metric(i[1]), reverse=True)
        keep = {step for step, _ in (ranked[len(ranked) - n:] if n else [])}
        keep |= {step for step, metrics in infos if metrics is None}
        return [step for step in steps if step in keep]

    def save(self, step: int, state: TrainState, metrics: Optional[dict] = None) -> bool:
        """Write ``state`` as step ``step`` (skipped at or below the latest step),
        then apply the retention rule. Returns whether it was written."""
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        tmp = tempfile.mkdtemp(prefix=f".{step}.", dir=self.directory)
        try:
            torch.save(state.state_dict(), os.path.join(tmp, _STATE))
            if metrics:
                with open(os.path.join(tmp, _METRICS), "w") as f:
                    json.dump(metrics, f)
            os.rename(tmp, os.path.join(self.directory, str(step)))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        steps = self.all_steps()
        for old in sorted(set(steps) - set(self._kept(steps))):
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def restore(self, state_template: TrainState, step: Optional[int] = None) -> TrainState:
        """Load step ``step`` (the latest when None) into ``state_template``'s
        tensors in place, and return it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        device = next(iter(state_template.params.values())).device
        saved = torch.load(os.path.join(self.directory, str(step), _STATE),
                           map_location=device, weights_only=True)
        state_template.load_state_dict(saved)
        return state_template

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        if self.keep_best_on is None:
            return self.latest_step()
        with_metrics = [(s, m) for s in self.all_steps() if (m := self._metrics(s)) is not None]
        if not with_metrics:
            return None
        return sorted(with_metrics, key=lambda i: self._metric(i[1]), reverse=True)[-1][0]

    def load_config(self) -> Optional[ExperimentConfig]:
        cfg_path = os.path.join(self.directory, "config.json")
        if not os.path.exists(cfg_path):
            return None
        with open(cfg_path) as f:
            return ExperimentConfig.from_json(f.read())


def find_steps(directory: str) -> List[int]:
    """The steps checkpointed in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and os.path.isdir(os.path.join(directory, d)))
