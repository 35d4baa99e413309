"""Checkpoint/resume for training state, single process.

Port of ``k8s_tpu/models/checkpoint.py``'s ``Checkpointer`` interface
(``save``, ``maybe_save``, ``latest_step``, ``restore_or_init``,
``max_to_keep``, ``wait``, ``close``) for one process:

- the train state is the port's ``{"model", "optimizer", "step"}``
  (``models/train.py``); a checkpoint is one ``torch.save`` of the model's
  and the optimizer's state dicts and the step, as ``<dir>/<step>.pt``;
- each save writes a temporary file and ``os.replace``s it into place, so
  a writer killed mid-save leaves no half checkpoint behind;
- ``maybe_save`` follows the reference's orbax policy: a step at or below
  the latest saved one is skipped; otherwise save on multiples of
  ``save_interval_steps``, or when no checkpoint exists yet;
- restoring loads into the given state's model and optimizer in place.

Sharded, multi-process checkpoints (``torch.distributed.checkpoint``) come
with the parallel slice of the port.
"""

from __future__ import annotations

import logging
import os
import re
import threading
from typing import Optional

import torch

log = logging.getLogger(__name__)

_NAME = re.compile(r"^(\d+)\.pt$")


class Checkpointer:
    """Train-state checkpoint manager.

    Args:
      directory: checkpoint root (CHECKPOINT_DIR from the operator env).
      max_to_keep: newest N checkpoints kept, older pruned.
      save_interval_steps: ``maybe_save`` only saves on multiples of this.
    """

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = str(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.pt")

    # -- save ------------------------------------------------------------

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return latest is None or step % self.save_interval_steps == 0

    def save(self, step: int, state: dict, *, force: bool = False) -> bool:
        """Save ``state`` at ``step``.  Returns True if a save happened
        (off-interval steps are skipped unless ``force``)."""
        with self._lock:
            if not force and not self.should_save(step):
                return False
            payload = {"model": state["model"].state_dict(),
                       "optimizer": state["optimizer"].state_dict(),
                       "step": int(state["step"])}
            path = self._path(step)
            tmp = os.path.join(self.directory,
                               f".{int(step)}.pt.tmp{os.getpid()}")
            torch.save(payload, tmp)
            os.replace(tmp, path)
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
            return True

    def maybe_save(self, step: int, state: dict) -> bool:
        """Interval-respecting save (the per-step call site in train loops)."""
        return self.save(step, state)

    # -- restore ---------------------------------------------------------

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_state: dict) -> dict:
        """Load ``step`` into ``target_state``'s model and optimizer (in
        place, on the model's device); returns the state."""
        model = target_state["model"]
        device = next(model.parameters()).device
        payload = torch.load(self._path(step), map_location=device,
                             weights_only=True)
        model.load_state_dict(payload["model"])
        target_state["optimizer"].load_state_dict(payload["optimizer"])
        target_state["step"] = payload["step"]
        return target_state

    def restore_latest(self, target_state: dict
                       ) -> tuple[dict, Optional[int]]:
        step = self.latest_step()
        if step is None:
            return target_state, None
        return self.restore(step, target_state), step

    def restore_or_init(self, target_state: dict) -> tuple[dict, int]:
        """The resume contract: (restored_state, next_step) if a checkpoint
        exists, else (target_state, 0).  Fresh pods after a gang restart call
        this unconditionally."""
        state, step = self.restore_latest(target_state)
        if step is None:
            log.info("no checkpoint under %s; fresh start", self.directory)
            return target_state, 0
        log.info("resumed from step %d under %s", step, self.directory)
        return state, step + 1

    # -- lifecycle -------------------------------------------------------

    def wait(self) -> None:
        """Saves are synchronous: nothing is ever in flight."""

    def close(self) -> None:
        self.wait()
