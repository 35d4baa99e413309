"""Checkpoint/resume for training state, one process or sharded.

Port of ``k8s_tpu/models/checkpoint.py``'s ``Checkpointer`` (``save``,
``maybe_save``, ``latest_step``, ``restore_or_init``, ``max_to_keep``,
``async_save``, ``wait``, ``close``, ``save_on_preemption``) over the
port's train state ``{"model", "optimizer", "step"}`` (``models/train.py``):

- a one-process (unsharded) state is one ``torch.save`` of the model's and
  the optimizer's state dicts and the step, as ``<dir>/<step>.pt``: a
  temporary file ``os.replace``d into place, so a writer killed mid-save
  leaves no half checkpoint behind;
- an FSDP-sharded state (``train.shard_train_state``) is saved with
  ``torch.distributed.checkpoint`` into ``<dir>/<step>/``, orbax's layout:
  every rank writes its own shards, process 0 commits the step by writing
  ``.metadata`` last, and a restore reads each rank's shards back onto
  its own device.  The optimizer's param groups (the schedule's update
  count) travel with the moments.  Over an (sp, tp) mesh the shards
  are replicated on every sp and tp rank of a data position; the
  planner's dedup writes each once.  A pipeline stage
  (``models.pp_lm.LmStage``) is saved the same way: each pp rank writes
  its own blocks under their global names and its optimizer state
  flattened per parameter name, and the embedding the two end ranks
  hold alike is written once.  Over ep > 1 each ep rank's experts are
  saved under names of their own (``layers.0.moe_mlp.w_gate@ep1of2``),
  the rest once.  Every rank calls ``save`` and
  ``restore`` (they are collectives); process 0 alone prunes;
- ``async_save``: the state is copied off the device, then written on a
  background thread while training goes on; ``wait()`` (or the next
  save) joins the writer.  Sharded, the writer coordinates over a gloo
  group beside NCCL (``launcher.bootstrap.host_group``);
- ``maybe_save`` follows the reference's orbax policy: a step at or below
  the latest saved one is skipped; otherwise save on multiples of
  ``save_interval_steps``, or when no checkpoint exists yet.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from k8s_tpu_torch.launcher.bootstrap import host_group, process_index
from k8s_tpu_torch.models.train import is_sharded

log = logging.getLogger(__name__)

_FILE = re.compile(r"^(\d+)\.pt$")
_DIR = re.compile(r"^(\d+)$")
_COMMITTED = ".metadata"  # written last by torch.distributed.checkpoint


def _options(model):
    """A pipeline stage's optimizer state is flattened to per-name keys:
    each rank's param groups list only its own parameters."""
    from torch.distributed.checkpoint.state_dict import StateDictOptions

    return StateDictOptions(flatten_optimizer_state_dict=bool(
        getattr(model, "pipeline_stage", False)))


def _ep_suffix(model) -> str:
    """The key suffix of this rank's experts over ep > 1 (``@ep1of4``):
    the ep ranks hold different experts under one parameter name, so
    each rank's are saved under names of their own.  Empty at ep 1."""
    for m in model.modules():
        ring = getattr(m, "ep", None)
        if getattr(ring, "size", 1) > 1:
            return f"@ep{ring.rank}of{ring.size}"
    return ""


def _ep_rename(entries: dict, suffix: str, back: bool = False) -> dict:
    """``entries`` with every expert stack's key given ``suffix`` (or,
    ``back``, the suffix taken off)."""
    from k8s_tpu_torch.models.moe import is_expert_param

    if not suffix:
        return entries
    if back:
        return {k[:-len(suffix)] if k.endswith(suffix) else k: v
                for k, v in entries.items()}
    return {k + suffix if is_expert_param(k) else k: v
            for k, v in entries.items()}


def _dcp_state(state: dict) -> dict:
    """The sharded train state as ``torch.distributed.checkpoint`` takes
    it: the model's and the optimizer's state dicts (DTensors, keyed by
    parameter name; an ep rank's experts by ``_ep_suffix``) and the
    step."""
    from torch.distributed.checkpoint.state_dict import (
        get_model_state_dict, get_optimizer_state_dict,
    )

    model = state["model"]
    suffix = _ep_suffix(model)
    params = _ep_rename(get_model_state_dict(model), suffix)
    opt = get_optimizer_state_dict(model, state["optimizer"],
                                   options=_options(model))
    if suffix:
        opt = {**opt, "state": _ep_rename(opt["state"], suffix)}
    return {"model": params, "optimizer": opt, "step": int(state["step"])}


def _host_copy(obj):
    """A copy of a state dict with every tensor on the host."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


class Checkpointer:
    """Train-state checkpoint manager.

    Args:
      directory: checkpoint root (CHECKPOINT_DIR from the operator env).
      max_to_keep: newest N checkpoints kept, older pruned.
      save_interval_steps: ``maybe_save`` only saves on multiples of this.
      async_save: write on a background thread (``wait()`` or the next
        save joins the writer).
    """

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1, async_save: bool = False):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = str(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.async_save = async_save
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()
        self._pending: Optional[tuple] = None  # (step, future)
        self._writer: Optional[ThreadPoolExecutor] = None  # one-file saves

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.pt")

    def _dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

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
            return self._save_locked(step, state, force)

    def _save_locked(self, step: int, state: dict, force: bool) -> bool:
        if not force and not self.should_save(step):
            return False
        self._join()
        if is_sharded(state["model"]):
            self._save_sharded(step, state)
        else:
            payload = {"model": state["model"].state_dict(),
                       "optimizer": state["optimizer"].state_dict(),
                       "step": int(state["step"])}
            if self.async_save:
                if self._writer is None:
                    self._writer = ThreadPoolExecutor(
                        1, thread_name_prefix="checkpoint-writer")
                self._pending = (int(step), self._writer.submit(
                    self._write_file, step, _host_copy(payload)))
            else:
                self._write_file(step, payload)
        return True

    def _write_file(self, step: int, payload: dict) -> None:
        tmp = os.path.join(self.directory,
                           f".{int(step)}.pt.tmp{os.getpid()}")
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        if not self.async_save:
            self._prune()

    def _save_sharded(self, step: int, state: dict) -> None:
        import torch.distributed.checkpoint as dcp

        sd = _dcp_state(state)
        if self.async_save:
            future = dcp.async_save(sd, checkpoint_id=self._dir(step),
                                    process_group=host_group())
            # newer torch returns a response whose upload future is the
            # one that ends with the commit
            future = getattr(future, "upload_completion", future)
            self._pending = (int(step), future)
        else:
            dcp.save(sd, checkpoint_id=self._dir(step))
            self._prune()

    def _join(self) -> None:
        """Wait for the in-flight async save (re-raising its error), then
        prune."""
        if self._pending is None:
            return
        _, future = self._pending
        self._pending = None
        future.result()
        self._prune()

    def _prune(self) -> None:
        if process_index() != 0:
            return
        for old in self.all_steps()[:-self.max_to_keep]:
            if os.path.isdir(self._dir(old)):
                shutil.rmtree(self._dir(old), ignore_errors=True)
            if os.path.exists(self._path(old)):
                os.remove(self._path(old))

    def maybe_save(self, step: int, state: dict) -> bool:
        """Interval-respecting save (the per-step call site in train loops)."""
        return self.save(step, state)

    # -- restore ---------------------------------------------------------

    def all_steps(self) -> list[int]:
        """Committed steps: ``<step>.pt`` files and ``<step>/``
        directories holding ``.metadata``."""
        steps = set()
        for name in os.listdir(self.directory):
            if _FILE.match(name):
                steps.add(int(name[:-3]))
            elif _DIR.match(name) and os.path.exists(
                    os.path.join(self.directory, name, _COMMITTED)):
                steps.add(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        if self._pending is not None:
            steps.append(self._pending[0])
        return max(steps) if steps else None

    def restore(self, step: int, target_state: dict) -> dict:
        """Load ``step`` into ``target_state``'s model and optimizer in
        place, on their devices (a sharded checkpoint into a sharded
        state, shard by shard); returns the state."""
        model = target_state["model"]
        if is_sharded(model):
            return self._restore_sharded(step, target_state)
        device = next(model.parameters()).device
        payload = torch.load(self._path(step), map_location=device,
                             weights_only=True)
        model.load_state_dict(payload["model"])
        target_state["optimizer"].load_state_dict(payload["optimizer"])
        target_state["step"] = payload["step"]
        return target_state

    def _restore_sharded(self, step: int, target_state: dict) -> dict:
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.state_dict import (
            set_model_state_dict, set_optimizer_state_dict,
        )

        if not os.path.isdir(self._dir(step)):
            raise FileNotFoundError(
                f"no sharded checkpoint {self._dir(step)} for a sharded "
                "state")
        sd = _dcp_state(target_state)
        dcp.load(sd, checkpoint_id=self._dir(step))
        model, opt = target_state["model"], target_state["optimizer"]
        suffix = _ep_suffix(model)
        opt_sd = sd["optimizer"]
        if suffix:
            opt_sd = {**opt_sd, "state": _ep_rename(opt_sd["state"], suffix,
                                                    back=True)}
        set_model_state_dict(model, _ep_rename(sd["model"], suffix,
                                               back=True))
        set_optimizer_state_dict(model, opt, opt_sd, options=_options(model))
        target_state["step"] = int(sd["step"])
        return target_state

    def restore_latest(self, target_state: dict
                       ) -> tuple[dict, Optional[int]]:
        self._join()
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
        """Join any in-flight async save."""
        with self._lock:
            self._join()

    def close(self) -> None:
        self.wait()
        if self._writer is not None:
            self._writer.shutdown()
            self._writer = None

    def save_on_preemption(self, get_state, get_step):
        """Register a SIGTERM hook that saves synchronously before the
        pod's grace period runs out (a preemption is SIGTERM / exit 143,
        which the operator's exit-code policy restarts).  ``get_state`` and
        ``get_step`` are callables, read at signal time.

        Best effort, as the reference: the handler runs on the main thread
        between bytecodes, so if the signal lands while a save holds the
        lock, blocking would deadlock the process inside its grace window;
        the hook skips instead (the in-flight save is at most one interval
        stale).  ``train.fit`` saves at the next step boundary regardless.

        Returns the unsubscribe callable from ``signals.on_shutdown``."""
        from k8s_tpu_torch.util import signals

        def _save_now():
            if not self._lock.acquire(blocking=False):
                log.warning(
                    "SIGTERM during an in-flight save; skipping final save")
                return
            try:
                step = int(get_step())
                log.warning("SIGTERM: checkpointing step %d before exit", step)
                self._save_locked(step, get_state(), force=True)
                self._join()
            except Exception:  # noqa: BLE001 - best effort on the way out
                log.exception("preemption checkpoint failed")
            finally:
                self._lock.release()

        return signals.on_shutdown(_save_now)
