"""Fault-tolerant training runner.

  * checkpoints every ``ckpt_every`` steps (atomic, retained history) and
    restart from the latest;
  * failure injection, then recovery from the last checkpoint
    (`TrainRunner.recover_and_run`);
  * a straggler monitor: per-step wall times, flagged against an EWMA, with
    a mitigation hook;
  * deterministic data restart (a batch is a pure function of its step).

Each step's loss is read back with one host sync (``float(loss)``), as in
the reference.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Union


from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.data import SyntheticLM
from repro_torch.sharding.ctx import is_dtensor

Tree = Dict[str, Any]


@dataclasses.dataclass
class StragglerReport:
    step: int
    step_time_s: float
    ewma_s: float

    @property
    def slowdown(self) -> float:
        return self.step_time_s / max(self.ewma_s, 1e-9)


class StragglerMonitor:
    """EWMA-based step-time anomaly detection."""

    def __init__(self, threshold: float = 2.0, alpha: float = 0.2):
        self.threshold = threshold
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self.flagged: List[StragglerReport] = []

    def observe(self, step: int, dt: float) -> Optional[StragglerReport]:
        if self.ewma is None:
            self.ewma = dt
            return None
        report = None
        if dt > self.threshold * self.ewma:
            report = StragglerReport(step, dt, self.ewma)
            self.flagged.append(report)
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return report


class TrainRunner:
    """Runs ``step_fn`` (`launch.steps.make_train_step`, or a sharded
    `jit_train_step`) over ``dataset``'s batches, saving ``{"params",
    "opt"}`` to ``ckpt_dir`` (every rank saves sharded state, see
    `checkpoint.save_checkpoint`). A restore places the leaves on the
    device of the runner's own state, under ``shardings`` when given: any
    mesh, the reference's elastic continuation."""

    def __init__(self, *, step_fn: Callable, params: Tree, opt_state: Tree,
                 dataset: SyntheticLM, ckpt_dir: Union[str, Path],
                 ckpt_every: int = 10,
                 mitigation_hook: Optional[Callable] = None):
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.dataset = dataset
        self.ckpt_dir = Path(ckpt_dir)
        self.ckpt_every = ckpt_every
        self.monitor = StragglerMonitor()
        self.mitigation_hook = mitigation_hook
        self.losses: List[float] = []
        self.step = 0
        self.restarts = 0

    # ------------------------------------------------------------------
    def try_restore(self, shardings: Optional[Tree] = None) -> bool:
        """Restore the latest checkpoint into the runner's state; False
        when there is none. ``shardings``: ``{"params": tree, "opt": tree}``
        of `LeafSharding` to place it under."""
        state_like = {"params": self.params, "opt": self.opt_state}
        count = self.opt_state["count"]
        device = count.to_local().device if is_dtensor(count) else count.device
        try:
            step, state = load_checkpoint(self.ckpt_dir, state_like, device=device,
                                          shardings=shardings)
        except FileNotFoundError:
            return False
        self.params, self.opt_state = state["params"], state["opt"]
        self.step = step
        return True

    def _save(self) -> None:
        save_checkpoint(self.ckpt_dir, self.step,
                        {"params": self.params, "opt": self.opt_state})

    # ------------------------------------------------------------------
    def run(self, n_steps: int, *,
            fail_at: Optional[int] = None,
            slow_steps: Optional[Dict[int, float]] = None) -> Dict[str, Any]:
        """Run to ``self.step + n_steps``. ``fail_at`` raises a simulated
        node failure at that step (the caller restarts through
        `recover_and_run`); ``slow_steps`` maps a step to extra seconds
        (straggler injection)."""
        slow_steps = slow_steps or {}
        target = self.step + n_steps
        while self.step < target:
            t0 = time.time()
            batch = self.dataset.batch_at(self.step)
            if fail_at is not None and self.step == fail_at:
                raise RuntimeError(f"simulated node failure at step {self.step}")
            self.params, self.opt_state, loss, _metrics = self.step_fn(
                self.params, self.opt_state, batch)
            if self.step in slow_steps:
                time.sleep(slow_steps[self.step])
            loss = float(loss)
            self.losses.append(loss)
            dt = time.time() - t0
            rep = self.monitor.observe(self.step, dt)
            if rep is not None and self.mitigation_hook is not None:
                self.mitigation_hook(rep)
            self.step += 1
            if self.step % self.ckpt_every == 0:
                self._save()
        self._save()
        return {"final_loss": self.losses[-1] if self.losses else None,
                "steps": self.step,
                "stragglers": len(self.monitor.flagged),
                "restarts": self.restarts}

    def recover_and_run(self, n_steps_total_target: int,
                        shardings: Optional[Tree] = None) -> Dict[str, Any]:
        """The restart path after a failure: restore the latest checkpoint
        (under ``shardings`` when given; or start over at step 0 without
        one), then run to the target."""
        if not self.try_restore(shardings=shardings):
            self.step = 0
        self.restarts += 1
        return self.run(max(n_steps_total_target - self.step, 0))
