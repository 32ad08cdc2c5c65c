"""The degradation ladder: admission-tightening rungs declared in the
config (the port's copy of ``llmq_tpu/controlplane/ladder.py``).

Scaling takes seconds (a replica's spawn and warmup); tightening
admission takes one attribute write. While capacity catches up, or when
there is none left to add, the controller climbs rungs that tighten
admission at the overload shedder (``OverloadShedder.set_degradation``),
shedding the least valuable work first: tighter thresholds, then the
batch tier (``low``), then tenants under a fairness-weight bound.

One rung is climbed per hot tick; rungs relax in reverse order, one
after ``relax_after_ticks`` consecutive calm ticks, so a burn rate that
oscillates around its threshold cannot flap admission.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

log = logging.getLogger("llmq_tpu_torch.controlplane.ladder")


class DegradationLadder:
    def __init__(self, rungs: Optional[List[Dict[str, Any]]], *,
                 shedder: Any = None,
                 relax_after_ticks: int = 3) -> None:
        self.rungs = [dict(r) for r in (rungs or [])]
        self.shedder = shedder
        self.relax_after_ticks = max(1, int(relax_after_ticks))
        #: 0: no degradation; N: rungs[N-1] active.
        self.level = 0
        self._calm_ticks = 0
        self.escalations = 0
        self.relaxations = 0

    @property
    def rung(self) -> Optional[Dict[str, Any]]:
        if 0 < self.level <= len(self.rungs):
            return self.rungs[self.level - 1]
        return None

    def rung_name(self) -> Optional[str]:
        r = self.rung
        return str(r.get("name", f"rung{self.level}")) if r else None

    def tick(self, *, hot: bool, calm: bool) -> Optional[str]:
        """One controller tick. ``hot``: tighten now; ``calm``: the
        pressure is clearly gone; neither: hold (and restart the calm
        streak: relaxing needs consecutive calm ticks). Returns
        "escalate" or "relax" when the level moved, else None."""
        if hot:
            self._calm_ticks = 0
            if self.level < len(self.rungs):
                self.level += 1
                self.escalations += 1
                self._apply()
                log.warning("ladder escalated to rung %d (%s)",
                            self.level, self.rung_name())
                return "escalate"
            return None
        if calm:
            self._calm_ticks += 1
            if self.level > 0 and self._calm_ticks >= self.relax_after_ticks:
                self.level -= 1
                self.relaxations += 1
                self._calm_ticks = 0
                self._apply()
                log.info("ladder relaxed to rung %d (%s)", self.level,
                         self.rung_name() or "none")
                return "relax"
            return None
        self._calm_ticks = 0
        return None

    def reset(self) -> None:
        self.level = 0
        self._calm_ticks = 0
        self._apply()

    def _apply(self) -> None:
        shedder = self.shedder
        if shedder is None:
            if self.level > 0:
                log.warning("ladder rung %d active but no shedder is "
                            "wired (overload plane disabled?) — "
                            "admission unchanged", self.level)
            return
        set_deg = getattr(shedder, "set_degradation", None)
        if set_deg is not None:
            set_deg(self.rung)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "level": self.level,
            "rung": self.rung_name(),
            "rungs": [str(r.get("name", f"rung{i + 1}"))
                      for i, r in enumerate(self.rungs)],
            "calm_ticks": self._calm_ticks,
            "relax_after_ticks": self.relax_after_ticks,
            "escalations": self.escalations,
            "relaxations": self.relaxations,
        }
