"""Rollout orchestration: canary → promote / rollback over the serving
fleet, driven by a pure hysteresis state machine.

Port of ``distkeras_tpu/deploy/rollout.py``.

:class:`RolloutPolicy` follows the ``ElasticPolicy`` discipline
(resilience/elastic.py): no clocks, no threads, no sockets — callers
hand it ``now`` and the observed health signals, it returns a list of
action dicts and journals every decision. The surrounding
:class:`RolloutController` owns the impure half: picking the canary
subset deterministically from the router's directory view, pushing
versions onto replicas, and journaling every transition to the flight
recorder (``deploy.transition`` instants) and to a JSON-clean
``journal`` list CI uploads as an artifact.

The health signals come from the watchtower: ``green`` means the
watchdog currently holds NO active alert (promotion gate), and
``slo_firing`` means a ``ServingSLORule`` alert is active (rollback
trigger). :func:`watchtower_health` adapts a ``Watchtower`` into that
pair; it reads only ``tower.watchdog.active`` (or ``tower.active``), so
any object with that active-alert map serves, and the ``health`` closure
a ``RolloutController`` takes may be any callable.
"""

from __future__ import annotations

import math
from typing import Callable

from distkeras_tpu_torch.observability import trace as _trace

__all__ = ["RolloutPolicy", "RolloutController", "watchtower_health"]


def watchtower_health(tower) -> tuple[bool, bool]:
    """``(green, slo_firing)`` from a Watchtower's active-alert set.

    ``green`` is strict — ANY active alert (a PS rule, a loss stall)
    blocks promotion; a candidate should not be promoted into a sick
    fleet even when serving latency itself looks fine. ``slo_firing``
    is specifically the serving-SLO rule: the one signal that means the
    canary is hurting traffic NOW and must be rolled back."""
    active = getattr(getattr(tower, "watchdog", tower), "active", {})
    green = not active
    slo_firing = any(
        a.get("kind") == "serving_slo" for a in active.values()
    )
    return green, slo_firing


class RolloutPolicy:
    """Pure hysteresis state machine for one candidate at a time.

    States: ``idle`` (baseline serving everywhere) and ``canary`` (the
    candidate pinned to a fraction of the fleet). ``observe`` moves the
    machine and returns the actions the caller must execute:

    - ``{"action": "canary", "version": v, "fraction": f}`` — pin the
      candidate to a ``fraction`` of replicas.
    - ``{"action": "ramp", "version": v, "fraction": f}`` — the current
      ramp step stayed green for ``green_checks`` observations after its
      ``bake_s`` soak: widen the canary to the next fraction (only with
      a progressive ``fractions=`` ladder).
    - ``{"action": "promote", "version": v}`` — the LAST ramp step
      stayed green for ``green_checks`` consecutive observations after a
      ``bake_s`` soak: activate fleet-wide.
    - ``{"action": "rollback", "version": v, "to": baseline}`` — the
      serving SLO fired ``red_checks`` consecutive observations: repin
      the canaries to the baseline.

    ``fractions`` turns the single static canary fraction
    into a progressive ramp — e.g. ``[0.01, 0.1, 0.5]`` exposes 1% of
    the fleet first, and each widening requires a FRESH bake + green
    streak, so a regression that only shows under real traffic volume
    is caught while it still touches a sliver of users. ``fractions=
    None`` (default) is exactly the legacy single-step machine:
    ``[canary_fraction]``.

    Hysteresis on BOTH edges (consecutive-check streaks + the bake
    time) keeps one noisy scrape from promoting a bad model or rolling
    back a good one; ``cooldown_s`` separates consecutive rollouts the
    same way ``ElasticPolicy.cooldown_s`` separates scale actions.
    """

    def __init__(self, canary_fraction: float = 0.25, bake_s: float = 2.0,
                 green_checks: int = 2, red_checks: int = 1,
                 cooldown_s: float = 5.0,
                 fractions: list[float] | None = None):
        if not 0.0 < canary_fraction <= 1.0:
            raise ValueError(
                f"canary_fraction must be in (0, 1], got {canary_fraction}"
            )
        if bake_s < 0 or cooldown_s < 0:
            raise ValueError("bake_s and cooldown_s must be >= 0")
        if green_checks < 1 or red_checks < 1:
            raise ValueError("green_checks and red_checks must be >= 1")
        self.canary_fraction = float(canary_fraction)
        if fractions is None:
            fractions = [self.canary_fraction]
        fractions = [float(f) for f in fractions]
        if not fractions or any(not 0.0 < f <= 1.0 for f in fractions):
            raise ValueError(
                f"fractions must be non-empty, each in (0, 1]: {fractions}"
            )
        if any(b <= a for a, b in zip(fractions, fractions[1:])):
            raise ValueError(
                f"fractions must be strictly increasing: {fractions}"
            )
        self.fractions = fractions
        self._fi = 0              # index of the ACTIVE ramp step
        self.bake_s = float(bake_s)
        self.green_checks = int(green_checks)
        self.red_checks = int(red_checks)
        self.cooldown_s = float(cooldown_s)
        self.state = "idle"
        self.version = 0          # the promoted baseline
        self.candidate: int | None = None
        self._t_canary: float | None = None
        self._t_last_action: float | None = None
        self._green_streak = 0
        self._red_streak = 0
        #: every decision, in order — the rollout journal CI uploads
        self.decisions: list[dict] = []

    def _emit(self, now: float, action: str, **fields) -> dict:
        rec = {"t": float(now), "action": action, "state": self.state,
               **fields}
        self.decisions.append(rec)
        return rec

    def observe(self, now: float, candidate: int | None,
                green: bool, slo_firing: bool) -> list[dict]:
        """Advance the machine one observation; returns actions to run."""
        out: list[dict] = []
        if self.state == "idle":
            if candidate is None or candidate <= self.version:
                return out
            if (self._t_last_action is not None
                    and now - self._t_last_action < self.cooldown_s):
                return out  # cooling down from the previous rollout
            self.state = "canary"
            self.candidate = int(candidate)
            self._fi = 0
            self._t_canary = now
            self._t_last_action = now
            self._green_streak = 0
            self._red_streak = 0
            out.append(self._emit(now, "canary", version=self.candidate,
                                  fraction=self.fractions[0]))
            return out
        # state == "canary"
        if slo_firing:
            self._red_streak += 1
            self._green_streak = 0
            if self._red_streak >= self.red_checks:
                version = self.candidate
                self.state = "idle"
                self.candidate = None
                self._t_last_action = now
                out.append(self._emit(now, "rollback", version=version,
                                      to=self.version))
            return out
        self._red_streak = 0
        if green and now - self._t_canary >= self.bake_s:
            self._green_streak += 1
            if self._green_streak >= self.green_checks:
                if self._fi + 1 < len(self.fractions):
                    # ramp: widen to the next fraction; the new step
                    # re-bakes and needs a FRESH green streak — each
                    # widening earns its own soak
                    self._fi += 1
                    self._t_canary = now
                    self._t_last_action = now
                    self._green_streak = 0
                    out.append(self._emit(
                        now, "ramp", version=self.candidate,
                        fraction=self.fractions[self._fi]))
                    return out
                version = self.candidate
                self.state = "idle"
                self.version = version
                self.candidate = None
                self._t_last_action = now
                out.append(self._emit(now, "promote", version=version))
        else:
            # not green (some alert is up) or still baking: hold, and a
            # non-green observation restarts the green streak — the
            # promotion gate wants CONSECUTIVE clean checks
            if not green:
                self._green_streak = 0
        return out


class RolloutController:
    """Drives a rollout over real replicas: deterministic canary pick,
    version activation, and transition journaling.

    - ``router`` — a ``RoutedGenerationClient`` (or anything with
      ``refresh()`` and ``replica_versions() -> {key: version}``): the
      directory view the canary subset is picked from.
    - ``activate(key, version) -> bool`` — push ``version`` onto the
      replica registered under ``key`` (the serving server's
      ``deploy_activate`` wire action; in-process tests pass a closure).
    - ``health() -> (green, slo_firing)`` — usually
      ``lambda: watchtower_health(tower)``.

    The canary subset is the first ``ceil(fraction·N)`` keys ordered by
    ``stable_hash(key)`` — deterministic across controllers and across
    calls, so a restarted controller repins the SAME replicas.
    """

    def __init__(self, router, activate: Callable[[str, int], bool],
                 health: Callable[[], tuple[bool, bool]],
                 policy: RolloutPolicy | None = None):
        self.router = router
        self.activate = activate
        self.health = health
        self.policy = policy if policy is not None else RolloutPolicy()
        self.candidate: int | None = None
        self.canary_keys: list[str] = []
        #: JSON-clean transition journal (CI artifact)
        self.journal: list[dict] = []

    def begin(self, candidate: int) -> None:
        """Stage a candidate version; the next ``step`` may canary it."""
        self.candidate = int(candidate)

    def _keys(self) -> list[str]:
        from distkeras_tpu_torch.sharding.ring import stable_hash

        try:
            self.router.refresh()
        except Exception:
            pass  # a directory blip: act on the last known fleet
        versions = self.router.replica_versions()
        return sorted(versions, key=lambda k: (stable_hash(k), k))

    def _pick_canaries(self, keys: list[str],
                       fraction: float | None = None) -> list[str]:
        if not keys:
            return []
        if fraction is None:
            fraction = self.policy.canary_fraction
        n = max(1, int(math.ceil(float(fraction) * len(keys))))
        return keys[:n]

    def _journal(self, now: float, action: dict, keys: list[str],
                 ok: int) -> None:
        rec = {**action, "keys": list(keys), "activated": ok}
        self.journal.append(rec)
        _trace.instant("deploy.transition", cat="deploy", args={
            "action": action["action"],
            "version": int(action.get("version") or 0),
            "replicas": len(keys),
        })

    def step(self, now: float) -> list[dict]:
        """One control-loop tick: read health, advance the policy,
        execute whatever it decided. Returns the executed actions."""
        green, slo_firing = self.health()
        actions = self.policy.observe(now, self.candidate, green,
                                      slo_firing)
        executed = []
        for action in actions:
            kind = action["action"]
            if kind == "canary":
                keys = self._pick_canaries(self._keys(),
                                           action.get("fraction"))
                self.canary_keys = keys
            elif kind == "ramp":
                # widen: activate ONLY the newly-added replicas — the
                # existing canaries already run the candidate, and
                # re-activating them would re-stage a no-op swap
                want = self._pick_canaries(self._keys(),
                                           action.get("fraction"))
                have = set(self.canary_keys)
                keys = [k for k in want if k not in have]
                self.canary_keys = list(self.canary_keys) + keys
            elif kind == "promote":
                # the canaries already run the candidate — activate the
                # remainder of the fleet
                keys = [k for k in self._keys()
                        if k not in set(self.canary_keys)]
                self.candidate = None
            else:  # rollback: repin the canaries to the baseline
                keys = list(self.canary_keys)
                self.canary_keys = []
                self.candidate = None
            version = (self.policy.version if kind == "rollback"
                       else action["version"])
            ok = 0
            for key in keys:
                try:
                    if self.activate(key, version):
                        ok += 1
                except Exception:
                    pass  # a dead replica re-registers and catches up
            self._journal(now, action, keys, ok)
            executed.append(action)
        return executed
