"""Deterministic, seedable fault-injection plane (chaos engineering).

Production traffic means nodes die mid-flight; this module lets tests,
benchmarks and operators *provoke* those failures deterministically
instead of waiting for them (the preemption-tolerance framing of
"Exploring the limits of Concurrency in ML Training on Google TPUs" —
recovery is a throughput concern, so it must be measurable on demand).

Named injection sites, threaded through the layers where real failures
happen:

  ``rpc.send``     client about to write a request/oneway frame
                   (rpc.py) — actions: drop | delay | sever
  ``rpc.recv``     server just read a frame, before dispatch
                   (rpc.py) — actions: drop | delay | sever
  ``xfer.send``    bulk-plane holder about to serve a range request
                   (object_transfer.py) — actions: truncate | corrupt |
                   delay | sever
  ``lease.grant``  a worker-lease grant is being produced (head actor
                   scheduling + node_agent request_lease) — action: delay
  ``worker.kill``  node agent SIGKILLs one of its worker processes
                   (node_agent.py; key = worker_id) — action: kill
  ``worker.stall`` node agent tells a worker to busy-hang its RPC loop
                   for ``delay_s`` seconds (key = worker_id) — action:
                   stall.  The worker stays ALIVE (heartbeats, probes
                   answered late, nothing crashes): the GRAY-failure
                   generator, distinct from kill
  ``worker.oom``   the executing worker, just before running the task
                   body (worker.py; key = function_id) — action: oom.
                   Allocates real touched pages in steps until the
                   node memory watchdog kills it: exercises RSS
                   sampling, victim selection, the typed
                   OutOfMemoryError receipt, and the owner's separate
                   OOM retry budget end to end
  ``agent.kill``   node agent SIGKILLs itself (key = node_id) — action:
                   kill
  ``head.kill``    head service SIGKILLs itself (key = "head") —
                   action: kill.  Exercises the GCS fault-tolerance
                   paths (agent re-register, driver retry window)
                   under `rtpu chaos`.  Like the other kill/stall
                   sites, the rule is evaluated when the rule set is
                   (re-)applied, not per request — ``p``/``at`` index
                   over rule applications, not invocations

Rules are installed process-locally (``install``/``inject``) or cluster-
wide through the head's ``chaos`` RPC (`rtpu chaos inject|schedule|
clear|status`), which applies them on the head and gossips them to every
node agent (push + heartbeat catch-up).  Agents execute kill rules;
everything else fires inline at the site.

Determinism: each rule carries its own ``random.Random(seed)`` and a
per-rule match counter.  A *schedule* (``make_schedule``) derives, from
one seed, explicit per-site invocation indices at which to fire — the
same seed always reproduces the same failure sequence, which is what
makes a chaos run a regression test instead of a dice roll.

Overhead discipline: ``decide()`` is a single module-global list check
when no rules are installed — the plane costs nothing until armed.
Tests inject a clock via ``set_timers`` so delay rules never really
sleep.
"""

from __future__ import annotations

import itertools
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

SITES = ("rpc.send", "rpc.recv", "xfer.send", "lease.grant",
         "worker.kill", "worker.stall", "worker.oom", "agent.kill",
         "head.kill")
ACTIONS = ("drop", "delay", "sever", "truncate", "corrupt", "kill",
           "stall", "oom")

_rule_ids = itertools.count(1)


@dataclass
class Decision:
    """What a site should do for this invocation."""

    action: str
    delay_s: float = 0.0
    rule_id: str = ""


@dataclass
class ChaosRule:
    site: str
    action: str
    p: float = 1.0           # firing probability per matching invocation
    # max firings; -1 = unlimited.  PER PROCESS: gossip installs an
    # independent copy of the rule on every agent, each enforcing its
    # own cap — a count=1 worker.kill with no target kills one worker
    # on EVERY node.  Use `target` to scope cluster-wide one-shots.
    count: int = -1
    delay_s: float = 0.05    # used by action == "delay"
    target: str = ""         # substring match against the site key
    seed: Optional[int] = None
    # explicit schedule: fire exactly at these (0-based) per-rule match
    # indices — overrides `p` (seeded schedules compile to this)
    at: Optional[List[int]] = None
    rule_id: str = ""
    fired: int = 0
    matched: int = field(default=0, repr=False)
    _rng: Any = field(default=None, repr=False)
    _at_set: Any = field(default=None, repr=False)

    def __post_init__(self):
        if self.site not in SITES and not self.site.endswith("*"):
            raise ValueError(f"unknown chaos site {self.site!r} "
                             f"(known: {', '.join(SITES)})")
        if self.action not in ACTIONS:
            raise ValueError(f"unknown chaos action {self.action!r} "
                             f"(known: {', '.join(ACTIONS)})")
        if not self.rule_id:
            self.rule_id = f"chaos-{next(_rule_ids)}"
        if self.seed is None:
            from ray_tpu_torch._private.config import config

            self.seed = int(config.chaos_seed)
        self._rng = random.Random(self.seed)
        self._at_set = frozenset(self.at) if self.at is not None else None

    def matches(self, site: str, key: str) -> bool:
        if self.site.endswith("*"):
            if not site.startswith(self.site[:-1]):
                return False
        elif site != self.site:
            return False
        return not self.target or self.target in key

    def roll(self) -> bool:
        """Advance this rule's deterministic sequence by one matching
        invocation; True when the rule fires for it."""
        idx = self.matched
        self.matched += 1
        if self.count >= 0 and self.fired >= self.count:
            return False
        if self._at_set is not None:
            fire = idx in self._at_set
        else:
            # the RNG advances once per MATCH (not per fire) so the
            # decision sequence is a pure function of (seed, match index)
            fire = self._rng.random() < self.p
        if fire:
            self.fired += 1
        return fire

    def to_wire(self) -> Dict[str, Any]:
        return {"site": self.site, "action": self.action, "p": self.p,
                "count": self.count, "delay_s": self.delay_s,
                "target": self.target, "seed": self.seed,
                "at": list(self.at) if self.at is not None else None,
                "rule_id": self.rule_id, "fired": self.fired}

    @classmethod
    def from_wire(cls, d: Dict[str, Any]) -> "ChaosRule":
        return cls(site=d["site"], action=d["action"],
                   p=d.get("p", 1.0), count=d.get("count", -1),
                   delay_s=d.get("delay_s", 0.05),
                   target=d.get("target", ""), seed=d.get("seed"),
                   at=d.get("at"), rule_id=d.get("rule_id", ""))


_lock = threading.Lock()
_rules: List[ChaosRule] = []   # the fast-path gate: empty = plane inert
version = 0                    # bumped on every install/inject/clear

# injectable timers (tests swap these so delay rules never really sleep)
_sleep: Callable[[float], None] = time.sleep


def set_timers(sleep: Optional[Callable[[float], None]] = None) -> None:
    """Test hook: replace the blocking sleeper used by delay decisions
    (the async helper routes through it via the loop's executor-free
    ``asyncio.sleep`` only when the default is in place)."""
    global _sleep
    _sleep = sleep if sleep is not None else time.sleep


def decide(site: str, key: str = "") -> Optional[Decision]:
    """The site entry point.  Returns None (almost always, at the cost
    of one global list check) or the Decision of the first matching rule
    that fires."""
    if not _rules:
        return None
    return _decide_slow(site, key)


def _decide_slow(site: str, key: str) -> Optional[Decision]:
    with _lock:
        for rule in _rules:
            if not rule.matches(site, key):
                continue
            if not rule.roll():
                continue
            _injections_counter().inc(tags={"site": site})
            return Decision(rule.action, rule.delay_s, rule.rule_id)
    return None


def _injections_counter():
    from ray_tpu_torch._private.metrics import fault_tolerance_metrics

    return fault_tolerance_metrics()[2]


def sleep_sync(delay_s: float) -> None:
    """Blocking delay, through the injected clock."""
    _sleep(delay_s)


async def sleep_async(delay_s: float) -> None:
    """Event-loop delay; honors an injected clock (which must then not
    block) so unit tests stay sleep-free."""
    import asyncio

    if _sleep is time.sleep:
        await asyncio.sleep(delay_s)
    else:
        _sleep(delay_s)


def inject(site: str, action: str, **kw) -> Dict[str, Any]:
    """Add one rule to this process; returns its wire form."""
    global version
    from ray_tpu_torch._private.config import config

    if not config.chaos_enabled:
        raise RuntimeError("chaos fault injection is disabled "
                           "(chaos_enabled=False)")
    rule = ChaosRule(site=site, action=action, **kw)
    with _lock:
        _rules.append(rule)
        version += 1
    return rule.to_wire()


def install(rules_wire: Sequence[Dict[str, Any]],
            new_version: Optional[int] = None) -> None:
    """Replace this process's full rule set (gossip application).
    Counters restart from zero — determinism is per-process."""
    global version
    rules = [ChaosRule.from_wire(d) for d in rules_wire]
    with _lock:
        _rules[:] = rules
        version = new_version if new_version is not None else version + 1


def clear() -> None:
    global version
    with _lock:
        _rules.clear()
        version += 1


def status() -> Dict[str, Any]:
    with _lock:
        return {"version": version,
                "rules": [r.to_wire() for r in _rules]}


def fired_counts() -> Dict[str, int]:
    """{rule_id: firings in THIS process} — agents piggyback this on
    heartbeats so `rtpu chaos status` can aggregate cluster-wide."""
    with _lock:
        return {r.rule_id: r.fired for r in _rules if r.fired}


def make_schedule(seed: int, sites: Sequence[str],
                  actions: Optional[Dict[str, str]] = None,
                  events_per_site: int = 3, span: int = 100,
                  delay_s: float = 0.05) -> List[Dict[str, Any]]:
    """Compile one seed into an explicit failure schedule: for each
    site, `events_per_site` distinct invocation indices within
    [0, span) at which the site's action fires.  Pure function of its
    arguments — the same seed reproduces the same failure sequence on
    any process, which is the property the reproducibility test
    asserts."""
    default_action = {"rpc.send": "drop", "rpc.recv": "drop",
                      "xfer.send": "truncate", "lease.grant": "delay",
                      "worker.kill": "kill", "worker.stall": "stall",
                      "worker.oom": "oom", "agent.kill": "kill",
                      "head.kill": "kill"}
    rng = random.Random(seed)
    rules: List[Dict[str, Any]] = []
    for site in sites:
        if site not in SITES:
            raise ValueError(f"unknown chaos site {site!r}")
        n = min(events_per_site, span)
        at = sorted(rng.sample(range(span), n))
        action = (actions or {}).get(site, default_action[site])
        rules.append(ChaosRule(site=site, action=action, at=at,
                               delay_s=delay_s, seed=seed,
                               count=n).to_wire())
    return rules
