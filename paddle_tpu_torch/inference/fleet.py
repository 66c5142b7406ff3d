"""ServingFleet: a prefix-aware router over N serving engines (port of
``paddle_tpu/inference/fleet.py``).

Warm KV state is replica-local: a warm request routed to the wrong
replica pays a full cold prefill. The router sends work to where the state
already lives.

- **Tree-summary protocol.** Each replica's radix prefix cache exports a
  page-aligned summary ``{hash(token_prefix): n_tokens}`` and a monotone
  ``version`` (``prefix_summary()`` / ``prefix_cache_version``); the
  router caches the summary a replica and refreshes it only when the
  version moves. Summaries include spilled nodes: a prefix in a replica's
  host tier is still warm there (it restores on admission).
- **Prefix-aware routing** (``policy="prefix"``, the default): the
  prompt's page-aligned prefixes, longest first, against every replica's
  summary; the longest match wins (ties: least loaded, then lowest index).
  A cold prompt goes to the least-loaded replica, ties broken round-robin.
- **Admission backpressure**: a replica whose un-admitted queue is at
  ``max_queue_depth`` is no candidate while another has room; a warm
  request whose home is saturated DIVERTS (counted) to the best shorter
  match still open, else to cold capacity.
- ``policy="round_robin"`` / ``"least_loaded"``: the naive placements,
  kept as baselines; they still score the chosen replica, so their
  warm-hit ratio is measured, not 0.

Replicas are any mix of engine kinds (a colocated ``ServingEngine`` with or
without mesh, prefix cache or host tier, a ``DisaggregatedEngine``): each
has ``submit/step/drain/metrics`` and the router surface (``queue_depth``,
``live_slots``, ``prefix_summary``, ``prefix_cache_version``,
``offload_metrics``). Greedy output is per-request deterministic on every
kind, so the fleet's output equals a single colocated engine's, wherever a
request lands. The router is host bookkeeping only: no device work.
``step()`` runs one scheduler iteration a replica, in turn; on one card
the replicas' device work runs back to back. ``metrics()`` has the JAX
fleet's keys. ``observability=``/``telemetry=`` are the JAX fleet's: the
request-level histograms are shared by reference with every replica that
has the harness, the router records ``route`` events and per-replica
queue-depth gauges, the telemetry plane registers the fleet rollup and
each replica under a ``replica`` label, and ``export_trace``/
``write_timeline`` write the router's trace. The program audit (ROADMAP
A12) raises.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..observability import Observability, TelemetryConfig, TelemetryPlane
from .generation import GenerationConfig
from .serving import Request, _drain_loop

__all__ = ["ServingFleet"]

# request-level distributions shared BY REFERENCE with every
# observability-enabled replica (the disagg engine's idiom): a request
# admits and finishes on its replica, but its TTFT/TPOT must land in
# ONE fleet-wide distribution wherever it ran
FLEET_SHARED_HISTOGRAMS = ("ttft_ms", "tpot_ms", "queue_wait_ms",
                           "e2e_ms")
# ...plus what only the router can time
FLEET_HISTOGRAMS = FLEET_SHARED_HISTOGRAMS + ("step_ms",)

_POLICIES = ("prefix", "least_loaded", "round_robin")


def _later_slice(what: str, item: str):
    raise NotImplementedError(
        f"ServingFleet: {what} is not ported yet (ROADMAP {item})")


def _replica_roofline(engine) -> Dict[str, object]:
    """A replica's decode roofline: a DisaggregatedEngine prices its
    decode GROUP's route, every other engine kind its own; each at its
    measured mean decode-step time."""
    eng = engine if hasattr(engine, "_roofline_metrics") else engine.decode
    return eng._roofline_metrics(eng._decode_step_ms_mean())


class _Replica:
    """The router's handle: the engine and its cached tree summary."""

    __slots__ = ("name", "engine", "bs", "version", "summary",
                 "max_tokens", "routed", "warm_routed")

    def __init__(self, name: str, engine):
        self.name = name
        self.engine = engine
        self.bs = int(engine.block_size)
        self.version = -1            # forces the first refresh
        self.summary: Dict[int, int] = {}
        self.max_tokens = 0          # longest cached path, in tokens
        self.routed = 0
        self.warm_routed = 0

    def refresh(self) -> Dict[int, int]:
        v = self.engine.prefix_cache_version
        if v != self.version:
            self.summary = self.engine.prefix_summary()
            self.max_tokens = max(self.summary.values(), default=0)
            self.version = v
        return self.summary

    @property
    def load(self) -> Tuple[int, int]:
        return (self.engine.queue_depth, self.engine.live_slots)


class ServingFleet:
    """N engine replicas behind one prefix-aware router.

    ``replicas`` is a list of engines or ``(name, engine)`` pairs (a bare
    list names them ``replica0..N-1``). ``submit()`` routes one request and
    returns the replica's :class:`~.serving.Request`; ``step()`` runs one
    scheduler iteration on every replica; ``drain()`` steps until the
    whole fleet is idle. ``metrics()`` reports the routing counters
    (warm/cold/diverted, the warm-hit ratio), per-replica queue depth and
    load, the summed host-tier report and each replica's metrics under
    ``"replicas"``.
    """

    def __init__(self, replicas, policy: str = "prefix",
                 max_queue_depth: Optional[int] = None,
                 observability=False, telemetry=False):
        if not replicas:
            raise ValueError("ServingFleet needs at least one replica")
        self._replicas: List[_Replica] = []
        for i, r in enumerate(replicas):
            name, eng = (r if isinstance(r, (tuple, list))
                         else (f"replica{i}", r))
            self._replicas.append(_Replica(str(name), eng))
        names = [r.name for r in self._replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        if len({id(r.engine) for r in self._replicas}) != len(names):
            raise ValueError("the same engine object appears twice — "
                             "each replica needs its own engine")
        if policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}, "
                             f"got {policy!r}")
        self.policy = policy
        self.max_queue_depth = (None if max_queue_depth is None
                                else int(max_queue_depth))
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1 (or None)")
        self.counters = {
            "requests_submitted": 0, "routed_warm": 0, "routed_cold": 0,
            "routed_diverted": 0, "fleet_steps": 0,
            "drain_truncations": 0,
        }
        self._rr_next = 0            # round_robin policy cursor
        self._rr_cold = 0            # cold-placement tie-break cursor
        self._requests: List[Request] = []
        self._t_first = self._t_last = None
        self._metrics_reset_t = None
        self.last_drain_truncated = False
        # telemetry implies observability (alerts land timeline events
        # and stall dumps, both owned by the harness)
        _tcfg = TelemetryConfig.coerce(telemetry)
        if observability or _tcfg is not None:
            self._obs = (observability
                         if isinstance(observability, Observability)
                         else Observability(histograms=FLEET_HISTOGRAMS))
            self._obs.registry.adopt_counters(self.counters)
            self._share_histograms()
        else:
            self._obs = None
        # the telemetry plane: the fleet rollup plus every replica's
        # engine under a `replica` label, so burn-rate and anomaly rules
        # judge each replica separately
        self._telemetry = None
        if _tcfg is not None:
            self._telemetry = TelemetryPlane(
                _tcfg, on_alert=self._telemetry_alert)
            self._telemetry.register("fleet", self.metrics,
                                     counters=self.counters,
                                     skip=("replicas",))
            for rep in self._replicas:
                self._telemetry.register(
                    "fleet_replica", rep.engine.metrics,
                    labels={"replica": rep.name},
                    counters=getattr(rep.engine, "counters", None),
                    skip=("replicas", "groups"))

    def _share_histograms(self):
        """Point every observability-enabled replica's request-level
        latency histograms at the fleet-level objects (replicas without
        observability keep their zero-overhead None harness and do not
        feed the fleet distributions). A disaggregated replica re-shares
        onward to its two groups."""
        for rep in self._replicas:
            obs = rep.engine.observability
            if obs is None:
                continue
            for name in FLEET_SHARED_HISTOGRAMS:
                obs.registry.histograms[name] = \
                    self._obs.registry.histogram(name)
            resh = getattr(rep.engine, "_share_histograms", None)
            if resh is not None:
                resh()

    # -- routing ------------------------------------------------------
    def _match_tokens(self, rep: _Replica, toks: Tuple[int, ...]) -> int:
        """The longest page-aligned cached prefix of the prompt (an int
        tuple) on ``rep``, in tokens, capped at ``len(prompt) - 1``, as
        admission caps it, so the router never scores a match the engine
        could not use. A hash collision is guarded by the stored token
        length."""
        summ = rep.refresh()
        if not summ:
            return 0
        bs = rep.bs
        # no probe longer than the replica's longest cached path
        top = min((len(toks) - 1) // bs, rep.max_tokens // bs)
        for k in range(top, 0, -1):
            if summ.get(hash(toks[:k * bs])) == k * bs:
                return k * bs
        return 0

    def _route(self, prompt: np.ndarray) -> Tuple[_Replica, int, bool]:
        """Pick a replica: ``(replica, matched_tokens, diverted)``."""
        reps = self._replicas
        toks = tuple(int(t) for t in prompt)
        if self.policy == "round_robin":
            r = reps[self._rr_next % len(reps)]
            self._rr_next += 1
            return r, self._match_tokens(r, toks), False
        cap = self.max_queue_depth
        open_ = [i for i, r in enumerate(reps)
                 if cap is None or r.engine.queue_depth < cap]
        if not open_:                 # the whole fleet saturated: least
            open_ = list(range(len(reps)))      # loaded still wins
        diverted = False
        if self.policy == "prefix":
            scores = [self._match_tokens(r, toks) for r in reps]
            best = max(scores)
            if best > 0:
                warm_open = [i for i in open_ if scores[i] == best]
                if warm_open:
                    i = min(warm_open, key=lambda j: (reps[j].load, j))
                    return reps[i], best, False
                # the warm home(s) saturated: divert to the best SHORTER
                # match still open (a partial prefix skip beats a cold
                # prefill), else to cold capacity
                diverted = True
                warm_any = [i for i in open_ if scores[i] > 0]
                if warm_any:
                    sub = max(scores[i] for i in warm_any)
                    cands = [i for i in warm_any if scores[i] == sub]
                    i = min(cands, key=lambda j: (reps[j].load, j))
                    return reps[i], sub, True
        lo = min(reps[j].load for j in open_)
        cands = [j for j in open_ if reps[j].load == lo]
        i = cands[self._rr_cold % len(cands)]
        self._rr_cold += 1
        matched = (self._match_tokens(reps[i], toks)
                   if self.policy == "least_loaded" else 0)
        return reps[i], matched, diverted

    # -- public API ---------------------------------------------------
    def submit(self, prompt, gen: Optional[GenerationConfig] = None,
               priority: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Request:
        """Route one request onto a replica and enqueue it there. Returns
        the replica's :class:`~.serving.Request`: lifecycle, output and SLO
        semantics are the replica's own."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        rep, matched, diverted = self._route(prompt)
        req = rep.engine.submit(prompt, gen, priority=priority,
                                deadline_s=deadline_s)
        rep.routed += 1
        self.counters["requests_submitted"] += 1
        if matched > 0:
            rep.warm_routed += 1
            self.counters["routed_warm"] += 1
        else:
            self.counters["routed_cold"] += 1
        if diverted:
            self.counters["routed_diverted"] += 1
        self._requests.append(req)
        if self._obs is not None:
            self._obs.timeline.record(
                "route", req.req_id, replica=rep.name,
                matched_tokens=matched,
                **({"diverted": True} if diverted else {}))
        return req

    def step(self) -> bool:
        """One scheduler iteration on every replica, in turn. Returns True
        if any replica did work."""
        obs = self._obs
        t0 = time.perf_counter() if obs is not None else 0.0
        if self._t_first is None:
            self._t_first = time.perf_counter()
        did = False
        for rep in self._replicas:
            did = rep.engine.step() or did
        self.counters["fleet_steps"] += 1
        if did:
            self._t_last = time.perf_counter()
        if obs is not None:
            now = time.perf_counter()
            if did:
                obs.hist("step_ms").observe((now - t0) * 1e3)
            obs.sample_gauges(now, {
                f"queue_depth[{r.name}]": r.engine.queue_depth
                for r in self._replicas})
        if self._telemetry is not None:
            self._telemetry.on_step()
        return did

    @property
    def idle(self) -> bool:
        return all(r.engine.idle for r in self._replicas)

    def drain(self, max_steps: Optional[int] = None) -> int:
        """Step until every replica is idle (the shared
        :func:`~.serving._drain_loop`: a capped drain records the
        truncation; fleet-wide starvation raises)."""
        return _drain_loop(
            self, max_steps,
            starve_reason="fleet drain starved: no replica can make "
                          "progress",
            starve_error="fleet starved: no replica can admit its "
                         "queued requests (KV pools too small for the "
                         "in-flight mix?)")

    def _drain_truncated_event(self, n: int):
        if self._obs is not None:
            self._obs.timeline.record(
                "drain_truncated", steps=n,
                queue_depths={r.name: r.engine.queue_depth
                              for r in self._replicas})

    # -- reporting ----------------------------------------------------
    def scheduler_snapshot(self) -> Dict:
        return {
            "policy": self.policy,
            "queue_depths": {r.name: r.engine.queue_depth
                             for r in self._replicas},
            "live_slots": {r.name: r.engine.live_slots
                           for r in self._replicas},
            "replicas": {r.name: r.engine.scheduler_snapshot()
                         for r in self._replicas},
        }

    def metrics(self) -> Dict:
        c = self.counters
        rm = {r.name: r.engine.metrics() for r in self._replicas}
        wall = ((self._t_last - self._t_first)
                if self._t_first is not None and self._t_last is not None
                else 0.0)
        gen_tokens = sum(m["tokens_generated"] for m in rm.values())
        routed = c["routed_warm"] + c["routed_cold"]
        cut = self._metrics_reset_t
        ttfts = [r.ttft for r in self._requests
                 if r.ttft is not None
                 and (cut is None or (r.first_token_t or 0.0) >= cut)]
        off: Dict[str, int] = {}
        for r in self._replicas:
            for k, v in r.engine.offload_metrics().items():
                off[k] = off.get(k, 0) + v
        m = {
            "replicas_n": len(self._replicas),
            "requests_submitted": c["requests_submitted"],
            "requests_completed": sum(mm["requests_completed"]
                                      for mm in rm.values()),
            "tokens_generated": gen_tokens,
            "tokens_per_sec": (round(gen_tokens / wall, 3)
                               if wall > 0 else 0.0),
            "wall_time_s": round(wall, 6),
            "fleet_steps": c["fleet_steps"],
            "drain_truncations": c["drain_truncations"],
            "ttft_ms_mean": (round(float(np.mean(ttfts)) * 1e3, 3)
                             if ttfts else None),
            "ttft_ms_max": (round(float(np.max(ttfts)) * 1e3, 3)
                            if ttfts else None),
            "routing": {
                "policy": self.policy,
                "warm": c["routed_warm"],
                "cold": c["routed_cold"],
                "diverted": c["routed_diverted"],
                "warm_hit_ratio": (round(c["routed_warm"] / routed, 4)
                                   if routed else 0.0),
                "per_replica": {
                    r.name: {"routed": r.routed,
                             "warm_routed": r.warm_routed,
                             "queue_depth": r.engine.queue_depth,
                             "live_slots": r.engine.live_slots}
                    for r in self._replicas},
            },
            "offload": off,
            "replicas": rm,
            # each replica's decode roofline (a mixed fleet's replicas
            # price against different widths and classes)
            "roofline": {r.name: _replica_roofline(r.engine)
                         for r in self._replicas},
        }
        if self._obs is not None:
            obs = self._obs
            m["latency"] = obs.latency_snapshot()
            m["gauges"] = obs.gauges_snapshot()
            # replicas own their watchdogs; the fleet report must
            # surface ANY steady-state retrace in the fleet
            m["retrace_warnings"] = sum(
                mm.get("retrace_warnings", 0) for mm in rm.values())
            m["stall_dumps"] = (len(obs.stall_dumps)
                                + obs.stall_dumps_suppressed)
            m["timeline_events"] = len(obs.timeline)
            m["timeline_dropped"] = obs.timeline.dropped
        if self._telemetry is not None:
            m["telemetry"] = self._telemetry.snapshot()
        return m

    @property
    def telemetry(self) -> Optional[TelemetryPlane]:
        """The continuous telemetry plane, or None when disabled."""
        return self._telemetry

    def _telemetry_alert(self, alert: Dict):
        """Stamp an ``alert`` timeline event (replica attribution rides
        in the alert's labels); page-severity alerts also land a
        flight-recorder dump with the fleet scheduler snapshot."""
        obs = self._obs
        if obs is None:
            return
        obs.timeline.record(
            "alert", rule=alert.get("rule"),
            severity=alert.get("severity"), metric=alert.get("metric"),
            replica=(alert.get("labels") or {}).get("replica"),
            value=alert.get("value"), threshold=alert.get("threshold"))
        if (alert.get("severity") == "page"
                and self._telemetry.config.page_dumps):
            obs.stall_dump(
                f"telemetry alert: {alert.get('rule')} on "
                f"{alert.get('metric')}", self.scheduler_snapshot(),
                metrics={"alert": alert})

    def reset_metrics(self):
        """Restart the measurement window on the router and every
        replica (each replica's retrace watchdog arms)."""
        for k in ("requests_submitted", "routed_warm", "routed_cold",
                  "routed_diverted", "fleet_steps", "drain_truncations"):
            self.counters[k] = 0
        for r in self._replicas:
            r.routed = r.warm_routed = 0
            r.engine.reset_metrics()
        self._requests = [r for r in self._requests if not r.done]
        self._t_first = self._t_last = None
        self._metrics_reset_t = time.perf_counter()
        if self._obs is not None:
            # the replicas' reset_window() replaced their histogram
            # objects — restart the fleet window and re-share
            self._obs.reset_window()
            self._share_histograms()

    # -- observability export -----------------------------------------
    @property
    def observability(self) -> Optional[Observability]:
        return self._obs

    def _require_obs(self) -> Observability:
        if self._obs is None:
            raise RuntimeError(
                "observability is disabled for this fleet; construct "
                "with ServingFleet(..., observability=True)")
        return self._obs

    def export_trace(self, path: str) -> str:
        """The router's chrome trace (route events, the queue-depth
        gauges) with every replica's roofline track."""
        from ..observability.roofline import roofline_chrome_events
        events = []
        for r in self._replicas:
            report = _replica_roofline(r.engine)
            report = {"variants": {
                f"{r.name}:{k}": v
                for k, v in report["variants"].items()}}
            events.extend(roofline_chrome_events(report))
        return self._require_obs().export_chrome(
            path, process_name="paddle_tpu serving fleet",
            extra_events=events)

    def write_timeline(self, path: str) -> str:
        # the summary tooling reads header["roofline"]["variants"]:
        # report the FIRST replica's model there (fleets are homogeneous
        # in practice) and the full per-replica map beside
        roof = {r.name: _replica_roofline(r.engine)
                for r in self._replicas}
        first = self._replicas[0].name if self._replicas else None
        return self._require_obs().write_jsonl(
            path, header={"mode": "serving", "fleet": True,
                          "policy": self.policy,
                          "replicas": [r.name for r in self._replicas],
                          "roofline": roof.get(first),
                          "roofline_replicas": roof})

    # -- the program audit (ROADMAP A12) ------------------------------

    def program_specs(self, register: bool = True):
        _later_slice("the static program audit", "A12")

    def audit(self, register: bool = True):
        _later_slice("the static program audit", "A12")
