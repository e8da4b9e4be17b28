"""Open-loop load generation and deadline-aware driving (the JAX
package's ``serve/loadgen.py``).

A closed loop (submit a trace, run it to the end) throttles itself and
cannot show queueing collapse. Here requests arrive on a schedule that
ignores how busy the fleet is, each may carry a deadline
(:class:`~.policy.SloSpec`), and the driver measures what share of the
arrivals met their TTFT/TPOT targets at that rate.

- **Arrival processes**: seeded stdlib ``random`` generators
  (:func:`poisson_arrivals`, :func:`bursty_arrivals`, a two-state
  Markov-modulated Poisson process) and bounded-Pareto
  :func:`heavy_tailed_lengths`; :func:`make_schedule` composes them into
  ``(arrival_s, request_spec)`` rows. Pure functions of their seeds, and
  the JAX package's draws exactly (the same generator, the same calls).
- **:class:`OpenLoopDriver`** submits a schedule through a
  :class:`~.router.Router` or a bare :class:`~.engine.ServeEngine` on a
  ``virtual`` clock (``tick_s`` of virtual time per fleet step; the
  accounting is a function of the schedule, the tokens and the iteration
  count) or the ``wall`` clock (real sleeps; ``arrival_s`` and the SLO
  go into ``submit``, so the engines stamp real verdicts).
- **Knobs**: :func:`parse_arrival` (``HSTD_SERVE_ARRIVAL``),
  :func:`parse_arrival_seed` (``HSTD_SERVE_ARRIVAL_SEED``), and
  :func:`~.policy.parse_slo`, re-exported here with
  :class:`~.policy.SloSpec` so both import paths work.
"""

from __future__ import annotations

import os
import random
import time
from typing import Optional, Sequence

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.report import (
    percentile,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.policy import (  # noqa: F401
    ENV_SLO_TPOT,
    ENV_SLO_TTFT,
    SloSpec,
    parse_slo,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.scheduler import (
    WAITING,
    Request,
)

ENV_ARRIVAL = "HSTD_SERVE_ARRIVAL"
ENV_ARRIVAL_SEED = "HSTD_SERVE_ARRIVAL_SEED"

PROCESSES = ("poisson", "bursty")
CLOCKS = ("virtual", "wall")

# the driver's miss-attribution phases: the virtual clock observes the
# scheduler's transitions only (arrival, admit, first token, finish); an
# earlier phase wins a tie
MISS_PHASES = ("queue", "prefill", "decode")


# -- knob parsing ------------------------------------------------------------


def parse_arrival(spec=None):
    """The arrival-process knob: ``closed`` (None), ``poisson:RATE``
    (requests/s) or ``bursty:RATE_HI,RATE_LO,P_SWITCH``. None reads
    ``HSTD_SERVE_ARRIVAL`` (default ``closed``). Returns None or
    ``(process, params)``."""
    if spec is None:
        spec = os.environ.get(ENV_ARRIVAL, "closed") or "closed"
    s = str(spec).strip().lower()
    if s in ("", "closed"):
        return None
    name, _, argstr = s.partition(":")
    try:
        if name == "poisson":
            rate = float(argstr)
            if not rate > 0:
                raise ValueError
            return ("poisson", {"rate": rate})
        if name == "bursty":
            hi, lo, p = (float(x) for x in argstr.split(","))
            if not (hi > 0 and lo > 0 and 0 <= p <= 1):
                raise ValueError
            return ("bursty", {"rate_hi": hi, "rate_lo": lo,
                               "p_switch": p})
    except ValueError:
        pass
    raise ValueError(
        f"unparseable {ENV_ARRIVAL} value {spec!r}: expected "
        "closed | poisson:RATE | bursty:RATE_HI,RATE_LO,P_SWITCH")


def parse_arrival_seed(spec=None) -> int:
    """The schedule seed: any int. None reads ``HSTD_SERVE_ARRIVAL_SEED``
    (default 0)."""
    if spec is None:
        spec = os.environ.get(ENV_ARRIVAL_SEED, "0") or "0"
    try:
        return int(str(spec).strip() or "0")
    except ValueError:
        raise ValueError(f"unparseable {ENV_ARRIVAL_SEED} value "
                         f"{spec!r}: expected an integer")


# -- arrival processes and lengths ---------------------------------------------


def poisson_arrivals(rate: float, n: int, seed: int = 0) -> list:
    """``n`` arrival offsets (seconds from the schedule's start) with
    exponential gaps at ``rate`` requests/s."""
    if not rate > 0:
        raise ValueError(f"rate must be > 0, got {rate!r}")
    rng = random.Random(seed)
    t, out = 0.0, []
    for _ in range(n):
        t += rng.expovariate(rate)
        out.append(t)
    return out


def bursty_arrivals(rate_hi: float, rate_lo: float, p_switch: float,
                    n: int, seed: int = 0) -> list:
    """Two-state Markov-modulated Poisson arrivals: each gap draws at the
    current state's rate (starting hot) and the state flips with
    probability ``p_switch`` after every arrival."""
    if not (rate_hi > 0 and rate_lo > 0):
        raise ValueError("rates must be > 0")
    if not 0 <= p_switch <= 1:
        raise ValueError(f"p_switch must be in [0, 1], got {p_switch!r}")
    rng = random.Random(seed)
    hot, t, out = True, 0.0, []
    for _ in range(n):
        t += rng.expovariate(rate_hi if hot else rate_lo)
        out.append(t)
        if rng.random() < p_switch:
            hot = not hot
    return out


def heavy_tailed_lengths(n: int, lo: int, hi: int, seed: int = 0,
                         alpha: float = 1.5) -> list:
    """``n`` bounded-Pareto(``alpha``) lengths in ``[lo, hi]``: most near
    ``lo``, an occasional one near ``hi``."""
    if not 0 < lo <= hi:
        raise ValueError(f"need 0 < lo <= hi, got ({lo}, {hi})")
    if not alpha > 0:
        raise ValueError(f"alpha must be > 0, got {alpha!r}")
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        u = max(rng.random(), 1e-12)
        out.append(int(min(hi, max(lo, round(lo / u ** (1.0 / alpha))))))
    return out


def make_schedule(n_requests: int, vocab_size: int, *,
                  process: str = "poisson", rate: float = 1.0,
                  rate_lo: Optional[float] = None,
                  p_switch: float = 0.1, seed: int = 0,
                  prompt_lo: int = 4, prompt_hi: int = 32,
                  new_lo: int = 4, new_hi: int = 32,
                  alpha: float = 1.5,
                  eos_token_id: Optional[int] = None,
                  groups: Sequence[str] = (),
                  deadline_s: Optional[float] = None,
                  priorities: Sequence[int] = ()) -> list:
    """An arrival process with heavy-tailed prompt and output lengths as
    ``[(arrival_s, spec), ...]`` sorted by arrival, each spec
    ``{"prompt": [ids], "max_new_tokens": n}`` plus ``group`` (round-robin
    over ``groups``), ``deadline_s`` (a scalar, or a sequence
    round-robin) and ``priority`` (round-robin over ``priorities``).
    Prompts avoid ``eos_token_id``. Pure in ``seed``."""
    if process == "poisson":
        arrivals = poisson_arrivals(rate, n_requests, seed)
    elif process == "bursty":
        arrivals = bursty_arrivals(
            rate, rate_lo if rate_lo is not None else rate / 4.0,
            p_switch, n_requests, seed)
    else:
        raise ValueError(f"unknown arrival process {process!r}: "
                         f"expected {' | '.join(PROCESSES)}")
    rng = random.Random(f"{seed}:lengths")
    plens = heavy_tailed_lengths(n_requests, prompt_lo, prompt_hi,
                                 seed=rng.randrange(1 << 30), alpha=alpha)
    nlens = heavy_tailed_lengths(n_requests, new_lo, new_hi,
                                 seed=rng.randrange(1 << 30), alpha=alpha)
    tok_rng = random.Random(f"{seed}:tokens")
    out = []
    for i, arrival in enumerate(arrivals):
        prompt = []
        while len(prompt) < plens[i]:
            tok = tok_rng.randrange(vocab_size)
            if tok != eos_token_id:
                prompt.append(tok)
        spec = {"prompt": prompt, "max_new_tokens": nlens[i]}
        if groups:
            spec["group"] = groups[i % len(groups)]
        if deadline_s is not None:
            spec["deadline_s"] = float(
                deadline_s[i % len(deadline_s)]
                if isinstance(deadline_s, (list, tuple)) else deadline_s)
        if priorities:
            spec["priority"] = int(priorities[i % len(priorities)])
        out.append((arrival, spec))
    return out


# -- the driver --------------------------------------------------------------

_SPEC_KEYS = ("temperature", "top_k", "top_p", "seed", "group",
              "deadline_s", "priority")


class OpenLoopDriver:
    """Submit a ``[(arrival_s, spec), ...]`` schedule through ``target``
    (a :class:`~.router.Router` or a :class:`~.engine.ServeEngine`) at
    its arrival times, then drain.

    ``clock="virtual"``: arrivals interleave with fleet steps on a
    driver-owned clock (``tick_s`` per step; an idle fleet jumps to the
    next arrival), and the driver polls the scheduler transitions after
    each step to stamp virtual admit, first-token and finish times, so
    :meth:`summary` is a function of (schedule, tokens, iteration
    count). The SLO is not passed to the engines here (their wall-clock
    verdicts would vary), ``arrival_s`` is.

    ``clock="wall"``: real sleeps to each arrival; ``arrival_s`` and
    ``slo`` go into ``submit`` and the engines stamp the verdicts. Warmup
    runs before the clock starts in both modes."""

    def __init__(self, target, schedule, *, clock: str = "virtual",
                 tick_s: float = 0.001, slo: Optional[SloSpec] = None,
                 process: str = "custom", rate: Optional[float] = None):
        if clock not in CLOCKS:
            raise ValueError(f"unknown clock {clock!r}: expected "
                             f"{' | '.join(CLOCKS)}")
        if not tick_s > 0:
            raise ValueError(f"tick_s must be > 0, got {tick_s!r}")
        self.target = target
        # stable: simultaneous arrivals keep the schedule's order
        self.schedule = sorted(schedule, key=lambda row: row[0])
        self.clock = clock
        self.tick_s = float(tick_s)
        self.slo = slo
        self.process = str(process)
        self.rate = rate
        self._recs: list[dict] = []
        self._ran = False

    # -- submission ----------------------------------------------------------

    def _submit(self, arrival: float, spec: dict, t0: float):
        kw = {k: spec[k] for k in _SPEC_KEYS if k in spec}
        req = self.target.submit(
            spec["prompt"], spec["max_new_tokens"],
            arrival_s=t0 + arrival,
            slo=self.slo if self.clock == "wall" else None, **kw)
        if getattr(req, "rejected", False):
            # a rate-limit rejection: recorded, never served
            self._recs.append({"arrival": arrival,
                               "group": spec.get("group", ""),
                               "rejected": True})
            return req
        rec = {"arrival": arrival, "req": req,
               "group": spec.get("group", "")}
        if "deadline_s" in spec:
            rec["deadline_s"] = float(spec["deadline_s"])
        self._recs.append(rec)
        return req

    # -- clock loops ---------------------------------------------------------

    def _poll(self, vt: float) -> None:
        """Stamp virtual times for the transitions since the last step
        (admit, first token, finish); several within one step all stamp
        at this tick."""
        for rec in self._recs:
            if "v_finish" in rec or "req" not in rec:
                continue
            req = rec["req"]
            if "v_admit" not in rec and req.state != WAITING:
                rec["v_admit"] = vt
            if "v_first" not in rec and req.first_token_t is not None:
                rec["v_first"] = vt
            if req.finish_t is not None:
                rec["v_finish"] = vt

    def _set_policy_clock(self, now: float) -> None:
        """Pin every scheduler's admission-policy clock to the virtual
        timeline, so aging under ``policy='slo'`` replays exactly."""
        for eng in getattr(self.target, "engines", None) or [self.target]:
            sched = getattr(eng, "sched", None)
            if sched is not None:
                sched.policy_now = now

    def _run_virtual(self, t0: float) -> None:
        idx, vt = 0, 0.0
        while idx < len(self.schedule) or self.target.has_work():
            if (idx < len(self.schedule) and not self.target.has_work()
                    and vt < self.schedule[idx][0]):
                vt = self.schedule[idx][0]
            while (idx < len(self.schedule)
                   and self.schedule[idx][0] <= vt):
                arrival, spec = self.schedule[idx]
                idx += 1
                self._submit(arrival, spec, t0)
            if self.target.has_work():
                self._set_policy_clock(t0 + vt)
                self.target.step()
                vt += self.tick_s
                self._poll(vt)

    def _run_wall(self, t0: float) -> None:
        idx = 0
        while idx < len(self.schedule):
            now = time.perf_counter() - t0
            arrival, spec = self.schedule[idx]
            if arrival <= now:
                self._submit(arrival, spec, t0)
                idx += 1
            elif self.target.has_work():
                # serve while the next arrival is in the future; an idle
                # fleet sleeps instead of spinning
                self.target.step()
            else:
                time.sleep(min(arrival - now, 0.05))

    def run(self) -> dict:
        """Drive the schedule to the end; the target's {rid: Request}.
        One ``open_loop`` event first; the target's ``run()`` drains the
        tail and emits the report."""
        if self._ran:
            raise RuntimeError("OpenLoopDriver.run() is one-shot: "
                               "build a fresh driver per run")
        self._ran = True
        extra = {}
        if self.rate is not None:
            extra["rate"] = float(self.rate)
        if self.slo is not None:
            if self.slo.ttft_s is not None:
                extra["slo_ttft_s"] = float(self.slo.ttft_s)
            if self.slo.tpot_s is not None:
                extra["slo_tpot_s"] = float(self.slo.tpot_s)
        obs.serve("open_loop", process=self.process, clock=self.clock,
                  requests=len(self.schedule), **extra)
        sampled = any(spec.get("temperature", 0) > 0
                      for _, spec in self.schedule)
        self.target.warmup(sampled=sampled)
        t0 = time.perf_counter()
        if self.clock == "virtual":
            self._run_virtual(t0)
        else:
            self._run_wall(t0)
        finished = self.target.run()
        if self.clock == "virtual":
            # what the loop's last poll missed stamps one tick past it
            vt = max((rec.get("v_finish", 0.0) for rec in self._recs),
                     default=0.0) + self.tick_s
            self._poll(vt)
        return finished

    # -- accounting ----------------------------------------------------------

    def _virtual_phases(self, rec: dict) -> dict:
        admit = rec.get("v_admit", rec.get("v_finish", rec["arrival"]))
        first = rec.get("v_first", rec.get("v_finish", admit))
        return {
            "queue": max(admit - rec["arrival"], 0.0),
            "prefill": max(first - admit, 0.0),
            "decode": max(rec.get("v_finish", first) - first, 0.0),
        }

    @staticmethod
    def _generated(req: Request) -> int:
        return (len(req.prompt) - req.orig_prompt_len) + len(req.output)

    def summary(self) -> dict:
        """The run's goodput accounting: ``requests``/``process``/
        ``clock`` always; with an SLO ``slo_attainment``, ``slo_met``/
        ``slo_missed``, ``goodput_tokens`` (tokens of the requests that
        met it), ``group_slo_attainment``, ``miss_phases`` and
        ``dominant_miss_phase``; in virtual mode the TTFT and TPOT
        percentiles of the virtual timeline; ``rate_limited`` rejections
        (out of the attainment), and ``deadline_misses`` /
        ``deadline_miss_frac`` for schedules with deadlines."""
        out: dict = {"requests": len(self._recs), "clock": self.clock,
                     "process": self.process}
        if self.rate is not None:
            out["rate"] = self.rate
        served = [rec for rec in self._recs if "req" in rec]
        if len(served) < len(self._recs):
            out["rate_limited"] = len(self._recs) - len(served)
        if self.clock == "virtual":
            ttfts = sorted(rec["v_first"] - rec["arrival"]
                           for rec in self._recs if "v_first" in rec)
            tpots = sorted(
                (rec["v_finish"] - rec["v_first"])
                / max(self._generated(rec["req"]) - 1, 1)
                for rec in self._recs
                if "v_first" in rec and "v_finish" in rec)
            for label, vals in (("ttft", ttfts), ("tpot", tpots)):
                if vals:
                    out[f"{label}_p50_s"] = round(percentile(vals, 0.50), 6)
                    out[f"{label}_p95_s"] = round(percentile(vals, 0.95), 6)
                    out[f"{label}_p99_s"] = round(percentile(vals, 0.99), 6)
        dl_recs = [rec for rec in served if "deadline_s" in rec]
        if dl_recs:
            # wall mode trusts the engine's verdict; virtual mode judges
            # on the driver's timeline
            if self.clock == "wall":
                misses = sum(1 for rec in dl_recs
                             if rec["req"].deadline_miss)
            else:
                misses = sum(
                    1 for rec in dl_recs
                    if rec.get("v_finish", float("inf")) - rec["arrival"]
                    > rec["deadline_s"])
            out["deadline_misses"] = misses
            out["deadline_miss_frac"] = round(misses / len(dl_recs), 4)
        if self.slo is None:
            return out
        met = 0
        goodput_tokens = 0
        groups: dict = {}
        miss_phases = dict.fromkeys(MISS_PHASES, 0)
        for rec in served:
            req = rec["req"]
            if self.clock == "wall":
                ok = bool(req.slo_met)
            else:
                ok = True
                tokens = self._generated(req)
                first = rec.get("v_first")
                if self.slo.ttft_s is not None:
                    ok &= (first is not None
                           and first - rec["arrival"] <= self.slo.ttft_s)
                if self.slo.tpot_s is not None:
                    finish = rec.get("v_finish")
                    ok &= (first is not None and finish is not None
                           and (finish - first) / max(tokens - 1, 1)
                           <= self.slo.tpot_s)
            met += int(ok)
            if ok:
                goodput_tokens += self._generated(req)
            else:
                if self.clock == "wall":
                    phases = {ph: req.phase_s.get(ph, 0.0)
                              for ph in MISS_PHASES}
                    # pre-submit backlog and preemption stalls are time
                    # not served: queue, from the deadline's side
                    if req.arrival_s is not None and req.submit_t:
                        phases["queue"] += max(
                            req.submit_t - req.arrival_s, 0.0)
                    phases["queue"] += req.phase_s.get("preempted", 0.0)
                else:
                    phases = self._virtual_phases(rec)
                dom = max(MISS_PHASES,
                          key=lambda ph: (phases[ph],
                                          -MISS_PHASES.index(ph)))
                miss_phases[dom] += 1
            acc = groups.setdefault(rec["group"], [0, 0])
            acc[0] += int(ok)
            acc[1] += 1
        total = len(served)
        out["slo_met"] = met
        out["slo_missed"] = total - met
        out["slo_attainment"] = round(met / total, 4) if total else 0.0
        out["goodput_tokens"] = goodput_tokens
        out["group_slo_attainment"] = {
            g: round(m / t, 4) for g, (m, t) in sorted(groups.items())
            if t}
        out["miss_phases"] = {ph: n for ph, n in miss_phases.items() if n}
        misses = [(n, ph) for ph, n in miss_phases.items() if n]
        out["dominant_miss_phase"] = (
            max(misses, key=lambda x: (x[0], -MISS_PHASES.index(x[1])))[1]
            if misses else None)
        return out
