"""First-class client populations: heterogeneous cohorts as config.

(A copy of ``repro.core.population``, which is pure numpy: the port keeps
its own so that it imports nothing of the JAX package. Schedules are
bit-identical to the reference's, tests/test_torch_engine.py.)

The paper simulates a *homogeneous* fleet — one delay distribution, one
participation fraction — but the SFL literature studies device-tiered
cohorts (HASFL, arXiv:2506.08426) and unstable/correlated participation
(arXiv:2509.17398). This module makes the client fleet an explicit,
hashable spec:

  Cohort             one named device tier: size, delay model, comm scale,
                     participation fraction, and an availability process
                     ('iid' per-round draws, or a 'markov' up/down chain
                     for bursty correlated dropouts).
  ClientPopulation   a tuple of cohorts composing into per-client (M,)
                     system vectors; `straggler.make_schedule` samples
                     delays / participation / availability per cohort.
  parse_population   the CLI grammar ("tiered:4x1.0,12x0.2").

Everything is a frozen dataclass of literals, so a population can sit
inside SFLConfig (which jit treats as a static arg) and hash/compare like
any other config. The legacy scalar knobs (`straggler_rate`,
`participation`) remain as a deprecated single-cohort shorthand resolved
through `ClientPopulation.resolve(sfl)`; a single-iid-cohort population
reproduces the historical schedule RNG draws bit-for-bit
(tests/test_population.py pins this).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["DelayModel", "Cohort", "ClientPopulation", "parse_population",
           "AvailRow"]


class AvailRow:
    """One version's availability, bucketed by cohort — the streaming mask
    protocol between schedule samplers and the sparse DES.

    Instead of an (M,) dense 0/1 row, availability is one tagged record per
    cohort (cohorts are contiguous client-id ranges):

      ('all',)             every client in the cohort is available
      ('none',)            tier down / nobody drawn
      ('ids', ids)         exactly ``ids`` (sorted GLOBAL client ids)
      ('not_ids', ids)     everyone EXCEPT ``ids`` (sorted down-set) — the
                           natural shape of a mostly-up Markov chain

    The DES's cohort idle index consumes this directly, so a version's
    candidate selection costs O(K·log M) plus the size of the sparse
    records — never an O(M) scan — and a million-client schedule is never
    densified. ``from_mask`` adapts a dense row (the bit-exact reference
    path); ``densify`` expands back for tests.
    """

    __slots__ = ("bounds", "kinds", "ids", "sets")

    def __init__(self, bounds, kinds, ids):
        self.bounds = bounds            # [(lo, hi)] per cohort
        self.kinds = kinds              # ['all'|'none'|'ids'|'not_ids']
        self.ids = ids                  # sorted global-id arrays or None
        # O(1) membership for 'not_ids' admission checks, built lazily
        self.sets = [None] * len(kinds)

    def down_set(self, c: int):
        if self.sets[c] is None:
            self.sets[c] = frozenset(self.ids[c].tolist())
        return self.sets[c]

    @classmethod
    def from_mask(cls, mask: np.ndarray, bounds) -> "AvailRow":
        """Bucket a dense (M,) 0/1 row by cohort (O(M) — the adapter for
        dense-schedule-driven paths, which already hold the row)."""
        mask = np.asarray(mask)
        kinds, ids = [], []
        for lo, hi in bounds:
            nz = np.flatnonzero(mask[lo:hi] > 0)
            if nz.size == hi - lo:
                kinds.append("all")
                ids.append(None)
            elif nz.size == 0:
                kinds.append("none")
                ids.append(None)
            else:
                kinds.append("ids")
                ids.append(nz.astype(np.int64) + lo)
        return cls(list(bounds), kinds, ids)

    def densify(self, n_clients: int) -> np.ndarray:
        row = np.zeros(n_clients, np.float32)
        for c, (lo, hi) in enumerate(self.bounds):
            k = self.kinds[c]
            if k == "all":
                row[lo:hi] = 1.0
            elif k == "ids":
                row[self.ids[c]] = 1.0
            elif k == "not_ids":
                row[lo:hi] = 1.0
                row[self.ids[c]] = 0.0
        return row


@dataclasses.dataclass(frozen=True)
class DelayModel:
    """Per-round client compute times (seconds, simulated).

    t_m = base * (1 + Exp(scale))  — heterogeneous, heavy-tailed (paper §5
    follows [8,12] and samples from an exponential distribution).
    ``hetero`` optionally fixes a per-client speed multiplier (systematic
    stragglers rather than purely stochastic ones).
    """
    base: float = 1.0
    scale: float = 1.0
    hetero: Optional[Tuple[float, ...]] = None

    @property
    def stochastic(self) -> bool:
        return self.scale > 0 or self.hetero is not None

    def sample(self, rng: np.random.Generator, n_clients: int,
               n_rounds: int) -> np.ndarray:
        t = self.base * (1.0 + rng.exponential(self.scale,
                                               size=(n_rounds, n_clients)))
        if self.hetero is not None:
            t = t * np.asarray(self.hetero)[None, :]
        return t


@dataclasses.dataclass(frozen=True)
class Cohort:
    """One device tier of the fleet.

    availability='iid'    : each round draws an independent participation
                            mask (fraction ``participation``, always >=1
                            active in the cohort — the legacy behaviour).
    availability='markov' : each client carries an up/down state; per round
                            an up client drops with ``p_dropout`` and a
                            down client recovers with ``p_recover`` (bursty,
                            temporally correlated dropouts). A
                            ``participation`` fraction < 1 is drawn on top
                            of the chain.
    availability='markov-shared' : ONE up/down chain for the whole cohort —
                            every client drops and recovers together
                            (tier-wide outages: a rack, a carrier, a
                            region). One uniform draw per round per cohort;
                            ``participation`` < 1 still draws per client on
                            top while the tier is up.
    ``t_comm_scale`` scales the schedule's per-round t_comm for this tier
    (slow uplinks); the round is bounded by the slowest *active* link.
    """
    name: str
    n: int
    delay: DelayModel = DelayModel(base=1.0, scale=0.0)
    participation: float = 1.0
    availability: str = "iid"
    p_dropout: float = 0.0
    p_recover: float = 0.5
    t_comm_scale: float = 1.0

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"cohort {self.name!r}: n must be >= 1")
        if self.availability not in ("iid", "markov", "markov-shared"):
            raise ValueError(f"cohort {self.name!r}: availability must be "
                             f"'iid'|'markov'|'markov-shared', "
                             f"got {self.availability!r}")
        if not (0.0 < self.participation <= 1.0):
            raise ValueError(f"cohort {self.name!r}: participation must be "
                             f"in (0, 1], got {self.participation}")


@dataclasses.dataclass(frozen=True)
class ClientPopulation:
    """The whole client fleet as an ordered tuple of cohorts.

    Client index space is the concatenation of the cohorts in order:
    cohort 0 owns clients [0, n0), cohort 1 owns [n0, n0+n1), ...
    """
    cohorts: Tuple[Cohort, ...]

    def __post_init__(self):
        if not self.cohorts:
            raise ValueError("population needs at least one cohort")
        names = [c.name for c in self.cohorts]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate cohort names: {names}")

    # -- composition into per-client (M,) vectors ---------------------------

    @property
    def n_clients(self) -> int:
        return sum(c.n for c in self.cohorts)

    def slices(self) -> List[slice]:
        """Per-cohort client-index slices, in cohort order."""
        out, i = [], 0
        for c in self.cohorts:
            out.append(slice(i, i + c.n))
            i += c.n
        return out

    def cohort_ids(self) -> np.ndarray:
        """(M,) int array: which cohort each client belongs to."""
        return np.concatenate([np.full(c.n, i, np.int64)
                               for i, c in enumerate(self.cohorts)])

    def t_comm_scales(self) -> np.ndarray:
        """(M,) per-client communication-time multipliers."""
        return np.concatenate([np.full(c.n, c.t_comm_scale, np.float64)
                               for c in self.cohorts])

    @property
    def uniform_comm(self) -> bool:
        return all(c.t_comm_scale == 1.0 for c in self.cohorts)

    def client_vectors(self) -> Dict[str, np.ndarray]:
        """The fleet's per-client (M,) system vectors, expanded from the
        cohort spec — everything about population state that scales with
        M. This is the sharding surface: sharding/specs.population_pspecs
        lays these out over the mesh 'data' axis (the ring store's slot
        dim rides the same axis), so fleet vectors never have to fit one
        host/device past small M."""
        def expand(field, dtype):
            return np.concatenate([np.full(c.n, field(c), dtype)
                                   for c in self.cohorts])
        return {
            "cohort_id": self.cohort_ids(),
            "t_comm_scale": self.t_comm_scales(),
            "delay_base": expand(lambda c: c.delay.base, np.float64),
            "delay_scale": expand(lambda c: c.delay.scale, np.float64),
            "participation": expand(lambda c: c.participation, np.float64),
        }

    def sampler(self) -> "PopulationSampler":
        return PopulationSampler(self)

    def describe(self) -> str:
        return " + ".join(
            f"{c.name}[n={c.n}, base={c.delay.base:g}, "
            f"scale={c.delay.scale:g}, part={c.participation:g}, "
            f"{c.availability}"
            + (f"(drop={c.p_dropout:g}/rec={c.p_recover:g})"
               if c.availability.startswith("markov") else "")
            + (f", comm×{c.t_comm_scale:g}" if c.t_comm_scale != 1.0 else "")
            + "]" for c in self.cohorts)

    # -- legacy shorthand ---------------------------------------------------

    @classmethod
    def single(cls, n_clients: int, *, delay: Optional[DelayModel] = None,
               straggler_scale: float = 0.0,
               participation: float = 1.0) -> "ClientPopulation":
        """One homogeneous iid cohort — the legacy scalar-knob fleet."""
        return cls(cohorts=(Cohort(
            name="all", n=n_clients,
            delay=delay or DelayModel(base=1.0, scale=straggler_scale),
            participation=participation),))

    @classmethod
    def resolve(cls, sfl) -> "ClientPopulation":
        """The one resolution path from an SFLConfig: an explicit
        ``sfl.population`` wins; otherwise the deprecated scalar knobs
        (``straggler_rate``, ``participation``) become a single cohort."""
        pop = getattr(sfl, "population", None)
        if pop is not None:
            if pop.n_clients != sfl.n_clients:
                raise ValueError(
                    f"population has {pop.n_clients} clients but "
                    f"sfl.n_clients={sfl.n_clients}")
            return pop
        return cls.single(sfl.n_clients, straggler_scale=sfl.straggler_rate,
                          participation=sfl.participation)


class PopulationSampler:
    """Stateful per-round sampler (host-side, numpy RNG).

    Draw order per round is pinned to the historical scalar path — for each
    cohort in order: the delay draw (only when that cohort's delay model is
    stochastic), then for each cohort in order: the availability /
    participation draw — so a single-iid-cohort population consumes the RNG
    stream exactly like the legacy ``make_schedule`` loop and reproduces its
    arrays bit-for-bit. Markov chains start all-up and take one transition
    step before round 0 is read.
    """

    def __init__(self, population: ClientPopulation):
        self.pop = population
        self._slices = population.slices()
        self._up = [np.ones(c.n, bool) for c in population.cohorts]

    def delays_row(self, rng: np.random.Generator) -> np.ndarray:
        row = np.empty(self.pop.n_clients, np.float64)
        for c, sl in zip(self.pop.cohorts, self._slices):
            row[sl] = (c.delay.sample(rng, c.n, 1)[0] if c.delay.stochastic
                       else np.full(c.n, c.delay.base))
        return row

    def participation_row(self, rng: np.random.Generator) -> np.ndarray:
        from repro_torch.core.straggler import participation_mask
        row = np.empty(self.pop.n_clients, np.float32)
        for i, (c, sl) in enumerate(zip(self.pop.cohorts, self._slices)):
            if c.availability == "markov":
                u = rng.random(c.n)
                self._up[i] = np.where(self._up[i], u >= c.p_dropout,
                                       u < c.p_recover)
                m = self._up[i].astype(np.float32)
                if c.participation < 1.0:
                    m = m * participation_mask(rng, c.n, c.participation)
            elif c.availability == "markov-shared":
                # one transition draw for the whole tier: correlated,
                # rack/carrier-level outages — every client flips together
                u = rng.random()
                up = bool(self._up[i][0])
                up = (u >= c.p_dropout) if up else (u < c.p_recover)
                self._up[i][:] = up
                m = np.full(c.n, float(up), np.float32)
                if up and c.participation < 1.0:
                    m = m * participation_mask(rng, c.n, c.participation)
            else:
                m = participation_mask(rng, c.n, c.participation)
            row[sl] = m
        return row


# ---------------------------------------------------------------------------
# CLI grammar
# ---------------------------------------------------------------------------

def parse_population(spec: str, *,
                     straggler_scale: float = 0.0) -> ClientPopulation:
    """Parse the ``--population`` CLI grammar into a ClientPopulation.

        tiered:<n>x<speed>[@<part>][~<p_drop>/<p_recover>][%<comm_scale>],...

    Each comma-separated item is one cohort of ``n`` clients running at
    relative ``speed`` (delay base = 1/speed, so speed 0.2 is 5× slower
    than speed 1.0). Optional suffixes: ``@0.5`` participation fraction,
    ``~0.05/0.2`` per-client Markov availability (P(up→down)/P(down→up)),
    ``~~0.05/0.2`` a SHARED per-cohort chain (the whole tier drops and
    recovers together — correlated outages), ``%4`` communication-time
    scale. ``straggler_scale`` is the shared exponential jitter applied to
    every cohort (the CLI's --straggler-scale).

    Examples:
        tiered:4x1.0,12x0.2            4 fast + 12 five-times-slower clients
        tiered:4x1.0,4x0.25~0.05/0.2   slow tier with bursty Markov dropouts
        tiered:4x1.0,4x0.25~~0.05/0.2  slow tier with tier-WIDE outages
    """
    body = spec.split(":", 1)[1] if spec.startswith("tiered:") else spec
    cohorts = []
    for i, item in enumerate(x for x in body.split(",") if x.strip()):
        item = item.strip()
        comm_scale = 1.0
        if "%" in item:
            item, tail = item.rsplit("%", 1)
            comm_scale = float(tail)
        availability, p_drop, p_rec = "iid", 0.0, 0.5
        if "~" in item:
            item, tail = item.rsplit("~", 1)
            availability = "markov"
            if item.endswith("~"):          # `~~p/p`: shared cohort chain
                item = item[:-1]
                availability = "markov-shared"
            p_drop, p_rec = (float(x) for x in tail.split("/"))
        part = 1.0
        if "@" in item:
            item, tail = item.rsplit("@", 1)
            part = float(tail)
        try:
            n_str, speed_str = item.split("x", 1)
            n, speed = int(n_str), float(speed_str)
        except ValueError:
            raise ValueError(
                f"bad cohort spec {item!r} in {spec!r}; expected "
                "<n>x<speed>[@part][~p_drop/p_recover][%comm_scale]")
        if speed <= 0:
            raise ValueError(f"cohort speed must be > 0, got {speed}")
        cohorts.append(Cohort(
            name=f"tier{i}", n=n,
            delay=DelayModel(base=1.0 / speed, scale=straggler_scale),
            participation=part, availability=availability,
            p_dropout=p_drop, p_recover=p_rec, t_comm_scale=comm_scale))
    return ClientPopulation(cohorts=tuple(cohorts))
